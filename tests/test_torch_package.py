"""The PyTorch port as a package: no JAX in it, and its CUDA kernels never
stand in for anything on a host without a GPU."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import runia_core_tpu_torch
from runia_core_tpu_torch import _kernels, default_device
from runia_core_tpu_torch.models import (
    CausalLM,
    LlamaLM,
    NeoXLM,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    causal_lm_from_flax,
    convert_hf_gpt2,
    convert_hf_gpt_neox,
    detector_state_from_arrays,
    init_cache,
    llama_from_flax,
    neox_from_flax,
    pca_state_from_arrays,
    resnet_from_flax,
)
from runia_core_tpu_torch.models.resnet import ResNetBlock
from runia_core_tpu_torch.ops.entropy import marginal_entropy
from runia_core_tpu_torch.ops.entropy_cuda import marginal_entropy_cuda
from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention
from runia_core_tpu_torch.ops.mc_entropy_cuda import fused_mc_entropy, mc_dropblock_weights
from runia_core_tpu_torch.ops.quant_matmul import quant_matmul

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "runia_core_tpu_torch"


def test_import_loads_no_jax_or_flax():
    modules = [m.name for m in pkgutil.walk_packages([str(PACKAGE)], "runia_core_tpu_torch.")]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}: importlib.import_module(name)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'runia_core_tpu')))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=True
    )
    assert len(modules) >= 25
    assert {"runia_core_tpu_torch.llm.scores", "runia_core_tpu_torch.models.llama"} <= set(modules)
    assert out.stdout.strip() == "[]"


def test_sources_never_import_jax_flax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|runia_core_tpu)(\.|\s|$)", re.M)
    offenders = [
        str(path.relative_to(REPO))
        for path in PACKAGE.rglob("*.py")
        if pattern.search(path.read_text())
    ]
    assert offenders == []


def test_library_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _kernels.library()


def test_cpu_calls_take_the_plain_versions_and_launch_nothing():
    rng = np.random.RandomState(0)
    clouds = torch.from_numpy(rng.randn(2, 16, 8).astype(np.float32))
    fmap = torch.from_numpy(rng.rand(2, 4, 4, 8).astype(np.float32))
    weights = mc_dropblock_weights(2, 4, 4, 16, 3, 0.5, torch.Generator().manual_seed(0))
    assert marginal_entropy(clouds, 5).shape == (2, 8)
    assert fused_mc_entropy(weights, fmap).shape == (2, 8)
    x = torch.from_numpy(rng.randn(3, 32).astype(np.float32))
    wq = torch.from_numpy(rng.randint(-127, 128, (32, 16)).astype(np.int8))
    assert quant_matmul(x, wq, torch.ones(16)).shape == (3, 16)
    q, kv = torch.randn(1, 4, 8, 16), torch.randn(1, 2, 8, 16)
    assert flash_prefix_attention(q, kv, kv, torch.zeros(1, dtype=torch.int32)).shape == (1, 4, 8, 16)
    assert marginal_entropy_cuda.launches == 0
    assert fused_mc_entropy.launches == 0
    assert quant_matmul.launches == 0
    assert flash_prefix_attention.launches == flash_prefix_attention.kv8_launches == 0


def test_package_exposes_its_version():
    assert runia_core_tpu_torch.__version__


def test_default_device_is_cuda_and_does_not_probe():
    assert default_device() == torch.device("cuda")
    source = (PACKAGE / "__init__.py").read_text()
    assert "is_available" not in source and "device_count" not in source


_TINY_LLAMA = dict(vocab_size=17, num_layers=1, num_heads=2, num_kv_heads=1, d_model=8, hidden_dim=16, max_len=8)


def _llama(device="cpu", **kw):
    return LlamaLM(**_TINY_LLAMA, device=device, **kw)


_TINY_GPT = dict(vocab_size=17, num_layers=1, num_heads=2, d_model=8, max_len=8)


def _hf_gpt2():
    transformers = pytest.importorskip("transformers")
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(vocab_size=17, n_positions=8, n_embd=8, n_layer=1,
                                                                n_head=2))


def _hf_neox():
    transformers = pytest.importorskip("transformers")
    return transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=17, hidden_size=8, intermediate_size=16, num_hidden_layers=1, num_attention_heads=2,
        max_position_embeddings=8))


class _PCA:
    mean, components, explained_variance, whiten = np.zeros(3), np.eye(3)[:2], np.ones(2), True


_ON_CPU = {
    "LlamaLM": lambda: list(_llama().parameters()),
    "LlamaLM_int8": lambda: list(_llama(quantized=True, quantized_kv=True, fused_qkv=True).parameters()),
    "ResNet": lambda: list(ResNet((1, 1), ResNetBlock, 3, num_filters=4, device="cpu").state_dict().values()),
    "ResNet18": lambda: list(ResNet18(num_classes=3, num_filters=4, device="cpu").state_dict().values()),
    "ResNet34": lambda: list(ResNet34(num_classes=3, num_filters=4, device="cpu").state_dict().values()),
    "ResNet50": lambda: list(ResNet50(num_classes=3, num_filters=4, device="cpu").state_dict().values()),
    "init_cache": lambda: [t for layer in init_cache(_llama(), 2, 8, device="cpu")["layers"] for t in layer.values()],
    "init_cache_kv8": lambda: [
        t for layer in init_cache(_llama(quantized=True, quantized_kv=True), 2, 8, device="cpu")["layers"]
        for t in layer.values()
    ],
    "pca_state_from_arrays": lambda: [
        getattr(pca_state_from_arrays(_PCA, device="cpu"), name) for name in ("mean", "components", "explained_variance")
    ],
    "detector_state_from_arrays": lambda: [
        detector_state_from_arrays({"feats_mean": np.zeros(3), "precision": np.eye(3)}, device="cpu")[name]
        for name in ("feats_mean", "precision")
    ],
    "resnet_from_flax": lambda: list(resnet_from_flax(
        {"params": {"conv_init": {"kernel": np.zeros((3, 3, 3, 4))}, "bn_init": {"scale": np.ones(4)}},
         "batch_stats": {"bn_init": {"mean": np.zeros(4)}}}, device="cpu").values()),
    "llama_from_flax": lambda: list(llama_from_flax(
        {"params": {"embed": {"embedding": np.zeros((17, 8), np.float32)},
                    "block_0": {"q": {"kernel_q": np.zeros((8, 8), np.int8)}}}}, device="cpu").values()),
    "CausalLM": lambda: list(CausalLM(**_TINY_GPT, device="cpu").parameters()),
    "CausalLM_moe": lambda: list(CausalLM(**_TINY_GPT, num_experts=2, device="cpu").parameters()),
    "NeoXLM": lambda: list(NeoXLM(**_TINY_GPT, device="cpu").parameters()),
    "init_cache_causal_lm": lambda: [
        t for layer in init_cache(CausalLM(**_TINY_GPT, device="cpu"), 2, 8, device="cpu")["layers"]
        for t in layer.values()
    ],
    "convert_hf_gpt2": lambda: list(convert_hf_gpt2(_hf_gpt2(), device="cpu")[1].values()),
    "convert_hf_gpt_neox": lambda: list(convert_hf_gpt_neox(_hf_neox(), device="cpu")[1].values()),
    "causal_lm_from_flax": lambda: list(causal_lm_from_flax(
        {"params": {"pos_embed": {"embedding": np.zeros((8, 8), np.float32)}}}, device="cpu").values()),
    "neox_from_flax": lambda: list(neox_from_flax(
        {"params": {"block_0": {"qkv": {"kernel": np.zeros((8, 24), np.float32)}}}}, device="cpu").values()),
}


@pytest.mark.parametrize("name", sorted(_ON_CPU))
def test_constructors_and_converters_land_on_the_cpu_when_asked(name):
    tensors = _ON_CPU[name]()
    assert tensors and all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("name", ["LlamaLM", "ResNet18", "init_cache", "pca_state_from_arrays",
                                  "detector_state_from_arrays", "resnet_from_flax", "llama_from_flax", "CausalLM",
                                  "NeoXLM", "convert_hf_gpt2", "convert_hf_gpt_neox", "neox_from_flax"])
def test_the_default_device_is_the_card_and_nothing_falls_back(name):
    """With no ``device`` the constructors and converters go to the GPU: on a
    host without one the first allocation raises; nothing carries on on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    calls = {
        "LlamaLM": lambda: LlamaLM(**_TINY_LLAMA),
        "ResNet18": lambda: ResNet18(num_classes=3, num_filters=4),
        "init_cache": lambda: init_cache(_llama(), 2, 8),
        "pca_state_from_arrays": lambda: pca_state_from_arrays(_PCA),
        "detector_state_from_arrays": lambda: detector_state_from_arrays({"feats_mean": np.zeros(3)}),
        "resnet_from_flax": lambda: resnet_from_flax({"params": {"bn_init": {"scale": np.ones(4)}}}),
        "llama_from_flax": lambda: llama_from_flax({"params": {"embed": {"embedding": np.zeros((2, 2), np.float32)}}}),
        "CausalLM": lambda: CausalLM(**_TINY_GPT),
        "NeoXLM": lambda: NeoXLM(**_TINY_GPT),
        "convert_hf_gpt2": lambda: convert_hf_gpt2(_hf_gpt2()),
        "convert_hf_gpt_neox": lambda: convert_hf_gpt_neox(_hf_neox()),
        "neox_from_flax": lambda: neox_from_flax({"params": {"norm_f": {"scale": np.ones(2, np.float32)}}}),
    }
    with pytest.raises((RuntimeError, AssertionError)):
        calls[name]()


def test_no_entry_point_tests_for_a_gpu():
    """Only the kernel loader and the timers, which raise without a GPU, ask
    whether there is one; no model, cache or converter does."""
    asking = sorted(
        str(path.relative_to(PACKAGE)) for path in PACKAGE.rglob("*.py") if "is_available" in path.read_text()
    )
    assert asking == ["_kernels.py", "utils/timing.py"]


def test_chip_smoke_imports_no_jax_and_passes_no_device_to_the_models():
    source = (REPO / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|runia_core_tpu)(\.|\s|$)", source, re.M)
    assert "with torch.device(" not in source
