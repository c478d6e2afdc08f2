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
from runia_core_tpu_torch import _kernels
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
