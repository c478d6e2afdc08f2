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
    SimpleConvNet,
    ViT,
    convert_hf_vit,
    convert_torch_resnet,
    quantize_resnet,
    vit_from_flax,
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
from runia_core_tpu_torch.ops.nms import nms_keep_cuda, nms_mask
from runia_core_tpu_torch.ops.quant_matmul import quant_matmul
from runia_core_tpu_torch.ops.roi_align import roi_align_nhwc, roi_align_nhwc_cuda
from runia_core_tpu_torch.training import fit_classifier

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "runia_core_tpu_torch"


def test_import_loads_no_jax_or_flax():
    modules = [m.name for m in pkgutil.walk_packages([str(PACKAGE)], "runia_core_tpu_torch.")]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}: importlib.import_module(name)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', "
        "'runia_core_tpu')))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=True
    )
    assert len(modules) >= 25
    assert {"runia_core_tpu_torch.llm.scores", "runia_core_tpu_torch.models.llama",
            "runia_core_tpu_torch.detectors.features", "runia_core_tpu_torch.detectors.logits",
            "runia_core_tpu_torch.evaluation.metrics", "runia_core_tpu_torch.evaluation.baselines",
            "runia_core_tpu_torch.evaluation.latent_space", "runia_core_tpu_torch.models.quant_vision",
            "runia_core_tpu_torch.checkpoint", "runia_core_tpu_torch.models.torch_convert",
            "runia_core_tpu_torch.models.vit", "runia_core_tpu_torch.training", "runia_core_tpu_torch.config",
            "runia_core_tpu_torch.version", "runia_core_tpu_torch.import_helper_functions",
            "runia_core_tpu_torch.ops.nms", "runia_core_tpu_torch.ops.roi_align",
            "runia_core_tpu_torch.extraction.adapters", "runia_core_tpu_torch.extraction.object_level",
            "runia_core_tpu_torch.extraction.object_level_batched", "runia_core_tpu_torch.models.detection",
            "runia_core_tpu_torch.models.yolov8", "runia_core_tpu_torch.inference.object_level",
            "runia_core_tpu_torch.rcnn", "runia_core_tpu_torch.yolov8", "runia_core_tpu_torch.models.detr",
            "runia_core_tpu_torch.models.deeplab", "runia_core_tpu_torch.models.segmentation",
            "runia_core_tpu_torch.extraction.hf_adapters", "runia_core_tpu_torch.evaluation.open_set",
            "runia_core_tpu_torch.inference.segmentation"} <= set(modules)
    assert out.stdout.strip() == "[]"


def test_evaluation_exports_every_jax_name_but_subset_boxes_without_jax():
    jax_init = (REPO / "runia_core_tpu" / "evaluation" / "__init__.py").read_text()
    jax_names = set(re.findall(r'^\s+"(\w+)",$', jax_init.split("__all__")[1], re.M))
    code = ("import sys, runia_core_tpu_torch.evaluation as e\n"
            "print(sorted(e.__all__))\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'runia_core_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert len(jax_names) == 16 and "subset_boxes" in jax_names
    assert jax_names <= set(eval(out[0]))  # subset_boxes came with the object-level evaluation
    assert out[1] == "[]"


_NEW_SLICE_NAMES = {
    "models": ["DETR", "DetrJaxAdapter", "convert_hf_detr", "ASPP", "DeepLabV3Plus", "SimpleSegmenter"],
    "inference": ["build_pixel_uncertainty_scorer"],
    "extraction": ["HFDetrAdapter", "cxcywh_to_xyxy"],
    "evaluation": ["subset_boxes"],
    "evaluation.open_set": ["COCOParser", "OpenSetEvaluator", "voc_eval", "voc_ap", "get_gtu_uu_per_class",
                            "convert_xywh_to_xyxy", "evaluate_open_set_detection_one_method",
                            "get_overall_open_set_results", "convert_osod_results_to_pandas_df",
                            "convert_osod_results_to_hierarchical_pandas_df",
                            "convert_osod_results_for_mlflow_logging", "plot_two_osod_datasets_metrics",
                            "plot_two_osod_datasets_per_metric", "get_boxes_gtu_and_uu_ood_dataset",
                            "get_labels_and_scores_from_logits", "get_n_unk_ood_dataset"],
}


@pytest.mark.parametrize("package", sorted(_NEW_SLICE_NAMES))
def test_the_detr_segmentation_and_open_set_names_are_the_jax_packages(package):
    """Every name the JAX package exports for DETR, DeepLab, segmentation,
    the HF adapter and the open-set evaluation is exported by the port from
    the same package, and importing it loads no JAX."""
    path = REPO / "runia_core_tpu" / Path(*package.split("."))
    source = (path / "__init__.py" if path.is_dir() else path.with_suffix(".py")).read_text()
    jax_names = set(re.findall(r'^\s+"(\w+)",$', source.split("__all__")[1], re.M))
    assert set(_NEW_SLICE_NAMES[package]) <= jax_names
    code = (f"import sys, runia_core_tpu_torch.{package} as m\n"
            "print(sorted(m.__all__))\n"
            "print(sorted(n for n in m.__all__ if not hasattr(m, n)))\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'runia_core_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert set(_NEW_SLICE_NAMES[package]) <= set(eval(out[0]))
    assert out[1:] == ["[]", "[]"]


def test_sources_never_import_jax_flax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|runia_core_tpu)(\.|\s|$)", re.M)
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
    boxes = torch.tensor([[0.0, 0.0, 4.0, 4.0], [1.0, 1.0, 5.0, 5.0]])
    assert nms_mask(boxes, torch.tensor([0.9, 0.8]), 0.1)[1].tolist() == [True, False]
    assert roi_align_nhwc(fmap, torch.zeros((2, 4)), 2, 1.0, mean=True).shape == (2, 8)
    assert nms_keep_cuda.launches == roi_align_nhwc_cuda.launches == 0


def test_the_object_level_kernels_refuse_what_they_do_not_take():
    """Shapes outside a kernel's contract raise at the call, before any
    launch: NMS past MAX_NMS_BOXES boxes, ROIAlign on a map that is not a
    (B, H, W, C) float32 / bfloat16 one (the wrappers check before they ask
    for the library, so this holds on a host without a GPU too)."""
    from runia_core_tpu_torch.ops.nms import MAX_NMS_BOXES

    with pytest.raises(ValueError, match="at most"):
        nms_keep_cuda(torch.zeros((MAX_NMS_BOXES + 1, 4)), 0.5)
    with pytest.raises(ValueError, match="float32"):
        nms_keep_cuda(torch.zeros((3, 4), dtype=torch.float64), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        roi_align_nhwc_cuda(torch.zeros((1, 4, 4, 8), dtype=torch.float16), torch.zeros((1, 4)), 2, 1.0)
    with pytest.raises(ValueError, match="split evenly"):
        roi_align_nhwc_cuda(torch.zeros((2, 4, 4, 8)), torch.zeros((3, 4)), 2, 1.0)


def test_package_exposes_its_version():
    from runia_core_tpu_torch.version import __version__

    assert runia_core_tpu_torch.__version__ == __version__ == (REPO / "runia_core_tpu" / "version.py").read_text(
    ).split('"')[1]


def test_config_and_module_exists_are_the_jax_packages():
    from runia_core_tpu_torch.config import Config, default_config
    from runia_core_tpu_torch.import_helper_functions import module_exists

    cfg = default_config(k_neighbors=7)
    assert cfg.k_neighbors == 7 and cfg.num_classes == 10 and "ash_percentile" in cfg
    cfg.sub = {"x": 1}
    cfg.sub.x = 5
    assert cfg.to_dict()["sub"] == {"x": 5} and isinstance(cfg, Config)
    with pytest.raises(AttributeError):
        cfg.missing
    assert module_exists("json").__name__ == "json" and module_exists("no_such_module_xyz") is None
    with pytest.raises(ImportError):
        module_exists("no_such_module_xyz", error="raise")


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


def _torchvision_sd():
    """A torchvision-layout ResNet-18 state_dict of width 4 (random)."""
    model = ResNet18(num_classes=3, num_filters=4, torch_padding=True, device="cpu")
    renames = {"conv_init": "conv1", "bn_init": "bn1", "head": "fc", "conv_proj": "downsample.0",
               "norm_proj": "downsample.1"}
    sd = {}
    for key, value in model.state_dict().items():
        for mine, theirs in renames.items():
            key = key.replace(mine, theirs)
        key = re.sub(r"stage(\d)_block(\d)", lambda m: f"layer{m[1]}.{m[2]}", key)
        key = re.sub(r"Conv_(\d)", lambda m: f"conv{int(m[1]) + 1}", key)
        key = re.sub(r"BatchNorm_(\d)", lambda m: f"bn{int(m[1]) + 1}", key)
        sd[key] = value
    return sd


def _hf_vit():
    transformers = pytest.importorskip("transformers")
    return transformers.ViTForImageClassification(transformers.ViTConfig(
        image_size=8, patch_size=4, hidden_size=8, num_hidden_layers=1, num_attention_heads=2, intermediate_size=32,
        num_labels=2))


def _saved_pca(tmp):
    from runia_core_tpu_torch import checkpoint
    from runia_core_tpu_torch.reduction import PCAState

    path = Path(tmp) / "pca.npz"
    checkpoint.save_pca(path, PCAState(torch.zeros(3), torch.eye(3)[:2], torch.ones(2)))
    return path


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
    "SimpleConvNet": lambda: list(SimpleConvNet(num_classes=2, features=2, device="cpu").parameters()),
    "ViT": lambda: list(ViT(num_classes=2, d_model=8, num_layers=1, num_heads=2, device="cpu").parameters()),
    "vit_from_flax": lambda: list(vit_from_flax({"params": {"pos_embed": np.zeros((1, 4, 8))}},
                                                device="cpu").values()),
    "convert_torch_resnet": lambda: list(convert_torch_resnet(_torchvision_sd(), device="cpu").state_dict().values()),
    "convert_hf_vit": lambda: list(convert_hf_vit(_hf_vit(), device="cpu").parameters()),
    "quantize_resnet": lambda: list(quantize_resnet(
        ResNet18(num_classes=3, num_filters=4, cifar_stem=True, device="cpu"), torch.rand(2, 8, 8, 3))(
        torch.rand(1, 8, 8, 3))[1].values()),
    "load_pca": lambda: [checkpoint_load_pca(device="cpu").mean],
    "SimpleDetector": lambda: list(_detector_models()["SimpleDetector"](device="cpu").parameters()),
    "YoloV8": lambda: list(_detector_models()["YoloV8"](device="cpu").state_dict().values()),
    "convert_ultralytics_yolov8": lambda: list(_detector_models()["convert_ultralytics_yolov8"](
        device="cpu").state_dict().values()),
    "yolov8_from_flax": lambda: list(_detector_models()["yolov8_from_flax"](device="cpu").values()),
    "pad_detections": lambda: [_detector_models()["pad_detections"](device="cpu").boxes],
    "DeepLabV3Plus": lambda: list(_segmentation_models()["DeepLabV3Plus"](device="cpu").state_dict().values()),
    "SimpleSegmenter": lambda: list(_segmentation_models()["SimpleSegmenter"](device="cpu").parameters()),
    "convert_hf_detr": lambda: list(_segmentation_models()["convert_hf_detr"](device="cpu")[1].values()),
    "HFDetrAdapter": lambda: list(_segmentation_models()["HFDetrAdapter"](device="cpu").model.parameters()),
}


def _tiny_hf_detr():
    transformers = pytest.importorskip("transformers")
    return transformers.DetrForObjectDetection(transformers.DetrConfig(
        use_timm_backbone=False, use_pretrained_backbone=False,
        backbone_config=transformers.ResNetConfig(embedding_size=4, hidden_sizes=[16, 32], depths=[1, 1],
                                                  layer_type="bottleneck"),
        d_model=8, encoder_layers=1, decoder_layers=1, encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=16, decoder_ffn_dim=16, num_queries=3, num_labels=2))


def _segmentation_models():
    """This slice's constructors and converters, each a call taking ``device``."""
    from runia_core_tpu_torch.extraction import HFDetrAdapter
    from runia_core_tpu_torch.models import DeepLabV3Plus, SimpleSegmenter, convert_hf_detr

    return {
        "DeepLabV3Plus": lambda device=None: DeepLabV3Plus(num_classes=2, backbone_stages=(1, 1),
                                                           backbone_block=ResNetBlock, num_filters=4,
                                                           aspp_features=4, low_level_features=2, device=device),
        "SimpleSegmenter": lambda device=None: SimpleSegmenter(num_classes=2, features=2, device=device),
        "convert_hf_detr": lambda device=None: convert_hf_detr(_tiny_hf_detr(), device=device),
        "HFDetrAdapter": lambda device=None: HFDetrAdapter(_tiny_hf_detr(), device=device),
    }


def _detector_models():
    """The object level's constructors and converters, each a call taking ``device``."""
    from runia_core_tpu_torch.extraction import pad_detections
    from runia_core_tpu_torch.models import SimpleDetector, YoloV8, convert_ultralytics_yolov8, yolov8_from_flax
    from runia_core_tpu_torch.models.yolov8 import _ultralytics_names, yolov8_widths

    def ultralytics_sd():
        state = YoloV8(2, "n", device="cpu").state_dict()
        return {theirs: state[ours] for ours, theirs in _ultralytics_names(yolov8_widths("n")).items()}

    return {
        "SimpleDetector": lambda device=None: SimpleDetector(num_classes=2, features=2, device=device),
        "YoloV8": lambda device=None: YoloV8(2, "n", device=device),
        "convert_ultralytics_yolov8": lambda device=None: convert_ultralytics_yolov8(ultralytics_sd(), 2, "n",
                                                                                     device=device),
        "yolov8_from_flax": lambda device=None: yolov8_from_flax(
            {"params": {"layer0": {"conv": {"kernel": np.zeros((3, 3, 3, 16), np.float32)}}}}, device=device),
        "pad_detections": lambda device=None: pad_detections([{"boxes": np.zeros((1, 4))}], 2, (8, 8),
                                                             device=device),
    }


def checkpoint_load_pca(device=None):
    import tempfile

    from runia_core_tpu_torch import checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        return checkpoint.load_pca(_saved_pca(tmp), device=device)


@pytest.mark.parametrize("name", sorted(_ON_CPU))
def test_constructors_and_converters_land_on_the_cpu_when_asked(name):
    tensors = _ON_CPU[name]()
    assert tensors and all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("name", ["LlamaLM", "ResNet18", "init_cache", "pca_state_from_arrays",
                                  "detector_state_from_arrays", "resnet_from_flax", "llama_from_flax", "CausalLM",
                                  "NeoXLM", "convert_hf_gpt2", "convert_hf_gpt_neox", "neox_from_flax",
                                  "SimpleConvNet", "ViT", "vit_from_flax", "convert_torch_resnet", "convert_hf_vit",
                                  "load_pca", "SimpleDetector", "YoloV8", "convert_ultralytics_yolov8",
                                  "yolov8_from_flax", "pad_detections", "DeepLabV3Plus", "SimpleSegmenter",
                                  "convert_hf_detr", "HFDetrAdapter"])
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
        "SimpleConvNet": lambda: SimpleConvNet(num_classes=2, features=2),
        "ViT": lambda: ViT(num_classes=2, d_model=8, num_layers=1, num_heads=2),
        "vit_from_flax": lambda: vit_from_flax({"params": {"pos_embed": np.zeros((1, 4, 8))}}),
        "convert_torch_resnet": lambda: convert_torch_resnet(_torchvision_sd()),
        "convert_hf_vit": lambda: convert_hf_vit(_hf_vit()),
        "load_pca": lambda: checkpoint_load_pca(),
        **{name: make for name, make in _detector_models().items()},
        **{name: make for name, make in _segmentation_models().items()},
    }
    with pytest.raises((RuntimeError, AssertionError)):
        calls[name]()


def test_training_and_quantization_follow_the_models_device():
    """``fit_classifier`` and ``quantize_resnet`` send numpy batches to the
    model's device (here the CPU, as the model was built there)."""
    model = SimpleConvNet(num_classes=2, features=2, device="cpu")
    _, metrics = fit_classifier(model, [(np.zeros((2, 4, 4, 3), np.float32), np.zeros(2, np.int64))])
    assert np.isfinite(metrics["loss"])
    resnet = ResNet18(num_classes=3, num_filters=4, cifar_stem=True, device="cpu")
    logits, _ = quantize_resnet(resnet, np.random.rand(2, 8, 8, 3).astype(np.float32))(np.zeros((1, 8, 8, 3)))
    assert logits.device.type == "cpu"


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


def _placement_cases():
    """Entry point -> a call of it on its inputs made by ``make`` (numpy
    arrays, or CPU tensors)."""
    from runia_core_tpu_torch.detectors import DDU, MDLatentSpace, ViM, postprocessors_dict
    from runia_core_tpu_torch.evaluation import calculate_all_baselines, get_dl_h_z, torch_auroc
    from runia_core_tpu_torch.evaluation.entropy import single_image_entropy_calculation
    from runia_core_tpu_torch.extraction import postprocess_architecture_taps
    from runia_core_tpu_torch.extraction.object_level import _reduce_features_to_rois
    from runia_core_tpu_torch.rcnn import MCSamplerRCNN
    from runia_core_tpu_torch.reduction import apply_pca_ds, apply_pca_ds_split

    class Cfg:
        ood_datasets, k_neighbors, ash_percentile, gen_gamma = ["o"], 3, 85, 0.1
        react_percentile = dice_percentile = 90

    rng = np.random.RandomState(0)
    x, labels, w = rng.randn(40, 6).astype(np.float32), rng.randint(0, 3, 40), rng.randn(3, 6).astype(np.float32)

    def baselines(make):
        ind = {"train features": make(x), "valid features": make(x[:20]), "train logits": make(x @ w.T),
               "valid logits": make(x[:20] @ w.T)}
        ood = {"o features": make(x[20:]), "o logits": make(x[20:] @ w.T)}
        fc = {"weight": make(w), "bias": make(np.zeros(3, np.float32))}
        return calculate_all_baselines(["vim", "msp", "knn", "ddu", "mdist", "dice"], ind, ood, fc, Cfg(), 3)[2]

    return {
        "get_dl_h_z": lambda make: get_dl_h_z(make(x), 8)[1],
        "single_image_entropy_calculation": lambda make: single_image_entropy_calculation(make(x[:8]), 5),
        "apply_pca_ds_split": lambda make: apply_pca_ds_split(make(x), 3)[0],
        "apply_pca_ds": lambda make: apply_pca_ds(make(x), make(x[:5]), 3)[1],
        "MD_setup": lambda make: _fitted(MDLatentSpace(), make(x)).feats_mean,
        "every_latent_setup": lambda make: [
            _fitted(postprocessors_dict[name](), make(x), ind_train_labels=labels).state
            for name in ("KDE", "cMD", "KNN", "GMM")],
        "DDU_setup": lambda make: _fitted(DDU(num_classes=3), make(x), train_labels=make(labels),
                                          valid_feats=make(x)).gmm.means,
        "ViM_setup": lambda make: _fitted(ViM(), make(x), train_logits=make(x @ w.T), valid_feats=make(x),
                                          valid_logits=make(x @ w.T),
                                          final_linear_layer_params={"weight": make(w), "bias": make(w[:, 0])}).NS,
        "calculate_all_baselines": lambda make: baselines(make),
        "torch_auroc": lambda make: torch_auroc(make(x[:, 0]), make(x[:, 1])),
        "postprocess_architecture_taps": lambda make: postprocess_architecture_taps(
            "owlv2", [make(rng.rand(1, 5, 3).astype(np.float32))]),
        "_reduce_features_to_rois": lambda make: list(_reduce_features_to_rois(
            [make(rng.rand(1, 3, 4, 4).astype(np.float32))], [2], make(np.array([[0, 0, 8, 8]], np.float32)), (8, 8),
            -1, 1, 1, return_stds=True)),
        "MCSamplerRCNN": lambda make: MCSamplerRCNN(2, block_size=1)([make(rng.rand(1, 3, 4, 4).astype(np.float32))]),
    }


def _fitted(detector, data, **kwargs):
    detector.setup(data, **kwargs)
    return detector


def _devices(out):
    if isinstance(out, torch.Tensor):
        return {out.device.type}
    values = out.values() if isinstance(out, dict) else out
    return set().union(*(_devices(v) for v in values)) if isinstance(out, (dict, list)) else set()


@pytest.mark.parametrize("name", sorted(_placement_cases()))
def test_numpy_inputs_go_to_the_default_device_and_tensors_stay(monkeypatch, name):
    """A numpy input is placed on ``default_device()`` (patched here to
    record the request and answer the CPU); a tensor stays on its device
    and asks for none."""
    asked = []

    def recording_default_device():
        asked.append(True)
        return torch.device("cpu")

    call = _placement_cases()[name]
    monkeypatch.setattr(runia_core_tpu_torch, "default_device", recording_default_device)
    out = call(lambda a: np.asarray(a))
    assert asked and _devices(out) == {"cpu"}
    asked.clear()
    out = call(lambda a: torch.from_numpy(np.array(a)))
    assert not asked and _devices(out) == {"cpu"}


def test_a_numpy_input_is_not_computed_on_the_cpu_without_a_gpu():
    """Unpatched, a numpy input goes to the GPU: on this host that raises
    instead of quietly computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    from runia_core_tpu_torch.evaluation import get_dl_h_z

    with pytest.raises((RuntimeError, AssertionError)):
        get_dl_h_z(np.zeros((16, 4), np.float32), 8)


# Every name a JAX module exports has a counterpart at the same path in the
# port, under the same name unless it is renamed here.
_RENAMED = {
    "jax_auroc": "torch_auroc",
    "tap_flax_model": "tap_torch_model",
    "JaxGenerator": "TorchGenerator",
    "wrap_jax_nli": "wrap_torch_nli",
    "tpu_profile": "cuda_profile",
    "marginal_entropy_pallas": "marginal_entropy_cuda",
}
# The Pallas kernels' wrappers live beside their CUDA kernels.
_MODULE_PATHS = {"ops.entropy_pallas": "ops.entropy_cuda", "ops.mc_entropy_pallas": "ops.mc_entropy_cuda"}
_NO_COUNTERPART = {
    "enable_compilation_cache": "configures XLA's persistent compilation cache only "
                                "(runia_core_tpu/utils/profiling.py:31-58); the port compiles no programs",
    "HAVE_NATIVE": "flags the JAX loader's silent numpy fallback; the port's native= raises where the "
                   "extension does not build",
}
# Modules and names not ported yet (none: the model-parallel layer was the last).
_PENDING_MODULES = set()
_PENDING_NAMES = set()


def _jax_exports():
    """{module path relative to the package: its ``__all__``}, read from the
    JAX package's sources with ``ast`` (no JAX import)."""
    import ast

    root = REPO / "runia_core_tpu"
    exports = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
                parts = path.relative_to(root).with_suffix("").parts
                exports[".".join(parts[:-1] if parts[-1] == "__init__" else parts)] = ast.literal_eval(node.value)
    return exports


_JAX_EXPORTS = _jax_exports()


@pytest.mark.parametrize("module", sorted(_JAX_EXPORTS))
def test_every_jax_export_exists_in_the_port(module):
    """Each name in a JAX module's ``__all__`` is an attribute of the port's
    module at the same path, renamed only as ``_RENAMED`` says; the names
    without a counterpart say why, and the pending ones are still missing."""
    import importlib

    if module in _PENDING_MODULES:
        port = REPO / "runia_core_tpu_torch" / Path(*module.split("."))
        assert not port.with_suffix(".py").exists(), f"{module} is ported: take it off the pending list"
        return
    target = _MODULE_PATHS.get(module, module)
    port = importlib.import_module("runia_core_tpu_torch" + (f".{target}" if target else ""))
    names = [n for n in _JAX_EXPORTS[module] if n not in _NO_COUNTERPART]
    missing = [n for n in names if n not in _PENDING_NAMES and not hasattr(port, _RENAMED.get(n, n))]
    assert missing == []
    still_pending = [n for n in names if n in _PENDING_NAMES]
    assert not any(hasattr(port, n) for n in still_pending), "a pending name is ported: take it off the list"


def test_the_pending_list_is_the_model_parallel_layer():
    """Nothing is pending, and every module of the JAX ``parallel`` package
    has a port file at its path."""
    assert _PENDING_NAMES == set() and _PENDING_MODULES == set()
    jax_parallel = sorted(p.name for p in (REPO / "runia_core_tpu" / "parallel").glob("*.py"))
    assert {"fsdp.py", "llama_tp.py", "ring_attention.py", "pipeline.py", "moe.py"} <= set(jax_parallel)
    for name in jax_parallel:
        assert (REPO / "runia_core_tpu_torch" / "parallel" / name).is_file(), name
    assert set(_NO_COUNTERPART) <= {n for names in _JAX_EXPORTS.values() for n in names}


def test_the_three_aliases_are_the_jax_packages():
    from runia_core_tpu_torch import extraction, inference, utils
    from runia_core_tpu_torch.detectors.base import record_time

    assert extraction.ObjectDetectionExtractor is extraction.BoxFeaturesExtractor
    assert inference.ObjectDetectionInference is inference.ObjectDetectionInferenceBase
    assert utils.record_time is record_time is inference.record_time


def test_the_top_level_package_is_lazy_and_exports_the_jax_names():
    """``import runia_core_tpu_torch`` loads no sub-package, touches no CUDA
    and imports neither transformers nor pandas; the JAX package's top-level
    names (sub-packages, the reference's aliases, the reduction functions)
    load at first access."""
    jax_names = set(_JAX_EXPORTS[""])
    code = (
        "import sys, torch, runia_core_tpu_torch as r\n"
        "print(torch.cuda.is_initialized(), sorted(m for m in sys.modules if m.startswith('runia_core_tpu_torch.')))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('transformers', 'pandas', 'jax')))\n"
        "print(sorted(n for n in r.__all__ if getattr(r, n, None) is None))\n"
        "print(r.dimensionality_reduction is r.reduction, r.feature_extraction is r.extraction,"
        " r.llm_uncertainty is r.llm, r.apply_pca_ds is r.reduction.apply_pca_ds)\n"
        "print(sorted(r.__all__))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('transformers', 'pandas', 'jax')))\n"
        "try:\n    r.no_such_name\nexcept AttributeError as e:\n    print('AttributeError')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True).stdout.splitlines()
    assert out[0] == "False ['runia_core_tpu_torch.version']"
    assert out[1] == out[2] == "[]"
    assert out[3] == "True True True True"
    assert jax_names <= set(eval(out[4])) and "default_device" in eval(out[4])
    assert out[5] == "[]" and out[6] == "AttributeError"
