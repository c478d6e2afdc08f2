"""runia_core_tpu_torch: the PyTorch + CUDA port of runia_core_tpu.

The package mirrors ``runia_core_tpu``'s paths and names, so each module's
counterpart sits at the same relative path. It imports PyTorch, numpy and
scipy, and never JAX. Its hand-written Hopper kernels live in ``csrc/`` and
are built at first use on a GPU (``_kernels.py``); on CPU tensors every
kernel's wrapper takes the plain PyTorch version beside it.

Three slices run end to end: image-level LaREx scoring (``models.resnet`` ->
``sampling`` / ``ops.mc_entropy_cuda`` -> ``ops.entropy`` /
``ops.entropy_cuda`` -> ``reduction`` -> ``detectors.latent`` ->
``inference.image_level.build_larex_scorer``, served over a dataset by
``inference.service.ScoringService`` and the native loader of ``data``, and
split over ranks by ``parallel``), object-level scoring (``models.yolov8`` /
``models.detection`` -> ``ops.nms`` -> ``extraction.object_level`` /
``object_level_batched`` -> ``ops.roi_align`` -> ``inference.object_level``)
and the Llama LLM-uncertainty path (``models.llama`` -> ``llm.generate`` ->
``llm.scores``). On the GPU they run as replays of CUDA graphs
(``utils.graphs``), the counterpart of the JAX package's compiled programs.

Models, caches and converted states are built on :func:`default_device`, the
GPU, unless the caller names another device (the CPU tests pass
``device="cpu"``).

The sub-packages and the reference's aliases (``dimensionality_reduction``,
``feature_extraction``, ``llm_uncertainty``) load at first access
(PEP 562), so ``import runia_core_tpu_torch`` stays cheap: it touches no
CUDA, builds nothing and imports neither transformers nor pandas.
"""

import importlib

import torch

from runia_core_tpu_torch.version import __version__

__all__ = [
    "evaluation",
    "feature_extraction",
    "extraction",
    "inference",
    "yolov8",
    "rcnn",
    "llm_uncertainty",
    "llm",
    "detectors",
    "models",
    "ops",
    "parallel",
    "reduction",
    "dimensionality_reduction",
    "sampling",
    "config",
    "checkpoint",
    "module_exists",
    "apply_pca_ds",
    "apply_pca_ds_split",
    "apply_pca_transform",
    "fit_pacmap",
    "apply_pacmap_transform",
    "plot_samples_pacmap",
    "__version__",
    "default_device",
]


def default_device() -> torch.device:
    """Where the port builds what it is not told to build elsewhere: the
    current CUDA device. It does not look whether there is one: without a
    GPU the first allocation raises."""
    return torch.device("cuda")


_SUBPACKAGES = ("checkpoint", "config", "data", "detectors", "evaluation", "extraction", "inference", "llm",
                "models", "ops", "parallel", "rcnn", "reduction", "sampling", "training", "utils", "yolov8")
_ALIASES = {"dimensionality_reduction": "reduction", "feature_extraction": "extraction",
            "llm_uncertainty": "llm"}
_FROM = {"module_exists": "import_helper_functions", "apply_pca_ds": "reduction",
         "apply_pca_ds_split": "reduction", "apply_pca_transform": "reduction", "fit_pacmap": "reduction",
         "apply_pacmap_transform": "reduction", "plot_samples_pacmap": "reduction"}

# Deprecated / expired attribute machinery: maps old attribute names either
# to a replacement value + message (deprecated) or to a message only
# (expired: accessing returns a stub that raises).
__deprecated_attrs__: dict = {}
__expired_functions__: dict = {}


def __getattr__(attr):
    import warnings

    if attr in _SUBPACKAGES or attr in _ALIASES:
        module = importlib.import_module(f"{__name__}.{_ALIASES.get(attr, attr)}")
        globals()[attr] = module
        return module
    if attr in _FROM:
        value = getattr(importlib.import_module(f"{__name__}.{_FROM[attr]}"), attr)
        globals()[attr] = value
        return value

    if attr in __expired_functions__:
        message = __expired_functions__[attr]
        warnings.warn(message, DeprecationWarning, stacklevel=2)

        def _expired(*_args, **_kwargs):
            raise RuntimeError(message)

        return _expired

    if attr in __deprecated_attrs__:
        value, message = __deprecated_attrs__[attr]
        warnings.warn(message, DeprecationWarning, stacklevel=2)
        return value

    raise AttributeError(f"module {__name__!r} has no attribute {attr!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__) | set(_SUBPACKAGES))
