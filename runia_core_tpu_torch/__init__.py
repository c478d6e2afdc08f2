"""runia_core_tpu_torch: the PyTorch + CUDA port of runia_core_tpu.

The package mirrors ``runia_core_tpu``'s paths and names, so each module's
counterpart sits at the same relative path. It imports PyTorch, numpy and
scipy, and never JAX. Its hand-written Hopper kernels live in ``csrc/`` and
are built at first use on a GPU (``_kernels.py``); on CPU tensors every
kernel's wrapper takes the plain PyTorch version beside it.

Two slices run end to end: image-level LaREx scoring (``models.resnet`` ->
``sampling`` / ``ops.mc_entropy_cuda`` -> ``ops.entropy`` /
``ops.entropy_cuda`` -> ``reduction`` -> ``detectors.latent`` ->
``inference.image_level.build_larex_scorer``) and the Llama LLM-uncertainty
path (``models.llama`` -> ``llm.generate`` -> ``llm.scores``). On the GPU
both run as replays of CUDA graphs (``utils.graphs``), the counterpart of the
JAX package's compiled programs.

Models, caches and converted states are built on :func:`default_device`, the
GPU, unless the caller names another device (the CPU tests pass
``device="cpu"``).
"""

import torch

__version__ = "0.1.0"

__all__ = ["default_device"]


def default_device() -> torch.device:
    """Where the port builds what it is not told to build elsewhere: the
    current CUDA device. It does not look whether there is one: without a
    GPU the first allocation raises."""
    return torch.device("cuda")
