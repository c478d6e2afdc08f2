"""runia_core_tpu_torch: the PyTorch + CUDA port of runia_core_tpu.

The package mirrors ``runia_core_tpu``'s paths and names, so each module's
counterpart sits at the same relative path. It imports PyTorch, numpy and
scipy, and never JAX. Its hand-written Hopper kernels live in ``csrc/`` and
are built at first use on a GPU (``_kernels.py``); on CPU tensors every
kernel's wrapper takes the plain PyTorch version beside it.

This first slice carries image-level LaREx scoring end to end:
``models.resnet`` -> ``sampling`` / ``ops.mc_entropy_cuda`` ->
``ops.entropy`` / ``ops.entropy_cuda`` -> ``reduction`` ->
``detectors.latent`` -> ``inference.image_level.build_larex_scorer``.
"""

__version__ = "0.1.0"
