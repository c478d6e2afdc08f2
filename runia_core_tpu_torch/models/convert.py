"""Carry fitted state from the JAX package into the port, as numpy arrays.

``resnet_from_flax`` is the inverse of
``runia_core_tpu/models/torch_convert.py::convert_torch_resnet``: it maps a
flax ResNet ``{"params", "batch_stats"}`` tree onto the ``state_dict`` of
``models/resnet.py::ResNet``, whose module names follow the flax tree. The
other two helpers turn a JAX ``PCAState`` and an MD/KDE detector state into
the port's. Nothing here imports JAX: leaves only need ``np.asarray``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from runia_core_tpu_torch.reduction import PCAState

__all__ = ["detector_state_from_arrays", "pca_state_from_arrays", "resnet_from_flax"]


def _tensor(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _walk(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _walk(value, path + ".")
        else:
            yield path, value


def resnet_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` (numpy leaves) -> ResNet state_dict.

    Conv kernels go (kh, kw, in, out) -> (out, in, kh, kw); the dense head
    (in, out) -> (out, in); batch-norm ``scale``/``bias`` become
    ``weight``/``bias`` and ``mean``/``var`` become ``running_mean``/
    ``running_var``.
    """
    renames = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    state: Dict[str, torch.Tensor] = {}
    for tree in (variables["params"], variables.get("batch_stats", {})):
        for path, leaf in _walk(tree):
            module, name = path.rsplit(".", 1)
            array = np.asarray(leaf, dtype=np.float32)
            if name == "kernel":
                array = array.transpose(3, 2, 0, 1) if array.ndim == 4 else array.T
                state[f"{module}.weight"] = _tensor(array)
            else:
                state[f"{module}.{renames[name]}"] = _tensor(array)
    return state


def pca_state_from_arrays(state, device=None) -> PCAState:
    """A PCA state with ``mean``, ``components``, ``explained_variance`` and
    ``whiten`` attributes (a JAX ``PCAState``) -> the port's PCAState."""
    return PCAState(
        mean=_tensor(state.mean, device),
        components=_tensor(state.components, device),
        explained_variance=_tensor(state.explained_variance, device),
        whiten=bool(state.whiten),
    )


def detector_state_from_arrays(state: Mapping[str, Any], device=None) -> Dict[str, Any]:
    """An MD (``feats_mean``, ``precision``) or KDE (``train_embeddings``,
    ``bandwidth``) state dict -> tensors; scalars stay Python floats."""
    return {
        name: float(np.asarray(value)) if np.ndim(value) == 0 else _tensor(value, device)
        for name, value in state.items()
    }
