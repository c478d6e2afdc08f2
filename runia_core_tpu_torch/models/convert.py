"""Carry fitted state from the JAX package into the port, as numpy arrays.

``resnet_from_flax`` is the inverse of
``runia_core_tpu/models/torch_convert.py::convert_torch_resnet``: it maps a
flax ResNet ``{"params", "batch_stats"}`` tree onto the ``state_dict`` of
``models/resnet.py::ResNet``, whose module names follow the flax tree;
``llama_from_flax``, ``deberta_from_flax``, ``causal_lm_from_flax`` and
``neox_from_flax`` do the same for a JAX ``LlamaLM``,
``DebertaV2Classifier``, ``CausalLM`` (GPT-2) and ``NeoXLM`` and their
counterparts in ``models/llama.py``, ``models/deberta.py``,
``models/transformer.py`` and ``models/neox.py``. The other two helpers turn a
JAX ``PCAState`` and an MD/KDE detector state into the port's. Nothing here imports JAX:
leaves only need ``np.asarray``. Every helper makes its tensors on
``device``; None is ``runia_core_tpu_torch.default_device()``, the GPU.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from runia_core_tpu_torch import default_device
from runia_core_tpu_torch.reduction import PCAState

__all__ = [
    "causal_lm_from_flax", "deberta_from_flax", "detector_state_from_arrays", "llama_from_flax", "neox_from_flax",
    "pca_state_from_arrays", "resnet_from_flax",
]


def _on(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def _tensor(a, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(_on(device))


def _walk(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _walk(value, path + ".")
        else:
            yield path, value


def resnet_from_flax(variables: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
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
                state[f"{module}.weight"] = _tensor(array, device)
            else:
                state[f"{module}.{renames[name]}"] = _tensor(array, device)
    return state


def llama_from_flax(params: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A JAX ``LlamaLM`` or ``DebertaV2Classifier`` parameter tree
    ``{"params": ...}`` (numpy leaves) -> the port's state_dict for the same
    model: each leaf under its dotted path, in its dtype (f32, bf16 or int8).

    The port's models keep the flax names and layouts (kernels stay (in,
    out)), so nothing is renamed or transposed. LlamaLM: float32 and bfloat16
    kernels, embeddings and norms; int8 ``kernel_q`` with f32 ``scale``; the
    fused ``qkv``/``gateup`` entries; q/k/v biases; an MoE block's ``router``
    kernel and its (E, in, out) ``w_gate`` / ``w_up`` / ``w_down`` stacks, or
    their int8 ``*_q`` with (E, out) ``*_scale``. DebertaV2Classifier: the
    conv kernel (K, in/groups, out), LayerNorm ``scale``/``bias``,
    ``rel_embeddings``; ``load_state_dict`` casts each leaf to the model's
    dtype.
    """
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(params["params"]):
        array = np.asarray(leaf)
        if array.dtype.name == "bfloat16":  # ml_dtypes: exact through f32
            state[path] = torch.from_numpy(array.astype(np.float32)).to(_on(device), torch.bfloat16)
        elif array.dtype in (np.float32, np.int8):
            state[path] = torch.from_numpy(np.array(array)).to(_on(device))
        else:
            raise ValueError(f"{path}: unexpected dtype {array.dtype}")
    return state


# The DeBERTa, CausalLM (GPT-2: ``LayerNorm_0``, ``Dense_0``, ``pos_embed``,
# the MoE ``moe_gate`` kernel and ``moe_w_in`` / ``moe_w_out`` stacks) and
# NeoXLM trees carry across by the same rule: the port's models keep the flax
# names and (in, out) layouts.
deberta_from_flax = llama_from_flax
causal_lm_from_flax = llama_from_flax
neox_from_flax = llama_from_flax


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
