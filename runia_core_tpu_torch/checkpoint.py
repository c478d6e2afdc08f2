"""Checkpoint / resume for detector, PCA, LaREx-pipeline and LLM state.

Counterpart of ``runia_core_tpu/checkpoint.py``, with its on-disk format:
one ``.npz`` per artifact, the same keys (``__runia_meta__`` holding the
scalars as JSON, ``det.*`` / ``pca.*`` and the ``__…__`` settings of a LaREx
pipeline, an LLM's ``params/...`` leaves with bf16 stored as uint16 bits
under ``::bf16`` and ``__llm_config__`` holding the flax field names). So an
artifact written by either package loads in the other.

Loaders put what they rebuild on ``device`` (None:
``runia_core_tpu_torch.default_device()``, the GPU); the plain
``load_state_dict`` returns numpy arrays, as the JAX package's does. The
orbax pair of the JAX package maps to ``torch.distributed.checkpoint``
(each rank writes the shards it owns; one process writes everything), under
the JAX package's names.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

import runia_core_tpu_torch
from runia_core_tpu_torch.detectors import postprocessors_dict
from runia_core_tpu_torch.detectors.base import Postprocessor
from runia_core_tpu_torch.models import CausalLM, LlamaLM, causal_lm_from_flax, llama_from_flax
from runia_core_tpu_torch.reduction import PCAState
from runia_core_tpu_torch.utils.placement import to_numpy

__all__ = [
    "save_detector",
    "load_detector",
    "save_pca",
    "load_pca",
    "save_state_dict",
    "load_state_dict",
    "save_state_dict_orbax",
    "load_state_dict_orbax",
    "save_larex_pipeline",
    "load_larex_scorer",
    "save_llm",
    "load_llm",
]

_META_KEY = "__runia_meta__"
_LLM_KEY = "__llm_config__"
_BF16_TAG = "::bf16"


def _device(device) -> torch.device:
    return runia_core_tpu_torch.default_device() if device is None else torch.device(device)


def _flatten_state(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    arrays, scalars = {}, {}
    for key, value in state.items():
        if value is None:
            scalars[key] = None
        elif np.isscalar(value) or isinstance(value, (int, float, bool, str)):
            scalars[key] = value.item() if hasattr(value, "item") else value
        else:
            arrays[key] = to_numpy(value)
    arrays[_META_KEY] = np.frombuffer(json.dumps(scalars).encode(), dtype=np.uint8)
    return arrays


def _unflatten_state(npz) -> Dict[str, Any]:
    state: Dict[str, Any] = {key: npz[key] for key in npz.files if key != _META_KEY}
    state.update(json.loads(bytes(npz[_META_KEY].tolist()).decode()))
    return state


def _on_device(state: Mapping[str, Any], device) -> Dict[str, Any]:
    """Every array of ``state`` as a tensor on ``device``; scalars as they are."""
    device = _device(device)
    return {key: torch.from_numpy(np.array(value)).to(device) if isinstance(value, np.ndarray) else value
            for key, value in state.items()}


def save_state_dict(path: Union[str, os.PathLike], state: Mapping[str, Any]) -> None:
    """Persist a state dict of arrays or tensors and scalars to one .npz."""
    np.savez(path, **_flatten_state(state))


def load_state_dict(path: Union[str, os.PathLike]) -> Dict[str, Any]:
    """The state of :func:`save_state_dict`: numpy arrays and scalars."""
    with np.load(path, allow_pickle=False) as npz:
        return _unflatten_state(npz)


def save_detector(path: Union[str, os.PathLike], detector: Postprocessor, name: Optional[str] = None) -> None:
    """Save a fitted detector's state and its registry name."""
    state = dict(detector.state)
    if name is None:
        name = next((reg for reg, cls in postprocessors_dict.items() if type(detector) is cls), None)
    if name is None:
        raise ValueError("Pass name= for unregistered detector classes")
    state["__detector_name__"] = name
    save_state_dict(path, state)


def load_detector(path: Union[str, os.PathLike], cfg=None, device=None) -> Postprocessor:
    """Re-create a fitted detector from a saved state file, its arrays as
    tensors on ``device``."""
    state = load_state_dict(path)
    name = state.pop("__detector_name__")
    detector = postprocessors_dict[name](cfg=cfg)
    detector.load_state(_on_device(state, device))
    if "threshold" in state:
        detector.threshold = float(np.asarray(state["threshold"]))
    return detector


def save_state_dict_orbax(path: Union[str, os.PathLike], state: Mapping[str, Any]) -> None:
    """Persist a (possibly sharded) nested state of tensors or arrays with
    ``torch.distributed.checkpoint``: each rank writes the shards it owns;
    without a process group, this process writes everything."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_tensor_tree(state), checkpoint_id=os.path.abspath(path), no_dist=_single_process())


def _single_process() -> bool:
    """No process group is running: this process reads and writes it all."""
    import torch.distributed as dist

    return not getattr(dist, "is_initialized", lambda: False)()


def _tensor_tree(tree):
    if isinstance(tree, Mapping):
        return {key: _tensor_tree(value) for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree
    return torch.from_numpy(np.array(tree))


def load_state_dict_orbax(path: Union[str, os.PathLike], like: Any = None) -> Dict[str, Any]:
    """Restore a :func:`save_state_dict_orbax` checkpoint. With ``like`` (a
    nested state of tensors, e.g. the live sharded parameters) each leaf is
    read into a copy of its counterpart, on its device and with its
    sharding; without it the whole tree is read into this process, on the
    CPU."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict_loader import _load_state_dict_from_keys

    path = os.path.abspath(path)
    if like is None:
        return _load_state_dict_from_keys(checkpoint_id=path)
    target = _clone_tree(like)
    dcp.load(target, checkpoint_id=path, no_dist=_single_process())
    return target


def _clone_tree(tree):
    if isinstance(tree, Mapping):
        return {key: _clone_tree(value) for key, value in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))


def save_pca(path: Union[str, os.PathLike], pca: PCAState) -> None:
    save_state_dict(path, {"mean": pca.mean, "components": pca.components,
                           "explained_variance": pca.explained_variance, "whiten": bool(pca.whiten)})


def load_pca(path: Union[str, os.PathLike], device=None) -> PCAState:
    state = _on_device(load_state_dict(path), device)
    return PCAState(mean=state["mean"], components=state["components"],
                    explained_variance=state["explained_variance"], whiten=bool(state["whiten"]))


def save_larex_pipeline(
    path: Union[str, os.PathLike],
    pca_state: Optional[PCAState],
    detector_state: Mapping[str, Any],
    mcd_samples_nro: int = 16,
    drop_block_prob: float = 0.5,
    drop_block_size: int = 3,
    tap: str = "pre_pool",
    channel_axis: int = 3,
    detector: str = "MD",
) -> None:
    """Persist everything :func:`inference.build_larex_scorer` needs but the
    model, in one .npz: the fitted PCA and detector state and the MC / tap
    settings. The model's weights go to their own checkpoint."""
    state: Dict[str, Any] = {
        "__mcd_samples_nro__": int(mcd_samples_nro),
        "__drop_block_prob__": float(drop_block_prob),
        "__drop_block_size__": int(drop_block_size),
        "__tap__": tap,
        "__channel_axis__": int(channel_axis),
        "__detector__": detector,
        "__has_pca__": pca_state is not None,
    }
    if pca_state is not None:
        state["pca.mean"] = pca_state.mean
        state["pca.components"] = pca_state.components
        state["pca.explained_variance"] = pca_state.explained_variance
        state["__pca_whiten__"] = bool(pca_state.whiten)
    for key, value in detector_state.items():
        state[f"det.{key}"] = to_numpy(value)
    save_state_dict(path, state)


def load_larex_scorer(path: Union[str, os.PathLike], forward, fused: bool = False, use_graph: bool = True,
                      device=None):
    """Rebuild the LaREx scorer from a saved pipeline artifact: the port's
    ``build_larex_scorer`` with the saved MC and tap settings, its state on
    ``device`` (the model's). ``forward`` is the model's ``images ->
    (logits, taps)``; ``fused`` and ``use_graph`` are the scorer's."""
    from runia_core_tpu_torch.inference import build_larex_scorer

    state = _on_device(load_state_dict(path), device)
    pca_state = None
    if state["__has_pca__"]:
        pca_state = PCAState(mean=state["pca.mean"], components=state["pca.components"],
                             explained_variance=state["pca.explained_variance"], whiten=bool(state["__pca_whiten__"]))
    detector_state = {}
    for key, value in state.items():
        if key.startswith("det."):
            detector_state[key[len("det."):]] = float(value) if value.ndim == 0 else value
    return build_larex_scorer(
        forward,
        pca_state=pca_state,
        detector_state=detector_state,
        mcd_samples_nro=int(state["__mcd_samples_nro__"]),
        drop_block_prob=float(state["__drop_block_prob__"]),
        drop_block_size=int(state["__drop_block_size__"]),
        tap=str(state["__tap__"]),
        channel_axis=int(state["__channel_axis__"]),
        detector=str(state["__detector__"]),
        fused=fused,
        use_graph=use_graph,
    )


# The JAX package's LLM classes: the port's class, its carrier of flax
# parameters, and the flax config fields in their order. The names are the
# port's constructor arguments too, but for ``dtype`` (a name in the file)
# and CausalLM's ``remat`` (training only: the port's CausalLM does not take
# it, and writes False).
_LLMS = {
    "LlamaLM": (LlamaLM, llama_from_flax, (
        "vocab_size", "num_layers", "num_heads", "num_kv_heads", "d_model", "hidden_dim", "max_len", "head_dim",
        "rope_theta", "rms_eps", "tie_embeddings", "dtype", "use_flash", "quantized", "quantized_kv", "fused_qkv",
        "attn_bias", "sliding_window", "embed_scale", "mlp_act", "num_experts", "num_experts_per_tok")),
    "CausalLM": (CausalLM, causal_lm_from_flax, (
        "vocab_size", "num_layers", "num_heads", "d_model", "max_len", "num_experts", "moe_capacity_factor", "ln_eps",
        "tie_embeddings", "remat")),
}


def save_llm(path: Union[str, os.PathLike], model, params: Optional[Mapping] = None) -> None:
    """Persist a port ``LlamaLM`` or ``CausalLM`` (its flax-named config and
    its parameters, or ``params`` = ``{"params": tree}``) to one .npz that
    the JAX package's ``load_llm`` reads too. int8 and bf16 leaves keep
    their dtypes (bf16 as uint16 bits)."""
    _, _, fields = _LLMS[type(model).__name__]
    cfg = {}
    for name in fields:
        value = getattr(model, name, False)
        cfg[name] = str(value).replace("torch.", "") if name == "dtype" else value
    if params is None:
        leaves = {"params/" + key.replace(".", "/"): t for key, t in model.state_dict().items()}
    else:
        leaves = {"/".join(p): leaf for p, leaf in _tree_items(params)}
    flat = {}
    for key, leaf in leaves.items():
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            flat[key + _BF16_TAG] = leaf.detach().cpu().view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = np.asarray(leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf)
    flat[_LLM_KEY] = np.frombuffer(json.dumps({"class": type(model).__name__, "config": cfg}).encode(),
                                   dtype=np.uint8)
    np.savez(path, **flat)


def _tree_items(tree, prefix=()):
    if isinstance(tree, Mapping):
        for key, value in tree.items():
            yield from _tree_items(value, prefix + (str(key),))
    else:
        yield prefix, tree


def load_llm(path: Union[str, os.PathLike], device=None):
    """Inverse of :func:`save_llm` (or of the JAX package's): ``(model,
    params)``, the port's ``LlamaLM`` or ``CausalLM`` on ``device`` with its
    weights loaded through ``llama_from_flax`` / ``causal_lm_from_flax``, and
    the ``{"params": tree}`` of numpy leaves it was loaded from (bf16 leaves
    widened to f32, exactly, and cast back to bf16 by the load)."""
    with np.load(path, allow_pickle=False) as npz:
        meta = json.loads(bytes(npz[_LLM_KEY]).decode())
        params: Dict[str, Any] = {}
        for key in npz.files:
            if key == _LLM_KEY:
                continue
            arr = npz[key]
            if key.endswith(_BF16_TAG):
                key = key[: -len(_BF16_TAG)]
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            node = params
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = arr
    cls, carrier, fields = _LLMS[meta["class"]]
    cfg = {name: meta["config"][name] for name in fields if name in meta["config"] and name != "remat"}
    if "dtype" in cfg:
        cfg["dtype"] = getattr(torch, cfg["dtype"])
    model = cls(**cfg, device=_device(device))
    model.load_state_dict(carrier(params, device=_device(device)))
    return model, params
