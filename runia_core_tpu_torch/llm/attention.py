"""Attention aggregation for the LLM uncertainty scores (numpy, on the host).

Counterpart of the HF-structure functions of
``runia_core_tpu/llm/attention.py``: each takes ``attentions`` as
generation backends return it, a tuple over generated steps of tuples over
layers of (1, H, tgt, src) arrays (step 0 the (P, P) prompt block, step k a
single row of P + k keys). The reference's quirks are kept: step k's row
lands at matrix row P + k, so row P stays empty and becomes an identity row
in the rollout. ``StreamingAttentionAggregator`` waits for the serving
slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "_get_attention_rollout",
    "_get_average_attention_all",
    "_get_recurent_attention",
    "_reconstruct_attention_matrix",
]


def _host(a) -> np.ndarray:
    a = np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)
    if a.shape[0] != 1:
        raise ValueError(f"attention aggregation expects batch 1, got batch {a.shape[0]}")
    return a[0]


def _step_rows(per_layer) -> np.ndarray:
    """One generated step's per-layer (1, H, 1, t) rows -> (L, H, t)."""
    return np.stack([_host(a)[:, 0, :] for a in per_layer])


def _reconstruct_attention_matrix(attentions, input_length: int) -> np.ndarray:
    """The dense (L, H, N, N) attention map, N = P + number of steps."""
    prompt = np.stack([_host(a) for a in attentions[0]])  # (L, H, P, P)
    n = input_length + len(attentions)
    full = np.zeros(prompt.shape[:2] + (n, n))
    full[:, :, :input_length, :input_length] = prompt
    for step in range(1, len(attentions)):
        row = input_length + step
        full[:, :, row, :row] = _step_rows(attentions[step])
    return full


def _get_attention_rollout(attentions, input_length: int) -> np.ndarray:
    """(N, N) attention rollout: per layer the head mean plus the identity,
    row-normalised, multiplied up the stack (first layer rightmost)."""
    mean = _reconstruct_attention_matrix(attentions, input_length).mean(axis=1)
    augmented = mean + np.eye(mean.shape[-1])
    augmented /= augmented.sum(axis=-1, keepdims=True)
    joint = augmented[0]
    for layer in augmented[1:]:
        joint = layer @ joint
    return joint


def _get_recurent_attention(attentions, position: int = 1) -> np.ndarray:
    """(L, H, steps - 1): each generated step's weight on the key
    ``position`` places back (the previous token by default)."""
    if len(attentions) < 2:
        layers, heads = len(attentions[0]), _host(attentions[0][0]).shape[0]
        return np.zeros((layers, heads, 0))
    return np.stack([_step_rows(step)[..., -position - 1] for step in attentions[1:]], axis=-1)


def _get_average_attention_all(attentions) -> np.ndarray:
    """(L, H, steps): each step's mean attention over its keys; step 0
    reads row 0 of the prompt block (the reference's generated_idx = 0)."""
    return np.stack([_step_rows(step).mean(axis=-1) for step in attentions], axis=-1)
