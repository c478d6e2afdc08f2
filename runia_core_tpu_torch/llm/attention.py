"""Attention aggregation for the LLM uncertainty scores (numpy, on the host).

Counterpart of the HF-structure functions of
``runia_core_tpu/llm/attention.py``: each takes ``attentions`` as
generation backends return it, a tuple over generated steps of tuples over
layers of (1, H, tgt, src) arrays (step 0 the (P, P) prompt block, step k a
single row of P + k keys). The reference's quirks are kept: step k's row
lands at matrix row P + k, so row P stays empty and becomes an identity row
in the rollout. :class:`StreamingAttentionAggregator` folds the same
aggregations into a decode loop, one step at a time.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "StreamingAttentionAggregator",
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


def _augment(mean: np.ndarray) -> np.ndarray:
    """(head-mean attention + I), row-normalised (the rollout's layer)."""
    augmented = mean + np.eye(mean.shape[-1])
    return augmented / augmented.sum(axis=-1, keepdims=True)


class StreamingAttentionAggregator:
    """The three aggregations above, fed one step at a time::

        agg = StreamingAttentionAggregator(input_length=P)
        agg.prefill(attentions[0])       # per layer (1, H, P, P)
        for step in attentions[1:]:
            agg.step(step)               # per layer (1, H, 1, P + k)
        agg.rollout                      # == _get_attention_rollout(...)
        agg.prev_token_attention         # == _get_recurent_attention(...)
        agg.mean_past_attention          # == _get_average_attention_all(...)

    Each step keeps one (L, H) vector per aggregation, and the rollout is
    kept as the partial products P_k = A_k ... A_1, one per layer: the A_k
    are lower-triangular, so a new token leaves every old row of every P_k
    as it is and adds the row (new row of A_k) @ P_{k-1}. Memory is
    O(L N^2) instead of the dense map's O(L H N^2). The reference's quirks
    stay: row P (the first generated token) is empty and becomes an
    identity row, and step k's identity lands at column P + k, one past its
    attention span.
    """

    def __init__(self, input_length: int, track_rollout: bool = True):
        self.input_length = input_length
        self.track_rollout = track_rollout
        self._prev_token, self._mean_past, self._partials = [], [], []

    def _append_rows(self, layer_rows) -> None:
        """Append one augmented, normalised row per layer to the partial
        products (P_0 = I)."""
        n = layer_rows[0].shape[0]
        prev, grown_all = None, []
        for k, row in enumerate(layer_rows):
            new_row = row if prev is None else row @ prev
            if k < len(self._partials):
                grown = np.zeros((n, n))
                old = self._partials[k]
                grown[: old.shape[0], : old.shape[1]] = old
                grown[n - 1] = new_row
            else:
                grown = new_row[None, :]
            grown_all.append(grown)
            prev = grown
        self._partials = grown_all

    def prefill(self, attn) -> None:
        """The prompt block, per layer (1, H, P, P); records the reference's
        step-0 mean-past entry (row 0 of the block) and the empty row P."""
        p = self.input_length
        mats = [_host(a) for a in attn]  # (H, P, P)
        self._mean_past.append(np.stack([m[:, 0, :].mean(axis=1) for m in mats]))
        if self.track_rollout:
            prev, partials = None, []
            for m in mats:
                aug = _augment(m.mean(axis=0))
                prev = aug if prev is None else aug @ prev
                partials.append(prev.copy())
            self._partials = partials
            identity = np.zeros(p + 1)
            identity[p] = 1.0
            self._append_rows([identity for _ in mats])

    def step(self, attn_rows) -> None:
        """One generated token's attention, per layer (1, H, 1, t), t = P + k
        at step k >= 1."""
        rows = [_host(a)[:, 0, :] for a in attn_rows]  # (H, t)
        t = rows[0].shape[-1]
        self._prev_token.append(np.stack([r[:, -2] for r in rows]))
        self._mean_past.append(np.stack([r.mean(axis=1) for r in rows]))
        if self.track_rollout:
            layer_rows = []
            for r in rows:
                full = np.zeros(t + 1)
                full[:t] = r.mean(axis=0)
                full[t] += 1.0  # the identity at column t (the reference's row index)
                layer_rows.append(full / full.sum())
            self._append_rows(layer_rows)

    @property
    def prev_token_attention(self) -> np.ndarray:
        """(L, H, steps - 1), as ``_get_recurent_attention``."""
        if not self._prev_token:
            return np.zeros((0, 0, 0))
        return np.stack(self._prev_token, axis=-1)

    @property
    def mean_past_attention(self) -> np.ndarray:
        """(L, H, steps), as ``_get_average_attention_all``."""
        return np.stack(self._mean_past, axis=-1)

    @property
    def rollout(self) -> np.ndarray:
        """(N, N) joint rollout, as ``_get_attention_rollout``."""
        if not self.track_rollout:
            raise ValueError("rollout tracking is off (track_rollout=False)")
        return self._partials[-1]
