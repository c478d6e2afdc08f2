"""Helpers of the LLM uncertainty scores (numpy, on the host).

Counterpart of the distribution and embedding helpers of
``runia_core_tpu/llm/utils.py``. The NLI equivalence and clustering helpers
wait for the port of ``models/deberta.py`` (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
from scipy.special import softmax

__all__ = ["_construct_embedding_matrix", "_get_probability_distribution", "_host"]


def _host(a) -> np.ndarray:
    """A torch tensor or array-like as a numpy array on the host."""
    return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)


def _get_probability_distribution(logits) -> np.ndarray:
    """HF ``scores`` (tuple over steps of (1, V) logits) -> (steps, V)
    probabilities of the first sequence."""
    return np.stack([softmax(_host(step)[0], axis=-1) for step in logits])


def _construct_embedding_matrix(hidden_states, token_index: int = -1, layer_index: int = 15) -> np.ndarray:
    """EigenScore's (samples, D) matrix: the hidden state of one step and
    layer, squeezed."""
    return np.squeeze(_host(hidden_states[token_index][layer_index]))
