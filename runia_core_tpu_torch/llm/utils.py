"""Helpers of the LLM uncertainty scores (numpy, on the host): NLI
equivalence, semantic clustering, distributions and embeddings.

Counterpart of ``runia_core_tpu/llm/utils.py``, kept as the port's own copy
(that module is numpy and torch, but the port imports nothing of the JAX
package). The entailment judge is pluggable: an HF sequence-classification
model with its tokenizer (on the model's own device), an equivalence
callable ``(text1, text2) -> bool``, or a batched label callable
``(premises, hypotheses) -> labels`` such as
``models.deberta.wrap_torch_nli``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Union

import numpy as np
import torch
from scipy.special import softmax

__all__ = [
    "_are_equivalent",
    "_cluster_greedy",
    "_construct_embedding_matrix",
    "_get_probability_distribution",
    "_host",
    "_labels_equivalent",
    "_nli_predict",
    "_pairwise_equivalence_matrix",
    "_semantic_clustering",
    "_semantic_clustering_batched",
    "make_nli_batch_labels",
    "make_nli_equivalence",
]

# MNLI label ids in the deberta-mnli order.
_CONTRADICTION, _NEUTRAL = 0, 1


def _host(a) -> np.ndarray:
    """A torch tensor or array-like as a numpy array on the host."""
    return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)


def _nli_predict(model, tokenizer, premise: str, hypothesis: str) -> int:
    """argmax NLI label of one pair from an HF sequence-classification model."""
    inputs = tokenizer(premise, hypothesis, return_tensors="pt")
    if hasattr(model, "device"):
        inputs = {k: v.to(model.device) for k, v in inputs.items()}
    with torch.no_grad():
        logits = _host(model(**inputs).logits)
    return int(np.argmax(softmax(logits, axis=1), axis=1)[0])


def _labels_equivalent(fwd: int, bwd: int) -> bool:
    """The bidirectional decision rule: a contradiction either way rules
    equivalence out, two neutrals carry no evidence, anything else counts."""
    if _CONTRADICTION in (fwd, bwd):
        return False
    return not (fwd == _NEUTRAL and bwd == _NEUTRAL)


def _are_equivalent(model, tokenizer, text1: str, text2: str) -> bool:
    """NLI equivalence of two texts, asking both directions."""
    return _labels_equivalent(
        _nli_predict(model, tokenizer, text1, text2), _nli_predict(model, tokenizer, text2, text1)
    )


def make_nli_equivalence(model, tokenizer) -> Callable[[str, str], bool]:
    """An HF NLI model as an equivalence callable."""
    return lambda a, b: _are_equivalent(model, tokenizer, a, b)


def make_nli_batch_labels(model, tokenizer) -> Callable[..., np.ndarray]:
    """An HF NLI model as a batched label function: premises and hypotheses
    in, the (n,) argmax labels of one padded forward on the model's device
    out."""

    def batch_labels(premises: Sequence[str], hypotheses: Sequence[str]) -> np.ndarray:
        inputs = tokenizer(list(premises), list(hypotheses), return_tensors="pt", padding=True, truncation=True)
        if hasattr(model, "device"):
            inputs = {k: v.to(model.device) for k, v in inputs.items()}
        with torch.no_grad():
            logits = model(**inputs).logits
        return np.argmax(_host(logits), axis=1)

    return batch_labels


def _cluster_greedy(n: int, is_equivalent: Callable[[int, int], bool]) -> Dict[int, List[int]]:
    """First-fit clustering of 0..n-1: left to right, each index not yet
    placed opens a cluster and takes every later unplaced index equivalent
    to it. Only representative-candidate pairs are asked."""
    representative = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        if representative[i] >= 0:
            continue
        representative[i] = i
        for j in range(i + 1, n):
            if representative[j] < 0 and is_equivalent(i, j):
                representative[j] = i
    members: Dict[int, List[int]] = {}
    for idx, rep in enumerate(representative.tolist()):
        members.setdefault(rep, []).append(idx)
    return dict(enumerate(members.values()))


def _semantic_clustering(model_or_fn: Union[Callable[[str, str], bool], object], tokenizer,
                         texts: List[str]) -> Dict[int, List[int]]:
    """Clusters of semantically equivalent texts, one judge query per pair
    asked: ``model_or_fn`` is an equivalence callable (``tokenizer`` None)
    or an HF model with its tokenizer. The oracle of
    :func:`_semantic_clustering_batched`."""
    if callable(model_or_fn) and tokenizer is None:
        equivalent = model_or_fn
    else:
        equivalent = make_nli_equivalence(model_or_fn, tokenizer)
    return _cluster_greedy(len(texts), lambda i, j: bool(equivalent(texts[i], texts[j])))


def _pairwise_equivalence_matrix(batch_labels: Callable[..., np.ndarray], texts: Sequence[str]) -> np.ndarray:
    """(n, n) boolean equivalence from one batched call: both directions of
    every unordered pair in one batch of n (n - 1) rows, the decision rule
    applied to all of them at once."""
    n = len(texts)
    iu, ju = np.triu_indices(n, k=1)
    premises = [texts[i] for i in iu] + [texts[j] for j in ju]
    hypotheses = [texts[j] for j in ju] + [texts[i] for i in iu]
    mat = np.eye(n, dtype=bool)
    if premises:
        labels = np.asarray(batch_labels(premises, hypotheses))
        fwd, bwd = labels[: len(iu)], labels[len(iu):]
        eq = (fwd != _CONTRADICTION) & (bwd != _CONTRADICTION) & ((fwd != _NEUTRAL) | (bwd != _NEUTRAL))
        mat[iu, ju] = eq
        mat[ju, iu] = eq
    return mat


def _semantic_clustering_batched(model_or_fn: Union[Callable[..., np.ndarray], object], tokenizer,
                                 texts: List[str]) -> Dict[int, List[int]]:
    """The clusters of :func:`_semantic_clustering` from one judge call: the
    whole pairwise matrix first, then the same first-fit scan over it.
    ``model_or_fn`` is a batched label callable (``tokenizer`` None) or an
    HF model with its tokenizer."""
    if callable(model_or_fn) and tokenizer is None:
        batch_labels = model_or_fn
    else:
        batch_labels = make_nli_batch_labels(model_or_fn, tokenizer)
    mat = _pairwise_equivalence_matrix(batch_labels, texts)
    return _cluster_greedy(len(texts), lambda i, j: bool(mat[i, j]))


def _get_probability_distribution(logits) -> np.ndarray:
    """HF ``scores`` (tuple over steps of (1, V) logits) -> (steps, V)
    probabilities of the first sequence. A step without the batch axis is
    refused, as the reference fails on it."""
    steps = [_host(step) for step in logits]
    for step in steps:
        if step.ndim < 2:
            raise IndexError(f"a step of scores must be (batch, vocab); got shape {step.shape}")
    return np.stack([softmax(step[0], axis=-1) for step in steps])


def _construct_embedding_matrix(hidden_states, token_index: int = -1, layer_index: int = 15) -> np.ndarray:
    """EigenScore's (samples, D) matrix: the hidden state of one step and
    layer, squeezed."""
    return np.squeeze(_host(hidden_states[token_index][layer_index]))
