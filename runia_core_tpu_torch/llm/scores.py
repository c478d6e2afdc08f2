"""LLM hallucination / uncertainty scores (numpy, on the host).

Counterpart of ``runia_core_tpu/llm/scores.py``: eigen score, normalized
entropy, semantic entropy, perplexity, generation entropy, the three RAUQ
head aggregations, their batched form, and :func:`compute_uncertainties`,
which runs a :class:`~runia_core_tpu_torch.llm.generate.TorchGenerator` and
scores its output. The scores read HF-shaped outputs (tuples of arrays), as
the JAX package's do. Semantic entropy clusters the sampled texts with an
NLI judge, on the card through ``models.deberta.wrap_torch_nli``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from runia_core_tpu_torch.llm.attention import (
    _get_attention_rollout,
    _get_average_attention_all,
    _get_recurent_attention,
)
from runia_core_tpu_torch.llm.utils import (
    _construct_embedding_matrix,
    _get_probability_distribution,
    _host,
    _semantic_clustering,
    _semantic_clustering_batched,
)

__all__ = [
    "RAUQ",
    "batched_rauq",
    "compute_uncertainties",
    "eigen_score",
    "eigen_score_from_embeddings",
    "generation_entropy",
    "normalized_entropy",
    "perplexity",
    "rauq_uncertainty",
    "rauq_uncertainty_mean_heads",
    "rauq_uncertainty_rollout",
    "semantic_entropy",
]


def eigen_score(hidden_states, alpha: float = 1e-3, layer_index: int = 15) -> float:
    """EigenScore (Chen et al. 2024) of the sampled continuations: the mean
    log eigenvalue of the regularised covariance of the last step's hidden
    states at ``layer_index``."""
    return eigen_score_from_embeddings(
        _construct_embedding_matrix(hidden_states, layer_index=layer_index), alpha=alpha
    )


def eigen_score_from_embeddings(embeddings, alpha: float = 1e-3) -> float:
    """EigenScore of a (samples, d) embedding matrix, in f64.

    With n < d samples the (d, d) covariance has the n eigenvalues of the
    (n, n) Gram of the centred rows and d - n zeros, so the Gram's
    eigenvalues give the score without the d^3 decomposition; otherwise the
    covariance's singular values are taken directly."""
    emb = _host(embeddings).astype(np.float64)
    if emb.ndim == 2 and 1 < emb.shape[0] < emb.shape[1]:
        n, d = emb.shape
        centred = emb - emb.mean(axis=0)
        eig = np.clip(np.linalg.eigvalsh(centred @ centred.T / (n - 1)), 0.0, None)
        return float((np.log(eig + alpha).sum() + (d - n) * np.log(alpha)) / d)
    cov = np.cov(emb.T)
    singular = np.linalg.svd(cov + alpha * np.eye(cov.shape[0]), compute_uv=False)
    return float(np.log(singular).mean())


def normalized_entropy(log_probs) -> float:
    """Length-normalised negative log-likelihood averaged over the sampled
    sequences (Malinin & Gales 2021); -inf entries (after EOS) are left out."""
    lp = _host(log_probs)
    per_sequence = [row[row != -np.inf].sum() / (row != -np.inf).sum() for row in lp]
    return float(-np.sum(per_sequence) / len(lp))


def semantic_entropy(model, tokenizer, texts: List[str]) -> Tuple[float, Dict[int, List[int]]]:
    """Discrete semantic entropy over NLI-equivalence clusters (Kuhn et al.
    2023): -sum p log p over the clusters' shares of the texts.

    ``model`` is an HF NLI model with ``tokenizer``, a batched label
    callable carrying ``is_batch_labels`` (``models.deberta.wrap_torch_nli``)
    with ``tokenizer`` None, or an equivalence callable with ``tokenizer``
    None. The first two ask every pair in one batched call
    (``_semantic_clustering_batched``); the equivalence callable is asked
    pair by pair (``_semantic_clustering``). Returns (entropy, {cluster:
    text indices})."""
    if tokenizer is not None or getattr(model, "is_batch_labels", False):
        clusters = _semantic_clustering_batched(model, tokenizer, texts)
    else:
        clusters = _semantic_clustering(model, tokenizer, texts)
    total = sum(len(indices) for indices in clusters.values())
    entropy = 0.0
    for indices in clusters.values():
        p = len(indices) / total
        if p > 0:
            entropy -= p * np.log(p)
    return float(entropy), clusters


def perplexity(log_probs) -> float:
    """Mean negative log-probability of the generated tokens (finite entries)."""
    lp = _host(log_probs)
    return float(-lp[np.isfinite(lp)].mean())


def generation_entropy(logits) -> float:
    """Vocabulary-normalised entropy of each step's distribution, averaged."""
    probs = _get_probability_distribution(logits)
    entropy = -(probs * np.log(np.clip(probs, 1e-12, None))).sum(axis=-1) / np.log(probs.shape[-1])
    return float(np.mean(entropy))


def _rauq_confidence(probs: np.ndarray, attention: np.ndarray, alpha: float) -> np.ndarray:
    """c_0 = p_0, c_i = alpha p_i + (1 - alpha) a_i c_{i-1} over the rows of
    ``attention`` (N, ...); its first row is not read."""
    confidence = np.zeros(attention.shape)
    confidence[0] = probs[0] if probs.ndim else float(probs)
    for i in range(1, attention.shape[0]):
        confidence[i] = alpha * probs[i] + (1 - alpha) * attention[i] * confidence[i - 1]
    return confidence


_TOKEN_AGGREGATIONS = {"original": _get_recurent_attention, "mean_all_tokens": _get_average_attention_all}


def _per_layer_rauq(log_probs, per_step: np.ndarray, alphas, ablation):
    """Max over layers of the mean -log confidence, for each alpha;
    ``per_step`` is (N, L)."""
    probs = np.exp(np.squeeze(_host(log_probs)))
    scores = [float((-np.log(_rauq_confidence(probs, per_step, a))).mean(axis=0).max()) for a in alphas]
    return scores if ablation else scores[0]


def rauq_uncertainty(log_probs, attentions, token_aggregation: str, alphas: Sequence[float] = (0.2,),
                     ablation: bool = False, attention_weights: Optional[np.ndarray] = None):
    """RAUQ (Vazhentsev et al. 2025) with each layer's most attentive head:
    the head whose mean weight over steps 1.. is largest."""
    if attention_weights is None:
        attention_weights = _TOKEN_AGGREGATIONS[token_aggregation](attentions)
    weights = _host(attention_weights)  # (L, H, N)
    heads = weights[:, :, 1:].mean(axis=2).argmax(axis=1)
    per_step = weights[np.arange(weights.shape[0]), heads, :].T  # (N, L)
    return _per_layer_rauq(log_probs, per_step, alphas, ablation)


def rauq_uncertainty_mean_heads(log_probs, attentions, token_aggregation: str, alphas: Sequence[float] = (0.3,),
                                ablation: bool = False, attention_weights: Optional[np.ndarray] = None):
    """RAUQ with the attention averaged over heads."""
    if attention_weights is None:
        attention_weights = _TOKEN_AGGREGATIONS[token_aggregation](attentions)
    return _per_layer_rauq(log_probs, _host(attention_weights).mean(axis=1).T, alphas, ablation)


def rauq_uncertainty_rollout(log_probs, attentions, token_aggregation: str, input_length: int,
                             alphas: Sequence[float] = (0.4,), ablation: bool = False,
                             attention_rollout: Optional[np.ndarray] = None):
    """RAUQ over the attention rollout of the whole sequence."""
    lp = _host(log_probs)
    rollout = _get_attention_rollout(attentions, input_length) if attention_rollout is None else attention_rollout
    t = lp.shape[1]
    if token_aggregation == "original":
        attention = np.diagonal(rollout, offset=-1)[-t:]
    elif token_aggregation == "mean_all_tokens":
        attention = rollout[:, -t:].mean(axis=0)
    else:
        raise KeyError(token_aggregation)
    probs = np.exp(np.squeeze(lp))
    n = probs.shape[0]
    scores = [float(-np.log(_rauq_confidence(probs, attention, a)[:n]).mean()) for a in alphas]
    return scores if ablation else scores[0]


def RAUQ(log_probs, attentions, input_length, token_aggregation, head_aggregation, alphas, ablation):
    """RAUQ under one of the three head aggregations."""
    if head_aggregation == "rollout":
        return rauq_uncertainty_rollout(log_probs, attentions, token_aggregation, input_length, alphas, ablation)
    by_heads = {"original": rauq_uncertainty, "mean_heads": rauq_uncertainty_mean_heads}
    return by_heads[head_aggregation](log_probs, attentions, token_aggregation, alphas, ablation)


def batched_rauq(log_probs, prev_token_attention, head_aggregation: str = "original",
                 alphas: Sequence[float] = (0.2,), ablation: bool = False) -> Union[np.ndarray, List]:
    """RAUQ of every prompt of a ``TorchGenerator.generate_batch`` run from
    its log_probs (B, T) and prev_token_attention (B, L, H, T-1) (the
    "original" token aggregation). "rollout" needs the dense attention of a
    single-prompt ``generate``."""
    by_heads = {"original": rauq_uncertainty, "mean_heads": rauq_uncertainty_mean_heads}
    if head_aggregation not in by_heads:
        raise KeyError(f"{head_aggregation!r}: batched RAUQ supports {sorted(by_heads)}")
    lp = _host(log_probs)
    out = [
        by_heads[head_aggregation](lp[b], None, "original", alphas, ablation,
                                   attention_weights=prev_token_attention[b])
        for b in range(lp.shape[0])
    ]
    return out if ablation else np.asarray(out)


# Methods that read the sampled continuations; the others read the greedy one.
_SAMPLED = ("eigen_score", "normalized_entropy", "semantic_entropy")
_GREEDY = ("perplexity", "generation_entropy", "RAUQ")


def _score_key(request: Dict[str, Any]) -> str:
    method = request["method_name"]
    if method != "RAUQ":
        return method
    return f"RAUQ_{request.get('token_aggregation', 'mean_all_tokens')}_{request.get('head_aggregation', 'rollout')}"


def _score(request: Dict[str, Any], greedy: Dict[str, Any], sampled: Dict[str, Any], entailment):
    method = request["method_name"]
    if method == "semantic_entropy":
        return semantic_entropy(*entailment, sampled["texts"])
    if method == "eigen_score":
        return eigen_score(sampled["hidden_states"], layer_index=request.get("layer_index", 15))
    if method == "normalized_entropy":
        return normalized_entropy(sampled["log_probs"])
    if method == "perplexity":
        return perplexity(greedy["log_probs"])
    if method == "generation_entropy":
        return generation_entropy(greedy["logits"])
    return RAUQ(
        greedy["log_probs"], greedy["attentions"], greedy["input_length"],
        request.get("token_aggregation", "mean_all_tokens"), request.get("head_aggregation", "rollout"),
        request.get("alphas", [0.3]), request.get("ablation", False),
    )


def compute_uncertainties(
    model,
    tokenizer,
    prompt,
    uncertainty_requests: List[Dict[str, Any]],
    gen_config=None,
    num_samples: int = 5,
    entailment_model=None,
    entailment_tokenizer=None,
) -> Tuple[list, Dict[str, Any]]:
    """Generate from ``prompt`` with a TorchGenerator and compute each
    requested score.

    ``uncertainty_requests`` are dicts with a ``method_name`` among
    eigen_score, normalized_entropy, semantic_entropy, perplexity,
    generation_entropy and RAUQ (with ``token_aggregation``,
    ``head_aggregation``, ``alphas``, ``ablation``), and eigen_score's
    ``layer_index``. ``tokenizer`` may be None, and then ``prompt`` is a list
    of token ids and texts are id lists. semantic_entropy's judge is
    ``entailment_model`` (with ``entailment_tokenizer``), as
    :func:`semantic_entropy` takes it; without one, the reference's
    ``microsoft/deberta-v2-xxlarge-mnli`` is loaded from the HF hub, as the
    JAX package does. Every request is checked before any decode work. The
    greedy pass runs always; the sampled pass (``num_samples``
    continuations, sampling settings from ``gen_config``) only for the
    methods that read it.

    Returns (greedy text as a one-element list, {score name: value}); a
    RAUQ score is named ``RAUQ_<token_aggregation>_<head_aggregation>``.
    With semantic_entropy, ``scores["clusters"]`` maps each sampled text
    (an id list as a tuple) to its cluster.
    """
    from runia_core_tpu_torch.llm.generate import run_generation, validate_generation_request

    methods = [request["method_name"] for request in uncertainty_requests]
    unknown = sorted(set(methods) - set(_SAMPLED) - set(_GREEDY))
    if unknown:
        raise KeyError(f"unknown uncertainty method(s) {unknown}; valid: {sorted(_SAMPLED + _GREEDY)}")
    needs_sampling = any(method in _SAMPLED for method in methods)
    validate_generation_request(model, needs_sampling, needs_hiddens="eigen_score" in methods)
    if "semantic_entropy" in methods and entailment_model is None:  # pragma: no cover (a hub download)
        from transformers import AutoModelForSequenceClassification, AutoTokenizer

        entailment_model = AutoModelForSequenceClassification.from_pretrained(
            "microsoft/deberta-v2-xxlarge-mnli", device_map="auto"
        )
        entailment_tokenizer = AutoTokenizer.from_pretrained("microsoft/deberta-v2-xxlarge-mnli")
    greedy, sampled, text = run_generation(
        model, tokenizer, prompt, gen_config, num_samples, needs_sampling,
        needs_attentions="RAUQ" in methods, needs_hiddens="eigen_score" in methods,
    )
    scores: Dict[str, Any] = {}
    for request in uncertainty_requests:
        key, value = _score_key(request), _score(request, greedy, sampled, (entailment_model, entailment_tokenizer))
        if request["method_name"] != "semantic_entropy":
            scores[key] = value
            continue
        # Without a tokenizer the texts are id lists: tuples, to be keys.
        scores[key], clusters = value
        scores["clusters"] = {
            (tuple(t) if isinstance(t, list) else t): cluster
            for cluster, members in clusters.items()
            for t in (sampled["texts"][i] for i in members)
        }
    return text, scores
