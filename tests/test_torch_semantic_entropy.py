"""The port's semantic entropy and NLI clustering against runia_core_tpu's.

Fixed texts go through both packages' clustering with three kinds of judge:
an equivalence callable (asked pair by pair), a batched label callable
(``is_batch_labels``), and a tiny HF DeBERTa NLI with its tokenizer (also
through ``wrap_torch_nli`` against ``wrap_jax_nli``). Clusters must be
identical and the entropies agree to 1e-12 (the same few float64
operations in the same order).
"""

import numpy as np
import pytest
import torch

from runia_core_tpu.llm import scores as jax_scores
from runia_core_tpu.llm import utils as jax_utils
from runia_core_tpu.models import convert_hf_deberta as jax_convert_hf_deberta
from runia_core_tpu.models import wrap_jax_nli
from runia_core_tpu_torch.llm import scores, utils
from runia_core_tpu_torch.models import convert_hf_deberta, wrap_torch_nli

from test_torch_deberta import _TinyPairTokenizer, tiny_hf_deberta

torch.set_num_threads(1)

ENTROPY_ATOL = 1e-12
TEXTS = [
    "the cat sat on the mat", "the cat was sitting", "a dog ran far", "rain fell hard", "a dog slept",
    "the mat is red", "rain fell", "sun",
]


def _first_word_equivalent(a, b):
    return a.split()[0] == b.split()[0]


def _labels(premises, hypotheses):
    """Entailment (2) on a shared first word, neutral (1) on a shared
    length in words, else contradiction (0): every branch of the rule."""
    return np.array([2 if p.split()[0] == h.split()[0] else 1 if len(p.split()) == len(h.split()) else 0
                     for p, h in zip(premises, hypotheses)])


def _batched(premises, hypotheses):
    return _labels(premises, hypotheses)


_batched.is_batch_labels = True


class _PtTokenizer:
    """The toy pair tokenizer with torch tensors out, for an HF model: one
    pair of strings or lists of them."""

    def __init__(self):
        self.np_tok = _TinyPairTokenizer()

    def __call__(self, premises, hypotheses, return_tensors="pt", padding=True, truncation=True):
        if isinstance(premises, str):
            premises, hypotheses = [premises], [hypotheses]
        return {k: torch.tensor(v) for k, v in self.np_tok(premises, hypotheses).items()}


def _same(got, want):
    entropy, clusters = got
    assert clusters == want[1]
    assert abs(entropy - want[0]) <= ENTROPY_ATOL


def test_decision_rule_and_pairwise_matrix():
    for fwd in range(3):
        for bwd in range(3):
            assert utils._labels_equivalent(fwd, bwd) == jax_utils._labels_equivalent(fwd, bwd)
    np.testing.assert_array_equal(utils._pairwise_equivalence_matrix(_labels, TEXTS),
                                  jax_utils._pairwise_equivalence_matrix(_labels, TEXTS))
    np.testing.assert_array_equal(utils._pairwise_equivalence_matrix(_labels, TEXTS[:1]), np.eye(1, dtype=bool))


@pytest.mark.parametrize("texts", [TEXTS, TEXTS[:1], ["a b", "a c", "a d"], ["x", "y", "z"]],
                         ids=["eight", "one", "one_cluster", "all_apart"])
def test_clustering_with_callables(texts):
    assert utils._semantic_clustering(_first_word_equivalent, None, texts) == \
        jax_utils._semantic_clustering(_first_word_equivalent, None, texts)
    assert utils._semantic_clustering_batched(_labels, None, texts) == \
        jax_utils._semantic_clustering_batched(_labels, None, texts)
    _same(scores.semantic_entropy(_first_word_equivalent, None, texts),
          jax_scores.semantic_entropy(_first_word_equivalent, None, texts))
    _same(scores.semantic_entropy(_batched, None, texts), jax_scores.semantic_entropy(_batched, None, texts))


def test_a_marked_callable_takes_the_batched_route():
    calls = []

    def judge(premises, hypotheses):
        calls.append(len(premises))
        return _labels(premises, hypotheses)

    judge.is_batch_labels = True
    _same(scores.semantic_entropy(judge, None, TEXTS), jax_scores.semantic_entropy(_batched, None, TEXTS))
    assert calls == [len(TEXTS) * (len(TEXTS) - 1)]  # one call, both directions of every pair


@pytest.fixture(scope="module")
def hf_nli():
    return tiny_hf_deberta()


def test_hf_model_with_tokenizer(hf_nli):
    tok = _PtTokenizer()
    texts = TEXTS[:5]
    want_sequential = jax_utils._semantic_clustering(hf_nli, tok, texts)
    assert utils._semantic_clustering(hf_nli, tok, texts) == want_sequential
    assert utils._semantic_clustering_batched(hf_nli, tok, texts) == \
        jax_utils._semantic_clustering_batched(hf_nli, tok, texts) == want_sequential
    _same(scores.semantic_entropy(hf_nli, tok, texts), jax_scores.semantic_entropy(hf_nli, tok, texts))
    assert utils.make_nli_equivalence(hf_nli, tok)(texts[0], texts[1]) == \
        jax_utils.make_nli_equivalence(hf_nli, tok)(texts[0], texts[1])


def test_wrapped_deberta_judges(hf_nli):
    """The port's DeBERTa through wrap_torch_nli against the JAX one through
    wrap_jax_nli, both converted from the same HF model."""
    tok = _TinyPairTokenizer()
    port_model, _ = convert_hf_deberta(hf_nli, device="cpu")
    jax_model, jax_params = jax_convert_hf_deberta(hf_nli)
    port = wrap_torch_nli(port_model, tok, max_len=32, len_buckets=(16, 32), batch_bucket=8)
    jax_fn = wrap_jax_nli(jax_model, jax_params, tok, max_len=32, len_buckets=(16, 32), batch_bucket=8)
    _same(scores.semantic_entropy(port, None, TEXTS), jax_scores.semantic_entropy(jax_fn, None, TEXTS))
