"""The port's LLM uncertainty scores against runia_core_tpu's.

Every score runs on the same numpy inputs in both packages and must agree in
f64 to 1e-6. compute_uncertainties runs end to end on one small f32 LlamaLM
(TorchGenerator vs JaxGenerator, weights carried by llama_from_flax): the
greedy-pass scores agree within 1e-4 relative (f32 log-probabilities and
attention rows that agree to about 1e-6); the sampled ones are only checked
to be finite, since the two random streams differ by design, but for
semantic entropy, which each package's function recomputes on the other's
sampled texts: the same clusters, the entropy to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.llm import JaxGenerator
from runia_core_tpu.llm import attention as jax_attention
from runia_core_tpu.llm import compute_uncertainties as jax_compute_uncertainties
from runia_core_tpu.llm import generate as jax_generate
from runia_core_tpu.llm import scores as jax_scores
from runia_core_tpu.llm import utils as jax_utils
from runia_core_tpu.models.llama import LlamaLM as JaxLlamaLM
from runia_core_tpu_torch.llm import TorchGenerator, compute_uncertainties
from runia_core_tpu_torch.llm import attention, generate, scores, utils
from runia_core_tpu_torch.models import LlamaLM, llama_from_flax

torch.set_num_threads(1)

P, STEPS, LAYERS, HEADS = 7, 5, 3, 4


def _attentions(rng, batch=1):
    """HF-shaped attentions: a (B, H, P, P) prompt block per layer, then one
    (B, H, 1, P + k) row per layer for steps k = 1..STEPS-1; rows normalised."""
    def rows(shape):
        a = rng.rand(*shape)
        return a / a.sum(-1, keepdims=True)

    out = [tuple(np.tril(rows((batch, HEADS, P, P))) for _ in range(LAYERS))]
    for k in range(1, STEPS):
        out.append(tuple(rows((batch, HEADS, 1, P + k)) for _ in range(LAYERS)))
    return tuple(out)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    lp = np.log(rng.uniform(0.05, 1.0, (1, STEPS)))
    sampled_lp = np.log(rng.uniform(0.05, 1.0, (4, STEPS)))
    sampled_lp[1, 3:] = -np.inf  # finished after EOS
    return {
        "attentions": _attentions(rng),
        "log_probs": lp,
        "sampled_log_probs": sampled_lp,
        "logits": tuple(rng.randn(1, 50) * 2 for _ in range(STEPS)),
        "hidden_states": tuple(tuple(rng.randn(4, 1, 32) for _ in range(LAYERS + 1)) for _ in range(STEPS)),
        "wide": rng.randn(4, 32),  # n < d: the Gram route
        "tall": rng.randn(40, 6),  # n >= d: the covariance route
    }


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=1e-6, atol=1e-6)


def test_attention_aggregations(inputs):
    att = inputs["attentions"]
    _close(attention._reconstruct_attention_matrix(att, P), jax_attention._reconstruct_attention_matrix(att, P))
    _close(attention._get_attention_rollout(att, P), jax_attention._get_attention_rollout(att, P))
    _close(attention._get_recurent_attention(att), jax_attention._get_recurent_attention(att))
    _close(attention._get_recurent_attention(att, 2), jax_attention._get_recurent_attention(att, 2))
    _close(attention._get_average_attention_all(att), jax_attention._get_average_attention_all(att))
    _close(attention._get_recurent_attention(att[:1]), jax_attention._get_recurent_attention(att[:1]))
    with pytest.raises(ValueError, match="batch 1"):
        attention._get_average_attention_all(_attentions(np.random.RandomState(1), batch=2))


def test_distribution_and_embedding_helpers(inputs):
    _close(utils._get_probability_distribution(inputs["logits"]),
           jax_utils._get_probability_distribution(inputs["logits"]))
    _close(utils._construct_embedding_matrix(inputs["hidden_states"], layer_index=2),
           jax_utils._construct_embedding_matrix(inputs["hidden_states"], layer_index=2))


@pytest.mark.parametrize("name", ["wide", "tall"])
def test_eigen_score(inputs, name):
    _close(scores.eigen_score_from_embeddings(inputs[name]), jax_scores.eigen_score_from_embeddings(inputs[name]))
    _close(scores.eigen_score(inputs["hidden_states"], layer_index=-1),
           jax_scores.eigen_score(inputs["hidden_states"], layer_index=-1))


def test_sequence_scores(inputs):
    _close(scores.normalized_entropy(inputs["sampled_log_probs"]),
           jax_scores.normalized_entropy(inputs["sampled_log_probs"]))
    _close(scores.perplexity(inputs["sampled_log_probs"]), jax_scores.perplexity(inputs["sampled_log_probs"]))
    _close(scores.generation_entropy(inputs["logits"]), jax_scores.generation_entropy(inputs["logits"]))


@pytest.mark.parametrize("empty", [np.zeros((0, 4)), []], ids=["zeros_0x4", "list"])
def test_normalized_entropy_of_no_sequences_raises_as_jax(empty):
    with pytest.raises(ZeroDivisionError):
        jax_scores.normalized_entropy(empty)
    with pytest.raises(ZeroDivisionError):
        scores.normalized_entropy(empty)


def test_generation_entropy_refuses_steps_without_the_batch_axis():
    rng = np.random.RandomState(3)
    steps = [rng.randn(11).astype(np.float32) for _ in range(5)]
    with pytest.raises(IndexError):
        jax_scores.generation_entropy(steps)
    with pytest.raises(IndexError):
        scores.generation_entropy(steps)
    batched = [s[None] for s in steps]
    batched[2][0, 4] = -np.inf
    assert scores.generation_entropy(batched) == jax_scores.generation_entropy(batched)


@pytest.mark.parametrize("token", ["original", "mean_all_tokens"])
@pytest.mark.parametrize("head", ["original", "mean_heads", "rollout"])
@pytest.mark.parametrize("ablation", [False, True])
def test_rauq(inputs, token, head, ablation):
    args = (inputs["log_probs"], inputs["attentions"], P, token, head, [0.2, 0.5], ablation)
    _close(scores.RAUQ(*args), jax_scores.RAUQ(*args))


@pytest.mark.parametrize("head", ["original", "mean_heads"])
def test_batched_rauq(head):
    rng = np.random.RandomState(2)
    lp = np.log(rng.uniform(0.05, 1.0, (3, STEPS)))
    prev = rng.rand(3, LAYERS, HEADS, STEPS - 1)
    _close(scores.batched_rauq(lp, prev, head), jax_scores.batched_rauq(lp, prev, head))
    with pytest.raises(KeyError):
        scores.batched_rauq(lp, prev, "rollout")


REQUESTS = [
    {"method_name": "perplexity"},
    {"method_name": "generation_entropy"},
    {"method_name": "RAUQ", "token_aggregation": "mean_all_tokens", "head_aggregation": "rollout"},
    {"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "original"},
    {"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "mean_heads", "alphas": [0.2]},
    {"method_name": "normalized_entropy"},
    {"method_name": "eigen_score", "layer_index": -1},
]
GREEDY = ["perplexity", "generation_entropy", "RAUQ_mean_all_tokens_rollout", "RAUQ_original_original",
          "RAUQ_original_mean_heads"]


def _parity_judge(premises, hypotheses):
    """A batched NLI stand-in over token-id texts: entailment when the first
    tokens share their parity, else contradiction."""
    return np.array([2 if p[:1] and h[:1] and p[0] % 2 == h[0] % 2 else 0 for p, h in zip(premises, hypotheses)])


_parity_judge.is_batch_labels = True


def _recording_texts(module, monkeypatch):
    """Record the sampled texts each compute_uncertainties call scores."""
    seen, real = [], module.run_generation

    def run_generation(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out[1]["texts"])
        return out

    monkeypatch.setattr(module, "run_generation", run_generation)
    return seen


def _keyed(clusters, texts):
    return {tuple(t): c for c, members in clusters.items() for t in (texts[i] for i in members)}


def test_compute_uncertainties_end_to_end(monkeypatch):
    cfg = dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, hidden_dim=128, max_len=256)
    jm = JaxLlamaLM(**cfg)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(1), jnp.zeros((1, 8), jnp.int32)))
    port = LlamaLM(**cfg, device="cpu")
    port.load_state_dict(llama_from_flax(params, device="cpu"))
    prompt = list(np.random.RandomState(3).randint(1, 128, 24))
    requests = REQUESTS + [{"method_name": "semantic_entropy"}]
    jax_texts, port_texts = _recording_texts(jax_generate, monkeypatch), _recording_texts(generate, monkeypatch)
    jtext, want = jax_compute_uncertainties(JaxGenerator(jm, params, max_new_tokens=6), None, prompt, requests,
                                            num_samples=3, entailment_model=_parity_judge)
    text, got = compute_uncertainties(TorchGenerator(port, max_new_tokens=6), None, prompt, requests, num_samples=3,
                                      entailment_model=_parity_judge)
    assert text == jtext
    assert sorted(got) == sorted(want) and "clusters" in got
    for name in GREEDY:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=0, err_msg=name)
    assert all(np.isfinite(got[name]) for name in ("normalized_entropy", "eigen_score"))
    # semantic entropy: each package's function on the other's sampled texts
    (port_texts,), (jax_texts,) = port_texts, jax_texts
    for result, texts, other in ((got, port_texts, jax_scores), (want, jax_texts, scores)):
        entropy, clusters = other.semantic_entropy(_parity_judge, None, texts)
        assert abs(result["semantic_entropy"] - entropy) <= 1e-12
        assert result["clusters"] == _keyed(clusters, texts)


def test_requests_fail_before_any_decode():
    with pytest.raises(KeyError, match="unknown"):
        compute_uncertainties(None, None, [1], [{"method_name": "nope"}])
    # a semantic_entropy request with a judge passes the request check; the backend check follows
    with pytest.raises(TypeError, match="TorchGenerator"):
        compute_uncertainties(None, None, [1], [{"method_name": "semantic_entropy"}], entailment_model=_parity_judge)
    with pytest.raises(TypeError, match="TorchGenerator"):
        compute_uncertainties(object(), None, [1], [{"method_name": "perplexity"}])
