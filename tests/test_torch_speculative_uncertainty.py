"""compute_uncertainties over the port's speculative backend, against
runia_core_tpu's (the counterpart of tests/test_speculative_uncertainty.py).

The deterministic pass runs on the target through a TorchGenerator, so its
text and scores equal the JAX speculative backend's (perplexity and RAUQ
within 1e-5) and the port's plain TorchGenerator backend's; the sampled
scores come from the fused loop and are checked to be finite. eigen_score
and sampled scores on a greedy generator are refused before any decode.
"""

import numpy as np
import pytest
import torch

import jax

from runia_core_tpu.llm import SpeculativeGenerator as JaxSpeculativeGenerator
from runia_core_tpu.llm import compute_uncertainties as jax_compute_uncertainties
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
import runia_core_tpu_torch.llm.generate as generate
from runia_core_tpu_torch.llm import SpeculativeGenerator, TorchGenerator, compute_uncertainties, run_generation
from runia_core_tpu_torch.models import LlamaLM, llama_from_flax

torch.set_num_threads(1)

VOCAB, MAX_NEW = 64, 6
REQUESTS = [
    {"method_name": "perplexity"},
    {"method_name": "RAUQ"},
    {"method_name": "normalized_entropy"},
    {"method_name": "semantic_entropy"},
]


def _same(a, b):
    return a == b


@pytest.fixture(scope="module")
def models():
    out = []
    for key, cfg in ((0, dict(num_layers=2, num_heads=4, num_kv_heads=2, d_model=32, hidden_dim=64)),
                     (1, dict(num_layers=1, num_heads=2, num_kv_heads=1, d_model=16, hidden_dim=32))):
        module = JaxLlamaLM(vocab_size=VOCAB, max_len=64, **cfg)
        params = jax.tree_util.tree_map(np.asarray, module.init(jax.random.key(key), np.zeros((1, 8), np.int32)))
        port = LlamaLM(vocab_size=VOCAB, max_len=64, **cfg, device="cpu").eval()
        port.load_state_dict(llama_from_flax(params, device="cpu"))
        out += [module, params, port]
    return out


def _spec(models, **kw):
    return SpeculativeGenerator(models[2], models[5], gamma=3, max_new_tokens=MAX_NEW, **kw)


def test_scores_and_deterministic_parity(models):
    jt, tp, target, jd, dp, _ = models
    prompt = [1, 5, 9, 12]
    text_s, scores_s = compute_uncertainties(_spec(models, do_sample=True), None, prompt, REQUESTS, num_samples=3,
                                             entailment_model=_same)
    text_g, scores_g = compute_uncertainties(TorchGenerator(target, max_new_tokens=MAX_NEW), None, prompt, REQUESTS,
                                             num_samples=3, entailment_model=_same)
    text_j, scores_j = jax_compute_uncertainties(
        JaxSpeculativeGenerator(jt, tp, jd, dp, gamma=3, max_new_tokens=MAX_NEW, do_sample=True), None, prompt,
        REQUESTS, num_samples=3, entailment_model=_same, entailment_tokenizer=None)
    assert text_s == text_g == text_j
    for name in ("perplexity", "RAUQ_mean_all_tokens_rollout"):
        for other in (scores_g, scores_j):
            np.testing.assert_allclose(np.asarray(scores_s[name], np.float64).ravel(),
                                       np.asarray(other[name], np.float64).ravel(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    for name in ("normalized_entropy", "semantic_entropy"):
        assert np.isfinite(float(np.asarray(scores_s[name]).ravel()[0]))
    assert isinstance(scores_s["clusters"], dict)


def test_sampled_pass_reads_the_fused_loop(models):
    spec = _spec(models, do_sample=True)
    det, samp, text = run_generation(spec, None, [1, 2, 3], None, 4, needs_sampling=True, needs_hiddens=False)
    assert det["log_probs"].shape == (1, MAX_NEW) and len(det["attentions"]) == MAX_NEW
    assert samp["log_probs"].shape[0] == 4 and samp["hidden_states"] is None and len(samp["texts"]) == 4
    assert spec.greedy_generator.model is spec.target  # the greedy pass runs on the target
    with pytest.warns(UserWarning, match="temperature=0.5"):
        run_generation(spec, None, [1, 2, 3], {"temperature": 0.5, "top_k": 5}, 2, needs_sampling=True,
                       needs_hiddens=False)


def test_greedy_generator_is_kept_per_setting(models):
    spec = _spec(models, do_sample=True)
    first = spec.greedy_generator
    assert spec.greedy_generator is first
    assert (first.max_new_tokens, first.eos_id) == (spec.max_new_tokens, spec.eos_id)
    spec.max_new_tokens, spec.eos_id = spec.max_new_tokens + 1, 7
    again = spec.greedy_generator
    assert again is not first and (again.max_new_tokens, again.eos_id) == (spec.max_new_tokens, 7)


def test_eigen_score_and_greedy_sampling_are_refused(models):
    with pytest.raises(ValueError, match="eigen_score"):
        compute_uncertainties(_spec(models, do_sample=True), None, [1, 2, 3], [{"method_name": "eigen_score"}],
                              num_samples=2)
    with pytest.raises(ValueError, match="do_sample"):
        compute_uncertainties(_spec(models), None, [1, 2, 3], [{"method_name": "normalized_entropy"}], num_samples=2)


def test_deterministic_only_requests_work_without_sampling(models):
    _, result = compute_uncertainties(_spec(models), None, [1, 2, 3], [{"method_name": "perplexity"}])
    assert np.isfinite(float(result["perplexity"]))


def test_validation_happens_before_any_decode(models, monkeypatch):
    def explode(*args, **kwargs):  # pragma: no cover - must never be reached
        raise AssertionError("decode ran before request validation")

    monkeypatch.setattr(generate, "run_generation", explode)
    monkeypatch.setattr(generate.TorchGenerator, "generate", explode)
    monkeypatch.setattr(SpeculativeGenerator, "generate_samples", explode)
    with pytest.raises(ValueError, match="eigen_score"):
        compute_uncertainties(_spec(models, do_sample=True), None, [1, 2, 3], [{"method_name": "eigen_score"}],
                              num_samples=2)
