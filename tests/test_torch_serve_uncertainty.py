"""The port's batch uncertainty serving (UncertaintyServer,
serve_uncertainties) against runia_core_tpu's, on the CPU.

The model is the JAX engine's test model (test_torch_continuous.py),
carried across with llama_from_flax. Deterministic scores (perplexity,
generation entropy, RAUQ) and texts must equal JAX's server's within 1e-5;
the sampled methods are held to JAX's at a temperature of 1e-4, where every
sample is the greedy trace (normalized entropy = the deterministic mean
NLL, eigen_score = log(alpha), semantic entropy 0 in one cluster), because
the two frameworks' random streams differ by design. The validation errors
carry JAX's type and wording.
"""

import numpy as np
import pytest
import torch

import jax

from runia_core_tpu.llm import UncertaintyServer as JaxServer
from runia_core_tpu.llm import serve_uncertainties as jax_serve
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
from runia_core_tpu_torch.llm import ContinuousBatchingEngine, UncertaintyServer, serve_uncertainties
from runia_core_tpu_torch.llm.serve_uncertainty import _make_engine
from test_torch_continuous import CFG, VOCAB, _port

torch.set_num_threads(1)

MAX_NEW = 8
ATOL = 1e-5
ENGINE_KW = dict(num_slots=2, chunk_tokens=4, prefill_chunk=8)
DET_REQUESTS = [
    {"method_name": "perplexity"},
    {"method_name": "generation_entropy"},
    {"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "original"},
]
COLD = 1e-4  # every draw is the argmax


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlamaLM(**CFG)
    params = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    return jm, params, _port(params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(17)
    return [list(rng.randint(1, VOCAB, rng.randint(4, 14))) for _ in range(5)]


class _Words:
    """decode(ids) -> words, coarse enough that distinct samples can share
    a first word."""

    def decode(self, ids):
        return " ".join(f"w{int(i) % 5}" for i in ids)


def _same(a, b):
    return list(a) == list(b)


def assert_same_scores(got, want, keys):
    for g, w in zip(got, want):
        for key in keys:
            np.testing.assert_allclose(g[key], w[key], atol=ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("fused", [False, True], ids=["interactive", "fused"])
def test_deterministic_scores_equal_jax(pair, prompts, fused):
    jm, params, port = pair
    requests = DET_REQUESTS if not fused else DET_REQUESTS[:2]
    kw = dict(max_new_tokens=MAX_NEW, engine_kwargs=ENGINE_KW, fused=fused)
    texts, scores = serve_uncertainties(port, None, prompts, requests, **kw)
    want_texts, want = jax_serve(jm, params, None, prompts, requests, **kw)
    assert [list(t) for t in texts] == [[int(i) for i in t] for t in want_texts]
    assert_same_scores(scores, want, [k for k in want[0]])


def test_fused_equals_the_interactive_drain(pair, prompts):
    port = pair[2]
    requests = DET_REQUESTS[:2]
    kw = dict(max_new_tokens=MAX_NEW, engine_kwargs=ENGINE_KW)
    ta, sa = serve_uncertainties(port, None, prompts, requests, **kw)
    tb, sb = serve_uncertainties(port, None, prompts, requests, fused=True, **kw)
    assert ta == tb
    for a, b in zip(sa, sb):
        assert a == b


@pytest.mark.parametrize("fused", [False, True], ids=["merged", "fused"])
def test_sampled_methods_collapse_as_jax(pair, prompts, fused):
    jm, params, port = pair
    requests = [{"method_name": "normalized_entropy"}, {"method_name": "semantic_entropy"},
                {"method_name": "perplexity"}]
    kw = dict(num_samples=3, max_new_tokens=MAX_NEW, temperature=COLD, entailment_model=_same,
              engine_kwargs=ENGINE_KW, fused=fused)
    _, scores = serve_uncertainties(port, None, prompts[:3], requests, **kw)
    _, want = jax_serve(jm, params, None, prompts[:3], requests, **kw)
    assert_same_scores(scores, want, ["normalized_entropy", "perplexity", "semantic_entropy"])
    for out, w in zip(scores, want):
        np.testing.assert_allclose(out["normalized_entropy"], out["perplexity"], rtol=1e-4)
        assert out["semantic_entropy"] == 0.0 and len(set(out["clusters"].values())) == 1
        assert {tuple(int(i) for i in k): v for k, v in w["clusters"].items()} == out["clusters"]


def test_semantic_entropy_through_wrap_torch_nli(pair, prompts):
    """The judge of the serving leg: a DeBERTa through wrap_torch_nli (tiny
    HF geometry), against JAX's server judged by wrap_jax_nli on the same
    weights; decoded texts through a word tokenizer."""
    pytest.importorskip("transformers")
    from runia_core_tpu.models import convert_hf_deberta as jax_convert_hf_deberta
    from runia_core_tpu.models import wrap_jax_nli
    from runia_core_tpu_torch.models import convert_hf_deberta, wrap_torch_nli
    from test_torch_deberta import _TinyPairTokenizer, tiny_hf_deberta

    jm, params, port = pair
    hf = tiny_hf_deberta()
    model, _ = convert_hf_deberta(hf, device="cpu")
    jax_model, jax_params = jax_convert_hf_deberta(hf)
    tok = _TinyPairTokenizer()
    requests = [{"method_name": "semantic_entropy"}, {"method_name": "perplexity"}]
    kw = dict(num_samples=3, max_new_tokens=MAX_NEW, temperature=COLD, engine_kwargs=ENGINE_KW)
    texts, scores = serve_uncertainties(port, _Words(), prompts[:2], requests,
                                        entailment_model=wrap_torch_nli(model, tok, batch_bucket=4), **kw)
    want_texts, want = jax_serve(jm, params, _Words(), prompts[:2], requests,
                                 entailment_model=wrap_jax_nli(jax_model, jax_params, tok, batch_bucket=4), **kw)
    assert texts == want_texts and all(isinstance(t, str) for t in texts)
    for out, w in zip(scores, want):
        # A random judge need not call a text its own paraphrase: the
        # clusters are whatever both judges say, and they agree.
        assert out["semantic_entropy"] == w["semantic_entropy"]
        assert out["clusters"] == w["clusters"]


def test_eigen_score(pair, prompts):
    """Collapsed: JAX's score, log(1e-3); at temperature 1 the samples
    differ and lift it; the streamed hidden vector is the final token's
    forward."""
    jm, params, port = pair
    requests = [{"method_name": "eigen_score", "layer_index": -1}]
    kw = dict(num_samples=3, max_new_tokens=MAX_NEW, engine_kwargs=ENGINE_KW)
    _, scores = serve_uncertainties(port, None, prompts[:2], requests, temperature=COLD, **kw)
    _, want = jax_serve(jm, params, None, prompts[:2], requests, temperature=COLD, **kw)
    for out, w in zip(scores, want):
        np.testing.assert_allclose(out["eigen_score"], w["eigen_score"], rtol=1e-6)
        np.testing.assert_allclose(out["eigen_score"], np.log(1e-3), rtol=1e-6)
    _, hot = serve_uncertainties(port, None, prompts[:1], requests, temperature=1.0, **dict(kw, num_samples=4))
    assert hot[0]["eigen_score"] > np.log(1e-3) + 1e-3
    eng = _make_engine(port, max(len(p) for p in prompts), MAX_NEW, None, False, ENGINE_KW, do_sample=True,
                       temperature=0.8, collect_hidden=-1)
    rids = [eng.submit(p) for p in prompts]
    eng.run_until_drained()
    for p, rid in zip(prompts, rids):
        res = eng.result(rid)
        seq = torch.tensor([list(p) + res["tokens"][:-1]])
        hidden = port(seq, need_attentions=False)[2]
        np.testing.assert_allclose(res["hidden"], hidden[-1, 0, -1].numpy(), rtol=2e-4, atol=2e-5)


def test_server_reuses_its_engines(pair, prompts):
    """One server, several batches: deterministic scores repeat, samples are
    new each batch, results are cleared, the merged layout has no sampled
    engine, and a one-shot call matches the server."""
    port = pair[2]
    requests = [{"method_name": "perplexity"}, {"method_name": "normalized_entropy"}]
    server = UncertaintyServer(port, None, requests, num_samples=4, max_new_tokens=MAX_NEW, temperature=1.0,
                               engine_kwargs=ENGINE_KW, max_prompt_len=max(len(p) for p in prompts))
    ta, sa = server.serve(prompts)
    tb, sb = server.serve(prompts)
    assert ta == tb
    for a, b in zip(sa, sb):
        np.testing.assert_allclose(b["perplexity"], a["perplexity"], rtol=1e-6)
    assert any(not np.allclose(a["normalized_entropy"], b["normalized_entropy"]) for a, b in zip(sa, sb))
    assert not server.det_engine._results and server.samp_engine is None
    assert server.stats()["deterministic"]["prefix_hits"] > 0
    tc, sc = server.serve(prompts[:3])
    td, sd = serve_uncertainties(port, None, prompts[:3], requests, num_samples=4, max_new_tokens=MAX_NEW,
                                 engine_kwargs=ENGINE_KW)
    assert tc == td
    for c, d in zip(sc, sd):
        np.testing.assert_allclose(d["perplexity"], c["perplexity"], rtol=1e-6)


def test_fused_server_keeps_one_drain_per_shape(pair, prompts):
    port = pair[2]
    server = UncertaintyServer(port, None, [{"method_name": "perplexity"}], max_new_tokens=MAX_NEW,
                               engine_kwargs=ENGINE_KW, fused=True, max_prompt_len=max(len(p) for p in prompts))
    _, sa = server.serve(prompts[:3])
    _, sb = server.serve(prompts[2:])
    assert len(server.det_engine._fused_cache) == 1
    _, want = serve_uncertainties(port, None, prompts[2:], [{"method_name": "perplexity"}], max_new_tokens=MAX_NEW,
                                  engine_kwargs=ENGINE_KW, fused=True)
    for b, w in zip(sb, want):
        np.testing.assert_allclose(b["perplexity"], w["perplexity"], rtol=1e-6)
    assert not np.allclose(sa[0]["perplexity"], sb[0]["perplexity"])


def test_two_engine_layout_with_a_draft(pair, prompts):
    """A speculative engine keeps the two-engine layout (JAX's): greedy
    scores equal the plain server's."""
    port = pair[2]
    requests = [{"method_name": "perplexity"}, {"method_name": "normalized_entropy"}]
    kw = dict(num_samples=2, max_new_tokens=MAX_NEW, temperature=COLD, max_prompt_len=max(len(p) for p in prompts))
    spec = UncertaintyServer(port, None, requests, engine_kwargs=dict(ENGINE_KW, draft_model=port, gamma=3), **kw)
    plain = UncertaintyServer(port, None, requests, engine_kwargs=ENGINE_KW, **kw)
    assert spec.samp_engine is not None and spec.det_engine.draft_model is port
    ts, ss = spec.serve(prompts)
    tp, sp = plain.serve(prompts)
    assert ts == tp
    for a, b in zip(ss, sp):
        np.testing.assert_allclose(a["perplexity"], b["perplexity"], atol=ATOL)
        np.testing.assert_allclose(a["normalized_entropy"], b["normalized_entropy"], atol=ATOL)
    assert spec.stats()["deterministic"]["acceptance"] > 0.9


@pytest.mark.parametrize("requests, kw", [
    ([{"method_name": "eigen_score"}], dict()),
    ([{"method_name": "eigen_score", "layer_index": -1}, {"method_name": "eigen_score", "layer_index": 1}], dict()),
    ([{"method_name": "eigen_score", "layer_index": -1}], dict(fused=True)),
    ([{"method_name": "RAUQ", "head_aggregation": "rollout"}], dict()),
    ([{"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "original",
       "alphas": [0.1, 0.2]}], dict()),
    ([{"method_name": "nope"}], dict()),
    ([{"method_name": "semantic_entropy"}], dict()),
    ([{"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "original"}], dict(fused=True)),
    ([{"method_name": "perplexity"}], dict(fused=True, engine_kwargs=dict(ENGINE_KW, prefill_chunk=None))),
    ([{"method_name": "perplexity"}], dict(fused=True, engine_kwargs=dict(ENGINE_KW, draft="model"))),
], ids=["eigen_layer_15", "two_layers", "fused_eigen", "rauq_rollout", "rauq_alphas", "unknown", "no_judge",
        "fused_rauq", "fused_bucketed", "fused_draft"])
def test_validation_has_the_jax_wording(pair, prompts, requests, kw):
    jm, params, port = pair
    kw = dict(kw)
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("engine_kwargs", {}).get("draft"):
        base = {k: v for k, v in kw["engine_kwargs"].items() if k != "draft"}
        jkw["engine_kwargs"] = dict(base, draft_model=jm)
        pkw["engine_kwargs"] = dict(base, draft_model=port)
    with pytest.raises((KeyError, ValueError, NotImplementedError)) as want:
        jax_serve(jm, params, None, prompts, requests, **jkw)
    with pytest.raises(want.type) as got:
        serve_uncertainties(port, None, prompts, requests, **pkw)
    assert str(got.value) == str(want.value)


def test_capacity_is_fixed_at_construction(pair, prompts):
    jm, params, port = pair
    with pytest.raises(ValueError) as want:
        JaxServer(jm, params, None, [{"method_name": "perplexity"}], engine_kwargs=ENGINE_KW)
    with pytest.raises(ValueError) as got:
        UncertaintyServer(port, None, [{"method_name": "perplexity"}], engine_kwargs=ENGINE_KW)
    assert str(got.value) == str(want.value)
    server = UncertaintyServer(port, None, [{"method_name": "perplexity"}], max_new_tokens=MAX_NEW,
                               engine_kwargs=ENGINE_KW, max_prompt_len=16)
    assert isinstance(server.det_engine, ContinuousBatchingEngine) and server.det_engine.max_ctx == 24
    with pytest.raises(ValueError, match="exceeds"):
        server.serve([list(np.random.RandomState(0).randint(1, VOCAB, 40))])
