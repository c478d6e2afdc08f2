"""The port's speculative ContinuousBatchingEngine (draft_model=) against
runia_core_tpu's, on the CPU.

The target is the JAX engine's test model (test_torch_continuous.py: 2
layers, d_model 32, vocab 64); drafts are a 1-layer model of its width
(uncorrelated with the target: acceptance near 0) and the target itself (the
perfect draft: every proposal accepted). Bounds as test_torch_continuous.py:
tokens identical, scores within 1e-5, counters (accepted and proposed
included) equal. The sampled round is held against JAX's with JAX's own
random draws injected and from JAX's caches: the discrete outcomes equal,
the log-probabilities, entropies and logits within 1e-6 of max(1, max|x|)
over each array (two f32 ulps at the log-probabilities' magnitude of 5),
the residual sampling distribution within 1e-6 as probabilities.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.llm import continuous as jax_continuous
from runia_core_tpu.llm.continuous import ContinuousBatchingEngine as JaxEngine
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
from runia_core_tpu.models.transformer import init_cache as jax_init_cache
from runia_core_tpu_torch.llm import ContinuousBatchingEngine
from runia_core_tpu_torch.llm.continuous import _spec_round
from runia_core_tpu_torch.models import init_cache
from test_torch_continuous import CFG, COUNTERS, MAX_NEW, VOCAB, _port, assert_same_results, serve

torch.set_num_threads(1)

SPEC_COUNTERS = COUNTERS + ("accepted", "proposed")
DRAFT_CFG = dict(CFG, num_layers=1)
ROUND_ATOL = 1e-6


@pytest.fixture(scope="module")
def models():
    """{name: (JAX model, params, port model)} for the target and the two drafts."""
    jm = JaxLlamaLM(**CFG)
    params = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    port = _port(params)
    jd = JaxLlamaLM(**DRAFT_CFG)
    dparams = jd.init(jax.random.key(5), np.zeros((1, 8), np.int32))
    return {"target": (jm, params, port), "uncorrelated": (jd, dparams, _port(dparams, DRAFT_CFG)),
            "perfect": (jm, params, port)}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, VOCAB, rng.randint(3, 20))) for _ in range(7)]


def spec_both(models, prompts, draft="uncorrelated", budgets=None, **kw):
    """Serve on JAX's speculative engine and the port's; assert equal
    results and counters; returns (port engine, port results, JAX engine)."""
    jm, params, port = models["target"]
    jd, dparams, pd = models[draft]
    jeng = JaxEngine(jm, params, draft_model=jd, draft_params=dparams, **kw)
    peng = ContinuousBatchingEngine(port, draft_model=pd, **kw)
    want, got = serve(jeng, prompts, budgets), serve(peng, prompts, budgets)
    assert_same_results(got, want)
    js, ps = jeng.stats(), peng.stats()
    assert {k: ps[k] for k in SPEC_COUNTERS} == {k: js[k] for k in SPEC_COUNTERS}
    return peng, got, jeng


BASE = dict(num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=10, prefill_chunk=8)


@pytest.mark.parametrize("draft, kw", [
    ("uncorrelated", dict(gamma=4)),
    ("uncorrelated", dict(gamma=2, chunk_tokens=7, prefill_lanes=2)),
    ("perfect", dict(gamma=4)),
    ("perfect", dict(gamma=3, num_slots=2, prefill_lanes=3)),
], ids=["uncorrelated_g4", "uncorrelated_g2_lanes", "perfect_g4", "perfect_g3_lanes"])
def test_greedy_equals_jax_and_the_plain_engine(models, prompts, draft, kw):
    kw = dict(BASE, **kw)
    eng, got, _ = spec_both(models, prompts, draft, **kw)
    plain = {k: v for k, v in kw.items() if k != "gamma"}
    assert_same_results(got, ContinuousBatchingEngine(models["target"][2], **plain).generate_all(prompts))
    stats = eng.stats()
    if draft == "perfect":
        assert stats["acceptance"] > 0.9
    else:
        assert stats["acceptance"] < 0.5
    assert stats["proposed"] > 0


def test_eos_and_budgets(models, prompts):
    jm, params, port = models["target"]
    trace = ContinuousBatchingEngine(port, **BASE).generate_all(prompts[:1])
    eos = trace[0]["tokens"][3]
    budgets = [3, 10, 1, 7, 2, 9, 5]
    for draft in ("uncorrelated", "perfect"):
        _, got, _ = spec_both(models, prompts, draft, budgets, eos_id=eos, **BASE)
        assert all(eos not in r["tokens"] and len(r["tokens"]) <= b for r, b in zip(got, budgets))
    assert len(got[0]["tokens"]) <= 3 < MAX_NEW


def test_prefix_cache_copies_the_draft_rows(models):
    """Shared 18-token system prompt: hits copy both caches' rows; with the
    perfect draft a stale draft row would show as lost acceptance."""
    rng = np.random.RandomState(21)
    system = list(rng.randint(1, VOCAB, 18))
    batch = [system + list(rng.randint(1, VOCAB, rng.randint(2, 9))) for _ in range(6)]
    eng, _, _ = spec_both(models, batch, "perfect", num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW,
                          chunk_tokens=5, prefill_chunk=8, prefix_cache=True)
    assert eng.prefix_hits >= 3 and eng.stats()["acceptance"] > 0.9


def test_rauq_from_the_verify_rows(models, prompts):
    """In-loop RAUQ gathered from the verify forward's attention rows: the
    JAX speculative engine's, and the plain engine's (same greedy trace)."""
    _, got, _ = spec_both(models, prompts[:4], "perfect", collect_rauq=True, **BASE)
    plain = ContinuousBatchingEngine(models["target"][2], collect_rauq=True, **BASE).generate_all(prompts[:4])
    assert_same_results(got, plain)
    assert all(np.isfinite(r["rauq"]) for r in got)


def test_stream_increments_and_engine_reuse(models, prompts):
    port, pd = models["target"][2], models["uncorrelated"][2]
    eng = ContinuousBatchingEngine(port, draft_model=pd, **BASE)
    ids = [eng.submit(p) for p in prompts]
    seen = {rid: [] for rid in ids}
    for rid, new in eng.stream():
        seen[rid].extend(new)
    first = [eng.result(rid)["tokens"] for rid in ids]
    assert [seen[rid] for rid in ids] == first
    assert [r["tokens"] for r in eng.generate_all(prompts)] == first


# -- sampled ----------------------------------------------------------------------
def _prefilled(models, draft, S, p, temp):
    """Both frameworks' caches after an 8-token prefill of S random prompts,
    the next-token logits and the seeded sampling distribution."""
    jm, params, port = models["target"]
    jd, dparams, pd = models[draft]
    prompt = np.random.RandomState(8).randint(1, VOCAB, (S, p))
    jc, jdc = jax_init_cache(jm, S, 32), jax_init_cache(jd, S, 32)
    logits, _, _, jc = jm.apply(params, jnp.asarray(prompt, jnp.int32), jc, jnp.int32(0))
    jdc = jd.apply(dparams, jnp.asarray(prompt, jnp.int32), jdc, jnp.int32(0))[3]
    pc, pdc = init_cache(port, S, 32, device="cpu"), init_cache(pd, S, 32, device="cpu")
    plog = port(torch.from_numpy(prompt), pc, 0)[0]
    pd(torch.from_numpy(prompt), pdc, 0)
    step = logits[:, -1]
    np.testing.assert_allclose(plog[:, -1].numpy(), np.asarray(step), atol=1e-5, rtol=0)
    # The rounds start from JAX's state, so that only the round's own
    # arithmetic is compared.
    for cache, jcache in ((pc, jc), (pdc, jdc)):
        for layer, jlayer in zip(cache["layers"], jcache["layers"]):
            for name, buf in layer.items():
                buf.copy_(torch.from_numpy(np.array(jlayer[name])))
    jsamp = jax.nn.log_softmax(step / temp, axis=-1)
    return (jc, jdc, step, jsamp), (pc, pdc, torch.from_numpy(np.array(step)), torch.from_numpy(np.array(jsamp)))


def _jax_draws(key, S, gamma):
    """The draws JAX's spec round takes from ``key``: tok0's and each draft
    step's Gumbel noise (jax.random.categorical), the acceptance uniforms."""
    k0, kd, kr = jax.random.split(key, 3)
    return {
        "tok0": torch.from_numpy(np.array(jax.random.gumbel(k0, (S, VOCAB), jnp.float32))),
        "draft": torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, (S, VOCAB), jnp.float32))
                                            for k in jax.random.split(kd, gamma + 1)])),
        "uniforms": torch.from_numpy(np.array(jax.random.uniform(kr, (S, gamma)))),
    }


@pytest.mark.parametrize("draft", ["uncorrelated", "perfect"])
def test_sampled_round_with_jax_draws(models, draft):
    """Two rounds of the sampled round on both frameworks, JAX's draws
    injected into the port's: the same accepted counts, emissions and
    clocks; log-probs, entropies, the carried logits and the residual
    sampling distribution within 1e-6."""
    S, p, gamma, temp = 3, 8, 4, 0.8
    jm, params, port = models["target"]
    jd, dparams, pd = models[draft]
    (jc, jdc, jstep, jsamp), (pc, pdc, pstep, psamp) = _prefilled(models, draft, S, p, temp)
    jround = jax_continuous._make_spec_round(jm, jd, gamma, None, True, temp)
    jpos, jactive, jlimit = jnp.full((S,), p, jnp.int32), jnp.asarray([True, True, False]), jnp.asarray([20, 11, 20])
    ppos, pactive, plimit = torch.full((S,), p), torch.tensor([True, True, False]), torch.tensor([20, 11, 20])
    for i in range(2):
        key = jax.random.key(40 + i)
        want = jround(params, dparams, jc, jdc, jstep, jsamp, jpos, jactive, jlimit, key)
        got = _spec_round(port, pd, gamma, None, True, temp, pc, pdc, pstep, psamp, ppos, pactive, plimit,
                          draws=_jax_draws(key, S, gamma))
        for name in ("n_acc", "emit", "take", "slot_pos", "active"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
        emit = np.asarray(want["emit"])
        np.testing.assert_array_equal(np.where(emit, got["block"].numpy(), 0), np.where(emit, want["block"], 0))
        for name in ("lps", "ents", "step_logits"):
            ref = np.asarray(want[name])
            bound = ROUND_ATOL * max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(got[name].numpy(), ref, atol=bound, rtol=0, err_msg=name)
        # The residual max(p_t - p_d, 0) cancels where p_t ~ p_d, so its log
        # is compared as the probabilities it samples from.
        np.testing.assert_allclose(np.exp(got["samp_logp"].numpy()), np.exp(np.asarray(want["samp_logp"])),
                                   atol=ROUND_ATOL, rtol=0, err_msg="residual")
        jc, jdc, jstep, jsamp = want["cache"], want["d_cache"], want["step_logits"], want["samp_logp"]
        jpos, jactive = want["slot_pos"], want["active"]
        pstep, psamp, ppos, pactive = got["step_logits"], got["samp_logp"], got["slot_pos"], got["active"]
    if draft == "perfect":
        assert int(np.asarray(want["n_acc"])[0]) > 0


def test_sampled_engine_collapses_to_greedy(models, prompts):
    """At temperature 1e-4 every draw is the argmax: the sampled speculative
    engine's tokens are the greedy engine's, and one seed gives one result
    at temperature 1."""
    port, pd = models["target"][2], models["perfect"][2]
    greedy = ContinuousBatchingEngine(port, **BASE).generate_all(prompts)
    cold = ContinuousBatchingEngine(port, draft_model=pd, do_sample=True, temperature=1e-4, **BASE)
    assert [r["tokens"] for r in cold.generate_all(prompts)] == [r["tokens"] for r in greedy]
    assert cold.stats()["acceptance"] > 0.9

    def hot():
        return ContinuousBatchingEngine(port, draft_model=pd, do_sample=True, temperature=1.0,
                                        generator=torch.Generator().manual_seed(3), **BASE).generate_all(prompts)

    first, again = hot(), hot()
    assert [r["tokens"] for r in first] == [r["tokens"] for r in again]
    assert all(len(r["tokens"]) == MAX_NEW and np.isfinite(r["log_probs"]).all() for r in first)
    assert any(r["tokens"] != g["tokens"] for r, g in zip(first, greedy))


# -- the break-even guard, the errors ------------------------------------------------
def test_guard_disables_speculation_with_the_jax_warning(models, prompts):
    """An uncorrelated draft (acceptance near 0) under a floor of 0.5: the
    first drain gathers 280 proposals, the second starts on the plain path
    with JAX's warning, and both drains' tokens are JAX's and the plain
    engine's."""
    jm, params, port = models["target"]
    jd, dparams, pd = models["uncorrelated"]
    kw = dict(BASE, spec_min_acceptance=0.5, prefix_cache=True)
    jeng = JaxEngine(jm, params, draft_model=jd, draft_params=dparams, **kw)
    peng = ContinuousBatchingEngine(port, draft_model=pd, **kw)
    assert_same_results(peng.generate_all(prompts), jeng.generate_all(prompts))
    assert peng.stats()["proposed"] >= peng._SPEC_EVIDENCE
    with pytest.warns(UserWarning) as jw:
        want = jeng.generate_all(prompts)
    with pytest.warns(UserWarning) as pw:
        got = peng.generate_all(prompts)
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    assert "speculative decoding disabled" in str(pw[0].message)
    assert_same_results(got, want)
    plain = {k: v for k, v in BASE.items()}
    assert_same_results(got, ContinuousBatchingEngine(port, **plain).generate_all(prompts))
    ps, js = peng.stats(), jeng.stats()
    assert ps["spec_disabled"] == js["spec_disabled"] == 1
    assert {k: ps[k] for k in SPEC_COUNTERS} == {k: js[k] for k in SPEC_COUNTERS}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert_same_results(peng.generate_all(prompts[:2]), got[:2])


def test_guard_keeps_a_draft_above_the_floor(models, prompts):
    port, pd = models["target"][2], models["perfect"][2]
    eng = ContinuousBatchingEngine(port, draft_model=pd, spec_min_acceptance=0.5, **BASE)
    while eng.stats()["proposed"] < eng._SPEC_EVIDENCE:
        eng.generate_all(prompts)
    eng.generate_all(prompts)
    assert "spec_disabled" not in eng.stats() and eng.stats()["proposed"] >= eng._SPEC_EVIDENCE


def test_submit_errors_have_the_jax_wording(models, prompts):
    jm, params, port = models["target"]
    jd, dparams, pd = models["uncorrelated"]
    jeng = JaxEngine(jm, params, draft_model=jd, draft_params=dparams, do_sample=True, **BASE)
    peng = ContinuousBatchingEngine(port, draft_model=pd, do_sample=True, **BASE)
    with pytest.raises(NotImplementedError) as want:
        jeng.submit(prompts[0], sample=False)
    with pytest.raises(NotImplementedError) as got:
        peng.submit(prompts[0], sample=False)
    assert str(got.value) == str(want.value)
    # gamma + 1 rows of speculative slack
    long = list(range(1, 51))
    with pytest.raises(ValueError) as want:
        jeng.submit(long, 10)
    with pytest.raises(ValueError) as got:
        peng.submit(long, 10)
    assert str(got.value) == str(want.value) and "speculative slack" in str(got.value)
