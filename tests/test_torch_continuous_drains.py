"""The port's ContinuousBatchingEngine against runia_core_tpu's, on the CPU:
the drains (lookahead and open-loop), the prefix cache, admission order,
prefill lanes, per-request decoding modes, the errors, and
``speculative_breakeven``.

The model, the bounds and the helpers are test_torch_continuous.py's:
tokens identical, scores within 1e-5, the stats counters equal.
"""

import numpy as np
import pytest
import torch

import jax

from runia_core_tpu.llm.continuous import ContinuousBatchingEngine as JaxEngine
from runia_core_tpu.llm.continuous import speculative_breakeven as jax_breakeven
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
from runia_core_tpu_torch.llm import ContinuousBatchingEngine, speculative_breakeven
from test_torch_continuous import CFG, MAX_NEW, VOCAB, _port, assert_same_results, both

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlamaLM(**CFG)
    params = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    return jm, params, _port(params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, VOCAB, rng.randint(3, 20))) for _ in range(7)]


# -- prefix cache ---------------------------------------------------------------
def test_shared_system_prompt_hits(pair):
    rng = np.random.RandomState(21)
    system = list(rng.randint(1, VOCAB, 18))  # two full chunks of 8
    batch = [system + list(rng.randint(1, VOCAB, rng.randint(2, 9))) for _ in range(6)]
    eng, _ = both(pair, batch, num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=3, prefill_chunk=8,
                  prefix_cache=True)
    assert eng.prefix_hits >= 3


def test_identical_prompt_reuses_its_own_row(pair):
    """One slot: the duplicate's donor is the slot itself (src == slot, no
    copy); only its final chunk is prefilled again."""
    prompt = list(np.random.RandomState(22).randint(1, VOCAB, 20))
    eng, got = both(pair, [prompt, prompt], num_slots=1, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4,
                    prefill_chunk=8, prefix_cache=True)
    assert eng.prefix_hits == 1 and got[0]["tokens"] == got[1]["tokens"]


def test_first_wave_duplicates_wait_for_their_donor(pair):
    prompt = list(np.random.RandomState(31).randint(1, VOCAB, 26))
    eng, got = both(pair, [prompt] * 4, num_slots=4, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4,
                    prefill_chunk=8, prefix_cache=True)
    assert eng.prefix_hits == 3 and eng.stats()["deferred_admissions"] > 0
    assert all(r["tokens"] == got[0]["tokens"] for r in got)


def test_disjoint_prompts_never_hit(pair):
    rng = np.random.RandomState(23)
    batch = [list(rng.randint(1, VOCAB, 12) + i % 2) for i in range(4)]
    for i, b in enumerate(batch):
        b[0] = 1 + i
    eng, _ = both(pair, batch, num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, prefill_chunk=8, prefix_cache=True)
    assert eng.prefix_hits == 0


# -- admission, lanes -------------------------------------------------------------
def test_lpt_against_fifo(pair):
    """Longest budget first: the JAX order, the fifo results, no more decode
    chunks than fifo."""
    rng = np.random.RandomState(13)
    batch = [list(rng.randint(1, VOCAB, rng.randint(3, 20))) for _ in range(8)]
    budgets = [2, 10, 3, 9, 1, 8, 4, 7]
    kw = dict(num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4)
    lpt, got = both(pair, batch, budgets, admission="lpt", **kw)
    fifo, want = both(pair, batch, budgets, admission="fifo", **kw)
    assert_same_results(got, want)
    assert lpt.stats()["decode_chunks"] <= fifo.stats()["decode_chunks"]


def test_prefill_lanes_one_against_four(pair, prompts):
    rng = np.random.RandomState(14)
    batch = prompts + [list(rng.randint(1, VOCAB, 40))]
    kw = dict(num_slots=4, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4, prefill_chunk=8)
    four, got = both(pair, batch, prefill_lanes=4, **kw)
    one, want = both(pair, batch, prefill_lanes=1, **kw)
    assert_same_results(got, want)
    assert four.stats()["prefill_chunks"] < one.stats()["prefill_chunks"]


# -- drains -------------------------------------------------------------------------
@pytest.mark.parametrize("kw, budgets", [
    (dict(num_slots=3, chunk_tokens=4), None),
    (dict(num_slots=2, chunk_tokens=5, prefill_chunk=8, prefix_cache=True), [1, 9, 2, 7, 3, 10, 4]),
    (dict(num_slots=3, chunk_tokens=4, collect_rauq=True, collect_hidden=-1), None),
], ids=["bucketed", "chunked_prefix_budgets", "rauq_hidden"])
def test_open_loop_against_the_fetch_drain(pair, prompts, kw, budgets):
    """defer_fetch=True against JAX's open loop, and against the port's
    lookahead drain; its harvests wait in host memory until the end."""
    kw = dict(kw, max_ctx=64, max_new_tokens=MAX_NEW)
    eng, got = both(pair, prompts, budgets, defer_fetch=True, **kw)
    _, want = both(pair, prompts, budgets, **kw)
    assert_same_results(got, want)
    assert len(eng._harvest_pool) == eng.stats()["decode_chunks"]


def test_lookahead_drain_keeps_two_harvests(pair, prompts):
    eng = ContinuousBatchingEngine(pair[2], num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=3)
    eng.generate_all(prompts)
    assert eng.stats()["decode_chunks"] > 2 and len(eng._harvest_pool) == 2


def test_staggered_budgets_refill_under_the_inflight_chunk(pair):
    """Budgets 1..12 over 2 slots with chunk 5: slots free mid-drain while a
    lookahead chunk is in flight, and refills race it."""
    rng = np.random.RandomState(21)
    batch = [list(rng.randint(1, VOCAB, rng.randint(3, 20))) for _ in range(9)]
    both(pair, batch, [1, 12, 2, 7, 3, 1, 9, 4, 2], num_slots=2, max_ctx=64, max_new_tokens=12, chunk_tokens=5)


@pytest.mark.parametrize("kw", [dict(chunk_tokens=3), dict(chunk_tokens=4, defer_fetch=True),
                                dict(chunk_tokens=3, eos="trace")], ids=["lookahead", "open_loop", "eos"])
def test_stream_increments_equal_final_tokens(pair, prompts, kw):
    kw = dict(kw)
    if kw.pop("eos", None):
        trace = ContinuousBatchingEngine(pair[2], num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW).generate_all(
            prompts[:1])
        kw["eos_id"] = trace[0]["tokens"][2]
    eng = ContinuousBatchingEngine(pair[2], num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, **kw)
    ids = [eng.submit(p) for p in prompts]
    seen = {rid: [] for rid in ids}
    for rid, new in eng.stream():
        seen[rid].extend(new)
    for rid in ids:
        assert seen[rid] == eng.result(rid)["tokens"]


def test_tail_drain_and_reuse(pair):
    """A lone request whose budget fits one chunk (the tail guard's path);
    the drained engine serves the same request again identically."""
    prompt = list(np.random.RandomState(5).randint(1, VOCAB, 6))
    eng, got = both(pair, [prompt], num_slots=3, max_ctx=64, max_new_tokens=4, chunk_tokens=8)
    again = eng.generate_all([prompt])
    assert again[0]["tokens"] == got[0]["tokens"]


def test_open_loop_divergence_raises(pair, prompts, monkeypatch):
    eng = ContinuousBatchingEngine(pair[2], num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4,
                                   defer_fetch=True)
    real = eng._simulate_chunk

    def one_more(owner_reqs):
        finished = real(owner_reqs)
        for req in finished:
            req["sim_len"] += 1
        return finished

    monkeypatch.setattr(eng, "_simulate_chunk", one_more)
    with pytest.raises(RuntimeError, match="open-loop schedule diverged"):
        eng.generate_all(prompts[:2])


# -- decoding modes -------------------------------------------------------------
@pytest.mark.parametrize("defer_fetch", [False, True])
def test_sampled_mode(pair, prompts, defer_fetch):
    """Sampled decode is well formed (the two frameworks' random streams
    differ by design), one generator seed gives one result, and
    sample=False requests in a sampled engine are the greedy engine's."""
    port = pair[2]
    kw = dict(num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4, defer_fetch=defer_fetch)

    def sampled():
        eng = ContinuousBatchingEngine(port, do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
                                       generator=torch.Generator().manual_seed(7), **kw)
        ids = [eng.submit(p, sample=i % 2 == 0) for i, p in enumerate(prompts)]
        eng.run_until_drained()
        return [eng.result(i) for i in ids]

    first, second = sampled(), sampled()
    greedy = ContinuousBatchingEngine(port, **kw).generate_all(prompts)
    for i, (res, again, ref) in enumerate(zip(first, second, greedy)):
        assert len(res["tokens"]) == MAX_NEW and all(0 <= t < VOCAB for t in res["tokens"])
        assert np.isfinite(res["log_probs"]).all()
        assert res["tokens"] == again["tokens"]
        if i % 2:
            assert res["tokens"] == ref["tokens"]
            np.testing.assert_allclose(res["log_probs"], ref["log_probs"], atol=1e-6, rtol=0)
    assert any(r["tokens"] != g["tokens"] for r, g in zip(first[::2], greedy[::2]))


# -- errors -------------------------------------------------------------------------
def _drafts():
    """A JAX draft and the port's, and a port draft of another vocabulary."""
    cfg = dict(CFG, num_layers=1, num_heads=2, num_kv_heads=1, d_model=16, hidden_dim=32)
    jd = JaxLlamaLM(**cfg)
    dparams = jd.init(jax.random.key(9), np.zeros((1, 8), np.int32))
    other = dict(cfg, vocab_size=32)
    jo = JaxLlamaLM(**other)
    oparams = jo.init(jax.random.key(9), np.zeros((1, 8), np.int32))
    return (jd, dparams, _port(dparams, cfg)), (jo, oparams, _port(oparams, other))


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=0),
    dict(max_ctx=60, prefill_chunk=16),
    dict(prefix_cache=True),
    dict(collect_hidden=5),
    dict(collect_hidden=-4),
    dict(admission="sjf"),
    dict(defer_fetch=True, eos_id=3),
    dict(draft=True, collect_hidden=-1),
    dict(draft=True, defer_fetch=True, prefill_chunk=8),
    dict(draft=True),
    dict(draft=True, prefill_chunk=8, top_k=5),
    dict(draft="other", prefill_chunk=8),
], ids=["chunk_zero", "chunk_indivisible", "prefix_without_chunks", "hidden_past", "hidden_before", "admission",
        "defer_with_eos", "draft_hidden", "draft_defer", "draft_without_chunks", "draft_top_k", "draft_vocab"])
def test_constructor_errors_have_the_jax_wording(pair, kw):
    jm, params, port = pair
    kw = dict(kw)
    draft = kw.pop("draft", None)
    jax_kw, port_kw = dict(kw), dict(kw)
    if draft:
        (jd, dparams, pd), (jo, oparams, po) = _drafts()
        jax_kw.update(draft_model=jd if draft is True else jo, draft_params=dparams if draft is True else oparams)
        port_kw.update(draft_model=pd if draft is True else po)
    with pytest.raises((ValueError, NotImplementedError)) as want:
        JaxEngine(jm, params, **jax_kw)
    with pytest.raises(want.type) as got:
        ContinuousBatchingEngine(port, **port_kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw, prompt, call", [
    (dict(max_ctx=32, max_new_tokens=30), list(range(1, 20)), dict()),
    (dict(max_ctx=32, max_new_tokens=8, prefill_chunk=8), list(range(1, 30)), dict()),
    (dict(max_ctx=64, prefill_chunk=8), [], dict()),
    (dict(max_ctx=64), [1, 2, 3], dict(sample=True)),
], ids=["bucketed_overflow", "chunked_overflow", "empty_chunked", "sample_on_greedy"])
def test_submit_errors_have_the_jax_wording(pair, kw, prompt, call):
    jm, params, port = pair
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, params, **kw).submit(prompt, **call)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(port, **kw).submit(prompt, **call)
    assert str(got.value) == str(want.value)


def test_generate_all_validates_before_enqueuing(pair, prompts):
    eng = ContinuousBatchingEngine(pair[2], num_slots=2, max_ctx=32, max_new_tokens=MAX_NEW, chunk_tokens=4,
                                   prefill_chunk=8)
    with pytest.raises(ValueError, match="exceeds"):
        eng.generate_all([prompts[0], list(range(1, 64))])
    assert not eng._queue and eng.stats()["tokens_emitted"] == 0
    assert len(eng.generate_all([prompts[0]])[0]["tokens"]) == MAX_NEW


@pytest.mark.parametrize("cost, gamma, overhead", [(0.55, 4, 0.0), (0.55, 4, 1.5), (0.2, 4, 0.0), (0.1, 6, 0.0),
                                                   (0.3, 2, 0.0), (0.05, 4, 0.3), (1.0, 1, 0.0)])
def test_speculative_breakeven_equals_jax(cost, gamma, overhead):
    assert speculative_breakeven(cost, gamma, overhead) == jax_breakeven(cost, gamma, overhead)


def test_results_are_kept_until_cleared(pair, prompts):
    eng = ContinuousBatchingEngine(pair[2], num_slots=2, max_ctx=64, max_new_tokens=3, chunk_tokens=4)
    rid = eng.submit(prompts[0], 2)
    eng.run_until_drained()
    assert len(eng.result(rid)["tokens"]) == 2
    eng.clear_results()
    with pytest.raises(KeyError):
        eng.result(rid)


def test_harvest_packing_and_entropy_equal_jax():
    """One f32 buffer a chunk, token ids exact below 2**24, laid out as
    JAX's; the vocab-normalised entropy with -inf logits (masked by top-k)
    as JAX's isneginf guard gives it."""
    import jax.numpy as jnp

    from runia_core_tpu.llm import continuous as jax_continuous
    from runia_core_tpu_torch.llm import continuous

    rng = np.random.RandomState(0)
    k, s = 3, 5
    toks = rng.randint(0, 2**24, (k, s))
    lps, ents = rng.randn(k, s).astype(np.float32), rng.rand(k, s).astype(np.float32)
    emitted, active = rng.rand(k, s) > 0.5, rng.rand(s) > 0.5
    got = continuous._pack_harvest(*(torch.from_numpy(np.asarray(a)) for a in (toks, lps, ents, emitted, active)))
    want = jax_continuous._pack_harvest(*(jnp.asarray(a) for a in (toks, lps, ents, emitted, active)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for mine, theirs in zip(continuous._unpack_harvest(got.numpy(), (k, s), s),
                            jax_continuous._unpack_harvest(np.asarray(want), (k, s), s)):
        np.testing.assert_array_equal(mine, theirs)
    np.testing.assert_array_equal(continuous._unpack_harvest(got.numpy(), (k, s), s)[0], toks)
    logits = rng.randn(4, 64).astype(np.float32)
    logits[:, ::3] = -np.inf
    log_soft = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    want = jax_continuous._vocab_norm_entropy(jnp.asarray(log_soft.numpy()))
    np.testing.assert_allclose(continuous._vocab_norm_entropy(log_soft).numpy(), np.asarray(want), rtol=1e-6)
