"""The port's fused offline drain (ContinuousBatchingEngine.generate_all_fused)
against runia_core_tpu's, on the CPU.

The model and bounds are test_torch_continuous.py's: tokens identical,
log-probs and scores within 1e-5, and ``_last_fused_stats`` (prefill and
decode iterations, accepted and proposed for a draft) equal to JAX's: with
greedy decoding the schedule is deterministic, so this holds the device
scheduler (refill by rank, lanes chosen on the device, duplicate lanes) to
JAX's ``lax.while_loop``. ``prefill_lanes=1`` is held to the port's
interactive drain bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from runia_core_tpu.llm.continuous import ContinuousBatchingEngine as JaxEngine
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
from runia_core_tpu_torch.llm import ContinuousBatchingEngine
from test_torch_continuous import CFG, COUNTERS, MAX_NEW, VOCAB, _port, assert_same_results

torch.set_num_threads(1)

DRAFT_CFG = dict(CFG, num_layers=1)
BASE = dict(num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4, prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    jm = JaxLlamaLM(**CFG)
    params = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    jd = JaxLlamaLM(**DRAFT_CFG)
    dparams = jd.init(jax.random.key(5), np.zeros((1, 8), np.int32))
    return {"target": (jm, params, _port(params)), "draft": (jd, dparams, _port(dparams, DRAFT_CFG))}


@pytest.fixture(scope="module")
def prompts():
    """Seven prompts of 3-44 tokens: up to 6 prefill chunks of 8."""
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, VOCAB, n)) for n in (5, 17, 44, 3, 26, 9, 33)]


def fused_both(models, prompts, budgets=None, lanes=4, draft=None, **kw):
    """generate_all_fused on JAX's engine and the port's; asserts equal
    results, _last_fused_stats and counters; returns the port's engine and
    results."""
    jm, params, port = models["target"]
    jkw, pkw = dict(kw), dict(kw)
    if draft is not None:
        jd, dparams, pd = models[draft]
        jkw.update(draft_model=jd, draft_params=dparams)
        pkw.update(draft_model=pd)
    jeng, peng = JaxEngine(jm, params, **jkw), ContinuousBatchingEngine(port, **pkw)
    want = jeng.generate_all_fused(prompts, budgets, prefill_lanes=lanes)
    got = peng.generate_all_fused(prompts, budgets, prefill_lanes=lanes)
    assert_same_results(got, want)
    assert peng._last_fused_stats == jeng._last_fused_stats
    js, ps = jeng.stats(), peng.stats()
    keys = COUNTERS + (("accepted", "proposed") if draft else ())
    assert {k: ps[k] for k in keys} == {k: js[k] for k in keys}
    return peng, got


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_plain_drain_equals_jax(models, prompts, lanes):
    eng, got = fused_both(models, prompts, lanes=lanes, **BASE)
    assert all(len(r["tokens"]) == MAX_NEW for r in got)
    assert eng._last_fused_stats["prefill_iters"] > 0 and eng._last_fused_stats["decode_iters"] > 0


@pytest.mark.parametrize("kw, budgets", [
    (dict(num_slots=2), [3, 7, 0, 2, 9, 4, 6]),
    (dict(num_slots=5, admission="lpt"), [1, 10, 2, 7, 3, 9, 4]),
    (dict(num_slots=7, chunk_tokens=3), None),
    (dict(num_slots=1, chunk_tokens=5), [2, 4, 1, 3, 5, 2, 1]),
], ids=["two_slots_budgets", "lpt", "slots_for_all", "one_slot"])
def test_schedules_equal_jax(models, prompts, kw, budgets):
    """More requests than slots, per-request budgets (one of zero), lpt
    order undone in the results, every request in a slot at once."""
    _, got = fused_both(models, prompts, budgets, **dict(BASE, **kw))
    if budgets is not None:
        assert [len(r["tokens"]) for r in got] == budgets


def test_eos(models, prompts):
    trace = ContinuousBatchingEngine(models["target"][2], **BASE).generate_all(prompts[:1])
    eos = trace[0]["tokens"][2]
    _, got = fused_both(models, prompts, eos_id=eos, **BASE)
    assert all(eos not in r["tokens"] for r in got) and len(got[0]["tokens"]) <= 2


@pytest.mark.parametrize("kw", [dict(gamma=4, chunk_tokens=10), dict(gamma=2, chunk_tokens=6, eos_id="trace"),
                                dict(gamma=3, chunk_tokens=4, num_slots=2)], ids=["g4", "g2_eos", "g3_one_round"])
def test_spec_branch_equals_jax_and_the_plain_drain(models, prompts, kw):
    """The speculative decode branch: tokens JAX's, accepted / proposed
    JAX's, and the plain drain's greedy tokens."""
    kw = dict(BASE, **kw)
    if kw.get("eos_id") == "trace":
        kw["eos_id"] = ContinuousBatchingEngine(models["target"][2], **BASE).generate_all(prompts[:1])[0]["tokens"][3]
    budgets = [3, 10, 1, 7, 2, 9, 5]
    eng, got = fused_both(models, prompts, budgets, draft="draft", **kw)
    assert eng._last_fused_stats["proposed"] > 0
    plain = ContinuousBatchingEngine(models["target"][2], **{k: v for k, v in kw.items() if k != "gamma"})
    assert_same_results(got, plain.generate_all_fused(prompts, budgets))


def test_spec_branch_with_the_perfect_draft(models, prompts):
    models = dict(models, perfect=models["target"])
    eng, got = fused_both(models, prompts, draft="perfect", **dict(BASE, chunk_tokens=10))
    assert eng._last_fused_stats["acceptance"] > 0.9


@pytest.mark.parametrize("kw", [dict(), dict(gamma=4, chunk_tokens=10, draft=True)], ids=["plain", "spec"])
def test_one_lane_equals_the_interactive_drain_bit_for_bit(models, prompts, kw):
    kw = dict(BASE, **kw)
    if kw.pop("draft", False):
        kw["draft_model"] = models["draft"][2]
    port = models["target"][2]
    budgets = [3, 10, 1, 7, 2, 9, 5]
    fused = ContinuousBatchingEngine(port, **kw).generate_all_fused(prompts, budgets, prefill_lanes=1)
    eng = ContinuousBatchingEngine(port, **kw)
    ids = [eng.submit(p, b) for p, b in zip(prompts, budgets)]
    eng.run_until_drained()
    assert_same_results(fused, [eng.result(i) for i in ids], atol=0.0)


def test_reuse_invalidates_the_prefix_cache_and_keeps_one_program(models):
    """An interactive drain leaves prompts resident; a fused run drops them
    (its slots were rewritten), so the next interactive drain prefills from
    scratch and still matches a fresh engine. A second fused batch of the
    same shape reuses the drain built for the first."""
    port = models["target"][2]
    rng = np.random.RandomState(21)
    system = list(rng.randint(1, VOCAB, 18))
    batch = [system + list(rng.randint(1, VOCAB, rng.randint(2, 9))) for _ in range(4)]
    kw = dict(BASE, prefix_cache=True)
    eng = ContinuousBatchingEngine(port, **kw)
    first = eng.generate_all(batch)
    assert any(p is not None for p in eng._slot_prompt)
    other = [list(rng.randint(1, VOCAB, 20)) for _ in range(4)]
    fused_a = eng.generate_all_fused(other)
    assert all(p is None for p in eng._slot_prompt)
    hits = eng.prefix_hits
    assert_same_results(eng.generate_all(batch), first)
    fresh = ContinuousBatchingEngine(port, **kw)
    fresh.generate_all(batch)
    assert eng.prefix_hits - hits == fresh.prefix_hits
    fused_b = eng.generate_all_fused(other[::-1])
    assert len(eng._fused_cache) == 1
    assert_same_results(fused_b, fused_a[::-1])


def test_counters_empty_workload_and_sampling(models, prompts):
    port = models["target"][2]
    eng = ContinuousBatchingEngine(port, **BASE)
    assert eng.generate_all_fused([]) == []
    budgets = [3, 4, 0, 2, 5, 1, 6]
    eng.generate_all_fused(prompts, budgets)
    stats = eng.stats()
    assert stats["requests_finished"] == len(prompts) and stats["tokens_emitted"] == sum(budgets)
    assert stats["decode_chunks"] == eng._last_fused_stats["decode_iters"]

    def sampled(seed):
        e = ContinuousBatchingEngine(port, do_sample=True, temperature=0.9, generator=torch.Generator().manual_seed(
            seed), **BASE)
        return [r["tokens"] for r in e.generate_all_fused(prompts)], e

    a, e = sampled(7)
    b, _ = sampled(7)
    greedy = [r["tokens"] for r in ContinuousBatchingEngine(port, **BASE).generate_all_fused(prompts)]
    assert a == b and a != greedy and all(len(t) == MAX_NEW for t in a)
    again = [r["tokens"] for r in e.generate_all_fused(prompts)]
    assert again != a  # the engine's generator advanced


@pytest.mark.parametrize("kw, call", [
    (dict(max_ctx=64, prefill_chunk=None), dict()),
    (dict(collect_rauq=True), dict()),
    (dict(collect_hidden=-1), dict()),
    (dict(), dict(budgets=[1, 2])),
    (dict(), dict(prompts=[[]])),
    (dict(), dict(budgets=[60] * 7)),
    (dict(), dict(in_flight=True)),
], ids=["bucketed", "rauq", "hidden", "budget_count", "empty_prompt", "overflow", "in_flight"])
def test_errors_have_the_jax_wording(models, prompts, kw, call):
    jm, params, port = models["target"]
    kw = dict(BASE, **kw)
    errors = []
    for eng in (JaxEngine(jm, params, **kw), ContinuousBatchingEngine(port, **kw)):
        if call.get("in_flight"):
            eng.submit(prompts[0])
        with pytest.raises((ValueError, RuntimeError)) as err:
            eng.generate_all_fused(call.get("prompts", prompts), call.get("budgets"))
        errors.append((err.type, str(err.value)))
    assert errors[1] == errors[0]
