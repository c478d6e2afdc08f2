"""The port's ContinuousBatchingEngine against runia_core_tpu's, on the CPU.

The JAX engine's test model (tests/test_continuous_batching.py: 2 layers,
d_model 32, 4 query and 2 KV heads of 8, vocab 64), built once and carried
across with llama_from_flax; both engines serve the same seeded prompts and
budgets. On the CPU the port runs its program bodies uncaptured: the code a
CUDA graph records on the card. Bounds: tokens identical; log-probs,
perplexity, generation entropy, RAUQ and hidden vectors within 1e-5 (f32
sums in other orders; measured about 1e-6); the stats counters equal.

This file holds the decode and prefill paths; the drains, the prefix cache,
lanes, sampling and the errors are in test_torch_continuous_drains.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.llm.continuous import ContinuousBatchingEngine as JaxEngine
from runia_core_tpu.llm.generate import JaxGenerator
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
from runia_core_tpu.models.llama import fuse_quantized_llama_params as jax_fuse
from runia_core_tpu.models.llama import quantize_llama_params as jax_quantize
from runia_core_tpu.models.transformer import init_cache as jax_init_cache
from runia_core_tpu_torch.llm import ContinuousBatchingEngine, TorchGenerator
from runia_core_tpu_torch.models import LlamaLM, init_cache, llama_from_flax

torch.set_num_threads(1)

VOCAB, MAX_NEW = 64, 10
CFG = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, num_kv_heads=2, d_model=32, hidden_dim=64, max_len=128)
ATOL = 1e-5
# KV8: tests/test_torch_llama.py's bound on logits (5e-3: a cached code that
# rounds to the other neighbour of a half-integer than JAX's moves that value
# by max|x| / 127), doubled for a log-probability, which moves by at most
# twice the largest logit move.
KV8_ATOL = 2 * 5e-3
COUNTERS = ("requests_finished", "tokens_emitted", "decode_chunks", "prefill_chunks", "deferred_admissions",
            "prefix_hits")


def _port(params, cfg=CFG, **kw):
    model = LlamaLM(**cfg, **kw, device="cpu")
    model.load_state_dict(llama_from_flax(jax.tree_util.tree_map(np.asarray, params), device="cpu"))
    return model


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model on the same weights)."""
    jm = JaxLlamaLM(**CFG)
    params = jm.init(jax.random.key(0), np.zeros((1, 8), np.int32))
    return jm, params, _port(params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(3)
    return [list(rng.randint(1, VOCAB, rng.randint(3, 20))) for _ in range(7)]


def serve(engine, prompts, budgets=None):
    """Results in submission order (per-request budgets if given)."""
    if budgets is None:
        return engine.generate_all(prompts)
    ids = [engine.submit(p, b) for p, b in zip(prompts, budgets)]
    engine.run_until_drained()
    return [engine.result(i) for i in ids]


def assert_same_results(got, want, atol=ATOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["tokens"] == [int(t) for t in w["tokens"]], f"request {i}"
        assert g["prompt_length"] == w["prompt_length"]
        np.testing.assert_allclose(g["log_probs"], np.asarray(w["log_probs"]), atol=atol, rtol=0, err_msg=f"{i}")
        for key in ("perplexity", "generation_entropy", "rauq"):
            if key in w:
                np.testing.assert_allclose(g[key], w[key], atol=atol, rtol=0, err_msg=f"{key} {i}")
        if "hidden" in w:
            if w["hidden"] is None:
                assert g["hidden"] is None
            else:
                np.testing.assert_allclose(g["hidden"], np.asarray(w["hidden"]), atol=atol, rtol=0)


def both(pair, prompts, budgets=None, jax_model=None, port_model=None, atol=ATOL, **kw):
    """Serve ``prompts`` on the JAX engine and the port's with the same
    arguments; assert equal results and counters; returns the port's
    engine and results."""
    jm, params, port = pair
    jeng = JaxEngine(jax_model or jm, params, **kw)
    peng = ContinuousBatchingEngine(port_model or port, **kw)
    want, got = serve(jeng, prompts, budgets), serve(peng, prompts, budgets)
    assert_same_results(got, want, atol)
    js, ps = jeng.stats(), peng.stats()
    assert {k: ps[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
    return peng, got


def test_refill_more_requests_than_slots(pair, prompts):
    """3 slots < 7 prompts: every slot refills at least once."""
    eng, got = both(pair, prompts, num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4)
    assert all(len(r["tokens"]) == MAX_NEW for r in got)
    assert eng.stats()["requests_finished"] == len(prompts)


@pytest.mark.parametrize("prefill_chunk", [None, 16], ids=["bucketed", "chunked"])
def test_eos_cut(pair, prompts, prefill_chunk):
    """EOS is a token the greedy trace emits mid-sequence: the slot stops
    early, is refilled, and the EOS is stripped."""
    jm, params, port = pair
    trace = JaxEngine(jm, params, num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW).generate_all(prompts[:1])
    eos = int(trace[0]["tokens"][2])
    _, got = both(pair, prompts, num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=3, eos_id=eos,
                  prefill_chunk=prefill_chunk)
    assert all(eos not in r["tokens"] for r in got)
    assert len(got[0]["tokens"]) <= 2 < MAX_NEW


def test_per_request_budgets_and_a_zero_budget(pair, prompts):
    budgets = [3, 7, 0, 2, 9, 4, 6]
    _, got = both(pair, prompts, budgets, num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4)
    assert [len(r["tokens"]) for r in got] == budgets
    assert np.isnan(got[2]["perplexity"]) and np.isnan(got[2]["generation_entropy"])


def test_chunked_prefill(pair, prompts):
    both(pair, prompts, num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4, prefill_chunk=8)


def test_long_prompt_admitted_mid_decode(pair):
    """A 6-chunk prompt refilled into a busy engine while other slots keep
    emitting."""
    rng = np.random.RandomState(11)
    short = [list(rng.randint(1, VOCAB, 4)) for _ in range(3)]
    batch = short + [list(rng.randint(1, VOCAB, 45))] + short
    both(pair, batch, num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=3, prefill_chunk=8)


def test_bucketed_waves_of_batch_f(pair):
    """10 prompts in one bucket: 8 ride one batched prefill, 2 the F = 1
    shape; and a wave over two buckets."""
    rng = np.random.RandomState(12)
    wave = [list(rng.randint(1, VOCAB, rng.randint(9, 16))) for _ in range(10)]
    both(pair, wave, num_slots=10, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4, prompt_bucket=16)
    mixed = [list(rng.randint(1, VOCAB, n)) for n in (3, 5, 7, 9, 12, 15)]
    both(pair, mixed, num_slots=6, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4, prompt_bucket=8)


def test_flash_model_chunked_prefill(pair, prompts, monkeypatch):
    """A use_flash model's chunked prefill: JAX takes its flash kernel (in
    interpret mode, the size gate lowered as its own test does), the port
    the plain version of kernel 4 (``_FLASH_MIN_TOKENS`` lowered), with
    per-row q_start; both against each other and the port against its
    dense engine."""
    from runia_core_tpu.models import llama as jax_llama
    from runia_core_tpu_torch.models import llama as port_llama

    jm, params, port = pair
    monkeypatch.setattr(jax_llama, "_flash_available", lambda t: t >= 8)
    monkeypatch.setattr(port_llama, "_FLASH_MIN_TOKENS", 8)
    calls = []
    real = port_llama.flash_prefix_attention
    monkeypatch.setattr(port_llama, "flash_prefix_attention", lambda *a, **k: calls.append(a[3]) or real(*a, **k))
    # A 45-token prompt shares lane groups with short ones admitted later.
    rng = np.random.RandomState(11)
    batch = [list(rng.randint(1, VOCAB, 45))] + prompts
    kw = dict(num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4, prefill_chunk=8, prefill_lanes=2)
    _, got = both(pair, batch, jax_model=JaxLlamaLM(**CFG, use_flash=True), port_model=_port(params, use_flash=True),
                  **kw)
    assert calls and any(len(set(q.tolist())) > 1 for q in calls), "kernel 4 ran with per-row q_start"
    dense = ContinuousBatchingEngine(port, **kw).generate_all(batch)
    assert_same_results(got, dense)


def test_collect_rauq(pair, prompts):
    """In-loop RAUQ (the previous-position attention gathered in the chunk)
    against the JAX engine's, and against rauq_uncertainty on the full
    attentions of the same greedy trace."""
    from runia_core_tpu_torch.llm import rauq_uncertainty

    jm, params, port = pair
    _, got = both(pair, prompts[:4], num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4,
                  collect_rauq=True)
    gen = TorchGenerator(port, max_new_tokens=MAX_NEW)
    for p, res in zip(prompts[:4], got):
        out = gen.generate(p, output_attentions=True, output_hidden_states=False)
        np.testing.assert_allclose(res["rauq"], rauq_uncertainty(out["log_probs"], out["attentions"], "original"),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("layer", [-1, 1])
def test_collect_hidden(pair, prompts, layer):
    both(pair, prompts[:5], num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4, collect_hidden=layer)
    both(pair, prompts[:5], num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=3, prefill_chunk=8,
         prefill_lanes=2, collect_hidden=layer)


def test_int8_kv8_fused_model():
    """An int8 + KV8 + fused qkv / gate|up model, quantized by the JAX
    package and carried across; tokens identical, scores within KV8_ATOL
    (one cached code of these prompts rounds to the other neighbour of a
    half-integer than JAX's). Heads of 16, as the KV8 parity of
    tests/test_torch_llama.py: at heads of 64 such flips are more frequent
    (tests/test_torch_llama.py's one-flip bound) and could move a greedy
    near-tie."""
    cfg = dict(CFG, d_model=64, hidden_dim=128)
    kw = dict(quantized=True, quantized_kv=True, fused_qkv=True)
    float_params = JaxLlamaLM(**cfg).init(jax.random.key(1), np.zeros((1, 8), np.int32))
    params = jax_fuse(jax_quantize(jax.tree_util.tree_map(np.asarray, float_params)))
    jm, port = JaxLlamaLM(**cfg, **kw), _port(params, cfg, **kw)
    assert port.head_dim == 16
    rng = np.random.RandomState(4)
    batch = [list(rng.randint(1, VOCAB, rng.randint(3, 30))) for _ in range(5)]
    both((jm, params, port), batch, atol=KV8_ATOL, num_slots=2, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4)
    both((jm, params, port), batch, atol=KV8_ATOL, num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4,
         prefill_chunk=16, prefill_lanes=2, defer_fetch=True)


def test_vector_index_equals_scalar_when_uniform(pair):
    """A (B,) cache_index of equal entries reproduces the scalar path (the
    engine's programs always pass the vector form), in the port as in JAX,
    and the two frameworks agree."""
    jm, params, port = pair
    b, p = 3, 8
    prompt = np.random.RandomState(0).randint(1, VOCAB, (b, p))
    jcache = jm.apply(params, jnp.asarray(prompt, jnp.int32), jax_init_cache(jm, b, 32), jnp.int32(0))[3]
    cache = init_cache(port, b, 32, device="cpu")
    logits, _, _, cache = port(torch.from_numpy(prompt), cache, 0)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    saved = {"layers": [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]}
    scalar, _, _, _ = port(tok, cache, p)
    vector, _, _, after = port(tok, saved, torch.full((b,), p))
    np.testing.assert_allclose(vector.numpy(), scalar.numpy(), rtol=1e-6, atol=1e-6)
    for lv, ls in zip(after["layers"], cache["layers"]):
        for name in lv:
            torch.testing.assert_close(lv[name], ls[name], rtol=0, atol=0)
    want = jm.apply(params, jnp.asarray(tok.numpy(), jnp.int32), jcache, jnp.full((b,), p, jnp.int32))[0]
    np.testing.assert_allclose(vector.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_greedy_equals_torch_generator(pair, prompts):
    """The JAX contract: the engine's greedy tokens are
    TorchGenerator.generate's, prompt by prompt (and JaxGenerator's)."""
    jm, params, port = pair
    gen, jgen = TorchGenerator(port, max_new_tokens=MAX_NEW), JaxGenerator(jm, params, max_new_tokens=MAX_NEW)
    for kw in (dict(), dict(prefill_chunk=8, prefill_lanes=3)):
        got = ContinuousBatchingEngine(port, num_slots=3, max_ctx=64, max_new_tokens=MAX_NEW, chunk_tokens=4,
                                       **kw).generate_all(prompts)
        for p, res in zip(prompts, got):
            out = gen.generate(p, output_attentions=False, output_hidden_states=False)
            assert res["tokens"] == out["sequences"][0, len(p):].tolist()
            np.testing.assert_allclose(res["log_probs"], out["log_probs"][0], atol=ATOL, rtol=0)
            jout = jgen.generate(p, do_sample=False, output_attentions=False, output_hidden_states=False)
            assert res["tokens"] == np.asarray(jout["sequences"][0, len(p):]).tolist()
