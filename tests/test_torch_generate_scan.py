"""TorchGenerator(use_scan=True), the decode steps as one program, against
JaxGenerator(use_scan=True) and against the port's eager loop.

The 2-layer d_model-64 f32 LlamaLM of tests/test_torch_generate.py (weights
carried by llama_from_flax), with and without a KV8 cache. On the CPU the
program's step function runs without capture: it is the code a CUDA graph
records on the card. Against JAX: greedy tokens identical, log-probs,
attentions and hidden states within 1e-5, scores within 5e-5 (f32 sums in
other orders). Against the eager loop the arithmetic is the same, so the
tolerances are the same and in practice the results are equal.
"""

import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import runia_core_tpu_torch.llm.generate as generate
from runia_core_tpu.llm import JaxGenerator
from runia_core_tpu.models.llama import LlamaLM as JaxLlamaLM
from runia_core_tpu_torch.llm import TorchGenerator
from runia_core_tpu_torch.models import LlamaLM, llama_from_flax
from runia_core_tpu_torch.utils.graphs import ProgramCache

torch.set_num_threads(1)

CFG = dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, hidden_dim=128, max_len=256)
ATOL, SCORES_ATOL = 1e-5, 5e-5
NEW = 5


@pytest.fixture(scope="module")
def params():
    jm = JaxLlamaLM(**CFG)
    return jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))


def _generators(params, form, eos_id=None):
    """(JAX scan, port scan, port eager) over one model form."""
    kw = {"f32": dict(use_flash=True), "kv8": dict(quantized_kv=True)}[form]
    port = LlamaLM(**CFG, **kw, device="cpu")
    port.load_state_dict(llama_from_flax(params, device="cpu"))
    jm = JaxLlamaLM(**CFG, **{k: v for k, v in kw.items() if k != "use_flash"})
    return (JaxGenerator(jm, params, max_new_tokens=NEW, eos_id=eos_id, use_scan=True),
            TorchGenerator(port, max_new_tokens=NEW, eos_id=eos_id, use_scan=True),
            TorchGenerator(port, max_new_tokens=NEW, eos_id=eos_id, use_scan=False))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [list(rng.randint(1, 128, n)) for n in (130, 130, 100)]


def _same_batch(got, want, tol_scores):
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_array_equal(got["prompt_lengths"], want["prompt_lengths"])
    np.testing.assert_array_equal(np.isinf(got["log_probs"]), np.isinf(want["log_probs"]))
    np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=ATOL, rtol=0)
    assert len(got["scores"]) == len(want["scores"])
    if got["scores"]:
        np.testing.assert_allclose(np.stack(got["scores"]), np.stack(want["scores"]), atol=tol_scores, rtol=0)
    if "prev_token_attention" in want:
        assert got["prev_token_attention"].shape == want["prev_token_attention"].shape
        np.testing.assert_allclose(got["prev_token_attention"], want["prev_token_attention"], atol=ATOL, rtol=0)


def _same_generate(got, want, tol_scores):
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_array_equal(np.isinf(got["log_probs"]), np.isinf(want["log_probs"]))
    np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.stack(got["scores"]), np.stack(want["scores"]), atol=tol_scores, rtol=0)
    for key in ("attentions", "hidden_states"):
        assert len(got[key]) == len(want[key])
        for step_got, step_want in zip(got[key], want[key]):
            assert len(step_got) == len(step_want)
            for a, b in zip(step_got, step_want):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("form", ["f32", "kv8"])
@pytest.mark.parametrize("lengths", ["uniform", "left_padded"])
def test_generate_batch_scan(params, prompts, form, lengths):
    jg, scan, eager = _generators(params, form)
    batch = prompts[:2] if lengths == "uniform" else prompts
    want = jg.generate_batch(batch, output_attentions=True)
    got = scan.generate_batch(batch, output_attentions=True)
    _same_batch(got, want, SCORES_ATOL)
    _same_batch(got, eager.generate_batch(batch, output_attentions=True), ATOL)
    again = scan.generate_batch(batch, output_attentions=True)  # the cached program, its buffers reused
    _same_batch(again, got, 0.0)
    assert scan.generate_batch(batch, output_scores=False)["scores"] == ()


@pytest.mark.parametrize("form", ["f32", "kv8"])
def test_generate_scan_with_taps(params, prompts, form):
    jg, scan, eager = _generators(params, form)
    want = jg.generate(prompts[0], num_return_sequences=3)
    got = scan.generate(prompts[0], num_return_sequences=3)
    assert len(got["attentions"]) == len(got["hidden_states"]) == NEW
    _same_generate(got, want, SCORES_ATOL)
    _same_generate(got, eager.generate(prompts[0], num_return_sequences=3), ATOL)
    bare = scan.generate(prompts[0], output_attentions=False, output_hidden_states=False)
    assert bare["attentions"] == () and bare["hidden_states"] == ()
    np.testing.assert_array_equal(bare["sequences"], got["sequences"][:1])


@pytest.mark.parametrize("form", ["f32", "kv8"])
def test_eos_pads_and_masks_finished_rows(params, prompts, form):
    """EOS taken at the second step of one row: that row is padded with EOS
    and its later log-probs are -inf, in both entry points."""
    jg, scan, _ = _generators(params, form)
    eos = int(scan.generate_batch(prompts[:2])["sequences"][0, 131])
    jg, scan, eager = _generators(params, form, eos_id=eos)
    want, got = jg.generate_batch(prompts[:2]), scan.generate_batch(prompts[:2])
    _same_batch(got, want, SCORES_ATOL)
    _same_batch(got, eager.generate_batch(prompts[:2]), ATOL)
    assert np.isinf(got["log_probs"][0, 2:]).all() and (got["sequences"][0, 131:] == eos).all()
    eos = int(scan.generate(prompts[0], num_return_sequences=3)["sequences"][0, 131])
    jg, scan, eager = _generators(params, form, eos_id=eos)
    got = scan.generate(prompts[0], num_return_sequences=3)
    _same_generate(got, jg.generate(prompts[0], num_return_sequences=3), SCORES_ATOL)
    _same_generate(got, eager.generate(prompts[0], num_return_sequences=3), ATOL)
    assert np.isinf(got["log_probs"][:, 2:]).all()


@pytest.mark.parametrize("entry", ["generate", "generate_batch"])
def test_sampling_draws_what_the_eager_loop_draws(params, prompts, entry):
    """From one generator state both routes draw the same numbers, so the
    sampled tokens are the same; the generator advances past them."""
    _, scan, eager = _generators(params, "f32")

    def run(gen, seed):
        g = torch.Generator().manual_seed(seed)
        if entry == "generate":
            return gen.generate(prompts[0], num_return_sequences=3, do_sample=True, generator=g, top_k=20), g
        return gen.generate_batch(prompts, do_sample=True, generator=g, temperature=1.3, top_p=0.9), g

    got, g_scan = run(scan, 3)
    want, g_eager = run(eager, 3)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=ATOL, rtol=0)
    assert torch.equal(g_scan.get_state(), g_eager.get_state())
    again, _ = run(scan, 3)
    np.testing.assert_array_equal(again["sequences"], got["sequences"])


def test_program_cache_reuses_a_key_and_evicts_past_64(params, prompts, monkeypatch):
    cache = ProgramCache(generate._PROGRAM_CACHE_MAX)
    monkeypatch.setattr(generate, "_PROGRAM_CACHE", cache)
    _, scan, _ = _generators(params, "f32")
    first = scan.generate_batch(prompts[:2])
    assert len(cache) == 1
    (key, program), = cache.entries.items()
    assert key[:2] == ("batch", scan.device) and key[2]() is scan.model and key[3] is None
    scan.generate_batch(prompts[:2])  # the same key: the same program
    assert len(cache) == 1 and cache.get(key) is program
    scan.generate_batch(prompts[:2], max_new_tokens=NEW - 1)  # another key
    assert len(cache) == 2
    for i in range(generate._PROGRAM_CACHE_MAX - 2):
        generate._cache_put(("filler", i), object())
    assert len(cache) == 64 and key in cache
    assert generate._cached_program(key, lambda: None) is program  # a hit: now the most recent
    generate._cache_put(("filler", "one more"), object())
    assert len(cache) == 64 and key in cache  # the least recent went: the other key
    for i in range(64):
        generate._cache_put(("filler", "later", i), object())
    assert len(cache) == 64 and key not in cache
    rebuilt = scan.generate_batch(prompts[:2])
    assert cache.get(key) is not program
    np.testing.assert_array_equal(rebuilt["sequences"], first["sequences"])


def test_one_program_serves_every_prompt_length_of_its_bucket(params, monkeypatch):
    """Prompts of 129, 150 and 192 tokens share the 192-slot program (the
    length is a device input, the unused slots masked); each call equals
    the eager loop and JAX. 193 tokens take the next bucket."""
    cache = ProgramCache(generate._PROGRAM_CACHE_MAX)
    monkeypatch.setattr(generate, "_PROGRAM_CACHE", cache)
    jg, scan, eager = _generators(params, "f32")
    rng = np.random.RandomState(1)
    for n in (150, 129, 192):
        prompt = list(rng.randint(1, 128, n))
        got = scan.generate(prompt, num_return_sequences=2)
        _same_generate(got, eager.generate(prompt, num_return_sequences=2), ATOL)
        _same_generate(got, jg.generate(prompt, num_return_sequences=2), SCORES_ATOL)
        batch = [prompt, prompt[: n - 20]]
        _same_batch(scan.generate_batch(batch, output_attentions=True),
                    eager.generate_batch(batch, output_attentions=True), ATOL)
    assert len(cache) == 2 and all(program.prompt_slots == 192 for program in cache.entries.values())
    scan.generate(list(rng.randint(1, 128, 193)))
    assert len(cache) == 3 and generate._bucket(193) == 256


def test_a_new_generator_per_call_reuses_the_sampling_program(params, prompts, monkeypatch):
    """The sampling program draws from its own generator, lent the caller's
    state: a new generator object per call hits the cache, and each call
    draws what the eager loop draws from that generator."""
    cache = ProgramCache(generate._PROGRAM_CACHE_MAX)
    monkeypatch.setattr(generate, "_PROGRAM_CACHE", cache)
    _, scan, eager = _generators(params, "f32")
    for seed in (3, 4, 5):
        g_scan, g_eager = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
        got = scan.generate(prompts[0], num_return_sequences=3, do_sample=True, generator=g_scan, top_p=0.9)
        want = eager.generate(prompts[0], num_return_sequences=3, do_sample=True, generator=g_eager, top_p=0.9)
        np.testing.assert_array_equal(got["sequences"], want["sequences"])
        assert torch.equal(g_scan.get_state(), g_eager.get_state())
    assert len(cache) == 1


def test_program_cache_keeps_to_its_byte_budget_and_forgets_a_dead_model(params, prompts, monkeypatch):
    """Past ``max_bytes`` of the programs' buffers the least recently used
    go (the newest stays); a model's programs go with the model."""
    jg, scan, eager = _generators(params, "f32")
    scan.generate_batch(prompts[:2])
    one = generate._PROGRAM_CACHE.get(next(reversed(generate._PROGRAM_CACHE.entries)))
    cache = ProgramCache(generate._PROGRAM_CACHE_MAX, max_bytes=2 * one.nbytes)
    monkeypatch.setattr(generate, "_PROGRAM_CACHE", cache)
    for new in (NEW, NEW - 1, NEW - 2, NEW + 1):
        scan.generate_batch(prompts[:2], max_new_tokens=new)
        assert cache.nbytes <= cache.max_bytes
    assert 1 <= len(cache) < 4
    del jg, scan, eager
    gc.collect()
    assert len(cache) == 0
    small = ProgramCache(4, max_bytes=1)
    small.put("a", one)
    small.put("b", one)
    assert list(small.entries) == ["b"]  # over budget alone: the newest stays
