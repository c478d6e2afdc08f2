"""The port's speculative decoding against runia_core_tpu's.

Small f32 models built once per module in JAX and carried across
(``llama_from_flax``, ``causal_lm_from_flax``): a 3-layer Llama target with
a 1-layer draft, the target as its own draft, its int8 twin as the draft
(``quantize_llama_params``, the production self-draft), and a GPT-2
``CausalLM`` pair. Greedy: tokens identical to JAX's ``SpeculativeGenerator``
and to the port's plain greedy ``TorchGenerator``, target log-probs within
1e-5 of JAX's, rounds and acceptance equal to JAX's. The two frameworks'
random streams differ, so sampling is held by its own properties:
``speculative_sample_round`` given JAX's draws returns JAX's result, its
first token follows the target distribution (TV < 0.02 over 20,000 draws,
the JAX test's bound), and the sampled outputs have JAX's shapes, padding
and -inf.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.llm import SpeculativeGenerator as JaxSpeculativeGenerator
from runia_core_tpu.llm.speculative import speculative_sample_round as jax_sample_round
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
from runia_core_tpu.models import quantize_llama_params as jax_quantize
from runia_core_tpu.models.transformer import CausalLM as JaxCausalLM
from runia_core_tpu_torch.llm import SpeculativeGenerator, TorchGenerator, speculative_sample_round
from runia_core_tpu_torch.llm.speculative import _SpeculativeProgram
from runia_core_tpu_torch.models import CausalLM, LlamaLM, causal_lm_from_flax, llama_from_flax

torch.set_num_threads(1)

ATOL = 1e-5
TARGET = dict(vocab_size=64, num_layers=3, num_heads=4, num_kv_heads=2, d_model=48, hidden_dim=96, max_len=128)
DRAFT = dict(vocab_size=64, num_layers=1, num_heads=2, num_kv_heads=2, d_model=16, hidden_dim=32, max_len=128)
GPT_TARGET = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, max_len=64)
GPT_DRAFT = dict(vocab_size=64, num_layers=1, num_heads=2, d_model=16, max_len=64)


def _pair(jax_cls, port_cls, convert, key, **cfg):
    """(JAX module, its params as numpy, the port's module on the CPU)."""
    module = jax_cls(**cfg)
    params = jax.tree_util.tree_map(np.asarray, module.init(jax.random.key(key), jnp.zeros((1, 8), jnp.int32)))
    port = port_cls(**cfg, device="cpu").eval()
    port.load_state_dict(convert(params, device="cpu"))
    return module, params, port


@pytest.fixture(scope="module")
def models():
    target = _pair(JaxLlamaLM, LlamaLM, llama_from_flax, 0, **TARGET)
    draft = _pair(JaxLlamaLM, LlamaLM, llama_from_flax, 1, **DRAFT)
    q_params = jax.tree_util.tree_map(np.asarray, jax_quantize(target[1]))
    int8 = LlamaLM(**TARGET, quantized=True, device="cpu").eval()
    int8.load_state_dict(llama_from_flax(q_params, device="cpu"))
    return {
        "llama": (target, draft),
        "llama_self": (target, target),
        "llama_int8_self": (target, (JaxLlamaLM(**TARGET, quantized=True), q_params, int8)),
        "gpt2": (_pair(JaxCausalLM, CausalLM, causal_lm_from_flax, 0, **GPT_TARGET),
                 _pair(JaxCausalLM, CausalLM, causal_lm_from_flax, 1, **GPT_DRAFT)),
    }


def _spec(pair, **kw):
    (_, _, target), (_, _, draft) = pair
    return SpeculativeGenerator(target, draft, **kw)


def _jax_spec(pair, **kw):
    (jt, tp, _), (jd, dp, _) = pair
    return JaxSpeculativeGenerator(jt, tp, jd, dp, **kw)


def _plain_greedy(pair, prompt, new):
    return TorchGenerator(pair[0][2], max_new_tokens=new).generate(
        prompt, output_attentions=False, output_hidden_states=False)["sequences"][0]


@pytest.mark.parametrize("name,gamma", [(name, gamma) for name in ("llama", "llama_int8_self", "gpt2")
                                        for gamma in (1, 2, 4)] + [("llama_self", 4)])
def test_greedy_matches_jax_and_plain_greedy(models, name, gamma):
    pair = models[name]
    prompt, new = [3, 14, 15, 9, 2, 6], 12
    want = _jax_spec(pair, gamma=gamma, max_new_tokens=new).generate(prompt)
    got = _spec(pair, gamma=gamma, max_new_tokens=new).generate(prompt)
    np.testing.assert_array_equal(got["sequences"], np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["sequences"][0], _plain_greedy(pair, prompt, new))
    np.testing.assert_allclose(got["log_probs"], np.asarray(want["log_probs"]), atol=ATOL, rtol=0)
    assert got["rounds"] == want["rounds"]
    assert got["acceptance_rate"] == want["acceptance_rate"]
    if name != "llama" and name != "gpt2":  # a draft that agrees with the target
        assert got["acceptance_rate"] >= 0.5 and got["rounds"] < new - 1


def test_eos_stops_as_jax_does(models):
    pair = models["llama"]
    probe = _spec(pair, gamma=2, max_new_tokens=10).generate([1, 2, 3])
    eos = int(probe["tokens"][2])  # stop at the third emitted token
    got = _spec(pair, gamma=2, max_new_tokens=10, eos_id=eos).generate([1, 2, 3])
    want = _jax_spec(pair, gamma=2, max_new_tokens=10, eos_id=eos).generate([1, 2, 3])
    assert int(got["tokens"][-1]) == eos and len(got["tokens"]) <= 3
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["log_probs"], np.asarray(want["log_probs"]), atol=ATOL, rtol=0)
    assert got["rounds"] == want["rounds"]


def test_long_self_draft_has_no_cache_hole_decay(models):
    # A fully accepted round must leave the last proposal's K/V in the draft
    # cache (the draft's gamma+1-th step); a hole there decays acceptance.
    out = _spec(models["llama_self"], gamma=4, max_new_tokens=40).generate([5, 1, 7])
    assert out["acceptance_rate"] >= 0.9, out["acceptance_rate"]
    assert out["rounds"] <= 10


def test_generate_prompts_matches_per_prompt_greedy(models):
    spec = _spec(models["llama"], gamma=2, max_new_tokens=6)
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6], [4, 4, 4, 4]]
    out = spec.generate_prompts(prompts)
    assert out["sequences"].shape == (3, 4 + 6)
    for i, prompt in enumerate(prompts):
        np.testing.assert_array_equal(out["tokens"][i], spec.generate(prompt)["tokens"])


def test_rows_that_finish_early_are_frozen(models):
    """Rows that meet EOS in different rounds: each row is what it is
    decoded alone (its state stops changing once it is done, as under
    JAX's vmapped while_loop), and rounds past the last row change nothing."""
    pair = models["llama_self"]
    prompts = [[1, 2, 3, 4], [9, 8, 7, 6], [4, 4, 4, 4]]
    probe = _spec(pair, gamma=2, max_new_tokens=12).generate(prompts[1])
    eos = int(probe["tokens"][4])
    spec = _spec(pair, gamma=2, max_new_tokens=12, eos_id=eos)
    out = spec.generate_prompts(prompts)
    singles = [spec.generate(p) for p in prompts]
    assert sorted({len(s["tokens"]) for s in singles}) != [12]  # some row stops early
    total_rounds = 0
    for i, single in enumerate(singles):
        n = len(single["tokens"])
        assert out["lengths"][i] == n
        np.testing.assert_array_equal(out["tokens"][i, :n], single["tokens"])
        np.testing.assert_allclose(out["log_probs"][i, :n], single["log_probs"], atol=ATOL, rtol=0)
        assert (out["tokens"][i, n:] == single["tokens"][-1]).all() and np.isneginf(out["log_probs"][i, n:]).all()
        total_rounds += single["rounds"]
    assert out["rounds"] == total_rounds
    (_, _, target), (_, _, draft) = pair
    prog = _SpeculativeProgram(target, draft, 3, 4, 12, 2, eos, False, 1.0, False)
    prog.prefill(torch.tensor(prompts))
    prog.run()
    state = [t.clone() for t in (prog.buf, prog.lpb, prog.n_gen, prog.rounds, prog.accepted, prog.last,
                                 prog.index, prog.finished)]
    assert bool(prog.done)
    for _ in range(2):
        prog.round()
    for before, after in zip(state, (prog.buf, prog.lpb, prog.n_gen, prog.rounds, prog.accepted, prog.last,
                                     prog.index, prog.finished)):
        assert torch.equal(before, after)


def test_sample_round_with_jax_draws_is_jax_round():
    rng = np.random.RandomState(0)
    n, g, v = 64, 3, 8
    draft_p = rng.dirichlet(np.ones(v) * 0.3, size=(n, g)).astype(np.float32)
    target_p = rng.dirichlet(np.ones(v) * 0.3, size=(n, g + 1)).astype(np.float32)
    proposals = rng.randint(0, v, (n, g)).astype(np.int32)
    keys = jax.random.split(jax.random.key(3), n)

    def one(key, prop, dp, tp):
        ku, kc = jax.random.split(key)
        n_acc, emitted = jax_sample_round(prop, dp, tp, key)
        return n_acc, emitted, jax.random.uniform(ku, (g,)), jax.random.gumbel(kc, (v,))

    n_acc, emitted, u, noise = map(np.array, jax.jit(jax.vmap(one))(keys, proposals, draft_p, target_p))
    got_n, got_emitted = speculative_sample_round(
        torch.from_numpy(proposals.astype(np.int64)), torch.from_numpy(draft_p), torch.from_numpy(target_p),
        uniforms=torch.from_numpy(u), noise=torch.from_numpy(noise))
    assert len(set(n_acc.tolist())) > 2  # rejections at several positions and full acceptance
    np.testing.assert_array_equal(got_n.numpy(), n_acc)
    np.testing.assert_array_equal(got_emitted.numpy(), emitted)


def test_sample_round_emits_the_target_distribution():
    """The first emitted token of a round is an exact sample of the target
    distribution, whatever the draft is (TV < 0.02 over 20,000 draws)."""
    v, g, n = 8, 3, 20000
    rng = np.random.RandomState(0)
    draft_p = torch.from_numpy(rng.dirichlet(np.ones(v), size=g).astype(np.float32))
    target_p = torch.from_numpy(rng.dirichlet(np.ones(v), size=g + 1).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    proposals = torch.multinomial(draft_p, n, replacement=True, generator=gen).T  # (n, g)
    _, emitted = speculative_sample_round(proposals, draft_p.expand(n, g, v), target_p.expand(n, g + 1, v), gen)
    freq = np.bincount(emitted[:, 0].numpy(), minlength=v) / n
    tv = 0.5 * np.abs(freq - target_p[0].numpy()).sum()
    assert tv < 0.02, (tv, freq, target_p[0])


def test_sampled_outputs_padding_and_refusals(models):
    pair = models["llama"]
    spec = _spec(pair, gamma=3, max_new_tokens=8, do_sample=True)
    out = spec.generate_samples([2, 7, 1], num_samples=6)
    assert out["sequences"].shape == (6, 3 + 8) and out["tokens"].shape == (6, 8)
    assert (out["lengths"] == 8).all() and np.isfinite(out["log_probs"]).all()
    assert len({tuple(r) for r in out["tokens"].tolist()}) > 1
    probe = _spec(pair, gamma=2, max_new_tokens=10, do_sample=True).generate_samples(
        [1, 2, 3], num_samples=4, generator=torch.Generator().manual_seed(0))
    eos = int(probe["tokens"][0][3])
    out = _spec(pair, gamma=2, max_new_tokens=10, do_sample=True, eos_id=eos).generate_samples(
        [1, 2, 3], num_samples=4, generator=torch.Generator().manual_seed(0))
    assert out["lengths"][0] <= 4 and out["tokens"][0][out["lengths"][0] - 1] == eos
    for i in range(4):
        n = int(out["lengths"][i])
        assert (out["tokens"][i, n:] == out["tokens"][i, n - 1]).all()  # padded with the row's last token
        assert np.isneginf(out["log_probs"][i, n:]).all() and np.isfinite(out["log_probs"][i, :n]).all()
    with pytest.raises(ValueError, match="do_sample"):
        _spec(pair, max_new_tokens=4).generate_samples([1, 2], num_samples=2)
    with pytest.raises(ValueError, match="equal-length"):
        _spec(pair, max_new_tokens=4).generate_prompts([[1, 2], [1, 2, 3]])
    with pytest.warns(UserWarning, match="context window"):
        _spec(pair, gamma=2, max_new_tokens=126).generate(list(range(8)))


def test_repeated_sampled_calls_differ_and_a_callers_generator_wins(models):
    spec = _spec(models["llama"], gamma=2, max_new_tokens=8, do_sample=True)
    a, b = spec.generate([3, 1, 4]), spec.generate([3, 1, 4])
    assert not np.array_equal(a["tokens"], b["tokens"])
    c = spec.generate([3, 1, 4], generator=torch.Generator().manual_seed(5))
    d = spec.generate([3, 1, 4], generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(c["tokens"], d["tokens"])
    self_spec = _spec(models["llama_self"], gamma=4, max_new_tokens=12, do_sample=True)
    assert self_spec.generate([5, 1, 7])["acceptance_rate"] >= 0.75  # p_t == p_d: accepted up to float drift
