"""The port's GPT-2 ``CausalLM`` against runia_core_tpu's, and
``convert_hf_gpt2`` against ``transformers``.

Small f32 models: JAX weights carried by ``causal_lm_from_flax``; logits,
attentions and hidden states within 1e-5 of JAX's, dense and top-2 MoE, the
MoE with generous capacity and with tokens dropped (capacity is computed per
call, so JAX's drops are reproduced, not fixed); the KV-cache decode with
per-row offsets; positions past the learned table give JAX's NaN. The HF
converter within the JAX test's rtol 2e-4 / atol 2e-5 of HF's logits, and
greedy decode equal to HF ``generate``. Both TorchGenerator routes run over
the model, and so does ``compute_uncertainties``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.models.transformer import CausalLM as JaxCausalLM
from runia_core_tpu.models.transformer import convert_hf_gpt2 as jax_convert_hf_gpt2
from runia_core_tpu.models.transformer import init_cache as jax_init_cache
from runia_core_tpu_torch.llm import TorchGenerator, compute_uncertainties
from runia_core_tpu_torch.models import CausalLM, causal_lm_from_flax, convert_hf_gpt2, init_cache

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

ATOL = 1e-5
CFG = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=32, max_len=64)


def _pair(**cfg):
    module = JaxCausalLM(**cfg)
    params = jax.tree_util.tree_map(np.asarray, module.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    port = CausalLM(**cfg, device="cpu").eval()
    port.load_state_dict(causal_lm_from_flax(params, device="cpu"))
    return module, params, port


@pytest.fixture(scope="module")
def hf_gpt2():
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=128, n_positions=64, n_embd=32, n_layer=2, n_head=4)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("variant", ["dense", "tied", "moe", "moe_overflow"])
def test_forward_and_cache_decode_match_jax(variant):
    extra = {"dense": {}, "tied": {"tie_embeddings": True, "ln_eps": 1e-5},
             "moe": {"num_experts": 4, "moe_capacity_factor": 4.0},
             "moe_overflow": {"num_experts": 4, "moe_capacity_factor": 0.5}}[variant]
    module, params, port = _pair(**CFG, **extra)
    toks = np.random.RandomState(0).randint(0, 96, (2, 12))
    want = module.apply(params, jnp.asarray(toks))
    got = port(torch.from_numpy(toks))
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    valid = np.ones((2, 12), bool)
    valid[1, :3] = False  # left padding
    want = module.apply(params, jnp.asarray(toks), token_valid=jnp.asarray(valid))
    got = port(torch.from_numpy(toks), token_valid=torch.from_numpy(valid))
    _close(got[0], want[0])
    # prefill 8 tokens into a cache, then one step at a shared and at per-row offsets
    jc, pc = jax_init_cache(module, 2, 16), init_cache(port, 2, 16, "cpu")
    want, _, _, jc = module.apply(params, jnp.asarray(toks[:, :8]), jc, jnp.int32(0))
    got, _, _, pc = port(torch.from_numpy(toks[:, :8]), pc, 0)
    _close(got, want)
    want, attn_w, _, jc = module.apply(params, jnp.asarray(toks[:, 8:9]), jc, jnp.int32(8))
    got, attn, hid, _ = port(torch.from_numpy(toks[:, 8:9]), pc, torch.tensor([8, 8]), need_hiddens=False)
    _close(got, want)
    _close(attn, attn_w)
    assert hid is None
    last, _, _, _ = port(torch.from_numpy(toks[:, :8]), None, last_logits_only=True, need_attentions=False)
    _close(last, module.apply(params, jnp.asarray(toks[:, :8]))[0][:, -1:])


def test_moe_overflow_drops_tokens_as_jax_does():
    """With capacity 0.5 x T / E some tokens are dropped (their FFN output
    is zero): the result differs from the generous-capacity model on the
    same weights, and equals JAX's."""
    module, params, port = _pair(**CFG, num_experts=4, moe_capacity_factor=0.5)
    generous = CausalLM(**CFG, num_experts=4, moe_capacity_factor=4.0, device="cpu").eval()
    generous.load_state_dict(port.state_dict())
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 96, (2, 12)))
    assert (port(toks)[0] - generous(toks)[0]).abs().max() > 1e-3


def test_positions_past_the_table_are_jax_nan():
    module, params, port = _pair(**dict(CFG, max_len=8))
    toks = np.arange(10)[None, :]
    want = np.asarray(module.apply(params, jnp.asarray(toks))[0])
    got = port(torch.from_numpy(toks))[0].numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
    np.testing.assert_allclose(port(torch.from_numpy(toks[:, :8]))[0].numpy(),
                               np.asarray(module.apply(params, jnp.asarray(toks[:, :8]))[0]), atol=ATOL, rtol=0)


def test_convert_hf_gpt2_matches_hf_and_jax(hf_gpt2):
    model, state = convert_hf_gpt2(hf_gpt2, device="cpu")
    assert model.tie_embeddings and model.ln_eps == 1e-5 and model.max_len == 64
    assert model.block_0.q.kernel.data_ptr() == state["block_0.q.kernel"].data_ptr()  # loaded with assign=True
    ids = np.random.RandomState(0).randint(0, 128, (2, 10))
    with torch.no_grad():
        ref = hf_gpt2(torch.from_numpy(ids)).logits.numpy()
    ours, attns, hiddens, _ = model(torch.from_numpy(ids))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-5)
    assert attns.shape == (2, 2, 4, 10, 10) and hiddens.shape == (3, 2, 10, 32)
    _, variables = jax_convert_hf_gpt2(hf_gpt2)
    jax_state = causal_lm_from_flax(jax.tree_util.tree_map(np.asarray, variables), device="cpu")
    assert sorted(jax_state) == sorted(state)
    for name, value in jax_state.items():
        assert torch.equal(state[name], value), name
    bad = transformers.GPT2LMHeadModel(transformers.GPT2Config(n_embd=32, n_layer=1, n_head=4, vocab_size=16,
                                                               activation_function="relu"))
    with pytest.raises(NotImplementedError, match="activation_function"):
        convert_hf_gpt2(bad, device="cpu")


def test_greedy_decode_matches_hf_generate(hf_gpt2):
    model, _ = convert_hf_gpt2(hf_gpt2, device="cpu")
    prompt = [3, 17, 42, 9]
    with torch.no_grad():
        ref = hf_gpt2.generate(torch.tensor([prompt]), generation_config=transformers.GenerationConfig(
            max_new_tokens=8, do_sample=False, pad_token_id=0, eos_token_id=None)).numpy()
    for use_scan in (True, False):
        ours = TorchGenerator(model, max_new_tokens=8, use_scan=use_scan).generate(
            prompt, output_attentions=False, output_hidden_states=False)
        np.testing.assert_array_equal(ours["sequences"], ref)


def test_both_routes_and_uncertainty_scores_run():
    _, _, port = _pair(**CFG)
    prompts = [[5, 9, 2, 7, 1], [3, 4, 8]]
    scan, eager = (TorchGenerator(port, max_new_tokens=5, use_scan=s) for s in (True, False))
    for kwargs in (dict(output_attentions=True), dict(do_sample=True, generator=torch.Generator().manual_seed(3))):
        a = scan.generate_batch(prompts, **kwargs)
        if "generator" in kwargs:
            kwargs["generator"].manual_seed(3)
        b = eager.generate_batch(prompts, **kwargs)
        np.testing.assert_array_equal(a["sequences"], b["sequences"])
        np.testing.assert_allclose(a["log_probs"], b["log_probs"], atol=ATOL, rtol=0)
    _, result = compute_uncertainties(scan, None, [3, 9, 27], [{"method_name": "perplexity"}, {"method_name": "RAUQ"},
                                                               {"method_name": "eigen_score", "layer_index": 1}],
                                      num_samples=3)
    assert all(np.isfinite(np.asarray(v)).all() for v in result.values())
