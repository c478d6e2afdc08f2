"""The port's TorchGenerator and sampling against runia_core_tpu's JaxGenerator.

One small f32 LlamaLM (2 layers, d_model 64, 4/2 heads, vocab 128) with
use_flash, weights carried by llama_from_flax. Greedy decoding must give the
same tokens; log-probabilities, attention rows and hidden states agree within
1e-5 (f32 sums in other orders). Random draws are never matched: the
sampling tests hand both frameworks the same noise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.llm import JaxGenerator
from runia_core_tpu.llm.generate import sample_logits as jax_sample_logits
from runia_core_tpu.models.llama import LlamaLM as JaxLlamaLM
from runia_core_tpu_torch.llm import TorchGenerator, filter_logits, run_generation, sample_logits
from runia_core_tpu_torch.models import LlamaLM, llama_from_flax

torch.set_num_threads(1)

CFG = dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, hidden_dim=128, max_len=256)
ATOL = 1e-5
NEW = 5


@pytest.fixture(scope="module")
def pair():
    jm = JaxLlamaLM(**CFG, use_flash=True)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    port = LlamaLM(**CFG, use_flash=True, device="cpu")
    port.load_state_dict(llama_from_flax(params, device="cpu"))
    return JaxGenerator(jm, params, max_new_tokens=NEW, eos_id=None), TorchGenerator(port, max_new_tokens=NEW)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [list(rng.randint(1, 128, n)) for n in (130, 130, 100)]


@pytest.mark.parametrize("lengths", ["uniform", "left_padded"])
def test_generate_batch_greedy(pair, prompts, lengths):
    jg, tg = pair
    batch = prompts[:2] if lengths == "uniform" else prompts
    want = jg.generate_batch(batch, output_attentions=True)
    got = tg.generate_batch(batch, output_attentions=True)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_array_equal(got["prompt_lengths"], want["prompt_lengths"])
    np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["prev_token_attention"], want["prev_token_attention"], atol=ATOL, rtol=0)
    assert len(got["scores"]) == NEW
    np.testing.assert_allclose(np.stack(got["scores"]), np.stack(want["scores"]), atol=5e-5, rtol=0)
    assert tg.generate_batch(batch, output_scores=False)["scores"] == ()


def test_generate_with_attentions_and_hidden_states(pair, prompts):
    jg, tg = pair
    want = jg.generate(prompts[0], num_return_sequences=2)
    got = tg.generate(prompts[0], num_return_sequences=2)
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=ATOL, rtol=0)
    for key in ("attentions", "hidden_states"):
        assert len(got[key]) == len(want[key]) == NEW
        for step_got, step_want in zip(got[key], want[key]):
            assert len(step_got) == len(step_want)
            for a, b in zip(step_got, step_want):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_generate_skips_taps_not_asked_for_and_takes_flash(pair, prompts, monkeypatch):
    """Without attention taps the prompt takes the flash route (its plain
    version on the CPU, so no launch); decode steps stay dense."""
    import runia_core_tpu_torch.models.llama as llama
    from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention

    calls = []

    def spy(q, *args, **kwargs):
        calls.append(q.shape[2])
        return flash_prefix_attention(q, *args, **kwargs)

    monkeypatch.setattr(llama, "flash_prefix_attention", spy)
    jg, tg = pair
    want = jg.generate(prompts[0], output_attentions=False, output_hidden_states=False)
    got = tg.generate(prompts[0], output_attentions=False, output_hidden_states=False)
    assert got["attentions"] == () and got["hidden_states"] == ()
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=ATOL, rtol=0)
    assert calls == [130] * CFG["num_layers"]
    assert flash_prefix_attention.launches == 0


def test_eos_pads_and_masks_finished_rows(pair, prompts):
    jg, tg = pair
    eos = int(jg.generate_batch(prompts[:2])["sequences"][0, 131])  # row 0's second token
    jg_eos = JaxGenerator(jg.model, jg.params, max_new_tokens=NEW, eos_id=eos)
    tg_eos = TorchGenerator(tg.model, max_new_tokens=NEW, eos_id=eos)
    want = jg_eos.generate_batch(prompts[:2])
    got = tg_eos.generate_batch(prompts[:2])
    np.testing.assert_array_equal(got["sequences"], want["sequences"])
    np.testing.assert_array_equal(np.isinf(got["log_probs"]), np.isinf(want["log_probs"]))
    assert np.isinf(got["log_probs"][0, 2:]).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 500, 1.0), (1.0, 0, 0.8), (1.3, 10, 0.6), (1.0, 0, 0.0),
])
def test_sampling_filters_keep_the_jax_support(monkeypatch, temperature, top_k, top_p):
    """The JAX filter's output is read by standing in for its categorical
    draw; the port's filter must leave the same logits finite, with the
    same values."""
    logits = np.random.RandomState(4).randn(3, 64).astype(np.float32) * 3
    monkeypatch.setattr(jax.random, "categorical", lambda key, lg, axis=-1: lg)
    want = np.asarray(jax_sample_logits(jax.random.key(0), jnp.asarray(logits), temperature, top_k, top_p))
    got = filter_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (8, 1.0), (0, 0.9)])
def test_draw_with_injected_noise(top_k, top_p):
    """With the noise handed in, the draw is argmax(filtered + noise); given
    JAX's own Gumbel noise for a key it picks JAX's token for that key."""
    logits = np.random.RandomState(5).randn(4, 64).astype(np.float32)
    key = jax.random.key(3)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    got = sample_logits(torch.from_numpy(logits), None, 1.0, top_k, top_p, noise=torch.from_numpy(noise))
    filtered = filter_logits(torch.from_numpy(logits), 1.0, top_k, top_p)
    torch.testing.assert_close(got, torch.argmax(filtered + torch.from_numpy(noise), dim=-1))
    want = np.asarray(jax_sample_logits(key, jnp.asarray(logits), 1.0, top_k, top_p))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generation_stays_in_the_filtered_support(pair, prompts):
    _, tg = pair
    out = tg.generate_batch(prompts[:2], do_sample=True, top_k=1, generator=torch.Generator().manual_seed(1))
    greedy = tg.generate_batch(prompts[:2])
    np.testing.assert_array_equal(out["sequences"], greedy["sequences"])  # top-1 sampling is greedy


def test_run_generation_refuses_other_backends():
    with pytest.raises(TypeError, match="TorchGenerator"):
        run_generation(object(), None, [1, 2, 3], None, 2, needs_sampling=False)
