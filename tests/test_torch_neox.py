"""The port's GPT-NeoX / Pythia ``NeoXLM`` against runia_core_tpu's, and
``convert_hf_gpt_neox`` against ``transformers`` (the counterpart of
tests/test_neox.py).

Small f32 models. Against JAX (weights by ``neox_from_flax``): logits,
attentions and hidden states within 1e-5, parallel and sequential residual,
partial and full rotary, the KV-cache decode with per-row offsets. Against
HF: the JAX test's rtol 1e-3 / atol 1e-4, and greedy decode equal to HF
``generate`` on both TorchGenerator routes; ``compute_uncertainties`` runs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.models import NeoXLM as JaxNeoXLM
from runia_core_tpu.models import convert_hf_gpt_neox as jax_convert_hf_gpt_neox
from runia_core_tpu.models.transformer import init_cache as jax_init_cache
from runia_core_tpu_torch.llm import TorchGenerator, compute_uncertainties
from runia_core_tpu_torch.models import NeoXLM, convert_hf_gpt_neox, init_cache, neox_from_flax

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

ATOL = 1e-5
CFG = dict(vocab_size=96, num_layers=2, num_heads=4, d_model=32, hidden_dim=80, max_len=64)


def _hf(seed=0, **kw):
    base = dict(vocab_size=96, hidden_size=32, intermediate_size=80, num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=64, rotary_pct=0.25, use_parallel_residual=True)
    base.update(kw)
    torch.manual_seed(seed)
    return transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(**base)).eval()


@pytest.fixture(scope="module")
def pythia():
    return _hf()


@pytest.mark.parametrize("parallel,rotary_pct", [(True, 0.25), (False, 1.0), (True, 0.5)])
def test_forward_and_cache_decode_match_jax(parallel, rotary_pct):
    cfg = dict(CFG, parallel_residual=parallel, rotary_pct=rotary_pct)
    module = JaxNeoXLM(**cfg)
    params = jax.tree_util.tree_map(np.asarray, module.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    port = NeoXLM(**cfg, device="cpu").eval()
    port.load_state_dict(neox_from_flax(params, device="cpu"))
    toks = np.random.RandomState(0).randint(0, 96, (2, 12))
    for got, want in zip(port(torch.from_numpy(toks))[:3], module.apply(params, jnp.asarray(toks))[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    jc, pc = jax_init_cache(module, 2, 16), init_cache(port, 2, 16, "cpu")
    want, _, _, jc = module.apply(params, jnp.asarray(toks[:, :8]), jc, jnp.int32(0))
    got, _, _, pc = port(torch.from_numpy(toks[:, :8]), pc, 0, need_attentions=False, need_hiddens=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    want, _, _, _ = module.apply(params, jnp.asarray(toks[:, 8:9]), jc, jnp.int32(8))
    got, _, _, _ = port(torch.from_numpy(toks[:, 8:9]), pc, torch.tensor([8, 8]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [{}, {"use_parallel_residual": False, "rotary_pct": 1.0}])
def test_convert_hf_gpt_neox_matches_hf_and_jax(pythia, kw):
    hf = _hf(seed=1, **kw) if kw else pythia
    model, state = convert_hf_gpt_neox(hf, device="cpu")
    assert model.parallel_residual == kw.get("use_parallel_residual", True)
    assert model.rotary_pct == kw.get("rotary_pct", 0.25)
    toks = np.random.RandomState(0).randint(1, 96, (2, 12))
    with torch.no_grad():
        want = hf(torch.tensor(toks)).logits.numpy()
    np.testing.assert_allclose(model(torch.from_numpy(toks))[0].numpy(), want, rtol=1e-3, atol=1e-4)
    _, variables = jax_convert_hf_gpt_neox(hf)
    jax_state = neox_from_flax(variables, device="cpu")
    assert sorted(jax_state) == sorted(state)
    for name, value in jax_state.items():
        assert torch.equal(state[name], value), name


def test_greedy_decode_matches_hf_generate(pythia):
    model, _ = convert_hf_gpt_neox(pythia, device="cpu")
    prompt = [5, 11, 40]
    with torch.no_grad():
        want = pythia.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False)[0].numpy()
    for use_scan in (True, False):
        got = TorchGenerator(model, max_new_tokens=6, use_scan=use_scan).generate(
            prompt, output_attentions=False, output_hidden_states=False)["sequences"][0]
        np.testing.assert_array_equal(got, want)


def test_uncertainty_scores_run(pythia):
    model, _ = convert_hf_gpt_neox(pythia, device="cpu")
    _, scores = compute_uncertainties(TorchGenerator(model, max_new_tokens=4), None, [3, 9, 27],
                                      [{"method_name": "perplexity"}, {"method_name": "RAUQ"}], num_samples=2)
    assert np.isfinite(np.asarray(scores["perplexity"])).all()
    assert np.isfinite(np.asarray(scores["RAUQ_mean_all_tokens_rollout"])).all()
