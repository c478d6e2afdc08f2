"""The port's HF converters (convert_hf_llama / convert_hf_gemma /
convert_hf_mixtral) against the HF torch forward and the JAX converters.

(Named apart from tests/test_torch_convert.py, which tests the JAX
package's torch -> flax converter.)

Tiny random-init HF models from local configs, as tests/test_llama.py
builds them. Logits within the JAX tests' bounds: rtol 1e-4 / atol 2e-4 for
Llama against HF (tests/test_llama.py:47-55), rtol 1e-3 / atol 1e-4 for the
other families; the port against the JAX converter's model within 5e-5
absolute (the same f32 arithmetic). The int8 forms hold exactly the JAX
converter's int8 values and scales, and the refusals are the JAX ones.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from runia_core_tpu.models import convert_hf_gemma as jax_convert_hf_gemma
from runia_core_tpu.models import convert_hf_llama as jax_convert_hf_llama
from runia_core_tpu.models import convert_hf_mixtral as jax_convert_hf_mixtral
from runia_core_tpu_torch.llm import TorchGenerator
from runia_core_tpu_torch.models import convert_hf_gemma, convert_hf_llama, convert_hf_mixtral, llama_from_flax

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

JAX_ATOL = 5e-5
SMALL = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)


def _hf(family, seed=0, **over):
    config, model = {
        "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM),
        "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM),
        "mistral": (transformers.MistralConfig, transformers.MistralForCausalLM),
        "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM),
        "gemma2": (transformers.Gemma2Config, transformers.Gemma2ForCausalLM),
        "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM),
    }[family]
    torch.manual_seed(seed)
    return model(config(**{**SMALL, **over})).eval()


CASES = {  # id: (family, HF config overrides, port converter, JAX converter, rtol, atol, tokens)
    "llama": ("llama", dict(attn_implementation="eager"), convert_hf_llama, jax_convert_hf_llama, 1e-4, 2e-4, 12),
    "llama_tied_mha": ("llama", dict(tie_word_embeddings=True, num_key_value_heads=4), convert_hf_llama,
                       jax_convert_hf_llama, 1e-4, 2e-4, 10),
    "qwen2_biases": ("qwen2", dict(tie_word_embeddings=False), convert_hf_llama, jax_convert_hf_llama, 1e-3, 1e-4,
                     10),
    "qwen2_windowed": ("qwen2", dict(sliding_window=8, use_sliding_window=True, max_window_layers=0),
                       convert_hf_llama, jax_convert_hf_llama, 1e-3, 1e-4, 20),
    "mistral_windowed": ("mistral", dict(sliding_window=8), convert_hf_llama, jax_convert_hf_llama, 1e-3, 1e-4, 20),
    "gemma": ("gemma", dict(head_dim=8), convert_hf_gemma, jax_convert_hf_gemma, 1e-3, 1e-4, 10),
    "mixtral": ("mixtral", dict(num_local_experts=4, num_experts_per_tok=2, sliding_window=None), convert_hf_mixtral,
                jax_convert_hf_mixtral, 1e-3, 1e-4, 10),
}


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_hf_and_the_jax_converter(case):
    family, over, port_convert, jax_convert, rtol, atol, t = CASES[case]
    hf = _hf(family, **over)
    tokens = np.random.RandomState(0).randint(1, 96, (2, t))
    model, state = port_convert(hf, device="cpu")
    got = model(torch.from_numpy(tokens))[0].numpy()
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    jax_model, jax_params = jax_convert(hf)
    np.testing.assert_allclose(got, np.asarray(jax_model.apply(jax_params, jnp.asarray(tokens))[0]),
                               atol=JAX_ATOL, rtol=0)
    fields = ("num_layers", "num_heads", "num_kv_heads", "head_dim", "max_len", "rope_theta", "rms_eps",
              "tie_embeddings", "attn_bias", "sliding_window", "embed_scale", "mlp_act", "num_experts",
              "num_experts_per_tok")
    assert {f: getattr(model, f) for f in fields} == {f: getattr(jax_model, f) for f in fields}
    assert all(p.data_ptr() == state[name].data_ptr() for name, p in model.named_parameters())


@pytest.mark.parametrize("case", ["llama", "gemma", "mixtral"])
def test_int8_state_is_the_jax_converters(case):
    family, over, port_convert, jax_convert, *_ = CASES[case]
    hf = _hf(family, **over)
    model, state = port_convert(hf, quantize=True, quantize_kv=True, device="cpu")
    assert model.quantized and model.quantized_kv
    jax_model, jax_params = jax_convert(hf, quantize=True, quantize_kv=True)
    theirs = llama_from_flax(jax_params, device="cpu")
    assert sorted(state) == sorted(theirs)
    for name, value in state.items():
        assert value.dtype == theirs[name].dtype and torch.equal(value, theirs[name]), name
    tokens = np.random.RandomState(1).randint(1, 96, (1, 8))
    want = np.asarray(jax_model.apply(jax_params, jnp.asarray(tokens))[0])
    np.testing.assert_allclose(model(torch.from_numpy(tokens))[0].numpy(), want, atol=JAX_ATOL, rtol=0)


def test_bf16_storage_and_greedy_decode_match_hf():
    hf = _hf("mixtral", num_local_experts=4, num_experts_per_tok=2, sliding_window=None)
    bf16, state = convert_hf_mixtral(hf, dtype=torch.bfloat16, use_flash=True, device="cpu")
    assert state["block_0.w_gate"].dtype == torch.bfloat16 and state["block_0.router.kernel"].dtype == torch.bfloat16
    assert state["norm_f.scale"].dtype == torch.float32 and bf16.use_flash
    model, _ = convert_hf_mixtral(hf, device="cpu")
    prompt = [5, 17, 42]
    got = TorchGenerator(model, max_new_tokens=6).generate(prompt, output_attentions=False,
                                                           output_hidden_states=False)["sequences"][0]
    with torch.no_grad():
        want = hf.generate(torch.tensor([prompt]), max_new_tokens=6, do_sample=False)[0].numpy()
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("case", [
    "rope_scaling", "mixed_windows", "llama_window_flash", "gemma2_softcapping", "gemma_activations_disagree",
    "gemma_activation", "mixtral_activation", "mixtral_window_flash",
])
def test_refusals_are_the_jax_converters(case):
    if case == "rope_scaling":
        hf, fns, kw = _hf("llama"), (convert_hf_llama, jax_convert_hf_llama), {}
        hf.config.rope_scaling = {"rope_type": "linear", "factor": 2.0}
        error = NotImplementedError
    elif case == "mixed_windows":
        hf = _hf("qwen2", sliding_window=8, use_sliding_window=True, max_window_layers=1)
        fns, kw, error = (convert_hf_llama, jax_convert_hf_llama), {}, NotImplementedError
    elif case == "llama_window_flash":
        hf = _hf("mistral", sliding_window=8)
        fns, kw, error = (convert_hf_llama, jax_convert_hf_llama), dict(use_flash=True), NotImplementedError
    elif case == "gemma2_softcapping":
        hf = _hf("gemma2", head_dim=8)
        fns, kw, error = (convert_hf_gemma, jax_convert_hf_gemma), {}, NotImplementedError
    elif case == "gemma_activations_disagree":
        hf = _hf("gemma", head_dim=8)
        hf.config.hidden_activation = "gelu"
        fns, kw, error = (convert_hf_gemma, jax_convert_hf_gemma), {}, ValueError
    elif case == "gemma_activation":
        hf = _hf("gemma", head_dim=8)
        hf.config.hidden_act = "relu"
        fns, kw, error = (convert_hf_gemma, jax_convert_hf_gemma), {}, NotImplementedError
    elif case == "mixtral_activation":
        hf = _hf("mixtral", num_local_experts=2, sliding_window=None)
        hf.config.hidden_act = "gelu"
        fns, kw, error = (convert_hf_mixtral, jax_convert_hf_mixtral), {}, NotImplementedError
    else:
        hf = _hf("mixtral", num_local_experts=2, sliding_window=8)
        fns, kw, error = (convert_hf_mixtral, jax_convert_hf_mixtral), dict(use_flash=True), NotImplementedError
    port_convert, jax_convert = fns
    with pytest.raises(error) as jax_raised:
        jax_convert(hf, **kw)
    with pytest.raises(error) as port_raised:
        port_convert(hf, device="cpu", **kw)
    assert str(port_raised.value) == str(jax_raised.value)
