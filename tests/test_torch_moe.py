"""The port's sparse-MoE LlamaLM (Mixtral) against runia_core_tpu's.

A small model (2 layers, d_model 64, 4 query and 2 KV heads, 4 experts of
128, top-2, vocab 128) on weights carried by llama_from_flax. Bounds:

* f32: 5e-5 absolute on logits of order 1-5, the dense model's bound: the
  same f32 arithmetic (the port sums the gated experts one by one where JAX
  contracts an einsum);
* int8 experts: the same bound: both dequantize the same int8 values and
  scales (kernel 3's plain version on the CPU computes x @ (q * scale) in
  f32), and the port's quantizer gives JAX's int8 values and scales
  exactly;
* KV8: 5e-3, tests/test_torch_llama.py's (an ulp can flip an int8 step).

Greedy decoding gives the same tokens as JaxGenerator, with log-probs
within 1e-5; a cached decode equals the full forward within 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.llm import JaxGenerator
from runia_core_tpu.models.llama import LlamaLM as JaxLlamaLM
from runia_core_tpu.models.llama import fuse_quantized_llama_params as jax_fuse
from runia_core_tpu.models.llama import quantize_llama_params as jax_quantize
from runia_core_tpu.models.transformer import init_cache as jax_init_cache
from runia_core_tpu_torch.llm import TorchGenerator
from runia_core_tpu_torch.models import (
    LlamaLM,
    fuse_quantized_llama_params,
    init_cache,
    llama_from_flax,
    quantize_llama_params,
)

torch.set_num_threads(1)

CFG = dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, hidden_dim=128, max_len=256,
           num_experts=4, num_experts_per_tok=2)
F32_ATOL, KV8_ATOL, GEN_ATOL = 5e-5, 5e-3, 1e-5


@pytest.fixture(scope="module")
def params():
    """A JAX MoE model's parameters with the norm scales moved off 1."""
    jm = JaxLlamaLM(**CFG)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    rng = np.random.RandomState(0)
    for name, block in tree.items():
        for norm in ("input_norm", "post_attn_norm"):
            if norm in block:
                block[norm]["scale"] = rng.uniform(0.5, 1.5, block[norm]["scale"].shape).astype(np.float32)
    return {"params": tree}


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(1).randint(0, 128, (2, 24))


def _pair(params, **kw):
    port = LlamaLM(**CFG, **kw, device="cpu")
    port.load_state_dict(llama_from_flax(params, device="cpu"))
    return JaxLlamaLM(**CFG, **{k: v for k, v in kw.items() if k != "use_flash"}), port


def _forms(params):
    """(id, JAX parameters, model flags) of the float and int8 forms."""
    q = jax.tree_util.tree_map(np.asarray, jax_quantize(params))
    return {
        "f32": (params, {}),
        "int8_experts": (q, dict(quantized=True)),
        "int8_fused_qkv": (jax.tree_util.tree_map(np.asarray, jax_fuse(q)), dict(quantized=True, fused_qkv=True)),
        "int8_kv8_fused": (jax.tree_util.tree_map(np.asarray, jax_fuse(q)),
                           dict(quantized=True, fused_qkv=True, quantized_kv=True)),
    }


@pytest.mark.parametrize("form", ["f32", "int8_experts", "int8_fused_qkv", "int8_kv8_fused"])
def test_forward_and_cached_decode_match_jax(params, tokens, form):
    p, kw = _forms(params)[form]
    jm, port = _pair(p, **kw)
    atol = KV8_ATOL if kw.get("quantized_kv") else F32_ATOL
    if not kw.get("quantized_kv"):
        lj, aj, hj, _ = jm.apply(p, jnp.asarray(tokens))
        lp, ap, hp, _ = port(torch.from_numpy(tokens))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=atol, rtol=0)
        np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=atol, rtol=0)
    jcache, pcache = jax_init_cache(jm, 2, 32), init_cache(port, 2, 32, device="cpu")
    calls = [(tokens[:, :20], 0)] + [(tokens[:, 20 + i:21 + i], 20 + i) for i in range(3)]
    for chunk, index in calls:
        lj, _, _, jcache = jm.apply(p, jnp.asarray(chunk), jcache, jnp.int32(index))
        lp, _, _, pcache = port(torch.from_numpy(chunk), pcache, index)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), atol=atol, rtol=0)


def test_quantization_and_fusion_match_jax_exactly(params):
    _, port = _pair(params)
    ours = fuse_quantized_llama_params(quantize_llama_params(port.state_dict()))
    theirs = llama_from_flax(jax_fuse(jax_quantize(params)), device="cpu")
    assert sorted(ours) == sorted(theirs)
    assert "block_0.w_gate_q" in ours and "block_0.router.kernel" in ours and "block_0.gateup.kernel_q" not in ours
    assert tuple(ours["block_0.w_down_scale"].shape) == (4, 64)
    for name, value in ours.items():
        assert value.dtype == theirs[name].dtype and torch.equal(value, theirs[name]), name


def test_cached_decode_equals_the_full_forward(params, tokens):
    _, port = _pair(params)
    full = port(torch.from_numpy(tokens))[0]
    cache = init_cache(port, 2, 24, device="cpu")
    got = [port(torch.from_numpy(tokens[:, :16]), cache, 0)[0]]
    got += [port(torch.from_numpy(tokens[:, i:i + 1]), cache, i)[0] for i in range(16, 24)]
    torch.testing.assert_close(torch.cat(got, dim=1), full, atol=GEN_ATOL, rtol=0)


def test_routing_is_sparse(params, tokens):
    """Only the top-k experts of a token reach it: the weights of an expert
    no token picks do not move the output by a bit."""
    _, port = _pair(params)
    block = port.block_0
    x = torch.randn((1, 5, 64), generator=torch.Generator().manual_seed(0))
    probs = torch.softmax(block.router(x.reshape(5, 64)), dim=-1)
    unused = sorted(set(range(4)) - set(torch.topk(probs, 2, dim=-1).indices.flatten().tolist()))
    want = block._moe_ffn(x)
    for e in unused:
        block.w_down.data[e] = 1e6
    got = block._moe_ffn(x)
    assert unused
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("form", ["f32", "int8_kv8_fused"])
def test_generator_on_an_moe_model(params, form):
    p, kw = _forms(params)[form]
    jm, port = _pair(p, **kw)
    rng = np.random.RandomState(2)
    prompts = [list(rng.randint(1, 128, n)) for n in (20, 20, 13)]
    want = JaxGenerator(jm, p, max_new_tokens=5).generate_batch(prompts)
    for use_scan in (True, False):
        got = TorchGenerator(port, max_new_tokens=5, use_scan=use_scan).generate_batch(prompts)
        np.testing.assert_array_equal(got["sequences"], want["sequences"])
        atol = KV8_ATOL if kw.get("quantized_kv") else GEN_ATOL
        np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=atol, rtol=0)
