"""The port's LlamaLM against runia_core_tpu's, on weights carried by
llama_from_flax.

A small model (2 layers, d_model 64, 4 query and 2 KV heads of 16, vocab
128) and prompts of 130 tokens, so a use_flash model takes the port's flash
route (the kernel's plain version on the CPU) while JAX takes its dense path
off the TPU. Bounds, stated once:

* f32: 5e-5 absolute on logits of order 1-5 (measured about 5e-6): the
  same f32 arithmetic summed in other orders;
* KV8: 5e-3 absolute on the logits (measured about 1e-3): ulp-level
  differences of k and v (RoPE tables, sum order) flip an occasional
  round(x / scale) to the neighbouring int8 step, which moves that cached
  value by max|x| / 127;
* bf16: 0.1 absolute on logits of order 5: the two frameworks round to
  bf16 at other places (the JAX model rounds w * scale, attention sums
  and activations differently), each rounding 2^-9 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.models.llama import LlamaLM as JaxLlamaLM
from runia_core_tpu.models.llama import fuse_quantized_llama_params as jax_fuse
from runia_core_tpu.models.llama import quantize_llama_params as jax_quantize
from runia_core_tpu.models.transformer import init_cache as jax_init_cache
from runia_core_tpu_torch.models import (
    LlamaLM,
    fuse_quantized_llama_params,
    init_cache,
    llama_from_flax,
    quantize_llama_params,
)

torch.set_num_threads(1)

CFG = dict(vocab_size=128, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, hidden_dim=128, max_len=256)
T, CACHE = 130, 140
F32_ATOL, KV8_ATOL, BF16_ATOL = 5e-5, 5e-3, 0.1


def _randomize(tree, rng):
    """Norm scales and biases away from their 1 / 0 initial values, so the
    comparison sees them."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = _randomize(value, rng)
        elif name == "scale" and value.dtype == np.float32 and value.ndim == 1:
            out[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif name == "bias":
            out[name] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        else:
            out[name] = np.asarray(value)
    return out


def _jax_params(seed=0, **kw):
    model = JaxLlamaLM(**CFG, **kw)
    params = model.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))
    return {"params": _randomize(jax.tree_util.tree_map(np.asarray, params)["params"], np.random.RandomState(seed))}


def _pair(params, **kw):
    """(JAX model, port model) of one configuration on the same weights;
    the JAX side never sees use_flash (it runs dense off the TPU anyway)."""
    port = LlamaLM(**CFG, **kw, device="cpu")
    port.load_state_dict(llama_from_flax(params, device="cpu"))
    return JaxLlamaLM(**CFG, **{k: v for k, v in kw.items() if k != "use_flash"}), port


@pytest.fixture(scope="module")
def base():
    return _jax_params()


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(0).randint(0, 128, (2, T)).astype(np.int32)


def _np(x):
    return np.asarray(x, np.float32)


def _run_cached(jm, params, port, tokens, steps=3, chunks=(T,), **port_kw):
    """Prefill ``tokens`` into a cache in the given chunks, then decode
    ``steps`` tokens; yields (jax logits, port logits, jax attn, port attn)
    per call."""
    b = tokens.shape[0]
    jcache, pcache = jax_init_cache(jm, b, CACHE), init_cache(port, b, CACHE, device="cpu")
    rng = np.random.RandomState(1)
    calls, start = [], 0
    for size in chunks:
        calls.append((tokens[:, start:start + size], start, port_kw))
        start += size
    for step in range(steps):
        calls.append((rng.randint(0, 128, (b, 1)).astype(np.int32), start + step, {}))
    for chunk, index, kw in calls:
        lj, aj, _, jcache = jm.apply(params, jnp.asarray(chunk), jcache, jnp.int32(index))
        lp, ap, _, pcache = port(torch.from_numpy(chunk).long(), pcache, index, **kw)
        yield _np(lj), lp.numpy(), _np(aj), None if ap is None else ap.numpy()


def test_full_forward_matches_jax(base, tokens):
    jm, port = _pair(base)
    lj, aj, hj, _ = jm.apply(base, jnp.asarray(tokens))
    lp, ap, hp, _ = port(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(lp.numpy(), _np(lj), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(ap.numpy(), _np(aj), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(hp.numpy(), _np(hj), atol=F32_ATOL, rtol=0)


def test_outputs_not_asked_for_are_not_computed(base, tokens):
    _, port = _pair(base)
    full, _, _, _ = port(torch.from_numpy(tokens).long())
    last, attn, hid, _ = port(torch.from_numpy(tokens).long(), need_attentions=False, need_hiddens=False,
                              last_logits_only=True)
    assert attn is None and hid is None and tuple(last.shape) == (2, 1, 128)
    torch.testing.assert_close(last[:, 0], full[:, -1], atol=1e-6, rtol=0)


def test_prefill_then_decode_on_the_cache(base, tokens):
    jm, port = _pair(base)
    for lj, lp, aj, ap in _run_cached(jm, base, port, tokens):
        np.testing.assert_allclose(lp, lj, atol=F32_ATOL, rtol=0)
        np.testing.assert_allclose(ap, aj, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("chunks", [(T,), (20, 110)], ids=["prefill", "chunked_over_live_cache"])
def test_flash_route_matches_the_jax_dense_path(base, tokens, chunks):
    """use_flash at t >= 128 without attention outputs takes the flash route,
    a prefill into an empty cache and a chunk over a live cache alike."""
    jm, port = _pair(base, use_flash=True)
    for lj, lp, _, _ in _run_cached(jm, base, port, tokens, chunks=chunks, need_attentions=False):
        np.testing.assert_allclose(lp, lj, atol=F32_ATOL, rtol=0)
    lj, _, _, _ = jm.apply(base, jnp.asarray(tokens))  # no cache: flash over the call's own keys
    lp, _, _, _ = port(torch.from_numpy(tokens).long(), need_attentions=False)
    np.testing.assert_allclose(lp.numpy(), _np(lj), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("use_flash", [False, True])
def test_kv8_cache(base, tokens, use_flash):
    jm, port = _pair(base, quantized_kv=True, use_flash=use_flash)
    for lj, lp, _, _ in _run_cached(jm, base, port, tokens, need_attentions=not use_flash):
        np.testing.assert_allclose(lp, lj, atol=KV8_ATOL, rtol=0)


def test_kv8_cache_contents(base, tokens):
    jm, port = _pair(base, quantized_kv=True)
    jcache = jm.apply(base, jnp.asarray(tokens), jax_init_cache(jm, 2, CACHE), jnp.int32(0))[3]
    pcache = port(torch.from_numpy(tokens).long(), init_cache(port, 2, CACHE, device="cpu"), 0)[3]
    for jl, pl in zip(jcache["layers"], pcache["layers"]):
        for name in ("k", "v"):
            diff = np.abs(np.asarray(jl[name], np.int32) - pl[name].numpy().astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        np.testing.assert_allclose(pl["k_scale"].numpy(), _np(jl["k_scale"]), rtol=1e-5, atol=0)


@pytest.mark.parametrize("head_dim", [16, 64])
def test_kv8_codes_differ_from_jax_only_at_rounding_boundaries(tokens, monkeypatch, head_dim):
    """Where a cached KV8 code differs from JAX's, the port's unrounded
    x / scale lies within 2.5e-4 of a half-integer and the two codes are its
    neighbours. The frameworks' k and v agree to about 1e-6 relative (f32
    sums in other orders), which moves a quotient of at most 127 by about
    2.5e-4, so only a value at a rounding boundary can flip; a fault would
    flip codes anywhere. At heads of 64 a few codes of the second layer
    flip, at 16 none."""
    import runia_core_tpu_torch.models.llama as llama

    seen, real = [], llama._quantize_kv
    monkeypatch.setattr(llama, "_quantize_kv", lambda x: seen.append(x.clone()) or real(x))
    cfg = dict(CFG, head_dim=head_dim)
    jm = JaxLlamaLM(**cfg, quantized_kv=True)
    params = jax.tree_util.tree_map(np.asarray, JaxLlamaLM(**cfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    port = LlamaLM(**cfg, quantized_kv=True, device="cpu")
    port.load_state_dict(llama_from_flax(params, device="cpu"))
    jcache = jm.apply(params, jnp.asarray(tokens), jax_init_cache(jm, 2, CACHE), jnp.int32(0))[3]
    with torch.no_grad():
        pcache = port(torch.from_numpy(tokens).long(), init_cache(port, 2, CACHE, device="cpu"), 0)[3]
    flipped = 0
    for layer, (jl, pl) in enumerate(zip(jcache["layers"], pcache["layers"])):
        for j, name in enumerate(("k", "v")):  # the port quantizes k, then v
            quotient = (seen[2 * layer + j].float() / pl[f"{name}_scale"][:, :T, :, None]).numpy()
            jc, pc = np.asarray(jl[name])[:, :T], pl[name][:, :T].numpy()
            flips = jc != pc
            flipped += int(flips.sum())
            q = quotient[flips]
            assert np.all(np.abs(np.abs(q - np.trunc(q)) - 0.5) <= 2.5e-4), q
            assert np.array_equal(np.minimum(jc[flips], pc[flips]), np.floor(q))
            assert np.array_equal(np.maximum(jc[flips], pc[flips]), np.ceil(q))
    assert flipped <= 1e-3 * 4 * 2 * T * CFG["num_kv_heads"] * head_dim


def test_kv8_cache_at_heads_of_64_within_the_one_flip_bound(tokens, monkeypatch):
    """KV8 parity at heads of 64: a 130-token prefill and 3 decode steps.

    The bound, derived: where a cached code differs from JAX's, the port's
    x / scale lies at a rounding boundary (checked below, as in the test
    above) and the two codes are its neighbours, so that cached value moves
    by exactly one step, its scale max|x| / 127. Everything else is the f32
    arithmetic of F32_ATOL. So the logits may differ from JAX's by F32_ATOL
    plus the effect of moving each flipped value by its max|x| / 127, which
    the test computes by running the port again with JAX's codes put in at
    the flips (the port's arithmetic otherwise): that run must agree with
    JAX to F32_ATOL, and the port's own run differs from it by the flips'
    effect alone."""
    import runia_core_tpu_torch.models.llama as llama

    cfg = dict(CFG, head_dim=64)
    params = jax.tree_util.tree_map(np.asarray, JaxLlamaLM(**cfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
    jm = JaxLlamaLM(**cfg, quantized_kv=True)
    port = LlamaLM(**cfg, quantized_kv=True, device="cpu")
    port.load_state_dict(llama_from_flax(params, device="cpu"))
    b, steps = tokens.shape[0], 3
    calls = [(tokens, 0)] + [(np.random.RandomState(1 + s).randint(0, 128, (b, 1)).astype(np.int32), T + s)
                             for s in range(steps)]
    jcache, want, jcodes = jax_init_cache(jm, b, CACHE), [], []
    for chunk, index in calls:
        lj, _, _, jcache = jm.apply(params, jnp.asarray(chunk), jcache, jnp.int32(index))
        want.append(_np(lj))
        for layer in jcache["layers"]:  # the order the port quantizes in: per layer, k then v
            jcodes += [np.array(layer[name])[:, index:index + chunk.shape[1]] for name in ("k", "v")]

    real, seen = llama._quantize_kv, []

    def run(force: bool):
        seen.clear()

        def quantize(x):
            xq, scale = real(x)
            seen.append((x / scale[..., None], xq, scale))
            return (torch.from_numpy(jcodes[len(seen) - 1]), scale) if force else (xq, scale)

        monkeypatch.setattr(llama, "_quantize_kv", quantize)
        cache, out = init_cache(port, b, CACHE, device="cpu"), []
        with torch.no_grad():
            for chunk, index in calls:
                out.append(port(torch.from_numpy(chunk).long(), cache, index)[0].numpy())
        return out

    plain = run(force=False)
    flips = 0
    for (quotient, xq, scale), jc in zip(seen, jcodes):
        moved = xq.numpy() != jc
        flips += int(moved.sum())
        q = quotient.numpy()[moved]
        assert np.all(np.abs(np.abs(q - np.trunc(q)) - 0.5) <= 2.5e-4), q  # at a rounding boundary
        assert np.array_equal(np.abs(xq.numpy()[moved].astype(np.int32) - jc[moved]), np.ones(int(moved.sum())))
    forced = run(force=True)
    assert flips > 0  # heads of 64 flip codes on this prompt (ROADMAP Queue 3)
    for lj, lp, lf in zip(want, plain, forced):
        np.testing.assert_allclose(lf, lj, atol=F32_ATOL, rtol=0)  # JAX's codes: the f32 bound
        np.testing.assert_array_less(np.abs(lp - lj), F32_ATOL + np.abs(lp - lf) + 1e-12)


def test_quantization_matches_jax_exactly(base):
    _, port = _pair(base)
    ours = fuse_quantized_llama_params(quantize_llama_params(port.state_dict()))
    theirs = llama_from_flax(jax_fuse(jax_quantize(base)), device="cpu")
    assert sorted(ours) == sorted(theirs)
    for name, value in ours.items():
        assert value.dtype == theirs[name].dtype and torch.equal(value, theirs[name]), name


@pytest.mark.parametrize("kw", [
    dict(quantized=True),
    dict(quantized=True, fused_qkv=True, use_flash=True),
    dict(quantized=True, quantized_kv=True, fused_qkv=True),
], ids=["int8", "int8_fused_flash", "int8_kv8_fused"])
def test_int8_weights(base, tokens, kw):
    params = jax_quantize(base)
    if kw.get("fused_qkv"):
        params = jax_fuse(params)
    jm, port = _pair(jax.tree_util.tree_map(np.asarray, params), **kw)
    atol = KV8_ATOL if kw.get("quantized_kv") else F32_ATOL
    for lj, lp, _, _ in _run_cached(jm, params, port, tokens, need_attentions=not kw.get("use_flash")):
        np.testing.assert_allclose(lp, lj, atol=atol, rtol=0)


def test_attn_bias(tokens):
    params = _jax_params(seed=2, attn_bias=True)
    jm, port = _pair(params, attn_bias=True, use_flash=True)
    for lj, lp, _, _ in _run_cached(jm, params, port, tokens, need_attentions=False):
        np.testing.assert_allclose(lp, lj, atol=F32_ATOL, rtol=0)


def test_gemma_deltas_tied_embeddings_embed_scale_geglu(tokens):
    kw = dict(tie_embeddings=True, embed_scale=True, mlp_act="gelu_tanh")
    params = _jax_params(seed=3, **kw)
    jm, port = _pair(params, **kw)
    for lj, lp, aj, ap in _run_cached(jm, params, port, tokens, steps=2):
        np.testing.assert_allclose(lp, lj, atol=F32_ATOL * 10, rtol=0)  # logits of order 50 (embed_scale)


def test_sliding_window(base, tokens):
    jm, port = _pair(base, sliding_window=16)
    lj = jm.apply(base, jnp.asarray(tokens))[0]
    np.testing.assert_allclose(port(torch.from_numpy(tokens).long())[0].numpy(), _np(lj), atol=F32_ATOL, rtol=0)
    for lj, lp, aj, ap in _run_cached(jm, base, port, tokens, steps=2):
        np.testing.assert_allclose(lp, lj, atol=F32_ATOL, rtol=0)


def test_per_row_cache_index(base, tokens):
    """A (B,) cache_index writes and attends each row at its own offset."""
    jm, port = _pair(base)
    idx = np.asarray([3, 9], np.int32)
    jcache, pcache = jax_init_cache(jm, 2, 32), init_cache(port, 2, 32, device="cpu")
    chunk = tokens[:, :4]
    lj, aj, _, jcache = jm.apply(base, jnp.asarray(chunk), jcache, jnp.asarray(idx))
    lp, ap, _, pcache = port(torch.from_numpy(chunk).long(), pcache, torch.from_numpy(idx))
    np.testing.assert_allclose(lp.numpy(), _np(lj), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(pcache["layers"][1]["k"].numpy(), _np(jcache["layers"][1]["k"]), atol=F32_ATOL, rtol=0)


def test_bf16_model(base, tokens):
    def store(path, leaf):  # kernels and the embedding in bf16, norms f32
        name = path[-1].key
        return np.asarray(jnp.asarray(leaf, jnp.bfloat16)) if name in ("kernel", "embedding") else leaf

    bf16 = {"params": jax.tree_util.tree_map_with_path(store, base["params"])}
    jm = JaxLlamaLM(**CFG, dtype=jnp.bfloat16)
    port = LlamaLM(**CFG, dtype=torch.bfloat16, use_flash=True, device="cpu")
    port.load_state_dict(llama_from_flax(bf16, device="cpu"))
    assert port.block_0.q.kernel.dtype == torch.bfloat16
    for lj, lp, _, _ in _run_cached(jm, bf16, port, tokens, need_attentions=False):
        assert lp.dtype == np.float32
        np.testing.assert_allclose(lp, lj, atol=BF16_ATOL, rtol=0)


def test_moe_is_not_ported_yet():
    """An MoE configuration builds its router and expert stacks, in the
    float and the int8 form (tests/test_torch_moe.py holds them against
    JAX). The name dates from when the port refused MoE configurations; it
    is kept so that the test's history stays one line."""
    block = LlamaLM(**CFG, num_experts=4, device="cpu").block_0
    assert tuple(block.router.kernel.shape) == (64, 4) and tuple(block.w_down.shape) == (4, 128, 64)
    assert not hasattr(block, "gate") and not hasattr(block, "down")
    block = LlamaLM(**CFG, num_experts=4, quantized=True, fused_qkv=True, device="cpu").block_0
    assert block.w_gate_q.dtype == torch.int8 and tuple(block.w_gate_scale.shape) == (4, 128)
    assert hasattr(block, "qkv") and not hasattr(block, "gateup")


# Combinations checked against the JAX dense path by hand before they were
# tests: (id, model configuration, prefill chunks, a left-padded row).
_CHECKED = [
    ("window_flash", dict(sliding_window=16, use_flash=True), (T,), False),
    ("window_flash_chunked", dict(sliding_window=16, use_flash=True), (20, 110), False),
    ("window_flash_kv8", dict(sliding_window=16, use_flash=True, quantized_kv=True), (20, 110), False),
    ("window_wider_than_prompt", dict(sliding_window=200, use_flash=True), (T,), False),
    ("chunks_128_2", dict(use_flash=True), (128, 2), False),
    ("chunks_1_129", dict(use_flash=True), (1, 129), False),
    ("head_dim_32", dict(head_dim=32, rope_theta=5e5, rms_eps=1e-5), (T,), False),
    ("kv_heads_1", dict(num_kv_heads=1), (T,), False),
    ("kv_heads_4", dict(num_kv_heads=4), (T,), False),
    ("left_padded", dict(), (T,), True),
    ("left_padded_window", dict(sliding_window=16), (T,), True),
    ("left_padded_flash", dict(use_flash=True), (T,), True),
    ("left_padded_kv8", dict(quantized_kv=True), (T,), True),
]


@pytest.mark.parametrize("kw,chunks,left_padded", [case[1:] for case in _CHECKED], ids=[case[0] for case in _CHECKED])
def test_checked_combinations(tokens, kw, chunks, left_padded):
    """Prefill in ``chunks`` (the flash route where the configuration and a
    chunk of 128 or more allow it), then three decode steps; with a
    left-padded row, ``token_valid`` and ``positions`` in every call, as
    ``generate_batch`` passes them."""
    cfg = {**CFG, **{k: v for k, v in kw.items() if k != "use_flash"}}
    jm = JaxLlamaLM(**cfg)
    params = jm.init(jax.random.key(4), jnp.zeros((1, 8), jnp.int32))
    params = {"params": _randomize(jax.tree_util.tree_map(np.asarray, params)["params"], np.random.RandomState(4))}
    port = LlamaLM(**cfg, use_flash=kw.get("use_flash", False), device="cpu")
    port.load_state_dict(llama_from_flax(params, device="cpu"))
    atol = KV8_ATOL if kw.get("quantized_kv") else F32_ATOL
    b, steps = tokens.shape[0], 3
    valid = np.ones((b, CACHE), bool)
    if left_padded:
        valid[1, :10] = False
    positions = np.maximum(np.cumsum(valid, axis=1) - 1, 0)
    jcache, pcache = jax_init_cache(jm, b, CACHE), init_cache(port, b, CACHE, device="cpu")
    rng = np.random.RandomState(1)
    calls, start = [], 0
    for size in chunks:
        calls.append((tokens[:, start:start + size], start))
        start += size
    calls += [(rng.randint(0, 128, (b, 1)).astype(np.int32), start + i) for i in range(steps)]
    for chunk, index in calls:
        extra_j, extra_p = {}, {}
        if left_padded:
            here = positions[:, index:index + chunk.shape[1]]
            extra_j = dict(token_valid=jnp.asarray(valid), positions=jnp.asarray(here))
            extra_p = dict(token_valid=torch.from_numpy(valid), positions=torch.from_numpy(here))
        lj = jm.apply(params, jnp.asarray(chunk), jcache, jnp.int32(index), **extra_j)
        lp = port(torch.from_numpy(chunk).long(), pcache, index, **extra_p, need_attentions=False)
        jcache = lj[3]
        np.testing.assert_allclose(lp[0].numpy(), _np(lj[0]), atol=atol, rtol=0)


def test_use_flash_on_a_gpu_takes_only_the_kernels_head_sizes():
    """A use_flash model made on a GPU with heads the flash kernel is not
    built for raises before any allocation; on the CPU (the kernel's plain
    version) any size is taken."""
    with pytest.raises(ValueError, match="heads of"):
        LlamaLM(**CFG, head_dim=80, use_flash=True, device="cuda")
    LlamaLM(**CFG, head_dim=80, use_flash=True, device="cpu")
