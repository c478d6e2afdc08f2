"""Mellum 2 (window and full attention mixed with YaRN, routed experts) on
the port, against the benchmark's plain reference
(``portbench/reference/mellum.py``, imported, not copied).

CPU, f32, small widths: one whole period of the layer pattern (three
windowed layers and a full one), a window of 16 under prompts of up to 60
tokens, a YaRN ramp that is not trivial, 8 experts of which each token
takes 4. Bounds: 1e-4 absolute on logits of order 1 where the port and the
reference run the same f32 arithmetic in another order (and the routed
experts sum another way than the dense loop). The CUDA-gated tests at the
end hold the windowed kernel 4 and the grouped expert kernel to their plain
twins on the card, at the cell's shapes.
"""

import copy
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.families import mellum as family
from portbench.reference import mellum as ref
from runia_core_tpu_torch.llm.serve_uncertainty import UncertaintyServer
from runia_core_tpu_torch.models import init_cache
from runia_core_tpu_torch.models.llama import LlamaLM, _rope_cos_sin
from runia_core_tpu_torch.ops.flash_prefill import flash_prefix_attention, reference_prefix_attention
from runia_core_tpu_torch.ops.moe_grouped import moe_grouped, reference_moe_grouped, routed_experts
from runia_core_tpu_torch.utils.profiling import recording

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PUBLISHED = json.loads((ROOT / "portbench" / "configs" / "mellum2_12b_a2.5b.json").read_text())
SEED = 2**33 + 5
ATOL = 1e-4
METHODS = [{"method_name": "perplexity"}, {"method_name": "generation_entropy"},
           {"method_name": "RAUQ", "token_aggregation": "original", "head_aggregation": "original", "alphas": [0.3]}]


def small_cfg(**over):
    """The published configuration at CPU widths: one period, window 16,
    YaRN over 32 original positions at theta 1e4 (correction dimensions 2
    and 5 of the 8 frequencies)."""
    cfg = copy.deepcopy(PUBLISHED)
    cfg.update(hidden_size=64, head_dim=16, num_attention_heads=4, num_key_value_heads=2, moe_intermediate_size=32,
               num_experts=8, num_experts_per_tok=4, num_hidden_layers=4, vocab_size=128, sliding_window=16,
               dtype="float32", layer_types=PUBLISHED["layer_types"][:4], mlp_layer_types=["sparse"] * 4)
    cfg["rope_parameters"]["full_attention"].update(rope_theta=1e4, original_max_position_embeddings=32, factor=4)
    cfg["rope_parameters"]["sliding_attention"].update(rope_theta=1e4)
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def cfg():
    return small_cfg()


@pytest.fixture(scope="module")
def model(cfg):
    return family.build_model(cfg, SEED, "cpu", use_flash=True)


def tokens(n, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 128, (n,)))


def test_yarn_frequencies_and_scale_at_the_published_values():
    """The full layers' YaRN at the published values (theta 5e5, factor 16
    over 8,192, betas 32 and 1, head 128): the ramp runs from frequency 18 to
    35 of 64, below it the frequencies are theta^(-2i/128), above them
    divided by 16; cos and sin carry the attention factor 1.2772588722."""
    spec = PUBLISHED["rope_parameters"]["full_attention"]
    d, theta = 128, 5e5
    base = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ramp = ((torch.arange(64, dtype=torch.float64) - 18) / (35 - 18)).clamp(0, 1)
    want = base / 16 * ramp + base * (1 - ramp)
    positions = torch.arange(1, 3)[None, :].expand(1, 2)
    cos, sin = _rope_cos_sin(positions, d, theta, spec)
    plain_cos, _ = _rope_cos_sin(positions, d, theta)
    angles = torch.atan2(sin[0, 0, :64] / spec["attention_factor"], cos[0, 0, :64] / spec["attention_factor"])
    np.testing.assert_allclose(angles.numpy(), want.numpy(), rtol=2e-6)
    assert float(cos[0, 0].square().add(sin[0, 0].square()).sqrt().mean()) == pytest.approx(1.2772588722239782, 1e-6)
    np.testing.assert_allclose(angles[:18].numpy(), base[:18].numpy(), rtol=2e-6)  # below the ramp: as plain RoPE
    np.testing.assert_allclose(angles[35:].numpy(), base[35:].numpy() / 16, rtol=2e-6)  # above it: a sixteenth
    assert not torch.allclose(cos, plain_cos)
    freqs, scale = ref.inv_freq(PUBLISHED, "full_attention")
    np.testing.assert_allclose(freqs.numpy(), want.numpy(), rtol=2e-6)
    assert scale == pytest.approx(1.2772588722239782)


def test_full_forward_logits_match_the_reference(cfg, model):
    seq = tokens(60)
    got = model(seq[None], need_attentions=False, need_hiddens=False)[0][0]
    torch.testing.assert_close(got, ref.logits(cfg, SEED, seq, "cpu"), atol=ATOL, rtol=0)


def test_prefill_then_decode_through_the_cache_match_the_full_forward(cfg, model):
    """Chunks of 20 and 16 (the flash route's twin below 128 tokens is the
    dense path; chunks of 128 take it), then decode steps past the window."""
    seq = tokens(150, seed=1)
    want = ref.logits(cfg, SEED, seq, "cpu")
    cache = init_cache(model, 1, 160, device="cpu")
    got, start = [], 0
    for size in (20, 16, 128):
        chunk = seq[start:start + size][None]
        got.append(model(chunk, cache, start, need_attentions=False, need_hiddens=False)[0][0])
        start += size
    for i in range(start, 150):
        got.append(model(seq[i:i + 1][None], cache, i, need_attentions=False, need_hiddens=False)[0][0])
    torch.testing.assert_close(torch.cat(got), want, atol=ATOL, rtol=0)


def _server(model, **engine):
    kw = dict(num_slots=3, prefill_chunk=16, max_ctx=80, prefill_lanes=2, chunk_tokens=4, defer_fetch=False)
    kw.update(engine)
    return UncertaintyServer(model, None, METHODS, max_new_tokens=8, engine_kwargs=kw)


def test_chunked_prefill_and_decode_through_the_engine_match_the_reference(cfg, model):
    """Greedy tokens, harvested log-probs, entropies and the three scores
    through UncertaintyServer -> ContinuousBatchingEngine, against the
    reference's teacher-forced run of the same tokens."""
    server = _server(model)
    prompts = [tokens(n, seed=n).tolist() for n in (20, 45, 60, 33)]
    ids = [server.submit(p) for p in prompts]
    streamed = dict(server.stream())
    got = [server.completion(i) for i in ids]
    want = ref.teacher_forced(cfg, SEED, prompts, [g["tokens"] for g in got], "cpu")
    for g, w, rid in zip(got, want, ids):
        assert g["tokens"] == w["argmax"].tolist()
        np.testing.assert_allclose(g["log_probs"], w["log_prob"].numpy(), atol=ATOL)
        np.testing.assert_allclose(g["entropies"], w["entropy"].numpy(), atol=ATOL)
        for name, value in ref.scores(w, 0.3).items():
            assert streamed[rid][name] == pytest.approx(value, rel=1e-4), name


def test_stream_and_serve_give_equal_scores(model):
    """Submitted whole and streamed, a batch's scores are serve's bit for
    bit; submitted one by one as earlier ones finish (a closed loop), each
    shares its decode steps and lanes with other requests, whose rows round
    the f32 products another way: equal within 1e-5."""
    prompts = [tokens(n, seed=n + 100).tolist() for n in (25, 50, 17, 60, 40)]
    texts, served = _server(model).serve(prompts)
    server = _server(model)
    ids = [server.submit(p) for p in prompts]
    streamed = dict(server.stream())
    assert [streamed[i] for i in ids] == served
    assert [server.completion(i)["tokens"] for i in ids] == texts
    ids = [server.submit(p) for p in prompts[:2]]
    streamed = {}
    for rid, scores in server.stream():
        streamed[rid] = scores
        if len(ids) < len(prompts):
            ids.append(server.submit(prompts[len(ids)]))
    for rid, want in zip(ids, served):
        assert streamed[rid] == pytest.approx(want, rel=1e-5)
    assert [server.completion(i)["tokens"] for i in ids] == texts


def test_a_recording_holds_the_serving_spans_and_the_new_counters(model):
    server = _server(model)
    with recording() as rec:
        server.serve([tokens(30).tolist(), tokens(50, seed=3).tolist()])
    names = {s.name for s in rec.spans}
    assert {"runia.engine.refill", "runia.engine.prefill", "runia.engine.decode", "runia.engine.harvest",
            "runia.uncertainty.score"} <= names
    assert {s.batch for s in rec.spans if s.name == "runia.engine.prefill"} <= {1, 2}
    assert {"moe_grouped.launches", "flash_prefix_attention.launches",
            "flash_prefix_attention.window_launches"} <= set(rec.counters)


def test_windowed_prefix_attention_equals_the_dense_masked_path():
    """The twin's window against the model's dense path with the window in
    its mask, over a live cache (q_start 40, kv_start 5) and a fresh prefill."""
    gen = torch.Generator().manual_seed(0)
    b, hq, g, tq, kk, d, window = 2, 4, 2, 24, 80, 16, 10
    q = torch.randn((b, hq, tq, d), generator=gen)
    k, v = (torch.randn((b, g, kk, d), generator=gen) for _ in range(2))
    q_start = torch.tensor([40, 0], dtype=torch.int32)
    kv_start = torch.tensor([5, 0], dtype=torch.int32)
    got = reference_prefix_attention(q, k, v, q_start, kv_start, None, None, None, window)
    block = LlamaLM(vocab_size=16, num_layers=1, num_heads=hq, num_kv_heads=g, d_model=hq * d, head_dim=d,
                    device="cpu").block_0
    rows = q_start.long()[:, None] + torch.arange(tq)
    keys = torch.arange(kk)
    mask = ((keys <= rows[..., None]) & (keys >= kv_start.long()[:, None, None])
            & (rows[..., None] - keys < window))[:, None]
    dense, _ = block._dense_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None, mask)
    torch.testing.assert_close(got.transpose(1, 2).reshape(b, tq, hq * d), dense, atol=1e-5, rtol=0)


def _dense_loop(x, top_i, top_w, w_gate, w_up, w_down):
    """Every expert on every token, the unpicked ones weighed 0: the loop the
    routed experts replace."""
    gates = torch.zeros((x.shape[0], w_gate.shape[0])).scatter_(1, top_i, top_w)
    out = torch.zeros((x.shape[0], w_down.shape[2]))
    for e in range(w_gate.shape[0]):
        out += (torch.nn.functional.silu(x @ w_gate[e]) * (x @ w_up[e])) @ w_down[e] * gates[:, e, None]
    return out


@pytest.mark.parametrize("case,t,k,e", [
    *(pytest.param(case, 40, 3, 8, id=case) for case in ("random", "an_expert_with_no_token", "all_tokens_on_one_expert")),
    # the routing shapes of the card's calls: Mellum's decode step and one to four 512-token lanes (8 of 64 experts),
    # Mixtral's decode steps and prefill (2 of 8)
    *(pytest.param("random", t, k, e, id=f"{t}x{k}of{e}") for t, k, e in [
        (8, 8, 64), (15, 8, 64), (16, 8, 64), (512, 8, 64), (1024, 8, 64), (1536, 8, 64), (2048, 8, 64), (4, 2, 8),
        (16, 2, 8), (2048, 2, 8)])])
def test_the_routed_twin_matches_the_dense_loop(case, t, k, e):
    gen = torch.Generator().manual_seed(1)
    d, width = 32, 24
    x = torch.randn((t, d), generator=gen)
    w_gate, w_up = (torch.randn((e, d, width), generator=gen) / d**0.5 for _ in range(2))
    w_down = torch.randn((e, width, d), generator=gen) / width**0.5
    logits = torch.randn((t, e), generator=gen)
    if case == "an_expert_with_no_token":
        logits[:, 5] = -1e9
    elif case == "all_tokens_on_one_expert":
        logits[:, 2] = 1e9
    top_v, top_i = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    top_w = top_v / top_v.sum(-1, keepdim=True)
    got = routed_experts(x, top_i, top_w, w_gate, w_up, w_down)
    torch.testing.assert_close(got, _dense_loop(x, top_i, top_w, w_gate, w_up, w_down), atol=1e-5, rtol=0)


def test_the_parameter_count_at_published_widths():
    model = LlamaLM(**family.model_kwargs(PUBLISHED), device="meta")
    count = sum(p.numel() for p in model.parameters())
    assert count == ref.parameter_count(PUBLISHED) == PUBLISHED["parameters"] == 12_149_915_904
    assert model.layer_types.count("full") == 7 and model.layer_types[3::4] == ["full"] * 7


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def bf16_within(got, want, q, k, v, q_start, window, ks=None, vs=None):
    """The per-element bf16 bound of ``test_torch_cuda_kernels.flash_bf16_within``
    (each probability rounded to bf16 before P.V; one ulp of each output),
    with the window in the mask."""
    b, hq, tq, d = q.shape
    g, kk = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if ks is not None:
        kf, vf = kf * ks.permute(0, 2, 1)[..., None], vf * vs.permute(0, 2, 1)[..., None]
    logits = torch.einsum("bgrtd,bgkd->bgrtk", q.float().reshape(b, g, hq // g, tq, d), kf) / d**0.5
    rows = q_start.long()[:, None, None] + torch.arange(tq, device=q.device)[:, None]
    keys = torch.arange(kk, device=q.device)
    mask = (keys <= rows) & ((rows - keys < window) if window else True)
    probs = torch.softmax(logits.masked_fill(~mask[:, None, None], float("-inf")), dim=-1).nan_to_num(0.0)
    spread = torch.einsum("bgrtk,bgkd->bgrtd", probs.square(), vf.square()).sqrt().reshape(b, hq, tq, d)
    return bool(((got.float() - want.float()).abs() <= 2.0**-7 * want.float().abs() + 2.0**-6 * spread).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("window,kv8", [(1024, False), (1024, True), (0, False), (100, False)])
def test_windowed_kernel_4_matches_its_twin_at_the_cell_s_lanes(card, window, kv8):
    """4 lanes of 512 queries at q_start 0 / 512 / 4,096 / 11,776 over the
    12,800-slot cache (transposed views, as the model passes them), 32 / 4
    heads of 128."""
    b, hq, g, tq, kk, d = 4, 32, 4, 512, 12800, 128
    q = torch.randn((b, hq, tq, d), generator=card, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, kk, g, d), generator=card, device="cuda").to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    ks = vs = None
    if kv8:
        k, ks = (k.float() * 40).round().clamp(-127, 127).to(torch.int8), torch.rand((b, kk, g), generator=card, device="cuda") / 40
        v, vs = (v.float() * 40).round().clamp(-127, 127).to(torch.int8), torch.rand((b, kk, g), generator=card, device="cuda") / 40
    q_start = torch.tensor([0, 512, 4096, 11776], dtype=torch.int32, device="cuda")
    before = (flash_prefix_attention.launches, flash_prefix_attention.window_launches)
    got = flash_prefix_attention(q, k, v, q_start, None, ks, vs, window=window)
    again = flash_prefix_attention(q, k, v, q_start, None, ks, vs, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert flash_prefix_attention.launches == before[0] + 2
    assert flash_prefix_attention.window_launches == before[1] + (2 if window else 0)
    for row in range(b):  # the twin row by row: its logits take (Hq, Tq, K) f32
        sl = slice(row, row + 1)
        want = reference_prefix_attention(q[sl], k[sl], v[sl], q_start[sl], None, None,
                                          None if ks is None else ks[sl], None if vs is None else vs[sl], window)
        assert bf16_within(got[sl], want, q[sl], k[sl], v[sl], q_start[sl], window,
                           None if ks is None else ks[sl], None if vs is None else vs[sl]), row


def _sorted_pairs(top_i, e):
    k = top_i.shape[1]
    flat = top_i.reshape(-1)
    counts = torch.bincount(flat, minlength=e)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32)
    tok = (torch.argsort(flat, stable=True) // k).to(torch.int32)
    return tok, offsets


# (top k, experts, d, I) of each grouped-kernel case: the cell's widths, and Mixtral's (8 experts of 14,336 over
# 4,096, top 2), whose 2,048-token prefill runs the kernels at other widths.
MELLUM_EXPERTS = (8, 64, 2304, 896)
MIXTRAL_EXPERTS = (2, 8, 4096, 14336)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tokens_,case,widths", [
    pytest.param(t, case, widths, id=f"{t}-{case}") for t, case, widths in [
        (8, "random", MELLUM_EXPERTS), (512, "random", MELLUM_EXPERTS), (1024, "random", MELLUM_EXPERTS),
        (1536, "random", MELLUM_EXPERTS), (2048, "random", MELLUM_EXPERTS),
        (2048, "an_expert_with_no_token", MELLUM_EXPERTS), (300, "all_tokens_on_one_expert", MELLUM_EXPERTS),
        (1100, "all_tokens_on_one_expert", MELLUM_EXPERTS), (512, "experts_of_1_63_65_127_129_rows", MELLUM_EXPERTS),
        (2048, "mixtral", MIXTRAL_EXPERTS)]])
def test_grouped_expert_kernel_matches_its_twin_at_the_cell_s_widths(card, tokens_, case, widths):
    """Mellum's 64 experts of 896 over d = 2304, top 8: a decode step's 8
    tokens, one to four prefill lanes' 512-2,048, one expert with every
    token, experts of 1, 63, 65, 127 and 129 rows (either side of the
    kernels' 64-row warpgroups and 128-row tiles; the other 59 experts 64
    rows each); and a Mixtral prefill. Bound: 2e-2 of the output's RMS; the
    kernels and the twin round the same f32 hidden products to bf16, and a
    product summed in another order rounds to a neighbouring bf16 value now
    and then."""
    k, e, d, width = widths
    x = torch.randn((tokens_, d), generator=card, device="cuda").to(torch.bfloat16)
    w_gate, w_up = ((torch.randn((e, d, width), generator=card, device="cuda") / d**0.5).to(torch.bfloat16)
                    for _ in range(2))
    w_down = (torch.randn((e, width, d), generator=card, device="cuda") / width**0.5).to(torch.bfloat16)
    if case == "experts_of_1_63_65_127_129_rows":
        counts = torch.tensor([1, 63, 65, 127, 129] + [64] * (e - 5))
        offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(torch.int32).cuda()
        tok = torch.randint(0, tokens_, (int(counts.sum()),), generator=card, device="cuda").to(torch.int32)
    else:
        logits = torch.randn((tokens_, e), generator=card, device="cuda")
        if case == "an_expert_with_no_token":
            logits[:, 5] = -1e9
        elif case == "all_tokens_on_one_expert":
            logits[:, 2] = 1e9
        tok, offsets = _sorted_pairs(torch.topk(logits, k, dim=-1).indices, e)
    before = moe_grouped.launches
    got = moe_grouped(x, tok, offsets, w_gate, w_up, w_down)
    torch.cuda.synchronize()
    assert moe_grouped.launches == before + 1
    want = reference_moe_grouped(x, tok, offsets, w_gate, w_up, w_down)
    assert float((got - want).abs().max()) <= 2e-2 * float(want.square().mean().sqrt())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("t", [8, 2048])
def test_routed_experts_replay_deterministically(card, t):
    """The routing, the grouped kernels and the combine captured in one CUDA
    graph, at a decode step and at four lanes: replays give the same bits,
    and the work counters rise by the pairs and the touched experts each
    replay."""
    from runia_core_tpu_torch.utils.graphs import CudaGraph

    e, k, d, width = 64, 8, 2304, 896
    x = torch.randn((t, d), generator=card, device="cuda").to(torch.bfloat16)
    w_gate, w_up = ((torch.randn((e, d, width), generator=card, device="cuda") / d**0.5).to(torch.bfloat16)
                    for _ in range(2))
    w_down = (torch.randn((e, width, d), generator=card, device="cuda") / width**0.5).to(torch.bfloat16)
    top_v, top_i = torch.topk(torch.softmax(torch.randn((t, e), generator=card, device="cuda"), -1), k, dim=-1)
    top_w = top_v / top_v.sum(-1, keepdim=True)
    out = torch.zeros((t, d), device="cuda")
    graph = CudaGraph(lambda: out.copy_(routed_experts(x, top_i, top_w, w_gate, w_up, w_down)), device="cuda",
                      warmup=1)
    results, work = [], []
    for _ in range(3):
        before = moe_grouped.work[x.device].clone()
        graph.replay()
        torch.cuda.synchronize()
        results.append(out.clone())
        work.append((moe_grouped.work[x.device] - before).tolist())
    assert all(torch.equal(results[0], r) for r in results[1:])
    assert work == [[t * k, len(set(top_i.flatten().tolist()))]] * 3
    want = torch.zeros((t, d), device="cuda")
    tok, offsets = _sorted_pairs(top_i, e)
    rows = reference_moe_grouped(x, tok, offsets, w_gate, w_up, w_down)
    pos = torch.argsort(torch.argsort(top_i.reshape(-1), stable=True))
    for j in range(k):  # the combine by hand, from the twin
        want += rows[pos].view(t, k, d)[:, j] * top_w[:, j, None]
    assert float((results[0] - want).abs().max()) <= 2e-2 * float(want.square().mean().sqrt())
    assert math.isfinite(float(results[0].abs().max()))
