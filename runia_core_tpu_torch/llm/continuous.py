"""Continuous (in-flight) batching: a fixed set of decode slots kept busy.

Counterpart of ``runia_core_tpu/llm/continuous.py``. A static batch makes
late arrivals wait for the whole batch, and finished rows idle until the
longest one ends. :class:`ContinuousBatchingEngine` keeps ``num_slots``
decode slots hot instead: every decode step emits one token for every slot,
and a slot whose request finishes (EOS or its token budget) is refilled from
the queue by prefilling the next prompt into that slot's row of the shared
KV cache (the Orca / vLLM scheduling model).

* One (S, max_ctx) KV cache; each slot writes at its own offset through the
  model's per-row cache path (a (S,) device ``cache_index``), so a refill
  moves no other slot's cache.
* Decode runs in **chunks** of ``chunk_tokens`` steps between host reads of
  the results: a finished slot idles at most chunk - 1 steps before the host
  sees it and refills it.
* Prefill is bucketed (``prompt_bucket``; whole prompts, left-padded, up to
  ``_BATCH_F`` same-bucket prompts in one forward) or, with
  ``prefill_chunk=C``, **chunked**: prompts advance C tokens at a time
  between decode chunks, up to ``prefill_lanes`` slots in one (W, C)
  forward, so admitting a long prompt stalls the decodes by one chunk.
  Chunks of 128 tokens or more on a ``use_flash`` model attend through
  kernel 4 (``ops/flash_prefill.py``, per-row ``q_start``, its KV8 variant
  over an int8 cache); an int8 model's projections run through kernel 3
  (``ops/quant_matmul.py``) in both.
* ``prefix_cache=True`` (chunked only): an admission that shares a
  chunk-aligned prompt prefix with a resident slot copies that slot's cache
  row and prefills only the suffix.
* The scheduling state lives on the host (numpy mirrors) and, packed as one
  (5 S,) int32 tensor, on the device, where every program edits it in place.

**Programs.** The JAX package compiles each of its programs once per
configuration and shares them across engines through a module-level LRU of
96 (one XLA compile costs 30-60 s on a TPU). A CUDA graph is bound to the
tensors it read, and the engine's cache is one of them, so here **each
engine owns its programs and their static buffers**, and no two live engines
share a cache. On a CUDA device with ``use_graph=True`` (the default) the
decode chunk (all K steps, one graph) and the chunked-prefill program of
every lane count W <= ``prefill_lanes`` are captured once, when the engine
is built, while every buffer is still zero (the warm-up's writes are then
cleared), and replayed. The bucketed prefill has one program per (F rows,
p_pad bucket) shape, as in JAX (F is 1 or ``_BATCH_F``, so at most 2 max_ctx
/ prompt_bucket of them), captured at its first call: the capture's warm-up
is that call. A capture costs a fraction of a second. ``use_graph=False``,
and any CPU engine, runs the same program bodies eagerly. The chunk and lane
programs take their cache offsets as (W,) device tensors, never a Python
scalar, so nothing in them reads a value back to the host.

**Harvests.** A decode chunk writes its per-step tokens, log-probs,
entropies, emission flags and the final active flags into one f32 buffer
(token ids are exact below 2^24), plus the RAUQ attention column
(``collect_rauq``) and the final-token hidden vectors (``collect_hidden``).
A replay overwrites those buffers, so every dispatch enqueues a
non-blocking copy of them into pinned host buffers of its own and records
an event; the host waits on that event (``utils.graphs.host_sync``) when it
processes the chunk. The lookahead drain (:meth:`ContinuousBatchingEngine.
stream`) dispatches chunk k+1 before it reads chunk k, so it keeps two such
buffers in turn. The open-loop drain (``defer_fetch=True``) reads nothing
until the drain ends; its harvests already sit in host memory, so the
device memory it holds does not grow with the number of chunks (the JAX
engine keeps every harvest on the device until the end).

**The owner-rewrite invariant.** Rows past a prompt, or of a finished
request, may hold stale or garbage K/V (a decode step writes for every slot,
active or not; a prefix copy brings the donor's whole row). That is legal
because each row's owner rewrites it before anything attends it; the engine
keeps every write position of the JAX engine (parked clocks) for that.

**Spans** (``utils.profiling.span``, free when no recording or profiler is
on): ``runia.engine.refill`` (an admission pass), ``runia.engine.prefill``
(a lane program call, ``batch`` = its lanes), ``runia.engine.decode`` (a
decode chunk's dispatch) and ``runia.engine.harvest`` (the wait for a
chunk's harvest and the host bookkeeping after it, in the pipelined drain).

**Speculative rounds** (``draft_model=``): a draft model proposes ``gamma``
tokens per slot on its own cache, one (S, gamma + 1) target forward
verifies them, and each slot advances by its own acceptance on the vector
clocks (:func:`_spec_round`, shared by the interactive chunk and the fused
drain, as JAX shares ``_make_spec_round``). The correction is deferred
through ``step_logits`` (greedy) or the per-slot residual distribution
``samp_logp`` (sampled, exact Leviathan rejection sampling). The decode
chunk of such an engine is ``chunk_tokens // (gamma + 1)`` rounds, one CUDA
graph captured at construction; every lane program carries the draft's leg.
``spec_min_acceptance`` turns speculation off at a drain boundary once the
measured acceptance sits below it; the plain decode chunk and draft-free
lane programs are captured then.

**The fused offline drain** (:meth:`ContinuousBatchingEngine.
generate_all_fused`): JAX runs the whole scheduler as one ``lax.while_loop``.
Here the scheduler state (slot assignments, prefill progress, clocks, the
device queue head, the (R, M) output buffers) lives in static buffers of one
:class:`_FusedDrain` per (R, P_pad, M, lanes) shape, and two programs, a
prefill iteration and a decode iteration, each end with the refill and a
2-int flag (any pending prefill, done); the host copies the flag behind an
event and chooses the next program from it. JAX's dropped scatters
(``mode="drop"``) aim at spare rows and columns here.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from runia_core_tpu_torch.llm.generate import sample_logits
from runia_core_tpu_torch.models.transformer import init_cache
from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, copy_to_host, drawing_from, host_sync, upload
from runia_core_tpu_torch.utils.profiling import span

__all__ = ["ContinuousBatchingEngine", "speculative_breakeven"]

_FUSED_PROGRAMS = 4  # fused-drain shapes an engine keeps (each holds two programs and its buffers)


def _vocab_norm_entropy(log_soft: torch.Tensor) -> torch.Tensor:
    """Vocab-normalised entropy over the last axis, the per-token term of
    ``llm.scores.generation_entropy``. The isneginf guard keeps masked
    (-inf) logits from making 0 * -inf = nan."""
    terms = torch.exp(log_soft) * torch.where(torch.isneginf(log_soft), torch.zeros_like(log_soft), log_soft)
    return -terms.sum(-1) / float(np.log(log_soft.shape[-1]))


def _pack_harvest(toks, lps, ents, emitted, active, extra=None) -> torch.Tensor:
    """Every host-bound output of a chunk as ONE f32 buffer, so the host
    reads one copy a chunk. Token ids ride as f32, exact below 2**24;
    ``extra`` appends a trailer of counters."""
    parts = [toks, lps, ents, emitted, active] + ([] if extra is None else [extra])
    return torch.cat([t.to(torch.float32).reshape(-1) for t in parts])


def _unpack_harvest(packed: np.ndarray, shape, num_slots, n_extra=0):
    """Invert :func:`_pack_harvest` on the host: (toks, lps, ents, emitted,
    active, extra) with ``toks/lps/ents/emitted`` of ``shape``."""
    n = int(np.prod(shape))
    sec = [packed[i * n:(i + 1) * n].reshape(shape) for i in range(4)]
    active = packed[4 * n:4 * n + num_slots] > 0.5
    extra = packed[4 * n + num_slots:4 * n + num_slots + n_extra]
    return sec[0].astype(np.int64), sec[1], sec[2], sec[3] > 0.5, active, extra


def _spec_round(model, draft, gamma: int, eos, do_sample: bool, temperature: float, cache, d_cache,
                step_logits, samp_logp, slot_pos, active, limit, collect_rauq: bool = False,
                generator: Optional[torch.Generator] = None, draws: Optional[Dict[str, torch.Tensor]] = None):
    """ONE speculative round over every slot: JAX's ``_make_spec_round``.

    Select each slot's next token ``tok0`` (argmax of its ``step_logits``
    row, or a draw from its ``samp_logp`` row), take ``gamma + 1`` draft
    steps at the per-slot clocks on ``d_cache`` (the last only writes the
    last proposal's K/V), verify the (S, gamma + 1) block with one target
    forward on ``cache``, and take the longest agreeing prefix (greedy) or
    the Leviathan-accepted one (sampled, the residual max(p_t - p_d, 0) at
    the rejection row carried as the next round's ``samp_logp``). The EOS
    and budget cuts give the ``emit`` mask; the target's row at the
    rejection index becomes the slot's next ``step_logits`` (the deferred
    correction). Both caches are written in place; rejected rows stay stale
    behind the causal mask until their owner rewrites them.

    ``draws`` may hold the random draws instead of ``generator``: ``tok0``
    (S, V) and ``draft`` (gamma + 1, S, V) Gumbel noise (a categorical draw
    is argmax(logits + noise), as ``jax.random.categorical``) and
    ``uniforms`` (S, gamma), the acceptance draws. Returns a dict of the
    advanced ``step_logits`` / ``samp_logp`` / ``slot_pos`` / ``active``,
    the (S, gamma + 1) ``block`` / ``lps`` / ``ents`` / ``emit``, ``take``,
    ``n_acc`` and, with ``collect_rauq``, ``att_prev`` (L, S, H, gamma + 1):
    each emission's attention to its previous position in the verify
    forward.
    """
    draws = draws or {}
    dev = step_logits.device
    idxs = torch.arange(gamma + 1, device=dev)[None, :]
    log_soft = torch.log_softmax(step_logits, dim=-1)
    if do_sample:
        tok0 = sample_logits(samp_logp, generator, noise=draws.get("tok0"))
    else:
        tok0 = torch.argmax(step_logits, dim=-1)
    # Reported log-probs are the raw target's, not the sampling distribution's.
    lp0 = log_soft.gather(1, tok0[:, None])[:, 0]
    ent0 = _vocab_norm_entropy(log_soft)

    tok, proposals, draft_probs = tok0, [], []
    for j in range(gamma + 1):
        lg = draft(tok[:, None], d_cache, slot_pos + j, need_attentions=False, need_hiddens=False)[0]
        if do_sample:
            row = lg[:, 0] / temperature
            noise = draws["draft"][j] if "draft" in draws else None
            tok = sample_logits(row, generator, noise=noise)
        else:
            # Greedy ignores the temperature (0.0 is a common greedy idiom).
            row = lg[:, 0]
            tok = torch.argmax(row, dim=-1)
        if j < gamma:
            proposals.append(tok)
            if do_sample:
                draft_probs.append(torch.softmax(row, dim=-1))
    proposals = torch.stack(proposals, dim=1)  # (S, gamma)
    block = torch.cat([tok0[:, None], proposals], dim=1)
    lg, v_attn, _, _ = model(block, cache, slot_pos, need_attentions=collect_rauq, need_hiddens=False)
    att_prev = None
    if collect_rauq:
        # Emission j's query sits at clock + j, its previous position at
        # clock + j - 1: one column per (slot, j) of (L, S, H, gamma+1, kv).
        prev = torch.clamp_min(slot_pos[:, None] + idxs - 1, 0)
        at = prev[None, :, None, :, None].expand(*v_attn.shape[:4], 1)
        att_prev = v_attn.gather(-1, at)[..., 0]
    logp = torch.log_softmax(lg, dim=-1)
    vocab = lg.shape[-1]
    if do_sample:
        t_probs = torch.softmax(lg / temperature, dim=-1)
        d_probs = torch.stack(draft_probs, dim=1)
        p_t = t_probs[:, :-1].gather(-1, proposals[..., None])[..., 0]
        p_d = d_probs.gather(-1, proposals[..., None])[..., 0]
        u = draws.get("uniforms")
        if u is None:
            u = torch.rand(p_t.shape, generator=generator, device=dev)
        accept = u < torch.clamp(p_t / p_d.clamp_min(1e-20), max=1.0)
        n_acc = torch.cumprod(accept.to(torch.int64), dim=1).sum(1)
        draft_ext = torch.cat([d_probs, torch.zeros_like(t_probs[:, :1])], dim=1)
        at = n_acc[:, None, None].expand(-1, 1, vocab)
        t_row = t_probs.gather(1, at)[:, 0]
        residual = (t_row - draft_ext.gather(1, at)[:, 0]).clamp_min(0.0)
        residual = torch.where(residual.sum(-1, keepdim=True) > 0, residual, t_row)
        samp_logp = torch.where(active[:, None], torch.log(residual + 1e-30), samp_logp)
    else:
        preds = torch.argmax(lg, dim=-1)
        n_acc = torch.cumprod((proposals == preds[:, :-1]).to(torch.int64), dim=1).sum(1)

    lps = torch.cat([lp0[:, None], logp[:, :-1].gather(-1, proposals[..., None])[..., 0]], dim=1)
    ents = torch.cat([ent0[:, None], _vocab_norm_entropy(logp[:, :-1])], dim=1)
    cand = n_acc + 1
    if eos is not None:
        is_eos = (block == eos) & (idxs < cand[:, None])
        has_eos = is_eos.any(1)
        cand = torch.where(has_eos, torch.argmax(is_eos.to(torch.int64), dim=1) + 1, cand)
    emit = active[:, None] & (idxs < cand[:, None]) & ((slot_pos[:, None] + idxs) < limit[:, None])
    take = emit.sum(1)
    new_pos = slot_pos + take
    new_active = active & (new_pos < limit)
    if eos is not None:
        new_active = new_active & ~has_eos
    nxt_row = lg.gather(1, n_acc[:, None, None].expand(-1, 1, vocab))[:, 0]
    return {
        "step_logits": torch.where(active[:, None], nxt_row, step_logits), "samp_logp": samp_logp,
        "slot_pos": new_pos, "active": new_active, "block": block, "lps": lps, "ents": ents, "emit": emit,
        "take": take, "n_acc": n_acc, "att_prev": att_prev,
    }


def speculative_breakeven(cost_ratio: float, gamma: int, overhead: float = 0.0) -> float:
    """Minimum per-token draft acceptance at which one speculative round
    beats plain decode, under the bandwidth-bound round model: a round costs
    ``(gamma+1) * cost_ratio + 1 + overhead`` target steps (gamma+1 draft
    forwards, one verify forward, plus any measured fixed cost per round in
    target steps) and emits ``E(a) = (1 - a^(gamma+1)) / (1 - a)`` tokens at
    per-token acceptance ``a`` (the accepted prefix and the correction or
    bonus token). Solved by bisection; 1.0 when no acceptance can pay for
    the draft. A draft must clear this floor with margin, or ``overhead``
    must carry the measured fixed cost, for speculation to pay.
    """
    c, g = float(cost_ratio), int(gamma)
    cost = (g + 1) * c + 1.0 + float(overhead)

    def emitted(a):
        if a >= 1.0:
            return float(g + 1)
        return (1.0 - a ** (g + 1)) / (1.0 - a)

    if emitted(1.0) <= cost:
        return 1.0
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if emitted(mid) < cost:
            lo = mid
        else:
            hi = mid
    return hi


def _prefill_rows(model, cache, slots, tokens, write_pos, need_hiddens=False, last_logits_only=False):
    """A prefill-lane forward: the cache rows of ``slots`` gathered, the
    (W, C) ``tokens`` written at each lane's ``write_pos`` and the rows
    scattered back (duplicate lanes write identical rows). Returns the
    model's (logits, hiddens)."""
    rows = {"layers": [{name: buf.index_select(0, slots) for name, buf in layer.items()}
                       for layer in cache["layers"]]}
    logits, _, hiddens, _ = model(tokens, rows, write_pos, need_attentions=False, need_hiddens=need_hiddens,
                                  last_logits_only=last_logits_only)
    for layer, row in zip(cache["layers"], rows["layers"]):
        for name, buf in layer.items():
            buf.index_copy_(0, slots, row[name])
    return logits, hiddens


class _Program:
    """One of the engine's device programs: ``fn`` reads and writes the
    engine's static buffers in place. With ``use_graph`` on a CUDA device it
    is captured into a CUDA graph here, after one warm-up call of ``fn``,
    and replayed; else run as it is."""

    def __init__(self, fn, device: torch.device, use_graph: bool, generators=()):
        self.fn = fn
        self.graph = None
        if use_graph and device.type == "cuda":
            self.graph = CudaGraph(fn, generators=generators, device=device, warmup=1)

    def __call__(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.fn()


class _Harvest:
    """Host copies of one decode chunk's outputs: the packed harvest and,
    when collected, the RAUQ columns and the final-token hidden vectors;
    pinned on a CUDA engine, with the event that marks their copies done."""

    def __init__(self, engine: "ContinuousBatchingEngine"):
        pin = engine.device.type == "cuda"
        self.sources = [engine._packed, engine._att_prev, engine._hid_last]
        self.host = [None if t is None else torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                     for t in self.sources]
        self.event = torch.cuda.Event() if pin else None

    def start(self) -> None:
        """Enqueue the copies behind the chunk that was just dispatched."""
        for dst, src in zip(self.host, self.sources):
            if dst is not None:
                dst.copy_(src, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record()

    def wait(self, device) -> tuple:
        """(packed, att_prev, hid_last) as numpy, once the copies are done:
        the one wait for the card."""
        if self.event is not None:
            with host_sync(device):
                self.event.synchronize()
        return tuple(None if t is None else t.numpy() for t in self.host)


class ContinuousBatchingEngine:
    """Fixed-slot in-flight batching over a ``LlamaLM``-style model.

    Usage::

        eng = ContinuousBatchingEngine(model, num_slots=8, max_ctx=256, max_new_tokens=32)
        results = eng.generate_all(prompts)   # any number of prompts

    Each result dict carries ``tokens`` (generated ids, EOS-stripped),
    ``log_probs`` and ``entropies`` (one per generated token),
    ``prompt_length``, and two
    sequence-level uncertainty scores computed in the decode loop:
    ``perplexity`` and ``generation_entropy`` (``llm.scores`` semantics);
    with ``collect_rauq`` also ``rauq``, with ``collect_hidden`` also
    ``hidden``. Greedy decode is token-identical to
    ``TorchGenerator.generate`` per prompt.

    The arguments are the JAX engine's, but for two: the model carries its
    own weights (no ``params``), and ``generator`` (a ``torch.Generator`` on
    the model's device, seeded 0 if not given) replaces ``key``.
    ``use_graph`` (default True) replays the decode chunk and the
    chunked-prefill programs as CUDA graphs on a CUDA device; False runs the
    same bodies eagerly (see the module doc).
    """

    # Same-bucket admissions ride one bucketed prefill in groups of this
    # size: slots free in waves, and a prefill of a few rows at serving sizes
    # is weight-bound, so F prompts cost barely more than one.
    _BATCH_F = 8

    def __init__(
        self,
        model,
        num_slots: int = 8,
        max_ctx: int = 512,
        max_new_tokens: int = 64,
        chunk_tokens: int = 8,
        eos_id: Optional[int] = None,
        do_sample: bool = False,
        temperature: float = 1.0,
        prompt_bucket: int = 16,
        generator: Optional[torch.Generator] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = False,
        draft_model=None,
        draft_params=None,
        gamma: int = 4,
        collect_rauq: bool = False,
        rauq_alpha: float = 0.2,
        collect_hidden: Optional[int] = None,
        spec_min_acceptance: Optional[float] = None,
        admission: str = "fifo",
        defer_fetch: bool = False,
        prefill_lanes: int = 1,
        use_graph: bool = True,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.num_slots = int(num_slots)
        self.max_ctx = int(max_ctx)
        self.max_new_tokens = int(max_new_tokens)
        self.chunk_tokens = int(chunk_tokens)
        self.eos_id = eos_id
        self.do_sample = do_sample
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.prompt_bucket = max(1, int(prompt_bucket))
        self.use_graph = bool(use_graph)
        # Chunked prefill: prompts advance in fixed chunks between decode
        # chunks, and one prefill shape serves every prompt.
        if prefill_chunk is not None and int(prefill_chunk) <= 0:
            raise ValueError(f"prefill_chunk must be positive, got {prefill_chunk}")
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk and max_ctx % self.prefill_chunk:
            # Chunk writes are chunk-aligned; divisibility keeps the last
            # chunk inside the cache.
            raise ValueError(f"max_ctx={max_ctx} must be a multiple of prefill_chunk={prefill_chunk}")
        # Prefix caching needs slots that start at physical row 0 (logical ==
        # physical), which only chunked prefill gives; bucketed prompts are
        # left-padded.
        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache and not self.prefill_chunk:
            raise ValueError("prefix_cache=True requires prefill_chunk")
        self._slot_prompt: List[Optional[list]] = [None] * int(num_slots)
        # In-loop RAUQ: each consumed token's attention to the previous
        # position, scored when the request finishes.
        self.collect_rauq = bool(collect_rauq)
        self.rauq_alpha = float(rauq_alpha)
        # In-loop EigenScore signal: per slot, the chosen layer's hidden
        # vector of the forward that produced the request's final token.
        self.collect_hidden: Optional[int] = None
        if collect_hidden is not None:
            if draft_model is not None:
                raise NotImplementedError(
                    "collect_hidden is not supported on the speculative "
                    "engine (block emission makes the final-token forward "
                    "ambiguous); use the plain engine"
                )
            n_hiddens = int(model.num_layers) + 1
            li = int(collect_hidden)
            if li < 0:
                li += n_hiddens
            if not 0 <= li < n_hiddens:
                raise ValueError(
                    f"collect_hidden={collect_hidden} out of range for a "
                    f"model with {n_hiddens} hidden-state entries"
                )
            self.collect_hidden = li
        # "fifo" keeps arrival order; "lpt" admits the longest remaining
        # budget first, which packs an offline drain into fewer chunks.
        if admission not in ("fifo", "lpt"):
            raise ValueError(f"admission must be 'fifo' or 'lpt', got {admission!r}")
        self.admission = admission
        self.prefill_lanes = max(1, int(prefill_lanes))
        # Open-loop drain: with no EOS every chunk's emissions follow from
        # the budgets, so the host dispatches without reading anything back
        # until the drain ends.
        self.defer_fetch = bool(defer_fetch)
        if self.defer_fetch:
            if eos_id is not None:
                raise ValueError(
                    "defer_fetch needs eos_id=None: EOS stops are data-"
                    "dependent, so the emission schedule would not be "
                    "host-predictable"
                )
            if draft_model is not None:
                raise ValueError(
                    "defer_fetch is not supported with speculative "
                    "decoding (acceptance makes emission data-dependent)"
                )
        self.prefix_hits = 0  # admissions served from the prefix cache
        self._stats = {
            "requests_finished": 0,
            "tokens_emitted": 0,
            "decode_chunks": 0,
            "prefill_chunks": 0,
            "deferred_admissions": 0,
            # Wall time of the serving loop (s): "fetch" the waits for the
            # harvests (device execution drains here), "dispatch" the decode
            # chunks' launches, "prefill" the prefill launches, "sched" the
            # host bookkeeping.
            "t_fetch_s": 0.0,
            "t_dispatch_s": 0.0,
            "t_prefill_s": 0.0,
            "t_sched_s": 0.0,
        }
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.gamma = int(gamma)
        self.spec_min_acceptance = float(spec_min_acceptance) if spec_min_acceptance is not None else None
        if draft_model is not None:
            if not self.prefill_chunk:
                raise ValueError("speculative decoding requires prefill_chunk")
            if top_k or top_p < 1.0:
                raise NotImplementedError(
                    "the speculative engine path supports temperature "
                    "sampling only (no top-k/top-p); use "
                    "SpeculativeGenerator or the plain engine for those"
                )
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError("draft and target must share one vocabulary")
            # Acceptance over the slots live at each round's start, as the
            # fused drain's _last_fused_stats counts it.
            self._stats["accepted"] = 0
            self._stats["proposed"] = 0
        self._spec_disabled = False
        self._SPEC_EVIDENCE = 256  # proposals before the break-even guard may fire
        # Verify and draft passes write gamma + 1 rows past a slot's clock.
        self._ctx_slack = self.gamma + 1 if draft_model is not None else 0
        self._rounds = max(1, self.chunk_tokens // (self.gamma + 1))  # spec rounds a decode chunk
        dev = self.device
        self.generator = generator or torch.Generator(device=dev).manual_seed(0)

        # Device state. Row S of step_logits, samp_logp and hid_prev is a
        # spare that a prefill lane which is not on its last chunk writes into.
        S, vocab = self.num_slots, model.vocab_size
        self.cache = init_cache(model, S, self.max_ctx, dev)
        self.d_cache = init_cache(draft_model, S, self.max_ctx, dev) if draft_model is not None else None
        self.samp_logp = (torch.zeros((S + 1, vocab), dtype=torch.float32, device=dev)
                          if draft_model is not None and do_sample else None)
        self.step_logits = torch.zeros((S + 1, vocab), dtype=torch.float32, device=dev)
        self._state = torch.zeros((5 * S,), dtype=torch.int32, device=dev)
        self._hid_prev = self._hid_last = None
        if self.collect_hidden is not None:
            d = int(model.d_model)
            self._hid_prev = torch.zeros((S + 1, d), dtype=torch.float32, device=dev)
            self._hid_last = torch.zeros((S, d), dtype=torch.float32, device=dev)
        self._harvest_buffers(self._spec_on)
        self._fused_cache = ProgramCache(_FUSED_PROGRAMS)
        self._last_fused_stats: Dict[str, Any] = {}
        # Host mirrors of the scheduling state: the packed (5 S,) device copy
        # is [slot_pos | kv_start | limit | active | sample flag].
        self.slot_pos = np.zeros((S,), np.int32)  # next write
        self.kv_start = np.zeros((S,), np.int32)  # left-pad offset
        self.limit = np.zeros((S,), np.int32)  # physical cap
        self.active = np.zeros((S,), bool)
        # Per-slot sampling flags (do_sample engines): a request submitted
        # with sample=False decodes greedily in the same chunk program.
        self.samp_flags = np.zeros((S,), np.int32)

        # Programs, built while every buffer is zero; the warm-up calls'
        # writes are cleared after.
        self._bucket_args: Dict[tuple, torch.Tensor] = {}
        self._bucket_progs: Dict[tuple, _Program] = {}
        self._lane_args: Dict[int, torch.Tensor] = {}
        if self.prefill_chunk:
            for w in range(1, self.prefill_lanes + 1):
                self._lane_args[w] = torch.zeros((w, self.prefill_chunk + 7), dtype=torch.int64, device=dev)
        self._build_decode_programs()
        for t in self._device_buffers():
            t.zero_()

        self._slot_req: List[Optional[dict]] = [None] * S
        self._queue: deque = deque()
        self._results: Dict[int, dict] = {}
        self._next_id = 0

    @property
    def _spec_on(self) -> bool:
        """Whether the decode chunks are speculative rounds."""
        return self.draft_model is not None and not self._spec_disabled

    def _harvest_buffers(self, spec: bool) -> None:
        """The decode chunk's host-bound outputs for the decode mode: K
        steps, or R rounds of gamma + 1 emissions and the (accepted,
        proposed) trailer; with ``collect_rauq`` the attention columns."""
        S, K, G, dev, model = self.num_slots, self.chunk_tokens, self.gamma + 1, self.device, self.model
        shape = (self._rounds, S, G) if spec else (K, S)
        self._packed = torch.zeros((4 * int(np.prod(shape)) + S + (2 if spec else 0),), dtype=torch.float32,
                                   device=dev)
        att = (self._rounds, model.num_layers, S, model.num_heads, G) if spec else (K, model.num_layers, S,
                                                                                    model.num_heads)
        self._att_prev = torch.zeros(att, dtype=torch.float32, device=dev) if self.collect_rauq else None
        self._harvest_pool: List[_Harvest] = []

    def _build_decode_programs(self) -> None:
        """The decode chunk of the current mode and the lane programs of
        every W <= ``prefill_lanes`` (with the draft's leg while speculation
        is on), captured on a CUDA device with ``use_graph``. Each program
        draws from a generator of its own."""
        dev, spec = self.device, self._spec_on
        self._gen_own = torch.Generator(device=dev) if self.do_sample else None
        body = self._spec_chunk_body if spec else self._chunk_body
        self._chunk_prog = _Program(body, dev, self.use_graph, [self._gen_own] if self.do_sample else [])
        self._lane_progs: Dict[int, _Program] = {
            w: _Program(lambda w=w: self._lane_body(w, spec), dev, self.use_graph) for w in self._lane_args}

    def _device_buffers(self) -> List[torch.Tensor]:
        bufs = [t for layer in self.cache["layers"] for t in layer.values()]
        if self.d_cache is not None:
            bufs += [t for layer in self.d_cache["layers"] for t in layer.values()]
        bufs += [self.step_logits, self._state, self._packed, *self._lane_args.values()]
        return bufs + [t for t in (self._hid_prev, self._hid_last, self._att_prev, self.samp_logp) if t is not None]

    # -- device programs ------------------------------------------------------
    def _chunk_body(self) -> None:
        """K decode steps for every slot, each on its own clock: the JAX
        ``_build_chunk`` scan, unrolled."""
        S, K, max_ctx, eos = self.num_slots, self.chunk_tokens, self.max_ctx, self.eos_id
        model, li = self.model, self.collect_hidden
        state = self._state.view(5, S)
        slot_pos, kv_start, limit = state[0].long(), state[1].long(), state[2].long()
        active, samp_flag = state[3] > 0, state[4] > 0
        step_logits = self.step_logits[:S]
        hp = self._hid_prev[:S] if li is not None else None
        hl = self._hid_last if li is not None else None
        # Physical rows each slot may attend: its own [kv_start, slot_pos]
        # window (the upper end by the per-slot causal clock).
        kv_valid = torch.arange(max_ctx, device=slot_pos.device)[None, :] >= kv_start[:, None]
        toks, lps, ents, emits = [], [], [], []
        for k in range(K):
            log_soft = torch.log_softmax(step_logits, dim=-1)
            greedy = torch.argmax(step_logits, dim=-1)
            if self.do_sample:
                drawn = sample_logits(step_logits, self._gen_own, self.temperature, self.top_k, self.top_p)
                next_tok = torch.where(samp_flag, drawn, greedy)
            else:
                next_tok = greedy
            lp = log_soft.gather(1, next_tok[:, None])[:, 0]
            # A slot emits only while its clock is inside its budget window;
            # a zero-budget request emits nothing.
            emitted = active & (slot_pos < limit)
            lp = torch.where(emitted, lp, torch.full_like(lp, float("-inf")))
            next_tok = torch.where(emitted, next_tok, torch.zeros_like(next_tok))
            ent = _vocab_norm_entropy(log_soft)
            if eos is not None:
                active = active & (next_tok != eos)
            # Writes clamp into the cache as JAX's dynamic_update_slice does
            # (a finished slot's clock may sit at max_ctx).
            new_logits, attn, hiddens, _ = model(
                next_tok[:, None], self.cache, slot_pos.clamp(max=max_ctx - 1), token_valid=kv_valid,
                positions=(slot_pos - kv_start)[:, None], need_attentions=self.collect_rauq,
                need_hiddens=li is not None,
            )
            if li is not None:
                # The emission's producing forward ran before this step (the
                # prefill or the previous step): commit hp to hl first.
                hl = torch.where(emitted[:, None], hp, hl)
                hp = torch.where(emitted[:, None], hiddens[li, :, 0, :], hp)
            if self.collect_rauq:
                # The consumed token's attention to the previous position:
                # attn (L, S, H, 1, kv), one column per slot.
                prev = torch.clamp_min(slot_pos - 1, 0)
                column = attn[:, :, :, 0, :].gather(-1, prev[None, :, None, None].expand(*attn.shape[:3], 1))
                self._att_prev[k].copy_(column[..., 0])
            slot_pos = slot_pos + emitted.long()
            active = active & (slot_pos < limit)
            step_logits = torch.where(emitted[:, None], new_logits[:, 0, :], step_logits)
            toks.append(next_tok)
            lps.append(lp)
            ents.append(ent)
            emits.append(emitted)
        self.step_logits[:S].copy_(step_logits)
        if li is not None:
            self._hid_prev[:S].copy_(hp)
            self._hid_last.copy_(hl)
        self._packed.copy_(_pack_harvest(torch.stack(toks), torch.stack(lps), torch.stack(ents),
                                         torch.stack(emits), active))
        state[0].copy_(slot_pos)
        state[3].copy_(active)

    def _spec_chunk_body(self) -> None:
        """``chunk_tokens // (gamma + 1)`` speculative rounds for every slot
        (:func:`_spec_round`): the JAX ``_build_spec_chunk`` scan, unrolled.
        The harvest carries the rounds' (accepted, proposed) sums."""
        S, gamma = self.num_slots, self.gamma
        state = self._state.view(5, S)
        slot_pos, limit, active = state[0].long(), state[2].long(), state[3] > 0
        step_logits = self.step_logits[:S]
        samp_logp = self.samp_logp[:S] if self.samp_logp is not None else None
        toks, lps, ents, emits, accs = [], [], [], [], []
        for r in range(self._rounds):
            out = _spec_round(self.model, self.draft_model, gamma, self.eos_id, self.do_sample, self.temperature,
                              self.cache, self.d_cache, step_logits, samp_logp, slot_pos, active, limit,
                              collect_rauq=self.collect_rauq, generator=self._gen_own)
            emit = out["emit"]
            toks.append(torch.where(emit, out["block"], torch.zeros_like(out["block"])))
            lps.append(torch.where(emit, out["lps"], torch.full_like(out["lps"], float("-inf"))))
            ents.append(out["ents"])
            emits.append(emit)
            accs.append(torch.stack([torch.where(active, out["n_acc"], 0).sum(), torch.where(active, gamma, 0).sum()]))
            if self.collect_rauq:
                self._att_prev[r].copy_(out["att_prev"])
            step_logits, samp_logp = out["step_logits"], out["samp_logp"]
            slot_pos, active = out["slot_pos"], out["active"]
        self.step_logits[:S].copy_(step_logits)
        if samp_logp is not None:
            self.samp_logp[:S].copy_(samp_logp)
        self._packed.copy_(_pack_harvest(torch.stack(toks), torch.stack(lps), torch.stack(ents), torch.stack(emits),
                                         active, extra=torch.stack(accs).sum(0)))
        state[0].copy_(slot_pos)
        state[3].copy_(active)

    def _lane_body(self, W: int, with_draft: bool = False) -> None:
        """Advance W slots' prefills by one chunk each in one (W, C)
        forward: the JAX ``_build_prefill_chunk_many`` (W = 1 is its
        ``_build_prefill_chunk``). Each lane's cache row is gathered from
        its slot, written at its own offset and scattered back; a lane on
        its final chunk sets its slot's next-token logits (and hidden
        vector, and the sampled speculative engine's ``samp_logp``, JAX's
        ``_seed_samp``) from its last real token, the others write the
        spare row. ``with_draft``: the draft tracks the same chunk on its
        own cache."""
        S, C, li = self.num_slots, self.prefill_chunk, self.collect_hidden
        args = self._lane_args[W]
        tokens = args[:, :C]
        slots, write_pos, last_idx, is_last, limit, samp, parked = (args[:, C + i].contiguous() for i in range(7))
        # Scheduling edits: park the clock at the next write position, pin
        # kv_start and limit, activate the slot on its final chunk.
        edits = torch.stack([parked, torch.zeros_like(parked), limit, is_last, samp]).to(torch.int32)
        self._state.view(5, S).index_copy_(1, slots, edits)
        logits, hiddens = _prefill_rows(self.model, self.cache, slots, tokens, write_pos, need_hiddens=li is not None)
        if with_draft:  # the draft's logits are never read
            _prefill_rows(self.draft_model, self.d_cache, slots, tokens, write_pos, last_logits_only=True)
        target = torch.where(is_last > 0, slots, torch.full_like(slots, S))
        sel = logits.gather(1, last_idx[:, None, None].expand(W, 1, logits.shape[-1]))[:, 0]
        self.step_logits.index_copy_(0, target, sel)
        if self.samp_logp is not None:
            self.samp_logp.index_copy_(0, target, torch.log_softmax(sel / self.temperature, dim=-1))
        if li is not None:
            hvec = hiddens[li].gather(1, last_idx[:, None, None].expand(W, 1, hiddens.shape[-1]))[:, 0]
            self._hid_prev.index_copy_(0, target, hvec)

    def _bucket_body(self, F: int, p_pad: int) -> None:
        """Prefill F left-padded prompts of a p_pad bucket into a fresh
        (zeroed) F-row cache, then splice each row into its slot with its
        next-token logits, hidden vector and scheduling state: the JAX
        ``_build_prefill_many``."""
        S, li, dev = self.num_slots, self.collect_hidden, self.device
        args = self._bucket_args[(F, p_pad)]
        tokens, valid = args[:, :p_pad], args[:, p_pad:2 * p_pad] > 0
        slots = args[:, 2 * p_pad].contiguous()
        self._state.view(5, S).index_copy_(1, slots, args[:, 2 * p_pad + 1:].T.contiguous().to(torch.int32))
        local = init_cache(self.model, F, self.max_ctx, dev)
        kv_valid = torch.cat([valid, torch.ones((F, self.max_ctx - p_pad), dtype=torch.bool, device=dev)], dim=1)
        positions = torch.clamp_min(torch.cumsum(valid.to(torch.int64), dim=1) - 1, 0)
        logits, _, hiddens, _ = self.model(tokens, local, 0, token_valid=kv_valid, positions=positions,
                                           need_attentions=False, need_hiddens=li is not None, last_logits_only=True)
        for layer, row in zip(self.cache["layers"], local["layers"]):
            for name, buf in layer.items():
                buf.index_copy_(0, slots, row[name])
        self.step_logits.index_copy_(0, slots, logits[:, -1])
        if li is not None:
            # Left-padded prompts: the last real token sits at p_pad - 1.
            self._hid_prev.index_copy_(0, slots, hiddens[li, :, -1, :])

    def _prefill_group(self, group: List[tuple], p_pad: int) -> None:
        """One (F, p_pad) bucketed prefill admitting ``group`` together.
        Each shape's program is built at its first call: captured, its
        warm-up being that call, on a CUDA device with ``use_graph``."""
        F = len(group)
        args = np.zeros((F, 2 * p_pad + 6), np.int64)
        for i, (slot, req, p, _) in enumerate(group):
            args[i, p_pad - p:p_pad] = req["prompt"]
            args[i, 2 * p_pad - p:2 * p_pad] = 1
            args[i, 2 * p_pad:] = (slot, p_pad, p_pad - p, min(p_pad + req["max_new"], self.max_ctx), 1,
                                   int(req["sample"]))
        key = (F, p_pad)
        if key not in self._bucket_args:
            self._bucket_args[key] = torch.zeros(args.shape, dtype=torch.int64, device=self.device)
        self._bucket_args[key].copy_(upload(args, self.device))
        prog = self._bucket_progs.get(key)
        if prog is None:
            prog = self._bucket_progs[key] = _Program(lambda: self._bucket_body(F, p_pad), self.device,
                                                      self.use_graph)
            if prog.graph is None:
                prog()
        else:
            prog()
        for slot, req, p, _ in group:
            self.slot_pos[slot] = p_pad
            self.kv_start[slot] = p_pad - p
            self.limit[slot] = min(p_pad + req["max_new"], self.max_ctx)
            self.active[slot] = True
            self.samp_flags[slot] = int(req["sample"])
            self._slot_req[slot] = req

    def _copy_row(self, src: int, dst: int) -> None:
        """Slot ``src``'s whole cache row onto slot ``dst``. Rows past the
        shared prefix carry the source's stale data, which the suffix chunks
        and the decode steps rewrite before anything attends them."""
        for cache in (self.cache, self.d_cache):
            for layer in cache["layers"] if cache is not None else ():
                for buf in layer.values():
                    buf[dst].copy_(buf[src])

    def _best_prefix(self, prompt: list, ignore_avail: bool = False) -> tuple:
        """(slot, chunk-aligned shared-prefix length) of the best resident
        match, or (None, 0). Only whole chunks are reusable, and the prompt
        must keep at least one real token past the prefix (its next-token
        logits come from the suffix prefill). ``ignore_avail`` scores what
        a donor still mid-prefill will offer once it is done."""
        C = self.prefill_chunk
        best_slot, best_len = None, 0
        for slot, resident in enumerate(self._slot_prompt):
            if resident is None:
                continue
            # A source mid-prefill has written rows [0, write_pos) only.
            src_req = self._slot_req[slot]
            avail = (
                src_req["write_pos"]
                if not ignore_avail and src_req is not None and not src_req.get("prefill_done", True)
                else len(resident)
            )
            n = 0
            for a, b in zip(resident, prompt):
                if a != b:
                    break
                n += 1
            n = (min(n, avail) // C) * C
            n = min(n, ((len(prompt) - 1) // C) * C)
            if n > best_len:
                best_slot, best_len = slot, n
        return best_slot, best_len

    def _upload_state(self) -> None:
        """The host mirrors into the device copy of the scheduling state."""
        packed = np.concatenate([self.slot_pos, self.kv_start, self.limit, self.active.astype(np.int32),
                                 self.samp_flags]).astype(np.int32)
        self._state.copy_(upload(packed, self.device))

    # -- host-side scheduling -------------------------------------------------
    def _refill(self) -> None:
        """Assign queued prompts to every free slot (chunked mode leaves the
        device work to :meth:`_advance_prefills`; bucketed mode prefills the
        whole prompts here)."""
        t0 = time.perf_counter()
        try:
            with span("runia.engine.refill"):
                self._refill_inner()
        finally:
            self._stats["t_prefill_s"] += time.perf_counter() - t0

    def _refill_inner(self) -> None:
        if self.admission == "lpt" and len(self._queue) > 1:
            # Stable sort: equal budgets keep arrival order.
            self._queue = deque(sorted(self._queue, key=lambda r: -r["max_new"]))
        free = [s for s in range(self.num_slots) if self._slot_req[s] is None]
        classic_admissions: List[tuple] = []
        for slot in free:
            if not self._queue:
                break
            req = self._queue.popleft()
            p = len(req["prompt"])
            if self.prefill_chunk:
                req["pending"] = list(req["prompt"])
                req["write_pos"] = 0
                req["prefill_done"] = False
                if self.prefix_cache:
                    src, n = self._best_prefix(req["prompt"])
                    pot = self._best_prefix(req["prompt"], ignore_avail=True)[1]
                    if pot > n:
                        # A better donor is still mid-prefill (the first of
                        # several duplicates): wait a round for it.
                        self._queue.appendleft(req)
                        self._stats["deferred_admissions"] += 1
                        break
                    if n > 0:
                        if src != slot:
                            self._copy_row(src, slot)
                        # src == slot: the previous occupant's prompt rows are
                        # resident already.
                        req["pending"] = req["prompt"][n:]
                        req["write_pos"] = n
                        self.prefix_hits += 1
                self._slot_prompt[slot] = list(req["prompt"])
                # Physical row 0 start (kv_start 0). The clock parks at the
                # next write position, so the decode steps' writes for this
                # inactive slot land where its next chunk overwrites them.
                self.kv_start[slot] = 0
                self.slot_pos[slot] = req["write_pos"]
                self.limit[slot] = min(p + req["max_new"], self.max_ctx)
                self.active[slot] = False
                self.samp_flags[slot] = int(req["sample"])
                self._slot_req[slot] = req
                continue
            p_pad = -(-max(p, 1) // self.prompt_bucket) * self.prompt_bucket
            classic_admissions.append((slot, req, p, p_pad))
        if classic_admissions:
            self._admit_classic(classic_admissions)

    def _admit_classic(self, admissions: List[tuple]) -> None:
        """Prefill bucketed admissions, same-bucket groups of ``_BATCH_F``
        in one call, the rest one by one."""
        by_pad: Dict[int, List[tuple]] = {}
        for adm in admissions:
            by_pad.setdefault(adm[3], []).append(adm)
        for p_pad, group in by_pad.items():
            while len(group) >= self._BATCH_F:
                self._prefill_group(group[:self._BATCH_F], p_pad)
                group = group[self._BATCH_F:]
            for single in group:
                self._prefill_group([single], p_pad)

    def _advance_prefills(self) -> None:
        """Advance every mid-prefill slot by one chunk, ``prefill_lanes``
        slots to a program call; a slot's final chunk sets its next-token
        logits and activates it."""
        if not self.prefill_chunk:
            return
        pend = [(s, r) for s, r in enumerate(self._slot_req) if r is not None and not r.get("prefill_done", True)]
        for i in range(0, len(pend), self.prefill_lanes):
            self._advance_lane_group(pend[i:i + self.prefill_lanes])

    def _advance_lane_group(self, group: List[tuple]) -> None:
        """One lane program call for ``group``'s next chunks."""
        C, W = self.prefill_chunk, len(group)
        args = np.zeros((W, C + 7), np.int64)
        for i, (slot, req) in enumerate(group):
            take = req["pending"][:C]
            req["pending"] = req["pending"][C:]
            args[i, :len(take)] = take
            parked = req["write_pos"] + len(take)
            args[i, C:] = (slot, req["write_pos"], len(take) - 1, not req["pending"],
                           min(len(req["prompt"]) + req["max_new"], self.max_ctx), int(req["sample"]), parked)
        with span("runia.engine.prefill", batch=W):
            self._lane_args[W].copy_(upload(args, self.device))
            self._lane_progs[W]()
        self._stats["prefill_chunks"] += 1
        for i, (slot, req) in enumerate(group):
            req["write_pos"] = int(args[i, C + 6])
            # The clock parks at the next write position (a chunk boundary
            # mid-prefill; the true next-token slot once done).
            self.slot_pos[slot] = req["write_pos"]
            if args[i, C + 3]:
                req["prefill_done"] = True
                self.active[slot] = True

    def _finish_slot(self, slot: int, hid_np=None) -> None:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._finish_req(req, hid_np[slot] if hid_np is not None else None)

    def _finish_req(self, req: dict, hid_row=None) -> None:
        """Record one finished request's result (independent of its slot, so
        the open-loop drain can finish a request whose slot was reassigned
        before its harvest was read)."""
        toks, lps, ents = req["tokens"], req["lps"], req["ents"]
        atts = req["atts"]
        if self.eos_id is not None and self.eos_id in toks:
            cut = toks.index(self.eos_id)
            toks, lps, ents = toks[:cut], lps[:cut], ents[:cut]
            atts = atts[:cut]
        lps_arr = np.asarray(lps, np.float32)
        ents_arr = np.asarray(ents, np.float32)
        self._results[req["id"]] = {
            "tokens": toks,
            "log_probs": lps_arr,
            "prompt_length": len(req["prompt"]),
            # llm.scores semantics: perplexity = mean -log p of the emitted
            # tokens; generation_entropy = the mean vocab-normalised entropy
            # of their steps. nan for zero-token results.
            "perplexity": float(-lps_arr.mean()) if len(toks) else float("nan"),
            "generation_entropy": float(ents_arr.mean()) if len(toks) else float("nan"),
            "entropies": ents_arr,  # each generated token's step: its vocab-normalised entropy
        }
        self._stats["requests_finished"] += 1
        if self.collect_hidden is not None:
            # hidden_states[-1][layer] of the HF protocol: the chosen layer's
            # vector of the forward that produced the last kept token.
            self._results[req["id"]]["hidden"] = (
                hid_row.copy() if hid_row is not None and len(toks) else None
            )
        if self.collect_rauq:
            from runia_core_tpu_torch.llm.scores import rauq_uncertainty

            # Entry i is token i's attention to its previous position; the
            # last token's entry is never consumed in the HF protocol.
            self._results[req["id"]]["rauq"] = (
                rauq_uncertainty(lps_arr, None, "original", alphas=[self.rauq_alpha],
                                 attention_weights=np.stack(atts[: len(toks) - 1], -1))
                if len(toks) >= 2 else float("nan")
            )

    def _validate_request(self, prompt: List[int], max_new_tokens: Optional[int]) -> int:
        """Check one request against the engine's capacity; returns its
        ``max_new`` budget. Raises without changing any state, so a batch
        can be validated before anything is enqueued."""
        p = len(prompt)
        max_new = int(self.max_new_tokens if max_new_tokens is None else max_new_tokens)
        if self.prefill_chunk:
            if p == 0:
                raise ValueError("chunked prefill needs a non-empty prompt")
            if p + max_new + self._ctx_slack > self.max_ctx:
                raise ValueError(
                    f"prompt of {p} tokens + {max_new} new "
                    f"(+{self._ctx_slack} speculative slack) exceeds "
                    f"max_ctx={self.max_ctx}"
                )
        else:
            p_pad = -(-max(p, 1) // self.prompt_bucket) * self.prompt_bucket
            if p_pad + max_new > self.max_ctx:
                raise ValueError(
                    f"prompt of {p} tokens (bucketed to {p_pad}) + "
                    f"{max_new} new exceeds max_ctx={self.max_ctx}"
                )
        return max_new

    def submit(self, prompt_tokens: Sequence[int], max_new_tokens: Optional[int] = None,
               sample: Optional[bool] = None) -> int:
        """Enqueue one prompt; returns its request id. ``max_new_tokens``
        overrides the engine's budget for this request; ``sample`` its
        decoding mode (a ``do_sample=True`` engine serves ``sample=False``
        requests greedily in the same programs; ``sample=True`` on a greedy
        engine raises). Validation happens here, so a bad request fails at
        once instead of mid-drain."""
        prompt = list(prompt_tokens)
        max_new = self._validate_request(prompt, max_new_tokens)
        if sample is None:
            sample = self.do_sample
        elif sample and not self.do_sample:
            raise ValueError("sample=True on a greedy engine (construct with do_sample=True to serve mixed decoding modes)")
        elif self.draft_model is not None and sample != self.do_sample:
            raise NotImplementedError(
                "per-request decoding modes are not supported on the "
                "speculative engine (the verify path is mode-global)"
            )
        rid = self._next_id
        self._next_id += 1
        self._queue.append({
            "id": rid, "prompt": prompt, "tokens": [], "lps": [], "ents": [], "atts": [],
            "max_new": max_new, "sample": bool(sample),
        })
        return rid

    def run_until_drained(self) -> None:
        """Decode until every submitted request has a result."""
        for _ in self.stream():
            pass

    def stream(self):
        """Drain the engine, yielding ``(request_id, new_token_ids)``
        increments as each chunk's harvest is read. Increments stop at a
        request's EOS, so their concatenation is the final ``tokens``.

        The drain is pipelined (lookahead 1): chunk k+1 is dispatched from
        the device's scheduling state before chunk k's harvest is read, so
        the host's wait, bookkeeping and refills overlap chunk k+1; a slot
        freed in chunk k idles through chunk k+1. ``defer_fetch=True``
        engines run open-loop instead (:meth:`_stream_deferred`).
        """
        if self.defer_fetch:
            yield from self._stream_deferred()
            return
        self._maybe_disable_spec()
        self._upload_state()
        self._refill()
        inflight = None
        while any(r is not None for r in self._slot_req) or inflight:
            t0 = time.perf_counter()
            self._advance_prefills()
            self._stats["t_prefill_s"] += time.perf_counter() - t0
            nxt = None
            if self.active.any():
                # Tail guard: with the queue empty and the chunk in flight
                # covering every live request's budget, read it before
                # deciding on another chunk.
                if not (inflight is not None and self._tail_drain()):
                    nxt = self._dispatch_chunk()
            elif inflight is None:
                # Every occupied slot is mid-prefill: keep prefilling.
                self._refill()
                continue
            if inflight is not None:
                yield from self._process_harvest(*inflight)
            inflight = nxt
            self._refill()

    def _stream_deferred(self):
        """Open-loop drain (``defer_fetch=True``): dispatch every chunk and
        prefill without reading a harvest until the drain ends. With no EOS
        each chunk's emissions per slot are min(chunk_tokens, remaining
        budget), so the host mirrors advance by simulation, a freed slot is
        refilled for the very next chunk, and the events are yielded at the
        end. Each harvest is copied to host memory as it is dispatched."""
        self._upload_state()
        self._refill()
        pending: List[tuple] = []
        while any(r is not None for r in self._slot_req):
            t0 = time.perf_counter()
            self._advance_prefills()
            self._stats["t_prefill_s"] += time.perf_counter() - t0
            if self.active.any():
                harvest, owners = self._dispatch_chunk()
                owner_reqs = {s: self._slot_req[s] for s in range(self.num_slots) if owners[s] is not None}
                finished = self._simulate_chunk(owner_reqs)
                pending.append((harvest, owner_reqs, finished))
            self._refill()
        yield from self._flush_deferred(pending)

    def _simulate_chunk(self, owner_reqs: Dict[int, dict]) -> List[dict]:
        """Advance the host mirrors as the dispatched chunk will: each owned
        slot emits min(chunk_tokens, limit - clock) tokens. Returns the
        requests that finish in it, whose slots are freed at once."""
        finished = []
        self._stats["decode_chunks"] += 1
        for slot, req in owner_reqs.items():
            n = max(0, min(self.chunk_tokens, int(self.limit[slot]) - int(self.slot_pos[slot])))
            self.slot_pos[slot] += n
            req["sim_len"] = req.get("sim_len", 0) + n
            if self.slot_pos[slot] >= self.limit[slot] or req["sim_len"] >= req["max_new"]:
                self.active[slot] = False
                self._slot_req[slot] = None
                finished.append(req)
        return finished

    def _flush_deferred(self, pending: List[tuple]):
        """Read every deferred harvest in dispatch order, append the
        emissions to their requests and finish the requests the simulation
        marked done; a mismatch with the simulation raises."""
        t1 = time.perf_counter()
        events = []
        K = self.chunk_tokens
        for harvest, owner_reqs, finished in pending:
            packed_np, atts_np, hid_np = harvest.wait(self.device)
            toks, lps, ents, emitted, _, _ = _unpack_harvest(packed_np, (K, self.num_slots), self.num_slots)
            self._stats["tokens_emitted"] += int(emitted.sum())
            for slot, req in owner_reqs.items():
                before = len(req["tokens"])
                for k in range(K):
                    if emitted[k, slot]:
                        req["tokens"].append(int(toks[k, slot]))
                        req["lps"].append(float(lps[k, slot]))
                        req["ents"].append(float(ents[k, slot]))
                        if atts_np is not None:
                            req["atts"].append(atts_np[k, :, slot, :].copy())
                new = req["tokens"][before:]
                if new:
                    events.append((req["id"], new))
            for req in finished:
                if len(req["tokens"]) != req["sim_len"]:
                    raise RuntimeError(
                        f"open-loop schedule diverged from the device for "
                        f"request {req['id']}: simulated {req['sim_len']} "
                        f"emissions, harvested {len(req['tokens'])}"
                    )
                hid_row = None
                if self.collect_hidden is not None:
                    # The slot the request held when this chunk ran.
                    slot = next(s for s, r in owner_reqs.items() if r is req)
                    hid_row = hid_np[slot]
                self._finish_req(req, hid_row)
            self._harvest_pool.append(harvest)
        self._stats["t_fetch_s"] += time.perf_counter() - t1
        yield from events

    def _tail_drain(self) -> bool:
        """True when the chunk in flight plausibly completes every live
        request: the queue is empty, no slot is mid-prefill, and each
        request's remaining budget fits in one chunk."""
        if self._queue:
            return False
        for req in self._slot_req:
            if req is None:
                continue
            if not req.get("prefill_done", True):
                return False
            if req["max_new"] - len(req["tokens"]) > self.chunk_tokens:
                return False
        return True

    def _dispatch_chunk(self):
        """Launch one decode chunk from the device's scheduling state and
        enqueue its harvest's copy to the host; returns the harvest and the
        request id each slot decodes for (a slot refilled later is not taken
        for the request this chunk served)."""
        owners = [
            req["id"] if req is not None and req.get("prefill_done", True) and self.active[s] else None
            for s, req in enumerate(self._slot_req)
        ]
        t0 = time.perf_counter()
        harvest = self._harvest_pool.pop() if self._harvest_pool else _Harvest(self)
        with span("runia.engine.decode"):
            if self._gen_own is not None:
                with drawing_from(self._gen_own, self.generator):
                    self._chunk_prog()
            else:
                self._chunk_prog()
            harvest.start()
        self._stats["t_dispatch_s"] += time.perf_counter() - t0
        return harvest, owners

    def _process_harvest(self, harvest: _Harvest, owners):
        """Read one chunk's harvest, advance the host mirrors, append the
        emissions and finish completed requests. The events are yielded at
        the end, so ``t_sched_s`` times this engine's bookkeeping only."""
        with span("runia.engine.harvest"):
            events = self._read_harvest(harvest, owners)
        yield from events

    def _read_harvest(self, harvest: _Harvest, owners) -> list:
        """:meth:`_process_harvest`'s work; returns its events."""
        t1 = time.perf_counter()
        packed_np, atts, hid_np = harvest.wait(self.device)
        self._stats["t_fetch_s"] += time.perf_counter() - t1
        t_sched = time.perf_counter()
        events = []
        S = self.num_slots
        if self._spec_on:
            toks, lps, ents, emitted, active_now, acc = _unpack_harvest(
                packed_np, (self._rounds, S, self.gamma + 1), S, n_extra=2)
            self._stats["accepted"] += int(acc[0])
            self._stats["proposed"] += int(acc[1])
            # (R, S, gamma+1) round blocks -> (R (gamma+1), S) steps in order.
            toks, lps, ents, emitted = (a.swapaxes(1, 2).reshape(-1, S) for a in (toks, lps, ents, emitted))
            if atts is not None:  # (R, L, S, H, gamma+1) -> (R (gamma+1), L, S, H)
                atts = np.transpose(atts, (0, 4, 1, 2, 3)).reshape(-1, *atts.shape[1:4])
        else:
            toks, lps, ents, emitted, active_now, _ = _unpack_harvest(packed_np, (self.chunk_tokens, S), S)
        # Each slot's clock moved by its emissions (zero for slots the chunk
        # did not own); active comes back in the harvest but only owned
        # slots take it: a slot refilled after dispatch keeps its state.
        self.slot_pos = self.slot_pos + emitted.sum(axis=0).astype(np.int32)
        self._stats["decode_chunks"] += 1
        self._stats["tokens_emitted"] += int(emitted.sum())
        for slot in range(self.num_slots):
            req = self._slot_req[slot]
            if owners[slot] is None or req is None or req["id"] != owners[slot]:
                continue
            self.active[slot] = bool(active_now[slot])
            before = len(req["tokens"])
            for k in range(toks.shape[0]):
                if emitted[k, slot]:
                    req["tokens"].append(int(toks[k, slot]))
                    req["lps"].append(float(lps[k, slot]))
                    req["ents"].append(float(ents[k, slot]))
                    if atts is not None:
                        req["atts"].append(atts[k, :, slot, :].copy())
            # Stream what the EOS-stripped result will hold, nothing past it.
            visible = len(req["tokens"])
            if self.eos_id is not None and self.eos_id in req["tokens"]:
                visible = min(visible, req["tokens"].index(self.eos_id))
            new = req["tokens"][before:visible]
            if new:
                events.append((req["id"], new))
            if (not active_now[slot]) or len(req["tokens"]) >= req["max_new"]:
                self.active[slot] = False
                self._finish_slot(slot, hid_np)
        self._harvest_pool.append(harvest)
        self._stats["t_sched_s"] += time.perf_counter() - t_sched
        return events

    def _maybe_disable_spec(self) -> None:
        """The drain-boundary break-even check (``spec_min_acceptance``):
        once ``_SPEC_EVIDENCE`` proposals are counted and the measured
        acceptance sits below the floor, speculation is off for good. Only
        at a drain boundary, as the sampled residual rides between rounds.
        The plain decode chunk and the draft-free lane programs are built
        then (one capture each); the draft cache stays allocated."""
        if (self.spec_min_acceptance is None or self._spec_disabled or self.draft_model is None
                or self._stats.get("proposed", 0) < self._SPEC_EVIDENCE):
            return
        acc = self._stats["accepted"] / self._stats["proposed"]
        if acc < self.spec_min_acceptance:
            warnings.warn(
                f"speculative decoding disabled: measured acceptance "
                f"{acc:.3f} < break-even {self.spec_min_acceptance:.3f} "
                f"(gamma={self.gamma}); continuing on the plain decode path"
            )
            self._spec_disabled = True
            self._stats["spec_disabled"] = 1
            self._harvest_buffers(False)
            # The lane programs' warm-up runs on null lanes (all slot 0, write
            # position 0) and writes slot 0's first rows and scheduling
            # entries; the decode chunk's warm-up writes at each idle slot's
            # clock, past its prompt. Slot 0's rows and the scheduling state
            # are put back after, so slot 0's prompt stays resident for the
            # prefix cache, as in the JAX engine.
            for args in self._lane_args.values():
                args.zero_()
            rows = [buf for layer in self.cache["layers"] for buf in layer.values()]
            saved = [buf[0].clone() for buf in rows]
            state = self._state.clone()
            self._build_decode_programs()
            for buf, row in zip(rows, saved):
                buf[0].copy_(row)
            self._state.copy_(state)

    def stats(self) -> dict:
        """Serving counters (host-side): requests finished, tokens emitted,
        decode and prefill program calls, prefix-cache hits, admissions
        deferred for a donor mid-prefill, and the wall-time breakdown.
        Speculative engines add ``accepted`` / ``proposed`` and the derived
        ``acceptance`` (interactive and fused drains together), and
        ``spec_disabled`` once the break-even guard fired. Cumulative over
        the engine's life."""
        out = {**self._stats, "prefix_hits": self.prefix_hits}
        if out.get("proposed"):
            out["acceptance"] = round(out["accepted"] / out["proposed"], 4)
        return out

    def result(self, request_id: int) -> dict:
        return self._results[request_id]

    def finished(self, request_id: int) -> bool:
        """Whether the request's result is in (and not yet popped)."""
        return request_id in self._results

    def pop_result(self, request_id: int) -> dict:
        """The request's result, dropped from the engine's store."""
        return self._results.pop(request_id)

    def clear_results(self) -> None:
        """Drop stored results (a persistent server calls this after reading
        each drain's); ids keep increasing."""
        self._results.clear()

    def generate_all(self, prompts: Sequence[Sequence[int]]) -> List[Dict[str, Any]]:
        """Submit every prompt, drain the engine, return ordered results.
        The whole batch is validated before anything is enqueued."""
        for p in prompts:
            self._validate_request(list(p), None)
        ids = [self.submit(p) for p in prompts]
        self.run_until_drained()
        return [self.result(i) for i in ids]

    # -- fused offline drain ---------------------------------------------------
    def generate_all_fused(self, prompts: Sequence[Sequence[int]], max_new_tokens: Optional[Sequence[int]] = None,
                           prefill_lanes: int = 4) -> List[Dict[str, Any]]:
        """Drain a workload known up front with the scheduler on the device.

        The results contract of :meth:`generate_all` (ordered dicts of
        ``tokens`` / ``log_probs`` / ``perplexity`` / ``generation_entropy``),
        the scheduler JAX's ``_fused_drain_fn``: free slots refill from a
        device-side queue by vectorised rank, each iteration either advances
        up to ``prefill_lanes`` pending prefills (lanes chosen on the device,
        padded with the first pending slot) or decodes every active slot
        (``chunk_tokens`` steps, or ``chunk_tokens // (gamma + 1)``
        speculative rounds with a draft model), and emissions scatter
        straight into per-request output buffers. The two iteration programs
        of a (requests, padded prompt, largest budget, lanes) shape are
        built at its first call (see :class:`_FusedDrain`); the host reads a
        2-int flag after each. ``max_new_tokens`` takes one budget per
        prompt. ``prefill_lanes=1`` gives the interactive drain's results
        bit for bit; wider lanes can flip a greedy near-tie in bf16.

        Needs chunked prefill; RAUQ and hidden-state collection are
        interactive-drain features and are rejected, and the prefix cache
        is not consulted (its residency is dropped after the run).
        ``_last_fused_stats`` holds the iteration counts (and, with a draft,
        accepted / proposed / acceptance).
        """
        if not self.prefill_chunk:
            raise ValueError("generate_all_fused requires prefill_chunk")
        if self.collect_rauq:
            raise ValueError(
                "generate_all_fused supports the plain decode path only "
                "(no RAUQ collection)"
            )
        if self.collect_hidden is not None:
            raise ValueError(
                "generate_all_fused does not stream hidden states "
                "(collect_hidden is an interactive-drain feature)"
            )
        if any(r is not None for r in self._slot_req) or self._queue:
            raise RuntimeError("engine has in-flight requests; drain them before a fused run")
        prompts = [list(p) for p in prompts]
        if not prompts:
            return []
        R = len(prompts)
        if max_new_tokens is None:
            budgets = [self.max_new_tokens] * R
        else:
            budgets = [int(b) for b in max_new_tokens]
            if len(budgets) != R:
                raise ValueError("one budget per prompt")
        # lpt: the device queue holds the longest budgets first; the
        # results come back in the caller's order.
        order = list(range(R))
        if self.admission == "lpt":
            order.sort(key=lambda i: -budgets[i])
            prompts = [prompts[i] for i in order]
            budgets = [budgets[i] for i in order]
        C = self.prefill_chunk
        for p, b in zip(prompts, budgets):
            if not p:
                raise ValueError("chunked prefill needs a non-empty prompt")
            if len(p) + b + self._ctx_slack > self.max_ctx:
                raise ValueError(
                    f"prompt of {len(p)} tokens + {b} new "
                    f"(+{self._ctx_slack} speculative slack) exceeds "
                    f"max_ctx={self.max_ctx}"
                )
        P_pad = -(-max(len(p) for p in prompts) // C) * C
        M = max(max(budgets), 1)
        req_tokens = np.zeros((R, P_pad), np.int64)
        for i, p in enumerate(prompts):
            req_tokens[i, :len(p)] = p

        drain = self._fused_cache.get_or_build((R, P_pad, M, int(prefill_lanes)),
                                               lambda: _FusedDrain(self, R, P_pad, M, int(prefill_lanes)))
        with torch.no_grad():
            out_t, out_l, out_e, n_emit, iters = drain.run(
                req_tokens, np.asarray([len(p) for p in prompts], np.int64), np.asarray(budgets, np.int64))
        # The run rewrote cache rows under its own slot schedule: no prompt
        # the interactive scheduler saw is resident any more.
        self._slot_prompt = [None] * self.num_slots
        self._last_fused_stats = {"prefill_iters": int(iters[0]), "decode_iters": int(iters[1])}
        self._stats["prefill_chunks"] += int(iters[0])
        self._stats["decode_chunks"] += int(iters[1])
        if self.draft_model is not None:
            acc, prop = int(iters[2]), int(iters[3])
            self._last_fused_stats.update(accepted=acc, proposed=prop,
                                          acceptance=round(acc / prop, 4) if prop else 0.0)
            self._stats["accepted"] += acc
            self._stats["proposed"] += prop
        results = []
        for i in range(R):
            n = int(n_emit[i])
            toks, lps, ents = [int(t) for t in out_t[i, :n]], out_l[i, :n], out_e[i, :n]
            if self.eos_id is not None and self.eos_id in toks:
                cut = toks.index(self.eos_id)
                toks, lps, ents = toks[:cut], lps[:cut], ents[:cut]
            lps, ents = np.asarray(lps, np.float32), np.asarray(ents, np.float32)
            results.append({
                "tokens": toks,
                "log_probs": lps,
                "prompt_length": len(prompts[i]),
                "perplexity": float(-lps.mean()) if len(toks) else float("nan"),
                "generation_entropy": float(ents.mean()) if len(toks) else float("nan"),
                "entropies": ents,
            })
            self._stats["requests_finished"] += 1
            # What the device emitted, an EOS included, as the interactive
            # drain counts it.
            self._stats["tokens_emitted"] += n
        if self.admission == "lpt":
            undo = [0] * R
            for pos, i in enumerate(order):
                undo[i] = pos
            results = [results[undo[i]] for i in range(R)]
        return results


class _FusedDrain:
    """The fused offline drain of one (R requests, P_pad prompt slots, M
    budget, lanes) shape on one engine: JAX's ``lax.while_loop`` drain, its
    loop on the host.

    Static buffers: the request table (tokens (R, P_pad), lengths, budgets,
    prefill chunks), the scheduler state (per slot: request, write position,
    prefill chunks left, clock, first emission's clock, limit, active; the
    queue head), the outputs (tokens, log-probs, entropies (R + 1, M + 1)
    and emission counts (R + 1,)), the iteration counters [prefill, decode,
    accepted, proposed] and the flag [any prefill pending, done]. JAX's
    dropped scatters land in row R / column M here, and a lane that is not
    on its final chunk writes the engine's spare row S (the clock, start,
    limit and active vectors carry a spare entry S too).

    Two programs: :meth:`prefill_iter` and :meth:`decode_iter` (plain steps
    or speculative rounds), each ending with :meth:`refill` and
    :meth:`set_flag`. On a CUDA engine with ``use_graph`` both are captured
    at the shape's first call, before it runs: their warm-ups run on the
    zeroed scheduler and write only cache rows the drain rewrites before
    attending them (and the spare rows), and the state is reset after. They
    draw from a generator of their own, lent the engine's state for a call.
    """

    def __init__(self, engine: ContinuousBatchingEngine, R: int, P_pad: int, M: int, lanes: int):
        dev, S = engine.device, engine.num_slots
        self.engine, self.R, self.P_pad, self.M, self.W = engine, R, P_pad, M, min(lanes, S)
        self.use_samp = engine.do_sample and engine.draft_model is not None

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.req_tokens, self.req_len, self.req_budget, self.n_chunks = zeros(R, P_pad), zeros(R), zeros(R), zeros(R)
        self.slot_req, self.write_pos, self.pre_rem = zeros(S), zeros(S), zeros(S)
        self.slot_pos, self.start, self.limit = zeros(S + 1), zeros(S + 1), zeros(S + 1)
        self.active = zeros(S + 1, dtype=torch.bool)
        self.qh = zeros(1)
        self.out_t = zeros(R + 1, M + 1)
        self.out_l = zeros(R + 1, M + 1, dtype=torch.float32)
        self.out_e = zeros(R + 1, M + 1, dtype=torch.float32)
        self.n_emit, self.iters, self.flag = zeros(R + 1), zeros(4), zeros(2)
        self.chunk_cols = torch.arange(engine.prefill_chunk, device=dev)
        self.emit_cols = torch.arange(engine.gamma + 1, device=dev)
        cuda = dev.type == "cuda"
        self.flag_host = torch.zeros((2,), dtype=torch.int64, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None
        self.generator = torch.Generator(device=dev) if engine.do_sample else None
        self.programs = None  # (prefill, decode), built at the first call
        self.flag_reads = 0  # of the last call

    def reset(self) -> None:
        for t in (self.slot_req, self.write_pos, self.pre_rem, self.slot_pos, self.start, self.limit, self.active,
                  self.qh, self.out_t, self.out_e, self.n_emit, self.iters):
            t.zero_()
        self.out_l.fill_(float("-inf"))

    def refill(self) -> None:
        """Vectorised admission: the i-th free slot (by rank among the free
        ones) takes request qh + i."""
        S, R = self.engine.num_slots, self.R
        free = ~self.active[:S] & (self.pre_rem == 0)
        n_free = free.to(torch.int64)
        at = self.qh + torch.cumsum(n_free, 0) - 1
        take = free & (at < R)
        r_new = at.clamp(0, R - 1)
        self.slot_req.copy_(torch.where(take, r_new, self.slot_req))
        self.write_pos.copy_(torch.where(take, 0, self.write_pos))
        self.pre_rem.copy_(torch.where(take, self.n_chunks[r_new], self.pre_rem))
        self.qh.add_(torch.minimum(n_free.sum(), (R - self.qh).clamp_min(0)))

    def set_flag(self) -> None:
        S = self.engine.num_slots
        pending = (self.pre_rem > 0).any()
        done = (self.qh[0] >= self.R) & ~self.active[:S].any() & ~pending
        self.flag.copy_(torch.stack([pending, done]).to(torch.int64))

    def prefill_iter(self) -> None:
        """Advance up to W pending prefills by one chunk in one (W, C)
        forward (and the draft's), lanes chosen on the device: the first W
        pending slots, padded with the first one (duplicate lanes compute
        and write identical rows)."""
        e = self.engine
        S, C, W = e.num_slots, e.prefill_chunk, self.W
        pending = self.pre_rem > 0
        order = torch.argsort((~pending).to(torch.int32), stable=True)
        lanes = torch.where(pending[order[:W]], order[:W], order[0])
        r_l, w_l = self.slot_req[lanes], self.write_pos[lanes]
        # dynamic_slice's clamp keeps the C-token window inside the table.
        cols = w_l.clamp(max=self.P_pad - C)[:, None] + self.chunk_cols[None, :]
        tokens = self.req_tokens[r_l[:, None], cols]
        logits, _ = _prefill_rows(e.model, e.cache, lanes, tokens, w_l)
        if e.draft_model is not None:
            _prefill_rows(e.draft_model, e.d_cache, lanes, tokens, w_l, last_logits_only=True)
        rem = self.pre_rem[lanes]
        r_len = self.req_len[r_l]
        last_idx = (r_len - 1 - w_l).clamp(0, C - 1)
        sel = logits.gather(1, last_idx[:, None, None].expand(W, 1, logits.shape[-1]))[:, 0]
        target = torch.where(rem == 1, lanes, S)
        e.step_logits.index_copy_(0, target, sel)
        if self.use_samp:
            e.samp_logp.index_copy_(0, target, torch.log_softmax(sel / e.temperature, dim=-1))
        self.slot_pos.index_copy_(0, target, r_len)
        self.start.index_copy_(0, target, r_len)
        self.limit.index_copy_(0, target, r_len + self.req_budget[r_l])
        self.active.index_fill_(0, target, True)
        self.write_pos.index_copy_(0, lanes, w_l + C)
        self.pre_rem.index_copy_(0, lanes, rem - 1)
        self.iters[0] += 1
        self.refill()
        self.set_flag()

    def decode_iter(self) -> None:
        """Every active slot decodes: ``chunk_tokens`` steps, or
        ``chunk_tokens // (gamma + 1)`` speculative rounds; emissions go
        straight into the output rows of their requests."""
        e = self.engine
        S, R, M = e.num_slots, self.R, self.M
        slot_req, start, limit = self.slot_req, self.start[:S], self.limit[:S]
        slot_pos, active = self.slot_pos[:S], self.active[:S]
        step_logits = e.step_logits[:S]
        if e.draft_model is not None:
            samp_logp = e.samp_logp[:S] if self.use_samp else None
            gamma, idxs = e.gamma, self.emit_cols[None, :]
            acc = torch.zeros((2,), dtype=torch.int64, device=e.device)
            for _ in range(e._rounds):
                out = _spec_round(e.model, e.draft_model, gamma, e.eos_id, self.use_samp, e.temperature, e.cache,
                                  e.d_cache, step_logits, samp_logp, slot_pos, active, limit,
                                  generator=self.generator)
                emit, take = out["emit"], out["take"]
                base = slot_pos - start
                e_idx = torch.where(emit, base[:, None] + idxs, M)
                r_idx = torch.where(emit, slot_req[:, None], R)
                self.out_t.index_put_((r_idx, e_idx), torch.where(emit, out["block"], 0))
                self.out_l.index_put_((r_idx, e_idx), out["lps"])
                self.out_e.index_put_((r_idx, e_idx), out["ents"])
                self.n_emit.index_put_((torch.where(take > 0, slot_req, R),), base + take)
                acc = acc + torch.stack([torch.where(active, out["n_acc"], 0).sum(),
                                         torch.where(active, gamma, 0).sum()])
                step_logits, samp_logp = out["step_logits"], out["samp_logp"]
                slot_pos, active = out["slot_pos"], out["active"]
            if samp_logp is not None:
                e.samp_logp[:S].copy_(samp_logp)
            self.iters[2:].add_(acc)
        else:
            for _ in range(max(1, e.chunk_tokens)):
                log_soft = torch.log_softmax(step_logits, dim=-1)
                if e.do_sample:
                    token = sample_logits(step_logits, self.generator, e.temperature, e.top_k, e.top_p)
                else:
                    token = torch.argmax(step_logits, dim=-1)
                lp = log_soft.gather(1, token[:, None])[:, 0]
                emitted = active & (slot_pos < limit)
                token = torch.where(emitted, token, 0)
                ent = _vocab_norm_entropy(log_soft)
                if e.eos_id is not None:
                    active = active & (token != e.eos_id)
                e_idx = torch.where(emitted, slot_pos - start, M)
                r_idx = torch.where(emitted, slot_req, R)
                self.out_t.index_put_((r_idx, e_idx), token)
                self.out_l.index_put_((r_idx, e_idx), lp)
                self.out_e.index_put_((r_idx, e_idx), ent)
                self.n_emit.index_put_((r_idx,), slot_pos - start + 1)
                # A finished slot's clock may sit at max_ctx: its write
                # clamps into the cache, as dynamic_update_slice's does.
                new_logits = e.model(token[:, None], e.cache, slot_pos.clamp(max=e.max_ctx - 1),
                                     need_attentions=False, need_hiddens=False)[0]
                slot_pos = slot_pos + emitted.to(torch.int64)
                active = active & (slot_pos < limit)
                step_logits = torch.where(emitted[:, None], new_logits[:, 0], step_logits)
        e.step_logits[:S].copy_(step_logits)
        self.slot_pos[:S].copy_(slot_pos)
        self.active[:S].copy_(active)
        self.iters[1] += 1
        self.refill()
        self.set_flag()

    def read_flag(self) -> tuple:
        """(any prefill pending, done): the host's one wait an iteration."""
        self.flag_reads += 1
        if self.event is None:
            return tuple(bool(v) for v in self.flag.tolist())
        self.flag_host.copy_(self.flag, non_blocking=True)
        self.event.record()
        with host_sync(self.engine.device):
            self.event.synchronize()
        return tuple(bool(v) for v in self.flag_host.tolist())

    def run(self, req_tokens: np.ndarray, req_len: np.ndarray, req_budget: np.ndarray):
        """Load the request table, drain, and return host copies of the
        outputs (tokens, log-probs, entropies (R, M), emission counts (R,))
        and the iteration counters."""
        e = self.engine
        dev = e.device
        self.req_tokens.copy_(upload(req_tokens, dev))
        self.req_len.copy_(upload(req_len, dev))
        self.req_budget.copy_(upload(req_budget, dev))
        self.n_chunks.copy_((self.req_len + e.prefill_chunk - 1) // e.prefill_chunk)
        if self.programs is None:
            gens = [self.generator] if self.generator is not None else []
            self.reset()
            self.programs = (_Program(self.prefill_iter, dev, e.use_graph, gens),
                             _Program(self.decode_iter, dev, e.use_graph, gens))
        self.reset()
        self.refill()
        self.set_flag()
        self.flag_reads = 0
        lend = drawing_from(self.generator, e.generator) if self.generator is not None else contextlib.nullcontext()
        with lend:
            while True:
                pending, done = self.read_flag()
                if done:
                    break
                self.programs[0 if pending else 1]()
        R, M = self.R, self.M
        return copy_to_host(self.out_t[:R, :M], self.out_l[:R, :M], self.out_e[:R, :M], self.n_emit[:R],
                            self.iters)
