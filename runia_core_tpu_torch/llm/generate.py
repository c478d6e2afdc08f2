"""The generation backends of the port's LLM uncertainty scores.

Counterpart of ``runia_core_tpu/llm/generate.py``. :func:`run_generation`
dispatches as the JAX package does: to a :class:`TorchGenerator`, to a
``llm/speculative.py::SpeculativeGenerator`` (greedy pass on its target,
samples from the fused speculative loop) or to an HF model's ``generate``.
:class:`TorchGenerator` is the port's ``JaxGenerator``: a KV-cached decode
loop over any of the port's decoder LMs (``LlamaLM``, ``CausalLM``,
``NeoXLM``) that returns HF-shaped numpy structures
(``scores`` a tuple of (S, V), ``attentions`` a tuple over steps of
per-layer (S, H, tgt, src), ``hidden_states`` a tuple over steps of
per-layer (S, tgt, D)), so every score in ``llm/scores.py`` reads it as it
reads an HF model's output. The step after the last sampled token is not
run: its outputs are never read.

Two routes, as ``JaxGenerator(use_scan=)``:

* ``use_scan=True`` (the default): the decode steps are one program, the
  counterpart of JAX's ``lax.scan`` (``_scanned_decode`` and the batch
  program). A :class:`_DecodeProgram` holds the cache, the step's logits,
  ``finished``, the step index (a device tensor) and the stacked (T, ...)
  outputs in static buffers, and one step function samples, writes row
  ``step`` of the outputs, runs the model on the per-row cache path at
  ``cache_index = P + step`` and advances the step. On a CUDA device that
  step is captured once into a CUDA graph (``utils/graphs.py``) and
  replayed T - 1 times, with no host sync until the results' copy to the
  host; on the CPU the same function runs without capture. Programs are
  kept in the JAX package's LRU program cache (``_PROGRAM_CACHE``, 64
  entries), under the JAX keys with the device and the model added. Where
  JAX keys on the prompt length, the port keys on it rounded up to a
  multiple of ``_PROMPT_BUCKET``: the length itself is a device input, and
  the cache's slots past a row's last token are masked, so one program
  serves every prompt length of its bucket. A program holds device buffers
  (the KV cache, the stacked outputs), so the cache also drops the least
  recently used past ``_PROGRAM_CACHE_BYTES`` of them, holds the model
  weakly and forgets a model's programs when the model goes. A sampling
  program draws from a generator of its own, lent the caller's state for
  the call (``utils.graphs.drawing_from``), so any generator object reuses
  it. The prompt's prefill stays eager: it runs once a call.
* ``use_scan=False``: the eager loop, a Python loop over the steps whose
  outputs stay on the device until the loop ends.

Random draws come from a ``torch.Generator``. ``sample_logits`` splits the
HF top-k/top-p/temperature filter (:func:`filter_logits`) from the draw, an
argmax over the filtered logits plus Gumbel noise (what
``jax.random.categorical`` does), so a test can hand both frameworks the
same noise. The two frameworks' random streams differ by design; the two
routes of the port draw the same numbers from the same generator state.
"""

from __future__ import annotations

import contextlib
import math
import warnings
import weakref
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from runia_core_tpu_torch.models.transformer import init_cache
from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, copy_to_host, drawing_from, upload

__all__ = [
    "TorchGenerator",
    "filter_logits",
    "run_generation",
    "sample_logits",
    "validate_generation_request",
]


def filter_logits(
    logits: torch.Tensor, temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0
) -> torch.Tensor:
    """HF sampling filters on (..., V) logits, -inf outside the support.

    ``top_k=0`` and ``top_p=1.0`` disable the filters. Top-k (clamped to V)
    keeps the k highest logits; top-p then keeps the smallest set of the
    survivors whose probability reaches ``top_p``, the crossing token and
    the top token always included.
    """
    logits = logits / temperature
    if top_k:
        kth = torch.topk(logits, min(int(top_k), logits.shape[-1]), dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_desc, torch.full_like(sorted_desc, float("inf"))).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Token ids drawn from (..., V) logits: argmax(filtered + Gumbel noise).

    ``noise`` (the logits' shape) replaces the Gumbel draw from
    ``generator``."""
    filtered = filter_logits(logits, temperature, top_k, top_p)
    if noise is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        noise = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(filtered + noise, dim=-1)


# The JAX package's program cache: programs are built once per key and kept,
# least recently used dropped past 64, or past 4 GiB of the programs' device
# buffers (a batch program of 16 x 64 + 256 with scores holds about 1 GB).
_PROGRAM_CACHE_MAX = 64
_PROGRAM_CACHE_BYTES = 4 << 30
_PROGRAM_CACHE = ProgramCache(_PROGRAM_CACHE_MAX, _PROGRAM_CACHE_BYTES)
_PROMPT_BUCKET = 64  # a program's prompt slots: the prompt length rounded up to a multiple of this


def _cached_program(key: tuple, build):
    return _PROGRAM_CACHE.get_or_build(key, build)


def _cache_put(key: tuple, program) -> None:
    _PROGRAM_CACHE.put(key, program)


def _forget_model(ref: weakref.ref) -> None:
    """A model went: drop its programs (their graphs read its weights)."""
    _PROGRAM_CACHE.discard(lambda key: len(key) > 2 and key[2] is ref)


def _next_token(step_logits, finished, eos_id, do_sample, generator, temperature, top_k, top_p):
    """One sampling step: (token, its log-probability, finished)."""
    log_soft = torch.log_softmax(step_logits, dim=-1)
    if do_sample:
        token = sample_logits(step_logits, generator, temperature, top_k, top_p)
    else:
        token = torch.argmax(step_logits, dim=-1)
    lp = log_soft.gather(1, token[:, None])[:, 0]
    lp = lp.masked_fill(finished, float("-inf"))
    if eos_id is not None:
        # Pad with EOS once finished, as the HF backend strips it.
        token = token.masked_fill(finished, eos_id)
        finished = finished | (token == eos_id)
    return token, lp, finished


def _bucket(prompt_len: int) -> int:
    """A program's prompt slots: ``prompt_len`` rounded up to a multiple of
    ``_PROMPT_BUCKET``."""
    return -(-prompt_len // _PROMPT_BUCKET) * _PROMPT_BUCKET


class _DecodeProgram:
    """The decode steps of one key as one program: the port's
    ``_scanned_decode``.

    Static buffers: the KV cache of ``rows`` rows and ``prompt_slots +
    max_new`` slots, the step's logits (rows, V), ``finished``, the step
    index and the call's prompt length P (0-d device tensors), with
    ``batch_inputs`` the ``kv_valid`` (rows, slots) mask and the prompt
    lengths, and the stacked outputs: tokens and log-probs (T, rows), with
    ``out_scores`` the logits (T, rows, V), with ``out_prev`` each step's
    attention on the previous token (T-1, L, rows, H), with ``out_attn`` the
    attention rows (T-1, L, rows, H, slots), with ``out_hid`` the hidden
    rows (T-1, L+1, rows, D). Step ``i`` writes slot ``P + i``; the slots
    past it are masked (causal), so any P up to ``prompt_slots`` fits.

    A call loads the cache (the prefill writes it), the logits, P and the
    batch inputs, then :meth:`run` takes every step. On a CUDA device
    :meth:`step` is captured once, when the program is built (its warm-up
    runs on the buffers before any call loads them), and replayed. Draws
    come from the program's own generator, which :meth:`run` lends the
    caller's state. The model is held weakly: the cache drops a program
    whose model went.
    """

    def __init__(self, model, rows: int, prompt_slots: int, max_new: int, eos_id, do_sample: bool,
                 temperature: float, top_k: int, top_p: float, batch_inputs: bool,
                 out_scores: bool = False, out_prev: bool = False, out_attn: bool = False, out_hid: bool = False):
        dev = next(model.parameters()).device
        total = prompt_slots + max_new
        self._model = weakref.ref(model)
        self.rows, self.prompt_slots, self.max_new = rows, prompt_slots, max_new
        self.generator = torch.Generator(device=dev) if do_sample else None
        self.sampling = (eos_id, do_sample, temperature, top_k, top_p)
        self.out_prev, self.out_attn, self.out_hid = out_prev, out_attn, out_hid
        self.cache = init_cache(model, rows, total, dev)
        self.kv_valid = torch.zeros((rows, total), dtype=torch.bool, device=dev) if batch_inputs else None
        self.lengths = torch.zeros((rows,), dtype=torch.int64, device=dev) if batch_inputs else None
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        # Until a call loads P, the full bucket: the warm-up's step then
        # reads and writes slots inside the buffers.
        self.prompt_len = torch.full((), prompt_slots, dtype=torch.int64, device=dev)
        self.logits = torch.zeros((rows, model.vocab_size), dtype=torch.float32, device=dev)
        self.finished = torch.zeros((rows,), dtype=torch.bool, device=dev)
        self.tokens = torch.zeros((max_new, rows), dtype=torch.int64, device=dev)
        self.log_probs = torch.zeros((max_new, rows), dtype=torch.float32, device=dev)
        self.scores = torch.zeros((max_new, rows, model.vocab_size), device=dev) if out_scores else None
        layers, heads, steps = model.num_layers, model.num_heads, max_new - 1
        self.prev = torch.zeros((steps, layers, rows, heads), device=dev) if out_prev else None
        self.attn = torch.zeros((steps, layers, rows, heads, total), device=dev) if out_attn else None
        self.hid = torch.zeros((steps, layers + 1, rows, model.d_model), device=dev) if out_hid else None
        self.nbytes = sum(t.numel() * t.element_size() for layer in self.cache["layers"] for t in layer.values())
        self.nbytes += sum(t.numel() * t.element_size() for t in (
            self.kv_valid, self.lengths, self.logits, self.tokens, self.log_probs, self.scores, self.prev,
            self.attn, self.hid) if t is not None)
        self.graph = None
        if dev.type == "cuda" and max_new > 1:
            # One warm-up step: a second would write output row 1, past the
            # (T-1)-row taps of a two-token program.
            self.graph = CudaGraph(self.step, generators=[self.generator] if do_sample else [], device=dev,
                                   warmup=1)

    @property
    def model(self):
        return self._model()

    def _sample(self) -> torch.Tensor:
        """Sample from the step's logits into row ``index`` of the outputs."""
        eos_id, do_sample, temperature, top_k, top_p = self.sampling
        token, lp, finished = _next_token(self.logits, self.finished, eos_id, do_sample, self.generator,
                                          temperature, top_k, top_p)
        self.finished.copy_(finished)
        at = self.index.view(1)
        self.tokens.index_copy_(0, at, token[None])
        self.log_probs.index_copy_(0, at, lp[None])
        if self.scores is not None:
            self.scores.index_copy_(0, at, self.logits[None])
        return token

    def step(self) -> None:
        """One decode step: sample, run the model on the token at slot
        ``P + index`` of every row, keep its taps, advance."""
        token = self._sample()
        slot = self.index + self.prompt_len
        positions = None
        if self.kv_valid is not None:
            self.kv_valid.index_fill_(1, slot.view(1), True)
            positions = (self.lengths + self.index)[:, None]
        out, attn, hid, _ = self.model(
            token[:, None], self.cache, slot.expand(self.rows), token_valid=self.kv_valid, positions=positions,
            need_attentions=self.out_prev or self.out_attn, need_hiddens=self.out_hid,
        )
        self.logits.copy_(out[:, 0])
        at = self.index.view(1)
        if self.out_prev:
            # (L, B, H, 1, total): the column of the previous token.
            self.prev.index_copy_(0, at, attn[:, :, :, 0].index_select(-1, (slot - 1).view(1))[None, ..., 0])
        if self.out_attn:
            self.attn.index_copy_(0, at, attn[None, :, :, :, 0])
        if self.out_hid:
            self.hid.index_copy_(0, at, hid[None, :, :, 0])
        self.index.add_(1)

    def run(self, generator: Optional[torch.Generator]) -> None:
        """Every step from the loaded state: T - 1 steps (replays on a GPU),
        then the last sample, drawing from ``generator``'s state."""
        self.finished.zero_()
        self.index.zero_()
        with drawing_from(self.generator, generator) if self.generator is not None else contextlib.nullcontext():
            for _ in range(self.max_new - 1):
                if self.graph is not None:
                    self.graph.replay()
                else:
                    self.step()
            self._sample()


def _batch_result(tokens, lengths, toks, lps, scores, prev) -> Dict[str, Any]:
    """generate_batch's result from host arrays: toks, lps (T, B), scores
    (T, B, V) and prev (T-1, L, B, H), each None where not asked for."""
    result = {
        "sequences": np.concatenate([tokens, toks.T], axis=1),
        "scores": () if scores is None else tuple(scores),
        "log_probs": lps.T,
        "prompt_lengths": lengths.astype(np.int32),
    }
    if prev is not None:
        result["prev_token_attention"] = np.transpose(prev, (2, 1, 3, 0))  # (B, L, H, T-1)
    return result


def _generate_result(prompt_np, s, toks, lps, scores, attn0, hid0, attn_rows, hidden_rows) -> Dict[str, Any]:
    """generate's result from host arrays: toks, lps (T, S), scores (T, S,
    V), the prompt's attn0 (L, H, P, P) and hid0 (L+1, P, D) at batch 1 (or
    None where not asked for), attn_rows (T-1, L, S, H, total) and
    hidden_rows (T-1, L+1, S, D)."""
    p = prompt_np.shape[1]
    attentions, hidden_states = [], []
    if attn0 is not None:
        attentions.append(tuple(np.broadcast_to(a, (s,) + a.shape) for a in attn0))
        for step, rows in enumerate(attn_rows):
            attentions.append(tuple(r[:, :, None, : p + step + 1] for r in rows))
    if hid0 is not None:
        hidden_states.append(tuple(np.broadcast_to(h, (s,) + h.shape) for h in hid0))
        for rows in hidden_rows:
            hidden_states.append(tuple(h[:, None, :] for h in rows))
    return {
        "sequences": np.concatenate([np.repeat(prompt_np, s, 0), toks.T], axis=1),
        "scores": tuple(scores),
        "attentions": tuple(attentions),
        "hidden_states": tuple(hidden_states),
        "log_probs": lps.T,
    }


class TorchGenerator:
    """A LlamaLM and its decode configuration.

    ``generator`` is the default source of random draws (a
    ``torch.Generator`` on the model's device, seeded 0 if not given).
    ``use_scan`` runs the decode steps as one program (see the module doc);
    False keeps the eager loop.
    """

    def __init__(
        self,
        model,
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        use_scan: bool = True,
    ):
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.use_scan = use_scan
        self.device = next(model.parameters()).device
        self.generator = generator or torch.Generator(device=self.device).manual_seed(0)

    def _check_context(self, total: int) -> None:
        limit = getattr(self.model, "max_len", None)
        if limit and total > limit:
            warnings.warn(
                f"generation length {total} exceeds the model's trained context window "
                f"max_len={limit}; quality degrades beyond it",
                stacklevel=3,
            )

    def _program(self, kind: str, shape_key: tuple, do_sample: bool, **build) -> _DecodeProgram:
        """The cached program of a key: JAX's (kind, model, EOS id, shapes
        and flags, the prompt length bucketed) with the device; the model
        is held weakly."""
        key = (kind, self.device, weakref.ref(self.model, _forget_model), self.eos_id) + shape_key
        return _cached_program(key, lambda: _DecodeProgram(self.model, eos_id=self.eos_id, do_sample=do_sample,
                                                           **build))

    @torch.no_grad()
    def generate_batch(
        self,
        prompts: Sequence[Sequence[int]],
        do_sample: bool = False,
        temperature: float = 1.0,
        generator: Optional[torch.Generator] = None,
        max_new_tokens: Optional[int] = None,
        pad_id: int = 0,
        output_attentions: bool = False,
        output_scores: bool = True,
        pad_to: Optional[int] = None,
        top_k: int = 0,
        top_p: float = 1.0,
    ) -> Dict[str, Any]:
        """Decode a batch of different prompts, left-padded to one length.

        Returns sequences (B, P+T), scores (T-tuple of (B, V); empty with
        ``output_scores=False``), log_probs (B, T), prompt_lengths (B,), and
        with ``output_attentions`` the previous-token attention
        ``prev_token_attention`` (B, L, H, T-1) that ``batched_rauq`` reads.
        A batch of equal lengths prefills without a padding mask, so a
        ``use_flash`` model takes the flash route.
        """
        max_new = max_new_tokens or self.max_new_tokens
        model, dev, gen = self.model, self.device, generator or self.generator
        b = len(prompts)
        lengths = np.array([len(p) for p in prompts], np.int64)
        p = max(int(lengths.max()), int(pad_to or 0))
        tokens = np.full((b, p), pad_id, np.int64)
        valid = np.zeros((b, p), bool)
        for i, seq in enumerate(prompts):
            tokens[i, p - len(seq):] = seq
            valid[i, p - len(seq):] = True
        self._check_context(p + max_new)
        uniform = bool((lengths == p).all())
        if not self.use_scan:
            return self._eager_batch(tokens, valid, lengths, max_new, do_sample, temperature, gen,
                                     output_attentions, output_scores, top_k, top_p)

        slots = _bucket(p)
        prog = self._program(
            "batch", (b, slots, max_new, do_sample, float(temperature), output_attentions, output_scores, uniform,
                      int(top_k), float(top_p)), do_sample,
            rows=b, prompt_slots=slots, max_new=max_new, temperature=temperature, top_k=top_k, top_p=top_p,
            batch_inputs=True, out_scores=output_scores, out_prev=output_attentions,
        )
        kv_valid = np.zeros((b, slots + max_new), bool)
        kv_valid[:, :p] = valid
        prog.kv_valid.copy_(upload(kv_valid, dev))
        prog.lengths.copy_(upload(lengths, dev))
        prog.prompt_len.fill_(p)
        prefill_kwargs = {}
        if not uniform:
            positions = torch.clamp_min(torch.cumsum(prog.kv_valid[:, :p].to(torch.int64), dim=1) - 1, 0)
            prefill_kwargs = {"token_valid": prog.kv_valid, "positions": positions}
        logits, _, _, _ = model(
            upload(tokens, dev), prog.cache, 0, **prefill_kwargs, need_attentions=False, need_hiddens=False,
            last_logits_only=True,
        )
        prog.logits.copy_(logits[:, -1])
        prog.run(gen)
        return _batch_result(tokens, lengths, *copy_to_host(prog.tokens, prog.log_probs, prog.scores, prog.prev))

    def _eager_batch(self, tokens, valid, lengths, max_new, do_sample, temperature, gen, output_attentions,
                     output_scores, top_k, top_p) -> Dict[str, Any]:
        """generate_batch's eager loop (``use_scan=False``)."""
        model, dev = self.model, self.device
        b, p = tokens.shape
        prompt = torch.from_numpy(tokens).to(dev)
        kv_valid = torch.zeros((b, p + max_new), dtype=torch.bool, device=dev)
        kv_valid[:, :p] = torch.from_numpy(valid).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        cache = init_cache(model, b, p + max_new, dev)
        prefill_kwargs = {}
        if not (lengths == p).all():
            positions = torch.clamp_min(torch.cumsum(kv_valid[:, :p].to(torch.int64), dim=1) - 1, 0)
            prefill_kwargs = {"token_valid": kv_valid, "positions": positions}
        logits, _, _, cache = model(
            prompt, cache, 0, **prefill_kwargs, need_attentions=False, need_hiddens=False, last_logits_only=True
        )
        step_logits = logits[:, -1]
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        toks, lps, scores, prev = [], [], [], []
        for step in range(max_new):
            token, lp, finished = _next_token(step_logits, finished, self.eos_id, do_sample, gen, temperature,
                                              top_k, top_p)
            toks.append(token)
            lps.append(lp)
            if output_scores:
                scores.append(step_logits)
            if step == max_new - 1:
                break
            kv_valid[:, p + step] = True
            step_out, attn, _, cache = model(
                token[:, None], cache, p + step, token_valid=kv_valid, positions=(lengths_t + step)[:, None],
                need_attentions=output_attentions, need_hiddens=False,
            )
            if output_attentions:
                # (L, B, H, 1, total): the column of the previous token.
                prev.append(attn[:, :, :, 0, p - 1 + step])
            step_logits = step_out[:, 0]

        prev_np = None
        if output_attentions:
            prev_np = torch.stack(prev).cpu().numpy() if prev else np.zeros((0, model.num_layers, b, model.num_heads))
        return _batch_result(
            tokens, lengths, torch.stack(toks).cpu().numpy(), torch.stack(lps).cpu().numpy(),
            torch.stack(scores).cpu().numpy() if output_scores else None, prev_np,
        )

    @torch.no_grad()
    def generate(
        self,
        prompt_tokens: Sequence[int],
        num_return_sequences: int = 1,
        do_sample: bool = False,
        temperature: float = 1.0,
        generator: Optional[torch.Generator] = None,
        max_new_tokens: Optional[int] = None,
        output_attentions: bool = True,
        output_hidden_states: bool = True,
        top_k: int = 0,
        top_p: float = 1.0,
    ) -> Dict[str, Any]:
        """Decode S samples of one prompt with per-step taps.

        Returns sequences (S, P+T), scores (T-tuple of (S, V)), attentions
        and hidden_states (HF-shaped tuples over steps, empty when not
        asked for) and log_probs (S, T). The prompt runs once at batch 1 and
        its cache is copied out to S rows, which then diverge; its step-0
        attentions and hidden states are read-only views that repeat one
        row S times (copy before writing).
        """
        max_new = max_new_tokens or self.max_new_tokens
        model, dev, gen = self.model, self.device, generator or self.generator
        s = num_return_sequences
        prompt_np = np.asarray(prompt_tokens, np.int64)[None, :]
        p = prompt_np.shape[1]
        self._check_context(p + max_new)
        if not self.use_scan:
            return self._eager_generate(prompt_np, s, max_new, do_sample, temperature, gen, output_attentions,
                                        output_hidden_states, top_k, top_p)

        slots = _bucket(p)
        prog = self._program(
            "scan", (slots, max_new, s, do_sample, float(temperature), output_attentions, output_hidden_states,
                     int(top_k), float(top_p)), do_sample,
            rows=s, prompt_slots=slots, max_new=max_new, temperature=temperature, top_k=top_k, top_p=top_p,
            batch_inputs=False, out_scores=True, out_attn=output_attentions, out_hid=output_hidden_states,
        )
        cache = init_cache(model, 1, p + max_new, dev)
        logits, attn0, hid0, cache = model(
            upload(prompt_np, dev), cache, 0, need_attentions=output_attentions,
            need_hiddens=output_hidden_states, last_logits_only=True,
        )
        for dst, src in zip(prog.cache["layers"], cache["layers"]):
            for name, buf in src.items():
                dst[name][:, :p].copy_(buf[:, :p])  # the one prompt row to all S rows
        prog.logits.copy_(logits[:, -1].expand(s, -1))
        prog.prompt_len.fill_(p)
        prog.run(gen)
        return _generate_result(prompt_np, s, *copy_to_host(
            prog.tokens, prog.log_probs, prog.scores, attn0[:, 0, :, :, :p] if output_attentions else None,
            hid0[:, 0] if output_hidden_states else None, prog.attn, prog.hid,
        ))

    def _eager_generate(self, prompt_np, s, max_new, do_sample, temperature, gen, output_attentions,
                        output_hidden_states, top_k, top_p) -> Dict[str, Any]:
        """generate's eager loop (``use_scan=False``)."""
        model, dev = self.model, self.device
        p = prompt_np.shape[1]
        cache = init_cache(model, 1, p + max_new, dev)
        logits, attn0, hid0, cache = model(
            torch.from_numpy(prompt_np).to(dev), cache, 0, need_attentions=output_attentions,
            need_hiddens=output_hidden_states, last_logits_only=True,
        )
        cache = {"layers": [
            {name: buf.expand(s, *buf.shape[1:]).clone() for name, buf in layer.items()}
            for layer in cache["layers"]
        ]}
        step_logits = logits[:, -1].expand(s, -1)
        finished = torch.zeros((s,), dtype=torch.bool, device=dev)
        toks, lps, scores, attn_rows, hidden_rows = [], [], [], [], []
        for step in range(max_new):
            token, lp, finished = _next_token(step_logits, finished, self.eos_id, do_sample, gen, temperature,
                                              top_k, top_p)
            toks.append(token)
            lps.append(lp)
            scores.append(step_logits)
            if step == max_new - 1:
                break
            step_out, attn, hiddens, cache = model(
                token[:, None], cache, p + step, need_attentions=output_attentions,
                need_hiddens=output_hidden_states,
            )
            if output_attentions:
                attn_rows.append(attn[:, :, :, 0, :])  # (L, S, H, total)
            if output_hidden_states:
                hidden_rows.append(hiddens[:, :, 0, :])  # (L+1, S, D)
            step_logits = step_out[:, 0]

        def stacked(rows):
            return torch.stack(rows).cpu().numpy() if rows else ()

        return _generate_result(
            prompt_np, s, torch.stack(toks).cpu().numpy(), torch.stack(lps).cpu().numpy(),
            torch.stack(scores).cpu().numpy(),
            attn0[:, 0, :, :, :p].cpu().numpy() if output_attentions else None,
            hid0[:, 0].cpu().numpy() if output_hidden_states else None,
            stacked(attn_rows), stacked(hidden_rows),
        )


def _strip_eos(ids, eos_id):
    """Drop EOS and everything after it (HF ``skip_special_tokens``)."""
    if eos_id is None:
        return list(ids)
    ids = list(ids)
    return ids[: ids.index(eos_id)] if eos_id in ids else ids


def _sampling_kwargs(gen_config) -> Dict[str, Any]:
    """The sampling fields TorchGenerator honours (temperature, top_k,
    top_p) from an HF-style GenerationConfig object or dict; beam search and
    penalties are not supported and are ignored."""
    if gen_config is None:
        return {}
    if isinstance(gen_config, dict):
        get = gen_config.get
    else:
        def get(key):
            return getattr(gen_config, key, None)
    kinds = {"temperature": float, "top_k": int, "top_p": float}
    return {key: kind(get(key)) for key, kind in kinds.items() if get(key) is not None}


def validate_generation_request(model, needs_sampling: bool, needs_hiddens: bool) -> None:
    """Raise before any decode work if the backend cannot serve the request:
    ``compute_uncertainties`` calls this on the whole request list. A
    :class:`TorchGenerator` emits every tap the scores read; a
    ``SpeculativeGenerator``'s fused loop emits no hidden states (so no
    ``eigen_score``) and samples only when built with ``do_sample=True``;
    an HF model (anything else with ``generate``) is taken as it is."""
    from runia_core_tpu_torch.llm.speculative import SpeculativeGenerator

    if isinstance(model, SpeculativeGenerator):
        if needs_sampling and needs_hiddens:
            raise ValueError(
                "eigen_score needs sampled hidden states, which the fused speculative loop does not emit; "
                "pass a TorchGenerator instead"
            )
        if needs_sampling and not model.do_sample:
            raise ValueError("sampled uncertainty scores need SpeculativeGenerator(do_sample=True)")
    elif not isinstance(model, TorchGenerator) and not hasattr(model, "generate"):
        raise TypeError(
            f"unsupported generation backend {type(model).__name__}; pass a TorchGenerator, a "
            "SpeculativeGenerator or a transformers model with generate"
        )


def _torch_generation(generator, tokenizer, prompt, gen_config, num_samples, needs_sampling,
                      needs_attentions=True, needs_hiddens=True):
    """The two phases on a TorchGenerator: a greedy pass (attention taps
    only if ``needs_attentions``, for RAUQ) and, if ``needs_sampling``,
    ``num_samples`` sampled continuations honouring ``gen_config``'s
    temperature/top_k/top_p (hidden states only if ``needs_hiddens``, for
    eigen_score)."""
    encode = getattr(tokenizer, "encode", None)
    decode = getattr(tokenizer, "decode", None)
    prompt_tokens = encode(prompt) if encode else prompt
    input_length = len(prompt_tokens)
    det = generator.generate(
        prompt_tokens, num_return_sequences=1, do_sample=False,
        output_attentions=needs_attentions, output_hidden_states=False,
    )
    det_ids = _strip_eos(det["sequences"][0, input_length:].tolist(), generator.eos_id)
    deterministic_text = [decode(det_ids) if decode else det_ids]
    deterministic = {
        "log_probs": det["log_probs"],
        "logits": det["scores"],
        "attentions": det["attentions"],
        "input_length": input_length,
        "text": deterministic_text,
    }
    sampled = {"log_probs": None, "hidden_states": None, "texts": None}
    if needs_sampling:
        samp = generator.generate(
            prompt_tokens, num_return_sequences=num_samples, do_sample=True,
            output_attentions=False, output_hidden_states=needs_hiddens, **_sampling_kwargs(gen_config),
        )
        ids = [_strip_eos(row[input_length:].tolist(), generator.eos_id) for row in samp["sequences"]]
        sampled = {
            "log_probs": samp["log_probs"],
            "hidden_states": samp["hidden_states"],
            "texts": [decode(t) for t in ids] if decode else ids,
        }
    return deterministic, sampled, deterministic_text


def _speculative_generation(spec, tokenizer, prompt, gen_config, num_samples, needs_sampling,
                            needs_attentions=True):
    """The SpeculativeGenerator backend: the greedy pass through a
    TorchGenerator on the TARGET (``spec.greedy_generator``; it gives RAUQ
    its attention taps), the sampled pass through the fused speculative loop
    (``generate_samples``; log-probs -inf past each sample's end, no hidden
    states). As in JAX, ``gen_config`` does not steer the sampling, which
    the generator's construction fixes; a ``gen_config`` whose settings
    conflict with it warns."""
    requested = _sampling_kwargs(gen_config)
    if needs_sampling and requested:
        conflicts = []
        if "temperature" in requested and not math.isclose(requested["temperature"], spec.temperature, rel_tol=1e-6):
            conflicts.append(f"temperature={requested['temperature']} (generator uses {spec.temperature})")
        conflicts += [f"{k}={requested[k]} (unsupported on the speculative backend)"
                      for k in ("top_k", "top_p") if k in requested]
        if conflicts:
            warnings.warn(
                "gen_config is ignored on the speculative backend; conflicting settings: " + ", ".join(conflicts),
                stacklevel=3,
            )
    deterministic, _, deterministic_text = _torch_generation(
        spec.greedy_generator, tokenizer, prompt, gen_config, 1, needs_sampling=False,
        needs_attentions=needs_attentions, needs_hiddens=False,
    )
    sampled = {"log_probs": None, "hidden_states": None, "texts": None}
    if needs_sampling:
        encode = getattr(tokenizer, "encode", None)
        decode = getattr(tokenizer, "decode", None)
        samp = spec.generate_samples(encode(prompt) if encode else prompt, num_samples)
        ids = [_strip_eos(samp["tokens"][i, : int(samp["lengths"][i])].tolist(), spec.eos_id)
               for i in range(num_samples)]
        sampled = {"log_probs": samp["log_probs"], "hidden_states": None,
                   "texts": [decode(t) for t in ids] if decode else ids}
    return deterministic, sampled, deterministic_text


def _hf_generation(model, tokenizer, prompt, gen_config, num_samples, needs_sampling):
    """The reference's HF flow (``transformers`` ``generate`` with every
    output), log-probs as numpy; the JAX package's ``_hf_generation``."""
    inputs = tokenizer(prompt, return_tensors="pt")
    if hasattr(model, "device"):
        inputs = inputs.to(model.device)
    input_length = inputs["input_ids"].shape[1]
    det_out = model.generate(
        **inputs, generation_config=gen_config, output_attentions=True, output_hidden_states=True,
        output_scores=True, return_dict_in_generate=True,
    )
    deterministic_text = tokenizer.batch_decode(det_out.sequences[:, input_length:], skip_special_tokens=True)
    det_log_probs = model.compute_transition_scores(det_out.sequences, det_out.scores, normalize_logits=True)
    deterministic = {
        "log_probs": np.asarray(det_log_probs.cpu()),
        "logits": det_out.scores,
        "attentions": det_out.attentions,
        "input_length": input_length,
        "text": deterministic_text,
    }
    sampled = {"log_probs": None, "hidden_states": None, "texts": None}
    if needs_sampling:
        samp_out = model.generate(
            **inputs, do_sample=True, temperature=1.0, num_return_sequences=num_samples,
            generation_config=gen_config, output_attentions=True, output_hidden_states=True, output_scores=True,
            return_dict_in_generate=True,
        )
        sampled = {
            "log_probs": np.asarray(model.compute_transition_scores(
                samp_out.sequences, samp_out.scores, normalize_logits=True).cpu()),
            "hidden_states": samp_out.hidden_states,
            "texts": tokenizer.batch_decode(samp_out.sequences[:, input_length:], skip_special_tokens=True),
        }
    return deterministic, sampled, deterministic_text


def run_generation(model, tokenizer, prompt, gen_config, num_samples, needs_sampling,
                   needs_attentions=True, needs_hiddens=True):
    """The two phases of ``compute_uncertainties`` (a greedy pass and, if
    ``needs_sampling``, ``num_samples`` sampled continuations) on the
    backend's type, as the JAX package dispatches: a :class:`TorchGenerator`,
    a ``SpeculativeGenerator``, or an HF model with ``generate`` (the
    reference's flow, which always asks for every output). The ``needs_*``
    hints prune taps on the port's backends.

    Returns (deterministic, sampled, deterministic_text)."""
    from runia_core_tpu_torch.llm.speculative import SpeculativeGenerator

    validate_generation_request(model, needs_sampling, needs_hiddens)
    if isinstance(model, TorchGenerator):
        return _torch_generation(model, tokenizer, prompt, gen_config, num_samples, needs_sampling,
                                 needs_attentions=needs_attentions, needs_hiddens=needs_hiddens)
    if isinstance(model, SpeculativeGenerator):
        return _speculative_generation(model, tokenizer, prompt, gen_config, num_samples, needs_sampling,
                                       needs_attentions=needs_attentions)
    return _hf_generation(model, tokenizer, prompt, gen_config, num_samples, needs_sampling)
