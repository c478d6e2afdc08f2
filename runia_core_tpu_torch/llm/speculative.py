"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of ``runia_core_tpu/llm/speculative.py``. Each round the draft
proposes ``gamma`` tokens one step at a time, then ONE target forward scores
the ``gamma + 1`` positions, and the longest agreeing prefix plus the
target's correction token are accepted, so the target runs once per
``n_accepted + 1`` tokens. With greedy acceptance the output is the target's
plain greedy decode, up to argmax near-ties between the batched verify
forward and sequential one-token forwards (in bf16 they break differently;
the tests pin identity in f32).

The JAX package runs the whole generation as one ``lax.while_loop``. The
port's :class:`_SpeculativeProgram` holds both KV caches and the loop state
in static buffers and splits the work in two:

* a **prefill** of both caches (eager; the bf16 target's prompt takes
  kernel 4 from 128 tokens on) and the first token;
* a **round** that runs on the device alone: ``gamma + 1`` draft steps, the
  ``gamma + 1``-token verify forward of the target (under the flash
  threshold, so dense attention over the cache), greedy acceptance or
  :func:`speculative_sample_round`, the EOS cut, the writes of the emitted
  tokens and their target log-probs, and the index bookkeeping. On a CUDA
  device the round is captured once into a CUDA graph
  (``utils/graphs.py``) and replayed; on the CPU the same function runs
  uncaptured.

``lax.while_loop`` exits when every row is done; a CUDA graph has no
data-dependent loop, so the host replays the round and reads the "all
done" flag after each one (``utils.graphs.host_sync``; on an H100 reading
it every 2 or 4 rounds was no faster, see PERF.md). Every round emits at
least one token, so ``max_new_tokens - 1`` rounds always suffice, and a
round after a row is done changes none of its results. Rows are the samples of ``generate_samples`` and the prompts of
``generate_prompts`` (JAX vmaps the loop over them): each row keeps its own
cache index, a (B,) tensor that goes through the models' per-row cache path
and never through the host. Under a vmapped ``while_loop`` a finished row's
state stops changing; here masks freeze it, and its caches take the round's
writes in ``gamma + 1`` spare slots past the ``p + max_new + gamma + 1``
that the JAX loop allocates, so no write lands outside the buffers.

Cache bookkeeping is JAX's: both caches are written optimistically, the
rejected slots are left stale behind the causal mask, and the draft runs
``gamma + 1`` steps, not ``gamma``, so that after a fully accepted round the
last proposal's K/V is in the draft cache (without it a zero-K/V hole
halves the acceptance rate).

Random draws come from a ``torch.Generator``: the generator's own (seeded
0), advanced by every sampled call, or the caller's. The two frameworks'
random streams differ; :func:`speculative_sample_round` takes its draws as
arguments so a test can hand it JAX's.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from runia_core_tpu_torch.llm.generate import TorchGenerator, sample_logits
from runia_core_tpu_torch.models.transformer import init_cache
from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, copy_to_host, drawing_from, host_sync, upload

__all__ = ["SpeculativeGenerator", "speculative_sample_round"]


def speculative_sample_round(proposals: torch.Tensor, draft_probs: torch.Tensor, target_probs: torch.Tensor,
                             generator: Optional[torch.Generator] = None, uniforms: Optional[torch.Tensor] = None,
                             noise: Optional[torch.Tensor] = None):
    """One rejection-sampling verify round (Leviathan et al.), batched over
    any leading axes.

    ``proposals`` (..., g) the draft's sampled tokens, ``draft_probs``
    (..., g, V) its sampling distributions, ``target_probs`` (..., g+1, V)
    the target's at every position of the verify forward. Proposal i is
    accepted with probability min(1, p_t / p_d); at the first rejection the
    correction is drawn from the residual max(p_t - p_d, 0) (renormalised;
    p_t itself where it is empty), and when all are accepted the bonus
    token from the target's last distribution. The emitted tokens are exact
    samples of the target distribution.

    ``uniforms`` (..., g) replace the acceptance draws and ``noise``
    (..., V) the Gumbel noise of the correction's categorical draw
    (``jax.random.categorical`` is argmax(log-probs + Gumbel noise));
    either one not given is drawn from ``generator``. Returns (n_acc
    (...,), emitted (..., g+1)); emitted[i] is valid for i <= n_acc.
    """
    g = proposals.shape[-1]
    dev = target_probs.device
    p_t = target_probs[..., :-1, :].gather(-1, proposals[..., None])[..., 0]
    p_d = draft_probs.gather(-1, proposals[..., None])[..., 0]
    if uniforms is None:
        uniforms = torch.rand(p_t.shape, generator=generator, device=dev)
    accept = uniforms < torch.clamp(p_t / p_d.clamp_min(1e-20), max=1.0)
    n_acc = torch.cumprod(accept.to(torch.int64), dim=-1).sum(-1)
    draft_ext = torch.cat([draft_probs, torch.zeros_like(target_probs[..., -1:, :])], dim=-2)
    at = n_acc[..., None, None].expand(*n_acc.shape, 1, target_probs.shape[-1])
    target_row = target_probs.gather(-2, at)[..., 0, :]
    residual = (target_row - draft_ext.gather(-2, at)[..., 0, :]).clamp_min(0.0)
    residual = torch.where(residual.sum(-1, keepdim=True) > 0, residual, target_row)
    correction = sample_logits(torch.log(residual + 1e-30), generator, noise=noise)
    idxs = torch.arange(g + 1, device=dev)
    emitted = torch.where(idxs < n_acc[..., None], torch.cat([proposals, proposals[..., -1:]], dim=-1),
                          correction[..., None])
    return n_acc, emitted


class _SpeculativeProgram:
    """The fused speculative loop of one (rows, prompt length) key.

    Static buffers: both KV caches of ``rows`` rows and ``p + max_new +
    2 (gamma + 1)`` slots (the last ``gamma + 1`` take the writes of rows
    that are done), and the loop state, one entry a row: the last emitted
    token, the cache index, the tokens emitted (``n_gen``), ``finished``
    (EOS), rounds and accepted proposals, the emitted tokens and their
    target log-probs (``buf`` / ``lpb``, ``max_new + gamma + 1`` wide), and
    ``done`` (no row active). :meth:`prefill` loads them; :meth:`run` runs
    the rounds, on a CUDA device as replays of :meth:`round`'s graph,
    captured when the program is built.
    """

    def __init__(self, target, draft, rows: int, p: int, max_new: int, gamma: int, eos_id, do_sample: bool,
                 temperature: float, use_graph: bool):
        dev = next(target.parameters()).device
        self.target, self.draft, self.device = target, draft, dev
        self.rows, self.p, self.max_new, self.gamma = rows, p, max_new, gamma
        self.eos_id, self.do_sample, self.temperature = eos_id, do_sample, temperature
        self.total = p + max_new + gamma + 1  # the JAX loop's slots
        self.park = self.total  # where the rows that are done write
        slots = self.total + gamma + 1
        self.t_cache = init_cache(target, rows, slots, dev)
        self.d_cache = init_cache(draft, rows, slots, dev)
        buf_len = max_new + gamma + 1

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.last, self.index, self.n_gen = zeros(rows), zeros(rows), zeros(rows)
        self.rounds, self.accepted = zeros(rows), zeros(rows)
        self.finished, self.done = zeros(rows, dtype=torch.bool), zeros(dtype=torch.bool)
        self.buf, self.lpb = zeros(rows, buf_len), zeros(rows, buf_len, dtype=torch.float32)
        self.idxs = torch.arange(gamma + 1, device=dev)
        self.generator = torch.Generator(device=dev) if do_sample else None
        self.graph = None
        if use_graph and dev.type == "cuda" and max_new > 1:
            # One warm-up round, on the zero state: index 0 and n_gen 0
            # keep its writes inside the buffers.
            self.graph = CudaGraph(self.round, generators=[self.generator] if do_sample else [], device=dev,
                                   warmup=1)

    def prefill(self, prompt: torch.Tensor) -> None:
        """Both caches from the (1 or rows, p) prompt (one row is prefilled
        once and copied to every row), then the first token of every row
        and the loop state."""
        n = prompt.shape[0]
        for model, cache in ((self.target, self.t_cache), (self.draft, self.d_cache)):
            rows_view = {"layers": [{name: buf[:n] for name, buf in layer.items()} for layer in cache["layers"]]}
            logits, _, _, _ = model(prompt, rows_view, 0, need_attentions=False, need_hiddens=False,
                                    last_logits_only=True)
            if n < self.rows:
                for layer in cache["layers"]:
                    for buf in layer.values():
                        buf[n:, : self.p].copy_(buf[:n, : self.p].expand(self.rows - n, *([-1] * (buf.ndim - 1))))
            if model is self.target:
                first = logits[:, -1].expand(self.rows, -1)
        if self.do_sample:
            token = sample_logits(first / self.temperature, self.generator)
        else:
            token = torch.argmax(first, dim=-1)
        self.last.copy_(token)
        self.index.fill_(self.p)
        self.n_gen.fill_(1)
        self.rounds.zero_()
        self.accepted.zero_()
        self.buf.zero_()
        self.lpb.zero_()
        self.buf[:, 0] = token
        self.lpb[:, 0] = torch.log_softmax(first, dim=-1).gather(1, token[:, None])[:, 0]
        self.finished.copy_(token == self.eos_id if self.eos_id is not None else torch.zeros_like(self.finished))
        self.done.copy_(~((self.n_gen < self.max_new) & ~self.finished).any())

    def round(self) -> None:
        """One speculative round of every active row (see the module doc)."""
        gamma, max_new, temp, eos = self.gamma, self.max_new, self.temperature, self.eos_id
        active = (self.n_gen < max_new) & ~self.finished
        at = torch.where(active, self.index, torch.full_like(self.index, self.park))
        tok, proposals, draft_probs = self.last, [], []
        for j in range(gamma + 1):
            # The extra step writes the last proposal's K/V; its token is dropped.
            lg, _, _, _ = self.draft(tok[:, None], self.d_cache, at + j, need_attentions=False, need_hiddens=False)
            row = lg[:, 0] / temp
            tok = sample_logits(row, self.generator) if self.do_sample else torch.argmax(row, dim=-1)
            if j < gamma:
                proposals.append(tok)
                if self.do_sample:
                    draft_probs.append(torch.softmax(row, dim=-1))
        proposals = torch.stack(proposals, dim=1)
        block = torch.cat([self.last[:, None], proposals], dim=1)
        lg, _, _, _ = self.target(block, self.t_cache, at, need_attentions=False, need_hiddens=False)
        idxs = self.idxs
        if self.do_sample:
            n_acc, emitted = speculative_sample_round(proposals, torch.stack(draft_probs, dim=1),
                                                      torch.softmax(lg / temp, dim=-1), self.generator)
        else:
            preds = torch.argmax(lg, dim=-1)
            n_acc = torch.cumprod((proposals == preds[:, :-1]).to(torch.int64), dim=-1).sum(-1)
            emitted = torch.where(idxs < n_acc[:, None], torch.cat([proposals, proposals[:, -1:]], dim=1),
                                  preds.gather(1, torch.minimum(idxs, n_acc[:, None])))
        tok_lp = torch.log_softmax(lg, dim=-1).gather(-1, emitted[..., None])[..., 0]
        cand = n_acc + 1
        finished = self.finished
        if eos is not None:
            is_eos = (emitted == eos) & (idxs < cand[:, None])
            has_eos = is_eos.any(-1)
            cand = torch.where(has_eos, torch.argmax(is_eos.to(torch.int64), dim=-1) + 1, cand)
            finished = finished | has_eos
        take = torch.minimum(cand, max_new - self.n_gen)
        # Writes start at the first unwritten slot; entries past `take` are
        # slack that later rounds overwrite.
        cols = self.n_gen[:, None] + idxs
        self.buf.copy_(torch.where(active[:, None], self.buf.scatter(1, cols, emitted), self.buf))
        self.lpb.copy_(torch.where(active[:, None], self.lpb.scatter(1, cols, tok_lp), self.lpb))
        n_gen = self.n_gen + torch.where(active, take, 0)
        last = self.buf.gather(1, (n_gen - 1).clamp_min(0)[:, None])[:, 0]
        self.last.copy_(torch.where(active, last, self.last))
        self.index.add_(torch.where(active, n_acc + 1, 0))
        self.n_gen.copy_(n_gen)
        self.finished.copy_(torch.where(active, finished, self.finished))
        self.rounds.add_(active.to(torch.int64))
        self.accepted.add_(torch.where(active, n_acc, 0))
        self.done.copy_(~((self.n_gen < max_new) & ~self.finished).any())

    def run(self) -> int:
        """Rounds until every row is done, at most ``max_new - 1``, the
        flag read after each but the last; returns the host's flag reads."""
        syncs = 0
        for i in range(self.max_new - 1):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.round()
            if i + 1 < self.max_new - 1:
                syncs += 1
                with host_sync(self.device):
                    if bool(self.done):
                        break
        return syncs


class SpeculativeGenerator:
    """Speculative decoding over two models sharing one vocabulary.

    ``target`` / ``draft`` follow the decoder-LM contract of the port's
    ``LlamaLM`` / ``CausalLM`` / ``NeoXLM`` and hold their weights (the JAX
    generator takes the parameter trees beside the modules). Greedy
    (``do_sample=False``) or rejection-sampled at ``temperature``. Worst
    case each round emits the target's correction token, so the cost is
    bounded by one target forward plus ``gamma + 1`` draft steps a token;
    best case ``gamma + 1`` tokens a target forward.

    ``generator`` is the default source of random draws (a
    ``torch.Generator`` on the target's device, seeded 0 if not given);
    every sampled call advances it, so repeated calls differ, as the JAX
    generator's folded key stream does. ``use_graph`` (default) replays each
    round as a CUDA graph on a GPU. Programs are kept per (rows, prompt
    length), the 8 most recently used. :attr:`greedy_generator` is the
    target's plain greedy ``TorchGenerator``, which the uncertainty
    backend's deterministic pass uses.
    """

    def __init__(self, target, draft, gamma: int = 4, max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0, generator: Optional[torch.Generator] = None,
                 use_graph: bool = True):
        self.target, self.draft = target, draft
        self.gamma = int(gamma)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.use_graph = use_graph
        self.device = next(target.parameters()).device
        self.generator = generator or torch.Generator(device=self.device).manual_seed(0)
        self._run_cache = ProgramCache(8)
        self._greedy = None  # ((max_new_tokens, eos_id), TorchGenerator)
        self.last_syncs = 0  # the host's flag reads of the last call

    @property
    def greedy_generator(self) -> TorchGenerator:
        """The target's greedy ``TorchGenerator`` at this generator's
        ``max_new_tokens`` and ``eos_id``, built on first use and again
        after either changes."""
        key = (self.max_new_tokens, self.eos_id)
        if self._greedy is None or self._greedy[0] != key:
            self._greedy = (key, TorchGenerator(self.target, max_new_tokens=self.max_new_tokens, eos_id=self.eos_id))
        return self._greedy[1]

    def _next_key(self, generator: Optional[torch.Generator]) -> torch.Generator:
        """The caller's generator wins; otherwise the generator's own, which
        the call's draws advance."""
        return generator if generator is not None else self.generator

    def _warn_context(self, p: int) -> None:
        limit = getattr(self.target, "max_len", None)
        if limit and p + self.max_new_tokens > limit:
            warnings.warn(
                f"generation length {p + self.max_new_tokens} exceeds the target's trained context window "
                f"max_len={limit}; quality degrades beyond it",
                stacklevel=3,
            )

    def _run(self, prompt: np.ndarray, rows: int, generator: Optional[torch.Generator]):
        """Prefill and every round for a (1 or rows, p) prompt; the host
        copies of buf, lpb, n_gen, rounds and accepted."""
        p = prompt.shape[1]
        prog = self._run_cache.get_or_build((rows, p), lambda: _SpeculativeProgram(
            self.target, self.draft, rows, p, self.max_new_tokens, self.gamma, self.eos_id, self.do_sample,
            self.temperature, self.use_graph))
        with torch.no_grad():
            if prog.generator is not None:
                with drawing_from(prog.generator, self._next_key(generator)):
                    prog.prefill(upload(prompt, self.device))
                    self.last_syncs = prog.run()
            else:
                prog.prefill(upload(prompt, self.device))
                self.last_syncs = prog.run()
        return copy_to_host(prog.buf, prog.lpb, prog.n_gen, prog.rounds, prog.accepted)

    def _rows_result(self, prompts: np.ndarray, buf, lpb, n_gen, rounds, accepted) -> Dict[str, Any]:
        """generate_samples' and generate_prompts' result: tokens padded
        with each row's last token, log-probs -inf past each row's end."""
        t_max = int(n_gen.max())
        mask = np.arange(t_max)[None, :] < n_gen[:, None]
        last_tok = buf[np.arange(len(n_gen)), n_gen - 1]
        tokens = np.where(mask, buf[:, :t_max], last_tok[:, None])
        return {
            "sequences": np.concatenate([prompts, tokens], axis=1),
            "tokens": tokens,
            "log_probs": np.where(mask, lpb[:, :t_max], -np.inf),
            "lengths": n_gen,
            "rounds": int(rounds.sum()),
            "acceptance_rate": float(accepted.sum()) / max(1, int(rounds.sum()) * self.gamma),
        }

    def generate_samples(self, prompt_tokens: Sequence[int], num_samples: int,
                         generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """``num_samples`` sampled continuations of one prompt, one row each
        (JAX vmaps the loop); needs ``do_sample=True``.

        Returns sequences (N, P+T_max) and tokens (N, T_max), right-padded
        with each sample's last token, log_probs (N, T_max) (-inf past each
        sample's end), lengths (N,), rounds (summed over rows) and
        acceptance_rate = accepted / (rounds x gamma)."""
        if not self.do_sample:
            raise ValueError("generate_samples requires do_sample=True")
        prompt = np.asarray(prompt_tokens, np.int64)[None, :]
        self._warn_context(prompt.shape[1])
        out = self._run(prompt, num_samples, generator)
        return self._rows_result(np.repeat(prompt, num_samples, axis=0), *out)

    def generate_prompts(self, prompts: Sequence[Sequence[int]],
                         generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """B equal-length prompts decoded as B rows (the serving batch
        shape); ragged prompts raise (use ``TorchGenerator.generate_batch``,
        whose masking the fused loop does not do). The result as
        :meth:`generate_samples`'."""
        lens = {len(p) for p in prompts}
        if len(lens) != 1:
            raise ValueError(f"generate_prompts requires equal-length prompts, got {sorted(lens)}")
        batch = np.asarray(prompts, np.int64)
        self._warn_context(batch.shape[1])
        return self._rows_result(batch, *self._run(batch, len(prompts), generator))

    def generate(self, prompt_tokens: Sequence[int], generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """Decode one prompt (greedy or sampled per the constructor).

        Returns sequences (1, P+T), tokens (T,), log_probs (T,) (the
        target's log-probs of the emitted tokens), rounds and
        acceptance_rate."""
        prompt = np.asarray(prompt_tokens, np.int64)[None, :]
        self._warn_context(prompt.shape[1])
        buf, lpb, n_gen, rounds, accepted = self._run(prompt, 1, generator)
        n = int(n_gen[0])
        return {
            "sequences": np.concatenate([prompt, buf[:, :n]], axis=1),
            "tokens": buf[0, :n],
            "log_probs": lpb[0, :n],
            "rounds": int(rounds[0]),
            "acceptance_rate": float(accepted[0]) / max(1, int(rounds[0]) * self.gamma),
        }
