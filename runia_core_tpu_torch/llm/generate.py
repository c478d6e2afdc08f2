"""The generation backend of the port's LLM uncertainty scores.

Counterpart of ``runia_core_tpu/llm/generate.py``. :class:`TorchGenerator`
is the port's ``JaxGenerator``: a KV-cached decode loop over
``models/llama.py::LlamaLM`` that returns HF-shaped numpy structures
(``scores`` a tuple of (S, V), ``attentions`` a tuple over steps of
per-layer (S, H, tgt, src), ``hidden_states`` a tuple over steps of
per-layer (S, tgt, D)), so every score in ``llm/scores.py`` reads it as it
reads an HF model's output. The JAX ``lax.scan`` is a Python loop over the
steps here; every step's outputs stay on the device until the loop ends.
The step after the last sampled token is not run: its outputs are never
read.

Random draws come from a ``torch.Generator``. ``sample_logits`` splits the
HF top-k/top-p/temperature filter (:func:`filter_logits`) from the draw, an
argmax over the filtered logits plus Gumbel noise (what
``jax.random.categorical`` does), so a test can hand both frameworks the
same noise. The two frameworks' random streams differ by design.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from runia_core_tpu_torch.models.transformer import init_cache

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


class TorchGenerator:
    """A LlamaLM and its decode configuration.

    ``generator`` is the default source of random draws (a
    ``torch.Generator`` on the model's device, seeded 0 if not given).
    """

    def __init__(
        self,
        model,
        max_new_tokens: int = 16,
        eos_id: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ):
        self.model = model
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
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

    def _next_token(self, step_logits, finished, do_sample, generator, temperature, top_k, top_p):
        """One sampling step: (token, its log-probability, finished)."""
        log_soft = torch.log_softmax(step_logits, dim=-1)
        if do_sample:
            token = sample_logits(step_logits, generator, temperature, top_k, top_p)
        else:
            token = torch.argmax(step_logits, dim=-1)
        lp = log_soft.gather(1, token[:, None])[:, 0]
        lp = lp.masked_fill(finished, float("-inf"))
        if self.eos_id is not None:
            # Pad with EOS once finished, as the HF backend strips it.
            token = token.masked_fill(finished, self.eos_id)
            finished = finished | (token == self.eos_id)
        return token, lp, finished

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
            token, lp, finished = self._next_token(step_logits, finished, do_sample, gen, temperature, top_k, top_p)
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

        result = {
            "sequences": np.concatenate([tokens, torch.stack(toks, 1).cpu().numpy()], axis=1),
            "scores": tuple(torch.stack(scores).cpu().numpy()) if output_scores else (),
            "log_probs": torch.stack(lps, 1).cpu().numpy(),
            "prompt_lengths": lengths.astype(np.int32),
        }
        if output_attentions:
            # (T-1, L, B, H) -> (B, L, H, T-1)
            stacked = torch.stack(prev).cpu().numpy() if prev else np.zeros((0, model.num_layers, b, model.num_heads))
            result["prev_token_attention"] = np.transpose(stacked, (2, 1, 3, 0))
        return result

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
            token, lp, finished = self._next_token(step_logits, finished, do_sample, gen, temperature, top_k, top_p)
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

        attentions, hidden_states = [], []
        if output_attentions:
            a0 = attn0[:, 0, :, :, :p].cpu().numpy()  # (L, H, P, P)
            attentions.append(tuple(np.broadcast_to(a, (s,) + a.shape) for a in a0))
            if attn_rows:
                for step, rows in enumerate(torch.stack(attn_rows).cpu().numpy()):
                    attentions.append(tuple(r[:, :, None, : p + step + 1] for r in rows))
        if output_hidden_states:
            h0 = hid0[:, 0].cpu().numpy()  # (L+1, P, D)
            hidden_states.append(tuple(np.broadcast_to(h, (s,) + h.shape) for h in h0))
            if hidden_rows:
                for rows in torch.stack(hidden_rows).cpu().numpy():
                    hidden_states.append(tuple(h[:, None, :] for h in rows))
        return {
            "sequences": np.concatenate([np.repeat(prompt_np, s, 0), torch.stack(toks, 1).cpu().numpy()], axis=1),
            "scores": tuple(torch.stack(scores).cpu().numpy()),
            "attentions": tuple(attentions),
            "hidden_states": tuple(hidden_states),
            "log_probs": torch.stack(lps, 1).cpu().numpy(),
        }


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
    """Raise before any decode work if the backend cannot serve the request.
    The port serves one backend, :class:`TorchGenerator`, which emits every
    tap the scores read."""
    del needs_sampling, needs_hiddens
    if not isinstance(model, TorchGenerator):
        raise TypeError(f"unsupported generation backend {type(model).__name__}; pass a TorchGenerator")


def run_generation(model, tokenizer, prompt, gen_config, num_samples, needs_sampling,
                   needs_attentions=True, needs_hiddens=True):
    """The two phases of ``compute_uncertainties`` on a TorchGenerator: a
    greedy pass (attention taps only if ``needs_attentions``, for RAUQ) and,
    if ``needs_sampling``, ``num_samples`` sampled continuations honouring
    ``gen_config``'s temperature/top_k/top_p (hidden states only if
    ``needs_hiddens``, for eigen_score).

    Returns (deterministic, sampled, deterministic_text) as the JAX
    backends do."""
    validate_generation_request(model, needs_sampling, needs_hiddens)
    encode = getattr(tokenizer, "encode", None)
    decode = getattr(tokenizer, "decode", None)
    prompt_tokens = encode(prompt) if encode else prompt
    input_length = len(prompt_tokens)
    det = model.generate(
        prompt_tokens, num_return_sequences=1, do_sample=False,
        output_attentions=needs_attentions, output_hidden_states=False,
    )
    det_ids = _strip_eos(det["sequences"][0, input_length:].tolist(), model.eos_id)
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
        samp = model.generate(
            prompt_tokens, num_return_sequences=num_samples, do_sample=True,
            output_attentions=False, output_hidden_states=needs_hiddens, **_sampling_kwargs(gen_config),
        )
        ids = [_strip_eos(row[input_length:].tolist(), model.eos_id) for row in samp["sequences"]]
        sampled = {
            "log_probs": samp["log_probs"],
            "hidden_states": samp["hidden_states"],
            "texts": [decode(t) for t in ids] if decode else ids,
        }
    return deterministic, sampled, deterministic_text
