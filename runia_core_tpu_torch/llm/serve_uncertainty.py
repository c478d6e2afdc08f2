"""Batch uncertainty serving: ``compute_uncertainties`` semantics over the
continuous batching engine.

Counterpart of ``runia_core_tpu/llm/serve_uncertainty.py``. The
single-prompt path (``llm.scores.compute_uncertainties``) decodes one prompt
per call; this module serves the same scores for a batch of prompts through
:class:`~runia_core_tpu_torch.llm.continuous.ContinuousBatchingEngine`:

* the interactive mode runs ONE merged drain: each prompt's deterministic
  request (``sample=False``: greedy through the engine's per-request
  decoding modes, RAUQ's attention signal gathered in the decode loop) and
  its ``num_samples`` sampled duplicates go in together, sharing an
  admission wave, a prefix-cached prefill and the drain's tail;
* the scores come from the same ``llm.scores`` functions the single-prompt
  path calls. ``eigen_score`` reads the engine's in-loop hidden vectors
  (``collect_hidden``, each sample's final-token vector of one layer);
  ``semantic_entropy`` takes any judge ``llm.scores.semantic_entropy``
  takes, ``models.deberta.wrap_torch_nli`` among them.

``fused=True`` drains each pass with ``generate_all_fused`` (the scheduler on
the device), without RAUQ, eigen_score, a draft model or prefix-cache reuse
in the sampled pass. Engines carry their own weights, so there is no
``params`` argument; everything else is JAX's.

Online serving (the port's own; JAX's server takes whole batches):
:meth:`UncertaintyServer.submit` enqueues one prompt and
:meth:`UncertaintyServer.stream` yields ``(id, scores)`` as each prompt's
requests finish, the engine refilling its slots from the queue as they
free, so a client may submit its next prompt as soon as it has its last
scores. Each prompt's scoring runs in a ``runia.uncertainty.score`` span.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from runia_core_tpu_torch.llm.continuous import ContinuousBatchingEngine
from runia_core_tpu_torch.llm.scores import (
    eigen_score_from_embeddings,
    normalized_entropy,
    perplexity,
    semantic_entropy,
)
from runia_core_tpu_torch.utils.profiling import span

__all__ = ["UncertaintyServer", "serve_uncertainties"]

_SEQUENCE_METHODS = {  # method -> needs sampled continuations
    "perplexity": False,
    "generation_entropy": False,
    "RAUQ": False,
    "normalized_entropy": True,
    "semantic_entropy": True,
    "eigen_score": True,
}


def _validate(requests: Sequence[dict], num_layers: Optional[int] = None) -> Tuple[bool, bool, bool, Optional[int]]:
    """Fail before any decode work, as compute_uncertainties does. Returns
    (needs sampling, needs RAUQ, needs semantic entropy, eigen_score layer).

    ``num_layers`` (when known) maps a negative eigen_score layer to
    ``li + num_layers + 1``, as the engine does, so one layer named two ways
    (-1 and num_layers) is one stream."""
    unknown = [r["method_name"] for r in requests if r["method_name"] not in _SEQUENCE_METHODS]
    if unknown:
        raise KeyError(
            f"unknown uncertainty method(s) {unknown}; valid: "
            f"{sorted(_SEQUENCE_METHODS)}"
        )

    def norm_layer(li: int) -> int:
        if li < 0 and num_layers is not None:
            li += int(num_layers) + 1
        return li

    eigen_layers = {norm_layer(int(r.get("layer_index", 15))) for r in requests if r["method_name"] == "eigen_score"}
    if len(eigen_layers) > 1:
        raise NotImplementedError(
            "engine-served eigen_score streams ONE hidden layer per run; "
            f"got layer_index values {sorted(eigen_layers)} — use "
            "compute_uncertainties for multi-layer scoring"
        )
    rauq_alphas = set()
    for r in requests:
        if r["method_name"] == "RAUQ":
            # compute_uncertainties' defaults: a bare RAUQ request raises
            # here instead of scoring another aggregation under another key.
            tok = r.get("token_aggregation", "mean_all_tokens")
            head = r.get("head_aggregation", "rollout")
            if (tok, head) != ("original", "original"):
                raise NotImplementedError(
                    "engine-served RAUQ supports token_aggregation="
                    "'original', head_aggregation='original' (the in-loop "
                    f"signal); got ({tok!r}, {head!r}) — pass them "
                    "explicitly, or use compute_uncertainties for other "
                    "aggregations"
                )
            if len(r.get("alphas", [0.3])) != 1 or r.get("ablation"):
                raise NotImplementedError(
                    "engine-served RAUQ scores one alpha per run; use "
                    "compute_uncertainties for alpha ablations"
                )
            rauq_alphas.add(float(r.get("alphas", [0.3])[0]))
    if len(rauq_alphas) > 1:
        raise NotImplementedError(f"engine-served RAUQ uses one in-loop alpha; got {sorted(rauq_alphas)}")
    needs_sampling = any(_SEQUENCE_METHODS[r["method_name"]] for r in requests)
    needs_rauq = any(r["method_name"] == "RAUQ" for r in requests)
    needs_semantic = any(r["method_name"] == "semantic_entropy" for r in requests)
    eigen_layer = eigen_layers.pop() if eigen_layers else None
    return needs_sampling, needs_rauq, needs_semantic, eigen_layer


# The engine defaults _make_engine and the fused-mode checks share.
_ENGINE_DEFAULTS = dict(
    num_slots=8,
    chunk_tokens=16,
    prefill_chunk=64,
)


def _make_engine(model, max_prompt_len, max_new_tokens, eos_id, collect_rauq, engine_kwargs, **mode):
    """An engine sized for prompts of up to ``max_prompt_len`` tokens:
    ``_ENGINE_DEFAULTS`` under ``engine_kwargs``, the prefix cache on with
    chunked prefill, the open-loop drain when the emission schedule is known
    (no EOS, no draft), and ``max_ctx`` from the longest request (plus the
    speculative slack), unless given."""
    kw = dict(_ENGINE_DEFAULTS)
    kw.update(engine_kwargs or {})
    kw.setdefault("prefix_cache", bool(kw["prefill_chunk"]))
    kw.setdefault("defer_fetch", eos_id is None and kw.get("draft_model") is None)
    slack = kw.get("gamma", 4) + 1 if kw.get("draft_model") is not None else 0
    if "max_ctx" not in kw:
        max_p = int(max_prompt_len)
        if kw["prefill_chunk"]:
            c = kw["prefill_chunk"]
            kw["max_ctx"] = -(-(max_p + max_new_tokens + slack) // c) * c
        else:
            # The bucketed path checks the padded prompt length.
            bucket = kw.get("prompt_bucket", 16)
            p_pad = -(-max(max_p, 1) // bucket) * bucket
            kw["max_ctx"] = p_pad + max_new_tokens + slack
    return ContinuousBatchingEngine(model, max_new_tokens=max_new_tokens, eos_id=eos_id, collect_rauq=collect_rauq,
                                    **kw, **mode)


class UncertaintyServer:
    """A persistent batch uncertainty server: the engines are built once
    (their programs captured once) and serve any number of prompt batches.

    In the interactive mode with sampling, one engine (``do_sample=True``)
    drains a batch's deterministic requests and samples together; otherwise
    a deterministic engine (greedy, RAUQ in the loop if asked) and, when a
    method needs samples, a sampled one. Both keep their KV caches, their
    prefix cache and their generator across :meth:`serve` calls, so a
    repeated prompt reuses its resident rows and each batch draws new
    samples. Capacity is fixed at construction by ``max_prompt_len`` (or
    ``engine_kwargs["max_ctx"]``); a longer prompt later fails at
    submission. ``fused=True`` builds one drain per workload shape
    (requests, padded prompt, budget): batches of a steady size reuse it.
    """

    def __init__(
        self,
        model,
        tokenizer,
        uncertainty_requests: Sequence[dict],
        num_samples: int = 10,
        max_new_tokens: int = 64,
        eos_id: Optional[int] = None,
        temperature: float = 1.0,
        entailment_model=None,
        entailment_tokenizer=None,
        engine_kwargs: Optional[dict] = None,
        fused: bool = False,
        max_prompt_len: Optional[int] = None,
    ):
        needs_sampling, needs_rauq, needs_semantic, eigen_layer = _validate(
            uncertainty_requests, num_layers=getattr(model, "num_layers", None))
        if needs_semantic and entailment_model is None:
            raise ValueError(
                "semantic_entropy needs entailment_model "
                "(no implicit downloads)"
            )
        if fused and needs_rauq:
            raise ValueError(
                "fused=True cannot serve RAUQ (in-loop attention is an "
                "interactive-drain feature); drop the RAUQ request or "
                "fused=True"
            )
        if fused and eigen_layer is not None:
            raise ValueError(
                "fused=True cannot serve eigen_score (in-loop hidden-state "
                "collection is an interactive-drain feature); drop the "
                "eigen_score request or fused=True"
            )
        if fused and (engine_kwargs or {}).get("draft_model") is not None:
            raise ValueError("fused=True supports the plain decode path only")
        if fused and not (engine_kwargs or {}).get("prefill_chunk", _ENGINE_DEFAULTS["prefill_chunk"]):
            raise ValueError("fused=True requires chunked prefill")
        if max_prompt_len is None and "max_ctx" not in (engine_kwargs or {}):
            raise ValueError(
                "UncertaintyServer sizes its KV caches up front: pass "
                "max_prompt_len or engine_kwargs['max_ctx']"
            )

        self.tokenizer = tokenizer
        self.requests = list(uncertainty_requests)
        self.num_samples = int(num_samples)
        self.entailment_model = entailment_model
        self.entailment_tokenizer = entailment_tokenizer
        self.fused = bool(fused)
        # The RAUQ alpha compute_uncertainties would use (_validate makes
        # every RAUQ request agree on one).
        rauq_alpha = next((float(r.get("alphas", [0.3])[0]) for r in uncertainty_requests
                           if r["method_name"] == "RAUQ"), 0.2)
        # Merged: the deterministic pass is sample=False requests on the
        # sampled engine. Fused mode and speculative engines keep two engines.
        self._merged = not fused and needs_sampling and (engine_kwargs or {}).get("draft_model") is None
        self.samp_engine = None
        build = (model, max_prompt_len or 0, max_new_tokens, eos_id)
        if self._merged:
            mode: Dict[str, Any] = dict(do_sample=True, temperature=temperature, rauq_alpha=rauq_alpha)
            if eigen_layer is not None:
                mode["collect_hidden"] = eigen_layer
            self.det_engine = _make_engine(*build, needs_rauq, engine_kwargs, **mode)
        else:
            self.det_engine = _make_engine(*build, needs_rauq, engine_kwargs, rauq_alpha=rauq_alpha)
            if needs_sampling:
                mode = dict(do_sample=True, temperature=temperature)
                if eigen_layer is not None:
                    mode["collect_hidden"] = eigen_layer
                self.samp_engine = _make_engine(*build, False, engine_kwargs, **mode)
        self._open: Dict[int, List[int]] = {}  # submitted prompt id -> its sampled requests' ids
        self._completions: Dict[int, dict] = {}  # streamed prompt id -> its deterministic result, until taken

    def submit(self, prompt: Sequence[int]) -> int:
        """Enqueue one prompt: its deterministic request and, in the merged
        mode, its samples, together (the first admission prefills, the rest
        hit the prefix cache). Returns its id; its scores come out of
        :meth:`stream`. The fused mode and a speculative engine with a
        separate sampled engine serve whole batches only (:meth:`serve`)."""
        if self.fused or self.samp_engine is not None:
            raise NotImplementedError("submit / stream serve one engine's drain: not with fused=True or a "
                                      "separate sampled engine; use serve")
        eng, prompt = self.det_engine, list(prompt)
        if not self._merged:
            rid = eng.submit(prompt)
            self._open[rid] = []
            return rid
        rid = eng.submit(prompt, sample=False)
        self._open[rid] = [eng.submit(prompt, sample=True) for _ in range(self.num_samples)]
        return rid

    def stream(self) -> Iterator[Tuple[int, Dict[str, Any]]]:
        """Serve what was submitted, yielding ``(id, scores)`` as each
        prompt's requests finish, until none is left. A prompt submitted
        while it runs (between two of its yields) joins the same drain. The
        deterministic completion (the engine's result: ``tokens``,
        ``log_probs``, ``entropies``, ...) waits in :meth:`completion`."""
        for rid, _, scores in self._drain():
            yield rid, scores

    def completion(self, request_id: int) -> dict:
        """A streamed prompt's deterministic result, handed over once."""
        return self._completions.pop(request_id)

    def _drain(self, keep: bool = True) -> Iterator[Tuple[int, Any, Dict[str, Any]]]:
        """(id, text, scores) of each submitted prompt as it finishes; with
        ``keep``, its deterministic result waits in :meth:`completion`."""
        eng = self.det_engine
        while self._open:
            done = eng.stats()["requests_finished"]
            for _ in eng.stream():
                yield from self._finished(keep)
            if eng.stats()["requests_finished"] == done:
                raise RuntimeError(f"the engine drained with prompts {sorted(self._open)} unfinished")
            yield from self._finished(keep)

    def _finished(self, keep: bool) -> Iterator[Tuple[int, Any, Dict[str, Any]]]:
        eng = self.det_engine
        for rid in [r for r, samples in self._open.items()
                    if eng.finished(r) and all(eng.finished(i) for i in samples)]:
            samples = self._open.pop(rid)
            with span("runia.uncertainty.score"):
                det = eng.pop_result(rid)
                text, scores = self._score_one(det, [eng.pop_result(i) for i in samples])
            if keep:
                self._completions[rid] = det
            yield rid, text, scores

    def serve(self, prompts: Sequence[Sequence[int]]) -> Tuple[List[Any], List[Dict[str, Any]]]:
        """One batch: the deterministic pass, the sampled pass (if a method
        needs it), the scores. Returns ``(texts, scores)`` as
        :func:`serve_uncertainties`. Where :meth:`submit` serves, the batch
        is submitted whole and drained."""
        if not self.fused and self.samp_engine is None:
            for p in prompts:  # the whole batch is checked before anything is enqueued
                self.det_engine._validate_request(list(p), None)
            ids = [self.submit(p) for p in prompts]
            done = {rid: (text, scores) for rid, text, scores in self._drain(keep=False)}
            return [done[rid][0] for rid in ids], [done[rid][1] for rid in ids]

        det = self.det_engine.generate_all_fused(prompts) if self.fused else self.det_engine.generate_all(prompts)
        self.det_engine.clear_results()
        samp: List[List[dict]] = [[] for _ in prompts]
        if self.samp_engine is not None:
            if self.fused:
                flat = [p for p in prompts for _ in range(self.num_samples)]
                res = self.samp_engine.generate_all_fused(flat)
                for i in range(len(prompts)):
                    samp[i] = res[i * self.num_samples:(i + 1) * self.num_samples]
            else:
                ids = [(i, self.samp_engine.submit(p)) for i, p in enumerate(prompts) for _ in range(self.num_samples)]
                self.samp_engine.run_until_drained()
                for i, rid in ids:
                    samp[i].append(self.samp_engine.result(rid))
            self.samp_engine.clear_results()
        return self._score(prompts, det, samp)

    def _score(self, prompts, det: List[dict], samp: List[List[dict]]) -> Tuple[List[Any], List[Dict[str, Any]]]:
        """One batch's engine results as (texts, score dicts)."""
        scored = [self._score_one(det_res, samp[i]) for i, det_res in enumerate(det)]
        return [text for text, _ in scored], [scores for _, scores in scored]

    def _score_one(self, det_res: dict, samp: List[dict]) -> Tuple[Any, Dict[str, Any]]:
        """One prompt's (text, score dict) from its deterministic result and
        its samples' results."""
        decode = (lambda t: self.tokenizer.decode(t)) if self.tokenizer is not None else (lambda t: list(t))
        out: Dict[str, Any] = {}
        for req in self.requests:
            name = req["method_name"]
            if name == "perplexity":
                out[name] = perplexity(det_res["log_probs"])
            elif name == "generation_entropy":
                out[name] = det_res["generation_entropy"]  # computed in the decode loop
            elif name == "RAUQ":
                out["RAUQ_original_original"] = det_res["rauq"]
            elif name == "normalized_entropy":
                lens = [len(r["log_probs"]) for r in samp]
                lp = np.full((len(samp), max(max(lens), 1)), -np.inf, np.float32)
                for j, r in enumerate(samp):
                    lp[j, :lens[j]] = r["log_probs"]
                out[name] = normalized_entropy(lp)
            elif name == "eigen_score":
                embs = [r["hidden"] for r in samp if r.get("hidden") is not None]
                out[name] = eigen_score_from_embeddings(np.stack(embs)) if len(embs) >= 2 else float("nan")
            elif name == "semantic_entropy":
                texts = [decode(r["tokens"]) for r in samp]
                ent, clusters = semantic_entropy(self.entailment_model, self.entailment_tokenizer, texts)
                out[name] = ent
                out["clusters"] = {(tuple(t) if isinstance(t, list) else t): c
                                   for c, idxs in clusters.items() for j in idxs for t in [texts[j]]}
        return decode(det_res["tokens"]), out

    def stats(self) -> dict:
        """Cumulative engine counters: ``{"deterministic": ...}`` (the merged
        engine when one drain serves both passes), plus ``"sampled"`` when a
        separate sampled engine exists."""
        out = {"deterministic": self.det_engine.stats()}
        if self.samp_engine is not None:
            out["sampled"] = self.samp_engine.stats()
        return out


def serve_uncertainties(
    model,
    tokenizer,
    prompts: Sequence[Sequence[int]],
    uncertainty_requests: Sequence[dict],
    num_samples: int = 10,
    max_new_tokens: int = 64,
    eos_id: Optional[int] = None,
    temperature: float = 1.0,
    entailment_model=None,
    entailment_tokenizer=None,
    engine_kwargs: Optional[dict] = None,
    fused: bool = False,
) -> Tuple[List[Any], List[Dict[str, Any]]]:
    """Score a batch of prompts with ``compute_uncertainties`` semantics:
    a one-shot :class:`UncertaintyServer` (its engines are built for this
    batch and dropped; a serving loop holds a server instead).

    ``model`` is a ``LlamaLM``-style model of the port; ``tokenizer`` has
    ``decode(List[int]) -> str`` or is None (token-id lists are then the
    "texts"). ``uncertainty_requests`` are ``[{"method_name": ...}, ...]``:
    perplexity, generation_entropy, RAUQ (original / original),
    normalized_entropy, semantic_entropy, eigen_score. ``engine_kwargs`` go
    to every engine (slots, chunking, a draft model, ``use_graph``).
    ``fused`` drains with ``generate_all_fused``.

    Returns (deterministic texts, scores): one text and one score dict per
    prompt, the keys ``compute_uncertainties``'.
    """
    server = UncertaintyServer(
        model, tokenizer, uncertainty_requests, num_samples=num_samples, max_new_tokens=max_new_tokens,
        eos_id=eos_id, temperature=temperature, entailment_model=entailment_model,
        entailment_tokenizer=entailment_tokenizer, engine_kwargs=engine_kwargs, fused=fused,
        max_prompt_len=max(len(p) for p in prompts),
    )
    return server.serve(prompts)
