"""Program ``llm_uncertainty``: the port's LLM uncertainty server, and how
its answers are judged.

The system under test is the program's own serving path, as a user runs
it: the configuration family's model (``families/<family>.py``) with the
seeded weights made on the device, an ``llm.UncertaintyServer`` over the
``ContinuousBatchingEngine`` with the traffic's methods and engine settings,
prompts submitted one at a time and scores streamed back as each request
finishes (``loads/complete.py``).

Its answers are each request's greedy tokens, the log-probability and
normalised entropy the decode loop harvested for each, and its scores
(perplexity, generation entropy, RAUQ). :func:`judge` has the plain
reference (``reference/<family>.py``: f32, no cache, no batching, its own
f32 router) run each sampled prompt with the program's tokens,
teacher-forced, and compares, over the sampled answers' positions:

* ``logprob_off_share``: the share of positions whose harvested log-prob of
  the emitted token lies more than the cell's ``tau`` from the reference's;
* ``entropy_off_share``: the share of positions whose harvested entropy
  (over the whole vocabulary, divided by its log) lies more than the cell's
  ``tau_entropy`` from the reference's;
* ``token_flip_share``: the share of positions whose emitted token is not
  the reference's argmax where the reference's top-2 logit margin exceeds
  the cell's ``margin`` (a greedy choice between two near-equal logits may
  go either way in bf16);
* ``score_gap``: the largest gap between a request's score and the
  reference's, over the three scores, relative to the reference's.

Shares and not maxima for the first three: with random weights the
logits sit in a narrow band (the emitted token's log-prob near -7.5, the
normalised entropy near 0.956), bf16 moves every position a little, and a
token whose top-8 experts hold a near-tie takes another expert in bf16
than in f32 and moves further. The largest gap over a sample is then set
by those few positions, and an fp8 forward's largest entropy gap reads
about what bf16's does, while the share past a threshold separates the two
seven- to ten-fold (PERF.md, section 4). The control is the reference with its weights and the inputs of
its products in fp8 e4m3 (``reference/precision.py``), its answers its own
argmax tokens.
"""

from __future__ import annotations

import importlib
import math
from types import SimpleNamespace
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import inputs
from portbench.reference.precision import CONTROLS

CHECKS = ("logprob_off_share", "entropy_off_share", "token_flip_share", "score_gap")
COMPARE = ("tau", "tau_entropy", "margin")
TAGS = {"lengths": 101, "tokens": 102, "warmup": 104}


def reference_family(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['family']}")


def prompt_pool(cfg: dict, traffic: dict, seed: int, device, tag: int, count: int, lengths=None) -> List[np.ndarray]:
    """``count`` prompts of seeded token ids drawn uniformly from the
    vocabulary, made on the device in one draw; their lengths log-uniform
    over the traffic's ``prompt_tokens`` unless given."""
    if lengths is None:
        lo, hi = traffic["prompt_tokens"]
        rng = np.random.default_rng(inputs.seed_word(seed, TAGS["lengths"], tag))
        lengths = np.minimum(np.exp(rng.uniform(math.log(lo), math.log(hi), count)).astype(np.int64), hi)
    ids = torch.randint(0, cfg["vocab_size"], (int(np.sum(lengths)),), device=device,
                        generator=inputs.generator(device, seed, TAGS["tokens"], tag)).cpu().numpy()
    return np.split(ids, np.cumsum(lengths)[:-1])


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The prompts: a pool of ``pool_prompts`` and the warm-up's own, as
    long as the shortest. The family and the reference each make the
    weights from the seed."""
    warm = traffic["warmup_prompts"]
    return {"pool": prompt_pool(cfg, traffic, seed, device, 0, traffic["pool_prompts"]),
            "warmup": prompt_pool(cfg, traffic, seed, device, TAGS["warmup"], warm, [traffic["prompt_tokens"][0]] * warm)}


def build(cfg: dict, traffic: dict, seed: int, made: dict, device) -> SimpleNamespace:
    from runia_core_tpu_torch.llm.serve_uncertainty import UncertaintyServer

    family = importlib.import_module(f"portbench.families.{cfg['family']}")
    model = family.build_model(cfg, seed, device, use_flash=traffic["use_flash"])
    server = UncertaintyServer(model, None, traffic["methods"], max_new_tokens=traffic["new_tokens"],
                               engine_kwargs=dict(traffic["engine"]))
    return SimpleNamespace(model=model, server=server, pool=made["pool"], warmup_pool=made["warmup"])


def checked_state(program: SimpleNamespace) -> None:
    return None


def release(program: SimpleNamespace) -> None:
    """Drops the server (its engine, cache and captured programs) and the model."""
    program.server = program.model = None


def rauq_alpha(traffic: dict) -> float:
    return next(float(m.get("alphas", [0.3])[0]) for m in traffic["methods"] if m["method_name"] == "RAUQ")


def compare(got: List[dict], want: List[dict], family, alpha: float, compared: dict) -> Dict[str, float]:
    """The four numbers of answers ``got`` (per request: ``tokens``,
    ``log_prob``, ``entropy``, ``scores``) against the reference's
    (``family.teacher_forced``'s, scored by ``family.scores``), with the
    cell's ``tau``, ``tau_entropy`` and ``margin``."""
    off, entropy_off, flips, positions, score_gap = 0, 0, 0, 0, 0.0
    for g, w in zip(got, want):
        dev = w["log_prob"].device
        lp = torch.as_tensor(g["log_prob"], dtype=torch.float64, device=dev)
        ent = torch.as_tensor(g["entropy"], dtype=torch.float64, device=dev)
        tokens = torch.as_tensor(g["tokens"], device=dev)
        off += int(((lp - w["log_prob"].double()).abs() > compared["tau"]).sum())
        entropy_off += int(((ent - w["entropy"].double()).abs() > compared["tau_entropy"]).sum())
        flips += int(((tokens != w["argmax"]) & (w["margin"] > compared["margin"])).sum())
        positions += lp.numel()
        for name, value in family.scores(w, alpha).items():
            gap = abs(float(g["scores"][name]) - value) / max(abs(value), 1e-6)
            score_gap = max(score_gap, gap if math.isfinite(gap) else math.inf)
    return {"logprob_off_share": off / positions, "entropy_off_share": entropy_off / positions,
            "token_flip_share": flips / positions, "score_gap": score_gap}


def judge(cfg: dict, traffic: dict, seed: int, made: dict, blocks: List[dict], state, device, compared: dict,
          controls: Sequence[str] = (), record: bool = False) -> dict:
    """The numbers of the sampled answers (``blocks``: per request its
    ``prompt``, ``tokens``, ``log_probs``, ``entropies`` and ``scores``)
    against the reference's teacher-forced run of the same tokens; each
    control is judged the same way on its own argmax tokens."""
    family = reference_family(cfg)
    alpha = rauq_alpha(traffic)
    prompts = [b["prompt"] for b in blocks]
    answers = [b["tokens"] for b in blocks]
    truth = family.teacher_forced(cfg, seed, prompts, answers, device)
    got = [{"tokens": b["tokens"], "log_prob": b["log_probs"], "entropy": b["entropies"], "scores": b["scores"]}
           for b in blocks]
    out = {"numbers": compare(got, truth, family, alpha, compared), "controls": {}}
    raw = {"program": got, "reference": truth}
    for control in controls:
        theirs = family.teacher_forced(cfg, seed, prompts, answers, device, quantize=CONTROLS[control])
        as_answers = [{"tokens": t["argmax"], "log_prob": t["log_prob"], "entropy": t["entropy"],
                       "scores": family.scores(t, alpha)} for t in theirs]
        out["controls"][control] = compare(as_answers, truth, family, alpha, compared)
        raw[f"control_{control}"] = as_answers
    if record:
        out["raw"] = {name: [{k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in a.items()} for a in answers]
                      for name, answers in raw.items()}
    return out
