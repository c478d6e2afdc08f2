"""Per-pixel segmentation uncertainty: S stochastic forwards -> dense maps.

Counterpart of ``runia_core_tpu/inference/segmentation.py``. Per pixel, the
MC-dropout decomposition of ``detectors.funcs.get_mcd_pred_uncertainty_score``
over spatial maps:

  - ``pred_h``:  H[E_s p]          total predictive entropy
  - ``mi``:      pred_h - E_s H[p] mutual information (epistemic part)
  - ``msp``:     max_c E_s p       mean max-softmax
  - ``pred``:    argmax_c E_s p    the MC-marginal segmentation

The model contract is the port's stochastic forward: ``apply_fn(images,
generator) -> (logits, taps)`` or bare logits, per-pixel class logits (B, H,
W, C) with the dropout noise drawn from ``generator`` (e.g.
``DeepLabV3Plus(dropout_rate=0.5)``). Where the JAX package vmaps the S
forwards over split keys inside one jitted program, the port calls
``apply_fn`` S times in order, drawing in turn from one generator, and keeps
running sums of the probabilities and the per-sample entropies, so the (S, B,
H, W, C) stack is never held. On a GPU the S forwards and the decomposition
are one CUDA graph, captured per image shape and dtype and replayed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, drawing_from

__all__ = ["build_pixel_uncertainty_scorer"]

_EPS = 1e-12  # guards 0*log(0) at saturated pixels
_SCORER_PROGRAMS = 8  # graphs a scorer keeps (image shapes), least recently used dropped
_KEYS = ("pred", "pred_h", "mi", "msp")


def _default_generator(device: torch.device) -> torch.Generator:
    if device.type == "cuda":
        return torch.cuda.default_generators[device.index if device.index is not None else torch.cuda.current_device()]
    return torch.default_generator


def build_pixel_uncertainty_scorer(apply_fn: Callable, mc_samples: int = 8, use_graph: bool = True) -> Callable:
    """S stochastic forwards and the MC-dropout decomposition as one callable.

    Args:
        apply_fn: ``(images, generator) -> logits`` or ``(logits, taps)``.
        mc_samples: S, the forwards per call.
        use_graph: on a GPU, capture each image shape and dtype once into a
            CUDA graph and replay it; False runs every call eagerly. A
            capture that fails raises.

    Returns:
        ``score(images, generator=None) -> {"pred": (B, H, W) int32,
        "pred_h" / "mi" / "msp": (B, H, W) f32}``. The forwards draw from
        ``generator`` (None: the images' device's default generator); a
        replay draws what the eager call would draw and advances the
        generator alike. The maps of a replay are copies.
    """

    def run(images: torch.Tensor, generator: torch.Generator):
        p_sum = ent_sum = None
        for _ in range(mc_samples):
            out = apply_fn(images, generator)
            logits = out[0] if isinstance(out, tuple) else out
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            p = torch.exp(logp)
            ent = -(p * logp).sum(dim=-1)
            p_sum = p if p_sum is None else p_sum + p
            ent_sum = ent if ent_sum is None else ent_sum + ent
        p_mean = p_sum / mc_samples
        pred_h = -(p_mean * torch.log(p_mean + _EPS)).sum(dim=-1)
        exp_h = ent_sum / mc_samples
        return torch.argmax(p_mean, dim=-1).to(torch.int32), pred_h, pred_h - exp_h, p_mean.amax(dim=-1)

    programs = ProgramCache(_SCORER_PROGRAMS)

    def _capture(images: torch.Tensor) -> CudaGraph:
        own = torch.Generator(device=images.device)
        return CudaGraph(lambda images: run(images, own), {"images": images}, generators=[own],
                         device=images.device)

    @torch.inference_mode()
    def score(images: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        source = generator if generator is not None else _default_generator(images.device)
        if not (use_graph and images.is_cuda):
            return dict(zip(_KEYS, run(images, source)))
        graph = programs.get_or_build((tuple(images.shape), images.dtype), lambda: _capture(images))
        graph.load(images=images)
        with drawing_from(graph.generators[0], source):
            return dict(zip(_KEYS, (t.clone() for t in graph.replay())))

    return score
