"""Program ``larex``: the port's LaREx image scorer, and how its answers are judged.

The system under test is the program's own path, as a user runs it: the
tapped forward, the MC DropBlock samples, the marginal entropies, the PCA
fit, the detector's fit and ``build_larex_scorer``. The benchmark hands it
the seeded weights, the fit images and seeded generators, nothing else.

Its answers are each image's logits and score. :func:`judge` has the plain
reference (``reference/``) work out, from the same seeded weights, images
and draws, its own forward, keep-weights, entropies, PCA and detector, and
compares:

* ``logit_gap``: the largest |program logit - reference logit| over the
  sample, over the root mean square of the reference's logits;
* ``score_off_share``: the share of the sampled images whose program score
  lies more than the cell's ``tau`` standard deviations of the reference's
  scores from the reference's score of that image. The reference's PCA is
  its own: its components near the k-th turn under the bf16 forward's
  rounding, so each score carries some of that turn, most in the images
  farthest out; ``tau`` sits above what a sound program reads on all but a
  few images in a thousand, and a fault that moves the scores of a batch
  moves its share;
* ``pca_gap``: the program's fitted PCA state, by itself, against the
  reference's fit entropies (``reference.larex.pca_gap``).

The scores carry the keep-weights, the entropies, the projection and the
detector of every image, so a fault in any of those stages, in any batch,
shows in them.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import torch

from portbench import inputs
from portbench.reference import larex as ref_larex
from portbench.reference.precision import CONTROLS

# The numbers :func:`judge` returns, each held to a limit of the cell
# (``cells/<cell>.json``'s ``limits``), and the parameters it reads from the
# cell's ``compare``.
CHECKS = ("logit_gap", "score_off_share", "pca_gap")
COMPARE = ("tau",)


def reference_family(cfg: dict):
    return importlib.import_module(f"portbench.reference.{cfg['family']}")


class LarexProgram:
    """The fitted scorer of a configuration under a traffic mix's detector
    and route. ``fit_images`` / ``support_images`` are float images on the
    device; the keep-weights of each set are drawn by the program from one
    generator seeded with (seed, tag)."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, weights: dict, fit_images: torch.Tensor,
                 support_images, device):
        from runia_core_tpu_torch.detectors import KDELatentSpace, MDLatentSpace
        from runia_core_tpu_torch.inference import build_larex_scorer
        from runia_core_tpu_torch.reduction import apply_pca_ds_split, pca_transform

        family = importlib.import_module(f"portbench.families.{cfg['family']}")
        lx = cfg["larex"]
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.forward = family.build_forward(cfg, weights, device)
        self.rows = traffic["fit_batch"]
        h_fit = self.entropies(fit_images, inputs.generator(device, seed, inputs.TAGS["fit_draw"]))
        fitted, pca_state = apply_pca_ds_split(h_fit, nro_components=lx["pca_components"])
        detector = traffic["detector"]
        if detector["name"] == "MD":
            postprocessor = MDLatentSpace()
            postprocessor.setup(fitted)
            self.embeddings = fitted
        else:
            h_support = self.entropies(support_images, inputs.generator(device, seed, inputs.TAGS["support_draw"]))
            self.embeddings = pca_transform(pca_state, h_support)
            postprocessor = KDELatentSpace()
            postprocessor.setup(self.embeddings)
        self.detector_state = dict(postprocessor.state)
        if detector["name"] == "KDE":
            self.detector_state["bandwidth"] = detector["bandwidth"]
        self.pca = {"mean": pca_state.mean, "components": pca_state.components,
                    "variance": pca_state.explained_variance}
        self.scorer = build_larex_scorer(
            self.forward, pca_state, self.detector_state, lx["mc_samples"], lx["drop_prob"], lx["block_size"],
            tap=lx["tap"], detector=detector["name"], fused=traffic["route"] == "fused",
        )

    @torch.inference_mode()
    def entropies(self, images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """(N, C) marginal entropies of ``images``' MC samples, the
        keep-weights of all N drawn at once, the forward ``rows`` at a time."""
        from runia_core_tpu_torch.evaluation.entropy import neighbors_for
        from runia_core_tpu_torch.ops.entropy import marginal_entropy
        from runia_core_tpu_torch.ops.mc_entropy_cuda import mc_dropblock_weights
        from runia_core_tpu_torch.sampling import mc_dropblock_samples

        lx = self.cfg["larex"]
        h, w, c = lx["tap_shape"]
        weights = mc_dropblock_weights(images.shape[0], h, w, lx["mc_samples"], lx["block_size"], lx["drop_prob"],
                                       generator, self.device)
        out = []
        for start in range(0, images.shape[0], self.rows):
            tap = self.forward(images[start:start + self.rows])[1][lx["tap"]]
            if tuple(tap.shape[1:]) != (h, w, c):
                raise ValueError(f"the forward's tap is {tuple(tap.shape[1:])}, the configuration says {(h, w, c)}")
            mc = mc_dropblock_samples(tap.to(torch.float32).contiguous(), lx["mc_samples"], lx["block_size"],
                                      lx["drop_prob"], "Conv", channel_axis=3,
                                      weights=weights[start:start + self.rows])
            out.append(marginal_entropy(mc, neighbors_for(lx["mc_samples"])))
        return torch.cat(out)


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, Optional[torch.Tensor]]:
    """The seeded weights, fit images and (for LaRED) support images, on
    the device; handed alike to the program and to the reference."""
    lx, size = cfg["larex"], cfg["image_size"]
    made = {"weights": inputs.make_weights(reference_family(cfg).param_specs(cfg), seed, device),
            "fit_images": inputs.to_float(inputs.images_u8(lx["fit_images"], size, size, device, seed,
                                                           inputs.TAGS["fit"])),
            "support_images": None}
    if traffic["detector"]["name"] == "KDE":
        made["support_images"] = inputs.to_float(inputs.images_u8(traffic["detector"]["support_images"], size, size,
                                                                  device, seed, inputs.TAGS["support"]))
    return made


def build(cfg: dict, traffic: dict, seed: int, made: dict, device) -> LarexProgram:
    return LarexProgram(cfg, traffic, seed, made["weights"], made["fit_images"], made["support_images"], device)


def checked_state(program: LarexProgram) -> dict:
    """What of the program's fitted state the check holds by itself: its
    PCA (mean, components, variances)."""
    return program.pca


def reference(cfg: dict, traffic: dict, seed: int, made: dict, device,
              control: Optional[str] = None) -> ref_larex.Pipeline:
    """The reference pipeline on the benchmark's inputs, fitted; with
    ``control`` its forward rounds to that control's precision."""
    family = reference_family(cfg)
    quantize = CONTROLS[control] if control else None
    lx = cfg["larex"]
    hw = tuple(lx["tap_shape"][:2])

    def forward(images):
        return family.forward(made["weights"], images, cfg, quantize)

    fit = (made["fit_images"], inputs.uniforms(made["fit_images"].shape[0], lx, hw, device, seed,
                                               inputs.TAGS["fit_draw"]))
    support = None
    if made["support_images"] is not None:
        support = (made["support_images"], inputs.uniforms(made["support_images"].shape[0], lx, hw, device, seed,
                                                           inputs.TAGS["support_draw"]))
    return ref_larex.Pipeline(forward, lx, traffic["detector"], fit, support, traffic["fit_batch"])


@torch.inference_mode()
def answers_of(pipeline: ref_larex.Pipeline, cfg: dict, blocks: List[dict], device, redraw: int = 0) -> dict:
    """``pipeline``'s logits, entropies and scores of the blocks' images
    under the keep-weights each batch drew (``redraw`` > 0: under another
    draw, a fault's), concatenated."""
    lx = cfg["larex"]
    hw = tuple(lx["tap_shape"][:2])
    logits, h, scores = [], [], []
    for block in blocks:
        batch, parts = block["draw"]
        parts = tuple(parts) + ((redraw,) if redraw else ())
        uniforms = inputs.uniforms(batch, lx, hw, device, *parts)[block["rows"]]
        part = pipeline(block["images"], uniforms)
        for out, value in zip((logits, h, scores), part):
            out.append(value)
    return {"logits": torch.cat(logits).to(torch.float64), "h": torch.cat(h), "scores": torch.cat(scores)}


def compare(got_logits: torch.Tensor, got_scores: torch.Tensor, want: dict, tau: float) -> Dict[str, float]:
    """``logit_gap`` and ``score_off_share`` of answers against the
    reference's (``want``)."""
    dev = want["logits"].device
    got_logits, got_scores = got_logits.to(dev, torch.float64), got_scores.to(dev, torch.float64)
    off = (got_scores - want["scores"]).abs() / want["scores"].std()
    return {
        "logit_gap": float((got_logits - want["logits"]).abs().max() / want["logits"].square().mean().sqrt()),
        "score_off_share": float((off > tau).to(torch.float64).mean()),
    }


def judge(cfg: dict, traffic: dict, seed: int, made: dict, blocks: List[dict], state: dict, device,
          compared: dict, controls: Sequence[str] = (), record: bool = False) -> dict:
    """The numbers of the program's answers in ``blocks`` (and of each
    control's) against the reference; with ``record``, the per-image
    readings too: the program's, the reference's and each control's scores,
    the reference's scores under another draw (a fault's), and how much of
    each of the reference's eigenvectors the program's PCA spans."""
    tau = compared["tau"]
    truth = reference(cfg, traffic, seed, made, device)
    want = answers_of(truth, cfg, blocks, device)
    got_logits = torch.cat([b["logits"] for b in blocks])
    got_scores = torch.cat([b["scores"] for b in blocks])
    out = {"numbers": dict(compare(got_logits, got_scores, want, tau), pca_gap=truth.pca_gap(state)), "controls": {}}
    raw = {}
    if record:
        raw = {"program": got_scores.double(), "reference": want["scores"].cpu(),
               "fault_draw": answers_of(truth, cfg, blocks, device, redraw=99)["scores"].cpu(),
               "values": truth.whole["values"].cpu(), "overlap": overlap(state, truth.whole).cpu()}
    for control in controls:
        lower = reference(cfg, traffic, seed, made, device, control)
        theirs = answers_of(lower, cfg, blocks, device)
        out["controls"][control] = dict(compare(theirs["logits"], theirs["scores"], want, tau),
                                        pca_gap=truth.pca_gap(lower.state))
        if record:
            raw[f"control_{control}"] = theirs["scores"].cpu()
        del lower, theirs
    if record:
        out["raw"] = raw
    return out


def overlap(state: dict, whole: dict) -> torch.Tensor:
    """How much of each of the reference's eigenvectors the program's PCA
    components span: |P v_i|^2, over the eigenvectors in order."""
    v = state["components"].to(whole["vectors"].device, torch.float64)
    return (v @ whole["vectors"]).square().sum(dim=0)


def release(program: LarexProgram) -> None:
    """Drops what the program holds on the device."""
    program.scorer = program.forward = program.embeddings = program.detector_state = None
