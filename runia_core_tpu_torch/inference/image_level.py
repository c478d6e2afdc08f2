"""Online image-level LaREx / LaRD inference, in PyTorch.

Counterpart of ``runia_core_tpu/inference/image_level.py``:

* :class:`LaRExInference` / :class:`LaRDInference` keep the reference's
  object API (model + postprocessor + optional PCA, an MC sampler,
  ``get_score`` per batch and its ``record_time`` timing twins);
* :func:`build_larex_scorer` is the production scoring path: forward ->
  MC-DropBlock keep-weights -> per-dimension KL entropy -> PCA -> Mahalanobis
  or KDE score, with every stage on the model's device. As JAX runs it as
  one jitted program, the port runs it on a GPU as one CUDA graph
  (``utils/graphs.py``): captured per image shape and dtype and injected
  weights or not, and replayed for every later call. The graph draws the
  keep-weights from a generator of its own, lent the caller's state for the
  call, so a new generator per call replays too.

Two routes lead from the tap to the entropies:

* ``fused=False`` (the default), the JAX package's route: keep-weights ->
  ``bmm`` -> ``ops/entropy_cuda.py`` (CUDA kernel 1, marginal entropy);
* ``fused=True``: keep-weights -> ``ops/mc_entropy_cuda.py`` (CUDA kernel
  2, channel means and entropy in one pass over the tap). A sample count or
  tap beyond kernel 2's contract (``fused_mc_entropy_supported``) takes its
  plain version (``bmm`` then the sorted-window entropy) instead, chosen by
  shape before any launch.

The two give the same scores to the entropies' f32 rounding.

On CPU tensors both routes take the kernels' plain versions.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from runia_core_tpu_torch.detectors.base import Postprocessor, record_time
from runia_core_tpu_torch.detectors.latent import kde_log_density
from runia_core_tpu_torch.evaluation.entropy import neighbors_for
from runia_core_tpu_torch.ops.entropy import marginal_entropy
from runia_core_tpu_torch.ops.linalg import mahalanobis_quadform
from runia_core_tpu_torch.ops.mc_entropy_cuda import (
    MAP_DTYPES,
    fused_mc_entropy,
    fused_mc_entropy_plain,
    fused_mc_entropy_supported,
    mc_dropblock_weights,
)
from runia_core_tpu_torch.reduction import PCAState, apply_pca_transform, pca_transform
from runia_core_tpu_torch.sampling import MCSamplerModule, mc_dropblock_samples
from runia_core_tpu_torch.utils.graphs import CudaGraph, ProgramCache, drawing_from
from runia_core_tpu_torch.utils.profiling import span

__all__ = [
    "InferenceModule", "LaRDInference", "LaRExInference", "ObjectDetectionInferenceBase",
    "ProbabilisticInferenceModule", "build_larex_scorer",
]


class InferenceModule:
    """Base runtime-inference module: a model (images -> (outputs, taps))
    and a postprocessor."""

    def __init__(self, model, postprocessor):
        self.model = model
        self.postprocessor = postprocessor

    def get_score(self, input_image, *args, **kwargs):
        raise NotImplementedError


class ProbabilisticInferenceModule(InferenceModule):
    """An inference module carrying the MC-dropout configuration."""

    def __init__(self, model, postprocessor, drop_block_prob: float, drop_block_size: int, mcd_samples_nro: int):
        super().__init__(model, postprocessor)
        self.drop_block_prob = drop_block_prob
        self.drop_block_size = drop_block_size
        self.mcd_samples_nro = mcd_samples_nro


class ObjectDetectionInferenceBase(InferenceModule):
    """Object-detection inference base: the architecture string, its tap
    names (``hooked_layers``) and an optional PCA transform."""

    def __init__(self, model, postprocessor, architecture: str, hooked_layers=None, pca_transform=None,
                 rcnn_extraction_type: str = None):
        super().__init__(model, postprocessor)
        self.architecture = architecture
        self.rcnn_extraction_type = rcnn_extraction_type
        self.hooked_layers = hooked_layers
        self.pca_transform = pca_transform


class LaRExInference(InferenceModule):
    """LaREx online scoring: tap -> MC DropBlock -> entropy -> PCA -> density.

    ``model`` is a tapped forward (``models.build_tapped_forward`` or
    ``extraction.tap_torch_model``); ``layer_hook`` in ``get_score`` is the
    tap's name. ``mcd_sampler`` is built with the reference's keywords plus
    ``channel_axis`` and ``generator`` (which must live on the model's
    device) and kept as ``mc_sampler``; every score's MC samples come from
    ``mc_sampler(tap, weights=weights)``, which returns (B, S, d), or (S, d)
    for one image, and draws its masks unless keep-weights are injected. The
    tap is sampled in f32, as :func:`build_larex_scorer` samples it.
    """

    def __init__(
        self,
        model: Callable,
        postprocessor: Postprocessor,
        drop_block_prob: float,
        drop_block_size: int,
        mcd_samples_nro: int,
        mcd_sampler=MCSamplerModule,
        pca_transform=None,
        layer_type: str = "Conv",
        channel_axis: int = 3,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__(model, postprocessor)
        self.drop_block_prob = drop_block_prob
        self.drop_block_size = drop_block_size
        self.mcd_samples_nro = mcd_samples_nro
        self.layer_type = layer_type
        self.channel_axis = channel_axis
        self.pca_transform = pca_transform
        self.mc_sampler = mcd_sampler(
            mc_samples=mcd_samples_nro, layer_type=layer_type, drop_prob=drop_block_prob, block_size=drop_block_size,
            channel_axis=channel_axis, generator=generator,
        )

    def _mc_samples(self, taps: dict, layer_hook: str, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        samples = self.mc_sampler(taps[layer_hook].to(torch.float32), weights=weights)
        return samples if samples.ndim == 3 else samples[None]

    @torch.inference_mode()
    def get_score(self, input_image, layer_hook: str = "pre_pool", weights: Optional[torch.Tensor] = None):
        """Score a batch of images: (model outputs, per-image scores).
        ``weights`` (B, S, H*W) replaces the drawn keep-weights."""
        outputs, taps = self.model(input_image)
        mc_samples = self._mc_samples(taps, layer_hook, weights)
        sample_h_z = marginal_entropy(mc_samples, neighbors_for(self.mcd_samples_nro))
        if self.pca_transform is not None:
            sample_h_z = apply_pca_transform(sample_h_z, self.pca_transform)
        return outputs, self.postprocessor.postprocess(sample_h_z)

    @record_time
    def test_time_inference(self, input_image, layer_hook: str = "pre_pool"):
        """get_score + wall-clock seconds."""
        return self.get_score(input_image, layer_hook)

    @record_time
    @torch.inference_mode()
    def get_layer_mc_samples(self, input_image, layer_hook: str = "pre_pool"):
        """Forward and MC sampling only, (B, S, d) + seconds."""
        return self._mc_samples(self.model(input_image)[1], layer_hook)

    @record_time
    @torch.inference_mode()
    def get_mc_samples_full_inference(self, input_image, layer_hook: str = "pre_pool"):
        """The full-MCD baseline: ``mcd_samples_nro`` whole forwards, their
        taps concatenated on the batch axis, + seconds."""
        return torch.cat([self.model(input_image)[1][layer_hook] for _ in range(self.mcd_samples_nro)], dim=0)


class LaRDInference(InferenceModule):
    """LaRD: density of the spatially averaged tap, no MC sampling."""

    def __init__(self, model, postprocessor, pca_transform=None, layer_type="Conv", channel_axis: int = 3):
        super().__init__(model, postprocessor)
        self.layer_type = layer_type
        self.channel_axis = channel_axis
        self.pca_transform = pca_transform

    def _reduce(self, representation: torch.Tensor) -> torch.Tensor:
        if self.layer_type == "Conv" and representation.ndim == 4:
            return representation.mean(dim=(2, 3) if self.channel_axis == 1 else (1, 2))
        if representation.ndim > 2:
            return representation.mean(dim=1).reshape(representation.shape[0], -1)
        return representation

    @torch.inference_mode()
    def get_score(self, input_image, layer_hook: str = "pre_pool"):
        outputs, taps = self.model(input_image)
        latent_rep = self._reduce(taps[layer_hook])
        if self.pca_transform is not None:
            latent_rep = apply_pca_transform(latent_rep, self.pca_transform)
        return outputs, self.postprocessor.postprocess(latent_rep)

    @record_time
    def test_time_inference(self, input_image, layer_hook: str = "pre_pool"):
        return self.get_score(input_image, layer_hook)


_SCORER_PROGRAMS = 8  # graphs a scorer keeps (shapes), least recently used dropped


def build_larex_scorer(
    forward: Callable,
    pca_state: Optional[PCAState],
    detector_state: dict,
    mcd_samples_nro: int = 16,
    drop_block_prob: float = 0.5,
    drop_block_size: int = 3,
    tap: str = "pre_pool",
    channel_axis: int = 3,
    detector: str = "MD",
    fused: bool = False,
    use_graph: bool = True,
) -> Callable:
    """The LaREx pipeline as one callable.

    Args:
        forward: images -> (logits, taps dict).
        pca_state: fitted PCAState or None.
        detector_state: for 'MD' {"feats_mean", "precision"}; for 'KDE'
            {"train_embeddings", "bandwidth"}; tensors on the model's device.
        channel_axis: 3 for an NHWC tap (B, H, W, C), 1 for a channel-first
            one (B, C, H, W), which is permuted to NHWC once, before either
            route.
        detector: 'MD' (LaREM) or 'KDE' (LaRED).
        fused: route the tap through the fused kernel (see the module doc).
        use_graph: on a GPU, capture each (image shape and dtype, weights
            given or not) once into a CUDA graph and replay it; False runs
            every call eagerly. A capture that fails raises.

    Returns:
        ``score(images, generator=None, weights=None) -> (logits, scores (B,))``.
        ``weights`` (B, S, H*W) replaces the keep-weights drawn from
        ``generator`` (None: the device's default generator; tests inject
        the JAX package's weights); it is copied into the graph's input. A
        replay draws what the eager call would draw from ``generator`` and
        advances it alike. The results of a replay are copies: a later call
        does not overwrite them. ``score.draw_weights(batch, H, W,
        generator, device)`` draws the keep-weights a call draws and
        ``score.tap_size(images)`` gives the tap's (H, W)
        (``parallel.data_parallel_scorer`` splits a batch with them).
    """
    if detector not in ("MD", "KDE"):
        raise ValueError(f"Unsupported fused detector {detector}")
    if channel_axis not in (1, 3, -1):
        raise ValueError("channel_axis must be 1 or 3/-1")
    k_neighbors = neighbors_for(mcd_samples_nro)

    def run(images: torch.Tensor, generator: Optional[torch.Generator] = None,
            weights: Optional[torch.Tensor] = None):
        logits, taps = forward(images)
        # Scoring is f32 whatever the forward's dtype. A channels_last
        # forward gives an NHWC tap that is already contiguous, so
        # .contiguous() makes no copy on the GPU.
        latent = taps[tap]
        if channel_axis == 1:
            latent = latent.permute(0, 2, 3, 1)
        b, h, w, _ = latent.shape
        if weights is None:
            weights = mc_dropblock_weights(
                b, h, w, mcd_samples_nro, drop_block_size, drop_block_prob, generator, latent.device
            )
        if fused and fused_mc_entropy_supported(mcd_samples_nro, h * w, k_neighbors):
            # The kernel widens a bf16 tap in registers (exact), so the f32
            # copy is never made.
            if latent.dtype not in MAP_DTYPES:
                latent = latent.to(torch.float32)
            h_z = fused_mc_entropy(weights, latent.contiguous(), k_neighbors)
        elif fused:
            h_z = fused_mc_entropy_plain(weights, latent, k_neighbors)
        else:
            latent = latent.to(torch.float32).contiguous()
            mc = mc_dropblock_samples(
                latent, mcd_samples_nro, drop_block_size, drop_block_prob, "Conv",
                channel_axis=3, weights=weights,
            )
            h_z = marginal_entropy(mc, k_neighbors)
        if pca_state is not None:
            h_z = pca_transform(pca_state, h_z)
        if detector == "MD":
            scores = -mahalanobis_quadform(h_z, detector_state["feats_mean"], detector_state["precision"])
        else:
            scores = kde_log_density(h_z, detector_state["train_embeddings"], detector_state["bandwidth"])
        return logits, scores

    programs = ProgramCache(_SCORER_PROGRAMS)

    @torch.inference_mode()
    def score(images: torch.Tensor, generator: Optional[torch.Generator] = None,
              weights: Optional[torch.Tensor] = None):
        with span("runia.scorer.call"):
            if not (use_graph and images.is_cuda):
                return run(images, generator, weights)
            inputs = {"images": images} if weights is None else {"images": images, "weights": weights}
            graph = programs.get_or_build((tuple(images.shape), images.dtype, weights is not None),
                                          lambda: _capture(images.device, inputs))
            with span("runia.scorer.load"):
                graph.load(**inputs)
            with span("runia.scorer.replay"):
                if weights is not None:
                    outputs = graph.replay()
                else:
                    source = generator or torch.cuda.default_generators[graph.device.index]
                    with drawing_from(graph.generators[0], source):
                        outputs = graph.replay()
            with span("runia.scorer.copy_out"):
                return tuple(t.clone() for t in outputs)

    def _capture(device: torch.device, inputs: dict) -> CudaGraph:
        """The scorer's graph; one that draws its keep-weights owns the
        generator it draws from."""
        if "weights" in inputs:
            return CudaGraph(lambda images, weights: run(images, None, weights), inputs, device=device)
        own = torch.Generator(device=device)
        return CudaGraph(lambda images: run(images, own), inputs, generators=[own], device=device)

    def draw_weights(batch: int, height: int, width: int, generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
        """The (batch, S, H*W) keep-weights ``score`` draws from
        ``generator`` for a batch whose tap is H x W."""
        return mc_dropblock_weights(batch, height, width, mcd_samples_nro, drop_block_size, drop_block_prob,
                                    generator, device)

    @torch.inference_mode()
    def tap_size(images: torch.Tensor) -> Tuple[int, int]:
        """The (H, W) of the tap ``forward`` gives for ``images``."""
        latent = forward(images)[1][tap]
        return tuple(latent.shape[2:4] if channel_axis == 1 else latent.shape[1:3])

    score.draw_weights, score.tap_size = draw_weights, tap_size
    return score
