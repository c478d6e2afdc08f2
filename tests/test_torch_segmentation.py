"""The port's ``SimpleSegmenter`` (``models/segmentation.py``) and LaREx over
segmentation against the JAX package, on the CPU.

A JAX ``SimpleSegmenter`` with seeded parameters is carried across by
``segmenter_from_flax``: logits and taps within 1e-4 of their largest
magnitude (f32). Then the LaREx flow of tests/test_segmentation.py on both
sides: ``FastMCDSamplesExtractor`` on the bottleneck tap with the JAX
extractor's DropBlock keep-weights injected into the port's, ``get_dl_h_z``
(kernel 1's plain version here) and an MD fit. Samples within 1e-5, the
entropies within 1e-4 and the MD scores within 1e-3 of their largest
magnitude (whitening amplifies the entropies' f32 rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.evaluation import get_dl_h_z as jax_get_dl_h_z
from runia_core_tpu.extraction import FastMCDSamplesExtractor as JaxFastExtractor
from runia_core_tpu.models import SimpleSegmenter as JaxSegmenter
from runia_core_tpu.models import build_tapped_forward as jax_tapped_forward
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu_torch.detectors import MDLatentSpace
from runia_core_tpu_torch.evaluation import get_dl_h_z
from runia_core_tpu_torch.extraction import FastMCDSamplesExtractor
from runia_core_tpu_torch.models import SimpleSegmenter, build_tapped_forward, segmenter_from_flax
from test_torch_deeplab import _close, _randomize

torch.set_num_threads(1)

IMG, CLASSES, FEATURES, S = 32, 5, 8, 8
P, BLOCK = 0.4, 3


@pytest.fixture(scope="module")
def segmenters():
    model = JaxSegmenter(num_classes=CLASSES, features=FEATURES)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    variables = _randomize(dict(shapes), np.random.RandomState(0))
    port = SimpleSegmenter(num_classes=CLASSES, features=FEATURES, device="cpu")
    port.load_state_dict(segmenter_from_flax(variables, device="cpu"))
    return model, variables, port


def test_forward_and_taps_match_jax(segmenters):
    model, variables, port = segmenters
    x = np.random.RandomState(1).rand(2, IMG, IMG, 3).astype(np.float32)
    want_logits, want_taps = jax.jit(model.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        logits, taps = port(torch.from_numpy(x))
    assert logits.shape == (2, IMG, IMG, CLASSES) and taps["pre_pool"].shape == (2, IMG // 4, IMG // 4, 4 * FEATURES)
    _close(logits, want_logits)
    for name in ("bottleneck", "pre_pool"):
        _close(taps[name], want_taps[name])


def test_larex_over_segmentation_with_injected_masks(segmenters):
    model, variables, port = segmenters
    rng = np.random.RandomState(2)
    loader = [(rng.rand(8, IMG, IMG, 3).astype(np.float32), np.zeros(8)) for _ in range(2)]
    key = jax.random.key(3)
    kw = dict(layer_type="Conv", reduction_method="fullmean", mcd_nro_samples=S, dropblock_probs=P,
              dropblock_sizes=BLOCK)
    want = JaxFastExtractor(model=jax_tapped_forward(model, variables), rng=key, **kw).get_ls_samples(loader)
    hw = IMG // 4
    draws = [[torch.from_numpy(np.array(jax_mc_weights(jax.random.fold_in(jax.random.fold_in(key, step), 0),
                                                       len(images), hw, hw, S, BLOCK, P)))]
             for step, (images, _) in enumerate(loader)]
    got = FastMCDSamplesExtractor(model=build_tapped_forward(port), device="cpu", **kw).get_ls_samples(
        loader, draws=draws)
    assert got["latent_space_means"].shape == (16 * S, 4 * FEATURES)
    _close(got["latent_space_means"], want["latent_space_means"], 1e-5)

    _, want_h = jax_get_dl_h_z(want["latent_space_means"], S)
    _, h_z = get_dl_h_z(got["latent_space_means"], S)
    _close(h_z, want_h)
    jax_md, md = JaxMD(), MDLatentSpace()
    jax_md.setup(want_h)
    md.setup(h_z)
    scores = md.postprocess(h_z)
    assert bool(torch.isfinite(scores).all())
    _close(scores, jax_md.postprocess(want_h), 1e-3)
