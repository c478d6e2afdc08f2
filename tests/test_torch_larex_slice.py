"""The LaREx scoring slice end to end: the port against runia_core_tpu.

The JAX side fits PCA and a detector on the entropies of a few dozen images
through a narrow flax ResNet-18 (CIFAR stem, 8 filters, randomised weights).
The weights, the PCAState and the detector state are carried across, and both
scorers score the same images; the port gets the JAX keep-weights
(mc_dropblock_weights(key, ...) is what the JAX scorer draws with ``key``).
On CPU tensors the port's two routes run the plain versions of its kernels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.detectors import KDELatentSpace as JaxKDE
from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.inference import LaRExInference as JaxLaRExInference
from runia_core_tpu.inference import build_larex_scorer as jax_build_larex_scorer
from runia_core_tpu.models import ResNet18 as JaxResNet18
from runia_core_tpu.models import build_tapped_forward as jax_tapped_forward
from runia_core_tpu.ops.entropy import marginal_entropy as jax_marginal_entropy
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu.reduction import apply_pca_ds_split as jax_pca_split
from runia_core_tpu.sampling import mc_dropblock_samples as jax_mc_samples
from runia_core_tpu_torch.detectors import KDELatentSpace, MDLatentSpace
from runia_core_tpu_torch.inference import LaRDInference, LaRExInference, build_larex_scorer
from runia_core_tpu_torch.models import (
    ResNet18,
    build_tapped_forward,
    detector_state_from_arrays,
    pca_state_from_arrays,
    resnet_from_flax,
)

torch.set_num_threads(1)

S, P, BS = 16, 0.5, 3
N_FIT, N_SCORE, PCA_DIMS = 48, 8, 16


def _randomize(tree, rng):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = _randomize(value, rng)
        elif name == "kernel":
            out[name] = (np.asarray(value) + 0.05 * rng.randn(*np.shape(value))).astype(np.float32)
        elif name in ("scale", "var"):
            out[name] = rng.uniform(0.5, 1.5, np.shape(value)).astype(np.float32)
        else:
            out[name] = (0.1 * rng.randn(*np.shape(value))).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.RandomState(0)
    model = JaxResNet18(num_classes=10, cifar_stem=True, num_filters=8)
    init = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    variables = {name: _randomize(init[name], rng) for name in ("params", "batch_stats")}
    forward = jax_tapped_forward(model, variables)
    _, taps = forward(jnp.asarray(rng.rand(N_FIT, 32, 32, 3).astype(np.float32)))
    mc = jax_mc_samples(jax.random.key(1), taps["pre_pool"], S, BS, P, "Conv", channel_axis=3)
    h_fit = np.asarray(jax_marginal_entropy(mc, 5))
    h_pca, pca_state = jax_pca_split(h_fit, nro_components=PCA_DIMS)
    detectors = {"MD": JaxMD(), "KDE": JaxKDE()}
    for det in detectors.values():
        det.setup(h_pca)

    port = ResNet18(num_classes=10, cifar_stem=True, num_filters=8, device="cpu")
    port.load_state_dict(resnet_from_flax(variables, device="cpu"))
    images = rng.rand(N_SCORE, 32, 32, 3).astype(np.float32)
    key = jax.random.key(7)
    weights = torch.tensor(np.asarray(jax_mc_weights(key, N_SCORE, 4, 4, S, BS, P)))
    return dict(forward=forward, pca_state=pca_state, detectors=detectors, port=port,
                images=images, key=key, weights=weights)


def _scores_close(got, want):
    # Entropies agree to ~1e-6 (test_torch_entropy.py) on taps that agree to
    # ~1e-5 relative (test_torch_resnet.py); whitening by 16 PCA components
    # fitted on 48 images amplifies that, so scores agree to 1e-4 relative.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("detector", ["MD", "KDE"])
def test_scorer_matches_jax(fitted, detector, fused):
    det = fitted["detectors"][detector]
    jax_score = jax_build_larex_scorer(fitted["forward"], fitted["pca_state"], det.state, S, P, BS,
                                       detector=detector)
    want_logits, want = jax_score(jnp.asarray(fitted["images"]), fitted["key"])
    score = build_larex_scorer(
        build_tapped_forward(fitted["port"]), pca_state_from_arrays(fitted["pca_state"], device="cpu"),
        detector_state_from_arrays(det.state, device="cpu"), S, P, BS, detector=detector, fused=fused,
    )
    logits, scores = score(torch.from_numpy(fitted["images"]), weights=fitted["weights"])
    assert scores.shape == (N_SCORE,) and bool(torch.isfinite(scores).all())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want_logits)).max())
    _scores_close(scores.numpy(), np.asarray(want))


def test_larex_inference_get_score_matches_jax(fitted):
    jax_det = fitted["detectors"]["MD"]
    want_outputs, want = JaxLaRExInference(
        fitted["forward"], jax_det, P, BS, S, pca_transform=fitted["pca_state"]
    ).get_score(jnp.asarray(fitted["images"]), key=fitted["key"])
    det = MDLatentSpace()
    det.load_state(detector_state_from_arrays(jax_det.state, device="cpu"))
    inference = LaRExInference(
        build_tapped_forward(fitted["port"]), det, P, BS, S,
        pca_transform=pca_state_from_arrays(fitted["pca_state"], device="cpu"),
    )
    outputs, scores = inference.get_score(torch.from_numpy(fitted["images"]), weights=fitted["weights"])
    _scores_close(scores.numpy(), np.asarray(want))
    (_, timed_scores), seconds = inference.test_time_inference(torch.from_numpy(fitted["images"]))
    assert timed_scores.shape == (N_SCORE,) and seconds > 0


def test_lard_inference_and_unknown_detector(fitted):
    det = KDELatentSpace()
    h = torch.rand(20, 64, generator=torch.Generator().manual_seed(0))
    det.setup(h)
    _, scores = LaRDInference(build_tapped_forward(fitted["port"]), det).get_score(
        torch.from_numpy(fitted["images"])
    )
    assert scores.shape == (N_SCORE,) and bool(torch.isfinite(scores).all())
    with pytest.raises(ValueError):
        build_larex_scorer(build_tapped_forward(fitted["port"]), None, {}, detector="GMM")
