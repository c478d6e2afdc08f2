"""The LaREx scorer's ``channel_axis``: a channel-first tap against the JAX
scorer and against the NHWC tap of the same images.

A narrow flax ResNet-18 (CIFAR stem, 8 filters, randomised weights) is
carried across as in tests/test_torch_larex_slice.py. The JAX scorer reads
its tap permuted to NCHW with ``channel_axis=1``; the port reads the
NCHW tap of ``build_tapped_forward(channel_first_taps=True)`` with
``channel_axis=1`` and the NHWC tap with ``channel_axis=3``. The port gets
the JAX keep-weights (they do not depend on the layout). The two port
layouts run the same arithmetic on the same numbers: they agree to 1e-6.
Against JAX the bound of tests/test_torch_larex_slice.py holds (1e-4
relative: whitening by 16 PCA components amplifies ~1e-6 entropy
differences).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.detectors import KDELatentSpace as JaxKDE
from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.inference import build_larex_scorer as jax_build_larex_scorer
from runia_core_tpu.models import ResNet18 as JaxResNet18
from runia_core_tpu.models import build_tapped_forward as jax_tapped_forward
from runia_core_tpu.ops.entropy import marginal_entropy as jax_marginal_entropy
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu.reduction import apply_pca_ds_split as jax_pca_split
from runia_core_tpu.sampling import mc_dropblock_samples as jax_mc_samples
from runia_core_tpu_torch.inference import build_larex_scorer
from runia_core_tpu_torch.models import (
    ResNet18,
    build_tapped_forward,
    detector_state_from_arrays,
    pca_state_from_arrays,
    resnet_from_flax,
)

torch.set_num_threads(1)

S, P, BS = 16, 0.5, 3
N_FIT, N_SCORE, PCA_DIMS = 40, 6, 16


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
    rng = np.random.RandomState(1)
    model = JaxResNet18(num_classes=10, cifar_stem=True, num_filters=8)
    init = model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    variables = {name: _randomize(init[name], rng) for name in ("params", "batch_stats")}
    nhwc = jax_tapped_forward(model, variables)

    def nchw(images):
        logits, taps = nhwc(images)
        return logits, {"pre_pool": jnp.transpose(taps["pre_pool"], (0, 3, 1, 2))}

    _, taps = nchw(jnp.asarray(rng.rand(N_FIT, 32, 32, 3).astype(np.float32)))
    mc = jax_mc_samples(jax.random.key(1), taps["pre_pool"], S, BS, P, "Conv", channel_axis=1)
    h_pca, pca_state = jax_pca_split(np.asarray(jax_marginal_entropy(mc, 5)), nro_components=PCA_DIMS)
    detectors = {"MD": JaxMD(), "KDE": JaxKDE()}
    for det in detectors.values():
        det.setup(h_pca)
    port = ResNet18(num_classes=10, cifar_stem=True, num_filters=8, device="cpu")
    port.load_state_dict(resnet_from_flax(variables, device="cpu"))
    key = jax.random.key(5)
    return dict(nchw=nchw, pca_state=pca_state, detectors=detectors, port=port, key=key,
                images=rng.rand(N_SCORE, 32, 32, 3).astype(np.float32),
                weights=torch.tensor(np.asarray(jax_mc_weights(key, N_SCORE, 4, 4, S, BS, P))))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("detector", ["MD", "KDE"])
def test_channel_first_tap_scores_as_jax_and_as_nhwc(fitted, detector, fused):
    det = fitted["detectors"][detector]
    jax_score = jax_build_larex_scorer(fitted["nchw"], fitted["pca_state"], det.state, S, P, BS,
                                       channel_axis=1, detector=detector)
    want_logits, want = jax_score(jnp.asarray(fitted["images"]), fitted["key"])

    def port_scorer(channel_first):
        return build_larex_scorer(
            build_tapped_forward(fitted["port"], channel_first_taps=channel_first),
            pca_state_from_arrays(fitted["pca_state"], device="cpu"),
            detector_state_from_arrays(det.state, device="cpu"), S, P, BS,
            channel_axis=1 if channel_first else 3, detector=detector, fused=fused,
        )

    images = torch.from_numpy(fitted["images"])
    logits, nchw = port_scorer(True)(images, weights=fitted["weights"])
    _, nhwc = port_scorer(False)(images, weights=fitted["weights"])
    assert nchw.shape == (N_SCORE,) and bool(torch.isfinite(nchw).all())
    torch.testing.assert_close(nchw, nhwc, rtol=1e-6, atol=1e-6 * float(nhwc.abs().max()))
    want = np.asarray(want)
    np.testing.assert_allclose(nchw.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(want_logits)).max())


def test_a_channel_first_tap_is_not_read_as_nhwc():
    """A (3, 8, 4, 4) tap scored with channel_axis=1
    gives the 8 channel entropies of its NHWC permutation, not 4 entropies
    over W; any other axis raises."""
    rng = np.random.RandomState(2)
    nhwc = torch.from_numpy(rng.rand(3, 4, 4, 8).astype(np.float32))
    weights = torch.from_numpy(rng.rand(3, S, 16).astype(np.float32))
    state = {"feats_mean": torch.zeros(8), "precision": torch.eye(8)}
    for fused in (False, True):
        want = build_larex_scorer(lambda x: (x, {"pre_pool": nhwc}), None, state, S, P, BS,
                                  fused=fused)(nhwc, weights=weights)[1]
        got = build_larex_scorer(lambda x: (x, {"pre_pool": nhwc.permute(0, 3, 1, 2)}), None, state, S, P, BS,
                                 channel_axis=1, fused=fused)(nhwc, weights=weights)[1]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="channel_axis"):
        build_larex_scorer(lambda x: (x, {}), None, state, channel_axis=2)
