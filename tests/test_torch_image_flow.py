"""The LaREx user flow end to end: the port against runia_core_tpu.

A narrow ResNet-18 (CIFAR stem, 8 filters, randomised weights, 16 px
images) is built in flax and carried across with ``resnet_from_flax``. The
port taps it with ``tap_torch_model`` at the last block of stage 3
(aliased ``pre_pool``: (B, 32, 4, 4) NCHW; flax's ``block3`` tap is its NHWC
twin), and both sides run the flow:

fast extractor (16 DropBlock samples, p 0.5, block 3) -> ``get_dl_h_z`` ->
PCA-8 -> MD, KDE, cMD, KNN and GMM fitted on the in-distribution
entropies -> thresholds -> ``LaRExInference(mcd_sampler=MCSamplerModule)``
scoring new images.

The port gets every keep-weight the JAX side draws. Taps agree to about
1e-5 relative; entropies and scores to 1e-4 relative to their largest
magnitude, the bound ``tests/test_torch_larex_slice.py`` argues for (PCA
whitening amplifies the taps' rounding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu import detectors as jax_detectors
from runia_core_tpu.evaluation import get_dl_h_z as jax_get_dl_h_z
from runia_core_tpu.extraction import FastMCDSamplesExtractor as JaxFast
from runia_core_tpu.inference import LaRExInference as JaxLaRExInference
from runia_core_tpu.models import ResNet18 as JaxResNet18
from runia_core_tpu.models import build_tapped_forward as jax_tapped_forward
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu.reduction import apply_pca_ds_split as jax_pca_split
from runia_core_tpu.sampling import MCSamplerModule as JaxSampler
from runia_core_tpu_torch import detectors
from runia_core_tpu_torch.evaluation import get_dl_h_z
from runia_core_tpu_torch.extraction import FastMCDSamplesExtractor, tap_torch_model
from runia_core_tpu_torch.inference import LaRExInference, get_baselines_thresholds
from runia_core_tpu_torch.models import ResNet18, resnet_from_flax
from runia_core_tpu_torch.reduction import apply_pca_ds_split
from runia_core_tpu_torch.sampling import MCSamplerModule, mc_dropblock_samples

torch.set_num_threads(1)

IMG, S, P, BS, K_TAP = 16, 16, 0.5, 3, 4  # K_TAP: the tap's 4 x 4 positions
N_FIT, BATCH, N_SCORE, PCA_DIMS, CLASSES = 96, 32, 8, 8, 3
NAMES = ["MD", "KDE", "cMD", "KNN", "GMM"]


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


def _close(got, want, rel=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def flow():
    rng = np.random.RandomState(0)
    model = JaxResNet18(num_classes=CLASSES, cifar_stem=True, num_filters=8)
    init = model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    variables = {name: _randomize(init[name], rng) for name in ("params", "batch_stats")}
    jax_forward = jax_tapped_forward(model, variables, taps=("block3",))
    port = ResNet18(num_classes=CLASSES, cifar_stem=True, num_filters=8, device="cpu")
    port.load_state_dict(resnet_from_flax(variables, device="cpu"))
    tapped = tap_torch_model(port.eval(), ("stage3_block1",), tap_aliases={"pre_pool": "stage3_block1"},
                             device="cpu")

    def port_forward(images):  # the ResNet returns (logits, its own taps): keep the logits
        (logits, _), taps = tapped(images)
        return logits, taps

    images = rng.rand(N_FIT, IMG, IMG, 3).astype(np.float32)
    labels = rng.randint(0, CLASSES, N_FIT)
    loader = [(images[i:i + BATCH], labels[i:i + BATCH]) for i in range(0, N_FIT, BATCH)]
    kw = dict(layer_type="Conv", reduction_method="fullmean", mcd_nro_samples=S, dropblock_probs=P,
              dropblock_sizes=BS, return_raw_predictions=True, return_gt_labels=True)
    want = JaxFast(model=jax_forward, tap="block3", rng=jax.random.key(1), **kw).get_ls_samples(loader)
    draws = [[torch.tensor(np.asarray(jax_mc_weights(jax.random.fold_in(jax.random.fold_in(jax.random.key(1), step),
                                                                          0), BATCH, K_TAP, K_TAP, S, BS, P)))]
             for step in range(len(loader))]
    got = FastMCDSamplesExtractor(model=port_forward, channel_axis=1, device="cpu", **kw).get_ls_samples(
        loader, draws=draws)

    fitted = {}
    for side, samples in (("jax", want), ("port", got)):
        h_joint, h = (jax_get_dl_h_z if side == "jax" else get_dl_h_z)(samples["latent_space_means"], S)
        h_pca, pca = (jax_pca_split if side == "jax" else apply_pca_ds_split)(h, PCA_DIMS)
        registry = (jax_detectors if side == "jax" else detectors).postprocessors_dict
        dets = {}
        for name in NAMES:
            dets[name] = registry[name]()
            dets[name].setup(h_pca, ind_train_labels=samples["gt_labels"])
        fitted[side] = dict(samples=samples, h=h, h_joint=h_joint, h_pca=h_pca, pca=pca, dets=dets)
    score_images = rng.rand(N_SCORE, IMG, IMG, 3).astype(np.float32)
    key = jax.random.key(7)
    weights = torch.tensor(np.asarray(jax_mc_weights(key, N_SCORE, K_TAP, K_TAP, S, BS, P)))
    return dict(jax_forward=jax_forward, port_forward=port_forward, fitted=fitted, images=score_images, key=key,
                weights=weights)


def test_extractor_entropies_and_pca_match_jax(flow):
    want, got = flow["fitted"]["jax"], flow["fitted"]["port"]
    for key in ("latent_space_means", "raw_preds"):
        _close(got["samples"][key], want["samples"][key], rel=1e-5)
    np.testing.assert_array_equal(got["samples"]["gt_labels"].numpy(), want["samples"]["gt_labels"])
    assert got["samples"]["latent_space_means"].shape == (N_FIT * S, 32)
    _close(got["h"], want["h"])
    _close(got["h_joint"], want["h_joint"])
    _close(got["h_pca"], want["h_pca"])


@pytest.mark.parametrize("name", NAMES)
def test_latent_scorers_fit_on_the_flow_match_jax(flow, name):
    want, got = flow["fitted"]["jax"], flow["fitted"]["port"]
    kw = {"pred_labels": np.zeros(N_FIT)} if name == "cMD" else {}
    want_scores = want["dets"][name].postprocess(np.asarray(want["h_pca"]), **kw)
    _close(got["dets"][name].postprocess(got["h_pca"], **kw), want_scores)
    if name == "GMM":  # the shared jitter rung is JAX's
        np.testing.assert_array_equal(got["dets"][name].gmm.jitter.numpy(), np.asarray(want["dets"][name].gmm.jitter))


def test_thresholds_from_in_distribution_scores_match_jax(flow):
    want, got = flow["fitted"]["jax"], flow["fitted"]["port"]
    names = ["raw", "MD", "KNN", "GMM"]
    want_scores = {name: want["dets"][name].postprocess(np.asarray(want["h_pca"])) for name in names[1:]}
    got_scores = {name: got["dets"][name].postprocess(got["h_pca"]) for name in names[1:]}
    want_thr = jax_detectors.get_baselines_thresholds(names, want_scores)
    got_thr = get_baselines_thresholds(names, got_scores)
    assert got_thr["raw"] == want_thr["raw"] == 0.0
    for name in names[1:]:
        scale = float(np.abs(want_scores[name]).max())
        assert abs(got_thr[name] - want_thr[name]) <= 1e-4 * scale


@pytest.mark.parametrize("name", ["MD", "KDE", "KNN", "GMM"])
def test_larex_inference_with_the_mcd_sampler_matches_jax(flow, name):
    want, got = flow["fitted"]["jax"], flow["fitted"]["port"]
    jax_inf = JaxLaRExInference(flow["jax_forward"], want["dets"][name], P, BS, S, mcd_sampler=JaxSampler,
                                pca_transform=want["pca"])
    inf = LaRExInference(flow["port_forward"], got["dets"][name], P, BS, S, mcd_sampler=MCSamplerModule,
                         pca_transform=got["pca"], channel_axis=1)
    assert isinstance(inf.mc_sampler, MCSamplerModule) and inf.mc_sampler.mc_samples == S
    want_out, want_scores = jax_inf.get_score(jnp.asarray(flow["images"]), layer_hook="block3", key=flow["key"])
    out, scores = inf.get_score(torch.from_numpy(flow["images"]), weights=flow["weights"])
    _close(out, want_out, rel=1e-5)
    _close(scores, want_scores)


def test_larex_inference_draws_through_its_mcd_sampler(flow):
    """Every score's samples come from the sampler built from ``mcd_sampler``
    (with the inference's generator and layout), one image included."""

    class CountingSampler(MCSamplerModule):
        calls = 0

        def __call__(self, latent_rep, weights=None):
            CountingSampler.calls += 1
            return super().__call__(latent_rep, weights=weights)

    got = flow["fitted"]["port"]
    gen = torch.Generator().manual_seed(3)
    inf = LaRExInference(flow["port_forward"], got["dets"]["MD"], P, BS, S, mcd_sampler=CountingSampler,
                         pca_transform=got["pca"], channel_axis=1, generator=gen)
    assert inf.mc_sampler.generator is gen and inf.mc_sampler.channel_axis == 1
    images = torch.from_numpy(flow["images"])
    samples, _ = inf.get_layer_mc_samples(images)
    want = mc_dropblock_samples(flow["port_forward"](images)[1]["pre_pool"], S, BS, P, "Conv", channel_axis=1,
                                generator=torch.Generator().manual_seed(3))
    assert torch.equal(samples, want)
    _, one = inf.get_score(images[:1])
    _, scores = inf.get_score(images, weights=flow["weights"])
    assert CountingSampler.calls == 3 and one.shape == (1,) and scores.shape == (N_SCORE,)


def test_larex_inference_timing_twins(flow):
    got = flow["fitted"]["port"]
    inf = LaRExInference(flow["port_forward"], got["dets"]["MD"], P, BS, S, pca_transform=got["pca"],
                         channel_axis=1, generator=torch.Generator().manual_seed(0))
    samples, seconds = inf.get_layer_mc_samples(torch.from_numpy(flow["images"]))
    assert samples.shape == (N_SCORE, S, 32) and seconds > 0
    taps, seconds = inf.get_mc_samples_full_inference(torch.from_numpy(flow["images"][:2]))
    assert taps.shape == (2 * S, 32, K_TAP, K_TAP) and seconds > 0
    assert torch.equal(taps[:2], taps[2:4])  # a deterministic forward gives the same tap every time
    with pytest.raises(ValueError, match="pred_logits not provided"):
        LaRExInference(flow["port_forward"], got["dets"]["cMD"], P, BS, S, pca_transform=got["pca"],
                       channel_axis=1).get_score(torch.from_numpy(flow["images"]), weights=flow["weights"])
