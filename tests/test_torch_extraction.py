"""The image-level extractors and ``extraction/utils.py`` against
runia_core_tpu: the option matrix of ``tests/test_extraction_matrix.py``.

To hold the extractors alone, both sides read the same taps: the JAX
package's ``SimpleConvNet`` (16 px, ``pre_pool`` (B, 4, 4, 16) and
``penultimate`` (B, 16)), the port's forward handing its numbers over as
tensors. Every draw the JAX extractors make is injected into the port's: the
fast extractor's per-batch, per-layer DropBlock keep-weights and dropout keep
masks (``fold_in(fold_in(rng, step), layer)``), and the classic extractor's
input noise, which the port's stochastic model reads in the order the JAX
forwards draw it. Samples agree to 1e-6 relative to their largest magnitude.
"""

import copy
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu import extraction as jax_extraction
from runia_core_tpu.models import SimpleConvNet, build_tapped_forward
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu_torch import extraction

torch.set_num_threads(1)

IMG, S, N = 16, 4, 6
C_PRE, HW = 16, 4


def _close(got, want, rel=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def models():
    model = SimpleConvNet(num_classes=3, features=8)
    variables = model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))
    out = {}
    for axis in (3, 1):
        jax_fwd = build_tapped_forward(model, variables, taps=("pre_pool", "penultimate"),
                                       channel_first_taps=axis == 1)

        def port_fwd(images, jax_fwd=jax_fwd):
            logits, taps = jax_fwd(jnp.asarray(images.numpy()))
            return torch.tensor(np.asarray(logits)), {k: torch.tensor(np.asarray(v)) for k, v in taps.items()}

        out[axis] = (jax_fwd, port_fwd)
    return out


def _loader(seed, n=N, bs=3):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, IMG, IMG, 3).astype(np.float32)
    ys = rng.randint(0, 3, n)
    return [(xs[i:i + bs], ys[i:i + bs]) for i in range(0, n, bs)]


def _fast_draws(rng, loader, layers):
    """The JAX fast extractor's draws: per batch, per layer (kind, p, size)."""
    draws = []
    for step, (images, _) in enumerate(loader):
        b, per_layer = len(images), []
        for i, (kind, p, size, d) in enumerate(layers):
            key = jax.random.fold_in(jax.random.fold_in(rng, step), i)
            if kind == "Conv":
                per_layer.append(torch.tensor(np.asarray(jax_mc_weights(key, b, HW, HW, S, size, p))))
            else:
                keep = [np.asarray(jax.random.bernoulli(k, 1.0 - p, (b, d))) for k in jax.random.split(key, S)]
                per_layer.append(torch.from_numpy(np.stack(keep, axis=1)))
        draws.append(per_layer)
    return draws


def _same_results(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "gt_labels":
            np.testing.assert_array_equal(got[key].numpy(), value)
        else:
            _close(got[key], value)


@pytest.mark.parametrize("return_stds,raw_preds,gt_labels", list(itertools.product([False, True], repeat=3)))
def test_fast_conv_fullmean_option_matrix(models, return_stds, raw_preds, gt_labels):
    jax_fwd, port_fwd = models[3]
    loader = _loader(0)
    kw = dict(layer_type="Conv", reduction_method="fullmean", mcd_nro_samples=S, dropblock_probs=0.4,
              dropblock_sizes=3, return_stds=return_stds, return_raw_predictions=raw_preds,
              return_gt_labels=gt_labels)
    want = jax_extraction.FastMCDSamplesExtractor(model=jax_fwd, rng=jax.random.key(1), **kw).get_ls_samples(loader)
    got = extraction.FastMCDSamplesExtractor(model=port_fwd, device="cpu", **kw).get_ls_samples(
        loader, draws=_fast_draws(jax.random.key(1), loader, [("Conv", 0.4, 3, None)]))
    _same_results(got, want)
    assert got["latent_space_means"].shape == (N * S, C_PRE)
    if raw_preds:
        assert got["raw_preds"].shape == (N, 3)


@pytest.mark.parametrize("channel_axis", [3, 1])
@pytest.mark.parametrize("case", ["conv_mean", "conv_mean_stds", "fc_dropout", "multi_layer"])
def test_fast_layer_types_reductions_and_layouts(models, case, channel_axis):
    jax_fwd, port_fwd = models[channel_axis]
    loader = _loader(1)
    kw = dict(mcd_nro_samples=S, channel_axis=channel_axis)
    if case.startswith("conv_mean"):
        kw.update(layer_type="Conv", reduction_method="mean", dropblock_probs=0.4, dropblock_sizes=3,
                  return_stds=case.endswith("stds"))
        layers, d = [("Conv", 0.4, 3, None)], HW * C_PRE
    elif case == "fc_dropout":
        kw.update(layer_type="FC", reduction_method="mean", tap="penultimate", dropblock_probs=0.3,
                  dropblock_sizes=0)
        layers, d = [("FC", 0.3, 0, C_PRE)], C_PRE
    else:
        kw.update(layer_type="Conv", reduction_method="fullmean", tap=["pre_pool", "pre_pool"],
                  dropblock_probs=[0.3, 0.5], dropblock_sizes=[3, 2], return_stds=True)
        layers, d = [("Conv", 0.3, 3, None), ("Conv", 0.5, 2, None)], 2 * C_PRE
    want = jax_extraction.FastMCDSamplesExtractor(model=jax_fwd, rng=jax.random.key(2), **kw).get_ls_samples(loader)
    got = extraction.FastMCDSamplesExtractor(model=port_fwd, device="cpu", **kw).get_ls_samples(
        loader, draws=_fast_draws(jax.random.key(2), loader, layers))
    _same_results(got, want)
    assert got["latent_space_means"].shape == (N * S, d)


def test_fast_draws_from_its_generator(models):
    _, port_fwd = models[3]
    loader = _loader(2)
    kw = dict(layer_type="Conv", reduction_method="fullmean", mcd_nro_samples=S, dropblock_probs=0.4,
              dropblock_sizes=3, device="cpu")
    outs = [extraction.FastMCDSamplesExtractor(model=port_fwd, generator=torch.Generator().manual_seed(5),
                                               **kw).get_ls_samples(loader)["latent_space_means"]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    default = extraction.FastMCDSamplesExtractor(model=port_fwd, **kw)
    first = default.get_ls_samples(loader)["latent_space_means"]
    assert default.generator.initial_seed() == 0
    assert not torch.equal(first, default.get_ls_samples(loader)["latent_space_means"])  # the stream goes on
    assert extraction.FastMCDSamplesExtractor(model=port_fwd, layer_type="Conv", reduction_method="fullmean",
                                              dropblock_probs=[0.3, 0.5], dropblock_sizes=[3, 2]).taps == [
        "pre_pool", "pre_pool"]


def _noise(rng, loader):
    """The JAX classic extractor's input noise, in the order of its forwards."""
    noise = []
    for step, (images, _) in enumerate(loader):
        for key in jax.random.split(jax.random.fold_in(rng, step), S):
            noise.append(torch.tensor(np.asarray(jax.random.normal(key, images.shape)) * 0.01))
    return noise


def _stochastic(models, channel_axis, rng, loader):
    jax_fwd, port_fwd = models[channel_axis]
    noise = iter(_noise(rng, loader))

    def jax_model(images, key):
        return jax_fwd(images + jax.random.normal(key, images.shape) * 0.01)

    def port_model(images, generator):
        assert isinstance(generator, torch.Generator)
        return port_fwd(images + next(noise))

    return jax_model, port_model


@pytest.mark.parametrize("channel_axis", [3, 1])
@pytest.mark.parametrize("reduction_,pool", [("fullmean", None), ("mean", None), ("avgpool", (2, 2, 0)),
                                             ("avgpool", (4, 4, 0)), ("avgpool", (3, 1, 1))])
def test_classic_reductions_match_jax(models, reduction_, pool, channel_axis):
    loader = _loader(3)
    jax_model, port_model = _stochastic(models, channel_axis, jax.random.key(4), loader)
    kw = dict(layer_type="Conv", reduction_method=reduction_, mcd_nro_samples=S, avg_pooling_parameters=pool,
              channel_axis=channel_axis, return_raw_predictions=True)
    want, want_raw = jax_extraction.MCDSamplesExtractor(model=jax_model, rng=jax.random.key(4), **kw).get_ls_samples(
        loader)
    got, got_raw = extraction.MCDSamplesExtractor(model=port_model, device="cpu", **kw).get_ls_samples(loader)
    _close(got, want)
    _close(got_raw, want_raw)
    d = {"fullmean": C_PRE, "mean": HW * C_PRE}.get(reduction_)
    if pool is not None:  # (H + 2p - k) // s + 1 per side, padding counted in the k * k divisor
        d = ((HW + 2 * pool[2] - pool[0]) // pool[1] + 1) ** 2 * C_PRE
    assert got.shape == (N * S, d) and got_raw.shape == (N * S, 3)


def test_classic_fc_and_single_image_batches(models):
    loader = _loader(4, n=3, bs=1)
    jax_model, port_model = _stochastic(models, 3, jax.random.key(6), loader)
    kw = dict(layer_type="FC", reduction_method="mean", tap="penultimate", mcd_nro_samples=S)
    want = jax_extraction.MCDSamplesExtractor(model=jax_model, rng=jax.random.key(6), **kw).get_ls_samples(loader)
    got = extraction.MCDSamplesExtractor(model=port_model, device="cpu", **kw).get_ls_samples(loader)
    _close(got, want)
    assert got.shape == (3 * S, C_PRE)
    assert len({tuple(row) for row in got[:S].numpy().round(7).tolist()}) == S  # S distinct realisations


def test_classic_nhwc_mean_is_c_major_as_nchw():
    t = np.random.RandomState(5).rand(2, HW, HW, C_PRE).astype(np.float32)
    outs = []
    for axis, tap in ((3, t), (1, t.transpose(0, 3, 1, 2))):
        ex = extraction.MCDSamplesExtractor(model=lambda images, gen, tap=tap: (None, {"pre_pool": torch.tensor(tap)}),
                                            layer_type="Conv", reduction_method="mean", mcd_nro_samples=S,
                                            channel_axis=axis, device="cpu")
        outs.append(ex.get_ls_samples(_loader(6, n=2, bs=2)))
    _close(outs[0], outs[1].numpy())


@pytest.mark.parametrize("helper", ["get_latent_representation_mcd_samples", "deeplabv3p_get_ls_mcd_samples"])
def test_deprecated_helpers_warn_and_match_jax(models, helper):
    loader = _loader(7)
    jax_model, port_model = _stochastic(models, 3, jax.random.key(8), loader)
    args = ("pre_pool", "Conv") if helper.startswith("get_latent") else ("pre_pool",)
    with pytest.warns(DeprecationWarning, match="deprecated") as jw:
        want = getattr(jax_extraction, helper)(jax_model, loader, S, *args, rng=jax.random.key(8))
    with pytest.warns(DeprecationWarning, match="deprecated") as pw:
        got = getattr(extraction, helper)(port_model, loader, S, *args, device="cpu")
    assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
    _close(got, want)


_ERRORS = [
    ("FastMCDSamplesExtractor", dict(layer_type="Dense", reduction_method="fullmean")),
    ("FastMCDSamplesExtractor", dict(layer_type="Conv", reduction_method="max")),
    ("FastMCDSamplesExtractor", dict(layer_type="FC", reduction_method="mean", return_stds=True)),
    ("MCDSamplesExtractor", dict(layer_type="Dense", reduction_method="fullmean")),
    ("MCDSamplesExtractor", dict(layer_type="Conv", reduction_method="max")),
    ("MCDSamplesExtractor", dict(layer_type="Conv", reduction_method="avgpool", avg_pooling_parameters=(2, 2))),
]


@pytest.mark.parametrize("cls,kw", _ERRORS, ids=[f"{c}-{i}" for i, (c, _) in enumerate(_ERRORS)])
def test_constructor_errors_have_the_jax_wording(models, cls, kw):
    jax_fwd, port_fwd = models[3]
    with pytest.raises((AssertionError, ValueError)) as want:
        getattr(jax_extraction, cls)(model=jax_fwd, **kw)
    with pytest.raises(ValueError) as got:
        getattr(extraction, cls)(model=port_fwd, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_deprecated_helper_refuses_a_layer_type_as_jax(models):
    with pytest.warns(DeprecationWarning), pytest.raises(AssertionError) as want:
        jax_extraction.get_latent_representation_mcd_samples(None, [], S, "pre_pool", "Dense")
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError) as got:
        extraction.get_latent_representation_mcd_samples(None, [], S, "pre_pool", "Dense", device="cpu")
    assert str(got.value) == str(want.value)


def _shared_dicts():
    rng = np.random.RandomState(9)
    per_image = {
        "img0": {"features": rng.rand(2, 4), "logits": rng.rand(2, 3), "latent_space_means": rng.rand(2, 5)},
        "img1": {"features": [], "logits": [], "latent_space_means": []},
        "img2": {"features": rng.rand(3, 4), "logits": rng.rand(3, 3), "latent_space_means": rng.rand(3, 5)},
        "no_obj": ["img1"],
    }
    return {"ood": per_image}


@pytest.mark.parametrize("probs_as_logits", [False, True])
def test_aggregation_utils_equal_jax(probs_as_logits):
    outs = []
    for module in (jax_extraction, extraction):
        data = _shared_dicts()
        agg, no_obj, owners = module.get_aggregated_data_dict(data, "ood", {}, {}, {}, probs_as_logits)
        scores = {"ood MD": np.arange(5.0), "ood KNN": -np.arange(5.0)}
        attached = module.associate_precalculated_baselines_with_raw_predictions(
            copy.deepcopy(data["ood"]), "ood", scores, ["MD", "KNN"], owners["ood"], is_ood=True)
        ind = module.associate_precalculated_baselines_with_raw_predictions(
            copy.deepcopy(data["ood"]), "ood", {"MD": np.ones(5)}, ["MD"], owners["ood"], is_ood=False)
        outs.append((agg, no_obj, owners, attached, ind))
    (want_agg, want_no, want_own, want_att, want_ind), (agg, no_obj, owners, attached, ind) = outs
    assert set(agg) == set(want_agg)
    for key in want_agg:
        np.testing.assert_array_equal(agg[key], want_agg[key])
    assert no_obj == want_no == {"ood": ["img1"]} and owners == want_own
    assert owners["ood"] == ["img0", "img0", "img2", "img2", "img2"]
    assert attached["img2"]["KNN"] == want_att["img2"]["KNN"] == [-2.0, -3.0, -4.0]
    assert ind["img0"]["MD"] == want_ind["img0"]["MD"]
