"""The port's feature and logit scorers and the rest of ``detectors/funcs.py``
against runia_core_tpu.

The data are ``tests/test_detectors_parity.py``'s shapes (200 train, 100
valid and 100 shifted OoD rows of 16 features, 4 classes; a (4, 16) final
layer). Scores agree within 1e-5 of the largest magnitude for the logit and
shaping scorers (energy, msp, gen, knn, ash, dice, react, dice_react) and
1e-4 for mahalanobis, vim and ddu, whose pseudo-inverses, eigenvectors and
Cholesky factors come from other LAPACK calls: both sides run f32 matmuls in
other orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu import detectors as jax_detectors
from runia_core_tpu.config import Config
from runia_core_tpu.detectors import funcs as jax_funcs
from runia_core_tpu_torch import detectors
from runia_core_tpu_torch.detectors import funcs

torch.set_num_threads(1)

LOGIT_NAMES = ("energy", "msp", "gen")
FEATURE_NAMES = ("knn", "ash", "dice", "react", "dice_react", "mahalanobis", "vim", "ddu")
LOOSE = ("mahalanobis", "vim", "ddu")


def _rel(name: str) -> float:
    return 1e-4 if name in LOOSE else 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    scale = max(1.0, float(np.abs(want[finite]).max())) if finite.any() else 1.0
    np.testing.assert_allclose(got[finite], want[finite], rtol=rel, atol=rel * scale)


def _features(rng, n, d=16, num_classes=4, shift=0.0):
    labels = rng.randint(0, num_classes, size=n)
    centers = rng.randn(num_classes, d) * 2.0
    return (centers[labels] + rng.randn(n, d) + shift).astype(np.float32), labels.astype(np.int64)


def _make_data():
    rng = np.random.RandomState(1)
    train, train_labels = _features(rng, 200)
    valid, _ = _features(rng, 100)
    ood, _ = _features(rng, 100, shift=3.0)
    fc = {"weight": rng.randn(4, 16).astype(np.float32) * 0.3, "bias": rng.randn(4).astype(np.float32) * 0.1}
    logits = {k: v @ fc["weight"].T + fc["bias"] for k, v in (("train", train), ("valid", valid), ("ood", ood))}
    return dict(train=train, train_labels=train_labels, valid=valid, ood=ood, fc=fc, logits=logits)


DATA = _make_data()


def _t(x):
    """A CPU tensor of an array (a dict of arrays: each)."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _a(x):
    """The array as the JAX package is given it (a dict of arrays: each)."""
    return {k: np.asarray(v) for k, v in x.items()} if isinstance(x, dict) else np.asarray(x)


def _fit_args(name, data, to):
    """(train data, setup kwargs, postprocess test data, postprocess kwargs) for a registry name."""
    if name in LOGIT_NAMES:
        return to(data["logits"]["train"]), {}, to(data["logits"]["ood"]), {}
    kw = {"valid_feats": to(data["valid"])}
    if name in ("mahalanobis", "ddu"):
        kw["train_labels"] = to(data["train_labels"])
    if name in ("ash", "dice", "react", "dice_react", "vim"):
        kw["final_linear_layer_params"] = to(data["fc"])
    post = {}
    if name == "vim":
        kw.update(train_logits=to(data["logits"]["train"]), valid_logits=to(data["logits"]["valid"]))
        post = {"logits": to(data["logits"]["ood"])}
    return to(data["train"]), kw, to(data["ood"]), post


def _fitted(name, flip_sign):
    jax_det = jax_detectors.postprocessors_dict[name](flip_sign=flip_sign)
    det = detectors.postprocessors_dict[name](flip_sign=flip_sign)
    x, kw, _, _ = _fit_args(name, DATA, _a)
    jax_det.setup(x, **kw)
    x, kw, _, _ = _fit_args(name, DATA, _t)
    det.setup(x, **kw)
    return jax_det, det


@pytest.mark.parametrize("flip_sign", [False, True])
@pytest.mark.parametrize("name", LOGIT_NAMES + FEATURE_NAMES)
def test_scores_thresholds_and_state_match_jax(name, flip_sign):
    jax_det, det = _fitted(name, flip_sign)
    _, _, want_in, want_kw = _fit_args(name, DATA, _a)
    _, _, got_in, got_kw = _fit_args(name, DATA, _t)
    want = jax_det.postprocess(want_in, **want_kw)
    got = det.postprocess(got_in, **got_kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _close(got, want, _rel(name))
    assert det.threshold == pytest.approx(jax_det.threshold, rel=_rel(name), abs=_rel(name))
    assert set(det.state) == set(jax_det.state)
    # The port's state round trip, and JAX's state carried across.
    for state in (det.state, {k: _t(v) if isinstance(v, (np.ndarray, jax.Array)) else v
                              for k, v in jax_det.state.items()}):
        loaded = type(det)(flip_sign=flip_sign)
        loaded.load_state(state)
        _close(loaded.postprocess(got_in, **got_kw), want, _rel(name))
        assert loaded.threshold == pytest.approx(jax_det.threshold, rel=_rel(name), abs=_rel(name))


def test_flip_sign_negates_scores_and_threshold_side():
    for name in ("energy", "knn", "vim"):
        _, plain = _fitted(name, False)
        _, flipped = _fitted(name, True)
        _, _, test, kw = _fit_args(name, DATA, _t)
        _close(flipped.postprocess(test, **kw), -plain.postprocess(test, **kw))


def test_postprocess_before_setup_and_missing_inputs_raise_as_jax():
    _, _, test, _ = _fit_args("energy", DATA, _t)
    with pytest.raises(AssertionError, match="setup"):
        detectors.Energy().postprocess(test)
    for name, missing in (("ddu", "valid_feats"), ("knn", "valid_feats"), ("mahalanobis", "train_labels"),
                          ("vim", "final_linear_layer_params"), ("ash", "valid_feats"), ("react", "valid_feats")):
        x, kw, _, _ = _fit_args(name, DATA, _a)
        kw.pop(missing)
        with pytest.raises(AssertionError) as want:
            jax_detectors.postprocessors_dict[name]().setup(x, **kw)
        x, kw, _, _ = _fit_args(name, DATA, _t)
        kw.pop(missing)
        with pytest.raises(AssertionError) as got:
            detectors.postprocessors_dict[name]().setup(x, **kw)
        assert str(got.value) == str(want.value)


def test_registry_holds_every_jax_key_alias_and_input_kind():
    assert set(jax_detectors.postprocessors_dict) <= set(detectors.postprocessors_dict)
    assert len(set(jax_detectors.postprocessors_dict.values())) == 16
    for name, cls in jax_detectors.postprocessors_dict.items():
        assert detectors.postprocessors_dict[name].__name__ == cls.__name__
        assert detectors.postprocessor_input_dict[name] == jax_detectors.postprocessor_input_dict[name]
    assert detectors.postprocessors_dict["LaRED"] is detectors.postprocessors_dict["KDE"]
    assert detectors.postprocessors_dict["LaREM"] is detectors.postprocessors_dict["MD"]
    assert detectors.postprocessors_dict["LaREK"] is detectors.postprocessors_dict["KNN"]
    assert set(jax_detectors.__all__) <= set(detectors.__all__)
    cfg = Config(num_classes=4, k_neighbors=5, gen_gamma=0.2, ash_percentile=70, react_percentile=80,
                 dice_percentile=60)
    for name, cls in detectors.postprocessors_dict.items():
        got, want = cls(cfg=cfg), jax_detectors.postprocessors_dict[name](cfg=cfg)
        for attr in ("num_classes", "k_neighbors", "gamma", "ash_percentile", "react_percentile",
                     "dice_percentile", "K"):
            assert getattr(got, attr, None) == getattr(want, attr, None), (name, attr)


def test_mahalanobis_pre_and_postprocess_match_jax():
    ind = {"train features": DATA["train"], "train labels": DATA["train_labels"]}
    want_mean, want_precision = jax_funcs.mahalanobis_preprocess(ind, 4)
    got_mean, got_precision = funcs.mahalanobis_preprocess(_t(ind), 4)
    _close(got_mean, want_mean)
    _close(got_precision, want_precision, 1e-4)
    _close(funcs.mahalanobis_postprocess(_t(DATA["ood"]), got_mean, got_precision, 4),
           jax_funcs.mahalanobis_postprocess(DATA["ood"], want_mean, want_precision, 4), 1e-4)


def test_dice_masked_weight_routed_layer_and_route_dice_match_jax():
    info = DATA["train"].mean(0)
    w, b = DATA["fc"]["weight"], DATA["fc"]["bias"]
    want_w = np.asarray(jax_funcs.dice_masked_weight(w, info, 90))
    got_w = funcs.dice_masked_weight(_t(w), _t(info), 90)
    np.testing.assert_array_equal(got_w.numpy(), want_w)  # the same entries kept, the others exactly 0
    _close(funcs.route_dice_logits(_t(DATA["ood"]), got_w, _t(b)),
           jax_funcs.route_dice_logits(DATA["ood"], want_w, b))
    _close(funcs.route_dice_logits(_t(DATA["ood"]), got_w, None),
           jax_funcs.route_dice_logits(DATA["ood"], want_w, None))
    want = jax_funcs.RouteDICE(16, 4, p=90, info=info, weight=w, bias_value=b)(DATA["ood"])
    got = funcs.RouteDICE(16, 4, p=90, info=_t(info), weight=_t(w), bias_value=_t(b))(_t(DATA["ood"]))
    _close(got, want)
    routed = funcs.RouteDICE(16, 4, bias=False, p=50, info=_t(info)).load_params(_t(w), _t(b))
    _close(routed.forward(_t(DATA["ood"])),
           jax_funcs.RouteDICE(16, 4, bias=False, p=50, info=info).load_params(w, b)(DATA["ood"]))
    with pytest.raises(AssertionError, match="p must be"):
        funcs.RouteDICE(16, 4, p=100)


@pytest.mark.parametrize("p", [65, 85, 90])
def test_ash_s_layers_match_jax(p):
    rng = np.random.RandomState(p)
    x = np.abs(rng.randn(8, 37)).astype(np.float32)  # continuous: no ties among the kept values
    _close(funcs.ash_s_linear_layer(_t(x), p), jax_funcs.ash_s_linear_layer(x, p))
    maps = np.abs(rng.randn(3, 4, 5, 6)).astype(np.float32)
    _close(funcs.ash_s_conv_layer(_t(maps), p), jax_funcs.ash_s_conv_layer(maps, p))


def test_ash_keeps_the_lower_index_of_tied_activations_as_jax():
    """Activations on a coarse grid (as bf16 taps give) tie at the top-k
    boundary; JAX's top_k keeps the lower index, and so does the port, so
    the ASH logits through a weight agree."""
    rng = np.random.RandomState(8)
    x = np.round(np.abs(rng.randn(16, 64)) * 4).astype(np.float32) / 4
    w = rng.randn(4, 64).astype(np.float32)
    want = np.asarray(jax_funcs.ash_s_linear_layer(x, 85))
    got = funcs.ash_s_linear_layer(_t(x), 85)
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    _close(got @ _t(w).T, want @ w.T)


def test_react_clip_and_generalized_entropy_match_jax():
    w, b = DATA["fc"]["weight"], DATA["fc"]["bias"]
    _close(funcs.react_clip_logits(_t(DATA["ood"]), 1.5, _t(w), _t(b)),
           jax_funcs.react_clip_logits(DATA["ood"], 1.5, w, b))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(DATA["logits"]["ood"]), axis=1))
    for m in (2, 4):
        _close(funcs.generalized_entropy(_t(probs), 0.1, m), jax_funcs.generalized_entropy(probs, 0.1, m))


def test_predictive_uncertainty_scores_match_jax():
    logits = np.random.RandomState(3).randn(40, 6).astype(np.float32)  # 10 images x 4 samples
    for got, want in zip(funcs.get_predictive_uncertainty_score(_t(logits), 4),
                         jax_funcs.get_predictive_uncertainty_score(logits, 4)):
        _close(got, want)
    with pytest.raises(AssertionError, match="divisible"):
        funcs.get_predictive_uncertainty_score(_t(logits[:-1]), 4)


def test_mcd_pred_uncertainty_score_matches_jax_on_its_draws():
    """JAX maps S forwards over split keys; the port runs them in turn. The
    port's forward is handed JAX's noise for each forward in order."""
    rng = np.random.RandomState(4)
    images, w = rng.randn(5, 16).astype(np.float32), rng.randn(16, 3).astype(np.float32)
    key, samples = jax.random.key(9), 6

    def jax_forward(k, x):
        return x @ w + 0.5 * jax.random.normal(k, (x.shape[0], 3))

    noise = iter([np.asarray(0.5 * jax.random.normal(k, (5, 3))) for k in jax.random.split(key, samples)])

    def port_forward(generator, x):
        assert isinstance(generator, torch.Generator)
        return x @ _t(w) + _t(next(noise))

    want = jax_funcs.get_mcd_pred_uncertainty_score(jax_forward, images, key, samples)
    got = funcs.get_mcd_pred_uncertainty_score(port_forward, _t(images), torch.Generator().manual_seed(0), samples)
    assert got[0].shape == (5, samples, 3)
    for g, wt in zip(got, want):
        _close(g, wt)


@pytest.mark.parametrize("channel_axis", [1, 3])
def test_dice_feat_mean_react_percentile_matches_jax(channel_axis):
    rng = np.random.RandomState(5)
    shape = (4, 6, 3, 3) if channel_axis == 1 else (4, 3, 3, 6)
    batches = [rng.rand(*shape).astype(np.float32) for _ in range(3)]
    want_mean, want_p = jax_funcs.get_dice_feat_mean_react_percentile(lambda x: x, [(b, 0) for b in batches], 90,
                                                                       channel_axis=channel_axis)
    got_mean, got_p = funcs.get_dice_feat_mean_react_percentile(lambda x: x, [(_t(b), 0) for b in batches], 90,
                                                                 channel_axis=channel_axis)
    _close(got_mean, want_mean)
    assert got_p == pytest.approx(want_p, rel=1e-6)


def test_gmm_fit_gathers_classes_as_jax_at_many_classes():
    """Forty classes in shuffled order, four of them empty: the class-order
    gather gives JAX's per-class (lax.map) means, covariances, rung and
    log-densities."""
    rng = np.random.RandomState(6)
    labels = rng.permutation(np.repeat(np.arange(36), 9))
    x = (2.0 * rng.randn(40, 5)[labels] + rng.randn(labels.size, 5)).astype(np.float32)
    want, want_jitter = jax_funcs.gmm_fit(x, labels, 40)
    got, got_jitter = funcs.gmm_fit(_t(x), _t(labels), 40)
    assert got.means.shape == (36, 5) and got_jitter == want_jitter
    _close(got.means, want.means)
    _close(got.chols @ got.chols.transpose(1, 2), np.einsum("cij,ckj->cik", want.chols, want.chols))
    _close(got.log_prob(_t(DATA["ood"][:, :5])), want.log_prob(DATA["ood"][:, :5]), 1e-4)
