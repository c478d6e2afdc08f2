"""The port's checkpoint.py against runia_core_tpu's: the same .npz format
both ways.

- Round trips inside the port (the detectors of
  tests/test_adapters_checkpoint.py, PCA, a LaREx pipeline) give the scores
  of the state that was saved: 1e-6 relative, as the JAX tests hold theirs
  (the loaded tensors are the saved ones, bit for bit).
- An artifact written by the JAX package loads in the port and scores as
  JAX scores, and one written by the port loads in JAX and scores as the
  port does: a detector and PCA to 1e-5 relative to the largest score (f32
  sums in other orders); a LaREx pipeline, whose scores run the model's
  forward first, to tests/test_torch_larex_slice.py's 1e-4 (whitening
  amplifies the taps' rounding).
- ``load_llm`` of a JAX-written small ``LlamaLM`` (f32, and int8 + bf16)
  gives JAX's logits to 1e-5 of their largest magnitude (the bound of
  tests/test_torch_llama.py), and a port-written one loads in JAX.
- The ``torch.distributed.checkpoint`` pair round-trips bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import runia_core_tpu.config
from runia_core_tpu import checkpoint as jax_checkpoint
from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.models import LlamaLM as JaxLlamaLM
from runia_core_tpu.models import quantize_llama_params as jax_quantize_llama_params
from runia_core_tpu.reduction import pca_fit as jax_pca_fit
from runia_core_tpu_torch import checkpoint
from runia_core_tpu_torch.config import Config
from runia_core_tpu_torch.detectors import (
    Energy,
    GMMLatentSpace,
    KDELatentSpace,
    MDLatentSpace,
    ReAct,
)
from runia_core_tpu_torch.models import build_tapped_forward, pca_state_from_arrays
from runia_core_tpu_torch.reduction import pca_fit

from test_torch_larex_slice import fitted  # noqa: F401  (the module's JAX-fitted LaREx pipeline)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1.0)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


# ---- round trips inside the port --------------------------------------------

def _md(rng):
    md = MDLatentSpace()
    md.setup(_t(rng.randn(100, 16)))
    return md, _t(rng.randn(20, 16)), {}


def _kde(rng):
    kde = KDELatentSpace()
    kde.setup(_t(rng.randn(50, 8)))
    return kde, _t(rng.randn(10, 8)), {}


def _gmm(rng):
    g = GMMLatentSpace(cfg=Config(num_classes=3))
    g.setup(_t(rng.randn(120, 8)), ind_train_labels=torch.from_numpy(rng.randint(0, 3, 120)))
    return g, _t(rng.randn(10, 8)), {"name": "GMM", "cfg": Config(num_classes=3)}


def _energy(rng):
    e = Energy(flip_sign=False)
    e.setup(_t(rng.randn(100, 5)))
    return e, _t(rng.randn(100, 5)), {}


def _react(rng):
    train, valid = _t(np.abs(rng.randn(80, 12))), _t(np.abs(rng.randn(30, 12)))
    r = ReAct(flip_sign=False)
    r.setup(train, valid_feats=valid, final_linear_layer_params={"weight": _t(rng.randn(4, 12)),
                                                                 "bias": _t(rng.randn(4))})
    return r, valid, {}


@pytest.mark.parametrize("make", [_md, _kde, _gmm, _energy, _react], ids=["MD", "KDE", "GMM", "energy", "react"])
def test_detector_round_trip(make, rng, tmp_path):
    det, test, kw = make(rng)
    checkpoint.save_detector(tmp_path / "d.npz", det, name=kw.get("name"))
    loaded = checkpoint.load_detector(tmp_path / "d.npz", cfg=kw.get("cfg"), device="cpu")
    assert type(loaded) is type(det)
    if getattr(det, "threshold", None) is not None:
        assert loaded.threshold == pytest.approx(det.threshold)
    np.testing.assert_allclose(loaded.postprocess(test).numpy(), det.postprocess(test).numpy(), rtol=1e-6)


def test_pca_round_trip(rng, tmp_path):
    x, new = _t(rng.randn(100, 16)), _t(rng.randn(10, 16))
    _, pca = pca_fit(x, 4)
    checkpoint.save_pca(tmp_path / "pca.npz", pca)
    loaded = checkpoint.load_pca(tmp_path / "pca.npz", device="cpu")
    assert loaded.mean.device.type == "cpu" and loaded.whiten == pca.whiten
    np.testing.assert_allclose(loaded.transform(new).numpy(), pca.transform(new).numpy(), rtol=1e-5)


def test_state_dict_round_trip_keeps_arrays_and_scalars(tmp_path):
    state = {"a": torch.arange(6.0).reshape(2, 3), "b": np.int8([1, -2]), "s": 0.5, "n": None, "flag": True,
             "name": "x", "f32": np.float32(0.25)}
    checkpoint.save_state_dict(tmp_path / "s.npz", state)
    loaded = checkpoint.load_state_dict(tmp_path / "s.npz")
    np.testing.assert_array_equal(loaded["a"], state["a"].numpy())
    assert loaded["b"].dtype == np.int8 and loaded["s"] == 0.5 and loaded["n"] is None
    assert loaded["flag"] is True and loaded["name"] == "x" and loaded["f32"] == 0.25


def test_unregistered_detector_needs_a_name(tmp_path):
    class Unregistered(MDLatentSpace):
        pass

    with pytest.raises(ValueError, match="name="):
        checkpoint.save_detector(tmp_path / "u.npz", Unregistered())


# ---- across the two packages --------------------------------------------------

def test_jax_detector_loads_in_the_port_and_back(rng, tmp_path):
    train, test = rng.randn(100, 16).astype(np.float32), rng.randn(20, 16).astype(np.float32)
    md = JaxMD()
    md.setup(train)
    jax_checkpoint.save_detector(tmp_path / "jax_md.npz", md)
    port = checkpoint.load_detector(tmp_path / "jax_md.npz", device="cpu")
    _close(port.postprocess(_t(test)).numpy(), md.postprocess(test))

    checkpoint.save_detector(tmp_path / "port_md.npz", port)
    back = jax_checkpoint.load_detector(tmp_path / "port_md.npz")
    _close(np.asarray(back.postprocess(test)), port.postprocess(_t(test)).numpy())


def test_jax_gmm_with_cfg_loads_in_the_port(rng, tmp_path):
    from runia_core_tpu.detectors import GMMLatentSpace as JaxGMM

    train, labels, test = rng.randn(120, 8).astype(np.float32), rng.randint(0, 3, 120), rng.randn(10, 8)
    g = JaxGMM(cfg=runia_core_tpu.config.Config(num_classes=3))
    g.setup(train, ind_train_labels=labels)
    jax_checkpoint.save_detector(tmp_path / "g.npz", g, name="GMM")
    port = checkpoint.load_detector(tmp_path / "g.npz", cfg=Config(num_classes=3), device="cpu")
    _close(port.postprocess(_t(test)).numpy(), g.postprocess(test.astype(np.float32)))


def test_pca_across_the_packages(rng, tmp_path):
    x, new = rng.randn(100, 16).astype(np.float32), rng.randn(10, 16).astype(np.float32)
    _, pca = jax_pca_fit(x, 4)
    jax_checkpoint.save_pca(tmp_path / "jax_pca.npz", pca)
    port = checkpoint.load_pca(tmp_path / "jax_pca.npz", device="cpu")
    _close(port.transform(_t(new)).numpy(), np.asarray(pca.transform(new)))
    checkpoint.save_pca(tmp_path / "port_pca.npz", port)
    back = jax_checkpoint.load_pca(tmp_path / "port_pca.npz")
    _close(np.asarray(back.transform(new)), port.transform(_t(new)).numpy())


@pytest.mark.parametrize("detector", ["MD", "KDE"])
def test_larex_pipeline_across_the_packages(fitted, detector, tmp_path):  # noqa: F811
    from runia_core_tpu.inference import build_larex_scorer as jax_build_larex_scorer

    det = fitted["detectors"][detector]
    jax_checkpoint.save_larex_pipeline(tmp_path / "jax.npz", fitted["pca_state"], det.state, detector=detector)
    _, want = jax_build_larex_scorer(fitted["forward"], fitted["pca_state"], det.state, detector=detector)(
        jnp.asarray(fitted["images"]), fitted["key"])
    forward = build_tapped_forward(fitted["port"])
    port_scorer = checkpoint.load_larex_scorer(tmp_path / "jax.npz", forward, use_graph=False, device="cpu")
    _, got = port_scorer(torch.from_numpy(fitted["images"]), weights=fitted["weights"])
    _close(got.numpy(), np.asarray(want), 1e-4)

    pca = pca_state_from_arrays(fitted["pca_state"], device="cpu")
    state = {k: (torch.from_numpy(np.array(v)) if np.ndim(v) else float(np.asarray(v))) for k, v in det.state.items()}
    checkpoint.save_larex_pipeline(tmp_path / "port.npz", pca, state, detector=detector, mcd_samples_nro=16)
    scorer = jax_checkpoint.load_larex_scorer(tmp_path / "port.npz", fitted["forward"])
    _, back = scorer(jnp.asarray(fitted["images"]), fitted["key"])
    _close(np.asarray(back), got.numpy(), 1e-4)
    fused = checkpoint.load_larex_scorer(tmp_path / "port.npz", forward, fused=True, use_graph=False, device="cpu")
    _close(fused(torch.from_numpy(fitted["images"]), weights=fitted["weights"])[1].numpy(), got.numpy(), 1e-4)


_TINY = dict(vocab_size=61, num_layers=2, num_heads=4, num_kv_heads=2, d_model=32, hidden_dim=64, max_len=32)


@pytest.mark.parametrize("form", ["f32", "int8_bf16"])
def test_llm_across_the_packages(form, tmp_path):
    model = JaxLlamaLM(**_TINY)
    tokens = jnp.asarray(np.random.RandomState(1).randint(0, 61, (2, 9)))
    params = model.init(jax.random.key(0), tokens)
    if form == "int8_bf16":
        params = jax_quantize_llama_params(params)
        model = JaxLlamaLM(**_TINY, quantized=True, dtype=jnp.bfloat16)
    want = np.asarray(model.apply(params, tokens)[0], np.float32)
    jax_checkpoint.save_llm(tmp_path / "jax_llm.npz", model, params)
    port, tree = checkpoint.load_llm(tmp_path / "jax_llm.npz", device="cpu")
    assert type(port).__name__ == "LlamaLM" and port.num_kv_heads == 2
    assert port.dtype == (torch.bfloat16 if form == "int8_bf16" else torch.float32)
    if form == "int8_bf16":
        assert port.block_0.q.kernel_q.dtype == torch.int8 and tree["params"]["block_0"]["q"]["kernel_q"].dtype == np.int8
    with torch.inference_mode():
        got = port(torch.from_numpy(np.asarray(tokens)))[0].float().numpy()
    bound = 1e-5 if form == "f32" else 2e-2  # bf16 compute: both round to bf16 at other places
    _close(got, want, bound)

    checkpoint.save_llm(tmp_path / "port_llm.npz", port)
    model2, params2 = jax_checkpoint.load_llm(tmp_path / "port_llm.npz")
    assert model2.quantized == (form == "int8_bf16")
    np.testing.assert_array_equal(np.asarray(model2.apply(params2, tokens)[0], np.float32), want)


def test_orbax_counterpart_round_trips(tmp_path):
    state = {"params": {"w": torch.randn(4, 3), "b": np.arange(3, dtype=np.float32)},
             "step": torch.tensor(7), "q": torch.randint(-127, 128, (5,), dtype=torch.int8)}
    checkpoint.save_state_dict_orbax(tmp_path / "ckpt", state)
    loaded = checkpoint.load_state_dict_orbax(tmp_path / "ckpt")
    assert torch.equal(loaded["params"]["w"], state["params"]["w"])
    assert torch.equal(loaded["params"]["b"], torch.arange(3, dtype=torch.float32))
    assert int(loaded["step"]) == 7 and torch.equal(loaded["q"], state["q"])
    like = {"params": {"w": torch.zeros(4, 3), "b": torch.zeros(3)}, "step": torch.tensor(0),
            "q": torch.zeros(5, dtype=torch.int8)}
    into = checkpoint.load_state_dict_orbax(tmp_path / "ckpt", like=like)
    assert torch.equal(into["params"]["w"], state["params"]["w"]) and float(like["params"]["w"].abs().sum()) == 0.0
