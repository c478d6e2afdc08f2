"""The port's ViT (models/vit.py) against runia_core_tpu's flax ViT, on
weights carried across with ``vit_from_flax``, and ``convert_hf_vit``
against a ``transformers`` ViT built from a local ``ViTConfig`` with random
weights (no download).

Every flax parameter is randomised (a fresh init has zero biases and unit
LayerNorms, which would hide a swapped bias or scale). Both sides run f32;
the matmuls sum in other orders, so logits and taps agree to 1e-4 of their
largest magnitude; against HF, tests/test_torch_convert.py's bar (rtol
1e-4, atol 1e-5). The LaREx scorer on ``encoder_tokens`` agrees with JAX's
with JAX's keep-weights put in, to tests/test_torch_larex_slice.py's 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.inference import build_larex_scorer as jax_build_larex_scorer
from runia_core_tpu.models import ViT as JaxViT
from runia_core_tpu.models import build_tapped_forward as jax_tapped_forward
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu_torch.inference import build_larex_scorer
from runia_core_tpu_torch.models import ViT, build_tapped_forward, convert_hf_vit, vit_from_flax

torch.set_num_threads(1)

IMG, PATCH, D = 16, 4, 32
TAPS = ("encoder_tokens", "pre_head")


def _randomize(tree, rng):
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.1 * rng.randn(*np.shape(v))).astype(np.float32), tree)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel, atol=rel * np.abs(want).max())


def _carried(**kw):
    rng = np.random.RandomState(0)
    model = JaxViT(num_classes=5, patch_size=PATCH, d_model=D, num_layers=2, num_heads=2, **kw)
    variables = {"params": _randomize(model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))["params"], rng)}
    port = ViT(num_classes=5, patch_size=PATCH, d_model=D, num_layers=2, num_heads=2, image_size=IMG, device="cpu",
               **kw)
    port.load_state_dict(vit_from_flax(variables, device="cpu"), strict=True)
    return model, variables, port.eval()


@pytest.mark.parametrize("cls", [False, True])
@pytest.mark.parametrize("exact_gelu", [False, True])
def test_vit_matches_flax(cls, exact_gelu):
    kw = dict(use_cls_token=cls, pool="cls" if cls else "mean", exact_gelu=exact_gelu, ln_eps=1e-12 if cls else 1e-6)
    model, variables, port = _carried(**kw)
    images = np.random.RandomState(1).rand(3, IMG, IMG, 3).astype(np.float32)
    want_logits, want_taps = model.apply(variables, jnp.asarray(images))
    logits, taps = build_tapped_forward(port, TAPS)(torch.from_numpy(images))
    assert taps["encoder_tokens"].shape == (3, IMG // PATCH, IMG // PATCH, D) and taps["pre_head"].shape == (3, D)
    _close(logits.numpy(), want_logits)
    for name in TAPS:
        _close(taps[name].numpy(), want_taps[name])


def test_the_two_gelus_differ_and_bad_configurations_are_refused():
    images = torch.from_numpy(np.random.RandomState(2).rand(2, IMG, IMG, 3).astype(np.float32))
    _, _, tanh = _carried()
    _, _, erf = _carried(exact_gelu=True)
    assert not torch.equal(build_tapped_forward(tanh, TAPS)(images)[0], build_tapped_forward(erf, TAPS)(images)[0])
    with pytest.raises(ValueError, match="use_cls_token"):
        ViT(num_classes=2, pool="cls", device="cpu")
    with pytest.raises(ValueError, match="tile"):
        ViT(num_classes=2, patch_size=5, image_size=16, device="cpu")
    with pytest.raises(ValueError, match="tile"):
        tanh(torch.zeros(1, 18, 18, 3))


@pytest.fixture(scope="module")
def hf_vit():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.ViTConfig(image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
                                 num_attention_heads=4, intermediate_size=128, num_labels=5)
    torch.manual_seed(0)
    return transformers.ViTForImageClassification(cfg).eval()


def test_convert_hf_vit_matches_hf(hf_vit):
    model = convert_hf_vit(hf_vit, device="cpu")
    assert model.use_cls_token and model.pool == "cls" and not model.training
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = hf_vit(torch.from_numpy(x.transpose(0, 3, 1, 2))).logits.numpy()
    logits, taps = build_tapped_forward(model, TAPS)(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-5)
    assert taps["encoder_tokens"].shape == (3, 4, 4, 32) and taps["pre_head"].shape == (3, 32)


def test_larex_scorer_on_encoder_tokens_matches_jax():
    model, variables, port = _carried()
    rng = np.random.RandomState(3)
    forward = jax_tapped_forward(model, variables, taps=("encoder_tokens",))
    md = JaxMD()
    md.setup(rng.randn(64, D).astype(np.float32))
    images = rng.rand(4, IMG, IMG, 3).astype(np.float32)
    key = jax.random.key(5)
    kw = dict(mcd_samples_nro=8, drop_block_prob=0.4, drop_block_size=2, tap="encoder_tokens", channel_axis=3)
    want_logits, want = jax_build_larex_scorer(forward, None, md.state, **kw)(jnp.asarray(images), key)
    weights = torch.tensor(np.asarray(jax_mc_weights(key, 4, IMG // PATCH, IMG // PATCH, 8, 2, 0.4)))
    state = {name: torch.from_numpy(np.array(value)) for name, value in md.state.items()}
    for fused in (False, True):
        scorer = build_larex_scorer(build_tapped_forward(port, ("encoder_tokens",)), None, state, fused=fused, **kw)
        logits, scores = scorer(torch.from_numpy(images), weights=weights)
        _close(logits.numpy(), want_logits)
        _close(scores.numpy(), want)
