"""The port's training.py against runia_core_tpu's, on the same weights.

A (1, 1)-stage ResNet of 8 filters with the CIFAR stem and every weight and
statistic randomised is carried across with ``resnet_from_flax``; both sides
take one step on the same batch. Tolerances:

- SGD (``optax.sgd`` against ``torch.optim.SGD``): parameters after the step
  to 1e-5 of each tensor's largest magnitude (gradients are f32 sums in
  other orders, about 1e-6 relative, times the learning rate);
- Adam: its first step is +-lr * sign(g) and the sign of a g near 0 can
  flip, so the loss (1e-5 relative) and the gradients (1e-4 of each
  tensor's largest magnitude) are compared instead;
- BatchNorm running statistics after the step: 1e-6 (absolute and
  relative; they are means of conv outputs summed in other orders);
- ``accum_steps=4`` against the full batch without BatchNorm: JAX's own bar
  (tests/test_training.py: loss 1e-6 relative, parameters rtol 1e-5,
  atol 1e-7).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from runia_core_tpu.models import ResNet as JaxResNet
from runia_core_tpu.models.resnet import ResNetBlock as JaxBlock
from runia_core_tpu.training import TrainState as JaxTrainState
from runia_core_tpu.training import make_train_step as jax_make_train_step
from runia_core_tpu_torch.detectors import MDLatentSpace
from runia_core_tpu_torch.models import SimpleConvNet, build_tapped_forward, resnet_from_flax
from runia_core_tpu_torch.models.resnet import ResNet, ResNetBlock
from runia_core_tpu_torch.ops.entropy import marginal_entropy
from runia_core_tpu_torch.sampling import mc_dropblock_samples
from runia_core_tpu_torch.training import TrainState, create_train_state, fit_classifier, make_train_step

from test_torch_resnet import randomize

torch.set_num_threads(1)

LR = 0.05


@pytest.fixture(scope="module")
def carried():
    rng = np.random.RandomState(0)
    images = rng.rand(16, 8, 8, 3).astype(np.float32)
    labels = rng.randint(0, 4, 16).astype(np.int32)
    model = JaxResNet(stage_sizes=(1, 1), block_cls=JaxBlock, num_classes=4, num_filters=8, cifar_stem=True)
    init = model.init(jax.random.key(0), jnp.asarray(images))
    variables = {name: randomize(init[name], rng) for name in ("params", "batch_stats")}
    return model, variables, images, labels


def _port(variables, **kw):
    port = ResNet((1, 1), ResNetBlock, 4, num_filters=8, cifar_stem=True, device="cpu", **kw)
    port.load_state_dict(resnet_from_flax(variables, device="cpu"), strict=True)
    return port


def _jax_step(model, variables, tx, images, labels):
    state = JaxTrainState(params=variables["params"], extra_variables={"batch_stats": variables["batch_stats"]},
                          opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    state, metrics = jax_make_train_step(model, tx)(state, jnp.asarray(images), jnp.asarray(labels))
    return {"params": state.params, **state.extra_variables}, metrics


def _close_each(got: dict, want: dict, rel: float, atol=None):
    assert sorted(got) == sorted(want)
    for name in want:
        w = want[name].numpy()
        np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=rel,
                                   atol=rel * np.abs(w).max() if atol is None else atol, err_msg=name)


def test_one_sgd_step_matches_jax(carried):
    model, variables, images, labels = carried
    want, want_metrics = _jax_step(model, variables, optax.sgd(LR), images, labels)
    port = _port(variables)
    state, _ = create_train_state(port, tx=lambda p: torch.optim.SGD(p, lr=LR))
    state, metrics = make_train_step(port)(state, torch.from_numpy(images), torch.from_numpy(labels))
    assert state.step == 1 and not port.training
    assert float(metrics["loss"]) == pytest.approx(float(want_metrics["loss"]), rel=1e-5)
    assert float(metrics["accuracy"]) == pytest.approx(float(want_metrics["accuracy"]))
    carried_back = resnet_from_flax(jax.tree_util.tree_map(np.asarray, want), device="cpu")
    got = port.state_dict()
    params = {k: v for k, v in carried_back.items() if "running" not in k}
    stats = {k: v for k, v in carried_back.items() if "running" in k}
    _close_each({k: got[k] for k in params}, params, 1e-5)
    _close_each({k: got[k] for k in stats}, stats, 1e-6, atol=1e-6)
    moved = [k for k in stats if not torch.equal(stats[k], resnet_from_flax(variables, device="cpu")[k])]
    assert len(moved) == len(stats)  # every running statistic moved


def test_one_adam_step_matches_jax_in_loss_and_gradients(carried):
    model, variables, images, labels = carried
    _, want_metrics = _jax_step(model, variables, optax.adam(1e-3), images, labels)

    def loss(params):
        (logits, _), _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     jnp.asarray(images), train=True, mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(labels)).mean()

    grads = resnet_from_flax({"params": jax.tree_util.tree_map(np.asarray, jax.grad(loss)(variables["params"]))},
                             device="cpu")
    port = _port(variables)
    state, optimizer = create_train_state(port)  # the default: Adam(lr=1e-3), optax's adam
    assert isinstance(optimizer, torch.optim.Adam) and optimizer.defaults["lr"] == 1e-3
    _, metrics = make_train_step(port)(state, torch.from_numpy(images), torch.from_numpy(labels))
    assert float(metrics["loss"]) == pytest.approx(float(want_metrics["loss"]), rel=1e-5)
    named = dict(port.named_parameters())
    _close_each({k: named[k].grad for k in grads}, grads, 1e-4)


def test_accumulated_steps_equal_the_full_batch_without_batch_norm():
    rng = np.random.RandomState(1)
    images = torch.from_numpy(rng.rand(16, 16, 16, 3).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 3, 16))
    models = [SimpleConvNet(num_classes=3, features=4, device="cpu") for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    out = []
    for model, accum in zip(models, (1, 4)):
        state, opt = create_train_state(model, tx=lambda p: torch.optim.SGD(p, lr=0.1))
        out.append(make_train_step(model, accum_steps=accum)(state, images, labels)[1])
    assert float(out[0]["loss"]) == pytest.approx(float(out[1]["loss"]), rel=1e-6)
    assert float(out[0]["accuracy"]) == pytest.approx(float(out[1]["accuracy"]))
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-7)


def test_accumulation_threads_batch_statistics_per_microbatch(carried):
    """With BatchNorm each microbatch moves the running statistics once,
    from the last: two half-batch moves, not one full-batch move."""
    _, variables, images, labels = carried
    port, halves = _port(variables), _port(variables)
    state, _ = create_train_state(port, tx=lambda p: torch.optim.SGD(p, lr=0.0))
    make_train_step(port, accum_steps=2)(state, torch.from_numpy(images), torch.from_numpy(labels))
    halves.train()
    with torch.no_grad():
        halves(torch.from_numpy(images[:8]))
        halves(torch.from_numpy(images[8:]))
    for name, value in halves.state_dict().items():
        if "running" in name:
            assert torch.allclose(port.state_dict()[name], value, rtol=1e-6, atol=1e-7), name


def test_an_indivisible_batch_is_refused(carried):
    _, variables, images, labels = carried
    port = _port(variables)
    state, _ = create_train_state(port)
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        make_train_step(port, accum_steps=3)(state, torch.from_numpy(images), torch.from_numpy(labels))


def test_remat_gives_the_same_gradients_and_moves_statistics_once(carried):
    _, variables, images, labels = carried
    plain, remat = _port(variables), _port(variables, remat=True)
    for model in (plain, remat):
        state, _ = create_train_state(model, tx=lambda p: torch.optim.SGD(p, lr=LR))
        make_train_step(model)(state, torch.from_numpy(images), torch.from_numpy(labels))
    for (name, a), b in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad), name
    for name, value in plain.state_dict().items():
        assert torch.equal(remat.state_dict()[name], value), name


def two_blob_data(rng, n=128, img=12):
    labels = rng.randint(0, 2, n)
    images = rng.rand(n, img, img, 1).astype(np.float32) * 0.2
    for i, label in enumerate(labels):
        sl = slice(1, 5) if label == 0 else slice(7, 11)
        images[i, sl, sl, 0] += 1.0
    return images, labels


def test_train_then_tap_then_larex():
    """tests/test_training.py's story on the port: fit_classifier converges
    on two blobs (accuracy > 0.9), then tap -> MC DropBlock -> entropy ->
    LaREM scores are finite."""
    rng = np.random.RandomState(0)
    x, y = two_blob_data(rng)
    model = SimpleConvNet(num_classes=2, features=8, in_channels=1, device="cpu")
    model, metrics = fit_classifier(model, [(torch.from_numpy(x), torch.from_numpy(y))],
                                    generator=torch.Generator().manual_seed(0), epochs=25, learning_rate=5e-3)
    assert metrics["accuracy"] > 0.9, metrics
    _, taps = build_tapped_forward(model)(torch.from_numpy(x[:32]))
    mc = mc_dropblock_samples(taps["pre_pool"], 8, 2, 0.3, "Conv", channel_axis=3,
                              generator=torch.Generator().manual_seed(1))
    h_z = marginal_entropy(mc, 5)
    md = MDLatentSpace()
    md.setup(h_z)
    assert bool(torch.isfinite(md.postprocess(h_z)).all())


def test_train_state_counts_steps():
    model = SimpleConvNet(num_classes=2, features=2, in_channels=1, device="cpu")
    state, optimizer = create_train_state(model, tx=torch.optim.SGD(model.parameters(), lr=0.1))
    assert isinstance(state, TrainState) and state.optimizer is optimizer and state.step == 0
