"""``inference/service.py::ScoringService`` against the JAX package's.

Both services stream the same batches through a LaREx scorer on the JAX
package's ``SimpleConvNet`` (16 px, 8 features, carried across with
``resnet_from_flax``). The port's scorer is wrapped so that batch i gets the
keep-weights the JAX service draws from ``fold_in(key, i)``; outputs agree
to 1e-5 relative (logits) and 1e-4 of max(|score|, 1) (scores: the JAX and
torch convolutions and entropies sum in other orders). On its own, the
port's service equals direct scorer calls with ``generator_for(i)`` bit for
bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.detectors import MDLatentSpace as JaxMD
from runia_core_tpu.inference import ScoringService as JaxScoringService
from runia_core_tpu.inference import build_larex_scorer as jax_build_larex_scorer
from runia_core_tpu.models import SimpleConvNet as JaxSimpleConvNet
from runia_core_tpu.models import build_tapped_forward as jax_tapped_forward
from runia_core_tpu.ops.mc_entropy_pallas import mc_dropblock_weights as jax_mc_weights
from runia_core_tpu_torch.inference import ScoringService, build_larex_scorer
from runia_core_tpu_torch.models import SimpleConvNet, build_tapped_forward, detector_state_from_arrays
from runia_core_tpu_torch.models import resnet_from_flax
from runia_core_tpu_torch.utils import NonFiniteError

torch.set_num_threads(1)

B, IMG, S, P, BS = 8, 16, 4, 0.4, 3
LOGITS_REL, SCORES_REL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def scorers():
    r = np.random.RandomState(0)
    model = JaxSimpleConvNet(num_classes=3, features=8)
    variables = jax.tree_util.tree_map(np.asarray, dict(model.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)))))
    md = JaxMD()
    md.setup(r.randn(64, 16).astype(np.float32))
    jax_scorer = jax_build_larex_scorer(jax_tapped_forward(model, variables), pca_state=None,
                                        detector_state=md.state, mcd_samples_nro=S, drop_block_prob=P,
                                        drop_block_size=BS)
    port = SimpleConvNet(num_classes=3, features=8, device="cpu")
    port.load_state_dict(resnet_from_flax(variables, device="cpu"))
    port_scorer = build_larex_scorer(build_tapped_forward(port), None,
                                     detector_state_from_arrays(md.state, device="cpu"), S, P, BS)
    return jax_scorer, port_scorer


class JaxDraws:
    """The port's scorer with, at its i-th call, the keep-weights the JAX
    service draws for batch i (``fold_in(key, i)``); the service's own
    generator is not used."""

    def __init__(self, scorer, key):
        self.scorer, self.key, self.calls = scorer, key, 0

    def __call__(self, images, generator):
        weights = jax_mc_weights(jax.random.fold_in(self.key, self.calls), images.shape[0], 4, 4, S, BS, P)
        self.calls += 1
        return self.scorer(images, weights=torch.from_numpy(np.asarray(weights)))


def _close(ours, theirs):
    logits, scores = ours
    jax_logits, jax_scores = np.asarray(theirs[0]), np.asarray(theirs[1])
    assert isinstance(logits, torch.Tensor) and logits.device.type == "cpu"
    np.testing.assert_allclose(logits.numpy(), jax_logits, rtol=0, atol=LOGITS_REL * np.abs(jax_logits).max())
    np.testing.assert_allclose(scores.numpy(), jax_scores, rtol=0,
                               atol=SCORES_REL * max(np.abs(jax_scores).max(), 1.0))


def _batches(rng, n):
    return [rng.rand(B, IMG, IMG, 3).astype(np.float32) for _ in range(n)]


def test_stream_equals_jaxs_in_order(scorers, rng):
    jax_scorer, port_scorer = scorers
    key = jax.random.key(3)
    batches = _batches(rng, 7)
    ours = list(ScoringService(JaxDraws(port_scorer, key), max_in_flight=3, device="cpu").score_stream(batches))
    theirs = list(JaxScoringService(jax_scorer, key=key, max_in_flight=3).score_stream(batches))
    assert len(ours) == len(theirs) == 7
    for got, want in zip(ours, theirs):
        _close(got, want)


def test_stream_equals_direct_calls_with_the_services_generators(scorers, rng):
    _, port_scorer = scorers
    batches = _batches(rng, 5)
    service = ScoringService(port_scorer, seed=11, max_in_flight=2, device="cpu")
    got = list(service.score_stream(iter(batches)))
    for i, (logits, scores) in enumerate(got):
        want_logits, want_scores = port_scorer(torch.from_numpy(batches[i]), service.generator_for(i))
        assert torch.equal(logits, want_logits) and torch.equal(scores, want_scores)


def test_generators_are_the_documented_function_of_seed_and_batch():
    service = ScoringService(lambda x, g: x, seed=5, device="cpu")
    draws = [torch.rand(4, generator=service.generator_for(i)) for i in (0, 1, 0)]
    word = np.random.SeedSequence((5, 1)).generate_state(1, np.uint64)[0]
    assert torch.equal(draws[0], draws[2]) and not torch.equal(draws[0], draws[1])
    assert torch.equal(draws[1], torch.rand(4, generator=torch.Generator().manual_seed(int(word))))


def test_tuple_batches_extras_ignored(scorers, rng):
    _, port_scorer = scorers
    service = ScoringService(port_scorer, device="cpu")
    out = list(service.score_stream(iter([(b, np.arange(B)) for b in _batches(rng, 2)])))
    assert len(out) == 2 and out[0][1].shape == (B,)


def test_window_smaller_than_stream(scorers, rng):
    jax_scorer, port_scorer = scorers
    key = jax.random.key(0)
    batches = _batches(rng, 4)
    ours = list(ScoringService(JaxDraws(port_scorer, key), max_in_flight=1, device="cpu").score_stream(batches))
    theirs = list(JaxScoringService(jax_scorer, key=key, max_in_flight=1).score_stream(batches))
    assert len(ours) == 4
    for got, want in zip(ours, theirs):
        _close(got, want)


def test_invalid_window(scorers):
    with pytest.raises(ValueError):
        ScoringService(scorers[1], max_in_flight=0, device="cpu")


@pytest.mark.parametrize("resize", [False, True])
def test_score_dataset_trims_the_ragged_tail_as_jaxs(scorers, rng, resize):
    jax_scorer, port_scorer = scorers
    key = jax.random.key(9)
    n = 3 * B + 5  # the last batch is 3 short
    size = 2 * IMG if resize else IMG
    images_u8 = (rng.rand(n, size, size, 3) * 255).astype(np.uint8)
    kw = {"resize_to": (IMG, IMG)} if resize else {}
    ours = ScoringService(JaxDraws(port_scorer, key), device="cpu").score_dataset(images_u8, batch_size=B, **kw)
    theirs = JaxScoringService(jax_scorer, key=key).score_dataset(images_u8, batch_size=B, **kw)
    assert ours[0].shape == (n, 3) and ours[1].shape == (n,)
    assert bool(torch.isfinite(ours[1]).all())
    _close(ours, theirs)


def test_score_dataset_native_equals_numpy_gather(scorers, rng):
    _, port_scorer = scorers
    images_u8 = (rng.rand(2 * B + 3, IMG, IMG, 3) * 255).astype(np.uint8)
    native = ScoringService(port_scorer, seed=2, device="cpu").score_dataset(images_u8, B)
    plain = ScoringService(port_scorer, seed=2, device="cpu").score_dataset(images_u8, B, native=False)
    assert all(torch.equal(a, b) for a, b in zip(native, plain))


def test_valid_rows_unaffected_by_padding(scorers, rng):
    """The real rows of a padded tail batch score as the same rows of a
    direct call of the scorer on the padded batch (per-image independence)."""
    _, port_scorer = scorers
    images_u8 = (rng.rand(B + 2, IMG, IMG, 3) * 255).astype(np.uint8)
    service = ScoringService(port_scorer, seed=4, device="cpu")
    _, scores = service.score_dataset(images_u8, batch_size=B)
    first = torch.from_numpy(images_u8[:B].astype(np.float32) * (1.0 / 255.0))
    _, direct = port_scorer(first, service.generator_for(0))
    assert torch.equal(scores[:B], direct)
    tail = torch.zeros((B, IMG, IMG, 3))
    tail[:2] = torch.from_numpy(images_u8[B:].astype(np.float32) * (1.0 / 255.0))
    assert torch.equal(scores[B:], port_scorer(tail, service.generator_for(1))[1][:2])


def test_check_finite_names_the_batch(rng):
    def bad_scorer(images, generator):
        return torch.zeros((images.shape[0], 2)), torch.full((images.shape[0],), float("nan"))

    service = ScoringService(bad_scorer, max_in_flight=2, check_finite=True, device="cpu")
    with pytest.raises(NonFiniteError, match=r"batch 0: non-finite in \{'\[1\]': 8\}"):
        list(service.score_stream(_batches(rng, 3)))


def test_any_output_structure_streams(rng):
    def dict_scorer(images, generator):
        return {"mean": images.mean(dim=(1, 2, 3)), "n": images.shape[0], "parts": (images[:, 0, 0, 0],)}

    out = list(ScoringService(dict_scorer, device="cpu").score_stream(_batches(rng, 2)))
    assert len(out) == 2 and out[0]["mean"].shape == (B,) and out[0]["n"] == B and out[1]["parts"][0].shape == (B,)


def test_the_service_runs_on_the_gpu_by_default(scorers, rng):
    """With no ``device`` the batches go to the GPU: on a host without one
    the first call raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    service = ScoringService(scorers[1])
    assert service.device == torch.device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        list(service.score_stream(_batches(rng, 1)))


def test_score_dataset_records_one_span_of_each_stage_a_batch(scorers, rng):
    """Inside a recording: one ``score_dataset`` root, and per batch one
    submit, fetch, scorer call and gather; the gathers run on the loader's
    thread and belong to the call (its trace, as their parent)."""
    import threading

    from runia_core_tpu_torch.utils.profiling import recording

    _, port_scorer = scorers
    images_u8 = (rng.rand(3 * B + 5, IMG, IMG, 3) * 255).astype(np.uint8)
    with recording() as rec:
        ScoringService(port_scorer, seed=6, max_in_flight=2, device="cpu").score_dataset(images_u8, B)
    spans = {}
    for s in rec.spans:
        spans.setdefault(s.name, []).append(s)
    (root,) = spans["runia.service.score_dataset"]
    assert root.parent is None and root.trace == root.id and root.thread == threading.get_ident()
    for name in ("runia.service.submit", "runia.service.fetch", "runia.loader.gather"):
        assert sorted(s.batch for s in spans[name]) == [0, 1, 2, 3], name
    assert len(spans["runia.scorer.call"]) == 4
    assert len(spans["runia.loader.wait"]) == 5  # one a batch, and the one that finds the loader done
    assert all(s.trace == root.id for s in rec.spans)
    for s in spans["runia.loader.gather"] + spans["runia.loader.wait"] + spans["runia.service.fetch"]:
        assert s.parent == root.id
    submits = {s.id for s in spans["runia.service.submit"]}
    assert all(s.parent in submits for s in spans["runia.scorer.call"])
    assert {s.thread for s in spans["runia.loader.gather"]} != {root.thread}
    summary = rec.summary()
    assert summary["runia.service.score_dataset"]["count"] == 1
    assert summary["runia.service.submit"]["self_ms"] < summary["runia.service.submit"]["total_ms"]


def test_answers_are_bitwise_equal_with_spans_recorded_profiled_or_off(scorers, rng, tmp_path):
    from runia_core_tpu_torch.utils import cuda_profile
    from runia_core_tpu_torch.utils.profiling import recording

    _, port_scorer = scorers
    images_u8 = (rng.rand(2 * B + 3, IMG, IMG, 3) * 255).astype(np.uint8)

    def call():
        return ScoringService(port_scorer, seed=8, device="cpu").score_dataset(images_u8, B)

    off = call()
    with recording() as rec:
        recorded = call()
    with cuda_profile(str(tmp_path)):
        profiled = call()
    assert rec.spans
    for got in (recorded, profiled):
        assert torch.equal(got[0], off[0]) and torch.equal(got[1], off[1])
