"""Failure detection of the port (``utils/health.py``) against the JAX
package's: the healthcheck's probe and deadline, ``find_nonfinite``'s keys
(equal to ``jax.tree_util.keystr``'s for the same structure), the finite
guard and the retries."""

import collections
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from runia_core_tpu.reduction import PCAState as JaxPCAState
from runia_core_tpu.utils import find_nonfinite as jax_find_nonfinite
from runia_core_tpu.utils import guard_finite as jax_guard_finite
from runia_core_tpu_torch.reduction import PCAState
from runia_core_tpu_torch.utils import (
    HealthCheckError,
    NonFiniteError,
    device_healthcheck,
    find_nonfinite,
    guard_finite,
    with_retries,
)
from runia_core_tpu_torch.utils import health

torch.set_num_threads(1)

Pair = collections.namedtuple("Pair", "first second")


def _tree(make, pca):
    """One nested structure with NaN / inf at known places, its arrays made
    by ``make`` from seeded numpy."""
    rng = np.random.RandomState(0)
    bad = rng.randn(3, 4).astype(np.float32)
    bad[1, 2], bad[0, 0] = np.nan, np.inf
    mean = np.array([1.0, np.nan], np.float32)
    return {
        "scores": make(bad),
        "good": [make(np.ones(4, np.float32)), (make(np.zeros(2, np.float32)), Pair(make(bad[:1]), make(bad)))],
        "ints": make(np.arange(3)),
        "pca": pca(make(mean), make(np.eye(2, dtype=np.float32)), make(np.array([np.inf, 1.0], np.float32))),
        "none": None,
    }


def test_find_nonfinite_keys_and_counts_equal_jaxs():
    ours = find_nonfinite(_tree(torch.from_numpy, PCAState))
    theirs = jax_find_nonfinite(_tree(jnp.asarray, JaxPCAState))
    assert ours == theirs
    assert ours["['scores']"] == 2 and ours["['good'][1][1].second"] == 2 and "['ints']" not in ours
    assert ours["['pca'][<flat index 0>]"] == 1


def test_find_nonfinite_of_a_clean_tree_is_empty():
    assert find_nonfinite({"a": torch.ones(3), "b": (torch.zeros(2),), "c": np.ones(2)}) == {}


def test_guard_passes_clean_outputs_through():
    f = guard_finite(lambda x: (x * 2, x.sum()))
    y, s = f(torch.ones(4))
    assert torch.equal(y, 2 * torch.ones(4)) and float(s) == 4.0


def test_guard_raises_with_jaxs_message():
    data = np.array([1.0, -1.0], np.float32)
    with pytest.raises(NonFiniteError, match="scores") as ours:
        guard_finite(lambda x: {"log": torch.log(x), "n": 2}, name="scores")(torch.from_numpy(data))
    with pytest.raises(Exception) as theirs:
        jax_guard_finite(lambda x: {"log": jnp.log(x), "n": 2}, name="scores")(jnp.asarray(data))
    assert str(ours.value) == str(theirs.value) == "scores: non-finite values in {\"['log']\": 1}"


def test_guard_reads_the_flags_once():
    """One stacked flag tensor and one host read, whatever the number of
    floating outputs; numpy leaves are checked on the host."""
    reads = []
    real = torch.Tensor.__bool__

    def counting(self):
        reads.append(self.shape)
        return real(self)

    f = guard_finite(lambda: [torch.ones(3), torch.zeros(2, 2), np.ones(2), torch.arange(3), {"x": torch.ones(1)}])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "__bool__", counting)
        f()
    assert reads == [torch.Size([])]


def test_guard_turns_a_singular_larem_into_an_error():
    """A LaREM scorer with a NaN precision scores NaN; the guard raises."""
    from runia_core_tpu_torch.detectors.latent import md_score

    feats = torch.from_numpy(np.random.RandomState(1).randn(4, 8).astype(np.float32))
    scorer = guard_finite(lambda x: md_score(x, torch.zeros(1, 8), torch.full((8, 8), float("nan"))), name="larem")
    with pytest.raises(NonFiniteError, match="larem"):
        scorer(feats)


def test_healthcheck_answers_on_the_cpu_as_jaxs_does():
    from runia_core_tpu.utils import device_healthcheck as jax_healthcheck

    assert device_healthcheck(device="cpu", timeout_s=60.0) > 0
    assert jax_healthcheck(jax.devices("cpu")[0], timeout_s=60.0) > 0


def test_healthcheck_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    with pytest.raises((RuntimeError, AssertionError)):  # torch built without CUDA asserts
        device_healthcheck(timeout_s=60.0)


def test_healthcheck_timeout_abandons_the_probe(monkeypatch):
    """A probe slower than the deadline raises at the deadline: the worker
    thread is abandoned, not joined."""
    real_eye = torch.eye
    release = threading.Event()

    def wedged_eye(*args, **kwargs):
        release.wait(10.0)
        return real_eye(*args, **kwargs)

    monkeypatch.setattr(health.torch, "eye", wedged_eye)
    start = time.perf_counter()
    with pytest.raises(HealthCheckError, match="did not answer"):
        device_healthcheck(device="cpu", timeout_s=0.05)
    assert time.perf_counter() - start < 5.0
    release.set()


def test_healthcheck_refuses_a_wrong_sum(monkeypatch):
    real_eye = torch.eye
    monkeypatch.setattr(health.torch, "eye", lambda *a, **k: real_eye(*a, **k) * 1.5)
    with pytest.raises(HealthCheckError, match="expected 512.0"):
        device_healthcheck(device="cpu", timeout_s=60.0)


def test_retries_then_succeeds():
    calls, seen = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise torch.AcceleratorError("transient")
        return "ok"

    f = with_retries(flaky, retries=3, backoff_s=0.0, on_retry=lambda i, e: seen.append(i))
    assert f() == "ok"
    assert len(calls) == 3 and seen == [0, 1]


def test_exhausted_retries_raise():
    def always_fails():
        raise torch.AcceleratorError("dead")

    with pytest.raises(torch.AcceleratorError):
        with_retries(always_fails, retries=1, backoff_s=0.0)()


@pytest.mark.parametrize("retry_on", [(torch.AcceleratorError,), (ValueError,)])
def test_semantic_errors_are_never_retried(retry_on):
    """Not even when ``retry_on`` names a base class of NonFiniteError."""
    calls = []

    def bad():
        calls.append(1)
        raise NonFiniteError("nan scores")

    with pytest.raises(NonFiniteError):
        with_retries(bad, retries=5, backoff_s=0.0, retry_on=retry_on)()
    assert len(calls) == 1
