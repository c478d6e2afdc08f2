"""What decides ``correct``, at a size a CPU test run holds: the reference
agrees with the program's own arithmetic, the control (the reference with
an fp8 forward) fails the cell's limits, and so does a run
whose timed path is broken underneath, in every batch or in one."""

import time

import pytest
import torch

from portbench import harness
from portbench.reference.precision import CONTROL

TINY = {
    "resnet18_cifar10": {"num_filters": 8, "image_size": 16,
                         "larex": {"tap_shape": [2, 2, 64], "pca_components": 8, "fit_images": 64}},
    "resnet50_imagenet": {"num_filters": 8, "image_size": 64, "num_classes": 20,
                          "larex": {"tap_shape": [2, 2, 256], "pca_components": 8, "fit_images": 64}},
}
# Every answer of the window is compared (``sample`` above their count), so
# a fault in one batch of each call is always in the sample. 72 images make
# four batches of 16 and a tail of 8.
TRAFFIC = {
    "dataset": {"images": 72, "batch": 16, "fit_batch": 16, "max_in_flight": 2, "sample": 100_000,
                "detector": {"support_images": 96}},
    "stream": {"pool_frames": 4, "warmup_requests": 2, "fit_batch": 16, "sample": 100_000},
}
BATCHES = 5
CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
SEED = 2**35 + 17


def tiny_spec(cell, dtype="float32"):
    spec = harness.Spec(cell)
    traffic = dict(TRAFFIC[spec.traffic["kind"]])
    if spec.traffic["detector"]["name"] != "KDE":
        traffic.pop("detector", None)
    return harness.Spec(cell, overrides={"config": dict(TINY[spec.workload["config"]], dtype=dtype),
                                         "traffic": traffic})


def run(spec, controls=()):
    torch.set_num_threads(2)
    return harness.execute(spec, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(), controls=controls)


def not_correct(out, cell):
    checks = harness.verdict(out["numbers"], harness.Spec(cell).limits)
    return not all(c["ok"] for c in checks.values())


@pytest.fixture(scope="module")
def f32_runs():
    """The program with an f32 forward, and the control, per cell."""
    return {cell: run(tiny_spec(cell), controls=[CONTROL]) for cell in CELLS}


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_follows_the_program_in_f32(f32_runs, cell):
    """With the forward in f32 the program and the reference differ by
    rounding alone: the draws, keep-weights, entropies, PCA and detector
    are the same computation."""
    numbers = f32_runs[cell]["numbers"]
    assert set(numbers) >= set(harness.Spec(cell).limits)
    assert all(value < 1e-3 for value in numbers.values()), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cell_s_limits(f32_runs, cell):
    checks = harness.verdict(f32_runs[cell]["control_numbers"][CONTROL], harness.Spec(cell).limits)
    assert not all(c["ok"] for c in checks.values()), checks


def test_the_share_counts_the_images_whose_score_lies_past_tau():
    program = harness.load_file(harness.HERE / "programs" / "larex.py", "portbench_program_larex")
    want = {"logits": torch.ones(8, 2, dtype=torch.float64),
            "scores": torch.tensor([0.0, 2.0] * 4, dtype=torch.float64)}  # standard deviation 1.069
    got_scores = want["scores"] + torch.tensor([0.0, 0.5, 1.0, 2.0, 0.0, -1.5, 0.0, 0.0])
    numbers = program.compare(want["logits"] + 0.25, got_scores, want, tau=0.75)
    assert numbers == {"logit_gap": pytest.approx(0.25), "score_off_share": pytest.approx(3 / 8)}


class Counter:
    """Counts the scorer's calls: warm-up and window alike, each a batch."""

    def __init__(self):
        self.calls = 0

    def __call__(self):
        index = self.calls
        self.calls += 1
        return index


def redrawn(monkeypatch, which):
    """The scorer's DropBlock draw taken from another generator in the
    batches that ``which(call index, batch size)`` picks."""
    from runia_core_tpu_torch.inference import image_level

    draw, count = image_level.mc_dropblock_weights, Counter()

    def weights(batch, height, width, samples, size, prob, generator, device):
        if which(count(), batch):
            generator = torch.Generator(device=device).manual_seed(123_457)
        return draw(batch, height, width, samples, size, prob, generator, device)

    monkeypatch.setattr(image_level, "mc_dropblock_weights", weights)


def tail_batch_redrawn(monkeypatch):
    """The tail batch of each ``score_dataset`` call (8 images, padded to
    16 on the host) drawn wrong."""
    redrawn(monkeypatch, lambda index, batch: index % BATCHES == BATCHES - 1)


def one_batch_redrawn(monkeypatch):
    """One batch in flight of each call (the third of five) drawn wrong."""
    redrawn(monkeypatch, lambda index, batch: index % BATCHES == 2)


def half_the_requests_redrawn(monkeypatch):
    """Every second request drawn wrong."""
    redrawn(monkeypatch, lambda index, batch: index % 2 == 1)


def altered_logit(monkeypatch):
    """The forward's first logit of every batch moved by one."""
    from portbench.families import resnet

    build = resnet.build_forward

    def build_forward(*args):
        forward = build(*args)

        def altered(images):
            logits, taps = forward(images)
            logits = logits.clone()
            logits[0, 0] += 1.0
            return logits, taps

        return altered

    monkeypatch.setattr(resnet, "build_forward", build_forward)


def keep_weights_ignored(monkeypatch):
    """The scorer's DropBlock draw replaced by all-ones keep-weights."""
    from runia_core_tpu_torch.inference import image_level

    def ones(batch, height, width, samples, *args, **kwargs):
        return torch.ones((batch, samples, height * width))

    monkeypatch.setattr(image_level, "mc_dropblock_weights", ones)


def whitening_dropped(monkeypatch):
    """The scorer's PCA projection without its whitening."""
    from runia_core_tpu_torch.inference import image_level

    def unwhitened(state, samples):
        return (samples - state.mean) @ state.components.T

    monkeypatch.setattr(image_level, "pca_transform", unwhitened)


def altered_score(monkeypatch):
    """The detector's answer for the first image of every batch moved by
    100 (LaREM: its quadratic form; LaRED: its log density)."""
    from runia_core_tpu_torch.inference import image_level

    quadform, density = image_level.mahalanobis_quadform, image_level.kde_log_density

    def moved(fn):
        def altered(*args):
            out = fn(*args).clone()
            out[0] += 100.0
            return out

        return altered

    monkeypatch.setattr(image_level, "mahalanobis_quadform", moved(quadform))
    monkeypatch.setattr(image_level, "kde_log_density", moved(density))


# Each cell's numbers against the faults it can have: every batch's or
# request's answer altered where it is produced, and a wrong draw in the
# tail batch or one batch in flight of each call only. A wrong draw moves a
# ResNet-50 score far less than a ResNet-18 one (its 7 x 7 tap averages the
# mask out), so there a wrong draw shows in one batch of five and in every
# second request, not in the tail batch alone (in the full-size cell, 16 of
# 10,000 images).
EVERY = (altered_logit, altered_score, keep_weights_ignored, whitening_dropped)
FAULTS = [("larex_rn18_cifar.dataset", f) for f in EVERY + (tail_batch_redrawn, one_batch_redrawn)]
FAULTS += [("larex_rn18_cifar.dataset_lared", f) for f in (altered_score, tail_batch_redrawn, one_batch_redrawn)]
FAULTS += [("larex_rn50_224.dataset", f) for f in (altered_score, one_batch_redrawn)]
FAULTS += [("larex_rn50_224.stream6", f) for f in EVERY + (half_the_requests_redrawn,)]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, cell):
    fault(monkeypatch)
    assert not_correct(run(tiny_spec(cell)), cell)
