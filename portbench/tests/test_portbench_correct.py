"""What decides ``correct``, at a size a CPU test run holds: the reference
agrees with the program's own arithmetic, the control (the reference with
an fp8 forward) fails the cell's limits, and so does a run
whose timed path is broken underneath, in every batch or in one. Each
check is ``cellchecks``'s, which finds a cell's CPU sizes and faults by
its names."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import resize
from portbench.reference.precision import CONTROL
from portbench.tests import cellchecks

BENCH = cellchecks.with_left_out(harness.load_json(harness.ROOT / "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
FAULTS = [(cell, fault) for cell in CELLS for fault in cellchecks.fault_names(cell)]


class Runs(dict):
    """The program with an f32 forward, and the control, per cell, each run
    when a test first asks for it."""

    def __missing__(self, cell):
        self[cell] = out = cellchecks.tiny_run(BENCH, cell, controls=[CONTROL])
        return out


@pytest.fixture(scope="module")
def f32_runs():
    return Runs()


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_follows_the_program_in_f32(f32_runs, cell):
    """With the forward in f32 the program and the reference differ by
    rounding alone: the draws, keep-weights, entropies, PCA and detector
    are the same computation."""
    cellchecks.check_f32_agreement(BENCH, cell, f32_runs[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cell_s_limits(f32_runs, cell):
    cellchecks.check_control_fails(BENCH, cell, f32_runs[cell])


def test_the_share_counts_the_images_whose_score_lies_past_tau():
    program = harness.load_file(harness.HERE / "programs" / "larex.py", "portbench_program_larex")
    want = {"logits": torch.ones(8, 2, dtype=torch.float64),
            "scores": torch.tensor([0.0, 2.0] * 4, dtype=torch.float64)}  # standard deviation 1.069
    got_scores = want["scores"] + torch.tensor([0.0, 0.5, 1.0, 2.0, 0.0, -1.5, 0.0, 0.0])
    numbers = program.compare(want["logits"] + 0.25, got_scores, want, tau=0.75)
    assert numbers == {"logit_gap": pytest.approx(0.25), "score_off_share": pytest.approx(3 / 8)}


@pytest.mark.parametrize("size", [(256, 256, 224, 224), (73, 73, 64, 64), (20, 30, 40, 25)])
def test_the_reference_resizes_as_the_loader_does(size):
    """The reference's plain resize against the port's native loader pass
    (``data.gather_resize_normalize``): the same up to the loader's float32
    source coordinates, far below the tenth of a level that another
    half-pixel convention moves a value."""
    from runia_core_tpu_torch.data import gather_resize_normalize

    h_in, w_in, h_out, w_out = size
    images = np.random.default_rng(5).integers(0, 256, (3, h_in, w_in, 3), dtype=np.uint8)
    loaded = gather_resize_normalize(images, np.arange(3), (h_out, w_out))
    ours = resize.bilinear(torch.from_numpy(images), (h_out, w_out)).numpy()
    assert ours.shape == loaded.shape == (3, h_out, w_out, 3)
    np.testing.assert_allclose(ours, loaded, rtol=0, atol=1e-4)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_a_fault_case(cell):
    cellchecks.check_fault_cases(BENCH, cell)


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(fault, cell):
    cellchecks.check_fault_fails(BENCH, cell, fault)
