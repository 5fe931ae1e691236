"""On the card: the control, the plain reference in TF32 put in the
program's place, comes out not correct, and the program correct, at each
cell's widths with fewer rows, ticks or epochs than a run takes.  Skips
where there is no card."""

import pytest
import torch

from benchmark.harness import manifest as mf

SEED = 2 ** 31 + 23
SMALLER = {
    "all_1728.tick_nap": ({}, {"check_ticks": 8}),
    "hand_camera_1024.score_offline": ({}, {"test_windows": 2800}),
    "all_1728.score_offline": ({}, {"test_windows": 2800}),
    "all_1728.train": ({"n_epochs": 2}, {"train_windows": 21000,
                                         "valid_windows": 2800}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALLER))
def test_the_control_fails_and_the_program_passes(card, cell):
    manifest = mf.Manifest(mf.BENCH.rsplit("/", 1)[0])
    entry_cell = manifest.cell(cell)
    config = {**manifest.config(entry_cell), **SMALLER[cell][0]}
    traffic = {**mf.traffic(entry_cell["traffic"]), **SMALLER[cell][1]}
    limits = mf.limits(cell)
    entry = mf.entry(traffic["entry"])(config, traffic, SEED, card)
    entry.window(1.0)
    entry.release()
    assert all(c.ok for c in entry.check(limits))
    assert not all(c.ok for c in entry.control(limits, "tf32"))
