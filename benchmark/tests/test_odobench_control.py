"""The comparison that decides `correct` has to fail a broken program.

On the CPU: a whole run of the tiny cells (the harness's look for a card
skipped), with the timed path broken underneath in each way a cell of
this benchmark can break, comes out not correct against the kitti
cells' limits; unbroken, it comes out correct. One chip, so there is no
exchange between chips to leave out. A configuration that deskews swept
scans can besides ignore the points' times (tiny_deskew).

On the card (marker `cuda`): the control, the reference itself in the
program's place with its float32 matrix products in TF32, comes out not
correct. Run it there with
    python -m pytest benchmark/tests/test_odobench_control.py -m cuda -q
"""

from __future__ import annotations

import pytest
import torch

from benchmark import cells, control, run, verdict
from sage_icp_tpu_torch.models import pipeline as pl
from sage_icp_tpu_torch.ops import scan as scan_ops


def state_unchanged(monkeypatch):
    """The step hands back the state it was given: nothing is inserted,
    no pose is carried."""
    original = pl.finish_step

    def finish(state, prep, icp, config, mesh=None, shard_insert=True, in_place=False):
        _, pose, aux, lmk = original(state, prep, icp, config, mesh, shard_insert, in_place=False)
        return state, pose, aux, lmk

    monkeypatch.setattr(pl, "finish_step", finish)


def half_the_scan(monkeypatch):
    """Every other point of each scan is left out before the upload."""
    original = pl.SageICP.pad_chunk
    monkeypatch.setattr(pl.SageICP, "pad_chunk",
                        lambda self, scans, ts=None: original(self, [s[::2] for s in scans], ts))


def pose_altered(monkeypatch):
    """The pose handed back is 5 cm off where the step produces it; the
    state carries the right one."""
    original = pl.finish_step

    def finish(*args, **kwargs):
        state, pose, aux, lmk = original(*args, **kwargs)
        return state, pose + torch.tensor([[0, 0, 0, 0.05], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]), aux, lmk

    monkeypatch.setattr(pl, "finish_step", finish)


def times_ignored(monkeypatch):
    """The deskew hands the points back unmoved, whatever their times."""
    monkeypatch.setattr(scan_ops, "deskew", lambda points, timestamps, start_pose, finish_pose: points)


# fault -> (how the program breaks, the configuration it breaks in)
FAULTS = {"none": (None, "tiny"), "state_unchanged": (state_unchanged, "tiny"),
          "half_the_scan": (half_the_scan, "tiny"), "pose_altered": (pose_altered, "tiny"),
          "times_ignored": (times_ignored, "tiny_deskew")}


@pytest.mark.parametrize("traffic", ["stream", "offline"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_step_comes_out_not_correct(tiny_root, monkeypatch, fault, traffic):
    breaks, config = FAULTS[fault]
    if breaks is not None:
        breaks(monkeypatch)
    cell = cells.load(tiny_root, f"{config}.{traffic}", tiny_root / "benchmark")
    result = run.run_cell(cell, 2**31 + 99, 0.5, False, "cpu")
    assert result["correct"] is (fault == "none"), result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["tiny", "tiny_deskew"])
def test_the_tf32_control_comes_out_not_correct_on_card(tiny_root, config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = cells.load(tiny_root, f"{config}.stream", tiny_root / "benchmark")
    for seed in (1, 2, 3):
        values = control.control_numbers(cell, seed, torch.device("cuda", 0))
        correct, checks = verdict.judge(values, cell.limits)
        assert not correct, checks
