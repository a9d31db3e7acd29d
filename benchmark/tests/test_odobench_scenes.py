"""The scenes: today's drives stay as they were, and a swept scan is what
the reference's deskew undoes.

A swept scene moves each rendered point to where a sensor sweeping
through the frame's motion measured it; deskewing it with the frame's
true motion has to give the rendered scan back. The reference's deskew
and the port's ops/scan.deskew have to agree on any points, times and
poses: within 2e-5 m, float32's spacing at 100 m (7.6e-6 m) and room for
a few roundings."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.reference import deskew as dsk
from benchmark.tests.conftest import ROOT, TINY_SCENE
from sage_icp_tpu_torch.ops import scan as port_scan

AGREE_M = 2e-5

# sha256 of the tiny checkout's drives (tiny.json: the kitti scene with
# TINY_SCENE, 6 frames) as the harness rendered them before swept scenes
# existed, on the CPU with torch 2.13.0
UNSWEPT_DIGESTS = {5: "cd470fe59a5bfe4c89fc5de79ed054b36463742d2cec0de9b1ff5fa2dfb42825",
                   2**31 + 77: "9b68be025384a6200b861937929f992f1b1387308142f60a4d2f6e1fa49c9694"}


def tiny_config(frames: int = 6, sweep: bool = False) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / "kitti.json").read_text())
    scene = dict(cfg["scene"], **TINY_SCENE)
    if sweep:
        scene["sweep"] = True
    return dict(cfg, scene=scene, drive_frames=frames)


def digest(drives: list) -> str:
    h = hashlib.sha256()
    for drive in drives:
        for scan in drive:
            h.update(np.asarray(scan.shape, dtype=np.int64).tobytes())
            h.update(scan.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(UNSWEPT_DIGESTS))
def test_a_scene_without_sweep_renders_todays_drives(seed):
    gt, drives, times = scenes.cell_scenes(tiny_config(), seed, TINY_SCENE["drives"], "cpu")
    assert times is None and len(gt) == 6
    assert all(s.dtype == np.float32 and s.shape[1] == 4 for drive in drives for s in drive)
    assert digest(drives) == UNSWEPT_DIGESTS[seed]


def test_the_reference_deskews_a_swept_scan_back_to_the_rendered_one():
    seed, frames = 2**31 + 5, 9
    gt, swept, times = scenes.cell_scenes(tiny_config(frames, sweep=True), seed, 2, "cpu")
    _, plain, _ = scenes.cell_scenes(tiny_config(frames), seed, 2, "cpu")
    poses = torch.tensor(gt, dtype=torch.float32)
    for drive in range(2):
        for k in range(frames):
            raw, t, mid = swept[drive][k], times[drive][k], plain[drive][k]
            assert raw.shape == mid.shape and t.shape == (len(mid),) and t.dtype == np.float32
            assert np.array_equal(raw[:, 3], mid[:, 3]) and 0.0 <= t.min() and t.max() <= 1.0
            moved = np.abs(raw[:, :3] - mid[:, :3]).max()
            # from the 7th frame on the vehicle cruises at 1 m a scan: the
            # sweep's ends lie 0.5 m from its middle
            assert moved == 0.0 if k == 0 else moved > (0.45 if k >= 6 else 0.05)
            back = dsk.deskew(torch.from_numpy(raw), torch.from_numpy(t), poses[max(k - 1, 0)], poses[k])
            assert np.abs(back.numpy() - mid).max() <= AGREE_M


def random_twist(rng, rotation: float, translation: float) -> torch.Tensor:
    return torch.tensor(np.concatenate([rng.normal(0.0, translation, 3), rng.normal(0.0, rotation, 3)]))


# a frame's motion: "turning", rotations of some hundredths of a radian;
# "cruising", a vehicle at 10 m/s holding its lane, 1 m and 3e-4 rad a
# scan. Cruising, a point turns by 1e-4 to 2e-4 rad, where the port's
# coefficients (1 - cos t) / t^2 and (t - sin t) / t^3, taken in float32
# above 1e-4 rad, come out 0 for 0.5 and 1/6: its points then lie up to
# 6e-5 m from the exact deskew, which the reference meets within 2e-5 m
# (the round trip above), and this case fails
@pytest.mark.parametrize("motion", [(0.05, 1.0), (3e-4, 1.0)], ids=["turning", "cruising"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_references_deskew_agrees_with_the_ports(seed, motion):
    rng = np.random.default_rng(seed)
    start = dsk.se3_exp(random_twist(rng, 0.5, 50.0))
    finish = start @ dsk.se3_exp(random_twist(rng, *motion))
    n = 20000
    direction = rng.normal(size=(n, 3))
    xyz = direction / np.linalg.norm(direction, axis=1, keepdims=True) * rng.uniform(5.0, 100.0, (n, 1))
    points = torch.from_numpy(np.concatenate([xyz, rng.integers(0, 260, (n, 1))], axis=1).astype(np.float32))
    times = torch.from_numpy(rng.uniform(0.0, 1.0, n).astype(np.float32))
    start, finish = start.to(torch.float32), finish.to(torch.float32)
    ours = dsk.deskew(points, times, start, finish)
    port = port_scan.deskew(points, times, start, finish)
    assert torch.equal(ours[:, 3], points[:, 3])
    assert (ours - port).abs().max().item() <= AGREE_M
