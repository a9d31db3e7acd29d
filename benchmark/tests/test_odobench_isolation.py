"""What the benchmark may import, and the plain reference against the
port's plain (CPU) step."""

from __future__ import annotations

import ast
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import run, verdict
from benchmark.reference import odometry as reference
from benchmark.scenes import build_city_world, make_trajectory, render_drives, sweep_scans
from sage_icp_tpu_torch.models import pipeline as pl

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sage_icp_tpu"}


def imported_top_levels(path: Path) -> set:
    """The top-level names of every absolute import in the file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def card_modules() -> list:
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def test_nothing_the_card_runs_imports_jax_or_the_jax_package():
    assert len(card_modules()) > 20
    for path in card_modules():
        found = imported_top_levels(path) & FORBIDDEN
        assert not found, f"{path.relative_to(BENCH)} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    paths = sorted((BENCH / "reference").glob("*.py"))
    assert len(paths) >= 7
    for path in paths:
        names = imported_top_levels(path)
        assert not names & ({"sage_icp_tpu_torch", "benchmark"} | FORBIDDEN), path.name
        assert names <= {"__future__", "contextlib", "math", "typing", "numpy", "torch"}, (path.name, names)


def test_the_run_looks_for_loaded_modules_by_their_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "sage_icp_tpu_torch_lookalike", sys)
    assert "sage_icp_tpu_torch_lookalike" not in run.forbidden_modules()
    assert all(m.split(".")[0] in FORBIDDEN for m in run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "sage_icp_tpu.ops", sys)
    assert "sage_icp_tpu.ops" in run.forbidden_modules()


TINY = dict(scan_capacity=8192, frame_capacity=8192, source_capacity=8192, map_capacity=65536,
            dynamic_vehicle_filter=False, min_range=2.0, corr_unique_voxel_rows=4096, corr_overflow_rows=512,
            insert_unique_capacity=6144, basic_points_per_voxel=5, critical_points_per_voxel=5)


@pytest.fixture(scope="module")
def scans():
    pts, labels = build_city_world(seed=3, size=160.0, density=0.5)
    return render_drives(pts, labels, make_trajectory(4), 11, 1, 6000, 60.0, 0.01, "cpu")[0]


@pytest.fixture(scope="module")
def swept():
    """Six swept scans and their point times: frames 3 to 5 are deskewed."""
    pts, labels = build_city_world(seed=3, size=160.0, density=0.5)
    gt = make_trajectory(6)
    return sweep_scans(render_drives(pts, labels, gt, 11, 1, 6000, 60.0, 0.01, "cpu")[0], gt, "cpu")


@pytest.mark.parametrize("variant", ["plain", "filter", "int16_upload", "search_every_iteration", "deskew"])
def test_the_reference_agrees_with_the_ports_cpu_step(scans, swept, variant):
    """Both are plain PyTorch on the CPU: poses, counters and the map
    agree bit for bit, free-running and following the port's poses. The
    reference's deskew is its own, not a copy of the port's, so on swept
    scans with their times the two agree within the kitti cells' limits
    on the poses and the map, with the same counters."""
    extra = dict(plain={}, filter=dict(dynamic_vehicle_filter=True, label_max_range=10.0),
                 int16_upload=dict(quantized_scan_upload=True),
                 search_every_iteration=dict(use_fast_correspondences=False), deskew=dict(deskew=True))[variant]
    scans, times = swept if variant == "deskew" else (scans, [None] * len(scans))
    cfg = pl.SageConfig(**dict(TINY, **extra))
    odom = pl.SageICP(cfg, device="cpu")
    poses = np.stack([odom.register_frame(s, t) for s, t in zip(scans, times)])
    fields = dataclasses.asdict(cfg)
    free, follow = reference.Reference(fields, "cpu"), reference.Reference(fields, "cpu")
    for s, t, p in zip(scans, times, poses):
        free.register(s, t)
        follow.register(s, t, follow=p)
    totals = odom.aux_totals()
    limits = json.loads((BENCH / "limits" / "kitti.stream.json").read_text())
    for ref in (free, follow):
        assert {k: sum(c[k] for c in ref.counters) for k in reference.DROP_COUNTERS} == {
            k: int(getattr(totals, k)) for k in reference.DROP_COUNTERS}
        if variant == "deskew":
            dt, dr = verdict.pose_gaps([poses], ref.poses)
            assert dt.max() <= limits["pose_gap_m"] and dr.max() <= limits["rotation_gap_rad"], (dt, dr)
            assert verdict.map_mismatch(odom.state.map[:3], ref.state.map[:3], cfg.voxel_size_map) <= limits[
                "map_point_mismatch"]
            continue
        assert np.array_equal(np.stack(ref.poses), poses)
        assert all(torch.equal(a, b) for a, b in zip(ref.state.map, odom.state.map[:4]))
        assert [c["icp_iterations"] for c in ref.counters] == odom.iteration_counts().tolist()
