"""A small checkout for the benchmark's CPU tests: BENCHMARK.json and the
benchmark's files copied into a temporary directory, plus a tiny
configuration (the kitti configuration at small capacities, a 160 m city,
6-frame drives) and its swept, deskewed twin tiny_deskew, each with a
stream and an offline cell held to the kitti cells' limits. The port
runs its plain versions on the CPU there."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

TINY_SAGE = dict(scan_capacity=8192, frame_capacity=8192, source_capacity=8192, map_capacity=65536, min_range=2.0,
                 corr_unique_voxel_rows=4096, corr_overflow_rows=512, insert_unique_capacity=6144,
                 basic_points_per_voxel=5, critical_points_per_voxel=5, label_max_range=10.0)
TINY_SCENE = dict(world_size=160.0, density=0.5, points_target=6000, max_range=60.0, drives=2)
TINY_CONFIGS = ("tiny", "tiny_deskew")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_tiny_checkout(dest: Path) -> Path:
    """dest with BENCHMARK.json, benchmark/ (no tests) and the tiny cells
    tiny.stream, tiny.offline, tiny_deskew.stream and tiny_deskew.offline."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = dest / "benchmark"
    cfg = json.loads((bench / "configs" / "kitti.json").read_text())
    cfg["name"] = "tiny"
    cfg["sage_config"].update(TINY_SAGE)
    cfg["scene"].update(TINY_SCENE)
    cfg["drive_frames"] = 6
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    swept = dict(cfg, name="tiny_deskew", sage_config=dict(cfg["sage_config"], deskew=True),
                 scene=dict(cfg["scene"], sweep=True))
    (bench / "configs" / "tiny_deskew.json").write_text(json.dumps(swept))
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for name in TINY_CONFIGS:
        spec["configs"].append(dict(spec["configs"][0], name=name, file=f"benchmark/configs/{name}.json"))
        for traffic in ("stream", "offline"):
            spec["workloads"].append(dict(name=f"{name}.{traffic}", config=name, traffic=traffic, chips=1, why="tests"))
            shutil.copy(bench / "limits" / f"kitti.{traffic}.json", bench / "limits" / f"{name}.{traffic}.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [w.replace("kitti.", f"{name}.") for name in TINY_CONFIGS for w in m["workloads"]
                               if w.startswith("kitti.")]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_checkout(tmp_path_factory.mktemp("checkout"))
