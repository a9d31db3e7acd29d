"""Everything the harness knows about a cell, found by name.

A cell is an entry of `workloads` in BENCHMARK.json at the checkout's
root. Its parts are files of their own under benchmark/:

    the configuration   the file its `configs` entry names (SageConfig
                        fields under "sage_config", the scene under
                        "scene", the drive length under "drive_frames")
    the traffic mix     traffic/<traffic>.json, the parameters that
                        traffic.py's one driver reads
    each metric         metrics/<metric>.py, a reader with
                        read(run) -> float | None
    the limits          limits/<cell>.json, the limit of each number that
                        decides `correct` (verdict.py)

so a later cell, mix or metric is added by adding files, never by
editing one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file's contents
    traffic_name: str
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # ... and with --trace 1
    limits: dict
    bench_dir: Path  # the benchmark's folder the cell's files were found in

    @property
    def sage(self) -> dict:
        return self.config["sage_config"]


def _reports(entry: dict, cell: str, reported: set | None = None) -> bool:
    """Whether a metric entry belongs to `cell`: the cells its `workloads`
    lists, or, without the key, every cell (for a per-layer metric, every
    cell that reports the end-to-end metric it moves)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def load(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    spec = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=json.loads((Path(root) / conf["file"]).read_text()),
        traffic_name=w["traffic"], traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=e2e, per_layer=[m for m in spec["per_layer"] if _reports(m, name, reported)],
        limits=json.loads((bench_dir / "limits" / f"{name}.json").read_text()), bench_dir=Path(bench_dir),
    )


def reader(metric: str, bench_dir: Path = HERE):
    """metrics/<metric>.py's read function (a metric's name may hold
    dots, so the file is loaded by its path)."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"odobench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
