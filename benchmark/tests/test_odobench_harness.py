"""The harness, rehearsed on the CPU: cells found by name, the last line
of a run, the refusal without a card, and how card tests decide."""

from __future__ import annotations

import ast
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cells, run

ROOT = Path(__file__).resolve().parents[2]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_configuration_mix_and_metric_are_found_by_name(tiny_root):
    bench = tiny_root / "benchmark"
    before = digest(bench)
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    (bench / "configs" / "tiny2.json").write_text(json.dumps(dict(cfg, name="tiny2")))
    (bench / "traffic" / "pairs.json").write_text(json.dumps({"frames_per_call": 2, "pose_fetch": "per_call"}))
    (bench / "metrics" / "frames_seen.py").write_text("def read(run):\n    return float(run.window.frames)\n")
    (bench / "limits" / "tiny2.pairs.json").write_text(json.dumps({"counter_gap": 0}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny2", file="benchmark/configs/tiny2.json"))
    spec["workloads"].append(dict(name="tiny2.pairs", config="tiny2", traffic="pairs", chips=1, why="tests"))
    spec["per_layer"].append(dict(name="frames_seen", unit="frames", better="higher", source="program_counter",
                                  layer="device", moves="scans_per_s", workloads=["tiny2.pairs"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        after = digest(bench)
        assert {k: v for k, v in after.items() if k in before} == before
        cell = cells.load(tiny_root, "tiny2.pairs", bench)
        assert cell.config["name"] == "tiny2" and cell.traffic["frames_per_call"] == 2
        assert cell.limits == {"counter_gap": 0}
        assert [m["name"] for m in cell.per_layer] == ["frames_seen"]
        assert {m["name"] for m in cell.end_to_end} == {"scans_per_s", "setup_s"}
        read = cells.reader("frames_seen", cell.bench_dir)
        assert read(type("Run", (), {"window": type("W", (), {"frames": 3})()})()) == 3.0
    finally:
        spec["configs"].pop(), spec["workloads"].pop(), spec["per_layer"].pop()
        (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
        for p in ("configs/tiny2.json", "traffic/pairs.json", "metrics/frames_seen.py", "limits/tiny2.pairs.json"):
            (bench / p).unlink()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("traffic", ["stream", "offline"])
@pytest.mark.parametrize("config", ["tiny", "tiny_deskew"])
def test_a_cpu_rehearsal_prints_the_contract_keys_last(tiny_root, config, traffic, trace, capsys):
    cell = cells.load(tiny_root, f"{config}.{traffic}", tiny_root / "benchmark")
    result = run.run_cell(cell, 2**31 + 1234, 2.0, bool(trace), "cpu")
    line = run.result_line(result)
    out = json.loads(line)
    assert "\n" not in line
    assert list(out) == RESULT_KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 6
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    wanted = cell.per_layer if trace else cell.end_to_end
    assert set(out["metrics"]) <= {m["name"] for m in wanted}
    for m in wanted:
        if m["name"] in out["metrics"]:
            assert out["metrics"][m["name"]]["unit"] == m["unit"]
    if not trace:
        assert set(out["metrics"]) == {m["name"] for m in wanted}
    assert set(out["checks"]) == set(cell.limits)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-len(cell.limits):] == [f"check {k} {v['value']} limit {v['limit']}" for k, v in out["checks"].items()]


def test_run_without_a_card_exits_with_an_error_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kitti.stream", "--seed", "5",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def _decides_at_import(tree: ast.Module) -> list:
    """Calls of torch.cuda.is_available / device_count outside a function
    body: at module level, in a decorator or a default argument."""
    bad = []

    def visit(node, in_body):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr in (
                "is_available", "device_count") and not in_body:
            bad.append(node.lineno)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in node.decorator_list + node.args.defaults:
                visit(d, False)
            for b in node.body:
                visit(b, True)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, in_body)

    visit(tree, False)
    return bad


def test_card_tests_carry_the_cuda_marker_and_decide_inside_the_test():
    for path in sorted(Path(__file__).parent.glob("test_*.py")):
        tree = ast.parse(path.read_text())
        assert _decides_at_import(tree) == [], path.name
        for fn in [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]:
            src = ast.unparse(fn)
            marked = any(ast.unparse(d) == "pytest.mark.cuda" for d in fn.decorator_list)
            if "on_card" in fn.name:
                assert marked, f"{path.name}::{fn.name} needs the card and has no cuda marker"
            if marked:
                assert "is_available" in src, f"{path.name}::{fn.name} must look for the card inside the test"
