"""The PyTorch port stands alone: it never imports JAX or the JAX package,
it never falls back to the CPU on its own, and it refuses settings it
does not implement instead of ignoring them."""

import dataclasses
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "sage_icp_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PACKAGE.rglob("*.py") if p.name != "__init__.py"
)


def test_port_modules_and_chip_smoke_import_without_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'sage_icp_tpu.'))"
        " or m == 'sage_icp_tpu')\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 12
    assert {"sage_icp_tpu_torch.ops.dynamic_filter", "sage_icp_tpu_torch.ops.sort_kernel"} <= set(MODULES)


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_source_has_no_jax_import(path):
    src = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M)
    assert not re.search(r"^\s*(import|from)\s+sage_icp_tpu(\.|\s)", src, re.M)


def test_sage_icp_without_device_needs_a_card(monkeypatch):
    from sage_icp_tpu_torch.models.pipeline import SageICP

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SageICP("city")
    assert SageICP("city", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("setting", ["deskew", "dense_grid", "quantized_scan_upload"])
def test_unported_settings_are_refused(setting):
    from sage_icp_tpu_torch.models.pipeline import PRESETS, SageICP

    config = dataclasses.replace(PRESETS["synthetic"], **{setting: True})
    with pytest.raises(NotImplementedError, match=setting):
        SageICP(config, device="cpu")


def test_kitti_preset_runs_its_dynamic_filter():
    """SageICP() is the kitti preset, dynamic filter on; its prepare step
    removes a moving car and keeps a parked one, without overflow."""
    from sage_icp_tpu_torch.models import pipeline as tpl
    from tests.test_torch_cuda import parked_moving_scan

    odom = tpl.SageICP("kitti", device="cpu")
    assert odom.config == tpl.SageICP(device="cpu").config == tpl.PRESETS["kitti"]
    assert odom.config.dynamic_vehicle_filter
    buf, valid = parked_moving_scan(odom.config.scan_capacity)
    pts, ok = torch.from_numpy(buf), torch.from_numpy(valid)
    prep = tpl.prepare_icp_inputs(odom.state, pts, ok, odom.config)
    assert int(prep["dyn_overflow"]) == 0
    frame = prep["frame_ds"][prep["frame_valid"]]
    car = frame[frame[:, 3] == 10.0]
    assert len(car) > 0 and bool((car[:, 0] < 20.0).all())
