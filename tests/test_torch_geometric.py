"""The geometric (KISS-ICP-like) configuration on the port, against the
JAX package, on the CPU: the analog of
tests/test_robustness.py::test_geometric_preset_tracks_city. One group of
all 260 labels at 1.0 m voxels, sem_th 1.0 (semantics off), no labels
kept past 0 m, no critical points; 8 frames of the 160 m city world.

Tolerances: the final error below the JAX test's 0.25 m, no drop over all
frames, and the port's final error within 1e-3 m of JAX's on the same
scans and calls."""

import dataclasses

import numpy as np
import pytest
import torch

from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.utils import synthetic
from sage_icp_tpu_torch.models import pipeline as tpl
from tests.test_robustness import small_config

FRAMES = 8


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module: the suite runs six workers on
    the host's cores (see tests/test_torch_runtime.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def geometric_config():
    """test_geometric_preset_tracks_city's configuration."""
    return small_config(voxel_labels=(tuple(range(260)),), voxel_size=(1.0,), voxel_size_map=1.0, sem_th=1.0,
                        label_max_range=0.0, basic_points_per_voxel=10, critical_points_per_voxel=0)


def final_error(odom, gt) -> float:
    est = odom.trajectory()
    return float(np.linalg.norm(est[-1][:3, 3] - (np.linalg.inv(gt[0]) @ gt[-1])[:3, 3]))


def test_geometric_config_tracks_city_as_jax_does():
    pts, labs = synthetic.build_city_world(seed=2, size=160.0, block=50.0, density=1.6)
    gt = synthetic.make_trajectory(FRAMES, step=1.0)
    rng = np.random.default_rng(3)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=14000) for i in range(FRAMES)]
    jcfg = geometric_config()
    port = tpl.SageICP(tpl.SageConfig(**dataclasses.asdict(jcfg)), device="cpu")
    assert len(port.config.voxel_labels) == 1 and port.config.points_per_voxel == 10
    jodom = jpl.SageICP(jcfg)
    for scan in scans:
        port.register_frame(scan)
        jodom.register_frame(scan)
    err, jerr = final_error(port, gt), final_error(jodom, gt)
    assert err < 0.25, f"final drift {err:.3f} m"
    assert int(port.aux_totals().overflow_total()) == 0
    assert abs(err - jerr) < 1e-3, (err, jerr)
