"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode. Tolerances: the semantic NN outputs
within 1e-6 (the same winners; XLA rounds d2 an ulp differently), the
GN sums within 1e-5 of the sum of their terms' magnitudes (only the
summation order differs), the retention policy bit for bit. The CUDA
kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_icp_tpu.ops import geometry as jgeo
from sage_icp_tpu.ops import hashmap as jhm
from sage_icp_tpu.ops import pallas_insert as jpi
from sage_icp_tpu.ops import pallas_nn as jpn
from sage_icp_tpu.ops import registration as jreg
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops import nn_kernels, policy_kernel
from sage_icp_tpu_torch.ops import registration as treg
from tests.oracle import OracleVoxelMap
from tests.test_torch_cuda import BASIC_LABELS, KTH, MAX_CORR, SEM_TH, VOXEL, gn_fixture, nn_rows, policy_rows, t

def test_semantic_nn_plain_matches_pallas():
    d = nn_rows(0)
    scale = VOXEL / 32767.0
    args = d["planes"] + d["offs"] + [d["q_local"]]
    want = jpn.fused_semantic_nn(*[jnp.asarray(a) for a in args], SEM_TH, scale, interpret=True)
    got = nn_kernels.fused_semantic_nn(*[t(a) for a in args], SEM_TH, scale)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("dead_from", [None, 100])
def test_gn_iteration_plain_matches_pallas(dead_from):
    """dead_from=100: tiles 1 and 2 of 3 hold no used slot, the tile map
    redirects them to tile 0 (the reference's dead-tile rule)."""
    R = 384
    d = nn_rows(1, R=R, dead_from=dead_from)
    scale = VOXEL / 32767.0
    T = np.asarray(jgeo.se3_exp(jnp.asarray([0.03, -0.02, 0.01, 0.004, -0.003, 0.006], jnp.float32)))
    tile_map = nn_kernels.default_tile_map(t(d["used"]))
    if dead_from is not None:
        assert tile_map.tolist() == [0, 0, 0]
    args = d["planes"] + d["offs"] + [d["q_world"], d["origin"], d["row_abs"], d["used"], T]
    want = np.asarray(jpn.fused_gn_iteration(
        *[jnp.asarray(a) for a in args], SEM_TH, scale, VOXEL, MAX_CORR, KTH,
        interpret=True, tile_map=jnp.asarray(tile_map.numpy())))
    targs = [t(a) for a in args] + [SEM_TH, scale, VOXEL, MAX_CORR, KTH]
    got = nn_kernels.fused_gn_iteration(*targs, tile_map=tile_map).numpy()
    mag = nn_kernels.gn_terms(*targs, tile_map).abs().sum(dim=1).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * mag + 1e-6), (got, want)
    assert got[16] > 0 and got[16] == want[16] and got[17] == want[17]


@pytest.mark.parametrize("K,width", [(40, 16), (20, 8), (8, 16), (4, 8), (7, 2)])
def test_gn_load_width(K, width):
    """The GN kernel's load width per lane and plane follows the row's byte
    stride 2M (M = 27K): 16 B on the main path (K = 40), else 8 B, else
    2 B; every row start of a 16-byte-aligned plane is then aligned too."""
    M = 27 * K
    assert nn_kernels.gn_load_bytes(M) == width
    assert (2 * M) % width == 0


def test_policy_plain_matches_pallas():
    args = policy_rows(2)
    basic = 4
    seglen = args[5]
    want = jpi.apply_policy(*[jnp.asarray(a) for a in args], jnp.asarray(int(seglen.max())),
                            n_rounds=8, basic=basic, interpret=True)
    got = policy_kernel.apply_policy(*[t(a) for a in args], basic=basic)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_retention_policy_exact_sequence():
    """One voxel through every branch of the policy: fill the basic part
    with label-0 and basic points, drop a label-0 point on a full basic
    part, overwrite the first label-0 point with a basic point, append
    critical points, overwrite with a critical point on a full block,
    drop when no label-0 point is left. The port's insert agrees with the
    oracle and with the JAX insert."""
    basic, critical = 4, 3
    seq = [[0.1 + 0.01 * i, 0.1, 0.1, 0.0 if i % 2 == 0 else 40.0] for i in range(basic)]
    seq += [[0.5, 0.5, 0.5, 0.0], [0.6, 0.6, 0.6, 44.0]]
    seq += [[0.7, 0.7, 0.7 - 0.01 * i, 10.0] for i in range(critical)]
    seq += [[0.8, 0.8, 0.8, 81.0], [0.9, 0.9, 0.9, 81.0]]
    seq = np.array(seq, np.float32)
    mask = np.zeros(260, bool)
    mask[list(BASIC_LABELS)] = True
    mt, _ = thm.insert(thm.create(1024, basic + critical), t(seq), torch.ones(len(seq), dtype=torch.bool),
                       VOXEL, basic, t(mask))
    mj = jhm.insert(jhm.create(1024, basic + critical), jnp.asarray(seq), jnp.ones(len(seq), bool),
                    VOXEL, basic, jnp.asarray(mask))
    np.testing.assert_array_equal(mt.points.numpy(), np.asarray(mj.points))
    oracle = OracleVoxelMap(VOXEL, 100.0, basic, critical, BASIC_LABELS)
    oracle.add_points(seq)
    pts, live = thm.pointcloud(mt, VOXEL)
    got = pts[live].numpy().astype(np.float64).round(4)
    ref = np.asarray(oracle.pointcloud(), np.float64).round(4)
    np.testing.assert_allclose(got[np.lexsort(got.T)], ref[np.lexsort(ref.T)], atol=1e-3)


def test_register_frame_matches_jax():
    mj, mt, frame = gn_fixture_maps()
    n = len(frame)
    np.testing.assert_array_equal(mt.points.numpy(), np.asarray(mj.points))
    fast = dict(unique_voxel_rows=896, queries_per_voxel=8, overflow_rows=128)
    kw = dict(max_correspondence_distance=1.5, kernel=0.5, sem_th=0.5, max_iterations=60, fast_params=fast)
    rj = jreg.register_frame(mj, jnp.asarray(frame), jnp.ones(n, bool), jnp.eye(4, dtype=jnp.float32), 1.0,
                             **kw)
    rt = treg.register_frame(mt, t(frame), torch.ones(n, dtype=torch.bool), torch.eye(4), 1.0, **kw)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4)
    assert abs(int(rt.iterations) - int(rj.iterations)) <= 1
    nc = int(rt.num_correspondences)
    assert abs(nc - int(rj.num_correspondences)) <= max(2, nc // 100)


def gn_fixture_maps():
    world, frame = gn_fixture()
    n = len(world)
    mj = jhm.insert(jhm.create(8192, 8), jnp.asarray(world), jnp.ones(n, bool), 1.0, 8, jnp.zeros(260, bool))
    mt, _ = thm.insert(thm.create(8192, 8), t(world), torch.ones(n, dtype=torch.bool), 1.0, 8,
                       torch.zeros(260, dtype=torch.bool))
    return mj, mt, frame


def test_register_frame_reference_branch_matches_jax():
    """fast_params=None, the reference-shaped search every iteration
    (use_fast_correspondences=False): pose within 1e-6 of the JAX
    package's, the same iteration and correspondence counts."""
    mj, mt, frame = gn_fixture_maps()
    n = len(frame)
    kw = dict(max_correspondence_distance=1.5, kernel=0.5, sem_th=0.5, max_iterations=60)
    rj = jreg.register_frame(mj, jnp.asarray(frame), jnp.ones(n, bool), jnp.eye(4, dtype=jnp.float32), 1.0, **kw)
    rt = treg.register_frame(mt, t(frame), torch.ones(n, dtype=torch.bool), torch.eye(4), 1.0, **kw)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-6)
    assert int(rt.iterations) == int(rj.iterations) > 1
    assert int(rt.num_correspondences) == int(rj.num_correspondences) > 0


@pytest.mark.parametrize("fast", [False, True])
def test_register_frame_empty_map_returns_initial_guess(fast):
    """The analog of test_icp_empty_map_returns_initial_guess, in both
    branches: one zero step, then the guess comes back, as in the JAX
    package."""
    rng = np.random.default_rng(0)
    frame = rng.normal(size=(64, 4)).astype(np.float32)
    xi = np.array([1.0, 2.0, 0.5, 0.1, 0.2, 0.3], np.float32)
    guess = np.asarray(jgeo.se3_exp(jnp.asarray(xi)))
    fast_params = dict(unique_voxel_rows=128, queries_per_voxel=2, overflow_rows=32) if fast else None
    args = (1.0, 1.5, 0.5, 1.0)
    rj = jreg.register_frame(jhm.create(256, 4), jnp.asarray(frame), jnp.ones(64, bool), jnp.asarray(guess), *args,
                             fast_params=fast_params)
    rt = treg.register_frame(thm.create(256, 4), t(frame), torch.ones(64, dtype=torch.bool), t(guess), *args,
                             fast_params=fast_params)
    np.testing.assert_allclose(rt.pose.numpy(), guess, atol=1e-5)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-6)
    assert int(rt.iterations) == int(rj.iterations) == 1
    assert int(rt.num_correspondences) == int(rj.num_correspondences) == 0
