"""The port's dense voxel-grid index (dense_grid) against the JAX package,
on the CPU: the torus geometry, the grid's upkeep through insert, cull,
slot reuse and revisit, the grid branch of the fast correspondence path,
a short drive, the configuration bounds, the checkpoint in both
directions and two gloo ranks.

Tolerances: grid cells, checksums, keys, counts, int16 planes and the
grid array bit for bit wherever both packages run the same map op; on the
drive (test_torch_pipeline.py's bounds) the poses within 1e-4, keys,
counts and the grid array equal, int16 planes within 1 LSB; the port
with the grid equal to the port without it bit for bit; fast-path
targets within 1e-4 of the reference search (test_fast_correspondence.py's
bound)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.ops import correspondence_fast as jcf
from sage_icp_tpu.ops import hashmap as jhm
from sage_icp_tpu.runtime import checkpoint as j_ckpt
from sage_icp_tpu.utils import synthetic
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.models.state_io import state_from_numpy, state_to_numpy
from sage_icp_tpu_torch.ops import correspondence_fast as tcf
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.runtime import checkpoint as t_ckpt
from tests.test_checkpoint_viz import tiny_cfg
from tests.test_parallel import tiny_config

VOXEL = 1.0
BASIC, CRITICAL = 4, 3
K = BASIC + CRITICAL
MASK = np.isin(np.arange(260), [40, 44, 48, 49, 50, 70, 72])
FIELDS = ("keys", "counts", "points", "first_pts", "grid")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def random_scan(rng, n, spread=8.0, labels=(0, 40, 44, 50, 10, 80, 81)):
    xyz = rng.uniform(-spread, spread, size=(n, 3))
    return np.concatenate([xyz, rng.choice(labels, size=(n, 1))], axis=1).astype(np.float32)


def to_port(mj) -> thm.MapState:
    return thm.MapState(*[None if a is None else t(np.asarray(a)) for a in mj])


def assert_maps_equal(mj, mt):
    for name in FIELDS:
        a, b = getattr(mj, name), getattr(mt, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def expected_grid(keys: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The grid a map's live slots define, built in numpy: each live
    voxel's cell holds [slot, hi-check], every other cell [-1, *]."""
    live = np.flatnonzero(counts > 0)
    k = keys[live].astype(np.int64)
    cell = ((k[:, 0] & 255) << 14) | ((k[:, 1] & 255) << 6) | (k[:, 2] & 63)
    assert len(np.unique(cell)) == len(live), "two live voxels share a cell"
    hi = ((k[:, 0] >> 8) * 73856093 ^ (k[:, 1] >> 8) * 19349663 ^ (k[:, 2] >> 6) * 83492791) & 0xFFFFFFFF
    grid = np.full((thm.GRID_SIZE, 2), -1, np.int64)
    grid[cell, 0] = live
    grid[cell, 1] = np.where(hi >= 2**31, hi - 2**32, hi)
    return grid


def assert_grid_consistent(keys, counts, grid, stale_ok=False):
    """Every live slot's cell holds that slot and its checksum; no other
    cell holds a slot (unless stale_ok: a map emptied by hand keeps the
    cells of its emptied blocks)."""
    want = expected_grid(np.asarray(keys), np.asarray(counts))
    grid = np.asarray(grid)
    used = want[:, 0] >= 0
    np.testing.assert_array_equal(grid[used], want[used])
    if not stale_ok:
        np.testing.assert_array_equal(grid[~used, 0], -1)


# --- geometry ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["grid_index", "grid_hi_code"])
def test_grid_geometry_bit_exact(name):
    """Random keys in +-2^20, negative keys, EMPTY_KEY and keys at the
    int32 edges of the coordinate range, where hi_code's products wrap."""
    rng = np.random.default_rng(0)
    keys = rng.integers(-(2**20), 2**20, size=(8192, 3)).astype(np.int32)
    keys[:64] = -rng.integers(1, 600, (64, 3))
    keys[64:70] = jhm.EMPTY_KEY
    keys[70:76] = 2**20 - 1
    keys[76:82] = [[-(2**20), 2**20 - 1, -1]] * 6
    keys[82:88] = rng.integers(2**31 - 300, 2**31, (6, 3))
    keys[88:94] = -rng.integers(2**31 - 300, 2**31, (6, 3))
    want = np.asarray(getattr(jhm, name)(jnp.asarray(keys)))
    got = getattr(thm, name)(t(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (thm.GRID_XY_BITS, thm.GRID_Z_BITS, thm.GRID_SIZE) == (jhm.GRID_XY_BITS, jhm.GRID_Z_BITS, jhm.GRID_SIZE)


def test_create_and_clear_keep_the_grid_like_jax():
    mj, mt = jhm.create(64, K, dense_grid=True), thm.create(64, K, dense_grid=True)
    assert_maps_equal(mj, mt)
    assert mt.grid.shape == (thm.GRID_SIZE, 2) and mt.grid.dtype == torch.int32
    assert thm.clear(mt).grid is not None and thm.clear(thm.create(64, K)).grid is None
    assert_maps_equal(jhm.clear(mj), thm.clear(mt))


# --- upkeep --------------------------------------------------------------------

def test_dense_grid_matches_jax_through_insert_cull_reuse_revisit():
    """The analog of tests/test_hashmap.py's
    test_dense_grid_matches_window_lookup: insert, cull (stale cells),
    a far region reusing the culled slots, the original region revisited.
    After every step the port's map equals JAX's, grid array included,
    and the port's grid probe agrees with its hash-window lookup."""
    rng = np.random.default_rng(0)
    mj, mt = jhm.create(256, K, dense_grid=True), thm.create(256, K, dense_grid=True)

    def ins(pts):
        nonlocal mj, mt
        mj = jhm.insert(mj, jnp.asarray(pts), jnp.ones(len(pts), bool), VOXEL, BASIC, jnp.asarray(MASK),
                        unique_voxel_capacity=128, policy_kernel=False)
        mt, _ = thm.insert(mt, t(pts), torch.ones(len(pts), dtype=torch.bool), VOXEL, BASIC, t(MASK),
                           unique_voxel_capacity=128)

    def cull(origin):
        nonlocal mj, mt
        mj = jhm.remove_far(mj, jnp.asarray(origin, jnp.float32), 20.0)
        mt = thm.remove_far(mt, torch.tensor(origin, dtype=torch.float32), 20.0)

    def check(keys):
        assert_maps_equal(mj, mt)
        assert_grid_consistent(mt.keys, mt.counts, mt.grid)
        q = t(keys.astype(np.int32))
        found, slot = thm.grid_probe(mt, q)
        ref = thm.lookup(mt, q)
        live = (ref >= 0) & (mt.counts[torch.clamp(ref, min=0).long()] > 0)
        np.testing.assert_array_equal((found & (mt.counts[slot.long()] > 0)).numpy(), live.numpy())
        np.testing.assert_array_equal(found.numpy(), live.numpy())
        np.testing.assert_array_equal(slot[live].numpy(), ref[live].numpy())
        for a, b in zip(jhm.grid_probe(mj, jnp.asarray(keys.astype(np.int32))), (found, slot)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())

    near = random_scan(rng, 120, spread=4.0)
    probes = np.unique(np.trunc(near[:, :3] / VOXEL), axis=0)
    ins(near)
    check(probes)
    cull([100.0, 0.0, 0.0])
    check(probes)
    assert not bool(thm.grid_probe(mt, t(probes.astype(np.int32)))[0].any())
    far = random_scan(rng, 120, spread=4.0)
    far[:, 0] += 100.0
    fprobes = np.unique(np.trunc(far[:, :3] / VOXEL), axis=0)
    ins(far)
    check(fprobes)
    check(probes)
    cull([0.0, 0.0, 0.0])
    ins(near)
    check(probes)
    check(fprobes)


def test_reclaimed_stale_slots_clear_their_cells_like_jax():
    """The insert's stale-cell clear, which a map that remove_far erased
    never reaches: blocks emptied with their keys and cells left behind
    (count 0, key kept), then one batch that re-claims many of those
    slots with new voxels, some in the very cell of the slot's previous
    owner (a voxel whole torus periods away whose hash is that slot: the
    cell is cleared, then written again), and revives other emptied
    voxels in place. Keys, counts, blocks and the grid equal JAX's bit
    for bit."""
    rng = np.random.default_rng(7)
    mj = jhm.create(256, K, dense_grid=True)
    first = random_scan(rng, 400, spread=4.0)
    mj = jhm.insert(mj, jnp.asarray(first), jnp.ones(len(first), bool), VOXEL, BASIC, jnp.asarray(MASK),
                    unique_voxel_capacity=256, policy_kernel=False)
    counts = np.asarray(mj.counts).copy()
    live = np.flatnonzero(counts > 0)
    assert len(live) > 150
    emptied = rng.permutation(live)[: len(live) * 2 // 3]
    counts[emptied] = 0
    mj = mj._replace(counts=jnp.asarray(counts))
    mt = to_port(mj)
    keys = np.asarray(mj.keys)
    alias, revive = emptied[: len(emptied) // 2], emptied[len(emptied) // 2:][:20]
    # another voxel in the previous owner's cell, whose hash is the
    # owner's slot for the first few (it claims that slot in round 0),
    # 256 voxels away in x for the rest
    period = np.array([(i * 256, j * 256, k * 64) for i in range(-12, 13) for j in range(-12, 13)
                       for k in (-2, -1, 1, 2)], np.int32)
    new_vox = keys[alias] + [256, 0, 0]
    for n, slot in enumerate(alias[:8]):
        cand = keys[slot] + period
        new_vox[n] = cand[np.flatnonzero(thm.hash_keys(t(cand), 256).numpy() == slot)[0]]
    vox = np.concatenate([new_vox, keys[revive]]).astype(np.float64)
    pts = (vox + np.where(vox < 0, -0.5, 0.5)) * VOXEL  # inside the voxel: coordinates truncate toward 0
    pts = np.concatenate([pts, rng.choice([40, 50, 0], (len(pts), 1))], axis=1).astype(np.float32)
    mj2 = jhm.insert(mj, jnp.asarray(pts), jnp.ones(len(pts), bool), VOXEL, BASIC, jnp.asarray(MASK),
                     unique_voxel_capacity=256, policy_kernel=False)
    mt2, stats = thm.insert(mt, t(pts), torch.ones(len(pts), dtype=torch.bool), VOXEL, BASIC, t(MASK),
                            unique_voxel_capacity=256)
    assert_maps_equal(mj2, mt2)
    assert_maps_equal(mj, mt)  # the input map is left as it was
    new_keys = mt2.keys.numpy()
    reclaimed = (counts == 0) & (keys != jhm.EMPTY_KEY).any(1) & (new_keys != keys).any(1)
    assert reclaimed.sum() >= 10, "too few stale slots were re-claimed to exercise the clear"
    same_cell = thm.grid_index(t(keys[reclaimed])) == thm.grid_index(mt2.keys[t(reclaimed)])
    assert bool(same_cell.any()), "no re-claimed slot landed in its previous owner's cell"
    assert int(stats.claim_failures) == 0
    assert_grid_consistent(mt2.keys, mt2.counts, mt2.grid, stale_ok=True)


# --- the fast correspondence path ---------------------------------------------

def fast_fixture_map(rng, dense_grid):
    """tests/test_fast_correspondence.py's build_map, in both packages."""
    n = 600
    xyz = rng.uniform(-12.0, 12.0, size=(n, 3))
    lab = rng.choice([0, 40, 44, 50, 10, 80], size=n).astype(np.float64)
    pts = np.concatenate([xyz, lab[:, None]], axis=1).astype(np.float32)
    basic = jnp.zeros(260, dtype=bool).at[jnp.asarray([40, 44, 50])].set(True)
    mj = jhm.insert(jhm.create(2048, K, dense_grid=dense_grid), jnp.asarray(pts), jnp.ones(n, bool), VOXEL, 4,
                    basic)
    mt, _ = thm.insert(thm.create(2048, K, dense_grid=dense_grid), t(pts), torch.ones(n, dtype=torch.bool), VOXEL,
                       4, t(np.asarray(basic)))
    assert_maps_equal(mj, mt)
    return mj, mt


def fast_queries(rng, n):
    q = np.concatenate([rng.uniform(-12, 12, size=(n, 3)), rng.choice([0, 40, 50, 10], size=(n, 1))], axis=1)
    return q.astype(np.float32)


@functools.partial(jax.jit, static_argnames=("P", "Q", "OV"))
def jax_fast(mj, q, valid, P, Q, OV):
    """JAX's fast path, jitted (a quarter of the eager path's time)."""
    tables = jcf.build_probe_tables(mj, jnp.zeros(3, jnp.int32), 16)
    return jcf.get_correspondences_fast(mj, tables, q, valid, VOXEL, 1.5, 0.4, 16, unique_voxel_rows=Q,
                                        queries_per_voxel=P, overflow_rows=OV)


def fast_both(mj, mt, q, valid, P, Q, OV):
    """The fast path in both packages and the port's reference search."""
    tt = tcf.build_probe_tables(mt, torch.zeros(3, dtype=torch.int32), 16)
    jt, ja = jax_fast(mj, jnp.asarray(q), jnp.asarray(valid), P=P, Q=Q, OV=OV)
    ft, fa = tcf.get_correspondences_fast(mt, tt, t(q), t(valid), VOXEL, 1.5, 0.4, 16, unique_voxel_rows=Q,
                                          queries_per_voxel=P, overflow_rows=OV)
    rt, ra, _ = thm.get_correspondences(mt, t(q), t(valid), VOXEL, 1.5, 0.4, 16)
    np.testing.assert_array_equal(fa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(ft.numpy()[fa.numpy()], np.asarray(jt)[fa.numpy()], atol=1e-6)
    np.testing.assert_array_equal(fa.numpy(), ra.numpy())
    acc = ra.numpy()
    np.testing.assert_allclose(ft.numpy()[acc], rt.numpy()[acc], atol=1e-4)
    return acc


@pytest.mark.parametrize("dense_grid", [False, True])
def test_fast_handles_overflow_rows(dense_grid):
    """The analog of tests/test_fast_correspondence.py's test: P = 1 sends
    most queries to overflow rows; the fast path still equals JAX's and
    the reference search."""
    rng = np.random.default_rng(0)
    mj, mt = fast_fixture_map(rng, dense_grid)
    q = fast_queries(rng, 256)
    valid = np.ones(256, dtype=bool)
    valid[-20:] = False
    acc = fast_both(mj, mt, q, valid, P=1, Q=512, OV=512)
    assert acc.sum() > 50


@pytest.mark.parametrize("dense_grid", [False, True])
def test_fast_path_rejects_culled_blocks(dense_grid):
    """The analog of tests/test_fast_correspondence.py's test: after a cull
    at 6 m the fast path (through the grid's cleared cells, or the erased
    keys) equals JAX's and the reference search, and queries in culled
    territory find nothing."""
    rng = np.random.default_rng(0)
    mj, mt = fast_fixture_map(rng, dense_grid)
    mj, mt = jhm.remove_far(mj, jnp.zeros(3), 6.0), thm.remove_far(mt, torch.zeros(3), 6.0)
    assert_maps_equal(mj, mt)
    if dense_grid:
        assert_grid_consistent(mt.keys, mt.counts, mt.grid)
    q = fast_queries(rng, 256)
    acc = fast_both(mj, mt, q, np.ones(256, dtype=bool), P=4, Q=512, OV=64)
    far = np.linalg.norm(q[:, :3], axis=1) > 6.0 + 2 * VOXEL
    assert acc.sum() > 0 and not acc[far].any(), "fast path matched culled map data"


# --- the pipeline ----------------------------------------------------------------

def drive_config(dense_grid=True):
    """tests/test_checkpoint_viz.py's tiny config with a 15 m local map (the
    cull erases blocks every frame), 30 ICP iterations, and the source,
    row and probe capacities this drive needs to drop nothing."""
    return dataclasses.replace(tiny_cfg(), local_map_range=15.0, max_icp_iterations=30, source_capacity=2048,
                               corr_unique_voxel_rows=2048, corr_overflow_rows=256, probe_depth=12,
                               dense_grid=dense_grid)


def port_config(jcfg):
    return tpl.SageConfig(**dataclasses.asdict(jcfg))


FRAMES = 6


@pytest.fixture(scope="module")
def drive():
    """Six frames at 1 m over build_world(seed=4, length=80): JAX with the
    grid, the port with and without it."""
    pts, labs = synthetic.build_world(seed=4, length=80.0)
    gt = synthetic.make_trajectory(FRAMES, step=1.0)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=1800) for i in range(FRAMES)]
    jodom = jpl.SageICP(drive_config())
    port = {g: tpl.SageICP(port_config(drive_config(g)), device="cpu") for g in (True, False)}
    killed = 0
    for s in scans:
        jodom.register_frame(s)
        before = port[True].state.map.counts.clone()
        for odom in port.values():
            odom.register_frame(s)
        killed += int(((before > 0) & (port[True].state.map.counts == 0)).sum())
    return jodom, port, scans, killed


def test_drive_with_grid_equals_without_and_jax(drive):
    jodom, port, _, killed = drive
    on, off = port[True], port[False]
    assert killed > 50, "the cull erased too few blocks"
    np.testing.assert_array_equal(on.trajectory(), off.trajectory())
    a, b = state_to_numpy(on.state), state_to_numpy(off.state)
    assert set(a) - set(b) == {"map.grid"}
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert on.icp_iters == off.icp_iters
    assert int(on.aux_totals().overflow_total()) == 0
    assert_grid_consistent(a["map.keys"], a["map.counts"], a["map.grid"])

    want = state_to_numpy(jodom.state)
    np.testing.assert_allclose(on.trajectory(), jodom.trajectory(), atol=1e-4)
    for k in ("map.keys", "map.counts", "map.grid"):
        np.testing.assert_array_equal(a[k], want[k], err_msg=k)
    lsb = np.abs(a["map.points"].astype(np.int32) - want["map.points"].astype(np.int32))
    assert lsb.max() <= 1
    assert int(jodom.aux_totals().overflow_total()) == 0


def test_checkpoint_with_grid_crosses_both_ways(tmp_path, drive):
    """A port checkpoint with map_grid loads into JAX, and a JAX one into
    the port, under the grid config: every field bit for bit, the grid
    included; the resumed port steps on with the grid."""
    jodom, port, scans, _ = drive
    odom = port[True]
    path = str(tmp_path / "port.npz")
    t_ckpt.save_state(path, odom)
    with np.load(path) as z:
        assert z["map_grid"].shape == (thm.GRID_SIZE, 2) and bool(z["dense_grid"])
    loaded = j_ckpt.load_state(path, jpl.SageICP(drive_config()))
    want, got = state_to_numpy(odom.state), state_to_numpy(loaded.state)
    assert set(got) == set(want) and "map.grid" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jpath = str(tmp_path / "jax.npz")
    j_ckpt.save_state(jpath, jodom)
    back = t_ckpt.load_state(jpath, tpl.SageICP(port_config(drive_config()), device="cpu"))
    want, got = state_to_numpy(jodom.state), state_to_numpy(back.state)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(back.trajectory(), jodom.trajectory())
    resumed = t_ckpt.load_state(path, tpl.SageICP(port_config(drive_config()), device="cpu"))
    cont = tpl.SageICP(port_config(drive_config()), device="cpu")
    cont.state = odom.state
    np.testing.assert_array_equal(resumed.register_frame(scans[-1]), cont.register_frame(scans[-1]))
    a, b = state_to_numpy(resumed.state), state_to_numpy(cont.state)
    assert "map.grid" in a
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_state_round_trip_keeps_or_omits_the_grid(drive):
    _, port, _, _ = drive
    for odom in port.values():
        d = state_to_numpy(odom.state)
        back = state_from_numpy(d, "cpu")
        assert (back.map.grid is None) == (odom.state.map.grid is None)
        for k, v in state_to_numpy(back).items():
            np.testing.assert_array_equal(v, d[k], err_msg=k)


BOUNDS = {
    "kitti": dict(),
    "span_255.5": dict(local_map_range=100.6),
    "span_256_rounded_down": dict(local_map_range=100.8),  # 2 * 100.8 / 0.8 = 251.99999999999997
    "span_258": dict(local_map_range=101.6),
    "voxel_1.0_range_126": dict(voxel_size_map=1.0, local_map_range=126.0),
    "voxel_1.0_range_125.9": dict(voxel_size_map=1.0, local_map_range=125.9),
    "z_47.9": dict(dense_grid_z_extent=47.9),
    "z_48": dict(dense_grid_z_extent=48.0),
    "z_60_voxel_1.0": dict(voxel_size_map=1.0, local_map_range=50.0, dense_grid_z_extent=60.0),
    "grid_off_far": dict(dense_grid=False, local_map_range=500.0, dense_grid_z_extent=500.0),
}


@pytest.mark.parametrize("case", sorted(BOUNDS))
def test_config_bounds_refused_as_jax_refuses(case):
    """The port refuses (ValueError naming the setting, before any state
    is built) exactly the span and z-extent configs that JAX's init_state
    refuses."""
    jcfg = dataclasses.replace(tiny_config(), **{"dense_grid": True, "map_capacity": 64, **BOUNDS[case]})
    try:
        jpl.init_state(jcfg)
        refused = False
    except AssertionError:
        refused = True
    cfg = port_config(jcfg)
    if refused:
        with pytest.raises(ValueError, match="dense_grid"):
            tpl.SageICP(cfg, device="cpu")
        with pytest.raises(ValueError, match="dense_grid"):
            tpl.init_state(cfg, "cpu")
    else:
        odom = tpl.SageICP(cfg, device="cpu")
        assert (odom.state.map.grid is not None) == cfg.dense_grid
    assert refused == (case in ("span_258", "voxel_1.0_range_126", "z_48", "z_60_voxel_1.0"))


def test_two_gloo_ranks_with_the_grid_agree(tmp_path):
    """Two ranks over gloo, the grid on, tests/test_parallel.py's tiny
    config and world: equal to each other bit for bit, the grid included;
    each rank's grid consistent with its map; within 5e-4 of the port's
    single device with the grid (test_torch_parallel.py's bound)."""
    from tests.test_torch_parallel import port_tiny, run_workers

    pts, labs = synthetic.build_world(seed=1, length=60.0)
    gt = synthetic.make_trajectory(3, step=0.5)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(pts, labs, gt[i], rng, n_target=3000) for i in range(3)]
    cfg = dataclasses.replace(port_tiny(), dense_grid=True)
    r0, r1 = run_workers(tmp_path, scans, cfg, 2)
    np.testing.assert_array_equal(r0["poses"], r1["poses"])
    assert set(r0["map"]) == set(FIELDS)
    for name in FIELDS:
        np.testing.assert_array_equal(r0["map"][name], r1["map"][name], err_msg=name)
    assert_grid_consistent(r0["map"]["keys"], r0["map"]["counts"], r0["map"]["grid"])
    single = tpl.SageICP(cfg, device="cpu")
    for s in scans:
        single.register_frame(s)
    np.testing.assert_allclose(r0["poses"], single.trajectory(), atol=5e-4)
