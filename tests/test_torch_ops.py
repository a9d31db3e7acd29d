"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both. Integer and
structural outputs (voxel keys, hash slots, counts, int16 planes, picks,
row seats) must agree bit for bit; float geometry within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.ops import correspondence_fast as jcf
from sage_icp_tpu.ops import geometry as jgeo
from sage_icp_tpu.ops import hashmap as jhm
from sage_icp_tpu.ops import scan as jscan
from sage_icp_tpu.utils import synthetic as jsyn
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import correspondence_fast as tcf
from sage_icp_tpu_torch.ops import geometry as tgeo
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops import scan as tscan
from sage_icp_tpu_torch.utils import synthetic as tsyn

VOXEL = 1.0
BASIC, K = 4, 7
PROBE = 16
BASIC_LABELS = (40, 44, 48, 49, 50, 70, 72)


def t(a):
    return torch.from_numpy(np.array(a))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if torch.is_tensor(b) else np.asarray(b))


def twists(seed, n=16):
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-6  # series branch
    xi[4:8, 3:] *= 3.0 / np.linalg.norm(xi[4:8, 3:], axis=1, keepdims=True)  # near pi
    return xi


GEOMETRY = {
    "hat": lambda g, x: g.hat(x[:, 3:]),
    "so3_exp": lambda g, x: g.so3_exp(x[:, 3:]),
    "so3_log": lambda g, x: g.so3_log(g.so3_exp(x[:, 3:])),
    "se3_exp": lambda g, x: g.se3_exp(x),
    "se3_log": lambda g, x: g.se3_log(g.se3_exp(x)),
    "se3_inverse": lambda g, x: g.se3_inverse(g.se3_exp(x)),
    "renormalize": lambda g, x: g.renormalize(g.se3_exp(x) * 1.01),
    "transform_points": lambda g, x: g.transform_points(g.se3_exp(x[0]), x[:, [0, 1, 2, 5]] * 20.0),
}


@pytest.mark.parametrize("name", sorted(GEOMETRY))
def test_geometry_matches_jax(name):
    xi = twists(1)
    want = np.asarray(GEOMETRY[name](jgeo, jnp.asarray(xi)))
    got = GEOMETRY[name](tgeo, t(xi)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * max(1.0, np.abs(want).max()))


def random_scan(rng, n, spread=8.0, labels=(0, 40, 44, 50, 10, 80, 81)):
    xyz = rng.uniform(-spread, spread, size=(n, 3))
    lab = rng.choice(labels, size=n)
    return np.concatenate([xyz, lab[:, None]], axis=1).astype(np.float32)


def test_preprocess_and_voxel_downsample_bit_exact():
    rng = np.random.default_rng(2)
    pts = random_scan(rng, 3000, spread=30.0, labels=(0, 40, 44, 50, 10, 80, 81, 300))
    pts[::7, :3] = np.round(pts[::7, :3] / 0.3) * 0.3  # points on cell edges
    valid = rng.random(3000) < 0.9
    cfg = tpl.PRESETS["city"]
    jp, jv = jscan.preprocess(jnp.asarray(pts), jnp.asarray(valid), 25.0, 2.0, 12.0)
    tp, tv = tscan.preprocess(t(pts), t(valid), 25.0, 2.0, 12.0)
    eq(jp, tp)
    eq(jv, tv)
    lut = jscan.make_label_group_lut(list(map(list, cfg.voxel_labels)))
    sizes = np.asarray(cfg.voxel_size, np.float32)
    for scale, cap in ((0.5, 2048), (1.5, 300)):  # 300: truncation
        want = jscan.voxel_downsample(jp, jv, lut, jnp.asarray(sizes), scale, cap,
                                      voxel_labels=cfg.voxel_labels, with_stats=True)
        got = tscan.voxel_downsample(tp, tv, cfg.voxel_labels, t(sizes), scale, cap)
        for a, b in zip(want, got):
            eq(a, b)


def test_hash_keys_and_lookup_bit_exact():
    rng = np.random.default_rng(3)
    keys = rng.integers(-(2**20), 2**20, size=(4096, 3)).astype(np.int32)
    for cap in (1024, 131072):
        eq(jhm.hash_keys(jnp.asarray(keys), cap), thm.hash_keys(t(keys), cap))
    state_j = jhm.insert(jhm.create(1024, K), jnp.asarray(random_scan(rng, 400)), jnp.ones(400, bool),
                         VOXEL, BASIC, jnp.asarray(mask_np()))
    state_t = thm.MapState(*[t(np.asarray(a)) for a in state_j[:4]])
    q = np.concatenate([np.asarray(state_j.keys)[:300], rng.integers(-9, 9, (300, 3))]).astype(np.int32)
    eq(jhm.lookup(state_j, jnp.asarray(q), PROBE), thm.lookup(state_t, t(q), PROBE))


def mask_np(n=260):
    m = np.zeros(n, dtype=bool)
    m[list(BASIC_LABELS)] = True
    return m


def assert_maps_equal(mj, mt):
    for name in ("keys", "counts", "points", "first_pts"):
        eq(getattr(mj, name), getattr(mt, name))


def test_insert_and_remove_far_bit_exact():
    """A sequence of inserts (revisits, label-0 overwrites, more than
    R_max points in one voxel, fewer unique slots than voxels) and a cull
    followed by a re-insert into freed slots: the maps agree slot for slot
    and the drop counters agree."""
    rng = np.random.default_rng(4)
    mj, mt = jhm.create(1024, K), thm.create(1024, K)
    mask_j, mask_t = jnp.asarray(mask_np()), t(mask_np())
    dense = np.concatenate([np.full((40, 3), 0.5) + rng.normal(0, 0.1, (40, 3)),
                            rng.choice([0, 40, 10], (40, 1))], axis=1).astype(np.float32)
    batches = [random_scan(rng, 500), np.concatenate([random_scan(rng, 500, spread=4.0), dense]),
               random_scan(rng, 500, spread=12.0)]
    for i, pts in enumerate(batches):
        n = len(pts)
        valid = rng.random(n) < 0.95
        U = 300 if i == 2 else n  # the third batch overflows the unique capacity
        mj, sj = jhm.insert(mj, jnp.asarray(pts), jnp.asarray(valid), VOXEL, BASIC, mask_j,
                            max_incoming_per_voxel=8, probe_depth=PROBE, unique_voxel_capacity=U,
                            with_stats=True, policy_kernel=False)
        mt, st = thm.insert(mt, t(pts), t(valid), VOXEL, BASIC, mask_t,
                            max_incoming_per_voxel=8, probe_depth=PROBE, unique_voxel_capacity=U)
        assert_maps_equal(mj, mt)
        for a, b in zip(sj, st):
            eq(a, b)
        if i == 1:
            origin = np.array([3.0, -2.0, 1.0], np.float32)
            mj = jhm.remove_far(mj, jnp.asarray(origin), 6.0)
            mt = thm.remove_far(mt, t(origin), 6.0)
            assert_maps_equal(mj, mt)
    assert int(st.unique_overflow) > 0 and int(np.asarray(mt.counts).sum()) > 0


def build_maps(seed, n=600, spread=12.0):
    rng = np.random.default_rng(seed)
    pts = random_scan(rng, n, spread=spread, labels=(0, 40, 44, 50, 10, 80))
    mj = jhm.insert(jhm.create(2048, K), jnp.asarray(pts), jnp.ones(n, bool), VOXEL, BASIC,
                    jnp.asarray(mask_np()))
    mt, _ = thm.insert(thm.create(2048, K), t(pts), torch.ones(n, dtype=torch.bool), VOXEL, BASIC,
                       t(mask_np()))
    assert_maps_equal(mj, mt)
    return mj, mt, rng


def queries(rng, n=400, spread=12.0):
    q = np.concatenate([rng.uniform(-spread, spread, (n, 3)), rng.choice([0, 40, 50, 10], (n, 1))],
                       axis=1).astype(np.float32)
    q[n // 2 : n // 2 + 60, :3] = q[n // 2, :3] + rng.uniform(-0.2, 0.2, (60, 3))  # crowded voxel
    valid = np.ones(n, dtype=bool)
    valid[-20:] = False
    return q, valid


@pytest.mark.parametrize("P,Q,OV", [(4, 256, 64), (1, 128, 512)])
def test_probe_tables_probe_and_corr_setup_bit_exact(P, Q, OV):
    mj, mt, rng = build_maps(5)
    center = np.array([1, -1, 0], np.int32)
    tj = jcf.build_probe_tables(mj, jnp.asarray(center), PROBE)
    tt = tcf.build_probe_tables(mt, t(center), PROBE)
    eq(tj.window, tt.window)
    eq(tj.points2, tt.points2)
    keys = np.concatenate([np.asarray(mj.keys)[:200], rng.integers(-14, 14, (200, 3))]).astype(np.int32)
    rel = keys - center
    for a, b in zip(jcf.probe(tj, jnp.asarray(keys), jcf.pack_rel(jnp.asarray(rel)), PROBE),
                    tcf.probe(tt, t(keys), tcf.pack_rel(t(rel)), PROBE)):
        eq(a, b)
    q, valid = queries(rng)
    sj = jcf.corr_setup(mj, tj, jnp.asarray(q), jnp.asarray(valid), VOXEL, PROBE, Q, P, OV)
    st = tcf.corr_setup(mt, tt, t(q), t(valid), VOXEL, PROBE, Q, P, OV)
    for name in jcf.CorrSetup._fields:
        eq(getattr(sj, name), getattr(st, name))
    assert int(st.n_dropped) > 0 if P == 1 else True


@pytest.mark.parametrize("sem_th", [0.4, 1.0])
def test_fast_correspondences_match_reference_search(sem_th):
    _, mt, rng = build_maps(6)
    q, valid = queries(rng)
    tables = tcf.build_probe_tables(mt, torch.zeros(3, dtype=torch.int32), PROBE)
    tgt_f, acc_f = tcf.get_correspondences_fast(mt, tables, t(q), t(valid), VOXEL, 1.5, sem_th, PROBE,
                                                unique_voxel_rows=512, queries_per_voxel=4,
                                                overflow_rows=64)
    tgt_r, acc_r, _ = thm.get_correspondences(mt, t(q), t(valid), VOXEL, 1.5, sem_th, PROBE)
    eq(acc_r, acc_f)
    assert int(acc_r.sum()) > 100
    np.testing.assert_allclose(tgt_f[acc_r].numpy(), tgt_r[acc_r].numpy(), atol=1e-5)


def test_config_and_presets_match_jax():
    assert set(tpl.PRESETS) == set(jpl.PRESETS)
    for name, jcfg in jpl.PRESETS.items():
        assert dataclasses.asdict(tpl.PRESETS[name]) == dataclasses.asdict(jcfg), name
        assert tpl.PRESETS[name].points_per_voxel == jcfg.points_per_voxel


def test_synthetic_copy_matches_jax():
    for fn, kw in (("build_world", dict(seed=1, length=80.0)),
                   ("build_city_world", dict(seed=0, size=180.0, density=0.7))):
        for a, b in zip(getattr(jsyn, fn)(**kw), getattr(tsyn, fn)(**kw)):
            np.testing.assert_array_equal(a, b)
    gt_j = jsyn.make_trajectory(9, step=1.0, jitter=0.1)
    gt_t = tsyn.make_trajectory(9, step=1.0, jitter=0.1)
    np.testing.assert_array_equal(gt_j, gt_t)
    np.testing.assert_array_equal(jsyn.make_maneuver_trajectory(step=0.75), tsyn.make_maneuver_trajectory(step=0.75))
    pts, labs = tsyn.build_world(seed=1, length=80.0)
    sj = jsyn.render_scan(pts, labs, gt_j[3], np.random.default_rng(3), n_target=5000)
    st = tsyn.render_scan(pts, labs, gt_t[3], np.random.default_rng(3), n_target=5000)
    np.testing.assert_array_equal(sj, st)


def test_map_helpers_match_jax():
    """clear, is_empty and dequantize_points, bit for bit."""
    rng = np.random.default_rng(5)
    pts = random_scan(rng, 300)
    mj = jhm.insert(jhm.create(512, K), jnp.asarray(pts), jnp.ones(300, bool), VOXEL, BASIC,
                    jnp.asarray(mask_np()), policy_kernel=False)
    mt, _ = thm.insert(thm.create(512, K), t(pts), torch.ones(300, dtype=torch.bool), VOXEL, BASIC, t(mask_np()))
    assert bool(jhm.is_empty(mj)) is bool(thm.is_empty(mt)) is False
    cj, ct = jhm.clear(mj), thm.clear(mt)
    assert_maps_equal(cj, ct)
    assert_maps_equal(jhm.create(512, K), ct)
    assert bool(jhm.is_empty(cj)) is bool(thm.is_empty(ct)) is True
    assert ct.first_pts.dtype == mt.first_pts.dtype and ct.points.shape == mt.points.shape
    stored = rng.integers(-32767, 32768, (64, 5, 4)).astype(np.int16)
    stored[..., 3] = rng.choice([0, 40, 259], (64, 5))
    vkeys = rng.integers(-500, 500, (64, 5, 3)).astype(np.int32)
    for voxel in (1.0, 0.8):
        eq(jhm.dequantize_points(jnp.asarray(stored), jnp.asarray(vkeys), voxel),
           thm.dequantize_points(t(stored), t(vkeys), voxel))
    world = tsyn.render_scan(*tsyn.build_world(seed=1, length=40.0), tsyn.make_trajectory(1)[0],
                             np.random.default_rng(0), n_target=2000)
    keys = tscan.trunc_div(t(world[:, :3]), 0.8)
    q = thm.quantize_points(t(world), keys, 0.8)
    back = thm.dequantize_points(q, keys, 0.8)
    np.testing.assert_allclose(back.numpy(), world, atol=0.8 / 32767.0)


def test_se3_identity_and_moving_car_points_match_jax():
    eq(jgeo.se3_identity(), tgeo.se3_identity())
    assert tgeo.se3_identity(torch.float64).dtype == torch.float64
    for seed, offset in ((0, 8.0), (3, -12.5)):
        np.testing.assert_array_equal(jsyn.moving_car_points(offset, np.random.default_rng(seed)),
                                      tsyn.moving_car_points(offset, np.random.default_rng(seed)))
    np.testing.assert_array_equal(jsyn.moving_car_points(5.0, np.random.default_rng(1), n=37),
                                  tsyn.moving_car_points(5.0, np.random.default_rng(1), n=37))


def test_slot_reuse_after_cull():
    """The analog of tests/test_hashmap.py's test: a map culled to empty
    takes the same points again, every voxel back exactly once, slot for
    slot as the JAX package's."""
    rng = np.random.default_rng(0)
    pts = random_scan(rng, 120, spread=10.0)
    ins_j = lambda m: jhm.insert(m, jnp.asarray(pts), jnp.ones(120, bool), VOXEL, BASIC, jnp.asarray(mask_np()),
                                 policy_kernel=False)
    ins_t = lambda m: thm.insert(m, t(pts), torch.ones(120, dtype=torch.bool), VOXEL, BASIC, t(mask_np()))[0]
    mj, mt = ins_j(jhm.create(256, K)), ins_t(thm.create(256, K))
    assert_maps_equal(mj, mt)
    mj, mt = jhm.remove_far(mj, jnp.zeros(3), 0.01), thm.remove_far(mt, torch.zeros(3), 0.01)
    assert_maps_equal(mj, mt)
    assert bool(jhm.is_empty(mj)) and bool(thm.is_empty(mt))
    mj, mt = ins_j(mj), ins_t(mt)
    assert_maps_equal(mj, mt)
    live = mt.keys[mt.counts > 0]
    assert len(torch.unique(live, dim=0)) == len(live) == len(np.unique(np.trunc(pts[:, :3]), axis=0))


def test_negative_coords_truncation():
    """The analog of tests/test_hashmap.py's test: -0.4 / 1.0 truncates to
    voxel 0, as static_cast<int> does, so both points share one block;
    the map equals the JAX package's slot for slot."""
    pts = np.array([[-0.4, -0.4, -0.4, 40.0], [0.4, 0.4, 0.4, 50.0]], np.float32)
    mj = jhm.insert(jhm.create(1024, K), jnp.asarray(pts), jnp.ones(2, bool), VOXEL, BASIC, jnp.asarray(mask_np()),
                    policy_kernel=False)
    mt, _ = thm.insert(thm.create(1024, K), t(pts), torch.ones(2, dtype=torch.bool), VOXEL, BASIC, t(mask_np()))
    assert_maps_equal(mj, mt)
    assert int(mt.counts.sum()) == 2 and int((mt.counts > 0).sum()) == 1
    assert mt.keys[mt.counts > 0].tolist() == [[0, 0, 0]]
