"""The port's dynamic-vehicle filter, its radius-count kernel and the
bitonic sort kernel against the JAX package, on the CPU.

The JAX side runs the Pallas kernels in interpret mode and its filter
jitted; the port runs the kernels' plain versions. Everything compared
here is integers or selected points: the radius counts, the sorted
planes, the filter's keep mask, points and overflow, and the step's
downsampled source and frame points, all bit for bit. The CUDA kernels
are held against the plain versions on the card by
tests/test_torch_cuda.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.ops import dynamic_filter as jdyn
from sage_icp_tpu.ops import pallas_nn as jpn
from sage_icp_tpu.ops import pallas_sort as jps
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import dynamic_filter as tdyn
from sage_icp_tpu_torch.ops import nn_kernels, sort_kernel
from sage_icp_tpu_torch.ops import scan as tscan
from tests.test_robustness import small_config
from tests.test_torch_cuda import (car_row_scan, city_frame, crowded_cell_scan, kitti_world, pad_scan,
                                   parked_moving_scan, radius_edge_rows, radius_rows, sort_planes, t, vehicle_keys)

CAP = 16384
VEHICLE = (10, 11, 13, 15, 16, 18, 20)
# one compile for every case: the filter reads no capacity of the config
_jax_filter = jax.jit(functools.partial(jdyn.filter_dynamic_vehicles, config=jpl.SageConfig(), with_stats=True))


@pytest.fixture(scope="module")
def city_scan():
    """A kitti-scale frame cropped to the 16,384-point test capacity
    around a parked car the filter keeps."""
    return city_frame(kitti_world(), crop=(14.0, 12.0))


@pytest.mark.parametrize("P", [1, 48])
def test_radius_count_plain_matches_pallas(P):
    args = radius_rows(1, R=512, P=P)
    want = np.asarray(jpn.radius_count(*[jnp.asarray(a) for a in args], 0.25, interpret=True))
    got = nn_kernels.radius_count(*[t(a) for a in args], 0.25).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0 and (want == 0).any()


@pytest.mark.parametrize("M,P", [(27 * 32, 48), (27 * 32 - 3, 1), (37, 48)])
def test_radius_count_plain_matches_pallas_on_edge_lanes(M, P):
    """NaN and infinite lanes and queries, lanes at the kernel's skip
    margin (radius_edge_rows)."""
    args = radius_edge_rows(9, R=128, P=P, M=M)
    want = np.asarray(jpn.radius_count(*[jnp.asarray(a) for a in args], 0.25, interpret=True))
    got = nn_kernels.radius_count(*[t(a) for a in args], 0.25).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0


@pytest.mark.parametrize("r2", [0.25, 1.0, 2.0, 0.0, -1.0, 1e-30, 1e-45, 3e38, 3.4e38, np.inf, np.nan])
def test_skip_margin_squares_past_r2(r2):
    """The radius-count kernel's lane skip is exact when fl(m * m) > r2;
    m stays within 2^-9 of sqrt(r2) where r2 is not tiny, and is +inf
    (no skip) only where no float32 margin works."""
    m = nn_kernels.skip_margin(r2)
    r2 = np.float32(r2)
    assert m.dtype == np.float32
    if not np.isfinite(r2):
        assert m == np.inf
        return
    with np.errstate(over="ignore"):
        assert np.float32(m * m) > r2
    if 1e-30 <= r2 <= 3e38:
        assert m <= np.sqrt(np.float64(r2)) * (1 + 2.0**-9)


@pytest.mark.parametrize("M,P", [(27 * 32, 48), (27 * 32 - 3, 1), (37, 48)])
def test_radius_skip_rule_keeps_every_count(M, P):
    """The kernel's lane skip (csrc/radius_count.cu) in numpy: a lane with
    fl(c - hi) > m or fl(lo - c) > m on an axis, for the bounds lo/hi of
    the row's finite used queries, is made NaN (it never counts); the
    plain counts do not change. The margin lanes of radius_edge_rows fall
    on both sides of the rule."""
    cx, cy, cz, q, used = radius_edge_rows(9, R=128, P=P, M=M)
    m = nn_kernels.skip_margin(0.25)
    planes = np.stack([cx, cy, cz])  # (3, R, M)
    qq = q.reshape(len(used), P, 3)
    drop = np.zeros(cx.shape, dtype=bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for r in np.nonzero(used.any(axis=1))[0]:
            fin = qq[r][(used[r] != 0) & np.isfinite(qq[r]).all(axis=1)]
            lo = fin.min(axis=0) if len(fin) else np.full(3, np.inf, np.float32)
            hi = fin.max(axis=0) if len(fin) else np.full(3, -np.inf, np.float32)
            c = planes[:, r, :]
            drop[r] = ((c - hi[:, None] > m) | (lo[:, None] - c > m)).any(axis=0)
    skipped = np.where(drop, np.float32(np.nan), planes)
    want = nn_kernels.radius_count(*[t(a) for a in (cx, cy, cz, q, used)], 0.25)
    got = nn_kernels.radius_count(*[t(a) for a in (*skipped, q, used)], 0.25)
    assert torch.equal(got, want) and float(want.max()) > 0
    edge = drop[used.any(axis=1)][:, 12:30]
    assert edge.any() and not edge.all()


@pytest.mark.parametrize("n", [256, 2048])
def test_bitonic_plain_matches_pallas(n):
    """tests/test_pallas_sort.py's case: two duplicated uint32 keys, an
    iota key, a float payload."""
    planes = sort_planes(2, n, unsigned=True)
    jplanes = [jnp.asarray(p.view(np.uint32)) for p in planes[:2]] + [jnp.asarray(p) for p in planes[2:]]
    want = jps.bitonic_sort_planes(tuple(jplanes), num_keys=3, interpret=True)
    got = sort_kernel.bitonic_sort_planes([t(p) for p in planes], 3, unsigned=(True, True, False))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().view(np.asarray(w).dtype), np.asarray(w))
    assert not np.array_equal(got[2].numpy(), planes[2])


@pytest.mark.parametrize("n", [256, 2048])
def test_bitonic_network_plain_matches_pallas_on_ties(n):
    """Two duplicated keys and no iota key: the network copies one element
    over its tied partner, in the port's network as in the TPU kernel."""
    planes = sort_planes(3, n, unsigned=True)
    jplanes = [jnp.asarray(p.view(np.uint32)) for p in planes[:2]] + [jnp.asarray(p) for p in planes[2:]]
    want = jps.bitonic_sort_planes(tuple(jplanes), num_keys=2, interpret=True)
    got = sort_kernel.bitonic_network_plain([t(p) for p in planes], 2, unsigned=(True, True))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().view(np.asarray(w).dtype), np.asarray(w))
    assert len(np.unique(got[2].numpy())) < n  # payloads were copied over


@pytest.mark.parametrize("unsigned", [False, True])
@pytest.mark.parametrize("n", [256, 2048])
def test_bitonic_network_plain_matches_stable_sort(n, unsigned):
    """Under the contract (an iota last key) the network is the stable
    sort."""
    planes = [t(p) for p in sort_planes(4, n, unsigned)]
    flags = (unsigned, unsigned, False)
    got = sort_kernel.bitonic_network_plain(planes, 3, flags)
    want = sort_kernel.bitonic_sort_planes_plain(planes, 3, flags)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not torch.equal(got[2], planes[2])


def test_filter_refuses_grid_beyond_float32_ids():
    """Cell ids pool in float32, exact below 2^24 cells: 179 m fits, 180 m
    is refused rather than clustered differently from JAX."""
    assert tdyn._grid_nx(179.0) ** 2 * 32 < 2**24 <= tdyn._grid_nx(180.0) ** 2 * 32
    buf, valid = parked_moving_scan(2048)
    cfg = dataclasses.replace(tpl.PRESETS["kitti"], label_max_range=180.0)
    with pytest.raises(ValueError, match="2\\^24"):
        tdyn.filter_dynamic_vehicles(t(buf), t(valid), cfg)


def run_both(buf, valid):
    """The filter's keep mask, points and overflow against JAX's; returns
    (keep mask, overflow, landmark cells dropped: the port's own count)."""
    jp, jv, jo = _jax_filter(jnp.asarray(buf), jnp.asarray(valid))
    tp, tv, to, tl = tdyn.filter_dynamic_vehicles(t(buf), t(valid), tpl.PRESETS["kitti"])
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert int(to) == int(jo)
    return tv.numpy(), int(to), int(tl)


def preprocessed(scan, cfg):
    buf, valid = pad_scan(scan, CAP)
    pts, ok = tscan.preprocess(t(buf), t(valid), cfg.max_range, cfg.min_range, cfg.label_max_range)
    return pts.numpy(), ok.numpy()


def test_filter_matches_jax_parked_and_moving():
    """The JAX suite's decision: the parked car kept, the moving removed."""
    buf, valid = parked_moving_scan(CAP)
    keep, overflow, lmk_dropped = run_both(buf, valid)
    labs, xs = buf[:, 3].astype(int), buf[:, 0]
    assert keep[(labs == 10) & (xs < 20) & valid].mean() > 0.9
    assert keep[(labs == 10) & (xs > 20) & valid].mean() < 0.1
    assert keep[(labs != 10) & valid].all() and overflow == 0 and lmk_dropped == 0


def test_filter_matches_jax_city_scan(city_scan):
    pts, ok = preprocessed(city_scan, tpl.PRESETS["kitti"])
    keep, overflow, lmk_dropped = run_both(pts, ok)
    vehicle = ok & np.isin(pts[:, 3].astype(int), VEHICLE)
    assert 0 < (vehicle & keep).sum() < vehicle.sum() and overflow == 0 and lmk_dropped == 0


def test_filter_matches_jax_slot_overflow():
    buf, valid = crowded_cell_scan(CAP)
    _, overflow, _ = run_both(buf, valid)
    assert overflow >= 12 + 5


def test_filter_matches_jax_on_a_row_past_the_round_cut():
    """car_row_scan: parked cars bumper to bumper over 45 cells, one blob
    longer than the 24 diffusion rounds reach. The port's cluster ids of
    the vehicle rows equal those of JAX's 24 rounds of reduce_window (as
    sage_icp_tpu/ops/dynamic_filter.py runs them) on the same occupied
    cells: 21 ids, not one. The keep mask and overflow equal JAX's filter:
    the first 25 cells' points are kept, the rest, clusters of two
    points, removed."""
    buf, valid = car_row_scan(CAP)
    keep, overflow, _ = run_both(buf, valid)
    cfg = tpl.PRESETS["kitti"]
    nx, nz = tdyn._grid_nx(cfg.label_max_range), tdyn._GRID_NZ
    vk = vehicle_keys(t(buf), t(valid), cfg)
    got = tdyn.cluster_ids(vk, nx).numpy()
    cells = np.unique(vk.numpy()[vk.numpy() != tdyn._BIG])
    big = np.int32(2**30)
    comp = jnp.full((nx * nx * nz,), big, jnp.int32).at[jnp.asarray(cells)].set(jnp.asarray(cells, jnp.int32))
    occ = (comp != big).reshape(nx, nx, nz)

    def diffuse(_, c):
        pooled = jax.lax.reduce_window(c, big, jax.lax.min, (3, 3, 3), (1, 1, 1), "SAME")
        return jnp.where(occ, jnp.minimum(c, pooled), big)

    want = np.asarray(jax.lax.fori_loop(0, jdyn._CC_ITERS, diffuse, comp.reshape(nx, nx, nz))).reshape(-1)
    live = vk.numpy() != tdyn._BIG
    np.testing.assert_array_equal(got[live], want[vk.numpy()[live]])
    assert len(cells) == 90 and len(np.unique(got[live])) == 21
    car = (buf[:, 3] == 10) & valid
    cell_x = np.floor((buf[:, 0] - 5.0) / 0.5)
    assert keep[car & (cell_x < 25)].all() and not keep[car & (cell_x >= 25)].any() and overflow == 0


def landmark_lattice_scan(cap=CAP, side=70):
    """side x side landmark points (parking 44 and sidewalk 48), one in
    each 0.5 m cell of x, y in [0, 0.5 side), more distinct cells than the
    filter's _LMK_VOXEL_CAP; a low parked car over the first columns of
    cells and one over the last columns, which sort past the capacity."""
    rng = np.random.default_rng(5)
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    lot = np.stack([0.25 + 0.5 * i.ravel(), 0.25 + 0.5 * j.ravel(), np.full(i.size, 0.1),
                    np.where((i + j).ravel() % 2 == 0, 44.0, 48.0)], 1)
    u = lambda lo, hi, n: rng.uniform(lo, hi, n)
    cars = [np.stack([u(x0, x0 + 2.0, 80), u(5.0, 6.5, 80), u(0.15, 0.45, 80), np.full(80, 10.0)], 1)
            for x0 in (5.0, 31.0)]
    return pad_scan(np.concatenate([lot, *cars]).astype(np.float32), cap)


def test_filter_counts_landmark_cells_beyond_capacity():
    """4,900 landmark cells: the 804 past the 4,096 the filter stores are
    dropped as in JAX (the keep mask equal to JAX's, so the car over them
    finds no landmark and is removed) and counted by the port."""
    buf, valid = landmark_lattice_scan()
    keep, overflow, lmk_dropped = run_both(buf, valid)
    assert lmk_dropped == 70 * 70 - tdyn._LMK_VOXEL_CAP == 804
    car, xs = (buf[:, 3] == 10) & valid, buf[:, 0]
    assert keep[car & (xs < 20)].mean() > 0.9
    assert not keep[car & (xs > 20)].any()
    assert overflow == 0


def test_prepare_icp_inputs_with_filter_matches_jax(city_scan):
    """The slice before the solve, from the initial state: preprocess,
    the filter, the double downsample. At the kitti min_range of 5 m the
    parked car's cluster is kept (from 1 m, nearer car points join it and
    it is removed)."""
    jcfg = small_config(dynamic_vehicle_filter=True, min_range=5.0)
    tcfg = tpl.SageConfig(**dataclasses.asdict(jcfg))
    buf, valid = pad_scan(city_scan, jcfg.scan_capacity)
    prepare = jax.jit(functools.partial(jpl.prepare_icp_inputs, config=jcfg))
    want = prepare(jpl.init_state(jcfg), jnp.asarray(buf), jnp.asarray(valid), jnp.zeros(len(buf), jnp.float32))
    got = tpl.prepare_icp_inputs(tpl.init_state(tcfg, "cpu"), t(buf), t(valid), torch.zeros(len(buf)), tcfg)
    for name in ("source", "source_valid", "frame_ds", "frame_valid", "ds_trunc", "dyn_overflow"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    frame_labels = got["frame_ds"][got["frame_valid"], 3].to(torch.int32).numpy()
    assert np.isin(frame_labels, VEHICLE).any()
