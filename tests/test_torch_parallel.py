"""The port's multi-rank layer (parallel/sharding.py, parallel/distributed.py,
parallel/worker.py) on the CPU, against the JAX package and against the
port's single-device step.

Ranks are processes: `python -m sage_icp_tpu_torch.parallel.worker` (or a
small insert script), over gloo, meeting through a file:// rendezvous
under a temporary directory (no TCP port, so parallel test workers cannot
collide), each capped at two intra-op threads. Every worker group the
tests read is spawned once, all together (worker_runs).

Tolerances: pad_config_for_mesh equal to JAX's field for field; the
sharded step at one rank equal to SageICP bit for bit, on the fast and the
reference path; two ranks equal to each other bit for bit, and within
5e-4 of JAX's single-device SageICP and of the port's
(test_sharded_step_matches_single_device's bound: only the order in which
the two halves' GN or normal-equation sums are added differs), on the
fast path, with the filter and deskew on, and on the reference path; the
row-sharded insert equal to the single-device insert bit for bit. The
rank-local pieces are held in tests/test_torch_sharded_points.py."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sage_icp_tpu.models import pipeline as jpl
from sage_icp_tpu.parallel import sharding as jsh
from sage_icp_tpu.utils import synthetic
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import hashmap as thm
from sage_icp_tpu_torch.ops.registration import BLOCK_ITERATIONS
from sage_icp_tpu_torch.parallel import distributed as tdist
from sage_icp_tpu_torch.parallel import sharding as tsh
from sage_icp_tpu_torch.parallel.worker import save_scans
from tests.test_parallel import tiny_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 180


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op threads, as the ranks use: the suite's workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_tiny():
    return tpl.SageConfig(**dataclasses.asdict(tiny_config()))


@pytest.fixture(scope="module")
def tiny_scans():
    """tests/test_parallel.py's world, trajectory and seed: 3 frames."""
    pts, labs = synthetic.build_world(seed=1, length=60.0)
    gt = synthetic.make_trajectory(3, step=0.5)
    rng = np.random.default_rng(0)
    return [synthetic.render_scan(pts, labs, gt[i], rng, n_target=3000) for i in range(3)]


# the configurations the ranks drive: the tiny config's fast path, then
# with the dynamic filter and deskew on (the filter's and the scan head's
# splits; labels kept within 20 m, an 88 x 88 x 32 grid that ~110 vehicle
# and ~650 landmark points of each tiny scan fall in), and on the
# reference path (the reference search's split)
DRIVES = {
    "fast": {},
    "filter": dict(dynamic_vehicle_filter=True, deskew=True, label_max_range=20.0),
    "reference": dict(use_fast_correspondences=False),
}


def drive_config(name):
    return dataclasses.replace(port_tiny(), **DRIVES[name])


@pytest.fixture(scope="module")
def single_runs(tiny_scans):
    """name -> the port's single-device SageICP driven over the tiny scans
    with DRIVES[name], and JAX's SageICP's trajectory; each run once."""
    runs = {}

    def run(name):
        if name not in runs:
            odom = tpl.SageICP(drive_config(name), device="cpu")
            jax_odom = jpl.SageICP(jpl.SageConfig(**dataclasses.asdict(drive_config(name))))
            for s in tiny_scans:
                odom.register_frame(s)
                jax_odom.register_frame(s)
            runs[name] = odom, jax_odom.trajectory()
        return runs[name]

    return run


@pytest.fixture(scope="module")
def port_single(single_runs):
    return single_runs("fast")[0]


def spawn(cmds):
    """Run the rank processes together; each must exit 0 in time."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out[-4000:]}"
    return outs


def worker_cmds(tmp_path, scans, config, world):
    """The commands of a gloo group of `world` worker ranks driving
    `config` over `scans`, its files under tmp_path."""
    save_scans(str(tmp_path / "scans.npy"), scans)
    fields = {k: v for k, v in dataclasses.asdict(config).items() if v != getattr(tpl.PRESETS["kitti"], k)}
    (tmp_path / "config.json").write_text(json.dumps(fields))
    return [[sys.executable, "-m", "sage_icp_tpu_torch.parallel.worker", "--rank", str(r), "--world", str(world),
             "--init", f"file://{tmp_path / 'rendezvous'}", "--backend", "gloo", "--device", "cpu",
             "--preset", "kitti", "--config", str(tmp_path / "config.json"),
             "--scans", str(tmp_path / "scans.npy"), "--out", str(tmp_path)] for r in range(world)]


def worker_results(tmp_path, world):
    return [dict(poses=np.load(tmp_path / f"poses_{r}.npy"), map=dict(np.load(tmp_path / f"map_{r}.npz")),
                 report=json.loads((tmp_path / f"rank_{r}.json").read_text())) for r in range(world)]


def run_workers(tmp_path, scans, config, world):
    """One gloo group of `world` worker ranks, run to its end: the ranks'
    trajectories, maps and reports."""
    spawn(worker_cmds(tmp_path, scans, config, world))
    return worker_results(tmp_path, world)


# the gloo groups the tests read: (DRIVES name, world size)
GROUPS = (("fast", 1), ("fast", 2), ("filter", 2), ("reference", 1), ("reference", 2))


@pytest.fixture(scope="module")
def worker_runs(tmp_path_factory, tiny_scans):
    """Every gloo group of GROUPS, spawned together once (a rendezvous
    each): (name, world) -> the ranks' trajectories, maps and reports."""
    dirs = {g: tmp_path_factory.mktemp(f"{g[0]}_{g[1]}") for g in GROUPS}
    spawn([c for (name, world), d in dirs.items() for c in worker_cmds(d, tiny_scans, drive_config(name), world)])
    return {(name, world): worker_results(d, world) for (name, world), d in dirs.items()}


def test_card_tests_use_the_tiny_config():
    from tests.test_torch_cuda import TINY_CONFIG

    assert tpl.SageConfig(**TINY_CONFIG) == port_tiny()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["kitti", "city", "tiny"])
def test_pad_config_for_mesh_matches_jax(name, n):
    jcfg = tiny_config() if name == "tiny" else jpl.PRESETS[name]
    want = jsh.pad_config_for_mesh(jcfg, jsh.make_mesh(n_devices=n))
    mesh = tsh.Mesh(size=n, rank=0, group=None, device=torch.device("cpu"))
    got = tsh.pad_config_for_mesh(tpl.SageConfig(**dataclasses.asdict(jcfg)), mesh)
    assert mesh.shape == {tsh.POINTS_AXIS: n}
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_row_ranges_cover_the_rows_in_rank_order():
    for n in (1, 2, 3, 4, 8):
        for rows in (1, 640, 18_432, 33_024, 1_001):
            ranges = [tsh.Mesh(n, r, None, torch.device("cpu")).row_range(rows) for r in range(n)]
            assert ranges[0][0] == 0 and ranges[-1][1] == rows
            assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(ranges, ranges[1:]))


def test_gn_row_slices_keep_the_plane_alignment():
    """A rank's GN rows are views at row offset lo: the plane base moves by
    lo * 2M bytes, a multiple of the kernel's load width for every M the
    presets and the tiny config give (M = 27 K)."""
    from sage_icp_tpu_torch.ops.nn_kernels import gn_load_bytes

    configs = list(tpl.PRESETS.values()) + [port_tiny()]
    for cfg in configs:
        M = 27 * cfg.points_per_voxel
        assert (2 * M) % gn_load_bytes(M) == 0, cfg
    assert gn_load_bytes(27 * tpl.PRESETS["kitti"].points_per_voxel) == 16


def test_make_mesh_without_a_group_is_a_world_of_one():
    mesh = tsh.make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.device) == (1, 0, None, torch.device("cpu"))
    x = torch.arange(6).reshape(3, 2)
    assert mesh.all_gather(x) is x
    assert tsh.init_distributed is tdist.init_distributed


def test_init_distributed_never_gives_nccl_up_for_gloo(monkeypatch):
    with pytest.raises(ValueError, match="nccl"):
        tdist.init_distributed("file:///nonexistent", 1, 0, device="cpu")
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        tdist.init_distributed(backend="gloo", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.init_distributed("file:///nonexistent", 1, 0)


def test_sharded_step_at_one_rank_equals_sage_icp(tiny_scans, port_single):
    """ShardedSageICP and make_sharded_step on a world of one: the
    trajectory, the map and the counters equal SageICP's bit for bit."""
    mesh = tsh.make_mesh("cpu")
    odom = tsh.ShardedSageICP(port_tiny(), mesh)
    assert odom.config == port_tiny() and odom.mesh is mesh
    for s in tiny_scans:
        odom.register_frame(s)
    np.testing.assert_array_equal(odom.trajectory(), port_single.trajectory())
    for a, b in zip(odom.state.map, port_single.state.map):
        assert (a is None and b is None) or torch.equal(a, b)
    assert odom.icp_iters == port_single.icp_iters
    for a, b in zip(odom.aux_totals(), port_single.aux_totals()):
        np.testing.assert_array_equal(a, b)

    step = tsh.make_sharded_step(odom.config, mesh)
    state = tpl.init_state(odom.config, "cpu")
    buf = odom.pad_chunk(tiny_scans)
    for i in range(len(tiny_scans)):
        pts, valid, ts = tpl._split_packed(torch.from_numpy(buf[i]))
        state, pose, _, _ = step(state, pts, valid, ts)
        np.testing.assert_array_equal(pose.numpy(), port_single.trajectory()[i])


def test_make_sharded_step_at_a_world_of_one_is_make_step(tiny_scans):
    """make_sharded_step on a world of one without a group is a DeviceStep
    (eager on the CPU), equal to make_step's bit for bit: poses, aux and
    the final state."""
    cfg = port_tiny()
    sharded = tsh.make_sharded_step(cfg, tsh.make_mesh("cpu"))
    assert isinstance(sharded, tpl.DeviceStep) and not sharded.graph and sharded.mesh.group is None
    single = tpl.make_step(cfg, graph=False, device="cpu")
    buf = tpl.SageICP(cfg, device="cpu").pad_chunk(tiny_scans)
    a, b = tpl.init_state(cfg, "cpu"), tpl.init_state(cfg, "cpu")
    for frame in buf:
        inputs = tpl._split_packed(torch.from_numpy(frame))
        a, pa, xa, la = sharded(a, *inputs)
        b, pb, xb, lb = single(b, *inputs)
        assert torch.equal(pa, pb) and torch.equal(la, lb) and all(torch.equal(x, y) for x, y in zip(xa, xb))
    for x, y in zip([*a.map, *tpl._small_fields(a)], [*b.map, *tpl._small_fields(b)]):
        assert (x is None and y is None) or torch.equal(x, y)


def test_graph_steps_refuse_a_gloo_mesh(tiny_scans):
    """gloo copies through the host, which a CUDA graph cannot hold:
    DeviceStep(graph=True) and ShardedSageICP(graph=True) on a gloo mesh
    raise, naming the backend; graph=None captures only on a card over
    NCCL or without a group (Mesh.captures), so ShardedSageICP() on the
    CPU runs its step eagerly."""
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    gloo = tsh.Mesh(size=1, rank=0, group=None, device=cpu, backend="gloo")
    with pytest.raises(ValueError, match="gloo backend"):
        tpl.DeviceStep(port_tiny(), "cpu", graph=True, mesh=gloo)
    with pytest.raises(ValueError, match="gloo backend"):
        tsh.ShardedSageICP(port_tiny(), gloo, graph=True)
    assert [tsh.Mesh(1, 0, None, d, b).captures for d, b in ((card, "nccl"), (card, None), (card, "gloo"),
                                                              (cpu, "gloo"), (cpu, None))] == [
        True, True, False, False, False]
    odom = tsh.ShardedSageICP(port_tiny(), gloo)
    assert odom.graph is False and odom._step.graph is False
    odom.register_frame(tiny_scans[0])
    odom.release()  # no graphs to drop here; the step goes on
    odom.register_frame(tiny_scans[1])
    assert odom.icp_iters[0] == 1 and len(odom.trajectory()) == 2


@pytest.mark.parametrize("shard_insert", [True, False])
def test_sharded_step_routes_rows_to_the_kernels(tiny_scans, monkeypatch, shard_insert):
    """Rank 1 of a two-rank mesh (a test double without a group, whose
    gathers repeat the rank's own rows): the GN wrapper gets 320 of the
    640 rows, the policy wrapper 1,024 of the 2,048, or all of them with
    shard_insert=False."""
    from sage_icp_tpu_torch.ops import nn_kernels, policy_kernel

    seen = {}
    for module, name in ((nn_kernels, "fused_gn_iteration"), (policy_kernel, "apply_policy")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _name=name, **kw: (
            seen.setdefault(_name, []).append(a[0].shape[0]), _fn(*a, **kw))[1])
    class RepeatingMesh(tsh.Mesh):
        def all_gather(self, x):
            return torch.cat([x] * self.size)

    mesh = RepeatingMesh(size=2, rank=1, group=None, device=torch.device("cpu"))
    cfg = tsh.pad_config_for_mesh(port_tiny(), mesh)
    step = tsh.make_sharded_step(cfg, mesh, shard_insert=shard_insert)
    buf = tpl.SageICP(cfg, device="cpu").pad_chunk(tiny_scans[:2])
    state = tpl.init_state(cfg, "cpu")
    for frame in buf:
        state, _, _, _ = step(state, *tpl._split_packed(torch.from_numpy(frame)))
    assert set(seen["fused_gn_iteration"]) == {320}
    assert seen["apply_policy"] == [1024 if shard_insert else 2048] * 2


def test_sharded_step_at_one_rank_equals_sage_icp_on_the_reference_path(tiny_scans, single_runs):
    """ShardedSageICP on a world of one without fast correspondences: the
    reference loop's gathered terms change nothing; trajectory, map,
    iterations and totals equal SageICP's bit for bit."""
    single = single_runs("reference")[0]
    odom = tsh.ShardedSageICP(drive_config("reference"), tsh.make_mesh("cpu"))
    for s in tiny_scans:
        odom.register_frame(s)
    np.testing.assert_array_equal(odom.trajectory(), single.trajectory())
    for a, b in zip(odom.state.map, single.state.map):
        assert (a is None and b is None) or torch.equal(a, b)
    assert odom.icp_iters == single.icp_iters
    for a, b in zip(odom.aux_totals(), single.aux_totals()):
        np.testing.assert_array_equal(a, b)


def test_world_of_one_over_gloo_equals_sage_icp(worker_runs, port_single):
    """One worker process in a gloo group of one: the collectives run and
    change nothing."""
    (rank,) = worker_runs["fast", 1]
    np.testing.assert_array_equal(rank["poses"], port_single.trajectory())
    for name, t in port_single.state.map._asdict().items():
        assert (t is None) == (name not in rank["map"]), name
        if t is not None:
            np.testing.assert_array_equal(rank["map"][name], t.numpy())


def two_ranks_agree(worker_runs, single_runs, name):
    """Two gloo ranks driving DRIVES[name]: equal to each other bit for
    bit, maps slot for slot, within 5e-4 of the port's single device and
    of JAX's SageICP. Returns the two ranks' reports."""
    r0, r1 = worker_runs[name, 2]
    np.testing.assert_array_equal(r0["poses"], r1["poses"])
    assert r0["map"].keys() == r1["map"].keys()
    for key in r0["map"]:
        np.testing.assert_array_equal(r0["map"][key], r1["map"][key])
    assert r0["poses"].shape == (3, 4, 4) and np.isfinite(r0["poses"]).all()
    single, jax_traj = single_runs(name)
    np.testing.assert_allclose(r0["poses"], single.trajectory(), atol=5e-4)
    np.testing.assert_allclose(r0["poses"], jax_traj, atol=5e-4)
    assert r0["report"]["icp_iterations"] == r1["report"]["icp_iterations"]
    assert r0["report"]["aux_totals"] == r1["report"]["aux_totals"]
    return r0["report"], r1["report"]


def gn_slots(rep, rows: str) -> int:
    """The GN wrapper's calls on `rows` rows: BLOCK_ITERATIONS a block, at
    least one block a frame, enough slots for every iteration."""
    slots = rep["kernel_rows"]["fused_gn_iteration"][rows]
    assert slots % BLOCK_ITERATIONS == 0 and slots >= 3 * BLOCK_ITERATIONS
    assert sum(rep["icp_iterations"]) <= slots
    return slots


def test_world_of_one_over_gloo_equals_sage_icp_on_the_reference_path(worker_runs, single_runs):
    """One worker process in a gloo group of one without fast
    correspondences: the reference loop's gather of its terms runs and
    changes nothing; trajectory and map equal SageICP's bit for bit."""
    single = single_runs("reference")[0]
    (rank,) = worker_runs["reference", 1]
    np.testing.assert_array_equal(rank["poses"], single.trajectory())
    for name, t in single.state.map._asdict().items():
        assert (t is None) == (name not in rank["map"]), name
        if t is not None:
            np.testing.assert_array_equal(rank["map"][name], t.numpy())
    assert rank["report"]["icp_iterations"] == single.icp_iters


def test_two_ranks_agree_and_match_single_device(worker_runs, single_runs):
    """Two ranks over gloo on tests/test_parallel.py's tiny config and
    world (the fast path, filter and deskew off): equal to each other bit
    for bit, maps slot for slot; within 5e-4 of the JAX package's
    single-device SageICP and of the port's. Each rank built and ran GN
    on its 320 of the 640 rows in every slot of every block of ICP
    iterations and the policy on its 1,024 of the 2,048 insert rows every
    frame; the radius count never ran (no filter)."""
    for rep in two_ranks_agree(worker_runs, single_runs, "fast"):
        assert rep["kernel_rows"] == {"fused_gn_iteration": {"320": gn_slots(rep, "320")},
                                      "apply_policy": {"1024": 3}, "radius_count": {}}


def test_two_ranks_agree_with_the_filter_and_deskew(worker_runs, single_runs):
    """The same with the dynamic filter and deskew on: each rank deskewed
    and cropped half the scan, pooled its slab of the filter's grid and
    ran the radius count on its 2,048 of the 4,096 query rows every
    frame, besides its GN and policy rows."""
    for rep in two_ranks_agree(worker_runs, single_runs, "filter"):
        assert rep["kernel_rows"] == {"fused_gn_iteration": {"320": gn_slots(rep, "320")},
                                      "apply_policy": {"1024": 3}, "radius_count": {"2048": 3}}


def test_two_ranks_agree_on_the_reference_path(worker_runs, single_runs):
    """The same without fast correspondences: each rank searched its 512
    of the 1,024 sources in every iteration (the reference step kernel
    once an iteration: the launches' count, as on the card, is not kept
    on the CPU) and ran the policy on its 1,024 insert rows; GN never
    ran."""
    for rep in two_ranks_agree(worker_runs, single_runs, "reference"):
        assert rep["kernel_rows"] == {"fused_gn_iteration": {}, "apply_policy": {"1024": 3}, "radius_count": {}}
        assert 3 <= sum(rep["icp_iterations"]) <= 3 * 30


# one rank of the row-sharded insert: the map and the batch from inputs.npz,
# the result to result_<rank>.npz
_INSERT_RANK = """
import sys
import numpy as np
import torch
from sage_icp_tpu_torch.ops import hashmap as hm
from sage_icp_tpu_torch.parallel.distributed import init_distributed

torch.set_num_threads(2)
rank, out = int(sys.argv[1]), sys.argv[2]
mesh = init_distributed("file://" + out + "/rendezvous", 2, rank, backend="gloo", device="cpu", timeout_s=120)
d = np.load(out + "/inputs.npz")
state = hm.MapState(*[torch.from_numpy(d[k]) for k in ("keys", "counts", "points", "first_pts")])
new, stats = hm.insert(state, torch.from_numpy(d["pts"]), torch.from_numpy(d["valid"]), 1.0, 4,
                       torch.from_numpy(d["mask"]), max_incoming_per_voxel=8, probe_depth=16,
                       unique_voxel_capacity=256, mesh=mesh)
np.savez(out + f"/result_{rank}.npz", **{k: v.numpy() for k, v in new._asdict().items() if v is not None},
         stats=np.array([int(s) for s in stats]))
torch.distributed.destroy_process_group()
"""


def test_row_sharded_insert_equals_single_device(tmp_path):
    """A second batch (revisits, label-0 overwrites, more points in one
    voxel than R_max) into a map of 7-point blocks, its 256 compact rows
    split 128 / 128 across two ranks: keys, counts, points, first points
    and the drop counters equal the single-device insert's."""
    rng = np.random.default_rng(11)
    mask = np.zeros(260, bool)
    mask[[40, 44, 48, 49, 50, 70, 72]] = True
    scan = lambda n, s: np.concatenate([rng.uniform(-s, s, (n, 3)), rng.choice([0, 40, 44, 50, 10, 80], (n, 1))],
                                       axis=1).astype(np.float32)
    dense = np.concatenate([np.full((30, 3), 0.5) + rng.normal(0, 0.1, (30, 3)), rng.choice([0, 40, 10], (30, 1))],
                           axis=1).astype(np.float32)
    first, second = scan(400, 6.0), np.concatenate([scan(300, 6.0), dense])
    valid = rng.random(len(second)) < 0.95
    kw = dict(max_incoming_per_voxel=8, probe_depth=16, unique_voxel_capacity=256)
    state, _ = thm.insert(thm.create(1024, 7), torch.from_numpy(first), torch.ones(len(first), dtype=torch.bool),
                          1.0, 4, torch.from_numpy(mask), **kw)
    want, want_stats = thm.insert(state, torch.from_numpy(second), torch.from_numpy(valid), 1.0, 4,
                                  torch.from_numpy(mask), **kw)
    assert len(np.unique(np.trunc(second[valid, :3]), axis=0)) > 128  # both ranks' rows are live
    np.savez(tmp_path / "inputs.npz", **{k: v.numpy() for k, v in state._asdict().items() if v is not None}, pts=second,
             valid=valid, mask=mask)
    spawn([[sys.executable, "-c", _INSERT_RANK, str(r), str(tmp_path)] for r in range(2)])
    for r in range(2):
        got = np.load(tmp_path / f"result_{r}.npz")
        for name, t in want._asdict().items():
            assert (t is None) == (name not in got), name
            if t is not None:
                np.testing.assert_array_equal(got[name], t.numpy(), err_msg=name)
        np.testing.assert_array_equal(got["stats"], [int(s) for s in want_stats])


def test_sharded_insert_refuses_rows_that_do_not_tile():
    """U must be a multiple of 128 n, as in the JAX package."""
    mesh = tsh.Mesh(size=2, rank=0, group=None, device=torch.device("cpu"))
    pts = torch.tensor([[0.5, 0.5, 0.5, 40.0]])
    with pytest.raises(ValueError, match="128-row tiles"):
        thm.insert(thm.create(64, 4), pts, torch.ones(1, dtype=torch.bool), 1.0, 2, torch.zeros(260, dtype=torch.bool),
                   unique_voxel_capacity=128, mesh=mesh)
