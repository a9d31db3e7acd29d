"""SageICP's staging buffer (models/pipeline.py): pad_chunk writes its
scans into a host buffer of the SageICP's own, one for each chunk length,
rewriting only the rows that change, and returns that buffer. Held here
against the fresh buffer a call that pad_chunk built before (`fresh_pad`,
kept as it was), byte for byte, over runs of calls whose scans grow and
shrink; the recorder's staging counts; and the trajectories SageICP steps
from the staging buffer against chunk_step's on the fresh pads, bit for
bit.
This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from sage_icp_tpu_torch.datasets.kitti import azimuth_timestamps
from sage_icp_tpu_torch.models import pipeline as tpl
from sage_icp_tpu_torch.ops import scan as tscan
from sage_icp_tpu_torch.runtime import tracing
from sage_icp_tpu_torch.utils import synthetic
from tests.test_torch_cuda import TINY_CONFIG

# scan rows of each call, slot by slot: growing, shrinking, empty, past the capacity
RUNS = {1: [[900], [2500], [40], [0], [5000], [1200]],
        3: [[100, 2000, 50], [3000, 10, 700], [5000, 0, 1200], [5, 5, 4096], [2500, 2500, 2500]]}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module (see tests/test_torch_runtime.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fresh_pad(cfg, scans, timestamps=None) -> np.ndarray:
    """pad_chunk as it was before the staging buffer: a fresh buffer of the
    sentinel a call, each scan's rows (and time lane) copied in."""
    cap = cfg.scan_capacity
    lanes = 5 if cfg.deskew else 4
    if cfg.quantized_scan_upload:
        buf = np.full((len(scans), cap, lanes), tpl.QSCAN_INVALID, dtype=np.int16)
    else:
        buf = np.full((len(scans), cap, lanes), tscan.INVALID_COORD, dtype=np.float32)
    for i, s in enumerate(scans):
        n = min(len(s), cap)
        rows = np.asarray(s[:n, :4], dtype=np.float32)
        if lanes == 5:
            ts = timestamps[i] if timestamps is not None else None
            ts = azimuth_timestamps(rows[:, :3]) if ts is None else ts[:n]
            rows = np.concatenate([rows, np.asarray(ts, np.float32)[:, None]], axis=1)
        if cfg.quantized_scan_upload:
            tpl._quantize_scan_host(rows, buf[i])
        else:
            buf[i, :n] = rows
    return buf


def random_scan(rng, n, dtype):
    """n rows of xyz within 60 m and a label, float32 or float64."""
    xyz = rng.uniform(-60.0, 60.0, (n, 3))
    return np.concatenate([xyz, rng.integers(0, 260, (n, 1))], axis=1).astype(dtype)


def config(deskew=False, quantized=False):
    return tpl.SageConfig(**TINY_CONFIG, deskew=deskew, quantized_scan_upload=quantized)


@pytest.mark.parametrize("times", ["given", None])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("deskew", [False, True])
@pytest.mark.parametrize("W", [1, 3])
def test_staging_buffer_equals_a_fresh_pad_byte_for_byte(W, deskew, quantized, times):
    """Each call's buffer equals the fresh pad of its scans byte for byte,
    while the scans of each slot grow and shrink (float32 and float64 rows,
    float32 and float64 times; rows past the capacity cut)."""
    cfg = config(deskew, quantized)
    odom = tpl.SageICP(cfg, device="cpu")
    rng = np.random.default_rng(W + 2 * deskew + 4 * quantized)
    for k, sizes in enumerate(RUNS[W]):
        scans = [random_scan(rng, n, np.float32 if (k + i) % 2 else np.float64) for i, n in enumerate(sizes)]
        stamps = None if times is None else [rng.random(n).astype(np.float64 if k % 2 else np.float32)
                                             for n in sizes]
        got = odom.pad_chunk(scans, stamps)
        want = fresh_pad(cfg, scans, stamps)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.tobytes() == want.tobytes(), f"call {k}"


def test_the_next_call_overwrites_the_buffer():
    """pad_chunk hands back the SageICP's own buffer for W scans: the next
    call of W scans writes into it, a call of another W into its own."""
    cfg = config()
    odom = tpl.SageICP(cfg, device="cpu")
    rng = np.random.default_rng(0)
    first = [random_scan(rng, n, np.float32) for n in (3000, 200)]
    second = [random_scan(rng, n, np.float32) for n in (100, 2500)]
    a = odom.pad_chunk(first)
    kept = a.copy()
    b = odom.pad_chunk(second)
    assert np.shares_memory(a, b)
    assert a.tobytes() == fresh_pad(cfg, second).tobytes() != kept.tobytes()
    one = odom.pad_chunk(first[:1])
    assert not np.shares_memory(one, a) and b.tobytes() == fresh_pad(cfg, second).tobytes()
    assert odom.pad_chunk(first).tobytes() == kept.tobytes()


CHUNKS = ((0, 3), (3, 5))


def chunk_step_on_fresh_pads(cfg, scans, stamps):
    """chunk_step (tests/test_torch_device_step.py holds make_chunk_step to
    it bit for bit) over each chunk's fresh pad: the poses, the per-frame
    iterations and the totals over both chunks."""
    state, poses, iters, totals = tpl.init_state(cfg, "cpu"), [], [], None
    for lo, hi in CHUNKS:
        buf = torch.from_numpy(fresh_pad(cfg, scans[lo:hi], None if stamps is None else stamps[lo:hi]))
        state, p, it, agg, _ = tpl.chunk_step(state, buf, cfg)
        poses.append(p)
        iters.append(it)
        totals = tpl._fold_aux(totals, agg)
    return torch.cat(poses).numpy(), torch.cat(iters).numpy(), [a.numpy() for a in totals]


@pytest.fixture(scope="module")
def drives():
    """Five frames of a small city drive stepped three ways on the CPU,
    deskew off and on (the drive's own point times): SageICP's
    register_frame, SageICP's register_chunk on lists of scans (chunks of
    3 and 2), and chunk_step on each chunk's fresh pad; {deskew: (the two
    SageICPs, chunk_step's poses, iterations and totals, the scans, the
    recorder's snapshot)}."""
    world = synthetic.build_city_world(seed=0, size=160.0, density=0.5)
    gt = synthetic.make_trajectory(5, step=1.0)
    rng = np.random.default_rng(0)
    scans = [synthetic.render_scan(*world, gt[i], rng, n_target=3000, max_range=60.0) for i in range(5)]
    stamps = [azimuth_timestamps(s[:, :3]).astype(np.float32) for s in scans]
    out = {}
    for deskew in (False, True):
        cfg = config(deskew)
        ts = stamps if deskew else None
        per_frame = tpl.SageICP(cfg, device="cpu")  # each drives before the next is made: the recorder's drive
        for k, s in enumerate(scans):
            per_frame.register_frame(s, None if ts is None else ts[k])
        chunked = tpl.SageICP(cfg, device="cpu")
        for lo, hi in CHUNKS:
            chunked.register_chunk(scans[lo:hi], None if ts is None else ts[lo:hi])
        out[deskew] = (per_frame, chunked), chunk_step_on_fresh_pads(cfg, scans, ts), scans, tracing.RECORDER.read()
    return out


@pytest.mark.parametrize("deskew", [False, True])
def test_trajectories_from_the_staging_buffer_equal_the_fresh_pads(drives, deskew):
    """register_frame and register_chunk from the staging buffer step the
    same poses, iterations and totals, bit for bit, as chunk_step on the
    fresh pads."""
    sageicps, (poses, iters, totals), _, _ = drives[deskew]
    assert len(poses) == 5 and np.isfinite(poses).all()
    for odom in sageicps:
        np.testing.assert_array_equal(odom.trajectory(), poses)
        np.testing.assert_array_equal(odom.iteration_counts(), iters)
        for a, b in zip(odom.aux_totals(), totals):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("deskew", [False, True])
def test_the_recorder_counts_rows_staged_and_buffers_made(drives, deskew):
    """Each frame of register_frame counts its scan's rows and a chunk's
    first frame the chunk's rows; one buffer is made for each chunk length
    (1, 3, 2), at its first call, and none after."""
    (per_frame, chunked), _, scans, snap = drives[deskew]
    cap = per_frame.config.scan_capacity
    rows = [min(len(s), cap) for s in scans]
    frames = snap.frames_of([per_frame.drive])
    assert [f.staged_rows for f in frames] == rows
    assert [f.staging_buffers for f in frames] == [1, 0, 0, 0, 0]
    frames = snap.frames_of([chunked.drive])
    assert [f.staged_rows for f in frames] == [sum(rows[:3]), 0, 0, sum(rows[3:]), 0]
    assert [f.staging_buffers for f in frames] == [1, 0, 0, 1, 0]
