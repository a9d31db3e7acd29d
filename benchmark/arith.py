"""The benchmark's arithmetic: percentiles over frames, the table of the
card's peaks, and the bytes and operations a kernel's launch needs.

The GN kernel's count is chip_smoke.py's (phase 3's bound): a running
launch reads each live row's four int16 candidate planes (M lanes each),
its P query slots (4 floats), its voxel origin (3 floats), its absolute
voxel (3 ints) and its P used flags once, the three lane-offset planes
and the tile map once, and writes the 18 sums; it computes
M (6 + 10 P) operations a live row. A live row is one with a used query
slot. A launch that finds the loop stopped needs nothing, so it adds time
and no bytes."""

from __future__ import annotations

import math

import numpy as np

# published peaks, dense, at the card's full power limit (NVIDIA's data
# sheet): HBM bytes per second and float32 operations per second outside
# the tensor cores; matched against torch.cuda.get_device_name()
PEAKS = {"H100": dict(bytes_per_s=3.35e12, f32_flops=67e12)}


def peaks(device_name: str) -> dict | None:
    return next((v for k, v in PEAKS.items() if k in device_name), None)


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (numpy's linear rule)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def gn_launch_bytes(live_rows: int, R: int, P: int, M: int) -> int:
    return (live_rows * (4 * M * 2 + 4 * P * 4 + 3 * 4 + 3 * 4 + P * 4) + 3 * M * 4
            + math.ceil(R / 128) * 4 + 18 * 4)


def gn_launch_flops(live_rows: int, P: int, M: int) -> int:
    return live_rows * M * (6 + 10 * P)


def least_seconds(n_bytes: float, n_flops: float, peak: dict) -> tuple[float, str]:
    """The least time the card could take, and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / peak["bytes_per_s"], n_flops / peak["f32_flops"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_percent(least_s: float, measured_s: float) -> float:
    """The share of its roofline, in %. A share above 105 % means the work
    was counted too high or the time misses part of it: that is raised,
    never clamped."""
    share = 100.0 * least_s / measured_s
    if share > 105.0:
        raise ValueError(f"roofline share {share:.1f} % is above 105 %: the bytes or operations are counted too "
                         f"high, or the measured time misses part of the work ({least_s} s needed, "
                         f"{measured_s} s measured)")
    return share
