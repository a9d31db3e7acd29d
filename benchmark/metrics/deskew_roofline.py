"""deskew_roofline (%, program counter): the scan head's deskew against
its roofline. The least time the window's untraced frames need, over the
device time of their deskew stage (deskew_ms_per_frame's).

A frame's need is the points the program counts as deskewed in it (the
recorder's deskewed_points: the scan's valid rows from the third pose
on, 0 before) times the work of one point at the card's peaks
(arith.least_seconds): the work the deployment asks for, not the padded
rows the program runs over, so a fused kernel is judged on the same work
as the ops it replaces. Which bound holds goes to standard error. None
without a card's peaks, or when a frame's record holds no deskew stage or
no deskewed-point count."""

import sys

from benchmark import arith, recorded

STAGE = "deskew"


def point_bytes() -> int:
    """A point's x, y, z and sensor time read, its x, y, z written (float32)."""
    return 4 * 4 + 3 * 4


def point_flops() -> int:
    """The operations of exp((t - 0.5) delta) p for one point, delta
    given: s = t - 0.5 (1); rho = s delta_rho, phi = s delta_phi (6);
    theta^2 (5); theta = sqrt(theta^2 + eps^2) (2); a, b, c by their
    series in theta^2 (4 each, 12); hat(phi)^2's three distinct
    off-diagonal products and its diagonal (3 + 9); R - I = a K + b K^2
    (6 off-diagonal entries of 3, the diagonal 3: 21); V = I + b K + c K^2
    (6 x 3 + 3 x 2: 24); p + (R - I) p + V rho (3 x 12: 36)."""
    return 1 + 6 + 5 + 2 + 12 + 12 + 21 + 24 + 36


def read(run):
    if run.peaks is None:
        return None
    u = recorded.untraced(run)
    if u is None or any(STAGE not in f.stages_ns or getattr(f, "deskewed_points", None) is None
                        for f in u.frames):
        return None
    points = sum(f.deskewed_points for f in u.frames)
    measured = sum(f.stages_ns[STAGE] for f in u.frames) / 1e9
    if measured <= 0:
        return None
    need, bound = arith.least_seconds(points * point_bytes(), points * point_flops(), run.peaks)
    print(f"deskew_roofline: {points} deskewed points over {len(u.frames)} frames; {need} s needed ({bound} "
          f"bound), {measured} s measured", file=sys.stderr)
    return arith.roofline_percent(need, measured)
