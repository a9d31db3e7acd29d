"""Deterministic synthetic semantic-LiDAR world for tests and benchmarks
(numpy only; the same worlds, trajectories and scans, seed for seed, as
the JAX reference package's utils/synthetic.py).

No KITTI data ships with this environment, so integration tests and
bench.py drive the odometry with a procedurally generated urban scene:
a road corridor with sidewalks/parking strips, building walls, poles and
parked vehicles, all labeled with semantic-KITTI ids. Scans are rendered
by range-windowing the static world from a moving sensor pose with
distance-dependent thinning and Gaussian range noise — structurally close
to what the reference's eval publishers feed the odometry
(reference eval/kitti_pub.py:340-482 replays real KITTI the same way:
points + labels + ground-truth poses).
"""

from __future__ import annotations

import numpy as np

# semantic-KITTI ids (reference ros/launch/semantic-kitti.yaml)
ROAD, PARKING, SIDEWALK = 40, 44, 48
BUILDING, FENCE = 50, 51
VEGETATION, TRUNK = 70, 71
POLE, TRAFFIC_SIGN = 80, 81
CAR = 10
UNLABELED = 0


def build_world(
    seed: int = 0,
    length: float = 300.0,
    half_width: float = 14.0,
    density: float = 1.0,
):
    """Returns (points (M,3) f32, labels (M,) int32). World frame: road
    along +x, z up, sensor height ~1.8 m above road. density > 1 shrinks
    every surface's sampling step so the per-frame downsampled point count
    matches denser real-sensor data (KITTI steady state ~40-60k points
    after the 0.5x class downsample needs density ~2)."""
    rng = np.random.default_rng(seed)
    pts, labs = [], []
    inv_d = 1.0 / float(density)

    def grid(x0, x1, y0, y1, z, step, label, jitter=0.03, zjit=0.02):
        step = step * inv_d
        xs = np.arange(x0, x1, step)
        ys = np.arange(y0, y1, step)
        X, Y = np.meshgrid(xs, ys)
        n = X.size
        p = np.stack(
            [
                X.ravel() + rng.normal(0, jitter, n),
                Y.ravel() + rng.normal(0, jitter, n),
                np.full(n, z) + rng.normal(0, zjit, n),
            ],
            axis=1,
        )
        pts.append(p)
        labs.append(np.full(n, label, dtype=np.int32))

    def wall(x0, x1, y, z0, z1, step, label, jitter=0.03):
        step = step * inv_d
        xs = np.arange(x0, x1, step)
        zs = np.arange(z0, z1, step)
        X, Z = np.meshgrid(xs, zs)
        n = X.size
        p = np.stack(
            [
                X.ravel() + rng.normal(0, jitter, n),
                np.full(n, y) + rng.normal(0, jitter, n),
                Z.ravel(),
            ],
            axis=1,
        )
        pts.append(p)
        labs.append(np.full(n, label, dtype=np.int32))

    # road surface + parking strips + sidewalks
    grid(-20, length + 20, -4.0, 4.0, 0.0, 0.35, ROAD)
    grid(-20, length + 20, 4.0, 6.0, 0.0, 0.35, PARKING)
    grid(-20, length + 20, -6.0, -4.0, 0.0, 0.35, PARKING)
    grid(-20, length + 20, 6.0, 8.5, 0.12, 0.35, SIDEWALK)
    grid(-20, length + 20, -8.5, -6.0, 0.12, 0.35, SIDEWALK)

    # building facades with gaps (cross streets every ~60 m)
    for x0 in np.arange(-20, length + 20, 60.0):
        wall(x0, x0 + 45.0, 9.5, 0.0, 7.0, 0.4, BUILDING)
        wall(x0 + 5.0, x0 + 50.0, -9.5, 0.0, 6.0, 0.4, BUILDING)

    # poles + signs along the sidewalk
    for x in np.arange(0, length, 25.0):
        for side in (7.2, -7.2):
            zs = np.arange(0, 4.0, 0.12)
            n = len(zs)
            p = np.stack(
                [
                    np.full(n, x) + rng.normal(0, 0.01, n),
                    np.full(n, side) + rng.normal(0, 0.01, n),
                    zs,
                ],
                axis=1,
            )
            pts.append(p)
            labs.append(np.full(n, POLE, dtype=np.int32))

    # vegetation patches
    for x in np.arange(12, length, 40.0):
        n = 300
        p = np.stack(
            [
                x + rng.normal(0, 1.2, n),
                -7.0 + rng.normal(0, 0.8, n),
                1.5 + rng.normal(0, 0.9, n),
            ],
            axis=1,
        )
        pts.append(p)
        labs.append(np.full(n, VEGETATION, dtype=np.int32))

    # parked cars on the parking strips (boxes of CAR points)
    for x in np.arange(8, length, 30.0):
        for side in (4.9, -4.9):
            grid(x, x + 4.2, side - 0.85, side + 0.85, 0.8, 0.22, CAR)
            wall(x, x + 4.2, side - 0.85, 0.2, 1.4, 0.25, CAR)

    # street clutter: signs, small boxes, fences — gives the ICP tangential
    # (along-road) structure like real urban scans have
    for x in np.arange(3, length, 11.0):
        side = 6.8 if (int(x) % 2 == 0) else -6.8
        n = 120
        p = np.stack(
            [
                x + rng.uniform(-0.4, 0.4, n),
                side + rng.uniform(-0.4, 0.4, n),
                rng.uniform(0.0, 1.6, n),
            ],
            axis=1,
        )
        pts.append(p)
        labs.append(np.full(n, TRAFFIC_SIGN, dtype=np.int32))
    # low fences crossing partial segments (x-structure)
    for x0 in np.arange(15, length, 45.0):
        wall_y = np.arange(6.0, 8.5, 0.25)
        zs = np.arange(0.0, 1.2, 0.2)
        Y, Z = np.meshgrid(wall_y, zs)
        n = Y.size
        p = np.stack(
            [np.full(n, x0) + rng.normal(0, 0.02, n), Y.ravel(), Z.ravel()],
            axis=1,
        )
        pts.append(p)
        labs.append(np.full(n, FENCE, dtype=np.int32))

    points = np.concatenate(pts).astype(np.float32)
    labels = np.concatenate(labs)
    return points, labels


def build_city_world(
    seed: int = 0,
    size: float = 420.0,
    block: float = 60.0,
    density: float = 1.0,
):
    """Manhattan-grid city: roads every `block` meters in both axes with
    sidewalk borders, building slabs filling the blocks, poles at corners.
    Unlike the corridor world (build_world), surfaces cover the FULL
    local-map disc, so the live map under the 100 m cull reaches the
    50-100k-voxel KITTI steady state (reference map scale,
    core/VoxelHashMap.cpp:176-184) instead of underfilling it. Returns
    (points (M, 3) f32, labels (M,) i32).

    The road grid is CENTERED ON THE ORIGIN: road centerlines run along
    x=0/y=0 (and every `block` meters outward), so test/bench trajectories
    that start at the origin and drive along an axis (make_trajectory,
    make_maneuver_trajectory) travel on actual road surface with building
    facades flanking them — like the KITTI drives the reference replays.
    Through round 3 the edges were anchored at -size/2 instead, which put
    NO road at y=0: the bench vehicle drove through building-block
    interiors (no ground beneath it) and pierced a solid facade wall at
    x=22.5 — the reference-exact correspondence search diverges on that
    unphysical workload exactly like the fast path (scripts/bench_debug.py
    REPRO_MODE=nofast, round-4 bisect; see docs/ARCHITECTURE.md)."""
    rng = np.random.default_rng(seed)
    pts, labs = [], []
    inv_d = 1.0 / float(density)
    half = size / 2.0

    def slab(x0, x1, y0, y1, z, step, label, jitter=0.03, zjit=0.02):
        step = step * inv_d
        xs = np.arange(x0, x1, step)
        ys = np.arange(y0, y1, step)
        if len(xs) == 0 or len(ys) == 0:
            return
        X, Y = np.meshgrid(xs, ys)
        n = X.size
        p = np.stack(
            [
                X.ravel() + rng.normal(0, jitter, n),
                Y.ravel() + rng.normal(0, jitter, n),
                np.full(n, z) + rng.normal(0, zjit, n),
            ],
            axis=1,
        )
        pts.append(p)
        labs.append(np.full(n, label, dtype=np.int32))

    # Facade relief: real building fronts are NOT smooth planes — window
    # reveals / pilasters give them structure ALONG the wall. Without it a
    # block-long facade constrains only its normal direction and point-to-
    # point ICP can slide along the street canyon (the corridor-world
    # degeneracy all over again — round-4 bisect: the reference-exact
    # search diverges mid-canyon exactly like the fast path). TWO scales:
    # 3 m window bays 0.4 m deep (coarse basin: captures ~0.2 m errors)
    # plus 0.75 m panel texture at +-0.1 m (sills/frames/drainpipes: a
    # dense fine-scale gradient) — the point-to-point forward-constraint
    # basin is roughly HALF the smallest structure scale, so a smooth or
    # single-scale facade leaves the solve nothing to re-lock onto once
    # the constant-velocity guess is a few cm off (round-4 force probes).
    def _relief(along, z):
        bay = 0.4 * (((np.floor(along / 3.0) + np.floor(z / 2.6)) % 2.0))
        cell = np.floor(along / 0.75) * 7.0 + np.floor(z / 0.75) * 13.0
        panel = 0.1 * np.sin(cell * 2.399963)  # deterministic, aperiodic
        return bay + panel

    def wall_x(x0, x1, y, z1, step, label, sign=1.0):
        step = step * inv_d
        xs = np.arange(x0, x1, step)
        zs = np.arange(0.0, z1, step)
        if len(xs) == 0 or len(zs) == 0:
            return
        X, Z = np.meshgrid(xs, zs)
        n = X.size
        yy = y + sign * _relief(X.ravel(), Z.ravel())
        p = np.stack(
            [X.ravel(), yy + rng.normal(0, 0.03, n), Z.ravel()],
            axis=1,
        )
        pts.append(p)
        labs.append(np.full(n, BUILDING, dtype=np.int32))

    def wall_y(y0, y1, x, z1, step, label, sign=1.0):
        step = step * inv_d
        ys = np.arange(y0, y1, step)
        zs = np.arange(0.0, z1, step)
        if len(ys) == 0 or len(zs) == 0:
            return
        Y, Z = np.meshgrid(ys, zs)
        n = Y.size
        xx = x + sign * _relief(Y.ravel(), Z.ravel())
        p = np.stack(
            [xx + rng.normal(0, 0.03, n), Y.ravel(), Z.ravel()],
            axis=1,
        )
        pts.append(p)
        labs.append(np.full(n, BUILDING, dtype=np.int32))

    def parked_car(cx, cy, along_x=True):
        """A car-sized box (roof + 4 sides) — unlike a floating roof slab,
        its vertical faces anchor the along-road direction."""
        L, W, H = 4.2, 1.7, 1.45
        dx, dy = (L, W) if along_x else (W, L)
        x0, x1 = cx - dx / 2, cx + dx / 2
        y0, y1 = cy - dy / 2, cy + dy / 2
        step = 0.22 * inv_d
        slab(x0, x1, y0, y1, H, 0.22, CAR, jitter=0.02, zjit=0.02)
        zs = np.arange(0.25, H, step)
        for yy, xs in ((y0, None), (y1, None)):
            xv = np.arange(x0, x1, step)
            X, Z = np.meshgrid(xv, zs)
            n = X.size
            if n:
                pts.append(np.stack(
                    [X.ravel(), np.full(n, yy) + rng.normal(0, 0.02, n),
                     Z.ravel()], axis=1))
                labs.append(np.full(n, CAR, dtype=np.int32))
        for xx in (x0, x1):
            yv = np.arange(y0, y1, step)
            Y, Z = np.meshgrid(yv, zs)
            n = Y.size
            if n:
                pts.append(np.stack(
                    [np.full(n, xx) + rng.normal(0, 0.02, n), Y.ravel(),
                     Z.ravel()], axis=1))
                labs.append(np.full(n, CAR, dtype=np.int32))

    def tree(cx, cy):
        """Street tree: trunk points + a canopy blob — the classic
        high-information landmark in urban LiDAR."""
        zs = np.arange(0.0, 2.6, 0.13 * inv_d)
        n = len(zs)
        if n:
            pts.append(np.stack(
                [np.full(n, cx) + rng.normal(0, 0.02, n),
                 np.full(n, cy) + rng.normal(0, 0.02, n), zs], axis=1))
            labs.append(np.full(n, TRUNK, dtype=np.int32))
        m = max(int(60 / inv_d**2), 15)
        pts.append(np.stack(
            [cx + rng.normal(0, 0.9, m), cy + rng.normal(0, 0.9, m),
             3.4 + rng.normal(0, 0.7, m)], axis=1))
        labs.append(np.full(m, VEGETATION, dtype=np.int32))

    road_half = 5.0
    walk = 2.5
    # road centerlines at 0, +-block, +-2*block, ... (origin-centered grid)
    n_edges = int(half // block)
    edges = np.arange(-n_edges, n_edges + 1, dtype=np.float64) * block
    # road strips (both axes) + sidewalks alongside
    for e in edges:
        slab(-half, half, e - road_half, e + road_half, 0.0, 0.5, ROAD)
        slab(e - road_half, e + road_half, -half, half, 0.0, 0.5, ROAD)
        slab(-half, half, e + road_half, e + road_half + walk, 0.12, 0.5,
             SIDEWALK)
        slab(-half, half, e - road_half - walk, e - road_half, 0.12, 0.5,
             SIDEWALK)
    # building blocks: slab roofs omitted, 4 facade walls + interior ground
    inner = road_half + walk
    for bx in edges[:-1]:
        for by in edges[:-1]:
            x0, x1 = bx + inner, bx + block - inner
            y0, y1 = by + inner, by + block - inner
            if x1 - x0 < 4 or y1 - y0 < 4:
                continue
            h = 5.0 + (rng.integers(0, 4)) * 2.0
            # relief recesses point INTO the block (away from the street)
            wall_x(x0, x1, y0, h, 0.5, BUILDING, sign=1.0)
            wall_x(x0, x1, y1, h, 0.5, BUILDING, sign=-1.0)
            wall_y(y0, y1, x0, h, 0.5, BUILDING, sign=1.0)
            wall_y(y0, y1, x1, h, 0.5, BUILDING, sign=-1.0)
            # sparse vegetation inside the block (visible over low walls)
            n = 150
            p = np.stack(
                [
                    rng.uniform(x0, x1, n),
                    rng.uniform(y0, y1, n),
                    h + rng.uniform(0.0, 2.0, n),
                ],
                axis=1,
            )
            pts.append(p)
            labs.append(np.full(n, VEGETATION, dtype=np.int32))
    # street furniture along every road — poles, parked cars (full boxes,
    # alternating sides), sidewalk trees. These are the continuous along-
    # road landmarks real urban LiDAR has; without them the street canyons
    # between intersections are forward/yaw-degenerate for point-to-point
    # ICP (round-4 finding, docs/ARCHITECTURE.md).
    for e in edges:
        for x in np.arange(-half + 10, half, 35.0):
            zs = np.arange(0, 4.0, 0.12)
            n = len(zs)
            p = np.stack(
                [
                    np.full(n, x) + rng.normal(0, 0.01, n),
                    np.full(n, e + road_half + 0.5),
                    zs,
                ],
                axis=1,
            )
            pts.append(p)
            labs.append(np.full(n, POLE, dtype=np.int32))
        for i, x in enumerate(np.arange(-half + 9.0, half - 4.0, 13.0)):
            parked_car(x, e + (4.1 if i % 2 == 0 else -4.1), along_x=True)
        for i, y in enumerate(np.arange(-half + 9.0, half - 4.0, 13.0)):
            parked_car(e + (4.1 if i % 2 == 1 else -4.1), y, along_x=False)
        for i, x in enumerate(np.arange(-half + 5.0, half, 16.0)):
            tree(x, e + (6.9 if i % 2 == 0 else -6.9))
        for i, y in enumerate(np.arange(-half + 5.0, half, 16.0)):
            tree(e + (6.9 if i % 2 == 1 else -6.9), y)
        # sidewalk clutter: bins / hydrants / steps — small boxes every
        # ~9 m; with the cars and trees these are the continuous near-
        # field 3D anchors that pin the along-road DoF in real urban
        # scans (TRAFFIC_SIGN label: a critical retention class)
        for i, x in enumerate(np.arange(-half + 3.0, half, 9.0)):
            side = 6.3 if i % 3 != 1 else -6.3
            w = 0.4 + 0.3 * ((i * 7) % 3)
            h = 0.6 + 0.25 * ((i * 5) % 4)
            slab(x, x + w, e + side - w / 2, e + side + w / 2, h, 0.15,
                 TRAFFIC_SIGN, jitter=0.02)
            zs = np.arange(0.1, h, 0.15 * inv_d)
            xv = np.arange(x, x + w, 0.15 * inv_d)
            if len(zs) and len(xv):
                X, Z = np.meshgrid(xv, zs)
                m = X.size
                pts.append(np.stack(
                    [X.ravel(),
                     np.full(m, e + side - w / 2) + rng.normal(0, 0.02, m),
                     Z.ravel()], axis=1))
                labs.append(np.full(m, TRAFFIC_SIGN, dtype=np.int32))
        for i, y in enumerate(np.arange(-half + 3.0, half, 9.0)):
            side = 6.3 if i % 3 != 2 else -6.3
            w = 0.4 + 0.3 * ((i * 7) % 3)
            h = 0.6 + 0.25 * ((i * 5) % 4)
            slab(e + side - w / 2, e + side + w / 2, y, y + w, h, 0.15,
                 TRAFFIC_SIGN, jitter=0.02)
            zs = np.arange(0.1, h, 0.15 * inv_d)
            yv = np.arange(y, y + w, 0.15 * inv_d)
            if len(zs) and len(yv):
                Y, Z = np.meshgrid(yv, zs)
                m = Y.size
                pts.append(np.stack(
                    [np.full(m, e + side - w / 2) + rng.normal(0, 0.02, m),
                     Y.ravel(), Z.ravel()], axis=1))
                labs.append(np.full(m, TRAFFIC_SIGN, dtype=np.int32))
    points = np.concatenate(pts).astype(np.float32)
    labels = np.concatenate(labs)
    return points, labels


def make_trajectory(
    n_frames: int,
    step: float = 1.0,
    curve: float = 0.0005,
    accel_frames: int = 6,
    jitter: float = 0.0,
    seed: int = 7,
):
    """Ground-truth 4x4 poses: accelerate from standstill to `step` m/frame
    over `accel_frames` (like a real drive — the constant-velocity
    prediction then keeps the ICP initial guess close), then cruise with a
    gentle yaw curve. Sensor at z = 1.8. The default curve keeps the
    vehicle inside its 5 m road half-width for ~130 frames on the origin-
    centered city grid (y ~= curve/2 * x^2): a lane-keeping drift, not a
    lane departure.

    jitter > 0 adds low-passed speed/yaw-rate perturbations (traffic,
    road texture) scaled by `jitter` in m/frame — a perfectly constant-
    velocity drive is OUT OF DOMAIN for the reference's AdaptiveThreshold
    (Threshold.cpp:39-50 accumulates only model deviations > min_motion_th
    = 0.1 m, so a clean cruise freezes sigma at whatever the acceleration
    phase left; real drives keep feeding it)."""
    rng = np.random.default_rng(seed)
    poses = []
    x, y, yaw = 0.0, 0.0, 0.0
    dv, yd = 0.0, 0.0
    for i in range(n_frames):
        hdg = yaw + yd  # heading = nominal course + transient wobble
        c, s = np.cos(hdg), np.sin(hdg)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, 3] = [x, y, 1.8]
        poses.append(T.copy())
        v = step * min(1.0, (i + 1) / max(accel_frames, 1))
        if jitter > 0.0:
            # speed: low-passed surge (traffic/throttle); heading: mean-
            # reverting wobble (steering corrections) — it does NOT
            # integrate into the course, so the vehicle keeps its lane.
            # At jitter=0.1 the constant-velocity prediction error is
            # ~0.1-0.3 m/frame translation + ~0.1 deg/frame heading —
            # the 10 Hz deviation scale of a real drive.
            dv = 0.6 * dv + rng.normal(0.0, jitter)
            yd = 0.8 * yd + rng.normal(0.0, 0.02 * jitter)
            v = max(v + dv, 0.0)
        x += v * np.cos(hdg)
        y += v * np.sin(hdg)
        yaw += curve * v
    return np.stack(poses)


def make_maneuver_trajectory(
    straight: int = 10,
    turn: int = 8,
    stop: int = 3,
    reverse: int = 6,
    step: float = 1.0,
    turn_deg: float = 90.0,
    start=(-20.0, 0.0),
):
    """Hard trajectory: straight -> sharp turn -> full stop -> reverse.
    Exercises the adaptive threshold (stop/go), the constant-velocity
    prediction under model violation (sharp yaw, reversal), and map
    revisiting after the cull (reverse). Sensor at z = 1.8."""
    poses = []
    x, y = float(start[0]), float(start[1])
    yaw = 0.0

    def emit():
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, 3] = [x, y, 1.8]
        poses.append(T.copy())

    for _ in range(straight):
        emit()
        x += step * np.cos(yaw)
        y += step * np.sin(yaw)
    dyaw = np.deg2rad(turn_deg) / max(turn, 1)
    for _ in range(turn):
        emit()
        yaw += dyaw
        x += step * np.cos(yaw)
        y += step * np.sin(yaw)
    for _ in range(stop):
        emit()
    for _ in range(reverse):
        emit()
        x -= step * np.cos(yaw)
        y -= step * np.sin(yaw)
    emit()
    return np.stack(poses)


def skew_scan(scan: np.ndarray, delta_twist: np.ndarray, timestamps: np.ndarray) -> np.ndarray:
    """Apply intra-scan motion distortion to a rendered (mid-pose) scan:
    the point seen at sweep phase t was observed from the pose
    exp((t - 0.5) * delta) relative to mid-scan, so the raw measurement is
    exp((t - 0.5) * delta)^-1 p, which deskew inverts (reference
    core/Deskew.cpp:36-50). delta_twist (6,) = log(per-frame motion);
    timestamps (n,) in [0, 1]. The exponential runs in float32 torch on
    the CPU (the package's geometry), the transform in numpy."""
    import torch

    from sage_icp_tpu_torch.ops import geometry as geo

    scaled = (-(timestamps - 0.5))[:, None] * delta_twist[None, :]
    T = geo.se3_exp(torch.as_tensor(scaled, dtype=torch.float32)).numpy()
    xyz = np.einsum("nij,nj->ni", T[:, :3, :3], scan[:, :3]) + T[:, :3, 3]
    out = scan.copy()
    out[:, :3] = xyz.astype(np.float32)
    return out


def render_scan(
    world_pts: np.ndarray,
    world_labels: np.ndarray,
    pose: np.ndarray,
    rng: np.random.Generator,
    max_range: float = 70.0,
    n_target: int = 30_000,
    noise: float = 0.01,
    moving_obstacle: np.ndarray | None = None,
):
    """Render one labeled scan in the sensor frame: window the world by
    range, thin with ~1/r density, add noise. Returns (n, 4) float32."""
    Rinv = pose[:3, :3].T
    tinv = -Rinv @ pose[:3, 3]
    local = world_pts @ Rinv.T + tinv
    r = np.linalg.norm(local, axis=1)
    sel = (r < max_range) & (r > 1.0)
    local, labs, r = local[sel], world_labels[sel], r[sel]
    # Distance thinning, drawn FRESH per frame and SURFACE-AWARE — both
    # properties were round-4 divergence root causes:
    #
    # * Fresh draws: through round 3 the draw was a persistent hash of
    #   the world-point index ("stable returns"), so ~98% of a frame's
    #   far-field points had their EXACT same point in the map, inserted
    #   one frame earlier at THAT frame's pose error — a momentum term
    #   that constrains the solve to yesterday's error instead of the
    #   world. Real spinning LiDAR never hits the same physical point
    #   twice.
    # * Surface-aware falloff: a uniform (12/r)^1.2 keep probability
    #   made EVERY surface sparse at range, and the resulting radial
    #   density gradient biases far-field NN assignments inward (toward
    #   the vehicle) — under any forward pose error the behind-field
    #   bias points forward, the gating asymmetry nets a pull that
    #   TRACKS the error, and the constant-velocity prediction ratchets
    #   it a few cm per frame into divergence (scripts/force_probe.py
    #   decomposition at the f016 onset). A real scanner's angular
    #   spacings both grow ~linearly with range on VERTICAL structure
    #   (area density ~ 1/r^2, walls stay dense to ~50 m+), while only
    #   GROUND fades fast (grazing incidence, ~ 1/r^3) — so real far
    #   fields keep dense vertical anchors exactly where this model now
    #   puts them.
    u = rng.random(len(r))
    rs = np.maximum(r, 1e-3)
    ground = np.isin(labs, (ROAD, PARKING, SIDEWALK))
    p = np.where(
        ground,
        np.minimum(1.0, (18.0 / rs) ** 3),
        np.minimum(1.0, (40.0 / rs) ** 2),
    )
    keep = u < p
    local, labs = local[keep], labs[keep]
    if len(local) > n_target:
        idx = rng.choice(len(local), n_target, replace=False)
        local, labs = local[idx], labs[idx]
    local = local + rng.normal(0, noise, local.shape)
    scan = np.concatenate(
        [local.astype(np.float32), labs[:, None].astype(np.float32)], axis=1
    )
    if moving_obstacle is not None:
        scan = np.concatenate([scan, moving_obstacle.astype(np.float32)], axis=0)
    return scan


def moving_car_points(offset_x: float, rng: np.random.Generator, n: int = 400) -> np.ndarray:
    """A CAR-labelled box in the sensor frame (a vehicle driving ahead),
    exercise for the dynamic-vehicle filter."""
    x = offset_x + rng.uniform(0, 4.0, n)
    y = rng.uniform(-0.9, 0.9, n)
    z = rng.uniform(0.2, 1.5, n)
    lab = np.full(n, CAR, dtype=np.float32)
    return np.stack([x, y, z, lab], axis=1).astype(np.float32)
