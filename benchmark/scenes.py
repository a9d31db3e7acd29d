"""The scenes of the benchmark: a synthetic city, a drive through it and
the labelled scans a sensor on that drive would return, all made from the
run's seed.

build_city_world and make_trajectory are copies of the port's
utils/synthetic.py (numpy), kept here so that a change to the program
cannot change the traffic. render_drives renders the scans of several
drives along one trajectory on the device: the range window, the
surface-aware distance thinning, the cut to n_target points and the range
noise of synthetic.render_scan, with the random draws from a torch
generator seeded by the run's seed (the same seed gives the same scans on
the same card and software), each drive its own draws. The scans come
back to the host as (n, 4) float32 rows [x y z label], as the KITTI
format hands them over.

A scene with "sweep": true makes each scan a spinning sensor's: the scan
rendered at the frame's pose as above, with the same draws, then moved
point by point to where a sensor sweeping through the frame's motion
measured it (sweep_scans), each point's sweep phase kept as its time.
cell_scenes renders a configuration's scene either way.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.deskew import azimuth_phase, deskew

# semantic-KITTI ids (upstream ros/launch/semantic-kitti.yaml)
ROAD, PARKING, SIDEWALK = 40, 44, 48
BUILDING, FENCE = 50, 51
VEGETATION, TRUNK = 70, 71
POLE, TRAFFIC_SIGN = 80, 81
CAR = 10
UNLABELED = 0


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


def render_drives(world_pts: np.ndarray, world_labels: np.ndarray, poses: np.ndarray, seed: int, n_drives: int,
                  n_target: int, max_range: float, noise: float, device) -> list:
    """n_drives drives along `poses`, each its own draws of the sensor's
    returns: [drive][frame] -> (n, 4) float32 [x y z label], sensor frame.
    A scan holds the world points within (1, max_range) m, kept with
    probability min(1, (18 / r)^3) on the ground (road, parking, sidewalk)
    and min(1, (40 / r)^2) elsewhere, cut to n_target in a random order,
    plus Gaussian noise of `noise` m on each coordinate (render_scan's
    model). The draws come from one torch generator seeded with `seed`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % 2**63)
    world = torch.from_numpy(np.asarray(world_pts, dtype=np.float32)).to(dev, torch.float64)
    labels = torch.from_numpy(np.asarray(world_labels, dtype=np.int32)).to(dev)
    ground = (labels == ROAD) | (labels == PARKING) | (labels == SIDEWALK)
    drives = [[] for _ in range(n_drives)]
    for pose in poses:
        Rinv = torch.from_numpy(pose[:3, :3].T.copy()).to(dev, torch.float64)
        tinv = torch.from_numpy(-pose[:3, :3].T @ pose[:3, 3]).to(dev, torch.float64)
        local = world @ Rinv.T + tinv
        r = torch.linalg.vector_norm(local, dim=1)
        sel = torch.nonzero((r < max_range) & (r > 1.0))[:, 0]
        local, labs, r = local[sel], labels[sel], torch.clamp(r[sel], min=1e-3)
        p = torch.where(ground[sel], torch.clamp((18.0 / r) ** 3, max=1.0), torch.clamp((40.0 / r) ** 2, max=1.0))
        for drive in drives:
            keep = torch.nonzero(torch.rand(len(r), generator=gen, dtype=torch.float64, device=dev) < p)[:, 0]
            if len(keep) > n_target:
                keep = keep[torch.randperm(len(keep), generator=gen, device=dev)[:n_target]]
            xyz = local[keep] + noise * torch.randn((len(keep), 3), generator=gen, dtype=torch.float64, device=dev)
            drive.append(torch.cat([xyz.to(torch.float32), labs[keep].to(torch.float32)[:, None]], dim=1))
    return [[s.cpu().numpy() for s in drive] for drive in drives]


def sweep_scans(scans: list, poses: np.ndarray, device) -> tuple:
    """A drive's mid-sweep scans [frame] -> (n, 4) float32, as a sensor
    that sweeps through each frame's motion at constant velocity measures
    them. The HDL-64E spins clockwise, so a point's sweep phase is
    t = (pi - atan2(y, x)) / (2 pi) (KISS-ICP's KITTI loader's convention),
    and it was measured from the pose exp((t - 0.5) delta_k) relative to
    mid-sweep, delta_k = log(poses[k-1]^-1 poses[k]) (0 for the first
    frame): its raw coordinates are exp((0.5 - t) delta_k) p, the
    reference's deskew with the two poses swapped, here in float64 on
    `device` (the model of the port's utils/synthetic.skew_scan). Draws
    nothing. Returns (raw scans, times [frame] -> (n,) float32 t)."""
    raw, times = [], []
    for k, scan in enumerate(scans):
        t = azimuth_phase(scan[:, :3])
        finish = torch.from_numpy(poses[k]).to(device, torch.float64)
        start = torch.from_numpy(poses[max(k - 1, 0)]).to(device, torch.float64)
        moved = deskew(torch.from_numpy(scan).to(device, torch.float64), t.to(device), finish, start)
        raw.append(moved.to(torch.float32).cpu().numpy())
        times.append(t.numpy())
    return raw, times


def cell_scenes(config: dict, seed: int, n_drives: int, device):
    """A configuration's scene: (its ground-truth poses, n_drives drives
    rendered from `seed`, their point times, or None where the scene has
    no "sweep")."""
    scene = config["scene"]
    pts, labels = build_city_world(seed=scene["world_seed"], size=scene["world_size"], block=scene["block"],
                                   density=scene["density"])
    gt = make_trajectory(config["drive_frames"], step=scene["step_m"])
    drives = render_drives(pts, labels, gt, seed, n_drives, scene["points_target"], scene["max_range"],
                           scene["noise"], device)
    if not scene.get("sweep", False):
        return gt, drives, None
    swept = [sweep_scans(drive, gt, device) for drive in drives]
    return gt, [d for d, _ in swept], [t for _, t in swept]
