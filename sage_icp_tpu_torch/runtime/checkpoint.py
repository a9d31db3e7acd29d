"""Odometry state checkpoint and resume, in the JAX package's .npz layout.

The reference keeps its state in RAM only. For long sequences and fault
recovery the whole odometry state (the pose history head, the adaptive
threshold's accumulators and the voxel map) round-trips through one .npz
with the trajectory beside it. The file's keys, dtypes and metadata
(probe_depth, dense_grid, hash_layout) are the JAX package's, so a
checkpoint written by either package loads into the other.
"""

from __future__ import annotations

import numpy as np

from sage_icp_tpu_torch.models.pipeline import SageICP
from sage_icp_tpu_torch.models.state_io import state_from_numpy, state_to_numpy
from sage_icp_tpu_torch.ops import hashmap

# .npz key -> the dotted state field of models/state_io
NPZ_FIELDS = {
    "map_keys": "map.keys", "map_counts": "map.counts", "map_points": "map.points",
    "map_first": "map.first_pts", "last_pose": "last_pose", "prev_pose": "prev_pose",
    "first_pose": "first_pose", "num_poses": "num_poses", "reject_streak": "reject_streak",
    "thr_deviation": "threshold.model_deviation", "thr_sse": "threshold.sse",
    "thr_n": "threshold.num_samples",
}


def save_state(path: str, odom: SageICP) -> None:
    state = state_to_numpy(odom.state)
    np.savez_compressed(
        path,
        **{key: state[field] for key, field in NPZ_FIELDS.items()},
        **({"map_grid": state["map.grid"]} if "map.grid" in state else {}),
        trajectory=odom.trajectory(),
        # the layout the map is only valid under: entries are placed by
        # probe distance and by the hash function itself
        probe_depth=np.asarray(odom.config.probe_depth),
        dense_grid=np.asarray(odom.config.dense_grid),
        hash_layout=np.asarray(hashmap.HASH_LAYOUT_VERSION),
    )


def load_state(path: str, odom: SageICP) -> SageICP:
    """Restore a checkpoint into an odometry object built with the same
    config. Raises ValueError, loading nothing, on a file whose map this
    config could not read: another capacity, float block storage, another
    hash layout or probe depth, missing metadata, a dense_grid flag other
    than the config's, or a dense index (map_grid) that the config does
    not keep, lacks, or that is not (GRID_SIZE, 2) int32."""
    with np.load(path) as z:
        if "probe_depth" not in z or "dense_grid" not in z:
            raise ValueError("checkpoint lacks probe_depth/dense_grid metadata; re-save it")
        if z["map_counts"].shape[0] != odom.config.map_capacity:
            raise ValueError(f"checkpoint capacity {z['map_counts'].shape[0]} != config "
                             f"{odom.config.map_capacity}")
        if z["map_points"].dtype != np.int16:
            raise ValueError("checkpoints with float32 block storage are not loadable")
        layout = int(z["hash_layout"]) if "hash_layout" in z else 1
        if layout != hashmap.HASH_LAYOUT_VERSION:
            raise ValueError(f"checkpoint hash layout v{layout} != v{hashmap.HASH_LAYOUT_VERSION}: map slots "
                             "were placed by another hash function and would be unfindable")
        if int(z["probe_depth"]) != odom.config.probe_depth:
            raise ValueError(f"checkpoint probe_depth {int(z['probe_depth'])} != config "
                             f"{odom.config.probe_depth}: deeper entries would be unfindable")
        if bool(z["dense_grid"]) != odom.config.dense_grid:
            raise ValueError(f"checkpoint dense_grid flag {bool(z['dense_grid'])} does not match the loading "
                             f"config's {odom.config.dense_grid}")
        grid = z["map_grid"] if "map_grid" in z else None  # each read of an npz key decompresses it
        if (grid is not None) != odom.config.dense_grid:
            raise ValueError("checkpoint map_grid " + ("present under a config without dense_grid"
                                                       if grid is not None else "missing under dense_grid"))
        if grid is not None and (grid.shape != (hashmap.GRID_SIZE, 2) or grid.dtype != np.int32):
            raise ValueError(f"checkpoint map_grid is {grid.dtype} {grid.shape}, not int32 {(hashmap.GRID_SIZE, 2)}")
        state = {field: z[key] for key, field in NPZ_FIELDS.items() if key in z}
        if grid is not None:
            state["map.grid"] = grid
        state.setdefault("reject_streak", np.int32(0))  # files without the guard streak
        trajectory = list(z["trajectory"])
    odom.reinitialize()
    odom.state = state_from_numpy(state, odom.device)
    odom.poses = trajectory
    return odom
