"""Odometry state to and from flat dicts of numpy arrays.

Keys are the dotted field paths of OdomState ("map.keys",
"threshold.sse", "last_pose", ...), the same paths as the JAX reference
package's OdomState, so a state can cross between the two packages (and
to disk) as plain numpy arrays. "map.grid" is there only when the map
keeps a dense index.
"""

from __future__ import annotations

import numpy as np
import torch

from sage_icp_tpu_torch.models.pipeline import OdomState, ThresholdState
from sage_icp_tpu_torch.ops.hashmap import MapState

_DTYPES = {
    "map.keys": torch.int32, "map.counts": torch.int32, "map.points": torch.int16,
    "map.first_pts": torch.float32, "last_pose": torch.float32, "prev_pose": torch.float32,
    "first_pose": torch.float32, "num_poses": torch.int32,
    "threshold.model_deviation": torch.float32, "threshold.sse": torch.float32,
    "threshold.num_samples": torch.int32, "reject_streak": torch.int32,
}


def state_to_numpy(state) -> dict:
    """Flatten an OdomState (tensors of this package, or any NamedTuple
    tree of array-likes with the same field names) into numpy arrays.
    None leaves are skipped."""
    out = {}

    def walk(node, prefix):
        for name, leaf in zip(node._fields, node):
            key = prefix + name
            if leaf is None:
                continue
            if hasattr(leaf, "_fields"):
                walk(leaf, key + ".")
            elif torch.is_tensor(leaf):
                out[key] = leaf.detach().to("cpu", copy=True).numpy()  # a snapshot: steps update in place
            else:
                out[key] = np.asarray(leaf)

    walk(state, "")
    return out


def state_from_numpy(d: dict, device) -> OdomState:
    """Inverse of state_to_numpy: every leaf becomes a tensor on device;
    the map has no dense index when "map.grid" is absent."""
    t = {k: torch.as_tensor(np.array(d[k]), dtype=dt).to(device) for k, dt in _DTYPES.items()}
    grid = torch.as_tensor(np.array(d["map.grid"]), dtype=torch.int32).to(device) if "map.grid" in d else None
    return OdomState(
        map=MapState(keys=t["map.keys"], counts=t["map.counts"], points=t["map.points"],
                     first_pts=t["map.first_pts"], grid=grid),
        last_pose=t["last_pose"], prev_pose=t["prev_pose"], first_pose=t["first_pose"],
        num_poses=t["num_poses"],
        threshold=ThresholdState(t["threshold.model_deviation"], t["threshold.sse"],
                                 t["threshold.num_samples"]),
        reject_streak=t["reject_streak"],
    )
