"""Multi-GPU execution: the step's two kernels split their rows across
the ranks of a torch.distributed process group.

The JAX package runs its step SPMD over a device mesh and lets GSPMD
insert the collectives. Here every rank is one process on one device
that runs the whole step on the whole scan (preprocess, filter,
downsample, the correspondence-row setup and the map stay replicated)
and shares out the work of the two kernels on the step:

  * the GN iteration: each rank runs the fused GN kernel on its
    contiguous slice of the frozen correspondence rows; the (18,) sums
    are all-gathered as an (n, 18) buffer and added in rank order on
    the host, the same on every rank, so every rank solves the same 6x6
    system and takes the same loop decisions (ops/registration.py);
  * the insert's retention policy: each rank runs the policy kernel on
    its U/n compact rows and the updated rows are all-gathered for the
    replicated write-back. Rows are independent, so the result is
    exactly the single-device insert (ops/hashmap.py).

With one rank the step equals the single-device step bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from sage_icp_tpu_torch.models import pipeline as pl
from sage_icp_tpu_torch.parallel.distributed import init_distributed  # noqa: F401  (re-export)

POINTS_AXIS = "points"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the process group: `size` ranks, this one
    `rank`, on `device`. group None is a world of one without a process
    group (no collective runs)."""

    size: int
    rank: int
    group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        return {POINTS_AXIS: self.size}

    def row_range(self, n_rows: int) -> tuple[int, int]:
        """This rank's contiguous share [lo, hi) of n_rows rows."""
        return self.rank * n_rows // self.size, (self.rank + 1) * n_rows // self.size

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(m, ...) on every rank -> (size * m, ...), the ranks' rows in
        rank order, on every rank."""
        if self.group is None:
            return x
        import torch.distributed as dist

        out = torch.empty((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather(list(out.chunk(self.size)), x.contiguous(), group=self.group)
        return out


def make_mesh(device=None) -> Mesh:
    """The initialised process group's mesh on `device` (default: the
    current card); without one, a world of one on `device` (default: the
    card)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", torch.cuda.current_device())
        return Mesh(size=dist.get_world_size(), rank=dist.get_rank(), group=dist.group.WORLD,
                    device=pl.resolve_device(device))
    return Mesh(size=1, rank=0, group=None, device=pl.resolve_device(device))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_config_for_mesh(config: pl.SageConfig, mesh: Mesh) -> pl.SageConfig:
    """The JAX package's capacities for a mesh of n: scan and source
    capacity a multiple of n; frame capacity and the insert's unique rows
    a multiple of 128 * n (128-row policy tiles on every rank; the
    pipeline clips the unique rows to the frame capacity)."""
    n = mesh.shape[POINTS_AXIS]
    return dataclasses.replace(
        config,
        scan_capacity=_round_up(config.scan_capacity, n),
        frame_capacity=_round_up(config.frame_capacity, 128 * n),
        source_capacity=_round_up(config.source_capacity, n),
        insert_unique_capacity=_round_up(config.insert_unique_capacity, 128 * n),
    )


def make_sharded_step(config: pl.SageConfig, mesh: Mesh, shard_insert: bool = True):
    """step(state, points, valid, timestamps) -> (state, pose, aux,
    landmark_cells_dropped) (pipeline.odometry_step's) with
    the GN rows split across the mesh and, with shard_insert, the policy
    rows too (False keeps the insert replicated on every rank)."""
    return functools.partial(pl.odometry_step, config=config, mesh=mesh, shard_insert=shard_insert)


class ShardedSageICP(pl.SageICP):
    """SageICP whose step is the sharded step on `mesh` (default:
    make_mesh()), with the configuration padded for it."""

    def __init__(self, config: pl.SageConfig | str = "kitti", mesh: Mesh | None = None):
        if isinstance(config, str):
            config = pl.PRESETS[config]
        if mesh is None:
            mesh = make_mesh()
        super().__init__(pad_config_for_mesh(config, mesh), device=mesh.device)
        self.mesh = mesh
