"""Multi-GPU execution: the step's per-point work split across the ranks
of a torch.distributed process group.

The JAX package runs its step SPMD over a device mesh, the scan's point
axis partitioned, and lets GSPMD insert the collectives. Here every rank
is one process on one device. Each splits the per-point stages into
contiguous shares in rank order (Mesh.row_range), and the results that
the next stage needs whole are all-gathered in rank order
(Mesh.gather_rows: one collective; a share that does not tile is padded
to ceil(rows / n) rows of dead work, dropped after the gather):

  * the scan head, with deskew on: deskew and the crop of its
    scan_capacity / n points, then the cropped scan gathered
    (models/pipeline.py::scan_head); without deskew the crop alone costs
    less than the gather and stays whole (PERF.md);
  * the dynamic filter: the 24 min-pooling rounds on its x-slab of the
    grid plus a 24-plane halo, and the landmark lookup, candidate planes
    and radius_count kernel of its VR / n query rows; the component grid
    and the counts gathered (ops/dynamic_filter.py);
  * the correspondence rows: the neighbour probe and the candidate-plane
    gathers of its R / n rows (correspondence_fast.corr_setup's `rows`),
    on which it runs the fused GN kernel; the (18,) sums are gathered as
    an (n, 18) buffer and added in rank order on the device
    (ops/registration.py::IcpLoop);
  * or, without fast correspondences, the reference search and the
    normal equations of its N / n sources, their terms gathered and added
    in rank order (ops/registration.py::RefLoop);
  * the insert's retention policy on its U / n compact rows, the updated
    rows gathered for the replicated write-back (ops/hashmap.py).

The global decisions stay whole on every rank, so every rank numbers rows
and points alike and ends with the same state: the downsample's stable
sorts, the filter's class sorts, landmark table and verdict, corr_setup's
seats, the 6x6 solves, the map and its write-back. Every split but the
two sums is exact, so the state is the unsharded step's bit for bit
except for the order in which the ranks' GN or normal-equation sums are
added; with one rank it equals the single-device step bit for bit. The
step is the device-resident DeviceStep (models/pipeline.py), as the JAX
package's sharded step is a jitted, donated program: over NCCL on the
card it is captured as CUDA graphs, the collectives inside them; over
gloo (which copies through the host) and on the CPU it runs eagerly.
"""

from __future__ import annotations

import dataclasses

import torch

from sage_icp_tpu_torch.models import pipeline as pl
from sage_icp_tpu_torch.ops.constants import device_constant
from sage_icp_tpu_torch.parallel.distributed import init_distributed  # noqa: F401  (re-export)

POINTS_AXIS = "points"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the process group: `size` ranks, this one
    `rank`, on `device`, its collectives over `backend`
    (dist.get_backend(group)). group None is a world of one without a
    process group (no collective runs; backend None)."""

    size: int
    rank: int
    group: object
    device: torch.device
    backend: str | None = None

    @property
    def shape(self) -> dict:
        return {POINTS_AXIS: self.size}

    def row_range(self, n_rows: int) -> tuple[int, int]:
        """This rank's contiguous share [lo, hi) of n_rows rows."""
        return self.rank * n_rows // self.size, (self.rank + 1) * n_rows // self.size

    def pad_share(self, x: torch.Tensor, lo: int, hi: int, n_rows: int) -> torch.Tensor:
        """Rows [lo, hi) of x, padded to the largest share of n_rows,
        ceil(n_rows / size), with copies of row hi - 1 (dead work, dropped
        by gather_rows): a view when the share needs no padding."""
        c = -(-n_rows // self.size)
        if hi - lo == c:
            return x[lo:hi]
        idx = torch.arange(lo, lo + c, device=x.device).clamp_(max=hi - 1)
        return x[idx]

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's share of x's rows (row_range), padded as pad_share
        pads it."""
        return self.pad_share(x, *self.row_range(x.shape[0]), x.shape[0])

    def gather_rows(self, x: torch.Tensor, n_rows: int) -> torch.Tensor:
        """The inverse of local_rows: every rank's padded share (c, ...) ->
        the n_rows real rows (n_rows, ...) in rank order, on every rank."""
        out = self.all_gather(x)
        c = x.shape[0]
        if c * self.size == n_rows:
            return out
        # rank r's share holds row_range's (r + 1) n / size - r n / size real rows
        keep = [r * c + i for r in range(self.size)
                for i in range((r + 1) * n_rows // self.size - r * n_rows // self.size)]
        return out[device_constant(keep, torch.int64, out.device)]

    @property
    def captures(self) -> bool:
        """Whether a step on this mesh is captured as CUDA graphs by
        default: on a card, with NCCL's collectives (or none)."""
        return self.device.type == "cuda" and self.backend in (None, "nccl")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(m, ...) on every rank -> (size * m, ...), the ranks' rows in
        rank order, on every rank: one collective into one output, which
        a CUDA graph can hold (over NCCL)."""
        if self.group is None:
            return x
        import torch.distributed as dist

        out = torch.empty((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
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
                    device=pl.resolve_device(device), backend=dist.get_backend())
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


def make_sharded_step(config: pl.SageConfig, mesh: Mesh, donate: bool = True, shard_insert: bool = True):
    """step(state, points, valid, timestamps) -> (state, pose, aux,
    landmark_cells_dropped) (pipeline.odometry_step's) with the GN rows
    split across the mesh and, with shard_insert, the policy rows too
    (False keeps the insert replicated on every rank): a DeviceStep on
    the mesh's device, captured when the mesh captures (Mesh.captures),
    the state donated unless donate=False (make_step's rule)."""
    return pl.DeviceStep(config, mesh.device, graph=mesh.captures, packed=False, mesh=mesh,
                         shard_insert=shard_insert, donate=donate)


class ShardedSageICP(pl.SageICP):
    """SageICP whose step is the sharded step on `mesh` (default:
    make_mesh()), with the configuration padded for it. graph=None
    captures the step as CUDA graphs on the card over NCCL (or in a world
    without a group) and runs it eagerly on the CPU or over gloo, whose
    host copies a graph cannot hold; graph=True there raises. Call
    release() before destroy_process_group: NCCL's communicator waits
    for the graphs that hold its kernels."""

    def __init__(self, config: pl.SageConfig | str = "kitti", mesh: Mesh | None = None, graph: bool | None = None):
        if isinstance(config, str):
            config = pl.PRESETS[config]
        if mesh is None:
            mesh = make_mesh()
        super().__init__(pad_config_for_mesh(config, mesh), device=mesh.device,
                         graph=mesh.captures if graph is None else graph, mesh=mesh)
