"""Multi-process initialisation on torch.distributed.

    from sage_icp_tpu_torch.parallel.distributed import init_distributed
    mesh = init_distributed()   # under torchrun: RANK, WORLD_SIZE, LOCAL_RANK
    odom = ShardedSageICP("kitti", mesh)

Each process drives one card (cuda:LOCAL_RANK) and receives the whole
scan; the ranks split its per-point work and the insert's policy rows
between them (parallel/sharding.py). The backend is NCCL on the card; gloo runs
only when the caller names it (a CPU run, or ranks sharing one card,
which NCCL refuses). Every process group has a finite timeout, so a rank
that stops taking part in the collectives fails the others instead of
hanging them.
"""

from __future__ import annotations

import datetime
import os

import torch

DEFAULT_TIMEOUT_S = 300.0


def _env_int(name: str, value):
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass it as an argument or run under torchrun")
    return int(os.environ[name])


def init_distributed(init_method: str | None = None, world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None, device=None, timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the process group and return this rank's Mesh.

    world_size and rank default to torchrun's WORLD_SIZE and RANK;
    init_method to "env://" (torchrun's MASTER_ADDR / MASTER_PORT).
    device defaults to the card cuda:LOCAL_RANK (LOCAL_RANK defaults to
    the rank; "cuda" without an index means the same), which becomes the
    current device; ranks that share a card name it ("cuda:0"); "cpu"
    runs on the host.
    backend defaults to "nccl", which needs a CUDA device: gloo is never
    chosen in its place."""
    import torch.distributed as dist

    from sage_icp_tpu_torch.models.pipeline import resolve_device
    from sage_icp_tpu_torch.parallel.sharding import Mesh

    world_size = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = resolve_device(device)
    backend = "nccl" if backend is None else backend
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, got {device}: pass backend='gloo' for the CPU")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(size=world_size, rank=rank, group=dist.group.WORLD, device=device, backend=dist.get_backend())
