"""Voxel-block retention policy: the CUDA kernel (csrc/retention_policy.cu)
and its plain PyTorch version.

Replaces the TPU kernel sage_icp_tpu/ops/pallas_insert.py::apply_policy.
For every touched voxel row the incoming points of this frame are
replayed in scan order, ranks r < seglen, through the reference's
VoxelBlock::AddPoint:

  count < basic            -> append
  class 0 (label 0)        -> drop
  class 1 (basic label)    -> overwrite the first live label-0 slot
  class 2 (critical label) -> append while count < K, else overwrite the
                              first live label-0 slot

Inputs (hashmap.insert builds them):
  bx, by, bz, bl  (U, K) int16  block planes, quantized voxel-local + label
  counts, seglen  (U, 1) int32  seglen clipped to R_max, 0 = inactive row
  ix, iy, iz, ie  (U, R_max) int16  incoming ranks; ie = label | cls << 12
Returns (bx', by', bz', bl', counts'). Integers only: the kernel and the
plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from sage_icp_tpu_torch.ops import cuda_lib

CLS_SHIFT = 12
LABEL_MASK = (1 << CLS_SHIFT) - 1
MAX_K = 64  # the kernel keeps each row's zero-live slots in a 64-bit mask
MAX_R = 64  # and stages a tile's incoming classes in shared memory

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7


def apply_policy(bx, by, bz, bl, counts, seglen, ix, iy, iz, ie, basic: int):
    if cuda_lib.on_cpu(bx):
        return apply_policy_plain(bx, by, bz, bl, counts, seglen, ix, iy, iz, ie, basic)
    U, K = bx.shape
    Rmax = ix.shape[1]
    if not (1 <= K <= MAX_K and 1 <= Rmax <= MAX_R):
        raise ValueError(f"apply_policy: K = {K}, R_max = {Rmax}; the kernel takes 1..{MAX_K} and 1..{MAX_R}")
    for name, t in (("bx", bx), ("by", by), ("bz", bz), ("bl", bl)):
        cuda_lib.check_cuda(name, t, torch.int16, (U, K))
    for name, t in (("counts", counts), ("seglen", seglen)):
        cuda_lib.check_cuda(name, t, torch.int32, (U, 1))
    for name, t in (("ix", ix), ("iy", iy), ("iz", iz), ("ie", ie)):
        cuda_lib.check_cuda(name, t, torch.int16, (U, Rmax))
    outs = [torch.empty_like(bx) for _ in range(4)] + [torch.empty_like(counts)]
    fn = cuda_lib.function("retention_policy.cu", "sage_retention_policy", _ARGTYPES)
    p = cuda_lib.ptr
    cuda_lib.call(
        "apply_policy", fn, bx.device,
        p(bx), p(by), p(bz), p(bl), p(counts), p(seglen), p(ix), p(iy), p(iz), p(ie),
        U, K, Rmax, basic, *[p(o) for o in outs],
    )
    return tuple(outs)


def apply_policy_plain(bx, by, bz, bl, counts, seglen, ix, iy, iz, ie, basic: int):
    """Round r applies rank r of every row at once (sequential per row,
    vectorized across rows), as the reference's while_loop policy does.
    All R_max rounds run (a round past every row's seglen changes
    nothing): the host reads nothing."""
    U, K = bx.shape
    kidx = torch.arange(K, device=bx.device)[None, :]
    ox, oy, oz, ol = bx.clone(), by.clone(), bz.clone(), bl.clone()
    cnt = counts[:, 0].clone()
    seg = seglen[:, 0]
    zero_live = (bl == 0) & (kidx < cnt[:, None])
    for r in range(ix.shape[1]):
        act = r < seg
        enc = ie[:, r].to(torch.int32)
        cls = enc >> CLS_SHIFT
        lab = enc & LABEL_MASK
        has_zero = zero_live.any(dim=1)
        first_zero = torch.argmax(zero_live.to(torch.int32), dim=1)
        append_basic = cnt < basic
        overwrite_b = ~append_basic & (cls == 1)
        append_crit = ~append_basic & (cls == 2) & (cnt < K)
        overwrite_c = ~append_basic & (cls == 2) & (cnt >= K)
        do_append = act & (append_basic | append_crit)
        do_over = act & (overwrite_b | overwrite_c) & has_zero
        target = torch.where(do_append, cnt, first_zero)
        sel = (do_append | do_over)[:, None] & (kidx == target[:, None])
        ox = torch.where(sel, ix[:, r : r + 1], ox)
        oy = torch.where(sel, iy[:, r : r + 1], oy)
        oz = torch.where(sel, iz[:, r : r + 1], oz)
        ol = torch.where(sel, lab.to(torch.int16)[:, None], ol)
        zero_live = torch.where(sel, (lab == 0)[:, None], zero_live)
        cnt = cnt + do_append.to(torch.int32)
    return ox, oy, oz, ol, cnt[:, None]
