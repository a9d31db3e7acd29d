"""Bitonic sort over key/payload planes: the CUDA kernel
(csrc/bitonic_sort.cu) and its plain PyTorch version.

Replaces the TPU kernel sage_icp_tpu/ops/pallas_sort.py::
bitonic_sort_planes, with its interface: a tuple of (N,) planes of 32-bit
words, N a power of two >= 256; the first num_keys planes are keys
compared lexicographically, the rest move with them as payload. Keys are
int32 tensors; a uint32 key is passed as its int32 view with its flag in
`unsigned` set (PyTorch's uint32 support is partial). Payload planes may
be any 32-bit dtype.

Contract: every composite key must be distinct; append an iota plane as
the last key. Under it the network yields the stable-sort permutation,
which the plain version computes with successive stable sorts. With equal
composite keys the network (here as on the TPU) copies one element over
its tied partner instead of exchanging them, so the plain version and the
kernel differ there. bitonic_network_plain runs the network itself, stage
by stage, and equals the kernel and the TPU kernel even on tied keys; the
tests and chip_smoke.py hold the kernel against both.

The port's own sorts are torch.sort(stable=True), as the JAX package's
are lax.sort; this kernel is held against them by chip_smoke.py on the
dynamic filter's sort keys.
"""

from __future__ import annotations

import ctypes

import torch

from sage_icp_tpu_torch.ops import cuda_lib

MIN_N = 256
MAX_PLANES = 16  # csrc/bitonic_sort.cu kMaxPlanes

_I = ctypes.c_int
_V = ctypes.c_void_p
_ARGTYPES = [_V, _V, _V, _V, _I, _I, _I, _V, _V]


def _check(planes, num_keys: int, unsigned) -> tuple:
    n = planes[0].shape[0]
    if n < MIN_N or n & (n - 1):
        raise ValueError(f"N must be a power of two >= {MIN_N}, got {n}")
    if not 1 <= num_keys <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{num_keys} keys of {len(planes)} planes; at most {MAX_PLANES} planes")
    for i, p in enumerate(planes):
        if p.dim() != 1 or p.shape[0] != n or p.element_size() != 4:
            raise ValueError(f"plane {i}: expected ({n},) of 32-bit words, got {tuple(p.shape)} {p.dtype}")
        if i < num_keys and p.dtype != torch.int32:
            raise ValueError(f"key plane {i}: expected int32 (a uint32 key as its int32 view), got {p.dtype}")
    unsigned = tuple(bool(u) for u in (unsigned or (False,) * num_keys))
    if len(unsigned) != num_keys:
        raise ValueError(f"{len(unsigned)} unsigned flags for {num_keys} keys")
    return unsigned


def bitonic_sort_planes(planes, num_keys: int, unsigned=None):
    """Sort the planes lexicographically by the first num_keys; `unsigned`
    (one flag per key, default all False) marks uint32 keys. Returns the
    sorted planes as new tensors; the inputs are not written."""
    planes = tuple(planes)
    unsigned = _check(planes, num_keys, unsigned)
    if cuda_lib.on_cpu(planes[0]):
        return bitonic_sort_planes_plain(planes, num_keys, unsigned)
    n = planes[0].shape[0]
    dev = planes[0].device
    for i, p in enumerate(planes):
        cuda_lib.check_cuda(f"plane {i}", p, p.dtype, (n,))
        if p.device != dev:
            raise ValueError(f"plane {i} is on {p.device}, plane 0 on {dev}")
    outs = tuple(torch.empty_like(p) for p in planes)
    state = torch.empty(((num_keys + 1) * n,), dtype=torch.int32, device=dev)  # keys and source
    ins = (_V * len(planes))(*[p.data_ptr() for p in planes])
    ptrs = (_V * len(outs))(*[o.data_ptr() for o in outs])
    flags = (ctypes.c_int * num_keys)(*unsigned)
    fn = cuda_lib.function("bitonic_sort.cu", "sage_bitonic_sort", _ARGTYPES)
    cuda_lib.call(
        "bitonic_sort_planes", fn, dev,
        ctypes.cast(ins, _V), ctypes.cast(ptrs, _V), cuda_lib.ptr(state), ctypes.cast(flags, _V),
        len(planes), num_keys, n,
    )
    return outs


def bitonic_launches(n: int, num_keys: int) -> int:
    """CUDA launches one call on the card makes (0: refused)."""
    return cuda_lib.function("bitonic_sort.cu", "sage_bitonic_launches", [_I, _I])(n, num_keys)


def bitonic_sort_planes_plain(planes, num_keys: int, unsigned):
    """Lexicographic stable sort: stable passes from the last key to the
    first, uint32 keys widened to int64."""
    perm = torch.arange(planes[0].shape[0], device=planes[0].device)
    for k in reversed(range(num_keys)):
        key = planes[k].to(torch.int64)
        if unsigned[k]:
            key = key & 0xFFFFFFFF
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return tuple(p[perm] for p in planes)


def bitonic_network_plain(planes, num_keys: int, unsigned=None):
    """The bitonic network itself, vectorised: every (k, j) stage of
    pallas_sort._stage_table, each element deciding on its own whether to
    take its partner i ^ j (the per-side take rule). Equals the kernel and
    the TPU kernel bit for bit, tied composite keys included."""
    planes = tuple(planes)
    unsigned = _check(planes, num_keys, unsigned)
    n = planes[0].shape[0]
    idx = torch.arange(n, device=planes[0].device)
    # uint32 keys compare as int32 with the sign bit flipped
    flip = [-(2**31) if u else 0 for u in unsigned]
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            partner = idx ^ j
            moved = tuple(p[partner] for p in planes)
            lt = torch.zeros(n, dtype=torch.bool, device=idx.device)  # partner < self
            eq = torch.ones(n, dtype=torch.bool, device=idx.device)
            for kk in range(num_keys):
                a = moved[kk] ^ flip[kk]
                b = planes[kk] ^ flip[kk]
                lt = lt | (eq & (a < b))
                eq = eq & (a == b)
            want_min = ((idx & k) == 0) == ((idx & j) == 0)
            take = torch.where(want_min, lt, ~lt)
            planes = tuple(torch.where(take, m, p) for m, p in zip(moved, planes))
            j //= 2
        k *= 2
    return planes
