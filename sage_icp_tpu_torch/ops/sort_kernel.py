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
kernel differ there.

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

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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
    sorted planes as new tensors."""
    planes = tuple(planes)
    unsigned = _check(planes, num_keys, unsigned)
    if cuda_lib.on_cpu(planes[0]):
        return bitonic_sort_planes_plain(planes, num_keys, unsigned)
    n = planes[0].shape[0]
    for i, p in enumerate(planes):
        cuda_lib.check_cuda(f"plane {i}", p, p.dtype, (n,))
    outs = tuple(p.clone() for p in planes)  # sorted in place
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    flags = (ctypes.c_int * num_keys)(*unsigned)
    fn = cuda_lib.function("bitonic_sort.cu", "sage_bitonic_sort", _ARGTYPES)
    cuda_lib.call(
        "bitonic_sort_planes", fn,
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(flags, ctypes.c_void_p),
        len(outs), num_keys, n, cuda_lib.stream_ptr(planes[0].device),
    )
    return outs


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
