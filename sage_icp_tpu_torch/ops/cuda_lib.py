"""Build and load the hand-written Hopper kernels of sage_icp_tpu_torch.

Each source in csrc/ is compiled by nvcc for sm_90a into its own shared
library with a plain C interface, under build/torch_kernels/ at the repo
root, at first use; the sources are compiled in parallel. A library's
file name carries a hash of its sources and flags, so an edited kernel is
rebuilt and an unchanged one is reused. Entry points are bound with
ctypes: every pointer and the stream are c_void_p, and each entry point
returns cudaGetLastError() of its launch, which `call` turns into an
exception.

Launches are counted on the device: every wrapper passes its kernel a
pointer to the kernel's own 64-bit counter on the launching device, and
the kernel adds one when it runs (csrc/launch_count.cuh). A launch
replayed from a captured CUDA graph (models/pipeline.py) is therefore
counted as one made from the host, and a capture, which runs nothing,
counts nothing. A run zeroes the counters with `reset_launches` and
reads them with `launches()` to show which kernels a path ran. A wrapper
launches on the current stream of its tensors' device, which must be
the current device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("semantic_nn.cu", "gn_iteration.cu", "retention_policy.cu", "radius_count.cu", "bitonic_sort.cu",
           "icp_step.cu", "stage_clock.cu", "min_diffusion.cu", "corr_planes.cu")

# --fmad=false: no contraction of a*b+c into an FMA, so distances round
# exactly as in the plain PyTorch versions (a near-tie would otherwise
# flip the first-minimum winner). No fast math: IEEE division and sqrt.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("fused_semantic_nn", "fused_gn_iteration", "apply_policy", "radius_count", "bitonic_sort_planes",
           "icp_step", "icp_ref_step", "stage_clock", "min_diffusion", "corr_planes")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_counters: dict = {}  # device -> (len(KERNELS),) int64 launch counters on it
BUILD_LOG: dict[str, str] = {}  # source -> nvcc/ptxas output of its build


def _counter(kernel: str, device) -> ctypes.c_void_p:
    """The address of `kernel`'s launch counter on `device`. The counters
    are made at a device's first launch, which must not be inside a
    capture (the graph would own them)."""
    import torch

    if device not in _counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the launch counters are made at a device's first launch, not during a capture")
        _counters[device] = torch.zeros((len(KERNELS),), dtype=torch.int64, device=device)
    c = _counters[device]
    return ctypes.c_void_p(c.data_ptr() + KERNELS.index(kernel) * c.element_size())


def reset_launches() -> None:
    """Zero every launch counter (in stream order on each device)."""
    for c in _counters.values():
        c.zero_()


def launches() -> dict[str, int]:
    """Kernel launches since reset_launches, summed over this process's
    devices: one host read per device, after the launches' streams."""
    total = dict.fromkeys(KERNELS, 0)
    for c in _counters.values():
        for k, v in zip(KERNELS, c.tolist()):
            total[k] += v
    return total


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _lib_path(source: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all at once.
    Returns the seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in SOURCES:
        out = _lib_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[src] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(source: str, name: str, argtypes) -> object:
    """The C entry point `name` of csrc/<source>, built on first use."""
    key = (source, name)
    if key not in _fns:
        if source not in _libs:
            path = _lib_path(source)
            if not path.exists():
                build_all()
            _libs[source] = ctypes.CDLL(str(path))
        fn = getattr(_libs[source], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def call(kernel: str, fn, device, *args) -> None:
    """Launch through `fn` on `device` (the current device) and its
    current stream: fn(*args, launch counter, stream). Raises on a CUDA
    error."""
    import torch

    if device.index != torch.cuda.current_device():
        raise RuntimeError(f"{kernel}: the tensors are on {device} but the current device is "
                           f"cuda:{torch.cuda.current_device()}: run under torch.cuda.device({device})")
    rc = fn(*args, _counter(kernel, device), stream_ptr(device))
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_cuda(name: str, t, dtype, shape=None) -> None:
    """Raise unless t is a contiguous CUDA tensor of this dtype/shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def on_cpu(t) -> bool:
    """True for a CPU tensor (the plain version runs); False for a CUDA
    tensor (the kernel runs); any other device is refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")
