"""Small constant tensors on a device, built once.

A step that uploads a constant from a Python list or scalar (torch.tensor
on a CUDA device, or a Python scalar assigned through an index) makes a
pageable host-to-device copy every time, which waits for the host and is
refused while a CUDA graph is being captured. `device_constant` uploads
each (value, dtype, device) once and hands out the same tensor after
that; the first frame of a step builds every constant the step needs,
before anything is captured. The tensors are shared: never write to one.
"""

from __future__ import annotations

import torch

_CACHE: dict[tuple, torch.Tensor] = {}


def _frozen(value):
    if isinstance(value, (list, tuple)):
        return tuple(_frozen(v) for v in value)
    return value


def device_constant(value, dtype, device) -> torch.Tensor:
    """torch.tensor(value, dtype=dtype, device=device), uploaded once per
    process, value and device."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (_frozen(value), dtype, device)
    t = _CACHE.get(key)
    if t is None:
        t = torch.tensor(value, dtype=dtype, device=device)
        _CACHE[key] = t
    return t


def device_scalar(value, dtype, device) -> torch.Tensor:
    """A 0-dim tensor of dtype on device: a tensor converted (no copy
    when it already is one), a number through device_constant."""
    if torch.is_tensor(value):
        return value.to(device=device, dtype=dtype).reshape(())
    return device_constant(value, dtype, device)
