"""filter_kernels_ms_per_frame (ms, device trace): the device time of
the kernels that only the dynamic filter (ops/dynamic_filter.py)
launches, over the traced drive's frames: the 24 rounds of max_pool3d of
its min-label diffusion and its radius count (csrc/radius_count.cu).
Nothing when the filter is off."""

NAMES = ("max_pool3d", "radius_count_kernel")


def read(run):
    if run.trace is None:
        return None
    s = run.trace.device_seconds(lambda n: any(k in n for k in NAMES))
    return None if s is None else 1e3 * s / run.traced.frames
