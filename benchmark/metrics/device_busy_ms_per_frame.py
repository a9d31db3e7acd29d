"""device_busy_ms_per_frame (ms, device trace): the union of the
intervals in which an operation ran on the card during the traced drive,
over its frames. Layer: the step (DeviceStep and its four graphs)."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return run.trace.busy_ns() / 1e6 / run.traced.frames
