"""device_idle_share (%, device trace): the share of the traced drive's
window in which nothing ran on the card."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_ns() / 1e9 / run.trace.window_s)
