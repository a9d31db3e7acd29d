"""scans_per_s (scans/s, host clock): every frame handed in during the
window over the window's length; resets, padding, uploads and pose
fetches all fall inside it."""


def read(run):
    return run.window.frames / run.window.seconds
