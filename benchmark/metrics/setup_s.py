"""setup_s (s, host clock): from the start of run.py to the first
measured frame: imports, the scenes, the program's construction and its
warm-up drive (on a checkout's first run, the kernels' build too)."""


def read(run):
    return run.setup_s
