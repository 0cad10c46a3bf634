"""Seconds from the process's start to the window's start: CUDA's
start, the inputs made from the seed, the program's set-up and warm-up
(and in a first run in a checkout, the kernels' build)."""


def read(run):
    return run.setup_s
