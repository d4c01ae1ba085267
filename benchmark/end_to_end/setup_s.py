"""Seconds from the process's start to the first timed frame or step:
imports, the CUDA context, loading (on a checkout's first run, building)
the kernels, the scene, the target render and the warm-up."""


def read(window):
    return window.setup_s
