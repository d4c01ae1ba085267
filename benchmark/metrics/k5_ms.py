"""K5's device milliseconds per train step: every launch of the gradient
path's backward bounce (``csrc/grad_bwd.cu``), thread and warp forms."""
KERNELS = r"grad_bwd"


def read(trace):
    seconds = trace.kernel_s(KERNELS)
    if seconds is None or not trace.units:
        return None
    return seconds / trace.units * 1e3
