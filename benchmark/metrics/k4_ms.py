"""K4's device milliseconds per train step: every launch of the gradient
path's forward bounce (``csrc/grad_fwd.cu``), thread and warp forms."""
KERNELS = r"grad_fwd"


def read(trace):
    seconds = trace.kernel_s(KERNELS)
    if seconds is None or not trace.units:
        return None
    return seconds / trace.units * 1e3
