"""K3's device milliseconds per frame: every launch of the sorted
wavefront's bounce kernel (``csrc/flat_bounce.cu``), thread and warp
forms."""
KERNELS = r"flat_bounce"


def read(trace):
    seconds = trace.kernel_s(KERNELS)
    if seconds is None or not trace.units:
        return None
    return seconds / trace.units * 1e3
