"""K1's device milliseconds per frame: every launch of the whole-frame
render's kernel (``csrc/megakernel.cu``), all its instances."""
KERNELS = r"megakernel<"


def read(trace):
    seconds = trace.kernel_s(KERNELS)
    if seconds is None or not trace.units:
        return None
    return seconds / trace.units * 1e3
