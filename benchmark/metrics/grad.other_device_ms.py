"""The train step's device milliseconds outside K4 and K5: the camera
rays, the sorts and the permutations' gathers and scatters, the loss,
the table sums and the update."""
KERNELS = r"grad_fwd|grad_bwd"


def read(trace):
    k45 = trace.kernel_s(KERNELS)
    if k45 is None or not trace.units:
        return None
    return (trace.device_s() - k45) / trace.units * 1e3
