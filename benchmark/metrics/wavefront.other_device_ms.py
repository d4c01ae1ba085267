"""The sorted wavefront's device milliseconds per frame outside K3: the
sort keys, the sorts, the gathers and the scatter back, the live counts
and the camera rays."""
KERNELS = r"flat_bounce"


def read(trace):
    k3 = trace.kernel_s(KERNELS)
    if k3 is None or not trace.units:
        return None
    return (trace.device_s() - k3) / trace.units * 1e3
