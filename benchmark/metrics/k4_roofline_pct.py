"""K4's share of its roofline (%): the least time of a step's forward
bounces (``benchmark/work.py``: each segment's winner test, hit record,
draws and scatter or sky; the scene read and the image written once)
over K4's device time per step.  The segments are K4's own count of live
lanes (``bounce_fwd(stats=)``)."""
from benchmark import work

KERNELS = r"grad_fwd"


def ops(segments, samples, run):
    return work.segment_ops(segments, samples, run["n_triangles"] > 0)


def read(trace):
    run = trace.run
    return work.share(
        trace, KERNELS, "k4_live",
        lambda seg, smp: ops(seg, smp, run),
        lambda: work.scene_bytes(run) + work.image_bytes(run))
