"""K3's share of its roofline (%): the least time of a frame's bounces
(``benchmark/work.py``: each segment's winner test, hit record, draws and
scatter or sky; the scene read and the image written once) over K3's
device time per frame.  The segments are K3's own count of live lanes
(``bounce_step(stats=)``)."""
from benchmark import work

KERNELS = r"flat_bounce"


def ops(segments, samples, run):
    return work.segment_ops(segments, samples, run["n_triangles"] > 0)


def read(trace):
    run = trace.run
    return work.share(
        trace, KERNELS, "k3_live",
        lambda seg, smp: ops(seg, smp, run),
        lambda: work.scene_bytes(run) + work.image_bytes(run))
