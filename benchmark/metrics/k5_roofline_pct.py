"""K5's share of its roofline (%): the least time of a step's adjoint
bounces (``benchmark/work.py``: the adjoint of each segment's winner
test, hit record and scatter or sky; the scene read and its gradient
tables written once) over K5's device time per step.  K5 replays K4's
lanes, so the segments are K4's count of live lanes."""
from benchmark import work

KERNELS = r"grad_bwd"


def ops(segments, samples, run):
    return work.adjoint_ops(segments, samples, run["n_triangles"] > 0)


def read(trace):
    run = trace.run
    return work.share(
        trace, KERNELS, "k4_live",
        lambda seg, smp: ops(seg, smp, run),
        lambda: work.scene_bytes(run) + work.grad_bytes(run))
