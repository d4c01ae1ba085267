"""K1's share of its roofline (%): the least time of a frame's work
(``benchmark/work.py``: each sample's camera ray drawn on the card, each
segment's winner test, hit record, draws and scatter or sky; the scene
read and the image written once) over K1's device time per frame.  The
segments are K1's own count of ray steps (``render_blocks(steps=)``)."""
from benchmark import work

KERNELS = r"megakernel<"


def ops(segments, samples, run):
    return (samples * work.OPS_CAMERA
            + work.segment_ops(segments, samples, run["n_triangles"] > 0))


def read(trace):
    run = trace.run
    return work.share(
        trace, KERNELS, "k1_steps",
        lambda seg, smp: ops(seg, smp, run),
        lambda: work.scene_bytes(run) + work.image_bytes(run))
