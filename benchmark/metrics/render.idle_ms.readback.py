"""The card's idle milliseconds per frame while the frame reads its image
back (``rtow.render.readback``: the block rows put in image order, the
wait for K1, the copy to the host, the float64 cast and the divide).
Read from the program's spans (``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.FRAME, "rtow.render.readback")
