"""The card's idle milliseconds per frame while the frame launches K1
(``rtow.render.k1``: the launcher's checks, the camera's shutter read
back, the sphere groups' boxes, the launch).  Read from the program's
spans (``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.FRAME, "rtow.render.k1")
