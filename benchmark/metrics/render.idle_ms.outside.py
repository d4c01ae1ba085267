"""The card's idle milliseconds per frame outside every
``rtow.render.frame`` span: the harness's sample of the image, its
synchronize and Python between frames.  Read from the program's spans
(``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.FRAME, None)
