"""The card's idle milliseconds per frame while the frame builds its
tables (``rtow.render.tables``: the image-texture check's sync, K1's
sphere table and its Morton sort, the lit rows, the camera and scalars).
Read from the program's spans (``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.FRAME, "rtow.render.tables")
