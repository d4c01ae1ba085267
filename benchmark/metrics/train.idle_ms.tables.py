"""The card's idle milliseconds per train step while the step builds its
tables (``rtow.train.tables``: the scene check's sync, the sphere,
triangle and light tables, the sort grid).  Read from the program's
spans (``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.TRAIN_STEP, "rtow.train.tables")
