"""The card's idle milliseconds per train step while the step runs its
backward (``rtow.train.backward``: ``autograd.grad`` on the window's
thread, while the engine's device thread launches K5 and the
permutations' scatters).  Read from the program's spans
(``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.TRAIN_STEP, "rtow.train.backward")
