"""The card's idle milliseconds per train step while the step runs its
forward (``rtow.train.forward``: the camera rays, the lanes, the bounces
with their sorts and K4's launches, the loss).  Read from the program's
spans (``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.TRAIN_STEP, "rtow.train.forward")
