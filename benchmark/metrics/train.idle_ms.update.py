"""The card's idle milliseconds per train step while the step runs its
update (``rtow.train.update``: the gradients masked, SGD).  Read from
the program's spans (``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.TRAIN_STEP, "rtow.train.update")
