"""The card's idle milliseconds per train step outside every
``rtow.train.step`` span: the harness's synchronize and Python between
steps.  Read from the program's spans (``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.idle_ms(trace, spans.TRAIN_STEP, None)
