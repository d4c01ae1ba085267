"""The program's host syncs per frame: its ``rtow.sync.*`` spans, each a
place where the host waits on the card (``benchmark/spans.py``)."""
from benchmark import spans


def read(trace):
    return spans.host_syncs(trace, spans.FRAME)
