"""The card's idle time put down to the program's phases, and the host's
syncs counted, from the program's own spans in the traced window: the
readers of ``metrics/train.*.py`` and ``metrics/render.*.py``.

The program (``rtow_tpu_torch/utils/profiling.span``) records its spans
on the profiler's timeline, which CUPTI shares with the card's
operations.  A unit is one ``rtow.train.step`` or ``rtow.render.frame``,
tiled by its phases (``rtow.train.tables``, ``.forward``, ``.backward``,
``.update``; ``rtow.render.tables``, ``.k1``, ``.readback``); every
place where the host waits on the card is a ``rtow.sync.<site>`` span.
Phases on one thread do not overlap, so each idle interval of the card
falls in one phase, in no phase of a unit, or outside every unit (the
harness and Python between units: ``outside``).

Only what :class:`benchmark.trace.Trace` holds is read: ``device_ops``,
``host_ops`` (the window's thread), ``start``, ``end`` and ``units``.  A
program without these spans gives None, and the metric is left out.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from benchmark.trace import _union

#: Each traffic kind's unit span, and the prefix of the sync spans.
TRAIN_STEP = "rtow.train.step"
FRAME = "rtow.render.frame"
SYNC = "rtow.sync."


def host_spans(trace, name: str) -> List[List[int]]:
    """The union of the window thread's spans named ``name``, clipped to
    the window, in order."""
    return _union(sorted(
        (max(s, trace.start), min(e, trace.end))
        for n, s, e in trace.host_ops
        if n == name and e > trace.start and s < trace.end))


def idle_intervals(trace) -> List[Tuple[int, int]]:
    """The window's intervals in which no operation ran on the card."""
    busy = _union(sorted((s, e) for _, s, e in trace.device_ops))
    gaps, t = [], trace.start
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if trace.end > t:
        gaps.append((t, trace.end))
    return gaps


def overlap_ns(a, b) -> int:
    """The length of the intersection of two ordered lists of disjoint
    intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(trace, unit: str, phase: Optional[str]) -> Optional[float]:
    """Milliseconds per unit in which the card idles while the window's
    thread is inside a ``phase`` span, or (``phase`` None) outside every
    ``unit`` span; None without device operations, units or unit
    spans."""
    if not trace.device_ops or not trace.units:
        return None
    units = host_spans(trace, unit)
    if not units:
        return None
    gaps = idle_intervals(trace)
    if phase is None:
        ns = sum(e - s for s, e in gaps) - overlap_ns(gaps, units)
    else:
        ns = overlap_ns(gaps, host_spans(trace, phase))
    return ns / trace.units * 1e-6


def host_syncs(trace, unit: str) -> Optional[float]:
    """The ``rtow.sync.*`` spans per unit that start in the window; None
    without units or unit spans."""
    if not trace.units or not host_spans(trace, unit):
        return None
    n = sum(1 for name, s, _ in trace.host_ops
            if name.startswith(SYNC) and trace.start <= s < trace.end)
    return n / trace.units
