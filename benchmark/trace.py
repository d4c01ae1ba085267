"""The traced run: ``torch.profiler`` over the window, reduced to what the
per-layer metrics read.

The profiler records the card's operations (kernels, copies, fills) and
the host's: the benchmark's own spans (``record_function``: the window,
``bench.window``, and each call into the program, ``bench.<traffic
kind>``), PyTorch's operators and the CUDA runtime's calls.  The
raw events are read once (``kineto_results``) into plain intervals.
"""
from __future__ import annotations

import contextlib
import re
from typing import Optional

#: The span around the traced window.
WINDOW = "bench.window"


def short_name(name: str) -> str:
    """A device operation's name without its return type and parameter
    list, at most 120 characters."""
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:120]


class Trace:
    """The traced window's intervals (nanoseconds): the card's operations
    clipped to the window, and the host's events on the window's thread.

    ``units`` is the frames or steps the window finished, ``counts`` the
    program's counters read over it (:class:`benchmark.program.Counters`),
    ``run`` the cell's sizes (width, height, spp, max_depth) and scene
    (n_spheres, n_triangles)."""

    def __init__(self, device_ops, host_ops, window, units: int,
                 counts: dict, run: dict):
        self.start, self.end = window
        self.device_ops = [(n, max(s, self.start), min(e, self.end))
                           for n, s, e in device_ops
                           if e > self.start and s < self.end]
        self.host_ops = host_ops
        self.units = units
        self.counts = counts
        self.run = run
        self._busy = _union(sorted((s, e) for _, s, e in self.device_ops))

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        return sum(e - s for s, e in self._busy) * 1e-9

    def kernel_s(self, pattern: str) -> Optional[float]:
        """Device seconds of the operations whose name matches
        ``pattern`` (a regular expression), None where none does."""
        rx = re.compile(pattern)
        times = [e - s for n, s, e in self.device_ops if rx.search(n)]
        return sum(times) * 1e-9 if times else None

    def device_s(self) -> float:
        """Device seconds of every operation (overlaps counted twice)."""
        return sum(e - s for _, s, e in self.device_ops) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e in self.device_ops:
            key = short_name(name)
            by[key] = by.get(key, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v * 1e-9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The card's idle time in the window by what the host was doing:
        each gap between busy intervals named by the innermost host event
        on the window's thread at its middle, summed by name."""
        gaps = []
        t = self.start
        for s, e in self._busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        host = sorted(self.host_ops, key=lambda x: (x[1], -x[2]))
        by = {}
        stack, j = [], 0
        for s, e in gaps:
            mid = (s + e) // 2
            while j < len(host) and host[j][1] <= mid:
                while stack and stack[-1][2] <= host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] < mid:
                stack.pop()
            name = stack[-1][0] if stack else "(no host event)"
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v * 1e-9] for k, v in top]


def _union(intervals):
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextlib.contextmanager
def profiled(enabled: bool, keep: bool = True):
    """A ``torch.profiler`` session over the block, or nothing; yields a
    holder whose ``events`` are set to (device ops, host ops on the
    window's thread, the window's (start, end)) when the block ends, if
    ``keep``."""
    holder = type("Recorded", (), {"events": None})()
    if not enabled:
        yield holder
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
    if keep:
        holder.events = _reduce(prof.profiler.kineto_results.events())


def _reduce(events):
    from torch.autograd import DeviceType

    device, host, window, thread = [], [], None, None
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if e.name() == WINDOW:
                window, thread = (s, end), e.start_thread_id()
            host.append((e.name(), s, end, e.start_thread_id()))
        elif not (e.is_user_annotation() or e.name().startswith("bench.")):
            # The spans' own marks on the card's timeline are not work.
            device.append((e.name(), s, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    host = [(n, s, e) for n, s, e, th in host if th == thread]
    return device, host, window
