"""Observability: render statistics, the program's spans and profiler
traces (the port of ``rtow_tpu.utils.profiling``).

* ``RenderStats``: wall time and primary-ray throughput, printed by the
  progress-enabled render path (the reference prints "Done in Nms",
  src/render.cpp:188-190); the same ``summary()`` text as the JAX
  package's.
* ``span``: a named interval of the program on the profiler's timeline,
  which CUPTI shares with the card's operations, so every interval in
  which the card idles falls inside or outside a named phase.  Names
  start with ``rtow.``: the phases of a frame or train step
  (``rtow.render.*``, ``rtow.train.*``, ``rtow.wavefront.*``), the
  gradient bounce's parts (``rtow.grad.*``), and ``rtow.sync.<site>``
  around each place where the host waits on the card, so a unit's
  ``rtow.sync.*`` spans count its host syncs and their durations are
  the host's blocked time.
* ``trace_profile``: ``--profile-dir``, a ``torch.profiler`` session
  written out as a Chrome trace, around a frame or a train step.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
from typing import Iterator, Optional

import torch


@dataclasses.dataclass
class RenderStats:
    wall_s: float
    n_pixels: int
    spp: int
    max_depth: int
    backend: str = "cuda"

    @property
    def primary_rays(self) -> int:
        return self.n_pixels * self.spp

    @property
    def primary_mrays_per_s(self) -> float:
        return self.primary_rays / self.wall_s / 1e6

    def summary(self) -> str:
        return (
            f"Done in {int(self.wall_s * 1000)}ms "
            f"({self.primary_mrays_per_s:.2f} Mprimary-rays/s, "
            f"{self.n_pixels}px x {self.spp}spp, depth {self.max_depth}, "
            f"{self.backend})"
        )


#: What :func:`span` returns while no profiler records: one shared
#: context that does nothing (``nullcontext`` keeps no state, so nested
#: and repeated uses may share it).
NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` span named ``name`` while a
    profiler records on this thread, else :data:`NO_SPAN`.  The guard is
    the point: a bare ``record_function`` costs ~10x the guarded call
    when no profiler runs, and a train step opens dozens of spans."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NO_SPAN


#: The file :func:`trace_profile` writes in its directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` session over the block (the host's operators
    and the program's spans on every thread, and the card's operations
    where PyTorch can trace a card), written as a Chrome trace to
    ``log_dir/trace.json`` when ``log_dir`` is set; nothing otherwise
    (``--profile-dir``, as ``rtow_tpu.utils.profiling.trace_profile``).
    ``render_auto`` runs a frame inside it (``rtow.render.*``,
    ``rtow.wavefront.*``); a train step's spans (``rtow.train.*``,
    ``rtow.grad.*``, K5's on the autograd engine's thread) are traced by
    calling the step inside ``with trace_profile(log_dir):``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported_activities()]
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    print(f"profile trace written to {log_dir}", file=sys.stderr)
