"""The readers of the program's spans (``benchmark/spans.py``,
``metrics/train.*.py``, ``metrics/render.*.py``) on synthetic traces:
each idle interval of the card lands in exactly one phase or outside,
so the phases and ``outside`` sum to the window's idle time per unit;
the sync spans are counted per unit; a program without the spans reads
None."""
import numpy as np
import pytest

from benchmark import core, spans
from benchmark.trace import Trace

TRAIN = ["tables", "forward", "backward", "update"]
RENDER = ["tables", "k1", "readback"]


def metric(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py",
                            f"t_{name}").read


def trace(device, host, window=(0, 1000), units=2):
    return Trace(device, host, window, units=units, counts={}, run={})


def tiled(unit, phases, bounds, prefix):
    """Host spans: one unit span per (start, cuts..., end) in ``bounds``,
    tiled by its phases."""
    out = []
    for b in bounds:
        out.append((unit, b[0], b[-1]))
        out += [(f"{prefix}.{p}", s, e) for p, s, e in zip(phases, b, b[1:])]
    return out


def test_hand_counted_train_window():
    """Two steps in a 1,000 ns window: the idle intervals [0, 120),
    [140, 160), [300, 520), [700, 1000) split by hand."""
    host = tiled("rtow.train.step", TRAIN,
                 [(100, 150, 250, 350, 400), (500, 550, 650, 750, 800)],
                 "rtow.train")
    host += [("rtow.sync.check_scene", 100, 110),
             ("rtow.sync.check_scene", 500, 505), ("aten::add", 0, 900)]
    device = [("k", 120, 140), ("k", 160, 300), ("k", 520, 600),
              ("k", 590, 700)]
    t = trace(device, host)
    got = {p: metric(f"train.idle_ms.{p}")(t) * 1e6 * 2 for p in TRAIN}
    got["outside"] = metric("train.idle_ms.outside")(t) * 1e6 * 2
    # tables: 100-120, 140-150, 500-520; forward: 150-160; backward:
    # 300-350, 700-750; update: 350-400, 750-800; outside: 0-100,
    # 400-500, 800-1000.
    want = {"tables": 50, "forward": 10, "backward": 100, "update": 100,
            "outside": 400}
    assert got == pytest.approx(want)
    assert metric("train.host_syncs")(t) == 1.0


def random_trace(rng, unit, phases, prefix, units):
    """Units back to back with gaps, each tiled by its phases at random
    cuts; random device operations, overlapping, some past the window."""
    t, bounds = 1000, []
    for _ in range(units):
        t += int(rng.integers(0, 5000))
        cuts = np.sort(rng.integers(0, 20000, len(phases) - 1))
        bounds.append((t, *(t + cuts), t + 20000))
        t += 20000
    window = (0, t + int(rng.integers(0, 5000)))
    host = tiled(unit, phases, bounds, prefix)
    host += [(f"rtow.sync.s{i}", s, s + 5) for i, (_, s, _e) in
             enumerate(host[:: len(phases) + 1])]
    starts = rng.integers(-2000, window[1] + 2000, 400)
    device = [("op", int(s), int(s + rng.integers(1, 800))) for s in starts]
    return trace(device, host, window, units)


@pytest.mark.parametrize("kind,unit,phases", [
    ("train", spans.TRAIN_STEP, TRAIN), ("render", spans.FRAME, RENDER)])
@pytest.mark.parametrize("seed", range(5))
def test_phases_and_outside_sum_to_the_idle_time(kind, unit, phases, seed):
    """Each idle interval lands in one phase or outside: the phases and
    ``outside`` sum to the window's idle time per unit, which is what
    ``device_idle_pct`` reads."""
    rng = np.random.default_rng(seed)
    units = int(rng.integers(1, 6))
    t = random_trace(rng, unit, phases, f"rtow.{kind}", units)
    parts = [spans.idle_ms(t, unit, f"rtow.{kind}.{p}") for p in phases]
    parts.append(spans.idle_ms(t, unit, None))
    idle = (1.0 - t.busy_s / t.window_s) * t.window_s / t.units * 1e3
    assert sum(parts) == pytest.approx(idle, rel=1e-12)
    assert all(p >= 0 for p in parts)
    for p in phases:
        assert metric(f"{kind}.idle_ms.{p}")(t) == parts[phases.index(p)]
    assert metric(f"{kind}.idle_ms.outside")(t) == parts[-1]
    assert metric(f"{kind}.host_syncs")(t) == 1.0


@pytest.mark.parametrize("name", [
    *(f"train.idle_ms.{p}" for p in TRAIN + ["outside"]),
    "train.host_syncs", *(f"render.idle_ms.{p}" for p in RENDER + [
        "outside"]), "render.host_syncs"])
def test_no_spans_reads_none(name):
    """The parent program has no spans: every reader gives None, and the
    metric is left out of the line; so do traces without device
    operations (the CPU's) for the idle readers."""
    device = [("k", 100, 200)]
    assert metric(name)(trace(device, [("aten::add", 0, 900)])) is None
    if "idle" in name:
        host = tiled(spans.TRAIN_STEP, TRAIN, [(0, 1, 2, 3, 4)], "rtow.train")
        host += tiled(spans.FRAME, RENDER, [(5, 6, 7, 8)], "rtow.render")
        assert metric(name)(trace([], host)) is None
