"""One run of one cell: set-up, the measured window, the traced
reduction, the output check, and the result line.

Everything the run needs is found by name from ``BENCHMARK.json``: the
cell's configuration (``configs/<config>.json``, its scene
``scenes/<scene>.py``), its traffic (``traffic/<traffic>.json``, its
driver ``drivers/<kind>.py``), its metrics (``end_to_end/<name>.py``,
``metrics/<name>.py``) and its check's limits (``limits/<cell>.json``).
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "rtow_tpu")
#: The traced run's window: at most this many seconds, at least one unit.
TRACE_SECONDS = 4.0


class NoDevice(RuntimeError):
    """The run has no card, or fewer than the cell asks for."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A cell of ``BENCHMARK.json`` with everything it names loaded."""

    def __init__(self, bench: dict, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(it has {sorted(cells)})")
        self.name = workload
        self.spec = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT / configs[self.spec["config"]]["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.spec['traffic']}.json")
        self.chips = int(self.spec["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if reports(m, self.name)]
        self.per_layer = [m for m in bench["per_layer"] if reports(m, self.name)]
        limits = HERE / "limits" / f"{workload}.json"
        self.limits = ({k: v["limit"] for k, v in load_json(limits).items()}
                       if limits.exists() else {})

    def scene_inputs(self, seeds) -> dict:
        """The scene's inputs, drawn from the configuration's fixed
        ``scene_seed`` where it names one (every run then renders the same
        scene, and the run's seed changes only the draws), else from the
        run's seed."""
        scene = load_module(HERE / "scenes" / f"{self.config['scene']}.py",
                            f"bench_scene_{self.config['scene']}")
        return scene.scene(self.config,
                           self.config.get("scene_seed", seeds.kernel))

    def driver(self, ctx):
        kind = self.traffic["kind"]
        module = importlib.import_module(f"benchmark.drivers.{kind}")
        return module.Driver(ctx)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules(names) -> list:
    """The module names whose top-level package is JAX's or the JAX
    package's (compared whole: ``rtow_tpu_torch`` is not ``rtow_tpu``)."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} cards, the cell asks "
                       f"for {chips}")
    return torch.device("cuda")


class Window:
    """The measured window: each unit's host-clock start and end, and its
    primary rays; and the run's set-up seconds."""

    def __init__(self, setup_s: float):
        self.setup_s = setup_s
        self.starts, self.ends, self.rays = [], [], []

    @property
    def units(self) -> int:
        return len(self.ends)

    @property
    def seconds(self) -> float:
        """From the first unit's start to the end of the last unit started
        in the window."""
        return self.ends[-1] - self.starts[0] if self.ends else 0.0

    def unit_seconds(self) -> np.ndarray:
        return np.asarray(self.ends) - np.asarray(self.starts)


def run_window(driver, seconds: float, sync, span, unit_span: str) -> Window:
    """Units back to back until ``seconds`` have passed since the first
    started; every unit started in the window is finished and counted."""
    w = Window(0.0)
    t0 = time.perf_counter()
    i = 0
    with span("bench.window"):
        while True:
            start = time.perf_counter()
            if start - t0 >= seconds and i:
                break
            with span(unit_span):
                rays = driver.unit(i)
            sync()
            w.starts.append(start)
            w.ends.append(time.perf_counter())
            w.rays.append(rays)
            i += 1
    return w


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: Optional[float] = None, device=None, sizes=None,
        scene=None, log=sys.stderr) -> dict:
    """One run of ``workload`` -> the result line's object.  ``device``
    None takes the card (``NoDevice`` without it); the CPU tests pass
    ``torch.device("cpu")``, small ``sizes`` (traffic keys) and a smaller
    ``scene`` (configuration keys)."""
    t_start = time.perf_counter() if t_start is None else t_start
    from benchmark.drivers import Context, Seeds

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = Cell(bench, workload)
    cell.config = {**cell.config, **(scene or {})}
    import torch

    if device is None:
        device = require_cards(cell.chips)
        print(f"card: {card_line()}", file=log, flush=True)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    seeds = Seeds(seed)
    ctx = Context(cell.config, cell.traffic, seeds, device,
                  cell.scene_inputs(seeds), sizes)
    driver = cell.driver(ctx)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    driver.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    print(f"{workload}: set-up {setup_s:.3f} s (seed {seed})", file=log,
          flush=True)

    from benchmark import program, trace as tr

    counters = program.Counters(device) if trace else None
    span = lambda _name: contextlib.nullcontext()  # noqa: E731
    if trace:
        from torch.profiler import record_function as span
        with tr.profiled(True, keep=False):  # its first start, untimed
            torch.zeros(1, device=device).add_(1)
            sync()
    with tr.profiled(trace) as rec, \
            (counters.installed() if trace else contextlib.nullcontext()):
        window = run_window(driver, min(seconds, TRACE_SECONDS) if trace
                            else seconds, sync, span,
                            f"bench.{cell.traffic['kind']}")
    window.setup_s = setup_s
    sync()
    memory = torch.cuda.max_memory_allocated() if on_card else 0
    if window.units:
        q = np.percentile(window.unit_seconds() * 1e3, [0, 50, 95, 100])
        print(f"{workload}: {window.units} units in {window.seconds:.3f} s; "
              f"unit ms min {q[0]:.2f} median {q[1]:.2f} p95 {q[2]:.2f} "
              f"max {q[3]:.2f}", file=log, flush=True)

    result = {"correct": False, "attempted": window.units, "failed": 0,
              "metrics": {}, "device": {
                  "platform": "gpu" if on_card else device.type,
                  "kind": (torch.cuda.get_device_name(0) if on_card
                           else "cpu"),
                  "count": cell.chips if on_card else 0,
                  "memory_peak_bytes": int(memory)}}
    if trace:
        t = tr.Trace(*rec.events, units=window.units,
                     counts=counters.counts(),
                     run=dict(width=driver.width, height=driver.height,
                              spp=driver.spp, max_depth=driver.max_depth,
                              n_spheres=len(ctx.inputs["spheres"]["radius"]),
                              n_triangles=len(
                                  ctx.inputs["triangles"]["material"]),
                              n_materials=len(
                                  ctx.inputs["materials"]["kind"])))
        result["device"]["busy_s"] = t.busy_s
        result["device"]["window_s"] = t.window_s
        for m in cell.per_layer:
            value = load_module(HERE / "metrics" / f"{m['name']}.py",
                                f"bench_metric_{m['name']}").read(t)
            if value is None:
                print(f"{m['name']}: nothing in the trace to read; left out",
                      file=log, flush=True)
                continue
            result["metrics"][m["name"]] = {"value": float(value),
                                            "unit": m["unit"]}
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.idle_gaps()}
        del t, rec
    else:
        for m in cell.end_to_end:
            value = load_module(HERE / "end_to_end" / f"{m['name']}.py",
                                f"bench_e2e_{m['name']}").read(window)
            if value is None:
                raise RuntimeError(f"{m['name']}: the window gave no value")
            result["metrics"][m["name"]] = {"value": float(value),
                                            "unit": m["unit"]}

    driver.release()
    if on_card:
        torch.cuda.empty_cache()
    check = driver.check(cell.limits)
    result["correct"] = check.correct
    result["failed"] = int(check.failed)
    result["compared"] = {k: {"value": float(v), "limit": cell.limits.get(k)}
                          for k, v in check.numbers.items()}
    return result


def emit(result: dict, out=sys.stdout, log=sys.stderr) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line of standard output, ``compared`` last."""
    for k, v in result["compared"].items():
        print(f"compared {k} = {v['value']} (limit {v['limit']})",
              file=log, flush=True)
    compared = result.pop("compared")
    result["compared"] = compared
    out.write(json.dumps(result) + "\n")
    out.flush()


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One run of a benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=t_start)
    except NoDevice as e:
        print(f"no card to run on: {e}", file=sys.stderr)
        return 3
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"the run holds JAX or the JAX package: {bad}", file=sys.stderr)
        return 4
    emit(result)
    return 0

