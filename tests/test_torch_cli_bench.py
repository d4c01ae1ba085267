"""The command line as the benchmark's ``cover.cli`` cell runs it, on the
CPU: a run of ``cli.main`` is the span ``rtow.cli.run``, tiled by the
scene's build, the frame and the write; the cell's readers
(``benchmark/metrics/cli.idle_ms.*.py``) read those spans, and nothing
from a program without them; a whole run of the cell at a small size is
correct, each render fault planted under the command line is caught and
the reference in bfloat16 fails the limit.  The cell is left out of
``BENCHMARK.json`` (its runs spread too widely on the card), so the runs
here give the harness its entry."""
import contextlib
import io

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import core, faults
from benchmark.calibrate_cli import reading
from benchmark.trace import Trace
from rtow_tpu_torch import cli

CPU = torch.device("cpu")
SEED = 2_147_483_659  # more than 31 bits
SIZES = dict(width=64, height=36, spp=2, max_depth=4)
SCENE = dict(number_of_balls_sqrt=2)
PHASES = ["rtow.cli.scene", "rtow.render.frame", "rtow.cli.write"]
READERS = ["cli.idle_ms.scene", "cli.idle_ms.write"]
#: The cell's entry, and the end-to-end metric it reports besides setup_s.
CELL = {"name": "cover.cli", "config": "cover",
        "traffic": "cli_1200x675_spp500_d50", "chips": 1, "why": "-"}
E2E = "render_mrays"


@pytest.fixture
def bench(monkeypatch):
    """``BENCHMARK.json`` as the harness reads it, with the cell in."""
    load = core.load_json

    def with_cell(path):
        out = load(path)
        if path == core.ROOT / "BENCHMARK.json":
            out["workloads"].append(CELL)
            for m in out["end_to_end"]:
                if m["name"] == E2E:
                    m["workloads"].append(CELL["name"])
        return out

    monkeypatch.setattr(core, "load_json", with_cell)
    return with_cell(core.ROOT / "BENCHMARK.json")


def reader(name):
    return core.load_module(core.HERE / "metrics" / f"{name}.py",
                            f"t_{name}").read


@pytest.fixture(scope="module")
def host_ops(tmp_path_factory):
    """The window thread's events of one tiny ``cli.main`` run, as
    (name, start ns, end ns) in start order."""
    out = tmp_path_factory.mktemp("cli") / "c.ppm"
    argv = ["-w", "16", "-s", "1", "-c", "2", "-n", "2", "--device", "cpu",
            "-o", str(out)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert cli.main(argv) == 0
    assert out.read_text().startswith("P3\n16 ")
    ev = [(e.name, int(e.time_range.start * 1000),
           int(e.time_range.end * 1000)) for e in prof.events()]
    return sorted(ev, key=lambda e: (e[1], -e[2]))


def test_run_is_tiled_by_its_phases(host_ops):
    [run] = [e for e in host_ops if e[0] == "rtow.cli.run"]
    phases = [e for e in host_ops if e[0] in PHASES]
    assert [p[0] for p in phases] == PHASES
    assert all(run[1] <= p[1] and p[2] <= run[2] for p in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    covered = sum(p[2] - p[1] for p in phases)
    assert covered >= 0.9 * (run[2] - run[1]), (covered, run)


def test_readers_read_the_spans(host_ops):
    """Each reader gives the card's idle time in its phase per run: on a
    trace whose one device operation covers the frame, all of the scene's
    and the write's time."""
    spans = {e[0]: e for e in host_ops if e[0] in PHASES + ["rtow.cli.run"]}
    run = spans["rtow.cli.run"]
    frame = spans["rtow.render.frame"]
    device = [("k", frame[1], frame[2])]
    t = Trace(device, host_ops, (run[1], run[2]), units=1, counts={}, run={})
    for name, phase in zip(READERS, ("rtow.cli.scene", "rtow.cli.write")):
        want = (spans[phase][2] - spans[phase][1]) * 1e-6
        assert reader(name)(t) == pytest.approx(want), name
    bare = [e for e in host_ops if not e[0].startswith("rtow.cli.")]
    t = Trace(device, bare, (run[1], run[2]), units=1, counts={}, run={})
    assert all(reader(name)(t) is None for name in READERS)


@pytest.mark.parametrize("fault", (None,) + faults.FAULTS)
def test_cell_run(bench, fault):
    """A whole run of ``cover.cli`` at a small size: sound, it is correct
    with both end-to-end metrics; with a render fault planted, not."""
    with (faults.planted(fault, "render") if fault
          else contextlib.nullcontext()):
        result = core.run("cover.cli", SEED, 0.2, False, device=CPU,
                          sizes=SIZES, scene=SCENE, log=io.StringIO())
    assert result["correct"] == (fault is None), (fault, result["compared"])
    if fault is None:
        assert set(result["metrics"]) == {E2E, "setup_s"}
        assert result["compared"]["ppm_gap"]["value"] == 0.0


def test_control_fails(bench):
    c = core.Cell(bench, "cover.cli")
    c.config = {**c.config, **SCENE}
    c.traffic = {**c.traffic, **SIZES}
    numbers = reading(c, "control", SEED, CPU)["numbers"]
    assert any(v > c.limits[k] for k, v in numbers.items()), numbers
