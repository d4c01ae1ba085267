"""Whole runs of each cell on the CPU at small sizes (the program's plain
versions): the result line, the check on a sound run, the faults planted
under the timed path and the control in bfloat16, each caught; and the
runs that must print no result."""
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import core, faults
from benchmark.calibrate import reading

#: Each cell at a size the CPU runs in seconds: (traffic sizes, scene).
SMALL = {
    "cover.render": (dict(width=64, height=36, spp=2, max_depth=4),
                     dict(number_of_balls_sqrt=2)),
    "cover.train": (dict(width=48, height=32, spp=2, max_depth=3),
                    dict(number_of_balls_sqrt=3)),
    "knot65k.train": (dict(width=12, height=12, spp=2, max_depth=3),
                      dict(segments=128, rings=72, triangles=18432)),
}
#: The knot's render on the sorted wavefront, a cell not in BENCHMARK.json
#: yet (its frame follows the host's speed): its driver and reference at a
#: small size, held to limits of this test's own.
WAVEFRONT = {"name": "knot65k.render", "config": "knot65k",
             "traffic": "render_400x400_spp64_d20", "chips": 1, "why": "-"}
WAVEFRONT_SMALL = (dict(width=16, height=16, spp=2, max_depth=3),
                   dict(segments=128, rings=72, triangles=18432))
WAVEFRONT_LIMIT = 0.2
CPU = torch.device("cpu")
SEED = 2_147_483_659  # more than 31 bits


def small_run(cell, trace=False, seconds=0.2):
    sizes, scene = SMALL[cell]
    return core.run(cell, SEED, seconds, trace, device=CPU, sizes=sizes,
                    scene=scene, log=io.StringIO())


def last_line(result):
    out = io.StringIO()
    core.emit(dict(result), out=out, log=io.StringIO())
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    line = last_line(small_run("cover.render", trace))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if trace else []) + [
        "compared"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"render_mrays", "setup_s"}
    assert line["compared"]["pixel_gap"]["limit"] is not None


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    result = small_run(cell)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_planted_fault_is_caught(cell, fault):
    kind = core.Cell(core.load_json(core.ROOT / "BENCHMARK.json"),
                     cell).traffic["kind"]
    with faults.planted(fault, kind):
        result = small_run(cell)
    assert not result["correct"], (fault, result["compared"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    """The reference in bfloat16 in the program's place fails a limit."""
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    c = core.Cell(bench, cell)
    sizes, scene = SMALL[cell]
    c.config = {**c.config, **scene}
    c.traffic = {**c.traffic, **sizes}
    numbers = reading(c, "control", SEED, CPU)["numbers"]
    assert any(v > c.limits[k] for k, v in numbers.items()), numbers


def wavefront_reading(mode):
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    c = core.Cell({**bench, "workloads": bench["workloads"] + [WAVEFRONT]},
                  WAVEFRONT["name"])
    sizes, scene = WAVEFRONT_SMALL
    c.config = {**c.config, **scene}
    c.traffic = {**c.traffic, **sizes}
    return reading(c, mode, SEED, CPU)["numbers"]


def test_wavefront_render_is_exact():
    """The knot's frame through the sorted wavefront equals the
    reference's sample bit for bit."""
    assert wavefront_reading("program") == {"pixel_gap": 0.0,
                                            "mismatch_share": 0.0}


@pytest.mark.parametrize("mode", ["control"] + [
    f"fault:{f}" for f in faults.FAULTS])
def test_wavefront_render_faults_caught(mode):
    numbers = wavefront_reading(mode)
    assert any(v > WAVEFRONT_LIMIT for v in numbers.values()), numbers


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_cover_scene_is_the_builders(seed):
    """The frozen scene is the one the port's command line builds."""
    from benchmark.scenes import cover
    from rtow_tpu_torch.config import Config
    from rtow_tpu_torch.models.builders import cover_scene

    config = core.load_json(core.HERE / "configs" / "cover.json")
    mine = cover.scene(config, seed)
    theirs, _ = cover_scene(Config(seed=seed, device="cpu"))
    sp, m = mine["spheres"], mine["materials"]
    assert np.array_equal(np.float32(sp["center0"]),
                          theirs.spheres.center0.numpy())
    assert np.array_equal(np.float32(sp["center1"] - sp["center0"]),
                          theirs.spheres.dcenter.numpy())
    assert np.array_equal(sp["material"], theirs.spheres.material.numpy())
    assert np.array_equal(np.float32(m["albedo"]),
                          theirs.materials.albedo.numpy())
    assert np.array_equal(m["kind"], theirs.materials.kind.numpy())


def run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cover.render",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_card_prints_no_result():
    out = run_py(core.ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "no card" in out.stderr


def test_benchmark_files_alone_print_no_result(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_py(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
