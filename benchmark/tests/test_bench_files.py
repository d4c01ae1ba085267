"""BENCHMARK.json and the files it names: each loads by name, and every
name, unit and text keeps to the benchmark's rules."""
import ast
import json
import re

import pytest

from benchmark import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = core.load_json(core.ROOT / "BENCHMARK.json")


def one_line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(config["name"]) and one_line(config["why"])
    assert one_line(config["source"]) and config["source"].startswith("https://")
    body = core.load_json(core.ROOT / config["file"])
    assert body["name"] == config["name"]
    assert body["reduced"] == config["reduced"]
    assert (core.HERE / "scenes" / f"{body['scene']}.py").exists()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert one_line(cell["why"]) and cell["chips"] == 1
    c = core.Cell(BENCH, cell["name"])
    assert (core.HERE / "drivers" / f"{c.traffic['kind']}.py").exists()
    assert c.limits, "the cell's check has no limits"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_loads(metric):
    per_layer = metric in BENCH["per_layer"]
    keys = ({"name", "unit", "better", "source", "layer", "moves"} if per_layer
            else {"name", "unit", "better", "bound", "source"})
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    folder = "metrics" if per_layer else "end_to_end"
    module = core.load_module(core.HERE / folder / f"{metric['name']}.py",
                              f"t_{metric['name']}")
    assert callable(module.read)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if per_layer:
        assert one_line(metric["layer"])
        moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    else:
        assert 0.01 <= metric["bound"] <= 0.25


def test_traffic_files_load():
    for path in (core.HERE / "traffic").glob("*.json"):
        traffic = core.load_json(path)
        assert NAME.match(path.stem)
        assert (core.HERE / "drivers" / f"{traffic['kind']}.py").exists()


def test_paths_hold_no_outside_file():
    """No harness file reads the JAX package's benchmark script or its
    results (the tests are left out: they name them here)."""
    script, results = "bench" + ".py", "BENCH" + "_r"
    for path in core.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert script not in text.replace("benchmark", "") and \
            results not in text, path
        ast.parse(text)
