"""Whole runs of the lit cells on the CPU at small sizes (the program's
plain versions): a sound run is correct, each fault planted under the
timed path is caught, and the reference in bfloat16 in the program's
place fails a limit."""
import io

import pytest
import torch

from benchmark import core, faults
from benchmark.calibrate import reading
from benchmark.calibrate_lit import LitCell

#: Each lit cell at a size the CPU runs in seconds (traffic sizes).
SMALL = {
    "cornell.render": dict(width=24, height=24, spp=2, max_depth=6),
    "cornell.train": dict(width=16, height=16, spp=2, max_depth=4),
}
CPU = torch.device("cpu")
SEED = 2_147_483_659  # more than 31 bits


@pytest.fixture(autouse=True)
def pool(monkeypatch):
    """K1's work pool, the scheduler the reference replays."""
    monkeypatch.setenv("RTOW_POOL", "1")


def small_run(cell, trace=False):
    return core.run(cell, SEED, 0.2, trace, device=CPU, sizes=SMALL[cell],
                    log=io.StringIO())


def base_kind(cell):
    return LitCell(core.load_json(core.ROOT / "BENCHMARK.json"),
                   cell).traffic["kind"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell, trace):
    result = small_run(cell, trace)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    if not trace:
        cells = core.Cell(core.load_json(core.ROOT / "BENCHMARK.json"), cell)
        assert set(result["metrics"]) == {m["name"] for m in cells.end_to_end}


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_planted_fault_is_caught(cell, fault):
    with faults.planted(fault, base_kind(cell)):
        result = small_run(cell)
    assert not result["correct"], (fault, result["compared"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    c = LitCell(core.load_json(core.ROOT / "BENCHMARK.json"), cell)
    c.traffic = {**c.traffic, **SMALL[cell]}
    numbers = reading(c, "control", SEED, CPU)["numbers"]
    assert any(v > c.limits[k] for k, v in numbers.items()), numbers
