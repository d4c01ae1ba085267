"""On the card, at each cell's own size: the control (the reference in
bfloat16 in the program's place) fails one of the cell's limits on three
seeds, and a sound run of the program passes them."""
import pytest
import torch

from benchmark import core
from benchmark.calibrate import reading

pytestmark = pytest.mark.cuda
BENCH = core.load_json(core.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell):
    c = core.Cell(BENCH, cell)
    for seed in (101, 2_147_483_711, 4_000_000_001):
        numbers = reading(c, "control", seed, card)["numbers"]
        assert any(v > c.limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_at_cell_size(card, cell):
    c = core.Cell(BENCH, cell)
    numbers = reading(c, "program", 4_000_000_003, card)["numbers"]
    assert all(v <= c.limits[k] for k, v in numbers.items()), numbers
