"""On the card, at each cell's own size: the program as configured passes
its limits, and the precision control (the program's own bfloat16
pair-table modes) fails them, on three seeds each. Skips without a card;
run on the chip with

    python3 -m pytest benchmark/tests -m card -q
"""
import pytest

from benchmark.control import readings

SEEDS = [3000000301, 3000000302, 3000000303]
CELLS = {"gs_mesh.train": 0.5, "gs_flame.train": 0.5, "gs_mesh.render": 1.5}


@pytest.mark.card
@pytest.mark.parametrize("cell", list(CELLS))
def test_program_passes_and_control_fails(card, cell):
    for _, result, lines in readings(cell, "exact", SEEDS, CELLS[cell]):
        assert result["correct"] is True, lines[-4:]
    for _, result, lines in readings(cell, "bf16", SEEDS, CELLS[cell]):
        assert result["correct"] is False, lines[-4:]
