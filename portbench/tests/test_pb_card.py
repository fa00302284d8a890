"""On the card, at the cells' own sizes: a short run of each cell comes out
correct and its control does not (``python -m pytest portbench/tests -m
cuda``; skips without a card)."""
import time
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.spec(ROOT)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run(cell, 2**35 + 17, 2.0, False, root=ROOT,
                    t_start=time.perf_counter(), control=control)
    assert r["correct"] is not control, r["checks"]
