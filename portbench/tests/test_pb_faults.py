"""A run driven past the harness's look for a card, at a tiny size on the
CPU, with the program computing in float32, against the cells' own limits:
a sound run comes out correct, and the control and each fault planted in
the timed path (``portbench/faults.py``) come out not correct."""
import time
from pathlib import Path

import pytest
import torch

from portbench import faults, harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {"image": [3, 16, 16], "noise_dim": 8, "compute_dtype": "float32"}
TRAFFIC = {
    "rgb64_z100.e2e_pixel": {"n": 96, "batch": 16, "k": 4, "pixel_k": 4,
                             "needle_chunk": 32, "warmup_steps": 0},
    "rgb128_z256.e2e": {"n": 96, "batch": 16, "k": 4, "needle_chunk": 32,
                        "warmup_steps": 0},
    "rgb128_z256.refine": {"chunk": 8, "pool_chunks": 2, "steps": 4,
                           "warmup_steps": 0},
    "rgb64_z100.train_gd": {"batch": 16, "pool_batches": 8,
                            "warmup_steps": 0},
}


def run_cell(cell, control=False, seed=2**33 + 5):
    torch.manual_seed(0)
    return harness.run(cell, seed, 0.01, False, root=ROOT,
                       t_start=time.perf_counter(), device="cpu",
                       control=control,
                       overrides={"config": TINY, "traffic": TRAFFIC[cell]})


@pytest.mark.parametrize("cell", list(TRAFFIC))
def test_sound_run_is_correct(cell):
    r = run_cell(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and set(r["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell", list(TRAFFIC))
def test_control_is_not_correct(cell):
    r = run_cell(cell, control=True)
    assert not r["correct"], r["checks"]


FAULTS = [(cell, fault) for cell in TRAFFIC for fault in faults.OF_DRIVER[
    harness.resolve(ROOT, cell).traffic["driver"]]]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        r = run_cell(cell)
    assert not r["correct"], r["checks"]
