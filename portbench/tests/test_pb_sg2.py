"""The cell ``sg2f_ffhq1024.refine_sg2`` at a tiny size on the CPU, with
the program computing in float32, against its own limits: a sound run
comes out correct, and the control and each of ``faults.OF_DRIVER``'s
refinement faults (they patch make_refiner, which the driver calls) come
out not correct.
Beside them: the reference's StyleGAN2 against the port's on the weights
``reference_sg2.make`` draws, the operations ``work_sg2`` counts for
config F, and that neither imports the program."""
import time
from pathlib import Path

import pytest
import torch

from portbench import faults, harness, reference, reference_sg2, work_sg2
from portbench.tests.test_pb_imports import FORBIDDEN, top_level_imports

ROOT = Path(__file__).resolve().parents[2]
SG2_TINY = {"image": [3, 16, 16], "noise_dim": 8, "w_dim": 8,
            "mapping_layers": 2, "channel_base": 64, "channel_max": 16,
            "compute_dtype": "float32"}
CELL = "sg2f_ffhq1024.refine_sg2"
TRAFFIC = {"chunk": 8, "pool_chunks": 2, "steps": 4, "warmup_steps": 0}


def run_cell(control=False, seed=2**33 + 23):
    torch.manual_seed(0)
    return harness.run(CELL, seed, 0.01, False, root=ROOT,
                       t_start=time.perf_counter(), device="cpu",
                       control=control,
                       overrides={"config": SG2_TINY, "traffic": TRAFFIC})


def test_sound_run_is_correct():
    r = run_cell()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and set(r["metrics"]) >= {"setup_s"}


def test_control_is_not_correct():
    r = run_cell(control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", faults.OF_DRIVER["refine"],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    with faults.planted(fault):
        r = run_cell()
    assert not r["correct"], r["checks"]


def test_reference_against_the_ports_modules():
    """The benchmark's weights load into the port's G by name, and the
    float32 reference (per-sample weights, grouped convolutions) gives the
    port's images within f32 round-off."""
    from ganreverser_tpu_torch.models.zoo import create_G_sg2f
    cfg = reference_sg2.config({**SG2_TINY, "lr_mul": 0.01,
                                "fir": [1, 3, 3, 1]})
    p = reference_sg2.make(cfg, torch.Generator().manual_seed(3), "cpu")
    G = create_G_sg2f(cfg["image"], cfg["noise_dim"], cfg["w_dim"],
                      mapping_layers=2, channel_base=64, channel_max=16)
    assert set(G.state_dict()) == set(p)
    G.load_state_dict(p)
    z = torch.randn(3, 8, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = reference_sg2.generator(p, z, cfg)
        got = G(z)
    assert float((got - want).abs().max()) < 1e-5 * float(want.abs().max())
    fp8 = reference_sg2.generator(p, z, cfg, reference.FP8)
    assert float((fp8 - want).abs().max()) > 1e-2 * float(want.abs().max())


def test_config_f_forward_is_74_1_g_multiply_adds():
    """One image's forward at config F, 1024 x 1024: 74.1 G multiply-adds
    (the 3x3 convolutions at 9 Ci Co an input pixel of each up-sampling
    one, ToRGB and the dense layers), within 0.5 %."""
    cfg = reference_sg2.config(harness.load_json(
        ROOT / "portbench" / "configs" / "sg2f_ffhq1024.json"))
    assert work_sg2.forward_macs(cfg) == pytest.approx(74.1e9, rel=0.005)
    assert work_sg2.refine_flops(cfg, 8, 10) == (
        8 * 10 * 2 * 2 * work_sg2.forward_macs(cfg))


@pytest.mark.parametrize("name", ["reference_sg2.py", "work_sg2.py"])
def test_imports_nothing_of_the_program(name):
    """The reference and the counts stand apart from the program they
    judge, and from JAX (the relative imports reach ``reference.py``,
    which ``test_pb_imports`` holds to the same)."""
    names = top_level_imports(ROOT / "portbench" / name)
    assert not names & (FORBIDDEN | {"ganreverser_tpu_torch"}), names
