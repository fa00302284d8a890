"""The port's spans (io/metrics.py::span): nothing but a flag check while
no profiler records; under one, the ranges of the refiner's chunk and the
adversarial epoch at their layer boundaries, nested and under one root,
in the profiler's own trace too. Small geometry on the CPU; the card case
is marked ``cuda``."""
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ganreverser_tpu_torch import optim as PO
from ganreverser_tpu_torch.analysis.graphs import CapturedProgram
from ganreverser_tpu_torch.analysis.refine import make_refiner
from ganreverser_tpu_torch.io import metrics
from ganreverser_tpu_torch.models import modules, zoo
from ganreverser_tpu_torch.train import adversarial as adv
from ganreverser_tpu_torch.train.state import GanState, TrainState

from torch_port_fixtures import one_thread  # noqa: F401

DIMS, ND, BATCH = (1, 8, 8), 6, 8

REFINE = (["gr.refine.chunk"]
          + ["gr.refine.forward", "gr.refine.backward", "gr.refine.adam"] * 2
          + ["gr.refine.loss"])
EPOCH = (["gr.train.epoch"]
         + ["gr.train.d_step", "gr.optim.update",
            "gr.train.g_step", "gr.optim.update"] * 2)


def _refine():
    gen = torch.Generator().manual_seed(0)
    G = modules.init_parameters(zoo.create_G3(DIMS, ND), gen).eval()
    refine = make_refiner(G, steps=2, lr=0.05)
    images = torch.rand((4,) + DIMS[1:] + DIMS[:1], generator=gen)
    return refine(images, torch.randn(4, ND, generator=gen))


def _epoch():
    gen = torch.Generator().manual_seed(1)
    G = modules.init_parameters(zoo.create_G(DIMS, ND), gen)
    D = modules.init_parameters(zoo.create_D(DIMS), gen)
    modules.set_dropout_generator(D, torch.Generator().manual_seed(2))
    gs = GanState(g=TrainState.create(G, PO.adam()),
                  d=TrainState.create(D, PO.adam()))
    epoch = adv.make_epoch_program(
        batch_size=BATCH, noise_dim=ND, noise_method="normal", n_batches=2,
        dtype=torch.float32)
    data = torch.rand(10, 8, 8, 1, generator=gen)
    return epoch(gs, adv.Confusion.zero(), data,
                 torch.Generator().manual_seed(3))


def _profiled(fn):
    metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof, metrics.spans()


def test_off_is_a_flag_check_and_records_nothing(monkeypatch):
    def entered(name):
        raise AssertionError(f"record_function({name!r}) entered")

    metrics.clear_spans()
    monkeypatch.setattr(metrics, "record_function", entered)
    with metrics.span("gr.test.off"):
        pass
    _refine()
    _epoch()
    assert metrics.spans() == []


@pytest.mark.parametrize("fn,names,parents", [
    (_refine, REFINE, [None] + ["gr.refine.chunk"] * 7),
    (_epoch, EPOCH, [None] + ["gr.train.epoch", "gr.train.d_step",
                              "gr.train.epoch", "gr.train.g_step"] * 2),
])
def test_spans_nest_at_the_layer_boundaries(fn, names, parents):
    _, got = _profiled(fn)
    assert [s.name for s in got] == names
    assert [s.parent for s in got] == parents
    assert len({s.root for s in got}) == 1
    assert all(s.device_ms is None for s in got)  # no card


def test_spans_are_in_the_chrome_trace(tmp_path):
    prof, got = _profiled(lambda: (_refine(), _epoch()))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"
                 and e["name"].startswith("gr.")}
    assert annotated == set(REFINE) | set(EPOCH) == {s.name for s in got}
    assert len({s.root for s in got}) == 2


def test_clear_spans_empties_the_store():
    _profiled(_refine)
    assert metrics.spans()
    metrics.clear_spans()
    assert metrics.spans() == []


@pytest.mark.cuda
def test_card_span_device_time():
    """On the card: a span's device interval is positive and no longer than
    the host's time to the end of its work; the graph path's spans."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(2048, 2048, device="cuda")
    program = CapturedProgram(lambda a: a @ a)
    program(x)  # the capture
    torch.cuda.synchronize()
    metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        with metrics.span("gr.test.matmul"):
            for _ in range(20):
                x = x @ x.T * 1e-3
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        program(x)
        torch.cuda.synchronize()
    got = metrics.spans()
    assert [s.name for s in got] == [
        "gr.test.matmul", "gr.program.call", "gr.program.copy_in",
        "gr.program.replay", "gr.program.clone_out"]
    assert 0 < got[0].device_ms <= host_ms
    assert all(s.device_ms > 0 for s in got)
    assert [s.parent for s in got[2:]] == ["gr.program.call"] * 3
