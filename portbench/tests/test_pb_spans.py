"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that use it) on a synthetic trace and a stubbed span store."""
from types import SimpleNamespace

import pytest

from ganreverser_tpu_torch.io import metrics
from portbench import harness, spans, tracing

HOST_READERS = ("graph_launch_ms.e2e", "span_idle_ms.e2e",
                "span_idle_ms.refine", "span_idle_ms.train")
STORE_READERS = ("refine_forward_ms.refine", "refine_backward_ms.refine",
                 "d_step_ms.train", "g_step_ms.train", "update_ms.train")


def run_of(host, steps=2):
    """Kernels at [10, 20), [30, 50), [60, 70), [90, 100) of a window
    [0, 100) us: idle at [0, 10), [20, 30), [50, 60), [70, 90)."""
    ops = [("k", 10, 20), ("k", 30, 50), ("k", 60, 70), ("k", 90, 100)]
    return SimpleNamespace(trace=tracing.Trace(ops, list(host), (0.0, 100.0),
                                               steps))


PROGRAM = [("gr.program.call", 6, 75), ("gr.program.replay", 15, 35),
           ("cudaGraphLaunch", 18, 32), ("aten::copy_", 52, 58),
           ("cudaDeviceSynchronize", 70, 95)]


def test_idle_goes_to_the_innermost_span_not_to_an_op_inside_it():
    by = spans.idle_s(run_of(PROGRAM))
    # [20, 30) under replay (cudaGraphLaunch inside it does not count),
    # [50, 60) under call (not aten::copy_); [0, 10) and [70, 90) under
    # no span are in no reader
    assert by == {"gr.program.replay": pytest.approx(10e-6),
                  "gr.program.call": pytest.approx(10e-6)}
    assert dict(tracing.idle_gaps(run_of(PROGRAM).trace))[
        "cudaGraphLaunch"] == pytest.approx(10e-6)
    read = harness.reader("span_idle_ms.train")
    assert read(run_of(PROGRAM)) == pytest.approx(1e3 * 20e-6 / 2)


def test_graph_launch_is_host_time_in_replay_per_step():
    read = harness.reader("graph_launch_ms.e2e")
    assert read(run_of(PROGRAM)) == pytest.approx(20e-3 / 2)


@pytest.mark.parametrize("name", HOST_READERS)
def test_host_readers_read_none_without_spans_or_trace(name):
    read = harness.reader(name)
    assert read(run_of([("aten::mm", 0, 100)])) is None
    assert read(SimpleNamespace(trace=None)) is None


STORE = [metrics.Span("gr.refine.chunk", None, 0, 40.0),
         metrics.Span("gr.refine.forward", "gr.refine.chunk", 0, 3.0),
         metrics.Span("gr.refine.backward", "gr.refine.chunk", 0, 6.0),
         metrics.Span("gr.refine.forward", "gr.refine.chunk", 0, 5.0),
         metrics.Span("gr.train.d_step", "gr.train.epoch", 1, 10.0),
         metrics.Span("gr.optim.update", "gr.train.d_step", 1, 1.0),
         metrics.Span("gr.train.g_step", "gr.train.epoch", 1, 20.0),
         metrics.Span("gr.optim.update", "gr.train.g_step", 1, 2.0),
         metrics.Span("gr.train.d_step", "gr.train.epoch", 2, 12.0),
         metrics.Span("gr.optim.update", "gr.train.d_step", 2, 3.0),
         metrics.Span("gr.train.g_step", "gr.train.epoch", 2, 22.0),
         metrics.Span("gr.optim.update", "gr.train.g_step", 2, 4.0)]


@pytest.mark.parametrize("name,want", [
    ("refine_forward_ms.refine", 4.0),   # the mean of a span
    ("refine_backward_ms.refine", 6.0),
    ("d_step_ms.train", 11.0),           # per traced step (2)
    ("g_step_ms.train", 21.0),
    ("update_ms.train", 5.0),
])
def test_store_readers(monkeypatch, name, want):
    monkeypatch.setattr(metrics, "spans", lambda: STORE)
    assert harness.reader(name)(run_of(PROGRAM)) == pytest.approx(want)


@pytest.mark.parametrize("name", STORE_READERS)
def test_store_readers_read_none(monkeypatch, name):
    read = harness.reader(name)
    monkeypatch.setattr(metrics, "spans", lambda: STORE)
    assert read(SimpleNamespace(trace=None)) is None          # no trace
    monkeypatch.setattr(metrics, "spans", lambda: [])
    assert read(run_of(PROGRAM)) is None                      # no span
    monkeypatch.setattr(metrics, "spans", lambda: [
        s._replace(device_ms=None) for s in STORE])
    assert read(run_of(PROGRAM)) is None                      # off the card
    monkeypatch.delattr(metrics, "spans")
    assert read(run_of(PROGRAM)) is None                      # no store
