"""The trace summariser on synthetic traces."""
import json

import pytest

from portbench import tracing


def make_trace(ops, host=(), window=(0.0, 100.0), steps=2):
    return tracing.Trace(list(ops), list(host), window, steps)


def test_union_counts_overlaps_once():
    ivs = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 21, 22)]
    assert tracing.union_us(ivs) == 25


def test_busy_and_idle_inside_the_window():
    t = make_trace([("k", -10, 10), ("k", 40, 60), ("k", 90, 120)])
    assert tracing.busy_s(t) == pytest.approx(40e-6)
    assert tracing.idle_share(t) == pytest.approx(0.6)


def test_classes_first_match_and_shares():
    classes = [["tc", ["wgmma_kernel"]], ["conv", ["fprop"]],
               ["ew", ["elementwise"]]]
    t = make_trace([("conv3x3_wgmma_kernel<64>", 0, 10),
                    ("sm90_xmma_fprop", 10, 30),
                    ("vectorized_elementwise_kernel", 30, 40),
                    ("memcpy", 40, 50)])
    assert tracing.kernel_class("sm90_xmma_fprop", classes) == "conv"
    assert tracing.kernel_class("memcpy", classes) == "other"
    assert tracing.class_time_s(t, classes, {"conv", "ew"}) == pytest.approx(
        30e-6)
    assert tracing.device_time_s(t, ["WGMMA"]) == pytest.approx(10e-6)
    assert tracing.top_device_ops(t, 1) == [["sm90_xmma_fprop",
                                             pytest.approx(20e-6)]]


def test_idle_gaps_named_by_innermost_host_op():
    t = make_trace([("k", 10, 20), ("k", 60, 100)],
                   host=[("step", 0, 100), ("aten::copy_", 25, 55),
                         ("cudaLaunchKernel", 1, 8)])
    gaps = dict(tracing.idle_gaps(t))
    assert gaps["aten::copy_"] == pytest.approx(40e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)


def test_read_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
         "ts": 100, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 200, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 400,
         "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation", "name": tracing.WINDOW,
         "ts": 100, "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 150,
         "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = tracing.read_chrome_trace(str(path), 3)
    assert [o[0] for o in t.ops] == ["k1", "Memcpy DtoD"]
    assert t.window_s == pytest.approx(1e-3)
    assert [h[0] for h in t.host] == ["aten::mm"]
    assert tracing.idle_share(t) == pytest.approx(0.85)
