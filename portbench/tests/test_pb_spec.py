"""BENCHMARK.json and the files it names: every cell resolves to a
configuration, a traffic file with its driver, a limits file and a reader
for each of its metrics; the contract's names and keys hold."""
import importlib.util
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.resolve(ROOT, cell)
    assert c.chips == 1
    assert hasattr(c.driver, "setup") and hasattr(c.driver, "counts")
    reported = {m["name"] for m, _ in c.e2e}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m, read in c.per_layer:
        assert callable(read)
        assert m["moves"] in reported
    limits = json.loads((ROOT / "portbench" / "workloads"
                         / f"{cell}.json").read_text())["limits"]
    for key, v in limits.items():
        assert v["limit"] > 0, key


def test_names_units_and_files():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + CELLS
    assert len(set(names)) == len(names)
    for name in names:
        assert NAME.match(name), name
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert harness.reader_path(m["name"]).is_file(), m["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["reduced"] == []
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"programs", "search", "refinement", "train steps",
                      "optimizer", "fast forwards", "modules", "kernels",
                      "device", "whole step"}


def test_every_reader_loads():
    for path in (ROOT / "portbench" / "metrics").glob("*.py"):
        spec = importlib.util.spec_from_file_location("m", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read), path


def test_reader_falls_back_to_the_stem():
    assert harness.reader_path("idle_share.train").name == "idle_share.py"
    assert harness.reader_path("kernel_roofline.e2e").name == \
        "kernel_roofline.e2e.py"


def test_missing_reader_or_driver_fails_loudly():
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.train")
    with pytest.raises(FileNotFoundError):
        harness.driver("no_such_driver")


def test_reservoir_is_uniform_and_seeded():
    picks = []
    for seed in range(2000):
        r = harness.Reservoir(1, seed)
        for i in range(4):
            r.offer(i)
        picks.append(r.items[0])
    counts = [picks.count(i) for i in range(4)]
    assert min(counts) > 400
    a, b = harness.Reservoir(2, 7), harness.Reservoir(2, 7)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_run_without_a_card_fails_and_prints_no_result():
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
