"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, the result line.

Everything a cell is made of is found by name:

* ``BENCHMARK.json`` (at the root of the checkout) names the cell's
  configuration and traffic, and lists the metrics each cell reports;
* ``configs/<config>.json``: the model's sizes and compute type;
* ``traffic/<traffic>.json``: the entry's driver (``drivers/<driver>.py``)
  and its parameters;
* ``workloads/<cell>.json``: the limits of the numbers that decide
  ``correct``;
* ``metrics/<metric>.py``, or ``metrics/<stem>.py`` for a metric
  ``<stem>.<part>`` without a file of its own: the reader, ``read(run)``,
  which returns a number or None (nothing to read: the metric is left
  out).

A driver module has ``prepare(cell) -> inputs`` (the weights and data the
benchmark makes; the memory peak is read from after it), ``setup(cell,
inputs) -> state`` (the program's set-up), ``step(state)`` (one call of
the entry; ``SYNC_EACH_STEP`` says whether the window waits for the device
after each), ``units_per_step(cell)``, ``release(state)`` (after the
window and the memory peak's reading: takes what the comparison still needs
of the program, such as training's batches after the window, then drops the
program before the reference runs), ``check(state) -> {name: number}`` and
``counts(cell) -> dict`` (the operations and bounds the readers use).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import tracing

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ganreverser_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def sub_seed(seed: int, stream: int) -> int:
    """The seed of one of a run's random streams: ``seed`` + stream * 2**32,
    modulo 2**64, so that every stream of every seed differs."""
    return (seed + (stream << 32)) % (1 << 64)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


class Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from
    ``seed``, whatever their number (reservoir sampling)."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self.rng = random.Random(seed)

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def spec(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: dict, cell: str, e2e_of_cell) -> bool:
    """Whether ``cell`` reports ``metric``: it lists the cell, or lists no
    cells and moves (or is) an end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_of_cell is None or metric.get("moves") in e2e_of_cell


def metrics_of(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if applies(m, cell, None)]
    names = {m["name"] for m in e2e}
    return e2e, [m for m in bench["per_layer"] if applies(m, cell, names)]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or where there is none ``metrics/<stem>.py``,
    the stem being the name before its first dot (``idle_share.train`` is
    read by ``idle_share.py``, the reader of every cell's idle share)."""
    path = HERE / "metrics" / f"{name}.py"
    if path.is_file() or "." not in name:
        return path
    return HERE / "metrics" / f"{name.split('.')[0]}.py"


def reader(name: str):
    """``read`` of the metric's reader; raises where there is none."""
    path = reader_path(name)
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    path = HERE / "drivers" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"driver {name!r} has no module at {path}")
    return importlib.import_module(f"portbench.drivers.{name}")


def resolve(root: Path, name: str, overrides: dict | None = None):
    """The cell ``name`` with its configuration, traffic and limits, and
    its metrics with their readers and its driver."""
    bench = spec(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    overrides = overrides or {}
    config = load_json(HERE / "configs" / f"{entry['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(HERE / "workloads" / f"{name}.json")["limits"]
    config.update(overrides.get("config", {}))
    traffic.update(overrides.get("traffic", {}))
    e2e, per_layer = metrics_of(bench, name)
    return SimpleNamespace(
        name=name, chips=entry["chips"], config=config, traffic=traffic,
        limits={k: v["limit"] for k, v in limits.items()},
        e2e=[(m, reader(m["name"])) for m in e2e],
        per_layer=[(m, reader(m["name"])) for m in per_layer],
        driver=driver(traffic["driver"]),
        kernels=load_json(HERE / "kernels.json"))


def card_info(device) -> dict:
    """The card's name, and its power limit as ``nvidia-smi`` reads it."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": "none"}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            timeout=30).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        limit = "unknown"
    return {"name": torch.cuda.get_device_name(device), "power_limit": limit}


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run(name: str, seed: int, seconds: float, trace: bool, *, root: Path,
        t_start: float, device=None, control: bool = False,
        overrides: dict | None = None, readings: bool = False) -> dict:
    """One run of the cell ``name``; returns the result line's object (with
    ``readings``, also every number the correctness check read, compared
    or not, under ``readings``)."""
    t_run = time.perf_counter()
    device = torch.device(device or "cuda:0")
    cell = resolve(root, name, overrides)
    cell.seed, cell.device, cell.control = seed, device, control
    on_card = device.type == "cuda"
    card = card_info(device)
    log(f"cell {name}, seed {seed}, {seconds} s, trace {int(trace)}"
        f"{', control' if control else ''}: {card['name']} x{cell.chips}, "
        f"power limit {card['power_limit']}")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    drv = cell.driver
    t_card = time.perf_counter()
    inputs = drv.prepare(cell)
    sync()
    t_prepared = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    state = drv.setup(cell, inputs)
    sync()

    step_s, steps = [], 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    log(f"set-up {setup_s:.3f} s: start to harness {t_run - t_start:.3f}, "
        f"cell and card {t_card - t_run:.3f}, weights and data "
        f"{t_prepared - t_card:.3f}, the program's set-up and first calls "
        f"{t0 - t_prepared:.3f}")
    while True:
        s = time.perf_counter()
        drv.step(state)
        if drv.SYNC_EACH_STEP:
            sync()
            step_s.append(time.perf_counter() - s)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0

    traced = None
    if trace:
        def traced_step():
            drv.step(state)
            if drv.SYNC_EACH_STEP:
                sync()
        traced = tracing.traced_window(traced_step,
                                       int(cell.traffic["trace_steps"]), sync)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    drv.release(state)
    if on_card:
        torch.cuda.empty_cache()

    checks = drv.check(state)
    units = steps * drv.units_per_step(cell)
    runinfo = SimpleNamespace(
        cell=cell, setup_s=setup_s, window_s=window_s, steps=steps,
        units=units, step_s=step_s or None, counts=drv.counts(cell),
        trace=traced, card=card)
    metrics = {}
    for m, read in (cell.per_layer if trace else cell.e2e):
        value = read(runinfo)
        if value is None:
            log(f"{m['name']}: nothing to read in this run, left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        log(f"{m['name']} {value} {m['unit']}")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": card["name"], "count": cell.chips,
                   "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": steps, "failed": 0,
              "metrics": metrics, "device": device_info}
    if traced is not None:
        device_info["busy_s"] = tracing.busy_s(traced)
        device_info["window_s"] = traced.window_s
        result["breakdown"] = {"device_ops": tracing.top_device_ops(traced),
                               "idle_gaps": tracing.idle_gaps(traced)}
    compared = {key: {"value": checks[key], "limit": limit}
                for key, limit in cell.limits.items()}
    result["correct"] = all(math.isfinite(c["value"]) and c["value"] <= c[
        "limit"] for c in compared.values())
    if readings:
        result["readings"] = checks
    result["checks"] = compared
    return result
