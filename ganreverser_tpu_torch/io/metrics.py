"""Scalar metrics as a JSONL event file — ``MetricsWriter.scalar`` of
ganreverser_tpu/io/metrics.py for one process: one record per line,
``{"tag", "value", "wall"[, "step"]}``, ``wall`` in seconds since the
writer opened. The image grids, charts and the step timer come with the
CLIs that use them."""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsWriter:
    """Appends scalars to ``<save_dir>/<name>.jsonl``; close it, or use it
    as a context manager."""

    def __init__(self, save_dir: str, name: str = "events"):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def scalar(self, tag: str, value, step: Optional[int] = None, **extra):
        rec = {"tag": tag, "value": float(value),
               "wall": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
