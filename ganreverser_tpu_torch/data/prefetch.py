"""Host -> device prefetching — the counterpart of
ganreverser_tpu/data/prefetch.py.

A background thread makes the next batch on the host while the card trains
on the current one. For a CUDA device it copies each batch from pinned
host memory on a side stream and waits for that copy on its own thread, so
the pinned buffer lives until the copy has completed; the consumer's stream
then waits on the copy's event, and the tensor is marked as used by that
stream for PyTorch's allocator. On the CPU there is no pinning and no
stream. An exception in the worker is re-raised in the consumer, never a
hang. Closing the iterator waits for the worker to finish the batch it is
making, so no copy to the card is left running (at interpreter exit a
thread still inside a CUDA call aborts the process).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch


class _WorkerError:
    """An exception of the worker thread, re-raised by the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _to_device(host: np.ndarray, device: torch.device, stream):
    """(tensor on ``device``, event of its copy or None)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type != "cuda":
        return t.to(device), None
    pinned = t.pin_memory()
    with torch.cuda.stream(stream):
        dev = pinned.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    event.synchronize()  # on the worker: ``pinned`` outlives the copy
    return dev, event


def prefetch_to_device(batch_fn: Callable[[int], np.ndarray], n_batches: int,
                       *, device: torch.device | str = "cpu",
                       depth: int = 2) -> Iterator[torch.Tensor]:
    """Yield ``n_batches`` tensors on ``device``: ``batch_fn(i)`` (a host
    array) made on a background thread up to ``depth`` batches ahead and
    copied to the device there. ``n_batches < 0`` is endless."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    stream = (torch.cuda.Stream(device=device) if device.type == "cuda"
              else None)

    def worker():
        i = 0
        try:
            while not stop.is_set() and (n_batches < 0 or i < n_batches):
                q.put(_to_device(batch_fn(i), device, stream))
                i += 1
        except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
            q.put(_WorkerError(e))
        finally:
            q.put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, _WorkerError):
                raise item.exc
            tensor, event = item
            if event is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                tensor.record_stream(consumer)
            yield tensor
    finally:
        stop.set()
        while t.is_alive():  # let a worker blocked on put() see ``stop``
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass
