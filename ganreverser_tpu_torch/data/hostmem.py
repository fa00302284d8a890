"""Host-allocator tuning for the ingest path — a copy of
ganreverser_tpu/data/hostmem.py.

Found by the JAX package's ingest measurements: numpy madvises
MADV_HUGEPAGE on every allocation >= 4MB, and with kernel THP defrag set
to 'madvise' each huge-page fault on such a buffer performs SYNCHRONOUS
direct compaction. After a JPEG decode loop has churned the heap with
thousands of ~50-110KB image buffers, free memory is fragmented enough
that the first touch of a fresh batch tensor (the np.stack output, or the
colorspace conversion's output buffer) stalls ~5 ms PER FAULT in the
kernel: measured 2.9 s wall / 2.8 s system time for one 50MB rgb2yuv
call that takes 40 ms with the madvise disabled (72x).

Huge pages buy nothing here — these buffers live for one batch and are
bandwidth-bound through a single core — so the loader turns the madvise
off process-wide the first time a Dataset is constructed. Device memory
and PyTorch's pinned host buffers are allocated elsewhere and are
unaffected.

The reference's loader (dataset.lua:99-131) never hits this class of
problem only because Torch7's allocator predates THP-aware madvise.
"""
from __future__ import annotations

_applied = False


def disable_hugepage_madvise() -> None:
    """Idempotently turn off numpy's MADV_HUGEPAGE hint (no-op if the
    private numpy hook is unavailable)."""
    global _applied
    if _applied:
        return
    _applied = True
    try:
        try:
            from numpy._core import multiarray as _m  # numpy >= 2.0
        except ImportError:  # pragma: no cover - numpy 1.x
            from numpy.core import multiarray as _m
        _m._set_madvise_hugepage(False)
    except Exception:  # pragma: no cover - hook gone in a future numpy
        pass
