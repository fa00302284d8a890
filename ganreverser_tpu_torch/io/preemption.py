"""Preemption-safe checkpointing — ganreverser_tpu/io/preemption.py,
vendored.

A scheduler that preempts a job sends SIGTERM (an operator, SIGINT); the
guard latches the signal into a flag, so that a training loop finishes its
current segment, checkpoints and exits cleanly:

    guard = PreemptionGuard()
    while ...:
        ...train...
        if guard.should_stop:
            save(); break
    guard.restore()
"""
from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    """Latches SIGTERM/SIGINT into a flag; second signal restores default
    behavior (so a stuck save can still be killed)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._signals = signals
        self._previous = {}
        for sig in signals:
            try:
                self._previous[sig] = signal.signal(sig, self._handler)
            except ValueError:
                # not the main thread (e.g. under a test runner) — inert
                pass

    def _handler(self, signum, frame):
        if self._stop.is_set():
            # second signal: give up gracefully-stopping, restore default
            signal.signal(signum, signal.SIG_DFL)
            raise KeyboardInterrupt
        print(f"<trainer> received signal {signum}: finishing step, "
              "checkpointing, exiting", flush=True)
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def trigger(self):
        """For tests: simulate a preemption signal."""
        self._stop.set()

    def restore(self):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
