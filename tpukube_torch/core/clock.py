"""Injectable clocks — the port's own copy of ``tpukube/core/clock.py``.

Scheduling-semantic time (gang reservation TTLs, the extender's
pending-webhook pruning) reads time through one of these objects instead
of the ``time`` module, so tests can move time forward instantly:

  * :class:`SystemClock` — the production clock: thin pass-throughs to
    ``time.monotonic``/``time.time``/``time.sleep``; the default.
  * :class:`FakeClock`  — a discrete-event clock: ``sleep``/``advance``
    move simulated time forward instantly, firing any timers scheduled
    with :meth:`schedule` in deadline order (each callback observes
    ``monotonic()`` == its own deadline).

Latency MEASUREMENT stays on the real ``time.perf_counter``/
``time.monotonic``: a fake-clock run still reports how long the
scheduler actually took.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable


class SystemClock:
    """The real clock. One shared instance (:data:`SYSTEM`) is enough —
    it holds no state."""

    def monotonic(self) -> float:
        return time.monotonic()

    def time(self) -> float:
        return time.time()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


#: process-wide default; ``clock=None`` parameters resolve to this
SYSTEM = SystemClock()


class FakeClock:
    """Discrete-event fake clock for the sim harness.

    ``sleep(s)`` and ``advance(s)`` move simulated time forward and run
    every timer whose deadline falls inside the window, in deadline
    order (FIFO among equal deadlines). Timer callbacks run on the
    advancing thread with the clock set to their own deadline — a
    callback scheduling another timer inside the window is honored in
    the same advance. Thread-safe: the sim's effector threads may read
    ``monotonic()`` while a scenario thread advances.

    ``epoch`` anchors ``time()`` (wall clock) so journal/statusz
    timestamps stay plausible; ``monotonic()`` starts at 0.0 like a
    freshly booted process.
    """

    def __init__(self, epoch: float = 1_700_000_000.0) -> None:
        self._lock = threading.RLock()
        self._now = 0.0
        self._epoch = epoch
        self._seq = itertools.count()  # FIFO tie-break among deadlines
        self._timers: list[tuple[float, int, Callable[[], Any]]] = []

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def time(self) -> float:
        with self._lock:
            return self._epoch + self._now

    def sleep(self, seconds: float) -> None:
        """A fake sleep IS an advance: the sleeper's wait elapses
        instantly in wall time while every timer due in the window
        fires exactly as it would have during a real sleep."""
        self.advance(seconds)

    def schedule(self, delay: float, fn: Callable[[], Any]) -> None:
        """Run ``fn`` once ``delay`` seconds of simulated time elapse
        (fires during the ``advance``/``sleep`` that crosses it)."""
        with self._lock:
            heapq.heappush(
                self._timers,
                (self._now + max(0.0, delay), next(self._seq), fn),
            )

    def pending_timers(self) -> int:
        with self._lock:
            return len(self._timers)

    def advance(self, seconds: float) -> None:
        """Advance simulated time by ``seconds`` (>= 0), firing due
        timers in deadline order. Callbacks run OUTSIDE the clock's
        internal lock (they may read the clock or schedule more work)."""
        if seconds < 0:
            raise ValueError(f"cannot advance time backwards ({seconds})")
        with self._lock:
            target = self._now + seconds
        while True:
            fn = None
            with self._lock:
                if self._timers and self._timers[0][0] <= target:
                    deadline, _, fn = heapq.heappop(self._timers)
                    # the discrete-event contract: the callback observes
                    # the clock AT its own deadline
                    self._now = max(self._now, deadline)
                else:
                    self._now = target
            if fn is None:
                return
            fn()
