"""Seeded fault schedule: the chaos layer's single source of randomness.
The port's own copy of ``tpukube/chaos/schedule.py``: the same seed draws the
same faults in the same order on both packages.

Every injection point (ChaosApiServer unary calls, watch-event fates)
asks the schedule what to do; the schedule draws from one
``random.Random(seed)`` in call order and logs what it injected. Same
seed + same call sequence = same faults — which is what makes the chaos
scenarios assertable instead of flaky.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from random import Random
from typing import Any, Optional

#: unary fault kinds, in the order one uniform draw is partitioned
#: (order is part of the determinism contract — do not reorder)
TORN, ERROR, TIMEOUT, SLOW = "torn", "error", "timeout", "slow"


@dataclass(frozen=True)
class ChaosSpec:
    """Per-call fault probabilities. All default 0.0 = no injection.

    ``torn_rate`` only applies to mutating ops (the write is APPLIED,
    then the response is "lost" — the ambiguous-outcome case real
    apiservers produce under connection resets, and the reason every
    writer must be idempotent-retry-safe). ``gone_rate`` applies to
    watch subscriptions (410 Gone -> list+watch resync).
    """

    error_rate: float = 0.0     # injected HTTP 503
    timeout_rate: float = 0.0   # injected transport error (code None)
    torn_rate: float = 0.0      # write applied, response lost
    slow_rate: float = 0.0      # response delayed by slow_seconds
    slow_seconds: float = 0.005
    gone_rate: float = 0.0      # 410 Gone on watch subscribe
    drop_event_rate: float = 0.0
    dup_event_rate: float = 0.0


@dataclass
class InjectedFault:
    seq: int
    op: str
    kind: str
    detail: str = ""

    def as_dict(self) -> dict[str, Any]:
        return {"seq": self.seq, "op": self.op, "kind": self.kind,
                "detail": self.detail}


class FaultSchedule:
    """Draws fault decisions deterministically and records them.

    ``budget`` caps the total number of injected faults (None =
    unlimited): scenarios set it so the storm provably ends and the
    convergence assertions run against a quiet control plane.
    ``stop()`` ends injection early (the scenario's "chaos off"
    switch); draws keep consuming the RNG identically either way, so
    toggling the budget does not reshuffle later decisions.
    """

    def __init__(self, seed: int, spec: ChaosSpec,
                 budget: Optional[int] = None) -> None:
        self.seed = seed
        self.spec = spec
        self.budget = budget
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self._stopped = False
        self.faults: list[InjectedFault] = []

    # -- control -----------------------------------------------------------
    def stop(self) -> None:
        """Cease injecting (draws still consume the RNG)."""
        with self._lock:
            self._stopped = True

    def resume(self, spec: Optional[ChaosSpec] = None) -> None:
        with self._lock:
            self._stopped = False
            if spec is not None:
                self.spec = spec

    def _armed_locked(self) -> bool:
        if self._stopped:
            return False
        return self.budget is None or len(self.faults) < self.budget

    def _note_locked(self, op: str, kind: str, detail: str = "") -> None:
        self.faults.append(
            InjectedFault(len(self.faults) + 1, op, kind, detail)
        )

    # -- draws -------------------------------------------------------------
    def draw_unary(self, op: str, mutating: bool) -> Optional[str]:
        """Fault kind for one unary API call, or None. One uniform per
        call, partitioned torn|error|timeout|slow in declared order."""
        with self._lock:
            r = self._rng.random()  # always consumed: determinism
            if not self._armed_locked():
                return None
            spec = self.spec
            edge = spec.torn_rate if mutating else 0.0
            if r < edge:
                self._note_locked(op, TORN)
                return TORN
            edge += spec.error_rate
            if r < edge:
                self._note_locked(op, ERROR)
                return ERROR
            edge += spec.timeout_rate
            if r < edge:
                self._note_locked(op, TIMEOUT)
                return TIMEOUT
            edge += spec.slow_rate
            if r < edge:
                self._note_locked(op, SLOW)
                return SLOW
            return None

    def draw_watch_gone(self, op: str) -> bool:
        """True = reject this watch subscription with 410 Gone."""
        with self._lock:
            r = self._rng.random()
            if not self._armed_locked():
                return False
            if r < self.spec.gone_rate:
                self._note_locked(op, "gone", "410 on subscribe")
                return True
            return False

    def event_fate(self, op: str) -> str:
        """'deliver' | 'drop' | 'dup' for one watch event."""
        with self._lock:
            r = self._rng.random()
            if not self._armed_locked():
                return "deliver"
            spec = self.spec
            if r < spec.drop_event_rate:
                self._note_locked(op, "drop_event")
                return "drop"
            if r < spec.drop_event_rate + spec.dup_event_rate:
                self._note_locked(op, "dup_event")
                return "dup"
            return "deliver"

    # -- reporting ---------------------------------------------------------
    def injected(self) -> int:
        with self._lock:
            return len(self.faults)

    def by_kind(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for f in self.faults:
                out[f.kind] = out.get(f.kind, 0) + 1
            return out

    def report(self) -> dict[str, Any]:
        """JSON-able summary for scenario results."""
        with self._lock:
            out: dict[str, int] = {}
            for f in self.faults:
                out[f.kind] = out.get(f.kind, 0) + 1
            return {
                "seed": self.seed,
                "injected": len(self.faults),
                "by_kind": out,
                "budget": self.budget,
            }
