"""Maintenance-event and spot-churn chaos — the port's own copy of
``tpukube/chaos/maintenance.py``.

Region-scale fleets lose capacity two ways that scenario 15 must
reproduce deterministically:

  * **maintenance events** — a whole slice leaves for planned work
    (firmware, recabling) and usually RETURNS later. The graceful path
    is the drain choreography (``sched/drain.py``); the chaos schedule
    decides WHICH slice goes next and whether it comes back.
  * **spot churn** — individual nodes vanish with no notice (preempted
    spot/ephemeral capacity): no cordon, no budgeted migration — the
    pods are simply gone and the control plane must converge anyway.

Both schedules follow the chaos layer's determinism contract
(:mod:`tpukube_torch.chaos.schedule`): one seeded RNG drawn in call order,
draws consume the RNG even while stopped, every injected event is
recorded for the scenario report. Same seed + same call sequence =
the same storm.
"""

from __future__ import annotations

import threading
from random import Random
from typing import Any, Optional


class MaintenanceSchedule:
    """Seeded chooser of the next slice to take for maintenance.

    The first ``len(slice_ids)`` picks are a seeded permutation of ALL
    slices — a storm with at least that many events provably maintains
    every slice — and later picks are uniform. ``returns`` draws
    whether the slice's capacity comes back afterwards (probability
    ``return_rate``); a storm mixing both arms exercises scale-down
    (gone for good) and maintenance (drain, then re-ingest).
    """

    def __init__(self, seed: int, slice_ids, return_rate: float = 0.5,
                 budget: Optional[int] = None) -> None:
        self.seed = seed
        self.return_rate = return_rate
        self.budget = budget
        self._rng = Random(seed)
        self._slices = tuple(slice_ids)
        first = list(self._slices)
        self._rng.shuffle(first)
        self._first = first
        self._lock = threading.Lock()
        self._stopped = False
        self.events: list[dict[str, Any]] = []

    def stop(self) -> None:
        """Cease injecting (draws still consume the RNG)."""
        with self._lock:
            self._stopped = True

    def resume(self) -> None:
        with self._lock:
            self._stopped = False

    def _armed_locked(self) -> bool:
        if self._stopped:
            return False
        return self.budget is None or len(self.events) < self.budget

    def next_event(self) -> Optional[tuple[str, bool]]:
        """(slice_id, returns) for the next maintenance event, or None
        when stopped/out of budget. Both draws always consume the RNG
        so toggling the budget never reshuffles later decisions."""
        with self._lock:
            if self._first:
                sid = self._first.pop(0)
            else:
                sid = self._slices[self._rng.randrange(len(self._slices))]
            returns = self._rng.random() < self.return_rate
            if not self._armed_locked():
                return None
            self.events.append(
                {"seq": len(self.events) + 1, "slice": sid,
                 "returns": returns})
            return sid, returns

    def report(self) -> dict[str, Any]:
        with self._lock:
            return {
                "seed": self.seed,
                "events": len(self.events),
                "slices": [e["slice"] for e in self.events],
                "returned": sum(1 for e in self.events if e["returns"]),
            }


class SpotChurnSchedule:
    """Seeded no-notice node killer: each ``draw_kill`` decides whether
    ONE node of the offered set vanishes right now. Exactly two RNG
    draws per call (the kill coin and the victim index) whether or not
    a kill fires — the determinism contract again."""

    def __init__(self, seed: int, kill_rate: float,
                 budget: Optional[int] = None) -> None:
        self.seed = seed
        self.kill_rate = kill_rate
        self.budget = budget
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self._stopped = False
        self.kills: list[dict[str, Any]] = []

    def stop(self) -> None:
        with self._lock:
            self._stopped = True

    def resume(self) -> None:
        with self._lock:
            self._stopped = False

    def _armed_locked(self) -> bool:
        if self._stopped:
            return False
        return self.budget is None or len(self.kills) < self.budget

    def draw_kill(self, node_names) -> Optional[str]:
        """The node to rip out with no notice, or None."""
        names = sorted(node_names)
        with self._lock:
            r = self._rng.random()
            idx = self._rng.randrange(len(names)) if names else 0
            if not names or r >= self.kill_rate:
                return None
            if not self._armed_locked():
                return None
            victim = names[idx]
            self.kills.append(
                {"seq": len(self.kills) + 1, "node": victim})
            return victim

    def report(self) -> dict[str, Any]:
        with self._lock:
            return {
                "seed": self.seed,
                "kills": len(self.kills),
                "nodes": [k["node"] for k in self.kills],
            }
