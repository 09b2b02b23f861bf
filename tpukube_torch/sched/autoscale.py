"""Fleet autoscaler loop — the port's own copy of
``tpukube/sched/autoscale.py``: grow/shrink the fleet against queue
depth and tenant SLO burn.

Scale-UP watches the batch queue (``SchedulingCycle.queue_depth``) and
the tenancy plane's SLO-burn verdict (``BurnMonitor.last_page_burning``
— read-only; the admission path slides the windows): sustained depth
at or above ``autoscale_up_queue_depth``, or a burning page, provisions
one new slice through the **bulk-ingest** fast path (one recorded
``upsert_nodes`` decision, one epoch/delta/journal seam). The
provisioner itself is injected (``set_provisioner``) — the sim harness
mints node items; a cloud deployment would call its instance API. No
provisioner means scale-up silently skips (the loop still shrinks).

Scale-DOWN watches utilization: when the fleet idles below
``autoscale_down_utilization`` with an empty queue, the EMPTIEST slice
drains through the DrainCoordinator's graceful choreography (cordon →
budgeted migrate-or-preempt → un-ingest) — which is why
``autoscale_enabled`` requires ``drain_enabled``. Slice-count bounds
(``autoscale_min_slices`` / ``autoscale_max_slices``) and a cooldown
(``autoscale_cooldown_seconds``, scheduling clock — FakeClock
compressible) keep the loop from flapping.

Ticks are amortized onto the decision path like the drain's
(``Extender.handle`` calls ``maybe_tick`` under the decision lock);
the sim drives ``tick()`` directly. Nothing is constructed with the
flag off; no ``tpukube_autoscaler_*`` series render.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Optional

log = logging.getLogger("tpukube_torch.autoscale")


class Autoscaler:
    """One per extender. ``self._lock`` is a LEAF for counters; fleet
    mutations run under the extender's decision lock (``tick`` takes
    it; ``maybe_tick`` is called while it is held — RLock)."""

    def __init__(self, extender, config) -> None:
        self.ext = extender
        self._config = config
        self._lock = threading.Lock()
        #: provisioner: () -> list of {"name", "annotations"} node
        #: items forming ONE new slice (injected by the harness/cloud)
        self._provision: Optional[Callable[[], list]] = None
        self._last_action = -float("inf")
        # scale-up ingests through handle("upsert_nodes"), whose tail
        # calls maybe_tick again — guard against re-entering the
        # evaluation mid-action (flips only under the decision lock)
        self._ticking = False
        # counters (tpukube_autoscaler_* series; rendered only when on)
        self.scale_ups = 0
        self.scale_downs = 0
        self.nodes_added_total = 0
        self.ticks = 0
        self.last_decision = "idle"

    def set_provisioner(self, fn: Callable[[], list]) -> None:
        self._provision = fn

    # -- the loop ----------------------------------------------------------
    def maybe_tick(self) -> None:
        """Amortized driver (caller holds the decision lock): a clock
        read per decision; the real evaluation runs at cooldown
        cadence."""
        if self._ticking:
            return
        now = self.ext.clock.monotonic()
        if now - self._last_action < self._config.autoscale_cooldown_seconds:
            return
        self.tick()

    def tick(self) -> str:
        """One scaling evaluation; returns the decision taken
        ("up" / "down" / "idle"). The cooldown stamps only on action,
        so a quiet fleet re-evaluates freely and a scaling one
        settles between moves."""
        ext = self.ext
        with ext._decision_lock:
            if self._ticking:
                return "idle"
            self._ticking = True
            try:
                return self._tick_locked()
            finally:
                self._ticking = False

    def _tick_locked(self) -> str:
        ext = self.ext
        cfg = self._config
        with self._lock:
            self.ticks += 1
        depth = (ext.cycle.queue_depth()
                 if ext.cycle is not None else 0)
        burning = (ext.tenants is not None
                   and ext.tenants.burn.last_page_burning())
        n_slices = len(ext.state.slice_ids())
        decision = "idle"
        if ((depth >= cfg.autoscale_up_queue_depth or burning)
                and n_slices < cfg.autoscale_max_slices):
            if self._scale_up(depth, burning):
                decision = "up"
        elif (depth == 0
              and ext.state.utilization()
              < cfg.autoscale_down_utilization
              and n_slices > cfg.autoscale_min_slices
              and ext.drain is not None
              and not ext.drain.active()):
            if self._scale_down():
                decision = "down"
        if decision != "idle":
            self._last_action = ext.clock.monotonic()
        with self._lock:
            self.last_decision = decision
        return decision

    def _scale_up(self, depth: int, burning: bool) -> bool:
        """Provision one slice and bulk-ingest it (one recorded
        decision — time-to-capacity is one seam, not O(nodes))."""
        if self._provision is None:
            return False
        try:
            items = list(self._provision())
        except Exception:
            log.exception("autoscaler provisioner failed")
            return False
        if not items:
            return False
        results = self.ext.handle("upsert_nodes", {"items": items})[
            "results"]
        errors = sum(1 for r in results
                     if isinstance(r, dict) and r.get("error"))
        with self._lock:
            self.scale_ups += 1
            self.nodes_added_total += len(items) - errors
        self.ext._emit_event(
            "AutoscaleUp", "autoscaler",
            f"provisioned {len(items)} node(s) ({errors} error(s)): "
            f"queue depth {depth}, slo burning: {bool(burning)}",
            warning=False,
        )
        log.warning("autoscaler: scale-up of %d node(s) "
                    "(depth %d, burning %s)", len(items), depth, burning)
        return True

    def _scale_down(self) -> bool:
        """Drain the emptiest slice through the graceful choreography
        (the drain owns eviction budgets and the final un-ingest)."""
        ext = self.ext
        snap = ext.snapshots.current()
        sids = snap.slice_ids()
        if len(sids) <= self._config.autoscale_min_slices:
            return False
        target = min(sids, key=lambda s: (snap.slice(s).utilization, s))
        nodes = [n for n in ext.state.node_names()
                 if ext.state.slice_of_node(n) == target]
        if not nodes:
            return False
        drain_id = ext.drain.begin(nodes, reason="autoscale-down")
        with self._lock:
            self.scale_downs += 1
        self.ext._emit_event(
            "AutoscaleDown", "autoscaler",
            f"draining slice {target} ({len(nodes)} node(s)) as "
            f"{drain_id}",
            warning=False,
        )
        log.warning("autoscaler: scale-down drains slice %s "
                    "(%d nodes, %s)", target, len(nodes), drain_id)
        return True

    # -- inspection --------------------------------------------------------
    def statusz(self) -> dict[str, Any]:
        with self._lock:
            return {
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "nodes_added_total": self.nodes_added_total,
                "ticks": self.ticks,
                "last_decision": self.last_decision,
                "provisioner": self._provision is not None,
            }

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "nodes_added": self.nodes_added_total,
                "ticks": self.ticks,
            }
