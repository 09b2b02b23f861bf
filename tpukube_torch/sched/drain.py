"""Graceful drain / decommission choreography — the port's own copy of
``tpukube/sched/drain.py``.

Bulk ingest makes capacity *arrival* O(Δ); this module owns the other
direction. A drain takes a node set (usually a whole slice) out of
service in three phases, none of which is a full rebuild:

  1. **Cordon** — ``ClusterState.set_cordon`` marks the nodes; their
     chips leave every placement sweep (``SliceSnapshot.blocked_sweep``
     masks them like occupancy) while live allocations keep serving.
     One epoch/delta/journal seam per batch, so the cordon rides the
     WAL and checkpoints like any other ledger mutation.
  2. **Migrate-or-preempt** — residents are evicted through the SAME
     victim machinery gang preemption uses (``Extender._apply_victims``:
     gangs dissolve wholesale, plain pods release + queue on the
     eviction bus), under a bounded disruption budget: at most
     ``drain_max_concurrent_moves`` workloads per tick, cheapest
     priority first, at most ``drain_tenant_budget`` pods per tenant
     per tick (0 = uncapped). Each evicted pod's provenance chain gains
     a ``drain_evict`` stage naming the drain (``Extender._note_decision``)
     — "where did my chips go" answers "maintenance", not silence.
  3. **Un-ingest** — once no resident remains, ``remove_nodes`` (the
     inverse of ``ingest_nodes``) drops views/lazy payloads, retires
     the per-slice incremental caches, deletes empty slices, and emits
     ONE epoch bump + delta + ``unnodes`` journal record.

Ticks ride the decision path (``Extender.handle`` calls
``maybe_tick`` under the decision lock, the checkpoint-cadence
pattern), so drains progress with traffic; the sim and the autoscaler
call ``tick()`` directly, which takes the decision lock itself.

On a sharded plane the replica being drained registers **drain
intent** with the shard router (``sched/shard.py``, which calls
``attach_router`` for each in-process replica) so its health check
never dead-marks it mid-choreography — eviction latency during a drain
is expected, not a liveness failure. Without a router the intent calls
do nothing.

Nothing here is constructed unless ``drain_enabled``; the flag off
leaves placements, exposition, and journal bytes byte-identical.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Optional

log = logging.getLogger("tpukube_torch.drain")


class DrainCoordinator:
    """One per extender; owns every in-flight drain on this replica.

    Thread contract: mutations to cluster state run under the
    extender's decision lock (``tick``/``begin`` take it; ``maybe_tick``
    is called while it is already held — RLock). ``self._lock`` is a
    LEAF guarding only the drain records and counters; no state/gang
    call ever runs while holding it.
    """

    #: scheduling-clock seconds between amortized ticks
    TICK_INTERVAL_S = 0.5

    def __init__(self, extender, config) -> None:
        self.ext = extender
        self._config = config
        self._lock = threading.Lock()
        #: drain_id -> record (see begin())
        self._drains: dict[str, dict[str, Any]] = {}
        self._next_id = 0
        # the shard router hook: set when this extender is
        # an in-process shard replica — drain intent keeps the health
        # checker from dead-marking the replica mid-choreography
        self._router = None
        self._router_idx: Optional[int] = None
        # counters (tpukube_drain_* series; rendered only when on)
        self.drains_started = 0
        self.drains_completed = 0
        self.evictions_total = 0
        self.nodes_removed_total = 0
        self.chips_removed_total = 0
        self.slices_dropped_total = 0
        #: disruption accounting: moves applied on the most recent
        #: tick, and the worst tick ever — scenario 15 asserts the
        #: peak never exceeds drain_max_concurrent_moves
        self.last_tick_moves = 0
        self.peak_tick_moves = 0
        self._last_tick = self.ext.clock.monotonic()

    # -- router intent (drain/health-check race fix) -----------------------
    def attach_router(self, router, idx: int) -> None:
        """Called by the shard router when it builds in-process
        replicas: ``idx`` is this replica's shard index."""
        self._router = router
        self._router_idx = idx

    def _set_router_intent(self, active: bool) -> None:
        if self._router is None or self._router_idx is None:
            return
        try:
            if active:
                self._router.register_drain_intent(self._router_idx)
            else:
                self._router.clear_drain_intent(self._router_idx)
        except Exception:
            log.exception("drain intent update failed (replica %s)",
                          self._router_idx)

    # -- lifecycle ---------------------------------------------------------
    def begin(self, nodes, reason: str = "maintenance") -> str:
        """Start draining ``nodes``: cordon them (one seam), register
        router intent, and record the drain. Returns the drain id.
        Unknown names are ignored by the cordon; already-draining
        nodes simply join another drain's record too (idempotent —
        remove_nodes tolerates double removal)."""
        names = sorted(set(nodes))
        with self.ext._decision_lock:
            self.ext.state.set_cordon(names, True)
            # chip count up front (these nodes are leaving anyway, so
            # materializing a lazy view here costs nothing we keep)
            chips = 0
            for n in names:
                view = self.ext.state.node(n)
                if view is not None:
                    chips += len(view.info.chips)
            with self._lock:
                self._next_id += 1
                drain_id = f"drain-{self._next_id}"
                self._drains[drain_id] = {
                    "id": drain_id,
                    "nodes": set(names),
                    "reason": reason,
                    "chips": chips,
                    "started": self.ext.clock.monotonic(),
                    "evicted": 0,
                    "state": "draining",
                }
                self.drains_started += 1
            self._set_router_intent(True)
        if self.ext.journal is not None:
            # durability barrier on the cordon seam: a crash after
            # begin() returns must recover knowing WHICH capacity was
            # leaving — the maintenance intent outlives the process
            self.ext.journal.sync()
        self.ext._emit_event(
            "DrainStarted", f"drain/{drain_id}",
            f"draining {len(names)} node(s) ({chips} chips): {reason}",
            warning=False,
        )
        log.warning("drain %s: cordoned %d node(s) (%s)",
                    drain_id, len(names), reason)
        return drain_id

    def cancel(self, drain_id: str) -> bool:
        """Abort a drain: uncordon whatever of its nodes still exists.
        Evictions already applied stand (they were real releases)."""
        with self.ext._decision_lock:
            with self._lock:
                rec = self._drains.pop(drain_id, None)
            if rec is None:
                return False
            self.ext.state.set_cordon(sorted(rec["nodes"]), False)
            with self._lock:
                if not self._drains:
                    self._set_router_intent(False)
        self.ext._emit_event(
            "DrainCancelled", f"drain/{drain_id}",
            f"uncordoned {len(rec['nodes'])} node(s)",
        )
        return True

    def active(self) -> bool:
        with self._lock:
            return any(r["state"] == "draining"
                       for r in self._drains.values())

    # -- the choreography --------------------------------------------------
    def maybe_tick(self) -> None:
        """Amortized driver on the decision path (caller holds the
        decision lock): a clock read per decision, a real tick at
        TICK_INTERVAL_S cadence, nothing at all with no active drain."""
        if not self.active():
            return
        now = self.ext.clock.monotonic()
        if now - self._last_tick < self.TICK_INTERVAL_S:
            return
        self.tick()

    def tick(self) -> int:
        """One budgeted round of migrate-or-preempt across every
        active drain; drains whose nodes are empty complete (release +
        un-ingest). Returns workloads evicted this tick."""
        ext = self.ext
        with ext._decision_lock:
            self._last_tick = ext.clock.monotonic()
            with self._lock:
                draining = [r for r in self._drains.values()
                            if r["state"] == "draining"]
            if not draining:
                return 0
            all_nodes: set[str] = set()
            for rec in draining:
                all_nodes |= rec["nodes"]
            moves = self._evict_residents(all_nodes)
            with self._lock:
                self.last_tick_moves = moves
                self.peak_tick_moves = max(self.peak_tick_moves, moves)
            if moves == 0:
                # nothing left to move anywhere: complete every drain
                # whose nodes carry no live allocation
                self._complete_empty(draining)
            return moves

    def _evict_residents(self, nodes: set[str]) -> int:
        """Evict up to the disruption budget of resident workloads.
        Cheapest (lowest blocking priority) first — the same ordering
        preemption planning optimizes for; gang residents dissolve
        all-or-nothing through the shared victim machinery."""
        ext = self.ext
        node_of = {a.pod_key: a.node_name
                   for a in ext.state.allocations()}
        resident = []
        seen_gangs: set = set()
        for w in ext._preemption_workloads():
            if not any(node_of.get(pk) in nodes for pk in w.pod_keys):
                continue
            if w.gang_key is not None:
                # a DCN-split gang appears once per slice; evicting any
                # part dissolves the whole gang — budget it once
                if w.gang_key in seen_gangs:
                    continue
                seen_gangs.add(w.gang_key)
            resident.append(w)
        if not resident:
            return 0
        resident.sort(key=lambda w: (w.priority, w.id))
        budget = self._config.drain_max_concurrent_moves
        tenant_cap = self._config.drain_tenant_budget
        tenant_moved: dict[str, int] = {}
        moves = 0
        for w in resident:
            if moves >= budget:
                break
            if tenant_cap > 0 and w.tenant:
                if tenant_moved.get(w.tenant, 0) >= tenant_cap:
                    continue
            victim_pods = ext._victim_pod_keys([w])
            # provenance FIRST: _apply_victims notes "preempted" for
            # each pod; the drain stage names WHICH drain took the
            # chips (the explain chain the issue requires)
            for pk in sorted(victim_pods):
                node = node_of.get(pk)
                did = self._drain_of(node)
                ext._note_decision(pk, "drain_evict",
                                   drain=did, node=node)
            evicted, _held = ext._apply_victims([w])
            moves += 1
            if w.tenant:
                tenant_moved[w.tenant] = (
                    tenant_moved.get(w.tenant, 0) + 1)
            with self._lock:
                self.evictions_total += evicted
                for rec in self._drains.values():
                    if rec["state"] == "draining" and any(
                            node_of.get(pk) in rec["nodes"]
                            for pk in victim_pods):
                        rec["evicted"] += evicted
        return moves

    def _drain_of(self, node: Optional[str]) -> Optional[str]:
        if node is None:
            return None
        with self._lock:
            for rec in self._drains.values():
                if rec["state"] == "draining" and node in rec["nodes"]:
                    return rec["id"]
        return None

    def _complete_empty(self, draining: list[dict]) -> None:
        """Release + un-ingest every drain whose nodes hold no live
        allocation any more (caller holds the decision lock)."""
        ext = self.ext
        live = {a.node_name for a in ext.state.allocations()}
        for rec in draining:
            if rec["nodes"] & live:
                continue  # evictions still terminating
            out = ext.state.remove_nodes(sorted(rec["nodes"]))
            removed = out["removed"]
            with self._lock:
                rec["state"] = "completed"
                rec["removed"] = len(removed)
                rec["slices_dropped"] = out["slices_dropped"]
                rec["finished"] = ext.clock.monotonic()
                self.drains_completed += 1
                self.nodes_removed_total += len(removed)
                self.chips_removed_total += rec["chips"]
                self.slices_dropped_total += len(out["slices_dropped"])
                any_active = any(r["state"] == "draining"
                                 for r in self._drains.values())
            if not any_active:
                self._set_router_intent(False)
            if ext.journal is not None:
                # the decommission is reported complete only once the
                # un-ingest record is durable: losing it to a crash
                # would resurrect capacity the provider already took
                ext.journal.sync()
            ext._emit_event(
                "DrainCompleted", f"drain/{rec['id']}",
                f"un-ingested {len(removed)} node(s), dropped "
                f"slice(s) {out['slices_dropped']}, evicted "
                f"{rec['evicted']} pod(s)",
                warning=False,
            )
            log.warning(
                "drain %s complete: %d node(s) un-ingested, %d pod(s) "
                "evicted, slices dropped: %s", rec["id"], len(removed),
                rec["evicted"], out["slices_dropped"])

    # -- inspection --------------------------------------------------------
    def statusz(self) -> dict[str, Any]:
        """The /statusz "drain" section (rendered only when the flag
        is on — the extender adds the key conditionally)."""
        with self._lock:
            return {
                "started": self.drains_started,
                "completed": self.drains_completed,
                "evictions_total": self.evictions_total,
                "nodes_removed_total": self.nodes_removed_total,
                "chips_removed_total": self.chips_removed_total,
                "slices_dropped_total": self.slices_dropped_total,
                "peak_tick_moves": self.peak_tick_moves,
                "budget_moves": self._config.drain_max_concurrent_moves,
                "active": [
                    {
                        "id": r["id"],
                        "reason": r["reason"],
                        "nodes": len(r["nodes"]),
                        "chips": r["chips"],
                        "evicted": r["evicted"],
                    }
                    for r in sorted(self._drains.values(),
                                    key=lambda r: r["id"])
                    if r["state"] == "draining"
                ],
            }

    def stats(self) -> dict[str, int]:
        """Counter snapshot for the metrics renderer."""
        with self._lock:
            return {
                "started": self.drains_started,
                "completed": self.drains_completed,
                "evictions": self.evictions_total,
                "nodes_removed": self.nodes_removed_total,
                "chips_removed": self.chips_removed_total,
                "slices_dropped": self.slices_dropped_total,
                "peak_tick_moves": self.peak_tick_moves,
            }
