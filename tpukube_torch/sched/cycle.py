"""Batched scheduling cycles — the port's own copy of
``tpukube/sched/cycle.py`` (``PodPlan``, ``_SliceOverlay``,
``SchedulingCycle``), line for line where parity rests on order: the
queue's (priority, gang, arrival) sort, the overlay's effect sets, the
best-node heap and the fast-state patching.

The extender protocol is per-pod: kube-scheduler sends /filter,
/prioritize, and /bind for one pod at a time, and the legacy path
re-plans inside every webhook. After the epoch-cached snapshot
removed the compute hot path, the residual wall is per-pod overhead —
three webhook round-trips each redoing overlapping work.

:class:`SchedulingCycle` turns that into kube-scheduler's
snapshot-per-cycle model, batched:

  * pending pods are ADMITTED into a scheduling queue — by their own
    /filter webhook, or ahead of time by the pod informer / sim batch
    driver (:meth:`enqueue`);
  * a CYCLE drains the queue (priority- and gang-aware order, capped at
    ``batch_max_pods``) and plans every pod against ONE epoch-pinned
    :class:`~tpukube_torch.sched.snapshot.ClusterSnapshot`, committing each
    planned placement to the ledger as an ASSUMED allocation (the
    kube-scheduler assume-cache move) so later pods in the batch see
    earlier ones exactly as the sequential per-pod path would;
  * /filter, /prioritize, and /bind then ANSWER FROM THE PLAN — a dict
    lookup — instead of re-planning; /bind consumes the assumed
    allocation (or undoes it and falls back to the legacy path when the
    scheduler picked a different node than planned).

Placement parity is a hard contract (the reference's tests/test_cycle.py,
run on both packages by tests/test_torch_cycle.py):
with batching on, every placement decision (node, chips, preemption
plan, DCN split) is bit-identical to the legacy per-pod path, because
the planner either runs the SAME per-pod code (gang / vTPU /
multi-chip pods — the "general path") or a fast path proven equal to
it (single whole-chip pods under topology scoring — the common churn
shape, planned incrementally against a cycle-local overlay so a
thousand-pod batch costs one snapshot build, not a thousand).

Locking: the cycle is owned by the Extender and ONLY touched under its
decision lock (handle() routes every webhook through it), so the plan
needs no lock of its own. The pinned snapshot is taken once per cycle
through the one seam ``_pin_snapshot``: no other ``SnapshotCache`` read
or ad-hoc sweep construction lives in this module.

With the tenancy plane on (``ext.tenants``) a full drain orders the queue
by ``drf_order``, the gang arm and the fast path run its admission gate,
and a planned bind carries the tenant env, as the reference's do.

With the capacity recorder on (``ext.capacity``) every plan that found no
node is root-caused into its stranded-demand ledger, and each cycle's end
is a sampling seam.

With decision provenance on (``ext.decisions``) each planned pod records
a ``cycle_plan`` stage (arm, cycle, epoch, queue age and how the snapshot
advanced: cached, delta or rebuild), and an undone assume or an expired
plan records its own stage. With it on, ``ext.phase_hist`` times the
cycle's queue, pin, plan and answer phases, and the trace carries the
cycle spans for the timeline.
"""

from __future__ import annotations

import heapq
import logging
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Optional

from tpukube_torch.core import codec
from tpukube_torch.core.types import (
    RESOURCE_TPU,
    AllocResult,
    PodInfo,
    TopologyCoord,
    make_device_id,
)
from tpukube_torch.obs.registry import Histogram
from tpukube_torch.sched import slicefit
from tpukube_torch.sched.gang import GangError, GangManager, NoSliceError
from tpukube_torch.sched.state import StateError

log = logging.getLogger("tpukube_torch.cycle")


class PodPlan:
    """One pod's planned webhook answers + (optionally) its assumed
    allocation. ``names`` is the node-name tuple the plan was computed
    against — a webhook asking about a different node set is a plan
    miss (the legacy path answers it)."""

    __slots__ = (
        "pod", "uid", "names", "feasible", "failed", "scores", "node",
        "alloc", "assumed", "bind_error", "error", "planned_at", "seq",
        "epoch_key",
    )

    def __init__(self, pod: PodInfo, names: tuple[str, ...],
                 planned_at: float, seq: int):
        self.pod = pod
        self.uid = pod.uid
        self.names = names
        #: (ledger, gang) epochs when planning finished — a NON-assumed
        #: entry is only servable while these stand still (its answer
        #: was "unschedulable"/"failed" against THAT state; the legacy
        #: path would recompute after any mutation, so must we)
        self.epoch_key: Optional[tuple[int, int]] = None
        self.feasible: Optional[list[str]] = None
        self.failed: dict[str, str] = {}
        self.scores: dict[str, int] = {}
        self.node: Optional[str] = None        # planner's predicted pick
        self.alloc: Optional[AllocResult] = None
        self.assumed = False                   # alloc committed, bind pending
        self.bind_error: Optional[str] = None  # planned /bind error answer
        self.error: Optional[str] = None       # planned /filter error answer
        self.planned_at = planned_at
        self.seq = seq


class _SliceOverlay:
    """Incremental view of one ICI slice for the fast path: the pinned
    snapshot's blocked contact values (as a plain dict over the free
    chips — numpy scalar indexing per query was the measured kilonode
    bottleneck) plus per-node free sets, updated in O(1) per placement
    instead of re-deriving O(volume) sweeps per pod. Values are proven
    equal to the legacy per-pod reads (contact_grid / point_contact /
    free-count feasibility) by the reference's parity suite.

    The overlay is PERSISTENT across cycles: it also
    carries the mutable occupied/reserved membership sets (the union
    the contact values count against) so it can be patched from the
    snapshot cache's delta chain — blocking and unblocking chips as
    commits, releases, and reservation moves land — instead of being
    rebuilt O(chips) at the top of every cycle."""

    __slots__ = ("mesh", "contact", "free_by_node", "owner", "occ",
                 "resv", "hosts")

    def __init__(self, mesh, contact, free_by_node, owner, occ, resv,
                 hosts):
        self.mesh = mesh
        #: free coord -> its contact against the blocked set; seeded
        #: from the pinned snapshot's vectorized contact grid and
        #: mutated incrementally (blocked chips are never queried)
        self.contact = contact
        #: node -> set of free, unreserved chip coords on that node
        #: (every tracked — annotated, whole-chip-mode — node has an
        #: entry, possibly empty: membership = "tracked")
        self.free_by_node = free_by_node
        #: free coord -> owning node name (for best-score fanout)
        self.owner = owner
        #: mutable occupied / reserved membership (blocked = occ ∪ resv
        #: — the two sets may overlap: a preemption victim's chips are
        #: occupied AND inside the new reservation until eviction)
        self.occ = occ
        self.resv = resv
        #: coord -> node name for the whole slice (the ledger's shared
        #: frozen host map; host moves are full-rebuild markers)
        self.hosts = hosts

    def _blocked(self, coord: TopologyCoord) -> bool:
        return coord in self.occ or coord in self.resv

    def set_occupied(self, coord: TopologyCoord) -> set[str]:
        """An assumed/committed allocation claimed ``coord``. Returns
        the nodes whose best contact may have changed."""
        was = self._blocked(coord)
        self.occ.add(coord)
        return set() if was else self._block_effects(coord)

    def clear_occupied(self, coord: TopologyCoord) -> set[str]:
        """A release returned ``coord`` to fully-free (the ledger delta
        only emits this for healthy, zero-share chips)."""
        self.occ.discard(coord)
        return set() if self._blocked(coord) else \
            self._unblock_effects(coord)

    def set_reserved(self, coord: TopologyCoord) -> set[str]:
        was = self._blocked(coord)
        self.resv.add(coord)
        return set() if was else self._block_effects(coord)

    def clear_reserved(self, coord: TopologyCoord) -> set[str]:
        self.resv.discard(coord)
        return set() if self._blocked(coord) else \
            self._unblock_effects(coord)

    def _block_effects(self, coord: TopologyCoord) -> set[str]:
        """``coord`` just became blocked: remove it from its node's
        free set and bump each free neighbor's contact once per
        reaching direction — the exact increment
        ``slicefit.point_contact`` would observe (a length-2 torus axis
        reaches the same neighbor twice and counts twice). Returns the
        nodes whose best contact may have changed."""
        node = self.hosts.get(coord)
        free = self.free_by_node.get(node) if node is not None else None
        touched = set()
        if free is not None:
            free.discard(coord)
            touched.add(node)
        self.contact.pop(coord, None)
        self.owner.pop(coord, None)
        mesh = self.mesh
        contact = self.contact
        owner = self.owner
        for axis in range(3):
            d = mesh.dims[axis]
            wrap = mesh.torus[axis] and d > 1
            for step in (-1, 1):
                idx = coord[axis] + step
                if wrap:
                    idx %= d
                elif idx < 0 or idx >= d:
                    continue  # true wall: no neighbor to update
                v = list(coord)
                v[axis] = idx
                nb = TopologyCoord(*v)
                if nb in contact:  # a free chip whose snugness grew
                    contact[nb] += 1
                    touched.add(owner[nb])
        return touched

    def _unblock_effects(self, coord: TopologyCoord) -> set[str]:
        """``coord`` just became free: decrement each free neighbor's
        contact (the inverse of ``_block_effects``) and — when its node
        is tracked — return it to the free set with its own contact
        computed against the current blocked union."""
        mesh = self.mesh
        contact = self.contact
        owner = self.owner
        touched = set()
        for axis in range(3):
            d = mesh.dims[axis]
            wrap = mesh.torus[axis] and d > 1
            for step in (-1, 1):
                idx = coord[axis] + step
                if wrap:
                    idx %= d
                elif idx < 0 or idx >= d:
                    continue
                v = list(coord)
                v[axis] = idx
                nb = TopologyCoord(*v)
                if nb in contact:
                    contact[nb] -= 1
                    touched.add(owner[nb])
        node = self.hosts.get(coord)
        free = self.free_by_node.get(node) if node is not None else None
        if free is not None:
            free.add(coord)
            contact[coord] = slicefit.point_contact(
                mesh, coord, self._blocked
            )
            owner[coord] = node
            touched.add(node)
        return touched

    def best_chip(self, node: str) -> Optional[TopologyCoord]:
        """The node's snuggest free chip under the legacy tie-break:
        max (contact, then lexicographically smallest coord) — the
        same key ``Extender._plan_chips``'s count==1 path uses."""
        free = self.free_by_node.get(node)
        if not free:
            return None
        cg = self.contact
        return max(free, key=lambda c: (cg[c], tuple(-v for v in c)))

    def best_contact(self, node: str) -> int:
        """Max contact over the node's free chips (-1 when none) — the
        quantity the legacy /prioritize count==1 path scores."""
        free = self.free_by_node.get(node)
        if not free:
            return -1
        cg = self.contact
        return max(cg[c] for c in free)


class SchedulingCycle:
    """The batch planner, owned by (and locked by) one Extender."""

    #: recent batch sizes / cycle walls kept for the /metrics summaries
    WINDOW = 512

    def __init__(self, extender, config) -> None:
        self._ext = extender
        self._max_pods = config.batch_max_pods
        self._interval = config.cycle_interval_seconds
        self._ttl = config.reservation_ttl_seconds
        # answer /filter (and /prioritize) FROM the
        # plan — the feasible set is the planned node alone, so the
        # webhook answer stops materializing the O(nodes) per-node
        # verdict list that was the 10k-node filter p99. Placement is
        # unchanged: the one offered node IS the max-score smallest-name
        # pick the full answer would have led the scheduler to.
        self._filter_from_plan = config.filter_from_plan
        # scheduling queue: pod key -> (PodInfo, enqueue seq, the
        # webhook's candidate node names or None for driver/informer
        # admissions). Insertion order is the arrival order; the cycle
        # re-sorts by priority. Per-pod names matter on real clusters:
        # kube-scheduler's /filter carries only the nodes that passed
        # its built-in predicates for THAT pod, so planning a queued
        # pod against another pod's candidate list would assume
        # placements onto nodes the pod may not even tolerate.
        self._queue: dict[str, tuple[PodInfo, int, Optional[tuple[str, ...]]]] = {}
        # pod key -> scheduling-clock FIRST-admit time, for the
        # pending-admit-age percentiles /statusz reports (the
        # starvation signal drf_order can hide) and the per-pod queue
        # wait the provenance layer records. The stamp survives
        # plan-and-retry cycles — a pod shed or refused for hours must
        # accumulate age, not reset per retry — and retires only when
        # the pod actually binds (on_bound), releases, or its plan
        # expires.
        self._enqueued_at: dict[str, float] = {}
        self._plans: dict[str, PodPlan] = {}
        self._seq = 0
        self._last_drain = float("-inf")  # clock time of last full drain
        # Persistent fast-path state: the overlay (per-node
        # free sets, contact dict, best-node heap) survives ACROSS
        # cycles and is patched from the snapshot cache's delta chain;
        # a full O(chips) rebuild happens only on structural change or
        # delta-log overflow. Owned by the decision lock like the rest.
        self._fast_state: Optional[dict[str, Any]] = None
        # counters (read by /metrics + /statusz under no extra lock —
        # the decision lock already serializes every writer)
        self.cycles = 0
        self.pods_planned = 0
        self.plan_hits = 0
        self.plan_misses = 0
        self.assumes = 0
        self.assume_undos = 0
        self.fast_patches = 0    # fast state advanced O(Δ) from deltas
        self.fast_rebuilds = 0   # fast state rebuilt O(chips)
        self.gang_batches = 0          # gang groups planned batched
        self.gang_batch_members = 0    # members planned by that arm
        self.batch_sizes: deque[int] = deque(maxlen=self.WINDOW)
        self.cycle_walls: deque[float] = deque(maxlen=self.WINDOW)
        self.cycle_wall_total = 0.0  # cumulative (the windows rotate)
        self.cycle_hist = Histogram("tpukube_cycle_wall_seconds",
                                    bucket_only=True)
        # queue-age histogram: the starvation signal the
        # percentile window on /statusz carries, exportable as _bucket
        # series so Prometheus can alert on it. Long-tail buckets: a
        # pod stuck for hours IS the signal, sub-second ages are noise.
        self.queue_age_hist = Histogram(
            "tpukube_cycle_queue_age_seconds", bucket_only=True,
            buckets=(1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0,
                     1800.0, 3600.0))

    # -- queue admission -----------------------------------------------------
    def enqueue(self, pod: PodInfo,
                names: Optional[tuple[str, ...]] = None) -> None:
        """Admit a pending pod (idempotent per pod key). ``names`` is
        the admitting webhook's candidate node list; None (the pod
        informer / sim batch driver) means every known node is a
        candidate and materialized webhook answers are not expected."""
        key = pod.key()
        # setdefault: re-deliveries AND refusal-retry re-admissions
        # keep the FIRST admit time — resetting per retry would hide
        # exactly the repeatedly-refused pod the age stat exists for
        self._enqueued_at.setdefault(key, self._ext.clock.monotonic())
        if key in self._queue:
            # keep the original seq (arrival order) but the fresh
            # object and candidate set
            self._queue[key] = (pod, self._queue[key][1], names)
            return
        self._seq += 1
        self._queue[key] = (pod, self._seq, names)

    def offer(self, pod: PodInfo) -> bool:
        """enqueue() unless the pod already has a LIVE plan — the
        informer feed re-delivers pending pods (MODIFIED events, every
        list resync), and replanning an ASSUMED allocation would commit
        its chips twice: the replan's commit fails, the fresh (broken)
        entry overwrites the assumed one in ``_plans``, and the
        original allocation is orphaned until the pod object dies.
        (Error entries are never live — _entry_current — so a shed or
        unschedulable pod re-enters the queue and re-runs the gate.)
        Invalidation on a genuinely changed pod belongs to
        filter_response, which undoes the assume first. Returns True
        when the pod actually entered the queue."""
        if self.plan_is_live(pod):
            return False
        self.enqueue(pod)
        return True

    def queue_depth(self) -> int:
        return len(self._queue)

    def planned_node(self, pod_key: str) -> Optional[str]:
        """The live plan's predicted node for ``pod_key`` (None when
        unplanned or found unschedulable)."""
        entry = self._plans.get(pod_key)
        return entry.node if entry is not None else None

    def _entry_current(self, entry: PodPlan) -> bool:
        """An ASSUMED entry stays servable regardless of later epochs —
        its allocation is committed, and the answer IS that commitment
        (re-planning would double-commit). A FILTER-ERROR answer is
        never served from cache: refusals may be time-dependent (the
        tenancy gate's SLO-burn shed subsides with no epoch moving),
        so each retry must re-run the gate — exactly what the
        recomputing legacy path did per webhook. Any other non-assumed
        entry (unschedulable node set, deferred preemption, a planned
        bind error — which take_for_bind consumes, so it cannot loop)
        is a cached pure function of cluster state: servable only
        while the epochs stand still."""
        if entry.assumed:
            return True
        if entry.error is not None:
            return False
        return entry.epoch_key == self._ext.snapshots.epoch_key()

    def plan_is_live(self, pod: PodInfo) -> bool:
        """True while this pod holds a servable plan (Extender.admit's
        informer-re-delivery dedup runs this BEFORE the tenancy gate,
        so an already-planned pod never journals a phantom refusal)."""
        entry = self._plans.get(pod.key())
        return (entry is not None and entry.uid == pod.uid
                and self._entry_current(entry))

    # -- webhook answers -----------------------------------------------------
    def filter_response(
        self,
        pod: PodInfo,
        raw_nodes: Optional[list[dict[str, Any]]],
        node_names: Optional[list[str]],
    ) -> Any:
        """The /filter decision in batch mode: ingest nodes, admit the
        pod, ensure it is planned (running a cycle if needed), and
        answer from the plan. Raises exactly what the legacy path
        raises (the caller maps errors to the wire error response)."""
        from tpukube_torch.sched import kube

        ext = self._ext
        if raw_nodes is not None:
            names = ext._ingest_nodes(raw_nodes)
            by_name: Optional[dict[str, Any]] = dict(zip(names, raw_nodes))
        else:
            names = list(node_names or [])
            by_name = None
        mk = (kube.filter_result if raw_nodes is not None
              else kube.filter_result_names)

        ask = ext.device_request(pod)  # ExtenderError propagates (legacy)
        if ask is None:
            # not a TPU pod: everything feasible, nothing to plan
            return mk(raw_nodes if raw_nodes is not None else names, {})

        key = pod.key()
        entry = self._plans.get(key)
        fresh = (entry is not None and entry.uid == pod.uid
                 and entry.names == tuple(names)
                 and self._entry_current(entry))
        if fresh:
            self.plan_hits += 1
        else:
            if entry is not None and entry.assumed:
                # the scheduler is re-filtering a pod we already assumed
                # (changed node set / recreated pod): the old plan's
                # commitment must not shadow the new cycle
                self._undo_assume(entry)
            self._plans.pop(key, None)
            self.enqueue(pod, tuple(names))
            self.run_cycle(must_plan=key)
            entry = self._plans.get(key)
            if entry is None:
                # beyond the batch cap even after a cycle: legacy
                # answer (quiet: the handle() wrapper already times
                # this webhook — exactly one sample per webhook)
                self.plan_misses += 1
                with self._quiet():
                    feasible, failed = ext.filter(
                        pod, raw_nodes=raw_nodes, node_names=node_names
                    )
                return mk(feasible, failed)
            self.plan_misses += 1  # planned now, not answered from cache
        if entry.error is not None:
            dlog = ext.decisions
            if dlog is not None and dlog.wants(key):
                # the planned refusal the scheduler will see (the tenancy
                # gate recorded its own verdict at plan time)
                dlog.record(key, "refusal", kind="filter_error",
                            reason=entry.error)
            return mk([], {}, error=entry.error)
        # answer materialization: serving the wire lists from the plan
        # — a dict lookup plus O(feasible) list builds (vs the legacy
        # O(nodes) re-plan this path replaced)
        ph = ext.phase_hist
        a0 = time.perf_counter() if ph is not None else None
        feasible = entry.feasible
        if feasible is None:
            # planned without materialized answers — a driver-enqueued
            # pod whose webhooks were not expected, or any pod under
            # filter_from_plan (the O(nodes) answer build was the
            # 10k-node filter p99): the planned node alone is a
            # correct — if minimal — feasibility answer, and the
            # scheduler's pick then consumes the assumed allocation
            feasible = [entry.node] if entry.node is not None else []
        if by_name is not None:
            response = mk([by_name[n] for n in feasible if n in by_name],
                          dict(entry.failed))
        else:
            response = mk(list(feasible), dict(entry.failed))
        if a0 is not None:
            ph.labels(phase="answer").observe(time.perf_counter() - a0)
            if ext.trace is not None:
                ext.trace.span("cycle_answer", key, cycle=self.cycles)
        return response

    def prioritize_response(
        self, pod: PodInfo, names: list[str]
    ) -> Optional[dict[str, int]]:
        """Planned scores for exactly the requested names, or None when
        the plan cannot answer (the caller falls back to the legacy
        path and counts a miss)."""
        entry = self._plans.get(pod.key())
        if (entry is None or entry.uid != pod.uid
                or entry.error is not None
                or not self._entry_current(entry)):
            self.plan_misses += 1
            return None
        if not all(n in entry.scores for n in names):
            if self._filter_from_plan and entry.node is not None:
                # plan-served answers carry no materialized score map;
                # the planned node wins outright (it is the only node
                # the plan-served filter offered — extra names can only
                # come from another extender's merge and lose)
                from tpukube_torch.sched.extender import MAX_SCORE

                self.plan_hits += 1
                return {n: (MAX_SCORE if n == entry.node else 0)
                        for n in names}
            self.plan_misses += 1
            return None
        self.plan_hits += 1
        return {n: entry.scores[n] for n in names}

    def take_for_bind(
        self, key: str, uid: str, node: str
    ) -> Optional[tuple[str, Any]]:
        """Consume the plan's /bind answer: ("ok", AllocResult) for an
        assumed allocation on the requested node, ("err", message) for
        a planned bind failure, None when the legacy bind path must run
        (no plan, deferred preemption, or the scheduler picked a
        different node — the assume is undone first)."""
        entry = self._plans.get(key)
        if entry is None or (uid and entry.uid and uid != entry.uid):
            return None
        if entry.assumed and entry.alloc is not None:
            self._plans.pop(key, None)
            if entry.node == node:
                self.plan_hits += 1
                # the pod is bound for real now: retire its pending-
                # webhook context exactly where the legacy bind does
                # (the admit-age stamp retires via on_bound)
                with self._ext._pending_lock:
                    self._ext._pending.pop(key, None)
                return ("ok", entry.alloc)
            # scheduler disagreed with the predicted node (another
            # extender's scores, a racing cycle): undo and re-plan
            self.plan_misses += 1
            self._undo_assume(entry)
            return None
        if (entry.bind_error is not None and entry.node == node
                and self._entry_current(entry)):
            self.plan_hits += 1
            self._plans.pop(key, None)
            return ("err", entry.bind_error)
        self.plan_misses += 1
        return None

    def note_pending(self, pod_key: str) -> None:
        """First-admit stamp for a pod refused at the admission gate
        WITHOUT entering the queue (Extender.admit's tenancy refusal):
        it is still pending — the informer feed retries it — and the
        queue-age starvation stats must count it from its first
        attempt. Retires like any stamp (bind/release)."""
        self._enqueued_at.setdefault(pod_key,
                                     self._ext.clock.monotonic())

    def on_bound(self, pod_key: str) -> None:
        """A bind actually committed (plan-served or legacy path):
        retire the first-admit stamp — the pod is no longer pending,
        so the starvation stats must stop counting it."""
        self._enqueued_at.pop(pod_key, None)

    def on_release(self, pod_key: str) -> None:
        """A recorded release arrived (pod deleted/evicted): a plan
        entry still assuming this pod must not keep counting it bound —
        the ledger release itself already happened in the decision. A
        still-QUEUED entry leaves too: planning a deleted pod would
        assume chips nobody will bind, and its admit time would keep
        inflating the queue-age starvation stats forever."""
        self._queue.pop(pod_key, None)
        self._enqueued_at.pop(pod_key, None)
        entry = self._plans.pop(pod_key, None)
        if entry is not None and entry.assumed:
            # the alloc is already released by the decision; only the
            # bookkeeping the assume added must unwind
            self._ext.binds_total -= 1
            self.assume_undos += 1

    # -- the cycle -----------------------------------------------------------
    def run_pending(self) -> int:
        """Drive cycles until the queue drains (the sim batch driver /
        pod-informer entry point; webhook-triggered planning goes
        through filter_response). Returns pods planned."""
        planned = 0
        while self._queue:
            planned += self.run_cycle(drain=True)
        return planned

    def run_cycle(self, must_plan: Optional[str] = None,
                  drain: bool = False) -> int:
        """Plan one batch. ``must_plan`` (a webhook's pod) is always
        included; the rest of the queue joins when ``drain`` is set or
        ``cycle_interval_seconds`` has elapsed since the last full
        drain — otherwise an arrival storm coalesces into fewer, bigger
        cycles instead of replanning per webhook. Each pod plans
        against ITS OWN candidate node list (the admitting webhook's,
        or every known node for driver/informer admissions) and only
        webhook-admitted pods pay for materialized filter/score
        answers."""
        ext = self._ext
        now = ext.clock.monotonic()
        self._expire_plans(now)
        full = (drain or self._interval <= 0
                or now - self._last_drain >= self._interval)
        batch: list[tuple[PodInfo, int, Optional[tuple[str, ...]]]] = []
        if full:
            if ext.tenants is not None:
                # multi-tenant plane: priority bands first (unchanged),
                # then progressive dominant-resource fairness within
                # each band — a neutral plane (one tenant) reproduces
                # the order without it exactly (parity-tested)
                order = ext.tenants.drf_order(list(self._queue.values()))
            else:
                order = sorted(
                    self._queue.values(),
                    key=lambda e: (
                        -e[0].priority,
                        # gang-aware: members of one gang plan
                        # adjacently (their reservation assembles within
                        # one cycle), gangs ahead of strays within a
                        # priority band
                        (0, e[0].group.name) if e[0].group is not None
                        else (1, ""),
                        e[1],
                    ),
                )
            batch = order[: self._max_pods]
            self._last_drain = now
        if must_plan is not None and must_plan in self._queue and not any(
            p.key() == must_plan for p, _, _ in batch
        ):
            batch = batch[: max(0, self._max_pods - 1)]
            batch.append(self._queue[must_plan])
        if not batch:
            return 0
        t0 = time.perf_counter()
        # cycle phase profiling (None = off): pin wall accumulates around
        # the fast-state ensure; the snapshot counters before the cycle
        # attribute this pin as a delta advance, a forced rebuild, or a
        # cache hit in the provenance records below
        ph = ext.phase_hist
        dlog = ext.decisions
        pin_s = 0.0
        ages: list[float] = []
        d0, r0 = ext.snapshots.delta_applies, ext.snapshots.rebuilds

        def _advance() -> str:
            # computed FRESH per record (never memoized): a batch whose
            # first pods plan before any snapshot work honestly reads
            # "cached", and the records after a delta advance / forced
            # rebuild — and the end-of-cycle span — attribute it
            if ext.snapshots.rebuilds > r0:
                return "rebuild"
            if ext.snapshots.delta_applies > d0:
                return "delta"
            return "cached"

        def _note_plan(key: str, entry: PodPlan, arm: str,
                       age: Optional[float]) -> None:
            if dlog is None or not dlog.wants(key):
                return
            dlog.record(
                key, "cycle_plan", cycle=self.cycles + 1, arm=arm,
                node=entry.node, assumed=entry.assumed,
                error=entry.error, bind_error=entry.bind_error,
                queue_age_s=(round(age, 6) if age is not None else None),
                snapshot=_advance(),
                epoch=(list(entry.epoch_key) if entry.epoch_key
                       else None),
            )

        def _age_of(key: str) -> Optional[float]:
            # READ, never pop: the first-admit stamp outlives the plan
            # so a refused-and-retried pod keeps accumulating age
            # (on_bound/on_release/_expire_plans retire it)
            qt = self._enqueued_at.get(key)
            if qt is None:
                return None
            age = max(0.0, now - qt)
            ages.append(age)
            self.queue_age_hist.observe(age)
            return age

        def _note_stranded(p: PodInfo, entry: PodPlan) -> None:
            # stranded-demand forensics: every plan that produced no
            # node — a refusal error or an unschedulable verdict
            # (feasible computed, empty) — gets root-caused by the
            # capacity recorder. Assumed plans and plan-served binds are
            # successes; bind errors are transport, not capacity.
            cap = ext.capacity
            if (cap is not None and entry.node is None
                    and not entry.assumed
                    and (entry.error is not None
                         or entry.feasible is not None)):
                cap.note_failed_plan(p, entry.error)

        # ONE shared tuple for driver/informer admissions: every such
        # PodPlan stores `names` verbatim, and at 10k nodes a per-entry
        # copy is ~80KB — tuple(t) on an existing tuple is identity, so
        # sharing here dedupes every downstream tuple(names)
        default_names: Optional[tuple[str, ...]] = None
        i = 0
        while i < len(batch):
            pod, seq, pod_names = batch[i]
            if pod.group is not None and pod_names is None:
                # batched gang planning: the queue order put
                # this gang's driver-admitted members adjacent — plan
                # the whole run through ONE reservation sweep and ONE
                # availability pass instead of the per-member general
                # path (which re-derives both over every node)
                gkey = (pod.namespace, pod.group.name)
                j = i
                members: list[tuple[PodInfo, int]] = []
                while j < len(batch):
                    p2, s2, n2 = batch[j]
                    if (n2 is None and p2.group is not None
                            and (p2.namespace, p2.group.name) == gkey):
                        members.append((p2, s2))
                        j += 1
                    else:
                        break
                if default_names is None:
                    default_names = tuple(ext.state.node_names())
                for (p2, _), entry in zip(members, self._plan_gang_batch(
                        members, default_names)):
                    key2 = p2.key()
                    self._queue.pop(key2, None)
                    self._plans[key2] = entry
                    self.pods_planned += 1
                    _note_plan(key2, entry, "gang_batch", _age_of(key2))
                    _note_stranded(p2, entry)
                i = j
                continue
            key = pod.key()
            self._queue.pop(key, None)
            age = _age_of(key)
            if pod_names is not None:
                names = list(pod_names)
                # a webhook will read the answers — unless plan-served
                # filter answers are on, in which case the planned node
                # alone answers and the O(nodes) materialization is the
                # cost this mode exists to kill
                needs_answers = not self._filter_from_plan
            else:
                if default_names is None:
                    default_names = tuple(ext.state.node_names())
                names = default_names
                needs_answers = False
            if self._fast_eligible(pod):
                # the same janitor the legacy filter runs per webhook;
                # BEFORE the staleness check — a TTL/fault rollback
                # bumps the epoch and must advance/rebuild the overlay
                ext.gang.sweep()
                if ph is not None:
                    p0 = time.perf_counter()
                    fast_state = self._ensure_fast_state()
                    pin_s += time.perf_counter() - p0
                else:
                    fast_state = self._ensure_fast_state()
                entry = self._plan_fast(pod, seq, names, fast_state,
                                        needs_answers)
                if entry.assumed:
                    # commit moved the ledger epoch exactly as planned
                    # (the overlay was patched in-place by _plan_fast)
                    fast_state["key"] = ext.snapshots.epoch_key()
                arm = "fast"
            else:
                entry = self._plan_general(pod, seq, names)
                arm = "general"
            entry.epoch_key = ext.snapshots.epoch_key()
            self._plans[key] = entry
            self.pods_planned += 1
            _note_plan(key, entry, arm, age)
            _note_stranded(pod, entry)
            i += 1
        self.cycles += 1
        self.batch_sizes.append(len(batch))
        wall = time.perf_counter() - t0
        self.cycle_walls.append(wall)
        self.cycle_wall_total += wall
        self.cycle_hist.observe(wall)
        # flight-recorder cadence: batch-driven drives may never touch
        # the webhook tail's hook, so the cycle end is the sampling seam
        # — one clock read when the interval has not elapsed
        if ext.capacity is not None:
            ext.capacity.maybe_sample()
        if ph is not None:
            # additive phases: queue wait (the batch's longest), the
            # snapshot/fast-state pin, and the planning remainder
            if ages:
                ph.labels(phase="queue").observe(max(ages))
            ph.labels(phase="pin").observe(pin_s)
            ph.labels(phase="plan").observe(max(0.0, wall - pin_s))
            if ext.trace is not None:
                # timeline spans (cluster track): Chrome-trace exports
                # show the batch structure cycle by cycle
                ext.trace.span("cycle_pin", "", cycle=self.cycles,
                               wall_s=round(pin_s, 6),
                               snapshot=_advance())
                ext.trace.span("cycle_plan", "", cycle=self.cycles,
                               pods=len(batch), wall_s=round(wall, 6))
        return len(batch)

    def _pin_snapshot(self):
        """The ONE place this module reads the epoch cache: every other
        SnapshotCache read or sweep construction in this module goes
        through this seam."""
        return self._ext.snapshots.current()

    @contextmanager
    def _quiet(self):
        """Suppress webhook-latency observation around plan-time
        internal calls: with batching on, each REAL webhook records
        exactly one latency sample (handle() times the plan/lookup),
        never the phantom prioritize/bind samples the planner's
        internal calls would otherwise add. Single-threaded by
        construction — every caller holds the decision lock."""
        ext = self._ext
        prev = ext._suppress_latency
        ext._suppress_latency = True
        try:
            yield
        finally:
            ext._suppress_latency = prev

    # -- the general path (gang / vTPU / multi-chip) -------------------------
    def _plan_general(self, pod: PodInfo, seq: int,
                      names: list[str]) -> PodPlan:
        """Plan one pod by running the SAME per-pod code the legacy
        webhooks run, in webhook order (filter -> prioritize -> pick ->
        bind), recording each answer. Bit-identity with the legacy path
        is structural: it IS the legacy path, executed at plan time."""
        from tpukube_torch.sched.extender import ExtenderError

        ext = self._ext
        entry = PodPlan(pod, tuple(names), ext.clock.monotonic(), seq)
        with self._quiet():
            # quiet: plan-time internal calls must not feed the webhook
            # latency histograms — each REAL webhook records exactly
            # one sample (the filter wrapper times the whole plan; the
            # prioritize/bind webhooks time their plan lookups)
            try:
                feasible, failed = ext.filter(pod, node_names=list(names))
            except (ExtenderError, GangError, StateError,
                    codec.CodecError) as e:
                entry.error = str(e)
                return entry
            entry.feasible = [
                n if isinstance(n, str) else n["metadata"]["name"]
                for n in feasible
            ]
            entry.failed = dict(failed)
            if not entry.feasible:
                return entry
            try:
                entry.scores = ext.prioritize(
                    pod, node_names=list(entry.feasible)
                )
            except (ExtenderError, GangError, StateError,
                    codec.CodecError) as e:
                log.warning("plan prioritize failed: %s", e)
                entry.scores = {n: 0 for n in entry.feasible}
            entry.node = max(sorted(entry.scores),
                             key=lambda h: entry.scores[h])
            res = None
            if pod.group is not None:
                res = ext.gang.reservation(pod.namespace, pod.group.name)
            if res is not None and (
                ext.gang.peek_pending_victims(res)
                or ext.gang.terminating_victims_of(res)
            ):
                # two-phase preemption: its execution (and the PDB
                # precheck guarding it) belongs to the real /bind
                # webhook — defer
                return entry
            try:
                entry.alloc = ext.bind(pod.name, pod.namespace, pod.uid,
                                       entry.node)
                entry.assumed = True
                self.assumes += 1
                # bind() consumed the pending-webhook context; re-arm
                # it so a node-mismatch fallback (or duplicate filter)
                # can still re-plan through the legacy path
                ext._remember(pod)
            except (ExtenderError, GangError, StateError,
                    codec.CodecError) as e:
                entry.bind_error = str(e)
            return entry

    # -- batched gang planning -------------------------------------------------
    def _plan_gang_batch(
        self, members: list[tuple[PodInfo, int]], names: list[str]
    ) -> list[PodPlan]:
        """Plan one gang's queued (driver-admitted) members as a batch:
        the reservation's shape candidates run through the vectorized
        slicefit sweep ONCE (ensure_reservation, exactly as the legacy
        first member's filter), then every member picks its node from
        ONE ``node_availability`` pass kept current by O(1) decrements
        — instead of the per-member general path, which re-runs filter
        + prioritize over every node per member (O(members × nodes)).

        Placement parity with the legacy path is preserved move for
        move: the pick is argmax of the same ``score_from`` quantity
        with the same smallest-name tie-break, candidates are the same
        feasibility set (nodes holding ≥ chips_per_pod unassigned
        reserved chips), binds run the REAL ``Extender.bind`` (chip
        choice, quorum commit, ledger). Anything off the clean path —
        preemption (pending or terminating victims), non-whole-chip
        requests, config errors, overflow replicas — falls back to the
        per-member general path, which IS the legacy code."""
        from tpukube_torch.sched.extender import ExtenderError

        ext = self._ext
        # the janitor every legacy gang filter runs (TTL/fault rollback
        # before reservation reads); per-member re-sweeps inside
        # ensure_reservation are cheap once the reservation exists
        ext.gang.sweep()
        dlog = ext.decisions
        entries: list[PodPlan] = []
        counts: Optional[dict[str, tuple[int, int]]] = None
        general = False  # sticky: preemption routed this gang legacy
        batched = 0
        with self._quiet():
            for pod, seq in members:
                if general:
                    entries.append(self._general(pod, seq, names))
                    continue
                entry = PodPlan(pod, tuple(names), ext.clock.monotonic(),
                                seq)
                try:
                    ask = ext.device_request(pod)
                except (ExtenderError, codec.CodecError) as e:
                    entry.error = str(e)
                    entry.epoch_key = ext.snapshots.epoch_key()
                    entries.append(entry)
                    continue
                if ask is None or ask[0] != RESOURCE_TPU:
                    # not a whole-chip gang member (the legacy filter
                    # raises / treats it specially): general path
                    entries.append(self._general(pod, seq, names))
                    continue
                count = ask[1]
                if ext.tenants is not None:
                    refusal = ext.tenants.admit(pod, RESOURCE_TPU, count)
                    if refusal is not None:
                        entry.error = refusal
                        entry.epoch_key = ext.snapshots.epoch_key()
                        entries.append(entry)
                        continue
                ext._remember(pod)
                try:
                    res = ext.gang.ensure_reservation(pod, count)
                except NoSliceError:
                    # preemption territory: the general path plans it
                    # (two-phase victims, deferred first bind) — and
                    # stays authoritative for the rest of the gang
                    general = True
                    entries.append(self._general(pod, seq, names))
                    continue
                except (GangError, StateError) as e:
                    entry.error = str(e)
                    entry.epoch_key = ext.snapshots.epoch_key()
                    entries.append(entry)
                    continue
                if dlog is not None and dlog.wants(pod.key()):
                    # the gang rendezvous leg of the provenance chain (the
                    # per-pod filter records it inline; this arm reserves
                    # directly)
                    dlog.record(
                        pod.key(), "gang_reserve",
                        gang=f"{pod.namespace}/{pod.group.name}",
                        chips=res.total_chips(),
                        committed=res.committed,
                    )
                if (ext.gang.peek_pending_victims(res)
                        or ext.gang.terminating_victims_of(res)):
                    general = True
                    entries.append(self._general(pod, seq, names))
                    continue
                if not ext.gang.assignable(res, count):
                    # overflow replica of a full gang: normal placement
                    entries.append(self._general(pod, seq, names))
                    counts = None  # a normal bind may touch gang nodes
                    continue
                if counts is None:
                    counts = ext.gang.node_availability(res)
                cands = sorted(
                    n for n, (a, _) in counts.items() if a >= count
                )
                if not cands:
                    # no node holds enough unassigned reserved chips:
                    # the legacy filter would answer "infeasible
                    # everywhere" — an unschedulable entry (the driver
                    # requeues; a webhook gets empty feasibility)
                    entry.feasible = []
                    entry.epoch_key = ext.snapshots.epoch_key()
                    entries.append(entry)
                    continue
                # argmax of score_from with the legacy smallest-name
                # tie-break (max over an ascending-sorted list returns
                # the first maximal element)
                entry.node = max(
                    cands,
                    key=lambda n: GangManager.score_from(counts, n),
                )
                try:
                    entry.alloc = ext.bind(pod.name, pod.namespace,
                                           pod.uid, entry.node)
                    entry.assumed = True
                    self.assumes += 1
                    batched += 1
                    ext._remember(pod)
                    avail, total = counts[entry.node]
                    counts[entry.node] = (avail - count, total)
                except (ExtenderError, GangError, StateError,
                        codec.CodecError) as e:
                    entry.bind_error = str(e)
                    counts = None  # uncertain state: recompute next
                entry.epoch_key = ext.snapshots.epoch_key()
                entries.append(entry)
        if batched:
            self.gang_batches += 1
            self.gang_batch_members += batched
        return entries

    def _general(self, pod: PodInfo, seq: int,
                 names: list[str]) -> PodPlan:
        """_plan_general + the epoch-key stamp run_cycle's normal path
        applies (gang-arm fallbacks must carry it identically)."""
        entry = self._plan_general(pod, seq, names)
        entry.epoch_key = self._ext.snapshots.epoch_key()
        return entry

    # -- the fast path (single whole-chip pods, topology scoring) ------------
    def _fast_eligible(self, pod: PodInfo) -> bool:
        from tpukube_torch.sched.extender import ExtenderError

        if pod.group is not None:
            return False
        if self._ext._config.score_mode != "topology":
            return False
        if (self._ext.drain is not None
                and self._ext.state.cordoned_nodes()):
            # the fast path's overlay carries no cordon mask: while a
            # drain holds nodes cordoned, a plan takes the general path,
            # whose /filter refuses a cordoned node (the reference's fast
            # path plans onto it: ROADMAP.md Queue 3)
            return False
        try:
            ask = self._ext.device_request(pod)
        except ExtenderError:
            return False  # the general path reports the schema error
        return ask is not None and ask[0] == RESOURCE_TPU and ask[1] == 1

    def _ensure_fast_state(self) -> dict[str, Any]:
        """The persistent fast-path state, advanced to the current
        epochs: patched O(Δ) from the snapshot cache's delta chain when
        it covers the gap, rebuilt O(chips) otherwise (cold start,
        structural change, log overflow). At 10k nodes the per-cycle
        rebuild — contact-grid tolist + every node's free set — was the
        dominant constant the O(log nodes)/pod placement path left."""
        ext = self._ext
        key = ext.snapshots.epoch_key()
        fs = self._fast_state
        if fs is not None and fs["key"] == key:
            return fs
        if fs is not None:
            deltas = ext.snapshots.deltas_between(fs["key"], key)
            if deltas is not None and not any(d.full for d in deltas):
                snap = self._pin_snapshot()
                if self._patch_fast_state(fs, snap, deltas):
                    fs["key"] = key
                    fs["snap"] = snap
                    self.fast_patches += 1
                    return fs
        snap = self._pin_snapshot()
        fs = self._build_fast_state(snap)
        self._fast_state = fs
        self.fast_rebuilds += 1
        return fs

    def _patch_fast_state(self, fs: dict[str, Any], snap,
                          deltas: list) -> bool:
        """Advance the overlay in place by the same delta chain the
        snapshot cache applied: explicit occupied add/remove coords
        from the ledger stream; reserved-mask moves as the per-slice
        set difference between the previously pinned snapshot and the
        fresh one (gang deltas name the touched slices; the masks are
        small). False = a slice the overlay never built appeared —
        caller rebuilds. Net-effect application is order-insensitive:
        every mutator fires block/unblock effects only on a membership
        transition of the occ ∪ resv union."""
        overlays: dict[str, _SliceOverlay] = fs["overlays"]
        old_snap = fs["snap"]
        touched: set[str] = set()
        gang_slices: set[str] = set()
        for d in deltas:
            if d.kind == "gang":
                gang_slices.update(d.slices)
                continue
            if d.slice_id is None:
                continue  # empty ledger bump (release on a gone node)
            ov = overlays.get(d.slice_id)
            if ov is None:
                return False
            for c in d.occupied_add:
                touched |= ov.set_occupied(c)
            for c in d.occupied_remove:
                touched |= ov.clear_occupied(c)
        for sid in gang_slices:
            ov = overlays.get(sid)
            old = old_snap.slices.get(sid)
            new = snap.slices.get(sid)
            if ov is None or old is None or new is None:
                return False
            for c in new.reserved - old.reserved:
                touched |= ov.set_reserved(c)
            for c in old.reserved - new.reserved:
                touched |= ov.clear_reserved(c)
        heap = fs["heap"]
        node_best = fs["node_best"]
        for name in touched:
            sid = fs["node_slice"].get(name)
            if sid is None:
                continue
            best = overlays[sid].best_contact(name)
            if node_best.get(name, -1) != best:
                node_best[name] = best
                if best >= 0:
                    heapq.heappush(heap, (-best, name, best))
        # lazy validation leaves stale heap entries behind; compact
        # before they dominate (a churn drive pushes one entry per
        # touched node per wave)
        if len(heap) > max(1024, 4 * len(node_best)):
            heap[:] = [(-b, n, b) for n, b in node_best.items()
                       if b >= 0]
            heapq.heapify(heap)
        return True

    def _build_fast_state(self, snap) -> dict[str, Any]:
        """Shared structures for the fast path, derived from the pinned
        snapshot over EVERY known node (per-pod candidate lists select
        from it at query time): slice overlays (free-chip contact dicts
        + free sets + the mutable blocked-union membership), the
        vTPU-mode set, and the best-node heap the driver placement loop
        pops from — O(nodes + chips) to build, O(log nodes) per
        placement, O(Δ) to carry across cycles (_patch_fast_state)."""
        ext = self._ext
        overlays: dict[str, _SliceOverlay] = {}
        vtpu_nodes: set[str] = set()
        node_slice: dict[str, str] = {}
        node_best: dict[str, int] = {}
        heap: list[tuple[int, str, int]] = []
        reserved = snap.reserved_by_slice()
        grids: dict[str, list] = {}
        for sid in snap.slice_ids():
            ss = snap.slice(sid)
            # the pinned snapshot's vectorized contact grid, read once
            # into plain nested lists (fast scalar access) — the shared
            # cached ndarray itself is never mutated
            grids[sid] = ss.blocked_sweep().contact_grid().tolist()
            overlays[sid] = _SliceOverlay(
                mesh=ss.mesh, contact={}, free_by_node={}, owner={},
                occ=set(ss.occupied), resv=set(ss.reserved),
                hosts=ext.state.hosts_by_coord(sid),
            )
        for name in ext.state.node_names():
            view = ext.state.node(name)
            if view is None:
                continue
            if view.shares_per_chip > 1:
                vtpu_nodes.add(name)
                continue
            sid = view.info.slice_id
            ov = overlays.get(sid)
            if ov is None:
                continue  # slice raced away mid-cycle: unknown at query
            node_slice[name] = sid
            mask = reserved.get(sid, frozenset())
            grid = grids[sid]
            free = {c.coord for c in view.free_chips()
                    if c.coord not in mask}
            ov.free_by_node[name] = free
            best = -1
            for c in free:
                ov.owner[c] = name
                contact = grid[c[0]][c[1]][c[2]]
                ov.contact[c] = contact
                if contact > best:
                    best = contact
            node_best[name] = best
            if best >= 0:
                heap.append((-best, name, best))
        heapq.heapify(heap)
        return {
            "key": ext.snapshots.epoch_key(),
            "snap": snap,
            "overlays": overlays,
            "vtpu": vtpu_nodes,
            "node_slice": node_slice,
            "node_best": node_best,
            "heap": heap,
        }

    def _plan_fast(self, pod: PodInfo, seq: int, names: list[str],
                   fs: dict[str, Any], needs_answers: bool) -> PodPlan:
        """One single-chip pod against the cycle overlay: O(nodes) to
        materialize webhook answers (skipped for driver-enqueued pods
        whose webhooks never ask), O(1) to place and assume."""
        from tpukube_torch.sched.extender import MAX_SCORE, ExtenderError

        ext = self._ext
        entry = PodPlan(pod, tuple(names), ext.clock.monotonic(), seq)
        if ext.tenants is not None:
            # the same tenancy admission gate the general path hits
            # inside ext.filter — the fast path answers webhooks too,
            # so a quota breach or SLO shed must refuse identically
            refusal = ext.tenants.admit(pod, RESOURCE_TPU, 1)
            if refusal is not None:
                entry.error = refusal
                return entry
        ext._remember(pod)
        overlays: dict[str, _SliceOverlay] = fs["overlays"]
        node_slice: dict[str, str] = fs["node_slice"]

        best_node: Optional[str] = None
        if needs_answers:
            best_score = -1
            feasible: list[str] = []
            failed: dict[str, str] = {}
            scores: dict[str, int] = {}
            for name in names:
                sid = node_slice.get(name)
                if sid is None:
                    failed[name] = (
                        "node is vTPU mode, pod wants whole chips"
                        if name in fs["vtpu"]
                        else "no tpukube node-topology annotation"
                    )
                    continue
                ov = overlays[sid]
                free = len(ov.free_by_node.get(name, ()))
                if free < 1:
                    failed[name] = (
                        f"wants 1 chips, node has {free} free "
                        f"(gang reservations excluded)"
                    )
                    continue
                feasible.append(name)
                contact = ov.best_contact(name)
                score = (round(MAX_SCORE * contact / 6)
                         if contact >= 0 else 0)
                scores[name] = score
                if score > best_score or (
                    score == best_score
                    and (best_node is None or name < best_node)
                ):
                    best_score, best_node = score, name
            entry.feasible = feasible
            entry.failed = failed
            entry.scores = scores
        else:
            # driver path: pop the argmax node off the lazily-validated
            # heap — identical choice to the materialized loop (best
            # contact maps 1:1 to score, ties break on smallest name),
            # at O(log nodes) instead of O(nodes x chips) per pod
            heap = fs["heap"]
            node_best = fs["node_best"]
            while heap:
                _, name, best = heapq.heappop(heap)
                if node_best.get(name, -1) == best and best >= 0:
                    # push the entry straight back: if the placement
                    # below leaves this node's best unchanged, the node
                    # must stay in the heap (the refresh only pushes on
                    # CHANGE); a duplicate is harmless under lazy
                    # validation
                    heapq.heappush(heap, (-best, name, best))
                    best_node = name
                    break
        if best_node is None:
            if needs_answers:
                return entry
            entry.error = "unschedulable: no feasible node in the batch plan"
            return entry
        entry.node = best_node
        ov = overlays[node_slice[best_node]]
        coord = ov.best_chip(best_node)
        view = ext.state.node(best_node)
        if coord is None or view is None:
            entry.bind_error = (
                f"{pod.key()}: node {best_node} can no longer fit 1 x "
                f"{RESOURCE_TPU}"
            )
            return entry
        env: dict[str, str] = {}
        if ext.tenants is not None:
            from tpukube_torch.device.gpu import ENV_KUBE_TENANT

            # same tenant attribution the webhook bind writes — the
            # assumed allocation's annotation must match it exactly
            env[ENV_KUBE_TENANT] = ext.tenants.tenant_of(pod)
        try:
            did = make_device_id(view.index_at(coord))
            alloc = AllocResult(
                pod_key=pod.key(),
                node_name=best_node,
                device_ids=[did],
                coords=[coord],
                env=env,
                priority=pod.priority,
                uid=pod.uid or "",
            )
            ext.state.commit(alloc)
        except (StateError, ExtenderError) as e:
            entry.bind_error = str(e)
            return entry
        ext.binds_total += 1
        entry.alloc = alloc
        entry.assumed = True
        self.assumes += 1
        # O(1) overlay update + best-score refresh for the few nodes
        # the placement touched (heap entries are validated lazily).
        # set_occupied keeps the persistent overlay's blocked union in
        # lockstep with the ledger commit above, so the delta chain
        # patching the NEXT cycle starts from a consistent base.
        heap = fs["heap"]
        node_best = fs["node_best"]
        for name in ov.set_occupied(coord):
            best = ov.best_contact(name)
            if node_best.get(name, -1) != best:
                node_best[name] = best
                if best >= 0:
                    heapq.heappush(heap, (-best, name, best))
        return entry

    # -- hygiene -------------------------------------------------------------
    def _undo_assume(self, entry: PodPlan) -> None:
        """Release an assumed-but-unbound allocation (node mismatch,
        re-filter, expiry): the ledger/gang release the legacy effector
        undo performs, minus the wire response."""
        ext = self._ext
        key = entry.pod.key()
        if ext.state.release(key) is not None:
            ext.gang.on_release(key)
            ext.binds_total -= 1
            self.assume_undos += 1
            log.warning("assumed allocation for %s undone (re-plan)", key)
        if ext.decisions is not None and ext.decisions.wants(key):
            ext.decisions.record(key, "assume_undo", node=entry.node)
        entry.assumed = False
        entry.alloc = None

    def _expire_plans(self, now: float) -> None:
        """Plans whose /bind never came expire on the reservation-TTL
        horizon — the same janitor contract the gang sweep applies to
        its reservations. Assumed allocations are released; non-assumed
        entries (unschedulable / failed answers) are dropped too — a
        daemon fed a stream of never-binding pods with unique names
        must not grow ``_plans`` without bound."""
        for key, entry in list(self._plans.items()):
            if now - entry.planned_at <= self._ttl:
                continue
            if entry.assumed:
                log.warning(
                    "assumed allocation for %s never bound within %.0fs; "
                    "releasing", key, self._ttl,
                )
                self._undo_assume(entry)
            elif (self._ext.decisions is not None
                    and self._ext.decisions.wants(key)):
                self._ext.decisions.record(key, "plan_expired")
            self._plans.pop(key, None)
            # the TTL horizon also retires the admit stamp: a pod whose
            # plan expired unbound restarts its pending-age clock if it
            # ever comes back
            self._enqueued_at.pop(key, None)

    def is_pending(self, pod_key: str) -> bool:
        """True while ``pod_key`` has an un-retired first-admit stamp —
        admitted and not yet bound, released or TTL'd out. The capacity
        recorder's stranded ledger uses this to expire entries whose
        demand left the system."""
        return pod_key in self._enqueued_at

    def pending_oldest_age(self, now: float) -> Optional[float]:
        """Oldest pending-admit age at clock time ``now`` (None when
        nothing is pending). Same bounded-retry snapshot as stats():
        admission threads insert while the recorder reads."""
        stamps: list[float] = []
        for _ in range(5):
            try:
                stamps = list(self._enqueued_at.values())
                break
            except RuntimeError:  # dict mutated mid-iteration
                continue
        if not stamps:
            return None
        return max(0.0, now - min(stamps))

    # -- observability -------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        """The /statusz "cycle" section."""
        from tpukube_torch.obs.registry import quantile

        lookups = self.plan_hits + self.plan_misses
        walls = list(self.cycle_walls)
        # pending-admit AGES, not just depth: drf_order can starve a
        # unit indefinitely while depth looks healthy — the oldest
        # admitted-but-never-bound age is the starvation signal, and
        # it survives refusal retries (first-admit stamps retire only
        # at bind/release/TTL). Snapshot with a bounded retry: /statusz
        # scrapes read while admission threads insert (the same guard
        # DecisionLog.events uses).
        now = self._ext.clock.monotonic()
        stamps: list[float] = []
        for _ in range(5):
            try:
                stamps = list(self._enqueued_at.values())
                break
            except RuntimeError:  # dict mutated mid-iteration
                continue
        ages = sorted(max(0.0, now - t) for t in stamps)
        return {
            "enabled": True,
            "cycles": self.cycles,
            "pods_planned": self.pods_planned,
            "queue_depth": len(self._queue),
            "queue_oldest_age_s": (round(ages[-1], 3) if ages else None),
            "queue_age_p50_s": (round(quantile(ages, 0.5), 3)
                                if ages else None),
            "queue_age_p99_s": (round(quantile(ages, 0.99), 3)
                                if ages else None),
            "plans_live": len(self._plans),
            "assumes": self.assumes,
            "assume_undos": self.assume_undos,
            # persistent fast-state maintenance + batched
            # gang planning — patches should dwarf rebuilds at scale
            "fast_patches": self.fast_patches,
            "fast_rebuilds": self.fast_rebuilds,
            "gang_batches": self.gang_batches,
            "gang_batch_members": self.gang_batch_members,
            "plan_hits": self.plan_hits,
            "plan_misses": self.plan_misses,
            "plan_hit_ratio": (round(self.plan_hits / lookups, 4)
                               if lookups else None),
            "last_batch_size": (self.batch_sizes[-1]
                                if self.batch_sizes else 0),
            "last_cycle_wall_s": (round(walls[-1], 6) if walls else None),
            # normalized planning cost — the perf-floor smoke's number
            # (cycle walls alone mix 1-pod and 1024-pod batches)
            "plan_ms_per_pod": (
                round(1000 * self.cycle_wall_total / self.pods_planned, 4)
                if self.pods_planned else None
            ),
            "batch_max_pods": self._max_pods,
            "cycle_interval_seconds": self._interval,
        }
