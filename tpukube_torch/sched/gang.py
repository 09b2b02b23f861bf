"""Gang scheduling — the port's own copy of ``tpukube/sched/gang.py``'s
reservation lifecycle.

All-or-nothing placement of N-pod job groups onto one contiguous box:

  1. The first member of a pod-group triggers a SLICE RESERVATION: slicefit
     finds a contiguous box for the whole gang (min_member x chips/pod,
     honouring an optional shape hint) across the mesh, spanning hosts.
     Reserved chips are invisible to non-gang placements. On an HGX fleet
     a 16-GPU gang is an (8, 2, 1) box: two whole hosts.
  2. Members bind one by one; each takes chips from the reservation on its
     bound node. The min_member-th bind COMMITS the gang (reservation
     latency recorded — the gang-schedule latency metric).
  3. TTL expiry before quorum rolls EVERYTHING back: assigned members'
     allocations are released and queued for eviction, their chips masked
     until the eviction is confirmed (``on_victim_gone``), and the
     reservation dissolves.
  4. A health fault on a reserved chip — or a downed link between two
     reserved chips — before commit rolls the gang back; the next filter
     cycle re-reserves from scratch on healthy, fully-linked chips.
  5. ``allow_dcn`` gangs that fit no single slice split into one
     contiguous box per slice.
  6. Preemption (the extender plans it with ``sched/policy.py``):
     ``reserve_exact*`` records the chosen box with its victims pending;
     the first bind claims them (``take_pending_victims``), gang victims
     ``dissolve`` whole, and ``register_terminating`` gates every member
     bind until each victim's pod object is confirmed gone.

Linearizability: one lock orders all reservation mutations; binds
re-validate against the reservation under that lock (optimistic callers
simply retry the cycle, same as ledger bind races).

With the durable journal on (``sched/journal.py``), every lifecycle seam
enqueues one WAL record (``gre``, ``gdrop``, ``evict``, ``gvtaken``,
``gterm``, ``gvgone``, ``gbound``, ``guncommit``, ``gmrel``, ``greas``)
in the reference's order, ``checkpoint_doc``/``restore_checkpoint`` carry
the reservations through a checkpoint, and ``apply_journal`` replays a
record. With the tenancy plane on (``tenancy/``) every reservation carries
its tenant, stamped by ``tenant_of`` at reservation time and restored
from the members' alloc env on a rebuild; with it off the tenant is "".
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from tpukube_torch.core.types import PodGroup, PodInfo, TopologyCoord
from tpukube_torch.obs.registry import Histogram
from tpukube_torch.sched import slicefit
from tpukube_torch.sched.snapshot import SnapshotCache, SnapshotDelta, sweep_for
from tpukube_torch.sched.state import ClusterState, StateError

log = logging.getLogger("tpukube_torch.gang")


class GangError(RuntimeError):
    pass


class NoSliceError(GangError):
    """No contiguous slice is free — the one GangError that may justify
    preemption. Configuration errors (shape/volume/chips-per-pod mismatch)
    must NOT trigger evictions."""


@dataclass
class GangReservation:
    """A gang's chip hold. Normally one contiguous box in one ICI slice;
    a gang that opted in to DCN spanning (``PodGroup.allow_dcn``, for
    data-parallel jobs whose gradient reduction tolerates DCN hops) may
    hold one contiguous sub-box in EACH of several slices. Members are
    whole within one slice either way (a pod's chips share a node)."""

    group: PodGroup
    namespace: str
    # slice id -> reserved chips in that slice (coords are slice-local)
    slice_coords: dict[str, set[TopologyCoord]]
    chips_per_pod: int
    priority: int = 0  # the reserving pods' priority (preemption blocking)
    # serving-plane tenant the reservation's chips are accounted to
    # ("" when tenancy is off — the TenantLedger never reads it then)
    tenant: str = ""
    created: float = field(default_factory=time.monotonic)
    # pod_key -> (slice id, that member's chips)
    assigned: dict[str, tuple[str, list[TopologyCoord]]] = field(
        default_factory=dict
    )
    # per-slice union of assigned coords, maintained by record_assignment/
    # drop_assignment (assigned_in runs per node per webhook — recomputing
    # the union there was measurable). Mutate assigned ONLY through those.
    _assigned_by_slice: dict[str, set[TopologyCoord]] = field(
        default_factory=dict
    )
    committed: bool = False
    commit_latency: Optional[float] = None
    # Two-phase preemption: the victim workloads this reservation plans to
    # evict, planned at /filter but EXECUTED only at the gang's first
    # /bind (extender._execute_pending_preemption). Until then the victims
    # keep running on the reserved chips; a reservation that TTLs out
    # unbound never evicts anyone. None once executed (or when the
    # reservation needed no preemption).
    pending_victims: Optional[list] = None
    # Executed-but-unconfirmed victims: a 2xx on the Eviction subresource
    # only STARTS graceful termination, so the victim physically holds its
    # chips until its pod object is gone. Member binds are gated on this
    # set being empty (extender.bind); the EvictionExecutor / lifecycle
    # watch clears entries through the recorded ``victim_gone`` decision.
    terminating_victims: set[str] = field(default_factory=set)

    def record_assignment(
        self, pod_key: str, slice_id: str, coords: list[TopologyCoord]
    ) -> None:
        self.assigned[pod_key] = (slice_id, list(coords))
        self._assigned_by_slice.setdefault(slice_id, set()).update(coords)

    def drop_assignment(self, pod_key: str) -> None:
        entry = self.assigned.pop(pod_key, None)
        if entry is not None:
            sid, coords = entry
            self._assigned_by_slice.get(sid, set()).difference_update(coords)

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.group.name)

    @property
    def spans_dcn(self) -> bool:
        return len(self.slice_coords) > 1

    @property
    def slice_id(self) -> str:
        """The sole slice of an ICI-confined gang. DCN-spanning gangs have
        no single slice — callers there iterate ``slice_coords``."""
        if self.spans_dcn:
            raise GangError(
                f"gang {self.key} spans {len(self.slice_coords)} slices"
            )
        return next(iter(self.slice_coords))

    @property
    def coords(self) -> set[TopologyCoord]:
        """Sole slice's chips (single-slice gangs; see slice_id)."""
        return self.slice_coords[self.slice_id]

    def total_chips(self) -> int:
        return sum(len(cs) for cs in self.slice_coords.values())

    def assigned_in(self, slice_id: str) -> set[TopologyCoord]:
        return self._assigned_by_slice.get(slice_id, set())

    def unassigned_in(self, slice_id: str) -> set[TopologyCoord]:
        return self.slice_coords.get(slice_id, set()) - self.assigned_in(slice_id)

    # single-slice conveniences (tests + single-slice call sites)
    def assigned_coords(self) -> set[TopologyCoord]:
        return self.assigned_in(self.slice_id)

    def unassigned_coords(self) -> set[TopologyCoord]:
        return self.unassigned_in(self.slice_id)


class GangManager:
    """Owns all live reservations; consulted by the extender on every
    filter/prioritize/bind involving a gang pod, and by non-gang placement
    to mask reserved chips."""

    LATENCY_WINDOW = 4096

    def __init__(self, state: ClusterState, ttl_seconds: float = 30.0,
                 eviction_sink: Optional[deque] = None, events=None,
                 clock=None):
        from tpukube_torch.core.clock import SYSTEM

        self._state = state
        self._ttl = ttl_seconds
        # scheduling-semantic time (reservation creation stamps, TTL
        # sweeps, commit-latency measurement against those stamps):
        # injectable for the discrete-event sim (core/clock.py)
        self._clock = clock if clock is not None else SYSTEM
        # structured event journal (obs/events.py), shared with the
        # owning Extender; None = no journal (standalone/unit tests)
        self._events = events
        # tenant resolver (pod -> tenant id), wired by the Extender
        # when the multi-tenant serving plane is on; None (the
        # default) stamps reservations with the empty tenant
        self.tenant_of = None
        # durable-state journal (sched/journal.py), wired by the owning
        # Extender when journal_enabled; None journals nothing
        self._journal = None
        # gre records replayed with an unexecuted pending-victim plan:
        # finish_replay() drops whichever never saw their plan executed
        # (gvtaken) — their reserved box may overlap victims' chips and
        # the plan itself cannot round-trip the WAL
        self._replay_pending: set[tuple[str, str]] = set()
        self._lock = threading.RLock()
        self._reservations: dict[tuple[str, str], GangReservation] = {}
        # reservation-created -> committed durations (north-star p50 feed)
        self.commit_latencies: deque[float] = deque(maxlen=self.LATENCY_WINDOW)
        # same durations as monotonic histogram buckets (the _bucket
        # series on /metrics are counters: cumulative since process
        # start, never windowed — aggregatable across scrapes/instances)
        self.commit_hist = Histogram("gang_schedule_latency_seconds",
                                     bucket_only=True)
        self.rollbacks = 0  # TTL/fault rollbacks observed (metrics/tests)
        # Cluster-wide eviction bus, owned by the Extender (which also feeds
        # it preemption victims); gang rollback/dissolve appends rolled-back
        # members here (all-or-nothing: a half-gang must not keep running).
        self._evictions: deque[str] = (
            eviction_sink if eviction_sink is not None else deque()
        )
        # Evicted-but-still-terminating victims' chips: pod_key ->
        # (slice_id, coords). These chips are ledger-free (the eviction
        # released them) but PHYSICALLY held until the pod object is gone;
        # reserved_coords masks them so no bystander binds onto a chip a
        # terminating container still owns. Entries die on on_victim_gone
        # — independent of the reservation, which may roll back first.
        self._terminating_coords: dict[
            str, tuple[str, frozenset[TopologyCoord]]
        ] = {}
        # reservation epoch: bumped by every mutation of reservations,
        # assignments, or the terminating masks — the gang half of the
        # scheduling-snapshot cache key (sched/snapshot.py). A mutation
        # path that forgets to bump serves stale placements; the
        # invalidation tests cover every seam.
        self._epoch = 0
        # The epoch-cached scheduling snapshot, shared with the owning
        # Extender: filter/prioritize/preemption cycles and the metrics
        # /statusz renders all read ONE snapshot per epoch instead of
        # re-deriving grids from the ledger per call.
        self.snapshots = SnapshotCache(state, self)
        # wire both epoch owners' delta streams into the cache's log so
        # it can advance O(Δ) instead of rebuilding per epoch (a second
        # GangManager on the same state re-points the sink; the orphaned
        # cache then degrades to full rebuilds via log gaps — never to
        # a stale snapshot)
        state.set_delta_sink(self.snapshots)

    def epoch(self) -> int:
        """Monotonic mutation counter (the snapshot cache's key half)."""
        with self._lock:
            return self._epoch

    def set_journal(self, journal) -> None:
        """Attach the durable-state journal (sched/journal.py); None
        detaches — recovery replays with the journal detached so the
        replayed mutations are not re-recorded."""
        with self._lock:
            self._journal = journal

    def _note_journal_locked(self, kind: str, data: dict) -> None:
        """Enqueue one gang-lifecycle WAL record (callers hold
        ``self._lock``; enqueue only — the journal's drain thread owns
        the file, so the gang lock never blocks on disk)."""
        journal = self._journal
        if journal is not None:
            journal.note(kind, data)

    @staticmethod
    def _res_doc(res: GangReservation) -> dict:
        """A reservation as a plain-JSON record (WAL ``gre`` payload and
        the Checkpoint's reservation list share this one shape)."""
        return {
            "ns": res.namespace,
            "g": {
                "n": res.group.name,
                "m": res.group.min_member,
                "shape": (list(res.group.shape)
                          if res.group.shape is not None else None),
                "dcn": res.group.allow_dcn,
            },
            "cpp": res.chips_per_pod,
            "prio": res.priority,
            "tenant": res.tenant,
            "committed": res.committed,
            # only the FLAG survives: a deferred (unexecuted) eviction
            # plan names live Workload objects that cannot round-trip —
            # recovery drops such reservations (the gang re-filters and
            # re-plans, exactly as after a legacy cold rebuild)
            "pv": bool(res.pending_victims),
            "sc": {sid: sorted([list(c) for c in coords])
                   for sid, coords in res.slice_coords.items()},
            "as": {pk: [sid, [list(c) for c in coords]]
                   for pk, (sid, coords) in res.assigned.items()},
            "tv": sorted(res.terminating_victims),
        }

    def _note_delta_locked(self, slices=(), why: str = "") -> None:
        """Record the gang-epoch bump just taken (callers hold
        ``self._lock`` and call this right after ``self._epoch += 1``).
        Gang deltas carry only the TOUCHED slice ids: the reserved /
        terminating masks of those slices are re-read from this manager
        at apply time — they are O(Δ)-small and their union semantics
        (unassigned reservation chips ∪ terminating victims, which may
        overlap) already live in ``reserved_coords``."""
        self.snapshots.note(SnapshotDelta(
            kind="gang", epoch=self._epoch,
            slices=tuple(slices), why=why,
        ))

    def _tenant_for(self, pod: PodInfo) -> str:
        """The reservation's tenant stamp; "" without a serving plane.
        A broken resolver must never fail a reservation."""
        if self.tenant_of is None:
            return ""
        try:
            return self.tenant_of(pod)
        except Exception:
            log.exception("tenant resolver failed for %s", pod.key())
            return ""

    def _emit(self, reason: str, res_key: tuple[str, str], message: str,
              warning: bool = False) -> None:
        """One journal event about a gang (no-op without a journal;
        never raises into the scheduling path)."""
        if self._events is None:
            return
        try:
            self._events.emit(
                reason, obj=f"gang/{res_key[0]}/{res_key[1]}",
                message=message,
                type="Warning" if warning else "Normal",
            )
        except Exception:
            log.exception("event emit failed: %s %s", reason, res_key)

    # -- views -------------------------------------------------------------
    def reservation(self, namespace: str, group_name: str) -> Optional[GangReservation]:
        with self._lock:
            return self._reservations.get((namespace, group_name))

    def reserved_coords(
        self, slice_id: Optional[str] = None
    ) -> set[TopologyCoord]:
        """Chips held for gang members that have not bound yet — masked out
        of every other placement. Coords are slice-local, so callers name
        the slice (None = all reservations, for single-slice callers).
        Assigned chips are NOT included: those live in the ledger as
        per-pod allocations already (state.commit runs before on_bound),
        and double-masking them would leak capacity after a committed
        gang's pods finish."""
        with self._lock:
            out: set[TopologyCoord] = set()
            for res in self._reservations.values():
                if slice_id is None:
                    for sid in res.slice_coords:
                        out |= res.unassigned_in(sid)
                else:
                    out |= res.unassigned_in(slice_id)
            # terminating victims' chips are ledger-free but physically
            # held: mask them exactly like unbound reservations
            for sid, coords in self._terminating_coords.values():
                if slice_id is None or sid == slice_id:
                    out |= coords
            return out

    # -- expiry / fault sweep ----------------------------------------------
    def sweep(self, now: Optional[float] = None) -> list[tuple[str, str]]:
        """Lazy janitor, called at the top of every gang interaction:
        rolls back (a) uncommitted reservations past TTL and (b) any
        uncommitted reservation whose slice lost a chip to a health fault
        or an internal ICI link to a link fault.
        Returns the rolled-back group keys."""
        now = self._clock.monotonic() if now is None else now
        rolled: list[tuple[str, str]] = []
        with self._lock:
            if all(r.committed for r in self._reservations.values()):
                # nothing sweepable (TTL/health/link rollback applies
                # only to UNCOMMITTED reservations, which the loop below
                # would skip anyway) — and this runs on every non-gang
                # filter, so skip the per-slice health/link snapshots
                return rolled
        # health/link state per slice from the epoch-cached snapshot
        # (this runs on every gang interaction; the direct accessors
        # re-scan every node view per call)
        snap = self.snapshots.current()
        unhealthy: dict[str, frozenset[TopologyCoord]] = {}
        broken: dict[str, frozenset] = {}
        for sid in snap.slice_ids():
            unhealthy[sid] = snap.slice(sid).unhealthy
            broken[sid] = snap.slice(sid).broken
        with self._lock:
            for key, res in list(self._reservations.items()):
                if res.committed:
                    continue
                # TTL-exempt while executed victims are still terminating:
                # those evictions are irreversible, so rolling the
                # reservation back would not un-evict anyone — it would
                # only let the gang re-reserve the victims' (ledger-free,
                # still physically held) chips and bind onto them, the
                # exact overlap the termination gate closes. The eviction
                # executor retries/confirms forever, so this state always
                # resolves (or pages the operator via /metrics).
                expired = (now - res.created > self._ttl
                           and not res.terminating_victims)
                sick = any(
                    coords & unhealthy.get(sid, set())
                    for sid, coords in res.slice_coords.items()
                )
                cut = any(
                    slicefit.coords_break_link(coords, broken.get(sid, set()))
                    for sid, coords in res.slice_coords.items()
                )
                if expired or sick or cut:
                    why = (
                        "TTL expired" if expired
                        else "chip fault in slice" if sick
                        else "ICI link fault in slice"
                    )
                    log.warning("gang %s/%s rollback: %s", key[0], key[1], why)
                    self._rollback_locked(res)
                    self._emit("GangRollback", key, why, warning=True)
                    rolled.append(key)
        return rolled

    def _evict_and_mask_locked(
        self, pod_key: str,
        entry: Optional[tuple[str, list[TopologyCoord]]],
    ) -> None:
        """The one way a gang layer eviction happens (rollback, dissolve,
        restore-rollback): release the ledger, queue the eviction for the
        executor, and mask the member's chips until the eviction is
        CONFIRMED. The pod may already be Running on its node — releasing
        the ledger alone would let another pod double-book those chips,
        and a rolled-back member terminates gracefully just like a
        preemption victim: a bystander bound onto its chip mid-grace
        would crash-loop on a single-owner TPU runtime. ``entry`` is the
        member's (slice, coords); None only when the coordinate space is
        genuinely unknown (restore with an unresolvable node on a
        multi-slice cluster) — then the mask is impossible and skipped."""
        self._state.release(pod_key)
        self._evictions.append(pod_key)
        if entry is not None and entry[1]:
            self._terminating_coords[pod_key] = (
                entry[0], frozenset(entry[1])
            )
        self._epoch += 1
        self._note_delta_locked(
            slices=(entry[0],) if entry is not None else (),
            why=f"evict+mask {pod_key}",
        )
        # WAL: the eviction INTENT plus the terminating mask — recovery
        # re-queues the eviction (if the pod still exists) so a
        # half-died gang finishes dying across a crash
        self._note_journal_locked("evict", {
            "p": pod_key,
            "sid": entry[0] if entry is not None else None,
            "c": ([list(c) for c in entry[1]]
                  if entry is not None else []),
        })
        # WAL: the eviction INTENT plus the terminating mask — recovery
        # re-queues the eviction (if the pod still exists) so a
        # half-died gang finishes dying across a crash

    def _rollback_locked(self, res: GangReservation) -> None:
        for pod_key in list(res.assigned):
            self._evict_and_mask_locked(pod_key, res.assigned.get(pod_key))
        self._reservations.pop(res.key, None)
        self._epoch += 1
        self._note_delta_locked(slices=res.slice_coords,
                                why=f"rollback {res.key}")
        self._note_journal_locked(
            "gdrop", {"ns": res.namespace, "g": res.group.name})
        self.rollbacks += 1

    # -- reservation -------------------------------------------------------
    def ensure_reservation(
        self, pod: PodInfo, chips_per_pod: int
    ) -> GangReservation:
        """Get or create the slice reservation for a gang pod's group.
        Raises GangError when no contiguous slice exists."""
        assert pod.group is not None
        self.sweep()
        with self._lock:
            key = (pod.namespace, pod.group.name)
            res = self._reservations.get(key)
            if res is not None:
                if res.chips_per_pod != chips_per_pod:
                    raise GangError(
                        f"gang {key}: member {pod.key()} wants {chips_per_pod} "
                        f"chips/pod but the reservation was made for "
                        f"{res.chips_per_pod}"
                    )
                return res
            slice_ids = self._state.slice_ids()
            if not slice_ids:
                raise GangError("no node topology known yet")
            total = pod.group.min_member * chips_per_pod
            if pod.group.shape is not None:
                sx, sy, sz = pod.group.shape
                if sx * sy * sz != total:
                    raise GangError(
                        f"gang {key}: shape {pod.group.shape} holds "
                        f"{sx * sy * sz} chips but the gang needs {total}"
                    )
            # A gang is ICI-contiguous, hence confined to ONE slice by
            # default (DCN crossings are the thing the scorer exists to
            # prevent). Slice choice bin-packs: the fullest slice that
            # still fits wins, so emptier slices stay whole for bigger
            # gangs. Deterministic tie-break on slice id.
            chosen: Optional[tuple[float, str, list[TopologyCoord]]] = None
            free_total = 0
            # one snapshot for the whole reservation cycle: the blocked
            # sweep (occupied | reserved, integral image prebuilt) is
            # shared with every other search of this epoch
            snap = self.snapshots.current()
            for sid in slice_ids:
                ss = snap.slice(sid)
                free_total += ss.blocked_free_chips
                coords = slicefit.find_slice_in(
                    ss.blocked_sweep(),
                    count=None if pod.group.shape is not None else total,
                    shape=pod.group.shape,
                    broken=ss.broken,
                )
                if coords is None:
                    continue
                rank = (-ss.utilization, sid)
                if chosen is None or rank < (chosen[0], chosen[1]):
                    chosen = (rank[0], sid, coords)
            if chosen is not None:
                _, sid, coords = chosen
                slice_coords = {sid: set(coords)}
            elif pod.group.allow_dcn and pod.group.shape is None:
                # DCN-spanning fallback (opt-in, DP-style jobs): one
                # contiguous sub-box per slice, every sub-box a multiple
                # of chips_per_pod so members stay slice-whole.
                slice_coords = self._plan_dcn_split(
                    total, chips_per_pod, slice_ids
                )
                if slice_coords is None:
                    raise NoSliceError(
                        f"gang {key}: {total} chips not coverable by "
                        f"per-slice contiguous boxes across "
                        f"{len(slice_ids)} ICI slices ({free_total} free)"
                    )
            else:
                raise NoSliceError(
                    f"gang {key}: no contiguous {total}-chip slice available "
                    f"in any of {len(slice_ids)} ICI slices "
                    f"({free_total} chips free)"
                )
            res = GangReservation(
                group=pod.group,
                namespace=pod.namespace,
                slice_coords=slice_coords,
                chips_per_pod=chips_per_pod,
                priority=pod.priority,
                tenant=self._tenant_for(pod),
                created=self._clock.monotonic(),
            )
            self._reservations[key] = res
            self._epoch += 1
            self._note_delta_locked(slices=slice_coords, why=f"reserve {key}")
            self._note_journal_locked("gre", self._res_doc(res))
            log.info(
                "gang %s/%s reserved %d chips over %d slice(s)",
                key[0], key[1], res.total_chips(), len(slice_coords),
            )
            self._emit(
                "GangReserved", key,
                f"{res.total_chips()} chips over "
                f"{len(slice_coords)} slice(s)",
            )
            return res

    def _plan_dcn_split(
        self, total: int, chips_per_pod: int, slice_ids: list[str]
    ) -> Optional[dict[str, set[TopologyCoord]]]:
        """Partition ``total`` chips into per-slice contiguous boxes, each a
        multiple of chips_per_pod. Greedy: slices in descending free
        capacity (tie: slice id), taking the largest box that fits the
        remaining need first — fewest DCN boundaries for the job, emptiest
        slices consumed first (the single-slice path already failed, so
        bin-packing has nothing left to protect)."""
        snap = self.snapshots.current()
        free_rank = sorted(
            slice_ids,
            key=lambda s: (snap.slice(s).utilization, s),
        )
        parts: dict[str, set[TopologyCoord]] = {}
        remaining = total
        for sid in free_rank:
            if remaining == 0:
                break
            ss = snap.slice(sid)
            # ONE box per slice — the TPU_KUBE_GANG_* contract promises the
            # in-pod runtime one contiguous ICI sub-mesh per slice part
            free_here = ss.blocked_free_chips
            vol = min(remaining, (free_here // chips_per_pod) * chips_per_pod)
            while vol >= chips_per_pod:
                coords = slicefit.find_slice_in(
                    ss.blocked_sweep(), count=vol, broken=ss.broken
                )
                if coords is not None:
                    parts[sid] = set(coords)
                    remaining -= len(coords)
                    break
                vol -= chips_per_pod
        return parts if remaining == 0 else None

    def dissolve(self, key: tuple[str, str]) -> list[str]:
        """Evict a whole gang (preemption victim): release every member's
        allocation, queue their evictions, drop the reservation. Gangs die
        all-or-nothing exactly as they are born. Returns evicted pod keys."""
        with self._lock:
            # look up before popping: the no-such-gang path mutates
            # nothing and owes no epoch bump
            res = self._reservations.get(key)
            if res is None:
                return []
            self._reservations.pop(key, None)
            self._epoch += 1
            self._note_delta_locked(slices=res.slice_coords,
                                    why=f"dissolve {key}")
            self._note_journal_locked("gdrop", {"ns": key[0], "g": key[1]})
            evicted = []
            for pod_key in list(res.assigned):
                self._evict_and_mask_locked(pod_key,
                                            res.assigned.get(pod_key))
                evicted.append(pod_key)
            log.warning(
                "gang %s/%s dissolved by preemption (%d members evicted)",
                key[0], key[1], len(evicted),
            )
            self._emit(
                "GangDissolved", key,
                f"preempted; {len(evicted)} member(s) evicted",
                warning=True,
            )
            return evicted

    def snapshot(self) -> list[GangReservation]:
        """Stable copy of live reservations (the preemption planner's view)."""
        with self._lock:
            return list(self._reservations.values())

    def restore(
        self, namespace: str, group: PodGroup, allocs: list
    ) -> Optional[GangReservation]:
        """Rebuild a gang's reservation from its members' restored
        allocations after an extender restart (the extender's
        rebuild_from_pods). Without this, running gang members look like
        free-standing pods to the preemption planner and could be evicted
        individually — partial gang death. ``allocs`` are the members'
        AllocResults (already committed to the ledger).

        A quorum of members means the gang had committed: restore it as
        committed with exactly its members' chips. A partial set (restart
        mid-assembly) lost its in-memory unassigned-chip pool, so re-derive
        it: find a full-size free box CONTAINING the members' chips; if none
        exists the gang can never complete — roll it back now (members
        released + queued for eviction), all-or-nothing in death as in
        birth, rather than letting late members bind as strays."""
        with self._lock:
            key = (namespace, group.name)
            if key in self._reservations or not allocs:
                return self._reservations.get(key)
            chips_per_pod = max(1, len(allocs[0].coords))
            member_slices: dict[str, str] = {}

            def rollback_all(why: str) -> None:
                log.warning("gang %s/%s: %s — rolling back",
                            namespace, group.name, why)
                self._emit("GangRollback", key, why, warning=True)
                for a in allocs:
                    # restored members may be RUNNING: mask their chips
                    # until the eviction confirms. Prefer the resolved
                    # member_slices entry (it carries the single-slice
                    # fallback for nodes whose view is gone); only a
                    # multi-slice cluster with an unresolvable node
                    # leaves the coordinate space unknown (mask skipped).
                    sid = member_slices.get(a.pod_key)
                    if sid is None:
                        sid = self._state.slice_of_node(a.node_name)
                    entry = (
                        (sid, [TopologyCoord.of(c) for c in a.coords])
                        if sid is not None else None
                    )
                    self._evict_and_mask_locked(a.pod_key, entry)
                self.rollbacks += 1

            # the members' nodes know which ICI slice(s) the gang lives in;
            # with a node view gone, only an unambiguous (single-slice)
            # cluster lets us proceed — guessing would mix coord spaces
            for a in allocs:
                sid = self._state.slice_of_node(a.node_name)
                if sid is None:
                    sids = self._state.slice_ids()
                    if len(sids) != 1:
                        rollback_all(
                            f"member node {a.node_name} unknown and cluster "
                            f"has {len(sids)} slices"
                        )
                        return None
                    sid = sids[0]  # guard above guarantees exactly one
                member_slices[a.pod_key] = sid
            committed = len(allocs) >= group.min_member
            by_slice: dict[str, set[TopologyCoord]] = {}
            for a in allocs:
                by_slice.setdefault(member_slices[a.pod_key], set()).update(
                    a.coords
                )
            if len(by_slice) > 1:
                # DCN-spanning gang: committed restores with exactly the
                # members' chips; mid-assembly the split plan is gone and
                # not re-derivable (which sub-box was whose?) — roll back
                if not committed:
                    rollback_all(
                        f"restart found {len(allocs)}/{group.min_member} "
                        f"members of a DCN-spanning gang"
                    )
                    return None
                slice_coords = by_slice
            else:
                slice_id = next(iter(by_slice))
                coords = set(by_slice[slice_id])
                if not committed:
                    coords_or_none = self._recomplete_slice(
                        group, chips_per_pod, coords, slice_id
                    )
                    if coords_or_none is None:
                        rollback_all(
                            f"restart found {len(allocs)}/{group.min_member} "
                            f"members and no completable slice"
                        )
                        return None
                    coords = coords_or_none
                slice_coords = {slice_id: coords}
            from tpukube_torch.device.gpu import ENV_KUBE_TENANT

            res = GangReservation(
                group=group,
                namespace=namespace,
                slice_coords=slice_coords,
                chips_per_pod=chips_per_pod,
                priority=max(a.priority for a in allocs),
                # tenant attribution survives the restart through the
                # members' alloc-annotation env, like the chips do
                tenant=next(
                    (a.env.get(ENV_KUBE_TENANT) for a in allocs
                     if a.env.get(ENV_KUBE_TENANT)), "",
                ),
                created=self._clock.monotonic(),
            )
            for a in allocs:
                res.record_assignment(
                    a.pod_key, member_slices[a.pod_key], list(a.coords)
                )
            res.committed = committed
            self._reservations[key] = res
            self._epoch += 1
            self._note_delta_locked(slices=slice_coords, why=f"restore {key}")
            self._note_journal_locked("gre", self._res_doc(res))
            log.info(
                "gang %s/%s restored from pod annotations: %d members, "
                "committed=%s", namespace, group.name, len(res.assigned),
                res.committed,
            )
            return res

    def _recomplete_slice(
        self,
        group: PodGroup,
        chips_per_pod: int,
        assigned: set[TopologyCoord],
        slice_id: str,
    ) -> Optional[set[TopologyCoord]]:
        """Full-size contiguous box containing ``assigned``, treating the
        members' own chips as free (they are the gang's). None if the mesh
        is unknown or no such box exists."""
        try:
            mesh = self._state.slice_mesh(slice_id)
        except StateError:
            return None
        total = group.min_member * chips_per_pod
        shape = group.shape
        if shape is not None and shape[0] * shape[1] * shape[2] != total:
            shape = None  # malformed hint: fall back to count search
        snap = self.snapshots.current()
        ss = snap.slice(slice_id)
        # members-look-free is request-specific: an ad-hoc sweep (via the
        # snapshot module's sole constructor seam), not the cached one
        # absent stays blocked even where a member was assigned: a chip
        # whose host left cannot be restored onto
        occupied = ((ss.occupied | ss.reserved) - assigned) | ss.absent
        sweep = sweep_for(mesh, occupied)
        best: Optional[tuple] = None
        for sb in slicefit.iter_free_boxes_in(
            sweep,
            count=total if shape is None else None,
            shape=shape,
            broken=ss.broken,
        ):
            box_set = set(slicefit.box_coords(mesh, sb.box))
            if assigned <= box_set and (
                best is None or sb.sort_key < best[0]
            ):
                best = (sb.sort_key, box_set)
        return best[1] if best is not None else None

    def reserve_exact(
        self, pod: PodInfo, chips_per_pod: int, coords: list[TopologyCoord],
        slice_id: str, pending_victims: Optional[list] = None,
    ) -> GangReservation:
        """Reserve a specific chip set (the preemption path: policy already
        chose the box and its victims). ``pending_victims`` defers the
        evictions to the gang's first bind (two-phase preemption). Raises
        if any non-victim chip was taken since planning — the scheduler
        retries."""
        return self.reserve_exact_split(
            pod, chips_per_pod, {slice_id: list(coords)},
            pending_victims=pending_victims,
        )

    def reserve_exact_split(
        self, pod: PodInfo, chips_per_pod: int,
        parts: dict[str, list[TopologyCoord]],
        pending_victims: Optional[list] = None,
    ) -> GangReservation:
        """Reserve specific per-slice chip sets (single- or multi-slice
        preemption). ``pending_victims`` (policy.Workload list) records the
        eviction plan WITHOUT executing it: their chips may legitimately
        still be occupied, and stay so until the gang's first bind. Raises
        if any chip outside the victim set is occupied — the scheduler
        retries."""
        assert pod.group is not None
        victim_held: dict[str, set[TopologyCoord]] = {}
        for w in pending_victims or ():
            victim_held.setdefault(w.slice_id, set()).update(w.coords)
        with self._lock:
            key = (pod.namespace, pod.group.name)
            existing = self._reservations.get(key)
            if existing is not None:
                return existing  # lost a benign race with a sibling member
            expected = pod.group.min_member * chips_per_pod
            got = sum(len(cs) for cs in parts.values())
            if got != expected:
                raise GangError(
                    f"gang {key}: preemption opened {got} chips but "
                    f"the gang needs {expected}"
                )
            victim_gangs = {
                w.gang_key for w in pending_victims or () if w.gang_key
            }
            snap = self.snapshots.current()
            for slice_id, coords in parts.items():
                try:
                    ss = snap.slice(slice_id)
                except KeyError:
                    raise GangError(
                        f"gang {key}: unknown slice {slice_id!r}"
                    ) from None
                # victim-held chips may legitimately still be OCCUPIED
                # (their eviction is deferred), but another reservation's
                # coords always clash — only reservations that are
                # themselves declared victims (dissolved at execution)
                # are exempt
                reserved: set[TopologyCoord] = set()
                for other in self._reservations.values():
                    if other.key not in victim_gangs:
                        reserved |= other.unassigned_in(slice_id)
                occupied = (
                    ss.occupied - victim_held.get(slice_id, set())
                ) | reserved
                # terminating victims' chips are ledger-free (their
                # eviction already released them) but physically held
                # until the pod object is gone — a preemption-opened box
                # overlapping them would bind members onto chips a dying
                # container still owns, with zero victims to gate on
                occupied |= ss.terminating
                clash = [c for c in coords if c in occupied]
                if clash:
                    raise GangError(
                        f"gang {key}: preempted box re-occupied at "
                        f"{clash[:3]} in {slice_id}; retry"
                    )
                if slicefit.coords_break_link(set(coords), ss.broken):
                    raise GangError(
                        f"gang {key}: preempted box in {slice_id} spans a "
                        f"downed ICI link; retry"
                    )
            res = GangReservation(
                group=pod.group,
                namespace=pod.namespace,
                slice_coords={s: set(cs) for s, cs in parts.items()},
                chips_per_pod=chips_per_pod,
                priority=pod.priority,
                tenant=self._tenant_for(pod),
                created=self._clock.monotonic(),
                pending_victims=(
                    list(pending_victims) if pending_victims else None
                ),
            )
            self._reservations[key] = res
            self._epoch += 1
            self._note_delta_locked(slices=parts, why=f"reserve-exact {key}")
            self._note_journal_locked("gre", self._res_doc(res))
            log.info(
                "gang %s/%s reserved %d chips over %d slice(s) via preemption"
                " (%d victim workload(s) pending first bind)",
                key[0], key[1], res.total_chips(), len(parts),
                len(pending_victims or ()),
            )
            self._emit(
                "GangReserved", key,
                f"{res.total_chips()} chips over {len(parts)} slice(s) "
                f"via preemption "
                f"({len(pending_victims or ())} victim(s) pending)",
            )
            return res

    def peek_pending_victims(self, res: GangReservation) -> list:
        """The deferred eviction plan, without claiming it (the extender
        pre-validates the bind against it before executing)."""
        with self._lock:
            if self._reservations.get(res.key) is not res:
                return []
            return list(res.pending_victims or [])

    def take_pending_victims(self, res: GangReservation) -> list:
        """Atomically claim a reservation's deferred eviction plan (empty
        if already executed, or if the reservation was replaced). The
        caller — extender bind, under the decision lock — executes it."""
        with self._lock:
            if self._reservations.get(res.key) is not res:
                return []
            victims = res.pending_victims or []
            res.pending_victims = None
            if victims:
                # WAL: the deferred plan is now EXECUTING — a recovery
                # no longer drops this reservation as plan-lost
                self._note_journal_locked(
                    "gvtaken", {"ns": res.namespace, "g": res.group.name})
            return list(victims)

    def register_terminating(
        self, res: GangReservation,
        held: dict[str, tuple[str, list[TopologyCoord]]],
    ) -> None:
        """Record executed evictions awaiting confirmed termination:
        ``held`` maps each evicted pod to the (slice, coords) its
        containers still physically hold. Gates the gang's member binds
        AND masks the chips from every other placement until
        on_victim_gone confirms the pod object is gone."""
        if not held:
            return
        with self._lock:
            for pod_key, (sid, coords) in held.items():
                res.terminating_victims.add(pod_key)
                if coords:
                    self._terminating_coords[pod_key] = (
                        sid, frozenset(coords)
                    )
            self._epoch += 1
            self._note_delta_locked(
                slices={sid for sid, _ in held.values()},
                why=f"register-terminating {res.key}",
            )
            self._note_journal_locked("gterm", {
                "ns": res.namespace, "g": res.group.name,
                "pods": {pk: [sid, [list(c) for c in coords]]
                         for pk, (sid, coords) in held.items()},
            })

    def on_victim_gone(self, pod_key: str) -> bool:
        """A terminating eviction victim's pod object is confirmed gone
        (EvictionExecutor / lifecycle watch, via the recorded
        ``victim_gone`` decision): unmask its chips and unblock any gang
        waiting on it. Returns True if anything was tracking the pod."""
        with self._lock:
            # membership first, pop only on a hit: the unknown-pod path
            # mutates nothing and owes no bump
            entry = self._terminating_coords.get(pod_key)
            hit = entry is not None
            gated = False
            for res in self._reservations.values():
                if pod_key in res.terminating_victims:
                    res.terminating_victims.discard(pod_key)
                    gated = True
                    if not res.terminating_victims:
                        log.info(
                            "gang %s/%s: all preemption victims terminated; "
                            "member binds may proceed",
                            res.namespace, res.group.name,
                        )
            if not hit and not gated:
                return False
            if hit:
                self._terminating_coords.pop(pod_key, None)
                if self._events is not None:
                    try:
                        self._events.emit(
                            "VictimGone", obj=f"pod/{pod_key}",
                            message="eviction victim's pod object "
                                    "confirmed gone; its chips are "
                                    "placeable again",
                        )
                    except Exception:
                        log.exception("event emit failed: VictimGone %s",
                                      pod_key)
                # the unmasked chips are placeable again: invalidate
                self._epoch += 1
                self._note_delta_locked(slices=(entry[0],),
                                        why=f"victim-gone {pod_key}")
            # WAL: ONE record covers both the coord unmask and the
            # bind-gate clear (a reservation can gate on a victim whose
            # alloc carried no coords — the record must still replay)
            self._note_journal_locked("gvgone", {"p": pod_key})
            return True

    def terminating_victims_of(self, res: GangReservation) -> set[str]:
        """Victims whose termination still gates this gang's binds."""
        with self._lock:
            return set(res.terminating_victims)

    def terminating_count(self) -> int:
        """Evicted-but-unconfirmed victims cluster-wide (metrics)."""
        with self._lock:
            return len(self._terminating_coords)

    def terminating_pod_keys(self) -> list[str]:
        """Every pod key any terminating bookkeeping still tracks —
        coord masks AND reservation bind gates."""
        with self._lock:
            keys = set(self._terminating_coords)
            for res in self._reservations.values():
                keys |= res.terminating_victims
            return sorted(keys)

    def terminating_coords(self, slice_id: str) -> set[TopologyCoord]:
        """Chips of evicted-but-still-terminating pods in one slice:
        ledger-free and reservation-free but PHYSICALLY held until the
        eviction is confirmed."""
        with self._lock:
            out: set[TopologyCoord] = set()
            for sid, coords in self._terminating_coords.values():
                if sid == slice_id:
                    out |= coords
            return out

    # -- per-node queries for the extender ----------------------------------
    def _node_slice(
        self, res: GangReservation, node_name: str
    ) -> Optional[str]:
        """Which of the reservation's slices this node belongs to (None if
        the gang holds nothing in the node's ICI domain)."""
        sid = self._state.slice_of_node(node_name)
        return sid if sid in res.slice_coords else None

    def node_availability(
        self, res: GangReservation
    ) -> dict[str, tuple[int, int]]:
        """Per-node (unassigned, total) reserved-chip counts in ONE pass
        over the reservation. filter/prioritize call this once per
        webhook and answer every node from it — the per-node coord scan
        (O(nodes x reserved chips) per webhook) was the hottest
        app-level term in the 64-member gang-commit profile."""
        snapshots = {
            sid: self._state.hosts_by_coord(sid) for sid in res.slice_coords
        }
        out: dict[str, list[int]] = {}
        with self._lock:
            for sid, coords in res.slice_coords.items():
                hosts = snapshots[sid]
                unassigned = res.unassigned_in(sid)
                for c in coords:
                    h = hosts.get(c)
                    if h is None:
                        continue
                    entry = out.setdefault(h, [0, 0])
                    entry[1] += 1
                    if c in unassigned:
                        entry[0] += 1
        return {h: (a, t) for h, (a, t) in out.items()}

    def feasibility_from(
        self, counts: dict[str, tuple[int, int]], res: GangReservation,
        node_name: str,
    ) -> Optional[str]:
        """node_feasibility answered from a node_availability snapshot.

        A node absent from the snapshot hosts NONE of the reservation's
        coords. When the node's whole ICI slice is outside the
        reservation — the commonest infeasible case — report the
        historical no-chips-in-slice reason instead of a misleading
        '0 unassigned chips here'; an in-slice node
        that merely hosts none of the reserved chips keeps the counted
        message."""
        entry = counts.get(node_name)
        if entry is None:
            if self._node_slice(res, node_name) is None:
                return "gang holds no chips in this node's ICI slice"
            entry = (0, 0)
        avail = entry[0]
        if avail < res.chips_per_pod:
            return (
                f"gang slice has {avail} unassigned chips here, "
                f"pod needs {res.chips_per_pod}"
            )
        return None

    @staticmethod
    def score_from(
        counts: dict[str, tuple[int, int]], node_name: str
    ) -> int:
        """node_score from a node_availability snapshot: more unassigned
        reserved chips on the node = higher score — fill the slice host
        by host so members land dense, not scattered."""
        avail, total = counts.get(node_name, (0, 0))
        return round(10 * avail / total) if total else 0


    def plan_for_bind(
        self, res: GangReservation, pod: PodInfo, node_name: str
    ) -> list[TopologyCoord]:
        """Pick this member's chips from the reservation on its node,
        preferring chips adjacent to already-assigned ones (members that
        talk most ride the shortest ICI paths)."""
        sid = self._node_slice(res, node_name)
        if sid is None:
            raise GangError(
                f"gang {res.key}: no reserved chips in {node_name}'s slice"
            )
        mesh = self._state.slice_mesh(sid)
        hosts = self._state.hosts_by_coord(sid)
        with self._lock:
            if res.key not in self._reservations:
                raise GangError(f"gang {res.key}: reservation dissolved; retry")
            if pod.key() in res.assigned:
                raise GangError(f"{pod.key()} already assigned in gang")
            avail = sorted(
                c for c in res.unassigned_in(sid)
                if hosts.get(c) == node_name
            )
            if len(avail) < res.chips_per_pod:
                raise GangError(
                    f"gang {res.key}: node {node_name} no longer has "
                    f"{res.chips_per_pod} unassigned slice chips"
                )
            anchor = res.assigned_in(sid)
            chosen: list[TopologyCoord] = []
            pool = list(avail)
            for _ in range(res.chips_per_pod):
                best = max(
                    pool,
                    key=lambda c: (
                        sum(1 for nb in mesh.neighbors(c) if nb in anchor or nb in chosen),
                        tuple(-v for v in c),
                    ),
                )
                chosen.append(best)
                pool.remove(best)
            return chosen

    def on_bound(self, res: GangReservation, pod_key: str,
                 coords: list[TopologyCoord], node_name: str) -> bool:
        """Record a member's successful ledger commit; the quorum member
        commits the whole gang. Returns True when THIS bind triggered the
        commit — the caller needs it to undo truthfully if its external
        bind effector subsequently fails (undo_commit)."""
        sid = self._node_slice(res, node_name)
        if sid is None:
            raise GangError(
                f"gang {res.key}: bound node {node_name} is outside the "
                f"reservation's slices"
            )
        with self._lock:
            live = self._reservations.get(res.key)
            if live is not res:
                raise GangError(f"gang {res.key}: reservation replaced mid-bind")
            bad = [c for c in coords if c not in res.unassigned_in(sid)]
            if bad:
                raise GangError(f"gang {res.key}: coords {bad} not reservable")
            res.record_assignment(pod_key, sid, list(coords))
            self._epoch += 1
            self._note_delta_locked(slices=(sid,), why=f"bound {pod_key}")
            self._note_journal_locked("gbound", {
                "ns": res.namespace, "g": res.group.name, "p": pod_key,
                "sid": sid, "c": [list(c) for c in coords],
            })
            if not res.committed and len(res.assigned) >= res.group.min_member:
                res.committed = True
                res.commit_latency = self._clock.monotonic() - res.created
                self.commit_latencies.append(res.commit_latency)
                self.commit_hist.observe(res.commit_latency)
                log.info(
                    "gang %s/%s COMMITTED: %d members in %.3fs",
                    res.namespace, res.group.name,
                    len(res.assigned), res.commit_latency,
                )
                self._emit(
                    "GangCommitted", res.key,
                    f"{len(res.assigned)} members in "
                    f"{res.commit_latency:.3f}s",
                )
                return True
        return False

    def undo_commit(self, res: GangReservation) -> None:
        """Revert a commit whose triggering bind failed at the apiserver:
        the quorum never truly assembled, so the committed flag (which
        exempts the reservation from the TTL/health sweep) and the
        recorded north-star latency sample must both go — otherwise a
        failing apiserver leaves a committed-below-quorum reservation
        masking chips forever and a latency sample for a commit that
        never happened."""
        with self._lock:
            if not res.committed:
                return
            res.committed = False
            self._note_journal_locked(
                "guncommit", {"ns": res.namespace, "g": res.group.name})
            try:
                # remove by value, not tail position: the effector runs
                # outside the decision lock, so another gang's commit can
                # land between this gang's commit and its undo
                self.commit_latencies.remove(res.commit_latency)
            except ValueError:
                pass  # window overflow evicted it already
            log.warning(
                "gang %s/%s commit UNDONE (quorum bind failed at the "
                "apiserver)", res.namespace, res.group.name,
            )

    # -- pod lifecycle -------------------------------------------------------
    def assignable(self, res: GangReservation, chips_per_pod: int) -> bool:
        """True while the reservation still has room for another member —
        room in SOME one slice (a member's chips never straddle slices).
        Replicas beyond min_member of a committed gang get False — they
        fall through to normal (non-gang) scheduling in the extender."""
        with self._lock:
            return any(
                len(res.unassigned_in(sid)) >= chips_per_pod
                for sid in res.slice_coords
            )

    def on_release(self, pod_key: str) -> None:
        """A gang member's pod went away. Uncommitted gang: the chips return
        to the reservation pool (a replacement member can take them).
        Committed gang: ditto while other members live; when the LAST member
        of a committed gang is released the reservation dissolves — keeping
        it would mask the freed chips forever (capacity leak)."""
        with self._lock:
            for res in self._reservations.values():
                if pod_key in res.assigned:
                    sid = res.assigned[pod_key][0]
                    res.drop_assignment(pod_key)
                    if res.committed and not res.assigned:
                        self._reservations.pop(res.key, None)
                        log.info(
                            "gang %s/%s dissolved (all members released)",
                            res.namespace, res.group.name,
                        )
                    # one bump AFTER the last seam of the batch (the
                    # epoch-discipline lint checks bump-follows-seam)
                    self._epoch += 1
                    self._note_delta_locked(
                        slices=(sid,), why=f"member-release {pod_key}")
                    self._note_journal_locked("gmrel", {"p": pod_key})
                    return

    def reassign(self, pod_key: str, coords: list[TopologyCoord]) -> bool:
        """Repoint a bound member's recorded chips (device-id reconcile:
        the kubelet allocated different chips than planned — the ledger
        already follows reality; gang bookkeeping must too, or released
        members would free the WRONG coords back into the pool). The
        reservation's chip pool moves with it: the abandoned planned
        coords leave slice_coords (they are ledger-free — keeping them
        'reserved but unassigned' would mask free chips forever and
        re-open assignable()), and the actual coords join it."""
        with self._lock:
            for res in self._reservations.values():
                entry = res.assigned.get(pod_key)
                if entry is not None:
                    sid, old = entry
                    res.drop_assignment(pod_key)
                    pool = res.slice_coords.get(sid, set())
                    pool.difference_update(old)
                    pool.update(coords)
                    res.slice_coords[sid] = pool
                    res.record_assignment(pod_key, sid, list(coords))
                    self._epoch += 1
                    # net reserved change is empty (old coords leave
                    # pool+assigned, new join both), but the note keeps
                    # the delta chain contiguous for this bump
                    self._note_delta_locked(
                        slices=(sid,), why=f"reassign {pod_key}")
                    self._note_journal_locked("greas", {
                        "p": pod_key, "c": [list(c) for c in coords],
                    })
                    return True
        return False

    # -- durable-state checkpoint + WAL replay (sched/journal.py) ------------
    def checkpoint_doc(self) -> dict:
        """Reservations + terminating masks as a plain-JSON Checkpoint
        fragment (in-memory only; the journal's drain thread owns the
        serialization and the disk)."""
        with self._lock:
            return {
                "epoch": self._epoch,
                "res": [self._res_doc(r)
                        for r in self._reservations.values()],
                "term": {pk: [sid, sorted(list(c) for c in coords)]
                         for pk, (sid, coords)
                         in self._terminating_coords.items()},
            }

    def _res_from_doc_locked(self, doc: dict) -> GangReservation:
        """Rebuild a GangReservation from a ``_res_doc`` record
        (callers hold ``self._lock`` and register the result; the
        member re-assignment is a seam event, so this helper owns an
        epoch bump of its own — the callers' registration bump then
        covers the reservation map write). The created stamp is NOW
        (fresh TTL — exactly the grace a legacy restore grants); an
        unexecuted eviction plan never round-trips (see ``_res_doc``)."""
        g = doc["g"]
        group = PodGroup(
            name=g["n"], min_member=int(g["m"]),
            shape=(tuple(int(v) for v in g["shape"])
                   if g.get("shape") else None),
            allow_dcn=bool(g.get("dcn")),
        )
        res = GangReservation(
            group=group,
            namespace=doc["ns"],
            slice_coords={
                sid: {TopologyCoord(*c) for c in coords}
                for sid, coords in doc["sc"].items()
            },
            chips_per_pod=int(doc["cpp"]),
            priority=int(doc["prio"]),
            tenant=doc.get("tenant", ""),
            created=self._clock.monotonic(),
        )
        for pk, entry in doc.get("as", {}).items():
            res.record_assignment(
                pk, entry[0], [TopologyCoord(*c) for c in entry[1]]
            )
        res.committed = bool(doc.get("committed"))
        for pk in doc.get("tv", ()):
            res.terminating_victims.add(pk)
        self._epoch += 1
        # without the delta note this bump is a GAP in the contiguous
        # delta chain: the first post-replay lookup would fall off the
        # O(Δ) advance into a full rebuild (no journal note: this IS
        # replay; noting would re-record)
        self._note_delta_locked(slices=res.slice_coords,
                                why=f"replayed reservation {res.key}")
        return res

    def restore_checkpoint(self, doc: dict) -> int:
        """Rebuild reservations and terminating masks VERBATIM from a
        Checkpoint fragment onto a fresh manager (recovery's warm
        path). A reservation checkpointed with an UNEXECUTED deferred
        preemption plan and no bound members is dropped: the plan's
        victim workloads cannot round-trip, so restoring the box would
        hold chips no bind can ever open — the gang simply re-filters
        and re-plans, exactly as after a legacy cold rebuild. Returns
        reservations restored."""
        restored = 0
        with self._lock:
            self._epoch = int(doc.get("epoch", 0))
            touched: set[str] = set()
            for rd in doc.get("res", ()):
                if rd.get("pv") and not rd.get("as"):
                    log.warning(
                        "checkpoint restore: dropping reservation %s/%s "
                        "with an unexecuted preemption plan (the plan "
                        "does not survive a crash; the gang re-plans)",
                        rd["ns"], rd["g"]["n"],
                    )
                    continue
                res = self._res_from_doc_locked(rd)
                self._reservations[res.key] = res
                touched.update(res.slice_coords)
                restored += 1
            for pk, entry in doc.get("term", {}).items():
                self._terminating_coords[pk] = (
                    entry[0],
                    frozenset(TopologyCoord(*c) for c in entry[1]),
                )
                touched.add(entry[0])
            self._epoch += 1
            self._note_delta_locked(slices=touched,
                                    why="checkpoint restore")
        return restored

    def apply_journal(self, rec: dict) -> None:
        """Apply one replayed gang-lifecycle WAL record (recovery path,
        journal detached). Mirrors the live mutators MINUS their side
        channels: no events, no latency samples, and no cascading
        ledger releases — those have their own WAL records in the
        stream, in order."""
        kind, d = rec["k"], rec["d"]
        with self._lock:
            if kind == "gre":
                res = self._res_from_doc_locked(d)
                self._reservations[res.key] = res
                if d.get("pv"):
                    # deferred plan lost across the crash: candidate for
                    # the finish_replay() drop unless a gvtaken record
                    # later proves the plan executed
                    self._replay_pending.add(res.key)
                self._epoch += 1
                self._note_delta_locked(slices=res.slice_coords,
                                        why=f"replay gre {res.key}")
            elif kind == "gvtaken":
                self._replay_pending.discard((d["ns"], d["g"]))
            elif kind == "gdrop":
                key = (d["ns"], d["g"])
                self._replay_pending.discard(key)
                res = self._reservations.get(key)
                if res is not None:
                    self._reservations.pop(key, None)
                    self._epoch += 1
                    self._note_delta_locked(slices=res.slice_coords,
                                            why=f"replay gdrop {key}")
            elif kind == "evict":
                # the eviction INTENT re-queues (recovery prunes pods
                # that no longer exist); the ledger release replayed
                # from its own record
                self._evictions.append(d["p"])
                if d.get("sid") is not None and d.get("c"):
                    self._terminating_coords[d["p"]] = (
                        d["sid"],
                        frozenset(TopologyCoord(*c) for c in d["c"]),
                    )
                    self._epoch += 1
                    self._note_delta_locked(slices=(d["sid"],),
                                            why=f"replay evict {d['p']}")
            elif kind == "gterm":
                res = self._reservations.get((d["ns"], d["g"]))
                sids: set[str] = set()
                for pk, entry in d["pods"].items():
                    if res is not None:
                        res.terminating_victims.add(pk)
                    if entry[1]:
                        self._terminating_coords[pk] = (
                            entry[0],
                            frozenset(TopologyCoord(*c) for c in entry[1]),
                        )
                        sids.add(entry[0])
                self._epoch += 1
                self._note_delta_locked(slices=sids, why="replay gterm")
            elif kind == "gvgone":
                pk = d["p"]
                entry = self._terminating_coords.get(pk)
                if entry is not None:
                    self._terminating_coords.pop(pk, None)
                    self._epoch += 1
                    self._note_delta_locked(slices=(entry[0],),
                                            why=f"replay gvgone {pk}")
                for res in self._reservations.values():
                    res.terminating_victims.discard(pk)
            elif kind == "gbound":
                res = self._reservations.get((d["ns"], d["g"]))
                if res is not None:
                    res.record_assignment(
                        d["p"], d["sid"],
                        [TopologyCoord(*c) for c in d["c"]],
                    )
                    if (not res.committed
                            and len(res.assigned) >= res.group.min_member):
                        res.committed = True
                    self._epoch += 1
                    self._note_delta_locked(slices=(d["sid"],),
                                            why=f"replay gbound {d['p']}")
            elif kind == "guncommit":
                res = self._reservations.get((d["ns"], d["g"]))
                if res is not None:
                    res.committed = False
            elif kind == "gmrel":
                pk = d["p"]
                for res in self._reservations.values():
                    if pk in res.assigned:
                        sid = res.assigned[pk][0]
                        res.drop_assignment(pk)
                        if res.committed and not res.assigned:
                            self._reservations.pop(res.key, None)
                        self._epoch += 1
                        self._note_delta_locked(
                            slices=(sid,), why=f"replay gmrel {pk}")
                        break
            elif kind == "greas":
                pk = d["p"]
                coords = [TopologyCoord(*c) for c in d["c"]]
                for res in self._reservations.values():
                    entry = res.assigned.get(pk)
                    if entry is not None:
                        sid, old = entry
                        res.drop_assignment(pk)
                        pool = res.slice_coords.get(sid, set())
                        pool.difference_update(old)
                        pool.update(coords)
                        res.slice_coords[sid] = pool
                        res.record_assignment(pk, sid, list(coords))
                        self._epoch += 1
                        self._note_delta_locked(
                            slices=(sid,), why=f"replay greas {pk}")
                        break
            else:
                raise GangError(f"unknown gang journal record {kind!r}")

    def drop_reservation(self, key: tuple[str, str]) -> bool:
        """Forget a reservation WITHOUT evicting its members — the
        recovery reconcile's gang normalizer: the ledger is already
        correct, and the group re-restores from it via ``restore()``
        (a replayed reservation whose member binds were lost with the
        WAL tail must not shadow the rebuilt truth)."""
        with self._lock:
            # look up before popping: the no-such-gang path mutates
            # nothing and owes no epoch bump
            res = self._reservations.get(key)
            if res is None:
                return False
            self._reservations.pop(key, None)
            self._epoch += 1
            self._note_delta_locked(slices=res.slice_coords,
                                    why=f"drop {key}")
            self._note_journal_locked("gdrop", {"ns": key[0],
                                                "g": key[1]})
            return True

    def finish_replay(self) -> list[tuple[str, str]]:
        """End-of-replay hygiene: drop reservations replayed with a
        deferred-eviction plan that never executed (no ``gvtaken``
        before the crash) and no bound members — their reserved box may
        overlap victims' still-occupied chips and no bind can ever
        execute the lost plan. The gang's next filter re-plans from
        scratch, exactly the legacy cold-rebuild behavior. Returns the
        dropped keys."""
        dropped: list[tuple[str, str]] = []
        with self._lock:
            for key in sorted(self._replay_pending):
                res = self._reservations.get(key)
                if res is not None and not res.assigned:
                    self._reservations.pop(key, None)
                    self._epoch += 1
                    self._note_delta_locked(
                        slices=res.slice_coords,
                        why=f"replay drop-pending {key}")
                    dropped.append(key)
            self._replay_pending.clear()
        return dropped

