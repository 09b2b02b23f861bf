"""Epoch-cached scheduling snapshots — the port's own copy of
``tpukube/sched/snapshot.py`` (``SnapshotCache``, ``SliceSnapshot``,
``ClusterSnapshot``, ``SnapshotDelta``, ``sweep_for`` and the audit).

Every /filter, /prioritize and gang reservation reads the derived
topology state (occupied / reserved / unhealthy / terminating coord sets,
broken links, and lazily the prepared slicefit sweeps) from ONE cached
snapshot per (ledger epoch, gang epoch) key instead of re-deriving it
from the ledger per webhook:

  * :class:`SliceSnapshot` — one slice's scheduling view, frozen at an
    epoch, with its sweeps built on first use;
  * :class:`ClusterSnapshot` — the per-slice snapshots under one key;
  * :class:`SnapshotCache` — owned by the GangManager (shared with the
    Extender): ``current()`` returns the cached snapshot while both
    epochs stand still and rebuilds lazily — at most once per epoch —
    otherwise.

Every ledger mutation bumps ``ClusterState.epoch()`` and every
reservation mutation ``GangManager.epoch()``, each recording a typed
:class:`SnapshotDelta`; ``current()`` ADVANCES the cached snapshot by the
queued deltas (O(Δ)) and falls back to a full rebuild on a structural
marker or a log gap. The audit sentinel (``snapshot_audit_rate``)
rebuilds a sampled fraction of cache hits from the ledger and raises
:class:`SnapshotAuditError` on any divergence.

A slice's blocked set is occupied | reserved | cordoned | absent: the
drain plane's cordoned chips (``sched/drain.py``) keep serving their live
allocations but take nothing new.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from collections import deque
from typing import Any, Iterable, Optional

from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import Link, TopologyCoord
from tpukube_torch.sched import slicefit

log = logging.getLogger("tpukube_torch.snapshot")


class SnapshotAuditError(RuntimeError):
    """The audit sentinel rebuilt a snapshot from the ledger and it
    diverged from the epoch-cached one: some mutation path changed
    scheduling state WITHOUT bumping an epoch — the stale-cache bug
    class the epoch discipline (static: tpukube-lint epoch-discipline;
    registries in analysis/epochs.py) exists to prevent."""


class SnapshotDelta:
    """One epoch bump's snapshot-visible effect, recorded by the seam
    that bumped (under its own lock, so per-stream order is bump
    order). Two streams, keyed by which epoch the bump advanced:

      * ``kind="ledger"`` (ClusterState._epoch): explicit per-slice
        occupied-chip transitions — ``occupied_add`` are chips whose
        used shares left zero (or that a commit claimed whole),
        ``occupied_remove`` chips whose shares returned to zero on a
        healthy chip — plus the used-share change feeding the slice
        utilization. A HEALTH-ONLY node re-annotation (the churn shape
        of health watches: same chips, same links, only per-chip health
        flipped) also travels as a ledger delta — ``unhealthy_add`` /
        ``unhealthy_remove`` plus the healthy-capacity movement in
        ``total_shares_delta`` (and the used/occupied consequences of
        chips entering/leaving health) — O(chips-per-node) instead of
        the full-rebuild marker every changed payload used to cost.
        Any OTHER payload change (links, topology, sharing mode) stays
        a ``full`` marker (below).
      * ``kind="gang"`` (GangManager._epoch): the ``slices`` whose
        reserved / terminating masks changed; the masks themselves are
        re-read from the GangManager at apply time (they are O(Δ)-small
        and their union semantics live in ``reserved_coords``).

    ``full=True`` marks a structural change (node upsert with a changed
    payload, slice registration) that invalidates the whole cached
    snapshot: the advance path refuses the chain and falls back to a
    full rebuild."""

    __slots__ = ("kind", "epoch", "full", "slice_id", "occupied_add",
                 "occupied_remove", "used_shares_delta",
                 "unhealthy_add", "unhealthy_remove",
                 "total_shares_delta", "slices", "why")

    def __init__(self, kind: str, epoch: int, full: bool = False,
                 slice_id: Optional[str] = None,
                 occupied_add: tuple = (), occupied_remove: tuple = (),
                 used_shares_delta: int = 0,
                 unhealthy_add: tuple = (), unhealthy_remove: tuple = (),
                 total_shares_delta: int = 0,
                 slices: tuple = (), why: str = ""):
        assert kind in ("ledger", "gang"), kind
        self.kind = kind
        self.epoch = epoch  # the epoch value AFTER the bump
        self.full = full
        self.slice_id = slice_id
        self.occupied_add = occupied_add
        self.occupied_remove = occupied_remove
        self.used_shares_delta = used_shares_delta
        # health-only re-annotation stream: per-chip health transitions
        # plus the healthy-share capacity they move (total only changes
        # through these; every other topology change is a full marker)
        self.unhealthy_add = unhealthy_add
        self.unhealthy_remove = unhealthy_remove
        self.total_shares_delta = total_shares_delta
        self.slices = slices
        self.why = why

    def __repr__(self) -> str:  # debugging / test failure readability
        return (f"SnapshotDelta({self.kind}@{self.epoch}"
                f"{', FULL' if self.full else ''}"
                f"{f', {self.why}' if self.why else ''})")


def sweep_for(
    mesh: MeshSpec, blocked: Iterable[TopologyCoord]
) -> "slicefit._Sweep":
    """Ad-hoc sweep over a REQUEST-SPECIFIC blocked set (a preemption
    plan's victims-look-free grid, a restore's members-look-free grid).
    These grids depend on the request, not just cluster state, so they
    cannot live in the epoch cache — but their construction still
    routes through here so the snapshot-discipline lint keeps all sweep
    building in one auditable place."""
    return slicefit._Sweep(mesh, slicefit.occupancy_grid(mesh, blocked))


class SliceSnapshot:
    """One ICI slice's scheduling state, frozen at an epoch and prepared
    for repeated queries. Coord sets are frozen (callers must not — and
    cannot — mutate them); sweeps, fragmentation, and the largest free
    box build lazily on first use and are then shared by every caller
    of the same snapshot (races on the lazy builds are benign: the
    result is deterministic and assignment is atomic)."""

    __slots__ = (
        "slice_id", "mesh", "occupied", "reserved", "unhealthy",
        "terminating", "cordoned", "absent", "broken", "used_shares",
        "total_shares",
        "_occ_sweep", "_blocked_sweep", "_frag", "_largest",
    )

    def __init__(
        self,
        slice_id: str,
        mesh: MeshSpec,
        occupied: frozenset[TopologyCoord],
        reserved: frozenset[TopologyCoord],
        unhealthy: frozenset[TopologyCoord],
        terminating: frozenset[TopologyCoord],
        broken: frozenset[Link],
        used_shares: int,
        total_shares: int,
        cordoned: frozenset[TopologyCoord] = frozenset(),
        absent: frozenset[TopologyCoord] = frozenset(),
    ):
        self.slice_id = slice_id
        self.mesh = mesh
        #: chips with used shares or bad health (ledger view)
        self.occupied = occupied
        #: gang mask: unassigned reservation chips + terminating victims
        self.reserved = reserved
        self.unhealthy = unhealthy
        #: evicted-but-still-terminating victims' chips (preemption
        #: planners treat these like unhealthy: nothing frees them sooner)
        self.terminating = terminating
        #: drain mask: chips of cordoned nodes — excluded from every NEW
        #: placement, while chips they already serve stay accounted
        #: through ``occupied`` as usual. Cordon transitions travel as
        #: full-rebuild markers (rare by design), so the delta-advance
        #: path carries this set through untouched.
        self.cordoned = cordoned
        #: geometry mask: chips of the slice's mesh that no node claims
        #: (a partially advertised fleet). There is nothing behind these
        #: coords — every sweep and capacity count must treat them as
        #: non-existent, or a slice advertises phantom chips.
        #: Topology changes travel as full-rebuild markers, so the
        #: delta-advance path carries this set through untouched.
        self.absent = absent
        self.broken = broken
        #: allocated / total shares over healthy capacity — carried as
        #: the two INTEGERS (not the derived float) so a ledger delta
        #: can advance utilization in O(1); total only moves on health/
        #: topology changes, which are full-rebuild markers
        self.used_shares = used_shares
        self.total_shares = total_shares
        self._occ_sweep: Optional[slicefit._Sweep] = None
        self._blocked_sweep: Optional[slicefit._Sweep] = None
        self._frag: Optional[float] = None
        self._largest: Optional[int] = None

    @property
    def utilization(self) -> float:
        """Allocated share fraction over healthy capacity (the gang
        layer's bin-pack signal), derived from the carried counts."""
        return self.used_shares / self.total_shares if self.total_shares \
            else 0.0

    # -- prepared sweeps ---------------------------------------------------
    def occupancy_sweep(self) -> "slicefit._Sweep":
        """Sweep over the OCCUPIED grid (allocated + unhealthy + absent
        chips) — the scorer's fallback and the fragmentation metric's
        base. Absent chips block here too: there is no hardware behind
        them to ever free up."""
        sweep = self._occ_sweep
        if sweep is None:
            sweep = self._occ_sweep = sweep_for(
                self.mesh, self.occupied | self.absent)
        return sweep

    def blocked_sweep(self) -> "slicefit._Sweep":
        """Sweep over occupied | reserved | cordoned | absent — what
        every placement search (gang reservation, prioritize scoring)
        masks against. Cordoned chips are drain-blocked: live
        allocations on them keep serving, but nothing NEW lands there.
        Absent chips have no host at all."""
        sweep = self._blocked_sweep
        if sweep is None:
            sweep = self._blocked_sweep = sweep_for(
                self.mesh,
                self.occupied | self.reserved | self.cordoned
                | self.absent
            )
        return sweep

    def uncordoned_sweep(self) -> "slicefit._Sweep":
        """Sweep over occupied | reserved | absent ONLY — the
        drain-pressure counterfactual (obs/capacity.py: would this
        demand fit if the cordoned chips were given back?). Absent
        chips stay masked: cancelling a drain does not resurrect a host
        that already left. Uncached: probed only while a drain is in
        flight."""
        if not self.cordoned:
            return self.blocked_sweep()
        return sweep_for(
            self.mesh, self.occupied | self.reserved | self.absent)

    # -- derived numbers ---------------------------------------------------
    @property
    def free_chips(self) -> int:
        """Chips neither occupied nor unhealthy nor absent
        (reservation-blind). Pure set arithmetic — counting must not
        force a sweep build."""
        return self.mesh.num_chips - len(self.occupied | self.absent)

    @property
    def blocked_free_chips(self) -> int:
        """Chips free for a NEW placement (occupied, reserved, cordoned
        and absent all masked) — the gang layer's capacity-ranking
        number. The union handles the (normally disjoint) sets
        overlapping, exactly as the OR'd grid the blocked sweep is built
        from would."""
        return self.mesh.num_chips - len(
            self.occupied | self.reserved | self.cordoned | self.absent)

    def largest_free_box(self) -> int:
        if self._largest is None:
            self._largest = slicefit.largest_free_box_in(
                self.occupancy_sweep()
            )
        return self._largest

    def fragmentation(self) -> float:
        """Cached ``slicefit.fragmentation`` over the occupied grid."""
        if self._frag is None:
            free = self.free_chips
            self._frag = (
                0.0 if free == 0
                else 1.0 - self.largest_free_box() / free
            )
        return self._frag


class ClusterSnapshot:
    """Per-slice snapshots under one (ledger epoch, gang epoch) key."""

    __slots__ = ("key", "slices", "build_seconds")

    def __init__(self, key: tuple[int, int],
                 slices: dict[str, SliceSnapshot],
                 build_seconds: float = 0.0):
        self.key = key
        self.slices = slices
        # wall time of the full rebuild that produced this snapshot (0
        # for a delta advance)
        self.build_seconds = build_seconds

    def slice_ids(self) -> list[str]:
        return sorted(self.slices)

    def slice(self, slice_id: str) -> SliceSnapshot:
        try:
            return self.slices[slice_id]
        except KeyError:
            raise KeyError(
                f"snapshot holds no slice {slice_id!r} "
                f"(has {sorted(self.slices)})"
            ) from None

    def reserved_by_slice(self) -> dict[str, frozenset[TopologyCoord]]:
        """The per-slice gang mask, in the shape the extender's
        feasibility/scoring helpers consume."""
        return {sid: ss.reserved for sid, ss in self.slices.items()}


def _audit_divergence(cached: ClusterSnapshot,
                      rebuilt: ClusterSnapshot) -> list[str]:
    """Human-readable differences between a cached snapshot and a fresh
    ledger rebuild at the same epochs (empty = identical). Compares the
    captured coord/link sets and utilization — the inputs every sweep,
    score, and placement decision derives from; the lazy sweep tables
    are pure functions of these."""
    diffs: list[str] = []
    if set(cached.slices) != set(rebuilt.slices):
        diffs.append(
            f"slice set {sorted(cached.slices)} != "
            f"{sorted(rebuilt.slices)}"
        )
        return diffs
    for sid in sorted(cached.slices):
        a, b = cached.slices[sid], rebuilt.slices[sid]
        for attr in ("occupied", "reserved", "unhealthy", "terminating",
                     "cordoned", "absent", "broken"):
            va, vb = getattr(a, attr), getattr(b, attr)
            if va != vb:
                extra = sorted(tuple(x) if not isinstance(x, tuple) else x
                               for x in (va - vb))[:3]
                missing = sorted(tuple(x) if not isinstance(x, tuple)
                                 else x for x in (vb - va))[:3]
                diffs.append(
                    f"{sid}.{attr}: cached has {len(va)}, ledger has "
                    f"{len(vb)} (stale extra {extra}, missing {missing})"
                )
        if abs(a.utilization - b.utilization) > 1e-9:
            diffs.append(
                f"{sid}.utilization: cached {a.utilization:.6f} != "
                f"ledger {b.utilization:.6f}"
            )
        if a.mesh != b.mesh:
            diffs.append(f"{sid}.mesh: cached {a.mesh.dims} != "
                         f"ledger {b.mesh.dims}")
    return diffs


class SnapshotCache:
    """The epoch-tagged snapshot owner. One instance per GangManager
    (the Extender shares it): ``current()`` is safe from any thread and
    from under the decision/gang locks, and rebuilds at most once per
    (ledger, gang) epoch pair."""

    #: per-stream delta-log bound: must exceed the deepest epoch run
    #: between two cache lookups (a full batch cycle of assumed
    #: commits plus a completion wave of releases) or the advance
    #: degrades to a full rebuild (overflow). Entries are a few dozen
    #: bytes, so the bound is memory-cheap headroom.
    DELTA_LOG = 16384
    DELTA_APPLY_WINDOW = 512  # delta-apply samples kept for quantiles
    REBUILD_WINDOW = 512  # rebuild-latency samples kept for quantiles

    def __init__(self, state, gang):
        self._state = state
        self._gang = gang
        # leaf mutex: guards only the cached-snapshot slot, the delta
        # log, and the counters — never held while taking the
        # gang/ledger locks
        self._lock = threading.Lock()
        self._snap: Optional[ClusterSnapshot] = None
        # bumped whenever a new snapshot is installed (the /statusz
        # "generation")
        self._snap_gen = 0
        self.rebuilds = 0
        self.hits = 0
        # Incremental maintenance: bump seams note() typed
        # SnapshotDeltas here; current() advances the cached snapshot
        # by applying them instead of rebuilding O(chips). Per-stream
        # deques — appends are ordered by the owning ledger/gang lock.
        self.delta_enabled = True
        self._delta_log: dict[str, deque[SnapshotDelta]] = {
            "ledger": deque(maxlen=self.DELTA_LOG),
            "gang": deque(maxlen=self.DELTA_LOG),
        }
        self.delta_applies = 0
        self.delta_overflows = 0
        # maintenance timers: the per-advance walls (a window for
        # quantiles) and both kinds' cumulative totals
        self._delta_apply_seconds: deque[float] = deque(
            maxlen=self.DELTA_APPLY_WINDOW
        )
        self.delta_apply_seconds_total = 0.0
        self.rebuild_seconds_total = 0.0
        self._rebuild_seconds: deque[float] = deque(
            maxlen=self.REBUILD_WINDOW
        )
        # Audit sentinel (config ``snapshot_audit_rate``, wired by the
        # Extender): on a sampled fraction of cache HITS, rebuild the
        # snapshot from the ledger and raise SnapshotAuditError on any
        # divergence — the runtime counterpart of the epoch-discipline
        # static pass, catching mutation seams its registry misses.
        # 0.0 (default) disables the sentinel entirely.
        self.audit_rate = 0.0
        self.audit_checks = 0
        self.audit_divergences = 0
        # deterministic sampling stream: audits are a debugging tool
        # and must not add nondeterminism to seeded chaos runs
        self._audit_rng = random.Random(0xA0D17)

    # -- epoch key ---------------------------------------------------------
    def epoch_key(self) -> tuple[int, int]:
        return (self._state.epoch(), self._gang.epoch())

    def invalidate(self) -> None:
        """Drop the cached snapshot (tests and the no-cache microbench
        baseline; production invalidation is epoch bumps, never this).
        With no base snapshot the next lookup is a full rebuild — the
        delta log cannot advance from nothing."""
        with self._lock:
            self._snap = None
            self._snap_gen += 1

    def peek(self) -> Optional[ClusterSnapshot]:
        """The cached snapshot IF it is current, else None — never
        builds (checkpoint captures read through here: a capture must
        not force an O(chips) rebuild just to decide whether a seedable
        snapshot exists)."""
        key = self.epoch_key()
        with self._lock:
            snap = self._snap
            return snap if snap is not None and snap.key == key else None

    def seed(self, snap: ClusterSnapshot) -> None:
        """Install a checkpoint-restored snapshot as the cached slot
        (journal recovery's warm path): the first lookups after a
        restart HIT instead of forcing the O(chips) rebuild that would
        eagerly materialize every lazily-restored node view. The caller
        guarantees ``snap.key`` equals the current epoch key and that
        the content matches the restored ledger — the audit sentinel
        (``audit_now`` at recovery with ``snapshot_audit_rate`` > 0,
        plus the sampled runtime audits) holds it to that."""
        with self._lock:
            self._snap = snap
            self._snap_gen += 1

    # -- the delta log -------------------------------------------------------
    def note(self, delta: SnapshotDelta) -> None:
        """Record one bump's effect. Called by the seam that bumped,
        under ITS lock (ledger or gang), so each stream's append order
        is epoch order; the cache mutex stays a leaf. No-op with the
        feature off — every epoch advance then rebuilds, the oracle
        behavior the parity tests compare against."""
        if not self.delta_enabled:
            return
        with self._lock:
            self._delta_log[delta.kind].append(delta)

    def deltas_between(
        self, old_key: tuple[int, int], new_key: tuple[int, int]
    ) -> Optional[list[SnapshotDelta]]:
        """The contiguous delta chain advancing ``old_key`` to
        ``new_key`` (per-stream epoch order; ledger first), or None
        when the log cannot cover the range — entries dropped by the
        bound, a bump whose seam never noted, or the feature off. The
        chain may contain ``full`` markers; callers must treat any
        marker as rebuild-required. Also the batch planner's feed: the
        cycle patches its persistent fast-state overlay from the same
        chain the snapshot advanced by."""
        (s0, g0), (s1, g1) = old_key, new_key
        if s1 < s0 or g1 < g0:
            return None
        out: list[SnapshotDelta] = []
        with self._lock:
            for kind, lo, hi in (("ledger", s0, s1), ("gang", g0, g1)):
                if hi == lo:
                    continue
                # per-stream epochs append in strictly increasing order,
                # so the wanted chain is a SUFFIX (minus entries newer
                # than hi): walk from the right and stop at lo — O(Δ +
                # newer-than-hi), never a full scan of the bounded log
                # (this runs under the leaf mutex that note() also
                # takes from inside the ledger/gang locks, so a full
                # 16k-entry filter here would stall commits)
                got = []
                for d in reversed(self._delta_log[kind]):
                    if d.epoch > hi:
                        continue
                    if d.epoch <= lo:
                        break
                    got.append(d)
                if len(got) != hi - lo:
                    return None  # gap: dropped or never noted
                got.reverse()
                out.extend(got)
        return out

    def _advance(self, base: ClusterSnapshot,
                 key: tuple[int, int]) -> Optional[ClusterSnapshot]:
        """Apply the queued deltas to ``base``, producing the snapshot
        for ``key`` in O(Δ): only touched slices get fresh
        SliceSnapshots (their lazy sweeps invalidate); untouched slices
        are shared by reference. None = not coverable (gap/full/unknown
        slice) — the caller falls back to a full rebuild. Runs OUTSIDE
        the cache mutex; the gang-mask re-reads take the gang lock,
        and may observe state newer than ``key`` under a lock-free
        observer race — the caller's epoch re-check then refuses to
        cache the result, exactly the ``_build`` torn-build contract."""
        deltas = self.deltas_between(base.key, key)
        if deltas is None:
            with self._lock:
                self.delta_overflows += 1
            return None
        if any(d.full for d in deltas):
            return None  # structural change: rebuild is the only truth
        # merge the ledger stream per slice (net add/remove against the
        # base set: an add cancels a pending remove and vice versa)
        occ_add: dict[str, set] = {}
        occ_rem: dict[str, set] = {}
        unh_add: dict[str, set] = {}
        unh_rem: dict[str, set] = {}
        used: dict[str, int] = {}
        total: dict[str, int] = {}
        gang_touched: set[str] = set()

        def _merge(add: set, rem: set, adds, rems) -> None:
            for c in adds:
                rem.discard(c)
                add.add(c)
            for c in rems:
                add.discard(c)
                rem.add(c)

        for d in deltas:
            if d.kind == "gang":
                gang_touched.update(d.slices)
                continue
            sid = d.slice_id
            if sid is None:
                continue  # an empty ledger bump (release on a gone node)
            _merge(occ_add.setdefault(sid, set()),
                   occ_rem.setdefault(sid, set()),
                   d.occupied_add, d.occupied_remove)
            _merge(unh_add.setdefault(sid, set()),
                   unh_rem.setdefault(sid, set()),
                   d.unhealthy_add, d.unhealthy_remove)
            used[sid] = used.get(sid, 0) + d.used_shares_delta
            total[sid] = total.get(sid, 0) + d.total_shares_delta
        touched = set(occ_add) | set(occ_rem) | set(used) | gang_touched
        if not touched <= set(base.slices):
            return None  # slice appeared without a full marker?!
        slices = dict(base.slices)
        for sid in touched:
            old = base.slices[sid]
            occupied = old.occupied
            if occ_add.get(sid) or occ_rem.get(sid):
                occupied = frozenset(
                    (occupied - occ_rem[sid]) | occ_add[sid]
                )
            unhealthy = old.unhealthy
            if unh_add.get(sid) or unh_rem.get(sid):
                # health-only re-annotation deltas (see SnapshotDelta)
                unhealthy = frozenset(
                    (unhealthy - unh_rem[sid]) | unh_add[sid]
                )
            if sid in gang_touched:
                reserved = frozenset(self._gang.reserved_coords(sid))
                terminating = frozenset(
                    self._gang.terminating_coords(sid))
            else:
                reserved, terminating = old.reserved, old.terminating
            slices[sid] = SliceSnapshot(
                slice_id=sid,
                mesh=old.mesh,
                occupied=occupied,
                reserved=reserved,
                unhealthy=unhealthy,
                terminating=terminating,
                broken=old.broken,
                used_shares=old.used_shares + used.get(sid, 0),
                total_shares=old.total_shares + total.get(sid, 0),
                # cordon and topology transitions are full markers
                # (set_cordon, ingest, un-ingest), so the carried sets
                # are exact across any delta chain
                cordoned=old.cordoned,
                absent=old.absent,
            )
        return ClusterSnapshot(key=key, slices=slices)

    # -- the cache ---------------------------------------------------------
    def current(self) -> ClusterSnapshot:
        """The scheduling snapshot for the current epochs: cached while
        nothing mutated, rebuilt lazily otherwise.

        Torn-build story: every mutation path runs under the extender's
        decision lock, and so does every PLACEMENT lookup — a placement
        cycle's build therefore always passes the epoch re-check below
        (the epochs cannot move under it), which is what makes a
        stale- or torn-snapshot placement structurally impossible.
        A lookup from outside that lock can race a mutation; a build
        that fails the re-check is served to that one caller uncached,
        and the next lookup rebuilds clean."""
        return self._lookup(count_hit=True)

    def observe(self) -> ClusterSnapshot:
        """Cache lookup for observability readers (metrics/statusz).
        Never counts a hit: scrape traffic counted as hits would mask the
        "flat hits counter under webhook load" diagnostic the counters
        exist for. A rebuild it performs is still real work (one the next
        scheduling lookup then inherits) and counts."""
        return self._lookup(count_hit=False)

    def _lookup(self, count_hit: bool) -> ClusterSnapshot:
        key = self.epoch_key()
        with self._lock:
            snap = self._snap
            if snap is not None and snap.key == key:
                if count_hit:
                    self.hits += 1
                hit: Optional[ClusterSnapshot] = snap
            else:
                hit = None
            base = snap  # delta-advance base (None = cold start)
        if hit is not None:
            if count_hit and self.audit_rate > 0.0:
                # audit OUTSIDE the leaf mutex: the rebuild takes the
                # gang/ledger locks, which must never nest inside it.
                # Only counted (scheduling) hits are audited: observer
                # scrapes may race mutations and would false-positive.
                self._maybe_audit(hit)
            return hit
        for _ in range(3):
            snap = None
            if (base is not None and self.delta_enabled
                    and base.key != key):
                t0 = time.perf_counter()
                snap = self._advance(base, key)
                if snap is not None:
                    dt = time.perf_counter() - t0
                    with self._lock:
                        self.delta_applies += 1
                        self._delta_apply_seconds.append(dt)
                        self.delta_apply_seconds_total += dt
            if snap is None:
                t0 = time.perf_counter()
                snap = self._build(key)
                snap.build_seconds = time.perf_counter() - t0
                with self._lock:
                    self.rebuilds += 1
                    self._rebuild_seconds.append(snap.build_seconds)
                    self.rebuild_seconds_total += snap.build_seconds
            after = self.epoch_key()
            with self._lock:
                if after == key:
                    self._snap = snap
                    self._snap_gen += 1
                    return snap
            key = after
            base = snap  # labeled for the missed key; advance from it
        return snap  # raced mutations: serve uncached

    # -- audit sentinel ----------------------------------------------------
    def audit_now(self) -> None:
        """One FORCED sentinel check regardless of ``audit_rate``: the
        cached snapshot must equal a from-scratch ledger rebuild. Callers
        hold off mutations, so a moved epoch mid-check is a real
        divergence, not a race. Raises :class:`SnapshotAuditError`."""
        snap = self.current()
        rebuilt = self._build(snap.key, audit=True)
        with self._lock:
            self.audit_checks += 1
        diffs = _audit_divergence(snap, rebuilt)
        if diffs:
            with self._lock:
                self.audit_divergences += 1
            detail = "; ".join(diffs[:4])
            log.error("snapshot audit DIVERGENCE (forced) at epochs "
                      "%s: %s", snap.key, detail)
            raise SnapshotAuditError(
                f"recovered snapshot at epochs {snap.key} diverges "
                f"from a ledger rebuild ({detail})"
            )

    def _maybe_audit(self, snap: ClusterSnapshot) -> None:
        """Sampled hit audit: rebuild from the ledger and compare.
        Raises :class:`SnapshotAuditError` on divergence — a mutation
        happened without an epoch bump, so the cache was serving stale
        placements. Callers under the decision lock cannot race
        mutations; a lookup that still observes moving epochs (a
        lock-free test caller) is skipped rather than misreported."""
        if (self.audit_rate < 1.0
                and self._audit_rng.random() >= self.audit_rate):
            return
        rebuilt = self._build(snap.key, audit=True)
        if self.epoch_key() != snap.key:
            return  # raced a mutation: the cached epochs moved mid-audit
        with self._lock:
            self.audit_checks += 1
        diffs = _audit_divergence(snap, rebuilt)
        if diffs:
            with self._lock:
                self.audit_divergences += 1
            detail = "; ".join(diffs[:4])
            log.error("snapshot audit DIVERGENCE at epochs %s: %s",
                      snap.key, detail)
            raise SnapshotAuditError(
                f"cached snapshot at epochs {snap.key} diverges from a "
                f"ledger rebuild ({detail}) — some mutation path is "
                f"missing an epoch bump, or a recorded SnapshotDelta "
                f"mis-stated its seam's effect"
            )

    def _build(self, key: tuple[int, int],
               audit: bool = False) -> ClusterSnapshot:
        slices: dict[str, SliceSnapshot] = {}
        for sid in self._state.slice_ids():
            try:
                mesh = self._state.slice_mesh(sid)
            except Exception as e:
                # slice vanished mid-build (a racing scrape); the epoch
                # re-check in current() refuses to cache this build
                log.warning("snapshot build: slice %s vanished: %s",
                            sid, e)
                continue
            # audit builds bypass EVERY incremental ledger cache (the
            # walk_* variants re-derive from the node views): the
            # sentinel exists to catch seams that forgot their
            # bookkeeping, so it must never read a set or counter the
            # same seams maintain
            if audit:
                used, total = self._state.walk_slice_share_counts(sid)
                occupied = self._state.walk_occupied_coords(sid)
                unhealthy = self._state.walk_unhealthy_coords(sid)
                broken = self._state.walk_broken_links(sid)
            else:
                used, total = self._state.slice_share_counts(sid)
                occupied = self._state.occupied_coords(sid)
                unhealthy = self._state.unhealthy_coords(sid)
                broken = self._state.broken_links(sid)
            slices[sid] = SliceSnapshot(
                slice_id=sid,
                mesh=mesh,
                occupied=frozenset(occupied),
                reserved=frozenset(self._gang.reserved_coords(sid)),
                unhealthy=frozenset(unhealthy),
                terminating=frozenset(self._gang.terminating_coords(sid)),
                broken=frozenset(broken),
                used_shares=used,
                total_shares=total,
                # no incremental cache to bypass: cordoned_coords and
                # absent_coords ARE the single derivations (audit and
                # build share them)
                cordoned=frozenset(self._state.cordoned_coords(sid)),
                absent=frozenset(self._state.absent_coords(sid)),
            )
        return ClusterSnapshot(key=key, slices=slices)

    # -- observability -----------------------------------------------------
    def rebuild_seconds_snapshot(self) -> list[float]:
        """Copy of the rebuild-latency window (the /metrics summary's
        values_fn; copied under the mutex so a concurrent rebuild cannot
        corrupt the scrape)."""
        with self._lock:
            return list(self._rebuild_seconds)

    def delta_apply_seconds_snapshot(self) -> list[float]:
        """Copy of the delta-apply latency window (one sample per O(Δ)
        advance, however many queued deltas it covered)."""
        with self._lock:
            return list(self._delta_apply_seconds)

    def stats(self) -> dict[str, Any]:
        """The /statusz document: cache counters plus the per-slice
        fragmentation numbers the snapshot makes cheap to serve. Reads
        through observe(): a statusz poll must not inflate the hit
        counters it reports."""
        snap = self.observe()
        with self._lock:
            rebuilds, hits = self.rebuilds, self.hits
            applies, overflows = self.delta_applies, self.delta_overflows
            checks, diverged = self.audit_checks, self.audit_divergences
            last = (self._rebuild_seconds[-1]
                    if self._rebuild_seconds else None)
        lookups = rebuilds + hits
        advances = rebuilds + applies
        return {
            "epoch": {"ledger": snap.key[0], "gang": snap.key[1]},
            "generation": self._snap_gen,
            "rebuilds": rebuilds,
            "hits": hits,
            "audit": {
                "rate": self.audit_rate,
                "checks": checks,
                "divergences": diverged,
            },
            "delta": {
                "enabled": self.delta_enabled,
                "applies": applies,
                "overflows": overflows,
            },
            # of the lookups that had to move the snapshot forward, the
            # fraction the O(delta) path served (vs full rebuilds)
            "delta_hit_rate": (round(applies / advances, 4)
                               if advances else None),
            "hit_rate": round(hits / lookups, 4) if lookups else None,
            "last_rebuild_s": (round(last, 6) if last is not None
                               else None),
            "slices": {
                sid: {
                    "fragmentation": round(ss.fragmentation(), 4),
                    "largest_free_box": ss.largest_free_box(),
                    "free_chips": ss.free_chips,
                    "reserved_chips": len(ss.reserved),
                    "links_down": len(ss.broken),
                }
                for sid, ss in snap.slices.items()
            },
        }
