"""Scheduler extender (L5) — the port's own copy of the default decision
path of ``tpukube/sched/extender.py``, plus its webhook server.

kube-scheduler calls three webhooks: /filter (feasibility: free-share
accounting per node, or the gang's reservation), /prioritize (topology
score: how snugly the pod's GPUs pack against walls and allocations), and
/bind (slicefit plans concrete GPUs, the ledger commits them, and the
pod's ``alloc`` annotation carries the result). ``Extender.handle`` is
the one decision path: mutation and trace record under one lock.

The extender is a pure function of (pod, node annotations, ledger): no
apiserver connection exists here. :func:`serve` answers the webhooks over
the standard library's ``http.server`` (the machines the port runs on have
no aiohttp), with the reference's JSON bodies; a schema error is HTTP 400.

Not ported yet (each refused or absent, none faked): preemption (a gang
that finds no slice is refused), the journal, the batch cycle, tenancy,
capacity, drain, autoscale, decision provenance, the shard router, the
bind effector, device-id reconcile, and the other HTTP routes.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np

from tpukube_torch.core import codec
from tpukube_torch.core.clock import SYSTEM
from tpukube_torch.core.config import GpuKubeConfig
from tpukube_torch.core.types import (
    RESOURCE_TPU,
    RESOURCE_VTPU,
    AllocResult,
    PodInfo,
    TopologyCoord,
    make_device_id,
)
from tpukube_torch.device.gpu import (
    ENV_GANG_NUM_SLICES,
    ENV_GANG_SLICE_INDEX,
    ENV_GANG_SLICES,
)
from tpukube_torch.obs.events import EventJournal
from tpukube_torch.sched import kube, slicefit
from tpukube_torch.sched.gang import (
    GangError,
    GangManager,
    GangReservation,
    NoSliceError,
)
from tpukube_torch.sched.state import ClusterState, NodeView, StateError
from tpukube_torch.trace import DecisionTrace

log = logging.getLogger("tpukube_torch.extender")

MAX_SCORE = 10  # kube extender HostPriority scores are 0..10


class ExtenderError(RuntimeError):
    pass


class Extender:
    """Webhook logic, HTTP-free (:func:`serve` wraps this)."""

    # in-flight pods older than this are pruned (abandoned/deleted while
    # Pending); the scheduler re-filters before any bind anyway
    PENDING_TTL_S = 600.0
    LATENCY_WINDOW = 4096

    def __init__(
        self,
        config: GpuKubeConfig,
        state: Optional[ClusterState] = None,
        trace: Optional["DecisionTrace"] = None,
        clock=None,
    ):
        self._config = config
        # scheduling-semantic time (pending-webhook TTL, gang
        # reservation TTLs via the gang manager): injectable so tests
        # can move time instantly; latency MEASUREMENT stays on real time
        self.clock = clock if clock is not None else SYSTEM
        self.state = state or ClusterState()
        # decision trace: handle() records every decision at the
        # protocol boundary; trace_capacity=0 disables
        if trace is None and config.trace_capacity > 0:
            trace = DecisionTrace(
                capacity=config.trace_capacity,
                path=config.trace_path or None,
                max_sink_bytes=config.trace_sink_max_bytes,
            )
        self.trace = trace
        # structured event journal (obs/events.py): the "why did that
        # happen" channel, fed by the gang manager. capacity 0 disables.
        self.events = EventJournal(
            capacity=config.events_capacity,
            path=config.events_path or None,
            max_sink_bytes=config.events_sink_max_bytes,
        )
        # Eviction bus: pods whose chips were taken back (gang rollback)
        # and must be deleted by the pod-lifecycle owner (the sim
        # harness's drain_evictions).
        self.pending_evictions: deque[str] = deque()
        self.gang = GangManager(
            self.state,
            ttl_seconds=config.reservation_ttl_seconds,
            eviction_sink=self.pending_evictions,
            events=self.events,
            clock=self.clock,
        )
        # The epoch-cached scheduling snapshot (sched/snapshot.py),
        # owned by the gang manager and shared here: every filter/
        # prioritize cycle takes it once at the top (under the decision
        # lock) instead of re-deriving occupancy grids and sweep tables
        # from the ledger per webhook.
        self.snapshots = self.gang.snapshots
        # audit sentinel: on this fraction of scheduling cache hits the
        # cache rebuilds from the ledger and raises on divergence (0 = off)
        self.snapshots.audit_rate = config.snapshot_audit_rate
        # incremental snapshot maintenance: epoch bumps record
        # SnapshotDeltas and the cache advances O(Δ); off =
        # rebuild-every-epoch (the parity oracle)
        self.snapshots.delta_enabled = config.snapshot_delta_enabled
        # bulk ingestion: webhook node lists route through
        # ClusterState.ingest_nodes — probe-validated lazy ingest, one
        # epoch/delta seam per batch. Off = per-item upserts.
        self.bulk_ingest = config.bulk_ingest_enabled
        # Pods seen at filter time, so /bind (which only carries names) can
        # recover the request: key -> (pod, uid, seen_monotonic).
        self._pending: dict[str, tuple[PodInfo, str, float]] = {}
        self._pending_lock = threading.Lock()
        self._pending_pruned = self.clock.monotonic()
        # Serializes every decision (mutation + trace record as ONE
        # step): webhooks run on the server's threads and releases
        # arrive from others; without this lock a trace could interleave
        # recording against application order. RLock: a decision may
        # release inside itself.
        self._decision_lock = threading.RLock()
        # webhook latencies, bounded windows (this is a daemon)
        self.latencies: dict[str, deque[float]] = {
            "filter": deque(maxlen=self.LATENCY_WINDOW),
            "prioritize": deque(maxlen=self.LATENCY_WINDOW),
            "bind": deque(maxlen=self.LATENCY_WINDOW),
        }

    def _remember(self, pod: PodInfo) -> None:
        now = self.clock.monotonic()
        with self._pending_lock:
            self._pending[pod.key()] = (pod, pod.uid, now)
            # amortized prune: a full scan per call was O(pending) on
            # the batch fast path (100k-pod kilonode traces); sweeping
            # a few times per TTL window keeps the same bound
            if now - self._pending_pruned < self.PENDING_TTL_S / 4:
                return
            self._pending_pruned = now
            stale = [
                k for k, (_, _, t) in self._pending.items()
                if now - t > self.PENDING_TTL_S
            ]
            for k in stale:
                del self._pending[k]

    # -- request decoding --------------------------------------------------
    @staticmethod
    def device_request(pod: PodInfo) -> Optional[tuple[str, int]]:
        """(resource, count) for the pod's TPU ask, or None for non-TPU pods.
        A pod asking for both resources is malformed (different node modes)."""
        req = pod.requests()
        tpu = req.get(RESOURCE_TPU, 0)
        vtpu = req.get(RESOURCE_VTPU, 0)
        if tpu and vtpu:
            raise ExtenderError(
                f"{pod.key()}: requests both {RESOURCE_TPU} and {RESOURCE_VTPU}"
            )
        if tpu:
            return RESOURCE_TPU, tpu
        if vtpu:
            return RESOURCE_VTPU, vtpu
        return None

    def _ingest_nodes(self, raw_nodes: list[dict[str, Any]]) -> list[str]:
        names = []
        if self.bulk_ingest:
            # the webhook body re-sends the whole candidate fleet every
            # request: ride the batch fast path (ONE lock hold, known
            # unchanged payloads answered by signature, new nodes
            # staged lazily). A bad payload still aborts the request
            # like the per-node path's raise did.
            items = []
            for obj in raw_nodes:
                name, annotations = kube.node_name_and_annotations(obj)
                items.append({"name": name, "annotations": annotations})
                names.append(name)
            for res in self.state.ingest_nodes(items):
                if isinstance(res, dict) and res.get("error"):
                    raise StateError(res["error"])
            return names
        for obj in raw_nodes:
            name, annotations = kube.node_name_and_annotations(obj)
            self.state.upsert_node(name, annotations)
            names.append(name)
        return names

    # -- /filter -----------------------------------------------------------
    def filter(
        self,
        pod: PodInfo,
        raw_nodes: Optional[list[dict[str, Any]]] = None,
        node_names: Optional[list[str]] = None,
    ) -> tuple[list[Any], dict[str, str]]:
        """Feasibility webhook. Two request modes, matching the upstream
        protocol: full node objects (ingested into the state cache), or
        nodeCacheCapable ``node_names`` answered purely from the cache.
        The feasible list holds objects or names respectively."""
        t0 = time.monotonic()
        try:
            if raw_nodes is not None:
                names = self._ingest_nodes(raw_nodes)
            else:
                names = list(node_names or [])
            ask = self.device_request(pod)
            if ask is None:
                # not a TPU pod: everything is feasible, nothing to track
                return (raw_nodes if raw_nodes is not None else names), {}
            by_name = (dict(zip(names, raw_nodes))
                       if raw_nodes is not None else None)
            resource, count = ask
            self._remember(pod)
            res: Optional[GangReservation] = None
            if pod.group is not None:
                if resource != RESOURCE_TPU:
                    raise ExtenderError(
                        f"{pod.key()}: gang scheduling requires whole-chip "
                        f"({RESOURCE_TPU}) requests"
                    )
                try:
                    res = self.gang.ensure_reservation(pod, count)
                except NoSliceError:
                    # no contiguous slice: the reference would plan a
                    # preemption for a gang with priority > 0
                    self._refuse_preemption(pod)
                if not self.gang.assignable(res, count):
                    # replica beyond min_member of a full gang: schedule it
                    # as a normal pod rather than wedging it Pending forever
                    res = None
                if res is not None and self.trace is not None:
                    # timeline span: this member attached to (or created)
                    # the gang's slice reservation in this filter cycle
                    self.trace.span(
                        "gang_reserve", pod.key(),
                        gang=f"{pod.namespace}/{pod.group.name}",
                        chips=res.total_chips(), committed=res.committed,
                    )
            else:
                self.gang.sweep()
            reserved = self._reserved_by_slice() if res is None else None
            # one availability pass per webhook, not one coord scan per
            # node (hot: 64-member gang x 32 nodes x 64 reserved coords)
            gang_counts = (self.gang.node_availability(res)
                           if res is not None else None)
            feasible, failed = [], {}
            for name in names:
                if res is not None:
                    reason = self.gang.feasibility_from(
                        gang_counts, res, name
                    )
                else:
                    reason = self._node_feasibility(name, resource, count, reserved)
                if reason is None:
                    feasible.append(by_name[name] if by_name is not None
                                    else name)
                else:
                    failed[name] = reason
            return feasible, failed
        finally:
            self._observe_latency("filter", time.monotonic() - t0)

    def _refuse_preemption(self, pod: PodInfo) -> None:
        """The filter error for a gang that found no contiguous slice.
        Below priority 1 the reference refuses in these words too; above
        it the reference would plan a preemption, which the port does
        not have yet."""
        assert pod.group is not None
        gang = f"{pod.namespace}/{pod.group.name}"
        if not self.snapshots.current().slice_ids() or pod.priority <= 0:
            raise GangError(
                f"gang {gang}: no contiguous slice "
                f"and priority {pod.priority} cannot preempt"
            )
        raise GangError(
            f"gang {gang}: no contiguous slice at priority "
            f"{pod.priority}; preemption is not ported yet"
        )

    def _observe_latency(self, handler: str, seconds: float) -> None:
        """One webhook latency sample, into its bounded window."""
        self.latencies[handler].append(seconds)

    def _reserved_by_slice(self) -> dict[str, frozenset[TopologyCoord]]:
        return self.snapshots.current().reserved_by_slice()

    def _node_feasibility(
        self,
        name: str,
        resource: str,
        count: int,
        reserved: Optional[dict[str, set[TopologyCoord]]] = None,
    ) -> Optional[str]:
        """None if feasible, else a human-readable reason. ``reserved`` is
        the per-slice gang mask — pass it in when calling per-node in a
        loop (coords are slice-local, so the mask is keyed by slice)."""
        view = self.state.node(name)
        if view is None:
            return "no tpukube node-topology annotation"
        vtpu_node = view.shares_per_chip > 1
        if resource == RESOURCE_VTPU:
            if not vtpu_node:
                return "node is whole-chip mode, pod wants vTPU shares"
            free = view.total_free_shares()
            if free < count:
                return f"wants {count} vTPU shares, node has {free}"
            return None
        if vtpu_node:
            return "node is vTPU mode, pod wants whole chips"
        sid = view.info.slice_id
        mask = (
            reserved.get(sid, set()) if reserved is not None
            else self.gang.reserved_coords(sid)
        )
        free = sum(1 for c in view.free_chips() if c.coord not in mask)
        if free < count:
            return f"wants {count} chips, node has {free} free (gang reservations excluded)"
        return None

    # -- /prioritize -------------------------------------------------------
    def prioritize(
        self,
        pod: PodInfo,
        raw_nodes: Optional[list[dict[str, Any]]] = None,
        node_names: Optional[list[str]] = None,
    ) -> dict[str, int]:
        t0 = time.monotonic()
        try:
            if raw_nodes is not None:
                names = self._ingest_nodes(raw_nodes)
            else:
                names = list(node_names or [])
            try:
                ask = self.device_request(pod)
            except ExtenderError:
                return {n: 0 for n in names}
            if ask is None:
                return {n: 0 for n in names}
            resource, count = ask
            if pod.group is not None and resource == RESOURCE_TPU:
                res = self.gang.reservation(pod.namespace, pod.group.name)
                if res is not None and self.gang.assignable(res, count):
                    counts = self.gang.node_availability(res)
                    return {
                        n: self.gang.score_from(counts, n)
                        for n in names
                    }
                if res is None:
                    return {n: 0 for n in names}
                # overflow replica of a full gang: fall through to normal
            # the occupancy sweeps and gang masks depend only on cluster
            # state — read once per request from the epoch-cached
            # snapshot, which survives ACROSS requests until the next
            # ledger/reservation mutation (the per-webhook sweep rebuild
            # this replaces was the prioritize hot path); both are
            # slice-keyed (coords are slice-local)
            snap = self.snapshots.current()
            reserved = snap.reserved_by_slice()
            sweeps: Optional[dict[str, "slicefit._Sweep"]] = None
            if self._config.score_mode == "topology" and resource == RESOURCE_TPU:
                sweeps = {
                    sid: snap.slice(sid).blocked_sweep()
                    for sid in snap.slice_ids()
                }
            scores: dict[str, int] = {}
            for name in names:
                scores[name] = self._score_node(name, resource, count, sweeps, reserved)
            return scores
        finally:
            self._observe_latency("prioritize", time.monotonic() - t0)

    def _score_node(
        self,
        name: str,
        resource: str,
        count: int,
        sweeps: Optional[dict[str, "slicefit._Sweep"]] = None,
        reserved: Optional[dict[str, set[TopologyCoord]]] = None,
    ) -> int:
        view = self.state.node(name)
        if view is None or self._node_feasibility(name, resource, count, reserved):
            return 0
        mode = self._config.score_mode
        n_chips = len(view.info.chips)
        if mode == "spread":
            free_frac = view.total_free_shares() / (
                n_chips * view.shares_per_chip or 1
            )
            return round(MAX_SCORE * free_frac)
        if mode == "binpack":
            used_frac = 1 - view.total_free_shares() / (
                n_chips * view.shares_per_chip or 1
            )
            return round(MAX_SCORE * used_frac)
        # "topology" (default): ICI-mesh locality.
        if resource == RESOURCE_TPU and count == 1 and sweeps is not None:
            # vectorized fast path for the commonest request: the node's
            # score is the snuggest single free chip it offers, read off
            # the per-request contact grid (bind re-plans the concrete
            # chip; scoring only needs the node's best)
            sid = view.info.slice_id
            sweep = sweeps.get(sid)
            if sweep is not None:
                mask_set = (
                    reserved.get(sid, set()) if reserved is not None else set()
                )
                cg = sweep.contact_grid()
                best = -1
                for chip in view.free_chips():
                    if chip.coord in mask_set:
                        continue
                    v = int(cg[chip.coord])
                    if v > best:
                        best = v
                return round(MAX_SCORE * best / 6) if best >= 0 else 0
        plan = self._plan_chips(view, resource, count, reserved)
        if plan is None:
            return 0
        if resource == RESOURCE_VTPU:
            # prefer riding already-used chips (keeps whole chips free)
            reused = sum(
                1
                for c in plan
                if view.used_share_count(self._index_at(view, c))
            )
            return min(MAX_SCORE, round(MAX_SCORE * (reused + 1) / (len(plan) + 1)))
        # whole chips: snugness — chips packed against walls/allocations
        # leave the mesh least fragmented, keeping future gangs' boxes open
        sid = view.info.slice_id
        sweep = sweeps.get(sid) if sweeps is not None else None
        if sweep is None:
            sweep = self.snapshots.current().slice(sid).occupancy_sweep()
        contact = 0
        max_contact = 0
        for coord in plan:
            contact += sweep.contact_point(coord)
            max_contact += 6
        return round(MAX_SCORE * contact / max_contact) if max_contact else 0

    @staticmethod
    def _index_at(view: NodeView, coord: TopologyCoord) -> int:
        try:
            return view.index_at(coord)  # O(1) via the view's coord map
        except StateError as e:
            raise ExtenderError(str(e)) from None

    # -- placement planning -------------------------------------------------
    def _plan_chips(
        self,
        view: NodeView,
        resource: str,
        count: int,
        reserved: Optional[dict[str, set[TopologyCoord]]] = None,
    ) -> Optional[list[TopologyCoord]]:
        """Choose concrete chips on one node for a request.

        Whole chips: slicefit over the global mesh, restricted to this
        node's free chips (everything else masked occupied) — irregular
        allowed, a host block is tightly connected anyway.
        vTPU: chip-level choice only (shares are fungible); fill
        partially-used chips first to keep whole chips free.
        """
        if resource == RESOURCE_VTPU:
            chips = sorted(
                (c for c in view.info.chips if view.free_shares(c) > 0),
                key=lambda c: (-view.used_share_count(c.index), c.index),
            )
            out: list[TopologyCoord] = []
            remaining = count
            for chip in chips:
                take = min(remaining, view.free_shares(chip))
                out.extend([chip.coord] * take)
                remaining -= take
                if remaining == 0:
                    return out
            return None
        sid = view.info.slice_id
        ss = self.snapshots.current().slice(sid)
        mesh = ss.mesh
        mask_set = (
            reserved.get(sid, set()) if reserved is not None
            else ss.reserved
        )
        node_free = {
            c.coord for c in view.free_chips() if c.coord not in mask_set
        }
        if len(node_free) < count:
            return None
        if count == 1:
            # fast path for the commonest request (1 chip/pod): pick the
            # node's free chip snuggest against GLOBAL occupancy — the
            # same quantity /prioritize's contact-grid scoring maximizes,
            # so the bound chip realizes the score the node won on (other
            # hosts' FREE chips are not blockers; treating them as such,
            # as the old mask form did, mis-ranked fragmentation)
            blocked = ss.occupied | mask_set | ss.absent
            best = max(
                node_free,
                key=lambda c: (
                    slicefit.point_contact(mesh, c, lambda nb: nb in blocked),
                    tuple(-v for v in c),
                ),
            )
            return [best]
        # everything outside this node's free set is masked occupied —
        # a NODE-LOCAL grid, so it cannot live in the cluster snapshot;
        # built directly as an ndarray and handed to the slicefit
        # wrapper (whose sweep build is the module's own seam)
        mask = np.ones(mesh.dims, dtype=bool)
        for c in node_free:
            mask[tuple(c)] = False
        placed = slicefit.find_slice(
            mesh, mask, count=count, allow_irregular=True,
            broken=ss.broken,
        )
        if placed is not None:
            return placed
        # Free chips exist but form no box/connected region (e.g. diagonal
        # survivors in a host block). Chips on ONE HOST are always mutually
        # usable — adjacency is a preference, not a requirement, for
        # non-gang pods — so fall back to any free chips, keeping the
        # filter's count-based feasibility and bind in agreement.
        chosen = sorted(node_free)[:count]
        return [TopologyCoord.of(c) for c in chosen]

    # -- /bind --------------------------------------------------------------
    def bind(self, pod_name: str, namespace: str, uid: str, node_name: str) -> AllocResult:
        t0 = time.monotonic()
        try:
            key = f"{namespace}/{pod_name}"
            with self._pending_lock:
                entry = self._pending.get(key)
            if entry is None:
                raise ExtenderError(
                    f"bind for {key} without a preceding filter (restart? "
                    "scheduler will re-run the cycle)"
                )
            pod, cached_uid, _ = entry
            if uid and cached_uid and uid != cached_uid:
                raise ExtenderError(
                    f"bind for {key}: uid {uid} does not match the filtered "
                    f"pod {cached_uid} (deleted and recreated?)"
                )
            ask = self.device_request(pod)
            if ask is None:
                raise ExtenderError(f"{key}: no TPU request to bind")
            resource, count = ask
            view = self.state.node(node_name)
            if view is None:
                raise ExtenderError(f"bind to unknown node {node_name}")
            res: Optional[GangReservation] = None
            if pod.group is not None and resource == RESOURCE_TPU:
                res = self.gang.reservation(pod.namespace, pod.group.name)
                if res is None:
                    raise ExtenderError(
                        f"{key}: gang reservation dissolved (TTL/fault); "
                        "scheduler will re-run the cycle"
                    )
                if not self.gang.assignable(res, count):
                    res = None  # overflow replica: normal placement
            if res is not None:
                try:
                    plan = self.gang.plan_for_bind(res, pod, node_name)
                except GangError as e:
                    raise ExtenderError(str(e)) from e
            else:
                plan = self._plan_chips(view, resource, count)
            if plan is None:
                raise ExtenderError(
                    f"{key}: node {node_name} can no longer fit {count} x {resource}"
                )
            device_ids = self._mint_device_ids(view, resource, plan)
            env: dict[str, str] = {}
            if res is not None:
                # gang context for the in-pod runtime (rides the alloc
                # annotation / downward API — the device plugin's Allocate
                # only sees device ids, so megascale-style multislice
                # coordination env cannot come from the node agent)
                sids = sorted(res.slice_coords)
                env[ENV_GANG_NUM_SLICES] = str(len(sids))
                env[ENV_GANG_SLICES] = ",".join(sids)
                env[ENV_GANG_SLICE_INDEX] = str(sids.index(view.info.slice_id))
            alloc = AllocResult(
                pod_key=key,
                node_name=node_name,
                device_ids=device_ids,
                coords=sorted(set(plan)),
                env=env,
                priority=pod.priority,
                uid=uid or cached_uid or "",
            )
            self.state.commit(alloc)  # StateError on lost race
            if res is not None:
                try:
                    committed_now = self.gang.on_bound(
                        res, key, plan, node_name
                    )
                except GangError as e:
                    # reservation changed between plan and commit: undo
                    self.state.release(key)
                    raise ExtenderError(str(e)) from e
                if committed_now and self.trace is not None:
                    # timeline span: this bind assembled the quorum
                    self.trace.span(
                        "gang_commit", key,
                        gang=f"{res.namespace}/{res.group.name}",
                        members=len(res.assigned),
                        latency_s=res.commit_latency,
                    )
            with self._pending_lock:
                self._pending.pop(key, None)
            log.info("bound %s -> %s %s", key, node_name, device_ids)
            return alloc
        finally:
            self._observe_latency("bind", time.monotonic() - t0)

    def _mint_device_ids(
        self, view: NodeView, resource: str, plan: list[TopologyCoord]
    ) -> list[str]:
        if resource == RESOURCE_TPU:
            return [
                make_device_id(self._index_at(view, coord)) for coord in plan
            ]
        # vTPU: mint the lowest UNUSED share index per chip — a count would
        # re-issue a released id while its sibling is still allocated
        n = view.shares_per_chip
        ids = []
        taken: dict[int, set[int]] = {}
        for coord in plan:
            index = self._index_at(view, coord)
            if index not in taken:
                taken[index] = set(view.used_frac_ks(index))
            k = next((i for i in range(n) if i not in taken[index]), None)
            if k is None:
                raise ExtenderError(f"chip {index}: shares exhausted mid-mint")
            taken[index].add(k)
            ids.append(make_device_id(index, (k, n)))
        return ids

    # -- pod lifecycle ------------------------------------------------------
    def release(self, pod_key: str) -> None:
        self.handle("release", {"pod_key": pod_key})

    # -- atomic webhook dispatch --------------------------------------------
    def handle(self, kind: str, body: Any) -> Any:
        """Process one decision request body and return the wire response.

        Every decision path — the HTTP handlers, the sim harness's direct
        releases — comes through here: mutation and trace recording
        happen under one lock, so trace order IS application order even
        with releases arriving from other threads than the webhooks'.

        Schema errors raise ``kube.KubeSchemaError`` before any mutation;
        the HTTP layer maps them to 400 without recording.
        """
        with self._decision_lock:
            if kind == "filter":
                pod, nodes, names = kube.parse_extender_args(body)
                if nodes is None and names is None:
                    # NodesCached body: the candidate set is every node
                    # this planner knows (the cached tuple — no O(nodes)
                    # list rebuild per webhook)
                    names = self.state.node_names()
                mk = (kube.filter_result if nodes is not None
                      else kube.filter_result_names)
                try:
                    feasible, failed = self.filter(
                        pod, raw_nodes=nodes, node_names=names
                    )
                    response: Any = mk(feasible, failed)
                except (ExtenderError, GangError, StateError,
                        codec.CodecError) as e:
                    response = mk([], {}, error=str(e))
            elif kind == "prioritize":
                pod, nodes, names = kube.parse_extender_args(body)
                if nodes is None and names is None:
                    names = self.state.node_names()  # NodesCached body
                try:
                    scores = self.prioritize(
                        pod, raw_nodes=nodes, node_names=names
                    )
                except (ExtenderError, GangError, StateError,
                        codec.CodecError) as e:
                    log.warning("prioritize failed: %s", e)
                    scores = {}
                response = kube.host_priority_list(scores)
            elif kind == "bind":
                name, ns, uid, node = kube.parse_binding_args(body)
                try:
                    alloc = self.bind(name, ns, uid, node)
                    # the alloc annotation rides back to the
                    # harness/apiserver-writer
                    response = kube.binding_result()
                    response["Annotations"] = {
                        codec.ANNO_ALLOC: codec.encode_alloc(alloc)
                    }
                except (ExtenderError, GangError, StateError,
                        codec.CodecError) as e:
                    response = kube.binding_result(str(e))
            elif kind == "release":
                pod_key = body["pod_key"]
                self.state.release(pod_key)
                self.gang.on_release(pod_key)
                with self._pending_lock:
                    self._pending.pop(pod_key, None)
                response = None
            elif kind == "victim_gone":
                # an evicted pod's object is confirmed gone: unmask its
                # chips. A recorded decision, so the mask changes only
                # through the trace.
                response = {
                    "cleared": self.gang.on_victim_gone(body["pod_key"])
                }
            elif kind == "upsert_node":
                # out-of-band node-annotation refresh (nodeCacheCapable
                # mode: webhooks carry names only, so topology updates
                # arrive through this recorded decision instead)
                try:
                    response = {"ours": self.state.upsert_node(
                        body["name"], dict(body.get("annotations") or {})
                    )}
                except (codec.CodecError, StateError) as e:
                    response = {"error": str(e)}
            elif kind == "upsert_nodes":
                # batched fleet ingest: ONE recorded decision for the
                # whole batch; per-item results ride the response
                # positionally in the per-item shape
                items = list(body.get("items") or [])
                if self.bulk_ingest:
                    results = self.state.ingest_nodes(items)
                else:
                    results = []
                    for item in items:
                        try:
                            results.append({
                                "ours": self.state.upsert_node(
                                    item["name"],
                                    dict(item.get("annotations") or {}),
                                )
                            })
                        except (codec.CodecError, StateError) as e:
                            results.append({"error": str(e)})
                response = {"results": results}
            else:
                raise ValueError(f"unknown decision kind {kind!r}")
            if self.trace is not None:
                self.trace.record(kind, body, response)
            return response

    # -- restart story -------------------------------------------------------
    def rebuild_from_pods(self, pods: list[dict[str, str]]) -> int:
        """Reconstruct ledger AND gang reservations from pod annotations
        (each item is one pod's annotation dict) after an extender restart.

        Restoring only per-pod allocations would silently downgrade running
        gangs to free-standing pods: a later preemption could then evict
        individual members, violating all-or-nothing death. The pod-group
        annotations persist gang identity, so rebuild it here.
        """
        restored = self.state.rebuild_from_pods(pods)
        members: dict[tuple[str, str], list] = {}  # (ns, group) -> [(alloc, group)]
        for annotations, alloc in restored:
            try:
                group = codec.pod_group_from_annotations(annotations)
            except codec.CodecError as e:
                # one pod's malformed gang annotation must not abort the
                # whole cluster's state reconstruction
                log.warning(
                    "pod %s: undecodable pod-group annotation (%s); "
                    "restored as non-gang", alloc.pod_key, e,
                )
                continue
            if group is None:
                continue
            ns = alloc.pod_key.split("/", 1)[0]
            members.setdefault((ns, group.name), []).append((alloc, group))
        for (ns, _), entries in members.items():
            allocs = [a for a, _ in entries]
            self.gang.restore(ns, entries[0][1], allocs)
        return len(restored)


# -- webhook server (standard library) ----------------------------------------

_ROUTES = {"/filter": "filter", "/prioritize": "prioritize", "/bind": "bind"}


class _WebhookHandler(BaseHTTPRequestHandler):
    """POST /filter, /prioritize, /bind and GET /healthz, with the JSON
    bodies of the reference's aiohttp app: a body that is not JSON, or a
    schema error, is HTTP 400 and records nothing."""

    protocol_version = "HTTP/1.1"  # keep-alive, as kube-scheduler uses

    def _reply(self, status: int, payload: bytes,
               content_type: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _text(self, status: int, text: str) -> None:
        self._reply(status, text.encode(), "text/plain; charset=utf-8")

    def do_POST(self) -> None:  # noqa: N802 (http.server's name)
        raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        kind = _ROUTES.get(self.path)
        if kind is None:
            self._text(404, "not found")
            return
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self._text(400, f"bad JSON: {e}")
            return
        try:
            response = self.server.extender.handle(kind, body)
        except kube.KubeSchemaError as e:
            self._text(400, str(e))
            return
        self._reply(200, json.dumps(response).encode())

    def do_GET(self) -> None:  # noqa: N802
        if self.path != "/healthz":
            self._text(404, "not found")
            return
        ext = self.server.extender
        self._reply(200, json.dumps(
            {"ok": True, "nodes": list(ext.state.node_names())}).encode())

    def log_message(self, format: str, *args: Any) -> None:
        log.debug("%s %s", self.address_string(), format % args)


def serve(extender: Extender, host: str = "127.0.0.1",
          port: int = 0) -> ThreadingHTTPServer:
    """Serve ``extender``'s webhooks on ``host:port`` (0 = a free port;
    read it from ``server.server_address``) from a daemon thread. Stop
    with ``server.shutdown(); server.server_close()``."""
    server = ThreadingHTTPServer((host, port), _WebhookHandler)
    server.daemon_threads = True
    server.extender = extender
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="tpukube-extender-http").start()
    return server


def main(argv: Optional[list[str]] = None) -> None:
    """Run the extender daemon on ``extender_host:extender_port`` (the
    ``TPUKUBE_*`` environment overlay) until interrupted."""
    import argparse

    from tpukube_torch.core.config import load_config

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    cfg = load_config()
    server = serve(Extender(cfg), args.host or cfg.extender_host,
                   cfg.extender_port if args.port is None else args.port)
    host, port = server.server_address[:2]
    print(f"tpukube_torch extender on http://{host}:{port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
