"""Scheduler extender (L5) — the port's own copy of the default decision
path of ``tpukube/sched/extender.py``, plus its webhook server.

kube-scheduler calls three webhooks: /filter (feasibility: free-share
accounting per node, or the gang's reservation), /prioritize (topology
score: how snugly the pod's GPUs pack against walls and allocations), and
/bind (slicefit plans concrete GPUs, the ledger commits them, and the
pod's ``alloc`` annotation carries the result). ``Extender.handle`` is
the one decision path: mutation and trace record under one lock. With a
``binder`` (``tpukube_torch.apiserver.pod_binder``), a successful /bind
also creates the pod's Binding through the apiserver, outside the lock; a
failed Binding undoes the ledger commit (and a gang's quorum commit) for
the scheduler's retry. The recorded ``reconcile`` decision folds a
kubelet's divergent device choice into the ledger.

A gang with priority > 0 that finds no contiguous slice preempts
(``sched/policy.py``), in two phases: /filter records the cheapest victim
set on the gang's reservation; the gang's first /bind evicts them (plain
pods released and queued on ``pending_evictions``, gang victims dissolved
whole) and fails retryably until every victim's pod object is confirmed
gone (the recorded ``victim_gone`` decision, sent by the eviction executor
of ``tpukube_torch.apiserver``). ``evict_precheck``, when wired, refuses a
bind whose plan a PodDisruptionBudget would block, before any eviction.

The extender's decisions are a pure function of (pod, node annotations,
ledger); the apiserver is reached only through the ``binder`` and
``evict_precheck`` callables a daemon wires in. The HTTP layer is the
standard library's ``http.server`` (the machines the port runs on have
no aiohttp), with the reference's JSON bodies; a schema error is HTTP
400.

With ``batch_enabled`` the webhooks answer from a batch plan
(``tpukube_torch.sched.cycle.SchedulingCycle``, ``self.cycle``): /filter
admits the pod and plans a cycle against one pinned snapshot, committing
each placement as an assumed allocation; /prioritize and /bind answer
from that plan, and a bind to another node undoes the assume and binds
the per-pod way. ``admit``/``plan_pending``/``planned_node`` feed and
read the queue ahead of any webhook (the pod informer's
``PodAdmissionFeed``, the sim's batch driver). Each real webhook records
exactly one latency sample in either mode.

While ``degraded_gate`` names a reason (the daemon wires it to the
apiserver circuit), /filter and /bind fail safe before any mutation.

The HTTP surface (:func:`make_app`, :func:`run_server`, :func:`serve`):
the webhooks, ``GET /healthz``, ``/metrics``
(``tpukube_torch.metrics``), ``/state/topology|allocs|gangs``,
``/trace?since=``, ``/events?reason=&pod=&node=&since=``, ``/explain?pod=``
and ``/statusz``
(``tpukube_torch.obs.statusz``), behind an optional bearer token and
TLS; :func:`make_probe_app` is the plain-HTTP listener for /healthz and
/metrics only. ``python -m tpukube_torch.cli extender`` is the daemon.

With ``journal_enabled`` every ledger and gang mutation is written ahead to
the durable journal (``sched/journal.py``) and ``handle`` captures a
periodic checkpoint; ``journal.recover_extender`` restores a restarted
daemon from them.

With ``tenancy_enabled`` the tenancy plane (``tenancy/``) gates /filter,
``admit`` and the batch plans (quotas, SLO-burn shedding), biases
preemption toward over-share tenants and stamps each bind's alloc env
with its tenant.

With ``capacity_enabled`` the capacity recorder (``obs/capacity.py``)
samples the fleet on the decision path, root-causes each refusal into the
stranded-demand taxonomy and serves ``/capacity`` and ``/capacity/probe``.
With ``drain_enabled`` the drain coordinator (``sched/drain.py``) cordons,
evicts under a budget and un-ingests; /filter refuses a cordoned node.
With ``autoscale_enabled`` the autoscaler (``sched/autoscale.py``) grows
the fleet on queue depth or SLO burn and shrinks it through a drain.
Drain and autoscaler ticks ride the decision path, as checkpoints do.

With ``decisions_enabled`` the decision-provenance ring
(``obs/decisions.py``, ``self.decisions``) records each sampled pod's
stages (admit, cycle plan, filter pruning, scores, refusals, bind,
preemption, release) for ``/explain``, and ``tpukube_cycle_phase_seconds``
(``self.phase_hist``) times the cycle's queue / pin / plan / answer /
commit phases. Off, neither is built and nothing is recorded.

The shard router (``sched/shard.py``) runs N of these behind one
decision surface; ``eviction_sink`` hands them one shared eviction bus.
"""

from __future__ import annotations

import hmac
import json
import logging
import ssl
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional
from urllib.parse import parse_qsl, urlsplit

import numpy as np

from tpukube_torch.core import codec
from tpukube_torch.core.clock import SYSTEM
from tpukube_torch.core.config import GpuKubeConfig
from tpukube_torch.core.types import (
    RESOURCE_TPU,
    RESOURCE_VTPU,
    AllocResult,
    Health,
    PodInfo,
    TopologyCoord,
    make_device_id,
    parse_device_id,
)
from tpukube_torch.device.gpu import (
    ENV_GANG_NUM_SLICES,
    ENV_GANG_SLICE_INDEX,
    ENV_GANG_SLICES,
    ENV_KUBE_TENANT,
)
from tpukube_torch.obs.events import EventJournal
from tpukube_torch.obs.registry import Histogram
from tpukube_torch.sched import kube, policy, slicefit
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
        eviction_sink: Optional[deque] = None,
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
        # Decision provenance (obs/decisions.py): a bounded, sampled,
        # lock-free-on-record ring of per-pod stage events — the "why did
        # this pod land there / stay Pending / get refused" chain —
        # served on /explain, /statusz "decisions" and `obs explain`.
        # None (the config default) builds nothing: no stage is
        # constructed, no series renders, and every placement path is
        # untouched.
        self.decisions = None
        # cycle phase profiling rides the same flag: queue / pin / plan /
        # answer / commit wall per cycle, plus the webhook-answer
        # materialization timer that attributes the O(nodes) filter
        # response cost. None = no observation anywhere.
        self.phase_hist = None
        if config.decisions_enabled:
            from tpukube_torch.obs.decisions import DecisionLog

            self.decisions = DecisionLog(
                capacity=config.decisions_capacity,
                sample_rate=config.decisions_sample_rate,
                seed=config.decisions_seed,
                path=config.decisions_path or None,
                max_sink_bytes=config.decisions_sink_max_bytes,
            )
            self.phase_hist = Histogram(
                "tpukube_cycle_phase_seconds",
                buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                         0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0),
                help_text="Wall time per scheduling phase: queue wait, "
                          "snapshot pin, batch plan, webhook-answer "
                          "materialization, bind commit.")
        # Cluster-wide eviction bus: pods whose chips were taken back
        # (gang rollback/dissolve, preemption) and must be deleted by the
        # pod-lifecycle owner (the EvictionExecutor of apiserver.py, which
        # the sim harness's drain_evictions wraps). ``eviction_sink``
        # lets the shard router (sched/shard.py) hand all replicas ONE
        # shared bus so a single EvictionExecutor drains every
        # replica's victims.
        self.pending_evictions: deque[str] = (
            eviction_sink if eviction_sink is not None else deque()
        )
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
        # generation-based incremental resync: size the ledger's alloc
        # change log so lifecycle resyncs read O(Δ) via allocs_since
        # instead of the full ledger per wave (capacity 0 keeps the
        # full read and the exposition free of the tpukube_resync_*
        # series)
        self.state.set_generation_log(config.generation_log_capacity)
        self.resync_incremental = config.generation_log_capacity > 0
        # Durable control-plane state (sched/journal.py): with
        # journal_enabled every ledger/gang mutation seam appends one
        # WAL record (enqueue-only — the journal's drain thread owns the
        # disk) and handle() captures a periodic checkpoint, so a
        # restarted daemon recovers O(Δ-since-checkpoint) via
        # journal.recover_extender instead of the O(fleet) cold rebuild.
        # None (the config default) journals nothing.
        self.journal = None
        # per-payload node-line + per-alloc memo for checkpoint
        # captures (steady state costs O(Δ), not O(fleet))
        self._ckpt_cache: dict = {}
        if config.journal_enabled:
            from tpukube_torch.sched.journal import StateJournal

            self.journal = StateJournal(
                config.journal_path,
                max_bytes=config.journal_max_bytes,
                fsync=config.journal_fsync,
                checkpoint_interval=config.checkpoint_interval_seconds,
                events=self.events,
                clock=self.clock,
            )
            self.state.set_journal(self.journal)
            self.gang.set_journal(self.journal)
        # Batched scheduling cycles (sched/cycle.py): with batch_enabled
        # the webhooks answer from a per-cycle batch plan instead of
        # re-planning per request; None (the config default) keeps the
        # per-pod path bit-identically — nothing batch-related is
        # constructed or consulted.
        self.cycle = None
        if config.batch_enabled:
            from tpukube_torch.sched.cycle import SchedulingCycle

            self.cycle = SchedulingCycle(self, config)
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
        # the same latencies as monotonic histogram buckets (counters,
        # cumulative since start — the windowed deques feed only the
        # quantile summaries); children pre-created so every handler's
        # _bucket series renders from the first scrape
        self.webhook_hist = Histogram("tpukube_webhook_latency_seconds",
                                      bucket_only=True)
        for handler in self.latencies:
            self.webhook_hist.labels(handler=handler)
        # True only while the batch planner's plan-time internal calls
        # run (under the decision lock): their filter/prioritize/bind
        # invocations are not webhooks and must not feed the histograms
        self._suppress_latency = False
        # Multi-tenant serving plane (tpukube_torch/tenancy): with
        # tenancy_enabled the plane gates admissions (quotas + SLO-burn
        # shedding), orders the batch queue by dominant-resource
        # fairness, and biases preemption victim choice toward
        # over-share tenants. None (the config default) constructs
        # nothing — every placement path and the /metrics exposition
        # stay byte-identical to the behavior without it.
        self.tenants = None
        if config.tenancy_enabled:
            from tpukube_torch.tenancy import TenantPlane

            self.tenants = TenantPlane(
                config, self.state, self.gang, events=self.events,
                clock=self.clock,
            )
            # SLO-aware admission reads the DEFAULT_SLOS burn straight
            # off the daemon's own cumulative histograms — the same
            # objectives deploy/prometheus-rules.yaml alerts on
            self.tenants.burn.attach_default_slos({
                "gang_schedule_latency_seconds": self.gang.commit_hist,
                "tpukube_webhook_latency_seconds": self.webhook_hist,
            })
            # gang reservations carry their tenant so reserved-but-
            # unbound chips are charged to the right owner
            self.gang.tenant_of = self.tenants.tenant_of
            # tenancy refusals (quota denial / SLO shed) record their
            # verdict — shares and tenant-local burn at decision time —
            # into the provenance ring (None = no recording)
            self.tenants.decisions = self.decisions
        # Capacity analytics & demand forensics (obs/capacity.py):
        # flight-recorder ring + stranded-demand forensics + what-if
        # probes. None (the config default) constructs nothing — no
        # sample is ever taken, no series renders, /capacity 404s, and
        # placements/exposition stay byte-identical. Built AFTER
        # snapshots/cycle/tenants so a sample can read all of them.
        self.capacity = None
        if config.capacity_enabled:
            from tpukube_torch.obs.capacity import CapacityRecorder

            self.capacity = CapacityRecorder(self, config)
        # Fleet elasticity: the graceful drain/decommission choreography
        # (sched/drain.py) and the autoscaler loop (sched/autoscale.py).
        # None (the config defaults) constructs nothing — no cordon
        # state is consulted on any placement path, no tpukube_drain_* /
        # tpukube_autoscaler_* series render, and /statusz carries no
        # drain/autoscaler section. Built AFTER snapshots/cycle/tenants/
        # capacity so a tick can read all of them.
        self.drain = None
        if config.drain_enabled:
            from tpukube_torch.sched.drain import DrainCoordinator

            self.drain = DrainCoordinator(self, config)
        self.autoscaler = None
        if config.autoscale_enabled:
            from tpukube_torch.sched.autoscale import Autoscaler

            self.autoscaler = Autoscaler(self, config)
        self.preemptions = 0   # victims evicted for higher-priority gangs
        self.binds_total = 0   # successful binds (metrics counter)
        # The bind EFFECTOR: with bindVerb configured, kube-scheduler
        # delegates the binding itself to the extender — returning success
        # without creating the Binding object leaves the pod Pending
        # forever on a real cluster. A daemon wires
        # apiserver.pod_binder(api) here; None in sim (the harness plays
        # the apiserver and applies the response's annotations itself).
        # The call runs OUTSIDE the decision lock (_handle_bind) so
        # apiserver latency never stalls filter/prioritize.
        self.binder = None
        # pod_key -> (reservation, this-bind-committed-the-gang), written
        # by bind() when a binder is set, consumed by _handle_bind's
        # effector undo
        self._bind_gang_info: dict[str, tuple[Any, bool]] = {}
        # the apiserver channel's Retrier/CircuitBreaker, attached by a
        # daemon purely so /metrics can export their counters
        # (tpukube_retry_* / tpukube_circuit_*); None in sim
        self.api_retrier = None
        self.api_circuit = None
        # The PDB PRECHECK: a callable pod_key -> Optional[bool] (True =
        # evictable now, False = a PodDisruptionBudget blocks it, None =
        # cannot determine). Consulted by _handle_bind BEFORE a gang's
        # first bind executes its preemption plan: evictions are
        # irreversible, so a plan with a PDB-blocked victim is refused
        # loudly instead of half-executed (the reservation then TTLs out
        # without costing anyone chips). Runs OUTSIDE the decision lock
        # and is NOT part of the recorded decision — a refused precheck
        # leaves no state to replay.
        self.evict_precheck = None
        # Degraded mode: a callable returning a human reason while the
        # apiserver circuit is open (None = healthy). While degraded,
        # /filter and /bind FAIL SAFE (no feasibility answer, no
        # preemption plan, no bind): an extender that cannot reach the
        # apiserver cannot effect or verify any decision it makes; the
        # scheduler retries once the circuit half-opens. The CLI wires
        # this to the channel's CircuitBreaker; None disables the gate.
        # It must only read memory: it is consulted on every webhook.
        self.degraded_gate = None

    def _emit_event(self, reason: str, obj: str, message: str,
                    warning: bool = True) -> None:
        """Journal an event; never let observability fail a webhook."""
        try:
            self.events.emit(
                reason, obj=obj, message=message,
                type="Warning" if warning else "Normal",
            )
        except Exception:
            log.exception("event emit failed: %s %s", reason, obj)

    def _note_decision(self, pod_key: str, stage: str, **fields) -> None:
        """Guarded provenance record — the one place the sampling gate
        lives for the extender's cold refusal/lifecycle seams (hot paths
        gate explicitly so unsampled pods never build kwargs)."""
        dlog = self.decisions
        if dlog is not None and dlog.wants(pod_key):
            dlog.record(pod_key, stage, **fields)

    def _degraded_reason(self) -> Optional[str]:
        """The degraded gate's answer, never letting a broken gate break
        scheduling (a gate failure reads as healthy)."""
        gate = self.degraded_gate
        if gate is None:
            return None
        try:
            return gate()
        except Exception:
            log.exception("degraded gate failed; treating as healthy")
            return None

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
            self.state.maybe_start_warmer()
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
            if self.tenants is not None:
                # tenancy admission gate: quota breaches and SLO-burn
                # sheds refuse BEFORE any reservation or preemption
                # plan exists — the refusal (journaled by the plane)
                # rides back as the filter error and the scheduler's
                # requeue turns it into a deferral
                refusal = self.tenants.admit(pod, resource, count)
                if refusal is not None:
                    raise ExtenderError(refusal)
            self._remember(pod)
            dlog = self.decisions
            wants = dlog is not None and dlog.wants(pod.key())
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
                    # no contiguous slice — a high-priority gang may evict
                    # cheaper pods to open one (config 5). Other
                    # GangErrors are configuration mistakes and must
                    # never cost innocent pods their chips.
                    res = self._try_preemption(pod, count)
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
                if res is not None and wants:
                    dlog.record(
                        pod.key(), "gang_reserve",
                        gang=f"{pod.namespace}/{pod.group.name}",
                        chips=res.total_chips(),
                        committed=res.committed,
                    )
            else:
                self.gang.sweep()
            reserved = self._reserved_by_slice() if res is None else None
            # one availability pass per webhook, not one coord scan per
            # node (hot: 64-member gang x 32 nodes x 64 reserved coords)
            gang_counts = (self.gang.node_availability(res)
                           if res is not None else None)
            # the webhook-answer materialization — the O(nodes) loop that
            # builds the wire lists; at 10k nodes THIS is the filter p99,
            # and the phase timer attributes it (suppressed for plan-time
            # internal calls, which answer no webhook)
            at0 = (time.perf_counter()
                   if self.phase_hist is not None
                   and not self._suppress_latency else None)
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
            if at0 is not None:
                self.phase_hist.labels(phase="answer").observe(
                    time.perf_counter() - at0
                )
            if wants:
                # per-stage candidate pruning: which reason rejected how
                # many nodes — the why-pending data
                pruned: dict[str, int] = {}
                for r in failed.values():
                    pruned[r] = pruned.get(r, 0) + 1
                dlog.record(
                    pod.key(), "filter",
                    candidates=len(names), feasible=len(feasible),
                    pruned=pruned,
                )
            return feasible, failed
        finally:
            self._observe_latency("filter", time.monotonic() - t0)

    def _observe_latency(self, handler: str, seconds: float) -> None:
        """One webhook latency sample: into the bounded window (quantile
        summaries) AND the cumulative histogram (_bucket counters).
        Suppressed while the batch planner runs its plan-time internal
        calls (SchedulingCycle._quiet) so each real webhook records
        exactly one sample in batch mode too."""
        if self._suppress_latency:
            return
        self.latencies[handler].append(seconds)
        self.webhook_hist.labels(handler=handler).observe(seconds)

    def _reserved_by_slice(self) -> dict[str, frozenset[TopologyCoord]]:
        return self.snapshots.current().reserved_by_slice()

    def _try_preemption(self, pod: PodInfo, count: int) -> GangReservation:
        """Open a contiguous slice for a gang by planning the eviction of
        lower-priority pods. Plans per ICI slice (victim chips only help
        inside their own slice) and reserves the cheapest plan across
        slices — TWO-PHASE: victims are recorded on the reservation, not
        evicted; the evictions execute at the gang's first bind
        (_execute_pending_preemption). A gang that filters but never binds
        (crash, queue churn) costs no innocent pod its chips — the TTL
        sweep drops the reservation and the victims were never touched.
        Raises GangError (propagates unschedulability) if no eligible
        victim set exists or the pod has no priority to preempt with."""
        assert pod.group is not None
        # one snapshot for the whole preemption plan: the planner's
        # blocked sets (unhealthy + terminating) and link state come from
        # the same epoch the candidate sweep is built against
        snap = self.snapshots.current()
        slice_ids = snap.slice_ids()
        if not slice_ids or pod.priority <= 0:
            raise GangError(
                f"gang {pod.namespace}/{pod.group.name}: no contiguous slice "
                f"and priority {pod.priority} cannot preempt"
            )
        total = pod.group.min_member * count
        if pod.group.shape is not None:
            sx, sy, sz = pod.group.shape
            if sx * sy * sz != total:
                raise GangError(
                    f"gang {pod.namespace}/{pod.group.name}: shape "
                    f"{pod.group.shape} holds {sx * sy * sz} chips but the "
                    f"gang needs {total} — refusing to preempt for it"
                )
        workloads = self._preemption_workloads()
        # tenant-aware victim bias (tpukube_torch/tenancy): at equal
        # priority cost the planner prefers boxes whose victims belong
        # to the most over-entitlement tenants; None with tenancy off
        # leaves the ranking bit-identical
        overshare = (self.tenants.overshare_map()
                     if self.tenants is not None else None)
        plan = None
        plan_slice = None
        best_rank = None
        for sid in slice_ids:
            # blocked = unhealthy chips PLUS terminating victims' chips:
            # the latter are ledger-free but physically held, and no
            # eviction can free them sooner — a plan over them would
            # reserve with zero victims and bind ungated onto chips a
            # dying container still owns
            ss = snap.slice(sid)
            cand = policy.find_preemption_plan(
                [w for w in workloads if w.slice_id == sid],
                ss.mesh,
                ss.unhealthy | ss.terminating,
                total,
                pod.group.shape,
                pod.priority,
                broken=ss.broken,
                overshare=overshare,
            )
            if cand is None:
                continue
            rank = (cand.cost_priority_sum, cand.victim_count, sid)
            if best_rank is None or rank < best_rank:
                best_rank, plan, plan_slice = rank, cand, sid
        if plan is None:
            if pod.group.allow_dcn and pod.group.shape is None:
                split = self._plan_split_preemption(
                    workloads, total, count, pod.priority,
                    overshare=overshare,
                )
                if split is not None:
                    victims = [w for p in split.values() for w in p.victims]
                    log.warning(
                        "gang %s/%s plans to preempt %d workload(s) for a "
                        "DCN-split %d-chip reservation over %s (deferred "
                        "to first bind)",
                        pod.namespace, pod.group.name, len(victims), total,
                        sorted(split),
                    )
                    if self.trace is not None:
                        self.trace.span(
                            "preemption_plan", pod.key(),
                            gang=f"{pod.namespace}/{pod.group.name}",
                            victims=len(victims), slices=sorted(split),
                        )
                    self._note_decision(
                        pod.key(), "preemption_plan",
                        gang=f"{pod.namespace}/{pod.group.name}",
                        victims=len(victims), slices=sorted(split),
                        overshare_bias=sorted(overshare or {}),
                    )
                    self._emit_event(
                        "PreemptionPlanned",
                        f"gang/{pod.namespace}/{pod.group.name}",
                        f"{len(victims)} victim workload(s) planned for a "
                        f"DCN-split {total}-chip reservation "
                        f"(deferred to first bind)",
                    )
                    return self.gang.reserve_exact_split(
                        pod, count,
                        {sid: p.coords for sid, p in split.items()},
                        pending_victims=victims,
                    )
            raise GangError(
                f"gang {pod.namespace}/{pod.group.name}: no victim set opens "
                f"a contiguous {total}-chip slice at priority {pod.priority} "
                f"in any of {len(slice_ids)} ICI slices"
            )
        log.warning(
            "gang %s/%s plans to preempt %d workloads (priority sum %d) "
            "for a %d-chip slice in %s (deferred to first bind)",
            pod.namespace, pod.group.name,
            plan.victim_count, plan.cost_priority_sum, total, plan_slice,
        )
        if self.trace is not None:
            self.trace.span(
                "preemption_plan", pod.key(),
                gang=f"{pod.namespace}/{pod.group.name}",
                victims=plan.victim_count,
                cost_priority_sum=plan.cost_priority_sum,
                slices=[plan_slice],
            )
        self._note_decision(
            pod.key(), "preemption_plan",
            gang=f"{pod.namespace}/{pod.group.name}",
            victims=plan.victim_count,
            cost_priority_sum=plan.cost_priority_sum,
            slices=[plan_slice],
            overshare_bias=sorted(overshare or {}),
        )
        self._emit_event(
            "PreemptionPlanned",
            f"gang/{pod.namespace}/{pod.group.name}",
            f"{plan.victim_count} victim workload(s), priority sum "
            f"{plan.cost_priority_sum}, for a {total}-chip slice in "
            f"{plan_slice} (deferred to first bind)",
        )
        return self.gang.reserve_exact(
            pod, count, plan.coords, slice_id=plan_slice,
            pending_victims=plan.victims,
        )

    def _execute_pending_preemption(
        self, res: GangReservation, view: NodeView, device_ids: list[str]
    ) -> None:
        """Phase two of preemption, at the gang's first bind: the planned
        victims actually lose their chips. Runs under the decision lock
        (handle()), so exactly one member executes the plan.

        Evictions are irreversible, so they run only after this member's
        commit is certain to succeed: every minted id must be on a healthy
        chip and held by nobody — or by a declared victim about to be
        evicted. A failed pre-check raises WITHOUT touching the victims
        (the reservation stays pending; a sick slice is the sweep's job).

        Execution does NOT let this bind proceed: a 2xx Eviction only
        starts graceful termination, and on a single-owner TPU runtime a
        gang pod started while its victim's containers still hold the
        chips crash-loops for the whole grace period. The victims are
        registered as terminating (gating every member bind + masking
        their chips) and this bind fails retryably; binds resume once the
        eviction executor / lifecycle watch confirms the pod objects gone
        (the recorded ``victim_gone`` decision). kube-scheduler's own
        preemption waits for victim deletion the same way."""
        victims = self.gang.peek_pending_victims(res)
        if not victims:
            return
        victim_pods = self._victim_pod_keys(victims)
        holders = {
            did: a.pod_key
            for a in self.state.allocations()
            if a.node_name == view.info.name
            for did in a.device_ids
        }
        for did in device_ids:
            index, _ = parse_device_id(did)
            if view.chip(index).health is not Health.HEALTHY:
                raise ExtenderError(
                    f"{did}: chip unhealthy; preemption not executed "
                    "(reservation will be swept)"
                )
            holder = holders.get(did)
            if holder is not None and holder not in victim_pods:
                raise ExtenderError(
                    f"{did}: held by non-victim {holder}; preemption not "
                    "executed, scheduler will re-run the cycle"
                )
        victims = self.gang.take_pending_victims(res)
        evicted_pods, held = self._apply_victims(victims)
        self.preemptions += evicted_pods
        log.warning(
            "gang %s/%s executes deferred preemption at first bind: "
            "%d workload(s) / %d pod(s) evicted",
            res.namespace, res.group.name, len(victims), evicted_pods,
        )
        self._emit_event(
            "PreemptionExecuted",
            f"gang/{res.namespace}/{res.group.name}",
            f"{len(victims)} workload(s) / {evicted_pods} pod(s) evicted "
            f"at the gang's first bind",
        )
        if held:
            self.gang.register_terminating(res, held)
            raise ExtenderError(
                f"gang {res.namespace}/{res.group.name}: preemption "
                f"executed; waiting for {len(held)} victim pod(s) to "
                "finish terminating — scheduler will re-run the cycle"
            )

    def _victim_pod_keys(self, victims) -> set[str]:
        """Every pod a victim-workload list would evict: the workloads'
        own pods plus, for gang victims, their reservations' assigned
        members. One definition shared by the PDB precheck and the
        execution pre-validation — they must never test different sets."""
        victim_pods: set[str] = set()
        for w in victims:
            victim_pods.update(w.pod_keys)
            if w.gang_key is not None:
                vres = self.gang.reservation(*w.gang_key)
                if vres is not None:
                    victim_pods.update(vres.assigned)
        return victim_pods

    def _apply_victims(self, victims) -> tuple[int, dict]:
        """Evict a victim set: gangs dissolve wholesale (once, even when a
        DCN-spanning gang appears as several per-slice workloads), plain
        pods release + queue for eviction. Victims that vanished between
        plan and execution (released naturally) are skipped. Returns
        (pods evicted, evicted pod -> (slice, coords still physically
        held) — the termination gate's input)."""
        held: dict[str, tuple[str, list[TopologyCoord]]] = {}

        def note_held(pk: str) -> None:
            alloc = self.state.allocation(pk)
            if alloc is None:
                return
            sid = self.state.slice_of_node(alloc.node_name)
            if sid is not None:
                held[pk] = (sid, [TopologyCoord.of(c) for c in alloc.coords])

        evicted_pods = 0
        dissolved: set[tuple[str, str]] = set()

        def note_preempted(pk: str) -> None:
            # provenance: the victim's own chain must answer "where did my
            # chips go" — not just the preemptor's
            self._note_decision(pk, "preempted")

        for victim in victims:
            if victim.gang_key is not None:
                if victim.gang_key in dissolved:
                    continue
                dissolved.add(victim.gang_key)
                vres = self.gang.reservation(*victim.gang_key)
                if vres is not None:
                    for pk in list(vres.assigned):
                        note_held(pk)
                gone = self.gang.dissolve(victim.gang_key)
                evicted_pods += len(gone)
                for pk in gone:
                    note_preempted(pk)
            else:
                for pk in victim.pod_keys:
                    note_held(pk)
                    if self.state.release(pk) is not None:
                        self.pending_evictions.append(pk)
                        evicted_pods += 1
                        note_preempted(pk)
                        self._emit_event(
                            "VictimEvicted", f"pod/{pk}",
                            "released and queued for eviction "
                            "(preempted by a higher-priority gang)",
                        )
                    else:
                        held.pop(pk, None)  # vanished between plan and now
        return evicted_pods, held

    def _plan_split_preemption(
        self, workloads: list[policy.Workload], total: int,
        chips_per_pod: int, priority: int,
        overshare: Optional[dict[str, float]] = None,
    ) -> Optional[dict[str, policy.PreemptionPlan]]:
        """Preemption for a DCN-split gang: one cost-optimal box per slice
        (greedy over slices by free capacity, largest feasible volume
        first — the preemption mirror of GangManager._plan_dcn_split).
        Returns slice -> plan covering exactly ``total`` chips, or None."""
        snap = self.snapshots.current()
        order = sorted(
            snap.slice_ids(),
            key=lambda s: (snap.slice(s).utilization, s),
        )
        parts: dict[str, policy.PreemptionPlan] = {}
        remaining = total
        for sid in order:
            if remaining == 0:
                break
            ss = snap.slice(sid)
            mesh = ss.mesh
            in_slice = [w for w in workloads if w.slice_id == sid]
            # same blocked-set rule as the single-slice path: chips a
            # terminating victim still physically holds are unopenable
            unhealthy = ss.unhealthy | ss.terminating
            broken = ss.broken
            max_vol = min(
                remaining,
                ((mesh.num_chips - len(unhealthy)) // chips_per_pod)
                * chips_per_pod,
            )
            vol = max_vol
            while vol >= chips_per_pod:
                cand = policy.find_preemption_plan(
                    in_slice, mesh, unhealthy, vol, None, priority,
                    broken=broken, overshare=overshare,
                )
                if cand is not None:
                    parts[sid] = cand
                    remaining -= vol
                    break
                vol -= chips_per_pod
        return parts if remaining == 0 else None

    def _preemption_workloads(self) -> list[policy.Workload]:
        """Current workloads at preemption granularity: whole gangs (with
        their reserved-but-unassigned chips) and free-standing pods."""
        out: list[policy.Workload] = []
        gang_pods: set[str] = set()
        for res in self.gang.snapshot():
            members = sorted(res.assigned)
            gang_pods.update(members)
            prios = [self.state.priority_of(k) for k in members]
            # Blocking priority covers members NOT yet bound: the
            # reservation records its gang's priority, so a freshly
            # reserving prio-100 gang is never the cheap victim of a
            # prio-1 preemptor (priority inversion). Cost likewise counts
            # unarrived members at the reservation's priority.
            unarrived = max(0, res.group.min_member - len(members))
            priority = max([res.priority, *prios])
            cost = sum(prios) + res.priority * unarrived
            # one Workload per slice the gang touches (the planner works
            # slice-by-slice); evicting ANY part dissolves the whole gang,
            # so each part carries the gang's full eviction cost
            for sid, coords in res.slice_coords.items():
                chips = set(coords)
                for k in members:
                    entry = res.assigned.get(k)  # may race with on_release
                    if entry is not None and entry[0] == sid:
                        chips.update(entry[1])
                out.append(policy.Workload(
                    id=f"gang:{res.namespace}/{res.group.name}@{sid}",
                    priority=priority,
                    cost=cost,
                    coords=frozenset(chips),
                    pod_keys=tuple(members),
                    gang_key=res.key,
                    slice_id=sid,
                    tenant=(res.tenant or self.tenants.default
                            if self.tenants is not None else ""),
                ))
        for alloc in self.state.allocations():
            if alloc.pod_key in gang_pods:
                continue
            sid = self.state.slice_of_node(alloc.node_name)
            if sid is None:
                # node view gone (deleted mid-teardown): its chips are not
                # in any slice's occupied set either, so skipping keeps the
                # planner's view consistent — guessing a slice would plant
                # these coords in the wrong coordinate space
                continue
            prio = self.state.priority_of(alloc.pod_key)
            out.append(policy.Workload(
                id=alloc.pod_key,
                priority=prio,
                cost=prio,
                coords=frozenset(TopologyCoord.of(c) for c in alloc.coords),
                pod_keys=(alloc.pod_key,),
                slice_id=sid,
                tenant=(self.tenants.tenant_of_alloc(alloc)
                        if self.tenants is not None else ""),
            ))
        return out

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
        if self.drain is not None and self.state.is_cordoned(name):
            # draining: live allocs keep serving, new placements are
            # refused — capacity forensics root-causes demand stranded
            # this way as "draining", not "capacity"
            return "node cordoned (draining)"
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
                    return self._record_scores(pod, {
                        n: self.gang.score_from(counts, n)
                        for n in names
                    })
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
            return self._record_scores(pod, scores)
        finally:
            self._observe_latency("prioritize", time.monotonic() - t0)

    def _record_scores(self, pod: PodInfo,
                       scores: dict[str, int]) -> dict[str, int]:
        """Provenance for the scoring decision: the top-k nodes and their
        scores (the why-here data — which candidates the pick actually
        beat). Pass-through when provenance is off or the pod is
        unsampled."""
        dlog = self.decisions
        if dlog is not None and scores and dlog.wants(pod.key()):
            top = sorted(scores.items(),
                         key=lambda kv: (-kv[1], kv[0]))[:5]
            dlog.record(pod.key(), "prioritize", nodes=len(scores),
                        top=[[n, s] for n, s in top])
        return scores

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
                terminating = self.gang.terminating_victims_of(res)
                if terminating:
                    # preemption executed but victims still hold the chips:
                    # no member may start until their pod objects are gone
                    raise ExtenderError(
                        f"{key}: gang waiting for {len(terminating)} "
                        "preemption victim(s) to finish terminating; "
                        "scheduler will re-run the cycle"
                    )
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
            if res is not None:
                # two-phase preemption: the first member to bind executes
                # the eviction plan recorded at filter time — but only
                # after this member's commit is pre-validated, so a bind
                # that would fail anyway (chip went unhealthy, chip taken
                # by a non-victim) never costs the victims their chips
                self._execute_pending_preemption(res, view, device_ids)
            env: dict[str, str] = {}
            if self.tenants is not None:
                # tenant attribution rides the alloc annotation so the
                # TenantLedger (and a restarted extender's rebuild)
                # charge the right owner
                env[ENV_KUBE_TENANT] = self.tenants.tenant_of(pod)
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
                if self.binder is not None:
                    # _handle_bind's effector undo needs to know whether
                    # THIS bind committed the gang (keyed, since other
                    # binds may interleave once the decision lock drops)
                    self._bind_gang_info[key] = (res, committed_now)
            with self._pending_lock:
                self._pending.pop(key, None)
            self.binds_total += 1
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

    # -- batch-driver hooks (sched/cycle.py; sim driver + pod informer) -----
    def admit(self, pod: PodInfo) -> bool:
        """Admit a pending pod into the scheduling queue ahead of its
        /filter webhook (pod-informer feed / sim batch driver). No-op
        without batching — the webhook path needs no pre-admission.
        Returns True when the pod actually entered the queue (False:
        batching off, tenancy refusal, or a live plan already exists —
        informer re-deliveries must not replan an assumed allocation).

        With the tenancy plane on, the admission gate runs HERE too —
        at enqueue time, against pre-drain usage — so a shed burst
        never even enters the queue (the plan-time gate inside the
        planning arms stays authoritative for quota races within a
        drain)."""
        if self.cycle is None:
            return False
        with self._decision_lock:
            if self.cycle.plan_is_live(pod):
                # informer re-delivery of an already-planned pod: no
                # re-enqueue, and — checked FIRST — no tenancy gate
                # run, which would journal a phantom refusal against a
                # pod whose own assumed usage already fills its quota
                return False
            if self.tenants is not None:
                try:
                    ask = self.device_request(pod)
                except ExtenderError:
                    ask = None  # planning reports the schema error
                if ask is not None and self.tenants.admit(
                    pod, ask[0], ask[1]
                ) is not None:
                    # refused and journaled, not enqueued — but the pod
                    # IS pending (the feed retries), so the starvation
                    # stats must see its first-admit stamp
                    self.cycle.note_pending(pod.key())
                    return False
            self.cycle.enqueue(pod)
            self._note_decision(pod.key(), "admit",
                                queue_depth=self.cycle.queue_depth())
            return True

    def plan_pending(self) -> int:
        """Drive batch cycles until the admitted queue drains; returns
        pods planned. The sim batch driver's entry point — webhook
        arrivals plan through handle('filter') instead."""
        if self.cycle is None:
            return 0
        with self._decision_lock:
            return self.cycle.run_pending()

    def planned_node(self, pod_key: str) -> Optional[str]:
        """The batch plan's predicted node for a pod (None = no live
        plan / plan found the pod unschedulable). Drivers use it to
        issue the /bind the plan anticipates."""
        if self.cycle is None:
            return None
        with self._decision_lock:
            return self.cycle.planned_node(pod_key)

    # -- pod lifecycle ------------------------------------------------------
    def release(self, pod_key: str) -> None:
        self.handle("release", {"pod_key": pod_key})

    def release_many(self, pod_keys: list[str]) -> None:
        """Batched releases (the lifecycle resync's flush surface — the
        ShardRouter fans these out per replica; here each is the same
        recorded release decision the per-key path dispatches)."""
        for key in pod_keys:
            self.handle("release", {"pod_key": key})

    def upsert_nodes_many(self, items: list[dict[str, Any]]) -> list[Any]:
        """Batched node ingest: one ``upsert_nodes`` decision for the
        whole batch (the bulk cold-start path when
        ``bulk_ingest_enabled``), per-item results positionally."""
        return self.handle("upsert_nodes", {"items": list(items)})[
            "results"]

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
        if kind == "bind":
            return self._handle_bind(body)
        if kind == "filter":
            reason = self._degraded_reason()
            if reason is not None:
                # fail safe BEFORE any mutation or trace record (the
                # schema-error contract): no reservation is created, no
                # preemption planned, and the refusal replays as nothing
                # because it changed nothing
                pod, nodes, names = kube.parse_extender_args(body)
                mk = (kube.filter_result if nodes is not None
                      else kube.filter_result_names)
                self._emit_event(
                    "DegradedMode", "extender/filter",
                    f"failing filter requests safe: {reason}",
                )
                self._note_decision(
                    pod.key(), "refusal", kind="degraded",
                    reason=f"degraded mode: {reason}",
                )
                return mk([], {}, error=f"degraded mode: {reason}")
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
                # per-tenant admission latency: the whole filter
                # decision's wall, charged to the pod's tenant — the
                # tpukube_tenant_admission_seconds histogram the
                # per-tenant burn monitor slides its windows over
                tt0 = (time.monotonic() if self.tenants is not None
                       else None)
                try:
                    if self.cycle is not None:
                        # batch mode: admit + plan (one snapshot per
                        # cycle), answer from the plan
                        t0 = time.monotonic()
                        try:
                            response: Any = self.cycle.filter_response(
                                pod, nodes, names
                            )
                        finally:
                            self._observe_latency(
                                "filter", time.monotonic() - t0
                            )
                    else:
                        feasible, failed = self.filter(
                            pod, raw_nodes=nodes, node_names=names
                        )
                        response = mk(feasible, failed)
                except (ExtenderError, GangError, StateError,
                        codec.CodecError) as e:
                    response = mk([], {}, error=str(e))
                    self._note_decision(pod.key(), "refusal",
                                        kind="filter_error",
                                        reason=str(e))
                    if self.capacity is not None:
                        # stranded-demand forensics: root-cause the
                        # per-pod path's refusal (fragmented / capacity
                        # / quota / shed / unhealthy / dcn-ineligible /
                        # draining)
                        self.capacity.note_refusal(pod, str(e))
                if self.tenants is not None and tt0 is not None:
                    self.tenants.observe_admission(
                        self.tenants.tenant_of(pod),
                        time.monotonic() - tt0,
                    )
            elif kind == "prioritize":
                pod, nodes, names = kube.parse_extender_args(body)
                if nodes is None and names is None:
                    names = self.state.node_names()  # NodesCached body
                scores = None
                if self.cycle is not None:
                    if nodes is not None:
                        names = self._ingest_nodes(nodes)
                        nodes = None
                    t0 = time.monotonic()
                    scores = self.cycle.prioritize_response(
                        pod, list(names or [])
                    )
                    if scores is not None:
                        self._observe_latency(
                            "prioritize", time.monotonic() - t0
                        )
                if scores is None:
                    try:
                        scores = self.prioritize(
                            pod, raw_nodes=nodes, node_names=names
                        )
                    except (ExtenderError, GangError, StateError,
                            codec.CodecError) as e:
                        log.warning("prioritize failed: %s", e)
                        scores = {}
                response = kube.host_priority_list(scores)
            elif kind == "release":
                pod_key = body["pod_key"]
                self.state.release(pod_key)
                self.gang.on_release(pod_key)
                if self.cycle is not None:
                    self.cycle.on_release(pod_key)
                with self._pending_lock:
                    self._pending.pop(pod_key, None)
                self._note_decision(pod_key, "release")
                response = None
            elif kind == "victim_gone":
                # an evicted pod's object is confirmed gone: unmask its
                # chips. A recorded decision, so the mask changes only
                # through the trace.
                response = {
                    "cleared": self.gang.on_victim_gone(body["pod_key"])
                }
            elif kind == "reconcile":
                response = {
                    "changed": self._reconcile_devices(
                        body["pod_key"], list(body["devices"])
                    )
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
                    # drain the deferred decodes off the serving path
                    self.state.maybe_start_warmer()
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
            if self.journal is not None:
                self._maybe_checkpoint()
            if self.capacity is not None:
                # amortized flight-recorder hook (the checkpoint seam's
                # pattern): a scheduling-clock read per decision, a real
                # sample only on interval expiry
                self.capacity.maybe_sample()
            if self.drain is not None:
                # amortized drain choreography: budgeted migrate-or-
                # preempt progress rides the decision path under the
                # same lock (a clock read when no drain is active)
                self.drain.maybe_tick()
            if self.autoscaler is not None:
                self.autoscaler.maybe_tick()
            return response

    def checkpoint_doc(self) -> dict:
        """The full Checkpoint capture (ledger + gang reservations +
        the cached scheduling snapshot + the WAL position they cover).
        Callers hold the decision lock — or run before serving
        (recovery) — so the capture is atomic with respect to every
        mutation path; the build is in-memory only (node lines
        memoized per payload; still-lazy nodes captured as byte refs
        into the previous checkpoint file), serialization and disk
        belong to the journal's drain thread."""
        if self.journal is None:
            raise RuntimeError(
                "checkpoint capture requires the journal "
                "(journal_enabled)")
        state_head, node_entries = self.state.checkpoint_doc(
            self._ckpt_cache
        )
        head = {
            "v": 2,
            "ts": time.time(),
            "wal_seq": self.journal.seq(),
            "state": state_head,
            "gang": self.gang.checkpoint_doc(),
        }
        snap = self.snapshots.peek()
        if snap is not None:
            # the seedable scheduling snapshot: a warm restart installs
            # it directly, so the first lookups HIT instead of forcing
            # the O(chips) rebuild that would drag every lazy node in
            snap_doc: dict[str, dict] = {}
            for sid, ss in snap.slices.items():
                sd = {
                    "occ": [list(c) for c in ss.occupied],
                    "res": [list(c) for c in ss.reserved],
                    "unh": [list(c) for c in ss.unhealthy],
                    "term": [list(c) for c in ss.terminating],
                    "brk": [[list(a), list(b)] for a, b in ss.broken],
                    "used": ss.used_shares,
                    "total": ss.total_shares,
                }
                if ss.cordoned:
                    # only when non-empty: with the drain flag off the
                    # checkpoint bytes stay identical
                    sd["crd"] = [list(c) for c in ss.cordoned]
                snap_doc[sid] = sd
            head["snap"] = snap_doc
        return {
            "head": head,
            "node_entries": node_entries,
            "old_fd": self.state.lazy_fd_dup(),
        }

    def _maybe_checkpoint(self) -> None:
        """Periodic checkpoint capture, amortized onto the decision
        path (a time check per decision; the capture itself runs at
        checkpoint_interval cadence or after a WAL rotation)."""
        if not self.journal.checkpoint_due(self.clock.monotonic()):
            return
        self.journal.request_checkpoint(self.checkpoint_doc())

    def _handle_bind(self, body: Any) -> Any:
        """The bind decision, split around the external effector: the PDB
        precheck of a pending preemption plan runs first, OUTSIDE the
        decision lock (it may ask the apiserver); the ledger mutation and
        its trace record run under the lock as one step; the binder's
        apiserver I/O (annotation PATCH + Binding POST) runs OUTSIDE it
        again, so one apiserver hiccup cannot stall every concurrent
        filter/prioritize. A failed effector undoes through a regular
        recorded ``release`` decision — the trace then replays as (bind
        ok, release), which IS the ledger's true history; only the wire
        response reports the failure to the scheduler for a retry."""
        name, ns, uid, node = kube.parse_binding_args(body)
        key = f"{ns}/{name}"
        bt0 = time.monotonic()
        degraded = self._degraded_reason()
        if degraded is not None:
            # the filter's fail-safe contract: refused before any
            # mutation, nothing recorded; a bind the effector could not
            # deliver must not touch the ledger or run a preemption plan
            self._emit_event(
                "DegradedMode", "extender/bind",
                f"failing bind requests safe: {degraded}",
            )
            self._note_decision(key, "refusal", kind="degraded",
                                reason=f"degraded mode: {degraded}")
            return kube.binding_result(f"{key}: degraded mode: {degraded}")
        blocked = self._precheck_preemption(key)
        if blocked:
            # refused BEFORE any mutation, so nothing is recorded in the
            # trace (same contract as schema errors): the plan stays
            # pending and the reservation TTLs out if the PDB never lifts
            # — no victim is half-evicted, no gang half-binds. The refusal
            # still lands in the provenance chain: a pod stuck behind a
            # PDB is exactly the incident `explain` must answer.
            reason = (
                f"{key}: preemption plan refused — PodDisruptionBudget "
                f"blocks eviction of {sorted(blocked)[:3]}"
            )
            self._note_decision(key, "refusal", kind="pdb_precheck",
                                reason=reason)
            return kube.binding_result(reason)
        alloc = None
        gang_info = None
        with self._decision_lock:
            planned = None
            if self.cycle is not None:
                # batch mode: consume the plan's assumed allocation (or
                # its planned error) instead of re-planning; a miss —
                # no plan, deferred preemption, node disagreement —
                # falls through to the per-pod bind below
                t0 = time.monotonic()
                planned = self.cycle.take_for_bind(key, uid, node)
                if planned is not None:
                    self._observe_latency("bind", time.monotonic() - t0)
                    if self.phase_hist is not None:
                        # commit phase: consuming the plan's assumed
                        # allocation (or its planned error) at /bind
                        self.phase_hist.labels(phase="commit").observe(
                            time.monotonic() - t0
                        )
            try:
                if planned is not None:
                    verdict, payload = planned
                    if verdict == "ok":
                        alloc = payload
                        gang_info = self._bind_gang_info.pop(key, None)
                        response: Any = kube.binding_result()
                        response["Annotations"] = {
                            codec.ANNO_ALLOC: codec.encode_alloc(alloc)
                        }
                    else:
                        response = kube.binding_result(payload)
                else:
                    alloc = self.bind(name, ns, uid, node)
                    # consume THIS bind's gang marker under the same
                    # lock; a FAILED bind must not pop (the key may
                    # belong to another in-flight bind's pending
                    # effector)
                    gang_info = self._bind_gang_info.pop(key, None)
                    # the alloc annotation rides back to the
                    # harness/apiserver-writer
                    response = kube.binding_result()
                    response["Annotations"] = {
                        codec.ANNO_ALLOC: codec.encode_alloc(alloc)
                    }
            except (ExtenderError, GangError, StateError,
                    codec.CodecError) as e:
                # an errored response must NEVER run the effector, even
                # when bind() itself succeeded and a later step threw —
                # the scheduler will retry a bind we told it failed
                alloc = None
                response = kube.binding_result(str(e))
            if alloc is not None and self.cycle is not None:
                # the pod bound (plan-served OR per-pod fallback):
                # retire its first-admit stamp
                self.cycle.on_bound(key)
            if self.decisions is not None and self.decisions.wants(key):
                err = (response.get("Error")
                       if isinstance(response, dict) else None)
                self.decisions.record(
                    key, "bind", node=node, ok=not err,
                    error=err or None,
                    served_from=("plan" if planned is not None
                                 else "legacy"),
                )
            if self.trace is not None:
                self.trace.record("bind", body, response)
            if self.journal is not None:
                self._maybe_checkpoint()
        if self.tenants is not None and alloc is not None:
            # per-tenant commit latency: the whole successful bind
            # decision's wall, charged to the allocation's tenant
            self.tenants.observe_commit(
                self.tenants.tenant_of_alloc(alloc),
                time.monotonic() - bt0,
            )
        if alloc is None or self.binder is None:
            return response
        try:
            self.binder(alloc)
        except Exception as e:
            # the Binding POST/annotation PATCH failed: the pod is NOT
            # bound on the cluster (annotation-first ordering guarantees
            # partial failures leave it Pending), so the ledger must not
            # claim it is. Preemption evictions already executed stand:
            # the victims were released either way.
            log.error("bind effector for %s failed: %s", key, e)
            self._emit_event(
                "BindFailed", f"pod/{key}",
                f"apiserver bind failed after a successful ledger "
                f"commit; undone for retry: {e}",
            )
            with self._decision_lock:
                # undo atomically w.r.t. other binds (which also hold the
                # decision lock): a sibling member interleaving between
                # the uncommit and the release could otherwise re-commit
                # a quorum that counts this phantom member
                if gang_info is not None and gang_info[1]:
                    # this very bind committed the gang: the quorum never
                    # truly assembled — revert flag + latency sample
                    self.gang.undo_commit(gang_info[0])
                self.handle("release", {"pod_key": key})
                self.binds_total -= 1  # the bind did not survive
                # the earlier bind record said ok=True (the ledger commit
                # succeeded); the pod is NOT bound on the cluster — without
                # this stage its explain would read "bound ... released"
                # for a pod Pending on retry
                self._note_decision(
                    key, "bind", node=node, ok=False,
                    error=f"apiserver bind failed: {e}",
                    served_from="effector",
                )
            return kube.binding_result(f"{key}: apiserver bind failed: {e}")
        return response

    def _precheck_preemption(self, pod_key: str) -> list[str]:
        """PDB dry-run for the eviction plan a bind for ``pod_key`` would
        execute: the victim pod keys a PodDisruptionBudget blocks right
        now ([] = proceed). No precheck wired (or an errored dry-run)
        means proceed — the executor's forever-retry then covers the
        raced case."""
        if self.evict_precheck is None:
            return []
        with self._pending_lock:
            entry = self._pending.get(pod_key)
        if entry is None or entry[0].group is None:
            return []
        pod = entry[0]
        res = self.gang.reservation(pod.namespace, pod.group.name)
        if res is None:
            return []
        try:
            ask = self.device_request(pod)
        except ExtenderError:
            return []  # bind() will surface the real error
        # mirror bind()'s routing: an overflow replica of a full gang
        # binds as a normal pod and executes no preemption — its bind
        # must not be refused for a PDB that only blocks the gang's plan
        if ask is None or not self.gang.assignable(res, ask[1]):
            return []
        victim_pods = self._victim_pod_keys(
            self.gang.peek_pending_victims(res)
        )
        blocked = []
        for vk in victim_pods:
            try:
                if self.evict_precheck(vk) is False:
                    blocked.append(vk)
            except Exception as e:
                # cannot determine (old apiserver, transient error):
                # proceed — refusing would wedge preemption on noise
                log.warning("eviction precheck for %s failed: %s", vk, e)
        return blocked

    def _reconcile_devices(self, pod_key: str, device_ids: list[str]) -> bool:
        """Fold the kubelet's ACTUAL device choice into the ledger when it
        diverged from the plan (reported through the pod's ``alloc-actual``
        annotation — apiserver.AllocReconcileLoop drives this as a recorded
        ``reconcile`` decision). The container is already running on those
        chips, so reality wins: the planned allocation is released, the
        actual one committed, and gang bookkeeping follows. Returns True if
        the ledger changed."""
        alloc = self.state.allocation(pod_key)
        if alloc is None:
            log.warning("reconcile for %s: no allocation in ledger", pod_key)
            return False
        if sorted(alloc.device_ids) == sorted(device_ids):
            return False
        view = self.state.node(alloc.node_name)
        if view is None:
            log.warning("reconcile for %s: node %s unknown",
                        pod_key, alloc.node_name)
            return False
        try:
            coords = sorted({
                view.chip(parse_device_id(did)[0]).coord
                for did in device_ids
            })
        except (ValueError, KeyError) as e:
            log.warning("reconcile for %s: bad actual ids %s: %s",
                        pod_key, device_ids, e)
            return False
        # A report naming chips the ledger shows held by ANOTHER pod is
        # wrong (stale, or a misattributed divergence after an agent
        # restart) — refuse rather than evict a running pod's entry.
        held_by_others = [
            did for did in device_ids
            if did in view.used_ids and did not in alloc.device_ids
        ]
        if held_by_others:
            log.warning(
                "reconcile for %s refused: %s already held by other pods",
                pod_key, held_by_others,
            )
            return False
        self.state.release(pod_key)
        actual = AllocResult(
            pod_key=pod_key,
            node_name=alloc.node_name,
            device_ids=sorted(device_ids),
            coords=coords,
            env=alloc.env,
            priority=alloc.priority,
            uid=alloc.uid,
        )
        try:
            self.state.commit(actual)
        except StateError:
            # never leave the pod ledger-less: restore the planned entry
            self.state.commit(alloc)
            log.warning("reconcile for %s: commit of %s failed; restored "
                        "planned allocation", pod_key, sorted(device_ids))
            return False
        self.gang.reassign(pod_key, coords)
        log.warning(
            "reconciled %s on %s: kubelet allocated %s (planned %s)",
            pod_key, alloc.node_name, sorted(device_ids),
            sorted(alloc.device_ids),
        )
        return True

    # -- inspection (ctl and the /state routes) ------------------------------
    def topology_snapshot(self) -> dict[str, Any]:
        """Cluster topology and occupancy as plain JSON (``ctl topo``).
        Per-slice sections carry the slice-local coord sets; the
        top-level fields aggregate across slices (mesh_dims is the sole
        slice's dims on a single-slice cluster, null otherwise)."""
        snap = self.snapshots.current()
        slice_ids = snap.slice_ids()
        per_slice: dict[str, dict[str, Any]] = {}
        for sid in slice_ids:
            ss = snap.slice(sid)
            per_slice[sid] = {
                "occupied": ss.occupied,
                "reserved": ss.reserved,
                "unhealthy": ss.unhealthy,
                "broken": sorted(ss.broken),
            }
        nodes = []
        for name in self.state.node_names():
            view = self.state.node(name)
            if view is None:
                continue
            s = per_slice[view.info.slice_id]
            chips = []
            for chip in view.info.chips:
                status = (
                    "unhealthy" if chip.coord in s["unhealthy"]
                    else "allocated" if chip.coord in s["occupied"]
                    else "reserved" if chip.coord in s["reserved"]
                    else "free"
                )
                chips.append({
                    "index": chip.index,
                    "coord": list(chip.coord),
                    "status": status,
                    "used_shares": view.used_share_count(chip.index),
                    "shares": view.shares_per_chip,
                })
            nodes.append({
                "name": name, "slice": view.info.slice_id, "chips": chips,
                # table-fallback nodes (static memory/SM guesses) show
                # at a glance in ``ctl topo``
                "source": view.info.source,
            })
        return {
            "mesh_dims": (
                list(snap.slice(slice_ids[0]).mesh.dims)
                if len(slice_ids) == 1 else None
            ),
            "utilization_percent": round(100.0 * self.state.utilization(), 2),
            "chips_total": sum(len(n["chips"]) for n in nodes),
            "chips_allocated": sum(len(s["occupied"])
                                   for s in per_slice.values()),
            "chips_reserved_unbound": sum(
                len(s["reserved"] - s["occupied"]) for s in per_slice.values()
            ),
            "chips_unhealthy": sum(
                len(s["unhealthy"]) for s in per_slice.values()
            ),
            "links_down": [
                [list(a), list(b)]
                for s in per_slice.values() for a, b in s["broken"]
            ],
            "slices": [
                {
                    "id": sid,
                    "mesh_dims": list(snap.slice(sid).mesh.dims),
                    "utilization_percent": round(
                        100.0 * snap.slice(sid).utilization, 2
                    ),
                    # how shattered the slice's free space is, and the
                    # biggest gang box it could still take
                    "fragmentation": round(
                        snap.slice(sid).fragmentation(), 4
                    ),
                    "largest_free_box_chips": snap.slice(
                        sid).largest_free_box(),
                    "links_down": [
                        [list(a), list(b)] for a, b in per_slice[sid]["broken"]
                    ],
                }
                for sid in slice_ids
            ],
            "nodes": nodes,
        }

    def alloc_snapshot(self) -> list[dict[str, Any]]:
        """Committed allocations as plain JSON (``ctl alloc``)."""
        return [
            {
                "pod": a.pod_key,
                "node": a.node_name,
                "devices": list(a.device_ids),
                "coords": [list(c) for c in a.coords],
                "priority": a.priority,
            }
            for a in sorted(self.state.allocations(), key=lambda a: a.pod_key)
        ]

    def gang_snapshot(self) -> list[dict[str, Any]]:
        """Live gang reservations as plain JSON (``ctl gangs``)."""
        out = []
        for res in self.gang.snapshot():
            out.append({
                "namespace": res.namespace,
                "group": res.group.name,
                "min_member": res.group.min_member,
                "members_bound": len(res.assigned),
                "committed": res.committed,
                "priority": res.priority,
                "spans_dcn": res.spans_dcn,
                # why an assembling gang is not binding: victims planned
                # (preemption not yet executed) or still terminating —
                # both through the manager's locked accessors
                "victims_pending": len(
                    self.gang.peek_pending_victims(res)
                ),
                "victims_terminating": len(
                    self.gang.terminating_victims_of(res)
                ),
                "slices": {
                    sid: [list(c) for c in sorted(coords)]
                    for sid, coords in sorted(res.slice_coords.items())
                },
            })
        return sorted(out, key=lambda g: (g["namespace"], g["group"]))

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


# -- HTTP application (standard library) -------------------------------------

_ROUTES = {"/filter": "filter", "/prioritize": "prioritize", "/bind": "bind"}
_PROBE_ROUTES = ("/healthz", "/metrics")
_GET_ROUTES = _PROBE_ROUTES + (
    "/state/topology", "/state/allocs", "/state/gangs", "/trace", "/events",
    "/explain", "/capacity", "/capacity/probe", "/statusz")
_CAPACITY_OFF = "capacity analytics disabled (set capacity_enabled)"


class App:
    """The extender's HTTP application: its routes and what they read.

    ``reconcile``/``evictions``/``node_refresh``/``lifecycle`` are the
    daemon's loops, exported on /metrics when present; ``informer`` is
    the shared PodInformer whose stream liveness /statusz reports (the
    lifecycle loop stands in when the loops run standalone).

    ``auth_token`` gates every route except /healthz and /metrics behind
    ``Authorization: Bearer <token>``: /bind mutates the ledger and runs
    preemption, /state, /trace, /events and /statusz disclose placement.
    /healthz (kubelet probes) and /metrics (Prometheus) stay open; both
    are read-only and disclose nothing. TLS is the transport's job
    (:func:`run_server`'s ``ssl_context``); the token also guards plain
    HTTP setups and backs TLS up. A probe app (``probe_only``) serves
    /healthz and /metrics and nothing else."""

    def __init__(self, extender: Extender, reconcile=None, evictions=None,
                 node_refresh=None, lifecycle=None,
                 auth_token: Optional[str] = None, informer=None,
                 probe_only: bool = False) -> None:
        self.extender = extender
        self.reconcile = reconcile
        self.evictions = evictions
        self.node_refresh = node_refresh
        self.lifecycle = lifecycle
        self.informer = informer
        self.probe_only = probe_only
        self._expected = (f"Bearer {auth_token}".encode()
                          if auth_token else None)

    def authorized(self, path: str, header: Optional[str]) -> bool:
        if self._expected is None or path in _PROBE_ROUTES:
            return True
        # constant-time compare on BYTES: the str overload raises on
        # non-ASCII input, and a crafted header must get a 401, not a 500
        got = (header or "").encode("utf-8", "surrogateescape")
        return hmac.compare_digest(got, self._expected)

    def get(self, path: str, query: dict[str, str]) -> tuple[int, Any]:
        """(status, JSON-able body, or str for text/plain) of a GET."""
        ext = self.extender
        if self.probe_only and path not in _PROBE_ROUTES:
            return 404, "not found"
        if path == "/healthz":
            return 200, {"ok": True, "nodes": list(ext.state.node_names())}
        if path == "/metrics":
            from tpukube_torch.metrics import render_extender_metrics

            return 200, render_extender_metrics(
                ext, reconcile=self.reconcile, evictions=self.evictions,
                node_refresh=self.node_refresh, lifecycle=self.lifecycle)
        if path == "/state/topology":
            return 200, ext.topology_snapshot()
        if path == "/state/allocs":
            return 200, ext.alloc_snapshot()
        if path == "/state/gangs":
            return 200, ext.gang_snapshot()
        if path == "/trace":
            if ext.trace is None:
                return 404, "tracing disabled (set trace_capacity)"
            try:
                since = int(query.get("since", 0))
            except ValueError:
                return 400, "since must be an integer"
            return 200, ext.trace.events(since_seq=since)
        if path == "/events":
            since: Optional[float] = None
            if query.get("since"):
                try:
                    since = float(query["since"])
                except ValueError:
                    return 400, "since must be a unix ts"
            return 200, ext.events.events(
                reason=query.get("reason") or None,
                pod=query.get("pod") or None,
                node=query.get("node") or None,
                since=since,
            )
        if path == "/explain":
            # behind the bearer gate: provenance discloses placement,
            # candidate sets and tenant shares
            if ext.decisions is None:
                return 404, ("decision provenance disabled "
                             "(set decisions_enabled)")
            pod = query.get("pod", "")
            if not pod:
                return 400, ("pod query parameter required "
                             "(namespace/name)")
            if "/" not in pod:
                pod = f"default/{pod}"
            return 200, ext.decisions.explain(pod)
        if path == "/capacity":
            # samples disclose utilization, tenant shares and the
            # stranded-demand ledger: behind the bearer gate
            if ext.capacity is None:
                return 404, _CAPACITY_OFF
            from tpukube_torch.obs.capacity import parse_since

            since = None
            if query.get("since"):
                try:
                    since = parse_since(query["since"])
                except ValueError:
                    return 400, "since must be a unix ts or duration (15m, 2h)"
            if since is not None and since < 1e9:
                # relative window: anchored to the newest sample's wall
                # ts (the events/CLI relative-since semantics)
                newest = max((float(s.get("ts", 0.0))
                              for s in ext.capacity.samples()), default=0.0)
                since = newest - since
            return 200, ext.capacity.capacity_doc(since)
        if path == "/capacity/probe":
            # read-only what-if fit dry-run against the observer snapshot
            if ext.capacity is None:
                return 404, _CAPACITY_OFF
            from tpukube_torch.obs.capacity import parse_shape

            count = shape = None
            try:
                if query.get("shape"):
                    shape = parse_shape(query["shape"])
                elif query.get("count"):
                    count = int(query["count"])
                else:
                    raise ValueError("want shape=XxYxZ or count=N")
                cpp = int(query.get("cpp", 1))
                return 200, ext.capacity.probe(count=count, shape=shape,
                                               chips_per_pod=cpp)
            except ValueError as e:
                return 400, str(e)
        if path == "/statusz":
            from tpukube_torch.obs.statusz import extender_statusz

            return 200, extender_statusz(
                ext, evictions=self.evictions, informer=self.informer,
                node_refresh=self.node_refresh, lifecycle=self.lifecycle,
                reconcile=self.reconcile)
        return 404, "not found"


def make_app(extender: Extender, reconcile=None, evictions=None,
             node_refresh=None, lifecycle=None,
             auth_token: Optional[str] = None, informer=None) -> App:
    """The extender's whole HTTP surface (see :class:`App`)."""
    return App(extender, reconcile=reconcile, evictions=evictions,
               node_refresh=node_refresh, lifecycle=lifecycle,
               auth_token=auth_token, informer=informer)


def make_probe_app(extender: Extender, reconcile=None, evictions=None,
                   node_refresh=None, lifecycle=None) -> App:
    """/healthz and /metrics ONLY: the mTLS deployment's second listener.

    With a client CA the main port refuses every peer without a CA-signed
    client certificate at the handshake, and kubelet's httpGet probes and
    Prometheus scrapes cannot present one. This app serves the two
    read-only routes over the separate ``--probe-port`` while /bind,
    /state and /trace stay behind mTLS."""
    return App(extender, reconcile=reconcile, evictions=evictions,
               node_refresh=node_refresh, lifecycle=lifecycle,
               probe_only=True)


class _Handler(BaseHTTPRequestHandler):
    """One connection's requests against ``server.app``, with the bodies
    of the reference's aiohttp app: a body that is not JSON, or a schema
    error, is HTTP 400 and records nothing."""

    protocol_version = "HTTP/1.1"  # keep-alive, as kube-scheduler uses
    # headers and body go out in two writes: with Nagle on, the body
    # waits for the peer's delayed ACK (~40 ms a response over TLS)
    disable_nagle_algorithm = True

    def _reply(self, status: int, payload: bytes,
               content_type: str = "application/json",
               headers: Optional[dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _text(self, status: int, text: str, **kw: Any) -> None:
        self._reply(status, text.encode(), "text/plain; charset=utf-8", **kw)

    def _route(self) -> Optional[tuple[str, dict[str, str]]]:
        """(path, query) once the request is authorized; None after the
        401 went out."""
        parts = urlsplit(self.path)
        if not self.server.app.authorized(
                parts.path, self.headers.get("Authorization")):
            self._text(401, "missing or invalid bearer token",
                       headers={"WWW-Authenticate": "Bearer"})
            return None
        return parts.path, dict(parse_qsl(parts.query))

    def do_POST(self) -> None:  # noqa: N802 (http.server's name)
        raw = self.rfile.read(int(self.headers.get("Content-Length") or 0))
        routed = self._route()
        if routed is None:
            return
        path, _ = routed
        app = self.server.app
        kind = None if app.probe_only else _ROUTES.get(path)
        if kind is None:
            if not app.probe_only and path in _GET_ROUTES:
                self._text(405, "method not allowed")
            else:
                self._text(404, "not found")
            return
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            self._text(400, f"bad JSON: {e}")
            return
        try:
            response = app.extender.handle(kind, body)
        except kube.KubeSchemaError as e:
            self._text(400, str(e))
            return
        self._reply(200, json.dumps(response).encode())

    def do_GET(self) -> None:  # noqa: N802
        routed = self._route()
        if routed is None:
            return
        path, query = routed
        app = self.server.app
        if path in _ROUTES and not app.probe_only:
            self._text(405, "method not allowed")
            return
        status, body = app.get(path, query)
        if path == "/metrics" and status == 200:
            self._reply(200, body.encode(), "text/plain; version=0.0.4")
        elif isinstance(body, str):
            self._text(status, body)
        else:
            self._reply(status, json.dumps(body).encode())

    def log_message(self, format: str, *args: Any) -> None:
        log.debug("%s %s", self.address_string(), format % args)


class Server(ThreadingHTTPServer):
    """``http.server`` for the extender's app, one thread per connection.

    With ``ssl_context`` each connection's TLS handshake runs in its own
    thread, under ``HANDSHAKE_TIMEOUT_S``, never in ``accept()``: a
    client that stalls in its handshake holds only its own thread. A
    peer the context refuses (no client certificate where one is
    required, a certificate of another CA) fails its handshake, is
    logged at INFO without a traceback, and the server goes on serving."""

    daemon_threads = True
    HANDSHAKE_TIMEOUT_S = 10.0
    handler_class = _Handler

    def __init__(self, address: tuple[str, int], app: App,
                 ssl_context: Optional[ssl.SSLContext] = None) -> None:
        self.app = app
        self.ssl_context = ssl_context
        super().__init__(address, self.handler_class)

    def finish_request(self, request, client_address) -> None:
        if self.ssl_context is None:
            super().finish_request(request, client_address)
            return
        request.settimeout(self.HANDSHAKE_TIMEOUT_S)
        try:
            conn = self.ssl_context.wrap_socket(
                request, server_side=True, do_handshake_on_connect=False)
        except OSError as e:
            log.info("TLS from %s refused: %s", client_address[0], e)
            return
        try:
            try:
                conn.do_handshake()
            except OSError as e:  # ssl.SSLError, a reset, a timeout
                log.info("TLS handshake from %s refused: %s",
                         client_address[0], e)
                return
            conn.settimeout(None)
            self.RequestHandlerClass(conn, client_address, self)
        finally:
            self.shutdown_request(conn)

    def handle_error(self, request, client_address) -> None:
        # a peer that drops its connection is not the server's error
        err = sys.exc_info()[1]
        if isinstance(err, OSError):
            log.debug("connection from %s: %s", client_address[0], err)
            return
        super().handle_error(request, client_address)


def run_server(app: App, host: str = "127.0.0.1", port: int = 0,
               ssl_context: Optional[ssl.SSLContext] = None) -> Server:
    """Serve ``app`` on ``host:port`` (0 = a free port; read it from
    ``server.server_address``) from a daemon thread, over TLS when
    ``ssl_context`` is given. Stop with ``server.shutdown();
    server.server_close()`` from another thread than the serving one."""
    server = Server((host, port), app, ssl_context=ssl_context)
    # a short poll interval: shutdown() waits out one poll
    threading.Thread(target=server.serve_forever, args=(0.05,), daemon=True,
                     name="tpukube-extender-http").start()
    return server


def run_probe_server(app: App, host: str, port: int):
    """Serve a probe app (:func:`make_probe_app`) over plain HTTP from a
    daemon thread; returns its stop() callable."""
    server = run_server(app, host, port)

    def stop() -> None:
        server.shutdown()
        server.server_close()

    return stop


def serve(extender: Extender, host: str = "127.0.0.1", port: int = 0,
          evictions=None, lifecycle=None, reconcile=None,
          node_refresh=None, auth_token: Optional[str] = None,
          informer=None,
          ssl_context: Optional[ssl.SSLContext] = None) -> Server:
    """Serve ``extender``'s whole HTTP surface (:func:`make_app`, then
    :func:`run_server`). Pass the daemon's ``EvictionExecutor``,
    ``PodLifecycleReleaseLoop``, ``AllocReconcileLoop``,
    ``NodeTopologyRefreshLoop`` and ``PodInformer``
    (``tpukube_torch.apiserver``) to export their counters on /metrics
    and their streams on /statusz."""
    return run_server(
        make_app(extender, reconcile=reconcile, evictions=evictions,
                 node_refresh=node_refresh, lifecycle=lifecycle,
                 auth_token=auth_token, informer=informer),
        host, port, ssl_context=ssl_context)
