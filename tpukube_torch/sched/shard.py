"""Slice-partitioned control plane — the port's copy of
``tpukube/sched/shard.py``.

One planner process is the throughput ceiling of the unsharded plane:
one ``ClusterState``/``GangManager`` owns the whole fleet — the
single-extender-webhook shape that limits KubeGPU-style schedulers.
ICI slices are already the natural partition unit
(snapshots, ``SnapshotDelta`` chains, fragmentation gauges, locks, and
the tenancy ledger are all per-slice), so this module partitions the
control plane BY SLICE:

  * :class:`PlannerReplica` — one shard: a full
    :class:`~tpukube_torch.sched.extender.Extender` owning a DISJOINT slice
    set, with its own ledger, gang manager, snapshot/delta chain,
    scheduling queue, and journal segment (``<journal_path>.r<i>``).
  * :class:`ShardRouter` — the thin routing layer in front of the N
    replicas. It speaks the same decision surface as a single Extender
    (``handle``/``admit``/``plan_pending``/``planned_node``/...), so
    the sim harness, the apiserver loops, and the chaos checkers run
    against either unchanged. Nodes route by the slice id in their
    topology annotation; pods route by slice affinity (their gang's
    home replica, their allocation's owner, or a stable hash with
    capacity spillover); binds route by the target node's owner.

Parity gate: with ``planner_replicas == 1`` every router entry point
delegates VERBATIM to the sole replica's Extender — the N=1 sharded
path is byte-identical to the unsharded planner by construction
(tests/test_torch_shard.py holds it end to end).

Two-phase rendezvous for DCN-spanning gangs
-------------------------------------------

A gang confined to one replica's slices reserves and commits locally,
exactly as today. A gang that fits NO single replica — and opted in to
DCN spanning (``PodGroup.allow_dcn``) — goes through a rendezvous
coordinated by the router on behalf of the initiating (home) replica,
built on the existing ``gang.py`` reservation/epoch machinery:

  1. PLAN: the router asks every alive replica's epoch-cached snapshot
     for its largest contiguous free boxes (one box per slice, each a
     multiple of chips_per_pod — the same greedy
     ``_plan_dcn_split`` shape, spread across replicas).
  2. PREPARE: each participant replica reserves its part through
     ``GangManager.reserve_exact_split`` under its own locks, with a
     LOCAL group whose ``min_member`` is the part's member count — so
     the part commits by its own quorum and sweeps by its own TTL.
     A duplicate prepare is idempotent (``reserve_exact_split``
     returns the existing reservation for the key), and a prepare that
     loses a race (box re-occupied) raises without touching anything.
  3. COMMIT-OR-ABORT: all prepares landed → the rendezvous is
     recorded and member pods fan out to participants with unassigned
     room; any prepare failed → every prepared part is dropped
     (``drop_reservation`` — no members yet, nothing to evict). After
     that, the rendezvous janitor (:meth:`ShardRouter.sweep`) keeps
     the all-or-nothing contract: if ANY uncommitted part disappears —
     TTL expiry, chip/link fault rollback, a replica killed or
     partitioned mid-commit — the surviving parts are dissolved
     (members evicted through the shared eviction bus), exactly the
     death a single-planner gang rollback dies.

The reservation-leak prover and the snapshot-audit sentinel keep
holding: every reservation mutation goes through the proven
``gang.py`` seams, and each replica audits its own snapshot chain.

Production shape: this in-process router serves the sim/bench plane;
a real deployment runs one extender process per replica (each
configured with its slice set and journal segment) behind the same
routing contract, with the router as the stateless webhook front —
its maps are re-derivable from node annotations and the replicas'
reservations (see ``rebuild_from_pods``).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace as dc_replace
from typing import Any, Optional

from tpukube_torch import trace as trace_mod
from tpukube_torch.core import codec
from tpukube_torch.core.config import GpuKubeConfig
from tpukube_torch.core.types import (
    AllocResult,
    PodGroup,
    PodInfo,
    TopologyCoord,
)
from tpukube_torch.sched import kube, slicefit, wirecodec
from tpukube_torch.sched.extender import Extender, ExtenderError
from tpukube_torch.sched.gang import GangError
from tpukube_torch.sched.state import StateError

log = logging.getLogger("tpukube.shard")


class ShardError(RuntimeError):
    pass


class ReplicaUnavailable(ShardError):
    """A replica transport call could not reach its daemon (connection
    refused/reset, timeout). The router treats the replica as dead —
    the same semantics as ``crash_replica`` — and routes around it."""


class _ListApi:
    """Minimal apiserver read surface over captured node/pod object
    lists — the reconcile source ``restart_replica`` hands the journal
    recovery (a replica has no live apiserver of its own; the router's
    feed is the same truth ``rebuild_from_pods`` would consume)."""

    def __init__(self, nodes: list[dict], pods: list[dict]):
        self._nodes = list(nodes)
        self._pods = list(pods)

    def list_nodes(self) -> list[dict]:
        return list(self._nodes)

    def list_pods(self, node_name=None) -> list[dict]:
        del node_name
        return list(self._pods)


# -- replica-side helpers ----------------------------------------------------
#
# The decision surface one planner replica serves, shared VERBATIM by
# the in-process transport (direct calls) and the process worker's
# HTTP routes (sched/shardworker.py): whatever transport carries the
# request, the replica-side computation is this one code path.

def replica_gauges(extender: Extender) -> dict[str, dict[str, Any]]:
    """Per-slice capacity gauges off the replica's EPOCH-CACHED
    snapshot — O(slices), no ledger walk, no sweep probe. The router's
    rendezvous PLAN phase and its routing order feed on these instead
    of serializing full fit probes over the wire (``largest_free_box``
    is cached on the snapshot; it can only OVER-estimate the blocked
    sweep's contiguity, so a gauge-based pre-filter never skips a
    replica the full probe would have accepted)."""
    snap = extender.snapshots.current()
    out: dict[str, dict[str, Any]] = {}
    for sid in snap.slice_ids():
        ss = snap.slice(sid)
        out[sid] = {
            "largest_free_box": ss.largest_free_box(),
            "free_chips": ss.blocked_free_chips,
            "used_shares": ss.used_shares,
            "total_shares": ss.total_shares,
            "utilization": ss.utilization,
            "fragmentation": ss.fragmentation(),
        }
    return out


def gang_fit_probe(extender: Extender, pod: PodInfo, total: int) -> bool:
    """Can this replica host the gang ICI-contiguously in ONE of its
    slices? The same search ``ensure_reservation`` runs — against the
    replica's epoch-cached snapshot, so the sweep this builds is the
    sweep the reservation reuses."""
    snap = extender.snapshots.current()
    shape = pod.group.shape if pod.group is not None else None
    for sid in snap.slice_ids():
        ss = snap.slice(sid)
        if ss.blocked_free_chips < total:
            continue
        coords = slicefit.find_slice_in(
            ss.blocked_sweep(),
            count=None if shape is not None else total,
            shape=shape,
            broken=ss.broken,
        )
        if coords is not None:
            return True
    return False


def gang_prepare_part(
    extender: Extender, pod: PodInfo, cpp: int, volumes: dict[str, int],
) -> dict[str, list[TopologyCoord]]:
    """One replica's PREPARE leg of the two-phase rendezvous: find one
    contiguous free box per requested slice (shrinking by chips_per_pod
    when fragmentation beat the router's gauge-planned volume) and
    reserve them through ``reserve_exact_split`` with a LOCAL-quorum
    group. Returns {slice id -> reserved coords}; raises GangError when
    the replica cannot cover any of the request (nothing reserved — the
    router aborts the rendezvous). A duplicate prepare is idempotent:
    an existing reservation for the key answers with its own parts."""
    assert pod.group is not None
    existing = extender.gang.reservation(pod.namespace, pod.group.name)
    if existing is not None:
        return {sid: sorted(coords)
                for sid, coords in existing.slice_coords.items()}
    snap = extender.snapshots.current()
    parts: dict[str, list[TopologyCoord]] = {}
    got = 0
    for sid in sorted(volumes):
        try:
            ss = snap.slice(sid)
        except KeyError:
            continue  # slice vanished since the gauge read: race
        vol = min(volumes[sid], (ss.blocked_free_chips // cpp) * cpp)
        while vol >= cpp:
            coords = slicefit.find_slice_in(
                ss.blocked_sweep(), count=vol, broken=ss.broken
            )
            if coords is not None:
                parts[sid] = list(coords)
                got += len(coords)
                break
            vol -= cpp
    if got == 0:
        raise GangError(
            f"gang {pod.namespace}/{pod.group.name}: no contiguous part "
            f"available (gauges raced an occupancy change); retry"
        )
    members = got // cpp
    local_pod = dc_replace(pod, group=PodGroup(
        name=pod.group.name, min_member=members,
        shape=None, allow_dcn=True,
    ))
    extender.gang.reserve_exact_split(local_pod, cpp, parts)
    return parts


def replica_summary(extender: Extender) -> dict[str, Any]:
    """One replica's rollup row: ledger/queue/gang counters plus the
    merged-observability feeds (latency windows, event counts, cycle
    stats) the router aggregates across the shard set."""
    st = extender.state
    share_counts: dict[str, list[int]] = {}
    used = total = 0
    for sid in st.slice_ids():
        u, t = st.slice_share_counts(sid)
        share_counts[sid] = [u, t]
        used += u
        total += t
    cycle = extender.cycle
    cycle_stats = None
    if cycle is not None:
        cycle_stats = dict(cycle.stats())
        cycle_stats["cycle_wall_total"] = cycle.cycle_wall_total
    out = {
        "slices": st.slice_ids(),
        "nodes": len(st.node_names()),
        "allocs": len(st.allocations()),
        "share_counts": share_counts,
        "used_shares": used,
        "total_shares": total,
        "utilization": used / total if total else 0.0,
        "binds_total": extender.binds_total,
        "preemptions": extender.preemptions,
        "queue_depth": cycle.queue_depth() if cycle is not None else 0,
        "snapshot_hits": extender.snapshots.hits,
        "snapshot_rebuilds": extender.snapshots.rebuilds,
        "audit": {
            "rate": extender.snapshots.audit_rate,
            "checks": extender.snapshots.audit_checks,
            "divergences": extender.snapshots.audit_divergences,
        },
        "events": extender.events.counts_by_reason(),
        "cycle": cycle_stats,
        "latencies": {h: list(w)
                      for h, w in extender.latencies.items()},
    }
    # federated lockgraph: with the dynamic lock-order detector
    # installed in THIS process (lock_monitor on), the replica's
    # observed edge set rides its summary row — the same surface the
    # subprocess transport serves over /worker/summary, so
    # worker-process edges reach the router's fleet-wide cycle merge
    # with no new wire protocol. Key absent when the monitor is off
    # (off-is-off: summaries unchanged).
    from tpukube_torch.analysis import lockgraph

    mon = lockgraph.active()
    if mon is not None:
        out["lock_graph"] = mon.report()
    return out


# -- replica transports ------------------------------------------------------

class InProcessTransport:
    """The parity oracle: the replica is a live Extender object in this
    process, every call a direct method dispatch — deterministic,
    single-GIL. :class:`SubprocessTransport` carries the identical
    surface over the extender webhook/HTTP contract."""

    mode = "inprocess"

    def __init__(self, extender: Extender):
        self.extender = extender

    # decision surface ------------------------------------------------------
    def handle(self, kind: str, body: Any) -> Any:
        return self.extender.handle(kind, body)

    def upsert_nodes(self, items: list[dict[str, Any]]) -> list[Any]:
        # ONE bulk-ingest decision per batch: the replica
        # ingests its whole shard through the cold-start fast path
        return self.extender.upsert_nodes_many(items)

    def admit_many(self, pods: list[PodInfo]) -> list[bool]:
        return [self.extender.admit(p) for p in pods]

    def plan_pending(self) -> int:
        return self.extender.plan_pending()

    def planned_nodes(self, keys: list[str]) -> dict[str, Optional[str]]:
        return {k: self.extender.planned_node(k) for k in keys}

    def bind_many(self, bodies: list[dict]) -> list[dict]:
        return [self.extender.handle("bind", b) for b in bodies]

    def release_many(self, pod_keys: list[str]) -> None:
        for key in pod_keys:
            self.extender.handle("release", {"pod_key": key})

    # gang / rendezvous surface ---------------------------------------------
    def gauges(self) -> dict[str, dict[str, Any]]:
        return replica_gauges(self.extender)

    def gang_fit(self, pod: PodInfo, total: int) -> bool:
        return gang_fit_probe(self.extender, pod, total)

    def gang_prepare(self, pod: PodInfo, cpp: int,
                     volumes: dict[str, int]) -> dict[str, list]:
        return gang_prepare_part(self.extender, pod, cpp, volumes)

    def gang_drop(self, key: tuple[str, str]) -> None:
        self.extender.gang.drop_reservation(key)

    def gang_dissolve(self, key: tuple[str, str]) -> None:
        self.extender.gang.dissolve(key)

    def gang_reservation(self, key: tuple[str, str]) -> Optional[dict]:
        res = self.extender.gang.reservation(*key)
        if res is None:
            return None
        return {
            "committed": res.committed,
            "slices": {sid: sorted(coords)
                       for sid, coords in res.slice_coords.items()},
        }

    def gang_sweep(self) -> None:
        self.extender.gang.sweep()

    # read views ------------------------------------------------------------
    def allocations(self) -> list[AllocResult]:
        return self.extender.state.allocations()

    def allocs_since(self, cursor) -> Optional[dict]:
        return self.extender.state.allocs_since(cursor)

    def allocation(self, pod_key: str) -> Optional[AllocResult]:
        return self.extender.state.allocation(pod_key)

    def node(self, name: str):
        return self.extender.state.node(name)

    def node_names(self) -> tuple[str, ...]:
        return self.extender.state.node_names()

    def slice_ids(self) -> list[str]:
        return self.extender.state.slice_ids()

    def gang_snapshot(self) -> list[dict[str, Any]]:
        return self.extender.gang_snapshot()

    def alloc_snapshot(self) -> list[dict[str, Any]]:
        return self.extender.alloc_snapshot()

    def summary(self) -> dict[str, Any]:
        return replica_summary(self.extender)

    def latencies(self) -> dict[str, list[float]]:
        return {h: list(w) for h, w in self.extender.latencies.items()}

    def counts_by_reason(self) -> dict[str, int]:
        return self.extender.events.counts_by_reason()

    def events_emit(self, *args, **kwargs) -> None:
        self.extender.events.emit(*args, **kwargs)

    # federated observability -----------------------------------------------
    def explain(self, pod_key: str) -> Optional[dict[str, Any]]:
        dlog = self.extender.decisions
        return dlog.explain(pod_key) if dlog is not None else None

    def events_query(self, reason=None, pod=None, node=None,
                     since=None) -> list[dict[str, Any]]:
        return self.extender.events.events(reason=reason, pod=pod,
                                           node=node, since=since)

    def metrics_text(self) -> str:
        from tpukube_torch.metrics import render_extender_metrics

        return render_extender_metrics(self.extender)

    def statusz_doc(self) -> dict[str, Any]:
        from tpukube_torch.obs.statusz import extender_statusz

        return extender_statusz(self.extender)

    def trace_events(self, since_seq: int = 0) -> list[dict[str, Any]]:
        tr = self.extender.trace
        return tr.events(since_seq=since_seq) if tr is not None else []

    def capacity_doc(self, since=None) -> Optional[dict[str, Any]]:
        cap = self.extender.capacity
        return cap.capacity_doc(since=since) if cap is not None else None

    def capacity_probe(self, count=None, shape=None,
                       chips_per_pod=1) -> Optional[dict[str, Any]]:
        cap = self.extender.capacity
        if cap is None:
            return None
        return cap.probe(count=count, shape=shape,
                         chips_per_pod=chips_per_pod)

    def wire_snapshot(self) -> Optional[dict[str, Any]]:
        return None  # direct dispatch: nothing crosses a wire

    # lifecycle -------------------------------------------------------------
    def rebuild_from_pods(self, pods: list[dict[str, str]]) -> int:
        return self.extender.rebuild_from_pods(pods)

    def recover(self, node_objs: list[dict],
                pod_objs: list[dict]) -> dict:
        """Warm restart from the replica's own journal segment
        (checkpoint + WAL replay + reconcile against the provided
        node/pod truth). ``{"recover_error": ...}`` when the journal
        cannot produce a trustworthy base — the router then falls back
        to the cold full re-ingest on a FRESH replica."""
        from tpukube_torch.sched import journal as journal_mod

        ext = self.extender
        if ext.journal is None:
            return {"recover_error": "journal disabled"}
        try:
            stats = journal_mod.recover_extender(
                ext, _ListApi(node_objs, pod_objs))
        except journal_mod.JournalError as e:
            ext.journal.crash()
            ext.state.retire()
            return {"recover_error": str(e)}
        return {"stats": stats,
                "restored": len(ext.state.allocations())}

    def drain_evictions(self) -> list[str]:
        # the in-process replicas share the router's eviction deque
        # (eviction_sink) — there is nothing replica-local to pull
        return []

    def advance(self, seconds: float) -> None:
        pass  # shares the router process's clock

    def healthz(self) -> bool:
        return True

    def set_evict_precheck(self, fn) -> None:
        self.extender.evict_precheck = fn

    def set_binder(self, fn) -> None:
        self.extender.binder = fn

    def set_degraded_gate(self, fn) -> None:
        self.extender.degraded_gate = fn

    def kill(self) -> None:
        # process death is modeled by the router (journal crash +
        # ledger retire); nothing transport-level to tear down
        pass

    def close(self) -> None:
        ext = self.extender
        if ext.trace is not None:
            ext.trace.close()
        if ext.capacity is not None:
            ext.capacity.close()
        ext.events.close()
        if ext.journal is not None:
            ext.journal.close()
            ext.state.retire()


#: the directory that holds the ``tpukube_torch`` package: a worker is
#: spawned there with it first on ``PYTHONPATH``, so it imports this very
#: package whatever the router's working directory is
_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tail(path: Optional[str], lines: int) -> str:
    """The last ``lines`` lines of a worker's log ("" when unreadable)."""
    if not path:
        return ""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - (1 << 16)))
            text = f.read().decode("utf-8", errors="replace")
    except OSError:
        return ""
    return "\n".join(text.splitlines()[-lines:])


class SubprocessTransport:
    """One planner daemon per replica: spawns ``python -m
    tpukube_torch.cli shard-worker`` (an Extender behind its HTTP surface
    plus the ``/worker/*`` routes of ``sched/shardworker.py``) and speaks
    the transport surface over HTTP. Requests on ONE replica are ordered
    (one kept-alive connection behind a lock: binds and rendezvous
    prepares arrive in call order); the router fans calls out to
    distinct replicas concurrently, which is where the multi-core
    speedup lives. A connection failure marks the replica dead through
    ``on_down`` — ``crash_replica`` semantics.

    The worker runs in the directory that holds this package, with it
    first on ``PYTHONPATH``, from a per-replica config file written by
    :func:`~tpukube_torch.core.config.write_yaml` (no inherited
    ``TPUKUBE_*`` variable reaches it: the file is its one config
    source). It binds a port the kernel picks and reports it on its first
    stdout line, so no port is handed over between a probe and a bind.
    Its stdout and stderr go to ``log_path`` in the transport's temp
    directory; a worker that exits before serving, or does not serve in
    ``SPAWN_TIMEOUT_S``, raises a ShardError that quotes the log's last
    ``LOG_TAIL_LINES`` lines. The worker leads a process group of its
    own, and ``kill``/``close`` signal the group."""

    mode = "subprocess"
    #: no live Extender object in this process (tests and the router's
    #: in-process-only seams check for None)
    extender = None

    SPAWN_TIMEOUT_S = 30.0
    RTT_WINDOW = 1024
    LOG_TAIL_LINES = 40
    _proc: Optional[subprocess.Popen] = None
    _dir: Optional[str] = None

    def __init__(self, index: int, config: GpuKubeConfig,
                 fake_clock: bool, on_down=None):
        self.index = index
        self.on_down = on_down
        self.down = False
        self.health_checks = 0
        self.health_failures = 0
        self.rtt_window: deque[float] = deque(maxlen=self.RTT_WINDOW)
        self.rtt_sum = 0.0
        self.rtt_count = 0
        # wire-cost accounting: request and response bytes as they cross
        # this transport, total and per op (op = the /worker/* route
        # tail), under _lock with the RTT stats; read via wire_snapshot()
        self.wire_tx = 0
        self.wire_rx = 0
        self.wire_by_op: dict[str, dict[str, Any]] = {}
        # wire codec (sched/wirecodec.py): json (the default, the parity
        # oracle) or binary (TKW1 frames); the raw counters keep
        # pre-compression frame bytes for the per-op compression ratio
        self.wire_codec = config.wire_codec
        self.wire_compress_min_bytes = config.wire_compress_min_bytes
        self.wire_raw_tx = 0
        self.wire_raw_rx = 0
        # the connection's negotiated peer capability: None = unknown
        # (requests go out as JSON with an Accept probe), True = the peer
        # answered TKW1, so request bodies switch to binary too. Reset
        # whenever the kept-alive connection is torn down: a respawned
        # worker re-handshakes from JSON.
        self._peer_binary: Optional[bool] = None
        #: optional (index, op, tx_bytes, rx_bytes, rtt_s, codec) hook the
        #: router feeds its fan-out flight recorder from; called outside
        #: the transport lock, after each completed request
        self.on_wire = None
        self._lock = threading.Lock()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._port = 0
        t0 = time.perf_counter()
        self._dir = tempfile.mkdtemp(prefix=f"tpukube-r{index}-")
        self.log_path = os.path.join(self._dir, "worker.log")
        # scrub TPUKUBE_* so the per-replica file is the ONE config source:
        # an inherited TPUKUBE_PLANNER_REPLICAS=4 must not make each
        # worker try to be a router itself
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("TPUKUBE_")}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_ROOT, env.get("PYTHONPATH", "")) if p)
        try:
            cmd = [sys.executable, "-m", "tpukube_torch.cli", "shard-worker",
                   "--config", self._write_config(config), "--port", "0"]
            if fake_clock:
                cmd.append("--fake-clock")
            with open(self.log_path, "wb") as log_file:
                self._proc = subprocess.Popen(
                    cmd, cwd=_PKG_ROOT, env=env, stdin=subprocess.DEVNULL,
                    stdout=log_file, stderr=subprocess.STDOUT,
                    start_new_session=True,
                )
            self._port = self._read_port()
            self._wait_ready()
        except BaseException:
            self.kill()
            raise
        self.spawn_ready_s = time.perf_counter() - t0

    def _write_config(self, config: GpuKubeConfig) -> str:
        import dataclasses

        from tpukube_torch.core.config import write_yaml

        doc = dataclasses.asdict(config)
        # the worker IS one planner: never a router, never recursive
        doc["planner_replicas"] = 1
        doc["shard_transport"] = "inprocess"
        path = os.path.join(self._dir, "config.yaml")
        write_yaml(path, doc)
        return path

    def _spawn_error(self, what: str) -> ShardError:
        tail = _tail(self.log_path, self.LOG_TAIL_LINES)
        return ShardError(
            f"shard worker r{self.index} {what}; the last lines of its "
            f"log ({self.log_path}):\n{tail or '(empty)'}")

    def _read_port(self) -> int:
        """The port the worker reports on its first stdout line."""
        from tpukube_torch.sched.shardworker import READY_KEY

        deadline = time.monotonic() + self.SPAWN_TIMEOUT_S
        prefix = f'{{"{READY_KEY}"'.encode()
        while time.monotonic() < deadline:
            try:
                with open(self.log_path, "rb") as f:
                    for line in f:
                        if line.startswith(prefix):
                            return int(json.loads(line)[READY_KEY]["port"])
            except (OSError, ValueError, KeyError, TypeError):
                pass
            if self._proc.poll() is not None:
                raise self._spawn_error(
                    f"exited with {self._proc.returncode} before serving")
            time.sleep(0.02)
        raise self._spawn_error(
            f"reported no port within {self.SPAWN_TIMEOUT_S}s")

    def _wait_ready(self) -> None:
        deadline = time.monotonic() + self.SPAWN_TIMEOUT_S
        while time.monotonic() < deadline:
            if self._proc.poll() is not None:
                raise self._spawn_error(
                    f"exited with {self._proc.returncode} before serving")
            try:
                if self.healthz(timeout=1.0):
                    # the spawn-wait probes are EXPECTED to fail until
                    # the daemon serves: they are not health signal
                    self.health_checks = 0
                    self.health_failures = 0
                    if self.wire_codec == "binary":
                        # complete the codec handshake NOW with one cheap
                        # op, or the first heavy call (the cold-start
                        # ingest, the body the codec exists for) would
                        # ride the JSON probe
                        try:
                            self._request("GET", "/worker/gauges",
                                          timeout=5.0, mark_down=False)
                        except ShardError:
                            pass  # probe only; requests renegotiate
                    return
            except ReplicaUnavailable:
                pass
            time.sleep(0.05)
        raise self._spawn_error(
            f"did not serve /healthz within {self.SPAWN_TIMEOUT_S}s")

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def _signal_group(self, sig: int) -> None:
        try:
            # the worker leads its own group (start_new_session)
            os.killpg(self._proc.pid, sig)
        except ProcessLookupError:
            pass  # ended between the poll and the signal

    # -- wire ---------------------------------------------------------------
    def _request(self, method: str, path: str,
                 body: Optional[dict] = None, timeout: float = 60.0,
                 mark_down: bool = True, as_text: bool = False) -> Any:
        # Only the /worker/* op surface negotiates the binary codec;
        # exposition passthrough (/metrics, /statusz, /healthz, ...)
        # stays JSON/text regardless.
        wire_op = path.startswith("/worker/")
        negotiate = (wire_op and not as_text
                     and self.wire_codec == "binary")
        # _peer_binary is read without the lock: requests on one
        # replica serialize behind _lock anyway, and the worst a stale
        # read costs is one more JSON-bodied probe request.
        req_codec = "json"
        raw_tx = 0
        if body is not None:
            if negotiate and self._peer_binary:
                payload, raw_tx = wirecodec.encode_frame(
                    body, self.wire_compress_min_bytes)
                headers = {
                    "Content-Type": wirecodec.WIRE_CONTENT_TYPE}
                req_codec = "binary"
            else:
                payload = wirecodec.dumps_json(body)
                headers = {
                    "Content-Type": wirecodec.JSON_CONTENT_TYPE}
                raw_tx = len(payload)
        else:
            payload = None
            headers = {}
        if negotiate:
            # capability probe: a TKW1-speaking worker answers in
            # kind; a JSON-only worker ignores it — the per-replica
            # rolling-upgrade degrade
            headers["Accept"] = wirecodec.WIRE_CONTENT_TYPE
        ctx = trace_mod.TRACE_CONTEXT.get()
        if ctx is not None:
            # propagate the router's trace context so the worker tags
            # its decision records and timeline spans with it
            headers["X-Tpukube-Trace"] = \
                f"{ctx.get('trace', '')}/{ctx.get('parent', '')}"
        op = path.split("?", 1)[0].lstrip("/")
        if op.startswith("worker/"):
            op = op[len("worker/"):]
        op = op.replace("/", "_")
        t0 = time.perf_counter()
        with self._lock:
            if self.down:
                raise ReplicaUnavailable(
                    f"replica r{self.index} is down"
                )
            try:
                conn = self._conn
                if conn is None:
                    conn = self._conn = http.client.HTTPConnection(
                        "127.0.0.1", self._port, timeout=timeout
                    )
                elif conn.sock is not None:
                    # the kept-alive socket's timeout is pinned at
                    # connect time: re-arm it PER REQUEST, or a quick
                    # health probe's 2s budget would cap every later
                    # heavy call (a 10k-node upsert, a 2k-pod plan)
                    # and read as replica death
                    conn.sock.settimeout(timeout)
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
            except (http.client.HTTPException, OSError) as e:
                if self._conn is not None:
                    self._conn.close()
                    self._conn = None
                # fresh connection means a possibly fresh peer (a
                # respawned worker): renegotiate the codec from JSON
                self._peer_binary = None
                # bill the failed request too — an unaccounted retry
                # storm is exactly the traffic this counter exists to
                # expose (rx stays 0: nothing usable came back)
                tx = len(payload or b"")
                self.wire_tx += tx
                self.wire_raw_tx += raw_tx
                cell = self.wire_by_op.get(op)
                if cell is None:
                    cell = self.wire_by_op[op] = \
                        {"tx": 0, "rx": 0, "calls": 0}
                cell["tx"] += tx
                cell["calls"] += 1
                cell["failures"] = cell.get("failures", 0) + 1
                if req_codec == "binary":
                    cell["codec"] = "binary"
                    cell["raw_tx"] = cell.get("raw_tx", 0) + raw_tx
                    cell["raw_rx"] = cell.get("raw_rx", 0)
                if mark_down:
                    self._mark_down_locked(e)
                raise ReplicaUnavailable(
                    f"replica r{self.index} unreachable: {e}"
                ) from e
            dt = time.perf_counter() - t0
            self.rtt_window.append(dt)
            self.rtt_sum += dt
            self.rtt_count += 1
            resp_ct = (resp.getheader("Content-Type") or "").split(
                ";", 1)[0].strip()
            resp_binary = resp_ct == wirecodec.WIRE_CONTENT_TYPE
            if negotiate and resp_binary and resp.status < 400:
                # the worker answered TKW1: switch request bodies to
                # binary for the rest of this connection
                self._peer_binary = True
            tx, rx = len(payload or b""), len(raw)
            self.wire_tx += tx
            self.wire_rx += rx
            self.wire_raw_tx += raw_tx
            if not resp_binary:
                self.wire_raw_rx += rx
            cell = self.wire_by_op.get(op)
            if cell is None:
                cell = self.wire_by_op[op] = \
                    {"tx": 0, "rx": 0, "calls": 0}
            cell["tx"] += tx
            cell["rx"] += rx
            cell["calls"] += 1
            if req_codec == "binary" or resp_binary:
                # tag the cell with the codec that actually crossed
                # the wire (absence of the tag = pure JSON, so the
                # default-codec cell shape is unchanged) and track
                # pre-compression frame bytes for the ratio exposition
                cell["codec"] = "binary"
                cell["raw_tx"] = cell.get("raw_tx", 0) + raw_tx
                cell.setdefault("raw_rx", 0)
        if self.on_wire is not None:
            self.on_wire(self.index, op, tx, rx, dt,
                         "binary" if (req_codec == "binary"
                                      or resp_binary) else "json")
        if resp.status >= 400:
            raise ShardError(
                f"replica r{self.index} {path}: HTTP {resp.status}: "
                f"{raw.decode(errors='replace')[:200]}"
            )
        if as_text:
            return raw.decode("utf-8", errors="replace")
        if not raw:
            return None
        if resp_binary:
            # decode outside the transport lock (a fleet-sized audit
            # read must not stall the next request behind its decode)
            try:
                out, raw_rx = wirecodec.decode_frame_ex(raw)
            except wirecodec.WireCodecError as e:
                raise ShardError(
                    f"replica r{self.index} {path}: undecodable "
                    f"wire frame: {e}"
                ) from e
            with self._lock:
                self.wire_raw_rx += raw_rx
                cell = self.wire_by_op.get(op)
                if cell is not None:
                    cell["raw_rx"] = cell.get("raw_rx", 0) + raw_rx
            return out
        return json.loads(raw)

    def _mark_down_locked(self, err: Exception) -> None:
        if not self.down:
            self.down = True
            log.error("replica r%d transport failed (%s); marking the "
                      "replica dead", self.index, err)
            if self.on_down is not None:
                self.on_down(self.index)

    # decision surface ------------------------------------------------------
    def handle(self, kind: str, body: Any) -> Any:
        out = self._request("POST", "/worker/handle",
                            {"kind": kind, "body": body})
        if isinstance(out, dict) and "schema_error" in out:
            # re-raise the exception type the in-process dispatch would
            # have propagated — the HTTP layer above maps it to 400
            raise kube.KubeSchemaError(out["schema_error"])
        return out

    def upsert_nodes(self, items: list[dict[str, Any]]) -> list[Any]:
        return self._request("POST", "/worker/upsert",
                             {"items": items})["results"]

    def admit_many(self, pods: list[PodInfo]) -> list[bool]:
        return self._request("POST", "/worker/admit", {
            "pods": [kube.pod_to_k8s(p) for p in pods],
        })["admitted"]

    def plan_pending(self) -> int:
        return self._request("POST", "/worker/plan", {})["planned"]

    def planned_nodes(self, keys: list[str]) -> dict[str, Optional[str]]:
        return self._request("POST", "/worker/planned",
                             {"keys": list(keys)})["nodes"]

    def bind_many(self, bodies: list[dict]) -> list[dict]:
        return self._request("POST", "/worker/bind",
                             {"bodies": bodies})["results"]

    def release_many(self, pod_keys: list[str]) -> None:
        self._request("POST", "/worker/release",
                      {"keys": list(pod_keys)})

    # gang / rendezvous surface ---------------------------------------------
    def gauges(self) -> dict[str, dict[str, Any]]:
        return self._request("GET", "/worker/gauges")["slices"]

    def _gang(self, op: str, **kw) -> Any:
        out = self._request("POST", "/worker/gang", {"op": op, **kw})
        err = out.get("error")
        if err:
            # the worker maps expected races (box re-occupied, slice
            # gone) to typed errors so the router degrades exactly as
            # the in-process prepare would
            if out.get("kind") == "state":
                raise StateError(err)
            raise GangError(err)
        return out

    def gang_fit(self, pod: PodInfo, total: int) -> bool:
        return self._gang("fit", pod=kube.pod_to_k8s(pod),
                          total=total)["fits"]

    def gang_prepare(self, pod: PodInfo, cpp: int,
                     volumes: dict[str, int]) -> dict[str, list]:
        out = self._gang("prepare", pod=kube.pod_to_k8s(pod), cpp=cpp,
                         volumes=volumes)
        return {
            sid: [TopologyCoord.of(c) for c in coords]
            for sid, coords in out["parts"].items()
        }

    def gang_drop(self, key: tuple[str, str]) -> None:
        self._gang("drop", namespace=key[0], name=key[1])

    def gang_dissolve(self, key: tuple[str, str]) -> None:
        self._gang("dissolve", namespace=key[0], name=key[1])

    def gang_reservation(self, key: tuple[str, str]) -> Optional[dict]:
        out = self._gang("reservation", namespace=key[0],
                         name=key[1])["reservation"]
        if out is None:
            return None
        out["slices"] = {
            sid: [TopologyCoord.of(c) for c in coords]
            for sid, coords in (out.get("slices") or {}).items()
        }
        return out

    def gang_sweep(self) -> None:
        self._gang("sweep")

    # read views ------------------------------------------------------------
    def allocations(self) -> list[AllocResult]:
        return self._decode_allocs(
            self._request("GET", "/worker/allocs")["allocs"])

    def _decode_allocs(self, objs: list) -> list[AllocResult]:
        allocs = []
        for obj in objs:
            try:
                allocs.append(codec.alloc_from_obj(obj))
            except codec.CodecError as e:
                log.error("replica r%d sent an undecodable alloc: %s",
                          self.index, e)
        return allocs

    def allocs_since(self, cursor) -> Optional[dict]:
        out = self._request("POST", "/worker/allocs_since",
                            {"cursor": cursor})
        if out is None or out.get("disabled"):
            return None
        res: dict[str, Any] = {
            "cursor": out["cursor"],
            "bytes": int(out.get("bytes", 0)),
        }
        if "full" in out:
            res["full"] = self._decode_allocs(out["full"])
        else:
            res["adds"] = self._decode_allocs(out["adds"])
            res["removes"] = [str(k) for k in out["removes"]]
        return res

    def allocation(self, pod_key: str) -> Optional[AllocResult]:
        from urllib.parse import quote

        out = self._request(
            "GET", f"/worker/alloc?pod={quote(pod_key, safe='')}"
        )["alloc"]
        if out is None:
            return None
        try:
            return codec.alloc_from_obj(out)
        except codec.CodecError as e:
            log.error("replica r%d sent an undecodable alloc for %s: "
                      "%s", self.index, pod_key, e)
            return None

    def node(self, name: str):
        # NodeView objects do not cross the process boundary; router
        # callers needing node payloads read them from the pod/node
        # store, not from a remote replica's in-memory view
        return None

    def node_names(self) -> tuple[str, ...]:
        return tuple(self._request("GET", "/worker/nodes")["names"])

    def slice_ids(self) -> list[str]:
        return list(self._request("GET", "/worker/summary")["slices"])

    def gang_snapshot(self) -> list[dict[str, Any]]:
        return self._request("GET", "/state/gangs")

    def alloc_snapshot(self) -> list[dict[str, Any]]:
        return self._request("GET", "/state/allocs")

    def summary(self) -> dict[str, Any]:
        return self._request("GET", "/worker/summary")

    def latencies(self) -> dict[str, list[float]]:
        return self._request("GET", "/worker/summary")["latencies"]

    def counts_by_reason(self) -> dict[str, int]:
        return self._request("GET", "/worker/summary")["events"]

    def events_emit(self, reason: str, obj: str = "", message: str = "",
                    **kwargs) -> None:
        self._request("POST", "/worker/emit", {
            "reason": reason, "obj": obj, "message": message, **kwargs,
        })

    # federated observability -----------------------------------------------
    def explain(self, pod_key: str) -> Optional[dict[str, Any]]:
        from urllib.parse import quote

        try:
            return self._request(
                "GET", f"/explain?pod={quote(pod_key, safe='')}")
        except ShardError:
            return None  # provenance disabled on the worker (404)

    def events_query(self, reason=None, pod=None, node=None,
                     since=None) -> list[dict[str, Any]]:
        from urllib.parse import urlencode

        q = {k: v for k, v in (("reason", reason), ("pod", pod),
                               ("node", node), ("since", since))
             if v is not None}
        path = "/events" + (f"?{urlencode(q)}" if q else "")
        return self._request("GET", path) or []

    def metrics_text(self) -> str:
        return self._request("GET", "/metrics", as_text=True)

    def statusz_doc(self) -> dict[str, Any]:
        return self._request("GET", "/statusz")

    def trace_events(self, since_seq: int = 0) -> list[dict[str, Any]]:
        try:
            return self._request(
                "GET", f"/trace?since={since_seq}") or []
        except ShardError:
            return []  # tracing disabled on the worker (404)

    def capacity_doc(self, since=None) -> Optional[dict[str, Any]]:
        path = "/capacity" + (f"?since={since}" if since is not None
                              else "")
        try:
            return self._request("GET", path)
        except ShardError:
            return None  # capacity disabled on the worker (404)

    def capacity_probe(self, count=None, shape=None,
                       chips_per_pod=1) -> Optional[dict[str, Any]]:
        from urllib.parse import urlencode

        q: dict[str, Any] = {"chips_per_pod": chips_per_pod}
        if count is not None:
            q["count"] = count
        if shape is not None:
            q["shape"] = "x".join(str(d) for d in shape)
        try:
            return self._request(
                "GET", f"/capacity/probe?{urlencode(q)}")
        except ShardError:
            return None  # capacity disabled on the worker (404)

    def wire_snapshot(self) -> dict[str, Any]:
        """Cumulative request/response byte counters, total and per op."""
        with self._lock:
            snap = {
                "tx": self.wire_tx,
                "rx": self.wire_rx,
                "by_op": {op: dict(c)
                          for op, c in self.wire_by_op.items()},
            }
            if self.wire_codec != "json":
                # pre-compression frame bytes next to the wire bytes:
                # saved = raw - wire, without re-serializing to JSON.
                # Keys appear only with the codec on so the default
                # plane's snapshot/statusz stays byte-identical.
                snap["codec"] = self.wire_codec
                snap["raw_tx"] = self.wire_raw_tx
                snap["raw_rx"] = self.wire_raw_rx
            return snap

    # lifecycle -------------------------------------------------------------
    def rebuild_from_pods(self, pods: list[dict[str, str]]) -> int:
        return self._request("POST", "/worker/rebuild",
                             {"pods": pods})["restored"]

    def recover(self, node_objs: list[dict],
                pod_objs: list[dict]) -> dict:
        # recovery replays the worker's whole journal segment and
        # reconciles a fleet-sized feed: give it the heavy-call budget
        return self._request("POST", "/worker/recover",
                             {"nodes": node_objs, "pods": pod_objs},
                             timeout=300.0)

    def drain_evictions(self) -> list[str]:
        return self._request("POST", "/worker/evictions", {})["pods"]

    def advance(self, seconds: float) -> None:
        self._request("POST", "/worker/advance", {"seconds": seconds})

    def healthz(self, timeout: float = 2.0) -> bool:
        self.health_checks += 1
        try:
            out = self._request("GET", "/healthz", timeout=timeout,
                                mark_down=False)
        except (ReplicaUnavailable, ShardError):
            self.health_failures += 1
            raise ReplicaUnavailable(
                f"replica r{self.index}: health check failed"
            ) from None
        return bool(out.get("ok"))

    def set_evict_precheck(self, fn) -> None:
        # the worker daemon owns its own apiserver wiring; the sim
        # worker runs precheck-less (no PDBs), matching the harness's
        # trivially-true precheck
        pass

    def set_binder(self, fn) -> None:
        pass  # the router applies the bind effector from the bind answer

    def set_degraded_gate(self, fn) -> None:
        pass  # a real worker daemon wires its own circuit -> gate

    def rtt_snapshot(self) -> list[float]:
        with self._lock:
            return list(self.rtt_window)

    def kill(self) -> None:
        """SIGKILL the worker's process group — process death, nothing
        flushed (the chaos story's crash_replica over a real process)."""
        self._stop(signal.SIGKILL, wait_s=10.0)

    def close(self) -> None:
        """Graceful stop (harness shutdown): SIGTERM, then SIGKILL after
        5 s."""
        self._stop(signal.SIGTERM, wait_s=5.0)

    def _stop(self, sig: int, wait_s: float) -> None:
        with self._lock:
            self.down = True
            if self._conn is not None:
                self._conn.close()
                self._conn = None
        proc = self._proc
        if proc is not None and proc.poll() is None:
            self._signal_group(sig)
            try:
                proc.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                self._signal_group(signal.SIGKILL)
                proc.wait()
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


class PlannerReplica:
    """One shard of the control plane: index + its transport + liveness.
    ``alive=False`` models a partitioned OR killed replica — the
    router stops routing to it and the rendezvous janitor treats its
    uncommitted parts as lost. ``killed=True`` additionally marks the
    in-memory state as GONE (process death): the federated read views
    must not serve the corpse's ledger — a dead shard's pods are
    ledger-absent until the warm restart, and the chaos invariants
    must see exactly that. ``transport`` is the replica's decision
    surface: an :class:`InProcessTransport` (a live Extender in this
    process — the parity oracle) or a :class:`SubprocessTransport`
    (one planner daemon per replica over the webhook HTTP contract)."""

    __slots__ = ("index", "transport", "alive", "killed", "pods_routed")

    def __init__(self, index: int, transport):
        self.index = index
        self.transport = transport
        self.alive = True
        self.killed = False
        self.pods_routed = 0

    @property
    def extender(self) -> Optional[Extender]:
        """The replica's in-process Extender (None for a subprocess
        replica — its extender lives in the worker daemon)."""
        return self.transport.extender

    @property
    def name(self) -> str:
        return f"r{self.index}"


class _Rendezvous:
    """Router-side record of one DCN gang's prepared parts."""

    __slots__ = ("key", "parts", "local_min", "created", "committed",
                 "member_target")

    def __init__(self, key: tuple[str, str],
                 parts: dict[int, dict[str, list[TopologyCoord]]],
                 local_min: dict[int, int], created: float):
        self.key = key
        #: replica index -> {slice id -> reserved coords}
        self.parts = parts
        #: replica index -> that part's member quorum
        self.local_min = local_min
        self.created = created
        self.committed = False
        #: pod key -> its part's replica index: STICKY member routing,
        #: capped per part at local_min — the driver path admits every
        #: member before any binds, so ``assignable`` cannot spread
        #: them; the router must (and a member's filter, prioritize,
        #: and bind must all land on the same part)
        self.member_target: dict[str, int] = {}


class _FederatedState:
    """Read-only ledger view over every replica (the surface the
    apiserver loops and chaos checkers consume: ``allocations``,
    ``allocation``, ``utilization``, ``node_names``). Mutations never
    come through here — they route via ``ShardRouter.handle``. A
    KILLED replica's state is excluded: its in-memory ledger died
    with the process, and serving the corpse would let the chaos
    invariants false-negative on exactly the divergence a dead shard
    creates (a partitioned replica's state, by contrast, is real and
    still served)."""

    def __init__(self, router: "ShardRouter"):
        self._router = router

    def _live(self) -> list[PlannerReplica]:
        return [r for r in self._router.replicas if not r.killed]

    def allocations(self) -> list:
        # fanned out: in process mode each replica serializes its own
        # ledger concurrently (the lifecycle resync reads this every
        # churn wave — serial fetches would re-serialize the whole
        # fleet through one connection at a time)
        results = self._router._fan_out(
            self._live(), lambda rep: rep.transport.allocations()
        )
        out: list = []
        for allocs in results.values():
            out.extend(allocs)
        return out

    def allocs_since(self, cursor) -> Optional[dict]:
        """Federated incremental resync: fan ``allocs_since``
        out per live replica (concurrently in process mode) and merge.
        The merged answer is INCREMENTAL only when the answering
        replica set matches the cursor's and every replica answered
        incrementally; anything else — a replica killed, healed,
        restarted (fresh incarnation), gapped, or simply missing from
        the last cursor — degrades to a merged FULL answer, never a
        stale one. A churn wave against a stable shard set therefore
        moves O(changed-allocs) wire bytes instead of every replica's
        whole ledger. None when any replica runs without the log
        (consumers then keep the legacy full read)."""
        router = self._router
        reps = self._live()
        prev = cursor if isinstance(cursor, dict) else None
        results = router._fan_out(
            reps,
            lambda rep: rep.transport.allocs_since(
                (prev or {}).get(rep.name)),
        )
        if not results or any(r is None for r in results.values()):
            return None  # a replica has no change log: legacy reads
        names = {router.replicas[i].name for i in results}
        new_cursor = {router.replicas[i].name: r["cursor"]
                      for i, r in results.items()}
        total_bytes = sum(int(r.get("bytes", 0))
                          for r in results.values())
        if (prev is not None and set(prev) == names
                and all("full" not in r for r in results.values())):
            adds: list = []
            removes: list[str] = []
            for r in results.values():
                adds.extend(r["adds"])
                removes.extend(r["removes"])
            return {"cursor": new_cursor, "adds": adds,
                    "removes": removes, "bytes": total_bytes}
        # full merge: replicas that answered incrementally re-read
        # their full set (rare — replica-set churn or a gap); changes
        # racing between a replica's cursor and its full read are
        # simply re-delivered by the next delta, which the consumer's
        # mirror absorbs idempotently
        full: list = []
        need = [router.replicas[i] for i, r in results.items()
                if "full" not in r]
        refetch = router._fan_out(
            need, lambda rep: rep.transport.allocations()
        )
        from tpukube_torch.sched.state import _alloc_bytes

        for i, r in results.items():
            if "full" in r:
                full.extend(r["full"])
            elif i in refetch:
                # the refetched ledger is wire traffic too (on TOP of
                # the superseded incremental answer): count it, or the
                # bytes counter understates exactly the expensive
                # rounds it exists to expose
                full.extend(refetch[i])
                total_bytes += _alloc_bytes(refetch[i])
            else:
                # died between the two reads: its allocs drop from the
                # cursor too, so the next round full-reads again
                new_cursor.pop(router.replicas[i].name, None)
        return {"cursor": new_cursor, "full": full,
                "bytes": total_bytes}

    def allocation(self, pod_key: str):
        if self._router.mode == "subprocess":
            # bind answers prime this cache; a hit saves the lifecycle
            # loop one HTTP read per released pod (stale-yes is safe:
            # the routed release on an already-released pod is a no-op)
            cached = self._router._alloc_cache.get(pod_key)
            if cached is not None:
                return cached
        # the router's pod->replica affinity answers most lookups with
        # one targeted read; an unmapped key scans the live set
        idx = self._router._pod_replica.get(pod_key)
        reps = ([self._router.replicas[idx]] if idx is not None
                else self._live())
        for rep in reps:
            if rep.killed:
                continue
            try:
                a = rep.transport.allocation(pod_key)
            except ReplicaUnavailable:
                continue
            if a is not None:
                return a
        return None

    def priority_of(self, pod_key: str) -> int:
        a = self.allocation(pod_key)
        return a.priority if a is not None else 0

    def node(self, name: str):
        idx = self._router._node_replica.get(name)
        reps = (
            [self._router.replicas[idx]] if idx is not None
            else self._router.replicas
        )
        for rep in reps:
            if rep.killed:
                continue
            view = rep.transport.node(name)
            if view is not None:
                return view
        return None

    def node_names(self) -> tuple[str, ...]:
        out: list[str] = []
        for rep in self._live():
            try:
                out.extend(rep.transport.node_names())
            except ReplicaUnavailable:
                continue
        return tuple(sorted(out))

    def slice_ids(self) -> list[str]:
        out: list[str] = []
        for rep in self._live():
            try:
                out.extend(rep.transport.slice_ids())
            except ReplicaUnavailable:
                continue
        return sorted(out)

    def utilization(self) -> float:
        used = total = 0
        for rep in self._live():
            try:
                s = rep.transport.summary()
            except ReplicaUnavailable:
                continue
            used += s["used_shares"]
            total += s["total_shares"]
        return used / total if total else 0.0

    def retire(self) -> None:
        for rep in self._router.replicas:
            ext = rep.extender
            if ext is not None:
                ext.state.retire()


class _RouterCycle:
    """Aggregated batch-planner stats in the shape scenario drivers
    read (``extender.cycle.stats()``)."""

    def __init__(self, router: "ShardRouter"):
        self._router = router

    def _stats_rows(self) -> list[tuple[str, dict[str, Any]]]:
        out = []
        for rep in self._router.replicas:
            if rep.killed:
                continue
            try:
                s = rep.transport.summary().get("cycle")
            except ReplicaUnavailable:
                continue
            if s is not None:
                out.append((rep.name, s))
        return out

    @property
    def cycles(self) -> int:
        return sum(p["cycles"] for _, p in self._stats_rows())

    def stats(self) -> dict[str, Any]:
        rows = self._stats_rows()
        per = [p for _, p in rows]
        if not per:
            return {"enabled": False}
        summed = {
            k: sum(p[k] for p in per)
            for k in (
                "cycles", "pods_planned", "queue_depth", "plans_live",
                "assumes", "assume_undos", "fast_patches",
                "fast_rebuilds", "gang_batches", "gang_batch_members",
                "plan_hits", "plan_misses",
            )
        }
        lookups = summed["plan_hits"] + summed["plan_misses"]
        wall_total = sum(p["cycle_wall_total"] for p in per)
        summed.update({
            "enabled": True,
            "replicas": len(per),
            "plan_hit_ratio": (round(summed["plan_hits"] / lookups, 4)
                               if lookups else None),
            "plan_ms_per_pod": (
                round(1000 * wall_total / summed["pods_planned"], 4)
                if summed["pods_planned"] else None
            ),
            "per_replica": {
                name: {
                    "pods_planned": p["pods_planned"],
                    "cycles": p["cycles"],
                    "plan_ms_per_pod": p["plan_ms_per_pod"],
                }
                for name, p in rows
            },
        })
        return summed


class _MergedEvents:
    """Event-journal rollup over the replicas (scenario result code
    reads ``counts_by_reason``; the harness calls ``close``)."""

    def __init__(self, router: "ShardRouter"):
        self._router = router

    def counts_by_reason(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for rep in self._router.replicas:
            if rep.killed:
                continue
            try:
                counts = rep.transport.counts_by_reason()
            except ReplicaUnavailable:
                continue
            for reason, n in counts.items():
                out[reason] = out.get(reason, 0) + n
        return out

    def emit(self, *args, **kwargs) -> None:
        # router-level events land on replica 0's journal (the
        # rendezvous coordinator's channel)
        try:
            self._router.replicas[0].transport.events_emit(*args,
                                                           **kwargs)
        except ReplicaUnavailable:
            log.warning("router event %s lost: replica r0 unreachable",
                        args[0] if args else kwargs.get("reason"))

    def close(self) -> None:
        for rep in self._router.replicas:
            ext = rep.extender
            if ext is not None:
                ext.events.close()


class ShardRouter:
    """N planner replicas behind one decision surface (see module
    docstring). With ``planner_replicas == 1`` every entry point
    delegates verbatim to the sole Extender — the parity gate."""

    def __init__(self, config: GpuKubeConfig, clock=None):
        n = config.planner_replicas
        if n < 1:
            raise ShardError("planner_replicas must be >= 1")
        self.config = config
        self.mode = config.shard_transport
        from tpukube_torch.core.clock import SYSTEM

        self.clock = clock if clock is not None else SYSTEM
        #: ONE eviction bus across replicas: in-process replicas share
        #: it directly (eviction_sink); subprocess replicas queue
        #: locally and the router pulls (pull_evictions) — either way
        #: the harness's / the daemon's single EvictionExecutor drains
        #: every shard's rollback and preemption victims here
        self.pending_evictions: deque[str] = deque()
        self.replicas: list[PlannerReplica] = []
        self._replica_cfgs: list[GpuKubeConfig] = []
        #: every worker transport this router spawned, the respawned ones
        #: too (subprocess mode): a caller can hold each process to its
        #: end after shutdown()
        self.spawned: list[SubprocessTransport] = []
        fake_clock = hasattr(self.clock, "advance")
        for i in range(n):
            rcfg = config
            if n > 1 and config.journal_enabled:
                # per-replica journal segment: each shard's WAL +
                # checkpoints cover exactly its own slice partition
                rcfg = dc_replace(
                    config, journal_path=f"{config.journal_path}.r{i}"
                )
            self._replica_cfgs.append(rcfg)
        if self.mode == "subprocess" and n > 1:
            # the worker daemons start side by side (each spawn is an
            # interpreter start and the package's imports)
            with ThreadPoolExecutor(max_workers=n) as spawn:
                futures = [spawn.submit(self._make_transport, i, rcfg,
                                        fake_clock)
                           for i, rcfg in enumerate(self._replica_cfgs)]
            errors = [f.exception() for f in futures if f.exception()]
            if errors:
                # a worker that failed to spawn leaves no sibling running
                for t in self.spawned:
                    t.close()
                raise errors[0]
            transports = [f.result() for f in futures]
        else:
            transports = [self._make_transport(i, rcfg, fake_clock)
                          for i, rcfg in enumerate(self._replica_cfgs)]
        self.replicas = [PlannerReplica(i, t)
                         for i, t in enumerate(transports)]
        self._n = n
        # fan-out pool of the process transport: calls to DISTINCT
        # replicas run concurrently (one planner process per core — the
        # multi-core speedup); each replica's own connection lock keeps
        # its binds and prepares ordered. None in process: the in-process
        # replicas share one GIL, so a pool would only add switch
        # overhead to the deterministic path.
        self._pool = (ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="tpukube-shard-fanout",
        ) if self.mode == "subprocess" else None)
        self._inflight = 0
        self.health_checks_total = 0
        self.health_failures_total = 0
        self._health_checked_at: Optional[float] = None
        # replica indices whose DrainCoordinator is actively draining:
        # a replica mid-drain is legitimately slow — its
        # decision lock is busy migrating residents — and the health
        # checker must NOT dead-mark it (dead-marking aborts its
        # rendezvous parts and rebuilds state the drain is about to
        # retire anyway). The drain registers intent BEFORE its first
        # eviction tick and clears it when no drain remains active.
        self._drain_intent: set[int] = set()
        self.health_skips_draining_total = 0
        # pod key -> last bound AllocResult, decoded from bind answers
        # (subprocess mode only): lets the federated allocation() serve
        # the lifecycle loop's per-release existence checks without an
        # HTTP read per pod. Advisory — the divergence checkers read
        # allocations() straight from the replicas.
        self._alloc_cache: dict[str, AllocResult] = {}
        # the bind effector in subprocess mode (see binder)
        self._proc_binder = None
        # N=1 parity gate: every entry point delegates VERBATIM to the
        # sole replica's Extender (same objects, same code path). Only
        # the in-process transport has an extender in this process —
        # an N=1 SUBPROCESS router routes normally, over the wire.
        self._sole = (self.replicas[0].extender
                      if n == 1 and self.mode == "inprocess" else None)
        # wire each in-process replica's drain choreography to the
        # router's intent set (subprocess replicas drain behind their
        # own listener; the daemon has no router to shield it, and
        # the health checker there probes /healthz, not the decision
        # lock). No drain (the flag default) wires nothing.
        for rep in self.replicas:
            _ext = rep.extender
            if _ext is not None and getattr(_ext, "drain", None) is not None:
                _ext.drain.attach_router(self, rep.index)
        # router maps only (replica state lives behind each replica's
        # own locks; this leaf lock never nests around them on the
        # mutation path — routing reads replica state lock-free
        # through the epoch-cached snapshots)
        self._lock = threading.RLock()
        self._slice_replica: dict[str, int] = {}
        self._node_replica: dict[str, int] = {}
        self._pod_replica: dict[str, int] = {}
        self._gang_replica: dict[tuple[str, str], int] = {}
        self._dcn: dict[tuple[str, str], _Rendezvous] = {}
        # driver-admitted pods whose owner replica found them
        # unschedulable: attempt counts rotate the next admit to the
        # following replica (the webhook path spills over inline; the
        # admit path has no answer to spill on). Entries retire at
        # bind/release.
        self._pod_attempts: dict[str, int] = {}
        # last scheduling-clock instant the rendezvous janitor ran
        # from the gang-routing path (throttle; see _route_gang)
        self._swept_at: Optional[float] = None
        # rendezvous aborted while participants were unreachable:
        # key -> the replica indices that could NOT be dissolved at
        # abort time. A healed/restarted participant still on the list
        # has its leftover fragment dissolved (even a locally-committed
        # one — death is all-or-nothing), then leaves the list; the
        # key retires when the list empties. Scoping the sentence to
        # the EXACT unreachable replicas means a same-named gang
        # re-created meanwhile on other replicas is never touched.
        self._aborted_dcn: dict[tuple[str, str], set[int]] = {}
        # what path the last restart_replica took ({"replica", "warm",
        # "restored"}; None before any restart): warm=True means the
        # replica's own journal segment replayed, warm=False on a
        # journal-enabled replica means the recovery failure ladder
        # fell back to the cold re-ingest
        self.last_restart: Optional[dict] = None
        # replica index -> (clock instant, gauges): the subprocess
        # routing pre-filter's per-instant memo (see _gauges_of)
        self._gauge_cache: dict[int, tuple[float, dict]] = {}
        # (replica, gang key) -> (clock instant, fit/reservation
        # answer): the subprocess gang-routing memo. A 512-member gang
        # admitted in one burst (one clock instant) must not pay one
        # fit probe + one reservation read PER MEMBER over the wire;
        # staleness within an instant only defers a gang one retry —
        # the reservation itself is taken under the replica's locks.
        self._fit_cache: dict[tuple[int, tuple[str, str]],
                              tuple[float, bool]] = {}
        self._rsv_cache: dict[tuple[int, tuple[str, str]],
                              tuple[float, Optional[dict]]] = {}
        # counters (per-replica metrics/statusz)
        self.rendezvous_prepared = 0
        self.rendezvous_committed = 0
        self.rendezvous_aborted = 0
        self.state = _FederatedState(self)
        self.cycle = (_RouterCycle(self)
                      if config.batch_enabled else None)
        self.events = _MergedEvents(self)
        self.journal = None
        # -- federated observability plane -------------------
        # Router-local trace spans (fan-out timing), route/spillover/
        # rendezvous provenance, and the fan-out flight recorder exist
        # ONLY when the router actually federates (N>1, or any
        # subprocess topology). The N=1 in-process parity gate keeps
        # the router invisible: trace/decisions stay None and the sole
        # Extender's own surfaces serve verbatim (off-is-off — the
        # byte-compat goldens hold).
        self._trace_ids = None
        self._flights: Optional[deque] = None
        if self._sole is not None:
            self.trace = None
            self.decisions = None
        else:
            import itertools

            self._trace_ids = itertools.count(1)
            self.trace = (trace_mod.DecisionTrace(
                capacity=config.trace_capacity,
                path=(f"{config.trace_path}.router"
                      if config.trace_path else None),
                max_sink_bytes=config.trace_sink_max_bytes,
            ) if config.trace_capacity > 0 else None)
            from tpukube_torch.obs.decisions import DecisionLog

            self.decisions = (DecisionLog(
                capacity=config.decisions_capacity,
                sample_rate=config.decisions_sample_rate,
                seed=config.decisions_seed,
                path=(f"{config.decisions_path}.router"
                      if config.decisions_path else None),
                max_sink_bytes=config.decisions_sink_max_bytes,
            ) if config.decisions_enabled else None)
            # bounded ring of recent fan-out requests with sizes and
            # RTTs (/statusz "flights" section) — fed by the subprocess
            # transports' on_wire hook; stays empty in-process
            self._flights = deque(maxlen=256)
            for rep in self.replicas:
                if rep.transport.mode == "subprocess":
                    rep.transport.on_wire = self._record_flight

    def _make_transport(self, index: int, rcfg: GpuKubeConfig,
                        fake_clock: bool):
        if self.mode == "subprocess":
            transport = SubprocessTransport(
                index, rcfg, fake_clock=fake_clock,
                on_down=self._on_transport_down,
            )
            self.spawned.append(transport)
            return transport
        return InProcessTransport(Extender(
            rcfg, clock=self.clock,
            eviction_sink=self.pending_evictions,
        ))

    def _on_transport_down(self, idx: int) -> None:
        """A transport-level connection failure: the daemon is gone (or
        unreachable) mid-call. Mark the replica dead with the SAME
        semantics as ``crash_replica`` — excluded from the federated
        views, rendezvous parts treated as lost by the janitor, warm
        restart via ``restart_replica``."""
        rep = self.replicas[idx]
        if rep.alive or not rep.killed:
            rep.alive = False
            rep.killed = True
            self._drop_dead_alloc_cache(idx)
            log.error("replica %s marked dead (transport failure)",
                      rep.name)

    def _drop_dead_alloc_cache(self, idx: int) -> None:
        """Purge the dead replica's entries from the bind-answer alloc
        cache: the federated ``allocation()`` must stop serving the
        corpse's ledger the moment ``allocations()`` does (the
        dead-shard invariant the chaos checkers assert). Restart
        re-primes the survivors from the pod annotations."""
        with self._lock:
            dead = [k for k, i in self._pod_replica.items()
                    if i == idx]
            for key in dead:
                self._alloc_cache.pop(key, None)

    def _fan_out(self, reps: list[PlannerReplica], fn) -> dict[int, Any]:
        """Run ``fn(rep)`` for each replica — concurrently in subprocess
        mode (the multi-core fan-out), serially in process (one GIL; a
        pool would only reorder the deterministic path). A replica that
        dies mid-call is skipped; its death is already recorded by the
        transport's ``on_down``."""
        out: dict[int, Any] = {}
        if self._pool is not None and len(reps) > 1:
            ctx = trace_mod.TRACE_CONTEXT.get()
            if ctx is not None:
                # ThreadPoolExecutor does not propagate contextvars:
                # re-set the trace context inside each pooled call so
                # the transport stamps the X-Tpukube-Trace header
                inner = fn

                def fn(rep, _inner=inner, _ctx=ctx):
                    tok = trace_mod.TRACE_CONTEXT.set(_ctx)
                    try:
                        return _inner(rep)
                    finally:
                        trace_mod.TRACE_CONTEXT.reset(tok)
            with self._lock:
                self._inflight += 1
            try:
                futures = {rep.index: self._pool.submit(fn, rep)
                           for rep in reps}
                for idx, fut in futures.items():
                    try:
                        out[idx] = fut.result()
                    except ReplicaUnavailable:
                        continue
            finally:
                with self._lock:
                    self._inflight -= 1
            return out
        for rep in reps:
            try:
                out[rep.index] = fn(rep)
            except ReplicaUnavailable:
                continue
        return out

    # -- federated observability helpers ------------------------------------
    def _traced(self, op: str, pod_key: str = "", **fields):
        """Context manager around one fanned operation: allocates a
        trace id, exposes it through ``TRACE_CONTEXT`` (the transport
        stamps it on every request it carries; the workers tag their
        records with it), and records one router span with explicit
        wall-clock bounds on exit — the enclosing slice the merged
        timeline nests worker spans under. A no-op object when router
        tracing is off (N=1 in-process, or trace_capacity 0)."""
        from contextlib import contextmanager

        @contextmanager
        def _span():
            if self.trace is None or self._trace_ids is None:
                yield
                return
            cur = trace_mod.TRACE_CONTEXT.get()
            if cur is not None:
                # nested fan-out (e.g. the sweep inside a gang route):
                # stay on the enclosing trace, allocate a child span
                tid = cur["trace"]
                sid = f"{tid}.{next(self._trace_ids)}"
            else:
                tid = f"t{next(self._trace_ids)}"
                sid = f"{tid}.0"
            tok = trace_mod.TRACE_CONTEXT.set(
                {"trace": tid, "parent": sid})
            t0 = time.time()
            try:
                yield
            finally:
                trace_mod.TRACE_CONTEXT.reset(tok)
                self.trace.span(op, pod_key, trace=tid, span=sid,
                                t0=t0, t1=time.time(), **fields)

        return _span()

    def _decide(self, pod_key: str, stage: str, **fields) -> None:
        """Record one router-side provenance stage (route / spillover /
        rendezvous) when provenance is on and the pod is sampled."""
        dlog = self.decisions
        if dlog is not None and dlog.wants(pod_key):
            dlog.record(pod_key, stage, replica_source="router",
                        **fields)

    def _record_flight(self, idx: int, op: str, tx: int, rx: int,
                       dt: float, codec_used: str = "json") -> None:
        """The subprocess transports' on_wire hook: one bounded ring
        entry per completed request (sizes + RTT) — the /statusz
        flight recorder. Lock-free (one atomic deque append)."""
        flights = self._flights
        if flights is not None:
            entry = {
                "ts": round(time.time(), 3),
                "replica": f"r{idx}",
                "op": op,
                "tx_bytes": tx,
                "rx_bytes": rx,
                "rtt_ms": round(dt * 1000.0, 3),
            }
            if codec_used != "json":
                # tagged only off the JSON default, so the recorder's
                # entry shape is unchanged on the oracle path
                entry["codec"] = codec_used
            flights.append(entry)

    def flights_snapshot(self, limit: int = 64) -> list[dict[str, Any]]:
        """Most recent fan-out requests, oldest first."""
        if self._flights is None:
            return []
        for _ in range(5):
            try:
                out = list(self._flights)
                break
            except RuntimeError:  # deque mutated mid-iteration
                continue
        else:
            out = []
        return out[-limit:]

    def wire_totals(self) -> dict[str, Any]:
        """Cumulative wire bytes across every replica transport (zeros
        in-process — direct dispatch moves no bytes): the bytes-per-
        churn-wave numerator on the driver surface, and the baseline
        a wire codec is judged against."""
        tx = rx = 0
        raw_tx = raw_rx = 0
        codec_name = None
        by_op: dict[str, dict[str, int]] = {}
        per_replica: dict[str, dict[str, int]] = {}
        for rep in self.replicas:
            snap = rep.transport.wire_snapshot() \
                if hasattr(rep.transport, "wire_snapshot") else None
            if not snap:
                continue
            tx += snap["tx"]
            rx += snap["rx"]
            per_replica[rep.name] = {"tx": snap["tx"], "rx": snap["rx"]}
            if "codec" in snap:
                codec_name = snap["codec"]
                raw_tx += snap["raw_tx"]
                raw_rx += snap["raw_rx"]
            for op, cell in snap["by_op"].items():
                agg = by_op.setdefault(
                    op, {"tx": 0, "rx": 0, "calls": 0})
                for k in ("tx", "rx", "calls"):
                    agg[k] += cell[k]
                # codec-tagged cells carry failures/raw counters; fold
                # them in without changing the default cell shape
                if "failures" in cell:
                    agg["failures"] = \
                        agg.get("failures", 0) + cell["failures"]
                if "codec" in cell:
                    agg["codec"] = cell["codec"]
                    agg["raw_tx"] = \
                        agg.get("raw_tx", 0) + cell.get("raw_tx", 0)
                    agg["raw_rx"] = \
                        agg.get("raw_rx", 0) + cell.get("raw_rx", 0)
        doc = {"tx": tx, "rx": rx, "total": tx + rx,
               "per_replica": per_replica, "by_op": by_op}
        if codec_name is not None:
            # bytes the codec kept off the wire and the resulting
            # compression ratio (pre-compression frames / wire bytes)
            doc["codec"] = codec_name
            doc["raw_tx"] = raw_tx
            doc["raw_rx"] = raw_rx
            doc["saved"] = max(0, (raw_tx + raw_rx) - (tx + rx))
            wire_total = tx + rx
            doc["ratio"] = (round((raw_tx + raw_rx) / wire_total, 3)
                            if wire_total else None)
        return doc

    def explain(self, pod_key: str) -> Optional[dict[str, Any]]:
        """Stitched federated /explain: the router's own route /
        spillover / rendezvous stages (including the gang pseudo-key
        chain when the pod belongs to a DCN gang) merged with every
        alive replica's local chain for the pod, rendered as ONE
        document — a DCN gang member's explain names both replicas and
        the rendezvous verdict. N=1 delegates to the sole planner's
        log verbatim (off-is-off)."""
        from tpukube_torch.obs.decisions import explain_doc, merge_stage_events

        if self._sole is not None:
            dlog = self._sole.decisions
            return dlog.explain(pod_key) if dlog is not None else None
        if "/" not in pod_key:
            pod_key = f"default/{pod_key}"
        groups: list[tuple[str, list[dict[str, Any]]]] = []
        if self.decisions is not None:
            router_evs = [dict(ev)
                          for ev in self.decisions.events(pod=pod_key)]
            # the gang's own rendezvous chain lives under its
            # pseudo-key (gang:<ns>/<name>) so EVERY member can pull
            # it — re-key those events onto the asked pod
            gangs = sorted({ev["gang"] for ev in router_evs
                            if ev.get("gang")})
            for gang in gangs:
                for ev in self.decisions.events(pod=f"gang:{gang}"):
                    ev = dict(ev)
                    ev["pod"] = pod_key
                    router_evs.append(ev)
            if router_evs:
                groups.append(("router", router_evs))
        fanned = self._fan_out(
            self._alive(), lambda rep: rep.transport.explain(pod_key)
        )
        for idx in sorted(fanned):
            doc = fanned[idx]
            if doc and doc.get("stages"):
                groups.append(
                    (self.replicas[idx].name, doc["stages"]))
        if not groups:
            return None
        return explain_doc(merge_stage_events(groups), pod_key)

    def events_federated(self, reason=None, pod=None, node=None,
                         since=None, replica=None,
                         limit: Optional[int] = None
                         ) -> list[dict[str, Any]]:
        """Merged event journals across the replica set, every event
        stamped with its source replica, wall-clock ordered — the
        router /events surface and `tpukube-obs events --replica`
        feed."""
        rows: list[dict[str, Any]] = []
        fanned = self._fan_out(
            self._alive(),
            lambda rep: rep.transport.events_query(
                reason=reason, pod=pod, node=node, since=since),
        )
        for idx in sorted(fanned):
            name = self.replicas[idx].name
            for ev in fanned[idx] or []:
                if not isinstance(ev, dict):
                    continue
                ev = dict(ev)
                ev.setdefault("replica", name)
                rows.append(ev)
        if replica is not None:
            rows = [e for e in rows if e.get("replica") == replica]
        rows.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                 str(e.get("replica", ""))))
        if limit is not None:
            rows = rows[-limit:]
        return rows

    def capacity_doc(self, since=None) -> Optional[dict[str, Any]]:
        """The router /capacity surface: N=1 serves the sole planner's
        document verbatim (off-is-off); N>1 stitches EVERY replica's
        answer — a killed or unreachable replica lands in
        ``dead_replicas`` so the merged fleet view degrades loudly
        instead of silently narrowing (never stale, never partial
        without saying so). None when no replica has capacity on."""
        from tpukube_torch.obs.capacity import merge_capacity_docs

        if self._sole is not None:
            cap = self._sole.capacity
            return cap.capacity_doc(since=since) if cap is not None \
                else None
        fanned = self._fan_out(
            self._alive(),
            lambda rep: rep.transport.capacity_doc(since=since),
        )
        per: list[tuple[str, Optional[dict[str, Any]]]] = []
        for rep in self.replicas:
            per.append((rep.name, fanned.get(rep.index)))
        if not any(doc is not None for _, doc in per):
            return None
        return merge_capacity_docs(per)

    def capacity_probe(self, count=None, shape=None,
                       chips_per_pod=1) -> Optional[dict[str, Any]]:
        """The router /capacity/probe surface: fans the read-only
        what-if ask to every replica and merges — the demand fits if
        ANY replica fits it whole; the DCN fallback composes the
        per-replica largest boxes; dead replicas are named in the
        answer (a probe that cannot see a shard must say so)."""
        from tpukube_torch.obs.capacity import merge_probe_docs

        if self._sole is not None:
            cap = self._sole.capacity
            if cap is None:
                return None
            return cap.probe(count=count, shape=shape,
                             chips_per_pod=chips_per_pod)
        fanned = self._fan_out(
            self._alive(),
            lambda rep: rep.transport.capacity_probe(
                count=count, shape=shape, chips_per_pod=chips_per_pod),
        )
        per = [(rep.name, fanned.get(rep.index))
               for rep in self.replicas]
        if not any(doc is not None for _, doc in per):
            return None
        total = (count if count is not None
                 else shape[0] * shape[1] * shape[2])
        return merge_probe_docs(per, {
            "count": count,
            "shape": list(shape) if shape else None,
            "chips": total,
        })

    # -- Extender-surface passthroughs --------------------------------------
    @property
    def evict_precheck(self):
        ext = self.replicas[0].extender
        return ext.evict_precheck if ext is not None else None

    @evict_precheck.setter
    def evict_precheck(self, fn) -> None:
        for rep in self.replicas:
            rep.transport.set_evict_precheck(fn)

    @property
    def binder(self):
        if self.mode == "subprocess":
            return self._proc_binder
        ext = self.replicas[0].extender
        return ext.binder if ext is not None else None

    @binder.setter
    def binder(self, fn) -> None:
        if (fn is not None and self._sole is None
                and not getattr(fn, "globalizes_gang_env", False)):
            # the bind effector writes the alloc annotation the node
            # agent and the pod's downward API read: a rendezvous
            # member's must carry the GLOBAL gang env the bind answer
            # carries (_globalize_gang_env), not its replica's local
            # part — else the in-pod runtime, fed from the apiserver,
            # forms a one-slice collective
            inner = fn

            def fn(alloc, _inner=inner):
                return _inner(self._global_alloc(alloc))

            fn.globalizes_gang_env = True
        if self.mode == "subprocess":
            # a worker daemon has no effector of this process: the router
            # applies it from each bind answer (_after_bind)
            self._proc_binder = fn
        for rep in self.replicas:
            rep.transport.set_binder(fn)

    @property
    def degraded_gate(self):
        ext = self.replicas[0].extender
        return ext.degraded_gate if ext is not None else None

    @degraded_gate.setter
    def degraded_gate(self, fn) -> None:
        for rep in self.replicas:
            rep.transport.set_degraded_gate(fn)

    @property
    def latencies(self) -> dict[str, list[float]]:
        """Merged webhook-latency windows (quantile feeds)."""
        out: dict[str, list[float]] = {}
        for rep in self.replicas:
            if rep.killed:
                continue
            try:
                windows = rep.transport.latencies()
            except ReplicaUnavailable:
                continue
            for handler, window in windows.items():
                out.setdefault(handler, []).extend(window)
        return out

    def _summed(self, field: str) -> int:
        total = 0
        for rep in self.replicas:
            if rep.killed:
                continue
            try:
                total += rep.transport.summary()[field]
            except ReplicaUnavailable:
                continue
        return total

    @property
    def preemptions(self) -> int:
        return self._summed("preemptions")

    @property
    def binds_total(self) -> int:
        return self._summed("binds_total")

    def gang_snapshot(self) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = []
        for rep in self.replicas:
            if rep.killed:
                continue  # a dead shard's reservations died with it
            try:
                out.extend(rep.transport.gang_snapshot())
            except ReplicaUnavailable:
                continue
        return sorted(out, key=lambda g: (g["namespace"], g["group"]))

    def alloc_snapshot(self) -> list[dict[str, Any]]:
        out: list[dict[str, Any]] = []
        for rep in self.replicas:
            if rep.killed:
                continue
            try:
                out.extend(rep.transport.alloc_snapshot())
            except ReplicaUnavailable:
                continue
        return sorted(out, key=lambda a: a["pod"])

    def audit_stats(self) -> dict[str, Any]:
        """Summed snapshot-audit sentinel counters across replicas."""
        rows = []
        for rep in self.replicas:
            if rep.killed:
                continue
            try:
                rows.append(rep.transport.summary()["audit"])
            except ReplicaUnavailable:
                continue
        return {
            "rate": max((r["rate"] for r in rows), default=0.0),
            "checks": sum(r["checks"] for r in rows),
            "divergences": sum(r["divergences"] for r in rows),
        }

    def statusz(self) -> dict[str, Any]:
        """The router's /statusz section: topology + rendezvous state +
        one summary row per replica (the per-replica observability leg
        of the sharded plane; each replica's full extender_statusz
        stays available on its own listener in a real deployment)."""
        with self._lock:
            rendezvous = [
                {
                    "gang": f"{key[0]}/{key[1]}",
                    "committed": rdv.committed,
                    "parts": {
                        self.replicas[idx].name: {
                            sid: len(coords)
                            for sid, coords in parts.items()
                        }
                        for idx, parts in rdv.parts.items()
                    },
                }
                for key, rdv in sorted(self._dcn.items())
            ]
            slice_map = {
                sid: self.replicas[idx].name
                for sid, idx in sorted(self._slice_replica.items())
            }
        per_replica = []
        for rep in self.replicas:
            row = {
                "replica": rep.name,
                "alive": rep.alive,
                "pods_routed": rep.pods_routed,
            }
            summary = None
            if not rep.killed:
                try:
                    summary = rep.transport.summary()
                except ReplicaUnavailable:
                    summary = None
            if summary is None:
                # a dead daemon's ledger died with it: render the row
                # with liveness only, exactly what an operator sees
                row.update({"slices": [], "nodes": 0, "allocs": 0,
                            "binds_total": 0, "utilization": 0.0,
                            "queue_depth": 0, "snapshot_hits": 0,
                            "snapshot_rebuilds": 0})
            else:
                row.update({
                    "slices": summary["slices"],
                    "nodes": summary["nodes"],
                    "allocs": summary["allocs"],
                    "binds_total": summary["binds_total"],
                    "utilization": round(summary["utilization"], 4),
                    "queue_depth": summary["queue_depth"],
                    "snapshot_hits": summary["snapshot_hits"],
                    "snapshot_rebuilds": summary["snapshot_rebuilds"],
                })
                if "lock_graph" in summary:
                    # federated lockgraph: the worker's observed
                    # lock-order edges ride its status row
                    # when the monitor is live (key absent otherwise —
                    # off-is-off)
                    row["lock_graph"] = summary["lock_graph"]
            if self._sole is None and summary is not None:
                # federated per-replica observability sections: each
                # worker's decisions ring / event journal / journal
                # stats, attributed by replica (a dead daemon's row
                # stays liveness-only above)
                try:
                    zdoc = rep.transport.statusz_doc()
                except (ReplicaUnavailable, ShardError):
                    zdoc = None
                if zdoc is not None:
                    row["decisions"] = zdoc.get("decisions")
                    row["events"] = zdoc.get("events")
                    row["journal"] = zdoc.get("journal")
            per_replica.append(row)
        doc = {
            "replicas": per_replica,
            "slice_assignment": slice_map,
            "rendezvous": {
                "live": rendezvous,
                "prepared": self.rendezvous_prepared,
                "committed": self.rendezvous_committed,
                "aborted": self.rendezvous_aborted,
            },
            "transport": self.transport_statusz(),
        }
        with self._lock:
            intent = sorted(self._drain_intent)
            skips = self.health_skips_draining_total
        if intent:
            # present only while a drain shields replicas (off-is-off:
            # no drain, no key — the statusz goldens hold byte-for-byte)
            doc["drain_intent"] = [self.replicas[i].name for i in intent]
        if intent or skips:
            # the drain/health-check race fix's receipt: probes skipped
            # because the replica was shielded by drain intent (can only
            # be nonzero with the drain flag on, so off stays off)
            doc["health_skips_draining_total"] = skips
        if self._sole is None:
            # the router's OWN observability plane (absent under the
            # N=1 in-process parity gate — off-is-off)
            doc["router_obs"] = {
                "trace": (self.trace.stats() if self.trace is not None
                          else {"enabled": False}),
                "decisions": (self.decisions.stats()
                              if self.decisions is not None
                              else {"enabled": False}),
            }
            doc["wire"] = self.wire_totals()
            doc["flights"] = self.flights_snapshot()
        return doc

    def transport_statusz(self) -> dict[str, Any]:
        """The router's transport section: mode, in-flight fan-outs,
        and per-replica link liveness/RTT — the observability leg the
        process mode adds. In-process mode reports the mode alone:
        there is no wire to measure."""
        from tpukube_torch.obs.registry import quantile

        out: dict[str, Any] = {"mode": self.mode}
        if self.mode != "subprocess":
            return out
        with self._lock:
            out["in_flight_fanouts"] = self._inflight
        out["health_checks"] = self.health_checks_total
        out["health_failures"] = self.health_failures_total
        rows = []
        for rep in self.replicas:
            tr = rep.transport
            rtts = tr.rtt_snapshot()
            wire = tr.wire_snapshot()
            rows.append({
                "replica": rep.name,
                "alive": rep.alive,
                "rtt_p50_ms": round(1000 * quantile(rtts, 0.5), 3),
                "rtt_p99_ms": round(1000 * quantile(rtts, 0.99), 3),
                "requests": tr.rtt_count,
                "health_checks": tr.health_checks,
                "health_failures": tr.health_failures,
                "wire_tx_bytes": wire["tx"] if wire else 0,
                "wire_rx_bytes": wire["rx"] if wire else 0,
            })
        out["replicas"] = rows
        return out

    # -- slice / node / pod assignment --------------------------------------
    def _slice_of_payload(self, annotations: dict[str, str]) -> Optional[str]:
        payload = annotations.get(codec.ANNO_NODE_TOPOLOGY)
        if not payload:
            return None
        try:
            obj = json.loads(payload)
        except (TypeError, ValueError):
            return None
        sid = obj.get("slice")
        return sid if isinstance(sid, str) and sid else None

    def _assign_slice_locked(self, sid: str) -> int:
        """Deterministic least-loaded slice→replica assignment: a new
        slice goes to the replica owning the fewest slices (ties break
        on index), so a fleet whose slices register in sorted order —
        the sim and any annotation-synced cluster — balances exactly.
        Recorded in the router map; a production deployment pins the
        same assignment in per-replica config."""
        idx = self._slice_replica.get(sid)
        if idx is None:
            counts = [0] * self._n
            for i in self._slice_replica.values():
                counts[i] += 1
            idx = min(range(self._n), key=lambda i: (counts[i], i))
            self._slice_replica[sid] = idx
            log.info("slice %s assigned to replica %s", sid,
                     self.replicas[idx].name)
        return idx

    def _replica_for_node(
        self, name: str, annotations: Optional[dict[str, str]] = None
    ) -> Optional[int]:
        with self._lock:
            idx = self._node_replica.get(name)
            if idx is not None:
                return idx
            if annotations is None:
                return None
            sid = self._slice_of_payload(annotations)
            if sid is None:
                return None
            idx = self._assign_slice_locked(sid)
            self._node_replica[name] = idx
            return idx

    def _alive(self) -> list[PlannerReplica]:
        return [r for r in self.replicas if r.alive]

    def _hash_replica(self, pod_key: str) -> int:
        return zlib.crc32(pod_key.encode("utf-8")) % self._n

    def _pick_pod_replica(self, pod_key: str,
                          attempts: Optional[int] = None) -> int:
        """Stable hash with liveness fallback: the hash spreads the
        burst plane uniformly; a dead primary falls over to the next
        alive index. Spillover on a FULL primary: the webhook path
        retries the other replicas inline (filter answers), the admit
        path rotates by the pod's recorded failed-plan attempts
        (pass ``attempts`` pre-read to save a lock round-trip on the
        driver hot path — there is ONE rotation policy, not two)."""
        if attempts is None:
            with self._lock:
                attempts = self._pod_attempts.get(pod_key, 0)
        primary = self._hash_replica(pod_key) + attempts
        for off in range(self._n):
            idx = (primary + off) % self._n
            if self.replicas[idx].alive:
                return idx
        raise ShardError("no alive planner replica")

    # -- node partitioning for webhook bodies --------------------------------
    def _partition_nodes(
        self, nodes: list[dict[str, Any]]
    ) -> dict[int, list[dict[str, Any]]]:
        """Split a raw-node webhook body per owning replica (unknown
        names — nodes never annotated — are dropped from every part).
        Only the RAW mode partitions: a replica must never ingest
        another shard's node objects. Names-only bodies forward
        verbatim — the target replica answers its own nodes and
        reports the rest infeasible, which is both correct and O(1)
        under plan-served filter answers (re-partitioning 10k names
        per webhook was a measured router tax)."""
        parts: dict[int, list[dict[str, Any]]] = {}
        for obj in nodes:
            name, annotations = kube.node_name_and_annotations(obj)
            idx = self._replica_for_node(name, annotations)
            if idx is None:
                continue
            parts.setdefault(idx, []).append(obj)
        return parts

    # -- gang routing + two-phase rendezvous ---------------------------------
    def _gang_chips(self, pod: PodInfo) -> Optional[tuple[int, int]]:
        """(chips_per_pod, total chips) for a gang pod, None when the
        request is malformed (the home replica reports the schema
        error exactly as the unsharded path would)."""
        try:
            ask = Extender.device_request(pod)
        except ExtenderError:
            return None  # the routed replica reports the schema error
        if ask is None or pod.group is None:
            return None
        return ask[1], ask[1] * pod.group.min_member

    def _gauges_of(self, rep: PlannerReplica) -> dict[str, dict]:
        """The replica's per-slice capacity gauges. In-process: a
        direct cached-snapshot read (O(slices), free). Subprocess: one
        GET, memoized per scheduling-clock instant — a 512-member gang
        admitted in one batch must not pay 512xN gauge round-trips;
        the full fit probe stays authoritative, so gauge staleness
        within one instant can only defer a gang one retry."""
        if rep.transport.mode == "inprocess":
            return rep.transport.gauges()
        now = self.clock.monotonic()
        with self._lock:
            ent = self._gauge_cache.get(rep.index)
            if ent is not None and ent[0] == now:
                return ent[1]
        gauges = rep.transport.gauges()
        with self._lock:
            self._gauge_cache[rep.index] = (now, gauges)
        return gauges

    def _replica_fits_gang(self, rep: PlannerReplica, pod: PodInfo,
                           total: int) -> bool:
        """Can this replica host the gang ICI-contiguously in ONE of
        its slices? The cheap largest-free-box gauge (cached on the
        replica's snapshot) pre-filters: it can only over-estimate the
        blocked sweep's contiguity, so a replica it rejects cannot fit
        the gang and the full probe — a sweep, and in process mode a
        round-trip — never runs there. The probe itself is the same
        search ``ensure_reservation`` runs, against the replica's
        epoch-cached snapshot."""
        key = (pod.namespace,
               pod.group.name if pod.group is not None else pod.name)
        if rep.transport.mode == "subprocess":
            now = self.clock.monotonic()
            with self._lock:
                ent = self._fit_cache.get((rep.index, key))
            if ent is not None and ent[0] == now:
                return ent[1]
        try:
            gauges = self._gauges_of(rep)
            if all(g["largest_free_box"] < total
                   for g in gauges.values()):
                fits = False
            else:
                fits = rep.transport.gang_fit(pod, total)
        except ReplicaUnavailable:
            return False
        if rep.transport.mode == "subprocess":
            with self._lock:
                self._fit_cache[(rep.index, key)] = (now, fits)
        return fits

    def _route_gang(self, pod: PodInfo) -> int:
        """The gang pod's target replica: its rendezvous participant
        with room, its established home, or — for a new gang — the
        first replica that fits it whole; a gang that fits nowhere and
        opted into DCN gets the two-phase rendezvous. Falls back to
        the emptiest alive replica so error answers (config mistakes,
        genuinely unschedulable gangs) come from a deterministic
        place."""
        assert pod.group is not None
        key = (pod.namespace, pod.group.name)
        # the janitor runs at most once per scheduling-clock instant:
        # a 512-member gang admitted in one batch (one FakeClock tick,
        # one webhook burst) must not pay 512 full rendezvous sweeps —
        # plan_pending() additionally sweeps once per drive
        now = self.clock.monotonic()
        if now != self._swept_at:
            self._swept_at = now
            with self._lock:
                # the per-instant routing memos expire with the instant
                self._fit_cache.clear()
                self._rsv_cache.clear()
                self._gauge_cache.clear()
            self.sweep()
        with self._lock:
            rdv = self._dcn.get(key)
        if rdv is not None:
            idx = self._rendezvous_member_target(rdv, pod)
            if idx is not None:
                return idx
            # every part full: overflow replica — any participant
            # answers it as a normal pod (assignable() is False there)
            for idx in rdv.parts:
                if self.replicas[idx].alive:
                    return idx
        with self._lock:
            home = self._gang_replica.get(key)
        if home is not None and self.replicas[home].alive \
                and self._reservation_routed(self.replicas[home],
                                             key) is not None:
            # sticky only while the home actually HOLDS a reservation:
            # a gang that transiently fit nowhere must re-probe the
            # whole fleet (and the rendezvous) on every retry, not
            # stay pinned to whichever replica owned the error answer
            return home
        ask = self._gang_chips(pod)
        ranked = sorted(
            self._alive(),
            key=lambda r: (self.state_utilization_of(r), r.index),
        )
        if not ranked:
            raise ShardError("no alive planner replica")
        if home is not None and self.replicas[home].alive:
            # prefer the previous home when it still fits — re-probing
            # must not flip a mid-reserve gang between replicas
            ranked.sort(key=lambda r: r.index != home)
        if ask is not None:
            cpp, total = ask
            for rep in ranked:
                if self._replica_fits_gang(rep, pod, total):
                    with self._lock:
                        self._gang_replica[key] = rep.index
                        # the pick is about to consume capacity there:
                        # the NEXT gang routed within this clock
                        # instant must rank against fresh gauges, not
                        # this pick's pre-image
                        self._gauge_cache.pop(rep.index, None)
                    return rep.index
            if pod.group.allow_dcn and pod.group.shape is None \
                    and self._n > 1:
                rdv = self._prepare_rendezvous(pod, cpp, total)
                if rdv is not None:
                    idx = self._rendezvous_member_target(rdv, pod)
                    if idx is not None:
                        return idx
        # nothing fits anywhere (or the request is malformed): the
        # emptiest replica owns the error answer; NOT recorded as a
        # sticky home — the next retry re-probes a changed fleet
        return ranked[0].index

    def state_utilization_of(self, rep: PlannerReplica) -> float:
        """One replica's used-share fraction off its cached snapshot
        gauges (O(slices) — never a ledger walk, and in process mode
        at most one round-trip per clock instant)."""
        try:
            gauges = self._gauges_of(rep)
        except ReplicaUnavailable:
            return 1.0  # unreachable sorts last in emptiest-first orders
        used = sum(g["used_shares"] for g in gauges.values())
        total = sum(g["total_shares"] for g in gauges.values())
        return used / total if total else 0.0

    def _reservation_of(self, rep: PlannerReplica,
                        key: tuple[str, str]) -> Optional[dict]:
        """The replica's reservation record for a gang key (None when
        absent OR when the replica is unreachable — an unreachable
        replica's reservation is exactly as lost as a crashed one's).
        Always a FRESH read: the janitor and the eager commit check
        must see reservation state as of now, never a routing memo."""
        try:
            return rep.transport.gang_reservation(key)
        except ReplicaUnavailable:
            return None

    def _reservation_routed(self, rep: PlannerReplica,
                            key: tuple[str, str]) -> Optional[dict]:
        """The ROUTING path's reservation read, memoized per scheduling
        clock instant over the wire (see _fit_cache): a gang burst's
        members must not pay one reservation round-trip each. A stale
        None only re-ranks through the (also memoized) fit probe to
        the same home; a stale record re-routes a member one retry
        late — both settle within the next instant."""
        if rep.transport.mode != "subprocess":
            return self._reservation_of(rep, key)
        now = self.clock.monotonic()
        with self._lock:
            ent = self._rsv_cache.get((rep.index, key))
        if ent is not None and ent[0] == now:
            return ent[1]
        res = self._reservation_of(rep, key)
        with self._lock:
            self._rsv_cache[(rep.index, key)] = (now, res)
        return res

    def _rendezvous_member_target(
        self, rdv: _Rendezvous, pod: PodInfo
    ) -> Optional[int]:
        """The participant replica this member filters, scores, AND
        binds on: sticky per pod (every webhook of one member must
        land on the part holding its chips), parts filling in
        replica-index order, each capped at its local quorum — the
        driver path admits every member before any binds, so the
        reservation's own room cannot spread them."""
        with self._lock:
            idx = rdv.member_target.get(pod.key())
            if idx is not None and self.replicas[idx].alive:
                return idx
            routed: dict[int, int] = {}
            for i in rdv.member_target.values():
                routed[i] = routed.get(i, 0) + 1
            for i in sorted(rdv.parts):
                if not self.replicas[i].alive:
                    continue
                if routed.get(i, 0) < rdv.local_min.get(i, 0):
                    rdv.member_target[pod.key()] = i
                    return i
        return None

    def _prepare_rendezvous(
        self, pod: PodInfo, cpp: int, total: int
    ) -> Optional[_Rendezvous]:
        assert pod.group is not None
        key = (pod.namespace, pod.group.name)
        with self._traced("rendezvous_prepare", pod.key(),
                          gang=f"{key[0]}/{key[1]}"):
            return self._prepare_rendezvous_inner(pod, cpp, total)

    def _decide_rendezvous(self, pod_key: str, key: tuple[str, str],
                           **fields) -> None:
        """Record one rendezvous stage on the gang's own pseudo-key
        (``gang:<ns>/<name>``) — the stitched /explain re-keys the gang
        chain into EVERY member's answer, so recording it once covers
        the triggering pod and the members that never touched the
        prepare alike (a per-pod copy would render the verdict twice
        for the trigger). ``pod_key`` stays in the signature as the
        trigger attribution carried on the event itself."""
        if self.decisions is None:
            return
        gang = f"{key[0]}/{key[1]}"
        self.decisions.record(f"gang:{gang}", "rendezvous", gang=gang,
                              replica_source="router",
                              trigger=pod_key or None, **fields)

    @staticmethod
    def _rdv_parts_doc(replicas, parts) -> list[dict[str, Any]]:
        return [
            {"replica": replicas[i].name, "slice": sid,
             "chips": len(coords)}
            for i, p in sorted(parts.items())
            for sid, coords in sorted(p.items())
        ]

    def _prepare_rendezvous_inner(
        self, pod: PodInfo, cpp: int, total: int
    ) -> Optional[_Rendezvous]:
        """Phases 1+2 of the rendezvous (see module docstring): plan
        per-replica contiguous parts greedily, PREPARE each part as a
        local reservation, and commit the rendezvous record — or abort
        every prepared part on the first failure. None = the fleet
        cannot cover the gang; the caller serves the home replica's
        no-slice error and the scheduler retries later."""
        assert pod.group is not None
        key = (pod.namespace, pod.group.name)
        # PLAN: greedy over (replica, slice) by emptiness — one box per
        # slice, each a multiple of chips_per_pod, largest first (the
        # cross-replica mirror of GangManager._plan_dcn_split). The
        # plan reads ONLY the cheap per-replica gauges (largest free
        # box / utilization, cached on each replica's snapshot): no
        # full fit probe — a sweep, and in process mode a round-trip —
        # serializes across N replicas here. The gauge bounds each
        # slice's one-box part; the PREPARE leg re-derives the exact
        # coords on the owning replica and shrinks on races.
        candidates: list[tuple[float, str, int, int]] = []
        for rep in self._alive():
            try:
                gauges = self._gauges_of(rep)
            except ReplicaUnavailable:
                continue
            for sid, g in gauges.items():
                box = (g["largest_free_box"] // cpp) * cpp
                if box >= cpp:
                    candidates.append(
                        (g["utilization"], sid, rep.index, box)
                    )
        candidates.sort(key=lambda c: (c[0], c[1]))
        volumes: dict[int, dict[str, int]] = {}
        remaining = total
        for _, sid, idx, box in candidates:
            if remaining == 0:
                break
            vol = min(remaining, box)
            if vol >= cpp:
                volumes.setdefault(idx, {})[sid] = vol
                remaining -= vol
        if remaining != 0 or len(volumes) < 2:
            # len(volumes) < 2 cannot happen when every single replica
            # already failed the whole-gang fit — defensive: a
            # one-replica "rendezvous" is just that replica's own
            # _plan_dcn_split, which its ensure_reservation will run
            return None
        # PREPARE each part under its replica's own locks (ordered per
        # replica — the transport contract); roll back every prepared
        # part on the first failure or on a gauge-raced shortfall (no
        # members have bound, so drop_reservation — not dissolve — is
        # the abort)
        prepared: list[int] = []
        parts: dict[int, dict[str, list[TopologyCoord]]] = {}
        local_min: dict[int, int] = {}
        got_total = 0
        failure: Optional[str] = None
        for idx in sorted(volumes):
            rep = self.replicas[idx]
            try:
                got = rep.transport.gang_prepare(pod, cpp, volumes[idx])
            except Exception as e:
                # any prepare failure aborts every prepared part; only
                # the EXPECTED races (box re-occupied, slice gone,
                # replica died mid-prepare) degrade to "retry next
                # cycle" — anything else is a bug and re-raises after
                # the abort
                log.warning(
                    "rendezvous %s/%s: prepare on %s failed (%s); "
                    "aborting %d prepared part(s)",
                    key[0], key[1], rep.name, e, len(prepared),
                )
                self._abort_prepared(key, prepared)
                self._decide_rendezvous(
                    pod.key(), key, outcome="aborted",
                    reason=f"prepare failed on {rep.name}")
                if not isinstance(
                    e, (GangError, StateError, ReplicaUnavailable)
                ):
                    raise
                return None
            parts[idx] = got
            members = sum(len(c) for c in got.values()) // cpp
            local_min[idx] = members
            got_total += members * cpp
            prepared.append(idx)
        if got_total != total:
            # a gauge over-estimated and the owning replica came up
            # short: all-or-nothing — drop what was reserved, let the
            # scheduler retry against the changed fleet
            log.warning(
                "rendezvous %s/%s: prepared %d of %d chips (gauges "
                "raced occupancy); aborting", key[0], key[1],
                got_total, total,
            )
            self._abort_prepared(key, prepared)
            self._decide_rendezvous(
                pod.key(), key, outcome="aborted",
                reason="gauges raced occupancy")
            return None
        rdv = _Rendezvous(key, parts, local_min,
                          created=self.clock.monotonic())
        with self._lock:
            self._dcn[key] = rdv
            self.rendezvous_prepared += 1
        self.events.emit(
            "GangReserved", obj=f"gang/{key[0]}/{key[1]}",
            message=(
                f"two-phase rendezvous prepared: {total} chips over "
                f"{sum(len(p) for p in parts.values())} slice part(s) "
                f"on {len(parts)} replica(s)"
            ),
        )
        log.info(
            "rendezvous %s/%s prepared: %d chips over replicas %s",
            key[0], key[1], total,
            {self.replicas[i].name: sorted(p) for i, p in parts.items()},
        )
        self._decide_rendezvous(
            pod.key(), key, outcome="prepared", chips=total,
            parts=self._rdv_parts_doc(self.replicas, parts))
        return rdv

    def _abort_prepared(self, key: tuple[str, str],
                        prepared: list[int]) -> None:
        """Drop every prepared (member-less) part of an aborted
        rendezvous prepare and count the abort."""
        for pidx in prepared:
            try:
                self.replicas[pidx].transport.gang_drop(key)
            except ReplicaUnavailable:
                # the replica died holding a member-less reservation:
                # its TTL janitor (or the restart rebuild, which finds
                # no bound members) retires it — nothing leaks
                continue
        with self._lock:
            self.rendezvous_aborted += 1

    def sweep(self) -> list[tuple[str, str]]:
        """The rendezvous janitor (phase 3's abort half), run at the
        top of every gang routing and every batch drive: sweep each
        participant's local TTL/fault janitor, then enforce
        all-or-nothing — an uncommitted rendezvous that lost ANY part
        (TTL rollback, fault, replica killed/partitioned) dissolves
        its surviving parts, evicting their bound members through the
        shared eviction bus. A COMMITTED rendezvous tolerates a dead
        replica: its part is durable in pod annotations and restores
        with the replica. Returns the aborted gang keys."""
        if self.mode == "subprocess":
            # the process-mode janitor legs: detect dead daemons (a
            # failed health check = crash_replica semantics), run every
            # worker's own gang TTL janitor (in-process replicas sweep
            # inside their webhook handling; a worker daemon between
            # webhooks must be swept from here or an expired
            # reservation would linger until its next request), then
            # pull the replica-local eviction queues — INCLUDING any
            # victims those sweeps just rolled back — onto the shared
            # bus
            with self._traced("sweep"):
                self.health_check()
                self._fan_out(self._alive(),
                              lambda rep: rep.transport.gang_sweep())
                self.pull_evictions()
        aborted: list[tuple[str, str]] = []
        with self._lock:
            live = list(self._dcn.items())
        for key, rdv in live:
            held: list[tuple[int, Any]] = []
            lost = False
            for idx in rdv.parts:
                rep = self.replicas[idx]
                if not rep.alive:
                    if not rdv.committed:
                        lost = True
                    continue
                try:
                    rep.transport.gang_sweep()
                    res = rep.transport.gang_reservation(key)
                except ReplicaUnavailable:
                    # died mid-sweep: same as not alive above
                    if not rdv.committed:
                        lost = True
                    continue
                if res is None:
                    lost = True
                else:
                    held.append((idx, res))
            if not rdv.committed and held and not lost \
                    and all(res["committed"] for _, res in held) \
                    and len(held) == len(rdv.parts):
                self._check_rendezvous_commit(rdv)
                continue
            if lost and not rdv.committed:
                for idx, _res in held:
                    try:
                        self.replicas[idx].transport.gang_dissolve(key)
                    except ReplicaUnavailable:
                        continue  # now unreachable: settled on return
                unreachable = {
                    idx for idx in rdv.parts
                    if not self.replicas[idx].alive
                }
                with self._lock:
                    self._dcn.pop(key, None)
                    self._gang_replica.pop(key, None)
                    if unreachable:
                        self._aborted_dcn.setdefault(
                            key, set()).update(unreachable)
                    self.rendezvous_aborted += 1
                aborted.append(key)
                self.events.emit(
                    "GangRollback", obj=f"gang/{key[0]}/{key[1]}",
                    message=(
                        "rendezvous aborted: a part was lost before "
                        "commit (TTL/fault/replica down); surviving "
                        "parts dissolved all-or-nothing"
                    ), type="Warning",
                )
                log.warning("rendezvous %s/%s aborted (part lost "
                            "pre-commit)", key[0], key[1])
                self._decide_rendezvous(
                    "", key, outcome="aborted",
                    reason="part lost pre-commit")
            elif not held and rdv.committed and all(
                self.replicas[idx].alive for idx in rdv.parts
            ):
                # every part released naturally (members finished):
                # the rendezvous record retires
                with self._lock:
                    self._dcn.pop(key, None)
                    self._gang_replica.pop(key, None)
        # retire gang-home entries whose reservation is gone (the gang
        # completed or rolled back): routing already re-probes on a
        # missing reservation, so this is purely the memory bound —
        # unbounded unique gang names must not grow the map forever
        with self._lock:
            homes = [(k, i) for k, i in self._gang_replica.items()
                     if k not in self._dcn]
        for key, idx in homes:
            rep = self.replicas[idx]
            if rep.alive \
                    and self._reservation_of(rep, key) is None:
                with self._lock:
                    if self._gang_replica.get(key) == idx \
                            and key not in self._dcn:
                        self._gang_replica.pop(key, None)
        return aborted

    # -- process-mode janitors ----------------------------------------------
    def health_check(self) -> int:
        """Health-check the subprocess replica set (throttled to once
        per scheduling-clock instant — sweep() runs this at the top of
        every drive and every gang routing). A replica that fails its
        check is marked DEAD with ``crash_replica`` semantics: routed
        around, excluded from the federated views, its uncommitted
        rendezvous parts aborted by the janitor, warm restart via
        ``restart_replica``. Returns how many replicas failed."""
        if self.mode != "subprocess":
            return 0
        now = self.clock.monotonic()
        with self._lock:
            if self._health_checked_at == now:
                return 0
            self._health_checked_at = now
        failed = 0
        with self._traced("health_check"):
            for rep in self.replicas:
                if not rep.alive:
                    continue
                with self._lock:
                    draining = rep.index in self._drain_intent
                if draining:
                    # drain/health-check race: a replica
                    # mid-drain holds its decision lock through
                    # budgeted eviction ticks — slow, not dead.
                    # Dead-marking it would abort its rendezvous
                    # parts and rebuild the very state the drain is
                    # retiring; skip until the drain clears intent.
                    self.health_skips_draining_total += 1
                    continue
                self.health_checks_total += 1
                try:
                    ok = rep.transport.healthz()
                except ReplicaUnavailable:
                    ok = False
                if not ok:
                    failed += 1
                    self.health_failures_total += 1
                    log.error("replica %s failed its health check; "
                              "marking dead (crash_replica semantics)",
                              rep.name)
                    self._mark_replica_dead(rep.index)
        return failed

    def _mark_replica_dead(self, idx: int) -> None:
        """A subprocess replica's daemon is gone/unreachable: its
        in-memory state is unreachable exactly like a killed process's
        — dead, not merely partitioned (a partition is an explicit
        chaos injection; the health checker cannot tell a hung daemon
        from a dead one and must fail to the safe side: rebuild)."""
        rep = self.replicas[idx]
        rep.alive = False
        rep.killed = True
        self._drop_dead_alloc_cache(idx)

    # -- drain intent ----------------------------------------------
    def register_drain_intent(self, idx: int) -> None:
        """A DrainCoordinator on replica ``idx`` is beginning its
        choreography: shield the replica from dead-marking (see
        ``health_check``) until the intent clears."""
        with self._lock:
            self._drain_intent.add(idx)

    def clear_drain_intent(self, idx: int) -> None:
        with self._lock:
            self._drain_intent.discard(idx)

    def pull_evictions(self) -> int:
        """Drain each subprocess replica's local eviction queue onto
        the router's shared bus (in-process replicas write the shared
        deque directly — nothing to pull). The harness's
        drain_evictions and the sweep janitor both run this, so a
        worker-side rollback's victims surface within the round."""
        if self.mode != "subprocess":
            return 0
        pulled = 0
        results = self._fan_out(
            self._alive(), lambda rep: rep.transport.drain_evictions()
        )
        for pods in results.values():
            for pod_key in pods:
                self.pending_evictions.append(pod_key)
                pulled += 1
        return pulled

    def advance_replicas(self, seconds: float) -> None:
        """Fan a FakeClock advance out to every subprocess worker so
        scheduling-semantic time (TTL sweeps, pending expiry) moves in
        lockstep with the router's clock; no-op in-process (shared
        clock object). Simulated time passes EVERYWHERE: a PARTITIONED
        replica still gets the advance (in-process, a partitioned
        replica shares the router's clock — its TTLs keep aging; the
        partition is a routing fiction, not a time freeze), only a
        KILLED process is skipped (gone; its restart re-stamps
        reservations against its fresh clock)."""
        if self.mode != "subprocess":
            return
        self._fan_out(
            [r for r in self.replicas if not r.killed],
            lambda rep: rep.transport.advance(seconds),
        )

    # -- the decision surface -------------------------------------------------
    def handle(self, kind: str, body: Any) -> Any:
        if self._sole is not None:
            return self._sole.handle(kind, body)
        if kind in ("filter", "prioritize"):
            return self._handle_scoring(kind, body)
        if kind == "bind":
            return self._handle_bind(body)
        if kind == "release":
            return self._handle_release(body)
        if kind == "victim_gone":
            cleared = False
            for rep in self._alive():
                try:
                    out = rep.transport.handle(kind, body)
                except ReplicaUnavailable:
                    continue
                cleared = cleared or bool(out.get("cleared"))
            return {"cleared": cleared}
        if kind == "reconcile":
            changed = False
            for rep in self._alive():
                try:
                    if rep.transport.allocation(
                            body["pod_key"]) is None:
                        continue
                    out = rep.transport.handle(kind, body)
                except ReplicaUnavailable:
                    continue
                changed = changed or bool(out.get("changed"))
            return {"changed": changed}
        if kind == "upsert_node":
            idx = self._replica_for_node(
                body["name"], dict(body.get("annotations") or {})
            )
            if idx is None:
                return {"ours": False}
            if not self.replicas[idx].alive:
                return {"error": f"replica {self.replicas[idx].name} "
                                 f"unavailable"}
            try:
                return self.replicas[idx].transport.handle(kind, body)
            except ReplicaUnavailable:
                return {"error": f"replica "
                                 f"{self.replicas[idx].name} died "
                                 f"mid-upsert"}
        raise ValueError(f"unknown decision kind {kind!r}")

    def upsert_nodes_many(
        self, items: list[dict[str, Any]]
    ) -> list[Any]:
        """Batched node ingest: route each {name, annotations} item to
        its owning replica and fan the per-replica batches out
        concurrently — the harness's node sync pays one round-trip per
        replica instead of one per node (at 10k nodes the per-node
        round-trips dominated process-mode setup)."""
        if self._sole is not None:
            return [self._sole.handle("upsert_node", it) for it in items]
        order: dict[int, list[int]] = {}
        results: list[Any] = [None] * len(items)
        for pos, item in enumerate(items):
            idx = self._replica_for_node(
                item["name"], dict(item.get("annotations") or {})
            )
            if idx is None:
                results[pos] = {"ours": False}
                continue
            if not self.replicas[idx].alive:
                results[pos] = {
                    "error": f"replica {self.replicas[idx].name} "
                             f"unavailable"
                }
                continue
            order.setdefault(idx, []).append(pos)
        with self._traced("upsert_nodes", nodes=len(items)):
            out = self._fan_out(
                [self.replicas[i] for i in order],
                lambda rep: rep.transport.upsert_nodes(
                    [items[p] for p in order[rep.index]]
                ),
            )
        for idx, positions in order.items():
            per = out.get(idx)
            for j, pos in enumerate(positions):
                if per is None:  # died mid-batch
                    results[pos] = {
                        "error": f"replica r{idx} died mid-upsert"
                    }
                else:
                    results[pos] = per[j]
        return results

    def _handle_release(self, body: Any) -> Any:
        pod_key = body["pod_key"]
        with self._lock:
            idx = self._pod_replica.pop(pod_key, None)
            self._pod_attempts.pop(pod_key, None)
        targets = (
            [self.replicas[idx]] if idx is not None
            else list(self.replicas)
        )
        with self._traced("release", pod_key):
            for rep in targets:
                if not rep.alive:
                    # a dead replica's release is lost exactly like a
                    # real crashed daemon's: the restart rebuild
                    # (killed) or the post-heal lifecycle resync
                    # (partitioned) re-converges against the pod store
                    continue
                try:
                    rep.transport.handle("release",
                                         {"pod_key": pod_key})
                except ReplicaUnavailable:
                    continue  # died mid-release: same lost-release
                    # contract
        with self._lock:
            self._alloc_cache.pop(pod_key, None)
        return None

    def _handle_scoring(self, kind: str, body: Any) -> Any:
        pod, nodes, names = kube.parse_extender_args(body)
        parts: Optional[dict[int, list]] = None
        if nodes is not None:
            parts = self._partition_nodes(nodes)
            # every owning replica ingests its node objects NOW (the
            # webhook is how topology reaches the caches; only the
            # target replica gets the scoring call, but a later
            # spillover to another replica must find its nodes known).
            # payload_matches makes the unchanged-resend case cheap.
            for idx, pnodes in parts.items():
                rep = self.replicas[idx]
                if not rep.alive:
                    continue
                items = []
                for obj in pnodes:
                    name, annotations = kube.node_name_and_annotations(
                        obj
                    )
                    items.append({"name": name,
                                  "annotations": annotations})
                try:
                    for item, out in zip(items,
                                         rep.transport.upsert_nodes(
                                             items)):
                        if isinstance(out, dict) and out.get("error"):
                            log.error("node %s rejected by %s at "
                                      "ingest: %s", item["name"],
                                      rep.name, out["error"])
                except ReplicaUnavailable:
                    continue  # marked dead; scoring routes around it
        bad_ask = False
        try:
            ask = Extender.device_request(pod)
        except ExtenderError:
            # malformed request (e.g. both TPU and vTPU asked): MUST
            # route to a replica so its handler reports the schema
            # error exactly like the unsharded planner — the non-TPU
            # fast exit below would silently answer it feasible
            # everywhere
            ask = None
            bad_ask = True
        if ask is None and pod.group is None and not bad_ask:
            # non-TPU pod: feasible everywhere, tracked nowhere — no
            # replica needs to see it (matches the unsharded fast exit)
            if names is None and nodes is None:
                # NodesCached body: expand from the federated cache,
                # exactly as the unsharded handler expands from its own
                names = list(self.state.node_names())
            if kind == "prioritize":
                return kube.host_priority_list(
                    {n: 0 for n in (names or [])}
                )
            if nodes is not None:
                return kube.filter_result(list(nodes), {})
            return kube.filter_result_names(list(names or []), {})
        with self._traced(kind, pod.key()):
            if pod.group is not None:
                idx = self._route_gang(pod)
            else:
                with self._lock:
                    idx = self._pod_replica.get(pod.key())
                if idx is None or not self.replicas[idx].alive:
                    idx = self._pick_pod_replica(pod.key())
            return self._score_on(kind, body, pod, parts, idx)

    @staticmethod
    def _sub_body(body: Any, parts: Optional[dict[int, list]],
                  idx: int) -> dict:
        """The body replica ``idx`` sees: its own node objects in raw
        mode; the verbatim body otherwise (a names-only replica
        answers foreign names infeasible on its own — correct, and
        O(1) under plan-served answers)."""
        if parts is None:
            return body
        sub = dict(body)
        sub["Nodes"] = {"Items": parts.get(idx, [])}
        sub.pop("NodeNames", None)
        return sub

    def _score_on(self, kind: str, body: Any, pod: PodInfo,
                  parts: Optional[dict[int, list]], idx: int) -> Any:
        """Forward a filter/prioritize to replica ``idx``. For a
        non-gang filter, spill over to the other alive replicas
        (emptiest first) when the target answers nothing feasible —
        slice affinity routes, the fleet answers. Nodes on other
        shards simply stay out of the feasible set (the upstream
        protocol prunes whatever the answer omits)."""
        def spill_order():
            # built lazily: the common primary-feasible case must not
            # pay O(replicas x slices) utilization reads per webhook
            yield idx
            if kind != "filter" or pod.group is not None:
                return
            for r in sorted(
                self._alive(),
                key=lambda r: (self.state_utilization_of(r), r.index),
            ):
                if r.index != idx:
                    yield r.index

        last_out: Any = None
        for i in spill_order():
            rep = self.replicas[i]
            if not rep.alive or (parts is not None and i not in parts):
                continue
            try:
                out = rep.transport.handle(
                    kind, self._sub_body(body, parts, i)
                )
            except ReplicaUnavailable:
                continue  # died mid-score: spill to the next replica
            if kind == "prioritize":
                return out  # scores for the target's own nodes
            feasible_names = out.get("NodeNames") or []
            last_out = out
            if feasible_names and not out.get("Error"):
                with self._lock:
                    self._pod_replica[pod.key()] = i
                rep.pods_routed += 1
                if i == idx:
                    self._decide(
                        pod.key(), "route", replica=rep.name,
                        feasible=len(feasible_names),
                        **({"gang": f"{pod.namespace}/{pod.group.name}"}
                           if pod.group is not None else {}),
                    )
                else:
                    self._decide(
                        pod.key(), "spillover",
                        primary=self.replicas[idx].name,
                        replica=rep.name,
                        feasible=len(feasible_names),
                    )
                return out
        if last_out is not None:
            return last_out
        if kind == "prioritize":
            return kube.host_priority_list({})
        mk = (kube.filter_result if parts is not None
              else kube.filter_result_names)
        return mk([], {}, error="no alive planner replica owns any "
                                "offered node")

    def _bind_target(self, body: Any) -> tuple[str, Optional[int],
                                               Optional[dict]]:
        """Resolve a bind body to (pod key, owning replica index,
        inline error response). Exactly one of the last two is set."""
        name, ns, uid, node = kube.parse_binding_args(body)
        key = f"{ns}/{name}"
        with self._lock:
            idx = self._node_replica.get(node)
            if idx is None:
                idx = self._pod_replica.get(key)
        if idx is None:
            return key, None, kube.binding_result(
                f"{key}: node {node} is owned by no planner replica"
            )
        rep = self.replicas[idx]
        if not rep.alive:
            return key, None, kube.binding_result(
                f"{key}: replica {rep.name} unavailable (partitioned "
                f"or restarting); scheduler will retry"
            )
        return key, idx, None

    def _after_bind(self, key: str, idx: int, out: Any) -> Any:
        """Post-bind bookkeeping for one replica answer: record the
        pod's affinity, retire its rotation counter, globalize a
        rendezvous member's gang env, and run the eager commit check
        (a replica killed right after the final bind must not read as
        'part lost pre-commit')."""
        if isinstance(out, dict) and not out.get("Error"):
            with self._lock:
                self._pod_replica[key] = idx
                self._pod_attempts.pop(key, None)
                rdv = next(
                    (r for r in self._dcn.values()
                     if key in r.member_target), None,
                )
            if self.mode == "subprocess":
                payload = (out.get("Annotations") or {}).get(
                    codec.ANNO_ALLOC)
                if payload:
                    try:
                        alloc = codec.decode_alloc(payload)
                    except codec.CodecError:
                        alloc = None
                    if alloc is not None:
                        # the federated allocation() fast path: the
                        # lifecycle loop's per-release existence check
                        # answers locally instead of one HTTP read per
                        # released pod (advisory — divergence checks
                        # read the replicas' own ledgers)
                        with self._lock:
                            self._alloc_cache[key] = alloc
            if rdv is not None:
                self._globalize_gang_env(out, rdv)
            if self._proc_binder is not None:
                err = self._apply_proc_binder(key, idx, out)
                if err is not None:
                    return err
            if rdv is not None:
                # EAGER commit check at the bind that may have closed
                # the last part's quorum: waiting for the next janitor
                # sweep leaves a window where a replica killed after
                # the final bind reads as "part lost pre-commit" and
                # the janitor dissolves a fully-committed gang
                self._check_rendezvous_commit(rdv)
        return out

    def _apply_proc_binder(self, key: str, idx: int,
                           out: dict) -> Optional[dict]:
        """Subprocess mode: run the bind effector on the alloc of a bind
        answer, as a replica's extender runs it in process — a rendezvous
        member's with the global gang env the answer now carries. When
        the effector fails the pod is not bound on the cluster: its
        allocation is released on its replica and the answer becomes a
        retryable bind error. Returns that error, else None."""
        payload = (out.get("Annotations") or {}).get(codec.ANNO_ALLOC)
        try:
            alloc = codec.decode_alloc(payload) if payload else None
        except codec.CodecError:
            alloc = None
        if alloc is None:
            return None
        try:
            self._proc_binder(alloc)
        except Exception as e:
            log.error("bind effector for %s failed: %s", key, e)
            self.events.emit(
                "BindFailed", obj=f"pod/{key}",
                message=(f"apiserver bind failed after a successful "
                         f"ledger commit; undone for retry: {e}"),
            )
            try:
                self.replicas[idx].transport.release_many([key])
            except ReplicaUnavailable:
                pass  # the dead replica's ledger is gone with it
            with self._lock:
                self._pod_replica.pop(key, None)
                self._alloc_cache.pop(key, None)
            return kube.binding_result(
                f"{key}: apiserver bind failed: {e}; scheduler will retry")
        return None

    def _handle_bind(self, body: Any) -> Any:
        key, idx, err = self._bind_target(body)
        if err is not None:
            return err
        with self._traced("bind", key):
            try:
                out = self.replicas[idx].transport.handle("bind", body)
            except ReplicaUnavailable:
                return kube.binding_result(
                    f"{key}: replica {self.replicas[idx].name} died "
                    f"mid-bind; scheduler will retry"
                )
        return self._after_bind(key, idx, out)

    def bind_many(self, bodies: list[dict]) -> list[dict]:
        """Batched binds for the driver path: group by owning replica,
        fan the per-replica batches out concurrently (each replica's
        connection keeps ITS binds ordered), then run the same
        post-bind bookkeeping per answer. Answer order matches input
        order. The per-pod webhook path (``handle('bind', ...)``)
        stays untouched — this is how the process mode keeps the
        commit step off the per-pod round-trip ledger."""
        if self._sole is not None:
            return [self._sole.handle("bind", b) for b in bodies]
        results: list[Optional[dict]] = [None] * len(bodies)
        order: dict[int, list[int]] = {}
        keys: list[Optional[str]] = [None] * len(bodies)
        for pos, body in enumerate(bodies):
            key, idx, err = self._bind_target(body)
            keys[pos] = key
            if err is not None:
                results[pos] = err
                continue
            order.setdefault(idx, []).append(pos)
        with self._traced("bind_many", pods=len(bodies)):
            out = self._fan_out(
                [self.replicas[i] for i in order],
                lambda rep: rep.transport.bind_many(
                    [bodies[p] for p in order[rep.index]]
                ),
            )
        for idx, positions in order.items():
            per = out.get(idx)
            for j, pos in enumerate(positions):
                if per is None:
                    results[pos] = kube.binding_result(
                        f"{keys[pos]}: replica r{idx} died mid-bind; "
                        f"scheduler will retry"
                    )
                else:
                    results[pos] = self._after_bind(
                        keys[pos], idx, per[j]
                    )
        return results

    def _check_rendezvous_commit(self, rdv: _Rendezvous) -> None:
        """Flip the rendezvous to committed the moment every part's
        local reservation is committed (idempotent; also run by the
        janitor sweep for the webhook-paced path)."""
        if rdv.committed:
            return
        for idx in rdv.parts:
            rep = self.replicas[idx]
            if not rep.alive:
                return
            res = self._reservation_of(rep, rdv.key)
            if res is None or not res["committed"]:
                return
        rdv.committed = True
        with self._lock:
            self.rendezvous_committed += 1
        self.events.emit(
            "GangCommitted", obj=f"gang/{rdv.key[0]}/{rdv.key[1]}",
            message=(f"rendezvous committed: all {len(rdv.parts)} "
                     f"parts assembled"),
        )
        self._decide_rendezvous(
            "", rdv.key, outcome="committed",
            parts=self._rdv_parts_doc(self.replicas, rdv.parts))

    def _globalize_gang_env(self, out: dict, rdv: _Rendezvous) -> None:
        """A rendezvous member's bind answer carries the TPU_KUBE_GANG_*
        env of its LOCAL part (the replica only knows its own slices);
        rewrite the annotation to the GLOBAL rendezvous topology so the
        in-pod runtime forms the full multislice collective — the same
        contract a single-planner DCN gang's bind stamps."""
        payload = (out.get("Annotations") or {}).get(codec.ANNO_ALLOC)
        if not payload:
            return
        try:
            alloc = codec.decode_alloc(payload)
        except codec.CodecError:
            return
        env = self._global_gang_env(alloc.env, rdv)
        if env is None:
            return
        out["Annotations"][codec.ANNO_ALLOC] = codec.encode_alloc(
            dc_replace(alloc, env=env)
        )

    @staticmethod
    def _global_gang_env(env: dict, rdv: _Rendezvous) -> Optional[dict]:
        """``env`` with its TPU_KUBE_GANG_* keys rewritten from the
        member's LOCAL part to the rendezvous' global topology; None
        when the env names no slice of the rendezvous."""
        from tpukube_torch.device.gpu import (
            ENV_GANG_NUM_SLICES,
            ENV_GANG_SLICE_INDEX,
            ENV_GANG_SLICES,
        )

        # the pod's OWN slice comes from its local index into the
        # part's local slice list — a part may span several slices,
        # so the first local slice is NOT every member's slice
        local_sids = [s for s in env.get(ENV_GANG_SLICES, "").split(",")
                      if s]
        try:
            local_idx = int(env.get(ENV_GANG_SLICE_INDEX, ""))
            local_sid = local_sids[local_idx]
        except (ValueError, IndexError):
            return None
        sids = sorted({
            sid for parts in rdv.parts.values() for sid in parts
        })
        if local_sid not in sids:
            return None
        env = dict(env)
        env[ENV_GANG_NUM_SLICES] = str(len(sids))
        env[ENV_GANG_SLICES] = ",".join(sids)
        env[ENV_GANG_SLICE_INDEX] = str(sids.index(local_sid))
        return env

    def _global_alloc(self, alloc: AllocResult) -> AllocResult:
        """``alloc`` as the bind effector must write it: a rendezvous
        member's with the global gang env, any other unchanged."""
        with self._lock:
            rdv = next((r for r in self._dcn.values()
                        if alloc.pod_key in r.member_target), None)
        env = (self._global_gang_env(alloc.env, rdv)
               if rdv is not None else None)
        return alloc if env is None else dc_replace(alloc, env=env)

    # -- batch-driver surface -------------------------------------------------
    def _route_pod(self, pod: PodInfo) -> int:
        """The target replica for one driver-admitted pod."""
        key = pod.key()
        if pod.group is not None:
            return self._route_gang(pod)
        # one lock round-trip for the whole routing read (this is
        # the per-pod driver hot path)
        with self._lock:
            idx = self._pod_replica.get(key)
            attempts = self._pod_attempts.get(key, 0)
        if idx is None or not self.replicas[idx].alive:
            idx = self._pick_pod_replica(key, attempts)
        return idx

    def admit(self, pod: PodInfo) -> bool:
        if self._sole is not None:
            return self._sole.admit(pod)
        return self.admit_many([pod])[0]

    def admit_many(self, pods: list[PodInfo]) -> list[bool]:
        """Batched admissions: route every pod, then fan ONE admit call
        per target replica out concurrently. Result order matches the
        input. This is the driver hot path the process mode lives on —
        per-pod round-trips would hand the router tax the whole
        multi-core win back."""
        if self._sole is not None:
            return [self._sole.admit(p) for p in pods]
        results: list[bool] = [False] * len(pods)
        order: dict[int, list[int]] = {}
        with self._traced("admit_many", pods=len(pods)):
            for pos, pod in enumerate(pods):
                idx = self._route_pod(pod)
                if not self.replicas[idx].alive:
                    continue
                order.setdefault(idx, []).append(pos)
            out = self._fan_out(
                [self.replicas[i] for i in order],
                lambda rep: rep.transport.admit_many(
                    [pods[p] for p in order[rep.index]]
                ),
            )
        for idx, positions in order.items():
            per = out.get(idx)
            if per is None:
                continue  # replica died mid-admit: pods re-admit later
            rep = self.replicas[idx]
            for j, pos in enumerate(positions):
                ok = bool(per[j])
                results[pos] = ok
                if ok:
                    with self._lock:
                        self._pod_replica[pods[pos].key()] = idx
                    rep.pods_routed += 1
                    self._decide(pods[pos].key(), "route",
                                 replica=rep.name)
        return results

    def plan_pending(self) -> int:
        """Drive every replica's batch planner. In process mode the N
        plan calls fan out CONCURRENTLY — one planner process per core
        actually planning in parallel, the throughput lever the
        in-process sweep could never pull (one GIL)."""
        if self._sole is not None:
            return self._sole.plan_pending()
        self.sweep()
        with self._traced("plan_pending"):
            out = self._fan_out(
                self._alive(), lambda rep: rep.transport.plan_pending()
            )
        return sum(out.values())

    def _planned_miss(self, pod_key: str, idx: int) -> None:
        """Plan failed or expired on the owner: release the affinity
        and bump the attempt count so the next admit rotates to
        another replica instead of re-queuing on the same full shard
        forever."""
        with self._lock:
            if self._pod_replica.get(pod_key) == idx:
                self._pod_replica.pop(pod_key, None)
            self._pod_attempts[pod_key] = \
                self._pod_attempts.get(pod_key, 0) + 1

    def planned_node(self, pod_key: str) -> Optional[str]:
        if self._sole is not None:
            return self._sole.planned_node(pod_key)
        return self.planned_many([pod_key])[pod_key]

    def planned_many(
        self, pod_keys: list[str]
    ) -> dict[str, Optional[str]]:
        """Batched plan queries: keys with a recorded replica affinity
        resolve in one call per replica (fanned out concurrently);
        unmapped keys scan the live set. Misses run the same
        rotation bookkeeping as ``planned_node``."""
        if self._sole is not None:
            return {k: self._sole.planned_node(k) for k in pod_keys}
        results: dict[str, Optional[str]] = {}
        order: dict[int, list[str]] = {}
        unmapped: list[str] = []
        with self._lock:
            affinity = {k: self._pod_replica.get(k) for k in pod_keys}
        for key in pod_keys:
            idx = affinity[key]
            if idx is not None and self.replicas[idx].alive:
                order.setdefault(idx, []).append(key)
            else:
                unmapped.append(key)
        out = self._fan_out(
            [self.replicas[i] for i in order],
            lambda rep: rep.transport.planned_nodes(order[rep.index]),
        )
        for idx, keys in order.items():
            per = out.get(idx)
            for key in keys:
                node = per.get(key) if per is not None else None
                results[key] = node
                if node is None:
                    self._planned_miss(key, idx)
        if unmapped:
            for key in unmapped:
                results[key] = None
            scan = self._fan_out(
                self._alive(),
                lambda rep: rep.transport.planned_nodes(unmapped),
            )
            for nodes in scan.values():
                for key, node in nodes.items():
                    if node is not None and results.get(key) is None:
                        results[key] = node
        return results

    def release(self, pod_key: str) -> None:
        self.handle("release", {"pod_key": pod_key})

    def release_many(self, pod_keys: list[str]) -> None:
        """Batched releases (the lifecycle loop's resync flush): keys
        group by recorded pod->replica affinity and fan out as ONE
        call per replica; keys with no affinity go to every alive
        replica (a release of an unknown pod is a no-op there). Same
        lost-release contract as ``_handle_release`` for dead
        replicas."""
        if self._sole is not None:
            for key in pod_keys:
                self._sole.handle("release", {"pod_key": key})
            return
        order: dict[int, list[str]] = {}
        everywhere: list[str] = []
        with self._lock:
            for key in pod_keys:
                idx = self._pod_replica.pop(key, None)
                self._pod_attempts.pop(key, None)
                self._alloc_cache.pop(key, None)
                if idx is None:
                    everywhere.append(key)
                else:
                    order.setdefault(idx, []).append(key)
        if everywhere:
            for rep in self._alive():
                order.setdefault(rep.index, []).extend(everywhere)
        self._fan_out(
            [self.replicas[i] for i in order
             if self.replicas[i].alive],
            lambda rep: rep.transport.release_many(order[rep.index]),
        )

    # -- restart / recovery ---------------------------------------------------
    def rebuild_from_pods(self, pods: list[dict[str, str]]) -> int:
        """Cold rebuild across the partition: pods route to the
        replica owning their bound node; the pod-group annotations of
        a COMMITTED DCN-rendezvous gang (members spanning >1 replica,
        quorum present) are rewritten to each part's LOCAL member
        count so every part restores committed-verbatim — the
        rendezvous record itself is then re-registered. A PARTIAL
        DCN gang restores with its original annotations, so each part
        rolls its members back: all-or-nothing in death, exactly the
        single-planner restore contract."""
        if self._sole is not None:
            return self._sole.rebuild_from_pods(pods)
        by_replica: dict[int, list[dict[str, str]]] = {}
        gangs: dict[tuple[str, str], list[tuple[int, dict, Any]]] = {}
        skipped = 0
        for annotations in pods:
            payload = annotations.get(codec.ANNO_ALLOC)
            if not payload:
                continue
            try:
                alloc = codec.decode_alloc(payload)
            except codec.CodecError:
                skipped += 1
                continue
            idx = self._replica_for_node(alloc.node_name)
            if idx is None:
                log.error("rebuild: %s bound to unmapped node %s; "
                          "skipped", alloc.pod_key, alloc.node_name)
                skipped += 1
                continue
            by_replica.setdefault(idx, []).append(annotations)
            try:
                group = codec.pod_group_from_annotations(annotations)
            except codec.CodecError:
                group = None
            if group is not None:
                ns = alloc.pod_key.split("/", 1)[0]
                gangs.setdefault((ns, group.name), []).append(
                    (idx, annotations, group)
                )
        rewrites: dict[tuple[str, str], dict[int, int]] = {}
        for key, members in gangs.items():
            replicas_of = {idx for idx, _, _ in members}
            group = members[0][2]
            if len(replicas_of) > 1 and len(members) >= group.min_member:
                # committed DCN gang: each part restores by its LOCAL
                # quorum (the full min_member would read as partial
                # everywhere and roll a healthy gang back)
                counts: dict[int, int] = {}
                for idx, _, _ in members:
                    counts[idx] = counts.get(idx, 0) + 1
                rewrites[key] = counts
                for idx, annotations, g in members:
                    annotations.update(codec.pod_group_annotations(
                        PodGroup(name=g.name,
                                 min_member=counts[idx],
                                 shape=None, allow_dcn=True)
                    ))
        restored = 0
        for idx, plist in sorted(by_replica.items()):
            try:
                restored += self.replicas[idx].transport \
                    .rebuild_from_pods(plist)
            except ReplicaUnavailable:
                log.error("rebuild: replica r%d unreachable; its %d "
                          "pod(s) restore at its own restart", idx,
                          len(plist))
                continue
            with self._lock:
                for annotations in plist:
                    payload = annotations.get(codec.ANNO_ALLOC)
                    if payload:
                        try:
                            alloc = codec.decode_alloc(payload)
                        except codec.CodecError:
                            continue
                        self._pod_replica[alloc.pod_key] = idx
                        if self.mode == "subprocess":
                            self._alloc_cache[alloc.pod_key] = alloc
        for key, counts in rewrites.items():
            parts: dict[int, dict[str, list[TopologyCoord]]] = {}
            for idx in counts:
                res = self._reservation_of(self.replicas[idx], key)
                if res is not None:
                    parts[idx] = res["slices"]
            if len(parts) > 1:
                rdv = _Rendezvous(
                    key, parts,
                    {idx: counts[idx] for idx in parts},
                    created=self.clock.monotonic(),
                )
                rdv.committed = True
                with self._lock:
                    self._dcn[key] = rdv
        return restored

    def replica_pods(self, idx: int,
                     pods: dict[str, dict[str, Any]]) -> list[dict]:
        """The pod store entries bound to replica ``idx``'s nodes (the
        harness's per-replica restart feed)."""
        out = []
        with self._lock:
            owned = {n for n, i in self._node_replica.items()
                     if i == idx}
        for pod in pods.values():
            node = (pod.get("spec") or {}).get("nodeName")
            if node in owned:
                out.append(pod)
        return out

    def kill_replica(self, idx: int) -> None:
        """Model replica process death: everything in-memory on the
        shard — ledger, reservations, queue, plans — is gone; nothing
        is flushed. The router keeps routing around it, the federated
        read views stop serving the corpse's ledger (``killed``), and
        the rendezvous janitor aborts any uncommitted rendezvous
        holding a part there."""
        rep = self.replicas[idx]
        rep.alive = False
        rep.killed = True
        self._drop_dead_alloc_cache(idx)
        ext = rep.extender
        if ext is not None:
            if ext.journal is not None:
                ext.journal.crash()
            ext.state.retire()
        else:
            # subprocess replica: REAL process death (SIGKILL) —
            # nothing modeled, nothing flushed
            rep.transport.kill()

    def partition_replica(self, idx: int) -> None:
        """Model a network partition: the replica's state survives but
        the router cannot reach it — scoring/bind answers route
        around or fail retryably, and an uncommitted rendezvous part
        there counts as lost (all-or-nothing abort)."""
        self.replicas[idx].alive = False

    def heal_replica(self, idx: int) -> None:
        """End a partition: the replica serves again with the state it
        kept — MINUS any fragment of a rendezvous the janitor aborted
        while THIS replica was unreachable (a locally-complete part of
        a dead gang must die all-or-nothing, not resurrect as a
        fragment). The sentence is scoped to the exact replicas that
        were unreachable at abort time, so a same-named gang
        re-created meanwhile on other replicas is never touched.
        Other reservations resolve through the normal janitors."""
        rep = self.replicas[idx]
        rep.alive = True
        self._settle_aborted_parts(idx)

    def _settle_aborted_parts(self, idx: int) -> None:
        """Dissolve replica ``idx``'s leftover fragments of rendezvous
        aborted while it was unreachable, and retire it from every
        pending sentence (heal AND restart both come through here —
        either way the replica's state is now reconciled)."""
        rep = self.replicas[idx]
        with self._lock:
            owed = [key for key, pending in self._aborted_dcn.items()
                    if idx in pending]
        settled = []
        for key in owed:
            if self._reservation_of(rep, key) is not None:
                log.warning(
                    "replica %s returned holding part of aborted "
                    "rendezvous %s/%s; dissolving", rep.name, *key,
                )
                try:
                    rep.transport.gang_dissolve(key)
                except ReplicaUnavailable:
                    continue  # died again: stays on the pending sentence
            settled.append(key)
        with self._lock:
            for key in settled:
                pending = self._aborted_dcn.get(key)
                if pending is not None:
                    pending.discard(idx)
                    if not pending:
                        self._aborted_dcn.pop(key, None)

    def _rewrite_rdv_quorum(
        self, annotations: dict[str, str], ns: Optional[str],
        live_rdv: dict, idx: int,
    ) -> dict[str, str]:
        """A live-rendezvous member's pod-group annotations rewritten
        to the part's LOCAL quorum (the full min_member would read as
        partial on one replica and roll a healthy gang back); anything
        else passes through verbatim. Returns a fresh dict."""
        annotations = dict(annotations)
        try:
            group = codec.pod_group_from_annotations(annotations)
        except codec.CodecError:
            group = None
        if group is not None:
            # the rendezvous key is (namespace, group): an unrelated
            # same-named gang in ANOTHER namespace must not have its
            # quorum rewritten
            if ns is None:
                payload = annotations.get(codec.ANNO_ALLOC)
                if payload:
                    try:
                        ns = codec.decode_alloc(payload).pod_key.split(
                            "/", 1)[0]
                    except codec.CodecError:
                        ns = None
            rdv = (live_rdv.get((ns, group.name))
                   if ns is not None else None)
            if rdv is not None:
                annotations.update(codec.pod_group_annotations(
                    PodGroup(name=group.name,
                             min_member=rdv.local_min[idx],
                             shape=None, allow_dcn=True)
                ))
        return annotations

    def restart_replica(
        self, idx: int,
        node_annotations: list[tuple[str, dict[str, str]]],
        pods: list[dict[str, str]],
        pod_objects: Optional[list[dict]] = None,
    ) -> int:
        """Restart one killed replica the way a restarted shard daemon
        would: a fresh Extender (in-process) or a freshly spawned
        worker daemon (subprocess). With the replica's journal segment
        enabled (and ``pod_objects`` — the full pod objects of the
        shard — provided), the restart REPLAYS the segment first
        (checkpoint + WAL through the real recovery, reconciled
        against the provided node/pod truth) so a warm worker restart
        rides its own durable log instead of a full re-ingest; the
        failure ladder falls back to the cold path — nodes re-ingested,
        ledger + gang reservations rebuilt from pod annotations
        (``rebuild_from_pods``) — on a FRESH replica. Live-rendezvous
        parts restore by their LOCAL quorum either way. Returns
        allocations restored."""
        old = self.replicas[idx]
        fake_clock = hasattr(self.clock, "advance")
        # stat the durable segment BEFORE the fresh replica's journal
        # re-creates the (empty) WAL file: no pre-crash bytes on disk
        # means the warm path has nothing to replay — go cold
        seg = self._replica_cfgs[idx].journal_path
        has_segment = bool(seg) and (
            os.path.exists(seg) or os.path.exists(seg + ".ckpt"))

        def make_transport():
            if self.mode == "subprocess":
                transport = self._make_transport(
                    idx, self._replica_cfgs[idx], fake_clock
                )
                if self._flights is not None:
                    transport.on_wire = self._record_flight
                return transport
            ext = Extender(
                self._replica_cfgs[idx], clock=self.clock,
                eviction_sink=self.pending_evictions,
            )
            # every externally-wired hook survives the restart (a fresh
            # daemon would be re-wired by its main; the router plays
            # that role here) — dropping the degraded gate would let
            # ONE restarted shard bind while the rest of the plane
            # refuses
            ext.evict_precheck = old.extender.evict_precheck
            ext.binder = old.extender.binder
            ext.degraded_gate = old.extender.degraded_gate
            return InProcessTransport(ext)

        if self.mode == "subprocess":
            old.transport.kill()  # reap a half-dead daemon first
        self.replicas[idx] = PlannerReplica(idx, make_transport())
        rep = self.replicas[idx]
        with self._lock:
            live_rdv = {
                key: rdv for key, rdv in self._dcn.items()
                if idx in rdv.parts
            }
        restored: Optional[int] = None
        warm = False
        if (pod_objects is not None
                and self._replica_cfgs[idx].journal_enabled
                and has_segment):
            # warm path: the replica's own journal segment. The feed's
            # rendezvous members carry their LOCAL quorum (the same
            # rewrite the cold plist gets) so the recovery reconcile
            # can never misread a healthy part as partial.
            node_objs = [
                {"metadata": {"name": name,
                              "annotations": dict(annotations)}}
                for name, annotations in node_annotations
            ]
            fixed_pods = []
            for obj in pod_objects:
                meta = dict(obj.get("metadata") or {})
                meta["annotations"] = self._rewrite_rdv_quorum(
                    dict(meta.get("annotations") or {}),
                    meta.get("namespace", "default"), live_rdv, idx,
                )
                fixed_pods.append({**obj, "metadata": meta})
            try:
                out = rep.transport.recover(node_objs, fixed_pods)
            except ReplicaUnavailable:
                out = {"recover_error": "replica unreachable during "
                                        "recovery"}
            err = out.get("recover_error")
            if err is None:
                restored = int(out.get("restored", 0))
                warm = True
                log.warning(
                    "restart r%d: journal segment replayed (%d "
                    "alloc(s) restored warm)", idx, restored)
            else:
                # failure ladder: cold full re-ingest on a FRESH
                # replica (the failed recovery may have half-restored
                # state; a fresh daemon/Extender starts clean)
                log.error("restart r%d: journal recovery failed (%s); "
                          "falling back to the full re-ingest", idx,
                          err)
                if self.mode == "subprocess":
                    rep.transport.kill()
                self.replicas[idx] = PlannerReplica(idx,
                                                    make_transport())
                rep = self.replicas[idx]
        if restored is None:
            items = [{"name": name, "annotations": annotations}
                     for name, annotations in node_annotations]
            for item, out in zip(items,
                                 rep.transport.upsert_nodes(items)):
                if isinstance(out, dict) and out.get("error"):
                    log.error("restart r%d: node %s rejected: %s",
                              idx, item["name"], out["error"])
            plist = [
                self._rewrite_rdv_quorum(annotations, None, live_rdv,
                                         idx)
                for annotations in pods
            ]
            restored = rep.transport.rebuild_from_pods(plist)
            recovered_allocs = []
            for annotations in plist:
                payload = annotations.get(codec.ANNO_ALLOC)
                if payload:
                    try:
                        recovered_allocs.append(
                            codec.decode_alloc(payload))
                    except codec.CodecError:
                        continue
        else:
            # warm path: prime the router maps from what ACTUALLY
            # restored (recovery may have reconciled stale pods away)
            try:
                recovered_allocs = rep.transport.allocations()
            except ReplicaUnavailable:
                recovered_allocs = []
        with self._lock:
            for alloc in recovered_allocs:
                self._pod_replica[alloc.pod_key] = idx
                if self.mode == "subprocess":
                    self._alloc_cache[alloc.pod_key] = alloc
            # which path this restart actually took (tests + operator
            # introspection: a warm=False restart on a journal-enabled
            # replica means the failure ladder fired)
            self.last_restart = {"replica": idx, "warm": warm,
                                 "restored": restored}
        rep.alive = True
        # a restored fragment of a rendezvous aborted while this
        # replica was down dies here (and the replica leaves the
        # pending sentence); then reconcile the rendezvous records
        # against what actually restored (an uncommitted part that
        # could not re-complete rolled back inside restore(); the
        # janitor then aborts the survivors — all-or-nothing)
        self._settle_aborted_parts(idx)
        self.sweep()
        return restored

    def lockgraph_report(self) -> Optional[dict]:
        """The fleet-wide dynamic lock-order report: this process's
        monitor merged with every subprocess replica's edge set (which
        rides ``replica_summary``'s ``lock_graph`` key over the worker
        status surface — no extra wire protocol). None when no monitor
        is installed here (``lock_monitor`` off).

        In-process replicas share THIS process's ref-counted monitor,
        so their summaries report the same graph the router already
        holds — merging them would only double the counts; they are
        counted as reporting and skipped. Cycle detection runs on the
        merged edge multiset: a worker-process inversion (held->acquired
        the other way around on the far side of the HTTP boundary)
        closes a cycle here exactly as a local one would."""
        from tpukube_torch.analysis import lockgraph

        mon = lockgraph.active()
        if mon is None:
            return None
        own = mon.report()
        sites = dict(own["sites"])
        acquisitions = own["acquisitions"]
        merged: dict[tuple[str, str], int] = {
            (e["from"], e["to"]): e["count"] for e in own["edges"]
        }
        reporting = []
        for rep in self.replicas:
            doc = None
            if not rep.killed:
                try:
                    doc = rep.transport.summary()
                except ReplicaUnavailable:
                    doc = None
            lg = (doc or {}).get("lock_graph")
            if lg is None:
                continue
            reporting.append(rep.name)
            if rep.transport.mode == "inprocess":
                continue  # same process, same monitor: already merged
            acquisitions += lg["acquisitions"]
            for site, n in lg["sites"].items():
                sites[site] = sites.get(site, 0) + n
            for e in lg["edges"]:
                key = (e["from"], e["to"])
                merged[key] = merged.get(key, 0) + e["count"]
        return {
            "sites": dict(sorted(sites.items())),
            "acquisitions": acquisitions,
            "edges": [
                {"from": a, "to": b, "count": n}
                for (a, b), n in sorted(merged.items())
            ],
            "cycles": lockgraph.LockOrderMonitor._cycles_of(merged),
            "replicas_reporting": reporting,
        }

    def shutdown(self) -> None:
        """Close every replica (sinks in-process, graceful daemon stop
        in subprocess mode) — the harness stop path. Every worker this
        router spawned has ended when it returns."""
        for rep in self.replicas:
            rep.transport.close()
        for transport in self.spawned:
            transport.close()  # a replaced one was killed already
        if self._pool is not None:
            self._pool.shutdown(wait=False)
        if self.trace is not None:
            self.trace.close()
        if self.decisions is not None:
            self.decisions.close()

    close = shutdown
