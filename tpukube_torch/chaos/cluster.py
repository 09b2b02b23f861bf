"""ChaosSimCluster — a SimCluster whose control-plane seams run through
the fault schedule, plus the convergence checks the chaos scenarios
assert (zero leaked reservations, zero ledger/apiserver divergence): the
port's own copy of ``tpukube/chaos/cluster.py``.

The chaos cluster wires what a hardened production extender wires:

  * the pod store wrapped in :class:`~tpukube_torch.chaos.api.ChaosApiServer`
    (evictions, lifecycle GET-confirms, and the bind effector all take
    injected faults);
  * a real bind effector (``apiserver``-style ``bind_pod``) behind a
    :class:`~tpukube_torch.core.retry.Retrier` +
    :class:`~tpukube_torch.core.retry.CircuitBreaker` — torn bind writes
    retry into idempotency instead of leaving a bound pod the ledger
    forgot;
  * the eviction executor's GET confirms behind the same retry policy;
  * the extender's degraded gate on the apiserver circuit: while the
    circuit is open, /filter and /bind fail safe (no bind, no preemption
    plan) and ``DegradedMode`` lands in the event journal.

On a sharded cluster (``planner_replicas > 1``) ``replica_crash_recover``
kills one planner replica mid-flight and restarts it, reporting the
zero-leak convergence.
"""

from __future__ import annotations

import logging
from random import Random
from typing import Any

from tpukube_torch.apiserver import (
    ApiServerError,
    TERMINAL_PHASES,
    pod_binder,
    transient_api_error,
)
from tpukube_torch.chaos.api import ChaosApiServer
from tpukube_torch.chaos.schedule import FaultSchedule
from tpukube_torch.core import codec, retry
from tpukube_torch.sim.harness import SimCluster

log = logging.getLogger("tpukube_torch.chaos")


class ChaosSimCluster(SimCluster):
    """SimCluster + chaos wiring; see module docstring. ``fault_schedule``
    drives every injection; the retry/circuit knobs come from the
    config's ``retry_*`` / ``circuit_*`` fields (with fast-test
    overrides below, since scenario walls are seconds, not minutes)."""

    # scenario-scale retry/circuit shape: the production defaults wait
    # tens of seconds; the sim exercises the same code paths at ms
    # scale so scenario 8 stays a smoke test
    BIND_POLICY = retry.RetryPolicy(
        max_attempts=6, base_delay=0.001, max_delay=0.01,
        jitter=0.5, deadline=0.0,
    )
    CIRCUIT_THRESHOLD = 3
    CIRCUIT_RESET_S = 0.02

    def __init__(self, config, fault_schedule: FaultSchedule,
                 **kwargs: Any) -> None:
        self._fault_schedule = fault_schedule
        super().__init__(config, **kwargs)

    def _make_store_api(self):
        return ChaosApiServer(super()._make_store_api(),
                              self._fault_schedule)

    def _wire_extender(self) -> None:
        super()._wire_extender()
        threshold = (self.config.circuit_failure_threshold
                     or self.CIRCUIT_THRESHOLD)
        self.circuit = retry.CircuitBreaker(
            failure_threshold=threshold,
            reset_seconds=self.CIRCUIT_RESET_S,
            half_open_probes=self.config.circuit_half_open_probes,
            name="apiserver", journal=self.extender.events,
        )
        self.bind_retrier = retry.Retrier(
            self.BIND_POLICY, name="bind-effector",
            retryable=transient_api_error, circuit=self.circuit,
            rng=Random(self._fault_schedule.seed + 1),
            journal=self.extender.events,
        )
        self.confirm_retrier = retry.Retrier(
            self.BIND_POLICY, name="eviction-confirm",
            retryable=transient_api_error,
            rng=Random(self._fault_schedule.seed + 2),
            journal=self.extender.events,
        )
        # EvictionExecutor GET-confirms through the unified policy
        self._evictions.retrier = self.confirm_retrier
        raw_bind = pod_binder(self._store_api)

        def binder(alloc) -> None:
            try:
                self.bind_retrier.call(lambda: raw_bind(alloc))
            except retry.CircuitOpenError as e:
                raise ApiServerError(str(e)) from e

        self.extender.binder = binder
        # degraded mode: while the apiserver circuit is open the
        # extender fails filter/bind safe instead of planning work it
        # cannot effect
        self.extender.degraded_gate = (
            lambda: ("apiserver circuit open"
                     if self.circuit.is_open() else None)
        )
        # export the channel's retry/circuit counters on /metrics,
        # exactly as the real daemon main wires them
        self.extender.api_retrier = self.bind_retrier
        self.extender.api_circuit = self.circuit

    # fresh-extender metrics/degraded wiring also applies after a
    # scenario-9-style restart: SimCluster.restart_extender calls
    # _wire_extender, so nothing extra is needed here.


def leaked_reservations(cluster: SimCluster) -> list[dict[str, Any]]:
    """Gang reservations that can never complete: uncommitted with zero
    assigned members (a committed gang or one mid-assembly with live
    members is fine — TTL or later binds own those)."""
    leaks = []
    for g in cluster.extender.gang_snapshot():
        if not g["committed"] and g["members_bound"] == 0:
            leaks.append(g)
    return leaks


def ledger_divergence(cluster: SimCluster) -> list[str]:
    """Cross-check the extender's ledger against the pod store (the
    sim's apiserver ground truth). Returns human-readable divergences;
    [] is the scenario acceptance criterion.

      * every live, bound, non-terminal pod with an alloc annotation
        must hold a matching ledger entry (node + device ids);
      * every ledger entry must point at such a pod.

    Terminal-phase pods and unbound pods with annotation residue are
    skipped — those are exactly the states the rebuild/lifecycle
    machinery is documented to skip or release."""
    problems: list[str] = []
    ledger = {a.pod_key: a for a in cluster.extender.state.allocations()}
    seen: set[str] = set()
    for key, pod in sorted(cluster.pods.items()):
        annos = (pod.get("metadata") or {}).get("annotations") or {}
        payload = annos.get(codec.ANNO_ALLOC)
        bound = (pod.get("spec") or {}).get("nodeName")
        phase = (pod.get("status") or {}).get("phase")
        if not payload or not bound or phase in TERMINAL_PHASES:
            continue
        try:
            planned = codec.decode_alloc(payload)
        except codec.CodecError as e:
            problems.append(f"{key}: undecodable alloc annotation: {e}")
            continue
        seen.add(key)
        entry = ledger.get(key)
        if entry is None:
            problems.append(
                f"{key}: bound to {bound} with an alloc annotation but "
                f"absent from the ledger"
            )
            continue
        if entry.node_name != bound:
            problems.append(
                f"{key}: ledger says node {entry.node_name}, pod is "
                f"bound to {bound}"
            )
        if sorted(entry.device_ids) != sorted(planned.device_ids):
            problems.append(
                f"{key}: ledger devices {sorted(entry.device_ids)} != "
                f"annotation devices {sorted(planned.device_ids)}"
            )
    for key in sorted(set(ledger) - seen):
        problems.append(
            f"{key}: in the ledger but no live bound pod carries its "
            f"alloc annotation"
        )
    return problems


def replica_crash_recover(cluster: SimCluster, idx: int,
                          rounds: int = 50) -> dict[str, Any]:
    """Replica chaos: kill ONE planner replica of a sharded cluster
    mid-flight, let the router's rendezvous janitor abort any
    uncommitted rendezvous holding a part there, converge the
    effectors, restart the replica (``SimCluster.restart_replica``),
    and converge again. Returns a report with the aborted rendezvous
    keys, allocations restored, and the post-recovery leak/divergence
    counts — the zero-leak acceptance the caller asserts on."""
    cluster.crash_replica(idx)
    aborted = cluster.extender.sweep()
    converge(cluster, rounds=rounds)
    restored = cluster.restart_replica(idx)
    converge(cluster, rounds=rounds)
    cluster.extender.sweep()
    converge(cluster, rounds=rounds)
    return {
        "replica": idx,
        "rendezvous_aborted": [list(k) for k in aborted],
        "restored_allocs": restored,
        "leaked_reservations": len(leaked_reservations(cluster)),
        "ledger_divergence": len(ledger_divergence(cluster)),
        "audit": cluster.extender.audit_stats(),
    }


def converge(cluster: SimCluster, rounds: int = 50) -> int:
    """Drive the effector loops until quiet (or ``rounds``): evictions
    drained + confirmed, lifecycle resynced. Returns rounds used. Loop
    steps swallow transient (possibly chaos-injected) API errors — the
    real daemons' poll loops do exactly that and try again."""
    for i in range(rounds):
        busy = False
        try:
            busy |= bool(cluster.drain_evictions())
        except ApiServerError as e:
            log.info("converge: eviction drain hit %s; retrying", e)
            busy = True
        try:
            busy |= cluster._lifecycle.check_once()
        except ApiServerError as e:
            log.info("converge: lifecycle resync hit %s; retrying", e)
            busy = True
        if not busy and cluster._evictions.depth() == 0:
            return i + 1
    return rounds
