"""Runnable BASELINE scenarios on the port — its own copy of
``tpukube/sim/scenarios.py``'s scenarios 1-13 and 15.

Each scenario replays one BASELINE.json config against the port's stack
(the extender over HTTP inside ``SimCluster``'s ``with`` block; configs
1-3 additionally walk the device plugin over the ``"inprocess"``
transport: the same v1beta1 bytes as the reference's unix sockets,
without grpcio, which the GPU machine lacks) and returns a JSON-able
result. Scenarios 10 and 12 are the kilonode churn drives:
1,024 and 10,240 nodes on a fake clock, through the batch scheduling
cycle (``sched/cycle.py``), each raising on its own invariants.
Scenarios 8, 9 and 13 are the chaos drives: a seeded apiserver fault
storm (``tpukube_torch/chaos``), an extender crash mid-gang with the cold
restart, and the crash-at-every-journal-seam storm with the durable
journal (``sched/journal.py``) carrying recovery. Scenario 7 drives chip
and link faults through a node agent's telemetry into the extender's
fleet rollup and the SLO evaluator (``obs/slo.py``); scenario 11 is the
multi-tenant serving plane (``tenancy/``) under scenario 8's fault
storm. Scenario 15 is fleet elasticity (``sched/drain.py``,
``sched/autoscale.py``, ``chaos/maintenance.py``): a maintenance storm of
drains, crashes and spot kills (phase A) and the autoscaler's up and down
(phase B).

Scenario 14 is the sharded control plane (``sched/shard.py``): a
multi-slice fleet behind N planner replicas and the router, the same
churn drive as 10 and 12; scenario 15's phase C drains one replica's
whole slice set under the router.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Any, Optional

from tpukube_torch.core.config import GpuKubeConfig, load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.sim.harness import SimCluster

#: knobs that pass through from the process environment into every
#: scenario's canonical config (which would otherwise shadow them). The
#: reference's whole list: a key the port has no field for is not read
_PASSTHROUGH_KEYS = (
    "TPUKUBE_CHAOS_SEED",
    "TPUKUBE_SNAPSHOT_AUDIT_RATE",
    "TPUKUBE_SNAPSHOT_DELTA_ENABLED",
    "TPUKUBE_BATCH_ENABLED",
    "TPUKUBE_BATCH_MAX_PODS",
    "TPUKUBE_CYCLE_INTERVAL_SECONDS",
    "TPUKUBE_TENANCY_ENABLED",
    "TPUKUBE_TENANCY_QUOTAS",
    "TPUKUBE_JOURNAL_ENABLED",
    "TPUKUBE_JOURNAL_PATH",
    "TPUKUBE_CHECKPOINT_INTERVAL_SECONDS",
    "TPUKUBE_JOURNAL_FSYNC",
    "TPUKUBE_DECISIONS_ENABLED",
    "TPUKUBE_DECISIONS_SAMPLE_RATE",
    "TPUKUBE_DECISIONS_PATH",
    "TPUKUBE_PLANNER_REPLICAS",
    "TPUKUBE_FILTER_FROM_PLAN",
    "TPUKUBE_SHARD_TRANSPORT",
    "TPUKUBE_BULK_INGEST_ENABLED",
    "TPUKUBE_GENERATION_LOG_CAPACITY",
    "TPUKUBE_CAPACITY_ENABLED",
    "TPUKUBE_CAPACITY_SAMPLE_INTERVAL_SECONDS",
    "TPUKUBE_CAPACITY_SAMPLES",
    "TPUKUBE_CAPACITY_PATH",
    "TPUKUBE_LOCK_MONITOR",
    "TPUKUBE_DRAIN_ENABLED",
    "TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES",
    "TPUKUBE_DRAIN_TENANT_BUDGET",
    "TPUKUBE_AUTOSCALE_ENABLED",
    "TPUKUBE_AUTOSCALE_MIN_SLICES",
    "TPUKUBE_AUTOSCALE_MAX_SLICES",
    "TPUKUBE_WIRE_CODEC",
    "TPUKUBE_WIRE_COMPRESS_MIN_BYTES",
)

def _env(defaults: dict[str, str]) -> dict[str, str]:
    import os

    env = dict(defaults)
    for key in _PASSTHROUGH_KEYS:
        if os.environ.get(key):
            env[key] = os.environ[key]
    return env


def _audit_stats(c: SimCluster) -> dict[str, Any]:
    """The snapshot audit sentinel's counters for a scenario result
    (all zero when snapshot_audit_rate is 0 — the default)."""
    snaps = c.extender.snapshots
    return {
        "rate": snaps.audit_rate,
        "checks": snaps.audit_checks,
        "divergences": snaps.audit_divergences,
    }


def run(scenario: int, config: GpuKubeConfig | None = None) -> dict[str, Any]:
    """Run one scenario."""
    fn = {
        1: smoke_single_pod,
        2: dp_fanout,
        3: fractional_vtpu,
        4: gang_16,
        5: multi_tenant_northstar,
        6: churn,
        7: fault_telemetry,
        8: apiserver_chaos,
        9: crash_recovery,
        10: kilonode_churn,
        11: tenant_serving,
        12: kilonode10k_churn,
        13: crash_storm,
        14: kilonode_sharded,
        15: maintenance_storm,
    }[scenario]
    t0 = time.perf_counter()
    result = fn(config)
    result.setdefault("wall_s", round(time.perf_counter() - t0, 3))
    result["scenario"] = scenario
    return result


def _metrics(c: SimCluster) -> dict[str, float]:
    with urllib.request.urlopen(f"{c.base_url}/metrics", timeout=5) as r:
        text = r.read().decode()
    return {
        line.split(" ")[0]: float(line.split(" ")[1])
        for line in text.splitlines()
        if line and not line.startswith("#")
    }


def smoke_single_pod(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Config 1: one pod, one chip, full schedule + Allocate walk."""
    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "2,2,1",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    }))
    with SimCluster(cfg, transport="inprocess") as c:
        node, alloc = c.schedule(c.make_pod("smoke", tpu=1))
        env = c.execute_allocation(alloc)
        return {
            "metric": "allocate_smoke",
            "node": node,
            "devices": alloc.device_ids,
            "env_keys": sorted(env),
            "utilization_percent": round(100 * c.utilization(), 2),
        }


def dp_fanout(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Config 2: 4-pod data-parallel job, 1 chip per pod, no topology hint."""
    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "4,2,1",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    }))
    with SimCluster(cfg, transport="inprocess") as c:
        placements = {}
        for i in range(4):
            node, alloc = c.schedule(c.make_pod(f"resnet-{i}", tpu=1))
            c.execute_allocation(alloc)
            placements[f"resnet-{i}"] = node
        return {
            "metric": "dp_fanout",
            "placements": placements,
            "utilization_percent": round(100 * c.utilization(), 2),
        }


def fractional_vtpu(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Config 3: two inference pods share one chip via vTPU shares."""
    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "2,1,1",
        "TPUKUBE_SIM_HOST_BLOCK": "2,1,1",
        "TPUKUBE_SHARES_PER_CHIP": "2",
    }))
    with SimCluster(cfg, vtpu_nodes={"host-0-0-0"},
                    vtpu_shares=cfg.shares_per_chip,
                    transport="inprocess") as c:
        results = []
        for i in range(2):
            node, alloc = c.schedule(c.make_pod(f"infer-{i}", vtpu=1))
            env = c.execute_allocation(alloc)
            results.append({
                "pod": f"infer-{i}",
                "devices": alloc.device_ids,
                "hbm_limit": env.get("TPU_HBM_LIMIT_BYTES"),
            })
        chips = {r["devices"][0].split("-frac")[0] for r in results}
        return {
            "metric": "fractional_vtpu",
            "pods": results,
            "shared_one_chip": len(chips) == 1,
        }


def gang_16(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Config 4: 16-pod gang onto a contiguous box of a 64-chip mesh."""
    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "4,4,4",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    }))
    with SimCluster(cfg, transport="inprocess") as c:
        for i in range(2):
            c.schedule(c.make_pod(f"bg-{i}", tpu=4))
        group = PodGroup("llama-8b", min_member=16)
        coords = []
        for i in range(16):
            _, alloc = c.schedule(
                c.make_pod(f"llama-8b-{i}", tpu=1, priority=10, group=group)
            )
            coords.extend(alloc.coords)
        extents = [
            max(co[a] for co in coords) - min(co[a] for co in coords) + 1
            for a in range(3)
        ]
        m = _metrics(c)
        ex, ey, ez = extents
        return {
            "metric": "gang_16_contiguous",
            "gang_box": extents,
            # a true axis-aligned box: axis extents (not distinct-value
            # counts, which would miss gaps) multiply out to the chip count
            "contiguous": ex * ey * ez == len(set(coords)) == 16,
            "gang_p50_s": round(
                m['gang_schedule_latency_seconds{quantile="0.5"}'], 4),
            "utilization_percent": round(100 * c.utilization(), 2),
        }


def multi_tenant_northstar(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Config 5: the north-star scenario: 80 burst infer
    pods, a 64-pod priority training gang that preempts its way to a
    contiguous slice, then burst backfill to measure utilization."""
    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "8,8,2",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    }))
    with SimCluster(cfg, transport="inprocess") as c:
        for i in range(80):
            c.schedule(c.make_pod(f"infer-{i}", tpu=1, priority=0))
        group = PodGroup("llama-70b", min_member=64)
        for i in range(64):
            c.schedule(c.make_pod(f"train-{i}", tpu=1, priority=100,
                                  group=group))
        fill = 0
        while True:
            try:
                c.schedule(c.make_pod(f"fill-{fill}", tpu=1, priority=0))
                fill += 1
            except RuntimeError:
                break
        m = _metrics(c)
        util = m["tpu_chip_utilization_percent"]
        result = {
            "metric": "cluster_tpu_utilization_percent",
            "value": round(util, 2),
            "unit": "%",
            "vs_baseline": round(util / 95.0, 4),
            "gang_p50_s": round(
                m['gang_schedule_latency_seconds{quantile="0.5"}'], 4),
            "preemptions": int(m["tpukube_preemptions_total"]),
            "pods_placed": int(m["tpukube_binds_total"]),
        }
        # per-phase timeline stats: where scheduling time went, phase by
        # phase, from the run's own decision trace — what explains
        # run-to-run spread
        if c.extender.trace is not None:
            from tpukube_torch.obs import timeline

            result["phases"] = timeline.phase_stats(
                c.extender.trace.events()
            )
        return result


def churn(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Config 6 — steady-state churn: the workload shape the pod-
    lifecycle release loop exists for. A training gang holds half the
    mesh while burst pods continuously FINISH (terminal phase → release
    loop frees the chips, no manual release anywhere) and replacements
    schedule into the freed capacity. Measures utilization stability
    (min across waves — a release leak shows up as the floor dropping)
    and the re-schedule latency p50 (finish → replacement bound)."""
    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "8,8,2",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    }))
    waves, wave_size = 6, 16
    with SimCluster(cfg, transport="inprocess") as c:
        n_chips = sum(m.num_chips for m in c.slices.values())
        group = PodGroup("train", min_member=n_chips // 2)
        for i in range(n_chips // 2):
            c.schedule(c.make_pod(f"train-{i}", tpu=1, priority=100,
                                  group=group))
        burst = 0
        alive: list[str] = []
        while True:
            try:
                c.schedule(c.make_pod(f"burst-{burst}", tpu=1))
                alive.append(f"burst-{burst}")
                burst += 1
            except RuntimeError:
                break
        full = c.utilization()

        util_samples: list[float] = []
        resched: list[float] = []
        released0 = c._lifecycle.released
        for _ in range(waves):
            done, alive = alive[:wave_size], alive[wave_size:]
            for name in done:
                c.complete_pod(name)  # phase Succeeded; object lingers
            util_samples.append(c.utilization())  # the dip
            for _ in range(len(done)):
                t0 = time.perf_counter()
                c.schedule(c.make_pod(f"burst-{burst}", tpu=1))
                resched.append(time.perf_counter() - t0)
                alive.append(f"burst-{burst}")
                burst += 1
            util_samples.append(c.utilization())  # must recover

        recovered = util_samples[1::2]  # post-refill samples
        resched.sort()
        result = {
            "metric": "churn",
            "value": round(100 * min(recovered), 2),
            "unit": "% min utilization after refill",
            "vs_baseline": round(min(recovered) / 0.95, 4),
            "waves": waves,
            "wave_size": wave_size,
            "full_utilization_percent": round(100 * full, 2),
            "util_min_after_refill_percent": round(100 * min(recovered), 2),
            "resched_p50_s": round(resched[len(resched) // 2], 5),
            "resched_p99_s": round(resched[int(len(resched) * 0.99)], 5),
            "lifecycle_releases": c._lifecycle.released - released0,
        }
        # per-phase timeline stats, same key scenario 5 carries: under
        # churn the interesting spread is release -> replacement-bind,
        # and attributing it needs the per-phase view
        if c.extender.trace is not None:
            from tpukube_torch.obs import timeline

            result["phases"] = timeline.phase_stats(
                c.extender.trace.events()
            )
        return result


def kilonode_churn(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 10: the kilonode scale trace —
    1024 nodes / 4096 chips, a committed 256-member training gang, and
    a ~100k-pod burst-churn trace driven through the batched
    scheduling cycles on a discrete-event fake clock: hours of
    simulated churn (waves arrive, run, complete on a simulated
    cadence; TTL sweeps and eviction ages all read the fake clock) in
    seconds of wall time. Every ~100th pod additionally runs the FULL
    per-pod webhook protocol (filter -> prioritize -> bind, in-process)
    so webhook latency quantiles are measured, not inferred.

    ``TPUKUBE_KILONODE_PODS`` scales the trace (default 100000; the
    tests run a shorter trace). Raises on
    invariant violations: gang uncommitted, ledger/store divergence,
    or a pod count short of the target.
    """
    import os

    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "16,16,16",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
        "TPUKUBE_BATCH_ENABLED": "1",
        "TPUKUBE_BATCH_MAX_PODS": "1024",
    }))
    total_target = int(os.environ.get("TPUKUBE_KILONODE_PODS", "100000"))
    return _kilonode_drive(cfg, metric="kilonode_churn",
                           total_target=total_target, gang_size=256)


def kilonode10k_churn(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 12: the 10k-node / 40k-chip
    churn drive — 10240 nodes over a 32x32x40 mesh (40960 chips), a
    committed 512-member training gang placed through the batched gang
    planner, and burst-churn waves through the batched cycles on the
    fake clock, with the incremental snapshot path (delta advance +
    persistent fast-state patching) carrying the per-cycle constant
    that a full O(chips) rebuild would otherwise pay 10x over.

    Reports ``pods_per_sec``, the plan-hit
    ratio, and ``delta_apply_p50_ms`` vs ``rebuild_p50_ms`` — the
    latter measured by forcing full rebuilds on the SAME loaded
    cluster at drive end, so the speedup is apples-to-apples.

    ``TPUKUBE_KILONODE10K_PODS`` scales the trace (default 40000; the
    tests run a shorter trace). Raises on: gang
    uncommitted, ledger/store divergence, LEAKED RESERVATIONS, or a
    pod shortfall."""
    import os

    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "32,32,40",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
        "TPUKUBE_BATCH_ENABLED": "1",
        "TPUKUBE_BATCH_MAX_PODS": "2048",
    }))
    total_target = int(os.environ.get("TPUKUBE_KILONODE10K_PODS",
                                      "40000"))
    return _kilonode_drive(cfg, metric="kilonode10k_churn",
                           total_target=total_target, gang_size=512,
                           max_alive=8192, check_leaks=True,
                           delta_stats=True)


def kilonode_sharded(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 14: the 100k-node sharded drive —
    ``TPUKUBE_SHARD_SLICES`` (default 10) ICI slices of
    ``TPUKUBE_SIM_MESH_DIMS`` (default 32x32x40, i.e. 10,240 nodes /
    40,960 chips each: ~102k nodes / ~410k chips total), partitioned
    across ``TPUKUBE_PLANNER_REPLICAS`` (default 4) planner replicas
    behind the ShardRouter, burst-churned through the batched cycles
    on the fake clock with plan-served filter answers
    (filter_from_plan). The committed training gang routes whole to
    one replica (ICI-contiguous placement stays first choice); the
    webhook-sampled pods measure real p99s through the router.

    The measured wall EXCLUDES fleet minting + the one-time node
    ingest (reported separately as ``setup_s``): at 100k nodes the
    annotation encode/decode is a fixed startup cost, not the
    steady-state throughput the scenario records. Raises on: gang
    uncommitted, ledger/store divergence, leaked reservations, a dead
    replica, or a pod shortfall. ``TPUKUBE_KILONODE100K_PODS`` scales
    the trace (default 40000; a smoke runs a much smaller fleet via the
    env knobs). With ``lock_monitor`` on, ``shard.lock_graph`` carries
    the router's fleet-wide lock-order report (cycles, acquisitions,
    edge count, the replicas that reported)."""
    import os

    from tpukube_torch.core.mesh import MeshSpec

    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": os.environ.get(
            "TPUKUBE_SIM_MESH_DIMS", "32,32,40"),
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
        "TPUKUBE_BATCH_ENABLED": "1",
        "TPUKUBE_BATCH_MAX_PODS": "2048",
        "TPUKUBE_FILTER_FROM_PLAN": "1",
        "TPUKUBE_PLANNER_REPLICAS": os.environ.get(
            "TPUKUBE_PLANNER_REPLICAS", "4"),
    }))
    n_slices = int(os.environ.get("TPUKUBE_SHARD_SLICES", "10"))
    mesh = cfg.sim_mesh()
    slices = {
        f"s{i:02d}": MeshSpec(dims=mesh.dims,
                              host_block=mesh.host_block,
                              torus=mesh.torus)
        for i in range(n_slices)
    }
    total_target = int(os.environ.get("TPUKUBE_KILONODE100K_PODS",
                                      "40000"))
    total_chips = n_slices * mesh.num_chips
    result = _kilonode_drive(
        cfg, metric="kilonode_sharded", total_target=total_target,
        gang_size=min(512, total_chips // 8),
        max_alive=8192, check_leaks=True,
        slices=slices, include_setup=False,
    )
    problems = []
    if any(not r["alive"] for r in result["shard"]["replicas"]):
        problems.append("a planner replica died during the drive")
    if problems:
        raise RuntimeError("kilonode_sharded invariants violated: "
                           + "; ".join(problems))
    return result


def _kilonode_drive(cfg: GpuKubeConfig, metric: str, total_target: int,
                    gang_size: int,
                    max_alive: Optional[int] = None,
                    check_leaks: bool = False,
                    delta_stats: bool = False,
                    slices: Optional[dict] = None,
                    include_setup: bool = True) -> dict[str, Any]:
    """The shared kilonode churn driver (scenarios 10, 12 and 14): a
    committed training gang pins a contiguous block while burst waves
    arrive, run five simulated minutes, and complete, on the fake
    clock through the batched cycles. ``check_leaks`` adds the
    leaked-reservation invariant and ``delta_stats`` the
    snapshot-maintenance numbers (delta-apply p50 vs a forced full
    rebuild p50 measured on the SAME loaded cluster at drive end).

    ``slices`` drives a multi-slice fleet (the sharded scenario's
    shape; the extender is then the ShardRouter when
    planner_replicas > 1), and ``include_setup=False`` excludes fleet
    minting + the initial node sync from the measured wall (reported
    as ``setup_s``) — at 100k nodes the one-time annotation
    encode/decode would otherwise swamp the steady-state number.

    With decision provenance on the result carries ``decisions``: the
    ring's stats and ``overhead_pct``, the record wall as a share of the
    drive wall. With the capacity recorder on it carries
    ``utilization_over_time`` (each sample's fleet utilization),
    ``stranded`` (the stranded-demand rollup) and ``capacity`` (the
    recorder's stats and ``overhead_pct``, its sample wall as a share of
    the drive wall). On the sharded plane it carries ``shard`` (replica
    rows, slice assignment, rendezvous ledger, transport section, and
    ``lock_graph`` with the lock-order monitor on) and ``wire`` (all
    zeros over the in-process transport)."""
    from collections import deque as _deque

    from tpukube_torch.chaos import leaked_reservations, ledger_divergence
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.obs.registry import quantile

    sample_every = 101  # full-webhook-protocol sampling cadence
    clock = FakeClock()
    t0 = time.perf_counter()
    # NodesCached sampled-webhook bodies: after the one-time ingest the
    # kilonode drives stop re-listing O(nodes) names per sampled webhook
    with SimCluster(cfg, clock=clock, in_process=True, slices=slices,
                    cached_node_body=True, transport="inprocess") as c:
        setup_s = None
        if not include_setup:
            c._sync_nodes()  # the one-time node ingest, off the clock
            setup_s = round(time.perf_counter() - t0, 3)
            t0 = time.perf_counter()
        n_nodes = len(c.nodes)
        n_chips = sum(m.num_chips for m in c.slices.values())

        # a long-lived training gang pins a contiguous block while the
        # burst plane churns around it — the config-5 shape at 16x scale
        group = PodGroup("kilotrain", min_member=gang_size)
        gang_pods = [
            c.make_pod(f"kt-{i}", tpu=1, priority=100, group=group)
            for i in range(gang_size)
        ]
        c.schedule_pending(gang_pods)
        scheduled = gang_size
        sampled = 0

        capacity = n_chips - gang_size
        if max_alive is not None:
            # cap the live burst plane below mesh capacity so the
            # completion churn — the release-delta traffic the
            # incremental snapshot path must keep up with — starts
            # early even on a short smoke trace, instead of only after
            # the whole 40k-chip mesh fills
            capacity = min(capacity, max_alive)
        wave = min(cfg.batch_max_pods, capacity // 2)
        alive: _deque[str] = _deque()
        seq = 0
        waves = 0
        while scheduled < total_target:
            waves += 1
            room = capacity - len(alive)
            n = min(wave, room, total_target - scheduled)
            if n > 0:
                batch = []
                for _ in range(n):
                    name = f"burst-{seq}"
                    seq += 1
                    if seq % sample_every == 0:
                        # full per-pod webhook protocol for this one:
                        # filter/prioritize/bind latencies get sampled
                        c.schedule(c.make_pod(name, tpu=1))
                        sampled += 1
                    else:
                        batch.append(c.make_pod(name, tpu=1))
                    alive.append(name)
                if batch:
                    c.schedule_pending(batch)
                scheduled += n
            # the wave runs for five simulated minutes, then enough of
            # the oldest pods complete to make room for the next wave —
            # the mesh stays near-full, the steady-churn shape
            c.advance(300.0)
            done = min(len(alive), max(0, len(alive) + wave - capacity))
            for _ in range(done):
                c.pods.pop(f"default/{alive.popleft()}", None)
            c._lifecycle.check_once()
        wall = time.perf_counter() - t0

        ext = c.extender
        gangs = [g for g in ext.gang_snapshot() if g["group"] == "kilotrain"]
        committed = bool(gangs and gangs[0]["committed"])
        div = ledger_divergence(c)
        webhook_p99_ms = {
            handler: round(1000 * quantile(window, 0.99), 3)
            for handler, window in ext.latencies.items()
        }
        result = {
            "metric": metric,
            "value": round(scheduled / wall, 1),
            "unit": "pods scheduled per second",
            "nodes": n_nodes,
            "chips": n_chips,
            "pods_total": scheduled,
            "pods_sampled_full_protocol": sampled,
            "wall_s": round(wall, 3),
            "pods_per_sec": round(scheduled / wall, 1),
            # the fake clock's whole point: simulated hours per wall
            # second — the compression factor that makes kilonode
            # fleets measurable at all
            "sim_seconds": round(clock.monotonic(), 1),
            "time_compression": round(clock.monotonic() / wall, 1),
            "webhook_p99_ms": webhook_p99_ms,
            "gang_committed": committed,
            "ledger_divergence": len(div),
            "cycle": ext.cycle.stats() if ext.cycle is not None else None,
            "utilization_percent": round(100 * c.utilization(), 2),
        }
        if setup_s is not None:
            result["setup_s"] = setup_s
        # generation-based incremental resync: the per-wave lifecycle
        # reconcile's full-vs-incremental read counts and the
        # wire-shape bytes they moved
        result["resync"] = c._lifecycle.resync_stats()
        statusz = getattr(ext, "statusz", None)
        if statusz is not None:
            # sharded plane: the router topology + rendezvous ledger +
            # per-replica summary rows ride the result
            doc = statusz()
            result["shard"] = {
                "replicas": [
                    {k: r[k] for k in ("replica", "alive", "nodes",
                                       "allocs", "pods_routed",
                                       "binds_total", "utilization")}
                    for r in doc["replicas"]
                ],
                "slice_assignment": doc["slice_assignment"],
                "rendezvous": doc["rendezvous"],
                # the router's transport section: over processes, the
                # replicas' RTTs and health-check counters
                "transport": doc["transport"],
            }
            # federated lockgraph: with lock_monitor on, the router
            # merges its own observed lock-order edges with each
            # subprocess replica's (reported over the worker status
            # surface) and the fleet-wide cycle check rides the result
            lg_fn = getattr(ext, "lockgraph_report", None)
            if lg_fn is not None:
                lg = lg_fn()
                if lg is not None:
                    result["shard"]["lock_graph"] = {
                        "cycles": lg["cycles"],
                        "acquisitions": lg["acquisitions"],
                        "edge_count": len(lg["edges"]),
                        "replicas_reporting": lg["replicas_reporting"],
                    }
        wire_fn = getattr(ext, "wire_totals", None)
        if wire_fn is not None:
            # federated wire-cost accounting: the transport byte bill
            # normalized per churn wave (all zeros over the in-process
            # transport, which moves no bytes)
            wt = wire_fn()
            top = sorted(wt["by_op"].items(),
                         key=lambda kv: -(kv[1]["tx"] + kv[1]["rx"]))
            result["wire"] = {
                "tx_bytes": wt["tx"],
                "rx_bytes": wt["rx"],
                "total_bytes": wt["total"],
                "waves": waves,
                "bytes_per_wave": (round(wt["total"] / waves, 1)
                                   if waves else 0.0),
                "per_replica": wt["per_replica"],
                "top_ops": dict(top[:8]),
            }
            if "codec" in wt:
                # the binary codec: pre-compression frame bytes and the
                # on-wire compression ratio (keys only with the codec
                # on, so the json drive's result is unchanged)
                result["wire"]["codec"] = wt["codec"]
                result["wire"]["raw_bytes"] = wt["raw_tx"] + wt["raw_rx"]
                result["wire"]["saved_bytes"] = wt["saved"]
                result["wire"]["compress_ratio"] = wt["ratio"]
        if ext.decisions is not None:
            # the measured-overhead guard: provenance's cumulative
            # record wall as a fraction of the drive wall
            ds = ext.decisions.stats()
            result["decisions"] = {
                **ds,
                "overhead_pct": (round(100.0 * ds["record_seconds"]
                                       / wall, 3) if wall else None),
            }
        # capacity flight recorder: utilization-over-time + the stranded
        # forensics rollup ride the result, plus the measured recorder
        # overhead (its sample wall as a share of the drive wall)
        cap = getattr(ext, "capacity", None)  # raw extender
        if cap is not None:
            cap_doc = cap.capacity_doc()
        else:  # router surface (federated; None when capacity is off)
            cap_fn = getattr(ext, "capacity_doc", None)
            cap_doc = cap_fn() if cap_fn is not None else None
        if cap_doc is not None:
            result["utilization_over_time"] = [
                (s.get("fleet") or {}).get("utilization")
                for s in cap_doc["samples"]
            ]
            result["stranded"] = cap_doc["stranded"]
            cstats = cap_doc.get("stats") or {}
            secs = cstats.get("sample_seconds")
            result["capacity"] = {
                **cstats,
                "overhead_pct": (
                    round(100.0 * secs / wall, 3)
                    if wall and isinstance(secs, (int, float))
                    else None),
            }
        if delta_stats:
            # the snapshot-maintenance numbers: the O(Δ) delta-advance
            # p50 against a FORCED full-rebuild p50 on the same loaded
            # cluster (invalidate drops the cached snapshot, so the
            # next lookup re-derives every coord set from the ledger —
            # the pre-delta per-epoch cost)
            snaps = ext.snapshots
            applies = snaps.delta_apply_seconds_snapshot()
            # total maintenance cost normalized per cycle, captured
            # BEFORE the forced-rebuild measurement below inflates the
            # rebuild totals
            cycles = ext.cycle.cycles if ext.cycle is not None else 0
            maintain_s = (snaps.delta_apply_seconds_total
                          + snaps.rebuild_seconds_total)
            rebuild_walls = []
            for _ in range(5):
                snaps.invalidate()
                r0 = time.perf_counter()
                snaps.current()
                rebuild_walls.append(time.perf_counter() - r0)
            delta_p50 = quantile(applies, 0.5)
            rebuild_p50 = quantile(rebuild_walls, 0.5)
            result["snapshot"] = {
                "delta_applies": snaps.delta_applies,
                "delta_overflows": snaps.delta_overflows,
                "rebuilds": snaps.rebuilds,
                "snapshot_ms_per_cycle": (
                    round(1000 * maintain_s / cycles, 4) if cycles
                    else None
                ),
                "delta_apply_p50_ms": round(1000 * delta_p50, 4),
                "rebuild_p50_ms": round(1000 * rebuild_p50, 4),
                "delta_speedup": (
                    round(rebuild_p50 / delta_p50, 1)
                    if delta_p50 > 0 else None
                ),
            }
        problems = list(div)
        if check_leaks:
            problems += [str(p) for p in leaked_reservations(c)]
        if not committed:
            problems.append("the kilotrain gang never committed")
        if scheduled < total_target:
            problems.append(
                f"only {scheduled}/{total_target} pods scheduled"
            )
        if problems:
            raise RuntimeError(f"{metric} invariants violated: "
                               + "; ".join(problems[:5]))
        return result


def fault_telemetry(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 7: chip + NVLink faults driven through the WHOLE
    telemetry pipeline — ``inject_fault``/``inject_link_fault`` on a
    real node-agent stack (the sim backend's GpuDeviceManager):

      device layer fault -> HealthSampler transition -> ChipUnhealthy /
      LinkFault journal events + per-chip /metrics series -> node
      re-annotation (health summary) -> extender fleet rollup on
      /statusz -> SLO burn rates from a live /metrics scrape.

    The device-plugin server is built as the node agent builds it but
    not started: the scenario reads its metrics and /statusz documents,
    and no kubelet ever dials it (so no gRPC, which the card's machine
    lacks).
    """
    import os
    import tempfile

    from tpukube_torch.core.config import load_config as _load
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.metrics import MetricsServer, render_plugin_metrics
    from tpukube_torch.obs import events as events_mod
    from tpukube_torch.obs import slo as slo_mod
    from tpukube_torch.obs.events import EventJournal
    from tpukube_torch.obs.health import HealthSampler
    from tpukube_torch.obs.statusz import plugin_statusz
    from tpukube_torch.plugin.server import DevicePluginServer

    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    }))

    def fetch(url: str) -> str:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.read().decode()

    link = ((0, 0, 0), (0, 1, 0))  # intra-host link on host-0-0-0
    with SimCluster(cfg) as c:
        # load the control plane so the SLO histograms hold samples
        group = PodGroup("telemetry-gang", min_member=4)
        for i in range(4):
            c.schedule(c.make_pod(f"tg-{i}", tpu=1, priority=10,
                                  group=group))
        for i in range(4):
            c.schedule(c.make_pod(f"bg-{i}", tpu=1))

        with tempfile.TemporaryDirectory() as td:
            node_cfg = _load(env={
                "TPUKUBE_BACKEND": "sim",
                "TPUKUBE_DEVICE_PLUGIN_DIR": td,
                "TPUKUBE_SIM_MESH_DIMS": ",".join(
                    str(d) for d in cfg.sim_mesh_dims),
                "TPUKUBE_SIM_HOST_BLOCK": ",".join(
                    str(d) for d in cfg.sim_host_block),
            })
            journal_path = os.path.join(td, "events.jsonl")
            journal = EventJournal(path=journal_path)
            with GpuDeviceManager(node_cfg, host="host-0-0-0") as device:
                server = DevicePluginServer(node_cfg, device)
                server.events = journal
                sampler = HealthSampler(device, journal=journal,
                                        poll_seconds=999)
                ms = MetricsServer(
                    lambda: render_plugin_metrics(
                        server, sampler=sampler, events=journal),
                    statusz=lambda: plugin_statusz(
                        server, device=device, sampler=sampler,
                        events=journal),
                )
                ms.start()
                try:
                    sampler.check_once()  # baseline sighting

                    def push_upstream() -> None:
                        # the syncer's job, stepped deterministically:
                        # apply the node's refreshed annotations (incl.
                        # the health summary) through the recorded
                        # upsert_node decision
                        for obj in c.node_objects():
                            if obj["metadata"]["name"] == "host-0-0-0":
                                c.extender.handle("upsert_node", {
                                    "name": "host-0-0-0",
                                    "annotations":
                                        obj["metadata"]["annotations"],
                                })

                    # chip fault + link fault, node-agent side and
                    # scheduler side (as the health watch + syncer would)
                    device.inject_fault(1)
                    chip_flip = sampler.check_once()
                    device.inject_link_fault(*link)
                    link_flip = sampler.check_once()
                    c.inject_fault("host-0-0-0", 1)
                    c.inject_link_fault(*link)
                    push_upstream()

                    degraded_metrics = fetch(
                        f"http://127.0.0.1:{ms.port}/metrics")
                    degraded_statusz = json.loads(
                        fetch(f"{c.base_url}/statusz"))

                    # recovery
                    device.inject_fault(1, healthy=True)
                    device.inject_link_fault(*link, up=True)
                    recovered = sampler.check_once()
                    c.inject_fault("host-0-0-0", 1, healthy=True)
                    c.inject_link_fault(*link, up=True)
                    push_upstream()
                    recovered_statusz = json.loads(
                        fetch(f"{c.base_url}/statusz"))

                    slo_eval = slo_mod.evaluate(
                        fetch(f"{c.base_url}/metrics"))
                finally:
                    ms.stop()
            journal.close()
            event_reasons = [
                e["reason"] for e in events_mod.load(journal_path)
            ]

        chip_series = sum(
            1 for line in degraded_metrics.splitlines()
            if line.startswith("tpukube_chip_")
        )
        fleet_degraded = degraded_statusz["fleet"]["total"]
        fleet_recovered = recovered_statusz["fleet"]["total"]
        return {
            "metric": "fault_telemetry",
            "transitions": {
                "chip_fault": chip_flip,
                "link_fault": link_flip,
                "recovery": recovered,
            },
            "event_reasons": sorted(set(event_reasons)),
            "chip_series_on_node_metrics": chip_series,
            "fleet_degraded": {
                k: fleet_degraded[k]
                for k in ("healthy", "degraded", "unhealthy", "links_down")
            },
            "fleet_recovered": {
                k: fleet_recovered[k]
                for k in ("healthy", "degraded", "unhealthy", "links_down")
            },
            "slo": {
                name: {
                    "burn_rate": entry["burn_rate"],
                    "total": entry["total"],
                }
                for name, entry in slo_eval.items()
            },
        }


def scenario8_storm():
    """Scenario 8's storm spec — ONE definition, reused verbatim by the
    multi-tenant scenario 11 so both run the same fault mix."""
    from tpukube_torch.chaos import ChaosSpec

    return ChaosSpec(
        error_rate=0.12, timeout_rate=0.08, torn_rate=0.10,
        slow_rate=0.05, slow_seconds=0.001,
        gone_rate=0.10, drop_event_rate=0.05, dup_event_rate=0.05,
    )


def apiserver_chaos(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 8: seeded apiserver chaos under gang + burst churn.

    A ChaosSimCluster runs the full control plane — preempting gang,
    burst fill, completion churn — while the fault schedule injects
    503s, transport timeouts, torn writes, and slow responses into the
    eviction / lifecycle / bind-effector seams. A blackout phase
    (every request failing) then trips the apiserver circuit and
    proves degraded mode: filter requests fail SAFE while the circuit
    is open, and scheduling resumes through the half-open probe once
    the chaos stops. Acceptance: zero leaked gang reservations and
    zero ledger/apiserver divergence after the dust settles.
    """
    from tpukube_torch.chaos import (
        ChaosSimCluster,
        ChaosSpec,
        FaultSchedule,
        converge,
        leaked_reservations,
        ledger_divergence,
    )

    # canonical topology; the seed + audit knobs must work WITHOUT
    # --config — _env passes them through from the process environment
    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    }))
    seed = cfg.chaos_seed or 1337
    schedule_ = FaultSchedule(seed, scenario8_storm())

    with ChaosSimCluster(cfg, schedule_) as c:

        def robust(pod, deadline_s: float = 60.0,
                   retry_unschedulable: bool = True):
            """schedule() with the outer retry a real kube-scheduler
            queue provides: degraded-mode refusals wait out the
            circuit's reset window; chaos-exhausted binds,
            victims-terminating gates, and release lag just requeue.
            Each retry also steps the lifecycle loop — the real
            daemon's release watch runs concurrently; the sim steps
            it deterministically."""
            t0 = time.monotonic()
            while True:
                try:
                    return c.schedule(pod)
                except RuntimeError as e:
                    msg = str(e)
                    if not retry_unschedulable and "unschedulable" in msg:
                        raise
                    if time.monotonic() - t0 > deadline_s:
                        raise
                    if "degraded mode" in msg:
                        time.sleep(c.CIRCUIT_RESET_S)
                    try:
                        c._lifecycle.check_once()
                    except RuntimeError:
                        pass  # chaos-injected resync failure; next lap
                    continue

        # fill the mesh with bursts, then a priority gang preempts its
        # way in — evictions, confirms, and binds all under fault fire
        fill = 0
        while True:
            try:
                robust(c.make_pod(f"burst-{fill}", tpu=1),
                       deadline_s=20.0, retry_unschedulable=False)
                fill += 1
            except RuntimeError:
                break
        n_chips = sum(m.num_chips for m in c.slices.values())
        group = PodGroup("storm", min_member=n_chips // 2)
        for i in range(n_chips // 2):
            robust(c.make_pod(f"storm-{i}", tpu=1, priority=100,
                              group=group))

        # churn: survivors finish, replacements land in the freed chips
        survivors = sorted(
            a.pod_key.split("/", 1)[1]
            for a in c.extender.state.allocations()
            if a.pod_key.startswith("default/burst-")
        )
        finished = survivors[:4]
        for name in finished:
            try:
                c.complete_pod(name)
            except RuntimeError:
                pass  # release deferred by an injected fault; converge
        converge(c)
        for i in range(len(finished)):
            robust(c.make_pod(f"refill-{i}", tpu=1), deadline_s=20.0)

        # free one chip BEFORE the blackout so the probe pod passes
        # filter and reaches the (failing) bind effector — a full mesh
        # would answer "unschedulable" without ever touching the
        # circuit
        try:
            c.complete_pod("refill-0")
        except RuntimeError:
            pass
        converge(c)

        # blackout: every apiserver call fails until the circuit opens
        # and the extender fails filter requests safe (degraded mode)
        schedule_.resume(ChaosSpec(error_rate=1.0))
        degraded_before = c.extender.events.counts_by_reason().get(
            "DegradedMode", 0)
        blackout_refused = False
        try:
            c.schedule(c.make_pod("blackout-probe", tpu=1), retries=12)
        except RuntimeError:
            blackout_refused = True
        degraded_refusals = c.extender.events.counts_by_reason().get(
            "DegradedMode", 0) - degraded_before

        # quiet: chaos off, circuit half-opens, scheduling resumes
        schedule_.stop()
        time.sleep(c.CIRCUIT_RESET_S * 2)
        robust(c.make_pod("recovery-probe", tpu=1))
        converge_rounds = converge(c)

        leaks = leaked_reservations(c)
        div = ledger_divergence(c)
        reasons = c.extender.events.counts_by_reason()
        gangs = c.extender.gang_snapshot()
        committed = [g for g in gangs if g["committed"]]
        result = {
            "metric": "apiserver_chaos",
            "value": schedule_.injected(),
            "unit": "faults injected",
            "faults": schedule_.report(),
            "blackout_refused": blackout_refused,
            "degraded_refusals": degraded_refusals,
            "circuit": {
                "opens": c.circuit.opens,
                "state": c.circuit.state(),
            },
            "retry": {
                "bind_attempts": c.bind_retrier.stats.attempts,
                "bind_retries": c.bind_retrier.stats.retries,
                "bind_exhausted": c.bind_retrier.stats.exhausted,
                "retry_exhausted_events": reasons.get("RetryExhausted", 0),
            },
            "gang_committed": bool(committed),
            "preemptions": c.extender.preemptions,
            "converge_rounds": converge_rounds,
            "evictions_pending": c._evictions.depth(),
            "leaked_reservations": len(leaks),
            "ledger_divergence": len(div),
            "snapshot_audit": _audit_stats(c),
            "utilization_percent": round(100 * c.utilization(), 2),
        }
        # the acceptance invariants FAIL the scenario, not just dent a
        # number — a chaos run that leaks is a bug, full stop
        problems = [str(p) for p in leaks] + div
        if c._evictions.depth():
            problems.append(
                f"{c._evictions.depth()} eviction(s) still pending")
        if not committed:
            problems.append("the storm gang never committed")
        if not (blackout_refused and degraded_refusals > 0
                and c.circuit.opens > 0):
            problems.append(
                "blackout did not trip the circuit into degraded mode")
        if problems:
            raise RuntimeError("scenario 8 invariants violated: "
                               + "; ".join(problems))
        return result


def crash_recovery(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 9: extender crash mid-gang-commit + cold restart.

    Half a gang binds, then the extender "process" dies — HTTP gone,
    ledger, reservations, and pending webhook context lost. A fresh
    extender rebuilds from the apiserver (node annotations + live
    bound pods' alloc annotations, via rebuild_from_pods), restoring
    the partial gang as a partial RESERVATION; the remaining members
    then bind and the gang commits. Rebuild residue the restart must
    skip — a finished pod's lingering annotation and an unbound pod's
    partial-failure annotation — is planted up front. The node-agent
    half restarts too: one member's Allocate runs through a device
    plugin that is torn down and re-registered mid-session.
    Acceptance: gang committed, zero leaked reservations, zero ledger
    divergence, recovery within the scenario wall.
    """
    from tpukube_torch.chaos import converge, leaked_reservations, \
        ledger_divergence
    from tpukube_torch.core import codec
    from tpukube_torch.core.types import AllocResult, TopologyCoord

    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    }))
    with SimCluster(cfg, transport="inprocess") as c:
        group = PodGroup("phoenix", min_member=8)
        for i in range(4):
            c.schedule(c.make_pod(f"phoenix-{i}", tpu=1, priority=10,
                                  group=group))

        # rebuild-residue plants: a finished pod whose annotation
        # lingers (chips are free — restoring it would leak) and an
        # unbound pod carrying bind partial-failure residue
        c.schedule(c.make_pod("finished", tpu=1))
        c.pods["default/finished"].setdefault("status", {})[
            "phase"] = "Succeeded"
        residue = c.make_pod("residue", tpu=1)
        residue["metadata"]["annotations"][codec.ANNO_ALLOC] = (
            codec.encode_alloc(AllocResult(
                pod_key="default/residue", node_name="host-0-0-0",
                device_ids=["tpu-0"], coords=[TopologyCoord(0, 0, 0)],
                env={}, priority=0, uid="uid-default-residue",
            ))
        )

        ledger_before = len(c.extender.state.allocations())
        t0 = time.perf_counter()
        c.crash_extender()
        restored = c.restart_extender()
        gangs = c.extender.gang_snapshot()
        partial = [g for g in gangs if g["group"] == "phoenix"]
        restored_partial = bool(
            partial and not partial[0]["committed"]
            and partial[0]["members_bound"] == 4
        )

        # the crashed half's survivors + the rest of the gang
        last_alloc = None
        for i in range(4, 8):
            _, last_alloc = c.schedule(
                c.make_pod(f"phoenix-{i}", tpu=1, priority=10, group=group)
            )
        converge(c)
        recovery_s = time.perf_counter() - t0

        leaks = leaked_reservations(c)
        div = ledger_divergence(c)
        gangs = c.extender.gang_snapshot()
        committed = [g for g in gangs if g["group"] == "phoenix"
                     and g["committed"]]

        # node-agent teardown + cold restart mid-session: the restarted
        # agent re-registers and still serves the planned intent
        env = c.execute_allocation(last_alloc, restart_agent=True)

        result = {
            "metric": "crash_recovery",
            "value": round(recovery_s, 3),
            "unit": "s crash -> ledger converged",
            "recovery_s": round(recovery_s, 3),
            "members_before_crash": 4,
            "ledger_before_crash": ledger_before,
            "restored": restored,
            "partial_gang_restored": restored_partial,
            "gang_committed": bool(committed),
            "leaked_reservations": len(leaks),
            "ledger_divergence": len(div),
            "snapshot_audit": _audit_stats(c),
            "agent_restart_allocate_ok": bool(env),
        }
        problems = [str(p) for p in leaks] + div
        if restored != 4:
            problems.append(
                f"rebuild restored {restored} allocation(s), wanted 4 "
                f"(residue/finished must be skipped)")
        if not restored_partial:
            problems.append("partial gang did not restore as an "
                            "uncommitted reservation")
        if not committed:
            problems.append("gang did not commit after restart")
        if not env:
            problems.append("restarted node agent failed the Allocate")
        if problems:
            raise RuntimeError("scenario 9 invariants violated: "
                               + "; ".join(problems))
        return result


def _complete_quiet(c: SimCluster, name: str) -> None:
    """complete_pod whose lifecycle step may hit an injected apiserver
    fault — the release is deferred, and converge() (the real daemons'
    retrying poll loops) picks it up next lap."""
    try:
        c.complete_pod(name)
    except RuntimeError:
        pass


def tenant_serving(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 11: the multi-tenant serving plane under
    chaos — diurnal burst-infer waves from four synthetic tenants over
    a shared mesh while a committed training gang holds half of it, on
    the fake clock, with scenario 8's fault schedule reused verbatim.

    Shape: an 8x8x2 mesh (128 chips); tenant ``trainer`` commits a
    64-member gang; four burst tenants (``team-0..3``, 18-chip quotas)
    offer phase-shifted sinusoidal demand every simulated hour, far
    above the 64-chip burst plane — the DRF queue order must equalize
    their dominant shares. Mid-run a small priority-50 gang preempts
    its way in (tenant-aware victim choice) and deliberately commits
    slowly, burning the gang-schedule SLO past the page threshold —
    the admission controller then sheds over-share tenants' bursts
    with TenantAdmissionShed journal events.

    Raises on any violation: a tenant over quota at any wave, a
    steady-state max/min dominant-share ratio above 2.0, the training
    gang losing its commit, a shed or denial that is not journaled,
    leaked reservations, or ledger divergence.
    ``TPUKUBE_TENANCY_WAVES`` scales the trace (default 8)."""
    import math
    import os

    from tpukube_torch.chaos import (
        ChaosSimCluster,
        FaultSchedule,
        converge,
        leaked_reservations,
        ledger_divergence,
    )
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.sched import kube

    teams = [f"team-{i}" for i in range(4)]
    cfg = config or load_config(env=_env({
        "TPUKUBE_SIM_MESH_DIMS": "8,8,2",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
        "TPUKUBE_BATCH_ENABLED": "1",
        "TPUKUBE_TENANCY_ENABLED": "1",
        "TPUKUBE_TENANCY_QUOTAS": "trainer=chips:72;" + ";".join(
            f"{t}=chips:18,hbm:0.2" for t in teams
        ),
        # burn windows ride the fake clock: hourly waves need a
        # window wide enough that a wave gap is not an "idle reset"
        # (BurnMonitor resets past two windows of silence)
        "TPUKUBE_TENANCY_BURN_WINDOW_SECONDS": "3600",
        # decision provenance on: a shed pod's explain output must name
        # the burning SLO and the tenant's share — asserted below
        # against the actual sheds
        "TPUKUBE_DECISIONS_ENABLED": "1",
    }))
    waves = int(os.environ.get("TPUKUBE_TENANCY_WAVES", "8"))
    steady = [w for w in (2, 3, 4) if w < waves]
    burn_wave = 5  # the slow-commit SLO event
    seed = cfg.chaos_seed or 1337
    schedule_ = FaultSchedule(seed, scenario8_storm())
    clock = FakeClock()
    label = cfg.tenancy_label

    def demand(team_idx: int, hour: int) -> int:
        """Diurnal offered load: phase-shifted sine, 12..28 pods/hour —
        always above any achievable share, so every tenant stays
        backlogged and DRF fairness is actually load-bearing."""
        return round(20 + 8 * math.sin(
            2 * math.pi * (hour + 6 * team_idx) / 24.0
        ))

    with ChaosSimCluster(cfg, schedule_, clock=clock,
                         in_process=True) as c:
        ext = c.extender
        plane = ext.tenants
        assert plane is not None

        def robust(pod, deadline_rounds: int = 40):
            """schedule() with the requeue loop a real scheduler
            provides; each lap steps the effectors (eviction drain,
            lifecycle) so preemption/termination gates make progress
            under chaos, and degraded-mode refusals wait out the
            circuit's (wall-clock) reset window exactly as scenario 8
            does."""
            last = None
            for _ in range(deadline_rounds):
                try:
                    return c.schedule(pod)
                except RuntimeError as e:
                    last = e
                    if "degraded mode" in str(e):
                        time.sleep(c.CIRCUIT_RESET_S)
                    converge(c, rounds=3)
            raise RuntimeError(f"pod never scheduled: {last}")

        # the trained gang: half the mesh, committed before traffic
        train_group = PodGroup("diurnal-train", min_member=64)
        for i in range(64):
            robust(c.make_pod(
                f"dt-{i}", tpu=1, priority=100, group=train_group,
                labels={label: "trainer"},
            ))

        def committed(name: str) -> bool:
            return any(g["committed"] for g in ext.gang_snapshot()
                       if g["group"] == name)

        def drive(pods) -> list[str]:
            """Batch-drive one wave with the requeue semantics a real
            scheduler provides: admit (the enqueue-time gate may shed),
            plan (DRF order + plan-time gates), bind planned pods;
            chaos bind casualties and degraded-mode refusals requeue
            for another round (waiting out the circuit's wall-clock
            reset). Pods still unplaced after the rounds are abandoned
            — their objects leave the store and the lifecycle resync
            (converge) releases any assumed allocation they held.
            Returns placed pod names."""
            remaining = list(pods)
            placed: list[str] = []
            for _ in range(8):
                if not remaining:
                    break
                c._sync_nodes()
                try:
                    c.drain_evictions()
                except RuntimeError:
                    pass  # injected fault; converge retries below
                for obj in remaining:
                    ext.admit(kube.pod_from_k8s(obj))
                ext.plan_pending()
                still = []
                for obj in remaining:
                    meta = obj["metadata"]
                    key = f"{meta['namespace']}/{meta['name']}"
                    node = ext.planned_node(key)
                    if node is None:
                        still.append(obj)  # shed/denied/capacity
                        continue
                    bres = c._post("/bind", {
                        "PodName": meta["name"],
                        "PodNamespace": meta["namespace"],
                        "PodUID": meta["uid"],
                        "Node": node,
                    })
                    if bres.get("Error"):
                        if "degraded mode" in bres["Error"]:
                            time.sleep(c.CIRCUIT_RESET_S)
                        still.append(obj)  # requeue next round
                        continue
                    meta.setdefault("annotations", {}).update(
                        bres.get("Annotations", {})
                    )
                    obj["spec"]["nodeName"] = node
                    placed.append(meta["name"])
                remaining = still
                converge(c, rounds=3)
            for obj in remaining:
                meta = obj["metadata"]
                c.pods.pop(f"{meta['namespace']}/{meta['name']}", None)
            converge(c, rounds=3)
            return placed

        def team_chips() -> dict[str, float]:
            snap = plane.ledger.usage()
            return {t: (snap.usage[t].chips if t in snap.usage else 0.0)
                    for t in teams}

        alive: list[tuple[str, str]] = []  # (team, pod name), placement order
        seq = 0
        violations: list[str] = []
        ratio_samples: list[float] = []
        util_samples: list[float] = []
        pods_placed = 0
        for wave in range(waves):
            if wave == burn_wave:
                # the SLO event: a small priority-50 gang preempts its
                # way into the full mesh (tenant-aware victim choice)
                # and commits SLOWLY — 3 simulated seconds from
                # reservation to quorum blows the 2.5s gang SLO and
                # burns the budget at page rate
                probe_group = PodGroup("slo-probe", min_member=8)
                for i in range(7):
                    robust(c.make_pod(
                        f"sp-{i}", tpu=1, priority=50, group=probe_group,
                        labels={label: "trainer"},
                    ))
                c.advance(3.0)
                robust(c.make_pod(
                    "sp-7", tpu=1, priority=50, group=probe_group,
                    labels={label: "trainer"},
                ))
                converge(c)
                alive = [(t, n) for t, n in alive
                         if ext.state.allocation(f"default/{n}")
                         is not None]
                # skewed day's-end completions: team-1 finishes its
                # batch entirely and team-0 almost — the remaining
                # teams are now over the burst population's mean
                # share, exactly who shedding must select
                done = [(t, n) for t, n in alive if t == "team-1"]
                t0_alive = [(t, n) for t, n in alive if t == "team-0"]
                done += t0_alive[: max(0, len(t0_alive) - 4)]
                for t, n in done:
                    _complete_quiet(c, n)
                    alive.remove((t, n))
                converge(c)
            elif alive:
                # steady churn: the oldest half-plane of bursts ends
                done, alive = alive[:32], alive[32:]
                for _, name in done:
                    _complete_quiet(c, name)
                converge(c)

            wave_pods = []
            for i, team in enumerate(teams):
                for _ in range(demand(i, wave)):
                    wave_pods.append((team, c.make_pod(
                        f"b{seq}", tpu=1, priority=0,
                        labels={label: team},
                    )))
                    seq += 1
            placed = set(drive([obj for _, obj in wave_pods]))
            for team, obj in wave_pods:
                name = obj["metadata"]["name"]
                if name in placed:
                    alive.append((team, name))
                    pods_placed += 1

            # wave-end invariants
            usage = team_chips()
            snap = plane.ledger.usage()
            for tenant, quota in plane.quotas.items():
                held = (snap.usage[tenant].chips
                        if tenant in snap.usage else 0.0)
                if quota.chips is not None and held > quota.chips + 1e-6:
                    violations.append(
                        f"wave {wave}: {tenant} holds {held:g} chips over "
                        f"its {quota.chips:g} quota"
                    )
            if not committed("diurnal-train"):
                violations.append(
                    f"wave {wave}: the training gang lost its commit"
                )
            util_samples.append(c.utilization())
            if wave in steady:
                shares = [usage[t] for t in teams]
                if min(shares) > 0:
                    ratio_samples.append(max(shares) / min(shares))
                else:
                    violations.append(
                        f"wave {wave}: a tenant was starved to zero at "
                        f"steady state ({usage})"
                    )
            c.advance(3600.0)

        converge(c)
        reasons = ext.events.counts_by_reason()
        sheds, denials = plane.counter_snapshot()
        shed_total = sum(sheds.values())
        denial_total = sum(denials.values())
        leaks = leaked_reservations(c)
        div = ledger_divergence(c)
        stats = plane.stats()
        result = {
            "metric": "tenant_serving",
            "value": round(max(ratio_samples), 4) if ratio_samples else None,
            "unit": "max/min dominant-share ratio at steady state",
            "waves": waves,
            "sim_hours": round(clock.monotonic() / 3600.0, 2),
            "faults_injected": schedule_.injected(),
            "pods_placed": pods_placed,
            "preemptions": ext.preemptions,
            "quota_violations": len(violations),
            "sheds_by_tenant": sheds,
            "quota_denials_by_tenant": denials,
            "shed_events_journaled": reasons.get("TenantAdmissionShed", 0),
            "denial_events_journaled": reasons.get("TenantQuotaDenied", 0),
            "gangs_committed": [g["group"] for g in ext.gang_snapshot()
                                if g["committed"]],
            "steady_utilization_min_percent": round(
                100 * min(util_samples[w] for w in steady), 2
            ) if steady else None,
            "leaked_reservations": len(leaks),
            "ledger_divergence": len(div),
            "snapshot_audit": _audit_stats(c),
            "tenants": stats["tenants"],
        }
        problems = list(violations) + [str(p) for p in leaks] + div
        # a shed pod's decision provenance must answer why-denied
        # naming the burning SLO and the tenant's share (the explain
        # layer's whole point — refusals are never silent in it)
        decisions = ext.decisions
        if decisions is not None and shed_total:
            # a shed pod may schedule in a later retry round once the
            # burn subsides; the assertion wants one whose FINAL state
            # is the refusal — scan newest-first for it
            doc = None
            for ev in reversed(
                ext.events.events(reason="TenantAdmissionShed")
            ):
                shed_key = ev["object"].split("pod/", 1)[1]
                cand = decisions.explain(shed_key)
                if cand["verdict"] == "denied":
                    doc = cand
                    break
            text = json.dumps(doc) if doc is not None else ""
            slo_named = any(
                name in text for name in
                ("gang-schedule-latency", "bind-webhook-latency",
                 "tenant-admission-latency")
            )
            result["explain_shed"] = {
                "pod": doc["pod"] if doc is not None else None,
                "verdict": doc["verdict"] if doc is not None else None,
                "slo_named": slo_named,
            }
            if doc is None:
                problems.append(
                    "no shed pod explains as 'denied' — refusals are "
                    "missing from the provenance ring"
                )
            elif not slo_named or "burst_share" not in text:
                problems.append(
                    f"shed pod {doc['pod']}'s explain names no "
                    f"burning SLO / tenant share"
                )
        if decisions is not None:
            result["decisions"] = decisions.stats()
        if ratio_samples and max(ratio_samples) > 2.0:
            problems.append(
                f"steady-state share ratio {max(ratio_samples):.3f} > 2.0"
            )
        if waves > burn_wave:
            if shed_total == 0:
                problems.append("the SLO burn shed no admissions")
            if not committed("slo-probe"):
                problems.append("the slo-probe gang never committed")
            if ext.preemptions == 0:
                problems.append("the probe gang entered without "
                                "preemption on a full mesh")
        if denial_total == 0:
            problems.append("no quota denial was ever exercised")
        if shed_total != reasons.get("TenantAdmissionShed", 0):
            problems.append(
                f"{shed_total} sheds but "
                f"{reasons.get('TenantAdmissionShed', 0)} journaled — "
                f"sheds must never be silent"
            )
        if denial_total != reasons.get("TenantQuotaDenied", 0):
            problems.append(
                f"{denial_total} denials but "
                f"{reasons.get('TenantQuotaDenied', 0)} journaled"
            )
        if steady and min(util_samples[w] for w in steady) < 0.90:
            problems.append(
                f"steady utilization fell to "
                f"{100 * min(util_samples[w] for w in steady):.1f}%"
            )
        if problems:
            raise RuntimeError("scenario 11 invariants violated: "
                               + "; ".join(problems[:6]))
        return result


def crash_storm(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 13: the crash-at-every-seam chaos storm —
    a scenario-8-style apiserver fault storm interleaved with repeated
    extender crash/restart cycles at kilonode-ish scale (256 nodes /
    1024 chips), with the durable-state journal carrying recovery.

    Per cycle: a burst wave schedules through the batched cycles on
    the fake clock (completion churn frees chips), the journal
    checkpoints on its cadence, then the extender "process" dies and
    the :class:`~tpukube_torch.chaos.crash.CrashSchedule` mutilates the
    journal files the way a real crash at one of the append/checkpoint
    seams would (clean boundary, lost tail records, torn line, CRC
    corruption, torn checkpoint). The restart recovers via checkpoint
    + WAL replay + O(Δ) apiserver reconcile — under the SAME ongoing
    fault storm — and the cycle's invariants run: the committed
    training gang must still be committed, zero ledger divergence,
    zero leaked reservations.

    After the storm, checkpoint-warm recovery is timed against a cold
    ``rebuild_extender`` on the same final state. Raises on any invariant violation or
    an unbounded recovery time. ``TPUKUBE_CRASH_CYCLES`` scales the
    storm (default 8 — the acceptance minimum)."""
    import os
    import tempfile
    from dataclasses import replace as _dc_replace

    from tpukube_torch.chaos import (
        ChaosSimCluster,
        CrashSchedule,
        FaultSchedule,
        converge,
        leaked_reservations,
        ledger_divergence,
    )
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.sched import kube

    cycles = int(os.environ.get("TPUKUBE_CRASH_CYCLES", "8"))
    seed = (config.chaos_seed if config is not None
            else int(os.environ.get("TPUKUBE_CHAOS_SEED") or 0)) or 1337
    with tempfile.TemporaryDirectory(prefix="tpukube-journal-") as td:
        wal_path = os.path.join(td, "wal.jsonl")
        cfg = config or load_config(env=_env({
            "TPUKUBE_SIM_MESH_DIMS": "16,16,4",
            "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
            "TPUKUBE_BATCH_ENABLED": "1",
            "TPUKUBE_BATCH_MAX_PODS": "256",
            "TPUKUBE_JOURNAL_ENABLED": "1",
            "TPUKUBE_JOURNAL_PATH": wal_path,
            # two fake-clock waves per checkpoint: recoveries exercise
            # BOTH the checkpoint-restore and the WAL-tail-replay arms
            "TPUKUBE_CHECKPOINT_INTERVAL_SECONDS": "600",
        }))
        if not cfg.journal_enabled:
            raise RuntimeError(
                "scenario 13 needs journal_enabled (a --config must "
                "set journal_enabled + journal_path)"
            )
        wal_path = cfg.journal_path
        schedule_ = FaultSchedule(seed, scenario8_storm())
        crash_sched = CrashSchedule(seed + 7)
        clock = FakeClock()
        gang_size = 64
        violations: list[str] = []
        recovery_walls: list[float] = []
        modes: list[str] = []
        # audit totals ACROSS incarnations (each crash wipes the next
        # extender's counters; the storm's proof is the sum)
        audit_checks = audit_divergences = 0
        with ChaosSimCluster(cfg, schedule_, clock=clock,
                             in_process=True) as c:
            ext = c.extender

            def robust(pod, deadline_rounds: int = 60):
                last = None
                for _ in range(deadline_rounds):
                    try:
                        return c.schedule(pod)
                    except RuntimeError as e:
                        last = e
                        if "degraded mode" in str(e):
                            time.sleep(c.CIRCUIT_RESET_S)
                        converge(c, rounds=3)
                raise RuntimeError(f"pod never scheduled: {last}")

            def committed(name: str) -> bool:
                return any(
                    g["committed"] for g in c.extender.gang_snapshot()
                    if g["group"] == name
                )

            def drive(pods) -> int:
                """Batch-drive one wave with scheduler requeue
                semantics under chaos; unplaced pods are abandoned
                (their objects leave the store). Returns placed."""
                ext = c.extender
                remaining = list(pods)
                placed = 0
                for _ in range(8):
                    if not remaining:
                        break
                    c._sync_nodes()
                    try:
                        c.drain_evictions()
                    except RuntimeError:
                        pass  # injected fault; converge retries below
                    for obj in remaining:
                        ext.admit(kube.pod_from_k8s(obj))
                    ext.plan_pending()
                    still = []
                    for obj in remaining:
                        meta = obj["metadata"]
                        key = f"{meta['namespace']}/{meta['name']}"
                        node = ext.planned_node(key)
                        if node is None:
                            still.append(obj)
                            continue
                        bres = c._post("/bind", {
                            "PodName": meta["name"],
                            "PodNamespace": meta["namespace"],
                            "PodUID": meta["uid"],
                            "Node": node,
                        })
                        if bres.get("Error"):
                            if "degraded mode" in bres["Error"]:
                                time.sleep(c.CIRCUIT_RESET_S)
                            still.append(obj)
                            continue
                        meta.setdefault("annotations", {}).update(
                            bres.get("Annotations", {})
                        )
                        obj["spec"]["nodeName"] = node
                        placed += 1
                    remaining = still
                    converge(c, rounds=3)
                for obj in remaining:
                    meta = obj["metadata"]
                    c.pods.pop(f"{meta['namespace']}/{meta['name']}",
                               None)
                converge(c, rounds=3)
                return placed

            # the training gang whose commit every crash must survive
            group = PodGroup("stormtrain", min_member=gang_size)
            for i in range(gang_size):
                robust(c.make_pod(f"st-{i}", tpu=1, priority=100,
                                  group=group))
            if not committed("stormtrain"):
                raise RuntimeError("scenario 13: the training gang "
                                   "never committed")

            alive: list[str] = []
            seq = 0
            pods_placed = 0
            for cycle in range(cycles):
                # churn: the oldest half of the burst plane completes
                done, alive = alive[:64], alive[64:]
                for name in done:
                    _complete_quiet(c, name)
                converge(c, rounds=3)
                wave = []
                for _ in range(96):
                    wave.append(c.make_pod(f"b{seq}", tpu=1))
                    seq += 1
                names = [obj["metadata"]["name"] for obj in wave]
                got = drive(wave)
                pods_placed += got
                alive.extend(
                    n for n in names if f"default/{n}" in c.pods
                    and c.pods[f"default/{n}"]["spec"].get("nodeName")
                )
                c.advance(300.0)  # checkpoint cadence rides the clock

                # the crash: process death + one journal-seam outcome
                audit_checks += c.extender.snapshots.audit_checks
                audit_divergences += c.extender.snapshots.audit_divergences
                c.crash_extender()
                seam = crash_sched.next_seam()
                crash_sched.apply(seam, wal_path)
                t0 = time.perf_counter()
                c.restart_extender()
                recovery_walls.append(time.perf_counter() - t0)
                modes.append(c.last_recovery.get("mode", "?"))
                converge(c, rounds=5)

                # per-cycle invariants — a violation fails the storm
                if not committed("stormtrain"):
                    violations.append(
                        f"cycle {cycle} ({seam}): committed gang lost")
                div = ledger_divergence(c)
                if div:
                    violations.append(
                        f"cycle {cycle} ({seam}): ledger divergence "
                        f"{div[:2]}")
                leaks = leaked_reservations(c)
                if leaks:
                    violations.append(
                        f"cycle {cycle} ({seam}): leaked reservations "
                        f"{leaks[:2]}")

            # quiet: storm off, drain, final invariants
            schedule_.stop()
            converge(c)
            robust(c.make_pod("post-storm-probe", tpu=1))
            converge(c)

            # the acceptance measurement: checkpoint-warm recovery vs
            # a cold rebuild_extender of the SAME final state
            ext = c.extender
            ext.journal.write_checkpoint_sync(ext.checkpoint_doc())
            from tpukube_torch.apiserver import rebuild_extender
            from tpukube_torch.sched.extender import Extender as _Ext

            # same trace/events surface as the live extender — the cold
            # number must be the restart a journal-less daemon would
            # actually pay, not a stripped-down one
            cold_cfg = _dc_replace(cfg, journal_enabled=False,
                                   journal_path="")
            throwaway = _Ext(cold_cfg, clock=clock)
            t0 = time.perf_counter()
            cold_restored = rebuild_extender(throwaway, c._store_api)
            cold_s = time.perf_counter() - t0
            # the timing pair runs at the PRODUCTION audit setting (the
            # sentinel's two full rebuild-compares are a test-mode
            # cost); the ≥8 storm cycles above already proved the
            # recovered state correct at whatever rate the run pinned
            audit_rate = cfg.snapshot_audit_rate
            object.__setattr__(c.config, "snapshot_audit_rate", 0.0)
            try:
                c.crash_extender()
                t0 = time.perf_counter()
                c.restart_extender()
                warm_s = time.perf_counter() - t0
            finally:
                object.__setattr__(c.config, "snapshot_audit_rate",
                                   audit_rate)
            c.extender.snapshots.audit_rate = audit_rate
            warm = c.last_recovery
            converge(c)

            div = ledger_divergence(c)
            leaks = leaked_reservations(c)
            journal_stats = c.extender.journal.stats()
            reasons = c.extender.events.counts_by_reason()
            recovery_walls.sort()
            result = {
                "metric": "crash_storm",
                "value": len(recovery_walls),
                "unit": "crash/restart cycles survived",
                "crash_cycles": cycles,
                "seams": crash_sched.chosen,
                "recovery_modes": modes,
                "recovery_s_max": round(recovery_walls[-1], 4),
                "recovery_s_p50": round(
                    recovery_walls[len(recovery_walls) // 2], 4),
                "warm_recovery_s": round(warm_s, 4),
                "cold_rebuild_s": round(cold_s, 4),
                "replay_speedup": round(cold_s / warm_s, 2)
                if warm_s > 0 else None,
                "warm_mode": warm.get("mode"),
                "warm_from_checkpoint": warm.get("checkpoint"),
                "warm_replayed": warm.get("replayed"),
                "cold_restored": cold_restored,
                "pods_placed": pods_placed,
                "faults_injected": schedule_.injected(),
                "checkpoints": journal_stats["checkpoints"],
                "wal_appends": journal_stats["appends"],
                "wal_replayed_total": journal_stats["replayed_total"],
                # the LAST incarnation's journal events (an extender's
                # event ring dies with its process — that is the point)
                "recovery_events": {
                    k: reasons.get(k, 0)
                    for k in ("RecoveryCompleted", "RecoveryDiverged",
                              "JournalTruncated", "CheckpointWritten")
                },
                "ledger_divergence": len(div),
                "leaked_reservations": len(leaks),
                "snapshot_audit": {
                    "rate": cfg.snapshot_audit_rate,
                    "checks": audit_checks
                    + c.extender.snapshots.audit_checks,
                    "divergences": audit_divergences
                    + c.extender.snapshots.audit_divergences,
                },
                "utilization_percent": round(100 * c.utilization(), 2),
            }
            problems = list(violations) + div + [str(p) for p in leaks]
            if recovery_walls[-1] > 30.0:
                problems.append(
                    f"recovery took {recovery_walls[-1]:.1f}s — "
                    f"unbounded recovery time")
            if not warm.get("checkpoint"):
                problems.append(
                    "the final warm recovery did not load a checkpoint")
            if warm.get("mode") != "warm":
                problems.append(
                    f"final recovery mode {warm.get('mode')!r}, "
                    f"expected warm")
            if len(modes) != cycles:
                problems.append(
                    f"{len(modes)} recoveries ran for {cycles} crash "
                    f"cycles")
            if reasons.get("RecoveryCompleted", 0) < 1:
                problems.append(
                    "the final recovery was not journaled")
            if problems:
                raise RuntimeError("scenario 13 invariants violated: "
                                   + "; ".join(problems[:6]))
            return result


def maintenance_storm(config: GpuKubeConfig | None) -> dict[str, Any]:
    """Scenario 15: region-scale fleet elasticity under chaos —
    maintenance events and spot churn rip capacity out of a live fleet
    while the drain choreography, the WAL, and the autoscaler put it
    back, in three phases:

    **A — maintenance storm.** A 4-slice fleet (64 chips) carries a
    committed training gang plus burst fillers on the fake clock with
    the journal on. Each cycle the seeded
    :class:`~tpukube_torch.chaos.maintenance.MaintenanceSchedule` picks a
    slice to drain (graceful: cordon → budgeted migrate-or-preempt →
    un-ingest); every other cycle the extender CRASHES mid-choreography
    (mid-drain or mid-un-ingest — wherever the cycle's clock lands)
    and recovery must carry the cordon state through checkpoint + WAL
    replay; the :class:`~tpukube_torch.chaos.maintenance.SpotChurnSchedule`
    additionally rips individual nodes out with no notice. Per-cycle
    invariants: the gang is allocated all-or-nothing (never partial),
    zero ledger divergence, zero leaked reservations, and the drain's
    per-tick disruption never exceeds ``drain_max_concurrent_moves``.
    Slices the schedule marks as returning are re-ingested through the
    bulk path.

    **B — autoscaler loop.** A fresh 2-slice batched cluster: a queue
    burst beyond ``autoscale_up_queue_depth`` must provision + bulk-
    ingest a new slice (time-to-capacity = one decision), and the
    post-burst idle fleet must drain the emptiest slice back down.

    **C — sharded rebalance-away.** ``planner_replicas=2`` in-process:
    draining one replica's ENTIRE slice set registers drain intent
    with the router (the health-check race fix's observable), survives
    crashing + restarting the OTHER replica mid-drain, and converges
    with zero leaks.

    Raises on any invariant violation. ``TPUKUBE_MAINT_CYCLES`` scales
    phase A (default 6 — at least one maintenance event per slice plus
    both crash arms); the acceptance drive runs the whole scenario at
    ``TPUKUBE_SNAPSHOT_AUDIT_RATE=1.0`` asserting zero divergences."""
    import os
    import tempfile

    from tpukube_torch.chaos import (
        MaintenanceSchedule,
        SpotChurnSchedule,
        converge,
        leaked_reservations,
        ledger_divergence,
    )
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.core.mesh import MeshSpec

    cycles = int(os.environ.get("TPUKUBE_MAINT_CYCLES", "6"))
    seed = (config.chaos_seed if config is not None
            else int(os.environ.get("TPUKUBE_CHAOS_SEED") or 0)) or 1337
    mesh = MeshSpec(dims=(4, 4, 1), host_block=(2, 2, 1))
    gang_size = 8
    problems: list[str] = []
    audit_checks = audit_divergences = 0
    peak_moves = 0

    def _drive_drain(c, ext, budget_ticks: int = 40) -> None:
        """Tick every active drain to completion (evictions drained
        between ticks — the effector loop a real deployment runs)."""
        for _ in range(budget_ticks):
            if ext.drain is None or not ext.drain.active():
                return
            c.clock.advance(1.0)
            ext.drain.tick()
            converge(c, rounds=3)
        raise RuntimeError("drain never completed within the tick "
                           "budget")

    def _gang_alloc_count(ext, prefix: str) -> int:
        return sum(1 for a in ext.state.allocations()
                   if a.pod_key.startswith(f"default/{prefix}"))

    def _drop_gang(c, prefix: str) -> None:
        """Tear a gang fully down: pods deleted, then the reservation
        TTL runs out on the fake clock and the sweep reclaims it — a
        dissolved gang must leave NOTHING for the leak check to find."""
        for i in range(gang_size):
            c.delete_pod(f"{prefix}{i}")
        converge(c, rounds=3)
        clock.advance(cfg.reservation_ttl_seconds + 1.0)
        c.extender.gang.sweep()
        converge(c, rounds=3)

    # ---- phase A: the maintenance storm --------------------------------
    with tempfile.TemporaryDirectory(prefix="tpukube-maint-") as td:
        wal_path = os.path.join(td, "wal.jsonl")
        cfg = config or load_config(env=_env({
            "TPUKUBE_DRAIN_ENABLED": "1",
            "TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES": "2",
            "TPUKUBE_JOURNAL_ENABLED": "1",
            "TPUKUBE_JOURNAL_PATH": wal_path,
            "TPUKUBE_CHECKPOINT_INTERVAL_SECONDS": "600",
            # the storm asserts cordons SURVIVE the crash; a buffered
            # tail would shed the latest cordon seam by design
            "TPUKUBE_JOURNAL_FSYNC": "always",
        }))
        if not cfg.drain_enabled:
            raise RuntimeError("scenario 15 needs drain_enabled (a "
                               "--config must set it)")
        maint = MaintenanceSchedule(seed, [f"s{i}" for i in range(4)],
                                    return_rate=0.5)
        spot = SpotChurnSchedule(seed + 3, kill_rate=0.5)
        clock = FakeClock()
        slices = {f"s{i}": mesh for i in range(4)}
        gang_gen = 0
        with SimCluster(cfg, slices=dict(slices), clock=clock,
                        in_process=True) as c:

            def commit_gang() -> str:
                """All-or-nothing by construction: a half-placed gang
                (fleet too small this cycle) is torn down so its
                reservations can't masquerade as a partial survival."""
                nonlocal gang_gen
                gang_gen += 1
                prefix = f"et{gang_gen}-"
                group = PodGroup(f"elastictrain{gang_gen}",
                                 min_member=gang_size)
                try:
                    for i in range(gang_size):
                        c.schedule(c.make_pod(f"{prefix}{i}", tpu=2,
                                              priority=100,
                                              group=group))
                except RuntimeError:
                    _drop_gang(c, prefix)
                    raise
                return prefix

            gang_prefix = commit_gang()
            fillers = []
            for i in range(6):
                name = f"fill-{i}"
                c.schedule(c.make_pod(name, tpu=1))
                fillers.append(name)

            drains_completed = 0
            spot_kills = 0
            returned_slices = 0
            refill_failures: list[str] = []
            for cycle in range(cycles):
                ext = c.extender
                event = maint.next_event()
                if event is None:
                    break
                sid, returns = event
                nodes = [n for n in ext.state.node_names()
                         if ext.state.slice_of_node(n) == sid]
                if not nodes:
                    # the slice left in an earlier cycle and never
                    # returned — the draw stands (determinism), the
                    # cycle's churn still runs below
                    pass
                else:
                    ext.drain.begin(nodes, reason="maintenance")
                    ext.drain.tick()
                    converge(c, rounds=3)
                    if cycle % 2 == 1:
                        # the crash arm: die mid-choreography; the
                        # cordon must ride the WAL into the fresh
                        # incarnation. When the first tick already
                        # finished the drain this is the mid-UN-INGEST
                        # crash: the provider has the capacity, so the
                        # store stops advertising it BEFORE the restart
                        # (else the O(Δ) reconcile would faithfully
                        # re-ingest what the apiserver still claims).
                        if not ext.drain.active():
                            c.forget_nodes(nodes)
                        audit_checks += ext.snapshots.audit_checks
                        audit_divergences += \
                            ext.snapshots.audit_divergences
                        c.crash_extender()
                        c.restart_extender()
                        ext = c.extender
                        still = sorted(
                            n for n in ext.state.cordoned_nodes())
                        missing = (set(nodes)
                                   & set(ext.state.node_names())
                                   ) - set(still)
                        if missing:
                            problems.append(
                                f"cycle {cycle}: cordon lost in "
                                f"recovery for {sorted(missing)[:2]}")
                        if still:
                            # the operator's resume: a fresh
                            # coordinator adopts the recovered cordon
                            ext.drain.begin(still, reason="maintenance")
                    _drive_drain(c, ext)
                    drains_completed += 1
                    peak_moves = max(peak_moves,
                                     ext.drain.peak_tick_moves)
                    if ext.drain.peak_tick_moves > \
                            cfg.drain_max_concurrent_moves:
                        problems.append(
                            f"cycle {cycle}: drain moved "
                            f"{ext.drain.peak_tick_moves} workloads in "
                            f"one tick (budget "
                            f"{cfg.drain_max_concurrent_moves})")
                    c.forget_nodes(nodes)
                    if returns:
                        items = c.add_slice(sid, mesh)
                        res = ext.handle("upsert_nodes",
                                         {"items": items})["results"]
                        errs = [r for r in res
                                if isinstance(r, dict) and r.get("error")]
                        if errs:
                            problems.append(
                                f"cycle {cycle}: re-ingest of {sid} "
                                f"failed: {errs[:1]}")
                        returned_slices += 1

                # spot churn: no cordon, no budget — the node is gone
                victim = spot.draw_kill(ext.state.node_names())
                if victim is not None:
                    doomed = [a.pod_key for a in ext.state.allocations()
                              if a.node_name == victim]
                    for key in doomed:
                        ns, name = key.split("/", 1)
                        c.delete_pod(name, namespace=ns)
                    converge(c, rounds=3)
                    out = ext.state.remove_nodes([victim])
                    if victim not in out["removed"]:
                        problems.append(
                            f"cycle {cycle}: spot victim {victim} not "
                            f"removable: {out['skipped']}")
                    c.forget_nodes([victim])
                    spot_kills += 1

                # the all-or-nothing invariant, then refill
                got = _gang_alloc_count(ext, gang_prefix)
                if got not in (0, gang_size):
                    problems.append(
                        f"cycle {cycle}: gang partially allocated "
                        f"({got}/{gang_size})")
                if got == 0:
                    _drop_gang(c, gang_prefix)
                    try:
                        gang_prefix = commit_gang()
                    except RuntimeError as e:
                        # fleet too small/fragmented this cycle — the
                        # next one retries after capacity returns
                        refill_failures.append(
                            f"cycle {cycle} (fleet "
                            f"{sorted(ext.state.slice_ids())}, "
                            f"{len(ext.state.node_names())} nodes): "
                            f"{str(e)[:200]}")
                for name in list(fillers):
                    if f"default/{name}" not in c.pods or not c.pods[
                            f"default/{name}"]["spec"].get("nodeName"):
                        c.delete_pod(name)
                        fillers.remove(name)
                div = ledger_divergence(c)
                if div:
                    problems.append(
                        f"cycle {cycle}: ledger divergence {div[:2]}")
                leaks = leaked_reservations(c)
                if leaks:
                    problems.append(
                        f"cycle {cycle}: leaked reservations "
                        f"{[str(p) for p in leaks[:2]]}")
                clock.advance(120.0)

            maint.stop()
            spot.stop()
            converge(c)
            audit_checks += c.extender.snapshots.audit_checks
            audit_divergences += c.extender.snapshots.audit_divergences
            drain_stats = c.extender.drain.stats() \
                if c.extender.drain is not None else {}
            storm_report = {
                "maintenance": maint.report(),
                "spot": spot.report(),
                "drains_completed": drains_completed,
                "spot_kills": spot_kills,
                "returned_slices": returned_slices,
                "gang_refill_failures": refill_failures,
                "final_slices": sorted(c.extender.state.slice_ids()),
                "last_incarnation_drain": drain_stats,
            }

    # ---- phase B: the autoscaler loop ----------------------------------
    cfg_b = load_config(env=_env({
        "TPUKUBE_DRAIN_ENABLED": "1",
        "TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES": "2",
        "TPUKUBE_AUTOSCALE_ENABLED": "1",
        "TPUKUBE_AUTOSCALE_MIN_SLICES": "2",
        "TPUKUBE_AUTOSCALE_MAX_SLICES": "4",
        "TPUKUBE_AUTOSCALE_UP_QUEUE_DEPTH": "4",
        "TPUKUBE_AUTOSCALE_DOWN_UTILIZATION": "0.25",
        "TPUKUBE_AUTOSCALE_COOLDOWN_SECONDS": "30",
        "TPUKUBE_BATCH_ENABLED": "1",
    }))
    clock_b = FakeClock()
    with SimCluster(cfg_b, slices={"s0": mesh, "s1": mesh},
                    clock=clock_b, in_process=True) as c:
        from tpukube_torch.sched import kube

        ext = c.extender
        ext.autoscaler.set_provisioner(c.make_slice_provisioner(mesh))
        # saturate: 8 x 4-chip pods fill both 16-chip slices exactly
        held = [c.make_pod(f"hold-{i}", tpu=4) for i in range(8)]
        c.schedule_pending(held)
        # the burst beyond capacity: queue depth crosses the up
        # threshold; the next autoscaler decision must provision + bulk-
        # ingest a slice (time-to-capacity = one decision)
        burst = [c.make_pod(f"burst-{i}", tpu=4) for i in range(4)]
        for obj in burst:
            ext.admit(kube.pod_from_k8s(obj))
        up = ext.autoscaler.tick()
        if up != "up":
            problems.append(
                f"phase B: queued burst decided {up!r}, wanted 'up' "
                f"(depth {ext.cycle.queue_depth()})")
        n_after_up = len(ext.state.slice_ids())
        placed = c.schedule_pending(burst, retries=6)
        if len(placed) != len(burst):
            problems.append(
                f"phase B: only {len(placed)}/{len(burst)} burst pods "
                f"placed after scale-up")
        # idle down: everything completes, utilization collapses
        for obj in held + burst:
            _complete_quiet(c, obj["metadata"]["name"])
        converge(c, rounds=5)
        clock_b.advance(60.0)
        decision = ext.autoscaler.tick()
        if decision != "down":
            problems.append(
                f"phase B: idle fleet decided {decision!r}, wanted "
                f"'down'")
        _drive_drain(c, ext)
        gone = [sid for sid in list(c.slices)
                if sid not in ext.state.slice_ids()]
        c.forget_nodes([n for n in list(c.nodes)
                        if c.nodes[n].slice_id in gone])
        scale_report = {
            "scale_ups": ext.autoscaler.scale_ups,
            "scale_downs": ext.autoscaler.scale_downs,
            "slices_after_up": n_after_up,
            "slices_final": sorted(ext.state.slice_ids()),
        }
        audit_checks += ext.snapshots.audit_checks
        audit_divergences += ext.snapshots.audit_divergences

    # ---- phase C: sharded rebalance-away -------------------------------
    cfg_c = load_config(env=_env({
        "TPUKUBE_DRAIN_ENABLED": "1",
        "TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES": "2",
        "TPUKUBE_PLANNER_REPLICAS": "2",
    }))
    clock_c = FakeClock()
    with SimCluster(cfg_c, slices={f"s{i}": mesh for i in range(4)},
                    clock=clock_c, in_process=True) as c:
        router = c.extender
        for i in range(8):
            c.schedule(c.make_pod(f"sp-{i}", tpu=2))
        with router._lock:
            assign = dict(router._slice_replica)
        # drain EVERY slice the second replica owns (rebalance-away)
        target_idx = 1
        target_slices = sorted(s for s, i in assign.items()
                               if i == target_idx)
        rext = router.replicas[target_idx].extender
        drained_nodes: list[str] = []
        if not target_slices:
            problems.append("phase C: replica 1 owns no slices")
        else:
            for sid in target_slices:
                drained_nodes.extend(
                    n for n in rext.state.node_names()
                    if rext.state.slice_of_node(n) == sid)
            rext.drain.begin(drained_nodes, reason="rebalance-away")
            if "drain_intent" not in router.statusz():
                problems.append(
                    "phase C: drain intent missing from router statusz")
            # the OTHER replica dies and cold-restarts mid-drain
            c.crash_replica(0)
            c.restart_replica(0)
            for _ in range(40):
                if not rext.drain.active():
                    break
                clock_c.advance(1.0)
                rext.drain.tick()
                converge(c, rounds=3)
            if rext.drain.active():
                problems.append("phase C: rebalance drain never "
                                "completed")
            if "drain_intent" in router.statusz():
                problems.append(
                    "phase C: drain intent not cleared at completion")
            c.forget_nodes(drained_nodes)
        converge(c)
        div = ledger_divergence(c)
        if div:
            problems.append(f"phase C: ledger divergence {div[:2]}")
        leaks = leaked_reservations(c)
        if leaks:
            problems.append(
                f"phase C: leaked reservations "
                f"{[str(p) for p in leaks[:2]]}")
        shard_report = {
            "slice_assignment": assign,
            "drained_slices": target_slices,
            "drained_nodes": len(drained_nodes),
            "health_skips_draining":
                router.health_skips_draining_total,
        }

    result = {
        "metric": "maintenance_storm",
        "value": storm_report["drains_completed"]
        + scale_report["scale_downs"] + len(target_slices),
        "unit": "graceful drains survived",
        "cycles": cycles,
        "seed": seed,
        "storm": storm_report,
        "autoscale": scale_report,
        "sharded": shard_report,
        "peak_tick_moves": peak_moves,
        "budget_moves": cfg.drain_max_concurrent_moves,
        "snapshot_audit": {
            "rate": cfg.snapshot_audit_rate,
            "checks": audit_checks,
            "divergences": audit_divergences,
        },
    }
    if audit_divergences:
        problems.append(
            f"{audit_divergences} snapshot audit divergence(s)")
    if problems:
        raise RuntimeError("scenario 15 invariants violated: "
                           + "; ".join(problems[:6]))
    return result
