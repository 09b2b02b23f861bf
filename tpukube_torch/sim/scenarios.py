"""Runnable BASELINE scenarios on the port — its own copy of
``tpukube/sim/scenarios.py``'s scenarios 1-6, 10 and 12.

Each scenario replays one BASELINE.json config against the port's stack
(the extender over HTTP inside ``SimCluster``'s ``with`` block; configs
1-3 additionally walk the device plugin over the ``"inprocess"``
transport: the same v1beta1 bytes as the reference's unix sockets,
without grpcio, which the GPU machine lacks) and returns a JSON-able
result. Scenarios 10 and 12 are the kilonode churn drives:
1,024 and 10,240 nodes on a fake clock, through the batch scheduling
cycle (``sched/cycle.py``), each raising on its own invariants.

Not ported (``run`` raises, naming the plane): scenario 7 (the SLO
plane), 8, 9 and 13 (chaos), 11 (tenancy), 14 (the shard router)
and 15 (drain); each waits in ROADMAP.md Queue 1.
"""

from __future__ import annotations

import time
import urllib.request
from typing import Any, Optional

from tpukube_torch.core.config import GpuKubeConfig, load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.sim.harness import SimCluster

#: knobs that pass through from the process environment into every
#: scenario's canonical config (which would otherwise shadow them). The
#: reference's whole list: a key of a plane the port has not ported is
#: refused by load_config, as ever, and a key the port has no field for
#: is not read
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

#: scenario -> the plane it needs that the port has not ported yet
NOT_PORTED = {
    7: "the SLO plane (ROADMAP.md Queue 1)",
    8: "the chaos harness (ROADMAP.md Queue 1)",
    9: "the chaos harness (ROADMAP.md Queue 1)",
    11: "the tenancy plane (ROADMAP.md Queue 1)",
    13: "the chaos harness and the journal (ROADMAP.md Queue 1)",
    14: "the shard router (ROADMAP.md Queue 1)",
    15: "drain and the autoscaler (ROADMAP.md Queue 1)",
}


def _env(defaults: dict[str, str]) -> dict[str, str]:
    import os

    env = dict(defaults)
    for key in _PASSTHROUGH_KEYS:
        if os.environ.get(key):
            env[key] = os.environ[key]
    return env


def run(scenario: int, config: GpuKubeConfig | None = None) -> dict[str, Any]:
    """Run one scenario. Raises ``NotImplementedError`` for a scenario
    whose plane is not ported."""
    if scenario in NOT_PORTED:
        raise NotImplementedError(
            f"scenario {scenario} needs {NOT_PORTED[scenario]}, which "
            f"the port does not have yet")
    fn = {
        1: smoke_single_pod,
        2: dp_fanout,
        3: fractional_vtpu,
        4: gang_16,
        5: multi_tenant_northstar,
        6: churn,
        10: kilonode_churn,
        12: kilonode10k_churn,
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


def _kilonode_drive(cfg: GpuKubeConfig, metric: str, total_target: int,
                    gang_size: int,
                    max_alive: Optional[int] = None,
                    check_leaks: bool = False,
                    delta_stats: bool = False) -> dict[str, Any]:
    """The shared kilonode churn driver (scenarios 10 and 12): a
    committed training gang pins a contiguous block while burst waves
    arrive, run five simulated minutes, and complete, on the fake
    clock through the batched cycles. ``check_leaks`` adds the
    leaked-reservation invariant and ``delta_stats`` the
    snapshot-maintenance numbers (delta-apply p50 vs a forced full
    rebuild p50 measured on the SAME loaded cluster at drive end).

    The reference's multi-slice fleet and setup-excluding options exist
    for its sharded scenario 14, and its shard, wire, decisions and
    capacity result keys for planes the port has not ported; all are
    left out here."""
    from collections import deque as _deque

    from tpukube_torch.chaos import leaked_reservations, ledger_divergence
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.obs.registry import quantile

    sample_every = 101  # full-webhook-protocol sampling cadence
    clock = FakeClock()
    t0 = time.perf_counter()
    # NodesCached sampled-webhook bodies: after the one-time ingest the
    # kilonode drives stop re-listing O(nodes) names per sampled webhook
    with SimCluster(cfg, clock=clock, in_process=True,
                    cached_node_body=True, transport="inprocess") as c:
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
        # the per-wave lifecycle reconcile's read counts (every read of
        # the port is a full one: it has no alloc change log)
        result["resync"] = c._lifecycle.resync_stats()
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
