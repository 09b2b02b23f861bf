"""/statusz JSON introspection documents — the port's own copy of
``tpukube/obs/statusz.py``.

/metrics answers "how much"; /statusz answers "what, exactly, right now":
the ledger and reservation summary, the pending-eviction queue with
per-key ages, watch liveness as a last-event timestamp (a live thread in
reconnect backoff is not a live stream), trace-ring stats, and the node
agent's inventory source. Served by the extender's HTTP app and the node
agent's ``MetricsServer``.

``router_statusz`` is the shard router's document (planner_replicas > 1).
"""

from __future__ import annotations

import time
from typing import Any


def device_health_counts(device) -> tuple[int, int]:
    """(healthy, unhealthy) over a device manager's current device list:
    the one classification both /metrics and /statusz report."""
    healthy = unhealthy = 0
    for _, h in device.device_list():
        if h.value == "Healthy":
            healthy += 1
        else:
            unhealthy += 1
    return healthy, unhealthy


def watch_status(loop) -> dict[str, Any]:
    """One watch/poll loop's liveness document. ``loop`` is any of the
    apiserver module's watch loops (or a loop a PodInformer hosts); None
    means the daemon runs without that loop (sim/dev)."""
    if loop is None:
        return {"configured": False}
    status = getattr(loop, "watch_status", None)
    if status is not None:
        return {"configured": True, **status()}
    return {"configured": True, "name": getattr(loop, "_name", "?")}


def fleet_health(extender) -> dict[str, Any]:
    """Fleet health rolled up per NVLink domain (slice): healthy /
    degraded / unhealthy GPUs (from the node agents' health-summary
    annotations, else the topology annotation's chip health) plus the
    terminating-victim GPU count: healthy hardware a dying container
    still owns."""
    from tpukube_torch.core import codec

    state, gang = extender.state, extender.gang
    slices: dict[str, dict[str, Any]] = {}
    for sid in state.slice_ids():
        slices[sid] = {
            "nodes": 0,
            "chips": 0,
            "healthy": 0,
            "degraded": 0,
            "unhealthy": 0,
            # a separate dimension, not a fourth chip state: terminating
            # victims' chips are healthy but unplaceable until confirmed
            "terminating": len(gang.terminating_coords(sid)),
            "links_down": len(state.broken_links(sid)),
        }
    for name in state.node_names():
        view = state.node(name)
        if view is None:
            continue
        s = slices.get(view.info.slice_id)
        if s is None:
            continue
        s["nodes"] += 1
        s["chips"] += len(view.info.chips)
        summary = view.health_summary
        if summary is not None:
            for key in ("healthy", "degraded", "unhealthy"):
                s[key] += int(summary.get(key, 0))
        else:
            for st in codec.chip_health_states(view.info).values():
                s[st] += 1
    totals = {
        k: sum(s[k] for s in slices.values())
        for k in ("nodes", "chips", "healthy", "degraded", "unhealthy",
                  "terminating", "links_down")
    }
    return {
        "slices": slices,
        "total": totals,
        "degraded_slices": sorted(
            sid for sid, s in slices.items()
            if s["degraded"] or s["unhealthy"] or s["terminating"]
            or s["links_down"]
        ),
    }


def _events_section(events) -> dict[str, Any]:
    return {
        **events.stats(),
        "by_reason": events.counts_by_reason(),
        "recent": events.events(limit=20),
    }


def extender_statusz(
    extender, evictions=None, informer=None, node_refresh=None,
    lifecycle=None, reconcile=None,
) -> dict[str, Any]:
    """The extender daemon's introspection document (served on /statusz
    behind the same auth as /state: it discloses placement)."""
    state = extender.state
    gangs = extender.gang.snapshot()
    now = time.monotonic()
    if evictions is not None:
        pending = evictions.pending_snapshot(now=now)
        oldest = evictions.oldest_age_seconds(now=now)
    else:
        # no executor (sim/dev): the raw queue, ages unknown
        pending = [
            {"pod": k, "state": "queued", "age_seconds": None}
            for k in list(extender.pending_evictions)
        ]
        oldest = None
    out: dict[str, Any] = {
        "component": "extender",
        "time": time.time(),
        "ledger": {
            "nodes": len(state.node_names()),
            "allocations": len(state.allocations()),
            "utilization_percent": round(100.0 * state.utilization(), 2),
        },
        "gangs": {
            "reservations": len(gangs),
            "committed": sum(1 for r in gangs if r.committed),
            "assembling": sum(1 for r in gangs if not r.committed),
            "victims_terminating": extender.gang.terminating_count(),
        },
        "pending_evictions": {
            "depth": len(pending),
            "oldest_age_seconds": oldest,
            "entries": pending,
        },
        # the pod stream feeding releases and reconciles: liveness means
        # a CONNECTED stream with a last-event timestamp, not merely a
        # live thread (reconnect backoff windows miss DELETED events)
        "pod_watch": watch_status(informer if informer is not None
                                  else lifecycle),
        "node_watch": watch_status(node_refresh),
        "trace": (extender.trace.stats() if extender.trace is not None
                  else {"enabled": False}),
        "fleet": fleet_health(extender),
        # the epoch-cached scheduling snapshot: cache counters and
        # per-slice fragmentation
        "snapshot": extender.snapshots.stats(),
        # bulk cold-start ingestion: batch counters, the decode-cache
        # hit rate, and the lazy backlog the warmer still drains
        "ingest": ({"enabled": True, **state.ingest_stats()}
                   if extender.bulk_ingest else {"enabled": False}),
        # generation-based incremental resync: full vs incremental
        # lifecycle reads and the wire-shape bytes moved
        "resync": ({"enabled": True, **lifecycle.resync_stats()}
                   if lifecycle is not None
                   and getattr(extender, "resync_incremental", False)
                   and hasattr(lifecycle, "resync_stats")
                   else {"enabled": False}),
        # durable-state journal (sched/journal.py): WAL position,
        # append/checkpoint counters, and the last recovery's stats
        # (mode "cold-fallback" means the journal could not produce a
        # trustworthy base and the daemon rebuilt the legacy way)
        "journal": (extender.journal.stats()
                    if extender.journal is not None
                    else {"enabled": False}),
        # batched scheduling cycles: queue depth, batch sizes, and the
        # plan-hit ratio
        "cycle": (extender.cycle.stats() if extender.cycle is not None
                  else {"enabled": False}),
        # multi-tenant serving plane (tenancy/): per-tenant
        # usage/share/quota, shed and denial counters, and the SLO
        # burn monitor feeding the shedding decision
        "tenants": (extender.tenants.stats()
                    if getattr(extender, "tenants", None) is not None
                    else {"enabled": False}),
        # decision provenance (obs/decisions.py): ring occupancy, sample
        # rate, and the measured record overhead — the data behind
        # /explain and `obs explain`
        "decisions": (extender.decisions.stats()
                      if getattr(extender, "decisions", None)
                      is not None else {"enabled": False}),
        "events": _events_section(extender.events),
    }
    # capacity analytics (obs/capacity.py): the key itself is
    # CONDITIONAL — with the plane off the /statusz document stays
    # byte-identical, like the lifecycle/reconcile keys
    capacity = getattr(extender, "capacity", None)
    if capacity is not None:
        out["capacity"] = {
            **capacity.stats(),
            "stranded": capacity.stranded_summary(),
        }
    # fleet elasticity: drain choreography + autoscaler loop — both keys
    # conditional like capacity's
    drain = getattr(extender, "drain", None)
    if drain is not None:
        out["drain"] = drain.statusz()
    autoscaler = getattr(extender, "autoscaler", None)
    if autoscaler is not None:
        out["autoscaler"] = autoscaler.statusz()
    if lifecycle is not None:
        out["lifecycle_releases"] = lifecycle.released
    if reconcile is not None:
        out["reconciles"] = reconcile.reconciled
    return out


def router_statusz(router) -> dict[str, Any]:
    """The sharded control plane's /statusz document:
    slice→replica assignment, per-replica summary rows (liveness,
    nodes, allocs, queue depth, snapshot counters), and the two-phase
    rendezvous ledger. Each replica's FULL ``extender_statusz`` stays
    its own listener's document in a real deployment; this is the
    cross-shard rollup the router serves."""
    return {
        "time": time.time(),
        "sharded": True,
        **router.statusz(),
        "pending_evictions": len(router.pending_evictions),
        "rendezvous_counters": {
            "prepared": router.rendezvous_prepared,
            "committed": router.rendezvous_committed,
            "aborted": router.rendezvous_aborted,
        },
    }


def plugin_statusz(
    server, device=None, health=None, kubelet_watch=None, intent_watch=None,
    sampler=None, events=None,
) -> dict[str, Any]:
    """The node agent's introspection document (served by its
    ``MetricsServer`` on /statusz). ``sampler`` is the telemetry
    HealthSampler (per-GPU states and rolling windows); ``events`` the
    node-local EventJournal."""
    dev = device if device is not None else server._device
    healthy, unhealthy = device_health_counts(dev)
    out: dict[str, Any] = {
        "component": "plugin",
        "time": time.time(),
        "resource": server.resource_name,
        "devices": {"healthy": healthy, "unhealthy": unhealthy},
        # table-fallback nodes run on static memory/SM guesses, not
        # runtime truth: the first thing to check on a weird node
        "inventory_source": dev.inventory_source(),
        "allocations": server.allocation_count,
        "divergences": server.divergences,
        "intents": {
            "depth": server.intents.depth(),
            "pending": sorted(server.intents.snapshot()),
        },
        "intent_watch": watch_status(intent_watch),
    }
    if health is not None:
        out["health_transitions"] = health.transitions
    if kubelet_watch is not None:
        out["kubelet_reregistrations"] = kubelet_watch.reregistrations
    if sampler is not None:
        out["telemetry"] = sampler.telemetry_status()
    if events is not None:
        out["events"] = _events_section(events)
    return out
