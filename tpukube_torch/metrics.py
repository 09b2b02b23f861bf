"""Metrics export — the port's own copy of the default plane of
``tpukube/metrics.py``, thin functions over ``tpukube_torch.obs.registry``:
``build_extender_registry``/``render_extender_metrics`` (``serve`` in
``tpukube_torch.sched.extender`` answers ``GET /metrics`` with it) and
``build_plugin_registry``/``render_plugin_metrics`` for the device
plugin (``tpukube_torch.plugin.server``), and
``build_syncer_registry``/``render_syncer_metrics`` for the node
annotation syncer (``tpukube_torch.apiserver.NodeAnnotationSyncer``).

Extender series, under the reference's names and types:
  tpu_chip_utilization_percent            — north star #1
  gang_schedule_latency_seconds{quantile} — north star #2 (+ _count/_sum)
  gang_schedule_latency_seconds_bucket{le}
  tpukube_ici_links_down, tpukube_binds_total,
  tpukube_gang_rollbacks_total, tpukube_preemptions_total,
  tpukube_webhook_latency_seconds{handler,quantile} (+ _bucket{handler,le}),
  tpukube_gang_victims_terminating, tpukube_evictions_pending,
  and with an eviction executor: tpukube_evictions_total,
  tpukube_evictions_blocked_total, tpukube_eviction_failures_total,
  tpukube_eviction_oldest_age_seconds;
  with a reconcile loop: tpukube_reconciles_total;
  with a node-topology refresh loop: tpukube_node_refreshes_total;
  with a lifecycle loop: tpukube_lifecycle_releases_total;
  tpukube_events_total{reason};
  with the batch cycle built (``batch_enabled``): tpukube_cycles_total,
  tpukube_cycle_{pods_planned,plan_hits,plan_misses,assumes}_total,
  tpukube_cycle_batch_size{quantile}, tpukube_cycle_wall_seconds{quantile}
  (+ _bucket{le}), tpukube_cycle_queue_age_seconds_bucket{le},
  tpukube_cycle_queue_depth;
  with the tenancy plane built (``tenancy_enabled``):
  tpukube_tenant_{chips_used,hbm_used_bytes,dominant_share}{tenant},
  tpukube_tenant_quota_{chips,hbm_fraction}{tenant},
  tpukube_tenant_{sheds,quota_denials}_total{tenant},
  tpukube_tenant_{admission,commit}_seconds_bucket{tenant,le},
  tpukube_tenancy_burn_rate{slo}, tpukube_tenant_slo_burn{tenant,slo},
  tpukube_tenancy_shedding;
  with decision provenance built (``decisions_enabled``):
  tpukube_decisions_total, tpukube_decisions_record_seconds_total and
  tpukube_cycle_phase_seconds_bucket{phase,le};
  with the capacity recorder built (``capacity_enabled``):
  tpukube_capacity_{samples,sample_seconds}_total,
  tpukube_capacity_{fleet,recoverable}_chips,
  tpukube_capacity_stranded_{chips,demands}{reason},
  tpukube_unschedulable_pods{reason};
  with the drain coordinator built (``drain_enabled``):
  tpukube_drain_{started,completed,evictions,nodes_removed,chips_removed,
  slices_dropped}_total, tpukube_drain_peak_tick_moves,
  tpukube_drain_active;
  with the autoscaler built (``autoscale_enabled``):
  tpukube_autoscaler_{scale_ups,scale_downs,nodes_added,ticks}_total;
  with the apiserver channel's Retrier / CircuitBreaker attached
  (``extender.api_retrier``/``api_circuit``):
  tpukube_retry_{attempts,retries,exhausted}_total{op},
  tpukube_circuit_state{circuit} and tpukube_circuit_opens_total{circuit}.

Plugin series: tpukube_plugin_allocations_total,
tpukube_plugin_devices{health}, tpukube_plugin_resource_info{resource},
tpukube_plugin_inventory_source{source}, tpukube_plugin_intent_depth,
tpukube_plugin_divergences_total; with a health watcher
tpukube_plugin_health_transitions_total; with a kubelet session watcher
tpukube_plugin_reregistrations_total and its retrier's
tpukube_retry_{attempts,retries,exhausted}_total{op}; with a telemetry
sampler one series per GPU of tpukube_chip_{healthy,duty_cycle_percent,
hbm_used_bytes,hbm_total_bytes,ici_link_errors_total,
health_transitions_total}, tpukube_node_chips{state} and
tpukube_telemetry_samples_total; with an alloc-intent watcher
tpukube_plugin_intent_watch_events_total; tpukube_events_total{reason}.

Syncer series: tpukube_syncer_syncs_total.

The extender's page also carries the scheduling-snapshot cache's
families (tpukube_snapshot_{rebuilds,hits}_total,
tpukube_snapshot_rebuild_seconds{quantile}, with delta maintenance on
tpukube_snapshot_delta_{applies,overflows}_total and
tpukube_snapshot_delta_apply_seconds, with the audit sentinel on
tpukube_snapshot_audit_{checks,divergence}_total), per-slice
tpukube_slice_fragmentation and tpukube_slice_largest_free_box_chips; with
bulk ingest on tpukube_ingest_nodes_total and
tpukube_ingest_seconds{quantile}; with a degraded gate wired
tpukube_degraded_mode.

With the journal on: tpukube_journal_{appends,bytes}_total,
tpukube_checkpoint_seconds{quantile}, tpukube_recovery_seconds{quantile}
and tpukube_recovery_replayed_deltas_total.

With the generation log on and a lifecycle loop:
tpukube_resync_{full,incremental,bytes}_total.

Router series (``render_router_metrics``, planner_replicas > 1):
tpukube_router_replicas, tpukube_router_rendezvous_total{outcome},
tpukube_replica_{up,nodes,slices,allocs,utilization,queue_depth}{replica},
tpukube_replica_{pods_routed,binds}_total{replica};
``render_federated_metrics`` merges them with every alive replica's
extender exposition under a ``replica`` label (the sole extender's page
verbatim at one replica).

:class:`MetricsServer` serves a page (and optionally a /statusz
document) for the plugin and syncer daemons.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional

from tpukube_torch.obs.registry import Registry, quantile  # noqa: F401
from tpukube_torch.obs.registry import format_sample as _fmt  # noqa: F401
from tpukube_torch.obs.statusz import device_health_counts

__all__ = ["build_extender_registry", "render_extender_metrics",
           "build_router_registry", "render_router_metrics",
           "render_federated_metrics",
           "build_plugin_registry", "render_plugin_metrics",
           "build_syncer_registry", "render_syncer_metrics",
           "MetricsServer"]


def build_extender_registry(extender, reconcile=None, evictions=None,
                            node_refresh=None, lifecycle=None) -> Registry:
    """Registry for an Extender (tpukube_torch.sched.extender); pass the
    daemon's AllocReconcileLoop / EvictionExecutor /
    NodeTopologyRefreshLoop / PodLifecycleReleaseLoop to export their
    counters (a flat releases counter under churn means the release
    watch is dead and chips are leaking)."""
    reg = Registry()
    # everything is pull-based (fn/values_fn against the live daemon
    # objects): a registry built once and rendered per scrape must never
    # serve construction-time snapshots of the north-star series
    reg.gauge("tpu_chip_utilization_percent",
              fn=lambda: 100.0 * extender.state.utilization())

    reg.summary("gang_schedule_latency_seconds",
                quantiles=(0.5, 0.9, 0.99),
                values_fn=lambda: list(extender.gang.commit_latencies))
    # the distribution the summary's fixed quantiles flatten: the gang
    # manager's persistent histogram — monotonic cumulative bucket
    # counters (observed at commit time, never a window snapshot)
    reg.register(extender.gang.commit_hist)

    reg.gauge("tpukube_ici_links_down", fn=lambda: sum(
        len(extender.state.broken_links(sid))
        for sid in extender.state.slice_ids()
    ))

    reg.counter("tpukube_binds_total",
                fn=lambda: extender.binds_total)
    reg.counter("tpukube_gang_rollbacks_total",
                fn=lambda: extender.gang.rollbacks)
    reg.counter("tpukube_preemptions_total",
                fn=lambda: extender.preemptions)

    web = reg.summary("tpukube_webhook_latency_seconds",
                      quantiles=(0.5, 0.99), emit_count_sum=False)
    for handler in extender.latencies:
        web.labels(_values_fn=(lambda h=handler: list(extender.latencies[h])),
                   handler=handler)
    # per-handler monotonic buckets, observed where the daemon records
    # each sample (the extender's persistent histogram)
    reg.register(extender.webhook_hist)

    # evicted-but-unconfirmed preemption victims: non-zero means gang
    # binds are gated on graceful terminations in progress
    reg.gauge("tpukube_gang_victims_terminating",
              fn=lambda: extender.gang.terminating_count())

    pending = reg.gauge("tpukube_evictions_pending")
    if evictions is not None:
        pending.set_function(lambda: evictions.depth())
        reg.counter("tpukube_evictions_total",
                    fn=lambda: evictions.evicted)
        reg.counter("tpukube_evictions_blocked_total",
                    fn=lambda: evictions.blocked)
        reg.counter("tpukube_eviction_failures_total",
                    fn=lambda: evictions.failures)
        # a PDB-wedged eviction is a capacity leak in progress: alarm on
        # age, not just depth
        reg.gauge("tpukube_eviction_oldest_age_seconds",
                  fn=lambda: evictions.oldest_age_seconds())
    else:
        # no executor: the queue depth is still the operator's
        # double-allocation early-warning
        pending.set_function(lambda: len(extender.pending_evictions))
    if reconcile is not None:
        reg.counter("tpukube_reconciles_total",
                    fn=lambda: reconcile.reconciled)
    if node_refresh is not None:
        reg.counter("tpukube_node_refreshes_total",
                    fn=lambda: node_refresh.refreshed)
    if lifecycle is not None:
        reg.counter("tpukube_lifecycle_releases_total",
                    fn=lambda: lifecycle.released)
    events = getattr(extender, "events", None)
    if events is not None:
        _add_events_counter(reg, events)
    # epoch-cached scheduling snapshot: cache effectiveness counters and
    # the per-slice fragmentation numbers the cache makes cheap to serve
    _add_snapshot_metrics(reg, extender.snapshots)
    # durable-state journal (sched/journal.py): series render only when
    # journal_enabled built a StateJournal — the exposition stays
    # byte-identical with the journal off
    if extender.journal is not None:
        _add_journal_metrics(reg, extender.journal)
    # bulk cold-start ingestion and generation-based incremental
    # resync: series render only while the features are on
    if extender.bulk_ingest:
        st = extender.state
        reg.counter(
            "tpukube_ingest_nodes_total",
            fn=lambda: st.ingest_nodes_total,
            help_text="Nodes ingested through the bulk cold-start "
                      "fast path (handle('upsert_nodes')).")
        reg.summary(
            "tpukube_ingest_seconds",
            quantiles=(0.5, 0.99),
            values_fn=st.ingest_seconds_snapshot,
            help_text="Wall time per bulk-ingest batch (probe + "
                      "seeding; the deferred decode drains on the "
                      "background warmer).")
    if (lifecycle is not None
            and getattr(extender, "resync_incremental", False)
            and hasattr(lifecycle, "resync_full")):
        reg.counter(
            "tpukube_resync_full_total",
            fn=lambda: lifecycle.resync_full,
            help_text="Lifecycle resyncs that read the FULL ledger "
                      "(the one bootstrap read, plus any generation-"
                      "log gap/restart fallback).")
        reg.counter(
            "tpukube_resync_incremental_total",
            fn=lambda: lifecycle.resync_incremental,
            help_text="Lifecycle resyncs served O(Δ) from the "
                      "generation log (allocs_since adds/removes).")
        reg.counter(
            "tpukube_resync_bytes_total",
            fn=lambda: lifecycle.resync_bytes,
            help_text="Wire-shape bytes the resync reads moved "
                      "(encoded alloc lengths) — O(changed-allocs) "
                      "per churn wave when the incremental path "
                      "holds.")
    # batched scheduling cycles (sched/cycle.py): series render only
    # when batch_enabled actually built a planner — the default
    # exposition stays byte-identical with batching off
    cycle = getattr(extender, "cycle", None)
    if cycle is not None:
        _add_cycle_metrics(reg, cycle)
    # multi-tenant serving plane (tenancy/): series render only when
    # tenancy_enabled built a TenantPlane — tenancy-off exposition
    # stays byte-identical
    tenants = getattr(extender, "tenants", None)
    if tenants is not None:
        _add_tenant_metrics(reg, tenants)
    # decision provenance + cycle phase profiling (obs/decisions.py):
    # series render only when decisions_enabled built a DecisionLog —
    # provenance-off exposition stays byte-identical
    decisions = getattr(extender, "decisions", None)
    if decisions is not None:
        _add_decision_metrics(reg, extender, decisions)
    # capacity analytics & demand forensics (obs/capacity.py): series
    # render only when capacity_enabled built a CapacityRecorder —
    # capacity-off exposition stays byte-identical
    capacity = getattr(extender, "capacity", None)
    if capacity is not None:
        _add_capacity_metrics(reg, capacity)
    # fleet elasticity (sched/drain.py + sched/autoscale.py): series
    # render only when the flags built the objects — elasticity-off
    # exposition stays byte-identical
    drain = getattr(extender, "drain", None)
    if drain is not None:
        _add_drain_metrics(reg, drain)
    autoscaler = getattr(extender, "autoscaler", None)
    if autoscaler is not None:
        _add_autoscaler_metrics(reg, autoscaler)
    # the apiserver channel's retry/circuit layer: series render only
    # when a daemon wired the channel objects — sim extenders keep the
    # default exposition
    _add_retry_metrics(
        reg,
        retriers=[getattr(extender, "api_retrier", None)],
        circuits=[getattr(extender, "api_circuit", None)],
    )
    if extender.degraded_gate is not None:
        reg.gauge(
            "tpukube_degraded_mode",
            fn=lambda: 1.0 if extender._degraded_reason() else 0.0,
            help_text="1 while the extender fails filter/bind safe "
                      "because its apiserver circuit is open.")
    return reg


def _add_snapshot_metrics(reg: Registry, snapshots) -> None:
    """Scheduling-snapshot cache families (sched/snapshot.py). A flat
    hits counter under webhook load means every cycle is rebuilding (an
    epoch bump on a read path, or a mutation storm)."""
    reg.counter(
        "tpukube_snapshot_rebuilds_total",
        fn=lambda: snapshots.rebuilds,
        help_text="Scheduling-snapshot rebuilds (one per ledger/"
                  "reservation epoch actually consulted).")
    reg.counter(
        "tpukube_snapshot_hits_total",
        fn=lambda: snapshots.hits,
        help_text="Snapshot lookups answered from the epoch cache "
                  "without re-deriving grids from the ledger.")
    reg.summary(
        "tpukube_snapshot_rebuild_seconds",
        quantiles=(0.5, 0.99),
        values_fn=snapshots.rebuild_seconds_snapshot,
        help_text="Wall time of snapshot rebuilds (coord-set capture; "
                  "sweep tables build lazily on first query).")
    if snapshots.delta_enabled:
        # incremental-maintenance series render only while it is on
        reg.counter(
            "tpukube_snapshot_delta_applies_total",
            fn=lambda: snapshots.delta_applies,
            help_text="Snapshot advances served by applying the queued "
                      "SnapshotDeltas (O(Δ)) instead of rebuilding "
                      "O(chips) from the ledger.")
        reg.counter(
            "tpukube_snapshot_delta_overflows_total",
            fn=lambda: snapshots.delta_overflows,
            help_text="Advances the delta log could not cover (bound "
                      "overflow or an unnoted bump) — each fell back "
                      "to a full rebuild. A growing rate means the log "
                      "bound trails the batch depth.")
        reg.summary(
            "tpukube_snapshot_delta_apply_seconds",
            quantiles=(0.5, 0.99),
            values_fn=snapshots.delta_apply_seconds_snapshot,
            help_text="Wall time of O(Δ) delta advances (one sample "
                      "per advance, covering every queued delta).")
    if snapshots.audit_rate > 0.0:
        reg.counter(
            "tpukube_snapshot_audit_checks_total",
            fn=lambda: snapshots.audit_checks,
            help_text="Sampled cache-hit audits: snapshot rebuilt from "
                      "the ledger and compared against the cache.")
        reg.counter(
            "tpukube_snapshot_audit_divergence_total",
            fn=lambda: snapshots.audit_divergences,
            help_text="Audits that found the cached snapshot diverging "
                      "from the ledger — a mutation path missing an "
                      "epoch bump. Any nonzero value is a bug.")

    # every read below goes through observe(): a scrape must not count
    # its own lookups as cache hits
    def _slice_fn(sid: str, compute):
        def get() -> float:
            ss = snapshots.observe().slices.get(sid)
            return float(compute(ss)) if ss is not None else 0.0
        return get

    frag = reg.gauge(
        "tpukube_slice_fragmentation",
        help_text="Free-space fragmentation per ICI slice: 1 - "
                  "(largest free box)/(free chips); 0 = one perfect "
                  "box, -> 1 as free space shatters.")
    largest = reg.gauge(
        "tpukube_slice_largest_free_box_chips",
        help_text="Volume of the largest fully-free contiguous box "
                  "per ICI slice — the biggest gang that could still "
                  "land without preemption.")
    for sid in snapshots.observe().slice_ids():
        frag.labels(slice=sid).set_function(
            _slice_fn(sid, lambda ss: ss.fragmentation()))
        largest.labels(slice=sid).set_function(
            _slice_fn(sid, lambda ss: ss.largest_free_box()))


def _add_journal_metrics(reg: Registry, journal) -> None:
    """Durable-state journal families (sched/journal.py): WAL append
    throughput and volume, checkpoint latency, and the recovery
    numbers operators alarm on (a recovery_seconds sample near the
    cold-rebuild wall means the checkpoint cadence — or the WAL bound
    — is not keeping the replay tail short)."""
    reg.counter(
        "tpukube_journal_appends_total",
        fn=lambda: journal.appends,
        help_text="WAL records appended (one per ledger/gang mutation "
                  "seam).")
    reg.counter(
        "tpukube_journal_bytes_total",
        fn=lambda: journal.bytes_total,
        help_text="Bytes written to the WAL (pre-rotation total).")
    reg.summary(
        "tpukube_checkpoint_seconds",
        quantiles=(0.5, 0.99),
        values_fn=journal.checkpoint_seconds_snapshot,
        help_text="Wall time of checkpoint writes (serialize + fsync + "
                  "atomic rename, on the journal's drain thread).")
    reg.summary(
        "tpukube_recovery_seconds",
        quantiles=(0.5,),
        values_fn=journal.recovery_seconds_snapshot,
        help_text="Wall time of journal recoveries (checkpoint load + "
                  "WAL replay + apiserver reconcile), one sample per "
                  "recovery this process ran.")
    reg.counter(
        "tpukube_recovery_replayed_deltas_total",
        fn=lambda: journal.replayed_total,
        help_text="WAL records replayed by recoveries — the Δ in the "
                  "O(Δ-since-checkpoint) restart story.")

def render_extender_metrics(extender, reconcile=None, evictions=None,
                            node_refresh=None, lifecycle=None) -> str:
    """Prometheus text for an Extender — see build_extender_registry."""
    return build_extender_registry(
        extender, reconcile=reconcile, evictions=evictions,
        node_refresh=node_refresh, lifecycle=lifecycle,
    ).render()


def _add_cycle_metrics(reg: Registry, cycle) -> None:
    """Batched-scheduling-cycle families (sched/cycle.py): throughput
    counters (``rate(tpukube_cycle_pods_planned_total)`` is
    pods-scheduled/sec), the plan-hit/miss split, batch-size and
    cycle-wall distributions. A flat hits counter with batching on means
    webhooks are not finding their plans."""
    reg.counter(
        "tpukube_cycles_total",
        fn=lambda: cycle.cycles,
        help_text="Batch scheduling cycles run (one snapshot pin and "
                  "one queue drain each).")
    reg.counter(
        "tpukube_cycle_pods_planned_total",
        fn=lambda: cycle.pods_planned,
        help_text="Pods planned by batch cycles; its rate is "
                  "pods-scheduled/sec.")
    reg.counter(
        "tpukube_cycle_plan_hits_total",
        fn=lambda: cycle.plan_hits,
        help_text="Webhooks answered from the batch plan (a lookup, "
                  "not a re-plan).")
    reg.counter(
        "tpukube_cycle_plan_misses_total",
        fn=lambda: cycle.plan_misses,
        help_text="Webhooks the plan could not answer (fresh pod, "
                  "changed node set, deferred preemption) — the "
                  "legacy per-pod path served them.")
    reg.counter(
        "tpukube_cycle_assumes_total",
        fn=lambda: cycle.assumes,
        help_text="Placements committed as assumed allocations at plan "
                  "time (consumed — or undone — by /bind).")
    reg.summary(
        "tpukube_cycle_batch_size",
        quantiles=(0.5, 0.99),
        values_fn=lambda: list(cycle.batch_sizes),
        help_text="Pods planned per cycle (recent window).")
    reg.summary(
        "tpukube_cycle_wall_seconds",
        quantiles=(0.5, 0.99),
        values_fn=lambda: list(cycle.cycle_walls),
        help_text="Wall time per batch cycle (recent window; the "
                  "_bucket histogram is cumulative).")
    # the cumulative histogram the summary's window flattens
    reg.register(cycle.cycle_hist)
    # every planned pod's admitted-to-planned age
    reg.register(cycle.queue_age_hist)
    reg.gauge(
        "tpukube_cycle_queue_depth",
        fn=lambda: cycle.queue_depth(),
        help_text="Pending pods admitted to the scheduling queue but "
                  "not yet planned.")


def _add_tenant_metrics(reg: Registry, tenants) -> None:
    """Per-tenant serving-plane families (tenancy/): usage and
    dominant shares from the epoch-cached TenantLedger, quota caps,
    and the shed/denial counters the admission gate maintains. One
    child per tenant the plane knows (quota'd, with usage, or already
    refused); renderers rebuild per scrape so late tenants appear on
    the next pull."""
    names = tenants.known_tenants()

    chips = reg.gauge(
        "tpukube_tenant_chips_used",
        help_text="Whole-chip equivalents held per tenant (vTPU "
                  "shares count 1/n; gang reservations included).")
    hbm = reg.gauge(
        "tpukube_tenant_hbm_used_bytes",
        help_text="HBM bytes held per tenant.")
    share = reg.gauge(
        "tpukube_tenant_dominant_share",
        help_text="DRF dominant share per tenant: max(chips share, "
                  "HBM share) of cluster capacity.")
    q_chips = reg.gauge(
        "tpukube_tenant_quota_chips",
        help_text="Configured whole-chip quota per tenant (only "
                  "capped tenants render).")
    q_hbm = reg.gauge(
        "tpukube_tenant_quota_hbm_fraction",
        help_text="Configured HBM-fraction quota per tenant (only "
                  "capped tenants render).")
    shed_c = reg.counter(
        "tpukube_tenant_sheds_total",
        help_text="Admissions shed per tenant while an SLO burned at "
                  "the page threshold (TenantAdmissionShed events).")
    denied_c = reg.counter(
        "tpukube_tenant_quota_denials_total",
        help_text="Admissions refused per tenant for quota breaches "
                  "(TenantQuotaDenied events).")

    def usage_fn(tenant: str, attr: str):
        def get() -> float:
            u = tenants.ledger.usage().usage.get(tenant)
            return float(getattr(u, attr)) if u is not None else 0.0
        return get

    for t in names:
        chips.labels(tenant=t).set_function(usage_fn(t, "chips"))
        hbm.labels(tenant=t).set_function(usage_fn(t, "hbm_bytes"))
        share.labels(tenant=t).set_function(
            lambda t=t: tenants.ledger.usage().dominant_share(t))
        quota = tenants.quotas.get(t)
        if quota is not None and quota.chips is not None:
            q_chips.labels(tenant=t).set(quota.chips)
        if quota is not None and quota.hbm_fraction is not None:
            q_hbm.labels(tenant=t).set(quota.hbm_fraction)
        shed_c.labels(tenant=t).set_function(
            lambda t=t: tenants.counter_snapshot()[0].get(t, 0))
        denied_c.labels(tenant=t).set_function(
            lambda t=t: tenants.counter_snapshot()[1].get(t, 0))

    # per-tenant latency histograms: admission (filter)
    # and commit (bind) walls, observed by the extender per decision —
    # the admission family is also the per-tenant burn source
    reg.register(tenants.admission_hist)
    reg.register(tenants.commit_hist)

    burn = reg.gauge(
        "tpukube_tenancy_burn_rate",
        help_text="Last evaluated SLO burn rate per source feeding "
                  "the shedding decision (sliding window).")
    for name in tenants.burn.stats()["sources"]:
        burn.labels(slo=name).set_function(
            lambda n=name: tenants.burn.stats()["last_burns"].get(n)
            or 0.0)
    tburn = reg.gauge(
        "tpukube_tenant_slo_burn",
        help_text="Last evaluated per-tenant windowed SLO burn — the "
                  "tenant-local number a shed decision cites.")
    bstats = tenants.burn.stats()
    for tenant, burns in sorted(bstats["last_tenant_burns"].items()):
        for slo in sorted(burns):
            tburn.labels(tenant=tenant, slo=slo).set_function(
                lambda t=tenant, s=slo:
                tenants.burn.last_tenant_burn(t, s))
    reg.gauge(
        "tpukube_tenancy_shedding",
        # read-only view of the last admission-path evaluation: a
        # scrape must not slide the burn windows itself
        fn=lambda: 1.0 if tenants.burn.last_page_burning() else 0.0,
        help_text="1 while SLO burn is at the page threshold and "
                  "over-share low-priority admissions are being shed.")


def _add_decision_metrics(reg: Registry, extender, decisions) -> None:
    """Decision-provenance families (obs/decisions.py): recording volume,
    the measured record overhead (scenario 12's ``overhead_pct``
    numerator), and the cycle phase histogram — queue / pin / plan /
    answer / commit wall."""
    reg.counter(
        "tpukube_decisions_total",
        fn=lambda: decisions.recorded,
        help_text="Provenance stage events recorded (sampled pods "
                  "only).")
    reg.counter(
        "tpukube_decisions_record_seconds_total",
        fn=lambda: decisions.record_seconds,
        help_text="Cumulative wall spent recording provenance — the "
                  "measured overhead the check.sh decisions smoke "
                  "guards against a floor.")
    if extender.phase_hist is not None:
        reg.register(extender.phase_hist)


def _add_capacity_metrics(reg: Registry, capacity) -> None:
    """Capacity analytics families (obs/capacity.py): flight-recorder
    volume + measured overhead, the failed-plan taxonomy counter, and
    the live stranded ledger per root cause — the stranded-ratio
    recording rule and the fragmentation ticket alert read these."""
    from tpukube_torch.obs.capacity import UNSCHEDULABLE_REASONS

    reg.counter(
        "tpukube_capacity_samples_total",
        fn=lambda: capacity.samples_taken,
        help_text="Flight-recorder fleet samples taken (scheduling "
                  "clock cadence).")
    reg.counter(
        "tpukube_capacity_sample_seconds_total",
        fn=lambda: capacity.sample_seconds,
        help_text="Cumulative wall spent sampling + classifying — the "
                  "measured overhead the check.sh capacity smoke "
                  "floors.")
    reg.gauge(
        "tpukube_capacity_fleet_chips",
        fn=lambda: capacity.fleet_chips,
        help_text="Fleet chip count at the last flight-recorder "
                  "sample (the stranded-ratio denominator).")
    reg.gauge(
        "tpukube_capacity_recoverable_chips",
        fn=lambda: capacity._recoverable_last,
        help_text="Chips a perfect repack would recover into the "
                  "largest contiguous boxes, from the last stranded "
                  "classification (the defragmenter's objective).")
    unsched = reg.counter(
        "tpukube_unschedulable_pods",
        help_text="Failed/deferred plans root-caused by reason "
                  "(fragmented = chips free but no contiguous box; "
                  "capacity = not enough free chips anywhere).")
    chips_g = reg.gauge(
        "tpukube_capacity_stranded_chips",
        help_text="Chips requested by live stranded demands, by root "
                  "cause (ledger entries expire with their demand).")
    demands_g = reg.gauge(
        "tpukube_capacity_stranded_demands",
        help_text="Live stranded demands (gangs collapse to one), by "
                  "root cause.")
    for reason in UNSCHEDULABLE_REASONS:
        unsched.labels(reason=reason).set_function(
            lambda r=reason: capacity.unschedulable_counts().get(r, 0))
        chips_g.labels(reason=reason).set_function(
            lambda r=reason:
            capacity.stranded_by_reason().get(r, (0, 0))[1])
        demands_g.labels(reason=reason).set_function(
            lambda r=reason:
            capacity.stranded_by_reason().get(r, (0, 0))[0])


def _add_drain_metrics(reg: Registry, drain) -> None:
    """Drain choreography families (sched/drain.py): lifecycle
    counters plus the disruption-budget gauge pair scenario 15 and the
    elasticity bench read (peak moves per tick vs the configured
    budget)."""
    reg.counter(
        "tpukube_drain_started_total",
        fn=lambda: drain.drains_started,
        help_text="Drains begun (cordon + record).")
    reg.counter(
        "tpukube_drain_completed_total",
        fn=lambda: drain.drains_completed,
        help_text="Drains whose nodes were fully un-ingested.")
    reg.counter(
        "tpukube_drain_evictions_total",
        fn=lambda: drain.evictions_total,
        help_text="Pods evicted by drain migrate-or-preempt ticks "
                  "(gangs dissolve all-or-nothing).")
    reg.counter(
        "tpukube_drain_nodes_removed_total",
        fn=lambda: drain.nodes_removed_total,
        help_text="Nodes un-ingested at drain completion (the "
                  "inverse of bulk ingest: one seam per batch).")
    reg.counter(
        "tpukube_drain_chips_removed_total",
        fn=lambda: drain.chips_removed_total,
        help_text="Chips decommissioned by completed drains.")
    reg.counter(
        "tpukube_drain_slices_dropped_total",
        fn=lambda: drain.slices_dropped_total,
        help_text="Slices whose last node left at drain completion.")
    reg.gauge(
        "tpukube_drain_peak_tick_moves",
        fn=lambda: drain.peak_tick_moves,
        help_text="Worst-ever workloads moved in one drain tick — "
                  "must never exceed the configured disruption "
                  "budget (drain_max_concurrent_moves).")
    reg.gauge(
        "tpukube_drain_active",
        fn=lambda: len(drain.statusz()["active"]),
        help_text="Drains currently in the migrate-or-preempt phase.")


def _add_autoscaler_metrics(reg: Registry, autoscaler) -> None:
    """Autoscaler loop families (sched/autoscale.py): scaling actions
    and evaluation volume — the elasticity bench's time-to-capacity
    numerator rides scale_ups/nodes_added."""
    reg.counter(
        "tpukube_autoscaler_scale_ups_total",
        fn=lambda: autoscaler.scale_ups,
        help_text="Scale-up actions (one provisioned slice each, "
                  "bulk-ingested as one decision).")
    reg.counter(
        "tpukube_autoscaler_scale_downs_total",
        fn=lambda: autoscaler.scale_downs,
        help_text="Scale-down actions (one graceful slice drain "
                  "each).")
    reg.counter(
        "tpukube_autoscaler_nodes_added_total",
        fn=lambda: autoscaler.nodes_added_total,
        help_text="Nodes successfully ingested by scale-ups.")
    reg.counter(
        "tpukube_autoscaler_ticks_total",
        fn=lambda: autoscaler.ticks,
        help_text="Scaling evaluations run (amortized onto the "
                  "decision path at cooldown cadence).")


def _add_events_counter(reg: Registry, events) -> None:
    counter = reg.counter(
        "tpukube_events_total",
        help_text="Structured journal events by reason "
                  "(GangCommitted, ChipUnhealthy, ...).")
    # children for every reason seen so far; later reasons appear on
    # the next render (renderers rebuild per scrape)
    for reason in sorted(events.counts_by_reason()):
        counter.labels(reason=reason).set_function(
            lambda r=reason: events.counts_by_reason().get(r, 0))


def build_router_registry(router, lifecycle=None) -> Registry:
    """Registry for a :class:`~tpukube_torch.sched.shard.ShardRouter`
    (planner_replicas > 1): router topology, routed volume, the
    two-phase rendezvous ledger, and one summary row per replica — the
    per-replica observability leg of the sharded plane; the
    router-level series are the cross-shard rollup. With the daemon's
    ``lifecycle`` loop (whose resyncs ride the router's federated
    ``allocs_since``) its release and resync counters render too. Over
    the process transport the router also renders its replicas'
    round-trip times, health checks and wire bytes (and, with the binary
    codec, the bytes it saved); the in-process router has no wire, and
    its exposition carries none of them."""
    reg = Registry()
    reg.gauge("tpukube_router_replicas",
              fn=lambda: len(router.replicas))
    rdv = reg.counter("tpukube_router_rendezvous_total")
    rdv.labels(outcome="prepared").set_function(
        lambda: router.rendezvous_prepared)
    rdv.labels(outcome="committed").set_function(
        lambda: router.rendezvous_committed)
    rdv.labels(outcome="aborted").set_function(
        lambda: router.rendezvous_aborted)
    up = reg.gauge("tpukube_replica_up")
    nodes = reg.gauge("tpukube_replica_nodes")
    slices = reg.gauge("tpukube_replica_slices")
    allocs = reg.gauge("tpukube_replica_allocs")
    routed = reg.counter("tpukube_replica_pods_routed_total")
    binds = reg.counter("tpukube_replica_binds_total")
    util = reg.gauge("tpukube_replica_utilization")
    depth = reg.gauge("tpukube_replica_queue_depth")

    # one summary read per replica feeds the whole row, memoized for
    # this REGISTRY's lifetime: render_router_metrics builds a fresh
    # registry per scrape, so each scrape reads each replica once —
    # not once per gauge (6 HTTP round-trips per replica per scrape in
    # process mode). A dead/unreachable replica renders zeros (its
    # liveness gauge carries the signal).
    summary_memo: dict[int, dict] = {}

    def _summary(rep) -> dict:
        from tpukube_torch.sched.shard import ReplicaUnavailable

        cached = summary_memo.get(rep.index)
        if cached is not None:
            return cached
        if rep.killed:
            doc = {}
        else:
            try:
                doc = rep.transport.summary()
            except ReplicaUnavailable:
                doc = {}
        summary_memo[rep.index] = doc
        return doc

    if lifecycle is not None:
        reg.counter("tpukube_lifecycle_releases_total",
                    fn=lambda: lifecycle.released)
        if router.config.generation_log_capacity > 0:
            reg.counter("tpukube_resync_full_total",
                        fn=lambda: lifecycle.resync_full)
            reg.counter("tpukube_resync_incremental_total",
                        fn=lambda: lifecycle.resync_incremental)
            reg.counter("tpukube_resync_bytes_total",
                        fn=lambda: lifecycle.resync_bytes)
    for rep in router.replicas:
        name = rep.name
        up.labels(replica=name).set_function(
            lambda r=rep: 1.0 if r.alive else 0.0)
        nodes.labels(replica=name).set_function(
            lambda r=rep: _summary(r).get("nodes", 0))
        slices.labels(replica=name).set_function(
            lambda r=rep: len(_summary(r).get("slices", ())))
        allocs.labels(replica=name).set_function(
            lambda r=rep: _summary(r).get("allocs", 0))
        routed.labels(replica=name).set_function(
            lambda r=rep: r.pods_routed)
        binds.labels(replica=name).set_function(
            lambda r=rep: _summary(r).get("binds_total", 0))
        util.labels(replica=name).set_function(
            lambda r=rep: _summary(r).get("utilization", 0.0))
        depth.labels(replica=name).set_function(
            lambda r=rep: _summary(r).get("queue_depth", 0))
    if getattr(router, "mode", "inprocess") == "subprocess":
        _add_transport_series(reg, router)
    return reg


def _add_transport_series(reg: Registry, router) -> None:
    """The process transport's telemetry on a router's registry: per
    replica RTTs and health checks, wire bytes per op and direction, and
    the binary codec's saved bytes (only when a transport uses it)."""
    rtt = reg.summary(
        "tpukube_replica_rtt_seconds",
        help_text="Router->replica request round-trip time over "
                  "the subprocess transport, per replica.")
    checks = reg.counter(
        "tpukube_replica_health_checks_total",
        help_text="Replica health checks run by the router "
                  "(subprocess transport).")
    fails = reg.counter(
        "tpukube_replica_health_check_failures_total",
        help_text="Health checks that failed and marked the "
                  "replica dead (crash_replica semantics).")
    for rep in router.replicas:
        name = rep.name
        rtt.labels(lambda r=rep: r.transport.rtt_snapshot(), replica=name)
        checks.labels(replica=name).set_function(
            lambda r=rep: r.transport.health_checks)
        fails.labels(replica=name).set_function(
            lambda r=rep: r.transport.health_failures)
    wire = reg.counter(
        "tpukube_router_wire_bytes_total",
        help_text="Bytes over the router->replica subprocess "
                  "transport, per op and direction (dir=tx is the "
                  "request payload, dir=rx the response body).")
    snaps = []
    for rep in router.replicas:
        # snapshot at registry build: the registry is rebuilt per
        # scrape, so the values are scrape-current without taking the
        # transport lock once per rendered sample
        snap = rep.transport.wire_snapshot() \
            if hasattr(rep.transport, "wire_snapshot") else None
        if not snap:
            continue
        snaps.append((rep.name, snap))
        for op, cell in sorted(snap["by_op"].items()):
            for d in ("tx", "rx"):
                wire.labels(op=op, dir=d, replica=rep.name) \
                    .set_function(lambda v=cell[d]: v)
    if any("codec" in snap for _, snap in snaps):
        saved = reg.counter(
            "tpukube_router_wire_saved_bytes_total",
            help_text="Bytes the binary wire codec kept off the "
                      "router->replica transport, per op and replica "
                      "(pre-compression frame bytes minus bytes "
                      "actually sent).")
        for name, snap in snaps:
            for op, cell in sorted(snap["by_op"].items()):
                if "codec" not in cell:
                    continue
                delta = max(0, (cell.get("raw_tx", 0)
                                + cell.get("raw_rx", 0))
                            - (cell["tx"] + cell["rx"]))
                saved.labels(op=op, replica=name) \
                    .set_function(lambda v=delta: v)


def render_router_metrics(router, lifecycle=None) -> str:
    """Prometheus text for a ShardRouter — see build_router_registry."""
    return build_router_registry(router, lifecycle=lifecycle).render()


def _with_replica_label(line: str, replica: str) -> str:
    """One exposition sample line with ``replica="<name>"`` appended to
    its label set (added when absent — a worker never labels itself)."""
    if "{" in line:
        close = line.rindex("}")
        inner = line[line.index("{") + 1:close]
        if 'replica="' in inner:
            return line
        head = line[:line.index("{")]
        return (f'{head}{{{inner},replica="{replica}"}}'
                + line[close + 1:])
    name, _, value = line.partition(" ")
    return f'{name}{{replica="{replica}"}} {value}'


def _merge_exposition(acc: dict, text: str,
                      replica: Optional[str]) -> None:
    """Fold one exposition into the family accumulator: HELP/TYPE are
    kept from the FIRST source that declared them (the replicas run
    identical code, so later declarations are identical), samples
    append under their family so the merged render keeps each family
    contiguous with exactly one TYPE line — the promlint contract."""
    fam: Optional[str] = None
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            name = line.split(None, 3)[2]
            cell = acc.setdefault(
                name, {"help": None, "type": None, "samples": []})
            kind = "help" if line.startswith("# HELP ") else "type"
            if cell[kind] is None:
                cell[kind] = line
            fam = name
            continue
        if line.startswith("#"):
            continue
        name = line.split("{", 1)[0].split(None, 1)[0]
        family = fam if fam is not None and name.startswith(fam) \
            else name
        cell = acc.setdefault(
            family, {"help": None, "type": None, "samples": []})
        if replica is not None:
            line = _with_replica_label(line, replica)
        cell["samples"].append(line)


def render_federated_metrics(router, lifecycle=None) -> str:
    """The router's aggregated /metrics: the router's own
    registry plus every alive replica's FULL worker exposition merged
    in with a ``replica`` label — one scrape target for the whole
    sharded control plane, replacing N per-replica scrape configs.
    With ``planner_replicas: 1`` in-process this returns the sole
    planner's exposition verbatim (off-is-off: byte-identical to the
    unsharded scrape)."""
    sole = getattr(router, "_sole", None)
    if sole is not None:
        return render_extender_metrics(sole, lifecycle=lifecycle)
    from tpukube_torch.sched.shard import ReplicaUnavailable, ShardError

    acc: dict = {}
    _merge_exposition(acc, render_router_metrics(router, lifecycle), None)
    for rep in router.replicas:
        if not rep.alive:
            continue
        try:
            text = rep.transport.metrics_text()
        except (ReplicaUnavailable, ShardError):
            continue  # liveness is tpukube_replica_up's job
        _merge_exposition(acc, text, rep.name)
    parts: list[str] = []
    for cell in acc.values():
        if cell["help"] is not None:
            parts.append(cell["help"])
        if cell["type"] is not None:
            parts.append(cell["type"])
        parts.extend(cell["samples"])
    return "\n".join(parts) + "\n"


def build_plugin_registry(server, health=None, kubelet_watch=None,
                          intent_watch=None, sampler=None,
                          events=None) -> Registry:
    """Registry for a DevicePluginServer (tpukube_torch.plugin.server);
    pass the daemon's HealthWatcher / KubeletSessionWatcher to export
    their transition counters, and an alloc-intent watcher (with a
    ``watch_events`` counter) where one runs. ``sampler`` is the
    telemetry HealthSampler (obs/health.py): per-GPU health / memory /
    utilization gauges and link-error counters, one series per GPU. The
    telemetry families opt into ``# HELP`` text as in the reference."""
    reg = Registry()
    reg.counter("tpukube_plugin_allocations_total",
                fn=lambda: server.allocation_count)
    devices = reg.gauge("tpukube_plugin_devices")
    devices.labels(health="Healthy").set_function(
        lambda: device_health_counts(server._device)[0])
    devices.labels(health="Unhealthy").set_function(
        lambda: device_health_counts(server._device)[1])
    info = reg.gauge("tpukube_plugin_resource_info", emit_type=False)
    info.labels(resource=server.resource_name).set(1)
    # where the node's inventory came from: "nvml" on a real node
    reg.gauge("tpukube_plugin_inventory_source").labels(
        source=server._device.inventory_source()
    ).set(1)
    reg.gauge("tpukube_plugin_intent_depth",
              fn=lambda: server.intents.depth())
    reg.counter("tpukube_plugin_divergences_total",
                fn=lambda: server.divergences)
    if health is not None:
        reg.counter("tpukube_plugin_health_transitions_total",
                    fn=lambda: health.transitions)
    if kubelet_watch is not None:
        reg.counter("tpukube_plugin_reregistrations_total",
                    fn=lambda: kubelet_watch.reregistrations)
        # the registration retrier's counters (unified retry layer)
        _add_retry_metrics(
            reg, retriers=[getattr(kubelet_watch, "retrier", None)]
        )
    if intent_watch is not None:
        reg.counter("tpukube_plugin_intent_watch_events_total",
                    fn=lambda: intent_watch.watch_events)
    if sampler is not None:
        _add_telemetry_metrics(reg, sampler)
    if events is not None:
        _add_events_counter(reg, events)
    return reg


def _add_retry_metrics(reg: Registry, retriers=(), circuits=()) -> None:
    """Retry/circuit families (core/retry.py), one child per named
    Retrier/CircuitBreaker — shared by the extender's and the plugin's
    builders so the series shapes can never drift apart."""
    retriers = [r for r in retriers if r is not None]
    circuits = [c for c in circuits if c is not None]
    if retriers:
        attempts = reg.counter(
            "tpukube_retry_attempts_total",
            help_text="Call attempts made under the unified retry "
                      "policy, by operation.")
        retries = reg.counter(
            "tpukube_retry_retries_total",
            help_text="Attempts beyond the first (each one is a "
                      "transient failure that was retried).")
        exhausted = reg.counter(
            "tpukube_retry_exhausted_total",
            help_text="Calls that gave up after max attempts or the "
                      "overall deadline (RetryExhausted events).")
        for r in retriers:
            attempts.labels(op=r.name).set_function(
                lambda r=r: r.stats.attempts)
            retries.labels(op=r.name).set_function(
                lambda r=r: r.stats.retries)
            exhausted.labels(op=r.name).set_function(
                lambda r=r: r.stats.exhausted)
    if circuits:
        state = reg.gauge(
            "tpukube_circuit_state",
            help_text="Breaker state: 0 closed, 1 half-open, 2 open.")
        opens = reg.counter(
            "tpukube_circuit_opens_total",
            help_text="Times the breaker tripped open (CircuitOpen "
                      "events).")
        for c in circuits:
            state.labels(circuit=c.name).set_function(
                lambda c=c: c.state_code())
            opens.labels(circuit=c.name).set_function(
                lambda c=c: c.opens)


def _add_telemetry_metrics(reg: Registry, sampler) -> None:
    """Per-GPU telemetry families under the reference's chip names
    (pull-based over the sampler's latest samples; children exist for
    every GPU the sampler has seen)."""
    healthy = reg.gauge(
        "tpukube_chip_healthy",
        help_text="1 while the GPU serves traffic, 0 after a health "
                  "fault (per-GPU ListAndWatch health).")
    duty = reg.gauge(
        "tpukube_chip_duty_cycle_percent",
        help_text="Instantaneous utilization per GPU (NVML; "
                  "synthesized on the sim backend).")
    hbm_used = reg.gauge(
        "tpukube_chip_hbm_used_bytes",
        help_text="Device memory in use per GPU (NVML; synthesized on "
                  "the sim backend).")
    hbm_total = reg.gauge(
        "tpukube_chip_hbm_total_bytes",
        help_text="Device memory capacity per GPU.")
    link_errs = reg.counter(
        "tpukube_chip_ici_link_errors_total",
        help_text="Cumulative link-error count per GPU (the sim's "
                  "downed links); a non-zero rate means a degraded link.")
    flips = reg.counter(
        "tpukube_chip_health_transitions_total",
        help_text="Health-state transitions observed per GPU "
                  "(healthy/degraded/unhealthy flips).")

    def field(did: str, attr: str, default: float = 0.0):
        def get() -> float:
            t = sampler.sample(did)
            return float(getattr(t, attr)) if t is not None else default
        return get

    for t in sampler.latest():
        did = t.device_id
        healthy.labels(chip=did).set_function(
            lambda d=did: 1.0 if (
                (s := sampler.sample(d)) is not None
                and s.state != "unhealthy"
            ) else 0.0
        )
        duty.labels(chip=did).set_function(
            field(did, "duty_cycle_percent"))
        hbm_used.labels(chip=did).set_function(field(did, "hbm_used_bytes"))
        hbm_total.labels(chip=did).set_function(
            field(did, "hbm_total_bytes"))
        link_errs.labels(chip=did).set_function(
            field(did, "ici_link_errors"))
        flips.labels(chip=did).set_function(
            lambda d=did: sampler.transition_count(d))
    chips = reg.gauge(
        "tpukube_node_chips",
        help_text="This node's GPUs by health state (healthy / "
                  "degraded = up but on a downed link / unhealthy).")
    for state in ("healthy", "degraded", "unhealthy"):
        chips.labels(state=state).set_function(
            lambda s=state: sampler.state_counts().get(s, 0))
    reg.counter(
        "tpukube_telemetry_samples_total",
        fn=lambda: sampler.samples,
        help_text="Telemetry polls taken by the node agent's sampler.")


def render_plugin_metrics(server, health=None, kubelet_watch=None,
                          intent_watch=None, sampler=None,
                          events=None) -> str:
    """Prometheus text for a DevicePluginServer — see
    build_plugin_registry."""
    return build_plugin_registry(
        server, health=health, kubelet_watch=kubelet_watch,
        intent_watch=intent_watch, sampler=sampler, events=events,
    ).render()


def build_syncer_registry(syncer) -> Registry:
    reg = Registry()
    reg.counter("tpukube_syncer_syncs_total", fn=lambda: syncer.syncs)
    return reg


def render_syncer_metrics(syncer) -> str:
    """Prometheus text for a NodeAnnotationSyncer sidecar."""
    return build_syncer_registry(syncer).render()


class MetricsServer:
    """Minimal threaded HTTP server for the node agent and the syncer:
    /metrics always, /statusz when a ``statusz`` document callback is
    wired (the plugin daemon passes ``obs.statusz.plugin_statusz``)."""

    def __init__(self, render: Callable[[], str], host: str = "127.0.0.1",
                 port: int = 0,
                 statusz: Optional[Callable[[], Any]] = None):
        render_fn = render
        statusz_fn = statusz

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, body: bytes, content_type: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802  (http.server API)
                if self.path == "/metrics":
                    self._reply(
                        render_fn().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/statusz" and statusz_fn is not None:
                    self._reply(
                        json.dumps(statusz_fn(), sort_keys=True).encode(),
                        "application/json",
                    )
                else:
                    self.send_error(404)

            def log_message(self, *args):  # no per-request stderr lines
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="tpukube-metrics",
        )
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
