"""Metrics export of the extender — the port's own copy of the default
plane of ``tpukube/metrics.py``: ``build_extender_registry`` and
``render_extender_metrics``, thin functions over
``tpukube_torch.obs.registry``. ``serve`` in
``tpukube_torch.sched.extender`` answers ``GET /metrics`` with it.

Exported series, under the reference's names and types:
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
  with a lifecycle loop: tpukube_lifecycle_releases_total;
  tpukube_events_total{reason}.

Absent, because the port lacks their source (each listed in ROADMAP.md,
none faked): the reconcile and node-refresh counters (their loops), the
scheduling-snapshot cache stats and per-slice fragmentation (the cache's
``stats()``/``observe()``), the bulk-ingest and incremental-resync series,
and the journal, batch-cycle, tenancy, decision-provenance, capacity,
drain, autoscaler, retry/circuit and degraded-mode sections.
"""

from __future__ import annotations

from tpukube_torch.obs.registry import Registry, format_sample as _fmt  # noqa: F401

__all__ = ["build_extender_registry", "render_extender_metrics"]


def build_extender_registry(extender, evictions=None,
                            lifecycle=None) -> Registry:
    """Registry for an Extender (tpukube_torch.sched.extender); pass the
    daemon's EvictionExecutor / PodLifecycleReleaseLoop to export their
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
    if lifecycle is not None:
        reg.counter("tpukube_lifecycle_releases_total",
                    fn=lambda: lifecycle.released)
    events = getattr(extender, "events", None)
    if events is not None:
        _add_events_counter(reg, events)
    return reg


def render_extender_metrics(extender, evictions=None, lifecycle=None) -> str:
    """Prometheus text for an Extender — see build_extender_registry."""
    return build_extender_registry(
        extender, evictions=evictions, lifecycle=lifecycle,
    ).render()


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
