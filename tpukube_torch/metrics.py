"""Metrics export — the port's own copy of the default plane of
``tpukube/metrics.py``, thin functions over ``tpukube_torch.obs.registry``:
``build_extender_registry``/``render_extender_metrics`` (``serve`` in
``tpukube_torch.sched.extender`` answers ``GET /metrics`` with it) and
``build_plugin_registry``/``render_plugin_metrics`` for the device
plugin (``tpukube_torch.plugin.server``).

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
  with a lifecycle loop: tpukube_lifecycle_releases_total;
  tpukube_events_total{reason}.

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
tpukube_telemetry_samples_total; tpukube_events_total{reason}.

Absent, because the port lacks their source (each listed in ROADMAP.md,
none faked): the reconcile and node-refresh counters (their loops), the
plugin's intent-watch counter (the alloc-intent watcher), the
scheduling-snapshot cache stats and per-slice fragmentation (the cache's
``stats()``/``observe()``), the bulk-ingest and incremental-resync series,
and the journal, batch-cycle, tenancy, decision-provenance, capacity,
drain, autoscaler, circuit and degraded-mode sections.
"""

from __future__ import annotations

from tpukube_torch.obs.registry import Registry, format_sample as _fmt  # noqa: F401

__all__ = ["build_extender_registry", "render_extender_metrics",
           "build_plugin_registry", "render_plugin_metrics"]


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


def device_health_counts(device) -> tuple[int, int]:
    """(healthy, unhealthy) over a device manager's current device list —
    the port's copy of ``tpukube/obs/statusz.py``'s one classification."""
    healthy = unhealthy = 0
    for _, h in device.device_list():
        if h.value == "Healthy":
            healthy += 1
        else:
            unhealthy += 1
    return healthy, unhealthy


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


def _add_retry_metrics(reg: Registry, retriers=()) -> None:
    """Retry families (core/retry.py), one child per named Retrier (the
    reference's circuit families wait for its CircuitBreaker)."""
    retriers = [r for r in retriers if r is not None]
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
