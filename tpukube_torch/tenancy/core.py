"""The multi-tenant serving plane — the port's own copy of
``tpukube/tenancy/core.py``: tenancy policy over the mechanisms the
scheduler already has.

BASELINE configs 3 and 5 (HBM-quota vGPU sharing; train + burst
inference) share the card: the fractional layer (``device/gpu.py``,
``native/cudaguard.cpp``), the preemption planner and the burn-rate math
(``obs/slo.py``) are the mechanisms, and this module is the TRAFFIC
policy over them — who may take how much, in what order, and what gets
shed when the control plane's SLOs burn. Three pieces:

  * **Tenant model + ledger** — the tenant id comes from a pod label
    (``tenancy_label``, default ``tpu.qiniu.com/tenant``; unlabeled
    pods belong to ``tenancy_default_tenant``). :class:`TenantLedger`
    derives per-tenant, per-slice usage (whole-chip equivalents and
    HBM bytes) as a PURE FUNCTION of the cluster ledger plus live gang
    reservations, cached on the same (ledger epoch, gang epoch) key the
    scheduling snapshot uses — so tenant accounting can never diverge
    from the placement truth (there is no second bookkeeping to leak).
    Bound pods carry their tenant in the alloc annotation's env
    (``TPU_KUBE_TENANT``), so attribution survives an extender restart
    exactly like the allocations themselves.
  * **DRF fairness** — a tenant's *dominant share* is the classic DRF
    quantity: max(chips used / cluster chips, HBM used / cluster HBM).
    :meth:`TenantPlane.drf_order` orders the batched scheduling queue
    (sched/cycle.py) progressively: within a priority band, the next
    unit (a whole gang, or one stray pod) always comes from the tenant
    with the lowest virtual dominant share, the virtual share charged
    as units are picked — so a thousand-pod burst from one tenant
    interleaves with everyone else's instead of draining first. The
    preemption planner gets the mirror-image signal: victims from
    tenants furthest OVER their share are preferred at equal priority
    cost (``policy.find_preemption_plan``'s ``overshare`` bias).
  * **SLO-aware admission** — :class:`BurnMonitor` evaluates the
    DEFAULT_SLOS burn rates (obs/slo.py math, the same objectives the
    Prometheus rules encode) directly over the extender's own
    gang-commit and webhook histograms, on a sliding window of the
    scheduling clock. While any SLO burns at the page threshold,
    low-priority non-gang admissions from tenants above the burst
    population's mean share are SHED — refused with a typed journal
    event (``TenantAdmissionShed``), never silently dropped; the
    scheduler's requeue makes refusal a deferral. Per-tenant quota
    breaches are refused the same way (``TenantQuotaDenied``).

Everything here is constructed only when ``tenancy_enabled`` is on;
with the default OFF config the extender holds ``tenants = None``, no
tenant series render, and every placement path is byte-identical to
the behavior without the plane (a NEUTRAL plane — one tenant, no
quotas, no burn — changes no placement either).

Parity with the reference rests on iteration order and float rounding
(``drf_order``'s tie-breaks, ``overshare_map``'s ``round(..., 9)``), so
the code below follows the reference line for line. ``decisions`` is the
decision-provenance hook: the extender hands its ``DecisionLog`` here
when ``decisions_enabled`` is on, so each refusal records its verdict.

Locking: the plane owns one leaf lock for its counters and the burn
monitor's window state; usage snapshots build OUTSIDE it by reading
the gang and ledger locks (decision -> gang -> ledger order, same as
the scheduling snapshot). Callers are the webhook paths (under the
decision lock) and the metrics/statusz renderers (lock-free reads of
the epoch-cached snapshot).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from tpukube_torch.core.types import (
    RESOURCE_TPU,
    RESOURCE_VTPU,
    PodInfo,
    parse_device_id,
)
from tpukube_torch.device.gpu import ENV_KUBE_TENANT
from tpukube_torch.obs import slo as slo_mod
from tpukube_torch.obs.registry import Histogram

log = logging.getLogger("tpukube_torch.tenancy")

#: margin over the burst population's mean share before a tenant
#: counts as over-share for SLO shedding — strictly-above-the-mean
#: would shed at fair equilibrium on float noise
OVER_SHARE_MARGIN = 1.05


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant caps. ``chips`` bounds whole-chip equivalents
    (vTPU shares count fractionally); ``hbm_fraction`` bounds the
    tenant's slice of total cluster HBM. None = uncapped."""

    chips: Optional[float] = None
    hbm_fraction: Optional[float] = None


def parse_quotas(spec: str) -> dict[str, TenantQuota]:
    """Parse the ``tenancy_quotas`` config string:
    ``"teamA=chips:16,hbm:0.25;teamB=chips:8"`` — ``;`` separates
    tenants, ``,`` separates caps, ``chips`` is a positive number of
    whole-chip equivalents, ``hbm`` a fraction of cluster HBM in
    (0, 1]. Raises ValueError with the offending fragment."""
    out: dict[str, TenantQuota] = {}
    if not spec.strip():
        return out
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, caps_raw = entry.partition("=")
        name = name.strip()
        if not sep or not name or not caps_raw.strip():
            raise ValueError(
                f"tenancy_quotas entry {entry!r}: want "
                f"'<tenant>=chips:<n>[,hbm:<frac>]'"
            )
        if name in out:
            raise ValueError(f"tenancy_quotas: duplicate tenant {name!r}")
        chips: Optional[float] = None
        hbm: Optional[float] = None
        for cap in caps_raw.split(","):
            key, sep, val = cap.strip().partition(":")
            key = key.strip()
            try:
                num = float(val)
            except ValueError:
                num = float("nan")
            if not sep or num != num:
                raise ValueError(
                    f"tenancy_quotas cap {cap!r} for {name!r}: want "
                    f"'chips:<n>' or 'hbm:<frac>'"
                )
            if key == "chips":
                if num <= 0:
                    raise ValueError(
                        f"tenancy_quotas: {name!r} chips cap must be > 0"
                    )
                chips = num
            elif key == "hbm":
                if not 0 < num <= 1:
                    raise ValueError(
                        f"tenancy_quotas: {name!r} hbm cap must be in "
                        f"(0, 1]"
                    )
                hbm = num
            else:
                raise ValueError(
                    f"tenancy_quotas cap key {key!r} for {name!r}: "
                    f"known caps are 'chips' and 'hbm'"
                )
        out[name] = TenantQuota(chips=chips, hbm_fraction=hbm)
    return out


@dataclass
class TenantUsage:
    """One tenant's live consumption."""

    chips: float = 0.0       # whole-chip equivalents (vTPU shares 1/n)
    hbm_bytes: float = 0.0
    pods: int = 0
    #: chips held by shed-ELIGIBLE work (non-gang, priority at or below
    #: the shed cutoff) — the population SLO shedding reasons about
    burst_chips: float = 0.0
    #: chips per ICI slice (gang reservation chips included)
    by_slice: dict[str, float] = field(default_factory=dict)


class _UsageSnapshot:
    """Per-tenant usage plus cluster capacity, frozen at an epoch key."""

    __slots__ = ("key", "usage", "capacity_chips", "capacity_hbm",
                 "vtpu_shares")

    def __init__(self, key, usage: dict[str, TenantUsage],
                 capacity_chips: int, capacity_hbm: int,
                 vtpu_shares: int):
        self.key = key
        self.usage = usage
        self.capacity_chips = capacity_chips
        self.capacity_hbm = capacity_hbm
        #: largest shares_per_chip advertised by any node (1 = no vTPU
        #: nodes) — the pre-bind chip-equivalent estimate for vTPU asks
        self.vtpu_shares = vtpu_shares

    def dominant_share(self, tenant: str) -> float:
        u = self.usage.get(tenant)
        if u is None:
            return 0.0
        chips = u.chips / self.capacity_chips if self.capacity_chips else 0.0
        hbm = u.hbm_bytes / self.capacity_hbm if self.capacity_hbm else 0.0
        return max(chips, hbm)

    def burst_share(self, tenant: str) -> float:
        u = self.usage.get(tenant)
        if u is None or not self.capacity_chips:
            return 0.0
        return u.burst_chips / self.capacity_chips

    def mean_burst_share(self) -> float:
        """Mean burst share over tenants that HAVE burst usage — the
        over-share reference for SLO shedding (a tenant above it is
        consuming more of the contended burst plane than its peers)."""
        shares = [self.burst_share(t) for t, u in self.usage.items()
                  if u.burst_chips > 0]
        return sum(shares) / len(shares) if shares else 0.0


class TenantLedger:
    """Per-tenant usage derived from the cluster ledger + live gang
    reservations, epoch-cached. There is deliberately NO incremental
    bookkeeping: usage is recomputed (at most once per epoch pair)
    from the same state every placement decision reads, so tenant
    accounting cannot drift from placement truth."""

    def __init__(self, state, gang, default_tenant: str,
                 shed_priority_max: int = 0) -> None:
        self._state = state
        self._gang = gang
        self._default = default_tenant
        self._shed_priority_max = shed_priority_max
        self._lock = threading.Lock()  # leaf: guards only the cache slot
        self._snap: Optional[_UsageSnapshot] = None

    def tenant_of_alloc(self, alloc) -> str:
        return alloc.env.get(ENV_KUBE_TENANT) or self._default

    def usage(self) -> _UsageSnapshot:
        key = (self._state.epoch(), self._gang.epoch())
        with self._lock:
            snap = self._snap
        if snap is not None and snap.key == key:
            return snap
        snap = self._build(key)
        if (self._state.epoch(), self._gang.epoch()) == key:
            with self._lock:
                self._snap = snap
        return snap  # raced a mutation: serve this one uncached

    def _build(self, key) -> _UsageSnapshot:
        state, gang = self._state, self._gang
        usage: dict[str, TenantUsage] = {}
        cap_chips = 0
        cap_hbm = 0
        vtpu_shares = 1
        views = {}
        for name in state.node_names():
            view = state.node(name)
            if view is None:
                continue
            views[name] = view
            vtpu_shares = max(vtpu_shares, view.shares_per_chip)
            for chip in view.info.chips:
                if chip.health.value == "Healthy":
                    cap_chips += 1
                    cap_hbm += chip.hbm_bytes

        def entry(tenant: str) -> TenantUsage:
            u = usage.get(tenant)
            if u is None:
                u = usage[tenant] = TenantUsage()
            return u

        gang_pods: set[str] = set()
        for res in gang.snapshot():
            gang_pods.update(res.assigned)
            tenant = res.tenant or self._default
            u = entry(tenant)
            for sid, coords in res.slice_coords.items():
                unassigned = res.unassigned_in(sid)
                if not unassigned:
                    continue
                hosts = state.hosts_by_coord(sid)
                for c in unassigned:
                    host = hosts.get(c)
                    view = views.get(host) if host is not None else None
                    u.chips += 1.0
                    u.by_slice[sid] = u.by_slice.get(sid, 0.0) + 1.0
                    if view is not None:
                        try:
                            u.hbm_bytes += view.chip(
                                view.index_at(c)).hbm_bytes
                        except Exception:
                            log.debug("no chip at %s in %s for hbm "
                                      "attribution", c, sid)
        for alloc in state.allocations():
            tenant = self.tenant_of_alloc(alloc)
            u = entry(tenant)
            u.pods += 1
            view = views.get(alloc.node_name)
            sid = (view.info.slice_id if view is not None
                   else state.slice_of_node(alloc.node_name) or "?")
            chips = 0.0
            hbm = 0.0
            for did in alloc.device_ids:
                try:
                    index, frac = parse_device_id(did)
                except ValueError:
                    continue
                chip_hbm = 0
                if view is not None:
                    try:
                        chip_hbm = view.chip(index).hbm_bytes
                    except Exception:
                        log.debug("chip %s gone from %s mid-build",
                                  index, alloc.node_name)
                if frac is not None:
                    _, n = frac
                    chips += 1.0 / n
                    hbm += chip_hbm / n
                else:
                    chips += 1.0
                    hbm += chip_hbm
            u.chips += chips
            u.hbm_bytes += hbm
            u.by_slice[sid] = u.by_slice.get(sid, 0.0) + chips
            if (alloc.pod_key not in gang_pods
                    and alloc.priority <= self._shed_priority_max):
                u.burst_chips += chips
        return _UsageSnapshot(key, usage, cap_chips, cap_hbm, vtpu_shares)


def _hist_totals_by_tenant(hist, threshold_le: str) -> dict[
        str, tuple[float, float]]:
    """tenant -> (good, total) over one histogram's rendered
    ``_bucket`` samples, keyed by the ``tenant`` label — the
    per-tenant twin of :func:`_hist_totals` (the BurnMonitor slides
    one window pair per tenant over these)."""
    out: dict[str, list[float]] = {}
    for name, labels, value in hist.samples():
        if not name.endswith("_bucket"):
            continue
        labels = labels or {}
        tenant = labels.get("tenant")
        if tenant is None:
            continue
        le = labels.get("le")
        acc = out.setdefault(tenant, [0.0, 0.0])
        if le == threshold_le:
            acc[0] += value
        elif le == "+Inf":
            acc[1] += value
    return {t: (g, tot) for t, (g, tot) in out.items()}


def _hist_totals(hist, threshold_le: str,
                 match: dict[str, str]) -> tuple[float, float]:
    """(good, total) over one histogram's rendered ``_bucket`` samples,
    restricted to the children matching ``match`` — the in-process twin
    of ``obs.slo.histogram_totals`` (same bucket-counter semantics,
    read off the live Histogram instead of a scrape)."""
    good = total = 0.0
    for name, labels, value in hist.samples():
        if not name.endswith("_bucket"):
            continue
        labels = labels or {}
        if any(labels.get(k) != v for k, v in match.items()):
            continue
        le = labels.get("le")
        if le == threshold_le:
            good += value
        elif le == "+Inf":
            total += value
    return good, total


class _BurnSource:
    __slots__ = ("name", "hist", "threshold_le", "objective", "match")

    def __init__(self, name, hist, threshold_le, objective, match):
        self.name = name
        self.hist = hist
        self.threshold_le = threshold_le
        self.objective = objective
        self.match = dict(match or {})


class BurnMonitor:
    """Sliding-window SLO burn over live histograms.

    Two baselines A (older) and B (newer) slide forward: burn is the
    obs/slo burn-rate of the delta since A, and whenever B is a full
    window old, A <- B and B <- now — so the evaluated window always
    spans between one and two ``window`` lengths of the SCHEDULING
    clock (the fake clock in sims, so burn windows compress with the
    rest of simulated time), PROVIDED evaluations keep arriving.
    Evaluations only happen on shed-eligible admissions, so after an
    idle gap longer than two windows both baselines are stale; rather
    than conflate hours of quiet (and any sample inside them) into one
    giant pseudo-window — shedding morning traffic for last night's
    slow commit — a gap that long RESETS the baselines to the current
    totals and reports no burn for that evaluation (a burn that is
    genuinely still happening re-crosses the threshold within one
    window of resumed traffic). ``threshold`` is the page burn from
    the multiwindow policy; 0 disables the monitor entirely."""

    def __init__(self, clock, threshold: float = 14.4,
                 window: float = 60.0) -> None:
        self._clock = clock
        self.threshold = threshold
        self.window = window
        self._sources: list[_BurnSource] = []
        # per-tenant sources: each evaluates one
        # (good, total) window pair PER tenant-labeled child, sliding
        # on the same A/B baselines and clock as the global sources —
        # so a shed can cite the refused tenant's own burn, not just
        # the plane-global one
        self._tenant_sources: list[_BurnSource] = []
        self._lock = threading.Lock()
        # name -> (good, total) at the older (A) and newer (B)
        # baselines; only B's timestamp drives the sliding
        self._a: dict[str, tuple[float, float]] = {}
        self._b: dict[str, tuple[float, float]] = {}
        # (name, tenant) -> (good, total): the per-tenant baselines
        self._ta: dict[tuple[str, str], tuple[float, float]] = {}
        self._tb: dict[tuple[str, str], tuple[float, float]] = {}
        self._b_t = clock.monotonic()
        self.last_burns: dict[str, Optional[float]] = {}
        # tenant -> {slo name -> last windowed burn} (read-only views:
        # tenant_burn(), the tpukube_tenant_slo_burn gauge, /statusz)
        self.last_tenant_burns: dict[str, dict[str, Optional[float]]] = {}
        # one verdict per clock instant: kilonode-scale sims run whole
        # drains at a single fake-clock tick, and every admission in a
        # drain must see one consistent verdict without re-scanning
        # the histograms per pod
        self._verdict_t: Optional[float] = None
        self._verdict: Optional[str] = None

    def attach(self, name: str, hist, threshold_le: str,
               objective: float, match=None) -> None:
        self._sources.append(
            _BurnSource(name, hist, threshold_le, objective, match)
        )

    def attach_tenant(self, name: str, hist, threshold_le: str,
                      objective: float) -> None:
        """Attach a tenant-labeled histogram as a PER-TENANT burn
        source: every tenant child gets its own sliding window pair
        and its own burn in ``last_tenant_burns``."""
        self._tenant_sources.append(
            _BurnSource(name, hist, threshold_le, objective, None)
        )

    def attach_default_slos(self, hists: dict[str, Any]) -> None:
        """Wire the DEFAULT_SLOS (obs/slo.py) against the live
        histograms that back them — the same objectives and bucket
        thresholds the Prometheus rules alert on."""
        for spec in slo_mod.DEFAULT_SLOS:
            hist = hists.get(spec.family)
            if hist is not None:
                self.attach(spec.name, hist, spec.threshold_le,
                            spec.objective, match=dict(spec.labels))

    def evaluate(self) -> dict[str, Optional[float]]:
        """Current burn per source over the sliding window; slides the
        baselines (global AND per-tenant — one clock, one window pair
        policy) as a side effect."""
        now = self._clock.monotonic()
        totals = {
            s.name: _hist_totals(s.hist, s.threshold_le, s.match)
            for s in self._sources
        }
        tenant_totals: dict[tuple[str, str], tuple[float, float]] = {}
        for s in self._tenant_sources:
            for tenant, gt in _hist_totals_by_tenant(
                    s.hist, s.threshold_le).items():
                tenant_totals[(s.name, tenant)] = gt
        with self._lock:
            if now - self._b_t >= 2 * self.window:
                # idle gap past the window contract: reset instead of
                # judging a giant stale pseudo-window (see class doc)
                self._a = totals
                self._b, self._b_t = totals, now
                self._ta = tenant_totals
                self._tb = dict(tenant_totals)
                self.last_burns = {s.name: None for s in self._sources}
                self.last_tenant_burns = {}
                return dict(self.last_burns)
            burns: dict[str, Optional[float]] = {}
            for s in self._sources:
                good, total = totals[s.name]
                bg, bt = self._a.get(s.name, (0.0, 0.0))
                burns[s.name] = slo_mod.burn_rate(
                    good - bg, total - bt, s.objective
                )
            objectives = {s.name: s.objective
                          for s in self._tenant_sources}
            tburns: dict[str, dict[str, Optional[float]]] = {}
            for (name, tenant), (good, total) in tenant_totals.items():
                bg, bt = self._ta.get((name, tenant), (0.0, 0.0))
                tburns.setdefault(tenant, {})[name] = slo_mod.burn_rate(
                    good - bg, total - bt, objectives[name]
                )
            if now - self._b_t >= self.window:
                self._a = self._b
                self._b, self._b_t = totals, now
                self._ta = self._tb
                self._tb = dict(tenant_totals)
            self.last_burns = burns
            self.last_tenant_burns = tburns
            return burns

    def page_burning(self) -> Optional[str]:
        """A human reason while any source burns at or above the page
        threshold, else None. Memoized per clock instant — a batch
        drain's admissions all land on one fake-clock tick and must
        not re-scan the histograms per pod."""
        if self.threshold <= 0 or not self._sources:
            return None
        now = self._clock.monotonic()
        with self._lock:
            if self._verdict_t == now:
                return self._verdict
        worst_name, worst = None, None
        for name, burn in self.evaluate().items():
            if burn is not None and (worst is None or burn > worst):
                worst_name, worst = name, burn
        verdict = None
        if worst is not None and worst >= self.threshold:
            verdict = (f"{worst_name} burning at {worst:.1f}x "
                       f"(page threshold {self.threshold:g}x)")
        with self._lock:
            self._verdict_t, self._verdict = now, verdict
        return verdict

    def tenant_burn(self, tenant: str) -> Optional[float]:
        """The tenant's WORST last-evaluated burn across the per-tenant
        sources (None = no traffic / no per-tenant source). Read-only —
        the admission path's page_burning() evaluation already slid the
        windows this reads."""
        with self._lock:
            burns = self.last_tenant_burns.get(tenant)
            if not burns:
                return None
            vals = [b for b in burns.values() if b is not None]
            return max(vals) if vals else None

    def last_tenant_burn(self, tenant: str, slo: str) -> float:
        """One (tenant, slo) cell of the last evaluation, 0.0 when
        unknown — the tpukube_tenant_slo_burn gauge's pull callback."""
        with self._lock:
            return (self.last_tenant_burns.get(tenant) or {}).get(
                slo) or 0.0

    def last_page_burning(self) -> bool:
        """Read-only view of the LAST evaluation — the metrics/statusz
        renderers must never slide the admission windows themselves."""
        if self.threshold <= 0:
            return False
        with self._lock:
            return any(b is not None and b >= self.threshold
                       for b in self.last_burns.values())

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "threshold": self.threshold,
                "window_seconds": self.window,
                "sources": [s.name for s in self._sources],
                "tenant_sources": [s.name
                                   for s in self._tenant_sources],
                "last_burns": dict(self.last_burns),
                "last_tenant_burns": {
                    t: dict(b)
                    for t, b in self.last_tenant_burns.items()
                },
            }


class TenantPlane:
    """The tenancy policy facade the Extender owns when
    ``tenancy_enabled`` is on (None otherwise — nothing below runs)."""

    def __init__(self, config, state, gang, events=None,
                 clock=None) -> None:
        from tpukube_torch.core.clock import SYSTEM

        self.label = config.tenancy_label
        self.default = config.tenancy_default_tenant
        self.quotas = parse_quotas(config.tenancy_quotas)
        self.shed_priority_max = config.tenancy_shed_priority_max
        self.ledger = TenantLedger(
            state, gang, default_tenant=self.default,
            shed_priority_max=self.shed_priority_max,
        )
        self._gang = gang
        self._events = events
        self.burn = BurnMonitor(
            clock if clock is not None else SYSTEM,
            threshold=config.tenancy_burn_threshold,
            window=config.tenancy_burn_window_seconds,
        )
        # per-tenant latency histograms: the
        # extender observes each filter decision's wall into
        # admission_hist{tenant} and each successful bind's into
        # commit_hist{tenant}; both render whenever tenancy is on
        # (tpukube_tenant_admission_seconds / _commit_seconds), and
        # the admission one doubles as the per-tenant burn source —
        # so a shed can cite the refused tenant's OWN burn
        self.admission_hist = Histogram(
            "tpukube_tenant_admission_seconds",
            help_text="Admission (filter) decision wall per tenant; "
                      "the per-tenant SLO-burn source.")
        self.commit_hist = Histogram(
            "tpukube_tenant_commit_seconds",
            help_text="Successful bind decision wall per tenant.")
        self.burn.attach_tenant(
            "tenant-admission-latency", self.admission_hist,
            threshold_le="0.25", objective=0.999,
        )
        # decision-provenance hook: an Extender with a DecisionLog
        # wires it here so every refusal's verdict — shares and
        # tenant-local burn at decision time — lands in the refused
        # pod's provenance chain. None = no recording.
        self.decisions = None
        self._lock = threading.Lock()  # leaf: counters only
        self.sheds: dict[str, int] = {}
        self.quota_denials: dict[str, int] = {}

    # -- identity ------------------------------------------------------------
    def tenant_of(self, pod: PodInfo) -> str:
        return pod.labels.get(self.label) or self.default

    def tenant_of_alloc(self, alloc) -> str:
        return self.ledger.tenant_of_alloc(alloc)

    # -- per-tenant latency (the burn monitor's windows slide on these) ------
    def observe_admission(self, tenant: str, seconds: float) -> None:
        self.admission_hist.labels(tenant=tenant).observe(seconds)

    def observe_commit(self, tenant: str, seconds: float) -> None:
        self.commit_hist.labels(tenant=tenant).observe(seconds)

    def known_tenants(self) -> list[str]:
        with self._lock:
            counted = set(self.sheds) | set(self.quota_denials)
        return sorted(
            set(self.quotas) | set(self.ledger.usage().usage) | counted
        )

    # -- request sizing ------------------------------------------------------
    def request_chips(self, pod: PodInfo) -> float:
        """Whole-chip-equivalent estimate of a pod's ask: exact for
        whole-chip requests; vTPU shares charged at 1/n of the largest
        advertised share count pre-bind (the post-bind ledger then
        carries the node's exact fraction)."""
        req = pod.requests()
        tpu = req.get(RESOURCE_TPU, 0)
        if tpu:
            return float(tpu)
        vtpu = req.get(RESOURCE_VTPU, 0)
        if vtpu:
            return vtpu / max(1, self.ledger.usage().vtpu_shares)
        return 0.0

    # -- admission -----------------------------------------------------------
    def admit(self, pod: PodInfo, resource: str,
              count: int) -> Optional[str]:
        """None to admit; a human reason to refuse (the caller turns it
        into the webhook's error answer — the scheduler's requeue makes
        refusal a deferral). Every refusal lands in the journal as a
        typed event; nothing is ever silently dropped."""
        tenant = self.tenant_of(pod)
        snap = self.ledger.usage()
        overflow = False
        if pod.group is not None:
            res = self._gang.reservation(pod.namespace, pod.group.name)
            if res is not None and self._gang.assignable(res, count):
                # the gang's chips are already held (and charged) by
                # its reservation; a member bind moves, not adds
                return None
            if res is not None:
                # replica beyond min_member of a full gang: the
                # extender schedules it as a NORMAL pod on fresh chips
                # (gang.assignable is False), so it is charged — and
                # shed-eligible — like any other burst
                overflow = True
                req_chips = float(count)
            else:
                req_chips = float(pod.group.min_member * count)
        elif resource == RESOURCE_VTPU:
            req_chips = count / max(1, snap.vtpu_shares)
        else:
            req_chips = float(count)
        quota = self.quotas.get(tenant)
        if quota is not None:
            u = snap.usage.get(tenant)
            used_chips = u.chips if u is not None else 0.0
            used_hbm = u.hbm_bytes if u is not None else 0.0
            if (quota.chips is not None
                    and used_chips + req_chips > quota.chips + 1e-9):
                reason = (
                    f"tenant {tenant}: {used_chips:g} chips held + "
                    f"{req_chips:g} asked exceeds the {quota.chips:g}-chip "
                    f"quota"
                )
                self._refuse("TenantQuotaDenied", self.quota_denials,
                             tenant, pod, reason)
                return reason
            if quota.hbm_fraction is not None and snap.capacity_hbm:
                req_hbm = req_chips * snap.capacity_hbm / max(
                    1, snap.capacity_chips
                )
                cap = quota.hbm_fraction * snap.capacity_hbm
                if used_hbm + req_hbm > cap + 1.0:
                    reason = (
                        f"tenant {tenant}: HBM quota exceeded — "
                        f"{used_hbm / snap.capacity_hbm:.3f} of cluster "
                        f"HBM held, cap {quota.hbm_fraction:g}"
                    )
                    self._refuse("TenantQuotaDenied", self.quota_denials,
                                 tenant, pod, reason)
                    return reason
        # SLO-aware shedding: only low-priority, non-gang burst work is
        # ever shed, and only from tenants above the burst population's
        # mean share — committed training gangs and on-quota tenants
        # ride out the burn untouched. Deliberate corollary: with ONE
        # bursting tenant its share IS the mean, so nothing sheds —
        # fairness-based shedding has no over-share target to select,
        # and refusing the only tenant's traffic would just fail the
        # cluster (this is also what keeps a neutral single-tenant
        # plane placement-identical to tenancy off). Single-tenant
        # overload protection is the quota knob, not the shed.
        if ((pod.group is None or overflow)
                and pod.priority <= self.shed_priority_max):
            burning = self.burn.page_burning()
            if burning is not None:
                share = snap.burst_share(tenant)
                mean = snap.mean_burst_share()
                if mean > 0 and share > OVER_SHARE_MARGIN * mean:
                    # the shed cites the TENANT-LOCAL burn alongside
                    # the plane-global trigger: "your own admissions
                    # are burning Nx" is the answer the refused tenant
                    # actually disputes (None = tenant idle so far)
                    tburn = self.burn.tenant_burn(tenant)
                    reason = (
                        f"tenant {tenant}: admission shed — {burning}; "
                        f"burst share {share:.4f} above "
                        f"{OVER_SHARE_MARGIN:g}x the population mean "
                        f"{mean:.4f}"
                        + (f"; tenant-local admission burn {tburn:.1f}x"
                           if tburn is not None else "")
                    )
                    self._refuse("TenantAdmissionShed", self.sheds,
                                 tenant, pod, reason)
                    return reason
        return None

    def _refuse(self, reason: str, counter: dict[str, int], tenant: str,
                pod: PodInfo, message: str) -> None:
        with self._lock:
            counter[tenant] = counter.get(tenant, 0) + 1
        dlog = self.decisions
        if dlog is not None and dlog.wants(pod.key()):
            # the tenancy verdict, with the shares and tenant-local
            # burn AT DECISION TIME — the provenance reader renders
            # this as the why-denied line
            try:
                snap = self.ledger.usage()
                dlog.record(
                    pod.key(), "tenancy", verdict=reason,
                    tenant=tenant, message=message,
                    dominant_share=round(snap.dominant_share(tenant), 6),
                    burst_share=round(snap.burst_share(tenant), 6),
                    tenant_burn=self.burn.tenant_burn(tenant),
                )
            except Exception:
                log.exception("decision record failed: %s %s",
                              reason, pod.key())
        if self._events is None:
            return
        try:
            self._events.emit(reason, obj=f"pod/{pod.key()}",
                              message=message, type="Warning")
        except Exception:
            log.exception("event emit failed: %s %s", reason, pod.key())

    # -- DRF ordering (the batched scheduling queue) -------------------------
    def drf_order(self, entries: list) -> list:
        """Order queue entries ``(pod, seq, names)`` for a cycle drain:
        priority bands first (unchanged — priority always dominates),
        then progressive dominant-resource fairness within each band.
        Units are whole gangs (members plan adjacently, as the legacy
        order guaranteed) or single stray pods; each pick charges the
        tenant's VIRTUAL share so one tenant's burst interleaves with
        everyone else's. Ties (equal virtual share) fall back to the
        legacy key — gangs before strays, then arrival — so a neutral
        plane (one tenant) reproduces the legacy order exactly."""
        snap = self.ledger.usage()
        cap = max(1, snap.capacity_chips)
        virtual: dict[str, float] = {}
        # (priority, unit key) -> [entries in seq order]
        units: dict[tuple, list] = {}
        for e in sorted(entries, key=lambda e: e[1]):
            pod = e[0]
            if pod.group is not None:
                ukey = (pod.priority,
                        (0, f"{pod.namespace}/{pod.group.name}"))
            else:
                ukey = (pod.priority, (1, "", e[1]))
            units.setdefault(ukey, []).append(e)
        # per-unit facts resolved ONCE (tenant label lookups and chip
        # estimates must not re-run on every pick of the loop below)
        facts: dict[tuple, tuple[str, float]] = {}
        by_prio: dict[int, list[tuple]] = {}
        for ukey, unit in units.items():
            tenant = self.tenant_of(unit[0][0])
            cost = sum(self.request_chips(e[0]) for e in unit) / cap
            facts[ukey] = (tenant, cost)
            by_prio.setdefault(ukey[0], []).append(ukey)
            virtual.setdefault(tenant, snap.dominant_share(tenant))
        out: list = []
        for prio in sorted(by_prio, reverse=True):
            remaining = list(by_prio[prio])
            # selection loop, O(units^2) per band with a tuple compare
            # per step: queue drains are a few hundred units at most in
            # tenancy deployments (the kilonode trace runs tenancy off
            # and keeps the O(n log n) legacy sort)
            while remaining:
                best_i = 0
                best_key = None
                for i, ukey in enumerate(remaining):
                    k = (virtual[facts[ukey][0]], ukey[1])
                    if best_key is None or k < best_key:
                        best_key, best_i = k, i
                ukey = remaining.pop(best_i)
                out.extend(units[ukey])
                tenant, cost = facts[ukey]
                virtual[tenant] += cost
        return out

    # -- preemption bias -----------------------------------------------------
    def overshare_map(self) -> dict[str, float]:
        """tenant -> how far its dominant share sits above entitlement
        (quota share when capped, else an equal split of the cluster
        among known tenants). The preemption planner prefers victim
        boxes whose owners are furthest over — priority cost still
        dominates the plan ranking."""
        snap = self.ledger.usage()
        known = set(self.quotas) | set(snap.usage)
        n = max(1, len(known))
        out: dict[str, float] = {}
        for tenant in known:
            share = snap.dominant_share(tenant)
            quota = self.quotas.get(tenant)
            entitled = 1.0 / n
            if quota is not None:
                parts = []
                if quota.chips is not None and snap.capacity_chips:
                    parts.append(quota.chips / snap.capacity_chips)
                if quota.hbm_fraction is not None:
                    parts.append(quota.hbm_fraction)
                if parts:
                    entitled = max(parts)
            over = share - entitled
            if over > 1e-9:
                out[tenant] = round(over, 9)
        return out

    # -- observability -------------------------------------------------------
    def shed_total(self) -> int:
        with self._lock:
            return sum(self.sheds.values())

    def quota_denied_total(self) -> int:
        with self._lock:
            return sum(self.quota_denials.values())

    def counter_snapshot(self) -> tuple[dict[str, int], dict[str, int]]:
        with self._lock:
            return dict(self.sheds), dict(self.quota_denials)

    def stats(self) -> dict[str, Any]:
        """The /statusz "tenants" section."""
        snap = self.ledger.usage()
        sheds, denials = self.counter_snapshot()
        tenants: dict[str, Any] = {}
        for tenant in sorted(set(self.quotas) | set(snap.usage)
                             | set(sheds) | set(denials)):
            u = snap.usage.get(tenant, TenantUsage())
            quota = self.quotas.get(tenant)
            tenants[tenant] = {
                "chips_used": round(u.chips, 4),
                "hbm_used_bytes": int(u.hbm_bytes),
                "pods": u.pods,
                "dominant_share": round(snap.dominant_share(tenant), 6),
                "burst_chips": round(u.burst_chips, 4),
                "by_slice": {s: round(c, 4)
                             for s, c in sorted(u.by_slice.items())},
                "quota": (
                    {"chips": quota.chips,
                     "hbm_fraction": quota.hbm_fraction}
                    if quota is not None else None
                ),
                "sheds": sheds.get(tenant, 0),
                "quota_denials": denials.get(tenant, 0),
            }
        shares = [t["dominant_share"] for t in tenants.values()
                  if t["dominant_share"] > 0]
        return {
            "enabled": True,
            "label": self.label,
            "default_tenant": self.default,
            "capacity": {
                "chips": snap.capacity_chips,
                "hbm_bytes": snap.capacity_hbm,
            },
            "tenants": tenants,
            "max_min_share_ratio": (
                round(max(shares) / min(shares), 4) if shares else None
            ),
            "burn": self.burn.stats(),
        }
