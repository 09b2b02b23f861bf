"""Capacity analytics & demand forensics plane — the port's own copy of
``tpukube/obs/capacity.py``.

/metrics answers "how much, right now"; this module answers the three
questions a defragmenter and the autoscaler consume and nothing else
records: *how did fleet capacity evolve* (flight recorder), *why
exactly is demand unschedulable* (stranded-demand forensics), and *what
would fit if we acted* (what-if placement probes).

Three pillars, one subsystem:

  * **Flight recorder** — a bounded ring of periodic fleet samples
    (per-slice utilization / fragmentation / largest-free-box /
    unhealthy+terminating counts, queue depth + oldest age, per-tenant
    dominant shares + burn verdict, the live stranded rollup), sampled
    on the SCHEDULING clock (FakeClock-compressible) and served from
    the epoch-cached snapshot's ``observe()`` view so a sample rides
    the existing O(Δ) maintenance chain instead of rebuilding anything.
    An optional JSONL sink on the :class:`tpukube_torch.trace.JsonlSink`
    drain-thread pattern persists samples for ``obs capacity --merge``
    stitching.

  * **Stranded-demand forensics** — every failed/deferred plan is
    root-caused into a typed taxonomy: ``fragmented`` (chips free but
    no contiguous box — the repack signal), ``capacity`` (not enough
    free chips anywhere), ``quota`` / ``shed`` (tenancy refusals, also
    in the DecisionLog), ``unhealthy`` (free-if-healed capacity would
    cover it), ``dcn-ineligible`` (only multi-slice spanning could
    serve it and the gang did not opt in), plus ``transient`` for the
    honest race where a fit exists by the time forensics re-probes
    (degrade loudly, never misattribute). Counts feed
    ``tpukube_unschedulable_pods{reason}``; live demands feed the
    per-shape stranded ledger on /statusz and the explain chain's
    ``stranded`` stage.

  * **What-if probes** — a read-only fit dry-run against the current
    epoch-pinned snapshot: per-slice contiguous verdicts through the
    REAL vectorized sweep (``slicefit.find_slice_in``) plus the greedy
    DCN-split fallback, the API a defragmenter or autoscaler calls
    before acting. Served on ``/capacity/probe`` and federated by the
    shard router.

Everything is gated on ``capacity_enabled`` (default off): nothing is
constructed, sampled, or rendered when the flag is off, so the
exposition stays byte-identical.

Each root-caused demand records a ``stranded`` stage into the pod's
provenance chain while decision provenance is on (``ext.decisions``). The
shard router federates ``/capacity`` and ``/capacity/probe`` over
:func:`merge_capacity_docs` / :func:`merge_probe_docs`.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Optional

from tpukube_torch import trace as trace_mod
from tpukube_torch.sched import slicefit

#: the forensics taxonomy (``tpukube_unschedulable_pods{reason}``);
#: ``transient`` is the loud fallback for plans whose failure no longer
#: reproduces against the current snapshot (a racing release) — honest
#: over plausible
UNSCHEDULABLE_REASONS = (
    "capacity", "dcn-ineligible", "draining", "fragmented", "quota",
    "shed", "transient", "unhealthy",
)

#: scheduling-clock seconds a stranded-ledger entry survives without a
#: refreshing re-classification when no batch queue exists to consult
#: for liveness (batching on: the entry dies the moment its pod leaves
#: the queue's first-admit stamps)
STRANDED_TTL_SECONDS = 900.0

#: the utilization sparkline ramp (``obs capacity``)
_SPARK = "▁▂▃▄▅▆▇█"

_DURATION_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_duration(text: Any) -> float:
    """``"15m"`` / ``"2h"`` / ``"90s"`` / ``"1d"`` → seconds; bare
    numbers pass through as float seconds. Raises ValueError on junk —
    the CLI turns that into an argparse error."""
    t = str(text).strip()
    if not t:
        raise ValueError("empty duration")
    unit = _DURATION_UNITS.get(t[-1].lower())
    if unit is not None:
        return float(t[:-1]) * unit
    return float(t)


def parse_since(text: Any) -> float:
    """The shared ``--since`` parser (``obs events`` / ``obs
    capacity``): a suffixed duration is RELATIVE (its seconds value is
    far below any epoch timestamp, so the existing newest-minus-delta
    branch applies); a bare number keeps the legacy float semantics
    (epoch seconds, or a small relative number)."""
    return parse_duration(text)


def parse_shape(text: str) -> tuple[int, int, int]:
    """``"4x4x4"`` → ``(4, 4, 4)`` (the /capacity/probe query shape)."""
    parts = str(text).lower().split("x")
    if len(parts) != 3:
        raise ValueError(f"shape {text!r}: want XxYxZ")
    dims = tuple(int(p) for p in parts)
    if any(d < 1 for d in dims):
        raise ValueError(f"shape {text!r}: extents must be >= 1")
    return dims  # type: ignore[return-value]


def _healed_free(ss) -> int:
    """Chips free for a new placement if every unhealthy/terminating
    chip healed — the counterfactual that separates ``unhealthy`` from
    ``capacity`` in the taxonomy. Cordoned chips stay blocked: healing
    does not un-drain a node (that counterfactual is ``draining``'s,
    probed separately)."""
    blocked = ((ss.occupied | ss.reserved | ss.cordoned | ss.absent)
               - ((ss.unhealthy | ss.terminating) - ss.cordoned))
    return ss.mesh.num_chips - len(blocked)


class CapacityRecorder:
    """The capacity analytics subsystem one extender owns (None unless
    ``capacity_enabled``). Constructed after the snapshot cache and the
    optional cycle/tenant planes so samples can read all of them.

    Recording is observer-grade: samples read
    ``snapshots.observe()`` (never ``current()`` — an observer read
    must not warm or fork the scheduling path's cache discipline), and
    both the sampler and the forensics accumulate their wall into
    ``sample_seconds``, the recorder's measured overhead."""

    def __init__(self, extender, config) -> None:
        self._ext = extender
        self._interval = config.capacity_sample_interval_seconds
        self.ring_capacity = config.capacity_samples
        self.ring: deque[dict] = deque(maxlen=self.ring_capacity)
        self.sink: Optional[trace_mod.JsonlSink] = (
            trace_mod.JsonlSink(
                config.capacity_path,
                max_bytes=config.capacity_sink_max_bytes,
            ) if config.capacity_path else None
        )
        # cumulative counters (lock-free, like DecisionLog.record):
        # plain int/float adds under the GIL — a racing reader sees a
        # slightly stale number, never a torn one
        self.samples_taken = 0
        self.sample_seconds = 0.0
        self.classified = 0
        self._unschedulable: dict[str, int] = {}
        # scheduling-clock instant of the last sample (None = never)
        self._last_sample: Optional[float] = None
        # stranded ledger: shape label -> demand key -> record; leaf
        # lock only (dict updates, no calls out under it)
        self._lock = threading.Lock()
        self._stranded: dict[str, dict[str, dict]] = {}
        # demand key -> (snapshot epoch, reason): a gang refused 128
        # times against ONE epoch classifies once — the counter still
        # counts every refusal, with the memoized reason
        self._classified_at: dict[str, tuple[tuple[int, int], str]] = {}
        # cluster-wide repack-recoverable chips at the last
        # classification/sample (the stranded ledger's headline)
        self._recoverable_last = 0
        # fleet size at the last sample (the stranded-ratio
        # recording rule's denominator)
        self.fleet_chips = 0

    # -- flight recorder -----------------------------------------------------
    def maybe_sample(self) -> None:
        """Amortized per-decision hook (the extender calls it where it
        checkpoints): a clock read per decision, a real sample only
        when the scheduling-clock interval elapsed — FakeClock drives
        compress wall-free."""
        now = self._ext.clock.monotonic()
        last = self._last_sample
        if last is not None and now - last < self._interval:
            return
        self._last_sample = now
        self.sample_now(now)

    def sample_now(self, now: Optional[float] = None) -> dict:
        """Take one fleet sample (also the test/CLI forced-sample
        seam). Reads the observer snapshot view only."""
        t0 = time.perf_counter()
        ext = self._ext
        if now is None:
            now = ext.clock.monotonic()
        snap = ext.snapshots.observe()
        slices: dict[str, dict[str, Any]] = {}
        chips = free = bfree = 0
        used_shares = total_shares = 0
        unhealthy = terminating = 0
        for sid in sorted(snap.slices):
            ss = snap.slices[sid]
            # the snapshot-memoized pair (shared with /metrics gauges
            # and the shard capacity exchange) — one box sweep per
            # slice per epoch fleet-wide, not one per sample
            slices[sid] = {
                "utilization": round(ss.utilization, 4),
                "fragmentation": round(ss.fragmentation(), 4),
                "largest_free_box": ss.largest_free_box(),
                "free_chips": ss.free_chips,
                "blocked_free_chips": ss.blocked_free_chips,
                "unhealthy": len(ss.unhealthy),
                "terminating": len(ss.terminating),
            }
            chips += ss.mesh.num_chips
            free += ss.free_chips
            bfree += ss.blocked_free_chips
            used_shares += ss.used_shares
            total_shares += ss.total_shares
            unhealthy += len(ss.unhealthy)
            terminating += len(ss.terminating)
        cycle = getattr(ext, "cycle", None)
        queue: dict[str, Any] = {"depth": 0, "oldest_age_s": None}
        if cycle is not None:
            queue = {
                "depth": cycle.queue_depth(),
                "oldest_age_s": cycle.pending_oldest_age(now),
            }
        tenants = getattr(ext, "tenants", None)
        tenant_doc: Optional[dict[str, Any]] = None
        if tenants is not None:
            usage = tenants.ledger.usage()
            tenant_doc = {
                "dominant_share": {
                    t: round(usage.dominant_share(t), 4)
                    for t in sorted(tenants.known_tenants())
                },
                "shedding": bool(tenants.burn.last_page_burning()),
            }
        with self._lock:
            self._expire_stranded_locked(now)
            stranded = self._stranded_rollup_locked()
        sample: dict[str, Any] = {
            # wall ts orders cross-replica merges; the scheduling-clock
            # instant is what --since windows and tests reason about
            "ts": time.time(),
            "clock": round(now, 6),
            "fleet": {
                "chips": chips,
                "free_chips": free,
                "blocked_free_chips": bfree,
                "utilization": (
                    round(used_shares / total_shares, 4)
                    if total_shares else 0.0
                ),
                "unhealthy": unhealthy,
                "terminating": terminating,
            },
            "slices": slices,
            "queue": queue,
            "tenants": tenant_doc,
            "stranded": stranded,
        }
        self.fleet_chips = chips
        self.ring.append(sample)
        if self.sink is not None:
            self.sink.write(json.dumps(sample, sort_keys=True) + "\n")
        self.samples_taken += 1
        self.sample_seconds += time.perf_counter() - t0
        return sample

    def samples(self, since: Optional[float] = None) -> list[dict]:
        """Ring contents, oldest first, optionally clipped to samples
        at/after ``since`` (epoch seconds — the CLI resolves relative
        windows before asking)."""
        out = list(self.ring)
        if since is not None:
            out = [s for s in out if float(s.get("ts", 0.0)) >= since]
        return out

    # -- stranded-demand forensics -------------------------------------------
    def note_failed_plan(self, pod, error: Optional[str] = None) -> None:
        """Root-cause one failed/deferred plan. Called from the batch
        planner's plan-store seam and the legacy filter's refusal seam;
        must stay cheap — the geometric probe memoizes per (demand,
        snapshot epoch), and every wall spent lands in
        ``sample_seconds`` (the measured-overhead guard)."""
        t0 = time.perf_counter()
        try:
            demand = self._demand_of(pod)
            if demand is None:
                return
            key, total, shape, dcn, cpp = demand
            epoch = self._ext.snapshots.epoch_key()
            # the memo is shared with _expire_stranded_locked (which
            # pops entries from another thread's sample tick): read and
            # write under the lock; the expensive _classify probe stays
            # OUTSIDE it (lock-discipline: no heavy work under _lock)
            with self._lock:
                memo = self._classified_at.get(key)
            if memo is not None and memo[0] == epoch:
                reason, detail = memo[1], None
            else:
                reason, detail = self._classify(total, shape, dcn, cpp,
                                                error)
                with self._lock:
                    self._classified_at[key] = (epoch, reason)
                self.classified += 1
            self._unschedulable[reason] = \
                self._unschedulable.get(reason, 0) + 1
            now = self._ext.clock.monotonic()
            label = ("x".join(str(d) for d in shape) if shape
                     else str(total))
            with self._lock:
                rec = self._stranded.setdefault(label, {}).setdefault(
                    key, {})
                rec.update({
                    "demand": key,
                    "pod": pod.key(),
                    "chips": total,
                    "reason": reason,
                    "ts": now,
                })
                if detail:
                    rec.update(detail)
                self._expire_stranded_locked(now)
            if detail and "recoverable_chips" in detail:
                self._recoverable_last = detail["recoverable_chips"]
            ext = self._ext
            if ext.decisions is not None:
                ext._note_decision(
                    pod.key(), "stranded", reason=reason, chips=total,
                    shape=(list(shape) if shape else None),
                    **(detail or {}),
                )
        finally:
            self.sample_seconds += time.perf_counter() - t0

    def note_refusal(self, pod, error: str) -> None:
        """The legacy (non-batch) refusal seam: a filter exception is a
        failed plan with a reason string."""
        self.note_failed_plan(pod, error=error)

    def _demand_of(self, pod):
        """(demand key, chips, shape, dcn-allowed, chips/pod) for a
        failed pod, or None for non-``qiniu.com/tpu`` asks (nothing geometric to
        strand). Gang members collapse onto one demand so a 128-member
        refusal storm is one ledger row."""
        from tpukube_torch.core.types import RESOURCE_TPU
        from tpukube_torch.sched.extender import Extender, ExtenderError

        try:
            ask = Extender.device_request(pod)
        except ExtenderError:
            return None
        if ask is None or ask[0] != RESOURCE_TPU:
            return None
        count = ask[1]
        if pod.group is not None:
            return (
                f"gang:{pod.namespace}/{pod.group.name}",
                pod.group.min_member * count,
                pod.group.shape,
                bool(pod.group.allow_dcn),
                count,
            )
        return (pod.key(), count, None, False, count)

    def _classify(self, total: int, shape, dcn: bool, cpp: int,
                  error: Optional[str]):
        """(reason, detail) for one unschedulable demand. String-routed
        tenancy refusals first (their reason is authoritative — the
        plane refused, geometry did not); everything else re-probes the
        observer snapshot with the real sweep primitives."""
        if error:
            if "quota" in error:
                return "quota", None
            if "admission shed" in error:
                return "shed", None
        snap = self._ext.snapshots.observe()
        rows = sorted(snap.slices.items())
        bfree = sum(ss.blocked_free_chips for _, ss in rows)
        detail: dict[str, Any] = {"free_chips": bfree}
        if bfree < total:
            healed = sum(_healed_free(ss) for _, ss in rows)
            if healed >= total:
                detail["healed_free_chips"] = healed
                return "unhealthy", detail
            dsid = self._fits_if_uncordoned(rows, total, shape)
            if dsid is not None:
                detail["fits_if_uncordoned"] = dsid
                return "draining", detail
            return "capacity", detail
        candidates = [(sid, ss) for sid, ss in rows
                      if ss.blocked_free_chips >= total]
        for sid, ss in candidates:
            coords = slicefit.find_slice_in(
                ss.blocked_sweep(),
                count=None if shape is not None else total,
                shape=shape,
                broken=ss.broken,
            )
            if coords is not None:
                detail["fits_in"] = sid
                return "transient", detail
        dsid = self._fits_if_uncordoned(rows, total, shape)
        if dsid is not None:
            # the demand fits once the drain gives the chips back (or
            # is cancelled) — stranded by elasticity, not by geometry
            detail["fits_if_uncordoned"] = dsid
            return "draining", detail
        boxes = {sid: slicefit.largest_free_box_in(ss.blocked_sweep())
                 for sid, ss in rows}
        detail["largest_free_box"] = max(boxes.values(), default=0)
        recoverable = sum(
            max(0, ss.blocked_free_chips - boxes[sid])
            for sid, ss in rows
        )
        detail["recoverable_chips"] = recoverable
        self._recoverable_last = recoverable
        if not candidates:
            # enough chips fleet-wide but no single slice holds them:
            # only DCN spanning could serve this demand
            if dcn and shape is None:
                if self._dcn_covers(rows, total, cpp, boxes):
                    return "transient", detail
                return "fragmented", detail
            return "dcn-ineligible", detail
        return "fragmented", detail

    @staticmethod
    def _fits_if_uncordoned(rows, total: int, shape):
        """The drain counterfactual: the slice id where this
        demand would fit if no chip were cordoned, else None. Probed
        only when a placement failed AND some slice is mid-drain — the
        operator's remedy is waiting out (or cancelling) the drain, not
        adding capacity or defragmenting, and the taxonomy must say
        so. The pre-filter skips slices whose UNCORDONED occupancy
        already exceeds the demand (the probe could never fit)."""
        for sid, ss in rows:
            if not ss.cordoned:
                continue
            if ss.mesh.num_chips - len(
                    ss.occupied | ss.reserved | ss.absent) < total:
                continue
            coords = slicefit.find_slice_in(
                ss.uncordoned_sweep(),
                count=None if shape is not None else total,
                shape=shape,
                broken=ss.broken,
            )
            if coords is not None:
                return sid
        return None

    @staticmethod
    def _dcn_covers(rows, total: int, cpp: int, boxes) -> bool:
        """Read-only mirror of the gang layer's greedy DCN split (one
        contiguous sub-box per slice, each a chips/pod multiple),
        conservative: only each slice's LARGEST box is offered."""
        cpp = max(1, cpp)
        remaining = total
        for sid, ss in sorted(rows, key=lambda kv:
                              -kv[1].blocked_free_chips):
            vol = min(remaining, (boxes[sid] // cpp) * cpp)
            remaining -= vol
            if remaining <= 0:
                return True
        return remaining <= 0

    def _expire_stranded_locked(self, now: float) -> None:
        """Retire ledger entries whose demand left the queue (batching
        on: the first-admit stamps are the liveness oracle) or went
        TTL-stale (no batch queue to consult) — a stranded row must
        never outlive the demand it names."""
        cycle = getattr(self._ext, "cycle", None)
        for label in list(self._stranded):
            demands = self._stranded[label]
            for key in list(demands):
                rec = demands[key]
                dead = now - rec["ts"] > STRANDED_TTL_SECONDS
                if not dead and cycle is not None:
                    dead = not cycle.is_pending(rec["pod"])
                if dead:
                    del demands[key]
                    self._classified_at.pop(key, None)
            if not demands:
                del self._stranded[label]

    def _stranded_rollup_locked(self) -> dict[str, Any]:
        by_shape = []
        for label in sorted(self._stranded):
            demands = list(self._stranded[label].values())
            reasons: dict[str, int] = {}
            for rec in demands:
                reasons[rec["reason"]] = reasons.get(rec["reason"], 0) + 1
            by_shape.append({
                "shape": label,
                "demands": len(demands),
                "chips_requested": sum(r["chips"] for r in demands),
                "reasons": reasons,
            })
        return {
            "demands": sum(r["demands"] for r in by_shape),
            "chips_requested": sum(r["chips_requested"]
                                   for r in by_shape),
            "recoverable_chips": self._recoverable_last,
            "by_shape": by_shape,
        }

    def stranded_summary(self) -> dict[str, Any]:
        """The /statusz stranded ledger ("3×64-chip gangs stranded by
        fragmentation, 412 chips recoverable by repack")."""
        now = self._ext.clock.monotonic()
        with self._lock:
            self._expire_stranded_locked(now)
            return self._stranded_rollup_locked()

    def stranded_by_reason(self) -> dict[str, tuple[int, int]]:
        """Live stranded ledger rolled up by root cause:
        reason -> (demands, chips_requested). The per-reason gauges
        (and the fragmentation ticket alert) read this."""
        now = self._ext.clock.monotonic()
        out: dict[str, tuple[int, int]] = {}
        with self._lock:
            self._expire_stranded_locked(now)
            for demands in self._stranded.values():
                for rec in demands.values():
                    d, c = out.get(rec["reason"], (0, 0))
                    out[rec["reason"]] = (d + 1, c + rec["chips"])
        return out

    def unschedulable_counts(self) -> dict[str, int]:
        """Cumulative failed-plan classifications by reason (the
        ``tpukube_unschedulable_pods{reason}`` source)."""
        return dict(self._unschedulable)

    # -- what-if probes ------------------------------------------------------
    def probe(self, count: Optional[int] = None,
              shape: Optional[tuple[int, int, int]] = None,
              chips_per_pod: int = 1) -> dict[str, Any]:
        """Read-only fit dry-run against the current observer snapshot:
        the real vectorized sweep per slice, plus the greedy DCN-split
        fallback — the answer a defragmenter/autoscaler acts on."""
        if (count is None) == (shape is None):
            raise ValueError("probe wants exactly one of count/shape")
        total = count if count is not None \
            else shape[0] * shape[1] * shape[2]
        if total < 1:
            raise ValueError("probe wants a positive chip count")
        snap = self._ext.snapshots.observe()
        rows = sorted(snap.slices.items())
        slices: dict[str, dict[str, Any]] = {}
        boxes: dict[str, int] = {}
        fits_in: Optional[str] = None
        for sid, ss in rows:
            box = slicefit.largest_free_box_in(ss.blocked_sweep())
            boxes[sid] = box
            fit = slicefit.find_slice_in(
                ss.blocked_sweep(), count=count, shape=shape,
                broken=ss.broken,
            ) is not None
            slices[sid] = {
                "blocked_free_chips": ss.blocked_free_chips,
                "largest_free_box": box,
                "fits": fit,
            }
            if fit and fits_in is None:
                fits_in = sid
        # the DCN fallback dry-run (count asks only — a shape ask is a
        # single-slice contract, exactly as the gang layer treats it)
        dcn: dict[str, Any] = {"fits": False, "parts": {}}
        if shape is None:
            cpp = max(1, chips_per_pod)
            remaining = total
            parts: dict[str, int] = {}
            for sid, ss in sorted(rows, key=lambda kv:
                                  -kv[1].blocked_free_chips):
                vol = min(remaining, (boxes[sid] // cpp) * cpp)
                if vol > 0:
                    parts[sid] = vol
                    remaining -= vol
                if remaining <= 0:
                    break
            if remaining <= 0:
                dcn = {"fits": True, "parts": parts}
        return {
            "requested": {
                "count": count,
                "shape": list(shape) if shape else None,
                "chips": total,
            },
            "free_chips": sum(ss.blocked_free_chips for _, ss in rows),
            "largest_free_box": max(boxes.values(), default=0),
            "fits": fits_in is not None,
            "slice": fits_in,
            "slices": slices,
            "dcn": dcn,
            "epoch": list(snap.key),
        }

    # -- documents -----------------------------------------------------------
    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "enabled": True,
            "samples": self.samples_taken,
            "sample_seconds": round(self.sample_seconds, 6),
            "ring": len(self.ring),
            "ring_capacity": self.ring_capacity,
            "interval_seconds": self._interval,
            "classified": self.classified,
            "unschedulable": self.unschedulable_counts(),
        }
        if self.sink is not None:
            bytes_, rotations = self.sink.stats()
            out["sink"] = {"path": self.sink.path, "bytes": bytes_,
                           "rotations": rotations}
        return out

    def capacity_doc(self, since: Optional[float] = None) -> dict[str, Any]:
        """The /capacity answer: ring samples + forensics rollup +
        recorder stats in one JSON document."""
        return {
            "samples": self.samples(since),
            "stranded": self.stranded_summary(),
            "unschedulable": self.unschedulable_counts(),
            "stats": self.stats(),
        }

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


# -- federation & rendering (shared by the router and the CLI) ---------------
def merge_capacity_docs(per_replica: list[tuple[str, Optional[dict]]],
                        ) -> dict[str, Any]:
    """Stitch per-replica /capacity documents into one fleet view.
    Samples are replica-stamped and ordered by (wall ts, replica) —
    the ``events --merge`` idiom; stranded rows and unschedulable
    counts aggregate with per-replica attribution kept. A replica with
    no document (dead, unreachable, or capacity-off) lands in
    ``dead_replicas`` so a merged answer can degrade loudly but never
    serve a stale fleet picture as fresh."""
    samples: list[dict] = []
    by_shape: dict[str, dict[str, Any]] = {}
    unschedulable: dict[str, int] = {}
    stats: dict[str, Any] = {}
    dead: list[str] = []
    recoverable = 0
    for name, doc in per_replica:
        if doc is None:
            dead.append(name)
            continue
        for s in doc.get("samples", ()):
            s = dict(s)
            s.setdefault("replica", name)
            samples.append(s)
        stranded = doc.get("stranded") or {}
        recoverable += int(stranded.get("recoverable_chips", 0))
        for row in stranded.get("by_shape", ()):
            agg = by_shape.setdefault(row["shape"], {
                "shape": row["shape"], "demands": 0,
                "chips_requested": 0, "reasons": {},
                "replicas": {},
            })
            agg["demands"] += row["demands"]
            agg["chips_requested"] += row["chips_requested"]
            for reason, n in (row.get("reasons") or {}).items():
                agg["reasons"][reason] = \
                    agg["reasons"].get(reason, 0) + n
            agg["replicas"][name] = row["demands"]
        for reason, n in (doc.get("unschedulable") or {}).items():
            unschedulable[reason] = unschedulable.get(reason, 0) + n
        stats[name] = doc.get("stats")
    samples.sort(key=lambda s: (float(s.get("ts", 0.0)),
                                str(s.get("replica", ""))))
    shapes = [by_shape[k] for k in sorted(by_shape)]
    return {
        "samples": samples,
        "stranded": {
            "demands": sum(r["demands"] for r in shapes),
            "chips_requested": sum(r["chips_requested"] for r in shapes),
            "recoverable_chips": recoverable,
            "by_shape": shapes,
        },
        "unschedulable": unschedulable,
        "stats": stats,
        "dead_replicas": sorted(dead),
    }


def merge_probe_docs(per_replica: list[tuple[str, Optional[dict]]],
                     requested: dict[str, Any]) -> dict[str, Any]:
    """Stitch per-replica /capacity/probe answers: the demand fits if
    any replica fits it whole; the DCN fallback composes each replica's
    largest offered parts. Dead replicas are named — a probe answer
    missing a shard's view must say so."""
    slices: dict[str, dict[str, Any]] = {}
    fits_in: Optional[tuple[str, str]] = None
    dead: list[str] = []
    free = 0
    largest = 0
    parts: dict[str, int] = {}
    total = int(requested.get("chips") or 0)
    for name, doc in per_replica:
        if doc is None:
            dead.append(name)
            continue
        free += int(doc.get("free_chips", 0))
        largest = max(largest, int(doc.get("largest_free_box", 0)))
        if doc.get("fits") and fits_in is None:
            fits_in = (name, doc.get("slice"))
        for sid, row in (doc.get("slices") or {}).items():
            slices[sid] = {**row, "replica": name}
        for sid, vol in ((doc.get("dcn") or {}).get("parts")
                         or {}).items():
            parts[sid] = vol
    dcn_fits = sum(parts.values()) >= total > 0
    return {
        "requested": requested,
        "free_chips": free,
        "largest_free_box": largest,
        "fits": fits_in is not None,
        "slice": fits_in[1] if fits_in else None,
        "replica": fits_in[0] if fits_in else None,
        "slices": slices,
        "dcn": {"fits": dcn_fits,
                "parts": parts if dcn_fits else {}},
        "dead_replicas": sorted(dead),
    }


def _spark(values: list[float], lo: float = 0.0,
           hi: float = 1.0) -> str:
    span = max(hi - lo, 1e-9)
    out = []
    for v in values:
        idx = int((min(max(v, lo), hi) - lo) / span
                  * (len(_SPARK) - 1))
        out.append(_SPARK[idx])
    return "".join(out)


def format_capacity(doc: dict[str, Any], fmt: str = "sparkline") -> str:
    """Render a /capacity document (solo or merged) for the terminal:
    ``sparkline`` (utilization + queue trends, stranded ledger lines),
    ``csv`` (one row per sample), or ``json`` (verbatim)."""
    if fmt == "json":
        return json.dumps(doc, indent=2, sort_keys=True)
    samples = doc.get("samples") or []
    if fmt == "csv":
        lines = ["ts,replica,utilization,free_chips,blocked_free_chips,"
                 "largest_free_box,queue_depth,queue_oldest_age_s,"
                 "stranded_chips"]
        for s in samples:
            fleet = s.get("fleet") or {}
            queue = s.get("queue") or {}
            stranded = s.get("stranded") or {}
            largest = max(
                (row.get("largest_free_box", 0)
                 for row in (s.get("slices") or {}).values()),
                default=0,
            )
            lines.append(",".join(str(x) for x in (
                s.get("ts"), s.get("replica", ""),
                fleet.get("utilization"), fleet.get("free_chips"),
                fleet.get("blocked_free_chips"), largest,
                queue.get("depth"), queue.get("oldest_age_s"),
                stranded.get("chips_requested", 0),
            )))
        return "\n".join(lines)
    # sparkline (default)
    lines: list[str] = []
    utils = [float((s.get("fleet") or {}).get("utilization") or 0.0)
             for s in samples]
    if utils:
        depth = [float((s.get("queue") or {}).get("depth") or 0)
                 for s in samples]
        lines.append(
            f"utilization  {_spark(utils)}  "
            f"(last {utils[-1]:.1%} over {len(utils)} samples)"
        )
        lines.append(
            f"queue depth  {_spark(depth, 0.0, max(max(depth), 1.0))}  "
            f"(last {int(depth[-1])})"
        )
    else:
        lines.append("no samples recorded")
    stranded = doc.get("stranded") or {}
    for row in stranded.get("by_shape", ()):
        reasons = ", ".join(
            f"{n}x {reason}"
            for reason, n in sorted((row.get("reasons") or {}).items())
        )
        line = (f"stranded: {row['demands']}x {row['shape']}-chip "
                f"demand(s) ({reasons}) — "
                f"{row['chips_requested']} chips requested")
        reps = row.get("replicas")
        if reps:
            line += " [" + ", ".join(
                f"{r}: {n}" for r, n in sorted(reps.items())) + "]"
        lines.append(line)
    if stranded.get("demands"):
        lines.append(
            f"{stranded.get('recoverable_chips', 0)} chips "
            f"recoverable by repack"
        )
    counts = doc.get("unschedulable") or {}
    if counts:
        lines.append("unschedulable plans: " + ", ".join(
            f"{reason}={n}" for reason, n in sorted(counts.items())))
    dead = doc.get("dead_replicas")
    if dead:
        lines.append(
            "WARNING: no capacity answer from replica(s) "
            + ", ".join(dead) + " — fleet view is partial"
        )
    return "\n".join(lines)
