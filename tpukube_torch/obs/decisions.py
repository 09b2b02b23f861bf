"""Scheduling decision provenance — the port's own copy of
``tpukube/obs/decisions.py``.

One pod's causal chain, as an operator asks for it during an incident:
why did THIS pod land where it did, why is it Pending, who refused it?

    admit -> queue wait -> cycle pin (snapshot epoch, delta advance vs
    rebuild, fast / general / batched-gang arm) -> per-stage candidate
    pruning (which filter rejected how many nodes, top-k scores) -> gang
    reservation / preemption plan (victims + bias) -> tenancy verdict
    (quota / shed, with tenant shares at decision time) -> assume / bind
    / undo -> release

:class:`DecisionLog` is that chain: a bounded, sampled ring of per-pod
*stage events*. Recording is one ``deque.append`` (atomic under the GIL:
no lock is taken on the record path); the optional JSONL sink enqueues to
its own drain thread (``trace.JsonlSink``), so a stalled disk never
reaches the decision lock. Sampling is a pure hash of the pod key against
a seed (crc32, as the reference's), so the sampled set is the same across
processes, restarts and the two packages.

Consumers: ``python -m tpukube_torch.cli obs explain <pod>`` (from a live
extender's ``/explain?pod=`` or a sink file), the extender's ``/statusz``
"decisions" section, and scenario 12's measured-overhead result
(``record_seconds``).

Off by default (``decisions_enabled``): the extender then holds
``decisions = None``, no stage is built, no series renders, and
placements are untouched — provenance observes decisions, it never makes
them.
"""

from __future__ import annotations

import itertools
import json
import time
import zlib
from collections import deque
from typing import Any, Iterable, Optional

from tpukube_torch.trace import TRACE_CONTEXT

#: stage vocabulary in use (documentation, not an enum — the explain
#: renderer treats unknown stages as opaque provenance lines):
#:   admit        pod entered the batch scheduling queue
#:   cycle_plan   a batch cycle planned it (arm, epoch, snapshot
#:                advance kind, queue age, assumed node or error)
#:   filter       feasibility answer (candidates, feasible, per-reason
#:                pruning counts)
#:   prioritize   scoring answer (top-k scores)
#:   gang_reserve the pod attached to / created its gang's reservation
#:   preemption_plan  a victim plan was recorded for its gang
#:   tenancy      the tenancy gate refused (quota / shed, with shares
#:                and the tenant-local burn at decision time)
#:   refusal      any other refusal seam (degraded mode, filter error)
#:   bind         the /bind decision (node, ok or error, plan/legacy)
#:   assume_undo  an assumed allocation was undone (re-plan)
#:   plan_expired the plan TTL'd out unbound
#:   preempted    the pod lost its chips to a higher-priority gang
#:   release      the pod's allocation was released
#:   route        (router) the fan-out router chose a replica to score
#:                the pod on
#:   spillover    (router) the home replica refused and the router
#:                spilled the pod to another replica
#:   rendezvous   (router) a two-phase DCN rendezvous verdict for the
#:                pod's gang (outcome prepared/committed/aborted, with
#:                the per-replica parts)
#:   stranded     the capacity forensics root-caused a failed/deferred
#:                plan (reason from the unschedulable taxonomy, with
#:                free-chip / largest-box / recoverable counts)
STAGES = (
    "admit", "cycle_plan", "filter", "prioritize", "gang_reserve",
    "preemption_plan", "tenancy", "refusal", "bind", "assume_undo",
    "plan_expired", "preempted", "release",
    "route", "spillover", "rendezvous", "stranded",
)

#: stages that are refusals (the explain verdict "denied")
REFUSAL_STAGES = frozenset({"tenancy", "refusal"})


class DecisionLog:
    """Bounded, sampled, lock-free-on-record provenance ring.

    ``capacity`` bounds the ring (stage events, not pods); the oldest
    events rotate out — incident captures that need full depth set
    ``path`` and read the JSONL sink. ``sample_rate`` selects pods by
    a deterministic hash of the pod key (seeded), so 0.01 on a
    kilonode fleet keeps 1% of pods FULLY explained instead of 100% of
    pods 1% explained. Readers (``events``/``explain``/``stats``)
    snapshot the ring with a bounded retry — they never block a
    recording webhook.
    """

    def __init__(self, capacity: int = 8192, sample_rate: float = 1.0,
                 seed: int = 0, path: Optional[str] = None,
                 max_sink_bytes: int = 0) -> None:
        self.capacity = max(1, capacity)
        self.sample_rate = sample_rate
        self.seed = seed
        self._ring: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self._seq = itertools.count(1)
        #: stage events recorded (cumulative — feeds
        #: tpukube_decisions_total)
        self.recorded = 0
        #: cumulative wall spent inside record() — the measured
        #: overhead the scenario-12 guard divides by the drive wall
        self.record_seconds = 0.0
        self.path = path or None
        self._sink = None
        if self.path:
            from tpukube_torch.trace import JsonlSink

            self._sink = JsonlSink(self.path, max_bytes=max_sink_bytes)

    # -- sampling ----------------------------------------------------------
    def wants(self, pod_key: str) -> bool:
        """True when this pod is in the sampled set. Pure function of
        (pod key, seed): deterministic across processes, so call sites
        can gate stage construction cheaply and every replica samples
        the same pods."""
        rate = self.sample_rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        h = zlib.crc32(pod_key.encode("utf-8"), self.seed & 0xFFFFFFFF)
        return (h % 1000000) < rate * 1000000

    # -- recording ---------------------------------------------------------
    def record(self, pod_key: str, stage: str, **fields: Any) -> None:
        """Append one stage event. Callers gate on :meth:`wants` first
        (``if dlog is not None and dlog.wants(key):``) so unsampled
        pods never even build the kwargs. The ring append is lock-free
        (one atomic deque append); the sink write is an enqueue to the
        drain thread."""
        t0 = time.perf_counter()
        ev: dict[str, Any] = {
            "seq": next(self._seq),
            "ts": time.time(),
            "pod": pod_key,
            "stage": stage,
        }
        ev.update(fields)
        ctx = TRACE_CONTEXT.get()
        if ctx is not None:
            # router-originated request (sharded mode): tag the stage
            # so the stitched /explain and merged timeline can join it
            # to the router's fan-out span; absent outside that path
            ev.setdefault("ctx", dict(ctx))
        self._ring.append(ev)
        self.recorded += 1
        if self._sink is not None:
            # default=str: provenance fields embed runtime values
            # (coords, enums); an unserializable one must degrade to
            # its repr, never fail the webhook that recorded it
            self._sink.write(json.dumps(ev, sort_keys=True,
                                        default=str) + "\n")
        self.record_seconds += time.perf_counter() - t0

    # -- queries -----------------------------------------------------------
    def events(self, pod: Optional[str] = None,
               limit: Optional[int] = None) -> list[dict[str, Any]]:
        """Snapshot of the ring, oldest first. Reads retry around the
        (rare) concurrent-append RuntimeError instead of locking the
        record path."""
        evs: list[dict[str, Any]] = []
        for _ in range(5):
            try:
                evs = list(self._ring)
                break
            except RuntimeError:  # deque mutated mid-iteration
                continue
        if pod is not None:
            evs = [e for e in evs if e.get("pod") == pod]
        if limit is not None:
            evs = evs[-limit:]
        return evs

    def explain(self, pod_key: str) -> dict[str, Any]:
        """The assembled why-pending / why-here / why-denied document
        for one pod, from the live ring."""
        return explain_doc(self.events(), pod_key)

    def stats(self) -> dict[str, Any]:
        """The /statusz "decisions" section."""
        evs = self.events()
        sink_bytes, rotations = (
            self._sink.stats() if self._sink is not None else (None, 0)
        )
        return {
            "enabled": True,
            "capacity": self.capacity,
            "sample_rate": self.sample_rate,
            "seed": self.seed,
            "events": len(evs),
            "pods": len({e.get("pod") for e in evs}),
            "recorded": self.recorded,
            "record_seconds": round(self.record_seconds, 6),
            "sink_path": self.path,
            "sink_bytes": sink_bytes,
            "sink_rotations": rotations,
        }

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()


# -- explain assembly --------------------------------------------------------

def load(path: str) -> list[dict[str, Any]]:
    """Read a decisions JSONL sink back (torn-line tolerant — shared
    loader with the trace/events captures)."""
    import os

    if not os.path.exists(path):
        return []
    from tpukube_torch.trace import load as _load_jsonl

    return _load_jsonl(path)


def pod_events(events: Iterable[dict[str, Any]],
               pod_key: str) -> list[dict[str, Any]]:
    """One pod's stage events in record order."""
    out = [e for e in events
           if isinstance(e, dict) and e.get("pod") == pod_key]
    out.sort(key=lambda e: e.get("seq", 0))
    return out


def merge_stage_events(
    groups: Iterable[tuple[str, Iterable[dict[str, Any]]]],
) -> list[dict[str, Any]]:
    """Stitch stage-event streams from several processes (the router's
    own log plus each owning replica's /explain chain) into ONE stream:
    every event gains a ``replica`` attribution (kept when the source
    already set one), ordering falls back from per-process seq to the
    wall clock (the only ordering that exists across processes), and
    seq is reassigned so :func:`explain_doc` renders the merged chain
    exactly like a local one."""
    merged: list[dict[str, Any]] = []
    for label, evs in groups:
        for ev in evs:
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ev.setdefault("replica", label)
            merged.append(ev)
    merged.sort(key=lambda e: (float(e.get("ts", 0.0)),
                               str(e.get("replica", "")),
                               int(e.get("seq", 0))))
    for i, ev in enumerate(merged, start=1):
        ev["seq"] = i
    return merged


def explain_doc(events: Iterable[dict[str, Any]],
                pod_key: str) -> dict[str, Any]:
    """Assemble one pod's provenance into a verdict + human "why"
    lines. Verdicts:

      placed     why-here: bound (or assumed) on a node — the chain
                 shows the candidates, pruning, scores, and arm
      denied     why-denied: a refusal seam answered last (tenancy
                 quota/shed, degraded mode, filter error)
      pending    why-pending: known but unbound — zero feasible nodes,
                 an undone/expired plan, or mid-flight
      preempted  placed, then evicted for a higher-priority gang
      released   placed, then released (completed/deleted)
      unknown    no provenance (unsampled pod, rotated out, or off)
    """
    evs = pod_events(events, pod_key)
    verdict = "unknown"
    node: Optional[str] = None
    why: list[str] = []
    for ev in evs:
        stage = ev.get("stage")
        if stage == "admit":
            verdict = "pending" if verdict == "unknown" else verdict
            why.append("admitted to the scheduling queue")
        elif stage == "cycle_plan":
            age = ev.get("queue_age_s")
            pin = ", ".join(
                str(x) for x in (
                    f"arm={ev.get('arm')}",
                    f"cycle={ev.get('cycle')}",
                    f"snapshot={ev.get('snapshot')}",
                    f"epoch={ev.get('epoch')}",
                ) if "None" not in x
            )
            if ev.get("assumed"):
                node = ev.get("node")
                verdict = "placed"
                why.append(
                    f"batch cycle planned it onto {node} ({pin}"
                    + (f", queued {age:.3f}s" if age is not None else "")
                    + ")"
                )
            elif ev.get("error"):
                verdict = "denied"
                why.append(f"batch plan refused it: {ev['error']}")
            elif ev.get("bind_error"):
                verdict = "pending"
                why.append(
                    f"batch plan could not bind it: {ev['bind_error']}"
                )
            else:
                verdict = "pending"
                why.append(f"batch cycle planned it unschedulable ({pin})")
        elif stage == "filter":
            feasible = ev.get("feasible")
            pruned = ev.get("pruned") or {}
            if feasible == 0:
                verdict = "pending"
            line = (f"filter: {feasible}/{ev.get('candidates')} node(s) "
                    f"feasible")
            if pruned:
                tops = sorted(pruned.items(), key=lambda kv: -kv[1])[:3]
                line += "; pruned: " + "; ".join(
                    f"{n}x {reason}" for reason, n in tops
                )
            why.append(line)
        elif stage == "prioritize":
            top = ev.get("top") or []
            why.append("scores: " + ", ".join(
                f"{n}={s}" for n, s in top
            ))
        elif stage == "gang_reserve":
            why.append(
                f"gang {ev.get('gang')}: reservation holds "
                f"{ev.get('chips')} chip(s)"
                + (" (committed)" if ev.get("committed") else "")
            )
        elif stage == "preemption_plan":
            why.append(
                f"gang {ev.get('gang')}: preemption planned — "
                f"{ev.get('victims')} victim workload(s) in "
                f"{ev.get('slices')}"
            )
        elif stage in REFUSAL_STAGES:
            verdict = "denied"
            reason = ev.get("message") or ev.get("reason") or "refused"
            if stage == "tenancy":
                extra = []
                if ev.get("burst_share") is not None:
                    extra.append(f"burst share {ev['burst_share']}")
                if ev.get("dominant_share") is not None:
                    extra.append(
                        f"dominant share {ev['dominant_share']}")
                if ev.get("tenant_burn") is not None:
                    extra.append(
                        f"tenant-local burn {ev['tenant_burn']}x")
                why.append(
                    f"tenancy gate refused ({ev.get('tenant')}): "
                    f"{reason}"
                    + (f" [{'; '.join(extra)}]" if extra else "")
                )
            else:
                why.append(f"refused ({ev.get('kind')}): {reason}")
        elif stage == "bind":
            if ev.get("ok"):
                verdict = "placed"
                node = ev.get("node")
                why.append(
                    f"bound on {node} (served from the "
                    f"{ev.get('served_from')} path)"
                )
            else:
                verdict = "pending"
                why.append(f"bind to {ev.get('node')} failed: "
                           f"{ev.get('error')}")
        elif stage == "assume_undo":
            verdict = "pending"
            why.append("assumed allocation undone (re-plan)")
        elif stage == "plan_expired":
            verdict = "pending"
            why.append("batch plan expired unbound (reservation TTL)")
        elif stage == "preempted":
            verdict = "preempted"
            why.append(
                "evicted: chips taken by a higher-priority gang"
                + (f" ({ev['by']})" if ev.get("by") else "")
            )
        elif stage == "release":
            if verdict == "placed":
                verdict = "released"
            why.append("allocation released")
        elif stage == "route":
            why.append(
                f"router: scored on replica {ev.get('replica')}"
                + (f" ({ev.get('reason')})" if ev.get("reason") else "")
            )
        elif stage == "spillover":
            why.append(
                f"router: spilled over from replica {ev.get('primary')} "
                f"to replica {ev.get('replica')}"
            )
        elif stage == "stranded":
            # verdict stays pending/unschedulable — forensics explains
            # WHY the demand cannot place, it is not a new outcome
            bits = []
            if ev.get("free_chips") is not None:
                bits.append(f"{ev['free_chips']} chips free")
            if ev.get("largest_free_box") is not None:
                bits.append(
                    f"largest contiguous box {ev['largest_free_box']}")
            if ev.get("recoverable_chips"):
                bits.append(
                    f"{ev['recoverable_chips']} recoverable by repack")
            why.append(
                f"stranded: {ev.get('chips')} chip(s) unschedulable — "
                f"root cause {ev.get('reason')}"
                + (f" ({', '.join(bits)})" if bits else "")
            )
        elif stage == "rendezvous":
            parts = ev.get("parts") or []
            detail = ", ".join(
                f"{p.get('chips')} chip(s) on {p.get('slice')} "
                f"(replica {p.get('replica')})" for p in parts
            )
            why.append(
                f"router: DCN rendezvous {ev.get('outcome')} for gang "
                f"{ev.get('gang')}"
                + (f" — {detail}" if detail else "")
                + (f" ({ev.get('reason')})" if ev.get("reason") else "")
            )
        else:
            why.append(f"{stage}: " + ", ".join(
                f"{k}={v}" for k, v in sorted(ev.items())
                if k not in ("seq", "ts", "pod", "stage")
            ))
    if verdict == "unknown" and evs:
        # stages exist but none was verdict-moving (a mid-flight pod:
        # filter/prioritize recorded, bind not yet) — that is a
        # PENDING pod, and "no provenance recorded" would deny the
        # very lines rendered below it
        verdict = "pending"
    return {
        "pod": pod_key,
        "verdict": verdict,
        "node": node,
        "stages": evs,
        "why": why,
    }


def format_explain(doc: dict[str, Any]) -> str:
    """Human rendering for ``obs explain`` (``--json`` prints the raw
    document instead)."""
    head = {
        "placed": f"PLACED on {doc.get('node')}",
        "denied": "DENIED",
        "pending": "PENDING",
        "preempted": "PREEMPTED",
        "released": f"RELEASED (was on {doc.get('node')})",
        "unknown": ("UNKNOWN — no provenance recorded (pod unsampled, "
                    "rotated out of the ring, or decisions_enabled "
                    "is off)"),
    }[doc.get("verdict", "unknown")]
    lines = [f"{doc.get('pod')}: {head}"]
    for i, line in enumerate(doc.get("why", []), start=1):
        lines.append(f"  {i:2d}. {line}")
    return "\n".join(lines)
