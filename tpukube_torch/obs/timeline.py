"""Per-pod scheduling timelines from a DecisionTrace event stream — the
port's own copy of ``tpukube/obs/timeline.py``.

The decision trace is a flat transcript of the control plane: webhook
decisions (filter/prioritize/bind), releases, victim confirmations, and
— new with the obs layer — ``span`` annotations recorded at interesting
internal points (gang reserve, preemption plan, gang commit, plugin
Allocate/intent-match). This module answers "where did pod X spend its
93 ms between first filter and Allocate?" by correlating all of those by
pod key into one track per pod and exporting Chrome trace-event JSON
(load in Perfetto / chrome://tracing), plus per-phase aggregate stats
for the bench line.

Each event becomes one slice on its pod's track: the slice is NAMED for
the event that ends it and SPANS the time since the pod's previous
event — so a wide "bind" slice literally is the wait between filter and
bind, the quantity an incident investigation needs.

``dump_chrome_trace`` writes the trace for ``python -m tpukube_torch.cli
obs timeline``; ``merged_chrome_trace`` stitches the shard router's
capture and each replica's into one (``obs timeline --merge``).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Optional

from tpukube_torch.obs.registry import quantile

# events with no pod affiliation land on this synthetic track
CLUSTER_TRACK = "(cluster)"


def _pod_key_of_pod_obj(pod: Any) -> Optional[str]:
    if not isinstance(pod, dict):
        return None
    meta = pod.get("metadata") or {}
    name = meta.get("name")
    if not name:
        return None
    return f"{meta.get('namespace', 'default')}/{name}"


def event_pod_key(ev: dict) -> Optional[str]:
    """The pod a trace event is about, or None for cluster-scoped events
    (upsert_node, unattributable spans)."""
    kind = ev.get("kind")
    req = ev.get("request")
    if kind in ("filter", "prioritize"):
        return _pod_key_of_pod_obj((req or {}).get("Pod"))
    if kind == "bind":
        if not isinstance(req, dict) or "PodName" not in req:
            return None
        return f"{req.get('PodNamespace', 'default')}/{req['PodName']}"
    if kind in ("release", "victim_gone", "reconcile"):
        return (req or {}).get("pod_key") if isinstance(req, dict) else None
    if kind == "span":
        key = (req or {}).get("pod_key") if isinstance(req, dict) else None
        return key or None
    return None


def event_phase(ev: dict) -> str:
    """Display name of the phase an event completes (span events carry
    their own name: gang_reserve, preemption_plan, gang_commit,
    intent_match, allocate, ...)."""
    if ev.get("kind") == "span":
        req = ev.get("request") or {}
        return str(req.get("name") or "span")
    return str(ev.get("kind"))


def _event_args(ev: dict) -> dict[str, Any]:
    args: dict[str, Any] = {"seq": ev.get("seq"), "kind": ev.get("kind")}
    kind = ev.get("kind")
    resp = ev.get("response")
    if kind == "span" and isinstance(ev.get("request"), dict):
        args.update({
            k: v for k, v in ev["request"].items() if k not in ("name",)
        })
    elif kind == "filter" and isinstance(resp, dict):
        args["feasible"] = len(resp.get("NodeNames") or [])
        args["failed"] = len(resp.get("FailedNodes") or {})
        if resp.get("Error"):
            args["error"] = resp["Error"]
    elif kind == "bind" and isinstance(resp, dict):
        if resp.get("Error"):
            args["error"] = resp["Error"]
    return args


def correlate(events: Iterable[dict]) -> dict[str, list[dict]]:
    """pod key -> that pod's events, each sorted by (ts, seq). Cluster-
    scoped events group under :data:`CLUSTER_TRACK`."""
    tracks: dict[str, list[dict]] = {}
    for ev in events:
        # tolerate partial events: a crashed or still-pending pod's
        # track may hold only span annotations (no bind/filter), and a
        # torn capture may carry junk — neither must break the exporter
        if not isinstance(ev, dict):
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            continue
        key = event_pod_key(ev) or CLUSTER_TRACK
        tracks.setdefault(key, []).append(ev)
    for evs in tracks.values():
        evs.sort(key=lambda e: (e["ts"], e.get("seq", 0)))
    return tracks


def chrome_trace(events: Iterable[dict]) -> dict[str, Any]:
    """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` object
    format Perfetto and chrome://tracing load).

    One thread per pod (tid = rank in sorted pod-key order, thread_name
    metadata carries the key); each event is a complete ("X") slice from
    the pod's previous event to this one, so gaps between decisions are
    visible as slice widths.
    """
    tracks = correlate(events)
    all_ts = [e["ts"] for evs in tracks.values() for e in evs]
    t0 = min(all_ts) if all_ts else 0.0
    trace_events: list[dict[str, Any]] = []
    for tid, pod_key in enumerate(sorted(tracks), start=1):
        trace_events.append({
            "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
            "args": {"name": pod_key},
        })
        prev_us: Optional[float] = None
        for ev in tracks[pod_key]:
            us = (ev["ts"] - t0) * 1e6
            start = us if prev_us is None else prev_us
            trace_events.append({
                "name": event_phase(ev),
                "ph": "X",
                "ts": round(start, 3),
                "dur": round(max(us - start, 1.0), 3),
                "pid": 1,
                "tid": tid,
                "args": _event_args(ev),
            })
            prev_us = us
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def _span_bounds(ev: dict) -> Optional[tuple[float, float]]:
    """Explicit wall-clock bounds on a span event, when recorded. The
    router's fan-out spans (sched/shard.py ``_traced``) stamp t0/t1 so
    the merged timeline can render them as true enclosing slices
    instead of width-since-previous-event slices."""
    req = ev.get("request")
    if ev.get("kind") == "span" and isinstance(req, dict) \
            and isinstance(req.get("t0"), (int, float)) \
            and isinstance(req.get("t1"), (int, float)):
        return float(req["t0"]), float(req["t1"])
    return None


def merged_chrome_trace(
    captures: list[tuple[str, list[dict]]],
) -> dict[str, Any]:
    """One Chrome trace stitched from several per-process captures
    (the sharded plane's federated observability): each capture renders as its own
    process (pid; process_name metadata carries the label — router,
    r0, r1, ...), sharing ONE time zero, so the router's fan-out spans
    visibly enclose/overlap the worker slices they fanned out to.
    Events tagged with a propagated trace context (``ctx``) surface
    ``trace``/``parent`` in their args — the join key across
    processes. Span events carrying explicit t0/t1 bounds render as
    true wall-clock slices; everything else keeps the
    width-since-previous-event semantics of :func:`chrome_trace`."""
    all_ts: list[float] = []
    for _, events in captures:
        for ev in events:
            if not isinstance(ev, dict):
                continue
            bounds = _span_bounds(ev)
            if bounds is not None:
                all_ts.append(bounds[0])
            elif isinstance(ev.get("ts"), (int, float)):
                all_ts.append(ev["ts"])
    zero = min(all_ts) if all_ts else 0.0
    trace_events: list[dict[str, Any]] = []
    for pid, (label, events) in enumerate(captures, start=1):
        trace_events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
        tracks = correlate(events)
        for tid, pod_key in enumerate(sorted(tracks), start=1):
            trace_events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": tid, "args": {"name": pod_key},
            })
            prev_us: Optional[float] = None
            for ev in tracks[pod_key]:
                args = _event_args(ev)
                ctx = ev.get("ctx")
                if isinstance(ctx, dict):
                    args["trace"] = ctx.get("trace")
                    args["parent"] = ctx.get("parent")
                bounds = _span_bounds(ev)
                if bounds is not None:
                    start = (bounds[0] - zero) * 1e6
                    end = (bounds[1] - zero) * 1e6
                    trace_events.append({
                        "name": event_phase(ev),
                        "ph": "X",
                        "ts": round(start, 3),
                        "dur": round(max(end - start, 1.0), 3),
                        "pid": pid,
                        "tid": tid,
                        "args": args,
                    })
                    prev_us = end
                    continue
                us = (ev["ts"] - zero) * 1e6
                start = us if prev_us is None else prev_us
                trace_events.append({
                    "name": event_phase(ev),
                    "ph": "X",
                    "ts": round(start, 3),
                    "dur": round(max(us - start, 1.0), 3),
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                })
                prev_us = us
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def span_chains(events: Iterable[dict]) -> dict[str, list[str]]:
    """pod key -> ordered phase names on its track (the chain the 16-pod
    gang acceptance check inspects: filter→gang_reserve→bind→allocate)."""
    return {
        key: [event_phase(ev) for ev in evs]
        for key, evs in correlate(events).items()
        if key != CLUSTER_TRACK
    }


def phase_stats(events: Iterable[dict]) -> dict[str, dict[str, Any]]:
    """Per-phase timing aggregates across all pods: for each phase name,
    the count of slices and the p50/p99/max slice width in ms (a slice's
    width = time since the pod's previous event — "time spent reaching
    this phase"). Feeds the bench line's ``phases`` key.

    A pod's FIRST event has no predecessor, so its width is undefined:
    it contributes to ``count`` but not to the percentiles (recording it
    as 0.0 would drag the entry phase's p50 toward zero and misreport
    the very attribution this exists for). A phase observed only as
    first events reports null percentiles."""
    counts: dict[str, int] = {}
    widths: dict[str, list[float]] = {}
    for key, evs in correlate(events).items():
        if key == CLUSTER_TRACK:
            continue
        prev: Optional[float] = None
        for ev in evs:
            phase = event_phase(ev)
            counts[phase] = counts.get(phase, 0) + 1
            if prev is not None:
                widths.setdefault(phase, []).append((ev["ts"] - prev) * 1e3)
            prev = ev["ts"]
    out: dict[str, dict[str, Any]] = {}
    for phase in sorted(counts):
        ws = widths.get(phase)
        out[phase] = {
            "count": counts[phase],
            "p50_ms": round(quantile(ws, 0.5), 3) if ws else None,
            "p99_ms": round(quantile(ws, 0.99), 3) if ws else None,
            "max_ms": round(max(ws), 3) if ws else None,
        }
    return out


def dump_chrome_trace(events: Iterable[dict], fp) -> None:
    json.dump(chrome_trace(events), fp, sort_keys=True)
    fp.write("\n")
