"""Structured event journal — the port's own copy of ``EventJournal`` from
``tpukube/obs/events.py``: the control plane's "why did that happen".

Typed, deduplicated records (GangReserved, GangCommitted, GangRollback,
VictimGone, ...) emitted at the gang manager's seams, held in a bounded
ring and optionally streamed to a JSONL sink. On by default
(``events_capacity`` 4096). Dedup follows the K8s model: an event with the
same (reason, object, message) as a live ring entry bumps that entry's
``count`` and ``last_ts`` instead of appending. ``counts_by_reason`` feeds
the extender's ``/metrics``, ``events``/``stats`` its ``/events`` route
and ``/statusz``, and :func:`load`/:func:`format_event` the
``python -m tpukube_torch.cli obs events`` query of a JSONL sink.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Iterable, Optional

# event severities, K8s-style
NORMAL = "Normal"
WARNING = "Warning"

#: The declared reason enum. Every emit() call in the tree must use one
#: of these (enforced source-level by the lint prover's name-consistency
#: pass; consumers — /events filters, ``obs events``, the
#: tpukube_events_total{reason} counter — key off these strings).
REASONS: tuple[str, ...] = (
    "AllocDiverged",
    "AutoscaleDown",
    "AutoscaleUp",
    "BindFailed",
    "CheckpointWritten",
    "ChipRecovered",
    "ChipUnhealthy",
    "CircuitClosed",
    "CircuitOpen",
    "DegradedMode",
    "DrainCancelled",
    "DrainCompleted",
    "DrainStarted",
    "GangCommitted",
    "GangDissolved",
    "GangReserved",
    "GangRollback",
    "JournalTruncated",
    "KubeletReregistered",
    "LinkFault",
    "LinkRecovered",
    "PreemptionExecuted",
    "PreemptionPlanned",
    "RecoveryCompleted",
    "RecoveryDiverged",
    "RetryExhausted",
    "TenantAdmissionShed",
    "TenantQuotaDenied",
    "VictimEvicted",
    "VictimGone",
    "WatchReconnected",
)


class EventJournal:
    """Bounded, deduplicating ring of typed events + optional JSONL sink.

    ``capacity=0`` disables the journal entirely (emit becomes a no-op),
    which is how config turns it off without every emitter re-checking.
    """

    def __init__(self, capacity: int = 4096, path: Optional[str] = None,
                 max_sink_bytes: int = 0) -> None:
        self.capacity = capacity
        self.path = path or None
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque()
        # (reason, object, message) -> live ring entry, for dedup; keys
        # leave the map when their entry is evicted from the ring
        self._live: dict[tuple[str, str, str], dict[str, Any]] = {}
        self._seq = 0
        # emissions per reason, deduped ones included (the
        # ``tpukube_events_total{reason}`` counter on /metrics)
        self._by_reason: dict[str, int] = {}
        # The sink is a trace.JsonlSink: emit() only ENQUEUES the
        # serialized line — the file write happens on the sink's drain
        # thread. Emitters call from inside the gang manager's lock and
        # the extender's decision paths, where one blocked write
        # syscall would freeze every concurrent webhook.
        # ``max_sink_bytes`` rotates the file once to ``<path>.1`` at
        # the cap, same policy as the decision-trace sink.
        self._sink = None
        if self.path and capacity > 0:
            from tpukube_torch.trace import JsonlSink

            self._sink = JsonlSink(self.path, max_bytes=max_sink_bytes)

    # -- emission ----------------------------------------------------------
    def emit(self, reason: str, obj: str = "", message: str = "",
             type: str = NORMAL, node: str = "") -> Optional[dict[str, Any]]:
        """Record one event. ``obj`` names what the event is about, in
        ``kind/name`` form ("pod/default/p0", "gang/default/llama",
        "chip/tpu-3", "node/host-0-0-0"); ``node`` optionally pins the
        host for node-scoped filtering. Returns the (possibly deduped)
        ring entry, or None when the journal is disabled."""
        if self.capacity <= 0:
            return None
        now = time.time()
        key = (reason, obj, message)
        with self._lock:
            self._by_reason[reason] = self._by_reason.get(reason, 0) + 1
            ev = self._live.get(key)
            if ev is not None:
                ev["count"] += 1
                ev["last_ts"] = now
            else:
                self._seq += 1
                ev = {
                    "seq": self._seq,
                    "type": type,
                    "reason": reason,
                    "object": obj,
                    "node": node,
                    "message": message,
                    "count": 1,
                    "first_ts": now,
                    "last_ts": now,
                }
                self._ring.append(ev)
                self._live[key] = ev
                while len(self._ring) > self.capacity:
                    old = self._ring.popleft()
                    okey = (old["reason"], old["object"], old["message"])
                    if self._live.get(okey) is old:
                        del self._live[okey]
            if self._sink is not None:
                # serialize under the lock (the ring entry mutates on
                # later dedups; enqueue order = emission order)
                self._sink.write(json.dumps(ev, sort_keys=True) + "\n")
            return ev

    # -- queries -----------------------------------------------------------
    def events(self, reason: Optional[str] = None,
               pod: Optional[str] = None, node: Optional[str] = None,
               since: Optional[float] = None,
               limit: Optional[int] = None) -> list[dict[str, Any]]:
        """Filtered view of the ring, oldest first. ``pod`` matches the
        object's pod identity (``pod/<key>`` objects and any object whose
        name embeds the pod key); ``since`` is an absolute unix ts."""
        with self._lock:
            out = [dict(ev) for ev in self._ring]
        out = filter_events(out, reason=reason, pod=pod, node=node,
                            since=since)
        if limit is not None:
            out = out[-limit:]
        return out

    def counts_by_reason(self) -> dict[str, int]:
        """Cumulative emissions per reason (feeds the
        ``tpukube_events_total{reason=...}`` counter)."""
        with self._lock:
            return dict(self._by_reason)

    def stats(self) -> dict[str, Any]:
        sink_bytes, rotations = (
            self._sink.stats() if self._sink is not None else (None, 0)
        )
        with self._lock:
            return {
                "enabled": self.capacity > 0,
                "capacity": self.capacity,
                "events": len(self._ring),
                "total_emitted": sum(self._by_reason.values()),
                "sink_path": self.path,
                "sink_bytes": sink_bytes,
                "sink_rotations": rotations,
            }

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()


def filter_events(events: Iterable[dict[str, Any]],
                  reason: Optional[str] = None, pod: Optional[str] = None,
                  node: Optional[str] = None,
                  since: Optional[float] = None,
                  replica: Optional[str] = None) -> list[dict[str, Any]]:
    """The journal's query predicate over plain event dicts — shared by
    the live ring and `tpukube-obs events` reading a JSONL sink.
    ``replica`` matches the source-replica attribution a federated
    merge stamps (sched/shard.py ``events_federated``); events without
    one (a single-planner journal) never match a replica filter."""
    out = []
    for ev in events:
        if not isinstance(ev, dict):
            continue
        if reason is not None and ev.get("reason") != reason:
            continue
        if node is not None and ev.get("node") != node:
            continue
        if replica is not None and ev.get("replica") != replica:
            continue
        if pod is not None:
            # exact pod identity only: "pod/<key>" or any object whose
            # name tail IS the key — substring matching would leak
            # default/p10..p19's events into a default/p1 query
            obj = str(ev.get("object", ""))
            if obj != f"pod/{pod}" and not obj.endswith(f"/{pod}"):
                continue
        if since is not None and float(ev.get("last_ts", 0)) < since:
            continue
        out.append(ev)
    return out


def load(path: str) -> list[dict[str, Any]]:
    """Read a JSONL event sink back into a list ([] for a missing file),
    through the trace module's torn-line-tolerant loader."""
    if not os.path.exists(path):
        return []
    from tpukube_torch.trace import load as _load_jsonl

    return _load_jsonl(path)


def format_event(ev: dict[str, Any]) -> str:
    """One human line per event (``obs events``' default output)."""
    ts = time.strftime("%H:%M:%S", time.localtime(ev.get("last_ts", 0)))
    count = ev.get("count", 1)
    suffix = f" (x{count})" if count > 1 else ""
    node = f" [{ev['node']}]" if ev.get("node") else ""
    replica = f" @{ev['replica']}" if ev.get("replica") else ""
    return (f"{ts} {ev.get('type', NORMAL):7s} {ev.get('reason', '?'):20s} "
            f"{ev.get('object', ''):32s} {ev.get('message', '')}"
            f"{suffix}{node}{replica}")
