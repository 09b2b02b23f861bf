"""Scheduling decision trace — the port's own copy of ``JsonlSink`` and
``DecisionTrace`` from ``tpukube/trace.py``.

Every webhook decision (filter / prioritize / bind) and every pod release
is recorded at the protocol boundary — the exact request JSON in, the
exact response JSON out — as one event, in a bounded in-memory ring with
an optional JSONL file sink. The trace is on by default
(``trace_capacity`` 4096), so the default decision path records into it.
:func:`load` reads a JSONL capture back (a torn last line is skipped),
and :func:`replay` re-runs a recorded stream against a fresh extender and
reports every divergence (``python -m tpukube_torch.cli ctl replay``).
"""

from __future__ import annotations

import contextvars
import io
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

#: Cross-process trace context: a trace id and parent span id that the
#: shard router (``sched/shard.py``'s ``_traced``) sets around each
#: fanned operation. The decision trace (``record`` below) and the
#: provenance ring (``obs/decisions.py``) tag what they record while it
#: is set, so ``obs timeline --merge`` can nest replica spans under the
#: router's and a stitched explain can join the replica's stages to the
#: router's. A contextvar, not a thread local: concurrent requests on
#: one thread never share one context. Unset (None: one replica, or no
#: router) means no tagging at all.
TRACE_CONTEXT: contextvars.ContextVar[Optional[dict]] = \
    contextvars.ContextVar("tpukube_trace_context", default=None)

# Event kinds. filter/prioritize/bind carry the webhook request/response
# verbatim; release carries the pod key; reconcile carries a kubelet
# device-id divergence report being folded into the ledger
# (apiserver.AllocReconcileLoop); upsert_node(s) carry node annotation
# refreshes applied outside any webhook (apiserver.NodeTopologyRefreshLoop);
# victim_gone carries an evicted pod's confirmed deletion (it unblocks
# masked chips).
KINDS = ("filter", "prioritize", "bind", "release", "reconcile",
         "upsert_node", "upsert_nodes", "victim_gone")

# Annotation kinds: pure observability markers (gang reserve, gang
# commit). They mutate nothing.
ANNOTATION_KINDS = ("span",)


class JsonlSink:
    """Size-capped JSONL file sink with a dedicated drain thread —
    shared by :class:`DecisionTrace` and the event journal
    (``tpukube_torch.obs.events``).

    ``write()`` only enqueues (a deque append + condition notify): the
    file I/O happens on the sink's own daemon thread, so a stalled disk
    can never block an emitter — and emitters call from inside the gang
    manager's lock and the extender's decision paths, where one blocked
    write syscall would freeze every concurrent webhook. Lines are
    written in enqueue order (single drain thread). ``max_bytes`` caps
    the file: at the cap it rotates once to ``<path>.1`` (replacing the
    previous rotation) so incident captures on a long-lived daemon
    cannot fill the disk. ``close()`` drains what is queued, then joins
    the thread — call it before reading the file for a complete view.
    """

    def __init__(self, path: str, max_bytes: int = 0) -> None:
        self.path = path
        self.max_bytes = max_bytes
        self._cond = threading.Condition()
        self._pending: deque[str] = deque()
        self._closed = False
        # explicit utf-8: event/trace text embeds arbitrary runtime
        # strings; a C-locale node must not drop a whole drain batch to
        # UnicodeEncodeError
        self._file: Optional[io.TextIOBase] = open(
            path, "a", buffering=1, encoding="utf-8"
        )
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0
        self._rotations = 0
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tpukube-jsonl-sink",
        )
        self._thread.start()

    def write(self, line: str) -> None:
        """Enqueue one line (non-blocking; dropped after close)."""
        with self._cond:
            if self._closed:
                return
            self._pending.append(line)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                lines = list(self._pending)
                self._pending.clear()
                closing = self._closed
            try:
                self._write_out(lines)
            except Exception:
                # a sink failure must never kill the drain thread while
                # the daemon keeps emitting
                logging.getLogger("tpukube_torch.trace").exception(
                    "JSONL sink write failed (%s)", self.path
                )
            if closing:
                return

    def _write_out(self, lines: list[str]) -> None:
        f = self._file
        if f is None:
            return
        for line in lines:
            # count ENCODED bytes: the cap guards disk, and multi-byte
            # text counted as characters would overshoot max_bytes 4x
            # (it is also what the getsize() seed above measures)
            nbytes = len(line.encode("utf-8"))
            if (self.max_bytes > 0 and self._bytes > 0
                    and self._bytes + nbytes > self.max_bytes):
                f.close()
                try:
                    os.replace(self.path, f"{self.path}.1")
                except OSError:
                    pass  # worst case we truncate in place below
                f = self._file = open(self.path, "w", buffering=1,
                                      encoding="utf-8")
                with self._cond:
                    self._bytes = 0
                    self._rotations += 1
            f.write(line)
            with self._cond:
                self._bytes += nbytes

    def stats(self) -> tuple[int, int]:
        """(bytes in the live file, rotations so far)."""
        with self._cond:
            return self._bytes, self._rotations

    def close(self) -> None:
        """Flush the queue, stop the drain thread, close the file.
        Idempotent."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=10.0)
        if self._file is not None:
            self._file.close()
            self._file = None


@dataclass
class DecisionTrace:
    """Bounded ring of decision events, with an optional JSONL file sink.

    The sink is a :class:`JsonlSink`: recording only ENQUEUES the
    serialized line (under the ring lock, preserving seq order); the
    file write happens on the sink's drain thread, so disk latency
    never reaches the decision path. ``max_sink_bytes`` caps the sink
    file with one ``<path>.1`` rotation generation.
    """

    capacity: int = 65536
    path: Optional[str] = None
    max_sink_bytes: int = 0  # 0 = unlimited
    _events: deque = field(init=False)
    _lock: threading.Lock = field(init=False,
                                  default_factory=lambda: threading.Lock())
    _seq: int = field(init=False, default=0)
    _sink: Optional[JsonlSink] = field(init=False, default=None)

    def __post_init__(self) -> None:
        self._events = deque(maxlen=self.capacity)
        if self.path:
            self._sink = JsonlSink(self.path, max_bytes=self.max_sink_bytes)

    def record(self, kind: str, request: Any, response: Any) -> dict:
        assert kind in KINDS or kind in ANNOTATION_KINDS, kind
        ctx = TRACE_CONTEXT.get()
        with self._lock:
            self._seq += 1
            ev = {
                "seq": self._seq,
                "ts": time.time(),
                "kind": kind,
                "request": request,
                "response": response,
            }
            if ctx is not None:
                # router-originated request: tag the event so merged
                # timelines can parent this decision under the fan-out
                # span (absent outside the sharded plane — replay
                # ignores it)
                ev["ctx"] = dict(ctx)
            self._events.append(ev)
            if self._sink is not None:
                # enqueue under the ring lock so sink order IS seq order
                self._sink.write(json.dumps(ev, sort_keys=True) + "\n")
        return ev

    def span(self, name: str, pod_key: str, **fields: Any) -> dict:
        """Record one observability span marker attributed to a pod (the
        timeline correlates these with the decision events by pod key).
        ``fields`` must be JSON-able."""
        request = {"name": name, "pod_key": pod_key}
        request.update(fields)
        return self.record("span", request, None)

    def events(self, since_seq: int = 0) -> list[dict]:
        with self._lock:
            return [e for e in self._events if e["seq"] > since_seq]

    def stats(self) -> dict:
        """Ring statistics for /statusz: occupancy, total recorded, and
        how many events the bounded ring has already dropped (non-zero
        means an incident capture should use a file sink)."""
        sink_bytes, rotations = (
            self._sink.stats() if self._sink is not None else (None, 0)
        )
        with self._lock:
            return {
                "enabled": True,
                "capacity": self.capacity,
                "events": len(self._events),
                "last_seq": self._seq,
                "dropped": max(0, self._seq - len(self._events)),
                "sink_path": self.path or None,
                "sink_bytes": sink_bytes,
                "sink_rotations": rotations,
            }

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()


def load(path: str) -> list[dict]:
    """Read a JSONL trace file back into an event list. Undecodable
    lines are skipped (counted in a log warning): a daemon that crashed
    mid-write leaves a torn final line, and the rest of the capture is
    what an investigation needs."""
    out: list[dict] = []
    bad = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                bad += 1
    if bad:
        logging.getLogger("tpukube_torch.trace").warning(
            "%s: skipped %d undecodable line(s)", path, bad
        )
    return out


@dataclass
class Divergence:
    seq: int
    kind: str
    recorded: Any
    replayed: Any

    def __str__(self) -> str:  # the divergence report ``ctl replay`` prints
        return (
            f"divergence at seq {self.seq} ({self.kind}):\n"
            f"  recorded: {json.dumps(self.recorded, sort_keys=True)[:400]}\n"
            f"  replayed: {json.dumps(self.replayed, sort_keys=True)[:400]}"
        )


def replay(
    events: Iterable[dict],
    extender: Optional[Any] = None,
    config: Optional[Any] = None,
    stop_on_divergence: bool = True,
) -> list[Divergence]:
    """Re-run a recorded decision stream against a fresh Extender and
    return every point where the replayed response differs.

    An empty result proves the scheduler is a deterministic function of
    its request stream (time-dependent behavior — gang TTL sweeps — only
    fires on inactivity gaps longer than the TTL, which a replay never
    reproduces, so a clean capture replays clean).
    """
    # local import: trace must stay importable from the extender module
    from tpukube_torch.core.config import load_config
    from tpukube_torch.sched.extender import Extender

    if extender is None:
        from dataclasses import replace as _dc_replace

        cfg = config or load_config(env={})
        # replay must not record (or append to the live trace/event
        # sinks!) — the replayed extender is a scratch instance
        extender = Extender(_dc_replace(
            cfg, trace_capacity=0, trace_path="", events_path="",
        ))
    divergences: list[Divergence] = []

    def _check(ev: dict, replayed: Any) -> bool:
        if _canon(replayed) != _canon(ev["response"]):
            divergences.append(
                Divergence(ev["seq"], ev["kind"], ev["response"], replayed)
            )
            return stop_on_divergence
        return False

    for ev in events:
        kind, req = ev["kind"], ev["request"]
        if kind in ANNOTATION_KINDS:
            continue  # observability markers: nothing to re-dispatch
        if kind not in KINDS:  # newer trace format: report, don't crash
            divergences.append(Divergence(ev.get("seq", -1), kind, ev, None))
            if stop_on_divergence:
                break
            continue
        # replay through the SAME dispatch the live daemon uses (the
        # scratch extender has tracing disabled, so nothing re-records)
        try:
            replayed = extender.handle(kind, req)
        except Exception as e:  # tpukube: allow(exception-hygiene) the replay error IS the output — it lands in the divergence report the caller prints
            replayed = {"replayError": f"{type(e).__name__}: {e}"}
        if kind == "release":
            continue  # releases have no response to compare
        if _check(ev, replayed):
            break
    return divergences


def _canon(obj: Any) -> str:
    return json.dumps(obj, sort_keys=True)
