"""Spans on the workload's hot path, recorded only while a torch profiler
runs in the process.

    with span("tpukube.forward", tokens):
        ...

Outside a profiler, :func:`span` checks one flag
(``torch.autograd._profiler_enabled``) and returns a shared no-op object:
nothing is allocated and nothing recorded. Inside one (``kubebench``'s
``--trace 1``, or an operator profiling a pod), a span

- opens a ``torch.profiler.record_function`` range of its name, so it
  shows in the profiler's trace around the kernels it launched;
- takes the host's start and end on the profiler's clock (unix time,
  ``time.time_ns``), its id, its parent's id (the span open around it on
  the same thread) and its root's id: the spans of one request or one
  step share a root;
- where it is given a CUDA tensor or device, records a pair of timing
  events on that device's current stream; their elapsed time, read at
  export, is the span's ``device_ms``: the device's wall time from the
  span's first work to its last, idle time inside included. Elsewhere
  ``device_ms`` is the host's duration;
- keeps the counters its work hands it (``s.count("rows_per_expert",
  t)``: a small tensor, on the device where the work ran, that nothing
  writes afterwards) and reads them only at export, beside the timing
  events, so that the hot path never waits for the device. They go out
  as ``counts``, each a list.

The no-op span takes the same ``count`` call and keeps nothing.

A span opened on a thread with none open is a root: the recomputation
that a backward pass runs on autograd's device thread records its
attention spans as roots.

Finished spans wait in a bounded ring. When the process exits, if any were
recorded, :meth:`Recorder.export` writes them once, through
:class:`tpukube_torch.trace.JsonlSink`, as ``kind: "span"`` events in the
decision trace's shape (``request`` holds ``name``, ``t0`` and ``t1`` in
seconds, ``device_ms``, ``id``, ``parent`` and ``root``), to one file per
process under :func:`default_dir`, which keeps the newest
:data:`FILES_KEPT` files. :func:`tpukube_torch.trace.load` reads a file
back, and ``python -m tpukube_torch.cli obs timeline --merge`` draws its
spans as enclosing slices beside the scheduler's captures.
:func:`files_for` finds the file of a process by the stretch of time its
profiler covered: the benchmark's readers (``kubebench/metrics/``) set
the spans against the kernels of the same stretch.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Optional, Union

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from tpukube_torch.trace import JsonlSink, load

CAPACITY = 16384
FILES_KEPT = 64
PREFIX = "spans-"
# how far a span may lie outside a window that holds it, for two readings
# of the same clock
SLACK_S = 1e-3


def default_dir() -> str:
    """Where a process's span file goes."""
    return os.path.join(tempfile.gettempdir(), "tpukube_torch-spans")


class _Off:
    """The span outside a profiler: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def count(self, name: str, value) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("_rec", "_device", "_stream", "_events", "_range", "_counts", "name",
                 "id", "parent", "root", "t0", "t1")

    def __init__(self, rec: "Recorder", name: str, device: Optional[torch.device]):
        self._rec = rec
        self._device = device
        self._events = None
        self._counts = None
        self.name = name

    def __enter__(self) -> "_Span":
        stack = self._rec._stack()
        top = stack[-1] if stack else None
        self.id = next(self._rec._ids)
        self.parent = top.id if top else None
        self.root = top.root if top else self.id
        self._range = record_function(self.name)
        self._range.__enter__()
        # the host's stamps next to the range's own ends
        self.t0 = time.time_ns()
        if self._device is not None:
            # looked up once: the lookup costs microseconds a call
            self._stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(self._stream)
        self.t1 = time.time_ns()
        self._range.__exit__(*exc)
        self._rec._stack().pop()
        self._rec._finish(self)
        return False

    def count(self, name: str, value: torch.Tensor) -> None:
        """Keep ``value`` (not read now) as the counter ``name``."""
        if self._counts is None:
            self._counts = {}
        self._counts[name] = value

    def as_dict(self) -> dict:
        device_ms = (self.t1 - self.t0) / 1e6
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            device_ms = start.elapsed_time(end)
        out = {"name": self.name, "t0": self.t0 / 1e9, "t1": self.t1 / 1e9,
               "device_ms": device_ms, "id": self.id, "parent": self.parent,
               "root": self.root}
        if self._counts:
            out["counts"] = {k: v.tolist() for k, v in self._counts.items()}
        return out


class Recorder:
    """The spans of one process: a ring of finished spans, each thread's
    open ones, and the export at exit."""

    def __init__(self, capacity: int = CAPACITY):
        self._done: deque = deque(maxlen=capacity)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._armed = False

    def span(self, name: str, at: Union[torch.Tensor, torch.device, None] = None):
        """A context manager around one stretch of work; ``at`` is a
        tensor the work runs beside, or its device, for the device's
        timing events."""
        if not _profiler_enabled():
            return OFF
        device = at.device if isinstance(at, torch.Tensor) else at
        return _Span(self, name, device if device is not None and device.type == "cuda" else None)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, s: _Span) -> None:
        self._done.append(s)
        if not self._armed:
            with self._lock:
                if not self._armed:
                    self._armed = True
                    atexit.register(self.export)

    def drain(self) -> list:
        """The finished spans as dicts, by start, and forget them."""
        spans = []
        while self._done:
            spans.append(self._done.popleft())
        return sorted((s.as_dict() for s in spans), key=lambda d: d["t0"])

    def export(self, directory: Optional[str] = None) -> Optional[str]:
        """Write the finished spans to a new file in ``directory``
        (:func:`default_dir` by default), drop the oldest files past
        :data:`FILES_KEPT`; -> the file, or None where none was recorded."""
        spans = self.drain()
        if not spans:
            return None
        directory = directory or default_dir()
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{PREFIX}{os.getpid()}-{time.time_ns()}.jsonl")
        sink = JsonlSink(path)
        try:
            for seq, s in enumerate(spans, start=1):
                sink.write(json.dumps({"seq": seq, "ts": s["t1"], "kind": "span",
                                       "request": s, "response": None}, sort_keys=True) + "\n")
        finally:
            sink.close()
        _prune(directory, FILES_KEPT)
        return path


def _files(directory: str) -> list:
    """(mtime, path) of the span files in ``directory``."""
    files = []
    for name in os.listdir(directory):
        if name.startswith(PREFIX) and name.endswith(".jsonl"):
            path = os.path.join(directory, name)
            try:
                files.append((os.path.getmtime(path), path))
            except FileNotFoundError:  # another process pruned it
                continue
    return files


def _prune(directory: str, keep: int) -> None:
    for _, path in sorted(_files(directory), reverse=True)[keep:]:
        try:
            os.remove(path)
        except FileNotFoundError:
            continue


def files_for(windows: list, directory: Optional[str] = None) -> Optional[list]:
    """For each (start, end) window in unix seconds, the spans (their
    ``request`` dicts) of the one file in ``directory`` whose spans all lie
    inside it, give or take :data:`SLACK_S`: a profiled process's spans
    fall inside the stretch it profiled. None where a window has no such
    file, or more than one."""
    directory = directory or default_dir()
    if not os.path.isdir(directory):
        return None
    loaded = []
    for _, path in _files(directory):
        spans = [e["request"] for e in load(path) if e.get("kind") == "span"]
        if spans:
            loaded.append((min(s["t0"] for s in spans), max(s["t1"] for s in spans), spans))
    out = []
    for start, end in windows:
        inside = [spans for t0, t1, spans in loaded
                  if t0 >= start - SLACK_S and t1 <= end + SLACK_S]
        if len(inside) != 1:
            return None
        out.append(inside[0])
    return out


RECORDER = Recorder()
span = RECORDER.span
