"""ChaosApiServer — fault-injecting proxy over any apiserver surface.
The port's own copy of ``tpukube/chaos/api.py``.

Wraps a FakeApiServer (or the sim harness's pod-store adapter) and
injects the failure modes a real apiserver produces, on the schedule's
deterministic draw:

  * ``error``   — ApiServerError HTTP 503 (server sick; retryable)
  * ``timeout`` — ApiServerError with ``code=None`` (transport error:
    the request may or may not have reached the server — here it did
    NOT, the torn kind covers the did-land half)
  * ``torn``    — the mutation is APPLIED, then the response is
    "lost" (raised as a transport error). The ambiguous-outcome case
    every writer must be idempotent against: a retried bind must
    tolerate 409-already-bound-to-us, a retried patch must re-apply
    harmlessly.
  * ``slow``    — the response is delayed by ``slow_seconds``
  * watch faults — 410 Gone at subscribe (forcing the informer's
    list+watch resync) and per-event drop/duplicate fates (what a
    flaky stream actually does; resyncs must repair both).

Methods not listed in the fault tables pass straight through, and
unknown attributes delegate to the wrapped server — the proxy is
surface-agnostic so the same wrapper chaoses FakeApiServer in informer
tests and the sim pod store in scenario 8.
"""

from __future__ import annotations

import copy
import time
from typing import Any

from tpukube_torch.apiserver import ApiServerError
from tpukube_torch.chaos.schedule import ERROR, SLOW, TIMEOUT, TORN, FaultSchedule

#: unary ops with read-only semantics (torn never applies)
READ_OPS = frozenset({
    "get_pod", "list_pods", "list_pods_with_rv", "list_nodes",
    "list_nodes_with_rv", "get_node_annotations", "node_objects",
    "node_names",
})

#: unary ops that mutate (torn = applied-but-response-lost)
WRITE_OPS = frozenset({
    "patch_node_annotations", "patch_pod_annotations", "bind_pod",
    "evict_pod", "delete_pod", "upsert_pod", "finish_termination",
})

#: watch subscriptions (410-Gone + event-fate injection)
WATCH_OPS = frozenset({"watch_pods", "watch_nodes"})


class ChaosApiServer:
    """Fault-injecting decorator; see module docstring."""

    def __init__(self, inner: Any, schedule: FaultSchedule,
                 sleep=time.sleep) -> None:
        self._inner = inner
        self._schedule = schedule
        self._sleep = sleep

    @property
    def inner(self) -> Any:
        """The wrapped server (assertions read ground truth here)."""
        return self._inner

    @property
    def schedule(self) -> FaultSchedule:
        return self._schedule

    def __getattr__(self, name: str) -> Any:
        target = getattr(self._inner, name)
        if name in READ_OPS or name in WRITE_OPS:
            mutating = name in WRITE_OPS

            def unary(*args, **kwargs):
                kind = self._schedule.draw_unary(name, mutating)
                if kind == SLOW:
                    self._sleep(self._schedule.spec.slow_seconds)
                elif kind == ERROR:
                    raise ApiServerError(
                        f"chaos: injected 503 on {name}", code=503
                    )
                elif kind == TIMEOUT:
                    raise ApiServerError(
                        f"chaos: injected transport timeout on {name}"
                    )
                out = target(*args, **kwargs)
                if kind == TORN:
                    # the write landed; the caller only sees a dead
                    # connection — it MUST retry into idempotency
                    raise ApiServerError(
                        f"chaos: response lost after {name} applied "
                        f"(torn write)"
                    )
                return out

            return unary
        if name in WATCH_OPS:

            def watch(*args, **kwargs):
                if self._schedule.draw_watch_gone(name):
                    raise ApiServerError(
                        f"chaos: injected 410 Gone on {name}", code=410,
                    )
                gen = target(*args, **kwargs)
                return self._event_stream(name, gen)

            return watch
        return target

    def _event_stream(self, op: str, gen):
        for etype, obj in gen:
            fate = self._schedule.event_fate(op)
            if fate == "drop":
                continue
            yield etype, obj
            if fate == "dup":
                yield etype, copy.deepcopy(obj)
