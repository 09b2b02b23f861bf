"""Shard worker daemon: one planner replica as its own process — the port's
copy of ``tpukube/sched/shardworker.py``, on ``http.server``.

The process-parallel sharded control plane runs each
:class:`~tpukube_torch.sched.shard.PlannerReplica` as an OS process: a
plain :class:`~tpukube_torch.sched.extender.Extender` (``planner_replicas``
1 — a worker IS one planner, never a router) serving

  * the extender's whole HTTP surface (:class:`~tpukube_torch.sched.
    extender.App`: /filter, /prioritize, /bind, /healthz, /metrics,
    /state/*, /statusz, /explain, ...), and
  * the ``/worker/*`` routes below — the replica half of
    :class:`~tpukube_torch.sched.shard.SubprocessTransport`: batch
    admit/plan/bind for the driver path, gauges and gang prepare for the
    router's two-phase rendezvous, summary/allocs for the federated
    reads, the eviction drain and the ``FakeClock`` advance.

Every ``/worker`` route dispatches into the SAME replica-side helpers the
in-process transport calls directly (``shard.replica_gauges``,
``shard.gang_prepare_part``, ...): the transport changes the wire, never
the computation.

At the edges it behaves as the reference's aiohttp app: the router's
``X-Tpukube-Trace: <trace>/<parent>`` header sets
``trace.TRACE_CONTEXT`` for the request; a ``/worker`` body is decoded by
its ``Content-Type`` (JSON or a TKW1 frame, ``sched/wirecodec.py``) and
the answer is TKW1 only when ``Accept`` asks for it; a corrupt frame or
body is a 400 and the worker goes on serving; bodies up to
``CLIENT_MAX_SIZE`` are read. The ``/worker`` routes run one at a time (as
on the reference's single event loop) but ``/worker/stall`` and
``/healthz``. A handler that raises answers 500 with the error: the
router reads a request defect, never a dead replica.

``python -m tpukube_torch.cli shard-worker --config F --port P`` (P may be
0: the kernel picks one) prints one JSON line ``{"serving": {"host",
"port", "pid"}}`` on stdout once it listens, then serves until SIGTERM or
SIGINT, and closes its sinks and journal on the way out.

:func:`make_router_app` is the router's observability listener
(federated /metrics, /statusz, /explain, /events, /trace, /capacity),
served by the extender's threaded server: each connection gets its own
thread, so a slow fan-out behind one route never holds the listener's own
/healthz.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Optional
from urllib.parse import parse_qsl, urlsplit

from tpukube_torch import trace as trace_mod
from tpukube_torch.core import codec
from tpukube_torch.sched import kube, shard, wirecodec
from tpukube_torch.sched.extender import App, Extender, Server, _Handler
from tpukube_torch.sched.gang import GangError
from tpukube_torch.sched.state import StateError

log = logging.getLogger("tpukube_torch.shardworker")

#: batched transport bodies (a 10k-node fleet upsert, a 2k-pod admit wave,
#: a rebuild feed) are far past a webhook's size; the reference raises
#: aiohttp's 1 MiB default to this
CLIENT_MAX_SIZE = 1 << 30

#: the stdout line a worker prints once it listens (its first)
READY_KEY = "serving"


class BadRequest(Exception):
    """A request the worker answers with 400 (the caller's defect)."""


class WorkerApp(App):
    """The worker daemon's app: the extender's whole surface plus the
    ``/worker/*`` transport routes (:data:`WORKER_ROUTES`)."""

    def __init__(self, extender: Extender, clock=None) -> None:
        super().__init__(extender)
        self.clock = clock
        # the worker side is capability-driven: it decodes whatever the
        # router sent and answers TKW1 only when asked; the compression
        # threshold comes from config so both ends compress alike
        self.compress_min = extender._config.wire_compress_min_bytes
        self._serial = threading.Lock()

    # -- bodies ---------------------------------------------------------------
    @staticmethod
    def body(raw: bytes, content_type: str) -> Any:
        if content_type.split(";", 1)[0].strip() == \
                wirecodec.WIRE_CONTENT_TYPE:
            try:
                return wirecodec.decode_frame(raw)
            except wirecodec.WireCodecError as e:
                # the caller's defect: 400, and keep serving
                raise BadRequest(f"bad wire frame: {e}") from None
        try:
            return json.loads(raw) if raw else {}
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise BadRequest(f"bad JSON: {e}") from None

    def encode(self, obj: Any, accept: str) -> tuple[bytes, str]:
        """(payload, content type) of an answer: TKW1 when ``accept``
        names it, compact JSON otherwise."""
        if wirecodec.WIRE_CONTENT_TYPE in accept:
            frame, _ = wirecodec.encode_frame(obj, self.compress_min)
            return frame, wirecodec.WIRE_CONTENT_TYPE
        return (wirecodec.dumps_json(obj),
                "application/json; charset=utf-8")

    def dispatch(self, method: str, path: str, query: dict[str, str],
                 doc: Any) -> Any:
        """The answer of one ``/worker`` route; raises KeyError for an
        unknown route, BadRequest for a bad request."""
        route = WORKER_ROUTES[path]
        if route[0] != method:
            raise BadRequest(f"{path} takes {route[0]}")
        if path == "/worker/stall":
            return route[1](self, doc, query)
        with self._serial:
            return route[1](self, doc, query)

    # -- the routes -------------------------------------------------------------
    def w_handle(self, doc, _q):
        try:
            return self.extender.handle(doc["kind"], doc["body"])
        except kube.KubeSchemaError as e:
            # in-band so the router re-raises the SAME exception type
            # the in-process transport would have propagated
            return {"schema_error": str(e)}

    def w_upsert(self, doc, _q):
        # one bulk-ingest decision for the whole batch
        return {"results": self.extender.upsert_nodes_many(doc["items"])}

    def w_admit(self, doc, _q):
        admitted = []
        for obj in doc["pods"]:
            try:
                admitted.append(bool(self.extender.admit(
                    kube.pod_from_k8s(obj))))
            except kube.KubeSchemaError as e:
                log.error("admit: undecodable pod object (%s)", e)
                admitted.append(False)
        return {"admitted": admitted}

    def w_plan(self, _doc, _q):
        return {"planned": self.extender.plan_pending()}

    def w_planned(self, doc, _q):
        return {"nodes": {key: self.extender.planned_node(key)
                          for key in doc["keys"]}}

    def w_bind(self, doc, _q):
        results = []
        for body in doc["bodies"]:
            try:
                results.append(self.extender.handle("bind", body))
            except kube.KubeSchemaError as e:
                results.append(kube.binding_result(f"bad bind body: {e}"))
        return {"results": results}

    def w_release(self, doc, _q):
        for key in doc["keys"]:
            self.extender.handle("release", {"pod_key": key})
        return {}

    def w_gauges(self, _doc, _q):
        return {"slices": shard.replica_gauges(self.extender)}

    def w_gang(self, doc, _q):
        ext = self.extender
        op = doc.get("op")
        try:
            if op == "fit":
                pod = kube.pod_from_k8s(doc["pod"])
                return {"fits": shard.gang_fit_probe(ext, pod,
                                                     int(doc["total"]))}
            if op == "prepare":
                pod = kube.pod_from_k8s(doc["pod"])
                return {"parts": shard.gang_prepare_part(
                    ext, pod, int(doc["cpp"]),
                    {sid: int(v) for sid, v in doc["volumes"].items()})}
            key = ((doc["namespace"], doc["name"])
                   if "namespace" in doc else None)
            if op == "drop":
                ext.gang.drop_reservation(key)
                return {}
            if op == "dissolve":
                ext.gang.dissolve(key)
                return {}
            if op == "reservation":
                res = ext.gang.reservation(*key)
                return {"reservation": None if res is None else {
                    "committed": res.committed,
                    "slices": {sid: sorted(coords) for sid, coords
                               in res.slice_coords.items()},
                }}
            if op == "sweep":
                ext.gang.sweep()
                return {}
        except GangError as e:
            return {"error": str(e), "kind": "gang"}
        except StateError as e:
            return {"error": str(e), "kind": "state"}
        raise BadRequest(f"unknown gang op {op!r}")

    def w_allocs(self, _doc, _q):
        return {"allocs": [codec.alloc_obj(a)
                           for a in self.extender.state.allocations()]}

    def w_allocs_since(self, doc, _q):
        # generation-based incremental resync: a churn wave's federated
        # read moves the changed allocations, not the whole ledger
        out = self.extender.state.allocs_since(doc.get("cursor"))
        if out is None:
            return {"disabled": True}
        wire: dict = {"cursor": list(out["cursor"]), "bytes": out["bytes"]}
        if "full" in out:
            wire["full"] = [codec.alloc_obj(a) for a in out["full"]]
        else:
            wire["adds"] = [codec.alloc_obj(a) for a in out["adds"]]
            wire["removes"] = out["removes"]
        return wire

    def w_recover(self, doc, _q):
        # warm restart from this worker's own journal segment, reconciled
        # against the router's node and pod truth; an error answer sends
        # the router to the cold re-ingest on a fresh daemon
        from tpukube_torch.sched import journal as journal_mod

        ext = self.extender
        if ext.journal is None:
            return {"recover_error": "journal disabled"}
        try:
            stats = journal_mod.recover_extender(
                ext, shard._ListApi(doc.get("nodes") or [],
                                    doc.get("pods") or []))
        except journal_mod.JournalError as e:
            return {"recover_error": str(e)}
        return {"stats": stats, "restored": len(ext.state.allocations())}

    def w_alloc(self, _doc, q):
        a = self.extender.state.allocation(q.get("pod", ""))
        return {"alloc": codec.alloc_obj(a) if a is not None else None}

    def w_nodes(self, _doc, _q):
        return {"names": list(self.extender.state.node_names())}

    def w_summary(self, _doc, _q):
        return shard.replica_summary(self.extender)

    def w_emit(self, doc, _q):
        self.extender.events.emit(
            doc.get("reason", ""), obj=doc.get("obj", ""),
            message=doc.get("message", ""),
            **({"type": doc["type"]} if doc.get("type") else {}),
        )
        return {}

    def w_rebuild(self, doc, _q):
        return {"restored": self.extender.rebuild_from_pods(doc["pods"])}

    def w_evictions(self, _doc, _q):
        out: list[str] = []
        q = self.extender.pending_evictions
        while True:
            try:
                out.append(q.popleft())
            except IndexError:
                return {"pods": out}

    def w_stall(self, doc, _q):
        # hold this request open without holding the worker: the router's
        # fan-out concurrency test measures overlap with it
        time.sleep(min(float(doc.get("seconds", 0)), 5.0))
        return {}

    def w_advance(self, doc, _q):
        adv = getattr(self.clock, "advance", None)
        if adv is None:
            raise BadRequest("worker runs the system clock (spawn with "
                             "--fake-clock to advance simulated time)")
        adv(float(doc["seconds"]))
        return {"now": self.clock.monotonic()}


# path -> (method, WorkerApp route)
WORKER_ROUTES: dict[str, tuple[str, Callable]] = {
    "/worker/handle": ("POST", WorkerApp.w_handle),
    "/worker/upsert": ("POST", WorkerApp.w_upsert),
    "/worker/admit": ("POST", WorkerApp.w_admit),
    "/worker/plan": ("POST", WorkerApp.w_plan),
    "/worker/planned": ("POST", WorkerApp.w_planned),
    "/worker/bind": ("POST", WorkerApp.w_bind),
    "/worker/release": ("POST", WorkerApp.w_release),
    "/worker/gauges": ("GET", WorkerApp.w_gauges),
    "/worker/gang": ("POST", WorkerApp.w_gang),
    "/worker/allocs": ("GET", WorkerApp.w_allocs),
    "/worker/allocs_since": ("POST", WorkerApp.w_allocs_since),
    "/worker/recover": ("POST", WorkerApp.w_recover),
    "/worker/alloc": ("GET", WorkerApp.w_alloc),
    "/worker/nodes": ("GET", WorkerApp.w_nodes),
    "/worker/summary": ("GET", WorkerApp.w_summary),
    "/worker/emit": ("POST", WorkerApp.w_emit),
    "/worker/rebuild": ("POST", WorkerApp.w_rebuild),
    "/worker/evictions": ("POST", WorkerApp.w_evictions),
    "/worker/advance": ("POST", WorkerApp.w_advance),
    "/worker/stall": ("POST", WorkerApp.w_stall),
}


class _WorkerHandler(_Handler):
    """The extender's handler with the router's trace context set for each
    request, the raised body cap, and the ``/worker`` routes."""

    def _too_big(self) -> bool:
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            n = -1
        if 0 <= n <= CLIENT_MAX_SIZE:
            return False
        self.close_connection = True
        self._text(413, f"body of {n} bytes: the limit is "
                        f"{CLIENT_MAX_SIZE}")
        return True

    def _traced(self, fn) -> None:
        # the router stamps X-Tpukube-Trace: <trace>/<parent span> on every
        # fanned request: the replica's decision records and timeline
        # spans tag themselves with it, the join key of the merged
        # timeline and the stitched /explain. No header (an unsharded
        # deployment, a probe): the records are the unsharded ones.
        hdr = self.headers.get("X-Tpukube-Trace")
        if not hdr:
            fn()
            return
        trace_id, _, parent = hdr.partition("/")
        tok = trace_mod.TRACE_CONTEXT.set({"trace": trace_id,
                                           "parent": parent})
        try:
            fn()
        finally:
            trace_mod.TRACE_CONTEXT.reset(tok)

    def _worker(self, method: str) -> None:
        parts = urlsplit(self.path)
        app: WorkerApp = self.server.app
        raw = b""
        if method == "POST":
            raw = self.rfile.read(int(self.headers.get("Content-Length")
                                      or 0))
        try:
            doc = app.body(raw, self.headers.get("Content-Type", ""))
            out = app.dispatch(method, parts.path,
                               dict(parse_qsl(parts.query)), doc)
        except KeyError as e:
            if parts.path not in WORKER_ROUTES:
                self._text(404, "not found")
            else:
                self._text(500, f"{parts.path}: missing {e}")
            return
        except BadRequest as e:
            self._text(400, str(e))
            return
        except Exception as e:  # a handler's fault: the request fails
            log.exception("%s %s failed", method, parts.path)
            self._text(500, f"{parts.path}: {type(e).__name__}: {e}")
            return
        payload, ctype = app.encode(out, self.headers.get("Accept", ""))
        self._reply(200, payload, ctype)

    def do_POST(self) -> None:  # noqa: N802 (http.server's name)
        if self._too_big():
            return
        if self.path.startswith("/worker/"):
            self._traced(lambda: self._worker("POST"))
        else:
            self._traced(super().do_POST)

    def do_GET(self) -> None:  # noqa: N802
        if self.path.startswith("/worker/"):
            self._traced(lambda: self._worker("GET"))
        else:
            self._traced(super().do_GET)


class WorkerServer(Server):
    """``http.server`` for a :class:`WorkerApp`."""

    handler_class = _WorkerHandler


def make_worker_app(extender: Extender, clock=None) -> WorkerApp:
    """The worker daemon's app: the extender's whole surface plus the
    ``/worker/*`` transport routes."""
    return WorkerApp(extender, clock=clock)


def run_worker_server(app: WorkerApp, host: str = "127.0.0.1",
                      port: int = 0) -> WorkerServer:
    """Serve ``app`` from a daemon thread (``port`` 0: a free one, read
    from ``server.server_address``)."""
    server = WorkerServer((host, port), app)
    threading.Thread(target=server.serve_forever, args=(0.05,),
                     daemon=True, name="tpukube-shard-worker-http").start()
    return server


# -- the router's observability listener ---------------------------------------

class RouterApp:
    """The router's federated observability listener: /metrics renders
    every worker's registry under a ``replica`` label plus the router's
    own series; /explain stitches the router's route, spillover and
    rendezvous stages with the owning replicas' chains; /events merges the
    workers' journals with replica attribution; /statusz carries the wire
    bill and the flight recorder. Webhook traffic does not come here: to
    the extender's HTTP handler it is a probe app (no webhook route, no
    bearer gate), GETs only."""

    probe_only = True

    def __init__(self, router) -> None:
        self.router = router

    def authorized(self, path: str, header: Optional[str]) -> bool:
        return True

    def get(self, path: str, query: dict[str, str]) -> tuple[int, Any]:
        router = self.router
        if path == "/healthz":
            return 200, "ok"
        if path == "/metrics":
            from tpukube_torch.metrics import render_federated_metrics

            return 200, render_federated_metrics(router)
        if path == "/statusz":
            from tpukube_torch.obs.statusz import router_statusz

            return 200, router_statusz(router)
        if path == "/explain":
            pod = query.get("pod", "")
            if not pod:
                return 400, "missing ?pod=<ns/name>"
            doc = router.explain(pod)
            if doc is None:
                return 404, ("decision provenance is disabled "
                             "(decisions_enabled: false)")
            return 200, doc
        if path == "/events":
            since = query.get("since")
            try:
                since_f = float(since) if since else None
            except ValueError:
                return 400, "since must be a unix ts"
            return 200, router.events_federated(
                reason=query.get("reason"), pod=query.get("pod"),
                node=query.get("node"), since=since_f,
                replica=query.get("replica"))
        if path == "/trace":
            if router.trace is None:
                return 404, "router tracing disabled"
            try:
                since_seq = int(query.get("since", 0))
            except ValueError:
                return 400, "since must be an integer"
            return 200, router.trace.events(since_seq=since_seq)
        if path == "/capacity":
            from tpukube_torch.obs.capacity import parse_since

            raw = query.get("since")
            try:
                since_c = parse_since(raw) if raw else None
            except ValueError as e:
                return 400, str(e)
            doc = router.capacity_doc(since_c)
            if doc is None:
                return 404, "capacity analytics disabled (set capacity_enabled)"
            return 200, doc
        if path == "/capacity/probe":
            from tpukube_torch.obs.capacity import parse_shape

            try:
                count = int(query["count"]) if "count" in query else None
                shape = (parse_shape(query["shape"]) if "shape" in query
                         else None)
                cpp = int(query.get("chips_per_pod", 1))
                if (count is None) == (shape is None):
                    raise ValueError(
                        "probe wants exactly one of ?count= / ?shape=")
            except ValueError as e:
                return 400, str(e)
            doc = router.capacity_probe(count=count, shape=shape,
                                        chips_per_pod=cpp)
            if doc is None:
                return 404, "capacity analytics disabled (set capacity_enabled)"
            return 200, doc
        if path == "/lockgraph":
            doc = router.lockgraph_report()
            if doc is None:
                return 404, ("dynamic lock-order detector disabled "
                             "(set lock_monitor)")
            return 200, doc
        return 404, "not found"


def make_router_app(router) -> RouterApp:
    """The router's observability listener's app (see :class:`RouterApp`);
    serve it with :func:`~tpukube_torch.sched.extender.run_probe_server`
    (or ``run_server``, which hands back the port)."""
    return RouterApp(router)


# -- the daemon ---------------------------------------------------------------------

def main_worker(argv: Optional[list[str]] = None) -> int:
    """``python -m tpukube_torch.cli shard-worker``: the per-replica
    planner daemon the ``SubprocessTransport`` spawns (and a production
    replica runs)."""
    import argparse
    import os
    import sys

    from tpukube_torch.cli import _install_stop_handlers
    from tpukube_torch.core.clock import SYSTEM, FakeClock
    from tpukube_torch.core.config import load_config

    p = argparse.ArgumentParser(
        prog="tpukube-shard-worker",
        description="one planner replica of the sharded control plane",
    )
    p.add_argument("--config", metavar="YAML", required=True,
                   help="resolved per-replica config (the router writes "
                        "one; production pins one per replica)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True,
                   help="0: a free port, reported on the first stdout line")
    p.add_argument("--fake-clock", action="store_true",
                   help="run scheduling-semantic time on a FakeClock "
                        "advanced by the router (/worker/advance)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    args = p.parse_args(argv)
    logging.basicConfig(
        level=(logging.WARNING, logging.INFO,
               logging.DEBUG)[min(args.verbose, 2)],
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    stop = _install_stop_handlers()
    cfg = load_config(yaml_path=args.config)
    if cfg.planner_replicas != 1:
        p.error("a shard worker is ONE planner replica: the config must say "
                "planner_replicas: 1 (the router writes per-replica configs)")
    clock = FakeClock() if args.fake_clock else SYSTEM
    # federated lockgraph: install the dynamic lock-order detector
    # BEFORE the Extender is built so every scheduling lock this replica
    # creates is wrapped; the observed edge set then rides
    # replica_summary's lock_graph key over /worker/summary and the
    # router merges a fleet-wide cycle report
    monitor_installed = False
    if cfg.lock_monitor:
        from tpukube_torch.analysis import lockgraph

        lockgraph.install()
        monitor_installed = True
    extender = Extender(cfg, clock=clock)
    server = None
    try:
        server = run_worker_server(make_worker_app(extender, clock=clock),
                                   args.host, args.port)
        host, port = server.server_address[:2]
        # the spawning router reads the port from this line
        print(json.dumps({READY_KEY: {"host": host, "port": port,
                                      "pid": os.getpid()}}), flush=True)
        log.warning("shard worker serving on %s:%d (fake_clock=%s)",
                    host, port, args.fake_clock)
        stop.wait()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if extender.trace is not None:
            extender.trace.close()
        if extender.decisions is not None:
            extender.decisions.close()
        if extender.capacity is not None:
            extender.capacity.close()
        extender.events.close()
        if extender.journal is not None:
            extender.journal.close()
            extender.state.retire()
        if monitor_installed:
            from tpukube_torch.analysis import lockgraph

            lockgraph.uninstall()
        sys.stdout.flush()
    return 0
