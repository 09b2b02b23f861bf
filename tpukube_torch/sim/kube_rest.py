"""The sim's apiserver over HTTP: a ``FakeApiServer`` store served on
127.0.0.1 over exactly the Kubernetes REST subset that
``tpukube_torch.apiserver.RestApiServer`` speaks, so the REST channel and
every loop on top of it run end to end without a cluster.

    with KubeRestServer(token="t") as kube:
        api = RestApiServer(base_url=kube.base_url, token="t")
        kube.store.upsert_pod(pod)          # the test's (or kubelet's) hand
        api.bind_pod("default", "p0", "node-a", annotations)

Routes (each counted in :attr:`KubeRestServer.requests` under the name on
the left, so a run can prove which it used):

  nodes.list     GET    /api/v1/nodes?limit=N[&continue=T]
  nodes.watch    GET    /api/v1/nodes?watch=1&timeoutSeconds=S[&resourceVersion=V]
  nodes.get      GET    /api/v1/nodes/{name}
  nodes.patch    PATCH  /api/v1/nodes/{name}           (merge-patch of annotations)
  pods.list      GET    /api/v1/pods?limit=N[&continue=T][&fieldSelector=spec.nodeName%3DX]
  pods.watch     GET    /api/v1/pods?watch=1&timeoutSeconds=S[&fieldSelector=..][&resourceVersion=V]
  pods.get       GET    /api/v1/namespaces/{ns}/pods/{name}
  pods.patch     PATCH  /api/v1/namespaces/{ns}/pods/{name}
  pods.delete    DELETE /api/v1/namespaces/{ns}/pods/{name}
  pods.binding   POST   /api/v1/namespaces/{ns}/pods/{name}/binding
  pods.eviction  POST   /api/v1/namespaces/{ns}/pods/{name}/eviction

Every mutation goes through the store's own method, so the store's
semantics are the stand-in's: a Binding to another node is 409, an
Eviction a PodDisruptionBudget blocks (``store.pdb_blocked``) is 429, a
missing pod is 404, a watch from a version older than the store's bounded
history is 410. A list answers with the store's resourceVersion and pages
of ``limit`` items from a snapshot taken at the first page (the
``continue`` token names it). A watch is one chunked response of
``{"type", "object"}`` JSON lines, ending at ``timeoutSeconds`` or at
:meth:`KubeRestServer.stop`. With a ``token``, a request without
``Authorization: Bearer <token>`` is 401 (counted as ``unauthorized``).

Test and smoke infrastructure: no entry point of the node agent or the
extender uses it.
"""

from __future__ import annotations

import itertools
import json
import re
import threading
import urllib.parse
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from tpukube_torch.apiserver import ApiServerError, FakeApiServer

_NODE = re.compile(r"^/api/v1/nodes/([^/]+)$")
_POD = re.compile(r"^/api/v1/namespaces/([^/]+)/pods/([^/]+)(?:/(binding|eviction))?$")


class _Reply(Exception):
    """An HTTP answer other than 200 (status, message)."""

    def __init__(self, status: int, message: str) -> None:
        super().__init__(message)
        self.status = status


def _status_of(e: ApiServerError) -> int:
    # the store raises 404-shaped errors without a code on pod PATCH
    return e.code if e.code is not None else 404


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "_Server"

    # -- plumbing -------------------------------------------------------
    def _send(self, status: int, obj: Any) -> None:
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _status(self, status: int, message: str) -> None:
        self._send(status, {"kind": "Status", "apiVersion": "v1",
                            "status": "Failure", "message": message,
                            "code": status})

    def _body(self) -> Any:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b""
        try:
            return json.loads(raw) if raw else {}
        except json.JSONDecodeError as e:
            raise _Reply(400, f"bad JSON: {e}") from None

    def _authorized(self) -> bool:
        token = self.server.kube.token
        return not token or self.headers.get("Authorization") == f"Bearer {token}"

    def _dispatch(self, method: str) -> None:
        kube = self.server.kube
        url = urllib.parse.urlsplit(self.path)
        query = {k: v[0] for k, v in urllib.parse.parse_qs(url.query).items()}
        if not self._authorized():
            kube.count("unauthorized")
            self._status(401, "Unauthorized")
            return
        try:
            route, args = self._route(method, url.path, query)
            kube.count(route)
            getattr(self, "_" + route.replace(".", "_"))(*args, query)
        except _Reply as r:
            self._status(r.status, str(r))
        except ApiServerError as e:
            self._status(_status_of(e), str(e))

    def _route(self, method: str, path: str, query: dict) -> tuple[str, tuple]:
        if path in ("/api/v1/nodes", "/api/v1/pods") and method == "GET":
            kind = path.rsplit("/", 1)[1]
            return f"{kind}.{'watch' if query.get('watch') in ('1', 'true') else 'list'}", ()
        m = _NODE.match(path)
        if m and method in ("GET", "PATCH"):
            return f"nodes.{method.lower()}", (m.group(1),)
        m = _POD.match(path)
        if m:
            ns, name, sub = m.groups()
            if sub is not None and method == "POST":
                return f"pods.{sub}", (ns, name)
            if sub is None and method in ("GET", "PATCH", "DELETE"):
                return f"pods.{method.lower()}", (ns, name)
        raise _Reply(404, f"{method} {path}: no such route")

    def do_GET(self) -> None:  # noqa: N802 (http.server's names)
        self._dispatch("GET")

    def do_PATCH(self) -> None:  # noqa: N802
        self._dispatch("PATCH")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self) -> None:  # noqa: N802
        self._dispatch("DELETE")

    def log_message(self, format: str, *args: Any) -> None:
        pass

    # -- lists ------------------------------------------------------------
    def _page(self, kind: str, query: dict, snapshot) -> None:
        """One page of a list: the first request snapshots the whole list
        (``snapshot()`` -> (items, resourceVersion)); ``continue`` names
        the snapshot and the offset of the next page."""
        kube = self.server.kube
        limit = int(query.get("limit") or 0)
        cont = query.get("continue")
        if cont:
            try:
                sid, offset = cont.rsplit(":", 1)
                items, rv = kube.snapshot(sid)
                offset = int(offset)
            except (KeyError, ValueError):
                raise _Reply(410, f"continue token {cont!r} expired") from None
        else:
            items, rv = snapshot()
            # a copy now (the C encoder runs under the GIL, so the copy is
            # atomic with respect to the store's mutations)
            items = json.loads(json.dumps(items))
            sid, offset = kube.remember(items, rv), 0
        end = offset + limit if limit > 0 else len(items)
        meta = {"resourceVersion": rv}
        if end < len(items):
            meta["continue"] = f"{sid}:{end}"
        else:
            kube.forget(sid)
        self._send(200, {"kind": f"{kind}List", "apiVersion": "v1",
                         "metadata": meta, "items": items[offset:end]})

    def _nodes_list(self, query: dict) -> None:
        self._page("Node", query, self.server.kube.store.list_nodes_with_rv)

    def _pods_list(self, query: dict) -> None:
        store = self.server.kube.store
        node = _node_selector(query)
        self._page("Pod", query, lambda: store.list_pods_with_rv(node))

    # -- watches ------------------------------------------------------------
    def _stream(self, open_watch, query: dict) -> None:
        kube = self.server.kube
        box: list = []
        gen = open_watch(timeout_seconds=int(query.get("timeoutSeconds") or 300),
                         handle_box=box,
                         resource_version=query.get("resourceVersion") or None)
        kube.watching(box, True)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self.wfile.flush()
            for etype, obj in gen:
                line = json.dumps({"type": etype, "object": obj}).encode() + b"\n"
                self.wfile.write(f"{len(line):x}\r\n".encode() + line + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            pass  # the client hung up
        finally:
            gen.close()
            kube.watching(box, False)
        self.close_connection = True

    def _nodes_watch(self, query: dict) -> None:
        store = self.server.kube.store
        self._stream(lambda **kw: store.watch_nodes(None, **kw), query)

    def _pods_watch(self, query: dict) -> None:
        store = self.server.kube.store
        node = _node_selector(query)
        self._stream(lambda **kw: store.watch_pods(node, **kw), query)

    # -- objects ------------------------------------------------------------
    def _nodes_get(self, name: str, query: dict) -> None:
        store = self.server.kube.store
        if name not in store.node_names():
            raise _Reply(404, f'nodes "{name}" not found')
        self._send(200, {"metadata": {
            "name": name, "annotations": store.get_node_annotations(name)}})

    def _nodes_patch(self, name: str, query: dict) -> None:
        store = self.server.kube.store
        annotations = (self._body().get("metadata") or {}).get("annotations") or {}
        store.patch_node_annotations(name, dict(annotations))
        self._nodes_get(name, query)

    def _pod_or_404(self, ns: str, name: str) -> dict:
        pod = self.server.kube.store.get_pod(ns, name)
        if pod is None:
            raise _Reply(404, f'pods "{name}" not found')
        return pod

    def _pods_get(self, ns: str, name: str, query: dict) -> None:
        self._send(200, self._pod_or_404(ns, name))

    def _pods_patch(self, ns: str, name: str, query: dict) -> None:
        store = self.server.kube.store
        annotations = (self._body().get("metadata") or {}).get("annotations") or {}
        self._pod_or_404(ns, name)
        store.patch_pod_annotations(ns, name, dict(annotations))
        self._pods_get(ns, name, query)

    def _pods_delete(self, ns: str, name: str, query: dict) -> None:
        pod = self._pod_or_404(ns, name)
        self.server.kube.store.delete_pod(ns, name)
        self._send(200, pod)

    def _pods_binding(self, ns: str, name: str, query: dict) -> None:
        target = (self._body().get("target") or {}).get("name")
        if not target:
            raise _Reply(400, "Binding without target.name")
        self.server.kube.store.bind_pod(ns, name, target)
        self._send(201, {"kind": "Status", "apiVersion": "v1",
                         "status": "Success", "code": 201})

    def _pods_eviction(self, ns: str, name: str, query: dict) -> None:
        body = self._body()
        dry_run = "All" in ((body.get("deleteOptions") or {}).get("dryRun") or [])
        self._pod_or_404(ns, name)
        if not self.server.kube.store.evict_pod(ns, name, dry_run=dry_run):
            raise _Reply(429, "Cannot evict pod as it would violate the "
                              "pod's disruption budget.")
        self._send(201, {"kind": "Status", "apiVersion": "v1",
                         "status": "Success", "code": 201})


def _node_selector(query: dict) -> Optional[str]:
    sel = query.get("fieldSelector")
    if not sel:
        return None
    key, _, value = sel.partition("=")
    if key != "spec.nodeName":
        raise _Reply(400, f"unsupported field selector {sel!r}")
    return value


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    kube: "KubeRestServer"


class KubeRestServer:
    """A ``FakeApiServer`` (``store``, a fresh one by default) served over
    the REST subset above on ``host:port`` (0 = a free port) from a
    daemon thread; ``base_url`` names it. ``requests`` counts requests by
    route. Use as a context manager, or ``start()``/``stop()``."""

    def __init__(self, store: Optional[FakeApiServer] = None,
                 token: Optional[str] = None, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.store = store if store is not None else FakeApiServer()
        self.token = token
        self.requests: Counter = Counter()
        self._lock = threading.Lock()
        self._snapshots: dict[str, tuple[list, str]] = {}
        self._ids = itertools.count(1)
        self._streams: list[list] = []
        self._httpd = _Server((host, port), _Handler)
        self._httpd.kube = self
        self._thread: Optional[threading.Thread] = None

    @property
    def base_url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def count(self, route: str) -> None:
        with self._lock:
            self.requests[route] += 1

    def remember(self, items: list, rv: str) -> str:
        with self._lock:
            sid = f"s{next(self._ids)}"
            self._snapshots[sid] = (items, rv)
            return sid

    def snapshot(self, sid: str) -> tuple[list, str]:
        with self._lock:
            return self._snapshots[sid]

    def forget(self, sid: str) -> None:
        with self._lock:
            self._snapshots.pop(sid, None)

    def watching(self, box: list, live: bool) -> None:
        with self._lock:
            if live:
                self._streams.append(box)
            elif box in self._streams:
                self._streams.remove(box)

    def start(self) -> "KubeRestServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, args=(0.05,), daemon=True,
                name="tpukube-kube-rest")
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving: every open watch stream ends, then the socket
        closes."""
        with self._lock:
            streams = list(self._streams)
        for box in streams:
            for handle in box:
                handle.close()
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "KubeRestServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
