"""Apiserver channel — node annotations up, pod alloc intents down, and
the loops that act on the extender's decisions. The port's own copy of
``tpukube/apiserver.py``.

The node agent writes its NodeInfo into a Node annotation through the
Kubernetes apiserver, and the extender's alloc results ride Pod
annotations back to the node. The channel is a small interface with two
implementations:

  * :class:`FakeApiServer` — in-memory, thread-safe Node/Pod store with
    the Binding and Eviction subresources' semantics and the informer
    contract (list with a resourceVersion, then a watch that replays the
    gap), for pods and for nodes.
  * :class:`RestApiServer` — the same surface over the Kubernetes REST API
    with the standard library only (urllib, ssl): bearer token, cluster
    CA, JSON merge-patches, ``limit``/``continue`` pagination, the
    ``spec.nodeName`` field selector, chunked watch streams, the Binding
    and policy/v1 Eviction subresources, and optionally the unified
    ``Retrier``/``CircuitBreaker`` (core/retry.py), which
    :func:`rest_apiserver_from_config` builds from the config's knobs.
    ``tpukube_torch.sim.kube_rest`` serves a ``FakeApiServer`` over this
    subset for tests and the card's smoke run.

On top of it sit the loops:

  * :class:`NodeAnnotationSyncer` — PATCHes the node agent's annotation
    file onto its Node whenever the content changes.
  * :class:`NodeTopologyRefreshLoop` — a nodeCacheCapable extender learns
    (and re-learns) node topology from the Node objects, as recorded
    ``upsert_node`` decisions.
  * :func:`pod_binder` — the extender's bind effector: the alloc
    annotation PATCH, then the Binding POST.
  * :class:`AllocIntentWatcher` — feeds bound pods' planned alloc
    annotations to the device plugin, so ``GetPreferredAllocation`` steers
    the kubelet onto the chips the extender planned; when the kubelet
    allocates something else anyway, :func:`alloc_divergence_reporter`
    writes the ACTUAL ids back onto the pod, and
    :class:`AllocReconcileLoop` folds them into the extender's ledger.
  * :class:`PodLifecycleReleaseLoop` — turns a pod's end (DELETED, or a
    terminal phase) into the extender's recorded ``release`` decision.
  * :class:`EvictionExecutor` — drains ``extender.pending_evictions``
    through ``evict_pod`` and sends ``victim_gone`` once a victim's pod
    object is gone.
  * :class:`PodInformer` — one shared pod list+watch fanned out to the
    extender's pod loops.
  * :class:`PodAdmissionFeed` — admits informer-delivered pending pods
    into the batch cycle's scheduling queue (``Extender.admit``).
  * :func:`rebuild_extender` — a restarted extender's ledger and gangs
    from the apiserver's live, bound pods.

Not ported (ROADMAP.md): the incremental resync of the lifecycle loop
(the alloc change log: every resync here reads the full ledger) and its
batched releases.
"""

from __future__ import annotations

import json
import logging
import os
import copy
import queue
from collections import deque
import socket
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable, Optional

from tpukube_torch.core import codec, retry

log = logging.getLogger("tpukube_torch.apiserver")

# The node agent's report of what the kubelet ACTUALLY allocated, when it
# diverged from the planned ``tpu.qiniu.com/alloc`` annotation. Cleared by
# the extender's reconcile loop once folded into the ledger.
ANNO_ALLOC_ACTUAL = codec.ANNO_PREFIX + "alloc-actual"

# In-cluster serviceaccount defaults (mounted into every pod by kubelet).
SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ApiServerError(RuntimeError):
    """Apiserver request failure; ``code`` carries the HTTP status when the
    server answered (None for transport errors), so callers can branch on
    429 (PDB-blocked eviction) / 404 (already gone)."""

    def __init__(self, message: str, code: Optional[int] = None) -> None:
        super().__init__(message)
        self.code = code


def transient_api_error(exc: BaseException) -> bool:
    """The retry classifier every apiserver seam shares: transport
    errors (no HTTP code) and 5xx are transient; everything else —
    404, 409, 410, 429 — is a real answer the caller must handle, and
    retrying it would only mask the logic error."""
    if isinstance(exc, ApiServerError):
        return exc.code is None or exc.code >= 500
    return isinstance(exc, (OSError, ConnectionError))


def encode_alloc_actual(device_ids: list[str]) -> str:
    return json.dumps({"v": 1, "devices": sorted(device_ids)},
                      separators=(",", ":"))


def decode_alloc_actual(payload: str) -> list[str]:
    try:
        obj = json.loads(payload)
        if obj.get("v") != 1:
            raise ValueError(f"unsupported version {obj.get('v')!r}")
        return [str(d) for d in obj["devices"]]
    except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
        raise codec.CodecError(f"alloc-actual: {e}") from e


class FakeApiServer:
    """In-memory apiserver: Node/Pod metadata only, which is all this
    framework reads or writes. Thread-safe; the sim's source of truth."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: dict[str, dict[str, str]] = {}
        self._pods: dict[str, dict[str, Any]] = {}
        self.patch_log: list[tuple[str, str]] = []  # (kind, name) for tests
        # pod keys whose eviction a PodDisruptionBudget would deny (the
        # fake's stand-in for the real apiserver's 429): tests add keys
        # here to exercise the executor's requeue path
        self.pdb_blocked: set[str] = set()
        # pod keys that terminate GRACEFULLY on eviction: the accepted
        # eviction stamps deletionTimestamp and the object lingers until
        # finish_termination() — the real apiserver's behavior, and the
        # window the gang bind termination gate exists for
        self.graceful: set[str] = set()
        # live watch subscriptions (watch_pods): each holds an event queue
        self._watch_queues: list = []
        # the informer contract's versioning half: every pod mutation bumps
        # the resourceVersion and lands in a bounded history, so a watch
        # started FROM a list's version replays the events that raced into
        # the list->watch gap instead of silently dropping them (exactly
        # what the REST path's resourceVersion parameter does)
        self._rv = 0
        self._history: deque = deque(maxlen=4096)
        # node-watch half (NodeTopologyRefreshLoop's informer), same
        # versioning contract as pods but its own stream
        self._node_rv = 0
        self._node_history: deque = deque(maxlen=4096)
        self._node_watch_queues: list = []

    def _notify_node(self, etype: str, name: str) -> None:
        """Fan a Node event out to node watchers (under self._lock)."""
        self._node_rv += 1
        obj = {"metadata": {"name": name,
                            "annotations": dict(self._nodes.get(name, {}))}}
        self._node_history.append((self._node_rv, etype, obj))
        for q in self._node_watch_queues:
            q.put((etype, copy.deepcopy(obj)))

    def _notify(self, etype: str, pod: dict[str, Any]) -> None:
        """Fan a pod event out to live watchers (call under self._lock).
        Each watcher gets its OWN copy (a consumer mutating its event
        must not corrupt siblings or the replay history)."""
        self._rv += 1
        snap = copy.deepcopy(pod)
        self._history.append((self._rv, etype, snap))
        for q in self._watch_queues:
            q.put((etype, copy.deepcopy(snap)))

    # -- nodes -------------------------------------------------------------
    def patch_node_annotations(
        self, name: str, annotations: dict[str, str]
    ) -> None:
        with self._lock:
            etype = "MODIFIED" if name in self._nodes else "ADDED"
            self._nodes.setdefault(name, {}).update(annotations)
            self.patch_log.append(("node", name))
            self._notify_node(etype, name)

    def get_node_annotations(self, name: str) -> dict[str, str]:
        with self._lock:
            return dict(self._nodes.get(name, {}))

    def node_names(self) -> list[str]:
        with self._lock:
            return sorted(self._nodes)

    def list_nodes(self) -> list[dict[str, Any]]:
        return self.node_objects()

    def node_objects(self) -> list[dict[str, Any]]:
        """Node list in the webhook wire shape (the sim's kube-scheduler
        builds ExtenderArgs from this)."""
        with self._lock:
            return [
                {"metadata": {"name": n, "annotations": dict(a)}}
                for n, a in sorted(self._nodes.items())
            ]

    # -- pods --------------------------------------------------------------
    def upsert_pod(self, pod: dict[str, Any]) -> None:
        meta = pod["metadata"]
        key = f"{meta.get('namespace', 'default')}/{meta['name']}"
        with self._lock:
            etype = "MODIFIED" if key in self._pods else "ADDED"
            self._pods[key] = pod
            self._notify(etype, pod)

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            pod = self._pods.pop(f"{namespace}/{name}", None)
            if pod is not None:
                self._notify("DELETED", pod)

    def evict_pod(
        self, namespace: str, name: str, dry_run: bool = False
    ) -> bool:
        """Eviction-subresource semantics: True once the eviction is
        accepted (or the pod is already gone), False when a
        PodDisruptionBudget blocks it — the same contract RestApiServer
        derives from 2xx/404 vs 429. ``dry_run`` only answers the PDB
        question (the real API's dryRun=All). Keys in ``graceful`` get a
        deletionTimestamp and linger until finish_termination(); others
        delete instantly (grace 0)."""
        key = f"{namespace}/{name}"
        with self._lock:
            if key in self.pdb_blocked:
                return False
            if dry_run:
                return True
            if key in self.graceful:
                pod = self._pods.get(key)
                if pod is not None:
                    pod["metadata"].setdefault(
                        "deletionTimestamp", "2026-01-01T00:00:00Z"
                    )
                    self._notify("MODIFIED", pod)
            else:
                pod = self._pods.pop(key, None)
                if pod is not None:
                    self._notify("DELETED", pod)
            self.patch_log.append(("evict", key))
        return True

    def finish_termination(self, namespace: str, name: str) -> None:
        """A graceful pod's containers finally stopped: the object goes
        away (kubelet finishing the eviction the subresource started)."""
        with self._lock:
            pod = self._pods.pop(f"{namespace}/{name}", None)
            if pod is not None:
                self._notify("DELETED", pod)

    def get_pod(self, namespace: str, name: str) -> Optional[dict[str, Any]]:
        with self._lock:
            return self._pods.get(f"{namespace}/{name}")

    def watch_pods(self, node_name: Optional[str] = None,
                   timeout_seconds: int = 300,
                   handle_box: Optional[list] = None,
                   resource_version: Optional[str] = None):
        """The fake's watch half of the informer contract: yields
        (event_type, pod) for every mutation after ``resource_version``
        (a list_pods_with_rv result — events that raced into the
        list->watch gap are REPLAYED from the bounded history, exactly
        like the REST path's resourceVersion parameter) or, without a
        version, after this call. Subscription and replay snapshot happen
        atomically under the store lock — not at the generator's first
        next() — so no event can slip between them. Honors the
        spec.nodeName field selector. The handle placed in ``handle_box``
        exposes close() (enqueues a poison pill), so a loop's stop()
        unblocks a quiet watch exactly as it does the REST stream."""
        def pod_filter(pod: dict[str, Any]) -> bool:
            if node_name is None:
                return True
            return (pod.get("spec") or {}).get("nodeName") == node_name

        return self._subscribe_watch(
            self._watch_queues, self._history, resource_version,
            handle_box, timeout_seconds, pod_filter,
        )

    def _subscribe_watch(self, queues: list, history: deque,
                         resource_version: Optional[str],
                         handle_box: Optional[list],
                         timeout_seconds: int, keep) -> Any:
        """Shared machinery of the pod and node watch halves: atomic
        replay-from-history + subscription under the store lock, a
        close() handle (poison pill), the server-timeout deadline, and
        unsubscription when the generator ends."""
        q: queue.SimpleQueue = queue.SimpleQueue()

        class _Handle:
            def close(self) -> None:
                q.put(None)

        try:
            since = int(resource_version) if resource_version else None
        except ValueError:
            since = None
        with self._lock:
            if since is not None:
                if history and history[0][0] > since + 1:
                    # events between `since` and the oldest retained entry
                    # were evicted from the bounded history: replaying
                    # would silently skip them. The real apiserver answers
                    # 410 Gone; the informer's reconnect then resyncs with
                    # a fresh list — same contract here.
                    raise ApiServerError(
                        f"resourceVersion {since} too old "
                        f"(history starts at {history[0][0]})", code=410,
                    )
                for rv, etype, obj in history:
                    if rv > since:
                        q.put((etype, copy.deepcopy(obj)))
            queues.append(q)
        if handle_box is not None:
            handle_box.append(_Handle())

        def _events():
            try:
                deadline = time.monotonic() + timeout_seconds
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return  # server timeout; caller reconnects
                    try:
                        ev = q.get(timeout=remaining)
                    except queue.Empty:
                        return
                    if ev is None:
                        return  # closed via the handle
                    etype, obj = ev
                    if keep(obj):
                        yield etype, obj
            finally:
                with self._lock:
                    if q in queues:
                        queues.remove(q)

        return _events()

    def bind_pod(
        self, namespace: str, name: str, node: str,
        annotations: Optional[dict[str, str]] = None,
    ) -> None:
        """The Binding-subresource equivalent: conflict check FIRST (a pod
        bound elsewhere must not be touched at all — not even its
        annotations), then annotations (the pod is still Pending —
        retry-safe), then nodeName; 404s like the real apiserver. Already
        bound to the SAME node = idempotent-retry success (mirroring
        RestApiServer.bind_pod)."""
        key = f"{namespace}/{name}"
        with self._lock:
            pod = self._pods.get(key)
            if pod is None:
                raise ApiServerError(f"pod {key} not found", code=404)
            spec = pod.setdefault("spec", {})
            bound_to = spec.get("nodeName")
            if bound_to and bound_to != node:
                raise ApiServerError(
                    f"pod {key} is already bound to {bound_to!r}, "
                    f"not {node!r}", code=409,
                )
            if annotations:
                pod["metadata"].setdefault("annotations", {}).update(
                    annotations
                )
            spec["nodeName"] = node
            self.patch_log.append(("bind", key))
            self._notify("MODIFIED", pod)

    def patch_pod_annotations(
        self, namespace: str, name: str, annotations: dict[str, Optional[str]]
    ) -> None:
        """Merge-patch semantics: a None value deletes the key (exactly how
        a JSON merge-patch null behaves on the real apiserver)."""
        key = f"{namespace}/{name}"
        with self._lock:
            pod = self._pods.get(key)
            if pod is None:
                raise ApiServerError(f"pod {key} not found")
            annos = pod["metadata"].setdefault("annotations", {})
            for k, v in annotations.items():
                if v is None:
                    annos.pop(k, None)
                else:
                    annos[k] = v
            self.patch_log.append(("pod", key))
            self._notify("MODIFIED", pod)

    def list_pods(self, node_name: Optional[str] = None) -> list[dict[str, Any]]:
        with self._lock:
            out = []
            for pod in self._pods.values():
                if (node_name is None
                        or pod.get("spec", {}).get("nodeName") == node_name):
                    out.append(pod)
            return out

    def list_pods_with_rv(
        self, node_name: Optional[str] = None
    ) -> tuple[list[dict[str, Any]], str]:
        """(pods, resourceVersion) — list half of the informer contract
        (mirrors RestApiServer): watch from the returned version and no
        event between the list and the watch is lost."""
        with self._lock:
            out = [
                pod for pod in self._pods.values()
                if (node_name is None
                    or pod.get("spec", {}).get("nodeName") == node_name)
            ]
            return out, str(self._rv)

    def list_nodes_with_rv(self) -> tuple[list[dict[str, Any]], str]:
        """(nodes, resourceVersion) — the node informer's list half."""
        with self._lock:
            out = [
                {"metadata": {"name": n, "annotations": dict(a)}}
                for n, a in sorted(self._nodes.items())
            ]
            return out, str(self._node_rv)

    def watch_nodes(self, node_name: Optional[str] = None,
                    timeout_seconds: int = 300,
                    handle_box: Optional[list] = None,
                    resource_version: Optional[str] = None):
        """Node-object watch, same informer contract as watch_pods
        (``node_name`` accepted for signature symmetry; Node watches have
        no field selector)."""
        return self._subscribe_watch(
            self._node_watch_queues, self._node_history, resource_version,
            handle_box, timeout_seconds, lambda obj: True,
        )


class RestApiServer:
    """The same surface over the Kubernetes REST API, with no client
    library: merge-patches and field-selector GETs via urllib, the
    in-cluster serviceaccount token, and the cluster CA.

    Built for the DaemonSet sidecar (NodeAnnotationSyncer) and the node
    agent (AllocIntentWatcher); held in tests and the card's smoke run
    against ``tpukube_torch.sim.kube_rest``, a local HTTP stand-in.
    """

    def __init__(
        self,
        base_url: Optional[str] = None,
        token: Optional[str] = None,
        token_path: Optional[str] = None,
        ca_path: Optional[str] = None,
        timeout: float = 10.0,
        retrier: Optional[retry.Retrier] = None,
        circuit: Optional[retry.CircuitBreaker] = None,
    ) -> None:
        """``retrier``/``circuit`` route every unary request through
        the unified policy (core/retry.py): transient failures
        (transport errors, 5xx) retry with jittered backoff and feed
        the breaker; while the breaker is open, requests fail fast as
        ApiServerError instead of stacking timeouts. Both default None
        — the legacy single-attempt behavior. Watch STREAMS are not
        retried here; the informer loops own reconnects (with their
        own capped backoff)."""
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise ApiServerError(
                    "no apiserver URL: pass base_url or run in-cluster"
                )
            base_url = f"https://{host}:{port}"
        self._base = base_url.rstrip("/")
        if token is None:
            path = token_path or os.path.join(SA_DIR, "token")
            if os.path.exists(path):
                with open(path) as f:
                    token = f.read().strip()
        self._token = token
        self._timeout = timeout
        if ca_path is None:
            default_ca = os.path.join(SA_DIR, "ca.crt")
            ca_path = default_ca if os.path.exists(default_ca) else None
        if self._base.startswith("https"):
            self._ssl: Optional[ssl.SSLContext] = ssl.create_default_context(
                cafile=ca_path
            )
        else:
            self._ssl = None
        self.retrier = retrier
        self.circuit = circuit
        if retrier is not None and retrier.policy.attempt_timeout > 0:
            # the policy's per-attempt deadline caps the transport
            # timeout — a retried request must not spend its whole
            # overall deadline waiting out one hung attempt
            self._timeout = min(self._timeout,
                                retrier.policy.attempt_timeout)

    def _authed_request(
        self, method: str, path: str, data: Optional[bytes] = None,
        content_type: Optional[str] = None,
    ) -> urllib.request.Request:
        """One place for bearer auth + headers — the long-lived watch
        path and the unary path must never drift apart."""
        headers = {"Accept": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        if content_type is not None:
            headers["Content-Type"] = content_type
        return urllib.request.Request(
            self._base + path, data=data, headers=headers, method=method
        )

    def _request_once(
        self, method: str, path: str, body: Optional[dict] = None,
        content_type: str = "application/merge-patch+json",
    ) -> Any:
        data = ctype = None
        if body is not None:
            data = json.dumps(body).encode()
            ctype = content_type
        req = self._authed_request(method, path, data=data,
                                   content_type=ctype)
        try:
            with urllib.request.urlopen(
                req, timeout=self._timeout, context=self._ssl
            ) as r:
                payload = r.read()
        except urllib.error.HTTPError as e:
            raise ApiServerError(
                f"{method} {path}: HTTP {e.code} {e.read()[:200]!r}",
                code=e.code,
            ) from e
        except urllib.error.URLError as e:
            raise ApiServerError(f"{method} {path}: {e.reason}") from e
        return json.loads(payload) if payload else None

    def _request(
        self, method: str, path: str, body: Optional[dict] = None,
        content_type: str = "application/merge-patch+json",
    ) -> Any:
        """One unary request through the unified retry/circuit layer
        (when wired): each attempt consults the breaker, transient
        outcomes feed it, and an open circuit fails fast. Retrying a
        lost-response write is safe by the surface's own contract —
        merge-patches re-apply, bind_pod treats already-bound-to-us as
        success, evict_pod treats 404 as done."""
        if self.retrier is None and self.circuit is None:
            return self._request_once(method, path, body, content_type)

        def attempt() -> Any:
            if self.circuit is not None:
                self.circuit.before_call()  # CircuitOpenError when open
            try:
                out = self._request_once(method, path, body, content_type)
            except retry.CircuitOpenError:
                raise
            except Exception as e:
                if self.circuit is not None:
                    if transient_api_error(e):
                        self.circuit.on_failure()
                    else:
                        # the server ANSWERED (404/409/429/...): the
                        # channel is healthy, only the request lost
                        self.circuit.on_success()
                raise
            except BaseException:
                # interrupted, not answered: release any half-open
                # probe slot so the breaker cannot wedge half-open
                if self.circuit is not None:
                    self.circuit.abort_probe()
                raise
            if self.circuit is not None:
                self.circuit.on_success()
            return out

        try:
            if self.retrier is not None:
                return self.retrier.call(attempt)
            return attempt()
        except retry.CircuitOpenError as e:
            # preserve the surface's error contract: callers catch
            # ApiServerError; a fast-failed request is a transport-
            # level failure with no HTTP code
            raise ApiServerError(f"{method} {path}: {e}") from e

    # -- interface ---------------------------------------------------------
    def patch_node_annotations(
        self, name: str, annotations: dict[str, str]
    ) -> None:
        self._request(
            "PATCH", f"/api/v1/nodes/{name}",
            {"metadata": {"annotations": annotations}},
        )

    def get_node_annotations(self, name: str) -> dict[str, str]:
        obj = self._request("GET", f"/api/v1/nodes/{name}")
        return dict(obj.get("metadata", {}).get("annotations", {}) or {})

    def patch_pod_annotations(
        self, namespace: str, name: str, annotations: dict[str, Optional[str]]
    ) -> None:
        self._request(
            "PATCH", f"/api/v1/namespaces/{namespace}/pods/{name}",
            {"metadata": {"annotations": annotations}},
        )

    # chunked LISTs: big enough that small clusters stay one request,
    # small enough that a thousand-node cluster's poll never materializes
    # thousands of objects in one apiserver response
    LIST_PAGE_LIMIT = 500

    def _list_paginated(
        self, base: str
    ) -> tuple[list[dict[str, Any]], str]:
        """Follow the apiserver's limit/continue protocol; returns the
        concatenation of all pages plus the list's resourceVersion (the
        consistent point a watch should start from). ``base`` already
        carries its query string (limit, selectors)."""
        items: list[dict[str, Any]] = []
        cont = rv = ""
        while True:
            path = base + (f"&continue={urllib.parse.quote(cont)}" if cont
                           else "")
            obj = self._request("GET", path)
            items.extend(obj.get("items", []) or [])
            meta = obj.get("metadata") or {}
            rv = meta.get("resourceVersion") or rv
            cont = meta.get("continue") or ""
            if not cont:
                return items, rv

    def _pods_base(self, node_name: Optional[str]) -> str:
        base = f"/api/v1/pods?limit={self.LIST_PAGE_LIMIT}"
        if node_name is not None:
            base += f"&fieldSelector=spec.nodeName%3D{node_name}"
        return base

    def list_pods(self, node_name: Optional[str] = None) -> list[dict[str, Any]]:
        """Pod list, paginated so reconcile-loop polls on large clusters
        ask for bounded chunks instead of one giant LIST."""
        return self._list_paginated(self._pods_base(node_name))[0]

    def list_pods_with_rv(
        self, node_name: Optional[str] = None
    ) -> tuple[list[dict[str, Any]], str]:
        """(pods, resourceVersion) — the informer contract's list half:
        watch from the returned version and no event between the list
        and the watch is lost."""
        return self._list_paginated(self._pods_base(node_name))

    def list_nodes(self) -> list[dict[str, Any]]:
        """Node list, paginated like list_pods (startup rebuild reads
        every node's topology annotation)."""
        return self._list_paginated(
            f"/api/v1/nodes?limit={self.LIST_PAGE_LIMIT}"
        )[0]

    def list_nodes_with_rv(self) -> tuple[list[dict[str, Any]], str]:
        """(nodes, resourceVersion) — the node informer's list half."""
        return self._list_paginated(
            f"/api/v1/nodes?limit={self.LIST_PAGE_LIMIT}"
        )

    def watch_nodes(self, node_name: Optional[str] = None,
                    timeout_seconds: int = 300,
                    handle_box: Optional[list] = None,
                    resource_version: Optional[str] = None):
        """Node-object watch stream (NodeTopologyRefreshLoop's informer
        transport): a health re-annotation reaches a nodeCacheCapable
        extender within milliseconds instead of a poll interval — the
        §4.4 fault path's end-to-end latency. ``node_name`` accepted for
        signature symmetry with watch_pods; Node watches have no field
        selector."""
        path = f"/api/v1/nodes?watch=1&timeoutSeconds={timeout_seconds}"
        yield from self._watch_stream(
            "nodes", path, timeout_seconds, handle_box, resource_version
        )

    def watch_pods(self, node_name: Optional[str] = None,
                   timeout_seconds: int = 300,
                   handle_box: Optional[list] = None,
                   resource_version: Optional[str] = None):
        """One watch request (the informer pattern's transport): yields
        (event_type, pod) as the apiserver streams them, ending when the
        server closes the stream at ``timeoutSeconds`` — callers loop to
        reconnect, resyncing with list_pods in between. This is what
        makes intent steering real on a live cluster: a 5s LIST poll
        loses the race against the kubelet's Allocate; a watch delivers
        the bound pod's alloc annotation within milliseconds."""
        path = f"/api/v1/pods?watch=1&timeoutSeconds={timeout_seconds}"
        if node_name is not None:
            path += f"&fieldSelector=spec.nodeName%3D{node_name}"
        yield from self._watch_stream(
            "pods", path, timeout_seconds, handle_box, resource_version
        )

    def _watch_stream(self, what: str, path: str, timeout_seconds: int,
                      handle_box: Optional[list],
                      resource_version: Optional[str]):
        """Shared transport of the pod and node watches: one chunked GET,
        one {"type","object"} event per line, ending when the server
        closes at timeoutSeconds."""
        if resource_version:
            # the informer contract: watching FROM the list's version
            # closes the list->watch gap (without it, a watch starts at
            # "most recent" and events in the gap are silently lost); a
            # too-old version gets HTTP 410, which the caller's reconnect
            # resolves with a fresh list
            path += (
                f"&resourceVersion={urllib.parse.quote(resource_version)}"
            )
        req = self._authed_request("GET", path)
        try:
            with urllib.request.urlopen(
                req, timeout=timeout_seconds + 30, context=self._ssl
            ) as r:
                if handle_box is not None:
                    # the caller's stop() closes this to interrupt a
                    # blocked read (the stream is otherwise uninterruptible
                    # for up to the socket timeout)
                    handle_box.append(r)
                for line in r:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError as e:
                        log.warning("watch %s: unparsable event line: %s",
                                    what, e)
                        continue
                    yield str(ev.get("type", "")), dict(ev.get("object") or {})
        except urllib.error.HTTPError as e:
            raise ApiServerError(
                f"watch {what}: HTTP {e.code}", code=e.code
            ) from e
        except urllib.error.URLError as e:
            raise ApiServerError(f"watch {what}: {e.reason}") from e

    def get_pod(self, namespace: str, name: str) -> Optional[dict[str, Any]]:
        """One pod object, or None when it does not exist (404)."""
        try:
            return self._request(
                "GET", f"/api/v1/namespaces/{namespace}/pods/{name}"
            )
        except ApiServerError as e:
            if e.code == 404:
                return None
            raise

    def delete_pod(self, namespace: str, name: str) -> None:
        """Hard delete (no PDB check). The eviction executor uses
        :meth:`evict_pod`; this exists for operator tooling parity with
        FakeApiServer."""
        try:
            self._request(
                "DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}"
            )
        except ApiServerError as e:
            if e.code != 404:  # already gone is success
                raise

    def bind_pod(
        self, namespace: str, name: str, node: str,
        annotations: Optional[dict[str, str]] = None,
    ) -> None:
        """POST the Binding subresource (what kube-scheduler does for
        non-extender pods). With bindVerb delegated to the extender, THIS
        is what actually starts the pod on its node.

        Ordering is load-bearing: the alloc annotation is PATCHed FIRST,
        while the pod is still Pending — so the node agent's intent
        watcher can see the plan before the kubelet's Allocate, and a
        partial failure always leaves the pod unbound (safe to retry).
        A 409 on the Binding POST means the pod is already bound; that is
        idempotent success ONLY if it is bound to the node we asked for
        (our earlier retry landed) — bound elsewhere is a real conflict
        (e.g. a re-planned bind after an extender restart) that must
        surface. The bound-elsewhere check runs BEFORE the annotation
        PATCH, so a conflicting pod running on another host is never
        touched at all — not even its annotations."""
        current = self.get_pod(namespace, name)
        bound_to = ((current or {}).get("spec") or {}).get("nodeName")
        if bound_to and bound_to != node:
            raise ApiServerError(
                f"pod {namespace}/{name} is already bound to "
                f"{bound_to!r}, not {node!r}", code=409,
            )
        if annotations:
            self.patch_pod_annotations(namespace, name, dict(annotations))
        body = {
            "apiVersion": "v1",
            "kind": "Binding",
            "metadata": {"name": name, "namespace": namespace},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node},
        }
        try:
            self._request(
                "POST",
                f"/api/v1/namespaces/{namespace}/pods/{name}/binding",
                body, content_type="application/json",
            )
        except ApiServerError as e:
            if e.code != 409:
                raise
            # a binding raced in between our check and POST: success only
            # if it targets our node
            pod = self.get_pod(namespace, name)
            bound_to = ((pod or {}).get("spec") or {}).get("nodeName")
            if bound_to != node:
                raise ApiServerError(
                    f"pod {namespace}/{name} is already bound to "
                    f"{bound_to!r}, not {node!r}", code=409,
                ) from e

    def evict_pod(
        self, namespace: str, name: str, dry_run: bool = False
    ) -> bool:
        """POST the policy/v1 Eviction subresource — the polite way to
        delete a preemption victim, because it lets the apiserver enforce
        PodDisruptionBudgets. Returns True once the eviction is accepted
        (2xx, or 404 = already deleted), False when a PDB blocks it right
        now (HTTP 429: retry later, exactly what the executor's requeue
        does). ``dry_run`` sends deleteOptions.dryRun=["All"] — the PDB
        answer without starting a termination (the extender's preemption
        precheck)."""
        body: dict[str, Any] = {
            "apiVersion": "policy/v1",
            "kind": "Eviction",
            "metadata": {"name": name, "namespace": namespace},
        }
        if dry_run:
            body["deleteOptions"] = {"dryRun": ["All"]}
        try:
            self._request(
                "POST",
                f"/api/v1/namespaces/{namespace}/pods/{name}/eviction",
                body, content_type="application/json",
            )
        except ApiServerError as e:
            if e.code == 429:
                return False
            if e.code == 404:
                return True
            raise
        return True


def rest_apiserver_from_config(
    cfg,
    base_url: Optional[str] = None,
    token: Optional[str] = None,
    token_path: Optional[str] = None,
    ca_path: Optional[str] = None,
    journal=None,
) -> RestApiServer:
    """A daemon's REST channel, built as the reference's CLI builds it
    (``tpukube/cli.py``, ``_make_apiserver``): every unary request runs
    under the config's retry policy (the ``retry_*`` knobs), retrying
    transient errors only, and behind a circuit breaker with the
    ``circuit_*`` knobs (off when ``circuit_failure_threshold`` is 0).
    Both ride on the returned server as ``api.retrier``/``api.circuit``;
    a daemon hands them to its extender (``api_retrier``/``api_circuit``)
    so ``/metrics`` exports ``tpukube_retry_*``/``tpukube_circuit_*``.
    ``journal`` (an EventJournal) receives their RetryExhausted,
    CircuitOpen and CircuitClosed events."""
    circuit = retry.CircuitBreaker(
        failure_threshold=cfg.circuit_failure_threshold,
        reset_seconds=cfg.circuit_reset_seconds,
        half_open_probes=cfg.circuit_half_open_probes,
        name="apiserver", journal=journal,
    )
    retrier = retry.Retrier(
        retry.policy_from_config(cfg), name="apiserver",
        retryable=transient_api_error, journal=journal,
    )
    return RestApiServer(base_url=base_url, token=token, token_path=token_path,
                         ca_path=ca_path, retrier=retrier, circuit=circuit)


class _PollLoop:
    """start/stop/check_once scaffolding shared by the sync loops (the same
    deterministic-step pattern as HealthWatcher/KubeletSessionWatcher)."""

    def __init__(self, poll_seconds: float, name: str) -> None:
        self._poll = poll_seconds
        self._name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> bool:  # pragma: no cover - overridden
        raise NotImplementedError

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError(f"{self._name} already started")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=self._name
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self.check_once()
            except Exception:
                log.exception("%s poll failed", self._name)


class NodeAnnotationSyncer(_PollLoop):
    """Applies the plugin's node-annotation file to the Node object.

    ``tpukube-plugin --annotation-out FILE`` writes the node-topology
    annotation JSON; this loop (the DaemonSet's sidecar, sharing the
    /var/run/tpukube mount) PATCHes it through the apiserver whenever the
    content changes — including health-fault re-annotations, which is how
    the extender learns about dead chips on a real cluster."""

    def __init__(
        self, api, node_name: str, path: str, poll_seconds: float = 5.0
    ) -> None:
        super().__init__(poll_seconds, "tpukube-annotation-sync")
        self._api = api
        self._node = node_name
        self._path = path
        self._last_applied: Optional[str] = None
        self.syncs = 0  # applied patches (tests/metrics)

    def check_once(self) -> bool:
        """One poll; True if a patch was applied."""
        try:
            with open(self._path) as f:
                raw = f.read().strip()
        except OSError:
            return False  # agent not up yet
        if not raw or raw == self._last_applied:
            return False
        try:
            annotations = json.loads(raw)
        except json.JSONDecodeError as e:
            log.warning("annotation file %s unparsable: %s", self._path, e)
            return False
        if not isinstance(annotations, dict):
            log.warning("annotation file %s: not a JSON object", self._path)
            return False
        self._api.patch_node_annotations(self._node, annotations)
        # commit only after the PATCH succeeded, so a failed apply retries
        self._last_applied = raw
        self.syncs += 1
        log.info("synced node annotation for %s (%d bytes)",
                 self._node, len(raw))
        return True


class _ResyncNeeded(Exception):
    """Raised by a _WatchLoop subclass's event/resync handler when it
    left work unfinished (e.g. a failed ack PATCH): the loop closes the
    stream, backs off one poll interval, and resyncs — restoring the
    poll mode's convergence bound instead of waiting out the watch
    stream's server timeout (~300s)."""


class _WatchLoop(_PollLoop):
    """Informer-pattern scaffolding shared by the watching loops:
    list-resync at every (re)connect, then a watch FROM the list's
    resourceVersion, with the poll loop as the no-watch fallback.
    Subclasses implement ``_resync()`` (full list reconciliation,
    returning ``(changed, resourceVersion)``) and
    ``_apply_watch_event(etype, obj)``; ``watch_method`` names the api's
    stream ("watch_pods" for the pod loops, "watch_nodes" for the node
    topology loop)."""

    def __init__(
        self, name: str, api, node_name: Optional[str],
        poll_seconds: float, use_watch: bool,
        watch_method: str = "watch_pods",
    ) -> None:
        super().__init__(poll_seconds, name)
        self._api = api
        self._node = node_name
        self._watch_method = watch_method
        self._use_watch = use_watch and hasattr(api, watch_method)
        self._box_supported = True  # False after a handle_box TypeError
        # Stream liveness, NOT thread liveness: a watch thread is alive
        # through reconnect backoff and list-resync windows where DELETED
        # events are silently missed. True only
        # between a successful (resync, stream open) and the stream's
        # end/failure; last_event_time (wall clock) stamps the stream
        # connect and every delivered event — exported on /statusz.
        self._stream_connected = False
        self.last_event_time: Optional[float] = None
        # optional EventJournal (obs/events.py), wired by the daemon
        # main: a WatchReconnected event per stream re-establishment —
        # frequent reconnects mean events are being missed in backoff
        # windows, the first thing to check when releases lag
        self.journal = None
        self._connects = 0
        self.reconnects = 0
        # reconnect pacing: one poll interval after the FIRST failure,
        # then jittered exponential growth up to 16x — a down apiserver
        # (or a 410-Gone storm) must not be hammered at a fixed cadence
        # by every informer in the fleet at once. Reset the moment a
        # stream actually (re)connects.
        self._reconnect_backoff = retry.Backoff(
            base=poll_seconds, cap=poll_seconds * 16, jitter=0.5,
        )

    def _resync(self) -> tuple[bool, Optional[str]]:  # pragma: no cover
        raise NotImplementedError

    def _apply_watch_event(
        self, etype: str, pod: dict[str, Any]
    ) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def check_once(self) -> bool:
        """One full resync; True if anything changed."""
        return self._resync()[0]

    def _needs_resync(self) -> bool:
        """Subclass hook, consulted after each watch-mode resync: True
        when the resync left work unfinished (retry after one poll
        interval instead of entering the watch)."""
        return False

    def stream_connected(self) -> bool:
        """True while the watch stream is actually open and delivering —
        NOT during reconnect backoff or a failed resync."""
        return self._stream_connected

    def watch_status(self) -> dict[str, Any]:
        """Liveness document for /statusz."""
        return {
            "name": self._name,
            "mode": "watch" if self._use_watch else "poll",
            "thread_alive": (self._thread is not None
                             and self._thread.is_alive()),
            "stream_connected": self._stream_connected,
            "last_event_ts": self.last_event_time,
            "reconnects": self.reconnects,
            # consecutive reconnect failures driving the current
            # backoff (0 while healthy): non-zero here plus a stale
            # last_event_ts is "the apiserver is down", not "quiet"
            "reconnect_failures": self._reconnect_backoff.failures,
        }

    def _list_pods_rv(
        self, node_name: Optional[str] = None
    ) -> tuple[list[dict[str, Any]], Optional[str]]:
        """The informer contract's list half, with the plain-list
        fallback for apis without resourceVersions (one definition for
        every pod loop — watching then starts at 'now', and the
        periodic resync covers the gap)."""
        if hasattr(self._api, "list_pods_with_rv"):
            return self._api.list_pods_with_rv(node_name)
        return self._api.list_pods(node_name), None

    def _run(self) -> None:
        if not self._use_watch:
            return super()._run()
        while not self._stop.is_set():
            box: list = []
            self._stream_box = box
            delay = self._poll
            stream_t0: Optional[float] = None
            try:
                # resync at every (re)connect, then watch FROM the list's
                # resourceVersion — no event in the list->watch gap is lost
                _, rv = self._resync()
                if self._needs_resync():
                    raise _ResyncNeeded
                watch = getattr(self._api, self._watch_method)
                try:
                    gen = watch(
                        self._node, handle_box=box, resource_version=rv
                    )
                except TypeError:  # test stubs without the full signature
                    self._box_supported = False
                    gen = watch(self._node)
                # connected from here until the stream ends or fails:
                # the resync landed and the watch is (about to be) open —
                # the REST transport dials on first iteration, which
                # happens immediately below. The reconnect backoff does
                # NOT reset here: the REST generator is lazy, so nothing
                # has actually dialed yet — a dial that fails every lap
                # must keep escalating. Reset happens on demonstrated
                # liveness: a delivered event, a clean stream end, or a
                # stream that survived at least one poll interval.
                self._stream_connected = True
                self.last_event_time = time.time()
                stream_t0 = time.monotonic()
                self._connects += 1
                if self._connects > 1:
                    self.reconnects += 1
                    if self.journal is not None:
                        try:
                            self.journal.emit(
                                "WatchReconnected",
                                obj=f"watch/{self._name}",
                                message=f"stream re-established "
                                        f"(reconnect #{self.reconnects}); "
                                        f"resync covered the gap",
                            )
                        except Exception:
                            log.exception("event emit failed: "
                                          "WatchReconnected")
                try:
                    for etype, pod in gen:
                        if self._stop.is_set():
                            return
                        self.last_event_time = time.time()
                        if self._reconnect_backoff.failures:
                            # the stream is demonstrably delivering
                            self._reconnect_backoff.reset()
                        self._apply_watch_event(etype, pod)
                finally:
                    self._stream_connected = False
                # clean end at the server timeout: the dial worked
                self._reconnect_backoff.reset()
            except _ResyncNeeded:
                # expected control flow, not a failure: back off one
                # poll and resync (bounded retry for unfinished work)
                log.info("%s: resync forced (pending retry)", self._name)
            except Exception:
                if self._stop.is_set():
                    return  # stop() closed the stream under us
                # consecutive failures (down apiserver, 410 storms)
                # escalate the reconnect delay instead of replaying a
                # fixed-cadence hammer; the list-resync at the next
                # (re)connect covers every event missed meanwhile
                if (stream_t0 is not None
                        and time.monotonic() - stream_t0 > self._poll):
                    # an idle-but-open stream that lived at least a poll
                    # interval before dying is a FRESH outage, not a
                    # continuation of a dial-failure streak
                    self._reconnect_backoff.reset()
                delay = self._reconnect_backoff.next()
                log.exception(
                    "%s watch failed (consecutive failure %d); "
                    "reconnecting in %.1fs", self._name,
                    self._reconnect_backoff.failures, delay,
                )
            self._stop.wait(delay)  # backoff, then reconnect

    def stop(self) -> None:
        self._stop.set()
        # a watch thread blocked mid-read can't see the stop event, and
        # close() alone does NOT wake a thread parked in recv() — only a
        # socket shutdown does; then close for good measure. The stream
        # handle lands in the box at the thread's FIRST read, so grace a
        # moment for a connection that is mid-handshake (otherwise the
        # shutdown below has nothing to act on and join stalls).
        deadline = time.monotonic() + 2.0
        while (self._use_watch and self._box_supported
               and not (getattr(self, "_stream_box", None))
               and self._thread is not None and self._thread.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.02)
        for r in getattr(self, "_stream_box", []) or []:
            try:
                sock = getattr(getattr(r, "fp", None), "raw", None)
                sock = getattr(sock, "_sock", None)
                if sock is not None:
                    sock.shutdown(socket.SHUT_RDWR)
            # tpukube: allow(exception-hygiene) best-effort unblock of the watch thread at stop(); the handle may already be half-closed by the peer
            except Exception:
                pass
            try:
                r.close()
            # tpukube: allow(exception-hygiene) second best-effort close on the same dying handle; nothing to surface at shutdown
            except Exception:
                pass
        super().stop()


class AllocIntentWatcher(_WatchLoop):
    """Feeds the extender's planned allocations to the device plugin.

    Watches pods bound to this node; every ``tpu.qiniu.com/alloc``
    annotation becomes an intent in the plugin's
    :class:`~tpukube_torch.plugin.server.AllocIntentCache`, which
    GetPreferredAllocation serves back to the kubelet — closing the loop
    KubeGPU closes with its annotation channel: the kubelet's id choice
    converges on the chips the gang's contiguity score was computed for."""

    def __init__(
        self, api, node_name: str, server, poll_seconds: float = 5.0,
        use_watch: bool = True,
    ) -> None:
        # watch mode (the informer pattern): intents land within ms of
        # the bind instead of a poll interval later — steering would
        # otherwise routinely lose the race against the kubelet's
        # Allocate on a real cluster. Both apiserver implementations
        # (REST and fake) speak the watch protocol; poll mode remains
        # for deterministic stepping (check_once) in tests/sim.
        super().__init__("tpukube-alloc-intents", api, node_name,
                         poll_seconds, use_watch)
        self._server = server
        self.watch_events = 0  # processed watch events (tests/metrics)

    @staticmethod
    def _intent_of(pod: dict[str, Any]):
        """(pod_key, device_ids) from a pod's alloc annotation, or None."""
        meta = pod.get("metadata", {})
        payload = (meta.get("annotations") or {}).get(codec.ANNO_ALLOC)
        if not payload:
            return None
        try:
            alloc = codec.decode_alloc(payload)
        except codec.CodecError as e:
            log.warning("pod %s: bad alloc annotation: %s",
                        meta.get("name"), e)
            return None
        return alloc.pod_key, list(alloc.device_ids)

    def _resync(self) -> tuple[bool, Optional[str]]:
        """Full list resync; returns (changed, resourceVersion) — the
        version is the watch's safe starting point (None when the api
        doesn't expose it)."""
        pods, rv = self._list_pods_rv(self._node)
        intents: dict[str, list[str]] = {}
        for pod in pods:
            entry = self._intent_of(pod)
            if entry is not None:
                intents[entry[0]] = entry[1]
        return self._server.intents.sync(intents), rv

    def _apply_watch_event(self, etype: str, pod: dict[str, Any]) -> None:
        if etype == "DELETED":
            # the pod key needs no annotation decode (the final object's
            # annotation may be corrupt; the intent must still die NOW,
            # not at the next reconnect resync)
            meta = pod.get("metadata") or {}
            name = meta.get("name")
            if name:
                self.watch_events += 1
                self._server.intents.remove(
                    f"{meta.get('namespace', 'default')}/{name}"
                )
            return
        entry = self._intent_of(pod)
        if entry is None:
            return
        self.watch_events += 1
        # offer, not put: a consumed intent must not be resurrected by
        # the pod's later MODIFIED events / reconnect replays
        self._server.intents.offer(entry[0], entry[1])


# pod phases whose containers have stopped for good — their devices are
# free even while the pod object lingers (phase is monotonic once terminal)
TERMINAL_PHASES = frozenset({"Succeeded", "Failed"})


def _pod_key_of(pod: dict[str, Any]) -> Optional[str]:
    meta = pod.get("metadata") or {}
    name = meta.get("name")
    if not name:
        return None
    return f"{meta.get('namespace', 'default')}/{name}"


class PodLifecycleReleaseLoop(_WatchLoop):
    """The release effector for pod lifecycle — KubeGPU's recovery loop
    ("pods on dead device fail → controller reschedules") structurally
    requires it, and so does every long-lived cluster.

    kube-scheduler only talks to the extender about pods it is *placing*;
    nothing in the webhook protocol ever says a placed pod finished.
    Without this loop a completed or deleted pod's chips stay committed in
    the ledger forever: utilization reads 100% while the hardware idles,
    later gangs cannot fit, and preemption plans evict pods that no longer
    exist. This loop watches pod lifecycle cluster-wide and turns each
    ending into the extender's recorded ``release`` decision:

      * ``DELETED``                  → release (object gone, devices freed)
      * phase ``Succeeded``/``Failed`` → release (containers stopped; the
        object lingers until a controller or operator deletes it, but the
        kubelet has already returned the devices)

    A pod carrying only a ``deletionTimestamp`` is NOT released: graceful
    termination means its containers may still hold the chips — the same
    conservative rule :class:`EvictionExecutor` applies before counting a
    preemption victim as evicted.

    The resync (every (re)connect; every poll in no-watch mode) closes
    watch gaps from both directions: listed pods in a terminal phase are
    released directly, and ledger allocations whose pod is absent from the
    list are released only after a confirming GET — the GET, not the list,
    is the authority, because the list snapshot may predate a just-bound
    pod's creation (pods are always created before they are scheduled, so
    a pod the GET still finds is alive, not leaked).

    Gang note: only committed allocations are released here. A gang
    member holding a pre-bind *reservation* (assigned, never bound) whose
    pod vanishes is rolled back by the gang layer's own TTL — the
    documented path for half-assembled gangs.
    """

    def __init__(
        self, extender, api, poll_seconds: float = 5.0,
        use_watch: bool = True, evictions: Optional["EvictionExecutor"] = None,
    ) -> None:
        super().__init__("tpukube-pod-lifecycle", api, None,
                         poll_seconds, use_watch)
        self._extender = extender
        # termination-detection unification: this loop already sees every
        # pod DELETED event, so it confirms the eviction executor's
        # in-flight terminations for free — while this loop's watch runs,
        # the executor stretches its per-key GET poll to a 30s missed-
        # event safety net (attach_watch_confirmer)
        self._evictions = evictions
        if evictions is not None:
            evictions.attach_watch_confirmer(self)
        self.released = 0  # lifecycle releases applied (tests/metrics)
        # resync release batching: while set, _release
        # defers its dispatch into this buffer and _resync_from flushes
        # ONE extender.release_many call — against a process-mode
        # ShardRouter that is one fanned-out round-trip per replica
        # instead of one per released pod (a churn wave releases
        # thousands). None = dispatch inline (watch events, plain
        # extenders).
        self._release_buffer: Optional[list[str]] = None
        # generation-based incremental resync: instead of
        # reading the FULL ledger every resync (per churn wave — over
        # the process transport that serialized every replica's whole
        # alloc set per wave), keep a mirror advanced by the ledger's
        # allocs_since change log. A cursor the log cannot cover (gap,
        # restart) degrades to a counted full read — never stale. The
        # counters feed tpukube_resync_{full,incremental}_total and
        # tpukube_resync_bytes_total; None mirror = feature off or not
        # yet bootstrapped.
        self._alloc_cursor = None
        self._alloc_mirror: Optional[dict[str, Any]] = None
        self.resync_full = 0
        self.resync_incremental = 0
        self.resync_bytes = 0

    def watch_alive(self) -> bool:
        """True while DELETED events can actually flow (the executor's
        cue to defer its GET confirms here) — this loop's own stream, or
        the shared PodInformer's. Requires a CURRENTLY-CONNECTED stream,
        not merely a live thread: during reconnect backoff and list-
        resync windows events are silently missed, and deferring the GET
        net on a dead stream gates gang binds up to 30s per missed
        event."""
        host = getattr(self, "_host_loop", None) or self
        return (host._use_watch and host._thread is not None
                and host._thread.is_alive() and host.stream_connected())

    def _confirm_eviction(self, pod_key: str) -> None:
        if self._evictions is not None:
            self._evictions.confirm_deleted(pod_key)

    def _release(self, pod_key: str, why: str, uid: str = "") -> bool:
        alloc = self._extender.state.allocation(pod_key)
        if alloc is None:
            return False
        if alloc.uid and uid and alloc.uid != uid:
            # pod names recur (StatefulSet members): this signal is about
            # a DIFFERENT incarnation than the ledger entry — a stale
            # DELETED event or stale list entry must not free the chips a
            # recreated, live pod is holding
            log.info("lifecycle signal for %s ignored: uid %s is not the "
                     "ledger's %s", pod_key, uid, alloc.uid)
            return False
        if self._release_buffer is not None:
            self._release_buffer.append(pod_key)
        else:
            self._extender.handle("release", {"pod_key": pod_key})
        self.released += 1
        log.info("released %s (%s)", pod_key, why)
        return True

    def _apply_watch_event(self, etype: str, pod: dict[str, Any]) -> None:
        key = _pod_key_of(pod)
        if key is None:
            return
        uid = str((pod.get("metadata") or {}).get("uid") or "")
        if etype == "DELETED":
            self._confirm_eviction(key)
            self._release(key, "pod deleted", uid=uid)
            return
        phase = (pod.get("status") or {}).get("phase")
        if phase in TERMINAL_PHASES:
            self._release(key, f"phase {phase}", uid=uid)

    def _resync(self) -> tuple[bool, Optional[str]]:
        pods, rv = self._list_pods_rv()
        return self._resync_from(pods), rv

    def _resync_from(self, pods: list[dict[str, Any]]) -> bool:
        """Reconcile against an already-fetched pod list (the shared
        PodInformer fetches once for all its children)."""
        release_many = getattr(self._extender, "release_many", None)
        if release_many is not None:
            self._release_buffer = []
        try:
            return self._resync_scan(pods)
        finally:
            buffer, self._release_buffer = self._release_buffer, None
            if buffer:
                release_many(buffer)

    def _ledger_allocations(self) -> list:
        """The committed allocations the resync reconciles against —
        served O(Δ) from the generation-log mirror when the extender's
        ledger supports ``allocs_since``, the legacy full
        read otherwise. The mirror is exactly as fresh as a full read
        taken at the answer's cursor: a gap or restart produces a full
        answer from the source, never a stale or partial mirror."""
        state = self._extender.state
        since = getattr(state, "allocs_since", None)
        if since is None:
            return state.allocations()
        delta = since(self._alloc_cursor)
        if delta is None:  # log disabled: legacy full read, uncounted
            return state.allocations()
        self._alloc_cursor = delta["cursor"]
        self.resync_bytes += int(delta.get("bytes", 0))
        if "full" in delta:
            self.resync_full += 1
            self._alloc_mirror = {a.pod_key: a for a in delta["full"]}
        else:
            self.resync_incremental += 1
            mirror = self._alloc_mirror
            if mirror is None:  # defensive: treat as bootstrap
                mirror = self._alloc_mirror = {}
            for key in delta["removes"]:
                mirror.pop(key, None)
            for alloc in delta["adds"]:
                mirror[alloc.pod_key] = alloc
        return list(self._alloc_mirror.values())

    def resync_stats(self) -> dict[str, Any]:
        """The resync counters (scenario results + /statusz): full vs
        incremental reads and the wire-shape bytes they moved. The
        hit ratio excludes the one unavoidable bootstrap full read —
        any ADDITIONAL full is a gap/restart fallback."""
        reads = self.resync_full + self.resync_incremental
        return {
            "full": self.resync_full,
            "incremental": self.resync_incremental,
            "bytes": self.resync_bytes,
            "incremental_hit_ratio": (
                round(self.resync_incremental / max(1, reads - 1), 4)
                if reads > 1 else None
            ),
        }

    def _resync_scan(self, pods: list[dict[str, Any]]) -> bool:
        present: dict[str, str] = {}  # key -> listed uid
        changed = False
        for pod in pods:
            key = _pod_key_of(pod)
            if key is None:
                continue
            uid = str((pod.get("metadata") or {}).get("uid") or "")
            present[key] = uid
            if (pod.get("status") or {}).get("phase") in TERMINAL_PHASES:
                changed |= self._release(key, "terminal phase (resync)",
                                         uid=uid)
        for alloc in self._ledger_allocations():
            listed_uid = present.get(alloc.pod_key)
            if listed_uid is not None:
                if not (alloc.uid and listed_uid
                        and alloc.uid != listed_uid):
                    continue  # same (or indeterminate) incarnation — alive
                # a same-name pod with a DIFFERENT uid: the allocation's
                # incarnation is gone; holding its entry would 409 the
                # newcomer's bind forever (phantom allocation)
                changed |= self._release(alloc.pod_key,
                                         "pod replaced (resync)")
                continue
            namespace, name = alloc.pod_key.split("/", 1)
            try:
                pod = self._api.get_pod(namespace, name)
            except Exception as e:
                log.warning("lifecycle confirm of %s failed, retrying: %s",
                            alloc.pod_key, e)
                continue
            if pod is not None:
                cur_uid = str((pod.get("metadata") or {}).get("uid") or "")
                if not (alloc.uid and cur_uid and alloc.uid != cur_uid):
                    # same (or indeterminate) incarnation — but a pod the
                    # stale LIST missed may ALREADY be terminal: trust the
                    # GET's phase, or the chips wait a full reconnect
                    # interval for release
                    phase = (pod.get("status") or {}).get("phase")
                    if phase in TERMINAL_PHASES:
                        changed |= self._release(
                            alloc.pod_key, f"phase {phase} (resync confirm)",
                            uid=cur_uid,
                        )
                    continue
                changed |= self._release(alloc.pod_key,
                                         "pod replaced (resync)")
                continue
            # (executor-tracked eviction victims never reach this loop —
            # their ledger entries were released before queueing; a
            # DELETED event missed in a reconnect gap is recovered by the
            # executor's own stretched GET net, WATCH_CONFIRM_GRACE_S)
            changed |= self._release(alloc.pod_key, "pod absent (resync)")
        return changed


class PodAdmissionFeed(_WatchLoop):
    """Routes informer-delivered PENDING pods into the extender's batch
    scheduling queue (``Extender.admit``), so batching is fed by the
    cluster and not only by webhooks or the sim's batch driver.

    Without this feed the scheduling queue fills only from /filter
    webhooks (one pod per kube-scheduler pop): an arrival storm still
    pays a webhook round trip before a pod reaches the planner. Fed from
    the shared :class:`PodInformer`, pending pods are admitted the moment
    their ADDED/MODIFIED event lands, so the next cycle drains the real
    backlog in one epoch-pinned plan and their /filter webhooks answer
    from it.

    Admission is conservative and idempotent: only unbound (no
    ``spec.nodeName``), non-terminal pods with a GPU or GPU-share request
    are admitted; ``Extender.admit`` is a no-op without batching and
    dedups per pod key. DELETED events need no handling — a deleted
    pod's queue entry is superseded at plan time and its plan expires on
    the reservation-TTL janitor, with the lifecycle loop's recorded
    release unwinding any assumed allocation."""

    def __init__(self, extender, api, poll_seconds: float = 5.0,
                 use_watch: bool = True) -> None:
        super().__init__("tpukube-pod-admission", api, None,
                         poll_seconds, use_watch)
        self._extender = extender
        self.admitted = 0  # pods routed into the queue (tests/metrics)

    def _admit(self, pod: dict[str, Any]) -> bool:
        from tpukube_torch.core.types import RESOURCE_TPU, RESOURCE_VTPU
        from tpukube_torch.sched import kube

        if (pod.get("spec") or {}).get("nodeName"):
            return False  # already bound: the queue is for pending pods
        if (pod.get("status") or {}).get("phase") in TERMINAL_PHASES:
            return False
        try:
            info = kube.pod_from_k8s(pod)
        except kube.KubeSchemaError:
            return False  # not a schedulable pod object
        req = info.requests()
        if not (req.get(RESOURCE_TPU, 0) or req.get(RESOURCE_VTPU, 0)):
            return False  # not ours to schedule
        if not self._extender.admit(info):
            # the pod already has a live plan (an informer
            # re-delivery), or batching is off: nothing entered the queue
            return False
        self.admitted += 1
        return True

    def _apply_watch_event(self, etype: str, pod: dict[str, Any]) -> None:
        if etype == "DELETED":
            return
        self._admit(pod)

    def _resync(self) -> tuple[bool, Optional[str]]:
        pods, rv = self._list_pods_rv()
        return self._resync_from(pods), rv

    def _resync_from(self, pods: list[dict[str, Any]]) -> bool:
        changed = False
        for pod in pods:
            changed |= self._admit(pod)
        return changed


class PodInformer(_WatchLoop):
    """ONE cluster-wide pod list+watch fanned out to the extender's pod
    loops (lifecycle release + alloc reconcile).

    Each of those loops is a correct standalone informer, but running
    both means two full paginated LISTs per reconnect and two concurrent
    watch streams each carrying — and decoding — every pod mutation in
    the cluster. The daemon runs this composite instead: one stream, one
    list, events dispatched to every child's handler. Children are
    constructed normally but never started; their counters/metrics stay
    theirs."""

    def __init__(self, api, children, poll_seconds: float = 5.0,
                 use_watch: bool = True) -> None:
        super().__init__("tpukube-pod-informer", api, None,
                         poll_seconds, use_watch)
        self._children = list(children)
        for c in self._children:
            # watch_alive() consumers (eviction confirmation deferral)
            # must see THIS loop's thread as the live stream
            c._host_loop = self

    def _apply_watch_event(self, etype: str, pod: dict[str, Any]) -> None:
        resync = False
        for c in self._children:
            try:
                c._apply_watch_event(etype, pod)
            except _ResyncNeeded:
                resync = True  # finish fanning out, then force resync
            except Exception:
                # a standalone loop would hit _run's generic handler and
                # reconnect+resync within one poll — a child under the
                # informer must keep that retry bound, not wait out the
                # watch stream's server timeout
                log.exception("%s: %s handler failed on %s",
                              self._name, c._name, etype)
                resync = True
        if resync:
            raise _ResyncNeeded

    def _resync(self) -> tuple[bool, Optional[str]]:
        pods, rv = self._list_pods_rv()
        changed = False
        for c in self._children:
            try:
                changed |= c._resync_from(pods)
            except Exception:
                log.exception("%s: %s resync failed", self._name, c._name)
                self._child_failed = True
        return changed, rv

    def _needs_resync(self) -> bool:
        flags = [c._needs_resync() for c in self._children]  # consume ALL
        failed, self._child_failed = getattr(self, "_child_failed",
                                             False), False
        return failed or any(flags)


class NodeTopologyRefreshLoop(_WatchLoop):
    """Keeps a nodeCacheCapable extender's node cache fresh.

    With ``nodeCacheCapable: true``, kube-scheduler sends only NodeNames —
    the extender would never see node-annotation updates (health faults,
    link faults, share-mode changes) after its startup rebuild. This loop
    watches the Node objects (informer pattern, poll fallback) and
    applies CHANGED topology annotations as recorded ``upsert_node``
    decisions, so live captures still replay deterministically against a
    fresh extender. Watch mode closes the §4.4 fault path's last latency
    gap: a node agent's health re-annotation reaches the scheduler's
    cache within milliseconds instead of a poll interval later."""

    def __init__(self, extender, api, poll_seconds: float = 5.0,
                 use_watch: bool = True) -> None:
        super().__init__("tpukube-node-refresh", api, None, poll_seconds,
                         use_watch, watch_method="watch_nodes")
        self._extender = extender
        self._applied: dict[str, str] = {}  # name -> applied topo payload
        self._rejected: dict[str, str] = {}  # name -> rejected payload
        self.refreshed = 0  # applied annotation changes (tests/metrics)

    def note_applied(self, name: str, payload: Optional[str]) -> None:
        """Prime the loop with a topology payload some OTHER path already
        dispatched (rebuild_extender at startup): without priming, the
        first poll re-records an upsert_node decision for every node the
        rebuild just applied — duplicate trace records and an inflated
        ``refreshed`` counter on every restart."""
        if payload is not None:
            self._applied[name] = payload

    def note_rejected(self, name: str, payload: Optional[str]) -> None:
        """Same priming for a payload another path already dispatched and
        saw REJECTED — the first poll must not re-record the identical
        error decision."""
        if payload is not None:
            self._rejected[name] = payload

    def _apply_node(self, obj: dict[str, Any]) -> bool:
        """Dispatch one Node object's topology annotation if it changed;
        True when applied."""
        meta = obj.get("metadata") or {}
        name = meta.get("name")
        if not name:
            return False
        annotations = dict(meta.get("annotations") or {})
        payload = annotations.get(codec.ANNO_NODE_TOPOLOGY)
        if payload is None or payload == self._applied.get(name):
            return False
        if payload == self._rejected.get(name):
            # a persistently-bad annotation must not re-record an
            # identical error decision (trace spam) every poll;
            # re-dispatch only when the payload changes
            return False
        out = self._extender.handle(
            "upsert_node", {"name": name, "annotations": annotations}
        )
        if out.get("error"):
            log.warning("node refresh for %s rejected: %s",
                        name, out["error"])
            self._rejected[name] = payload
            return False
        self._rejected.pop(name, None)
        self._applied[name] = payload
        self.refreshed += 1
        return True

    def _apply_watch_event(self, etype: str, obj: dict[str, Any]) -> None:
        if etype == "DELETED":
            # forget bookkeeping so a recreated same-name node re-applies
            name = (obj.get("metadata") or {}).get("name")
            if name:
                self._applied.pop(name, None)
                self._rejected.pop(name, None)
            return
        self._apply_node(obj)

    def _resync(self) -> tuple[bool, Optional[str]]:
        if hasattr(self._api, "list_nodes_with_rv"):
            nodes, rv = self._api.list_nodes_with_rv()
        else:
            nodes, rv = self._api.list_nodes(), None
        did = False
        for obj in nodes:
            did |= self._apply_node(obj)
        return did, rv


def rebuild_extender(extender, api, refresh=None) -> int:
    """Reconstruct a restarted extender's ledger AND gang reservations
    from the apiserver (the restart story, wired to the real
    channel): node topology annotations first — the ledger can only
    commit onto known nodes — then every *live, bound* pod's alloc
    annotation. Lifecycle-filtered: terminal-phase pods, unbound pods
    (bind partial-failure residue), and pods whose bound node contradicts
    their annotation are skipped loudly — restoring any of them would
    resurrect a dead or phantom allocation. A node whose annotation is
    malformed is skipped loudly; its pods then fail to restore (also
    loudly) and the reconcile machinery takes over.
    Pass the daemon's NodeTopologyRefreshLoop as ``refresh`` to prime it
    with the payloads applied here — its first poll then dispatches
    nothing the rebuild already did.
    With bulk ingest on (the default) the node list goes in as ONE
    recorded ``upsert_nodes`` decision, the daemon's cold start at fleet
    scale; the reference records one ``upsert_node`` per node. Both leave
    the same ledger (the bulk-ingest parity tests) and both replay.
    Returns the number of allocations restored."""
    nodes = []
    for obj in api.list_nodes():
        meta = obj.get("metadata") or {}
        name = meta.get("name")
        if name:
            nodes.append((name, dict(meta.get("annotations") or {})))
    # recorded decisions, not bare state mutation: a names-mode capture
    # that starts right after rebuild must replay with the same node
    # state the live extender had
    if getattr(extender, "bulk_ingest", False):
        results = extender.handle("upsert_nodes", {"items": [
            {"name": name, "annotations": annotations}
            for name, annotations in nodes]})["results"]
    else:
        results = [extender.handle(
            "upsert_node", {"name": name, "annotations": annotations},
        ) for name, annotations in nodes]
    for (name, annotations), out in zip(nodes, results):
        if out.get("error"):
            log.error("rebuild: node %s annotation rejected: %s",
                      name, out["error"])
            if refresh is not None:
                refresh.note_rejected(
                    name, annotations.get(codec.ANNO_NODE_TOPOLOGY)
                )
        elif refresh is not None:
            refresh.note_applied(
                name, annotations.get(codec.ANNO_NODE_TOPOLOGY)
            )
    pods = [annos for annos, _, _ in live_alloc_pods(api.list_pods())]
    return extender.rebuild_from_pods(pods)


def live_alloc_pods(
    pods: list[dict[str, Any]],
) -> list[tuple[dict[str, str], Optional[Any], Optional[str]]]:
    """The restart story's lifecycle filter, shared by the legacy full
    rebuild above and the journal recovery's reconcile pass
    (sched/journal.py) — they must never test different sets. Returns
    (annotations, decoded alloc or None when undecodable, pod key) for
    every pod whose alloc annotation SHOULD be restored: live, bound,
    non-terminal, annotation matching its binding and uid. Skips are
    loud; an undecodable payload passes through with ``None`` so
    ``rebuild_from_pods`` logs the decode failure itself."""
    out: list[tuple[dict[str, str], Optional[Any], Optional[str]]] = []
    for p in pods:
        meta = p.get("metadata") or {}
        annos = dict(meta.get("annotations") or {})
        payload = annos.get(codec.ANNO_ALLOC)
        if not payload:
            continue
        key = _pod_key_of(p)
        if key is None:
            continue
        phase = (p.get("status") or {}).get("phase")
        if phase in TERMINAL_PHASES:
            # the pod finished; its devices are free. Restoring it would
            # re-import exactly the leak PodLifecycleReleaseLoop exists to
            # close. (A pod with only a deletionTimestamp IS restored: its
            # containers may still hold the chips through graceful
            # termination, and the lifecycle loop releases it on DELETED.)
            log.warning("rebuild: skipping %s (phase %s — chips are free)",
                        key, phase)
            continue
        node_name = (p.get("spec") or {}).get("nodeName")
        if not node_name:
            # the bind effector's designed partial-failure residue: the
            # annotation PATCH landed but the Binding POST failed, so the
            # ledger was released and the scheduler retries. Restoring it
            # would plant a phantom allocation that 409s every bind retry,
            # pinning the pod Pending and leaking its chips.
            log.warning("rebuild: skipping %s (alloc annotation on an "
                        "unbound pod — bind partial-failure residue)", key)
            continue
        try:
            planned = codec.decode_alloc(payload)
        except codec.CodecError:
            planned = None  # rebuild_from_pods logs the decode loudly
        if planned is not None and planned.node_name != node_name:
            log.warning("rebuild: skipping %s (alloc says node %s but the "
                        "pod is bound to %s — stale annotation)",
                        key, planned.node_name, node_name)
            continue
        pod_uid = str(meta.get("uid") or "")
        if (planned is not None and planned.uid and pod_uid
                and planned.uid != pod_uid):
            log.warning("rebuild: skipping %s (alloc was for uid %s; the "
                        "pod is a recreation with uid %s)",
                        key, planned.uid, pod_uid)
            continue
        out.append((annos, planned, key))
    return out


def pod_binder(api) -> Callable[[Any], None]:
    """The extender's bind effector: ``extender.binder = pod_binder(api)``
    makes a successful /bind create the real Binding (pod starts on its
    node) and persist the alloc annotation the node agent's intent watcher
    reads. Raises ApiServerError upward — the extender undoes its ledger
    commit and the scheduler re-runs the cycle."""

    def bind(alloc) -> None:
        namespace, name = alloc.pod_key.split("/", 1)
        annotations = {codec.ANNO_ALLOC: codec.encode_alloc(alloc)}
        # gang env ALSO rides as per-key annotations: the downward API
        # projects each into its TPU_KUBE_GANG_* container env var
        # (deploy/gang-job-example.yaml) — a JSON blob inside one env
        # var would make the in-pod runtime parse annotations itself
        annotations.update(codec.gang_env_annotations(alloc.env))
        api.bind_pod(namespace, name, alloc.node_name, annotations)

    return bind


def alloc_divergence_reporter(api) -> Callable[[str, list[str], list[str]], None]:
    """The plugin's report channel for kubelet-side id divergence: write
    the ACTUAL allocated ids onto the pod for the extender's reconcile
    loop. Used as ``server.set_alloc_reporter(alloc_divergence_reporter(api))``."""

    def report(pod_key: str, planned: list[str], actual: list[str]) -> None:
        namespace, name = pod_key.split("/", 1)
        try:
            api.patch_pod_annotations(
                namespace, name,
                {ANNO_ALLOC_ACTUAL: encode_alloc_actual(actual)},
            )
            log.warning(
                "reported alloc divergence for %s: kubelet chose %s, "
                "plan was %s", pod_key, sorted(actual), sorted(planned),
            )
        except ApiServerError as e:
            log.error("divergence report for %s failed: %s", pod_key, e)

    return report


class AllocReconcileLoop(_WatchLoop):
    """Extender-side half of the device-id loop: folds reported
    ``alloc-actual`` annotations into the ledger (via the extender's
    recorded ``reconcile`` decision) and rewrites the pod's ``alloc``
    annotation to match reality, clearing the report. Watch-driven
    (informer pattern, poll fallback) like the other pod loops: a
    divergence report lands as the MODIFIED event that carries it,
    instead of up to a poll interval later — and the extender stops
    LISTing every pod every few seconds looking for a rare annotation
    the apiserver cannot field-select on."""

    def __init__(
        self, extender, api, poll_seconds: float = 5.0,
        use_watch: bool = True,
    ) -> None:
        super().__init__("tpukube-alloc-reconcile", api, None,
                         poll_seconds, use_watch)
        self._extender = extender
        # a failed ack PATCH left a folded-but-uncleared report: force a
        # resync after one poll interval instead of waiting for the next
        # event / the watch stream's server timeout
        self._ack_retry = False
        self.reconciled = 0  # ledger amendments applied (tests/metrics)

    def _reconcile_pod(self, pod: dict[str, Any]) -> bool:
        """Fold one pod's alloc-actual report, if it carries one; True
        when the ledger was amended and the report cleared. A failing
        pod never blocks the batch."""
        meta = pod.get("metadata", {})
        annos = meta.get("annotations") or {}
        payload = annos.get(ANNO_ALLOC_ACTUAL)
        if not payload:
            return False
        namespace = meta.get("namespace", "default")
        name = meta["name"]
        pod_key = f"{namespace}/{name}"
        try:
            actual = decode_alloc_actual(payload)
        except codec.CodecError as e:
            log.warning("pod %s: bad alloc-actual: %s", pod_key, e)
            return False
        self._extender.handle(
            "reconcile", {"pod_key": pod_key, "devices": actual}
        )
        patch: dict[str, Optional[str]] = {ANNO_ALLOC_ACTUAL: None}
        alloc = self._extender.state.allocation(pod_key)
        if alloc is not None:
            patch[codec.ANNO_ALLOC] = codec.encode_alloc(alloc)
        try:
            self._api.patch_pod_annotations(namespace, name, patch)
        except ApiServerError as e:
            # pod deleted mid-event, transient apiserver error: the
            # reconcile above is idempotent; flag a forced resync so the
            # retry comes within one poll interval, not at the watch
            # stream's server timeout
            log.warning("reconcile ack for %s failed: %s", pod_key, e)
            self._ack_retry = True
            return False
        self.reconciled += 1
        return True

    def _apply_watch_event(self, etype: str, pod: dict[str, Any]) -> None:
        if etype == "DELETED":
            return  # a deleted pod's report is moot
        # the clearing PATCH triggers one more MODIFIED event, which
        # finds no alloc-actual and no-ops — no feedback loop
        self._reconcile_pod(pod)
        if self._ack_retry:
            self._ack_retry = False
            raise _ResyncNeeded

    def _resync(self) -> tuple[bool, Optional[str]]:
        pods, rv = self._list_pods_rv()
        return self._resync_from(pods), rv

    def _resync_from(self, pods: list[dict[str, Any]]) -> bool:
        did = False
        for pod in pods:
            did |= self._reconcile_pod(pod)
        return did

    def _needs_resync(self) -> bool:
        # consumed AFTER the whole resync list was processed — one pod's
        # failing ack must not starve the batch
        retry, self._ack_retry = self._ack_retry, False
        return retry


class EvictionExecutor(_PollLoop):
    """The effector for the extender's eviction decisions.

    Preemption and gang rollback leave victim pod keys on
    ``extender.pending_evictions`` — the ledger already shows their chips
    free, so a victim left running would double-allocate on first reuse.
    This loop drains the queue through the apiserver channel's
    ``evict_pod`` (the Eviction subresource on a real cluster). A
    PDB-blocked or transiently-failing eviction is requeued and retried
    every poll, forever: eviction is a correctness obligation, not
    best-effort, so the only terminal states are "pod gone" and "operator
    intervened". The sim harness's ``drain_evictions`` is a thin wrapper
    over :meth:`drain`."""

    def __init__(self, extender, api, poll_seconds: float = 1.0,
                 clock=None) -> None:
        from tpukube_torch.core.clock import SYSTEM

        super().__init__(poll_seconds, "tpukube-evictions")
        self._extender = extender
        self._api = api
        # eviction-confirm ages and the watch-confirm grace window are
        # scheduling-semantic time: injectable (core/clock.py) so the
        # discrete-event sim drives them on compressed time
        self._clock = clock if clock is not None else SYSTEM
        # eviction accepted by the apiserver but deletion not yet
        # confirmed: a 2xx on the Eviction subresource only STARTS
        # graceful termination; the pod keeps its devices until its
        # containers actually stop, so "evicted" is only counted once the
        # pod object is gone. Guarded by _state_lock: the lifecycle
        # watch's confirm_deleted runs on its own thread.
        self._terminating: set[str] = set()
        # keys whose eviction POST is IN FLIGHT right now: an instantly-
        # deleted victim's DELETED event can reach the lifecycle watch
        # (confirm_deleted) before drain() regains the lock to add the
        # key to _terminating — without pre-registration that confirm
        # would miss and the gang would wait out the 30s GET net
        self._expecting: set[str] = set()
        self._confirmed_early: set[str] = set()
        self._state_lock = threading.Lock()
        # pod key -> monotonic time of its FIRST drain attempt; feeds the
        # oldest-age gauge operators alarm on (a PDB-wedged eviction is
        # a capacity leak in progress)
        self._pending_since: dict[str, float] = {}
        # a live pod watch that calls confirm_deleted (the lifecycle
        # loop): while it is running, the per-key GET confirm only covers
        # keys the watch has had ample time to see — O(1) confirmation
        # traffic instead of one GET per victim per poll
        self._watch_confirmer = None
        # optional core/retry.Retrier for the per-key GET confirms: a
        # transient apiserver blip then retries within this poll
        # instead of gating a gang bind a whole extra interval. None
        # (the default) keeps the poll-cadence-only behavior.
        self.retrier: Optional[retry.Retrier] = None
        self.evicted = 0   # pods confirmed gone (tests/metrics)
        self.blocked = 0   # PDB 429s requeued (tests/metrics)
        self.failures = 0  # transport/API errors requeued (tests/metrics)

    # while a watch confirmer runs, GET-confirm only keys older than this
    # (the watch delivers DELETED within ms; the stretched GET is the
    # missed-event safety net, not the primary channel)
    WATCH_CONFIRM_GRACE_S = 30.0

    def attach_watch_confirmer(self, loop) -> None:
        """Called by PodLifecycleReleaseLoop when wired with this
        executor: its DELETED events become the primary termination
        confirmation channel."""
        self._watch_confirmer = loop

    def depth(self) -> int:
        """Evictions not yet confirmed done: queued + terminating."""
        with self._state_lock:
            return (len(self._extender.pending_evictions)
                    + len(self._terminating))

    def oldest_age_seconds(self, now: Optional[float] = None) -> float:
        """Age of the oldest unconfirmed eviction (0.0 when idle),
        measured from its first drain attempt."""
        with self._state_lock:
            if not self._pending_since:
                return 0.0
            now = self._clock.monotonic() if now is None else now
            return max(0.0, now - min(self._pending_since.values()))

    def pending_snapshot(
        self, now: Optional[float] = None
    ) -> list[dict[str, Any]]:
        """Every unconfirmed eviction with its state and age (seconds
        since first drain attempt; None before the first attempt): the
        /statusz rendering of the queue the depth gauge only counts."""
        now = self._clock.monotonic() if now is None else now
        with self._state_lock:
            out = []
            for pod_key in list(self._extender.pending_evictions):
                since = self._pending_since.get(pod_key)
                out.append({
                    "pod": pod_key, "state": "queued",
                    "age_seconds": (round(now - since, 3)
                                    if since is not None else None),
                })
            for pod_key in sorted(self._terminating):
                since = self._pending_since.get(pod_key)
                out.append({
                    "pod": pod_key, "state": "terminating",
                    "age_seconds": (round(now - since, 3)
                                    if since is not None else None),
                })
            return out

    def _confirmed(self, pod_key: str) -> None:
        """Bookkeeping for a victim whose pod object is gone (call with
        _state_lock held for the set mutation done by callers); tells the
        extender through the recorded ``victim_gone`` decision so gated
        gang binds unblock deterministically."""
        self.evicted += 1
        self._pending_since.pop(pod_key, None)

    def _notify_gone(self, pod_key: str) -> None:
        handle = getattr(self._extender, "handle", None)
        if handle is not None:
            try:
                handle("victim_gone", {"pod_key": pod_key})
            except Exception:
                log.exception("victim_gone dispatch for %s failed", pod_key)

    def confirm_deleted(self, pod_key: str) -> bool:
        """Out-of-band confirmation from the lifecycle watch: it saw the
        pod's DELETED event, so the GET poll for this key is redundant
        (and _confirm_terminated defers to this channel while the watch
        runs — see WATCH_CONFIRM_GRACE_S). Returns True if the key was
        being tracked: terminating, its eviction POST in flight, or
        still queued on pending_evictions awaiting its first drain."""
        never_posted = False
        with self._state_lock:
            if pod_key in self._terminating:
                self._terminating.discard(pod_key)
            elif pod_key in self._expecting:
                # the DELETED event outran the eviction call's return:
                # count it now; drain() sees _confirmed_early and will
                # not track (or requeue) the already-gone pod
                self._confirmed_early.add(pod_key)
            elif pod_key in self._extender.pending_evictions:
                # queued but not yet drained: the victim is already
                # gone, so the eviction POST is moot — drop the key from
                # the queue NOW (a side marker would linger and cancel a
                # later legitimate eviction of a reused pod name), and
                # never track a deletion the watch has already delivered
                # (re-tracking would gate the gang on the 30s GET net)
                try:
                    self._extender.pending_evictions.remove(pod_key)
                    never_posted = True
                except ValueError:
                    # drain() popped it between the membership check and
                    # the remove; its POST is about to fly — same
                    # handling as the _expecting race above
                    self._confirmed_early.add(pod_key)
            else:
                return False
            # ``evicted`` counts pods confirmed GONE (the gang-unblock
            # event), not Eviction POSTs executed — a queued victim that
            # exits on its own still resolves its eviction obligation
            self._confirmed(pod_key)
        self._notify_gone(pod_key)
        if never_posted:
            # no Eviction POST ever flew: don't log an eviction that
            # would have no apiserver audit record to correlate with
            log.warning("victim %s gone before its eviction was posted "
                        "(confirmed by lifecycle watch)", pod_key)
        else:
            log.warning("evicted %s (confirmed by lifecycle watch)", pod_key)
        return True

    def check_once(self) -> bool:
        """One poll; True if any pod was evicted."""
        return bool(self.drain())

    def drain(self) -> list[str]:
        """Attempt every currently-queued eviction once; returns the pod
        keys whose deletion is CONFIRMED (object absent from the
        apiserver). Blocked/failed keys go back on the queue, accepted-
        but-still-terminating keys wait in ``_terminating`` — a key only
        leaves the executor as a confirmed deletion, never dropped."""
        q = self._extender.pending_evictions
        requeue: list[str] = []
        try:
            # bounded by the snapshot length: keys appended by other
            # threads mid-drain, like requeued keys, wait for the next poll
            for _ in range(len(q)):
                try:
                    pod_key = q.popleft()
                except IndexError:  # racing consumer emptied it
                    break
                with self._state_lock:
                    self._pending_since.setdefault(
                        pod_key, self._clock.monotonic()
                    )
                    self._expecting.add(pod_key)
                ok = None
                err = None
                try:
                    namespace, name = pod_key.split("/", 1)
                    ok = self._api.evict_pod(namespace, name)
                # tpukube: allow(exception-hygiene) the error is carried to the requeue branch below, which logs it and bumps the failures counter
                except Exception as e:
                    err = e
                with self._state_lock:
                    self._expecting.discard(pod_key)
                    if pod_key in self._confirmed_early:
                        # the watch confirmed the pod gone mid-call:
                        # nothing left to track or requeue, whatever the
                        # call's own outcome was. Drop the age entry too:
                        # when confirm_deleted's queued-key remove lost
                        # the race to our popleft, its _confirmed()
                        # bookkeeping ran BEFORE our setdefault above —
                        # without this pop the orphan entry inflates
                        # oldest_age_seconds() forever
                        self._pending_since.pop(pod_key, None)
                        self._confirmed_early.discard(pod_key)
                        continue
                    if ok:
                        self._terminating.add(pod_key)
                if err is not None:
                    # broad on purpose: ANY failure (transport timeout,
                    # junk response body, ...) must requeue, not drop —
                    # a lost key is a silent double-allocation
                    log.warning("eviction of %s failed, requeued: %s",
                                pod_key, err)
                    self.failures += 1
                    requeue.append(pod_key)
                elif not ok:
                    self.blocked += 1
                    requeue.append(pod_key)
                    log.warning("eviction of %s blocked by PDB, requeued",
                                pod_key)
        finally:
            q.extend(requeue)
        return self._confirm_terminated()

    def _confirm_terminated(self) -> list[str]:
        """Count a terminating pod as evicted once its object is gone —
        one tiny GET per in-flight key, not a cluster-wide list. A
        same-name pod WITHOUT a deletionTimestamp also confirms: the
        apiserver stamps deletionTimestamp the moment it accepts an
        eviction, so an unstamped pod is a controller's recreation (e.g.
        a StatefulSet member) — the original is gone and the newcomer is
        someone else's allocation, not our victim."""
        done = []
        watch_live = (self._watch_confirmer is not None
                      and self._watch_confirmer.watch_alive())
        now = self._clock.monotonic()
        with self._state_lock:
            tracked = sorted(
                pod_key for pod_key in self._terminating
                if not watch_live
                or (now - self._pending_since.get(pod_key, now)
                    > self.WATCH_CONFIRM_GRACE_S)
            )
        for pod_key in tracked:
            namespace, name = pod_key.split("/", 1)
            try:
                if self.retrier is not None:
                    pod = self.retrier.call(
                        lambda ns=namespace, n=name: self._api.get_pod(ns, n)
                    )
                else:
                    pod = self._api.get_pod(namespace, name)
            except Exception as e:
                log.warning("eviction confirm of %s failed, retrying: %s",
                            pod_key, e)
                continue
            if pod is not None and (
                (pod.get("metadata") or {}).get("deletionTimestamp")
            ):
                continue  # graceful termination still running
            with self._state_lock:
                if pod_key not in self._terminating:
                    continue  # confirm_deleted raced in and won
                self._terminating.discard(pod_key)
                self._confirmed(pod_key)
            self._notify_gone(pod_key)
            done.append(pod_key)
            log.warning("evicted %s (extender preemption/rollback)", pod_key)
        return done
