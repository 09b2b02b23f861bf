"""kube-scheduler's side of the extender protocol, over HTTP: one
scheduling cycle (filter -> prioritize -> bind the highest score) against
an extender's webhooks, as the smoke run drives the port's extender
(:func:`tpukube_torch.sched.extender.serve`). Standard library only.

``ssl_context`` is kube-scheduler's extender ``tlsConfig``: with one the
webhooks go over HTTPS, and a context that loads a client certificate
speaks the mTLS the extender daemon asks for (``--tls-client-ca``)."""

from __future__ import annotations

import http.client
import json
import ssl
import time
from typing import Any, Optional

from tpukube_torch.core import codec
from tpukube_torch.core.types import AllocResult


def post(port: int, path: str, body: Any, host: str = "127.0.0.1",
         ssl_context: Optional[ssl.SSLContext] = None,
         token: Optional[str] = None) -> Any:
    """POST ``body`` as JSON to ``http://host:port/path`` (https with
    ``ssl_context``; ``Authorization: Bearer <token>`` with ``token``);
    the parsed JSON answer. Raises RuntimeError on a status other than
    200."""
    conn = (http.client.HTTPSConnection(host, port, timeout=60,
                                        context=ssl_context)
            if ssl_context is not None
            else http.client.HTTPConnection(host, port, timeout=60))
    try:
        headers = {"Content-Type": "application/json"}
        if token is not None:
            headers["Authorization"] = f"Bearer {token}"
        conn.request("POST", path, body=json.dumps(body).encode(),
                     headers=headers)
        resp = conn.getresponse()
        raw = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"HTTP {resp.status} from {path}: "
                           f"{raw.decode(errors='replace')[:300]}")
    return json.loads(raw)


def filter_nodes(port: int, pod: dict, nodes: list,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 token: Optional[str] = None) -> dict:
    """The ExtenderFilterResult for ``pod`` over ``nodes``: the node
    objects, or their names only (what kube-scheduler sends a
    nodeCacheCapable extender, which knows the nodes from the apiserver)."""
    if nodes and all(isinstance(n, str) for n in nodes):
        return post(port, "/filter", {"Pod": pod, "NodeNames": list(nodes)},
                    ssl_context=ssl_context, token=token)
    return post(port, "/filter", {"Pod": pod, "Nodes": {"Items": nodes}},
                ssl_context=ssl_context, token=token)


def place(port: int, pod: dict, nodes: list,
          ssl_context: Optional[ssl.SSLContext] = None,
          token: Optional[str] = None,
          ) -> tuple[str, AllocResult, dict[str, float]]:
    """One scheduling cycle for ``pod`` over ``nodes`` (objects or names,
    as :func:`filter_nodes`): the feasible nodes, their scores, the bind of
    the best (ties go to the first name, as the sim's scheduler breaks
    them). Returns (node, the bound alloc, each webhook's round trip in ms
    on the host clock). Raises when the pod is unschedulable or the bind
    fails."""
    ms: dict[str, float] = {}
    t = time.perf_counter()
    fres = filter_nodes(port, pod, nodes, ssl_context=ssl_context, token=token)
    ms["filter"] = (time.perf_counter() - t) * 1e3
    if fres.get("Error") or not fres["NodeNames"]:
        raise RuntimeError(f"unschedulable: {fres.get('Error') or fres['FailedNodes']}")
    t = time.perf_counter()
    pres = post(port, "/prioritize", {"Pod": pod, "NodeNames": fres["NodeNames"]},
                ssl_context=ssl_context, token=token)
    ms["prioritize"] = (time.perf_counter() - t) * 1e3
    scores = {e["Host"]: e["Score"] for e in pres}
    best = max(sorted(scores), key=lambda h: scores[h])
    meta = pod["metadata"]
    t = time.perf_counter()
    bres = post(port, "/bind", {"PodName": meta["name"],
                                "PodNamespace": meta["namespace"],
                                "PodUID": meta["uid"], "Node": best},
                ssl_context=ssl_context, token=token)
    ms["bind"] = (time.perf_counter() - t) * 1e3
    if bres.get("Error"):
        raise RuntimeError(f"bind error: {bres['Error']}")
    return best, codec.decode_alloc(bres["Annotations"][codec.ANNO_ALLOC]), ms
