"""Kubernetes API JSON <-> core types — the port's own copy of
``tpukube/sched/kube.py``.

The extender webhook bodies (ExtenderArgs, ExtenderFilterResult,
HostPriorityList, ExtenderBindingArgs) are fixed by kube-scheduler, the
``nodeCacheCapable`` names mode included. This module converts between
those wire dicts and the framework's PodInfo/NodeInfo, so the extender
logic never touches raw JSON.

Field names follow the upstream scheduler-extender v1 API (capitalized:
"Pod", "Nodes", "FailedNodes", "Host", "Score"); pod/node objects follow
core v1 (lowercase metadata/spec).
"""

from __future__ import annotations

from typing import Any, Optional

from tpukube_torch.core import codec
from tpukube_torch.core.types import (
    RESOURCE_TPU,
    RESOURCE_VTPU,
    ContainerInfo,
    PodInfo,
    ResourceList,
)


class KubeSchemaError(ValueError):
    pass


def pod_from_k8s(obj: dict[str, Any]) -> PodInfo:
    """v1.Pod dict -> PodInfo (only the fields this framework reasons on)."""
    if not isinstance(obj, dict):
        raise KubeSchemaError("Pod must be a JSON object")
    meta = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    name = meta.get("name")
    if not name:
        raise KubeSchemaError("Pod.metadata.name missing")
    containers = []
    for c in spec.get("containers") or []:
        requests_raw = ((c.get("resources") or {}).get("requests")) or {}
        requests = ResourceList()
        for k, v in requests_raw.items():
            try:
                requests[k] = int(v)
            except (TypeError, ValueError):
                # non-integer quantities (cpu "500m", memory "1Gi") are not
                # device resources; this framework only meters whole devices
                continue
        containers.append(ContainerInfo(name=c.get("name", ""), requests=requests))
    pod = PodInfo(
        name=name,
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", ""),
        containers=containers,
        priority=int(spec.get("priority") or 0),
        annotations=dict(meta.get("annotations") or {}),
        labels=dict(meta.get("labels") or {}),
        node_name=spec.get("nodeName", ""),
    )
    codec.attach_group(pod)
    return pod


def pod_to_k8s(pod: PodInfo) -> dict[str, Any]:
    """PodInfo -> v1.Pod dict, the inverse of :func:`pod_from_k8s` for
    the fields this framework reasons on. The sharded router's
    subprocess transport ships driver-admitted pods to worker daemons
    with this; round-tripping through ``pod_from_k8s`` on the worker
    reconstructs an equivalent PodInfo (the gang group rides its
    annotations, re-attached by ``codec.attach_group``)."""
    annotations = dict(pod.annotations)
    if pod.group is not None:
        annotations.update(codec.pod_group_annotations(pod.group))
    spec: dict[str, Any] = {
        "priority": pod.priority,
        "containers": [
            {
                "name": c.name,
                "resources": {
                    "requests": {k: str(v)
                                 for k, v in c.requests.items()}
                },
            }
            for c in pod.containers
        ],
    }
    if pod.node_name:
        spec["nodeName"] = pod.node_name
    return {
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "uid": pod.uid,
            "annotations": annotations,
            "labels": dict(pod.labels),
        },
        "spec": spec,
    }


def node_name_and_annotations(obj: dict[str, Any]) -> tuple[str, dict[str, str]]:
    if not isinstance(obj, dict):
        raise KubeSchemaError("Node must be a JSON object")
    meta = obj.get("metadata") or {}
    name = meta.get("name")
    if not name:
        raise KubeSchemaError("Node.metadata.name missing")
    return name, dict(meta.get("annotations") or {})


def parse_extender_args(
    body: dict[str, Any],
) -> tuple[PodInfo, Optional[list[dict[str, Any]]], Optional[list[str]]]:
    """ExtenderArgs -> (pod, raw node objects | None, node names | None).

    At most one of the last two is set. ``NodeNames`` is the
    nodeCacheCapable mode of the upstream extender protocol: the
    scheduler sends only names and the extender answers from its own node
    cache (here: ClusterState, fed by the annotation syncer) — the big
    per-webhook node payload disappears from the hot path.

    ``NodesCached: true`` (a sim-harness extension) takes
    nodeCacheCapable to its conclusion: the candidate set is "every
    node the extender already knows" and the body names NONE of them —
    both returns are None and the handler expands from its own cache.
    Re-listing 10k unchanged names per sampled webhook was a measured
    O(nodes) term of the kilonode drives; placements are parity-tested
    against the protocol-faithful body."""
    if not isinstance(body, dict):
        raise KubeSchemaError("ExtenderArgs must be a JSON object")
    pod_obj = body.get("Pod")
    if pod_obj is None:
        raise KubeSchemaError("ExtenderArgs.Pod missing")
    pod = pod_from_k8s(pod_obj)
    nodes = (body.get("Nodes") or {}).get("Items")
    if nodes is not None:
        return pod, list(nodes), None
    if body.get("NodesCached") is True:
        return pod, None, None
    names = body.get("NodeNames")
    if names is None:
        raise KubeSchemaError(
            "ExtenderArgs carries neither Nodes.Items, NodeNames, "
            "nor NodesCached"
        )
    if not isinstance(names, list) or not all(
        isinstance(n, str) for n in names
    ):
        raise KubeSchemaError(
            "ExtenderArgs.NodeNames must be a list of strings"
        )
    return pod, None, list(names)


def filter_result(
    feasible: list[dict[str, Any]],
    failed: dict[str, str],
    error: str = "",
) -> dict[str, Any]:
    return {
        "Nodes": {"Items": feasible},
        "NodeNames": [
            (n.get("metadata") or {}).get("name") for n in feasible
        ],
        "FailedNodes": failed,
        "Error": error,
    }


def filter_result_names(
    feasible_names: list[str],
    failed: dict[str, str],
    error: str = "",
) -> dict[str, Any]:
    """ExtenderFilterResult in nodeCacheCapable mode: names only."""
    return {
        "NodeNames": list(feasible_names),
        "FailedNodes": failed,
        "Error": error,
    }


def host_priority_list(scores: dict[str, int]) -> list[dict[str, Any]]:
    return [{"Host": h, "Score": s} for h, s in sorted(scores.items())]


def parse_binding_args(body: dict[str, Any]) -> tuple[str, str, str, str]:
    """ExtenderBindingArgs -> (name, namespace, uid, node)."""
    if not isinstance(body, dict):
        raise KubeSchemaError("ExtenderBindingArgs must be a JSON object")
    try:
        return (
            body["PodName"],
            body.get("PodNamespace", "default"),
            body.get("PodUID", ""),
            body["Node"],
        )
    except KeyError as e:
        raise KubeSchemaError(f"ExtenderBindingArgs missing {e}") from e


def binding_result(error: Optional[str] = None) -> dict[str, Any]:
    return {"Error": error or ""}


def pod_object(
    name: str,
    tpu: int = 0,
    vtpu: int = 0,
    namespace: str = "default",
    priority: int = 0,
    annotations: Optional[dict[str, str]] = None,
) -> dict[str, Any]:
    """A v1.Pod as kube-scheduler sends it in ExtenderArgs: one container
    requesting ``tpu`` whole GPUs or ``vtpu`` shares (the sim's and the
    smoke run's pods)."""
    requests: dict[str, str] = {}
    if tpu:
        requests[RESOURCE_TPU] = str(tpu)
    if vtpu:
        requests[RESOURCE_VTPU] = str(vtpu)
    return {
        "metadata": {
            "name": name,
            "namespace": namespace,
            "uid": f"uid-{namespace}-{name}",
            "annotations": dict(annotations or {}),
            "labels": {},
        },
        "spec": {
            "priority": priority,
            "containers": [
                {"name": "main", "resources": {"requests": requests}}
            ],
        },
    }
