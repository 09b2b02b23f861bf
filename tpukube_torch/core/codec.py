"""Annotation codec (L4) — the port's own copy of ``tpukube/core/codec.py``.

kube-scheduler extender webhooks only see core API object fields, so node
topology and allocation results ride Kubernetes annotations: the node
agent writes ``node-topology`` onto its Node (``annotate_node``), the
extender writes ``alloc`` onto bound Pods, and jobs declare gangs with
``pod-group`` annotations. The wire names (``tpu.qiniu.com/*``) and schema
version 1 are the reference's, so either package's agent and extender
interoperate. On the real backend a chip id is the GPU's NVML UUID.
"""

from __future__ import annotations

import json
from typing import Optional

from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import (
    DEFAULT_SLICE,
    AllocResult,
    ChipInfo,
    Health,
    NodeInfo,
    PodGroup,
    PodInfo,
    TopologyCoord,
    canonical_link,
)

SCHEMA_VERSION = 1

ANNO_PREFIX = "tpu.qiniu.com/"
ANNO_NODE_TOPOLOGY = ANNO_PREFIX + "node-topology"
ANNO_ALLOC = ANNO_PREFIX + "alloc"
ANNO_POD_GROUP = ANNO_PREFIX + "pod-group"
ANNO_POD_GROUP_MIN_MEMBER = ANNO_PREFIX + "pod-group-min-member"
ANNO_POD_GROUP_SHAPE = ANNO_PREFIX + "pod-group-shape"
ANNO_POD_GROUP_ALLOW_DCN = ANNO_PREFIX + "pod-group-allow-dcn"
# Compact per-node health summary (obs/health.py telemetry): refreshed
# alongside node-topology on every health/link transition so the
# extender can roll up fleet health per ICI slice without re-walking
# every chip entry of every annotation.
ANNO_HEALTH_SUMMARY = ANNO_PREFIX + "health-summary"

# Per-key projections of the bind-time gang env (the cross-slice
# coordination contract TPU_KUBE_GANG_* — device/gpu.py ENV_GANG_*). The alloc
# annotation carries the same env as one JSON blob, but the downward API
# can only project a WHOLE annotation value into one env var — so the
# bind effector also writes each gang env key as its own annotation, and
# deploy/gang-job-example.yaml projects them 1:1 into container env.
GANG_ENV_TO_ANNO = {
    "TPU_KUBE_GANG_NUM_SLICES": ANNO_PREFIX + "gang-num-slices",
    "TPU_KUBE_GANG_SLICES": ANNO_PREFIX + "gang-slices",
    "TPU_KUBE_GANG_SLICE_INDEX": ANNO_PREFIX + "gang-slice-index",
}


def gang_env_annotations(env: dict[str, str]) -> dict[str, str]:
    """The per-key annotation projection of an alloc's gang env ({} for
    non-gang allocs — their pods get no gang annotations at all)."""
    return {
        anno: env[var]
        for var, anno in GANG_ENV_TO_ANNO.items()
        if var in env
    }


class CodecError(ValueError):
    pass


def _check_version(obj, what: str) -> None:
    if not isinstance(obj, dict):
        raise CodecError(f"{what}: payload must be a JSON object")
    v = obj.get("v")
    if v != SCHEMA_VERSION:
        raise CodecError(f"{what}: unsupported schema version {v!r}")


def _field(obj: dict, key: str, what: str):
    try:
        return obj[key]
    except (KeyError, TypeError) as e:
        raise CodecError(f"{what}: missing field {key!r}") from e


# -- node topology ---------------------------------------------------------

def encode_node_topology(node: NodeInfo, mesh: MeshSpec) -> str:
    """Serialize a node's chip inventory + the global mesh it sits in."""
    return json.dumps(
        {
            "v": SCHEMA_VERSION,
            "node": node.name,
            "slice": node.slice_id,
            "mesh": mesh.to_json(),
            "sharesPerChip": node.shares_per_chip,
            "chips": [
                {
                    "id": c.chip_id,
                    "index": c.index,
                    "coord": c.coord.as_list(),
                    "hbm": c.hbm_bytes,
                    "cores": c.num_cores,
                    "health": c.health.value,
                }
                for c in node.chips
            ],
            "badLinks": [
                [a.as_list(), b.as_list()] for a, b in node.bad_links
            ],
            **({"source": node.source} if node.source else {}),
        },
        separators=(",", ":"),
    )


def decode_node_topology(payload: str) -> tuple[NodeInfo, MeshSpec]:
    try:
        obj = json.loads(payload)
    except json.JSONDecodeError as e:
        raise CodecError(f"node-topology: bad JSON: {e}") from e
    _check_version(obj, "node-topology")
    try:
        mesh = MeshSpec.from_json(_field(obj, "mesh", "node-topology"))
    except (KeyError, TypeError, ValueError) as e:
        if isinstance(e, CodecError):
            raise
        raise CodecError(f"node-topology: malformed mesh: {e}") from e
    raw_chips = _field(obj, "chips", "node-topology")
    if not isinstance(raw_chips, list):
        raise CodecError("node-topology: 'chips' must be a list")
    try:
        chips = [
            ChipInfo(
                chip_id=c["id"],
                index=int(c["index"]),
                coord=TopologyCoord.of(c["coord"]),
                hbm_bytes=int(c["hbm"]),
                num_cores=int(c.get("cores", 2)),
                health=Health(c.get("health", "Healthy")),
            )
            for c in raw_chips
        ]
    except (KeyError, TypeError, ValueError) as e:
        raise CodecError(f"node-topology: malformed chip entry: {e}") from e
    try:
        shares = int(obj.get("sharesPerChip", 1))
    except (TypeError, ValueError) as e:
        raise CodecError(f"node-topology: bad sharesPerChip: {e}") from e
    if shares < 1:
        raise CodecError(f"node-topology: sharesPerChip must be >= 1, got {shares}")
    raw_links = obj.get("badLinks", [])
    if not isinstance(raw_links, list):
        raise CodecError("node-topology: 'badLinks' must be a list")
    try:
        bad_links = [canonical_link(a, b) for a, b in raw_links]
    except (TypeError, ValueError) as e:
        raise CodecError(f"node-topology: malformed badLinks entry: {e}") from e
    # A stale/buggy annotation carrying an out-of-mesh or non-adjacent pair
    # would otherwise flow silently into link-containment checks and veto
    # placements with no diagnostic; the C side (tpuinfo_inject_link_fault)
    # enforces adjacency, so enforce it here too (torus-aware).
    for a, b in bad_links:
        if not (mesh.contains(a) and mesh.contains(b)):
            raise CodecError(
                f"node-topology: badLinks endpoint outside mesh "
                f"{mesh.dims}: {[a.as_list(), b.as_list()]}"
            )
        if b not in mesh.neighbors(a):
            raise CodecError(
                f"node-topology: badLinks pair not ICI-adjacent: "
                f"{[a.as_list(), b.as_list()]}"
            )
    slice_id = obj.get("slice", DEFAULT_SLICE)
    if not isinstance(slice_id, str) or not slice_id:
        raise CodecError(f"node-topology: bad slice id {slice_id!r}")
    node = NodeInfo(
        name=_field(obj, "node", "node-topology"),
        chips=chips,
        shares_per_chip=shares,
        bad_links=bad_links,
        slice_id=slice_id,
        source=str(obj.get("source", "")),
    )
    return node, mesh


def annotate_node(node: NodeInfo, mesh: MeshSpec) -> dict[str, str]:
    return {
        ANNO_NODE_TOPOLOGY: encode_node_topology(node, mesh),
        ANNO_HEALTH_SUMMARY: encode_health_summary(health_summary(node)),
    }


# -- per-node health summary -------------------------------------------------

def chip_health_states(node: NodeInfo) -> dict[str, str]:
    """device id -> "healthy" | "degraded" | "unhealthy" for a node's
    whole chips. Degraded = the chip itself is up but touches a downed
    ICI link (its gang traffic rides a reduced path) — the state the
    fleet rollup and the telemetry sampler must agree on, so it is
    defined exactly once, here."""
    bad_ends = {c for link in node.bad_links for c in link}
    out: dict[str, str] = {}
    for chip in node.chips:
        if chip.health is not Health.HEALTHY:
            out[chip.device_id()] = "unhealthy"
        elif chip.coord in bad_ends:
            out[chip.device_id()] = "degraded"
        else:
            out[chip.device_id()] = "healthy"
    return out


def health_summary(node: NodeInfo) -> dict:
    """The compact summary document the node agent pushes upstream."""
    states = chip_health_states(node)
    return {
        "v": SCHEMA_VERSION,
        "node": node.name,
        "slice": node.slice_id,
        "healthy": sum(1 for s in states.values() if s == "healthy"),
        "degraded": sum(1 for s in states.values() if s == "degraded"),
        "unhealthy": sum(1 for s in states.values() if s == "unhealthy"),
        "badLinks": len(node.bad_links),
        "chips": states,
    }


def encode_health_summary(summary: dict) -> str:
    return json.dumps(summary, separators=(",", ":"), sort_keys=True)


def decode_health_summary(payload: str) -> dict:
    try:
        obj = json.loads(payload)
    except json.JSONDecodeError as e:
        raise CodecError(f"health-summary: bad JSON: {e}") from e
    _check_version(obj, "health-summary")
    for key in ("healthy", "degraded", "unhealthy"):
        if not isinstance(obj.get(key), int):
            raise CodecError(f"health-summary: missing/bad count {key!r}")
    return obj


def node_from_annotations(
    name: str, annotations: dict[str, str]
) -> Optional[tuple[NodeInfo, MeshSpec]]:
    payload = annotations.get(ANNO_NODE_TOPOLOGY)
    if payload is None:
        return None
    node, mesh = decode_node_topology(payload)
    if node.name != name:
        raise CodecError(
            f"node-topology annotation names {node.name!r} but lives on {name!r}"
        )
    node.annotations = dict(annotations)
    return node, mesh


# -- allocation result -----------------------------------------------------

def alloc_obj(alloc: AllocResult) -> dict:
    """The alloc payload's object form (see ``alloc_from_obj``)."""
    obj = {
        "v": SCHEMA_VERSION,
        "pod": alloc.pod_key,
        "node": alloc.node_name,
        "devices": alloc.device_ids,
        "coords": [c.as_list() for c in alloc.coords],
        "env": alloc.env,
        "priority": alloc.priority,
    }
    if alloc.uid:
        # optional, not a schema bump: pre-UID decoders ignore it, and
        # pre-UID payloads decode to uid="" (name-only semantics)
        obj["uid"] = alloc.uid
    return obj


def encode_alloc(alloc: AllocResult) -> str:
    return json.dumps(alloc_obj(alloc), separators=(",", ":"))


def decode_alloc(payload: str) -> AllocResult:
    try:
        obj = json.loads(payload)
    except json.JSONDecodeError as e:
        raise CodecError(f"alloc: bad JSON: {e}") from e
    _check_version(obj, "alloc")
    return alloc_from_obj(obj)


def alloc_from_obj(obj: dict) -> AllocResult:
    """An AllocResult from the alloc payload's PARSED object form (the
    wire decoder above shares this construction)."""
    try:
        return AllocResult(
            pod_key=_field(obj, "pod", "alloc"),
            node_name=_field(obj, "node", "alloc"),
            device_ids=list(_field(obj, "devices", "alloc")),
            coords=[TopologyCoord.of(c) for c in obj.get("coords", [])],
            env=dict(obj.get("env", {})),
            priority=int(obj.get("priority", 0)),
            uid=str(obj.get("uid", "")),
        )
    except CodecError:
        raise
    except (TypeError, ValueError) as e:
        raise CodecError(f"alloc: malformed payload: {e}") from e


# -- pod group -------------------------------------------------------------

def pod_group_annotations(group: PodGroup) -> dict[str, str]:
    out = {
        ANNO_POD_GROUP: group.name,
        ANNO_POD_GROUP_MIN_MEMBER: str(group.min_member),
    }
    if group.shape is not None:
        out[ANNO_POD_GROUP_SHAPE] = "x".join(str(s) for s in group.shape)
    if group.allow_dcn:
        out[ANNO_POD_GROUP_ALLOW_DCN] = "true"
    return out


def pod_group_from_annotations(annotations: dict[str, str]) -> Optional[PodGroup]:
    name = annotations.get(ANNO_POD_GROUP)
    if not name:
        return None
    try:
        min_member = int(annotations.get(ANNO_POD_GROUP_MIN_MEMBER, "1"))
    except ValueError as e:
        raise CodecError("pod-group-min-member not an int") from e
    if min_member < 1:
        raise CodecError(f"pod-group-min-member must be >= 1, got {min_member}")
    shape_s = annotations.get(ANNO_POD_GROUP_SHAPE)
    shape = None
    if shape_s:
        parts = shape_s.split("x")
        if len(parts) not in (1, 2, 3) or not all(p.isdigit() for p in parts):
            raise CodecError(f"bad pod-group-shape {shape_s!r}")
        vals = [int(p) for p in parts] + [1, 1]
        shape = (vals[0], vals[1], vals[2])
        if any(v < 1 for v in shape):
            raise CodecError(f"pod-group-shape dims must be >= 1: {shape_s!r}")
    allow_dcn = annotations.get(ANNO_POD_GROUP_ALLOW_DCN, "").lower() in (
        "1", "true", "yes"
    )
    if allow_dcn and shape is not None:
        raise CodecError(
            "pod-group-allow-dcn is incompatible with pod-group-shape "
            "(a shape names one contiguous box)"
        )
    return PodGroup(
        name=name, min_member=min_member, shape=shape, allow_dcn=allow_dcn
    )


def attach_group(pod: PodInfo) -> PodInfo:
    """Populate pod.group from its annotations (idempotent)."""
    if pod.group is None:
        pod.group = pod_group_from_annotations(pod.annotations)
    return pod
