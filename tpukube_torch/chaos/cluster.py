"""Convergence checks of a sim cluster — the port's own copies of
``leaked_reservations`` and ``ledger_divergence`` from
``tpukube/chaos/cluster.py``: zero leaked gang reservations and zero
divergence between the extender's ledger and the pod store."""

from __future__ import annotations

from typing import Any

from tpukube_torch.apiserver import TERMINAL_PHASES
from tpukube_torch.core import codec


def leaked_reservations(cluster) -> list[dict[str, Any]]:
    """Gang reservations that can never complete: uncommitted with zero
    assigned members (a committed gang or one mid-assembly with live
    members is fine — TTL or later binds own those)."""
    leaks = []
    for g in cluster.extender.gang_snapshot():
        if not g["committed"] and g["members_bound"] == 0:
            leaks.append(g)
    return leaks


def ledger_divergence(cluster) -> list[str]:
    """Cross-check the extender's ledger against the pod store (the
    sim's apiserver ground truth). Returns human-readable divergences;
    [] is the scenario acceptance criterion.

      * every live, bound, non-terminal pod with an alloc annotation
        must hold a matching ledger entry (node + device ids);
      * every ledger entry must point at such a pod.

    Terminal-phase pods and unbound pods with annotation residue are
    skipped — those are exactly the states the rebuild/lifecycle
    machinery is documented to skip or release."""
    problems: list[str] = []
    ledger = {a.pod_key: a for a in cluster.extender.state.allocations()}
    seen: set[str] = set()
    for key, pod in sorted(cluster.pods.items()):
        annos = (pod.get("metadata") or {}).get("annotations") or {}
        payload = annos.get(codec.ANNO_ALLOC)
        bound = (pod.get("spec") or {}).get("nodeName")
        phase = (pod.get("status") or {}).get("phase")
        if not payload or not bound or phase in TERMINAL_PHASES:
            continue
        try:
            planned = codec.decode_alloc(payload)
        except codec.CodecError as e:
            problems.append(f"{key}: undecodable alloc annotation: {e}")
            continue
        seen.add(key)
        entry = ledger.get(key)
        if entry is None:
            problems.append(
                f"{key}: bound to {bound} with an alloc annotation but "
                f"absent from the ledger"
            )
            continue
        if entry.node_name != bound:
            problems.append(
                f"{key}: ledger says node {entry.node_name}, pod is "
                f"bound to {bound}"
            )
        if sorted(entry.device_ids) != sorted(planned.device_ids):
            problems.append(
                f"{key}: ledger devices {sorted(entry.device_ids)} != "
                f"annotation devices {sorted(planned.device_ids)}"
            )
    for key in sorted(set(ledger) - seen):
        problems.append(
            f"{key}: in the ledger but no live bound pod carries its "
            f"alloc annotation"
        )
    return problems
