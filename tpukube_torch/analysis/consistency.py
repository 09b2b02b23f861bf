"""name-consistency: every event reason, metric series name, and
``deploy/prometheus-rules.yaml`` metric reference must resolve against
the DECLARED registries — ``tpukube_torch.obs.events.REASONS`` and
``tpukube_torch.obs.registry.DECLARED_SERIES``.

This extends the exposition-time promlint (which scrapes live
/metrics) to the SOURCE level: a typo'd ``emit("GangComited")``
or a renamed series fails lint before any process runs, and a rules-file
expression referencing a series nobody renders fails before the alert
silently goes blind. Only string LITERALS are checked — forwarding
wrappers passing a ``reason`` variable are the call sites' problem, and
the call sites are literals.

The cross-check runs BOTH directions: the forward pass
above catches a constructor naming an undeclared series; the reverse
pass (``_check_registry_rot``) catches registry rot — a series or
reason that stays DECLARED after its last render/emit site was
deleted. A rotted declaration is worse than a missing one: the
rules-file check keeps passing (the name resolves), so the alert
reading it goes blind without any lint noise. Audited against the
registries the federated-observability and capacity PRs grew
(``tpukube_replica_*``, ``tpukube_capacity_*``,
``tpukube_cycle_queue_age_seconds``): all declared entries have live
reference sites as of this pass's introduction.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Optional

from tpukube_torch.analysis.base import (
    Finding,
    SourceFile,
    literal_strings,
)

#: call names whose first str-literal arg (or reason=) is an event reason
EMIT_CALLS = {"emit", "_emit", "_emit_event"}

#: registry builder methods / metric constructors whose first
#: str-literal arg is a series family name
METRIC_CALLS = {
    "counter", "gauge", "summary", "histogram",
    "Counter", "Gauge", "Summary", "Histogram",
}

#: suffixes a TYPE'd family implies (rules expressions reference these)
DERIVED_SUFFIXES = ("_bucket", "_count", "_sum")

#: the only modules allowed to construct occupancy grids / sweeps:
#: the epoch-cached snapshot (which owns the per-cycle instances and
#: the one ad-hoc seam, ``sweep_for``) and slicefit itself (the
#: primitive definitions plus their grid-based thin wrappers)
SNAPSHOT_HOME = ("sched/snapshot.py", "sched/slicefit.py")

#: constructor names the snapshot-discipline pass polices
SWEEP_CONSTRUCTORS = frozenset({"occupancy_grid", "_Sweep"})

#: the batch planner: its whole contract is ONE pinned
#: snapshot per cycle, taken through the ``_pin_snapshot`` seam — any
#: other SnapshotCache read (or ad-hoc sweep) inside it forks the
#: cluster view mid-batch and the plan silently stops being the thing
#: /filter, /prioritize, and /bind answer from
CYCLE_HOME = "sched/cycle.py"
CYCLE_PIN_SEAM = "_pin_snapshot"

#: call names that read a SnapshotCache (checked only when invoked on
#: an attribute chain mentioning ``snapshots``, so e.g. a histogram's
#: ``observe()`` is not confused for a cache read)
CYCLE_CACHE_READS = frozenset({"current", "observe"})

#: the ad-hoc grid seam — flagged in cycle.py wherever it appears
CYCLE_GRID_BUILDERS = frozenset({"sweep_for"})


def _call_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _literal_arg(call: ast.Call, kwarg: str) -> Optional[str]:
    for kw in call.keywords:
        if kw.arg == kwarg and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


#: (path suffix, declared-registry variable) -> what its entries are.
#: The reverse audit fires when linting the DECLARING file and scans
#: the package tree (the declaring file's grandparent directory) for
#: reference sites.
_REGISTRY_DECLS: dict[str, tuple[str, str]] = {
    "obs/registry.py": ("DECLARED_SERIES", "metric series"),
    "obs/events.py": ("REASONS", "event reason"),
}


def _declared_entries(sf: SourceFile, var: str) -> list[tuple[int, str]]:
    """(line, value) per string literal inside the module-level
    ``var = (... | {...})`` declaration — parsed from the AST, not
    imported, so fixture registries work."""
    for node in sf.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if not any(isinstance(t, ast.Name) and t.id == var
                   for t in targets):
            continue
        return [
            (n.lineno, n.value) for n in ast.walk(node.value)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
        ]
    return []


def _check_registry_rot(sf: SourceFile) -> list[Finding]:
    """The reverse cross-check: every declared series/reason must have
    at least one string-literal reference SOMEWHERE ELSE in the package
    tree. Deleting a render/emit site without retiring the declaration
    leaves dashboards and prometheus-rules reading a name nothing
    serves — the rules-file check alone cannot catch that (the name
    still resolves against the registry)."""
    decl = None
    for sfx, (var, what) in _REGISTRY_DECLS.items():
        if sf.in_scope((sfx,)):
            decl = (var, what)
            break
    if decl is None:
        return []
    var, what = decl
    entries = _declared_entries(sf, var)
    if not entries:
        return []
    root = sf.path.resolve().parent.parent
    own = sf.path.resolve()
    referenced: set = set()
    for f in sorted(root.rglob("*.py")):
        if f.resolve() == own or f.name.endswith("_pb2.py"):
            continue
        referenced |= literal_strings(f)
    findings: list[Finding] = []
    for line, value in entries:
        if value not in referenced:
            findings.append(Finding(
                "name-consistency", sf.rel, line,
                f"{what} {value!r} is declared in {var} but no module "
                f"in the package references it — the render/emit site "
                f"is gone; retire the declaration (a rotted entry keeps "
                f"rules-file expressions resolving against a series "
                f"nothing serves)",
            ))
    return findings


def check_names(sf: SourceFile) -> list[Finding]:
    from tpukube_torch.obs.events import REASONS
    from tpukube_torch.obs.registry import DECLARED_SERIES

    findings: list[Finding] = list(_check_registry_rot(sf))
    for node in sf.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in EMIT_CALLS:
            reason = _literal_arg(node, "reason")
            if reason is not None and reason not in REASONS:
                findings.append(Finding(
                    "name-consistency", sf.rel, node.lineno,
                    f"event reason {reason!r} is not declared in "
                    f"tpukube_torch.obs.events.REASONS — add it there (and to "
                    f"the journal docstring) or fix the typo",
                ))
        elif name in METRIC_CALLS:
            series = _literal_arg(node, "name")
            if series is not None and series not in DECLARED_SERIES:
                findings.append(Finding(
                    "name-consistency", sf.rel, node.lineno,
                    f"metric series {series!r} is not declared in "
                    f"tpukube_torch.obs.registry.DECLARED_SERIES — declare it "
                    f"(dashboards and prometheus-rules key off the "
                    f"registry) or fix the typo",
                ))
    return findings


def check_snapshot_discipline(sf: SourceFile) -> list[Finding]:
    """Constructing ``occupancy_grid``/``_Sweep`` outside
    ``sched/snapshot.py`` (and slicefit's own wrappers) is a finding:
    the whole point of the epoch-cached scheduling snapshot
    is that webhook cycles share ONE derived-state build per epoch — a
    call site quietly rebuilding sweeps per request reintroduces the
    O(volume x shapes x origins) hot path without failing any test.
    Route cluster-state sweeps through ``SnapshotCache.current()`` and
    request-specific grids through ``snapshot.sweep_for`` (tests are
    not linted and stay exempt).

    The batch planner (``sched/cycle.py``) is held to a
    STRICTER contract: a batch-plan consumer may not construct any
    ad-hoc snapshot view at all — no ``SnapshotCache.current()`` /
    ``observe()`` read and no ``sweep_for()`` grid outside the one
    pinning seam (``_pin_snapshot``). The whole point of a cycle is
    that every pod in the batch plans against ONE epoch-pinned
    snapshot; a second read mid-module forks the cluster view and the
    plan silently stops being what the webhooks answer from."""
    if sf.in_scope(SNAPSHOT_HOME):
        return []
    if sf.in_scope((CYCLE_HOME,)):
        return _check_cycle_snapshot_reads(sf)
    findings: list[Finding] = []
    for node in sf.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node)
        if name in SWEEP_CONSTRUCTORS:
            findings.append(Finding(
                "snapshot-discipline", sf.rel, node.lineno,
                f"{name}() constructed outside sched/snapshot.py — "
                f"read the epoch-cached snapshot "
                f"(SnapshotCache.current()) or build request-specific "
                f"grids through snapshot.sweep_for() so the per-cycle "
                f"cache cannot silently rot",
            ))
    return findings


def _check_cycle_snapshot_reads(sf: SourceFile) -> list[Finding]:
    """The cycle-module arm of snapshot-discipline: walk with the
    enclosing function tracked, flagging sweep constructors AND cache
    reads everywhere except the pinning seam."""
    findings: list[Finding] = []

    def on_snapshots(call: ast.Call) -> bool:
        fn = call.func
        while isinstance(fn, ast.Attribute):
            fn = fn.value
            if isinstance(fn, ast.Attribute) and fn.attr == "snapshots":
                return True
        return isinstance(fn, ast.Name) and fn.id == "snapshots"

    def visit(node: ast.AST, func: Optional[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        elif isinstance(node, ast.Call):
            name = _call_name(node)
            bad = (name in SWEEP_CONSTRUCTORS
                   or name in CYCLE_GRID_BUILDERS
                   or (name in CYCLE_CACHE_READS
                       and on_snapshots(node)
                       and func != CYCLE_PIN_SEAM))
            if bad:
                findings.append(Finding(
                    "snapshot-discipline", sf.rel, node.lineno,
                    f"{name}() in the batch planner outside the "
                    f"{CYCLE_PIN_SEAM} seam — batch-plan consumers must "
                    f"use the cycle's ONE pinned snapshot; a second "
                    f"cache read or ad-hoc sweep mid-batch forks the "
                    f"cluster view the plan was built against",
                ))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(sf.tree, None)
    return findings


def rule_expressions(path) -> list[tuple[dict, str]]:
    """(rule, expression) for every rule of a prometheus-rules.yaml,
    read by the narrow reader (``rulesyaml``: no YAML library needed;
    ``ValueError`` on a form outside its subset)."""
    from tpukube_torch.analysis import rulesyaml

    path = Path(path)
    out: list[tuple[dict, str]] = []
    for doc in rulesyaml.load_all(path.read_text(), str(path)):
        if not isinstance(doc, dict):
            continue
        for group in (doc.get("spec") or {}).get("groups", ()):
            for rule in group.get("rules", ()):
                out.append((rule, rule.get("expr", "")))
    return out


def check_rules_file(path) -> list[Finding]:
    """Every metric name a prometheus-rules.yaml expression reads must
    be a declared series (or a declared family's _bucket/_count/_sum).
    Recording-rule names (containing ':') are skipped by the shared
    PromQL name extractor in tpukube_torch.obs.slo."""
    from tpukube_torch.obs.registry import DECLARED_SERIES
    from tpukube_torch.obs.slo import referenced_metric_names

    path = Path(path)
    text = path.read_text()
    findings: list[Finding] = []
    for rule, expr in rule_expressions(path):
        for name in sorted(referenced_metric_names(expr)):
            base = name
            for suffix in DERIVED_SUFFIXES:
                if name.endswith(suffix) \
                        and name[: -len(suffix)] in DECLARED_SERIES:
                    base = name[: -len(suffix)]
                    break
            if base in DECLARED_SERIES:
                continue
            # anchor to the first textual occurrence for a clickable
            # location
            idx = text.find(name)
            line = text.count("\n", 0, idx) + 1 if idx >= 0 else 1
            findings.append(Finding(
                "name-consistency", str(path), line,
                f"rule {rule.get('record') or rule.get('alert')!r}"
                f" references series {name!r}, which is not in "
                f"tpukube_torch.obs.registry.DECLARED_SERIES — no "
                f"registry renders it, so the rule reads nothing",
            ))
    return findings
