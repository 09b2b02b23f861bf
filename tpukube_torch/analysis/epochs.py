"""epoch-discipline: every mutation of a declared snapshot seam must be
followed by an epoch bump on every path before the enclosing lock's
``with`` exits.

The snapshot cache makes scheduling correctness hinge on a manual invariant: the
epoch-cached :class:`~tpukube_torch.sched.snapshot.SnapshotCache` keys its
validity on ``ClusterState.epoch()`` / ``GangManager.epoch()``, so a
mutation path that forgets ``self._epoch += 1`` serves STALE PLACEMENTS
— silently, because the example-based invalidation tests only cover the
seams that existed when they were written. This pass machine-checks the
invariant over the registry below: a new mutation seam added without a
bump is a lint failure at review time, not a stale-cache heisenbug in
production. The runtime counterpart (``snapshot_audit_rate``, the
SnapshotCache audit sentinel) catches whatever the registry itself
misses.

What counts as a seam event inside a registered class:

  * a write (assign / augmented assign / ``del``) to a declared seam
    attribute of ``self`` — plain or subscripted
    (``self._allocs[k] = v``);
  * a mutating method call on a declared seam attribute
    (``self._reservations.pop(...)``); reads (``.get``, ``.values``,
    iteration) are not events;
  * a call to a registered mutator method name on ANY receiver
    (``res.record_assignment(...)``, ``view.add_ids(...)``) — these
    mutate reservation/occupancy state the snapshot derives from.

The bump is ``self._epoch += 1``. The enclosing region is the outermost
``with self.<lock>`` containing the seam (re-entrant locks release at
the outermost exit); in a ``*_locked`` helper — documented as called
with the lock held — the region is the whole function body, so the
bump must dominate every function exit instead. A seam outside both is
itself a finding (the epoch contract is only sound under the lock).

Helper methods that bump INTERNALLY (``_rollback_locked``,
``_evict_and_mask_locked``, ``ClusterState.commit``) are deliberately
NOT registered as mutators: their callers need no second bump, and
their own bodies are checked like any other function.

The bump predicate is interprocedural ONE level via
:mod:`tpukube_torch.analysis.callgraph`: a statement calling an intra-class
helper whose own DIRECT statements bump on every exit counts as a
bump for the caller — ``self._register_and_bump_locked(...)``
satisfies the seam it follows. The helper summary uses direct bumps
only, so a two-level chain (helper delegating to a sub-helper that
bumps) is rejected by design.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from tpukube_torch.analysis import callgraph, cfg
from tpukube_torch.analysis.base import Finding, SourceFile

#: methods that mutate the receiver when called on a seam attribute
MUTATING_METHODS = frozenset({
    "pop", "popitem", "append", "appendleft", "add", "discard", "remove",
    "clear", "update", "setdefault", "extend", "insert",
    "difference_update", "intersection_update",
    "symmetric_difference_update",
})


@dataclass(frozen=True)
class SeamSpec:
    """One class's epoch contract."""

    lock_attr: str
    seam_attrs: frozenset[str]
    mutator_calls: frozenset[str]
    bump_attr: str = "_epoch"


#: (path suffix, class) -> SeamSpec. Growing ClusterState/GangManager a
#: new snapshot-feeding structure means declaring it here — the pass
#: then enforces the bump discipline everywhere it is mutated.
#:
#: sched/snapshot.py joined the registry the day it grew a mutation-
#: application seam: the delta
#: advance WRITES the cached-snapshot slot, and every such write must
#: pair with a ``_snap_gen`` bump under the cache's leaf mutex — the
#: statically-proven invariant that the cached slot never changes
#: without its generation (and therefore the observably-served key)
#: moving in the same locked region. The cache still owns no EPOCH of
#: its own; ``_snap_gen`` is the slot-generation counter its stats
#: report.
EPOCH_REGISTRY: dict[tuple[str, str], SeamSpec] = {
    ("sched/state.py", "ClusterState"): SeamSpec(
        lock_attr="_lock",
        # _cordoned joined with the drain plane: the cordon
        # set feeds the snapshot's placement mask, so a cordon flip
        # without a bump serves stale sweeps exactly like a node write
        seam_attrs=frozenset({"_nodes", "_allocs", "_slices",
                              "_cordoned"}),
        mutator_calls=frozenset({"add_ids", "remove_ids"}),
    ),
    ("sched/gang.py", "GangManager"): SeamSpec(
        lock_attr="_lock",
        seam_attrs=frozenset({"_reservations", "_terminating_coords"}),
        mutator_calls=frozenset({"record_assignment", "drop_assignment"}),
    ),
    ("sched/snapshot.py", "SnapshotCache"): SeamSpec(
        lock_attr="_lock",
        seam_attrs=frozenset({"_snap"}),
        mutator_calls=frozenset(),
        bump_attr="_snap_gen",
    ),
}

def flatten_targets(targets: list) -> list[ast.AST]:
    """Assignment targets with tuple/list/starred unpacking expanded:
    ``self._reservations[k], old = ...`` writes the seam exactly like
    the plain form and must not evade the pass."""
    out: list[ast.AST] = []
    stack = list(targets)
    while stack:
        t = stack.pop()
        if isinstance(t, (ast.Tuple, ast.List)):
            stack.extend(t.elts)
        elif isinstance(t, ast.Starred):
            stack.append(t.value)
        else:
            out.append(t)
    return out


def _seam_write_target(t: ast.AST, attrs: frozenset[str]) -> Optional[str]:
    """self.<attr> or self.<attr>[...] as an assignment/delete target."""
    if isinstance(t, ast.Subscript):
        t = t.value
    return cfg._self_attr(t) if cfg._self_attr(t) in attrs else None


def seam_events(stmt: ast.AST, spec: SeamSpec) -> list[str]:
    """Human-readable descriptions of the seam mutations one statement
    performs (empty = not a seam). Never descends into nested defs."""
    out: list[str] = []
    for n in cfg.shallow_walk(stmt):
        targets: list[ast.AST] = []
        if isinstance(n, ast.Assign):
            targets = list(n.targets)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets = [n.target]
        elif isinstance(n, ast.Delete):
            targets = list(n.targets)
        for t in flatten_targets(targets):
            attr = _seam_write_target(t, spec.seam_attrs)
            if attr is not None:
                out.append(f"write to self.{attr}")
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            fn = n.func
            if fn.attr in spec.mutator_calls:
                out.append(f"{fn.attr}() call")
            if fn.attr in MUTATING_METHODS:
                recv = cfg._self_attr(fn.value)
                if recv in spec.seam_attrs:
                    out.append(f"self.{recv}.{fn.attr}()")
    return out


def _is_bump(stmt: ast.AST, spec: SeamSpec) -> bool:
    for n in cfg.shallow_walk(stmt):
        if (isinstance(n, ast.AugAssign)
                and isinstance(n.op, ast.Add)
                and cfg._self_attr(n.target) == spec.bump_attr):
            return True
    return False


def check_epochs(sf: SourceFile,
                 registry: Optional[dict] = None) -> list[Finding]:
    table = registry if registry is not None else EPOCH_REGISTRY
    specs = {cls: spec for (sfx, cls), spec in table.items()
             if sf.in_scope((sfx,))}
    if not specs:
        return []
    findings: list[Finding] = []
    emitted: set[tuple[int, str]] = set()

    def emit(line: int, message: str) -> None:
        # finally-instantiated duplicates report the same (line, msg)
        if (line, message) not in emitted:
            emitted.add((line, message))
            findings.append(Finding("epoch-discipline", sf.rel, line,
                                    message))

    for cls_node in sf.tree.body:
        if not isinstance(cls_node, ast.ClassDef):
            continue
        spec = specs.get(cls_node.name)
        if spec is None:
            continue
        cg = callgraph.ClassGraph(cls_node)
        for fn in cls_node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue  # no concurrency yet; the seed writes are free
            g = cfg.build_cfg(fn, lock_attrs={spec.lock_attr})
            seams = [(n, seam_events(n.stmt, spec)) for n in g.nodes
                     if n.stmt is not None]
            seams = [(n, ev) for n, ev in seams if ev]
            if not seams:
                continue

            # one-level delegation: a call to an intra-class helper
            # whose direct statements bump on every exit is a bump
            lifted = callgraph.delegating_satisfier(
                cg, lambda stmt: _is_bump(stmt, spec),
                exclude=(fn.name,))

            def bump(node: cfg.Node) -> bool:
                return node.stmt is not None and lifted(node.stmt)

            for node, events in seams:
                what = " + ".join(sorted(set(events)))
                rid = g.outermost_region(node, spec.lock_attr)
                if rid is None:
                    if fn.name.endswith("_locked"):
                        rets, rzs = cfg.escapes_function(g, node, bump)
                        for w in rets + rzs:
                            emit(node.line, (
                                f"mutation seam ({what}) in "
                                f"{cls_node.name}.{fn.name} is not "
                                f"followed by `self.{spec.bump_attr} += 1`"
                                f" on every path to function exit "
                                f"(escape near line {w.line}) — a missed "
                                f"bump serves stale snapshots"))
                            break
                    else:
                        emit(node.line, (
                            f"mutation seam ({what}) outside `with "
                            f"self.{spec.lock_attr}` in "
                            f"{cls_node.name}.{fn.name} — the epoch "
                            f"contract is only sound under the lock "
                            f"(or in a *_locked helper)"))
                    continue
                escapes = cfg.escapes_region(g, node, rid, bump)
                if escapes:
                    u, _ = escapes[0]
                    emit(node.line, (
                        f"mutation seam ({what}) in "
                        f"{cls_node.name}.{fn.name} is not followed by "
                        f"`self.{spec.bump_attr} += 1` on every path "
                        f"before the `with self.{spec.lock_attr}` region "
                        f"(line {g.regions[rid].line}) exits (escape "
                        f"near line {u.line}) — a missed bump serves "
                        f"stale snapshots"))
    return findings
