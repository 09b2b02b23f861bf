"""reservation-leak: every path from a reservation / preemption-plan
acquire to function exit must reach commit, rollback, or an explicit
hand-off — exception edges included.

The crash-safety story (scenarios 8-9: zero leaked reservations,
zero ledger divergence) rests on a handful of functions each upholding
"acquire then settle on ALL exits" by hand: ``Extender.bind`` releases
its ledger commit on every error path, ``_execute_pending_preemption``
never drops a claimed eviction plan, ``GangManager.restore`` ends every
restart in a reservation or ``rollback_all``. Those invariants are
path properties over exception edges — exactly what the example-based
chaos tests probe but cannot prove. This pass checks them per function
against the registry below, on the CFG engine (``analysis/cfg.py``).

Per registered function:

  * **acquire** — a call (matched by name) or a store to a declared
    attribute that takes ownership of the resource;
  * **settle** — a call or store that commits, rolls back, or hands it
    off;
  * ``on_return`` / ``on_raise`` — whether reaching the normal-return
    exit (resp. the exception exit) WITHOUT settling is a leak. A
    normal return is often the hand-off itself (``bind`` returns the
    committed alloc; ``ensure_reservation`` returns the stored
    reservation), so it is opt-in per function; exception exits are
    the classic leak edge and default to checked.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from tpukube_torch.analysis import callgraph, cfg
from tpukube_torch.analysis.base import Finding, SourceFile


@dataclass(frozen=True)
class LeakSpec:
    """One function's acquire/settle contract."""

    acquires: frozenset[str] = frozenset()
    acquire_stores: frozenset[str] = frozenset()
    settles: frozenset[str] = frozenset()
    settle_stores: frozenset[str] = frozenset()
    on_return: bool = False
    on_raise: bool = True
    why: str = ""


#: (path suffix, class, function) -> LeakSpec. These are the functions
#: whose hand-rolled settle-on-all-exits discipline the chaos suite's
#: zero-leak assertions depend on; add an entry when a new acquire
#: path appears.
LEAK_REGISTRY: dict[tuple[str, str, str], LeakSpec] = {
    ("sched/extender.py", "Extender", "bind"): LeakSpec(
        acquires=frozenset({"commit"}),
        settles=frozenset({"release"}),
        on_return=False, on_raise=True,
        why="an exception escaping after state.commit leaks the pod's "
            "chips until restart — release on every error path "
            "(the normal return hands the committed alloc off)",
    ),
    ("sched/extender.py", "Extender", "_execute_pending_preemption"): LeakSpec(
        acquires=frozenset({"take_pending_victims"}),
        settles=frozenset({"_apply_victims"}),
        on_return=True, on_raise=True,
        why="take_pending_victims atomically CLAIMS the eviction plan; "
            "a path that drops it leaves the reservation pending "
            "forever with victims that will never be evicted",
    ),
    ("sched/extender.py", "Extender", "_try_preemption"): LeakSpec(
        acquires=frozenset({"find_preemption_plan",
                            "_plan_split_preemption"}),
        settles=frozenset({"reserve_exact", "reserve_exact_split"}),
        on_return=True, on_raise=False,
        why="a preemption plan must be handed to reserve_exact[_split] "
            "so its victims ride the reservation (raising discards it "
            "safely — nothing was executed)",
    ),
    ("sched/gang.py", "GangManager", "restore"): LeakSpec(
        acquires=frozenset({"slice_of_node"}),
        settles=frozenset({"rollback_all"}),
        settle_stores=frozenset({"_reservations"}),
        on_return=True, on_raise=True,
        why="a restart restore must end in a stored reservation or "
            "rollback_all — anything else strands running gang members "
            "as individually evictable strays (partial gang death)",
    ),
    ("sched/gang.py", "GangManager", "ensure_reservation"): LeakSpec(
        acquire_stores=frozenset({"_reservations"}),
        on_return=False, on_raise=True,
        why="an exception after the reservation is stored masks its "
            "chips until TTL while the caller never learns it exists",
    ),
    ("sched/gang.py", "GangManager", "reserve_exact_split"): LeakSpec(
        acquire_stores=frozenset({"_reservations"}),
        on_return=False, on_raise=True,
        why="an exception after the preemption reservation is stored "
            "masks its chips until TTL while the caller never learns "
            "it exists",
    ),
}


def _call_names(stmt: ast.AST) -> set[str]:
    out: set[str] = set()
    for n in cfg.shallow_walk(stmt):
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Attribute):
                out.add(n.func.attr)
            elif isinstance(n.func, ast.Name):
                out.add(n.func.id)
    return out


def _store_attrs(stmt: ast.AST, attrs: frozenset[str]) -> set[str]:
    from tpukube_torch.analysis.epochs import flatten_targets

    out: set[str] = set()
    if not attrs:
        return out
    for n in cfg.shallow_walk(stmt):
        targets: list[ast.AST] = []
        if isinstance(n, ast.Assign):
            targets = list(n.targets)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets = [n.target]
        # tuple/list unpacking stores the attr exactly like the plain
        # form — flatten so it cannot evade the acquire/settle match
        for t in flatten_targets(targets):
            if isinstance(t, ast.Subscript):
                t = t.value
            a = cfg._self_attr(t)
            if a in attrs:
                out.add(a)
    return out


def _acquire_desc(stmt: ast.AST, spec: LeakSpec) -> Optional[str]:
    calls = _call_names(stmt) & spec.acquires
    if calls:
        return f"{sorted(calls)[0]}()"
    stores = _store_attrs(stmt, spec.acquire_stores)
    if stores:
        return f"store to self.{sorted(stores)[0]}"
    return None


def check_leaks(sf: SourceFile,
                registry: Optional[dict] = None) -> list[Finding]:
    table = registry if registry is not None else LEAK_REGISTRY
    specs: dict[tuple[str, str], LeakSpec] = {
        (cls, func): spec for (sfx, cls, func), spec in table.items()
        if sf.in_scope((sfx,))
    }
    if not specs:
        return []
    findings: list[Finding] = []
    emitted: set[tuple[int, str]] = set()

    def emit(line: int, message: str) -> None:
        if (line, message) not in emitted:
            emitted.add((line, message))
            findings.append(Finding("reservation-leak", sf.rel, line,
                                    message))

    for cls_node in sf.tree.body:
        if not isinstance(cls_node, ast.ClassDef):
            continue
        cg = callgraph.ClassGraph(cls_node)
        for fn in cls_node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            spec = specs.get((cls_node.name, fn.name))
            if spec is None:
                continue
            g = cfg.build_cfg(fn)

            def _settle_stmt(stmt: ast.AST) -> bool:
                if _call_names(stmt) & spec.settles:
                    return True
                return bool(_store_attrs(stmt, spec.settle_stores))

            # one-level delegation: a call to an intra-class helper
            # whose direct statements settle on every exit settles
            # for the caller (a two-level chain does not)
            lifted = callgraph.delegating_satisfier(
                cg, _settle_stmt, exclude=(fn.name,))

            def settles(node: cfg.Node) -> bool:
                return node.stmt is not None and lifted(node.stmt)

            for node in g.nodes:
                if node.stmt is None:
                    continue
                desc = _acquire_desc(node.stmt, spec)
                if desc is None:
                    continue
                rets, rzs = cfg.escapes_function(g, node, settles)
                want = sorted(
                    spec.settles | {f"self.{a}[...] = ..."
                                    for a in spec.settle_stores}
                ) or ["(none declared — no exit may skip the hand-off)"]
                if spec.on_return and rets:
                    emit(node.line, (
                        f"path from {desc} in {cls_node.name}.{fn.name} "
                        f"reaches a normal return (near line "
                        f"{rets[0].line}) without settling via "
                        f"{', '.join(want)} — {spec.why}"))
                if spec.on_raise and rzs:
                    emit(node.line, (
                        f"exception path from {desc} in "
                        f"{cls_node.name}.{fn.name} escapes the function "
                        f"(near line {rzs[0].line}) without settling via "
                        f"{', '.join(want)} — {spec.why}"))
    return findings
