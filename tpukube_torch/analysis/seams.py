"""seam-triple: every epoch bump in the ledger/gang classes must pair
with a delta note AND a journal note on every CFG path before the
lock region exits.

epoch-discipline proves the epoch half (mutation -> bump); this pass proves the
other two thirds of the seam the tree actually writes today:

  * ``self._note_delta_locked(...)`` — the snapshot delta chain is
    CONTIGUOUS (``sched/snapshot.py`` returns None on the first gap),
    so an epoch increment without a delta note silently degrades every
    later cache hit into an O(chips) full rebuild: a performance bug
    no functional test fails on;
  * ``self._note_journal_locked(...)`` — a bump whose mutation never
    reaches the WAL is a recovery-divergence bug: the live process
    and its restarted twin disagree about state the epoch said
    changed.

Per bump (``self._epoch += 1``) in a registered class: find the
outermost ``with self.<lock>`` region (or, in a ``*_locked`` helper,
treat the whole body as the region) and require that every path from
the bump passes a delta-note call and a journal-note call before the
region exits. Replay/restore functions are journal-EXEMPT by
registry: they apply WAL records with the journal deliberately
detached, so noting would double-record — their bumps still owe
delta notes (the cache contract holds during replay too).

Raise-path escapes of the JOURNAL half are reported separately and
anchored at the raising statement: "mutated, bumped, then raised
before journaling" is occasionally a deliberate design decision
(a slice registered by an upsert that then fails validation), and the
waiver then sits on the raise, not on the bump — deleting the
normal-path journal note still fails the build.

The registry also names the journal KINDS each file must note at
least once (``REQUIRED_KINDS``): the replayer in ``sched/journal.py``
dispatches on these strings, so a kind it handles that nothing notes
any more is dead recovery code hiding a deleted seam — this is what
catches deleting a journal-only note (``gvtaken``, ``guncommit``)
that no bump sits next to.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

from tpukube_torch.analysis import cfg
from tpukube_torch.analysis.base import Finding, SourceFile


@dataclass(frozen=True)
class TripleSpec:
    """One class's bump/delta/journal pairing contract."""

    lock_attr: str
    delta_call: str = "_note_delta_locked"
    journal_call: str = "_note_journal_locked"
    bump_attr: str = "_epoch"
    #: functions whose bumps owe no journal note (replay/restore:
    #: the journal is detached while they run)
    journal_exempt: frozenset = field(default_factory=frozenset)


#: (path suffix, class) -> TripleSpec
TRIPLE_REGISTRY: dict[tuple[str, str], TripleSpec] = {
    ("sched/state.py", "ClusterState"): TripleSpec(
        lock_attr="_lock",
        journal_exempt=frozenset({"restore_checkpoint"}),
    ),
    ("sched/gang.py", "GangManager"): TripleSpec(
        lock_attr="_lock",
        journal_exempt=frozenset({
            "restore_checkpoint", "apply_journal", "finish_replay",
            "_res_from_doc_locked",
        }),
    ),
}

#: path suffix -> journal kinds the file must note at least once —
#: the exact strings ``sched/journal.py``'s replayer dispatches on.
#: A kind handled there but noted nowhere is a deleted seam (or dead
#: recovery code); growing a new WAL kind means adding it here AND to
#: the replayer.
REQUIRED_KINDS: dict[str, frozenset] = {
    "sched/state.py": frozenset({"node", "nodes", "commit", "release",
                                 "cordon", "unnodes"}),
    "sched/gang.py": frozenset({
        "evict", "gre", "gdrop", "gterm", "gvgone", "gbound",
        "gmrel", "greas", "gvtaken", "guncommit",
    }),
}


def _is_bump(stmt: ast.AST, spec: TripleSpec) -> bool:
    for n in cfg.shallow_walk(stmt):
        if (isinstance(n, ast.AugAssign)
                and isinstance(n.op, ast.Add)
                and cfg._self_attr(n.target) == spec.bump_attr):
            return True
    return False


def _calls_method(stmt: ast.AST, method: str) -> bool:
    for n in cfg.shallow_walk(stmt):
        if (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and cfg._self_attr(n.func) is not None
                and n.func.attr == method):
            return True
    return False


def _next_bump(g: "cfg.FunctionCFG", start: cfg.Node, sat, bump_ids):
    """The first OTHER bump reachable from ``start`` without passing a
    satisfying (delta-note) statement — the delta chain records one
    delta PER epoch (``SnapshotDelta.epoch = self._epoch``), so two
    bumps with no note between them gap the chain at the first bump's
    epoch even when a later note covers the region exit."""
    seen: set[int] = set()
    stack = list(start.succ)
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if id(n) in bump_ids:
            return n
        if sat(n):
            continue
        stack.extend(n.succ)
    return None


def _noted_kinds(tree: ast.Module, spec: TripleSpec) -> set[str]:
    """String literals passed as the first argument of journal-note
    calls anywhere in the module."""
    out: set[str] = set()
    for n in ast.walk(tree):
        if (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == spec.journal_call
                and n.args
                and isinstance(n.args[0], ast.Constant)
                and isinstance(n.args[0].value, str)):
            out.add(n.args[0].value)
    return out


def check_seam_triples(sf: SourceFile,
                       registry: Optional[dict] = None) -> list[Finding]:
    table = registry if registry is not None else TRIPLE_REGISTRY
    specs = {cls: spec for (sfx, cls), spec in table.items()
             if sf.in_scope((sfx,))}
    if not specs:
        return []
    findings: list[Finding] = []
    emitted: set[tuple[int, str]] = set()

    def emit(line: int, message: str) -> None:
        if (line, message) not in emitted:
            emitted.add((line, message))
            findings.append(Finding("seam-triple", sf.rel, line, message))

    for cls_node in sf.tree.body:
        if not isinstance(cls_node, ast.ClassDef):
            continue
        spec = specs.get(cls_node.name)
        if spec is None:
            continue
        for fn in cls_node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            g = cfg.build_cfg(fn, lock_attrs={spec.lock_attr})
            bumps = [n for n in g.nodes
                     if n.stmt is not None and _is_bump(n.stmt, spec)]
            if not bumps:
                continue

            halves = [(spec.delta_call,
                       "breaks the contiguous snapshot delta chain — "
                       "every later cache hit degrades to an O(chips) "
                       "full rebuild")]
            if fn.name not in spec.journal_exempt:
                halves.append((spec.journal_call,
                               "is a recovery-divergence bug — a "
                               "restart replays a WAL that never saw "
                               "this mutation"))

            bump_ids = {id(n) for n in bumps}
            for node in bumps:
                rid = g.outermost_region(node, spec.lock_attr)

                def delta_sat(v: cfg.Node) -> bool:
                    return (v.stmt is not None
                            and _calls_method(v.stmt, spec.delta_call))

                nb = _next_bump(g, node, delta_sat, bump_ids)
                if nb is not None:
                    emit(node.line, (
                        f"`self.{spec.bump_attr} += 1` in "
                        f"{cls_node.name}.{fn.name} reaches the next "
                        f"bump (line {nb.line}) without "
                        f"`self.{spec.delta_call}(...)` in between — "
                        f"the delta chain records one delta PER epoch, "
                        f"so this bump's epoch gaps the chain and every "
                        f"later advance falls back to the O(chips) "
                        f"rebuild"))
                for call, why in halves:
                    def sat(v: cfg.Node, _c=call) -> bool:
                        return (v.stmt is not None
                                and _calls_method(v.stmt, _c))

                    if rid is None:
                        if not fn.name.endswith("_locked"):
                            # epoch-discipline already flags the
                            # bump-outside-lock shape; nothing sound
                            # to prove here
                            continue
                        rets, rzs = cfg.escapes_function(g, node, sat)
                        if rets:
                            emit(node.line, (
                                f"`self.{spec.bump_attr} += 1` in "
                                f"{cls_node.name}.{fn.name} reaches "
                                f"function exit without "
                                f"`self.{call}(...)` (near line "
                                f"{rets[0].line}) — a missed note "
                                f"{why}"))
                        for w in rzs:
                            emit(w.line if w.line is not None
                                 else node.line, (
                                f"exception path after "
                                f"`self.{spec.bump_attr} += 1` (line "
                                f"{node.line}) in "
                                f"{cls_node.name}.{fn.name} escapes "
                                f"without `self.{call}(...)` — a "
                                f"missed note {why}"))
                            break
                        continue
                    escapes = cfg.escapes_region(g, node, rid, sat)
                    normal = [(u, v) for u, v in escapes
                              if v.kind != "raise_exit"]
                    raising = [(u, v) for u, v in escapes
                               if v.kind == "raise_exit"]
                    if normal:
                        emit(node.line, (
                            f"`self.{spec.bump_attr} += 1` in "
                            f"{cls_node.name}.{fn.name} is not "
                            f"followed by `self.{call}(...)` on every "
                            f"path before the `with "
                            f"self.{spec.lock_attr}` region (line "
                            f"{g.regions[rid].line}) exits (escape "
                            f"near line {normal[0][0].line}) — a "
                            f"missed note {why}"))
                    seen_w: set[int] = set()
                    for u, _ in raising:
                        wl = u.line if u.line is not None else node.line
                        if wl in seen_w:
                            continue
                        seen_w.add(wl)
                        emit(wl, (
                            f"exception path after "
                            f"`self.{spec.bump_attr} += 1` (line "
                            f"{node.line}) in "
                            f"{cls_node.name}.{fn.name} leaves the "
                            f"`with self.{spec.lock_attr}` region "
                            f"without `self.{call}(...)` — a missed "
                            f"note {why}"))

        # journal-kind coverage: unique journal-only notes (no bump
        # beside them) are killed here when deleted
        required = None
        for sfx, kinds in REQUIRED_KINDS.items():
            if sf.in_scope((sfx,)):
                required = kinds
                break
        if required is not None:
            noted = _noted_kinds(sf.tree, spec)
            if not noted:
                # a module with ZERO journal notes does not participate
                # in the WAL seam (fixture skeletons, forks) — kind
                # coverage is a backstop against single-site deletions,
                # and any real deletion leaves the other notes behind
                continue
            for kind in sorted(required - noted):
                emit(cls_node.lineno, (
                    f"journal kind \"{kind}\" is handled by the "
                    f"replayer (sched/journal.py) but no "
                    f"`{spec.journal_call}(\"{kind}\", ...)` remains "
                    f"in {sf.rel} — a deleted WAL seam leaves "
                    f"recovery replaying records that are never "
                    f"written (analysis/seams.py REQUIRED_KINDS)"))
    return findings
