"""flag-discipline: feature-gated subsystems are constructed only
under their config flag, and every use of their seam attribute is
None-guarded.

The repo's off-is-off contract (every opt-in plane) is a pair of
hand-maintained idioms:

  * construction — ``self.X = None`` then ``if config.X_enabled:
    self.X = Ctor(...)`` (or the ternary form ``Ctor(...) if
    config.X_enabled else None``), so a disabled flag builds NOTHING:
    no thread, no ring, no series, byte-identical exposition;
  * consumption — every later ``self.X.method(...)`` sits under an
    ``is None`` guard (or inside a block whose test mentions the flag),
    because with the flag off the attribute IS ``None`` and an
    unguarded seam crashes exactly the configuration the parity
    goldens promise is untouched.

Both idioms rot silently: a new call site added two PRs after the flag
landed has no test running with the flag OFF on that path. This pass
machine-checks them over the registry below.

Scope and honesty: the guard check is lexical, not path-sensitive —
a block whose test MENTIONS the seam attribute (or its flag) counts
as guarded regardless of polarity, and an early-out ``if self.X is
None: return`` guards the rest of the enclosing block. Aliased access
(``dlog = self.decisions`` then ``if dlog is not None``) is invisible
and therefore trivially clean — the alias read itself dereferences
nothing. The pass exists to catch the common failure (a bare
``self.X.y(...)`` with no guard in sight), not to prove the guard's
branch sense.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from tpukube_torch.analysis import callgraph, cfg
from tpukube_torch.analysis.base import Finding, SourceFile

FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass(frozen=True)
class FlagSpec:
    """One feature gate's construction/consumption contract."""

    flag: str
    #: constructor call names; ``"mod.func"`` matches the dotted form
    ctors: frozenset
    #: files where any ctor call must sit under a flag check
    construct_scope: tuple
    #: the seam attribute the consumer classes hold (None = the flag
    #: has no per-instance seam — construction discipline only)
    attr: Optional[str] = None
    #: (path suffix, class) whose ``self.<attr>`` derefs are checked
    consumers: tuple = ()


FLAG_REGISTRY: tuple[FlagSpec, ...] = (
    FlagSpec(
        flag="decisions_enabled",
        ctors=frozenset({"DecisionLog"}),
        construct_scope=("sched/extender.py", "sched/shard.py"),
        attr="decisions",
        consumers=(("sched/extender.py", "Extender"),
                   ("sched/shard.py", "ShardRouter")),
    ),
    FlagSpec(
        flag="journal_enabled",
        ctors=frozenset({"StateJournal"}),
        construct_scope=("sched/extender.py",),
        attr="journal",
        consumers=(("sched/extender.py", "Extender"),),
    ),
    FlagSpec(
        flag="batch_enabled",
        ctors=frozenset({"SchedulingCycle", "_RouterCycle"}),
        construct_scope=("sched/extender.py", "sched/shard.py"),
        attr="cycle",
        consumers=(("sched/extender.py", "Extender"),
                   ("sched/shard.py", "ShardRouter")),
    ),
    FlagSpec(
        flag="tenancy_enabled",
        ctors=frozenset({"TenantPlane"}),
        construct_scope=("sched/extender.py",),
        attr="tenants",
        consumers=(("sched/extender.py", "Extender"),),
    ),
    FlagSpec(
        flag="capacity_enabled",
        ctors=frozenset({"CapacityRecorder"}),
        construct_scope=("sched/extender.py",),
        attr="capacity",
        consumers=(("sched/extender.py", "Extender"),),
    ),
    FlagSpec(
        flag="drain_enabled",
        ctors=frozenset({"DrainCoordinator"}),
        construct_scope=("sched/extender.py",),
        attr="drain",
        consumers=(("sched/extender.py", "Extender"),),
    ),
    FlagSpec(
        flag="autoscale_enabled",
        ctors=frozenset({"Autoscaler"}),
        construct_scope=("sched/extender.py",),
        attr="autoscaler",
        consumers=(("sched/extender.py", "Extender"),),
    ),
    FlagSpec(
        flag="lock_monitor",
        ctors=frozenset({"lockgraph.install"}),
        construct_scope=("tpukube_torch/cli.py", "sim/harness.py",
                         "sched/shardworker.py"),
        # no seam attribute: consumers hold the returned monitor (or an
        # installed bool) themselves; construction discipline is the
        # whole contract — an ungated install() patches threading.Lock
        # for the entire process
    ),
)


def _call_names(call: ast.Call) -> set[str]:
    """Both spellings of a constructor call: bare name and one-level
    dotted (``lockgraph.install``)."""
    out: set[str] = set()
    f = call.func
    if isinstance(f, ast.Name):
        out.add(f.id)
    elif isinstance(f, ast.Attribute):
        out.add(f.attr)
        if isinstance(f.value, ast.Name):
            out.add(f"{f.value.id}.{f.attr}")
    return out


def _terminates(body: list) -> bool:
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _check_construction(sf: SourceFile,
                        specs: list[FlagSpec]) -> list[Finding]:
    """Every registered ctor call must sit under an enclosing test
    (``if`` / ternary / ``while`` / bool-op guard) that mentions the
    flag."""
    findings: list[Finding] = []

    def visit(node: ast.AST, gates: frozenset) -> None:
        if isinstance(node, ast.If):
            inner = gates | _gate_names(node.test)
            visit(node.test, gates)
            for s in node.body:
                visit(s, inner)
            for s in node.orelse:
                visit(s, inner)
            return
        if isinstance(node, ast.IfExp):
            inner = gates | _gate_names(node.test)
            visit(node.test, gates)
            visit(node.body, inner)
            visit(node.orelse, inner)
            return
        if isinstance(node, ast.While):
            inner = gates | _gate_names(node.test)
            visit(node.test, gates)
            for s in node.body:
                visit(s, inner)
            for s in node.orelse:
                visit(s, gates)
            return
        if isinstance(node, ast.Call):
            names = _call_names(node)
            for spec in specs:
                if names & spec.ctors and spec.flag not in gates:
                    ctor = sorted(names & spec.ctors)[0]
                    findings.append(Finding(
                        "flag-discipline", sf.rel, node.lineno,
                        f"`{ctor}(...)` constructed without a "
                        f"`{spec.flag}` check — flagged subsystems are "
                        f"built only under their config gate, so the "
                        f"flag-off run builds NOTHING (off-is-off; "
                        f"analysis/flags.py FLAG_REGISTRY)"))
        for child in ast.iter_child_nodes(node):
            visit(child, gates)

    flags = {s.flag for s in specs}

    def _gate_names(test: ast.AST) -> frozenset:
        return frozenset(f for f in flags
                         if callgraph.guard_mentions(test, {f}))

    visit(sf.tree, frozenset())
    return findings


def _derefs(node: ast.AST, attrs: frozenset) -> list[tuple[int, str]]:
    """``self.<attr>.<x>`` / ``self.<attr>[...]`` / calls through the
    seam — uses that crash when the attribute is None. A bare read of
    ``self.<attr>`` (alias, truthiness test, hand-off) is not a deref."""
    out: list[tuple[int, str]] = []
    for n in cfg.shallow_walk(node):
        base = None
        if isinstance(n, (ast.Attribute, ast.Subscript)):
            base = n.value
        if base is not None and cfg._self_attr(base) in attrs:
            out.append((n.lineno, cfg._self_attr(base)))
    return out


def _stmt_local_guard(stmt: ast.AST, names: set) -> bool:
    """A guard inside the statement itself: a ternary whose test
    mentions the seam, or an ``is (not) None`` comparison on it."""
    for n in cfg.shallow_walk(stmt):
        if (isinstance(n, ast.IfExp)
                and callgraph.guard_mentions(n.test, names)):
            return True
        if (isinstance(n, ast.Compare)
                and callgraph.guard_mentions(n, names)
                and any(isinstance(c, ast.Constant) and c.value is None
                        for c in n.comparators)):
            return True
    return False


def _check_consumer(sf: SourceFile, cls_node: ast.ClassDef,
                    attr_flags: dict) -> list[Finding]:
    findings: list[Finding] = []
    attrs = frozenset(attr_flags)
    names_of = {a: {a, attr_flags[a]} for a in attrs}

    def check_expr(stmt: ast.AST, guarded: set) -> None:
        for line, attr in _derefs(stmt, attrs - frozenset(guarded)):
            if _stmt_local_guard(stmt, names_of[attr]):
                continue
            findings.append(Finding(
                "flag-discipline", sf.rel, line,
                f"`self.{attr}.<...>` dereferenced without a "
                f"`self.{attr} is None` guard — with "
                f"`{attr_flags[attr]}` off the attribute IS None and "
                f"this seam crashes the flag-off path the parity "
                f"goldens promise is untouched (analysis/flags.py)"))

    def mentioned_in(test: ast.AST) -> set:
        return {a for a in attrs
                if callgraph.guard_mentions(test, names_of[a])}

    def walk(stmts: list, guarded: set) -> None:
        g = set(guarded)
        for stmt in stmts:
            if isinstance(stmt, (*FuncDef, ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                m = mentioned_in(stmt.test)
                check_expr(stmt.test, g | m)
                walk(stmt.body, g | m)
                walk(stmt.orelse, g | m)
                if m and _terminates(stmt.body):
                    g |= m
            elif isinstance(stmt, ast.While):
                m = mentioned_in(stmt.test)
                check_expr(stmt.test, g | m)
                walk(stmt.body, g | m)
                walk(stmt.orelse, g)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                check_expr(stmt.iter, g)
                walk(stmt.body, g)
                walk(stmt.orelse, g)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    check_expr(item.context_expr, g)
                walk(stmt.body, g)
            elif isinstance(stmt, ast.Try):
                walk(stmt.body, g)
                for h in stmt.handlers:
                    walk(h.body, g)
                walk(stmt.orelse, g)
                walk(stmt.finalbody, g)
            elif isinstance(stmt, ast.Match):
                check_expr(stmt.subject, g)
                for case in stmt.cases:
                    walk(case.body, g)
            else:
                check_expr(stmt, g)

    for fn in cls_node.body:
        if isinstance(fn, FuncDef):
            walk(fn.body, set())
    return findings


def check_flags(sf: SourceFile,
                registry: Optional[tuple] = None) -> list[Finding]:
    table = registry if registry is not None else FLAG_REGISTRY
    findings: list[Finding] = []

    ctor_specs = [s for s in table if sf.in_scope(s.construct_scope)]
    if ctor_specs:
        findings.extend(_check_construction(sf, ctor_specs))

    by_class: dict[str, dict] = {}
    for spec in table:
        if spec.attr is None:
            continue
        for sfx, cls in spec.consumers:
            if sf.in_scope((sfx,)):
                by_class.setdefault(cls, {})[spec.attr] = spec.flag
    for cls, attr_flags in by_class.items():
        cls_node = callgraph.find_class(sf.tree, cls)
        if cls_node is not None:
            findings.extend(_check_consumer(sf, cls_node, attr_flags))

    # registry rot check: every declared flag must exist as a config
    # field — a renamed flag would otherwise quietly gate nothing
    if sf.in_scope(("core/config.py",)):
        fields = {
            n.target.id
            for cls in sf.tree.body if isinstance(cls, ast.ClassDef)
            for n in cls.body
            if isinstance(n, ast.AnnAssign)
            and isinstance(n.target, ast.Name)
        }
        for spec in table:
            if spec.flag not in fields:
                findings.append(Finding(
                    "flag-discipline", sf.rel, 1,
                    f"flag `{spec.flag}` in analysis/flags.py "
                    f"FLAG_REGISTRY is not a config field — the "
                    f"registry entry gates nothing; rename or remove "
                    f"it"))
    return findings
