"""Intra-class call graph: one-level delegation summaries for the
lint passes.

The per-function passes (locks, epochs, leaks) historically trusted
naming conventions at function boundaries: a ``*_locked`` helper is
ASSUMED to run under the lock, a caller's bump is ASSUMED to cover the
helper it delegates to. This module makes the boundary checkable ONE
level deep:

  * :func:`class_graph` indexes every method of a class and every
    intra-class ``self.<method>(...)`` call site, with the ``with
    self.<lock>`` attrs lexically held at each site;
  * :func:`always_satisfies` summarizes a helper body — "does every
    exit pass a statement the predicate accepts?" — using only the
    helper's DIRECT statements, so a two-level chain (caller ->
    helper -> sub-helper that actually bumps) is deliberately NOT
    accepted: one level is auditable by eye, arbitrary transitive
    chains are how conventions rot.

Closed-world caveat: "every call site" means every call site INSIDE
the class body. A method invoked from outside its class (another
module, a thread target) is not proven by its callers here — the
passes only use caller-proofs to ACCEPT code the per-function lexical
check would flag, never to flag code the lexical check accepts, so
the caveat can only cost a waiver, not hide a bug the old passes
caught.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from tpukube_torch.analysis import cfg

FuncDef = (ast.FunctionDef, ast.AsyncFunctionDef)


def methods_of(cls_node: ast.ClassDef) -> dict:
    """name -> def for the class's directly-declared methods."""
    return {fn.name: fn for fn in cls_node.body
            if isinstance(fn, FuncDef)}


def self_calls(stmt: ast.AST) -> set[str]:
    """Method names invoked as ``self.<m>(...)`` within one statement
    (never descending into nested defs)."""
    out: set[str] = set()
    for n in cfg.shallow_walk(stmt):
        if (isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and cfg._self_attr(n.func) is not None):
            out.add(n.func.attr)
    return out


@dataclass(frozen=True)
class Site:
    """One intra-class ``self.<method>(...)`` call site."""

    caller: ast.AST          # the enclosing FunctionDef
    call: ast.Call
    method: str
    #: ``with self.<attr>`` lock attrs lexically held at the call
    held: frozenset


class ClassGraph:
    """Method index + intra-class call sites for one class."""

    def __init__(self, cls_node: ast.ClassDef,
                 lock_attrs: Iterable[str] = ()):
        self.cls = cls_node
        self.methods = methods_of(cls_node)
        self._sites: dict[str, list[Site]] = {}
        track = frozenset(lock_attrs)
        for fn in self.methods.values():
            self._collect(fn, track)

    def _collect(self, fn, track: frozenset) -> None:
        sites = self._sites

        class V(ast.NodeVisitor):
            def __init__(self) -> None:
                self.held: list[str] = []

            def _visit_with(self, node) -> None:
                acquired = 0
                for item in node.items:
                    self.visit(item.context_expr)
                    a = cfg._self_attr(item.context_expr)
                    if a in track:
                        self.held.append(a)
                        acquired += 1
                for stmt in node.body:
                    self.visit(stmt)
                del self.held[len(self.held) - acquired:]

            visit_With = _visit_with
            visit_AsyncWith = _visit_with

            def visit_Call(self, node: ast.Call) -> None:
                if (isinstance(node.func, ast.Attribute)
                        and cfg._self_attr(node.func) is not None):
                    sites.setdefault(node.func.attr, []).append(Site(
                        caller=fn, call=node, method=node.func.attr,
                        held=frozenset(self.held),
                    ))
                self.generic_visit(node)

        V().visit(fn)

    def sites_of(self, method: str) -> list[Site]:
        """Every intra-class call site of ``self.<method>(...)``."""
        return self._sites.get(method, [])


def always_satisfies(fn, satisfies: Callable[[ast.AST], bool],
                     raise_paths: bool = True) -> bool:
    """True when every path through ``fn`` passes a DIRECT statement
    the predicate accepts before any function exit — the one-level
    helper summary. With ``raise_paths`` (the default) exception exits
    count too, which is the conservative reading: a helper that can
    raise before doing its duty does not discharge the caller's
    obligation on that path."""
    g = cfg.build_cfg(fn)

    def sat(node: cfg.Node) -> bool:
        return node.stmt is not None and satisfies(node.stmt)

    rets, rzs = cfg.escapes_function(g, g.entry, sat)
    if rets:
        return False
    return not (raise_paths and rzs)


def delegating_satisfier(
    cg: ClassGraph, satisfies: Callable[[ast.AST], bool],
    exclude: Iterable[str] = (),
) -> Callable[[ast.AST], bool]:
    """Lift a direct statement predicate one call level: the returned
    predicate also accepts a statement that calls an intra-class
    helper whose OWN direct statements satisfy on every exit. Helper
    summaries use the base predicate only, so delegation never chains
    (two-level delegation is rejected by design). ``exclude`` names
    methods that must not count (typically the function under
    analysis, so recursion cannot vouch for itself)."""
    excluded = frozenset(exclude)
    summary: dict[str, bool] = {}

    def helper_ok(name: str) -> bool:
        if name in excluded or name not in cg.methods:
            return False
        if name not in summary:
            summary[name] = always_satisfies(cg.methods[name], satisfies)
        return summary[name]

    def lifted(stmt: ast.AST) -> bool:
        if satisfies(stmt):
            return True
        return any(helper_ok(m) for m in self_calls(stmt))

    return lifted


def guard_mentions(test: ast.AST, names: Iterable[str]) -> bool:
    """Does a condition expression mention any of the given names —
    as a bare name, a ``self.<name>``, or a ``<recv>.<name>``
    attribute? The lexical "is this gated on the flag/holder" test
    the flag pass and caller-proofs share."""
    wanted = set(names)
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and n.id in wanted:
            return True
        if isinstance(n, ast.Attribute) and n.attr in wanted:
            return True
    return False


def find_class(tree: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None
