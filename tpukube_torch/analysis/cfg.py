"""Per-function control-flow graphs + path-dataflow queries — the
engine under tpukube-lint's ``epoch-discipline`` and
``reservation-leak`` passes.

The lexical passes (``locks.py``) see only nesting; the invariants of the
reservation and snapshot planes are PATH properties: "every write to a mutation
seam is followed by an epoch bump on every path before the enclosing
lock's ``with`` exits", "every path from a reservation acquire to
function exit reaches commit, rollback, or a hand-off — exception
edges included". This module builds a small CFG per function (branches,
loops, ``try/except/finally``, ``with`` regions, ``return`` / ``raise``
/ ``break`` / ``continue`` edges) and answers exactly those two query
shapes:

  * :func:`escapes_region` — edges leaving a lock-holding ``with``
    region reachable from a start node without passing a satisfying
    node ("B occurs before region exit on every path from A");
  * :func:`escapes_function` — function exits (normal return vs
    exception) reachable from a start node without passing a
    satisfying node ("A dominates a commit-or-cleanup on all exits").

Exception modeling is deliberately low-noise:

  * an explicit ``raise`` always takes the exception edge (through
    every enclosing ``finally`` to the innermost handler, or out of
    the function);
  * a statement lexically inside a ``try`` that HAS ``except``
    handlers gets an implicit exception edge to those handlers — the
    try exists precisely because exceptions are expected there;
  * statements under handler-less ``try/finally``, or under no try at
    all, are assumed not to raise. Anything else makes the queries
    unsatisfiable: a mutation followed by its epoch bump would always
    carry a phantom exception path BETWEEN the two statements.
  * a dispatch to handlers is treated as fully caught (no "unmatched
    type" propagation edge) — a handler that re-raises does so with an
    explicit ``raise``, which IS modeled.

``finally`` bodies are instantiated once per abrupt edge that crosses
them (plus once for normal completion), so ``return`` inside
``try/finally`` correctly runs the cleanup nodes before reaching the
return exit.

Nested ``def`` / ``lambda`` / ``class`` bodies do not execute inline:
they appear as single definition nodes and :func:`shallow_walk` (the
helper the passes use to evaluate predicates over one statement) never
descends into them.
"""

from __future__ import annotations

import ast
from typing import Callable, Iterable, Iterator, Optional


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def shallow_walk(root: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that never enters nested function / lambda / class
    bodies (they do not execute at the statement's program point).
    A def/class root therefore yields nothing — the definition
    statement itself performs none of its body's effects."""
    stack = [root]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


class Node:
    """One CFG node: a statement (or expression evaluation point, for
    branch tests / loop iterables / with items) plus synthetic
    entry/exit/join nodes. ``regions`` is the set of lock-region ids
    active at this node; ``stmt`` is the AST the passes evaluate
    predicates over (None for synthetic nodes)."""

    __slots__ = ("idx", "line", "desc", "stmt", "succ", "regions", "kind")

    def __init__(self, idx: int, line: Optional[int], desc: str,
                 stmt: Optional[ast.AST] = None,
                 regions: tuple[int, ...] = (), kind: str = "stmt"):
        self.idx = idx
        self.line = line
        self.desc = desc
        self.stmt = stmt
        self.succ: list["Node"] = []
        self.regions = frozenset(regions)
        self.kind = kind

    def __repr__(self) -> str:  # debugging aid only
        return f"<{self.idx}:{self.desc}@{self.line}>"


class Region:
    """A lock-holding ``with`` region (one per matching with-item)."""

    __slots__ = ("rid", "lock_attr", "line")

    def __init__(self, rid: int, lock_attr: str, line: int):
        self.rid = rid
        self.lock_attr = lock_attr
        self.line = line


class FunctionCFG:
    """The CFG of one function. Build with :func:`build_cfg`."""

    def __init__(self, func, lock_attrs: Iterable[str] = ()):
        self.func = func
        self.lock_attrs = frozenset(lock_attrs)
        self.nodes: list[Node] = []
        self.regions: dict[int, Region] = {}
        #: active lock-region ids, innermost last
        self._active: tuple[int, ...] = ()
        #: frames, innermost last: ("loop", head, after) |
        #: ("finally", finalbody, frames_len, active_regions) |
        #: ("except", dispatch_node)
        self._frames: list[tuple] = []
        self.return_exit = self._new(None, "<return-exit>",
                                     kind="return_exit")
        self.raise_exit = self._new(None, "<raise-exit>", kind="raise_exit")
        self.entry = self._new(func.lineno, "<entry>", kind="entry")
        frontier = self._build_body(func.body, [self.entry])
        for n in frontier:  # falling off the end = implicit `return None`
            self._edge(n, self.return_exit)

    # -- graph primitives ----------------------------------------------------
    def _new(self, line: Optional[int], desc: str,
             stmt: Optional[ast.AST] = None, kind: str = "stmt",
             regions: Optional[tuple[int, ...]] = None) -> Node:
        n = Node(len(self.nodes), line, desc, stmt=stmt,
                 regions=self._active if regions is None else regions,
                 kind=kind)
        self.nodes.append(n)
        return n

    @staticmethod
    def _edge(u: Node, v: Node) -> None:
        if v not in u.succ:
            u.succ.append(v)

    def _stmt_node(self, stmt: ast.stmt, desc: Optional[str] = None) -> Node:
        return self._new(stmt.lineno, desc or type(stmt).__name__, stmt=stmt)

    # -- abrupt-completion routing -------------------------------------------
    def _chain_finally(self, pred: Node, frame: tuple) -> Optional[Node]:
        """Instantiate a ``finally`` body for one abrupt edge: build its
        statements fresh in the context saved at the try statement,
        entered from ``pred``. Returns the join node the abrupt edge
        continues from — or None when the finally body itself completes
        abruptly on every path (it hijacked control)."""
        _, finalbody, flen, factive = frame
        saved_frames, saved_active = self._frames, self._active
        self._frames, self._active = list(saved_frames[:flen]), factive
        try:
            frontier = self._build_body(finalbody, [pred])
            if not frontier:
                return None
            join = self._new(finalbody[0].lineno, "<finally-join>",
                             kind="join")
        finally:
            self._frames, self._active = saved_frames, saved_active
        for n in frontier:
            self._edge(n, join)
        return join

    def _route_return(self, src: Node) -> None:
        cur: Optional[Node] = src
        for fr in reversed(self._frames):
            if fr[0] == "finally":
                cur = self._chain_finally(cur, fr)
                if cur is None:
                    return
        self._edge(cur, self.return_exit)

    def _route_exception(self, src: Node) -> None:
        cur: Optional[Node] = src
        for fr in reversed(self._frames):
            if fr[0] == "finally":
                cur = self._chain_finally(cur, fr)
                if cur is None:
                    return
            elif fr[0] == "except":
                self._edge(cur, fr[1])
                return
        self._edge(cur, self.raise_exit)

    def _implicit_raise(self, src: Node) -> None:
        """Exception edge for a statement inside a handler-bearing try
        body. No-op when no enclosing try has handlers — see the module
        docstring's exception model."""
        if any(fr[0] == "except" for fr in self._frames):
            self._route_exception(src)

    def _route_loop_jump(self, src: Node, kind: str) -> None:
        cur: Optional[Node] = src
        for fr in reversed(self._frames):
            if fr[0] == "finally":
                cur = self._chain_finally(cur, fr)
                if cur is None:
                    return
            elif fr[0] == "loop":
                self._edge(cur, fr[1] if kind == "continue" else fr[2])
                return
        # break/continue outside a loop is a SyntaxError upstream;
        # treat defensively as function exit
        self._edge(cur, self.raise_exit)

    # -- statement builders ---------------------------------------------------
    def _build_body(self, stmts: list, frontier: list[Node]) -> list[Node]:
        for stmt in stmts:
            if not frontier:
                break  # unreachable tail (after return/raise/break)
            frontier = self._build_stmt(stmt, frontier)
        return frontier

    def _build_stmt(self, stmt: ast.stmt, frontier: list[Node]) -> list[Node]:
        if isinstance(stmt, ast.If):
            return self._build_if(stmt, frontier)
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._build_loop(stmt, frontier)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._build_with(stmt, frontier)
        if isinstance(stmt, ast.Try) or (
                hasattr(ast, "TryStar") and isinstance(stmt, ast.TryStar)):
            return self._build_try(stmt, frontier)
        if isinstance(stmt, ast.Return):
            n = self._stmt_node(stmt)
            self._connect(frontier, n)
            self._route_return(n)
            return []
        if isinstance(stmt, ast.Raise):
            n = self._stmt_node(stmt)
            self._connect(frontier, n)
            self._route_exception(n)
            return []
        if isinstance(stmt, ast.Break):
            n = self._stmt_node(stmt)
            self._connect(frontier, n)
            self._route_loop_jump(n, "break")
            return []
        if isinstance(stmt, ast.Continue):
            n = self._stmt_node(stmt)
            self._connect(frontier, n)
            self._route_loop_jump(n, "continue")
            return []
        if hasattr(ast, "Match") and isinstance(stmt, ast.Match):
            return self._build_match(stmt, frontier)
        # simple statement (incl. nested def/class, which contribute no
        # inline effects — shallow_walk keeps predicates out of them)
        n = self._stmt_node(stmt)
        self._connect(frontier, n)
        self._implicit_raise(n)
        return [n]

    def _connect(self, frontier: list[Node], n: Node) -> None:
        for u in frontier:
            self._edge(u, n)

    def _build_if(self, stmt: ast.If, frontier: list[Node]) -> list[Node]:
        test = self._new(stmt.lineno, "if-test", stmt=stmt.test)
        self._connect(frontier, test)
        self._implicit_raise(test)
        then_f = self._build_body(stmt.body, [test])
        else_f = (self._build_body(stmt.orelse, [test])
                  if stmt.orelse else [test])
        return then_f + else_f

    def _build_loop(self, stmt, frontier: list[Node]) -> list[Node]:
        head_expr = stmt.test if isinstance(stmt, ast.While) else stmt.iter
        head = self._new(stmt.lineno, "loop-head", stmt=head_expr)
        after = self._new(stmt.lineno, "<loop-exit>", kind="join")
        self._connect(frontier, head)
        self._implicit_raise(head)
        self._frames.append(("loop", head, after))
        try:
            body_f = self._build_body(stmt.body, [head])
        finally:
            self._frames.pop()
        for n in body_f:
            self._edge(n, head)
        if stmt.orelse:
            for n in self._build_body(stmt.orelse, [head]):
                self._edge(n, after)
        else:
            self._edge(head, after)
        return [after]

    def _build_with(self, stmt, frontier: list[Node]) -> list[Node]:
        saved_active = self._active
        for item in stmt.items:
            # runtime order for `with A, B:`: A's expr, acquire A, B's
            # expr (under A), acquire B — matching locks.py's model
            n = self._new(stmt.lineno, "with-item", stmt=item.context_expr)
            self._connect(frontier, n)
            self._implicit_raise(n)
            frontier = [n]
            attr = _self_attr(item.context_expr)
            if attr in self.lock_attrs:
                rid = len(self.regions)
                self.regions[rid] = Region(rid, attr, stmt.lineno)
                self._active = self._active + (rid,)
        try:
            body_f = self._build_body(stmt.body, frontier)
        finally:
            self._active = saved_active
        # edges from body_f to whatever follows naturally leave the
        # region (successors carry the restored, smaller region set)
        return body_f

    def _build_try(self, stmt, frontier: list[Node]) -> list[Node]:
        dispatch = None
        flen = len(self._frames)
        if stmt.finalbody:
            self._frames.append(("finally", stmt.finalbody, flen,
                                 self._active))
        if stmt.handlers:
            dispatch = self._new(stmt.lineno, "<except-dispatch>",
                                 kind="join")
            self._frames.append(("except", dispatch))
        try:
            body_f = self._build_body(stmt.body, frontier)
        finally:
            if dispatch is not None:
                self._frames.pop()  # handlers do not catch their own raises
        if stmt.orelse:
            body_f = self._build_body(stmt.orelse, body_f)
        handler_f: list[Node] = []
        for h in stmt.handlers:
            hnode = self._new(h.lineno, "<except-entry>", kind="join")
            self._edge(dispatch, hnode)
            handler_f.extend(self._build_body(h.body, [hnode]))
        merged = body_f + handler_f
        if stmt.finalbody:
            self._frames.pop()  # the abrupt edges already instantiated theirs
            merged = self._build_body(stmt.finalbody, merged) if merged else []
        return merged

    def _build_match(self, stmt, frontier: list[Node]) -> list[Node]:
        subject = self._new(stmt.lineno, "match-subject", stmt=stmt.subject)
        self._connect(frontier, subject)
        self._implicit_raise(subject)
        out: list[Node] = [subject]  # no case may match
        for case in stmt.cases:
            out.extend(self._build_body(case.body, [subject]))
        return out

    # -- region helpers -------------------------------------------------------
    def outermost_region(self, node: Node,
                         lock_attr: str) -> Optional[int]:
        """The OUTERMOST region over ``lock_attr`` containing the node —
        outermost because the re-entrant lock is truly released only
        when the outermost ``with`` exits."""
        matching = [rid for rid in sorted(node.regions)
                    if self.regions[rid].lock_attr == lock_attr]
        return matching[0] if matching else None


def build_cfg(func, lock_attrs: Iterable[str] = ()) -> FunctionCFG:
    """CFG for one ``ast.FunctionDef`` / ``AsyncFunctionDef``.
    ``lock_attrs`` names the ``self.<attr>`` context managers whose
    ``with`` blocks become tracked lock regions."""
    return FunctionCFG(func, lock_attrs)


# -- the two path queries -----------------------------------------------------

def escapes_region(
    cfg: FunctionCFG, start: Node, rid: int,
    satisfies: Callable[[Node], bool],
) -> list[tuple[Node, Node]]:
    """Edges (u, v) that leave lock region ``rid`` and are reachable
    from ``start`` without passing through a node where
    ``satisfies(node)`` holds. Empty means: on every path from
    ``start``, a satisfying node occurs before the region exits —
    return / raise / fallthrough edges included. A satisfying node
    OUTSIDE the region does not help (the lock was already released
    when it runs), exactly as the epoch invariant requires."""
    seen = {start.idx}
    stack = [start]
    out: list[tuple[Node, Node]] = []
    while stack:
        u = stack.pop()
        for v in u.succ:
            if rid in v.regions:
                if v.idx in seen:
                    continue
                seen.add(v.idx)
                if satisfies(v):
                    continue
                stack.append(v)
            else:
                out.append((u, v))
    return out


def escapes_function(
    cfg: FunctionCFG, start: Node,
    satisfies: Callable[[Node], bool],
) -> tuple[list[Node], list[Node]]:
    """(return-exit witnesses, raise-exit witnesses): the last real
    node on each path from ``start`` that reaches a function exit
    without passing a satisfying node. Both lists empty means every
    path from ``start`` — exception edges included — settles first."""
    seen = {start.idx}
    stack = [start]
    returns: list[Node] = []
    raises: list[Node] = []
    while stack:
        u = stack.pop()
        for v in u.succ:
            if v.kind == "return_exit":
                returns.append(u)
                continue
            if v.kind == "raise_exit":
                raises.append(u)
                continue
            if v.idx in seen:
                continue
            seen.add(v.idx)
            if satisfies(v):
                continue
            stack.append(v)
    return returns, raises
