"""Lock passes: discipline (no blocking I/O under scheduling locks),
order (acquisitions against the declared partial order), and
shared-state (registry-declared attributes touched under their lock).

The lexical core — a ``with self._lock:`` region covers the
statements (and nested defs) textually inside it — is extended: the
passes follow ``self.<method>()`` delegation ONE level through
:mod:`tpukube_torch.analysis.callgraph`:

  * shared-state accepts an unguarded method when EVERY intra-class
    call site lexically holds the required lock (the caller-proof
    behind ``Extender.bind``);
  * a call to a ``*_locked`` helper is itself checked for holding the
    locks the helper's body directly needs — the other half of the
    naming convention, previously only documented;
  * lock-order derives re-entry levels from method bodies instead of
    trusting the hand-kept SELF_METHODS list alone.

Deeper cross-function flows remain the dynamic detector's job
(``tpukube_torch.analysis.lockgraph``).
"""

from __future__ import annotations

import ast
from typing import Optional

from tpukube_torch.analysis import callgraph
from tpukube_torch.analysis import cfg as cfg_mod
from tpukube_torch.analysis.base import Finding, SourceFile

# -- lock-discipline ---------------------------------------------------------

#: the scheduling-critical modules whose locks serialize every webhook
DISCIPLINE_SCOPE = (
    "sched/gang.py", "sched/extender.py", "sched/state.py",
)

#: the scheduling locks themselves (self.<name>)
SCHED_LOCKS = {"_lock", "_decision_lock", "_pending_lock"}

#: class-scoped discipline: (path suffix, class) -> lock attrs whose
#: regions ban blocking I/O. Unlike DISCIPLINE_SCOPE (file-wide, every
#: class), this names ONE class in a file where other classes hold
#: locks around I/O BY DESIGN — SubprocessTransport serializes a
#: kept-alive HTTP connection under its ``_lock``, which is the whole
#: point of that lock, while the router's fan-out lock one class over
#: must never wedge ``/filter`` on a stalled worker socket.
CLASS_DISCIPLINE = {
    ("sched/shard.py", "ShardRouter"): frozenset({"_lock"}),
    ("obs/capacity.py", "CapacityRecorder"): frozenset({"_lock"}),
}

#: method names that block on I/O regardless of receiver: file/socket
#: writes and flushes, socket traffic, HTTP round-trips, time.sleep.
#: The JSONL capture sinks are covered by write/flush — JsonlSink.write
#: only enqueues, but calling ANY .write under a scheduling lock is
#: banned so a refactor swapping the sink for a raw file fails lint.
BLOCKING_METHODS = {
    "write", "flush", "send", "sendall", "recv", "connect", "fsync",
    "request", "getresponse", "urlopen", "sleep",
}

#: bare-name calls that block (stdout IS a file)
BLOCKING_NAMES = {"open", "print"}

#: receiver-qualified calls: subprocess spawns, requests HTTP
BLOCKING_QUALIFIED = {
    "subprocess": {"run", "Popen", "call", "check_call", "check_output"},
    "requests": {"get", "post", "put", "delete", "head", "patch"},
    "socket": {"create_connection"},
    "os": {"replace", "rename", "unlink", "system"},
}


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _blocking_desc(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name) and fn.id in BLOCKING_NAMES:
        return f"{fn.id}()"
    if isinstance(fn, ast.Attribute):
        recv = fn.value
        if isinstance(recv, ast.Name):
            qualified = BLOCKING_QUALIFIED.get(recv.id)
            if qualified and fn.attr in qualified:
                return f"{recv.id}.{fn.attr}()"
        if fn.attr in BLOCKING_METHODS:
            return f".{fn.attr}()"
    return None


def _discipline_findings(sf: SourceFile, root: ast.AST,
                         lock_attrs, findings: list[Finding]) -> None:
    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.held: list[str] = []

        def _visit_with(self, node) -> None:
            # runtime order for `with A, B:`: A's expr, acquire A, B's
            # expr (under A), acquire B — so each item's context expr is
            # checked under the locks of the items before it
            acquired = 0
            for item in node.items:
                self.visit(item.context_expr)
                a = _self_attr(item.context_expr)
                if a in lock_attrs:
                    self.held.append(a)
                    acquired += 1
            for stmt in node.body:
                self.visit(stmt)
            del self.held[len(self.held) - acquired:]

        visit_With = _visit_with
        visit_AsyncWith = _visit_with

        def visit_Call(self, node: ast.Call) -> None:
            if self.held:
                desc = _blocking_desc(node)
                if desc is not None:
                    findings.append(Finding(
                        "lock-discipline", sf.rel, node.lineno,
                        f"blocking call {desc} inside `with "
                        f"self.{self.held[-1]}` — scheduling locks may "
                        f"only guard memory; enqueue and do the I/O "
                        f"outside the lock",
                    ))
            self.generic_visit(node)

    V().visit(root)


def check_lock_discipline(sf: SourceFile) -> list[Finding]:
    """Flag blocking operations lexically inside ``with self._lock`` /
    ``_decision_lock`` / ``_pending_lock`` regions of the scheduling
    modules — plus, class-scoped, the router fan-out lock and the
    capacity recorder's ledger lock: one stalled write syscall there
    freezes every concurrent webhook (the emitters-only-enqueue
    invariant)."""
    findings: list[Finding] = []
    if sf.in_scope(DISCIPLINE_SCOPE):
        _discipline_findings(sf, sf.tree, SCHED_LOCKS, findings)
    for (suffix, cls), attrs in CLASS_DISCIPLINE.items():
        if not sf.in_scope((suffix,)):
            continue
        cls_node = callgraph.find_class(sf.tree, cls)
        if cls_node is not None:
            _discipline_findings(sf, cls_node, attrs, findings)
    return findings


# -- lock-order --------------------------------------------------------------

#: the declared partial order (smaller level = acquired first /
#: outermost): decision -> pending -> gang -> ledger -> journal ->
#: router. Acquiring a SMALLER level while holding a larger one is an
#: inversion. The journal's condition sits ABOVE the ledger because
#: ``_note_journal_locked`` enqueues from inside the ledger/gang
#: locks; the router's map lock is the innermost leaf by its own
#: contract ("never nests around replica state on the mutation path").
LOCK_LEVELS = {"decision": 0, "pending": 1, "gang": 2, "ledger": 3,
               "journal": 4, "router": 5}

#: (path suffix, class) -> {self lock attr: (name, level)}
ORDERED_LOCKS = {
    ("sched/extender.py", "Extender"): {
        "_decision_lock": ("decision", 0),
        "_pending_lock": ("pending", 1),
    },
    ("sched/gang.py", "GangManager"): {"_lock": ("gang", 2)},
    ("sched/state.py", "ClusterState"): {"_lock": ("ledger", 3)},
    ("sched/journal.py", "StateJournal"): {"_cond": ("journal", 4)},
    ("sched/shard.py", "ShardRouter"): {"_lock": ("router", 5)},
}

#: (path suffix, class) -> {self.<root>.<method>() call root: lock it
#: acquires}. Calls through these attributes take the mapped lock.
CALL_ROOTS = {
    ("sched/extender.py", "Extender"): {
        "gang": ("gang", 2), "state": ("ledger", 3),
        # SnapshotCache.current() takes the gang lock first (epoch
        # read + build), then the ledger lock — level it at its
        # smallest acquisition so calling it under the ledger lock
        # flags as an inversion
        "snapshots": ("gang", 2),
    },
    ("sched/gang.py", "GangManager"): {
        "_state": ("ledger", 3),
        "snapshots": ("gang", 2),
        "_journal": ("journal", 4),
    },
    ("sched/state.py", "ClusterState"): {
        "_journal": ("journal", 4),
    },
    # a fan-out under the router map lock calls into replica
    # extenders, which start at the decision lock — level the replica
    # surface at decision so ANY replica call under `with self._lock`
    # flags as an inversion of the leaf contract
    ("sched/shard.py", "ShardRouter"): {
        "state": ("decision", 0),
        "events": ("decision", 0),
        "cycle": ("decision", 0),
        "replicas": ("decision", 0),
    },
}

#: (path suffix, class) -> {self.<method>() that re-enters a lock}
SELF_METHODS = {
    ("sched/extender.py", "Extender"): {
        "handle": ("decision", 0), "release": ("decision", 0),
    },
}


def _class_configs(sf: SourceFile, table: dict) -> dict[str, dict]:
    out = {}
    for (suffix, cls), cfg in table.items():
        if sf.in_scope((suffix,)):
            out[cls] = cfg
    return out


def check_lock_order(sf: SourceFile) -> list[Finding]:
    """Flag statically visible inversions of the declared lock order
    within the scheduling classes: a nested ``with`` on a lower-level
    lock, or a call through an attribute known to take one."""
    lock_cfg = _class_configs(sf, ORDERED_LOCKS)
    if not lock_cfg:
        return []
    root_cfg = _class_configs(sf, CALL_ROOTS)
    meth_cfg = _class_configs(sf, SELF_METHODS)
    findings: list[Finding] = []

    for cls_node in sf.tree.body:
        if not isinstance(cls_node, ast.ClassDef):
            continue
        locks = lock_cfg.get(cls_node.name)
        if locks is None:
            continue
        roots = root_cfg.get(cls_node.name, {})
        # self.<method>() re-entry levels: the hand-kept SELF_METHODS
        # entries plus one level derived from the class's own bodies —
        # a method whose statements take `with self.<ordered lock>`
        # re-enters that level when called, so a self-call to it under
        # a higher level is the same inversion as the inline `with`.
        # Derived entries carry the lock ATTR so re-entry on the very
        # lock already held (the RLock case) is not flagged.
        methods: dict[str, tuple[str, int, Optional[str]]] = {}
        for mname, mfn in callgraph.methods_of(cls_node).items():
            for stmt in mfn.body:
                for n in cfg_mod.shallow_walk(stmt):
                    if not isinstance(n, (ast.With, ast.AsyncWith)):
                        continue
                    for item in n.items:
                        a = _self_attr(item.context_expr)
                        entry = locks.get(a) if a else None
                        if entry is None:
                            continue
                        name, level = entry
                        prev = methods.get(mname)
                        if prev is None or level < prev[1]:
                            methods[mname] = (name, level, a)
        for mname, (name, level) in meth_cfg.get(cls_node.name,
                                                 {}).items():
            methods[mname] = (name, level, None)

        class V(ast.NodeVisitor):
            def __init__(self) -> None:
                # held (attr, name, level), acquisition order
                self.held: list[tuple[str, str, int]] = []

            def _flag(self, lineno: int, name: str, level: int,
                      how: str) -> None:
                attr, hname, hlevel = max(self.held, key=lambda h: h[2])
                if level < hlevel:
                    findings.append(Finding(
                        "lock-order", sf.rel, lineno,
                        f"{how} acquires the {name} lock (level "
                        f"{level}) while holding the {hname} lock "
                        f"(level {hlevel}); the declared order is "
                        f"decision -> pending -> gang -> ledger "
                        f"-> journal -> router",
                    ))

            def _visit_with(self, node) -> None:
                # items acquire left to right: each is checked (and then
                # held) against the ones before it, so a single-statement
                # `with self._pending_lock, self._decision_lock:` is the
                # same inversion as the nested spelling
                acquired = 0
                for item in node.items:
                    self.visit(item.context_expr)
                    attr = _self_attr(item.context_expr)
                    entry = locks.get(attr) if attr else None
                    if entry is None:
                        continue
                    name, level = entry
                    already = any(h[0] == attr for h in self.held)
                    if self.held and not already:
                        self._flag(node.lineno, name, level,
                                   f"`with self.{attr}`")
                    self.held.append((attr, name, level))
                    acquired += 1
                for stmt in node.body:
                    self.visit(stmt)
                del self.held[len(self.held) - acquired:]

            visit_With = _visit_with
            visit_AsyncWith = _visit_with

            def visit_Call(self, node: ast.Call) -> None:
                if self.held and isinstance(node.func, ast.Attribute):
                    fn = node.func
                    # self.<root>.<method>(...)
                    root = _self_attr(fn.value)
                    if root is not None and root in roots:
                        name, level = roots[root]
                        self._flag(node.lineno, name, level,
                                   f"call self.{root}.{fn.attr}()")
                    # self.<method>(...)
                    if _self_attr(fn) is not None and fn.attr in methods:
                        name, level, attr = methods[fn.attr]
                        if not (attr is not None
                                and any(h[0] == attr
                                        for h in self.held)):
                            self._flag(node.lineno, name, level,
                                       f"call self.{fn.attr}()")
                self.generic_visit(node)

        V().visit(cls_node)
    return findings


# -- shared-state ------------------------------------------------------------

#: The guarded-attribute registry, seeded from the classes whose state
#: is mutated from threading.Thread targets (webhook loop, watchers,
#: eviction/lifecycle loops, sink drains): (path suffix, class) ->
#: {attribute: the self lock that must be held to touch it}. Growing a
#: class a new cross-thread structure means declaring it here — the
#: lint then enforces the locking everywhere the attribute appears.
GUARDED_ATTRS = {
    ("sched/state.py", "ClusterState"): {
        "_nodes": "_lock", "_slices": "_lock", "_allocs": "_lock",
        "_hosts_cache": "_lock", "_epoch": "_lock",
        "_occ_cache": "_lock",
        # bulk ingest + generation resync structures:
        # touched from webhook threads, the background warmer, and
        # resync loops alike
        "_lazy_payloads": "_lock",
        "_gen_log": "_lock", "_generation": "_lock",
    },
    ("sched/gang.py", "GangManager"): {
        "_reservations": "_lock", "_terminating_coords": "_lock",
        "_epoch": "_lock",
    },
    ("sched/extender.py", "Extender"): {
        "_pending": "_pending_lock",
        "_bind_gang_info": "_decision_lock",
    },
    ("obs/events.py", "EventJournal"): {
        "_ring": "_lock", "_live": "_lock", "_by_reason": "_lock",
        "_seq": "_lock", "_total": "_lock",
    },
    ("obs/health.py", "HealthSampler"): {
        "_latest": "_lock", "_states": "_lock", "_windows": "_lock",
        "_transition_counts": "_lock",
    },
    ("plugin/server.py", "AllocIntentCache"): {
        "_intents": "_lock", "_satisfied": "_lock",
    },
    ("plugin/server.py", "DevicePluginServer"): {
        "_watch_queues": "_watch_lock",
    },
    # the sharded plane: the router's routing maps are
    # mutated from webhook threads, the fan-out pool's callbacks, and
    # the health/respawn loop alike — all behind the leaf map lock.
    # (_swept_at and the counters stay unregistered: single-writer or
    # deliberately lock-free "last seen" scalars.)
    ("sched/shard.py", "ShardRouter"): {
        "_slice_replica": "_lock", "_node_replica": "_lock",
        "_pod_replica": "_lock", "_gang_replica": "_lock",
        "_dcn": "_lock", "_pod_attempts": "_lock",
        "_aborted_dcn": "_lock", "_alloc_cache": "_lock",
        "_gauge_cache": "_lock", "_fit_cache": "_lock",
        "_rsv_cache": "_lock",
    },
    # the journal's enqueue surface: everything the drain thread and
    # the under-the-ledger note() path share rides the condition.
    # (_file/_bytes stay unregistered — drain-thread-owned, except the
    # pre-serving compact_wal, which holds the cond anyway.)
    ("sched/journal.py", "StateJournal"): {
        "_queue": "_cond", "_seq": "_cond", "_closed": "_cond",
        "_ckpt_wanted": "_cond", "_last_ckpt_req": "_cond",
    },
    # the capacity recorder's stranded ledger and its per-demand
    # classification memo: written from planner refusal seams, read
    # and expired from the observability listener's threads.
    ("obs/capacity.py", "CapacityRecorder"): {
        "_stranded": "_lock", "_classified_at": "_lock",
    },
}

#: attributes serialized by ANOTHER object's lock: (path suffix,
#: class) -> {holder attr: lock attr}. ``SchedulingCycle`` owns no
#: lock — the Extender serializes every touch under its decision
#: lock — so the checkable seam is the CALL SITE: every
#: ``self.cycle.<m>(...)`` in the Extender outside `with
#: self._decision_lock` is a finding (``__init__`` and ``*_locked``
#: exempt, like the attribute check).
EXTERNALLY_LOCKED_ROOTS = {
    ("sched/extender.py", "Extender"): {
        "cycle": "_decision_lock",
    },
}


def _unguarded_touches(fn, guarded: dict) -> list[tuple[int, str, str]]:
    """(line, attr, lock) for every registry-declared attribute touched
    outside a lexical ``with self.<lock>`` within one function body."""
    out: list[tuple[int, str, str]] = []
    lock_attrs = set(guarded.values())

    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.held: list[str] = []

        def _visit_with(self, node) -> None:
            acquired = 0
            for item in node.items:
                self.visit(item.context_expr)
                a = _self_attr(item.context_expr)
                if a in lock_attrs:
                    self.held.append(a)
                    acquired += 1
            for stmt in node.body:
                self.visit(stmt)
            del self.held[len(self.held) - acquired:]

        visit_With = _visit_with
        visit_AsyncWith = _visit_with

        def visit_Attribute(self, node: ast.Attribute) -> None:
            attr = _self_attr(node)
            lock = guarded.get(attr) if attr else None
            if lock is not None and lock not in self.held:
                out.append((node.lineno, attr, lock))
            self.generic_visit(node)

    V().visit(fn)
    return out


def check_shared_state(sf: SourceFile,
                       registry: Optional[dict] = None) -> list[Finding]:
    """Every read/write of a registry-declared attribute must sit
    lexically inside ``with self.<declared lock>``. ``__init__`` (no
    concurrency yet) is exempt. Two interprocedural refinements ride
    the intra-class call graph (one level, closed-world):

      * a method whose touches are unguarded is ACCEPTED when every
        intra-class call site lexically holds the required lock — the
        Extender.bind pattern, previously a waiver;
      * a ``*_locked`` helper's own body stays exempt, but every call
        site of it must hold the locks the body's touches need — the
        other half of the naming contract.

    Plus the EXTERNALLY_LOCKED_ROOTS seam: calls through a holder
    attribute that another object's lock serializes (``self.cycle``
    under the decision lock) are checked at the call site."""
    table = registry if registry is not None else GUARDED_ATTRS
    cfg_tbl = _class_configs(sf, table)
    findings: list[Finding] = []

    for cls_node in sf.tree.body:
        if not isinstance(cls_node, ast.ClassDef):
            continue
        guarded = cfg_tbl.get(cls_node.name)
        if guarded is None:
            continue
        locks_all = frozenset(guarded.values())
        cg = callgraph.ClassGraph(cls_node, locks_all)

        def site_held(site: callgraph.Site) -> frozenset:
            c = site.caller
            if c.name == "__init__" or c.name.endswith("_locked"):
                # no concurrency yet / documented as under the lock
                return locks_all
            return site.held

        for fn in cls_node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__":
                continue
            touches = _unguarded_touches(fn, guarded)
            if not touches:
                continue
            if fn.name.endswith("_locked"):
                # the body is exempt; its CALLERS must hold what the
                # body's direct touches need
                needed = sorted({lock for _, _, lock in touches})
                for site in cg.sites_of(fn.name):
                    missing = [lk for lk in needed
                               if lk not in site_held(site)]
                    if missing:
                        findings.append(Finding(
                            "shared-state", sf.rel, site.call.lineno,
                            f"self.{fn.name}() called without holding "
                            f"`self.{missing[0]}` — its body touches "
                            f"attributes declared guarded in the "
                            f"shared-state registry "
                            f"(analysis/locks.py GUARDED_ATTRS)",
                        ))
                continue
            # caller-proof, per lock: an unguarded touch is accepted
            # when every intra-class call site of this method holds
            # its lock (and at least one such site exists)
            sites = cg.sites_of(fn.name)
            proven = {
                lk for lk in {lock for _, _, lock in touches}
                if sites and all(lk in site_held(s) for s in sites)
            }
            for line, attr, lock in touches:
                if lock in proven:
                    continue
                findings.append(Finding(
                    "shared-state", sf.rel, line,
                    f"self.{attr} touched outside `with "
                    f"self.{lock}` — declared guarded in the "
                    f"shared-state registry "
                    f"(analysis/locks.py GUARDED_ATTRS)",
                ))

    for (suffix, cls), roots in EXTERNALLY_LOCKED_ROOTS.items():
        if not sf.in_scope((suffix,)):
            continue
        cls_node = callgraph.find_class(sf.tree, cls)
        if cls_node is None:
            continue
        for fn in cls_node.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__" or fn.name.endswith("_locked"):
                continue
            for line, holder, lock in _holder_calls(fn, roots):
                findings.append(Finding(
                    "shared-state", sf.rel, line,
                    f"call through self.{holder} outside `with "
                    f"self.{lock}` — self.{holder} owns no lock and "
                    f"is serialized by the {cls} {lock} "
                    f"(analysis/locks.py EXTERNALLY_LOCKED_ROOTS)",
                ))
    return findings


def _holder_calls(fn, roots: dict) -> list[tuple[int, str, str]]:
    """(line, holder, lock) for every ``self.<holder>.<m>(...)`` call
    outside a lexical ``with self.<lock>`` within one function."""
    out: list[tuple[int, str, str]] = []
    lock_attrs = set(roots.values())

    class V(ast.NodeVisitor):
        def __init__(self) -> None:
            self.held: list[str] = []

        def _visit_with(self, node) -> None:
            acquired = 0
            for item in node.items:
                self.visit(item.context_expr)
                a = _self_attr(item.context_expr)
                if a in lock_attrs:
                    self.held.append(a)
                    acquired += 1
            for stmt in node.body:
                self.visit(stmt)
            del self.held[len(self.held) - acquired:]

        visit_With = _visit_with
        visit_AsyncWith = _visit_with

        def visit_Call(self, node: ast.Call) -> None:
            if isinstance(node.func, ast.Attribute):
                holder = _self_attr(node.func.value)
                lock = roots.get(holder) if holder else None
                if lock is not None and lock not in self.held:
                    out.append((node.lineno, holder, lock))
            self.generic_visit(node)

    V().visit(fn)
    return out
