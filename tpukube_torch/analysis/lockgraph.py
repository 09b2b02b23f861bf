"""Dynamic lock-order detector — the runtime half of the lint prover.

Lockdep for the control plane: ``install()`` replaces the
``threading.Lock``/``threading.RLock`` factories with ones that wrap
locks created BY THE PORT'S CODE in a recording proxy (third-party and
stdlib-internal locks — grpc, logging, Condition/Event internals — stay
raw, so the graph holds exactly the locks the codebase declares).
Every acquisition records happens-before edges from each lock the
thread already holds to the one being acquired, aggregated by lock
CREATION SITE (``file:lineno`` — lockdep's lock-class notion: all
GangManager._lock instances are one node). A cycle in that graph means
two threads can acquire the same lock classes in opposite orders — a
potential deadlock, reported without ever having to hit it.

Off by default with zero overhead: nothing is patched until
``install()`` runs. The ``lock_monitor`` config flag turns it on for
``python -m tpukube_torch.cli sim`` (the result JSON gains a
``lock_graph`` key), for ``SimCluster`` and for each ``shard-worker``
daemon (its report rides ``/worker/summary``); tests use the
``monitor()`` context manager directly.
Reentrant acquisitions of the same instance record no edge (RLocks);
distinct instances of one site DO edge, including self-edges — two
ClusterStates locked against each other is a real inversion class.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Optional

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_OWN_FILE = __file__

#: the default instrumentation scope: files under the tpukube_torch
#: package directory itself — a PATH PREFIX, not a substring, so an
#: install under e.g. ~/src/tpukube_torch/.venv/site-packages/ does not
#: accidentally instrument third-party internals (foreign lock orders
#: would pollute the graph with cycles unrelated to the declared
#: scheduling locks)
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(_OWN_FILE)))
PACKAGE_SCOPE = PACKAGE_DIR + os.sep
#: sites are named relative to the package's parent directory, so a
#: site reads ``tpukube_torch/sched/gang.py:N`` wherever the checkout is
_SITE_ROOT = os.path.dirname(PACKAGE_DIR) + os.sep

# install()/uninstall() bookkeeping — guarded by a raw (never proxied)
# lock; ref-counted so nested installs (SimCluster inside a monitored
# test) share one monitor
_state_mu = _REAL_LOCK()
_active: Optional["LockOrderMonitor"] = None
_depth = 0


class _LockProxy:
    """Records acquire/release around a real lock. Everything else —
    including Condition's _release_save/_acquire_restore fast path —
    delegates to the wrapped lock via __getattr__."""

    def __init__(self, inner, site: str, monitor: "LockOrderMonitor"):
        self._inner = inner
        self.site = site
        self._monitor = monitor

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._monitor.on_acquired(self)
        return got

    def release(self) -> None:
        self._inner.release()  # raises before any bookkeeping if unowned
        self._monitor.on_released(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name: str):
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<LockProxy {self.site} of {self._inner!r}>"


class LockOrderMonitor:
    """The acquisition-order graph: nodes are lock creation sites,
    edges are observed held->acquired pairs, per thread."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        self._local = threading.local()
        self._edges: dict[tuple[str, str], int] = {}
        self._sites: dict[str, int] = {}  # site -> locks created there
        # id(proxy) -> the per-thread stack it is currently held on:
        # plain Locks may legally be RELEASED by a different thread
        # (handoff patterns), and the proxy must leave its acquiring
        # thread's stack either way — a stale entry would fabricate
        # held->acquired edges (and possibly cycles) forever after
        self._holder: dict[int, list] = {}
        self.acquisitions = 0

    # -- wrapping ----------------------------------------------------------
    def wrap(self, inner, site: str):
        with self._mu:
            self._sites[site] = self._sites.get(site, 0) + 1
        return _LockProxy(inner, site, self)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def on_acquired(self, proxy: _LockProxy) -> None:
        st = self._stack()
        reentrant = any(h is proxy for h in st)
        if not reentrant:
            with self._mu:
                self.acquisitions += 1
                for held in list(st):
                    if held is proxy:
                        continue
                    key = (held.site, proxy.site)
                    self._edges[key] = self._edges.get(key, 0) + 1
                self._holder[id(proxy)] = st
        st.append(proxy)

    def on_released(self, proxy: _LockProxy) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] is proxy:
                del st[i]
                if not any(h is proxy for h in st):
                    with self._mu:
                        self._holder.pop(id(proxy), None)
                return
        # released on a different thread than the acquirer (legal for
        # plain Locks): clear the proxy from ITS holder's stack so that
        # thread's future acquisitions record no phantom edges
        with self._mu:
            holder = self._holder.pop(id(proxy), None)
            if holder is not None:
                for i in range(len(holder) - 1, -1, -1):
                    if holder[i] is proxy:
                        del holder[i]
                        break

    # -- the graph ---------------------------------------------------------
    def edges(self) -> dict[tuple[str, str], int]:
        with self._mu:
            return dict(self._edges)

    def cycles(self) -> list[list[str]]:
        """Cycles in the site graph (Tarjan SCCs of size > 1, plus
        self-loops): each is a set of lock classes some pair of threads
        can acquire in opposite orders — a potential deadlock."""
        return self._cycles_of(self.edges())

    @staticmethod
    def _cycles_of(edges: dict[tuple[str, str], int]) -> list[list[str]]:
        adj: dict[str, set[str]] = {}
        for a, b in edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        sccs: list[list[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            # iterative Tarjan (daemon graphs are small, but recursion
            # limits are not a failure mode a linter should have)
            work = [(v, iter(sorted(adj[v])))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(adj[w]))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    sccs.append(scc)

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)
        out = []
        for scc in sccs:
            if len(scc) > 1 or (scc[0], scc[0]) in edges:
                out.append(sorted(scc))
        return sorted(out)

    def report(self) -> dict[str, Any]:
        """The lock graph as plain JSON: what ``cli sim`` attaches
        under the ``lock_graph`` result key when lock_monitor is on.
        One consistent snapshot under the monitor's own lock — daemon
        threads may still be creating/acquiring locks while a live
        cluster is being inspected."""
        with self._mu:
            sites = dict(sorted(self._sites.items()))
            edges = dict(self._edges)
            acquisitions = self.acquisitions
        return {
            "sites": sites,
            "acquisitions": acquisitions,
            "edges": [
                {"from": a, "to": b, "count": n}
                for (a, b), n in sorted(edges.items())
            ],
            "cycles": self._cycles_of(edges),
        }


def _trim(filename: str) -> str:
    path = os.path.abspath(filename)
    if path.startswith(_SITE_ROOT):
        return path[len(_SITE_ROOT):].replace(os.sep, "/")
    return filename


def _make_factory(real, scope: Optional[str]):
    def factory(*args, **kwargs):
        inner = real(*args, **kwargs)
        with _state_mu:
            mon = _active
        if mon is None:
            return inner
        frame = sys._getframe(1)
        filename = frame.f_code.co_filename
        if filename == _OWN_FILE:
            return inner  # never instrument the monitor's own locks
        if scope is not None \
                and not os.path.abspath(filename).startswith(scope):
            # only locks created DIRECTLY by in-scope code: stdlib
            # internals (Condition/Event/Thread plumbing) and
            # third-party libraries stay raw
            return inner
        return mon.wrap(inner, f"{_trim(filename)}:{frame.f_lineno}")
    return factory


def install(scope: Optional[str] = PACKAGE_SCOPE) -> LockOrderMonitor:
    """Patch the threading.Lock/RLock factories; ref-counted (nested
    installs share the first monitor). ``scope`` is the directory
    prefix lock-creating files must live under (default: the
    tpukube_torch package; None = instrument everything except this module). The
    patch itself happens under the state mutex so concurrent
    install/uninstall cannot leave an active monitor with unpatched
    factories (or vice versa)."""
    global _active, _depth
    with _state_mu:
        if _depth > 0:
            _depth += 1
            assert _active is not None
            return _active
        _active = LockOrderMonitor()
        _depth = 1
        monitor = _active
        threading.Lock = _make_factory(_REAL_LOCK, scope)
        threading.RLock = _make_factory(_REAL_RLOCK, scope)
    return monitor


def active() -> Optional[LockOrderMonitor]:
    """The currently installed monitor, or None when the detector is
    off. The read-only accessor the federated surfaces use: a worker's
    ``replica_summary`` attaches its report when a monitor is live, and
    the router merges the fleet's edge sets into one cycle check —
    without either surface owning install/uninstall."""
    with _state_mu:
        return _active


def uninstall() -> None:
    """Undo one install(); the factories revert when the last nested
    install unwinds. Live proxies keep recording into their monitor —
    a daemon thread outliving the monitored window stays observed."""
    global _active, _depth
    with _state_mu:
        if _depth == 0:
            return
        _depth -= 1
        if _depth > 0:
            return
        _active = None
        threading.Lock = _REAL_LOCK
        threading.RLock = _REAL_RLOCK


class monitor:
    """Context manager: ``with lockgraph.monitor() as mon: ...`` then
    inspect ``mon.report()`` / ``mon.cycles()``."""

    def __init__(self, scope: Optional[str] = PACKAGE_SCOPE):
        self._scope = scope
        self._monitor: Optional[LockOrderMonitor] = None

    def __enter__(self) -> LockOrderMonitor:
        self._monitor = install(scope=self._scope)
        return self._monitor

    def __exit__(self, *exc) -> None:
        uninstall()
