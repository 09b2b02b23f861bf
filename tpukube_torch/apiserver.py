"""Apiserver channel and the loops that act on the extender's decisions —
the port's own copy of the part of ``tpukube/apiserver.py`` that
preemption and the pod lifecycle need:

  * :class:`FakeApiServer` — in-memory, thread-safe Node/Pod store with the
    Eviction subresource's semantics (a PodDisruptionBudget refuses with
    False; ``graceful`` pods get a ``deletionTimestamp`` and linger until
    :meth:`FakeApiServer.finish_termination`), and the informer contract
    (list with a resourceVersion, then a watch that replays the gap).
  * :class:`EvictionExecutor` — drains ``extender.pending_evictions``
    through ``evict_pod``, retries blocked and failed evictions forever,
    tracks accepted ones until the pod object is gone, and only then
    sends the recorded ``victim_gone`` decision that opens a preempting
    gang's bind gate.
  * :class:`PodLifecycleReleaseLoop` — turns a pod's end (DELETED, or a
    terminal phase) into the extender's recorded ``release`` decision, and
    confirms in-flight evictions from the DELETED events it sees.
  * :func:`rebuild_extender` — a restarted extender's ledger and gangs
    from the apiserver's live, bound pods.

Any object with ``evict_pod``/``get_pod``/``list_pods`` serves as the
channel (the sim harness's pod store does). Not ported (ROADMAP.md):
``RestApiServer`` (the Kubernetes REST channel), the annotation syncer,
the alloc-intent watcher and reconcile loop, the admission feed, the pod
informer, the node-topology refresh loop, the bind effector, and the
executor's ``Retrier`` for its GET confirms.
"""

from __future__ import annotations

import copy
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Optional

from tpukube_torch.core import codec, retry

log = logging.getLogger("tpukube_torch.apiserver")


class ApiServerError(RuntimeError):
    """Apiserver request failure; ``code`` carries the HTTP status when the
    server answered (None for transport errors), so callers can branch on
    429 (PDB-blocked eviction) / 404 (already gone)."""

    def __init__(self, message: str, code: Optional[int] = None) -> None:
        super().__init__(message)
        self.code = code


class FakeApiServer:
    """In-memory apiserver: Node/Pod metadata only, which is all this
    framework reads or writes. Thread-safe; the sim's source of truth."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._nodes: dict[str, dict[str, str]] = {}
        self._pods: dict[str, dict[str, Any]] = {}
        self.patch_log: list[tuple[str, str]] = []  # (kind, name) for tests
        # pod keys whose eviction a PodDisruptionBudget would deny (the
        # fake's stand-in for the real apiserver's 429): tests add keys
        # here to exercise the executor's requeue path
        self.pdb_blocked: set[str] = set()
        # pod keys that terminate GRACEFULLY on eviction: the accepted
        # eviction stamps deletionTimestamp and the object lingers until
        # finish_termination() — the real apiserver's behavior, and the
        # window the gang bind termination gate exists for
        self.graceful: set[str] = set()
        # live watch subscriptions (watch_pods): each holds an event queue
        self._watch_queues: list = []
        # the informer contract's versioning half: every pod mutation bumps
        # the resourceVersion and lands in a bounded history, so a watch
        # started FROM a list's version replays the events that raced into
        # the list->watch gap instead of silently dropping them (exactly
        # what the REST path's resourceVersion parameter does)
        self._rv = 0
        self._history: deque = deque(maxlen=4096)

    def _notify(self, etype: str, pod: dict[str, Any]) -> None:
        """Fan a pod event out to live watchers (call under self._lock).
        Each watcher gets its OWN copy (a consumer mutating its event
        must not corrupt siblings or the replay history)."""
        self._rv += 1
        snap = copy.deepcopy(pod)
        self._history.append((self._rv, etype, snap))
        for q in self._watch_queues:
            q.put((etype, copy.deepcopy(snap)))

    # -- nodes -------------------------------------------------------------
    def patch_node_annotations(
        self, name: str, annotations: dict[str, str]
    ) -> None:
        with self._lock:
            self._nodes.setdefault(name, {}).update(annotations)
            self.patch_log.append(("node", name))

    def list_nodes(self) -> list[dict[str, Any]]:
        return self.node_objects()

    def node_objects(self) -> list[dict[str, Any]]:
        """Node list in the webhook wire shape (the sim's kube-scheduler
        builds ExtenderArgs from this)."""
        with self._lock:
            return [
                {"metadata": {"name": n, "annotations": dict(a)}}
                for n, a in sorted(self._nodes.items())
            ]

    # -- pods --------------------------------------------------------------
    def upsert_pod(self, pod: dict[str, Any]) -> None:
        meta = pod["metadata"]
        key = f"{meta.get('namespace', 'default')}/{meta['name']}"
        with self._lock:
            etype = "MODIFIED" if key in self._pods else "ADDED"
            self._pods[key] = pod
            self._notify(etype, pod)

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            pod = self._pods.pop(f"{namespace}/{name}", None)
            if pod is not None:
                self._notify("DELETED", pod)

    def evict_pod(
        self, namespace: str, name: str, dry_run: bool = False
    ) -> bool:
        """Eviction-subresource semantics: True once the eviction is
        accepted (or the pod is already gone), False when a
        PodDisruptionBudget blocks it — the same contract RestApiServer
        derives from 2xx/404 vs 429. ``dry_run`` only answers the PDB
        question (the real API's dryRun=All). Keys in ``graceful`` get a
        deletionTimestamp and linger until finish_termination(); others
        delete instantly (grace 0)."""
        key = f"{namespace}/{name}"
        with self._lock:
            if key in self.pdb_blocked:
                return False
            if dry_run:
                return True
            if key in self.graceful:
                pod = self._pods.get(key)
                if pod is not None:
                    pod["metadata"].setdefault(
                        "deletionTimestamp", "2026-01-01T00:00:00Z"
                    )
                    self._notify("MODIFIED", pod)
            else:
                pod = self._pods.pop(key, None)
                if pod is not None:
                    self._notify("DELETED", pod)
            self.patch_log.append(("evict", key))
        return True

    def finish_termination(self, namespace: str, name: str) -> None:
        """A graceful pod's containers finally stopped: the object goes
        away (kubelet finishing the eviction the subresource started)."""
        with self._lock:
            pod = self._pods.pop(f"{namespace}/{name}", None)
            if pod is not None:
                self._notify("DELETED", pod)

    def get_pod(self, namespace: str, name: str) -> Optional[dict[str, Any]]:
        with self._lock:
            return self._pods.get(f"{namespace}/{name}")

    def watch_pods(self, node_name: Optional[str] = None,
                   timeout_seconds: int = 300,
                   handle_box: Optional[list] = None,
                   resource_version: Optional[str] = None):
        """The fake's watch half of the informer contract: yields
        (event_type, pod) for every mutation after ``resource_version``
        (a list_pods_with_rv result — events that raced into the
        list->watch gap are REPLAYED from the bounded history, exactly
        like the REST path's resourceVersion parameter) or, without a
        version, after this call. Subscription and replay snapshot happen
        atomically under the store lock — not at the generator's first
        next() — so no event can slip between them. Honors the
        spec.nodeName field selector. The handle placed in ``handle_box``
        exposes close() (enqueues a poison pill), so a loop's stop()
        unblocks a quiet watch exactly as it does the REST stream."""
        q: queue.SimpleQueue = queue.SimpleQueue()

        class _Handle:
            def close(self) -> None:
                q.put(None)

        try:
            since = int(resource_version) if resource_version else None
        except ValueError:
            since = None
        history = self._history
        with self._lock:
            if since is not None:
                if history and history[0][0] > since + 1:
                    # events between `since` and the oldest retained entry
                    # were evicted from the bounded history: replaying
                    # would silently skip them. The real apiserver answers
                    # 410 Gone; the informer's reconnect then resyncs with
                    # a fresh list — same contract here.
                    raise ApiServerError(
                        f"resourceVersion {since} too old "
                        f"(history starts at {history[0][0]})", code=410,
                    )
                for rv, etype, obj in history:
                    if rv > since:
                        q.put((etype, copy.deepcopy(obj)))
            self._watch_queues.append(q)
        if handle_box is not None:
            handle_box.append(_Handle())

        def _events():
            try:
                deadline = time.monotonic() + timeout_seconds
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return  # server timeout; caller reconnects
                    try:
                        ev = q.get(timeout=remaining)
                    except queue.Empty:
                        return
                    if ev is None:
                        return  # closed via the handle
                    etype, pod = ev
                    if (node_name is None or (pod.get("spec") or {})
                            .get("nodeName") == node_name):
                        yield etype, pod
            finally:
                with self._lock:
                    if q in self._watch_queues:
                        self._watch_queues.remove(q)

        return _events()

    def list_pods(self, node_name: Optional[str] = None) -> list[dict[str, Any]]:
        with self._lock:
            out = []
            for pod in self._pods.values():
                if (node_name is None
                        or pod.get("spec", {}).get("nodeName") == node_name):
                    out.append(pod)
            return out

    def list_pods_with_rv(
        self, node_name: Optional[str] = None
    ) -> tuple[list[dict[str, Any]], str]:
        """(pods, resourceVersion) — list half of the informer contract:
        watch from the returned version and no
        event between the list and the watch is lost."""
        with self._lock:
            out = [
                pod for pod in self._pods.values()
                if (node_name is None
                    or pod.get("spec", {}).get("nodeName") == node_name)
            ]
            return out, str(self._rv)


class _PollLoop:
    """start/stop/check_once scaffolding of the sync loops: a thread that
    polls, or ``check_once`` stepped deterministically by a caller."""

    def __init__(self, poll_seconds: float, name: str) -> None:
        self._poll = poll_seconds
        self._name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self) -> bool:  # pragma: no cover - overridden
        raise NotImplementedError

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError(f"{self._name} already started")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=self._name
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self.check_once()
            except Exception:
                log.exception("%s poll failed", self._name)


class _WatchLoop(_PollLoop):
    """Informer-pattern scaffolding shared by the watching loops:
    list-resync at every (re)connect, then a watch FROM the list's
    resourceVersion, with the poll loop as the no-watch fallback.
    Subclasses implement ``_resync()`` (full list reconciliation,
    returning ``(changed, resourceVersion)``) and
    ``_apply_watch_event(etype, obj)``; the api's stream is its
    ``watch_pods``."""

    def __init__(
        self, name: str, api, node_name: Optional[str],
        poll_seconds: float, use_watch: bool,
    ) -> None:
        super().__init__(poll_seconds, name)
        self._api = api
        self._node = node_name
        self._use_watch = use_watch and hasattr(api, "watch_pods")
        # Stream liveness, NOT thread liveness: a watch thread is alive
        # through reconnect backoff and list-resync windows where DELETED
        # events are silently missed. True only between a successful
        # (resync, stream open) and the stream's end/failure;
        # last_event_time (wall clock) stamps the stream connect and
        # every delivered event.
        self._stream_connected = False
        self.last_event_time: Optional[float] = None
        # optional EventJournal (obs/events.py), wired by the daemon
        # main: a WatchReconnected event per stream re-establishment —
        # frequent reconnects mean events are being missed in backoff
        # windows, the first thing to check when releases lag
        self.journal = None
        self._connects = 0
        self.reconnects = 0
        # reconnect pacing: one poll interval after the FIRST failure,
        # then jittered exponential growth up to 16x — a down apiserver
        # (or a 410-Gone storm) must not be hammered at a fixed cadence
        # by every informer in the fleet at once. Reset the moment a
        # stream actually (re)connects.
        self._reconnect_backoff = retry.Backoff(
            base=poll_seconds, cap=poll_seconds * 16, jitter=0.5,
        )

    def _resync(self) -> tuple[bool, Optional[str]]:  # pragma: no cover
        raise NotImplementedError

    def _apply_watch_event(
        self, etype: str, pod: dict[str, Any]
    ) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def check_once(self) -> bool:
        """One full resync; True if anything changed."""
        return self._resync()[0]

    def stream_connected(self) -> bool:
        """True while the watch stream is actually open and delivering —
        NOT during reconnect backoff or a failed resync."""
        return self._stream_connected

    def watch_status(self) -> dict[str, Any]:
        """Liveness document (the reference serves it on /statusz)."""
        return {
            "name": self._name,
            "mode": "watch" if self._use_watch else "poll",
            "thread_alive": (self._thread is not None
                             and self._thread.is_alive()),
            "stream_connected": self._stream_connected,
            "last_event_ts": self.last_event_time,
            "reconnects": self.reconnects,
            # consecutive reconnect failures driving the current
            # backoff (0 while healthy): non-zero here plus a stale
            # last_event_ts is "the apiserver is down", not "quiet"
            "reconnect_failures": self._reconnect_backoff.failures,
        }

    def _list_pods_rv(
        self, node_name: Optional[str] = None
    ) -> tuple[list[dict[str, Any]], Optional[str]]:
        """The informer contract's list half, with the plain-list
        fallback for apis without resourceVersions (one definition for
        every pod loop — watching then starts at 'now', and the
        periodic resync covers the gap)."""
        if hasattr(self._api, "list_pods_with_rv"):
            return self._api.list_pods_with_rv(node_name)
        return self._api.list_pods(node_name), None

    def _run(self) -> None:
        if not self._use_watch:
            return super()._run()
        while not self._stop.is_set():
            box: list = []
            self._stream_box = box
            delay = self._poll
            stream_t0: Optional[float] = None
            try:
                # resync at every (re)connect, then watch FROM the list's
                # resourceVersion — no event in the list->watch gap is lost
                _, rv = self._resync()
                gen = self._api.watch_pods(
                    self._node, handle_box=box, resource_version=rv
                )
                # connected from here until the stream ends or fails. The
                # reconnect backoff does NOT reset here: a stream that
                # fails every lap must keep escalating. Reset happens on
                # demonstrated liveness: a delivered event, a clean
                # stream end, or a stream that survived at least one poll
                # interval.
                self._stream_connected = True
                self.last_event_time = time.time()
                stream_t0 = time.monotonic()
                self._connects += 1
                if self._connects > 1:
                    self.reconnects += 1
                    if self.journal is not None:
                        try:
                            self.journal.emit(
                                "WatchReconnected",
                                obj=f"watch/{self._name}",
                                message=f"stream re-established "
                                        f"(reconnect #{self.reconnects}); "
                                        f"resync covered the gap",
                            )
                        except Exception:
                            log.exception("event emit failed: "
                                          "WatchReconnected")
                try:
                    for etype, pod in gen:
                        if self._stop.is_set():
                            return
                        self.last_event_time = time.time()
                        if self._reconnect_backoff.failures:
                            # the stream is demonstrably delivering
                            self._reconnect_backoff.reset()
                        self._apply_watch_event(etype, pod)
                finally:
                    self._stream_connected = False
                # clean end at the server timeout: the dial worked
                self._reconnect_backoff.reset()
            except Exception:
                if self._stop.is_set():
                    return  # stop() closed the stream under us
                # consecutive failures (down apiserver, 410 storms)
                # escalate the reconnect delay instead of replaying a
                # fixed-cadence hammer; the list-resync at the next
                # (re)connect covers every event missed meanwhile
                if (stream_t0 is not None
                        and time.monotonic() - stream_t0 > self._poll):
                    # an idle-but-open stream that lived at least a poll
                    # interval before dying is a FRESH outage, not a
                    # continuation of a dial-failure streak
                    self._reconnect_backoff.reset()
                delay = self._reconnect_backoff.next()
                log.exception(
                    "%s watch failed (consecutive failure %d); "
                    "reconnecting in %.1fs", self._name,
                    self._reconnect_backoff.failures, delay,
                )
            self._stop.wait(delay)  # backoff, then reconnect

    def stop(self) -> None:
        self._stop.set()
        # a watch thread blocked on a quiet stream can't see the stop
        # event: close its stream handle (the fake's poison pill). The
        # handle lands in the box when the watch opens, so grace a moment
        # for a stream that is still opening.
        deadline = time.monotonic() + 2.0
        while (self._use_watch
               and not (getattr(self, "_stream_box", None))
               and self._thread is not None and self._thread.is_alive()
               and time.monotonic() < deadline):
            time.sleep(0.02)
        for handle in getattr(self, "_stream_box", []) or []:
            handle.close()
        super().stop()


# pod phases whose containers have stopped for good — their devices are
# free even while the pod object lingers (phase is monotonic once terminal)
TERMINAL_PHASES = frozenset({"Succeeded", "Failed"})


def _pod_key_of(pod: dict[str, Any]) -> Optional[str]:
    meta = pod.get("metadata") or {}
    name = meta.get("name")
    if not name:
        return None
    return f"{meta.get('namespace', 'default')}/{name}"


class PodLifecycleReleaseLoop(_WatchLoop):
    """The release effector for pod lifecycle — KubeGPU's recovery loop
    ("pods on dead device fail → controller reschedules") structurally
    requires it, and so does every long-lived cluster.

    kube-scheduler only talks to the extender about pods it is *placing*;
    nothing in the webhook protocol ever says a placed pod finished.
    Without this loop a completed or deleted pod's chips stay committed in
    the ledger forever: utilization reads 100% while the hardware idles,
    later gangs cannot fit, and preemption plans evict pods that no longer
    exist. This loop watches pod lifecycle cluster-wide and turns each
    ending into the extender's recorded ``release`` decision:

      * ``DELETED``                  → release (object gone, devices freed)
      * phase ``Succeeded``/``Failed`` → release (containers stopped; the
        object lingers until a controller or operator deletes it, but the
        kubelet has already returned the devices)

    A pod carrying only a ``deletionTimestamp`` is NOT released: graceful
    termination means its containers may still hold the chips — the same
    conservative rule :class:`EvictionExecutor` applies before counting a
    preemption victim as evicted.

    The resync (every (re)connect; every poll in no-watch mode) closes
    watch gaps from both directions: listed pods in a terminal phase are
    released directly, and ledger allocations whose pod is absent from the
    list are released only after a confirming GET — the GET, not the list,
    is the authority, because the list snapshot may predate a just-bound
    pod's creation (pods are always created before they are scheduled, so
    a pod the GET still finds is alive, not leaked).

    Gang note: only committed allocations are released here. A gang
    member holding a pre-bind *reservation* (assigned, never bound) whose
    pod vanishes is rolled back by the gang layer's own TTL — the
    documented path for half-assembled gangs.
    """

    def __init__(
        self, extender, api, poll_seconds: float = 5.0,
        use_watch: bool = True, evictions: Optional["EvictionExecutor"] = None,
    ) -> None:
        super().__init__("tpukube-pod-lifecycle", api, None,
                         poll_seconds, use_watch)
        self._extender = extender
        # termination-detection unification: this loop already sees every
        # pod DELETED event, so it confirms the eviction executor's
        # in-flight terminations for free — while this loop's watch runs,
        # the executor stretches its per-key GET poll to a 30s missed-
        # event safety net (attach_watch_confirmer)
        self._evictions = evictions
        if evictions is not None:
            evictions.attach_watch_confirmer(self)
        self.released = 0  # lifecycle releases applied (tests/metrics)

    def watch_alive(self) -> bool:
        """True while DELETED events can actually flow (the executor's
        cue to defer its GET confirms here). Requires a CURRENTLY-
        CONNECTED stream, not merely a live thread: during reconnect
        backoff and list-resync windows events are silently missed, and
        deferring the GET net on a dead stream gates gang binds up to 30s
        per missed event."""
        return (self._use_watch and self._thread is not None
                and self._thread.is_alive() and self.stream_connected())

    def _confirm_eviction(self, pod_key: str) -> None:
        if self._evictions is not None:
            self._evictions.confirm_deleted(pod_key)

    def _release(self, pod_key: str, why: str, uid: str = "") -> bool:
        alloc = self._extender.state.allocation(pod_key)
        if alloc is None:
            return False
        if alloc.uid and uid and alloc.uid != uid:
            # pod names recur (StatefulSet members): this signal is about
            # a DIFFERENT incarnation than the ledger entry — a stale
            # DELETED event or stale list entry must not free the chips a
            # recreated, live pod is holding
            log.info("lifecycle signal for %s ignored: uid %s is not the "
                     "ledger's %s", pod_key, uid, alloc.uid)
            return False
        self._extender.handle("release", {"pod_key": pod_key})
        self.released += 1
        log.info("released %s (%s)", pod_key, why)
        return True

    def _apply_watch_event(self, etype: str, pod: dict[str, Any]) -> None:
        key = _pod_key_of(pod)
        if key is None:
            return
        uid = str((pod.get("metadata") or {}).get("uid") or "")
        if etype == "DELETED":
            self._confirm_eviction(key)
            self._release(key, "pod deleted", uid=uid)
            return
        phase = (pod.get("status") or {}).get("phase")
        if phase in TERMINAL_PHASES:
            self._release(key, f"phase {phase}", uid=uid)

    def _resync(self) -> tuple[bool, Optional[str]]:
        pods, rv = self._list_pods_rv()
        return self._resync_scan(pods), rv

    def _resync_scan(self, pods: list[dict[str, Any]]) -> bool:
        present: dict[str, str] = {}  # key -> listed uid
        changed = False
        for pod in pods:
            key = _pod_key_of(pod)
            if key is None:
                continue
            uid = str((pod.get("metadata") or {}).get("uid") or "")
            present[key] = uid
            if (pod.get("status") or {}).get("phase") in TERMINAL_PHASES:
                changed |= self._release(key, "terminal phase (resync)",
                                         uid=uid)
        for alloc in self._extender.state.allocations():
            listed_uid = present.get(alloc.pod_key)
            if listed_uid is not None:
                if not (alloc.uid and listed_uid
                        and alloc.uid != listed_uid):
                    continue  # same (or indeterminate) incarnation — alive
                # a same-name pod with a DIFFERENT uid: the allocation's
                # incarnation is gone; holding its entry would 409 the
                # newcomer's bind forever (phantom allocation)
                changed |= self._release(alloc.pod_key,
                                         "pod replaced (resync)")
                continue
            namespace, name = alloc.pod_key.split("/", 1)
            try:
                pod = self._api.get_pod(namespace, name)
            except Exception as e:
                log.warning("lifecycle confirm of %s failed, retrying: %s",
                            alloc.pod_key, e)
                continue
            if pod is not None:
                cur_uid = str((pod.get("metadata") or {}).get("uid") or "")
                if not (alloc.uid and cur_uid and alloc.uid != cur_uid):
                    # same (or indeterminate) incarnation — but a pod the
                    # stale LIST missed may ALREADY be terminal: trust the
                    # GET's phase, or the chips wait a full reconnect
                    # interval for release
                    phase = (pod.get("status") or {}).get("phase")
                    if phase in TERMINAL_PHASES:
                        changed |= self._release(
                            alloc.pod_key, f"phase {phase} (resync confirm)",
                            uid=cur_uid,
                        )
                    continue
                changed |= self._release(alloc.pod_key,
                                         "pod replaced (resync)")
                continue
            # (executor-tracked eviction victims never reach this loop —
            # their ledger entries were released before queueing; a
            # DELETED event missed in a reconnect gap is recovered by the
            # executor's own stretched GET net, WATCH_CONFIRM_GRACE_S)
            changed |= self._release(alloc.pod_key, "pod absent (resync)")
        return changed


class EvictionExecutor(_PollLoop):
    """The effector for the extender's eviction decisions.

    Preemption and gang rollback leave victim pod keys on
    ``extender.pending_evictions`` — the ledger already shows their chips
    free, so a victim left running would double-allocate on first reuse.
    This loop drains the queue through the apiserver channel's
    ``evict_pod`` (the Eviction subresource on a real cluster). A
    PDB-blocked or transiently-failing eviction is requeued and retried
    every poll, forever: eviction is a correctness obligation, not
    best-effort, so the only terminal states are "pod gone" and "operator
    intervened". The sim harness's ``drain_evictions`` is a thin wrapper
    over :meth:`drain`."""

    def __init__(self, extender, api, poll_seconds: float = 1.0,
                 clock=None) -> None:
        from tpukube_torch.core.clock import SYSTEM

        super().__init__(poll_seconds, "tpukube-evictions")
        self._extender = extender
        self._api = api
        # eviction-confirm ages and the watch-confirm grace window are
        # scheduling-semantic time: injectable (core/clock.py) so the
        # discrete-event sim drives them on compressed time
        self._clock = clock if clock is not None else SYSTEM
        # eviction accepted by the apiserver but deletion not yet
        # confirmed: a 2xx on the Eviction subresource only STARTS
        # graceful termination; the pod keeps its devices until its
        # containers actually stop, so "evicted" is only counted once the
        # pod object is gone. Guarded by _state_lock: the lifecycle
        # watch's confirm_deleted runs on its own thread.
        self._terminating: set[str] = set()
        # keys whose eviction POST is IN FLIGHT right now: an instantly-
        # deleted victim's DELETED event can reach the lifecycle watch
        # (confirm_deleted) before drain() regains the lock to add the
        # key to _terminating — without pre-registration that confirm
        # would miss and the gang would wait out the 30s GET net
        self._expecting: set[str] = set()
        self._confirmed_early: set[str] = set()
        self._state_lock = threading.Lock()
        # pod key -> monotonic time of its FIRST drain attempt; feeds the
        # oldest-age gauge operators alarm on (a PDB-wedged eviction is
        # a capacity leak in progress)
        self._pending_since: dict[str, float] = {}
        # a live pod watch that calls confirm_deleted (the lifecycle
        # loop): while it is running, the per-key GET confirm only covers
        # keys the watch has had ample time to see — O(1) confirmation
        # traffic instead of one GET per victim per poll
        self._watch_confirmer = None
        self.evicted = 0   # pods confirmed gone (tests/metrics)
        self.blocked = 0   # PDB 429s requeued (tests/metrics)
        self.failures = 0  # transport/API errors requeued (tests/metrics)

    # while a watch confirmer runs, GET-confirm only keys older than this
    # (the watch delivers DELETED within ms; the stretched GET is the
    # missed-event safety net, not the primary channel)
    WATCH_CONFIRM_GRACE_S = 30.0

    def attach_watch_confirmer(self, loop) -> None:
        """Called by PodLifecycleReleaseLoop when wired with this
        executor: its DELETED events become the primary termination
        confirmation channel."""
        self._watch_confirmer = loop

    def depth(self) -> int:
        """Evictions not yet confirmed done: queued + terminating."""
        with self._state_lock:
            return (len(self._extender.pending_evictions)
                    + len(self._terminating))

    def oldest_age_seconds(self, now: Optional[float] = None) -> float:
        """Age of the oldest unconfirmed eviction (0.0 when idle),
        measured from its first drain attempt."""
        with self._state_lock:
            if not self._pending_since:
                return 0.0
            now = self._clock.monotonic() if now is None else now
            return max(0.0, now - min(self._pending_since.values()))

    def _confirmed(self, pod_key: str) -> None:
        """Bookkeeping for a victim whose pod object is gone (call with
        _state_lock held for the set mutation done by callers); tells the
        extender through the recorded ``victim_gone`` decision so gated
        gang binds unblock deterministically."""
        self.evicted += 1
        self._pending_since.pop(pod_key, None)

    def _notify_gone(self, pod_key: str) -> None:
        handle = getattr(self._extender, "handle", None)
        if handle is not None:
            try:
                handle("victim_gone", {"pod_key": pod_key})
            except Exception:
                log.exception("victim_gone dispatch for %s failed", pod_key)

    def confirm_deleted(self, pod_key: str) -> bool:
        """Out-of-band confirmation from the lifecycle watch: it saw the
        pod's DELETED event, so the GET poll for this key is redundant
        (and _confirm_terminated defers to this channel while the watch
        runs — see WATCH_CONFIRM_GRACE_S). Returns True if the key was
        being tracked: terminating, its eviction POST in flight, or
        still queued on pending_evictions awaiting its first drain."""
        never_posted = False
        with self._state_lock:
            if pod_key in self._terminating:
                self._terminating.discard(pod_key)
            elif pod_key in self._expecting:
                # the DELETED event outran the eviction call's return:
                # count it now; drain() sees _confirmed_early and will
                # not track (or requeue) the already-gone pod
                self._confirmed_early.add(pod_key)
            elif pod_key in self._extender.pending_evictions:
                # queued but not yet drained: the victim is already
                # gone, so the eviction POST is moot — drop the key from
                # the queue NOW (a side marker would linger and cancel a
                # later legitimate eviction of a reused pod name), and
                # never track a deletion the watch has already delivered
                # (re-tracking would gate the gang on the 30s GET net)
                try:
                    self._extender.pending_evictions.remove(pod_key)
                    never_posted = True
                except ValueError:
                    # drain() popped it between the membership check and
                    # the remove; its POST is about to fly — same
                    # handling as the _expecting race above
                    self._confirmed_early.add(pod_key)
            else:
                return False
            # ``evicted`` counts pods confirmed GONE (the gang-unblock
            # event), not Eviction POSTs executed — a queued victim that
            # exits on its own still resolves its eviction obligation
            self._confirmed(pod_key)
        self._notify_gone(pod_key)
        if never_posted:
            # no Eviction POST ever flew: don't log an eviction that
            # would have no apiserver audit record to correlate with
            log.warning("victim %s gone before its eviction was posted "
                        "(confirmed by lifecycle watch)", pod_key)
        else:
            log.warning("evicted %s (confirmed by lifecycle watch)", pod_key)
        return True

    def check_once(self) -> bool:
        """One poll; True if any pod was evicted."""
        return bool(self.drain())

    def drain(self) -> list[str]:
        """Attempt every currently-queued eviction once; returns the pod
        keys whose deletion is CONFIRMED (object absent from the
        apiserver). Blocked/failed keys go back on the queue, accepted-
        but-still-terminating keys wait in ``_terminating`` — a key only
        leaves the executor as a confirmed deletion, never dropped."""
        q = self._extender.pending_evictions
        requeue: list[str] = []
        try:
            # bounded by the snapshot length: keys appended by other
            # threads mid-drain, like requeued keys, wait for the next poll
            for _ in range(len(q)):
                try:
                    pod_key = q.popleft()
                except IndexError:  # racing consumer emptied it
                    break
                with self._state_lock:
                    self._pending_since.setdefault(
                        pod_key, self._clock.monotonic()
                    )
                    self._expecting.add(pod_key)
                ok = None
                err = None
                try:
                    namespace, name = pod_key.split("/", 1)
                    ok = self._api.evict_pod(namespace, name)
                except Exception as e:
                    err = e
                with self._state_lock:
                    self._expecting.discard(pod_key)
                    if pod_key in self._confirmed_early:
                        # the watch confirmed the pod gone mid-call:
                        # nothing left to track or requeue, whatever the
                        # call's own outcome was. Drop the age entry too:
                        # when confirm_deleted's queued-key remove lost
                        # the race to our popleft, its _confirmed()
                        # bookkeeping ran BEFORE our setdefault above —
                        # without this pop the orphan entry inflates
                        # oldest_age_seconds() forever
                        self._pending_since.pop(pod_key, None)
                        self._confirmed_early.discard(pod_key)
                        continue
                    if ok:
                        self._terminating.add(pod_key)
                if err is not None:
                    # broad on purpose: ANY failure (transport timeout,
                    # junk response body, ...) must requeue, not drop —
                    # a lost key is a silent double-allocation
                    log.warning("eviction of %s failed, requeued: %s",
                                pod_key, err)
                    self.failures += 1
                    requeue.append(pod_key)
                elif not ok:
                    self.blocked += 1
                    requeue.append(pod_key)
                    log.warning("eviction of %s blocked by PDB, requeued",
                                pod_key)
        finally:
            q.extend(requeue)
        return self._confirm_terminated()

    def _confirm_terminated(self) -> list[str]:
        """Count a terminating pod as evicted once its object is gone —
        one tiny GET per in-flight key, not a cluster-wide list. A
        same-name pod WITHOUT a deletionTimestamp also confirms: the
        apiserver stamps deletionTimestamp the moment it accepts an
        eviction, so an unstamped pod is a controller's recreation (e.g.
        a StatefulSet member) — the original is gone and the newcomer is
        someone else's allocation, not our victim."""
        done = []
        watch_live = (self._watch_confirmer is not None
                      and self._watch_confirmer.watch_alive())
        now = self._clock.monotonic()
        with self._state_lock:
            tracked = sorted(
                pod_key for pod_key in self._terminating
                if not watch_live
                or (now - self._pending_since.get(pod_key, now)
                    > self.WATCH_CONFIRM_GRACE_S)
            )
        for pod_key in tracked:
            namespace, name = pod_key.split("/", 1)
            try:
                pod = self._api.get_pod(namespace, name)
            except Exception as e:
                log.warning("eviction confirm of %s failed, retrying: %s",
                            pod_key, e)
                continue
            if pod is not None and (
                (pod.get("metadata") or {}).get("deletionTimestamp")
            ):
                continue  # graceful termination still running
            with self._state_lock:
                if pod_key not in self._terminating:
                    continue  # confirm_deleted raced in and won
                self._terminating.discard(pod_key)
                self._confirmed(pod_key)
            self._notify_gone(pod_key)
            done.append(pod_key)
            log.warning("evicted %s (extender preemption/rollback)", pod_key)
        return done


def rebuild_extender(extender, api) -> int:
    """Reconstruct a restarted extender's ledger AND gang reservations
    from the apiserver (the restart story, wired to the real
    channel): node topology annotations first — the ledger can only
    commit onto known nodes — then every *live, bound* pod's alloc
    annotation. Lifecycle-filtered: terminal-phase pods, unbound pods
    (bind partial-failure residue), and pods whose bound node contradicts
    their annotation are skipped loudly — restoring any of them would
    resurrect a dead or phantom allocation. A node whose annotation is
    malformed is skipped loudly; its pods then fail to restore (also
    loudly) and the reconcile machinery takes over.
    Returns the number of allocations restored."""
    for obj in api.list_nodes():
        meta = obj.get("metadata") or {}
        name = meta.get("name")
        if not name:
            continue
        annotations = dict(meta.get("annotations") or {})
        # recorded upsert_node decisions, not bare state mutation: a
        # names-mode capture that starts right after rebuild must replay
        # with the same node state the live extender had
        out = extender.handle(
            "upsert_node", {"name": name, "annotations": annotations},
        )
        if out.get("error"):
            log.error("rebuild: node %s annotation rejected: %s",
                      name, out["error"])
    pods = [annos for annos, _, _ in live_alloc_pods(api.list_pods())]
    return extender.rebuild_from_pods(pods)


def live_alloc_pods(
    pods: list[dict[str, Any]],
) -> list[tuple[dict[str, str], Optional[Any], Optional[str]]]:
    """The restart story's lifecycle filter. Returns
    (annotations, decoded alloc or None when undecodable, pod key) for
    every pod whose alloc annotation SHOULD be restored: live, bound,
    non-terminal, annotation matching its binding and uid. Skips are
    loud; an undecodable payload passes through with ``None`` so
    ``rebuild_from_pods`` logs the decode failure itself."""
    out: list[tuple[dict[str, str], Optional[Any], Optional[str]]] = []
    for p in pods:
        meta = p.get("metadata") or {}
        annos = dict(meta.get("annotations") or {})
        payload = annos.get(codec.ANNO_ALLOC)
        if not payload:
            continue
        key = _pod_key_of(p)
        if key is None:
            continue
        phase = (p.get("status") or {}).get("phase")
        if phase in TERMINAL_PHASES:
            # the pod finished; its devices are free. Restoring it would
            # re-import exactly the leak PodLifecycleReleaseLoop exists to
            # close. (A pod with only a deletionTimestamp IS restored: its
            # containers may still hold the chips through graceful
            # termination, and the lifecycle loop releases it on DELETED.)
            log.warning("rebuild: skipping %s (phase %s — chips are free)",
                        key, phase)
            continue
        node_name = (p.get("spec") or {}).get("nodeName")
        if not node_name:
            # the bind effector's designed partial-failure residue: the
            # annotation PATCH landed but the Binding POST failed, so the
            # ledger was released and the scheduler retries. Restoring it
            # would plant a phantom allocation that 409s every bind retry,
            # pinning the pod Pending and leaking its chips.
            log.warning("rebuild: skipping %s (alloc annotation on an "
                        "unbound pod — bind partial-failure residue)", key)
            continue
        try:
            planned = codec.decode_alloc(payload)
        except codec.CodecError:
            planned = None  # rebuild_from_pods logs the decode loudly
        if planned is not None and planned.node_name != node_name:
            log.warning("rebuild: skipping %s (alloc says node %s but the "
                        "pod is bound to %s — stale annotation)",
                        key, planned.node_name, node_name)
            continue
        pod_uid = str(meta.get("uid") or "")
        if (planned is not None and planned.uid and pod_uid
                and planned.uid != pod_uid):
            log.warning("rebuild: skipping %s (alloc was for uid %s; the "
                        "pod is a recreation with uid %s)",
                        key, planned.uid, pod_uid)
            continue
        out.append((annos, planned, key))
    return out
