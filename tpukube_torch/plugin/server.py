"""Device-plugin node agent (L3) — the port of ``tpukube/plugin/server.py``.

The node agent registers with the kubelet, serves the five
deviceplugin/v1beta1 RPCs for the node's GPUs, and runs a health loop
(NVML XID events, ``GpuDeviceManager.probe``) that pushes shrunken device
lists on the ListAndWatch stream. Allocate answers with the container env
of ``GpuDeviceManager.allocate_env``.

The RPC handlers take and return the messages of
``tpukube_torch.plugin.proto.deviceplugin`` (the hand-written v1beta1
codec) and never touch ``grpc``: a refused request raises
:class:`PluginRpcError` with the gRPC status code's name, and
ListAndWatch takes any context with ``is_active()``. Two transports carry
them: gRPC over unix sockets (``start``/``stop``/``restart``/
``register_with_kubelet`` here and ``stubs.py``, which import ``grpc``
inside the call) and the in-process kubelet peer
(``fake_kubelet.InProcessKubelet``), which moves the same encoded bytes
without sockets where no grpcio is installed.
"""

from __future__ import annotations

import logging
import os
import queue
import functools
import threading
from typing import Optional

from tpukube_torch.core import retry
from tpukube_torch.core.config import GpuKubeConfig
from tpukube_torch.core.types import Health
from tpukube_torch.device import DeviceError, GpuDeviceManager
from tpukube_torch.plugin.proto import deviceplugin as pb

log = logging.getLogger("tpukube_torch.plugin")

API_VERSION = "v1beta1"
REGISTER_TIMEOUT = 5.0  # seconds for one Register over gRPC


class PluginRpcError(RuntimeError):
    """A refused RPC: ``code`` names the gRPC status (``"INVALID_ARGUMENT"``),
    which the gRPC transport aborts the call with."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message


class AllocIntentCache:
    """Planned device-id sets for pods bound to this node, fed from their
    ``tpu.qiniu.com/alloc`` annotations.

    The kubelet — not the extender — decides which advertised ids go into
    Allocate; these intents are how the extender's plan reaches that
    decision: GetPreferredAllocation answers with the matching planned set,
    and Allocate checks the kubelet's actual choice against it, reporting
    divergence for ledger reconciliation.

    Attribution limits: deviceplugin/v1beta1 carries no pod identity, so
    matching an Allocate to a pod is inference. A consumed intent is marked
    satisfied and never re-enters from the watcher's polls while its pod
    lives (a running pod's lifetime alloc annotation must not masquerade
    as a fresh plan). A divergent Allocate is attributed ONLY when exactly
    one unsatisfied same-size intent exists — ambiguity means no report,
    never a guess.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._intents: dict[str, list[str]] = {}  # pod_key -> planned ids
        self._satisfied: set[str] = set()  # pod_keys whose Allocate happened

    def sync(self, intents: dict[str, list[str]]) -> bool:
        """Replace the set from a watcher poll (satisfied pods excluded;
        vanished pods forgotten entirely). True if the live set changed."""
        with self._lock:
            fresh = {
                k: list(v) for k, v in intents.items()
                if k not in self._satisfied
            }
            self._satisfied &= set(intents)
            if fresh == self._intents:
                return False
            self._intents = fresh
            return True

    def put(self, pod_key: str, device_ids: list[str]) -> None:
        with self._lock:
            self._intents[pod_key] = list(device_ids)
            self._satisfied.discard(pod_key)

    def offer(self, pod_key: str, device_ids: list[str]) -> bool:
        """put() for watch-event paths: refuses to resurrect an intent the
        kubelet already consumed (a running pod's lifetime alloc
        annotation rides every later event)."""
        with self._lock:
            if pod_key in self._satisfied:
                return False
            self._intents[pod_key] = list(device_ids)
            return True

    def remove(self, pod_key: str) -> None:
        with self._lock:
            self._intents.pop(pod_key, None)
            self._satisfied.discard(pod_key)

    def snapshot(self) -> dict[str, list[str]]:
        with self._lock:
            return {k: list(v) for k, v in self._intents.items()}

    def depth(self) -> int:
        """Pending (unconsumed) intents — exported on /metrics."""
        with self._lock:
            return len(self._intents)

    def preferred(
        self, available: list[str], required: list[str], size: int
    ) -> Optional[list[str]]:
        """The planned id set satisfying this preference query, if any:
        right size, inside the kubelet's available pool, containing every
        must-include id. Not consumed — the kubelet may ask repeatedly.

        The query carries no pod identity, so when MORE than one pending
        intent fits, any answer is a coin flip that can steer this pod
        onto the OTHER pod's plan: return None and let the device
        manager's local heuristic decide (consume()'s refuse-to-guess)."""
        avail = set(available)
        req = set(required)
        with self._lock:
            fits = [
                ids for ids in self._intents.values()
                if len(ids) == size and req <= set(ids) and set(ids) <= avail
            ]
        if len(fits) == 1:
            return list(fits[0])
        if fits:
            log.info(
                "preference query (size %d) matches %d pending intents; "
                "deferring to the local heuristic", size, len(fits),
            )
        return None

    def consume(
        self, allocated: list[str]
    ) -> tuple[Optional[str], Optional[list[str]], bool]:
        """Match an Allocate against the intents: exact id-set match wins
        (consumed, no divergence); otherwise a same-size intent is the
        diverged plan ONLY if it is unambiguous (see class docstring).
        Returns (pod_key, planned, diverged); (None, None, False) when no
        intent can safely be attributed."""
        got = set(allocated)
        with self._lock:
            for key, ids in self._intents.items():
                if set(ids) == got:
                    del self._intents[key]
                    self._satisfied.add(key)
                    return key, ids, False
            same = [
                (k, v) for k, v in self._intents.items()
                if len(v) == len(allocated)
            ]
            if len(same) == 1:
                key, ids = same[0]
                del self._intents[key]
                self._satisfied.add(key)
                return key, ids, True
            if same:
                log.warning(
                    "divergent Allocate %s matches %d same-size intents; "
                    "refusing to guess attribution",
                    sorted(allocated), len(same),
                )
        return None, None, False


class DevicePluginServer:
    """Serves one extended resource: whole GPUs or vGPU shares, as the
    device manager's sharing mode says (``tpukube_torch/device/gpu.py``)."""

    def __init__(self, config: GpuKubeConfig, device: GpuDeviceManager,
                 socket_path: Optional[str] = None):
        self._config = config
        self._device = device
        self._socket_path = socket_path or config.plugin_socket_path()
        self._server = None  # the grpc.Server while serving over gRPC
        # Each active ListAndWatch stream gets its own update queue; the
        # health watcher broadcasts a refreshed device list to all of them.
        self._watch_queues: list[queue.SimpleQueue] = []
        self._watch_lock = threading.Lock()
        self._allocations = 0  # served Allocate calls (metrics)
        self.divergences = 0   # kubelet-vs-plan id divergences (metrics)
        # extender-planned device ids for pods bound here (AllocIntentCache)
        self.intents = AllocIntentCache()
        self._alloc_reporter = None  # divergence callback (apiserver chan)
        # observability span hook: called as span_sink(name, pod_key,
        # **fields) on Allocate / intent-match, when an Allocate can be
        # attributed to a pod. Wire a DecisionTrace.span here (the sim
        # harness does) and the per-pod timeline gains the node-agent leg
        # of the chain: filter -> gang_reserve -> bind -> allocate.
        self.span_sink = None
        # structured event journal (obs/events.py)
        self.events = None

    def _emit_event(self, reason: str, obj: str, message: str,
                    warning: bool = True) -> None:
        if self.events is None:
            return
        try:
            self.events.emit(
                reason, obj=obj, message=message,
                type="Warning" if warning else "Normal",
                node=self._device.host,
            )
        except Exception:
            log.exception("event emit failed: %s %s", reason, obj)

    def _span(self, name: str, pod_key: str, **fields) -> None:
        if self.span_sink is None:
            return
        try:
            self.span_sink(name, pod_key, **fields)
        except Exception:
            # observability must never fail an Allocate
            log.exception("span sink failed for %s/%s", name, pod_key)

    def set_alloc_reporter(self, reporter) -> None:
        """Install the divergence report channel: called as
        ``reporter(pod_key, planned_ids, actual_ids)`` when the kubelet
        allocates ids other than the planned intent."""
        self._alloc_reporter = reporter

    # -- identity ----------------------------------------------------------
    @property
    def socket_path(self) -> str:
        return self._socket_path

    @property
    def config(self) -> GpuKubeConfig:
        return self._config

    @property
    def resource_name(self) -> str:
        return self._device.resource_name

    @property
    def allocation_count(self) -> int:
        return self._allocations

    def register_request(self) -> pb.RegisterRequest:
        """What this plugin announces to the kubelet's Registration service
        (either transport)."""
        return pb.RegisterRequest(
            version=API_VERSION,
            endpoint=os.path.basename(self._socket_path),
            resource_name=self.resource_name,
            options=pb.DevicePluginOptions(
                pre_start_required=False,
                get_preferred_allocation_available=True,
            ),
        )

    # -- the gRPC transport --------------------------------------------------
    def start(self) -> None:
        """Serve the RPCs over gRPC on the plugin's unix socket."""
        from concurrent import futures

        import grpc

        from tpukube_torch.plugin import stubs

        if self._server is not None:
            raise RuntimeError("plugin server already started")
        if os.path.exists(self._socket_path):
            os.unlink(self._socket_path)  # stale socket from a crashed agent
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        stubs.add_device_plugin_to_server(self, self._server)
        self._server.add_insecure_port(f"unix://{self._socket_path}")
        self._server.start()
        log.info("plugin serving %s on %s", self.resource_name, self._socket_path)

    def stop(self, grace: float = 0.5) -> None:
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None
        if os.path.exists(self._socket_path):
            os.unlink(self._socket_path)

    def restart(self, grace: float = 0.5) -> None:
        """Rebind the unix socket (kubelet wipes the device-plugin dir on
        restart, taking our socket file with it — a gRPC server holding a
        deleted socket's fd serves nobody kubelet can reach)."""
        self.stop(grace)
        self.start()

    def __enter__(self) -> "DevicePluginServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def register_with_kubelet(self, kubelet_socket: Optional[str] = None,
                              timeout: float = REGISTER_TIMEOUT) -> None:
        """Dial the kubelet's Registration service over gRPC and announce
        ourselves."""
        import grpc

        from tpukube_torch.plugin import stubs

        ks = kubelet_socket or self._config.kubelet_socket_path()
        with grpc.insecure_channel(f"unix://{ks}") as channel:
            grpc.channel_ready_future(channel).result(timeout=timeout)
            stub = stubs.RegistrationStub(channel)
            stub.Register(self.register_request(), timeout=timeout)
        log.info("registered %s with kubelet at %s", self.resource_name, ks)

    # -- device list plumbing ---------------------------------------------
    def _current_devices(self) -> pb.ListAndWatchResponse:
        return pb.ListAndWatchResponse(
            devices=[
                pb.Device(ID=did, health=h.value)
                for did, h in self._device.device_list()
            ]
        )

    def push_update(self) -> None:
        """Broadcast the current device list to all ListAndWatch streams
        (called by the health watcher on any health transition)."""
        resp = self._current_devices()
        with self._watch_lock:
            for q in self._watch_queues:
                q.put(resp)

    # -- deviceplugin/v1beta1 RPCs -----------------------------------------
    def GetDevicePluginOptions(self, request, context) -> pb.DevicePluginOptions:
        return pb.DevicePluginOptions(
            pre_start_required=False,
            get_preferred_allocation_available=True,
        )

    def ListAndWatch(self, request, context):
        """Initial full list, then a push per health transition — the
        long-lived stream the kubelet sizes node allocatable from; it ends
        when ``context.is_active()`` turns false."""
        q: queue.SimpleQueue = queue.SimpleQueue()
        with self._watch_lock:
            self._watch_queues.append(q)
        try:
            yield self._current_devices()
            while context.is_active():
                try:
                    yield q.get(timeout=0.2)
                except queue.Empty:
                    continue
        finally:
            with self._watch_lock:
                self._watch_queues.remove(q)

    def GetPreferredAllocation(self, request, context) -> pb.PreferredAllocationResponse:
        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            available = list(creq.available_deviceIDs)
            required = list(creq.must_include_deviceIDs)
            size = creq.allocation_size
            # the extender's planned ids outrank local adjacency: the gang
            # contiguity score was computed for exactly those GPUs
            chosen = self.intents.preferred(available, required, size)
            if chosen is None:
                try:
                    chosen = self._device.preferred_allocation(
                        available, required, size,
                    )
                except DeviceError as e:
                    raise PluginRpcError("INVALID_ARGUMENT", str(e)) from e
            resp.container_responses.append(
                pb.ContainerPreferredAllocationResponse(deviceIDs=chosen)
            )
        return resp

    def Allocate(self, request, context) -> pb.AllocateResponse:
        resp = pb.AllocateResponse()
        for creq in request.container_requests:
            ids = list(creq.devicesIDs)
            try:
                env = self._device.allocate_env(ids)
            except DeviceError as e:
                raise PluginRpcError("INVALID_ARGUMENT", str(e)) from e
            resp.container_responses.append(pb.ContainerAllocateResponse(envs=env))
            pod_key, planned, diverged = self.intents.consume(ids)
            if pod_key is not None:
                if not diverged:
                    # the kubelet's choice matched the extender's plan
                    # exactly — the steering loop closed as designed
                    self._span("intent_match", pod_key,
                               devices=sorted(ids))
                self._span("allocate", pod_key,
                           devices=sorted(ids), diverged=diverged)
            if diverged and planned is not None and pod_key is not None:
                self.divergences += 1
                log.warning(
                    "kubelet allocated %s but %s was planned %s — reporting",
                    sorted(ids), pod_key, sorted(planned),
                )
                self._emit_event(
                    "AllocDiverged", f"pod/{pod_key}",
                    f"kubelet allocated {sorted(ids)} but the plan was "
                    f"{sorted(planned)}; reporting for reconcile",
                )
                if self._alloc_reporter is not None:
                    # off the kubelet's pod-start critical path: the report
                    # is an apiserver PATCH that may block seconds
                    threading.Thread(
                        target=self._alloc_reporter,
                        args=(pod_key, planned, ids),
                        daemon=True, name="tpukube-alloc-report",
                    ).start()
        self._allocations += 1
        log.info("allocated %s", [list(c.devicesIDs) for c in request.container_requests])
        return resp

    def PreStartContainer(self, request, context) -> pb.PreStartContainerResponse:
        return pb.PreStartContainerResponse()


class HealthWatcher:
    """Polls device health and pushes ListAndWatch updates on transitions.

    On the real backend each poll runs the device manager's probe first
    (NVML XID events and a liveness check), so a GPU that raised a
    critical XID is Unhealthy within one interval; the sim's health is
    driven by ``inject_fault``.
    """

    def __init__(self, device: GpuDeviceManager, server: DevicePluginServer,
                 poll_seconds: Optional[float] = None,
                 on_transition=None):
        self._device = device
        self._server = server
        if poll_seconds is None:
            poll_seconds = server.config.health_poll_seconds
        self._poll = poll_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last: dict[str, Health] = {}
        self._last_links: list = []
        self.transitions = 0  # observed health flips (tests/metrics)
        # called (no args) after each pushed transition: a daemon hooks
        # its annotation rewrite here so the SCHEDULER learns about dead
        # GPUs too — the ListAndWatch push only reaches the kubelet
        self._on_transition = on_transition

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("health watcher already started")
        self._last = self._device.health_snapshot()
        self._last_links = self._device.link_fault_snapshot()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpukube-health")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def check_once(self) -> bool:
        """One poll; returns True if a transition was pushed. Exposed so
        tests (and the sim harness) can step deterministically."""
        try:
            # a probe ERROR must not kill the watch loop: the last
            # snapshot simply persists
            self._device.probe()
        except Exception:
            log.exception("health probe failed; keeping last snapshot")
        snap = self._device.health_snapshot()
        links = self._device.link_fault_snapshot()
        health_changed = snap != self._last
        links_changed = links != self._last_links
        if not (health_changed or links_changed):
            return False
        if health_changed:
            changed = {k for k in snap if snap[k] != self._last.get(k)}
            log.warning("health transition: %s", sorted(changed))
            # the kubelet cares only about device health, not links
            self._server.push_update()
        if links_changed:
            log.warning("link-fault transition: %d downed link(s)",
                        len(links))
        self._last = snap
        self._last_links = links
        self.transitions += 1
        if self._on_transition is not None:
            try:
                self._on_transition()
            except Exception:
                # re-annotation failure must not kill the watch loop;
                # the kubelet-side shrink already went out
                log.exception("health re-annotation hook failed")
        return True

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self.check_once()
            except Exception:
                log.exception("health poll failed")


class KubeletSessionWatcher:
    """Re-registers with a restarted kubelet (gRPC transport).

    Kubelet clears its device-plugin directory on restart and expects every
    plugin to dial the fresh ``kubelet.sock`` and Register again — a plugin
    that does not is silently absent from the node's allocatable until its
    own next restart. Two facts are polled at the health-watch cadence:

      * the kubelet socket's identity (st_ino/st_dev/st_ctime_ns) — a
        change means a new kubelet is up: re-register;
      * our OWN socket file's existence — kubelet's restart wipe unlinks
        it, and a gRPC server holding a deleted socket's fd is
        unreachable: rebind, then re-register.
    """

    def __init__(self, server: DevicePluginServer,
                 poll_seconds: Optional[float] = None,
                 retrier=None):
        self._server = server
        if poll_seconds is None:
            poll_seconds = server.config.health_poll_seconds
        self._poll = poll_seconds
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._kubelet_ident = self._ident()
        self._needs_register = False
        self.reregistrations = 0  # metrics/tests
        self.events = None  # optional EventJournal
        # registration attempts run under the retry policy (config
        # retry_* knobs) INSIDE one poll, on top of the poll-cadence
        # outer retry the _needs_register flag provides
        if retrier is None:
            retrier = retry.Retrier(
                retry.policy_from_config(server.config),
                name="kubelet-register",
            )
        self.retrier = retrier

    def _ident(self) -> Optional[tuple[int, int, int]]:
        try:
            st = os.stat(self._server.config.kubelet_socket_path())
            # st_ctime_ns guards against inode reuse: a deleted + recreated
            # socket can get the old inode back (tmpfs does this readily)
            return (st.st_ino, st.st_dev, st.st_ctime_ns)
        except OSError:
            return None

    def mark_unregistered(self) -> None:
        """Forget the observed kubelet identity so the next poll registers
        (for a daemon whose INITIAL registration failed)."""
        self._kubelet_ident = None
        self._needs_register = True

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("kubelet watcher already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tpukube-kubelet-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def check_once(self) -> bool:
        """One poll; True if a re-registration happened. Exposed so tests
        step deterministically (same pattern as HealthWatcher)."""
        ident = self._ident()
        if ident is None:
            # kubelet down: nothing to register with; record None so its
            # return reads as a restart
            self._kubelet_ident = None
            return False
        kubelet_restarted = ident != self._kubelet_ident
        socket_gone = not os.path.exists(self._server.socket_path)
        if not (kubelet_restarted or socket_gone or self._needs_register):
            return False
        if socket_gone:
            log.warning("plugin socket vanished (kubelet restart wipe); rebinding")
            self._server.restart()
        if kubelet_restarted:
            log.warning("kubelet socket identity changed; re-registering")
        # entered because an EARLIER registration failed? then success
        # below is a recovery worth journaling as such
        recovering = self._needs_register
        # registration state is tracked apart from kubelet identity: after
        # a rebind whose Register failed, the next poll sees the socket
        # present and the identity unchanged — only this flag retries
        self._needs_register = True
        self.retrier.journal = self.events
        register = self._server.register_with_kubelet
        cap = self.retrier.policy.attempt_timeout
        if cap > 0:
            # the policy's per-attempt cap on the transport timeout, as the
            # reference applies it to its REST transport
            register = functools.partial(register,
                                         timeout=min(cap, REGISTER_TIMEOUT))
        self.retrier.call(register)
        # commit the observed identity only AFTER registration succeeded
        self._kubelet_ident = ident
        self._needs_register = False
        self.reregistrations += 1
        if self.events is not None:
            attempts = self.retrier.last_attempts
            if recovering:
                msg = "registration recovered after earlier failure"
            else:
                msg = "kubelet restarted; plugin re-registered"
            if attempts > 1:
                msg += f" (succeeded on attempt {attempts})"
            try:
                self.events.emit(
                    "KubeletReregistered",
                    obj=f"node/{self._server._device.host}",
                    message=msg,
                    node=self._server._device.host,
                )
            except Exception:
                log.exception("event emit failed: KubeletReregistered")
        return True

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            try:
                self.check_once()
            except Exception:
                log.exception("kubelet session poll failed")
