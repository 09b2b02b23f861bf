"""The kubelet's side of the device-plugin contract, as a test and smoke
peer — the port of ``tpukube/plugin/fake_kubelet.py``, with two
transports the caller picks by name (:func:`make_kubelet`):

``"grpc"`` — :class:`FakeKubelet`, the reference's peer over real unix
sockets: it serves the Registration service on ``kubelet.sock``, dials
back to the plugin's endpoint on Register, keeps a live device cache from
the ListAndWatch stream, and plays the container-start path with
``allocate()``/``preferred()``. It imports ``grpc`` inside its methods.
``register_plugin`` starts the plugin server on its socket, and ``stop``
stops every server it started.

``"inprocess"`` — :class:`InProcessKubelet`, the same methods without
sockets or grpcio, for the GPU machine: every request and response
crosses as ``encode()``d v1beta1 bytes that the other side ``decode()``s,
and the plugin's handlers run exactly as under gRPC. A refused call
raises the handler's :class:`~tpukube_torch.plugin.server.PluginRpcError`
where gRPC would deliver its status.

Neither falls back to the other.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from tpukube_torch.plugin.proto import deviceplugin as pb
from tpukube_torch.plugin.server import API_VERSION, PluginRpcError

log = logging.getLogger("tpukube_torch.plugin")

TRANSPORTS = ("grpc", "inprocess")


def make_kubelet(transport: str, device_plugin_dir: str = ""):
    """The kubelet peer of ``transport``: a :class:`FakeKubelet` serving in
    ``device_plugin_dir``, or an :class:`InProcessKubelet`."""
    if transport == "grpc":
        return FakeKubelet(device_plugin_dir)
    if transport == "inprocess":
        return InProcessKubelet()
    raise ValueError(f"unknown plugin transport {transport!r}; one of {TRANSPORTS}")


@dataclass
class PluginHandle:
    """One registered plugin endpoint, as the kubelet tracks it."""

    resource_name: str
    endpoint: str
    request: pb.RegisterRequest
    channel: Any  # grpc.Channel, or the DevicePluginServer in process
    stub: Any = None  # stubs.DevicePluginStub (gRPC)
    devices: dict[str, str] = field(default_factory=dict)  # id -> health
    watch_thread: Optional[threading.Thread] = None
    stream_cancel: Any = None  # what ends the ListAndWatch stream


class _DeviceCache:
    """The kubelet's per-resource view, filled by ListAndWatch streams."""

    def __init__(self) -> None:
        self._plugins: dict[str, PluginHandle] = {}
        self._lock = threading.Lock()
        self._device_event = threading.Condition(self._lock)

    def _handle(self, resource_name: str) -> PluginHandle:
        with self._lock:
            h = self._plugins.get(resource_name)
        if h is None:
            raise KeyError(f"no plugin registered for {resource_name}")
        return h

    def _validate(self, request: pb.RegisterRequest) -> None:
        if request.version != API_VERSION:
            raise PluginRpcError(
                "INVALID_ARGUMENT",
                f"unsupported device plugin version {request.version}",
            )

    def _install(self, handle: PluginHandle) -> Optional[PluginHandle]:
        """Make ``handle`` the resource's plugin; returns the one it replaced."""
        with self._lock:
            old = self._plugins.get(handle.resource_name)
            self._plugins[handle.resource_name] = handle
        return old

    def _update(self, handle: PluginHandle, resp: pb.ListAndWatchResponse) -> None:
        with self._lock:
            handle.devices = {d.ID: d.health for d in resp.devices}
            self._device_event.notify_all()

    def _stream_lost(self, handle: PluginHandle) -> None:
        """The stream died under a handle still current: the kubelet marks
        its devices unhealthy, so the node stops advertising capacity it
        can't deliver."""
        with self._lock:
            if self._plugins.get(handle.resource_name) is handle:
                handle.devices = {d: "Unhealthy" for d in handle.devices}
                self._device_event.notify_all()

    def _take_all(self) -> list[PluginHandle]:
        with self._lock:
            handles = list(self._plugins.values())
            self._plugins.clear()
        return handles

    # -- kubelet-side queries ------------------------------------------------
    def resources(self) -> list[str]:
        with self._lock:
            return sorted(self._plugins)

    def registration(self, resource_name: str) -> pb.RegisterRequest:
        """The RegisterRequest the resource's plugin announced itself with."""
        return self._handle(resource_name).request

    def devices(self, resource_name: str) -> dict[str, str]:
        with self._lock:
            h = self._plugins.get(resource_name)
            return dict(h.devices) if h else {}

    def allocatable(self, resource_name: str) -> int:
        """Healthy device count — what the node would report allocatable."""
        return sum(
            1 for h in self.devices(resource_name).values() if h == "Healthy"
        )

    def wait_for_devices(
        self, resource_name: str, count: int, timeout: float = 5.0
    ) -> dict[str, str]:
        """Block until the device cache for a resource reaches ``count``
        entries (any health)."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                h = self._plugins.get(resource_name)
                if h is not None and len(h.devices) >= count:
                    return dict(h.devices)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    have = dict(h.devices) if h else {}
                    raise TimeoutError(
                        f"{resource_name}: wanted {count} devices, have {have}"
                    )
                self._device_event.wait(remaining)

    def wait_for_health(
        self, resource_name: str, device_id: str, health: str, timeout: float = 5.0
    ) -> None:
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                h = self._plugins.get(resource_name)
                if h is not None and h.devices.get(device_id) == health:
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{device_id} never became {health}: "
                        f"{h.devices if h else {}}"
                    )
                self._device_event.wait(remaining)


class FakeKubelet(_DeviceCache):
    """The kubelet over gRPC unix sockets (module docstring)."""

    def __init__(self, device_plugin_dir: str):
        super().__init__()
        self._dir = device_plugin_dir
        self._socket_path = os.path.join(device_plugin_dir, "kubelet.sock")
        self._server = None  # grpc.Server while started
        self._plugin_servers: list = []  # plugin servers register_plugin started

    # -- lifecycle ---------------------------------------------------------
    @property
    def socket_path(self) -> str:
        return self._socket_path

    def start(self) -> None:
        from concurrent import futures

        import grpc

        from tpukube_torch.plugin import stubs

        if self._server is not None:
            raise RuntimeError("fake kubelet already started")
        os.makedirs(self._dir, exist_ok=True)
        if os.path.exists(self._socket_path):
            os.unlink(self._socket_path)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        stubs.add_registration_to_server(self, self._server)
        self._server.add_insecure_port(f"unix://{self._socket_path}")
        self._server.start()

    def stop(self) -> None:
        for server in self._plugin_servers:
            server.stop()
        self._plugin_servers.clear()
        for h in self._take_all():
            if h.stream_cancel is not None:
                h.stream_cancel.cancel()
            h.channel.close()
            if h.watch_thread is not None:
                h.watch_thread.join(timeout=5.0)
        if self._server is not None:
            self._server.stop(0.5).wait()
            self._server = None
        if os.path.exists(self._socket_path):
            os.unlink(self._socket_path)

    def __enter__(self) -> "FakeKubelet":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def register_plugin(self, server) -> None:
        """``server`` serves on its unix socket and registers itself with
        this kubelet over gRPC; :meth:`stop` stops it."""
        server.start()
        self._plugin_servers.append(server)
        server.register_with_kubelet(self._socket_path)

    # -- Registration service ----------------------------------------------
    def Register(self, request: pb.RegisterRequest, context) -> pb.Empty:
        import grpc

        from tpukube_torch.plugin import stubs

        self._validate(request)
        endpoint_path = os.path.join(self._dir, request.endpoint)
        channel = grpc.insecure_channel(f"unix://{endpoint_path}")
        handle = PluginHandle(
            resource_name=request.resource_name,
            endpoint=endpoint_path,
            request=request,
            channel=channel,
            stub=stubs.DevicePluginStub(channel),
        )
        old = self._install(handle)
        if old is not None:
            if old.stream_cancel is not None:
                old.stream_cancel.cancel()
            old.channel.close()
        # Like the kubelet: immediately open the ListAndWatch stream.
        handle.watch_thread = threading.Thread(
            target=self._watch, args=(handle,), daemon=True,
            name=f"fake-kubelet-watch-{request.resource_name}",
        )
        handle.watch_thread.start()
        return pb.Empty()

    def _watch(self, handle: PluginHandle) -> None:
        import grpc

        try:
            stream = handle.stub.ListAndWatch(pb.Empty())
            handle.stream_cancel = stream
            for resp in stream:
                self._update(handle, resp)
        except grpc.RpcError:
            # stream torn down: replaced or closed by us, or the plugin died
            self._stream_lost(handle)

    # -- container-start path ------------------------------------------------
    def allocate(
        self, resource_name: str, device_ids: list[str], timeout: float = 5.0
    ) -> dict[str, str]:
        """Play the kubelet's Allocate for one container; returns the env."""
        resp = self._handle(resource_name).stub.Allocate(
            pb.AllocateRequest(
                container_requests=[pb.ContainerAllocateRequest(devicesIDs=device_ids)]
            ),
            timeout=timeout,
        )
        return dict(resp.container_responses[0].envs)

    def preferred(
        self,
        resource_name: str,
        available: list[str],
        size: int,
        required: Optional[list[str]] = None,
        timeout: float = 5.0,
    ) -> list[str]:
        resp = self._handle(resource_name).stub.GetPreferredAllocation(
            pb.PreferredAllocationRequest(
                container_requests=[
                    pb.ContainerPreferredAllocationRequest(
                        available_deviceIDs=available,
                        must_include_deviceIDs=required or [],
                        allocation_size=size,
                    )
                ]
            ),
            timeout=timeout,
        )
        return list(resp.container_responses[0].deviceIDs)


class _StreamContext:
    """The ListAndWatch context of the in-process transport: active until
    the kubelet cancels the stream."""

    def __init__(self) -> None:
        self._cancelled = threading.Event()

    def is_active(self) -> bool:
        return not self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()


def _crossed(msg: pb.Message) -> pb.Message:
    """``msg`` as the other side receives it: encoded, then decoded."""
    return type(msg).decode(msg.encode())


class InProcessKubelet(_DeviceCache):
    """The kubelet peer without sockets (module docstring)."""

    def stop(self) -> None:
        for h in self._take_all():
            h.stream_cancel.cancel()
            h.watch_thread.join(timeout=5.0)

    def __enter__(self) -> "InProcessKubelet":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def register_plugin(self, server) -> None:
        """``server``'s Register: its RegisterRequest crosses as bytes, and
        the kubelet "dials back" to the server object itself, opening the
        ListAndWatch stream on a thread of its own."""
        request = _crossed(server.register_request())
        self._validate(request)
        handle = PluginHandle(
            resource_name=request.resource_name,
            endpoint=request.endpoint,
            request=request,
            channel=server,
            stream_cancel=_StreamContext(),
        )
        old = self._install(handle)
        if old is not None:
            old.stream_cancel.cancel()
        handle.watch_thread = threading.Thread(
            target=self._watch, args=(handle,), daemon=True,
            name=f"inprocess-kubelet-watch-{request.resource_name}",
        )
        handle.watch_thread.start()

    def _watch(self, handle: PluginHandle) -> None:
        stream = handle.channel.ListAndWatch(_crossed(pb.Empty()),
                                             handle.stream_cancel)
        try:
            for resp in stream:
                self._update(handle, _crossed(resp))
        except Exception:
            log.exception("ListAndWatch of %s failed", handle.resource_name)
            self._stream_lost(handle)
        finally:
            stream.close()

    def _call(self, resource_name: str, rpc: str, request: pb.Message) -> pb.Message:
        """One unary RPC: the request and the response cross as bytes."""
        server = self._handle(resource_name).channel
        return _crossed(getattr(server, rpc)(_crossed(request), None))

    # -- container-start path ------------------------------------------------
    def allocate(self, resource_name: str, device_ids: list[str]) -> dict[str, str]:
        """Play the kubelet's Allocate for one container; returns the env."""
        resp = self._call(resource_name, "Allocate", pb.AllocateRequest(
            container_requests=[pb.ContainerAllocateRequest(devicesIDs=device_ids)]
        ))
        return dict(resp.container_responses[0].envs)

    def preferred(
        self,
        resource_name: str,
        available: list[str],
        size: int,
        required: Optional[list[str]] = None,
    ) -> list[str]:
        resp = self._call(resource_name, "GetPreferredAllocation",
                          pb.PreferredAllocationRequest(container_requests=[
                              pb.ContainerPreferredAllocationRequest(
                                  available_deviceIDs=available,
                                  must_include_deviceIDs=required or [],
                                  allocation_size=size,
                              )
                          ]))
        return list(resp.container_responses[0].deviceIDs)
