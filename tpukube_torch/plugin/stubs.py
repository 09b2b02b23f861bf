"""Hand-written gRPC service wiring for deviceplugin/v1beta1 — the port of
``tpukube/plugin/stubs.py``, over the hand-written codec
(``proto/deviceplugin.py``) instead of protoc output.

The method paths and serialization match the upstream API exactly (the
kubelet is the peer). A handler that raises
:class:`~tpukube_torch.plugin.server.PluginRpcError` aborts the call with
the status code it names. This module and the gRPC half of
``fake_kubelet.py`` are the only parts of the port that import ``grpc``.
"""

from __future__ import annotations

import grpc

from tpukube_torch.plugin.proto import deviceplugin as pb
from tpukube_torch.plugin.server import PluginRpcError

_REGISTRATION = "v1beta1.Registration"
_DEVICE_PLUGIN = "v1beta1.DevicePlugin"


def _abort(context, e: PluginRpcError) -> None:
    context.abort(getattr(grpc.StatusCode, e.code), e.message)


def _unary(method):
    def handler(request, context):
        try:
            return method(request, context)
        except PluginRpcError as e:
            _abort(context, e)
    return handler


def _stream(method):
    def handler(request, context):
        try:
            yield from method(request, context)
        except PluginRpcError as e:
            _abort(context, e)
    return handler


# -- Registration service (served by the kubelet; plugins are clients) -----

def add_registration_to_server(servicer, server: grpc.Server) -> None:
    """Serve ``servicer.Register(request, context)`` on ``server``."""
    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            _unary(servicer.Register),
            request_deserializer=pb.RegisterRequest.decode,
            response_serializer=pb.Empty.encode,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_REGISTRATION, handlers),)
    )


class RegistrationStub:
    def __init__(self, channel: grpc.Channel):
        self.Register = channel.unary_unary(
            f"/{_REGISTRATION}/Register",
            request_serializer=pb.RegisterRequest.encode,
            response_deserializer=pb.Empty.decode,
        )


# -- DevicePlugin service (served by the plugin; kubelet is the client) ----

def add_device_plugin_to_server(servicer, server: grpc.Server) -> None:
    """Serve the five RPCs of ``servicer`` (a DevicePluginServer) on
    ``server``."""
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            _unary(servicer.GetDevicePluginOptions),
            request_deserializer=pb.Empty.decode,
            response_serializer=pb.DevicePluginOptions.encode,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            _stream(servicer.ListAndWatch),
            request_deserializer=pb.Empty.decode,
            response_serializer=pb.ListAndWatchResponse.encode,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            _unary(servicer.GetPreferredAllocation),
            request_deserializer=pb.PreferredAllocationRequest.decode,
            response_serializer=pb.PreferredAllocationResponse.encode,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            _unary(servicer.Allocate),
            request_deserializer=pb.AllocateRequest.decode,
            response_serializer=pb.AllocateResponse.encode,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            _unary(servicer.PreStartContainer),
            request_deserializer=pb.PreStartContainerRequest.decode,
            response_serializer=pb.PreStartContainerResponse.encode,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(_DEVICE_PLUGIN, handlers),)
    )


class DevicePluginStub:
    def __init__(self, channel: grpc.Channel):
        self.GetDevicePluginOptions = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/GetDevicePluginOptions",
            request_serializer=pb.Empty.encode,
            response_deserializer=pb.DevicePluginOptions.decode,
        )
        self.ListAndWatch = channel.unary_stream(
            f"/{_DEVICE_PLUGIN}/ListAndWatch",
            request_serializer=pb.Empty.encode,
            response_deserializer=pb.ListAndWatchResponse.decode,
        )
        self.GetPreferredAllocation = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/GetPreferredAllocation",
            request_serializer=pb.PreferredAllocationRequest.encode,
            response_deserializer=pb.PreferredAllocationResponse.decode,
        )
        self.Allocate = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/Allocate",
            request_serializer=pb.AllocateRequest.encode,
            response_deserializer=pb.AllocateResponse.decode,
        )
        self.PreStartContainer = channel.unary_unary(
            f"/{_DEVICE_PLUGIN}/PreStartContainer",
            request_serializer=pb.PreStartContainerRequest.encode,
            response_deserializer=pb.PreStartContainerResponse.decode,
        )
