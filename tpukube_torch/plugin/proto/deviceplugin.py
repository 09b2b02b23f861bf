"""deviceplugin/v1beta1 messages as a hand-written proto3 codec.

Every message of ``deviceplugin.proto`` (beside this file, the spec) is a
plain dataclass with the proto's field names, ``encode() -> bytes`` and
``decode(bytes)``. The port's plugin speaks these, in place of the
reference's protoc output, because the GPU machine has no protobuf
runtime; the bytes are the kubelet's wire format all the same.

Proto3 rules kept: a field at its zero value is not written (a message
field is written whenever it is set, even empty); strings are UTF-8;
``int32``/``int64`` are varints, a negative one ten bytes of two's
complement; repeated fields are written element by element; a map is a
repeated entry message ``{key = 1, value = 2}``, written with both fields
in protobuf's deterministic key order, so ``encode()`` equals protobuf's
``SerializeToString(deterministic=True)`` byte for byte. Fields are
written in field-number order. Decoding skips fields this version does
not know (a newer kubelet sends them), merges a message field that
occurs twice, and keeps the last of a repeated scalar or map key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Optional

__all__ = [
    "DecodeError", "Message", "MESSAGES",
    "DevicePluginOptions", "RegisterRequest", "Empty",
    "ListAndWatchResponse", "TopologyInfo", "NUMANode", "Device",
    "PreferredAllocationRequest", "ContainerPreferredAllocationRequest",
    "PreferredAllocationResponse", "ContainerPreferredAllocationResponse",
    "PreStartContainerRequest", "PreStartContainerResponse",
    "AllocateRequest", "ContainerAllocateRequest", "AllocateResponse",
    "ContainerAllocateResponse", "Mount", "DeviceSpec", "CDIDevice",
]

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5

# field kinds of a ``_FIELDS`` entry (number, name, kind, message class)
STRING, BOOL, INT32, INT64 = "string", "bool", "int32", "int64"
MESSAGE, REPEATED_STRING, REPEATED_MESSAGE, MAP = (
    "message", "repeated string", "repeated message", "map<string, string>")

_U64 = (1 << 64) - 1


class DecodeError(ValueError):
    """Bytes that are not a well-formed encoding of the message."""


def _varint(value: int) -> bytes:
    value &= _U64  # a negative int is its 64-bit two's complement
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        if shift >= 64:
            raise DecodeError("varint longer than 10 bytes")
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value & _U64, pos


def _signed(value: int, bits: int) -> int:
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _key(number: int, wire: int) -> bytes:
    return _varint(number << 3 | wire)


def _len_field(number: int, payload: bytes) -> bytes:
    return _key(number, _LEN) + _varint(len(payload)) + payload


def _string(value: str, what: str) -> bytes:
    if not isinstance(value, str):
        raise TypeError(f"{what}: expected str, got {type(value).__name__}")
    return value.encode("utf-8")


def _map_order(key: str) -> tuple:
    """Sort key of a map entry: its key's UTF-8 bytes, with a key placed
    before its own prefixes — the order protobuf's runtime writes under
    deterministic serialization (for keys "a", "ab", "b", "": "ab", "a",
    "b", "")."""
    return (*key.encode("utf-8"), 256)


def _fields(buf: bytes):
    """(number, wire type, value) for each field of ``buf``: an int for
    varint/fixed fields, the payload bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        number, wire = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        if wire == _VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _LEN:
            size, pos = _read_varint(buf, pos)
            if pos + size > len(buf):
                raise DecodeError("truncated length-delimited field")
            value, pos = buf[pos:pos + size], pos + size
        elif wire in (_I64, _I32):
            size = 8 if wire == _I64 else 4
            if pos + size > len(buf):
                raise DecodeError("truncated fixed-width field")
            value, pos = int.from_bytes(buf[pos:pos + size], "little"), pos + size
        else:
            raise DecodeError(f"unsupported wire type {wire} (field {number})")
        yield number, wire, value


def _utf8(payload: bytes, what: str) -> str:
    try:
        return payload.decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"{what}: invalid UTF-8") from e


class Message:
    """Base of the messages: ``_FIELDS`` drives both directions."""

    _FIELDS: ClassVar[tuple] = ()

    def encode(self) -> bytes:
        out = bytearray()
        for number, name, kind, sub in self._FIELDS:
            value = getattr(self, name)
            what = f"{type(self).__name__}.{name}"
            if kind == STRING:
                if value:
                    out += _len_field(number, _string(value, what))
            elif kind == BOOL:
                if value:
                    out += _key(number, _VARINT) + b"\x01"
            elif kind in (INT32, INT64):
                lo = -(1 << 31) if kind == INT32 else -(1 << 63)
                if not lo <= value < -lo:
                    raise ValueError(f"{what}: {value} out of {kind} range")
                if value:
                    out += _key(number, _VARINT) + _varint(value)
            elif kind == MESSAGE:
                if value is not None:
                    out += _len_field(number, value.encode())
            elif kind == REPEATED_STRING:
                for item in value:
                    out += _len_field(number, _string(item, what))
            elif kind == REPEATED_MESSAGE:
                for item in value:
                    out += _len_field(number, item.encode())
            else:  # MAP: entries in key order, key and value both written
                for k in sorted(value, key=_map_order):
                    entry = (_len_field(1, _string(k, what))
                             + _len_field(2, _string(value[k], what)))
                    out += _len_field(number, entry)
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes):
        spec = {number: (name, kind, sub) for number, name, kind, sub in cls._FIELDS}
        values: dict = {}
        # message fields, merged as protobuf merges them: by concatenation
        parts: dict[str, tuple[type, bytearray]] = {}
        for number, wire, raw in _fields(bytes(data)):
            if number not in spec:
                continue  # a field of a newer API version
            name, kind, sub = spec[number]
            what = f"{cls.__name__}.{name}"
            want = _VARINT if kind in (BOOL, INT32, INT64) else _LEN
            if wire != want:
                raise DecodeError(f"{what}: wire type {wire}, want {want}")
            if kind == STRING:
                values[name] = _utf8(raw, what)
            elif kind == BOOL:
                values[name] = raw != 0
            elif kind == INT32:
                values[name] = _signed(raw, 32)
            elif kind == INT64:
                values[name] = _signed(raw, 64)
            elif kind == MESSAGE:
                parts.setdefault(name, (sub, bytearray()))[1].extend(raw)
            elif kind == REPEATED_STRING:
                values.setdefault(name, []).append(_utf8(raw, what))
            elif kind == REPEATED_MESSAGE:
                values.setdefault(name, []).append(sub.decode(raw))
            else:  # MAP
                entry = {1: "", 2: ""}
                for n, w, v in _fields(raw):
                    if n in entry:
                        if w != _LEN:
                            raise DecodeError(f"{what}: map entry wire type {w}")
                        entry[n] = _utf8(v, what)
                values.setdefault(name, {})[entry[1]] = entry[2]
        for name, (sub, raw) in parts.items():
            values[name] = sub.decode(bytes(raw))
        return cls(**values)


@dataclass
class DevicePluginOptions(Message):
    pre_start_required: bool = False
    get_preferred_allocation_available: bool = False
    _FIELDS: ClassVar[tuple] = (
        (1, "pre_start_required", BOOL, None),
        (2, "get_preferred_allocation_available", BOOL, None),
    )


@dataclass
class RegisterRequest(Message):
    version: str = ""
    endpoint: str = ""
    resource_name: str = ""
    options: Optional[DevicePluginOptions] = None
    _FIELDS: ClassVar[tuple] = (
        (1, "version", STRING, None),
        (2, "endpoint", STRING, None),
        (3, "resource_name", STRING, None),
        (4, "options", MESSAGE, DevicePluginOptions),
    )


@dataclass
class Empty(Message):
    pass


@dataclass
class NUMANode(Message):
    ID: int = 0
    _FIELDS: ClassVar[tuple] = ((1, "ID", INT64, None),)


@dataclass
class TopologyInfo(Message):
    nodes: list[NUMANode] = field(default_factory=list)
    _FIELDS: ClassVar[tuple] = ((1, "nodes", REPEATED_MESSAGE, NUMANode),)


@dataclass
class Device(Message):
    ID: str = ""
    health: str = ""
    topology: Optional[TopologyInfo] = None
    _FIELDS: ClassVar[tuple] = (
        (1, "ID", STRING, None),
        (2, "health", STRING, None),
        (3, "topology", MESSAGE, TopologyInfo),
    )


@dataclass
class ListAndWatchResponse(Message):
    devices: list[Device] = field(default_factory=list)
    _FIELDS: ClassVar[tuple] = ((1, "devices", REPEATED_MESSAGE, Device),)


@dataclass
class ContainerPreferredAllocationRequest(Message):
    available_deviceIDs: list[str] = field(default_factory=list)
    must_include_deviceIDs: list[str] = field(default_factory=list)
    allocation_size: int = 0
    _FIELDS: ClassVar[tuple] = (
        (1, "available_deviceIDs", REPEATED_STRING, None),
        (2, "must_include_deviceIDs", REPEATED_STRING, None),
        (3, "allocation_size", INT32, None),
    )


@dataclass
class PreferredAllocationRequest(Message):
    container_requests: list[ContainerPreferredAllocationRequest] = field(
        default_factory=list)
    _FIELDS: ClassVar[tuple] = (
        (1, "container_requests", REPEATED_MESSAGE,
         ContainerPreferredAllocationRequest),
    )


@dataclass
class ContainerPreferredAllocationResponse(Message):
    deviceIDs: list[str] = field(default_factory=list)
    _FIELDS: ClassVar[tuple] = ((1, "deviceIDs", REPEATED_STRING, None),)


@dataclass
class PreferredAllocationResponse(Message):
    container_responses: list[ContainerPreferredAllocationResponse] = field(
        default_factory=list)
    _FIELDS: ClassVar[tuple] = (
        (1, "container_responses", REPEATED_MESSAGE,
         ContainerPreferredAllocationResponse),
    )


@dataclass
class PreStartContainerRequest(Message):
    devicesIDs: list[str] = field(default_factory=list)
    _FIELDS: ClassVar[tuple] = ((1, "devicesIDs", REPEATED_STRING, None),)


@dataclass
class PreStartContainerResponse(Message):
    pass


@dataclass
class ContainerAllocateRequest(Message):
    devicesIDs: list[str] = field(default_factory=list)
    _FIELDS: ClassVar[tuple] = ((1, "devicesIDs", REPEATED_STRING, None),)


@dataclass
class AllocateRequest(Message):
    container_requests: list[ContainerAllocateRequest] = field(default_factory=list)
    _FIELDS: ClassVar[tuple] = (
        (1, "container_requests", REPEATED_MESSAGE, ContainerAllocateRequest),
    )


@dataclass
class Mount(Message):
    container_path: str = ""
    host_path: str = ""
    read_only: bool = False
    _FIELDS: ClassVar[tuple] = (
        (1, "container_path", STRING, None),
        (2, "host_path", STRING, None),
        (3, "read_only", BOOL, None),
    )


@dataclass
class DeviceSpec(Message):
    container_path: str = ""
    host_path: str = ""
    permissions: str = ""
    _FIELDS: ClassVar[tuple] = (
        (1, "container_path", STRING, None),
        (2, "host_path", STRING, None),
        (3, "permissions", STRING, None),
    )


@dataclass
class CDIDevice(Message):
    name: str = ""
    _FIELDS: ClassVar[tuple] = ((1, "name", STRING, None),)


@dataclass
class ContainerAllocateResponse(Message):
    envs: dict[str, str] = field(default_factory=dict)
    mounts: list[Mount] = field(default_factory=list)
    devices: list[DeviceSpec] = field(default_factory=list)
    annotations: dict[str, str] = field(default_factory=dict)
    cdi_devices: list[CDIDevice] = field(default_factory=list)
    _FIELDS: ClassVar[tuple] = (
        (1, "envs", MAP, None),
        (2, "mounts", REPEATED_MESSAGE, Mount),
        (3, "devices", REPEATED_MESSAGE, DeviceSpec),
        (4, "annotations", MAP, None),
        (5, "cdi_devices", REPEATED_MESSAGE, CDIDevice),
    )


@dataclass
class AllocateResponse(Message):
    container_responses: list[ContainerAllocateResponse] = field(default_factory=list)
    _FIELDS: ClassVar[tuple] = (
        (1, "container_responses", REPEATED_MESSAGE, ContainerAllocateResponse),
    )


# every message of the spec, by its proto name
MESSAGES = {cls.__name__: cls for cls in (
    DevicePluginOptions, RegisterRequest, Empty, ListAndWatchResponse,
    TopologyInfo, NUMANode, Device, PreferredAllocationRequest,
    ContainerPreferredAllocationRequest, PreferredAllocationResponse,
    ContainerPreferredAllocationResponse, PreStartContainerRequest,
    PreStartContainerResponse, AllocateRequest, ContainerAllocateRequest,
    AllocateResponse, ContainerAllocateResponse, Mount, DeviceSpec, CDIDevice,
)}
