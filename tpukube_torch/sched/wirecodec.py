"""Compact binary wire codec of the sharded plane's ``/worker/*`` surface
— the port's copy of ``tpukube/sched/wirecodec.py``, byte for byte on the
wire.

The router speaks to its worker daemons (``sched/shardworker.py``) over
HTTP. ``wire_codec: json`` (the default) sends compact JSON and is the
parity oracle; ``wire_codec: binary`` sends TKW1 frames, negotiated per
request through ``Content-Type``/``Accept`` (``sched/shard.py``'s
``SubprocessTransport``), so a binary router facing a JSON-only worker
degrades to JSON for that replica.

Frame layout (the magic pins format v1, including the preset key table):

    b"TKW1" | flags:1 byte | payload

    flags 0 = raw payload, 1 = zlib-compressed, 2 = zstd-compressed
    (zstd only where the standard library ships it, Python 3.14+; on
    3.12 zlib is the compressor on both ends).

The payload is a tag byte and its data per value. Three things make it
compact on the hot bodies (fleet batches, admit waves, alloc deltas):

* **Key tables**: a list of dicts sharing one key tuple is TAG_TABLE —
  the keys once, then bare rows.
* **String interning**: a string of at most ``_INTERN_MAX`` bytes gets an
  id on first sight (TAG_STR_NEW) and is referenced by id after
  (TAG_STR_REF); the rule is symmetric, so no table crosses the wire.
* **Preset keys**: the recurring ``/worker/*`` keys are interned on both
  sides before the first value.

Ints are zigzag varints, floats 8-byte doubles: ``decode(encode(x)) ==
x`` for any JSON value.
"""
from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, Dict, List, Tuple

try:  # stdlib zstd (Python 3.14+); Python 3.12 has zlib only
    from compression import zstd as _zstd  # type: ignore
except ImportError:  # pragma: no cover - environment-dependent
    _zstd = None

# HTTP content type announcing/carrying a TKW1 frame. The transport
# sends it in Accept (capability probe) and Content-Type (body format);
# the worker mirrors it back only when the request asked for it.
WIRE_CONTENT_TYPE = "application/x-tpukube-wire"
JSON_CONTENT_TYPE = "application/json"

# Compact separators on the codec-off path: journal.py already
# writes compact JSON; the wire should too.
JSON_SEPARATORS = (",", ":")

_MAGIC = b"TKW1"
_FLAG_RAW = 0
_FLAG_ZLIB = 1
_FLAG_ZSTD = 2

# Value tags.
_T_NONE = 0
_T_TRUE = 1
_T_FALSE = 2
_T_INT = 3  # zigzag varint
_T_FLOAT = 4  # 8-byte little-endian double
_T_STR_NEW = 5  # varint len + utf-8 bytes; interned if len <= _INTERN_MAX
_T_STR_REF = 6  # varint intern id
_T_STR_BIG = 7  # varint len + utf-8 bytes; never interned
_T_LIST = 8  # varint count + values
_T_DICT = 9  # varint count + (key value)*
_T_TABLE = 10  # varint ncols + keys, varint nrows + bare rows

# Strings longer than this are not interned: the table would grow on
# one-shot payload blobs without ever earning a reference back.
_INTERN_MAX = 64

# Keys pre-seeded into the intern table on BOTH sides, pinned to the
# TKW1 magic (changing this list means bumping the version). These are
# the recurring `/worker/*` body/response keys, so the schema row of a
# TAG_TABLE costs one varint per key even on the first frame.
_PRESET_STRINGS: Tuple[str, ...] = (
    # fleet node batches (upsert_nodes) / node annotations
    "name", "nodes", "node", "slice", "slice_id", "topology", "chips",
    "devices", "device_ids", "badLinks", "bad_links", "labels", "free",
    "used", "capacity", "health", "healthy", "epoch", "generation",
    # pod admission / planning waves
    "pod", "pods", "pod_name", "namespace", "uid", "request", "requests",
    "shape", "count", "priority", "tenant", "gang", "gang_id", "phase",
    "status", "reason", "ok", "error",
    # allocation deltas / rendezvous
    "alloc", "allocs", "allocations", "seq", "since", "deltas", "kind",
    "bind", "binds", "release", "released", "planned", "txn", "txn_id",
    "commit", "abort", "ts",
    # summaries / gauges
    "summary", "gauges", "total", "value", "values", "items", "result",
)

_STRUCT_DOUBLE = struct.Struct("<d")


class WireCodecError(ValueError):
    """Raised on any malformed, truncated or unsupported wire frame.

    The worker maps this to HTTP 400 (never a crash, never a dead
    replica); the transport maps a response-side decode failure to a
    ShardError on that one request.
    """


def zstd_available() -> bool:
    return _zstd is not None


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63) if -(1 << 63) <= n < (1 << 63) else _raise_int(n)


def _raise_int(n: int) -> int:
    raise WireCodecError(f"int out of 64-bit range: {n}")


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _write_varint(out: io.BytesIO, u: int) -> None:
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.write(bytes((b | 0x80,)))
        else:
            out.write(bytes((b,)))
            return


class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0
        self.end = len(buf)

    def read_varint(self) -> int:
        u = 0
        shift = 0
        buf, pos, end = self.buf, self.pos, self.end
        while True:
            if pos >= end:
                raise WireCodecError("truncated varint")
            b = buf[pos]
            pos += 1
            u |= (b & 0x7F) << shift
            if not b & 0x80:
                self.pos = pos
                return u
            shift += 7
            if shift > 70:
                raise WireCodecError("varint too long")

    def read_bytes(self, n: int) -> bytes:
        pos = self.pos
        if n < 0 or pos + n > self.end:
            raise WireCodecError("truncated frame body")
        self.pos = pos + n
        return self.buf[pos : pos + n]

    def read_byte(self) -> int:
        pos = self.pos
        if pos >= self.end:
            raise WireCodecError("truncated frame body")
        self.pos = pos + 1
        return self.buf[pos]


class _Encoder:
    """One frame's encode pass: intern table is per-frame (stateless
    across requests, so worker restarts need no codec re-sync)."""

    __slots__ = ("out", "interned")

    def __init__(self) -> None:
        self.out = io.BytesIO()
        self.interned: Dict[str, int] = {
            s: i for i, s in enumerate(_PRESET_STRINGS)
        }

    def encode_value(self, v: Any) -> None:
        out = self.out
        if v is None:
            out.write(b"\x00")
        elif v is True:
            out.write(b"\x01")
        elif v is False:
            out.write(b"\x02")
        elif type(v) is int:
            out.write(b"\x03")
            _write_varint(out, _zigzag(v))
        elif type(v) is float:
            out.write(b"\x04")
            out.write(_STRUCT_DOUBLE.pack(v))
        elif type(v) is str:
            self._encode_str(v)
        elif type(v) is list:
            self._encode_list(v)
        elif type(v) is dict:
            self._encode_dict(v)
        elif isinstance(v, bool):  # bool subclass guard (unreachable for
            out.write(b"\x01" if v else b"\x02")  # real json input)
        elif isinstance(v, int):
            out.write(b"\x03")
            _write_varint(out, _zigzag(int(v)))
        elif isinstance(v, float):
            out.write(b"\x04")
            out.write(_STRUCT_DOUBLE.pack(float(v)))
        elif isinstance(v, str):
            self._encode_str(str(v))
        elif isinstance(v, (list, tuple)):
            self._encode_list(list(v))
        elif isinstance(v, dict):
            self._encode_dict(dict(v))
        else:
            raise WireCodecError(
                f"unencodable type on the wire: {type(v).__name__}"
            )

    def _encode_str(self, s: str) -> None:
        out = self.out
        ref = self.interned.get(s)
        if ref is not None:
            out.write(b"\x06")
            _write_varint(out, ref)
            return
        raw = s.encode("utf-8")
        if len(raw) <= _INTERN_MAX:
            self.interned[s] = len(self.interned)
            out.write(b"\x05")
        else:
            out.write(b"\x07")
        _write_varint(out, len(raw))
        out.write(raw)

    def _encode_list(self, v: List[Any]) -> None:
        out = self.out
        # Per-op key table: a non-trivial list of dicts sharing one key
        # tuple encodes schema-once/rows-after. The hot wave bodies
        # (fleet batches, pod lists, alloc deltas) all hit this path.
        if len(v) >= 2 and type(v[0]) is dict and v[0]:
            keys = tuple(v[0].keys())
            homogeneous = True
            for item in v:
                if type(item) is not dict or tuple(item.keys()) != keys:
                    homogeneous = False
                    break
            if homogeneous:
                out.write(b"\x0a")
                _write_varint(out, len(keys))
                for k in keys:
                    if type(k) is not str:
                        raise WireCodecError("non-string dict key")
                    self._encode_str(k)
                _write_varint(out, len(v))
                for item in v:
                    for k in keys:
                        self.encode_value(item[k])
                return
        out.write(b"\x08")
        _write_varint(out, len(v))
        for item in v:
            self.encode_value(item)

    def _encode_dict(self, v: Dict[str, Any]) -> None:
        out = self.out
        out.write(b"\x09")
        _write_varint(out, len(v))
        for k, val in v.items():
            if type(k) is not str:
                raise WireCodecError("non-string dict key")
            self._encode_str(k)
            self.encode_value(val)


class _Decoder:
    __slots__ = ("r", "interned")

    def __init__(self, buf: bytes) -> None:
        self.r = _Reader(buf)
        self.interned: List[str] = list(_PRESET_STRINGS)

    def decode_value(self) -> Any:
        r = self.r
        tag = r.read_byte()
        if tag == _T_NONE:
            return None
        if tag == _T_TRUE:
            return True
        if tag == _T_FALSE:
            return False
        if tag == _T_INT:
            return _unzigzag(r.read_varint())
        if tag == _T_FLOAT:
            return _STRUCT_DOUBLE.unpack(r.read_bytes(8))[0]
        if tag in (_T_STR_NEW, _T_STR_BIG):
            n = r.read_varint()
            try:
                s = r.read_bytes(n).decode("utf-8")
            except UnicodeDecodeError as e:
                raise WireCodecError(f"bad utf-8 in string: {e}") from e
            if tag == _T_STR_NEW:
                if len(s.encode("utf-8")) > _INTERN_MAX:
                    raise WireCodecError("oversized interned string")
                self.interned.append(s)
            return s
        if tag == _T_STR_REF:
            ref = r.read_varint()
            if ref >= len(self.interned):
                raise WireCodecError(f"dangling string ref {ref}")
            return self.interned[ref]
        if tag == _T_LIST:
            n = r.read_varint()
            if n > r.end - r.pos:  # each element costs >= 1 byte
                raise WireCodecError("list count exceeds frame")
            return [self.decode_value() for _ in range(n)]
        if tag == _T_DICT:
            n = r.read_varint()
            if n * 2 > r.end - r.pos:
                raise WireCodecError("dict count exceeds frame")
            d: Dict[str, Any] = {}
            for _ in range(n):
                k = self.decode_value()
                if type(k) is not str:
                    raise WireCodecError("non-string dict key on decode")
                d[k] = self.decode_value()
            return d
        if tag == _T_TABLE:
            ncols = r.read_varint()
            if ncols == 0 or ncols > r.end - r.pos:
                raise WireCodecError("bad table schema")
            keys = []
            for _ in range(ncols):
                k = self.decode_value()
                if type(k) is not str:
                    raise WireCodecError("non-string table key")
                keys.append(k)
            nrows = r.read_varint()
            if nrows * ncols > r.end - r.pos:
                raise WireCodecError("table rows exceed frame")
            rows = []
            for _ in range(nrows):
                rows.append({k: self.decode_value() for k in keys})
            return rows
        raise WireCodecError(f"unknown value tag {tag}")


def encode_frame(obj: Any, compress_min_bytes: int = 1024) -> Tuple[bytes, int]:
    """Encode *obj* into a TKW1 frame.

    Returns ``(frame, raw_len)`` where *raw_len* is the pre-compression
    payload size — the wire accounting uses it to report bytes saved and
    the per-op compression ratio without re-serializing to JSON.
    Payloads at or above *compress_min_bytes* are compressed (zstd when
    the stdlib has it, zlib level 1 otherwise) but kept raw if
    compression doesn't actually shrink them.
    """
    enc = _Encoder()
    enc.encode_value(obj)
    raw = enc.out.getvalue()
    flag = _FLAG_RAW
    payload = raw
    if compress_min_bytes >= 0 and len(raw) >= compress_min_bytes:
        if _zstd is not None:
            comp = _zstd.compress(raw, 1)
            cflag = _FLAG_ZSTD
        else:
            comp = zlib.compress(raw, 1)
            cflag = _FLAG_ZLIB
        if len(comp) < len(raw):
            payload = comp
            flag = cflag
    return _MAGIC + bytes((flag,)) + payload, len(raw)


def decode_frame(frame: bytes) -> Any:
    """Decode a TKW1 frame back to the exact object that was encoded.

    Raises :class:`WireCodecError` on anything malformed — wrong magic,
    unknown flags, truncated or trailing bytes, corrupt payload.
    """
    return decode_frame_ex(frame)[0]


def decode_frame_ex(frame: bytes) -> Tuple[Any, int]:
    """Like :func:`decode_frame` but also returns the pre-compression
    payload size, which the transport's wire accounting reports as the
    per-op ``raw`` bytes next to what actually crossed the socket."""
    if len(frame) < 6:
        raise WireCodecError("frame too short")
    if frame[:4] != _MAGIC:
        raise WireCodecError(f"bad magic {frame[:4]!r}")
    flag = frame[4]
    payload = frame[5:]
    if flag == _FLAG_ZLIB:
        try:
            payload = zlib.decompress(payload)
        except zlib.error as e:
            raise WireCodecError(f"zlib payload corrupt: {e}") from e
    elif flag == _FLAG_ZSTD:
        if _zstd is None:
            raise WireCodecError("zstd frame but no zstd support")
        try:
            payload = _zstd.decompress(payload)
        except Exception as e:
            raise WireCodecError(f"zstd payload corrupt: {e}") from e
    elif flag != _FLAG_RAW:
        raise WireCodecError(f"unknown frame flags {flag}")
    dec = _Decoder(payload)
    obj = dec.decode_value()
    if dec.r.pos != dec.r.end:
        raise WireCodecError(
            f"{dec.r.end - dec.r.pos} trailing bytes after value"
        )
    return obj, len(payload)


def dumps_json(obj: Any) -> bytes:
    """Compact JSON body — the codec-off wire path (and the oracle)."""
    return json.dumps(obj, separators=JSON_SEPARATORS).encode("utf-8")
