"""ctypes wrapper over libgpuinfo.so, the port's discovery shim.

The Python surface is that of ``tpukube/native/tpuinfo.py`` (``TpuInfo``,
``sim_spec``), so the device manager ports line for line. The library is
built on first use with g++ into ``build/`` beside this file (listed in
``.gitignore``), again whenever a source is newer than it. The compiler
writes a name of its own and the result is renamed into place, so parallel
test workers never load a half-written library.

libgpuinfo is single-instance; :class:`GpuInfo` serializes all calls
behind a lock.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import ChipInfo, Health, TopologyCoord

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = tuple(
    os.path.join(_NATIVE_DIR, f) for f in ("gpuinfo.cpp", "gpuinfo.h")
)
BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB_PATH = os.path.join(BUILD_DIR, "libgpuinfo.so")

ABI_VERSION = 2
_MAX_ID = 96
_MAX_LINKS = 6


class GpuInfoError(RuntimeError):
    pass


class _Chip(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_int32),
        ("chip_id", ctypes.c_char * _MAX_ID),
        ("coord", ctypes.c_int32 * 3),
        ("hbm_bytes", ctypes.c_int64),
        ("num_cores", ctypes.c_int32),
        ("healthy", ctypes.c_int32),
    ]


class _Mesh(ctypes.Structure):
    _fields_ = [
        ("dims", ctypes.c_int32 * 3),
        ("host_block", ctypes.c_int32 * 3),
        ("torus", ctypes.c_int32 * 3),
    ]


def compile_shared(src: str, out: str, flags: tuple = ()) -> str:
    """g++ ``src`` (with the extra ``flags``) into the shared library
    ``out``: compiled under a name of its own, then renamed into place.
    Raises GpuInfoError with the compiler's output on failure."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O2", "-Wall", "-Werror", "-fPIC", "-shared", "-std=c++17",
           *flags, "-o", tmp, src, "-ldl"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise GpuInfoError(f"failed to build {os.path.basename(out)}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise GpuInfoError(
            f"failed to build {os.path.basename(out)}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _ensure_built() -> str:
    """Build libgpuinfo.so if missing or older than its sources."""
    if os.path.exists(_LIB_PATH):
        lib_mtime = os.path.getmtime(_LIB_PATH)
        if all(os.path.getmtime(p) <= lib_mtime for p in _SOURCES):
            return _LIB_PATH
    return compile_shared(_SOURCES[0], _LIB_PATH)


_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_ensure_built())
        lib.gpuinfo_abi_version.restype = ctypes.c_int
        # ABI first: binding newer symbols against a stale library would
        # die with an opaque AttributeError
        abi = lib.gpuinfo_abi_version()
        if abi != ABI_VERSION:
            raise GpuInfoError(f"libgpuinfo ABI {abi} != expected {ABI_VERSION}")
        lib.gpuinfo_init.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.gpuinfo_init.restype = ctypes.c_int
        lib.gpuinfo_shutdown.argtypes = []
        lib.gpuinfo_shutdown.restype = ctypes.c_int
        lib.gpuinfo_mesh_get.argtypes = [ctypes.POINTER(_Mesh)]
        lib.gpuinfo_mesh_get.restype = ctypes.c_int
        lib.gpuinfo_chip_count.argtypes = []
        lib.gpuinfo_chip_count.restype = ctypes.c_int
        lib.gpuinfo_chip_get.argtypes = [ctypes.c_int32, ctypes.POINTER(_Chip)]
        lib.gpuinfo_chip_get.restype = ctypes.c_int
        lib.gpuinfo_chip_links.argtypes = [
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.gpuinfo_chip_links.restype = ctypes.c_int
        lib.gpuinfo_inject_fault.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.gpuinfo_inject_fault.restype = ctypes.c_int
        lib.gpuinfo_inject_link_fault.argtypes = [ctypes.c_int32] * 7
        lib.gpuinfo_inject_link_fault.restype = ctypes.c_int
        lib.gpuinfo_link_faults.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.gpuinfo_link_faults.restype = ctypes.c_int
        lib.gpuinfo_last_error.argtypes = []
        lib.gpuinfo_last_error.restype = ctypes.c_char_p
        lib.gpuinfo_source.argtypes = []
        lib.gpuinfo_source.restype = ctypes.c_char_p
        lib.gpuinfo_probe.argtypes = []
        lib.gpuinfo_probe.restype = ctypes.c_int
        lib.gpuinfo_chip_telemetry.argtypes = [
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.gpuinfo_chip_telemetry.restype = ctypes.c_int
        _lib = lib
        return lib


def sim_spec(
    mesh: MeshSpec,
    host: str,
    hbm_bytes: int,
    cores: int = 2,
    origin: Optional[tuple[int, int, int]] = None,
) -> str:
    """Render the key=value sim spec libgpuinfo parses (the keys of the
    reference's libtpuinfo sim).

    ``origin`` pins the host block's chip-coord origin; without it the C
    side derives it from the host-i-j-k name convention."""

    def triple(t) -> str:
        return ",".join(str(int(v)) for v in t)

    out = (
        f"dims={triple(mesh.dims)}\n"
        f"host_block={triple(mesh.host_block)}\n"
        f"torus={triple(mesh.torus)}\n"
        f"host={host}\n"
        f"hbm={hbm_bytes}\n"
        f"cores={cores}\n"
    )
    if origin is not None:
        out += f"origin={triple(origin)}\n"
    return out


class GpuInfo:
    """One initialized enumeration session (context manager).

    >>> with GpuInfo("real") as gi:   # NVML
    ...     chips = gi.chips()
    """

    _instance_lock = threading.Lock()

    def __init__(self, backend: str, spec: Optional[str] = None):
        self._lib = _load()
        self._lock = threading.Lock()
        self._open = False
        with GpuInfo._instance_lock:
            rc = self._lib.gpuinfo_init(
                backend.encode(), spec.encode() if spec is not None else None
            )
            if rc != 0:
                raise GpuInfoError(self._last_error())
            self._open = True

    def _last_error(self) -> str:
        return (self._lib.gpuinfo_last_error() or b"").decode()

    def _check_open(self) -> None:
        if not self._open:
            raise GpuInfoError("GpuInfo session is closed")

    def close(self) -> None:
        # _instance_lock serializes shutdown against a concurrent __init__:
        # the C globals are not thread-safe
        with GpuInfo._instance_lock, self._lock:
            if self._open:
                self._open = False
                if self._lib.gpuinfo_shutdown() != 0:
                    raise GpuInfoError(self._last_error())

    def __enter__(self) -> "GpuInfo":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        # a leaked session would wedge the process-wide singleton; release
        # it on GC (explicit close() remains the contract)
        try:
            self.close()
        # tpukube: allow(exception-hygiene) GC-time best effort: logging machinery may already be finalized at interpreter shutdown
        except Exception:
            pass

    def mesh(self) -> MeshSpec:
        with self._lock:
            self._check_open()
            m = _Mesh()
            if self._lib.gpuinfo_mesh_get(ctypes.byref(m)) != 0:
                raise GpuInfoError(self._last_error())
            return MeshSpec(
                dims=tuple(m.dims),
                host_block=tuple(m.host_block),
                torus=tuple(bool(v) for v in m.torus),
            )

    def chip_count(self) -> int:
        with self._lock:
            self._check_open()
            n = self._lib.gpuinfo_chip_count()
            if n < 0:
                raise GpuInfoError(self._last_error())
            return n

    def source(self) -> str:
        """Where the inventory came from: "sim" or "nvml"."""
        with self._lock:
            self._check_open()
            return (self._lib.gpuinfo_source() or b"").decode()

    def probe(self) -> bool:
        """Health re-probe (see gpuinfo.h gpuinfo_probe): drains NVML's XID
        events in xid mode, then checks liveness. True when every GPU is
        healthy; False when any is not. Sim backend: always True (sim
        health is driven by inject_fault)."""
        with self._lock:
            self._check_open()
            rc = self._lib.gpuinfo_probe()
            if rc < 0:
                raise GpuInfoError(self._last_error())
            return bool(rc)

    def last_error(self) -> str:
        """Why the last call failed, or what the last probe found."""
        with self._lock:
            return self._last_error()

    def telemetry(self, index: int) -> tuple[int, int]:
        """NVML's (GPU utilization percent, device memory in use in bytes)
        of GPU ``index`` — real backend only."""
        with self._lock:
            self._check_open()
            util, used = ctypes.c_uint32(), ctypes.c_uint64()
            rc = self._lib.gpuinfo_chip_telemetry(
                index, ctypes.byref(util), ctypes.byref(used))
            if rc != 0:
                raise GpuInfoError(self._last_error())
            return int(util.value), int(used.value)

    def chips(self) -> list[ChipInfo]:
        with self._lock:
            self._check_open()
            n = self._lib.gpuinfo_chip_count()
            if n < 0:
                raise GpuInfoError(self._last_error())
            out: list[ChipInfo] = []
            for i in range(n):
                c = _Chip()
                if self._lib.gpuinfo_chip_get(i, ctypes.byref(c)) != 0:
                    raise GpuInfoError(self._last_error())
                out.append(
                    ChipInfo(
                        chip_id=c.chip_id.decode(),
                        index=int(c.index),
                        coord=TopologyCoord(*c.coord),
                        hbm_bytes=int(c.hbm_bytes),
                        num_cores=int(c.num_cores),
                        health=Health.HEALTHY if c.healthy else Health.UNHEALTHY,
                    )
                )
            return out

    def links(self, index: int) -> list[TopologyCoord]:
        """Neighbor coords of a chip in the mesh."""
        with self._lock:
            self._check_open()
            buf = (ctypes.c_int32 * (3 * _MAX_LINKS))()
            n = self._lib.gpuinfo_chip_links(index, buf, _MAX_LINKS)
            if n < 0:
                raise GpuInfoError(self._last_error())
            return [
                TopologyCoord(buf[3 * i], buf[3 * i + 1], buf[3 * i + 2])
                for i in range(n)
            ]

    def inject_fault(self, index: int, healthy: bool = False) -> None:
        """Flip a chip's health (sim backend only) — the XID-event analog."""
        with self._lock:
            self._check_open()
            if self._lib.gpuinfo_inject_fault(index, 1 if healthy else 0) != 0:
                raise GpuInfoError(self._last_error())

    def inject_link_fault(
        self, a: TopologyCoord, b: TopologyCoord, up: bool = False
    ) -> None:
        """Mark the link between adjacent chips ``a``/``b`` down (or back
        up) — sim backend only."""
        with self._lock:
            self._check_open()
            a, b = TopologyCoord.of(a), TopologyCoord.of(b)
            rc = self._lib.gpuinfo_inject_link_fault(
                a.x, a.y, a.z, b.x, b.y, b.z, 1 if up else 0
            )
            if rc != 0:
                raise GpuInfoError(self._last_error())

    def link_faults(self) -> list[tuple[TopologyCoord, TopologyCoord]]:
        """All downed links, canonical (a <= b) coord pairs."""
        with self._lock:
            self._check_open()
            max_n = 16
            while True:
                buf = (ctypes.c_int32 * (6 * max_n))()
                n = self._lib.gpuinfo_link_faults(buf, max_n)
                if n < 0:
                    raise GpuInfoError(self._last_error())
                if n <= max_n:
                    return [
                        (
                            TopologyCoord(buf[6 * i], buf[6 * i + 1], buf[6 * i + 2]),
                            TopologyCoord(buf[6 * i + 3], buf[6 * i + 4], buf[6 * i + 5]),
                        )
                        for i in range(n)
                    ]
                max_n = n
