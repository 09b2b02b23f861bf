"""The device-memory quota guard: build ``libcudaguard.so`` and read its
counters.

``libcudaguard.so`` (``cudaguard.cpp``) is preloaded into a pod
(``LD_PRELOAD``) and meters the process's CUDA driver allocations against
the share's ``TPU_HBM_LIMIT_BYTES``. :func:`library_path` builds it with
g++ on first use into ``build/`` beside this file, as ``gpuinfo.py`` builds
its library, and returns the path to preload. Inside the pod,
:class:`Guard` reads the counters of the guard the process was started
with.
"""

from __future__ import annotations

import ctypes
import os

from tpukube_torch.native.gpuinfo import BUILD_DIR, compile_shared

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cudaguard.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libcudaguard.so")
# the guard throws nothing, and a C++ exception must not cross the driver's
# C interface
BUILD_FLAGS = ("-fno-exceptions",)


class GuardError(RuntimeError):
    pass


def library_path() -> str:
    """Path of libcudaguard.so, built if missing or older than its source."""
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_SOURCE) <= os.path.getmtime(_LIB_PATH):
        return _LIB_PATH
    return compile_shared(_SOURCE, _LIB_PATH, BUILD_FLAGS)


class Guard:
    """The guard preloaded into this process. Raises GuardError when the
    process was started without it."""

    def __init__(self):
        lib = ctypes.CDLL(None)
        if not hasattr(lib, "cudaguard_limit"):
            raise GuardError("libcudaguard is not loaded in this process (LD_PRELOAD)")
        for name in ("used", "limit", "peak", "refused"):
            fn = getattr(lib, f"cudaguard_{name}")
            fn.argtypes = []
            fn.restype = ctypes.c_int64
        self._lib = lib

    def used(self) -> int:
        """Bytes of device memory metered and not yet freed."""
        return self._lib.cudaguard_used()

    def limit(self) -> int:
        """The quota read from TPU_HBM_LIMIT_BYTES, or -1 (inert)."""
        return self._lib.cudaguard_limit()

    def peak(self) -> int:
        """The most bytes metered at once."""
        return self._lib.cudaguard_peak()

    def refused(self) -> int:
        """How many allocations the quota refused."""
        return self._lib.cudaguard_refused()
