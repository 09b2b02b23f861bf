"""The reference's ``libtpuinfo.so`` for the port's tests, from a build of
their own.

``tpukube/native/tpuinfo.py`` builds its library in place on first use
(``make -C tpukube/native libtpuinfo.so``), and g++ writes the output file
where it stands. Under parallel test workers one process can then
``dlopen`` the file while another is still writing it ("file too short").
The port's tests load a copy instead: the reference's own Makefile builds it
in a directory of its own, and the finished file is renamed whole into
``tpukube_torch/native/build/``. ``tpukube.native.tpuinfo`` is pointed there
before its first load. Nothing of ``tpukube/`` is written.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import tpukube.native.tpuinfo as ref_tpuinfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NATIVE = os.path.join(REPO, "tpukube", "native")
SOURCES = ("tpuinfo.cpp", "tpuinfo.h", "Makefile")
PRIVATE_LIB = os.path.join(REPO, "tpukube_torch", "native", "build",
                           "libtpuinfo_ref.so")


def _up_to_date(lib: str) -> bool:
    if not os.path.exists(lib):
        return False
    built = os.path.getmtime(lib)
    return all(os.path.getmtime(os.path.join(REF_NATIVE, s)) <= built
               for s in SOURCES)


def build_private_tpuinfo() -> str:
    """Build the reference library with its Makefile in a fresh directory
    and rename it into ``PRIVATE_LIB`` (an atomic replace: a reader sees the
    old file or the new one, never a part)."""
    if _up_to_date(PRIVATE_LIB):
        return PRIVATE_LIB
    out_dir = os.path.dirname(PRIVATE_LIB)
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(prefix="tpuinfo.", dir=out_dir)
    try:
        for s in SOURCES:
            shutil.copy2(os.path.join(REF_NATIVE, s), work)
        proc = subprocess.run(["make", "-s", "-C", work, "libtpuinfo.so"],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"reference libtpuinfo.so failed to build:\n{proc.stdout}\n"
                f"{proc.stderr}")
        os.replace(os.path.join(work, "libtpuinfo.so"), PRIVATE_LIB)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return PRIVATE_LIB


def use_private_tpuinfo() -> None:
    """Point the reference's ctypes wrapper at the private copy (a no-op
    once the library is loaded in this process)."""
    ref_tpuinfo._LIB_PATH = build_private_tpuinfo()
