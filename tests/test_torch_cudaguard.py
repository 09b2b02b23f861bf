"""The port's quota guard (tpukube_torch/native/cudaguard.cpp) over
cuda_stub.cpp, a stand-in libcuda.so.1 built here — the twins of
tests/test_config3.py, where the reference's hbmguard meters host buffers.

Each case runs cudaguard_selftest.cpp in a process of its own, with the
guard preloaded and the limit the case needs, once for each of the three
ways a process reaches the driver: by direct symbol, by dlsym on a
dlopen'ed handle, and by cuGetProcAddress_v2 (as cudart does). The same
self-test runs again under AddressSanitizer and UBSan."""

import os
import subprocess
import sys

import pytest
import torch

from tpukube.core.config import load_config as ref_load_config
from tpukube.device import TpuDeviceManager
from tpukube_torch import graft
from tpukube_torch.core.config import load_config
from tpukube_torch.device import DeviceError, GpuDeviceManager
from tpukube_torch.device.gpu import ENV_HBM_LIMIT, ENV_MEM_FRACTION
from tpukube_torch.native import cudaguard
from tpukube_torch.native.gpuinfo import compile_shared
from torch_refnative import use_private_tpuinfo

use_private_tpuinfo()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "tpukube_torch", "native")
MiB = 1 << 20
STUB_FLAGS = ("-Wl,-soname,libcuda.so.1", "-Wl,-Bsymbolic")
SANITIZE = ("-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
            "-fno-sanitize-recover=undefined")

ROUTES = ["direct", "dlsym", "proc"]
# case -> the limit its checks assume (None: no limit) and the stub's card
CASES = {
    "accumulate": (100 * MiB, None),
    "free": (100 * MiB, None),
    "inert": (None, None),
    "getinfo": (100 * MiB, None),
    "kinds": (64 * MiB, None),
    "foreign": (100 * MiB, None),
    "config3": (128 * MiB, 256 * MiB),
    "next": (None, None),
}


def _build_selftest(out_dir, flags=()):
    """The stub (libcuda.so.1) and the self-test linked against it."""
    stub = compile_shared(os.path.join(NATIVE, "cuda_stub.cpp"),
                          str(out_dir / "libcuda.so.1"), STUB_FLAGS + tuple(flags))
    exe = str(out_dir / "cudaguard_selftest")
    cmd = ["g++", "-O2", "-Wall", "-Werror", "-std=c++17", *flags, "-o", exe,
           os.path.join(NATIVE, "cudaguard_selftest.cpp"), f"-L{out_dir}",
           "-l:libcuda.so.1", f"-Wl,-rpath,{out_dir}", "-ldl"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return stub, exe


@pytest.fixture(scope="module")
def selftest(tmp_path_factory):
    return _build_selftest(tmp_path_factory.mktemp("cudaguard"))[1]


@pytest.fixture(scope="module")
def guard():
    return cudaguard.library_path()


def _run(exe, preload, route, case, env=None):
    limit, card = CASES[case]
    base = {k: v for k, v in os.environ.items()
            if k not in ("TPU_HBM_LIMIT_BYTES", "CUDA_STUB_TOTAL", "LD_PRELOAD")}
    if limit is not None:
        base["TPU_HBM_LIMIT_BYTES"] = str(limit)
    if card is not None:
        base["CUDA_STUB_TOTAL"] = str(card)
    return subprocess.run([exe, route, case], env={**base, **(env or {}), "LD_PRELOAD": preload},
                          capture_output=True, text=True, timeout=60)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("route", ROUTES)
def test_guard_over_cuda_stub(selftest, guard, route, case):
    proc = _run(selftest, guard, route, case)
    assert proc.returncode == 0 and proc.stdout.strip() == f"ok {route} {case}", (
        proc.stdout + proc.stderr)


def test_selftest_fails_without_the_guard(selftest):
    # the self-test is no oracle if it passes with nothing preloaded
    proc = _run(selftest, "", "direct", "accumulate")
    assert proc.returncode == 1 and "guard is not loaded" in proc.stdout


def test_guard_selftest_under_sanitizers(tmp_path, guard):
    """The self-test and the stub built with AddressSanitizer and UBSan, the
    guard with UBSan, every route and case: nothing on stderr.

    The guard itself is not built with ASan: ASan's runtime calls dlsym
    while it starts, before its shadow memory is mapped, and the guard's
    dlsym is what it reaches; an ASan-instrumented dlsym faults there
    (SIGSEGV at start-up, before main). The guard does not interpose
    malloc, so it and ASan's allocator coexist otherwise."""
    probe = subprocess.run(["g++", "-print-file-name=libasan.so"], capture_output=True,
                           text=True)
    libasan = probe.stdout.strip()
    assert os.path.isabs(libasan) and os.path.exists(libasan), "g++ lacks libasan"
    _, exe = _build_selftest(tmp_path, SANITIZE)
    ubsan_guard = compile_shared(
        os.path.join(NATIVE, "cudaguard.cpp"), str(tmp_path / "libcudaguard.so"),
        cudaguard.BUILD_FLAGS + ("-g", "-fsanitize=undefined", "-fno-sanitize-recover=undefined"))
    for route in ROUTES:
        for case in CASES:
            # ASan's runtime must come first in the initial library list
            proc = _run(exe, f"{libasan}:{ubsan_guard}", route, case)
            assert proc.returncode == 0 and proc.stderr == "", (
                route, case, proc.stdout, proc.stderr)


def test_config3_twin_two_shares_of_one_gpu(selftest, guard):
    """tests/test_config3.py:59-89 without the scheduler: one sim GPU of
    256 MiB with 2 shares — both on tpu-0, each with half the memory, no
    third — and share 0's env under the guard: 64 MiB fits, 200 MiB is
    refused."""
    env = {"TPUKUBE_BACKEND": "sim", "TPUKUBE_SHARES_PER_CHIP": "2",
           "TPUKUBE_SIM_MESH_DIMS": "1,1,1", "TPUKUBE_SIM_HOST_BLOCK": "1,1,1",
           "TPUKUBE_HBM_BYTES_PER_CHIP": str(256 * MiB)}
    with GpuDeviceManager(load_config(env=env)) as m, \
            TpuDeviceManager(ref_load_config(env=env)) as ref:
        ids = [d for d, _ in m.device_list()]
        assert ids == [d for d, _ in ref.device_list()]
        assert {d.split("-frac")[0] for d in ids} == {"tpu-0"} and len(ids) == 2
        assert m.preferred_allocation(ids, [], 2) == ids
        envs = [m.allocate_env([d]) for d in ids]
        for k, share in enumerate(envs):
            assert share[ENV_HBM_LIMIT] == str(128 * MiB) == ref.allocate_env([ids[k]])[ENV_HBM_LIMIT]
            assert share[ENV_MEM_FRACTION] == "0.5000"
        with pytest.raises(DeviceError, match="share does not match"):
            m.allocate_env(["tpu-0-frac2of2"])
        with pytest.raises(DeviceError, match="larger than available"):
            m.preferred_allocation(ids, [], 3)
    for route in ROUTES:
        proc = _run(selftest, guard, route, "config3",
                    env={ENV_HBM_LIMIT: envs[0][ENV_HBM_LIMIT]})
        assert proc.returncode == 0, proc.stdout + proc.stderr


def test_guard_counters_in_a_python_process(guard):
    """Under the guard a Python process imports torch and reads the guard's
    counters through cudaguard.Guard; a limit that does not parse leaves it
    inert; without the preload Guard() refuses."""
    code = ("import json, torch\n"
            "from tpukube_torch.native.cudaguard import Guard\n"
            "g = Guard()\n"
            "print(json.dumps([g.limit(), g.used(), g.peak(), g.refused()]))\n")
    base = {k: v for k, v in os.environ.items() if k != "TPU_HBM_LIMIT_BYTES"}
    for raw, limit in ((str(42760404992), 42760404992), ("x12", -1), ("", -1)):
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
            env={**base, "LD_PRELOAD": guard, "TPU_HBM_LIMIT_BYTES": raw,
                 "PYTHONPATH": REPO}, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip().splitlines()[-1] == f"[{limit}, 0, 0, 0]"
    with pytest.raises(cudaguard.GuardError, match="not loaded"):
        cudaguard.Guard()


def test_guard_is_rebuilt_when_its_source_is_newer(tmp_path, monkeypatch):
    lib = tmp_path / "libcudaguard.so"
    monkeypatch.setattr(cudaguard, "_LIB_PATH", str(lib))
    built = cudaguard.library_path()
    assert built == str(lib) and lib.exists()
    os.utime(lib, (1, 1))  # older than the source
    assert cudaguard.library_path() == str(lib) and os.path.getmtime(lib) > 1
    first = os.path.getmtime(lib)
    assert cudaguard.library_path() == str(lib) and os.path.getmtime(lib) == first


class _FakeGuard:
    """A guard and the card's allocator in one, for the quota pod's checks
    on the CPU: ``empty`` meters against the limit and refuses past it,
    as the guard does under PyTorch; a block frees itself when dropped."""

    def __init__(self, limit, refuses=True):
        self._limit, self.refuses = limit, refuses
        self.metered = self.top = self.n_refused = 0

    def limit(self):
        return self._limit

    def used(self):
        return self.metered

    def peak(self):
        return self.top

    def refused(self):
        return self.n_refused

    def empty(self, n, dtype=None, device=None):
        if self.metered + n > self._limit:
            self.n_refused += self.refuses
            raise torch.OutOfMemoryError("CUDA out of memory")
        self.metered += n
        self.top = max(self.top, self.metered)
        return _Block(self, n)


class _Block:
    def __init__(self, guard, n):
        self.guard, self.n = guard, n

    def __del__(self):
        self.guard.metered -= self.n


def _quota_check(monkeypatch, guard, limit, card_free=84 << 30):
    monkeypatch.setattr(torch, "empty", guard.empty)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (min(card_free, guard.limit() - guard.used()),
                                        85520809984))
    return graft.quota_check(torch.device("cuda:0"), limit, guard, lambda: card_free)


def test_quota_pod_checks_on_a_fake_card(monkeypatch):
    limit = 85520809984 // 2
    out = _quota_check(monkeypatch, _FakeGuard(limit), limit)
    assert out["blocks_fitted"] == 9 == limit // (4 << 30)
    assert out["used_at_refusal"] == 9 * (4 << 30)
    assert out["used_after_empty_cache"] == 0 and out["refused"] == 2
    assert out["used_with_limit_minus_4GiB"] == limit - (4 << 30)
    # an OutOfMemoryError the guard did not raise proves nothing
    with pytest.raises(RuntimeError, match="not by the guard's refusal"):
        _quota_check(monkeypatch, _FakeGuard(limit, refuses=False), limit)
    with pytest.raises(RuntimeError, match="cannot show the quota"):
        _quota_check(monkeypatch, _FakeGuard(limit), limit, card_free=limit)
    with pytest.raises(RuntimeError, match="guard limit"):
        _quota_check(monkeypatch, _FakeGuard(limit - 1), limit)
