"""The port's vGPU sharing (tpukube_torch/device/gpu.py) against the
reference TpuDeviceManager on the same sim specs: shares advertised, the
shares env up to the renamed keys, refusals, preferred_allocation (the
reference's cases and a seeded random sweep) and sim telemetry. Then the
real backend's shares, all-to-all affinity and NVML telemetry against
tpukube_torch/native/nvml_stub.cpp, and the pod side of a share's env."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpukube.core.config import load_config as ref_load_config
from tpukube.device import DeviceError as RefDeviceError
from tpukube.device import TpuDeviceManager
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import Health
from tpukube_torch.device import DeviceError, GpuDeviceManager
from tpukube_torch.device.gpu import (
    ENV_DEVICE_ORDER,
    ENV_KUBE_CORE_IDS,
    ENV_MEM_FRACTION,
    ENV_MPS_THREAD_PERCENTAGE,
    ENV_VISIBLE_DEVICES,
)
from tpukube_torch.native.gpuinfo import compile_shared
from tpukube_torch.workload.meshenv import PodGpuEnv, device_from_alloc_env
from torch_refnative import use_private_tpuinfo

use_private_tpuinfo()

HBM = 16 << 30
STUB_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tpukube_torch", "native", "nvml_stub.cpp",
)


def _env(shares=2, cores=2, extra=None):
    return {
        "TPUKUBE_BACKEND": "sim",
        "TPUKUBE_SHARES_PER_CHIP": str(shares),
        "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
        "TPUKUBE_HBM_BYTES_PER_CHIP": str(HBM),
        "TPUKUBE_CORES_PER_CHIP": str(cores),
        **(extra or {}),
    }


def _pair(shares=2, cores=2, extra=None, host="host-0-0-0"):
    env = _env(shares, cores, extra)
    return (GpuDeviceManager(load_config(env=env), host=host),
            TpuDeviceManager(ref_load_config(env=env), host=host))


def _renamed(ref_env, cores):
    """The reference's env under the port's names: CUDA visibility, the
    memory fraction under TPU_KUBE_MEM_FRACTION, and MPS's SM percentage
    beside the core ids, from the most constrained GPU's owned SMs."""
    out = dict(ref_env)
    out[ENV_VISIBLE_DEVICES] = out.pop("TPU_VISIBLE_DEVICES")
    out[ENV_DEVICE_ORDER] = "PCI_BUS_ID"
    if "XLA_PYTHON_CLIENT_MEM_FRACTION" in out:
        out[ENV_MEM_FRACTION] = out.pop("XLA_PYTHON_CLIENT_MEM_FRACTION")
    if ENV_KUBE_CORE_IDS in out:
        owned = [len(part.split(":")[1].split("+"))
                 for part in out[ENV_KUBE_CORE_IDS].split(";")]
        out[ENV_MPS_THREAD_PERCENTAGE] = str(min(owned) * 100 // cores)
    return out


@pytest.mark.parametrize("shares,extra,host", [
    (2, None, "host-0-0-0"),
    (4, None, "host-1-1-0"),
    (2, {"TPUKUBE_SIM_MESH_DIMS": "1,1,1", "TPUKUBE_SIM_HOST_BLOCK": "1,1,1"},
     "host-0-0-0"),
    (1, None, "host-0-0-0"),
])
def test_device_list_matches_reference(shares, extra, host):
    gpu, tpu = _pair(shares, extra=extra, host=host)
    with gpu, tpu:
        assert gpu.resource_name == tpu.resource_name == (
            "qiniu.com/vtpu" if shares > 1 else "qiniu.com/tpu")
        assert [(d, h.value) for d, h in gpu.device_list()] == [
            (d, h.value) for d, h in tpu.device_list()]
        assert gpu.node_info().shares_per_chip == shares
        for g_share, t_share in zip(gpu.shares_of(gpu.chips()[0]),
                                    tpu.shares_of(tpu.chips()[0])):
            assert dataclasses.astuple(g_share) == dataclasses.astuple(t_share)


@pytest.mark.parametrize("shares,cores,alloc", [
    (2, 2, ["tpu-1-frac0of2"]),
    (2, 2, ["tpu-2-frac0of2", "tpu-2-frac1of2"]),
    (2, 2, ["tpu-2-frac0of2", "tpu-2-frac1of2", "tpu-1-frac0of2"]),
    (2, 132, ["tpu-0-frac1of2"]),
    (2, 132, ["tpu-3-frac1of2", "tpu-0-frac0of2", "tpu-0-frac1of2"]),
    (4, 2, ["tpu-0-frac2of4"]),
    (4, 132, ["tpu-3-frac1of4", "tpu-3-frac3of4"]),
    (3, 132, ["tpu-1-frac2of3"]),
])
def test_shares_env_matches_reference(shares, cores, alloc):
    gpu, tpu = _pair(shares, cores)
    with gpu, tpu:
        env = gpu.allocate_env(alloc)
        assert env == _renamed(tpu.allocate_env(alloc), cores)
        assert (ENV_KUBE_CORE_IDS in env) == (ENV_MPS_THREAD_PERCENTAGE in env)


def test_share_of_an_h100_owns_half_its_sms():
    with GpuDeviceManager(load_config(env=_env(2, 132))) as m:
        env0, env1 = (m.allocate_env([f"tpu-0-frac{k}of2"]) for k in range(2))
    assert env0[ENV_KUBE_CORE_IDS] == "0:" + "+".join(map(str, range(66)))
    assert env1[ENV_KUBE_CORE_IDS] == "0:" + "+".join(map(str, range(66, 132)))
    assert env0[ENV_MPS_THREAD_PERCENTAGE] == env1[ENV_MPS_THREAD_PERCENTAGE] == "50"
    assert env0[ENV_MEM_FRACTION] == "0.5000"
    assert not any(k.startswith(("TPU_VISIBLE", "XLA_")) for k in env0)


@pytest.mark.parametrize("ids", [
    ["tpu-0"],
    ["tpu-0-frac0of4"],
    ["tpu-0-frac2of2"],
    ["tpu-1-frac0of2"],
    ["tpu-9-frac0of2"],
    ["tpu-0-frac0of2", "tpu-0-frac0of2"],
    ["gpu-0-frac0of2"],
    [],
])
def test_shares_refusals_match_reference(ids):
    gpu, tpu = _pair()
    with gpu, tpu:
        gpu.inject_fault(1)
        tpu.inject_fault(1)
        with pytest.raises(DeviceError) as ge:
            gpu.allocate_env(ids)
        with pytest.raises(RefDeviceError) as te:
            tpu.allocate_env(ids)
        assert str(ge.value) == str(te.value)
        gpu.allocate_env(["tpu-0-frac1of2"])  # healthy shares still allocatable


# the reference's test_device.py cases: (shares, faults, available,
# required, size)
PREFERRED_CASES = {
    "adjacency": (1, [], ["tpu-0", "tpu-1", "tpu-2", "tpu-3"], [], 2),
    "adjacency_required": (1, [], ["tpu-0", "tpu-1", "tpu-2", "tpu-3"], ["tpu-3"], 3),
    "colocates_shares": (2, [], ["tpu-0-frac0of2", "tpu-0-frac1of2",
                                 "tpu-1-frac0of2", "tpu-1-frac1of2"], [], 2),
    "skips_unhealthy": (1, [1], ["tpu-0", "tpu-1", "tpu-2", "tpu-3"], [], 3),
    "too_few_healthy": (1, [1], ["tpu-0", "tpu-1", "tpu-2", "tpu-3"], [], 4),
    "required_unhealthy": (1, [1], ["tpu-0", "tpu-1"], ["tpu-1"], 1),
    "smaller": (1, [], ["tpu-0"], ["tpu-0", "tpu-1"], 1),
    "larger": (1, [], ["tpu-0"], [], 2),
    "not_in_available": (1, [], ["tpu-0"], ["tpu-3"], 1),
}


def _preferred(m, available, required, size):
    try:
        return m.preferred_allocation(available, required, size)
    except (DeviceError, RefDeviceError) as e:
        return f"error: {e}"


@pytest.mark.parametrize("case", sorted(PREFERRED_CASES))
def test_preferred_allocation_matches_reference(case):
    shares, faults, available, required, size = PREFERRED_CASES[case]
    gpu, tpu = _pair(shares)
    with gpu, tpu:
        for i in faults:
            gpu.inject_fault(i)
            tpu.inject_fault(i)
        got = _preferred(gpu, available, required, size)
        assert got == _preferred(tpu, available, required, size)
    if case == "colocates_shares":
        assert {d.split("-frac")[0] for d in got} == {"tpu-0"}


def test_preferred_allocation_random_sweep_matches_reference():
    """Seeded sweep on a 2x2x1 host of a 4x4 mesh: random available and
    required sets (shares or whole GPUs, duplicates and a GPU of another
    host included), sizes, chip faults and downed links (to neighbours on
    and off the host); the port picks what the reference picks, or refuses
    with its message."""
    rng = np.random.default_rng(3)
    outcomes = {"picked": 0, "refused": 0}
    for _ in range(120):
        shares = int(rng.choice([1, 2]))
        gpu, tpu = _pair(shares)
        with gpu, tpu:
            chips = gpu.chips()
            for i in rng.choice(4, size=int(rng.integers(0, 2)), replace=False):
                gpu.inject_fault(int(i))
                tpu.inject_fault(int(i))
            for _ in range(int(rng.integers(0, 3))):
                a = chips[int(rng.integers(4))].coord
                nbrs = gpu.mesh.neighbors(a)
                b = nbrs[int(rng.integers(len(nbrs)))]
                gpu.inject_link_fault(a, b)
                tpu.inject_link_fault(a, b)
            ids = [d for d, _ in gpu.device_list()]
            available = [ids[int(i)] for i in rng.integers(len(ids), size=int(rng.integers(1, len(ids) + 2)))]
            if rng.random() < 0.1:
                available.append("tpu-7" if shares == 1 else "tpu-7-frac0of2")
            uniq = list(dict.fromkeys(available))
            required = [uniq[int(i)] for i in rng.choice(len(uniq), size=int(rng.integers(0, min(2, len(uniq)) + 1)), replace=False)]
            if rng.random() < 0.05:
                required.append(ids[0] if ids[0] not in uniq else "tpu-5")
            size = int(rng.integers(0, len(uniq) + 2))
            got = _preferred(gpu, available, required, size)
            assert got == _preferred(tpu, available, required, size), (
                available, required, size)
            outcomes["refused" if isinstance(got, str) else "picked"] += 1
    assert min(outcomes.values()) > 20, outcomes


def test_telemetry_snapshot_matches_reference():
    gpu, tpu = _pair(1)
    with gpu, tpu:
        c0, c1 = gpu.chips()[:2]
        for m in (gpu, tpu):
            m.inject_link_fault(c0.coord, c1.coord)
            m.inject_link_fault(c0.coord, (c0.coord[0], c0.coord[1] + 1, 0))
            m.inject_fault(3)
        for tick in range(5):
            if tick == 3:
                gpu.inject_link_fault(c0.coord, c1.coord, up=True)
                tpu.inject_link_fault(c0.coord, c1.coord, up=True)
            got, want = gpu.telemetry_snapshot(), tpu.telemetry_snapshot()
            assert [(dataclasses.astuple(t), t.state) for t in got] == [
                (dataclasses.astuple(t), t.state) for t in want]
        assert got[0].ici_link_errors == 2 * 3 + 2 and got[0].links_down == 1
        assert got[3].state == "unhealthy" and got[3].hbm_used_bytes == 0


# -- the real backend, against the NVML stub ---------------------------------

@pytest.fixture(scope="module")
def nvml_stub(tmp_path_factory):
    out = tmp_path_factory.mktemp("nvml_stub") / "libnvidia-ml.so.1"
    return compile_shared(STUB_SRC, str(out))


@pytest.fixture
def stub_env(monkeypatch):
    for k in ("NVML_STUB_NAME", "NVML_STUB_FAIL_INIT", "NVML_STUB_LOST",
              "NVML_STUB_NO_EVENTS", "NVML_STUB_MEM_USED", "NVML_STUB_UTIL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NVML_STUB_COUNT", "4")
    monkeypatch.setenv("NVML_STUB_MEM", str(85520809984))
    return monkeypatch


def test_real_backend_shares_on_the_nvml_stub(nvml_stub, stub_env):
    cfg = load_config(env={"TPUKUBE_NVML_PATH": nvml_stub,
                           "TPUKUBE_SHARES_PER_CHIP": "2"})
    with GpuDeviceManager(cfg, host="gpu-node-3") as m:
        assert m.resource_name == "qiniu.com/vtpu"
        assert [d for d, h in m.device_list()][:3] == [
            "tpu-0-frac0of2", "tpu-0-frac1of2", "tpu-1-frac0of2"]
        env = m.allocate_env(["tpu-2-frac1of2"])
        assert env["TPU_HBM_LIMIT_BYTES"] == str(85520809984 // 2)
        assert env[ENV_MEM_FRACTION] == "0.5000"
        assert env[ENV_KUBE_CORE_IDS] == "2:" + "+".join(map(str, range(66, 132)))
        assert env[ENV_MPS_THREAD_PERCENTAGE] == "50"
        with pytest.raises(DeviceError, match="share does not match"):
            m.allocate_env(["tpu-0-frac2of2"])
        # two shares of one GPU first, then any GPU of the host
        avail = ["tpu-3-frac0of2", "tpu-0-frac0of2", "tpu-3-frac1of2"]
        assert m.preferred_allocation(avail, [], 2) == ["tpu-3-frac0of2", "tpu-3-frac1of2"]


def test_real_backend_gpus_are_all_to_all(nvml_stub, stub_env):
    # on a line, tpu-1 (a neighbour of tpu-0) would win; NVSwitch joins
    # tpu-0 and tpu-3 as well, so the list order decides
    with GpuDeviceManager(load_config(env={"TPUKUBE_NVML_PATH": nvml_stub})) as m:
        assert m.preferred_allocation(["tpu-0", "tpu-3", "tpu-1"], ["tpu-0"], 2) == [
            "tpu-0", "tpu-3"]
    sim = _env(1, extra={"TPUKUBE_SIM_MESH_DIMS": "4,1,1",
                         "TPUKUBE_SIM_HOST_BLOCK": "4,1,1"})
    with GpuDeviceManager(load_config(env=sim)) as m:
        assert m.preferred_allocation(["tpu-0", "tpu-3", "tpu-1"], ["tpu-0"], 2) == [
            "tpu-0", "tpu-1"]


def test_real_backend_telemetry_reads_nvml(nvml_stub, stub_env):
    stub_env.setenv("NVML_STUB_MEM_USED", str(40 << 30))
    stub_env.setenv("NVML_STUB_UTIL", "87")
    with GpuDeviceManager(load_config(env={"TPUKUBE_NVML_PATH": nvml_stub})) as m:
        tel = m.telemetry_snapshot()
        assert [t.device_id for t in tel] == ["tpu-0", "tpu-1", "tpu-2", "tpu-3"]
        assert all(t.hbm_used_bytes == 40 << 30 and t.duty_cycle_percent == 87.0
                   and t.hbm_total_bytes == 85520809984 and t.state == "healthy"
                   for t in tel)
        stub_env.setenv("NVML_STUB_LOST", "2")
        assert m.probe() is False and "GPU 2" in m.probe_report()
        tel = m.telemetry_snapshot()  # a lost GPU is reported, not read
        assert tel[2].state == "unhealthy" and tel[2].hbm_used_bytes == 0
        assert tel[1].duty_cycle_percent == 87.0


# -- the pod side of a share's env -------------------------------------------

def test_pod_env_reads_the_memory_fraction(monkeypatch):
    with GpuDeviceManager(load_config(env=_env(2))) as m:
        share, whole = m.allocate_env(["tpu-0-frac1of2"]), None
    with GpuDeviceManager(load_config(env=_env(1))) as m:
        whole = m.allocate_env(["tpu-0"])
    assert PodGpuEnv.from_env(share).mem_fraction == 0.5
    assert PodGpuEnv.from_env(whole).mem_fraction is None
    assert PodGpuEnv.from_env({**share, ENV_MEM_FRACTION: "0.2500"}).mem_fraction == 0.25

    # device_from_alloc_env hands the fraction to PyTorch's allocator
    caps = []
    monkeypatch.setenv(ENV_VISIBLE_DEVICES, "0")
    monkeypatch.setenv(ENV_DEVICE_ORDER, "PCI_BUS_ID")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, d: caps.append((f, d)))
    assert device_from_alloc_env(share) == torch.device("cuda:0")
    assert caps == [(0.5, torch.device("cuda:0"))]
    device_from_alloc_env(whole)
    assert len(caps) == 1


def test_shares_health_follows_the_gpu():
    with GpuDeviceManager(load_config(env=_env(2))) as m:
        m.inject_fault(2)
        health = m.health_snapshot()
    assert health["tpu-2-frac0of2"] is health["tpu-2-frac1of2"] is Health.UNHEALTHY
    assert health["tpu-1-frac1of2"] is Health.HEALTHY
