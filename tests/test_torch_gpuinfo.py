"""Port's discovery shim (tpukube_torch/native) against the reference.

The sim backend of libgpuinfo is held against libtpuinfo's on the same
spec: chips, links and link faults must agree exactly. The real backend
(NVML) runs against tpukube_torch/native/nvml_stub.cpp, a stand-in
libnvidia-ml built here, configured through NVML_STUB_* env knobs; XID
events are injected through the stub's nvml_stub_inject_xid."""

import dataclasses
import os

import pytest

from tpukube.core.mesh import MeshSpec as RefMeshSpec
from tpukube.native import TpuInfo
from tpukube.native import sim_spec as ref_sim_spec
from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import Health, TopologyCoord
from tpukube_torch.native import GpuInfo, GpuInfoError, sim_spec
from tpukube_torch.native.gpuinfo import compile_shared
from torch_refnative import use_private_tpuinfo

use_private_tpuinfo()

STUB_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tpukube_torch", "native", "nvml_stub.cpp",
)
_STUB_KNOBS = ["NVML_STUB_COUNT", "NVML_STUB_NAME", "NVML_STUB_MEM",
               "NVML_STUB_FAIL_INIT", "NVML_STUB_LOST", "NVML_STUB_NO_EVENTS",
               "NVML_STUB_MEM_USED", "NVML_STUB_UTIL"]

# (dims, host_block, torus, host, origin)
SIM_MESHES = {
    "torus": ((4, 4, 4), (2, 2, 1), (True, True, True), "host-1-0-2", None),
    "mesh": ((4, 4, 1), (2, 2, 1), (False, False, False), "host-0-1-0", None),
    "multi_host_block": ((8, 2, 2), (4, 2, 1), (True, False, False),
                         "slice-a-node-3", (4, 0, 1)),
}


def _chip_rows(chips):
    return [
        (c.chip_id, c.index, tuple(c.coord), c.hbm_bytes, c.num_cores,
         Health(c.health.value))
        for c in chips
    ]


@pytest.mark.parametrize("name", sorted(SIM_MESHES))
def test_sim_matches_reference(name):
    dims, block, torus, host, origin = SIM_MESHES[name]
    spec = sim_spec(MeshSpec(dims, block, torus), host, 24 << 30, 4, origin=origin)
    assert spec == ref_sim_spec(RefMeshSpec(dims, block, torus), host,
                                24 << 30, 4, origin=origin)
    with GpuInfo("sim", spec) as gi, TpuInfo("sim", spec) as ti:
        assert gi.source() == ti.source() == "sim"
        assert dataclasses.astuple(gi.mesh()) == dataclasses.astuple(ti.mesh())
        chips = gi.chips()
        assert _chip_rows(chips) == _chip_rows(ti.chips())
        for c in chips:
            assert gi.links(c.index) == ti.links(c.index)

        # the same injections on both: a chip fault, two link faults (one a
        # torus wrap where the mesh has one), one of them restored
        a = chips[0].coord
        nbrs = gi.links(0)
        for session in (gi, ti):
            session.inject_fault(len(chips) - 1)
            for b in nbrs[:2]:
                session.inject_link_fault(a, b)
            session.inject_link_fault(nbrs[0], a, up=True)
            session.inject_link_fault(nbrs[-1], a)
        assert _chip_rows(gi.chips()) == _chip_rows(ti.chips())
        assert gi.chips()[-1].health is Health.UNHEALTHY
        assert gi.link_faults() == ti.link_faults()
        assert len(gi.link_faults()) >= 1

        # the same refusals
        with pytest.raises(GpuInfoError, match="not mesh-adjacent"):
            gi.inject_link_fault(a, a)
        assert gi.probe() and ti.probe()


def test_sim_rejects_bad_spec_like_reference():
    for bad in ("dims=4,4\n", "bogus=1\n", "host=nope\n", "dims=4,4,4\nhost_block=3,1,1\n"):
        with pytest.raises(GpuInfoError) as ge:
            GpuInfo("sim", bad)
        with pytest.raises(Exception) as te:
            TpuInfo("sim", bad)
        assert str(ge.value) == str(te.value)
    with pytest.raises(GpuInfoError, match="unknown backend"):
        GpuInfo("tpu")


def test_compile_failure_raises_with_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int main( {\n")
    with pytest.raises(GpuInfoError, match="failed to build libbroken.so"):
        compile_shared(str(src), str(tmp_path / "libbroken.so"))
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


# -- real backend against the NVML stub -----------------------------------

@pytest.fixture(scope="module")
def nvml_stub(tmp_path_factory):
    out = tmp_path_factory.mktemp("nvml_stub") / "libnvidia-ml.so.1"
    return compile_shared(STUB_SRC, str(out))


@pytest.fixture(autouse=True)
def clean_stub_env(monkeypatch):
    for k in _STUB_KNOBS:
        monkeypatch.delenv(k, raising=False)


def _real(stub):
    return GpuInfo("real", f"nvml={stub}\n")


def test_nvml_enumeration(nvml_stub, monkeypatch):
    monkeypatch.setenv("NVML_STUB_COUNT", "3")
    monkeypatch.setenv("NVML_STUB_MEM", str(81559 << 20))
    with _real(nvml_stub) as gi:
        assert gi.source() == "nvml"
        assert dataclasses.astuple(gi.mesh()) == (
            (3, 1, 1), (3, 1, 1), (False, False, False))
        chips = gi.chips()
        assert [c.chip_id for c in chips] == [
            f"GPU-57ab0000-0000-4000-8000-{i:012x}" for i in range(3)
        ]
        assert [tuple(c.coord) for c in chips] == [(0, 0, 0), (1, 0, 0), (2, 0, 0)]
        assert all(c.hbm_bytes == 81559 << 20 for c in chips)
        assert all(c.num_cores == 132 for c in chips)
        assert all(c.health is Health.HEALTHY for c in chips)
        assert gi.links(1) == [TopologyCoord(0, 0, 0), TopologyCoord(2, 0, 0)]
        with pytest.raises(GpuInfoError, match="sim-only"):
            gi.inject_fault(0)
        with pytest.raises(GpuInfoError, match="sim-only"):
            gi.inject_link_fault((0, 0, 0), (1, 0, 0))


@pytest.mark.parametrize("name,sms", [
    ("NVIDIA H100 80GB HBM3", 132),
    ("NVIDIA H100 PCIe", 114),
    ("NVIDIA H100 NVL", 132),
    ("NVIDIA H200", 132),
])
def test_nvml_sm_table(nvml_stub, monkeypatch, name, sms):
    monkeypatch.setenv("NVML_STUB_NAME", name)
    with _real(nvml_stub) as gi:
        assert [c.num_cores for c in gi.chips()] == [sms]


def test_nvml_unknown_model_is_an_error(nvml_stub, monkeypatch):
    monkeypatch.setenv("NVML_STUB_NAME", "NVIDIA A100-SXM4-80GB")
    with pytest.raises(GpuInfoError, match="no SM count known .*A100"):
        _real(nvml_stub)


def test_nvml_failures_raise_and_leave_no_session(nvml_stub, monkeypatch, tmp_path):
    monkeypatch.setenv("NVML_STUB_FAIL_INIT", "9")
    with pytest.raises(GpuInfoError, match="nvmlInit_v2 failed: Driver Not Loaded"):
        _real(nvml_stub)
    monkeypatch.delenv("NVML_STUB_FAIL_INIT")
    monkeypatch.setenv("NVML_STUB_COUNT", "0")
    with pytest.raises(GpuInfoError, match="no GPUs"):
        _real(nvml_stub)
    with pytest.raises(GpuInfoError, match="cannot load NVML"):
        GpuInfo("real", f"nvml={tmp_path / 'missing.so'}\n")
    with pytest.raises(GpuInfoError, match="unknown spec key: chips"):
        GpuInfo("real", "chips=2\n")
    monkeypatch.setenv("NVML_STUB_COUNT", "1")
    with _real(nvml_stub) as gi:  # nothing was left initialized
        assert gi.chip_count() == 1


def test_nvml_probe_tracks_lost_gpu(nvml_stub, monkeypatch):
    monkeypatch.setenv("NVML_STUB_COUNT", "2")
    with _real(nvml_stub) as gi:
        assert gi.probe() is True
        monkeypatch.setenv("NVML_STUB_LOST", "1")
        assert gi.probe() is False
        assert [c.health for c in gi.chips()] == [Health.HEALTHY, Health.UNHEALTHY]
        monkeypatch.delenv("NVML_STUB_LOST")
        assert gi.probe() is True
        assert all(c.health is Health.HEALTHY for c in gi.chips())


# -- XID health and telemetry against the NVML stub ------------------------

def _inject_xid(stub, index, xid):
    # the stub's own hook; the same library the session dlopen'ed
    import ctypes

    lib = ctypes.CDLL(stub)
    lib.nvml_stub_inject_xid.argtypes = [ctypes.c_int, ctypes.c_ulonglong]
    assert lib.nvml_stub_inject_xid(index, xid) == 0


def test_nvml_critical_xid_marks_its_gpu_unhealthy_for_good(nvml_stub, monkeypatch):
    monkeypatch.setenv("NVML_STUB_COUNT", "3")
    with _real(nvml_stub) as gi:  # xid is the real backend's default
        assert gi.probe() is True
        _inject_xid(nvml_stub, 1, 79)  # fallen off the bus
        assert gi.probe() is False
        assert "GPU 1: critical XID 79" in gi.last_error()
        assert [c.health for c in gi.chips()] == [
            Health.HEALTHY, Health.UNHEALTHY, Health.HEALTHY]
        # sticky: liveness alone would pass it again
        assert gi.probe() is False
        assert gi.chips()[1].health is Health.UNHEALTHY
        assert "GPU 1: critical XID 79" in gi.last_error()


@pytest.mark.parametrize("xid", [13, 31, 43, 45, 68])
def test_nvml_application_xids_leave_the_gpu_healthy(nvml_stub, monkeypatch, xid):
    monkeypatch.setenv("NVML_STUB_COUNT", "2")
    with _real(nvml_stub) as gi:
        _inject_xid(nvml_stub, 0, xid)
        assert gi.probe() is True
        assert all(c.health is Health.HEALTHY for c in gi.chips())


def test_nvml_unattributed_xid_marks_every_gpu(nvml_stub, monkeypatch):
    monkeypatch.setenv("NVML_STUB_COUNT", "2")
    with _real(nvml_stub) as gi:
        _inject_xid(nvml_stub, -1, 48)
        assert gi.probe() is False
        assert all(c.health is Health.UNHEALTHY for c in gi.chips())


def test_nvml_xid_registration_refused_fails_init_in_xid_mode(nvml_stub, monkeypatch):
    monkeypatch.setenv("NVML_STUB_NO_EVENTS", "1")
    for spec in (f"nvml={nvml_stub}\n", f"nvml={nvml_stub}\nprobe=xid\n"):
        with pytest.raises(GpuInfoError,
                           match=r"nvmlDeviceRegisterEvents failed: Not Supported \(nvmlReturn 3\)"):
            GpuInfo("real", spec)
    for mode in ("liveness", "off"):  # modes that need no events still start
        with GpuInfo("real", f"nvml={nvml_stub}\nprobe={mode}\n") as gi:
            assert gi.probe() is True
    with pytest.raises(GpuInfoError, match="unknown probe mode: client"):
        GpuInfo("real", f"nvml={nvml_stub}\nprobe=client\n")


def test_nvml_liveness_and_off_modes_ignore_xids(nvml_stub, monkeypatch):
    monkeypatch.setenv("NVML_STUB_COUNT", "2")
    with GpuInfo("real", f"nvml={nvml_stub}\nprobe=liveness\n") as gi:
        _inject_xid(nvml_stub, 0, 79)  # no event set is registered
        assert gi.probe() is True
        monkeypatch.setenv("NVML_STUB_LOST", "0")
        assert gi.probe() is False
    monkeypatch.delenv("NVML_STUB_LOST")
    with GpuInfo("real", f"nvml={nvml_stub}\nprobe=off\n") as gi:
        monkeypatch.setenv("NVML_STUB_LOST", "0")
        assert gi.probe() is True  # off: NVML is not asked
        assert all(c.health is Health.HEALTHY for c in gi.chips())


def test_nvml_telemetry(nvml_stub, monkeypatch):
    monkeypatch.setenv("NVML_STUB_COUNT", "2")
    monkeypatch.setenv("NVML_STUB_MEM_USED", str(12345 << 20))
    monkeypatch.setenv("NVML_STUB_UTIL", "64")
    with _real(nvml_stub) as gi:
        assert gi.telemetry(1) == (64, 12345 << 20)
        with pytest.raises(GpuInfoError, match="out of range"):
            gi.telemetry(2)
    with GpuInfo("sim", "dims=2,1,1\nhost_block=2,1,1\n") as gi:
        with pytest.raises(GpuInfoError, match="needs the real backend"):
            gi.telemetry(0)
