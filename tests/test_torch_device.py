"""Port's device manager (tpukube_torch/device/gpu.py) against the
reference TpuDeviceManager on the same sim config: the same devices, the
same node info, the same Allocate env up to the documented key rename
(TPU_VISIBLE_DEVICES -> CUDA_VISIBLE_DEVICES, plus CUDA_DEVICE_ORDER), and
the same refusals with the same messages."""

import dataclasses
import os

import pytest

from tpukube.core.config import load_config as ref_load_config
from tpukube.device import DeviceError as RefDeviceError
from tpukube.device import TpuDeviceManager
from tpukube_torch.core.config import GpuKubeConfig, load_config
from tpukube_torch.device import DeviceError, GpuDeviceManager
from tpukube_torch.device.gpu import (
    ENV_DEVICE_ORDER,
    ENV_HBM_LIMIT,
    ENV_KUBE_CHIP_COORDS,
    ENV_KUBE_MESH_DIMS,
    ENV_VISIBLE_DEVICES,
)
from tpukube_torch.native.gpuinfo import compile_shared
from torch_refnative import use_private_tpuinfo

use_private_tpuinfo()

HBM = 16 << 30

# (env overlay, host, allocation) — the reference's test_device geometry,
# another host of it, and a torus whose host block is pinned by origin
CASES = {
    "host0": ({"TPUKUBE_SIM_MESH_DIMS": "4,4,1",
               "TPUKUBE_SIM_HOST_BLOCK": "2,2,1"},
              "host-0-0-0", ["tpu-2", "tpu-0"]),
    "host11": ({"TPUKUBE_SIM_MESH_DIMS": "4,4,1",
                "TPUKUBE_SIM_HOST_BLOCK": "2,2,1"},
               "host-1-1-0", ["tpu-3"]),
    "torus_origin": ({"TPUKUBE_SIM_MESH_DIMS": "8,1,1",
                      "TPUKUBE_SIM_HOST_BLOCK": "4,1,1",
                      "TPUKUBE_SIM_TORUS": "1,0,0",
                      "TPUKUBE_SIM_HOST_ORIGIN": "4,0,0",
                      "TPUKUBE_SLICE_ID": "slice-b"},
                     "slice-b-node-1", ["tpu-1", "tpu-3", "tpu-2"]),
}


def _env(extra=None):
    return {
        "TPUKUBE_BACKEND": "sim",
        "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
        "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
        "TPUKUBE_HBM_BYTES_PER_CHIP": str(HBM),
        "TPUKUBE_CORES_PER_CHIP": "2",
        **(extra or {}),
    }


def _pair(extra=None, host="host-0-0-0"):
    env = _env(extra)
    return (GpuDeviceManager(load_config(env=env), host=host),
            TpuDeviceManager(ref_load_config(env=env), host=host))


def _node_rows(info):
    return (
        info.name,
        [(c.chip_id, c.index, tuple(c.coord), c.hbm_bytes, c.num_cores,
          c.health.value) for c in info.chips],
        info.shares_per_chip,
        [tuple(map(tuple, link)) for link in info.bad_links],
        info.slice_id,
        info.source,
    )


def _renamed(ref_env):
    out = dict(ref_env)
    out[ENV_VISIBLE_DEVICES] = out.pop("TPU_VISIBLE_DEVICES")
    out[ENV_DEVICE_ORDER] = "PCI_BUS_ID"
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_sim_manager_matches_reference(case):
    extra, host, alloc = CASES[case]
    gpu, tpu = _pair(extra, host)
    with gpu, tpu:
        assert dataclasses.astuple(gpu.mesh) == dataclasses.astuple(tpu.mesh)
        assert gpu.inventory_source() == tpu.inventory_source() == "sim"
        assert [(d, h.value) for d, h in gpu.device_list()] == [
            (d, h.value) for d, h in tpu.device_list()
        ]
        assert _node_rows(gpu.node_info()) == _node_rows(tpu.node_info())
        assert gpu.allocate_env(alloc) == _renamed(tpu.allocate_env(alloc))

        # faults seen the same way: an unhealthy chip, a downed link
        chips = gpu.chips()
        for m in (gpu, tpu):
            m.inject_fault(chips[-1].index)
            m.inject_link_fault(chips[0].coord, chips[1].coord)
        assert gpu.probe() and tpu.probe()
        assert {d: h.value for d, h in gpu.health_snapshot().items()} == {
            d: h.value for d, h in tpu.health_snapshot().items()
        }
        assert _node_rows(gpu.node_info()) == _node_rows(tpu.node_info())
        assert gpu.link_faults() == tpu.link_faults()


def test_allocate_env_whole_gpus():
    # twin of tests/test_device.py test_allocate_env_whole_chips
    with GpuDeviceManager(load_config(env=_env())) as m:
        env = m.allocate_env(["tpu-2", "tpu-0"])
        assert env[ENV_VISIBLE_DEVICES] == "0,2"
        assert env[ENV_DEVICE_ORDER] == "PCI_BUS_ID"
        assert env[ENV_KUBE_MESH_DIMS] == "4,4,1"
        assert env[ENV_HBM_LIMIT] == str(2 * HBM)
        assert env[ENV_KUBE_CHIP_COORDS] == "0,0,0;0,1,0"
        assert not any(k.startswith("TPU_VISIBLE") for k in env)


@pytest.mark.parametrize("ids,match", [
    (["tpu-0-frac0of2"], "vTPU id rejected"),
    (["gpu-0"], "malformed"),
    (["tpu-0", "tpu-0"], "duplicate"),
    ([], "empty"),
    (["tpu-9"], "unknown chip"),
    (["tpu-1"], "unhealthy"),
])
def test_allocate_refusals_match_reference(ids, match):
    # twins of tests/test_device.py's whole-chip error cases, with the
    # reference's messages word for word
    gpu, tpu = _pair()
    with gpu, tpu:
        gpu.inject_fault(1)
        tpu.inject_fault(1)
        with pytest.raises(DeviceError, match=match) as ge:
            gpu.allocate_env(ids)
        with pytest.raises(RefDeviceError) as te:
            tpu.allocate_env(ids)
        assert str(ge.value) == str(te.value)
        gpu.allocate_env(["tpu-0"])  # healthy chips still allocatable


def test_vgpu_sharing_is_refused():
    """A shares config, once refused outright, now builds and advertises
    shares; what vGPU mode refuses is a whole-GPU id and a share of
    another size."""
    with GpuDeviceManager(load_config(env=_env({"TPUKUBE_SHARES_PER_CHIP": "2"}))) as m:
        assert m.resource_name == "qiniu.com/vtpu"
        assert [d for d, _ in m.device_list()] == [
            f"tpu-{i}-frac{k}of2" for i in range(4) for k in range(2)]
        assert m.allocate_env(["tpu-1-frac1of2"])[ENV_HBM_LIMIT] == str(HBM // 2)
        with pytest.raises(DeviceError, match="whole-chip id rejected"):
            m.allocate_env(["tpu-1"])
        with pytest.raises(DeviceError, match="share does not match"):
            m.allocate_env(["tpu-1-frac0of4"])


def test_config_defaults_and_env_overlay():
    cfg = load_config(env={})
    assert cfg == GpuKubeConfig()
    assert cfg.backend == "real"  # the node agent runs on its GPUs by default
    cfg = load_config(env=_env({"TPUKUBE_SIM_TORUS": "true,0,yes",
                                "TPUKUBE_SLICE_ID": "nvl-2"}))
    assert cfg.sim_mesh_dims == (4, 4, 1) and cfg.sim_torus == (True, False, True)
    assert cfg.hbm_bytes_per_chip == HBM and cfg.slice_id == "nvl-2"
    # the fields both packages have read the same env the same way
    ref = ref_load_config(env=_env())
    port = load_config(env=_env())
    for f in dataclasses.fields(port):
        if hasattr(ref, f.name) and f.name != "backend":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert cfg.probe_mode == "" and load_config(
        env={"TPUKUBE_PROBE_MODE": "liveness"}).probe_mode == "liveness"
    for bad in ({"TPUKUBE_SHARES_PER_CHIP": "0"}, {"TPUKUBE_BACKEND": "pjrt"},
                {"TPUKUBE_PROBE_MODE": "client"}, {"TPUKUBE_PROBE_MODE": "nvml"},
                {"TPUKUBE_SIM_HOST_ORIGIN": "1,2"}, {"TPUKUBE_SLICE_ID": ""},
                {"TPUKUBE_SIM_MESH_DIMS": "4,4"}):
        with pytest.raises(ValueError):
            load_config(env=bad)


def test_real_backend_manager_against_nvml_stub(tmp_path, monkeypatch):
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tpukube_torch", "native", "nvml_stub.cpp")
    stub = compile_shared(src, str(tmp_path / "libnvidia-ml.so.1"))
    for k in ("NVML_STUB_NAME", "NVML_STUB_FAIL_INIT", "NVML_STUB_LOST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NVML_STUB_COUNT", "2")
    monkeypatch.setenv("NVML_STUB_MEM", str(80 << 30))
    with GpuDeviceManager(load_config(env={"TPUKUBE_NVML_PATH": stub}),
                          host="gpu-node-7") as m:
        assert m.inventory_source() == "nvml"
        assert m.node_info().source == "nvml"
        assert [d for d, _ in m.device_list()] == ["tpu-0", "tpu-1"]
        env = m.allocate_env(["tpu-1"])
        assert env[ENV_VISIBLE_DEVICES] == "1"
        assert env[ENV_KUBE_CHIP_COORDS] == "1,0,0"
        assert env[ENV_KUBE_MESH_DIMS] == "2,1,1"
        assert env[ENV_HBM_LIMIT] == str(80 << 30)
        assert m.probe() is True
        monkeypatch.setenv("NVML_STUB_LOST", "1")
        assert m.probe() is False
        with pytest.raises(DeviceError, match="tpu-1 is unhealthy"):
            m.allocate_env(["tpu-1"])
