"""The port's dryrun_multichip (tpukube_torch/graft.py) on gloo ranks, and
its env → DeviceMesh policy (tpukube_torch/workload/meshenv.py) against
the reference's mesh_from_alloc_env on the 8-device CPU mesh.

Leg 2 of the dry run gets the DCN gang env that the reference's control
plane mints (``__graft_entry__._mint_dcn_gang_env``), with the
visible-devices key named as the port's node agent names it."""

import functools

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from tpukube.workload import meshenv as ref
from tpukube_torch import graft
from tpukube_torch.workload.meshenv import (
    PodGpuEnv,
    box_shape,
    mesh_axes_from_box,
    mesh_shape_from_alloc_env,
)
from test_torch_train import port_env

BOX_ENV = {
    "TPU_VISIBLE_DEVICES": "0,1,2,3",
    "TPU_KUBE_DEVICE_IDS": "tpu-0,tpu-1,tpu-2,tpu-3",
    "TPU_KUBE_CHIP_COORDS": "0,0,0;1,0,0;0,1,0;1,1,0",
    "TPU_KUBE_MESH_DIMS": "4,4,1",
    "TPU_KUBE_HOST": "host-0-0-0",
    "TPU_HBM_LIMIT_BYTES": "1000",
}
DCN_ENV = {
    "TPU_VISIBLE_DEVICES": "0",
    "TPU_KUBE_DEVICE_IDS": "tpu-0",
    "TPU_KUBE_CHIP_COORDS": "0,0,0",
    "TPU_KUBE_MESH_DIMS": "4,4,1",
    "TPU_KUBE_SLICE_ID": "slice-b",
    "TPU_KUBE_GANG_NUM_SLICES": "2",
    "TPU_KUBE_GANG_SLICES": "slice-a,slice-b",
    "TPU_KUBE_GANG_SLICE_INDEX": "1",
}


@functools.lru_cache(maxsize=None)
def minted_env() -> dict:
    return port_env(ref_entry._mint_dcn_gang_env())


@functools.lru_cache(maxsize=None)
def dryrun(n: int) -> dict:
    return graft.dryrun_multichip(n, device="cpu", gang_env=minted_env())


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_on_cpu(n):
    # twin of tests/test_workload.py test_graft_dryrun_multichip
    out = dryrun(n)
    tp = 2
    assert out["leg1"]["axes"] == ["dp", "tp"] and out["leg1"]["shape"] == [n // tp, tp]
    assert out["leg2"]["axes"] == ["dcn", "dp", "tp"]
    assert out["leg2"]["shape"] == [2, n // 2 // tp, tp]
    assert np.isfinite(out["leg1"]["loss"]) and np.isfinite(out["leg2"]["loss"])


def test_dryrun_says_why_it_skips_the_dcn_leg(monkeypatch, capsys):
    monkeypatch.setattr(graft, "run_ranks", lambda fn, n, backend, args: [{"args": args}])
    assert graft.dryrun_multichip(4, device="cpu") == {"args": (4, None)}
    assert "no gang env" in capsys.readouterr().out
    assert graft.dryrun_multichip(2, device="cpu", gang_env=DCN_ENV) == {"args": (2, None)}
    assert "not an even count >= 4" in capsys.readouterr().out


def test_dryrun_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.dryrun_multichip(4)


def test_dryrun_needs_a_gpu_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="dryrun over 2 GPUs, CUDA sees 1"):
        graft.dryrun_multichip(2)


def _ref_mesh(env, n, tp):
    mesh, pe = ref.mesh_from_alloc_env(env, devices=jax.devices()[:n], tp=tp)
    return tuple(mesh.axis_names), tuple(mesh.devices.shape), pe


@pytest.mark.parametrize("env,n,tp", [
    (BOX_ENV, 4, None),   # the box's longest axis rides tp
    (BOX_ENV, 4, 4),      # a pinned tp
    (BOX_ENV, 8, None),   # more ranks than chips: the box decides
    (BOX_ENV, 2, None),   # a dry run on fewer ranks folds onto them
    (BOX_ENV, 3, None),
    (DCN_ENV, 8, 2),      # a DCN gang: ("dcn", "dp", "tp")
    (DCN_ENV, 4, None),
])
def test_mesh_policy_matches_reference(env, n, tp):
    names, shape, pe = mesh_shape_from_alloc_env(port_env(env), n, tp)
    ref_names, ref_shape, ref_pe = _ref_mesh(env, n, tp)
    assert (names, shape) == (ref_names, ref_shape)
    assert pe.spans_dcn == ref_pe.spans_dcn


@pytest.mark.parametrize("env,n,tp", [(DCN_ENV, 7, None), (BOX_ENV, 2, 4)])
def test_mesh_policy_refuses_what_the_reference_refuses(env, n, tp):
    # twin of the ValueError in tests/test_dcn_gang.py
    # test_mesh_from_alloc_env_builds_dcn_mesh, plus a pinned tp that
    # cannot divide the folded ranks
    with pytest.raises(ValueError, match="divide"):
        _ref_mesh(env, n, tp)
    with pytest.raises(ValueError, match="divide"):
        mesh_shape_from_alloc_env(port_env(env), n, tp)


def test_mesh_env_bridge():
    # twin of tests/test_workload.py test_mesh_env_bridge
    pe = PodGpuEnv.from_env(port_env(BOX_ENV))
    assert pe.visible_chips == (0, 1, 2, 3)
    assert box_shape(pe.coords) == (2, 2, 1)
    dp, tp = mesh_axes_from_box(box_shape(pe.coords))
    assert dp * tp == 4 and tp == 2


def test_box_shape_rejects_non_contiguous():
    # twin of tests/test_workload.py test_box_shape_rejects_non_contiguous
    with pytest.raises(ValueError):
        box_shape([(0, 0, 0), (2, 0, 0)])
    with pytest.raises(ValueError):
        box_shape([(0, 0, 0), (1, 1, 0)])


def test_pod_env_gang_slice_context():
    # twin of tests/test_resnet.py test_pod_env_gang_slice_context
    env = port_env(DCN_ENV)
    pe = PodGpuEnv.from_env(env)
    assert pe.spans_dcn and pe.slice_id == "slice-b"
    assert pe.gang_slices == ("slice-a", "slice-b") and pe.gang_slice_index == 1
    for k in ("TPU_KUBE_GANG_NUM_SLICES", "TPU_KUBE_GANG_SLICES", "TPU_KUBE_GANG_SLICE_INDEX"):
        env.pop(k)
    pe2 = PodGpuEnv.from_env(env)
    assert not pe2.spans_dcn and pe2.gang_num_slices == 1


def test_minted_gang_env_reads_as_the_reference_reads_it():
    env = ref_entry._mint_dcn_gang_env()
    pe, ref_pe = PodGpuEnv.from_env(port_env(env)), ref.PodTpuEnv.from_env(env)
    assert pe.spans_dcn and pe.gang_num_slices == ref_pe.gang_num_slices == 2
    assert (pe.gang_slices, pe.gang_slice_index) == (ref_pe.gang_slices, ref_pe.gang_slice_index)
