"""The port's whole slice on the CPU, against the reference's: sim node
agent -> Allocate env -> in-pod env -> Llama forward. Plus the port's
import hygiene (no JAX, nothing of tpukube, none of the control plane's
dependencies the GPU machines lack) and its refusal to run on the CPU by
default."""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukube.core.config import load_config as ref_load_config
from tpukube.device import TpuDeviceManager
from tpukube.workload import llama as ref
from tpukube.workload.meshenv import PodTpuEnv
from tpukube.workload.meshenv import box_shape as ref_box_shape
from tpukube.workload.meshenv import mesh_axes_from_box as ref_mesh_axes
from tpukube_torch import graft
from tpukube_torch.core.config import load_config
from tpukube_torch.device import GpuDeviceManager
from tpukube_torch.workload import llama as port
from tpukube_torch.workload.meshenv import (
    PodGpuEnv,
    box_shape,
    device_from_alloc_env,
    mesh_axes_from_box,
)
from torch_refnative import use_private_tpuinfo

use_private_tpuinfo()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SIM_ENV = {
    "TPUKUBE_BACKEND": "sim",
    "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    "TPUKUBE_HBM_BYTES_PER_CHIP": str(16 << 30),
}
CFG = ref.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=64, max_seq=16)


def _np_params(cfg, rng):
    tree = jax.eval_shape(lambda: ref.init_params(jax.random.PRNGKey(0), cfg))
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32), tree)


def test_slice_matches_reference_end_to_end():
    alloc = ["tpu-3", "tpu-1"]
    with TpuDeviceManager(ref_load_config(env=SIM_ENV), host="host-1-0-0") as tm:
        ref_env = tm.allocate_env(alloc)
    with GpuDeviceManager(load_config(env=SIM_ENV), host="host-1-0-0") as gm:
        env = gm.allocate_env(alloc)

    ref_pe, pe = PodTpuEnv.from_env(ref_env), PodGpuEnv.from_env(env)
    # the port's one field more: a share's memory fraction, none for whole GPUs
    assert pe.mem_fraction is None
    assert {k: v for k, v in dataclasses.asdict(pe).items() if k != "mem_fraction"} == (
        dataclasses.asdict(ref_pe))
    assert box_shape(pe.coords) == ref_box_shape(ref_pe.coords) == (1, 2, 1)
    assert mesh_axes_from_box(box_shape(pe.coords)) == ref_mesh_axes(
        ref_box_shape(ref_pe.coords))

    rng = np.random.default_rng(7)
    np_params = _np_params(CFG, rng)
    tokens = rng.integers(0, CFG.vocab, (2, CFG.max_seq), dtype=np.int32)
    want = np.asarray(ref.forward(jax.tree.map(jnp.asarray, np_params),
                                  jnp.asarray(tokens), CFG))
    got = port.forward(port.params_from_numpy(np_params, CPU),
                       torch.from_numpy(tokens),
                       port.LlamaConfig(**dataclasses.asdict(CFG))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def test_pod_env_rejects_missing_keys_and_mismatched_process(monkeypatch):
    with pytest.raises(RuntimeError, match="not running under a tpukube allocation"):
        PodGpuEnv.from_env({"CUDA_VISIBLE_DEVICES": "0"})
    with GpuDeviceManager(load_config(env=SIM_ENV)) as gm:
        env = gm.allocate_env(["tpu-0"])
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")
    monkeypatch.setenv("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    with pytest.raises(RuntimeError, match="not the allocation's"):
        device_from_alloc_env(env)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_from_alloc_env(env)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="CUDA sees 2 devices"):
        device_from_alloc_env(env)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert device_from_alloc_env(env) == torch.device("cuda:0")


def test_pod_serve_at_tiny_size_on_cpu():
    # the pod's body, as chip_smoke.py runs it at Llama-3-8B width on the
    # card, here at a tiny config on the CPU
    cfg = port.LlamaConfig(**dataclasses.asdict(CFG))
    out = graft.serve(cfg, CPU, seed=0, requests=3, batch=2, seq=CFG.max_seq,
                      parity_layers=1, parity_seq=8)
    assert len(out["forward_ms"]) == 3 and out["tokens_per_s"] > 0
    assert abs(out["loss"] - out["ln_vocab"]) < 1.0
    assert out["parity_max_abs_err"] == 0.0  # CPU against itself
    assert out["max_memory_allocated"] is None


def test_serve_waits_on_warm_before_its_timed_requests(monkeypatch):
    # the shared pod's ready/go handshake sits between warm-up and timing:
    # no timed request may start before on_warm() returns
    cfg = port.LlamaConfig(**dataclasses.asdict(CFG))
    events = []
    forward = port.Llama.forward

    def counted(self, tokens):
        events.append("forward")
        return forward(self, tokens)

    monkeypatch.setattr(port.Llama, "forward", counted)
    out = graft.serve(cfg, CPU, seed=0, requests=2, batch=1, seq=CFG.max_seq,
                      parity_layers=1, parity_seq=8,
                      on_warm=lambda: events.append("warm"))
    assert events[:4] == ["forward", "warm", "forward", "forward"]
    assert out["batch"] == 1 and len(out["forward_ms"]) == 2


def test_forward_flops_counts_what_torch_counts():
    # the compute bound chip_smoke.py prints rests on this count
    from torch.utils.flop_counter import FlopCounterMode

    cfg = port.LlamaConfig(**dataclasses.asdict(CFG))
    params = port.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    tokens = torch.zeros((2, 12), dtype=torch.int64)
    with FlopCounterMode(display=False) as counter:
        port.forward(params, tokens, cfg)
    assert counter.get_total_flops() == graft.forward_flops(cfg, 2, 12)


def _import_targets(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_tpukube():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(REPO, "tpukube_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for new in ("workload/tp.py", "workload/train.py", "workload/resnet.py",
                "native/cudaguard.py", "obs/health.py", "apiserver.py",
                "metrics.py", "sched/policy.py", "core/retry.py"):
        assert os.path.join(REPO, "tpukube_torch", *new.split("/")) in paths
    for p in paths:
        for mod in _import_targets(p):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpukube", "flax", "optax"), (p, mod)


def test_port_pulls_in_no_control_plane_dependency():
    code = (
        "import json, sys\n"
        "import tpukube_torch.device, tpukube_torch.native, "
        "tpukube_torch.workload, tpukube_torch.graft\n"
        "import tpukube_torch.workload.tp, tpukube_torch.workload.train, "
        "tpukube_torch.workload.resnet, tpukube_torch.workload.meshenv\n"
        "import tpukube_torch.native.cudaguard, tpukube_torch.obs.health\n"
        "import tpukube_torch.sched, tpukube_torch.sched.extender, "
        "tpukube_torch.sched.client, tpukube_torch.sim\n"
        "import tpukube_torch.apiserver, tpukube_torch.metrics, "
        "tpukube_torch.sched.policy, tpukube_torch.core.retry\n"
        "import tpukube_torch.plugin, tpukube_torch.plugin.server, "
        "tpukube_torch.plugin.proto.deviceplugin, tpukube_torch.plugin.fake_kubelet\n"
        "bad = ('yaml', 'grpc', 'google.protobuf', 'aiohttp', 'jax', 'jaxlib', 'optax', "
        "'tpukube')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m in bad "
        "or m.startswith(('jax.', 'tpukube.', 'grpc.', 'yaml.', 'google.protobuf.')))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                          capture_output=True, text=True, timeout=120)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_plugin_loads_grpc_only_in_its_grpc_transport():
    # the device plugin's whole in-process path (the card's: Register ->
    # ListAndWatch -> Allocate, metrics, telemetry) loads no grpc, no
    # protobuf, no jax and nothing of tpukube; plugin.stubs brings grpc
    code = (
        "import json, sys, tempfile\n"
        "from tpukube_torch.core.config import load_config\n"
        "from tpukube_torch.device import GpuDeviceManager\n"
        "from tpukube_torch.metrics import render_plugin_metrics\n"
        "from tpukube_torch.obs.health import HealthSampler\n"
        "from tpukube_torch.plugin import DevicePluginServer, InProcessKubelet\n"
        "cfg = load_config(env={'TPUKUBE_BACKEND': 'sim', "
        "'TPUKUBE_DEVICE_PLUGIN_DIR': tempfile.mkdtemp()})\n"
        "with InProcessKubelet() as k, GpuDeviceManager(cfg) as dev:\n"
        "    s = DevicePluginServer(cfg, dev)\n"
        "    k.register_plugin(s)\n"
        "    k.wait_for_devices(s.resource_name, 8)\n"
        "    env = k.allocate(s.resource_name, ['tpu-0'])\n"
        "    sampler = HealthSampler(dev, poll_seconds=999)\n"
        "    sampler.check_once()\n"
        "    render_plugin_metrics(s, sampler=sampler)\n"
        "def bad():\n"
        "    return sorted(m for m in sys.modules if m.split('.')[0] in "
        "('grpc', 'jax', 'tpukube') or m.startswith('google.protobuf'))\n"
        "before = bad()\n"
        "import tpukube_torch.plugin.stubs\n"
        "print(json.dumps([env['CUDA_VISIBLE_DEVICES'], before, 'grpc' in bad()]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                          capture_output=True, text=True, timeout=120)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == ["0", [], True]


def test_scheduler_is_host_code_without_torch():
    # the extender, gang, slicefit and sim fleet import numpy, never torch
    code = (
        "import json, sys\n"
        "import tpukube_torch.sched.extender, tpukube_torch.sched.client, "
        "tpukube_torch.sim, tpukube_torch.trace, tpukube_torch.obs.events, "
        "tpukube_torch.core.clock, tpukube_torch.apiserver, tpukube_torch.metrics, "
        "tpukube_torch.sched.policy, tpukube_torch.core.retry\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'tpukube', 'aiohttp', 'grpc', 'yaml'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                          capture_output=True, text=True, timeout=120)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    # here there is no CUDA device: non-zero exit, no result line
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    # alone in a directory: non-zero exit, no result line
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_breakdown_sorts_kernels_by_kind_and_needs_the_card(monkeypatch):
    # the measurement script behind PERF.md's step breakdown: kernel names
    # map to kinds, and without CUDA it exits non-zero, measuring nothing
    from tpukube_torch import breakdown

    assert breakdown._kind("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "nccl"
    assert breakdown._kind("sm90_xmma_fprop_implicit_gemm_bf16bf16") == "convolution"
    assert breakdown._kind("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT") == "matmul"
    assert breakdown._kind("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel") == "normalization"
    assert breakdown._kind("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>") == "copy/cast"
    assert breakdown._kind("void at::native::vectorized_elementwise_kernel<4, AddFunctor>") == "elementwise"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert breakdown.main() == 1
