"""BASELINE config 2 on the port (twin of tests/test_config2.py): a 4-pod
data-parallel ResNet job, 1 GPU per pod, no topology hint.

The scheduling leg runs on both packages: the 4 replicas are placed by
each package's extender, and each pod's Allocate runs through each
package's device-plugin stack over gRPC unix sockets
(``SimCluster.execute_allocation``); the binds must be equal, each env's
coords the bind's coords, and the port's env the reference's under the
port's names. The in-process transport (the GPU machine's) must give the
same envs, also after a cold restart of the node agent.

The compute leg is the job those pods run: the port's ResNet DP step on 4
gloo ranks (one per replica) against the reference's
``make_dp_train_step`` on 4 CPU devices, with the reference test's TINY
config, seeds and learning rate, weights and batch carried across through
numpy. Both nets compute in float32 (the port's ``COMPUTE_DTYPE`` in the
ranks, the reference's ``jnp.bfloat16`` read as float32), so the 3 losses
are held at 1e-5 · max|ref|, as tests/test_torch_resnet.py holds its
float32 step; and the loss must fall."""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import test_config2
from tpukube.core.config import load_config as ref_load_config
from tpukube.sim import SimCluster as RefSimCluster
from tpukube.workload import resnet as ref_resnet
from tpukube_torch import graft
from tpukube_torch.device.gpu import ENV_KUBE_CHIP_COORDS
from tpukube_torch.sim import SimCluster
from test_torch_plugin import _renamed
from test_torch_tp import resnet_rank
from test_torch_train import in_float32
from torch_refnative import use_private_tpuinfo
from torch_twin import port_load_config, run_twin

use_private_tpuinfo()

CONFIG2_ENV = {
    "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
    "TPUKUBE_HBM_BYTES_PER_CHIP": str(16 << 30),
}
# test_config2's compute leg
RCFG = ref_resnet.ResNetConfig(num_classes=10, width=8, stage_blocks=(1,), groups=4,
                               image_size=8)
LR, STEPS = 0.05, 3


def _coords(env: dict) -> set:
    return {tuple(int(v) for v in part.split(","))
            for part in env[ENV_KUBE_CHIP_COORDS].split(";")}


def _fanout(cluster, restart_agent: bool = False) -> tuple:
    allocs = [cluster.schedule(cluster.make_pod(f"resnet-dp-{i}", tpu=1))[1]
              for i in range(4)]
    util = cluster.utilization()
    envs = [cluster.execute_allocation(a, restart_agent=restart_agent) for a in allocs]
    spans = [e["request"]["name"] for e in cluster.extender.trace.events()
             if e["kind"] == "span"]
    return allocs, util, envs, spans


@pytest.fixture(scope="module")
def reference_fanout():
    with RefSimCluster(ref_load_config(env=CONFIG2_ENV)) as cluster:
        return _fanout(cluster)


@pytest.mark.parametrize("transport,restart", [
    ("grpc", False), ("inprocess", False), ("grpc", True), ("inprocess", True)])
def test_config2_four_pod_dp_job_allocates_as_the_reference(reference_fanout,
                                                            transport, restart):
    ref_allocs, ref_util, ref_envs, ref_spans = reference_fanout
    with SimCluster(port_load_config(env=CONFIG2_ENV), transport=transport) as cluster:
        allocs, util, envs, spans = _fanout(cluster, restart_agent=restart)
    assert util == ref_util == pytest.approx(4 / 16)
    all_coords = [tuple(c) for a in allocs for c in a.coords]
    assert len(all_coords) == len(set(all_coords)) == 4  # no GPU double-booked
    for a, r, env, ref_env in zip(allocs, ref_allocs, envs, ref_envs):
        assert (a.node_name, a.device_ids, [tuple(c) for c in a.coords]) == (
            r.node_name, r.device_ids, [tuple(c) for c in r.coords])
        # env coords are the scheduler's annotation coords, on both sides
        assert _coords(env) == _coords(ref_env) == {tuple(c) for c in a.coords}
        assert env == _renamed(ref_env)
    # the node agent's leg of each pod's timeline: the kubelet took the plan
    assert spans == ref_spans == ["intent_match", "allocate"] * 4


def test_reference_config2_packing_test_holds_on_the_port():
    run_twin(test_config2.test_config2_without_topology_hint_still_packs_tightly)


def _ref_inputs():
    params = jax.tree.map(np.asarray, ref_resnet.init_params(jax.random.PRNGKey(0), RCFG))
    images = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (8, 8, 8, 3)))
    labels = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (8,), 0, 10))
    return params, images, labels


def test_config2_compute_leg_matches_the_reference():
    params, images, labels = _ref_inputs()
    # the reference's step on 4 CPU devices, float32
    mesh = Mesh(np.asarray(jax.devices("cpu")[:4]), ("dp",))
    step = ref_resnet.make_dp_train_step(RCFG, mesh, learning_rate=LR)
    p = jax.tree.map(jax.numpy.array, params)
    want = []
    for _ in range(STEPS):
        p, loss = in_float32(ref_resnet, step, p, images, labels)
        want.append(float(loss))
    # the port's on 4 gloo ranks, one per replica
    case = {"cfg": dataclasses.asdict(RCFG), "params": params, "mesh": {"dp": 4, "tp": 1},
            "runs": {"job": {"lr": LR, "steps": STEPS, "images": images,
                             "labels": labels, "f32": True}}}
    got = graft.run_ranks(resnet_rank, 4, "gloo", (case,))[0]["job"]["losses"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert got[-1] < got[0] and want[-1] < want[0]
