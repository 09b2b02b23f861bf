"""The port's gang scheduling held against the reference's, decision by
decision: the reference's gang, DCN-gang and config-4 tests run on both
packages with every bind recorded and compared, and config 4 (a 16-pod
gang) also runs on an HGX fleet, where it must take two whole hosts."""

import pytest

import test_config4
import test_dcn_gang
import test_gang
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.sim import SimCluster as RefSimCluster
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.sim import SimCluster
from test_torch_train import port_env
from torch_refnative import use_private_tpuinfo
from torch_twin import reference_tests, run_twin

use_private_tpuinfo()

DCN_SKIPS = {
    "test_mesh_from_alloc_env_builds_dcn_mesh": "a workload test (twin in test_torch_dryrun)",
}


@pytest.mark.parametrize(
    "fn",
    reference_tests(test_gang, {}) + reference_tests(test_dcn_gang, DCN_SKIPS)
    + reference_tests(test_config4, {}),
    ids=lambda f: f"{f.__module__}.{f.__name__}")
def test_reference_gang_tests_hold_on_the_port(fn):
    # threads race each other's binds there: compare the chips taken
    run_twin(fn, ordered=fn.__name__ != "test_concurrent_gang_assembly")


def _hgx_gang(sim_cls, load, group_cls, hosts, members, background):
    """Config 4 on an HGX fleet: ``hosts`` hosts of 8 GPUs along y, two
    4-GPU background pods, then a ``members``-pod gang of 1 GPU each.
    Returns (background binds, member binds, utilization, member 0's
    Allocate env, the reservation's committed flag)."""
    cfg = load(env={
        "TPUKUBE_SIM_MESH_DIMS": f"8,{hosts},1",
        "TPUKUBE_SIM_HOST_BLOCK": "8,1,1",
        "TPUKUBE_HBM_BYTES_PER_CHIP": str(80 << 30),
    })
    kw = {} if sim_cls is SimCluster else {"in_process": True}
    with sim_cls(cfg, **kw) as c:
        bg = [c.schedule(c.make_pod(f"bg-{i}", tpu=4)) for i in range(background)]
        group = group_cls("llama-8b", min_member=members)
        binds = [c.schedule(c.make_pod(f"llama-8b-{i}", tpu=1, group=group))
                 for i in range(members)]
        res = c.extender.gang.reservation("default", "llama-8b")
        return (bg, binds, c.utilization(), c.execute_allocation(binds[0][1]),
                res.committed)


def _rows(binds):
    return [(n, a.device_ids, [tuple(c) for c in a.coords], a.env) for n, a in binds]


@pytest.mark.parametrize("hosts,members,util", [(4, 16, 0.75), (16, 64, 0.5625)])
def test_config4_on_an_hgx_fleet(hosts, members, util):
    bg, binds, u, env, committed = _hgx_gang(
        SimCluster, load_config, PodGroup, hosts, members, 2)
    rbg, rbinds, ru, renv, _ = _hgx_gang(
        RefSimCluster, ref_load_config, RefPodGroup, hosts, members, 2)
    assert _rows(bg) == _rows(rbg) and _rows(binds) == _rows(rbinds)
    assert committed and u == ru == util
    # whole hosts, contiguous along y: an (8, members / 8, 1) box
    nodes = sorted({n for n, _ in binds})
    ys = sorted({c[1] for _, a in binds for c in a.coords})
    assert len(nodes) == members // 8
    assert ys == list(range(ys[0], ys[0] + members // 8))
    assert len({tuple(c) for _, a in binds for c in a.coords}) == members
    assert all(len({c[0] for _, a in binds for c in a.coords if c[1] == y}) == 8
               for y in ys)
    # member 0's Allocate env on the bound node is the reference's, in
    # the port's names
    assert env == port_env(renv)
    assert env["TPU_KUBE_MESH_DIMS"] == f"8,{hosts},1"


def test_config4_hgx_takes_the_hosts_the_background_left():
    _, binds, _, _, _ = _hgx_gang(SimCluster, load_config, PodGroup, 4, 16, 2)
    assert sorted({n for n, _ in binds}) == ["host-0-1-0", "host-0-2-0"]


def test_gang_refuses_as_the_reference_when_no_slice_is_free():
    cfg = {"TPUKUBE_SIM_MESH_DIMS": "8,2,1", "TPUKUBE_SIM_HOST_BLOCK": "8,1,1"}
    out = []
    for sim, load, group_cls, kw in (
            (SimCluster, load_config, PodGroup, {}),
            (RefSimCluster, ref_load_config, RefPodGroup, {"in_process": True})):
        with sim(load(env=cfg), **kw) as c:
            c.schedule(c.make_pod("bg", tpu=4))
            errors = []
            for prio in (0, -1):
                with pytest.raises(RuntimeError) as e:
                    c.schedule(c.make_pod(f"g-{prio}", tpu=1, priority=prio,
                                          group=group_cls(f"g{prio}", min_member=16)))
                errors.append(str(e.value))
            out.append(errors)
    assert out[0] == out[1]
    assert "cannot preempt" in out[0][0]

