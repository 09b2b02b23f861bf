"""The port's in-process sharded control plane (``tpukube_torch/sched/
shard.py``) held against the reference's.

Twins (``run_twin``, both packages, decision by decision): test_shard.py
(``SHARD_SKIPS`` is empty: its lock-monitor smoke runs too)."""

import random

import pytest

import test_federated_obs
import test_shard
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch.sim import scenarios
from torch_refnative import use_private_tpuinfo
from torch_twin import (
    REF_SIM_DEFAULTS,
    TMP_PATH,
    port_load_config,
    reference_cases,
    run_twin,
    value_fixtures,
)

use_private_tpuinfo()

SHARD_SKIPS: dict = {}
FIXTURES = {**TMP_PATH, "monkeypatch": lambda g: pytest.MonkeyPatch.context()}


@pytest.mark.parametrize("fn,params",
                         reference_cases(test_shard, SHARD_SKIPS))
def test_reference_shard_tests_hold_on_the_port(fn, params):
    run_twin(fn, {**FIXTURES, **value_fixtures(params)})


def test_n1_federated_exposition_is_sole_extender_verbatim():
    # test_federated_obs.py's one in-process test (its others drive the
    # process transport: tests/test_torch_federated_obs.py)
    run_twin(test_federated_obs.test_n1_federated_exposition_is_sole_extender_verbatim)


# -- scenario 14 at the reference's tier-1 smoke size ---------------------------

SCENARIO14_ENV = {"TPUKUBE_SHARD_SLICES": "2", "TPUKUBE_SIM_MESH_DIMS": "4,4,4",
                  "TPUKUBE_PLANNER_REPLICAS": "2",
                  "TPUKUBE_KILONODE100K_PODS": "400"}


def test_scenario14_smoke_without_the_monitor(monkeypatch):
    # test_scenario14_smoke's drive with the lock-order monitor off, on
    # both packages: the same pods, slice assignment, gang commit, binds
    # per replica, rendezvous ledger and resync reads; zero divergence
    for k, v in SCENARIO14_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TPUKUBE_LOCK_MONITOR", raising=False)
    got, want = scenarios.run(14), ref_scenarios.run(14)
    assert got["scenario"] == want["scenario"] == 14
    for key in ("pods_total", "nodes", "chips", "gang_committed",
                "ledger_divergence", "pods_sampled_full_protocol",
                "sim_seconds", "utilization_percent", "resync"):
        assert got[key] == want[key], key
    assert got["pods_total"] >= 400 and got["gang_committed"]
    assert got["ledger_divergence"] == 0
    assert got["shard"]["slice_assignment"] == want["shard"]["slice_assignment"]
    assert set(got["shard"]["slice_assignment"].values()) == {"r0", "r1"}
    assert got["shard"]["replicas"] == want["shard"]["replicas"]
    assert all(r["alive"] for r in got["shard"]["replicas"])
    assert got["shard"]["rendezvous"] == want["shard"]["rendezvous"]
    assert "lock_graph" not in got["shard"]
    assert got["wire"] == want["wire"]


# -- routing: every pod to the same replica and node -----------------------------

def _churned_sharded_drive(pkg: str, seed: int) -> list:
    """A seeded churn on 4 slices behind 3 replicas (singles through the
    webhooks and the batch path, slice-sized and DCN gangs, completions
    on the fake clock); returns, per scheduled pod, the replica the
    router routed it to and its node, device ids and coords."""
    import importlib

    sim = importlib.import_module(f"{pkg}.sim")
    config = importlib.import_module(f"{pkg}.core.config")
    mesh_mod = importlib.import_module(f"{pkg}.core.mesh")
    types_mod = importlib.import_module(f"{pkg}.core.types")
    clock_mod = importlib.import_module(f"{pkg}.core.clock")
    env = {**REF_SIM_DEFAULTS, "TPUKUBE_PLANNER_REPLICAS": "3",
           "TPUKUBE_BATCH_ENABLED": "1"}
    load = port_load_config if pkg == "tpukube_torch" else config.load_config
    mesh = mesh_mod.MeshSpec(dims=(2, 2, 2), host_block=(2, 2, 1),
                             torus=(False, False, False))
    slices = {f"s{i}": mesh for i in range(4)}
    rng = random.Random(seed)
    out: list = []
    with sim.SimCluster(load(env=env), slices=slices,
                        clock=clock_mod.FakeClock(), in_process=True) as c:
        router = c.extender
        live: list[str] = []
        seq = 0

        def note(name, alloc):
            key = f"default/{name}"
            out.append((key, router._pod_replica.get(key), alloc.node_name,
                        list(alloc.device_ids),
                        [tuple(x) for x in alloc.coords]))
            live.append(name)

        for step in range(40):
            roll = rng.random()
            try:
                if roll < 0.35:
                    name = f"p{seq}"
                    _, alloc = c.schedule(c.make_pod(
                        name, tpu=rng.choice((1, 1, 2))))
                    note(name, alloc)
                elif roll < 0.5:
                    pods = [c.make_pod(f"b{seq}-{i}", tpu=1) for i in range(3)]
                    for key, (_node, alloc) in sorted(
                            c.schedule_pending(pods).items()):
                        note(key.split("/", 1)[1], alloc)
                elif roll < 0.6:
                    dcn = rng.random() < 0.5
                    size = 10 if dcn else 4
                    grp = types_mod.PodGroup(f"g{seq}", min_member=size,
                                             allow_dcn=dcn)
                    for i in range(size):
                        name = f"g{seq}-{i}"
                        _, alloc = c.schedule(c.make_pod(name, tpu=1,
                                                         group=grp))
                        note(name, alloc)
                elif live:
                    done = live.pop(rng.randrange(len(live)))
                    c.complete_pod(done)
                    out.append(("done", f"default/{done}"))
            except RuntimeError as e:
                out.append(("refused", seq, str(e)))
            seq += 1
            c.advance(1.0)
            c.drain_evictions()
        out.append(("assignment", sorted(router._slice_replica.items())))
        out.append(("rendezvous", router.rendezvous_committed,
                    router.rendezvous_aborted))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_churned_sharded_drive_routes_as_the_reference(seed):
    got = _churned_sharded_drive("tpukube_torch", seed)
    want = _churned_sharded_drive("tpukube", seed)
    assert got == want
    placed = [e for e in got if len(e) == 5]
    assert len(placed) > 20
    assert len({e[1] for e in placed}) == 3  # every replica took pods


# -- chip_smoke.py's step 19c on the CPU ------------------------------------------

def test_card_step_shard_life_on_a_sim_node():
    """chip_smoke.py's ``shard_life`` with this machine's node agent on the
    sim backend (one GPU) and, for the card member, a child that prints
    its ``serving`` line, serves a moment and reports. The gang commits
    through the rendezvous with one member on tpu-0 and the global gang
    env; the card's replica, killed while the member serves, restarts
    warm with it; the gang's end reaches each replica as one
    ``release_many``; shard-x binds tpu-0."""
    import contextlib
    import subprocess
    import sys
    import types

    import chip_smoke
    from tpukube_torch.core.config import load_config
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.plugin import DevicePluginServer, InProcessKubelet

    @contextlib.contextmanager
    def card_agent():
        cfg = load_config(env={
            "TPUKUBE_BACKEND": "sim", "TPUKUBE_SIM_MESH_DIMS": "1,1,1",
            "TPUKUBE_SIM_HOST_BLOCK": "1,1,1",
            "TPUKUBE_SIM_HOST_ORIGIN": "0,0,0"})
        # the real backend's node name on the card's machine: it sorts
        # after the sim host, so the card's slice registers second
        with GpuDeviceManager(cfg, host="host-0-0-0") as mgr, \
                InProcessKubelet() as kubelet:
            server = DevicePluginServer(cfg, mgr)
            kubelet.register_plugin(server)
            kubelet.wait_for_devices(server.resource_name, 1)
            yield types.SimpleNamespace(mgr=mgr, kubelet=kubelet, server=server)

    envs = []

    def start_serving(env):
        envs.append(env)
        code = ("import json, time; print(json.dumps({'serving': {}}), "
                "flush=True); time.sleep(0.5); "
                "print(json.dumps({'pod': {'batch': 1}}), flush=True)")
        return subprocess.Popen([sys.executable, "-c", code],
                                stdout=subprocess.PIPE, text=True)

    got = chip_smoke.shard_life(card_agent, start_serving=start_serving,
                                run_solo=lambda env: {"env": env})
    assert got["slice_assignment"] == {"hgx-0": "r0", "slice-0": "r1"}
    assert got["rendezvous"] == {"prepared": 1, "committed": 1, "aborted": 0}
    assert got["member_gang_env"] == {
        "TPU_KUBE_GANG_NUM_SLICES": "2", "TPU_KUBE_GANG_SLICES": "hgx-0,slice-0",
        "TPU_KUBE_GANG_SLICE_INDEX": "1"}
    assert envs[0]["TPU_KUBE_GANG_NUM_SLICES"] == "2"
    assert envs[0]["CUDA_VISIBLE_DEVICES"] == "0"
    assert got["member_serving_at_kill"] and got["member_pod"] == {"batch": 1}
    assert got["shard_x_while_dead"] == []
    assert got["last_restart"]["warm"] and got["last_restart"]["restored"] >= 1
    assert got["leaked_reservations"] == got["ledger_divergence"] == 0
    assert got["release_many"] == {"r0": 8, "r1": 1}
    assert got["explain_trace"] and got["member"] == "gang-8"
    assert got["shard_x_pod"]["env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert got["resync"]["incremental"] > got["resync"]["full"] >= 2
    assert got["routes"]["pods.binding"] == 10
