"""The port's process-parallel sharded plane (``SubprocessTransport`` in
``tpukube_torch/sched/shard.py``, the worker daemon of
``sched/shardworker.py``, ``cli.py``'s ``shard-worker``) held against the
reference's.

Twins (``run_twin``, both packages, decision by decision): every test of
test_shard_proc.py, over real worker daemons on both sides. A worker that
cannot spawn fails the port's run (the reference's ``needs_workers`` skip
is not applied to a twin).

The port's own: the ways a process-plane run can fail on another machine
than the one it was tried on — the worker's import path (a router whose
working directory holds no package), the port it binds (``--port 0``,
reported on its first stdout line), a worker that dies saying why (its
log's last lines in the error), every worker reaped when a caller fails
— and the bind effector over processes: a DCN gang's members annotated
with the global gang env of their bind answers. Scenario 14 and the
replica chaos helper run over processes on both packages."""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import urllib.request

import pytest

import test_shard_proc
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch.core.config import load_config
from tpukube_torch.sched.shard import ShardError, ShardRouter, SubprocessTransport
from tpukube_torch.sim import scenarios
from torch_refnative import use_private_tpuinfo
from torch_twin import REF_SIM_DEFAULTS, reference_cases, run_twin, value_fixtures

use_private_tpuinfo()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("fn,params", reference_cases(test_shard_proc, {}))
def test_reference_shard_proc_tests_hold_on_the_port(fn, params):
    run_twin(fn, value_fixtures(params))


def _proc_config(n: int = 2, **extra: str):
    return load_config(env={**REF_SIM_DEFAULTS,
                            "TPUKUBE_PLANNER_REPLICAS": str(n),
                            "TPUKUBE_SHARD_TRANSPORT": "subprocess",
                            "TPUKUBE_BATCH_ENABLED": "1", **extra})


# -- the worker's import path ---------------------------------------------------

def test_a_router_outside_the_checkout_spawns_its_workers():
    # the router's process runs in an empty directory and finds the
    # package through sys.path alone: no PYTHONPATH for its children to
    # inherit, no package under their working directory
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from tpukube_torch.core.config import load_config
        from tpukube_torch.core.mesh import MeshSpec
        from tpukube_torch.sim import SimCluster
        cfg = load_config(env={{"TPUKUBE_BACKEND": "sim",
                               "TPUKUBE_PLANNER_REPLICAS": "2",
                               "TPUKUBE_SHARD_TRANSPORT": "subprocess",
                               "TPUKUBE_BATCH_ENABLED": "1"}})
        mesh = MeshSpec(dims=(2, 2, 1), host_block=(2, 2, 1),
                        torus=(False, False, False))
        with SimCluster(cfg, slices={{"s0": mesh, "s1": mesh}},
                        in_process=True) as c:
            node, alloc = c.schedule(c.make_pod("p", tpu=1))
            print(node, alloc.device_ids)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with tempfile.TemporaryDirectory() as td:
        proc = subprocess.run([sys.executable, "-c", code], cwd=td, env=env,
                              capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    node, ids = proc.stdout.split(" ", 1)
    assert node.startswith(("s0-", "s1-")) and ids.strip() == "['tpu-0']"


# -- the port a worker binds ----------------------------------------------------

def test_a_worker_binds_port_0_and_reports_it_first():
    cfg = dataclasses.asdict(load_config(env={}))
    from tpukube_torch.core.config import write_yaml

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "c.yaml")
        write_yaml(path, cfg)
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpukube_torch.cli", "shard-worker",
             "--config", path, "--port", "0"],
            cwd=REPO, stdout=subprocess.PIPE, text=True)
        try:
            first = json.loads(proc.stdout.readline())["serving"]
            assert first["port"] > 0 and first["pid"] == proc.pid
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{first['port']}/healthz",
                    timeout=10) as r:
                assert json.loads(r.read())["ok"] is True
        finally:
            proc.terminate()
            assert proc.wait(timeout=10) == 0


# -- a dead worker says why -----------------------------------------------------

def test_a_worker_that_dies_before_serving_quotes_its_log():
    bad = dataclasses.replace(load_config(env={}), wire_codec="msgpack")
    with pytest.raises(ShardError) as ei:
        SubprocessTransport(0, bad, fake_clock=False)
    msg = str(ei.value)
    assert "exited with 1 before serving" in msg
    assert "Traceback" in msg and "unknown wire_codec 'msgpack'" in msg


def test_the_worker_log_keeps_stdout_and_stderr():
    t = SubprocessTransport(0, load_config(env={}), fake_clock=True)
    try:
        with open(t.log_path) as f:
            first = f.readline()
        assert json.loads(first)["serving"]["port"] == t._port
        assert t.spawn_ready_s > 0
    finally:
        t.kill()
    assert not os.path.exists(os.path.dirname(t.log_path))


# -- every worker reaped --------------------------------------------------------

def test_close_after_a_failure_leaves_no_worker_alive():
    router = ShardRouter(_proc_config(2), clock=None)
    procs = [t._proc for t in router.spawned]
    assert len(procs) == 2 and all(p.poll() is None for p in procs)
    with pytest.raises(RuntimeError, match="a failed check"):
        try:
            raise RuntimeError("a failed check")
        finally:
            router.close()
    assert all(p.poll() is not None for p in procs)


def test_kill_ends_the_workers_process_group():
    t = SubprocessTransport(0, load_config(env={}), fake_clock=True)
    pgid = os.getpgid(t.pid)
    assert pgid == t.pid != os.getpgid(0)
    t.kill()
    assert t._proc.returncode == -9
    with pytest.raises(ProcessLookupError):
        os.killpg(pgid, 0)


def test_a_restart_reaps_the_replaced_worker():
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.sim import SimCluster

    with SimCluster(_proc_config(2), clock=FakeClock(), in_process=True,
                    slices=test_shard_proc.two_slices()) as c:
        c.schedule_pending([c.make_pod(f"p{i}", tpu=1) for i in range(4)])
        router = c.extender
        old = router.replicas[0].transport
        c.crash_replica(0)
        c.restart_replica(0)
        assert old._proc.poll() is not None
        assert router.replicas[0].transport._proc.poll() is None
        spawned = list(router.spawned)
    assert len(spawned) == 3
    assert all(t._proc.poll() is not None for t in spawned)


# -- the bind effector over processes -------------------------------------------

def test_dcn_members_annotations_carry_the_global_gang_env():
    """A 2-worker router over the REST stand-in, its bind effector the
    REST one: each DCN gang member's alloc annotation, as the stand-in
    holds it, equals its bind answer's (the global gang env: both slices,
    the member's own index), not its replica's one-slice part."""
    from tpukube_torch.apiserver import pod_binder, rest_apiserver_from_config
    from tpukube_torch.core import codec
    from tpukube_torch.core.mesh import MeshSpec
    from tpukube_torch.core.types import ChipInfo, NodeInfo, PodGroup, TopologyCoord
    from tpukube_torch.device.gpu import ENV_GANG_NUM_SLICES, ENV_GANG_SLICES
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim.kube_rest import KubeRestServer

    mesh = MeshSpec(dims=(2, 1, 1), host_block=(2, 1, 1),
                    torus=(False, False, False))

    def host(name, sid):
        chips = [ChipInfo(chip_id=f"{name}-gpu-{i}", index=i,
                          coord=TopologyCoord(i, 0, 0), hbm_bytes=80 << 30,
                          num_cores=132) for i in range(2)]
        return codec.annotate_node(NodeInfo(name=name, chips=chips,
                                            slice_id=sid), mesh)

    cfg = _proc_config(2)
    with KubeRestServer(token="t") as kube:
        api = rest_apiserver_from_config(cfg, kube.base_url, token="t")
        router = ShardRouter(cfg)
        try:
            router.binder = pod_binder(api)
            nodes = {"host-a": host("host-a", "sa"),
                     "host-b": host("host-b", "sb")}
            router.upsert_nodes_many([{"name": n, "annotations": a}
                                      for n, a in nodes.items()])
            group = PodGroup("g", min_member=3, allow_dcn=True)
            members = [pod_object(f"g-{i}", tpu=1,
                                  annotations=codec.pod_group_annotations(group))
                       for i in range(3)]
            answers = {}
            for pod in members:
                kube.store.upsert_pod(pod)
                fres = router.handle("filter", {"Pod": pod,
                                                "NodeNames": sorted(nodes)})
                assert fres["NodeNames"], fres
                meta = pod["metadata"]
                bres = router.handle("bind", {
                    "PodName": meta["name"], "PodNamespace": "default",
                    "PodUID": meta["uid"], "Node": fres["NodeNames"][0]})
                assert not bres.get("Error"), bres
                answers[meta["name"]] = codec.decode_alloc(
                    bres["Annotations"][codec.ANNO_ALLOC])
            assert router.rendezvous_committed == 1
            for name, want in answers.items():
                got = codec.decode_alloc(api.get_pod("default", name)
                                         ["metadata"]["annotations"]
                                         [codec.ANNO_ALLOC])
                assert got.env == want.env, name
                assert got.env[ENV_GANG_NUM_SLICES] == "2"
                assert got.env[ENV_GANG_SLICES] == "sa,sb"
                assert api.get_pod("default", name)["spec"]["nodeName"] \
                    == got.node_name
        finally:
            router.close()


def test_a_failed_bind_effector_releases_the_pod_over_processes():
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.sim import SimCluster

    def refuse(alloc):
        raise RuntimeError("apiserver said no")

    with SimCluster(_proc_config(2), clock=FakeClock(), in_process=True,
                    slices=test_shard_proc.two_slices()) as c:
        c._sync_nodes()
        router = c.extender
        router.binder = refuse
        assert router.binder is not None
        pod = c.make_pod("x", tpu=1)
        fres = router.handle("filter", {"Pod": pod,
                                        "NodeNames": sorted(c.nodes)})
        bres = router.handle("bind", {"PodName": "x",
                                      "PodNamespace": "default",
                                      "PodUID": pod["metadata"]["uid"],
                                      "Node": fres["NodeNames"][0]})
        assert "apiserver said no" in bres["Error"]
        assert router.state.allocation("default/x") is None
        assert router.state.allocations() == []


# -- the plane's consumers over processes ----------------------------------------

SCENARIO14_ENV = {"TPUKUBE_SHARD_SLICES": "2", "TPUKUBE_SIM_MESH_DIMS": "4,4,4",
                  "TPUKUBE_PLANNER_REPLICAS": "2",
                  "TPUKUBE_KILONODE100K_PODS": "400",
                  "TPUKUBE_SHARD_TRANSPORT": "subprocess"}


def test_scenario14_over_processes_gives_the_reference_result(monkeypatch):
    for k, v in SCENARIO14_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TPUKUBE_LOCK_MONITOR", raising=False)
    got, want = scenarios.run(14), ref_scenarios.run(14)
    for key in ("pods_total", "nodes", "chips", "gang_committed",
                "ledger_divergence", "pods_sampled_full_protocol",
                "sim_seconds", "utilization_percent", "resync"):
        assert got[key] == want[key], key
    assert got["ledger_divergence"] == 0 and got["gang_committed"]
    for key in ("slice_assignment", "replicas", "rendezvous"):
        assert got["shard"][key] == want["shard"][key], key
    tr = got["shard"]["transport"]
    assert tr["mode"] == want["shard"]["transport"]["mode"] == "subprocess"
    assert [r["replica"] for r in tr["replicas"]] == ["r0", "r1"]
    assert all(r["requests"] > 0 for r in tr["replicas"])
    assert got["wire"]["waves"] == want["wire"]["waves"]
    assert set(got["wire"]["top_ops"]) == set(want["wire"]["top_ops"])
    # the same calls cross the wire, and the same pod bodies: the node
    # annotations and bind answers differ in the port's GPU fields
    for op, cell in want["wire"]["top_ops"].items():
        assert got["wire"]["top_ops"][op]["calls"] == cell["calls"], op
    for op in ("admit", "planned"):
        assert got["wire"]["top_ops"][op] == want["wire"]["top_ops"][op], op


def test_replica_crash_recover_over_processes_as_the_reference():
    from tpukube.chaos import replica_crash_recover as ref_recover
    from tpukube.core.clock import FakeClock as RefFakeClock
    from tpukube.core.config import load_config as ref_load_config
    from tpukube.sim import SimCluster as RefSim
    from tpukube_torch.chaos import replica_crash_recover
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.sim import SimCluster

    def drive(sim_cls, cfg, clock_cls, recover, pkg_types):
        slices = {sid: pkg_types.MeshSpec(dims=(2, 2, 2), host_block=(2, 2, 1),
                                          torus=(False, False, False))
                  for sid in ("s0", "s1")}
        with sim_cls(cfg, clock=clock_cls(), in_process=True,
                     slices=slices) as c:
            placed = c.schedule_pending([c.make_pod(f"p{i}", tpu=1)
                                         for i in range(6)])
            out = recover(c, 1)
            return (sorted((k, n, tuple(a.device_ids))
                           for k, (n, a) in placed.items()), out)

    import tpukube.core.mesh as ref_mesh
    import tpukube_torch.core.mesh as port_mesh

    env = {**REF_SIM_DEFAULTS, "TPUKUBE_PLANNER_REPLICAS": "2",
           "TPUKUBE_SHARD_TRANSPORT": "subprocess",
           "TPUKUBE_BATCH_ENABLED": "1"}
    got = drive(SimCluster, load_config(env=env), FakeClock,
                replica_crash_recover, port_mesh)
    want = drive(RefSim, ref_load_config(env=env), RefFakeClock, ref_recover,
                 ref_mesh)
    assert got == want


# -- chip_smoke.py's step 20 on the CPU -------------------------------------------

def test_card_step_shard_proc_life_on_a_sim_node():
    """chip_smoke.py's ``shard_proc_life`` with this machine's node agent on
    the sim backend (one GPU) and, for the card member, a child that prints
    its ``serving`` line, serves a moment and reports: the gang commits
    through the rendezvous over two worker daemons with one member on tpu-0
    and the global gang env in its annotation; the card's worker, SIGKILLed
    while the member serves, is respawned warm with the same federated
    state; the router's listener serves the federated pages; no worker is
    left alive."""
    import contextlib
    import types

    import chip_smoke
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.plugin import DevicePluginServer, InProcessKubelet

    @contextlib.contextmanager
    def card_agent():
        cfg = load_config(env={
            "TPUKUBE_BACKEND": "sim", "TPUKUBE_SIM_MESH_DIMS": "1,1,1",
            "TPUKUBE_SIM_HOST_BLOCK": "1,1,1",
            "TPUKUBE_SIM_HOST_ORIGIN": "0,0,0"})
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

    got = chip_smoke.shard_proc_life(card_agent, start_serving=start_serving,
                                     run_solo=lambda env: {"env": env})
    assert got["slice_assignment"] == {"hgx-0": "r0", "slice-0": "r1"}
    assert got["rendezvous"] == {"prepared": 1, "committed": 1, "aborted": 0}
    assert got["member_gang_env"] == {
        "TPU_KUBE_GANG_NUM_SLICES": "2", "TPU_KUBE_GANG_SLICES": "hgx-0,slice-0",
        "TPU_KUBE_GANG_SLICE_INDEX": "1"}
    assert envs[0]["TPU_KUBE_GANG_NUM_SLICES"] == "2"
    assert got["member_serving_at_kill"] and got["member_pod"] == {"batch": 1}
    assert got["killed_worker_exit"] == -9
    assert got["shard_x_while_dead"] == []
    assert got["state_equal_after_restart"]
    assert got["last_restart"]["warm"] and got["last_restart"]["restored"] >= 1
    assert got["respawned_pid"] != got["worker_pids"][got["card_replica"]]
    assert got["leaked_reservations"] == got["ledger_divergence"] == 0
    assert got["release_many"] == {"r0": 8, "r1": 1}
    assert got["explain"]["parts_replicas"] == ["r0", "r1"]
    assert got["metrics"]["binds_total_replicas"] == ["r0", "r1"]
    assert got["statusz"]["transport_mode"] == "subprocess"
    assert got["shard_x_pod"]["env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert got["routes"]["pods.binding"] == 10
    assert got["workers_alive_after"] == []


@pytest.mark.parametrize("files,affinity,want", [
    ({}, 8, (None, 8)),
    ({"cpu.max": "max 100000\n"}, 8, (None, 8)),
    ({"cpu.max": "200000 100000\n"}, 8, (2.0, 2)),
    ({"cpu.max": "150000 100000\n"}, 8, (1.5, 2)),
    ({"cpu.max": "1600000 100000\n"}, 4, (16.0, 4)),
    ({"cpu/cpu.cfs_quota_us": "300000\n",
      "cpu/cpu.cfs_period_us": "100000\n"}, 8, (3.0, 3)),
    ({"cpu/cpu.cfs_quota_us": "-1\n",
      "cpu/cpu.cfs_period_us": "100000\n"}, 2, (None, 2)),
])
def test_schedulable_cores_reads_affinity_and_the_cgroup_quota(
        tmp_path, files, affinity, want):
    import chip_smoke

    for name, text in files.items():
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(text)
    got = chip_smoke.schedulable_cores(affinity=affinity, cgroup=str(tmp_path))
    assert (got["quota"], got["cores"]) == want
    assert got["affinity"] == affinity


def test_live_children_lists_a_child_until_it_is_reaped():
    import chip_smoke

    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(30)"])
    try:
        assert any(pid == proc.pid and "time.sleep" in cmd
                   for pid, cmd in chip_smoke.live_children())
    finally:
        proc.kill()
        proc.wait()
    assert all(pid != proc.pid for pid, _ in chip_smoke.live_children())


def test_the_workers_config_file_round_trips_every_field(tmp_path):
    # the transport writes each worker's config with write_yaml; the
    # worker reads it back with read_yaml: every field comes back as it
    # was (odd strings, floats without a dot, tuples), but the two the
    # transport pins: the worker is one in-process planner
    from tpukube_torch.core.config import GpuKubeConfig, write_yaml

    cfg = dataclasses.replace(
        _proc_config(3), slice_id='s "x"\\y # z: w\tv', retry_jitter=1e-05,
        journal_enabled=True, journal_path=str(tmp_path / "a b" / "wal"),
        sim_torus=(True, False, True), wire_codec="binary",
        decisions_sample_rate=0.1 + 0.2, trace_path="",
        hbm_bytes_per_chip=(1 << 40) + 3)
    path = str(tmp_path / "c.yaml")
    write_yaml(path, dataclasses.asdict(cfg))
    assert load_config(yaml_path=path, env={}) == cfg
    t = SubprocessTransport.__new__(SubprocessTransport)
    t._dir = str(tmp_path)
    back = load_config(yaml_path=t._write_config(cfg), env={})
    assert back == dataclasses.replace(cfg, planner_replicas=1,
                                       shard_transport="inprocess")
    assert {f.name for f in dataclasses.fields(GpuKubeConfig)} \
        == set(dataclasses.asdict(back))
