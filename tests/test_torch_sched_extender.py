"""The port's extender held against the reference's: the default-path
webhook tests run on both packages decision by decision; the standard
library server answers as ``Extender.handle`` does; the DCN gang env the
port mints for ``dryrun_multichip`` is the reference's; and a scheduled
pod's env is held against its bind."""

import http.client
import json
import os

import pytest

import __graft_entry__ as ref_entry
import test_extender
from tpukube.core import codec as ref_codec
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sim import SimCluster as RefSimCluster
from tpukube_torch import graft
from tpukube_torch.core import codec
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.sched import client, kube
from tpukube_torch.sched.extender import Extender, serve
from tpukube_torch.sim import SimCluster
from tpukube_torch.workload.meshenv import PodGpuEnv
from test_torch_train import port_env
from torch_refnative import use_private_tpuinfo
from torch_twin import reference_tests, run_twin

use_private_tpuinfo()

EXTENDER_SKIPS = {
    "test_bad_json_is_400": "HTTP (the port's server: test_http_* below)",
    "test_healthz": "HTTP (the port's server: test_http_* below)",
}
FIXTURES = {
    # tests/test_extender.py's ``cluster``: 4 nodes x 4 chips
    "cluster": lambda g: g["SimCluster"](g["load_config"](env={
        "TPUKUBE_SIM_MESH_DIMS": "4,4,1", "TPUKUBE_SIM_HOST_BLOCK": "2,2,1"})),
}


@pytest.mark.parametrize("fn", reference_tests(test_extender, EXTENDER_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_extender_tests_hold_on_the_port(fn):
    run_twin(fn, FIXTURES)


def _restart(sim_cls, ext_cls, load, group_cls, codec_mod, kw):
    """Two free pods and a committed 8-pod gang on an HGX fleet, then a
    fresh extender rebuilt from the pods' annotations (plus one malformed
    alloc annotation it must skip). Returns what the fresh extender holds
    and how it answers the next pod."""
    cfg = load(env={"TPUKUBE_SIM_MESH_DIMS": "8,4,1", "TPUKUBE_SIM_HOST_BLOCK": "8,1,1"})
    with sim_cls(cfg, **kw) as c:
        c.schedule(c.make_pod("a", tpu=2))
        c.schedule(c.make_pod("b", tpu=4))
        group = group_cls("g", min_member=8)
        for i in range(8):
            c.schedule(c.make_pod(f"g-{i}", tpu=1, group=group))
        pods = [dict(p["metadata"]["annotations"]) for p in c.pods.values()]
        pods.append({codec_mod.ANNO_ALLOC: "{not json"})
        nodes = c.node_objects()
        fresh = ext_cls(c.config)
        for obj in nodes:
            fresh.state.upsert_node(obj["metadata"]["name"], obj["metadata"]["annotations"])
        restored = fresh.rebuild_from_pods(pods)
        allocs = {}
        for key in sorted(c.pods):
            a = fresh.state.allocation(key)
            allocs[key] = (a.node_name, a.device_ids, [tuple(x) for x in a.coords], a.env)
        res = fresh.gang.reservation("default", "g")
        gang = (res.committed, res.total_chips())
        # the next pods: a free one, and a poacher of the gang's chips
        nxt = c.make_pod("c", tpu=8)
        answers = [fresh.handle("filter", {"Pod": nxt, "Nodes": {"Items": nodes}})]
        answers.append(fresh.handle("prioritize", {"Pod": nxt, "NodeNames": [
            n["metadata"]["name"] for n in nodes]}))
        return (restored, allocs, gang, fresh.state.utilization(), c.utilization(),
                json.dumps(answers, sort_keys=True))


def test_restart_rebuilds_ledger_and_gang_as_the_reference():
    # the port's Extender.rebuild_from_pods and ClusterState.rebuild_from_pods
    got = _restart(SimCluster, Extender, load_config, PodGroup, codec, {})
    want = _restart(RefSimCluster, RefExtender, ref_load_config, RefPodGroup,
                    ref_codec, {"in_process": True})
    assert got == want
    restored, allocs, gang, util, util_before, _ = got
    assert restored == 10 and len(allocs) == 10
    assert gang == (True, 8)
    assert util == util_before


def _fleet():
    return SimCluster(load_config(env={"TPUKUBE_SIM_MESH_DIMS": "8,2,1",
                                       "TPUKUBE_SIM_HOST_BLOCK": "8,1,1"}))


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _raw_post(port, path, payload: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("POST", path, body=payload,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_server_answers_as_handle_does():
    # the same pods through the server and through handle() on a twin
    # extender: byte-identical answers, decision by decision
    with _fleet() as sim:
        nodes = sim.node_objects()
        over_http = Extender(load_config(env={}))
        in_process = Extender(load_config(env={}))
        server = serve(over_http)
        port = server.server_address[1]
        try:
            pods = [kube.pod_object("a", tpu=2), kube.pod_object("b", tpu=8),
                    kube.pod_object("c", tpu=8), kube.pod_object("web")]
            for pod in pods:
                meta = pod["metadata"]
                for path, body in (
                        ("/filter", {"Pod": pod, "Nodes": {"Items": nodes}}),
                        ("/prioritize", {"Pod": pod, "NodeNames": [
                            n["metadata"]["name"] for n in nodes]}),
                        ("/bind", {"PodName": meta["name"], "PodNamespace": "default",
                                   "PodUID": meta["uid"], "Node": "host-0-1-0"})):
                    status, raw = _raw_post(port, path, json.dumps(body).encode())
                    want = in_process.handle(path[1:], body)
                    assert status == 200
                    assert raw == json.dumps(want).encode()
            status, raw = _get(port, "/healthz")
            assert status == 200
            assert json.loads(raw) == {"ok": True, "nodes": ["host-0-0-0", "host-0-1-0"]}
            status, raw = _get(port, "/metrics")
            assert status == 200
            text = raw.decode()
            assert in_process.binds_total == over_http.binds_total == 1
            assert "tpukube_binds_total 1\n" in text
            assert "tpu_chip_utilization_percent 12.5\n" in text
            status, raw = _get(port, "/statusz")
            assert status == 200
            doc = json.loads(raw)
            assert doc["component"] == "extender"
            assert doc["ledger"]["allocations"] == 1
            assert _get(port, "/no-such-route")[0] == 404
        finally:
            server.shutdown()
            server.server_close()
    assert over_http.trace.events()[-1]["kind"] == "bind"


def test_http_bad_json_and_schema_errors_are_400_and_record_nothing():
    ext = Extender(load_config(env={}))
    server = serve(ext)
    port = server.server_address[1]
    try:
        status, raw = _raw_post(port, "/filter", b"{not json")
        assert status == 400 and raw.startswith(b"bad JSON")
        status, raw = _raw_post(port, "/filter", json.dumps({"Nodes": {}}).encode())
        assert status == 400
        status, _ = _raw_post(port, "/bind", json.dumps({"PodName": "x"}).encode())
        assert status == 400
        assert _raw_post(port, "/state", b"{}")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
    assert ext.trace.events() == []


def test_client_places_over_http_and_refuses_when_full():
    # the smoke run's kube-scheduler: filter -> prioritize -> bind over
    # the server, on a node the real agent's codec annotated
    with _fleet() as sim:
        nodes = sim.node_objects()
        ext = Extender(load_config(env={}))
        server = serve(ext)
        port = server.server_address[1]
        try:
            placed = [client.place(port, kube.pod_object(f"p-{i}", tpu=8), nodes)
                      for i in range(2)]
            assert sorted(n for n, _, _ in placed) == ["host-0-0-0", "host-0-1-0"]
            for node, alloc, ms in placed:
                assert alloc.node_name == node and len(alloc.device_ids) == 8
                assert set(ms) == {"filter", "prioritize", "bind"}
            refused = client.filter_nodes(port, kube.pod_object("x", tpu=1), nodes)
            assert refused["NodeNames"] == [] and len(refused["FailedNodes"]) == 2
            with pytest.raises(RuntimeError, match="unschedulable"):
                client.place(port, kube.pod_object("x", tpu=1), nodes)
        finally:
            server.shutdown()
            server.server_close()


def test_minted_dcn_gang_env_is_the_reference_s():
    got, want = graft._mint_dcn_gang_env(), port_env(ref_entry._mint_dcn_gang_env())
    # each package's node agent mints its own default HBM per chip (the
    # port's H100 80 GiB, the reference's v5p 95 GiB); every other key is
    # the reference's, with the visibility key renamed
    hbm = "TPU_HBM_LIMIT_BYTES"
    assert got.pop(hbm) == str(load_config(env={}).hbm_bytes_per_chip)
    assert want.pop(hbm) == str(95 * 1024**3)
    assert got == want
    assert got["TPU_KUBE_GANG_NUM_SLICES"] == "2"


def test_dryrun_mints_its_own_gang_env_and_runs_leg2(capsys):
    out = graft.dryrun_multichip(4, device="cpu")
    assert "skipping" not in capsys.readouterr().out
    assert out["leg2"]["axes"] == ["dcn", "dp", "tp"]
    assert out["leg2"]["shape"] == [2, 1, 2]


def _scheduled_member():
    with SimCluster(load_config(env={"TPUKUBE_SIM_MESH_DIMS": "8,4,1",
                                     "TPUKUBE_SIM_HOST_BLOCK": "8,1,1"})) as c:
        group = PodGroup("llama-8b", min_member=16)
        binds = [c.schedule(c.make_pod(f"m-{i}", tpu=1, group=group))[1]
                 for i in range(16)]
        # the last member: on the second host, at y = 1
        return binds[-1], {**binds[-1].env, **c.execute_allocation(binds[-1])}


def test_scheduled_pod_env_holds_against_its_bind():
    alloc, env = _scheduled_member()
    checked = graft.check_scheduled_env(PodGpuEnv.from_env(env), codec.encode_alloc(alloc))
    assert checked["mesh_dims"] == [8, 4, 1]
    assert checked["gang"] == ["1", "slice-0", "0"]
    assert checked["coords"] == [list(c) for c in alloc.coords]


def test_scheduled_env_of_a_pod_outside_a_gang_holds():
    # a plain pod's alloc carries no gang keys; its env reads the
    # one-slice defaults, and a gang key it does not have is refused
    with SimCluster(load_config(env={"TPUKUBE_SIM_MESH_DIMS": "8,1,1",
                                     "TPUKUBE_SIM_HOST_BLOCK": "8,1,1"})) as c:
        _, alloc = c.schedule(c.make_pod("plain-0", tpu=1))
        env = {**alloc.env, **c.execute_allocation(alloc)}
    assert alloc.env == {}
    checked = graft.check_scheduled_env(PodGpuEnv.from_env(env), codec.encode_alloc(alloc))
    assert checked["gang"] == ["1", "", "0"]
    env["TPU_KUBE_GANG_NUM_SLICES"] = "2"
    env["TPU_KUBE_GANG_SLICES"] = "slice-0,slice-1"
    with pytest.raises(RuntimeError, match="gang keys"):
        graft.check_scheduled_env(PodGpuEnv.from_env(env), codec.encode_alloc(alloc))


@pytest.mark.parametrize("key,value,match", [
    ("TPU_KUBE_CHIP_COORDS", "7,3,0", "coords"),
    ("TPU_KUBE_GANG_NUM_SLICES", "2", "gang keys"),
    ("TPU_KUBE_DEVICE_IDS", "tpu-7", "devices"),
    ("TPU_KUBE_GANG_SLICES", "slice-9", "gang keys"),
    ("TPU_KUBE_MESH_DIMS", "8,1,1", "outside mesh"),
])
def test_scheduled_pod_env_mismatch_is_refused(key, value, match):
    alloc, env = _scheduled_member()
    env[key] = value
    with pytest.raises(RuntimeError, match=match):
        graft.check_scheduled_env(PodGpuEnv.from_env(env), codec.encode_alloc(alloc))


@pytest.mark.parametrize("shares", [1, 2])
def test_smoke_run_places_the_card_s_pods_over_http(tmp_path, monkeypatch, shares):
    # chip_smoke.py's placement phase, on a real-backend node agent over
    # the NVML stub (one GPU): whole GPU -> tpu-0, then a second pod is
    # unschedulable; two shares -> frac0of2 and frac1of2, a third refused
    import chip_smoke
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.native.gpuinfo import compile_shared

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "tpukube_torch", "native", "nvml_stub.cpp")
    stub = compile_shared(src, str(tmp_path / "libnvidia-ml.so.1"))
    for k in ("NVML_STUB_NAME", "NVML_STUB_FAIL_INIT", "NVML_STUB_LOST"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NVML_STUB_COUNT", "1")
    monkeypatch.setenv("NVML_STUB_MEM", str(80 << 30))
    cfg = load_config(env={"TPUKUBE_NVML_PATH": stub,
                           "TPUKUBE_SHARES_PER_CHIP": str(shares)})
    with GpuDeviceManager(cfg) as mgr:
        node = chip_smoke.node_object(mgr)
        if shares == 1:
            pods, want = [kube.pod_object("serve-0", tpu=1)], [["tpu-0"]]
            refused = kube.pod_object("serve-1", tpu=1)
        else:
            pods = [kube.pod_object(f"shared-{k}", vtpu=1) for k in range(2)]
            want = [["tpu-0-frac0of2"], ["tpu-0-frac1of2"]]
            refused = kube.pod_object("shared-2", vtpu=1)
        allocs = chip_smoke.place_pods(node, pods, want, refused, "stub")
        assert [a.device_ids for a in allocs] == want
        envs = [{**a.env, **mgr.allocate_env(a.device_ids)} for a in allocs]
    assert all(e["CUDA_VISIBLE_DEVICES"] == "0" for e in envs)
    # a bind to the wrong device is a failed phase, not a pass
    with GpuDeviceManager(cfg) as mgr:
        assert chip_smoke.place_pods(chip_smoke.node_object(mgr), pods[:1],
                                     [["tpu-9"]], refused, "stub") is None
