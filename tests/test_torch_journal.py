"""The port's durable journal (``tpukube_torch/sched/journal.py``) held
against the reference's.

Twins (``run_twin``, both packages, decision by decision): test_journal.py
whole (the crash-at-every-record-boundary property once per
``with_checkpoint`` case) and test_ingest.py's three checkpoint tests
(``test_generation_rides_checkpoint`` among them: the generation and the
resync cursor ride the checkpoint).

The port's own: the same decisions write byte-identical WAL files and
checkpoints equal apart from the head's clock field ``ts``; journal files
written by either package recover on the other to the same ledger; the
port's extender daemon with ``journal_enabled`` is SIGKILLed and restarts
warm with the same ``/state/allocs``."""

import contextlib
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

import test_ingest
import test_journal
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.sched import journal as ref_journal
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sim import SimCluster as RefSimCluster
from tpukube_torch.core import codec
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.sched import journal
from tpukube_torch.sched import kube
from tpukube_torch.sched.extender import Extender
from tpukube_torch.sim import SimCluster
from tpukube_torch.sim.kube_rest import KubeRestServer
from torch_refnative import use_private_tpuinfo
from torch_twin import REF_SIM_DEFAULTS, TMP_PATH, reference_tests, run_twin

use_private_tpuinfo()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDARY_TEST = "test_crash_at_every_record_boundary_equals_rebuild"
FIXTURES = {**TMP_PATH,
            "monkeypatch": lambda g: pytest.MonkeyPatch.context()}


@pytest.mark.parametrize(
    "fn",
    [f for f in reference_tests(test_journal, {})
     if f.__name__ != BOUNDARY_TEST],
    ids=lambda f: f.__name__)
def test_reference_journal_tests_hold_on_the_port(fn):
    run_twin(fn, FIXTURES)


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_reference_crash_at_every_boundary_holds_on_the_port(
        with_checkpoint):
    run_twin(vars(test_journal)[BOUNDARY_TEST], {
        **TMP_PATH,
        "with_checkpoint": lambda g: contextlib.nullcontext(with_checkpoint),
    })


@pytest.mark.parametrize("name", [
    "test_bulk_ingest_checkpoint_roundtrip_keeps_lazy",
    "test_mid_ingest_crash_replays_or_reconciles",
    "test_generation_rides_checkpoint",
])
def test_reference_ingest_checkpoint_tests_hold_on_the_port(name):
    run_twin(vars(test_ingest)[name], TMP_PATH)


# -- file-format parity -------------------------------------------------------

PORT = (SimCluster, load_config, PodGroup, {})
REF = (RefSimCluster, ref_load_config, RefPodGroup, {"in_process": True})


def _journal_env(wal: str, **extra) -> dict:
    return {**REF_SIM_DEFAULTS,
            "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
            "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
            "TPUKUBE_JOURNAL_ENABLED": "1",
            "TPUKUBE_JOURNAL_PATH": wal, **extra}


def _drive(pkg, wal: str, checkpoint_after: int = -1):
    """One decision sequence (gang, binds, a completion, a deletion, a
    health flip, a bind after it) with the journal on; a synchronous
    checkpoint after the ``checkpoint_after``-th step. Returns the
    extender's allocations."""
    sim_cls, load, group_cls, kw = pkg
    c = sim_cls(load(env=_journal_env(wal)), **kw)
    group = group_cls("jg", min_member=4)
    steps = [lambda i=i: c.schedule(c.make_pod(f"jg-{i}", tpu=1, priority=10,
                                               group=group))
             for i in range(4)]
    steps += [lambda i=i: c.schedule(c.make_pod(f"b-{i}", tpu=1))
              for i in range(4)]
    steps += [lambda: c.complete_pod("b-0"), lambda: c.delete_pod("b-1"),
              lambda: c.inject_fault("host-1-1-0", 0),
              lambda: c.schedule(c.make_pod("b-4", tpu=1))]
    for n, step in enumerate(steps):
        step()
        if n == checkpoint_after:
            c.extender.journal.write_checkpoint_sync(
                c.extender.checkpoint_doc())
    allocs = sorted((a.pod_key, a.node_name, tuple(a.device_ids))
                    for a in c.extender.state.allocations())
    c.extender.journal.close()
    c.extender.state.retire()
    return c, allocs


def _checkpoint_lines(path: str) -> list:
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    head = json.loads(lines[0])
    return [{k: v for k, v in head.items() if k not in ("ts", "c")},
            *lines[1:]]


@pytest.mark.parametrize("checkpoint_after", [-1, 5])
def test_same_decisions_write_the_same_journal_files(tmp_path,
                                                     checkpoint_after):
    wals = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        (tmp_path / name).mkdir()
        wals[name] = str(tmp_path / name / "wal.jsonl")
        _drive(pkg, wals[name], checkpoint_after)
    with open(wals["ref"], "rb") as a, open(wals["port"], "rb") as b:
        ref_wal, port_wal = a.read(), b.read()
    assert len(port_wal.splitlines()) > 5
    assert port_wal == ref_wal
    ckpts = [w + ".ckpt" for w in (wals["ref"], wals["port"])]
    if checkpoint_after < 0:
        assert not any(os.path.exists(p) for p in ckpts)
    else:
        ref_ckpt, port_ckpt = (_checkpoint_lines(p) for p in ckpts)
        assert len(port_ckpt) == 1 + 4  # the head, then one line per node
        assert port_ckpt == ref_ckpt


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("checkpoint_after", [-1, 5])
def test_each_package_recovers_the_others_journal(tmp_path, writer, reader,
                                                  checkpoint_after):
    wal = str(tmp_path / "wal.jsonl")
    c, want = _drive(REF if writer == "ref" else PORT, wal, checkpoint_after)
    store = c._store_api  # the writer's pod store and node objects
    if reader == "ref":
        ext = RefExtender(ref_load_config(env=_journal_env(wal)))
        stats = ref_journal.recover_extender(ext, store)
    else:
        ext = Extender(load_config(env=_journal_env(wal)))
        stats = journal.recover_extender(ext, store)
    try:
        got = sorted((a.pod_key, a.node_name, tuple(a.device_ids))
                     for a in ext.state.allocations())
        gangs = ext.gang_snapshot()
    finally:
        ext.journal.close()
        ext.state.retire()
    assert stats["mode"] == "warm"
    assert stats["checkpoint"] is (checkpoint_after >= 0)
    assert stats["replayed"] > 0
    assert stats["divergences"] == 0
    assert got == want
    assert [(g["group"], g["committed"], g["members_bound"])
            for g in gangs] == [("jg", True, 4)]


# -- the daemon, killed and restarted warm ------------------------------------

DAEMON_TIMEOUT_S = 30.0


def _get(url: str):
    with urllib.request.urlopen(url, timeout=5) as r:
        return json.loads(r.read())


def _start_daemon(args: list, url: str) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpukube_torch.cli", "extender", *args],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + DAEMON_TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"daemon exited {proc.returncode}: "
                                 f"{proc.stderr.read()[-2000:]}")
        try:
            _get(f"{url}/healthz")
            return proc
        except OSError:
            time.sleep(0.05)
    proc.kill()
    proc.wait()
    raise AssertionError("the extender daemon never served")


def test_journaled_daemon_is_killed_and_restarts_warm(tmp_path):
    from tpukube_torch.sched import client
    from tpukube_torch.sim.harness import _free_port

    cfg = tmp_path / "config.yaml"
    cfg.write_text("sim_mesh_dims: 8,4,1\nsim_host_block: 8,1,1\n"
                   "journal_enabled: true\n"
                   f"journal_path: {tmp_path / 'wal.jsonl'}\n"
                   "journal_fsync: always\n"
                   "checkpoint_interval_seconds: 3600\n")
    (tmp_path / "token").write_text("t")
    nodes = SimCluster(load_config(yaml_path=str(cfg), env={}),
                       in_process=True).node_objects()
    names = [n["metadata"]["name"] for n in nodes]
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    with KubeRestServer(token="t") as kube_server:
        for obj in nodes:
            kube_server.store.patch_node_annotations(
                obj["metadata"]["name"], obj["metadata"]["annotations"])
        args = ["--config", str(cfg), "--host", "127.0.0.1",
                "--port", str(port), "--kube-api", kube_server.base_url,
                "--kube-token-file", str(tmp_path / "token")]
        proc = _start_daemon(args, url)
        try:
            group = PodGroup("g", min_member=4)
            pods = [kube.pod_object(f"p-{i}", tpu=2) for i in range(3)]
            pods += [kube.pod_object(
                f"g-{i}", tpu=1, annotations=codec.pod_group_annotations(
                    group)) for i in range(2)]
            for pod in pods:
                kube_server.store.upsert_pod(pod)
                client.place(port, pod, names)
            before = (_get(f"{url}/state/allocs"), _get(f"{url}/state/gangs"))
            assert len(before[0]) == 5 and len(before[1]) == 1
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10)
            proc = _start_daemon(args, url)
            recovery = _get(f"{url}/statusz")["journal"]["last_recovery"]
            assert recovery["mode"] == "warm"
            assert recovery["replayed"] > 0
            assert (_get(f"{url}/state/allocs"),
                    _get(f"{url}/state/gangs")) == before
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=DAEMON_TIMEOUT_S) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def test_card_step_journal_life_at_a_small_fleet():
    """chip_smoke.py's step 15b (``journal_life``) on the CPU: 16 HGX hosts
    and a gang of 8 in place of 1,024 and 64, and this machine's node
    agent on the sim backend (one GPU) with no card pod."""
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
        with GpuDeviceManager(cfg, host=chip_smoke.DAEMON_NODE) as mgr, \
                InProcessKubelet() as kubelet:
            server = DevicePluginServer(cfg, mgr)
            kubelet.register_plugin(server)
            kubelet.wait_for_devices(server.resource_name, 1)
            yield types.SimpleNamespace(mgr=mgr, kubelet=kubelet, server=server)

    got = chip_smoke.journal_life(card_agent, hosts=16, gang=8)
    assert got["killed_at"] == {"allocations": 5, "members_bound": 4}
    assert got["recovery"]["mode"] == "warm"
    assert got["recovery"]["replayed"] > 0
    # the first start's recovery wrote the checkpoint; the WAL tail behind
    # it held journal-0 and four members
    assert got["recovery"]["restored_allocs"] == 0
    assert got["torn_mode"] == "cold-fallback"
    assert got["metrics"]["tpukube_journal_appends_total"] > 0
    for route in ("nodes.list", "nodes.watch", "pods.list", "pods.watch",
                  "pods.patch", "pods.binding"):
        assert got["routes"].get(route), route
