"""The port's fleet-elasticity planes (``tpukube_torch/sched/drain.py``,
``sched/autoscale.py``, ``chaos/maintenance.py``, the cordon and un-ingest
seams of ``sched/state.py`` and their journal records) held against the
reference's.

Twins (``run_twin``, both packages, decision by decision): test_drain.py
(its drain-intent test over the shard router's worker daemons). The port's
own: scenario 15's phases A and B give the reference's result field by
field at seed 1337, 6 cycles and audit rate 1.0; ``sim 15`` runs from
both packages' CLIs; journal files written across ``set_cordon`` and
``remove_nodes`` by either package recover on the other with the same
cordons, nodes, allocations and ``/state``; with every elasticity and
capacity flag off the exposition, ``/statusz`` and the journal bytes are
what they were without the planes; the drain and autoscaler families
render as the reference's; the maintenance and spot-churn schedules draw
as the reference's; and chip_smoke.py's step 17b runs on a sim node
without pods."""

import json
import random

import pytest

import test_drain
from tpukube.chaos import maintenance as ref_maintenance
from tpukube.core.clock import FakeClock as RefFakeClock
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.mesh import MeshSpec as RefMeshSpec
from tpukube.metrics import render_extender_metrics as ref_render
from tpukube.obs.statusz import extender_statusz as ref_statusz
from tpukube.sched import journal as ref_journal
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sim import SimCluster as RefSimCluster
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch.chaos import maintenance
from tpukube_torch.core.clock import FakeClock
from tpukube_torch.core.config import load_config
from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.metrics import render_extender_metrics
from tpukube_torch.obs import slo
from tpukube_torch.obs.statusz import extender_statusz
from tpukube_torch.sched import journal
from tpukube_torch.sched.extender import Extender
from tpukube_torch.sim import SimCluster
from tpukube_torch.sim import scenarios
from torch_refnative import use_private_tpuinfo
from torch_twin import (
    REF_SIM_DEFAULTS,
    TMP_PATH,
    reference_cases,
    run_twin,
    value_fixtures,
)

use_private_tpuinfo()


@pytest.mark.parametrize("fn,params",
                         reference_cases(test_drain, {}))
def test_reference_drain_tests_hold_on_the_port(fn, params):
    run_twin(fn, {**TMP_PATH, **value_fixtures(params)})


# -- config ---------------------------------------------------------------------

ELASTICITY_KEYS = (
    "capacity_enabled", "capacity_sample_interval_seconds", "capacity_samples",
    "capacity_path", "capacity_sink_max_bytes", "drain_enabled",
    "drain_max_concurrent_moves", "drain_tenant_budget", "autoscale_enabled",
    "autoscale_up_queue_depth", "autoscale_down_utilization",
    "autoscale_min_slices", "autoscale_max_slices",
    "autoscale_cooldown_seconds")


@pytest.mark.parametrize("env", [
    {},
    {"TPUKUBE_DRAIN_ENABLED": "1", "TPUKUBE_AUTOSCALE_ENABLED": "1",
     "TPUKUBE_CAPACITY_ENABLED": "1"},
    {"TPUKUBE_CAPACITY_ENABLED": "true",
     "TPUKUBE_CAPACITY_SAMPLE_INTERVAL_SECONDS": "5",
     "TPUKUBE_CAPACITY_SAMPLES": "16", "TPUKUBE_CAPACITY_PATH": "/x.jsonl",
     "TPUKUBE_CAPACITY_SINK_MAX_BYTES": "4096",
     "TPUKUBE_DRAIN_ENABLED": "yes", "TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES": "2",
     "TPUKUBE_DRAIN_TENANT_BUDGET": "1", "TPUKUBE_AUTOSCALE_ENABLED": "1",
     "TPUKUBE_AUTOSCALE_UP_QUEUE_DEPTH": "1",
     "TPUKUBE_AUTOSCALE_DOWN_UTILIZATION": "0.5",
     "TPUKUBE_AUTOSCALE_MIN_SLICES": "2", "TPUKUBE_AUTOSCALE_MAX_SLICES": "3",
     "TPUKUBE_AUTOSCALE_COOLDOWN_SECONDS": "0"},
], ids=["defaults", "enabled", "every-knob"])
def test_elasticity_keys_load_as_the_reference(env):
    got, want = load_config(env=env), ref_load_config(env=env)
    for name in ELASTICITY_KEYS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("env,match", [
    ({"TPUKUBE_AUTOSCALE_ENABLED": "1"}, "requires drain_enabled"),
    ({"TPUKUBE_CAPACITY_PATH": "/x.jsonl"}, "capacity_path"),
    ({"TPUKUBE_CAPACITY_ENABLED": "1", "TPUKUBE_CAPACITY_SAMPLES": "0"},
     "capacity_samples"),
    ({"TPUKUBE_CAPACITY_ENABLED": "1",
      "TPUKUBE_CAPACITY_SAMPLE_INTERVAL_SECONDS": "0"},
     "capacity_sample_interval_seconds"),
    ({"TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES": "0"}, "drain_max_concurrent_moves"),
    ({"TPUKUBE_DRAIN_TENANT_BUDGET": "-1"}, "drain_tenant_budget"),
    ({"TPUKUBE_AUTOSCALE_UP_QUEUE_DEPTH": "0"}, "autoscale_up_queue_depth"),
    ({"TPUKUBE_AUTOSCALE_DOWN_UTILIZATION": "2"}, "autoscale_down_utilization"),
    ({"TPUKUBE_AUTOSCALE_MIN_SLICES": "3", "TPUKUBE_AUTOSCALE_MAX_SLICES": "2"},
     "autoscale_max_slices"),
], ids=["autoscale-without-drain", "path-without-plane", "zero-ring",
        "zero-interval", "zero-budget", "negative-tenant-budget",
        "zero-depth", "utilization-over-one", "max-below-min"])
def test_elasticity_keys_refused_as_the_reference(env, match):
    with pytest.raises(ValueError, match=match):
        ref_load_config(env=env)
    with pytest.raises(ValueError, match=match):
        load_config(env=env)


def test_elasticity_keys_load_from_a_config_file(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("drain_enabled: true\ndrain_tenant_budget: 2\n"
                    "autoscale_enabled: true\ncapacity_enabled: true\n"
                    "autoscale_cooldown_seconds: 0\n")
    cfg = load_config(yaml_path=str(path), env={})
    assert (cfg.drain_enabled, cfg.drain_tenant_budget, cfg.autoscale_enabled,
            cfg.capacity_enabled, cfg.autoscale_cooldown_seconds) == (
        True, 2, True, True, 0.0)


# -- scenario 15 ----------------------------------------------------------------

def test_scenario_15_gives_the_reference_results(monkeypatch):
    monkeypatch.setenv("TPUKUBE_CHAOS_SEED", "1337")
    monkeypatch.setenv("TPUKUBE_MAINT_CYCLES", "6")
    monkeypatch.setenv("TPUKUBE_SNAPSHOT_AUDIT_RATE", "1.0")
    got = scenarios.run(15)
    want = ref_scenarios.run(15)
    for r in (got, want):
        r.pop("wall_s")
    assert got == want
    assert got["sharded"]["drained_slices"]
    storm = got["storm"]
    assert storm["drains_completed"] > 0 and storm["spot_kills"] > 0
    assert got["peak_tick_moves"] <= got["budget_moves"] == 2
    assert got["autoscale"]["scale_ups"] == got["autoscale"]["scale_downs"] == 1
    audit = got["snapshot_audit"]
    assert audit["checks"] > 0 and audit["divergences"] == 0


def test_scenario_15_runs_from_both_clis(monkeypatch, capsys):
    from tpukube import cli as ref_cli
    from tpukube_torch import cli

    monkeypatch.setenv("TPUKUBE_MAINT_CYCLES", "2")
    assert cli.main(["sim", "15"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ref_cli.main_sim(["15"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for r in (got, want):
        r.pop("wall_s")
    assert got == want
    assert got["scenario"] == 15 and got["cycles"] == 2


def test_scenario_15_phase_c_shields_the_draining_replica(monkeypatch):
    # phase C drains replica 1's whole slice set under the router's
    # drain intent while replica 0 crashes and restarts; the health
    # checker skips the draining replica (in process there is no health
    # check to skip, so the count is the reference's zero)
    monkeypatch.setenv("TPUKUBE_MAINT_CYCLES", "2")
    got = scenarios.run(15)["sharded"]
    assert got["drained_slices"] == sorted(
        s for s, r in got["slice_assignment"].items() if r == 1)
    assert got["drained_nodes"] > 0
    assert got["health_skips_draining"] == 0


# -- the maintenance and spot-churn schedules ------------------------------------

@pytest.mark.parametrize("seed", [1, 1337, 9001])
def test_maintenance_schedules_draw_as_the_reference(seed):
    slices = [f"s{i}" for i in range(5)]
    pairs = []
    for mod in (maintenance, ref_maintenance):
        m = mod.MaintenanceSchedule(seed, slices, return_rate=0.4, budget=7)
        s = mod.SpotChurnSchedule(seed + 3, kill_rate=0.5, budget=4)
        rng = random.Random(seed)
        events, kills = [], []
        for step in range(12):
            if step == 5:
                m.stop()
                s.stop()
            if step == 8:
                m.resume()
                s.resume()
            events.append(m.next_event())
            kills.append(s.draw_kill(
                [f"n{i}" for i in range(rng.randrange(0, 6))]))
        pairs.append((events, kills, m.report(), s.report()))
    assert pairs[0] == pairs[1]
    assert any(e is not None for e in pairs[0][0])


# -- journal files across cordon and un-ingest, either package --------------------

PORT = (SimCluster, load_config, FakeClock, MeshSpec, {})
REF = (RefSimCluster, ref_load_config, RefFakeClock, RefMeshSpec,
       {"in_process": True})


def _elastic_env(wal: str) -> dict:
    return {**REF_SIM_DEFAULTS,
            "TPUKUBE_JOURNAL_ENABLED": "1", "TPUKUBE_JOURNAL_PATH": wal,
            "TPUKUBE_DRAIN_ENABLED": "1",
            "TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES": "2"}


def _state(ext) -> dict:
    return {
        "cordoned": sorted(ext.state.cordoned_nodes()),
        "nodes": list(ext.state.node_names()),
        "slices": ext.state.slice_ids(),
        "allocs": sorted((a.pod_key, a.node_name, tuple(a.device_ids))
                         for a in ext.state.allocations()),
        "state": [ext.topology_snapshot(), ext.alloc_snapshot(),
                  ext.gang_snapshot()],
    }


def _drive_elastic(pkg, wal: str, checkpoint_at: int = -1):
    """A two-slice fleet with the journal on: binds on both slices, slice
    s0 drained whole (cordon, budgeted evictions, un-ingest), one node of
    s1 cordoned and left so, one idle node of s1 removed with no notice;
    a synchronous checkpoint after step ``checkpoint_at``. Returns the
    sim (its pod store outlives the extender) and the writer's state."""
    sim_cls, load, clock_cls, mesh_cls, kw = pkg
    slices = {sid: mesh_cls(dims=(4, 4, 1), host_block=(2, 2, 1))
              for sid in ("s0", "s1")}
    c = sim_cls(load(env=_elastic_env(wal)), clock=clock_cls(),
                slices=slices, **kw)
    ext = c.extender

    def nodes_of(sid):
        return sorted(n for n in ext.state.node_names()
                      if ext.state.slice_of_node(n) == sid)

    def drain_s0():
        doomed = nodes_of("s0")
        ext.drain.begin(doomed, reason="maintenance")
        while ext.drain.active():
            c.clock.advance(1.0)
            ext.drain.tick()
        c.forget_nodes(doomed)

    def spot_kill():
        live = {a.node_name for a in ext.state.allocations()}
        idle = [n for n in nodes_of("s1") if n not in live
                and not ext.state.is_cordoned(n)]
        assert ext.state.remove_nodes(idle[-1:])["removed"] == idle[-1:]
        c.forget_nodes(idle[-1:])

    steps = [lambda i=i: c.schedule(c.make_pod(f"p{i}", tpu=2))
             for i in range(6)]
    steps += [lambda: ext.state.set_cordon(nodes_of("s1")[:1], True),
              drain_s0, spot_kill,
              lambda: c.schedule(c.make_pod("after", tpu=1))]
    for n, step in enumerate(steps):
        step()
        ext.journal.sync()
        if n == checkpoint_at:
            ext.snapshots.current()  # a seedable snapshot rides along
            ext.journal.write_checkpoint_sync(ext.checkpoint_doc())
    want = _state(ext)
    ext.journal.close()
    ext.state.retire()
    return c, want


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("checkpoint_at", [-1, 6, 9])
def test_each_package_recovers_the_others_cordons_and_removals(
        tmp_path, writer, reader, checkpoint_at):
    wal = str(tmp_path / "wal.jsonl")
    c, want = _drive_elastic(REF if writer == "ref" else PORT, wal,
                             checkpoint_at)
    with open(wal, "rb") as f:
        records = [json.loads(line)["k"] for line in f]
    if checkpoint_at < 0:
        assert {"cordon", "unnodes"} <= set(records)
    if reader == "ref":
        ext = RefExtender(ref_load_config(env=_elastic_env(wal)))
        stats = ref_journal.recover_extender(ext, c._store_api)
    else:
        ext = Extender(load_config(env=_elastic_env(wal)))
        stats = journal.recover_extender(ext, c._store_api)
    try:
        got = _state(ext)
        if reader == "port":
            # the port's seeded snapshot holds to a rebuild; the
            # reference seeds an empty geometry mask from a checkpoint
            # (ROADMAP.md Queue 3, reference-side caveats), so its audit
            # trips on the spot-killed host's chips
            ext.snapshots.audit_now()
    finally:
        ext.journal.close()
        ext.state.retire()
    assert stats["mode"] == "warm" and stats["divergences"] == 0
    assert stats["checkpoint"] is (checkpoint_at >= 0)
    if reader == "ref" and checkpoint_at >= 0:
        # the same caveat: the reference's seeded snapshot counts the
        # spot-killed host's chips as free, so the two numbers /state
        # reads off the snapshot differ until its next rebuild
        for doc in (got, want):
            for sl in doc["state"][0]["slices"]:
                sl.pop("fragmentation")
                sl.pop("largest_free_box_chips")
    assert got == want
    assert len(want["cordoned"]) == 1 and want["slices"] == ["s1"]
    assert len(want["nodes"]) == 3


@pytest.mark.parametrize("checkpoint_at", [-1, 9])
def test_same_elastic_decisions_write_the_same_journal_files(
        tmp_path, checkpoint_at):
    files = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        (tmp_path / name).mkdir()
        wal = str(tmp_path / name / "wal.jsonl")
        _drive_elastic(pkg, wal, checkpoint_at)
        with open(wal, "rb") as f:
            files[name] = [f.read()]
        if checkpoint_at >= 0:
            with open(wal + ".ckpt", "rb") as f:
                lines = f.read().splitlines()
            head = json.loads(lines[0])
            files[name].append([{k: v for k, v in head.items()
                                 if k not in ("ts", "c")}, *lines[1:]])
    assert files["port"] == files["ref"]
    if checkpoint_at >= 0:
        # the checkpoint carries the cordon: the ledger's names and the
        # seedable snapshot's coords
        head = files["port"][1][0]
        assert head["state"]["cordoned"]
        assert any(sd.get("crd") for sd in head["snap"].values())


# -- with every flag off, nothing moves ------------------------------------------

def _sequence(pkg, wal: str, **extra):
    """One journaled sim sequence (a gang, binds, a completion) and a
    checkpoint; returns (the /metrics page, /statusz, WAL bytes, the
    checkpoint's lines without its clock)."""
    sim_cls, load, clock_cls, mesh_cls, kw = pkg
    c = sim_cls(load(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
                          "TPUKUBE_JOURNAL_ENABLED": "1",
                          "TPUKUBE_JOURNAL_PATH": wal, **extra}),
                clock=clock_cls(), **kw)
    for i in range(5):
        c.schedule(c.make_pod(f"p{i}", tpu=1))
    c.complete_pod("p0")
    c.extender.journal.write_checkpoint_sync(c.extender.checkpoint_doc())
    page = (render_extender_metrics if sim_cls is SimCluster
            else ref_render)(c.extender)
    doc = (extender_statusz if sim_cls is SimCluster
           else ref_statusz)(c.extender)
    c.extender.journal.close()
    c.extender.state.retire()
    with open(wal, "rb") as f:
        wal_bytes = f.read()
    with open(wal + ".ckpt", "rb") as f:
        lines = f.read().splitlines()
    head = {k: v for k, v in json.loads(lines[0]).items()
            if k not in ("ts", "c")}
    return page, doc, wal_bytes, [head, *lines[1:]]


def _families(page: str) -> list:
    return [line for line in page.splitlines() if line.startswith("#")]


def test_flags_off_leave_exposition_statusz_and_journal_unchanged(tmp_path):
    """The planes' knobs without their flags change nothing: the same
    /metrics families and label sets, the same /statusz sections, the
    same WAL and checkpoint bytes — and those bytes are the reference's
    with its planes off, as they were before the planes were ported."""
    runs = {}
    knobs = {"TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES": "1",
             "TPUKUBE_DRAIN_TENANT_BUDGET": "3",
             "TPUKUBE_CAPACITY_SAMPLES": "8",
             "TPUKUBE_AUTOSCALE_UP_QUEUE_DEPTH": "1",
             "TPUKUBE_AUTOSCALE_COOLDOWN_SECONDS": "0"}
    for name, pkg, extra in (("off", PORT, {}), ("knobs", PORT, knobs),
                             ("ref", REF, {})):
        (tmp_path / name).mkdir()
        runs[name] = _sequence(pkg, str(tmp_path / name / "wal.jsonl"),
                               **extra)
    off, knobbed, ref = runs["off"], runs["knobs"], runs["ref"]
    assert _families(off[0]) == _families(knobbed[0])
    assert ([(s.name, s.labels) for s in slo.parse_metrics(off[0])]
            == [(s.name, s.labels) for s in slo.parse_metrics(knobbed[0])])
    for word in ("tpukube_capacity", "tpukube_drain", "tpukube_autoscaler",
                 "tpukube_unschedulable"):
        assert word not in off[0]
    assert list(off[1]) == list(knobbed[1])
    assert not {"capacity", "drain", "autoscaler"} & set(off[1])
    assert off[2] == knobbed[2] == ref[2]
    assert off[3] == knobbed[3] == ref[3]
    assert b"cordon" not in off[2] and "cordoned" not in off[3][0]["state"]


def _elastic_page(sim_cls, load, sim_kw) -> str:
    """A /metrics page with drain and the autoscaler on, after a drain."""
    cfg = load(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
                    "TPUKUBE_DRAIN_ENABLED": "1",
                    "TPUKUBE_AUTOSCALE_ENABLED": "1"})
    with sim_cls(cfg, **sim_kw) as c:
        node, _ = c.schedule(c.make_pod("a", tpu=1))
        c.extender.drain.begin([node])
        c.extender.drain.tick()
        c.extender.autoscaler.tick()
        return (render_extender_metrics if sim_cls is SimCluster
                else ref_render)(c.extender)


def test_drain_and_autoscaler_families_render_as_the_reference():
    """The drain and autoscaler families' TYPE/HELP lines, label sets and
    values are the reference's after the same drain."""
    def shape(text: str) -> list:
        out = []
        for line in text.splitlines():
            if "tpukube_drain" not in line and "tpukube_autoscaler" not in line:
                continue
            if line.startswith("#"):
                out.append(line)
            else:
                s = slo.parse_metrics(line)[0]
                out.append((s.name, s.labels, s.value))
        return out

    got = shape(_elastic_page(SimCluster, load_config, {}))
    want = shape(_elastic_page(RefSimCluster, ref_load_config,
                               {"in_process": True}))
    assert got == want
    assert len([x for x in got if isinstance(x, str)
                and x.startswith("# TYPE")]) == 12


# -- the batch cycle under a cordon ------------------------------------------------

def _plan_under_cordon(sim_cls, load, clock_cls, kube_mod):
    cfg = load(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "2,2,1",
                    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                    "TPUKUBE_BATCH_ENABLED": "1", "TPUKUBE_DRAIN_ENABLED": "1",
                    "TPUKUBE_CAPACITY_ENABLED": "1"})
    with sim_cls(cfg, clock=clock_cls(), in_process=True) as c:
        ext = c.extender
        node = c.schedule_pending([c.make_pod("a", tpu=1)])["default/a"][0]
        ext.drain.begin([node])
        ext.admit(kube_mod.pod_from_k8s(c.make_pod("b", tpu=1)))
        ext.plan_pending()
        return node, ext.planned_node("default/b"), \
            ext.capacity.unschedulable_counts()


def test_batch_plans_skip_cordoned_nodes():
    """A 1-GPU pod planned while its only node is cordoned: the port's
    plan finds no node and strands it as ``draining``; the reference's
    fast path plans it onto the cordoned node (ROADMAP.md Queue 3)."""
    from tpukube.sched import kube as ref_kube
    from tpukube_torch.sched import kube

    node, planned, stranded = _plan_under_cordon(
        SimCluster, load_config, FakeClock, kube)
    assert planned is None and stranded == {"draining": 1}
    ref_node, ref_planned, _ = _plan_under_cordon(
        RefSimCluster, ref_load_config, RefFakeClock, ref_kube)
    assert ref_planned == ref_node == node


# -- the card step, on a sim node ------------------------------------------------

# a container that serves until SIGTERM, in place of the card's Llama pod
SERVING_CHILD = ("import json, time; print(json.dumps({'serving': {}}), "
                 "flush=True); time.sleep(600)")


def test_card_step_drain_life_on_a_sim_node():
    """chip_smoke.py's step 17b (``drain_life``) on the CPU: this
    machine's node agent on the sim backend (one GPU) and, for serve-0, a
    child that serves until SIGTERM. serve-0 binds tpu-0 from a batch
    plan; the drain cordons the node, serve-1 stays pending and is
    stranded as ``draining``; the tick evicts serve-0 (its container
    SIGTERMed, its pod object gone), the next one un-ingests the node;
    the autoscaler's ``up`` gives it back and serve-1 binds tpu-0."""
    import contextlib
    import subprocess
    import sys
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
        with GpuDeviceManager(cfg, host="gpu-node-0") as mgr, \
                InProcessKubelet() as kubelet:
            server = DevicePluginServer(cfg, mgr)
            kubelet.register_plugin(server)
            kubelet.wait_for_devices(server.resource_name, 1)
            yield types.SimpleNamespace(mgr=mgr, kubelet=kubelet, server=server)

    envs = []

    def start_serving(env):
        envs.append(env)
        return subprocess.Popen([sys.executable, "-c", SERVING_CHILD],
                                stdout=subprocess.PIPE, text=True)

    got = chip_smoke.drain_life(card_agent, start_serving=start_serving)
    assert got["binds"] == {"serve-0": ["tpu-0"], "serve-1": ["tpu-0"]}
    assert envs[0]["CUDA_VISIBLE_DEVICES"] == "0"
    assert got["cordoned"] == ["gpu-node-0"]
    assert got["statusz_drain_active"] == 1
    assert got["stranded_reasons"] == {"draining": 1}
    assert got["unschedulable"] == {"draining": 1}
    assert got["probe_fits_before"] is False and got["probe_fits_after"] is True
    assert got["evicted"] == ["default/serve-0"]
    assert got["removed_nodes"] == ["gpu-node-0"]
    assert got["wal_unnodes"] == [["gpu-node-0"]]
    assert got["queue_depth_at_tick"] == 1 and got["decision"] == "up"
    assert got["metrics"] == {"tpukube_drain_completed_total": 1.0,
                              "tpukube_drain_evictions_total": 1.0,
                              "tpukube_drain_chips_removed_total": 1.0,
                              "tpukube_autoscaler_scale_ups_total": 1.0}
    assert got["obs_capacity_rc"] == 0
    assert got["drain"]["active"] == [] and got["autoscaler"]["scale_ups"] == 1
    assert got["routes"].get("pods.eviction") == 1
    for key in ("begin_to_cordon_ms", "cordon_to_sigterm_ms",
                "tick_to_sigterm_ms", "sigterm_to_exit_ms",
                "exit_to_completed_ms", "up_to_bound_ms"):
        assert 0 < got[key] < chip_smoke.REST_WAIT_S * 1e3, key


def test_card_step_scale_up_point_at_a_small_fleet():
    """chip_smoke.py's step 17a scale-up point at 256 nodes in place of
    10,240: every GPU of the new slice free to the placement sweeps."""
    import chip_smoke

    got = chip_smoke.scale_up_point(256)
    assert got["scale_up_nodes"] == 256 and got["scale_up_gpus"] == 1024
    assert got["scale_up_to_capacity_s"] > 0
