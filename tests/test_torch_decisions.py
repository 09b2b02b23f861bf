"""The port's decision-provenance plane (``tpukube_torch/obs/decisions.py``,
the cycle's phase profiling, ``/explain`` and ``obs explain``) held against
the reference's.

Twins (``run_twin``, both packages, decision by decision): test_decisions.py
but the tests named in ``DECISIONS_SKIPS``, each with its reason. The
port's own: the sampled set is the reference's, pod for pod; the same
drive writes the same sink on both packages, line for line less the host
time of each line; each package's ``explain_doc`` reads the other's sink;
placements with provenance on are those with it off, in both packages, for
scenarios 10, 11 and 12; the stages a batch drive records (the arm and the
snapshot advance of each ``cycle_plan``) are the reference's; and step
18b of the card's smoke run, ``explain_life``, on the sim backend.

Host time: every stage event carries ``ts`` (the wall clock at record
time), and the ring's stats carry ``record_seconds`` (the measured record
wall) and ``sink_path``; those are left out of every comparison below.
``queue_age_s`` is on the scheduling clock, a ``FakeClock`` here, so it is
compared.

The arm a batch plan records may differ from the reference's only while a
node is cordoned: the port's cycle then plans on its general arm (its fast
arm does not read the cordon set; the reference's fast arm plans onto a
cordoned node, ROADMAP.md Queue 3). No drive here cordons a node, and the
last test shows the port's record in that case."""

import contextlib
import importlib
import io
import json
import os
import tempfile
import types

import pytest

import chip_smoke
import test_decisions
from tpukube import cli as ref_cli
from tpukube.core.clock import FakeClock as RefFakeClock
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.obs import decisions as ref_decisions
from tpukube.sched import extender as ref_extender
from tpukube.sched import kube as ref_kube
from tpukube.sim import SimCluster as RefSimCluster
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch import cli
from tpukube_torch.core.clock import FakeClock
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.obs import decisions
from tpukube_torch.sched import extender as port_extender
from tpukube_torch.sched import kube
from tpukube_torch.sim import SimCluster
from tpukube_torch.sim import scenarios
from test_torch_cli import _capsys
from torch_refnative import use_private_tpuinfo
from torch_twin import REF_SIM_DEFAULTS, TMP_PATH, reference_tests, run_twin

use_private_tpuinfo()

DECISIONS_SKIPS = {
    "test_provenance_lint_tree_clean":
        "lints the reference's package by its __path__, which the port's "
        "stand-in module does not hand out; "
        "test_provenance_lint_tree_clean_on_the_port lints the port's tree",
}
# the tests that scrape the reference's sim over HTTP (base_url)
_SERVED = {"test_explain_route_and_cli_file_mode",
           "test_explain_route_404_when_disabled"}
HOST_TIME = ("ts",)
TENANT_LABEL = "tpu.qiniu.com/tenant"


FIXTURES = {**TMP_PATH, "capsys": lambda g: _capsys()}


@pytest.mark.parametrize("fn", reference_tests(test_decisions, DECISIONS_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_decisions_tests_hold_on_the_port(fn):
    run_twin(fn, FIXTURES, serve_ref=fn.__name__ in _SERVED)


def test_provenance_lint_tree_clean_on_the_port():
    # the port's refusal seams all record: zero findings, zero waivers
    import tpukube_torch
    from tpukube_torch.analysis.base import run_all

    assert run_all([tpukube_torch.__path__[0]],
                   rules=["decision-provenance"]) == []


# -- sampling -----------------------------------------------------------------

@pytest.mark.parametrize("seed,rate", [(0, 0.01), (7, 0.25), (1337, 0.5)])
def test_the_sampled_set_is_the_references(seed, rate):
    keys = [f"{ns}/pod-{i}" for ns in ("default", "team-a", "kube-system")
            for i in range(2000)]
    port = decisions.DecisionLog(sample_rate=rate, seed=seed)
    ref = ref_decisions.DecisionLog(sample_rate=rate, seed=seed)
    got = [k for k in keys if port.wants(k)]
    assert got == [k for k in keys if ref.wants(k)]
    assert 0 < len(got) < len(keys)


# -- one drive, both packages' sinks -------------------------------------------

PORT = types.SimpleNamespace(sim=SimCluster, load_config=load_config,
                             group=PodGroup, clock=FakeClock, kube=kube,
                             decisions=decisions)
REF = types.SimpleNamespace(sim=RefSimCluster, load_config=ref_load_config,
                            group=RefPodGroup, clock=RefFakeClock, kube=ref_kube,
                            decisions=ref_decisions)


def _drive(pkg, sink: str) -> None:
    """One decision sequence on ``pkg``'s in-process sim with provenance
    on and a sink: the webhook path (placed, pending, a tenancy quota
    refusal, a gang that preempts, a completion), then the batch path
    (admitted, planned, bound from the plan, a gang arm, a queue age on
    the fake clock). The sink is closed, so it holds every stage."""
    env = {**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
           "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
           "TPUKUBE_DECISIONS_ENABLED": "1", "TPUKUBE_DECISIONS_PATH": sink,
           "TPUKUBE_TENANCY_ENABLED": "1",
           "TPUKUBE_TENANCY_QUOTAS": "a=chips:2"}
    clock = pkg.clock()
    with pkg.sim(pkg.load_config(env=env), clock=clock, in_process=True) as c:
        c.schedule(c.make_pod("a-0", tpu=2, priority=50,
                              labels={TENANT_LABEL: "a"}))
        for i in range(10):
            c.schedule(c.make_pod(f"low-{i}", tpu=1, priority=0,
                                  labels={TENANT_LABEL: "b"}))
        for name, kw in (("a-1", {"tpu": 1, "labels": {TENANT_LABEL: "a"}}),
                         ("huge", {"tpu": 64})):
            with contextlib.suppress(RuntimeError):
                c.schedule(c.make_pod(name, **kw), retries=1)
        group = pkg.group("g", min_member=8)
        for i in range(8):
            c.schedule(c.make_pod(f"g-{i}", tpu=1, priority=100, group=group))
        c.complete_pod("a-0")
        clock.advance(3.0)
        c.extender.decisions.close()
    env.pop("TPUKUBE_TENANCY_QUOTAS")
    env.update({"TPUKUBE_TENANCY_ENABLED": "0", "TPUKUBE_BATCH_ENABLED": "1",
                "TPUKUBE_DECISIONS_PATH": sink + ".batch"})
    clock = pkg.clock()
    with pkg.sim(pkg.load_config(env=env), clock=clock, in_process=True) as c:
        ext = c.extender
        c._sync_nodes()
        pods = [c.make_pod(f"b-{i}", tpu=1) for i in range(5)]
        for p in pods:
            ext.admit(pkg.kube.pod_from_k8s(p))
        clock.advance(2.5)
        c.schedule_pending(pods)
        group = pkg.group("gb", min_member=4)
        c.schedule_pending([c.make_pod(f"gb-{i}", tpu=1, priority=10,
                                       group=group) for i in range(4)])
        c.complete_pod("b-0")
        ext.decisions.close()


def _lines(path: str) -> list:
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in HOST_TIME}
                for line in f]


@pytest.fixture(scope="module")
def sinks():
    with tempfile.TemporaryDirectory() as td:
        out = {}
        for name, pkg in (("port", PORT), ("ref", REF)):
            path = os.path.join(td, f"{name}.jsonl")
            _drive(pkg, path)
            out[name] = path
        yield out


@pytest.mark.parametrize("suffix", ["", ".batch"], ids=["webhook", "batch"])
def test_the_same_drive_writes_the_same_sink(sinks, suffix):
    got, want = _lines(sinks["port"] + suffix), _lines(sinks["ref"] + suffix)
    assert got == want
    stages = {ev["stage"] for ev in got}
    if suffix:
        assert {"admit", "cycle_plan", "bind", "gang_reserve",
                "release"} <= stages
        plans = [ev for ev in got if ev["stage"] == "cycle_plan"]
        assert {ev["arm"] for ev in plans} == {"fast", "gang_batch"}
        assert {ev["snapshot"] for ev in plans} <= {"cached", "delta", "rebuild"}
        assert [ev["queue_age_s"] for ev in plans[:5]] == [2.5] * 5
    else:
        assert {"filter", "prioritize", "bind", "tenancy", "refusal",
                "preemption_plan", "preempted", "gang_reserve",
                "release"} <= stages


@pytest.mark.parametrize("suffix", ["", ".batch"], ids=["webhook", "batch"])
def test_each_package_explains_the_others_sink(sinks, suffix):
    def scrub(doc):
        return {**doc, "stages": [{k: v for k, v in ev.items()
                                   if k not in HOST_TIME}
                                  for ev in doc["stages"]]}

    pods = sorted({ev["pod"] for ev in _lines(sinks["port"] + suffix)})
    verdicts = set()
    for pod in pods + ["default/ghost"]:
        docs, texts = [], set()
        for reader in (decisions, ref_decisions):
            for path in (sinks["port"] + suffix, sinks["ref"] + suffix):
                doc = reader.explain_doc(reader.load(path), pod)
                docs.append(scrub(doc))
                texts.add(reader.format_explain(doc))
        assert all(d == docs[0] for d in docs[1:]), pod
        assert len(texts) == 1, pod
        verdicts.add(docs[0]["verdict"])
    assert verdicts == ({"placed", "released", "unknown"} if suffix else
                        {"placed", "released", "denied", "pending",
                         "preempted", "unknown"})


def test_obs_explain_prints_as_the_reference_tool(sinks):
    for argv in (["explain", "a-1", "--file", sinks["ref"]],
                 ["explain", "default/g-0", "--file", sinks["port"], "--json"],
                 ["explain", "default/ghost", "--file", sinks["port"]]):
        outs = []
        for main in (cli.main_obs, ref_cli.main_obs):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = main(argv)
            outs.append((rc, buf.getvalue()))
        assert outs[0] == outs[1], argv
    assert outs[0][0] == 1 and "UNKNOWN" in outs[0][1]


# -- provenance observes, it never decides ------------------------------------

@pytest.mark.parametrize("scenario,knobs", [
    (10, {"TPUKUBE_KILONODE_PODS": "1500"}),
    (11, {"TPUKUBE_TENANCY_WAVES": "6", "TPUKUBE_CHAOS_SEED": "1337"}),
    (12, {"TPUKUBE_KILONODE10K_PODS": "2500"}),
])
def test_placements_with_provenance_on_are_those_with_it_off(
        scenario, knobs, monkeypatch):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TPUKUBE_BATCH_ENABLED", raising=False)
    results = {}
    for name, mod, runner in (("port", port_extender, scenarios),
                              ("ref", ref_extender, ref_scenarios)):
        for on in ("0", "1"):
            monkeypatch.setenv("TPUKUBE_DECISIONS_ENABLED", on)
            with chip_smoke.recorded_binds(mod) as log:
                result = runner.run(scenario)
            results[name, on] = (log, result)
    for name in ("port", "ref"):
        off, on = results[name, "0"], results[name, "1"]
        assert off[0] and on[0] == off[0], name
        assert on[1]["decisions"]["recorded"] > 0, name
        assert "decisions" not in off[1] or not off[1]["decisions"], name
    if scenario != 11:
        # the kilonode drives bind the same pods to the same chips on both
        # packages (scenario 11's storm retries hang on wall-clock timing)
        assert results["port", "1"][0] == results["ref", "1"][0]
        port_d, ref_d = (results[k, "1"][1]["decisions"]
                         for k in ("port", "ref"))
        assert port_d["recorded"] == ref_d["recorded"]
        assert port_d["overhead_pct"] is not None


def test_a_cordoned_fleet_records_the_general_arm():
    """The one place the arm differs from the reference's: with a node
    cordoned the port's cycle plans on its general arm, which filters per
    pod, so the chain also carries that filter's pruning."""
    env = {**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
           "TPUKUBE_SIM_HOST_BLOCK": "2,2,1", "TPUKUBE_DECISIONS_ENABLED": "1",
           "TPUKUBE_BATCH_ENABLED": "1", "TPUKUBE_DRAIN_ENABLED": "1"}
    with SimCluster(load_config(env=env), clock=FakeClock(),
                    in_process=True) as c:
        ext = c.extender
        c._sync_nodes()
        cordoned = sorted(ext.state.node_names())[0]
        ext.drain.begin([cordoned])
        pod = c.make_pod("c-0", tpu=1)
        ext.admit(kube.pod_from_k8s(pod))
        placed = c.schedule_pending([pod])
        doc = ext.decisions.explain("default/c-0")
    assert placed["default/c-0"][0] != cordoned
    plan = next(ev for ev in doc["stages"] if ev["stage"] == "cycle_plan")
    assert plan["arm"] == "general" and plan["assumed"] is True
    f = next(ev for ev in doc["stages"] if ev["stage"] == "filter")
    assert f["feasible"] == f["candidates"] - 1
    assert doc["verdict"] == "placed"


# -- step 18b of the card's smoke run, on the sim backend ------------------------

def test_explain_life_on_a_sim_node():
    """chip_smoke's ``explain_life`` with a sim-backend node agent and no
    container: why-0 placed from a batch plan and explained live, why-1
    pending while the card is taken, the phases and counters on /metrics,
    why-0's release, why-1 bound, SIGTERM, and the sink explained as the
    live route did."""
    importlib.reload(chip_smoke)
    got = chip_smoke.explain_life(
        lambda: chip_smoke.node_agent({"TPUKUBE_BACKEND": "sim",
                                       "TPUKUBE_SIM_MESH_DIMS": "1,1,1",
                                       "TPUKUBE_SIM_HOST_BLOCK": "1,1,1",
                                       "TPUKUBE_SIM_HOST_ORIGIN": "0,0,0"},
                                      host=chip_smoke.DAEMON_NODE))
    assert got["binds"] == {"why-0": ["tpu-0"], "why-1": ["tpu-0"]}
    assert got["why0_chain"][:3] == ["admit", "cycle_plan", "bind"]
    assert got["why0_arm"] == "fast"
    assert got["why1_verdict"] == "pending" and got["why1_pending_age_s"] > 0
    assert "node has 0 free" in got["why1_reasons"]
    assert got["sink_same_stages"] is True
    assert got["sigterm_rc"] == 0
    assert set(got["phases_observed"]) == {"queue", "pin", "plan", "answer",
                                           "commit"}
    assert got["decisions_total"] > 0
