"""The port's lock-order monitor (``tpukube_torch/analysis/lockgraph.py``)
and its wiring (``SimCluster``, ``cli sim``, the shard router's federated
report, the worker daemons) held against the reference's.

Twins (``run_port``: each reference test's body on the port): the
monitor's tests of test_lint.py but those named in ``LOCKGRAPH_SKIPS``,
with its stand-in. The port's own: scenario 14 over two worker daemons
with the monitor on (the workers' edges merged, no cycle) and off (no
``lock_graph`` key); ``cli sim``'s ``lock_graph`` key and its exit code
on a cycle; sites named from the package's parent directory."""

import importlib
import json
import os
import threading

import pytest

import test_lint
from tpukube_torch.analysis import lockgraph
from tpukube_torch.sim import scenarios
from test_torch_cli import _capsys
from test_torch_lint import DYNAMIC, REF_ANALYSIS
from torch_twin import TMP_PATH, reference_tests, run_port

for _name in REF_ANALYSIS:
    importlib.import_module(f"tpukube.analysis.{_name}")

LOCKGRAPH_SKIPS = {
    "test_dynamic_detector_clean_across_sim_scenarios":
        "asserts edges between the reference's files by name "
        "(tpukube/sched/...); "
        "test_dynamic_detector_clean_across_sim_scenarios_on_the_port "
        "asserts the port's (tpukube_torch/sched/...)",
    **{fn.__name__: "static: tests/test_torch_lint.py"
       for fn in reference_tests(test_lint, {})
       if fn.__name__ not in DYNAMIC},
}


@pytest.mark.parametrize("fn", reference_tests(test_lint, LOCKGRAPH_SKIPS),
                         ids=lambda f: f.__name__)
def test_reference_monitor_tests_hold_on_the_port(fn):
    run_port(fn, TMP_PATH)
    assert threading.Lock is lockgraph._REAL_LOCK
    assert threading.RLock is lockgraph._REAL_RLOCK


def test_dynamic_detector_clean_across_sim_scenarios_on_the_port():
    with lockgraph.monitor() as mon:
        for i in range(1, 8):
            scenarios.run(i, None)
    rep = mon.report()
    assert rep["cycles"] == [], rep["cycles"]
    assert rep["acquisitions"] > 1000
    edges = {(e["from"].rsplit(":", 1)[0], e["to"].rsplit(":", 1)[0])
             for e in rep["edges"]}
    assert ("tpukube_torch/sched/extender.py",
            "tpukube_torch/sched/gang.py") in edges
    assert ("tpukube_torch/sched/gang.py",
            "tpukube_torch/sched/state.py") in edges
    # every site is named from the package's parent directory, whatever
    # the checkout's path
    assert all(site.startswith("tpukube_torch/") for site in rep["sites"])
    assert threading.Lock is lockgraph._REAL_LOCK


# -- the federated report over worker daemons -----------------------------------

SCENARIO14_PROC_ENV = {"TPUKUBE_SHARD_SLICES": "2",
                       "TPUKUBE_SIM_MESH_DIMS": "4,4,4",
                       "TPUKUBE_PLANNER_REPLICAS": "2",
                       "TPUKUBE_KILONODE100K_PODS": "400",
                       "TPUKUBE_SHARD_TRANSPORT": "subprocess"}


@pytest.mark.parametrize("monitor", [True, False], ids=["on", "off"])
def test_scenario14_over_worker_daemons_under_the_monitor(monitor,
                                                          monkeypatch):
    # each worker installs the monitor before its Extender is built (its
    # config says lock_monitor); its edges reach the router through
    # /worker/summary's lock_graph row and merge into one cycle check
    for k, v in SCENARIO14_PROC_ENV.items():
        monkeypatch.setenv(k, v)
    if monitor:
        monkeypatch.setenv("TPUKUBE_LOCK_MONITOR", "1")
    else:
        monkeypatch.delenv("TPUKUBE_LOCK_MONITOR", raising=False)
    got = scenarios.run(14)
    assert got["pods_total"] >= 400 and got["ledger_divergence"] == 0
    assert all(r["alive"] for r in got["shard"]["replicas"])
    if not monitor:
        assert "lock_graph" not in got["shard"]
        return
    lg = got["shard"]["lock_graph"]
    assert lg["cycles"] == [], lg["cycles"]
    assert lg["replicas_reporting"] == ["r0", "r1"]
    # the workers' own acquisitions are merged: more than the router's
    # process alone makes over the in-process transport
    monkeypatch.setenv("TPUKUBE_SHARD_TRANSPORT", "inprocess")
    inproc = scenarios.run(14)["shard"]["lock_graph"]
    assert lg["acquisitions"] > inproc["acquisitions"] > 0
    assert lg["edge_count"] > inproc["edge_count"]
    assert threading.Lock is lockgraph._REAL_LOCK


# -- cli sim -------------------------------------------------------------------------

def test_cli_sim_carries_the_lock_graph(monkeypatch):
    from tpukube_torch import cli

    monkeypatch.setenv("TPUKUBE_LOCK_MONITOR", "1")
    with _capsys() as cap:
        assert cli.main(["sim", "2"]) == 0
    got = json.loads(cap.readouterr().out.strip().splitlines()[-1])
    assert got["scenario"] == 2
    lg = got["lock_graph"]
    assert lg["cycles"] == [] and lg["acquisitions"] > 0 and lg["edges"]
    assert threading.Lock is lockgraph._REAL_LOCK


def test_cli_sim_exits_1_on_a_cycle(monkeypatch):
    # two journals of the port locked against each other: one lock
    # class (one creation site) edges to itself, a cycle
    from tpukube_torch import cli
    from tpukube_torch.obs.events import EventJournal

    def inverted(n, config=None):
        a, b = EventJournal(), EventJournal()
        with a._lock, b._lock:
            pass
        return {"scenario": n}

    monkeypatch.setenv("TPUKUBE_LOCK_MONITOR", "1")
    monkeypatch.setattr(scenarios, "run", inverted)
    with _capsys() as cap:
        assert cli.main(["sim", "2"]) == 1
    got = json.loads(cap.readouterr().out.strip().splitlines()[-1])
    assert len(got["lock_graph"]["cycles"]) == 1
    assert got["lock_graph"]["cycles"][0][0].startswith(
        "tpukube_torch/obs/events.py:")
    assert threading.Lock is lockgraph._REAL_LOCK


def test_sites_are_named_from_the_package_parent():
    root = os.path.dirname(lockgraph.PACKAGE_DIR)
    assert lockgraph._trim(os.path.join(lockgraph.PACKAGE_DIR, "sched",
                                        "gang.py")) == "tpukube_torch/sched/gang.py"
    # outside the package's parent a path stays as it is
    assert lockgraph._trim("/elsewhere/x.py") == "/elsewhere/x.py"
    assert lockgraph.PACKAGE_SCOPE == os.path.join(root, "tpukube_torch") + os.sep
