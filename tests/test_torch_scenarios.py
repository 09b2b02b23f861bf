"""The port's BASELINE scenario drives held against the reference's: the
same ``scenarios.run(n)`` on both packages, decisions compared exactly
(timing keys left out: they measure, they do not decide).

Two keys differ by design and are compared after the port's renaming:
scenario 1's env keys (CUDA visibility, as tests/test_torch_device.py
states it) and scenario 3's per-share memory limit, half of each
package's own default memory per card (80 GiB for an H100, 95 GiB for
the reference's chip)."""

import json

import pytest

import chip_smoke
from test_cycle import SCENARIO_KEYS
from tpukube.core.config import load_config as ref_load_config
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch.core.config import load_config
from tpukube_torch.sim import scenarios

# the port's Allocate env keys under the reference's names
ENV_RENAME = {"CUDA_VISIBLE_DEVICES": "TPU_VISIBLE_DEVICES"}
PORT_ONLY_ENV = {"CUDA_DEVICE_ORDER"}


@pytest.fixture
def batch_env(monkeypatch, request):
    monkeypatch.delenv("TPUKUBE_BATCH_ENABLED", raising=False)
    if request.param:
        monkeypatch.setenv("TPUKUBE_BATCH_ENABLED", "1")
    return request.param


def _as_reference(n: int, result: dict) -> dict:
    """The port's scenario-``n`` result under the reference's names and
    memory size."""
    out = dict(result)
    if n == 1:
        out["env_keys"] = sorted(ENV_RENAME.get(k, k) for k in out["env_keys"]
                                 if k not in PORT_ONLY_ENV)
    if n == 3:
        half = load_config(env={}).hbm_bytes_per_chip // 2
        ref_half = ref_load_config(env={}).hbm_bytes_per_chip // 2
        pods = []
        for p in out["pods"]:
            assert p["hbm_limit"] == str(half), p
            pods.append({**p, "hbm_limit": str(ref_half)})
        out["pods"] = pods
    return out


@pytest.mark.parametrize("batch_env", [False, True], ids=["legacy", "batching"],
                         indirect=True)
@pytest.mark.parametrize("n", sorted(SCENARIO_KEYS))
def test_scenario_matches_the_reference(n, batch_env):
    keys = SCENARIO_KEYS[n]
    want = ref_scenarios.run(n)
    got = _as_reference(n, scenarios.run(n))
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["scenario"] == n


def test_card_step_holds_the_reference_placement_keys():
    # chip_smoke's step 13a compares these keys with batching off and on
    assert chip_smoke.SCENARIO_KEYS == SCENARIO_KEYS


def test_churn_carries_phase_stats():
    # scenario 6's phases key (scenario 5's is held by test_obs.py's
    # twin): the port's decision trace is on by default
    phases = scenarios.run(6)["phases"]
    assert phases["filter"]["count"] > 0 and phases["bind"]["count"] > 0
    assert set(phases["bind"]) == {"count", "p50_ms", "p99_ms", "max_ms"}


# the cycle's count fields (its walls and per-pod plan time are timings)
CYCLE_COUNTS = ("enabled", "cycles", "pods_planned", "queue_depth",
                "plans_live", "assumes", "assume_undos", "fast_patches",
                "fast_rebuilds", "gang_batches", "gang_batch_members",
                "plan_hits", "plan_misses", "plan_hit_ratio",
                "last_batch_size", "batch_max_pods", "cycle_interval_seconds")
DRIVE_KEYS = ("metric", "nodes", "chips", "pods_total",
              "pods_sampled_full_protocol", "gang_committed",
              "ledger_divergence", "sim_seconds", "utilization_percent")


def _decisions(result: dict) -> dict:
    # resync is compared whole: both packages read their ledger through
    # the alloc change log (full once, then incremental), and the bytes
    # are encoded alloc lengths, equal as the codecs are byte-equal
    out = {k: result[k] for k in DRIVE_KEYS}
    out["resync"] = result["resync"]
    out["cycle"] = {k: result["cycle"][k] for k in CYCLE_COUNTS}
    if "snapshot" in result:
        out["snapshot"] = {k: result["snapshot"][k]
                           for k in ("delta_applies", "delta_overflows",
                                     "rebuilds")}
    return out


@pytest.mark.parametrize("n,knob,pods", [
    (10, "TPUKUBE_KILONODE_PODS", "1500"),
    (12, "TPUKUBE_KILONODE10K_PODS", "2500"),
])
def test_kilonode_drive_matches_the_reference(n, knob, pods, monkeypatch):
    monkeypatch.setenv(knob, pods)
    monkeypatch.delenv("TPUKUBE_BATCH_ENABLED", raising=False)
    want = ref_scenarios.run(n)
    got = scenarios.run(n)
    assert _decisions(got) == _decisions(want)
    assert got["pods_total"] == int(pods) and got["gang_committed"]
    assert got["ledger_divergence"] == 0
    assert set(got["resync"]) == {"full", "incremental", "bytes",
                                  "incremental_hit_ratio"}
    # one bootstrap full read; every later wave reads incrementally
    assert got["resync"]["full"] == 1
    assert set(got["webhook_p99_ms"]) == {"filter", "prioritize", "bind"}


def test_once_unported_scenario_14_runs_from_the_cli(monkeypatch, capsys):
    # scenario 14 raised while the shard router was not ported; it runs
    # now, from the port's CLI, at the reference's tier-1 smoke size
    # (tests/test_torch_shard.py holds it against the reference's)
    from tpukube_torch import cli

    for k, v in {"TPUKUBE_SHARD_SLICES": "2", "TPUKUBE_SIM_MESH_DIMS": "4,4,4",
                 "TPUKUBE_PLANNER_REPLICAS": "2",
                 "TPUKUBE_KILONODE100K_PODS": "400"}.items():
        monkeypatch.setenv(k, v)
    assert cli.main(["sim", "14"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["scenario"] == 14 and got["pods_total"] >= 400
    assert got["gang_committed"] and got["ledger_divergence"] == 0
    assert set(got["shard"]["slice_assignment"].values()) == {"r0", "r1"}
    assert "setup_s" in got and "lock_graph" not in got["shard"]


def test_once_unported_scenario_15_runs(monkeypatch):
    # scenario 15 raised while drain and the autoscaler were not ported;
    # all three phases run now (tests/test_torch_drain.py holds them
    # against the reference's), phase C on the shard router
    monkeypatch.setenv("TPUKUBE_MAINT_CYCLES", "2")
    got = scenarios.run(15)
    assert got["scenario"] == 15 and got["sharded"]["drained_slices"]
    assert got["storm"]["drains_completed"] >= 1
    assert got["autoscale"]["scale_ups"] == 1


def test_passthrough_of_the_lock_monitor_reaches_the_scenario(monkeypatch):
    # refused while the lock-order monitor was not ported: the knob
    # reaches scenario 2's SimCluster through the passthrough, which
    # installs the monitor; its lock graph is cycle-free
    from tpukube_torch.analysis import lockgraph

    installed = []
    install = lockgraph.install

    def recording(*args, **kw):
        installed.append(install(*args, **kw))
        return installed[-1]

    monkeypatch.setattr(lockgraph, "install", recording)
    monkeypatch.setenv("TPUKUBE_LOCK_MONITOR", "1")
    got = scenarios.run(2)
    assert got["scenario"] == 2 and installed
    rep = installed[0].report()
    assert rep["cycles"] == [] and rep["acquisitions"] > 0
    assert lockgraph.active() is None


def test_kilonode_drive_carries_the_capacity_keys(monkeypatch):
    # the capacity flight recorder on, a small scenario-12 slice on both
    # packages: the same utilization over time and stranded rollup; the
    # recorder's stats and its overhead share (wall-clock time, so a
    # number on both sides and not compared)
    for k, v in {"TPUKUBE_KILONODE10K_PODS": "2500",
                 "TPUKUBE_CAPACITY_ENABLED": "1",
                 "TPUKUBE_CAPACITY_SAMPLE_INTERVAL_SECONDS": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TPUKUBE_BATCH_ENABLED", raising=False)
    want = ref_scenarios.run(12)
    got = scenarios.run(12)
    assert got["utilization_over_time"] == want["utilization_over_time"]
    assert got["utilization_over_time"]
    assert got["stranded"] == want["stranded"]
    assert set(got["capacity"]) == set(want["capacity"])
    for side in (got, want):
        assert isinstance(side["capacity"]["overhead_pct"], float)
    assert got["capacity"]["samples"] == want["capacity"]["samples"] > 0
    assert got["capacity"]["enabled"] is True
