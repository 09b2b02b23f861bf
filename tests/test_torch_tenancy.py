"""The port's multi-tenant serving plane (``tpukube_torch/tenancy``) held
against the reference's.

Twins (``run_twin``, both packages, decision by decision): every case of
test_tenancy.py but the four admission-feed tests, which
tests/test_torch_cycle.py twins. The port's own: scenario 11 gives the
reference's share ratio, sheds and denials by tenant, preemptions and
utilization; the tenancy config keys load and refuse as the reference's;
the same decisions with tenancy on write byte-identical WAL files on
both packages, and each package recovers the other's with the same
tenants; the DRF order and the overshare map equal the reference's on
random queues; a tenant's usage survives the port's extender daemon
restart (chip_smoke.py's step 16b at a small size, on the CPU)."""

import contextlib
import random

import pytest

import test_tenancy
from tpukube.core import codec as ref_codec
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.sched import journal as ref_journal
from tpukube.sched import kube as ref_kube
from tpukube.sched.extender import Extender as RefExtender
from tpukube.sim import SimCluster as RefSimCluster
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch.core import codec
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.sched import journal
from tpukube_torch.sched import kube
from tpukube_torch.sched.extender import Extender
from tpukube_torch.sim import SimCluster
from tpukube_torch.sim import scenarios
from torch_refnative import use_private_tpuinfo
from torch_twin import (
    REF_SIM_DEFAULTS,
    reference_cases,
    run_twin,
    value_fixtures,
)

use_private_tpuinfo()

TENANCY_SKIPS = {
    name: "twinned in tests/test_torch_cycle.py"
    for name in ("test_pod_admission_feed_routes_pending_pods_into_the_queue",
                 "test_pod_admission_feed_is_noop_without_batching",
                 "test_informer_fed_pods_plan_and_bind_end_to_end",
                 "test_informer_redelivery_never_replans_an_assumed_allocation")
}
FIXTURES = {"monkeypatch": lambda g: pytest.MonkeyPatch.context()}
LABEL = "tpu.qiniu.com/tenant"


@pytest.mark.parametrize("fn,params",
                         reference_cases(test_tenancy, TENANCY_SKIPS))
def test_reference_tenancy_tests_hold_on_the_port(fn, params):
    run_twin(fn, {**FIXTURES, **value_fixtures(params)})


# -- scenario 11 ------------------------------------------------------------

# the fields the reference's scenario-11 test asserts, plus the numbers
# its result reports per tenant (HBM bytes aside: each package's default
# memory per card differs, and the HBM quotas are fractions of it)
SCENARIO11_SAME = ("value", "waves", "sim_hours", "pods_placed",
                   "preemptions", "quota_violations", "sheds_by_tenant",
                   "quota_denials_by_tenant", "shed_events_journaled",
                   "denial_events_journaled", "gangs_committed",
                   "steady_utilization_min_percent", "leaked_reservations",
                   "ledger_divergence")


def _tenants_without_hbm(result: dict) -> dict:
    return {t: {k: v for k, v in doc.items() if k != "hbm_used_bytes"}
            for t, doc in result["tenants"].items()}


def test_scenario_11_gives_the_reference_results(monkeypatch):
    monkeypatch.setenv("TPUKUBE_TENANCY_WAVES", "7")
    monkeypatch.setenv("TPUKUBE_CHAOS_SEED", "1337")
    monkeypatch.delenv("TPUKUBE_TENANCY_ENABLED", raising=False)
    # both scenarios turn decision provenance on, so each result carries
    # the explain_shed check of a shed pod's provenance
    got = scenarios.run(11)
    want = ref_scenarios.run(11)
    assert {k: got[k] for k in SCENARIO11_SAME} == \
        {k: want[k] for k in SCENARIO11_SAME}
    assert _tenants_without_hbm(got) == _tenants_without_hbm(want)
    assert got["explain_shed"] == want["explain_shed"]
    assert got["explain_shed"]["verdict"] == "denied"
    assert got["explain_shed"]["slo_named"] is True
    assert got["decisions"]["recorded"] > 0
    assert got["preemptions"] > 0 and got["quota_violations"] == 0
    assert sum(got["sheds_by_tenant"].values()) > 0


def test_scenario_11_runs_from_the_cli(monkeypatch, capsys):
    import json

    from tpukube_torch import cli

    monkeypatch.setenv("TPUKUBE_TENANCY_WAVES", "3")
    assert cli.main_sim(["11"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["scenario"] == 11 and doc["quota_violations"] == 0


# -- config -----------------------------------------------------------------

TENANCY_KEYS = ("tenancy_enabled", "tenancy_label", "tenancy_default_tenant",
                "tenancy_quotas", "tenancy_burn_threshold",
                "tenancy_burn_window_seconds", "tenancy_shed_priority_max")


@pytest.mark.parametrize("env", [
    {},
    {"TPUKUBE_TENANCY_ENABLED": "1"},
    {"TPUKUBE_TENANCY_ENABLED": "true",
     "TPUKUBE_TENANCY_QUOTAS": "a=chips:16,hbm:0.25;b=chips:0.5",
     "TPUKUBE_TENANCY_LABEL": "example.com/team",
     "TPUKUBE_TENANCY_DEFAULT_TENANT": "shared",
     "TPUKUBE_TENANCY_BURN_THRESHOLD": "0",
     "TPUKUBE_TENANCY_BURN_WINDOW_SECONDS": "3600",
     "TPUKUBE_TENANCY_SHED_PRIORITY_MAX": "10"},
], ids=["defaults", "enabled", "every-knob"])
def test_tenancy_keys_load_as_the_reference(env):
    got, want = load_config(env=env), ref_load_config(env=env)
    for name in TENANCY_KEYS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("env,match", [
    ({"TPUKUBE_TENANCY_QUOTAS": "a=chips:4"}, "tenancy_enabled"),
    ({"TPUKUBE_TENANCY_ENABLED": "1", "TPUKUBE_TENANCY_QUOTAS": "a=1"},
     "tenancy_quotas"),
    ({"TPUKUBE_TENANCY_ENABLED": "1", "TPUKUBE_TENANCY_QUOTAS": "a=hbm:2"},
     "hbm cap"),
    ({"TPUKUBE_TENANCY_ENABLED": "1", "TPUKUBE_TENANCY_LABEL": ""},
     "tenancy_label"),
    ({"TPUKUBE_TENANCY_BURN_THRESHOLD": "-1"}, "tenancy_burn_threshold"),
    ({"TPUKUBE_TENANCY_BURN_WINDOW_SECONDS": "0"},
     "tenancy_burn_window_seconds"),
], ids=["quotas-without-plane", "bad-spec", "hbm-over-one", "empty-label",
        "negative-burn", "zero-window"])
def test_tenancy_keys_refused_as_the_reference(env, match):
    with pytest.raises(ValueError, match=match):
        ref_load_config(env=env)
    with pytest.raises(ValueError, match=match):
        load_config(env=env)


# -- the WAL with tenancy on ---------------------------------------------------

PORT = (SimCluster, load_config, PodGroup, {})
REF = (RefSimCluster, ref_load_config, RefPodGroup, {"in_process": True})


def _tenancy_env(wal: str) -> dict:
    return {**REF_SIM_DEFAULTS,
            "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
            "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
            "TPUKUBE_JOURNAL_ENABLED": "1",
            "TPUKUBE_JOURNAL_PATH": wal,
            "TPUKUBE_TENANCY_ENABLED": "1",
            "TPUKUBE_TENANCY_QUOTAS": "team-a=chips:6;team-b=chips:8"}


def _drive_tenants(pkg, wal: str, checkpoint_after: int = -1):
    """One decision sequence with tenancy on: a labelled gang (its
    reservation stamped with the tenant), labelled and unlabelled binds,
    a quota refusal, a completion; a synchronous checkpoint after the
    ``checkpoint_after``-th step. Returns the sim, its allocations and
    its tenants' usage."""
    sim_cls, load, group_cls, kw = pkg
    c = sim_cls(load(env=_tenancy_env(wal)), **kw)
    group = group_cls("tg", min_member=4)

    def refused(name: str) -> None:
        with pytest.raises(RuntimeError, match="quota"):
            c.schedule(c.make_pod(name, tpu=1, labels={LABEL: "team-a"}))

    steps = [lambda i=i: c.schedule(c.make_pod(
        f"tg-{i}", tpu=1, priority=10, group=group, labels={LABEL: "team-b"}))
        for i in range(4)]
    steps += [lambda i=i: c.schedule(c.make_pod(
        f"a-{i}", tpu=1, labels={LABEL: "team-a"})) for i in range(6)]
    steps += [lambda: refused("a-6"),
              lambda: c.schedule(c.make_pod("bare", tpu=2)),
              lambda: c.complete_pod("a-0"),
              lambda: c.schedule(c.make_pod("a-7", tpu=1,
                                            labels={LABEL: "team-a"}))]
    for n, step in enumerate(steps):
        step()
        c.extender.journal.sync()
        if n == checkpoint_after:
            c.extender.journal.write_checkpoint_sync(
                c.extender.checkpoint_doc())
    allocs = sorted((a.pod_key, a.node_name, tuple(a.device_ids),
                     tuple(sorted(a.env.items())))
                    for a in c.extender.state.allocations())
    usage = _usage(c.extender)
    c.extender.journal.close()
    c.extender.state.retire()
    return c, allocs, usage


def _usage(ext) -> dict:
    snap = ext.tenants.ledger.usage()
    return {t: (u.chips, u.pods, u.burst_chips, dict(u.by_slice))
            for t, u in sorted(snap.usage.items())}


@pytest.mark.parametrize("checkpoint_after", [-1, 7])
def test_tenancy_on_writes_the_reference_journal(tmp_path, checkpoint_after):
    wals = {}
    usage = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        (tmp_path / name).mkdir()
        wals[name] = str(tmp_path / name / "wal.jsonl")
        _, _, usage[name] = _drive_tenants(pkg, wals[name], checkpoint_after)
    with open(wals["ref"], "rb") as a, open(wals["port"], "rb") as b:
        ref_wal, port_wal = a.read(), b.read()
    assert port_wal == ref_wal
    assert usage["port"] == usage["ref"]
    assert usage["port"]["team-a"][0] == 6.0  # the quota, not one more
    if checkpoint_after < 0:
        # the gang's reservation record carries its tenant
        assert b'"tenant":"team-b"' in port_wal
    else:
        # the checkpoint holds the reservation (and the WAL only its tail)
        ckpts = [open(w + ".ckpt", "rb").read().splitlines()
                 for w in (wals["ref"], wals["port"])]
        assert ckpts[0][1:] == ckpts[1][1:]
        assert b'"tenant":"team-b"' in ckpts[1][0]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_recovers_the_others_tenants(tmp_path, writer, reader):
    wal = str(tmp_path / "wal.jsonl")
    c, want, want_usage = _drive_tenants(REF if writer == "ref" else PORT,
                                         wal, checkpoint_after=3)
    store = c._store_api
    if reader == "ref":
        ext = RefExtender(ref_load_config(env=_tenancy_env(wal)))
        stats = ref_journal.recover_extender(ext, store)
    else:
        ext = Extender(load_config(env=_tenancy_env(wal)))
        stats = journal.recover_extender(ext, store)
    try:
        got = sorted((a.pod_key, a.node_name, tuple(a.device_ids),
                      tuple(sorted(a.env.items())))
                     for a in ext.state.allocations())
        got_usage = _usage(ext)
        tenants = [res.tenant for res in ext.gang.snapshot()]
    finally:
        ext.journal.close()
        ext.state.retire()
    assert stats["mode"] == "warm" and stats["divergences"] == 0
    assert got == want
    assert got_usage == want_usage
    assert tenants == ["team-b"]


# -- DRF order and the overshare map on random queues --------------------------

def _queue(pkg_kube, codec, group_cls, seed: int) -> list:
    rng = random.Random(seed)
    entries = []
    for seq in range(40):
        tenant = rng.choice(["a", "b", "c", None])
        labels = {LABEL: tenant} if tenant else {}
        annotations = {}
        if rng.random() < 0.25:
            annotations = codec.pod_group_annotations(
                group_cls(f"g{rng.randrange(3)}", min_member=2))
        obj = {"metadata": {"name": f"p{seq}", "namespace": "default",
                            "uid": f"u{seq}", "labels": labels,
                            "annotations": annotations},
               "spec": {"priority": rng.choice([0, 0, 5, 10]),
                        "containers": [{"name": "main", "resources": {
                            "requests": {"qiniu.com/tpu":
                                         str(rng.choice([1, 1, 2, 4]))}}}]}}
        entries.append((pkg_kube.pod_from_k8s(obj), seq, None))
    rng.shuffle(entries)
    return entries


def _orders(sim_cls, load, pkg_kube, codec, group_cls, sim_kw, seed: int):
    cfg = load(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,2",
                    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                    "TPUKUBE_TENANCY_ENABLED": "1",
                    "TPUKUBE_TENANCY_QUOTAS": "a=chips:4;b=chips:24,hbm:0.5"})
    with sim_cls(cfg, **sim_kw) as c:
        rng = random.Random(seed)
        for i in range(rng.randrange(4, 12)):
            tenant = rng.choice(["a", "b", "c"])
            with contextlib.suppress(RuntimeError):
                c.schedule(c.make_pod(f"held-{i}", tpu=1,
                                      labels={LABEL: tenant}))
        plane = c.extender.tenants
        order = [e[0].key() for e in plane.drf_order(
            _queue(pkg_kube, codec, group_cls, seed))]
        return order, plane.overshare_map(), plane.stats()["tenants"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_drf_order_and_overshare_equal_the_reference(seed):
    want = _orders(RefSimCluster, ref_load_config, ref_kube, ref_codec,
                   RefPodGroup, {"in_process": True}, seed)
    got = _orders(SimCluster, load_config, kube, codec, PodGroup,
                  {"in_process": True}, seed)
    assert got == want


# -- the daemon restart, as chip_smoke.py's step 16b ---------------------------

def test_card_step_tenancy_life_on_a_sim_share_node():
    """chip_smoke.py's step 16b (``tenancy_life``) on the CPU: the
    two-share node agent on the sim backend and no card pods. team-a-1 is
    refused by quota while a share is free, the tenants' usage survives
    the daemon's restart, and team-a-1 takes team-a-0's share once it
    ends."""
    import chip_smoke

    got = chip_smoke.tenancy_life(
        lambda: chip_smoke.share_agent(host=chip_smoke.DAEMON_NODE))
    assert got["binds"] == {"team-a-0": ["tpu-0-frac0of2"],
                            "team-b-0": ["tpu-0-frac1of2"],
                            "team-a-1": ["tpu-0-frac0of2"]}
    assert "quota" in got["refusal"]
    assert got["shedding_before_refusal"] == 0
    assert got["quota_denials_metric"] == 1
    assert got["tenants_env"] == {"team-a-0": "team-a", "team-b-0": "team-b",
                                  "team-a-1": "team-a"}
    assert got["chips_used"] == {"team-a": 0.5, "team-b": 0.5}
    assert set(got["slo_burn"]) == {"gang-schedule-latency",
                                    "bind-webhook-latency"}
    assert got["restart_same_tenants"] and got["restart_same_allocs"]
