"""The port's batch scheduling cycle held against the reference's: the
reference's own tests/test_cycle.py runs on both packages (every bind of
``schedule()`` and of the batch driver ``schedule_pending()`` compared,
node, device ids and coords), the port's batch knobs against the
reference's ``load_config``, and the cycle's families on the port's
``/metrics``."""

import contextlib
import urllib.request

import pytest

import test_cycle
import test_tenancy
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.sim import SimCluster as RefSimCluster
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.sim import SimCluster
from torch_refnative import use_private_tpuinfo
from torch_twin import reference_tests, run_twin

use_private_tpuinfo()

# the reference's parametrized test, once per scenario
SCENARIO_TEST = "test_scenario_placements_bit_identical_with_batching"
FIXTURES = {"monkeypatch": lambda g: pytest.MonkeyPatch.context()}


@pytest.mark.parametrize(
    "fn",
    [f for f in reference_tests(test_cycle, {})
     if f.__name__ != SCENARIO_TEST],
    ids=lambda f: f.__name__)
def test_reference_cycle_tests_hold_on_the_port(fn):
    run_twin(fn, FIXTURES)


@pytest.mark.parametrize("scenario", sorted(test_cycle.SCENARIO_KEYS))
def test_reference_scenario_parity_test_holds_on_the_port(scenario):
    # legacy vs batched placements of one scenario, within each package
    run_twin(vars(test_cycle)[SCENARIO_TEST],
             {"scenario": lambda g: contextlib.nullcontext(scenario)})


# test_tenancy's tests of the pod informer's admission feed (batching on,
# tenancy off); the rest of that module is twinned in
# tests/test_torch_tenancy.py
ADMISSION_TESTS = (
    "test_pod_admission_feed_routes_pending_pods_into_the_queue",
    "test_pod_admission_feed_is_noop_without_batching",
    "test_informer_fed_pods_plan_and_bind_end_to_end",
    "test_informer_redelivery_never_replans_an_assumed_allocation",
)


@pytest.mark.parametrize("name", ADMISSION_TESTS)
def test_reference_admission_feed_tests_hold_on_the_port(name):
    run_twin(vars(test_tenancy)[name])


def _same_priority_batch(sim_cls, load, group_cls, sim_kw):
    """Strays admitted before an equal-priority gang, in one driver batch:
    the queue plans gangs ahead of strays within a priority band, so the
    gang takes its box before the strays fragment the mesh."""
    cfg = load(env={"TPUKUBE_SIM_MESH_DIMS": "4,4,2",
                    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                    "TPUKUBE_BATCH_ENABLED": "1"})
    with sim_cls(cfg, **sim_kw) as c:
        strays = [c.make_pod(f"stray-{i}", tpu=1) for i in range(12)]
        group = group_cls("band", min_member=8)
        gang = [c.make_pod(f"band-{i}", tpu=1, group=group) for i in range(8)]
        placed = c.schedule_pending(strays + gang)
        return {k: (node, list(a.device_ids), [tuple(x) for x in a.coords])
                for k, (node, a) in placed.items()}


def test_driver_batch_plans_the_gang_before_equal_priority_strays():
    want = _same_priority_batch(RefSimCluster, ref_load_config, RefPodGroup,
                                {"in_process": True})
    got = _same_priority_batch(SimCluster, load_config, PodGroup, {})
    assert got == want
    coords = [c for k, (_, _, cs) in got.items() if "band" in k for c in cs]
    ext = [max(c[a] for c in coords) - min(c[a] for c in coords) + 1
           for a in range(3)]
    assert ext[0] * ext[1] * ext[2] == len(coords) == 8  # one box


def _plan_after_bind(sim_cls, load, pod_from_k8s, render, sim_kw):
    """A pod admitted again after its bind consumed its plan (the feed's
    re-delivery of the bind effector's annotation PATCH), then one more
    batch cycle, then the pod's release: what the refused commit leaves."""
    cfg = load(env={"TPUKUBE_SIM_MESH_DIMS": "2,2,1",
                    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                    "TPUKUBE_BATCH_ENABLED": "1"})
    with sim_cls(cfg, **sim_kw) as c:
        ext, obj = c.extender, c.make_pod("p", tpu=1)
        pod, key = pod_from_k8s(obj), "default/p"

        def seen():
            binds = [ln for ln in render(ext).splitlines()
                     if ln.startswith("tpukube_binds_total ")]
            s = ext.cycle.stats()
            return {"alloc": ext.state.allocation(key) and
                    list(ext.state.allocation(key).device_ids),
                    "binds": binds, "assumes": s["assumes"],
                    "plans_live": s["plans_live"], "queue": s["queue_depth"],
                    "planned_node": ext.planned_node(key)}

        node, alloc = c.schedule(obj)
        out = {"bound": seen(), "readmitted": ext.admit(pod)}
        out["planned"] = ext.plan_pending()
        out["replanned"] = seen()
        ext.release(key)
        out["released"] = seen()
        return out


def test_plan_after_bind_is_refused_without_side_effects():
    from tpukube.metrics import render_extender_metrics as ref_render
    from tpukube.sched.kube import pod_from_k8s as ref_pod_from_k8s
    from tpukube_torch.metrics import render_extender_metrics
    from tpukube_torch.sched.kube import pod_from_k8s

    want = _plan_after_bind(RefSimCluster, ref_load_config, ref_pod_from_k8s,
                            ref_render, {"in_process": True})
    got = _plan_after_bind(SimCluster, load_config, pod_from_k8s,
                           render_extender_metrics, {"in_process": True})
    assert got == want
    bound = {"alloc": ["tpu-0"], "binds": ["tpukube_binds_total 1"],
             "assumes": 1, "plans_live": 0, "queue": 0, "planned_node": None}
    assert got["bound"] == bound
    # the feed queues the bound pod again and the cycle plans it; its
    # commit is refused: no second assume, no second bind, the
    # allocation untouched, the queue drained
    assert got["readmitted"] is True and got["planned"] == 1
    assert got["replanned"] == {**bound, "plans_live": 1,
                                "planned_node": "host-0-0-0"}
    # the refused plan lives until the pod's release, and goes with it
    assert got["released"] == {**bound, "alloc": None, "plans_live": 0}


@pytest.mark.parametrize("env", [
    {},
    {"TPUKUBE_BATCH_ENABLED": "1"},
    {"TPUKUBE_BATCH_ENABLED": "true", "TPUKUBE_BATCH_MAX_PODS": "2048",
     "TPUKUBE_CYCLE_INTERVAL_SECONDS": "0.25"},
    {"TPUKUBE_BATCH_ENABLED": "1", "TPUKUBE_FILTER_FROM_PLAN": "1"},
], ids=["defaults", "batch", "knobs", "filter-from-plan"])
def test_batch_knobs_load_as_the_reference(env):
    got, want = load_config(env=env), ref_load_config(env=env)
    for name in ("batch_enabled", "batch_max_pods", "cycle_interval_seconds",
                 "filter_from_plan"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("env,match", [
    ({"TPUKUBE_BATCH_MAX_PODS": "0"}, "batch_max_pods"),
    ({"TPUKUBE_CYCLE_INTERVAL_SECONDS": "-1"}, "cycle_interval_seconds"),
    ({"TPUKUBE_FILTER_FROM_PLAN": "1"}, "filter_from_plan requires batch_enabled"),
], ids=["max-pods", "interval", "filter-without-batch"])
def test_batch_knobs_refused_as_the_reference(env, match):
    with pytest.raises(ValueError, match=match):
        ref_load_config(env=env)
    with pytest.raises(ValueError, match=match):
        load_config(env=env)


# the five families the reference's metrics-and-statusz test asserts
CYCLE_SERIES = ("tpukube_cycles_total", "tpukube_cycle_plan_hits_total",
                "tpukube_cycle_pods_planned_total",
                "tpukube_cycle_wall_seconds_bucket",
                "tpukube_cycle_queue_depth")


@pytest.mark.parametrize("batch", [True, False], ids=["batching", "legacy"])
def test_cycle_families_render_only_when_batching(batch):
    env = {"TPUKUBE_SIM_MESH_DIMS": "4,4,2", "TPUKUBE_SIM_HOST_BLOCK": "2,2,1"}
    if batch:
        env["TPUKUBE_BATCH_ENABLED"] = "1"
    with SimCluster(load_config(env=env)) as c:
        c.schedule(c.make_pod("m-0", tpu=1))
        with urllib.request.urlopen(f"{c.base_url}/metrics", timeout=5) as r:
            text = r.read().decode()
        if batch:
            for series in CYCLE_SERIES:
                assert series in text, series
            stats = c.extender.cycle.stats()
            assert stats["pods_planned"] == 1 and stats["plan_hits"] >= 2
            assert "tpukube_cycle_plan_hits_total 2" in text
        else:
            assert "tpukube_cycle" not in text  # default exposition untouched
            assert c.extender.cycle is None
