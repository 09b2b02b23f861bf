"""The port's SLO evaluator (``tpukube_torch/obs/slo.py``), its ``obs
slo`` command and scenario 7 held against the reference's.

Twins (``run_twin``, both packages): test_slo.py, test_promlint.py, and
test_telemetry.py's scenario-7 test (test_slo.py's rules test reads the
router's process-transport series, which the port's router renders over
its worker daemons). The port's own: the
parser, the linter and the evaluator agree with the reference's on pages
of both packages; scenario 7 gives the reference's result."""

import contextlib
import json
import urllib.request

import pytest

import test_promlint
import test_slo
import test_telemetry
from tpukube.core.config import load_config as ref_load_config
from tpukube.obs import slo as ref_slo
from tpukube.sim import SimCluster as RefSimCluster
from tpukube.sim import scenarios as ref_scenarios
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.obs import slo
from tpukube_torch.sim import SimCluster
from tpukube_torch.sim import scenarios
from torch_refnative import use_private_tpuinfo
from torch_twin import REF_SIM_DEFAULTS, TMP_PATH, reference_tests, run_twin

use_private_tpuinfo()


@pytest.fixture
def fixtures(capsys):
    return {**TMP_PATH, "capsys": lambda g: contextlib.nullcontext(capsys)}


@pytest.mark.parametrize("fn", reference_tests(test_slo, {})
                         + reference_tests(test_promlint, {}),
                         ids=lambda f: f"{f.__module__}.{f.__name__}")
def test_reference_slo_tests_hold_on_the_port(fn, fixtures):
    # the reference's sim serves its HTTP app: two of these scrape it
    run_twin(fn, fixtures, serve_ref=True)


def test_reference_fault_telemetry_scenario_holds_on_the_port():
    run_twin(test_telemetry.test_fault_telemetry_scenario_end_to_end)


def test_scenario_7_gives_the_reference_result():
    want = ref_scenarios.run(7)
    got = scenarios.run(7)
    for r in (want, got):
        r.pop("wall_s")
    assert got == want


def _page(sim_cls, load, sim_kw) -> str:
    """A live /metrics page after binds, a gang and a fault, tenancy on."""
    cfg = load(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,1",
                    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                    "TPUKUBE_TENANCY_ENABLED": "1",
                    "TPUKUBE_TENANCY_QUOTAS": "a=chips:4,hbm:0.5"})
    with sim_cls(cfg, **sim_kw) as c:
        for i in range(3):
            c.schedule(c.make_pod(f"a-{i}", tpu=1,
                                  labels={"tpu.qiniu.com/tenant": "a"}))
        group = PodGroup("g", min_member=4)
        for i in range(4):
            c.schedule(c.make_pod(f"g-{i}", tpu=1, priority=5, group=group))
        c.inject_fault("host-0-0-0", 0)
        with urllib.request.urlopen(f"{c.base_url}/metrics", timeout=10) as r:
            return r.read().decode()


@pytest.fixture(scope="module")
def pages():
    return {"port": _page(SimCluster, load_config, {}),
            "ref": _page(RefSimCluster, ref_load_config, {})}


@pytest.mark.parametrize("which", ["port", "ref"])
def test_parser_linter_and_evaluator_agree_with_the_reference(pages, which):
    text = pages[which]
    # a re-opened family and a bad label line, so the linter has
    # something to say
    bad = text + 'tpukube_events_total{reason="x"} 1\nm{k=unquoted} 1\n'
    assert slo.validate_exposition(text) == ref_slo.validate_exposition(text) == []
    assert slo.validate_exposition(bad) == ref_slo.validate_exposition(bad) != []
    assert ([tuple(vars(s).values()) for s in slo.parse_metrics(text)]
            == [tuple(vars(s).values()) for s in ref_slo.parse_metrics(text)])
    assert slo.evaluate(text) == ref_slo.evaluate(text)
    assert (slo.evaluate(text, prev_text=pages["port"], window_seconds=30)
            == ref_slo.evaluate(text, prev_text=pages["port"],
                                window_seconds=30))
    names = {s.name for s in slo.parse_metrics(text)}
    assert "tpukube_tenant_chips_used" in names
    assert "tpukube_tenant_admission_seconds_bucket" in names


def test_tenancy_families_render_as_the_reference(pages):
    """The tenant families' TYPE/HELP lines and label sets are the
    reference's (values aside: HBM bytes and latencies differ)."""
    def shape(text: str) -> list:
        out = []
        for line in text.splitlines():
            if "tenan" not in line:
                continue
            if line.startswith("#"):
                out.append(line)
            else:
                sample = slo.parse_metrics(line)[0]
                out.append((sample.name, sample.labels))
        return out

    assert shape(pages["port"]) == shape(pages["ref"])
    assert shape(pages["port"])


def test_promql_names_agree_with_the_reference():
    for expr in ('sum(rate(gang_schedule_latency_seconds_bucket{le="2.5"}[5m]))'
                 ' / sum(rate(gang_schedule_latency_seconds_bucket'
                 '{le="+Inf"}[5m]))',
                 'histogram_quantile(0.99, sum by (le, handler) '
                 '(rate(tpukube_webhook_latency_seconds_bucket[5m])))',
                 "tpukube:gang_burn:ratio_rate5m > (14.4 * 0.01)"):
        assert slo.referenced_metric_names(expr) == \
            ref_slo.referenced_metric_names(expr)
    assert [vars(s) for s in slo.DEFAULT_SLOS] == \
        [vars(s) for s in ref_slo.DEFAULT_SLOS]
    assert slo.MULTIWINDOW_ALERTS == ref_slo.MULTIWINDOW_ALERTS


def test_obs_slo_live_scrape_matches_the_reference_cli(capsys):
    """``obs slo --url`` of both packages' tools on one live page."""
    from tpukube import cli as ref_cli
    from tpukube_torch import cli

    cfg = load_config(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,1"})
    with SimCluster(cfg) as c:
        group = PodGroup("g", min_member=4)
        for i in range(4):
            c.schedule(c.make_pod(f"g-{i}", tpu=1, group=group))
        url = f"{c.base_url}/metrics"
        rc = cli.main_obs(["slo", "--url", url])
        got = json.loads(capsys.readouterr().out)
        ref_rc = ref_cli.main_obs(["slo", "--url", url])
        want = json.loads(capsys.readouterr().out)
    assert rc == ref_rc
    assert (got["gang-schedule-latency"]["total"]
            == want["gang-schedule-latency"]["total"] == 1.0)
    assert set(got) == set(want) == {s.name for s in slo.DEFAULT_SLOS}
