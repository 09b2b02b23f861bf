"""The port's capacity analytics plane (``tpukube_torch/obs/capacity.py``,
``/capacity``, ``/capacity/probe`` and ``obs capacity``) held against the
reference's.

Twins (``run_twin``, both packages, decision by decision): test_capacity.py
whole, the shard router's federated ``/capacity`` included. The
port's own: on one sim sequence (fragmented, unhealthy, draining and
quota demands) the stranded taxonomy, ``/capacity`` and
``/capacity/probe`` answer as the reference's; the query validation and
error codes of both routes are the reference's; the capacity families
render as the reference's; and ``obs capacity`` (capture files,
``--merge``, ``--url``, probes, the three formats) prints and exits as the
reference's tool."""

import contextlib
import json
import urllib.error
import urllib.request

import pytest

import test_capacity
from tpukube import cli as ref_cli
from tpukube.core.config import load_config as ref_load_config
from tpukube.core.types import PodGroup as RefPodGroup
from tpukube.core.clock import FakeClock as RefFakeClock
from tpukube.sim import SimCluster as RefSimCluster
from tpukube_torch import cli
from tpukube_torch.core.clock import FakeClock
from tpukube_torch.core.config import load_config
from tpukube_torch.core.types import PodGroup
from tpukube_torch.obs import capacity, slo
from tpukube_torch.sim import SimCluster
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
                         reference_cases(test_capacity, {}))
def test_reference_capacity_tests_hold_on_the_port(fn, params):
    run_twin(fn, {**TMP_PATH, **value_fixtures(params)})


# -- one sim sequence on both packages ---------------------------------------------

PORT = (SimCluster, load_config, PodGroup, FakeClock, {})
REF = (RefSimCluster, ref_load_config, RefPodGroup, RefFakeClock, {})
LABEL = "tpu.qiniu.com/tenant"


def _strip_clock(doc):
    """A /capacity answer without its wall-clock fields (``ts``, the
    recorder's measured ``sample_seconds``)."""
    doc = json.loads(json.dumps(doc))
    for s in doc.get("samples", ()):
        s.pop("ts", None)
    doc.get("stats", {}).pop("sample_seconds", None)
    return doc


def _get(base: str, path: str):
    try:
        with urllib.request.urlopen(f"{base}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


PROBES = ("/capacity/probe?count=4", "/capacity/probe?count=16",
          "/capacity/probe?shape=2x2x1", "/capacity/probe?shape=4x4x2",
          "/capacity/probe?count=6&cpp=2", "/capacity/probe",
          "/capacity/probe?count=x", "/capacity/probe?shape=4x4",
          "/capacity/probe?count=0", "/capacity/probe?shape=0x1x1",
          "/capacity/probe?count=4&cpp=y", "/capacity?since=15m",
          "/capacity?since=soon", "/capacity?since=1",
          "/capacity?since=0.5m")


def _drive(pkg) -> dict:
    """A 4x4x2 fleet with capacity, drain, tenancy quotas and the fake
    clock: fillers fragment it and a chip goes unhealthy; gangs that are
    fragmented, unhealthy-bound and too big, and a tenant past its quota,
    are refused through /filter; then every node drains and a gang is
    refused; then /capacity, the probes and /statusz over HTTP."""
    sim_cls, load, group_cls, clock_cls, kw = pkg
    cfg = load(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,2",
                    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                    "TPUKUBE_CAPACITY_ENABLED": "1",
                    "TPUKUBE_CAPACITY_SAMPLES": "64",
                    "TPUKUBE_DRAIN_ENABLED": "1",
                    "TPUKUBE_TENANCY_ENABLED": "1",
                    "TPUKUBE_TENANCY_QUOTAS": "team-q=chips:1"})
    out: dict = {}
    with sim_cls(cfg, clock=clock_cls(), **kw) as c:
        cap = c.extender.capacity
        test_capacity._fragment(c)
        c.inject_fault("host-1-1-0", 0)
        c.schedule(c.make_pod("sync", tpu=1))
        c.schedule(c.make_pod("q-0", tpu=1, labels={LABEL: "team-q"}))
        refused = [c.make_pod("q-1", tpu=1, labels={LABEL: "team-q"})]
        for name, n in (("frag", 12), ("heal", 14), ("big", 24)):
            refused.append(c.make_pod(f"{name}-0", tpu=1,
                                      group=group_cls(name, min_member=n)))
        for obj in refused:
            with contextlib.suppress(RuntimeError):
                c.schedule(obj)
        c.advance(30.0)
        cap.sample_now()
        c.extender.drain.begin(c.extender.state.node_names(), reason="mx")
        with contextlib.suppress(RuntimeError):
            c.schedule(c.make_pod("late-0", tpu=1,
                                  group=group_cls("late", min_member=4)))
        c.advance(30.0)
        cap.sample_now()
        out["unschedulable"] = cap.unschedulable_counts()
        out["by_reason"] = cap.stranded_by_reason()
        out["capacity"] = _strip_clock(_get(c.base_url, "/capacity")[1])
        for path in PROBES:
            status, body = _get(c.base_url, path)
            if isinstance(body, dict):
                body = (body if "/probe" in path
                        else len(body["samples"]))
            out[path] = (status, body)
        status, doc = _get(c.base_url, "/statusz")
        doc["capacity"].pop("sample_seconds")
        out["statusz"] = (status, doc["capacity"], doc["drain"])
    return out


def test_capacity_routes_and_taxonomy_answer_as_the_reference():
    got, want = _drive(PORT), _drive(REF)
    assert got == want
    # every geometric reason, and the tenancy one, came up
    assert got["unschedulable"] == {"fragmented": 1, "unhealthy": 1,
                                    "capacity": 1, "quota": 1,
                                    "draining": 1}
    assert got["/capacity/probe?count=4"][0] == 200
    assert got["/capacity/probe"][0] == 400
    assert got["/capacity?since=soon"][0] == 400


def _capacity_page(sim_cls, load, sim_kw) -> str:
    cfg = load(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,2",
                    "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                    "TPUKUBE_CAPACITY_ENABLED": "1"})
    with sim_cls(cfg, **sim_kw) as c:
        test_capacity._fragment(c)
        with contextlib.suppress(RuntimeError):
            c.schedule(c.make_pod("g-0", tpu=1,
                                  group=(PodGroup if sim_cls is SimCluster
                                         else RefPodGroup)("g", min_member=16)))
        c.extender.capacity.sample_now()
        with urllib.request.urlopen(f"{c.base_url}/metrics", timeout=10) as r:
            return r.read().decode()


def test_capacity_families_render_as_the_reference():
    """The capacity families' TYPE/HELP lines, label sets and values (the
    measured overhead aside) are the reference's."""
    def shape(text: str) -> list:
        out = []
        for line in text.splitlines():
            if ("tpukube_capacity" not in line
                    and "tpukube_unschedulable" not in line):
                continue
            if line.startswith("#"):
                out.append(line)
            else:
                s = slo.parse_metrics(line)[0]
                out.append((s.name, s.labels,
                            None if "seconds" in s.name else s.value))
        return out

    got = shape(_capacity_page(SimCluster, load_config, {}))
    want = shape(_capacity_page(RefSimCluster, ref_load_config, {}))
    assert got == want
    assert len([x for x in got if isinstance(x, str)
                and x.startswith("# TYPE")]) == 7


def test_capacity_routes_404_with_the_plane_off():
    for sim_cls, load in ((SimCluster, load_config),
                          (RefSimCluster, ref_load_config)):
        with sim_cls(load(env=REF_SIM_DEFAULTS)) as c:
            for path in ("/capacity", "/capacity/probe?count=4"):
                status, body = _get(c.base_url, path)
                assert status == 404
                assert "capacity_enabled" in body


# -- obs capacity on both packages' tools --------------------------------------------

def _samples(path, n: int, t0: float, replica_util: float) -> None:
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({
                "ts": t0 + i, "clock": float(i),
                "fleet": {"utilization": replica_util * (i + 1) / n,
                          "free_chips": 10 - i, "blocked_free_chips": 8 - i},
                "queue": {"depth": i, "oldest_age_s": None},
                "slices": {"s0": {"largest_free_box": 4}},
                "stranded": {"chips_requested": i},
            }, sort_keys=True) + "\n")


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    d = tmp_path_factory.mktemp("capacity")
    paths = [d / "r0.jsonl", d / "r1.jsonl"]
    _samples(paths[0], 6, 1.7e9, 0.8)
    _samples(paths[1], 4, 1.7e9 + 0.5, 0.4)
    return [str(p) for p in paths]


OBS_CASES = {
    "one-file": lambda f: ["capacity", f[0]],
    "csv": lambda f: ["capacity", f[0], "--format", "csv"],
    "json": lambda f: ["capacity", f[0], "--format", "json"],
    "since": lambda f: ["capacity", f[0], "--since", "3"],
    "merge": lambda f: ["capacity", "--merge", *f],
    "merge-csv": lambda f: ["capacity", "--merge", *f, "--format", "csv"],
    "two-without-merge": lambda f: ["capacity", *f],
    "nothing": lambda f: ["capacity"],
    "probe-without-url": lambda f: ["capacity", f[0], "--probe-count", "4"],
}


def _run(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    got = capsys.readouterr()
    return rc, got.out


@pytest.mark.parametrize("case", sorted(OBS_CASES))
def test_obs_capacity_files_as_the_reference_tool(case, captures, capsys):
    argv = OBS_CASES[case](captures)
    got = _run(cli.main_obs, argv, capsys)
    want = _run(ref_cli.main_obs, argv, capsys)
    assert got == want
    assert (got[0] == 0) == (case not in ("two-without-merge", "nothing",
                                          "probe-without-url"))


def test_obs_capacity_url_and_probes_as_the_reference_tool(capsys):
    """``obs capacity --url`` against a live port extender, each
    package's tool: the rendering, the probe documents and the exit
    codes (0 only when the probe fits)."""
    cfg = load_config(env={**REF_SIM_DEFAULTS, "TPUKUBE_SIM_MESH_DIMS": "4,4,2",
                           "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                           "TPUKUBE_CAPACITY_ENABLED": "1"})
    with SimCluster(cfg) as c:
        test_capacity._fragment(c)
        with contextlib.suppress(RuntimeError):
            c.schedule(c.make_pod("g-0", tpu=1,
                                  group=PodGroup("g", min_member=16)))
        c.extender.capacity.sample_now()
        for argv in (["--format", "csv"], ["--probe-count", "8"],
                     ["--probe-count", "16"], ["--probe-shape", "1x4x2"],
                     ["--probe-shape", "4x4x2"]):
            full = ["capacity", "--url", c.base_url, *argv]
            rc, out = _run(cli.main_obs, full, capsys)
            ref_rc, ref_out = _run(ref_cli.main_obs, full, capsys)
            assert rc == ref_rc, argv
            if argv[0] == "--format":
                # the rows' wall-clock ts differ by scrape; the columns
                # and the row count do not
                assert out.splitlines()[0] == ref_out.splitlines()[0]
                assert len(out.splitlines()) == len(ref_out.splitlines()) >= 2
            else:
                assert json.loads(out) == json.loads(ref_out)
                assert rc == (0 if json.loads(out)["fits"] else 1)
        rc, out = _run(cli.main_obs, ["capacity", "--url", c.base_url], capsys)
        assert rc == 0 and "stranded: 1x 16-chip demand(s) (1x fragmented)" in out


def test_duration_shape_and_merge_helpers_agree_with_the_reference():
    from tpukube.obs import capacity as ref_capacity

    for text in ("90", "90s", "15m", "2h", "1d", " 1.5h "):
        assert capacity.parse_duration(text) == ref_capacity.parse_duration(text)
    for text in ("4x4x4", "1X2x3"):
        assert capacity.parse_shape(text) == ref_capacity.parse_shape(text)
    assert capacity.UNSCHEDULABLE_REASONS == ref_capacity.UNSCHEDULABLE_REASONS
    assert capacity.STRANDED_TTL_SECONDS == ref_capacity.STRANDED_TTL_SECONDS
    docs = [("r0", test_capacity._doc(2.0, "64", "fragmented", 64)),
            ("r1", test_capacity._doc(1.0, "8", "capacity", 8)), ("r2", None)]
    assert capacity.merge_capacity_docs(docs) == \
        ref_capacity.merge_capacity_docs(docs)
    for fmt in ("sparkline", "csv", "json"):
        merged = capacity.merge_capacity_docs(docs)
        assert capacity.format_capacity(merged, fmt) == \
            ref_capacity.format_capacity(merged, fmt)
