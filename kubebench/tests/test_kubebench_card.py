"""On the card only (``-m card``): the float8 control at each cell's own
sizes must come out not correct against the cell's committed limits, and
a short run of each cell must come out correct. Each runs in a process of
its own, as the benchmark does, so that this process holds no memory on
the card. Readings and limits are in PERF.md."""

import json
import subprocess
import sys

import pytest

from kubebench import manifest
from kubebench.manifest import ROOT

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


def _last_json(args: list) -> dict:
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cuda):
    got = _last_json(["kubebench.control", "--workload", cell, "--seeds", str(2 ** 31 + 77)])
    got = got["readings"]
    limits = {k: v["limit"] for k, v in manifest.load_cell(cell).limits.items() if k in got}
    assert any(got[k] > lim for k, lim in limits.items()), (got, limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell, cuda):
    res = _last_json(["kubebench.run", "--workload", cell, "--seed", str(2 ** 31 + 78),
                      "--seconds", "5", "--trace", "0"])
    assert res["correct"] is True, res["checks"]
