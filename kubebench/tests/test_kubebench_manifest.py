"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import os
import re

import pytest

from kubebench import manifest

DOC = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["paths"] == ["kubebench"] and 1 <= DOC["run_seconds"] <= 51
    assert os.path.getsize(manifest.MANIFEST) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_only_their_keys_and_valid_names(section):
    names = [e["name"] for e in DOC[section]]
    assert len(names) == len(set(names))
    for e in DOC[section]:
        assert set(e) <= KEYS[section] and set(e) >= KEYS[section] - {"workloads"}
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        lines = [e[k] for k in ("why", "layer") if k in e]
        if section == "configs":
            lines.append(e["source"])
        for text in lines:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_bounds_and_sources():
    for m in DOC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in DOC["end_to_end"]}["setup_s"] == 0.25
    for m in DOC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = manifest.load_cell(cell)
    assert c.chips == 1
    assert c.traffic["entry"] and os.path.exists(os.path.join(manifest.PKG, "entries", c.traffic["entry"] + ".py"))
    assert os.path.exists(os.path.join(manifest.PKG, "checks", c.traffic["entry"] + ".py"))
    names = {m.name for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert hasattr(c.reader(m.name), "read")
    for m in c.per_layer:
        assert m.moves in names
    for k, v in c.limits.items():
        assert k.startswith("_") or isinstance(v["limit"], (int, float))
    assert hasattr(c.flops(), "step_flops") or hasattr(c.flops(), "request_flops")


def test_configs_state_what_they_reduce():
    for c in DOC["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert NAME.match(k) and not k.endswith(("_dim", "_rank", "_size"))
        assert c["file"].startswith("kubebench/")


def test_command_names_no_file_outside_paths():
    assert DOC["command"] == ["python3", "-m", "kubebench.run"]
