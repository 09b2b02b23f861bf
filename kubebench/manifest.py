"""``BENCHMARK.json`` and the files it names.

The manifest only names things; each configuration, traffic mix, limit set
and per-layer metric lives in a file of its own under ``kubebench/``, found
by its name:

- ``configs/<config>.json``: the model's sizes as run, its source, the keys
  ``reduced`` from the source and the sizes ``assumed``;
- ``traffic/<traffic>.json``: the mix's parameters and the port entry its
  pods drive;
- ``limits/<workload>.json``: each number that decides ``correct``, with
  the readings its limit was set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``flops/<family>.py`` and ``reference/<family>.py``: the operation counts
  and the plain reference of a configuration's model family.

Adding a cell, a mix or a metric is adding files and manifest entries; no
file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from types import ModuleType
from typing import Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_name(name: str, what: str) -> str:
    """``name`` when it is a valid manifest name, else ValueError."""
    if not isinstance(name, str) or not NAME_RE.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_part(kind: str, name: str, root: str = PKG) -> ModuleType:
    """``<root>/<kind>/<name>.py`` (an entry, a check, a reader, a count),
    loaded by its file name, which may hold dots."""
    return _load_module(os.path.join(root, kind, f"{name}.py"),
                        re.sub(r"\W", "_", f"kubebench_{kind}_{name}"))


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[tuple]
    layer: str = ""
    moves: str = ""

    def applies(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclass(frozen=True)
class Cell:
    """One workload of the manifest, with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple
    per_layer: tuple
    root: str

    @property
    def family(self) -> str:
        return self.config["family"]

    def flops(self) -> ModuleType:
        return load_part("flops", self.family, self.root)

    def reader(self, metric: str) -> ModuleType:
        return load_part("metrics", metric, self.root)


def load_manifest(path: str = MANIFEST) -> dict:
    doc = _json(path)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in doc[key]:
            check_name(entry["name"], key)
    for m in doc["end_to_end"] + doc["per_layer"]:
        if not UNIT_RE.match(m["unit"]):
            raise ValueError(f"metric {m['name']}: unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            raise ValueError(f"metric {m['name']}: better {m['better']!r}")
    return doc


def _metric(m: dict) -> Metric:
    w = m.get("workloads")
    return Metric(m["name"], m["unit"], m["better"], m["source"],
                  tuple(w) if w is not None else None,
                  m.get("layer", ""), m.get("moves", ""))


def load_cell(workload: str, path: str = MANIFEST) -> Cell:
    """The cell named ``workload``, its configuration, traffic and limits
    read from their files. KeyError when the manifest has no such cell."""
    doc = load_manifest(path)
    root = os.path.join(os.path.dirname(os.path.abspath(path)), "kubebench")
    cells = {w["name"]: w for w in doc["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {path}; have {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in doc["configs"]}[w["config"]]
    config = _json(os.path.join(os.path.dirname(os.path.abspath(path)), cfg_entry["file"]))
    traffic = _json(os.path.join(root, "traffic", f"{check_name(w['traffic'], 'traffic')}.json"))
    limits = _json(os.path.join(root, "limits", f"{workload}.json"))
    e2e = tuple(m for m in map(_metric, doc["end_to_end"]) if m.applies(workload))
    per = tuple(m for m in map(_metric, doc["per_layer"]) if m.applies(workload))
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e, per, root)
