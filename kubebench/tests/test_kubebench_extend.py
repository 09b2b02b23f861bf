"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and manifest entries, and edits no file
that is there: on a copy, the harness finds each by its name."""

import hashlib
import json
import os
import shutil

from kubebench import manifest


def _digests(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_a_mix_and_a_metric_added_as_files(tmp_path):
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(manifest.PKG, tmp_path / "kubebench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    before = _digests(tmp_path / "kubebench")
    kb = tmp_path / "kubebench"

    cfg = json.loads((kb / "configs" / "mistral-7b.json").read_text())
    cfg.update(num_hidden_layers=16, reduced=["num_hidden_layers"])
    (kb / "configs" / "mistral-7b-pp2.json").write_text(json.dumps(cfg))
    mix = json.loads((kb / "traffic" / "prefill-whole.json").read_text())
    mix["prompt_tokens"] = {"dist": "loguniform", "min": 8192, "max": 32768, "points": 8}
    (kb / "traffic" / "prefill-long.json").write_text(json.dumps(mix))
    (kb / "limits" / "mistral-7b-pp2.prefill-long.json").write_text(
        json.dumps({"served_logit_gap": {"limit": 0.5}}))
    (kb / "metrics" / "long_share_pct.py").write_text(
        "def read(ctx):\n    return 100.0 * sum(r.length > 16384 for r in ctx.requests) / len(ctx.requests)\n")

    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "mistral-7b-pp2", "source": cfg["source"],
                           "file": "kubebench/configs/mistral-7b-pp2.json",
                           "reduced": ["num_hidden_layers"], "why": "half the layers"})
    doc["workloads"].append({"name": "mistral-7b-pp2.prefill-long", "config": "mistral-7b-pp2",
                             "traffic": "prefill-long", "chips": 1, "why": "8k-32k prompts"})
    for m in doc["end_to_end"]:
        if "workloads" in m and "mistral-7b.prefill-shared" in m["workloads"]:
            m["workloads"].append("mistral-7b-pp2.prefill-long")
    doc["per_layer"].append({"name": "long_share_pct", "unit": "%", "better": "higher",
                             "source": "program_counter", "layer": "model step",
                             "moves": "prefill_tokens_per_s",
                             "workloads": ["mistral-7b-pp2.prefill-long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))

    cell = manifest.load_cell("mistral-7b-pp2.prefill-long", str(tmp_path / "BENCHMARK.json"))
    assert cell.config["num_hidden_layers"] == 16
    assert cell.traffic["prompt_tokens"]["min"] == 8192
    assert cell.limits == {"served_logit_gap": {"limit": 0.5}}
    assert "long_share_pct" in {m.name for m in cell.per_layer}
    assert {"prefill_tokens_per_s", "prefill_p95_ms", "setup_s"} == {m.name for m in cell.end_to_end}

    class Ctx:
        requests = [type("R", (), {"length": n})() for n in (8192, 20000, 32768, 9000)]

    assert cell.reader("long_share_pct").read(Ctx) == 50.0
    after = _digests(tmp_path / "kubebench")
    assert {k: v for k, v in after.items() if k in before} == before
