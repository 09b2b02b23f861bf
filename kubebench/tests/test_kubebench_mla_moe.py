"""The MLA + MoE cell (``moonlight-16b-a3b.prefill-whole``) on the CPU: a
whole run at tiny sizes reads ``correct``, each omission planted in the
program reads not correct, the float8 control reads past the limits, the
operation counts by hand, and the two MoE readers on made-up span files.

The tiny model: 16 experts, 4 a token, 2 shared, a vocabulary of 2,048,
and a score correction of N(0, 0.1**2) (at the cell's 0.01, leaving it
out moves too few of 16 experts' choices at width 64 to stand three times
clear of a sound run). Its limits are its own. With the program's routing
replayed, a sound run reads a served gap of 0.03-0.09 logits, a median
logit error of 0.017-0.020 and a mean shortfall of 0.00004-0.00018; a
flipped token reads a gap of 5-6; the shared experts or the routed scale
left out, a median of 0.38-0.60; the score correction left out, a
shortfall of 0.07-0.13; the float8 control 0.53, 0.19 and 0.012."""

import contextlib
import io
import json
import os
import textwrap
from types import SimpleNamespace

import pytest
import torch

from kubebench import run
from kubebench.manifest import load_cell, load_part

CELL = "moonlight-16b-a3b.prefill-whole"
SEED = 2 ** 33 + 7
CFG = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
       "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128, "n_routed_experts": 16,
       "num_experts_per_tok": 4, "moe_intermediate_size": 32, "vocab_size": 2048,
       "num_hidden_layers": 3,
       "assumed": {"e_score_correction_bias_std": 0.1, "latent_norm_eps": 1e-6}}
TRAFFIC = {"prompt_tokens": {"dist": "loguniform", "min": 8, "max": 64, "points": 4},
           "token_pool": 4096, "trace_slice_s": 0.5}
LIMITS = {"served_logit_gap": 0.3, "logit_error_median": 0.08, "route_shortfall_mean": 0.005}

WRAP = """
import dataclasses
from tpukube_torch.workload import mla_moe
_forward = mla_moe.forward
def forward(params, tokens, cfg, routes=None):
{body}
mla_moe.forward = forward
"""
FAULTS = {
    "token": """
    out = _forward(params, tokens, cfg, routes)
    out[..., -1, :] = out[..., -1, :].flip(-1)  # the last position's answer
    return out""",
    "no_shared": """
    moe = dict(params["moe"], shared_down=params["moe"]["shared_down"] * 0)
    return _forward(dict(params, moe=moe), tokens, cfg, routes)""",
    "no_bias": """
    moe = dict(params["moe"], router_bias=params["moe"]["router_bias"] * 0)
    return _forward(dict(params, moe=moe), tokens, cfg, routes)""",
    "no_scale": """
    return _forward(params, tokens, dataclasses.replace(cfg, routed_scale=1.0), routes)""",
}


def rehearse(tmp_path, fault=None) -> dict:
    env = {}
    if fault is not None:
        (tmp_path / "sitecustomize.py").write_text(WRAP.format(body=textwrap.dedent(FAULTS[fault])
                                                               .replace("\n", "\n    ")))
        env["PYTHONPATH"] = str(tmp_path)
    r = run.Rehearsal(config=CFG, traffic=TRAFFIC, pod_env=env, limits=LIMITS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
                      rehearsal=r)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_sound_run_is_correct(tmp_path):
    res = rehearse(tmp_path)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"failed", "pods_off_their_gpu", *LIMITS}


@pytest.mark.parametrize("fault,reading", [
    ("token", "served_logit_gap"),
    ("no_shared", "logit_error_median"),
    ("no_bias", "route_shortfall_mean"),
    ("no_scale", "logit_error_median"),
])
def test_broken_run_is_not_correct(tmp_path, fault, reading):
    res = rehearse(tmp_path, fault)
    assert res["correct"] is False
    check = res["checks"][reading]
    assert check["value"] > check["limit"], res["checks"]


def test_float8_control_reads_past_the_limits():
    cell = run.Rehearsal(config=CFG, traffic=TRAFFIC, limits=LIMITS).shrink(load_cell(CELL))
    checks = load_part("checks", "mla_moe.forward")
    got = checks.control(cell, SEED, [64, 40, 23], torch.device("cpu"), "fp8")
    assert all(got[k] > lim for k, lim in LIMITS.items()), got


# ---------------------------------------------------------------- counts
flops = load_part("flops", "mla_moe")
TINY = {"hidden_size": 8, "num_attention_heads": 2, "kv_lora_rank": 4, "qk_nope_head_dim": 3,
        "qk_rope_head_dim": 2, "v_head_dim": 5, "intermediate_size": 12, "n_routed_experts": 4,
        "num_experts_per_tok": 2, "moe_intermediate_size": 6, "n_shared_experts": 2,
        "first_k_dense_replace": 1, "num_hidden_layers": 3, "vocab_size": 10}


def test_forward_flops_by_hand():
    S, D, H, r, dn, dr, dv, V = 4, 8, 2, 4, 3, 2, 5, 10
    attn_proj = 2 * S * (D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D)
    pairs = S * (S + 1) // 2
    core = 2 * H * pairs * ((dn + dr) + dv)
    dense_mlp = 2 * S * 3 * D * 12
    router = 2 * S * D * 4
    routed = 2 * S * 2 * 3 * D * 6  # each token on 2 experts of width 6
    shared = 2 * S * 3 * D * 12
    want = (3 * (attn_proj + core) + dense_mlp + 2 * (router + routed + shared) + 2 * S * D * V)
    assert flops.request_flops(TINY, S) == want


def test_moonlight_active_parameters():
    cfg = _moonlight()
    # two operations a token for each active parameter outside the
    # embedding: 2.58 G of them (16 B in all, about 3 B active with it)
    assert 5.15e9 < flops.dense_flops(cfg, 1) + flops.moe_flops(cfg, 1) < 5.17e9


def test_moe_bound_by_hand():
    # one layer, 4 tokens on experts [5, 0, 2, 1]: 3 experts used
    rows = [5, 0, 2, 1]
    D, E, Fe, Fs = 8, 4, 6, 12
    ops = 2 * 4 * D * E + 3 * 2 * 8 * D * Fe + 3 * 2 * 4 * D * Fs
    nbytes = 4 * D * E + 2 * 3 * D * Fe * 3 + 2 * 3 * D * Fs + 2 * 2 * 4 * D
    assert flops.moe_bound_s(TINY, rows) == pytest.approx(max(ops / 989e12, nbytes / 3.35e12))


# --------------------------------------------------------------- readers
S0 = 1_700_000_000_000_000_000
MS = 1_000_000


@pytest.fixture
def span_dir(tmp_path, monkeypatch):
    import tempfile

    from tpukube_torch.obs import spans

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return spans.default_dir()


def _write(directory, recorded):
    """(name, t0 ms, t1 ms, device_ms, id, parent, rows_per_expert or None)"""
    from tpukube_torch.obs import spans

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, f"{spans.PREFIX}pod.jsonl"), "w") as f:
        for seq, (n, t0, t1, dev, i, parent, rows) in enumerate(recorded, start=1):
            req = {"name": n, "t0": (S0 + t0 * MS) / 1e9, "t1": (S0 + t1 * MS) / 1e9,
                   "device_ms": dev, "id": i, "parent": parent, "root": parent or i}
            if rows is not None:
                req["counts"] = {"rows_per_expert": rows}
            f.write(json.dumps({"seq": seq, "ts": req["t1"], "kind": "span",
                                "request": req, "response": None}) + "\n")


def _ctx(config):
    pod = {"trace": {"slice": [S0, S0 + 100 * MS], "busy": [], "by_name": {}, "dense_by_op": {},
                     "gaps": [], "units": []}}
    return SimpleNamespace(reports=[pod], config=config, flops=flops)


def _moonlight():
    return load_cell(CELL).config


ROWS = [130] * 60 + [30, 0, 0, 0]  # 1,385 tokens, 6 rows each


def test_moe_share_counts_the_forwards_children(span_dir):
    _write(span_dir, [("tpukube.forward", 10, 60, 50.0, 1, None, None),
                      ("tpukube.moe", 20, 30, 20.0, 2, 1, ROWS),
                      ("tpukube.attention", 31, 35, 5.0, 3, 1, None),
                      ("tpukube.moe", 36, 40, 10.0, 4, 1, ROWS),
                      ("tpukube.moe", 70, 80, 99.0, 5, None, ROWS)])
    ctx = _ctx(_moonlight())
    assert load_part("metrics", "moe_share.prefill").read(ctx) == pytest.approx(60.0)
    bound = 2 * flops.moe_bound_s(ctx.config, ROWS)
    got = load_part("metrics", "moe_roofline.prefill").read(ctx)
    assert got == pytest.approx(bound / 30e-3 * 100)


@pytest.mark.parametrize("rows", [ROWS, [6 * 4096 // 64] * 64, [6 * 256] + [0] * 63, [6] + [0] * 63])
def test_moe_roofline_stays_under_100_at_the_least_time(span_dir, rows):
    cfg = _moonlight()
    least_ms = flops.moe_bound_s(cfg, rows) * 1e3
    _write(span_dir, [("tpukube.forward", 10, 60, 50.0, 1, None, None),
                      ("tpukube.moe", 20, 30, least_ms, 2, 1, rows)])
    assert load_part("metrics", "moe_roofline.prefill").read(_ctx(cfg)) == pytest.approx(100.0)
    # an MoE call is bound by its expert weights' bytes at a prompt's rows
    assert flops.moe_bound_s(cfg, rows) >= 3 * 2048 * 1408 * 2 * sum(n > 0 for n in rows) / 3.35e12


def test_moe_readers_find_nothing_without_spans_or_counts(span_dir):
    ctx = _ctx(_moonlight())
    for metric in ("moe_share.prefill", "moe_roofline.prefill"):
        assert load_part("metrics", metric).read(ctx) is None  # no file
    # a program whose forwards hold no MoE spans (the decoder's; the parent's)
    _write(span_dir, [("tpukube.forward", 10, 60, 50.0, 1, None, None),
                      ("tpukube.attention", 31, 35, 5.0, 2, 1, None)])
    for metric in ("moe_share.prefill", "moe_roofline.prefill"):
        assert load_part("metrics", metric).read(ctx) is None
    _write(span_dir, [("tpukube.forward", 10, 60, 50.0, 1, None, None),
                      ("tpukube.moe", 20, 30, 20.0, 2, 1, None)])
    assert load_part("metrics", "moe_share.prefill").read(ctx) == pytest.approx(40.0)
    assert load_part("metrics", "moe_roofline.prefill").read(ctx) is None


def test_the_reference_weights_and_check_load_nothing_of_the_program():
    import subprocess
    import sys

    from kubebench.manifest import ROOT

    code = ("import importlib.util, os, sys\n"
            "import kubebench.reference.mla_moe, kubebench.weights_mla_moe\n"
            "p = os.path.join('kubebench', 'checks', 'mla_moe.forward.py')\n"
            "s = importlib.util.spec_from_file_location('c', p)\n"
            "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": ROOT})
    top = set(out.stdout.split())
    assert "torch" in top and not top & {"jax", "jaxlib", "flax", "tpukube", "tpukube_torch"}
