"""A whole run on the CPU at tiny sizes (the sim node agent in place of
the card's; the rest of the run as on the card) with the timed path
broken underneath: a ``sitecustomize`` put first on the pods' path patches
the port, and ``correct`` must come out false, once for each fault the
cell can have. A sound run at the same sizes comes out true.

The limits here are for the tiny configurations (bf16 at two layers of
width 64 reads other gaps than the cells' sizes); each fault reads far
past them: a state left unchanged reads 1, half a batch and an altered
loss read in the per cents, an altered token reads whole logits."""

import contextlib
import dataclasses
import io
import json
import textwrap

import pytest

from kubebench import run

SEED = 2 ** 33 + 7
DEC = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
       "intermediate_size": 128, "vocab_size": 512, "num_hidden_layers": 2,
       "assumed": {"head_dim": 16}}
RES = {"width": 8, "stage_blocks": [1, 1], "num_classes": 10, "image_size": 16, "norm_groups": 4}
CELLS = {
    "mistral-7b.prefill-shared": (DEC, {"prompt_tokens": {"dist": "loguniform", "min": 8, "max": 64,
                                                          "points": 4}, "token_pool": 4096},
                                  {"served_logit_gap": 0.3}),
    "mistral-7b.train": (DEC, {"batch": 2, "seq": 32},
                         {"first_loss_gap": 3e-3, "grad_norm_gap": 2e-2, "change_norm_gap": 2e-2}),
    "resnet-50-gn-cifarstem.train": (RES, {"batch": 4, "check_rows_per_block": 2},
                                     {"loss_gap": 3e-3, "change_norm_gap": 0.1}),
}

FAULTS = {
    "token": """
        from tpukube_torch.workload import llama
        _forward = llama.forward
        def forward(params, tokens, cfg, remat=False):
            out = _forward(params, tokens, cfg, remat)
            out[..., -1, :] = out[..., -1, :].flip(-1)  # the last position's answer
            return out
        llama.forward = forward
    """,
    "unchanged": """
        from tpukube_torch.workload import resnet, train
        _train, _resnet = train.make_train_step, resnet.make_dp_train_step
        def make_train_step(cfg, mesh, opt=None, **kw):
            step, init = _train(cfg, mesh, opt, **kw)
            def frozen(params, state, tokens):
                return params, state, train.make_loss_and_grad(cfg, mesh)(params, tokens)[0]
            return frozen, init
        def make_dp_train_step(cfg, mesh, learning_rate=1e-2):
            return _resnet(cfg, mesh, learning_rate=0.0)
        train.make_train_step, resnet.make_dp_train_step = make_train_step, make_dp_train_step
    """,
    "half_batch": """
        from tpukube_torch.workload import resnet, train
        _train, _resnet = train.make_train_step, resnet.make_dp_train_step
        def make_train_step(*a, **kw):
            step, init = _train(*a, **kw)
            return (lambda p, s, t: step(p, s, t[: len(t) // 2])), init
        def make_dp_train_step(*a, **kw):
            step = _resnet(*a, **kw)
            return lambda p, x, y: step(p, x[: len(x) // 2], y[: len(y) // 2])
        train.make_train_step, resnet.make_dp_train_step = make_train_step, make_dp_train_step
    """,
    "loss": """
        from tpukube_torch.workload import resnet, train
        _train, _resnet = train.make_train_step, resnet.make_dp_train_step
        def make_train_step(*a, **kw):
            step, init = _train(*a, **kw)
            def altered(p, s, t):
                p, s, loss = step(p, s, t)
                return p, s, loss * 1.01
            return altered, init
        def make_dp_train_step(*a, **kw):
            step = _resnet(*a, **kw)
            def altered(p, x, y):
                p, loss = step(p, x, y)
                return p, loss * 1.01
            return altered
        train.make_train_step, resnet.make_dp_train_step = make_train_step, make_dp_train_step
    """,
}


def rehearse(cell: str, tmp_path, fault=None) -> dict:
    config, traffic, limits = CELLS[cell]
    env = {}
    if fault is not None:
        (tmp_path / "sitecustomize.py").write_text(textwrap.dedent(FAULTS[fault]))
        env["PYTHONPATH"] = str(tmp_path)
    r = run.Rehearsal(config=config, traffic={**traffic, "trace_slice_s": 0.5}, pod_env=env)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds", "4", "--trace", "0"],
                      rehearsal=dataclasses.replace(r, limits=limits))
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell, tmp_path):
    res = rehearse(cell, tmp_path)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell,fault,reading", [
    ("mistral-7b.prefill-shared", "token", "served_logit_gap"),
    ("mistral-7b.train", "unchanged", "change_norm_gap"),
    ("mistral-7b.train", "half_batch", "first_loss_gap"),
    ("mistral-7b.train", "loss", "first_loss_gap"),
    ("resnet-50-gn-cifarstem.train", "unchanged", "change_norm_gap"),
    ("resnet-50-gn-cifarstem.train", "half_batch", "loss_gap"),
    ("resnet-50-gn-cifarstem.train", "loss", "loss_gap"),
])
def test_broken_run_is_not_correct(cell, fault, reading, tmp_path):
    res = rehearse(cell, tmp_path, fault)
    assert res["correct"] is False
    check = res["checks"][reading]
    assert check["value"] > check["limit"], res["checks"]
