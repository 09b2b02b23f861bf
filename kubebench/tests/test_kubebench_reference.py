"""The plain reference against the port at tiny sizes, on the CPU: the
decoder's forward, its clip + AdamW steps and the ResNet's SGD steps, all
from the benchmark's own weights. The port computes in bfloat16, the
reference in float32, so each comparison allows bf16's rounding, and the
float8 control must land further from the reference than the port does."""

import copy
import json
import os
import socket

import pytest
import torch
import torch.distributed as dist

from kubebench import compare, weights
from kubebench.manifest import PKG
from kubebench.reference import decoder as ref_dec
from kubebench.reference import resnet as ref_res
from tpukube_torch.workload import llama, resnet, train
from tpukube_torch.workload.meshenv import build_mesh

CPU = torch.device("cpu")
SEED = 2 ** 40 + 3


def _config(name: str, **small) -> dict:
    with open(os.path.join(PKG, "configs", f"{name}.json")) as f:
        return {**json.load(f), **small}


DEC = _config("mistral-7b", hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=128, vocab_size=256, num_hidden_layers=2,
              assumed={"head_dim": 16})
RES = _config("resnet-50-gn-cifarstem", width=8, stage_blocks=[1, 1], num_classes=10,
              image_size=16, norm_groups=4)


def _port_llama(c: dict) -> llama.LlamaConfig:
    return llama.LlamaConfig(vocab=c["vocab_size"], d_model=c["hidden_size"],
                             n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
                             n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
                             rope_theta=c["rope_theta"], norm_eps=c["rms_norm_eps"])


@pytest.fixture
def mesh():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield build_mesh("cpu", 1, 1)
    finally:
        dist.destroy_process_group()


def test_decoder_forward_matches_the_port():
    params = weights.decoder_params(DEC, SEED, CPU)
    toks = weights.token_pool(SEED, 48, DEC["vocab_size"], CPU)
    want = ref_dec.logits(params, toks, DEC)
    got = llama.forward(params, toks[None], _port_llama(DEC))[0]
    # bf16 products through two layers: a few parts in a hundred at worst
    scale = float(want.abs().max())
    err = (got - want).abs()
    assert float(err.max()) < 4e-2 * scale
    assert float(err.mean()) < 5e-3 * scale
    fp8 = ref_dec.logits(params, toks, DEC, "fp8")
    assert float((fp8 - want).abs().mean()) > 2 * float(err.mean())


def test_served_gap_is_zero_for_the_reference_own_tokens():
    params = weights.decoder_params(DEC, SEED, CPU)
    toks = weights.token_pool(SEED, 32, DEC["vocab_size"], CPU)
    best = ref_dec.greedy(params, toks, DEC, "fp32")
    assert ref_dec.served_gap(params, toks, best, DEC) == 0.0
    assert ref_dec.served_gap(params, toks, (best + 1) % DEC["vocab_size"], DEC) > 0.0


def test_decoder_train_steps_match_the_port(mesh):
    opt = {"lr": 3e-4, "max_norm": 1.0, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
           "weight_decay": 1e-4}
    batches = weights.train_batches(SEED, 3, 2, 32, DEC["vocab_size"], CPU)
    params = weights.decoder_params(DEC, SEED, CPU)
    for p in weights.named(params).values():
        p.requires_grad_(True)
    step, init = train.make_train_step(_port_llama(DEC), mesh, train.AdamW(**opt))
    state = init(params)
    prog = {"losses": [], "first_grad": {}}
    for i in range(3):
        params, state, loss = step(params, state, batches[i])
        prog["losses"].append(float(loss))
        if i == 0:
            prog["first_grad"] = {k: float(m.norm()) / (1 - opt["b1"])
                                  for k, m in weights.named(state["mu"]).items()}
    prog["change"] = {k: float((p.detach() - weights.initial_leaf("decoder", DEC, SEED, k, CPU)).norm())
                      for k, p in weights.named(params).items()}
    ref_params = weights.decoder_params(DEC, SEED, CPU)
    ref = ref_dec.train_steps(ref_params, batches, DEC, opt, 3)
    ref["change"] = {k: float((p - weights.initial_leaf("decoder", DEC, SEED, k, CPU)).norm())
                     for k, p in weights.named(ref_params).items()}
    got = compare.train_readings(prog, ref)
    assert got["loss_gap"] < 5e-3
    assert got["grad_norm_gap"] < 5e-2
    assert got["change_norm_gap"] < 5e-2


def test_resnet_train_steps_match_the_port(mesh):
    x, y = weights.images(SEED, 3, 4, RES["image_size"], RES["num_classes"], CPU)
    params = weights.resnet_params(RES, SEED, CPU)
    start = copy.deepcopy(weights.named(params))
    cfg = resnet.ResNetConfig(num_classes=10, width=8, stage_blocks=(1, 1), bottleneck=True,
                              groups=4, image_size=16)
    step = resnet.make_dp_train_step(cfg, mesh, learning_rate=0.01)
    prog = {"losses": []}
    for i in range(3):
        params, loss = step(params, x[i], y[i])
        prog["losses"].append(float(loss))
        if i == 0:
            prog["first_grad"] = {k: float((start[k] - p.detach()).norm()) / 0.01
                                  for k, p in weights.named(params).items()}
    prog["change"] = {k: float((p.detach() - start[k]).norm()) for k, p in weights.named(params).items()}
    ref_params = weights.resnet_params(RES, SEED, CPU)
    ref = ref_res.train_steps(ref_params, x, y, RES, 0.01, 3, rows_per_block=2)
    ref["change"] = {k: float((p - start[k]).norm()) for k, p in weights.named(ref_params).items()}
    got = compare.train_readings(prog, ref)
    assert got["loss_gap"] < 5e-3
    assert got["grad_norm_gap"] < 1e-1
    assert got["change_norm_gap"] < 1e-1


def test_resnet_reference_forward_matches_the_port():
    x, _ = weights.images(SEED, 1, 2, RES["image_size"], RES["num_classes"], CPU)
    params = weights.resnet_params(RES, SEED, CPU)
    cfg = resnet.ResNetConfig(num_classes=10, width=8, stage_blocks=(1, 1), bottleneck=True,
                              groups=4, image_size=16)
    want = ref_res.forward(params, x[0], RES)
    got = resnet.forward(params, x[0], cfg)
    assert float((got - want).abs().max()) < 3e-2 * float(want.abs().max())


def test_worst_leaf_takes_the_median_floor():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.0, "b": 2.0, "c": 2e-9}
    # c's gap is against the median leaf's norm, not its own
    gap, leaf = compare.worst_leaf(prog, ref)
    assert leaf == "c" and gap == pytest.approx(1e-9 / 1.0)
    assert compare.moving_leaves(ref) == {"a", "b"}
