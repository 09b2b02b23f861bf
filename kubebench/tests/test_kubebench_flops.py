"""The benchmark's operation counts against hand counts at small shapes."""

import json
import os

from kubebench.manifest import PKG, load_part

decoder = load_part("flops", "decoder")
resnet = load_part("flops", "resnet")

TINY = {"hidden_size": 8, "num_attention_heads": 2, "num_key_value_heads": 1,
        "intermediate_size": 16, "vocab_size": 10, "num_hidden_layers": 3}


def test_decoder_forward_by_hand():
    S, D, H, KV, HD, F, V, L = 4, 8, 2, 1, 4, 16, 10, 3
    per_layer = 2 * S * (D * H * HD + 2 * D * KV * HD + H * HD * D + 3 * D * F)
    # causal: QK^T and PV over the S(S+1)/2 pairs a head needs, 2 HD each
    pairs = S * (S + 1) // 2
    attention = 2 * (2 * HD * pairs) * H
    unembed = 2 * S * D * V
    assert decoder.forward_flops(TINY, S) == L * (per_layer + attention) + unembed


def test_causal_attention_is_half_the_square_plus_the_diagonal():
    S = 64
    full = TINY["num_hidden_layers"] * 2 * 2 * TINY["num_attention_heads"] * 4 * S * S
    assert decoder.attention_flops(TINY, S) * 2 == full + full // S


def test_decoder_train_step_is_three_forwards():
    t = {"batch": 2, "seq": 4}
    assert decoder.step_flops(TINY, t) == 3 * 2 * decoder.forward_flops(TINY, 4)


def test_dense_bound_takes_the_larger_of_compute_and_bytes():
    # one product of 1 x 8 x 10: bytes bound it (1 row)
    cfg = {**TINY, "num_hidden_layers": 0}
    (m, k, n, c), = [p for p in decoder.products(cfg, 1) if p[3]]
    want = max(2 * m * k * n / 989e12, 2 * (m * k + k * n + m * n) / 3.35e12)
    assert abs(decoder.dense_bound_s(cfg, 1, backward=False) - want) < 1e-18
    assert decoder.dense_bound_s(cfg, 1, backward=True) > 2.9 * want


def test_mistral_7b_parameters_and_forward():
    cfg = json.load(open(os.path.join(PKG, "configs", "mistral-7b.json")))
    # 2 x the 7.11e9 parameters outside the embedding a token, as published
    assert 14.0e9 < decoder.dense_flops(cfg, 1) < 14.4e9


def test_resnet_convs_by_hand():
    cfg = {"image_size": 8, "width": 2, "bottleneck_expansion": 4, "stage_blocks": [1, 1],
           "stem_kernel": 3, "stem_stride": 1, "num_classes": 3}
    convs = resnet.convs(cfg)
    # stem 3x3 3->2 at 8x8; block 1: 1x1 2->2, 3x3 2->2, 1x1 2->8, proj 2->8 at 8x8;
    # block 2 (stride 2): 1x1 8->4 at 4x4, 3x3 4->4, 1x1 4->16, proj 8->16 at 4x4
    assert convs == [(8, 8, 3, 2, 3), (8, 8, 2, 2, 1), (8, 8, 2, 2, 3), (8, 8, 2, 8, 1),
                     (8, 8, 2, 8, 1), (8, 4, 8, 4, 1), (4, 4, 4, 4, 3), (4, 4, 4, 16, 1),
                     (8, 4, 8, 16, 1)]
    by_hand = sum(2 * ho * ho * co * ci * k * k for _, ho, ci, co, k in convs) + 2 * 16 * 3
    assert resnet.forward_flops(cfg) == by_hand


def test_resnet_50_gn_cifarstem_as_configured():
    cfg = json.load(open(os.path.join(PKG, "configs", "resnet-50-gn-cifarstem.json")))
    # the port's 3x3 stride-1 stem keeps 224 x 224 through stage 1:
    # about 15x the 8.2 GFLOP of He et al.'s ResNet-50 forward
    assert 119e9 < resnet.forward_flops(cfg) < 121e9


def test_dense_rooflines_leave_attention_products_out_of_the_time():
    from types import SimpleNamespace

    cfg = {**TINY, "family": "decoder"}
    traffic = {"batch": 2, "seq": 4}
    # seconds of dense-kind kernels by the operation that launched them
    by_op = {"aten::mm": 2e-9, "aten::addmm": 1e-9, "aten::bmm": 5.0, "aten::baddbmm": 5.0,
             "aten::einsum": 5.0}
    trace = SimpleNamespace(units=[(0, {"length": 4}), (0, {"length": 4})], dense_by_op=by_op)
    ctx = SimpleNamespace(trace=trace, config=cfg, traffic=traffic, flops=decoder)
    got = load_part("metrics", "dense_roofline.prefill").read(ctx)
    assert abs(got - 2 * decoder.request_dense_bound_s(cfg, 4) / 3e-9 * 100) < 1e-6 * got
    got = load_part("metrics", "dense_roofline.train").read(ctx)
    assert abs(got - 2 * decoder.step_dense_bound_s(cfg, traffic) / 3e-9 * 100) < 1e-6 * got
    # nothing left to time: no reading, never 0
    trace.dense_by_op = {"aten::bmm": 1.0}
    assert load_part("metrics", "dense_roofline.prefill").read(ctx) is None
