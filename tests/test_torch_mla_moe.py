"""The port's MLA + MoE decoder (``tpukube_torch/workload/mla_moe.py``)
against the plain reference (``tests/torch_ref_mla_moe.py``) on the CPU at
a tiny size: one dense layer and two MoE layers of 8 experts, top 2, two
shared, with the benchmark's seeded weights (norm gains near one, a score
correction that moves the choice).

At float32 compute the port and the reference differ only in rounding
order: logits within 1e-4 of their largest, and every layer routes every
token to the same experts. At bfloat16 the port rounds at each product
(8 bits of mantissa) while the reference does not; the logits are held
to 3e-2 of their root mean square, bf16's rounding grown over three
layers, as the decoder's own tests hold theirs to 2e-2 of their largest,
with the reference routed as the port routed: a token whose scores lie
within rounding of a tie may take another expert in bf16, which moves
its logits far more than rounding does (a tenth of their root mean square
here, at two experts a token). Such a choice is held apart: the experts
the port chose score within 2e-2 (a few bf16 steps of the scores) of
those the reference chose.

The tests marked ``card`` need CUDA and skip without it; on the card:
``python -m pytest tests/test_torch_mla_moe.py -m card --noconftest``.
"""

import pytest
import torch

import torch_ref_mla_moe as ref
from kubebench import weights_mla_moe
from kubebench.reference import mla_moe as bench_ref
from tpukube_torch.workload import llama, mla_moe

CPU = torch.device("cpu")
SEED = 2 ** 35 + 11
HF = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128,
      "n_routed_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
      "n_shared_experts": 2, "routed_scaling_factor": 2.446, "first_k_dense_replace": 1,
      "num_hidden_layers": 3, "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 50000,
      "assumed": {"e_score_correction_bias_std": 0.05}}
CFG = mla_moe.MlaMoeConfig(
    vocab=256, d_model=64, n_layers=3, first_dense=1, n_heads=4, kv_rank=32, qk_nope_dim=16,
    qk_rope_dim=8, v_dim=16, d_ff_dense=128, n_experts=8, top_k=2, d_expert=32, n_shared=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip (see the module's docstring)")
    return torch.device("cuda", 0)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(llama, "COMPUTE_DTYPE", torch.float32)


def _params(seed=SEED):
    return weights_mla_moe.params(HF, seed, CPU)


def _tokens(n=24, seed=1):
    return torch.randint(0, HF["vocab_size"], (n,), generator=torch.Generator().manual_seed(seed))


def _experts_looped(x, chosen, w_gate, w_up, w_down):
    """``mla_moe.experts_grouped``'s outputs, one expert at a time."""
    T, k = chosen.shape
    out = x.new_zeros(T, k, w_down.shape[-1])
    for e in range(w_gate.shape[0]):
        tok, j = torch.nonzero(chosen == e, as_tuple=True)
        if len(tok):
            out[tok, j] = mla_moe._swiglu(x[tok], w_gate[e], w_up[e], w_down[e])
    return out


def _record(monkeypatch, module, name, keep):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        keep.append(out)
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_config_matches_the_reference_keys():
    big = mla_moe.MlaMoeConfig.moonlight_16b_a3b()
    assert (big.qk_dim, big.n_moe, big.n_experts * big.d_expert) == (192, 26, 90_112)
    counts = [s for _, s, _ in mla_moe.layout(CFG)]
    bench = [s for _, s, *_ in weights_mla_moe.layout(HF)]
    assert counts == bench
    assert [p for p, *_ in mla_moe.layout(CFG)] == [p for p, *_ in weights_mla_moe.layout(HF)]


def test_float32_port_matches_the_reference_with_the_same_choices(f32, monkeypatch):
    params, toks = _params(), _tokens()
    mine, theirs = [], []
    _record(monkeypatch, mla_moe, "route", mine)
    _record(monkeypatch, ref, "route", theirs)
    got = mla_moe.forward(params, toks[None], CFG)[0]
    want = ref.logits(params, toks, HF)
    assert len(mine) == len(theirs) == CFG.n_moe
    for (c1, w1), (c2, w2) in zip(mine, theirs):
        assert torch.equal(c1.sort(-1).values, c2.sort(-1).values)
        torch.testing.assert_close(w1, w2, rtol=1e-5, atol=1e-6)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bf16_port_within_bf16_rounding_of_the_reference(seed, monkeypatch):
    params, toks = _params(SEED + seed), _tokens(48, seed)
    mine, theirs = [], []
    _record(monkeypatch, mla_moe, "route", mine)
    got = mla_moe.forward(params, toks[None], CFG)[0]
    assert got.dtype == torch.float32 and len(mine) == CFG.n_moe
    # the reference routed as the port routed, its weights its own
    chosen = iter(c for c, _ in mine)
    route = ref.route

    def replay(m, layer, cfg):
        c = next(chosen)
        score = torch.sigmoid(m @ layer["router"])
        theirs.append((c, route(m, layer, cfg)[0], score + layer["router_bias"]))
        s = score.gather(-1, c)
        return c, s / (s.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]

    monkeypatch.setattr(ref, "route", replay)
    want = ref.logits(params, toks, HF)
    rms = want.pow(2).mean().sqrt()
    assert (got - want).pow(2).mean().sqrt() <= 3e-2 * rms
    # where the port chose otherwise than the reference would have, the
    # two choices were near ties: within bf16's rounding of the scores
    for port, own, score in theirs:
        a, b = score.gather(-1, port).sum(-1), score.gather(-1, own).sum(-1)
        assert ((b - a) <= 2e-2).all(), (b - a).max()


def test_the_plain_reference_imports_nothing_of_the_program():
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, torch_ref_mla_moe\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=here, capture_output=True, text=True,
                         check=True, env={**os.environ, "PYTHONPATH": here})
    top = set(out.stdout.split())
    assert "torch" in top and not top & {"jax", "jaxlib", "flax", "tpukube", "tpukube_torch",
                                         "kubebench"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_dispatch_equals_the_per_expert_loop(dtype):
    g = torch.Generator().manual_seed(5)
    T, D, E, Fe, k = 40, 64, 8, 32, 3
    x = torch.randn(T, D, generator=g).to(dtype)
    w_gate, w_up = (torch.randn(E, D, Fe, generator=g) * D ** -0.5 for _ in range(2))
    w_down = torch.randn(E, Fe, D, generator=g) * Fe ** -0.5
    # expert 6 gets no row; expert 0 the most
    chosen = torch.stack([torch.randperm(E - 1, generator=g)[:k] for _ in range(T)])
    chosen[:, 0] = torch.where(torch.arange(T) % 2 == 0, 0, chosen[:, 0])
    chosen[chosen == 6] = 7
    chosen = torch.where(chosen[:, :1] == chosen[:, 1:2], chosen.roll(1, 1), chosen)
    out, rows = mla_moe.experts_grouped(x, chosen, w_gate, w_up, w_down)
    want = _experts_looped(x, chosen, w_gate, w_up, w_down)
    assert out.dtype == dtype and out.shape == (T, k, D)
    tol = 0.0 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol * want.abs().max())
    assert rows.tolist() == torch.bincount(chosen.flatten(), minlength=E).tolist()
    assert rows[6] == 0 and int(rows.sum()) == T * k


def test_causal(f32):
    params, toks = _params(), _tokens()
    later = toks.clone()
    later[-4:] = (later[-4:] + 7) % HF["vocab_size"]
    a = mla_moe.forward(params, toks[None], CFG)[0]
    b = mla_moe.forward(params, later[None], CFG)[0]
    torch.testing.assert_close(a[:-4], b[:-4], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(a[-4:], b[-4:])


def test_the_rope_key_is_one_head_shared_by_every_head(f32, monkeypatch):
    keys = []
    core = mla_moe.causal_attention

    def keep(q, k, v):
        keys.append((q, k, v))
        return core(q, k, v)

    monkeypatch.setattr(mla_moe, "causal_attention", keep)
    mla_moe.forward(_params(), _tokens()[None], CFG)
    assert len(keys) == CFG.n_layers
    dn = CFG.qk_nope_dim
    for q, k, v in keys:
        assert q.shape[-1] == k.shape[-1] == CFG.qk_dim and v.shape[-1] == CFG.v_dim
        assert k.shape[2] == CFG.n_heads
        pe = k[..., dn:]
        assert torch.equal(pe, pe[:, :, :1].expand_as(pe))
        assert not torch.equal(k[..., :dn], k[:, :, :1, :dn].expand_as(k[..., :dn]))


def test_halves_equal_the_interleaved_rope_under_the_column_permutation():
    params, toks = _params(), _tokens()
    interleaved = ref.logits(params, toks, HF, interleaved=True)
    halves = ref.logits(ref.halves_from_interleaved(params, HF), toks, HF)
    torch.testing.assert_close(halves, interleaved, rtol=1e-5, atol=1e-5)
    # the permutation matters: unpermuted, the two forms are other models
    assert not torch.allclose(ref.logits(params, toks, HF), interleaved, atol=1e-3)


def test_the_benchmarks_reference_gives_the_same_logits():
    params, toks = _params(), _tokens()
    assert torch.equal(bench_ref.logits(params, toks, HF), ref.logits(params, toks, HF))


def test_init_params_draws_the_layout():
    p = mla_moe.init_params(torch.Generator().manual_seed(0), CFG, CPU)
    assert p["moe"]["w_gate"].shape == (2, 8, 64, 32) and p["moe"]["w_down"].shape == (2, 8, 32, 64)
    assert p["dense"]["w_gate"].shape == (1, 64, 128)
    assert 0 < p["moe"]["router_bias"].std() < 3 * mla_moe.BIAS_STD
    assert torch.equal(p["moe"]["kv_norm"], torch.ones(2, 32))
    out = mla_moe.forward(p, _tokens()[None], CFG)
    assert out.shape == (1, 24, 256) and torch.isfinite(out).all()


@pytest.mark.card
def test_grouped_dispatch_on_the_card_at_moonlight_widths(cuda):
    big = mla_moe.MlaMoeConfig.moonlight_16b_a3b()
    g = torch.Generator(cuda).manual_seed(7)
    T, D, E, Fe = 1385, big.d_model, big.n_experts, big.d_expert
    x = torch.randn(T, D, generator=g, device=cuda).bfloat16()
    w_gate, w_up = (torch.randn(E, D, Fe, generator=g, device=cuda) * D ** -0.5 for _ in range(2))
    w_down = torch.randn(E, Fe, D, generator=g, device=cuda) * Fe ** -0.5
    router = torch.randn(D, E, generator=g, device=cuda) * D ** -0.5
    bias = torch.randn(E, generator=g, device=cuda) * 0.01
    with torch.inference_mode():
        chosen, _ = mla_moe.route(x, router, bias, big)
        want = _experts_looped(x, chosen, w_gate, w_up, w_down)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:  # routing and dispatch wait for nothing on the host
            chosen, _ = mla_moe.route(x, router, bias, big)
            out, rows = mla_moe.experts_grouped(x, chosen, w_gate, w_up, w_down)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # both round each product's output to bf16 once, accumulating in f32
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=1e-2 * float(want.float().abs().max()))
    assert int(rows.sum()) == T * big.top_k and rows.tolist() == torch.bincount(
        chosen.flatten(), minlength=E).tolist()


@pytest.mark.card
def test_the_forward_waits_for_nothing_on_the_card(cuda):
    params = weights_mla_moe.params(HF, SEED, cuda)
    toks = _tokens(48).to(cuda)
    with torch.inference_mode():
        want = mla_moe.forward(params, toks[None], CFG)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = mla_moe.forward(params, toks[None], CFG)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
