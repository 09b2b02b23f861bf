"""Causal attention's forward kernel (``tpukube_torch/kernels/attention.py``)
and its place in both decoders.

On the CPU: the module imports without ``triton`` and builds nothing; a
CPU tensor takes the plain version, bit for bit the explicit chain the
decoders ran before the kernel (Mistral-7B's grouped heads;
Moonlight-16B-A3B's dq 192 and dv 128 with v a strided slice);
``llama.causal_attention`` takes the chain where autograd needs a gradient
through the call and the kernel's entry otherwise; the argument checks and
``plan()``'s blocks.

The tests marked ``card`` need CUDA and skip without it; on the card:
``python -m pytest tests/test_torch_attention.py -m card --noconftest``.
They hold the kernel against an f32 computation of the same function with
``chip_smoke.attention_check`` (whose docstring states the bounds and
their reason: the kernel's largest error, largest error of a row relative
to that row and mean error each at most 1.25 times the bf16 chain's, the
first two plus half a bf16 ulp), at both decoders' shapes and at two
narrow ones whose head dims fill part of a shared-memory row (dq 24 / dv
16; dq 96 / dv 40), check that a run repeats bit
for bit, that a token never reaches the rows before it, that a CUDA
graph's replay equals the eager call, and count the launches of a
Mistral-7B forward (32), a Moonlight-16B-A3B forward (27) and a decoder
train step (0)."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

import chip_smoke
from tpukube_torch.graft import free_port
from tpukube_torch.kernels import attention
from tpukube_torch.workload import llama, mla_moe, train
from tpukube_torch.workload.meshenv import build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chain(q, k, v):
    """The explicit core as both decoders ran it before the kernel."""
    B, S, H, HD = q.shape
    KV, DV = k.shape[2], v.shape[-1]
    q = q.reshape(B, S, KV, H // KV, HD)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k) * (HD ** -0.5)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~causal, -1e9)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v).reshape(B, S, H * DV)


def _qkv(shape, seq, batch=1, seed=0, device="cpu", dtype=torch.bfloat16):
    """q, k, v at a decoder's head geometry; Moonlight's v a strided slice."""
    H, KV, dq, dv = chip_smoke.ATTENTION_SHAPES[shape]
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((batch, seq, H, dq), generator=g) * 1.5
    k = torch.randn((batch, seq, KV, dq), generator=g)
    v = torch.randn((batch, seq, KV, 128 + dv), generator=g)[..., 128:]
    if shape == "mistral":
        v = v.contiguous()
    return tuple(t.to(device=device, dtype=dtype) for t in (q, k, v))


# -- the CPU -----------------------------------------------------------------

def test_module_imports_without_triton():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch\n"
        "from tpukube_torch.kernels import attention\n"
        "from tpukube_torch.workload import llama, mla_moe\n"
        "q = torch.randn(1, 5, 4, 16, dtype=torch.bfloat16)\n"
        "k = torch.randn(1, 5, 2, 16, dtype=torch.bfloat16)\n"
        "y = llama.causal_attention(q, k, k)\n"
        "assert sys.modules['triton'] is None and y.shape == (1, 5, 64)\n"
        "assert attention.build.cache_info().currsize == 0\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
@pytest.mark.parametrize("shape,seq,batch", [("mistral", 37, 1), ("mistral", 16, 2),
                                             ("moonlight", 29, 1)])
def test_cpu_takes_the_chain_bit_for_bit(shape, seq, batch, grad):
    q, k, v = _qkv(shape, seq, batch, seed=seq)
    want = _chain(q, k, v)
    assert torch.equal(attention.causal_attention_plain(q, k, v), want)
    assert torch.equal(attention.causal_attention_fwd(q, k, v), want)
    if grad:
        q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    with torch.set_grad_enabled(grad):
        got = llama.causal_attention(q, k, v)
    assert torch.equal(got.detach(), want)
    assert got.requires_grad == grad


@pytest.fixture
def spied(monkeypatch):
    """Which of the two paths ``llama.causal_attention`` takes (each spy
    computes the chain itself, so neither calls the other)."""
    calls = []

    def spy(name):
        def wrapped(*args):
            calls.append(name)
            return _chain(*args)
        monkeypatch.setattr(attention, name, wrapped)

    spy("causal_attention_plain")
    spy("causal_attention_fwd")
    return calls


def test_a_gradient_takes_the_chain(spied):
    q, k, v = _qkv("mistral", 9)
    q.requires_grad_(True)
    llama.causal_attention(q, k, v).float().sum().backward()
    assert spied == ["causal_attention_plain"] and q.grad is not None


@pytest.mark.parametrize("mode", ["inference", "no_grad", "no_leaf"])
def test_no_gradient_takes_the_kernels_entry(spied, mode):
    q, k, v = _qkv("moonlight", 9)
    if mode == "inference":
        with torch.inference_mode():
            llama.causal_attention(q, k, v)
    elif mode == "no_grad":
        q.requires_grad_(True)
        with torch.no_grad():
            llama.causal_attention(q, k, v)
    else:  # grad on, but nothing asks for one
        llama.causal_attention(q, k, v)
    assert spied == ["causal_attention_fwd"]


def test_the_train_step_and_remat_take_the_chain(spied):
    cfg = llama.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                            d_ff=64, max_seq=16)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    leaves = [t.requires_grad_(True) for _, t in llama.tree_leaves(params)]
    tokens = torch.randint(0, 64, (2, 9), generator=torch.Generator().manual_seed(1))
    loss = llama.loss_fn(params, tokens, cfg, remat=True)
    torch.autograd.grad(loss, leaves)
    # two blocks forward, then each recomputed in the backward pass
    assert spied == ["causal_attention_plain"] * 4


def test_both_decoders_serve_through_the_kernels_entry(spied):
    cfg = llama.LlamaConfig(vocab=64, d_model=32, n_layers=3, n_heads=4, n_kv_heads=2,
                            d_ff=64, max_seq=16)
    params = llama.init_params(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    tokens = torch.zeros((1, 7), dtype=torch.int64)
    with torch.inference_mode():
        llama.forward(params, tokens, cfg)
        mcfg = mla_moe.MlaMoeConfig()
        mparams = mla_moe.init_params(torch.Generator().manual_seed(0), mcfg,
                                      torch.device("cpu"))
        mla_moe.forward(mparams, tokens, mcfg)
    assert spied == ["causal_attention_fwd"] * (3 + mcfg.n_layers)


def _args(**kw):
    shape = {"q": (1, 8, 4, 128), "k": (1, 8, 2, 128), "v": (1, 8, 2, 128)}
    dtype = {"q": torch.bfloat16, "k": torch.bfloat16, "v": torch.bfloat16}
    for name, val in kw.items():
        (dtype if isinstance(val, torch.dtype) else shape)[name] = val
    return tuple(torch.zeros(shape[n], dtype=dtype[n]) for n in ("q", "k", "v"))


def _offset(shape, by):
    """A contiguous bf16 tensor of ``shape`` starting ``by`` values into its
    storage."""
    n = torch.Size(shape).numel()
    return torch.zeros(n + by, dtype=torch.bfloat16)[by:].view(shape)


@pytest.mark.parametrize("args,match", [
    (_args(q=torch.float32), "bfloat16"),
    (_args(v=torch.float16), "bfloat16"),
    (_args(q=(1, 8, 3, 128)), "do not divide"),
    (_args(q=(1, 8, 4, 100), k=(1, 8, 2, 100)), "multiple of 8"),
    (_args(q=(1, 8, 4, 264), k=(1, 8, 2, 264)), "multiple of 8 from 8 to 256"),
    (_args(q=(1, 8, 4, 4), k=(1, 8, 2, 4)), "multiple of 8"),
    (_args(v=(1, 8, 2, 136)), "multiple of 8 from 8 to 128"),
    (_args(v=(1, 8, 2, 20)), "multiple of 8"),
    (_args(k=(1, 9, 2, 128)), "do not share"),
    (_args(k=(1, 8, 2, 64)), "do not share"),
    (_args(q=(8, 4, 128)), r"\(B, S, heads, d\)"),
    (_args(q=(1, 0, 4, 128), k=(1, 0, 2, 128), v=(1, 0, 2, 128)), "no token"),
    (_args(q=(1, 2, 65_536, 8), k=(1, 2, 1, 8), v=(1, 2, 1, 8)), "past 65535"),
    (_args()[:2] + (torch.zeros((1, 8, 2, 256), dtype=torch.bfloat16)[..., ::2],),
     "contiguous"),
    (_args()[:2] + (_offset((1, 8, 2, 128), 4),), "16-byte"),
    ((torch.zeros((1, 8, 4, 132), dtype=torch.bfloat16)[..., :128],) + _args()[1:],
     "16-byte"),
], ids=["q-f32", "v-f16", "heads", "dq-100", "dq-264", "dq-4", "dv-136", "dv-20", "seq",
        "dq-k", "rank", "empty", "grid", "v-strided-d", "v-misaligned", "q-row-stride"])
def test_check_refuses_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        attention.check(*args)


@pytest.mark.parametrize("shape", ["mistral", "moonlight", "narrow", "dv40"])
def test_check_takes_both_decoders_shapes(shape):
    attention.check(*_qkv(shape, 5))


def test_causal_attention_runs_on_the_cpu_or_a_card_only():
    q = torch.empty((1, 4, 2, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        attention.causal_attention_fwd(q, q, q)


@pytest.mark.parametrize("dq,dv", [(8, 8), (24, 16), (96, 40), (112, 112), (128, 128),
                                   (192, 128), (256, 128)])
def test_plan_fills_a_blocks_shared_memory(dq, dv):
    p = attention.plan(dq, dv)
    room = attention.BLOCK_SHARED_BYTES - attention.STATIC_SHARED_BYTES
    assert (p.dq, p.dv, p.block_m, p.block_n) == (dq, dv, 128, 64)
    assert 2 <= p.stages <= attention.MAX_STAGES and p.shared_bytes <= room
    # one stage more would not fit, or would pass the most in flight
    more = dataclasses.replace(p, stages=p.stages + 1)
    assert p.stages == attention.MAX_STAGES or more.shared_bytes > room
    # the flags name every constant the source needs
    assert {f"-DTK_{k}={v}" for k, v in (("DQ", dq), ("DV", dv), ("BM", 128), ("BN", 64),
                                         ("STAGES", p.stages))} <= set(p.flags())


def test_plan_blocks_for_both_decoders():
    assert attention.plan(128, 128) == attention.Plan(128, 128, 128, 64, 4)
    # dq 192 as three 128-byte rows of shared memory, not padded to 256
    assert attention.plan(192, 128) == attention.Plan(192, 128, 128, 64, 4)
    assert attention.plan(192, 128).shared_bytes == 2 * (128 * 192 + 4 * 64 * 320) + 1024
    # a fourth stage of k and v would not fit beside q in shared memory
    assert attention.plan(256, 128).stages == 3


# -- the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip (see the module's docstring)")
    return torch.device("cuda", 0)


LENGTHS = (1, 17, 256, 979, 1385, 4096)


@pytest.mark.card
@pytest.mark.parametrize("seq", LENGTHS)
@pytest.mark.parametrize("shape", ["mistral", "moonlight"])
def test_kernel_holds_to_f32_as_the_chain_does(cuda, shape, seq):
    # chip_smoke's step 24 at these lengths: it raises past a bound
    out = chip_smoke.attention_check(shape, seq, cuda)
    assert out["kernel_max"] <= out["bound"] and out["kernel_row"] <= out["row_bound"]
    assert out["kernel_mean"] <= out["mean_bound"]


@pytest.mark.card
@pytest.mark.parametrize("seq", [1, 17, 130, 979])
@pytest.mark.parametrize("shape", ["narrow", "dv40"])
def test_narrow_heads_hold_to_f32_as_the_chain_does(cuda, shape, seq):
    # head dims that fill part of a 128-byte row of shared memory
    out = chip_smoke.attention_check(shape, seq, cuda)
    assert out["kernel_max"] <= out["bound"] and out["kernel_row"] <= out["row_bound"]
    assert out["kernel_mean"] <= out["mean_bound"]


@pytest.mark.card
@pytest.mark.parametrize("shape", ["mistral", "moonlight"])
def test_kernel_repeats_bit_for_bit(cuda, shape):
    q, k, v = _qkv(shape, 979, device=cuda)
    assert torch.equal(attention.causal_attention_fwd(q, k, v),
                       attention.causal_attention_fwd(q, k, v))


@pytest.mark.card
@pytest.mark.parametrize("t", [0, 63, 200, 640])
@pytest.mark.parametrize("shape", ["mistral", "moonlight"])
def test_a_token_never_reaches_the_rows_before_it(cuda, shape, t):
    q, k, v = _qkv(shape, 700, batch=2, device=cuda)
    base = attention.causal_attention_fwd(q, k, v)
    q2, k2, v2 = (x.clone() for x in (q, k, v))
    for x in (q2, k2, v2):
        x[:, t] = torch.randn(x[:, t].shape, device=cuda).to(x.dtype)
    moved = attention.causal_attention_fwd(q2, k2, v2)
    assert torch.equal(moved[:, :t], base[:, :t])
    assert not torch.equal(moved[:, t], base[:, t])


@pytest.mark.card
@pytest.mark.parametrize("shape", ["mistral", "moonlight"])
def test_a_graph_replay_equals_the_eager_call(cuda, shape):
    q, k, v = _qkv(shape, 1385, device=cuda)
    want = attention.causal_attention_fwd(q, k, v)  # built outside the capture
    torch.cuda.synchronize()
    static = [x.clone() for x in (q, k, v)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = attention.causal_attention_fwd(*static)
    for x in static:
        x.zero_()
    for x, y in zip(static, (q, k, v)):
        x.copy_(y)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.card
def test_a_mistral_forward_launches_the_kernel_once_a_layer(cuda):
    # Mistral-7B's depth and heads; the MLP and vocabulary cut, which the
    # count does not read
    cfg = llama.LlamaConfig(vocab=512, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
                            d_ff=256, max_seq=4096, rope_theta=1e6)
    params = llama.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    before = attention.launches
    with torch.inference_mode():
        logits = llama.forward(params, torch.zeros((1, 300), dtype=torch.int64, device=cuda), cfg)
    torch.cuda.synchronize()
    assert attention.launches - before == 32
    assert torch.isfinite(logits).all()


@pytest.mark.card
def test_a_moonlight_forward_launches_the_kernel_once_a_layer(cuda):
    # Moonlight-16B-A3B's depth and attention heads; its widths elsewhere cut
    cfg = dataclasses.replace(
        mla_moe.MlaMoeConfig.moonlight_16b_a3b(), vocab=512, d_model=512, d_ff_dense=256,
        n_experts=8, top_k=2, d_expert=64)
    params = mla_moe.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    before = attention.launches
    with torch.inference_mode():
        logits = mla_moe.forward(params, torch.zeros((1, 300), dtype=torch.int64, device=cuda),
                                 cfg)
    torch.cuda.synchronize()
    assert attention.launches - before == 27
    assert torch.isfinite(logits).all()


@pytest.mark.card
def test_a_decoder_train_step_launches_no_kernel(cuda):
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        cfg = llama.LlamaConfig(vocab=512, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_ff=256, max_seq=512)
        params = llama.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
        for _, leaf in llama.tree_leaves(params):
            leaf.requires_grad_(True)
        step, opt_init = train.make_train_step(cfg, build_mesh("cuda", 1, 1))
        state = opt_init(params)
        tokens = torch.randint(0, 512, (2, 257), device=cuda)
        before = attention.launches
        params, state, loss = step(params, state, tokens)
        torch.cuda.synchronize()
        assert attention.launches - before == 0
        assert torch.isfinite(loss)
    finally:
        dist.destroy_process_group()
