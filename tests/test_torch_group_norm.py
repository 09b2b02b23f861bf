"""GroupNorm over ``channels_last`` activations
(``tpukube_torch/kernels/group_norm.py``) and its place in the ResNet.

On the CPU: the module imports without ``triton``; a CPU tensor takes the
plain version, bit for bit what ``F.group_norm`` on the float32 input, the
cast and ``F.relu`` give, gradients included; the ResNet's norms carry
the ReLU where the block had one; the kernels' argument checks and launch
geometry.

The tests marked ``card`` need CUDA and skip without it; on the card:
``python -m pytest tests/test_torch_group_norm.py -m card --noconftest``.
They hold the kernels against the plain version on the card at the
ResNet-50 cell's shapes, batch cut to 2, with ``chip_smoke.norm_check``
(whose docstring states each tolerance and its reason; ``chip_smoke.py``
runs it at the cell's batch, 64), and count the launches of one ResNet-50
step."""

import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

import chip_smoke
from tpukube_torch.graft import free_port
from tpukube_torch.kernels import group_norm as gn
from tpukube_torch.workload import resnet
from tpukube_torch.workload.meshenv import build_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASIC = resnet.ResNetConfig(num_classes=10, width=8, stage_blocks=(1, 1), groups=4,
                            image_size=8)
BOTTLENECK = resnet.ResNetConfig(num_classes=5, width=8, stage_blocks=(1, 1),
                                 bottleneck=True, groups=4, image_size=8)


def _inputs(n, c, hw, dtype, device, seed=0, channels_last=True):
    g = torch.Generator().manual_seed(seed)
    # a per-channel offset, so that groups' means differ and lie off zero
    x = torch.randn((n, c, hw, hw), generator=g) * 2.0 + torch.randn((1, c, 1, 1), generator=g)
    x = x.to(device=device, dtype=dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    scale = (1.0 + 0.5 * torch.randn((c,), generator=g)).to(device)
    bias = (0.5 * torch.randn((c,), generator=g)).to(device)
    dy = torch.randn((n, c, hw, hw), generator=g).to(device=device, dtype=dtype)
    return x, scale, bias, dy.contiguous(memory_format=torch.channels_last)


def _run(fn, x, scale, bias, dy, relu):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, scale, bias)]
    y = fn(*leaves, 32 if x.shape[1] >= 32 else 4, relu=relu)
    grads = torch.autograd.grad(y, leaves, dy)
    return (y.detach(), *grads)


# -- the CPU -----------------------------------------------------------------

def test_module_imports_without_triton():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import torch\n"
        "from tpukube_torch.kernels import group_norm as gn\n"
        "from tpukube_torch.workload import resnet\n"
        "x = torch.randn(2, 8, 4, 4)\n"
        "y = gn.group_norm(x, torch.ones(8), torch.zeros(8), 4, relu=True)\n"
        "assert sys.modules['triton'] is None and y.shape == x.shape\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "nchw"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cpu_takes_the_plain_version_bit_for_bit(dtype, relu, channels_last):
    x, scale, bias, dy = _inputs(2, 16, 5, dtype, "cpu", channels_last=channels_last)

    def old(x, scale, bias, groups, relu):
        y = F.group_norm(x.float(), groups, scale, bias, 1e-5).to(x.dtype)
        return F.relu(y) if relu else y

    got = _run(gn.group_norm, x, scale, bias, dy, relu)
    want = _run(old, x, scale, bias, dy, relu)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _expected_norms(cfg):
    """(channels, relu) of each norm in the order the parent's forward ran
    them: the stem's with its ReLU; in each block every norm but the last
    with one, the last left to the block's ReLU after the residual add."""
    out = [(cfg.width, True)]
    for s, n_blocks in enumerate(cfg.stage_blocks):
        cout = cfg.stage_width(s)
        widths = [cout // 4, cout // 4, cout] if cfg.bottleneck else [cout, cout]
        for _ in range(n_blocks):
            out += [(w, i < len(widths) - 1) for i, w in enumerate(widths)]
    return out


@pytest.mark.parametrize("cfg", [BASIC, BOTTLENECK], ids=["basic", "bottleneck"])
def test_norms_carry_the_relu_where_the_block_had_one(cfg, monkeypatch):
    seen = []

    def record(x, scale, bias, groups, eps=1e-5, relu=False):
        seen.append((x.shape[1], relu))
        return gn.group_norm(x, scale, bias, groups, eps, relu)

    monkeypatch.setattr(resnet, "group_norm", record)
    params = resnet.init_params(torch.Generator().manual_seed(0), cfg, torch.device("cpu"))
    images = torch.randn((2, cfg.image_size, cfg.image_size, 3))
    resnet.forward(params, images, cfg)
    assert seen == _expected_norms(cfg)


def test_resnet50_has_49_norms_all_but_the_blocks_last_with_a_relu():
    norms = _expected_norms(resnet.ResNetConfig.resnet50())
    assert len(norms) == 49
    assert sum(relu for _, relu in norms) == 33


def _bad(**change):
    x, scale, bias, _ = _inputs(1, 64, 4, torch.bfloat16, "cpu")
    args = {"x": x, "scale": scale, "bias": bias, "groups": 32, **change}
    return args


@pytest.mark.parametrize("args,match", [
    (lambda: _bad(x=_bad()["x"].contiguous()), "channels_last"),
    (lambda: _bad(x=_bad()["x"].to(torch.float16)), "bfloat16 or float32"),
    (lambda: _bad(x=_bad()["x"][0]), r"\(N, C, H, W\)"),
    (lambda: _bad(groups=24), "do not divide"),
    (lambda: _bad(groups=0), "do not divide"),
    (lambda: _bad(x=torch.zeros((1, 96, 4, 4), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last), scale=torch.ones(96), bias=torch.zeros(96)),
     "power of two"),
    (lambda: _bad(scale=torch.ones(64, dtype=torch.float64)), "scale must be"),
    (lambda: _bad(bias=torch.zeros(32)), "bias must be"),
], ids=["nchw", "float16", "3d", "groups-24", "groups-0", "width-3", "scale-f64",
        "bias-shape"])
def test_check_refuses_what_the_kernels_do_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        gn.check(**args())


def test_check_takes_bf16_and_f32_nhwc():
    for dtype in (torch.bfloat16, torch.float32):
        x, scale, bias, _ = _inputs(2, 64, 4, dtype, "cpu")
        gn.check(x, scale, bias, 32)


def test_group_norm_runs_on_the_cpu_or_a_card_only():
    x = torch.empty((1, 8, 2, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA card"):
        gn.group_norm(x, torch.ones(8, device="meta"), torch.zeros(8, device="meta"), 4)


def _resnet50_shapes():
    """(C, H*W) of every norm of the cell's ResNet-50 at 224x224, and of
    graft's 64x64 parity batch."""
    cfg = resnet.ResNetConfig.resnet50()
    out = set()
    for size in (224, 64):
        out.add((cfg.width, size * size))
        for s, _ in enumerate(cfg.stage_blocks):
            side = size >> s
            cout = cfg.stage_width(s)
            out |= {(cout // 4, side * side), (cout, side * side)}
        out.add((cfg.stage_width(1) // 4, (size // 2) ** 2))
    return sorted(out)


@pytest.mark.parametrize("n", [64, 2])
@pytest.mark.parametrize("c,hw", _resnet50_shapes())
def test_plan_splits_every_row_once_into_whole_tiles(n, c, hw):
    p = gn.plan(n, c, hw, 32)
    assert p.group_width == c // 32 and p.block_c % p.group_width == 0
    assert c % p.block_c == 0 and p.block_c <= max(gn.MAX_BLOCK_C, p.group_width)
    assert p.block_rows * p.block_c <= max(gn.TILE, p.block_c)
    assert p.rows % p.block_rows == 0
    assert (p.splits - 1) * p.rows < hw <= p.splits * p.rows
    assert 1 <= p.splits <= gn.MAX_SPLITS
    if n == 64:
        # at the cell's batch, four programs or more for each of the card's
        # 132 SMs, or one for each tile where there are fewer tiles
        blocks = n * (c // p.block_c)
        assert blocks * p.splits >= min(4 * 132, blocks * -(-hw // p.block_rows))


# -- the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip (see the module's docstring)")
    return torch.device("cuda", 0)


SHAPES = [(64, 224), (256, 224), (1024, 56), (2048, 28)]


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "plain"])
@pytest.mark.parametrize("c,side", SHAPES, ids=[f"c{c}-{s}" for c, s in SHAPES])
def test_kernels_match_the_plain_version_on_the_card(cuda, c, side, relu, dtype):
    # chip_smoke's step 23 at batch 2: it raises past a bound
    out = chip_smoke.norm_check(c, side, relu, cuda, batch=2, dtype=dtype)
    assert out["launches"] == 4
    assert all(out[k] <= 0 for k in ("y", "dx", "dbias", "dscale"))


@pytest.mark.card
def test_kernels_repeat_bit_for_bit_on_the_card(cuda):
    x, scale, bias, dy = _inputs(2, 256, 224, torch.bfloat16, cuda)
    first = _run(gn.group_norm, x, scale, bias, dy, True)
    again = _run(gn.group_norm, x, scale, bias, dy, True)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.card
def test_a_resnet50_step_launches_the_kernels_for_each_norm(cuda):
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        cfg = resnet.ResNetConfig.resnet50()
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = resnet.init_params(gen, cfg, cuda)
        step = resnet.make_dp_train_step(cfg, build_mesh("cuda", 1, 1), learning_rate=1e-2)
        images = torch.randn((2, 224, 224, 3), generator=gen, device=cuda)
        labels = torch.randint(cfg.num_classes, (2,), generator=gen, device=cuda)
        before = gn.GroupNormNHWC.launches
        params, loss = step(params, images, labels)
        torch.cuda.synchronize()
        # 49 norms, two launches forward and two backward
        assert gn.GroupNormNHWC.launches - before == 49 * 4
        assert torch.isfinite(loss)
        assert all(torch.isfinite(p).all() for p in resnet.param_leaves(params))
    finally:
        dist.destroy_process_group()
