"""ResNet-style conv net in PyTorch — the port of ``tpukube/workload/resnet.py``.

The reference's contract stays at the public functions: images come in
NHWC, the param tree has the reference's keys (lists of blocks, (scale,
bias) norm tuples), float32 params, bfloat16 compute and float32 logits.
Inside, activations are NCHW in ``channels_last`` memory (the NHWC bytes
the caller passed) and conv weights are OIHW; :func:`params_from_numpy`
transposes the reference's HWIO leaves.

Rounding points follow the reference:

- SAME padding computed as XLA does: a stride-2 3×3 conv on an even input
  pads (0, 1), not ``padding=1``'s (1, 1); asymmetric pads go through
  ``F.pad``;
- GroupNorm statistics and its scale/bias in float32 (``F.group_norm`` on
  the float32 input groups contiguous channels, as the reference does),
  then cast to bfloat16;
- the global average pool in float32, then the head in float32.

:func:`make_dp_train_step` is the reference's data-parallel SGD step: the
batch split over ``dp`` (``("dcn", "dp")`` on a multislice mesh), params
replicated, gradients averaged by an explicit all-reduce. While a torch
profiler runs, a step is a ``tpukube.step`` span around its
``tpukube.grads`` and ``tpukube.update`` spans (:mod:`tpukube_torch.obs.spans`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tpukube_torch.obs.spans import span
from tpukube_torch.workload import tp as tpc
from tpukube_torch.workload.meshenv import batch_group, mesh_device

# The dtype activations are computed in: the reference's bfloat16. The
# parity tests set float32 (in a process of their own) to hold the
# algorithm against the reference's at float32, below bf16's noise.
COMPUTE_DTYPE = torch.bfloat16


@dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 10
    width: int = 16          # stem channels; stages double it
    stage_blocks: tuple[int, ...] = (1, 1, 1)
    bottleneck: bool = False  # True => 1x1/3x3/1x1 blocks (ResNet-50 style)
    groups: int = 8           # GroupNorm groups (must divide widths)
    image_size: int = 32

    @staticmethod
    def resnet50(num_classes: int = 1000) -> "ResNetConfig":
        """The reference's ResNet-50 shape."""
        return ResNetConfig(
            num_classes=num_classes, width=64,
            stage_blocks=(3, 4, 6, 3), bottleneck=True, groups=32,
            image_size=224,
        )

    def stage_width(self, stage: int) -> int:
        w = self.width * (2 ** stage)
        return w * 4 if self.bottleneck else w


def _map_convs(tree: dict, fn) -> dict:
    """The tree with ``fn`` applied to every conv weight, the rest as is."""
    return {
        "stem": fn(tree["stem"]),
        "stem_norm": tree["stem_norm"],
        "stages": [
            [
                {
                    **b,
                    "convs": [fn(w) for w in b["convs"]],
                    **({"proj": fn(b["proj"])} if "proj" in b else {}),
                }
                for b in blocks
            ]
            for blocks in tree["stages"]
        ],
        "head": tree["head"],
    }


def map_params(tree, fn):
    """The param tree with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_params(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_params(v, fn) for v in tree)
    return fn(tree)


def params_from_numpy(tree: dict, device: torch.device) -> dict:
    """Copy the reference's numpy param tree onto ``device``: float32
    leaves, conv weights transposed HWIO → OIHW. The copies are the
    port's own, so training them in place leaves the arrays as they were."""
    t = map_params(tree, lambda a: torch.tensor(np.asarray(a, np.float32), device=device))
    return _map_convs(t, lambda w: w.permute(3, 2, 0, 1).contiguous())


def params_to_numpy(tree: dict) -> dict:
    """The inverse of :func:`params_from_numpy`: a numpy copy in the
    reference's layout."""
    t = _map_convs(tree, lambda w: w.permute(2, 3, 1, 0))
    return map_params(t, lambda x: x.detach().cpu().numpy().copy())


def init_params(generator: torch.Generator, cfg: ResNetConfig,
                device: torch.device) -> dict:
    """float32 params (He-normal convs, unit/zero norms, a 1/sqrt(fan-in)
    head), drawn from ``generator`` on ``device``; the reference's shapes
    and scales, not its numbers."""

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    def conv(kh, kw, cin, cout):
        return normal((cout, cin, kh, kw)).mul_((2.0 / (kh * kw * cin)) ** 0.5)

    def norm(c):
        return (torch.ones(c, device=device), torch.zeros(c, device=device))

    params: dict = {"stem": conv(3, 3, 3, cfg.width), "stem_norm": norm(cfg.width),
                    "stages": []}
    cin = cfg.width
    for s, n_blocks in enumerate(cfg.stage_blocks):
        cout = cfg.stage_width(s)
        blocks = []
        for _ in range(n_blocks):
            if cfg.bottleneck:
                mid = cout // 4
                convs = [conv(1, 1, cin, mid), conv(3, 3, mid, mid), conv(1, 1, mid, cout)]
            else:
                convs = [conv(3, 3, cin, cout), conv(3, 3, cout, cout)]
            block = {"convs": convs, "norms": [norm(w.shape[0]) for w in convs]}
            if cin != cout:
                block["proj"] = conv(1, 1, cin, cout)
            blocks.append(block)
            cin = cout
        params["stages"].append(blocks)
    params["head"] = normal((cin, cfg.num_classes)).mul_(cin ** -0.5)
    return params


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    (ph_lo, ph_hi), (pw_lo, pw_hi) = (
        _same_pads(x.shape[2], w.shape[2], stride),
        _same_pads(x.shape[3], w.shape[3], stride),
    )
    w = w.to(dtype=x.dtype, memory_format=torch.channels_last)
    if ph_lo == ph_hi and pw_lo == pw_hi:
        return F.conv2d(x, w, stride=stride, padding=(ph_lo, pw_lo))
    x = F.pad(x, (pw_lo, pw_hi, ph_lo, ph_hi))
    return F.conv2d(x, w, stride=stride)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int, eps: float = 1e-5) -> torch.Tensor:
    return F.group_norm(x.float(), groups, scale, bias, eps).to(x.dtype)


def _apply_block(x: torch.Tensor, p: dict, cfg: ResNetConfig,
                 stride: int) -> torch.Tensor:
    y = x
    n = len(p["convs"])
    for i, (w, (scale, bias)) in enumerate(zip(p["convs"], p["norms"])):
        y = _conv(y, w, stride=stride if i == 0 else 1)
        y = _group_norm(y, scale, bias, cfg.groups)
        if i < n - 1:
            y = F.relu(y)
    if "proj" in p:
        x = _conv(x, p["proj"], stride=stride)
    elif stride != 1:
        x = x[:, :, ::stride, ::stride]
    return F.relu(x + y)


def forward(params: dict, images: torch.Tensor, cfg: ResNetConfig) -> torch.Tensor:
    """images (N, H, W, 3), any float dtype -> logits (N, num_classes)
    float32. Compute in ``COMPUTE_DTYPE``."""
    x = images.to(COMPUTE_DTYPE).permute(0, 3, 1, 2)  # NCHW, channels_last
    x = x.contiguous(memory_format=torch.channels_last)
    x = F.relu(_group_norm(_conv(x, params["stem"]), *params["stem_norm"], cfg.groups))
    for s, blocks in enumerate(params["stages"]):
        for b, p in enumerate(blocks):
            x = _apply_block(x, p, cfg, 2 if (s > 0 and b == 0) else 1)
    x = x.float().mean(dim=(2, 3))  # global average pool
    return x @ params["head"]


def loss_fn(params: dict, images: torch.Tensor, labels: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    logp = torch.log_softmax(forward(params, images, cfg), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


def param_leaves(tree) -> list:
    """The leaves of a param tree, dict keys sorted: the order every rank
    walks it, and so the order of the per-leaf all-reduces."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in param_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in param_leaves(v)]
    return [tree]


def make_dp_train_step(cfg: ResNetConfig, mesh: DeviceMesh,
                       learning_rate: float = 1e-2):
    """-> step(params, images, labels) -> (params, loss): plain SGD over
    the mesh's batch ranks. ``images`` (N, H, W, 3) and ``labels`` (N,) are
    the global batch, the same on every rank; each rank takes its rows,
    gradients are all-reduced and averaged over the batch ranks, and every
    rank applies the same update in place. ``loss`` is the global-batch
    mean. Building it is collective (the multislice batch group)."""
    group = batch_group(mesh)
    rank, ranks = dist.get_rank(group), dist.get_world_size(group)
    device = mesh_device(mesh)

    def rows(a) -> torch.Tensor:
        a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
        if a.shape[0] % ranks:
            raise ValueError(f"batch {a.shape[0]} does not split over {ranks} ranks")
        n = a.shape[0] // ranks
        return a[rank * n:(rank + 1) * n].to(device)

    def step(params: dict, images, labels):
        with span("tpukube.step", device):
            leaves = param_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            with span("tpukube.grads", device):
                loss = loss_fn(params, rows(images), rows(labels), cfg)
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad(), span("tpukube.update", device):
                for p, g in zip(leaves, grads):
                    g = g.contiguous()
                    dist.all_reduce(g, group=group)
                    p.sub_(g.div_(ranks), alpha=learning_rate)
                loss = tpc.all_reduce(loss.detach(), group).div_(ranks)
        return params, loss

    return step
