"""Plain PyTorch reference of the ResNet as configured
(``configs/resnet-50-gn-cifarstem.json``): He et al.'s bottleneck
ResNet-50 (stages of 3/4/6/3 blocks of 1x1, 3x3, 1x1 convolutions,
widths 64-2048, stride 2 on the first 1x1 convolution of stages 2-4, a
1x1 projection where the width changes) with GroupNorm (Wu and He) after every convolution, ReLU, a
``stem_kernel`` x ``stem_kernel`` stride-``stem_stride`` stem with no
pooling, global average pooling and a linear head; SAME padding as XLA
defines it (out = ceil(in / stride), the odd pixel of padding at the end).

float32 in NCHW with TF32 off (:func:`kubebench.reference.decoder.precise`);
``precision="fp8"`` rounds every convolution's and the head's operands to
float8 as the decoder's reference does. Images come NHWC. Nothing of the
program is imported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kubebench.reference.decoder import operand


def _same(size: int, k: int, stride: int) -> tuple:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride, precision):
    top, bottom = _same(x.shape[2], w.shape[2], stride)
    left, right = _same(x.shape[3], w.shape[3], stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(operand(x, precision), operand(w, precision), stride=stride)


def norm(x, pair, groups):
    return F.group_norm(x, groups, pair[0], pair[1], eps=1e-5)


def forward(params: dict, images: torch.Tensor, cfg: dict, precision: str = "fp32"):
    """images (N, H, W, 3) -> logits (N, classes) float32."""
    groups = cfg["norm_groups"]
    x = images.float().permute(0, 3, 1, 2)
    x = conv(x, params["stem"], cfg["stem_stride"], precision)
    x = F.relu(norm(x, params["stem_norm"], groups))
    for s, blocks in enumerate(params["stages"]):
        for b, blk in enumerate(blocks):
            stride = 2 if (s > 0 and b == 0) else 1
            y = x
            for i, (w, pair) in enumerate(zip(blk["convs"], blk["norms"])):
                y = norm(conv(y, w, stride if i == 0 else 1, precision), pair, groups)
                if i < 2:
                    y = F.relu(y)
            if "proj" in blk:
                short = conv(x, blk["proj"], stride, precision)
            else:
                short = x[:, :, ::stride, ::stride]
            x = F.relu(short + y)
    return operand(x.mean(dim=(2, 3)), precision) @ operand(params["head"], precision)


def train_steps(params: dict, images, labels, cfg: dict, lr: float, steps: int,
                rows_per_block: int, precision: str = "fp32") -> dict:
    """``steps`` plain SGD steps (p -= lr g) on the mean cross-entropy of
    each batch, in place on ``params``, the batch taken ``rows_per_block``
    images at a time. Returns the losses and each leaf's first gradient
    norm, by the leaf's dotted name."""
    from kubebench.weights import named

    leaves = named(params)
    for t in leaves.values():
        t.requires_grad_(True)
    losses, first = [], {}
    for step in range(steps):
        x, y = images[step], labels[step]
        B = x.shape[0]
        loss = 0.0
        for start in range(0, B, rows_per_block):
            part = F.cross_entropy(forward(params, x[start:start + rows_per_block], cfg, precision),
                                   y[start:start + rows_per_block], reduction="sum") / B
            part.backward()
            loss += float(part.detach())
        losses.append(loss)
        with torch.no_grad():
            for k, p in leaves.items():
                if step == 0:
                    first[k] = float(torch.linalg.vector_norm(p.grad))
                p.sub_(lr * p.grad)
                p.grad = None
    for t in leaves.values():
        t.requires_grad_(False)
    return {"losses": losses, "first_grad": first}
