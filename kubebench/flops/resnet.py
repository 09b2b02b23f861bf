"""Operations and bytes of the ResNet (``"family": "resnet"``), computed
from the shapes of the configuration as run: every convolution with
XLA's SAME padding (out = ceil(in / stride)) and the head. A
multiply-add is two operations; a training step is the forward and the
backward (twice the forward)."""

from kubebench.peaks import bound_s

BYTES = 2  # bf16 convolutions


def convs(cfg: dict) -> list:
    """(h_in, h_out, cin, cout, k) of each (square) convolution of one
    image."""
    out = []
    size = cfg["image_size"]

    def conv(h, cin, cout, k, stride):
        ho = -(-h // stride)
        out.append((h, ho, cin, cout, k))
        return ho

    w, exp = cfg["width"], cfg["bottleneck_expansion"]
    size = conv(size, 3, w, cfg["stem_kernel"], cfg["stem_stride"])
    cin = w
    for s, n in enumerate(cfg["stage_blocks"]):
        cout = w * 2 ** s * exp
        mid = cout // exp
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            h = conv(size, cin, mid, 1, stride)
            conv(h, mid, mid, 3, 1)
            conv(h, mid, cout, 1, 1)
            if cin != cout:
                conv(size, cin, cout, 1, stride)
            size, cin = h, cout
    return out


def features(cfg: dict) -> int:
    """The width of the last stage, the head's input."""
    return cfg["width"] * 2 ** (len(cfg["stage_blocks"]) - 1) * cfg["bottleneck_expansion"]


def _conv_flops(c) -> int:
    _, ho, cin, cout, k = c
    return 2 * ho * ho * cout * cin * k * k


def forward_flops(cfg: dict) -> int:
    """One image: the convolutions and the head."""
    head = 2 * features(cfg) * cfg["num_classes"]
    return sum(map(_conv_flops, convs(cfg))) + head


def dense_bound_s(cfg: dict, batch: int) -> float:
    """The least time of one step's convolutions and head, forward and
    both backward products, over ``batch`` images."""
    total = 0.0
    for c in convs(cfg):
        hin, ho, cin, cout, k = c
        f = batch * _conv_flops(c)
        x = batch * hin * hin * cin
        y = batch * ho * ho * cout
        wt = cout * cin * k * k
        # forward reads x, w and writes y; dgrad reads dy, w, writes dx;
        # wgrad reads x, dy, writes dw
        total += bound_s(f, BYTES * (x + wt + y)) + bound_s(f, BYTES * (y + wt + x)) \
            + bound_s(f, BYTES * (x + y + wt))
    feat = features(cfg)
    head = 2 * batch * feat * cfg["num_classes"]
    total += 3 * bound_s(head, 4 * (batch * feat + feat * cfg["num_classes"]
                                    + batch * cfg["num_classes"]))
    return total


def step_flops(cfg: dict, traffic: dict) -> int:
    return 3 * traffic["batch"] * forward_flops(cfg)


def step_dense_bound_s(cfg: dict, traffic: dict) -> float:
    return dense_bound_s(cfg, traffic["batch"])
