"""Operations and bytes of the decoder (``configs/<name>.json`` with
``"family": "decoder"``), computed from the shapes as the model needs
them, not as an implementation computes them: causal attention counts the
triangle it needs (QK^T and PV over the unmasked positions), whatever the
kernel computes; the training step counts forward and backward, not the
recomputation. A multiply-add is two operations."""

from kubebench.peaks import bound_s

BYTES = 2  # bf16 operands and results of the products


def _dims(cfg: dict) -> tuple:
    D, H, KV = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return D, H, KV, D // H, cfg["intermediate_size"], cfg["vocab_size"], cfg["num_hidden_layers"]


def products(cfg: dict, rows: int) -> list:
    """(m, k, n, count) of the dense products of one forward over ``rows``
    tokens: the projections, the MLP and the unembedding."""
    D, H, KV, HD, F, V, L = _dims(cfg)
    return [
        (rows, D, H * HD, L), (rows, D, KV * HD, 2 * L), (rows, H * HD, D, L),
        (rows, D, F, 2 * L), (rows, F, D, L), (rows, D, V, 1),
    ]


def attention_flops(cfg: dict, seq: int) -> int:
    """QK^T and PV of one sequence over the causal triangle, all layers."""
    D, H, KV, HD, F, V, L = _dims(cfg)
    return L * 2 * H * HD * seq * (seq + 1)


def forward_flops(cfg: dict, seq: int) -> int:
    dense = sum(2 * m * k * n * c for m, k, n, c in products(cfg, seq))
    return dense + attention_flops(cfg, seq)


def dense_bound_s(cfg: dict, rows: int, backward: bool) -> float:
    """The least time of the dense products over ``rows`` tokens: each
    product's larger of flops / peak and bytes / bandwidth (each operand
    read once, the result written once), with, for ``backward``, its two
    gradient products (dX = dY W^T, dW = X^T dY)."""
    total = 0.0
    for m, k, n, c in products(cfg, rows):
        f = 2 * m * k * n
        total += c * bound_s(f, BYTES * (m * k + k * n + m * n))
        if backward:
            total += c * bound_s(f, BYTES * (m * n + k * n + m * k))
            total += c * bound_s(f, BYTES * (m * k + m * n + k * n))
    return total


def dense_flops(cfg: dict, rows: int) -> int:
    return sum(2 * m * k * n * c for m, k, n, c in products(cfg, rows))


# the units a cell completes
def request_flops(cfg: dict, length: int) -> int:
    return forward_flops(cfg, length)


def request_dense_bound_s(cfg: dict, length: int) -> float:
    return dense_bound_s(cfg, length, backward=False)


def step_flops(cfg: dict, traffic: dict) -> int:
    """Forward and backward (twice the forward) of one training step."""
    return 3 * traffic["batch"] * forward_flops(cfg, traffic["seq"])


def step_dense_bound_s(cfg: dict, traffic: dict) -> float:
    return dense_bound_s(cfg, traffic["batch"] * traffic["seq"], backward=True)
