"""Operations and bytes of the MLA + MoE decoder (``configs/<name>.json``
with ``"family": "mla_moe"``), computed from the shapes as the model needs
them, not as an implementation computes them: a token's work is that of
the experts it is routed to (``num_experts_per_tok`` of them) and the
shared ones, never all of them; causal attention counts the triangle it
needs (QK^T over dn + dr, PV over dv); the router's float32 product
counts as any other. A multiply-add is two operations."""

from kubebench.peaks import bound_s

BYTES = 2  # bf16 operands and results of the products
ROUTER_BYTES = 4  # the router's float32 weights


def _dims(cfg: dict) -> dict:
    H = cfg["num_attention_heads"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    Ld = cfg["first_k_dense_replace"]
    return dict(D=cfg["hidden_size"], H=H, r=cfg["kv_lora_rank"], dq=dn + dr, dn=dn, dr=dr, dv=dv,
                V=cfg["vocab_size"], Ld=Ld, Lm=cfg["num_hidden_layers"] - Ld,
                Fd=cfg["intermediate_size"], E=cfg["n_routed_experts"],
                k=cfg["num_experts_per_tok"], Fe=cfg["moe_intermediate_size"],
                Fs=cfg["n_shared_experts"] * cfg["moe_intermediate_size"])


def products(cfg: dict, rows: int) -> list:
    """(m, k, n, count) of the dense products of one forward over ``rows``
    tokens: every layer's attention projections, the leading dense layers'
    MLP, the MoE layers' shared experts and the unembedding. Neither the
    router nor the routed experts: see :func:`moe_flops`."""
    d = _dims(cfg)
    D, H, L = d["D"], d["H"], d["Ld"] + d["Lm"]
    return [
        (rows, D, H * d["dq"], L), (rows, D, d["r"] + d["dr"], L),
        (rows, d["r"], H * (d["dn"] + d["dv"]), L), (rows, H * d["dv"], D, L),
        (rows, D, d["Fd"], 2 * d["Ld"]), (rows, d["Fd"], D, d["Ld"]),
        (rows, D, d["Fs"], 2 * d["Lm"]), (rows, d["Fs"], D, d["Lm"]),
        (rows, D, d["V"], 1),
    ]


def attention_flops(cfg: dict, seq: int) -> int:
    """QK^T and PV of one sequence over the causal triangle, all layers."""
    d = _dims(cfg)
    return (d["Ld"] + d["Lm"]) * d["H"] * (d["dq"] + d["dv"]) * seq * (seq + 1)


def router_flops(cfg: dict, rows: int) -> int:
    d = _dims(cfg)
    return 2 * rows * d["D"] * d["E"]


def routed_flops(cfg: dict, routed_rows: int) -> int:
    """The routed experts' three products over ``routed_rows`` (token,
    expert) rows."""
    d = _dims(cfg)
    return 3 * 2 * routed_rows * d["D"] * d["Fe"]


def moe_flops(cfg: dict, rows: int) -> int:
    """The routers and routed experts of every MoE layer over ``rows``
    tokens, each token on ``num_experts_per_tok`` experts."""
    d = _dims(cfg)
    return d["Lm"] * (router_flops(cfg, rows) + routed_flops(cfg, rows * d["k"]))


def dense_flops(cfg: dict, rows: int) -> int:
    return sum(2 * m * k * n * c for m, k, n, c in products(cfg, rows))


def forward_flops(cfg: dict, seq: int) -> int:
    return dense_flops(cfg, seq) + moe_flops(cfg, seq) + attention_flops(cfg, seq)


def dense_bound_s(cfg: dict, rows: int) -> float:
    """The least time of :func:`products` over ``rows`` tokens: each
    product's larger of flops / peak and bytes / bandwidth (each operand
    read once, the result written once)."""
    return sum(c * bound_s(2 * m * k * n, BYTES * (m * k + k * n + m * n))
               for m, k, n, c in products(cfg, rows))


def moe_bound_s(cfg: dict, rows_per_expert: list) -> float:
    """The least time of one MoE layer's call (router, routed experts,
    shared experts, combine) whose experts received ``rows_per_expert``:
    its operations over the bf16 peak or its bytes over the bandwidth,
    whichever is larger, taken over the whole call. Bytes: the router's
    float32 weights, each expert that received a row reading its bf16
    weights once, the shared experts' weights, the call's rows in and out
    once."""
    d = _dims(cfg)
    routed = sum(rows_per_expert)
    tokens = routed // d["k"]
    flops = (router_flops(cfg, tokens) + routed_flops(cfg, routed)
             + 3 * 2 * tokens * d["D"] * d["Fs"])
    used = sum(1 for n in rows_per_expert if n > 0)
    nbytes = (ROUTER_BYTES * d["D"] * d["E"] + BYTES * 3 * d["D"] * d["Fe"] * used
              + BYTES * 3 * d["D"] * d["Fs"] + BYTES * 2 * tokens * d["D"])
    return bound_s(flops, nbytes)


# the units a cell completes
def request_flops(cfg: dict, length: int) -> int:
    return forward_flops(cfg, length)


def request_dense_bound_s(cfg: dict, length: int) -> float:
    return dense_bound_s(cfg, length)
