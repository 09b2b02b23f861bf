"""Weights and inputs made on the device from ``--seed``.

The benchmark makes these, in the port's parameter layout, and hands the
same tensors to the program (inside each pod) and to the plain reference
(after the window): both call the functions here with the same seed and
get the same numbers, on the same kind of device. Each leaf is drawn from
a generator of its own, so a leaf can be made again alone. Imports nothing
of the program.
"""

from __future__ import annotations

import torch

from kubebench.traffic import subseed


def _gen(seed: int, device: torch.device, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *salt))


def _normal(shape, scale: float, shift: float, seed: int, salt: tuple,
            device: torch.device) -> torch.Tensor:
    t = torch.randn(shape, generator=_gen(seed, device, *salt), device=device,
                    dtype=torch.float32)
    return t.mul_(scale).add_(shift) if shift else t.mul_(scale)


# ---------------------------------------------------------------- decoder
def decoder_layout(cfg: dict) -> list:
    """(path, shape, scale, shift) of every leaf of the port's decoder tree
    (``tpukube_torch.workload.llama``: layer-stacked leading axis, float32);
    a leaf is N(shift, scale**2)."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, KV, V, F = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["vocab_size"], cfg["intermediate_size"])
    HD = D // H
    gain = (0.1, 1.0)  # norm gains near one, so the check sees them
    return [
        (("embed",), (V, D), D ** -0.5, 0.0),
        (("layers", "attn_norm"), (L, D), *gain),
        (("layers", "wq"), (L, D, H * HD), D ** -0.5, 0.0),
        (("layers", "wk"), (L, D, KV * HD), D ** -0.5, 0.0),
        (("layers", "wv"), (L, D, KV * HD), D ** -0.5, 0.0),
        (("layers", "wo"), (L, H * HD, D), (H * HD) ** -0.5, 0.0),
        (("layers", "mlp_norm"), (L, D), *gain),
        (("layers", "w_gate"), (L, D, F), D ** -0.5, 0.0),
        (("layers", "w_up"), (L, D, F), D ** -0.5, 0.0),
        (("layers", "w_down"), (L, F, D), F ** -0.5, 0.0),
        (("final_norm",), (D,), *gain),
        (("unembed",), (D, V), D ** -0.5, 0.0),
    ]


def decoder_leaf(cfg: dict, seed: int, index: int, device: torch.device) -> torch.Tensor:
    _, shape, scale, shift = decoder_layout(cfg)[index]
    return _normal(shape, scale, shift, seed, (10, index), device)


def nest(leaves) -> dict:
    tree: dict = {}
    for path, value in leaves:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def decoder_params(cfg: dict, seed: int, device: torch.device) -> dict:
    return nest((path, decoder_leaf(cfg, seed, i, device))
                for i, (path, *_) in enumerate(decoder_layout(cfg)))


def token_pool(seed: int, n: int, vocab: int, device: torch.device) -> torch.Tensor:
    """``n`` token ids, uniform over the vocabulary."""
    return torch.randint(vocab, (n,), generator=_gen(seed, device, 20),
                         device=device, dtype=torch.int64)


def train_batches(seed: int, pool: int, batch: int, seq: int, vocab: int,
                  device: torch.device) -> torch.Tensor:
    """(pool, batch, seq + 1) token ids: each row a sequence and its next
    token targets; every row differs."""
    return torch.randint(vocab, (pool, batch, seq + 1), generator=_gen(seed, device, 21),
                         device=device, dtype=torch.int64)


# ----------------------------------------------------------------- resnet
def resnet_layout(cfg: dict) -> list:
    """(path, shape, scale, shift) of the port's ResNet tree
    (``tpukube_torch.workload.resnet``): OIHW convs, He-normal; (scale,
    bias) norm pairs; the head (features, classes)."""
    out = []

    def conv(path, k, cin, cout):
        out.append((path, (cout, cin, k, k), (2.0 / (k * k * cin)) ** 0.5, 0.0))

    def norm(path, c):
        out.append((path + (0,), (c,), 0.1, 1.0))
        out.append((path + (1,), (c,), 0.1, 0.0))

    w, exp = cfg["width"], cfg["bottleneck_expansion"]
    conv(("stem",), cfg["stem_kernel"], 3, w)
    norm(("stem_norm",), w)
    cin = w
    for s, n in enumerate(cfg["stage_blocks"]):
        cout = w * 2 ** s * exp
        mid = cout // exp
        for b in range(n):
            p = ("stages", s, b)
            for i, (k, ci, co) in enumerate(((1, cin, mid), (3, mid, mid), (1, mid, cout))):
                conv(p + ("convs", i), k, ci, co)
                norm(p + ("norms", i), co)
            if cin != cout:
                conv(p + ("proj",), 1, cin, cout)
            cin = cout
    out.append((("head",), (cin, cfg["num_classes"]), cin ** -0.5, 0.0))
    return out


def resnet_leaf(cfg: dict, seed: int, index: int, device: torch.device) -> torch.Tensor:
    _, shape, scale, shift = resnet_layout(cfg)[index]
    return _normal(shape, scale, shift, seed, (30, index), device)


def resnet_params(cfg: dict, seed: int, device: torch.device) -> dict:
    """The port's tree: lists of blocks, lists of convs, (scale, bias)
    tuples."""
    tree: dict = {"stages": [[] for _ in cfg["stage_blocks"]]}
    for i, (path, *_) in enumerate(resnet_layout(cfg)):
        leaf = resnet_leaf(cfg, seed, i, device)
        if path[0] != "stages":
            if len(path) == 1:
                tree[path[0]] = leaf
            else:
                tree.setdefault(path[0], [None, None])[path[1]] = leaf
            continue
        _, s, b, key, *rest = path
        blocks = tree["stages"][s]
        if len(blocks) <= b:
            blocks.append({"convs": [], "norms": []})
        if key == "proj":
            blocks[b]["proj"] = leaf
        elif key == "convs":
            blocks[b]["convs"].append(leaf)
        elif rest[1] == 0:
            blocks[b]["norms"].append([leaf, None])
        else:
            blocks[b]["norms"][-1][1] = leaf
    tree["stem_norm"] = tuple(tree["stem_norm"])
    for blocks in tree["stages"]:
        for blk in blocks:
            blk["norms"] = [tuple(n) for n in blk["norms"]]
    return tree


def named(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a param tree; the paths are those of
    :func:`decoder_layout` and :func:`resnet_layout` joined by dots."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


LAYOUTS = {"decoder": decoder_layout, "resnet": resnet_layout}
LEAF = {"decoder": decoder_leaf, "resnet": resnet_leaf}


def initial_leaf(family: str, cfg: dict, seed: int, name: str,
                 device: torch.device) -> torch.Tensor:
    """The leaf ``name`` as :func:`decoder_params` / :func:`resnet_params`
    made it from ``seed``."""
    paths = [".".join(map(str, p)) for p, *_ in LAYOUTS[family](cfg)]
    return LEAF[family](cfg, seed, paths.index(name), device)


def images(seed: int, pool: int, batch: int, size: int, classes: int,
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(pool, batch, size, size, 3) float32 NHWC images and (pool, batch)
    labels."""
    g = _gen(seed, device, 31)
    x = torch.randn((pool, batch, size, size, 3), generator=g, device=device)
    y = torch.randint(classes, (pool, batch), generator=g, device=device)
    return x, y
