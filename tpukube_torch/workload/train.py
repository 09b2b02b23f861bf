"""dp × tp (× dcn) training step of the Llama decoder over a ``DeviceMesh`` —
the port of ``tpukube/workload/train.py``.

The reference declares its parallelism (PartitionSpecs, sequence-sharding
constraints) and lets GSPMD insert the collectives. Here each rank holds
its shard of the same param tree, and the collectives are written out with
their conjugates (:mod:`tpukube_torch.workload.tp`):

- column-parallel ``wq``/``wk``/``wv``, ``w_gate``/``w_up`` and the
  unembed (vocabulary columns), row-parallel ``wo``/``w_down``, the embed
  sharded over vocabulary rows, norm gains replicated (:func:`param_specs`);
- with ``seq_parallel`` the residual stream stays sequence-sharded over tp
  between blocks (the reference's ``sp_forward``): each region is entered
  by an all-gather on the sequence and left by a reduce-scatter. S is
  padded at its end to a multiple of tp; causal attention keeps the real
  positions blind to the padding, RoPE sees global positions (it runs
  after the gather), and the padding is dropped before the loss;
- the batch is split over ``dp`` (``("dcn", "dp")`` on a multislice mesh),
  gradients are averaged over it, and the loss returned is the mean over
  the global batch on every rank;
- where tp exceeds the kv heads, a rank holds the kv heads its query heads
  read (query head h reads kv head ``h // (H // KV)``), and the ranks that
  share a kv head sum its gradients.

The optimizer is the reference's ``optax.chain(clip_by_global_norm(1.0),
adamw(lr))``. The step updates params and optimizer state in place, as
``torch.optim`` does; the reference's buffer donation (``donate``) has no
counterpart here and is not emulated.

While a torch profiler runs, a step is a ``tpukube.step`` span around its
``tpukube.grads``, ``tpukube.grad_norm`` and ``tpukube.update`` spans
(:mod:`tpukube_torch.obs.spans`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tpukube_torch.obs.spans import span
from tpukube_torch.workload import llama
from tpukube_torch.workload import tp as tpc
from tpukube_torch.workload.llama import (
    LlamaConfig,
    _rmsnorm,
    init_leaves,
    run_blocks,
    tree_from_leaves,
    tree_leaves,
)
from tpukube_torch.workload.meshenv import batch_group, mesh_device

NORMS = ("attn_norm", "mlp_norm", "final_norm")
KV_LEAVES = ("wk", "wv")


def param_specs(cfg: LlamaConfig) -> dict:
    """The reference's PartitionSpec tree, as one tuple of mesh-axis names
    (or None) per dimension of each leaf."""
    col, row = (None, None, "tp"), (None, "tp", None)
    return {
        "embed": ("tp", None),
        "layers": {
            "attn_norm": (None, None),
            "wq": col, "wk": col, "wv": col, "wo": row,
            "mlp_norm": (None, None),
            "w_gate": col, "w_up": col, "w_down": row,
        },
        "final_norm": (None,),
        "unembed": (None, "tp"),
    }


def check_tp(cfg: LlamaConfig, tp: int) -> None:
    """Raise ValueError where ``cfg`` does not shard evenly over ``tp``."""
    for name, size in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                       ("vocab", cfg.vocab)):
        if size % tp:
            raise ValueError(f"{name}={size} does not divide over tp={tp}")
    KV = cfg.n_kv_heads
    if KV % tp and tp % KV:
        raise ValueError(
            f"n_kv_heads={KV} and tp={tp}: one must divide the other"
        )


def _kv_heads(cfg: LlamaConfig, tp: int, tp_rank: int) -> tuple[int, int]:
    """(first kv head, count) that tp rank ``tp_rank`` holds: its share of
    the kv heads, or, where tp exceeds them, the one kv head its query
    heads read."""
    KV = cfg.n_kv_heads
    if KV % tp == 0:
        return tp_rank * (KV // tp), KV // tp
    return tp_rank // (tp // KV), 1


def _spec(specs: dict, path: tuple) -> tuple:
    for k in path:
        specs = specs[k]
    return specs


@dataclass(frozen=True)
class _Shard:
    """How the leaves of one tp rank are cut."""

    cfg: LlamaConfig
    tp: int
    tp_rank: int

    def cut(self, path: tuple, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice (a view) of a full leaf."""
        dims = _spec(param_specs(self.cfg), path)
        if "tp" not in dims:
            return full
        d = dims.index("tp")
        if path[-1] in KV_LEAVES:
            first, n = _kv_heads(self.cfg, self.tp, self.tp_rank)
            hd = self.cfg.head_dim
            return full.narrow(d, first * hd, n * hd)
        part = full.shape[d] // self.tp
        return full.narrow(d, self.tp_rank * part, part)

    @property
    def kv_shared(self) -> bool:
        return self.tp > self.cfg.n_kv_heads


def _tp_shard(cfg: LlamaConfig, mesh: DeviceMesh) -> _Shard:
    tp = mesh.size(mesh.mesh_dim_names.index("tp"))
    check_tp(cfg, tp)
    return _Shard(cfg, tp, mesh.get_local_rank("tp"))


def _trainable(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.float32).clone().requires_grad_(True)


def shard_params(tree: dict, mesh: DeviceMesh, cfg: LlamaConfig) -> dict:
    """This rank's shard of a full param tree (numpy arrays or tensors,
    e.g. the reference's params through ``np.asarray``), as trainable
    float32 leaves on the rank's device."""
    shard, device = _tp_shard(cfg, mesh), mesh_device(mesh)
    return tree_from_leaves(
        (path, _trainable(shard.cut(path, torch.as_tensor(np.asarray(leaf))
                                    if not torch.is_tensor(leaf) else leaf), device))
        for path, leaf in tree_leaves(tree)
    )


def init_sharded(generator: torch.Generator, cfg: LlamaConfig,
                 mesh: DeviceMesh) -> dict:
    """Params laid out per :func:`param_specs`, drawn from ``generator``
    (on the rank's device) in :func:`~tpukube_torch.workload.llama.init_params`'
    order, so the gathered tree equals ``init_params`` from the same seed.
    Each full leaf lives only until its shard is cut."""
    shard, device = _tp_shard(cfg, mesh), mesh_device(mesh)
    return tree_from_leaves(
        (path, _trainable(shard.cut(path, full), device))
        for path, full in init_leaves(generator, cfg, device)
    )


def gather_params(tree: dict, mesh: DeviceMesh, cfg: LlamaConfig) -> dict:
    """The inverse of :func:`shard_params` (params or gradients): the full
    tree, detached, on every rank. Collective over tp."""
    shard = _tp_shard(cfg, mesh)
    group = mesh.get_group("tp")
    specs = param_specs(cfg)
    out = []
    for path, leaf in tree_leaves(tree):
        leaf = leaf.detach()
        dims = _spec(specs, path)
        if "tp" in dims:
            d = dims.index("tp")
            parts = tpc.all_gather(leaf, d, group).chunk(shard.tp, dim=d)
            if path[-1] in KV_LEAVES and shard.kv_shared:
                per_head = shard.tp // cfg.n_kv_heads
                parts = parts[::per_head]  # the first holder of each kv head
            leaf = torch.cat(parts, dim=d)
        out.append((path, leaf))
    return tree_from_leaves(out)


@dataclass(frozen=True)
class _Layout:
    """One rank's place on the mesh, resolved once per step function."""

    shard: _Shard
    device: torch.device
    tp_group: dist.ProcessGroup
    batch_group: dist.ProcessGroup
    batch_rank: int
    batch_ranks: int


def _layout(cfg: LlamaConfig, mesh: DeviceMesh) -> _Layout:
    bg = batch_group(mesh)
    return _Layout(_tp_shard(cfg, mesh), mesh_device(mesh), mesh.get_group("tp"),
                   bg, dist.get_rank(bg), dist.get_world_size(bg))


def _local_rows(tokens, lay: _Layout) -> torch.Tensor:
    """This rank's rows of the global batch, as int64 on its device."""
    tokens = torch.as_tensor(np.asarray(tokens) if not torch.is_tensor(tokens) else tokens)
    if tokens.shape[0] % lay.batch_ranks:
        raise ValueError(
            f"batch {tokens.shape[0]} does not split over {lay.batch_ranks} ranks"
        )
    n = tokens.shape[0] // lay.batch_ranks
    return tokens[lay.batch_rank * n:(lay.batch_rank + 1) * n].to(lay.device, torch.long)


def _local_loss(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                lay: _Layout, remat: bool, seq_parallel: bool) -> torch.Tensor:
    """Mean next-token NLL over this rank's rows (B_local, T)."""
    shard, group = lay.shard, lay.tp_group
    if seq_parallel:
        enter, leave = partial(tpc.gather_seq, group=group), partial(tpc.scatter_seq, group=group)
    else:
        enter, leave = partial(tpc.copy_to_tp, group=group), partial(tpc.reduce_from_tp, group=group)
    vocab_part = cfg.vocab // shard.tp
    vocab_start = shard.tp_rank * vocab_part

    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    S = inputs.shape[1]
    if seq_parallel:
        # pad S at its end to split over tp; token 0 is any valid id
        inputs = F.pad(inputs, (0, (-S) % shard.tp))
    h = tpc.vocab_parallel_embed(params["embed"], inputs, vocab_start, group,
                                 seq_parallel, llama.COMPUTE_DTYPE)
    h = run_blocks(h, params["layers"], cfg, remat,
                   heads=cfg.n_heads // shard.tp,
                   kv_heads=_kv_heads(cfg, shard.tp, shard.tp_rank)[1],
                   enter=enter, leave=leave)
    h = enter(_rmsnorm(h, params["final_norm"], cfg.norm_eps))[:, :S]
    logits = (h @ params["unembed"].to(h.dtype)).float()
    nll = tpc.vocab_parallel_cross_entropy(
        logits.reshape(-1, vocab_part), targets.reshape(-1), vocab_start, group)
    return nll.mean()


def _sum_shared_kv(grad: torch.Tensor, lay: _Layout) -> torch.Tensor:
    """Sum a kv leaf's gradient over the tp ranks that hold the same kv
    head: all-reduce a zero-filled full-width buffer, keep this rank's
    columns."""
    cfg, shard = lay.shard.cfg, lay.shard
    first, n = _kv_heads(cfg, shard.tp, shard.tp_rank)
    hd = cfg.head_dim
    full = grad.new_zeros((*grad.shape[:-1], cfg.n_kv_heads * hd))
    full[..., first * hd:(first + n) * hd] = grad
    dist.all_reduce(full, group=lay.tp_group)
    return full[..., first * hd:(first + n) * hd].contiguous()


def make_loss_and_grad(cfg: LlamaConfig, mesh: DeviceMesh, remat: bool = True,
                       seq_parallel: bool = True):
    """-> fn(params, tokens) -> (loss, grads): the global-batch mean loss
    and the gradient of every leaf of this rank's shard, tp-complete and
    averaged over the batch ranks (before clipping). ``tokens`` is the
    global batch (B, T), the same on every rank. Building it is
    collective (the multislice batch group)."""
    lay = _layout(cfg, mesh)

    def loss_and_grad(params: dict, tokens) -> tuple[torch.Tensor, dict]:
        loss = _local_loss(params, _local_rows(tokens, lay), cfg, lay, remat, seq_parallel)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out = []
        with torch.no_grad():
            for (path, _), g in zip(leaves, grads):
                g = g.contiguous()
                if seq_parallel and path[-1] in NORMS:
                    # each rank saw only its sequence shard
                    dist.all_reduce(g, group=lay.tp_group)
                if path[-1] in KV_LEAVES and lay.shard.kv_shared:
                    g = _sum_shared_kv(g, lay)
                dist.all_reduce(g, group=lay.batch_group)
                out.append((path, g.div_(lay.batch_ranks)))
            total = tpc.all_reduce(loss.detach(), lay.batch_group).div_(lay.batch_ranks)
        return total, tree_from_leaves(out)

    return loss_and_grad


@torch.no_grad()
def global_grad_norm(grads: dict, cfg: LlamaConfig, mesh: DeviceMesh) -> torch.Tensor:
    """The L2 norm of the whole (unsharded) gradient: squares of sharded
    leaves summed over tp, each replicated leaf counted once, and a kv head
    that several ranks share counted once."""
    shard = _tp_shard(cfg, mesh)
    specs = param_specs(cfg)
    sharded = replicated = None
    for path, g in tree_leaves(grads):
        sq = torch.linalg.vector_norm(g.float()).square()
        if "tp" not in _spec(specs, path):
            replicated = sq if replicated is None else replicated + sq
            continue
        if path[-1] in KV_LEAVES and shard.kv_shared:
            sq = sq / (shard.tp // cfg.n_kv_heads)
        sharded = sq if sharded is None else sharded + sq
    sharded = tpc.all_reduce(sharded, mesh.get_group("tp"))
    return torch.sqrt(sharded + replicated)


@dataclass(frozen=True)
class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr))`` with
    optax's defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
    every leaf, norm gains included; torch's ``AdamW`` defaults to 1e-2).
    The update has torch ``AdamW``'s form: bias-corrected moments and
    decoupled weight decay, in optax's order of operations. The clip keeps
    gradients whose global norm is below ``max_norm`` and scales the rest
    by ``max_norm / norm``, with no epsilon (unlike ``clip_grad_norm_``)."""

    lr: float = 3e-4
    max_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: dict) -> dict:
        leaves = tree_leaves(params)
        return {
            "count": 0,
            "mu": tree_from_leaves((p, torch.zeros_like(t)) for p, t in leaves),
            "nu": tree_from_leaves((p, torch.zeros_like(t)) for p, t in leaves),
        }

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict,
               grad_norm: torch.Tensor) -> None:
        """One clipped AdamW step, in place on ``params`` and ``state``."""
        count = state["count"] + 1
        # bias corrections in float32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        scale = torch.where(grad_norm < self.max_norm, 1.0, self.max_norm / grad_norm)
        for (_, p), (_, g), (_, m), (_, v) in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]), tree_leaves(state["nu"])
        ):
            g = g * scale
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            p.add_(upd.add_(p, alpha=self.weight_decay), alpha=-self.lr)
        state["count"] = count


def make_optimizer(lr: float = 3e-4) -> AdamW:
    return AdamW(lr=lr)


def make_train_step(cfg: LlamaConfig, mesh: DeviceMesh, opt: AdamW | None = None,
                    remat: bool = True, seq_parallel: bool = True):
    """Return (step, opt_init) where step(params, opt_state, tokens) ->
    (params, opt_state, loss) runs over the mesh: ``tokens`` is the global
    batch (B, T), the same on every rank, and rows are split over
    ``("dcn", "dp")``. ``remat`` checkpoints each block. Building it is
    collective."""
    opt = opt or make_optimizer()
    loss_and_grad = make_loss_and_grad(cfg, mesh, remat, seq_parallel)
    device = mesh_device(mesh)

    def step(params: dict, opt_state: dict, tokens):
        with span("tpukube.step", device):
            with span("tpukube.grads", device):
                loss, grads = loss_and_grad(params, tokens)
            with span("tpukube.grad_norm", device):
                norm = global_grad_norm(grads, cfg, mesh)
            with span("tpukube.update", device):
                opt.update(params, grads, opt_state, norm)
        return params, opt_state, loss

    return step, opt.init
