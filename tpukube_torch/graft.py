"""Entry points of the port.

:func:`entry` and :func:`dryrun_multichip` are the counterparts of
``entry()`` and ``dryrun_multichip(n)`` in ``__graft_entry__.py``: a
forward step of the Llama decoder at the reference's tiny config, and one
sharded training step over n ranks (one per GPU over NCCL, or gloo ranks
on the CPU), with a second leg over the ("dcn", "dp", "tp") mesh of a DCN
gang's env, which the port's own extender schedules on a sim fleet
(:func:`_mint_dcn_gang_env`).

``python -m tpukube_torch.graft`` runs a pod. Each reads the env the node
agent minted at Allocate, checks it got the GPU it was given, and prints
one JSON line of results:

- no flag: serves Llama-3-8B at full width and depth (:func:`serve`),
  ``--requests N`` requests of ``--batch B`` rows (default 3 of 2); it
  prints a ``serving`` line once its first forward (the warm-up) is done,
  so a long-running pod can be watched, and evicted, while it serves;
- ``--train``: trains Llama-3-8B at full width, depth cut to 4, over a
  world-1 NCCL group and the ``DeviceMesh`` of the env (:func:`train`);
- ``--resnet``: trains ResNet-50 data-parallel over NCCL
  (:func:`train_resnet`);
- ``--dryrun``: ``dryrun_multichip`` over every visible GPU;
- ``--quota``: on a share's env under the quota guard (``LD_PRELOAD`` of
  ``native/cudaguard``), proves the hard quota bites (:func:`quota_check`);
- ``--shared``: serves Llama-3-8B at B=1 on a share, under its cooperative
  cap and the guard, beside another such pod on the same GPU: it prints a
  ``ready`` line after its warm-up and waits for ``go`` on stdin before
  its timed requests, so the pods' timed windows overlap;
- ``--scheduled``: a pod the port's extender placed: its Allocate env is
  held against the bind (``TPU_KUBE_ALLOC``, the alloc annotation) before
  it serves one Llama-3-8B request (:func:`check_scheduled_env`).

Everything runs on the GPU unless the caller passes ``device="cpu"``; with
no CUDA device the entry points raise rather than carry on on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import multiprocessing as mp
import os
import queue
import socket
import statistics
import sys
import time
from datetime import timedelta
from typing import Callable, Mapping, Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpukube_torch.kernels import attention
from tpukube_torch.kernels.group_norm import GroupNormNHWC
from tpukube_torch.native import GpuInfo, cudaguard
from tpukube_torch.workload import resnet
from tpukube_torch.workload.llama import (
    Llama,
    LlamaConfig,
    forward,
    init_params,
    loss_fn,
    tree_from_leaves,
    tree_leaves,
)
from tpukube_torch.workload.meshenv import (
    PodGpuEnv,
    batch_group,
    build_mesh,
    device_from_alloc_env,
    mesh_axes_from_box,
    mesh_device,
    mesh_from_alloc_env,
)
from tpukube_torch.workload.train import (
    gather_params,
    init_sharded,
    make_loss_and_grad,
    make_train_step,
    shard_params,
)

# the reference entry's config (__graft_entry__.py entry())
ENTRY_CFG = LlamaConfig(vocab=256, d_model=128, n_layers=2, n_heads=8,
                        n_kv_heads=4, d_ff=256, max_seq=64)

# the reference dryrun's config (__graft_entry__.py _run_dryrun)
DRYRUN_CFG = LlamaConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128, max_seq=32)

# card-vs-CPU parity: bf16-level tolerance, as the reference's own JAX
# tests use (tests/test_workload.py)
PARITY_RTOL = 2e-2
PARITY_ATOL_OF_MAX = 2e-2

# how long run_ranks waits for its ranks
RANK_TIMEOUT_S = 600.0

GiB = 1 << 30
# the block the quota pod allocates until the quota refuses one
QUOTA_BLOCK = 4 * GiB
# what the caching allocator may still hold after empty_cache()
QUOTA_SLACK = 64 << 20
# timed requests of a shared pod: a window of seconds on a shared card
SHARED_REQUESTS = 10


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` as given, or the GPU when None; never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run on the CPU)")
    return torch.device("cuda")


def entry(device: Union[str, torch.device, None] = None):
    """-> (fwd, (params, tokens)), like the reference's ``entry()``."""
    dev = resolve_device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0), ENTRY_CFG, dev)
    tokens = torch.zeros((2, 32), dtype=torch.int32, device=dev)

    def fwd(params, tokens):
        return forward(params, tokens, ENTRY_CFG)

    return fwd, (params, tokens)


def forward_flops(cfg: LlamaConfig, batch: int, seq: int) -> int:
    """Multiply-add operations (x2) of one forward: the projections, MLP
    and unembed, plus QK^T and PV over the full S x S score matrix that
    the explicit attention computes (masked half included)."""
    D, H, KV, HD, F_ = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    per_layer = D * H * HD + 2 * D * KV * HD + H * HD * D + 3 * D * F_
    dense = 2 * batch * seq * (cfg.n_layers * per_layer + D * cfg.vocab)
    attention = cfg.n_layers * 2 * (2 * batch * H * seq * seq * HD)
    return dense + attention


@torch.inference_mode()
def serve(cfg: LlamaConfig, device: torch.device, *, seed: int, requests: int,
          batch: int, seq: int, parity_layers: int, parity_seq: int,
          on_warm: Optional[Callable[[], None]] = None) -> dict:
    """Build the decoder from ``seed`` on ``device``, serve ``requests``
    forward passes of (batch, seq) random tokens after one warm-up (and
    ``on_warm()``, when given), and check what comes out. Raises on any
    failed check; returns the numbers.

    Checks: f32 logits of the right shape, all finite; the loss of the
    random weights within 1.0 of ln(vocab); causality (changing token t
    leaves the logits before t unchanged); and the first ``parity_layers``
    layers with the full embed and unembed agree with the same function on
    the CPU. ``attention_launches`` counts the attention kernel's launches
    in the timed requests (none on the CPU)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Llama(cfg, init_params(gen, cfg, device))
    toks = [torch.randint(cfg.vocab, (batch, seq), generator=gen, device=device)
            for _ in range(requests + 1)]
    model(toks[0])  # warm-up
    _sync(device)
    if on_warm is not None:
        on_warm()
    times, logits = [], None
    attention.launches = 0
    for t in toks[1:]:
        t0 = time.perf_counter()
        logits = model(t)
        _sync(device)
        times.append(time.perf_counter() - t0)
        if logits.shape != (batch, seq, cfg.vocab) or logits.dtype != torch.float32:
            raise RuntimeError(f"logits {tuple(logits.shape)} {logits.dtype}")
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("non-finite logits")
    attention_launches = attention.launches

    loss = float(model.loss(toks[-1]))
    if not abs(loss - math.log(cfg.vocab)) < 1.0:
        raise RuntimeError(f"random-init loss {loss} is not near ln(vocab)")

    # causality: change token t of row 0 of the last request
    t_pos = seq // 2
    changed = toks[-1].clone()
    changed[0, t_pos] = (changed[0, t_pos] + 1) % cfg.vocab
    l2 = model(changed)
    if not torch.allclose(logits[0, :t_pos], l2[0, :t_pos], rtol=0, atol=1e-5):
        raise RuntimeError("logits before the changed token moved")
    if torch.allclose(logits[0, t_pos:], l2[0, t_pos:]):
        raise RuntimeError("logits after the changed token did not move")

    # parity: the first layers of the same weights, on the device and on
    # the CPU, both through this module's bf16 path
    tree = model.param_tree()
    sub = {**tree, "layers": {k: v[:parity_layers] for k, v in tree["layers"].items()}}
    pcfg = dataclasses.replace(cfg, n_layers=parity_layers)
    ptoks = torch.randint(cfg.vocab, (1, parity_seq), generator=gen, device=device)
    got = forward(sub, ptoks, pcfg).cpu()
    cpu_sub = {**{k: sub[k].cpu() for k in ("embed", "final_norm", "unembed")},
               "layers": {k: v.cpu() for k, v in sub["layers"].items()}}
    ref = forward(cpu_sub, ptoks.cpu(), pcfg)
    atol = PARITY_ATOL_OF_MAX * float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=PARITY_RTOL, atol=atol)

    median = statistics.median(times)
    return {
        "params": sum(p.numel() for p in model.parameters()),
        "batch": batch,
        "seq": seq,
        "requests": requests,
        "n_layers": cfg.n_layers,
        "attention_launches": attention_launches,
        "forward_ms": [t * 1e3 for t in times],
        "forward_ms_median": median * 1e3,
        "forward_flops": forward_flops(cfg, batch, seq),
        "tokens_per_s": batch * seq / median,
        "loss": loss,
        "ln_vocab": math.log(cfg.vocab),
        "parity_layers": parity_layers,
        "parity_seq": parity_seq,
        "parity_max_abs_err": float((got - ref).abs().max()),
        "parity_atol": atol,
        "max_memory_allocated": _peak_memory(device),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_memory(device: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _check_falls(losses: list, what: str) -> None:
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{what}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"{what}: loss did not fall {losses}")


def _parity(got: dict, ref: dict, what: str) -> dict:
    """Hold each leaf of ``got`` against ``ref`` (both brought to the CPU as
    float32) at atol 2e-2 * max|ref|; raise naming every leaf that fails.
    Returns, per leaf, [max abs err / max|ref|, relative L2 error]."""
    stats, bad = {}, []
    for name in ref:
        g, r = got[name].detach().float().cpu(), ref[name].detach().float().cpu()
        top = float(r.abs().max())
        err = float((g - r).abs().max())
        stats[name] = [err / top if top else err,
                       float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r))]
        if not err <= PARITY_ATOL_OF_MAX * top:
            bad.append(name)
    if bad:
        raise RuntimeError(f"{what}: {bad} beyond atol 2e-2 max|ref|; per leaf "
                           f"[max err / max|ref|, relative L2]: {stats}")
    return stats


def _named(tree: dict) -> dict:
    return {".".join(path): leaf for path, leaf in tree_leaves(tree)}


def train(cfg: LlamaConfig, mesh: DeviceMesh, *, seed: int, steps: int,
          batch: int, seq: int, parity_layers: int, parity_seq: int) -> dict:
    """Build the decoder's shards from ``seed`` over ``mesh``, take one
    warm-up and ``steps`` timed training steps on one fixed batch (batch,
    seq + 1 tokens), and check what comes out. Raises on any failed check;
    returns the numbers. Collective: every rank of the mesh calls it.

    Checks: finite losses; the first within 1.0 of ln(vocab); the last
    below the first; and the loss and gradients of the first
    ``parity_layers`` layers with the full embed and unembed, through the
    sharded step on the mesh's device, against the port's single-device
    decoder on the CPU."""
    device = mesh_device(mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_sharded(gen, cfg, mesh)
    step, opt_init = make_train_step(cfg, mesh)
    opt_state = opt_init(params)
    tokens = torch.randint(cfg.vocab, (batch, seq + 1), generator=gen, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, times = [], []
    for i in range(steps + 1):  # the first is the warm-up
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state, tokens)
        _sync(device)
        if i:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    _check_falls(losses, "train")
    if not abs(losses[0] - math.log(cfg.vocab)) < 1.0:
        raise RuntimeError(f"random-init loss {losses[0]} is not near ln(vocab)")
    peak = _peak_memory(device)

    # parity: the first layers of the trained weights, the sharded path on
    # the mesh's device against the plain decoder on the CPU
    pcfg = dataclasses.replace(cfg, n_layers=parity_layers)
    full = gather_params(params, mesh, cfg)
    sub = {**full, "layers": {k: v[:parity_layers] for k, v in full["layers"].items()}}
    # one row per batch rank: a single row on one card
    rows = dist.get_world_size(batch_group(mesh))
    ptoks = torch.randint(cfg.vocab, (rows, parity_seq + 1), generator=gen, device=device)
    got_loss, got = make_loss_and_grad(pcfg, mesh)(shard_params(sub, mesh, pcfg), ptoks)
    got = gather_params(got, mesh, pcfg)
    cpu = tree_from_leaves((p, t.detach().cpu().requires_grad_(True))
                           for p, t in tree_leaves(sub))
    ref_loss = loss_fn(cpu, ptoks.cpu(), pcfg)
    names = _named(cpu)
    ref = dict(zip(names, torch.autograd.grad(ref_loss, list(names.values()))))
    got_loss, ref_loss = float(got_loss), float(ref_loss.detach())
    if not abs(got_loss - ref_loss) <= PARITY_RTOL * abs(ref_loss):
        raise RuntimeError(f"parity loss {got_loss} vs CPU {ref_loss}")
    stats = _parity(_named(got), ref, "parity grad")

    median = statistics.median(times)
    return {
        "params": sum(p.numel() for p in _named(full).values()),
        "batch": batch,
        "seq": seq,
        "steps": steps,
        "losses": losses,
        "step_ms": [t * 1e3 for t in times],
        "step_ms_median": median * 1e3,
        "forward_flops": forward_flops(cfg, batch, seq),
        "tokens_per_s": batch * seq / median,
        "ln_vocab": math.log(cfg.vocab),
        "parity_layers": parity_layers,
        "parity_seq": parity_seq,
        "parity_loss": got_loss,
        "parity_ref_loss": ref_loss,
        "parity_grads": stats,
        "max_memory_allocated": peak,
    }


def train_resnet(cfg: resnet.ResNetConfig, mesh: DeviceMesh, *, seed: int,
                 steps: int, batch: int, parity_batch: int,
                 parity_size: int) -> dict:
    """Build ResNet params from ``seed``, take one warm-up and ``steps``
    timed data-parallel SGD steps (lr 1e-2) on one fixed batch of
    ``cfg.image_size`` images, and check that the loss is finite and
    falls; ``norm_launches`` counts the GroupNorm kernels those steps
    launched (none on the CPU). Parity: one step at ``parity_batch``
    images of ``parity_size`` on the mesh's device against the same step
    on the CPU (loss, and the updated stem and head). Raises on any
    failed check. Collective."""
    device = mesh_device(mesh)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = resnet.init_params(gen, cfg, device)
    step = resnet.make_dp_train_step(cfg, mesh, learning_rate=1e-2)
    size = cfg.image_size
    images = torch.randn((batch, size, size, 3), generator=gen, device=device)
    labels = torch.randint(cfg.num_classes, (batch,), generator=gen, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, times = [], []
    GroupNormNHWC.launches = 0
    for i in range(steps + 1):
        t0 = time.perf_counter()
        params, loss = step(params, images, labels)
        _sync(device)
        if i:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    norm_launches = GroupNormNHWC.launches
    _check_falls(losses, "resnet")
    peak = _peak_memory(device)

    pimages = torch.randn((parity_batch, parity_size, parity_size, 3),
                          generator=gen, device=device)
    plabels = torch.randint(cfg.num_classes, (parity_batch,), generator=gen, device=device)
    cpu = resnet.map_params(params, lambda t: t.detach().cpu().requires_grad_(True))
    dev = resnet.map_params(params, lambda t: t.detach().clone())
    dev, got_loss = step(dev, pimages, plabels)
    ref_loss = resnet.loss_fn(cpu, pimages.cpu(), plabels.cpu(), cfg)
    grads = torch.autograd.grad(ref_loss, resnet.param_leaves(cpu))
    with torch.no_grad():
        for p, g in zip(resnet.param_leaves(cpu), grads):
            p.sub_(g, alpha=1e-2)
    got_loss, ref_loss = float(got_loss), float(ref_loss.detach())
    if not abs(got_loss - ref_loss) <= PARITY_RTOL * abs(ref_loss):
        raise RuntimeError(f"parity loss {got_loss} vs CPU {ref_loss}")
    stats = _parity({"stem": dev["stem"], "head": dev["head"]},
                    {"stem": cpu["stem"], "head": cpu["head"]}, "parity update")

    median = statistics.median(times)
    return {
        "params": sum(p.numel() for p in resnet.param_leaves(params)),
        "norms": 1 + sum(len(b["norms"]) for blocks in params["stages"] for b in blocks),
        "norm_launches": norm_launches,
        "batch": batch,
        "image_size": size,
        "steps": steps,
        "losses": losses,
        "step_ms": [t * 1e3 for t in times],
        "step_ms_median": median * 1e3,
        "images_per_s": batch / median,
        "parity_batch": parity_batch,
        "parity_size": parity_size,
        "parity_loss": got_loss,
        "parity_ref_loss": ref_loss,
        "parity_params": stats,
        "max_memory_allocated": peak,
    }


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, n: int, backend: str, port: int, inbox, results) -> None:
    fn, args = inbox.get()
    if backend == "nccl":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank, timeout=timedelta(minutes=5))
    try:
        results.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, backend: str, args: tuple = ()) -> list:
    """Run ``fn(*args)`` in ``n`` fresh processes that form one process
    group over ``backend`` (rank r on GPU r for NCCL; one CPU thread each
    for gloo) and return their results in rank order. ``fn`` and its
    results must pickle. Raises if a rank fails or the ranks do not finish
    within ``RANK_TIMEOUT_S``; no rank outlives the call.

    The ranks fork from a ``forkserver``: a process started fresh, which
    imports torch once and runs nothing else, so it holds no threads and
    no CUDA context when it forks (the hazards of forking the caller), and
    each rank skips the seconds of importing torch."""
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    inbox, results = ctx.Queue(), ctx.Queue()
    # the work goes through a queue, not the processes' arguments: starting
    # a process writes those into a pipe, and a payload larger than the
    # pipe's buffer holds the parent until that child has imported its
    # modules, so the ranks would start one after another
    for _ in range(n):
        inbox.put((fn, args))
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n, backend, port, inbox, results))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        out: dict = {}
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while len(out) < n:
            try:
                rank, value = results.get(timeout=0.5)
                out[rank] = value
            except queue.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"a rank exited with {failed[0]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish in {RANK_TIMEOUT_S} s")
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with {p.exitcode}")
        return [out[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        inbox.close()
        results.close()


def _dryrun_rank(n: int, gang_env: Optional[Mapping[str, str]]) -> dict:
    """One rank of the dry run: the reference's ``_run_dryrun`` legs."""
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    # tp rides the longest axis of the (virtual) slice box, as in the
    # reference: a flat list of n ranks is an (n/tp, tp, 1) box
    tp = 2 if n % 2 == 0 else 1
    dp, tp = mesh_axes_from_box((n // tp, tp, 1), tp)
    mesh = build_mesh(device_type, dp, tp)
    out = {"leg1": _dryrun_step(mesh, seed=0, rows=2 * dp)}
    if gang_env is not None:
        per_slice = n // 2
        mesh2, pe = mesh_from_alloc_env(gang_env, n, tp=2 if per_slice % 2 == 0 else 1)
        if not pe.spans_dcn or mesh2.mesh_dim_names != ("dcn", "dp", "tp"):
            raise RuntimeError(f"gang env did not produce a DCN mesh: {mesh2.mesh_dim_names}")
        dcn, dp2, _ = mesh2.mesh.shape
        out["leg2"] = _dryrun_step(mesh2, seed=1, rows=2 * dcn * dp2)
    return out


def _dryrun_step(mesh: DeviceMesh, *, seed: int, rows: int) -> dict:
    device = mesh_device(mesh)
    params = init_sharded(torch.Generator(device=device).manual_seed(seed), DRYRUN_CFG, mesh)
    step, opt_init = make_train_step(DRYRUN_CFG, mesh)
    tokens = torch.zeros((rows, 17), dtype=torch.long)
    _, _, loss = step(params, opt_init(params), tokens)
    loss = float(loss)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss} on mesh {mesh}")
    return {"axes": list(mesh.mesh_dim_names), "shape": list(mesh.mesh.shape),
            "loss": loss}


def _mint_dcn_gang_env() -> dict:
    """Schedule a DCN-spanning gang through the port's own control plane —
    the extender's filter/prioritize/bind over a two-slice sim fleet, then
    the node agent's Allocate on the bound node — and return the first
    member's merged container env. The TPU_KUBE_GANG_* keys are what the
    extender mints at bind; nothing here is hand-written."""
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.mesh import MeshSpec
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.device.gpu import ENV_GANG_NUM_SLICES
    from tpukube_torch.sim import SimCluster

    slices = {
        "dcn-a": MeshSpec((2, 1, 1), (2, 1, 1)),
        "dcn-b": MeshSpec((2, 1, 1), (2, 1, 1)),
    }
    # the node agent's Allocate in process: the GPU machine has no grpcio
    with SimCluster(load_config(env={}), slices=slices, transport="inprocess") as c:
        group = PodGroup("dry", min_member=4, allow_dcn=True)
        allocs = [
            c.schedule(c.make_pod(f"dry-{i}", tpu=1, group=group))[1]
            for i in range(4)
        ]
        first = allocs[0]
        env = dict(first.env)  # the extender's TPU_KUBE_GANG_* keys
        if env.get(ENV_GANG_NUM_SLICES) != "2":
            raise RuntimeError(f"gang did not span 2 slices: {env}")
        env.update(c.execute_allocation(first))  # node agent's GPU env
        return env


def dryrun_multichip(n_devices: int, device: Union[str, torch.device, None] = None,
                     gang_env: Optional[Mapping[str, str]] = None) -> dict:
    """One sharded training step of the reference dryrun's config over
    ``n_devices`` ranks: NCCL, one per GPU, unless ``device="cpu"`` asks for
    gloo ranks. Leg 1: a (dp, tp) mesh with tp = 2 for even n, tokens
    (2·dp, 17). Leg 2, for an even n >= 4: the ("dcn", "dp", "tp") mesh
    ``mesh_from_alloc_env`` makes of a DCN gang's Allocate env — ``gang_env``
    if given, else the one :func:`_mint_dcn_gang_env` schedules — tokens
    (2·dcn·dp, 17). Each loss must be finite. Returns rank 0's report of
    the legs it ran."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if n_devices > torch.cuda.device_count():
            raise RuntimeError(
                f"dryrun over {n_devices} GPUs, CUDA sees {torch.cuda.device_count()}"
            )
        backend = "nccl"
    else:
        backend = "gloo"
    if n_devices < 4 or n_devices % 2:
        # the 2-slice mesh needs an even split of >=2 devices per slice;
        # say so rather than silently passing with the leg uncovered
        print(f"dryrun: skipping DCN multislice leg (n_devices={n_devices} "
              "not an even count >= 4)", flush=True)
        gang_env = None
    elif gang_env is None:
        gang_env = _mint_dcn_gang_env()
    return run_ranks(_dryrun_rank, n_devices, backend, (n_devices, gang_env))[0]


def _pod_device() -> tuple[PodGpuEnv, torch.device, str]:
    """The Allocate env, its GPU (checked by UUID) and that UUID; f32
    products in full f32 and bf16 products reduced in f32, as XLA computes
    the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    pe = PodGpuEnv.from_env()
    device = device_from_alloc_env()
    return pe, device, _check_uuid(device, pe.visible_chips[0])


def _with_nccl_mesh(device: torch.device, run: Callable[[DeviceMesh], dict]) -> dict:
    """``run`` on the env's ``DeviceMesh`` over a world-1 NCCL group."""
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh, _ = mesh_from_alloc_env(world_size=1)
        return run(mesh)
    finally:
        dist.destroy_process_group()


def train_main() -> int:
    """Train Llama-3-8B at full width, depth 4 (random weights from a fixed
    seed) on the GPU the Allocate env names; print one JSON line."""
    pe, device, uuid = _pod_device()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4)
    out = _with_nccl_mesh(device, lambda mesh: train(
        cfg, mesh, seed=0, steps=3, batch=2, seq=2048, parity_layers=2, parity_seq=64))
    out.update(device=torch.cuda.get_device_name(device), uuid=uuid,
               device_ids=list(pe.device_ids), n_layers=cfg.n_layers)
    print(json.dumps({"train": out}), flush=True)
    return 0


def resnet_main() -> int:
    """Train ResNet-50 data-parallel (random weights and images from a
    fixed seed) on the GPU the Allocate env names; print one JSON line."""
    pe, device, uuid = _pod_device()
    out = _with_nccl_mesh(device, lambda mesh: train_resnet(
        resnet.ResNetConfig.resnet50(), mesh, seed=0, steps=3, batch=64,
        parity_batch=2, parity_size=64))
    out.update(device=torch.cuda.get_device_name(device), uuid=uuid,
               device_ids=list(pe.device_ids))
    print(json.dumps({"resnet": out}), flush=True)
    return 0


def dryrun_main() -> int:
    """``dryrun_multichip`` over every GPU this process sees; one JSON line."""
    out = dryrun_multichip(torch.cuda.device_count())
    print(json.dumps({"dryrun": {"n_devices": torch.cuda.device_count(), **out}}),
          flush=True)
    return 0


def quota_check(device: torch.device, limit: int, guard: cudaguard.Guard,
                nvml_free: Callable[[], int]) -> dict:
    """Prove that the guard preloaded into this process holds it to
    ``limit`` bytes of device memory, on a card with more free than that
    (``nvml_free()``: NVML's free bytes). Checks, in order: the guard read
    ``limit``; ``torch.cuda.mem_get_info`` reports no more free than it;
    4 GiB blocks fit until the guard refuses one, after exactly
    ⌊limit / 4 GiB⌋; after ``empty_cache`` the guard's count is back near 0
    and a (limit − 4 GiB) tensor fits; limit + 1 GiB is refused while NVML
    says the card has that much free. Raises on any failed check; returns
    the numbers."""
    if limit <= 0 or guard.limit() != limit:
        raise RuntimeError(f"guard limit {guard.limit()}, the share's {limit}")
    free, total = torch.cuda.mem_get_info(device)
    if free > limit:
        raise RuntimeError(f"mem_get_info free {free} > the quota {limit}")
    refused0 = guard.refused()
    blocks = []
    try:
        for _ in range(limit // QUOTA_BLOCK + 1):
            blocks.append(torch.empty(QUOTA_BLOCK, dtype=torch.uint8, device=device))
    except torch.OutOfMemoryError:
        pass
    fitted, used_full = len(blocks), guard.used()
    if fitted != limit // QUOTA_BLOCK:
        raise RuntimeError(f"{fitted} blocks of 4 GiB fitted, the quota allows "
                           f"{limit // QUOTA_BLOCK}")
    if guard.refused() <= refused0:
        raise RuntimeError("the allocation failed, but not by the guard's refusal")
    del blocks
    torch.cuda.empty_cache()
    used_empty = guard.used()
    if used_empty > QUOTA_SLACK:
        raise RuntimeError(f"guard still counts {used_empty} bytes after empty_cache")
    big = torch.empty(limit - QUOTA_BLOCK, dtype=torch.uint8, device=device)
    used_big = guard.used()
    del big
    torch.cuda.empty_cache()
    over = limit + GiB
    card_free = nvml_free()
    if card_free <= over:
        raise RuntimeError(f"NVML free {card_free}: the card cannot show the quota "
                           f"refusing {over} bytes")
    refused1 = guard.refused()
    try:
        torch.empty(over, dtype=torch.uint8, device=device)
    except torch.OutOfMemoryError:
        pass
    else:
        raise RuntimeError(f"{over} bytes over a {limit}-byte quota were granted")
    if guard.refused() <= refused1:
        raise RuntimeError("limit + 1 GiB failed, but not by the guard's refusal")
    return {
        "limit": limit,
        "mem_get_info_free": free,
        "mem_get_info_total": total,
        "blocks_fitted": fitted,
        "used_at_refusal": used_full,
        "used_after_empty_cache": used_empty,
        "used_with_limit_minus_4GiB": used_big,
        "over_request": over,
        "nvml_free_at_over_request": card_free,
        "refused": guard.refused() - refused0,
        "guard_peak": guard.peak(),
    }


def quota_main() -> int:
    """The quota pod: run on a share's env without its memory fraction,
    under the guard; one JSON line."""
    pe, device, uuid = _pod_device()
    if pe.mem_fraction is not None:
        raise RuntimeError("the quota pod runs without the cooperative cap: "
                           "PyTorch would refuse before the guard is asked")
    chip = pe.visible_chips[0]

    def nvml_free() -> int:
        with GpuInfo("real", "probe=off\n") as gi:
            _, used = gi.telemetry(chip)
            return gi.chips()[chip].hbm_bytes - used

    out = quota_check(device, pe.hbm_limit_bytes, cudaguard.Guard(), nvml_free)
    out.update(device=torch.cuda.get_device_name(device), uuid=uuid,
               device_ids=list(pe.device_ids))
    print(json.dumps({"quota": out}), flush=True)
    return 0


def shared_main() -> int:
    """A serving pod on a share: Llama-3-8B at B=1 under the share's
    memory fraction and the guard; ``ready`` after the warm-up, the timed
    requests after ``go`` on stdin; one JSON line."""
    pe, device, uuid = _pod_device()
    if pe.mem_fraction is None:
        raise RuntimeError("the shared pod needs a share's env (no memory fraction)")
    guard = cudaguard.Guard()
    if guard.limit() != pe.hbm_limit_bytes:
        raise RuntimeError(f"guard limit {guard.limit()}, the share's {pe.hbm_limit_bytes}")

    def ready() -> None:
        print(json.dumps({"ready": {"memory_reserved": torch.cuda.memory_reserved(device),
                                    "guard_used": guard.used()}}), flush=True)
        line = sys.stdin.readline().strip()
        if line != "go":
            raise RuntimeError(f"expected 'go' on stdin, got {line!r}")

    out = serve(LlamaConfig.llama3_8b(), device, seed=0, requests=SHARED_REQUESTS,
                batch=1, seq=2048, parity_layers=2, parity_seq=64, on_warm=ready)
    out.update(device=torch.cuda.get_device_name(device), uuid=uuid,
               device_ids=list(pe.device_ids), tenant=pe.tenant,
               mem_fraction=pe.mem_fraction,
               hbm_limit_bytes=pe.hbm_limit_bytes,
               max_memory_reserved=torch.cuda.max_memory_reserved(device),
               guard_peak=guard.peak(), guard_refused=guard.refused())
    print(json.dumps({"shared": out}), flush=True)
    return 0


def _check_uuid(device: torch.device, chip_index: int) -> str:
    """The CUDA device must be the GPU NVML lists at the allocated index."""
    with GpuInfo("real", "probe=off\n") as gi:
        nvml_uuid = gi.chips()[chip_index].chip_id
    cuda_uuid = "GPU-" + str(torch.cuda.get_device_properties(device).uuid)
    if cuda_uuid != nvml_uuid:
        raise RuntimeError(
            f"CUDA device {cuda_uuid} is not the allocated GPU {nvml_uuid}"
        )
    return nvml_uuid


# the pod's ``tpu.qiniu.com/alloc`` annotation, as the downward API projects
# it into the container (read by the scheduled pod)
ENV_ALLOC = "TPU_KUBE_ALLOC"


def check_scheduled_env(pe: PodGpuEnv, alloc_payload: str) -> dict:
    """Hold a pod's Allocate env against the extender's bind: the device
    ids, the chip coords (``TPU_KUBE_CHIP_COORDS``) and the gang keys must
    be the alloc's, and every coord must lie inside ``TPU_KUBE_MESH_DIMS``.
    Raises on any mismatch; returns what was checked."""
    from tpukube_torch.core import codec
    from tpukube_torch.device.gpu import (
        ENV_GANG_NUM_SLICES,
        ENV_GANG_SLICE_INDEX,
        ENV_GANG_SLICES,
    )

    alloc = codec.decode_alloc(alloc_payload)
    if list(pe.device_ids) != alloc.device_ids:
        raise RuntimeError(f"env devices {pe.device_ids}, bound {alloc.device_ids}")
    bound = [tuple(c) for c in alloc.coords]
    if list(pe.coords) != bound:
        raise RuntimeError(f"env coords {pe.coords}, bound {bound}")
    if not all(0 <= v < d for c in pe.coords for v, d in zip(c, pe.mesh_dims)):
        raise RuntimeError(f"coords {pe.coords} outside mesh {pe.mesh_dims}")
    gang = (str(pe.gang_num_slices), ",".join(pe.gang_slices),
            str(pe.gang_slice_index))
    # a pod outside any gang carries no gang keys: its env reads the
    # one-slice defaults (PodGpuEnv's)
    want = (alloc.env.get(ENV_GANG_NUM_SLICES, "1"),
            alloc.env.get(ENV_GANG_SLICES, ""),
            alloc.env.get(ENV_GANG_SLICE_INDEX, "0"))
    if gang != want:
        raise RuntimeError(f"env gang keys {gang}, bound {want}")
    return {"pod": alloc.pod_key, "node": alloc.node_name,
            "device_ids": alloc.device_ids, "coords": [list(c) for c in bound],
            "mesh_dims": list(pe.mesh_dims), "gang": list(gang)}


def scheduled_main() -> int:
    """A pod the port's extender placed: check its Allocate env against the
    bind (``TPU_KUBE_ALLOC``), then serve one Llama-3-8B request at full
    width and depth on the GPU the env names; one JSON line."""
    pe, device, uuid = _pod_device()
    checked = check_scheduled_env(pe, os.environ[ENV_ALLOC])
    out = serve(LlamaConfig.llama3_8b(), device, seed=0, requests=1,
                batch=2, seq=2048, parity_layers=2, parity_seq=64)
    out.update(device=torch.cuda.get_device_name(device), uuid=uuid,
               scheduled=checked)
    print(json.dumps({"scheduled": out}), flush=True)
    return 0


def pod_main(requests: int = 3, batch: int = 2) -> int:
    """Serve Llama-3-8B (random weights from a fixed seed) on the GPU the
    Allocate env names: a ``serving`` JSON line after the warm-up, one
    JSON line of results at the end."""
    # f32 products stay full f32 (TF32 keeps ~3 decimal digits), and bf16
    # products reduce in f32 throughout, as XLA computes the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    pe = PodGpuEnv.from_env()
    device = device_from_alloc_env()
    uuid = _check_uuid(device, pe.visible_chips[0])

    def serving() -> None:
        print(json.dumps({"serving": {
            "uuid": uuid, "memory_reserved": torch.cuda.memory_reserved(device),
            "pid": os.getpid()}}), flush=True)

    out = serve(LlamaConfig.llama3_8b(), device, seed=0, requests=requests,
                batch=batch, seq=2048, parity_layers=2, parity_seq=64,
                on_warm=serving)
    out.update(device=torch.cuda.get_device_name(device), uuid=uuid,
               device_ids=list(pe.device_ids))
    print(json.dumps({"pod": out}), flush=True)
    return 0


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tpukube_torch.graft")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="the training pod")
    mode.add_argument("--resnet", action="store_true", help="the ResNet-50 DP pod")
    mode.add_argument("--dryrun", action="store_true",
                      help="dryrun_multichip over every visible GPU")
    mode.add_argument("--quota", action="store_true",
                      help="prove a share's hard quota under the guard")
    mode.add_argument("--shared", action="store_true",
                      help="serve on a share, beside another pod")
    mode.add_argument("--scheduled", action="store_true",
                      help="check the env against the extender's bind, then serve")
    parser.add_argument("--requests", type=int, default=3,
                        help="the serving pod's timed requests")
    parser.add_argument("--batch", type=int, default=2,
                        help="the serving pod's rows per request")
    a = parser.parse_args(argv)
    if a.train:
        return train_main()
    if a.resnet:
        return resnet_main()
    if a.dryrun:
        return dryrun_main()
    if a.quota:
        return quota_main()
    if a.shared:
        return shared_main()
    if a.scheduled:
        return scheduled_main()
    return pod_main(a.requests, a.batch)


if __name__ == "__main__":
    sys.exit(main())
