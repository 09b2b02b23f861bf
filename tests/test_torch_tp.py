"""Megatron's conjugate collectives (tpukube_torch/workload/tp.py) on 4
gloo ranks, forward and backward, against the same math done whole in one
process. Sums over ranks are held at rtol 1e-5 (float32, another order of
summation); lookups and copies exactly.

This module also holds the rank-side halves of the port's multi-process
tests (tests/test_torch_{train,resnet}.py): spawned ranks import the
function they run by module, and this one imports torch, numpy and the
port only, so a rank does not pay for importing JAX.

Each rank sets one CPU thread (graft.run_ranks); inputs are drawn with
numpy from a seed, every rank drawing every rank's inputs and keeping its
own."""


import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpukube_torch.graft import run_ranks, train, train_resnet
from tpukube_torch.workload import llama
from tpukube_torch.workload import resnet as port_resnet
from tpukube_torch.workload import tp as tpc
from tpukube_torch.workload import train as port_train
from tpukube_torch.workload.llama import LlamaConfig, init_params
from tpukube_torch.workload.meshenv import (
    build_mesh,
    build_multislice_mesh,
    mesh_from_alloc_env,
)

N = 4        # ranks of the collective checks
SEED = 11


def _inputs(n: int) -> dict:
    """Every rank's inputs, from one seed."""
    rng = np.random.default_rng(SEED)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    V = 4 * n
    return {
        "rep": normal(2, 3),            # a replicated activation
        "per_rank": normal(n, 2, 3),    # one partial output per rank
        "w": normal(n, 2, 3),           # per-rank upstream gradients
        "c": normal(2, 3),              # a replicated upstream gradient
        "seq": normal(n, 2, 3, 4),      # per-rank sequence shards (B, S/n, D)
        "seq_w": normal(n, 2, 3 * n, 4),
        "full_seq": normal(n, 2, 3 * n, 4),
        "full_seq_w": normal(n, 2, 3, 4),
        "table": normal(V, 3),
        "tokens": rng.integers(0, V, (2, 2 * n)),
        "emb_up": normal(2, 2 * n, 3),
        "logits": normal(6, V),
        "targets": rng.integers(0, V, (6,)),
        "nll_up": normal(6),
    }


def _leaf(a) -> torch.Tensor:
    return torch.tensor(a).requires_grad_(True)


def collectives_rank() -> dict:
    """Each conjugate pair's forward value and input gradient on this rank."""
    r, n = dist.get_rank(), dist.get_world_size()
    g = dist.group.WORLD
    x = _inputs(n)
    out = {}

    rep = _leaf(x["rep"])
    y = tpc.copy_to_tp(rep, g)
    (y * torch.tensor(x["w"][r])).sum().backward()
    out["copy"] = (y.detach().numpy(), rep.grad.numpy())

    part = _leaf(x["per_rank"][r])
    y = tpc.reduce_from_tp(part, g)
    (y * torch.tensor(x["c"])).sum().backward()
    out["reduce"] = (y.detach().numpy(), part.grad.numpy())

    shard = _leaf(x["seq"][r])
    y = tpc.gather_seq(shard, g)
    (y * torch.tensor(x["seq_w"][r])).sum().backward()
    out["gather"] = (y.detach().numpy(), shard.grad.numpy())

    whole = _leaf(x["full_seq"][r])
    y = tpc.scatter_seq(whole, g)
    (y * torch.tensor(x["full_seq_w"][r])).sum().backward()
    out["scatter"] = (y.detach().numpy(), whole.grad.numpy())

    rows = x["table"].shape[0] // n
    tokens = torch.tensor(x["tokens"])
    for sp in (False, True):
        table = _leaf(x["table"][r * rows:(r + 1) * rows])
        y = tpc.vocab_parallel_embed(table, tokens, r * rows, g, sp, torch.bfloat16)
        up = torch.tensor(x["emb_up"])
        if sp:  # this rank's sequence shard of the upstream gradient
            up = up.chunk(n, dim=1)[r]
        (y.float() * up).sum().backward()
        out[f"embed_sp{int(sp)}"] = (y.detach().float().numpy(), table.grad.numpy())

    cols = x["logits"].shape[1] // n
    logits = _leaf(x["logits"][:, r * cols:(r + 1) * cols])
    nll = tpc.vocab_parallel_cross_entropy(logits, torch.tensor(x["targets"]), r * cols, g)
    (nll * torch.tensor(x["nll_up"])).sum().backward()
    out["ce"] = (nll.detach().numpy(), logits.grad.numpy())
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(collectives_rank, N, "gloo")


@pytest.fixture(scope="module")
def x():
    return _inputs(N)


def test_copy_to_tp_is_identity_then_all_reduce(ranks, x):
    for r, out in enumerate(ranks):
        y, grad = out["copy"]
        np.testing.assert_array_equal(y, x["rep"])
        np.testing.assert_allclose(grad, x["w"].sum(0), rtol=1e-5, atol=1e-6)


def test_reduce_from_tp_is_all_reduce_then_identity(ranks, x):
    # the gradient is the upstream one, once: not tp times, as the
    # backward of torch.distributed.nn.functional.all_reduce would give
    for out in ranks:
        y, grad = out["reduce"]
        np.testing.assert_allclose(y, x["per_rank"].sum(0), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(grad, x["c"])


def test_gather_seq_and_its_reduce_scatter(ranks, x):
    whole = np.concatenate(list(x["seq"]), axis=1)
    up = x["seq_w"].sum(0)  # every rank's gradient of the gathered sequence
    for r, out in enumerate(ranks):
        y, grad = out["gather"]
        np.testing.assert_array_equal(y, whole)
        np.testing.assert_allclose(grad, np.split(up, N, axis=1)[r], rtol=1e-5, atol=1e-6)


def test_scatter_seq_and_its_all_gather(ranks, x):
    total = x["full_seq"].sum(0)
    up = np.concatenate(list(x["full_seq_w"]), axis=1)
    for r, out in enumerate(ranks):
        y, grad = out["scatter"]
        np.testing.assert_allclose(y, np.split(total, N, axis=1)[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(grad, up)


@pytest.mark.parametrize("sp", [False, True])
def test_vocab_parallel_embed(ranks, x, sp):
    table = torch.tensor(x["table"]).requires_grad_(True)
    want = table[torch.tensor(x["tokens"])].to(torch.bfloat16)
    (want.float() * torch.tensor(x["emb_up"])).sum().backward()
    got = [out[f"embed_sp{int(sp)}"] for out in ranks]
    whole = np.concatenate([y for y, _ in got], axis=1) if sp else got[0][0]
    np.testing.assert_array_equal(whole, want.detach().float().numpy())
    np.testing.assert_allclose(np.concatenate([g for _, g in got]), table.grad.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_vocab_parallel_cross_entropy(ranks, x):
    logits = torch.tensor(x["logits"]).requires_grad_(True)
    want = F.cross_entropy(logits, torch.tensor(x["targets"]), reduction="none")
    (want * torch.tensor(x["nll_up"])).sum().backward()
    for out in ranks:
        np.testing.assert_allclose(out["ce"][0], want.detach().numpy(), rtol=1e-5)
    grads = np.concatenate([out["ce"][1] for out in ranks], axis=1)
    np.testing.assert_allclose(grads, logits.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_collectives_need_a_process_group():
    # no silent single-process shortcut: without a group the calls fail
    with pytest.raises((RuntimeError, ValueError)):
        tpc.reduce_from_tp(torch.ones(2), None)


# -- rank-side halves of tests/test_torch_train.py and test_torch_resnet.py --


def _mesh(spec: dict):
    if "gang_env" in spec:
        mesh, _ = mesh_from_alloc_env(spec["gang_env"], dist.get_world_size(), spec["tp"])
        return mesh
    if "dcn" in spec:
        return build_multislice_mesh("cpu", spec["dcn"], spec["dp"], spec["tp"])
    return build_mesh("cpu", spec["dp"], spec["tp"])


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def llama_rank(case: dict) -> dict:
    """The port's sharded Llama step on this rank's mesh; rank 0 returns
    gathered (full) trees as numpy."""
    cfg = LlamaConfig(**case["cfg"])
    mesh = _mesh(case["mesh"])
    out = {"axes": list(mesh.mesh_dim_names), "shape": list(mesh.mesh.shape)}
    P, tokens = case["params"], case["tokens"]

    def gathered(tree):
        return _numpy(port_train.gather_params(tree, mesh, cfg))

    # the same algorithm computed in float32, below bf16's rounding noise
    llama.COMPUTE_DTYPE = torch.float32
    loss, grads = port_train.make_loss_and_grad(cfg, mesh)(
        port_train.shard_params(P, mesh, cfg), tokens)
    llama.COMPUTE_DTYPE = torch.bfloat16
    out["loss_f32"], out["grads_f32"] = float(loss), gathered(grads)

    # loss and gradients, sequence-parallel or not
    for sp in case["seq_parallel"]:
        loss, grads = port_train.make_loss_and_grad(cfg, mesh, seq_parallel=sp)(
            port_train.shard_params(P, mesh, cfg), tokens)
        out[f"loss_sp{int(sp)}"] = float(loss)
        out[f"grads_sp{int(sp)}"] = gathered(grads)
    if case.get("remat_off"):
        loss, grads = port_train.make_loss_and_grad(cfg, mesh, remat=False)(
            port_train.shard_params(P, mesh, cfg), tokens)
        out["grads_remat0"] = gathered(grads)

    # clip + AdamW over given gradients, 3 updates each
    opt = port_train.make_optimizer()
    for name, G in case["opt_grads"].items():
        params = port_train.shard_params(P, mesh, cfg)
        grads = port_train.shard_params(G, mesh, cfg)
        state = opt.init(params)
        norm = port_train.global_grad_norm(grads, cfg, mesh)
        for _ in range(3):
            opt.update(params, grads, state, norm)
        out[f"opt_{name}"] = {"norm": float(norm), "params": gathered(params),
                              "mu": gathered(state["mu"]), "nu": gathered(state["nu"])}

    # one full step
    step, opt_init = port_train.make_train_step(cfg, mesh)
    params = port_train.shard_params(P, mesh, cfg)
    params, _, loss = step(params, opt_init(params), tokens)
    out["step"] = {"loss": float(loss), "params": gathered(params)}

    # from init_sharded(seed 0): the gathered init and the step losses
    if case.get("init_steps"):
        gen = torch.Generator().manual_seed(0)
        params = port_train.init_sharded(gen, cfg, mesh)
        out["init"] = gathered(params)
        state = opt_init(params)
        losses = []
        for _ in range(case["init_steps"]):
            params, state, loss = step(params, state, tokens)
            losses.append(float(loss))
        out["init_losses"] = losses

    # the training pod's body (graft.train), as the card runs it at width
    if case.get("pod"):
        out["pod"] = train(cfg, mesh, seed=0, steps=3, batch=tokens.shape[0],
                           seq=cfg.max_seq, parity_layers=1, parity_seq=8)
    return out if dist.get_rank() == 0 else None


def init_params_numpy(cfg: LlamaConfig, seed: int) -> dict:
    """The port's single-device init, as numpy (the twin of init_sharded)."""
    return _numpy(init_params(torch.Generator().manual_seed(seed), cfg, torch.device("cpu")))


def resnet_rank(case: dict) -> dict:
    """The port's data-parallel ResNet step on this rank's mesh, one run
    per entry of ``case["runs"]``; rank 0 returns each run's losses and
    updated params in the reference's layout."""
    cfg = port_resnet.ResNetConfig(**case["cfg"])
    mesh = _mesh(case["mesh"])
    out = {"axes": list(mesh.mesh_dim_names), "shape": list(mesh.mesh.shape)}
    for name, run in case["runs"].items():
        port_resnet.COMPUTE_DTYPE = torch.float32 if run.get("f32") else torch.bfloat16
        step = port_resnet.make_dp_train_step(cfg, mesh, learning_rate=run["lr"])
        params = port_resnet.params_from_numpy(case["params"], torch.device("cpu"))
        losses = []
        for _ in range(run["steps"]):
            params, loss = step(params, run["images"], run["labels"])
            losses.append(float(loss))
        out[name] = {"losses": losses, "params": port_resnet.params_to_numpy(params)}
    port_resnet.COMPUTE_DTYPE = torch.bfloat16
    # the ResNet pod's body (graft.train_resnet), as the card runs it at width
    if case.get("pod"):
        out["pod"] = train_resnet(cfg, mesh, seed=0, steps=3, batch=8,
                                  parity_batch=4, parity_size=cfg.image_size)
    return out if dist.get_rank() == 0 else None


def mesh_rank(case: dict) -> dict:
    """The mesh ``mesh_from_alloc_env`` builds on this rank, and the sum of
    the ranks of its ``tp`` group where the rank holds a place in it."""
    mesh, _ = mesh_from_alloc_env(case["env"], dist.get_world_size(), case["tp"])
    coord = mesh.get_coordinate()
    out = {"axes": list(mesh.mesh_dim_names), "members": mesh.mesh.tolist(),
           "coordinate": None if coord is None else list(coord), "tp_sum": None}
    if coord is not None:
        t = torch.tensor([float(dist.get_rank())])
        dist.all_reduce(t, group=mesh.get_group("tp"))
        out["tp_sum"] = t.item()
    return out
