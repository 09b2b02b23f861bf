"""The port's sharded Llama training step (tpukube_torch/workload/train.py)
against the JAX reference (tpukube/workload/train.py, llama.py, optax) on
the same numpy params, gradients and tokens.

The port runs as 8 gloo ranks, spawned once per mesh: dp×tp (4, 2) and
(2, 4), and dcn×dp×tp (2, 2, 2) from a DCN gang env that the reference's
control plane mints. Tokens (8, 16) give S = 15, which splits over neither
tp = 2 nor tp = 4; TINY has 2 kv heads, so tp = 4 shares each kv head
between two ranks.

Tolerances, each with its reason:

- loss and gradients with both decoders computing in float32 (the port's
  ``llama.COMPUTE_DTYPE`` in the ranks, the reference's ``jnp.bfloat16``
  read as float32): loss rel 1e-5, each gathered gradient leaf atol
  1e-5 · max|ref|. This holds the sharded algorithm itself (collectives,
  padding, kv sharing, batch averaging);
- the same in bfloat16, as shipped: loss rel 2e-2 as in
  tests/test_workload.py; each gradient leaf within 5e-2 of the
  reference in relative L2 norm. At TINY the reference's own bf16
  gradients miss 2e-2 · max|ref| element-wise against its float32 ones
  (test_reference_bf16_gradients_are_this_noisy), so no port can hold
  that bound against them;
- the optimizer alone at rtol 1e-5 (float32, the same formula), with
  atol 1e-7 where an update lands a value next to zero;
- a full step's params at atol 2·lr, since AdamW's first update is ±lr
  per element wherever the gradient's sign is decided by bf16 rounding."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpukube.workload import llama as ref
from tpukube.workload import train as ref_train
from tpukube.workload.meshenv import build_mesh as ref_build_mesh
from tpukube.workload.meshenv import build_multislice_mesh as ref_multislice
from tpukube_torch import graft
from tpukube_torch.workload import llama as port
from tpukube_torch.workload import train as port_train
from test_torch_tp import init_params_numpy, llama_rank

TINY = ref.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                       d_ff=64, max_seq=16)
PORT_TINY = port.LlamaConfig(**dataclasses.asdict(TINY))
LR = 3e-4
NORMS = {"small": 0.5, "big": 5.0}  # global norms of the optimizer's gradients


def port_env(ref_env: dict) -> dict:
    """A reference Allocate env as the port's node agent names its keys:
    the visible-devices key becomes CUDA's, every TPU_KUBE_* key stays."""
    env = {k: v for k, v in ref_env.items() if k != "TPU_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ref_env["TPU_VISIBLE_DEVICES"]
    env["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    return env


def _np_params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(lambda: ref.init_params(jax.random.PRNGKey(0), TINY))

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name:  # gains off one, so their gradients matter
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (rng.standard_normal(s.shape) * s.shape[-2 if len(s.shape) > 1 else 0] ** -0.5
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _scaled_like(tree: dict, norm: float, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    total = np.sqrt(sum(float(np.sum(x.astype(np.float64) ** 2)) for x in jax.tree.leaves(g)))
    return jax.tree.map(lambda a: (a * (norm / total)).astype(np.float32), g)


PARAMS = _np_params(1)
TOKENS = np.random.default_rng(2).integers(0, TINY.vocab, (8, 16), dtype=np.int32)
OPT_GRADS = {name: _scaled_like(PARAMS, n, seed=3 + i) for i, (name, n) in enumerate(NORMS.items())}

CASES = {
    "4x2": {"mesh": {"dp": 4, "tp": 2}, "seq_parallel": [True, False],
            "remat_off": True, "init_steps": 8, "pod": True},
    "2x4": {"mesh": {"dp": 2, "tp": 4}, "seq_parallel": [True], "init_steps": 1},
    "2x2x2": {"mesh": {"gang": True, "tp": 2}, "seq_parallel": [True]},
}


@functools.lru_cache(maxsize=None)
def _minted_env() -> dict:
    import __graft_entry__ as g

    return port_env(g._mint_dcn_gang_env())


@functools.lru_cache(maxsize=None)
def port_run(name: str) -> dict:
    """Rank 0's report of the port's checks on one mesh (one spawn)."""
    case = dict(CASES[name])
    mesh = dict(case["mesh"])
    if mesh.pop("gang", False):
        mesh["gang_env"] = _minted_env()
    case.update(mesh=mesh, cfg=dataclasses.asdict(PORT_TINY), params=PARAMS,
                tokens=TOKENS, opt_grads=OPT_GRADS)
    return graft.run_ranks(llama_rank, 8, "gloo", (case,))[0]


class _Float32Numpy:
    """jax.numpy with ``bfloat16`` read as ``float32``."""

    def __getattr__(self, name):
        return jnp.float32 if name == "bfloat16" else getattr(jnp, name)


def in_float32(module, fn, *args):
    """``fn(*args)`` with ``module``'s ``jnp.bfloat16`` read as float32: a
    reference module computed in float32 where its compute dtype is that
    one name. Traces made meanwhile keep the float32 math."""
    saved = module.jnp
    module.jnp = _Float32Numpy()
    try:
        return fn(*args)
    finally:
        module.jnp = saved


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(f32: bool = False):
    # the reference decoder's one compute-dtype cast: jnp.bfloat16 in llama.forward
    run = jax.jit(jax.value_and_grad(lambda p, t: ref.loss_fn(p, t, TINY)))
    args = (jax.tree.map(jnp.asarray, PARAMS), jnp.asarray(TOKENS))
    loss, grads = in_float32(ref, run, *args) if f32 else run(*args)
    return float(loss), jax.tree.map(np.asarray, grads)


def _ref_mesh(name: str):
    if name == "2x2x2":
        return ref_multislice(jax.devices(), num_slices=2, dp=2, tp=2)
    dp, tp = CASES[name]["mesh"]["dp"], CASES[name]["mesh"]["tp"]
    return ref_build_mesh(jax.devices(), dp, tp)


def _leaf_pairs(got: dict, want):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        yield jax.tree_util.keystr(path), g, np.asarray(w)


def _assert_grads_f32(got: dict, want, what: str):
    for name, g, w in _leaf_pairs(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"{what} {name}")


def _assert_grads_bf16(got: dict, want, what: str):
    for name, g, w in _leaf_pairs(got, want):
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= 5e-2, f"{what} {name}: relative L2 error {rel}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_match_reference_in_float32(name):
    want_loss, want = ref_loss_and_grads(f32=True)
    out = port_run(name)
    assert out["loss_f32"] == pytest.approx(want_loss, rel=1e-5)
    _assert_grads_f32(out["grads_f32"], want, f"grad {name}")


def test_reference_bf16_gradients_are_this_noisy():
    # why the bf16 gradient bound is a relative L2 one: the reference's
    # own bf16 gradients miss 2e-2 * max|ref| element-wise against its
    # float32 ones on some leaf, yet stay within 5e-2 in relative L2
    _, bf16 = ref_loss_and_grads()
    _, f32 = ref_loss_and_grads(f32=True)
    pairs = list(_leaf_pairs(bf16, f32))
    assert any(np.abs(g - w).max() > 2e-2 * np.abs(w).max() for _, g, w in pairs)
    assert all(np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w) for _, g, w in pairs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_grads_match_reference(name):
    want_loss, want = ref_loss_and_grads()
    out = port_run(name)
    assert out["loss_sp1"] == pytest.approx(want_loss, rel=2e-2)
    _assert_grads_bf16(out["grads_sp1"], want, f"grad {name}")


def test_dcn_case_builds_its_mesh_from_the_minted_gang_env():
    out = port_run("2x2x2")
    assert out["axes"] == ["dcn", "dp", "tp"] and out["shape"] == [2, 2, 2]


def test_without_sequence_parallelism_matches_reference():
    want_loss, want = ref_loss_and_grads()
    out = port_run("4x2")
    assert out["loss_sp0"] == pytest.approx(want_loss, rel=2e-2)
    _assert_grads_bf16(out["grads_sp0"], want, "grad (no SP)")


def test_block_checkpointing_is_the_same_math():
    out = port_run("4x2")
    for path, g in jax.tree_util.tree_leaves_with_path(out["grads_sp1"]):
        h = out["grads_remat0"]
        for k in path:
            h = h[k.key]
        np.testing.assert_array_equal(g, h, err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def ref_optimizer(name: str):
    opt = ref_train.make_optimizer()
    params = jax.tree.map(jnp.asarray, PARAMS)
    grads = jax.tree.map(jnp.asarray, OPT_GRADS[name])
    state = opt.init(params)
    update = jax.jit(opt.update)
    for _ in range(3):
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
    adam = state[1][0]
    return (float(optax.global_norm(grads)),
            jax.tree.map(np.asarray, {"params": params, "mu": adam.mu, "nu": adam.nu}))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("norm", sorted(NORMS))
def test_clip_and_adamw_match_optax(name, norm):
    want_norm, want = ref_optimizer(norm)
    got = port_run(name)[f"opt_{norm}"]
    assert (want_norm < 1.0) == (norm == "small")
    assert got["norm"] == pytest.approx(want_norm, rel=1e-5)
    for part in ("params", "mu", "nu"):
        for path, w in jax.tree_util.tree_leaves_with_path(want[part]):
            g = got[part]
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7 if part == "params" else 0,
                                       err_msg=f"{part} {jax.tree_util.keystr(path)}")


@functools.lru_cache(maxsize=None)
def ref_step(name: str):
    mesh = _ref_mesh(name)
    with mesh:
        step, opt_init = ref_train.make_train_step(TINY, mesh)
        params = jax.tree.map(jnp.asarray, PARAMS)
        params, _, loss = step(params, opt_init(params), jnp.asarray(TOKENS))
        return float(loss), jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", sorted(CASES))
def test_one_step_matches_reference_step(name):
    want_loss, want = ref_step(name)
    got = port_run(name)["step"]
    assert got["loss"] == pytest.approx(want_loss, rel=2e-2)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got["params"]
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR,
                                   err_msg=jax.tree_util.keystr(path))


def test_loss_decreases_under_training():
    # twin of tests/test_workload.py test_loss_decreases_under_training
    losses = port_run("4x2")["init_losses"]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


def test_tp_matches_single_device():
    # twin of tests/test_workload.py test_tp_matches_single_device: the
    # sharded init from seed 0 is the single-device init, and the step's
    # loss is the single-device loss
    out = port_run("2x4")
    want = init_params_numpy(PORT_TINY, seed=0)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = out["init"]
        for k in path:
            g = g[k.key]
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    single = float(port.loss_fn(port.params_from_numpy(want, torch.device("cpu")),
                                torch.from_numpy(TOKENS), PORT_TINY))
    assert out["init_losses"][0] == pytest.approx(single, rel=2e-2)


@pytest.mark.parametrize("field,change", [
    ("n_heads", {"n_heads": 6, "d_model": 48}),
    ("d_ff", {"d_ff": 66}),
    ("vocab", {"vocab": 66}),
    ("n_kv_heads", {"n_heads": 12, "n_kv_heads": 3, "d_model": 48}),
])
def test_uneven_shards_raise(field, change):
    # TINY shards evenly over tp = 4; each change breaks one dimension
    port_train.check_tp(PORT_TINY, 4)
    with pytest.raises(ValueError, match=field):
        port_train.check_tp(dataclasses.replace(PORT_TINY, **change), 4)


def test_param_specs_match_reference():
    want = ref_train.param_specs(TINY)
    got = port_train.param_specs(PORT_TINY)
    leaves = jax.tree_util.tree_leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == 12
    for path, spec in leaves:
        g = got
        for k in path:
            g = g[k.key]
        assert g == tuple(spec), jax.tree_util.keystr(path)


def test_llama_module_trains_and_still_serves():
    params = port.params_from_numpy(PARAMS, torch.device("cpu"))
    model = port.Llama(PORT_TINY, params)
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.from_numpy(TOKENS)
    model.loss(tokens, remat=True).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    with torch.inference_mode():
        served = model(tokens)
    assert not served.requires_grad
    assert torch.equal(served, model(tokens).detach())


def test_remat_forward_and_grads_equal_plain():
    params = port.params_from_numpy(PARAMS, torch.device("cpu"))
    leaves = [params["embed"], params["unembed"], *params["layers"].values()]
    for t in leaves:
        t.requires_grad_(True)
    tokens = torch.from_numpy(TOKENS)
    plain = port.loss_fn(params, tokens, PORT_TINY)
    remat = port.loss_fn(params, tokens, PORT_TINY, remat=True)
    assert torch.equal(plain, remat)
    for a, b in zip(torch.autograd.grad(plain, leaves), torch.autograd.grad(remat, leaves)):
        assert torch.equal(a, b)


def test_train_pod_at_tiny_size_on_cpu():
    # the training pod's body, as chip_smoke.py runs it at Llama-3-8B width
    # on one card, here at TINY over the (4, 2) gloo mesh
    out = port_run("4x2")["pod"]
    assert len(out["step_ms"]) == 3 and out["tokens_per_s"] > 0
    assert out["losses"][-1] < out["losses"][0]
    assert out["parity_loss"] == pytest.approx(out["parity_ref_loss"], rel=2e-2)
    assert out["max_memory_allocated"] is None
    assert out["params"] == sum(np.asarray(x).size for x in jax.tree.leaves(PARAMS))
