"""Port's Llama decoder (tpukube_torch/workload/llama.py) against the JAX
reference on the same numpy params and tokens.

Tolerances are bf16-level, as the reference's own tests use
(tests/test_workload.py): logits rtol 2e-2 with atol 2e-2 * max|ref| (the
two frameworks round bf16 at slightly different points), loss rel 2e-2."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukube.workload import llama as ref
from tpukube_torch import graft
from tpukube_torch.workload import llama as port

CPU = torch.device("cpu")

# the reference tests' TINY (H//KV = 2) and a GQA config with H//KV = 4
REF_CONFIGS = {
    "tiny": ref.LlamaConfig(vocab=64, d_model=32, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=64, max_seq=16),
    "gqa4": ref.LlamaConfig(vocab=96, d_model=64, n_layers=3, n_heads=8,
                            n_kv_heads=2, d_ff=128, max_seq=32,
                            rope_theta=500_000.0),
}
RTOL = 2e-2
ATOL_OF_MAX = 2e-2


def _port_cfg(cfg: ref.LlamaConfig) -> port.LlamaConfig:
    return port.LlamaConfig(**dataclasses.asdict(cfg))


def _numpy_params(cfg, seed):
    """Param tree of the reference's shapes, drawn with numpy; the norm
    gains are not all ones so the gain multiply is exercised."""
    rng = np.random.default_rng(seed)
    L, D, H, KV, HD, F = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, cfg.d_ff)

    def dense(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(np.float32)

    def gain(shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": dense((cfg.vocab, D), D),
        "layers": {
            "attn_norm": gain((L, D)),
            "wq": dense((L, D, H * HD), D),
            "wk": dense((L, D, KV * HD), D),
            "wv": dense((L, D, KV * HD), D),
            "wo": dense((L, H * HD, D), H * HD),
            "mlp_norm": gain((L, D)),
            "w_gate": dense((L, D, F), D),
            "w_up": dense((L, D, F), D),
            "w_down": dense((L, F, D), F),
        },
        "final_norm": gain((D,)),
        "unembed": dense((D, cfg.vocab), D),
    }


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape, dtype=np.int32)


def _assert_logits_close(got: torch.Tensor, want: np.ndarray):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL_OF_MAX * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(REF_CONFIGS))
def test_forward_and_loss_match_reference(name):
    cfg = REF_CONFIGS[name]
    np_params = _numpy_params(cfg, seed=1)
    tokens = _tokens(cfg, (3, cfg.max_seq), seed=2)
    want = jax.jit(lambda p, t: ref.forward(p, t, cfg))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(tokens))
    want_loss = float(ref.loss_fn(jax.tree.map(jnp.asarray, np_params),
                                  jnp.asarray(tokens), cfg))

    params = port.params_from_numpy(np_params, CPU)
    pcfg = _port_cfg(cfg)
    got = port.forward(params, torch.from_numpy(tokens), pcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    _assert_logits_close(got, want)
    got_loss = float(port.loss_fn(params, torch.from_numpy(tokens), pcfg))
    assert got_loss == pytest.approx(want_loss, rel=2e-2)

    # the module over the same tree computes the same function
    model = port.Llama(pcfg, params)
    assert torch.equal(model(torch.from_numpy(tokens)), got)
    assert float(model.loss(torch.from_numpy(tokens))) == got_loss


def test_gqa_query_head_reads_its_own_kv_head():
    """Only kv head 1's value weights are nonzero, so only query heads
    h with h // (H // KV) == 1 see a nonzero context; grouping by tiling
    (h % KV) would feed other heads, and the logits would differ from the
    reference's."""
    cfg = REF_CONFIGS["gqa4"]
    p = _numpy_params(cfg, seed=3)
    HD = cfg.head_dim
    wv = np.zeros_like(p["layers"]["wv"])
    wv[:, :, 1 * HD:2 * HD] = p["layers"]["wv"][:, :, 1 * HD:2 * HD]
    p["layers"]["wv"] = wv
    tokens = _tokens(cfg, (2, 8), seed=4)
    want = ref.forward(jax.tree.map(jnp.asarray, p), jnp.asarray(tokens), cfg)
    got = port.forward(port.params_from_numpy(p, CPU), torch.from_numpy(tokens),
                       _port_cfg(cfg))
    _assert_logits_close(got, want)


def test_forward_shapes_and_dtype():
    # twin of tests/test_workload.py test_forward_shapes_and_dtype
    cfg = _port_cfg(REF_CONFIGS["tiny"])
    gen = torch.Generator(device=CPU).manual_seed(0)
    params = port.init_params(gen, cfg, CPU)
    tokens = torch.randint(cfg.vocab, (3, 8), generator=gen)
    logits = port.forward(params, tokens, cfg)
    assert logits.shape == (3, 8, cfg.vocab)
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    # random init: the loss sits near ln(vocab), as the pod checks at 8B
    assert abs(float(port.loss_fn(params, tokens, cfg)) - math.log(cfg.vocab)) < 1.0


def test_init_params_tree_matches_reference_layout():
    cfg = REF_CONFIGS["gqa4"]
    want = jax.eval_shape(lambda: ref.init_params(jax.random.PRNGKey(0), cfg))
    got = port.init_params(torch.Generator(device=CPU).manual_seed(0),
                           _port_cfg(cfg), CPU)
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(w.shape) == tuple(g.shape) and g.dtype == torch.float32


def test_causality():
    # twin of tests/test_workload.py test_causality
    cfg = _port_cfg(REF_CONFIGS["tiny"])
    gen = torch.Generator(device=CPU).manual_seed(0)
    params = port.init_params(gen, cfg, CPU)
    t1 = torch.randint(cfg.vocab, (1, 8), generator=gen)
    t2 = t1.clone()
    t2[0, 6] = (t1[0, 6] + 1) % cfg.vocab
    l1 = port.forward(params, t1, cfg)
    l2 = port.forward(params, t2, cfg)
    np.testing.assert_allclose(l1[0, :6], l2[0, :6], atol=1e-5)
    assert not np.allclose(l1[0, 6:], l2[0, 6:])


def test_entry_matches_reference_entry():
    import __graft_entry__ as g

    ref_fn, (ref_params, ref_tokens) = g.entry()
    want = jax.jit(ref_fn)(ref_params, ref_tokens)

    fwd, (params, tokens) = graft.entry(device="cpu")
    assert tokens.shape == ref_tokens.shape and tokens.device == CPU
    np_params = jax.tree.map(np.asarray, ref_params)
    assert jax.tree.structure(np_params) == jax.tree.structure(params)
    got = fwd(port.params_from_numpy(np_params, CPU), tokens)
    _assert_logits_close(got, want)
    assert torch.isfinite(fwd(params, tokens)).all()


def test_entry_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()
