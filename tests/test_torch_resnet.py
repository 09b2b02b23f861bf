"""The port's ResNet (tpukube_torch/workload/resnet.py) against the JAX
reference (tpukube/workload/resnet.py) on the same numpy params, images
and labels, and its data-parallel step on gloo ranks against the
reference's on the 8-device CPU mesh.

Tolerances, each with its reason:

- logits rtol 2e-2 with atol 2e-2 · max|ref| and losses rel 2e-2,
  bf16-level as the reference's own tests use;
- a data-parallel step with both nets computing in float32 (the port's
  ``resnet.COMPUTE_DTYPE`` in the ranks, the reference's ``jnp.bfloat16``
  read as float32): loss rel 1e-5 and updated params at atol
  1e-3 · lr · max|grad| per leaf (the gradient held at 1e-3 · max|grad|).
  This holds the DP algorithm itself;
- the same step in bfloat16, as shipped: loss rel 2e-2, and each leaf's
  update within 0.15 of the reference's in relative L2 norm. Split over
  ranks, each side rounds its shard's partial gradients to bf16 at other
  points, and at this size the reference's own bf16 stem gradient lies
  more than 5e-2 (relative L2) from its float32 one
  (test_reference_bf16_gradients_are_this_noisy)."""

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpukube.workload import resnet as ref
from tpukube.workload.meshenv import build_multislice_mesh as ref_multislice
from tpukube_torch import graft
from tpukube_torch.workload import resnet as port
from test_torch_tp import resnet_rank
from test_torch_train import in_float32

CPU = torch.device("cpu")
TINY = ref.ResNetConfig(num_classes=10, width=8, stage_blocks=(1, 1), groups=4,
                        image_size=8)
BOTTLENECK = ref.ResNetConfig(num_classes=5, width=8, stage_blocks=(1, 1),
                              bottleneck=True, groups=4, image_size=8)
LR = 0.05


def _port_cfg(cfg):
    return port.ResNetConfig(**dataclasses.asdict(cfg))


def _np_params(cfg, seed=0):
    return jax.tree.map(np.asarray, ref.init_params(jax.random.PRNGKey(seed), cfg))


def _batch(n, cfg=TINY, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, (n,), dtype=np.int32)
    return images, labels


def _assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("cfg", [TINY, BOTTLENECK], ids=["basic", "bottleneck"])
def test_forward_matches_reference(cfg):
    # stage 1 opens with a stride-2 block on an even (8x8) input: SAME pads
    # the basic block's 3x3 conv by (0, 1)
    params = _np_params(cfg)
    images, labels = _batch(3, cfg, seed=1)
    want = jax.jit(lambda p, x: ref.forward(p, x, cfg))(jax.tree.map(jnp.asarray, params),
                                                         jnp.asarray(images))
    got = port.forward(port.params_from_numpy(params, CPU), torch.from_numpy(images),
                       _port_cfg(cfg))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _assert_close(got.numpy(), want)
    want_loss = float(jax.jit(lambda p, x, y: ref.loss_fn(p, x, y, cfg))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(images), jnp.asarray(labels)))
    got_loss = float(port.loss_fn(port.params_from_numpy(params, CPU),
                                  torch.from_numpy(images), torch.from_numpy(labels),
                                  _port_cfg(cfg)))
    assert got_loss == pytest.approx(want_loss, rel=2e-2)


@pytest.mark.parametrize("size", [8, 9])
def test_same_padding_matches_xla(size):
    # stride 2 on an even input pads (0, 1), on an odd one (1, 1)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    want = ref._conv(jnp.asarray(x), jnp.asarray(w), stride=2)
    got = port._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(w).permute(3, 2, 0, 1), stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_strided_identity_shortcut_matches_reference():
    # stock configs always project when they stride; the block still takes
    # the strided identity when cin == cout, as the reference's does
    cfg = TINY
    rng = np.random.default_rng(4)
    c = 8
    p = {"convs": [(rng.standard_normal((3, 3, c, c)) * 0.2).astype(np.float32)
                   for _ in range(2)],
         "norms": [(np.ones(c, np.float32), np.zeros(c, np.float32))] * 2}
    x = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    want = ref._apply_block(jnp.asarray(x, jnp.bfloat16), jax.tree.map(jnp.asarray, p),
                            cfg, stride=2)
    tp = {"convs": [torch.from_numpy(w).permute(3, 2, 0, 1) for w in p["convs"]],
          "norms": [tuple(torch.from_numpy(a) for a in n) for n in p["norms"]]}
    got = port._apply_block(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
                            tp, _port_cfg(cfg), stride=2)
    assert tuple(got.shape) == (2, c, 4, 4)
    _assert_close(got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want, np.float32))


def test_params_round_trip_through_the_port_layout():
    params = _np_params(BOTTLENECK)
    back = port.params_to_numpy(port.params_from_numpy(params, CPU))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_forward_shapes_and_dtype():
    # twin of tests/test_resnet.py test_forward_shapes_and_dtype
    cfg = _port_cfg(TINY)
    params = port.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    logits = port.forward(params, torch.from_numpy(_batch(3)[0]), cfg)
    assert tuple(logits.shape) == (3, TINY.num_classes)
    assert logits.dtype == torch.float32


def test_bottleneck_variant():
    # twin of tests/test_resnet.py test_bottleneck_variant
    cfg = _port_cfg(BOTTLENECK)
    params = port.init_params(torch.Generator().manual_seed(0), cfg, CPU)
    logits = port.forward(params, torch.from_numpy(_batch(2, BOTTLENECK)[0]), cfg)
    assert tuple(logits.shape) == (2, 5)


def test_init_params_tree_matches_reference_layout():
    # twin of tests/test_resnet.py test_downsampling_halves_spatial, plus
    # the whole tree: the reference's shapes once carried to the port
    for cfg in (TINY, BOTTLENECK):
        want = port.params_from_numpy(_np_params(cfg), CPU)
        got = port.init_params(torch.Generator().manual_seed(0), _port_cfg(cfg), CPU)
        assert got["head"].shape[0] == cfg.stage_width(len(cfg.stage_blocks) - 1)
        for w, g in zip(port.param_leaves(want), port.param_leaves(got)):
            assert w.shape == g.shape and g.dtype == torch.float32


def _under(f32: bool, fn, *args):
    # the reference net in float32: its one compute-dtype cast is the
    # jnp.bfloat16 of resnet.forward
    return in_float32(ref, fn, *args) if f32 else fn(*args)


def _fresh_params():
    # a copy per call: the reference's step donates its params
    return jax.tree.map(jnp.array, _np_params(TINY))


@functools.lru_cache(maxsize=None)
def port_run(n: int) -> dict:
    """Rank 0's report of the port's DP runs on n gloo ranks (one spawn):
    4 ranks on ("dp", "tp") = (4, 1), 8 on ("dcn", "dp", "tp") = (2, 4, 1)."""
    images, labels = _batch(8 if n == 4 else 16)
    case = {"cfg": dataclasses.asdict(TINY), "params": _np_params(TINY)}
    one = {"lr": 1e-2 if n == 4 else LR, "steps": 1, "images": images, "labels": labels}
    runs = {"one": one, "one_f32": {**one, "f32": True}}
    if n == 4:
        runs["five"] = {"lr": LR, "steps": 5, "images": images, "labels": labels}
        case.update(mesh={"dp": 4, "tp": 1}, pod=True, runs=runs)
    else:
        case.update(mesh={"dcn": 2, "dp": 4, "tp": 1}, runs=runs)
    return graft.run_ranks(resnet_rank, n, "gloo", (case,))[0]


def test_dp_loss_decreases():
    # twin of tests/test_resnet.py test_dp_loss_decreases
    losses = port_run(4)["five"]["losses"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_dp_matches_single_device():
    # twin of tests/test_resnet.py test_dp_matches_single_device
    images, labels = _batch(8)
    single = float(port.loss_fn(port.params_from_numpy(_np_params(TINY), CPU),
                                torch.from_numpy(images), torch.from_numpy(labels),
                                _port_cfg(TINY)))
    assert abs(port_run(4)["one"]["losses"][0] - single) < 1e-2  # bf16 tolerance


def _ref_grads(images, labels, f32):
    return _under(f32, jax.grad(ref.loss_fn), _fresh_params(), jnp.asarray(images),
                  jnp.asarray(labels), TINY)


def _assert_updated(got, want, grads, lr, f32):
    p0 = jax.tree.leaves(_np_params(TINY))
    for (path, w), g, x, p in zip(jax.tree_util.tree_leaves_with_path(want),
                                  jax.tree.leaves(grads), jax.tree.leaves(got), p0):
        name, w = jax.tree_util.keystr(path), np.asarray(w)
        if f32:
            np.testing.assert_allclose(x, w, rtol=0, atol=1e-3 * lr * np.abs(np.asarray(g)).max(),
                                       err_msg=name)
        else:
            rel = np.linalg.norm((x - p) - (w - p)) / np.linalg.norm(w - p)
            assert rel <= 0.15, f"{name}: update relative L2 error {rel}"


def test_reference_bf16_gradients_are_this_noisy():
    # why the bf16 update bound is 0.15 in relative L2: the reference's own
    # bf16 stem gradient lies more than 5e-2 from its float32 one
    images, labels = _batch(8)
    bf16, f32 = (_ref_grads(images, labels, f32) for f32 in (False, True))
    g, w = np.asarray(bf16["stem"]), np.asarray(f32["stem"])
    assert np.linalg.norm(g - w) > 5e-2 * np.linalg.norm(w)


@pytest.fixture(scope="module")
def dp_reference():
    images, labels = _batch(8)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("dp",))
    out = {}
    for f32 in (False, True):
        step = ref.make_dp_train_step(TINY, mesh, learning_rate=1e-2)
        params, loss = _under(f32, step, _fresh_params(), images, labels)
        out[f32] = (float(loss), params, _ref_grads(images, labels, f32))
    return out


@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_dp_step_matches_reference_step(dp_reference, f32):
    want_loss, want, grads = dp_reference[f32]
    got = port_run(4)["one_f32" if f32 else "one"]
    assert got["losses"][0] == pytest.approx(want_loss, rel=1e-5 if f32 else 2e-2)
    _assert_updated(got["params"], want, grads, 1e-2, f32)


@pytest.fixture(scope="module")
def multislice_reference():
    mesh = ref_multislice(jax.devices(), num_slices=2, dp=4, tp=1)
    batch_spec = NamedSharding(mesh, P(("dcn", "dp")))
    repl = NamedSharding(mesh, P())
    images, labels = _batch(16)
    out = {}
    for f32 in (False, True):
        @partial(jax.jit, in_shardings=(repl, batch_spec, batch_spec),
                 out_shardings=(repl, None))
        def step(params, images, labels):
            loss, grads = jax.value_and_grad(ref.loss_fn)(params, images, labels, TINY)
            return jax.tree_util.tree_map(lambda p, g: p - LR * g, params, grads), loss

        with mesh:
            params, loss = _under(f32, step, _fresh_params(), images, labels)
        out[f32] = (float(loss), params, _ref_grads(images, labels, f32))
    return out


@pytest.mark.parametrize("f32", [True, False], ids=["float32", "bfloat16"])
def test_multislice_dp_step_runs(multislice_reference, f32):
    """Twin of tests/test_resnet.py test_multislice_dp_step_runs: batch over
    ("dcn", "dp"), params replicated, held against the reference's step."""
    want_loss, want, grads = multislice_reference[f32]
    out = port_run(8)
    assert out["axes"] == ["dcn", "dp", "tp"] and out["shape"] == [2, 4, 1]
    got = out["one_f32" if f32 else "one"]
    assert np.isfinite(got["losses"][0])
    assert got["losses"][0] == pytest.approx(want_loss, rel=1e-5 if f32 else 2e-2)
    _assert_updated(got["params"], want, grads, LR, f32)


def test_resnet_pod_at_tiny_size_on_cpu():
    # the ResNet pod's body, as chip_smoke.py runs it with ResNet-50 on one
    # card, here at TINY over 4 gloo ranks
    out = port_run(4)["pod"]
    assert len(out["step_ms"]) == 3 and out["images_per_s"] > 0
    assert out["losses"][-1] < out["losses"][0]
    assert out["parity_loss"] == pytest.approx(out["parity_ref_loss"], rel=2e-2)
    assert out["max_memory_allocated"] is None
    # the stem's norm and two a basic block; the CPU launches no kernel
    assert out["norms"] == 1 + 2 * sum(TINY.stage_blocks)
    assert out["norm_launches"] == 0
