"""``tpukube_torch.workload.graphs.ByShape``: a forward captured once per
input shape and replayed.

Off CUDA it captures nothing and runs the function as it is. The tests
marked ``card`` need CUDA and skip without it; on the card:
``python -m pytest tests/test_torch_graphs.py -m card --noconftest``.
There the MLA + MoE decoder at a tiny size, replayed, gives the eager
forward's logits and routing bit for bit, at every captured length.
"""

import pytest
import torch

from kubebench import weights_mla_moe
from tpukube_torch.workload import graphs, mla_moe

HF = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 8, "v_head_dim": 16, "intermediate_size": 128,
      "n_routed_experts": 8, "num_experts_per_tok": 2, "moe_intermediate_size": 32,
      "n_shared_experts": 2, "routed_scaling_factor": 2.446, "first_k_dense_replace": 1,
      "num_hidden_layers": 3, "vocab_size": 256, "rms_norm_eps": 1e-5, "rope_theta": 50000,
      "assumed": {"e_score_correction_bias_std": 0.05}}
CFG = mla_moe.MlaMoeConfig(
    vocab=256, d_model=64, n_layers=3, first_dense=1, n_heads=4, kv_rank=32, qk_nope_dim=16,
    qk_rope_dim=8, v_dim=16, d_ff_dense=128, n_experts=8, top_k=2, d_expert=32, n_shared=2)
SEED = 2 ** 33 + 5
LENGTHS = (48, 24, 16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip (see the module's docstring)")
    return torch.device("cuda", 0)


def _tokens(n, device, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, HF["vocab_size"], (1, n), generator=g).to(device)


def _serve(params):
    def serve(toks):
        routes: list = []
        return mla_moe.forward(params, toks, CFG, routes), torch.stack(routes)
    return serve


def test_off_cuda_nothing_is_captured_and_the_function_runs():
    calls = []

    def fn(x):
        calls.append(x.shape)
        return x * 2

    served = graphs.ByShape(fn, [torch.ones(3), torch.ones(5)])
    assert served.shapes == [] and calls == []
    assert torch.equal(served(torch.arange(4.0)), torch.arange(4.0) * 2)
    assert calls == [torch.Size([4])]


@pytest.mark.parametrize("examples", [[], [torch.zeros(0)]])
def test_no_cuda_example_means_no_graph(examples):
    served = graphs.ByShape(lambda x: x + 1, examples)
    assert served.shapes == []


def test_the_cpu_forward_is_the_eager_forward():
    params = weights_mla_moe.params(HF, SEED, torch.device("cpu"))
    serve = _serve(params)
    served = graphs.ByShape(serve, [_tokens(n, "cpu") for n in LENGTHS])
    toks = _tokens(24, "cpu", seed=9)
    with torch.inference_mode():
        got, want = served(toks), serve(toks)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.card
def test_replays_equal_the_eager_forward_on_the_card(cuda):
    params = weights_mla_moe.params(HF, SEED, cuda)
    serve = _serve(params)
    with torch.inference_mode():
        served = graphs.ByShape(serve, [_tokens(n, cuda) for n in LENGTHS])
        assert sorted(served.shapes) == sorted((1, n) for n in LENGTHS)
        for n in LENGTHS:
            toks = _tokens(n, cuda, seed=n)
            want = serve(toks)
            got = served(toks)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.card
def test_a_replay_overwrites_the_last_outputs_of_its_shape(cuda):
    params = weights_mla_moe.params(HF, SEED, cuda)
    serve = _serve(params)
    with torch.inference_mode():
        served = graphs.ByShape(serve, [_tokens(24, cuda)])
        first = served(_tokens(24, cuda, seed=1))
        kept = first[0].clone()
        second = served(_tokens(24, cuda, seed=2))
        assert second[0] is first[0]
        assert torch.equal(second[0], serve(_tokens(24, cuda, seed=2))[0])
        assert not torch.equal(first[0], kept)


@pytest.mark.card
def test_a_shape_with_no_graph_runs_the_function(cuda):
    params = weights_mla_moe.params(HF, SEED, cuda)
    serve = _serve(params)
    with torch.inference_mode():
        served = graphs.ByShape(serve, [_tokens(24, cuda)])
        toks = _tokens(40, cuda)
        got, want = served(toks), serve(toks)
    assert (1, 40) not in served.shapes
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
