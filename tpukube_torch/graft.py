"""Entry points of the port.

:func:`entry` is the counterpart of ``entry()`` in ``__graft_entry__.py``:
a forward step of the Llama decoder at the reference's tiny config.
:func:`pod_main` (``python -m tpukube_torch.graft``) is the pod: it reads
the env the node agent minted at Allocate, takes the GPU it was given,
builds Llama-3-8B at full width from a seed, serves a few forward requests
and prints one JSON line of results.

Both run on the GPU unless the caller passes ``device="cpu"``; with no CUDA
device they raise rather than carry on on the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import sys
import time
from typing import Union

import torch

from tpukube_torch.native import GpuInfo
from tpukube_torch.workload.llama import (
    Llama,
    LlamaConfig,
    forward,
    init_params,
)
from tpukube_torch.workload.meshenv import PodGpuEnv, device_from_alloc_env

# the reference entry's config (__graft_entry__.py entry())
ENTRY_CFG = LlamaConfig(vocab=256, d_model=128, n_layers=2, n_heads=8,
                        n_kv_heads=4, d_ff=256, max_seq=64)

# card-vs-CPU parity of the served weights: bf16-level tolerance, as the
# reference's own JAX tests use (tests/test_workload.py)
PARITY_RTOL = 2e-2
PARITY_ATOL_OF_MAX = 2e-2


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(cfg: LlamaConfig, device: torch.device, *, seed: int, requests: int,
          batch: int, seq: int, parity_layers: int, parity_seq: int) -> dict:
    """Build the decoder from ``seed`` on ``device``, serve ``requests``
    forward passes of (batch, seq) random tokens after one warm-up, and
    check what comes out. Raises on any failed check; returns the numbers.

    Checks: f32 logits of the right shape, all finite; the loss of the
    random weights within 1.0 of ln(vocab); causality (changing token t
    leaves the logits before t unchanged); and the first ``parity_layers``
    layers with the full embed and unembed agree with the same function on
    the CPU."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Llama(cfg, init_params(gen, cfg, device))
    toks = [torch.randint(cfg.vocab, (batch, seq), generator=gen, device=device)
            for _ in range(requests + 1)]
    model(toks[0])  # warm-up
    _sync(device)
    times, logits = [], None
    for t in toks[1:]:
        t0 = time.perf_counter()
        logits = model(t)
        _sync(device)
        times.append(time.perf_counter() - t0)
        if logits.shape != (batch, seq, cfg.vocab) or logits.dtype != torch.float32:
            raise RuntimeError(f"logits {tuple(logits.shape)} {logits.dtype}")
        if not bool(torch.isfinite(logits).all()):
            raise RuntimeError("non-finite logits")

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
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }


def _check_uuid(device: torch.device, chip_index: int) -> str:
    """The CUDA device must be the GPU NVML lists at the allocated index."""
    with GpuInfo("real") as gi:
        nvml_uuid = gi.chips()[chip_index].chip_id
    cuda_uuid = "GPU-" + str(torch.cuda.get_device_properties(device).uuid)
    if cuda_uuid != nvml_uuid:
        raise RuntimeError(
            f"CUDA device {cuda_uuid} is not the allocated GPU {nvml_uuid}"
        )
    return nvml_uuid


def pod_main() -> int:
    """Serve Llama-3-8B (random weights from a fixed seed) on the GPU the
    Allocate env names; print one JSON line."""
    # f32 products stay full f32 (TF32 keeps ~3 decimal digits), and bf16
    # products reduce in f32 throughout, as XLA computes the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    pe = PodGpuEnv.from_env()
    device = device_from_alloc_env()
    uuid = _check_uuid(device, pe.visible_chips[0])
    out = serve(LlamaConfig.llama3_8b(), device, seed=0, requests=3,
                batch=2, seq=2048, parity_layers=2, parity_seq=64)
    out.update(device=torch.cuda.get_device_name(device), uuid=uuid,
               device_ids=list(pe.device_ids))
    print(json.dumps({"pod": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(pod_main())
