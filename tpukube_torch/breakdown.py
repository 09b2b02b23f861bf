"""Where the training pods' step time goes on the card.

    python -m tpukube_torch.breakdown

Builds, over a world-1 NCCL ``DeviceMesh`` on GPU 0, the two steps that
``chip_smoke.py``'s training pods run: Llama-3-8B at full width and depth 4
(B=2, S=2048, clip + AdamW) and ResNet-50 (batch 64 at 224x224, SGD).
After one warm-up step each:

- times the Llama step's two phases with CUDA events, the mean of 3:
  loss and gradients (forward, per-block recompute, backward and the
  gradient collectives) and the update (global norm, clip, AdamW);
- profiles one more step of each with ``torch.profiler`` and sums the
  device time of its kernels by kind, with the device's idle share over
  the step (1 - the union of kernel intervals / the step's wall time).

Prints the card's name and power limit, then one JSON line. Needs CUDA:
without it, it exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpukube_torch.graft import free_port
from tpukube_torch.workload import resnet
from tpukube_torch.workload.llama import LlamaConfig
from tpukube_torch.workload.meshenv import build_mesh
from tpukube_torch.workload.train import (
    global_grad_norm,
    init_sharded,
    make_loss_and_grad,
    make_optimizer,
)

# kernel kinds, first match wins (names lower-cased)
KINDS = [
    ("nccl", r"nccl"),
    ("convolution", r"conv|fprop|dgrad|wgrad|cudnn|implicit"),
    ("matmul", r"gemm|cutlass|cublas|nvjet|xmma|matmul"),
    ("normalization", r"norm|moments|welford"),
    ("softmax", r"softmax"),
    ("copy/cast", r"copy|cast|convert"),
    ("reduction", r"reduce"),
    ("elementwise", r"elementwise|vectorized|foreach"),
]


def _kind(name: str) -> str:
    low = name.lower()
    for kind, pattern in KINDS:
        if re.search(pattern, low):
            return kind
    return "other"


def _profile(step, device: torch.device) -> dict:
    """One profiled call of ``step``: device ms by kernel kind, the top
    kernels, and the idle share over the call's wall time."""
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_kind, by_name = defaultdict(float), defaultdict(float)
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[_kind(e.name)] += us / 1e3
        by_name[e.name[:90]] += us / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for start, stop in sorted(spans):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return {
        "wall_ms": wall_us / 1e3,
        "kernels": len(kernels),
        "device_ms_by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
        "idle_share": (1.0 - busy / wall_us) if kernels else None,
    }


def _event_ms(fn, device: torch.device, repeats: int = 3) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / repeats


def llama(mesh, device: torch.device) -> dict:
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=4)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_sharded(gen, cfg, mesh)
    loss_and_grad = make_loss_and_grad(cfg, mesh)
    opt = make_optimizer()
    state = opt.init(params)
    tokens = torch.randint(cfg.vocab, (2, 2049), generator=gen, device=device)
    held = {}

    def grads():
        held["grads"] = loss_and_grad(params, tokens)[1]

    def update():
        g = held["grads"]
        opt.update(params, g, state, global_grad_norm(g, cfg, mesh))

    def step():
        grads()
        update()

    step()  # warm-up
    out = {"grads_ms": _event_ms(grads, device), "update_ms": _event_ms(update, device)}
    out["profile"] = _profile(step, device)
    return out


def resnet50(mesh, device: torch.device) -> dict:
    cfg = resnet.ResNetConfig.resnet50()
    gen = torch.Generator(device=device).manual_seed(0)
    params = resnet.init_params(gen, cfg, device)
    step = resnet.make_dp_train_step(cfg, mesh, learning_rate=1e-2)
    images = torch.randn((64, 224, 224, 3), generator=gen, device=device)
    labels = torch.randint(cfg.num_classes, (64,), generator=gen, device=device)

    def run():
        step(params, images, labels)

    run()  # warm-up
    return {"step_ms": _event_ms(run, device), "profile": _profile(run, device)}


def main() -> int:
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = build_mesh("cuda", 1, 1)
        out = {"card": card, "llama_train_step": llama(mesh, device)}
        torch.cuda.empty_cache()
        out["resnet50_dp_step"] = resnet50(mesh, device)
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
