#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpukube_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path the way a cluster does, on the card:

1. prints the card's name and power limit (nvidia-smi);
2. node agent: GpuDeviceManager on the real backend builds the NVML
   discovery shim (g++) and finds the card through NVML; its SM count,
   memory, health and probe are held against what CUDA reports;
3. Allocate: allocate_env(["tpu-0"]) mints the container env;
4. pod: ``python -m tpukube_torch.graft`` runs as a child process with that
   env, checks it got the allocated GPU (UUID), builds Llama-3-8B at full
   width and depth from a seed, serves 3 forward requests (B=2, S=2048),
   and checks shape, finiteness, loss, causality and card-vs-CPU parity;
5. training pod: ``python -m tpukube_torch.graft --train``, a child in the
   same env after the serving pod exits: a world-1 NCCL group, the
   ``DeviceMesh(("dp", "tp"))`` of the env, Llama-3-8B at full width and
   depth 4, 1 warm-up and 3 timed AdamW steps on one batch (B=2, S=2048);
   the loss must be finite, start near ln(vocab) and fall, and the loss and
   gradients of layers 0-1 (full embed and unembed, S=64) must agree with
   the CPU;
6. ResNet pod: ``python -m tpukube_torch.graft --resnet``: ResNet-50 (224x224,
   1000 classes) data-parallel over NCCL, batch 64, SGD lr 1e-2, 1 warm-up
   and 3 timed steps; the loss must fall, and one step at batch 2 on 64x64
   images must agree with the CPU;
7. ``python -m tpukube_torch.graft --dryrun``: ``dryrun_multichip`` over
   every visible GPU, NCCL;
8. prints the kernels line: the JAX package has no Pallas kernel, so the
   port has none to hold against a plain version.

The last line is ``{"ok": true, "device": {...}}``. Any failed step (an
NCCL init, a child's exit, a check) exits non-zero and prints no result;
without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
POD_TIMEOUT_S = 900
H100_BF16_FLOPS = 989e12  # NVIDIA data sheet, SXM, dense, at 700 W


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def run_pod(flags: list, env: dict, key: str):
    """``python -m tpukube_torch.graft *flags`` as a child with the Allocate
    env; its stdout lines are echoed, the last one is its JSON report.
    Returns ``report[key]``, or None when the child failed."""
    pythonpath = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p
    )
    proc = subprocess.run(
        [sys.executable, "-m", "tpukube_torch.graft", *flags],
        cwd=ROOT, env={**os.environ, **env, "PYTHONPATH": pythonpath},
        stdout=subprocess.PIPE, text=True, timeout=POD_TIMEOUT_S,
    )
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0 or not lines:
        print(proc.stdout, flush=True)
        fail(f"pod {' '.join(flags) or '(serve)'} exited {proc.returncode}")
        return None
    return json.loads(lines[-1])[key]


def main() -> int:
    t_start = time.monotonic()
    # CUDA's device order must be NVML's (PCI bus order) for the checks of
    # step 2 to compare the same card; set before CUDA initializes
    os.environ["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")

    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.types import Health
    from tpukube_torch.device import GpuDeviceManager

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # -- node agent -------------------------------------------------------
    props = torch.cuda.get_device_properties(0)
    with GpuDeviceManager(load_config(env={"TPUKUBE_BACKEND": "real"})) as mgr:
        if mgr.inventory_source() != "nvml":
            return fail(f"inventory source {mgr.inventory_source()!r}")
        chips = mgr.chips()
        if len(chips) != torch.cuda.device_count():
            return fail(f"NVML {len(chips)} GPUs, CUDA {torch.cuda.device_count()}")
        c0 = chips[0]
        if c0.num_cores != props.multi_processor_count:
            return fail(f"SMs: NVML table {c0.num_cores}, CUDA "
                        f"{props.multi_processor_count}")
        if abs(c0.hbm_bytes - props.total_memory) > 0.02 * props.total_memory:
            return fail(f"memory: NVML {c0.hbm_bytes}, CUDA {props.total_memory}")
        if c0.health is not Health.HEALTHY or not mgr.probe():
            return fail("GPU 0 is not healthy")
        print(f"node agent: {len(chips)} GPU(s) via {mgr.inventory_source()}; "
              f"tpu-0 = {c0.chip_id}, {c0.num_cores} SMs, {c0.hbm_bytes} bytes",
              flush=True)
        # -- Allocate -----------------------------------------------------
        env = mgr.allocate_env(["tpu-0"])
    print("allocate env: " + json.dumps(env, sort_keys=True), flush=True)

    # -- pod ---------------------------------------------------------------
    pod = run_pod([], env, "pod")
    if pod is None:
        return 1
    if pod["uuid"] != c0.chip_id or pod["device"] != props.name:
        return fail(f"pod ran on {pod['device']} {pod['uuid']}, allocated {c0.chip_id}")
    print("pod: " + json.dumps(pod, sort_keys=True), flush=True)
    print(
        f"pod forward, Llama-3-8B ({pod['params']} params, f32 weights, bf16 "
        f"compute), B={pod['batch']} S={pod['seq']}: median "
        f"{pod['forward_ms_median']:.3f} ms, {pod['tokens_per_s']:.1f} tokens/s, "
        f"peak {pod['max_memory_allocated']} bytes allocated [{card}]",
        flush=True,
    )
    bound_ms = pod["forward_flops"] / H100_BF16_FLOPS * 1e3
    print(
        f"pod forward compute bound: {pod['forward_flops']} FLOP at the "
        f"H100 SXM data sheet's 989 TFLOP/s bf16 dense = {bound_ms:.3f} ms; "
        f"measured median is {bound_ms / pod['forward_ms_median']:.1%} of it "
        f"[{card}]",
        flush=True,
    )
    print(
        f"pod checks: loss {pod['loss']:.4f} (ln V {pod['ln_vocab']:.4f}); "
        f"card vs CPU, {pod['parity_layers']} layers at S={pod['parity_seq']}: "
        f"max abs err {pod['parity_max_abs_err']:.3g} <= atol "
        f"{pod['parity_atol']:.3g} + rtol 2e-2",
        flush=True,
    )

    # -- training pod --------------------------------------------------------
    tr = run_pod(["--train"], env, "train")
    if tr is None:
        return 1
    if tr["uuid"] != c0.chip_id:
        return fail(f"training pod ran on {tr['uuid']}, allocated {c0.chip_id}")
    print("train: " + json.dumps(tr, sort_keys=True), flush=True)
    step_flops = 3 * tr["forward_flops"]  # forward + backward, no remat
    print(
        f"train step, Llama-3-8B width, {tr['n_layers']} layers ({tr['params']} "
        f"params, f32 params and AdamW state, bf16 compute, per-block "
        f"checkpointing), B={tr['batch']} S={tr['seq']}, NCCL world 1: median "
        f"{tr['step_ms_median']:.3f} ms, {tr['tokens_per_s']:.1f} tokens/s, "
        f"peak {tr['max_memory_allocated']} bytes allocated; model FLOPs "
        f"3 x forward = {step_flops} = {step_flops / H100_BF16_FLOPS * 1e3:.3f} ms "
        f"at 989 TFLOP/s, measured median is "
        f"{step_flops / H100_BF16_FLOPS * 1e3 / tr['step_ms_median']:.1%} of it "
        f"[{card}]",
        flush=True,
    )
    print(
        f"train checks: losses {[round(x, 4) for x in tr['losses']]} (ln V "
        f"{tr['ln_vocab']:.4f}); card vs CPU, {tr['parity_layers']} layers at "
        f"S={tr['parity_seq']}: loss {tr['parity_loss']:.5f} vs "
        f"{tr['parity_ref_loss']:.5f}, worst grad leaf max abs err "
        f"{max(v[0] for v in tr['parity_grads'].values()):.3g} max|ref| "
        f"<= 2e-2 max|ref|",
        flush=True,
    )

    # -- ResNet DP pod -------------------------------------------------------
    rn = run_pod(["--resnet"], env, "resnet")
    if rn is None:
        return 1
    if rn["uuid"] != c0.chip_id:
        return fail(f"ResNet pod ran on {rn['uuid']}, allocated {c0.chip_id}")
    print("resnet: " + json.dumps(rn, sort_keys=True), flush=True)
    print(
        f"ResNet-50 DP step ({rn['params']} params, bf16 compute, f32 GroupNorm), "
        f"batch {rn['batch']} at {rn['image_size']}x{rn['image_size']}, NCCL "
        f"world 1: median {rn['step_ms_median']:.3f} ms, "
        f"{rn['images_per_s']:.1f} images/s, peak {rn['max_memory_allocated']} "
        f"bytes allocated [{card}]",
        flush=True,
    )
    print(
        f"resnet checks: losses {[round(x, 4) for x in rn['losses']]}; card vs "
        f"CPU, batch {rn['parity_batch']} at {rn['parity_size']}x"
        f"{rn['parity_size']}: loss {rn['parity_loss']:.5f} vs "
        f"{rn['parity_ref_loss']:.5f}, updated stem/head max abs err "
        f"{max(v[0] for v in rn['parity_params'].values()):.3g} max|ref| "
        f"<= 2e-2 max|ref|",
        flush=True,
    )

    # -- dryrun_multichip over the visible GPUs ---------------------------
    dry = run_pod(["--dryrun"], env, "dryrun")
    if dry is None:
        return 1
    print("dryrun: " + json.dumps(dry, sort_keys=True) + f" [{card}]", flush=True)
    print(f"chip_smoke: whole run {time.monotonic() - t_start:.1f} s [{card}]",
          flush=True)

    print(json.dumps({
        "kernels": [],
        "note": "no Pallas kernel in tpukube; native discovery shim: gpuinfo (nvml)",
    }), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
