"""Entry ``llama.train_step``: a gang member training the decoder with
``tpukube_torch.workload.train.make_train_step`` (clip by global norm +
AdamW, each block recomputed in the backward pass) over the world-1 mesh
of its Allocate env, on a pool of batches made in set-up and cycled.

Set-up drives the step through its first steps on the pool's first
batches (every row differs); they warm up every shape, and their
readings go to the benchmark, which follows the same steps with the
reference: each step's loss, each leaf's first gradient as the optimizer
took it (from AdamW's first moment after one step: m = (1 - b1) g), and
each leaf's change after the set-up steps. The window then times the
same step object on the following batches.
"""

import time

import torch

from kubebench import weights
from kubebench.manifest import load_part
from tpukube_torch.workload import train


def run(pod) -> dict:
    t, dev = pod.traffic, pod.device
    cfg = load_part("entries", "llama.forward").port_config(pod.config)
    o = t["optimizer"]
    opt = train.AdamW(lr=o["lr"], max_norm=o["max_norm"], b1=o["b1"], b2=o["b2"],
                      eps=o["eps"], weight_decay=o["weight_decay"])
    with load_part("entries", "_mesh").world_one(pod) as mesh:
        params = weights.decoder_params(pod.config, pod.seed, dev)
        for leaf in weights.named(params).values():
            leaf.requires_grad_(True)
        step, opt_init = train.make_train_step(cfg, mesh, opt, remat=t["remat"])
        state = opt_init(params)
        batches = weights.train_batches(pod.seed, t["pool"], t["batch"], t["seq"], cfg.vocab, dev)
        pod.mark("mesh, weights, optimizer state, batches")
        losses, first = [], {}
        for i in range(t["setup_steps"]):
            params, state, loss = step(params, state, batches[i])
            losses.append(float(loss))
            if i == 0:
                first = {k: float(torch.linalg.vector_norm(m)) / (1 - o["b1"])
                         for k, m in weights.named(state["mu"]).items()}
            if i + 1 == t["check_steps"]:
                with torch.no_grad():
                    change = {k: float(torch.linalg.vector_norm(
                        p - weights.initial_leaf("decoder", pod.config, pod.seed, k, dev)))
                        for k, p in weights.named(params).items()}
        pod.mark("set-up steps")
        pod.sync()
        return window(pod, lambda i: step(params, state, batches[i % t["pool"]])[2],
                      {"losses": losses, "first_grad": first, "change": change})


def window(pod, step, readings: dict) -> dict:
    """Time steps back to back until the window closes; a step whose loss
    is not finite counts as failed."""
    t = pod.traffic
    t0, t1 = pod.ready({})
    steps, failed, i, straddle = [], 0, t["setup_steps"], None
    while True:
        start = time.monotonic()
        if start >= t1:
            break
        traced = pod.tracer.begin_unit(start, pod.device)
        loss = step(i)
        ok = bool(torch.isfinite(loss))  # waits for the step
        end = time.monotonic()
        i += 1
        if end > t1:  # ran across the window's close
            straddle = [t["batch"], start, end]
            break
        if not ok:
            failed += 1
            continue
        steps.append([start, end])
        if traced:
            pod.tracer.units.append({"samples": t["batch"]})
    pod.tracer.close()
    return {"steps": steps, "attempted": len(steps) + failed, "failed": failed,
            "straddle": straddle,
            "samples_per_step": t["batch"], **readings}
