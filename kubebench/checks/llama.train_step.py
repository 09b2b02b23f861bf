"""``correct`` for ``llama.train_step``: the reference follows the set-up
steps from the same weights and batches (clip + AdamW, float32); the
pod's losses, first gradients and changes are held against its."""

import sys
import time

import torch

from kubebench import compare, weights
from kubebench.reference import decoder as ref


def reference(cell, seed: int, device: torch.device, precision: str = "fp32",
              rows=None) -> dict:
    ref.precise()
    cfg, t = cell.config, cell.traffic
    clock = Clock(device)
    params = weights.decoder_params(cfg, seed, device)
    batches = weights.train_batches(seed, t["pool"], t["batch"], t["seq"],
                                    cfg["vocab_size"], device)[:t["check_steps"]]
    if rows is not None:
        batches = batches[:, :rows]
    clock.lap("weights and batches")
    out = ref.train_steps(params, batches, cfg, t["optimizer"], t["check_steps"],
                          t["check_rows_per_block"], precision)
    clock.lap(f"{t['check_steps']} reference steps")
    with torch.no_grad():
        out["change"] = {k: float(torch.linalg.vector_norm(
            p - weights.initial_leaf("decoder", cfg, seed, k, device)))
            for k, p in weights.named(params).items()}
    clock.lap("changes")
    return out


class Clock:
    """Logs each phase's seconds on stderr, the device's work included."""

    def __init__(self, device: torch.device):
        self.device, self.t = device, time.monotonic()

    def lap(self, phase: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.monotonic()
        peak = torch.cuda.max_memory_reserved(self.device) if self.device.type == "cuda" else 0
        print(f"kubebench: reference {phase}: {now - self.t:.3f} s (peak reserved {peak} B)",
              file=sys.stderr, flush=True)
        self.t = now


def check(cell, seed: int, reports: list, device: torch.device) -> dict:
    return compare.train_readings(reports[0], reference(cell, seed, device))
