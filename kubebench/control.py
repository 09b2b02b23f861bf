"""The readings that set each limit's upper end, on the card at a cell's
own sizes: the reference, computed in the precision below the one the
configuration states (float8 for bfloat16), put in the program's place;
and, for the training cells, a fault planted in the reference (half of
each batch left out, the mean taken over the rest).

    python3 -m kubebench.control --workload <name> --seeds <a,b,c> [--fault half_batch]

Prints one JSON line a seed with the numbers that decide ``correct``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from kubebench import compare, traffic as gen
from kubebench.manifest import load_cell, load_part


def prompt_lengths(cell, seed: int) -> list:
    """As many prompts as a run's sample holds: each pod's longest (the
    mix's longest) and the rest drawn from the mix."""
    t = cell.traffic
    mix = gen.lengths(t["prompt_tokens"])
    rng = np.random.default_rng(gen.subseed(seed, 4))
    out = []
    for _ in t["pods"]:
        out += [max(mix)] + [int(x) for x in rng.choice(mix, t["check_requests_per_pod"] - 1)]
    return out


def reading(cell, seed: int, device: torch.device, fault: str | None) -> dict:
    checks = load_part("checks", cell.traffic["entry"])
    if "prompt_tokens" in cell.traffic:
        if fault is not None:
            raise ValueError("the prefill cells' faults are planted in the program (tests)")
        return checks.control(cell, seed, prompt_lengths(cell, seed), device, "fp8")
    if fault == "half_batch":
        prog = checks.reference(cell, seed, device, rows=cell.traffic["batch"] // 2)
    elif fault is None:
        prog = checks.reference(cell, seed, device, precision="fp8")
    else:
        raise ValueError(f"unknown fault {fault!r}")
    torch.cuda.empty_cache()
    return compare.train_readings(prog, checks.reference(cell, seed, device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kubebench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", choices=("half_batch",))
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(a.workload)
    device = torch.device("cuda", 0)
    for seed in map(int, a.seeds.split(",")):
        t = time.monotonic()
        out = reading(cell, seed, device, a.fault)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": a.workload, "seed": seed, "fault": a.fault or "fp8",
                          "readings": out, "seconds": time.monotonic() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
