"""Run one cell of the benchmark once.

    python3 -m kubebench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's pods are placed by the port's extender and allocated by its
device plugin (``cluster.py``), started as child processes with the
Allocate env (``pod.py``), and driven through the window by the entry its
traffic names. Set-up runs from this process's start to the window's
start. After the window, with the pods gone, the plain reference judges
what the timed path produced (``checks/<entry>.py``), and each metric's
reader (``metrics/<name>.py``) takes its number: the end-to-end metrics
with ``--trace 0``, the per-layer ones with ``--trace 1``. The numbers
compared print, each beside its limit, as the last lines on stderr; the
result prints as one JSON line, the last on stdout.

Exits non-zero with no result where CUDA is missing or has fewer cards
than the cell asks for, where a pod fails, or where this process or a pod
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field, replace  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from kubebench import kinds, timeline  # noqa: E402
from kubebench.cluster import CACHE_ENV, Cluster, PodProcess  # noqa: E402
from kubebench.manifest import Cell, load_cell, load_part  # noqa: E402

READY_TIMEOUT_S = 900.0
REPORT_GRACE_S = 300.0


@dataclass(frozen=True)
class Rehearsal:
    """A run on the CPU, for the tests: the sim node agent, no guard, the
    pods on the CPU, and sizes shrunk by the overrides. Not reachable from
    the command line."""

    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    pod_env: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)

    def shrink(self, cell: Cell) -> Cell:
        limits = {k: {**v, "limit": self.limits[k]} if k in self.limits else v
                  for k, v in cell.limits.items()}
        return replace(cell, config={**cell.config, **self.config},
                       traffic={**cell.traffic, **self.traffic}, limits=limits)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="kubebench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def err(msg: str) -> None:
    print(f"kubebench: {msg}", file=sys.stderr, flush=True)


def drive(cell: Cell, args, rehearsal, check_device) -> SimpleNamespace:
    """Place, start and drive the cell's pods; -> what they reported.
    ``check_device()`` runs while the pods load; it raises RuntimeError
    where the machine cannot run the cell."""
    from tpukube_torch.device.gpu import ENV_MEM_FRACTION
    from tpukube_torch.native import cudaguard

    with Cluster(cell.traffic, sim=rehearsal is not None) as cluster:
        placed, place_ms = cluster.place(cell.name)
        err(f"placed at +{time.monotonic() - T_START:.2f} s")
        pods = []
        try:
            for i, (env, _) in enumerate(placed):
                spec = {"pod": i, "pods": len(placed), "seed": args.seed, "t_run": T_START,
                        "device": "cpu" if rehearsal else "cuda", "trace": bool(args.trace),
                        "config": cell.config, "traffic": cell.traffic}
                shared = ENV_MEM_FRACTION in env and rehearsal is None
                pods.append(PodProcess(spec, env, cudaguard.library_path() if shared else None,
                                       rehearsal.pod_env if rehearsal else {}))
            check_device()
            deadline = time.monotonic() + READY_TIMEOUT_S
            ready = [p.wait_for("ready", deadline) for p in pods]
            t0 = time.monotonic()
            t1 = t0 + args.seconds
            slice_s = cell.traffic["trace_slice_s"]
            tf = t0 + max(args.seconds - slice_s, 0.0) / 2 if args.trace else float("inf")
            for p in pods:
                p.go(t0, t1, tf, tf + slice_s)
            deadline = t1 + REPORT_GRACE_S
            reports = [p.wait_for("report", deadline) for p in pods]
            err(f"reports in at +{time.monotonic() - T_START:.2f} s")
            for p in pods:
                if p.stop() != 0:
                    raise RuntimeError(f"pod {p.index} exited {p.proc.returncode}")
        finally:
            for p in pods:
                p.stop(timeout=5.0)
    return SimpleNamespace(place_ms=place_ms, ready=ready, reports=reports,
                           gpus=[uuid for _, uuid in placed], envs=[e for e, _ in placed],
                           setup_s=t0 - T_START, window=(t0, t1))


def merge_traces(reports: list) -> SimpleNamespace | None:
    """The pods' profiled slices as one: the device busy while any pod's
    kernel ran, over the time all of them were profiled; device seconds
    by kernel and by kind; idle time by what the hosts were doing."""
    traces = [r["trace"] for r in reports]
    if any(t is None for t in traces):
        return None
    s0 = max(t["slice"][0] for t in traces)
    s1 = min(t["slice"][1] for t in traces)
    if s1 <= s0:
        return None
    busy = timeline.merge([(max(a, s0), min(b, s1)) for t in traces for a, b in t["busy"]
                         if min(b, s1) > max(a, s0)])
    by_name: dict = {}
    dense_by_op: dict = {}
    for t in traces:
        for name, s in t["by_name"].items():
            by_name[name] = by_name.get(name, 0.0) + s
        for op, s in t["dense_by_op"].items():
            dense_by_op[op] = dense_by_op.get(op, 0.0) + s
    by_kind: dict = {}
    for name, s in by_name.items():
        by_kind[kinds.kind(name)] = by_kind.get(kinds.kind(name), 0.0) + s
    idle: dict = {}
    for a, b in timeline.gaps(busy, s0, s1):
        label = " + ".join(f"pod{k}: {g[2]}" for k, t in enumerate(traces)
                           for g in t["gaps"] if g[0] <= a and b <= g[1])
        label = label or "(unlabelled: past the gaps each pod kept)"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    dense = sorted({n[:120] for n in by_name if kinds.kind(n) in kinds.DENSE})
    return SimpleNamespace(
        busy_s=sum(b - a for a, b in busy) / 1e9, window_s=(s1 - s0) / 1e9, dense_names=dense,
        by_kind=by_kind, dense_by_op=dense_by_op, units=[(k, u) for k, t in enumerate(traces) for u in t["units"]],
        breakdown={"device_ops": sorted(([n[:160], s] for n, s in by_name.items()),
                                        key=lambda x: -x[1])[:10],
                   "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                       key=lambda x: -x[1])[:10]})


def readings(cell: Cell, args, ran, device) -> dict:
    """Every number compared, with its limit: the entry's against the
    reference, and the placement's own."""
    reports = ran.reports
    off = 0
    if device.type == "cuda":
        off = sum(not r["uuid"] == r["nvml_uuid"] == want for r, want in zip(ran.ready, ran.gpus))
    values = {"failed": sum(r["failed"] for r in reports), "pods_off_their_gpu": off}
    shares = [(r, int(e["TPU_HBM_LIMIT_BYTES"])) for r, e in zip(reports, ran.envs)
              if "TPU_KUBE_MEM_FRACTION" in e]
    if shares:
        values["quota_excess_bytes"] = max(
            0, *(max(r["peak_reserved"], r.get("guard_peak", 0)) - q for r, q in shares))
    values.update(load_part("checks", cell.traffic["entry"]).check(cell, args.seed, reports, device))
    return values


def context(cell: Cell, ran) -> SimpleNamespace:
    t0, t1 = ran.window
    reqs, steps = [], []
    for k, r in enumerate(ran.reports):
        for c, i, n, off, sent, done in r.get("completed", []):
            reqs.append(SimpleNamespace(pod=k, length=n, sent=sent, done=done))
        for a, b in r.get("steps", []):
            steps.append(SimpleNamespace(pod=k, start=a, end=b, samples=r["samples_per_step"]))
    # the unit each pod had in hand at the close: (size, start, end)
    straddles = [tuple(r["straddle"]) for r in ran.reports if r.get("straddle")]
    return SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic,
                           flops=cell.flops(), setup_s=ran.setup_s, window=(t0, t1),
                           window_s=t1 - t0, straddles=straddles,
                           inside=lambda a, b: max(0.0, min(b, t1) - max(a, t0)) / (b - a),
                           requests=reqs, steps=steps, place_ms=ran.place_ms,
                           trace=merge_traces(ran.reports), reports=ran.reports)


class NoDevice(RuntimeError):
    pass


def main(argv=None, rehearsal: Rehearsal | None = None) -> int:
    args = parse(argv)
    cell = load_cell(args.workload)
    if rehearsal is not None:
        cell = rehearsal.shrink(cell)
    os.environ.update(CACHE_ENV)
    found = {}

    def check_device() -> None:
        # torch loads here, while the pods load theirs
        import torch

        if rehearsal is not None:
            found.update(device=torch.device("cpu"), kind="cpu")
            return
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            raise NoDevice(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}")
        found.update(device=torch.device("cuda", 0), kind=torch.cuda.get_device_name(0))

    try:
        ran = drive(cell, args, rehearsal, check_device)
    except NoDevice as e:
        err(str(e))
        return 2
    except (RuntimeError, OSError) as e:
        err(f"{type(e).__name__}: {e}")
        return 1
    device, kind = found["device"], found["kind"]
    if rehearsal is None:
        err(f"card: {card()}")
    # the pods have exited: the peak is read, the program's state is freed;
    # a card's peak is its pods' peaks together
    per_card: dict = {}
    for r, gpu in zip(ran.reports, ran.gpus):
        per_card[gpu] = per_card.get(gpu, 0) + r["peak_reserved"]
    peak = max(per_card.values())
    t = time.monotonic()
    values = readings(cell, args, ran, device)
    err(f"reference check took {time.monotonic() - t:.3f} s")
    limits = {k: v["limit"] for k, v in cell.limits.items() if not k.startswith("_")}
    if set(limits) - set(values):
        err(f"no reading for the limits {sorted(set(limits) - set(values))}")
        return 1
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    ctx = context(cell, ran)
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = cell.reader(m.name).read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    bad = sorted(set(timeline.banned_modules()).union(*(r["banned_modules"] for r in ran.reports)))
    if bad:
        err(f"JAX or the JAX package was loaded: {bad}")
        return 3
    dev = {"platform": "gpu" if rehearsal is None else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct,
           "attempted": sum(r["attempted"] for r in ran.reports),
           "failed": sum(r["failed"] for r in ran.reports),
           "metrics": metrics, "device": dev}
    if args.trace and ctx.trace is not None:
        dev.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        out["breakdown"] = ctx.trace.breakdown
        err(f"device s by kind: {json.dumps(ctx.trace.by_kind)}")
        err(f"dense kernels: {json.dumps(ctx.trace.dense_names)}")
        err(f"dense kernel s by launching operation: {json.dumps(ctx.trace.dense_by_op)}")
    out["checks"] = checks
    err(f"result at +{time.monotonic() - T_START:.2f} s")
    detail = {k: v for k, v in values.items() if k not in limits}
    if detail:
        err(f"detail: {json.dumps(detail)}")
    for k, c in checks.items():
        err(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
