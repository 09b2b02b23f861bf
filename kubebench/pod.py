"""One pod of a cell: a child process started with the env that the port's
device plugin answered Allocate with.

    python -m kubebench.pod '<spec as JSON>'

It checks that its CUDA device is the GPU the Allocate named (by NVML
UUID), hands the run to the traffic's entry (``entries/<entry>.py``,
found by name), which makes the model and inputs from the seed and warms
up every shape of the mix, and then speaks a line protocol with the
benchmark on stdin/stdout:

- pod -> ``{"ready": {...}}`` once set up;
- benchmark -> ``go <t_start> <t_end> <trace_from> <trace_to>`` (host
  monotonic seconds, common to the pods of a cell);
- pod -> ``{"report": {...}}`` after the window, then exit.

Logs go to stderr. With ``"trace": true`` the pod profiles the units
(requests or steps) that start between ``trace_from`` and ``trace_to``,
keeps the profile in memory and reports only a summary.
"""

from __future__ import annotations

import time

T_POD = time.monotonic()

import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

import torch  # noqa: E402

from kubebench.kinds import DENSE, UNLINKED, kind  # noqa: E402
from kubebench.manifest import load_part  # noqa: E402
from kubebench.timeline import banned_modules, gaps, merge  # noqa: E402

GAPS_KEPT = 3000


def _activities(device: torch.device) -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


class Tracer:
    """Profiles whole units between ``trace_from`` and ``trace_to``."""

    def __init__(self, on: bool):
        self.on = on
        self.start_at = self.stop_at = float("inf")
        self._prof = None
        self._span = None
        self.done = False
        self.units: list = []

    def warm(self, device: torch.device) -> None:
        """Initialise the profiler (CUPTI) in set-up, not in the window."""
        if not self.on:
            return
        from torch.profiler import profile

        with profile(activities=_activities(device)):
            torch.ones(8, device=device).sum().item()

    def begin_unit(self, now: float, device: torch.device) -> bool:
        """Called before each unit, after the last one ended; -> whether
        this unit is profiled."""
        if not self.on or self.done:
            return False
        from torch.profiler import profile, record_function

        if self._prof is None and now >= self.start_at:
            self._prof = profile(activities=_activities(device))
            self._prof.start()
        elif self._prof is not None and now >= self.stop_at:
            self.close()
        if self._prof is None or self.done:
            return False
        self._end_span()
        # each unit a span, so the slice's ends are on the profiler's clock
        self._span = record_function("kubebench.unit")
        self._span.__enter__()
        return True

    def _end_span(self) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None

    def close(self) -> None:
        if self._prof is not None and not self.done:
            self._end_span()
            self._prof.stop()
            self.done = True

    def summary(self) -> dict | None:
        """Kernel intervals merged (realtime ns), device seconds by kernel
        name, the dense kernels' seconds by the operation that launched
        them, and the idle gaps of this pod's kernel stream, each
        labelled with the innermost host operation at its start."""
        if self._prof is None:
            return None
        self.close()
        from torch.autograd import DeviceType

        kern, host, units, ops = [], [], [], {}
        for e in self._prof.profiler.kineto_results.events():
            a, b, name = e.start_ns(), e.end_ns(), e.name()
            if e.is_user_annotation() or name == "kubebench.unit":
                # a span, on the host and mirrored on the device: no kernel
                if e.device_type() == DeviceType.CPU and name == "kubebench.unit":
                    units.append((a, b))
            elif e.device_type() == DeviceType.CUDA:
                kern.append((a, b, name, e.linked_correlation_id()))
            elif e.device_type() == DeviceType.CPU:
                host.append((a, b, name))
                if e.linked_correlation_id() == 0:
                    # what a kernel names as its launcher: as a rule an
                    # operation, else an event inside one ("Command Buffer
                    # Full", a launch that waited for the queue)
                    ops[e.correlation_id()] = (name, a, b, e.start_thread_id())
        if not units:
            return None
        s0, s1 = min(a for a, _ in units), max(b for _, b in units)
        kern = [(max(a, s0), min(b, s1), n, c) for a, b, n, c in kern if min(b, s1) > max(a, s0)]
        by_name: dict = defaultdict(float)
        dense_by_op: dict = defaultdict(float)
        launcher = _Launchers(ops)
        for a, b, name, corr in kern:
            by_name[name] += (b - a) / 1e9
            if kind(name) in DENSE:
                dense_by_op[launcher(corr)] += (b - a) / 1e9
        busy = merge([(a, b) for a, b, _, _ in kern])
        host.sort()
        starts = [h[0] for h in host]
        kept = sorted(gaps(busy, s0, s1), key=lambda g: g[0] - g[1])[:GAPS_KEPT]
        labelled = [[a, b, _innermost(host, starts, a)] for a, b in sorted(kept)]
        return {"slice": [s0, s1], "busy": busy, "by_name": dict(by_name),
                "dense_by_op": dict(dense_by_op), "gaps": labelled, "units": self.units}


class _Launchers:
    """The operation (a name with ``::``, as ``aten::mm``) that launched a
    kernel, from the kernel's link to a host event: that event, or else
    the innermost operation around the event's start on its thread."""

    def __init__(self, ops: dict):
        self._ops = ops
        self._threads: dict = defaultdict(list)
        for name, a, b, tid in ops.values():
            if "::" in name:
                self._threads[tid].append((a, b, name))
        for spans in self._threads.values():
            spans.sort()
        self._starts = {tid: [x[0] for x in spans] for tid, spans in self._threads.items()}

    def __call__(self, corr: int) -> str:
        if corr not in self._ops:
            return UNLINKED
        name, t, _, tid = self._ops[corr]
        if "::" in name:
            return name
        spans = self._threads.get(tid, [])
        i = bisect.bisect_right(self._starts.get(tid, []), t) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if spans[j][1] > t:
                return spans[j][2]
        return UNLINKED


def _innermost(host: list, starts: list, t: int) -> str:
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 5000, -1), -1):
        if host[j][1] > t:
            return host[j][2]
    return "(python, between operations)"


class Pod:
    """What an entry sees of its pod."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.seed = spec["seed"]
        self.index = spec["pod"]
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.tracer = Tracer(bool(spec["trace"]))
        self.mark("imports")
        self.device, self.info = self._device()
        self.mark("device checked")

    def mark(self, phase: str) -> None:
        """Log a set-up phase's end, in seconds since the pod's and the
        run's start (both host monotonic)."""
        now = time.monotonic()
        print(f"pod {self.index}: {phase} at +{now - T_POD:.2f} s "
              f"(run +{now - self.spec['t_run']:.2f} s)", file=sys.stderr, flush=True)

    def _device(self) -> tuple:
        if self.spec["device"] == "cpu":
            return torch.device("cpu"), {"uuid": None}
        from tpukube_torch.native.gpuinfo import GpuInfo
        from tpukube_torch.workload.meshenv import PodGpuEnv, device_from_alloc_env

        # f32 products in full f32 and bf16 products reduced in f32, as the
        # port's own pods run (tpukube_torch/graft.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cudnn.allow_tf32 = False
        pe = PodGpuEnv.from_env()
        device = device_from_alloc_env()
        with GpuInfo("real", "probe=off\n") as gi:
            nvml = gi.chips()[pe.visible_chips[0]].chip_id
        # the benchmark holds both against the node agent's GPU
        info = {"uuid": "GPU-" + str(torch.cuda.get_device_properties(device).uuid),
                "nvml_uuid": nvml, "device_ids": list(pe.device_ids),
                "hbm_limit_bytes": pe.hbm_limit_bytes, "mem_fraction": pe.mem_fraction}
        if "cudaguard" in os.environ.get("LD_PRELOAD", ""):
            from tpukube_torch.native.cudaguard import Guard

            self.guard = Guard()
            if self.guard.limit() != pe.hbm_limit_bytes:
                raise RuntimeError(f"guard limit {self.guard.limit()}, the share's "
                                   f"{pe.hbm_limit_bytes}")
        return device, info

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ready(self, info: dict) -> tuple:
        """Announce set-up done; wait for the window. -> (t_start, t_end)."""
        self.tracer.warm(self.device)
        self.sync()
        self.mark("ready")
        print(json.dumps({"ready": {**self.info, **info}}), flush=True)
        words = sys.stdin.readline().split()
        if not words or words[0] != "go":
            raise RuntimeError(f"expected 'go', got {words!r}")
        t0, t1, tf, tt = map(float, words[1:5])
        self.tracer.start_at, self.tracer.stop_at = tf, tt
        return t0, t1

    def memory(self) -> dict:
        if self.device.type != "cuda":
            return {"peak_reserved": 0, "peak_allocated": 0}
        out = {"peak_reserved": torch.cuda.max_memory_reserved(self.device),
               "peak_allocated": torch.cuda.max_memory_allocated(self.device)}
        if hasattr(self, "guard"):
            out.update(guard_peak=self.guard.peak(), guard_refused=self.guard.refused())
        return out


def main(argv: list) -> int:
    spec = json.loads(argv[0])
    pod = Pod(spec)
    report = load_part("entries", spec["traffic"]["entry"]).run(pod)
    report.update(pod.memory())
    report["trace"] = pod.tracer.summary()
    report["banned_modules"] = banned_modules()
    print(json.dumps({"report": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
