"""The cluster side of a run: the port's node agent, device plugin and
scheduler extender, placing a cell's pods as kube-scheduler and the
kubelet would, and the pods themselves as child processes.

- node agent: ``GpuDeviceManager`` on the real backend (NVML through the
  ``native/gpuinfo`` shim), with the mix's shares per GPU;
- device plugin: ``DevicePluginServer`` registered with the in-process
  kubelet peer (the v1beta1 bytes, without sockets);
- extender: ``sched/extender.py`` over HTTP on 127.0.0.1 at a free port;
  each pod goes ``/filter`` -> ``/prioritize`` -> ``/bind``, its bound ids
  go into the plugin's intents, and the kubelet's Allocate of them gives
  the pod's env;
- a pod on a share is started under the quota guard (``LD_PRELOAD`` of
  ``native/cudaguard``), as the share's env asks.
"""

from __future__ import annotations

import json
import os
import queue
import subprocess
import sys
import threading
import time

from kubebench.manifest import PKG, ROOT

CACHE = os.path.join(PKG, ".cache")
# fixed build and kernel caches inside the checkout, so only a cell's
# first run in a checkout builds
CACHE_ENV = {"TORCH_EXTENSIONS_DIR": os.path.join(CACHE, "torch_extensions"),
             "TRITON_CACHE_DIR": os.path.join(CACHE, "triton")}
SIM_NODE = {"TPUKUBE_BACKEND": "sim", "TPUKUBE_SIM_MESH_DIMS": "1,1,1",
            "TPUKUBE_SIM_HOST_BLOCK": "1,1,1", "TPUKUBE_SIM_HOST_ORIGIN": "0,0,0"}


class Cluster:
    """Node agent and plugin for the length of a ``with`` block."""

    def __init__(self, traffic: dict, sim: bool = False):
        from tpukube_torch.core.config import load_config
        from tpukube_torch.device import GpuDeviceManager
        from tpukube_torch.plugin import DevicePluginServer, InProcessKubelet

        env = dict(SIM_NODE) if sim else {"TPUKUBE_BACKEND": "real"}
        shares = traffic["node"]["shares_per_chip"]
        if shares > 1:
            env["TPUKUBE_SHARES_PER_CHIP"] = str(shares)
        cfg = load_config(env=env)
        self.mgr = GpuDeviceManager(cfg, host="kubebench-node")
        self.kubelet = InProcessKubelet()
        self.server = DevicePluginServer(cfg, self.mgr)
        self.kubelet.register_plugin(self.server)
        self.kubelet.wait_for_devices(self.server.resource_name, len(self.mgr.device_list()))
        self.traffic = traffic

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.kubelet.stop()
        self.mgr.close()

    def place(self, cell: str) -> tuple[list, float]:
        """Place the mix's pods through the extender and allocate each.
        -> ([(allocate env, the GPU's NVML UUID)], ms from the first
        /filter to the last Allocate answer)."""
        from tpukube_torch.core import codec
        from tpukube_torch.core.config import load_config
        from tpukube_torch.sched import client
        from tpukube_torch.sched.extender import Extender, serve
        from tpukube_torch.sched.kube import pod_object

        notes = codec.annotate_node(self.mgr.node_info(), self.mgr.mesh)
        node = {"metadata": {"name": self.mgr.host, "annotations": notes}}
        chips = {c.index: c.chip_id for c in self.mgr.chips()}
        server = serve(Extender(load_config(env={})), "127.0.0.1", 0)
        out = []
        try:
            port = server.server_address[1]
            t0 = time.perf_counter()
            for i, want in enumerate(self.traffic["pods"]):
                pod = pod_object(f"{cell}-{i}", tpu=want.get("tpu", 0), vtpu=want.get("vtpu", 0))
                _, alloc, _ = client.place(port, pod, [node])
                self.server.intents.put(alloc.pod_key, alloc.device_ids)
                env = {**alloc.env,
                       **self.kubelet.allocate(self.server.resource_name, alloc.device_ids)}
                out.append((env, chips[int(env["CUDA_VISIBLE_DEVICES"].split(",")[0])]))
            place_ms = (time.perf_counter() - t0) * 1e3
        finally:
            server.shutdown()
            server.server_close()
        return out, place_ms


def _pump(stream, q: queue.Queue) -> None:
    for line in stream:
        q.put(line)
    q.put(None)


class PodProcess:
    """``python -m kubebench.pod <spec>`` with an Allocate env."""

    def __init__(self, spec: dict, env: dict, guard: str | None, extra_env: dict):
        pythonpath = os.pathsep.join(p for p in (extra_env.get("PYTHONPATH"), ROOT,
                                                 os.environ.get("PYTHONPATH")) if p)
        full = {**os.environ, **env, **CACHE_ENV, **extra_env, "PYTHONPATH": pythonpath}
        if guard:
            full["LD_PRELOAD"] = guard
        self.index = spec["pod"]
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "kubebench.pod", json.dumps(spec)], cwd=ROOT, env=full,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=_pump, args=(self.proc.stdout, self._lines), daemon=True).start()

    def wait_for(self, key: str, deadline: float) -> dict:
        """The pod's next ``{key: ...}`` line; RuntimeError when it exits
        or the deadline passes first."""
        while True:
            try:
                line = self._lines.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise RuntimeError(f"pod {self.index}: no {key!r} before the deadline") from None
            if line is None:
                raise RuntimeError(f"pod {self.index} exited {self.proc.wait()} before {key!r}")
            if line.startswith("{"):
                doc = json.loads(line)
                if key in doc:
                    return doc[key]
            print(f"pod {self.index}: {line.rstrip()}", file=sys.stderr, flush=True)

    def go(self, *times: float) -> None:
        self.proc.stdin.write("go " + " ".join(repr(t) for t in times) + "\n")
        self.proc.stdin.flush()
        self.proc.stdin.close()

    def stop(self, timeout: float = 60.0) -> int:
        if self.proc.poll() is None:
            try:
                return self.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        return self.proc.wait()
