#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpukube_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path the way a cluster does, on the card:

1. prints the card's name and power limit (nvidia-smi);
2. node agent: GpuDeviceManager on the real backend builds the NVML
   discovery shim (g++) and finds the card through NVML; its SM count,
   memory, health and probe are held against what CUDA reports. Its
   device plugin (``DevicePluginServer``) registers with the in-process
   kubelet peer, which moves the v1beta1 bytes of the port's codec
   without sockets (the machine has no grpcio): Register must carry
   ``v1beta1``, ``qiniu.com/tpu`` and GetPreferredAllocation, the first
   ListAndWatch must list exactly NVML's GPUs, each Healthy as the probe
   says, and one ``HealthWatcher`` poll over the XID probe must push no
   transition;
3. placement: the node agent annotates its node (``codec.annotate_node``);
   the port's scheduler extender serves its webhooks on 127.0.0.1 over
   HTTP, and a ``qiniu.com/tpu: 1`` pod goes through ``/filter`` ->
   ``/prioritize`` -> ``/bind`` as kube-scheduler sends them: it must bind
   ``tpu-0`` on this node, and a second such pod must be unschedulable
   while the first is bound. The bound ids go into the plugin's intents:
   GetPreferredAllocation must answer ``tpu-0`` from the intent, the
   kubelet's Allocate of them must return ``allocate_env``'s env and mark
   the intent satisfied, and an Allocate of ``tpu-99`` must be refused
   with INVALID_ARGUMENT; both round trips are timed (median of 100). The
   alloc's env merged with the AllocateResponse's is the env of every pod
   below (serving, train, ResNet, dryrun); every card pod's env comes
   from the plugin's Allocate;
4. pod: ``python -m tpukube_torch.graft`` runs as a child process with that
   env, checks it got the allocated GPU (UUID), builds Llama-3-8B at full
   width and depth from a seed, serves 3 forward requests (B=2, S=2048),
   and checks shape, finiteness, loss, causality and card-vs-CPU parity.
   Meanwhile a ``HealthSampler`` on the node agent samples NVML telemetry
   (one sample must show memory in use above the idle reading); then the
   plugin's ``/metrics`` page must count its Allocates, list every GPU
   Healthy and carry one telemetry series per GPU, and the ``plugin:``
   line prints the timings and readings;
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
8. vGPU (BASELINE config 3, two inference pods sharing one card under a
   hard memory quota): a second node agent with two shares per GPU, whose
   plugin must advertise exactly ``tpu-0-frac0of2`` and ``tpu-0-frac1of2``
   as ``qiniu.com/vtpu`` on ListAndWatch, prefer both for a pod of 2,
   answer each share's Allocate (half the memory, fraction 0.5000, half
   the SMs) and refuse a third with INVALID_ARGUMENT;
   two ``qiniu.com/vtpu: 1`` pods are placed through the extender (over
   HTTP, on the node the share agent annotates) and must bind
   ``tpu-0-frac0of2`` and ``tpu-0-frac1of2``, and a third must be
   unschedulable;
   g++ builds the quota guard (``libcudaguard.so``); the ``--quota`` pod,
   under it on share 0's env, shows it refusing at ⌊quota / 4 GiB⌋ blocks
   with the card physically free; then two ``--shared`` pods, one per
   share, each under the guard, serve Llama-3-8B (B=1, S=2048) at the same
   time, released together, while the node agent samples NVML telemetry
   and its XID watch;
9. config 4 on an HGX fleet (host work, no GPU): the port's ``SimCluster``
   over 4 hosts of 8 GPUs (``8,4,1`` / ``8,1,1``) with two 4-GPU background
   pods, then a 16-member gang of 1-GPU pods, which must commit on two
   whole hosts as one (8,2,1) box at utilization 0.75; then 16 hosts
   (``8,16,1``) and a 64-member gang, which must take 8 whole hosts,
   contiguous along y. Each gang's per-member schedule-cycle p50 and p99,
   its commit latency and the utilization are printed, as host CPU times;
10. the scheduled pod: member 0 of the 16-member gang, its env the
   extender's gang keys merged with the Allocate of the sim node's plugin
   (``SimCluster`` over the in-process transport), runs ``python -m tpukube_torch.graft --scheduled`` on the card,
   which holds the env against the bind and serves one Llama-3-8B request
   (B=2, S=2048) after the UUID check;
11. config 5 (BASELINE: burst inference pods, then a high-priority training
   gang that must preempt them):
   a. host work on an HGX fleet of 16 hosts (``8,16,1`` / ``8,1,1``): 80
      priority-0 burst pods, then a 64-member priority-100 gang, which must
      preempt and commit on 8 whole hosts, contiguous along y, its victims
      deleted from the pod store by the port's ``EvictionExecutor``; a
      refill with burst pods to utilization >= 0.95; a priority-0 gang of
      32 refused; the port's ``/metrics`` scraped over HTTP (utilization
      >= 95%, gang p50 in (0, 60) s, preemptions > 0);
   b. one real preemption on the card: the extender (over HTTP) binds a
      priority-0 burst pod to ``tpu-0``, which serves Llama-3-8B (B=1,
      S=2048, ``--requests 1000``) as a child; a priority-100 one-member
      gang pod is planned over it; its first bind must be refused while the
      burst process lives; the ``EvictionExecutor`` evicts the burst pod
      through a fake apiserver whose eviction SIGTERMs the child (the
      kubelet's part), and the pod object goes only once the process has
      exited; the gang's bind must then land ``tpu-0``, never while the
      victim lives, and its env (the plugin's Allocate, as the burst
      pod's) runs the ``--train`` pod (as step 5); NVML
      memory in use is read at idle, while the victim serves and at the
      bind;
12. ``dryrun_multichip(4, device="cpu")``: both legs over gloo ranks, leg 2
   on a DCN gang env the port's extender mints on a two-slice sim fleet;
13. prints the kernels line: the JAX package has no Pallas kernel, so the
   port has none to hold against a plain version.

The last line is ``{"ok": true, "device": {...}}``. Any failed step (an
NCCL init, a child's exit, a check) exits non-zero and prints no result,
and so does a run that imported ``grpc`` or ``google.protobuf``; without
CUDA it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
POD_TIMEOUT_S = 900
TELEMETRY_PERIOD_S = 0.25
BURST_REQUESTS = 1000  # ≈ 150 s at B=1: the burst pod serves until evicted
PREEMPT_TIMEOUT_S = 120
H100_BF16_FLOPS = 989e12  # NVIDIA data sheet, SXM, dense, at 700 W


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def pod_env(env: dict) -> dict:
    """The child's environment: this process's, the Allocate env over it."""
    pythonpath = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH", "")) if p
    )
    return {**os.environ, **env, "PYTHONPATH": pythonpath}


def run_pod(flags: list, env: dict, key: str):
    """``python -m tpukube_torch.graft *flags`` as a child with the Allocate
    env; its stdout lines are echoed, the last one is its JSON report.
    Returns ``report[key]``, or None when the child failed."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpukube_torch.graft", *flags],
        cwd=ROOT, env=pod_env(env),
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


@contextlib.contextmanager
def extender_server():
    """The port's scheduler extender, serving its webhooks on 127.0.0.1 at
    a free port (yielded) for the length of the block."""
    from tpukube_torch.core.config import load_config
    from tpukube_torch.sched.extender import Extender, serve

    server = serve(Extender(load_config(env={})), "127.0.0.1", 0)
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()


def node_object(mgr) -> dict:
    """The v1.Node kube-scheduler sends for the node agent's node: its
    name and the agent's topology annotations."""
    from tpukube_torch.core import codec

    return {"metadata": {"name": mgr.host,
                         "annotations": codec.annotate_node(mgr.node_info(), mgr.mesh)}}


def place_pods(node: dict, pods: list, want: list, refused: dict, card: str):
    """Place ``pods`` in order on ``node`` through the extender over HTTP
    (each bind must name ``want[i]``'s device ids on that node), then
    filter ``refused``, which must find no node. Returns the allocs, or
    None when a check failed."""
    from tpukube_torch.sched import client

    allocs = []
    with extender_server() as port:
        for pod, ids in zip(pods, want):
            name = pod["metadata"]["name"]
            try:
                host, alloc, ms = client.place(port, pod, [node])
            except RuntimeError as e:
                fail(f"pod {name} was not placed: {e}")
                return None
            if host != node["metadata"]["name"] or alloc.device_ids != ids:
                fail(f"pod {name} bound {alloc.device_ids} on {host}, want {ids}")
                return None
            print(f"placed {name} on {host} {alloc.device_ids} over HTTP: "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
                  + f" (host CPU round trips) [{card}]", flush=True)
            allocs.append(alloc)
        res = client.filter_nodes(port, refused, [node])
        if res["NodeNames"] or res.get("Error"):
            fail(f"pod {refused['metadata']['name']} was schedulable: {res}")
            return None
        print(f"pod {refused['metadata']['name']} unschedulable while the others "
              f"are bound: {json.dumps(res['FailedNodes'])}", flush=True)
    return allocs


@contextlib.contextmanager
def node_agent(env: dict):
    """The node agent on the card: a real-backend ``GpuDeviceManager``
    (``env`` over the config's defaults), its ``DevicePluginServer`` and
    ``HealthWatcher``, registered with the in-process kubelet peer (the
    GPU machine has no grpcio: the same v1beta1 bytes cross without
    sockets). Yields them, with the ms from Register to the kubelet's
    first ListAndWatch list, once that list holds every device."""
    from tpukube_torch.core.config import load_config
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.plugin import DevicePluginServer, HealthWatcher, InProcessKubelet

    cfg = load_config(env={"TPUKUBE_BACKEND": "real", **env})
    with GpuDeviceManager(cfg) as mgr, InProcessKubelet() as kubelet:
        server = DevicePluginServer(cfg, mgr)
        watcher = HealthWatcher(mgr, server, poll_seconds=3600.0)
        watcher.start()
        try:
            t = time.perf_counter()
            kubelet.register_plugin(server)
            kubelet.wait_for_devices(server.resource_name, len(mgr.device_list()))
            yield types.SimpleNamespace(
                mgr=mgr, kubelet=kubelet, server=server, watcher=watcher,
                register_ms=(time.perf_counter() - t) * 1e3)
        finally:
            watcher.stop()


def allocate(agent, alloc) -> dict:
    """A bound pod's container env, as the kubelet hands it over: the
    extender's bind puts its ids into the plugin's intents (the intent
    watcher's part on a real node), the kubelet's Allocate of those ids
    answers with the plugin's env, and the alloc's own keys (a gang's)
    lie under it."""
    agent.server.intents.put(alloc.pod_key, alloc.device_ids)
    return {**alloc.env,
            **agent.kubelet.allocate(agent.server.resource_name, alloc.device_ids)}


def refused(agent, device_ids: list) -> str:
    """The plugin's refusal of an Allocate of ``device_ids`` (its message),
    or "" when it answered with an env or refused with another code."""
    from tpukube_torch.plugin import PluginRpcError

    try:
        agent.kubelet.allocate(agent.server.resource_name, device_ids)
    except PluginRpcError as e:
        return e.message if e.code == "INVALID_ARGUMENT" else ""
    return ""


def median_us(fn, rounds: int = 100) -> float:
    """Median host-clock µs of ``rounds`` calls of ``fn``."""
    times = []
    for _ in range(rounds):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e6


def plugin_phase(agent, chips: list, bound, card: str):
    """The device plugin on the card (module docstring, steps 2-3): its
    registration and first device list, the planned Allocate of the
    serving pod's bound ids, a refused Allocate. Returns (the pod's env,
    the plugin line's timings), or None when a check failed."""
    from tpukube_torch.core.types import Health

    kubelet, server, mgr = agent.kubelet, agent.server, agent.mgr
    res = server.resource_name
    reg = kubelet.registration(res)
    if (reg.version, reg.resource_name) != ("v1beta1", "qiniu.com/tpu") \
            or not reg.options.get_preferred_allocation_available:
        fail(f"Register carried {reg}")
        return None
    devs = kubelet.devices(res)
    want = {c.device_id(): "Healthy" for c in chips}
    healthy = mgr.probe() and all(h is Health.HEALTHY
                                  for h in mgr.health_snapshot().values())
    if devs != want or not healthy:
        fail(f"first ListAndWatch listed {devs}, NVML has {want}, probe healthy {healthy}")
        return None
    if agent.watcher.check_once():
        fail(f"the health watch pushed a transition on a healthy card: "
             f"{mgr.health_snapshot()} {mgr.probe_report()}")
        return None
    spans = []
    server.span_sink = lambda name, pod_key, **fields: spans.append((name, pod_key))
    server.intents.put(bound.pod_key, bound.device_ids)
    ids = sorted(devs)
    planned = server.intents.preferred(ids, [], 1)
    pref = kubelet.preferred(res, ids, 1)
    if planned != ["tpu-0"] or pref != ["tpu-0"]:
        fail(f"GetPreferredAllocation answered {pref} (the intent: {planned})")
        return None
    penv = kubelet.allocate(res, ["tpu-0"])
    direct = mgr.allocate_env(["tpu-0"])  # the one direct call: equality only
    if penv != direct:
        fail(f"the plugin's Allocate env {penv} is not the device manager's {direct}")
        return None
    if (spans[:1] != [("intent_match", bound.pod_key)] or server.divergences
            or server.intents.depth()):
        fail(f"the intent was not satisfied: spans {spans}, divergences "
             f"{server.divergences}, pending {server.intents.snapshot()}")
        return None
    why = refused(agent, ["tpu-99"])
    if not why:
        fail("Allocate of tpu-99 was not refused with INVALID_ARGUMENT")
        return None
    times = {
        "register_to_first_list_ms": agent.register_ms,
        "preferred_us_median": median_us(lambda: kubelet.preferred(res, ids, 1)),
        "allocate_us_median": median_us(lambda: kubelet.allocate(res, ["tpu-0"])),
    }
    print(f"device plugin: Register {reg.version} {reg.resource_name} -> first "
          f"ListAndWatch {devs} in {agent.register_ms:.3f} ms; GetPreferredAllocation "
          f"answered {pref} from {bound.pod_key}'s intent; Allocate env equals "
          f"allocate_env; tpu-99 refused ({why}) [{card}]", flush=True)
    return {**bound.env, **penv}, times


def sampled(sampler, fn):
    """``fn()`` while a thread steps ``sampler`` every TELEMETRY_PERIOD_S.
    Returns (its result, GPU 0's NVML memory in use at each sample)."""
    used, done = [], threading.Event()

    def loop() -> None:
        while not done.wait(TELEMETRY_PERIOD_S):
            sampler.check_once()
            used.append(sampler.latest()[0].hbm_used_bytes)

    thread = threading.Thread(target=loop, daemon=True)
    thread.start()
    try:
        return fn(), used
    finally:
        done.set()
        thread.join()


def plugin_metrics_ok(agent, sampler, n_gpus: int) -> bool:
    """The plugin's /metrics page after the serving pod (module docstring,
    step 4): its Allocates counted, every GPU Healthy, one telemetry
    series per GPU."""
    from tpukube_torch.metrics import render_plugin_metrics

    m = metric_lines(render_plugin_metrics(agent.server, health=agent.watcher,
                                           sampler=sampler))
    per_gpu = [f'tpukube_chip_{family}{{chip="tpu-{i}"}}' for i in range(n_gpus)
               for family in ("healthy", "duty_cycle_percent", "hbm_used_bytes",
                              "hbm_total_bytes", "ici_link_errors_total")]
    missing = [k for k in per_gpu if k not in m]
    if (m.get("tpukube_plugin_allocations_total", 0) < 1 or missing
            or m.get('tpukube_plugin_devices{health="Healthy"}') != n_gpus):
        fail(f"plugin /metrics: {m}; missing {missing}")
        return False
    return True


def config4_phase(card: str):
    """Config 4 on a simulated HGX fleet (module docstring, step 9).
    Returns (member 0's alloc, its env) of the 16-member gang, or None
    when a check failed."""
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.obs.registry import quantile
    from tpukube_torch.sim import SimCluster

    member0 = None
    for hosts, members, util in ((4, 16, 0.75), (16, 64, 0.5625)):
        cfg = load_config(env={"TPUKUBE_SIM_MESH_DIMS": f"8,{hosts},1",
                               "TPUKUBE_SIM_HOST_BLOCK": "8,1,1"})
        # member 0's Allocate runs through the sim node's plugin stack, in
        # process: the GPU machine has no grpcio
        with SimCluster(cfg, transport="inprocess") as c:
            for i in range(2):
                c.schedule(c.make_pod(f"bg-{i}", tpu=4))
            group = PodGroup("llama-8b", min_member=members)
            cycles, binds = [], []
            for i in range(members):
                pod = c.make_pod(f"llama-8b-{i}", tpu=1, group=group)
                t = time.perf_counter()
                binds.append(c.schedule(pod))
                cycles.append(time.perf_counter() - t)
            res = c.extender.gang.reservation("default", "llama-8b")
            got_util = c.utilization()
            nodes = sorted({n for n, _ in binds})
            coords = {tuple(co) for _, a in binds for co in a.coords}
            ys = sorted({co[1] for co in coords})
            whole = all(c.nodes[n].chips and {ch.coord for ch in c.nodes[n].chips}
                        <= coords for n in nodes)
            if (res is None or not res.committed or len(coords) != members
                    or len(nodes) != members // 8 or not whole
                    or ys != list(range(ys[0], ys[0] + members // 8))
                    or got_util != util):
                fail(f"{members}-member gang on 8,{hosts},1: nodes {nodes}, "
                     f"rows {ys}, utilization {got_util}, committed "
                     f"{res is not None and res.committed}")
                return None
            if members == 16:
                if nodes != ["host-0-1-0", "host-0-2-0"]:
                    fail(f"config 4 gang on {nodes}")
                    return None
                member0 = (binds[0][1], {**binds[0][1].env,
                                         **c.execute_allocation(binds[0][1])})
            print(
                f"config 4, {members}-member gang on 8,{hosts},1 ({hosts} HGX hosts "
                f"of 8 GPUs, two 4-GPU background pods): committed on {nodes[0]}.."
                f"{nodes[-1]} ({len(nodes)} whole hosts, rows y={ys[0]}..{ys[-1]}); "
                f"schedule cycle per member p50 {quantile(cycles, 0.5) * 1e3:.3f} ms, "
                f"p99 {quantile(cycles, 0.99) * 1e3:.3f} ms, gang commit latency "
                f"{res.commit_latency * 1e3:.3f} ms, utilization {got_util} "
                f"(host CPU times, in-process extender) [{card}]",
                flush=True,
            )
    return member0


# BASELINE config 5 on an HGX fleet: 16 hosts of 8 GPUs (step 11a)
CONFIG5_ENV = {"TPUKUBE_SIM_MESH_DIMS": "8,16,1", "TPUKUBE_SIM_HOST_BLOCK": "8,1,1"}
CONFIG5_BURST, CONFIG5_GANG = 80, 64


def config5_fleet(sim_cls, load_config, group_cls, sim_kw=None) -> dict:
    """Config 5's decisions on ``sim_cls`` (the port's ``SimCluster``, or
    any class with its surface): 80 burst 1-GPU pods at priority 0, a
    64-member priority-100 gang that must preempt, a refill with burst
    pods, a priority-0 32-member gang, then a scrape of ``/metrics`` over
    HTTP. Returns what happened; the caller judges it. Package-agnostic,
    so the tests hold the port's run against the reference's."""
    import urllib.request

    with sim_cls(load_config(env=CONFIG5_ENV), **(sim_kw or {})) as c:
        evicted: list = []
        drain = c.drain_evictions

        def drain_and_record() -> list:
            done = drain()
            evicted.extend(done)
            return done

        c.drain_evictions = drain_and_record  # schedule() drains per cycle
        burst = [c.schedule(c.make_pod(f"infer-{i}", tpu=1))
                 for i in range(CONFIG5_BURST)]
        util_burst = c.utilization()
        group = group_cls("llama-train", min_member=CONFIG5_GANG)
        cycles, gang = [], []
        for i in range(CONFIG5_GANG):
            pod = c.make_pod(f"train-{i}", tpu=1, priority=100, group=group)
            t = time.perf_counter()
            gang.append(c.schedule(pod))
            cycles.append(time.perf_counter() - t)
        res = c.extender.gang.reservation("default", "llama-train")
        victims = [a.pod_key for _, a in burst
                   if c.extender.state.allocation(a.pod_key) is None]
        still_stored = [k for k in victims if k in c.pods]
        refill = []
        names = ([f"{k.split('/', 1)[1]}-retry" for k in victims]
                 + [f"fill-{i}" for i in range(len(c.nodes) * 8)])
        for name in names:
            try:
                refill.append(c.schedule(c.make_pod(name, tpu=1)))
            except RuntimeError:
                break  # the fleet is full: the rest stay Pending
        util = c.utilization()
        try:
            c.schedule(c.make_pod("fl-0", tpu=1, priority=0,
                                  group=group_cls("freeloader", min_member=32)))
            refused = None
        except RuntimeError as e:
            refused = str(e)
        with urllib.request.urlopen(f"{c.base_url}/metrics", timeout=10) as r:
            metrics = r.read().decode()
        return {
            "burst": [(n, a.device_ids, [tuple(x) for x in a.coords]) for n, a in burst],
            "gang": [(n, a.device_ids, [tuple(x) for x in a.coords]) for n, a in gang],
            "refill": [(n, a.device_ids) for n, a in refill],
            "util_burst": util_burst,
            "committed": res is not None and res.committed,
            "commit_latency": res.commit_latency if res is not None else None,
            "cycles": cycles,
            "victims": victims,
            "evicted": evicted,
            "still_stored": still_stored,
            "preemptions": c.extender.preemptions,
            "utilization": util,
            "refused": refused,
            "metrics": metrics,
            "hosts": {n: sorted(tuple(ch.coord) for ch in info.chips)
                      for n, info in c.nodes.items()},
        }


def metric_lines(text: str) -> dict:
    """The samples of a Prometheus text page: series (with labels) -> value."""
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in text.splitlines() if line and not line.startswith("#")}


def config5_phase(card: str) -> bool:
    """Config 5 on a simulated HGX fleet (module docstring, step 11a);
    False when a check failed."""
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.obs.registry import quantile
    from tpukube_torch.sim import SimCluster

    r = config5_fleet(SimCluster, load_config, PodGroup)
    coords = {co for _, _, cs in r["gang"] for co in cs}
    nodes = sorted({n for n, _, _ in r["gang"]})
    ys = sorted({co[1] for co in coords})
    whole = all(set(r["hosts"][n]) <= coords for n in nodes)
    m = metric_lines(r["metrics"])
    p50 = m.get('gang_schedule_latency_seconds{quantile="0.5"}', 0.0)
    checks = {
        "committed": r["committed"],
        "64 GPUs on 8 whole hosts": len(coords) == CONFIG5_GANG and len(nodes) == 8 and whole,
        "contiguous along y": ys == list(range(ys[0], ys[0] + len(ys))),
        "preemptions > 0": r["preemptions"] > 0 and bool(r["victims"]),
        "victims evicted from the pod store": not r["still_stored"]
        and sorted(r["victims"]) == sorted(set(r["evicted"]) & set(r["victims"])),
        "utilization >= 0.95": r["utilization"] >= 0.95,
        "priority-0 gang refused": r["refused"] is not None
        and "cannot preempt" in r["refused"],
        "/metrics utilization >= 95": m.get("tpu_chip_utilization_percent", 0) >= 95.0,
        "/metrics gang p50 in (0, 60) s": 0 < p50 < 60,
        "/metrics preemptions > 0": m.get("tpukube_preemptions_total", 0) > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"config 5: {bad}; nodes {nodes}, rows {ys}, utilization "
             f"{r['utilization']}, refused {r['refused']!r}")
        return False
    cyc = r["cycles"]
    print(
        f"config 5, {CONFIG5_GANG}-member priority-100 gang on 8,16,1 after "
        f"{CONFIG5_BURST} priority-0 burst pods (utilization {r['util_burst']}): "
        f"committed on {nodes[0]}..{nodes[-1]} (8 whole hosts, rows y={ys[0]}.."
        f"{ys[-1]}), {len(r['victims'])} victims preempted (extender preemptions "
        f"{r['preemptions']}); schedule cycle per member p50 "
        f"{quantile(cyc, 0.5) * 1e3:.3f} ms, p99 {quantile(cyc, 0.99) * 1e3:.3f} ms, "
        f"gang commit latency {r['commit_latency'] * 1e3:.3f} ms; after "
        f"{len(r['refill'])} refill pods utilization {r['utilization']}; "
        f"priority-0 32-member gang refused; /metrics: utilization "
        f"{m['tpu_chip_utilization_percent']}%, gang p50 {p50 * 1e3:.3f} ms, "
        f"preemptions {m['tpukube_preemptions_total']:.0f}, evictions "
        f"{m.get('tpukube_evictions_total', 0):.0f} (host CPU times, in-process "
        f"extender) [{card}]",
        flush=True,
    )
    return True


def preempt_on_card(card: str, c0):
    """One real preemption on the card (module docstring, step 11b).
    Returns the training pod's report, or None when a check failed. The
    burst pod never outlives the call."""
    import signal

    from tpukube_torch.apiserver import EvictionExecutor, FakeApiServer
    from tpukube_torch.core import codec
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.sched import client
    from tpukube_torch.sched.extender import Extender, serve
    from tpukube_torch.sched.kube import pod_object

    procs: dict = {}  # pod key -> the process of its container
    t_sig: list = []

    class KubeletApi(FakeApiServer):
        """The fake apiserver, with the kubelet's half of an eviction: an
        accepted eviction of a graceful pod SIGTERMs its container."""

        def evict_pod(self, namespace, name, dry_run=False):
            ok = super().evict_pod(namespace, name, dry_run=dry_run)
            proc = procs.get(f"{namespace}/{name}")
            if ok and not dry_run and proc is not None and proc.poll() is None:
                t_sig.append(time.perf_counter())
                proc.send_signal(signal.SIGTERM)
            return ok

    api = KubeletApi()
    ext = Extender(load_config(env={}))
    ext.evict_precheck = lambda key: api.evict_pod(*key.split("/", 1), dry_run=True)
    execu = EvictionExecutor(ext, api)
    server = serve(ext, evictions=execu)
    port = server.server_address[1]
    burst_proc = None
    try:
        with node_agent({}) as agent:
            mgr = agent.mgr

            def nvml_used() -> int:
                return mgr.telemetry_snapshot()[0].hbm_used_bytes

            node = node_object(mgr)
            used = {"idle": nvml_used()}
            burst = pod_object("burst-0", tpu=1, priority=0)
            host, alloc, _ = client.place(port, burst, [node])
            if alloc.device_ids != ["tpu-0"]:
                fail(f"burst pod bound {alloc.device_ids} on {host}")
                return None
            bkey = alloc.pod_key
            burst["metadata"]["annotations"][codec.ANNO_ALLOC] = codec.encode_alloc(alloc)
            burst["spec"]["nodeName"] = host
            api.upsert_pod(burst)
            api.graceful.add(bkey)  # terminates as the kubelet lets it
            benv = allocate(agent, alloc)
            burst_proc = subprocess.Popen(
                [sys.executable, "-m", "tpukube_torch.graft", "--requests",
                 str(BURST_REQUESTS), "--batch", "1"],
                cwd=ROOT, env=pod_env(benv), stdout=subprocess.PIPE, text=True)
            procs[bkey] = burst_proc
            lines: queue.Queue = queue.Queue()
            threading.Thread(target=pump, args=(burst_proc.stdout, lines),
                             daemon=True).start()
            while True:
                line = lines.get(timeout=POD_TIMEOUT_S)
                if line is None:
                    fail(f"burst pod exited {burst_proc.wait()} before serving")
                    return None
                print(f"burst pod: {line.rstrip()}", flush=True)
                if line.startswith('{"serving"'):
                    break
            used["serving"] = nvml_used()
            exited = threading.Event()
            t_exit = []

            def kubelet() -> None:
                burst_proc.wait()
                t_exit.append(time.perf_counter())
                exited.set()
                api.finish_termination(*bkey.split("/", 1))

            threading.Thread(target=kubelet, daemon=True).start()

            gang = pod_object("llama-train-0", tpu=1, priority=100,
                              annotations=codec.pod_group_annotations(
                                  PodGroup("llama-train", min_member=1)))
            fres = client.filter_nodes(port, gang, [node])
            if fres.get("Error") or fres["NodeNames"] != [host]:
                fail(f"the priority-100 gang pod was not planned on {host}: {fres}")
                return None
            client.post(port, "/prioritize", {"Pod": gang, "NodeNames": [host]})
            meta = gang["metadata"]
            bind = {"PodName": meta["name"], "PodNamespace": meta["namespace"],
                    "PodUID": meta["uid"], "Node": host}
            t0 = time.perf_counter()
            refusals, t_gone = [], None
            deadline = t0 + PREEMPT_TIMEOUT_S
            while True:
                alive = burst_proc.poll() is None
                bres = client.post(port, "/bind", bind)
                if not bres.get("Error"):
                    break
                if not refusals and "finish terminating" not in bres["Error"]:
                    fail(f"first gang bind: {bres['Error']}")
                    return None
                if not refusals and not alive:
                    fail("the burst pod was gone before the first gang bind")
                    return None
                if "terminating" not in bres["Error"]:
                    fail(f"gang bind refused for another reason: {bres['Error']}")
                    return None
                refusals.append(bres["Error"])
                if time.perf_counter() > deadline:
                    fail(f"the victim did not go in {PREEMPT_TIMEOUT_S} s")
                    return None
                execu.check_once()
                if t_gone is None and execu.evicted:
                    t_gone = time.perf_counter()
                time.sleep(0.01)
            t_bind = time.perf_counter()
            if burst_proc.poll() is None or not exited.is_set():
                fail("the gang's bind landed while the victim process was alive")
                return None
            used["bind"] = nvml_used()
            galloc = codec.decode_alloc(bres["Annotations"][codec.ANNO_ALLOC])
            if galloc.device_ids != ["tpu-0"] or burst_proc.returncode != -signal.SIGTERM:
                fail(f"gang bound {galloc.device_ids}; victim exit {burst_proc.returncode}")
                return None
            print(
                f"preemption on the card: burst pod {bkey} (priority 0, Llama-3-8B "
                f"B=1 serving) evicted for gang pod {galloc.pod_key} (priority 100): "
                f"first bind refused while the victim lived ({refusals[0]!r}); "
                f"after the first bind attempt: SIGTERM {(t_sig[0] - t0) * 1e3:.1f} "
                f"ms, victim exit {(t_exit[0] - t0) * 1e3:.1f} ms (SIGTERM to exit "
                f"{(t_exit[0] - t_sig[0]) * 1e3:.1f} ms), victim_gone "
                f"{(t_gone - t0) * 1e3:.1f} ms, the bind of {galloc.device_ids} "
                f"{(t_bind - t0) * 1e3:.1f} ms ({len(refusals)} refused binds); "
                f"extender preemptions "
                f"{ext.preemptions}, executor evicted {execu.evicted}; NVML memory "
                f"in use: idle {used['idle']}, victim serving {used['serving']}, at "
                f"the gang's bind {used['bind']} bytes [{card}]",
                flush=True,
            )
            genv = allocate(agent, galloc)
        tr = run_pod(["--train"], genv, "train")
        if tr is None:
            return None
        if tr["uuid"] != c0.chip_id:
            fail(f"the gang's training pod ran on {tr['uuid']}, allocated {c0.chip_id}")
            return None
        return tr
    finally:
        if burst_proc is not None:
            if burst_proc.poll() is None:
                burst_proc.kill()
            burst_proc.wait()
        server.shutdown()
        server.server_close()


def mps_daemon_running() -> bool:
    """Whether an MPS control daemon runs on this machine: without one,
    CUDA_MPS_ACTIVE_THREAD_PERCENTAGE binds nothing."""
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/comm") as f:
                if f.read().strip() == "nvidia-cuda-mps-control":
                    return True
        except OSError:  # not a process, or it ended
            continue
    return False


def pump(stream, q: queue.Queue) -> None:
    """Put each line of ``stream`` on ``q``, then None at its end."""
    for line in stream:
        q.put(line)
    q.put(None)


def run_shared(envs: list, guard: str, mgr) -> tuple:
    """Two ``--shared`` pods, one per share env, under the guard: both are
    started, and released by ``go`` together once both are ``ready``;
    while they run, the node agent's telemetry is sampled and its probe
    must stay healthy. Returns (reports, ready lines, [(phase, telemetry)])
    or None when a pod or the probe failed. No pod outlives the call."""
    procs, lines = [], []
    try:
        for env in envs:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tpukube_torch.graft", "--shared"],
                cwd=ROOT, env=pod_env({**env, "LD_PRELOAD": guard}),
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
            lines.append(queue.Queue())
        for proc, q in zip(procs, lines):
            threading.Thread(target=pump, args=(proc.stdout, q), daemon=True).start()
        deadline = time.monotonic() + POD_TIMEOUT_S
        outs = [[] for _ in procs]

        def take(i: int, timeout: float):
            line = lines[i].get(timeout=timeout)
            if line is not None:
                outs[i].append(line.rstrip("\n"))
                print(f"shared pod {i}: {line.rstrip()}", flush=True)
            return line

        ready = []
        for i in range(len(procs)):
            while True:
                line = take(i, max(deadline - time.monotonic(), 1.0))
                if line is None:
                    fail(f"shared pod {i} exited {procs[i].wait()} before ready")
                    return None
                if line.startswith('{"ready"'):
                    ready.append(json.loads(line)["ready"])
                    break
        samples = [("ready", mgr.telemetry_snapshot()[0])]
        if not mgr.probe():
            fail(f"XID/liveness probe failed: {mgr.probe_report()}")
            return None
        for proc in procs:
            proc.stdin.write("go\n")
            proc.stdin.flush()
            proc.stdin.close()
        done = [False] * len(procs)
        while not all(done):
            if time.monotonic() > deadline:
                fail(f"shared pods did not finish in {POD_TIMEOUT_S} s")
                return None
            time.sleep(TELEMETRY_PERIOD_S)
            samples.append(("running", mgr.telemetry_snapshot()[0]))
            if not mgr.probe():
                fail(f"XID/liveness probe failed while the pods ran: {mgr.probe_report()}")
                return None
            for i in range(len(procs)):
                try:
                    while not done[i]:
                        done[i] = take(i, 0) is None
                except queue.Empty:
                    pass
        reports = []
        for i, proc in enumerate(procs):
            rc = proc.wait()
            if rc != 0 or not outs[i]:
                fail(f"shared pod {i} exited {rc}")
                return None
            reports.append(json.loads(outs[i][-1])["shared"])
        return reports, ready, samples
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def vgpu_phase(card: str, c0, solo: dict) -> int:
    """BASELINE config 3 on the card (module docstring, step 8); 0 or the
    exit code of the failed check."""
    from tpukube_torch.device.gpu import (
        ENV_HBM_LIMIT,
        ENV_KUBE_CORE_IDS,
        ENV_MEM_FRACTION,
        ENV_MPS_THREAD_PERCENTAGE,
    )
    from tpukube_torch.native import cudaguard
    from tpukube_torch.sched.kube import pod_object

    mps = mps_daemon_running()
    print(f"vGPU: MPS control daemon running: {mps}"
          + ("" if mps else " (the SM split below is advertised, not enforced)"),
          flush=True)
    with node_agent({"TPUKUBE_SHARES_PER_CHIP": "2"}) as agent:
        mgr, kubelet = agent.mgr, agent.kubelet
        res = agent.server.resource_name
        ids = ["tpu-0-frac0of2", "tpu-0-frac1of2"]
        devices = kubelet.devices(res)
        if res != "qiniu.com/vtpu" or kubelet.registration(res).resource_name != res:
            return fail(f"vGPU resource {res}")
        if devices != {d: "Healthy" for d in ids}:
            return fail(f"vGPU ListAndWatch listed {devices}")
        picked = kubelet.preferred(res, ids, 2)
        if sorted(picked) != ids:
            return fail(f"GetPreferredAllocation picked {picked}")
        quota = c0.hbm_bytes // 2
        cps = c0.num_cores // 2

        allocs = place_pods(node_object(mgr),
                            [pod_object(f"shared-{k}", vtpu=1) for k in range(2)],
                            [[d] for d in ids], pod_object("shared-2", vtpu=1), card)
        if allocs is None:
            return 1
        envs = [allocate(agent, a) for a in allocs]
        for k, env in enumerate(envs):
            sms = "0:" + "+".join(str(c) for c in range(k * cps, (k + 1) * cps))
            want = {ENV_HBM_LIMIT: str(quota), ENV_MEM_FRACTION: "0.5000",
                    ENV_KUBE_CORE_IDS: sms,
                    ENV_MPS_THREAD_PERCENTAGE: str(cps * 100 // c0.num_cores)}
            got = {key: env.get(key) for key in want}
            if got != want:
                return fail(f"share {k} env {got}, want {want}")
            print(f"vGPU allocate env, share {k}: " + json.dumps(env, sort_keys=True),
                  flush=True)
        why = refused(agent, ["tpu-0-frac2of2"])
        if not why:
            return fail("a third share of the card was not refused with INVALID_ARGUMENT")
        print(f"vGPU: third share refused by the plugin: {why}", flush=True)

        guard = cudaguard.library_path()
        # share 0's env without its fraction: with it, PyTorch's caching
        # allocator refuses at the same byte count before cudaMalloc is
        # called, and the guard is never asked
        qenv = {k: v for k, v in envs[0].items() if k != ENV_MEM_FRACTION}
        q = run_pod(["--quota"], {**qenv, "LD_PRELOAD": guard}, "quota")
        if q is None:
            return 1
        if q["uuid"] != c0.chip_id:
            return fail(f"quota pod ran on {q['uuid']}, allocated {c0.chip_id}")
        print("quota: " + json.dumps(q, sort_keys=True), flush=True)
        print(
            f"quota pod: guard refused 4 GiB block {q['blocks_fitted'] + 1} at "
            f"{q['used_at_refusal']} bytes metered of a {q['limit']}-byte quota; "
            f"limit + 1 GiB refused with {q['nvml_free_at_over_request']} bytes "
            f"free on the card (NVML) [{card}]",
            flush=True,
        )

        ran = run_shared(envs, guard, mgr)
        if ran is None:
            return 1
        reports, ready, samples = ran
    for i, r in enumerate(reports):
        if r["uuid"] != c0.chip_id:
            return fail(f"shared pod {i} ran on {r['uuid']}, allocated {c0.chip_id}")
        if r["max_memory_reserved"] > quota or r["guard_peak"] > quota:
            return fail(f"shared pod {i} passed its quota {quota}: {r}")
        print(f"shared {i}: " + json.dumps(r, sort_keys=True), flush=True)
    nvml_used = max(t.hbm_used_bytes for _, t in samples)
    reserved = sum(r["memory_reserved"] for r in ready)
    if nvml_used <= reserved:
        return fail(f"NVML used {nvml_used} <= the pods' reserved {reserved}")
    util = max(t.duty_cycle_percent for w, t in samples if w == "running")
    if util <= 0:
        return fail("NVML utilization stayed 0 while the pods ran")
    for i, r in enumerate(reports):
        print(
            f"shared pod {i}, Llama-3-8B B={r['batch']} S={r['seq']} beside the "
            f"other pod: median {r['forward_ms_median']:.3f} ms, "
            f"{r['tokens_per_s']:.1f} tokens/s; peak reserved "
            f"{r['max_memory_reserved']} of a {quota}-byte quota, guard peak "
            f"{r['guard_peak']}, refused {r['guard_refused']} [{card}]",
            flush=True,
        )
    both = sum(r["tokens_per_s"] for r in reports)
    print(
        f"shared card: two B=1 pods {both:.1f} tokens/s together against the solo "
        f"B=2 pod's {solo['tokens_per_s']:.1f} ({both / solo['tokens_per_s']:.1%}); "
        f"NVML over {len(samples)} samples: used up to {nvml_used} bytes (pods "
        f"reserved {reserved} at ready), utilization up to {util:.0f}%, XID probe "
        f"healthy throughout [{card}]",
        flush=True,
    )
    return 0


def main() -> int:
    t_start = time.monotonic()
    # CUDA's device order must be NVML's (PCI bus order) for the checks of
    # step 2 to compare the same card; set before CUDA initializes
    os.environ["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")

    from tpukube_torch.core import codec
    from tpukube_torch.core.types import Health
    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.obs.health import HealthSampler
    from tpukube_torch.sched.kube import pod_object

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # -- node agent, its device plugin --------------------------------------
    props = torch.cuda.get_device_properties(0)
    # the real backend's default health watch: NVML XID events + liveness
    with node_agent({}) as agent:
        mgr = agent.mgr
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
        # -- placement, then the plugin's Allocate of the bound ids ---------
        allocs = place_pods(node_object(mgr), [pod_object("serve-0", tpu=1)],
                            [["tpu-0"]], pod_object("serve-1", tpu=1), card)
        if allocs is None:
            return 1
        planned = plugin_phase(agent, chips, allocs[0], card)
        if planned is None:
            return 1
        env, times = planned
        print("allocate env: " + json.dumps(env, sort_keys=True), flush=True)

        # -- pod, while the node agent samples telemetry --------------------
        sampler = HealthSampler(mgr, poll_seconds=TELEMETRY_PERIOD_S)
        sampler.check_once()
        idle = sampler.latest()[0].hbm_used_bytes
        pod, used = sampled(sampler, lambda: run_pod([], env, "pod"))
        if pod is None:
            return 1
        if not any(u > idle for u in used):
            return fail(f"no telemetry sample above the idle {idle} bytes: {used}")
        if not plugin_metrics_ok(agent, sampler, len(chips)):
            return 1
        print("plugin: " + json.dumps({
            **times, "rounds": 100, "devices": agent.kubelet.devices(agent.server.resource_name),
            "sampler": {"samples": sampler.samples, "during_pod": len(used),
                        "nvml_used_idle_bytes": idle, "nvml_used_peak_bytes": max(used),
                        "above_idle": sum(u > idle for u in used)},
            "card": card,
        }, sort_keys=True), flush=True)
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

    # -- vGPU: two pods on shares of the card ---------------------------------
    rc = vgpu_phase(card, c0, pod)
    if rc:
        return rc

    # -- config 4 on a simulated HGX fleet, then its member 0 on the card ----
    member0 = config4_phase(card)
    if member0 is None:
        return 1
    alloc0, env0 = member0
    # the sim node's GPU index names nothing on this one-card machine: the
    # pod's one visible device maps to the local card, which the pod's
    # UUID check then holds to NVML's GPU 0
    senv = {**env0, "CUDA_VISIBLE_DEVICES": "0",
            ENV_ALLOC: codec.encode_alloc(alloc0)}
    print("scheduled pod env: " + json.dumps(senv, sort_keys=True), flush=True)
    sp = run_pod(["--scheduled"], senv, "scheduled")
    if sp is None:
        return 1
    checked = sp["scheduled"]
    if (sp["uuid"] != c0.chip_id or checked["mesh_dims"] != [8, 4, 1]
            or checked["device_ids"] != alloc0.device_ids
            or checked["node"] != alloc0.node_name):
        return fail(f"scheduled pod: {checked} on {sp['uuid']}, bound {alloc0}")
    print("scheduled: " + json.dumps(sp, sort_keys=True), flush=True)
    print(
        f"scheduled pod {checked['pod']} (bound {checked['device_ids']} at "
        f"{checked['coords']} on {checked['node']} of the 8,4,1 fleet, gang keys "
        f"{checked['gang']}): Llama-3-8B B={sp['batch']} S={sp['seq']}, one "
        f"request {sp['forward_ms_median']:.3f} ms on {sp['uuid']} [{card}]",
        flush=True,
    )

    # -- config 5: preemption on an HGX fleet, then one on the card ----------
    if not config5_phase(card):
        return 1
    tr5 = preempt_on_card(card, c0)
    if tr5 is None:
        return 1
    print("preemptor's train: " + json.dumps(tr5, sort_keys=True), flush=True)
    print(
        f"the preempting gang's training pod, Llama-3-8B width, {tr5['n_layers']} "
        f"layers, B={tr5['batch']} S={tr5['seq']}: median "
        f"{tr5['step_ms_median']:.3f} ms, losses "
        f"{[round(x, 4) for x in tr5['losses']]}, card vs CPU loss "
        f"{tr5['parity_loss']:.5f} vs {tr5['parity_ref_loss']:.5f} [{card}]",
        flush=True,
    )

    # -- dryrun_multichip(4) on gloo ranks, leg 2 on a port-minted gang env -
    proc = subprocess.run(
        [sys.executable, "-c",
         "import json; from tpukube_torch import graft; "
         "print(json.dumps(graft.dryrun_multichip(4, device='cpu')))"],
        cwd=ROOT, env=pod_env({}), stdout=subprocess.PIPE, text=True,
        timeout=POD_TIMEOUT_S,
    )
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or any("skipping" in x for x in lines):
        print(proc.stdout, flush=True)
        return fail(f"gloo dry run exited {proc.returncode} or skipped a leg")
    gloo = json.loads(lines[-1])
    if gloo.get("leg2", {}).get("axes") != ["dcn", "dp", "tp"]:
        return fail(f"gloo dry run legs {gloo}")
    print(
        f"dryrun_multichip(4, cpu) over gloo: leg 1 {gloo['leg1']['axes']} "
        f"{gloo['leg1']['shape']} loss {gloo['leg1']['loss']:.4f}; leg 2 "
        f"{gloo['leg2']['axes']} {gloo['leg2']['shape']} loss "
        f"{gloo['leg2']['loss']:.4f} on the port-minted DCN gang env",
        flush=True,
    )
    # nothing on the card path loaded the gRPC stack
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] == "grpc" or m.startswith("google.protobuf"))
    if loaded:
        return fail(f"the card path imported {loaded}")
    print(f"chip_smoke: whole run {time.monotonic() - t_start:.1f} s [{card}]",
          flush=True)

    print(json.dumps({
        "kernels": [],
        "note": "no Pallas kernel in tpukube; the port's native code is host "
                "C++: gpuinfo (NVML discovery, XID health, telemetry) and "
                "cudaguard (CUDA driver quota guard); the scheduler extender "
                "is host Python (numpy)",
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
