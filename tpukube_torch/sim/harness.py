"""SimCluster — plays apiserver + kube-scheduler against the port's extender.

The port's own copy of ``tpukube/sim/harness.py``: node objects are minted
from ``MeshSpec`` geometry and annotated with the node agent's codec, pods
are kube-scheduler's JSON, and every webhook (filter -> prioritize -> pick
max -> bind) goes straight into ``Extender.handle`` — the reference's
``in_process=True`` path, the same decisions minus sockets. Inside a
``with`` block (or after :meth:`SimCluster.start`) the extender's HTTP
app also serves on ``base_url`` (``tpukube_torch.sched.extender.serve``),
so ``GET {base_url}/metrics`` reads the live daemon's exposition.
``execute_allocation`` runs the bound pod's Allocate through the device
plugin stack of the bound node (``tpukube_torch.plugin``: kubelet peer,
sim-backend ``GpuDeviceManager``, ``DevicePluginServer``) over the
transport named at construction: ``"grpc"`` (unix sockets, as the
reference) or ``"inprocess"`` (the same v1beta1 bytes without grpcio,
for the GPU machine).

An HGX fleet is ``MeshSpec((8, H, 1), (8, 1, 1))``: H hosts of 8 GPUs
along y (``TPUKUBE_SIM_MESH_DIMS=8,H,1``, ``TPUKUBE_SIM_HOST_BLOCK=8,1,1``).

The sim's pod store stands in for the apiserver, and the extender is wired
as a daemon is (``_wire_extender``): the ``EvictionExecutor`` deletes
evicted pods from the store and confirms them gone (``victim_gone``), the
``PodLifecycleReleaseLoop`` releases a deleted or finished pod's chips
through the recorded ``release`` decision, and the PDB precheck asks the
store (which has no PDBs).
"""

from __future__ import annotations

from typing import Any, Optional

from tpukube_torch.apiserver import EvictionExecutor, PodLifecycleReleaseLoop
from tpukube_torch.core import codec
from tpukube_torch.core.clock import SYSTEM
from tpukube_torch.core.config import GpuKubeConfig, load_config
from tpukube_torch.core.mesh import MeshSpec
from tpukube_torch.core.types import (
    AllocResult,
    ChipInfo,
    Health,
    NodeInfo,
    PodGroup,
    canonical_link,
)
from tpukube_torch.plugin.fake_kubelet import TRANSPORTS
from tpukube_torch.sched import kube
from tpukube_torch.sched.extender import Extender, serve


class _PodStoreApi:
    """The apiserver surface EvictionExecutor and PodLifecycleReleaseLoop
    act through, over the harness's in-memory pod store (no PDBs in the
    sim: every eviction is accepted and deletes at once)."""

    def __init__(self, pods: dict[str, dict[str, Any]]) -> None:
        self._pods = pods

    def evict_pod(
        self, namespace: str, name: str, dry_run: bool = False
    ) -> bool:
        if dry_run:
            return True  # no PDBs in the sim
        pod = self._pods.pop(f"{namespace}/{name}", None)
        if pod is not None:
            pod["metadata"].get("annotations", {}).pop(codec.ANNO_ALLOC, None)
            pod["spec"].pop("nodeName", None)
        return True

    def get_pod(self, namespace: str, name: str) -> Optional[dict[str, Any]]:
        return self._pods.get(f"{namespace}/{name}")

    def list_pods(self, node_name: Optional[str] = None) -> list[dict[str, Any]]:
        return [
            p for p in list(self._pods.values())
            if node_name is None
            or p.get("spec", {}).get("nodeName") == node_name
        ]


class SimCluster:
    """A simulated multi-node GPU cluster around one live Extender."""

    def __init__(
        self,
        config: Optional[GpuKubeConfig] = None,
        mesh: Optional[MeshSpec] = None,
        vtpu_nodes: Optional[set[str]] = None,
        vtpu_shares: int = 2,
        slices: Optional[dict[str, MeshSpec]] = None,
        clock=None,
        transport: str = "grpc",
    ):
        """Single-slice by default (``mesh``, else the config's sim mesh);
        pass ``slices`` (slice id -> MeshSpec) for a multi-slice cluster —
        node names are then prefixed "<slice>-host-i-j-k" so they stay
        unique cluster-wide. ``clock`` (core/clock.py) threads an
        injectable — typically a FakeClock — through the gang TTLs.
        ``transport`` is the device plugin's, for ``execute_allocation``:
        "grpc" or "inprocess"."""
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown plugin transport {transport!r}")
        self.transport = transport
        self.config = config or load_config(env={})
        self.clock = clock if clock is not None else SYSTEM
        if slices is not None and mesh is not None:
            raise ValueError("pass either mesh or slices, not both")
        self._prefixed = slices is not None
        if slices is None:
            slices = {self.config.slice_id: mesh or self.config.sim_mesh()}
        self.slices: dict[str, MeshSpec] = dict(slices)
        # single-slice convenience handle (most tests/scenarios)
        self.mesh: Optional[MeshSpec] = (
            next(iter(self.slices.values())) if len(self.slices) == 1 else None
        )
        self._vtpu_nodes = vtpu_nodes or set()
        self.nodes: dict[str, NodeInfo] = {}
        for sid in sorted(self.slices):
            m = self.slices[sid]
            for host in m.all_hosts():
                name = f"{sid}-{host}" if self._prefixed else host
                chips = [
                    ChipInfo(
                        chip_id=f"{name}-chip-{i}",
                        index=i,
                        coord=coord,
                        hbm_bytes=self.config.hbm_bytes_per_chip,
                        num_cores=self.config.cores_per_chip,
                    )
                    for i, coord in enumerate(m.coords_of_host(host))
                ]
                shares = vtpu_shares if name in self._vtpu_nodes else 1
                self.nodes[name] = NodeInfo(
                    name=name, chips=chips, shares_per_chip=shares,
                    slice_id=sid,
                )
        self.extender = Extender(self.config, clock=self.clock)
        self.pods: dict[str, dict[str, Any]] = {}  # key -> pod object
        self._wire_extender(_PodStoreApi(self.pods))
        self._http = None  # the extender's HTTP server while started
        # node objects cached per node (schedule() resends every node on
        # every webhook); fault injection invalidates the touched node
        self._node_obj_cache: dict[str, dict[str, Any]] = {}
        self._node_objs_list: Optional[list[dict[str, Any]]] = None
        # the node set the extender has ingested error-free, and its
        # names-only body (see _extender_node_args)
        self._synced_objs: list[dict[str, Any]] = []
        self._synced_names: list[str] = []

    def _wire_extender(self, store_api: _PodStoreApi) -> None:
        """Attach the effectors a real extender daemon wires (eviction
        executor, lifecycle release loop, PDB precheck) over the pod
        store, stepped deterministically by this harness instead of run
        as threads."""
        # drained inline by schedule(); not started as a thread
        self._evictions = EvictionExecutor(
            self.extender, store_api, clock=self.clock
        )
        # stepped by delete_pod/complete_pod — the sim has no manual
        # extender.release side channel
        self._lifecycle = PodLifecycleReleaseLoop(
            self.extender, store_api, use_watch=False,
            evictions=self._evictions,
        )
        # PDB precheck for preemption plans, the dry-run shape a real
        # daemon wires (trivially true here: the sim has no PDBs)
        self.extender.evict_precheck = (
            lambda pod_key: store_api.evict_pod(
                *pod_key.split("/", 1), dry_run=True
            )
        )

    # -- lifecycle ---------------------------------------------------------
    @property
    def base_url(self) -> str:
        """Where the extender's HTTP app serves while started."""
        if self._http is None:
            raise RuntimeError("SimCluster is not serving: start() it, or "
                               "use it as a context manager")
        host, port = self._http.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> None:
        """Serve the extender's HTTP app (webhooks, /healthz, /metrics
        with the executor's and lifecycle loop's counters) on 127.0.0.1."""
        if self._http is None:
            self._http = serve(self.extender, "127.0.0.1", 0,
                               evictions=self._evictions,
                               lifecycle=self._lifecycle)

    def stop(self) -> None:
        """Stop serving, then close the trace and event sinks (their
        drain threads)."""
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        if self.extender.trace is not None:
            self.extender.trace.close()
        self.extender.events.close()

    def __enter__(self) -> "SimCluster":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- kube-object minting -----------------------------------------------
    def _invalidate_node(self, name: str) -> None:
        self._node_obj_cache.pop(name, None)
        self._node_objs_list = None

    def node_objects(self) -> list[dict[str, Any]]:
        """Node API objects as kube-scheduler would send them, annotated
        by the node agent's codec (cached; see ``_invalidate_node``)."""
        cached = self._node_objs_list
        if cached is not None:
            return cached
        out = []
        for name, info in sorted(self.nodes.items()):
            obj = self._node_obj_cache.get(name)
            if obj is None:
                obj = {
                    "metadata": {
                        "name": name,
                        "annotations": codec.annotate_node(
                            info, self.slices[info.slice_id]
                        ),
                    }
                }
                self._node_obj_cache[name] = obj
            out.append(obj)
        self._node_objs_list = out
        return out

    def _extender_node_args(
        self,
    ) -> tuple[dict[str, Any], Optional[list[dict[str, Any]]]]:
        """The node half of ExtenderArgs, nodeCacheCapable style: full
        node objects only when some annotation changed since the last full
        send, names only otherwise — the traffic a kube-scheduler with
        ``nodeCacheCapable: true`` produces. Returns (args, pending_objs):
        the caller commits pending_objs only after the full send's
        response arrived error-free."""
        objs = self.node_objects()
        # cached objects are reused between cycles, so identity comparison
        # catches "nothing changed" without hashing annotation payloads
        synced = self._synced_objs
        if len(objs) == len(synced) and all(
            a is b for a, b in zip(objs, synced)
        ):
            return {"NodeNames": self._synced_names}, None
        return {"Nodes": {"Items": objs}}, objs

    def _commit_synced(self, objs: list[dict[str, Any]]) -> None:
        self._synced_objs = objs
        self._synced_names = [o["metadata"]["name"] for o in objs]

    def make_pod(
        self,
        name: str,
        tpu: int = 0,
        vtpu: int = 0,
        namespace: str = "default",
        priority: int = 0,
        group: Optional[PodGroup] = None,
        labels: Optional[dict[str, str]] = None,
    ) -> dict[str, Any]:
        pod = kube.pod_object(
            name, tpu=tpu, vtpu=vtpu, namespace=namespace, priority=priority,
            annotations=(codec.pod_group_annotations(group)
                         if group is not None else None),
        )
        pod["metadata"]["labels"] = dict(labels or {})
        self.pods[f"{namespace}/{name}"] = pod
        return pod

    # -- the scheduler loop (what kube-scheduler would do) -------------------
    def _post(self, path: str, body: dict[str, Any]) -> Any:
        """One webhook, dispatched into ``Extender.handle`` (a schema
        error is what the HTTP server answers with 400)."""
        try:
            return self.extender.handle(path.strip("/"), body)
        except kube.KubeSchemaError as e:
            raise RuntimeError(f"HTTP 400 from {path}: {e}")

    def drain_evictions(self) -> list[str]:
        """Delete the pods the extender evicted (gang rollback, preemption)
        through the same :class:`~tpukube_torch.apiserver.EvictionExecutor`
        a real cluster runs, pointed at this harness's pod store. Returns
        the pod keys confirmed gone."""
        return self._evictions.drain()

    def schedule(
        self, pod: dict[str, Any], retries: int = 8
    ) -> tuple[str, AllocResult]:
        """One scheduling cycle for one pod, with kube-scheduler's requeue
        semantics: a lost bind race re-runs the whole cycle. Raises on
        failure.

        Evictions drain at the top of EVERY cycle: a gang's first bind
        executes its preemption plan and fails retryably until the victims
        are confirmed gone, so the retry must run the executor (as a real
        daemon's eviction loop would, concurrently) to make progress."""
        last_err = ""
        for _ in range(retries):
            self.drain_evictions()
            node_args, pending_objs = self._extender_node_args()
            args = {"Pod": pod, **node_args}
            fres = self._post("/filter", args)
            if fres.get("Error"):
                raise RuntimeError(f"filter error: {fres['Error']}")
            if pending_objs is not None:
                self._commit_synced(pending_objs)
            feasible_names = fres["NodeNames"]
            if not feasible_names:
                raise RuntimeError(f"unschedulable: {fres['FailedNodes']}")
            pres = self._post(
                "/prioritize", {"Pod": pod, "NodeNames": feasible_names}
            )
            scores = {e["Host"]: e["Score"] for e in pres}
            best = max(sorted(scores), key=lambda h: scores[h])
            meta = pod["metadata"]
            bres = self._post(
                "/bind",
                {
                    "PodName": meta["name"],
                    "PodNamespace": meta["namespace"],
                    "PodUID": meta["uid"],
                    "Node": best,
                },
            )
            if bres.get("Error"):
                last_err = bres["Error"]  # lost the race; requeue
                continue
            # apiserver role: persist alloc annotation + nodeName on the pod
            meta.setdefault("annotations", {}).update(bres.get("Annotations", {}))
            pod["spec"]["nodeName"] = best
            alloc = codec.decode_alloc(meta["annotations"][codec.ANNO_ALLOC])
            return best, alloc
        raise RuntimeError(f"bind error after {retries} cycles: {last_err}")

    def delete_pod(self, name: str, namespace: str = "default") -> None:
        """Remove the pod object, then let the lifecycle release loop
        observe the absence — the path a real cluster takes (DELETED
        event → recorded release decision), not a manual release call."""
        self.pods.pop(f"{namespace}/{name}", None)
        self._lifecycle.check_once()

    def complete_pod(self, name: str, namespace: str = "default",
                     phase: str = "Succeeded") -> None:
        """Mark a pod's containers finished (terminal phase). The object
        lingers — exactly how a completed Job pod looks on a real cluster
        — and the lifecycle loop frees its chips from the phase alone."""
        pod = self.pods.get(f"{namespace}/{name}")
        if pod is None:
            raise KeyError(f"no pod {namespace}/{name}")
        pod.setdefault("status", {})["phase"] = phase
        self._lifecycle.check_once()

    # -- fault injection ------------------------------------------------------
    def inject_fault(self, node_name: str, chip_index: int,
                     healthy: bool = False) -> None:
        """Flip a chip's health in the node data — the node agent's health
        watch re-annotates exactly so on a real cluster."""
        info = self.nodes[node_name]
        for chip in info.chips:
            if chip.index == chip_index:
                chip.health = Health.HEALTHY if healthy else Health.UNHEALTHY
                self._invalidate_node(node_name)
                return
        raise KeyError(f"{node_name} has no chip {chip_index}")

    def inject_link_fault(
        self, a, b, up: bool = False, slice_id: Optional[str] = None
    ) -> None:
        """Drop (or restore) the link between adjacent coords ``a``/``b`` —
        each endpoint's node reports its side. ``slice_id`` names the
        slice on multi-slice clusters."""
        if slice_id is None:
            if len(self.slices) != 1:
                raise ValueError("multi-slice cluster: pass slice_id")
            slice_id = next(iter(self.slices))
        mesh = self.slices[slice_id]
        link = canonical_link(a, b)
        ca, cb = link
        if cb not in mesh.neighbors(ca):
            raise ValueError(f"{ca} and {cb} are not ICI-adjacent")
        for coord in link:
            host = mesh.host_of(coord)
            name = f"{slice_id}-{host}" if self._prefixed else host
            info = self.nodes[name]
            if up:
                if link in info.bad_links:
                    info.bad_links.remove(link)
            elif link not in info.bad_links:
                info.bad_links.append(link)
            self._invalidate_node(name)

    # -- node-agent composition (config 2's fan-out leg) --------------------
    def execute_allocation(self, alloc: AllocResult,
                           restart_agent: bool = False) -> dict[str, str]:
        """Run the bound pod's Allocate through the device-plugin stack of
        the target node — kubelet peer, sim-backend ``GpuDeviceManager``
        (the node's block of the mesh, its slice, memory and sharing
        mode), ``DevicePluginServer`` — over ``self.transport``, returning
        the env the container would receive.

        ``restart_agent=True`` cold-starts the node agent between
        registration and Allocate: the server stops, and a fresh one is
        fed the intent and registers anew (over gRPC on a rebound socket)
        — a restarted agent must still serve the extender's planned
        intent."""
        import tempfile

        from tpukube_torch.device import GpuDeviceManager
        from tpukube_torch.plugin import DevicePluginServer, make_kubelet

        info = self.nodes[alloc.node_name]
        mesh = self.slices[info.slice_id]
        origin = min(c.coord for c in info.chips)
        with tempfile.TemporaryDirectory() as td:
            cfg = load_config(env={
                "TPUKUBE_BACKEND": "sim",
                "TPUKUBE_DEVICE_PLUGIN_DIR": td,
                "TPUKUBE_SIM_MESH_DIMS": ",".join(str(d) for d in mesh.dims),
                "TPUKUBE_SIM_HOST_BLOCK": ",".join(
                    str(d) for d in mesh.host_block
                ),
                "TPUKUBE_SIM_TORUS": ",".join(
                    str(t).lower() for t in mesh.torus
                ),
                "TPUKUBE_SIM_HOST_ORIGIN": ",".join(str(v) for v in origin),
                "TPUKUBE_SLICE_ID": info.slice_id,
                "TPUKUBE_HBM_BYTES_PER_CHIP": str(self.config.hbm_bytes_per_chip),
                "TPUKUBE_SHARES_PER_CHIP": str(info.shares_per_chip),
            })
            with GpuDeviceManager(cfg, host=alloc.node_name) as device, \
                    make_kubelet(self.transport, td) as kubelet:
                server = DevicePluginServer(cfg, device)
                self._plan_and_register(kubelet, server, device, alloc)
                if restart_agent:
                    server.stop()
                    server = DevicePluginServer(cfg, device)
                    self._plan_and_register(kubelet, server, device, alloc)
                return kubelet.allocate(server.resource_name, alloc.device_ids)

    def _plan_and_register(self, kubelet, server, device,
                           alloc: AllocResult) -> None:
        """The node agent's part before Allocate: the planned intent put
        into the server (the intent watcher's job on a real node), its
        allocate/intent-match spans routed into the extender's decision
        trace, then Register and the kubelet's first device list."""
        if self.extender.trace is not None:
            server.span_sink = self.extender.trace.span
        server.intents.put(alloc.pod_key, list(alloc.device_ids))
        kubelet.register_plugin(server)
        kubelet.wait_for_devices(server.resource_name, len(device.device_list()))

    # -- metrics ------------------------------------------------------------
    def utilization(self) -> float:
        return self.extender.state.utilization()
