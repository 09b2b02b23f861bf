"""SimCluster — plays apiserver + kube-scheduler against the port's extender.

The port's own copy of ``tpukube/sim/harness.py``: node objects are minted
from ``MeshSpec`` geometry and annotated with the node agent's codec, pods
are kube-scheduler's JSON, and every webhook (filter -> prioritize -> pick
max -> bind) goes straight into ``Extender.handle`` — the reference's
``in_process=True`` path, the same decisions minus sockets. Inside a
``with`` block (or after :meth:`SimCluster.start`) the extender's HTTP
app also serves on ``base_url`` (``tpukube_torch.sched.extender.serve``),
so ``GET {base_url}/metrics`` reads the live daemon's exposition, unless
the cluster was built ``in_process=True`` (no listener at all).

With ``batch_enabled``, :meth:`SimCluster.schedule_pending` is the batch
driver: it admits many pending pods into the extender's scheduling queue,
runs plan cycles, and sends each pod's /bind to its planned node. A
``FakeClock`` (``clock=``) and :meth:`SimCluster.advance` compress
simulated time (gang TTLs, plan expiry, eviction ages) into wall
seconds.
``execute_allocation`` runs the bound pod's Allocate through the device
plugin stack of the bound node (``tpukube_torch.plugin``: kubelet peer,
sim-backend ``GpuDeviceManager``, ``DevicePluginServer``) over the
transport named at construction: ``"grpc"`` (unix sockets, as the
reference) or ``"inprocess"`` (the same v1beta1 bytes without grpcio,
for the GPU machine).

An HGX fleet is ``MeshSpec((8, H, 1), (8, 1, 1))``: H hosts of 8 GPUs
along y (``TPUKUBE_SIM_MESH_DIMS=8,H,1``, ``TPUKUBE_SIM_HOST_BLOCK=8,1,1``).

The sim's pod store stands in for the apiserver (``_make_store_api``; the
chaos harness wraps it in a fault injector), and the extender is wired as
a daemon is (``_wire_extender``): the ``EvictionExecutor`` deletes evicted
pods from the store and confirms them gone (``victim_gone``), the
``PodLifecycleReleaseLoop`` releases a deleted or finished pod's chips
through the recorded ``release`` decision, and the PDB precheck asks the
store (which has no PDBs).

Fleet elasticity: :meth:`SimCluster.add_slice` mints a new slice's nodes
(the autoscaler's provisioner, :meth:`SimCluster.make_slice_provisioner`,
feeds them to ``upsert_nodes``), and :meth:`SimCluster.forget_nodes` /
:meth:`SimCluster.remove_slice` drop nodes a drain un-ingested so the next
full node send cannot re-register them.

:meth:`SimCluster.crash_extender` kills the extender mid-flight (its
journal loses what it had not drained) and
:meth:`SimCluster.restart_extender` starts a fresh one the way a restarted
daemon does: journal recovery with ``journal_enabled``
(``sched/journal.py``, falling back to the legacy rebuild when the journal
cannot produce a trustworthy base), else the legacy rebuild from the pod
store.
"""

from __future__ import annotations

import logging
import socket
from typing import Any, Optional

from tpukube_torch.apiserver import (
    ApiServerError,
    EvictionExecutor,
    PodLifecycleReleaseLoop,
    rebuild_extender,
)
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
from tpukube_torch.sched.extender import App, Extender, run_server, serve

log = logging.getLogger("tpukube_torch.sim")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _AppThread:
    """Serves an extender app (``make_app``/``make_probe_app``) on
    ``host:port`` between start() and stop(); ``ssl_context`` serves TLS,
    the path the extender daemon takes with ``--tls-cert``."""

    def __init__(self, app: App, host: str, port: int, ssl_context=None):
        self._app = app
        self._host = host
        self._port = port
        self._ssl = ssl_context
        self._server = None

    def start(self) -> None:
        self._server = run_server(self._app, self._host, self._port,
                                  ssl_context=self._ssl)

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class _PodStoreApi:
    """The apiserver surface EvictionExecutor, PodLifecycleReleaseLoop,
    the bind effector and the restart rebuild act through, over the
    harness's in-memory pod store (no PDBs in the sim: every eviction is
    accepted and deletes at once). ``nodes_fn`` supplies Node objects for
    ``list_nodes`` (the restart's topology source)."""

    def __init__(self, pods: dict[str, dict[str, Any]],
                 nodes_fn=None) -> None:
        self._pods = pods
        self._nodes_fn = nodes_fn

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

    def list_nodes(self) -> list[dict[str, Any]]:
        return self._nodes_fn() if self._nodes_fn is not None else []

    def bind_pod(
        self, namespace: str, name: str, node: str,
        annotations: Optional[dict[str, str]] = None,
    ) -> None:
        """FakeApiServer.bind_pod semantics over the dict store:
        conflict check first, already-bound-to-the-same-node is
        idempotent-retry success (what makes torn bind writes safe to
        retry), 404 when the pod is gone."""
        key = f"{namespace}/{name}"
        pod = self._pods.get(key)
        if pod is None:
            raise ApiServerError(f"pod {key} not found", code=404)
        spec = pod.setdefault("spec", {})
        bound_to = spec.get("nodeName")
        if bound_to and bound_to != node:
            raise ApiServerError(
                f"pod {key} is already bound to {bound_to!r}, "
                f"not {node!r}", code=409,
            )
        if annotations:
            pod["metadata"].setdefault("annotations", {}).update(annotations)
        spec["nodeName"] = node

    def patch_pod_annotations(
        self, namespace: str, name: str, annotations: dict[str, Optional[str]]
    ) -> None:
        """Merge-patch (None deletes), 404 on a missing pod — mirrors
        the real channel so reconcile/divergence paths run unchanged."""
        key = f"{namespace}/{name}"
        pod = self._pods.get(key)
        if pod is None:
            raise ApiServerError(f"pod {key} not found", code=404)
        annos = pod["metadata"].setdefault("annotations", {})
        for k, v in annotations.items():
            if v is None:
                annos.pop(k, None)
            else:
                annos[k] = v


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
        in_process: bool = False,
        cached_node_body: bool = False,
    ):
        """Single-slice by default (``mesh``, else the config's sim mesh);
        pass ``slices`` (slice id -> MeshSpec) for a multi-slice cluster —
        node names are then prefixed "<slice>-host-i-j-k" so they stay
        unique cluster-wide. ``clock`` (core/clock.py) threads an
        injectable — typically a FakeClock — through the gang TTLs.
        ``transport`` is the device plugin's, for ``execute_allocation``:
        "grpc" or "inprocess". ``in_process=True`` starts no HTTP
        listener (webhooks always dispatch straight into
        ``Extender.handle``). ``cached_node_body=True``: once the
        extender has ingested the node set, webhooks send
        ``{"NodesCached": true}`` instead of re-listing every node name,
        and the extender expands the candidate set from its own cache."""
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown plugin transport {transport!r}")
        self.transport = transport
        self._in_process = in_process
        self._cached_node_body = cached_node_body
        self.config = config or load_config(env={})
        self.clock = clock if clock is not None else SYSTEM
        if slices is not None and mesh is not None:
            raise ValueError("pass either mesh or slices, not both")
        # the dynamic lock-order detector must be live BEFORE the
        # extender (and its gang/ledger locks) is constructed below;
        # install is ref-counted, so a cluster inside an outer
        # lockgraph.monitor() shares that monitor. A constructor that
        # fails later must unwind the install (stop() never runs for a
        # half-built cluster) — a leaked patch would silently wrap every
        # lock of the port for the rest of the process.
        self.lock_monitor = None
        self._lock_monitor_installed = False
        if self.config.lock_monitor:
            from tpukube_torch.analysis import lockgraph

            self.lock_monitor = lockgraph.install()
            self._lock_monitor_installed = True
        try:
            self._init_cluster(mesh, vtpu_nodes, slices, vtpu_shares)
        except BaseException:
            self._uninstall_lock_monitor()
            raise

    def _init_cluster(self, mesh, vtpu_nodes, slices, vtpu_shares) -> None:
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
        if (self.config.planner_replicas > 1
                or self.config.shard_transport == "subprocess"):
            # Slice-partitioned control plane (sched/shard.py): N full
            # planner replicas behind the router, each owning a
            # disjoint slice set. The router speaks the Extender
            # decision surface, so everything downstream (effectors,
            # schedulers, chaos checkers) runs unchanged. With
            # shard_transport=subprocess each replica is a spawned
            # worker daemon (at N=1 too: the process mode's parity and
            # throughput baseline), reached over HTTP.
            from tpukube_torch.sched.shard import ShardRouter

            self.extender: Any = ShardRouter(self.config,
                                             clock=self.clock)
        else:
            self.extender = Extender(self.config, clock=self.clock)
        self.pods: dict[str, dict[str, Any]] = {}  # key -> pod object
        # stats of the last restart_extender() recovery (None before)
        self.last_recovery: Optional[dict[str, Any]] = None
        self._store_api = self._make_store_api()
        self._wire_extender()
        self._http = None  # the extender's HTTP server while started
        # the port served on, kept across crash_extender() so a restart
        # resumes serving where clients already point
        self._serving_port: Optional[int] = None
        # node objects cached per node (schedule() resends every node on
        # every webhook); fault injection invalidates the touched node
        self._node_obj_cache: dict[str, dict[str, Any]] = {}
        self._node_objs_list: Optional[list[dict[str, Any]]] = None
        # the node set the extender has ingested error-free, and its
        # names-only body (see _extender_node_args)
        self._synced_objs: list[dict[str, Any]] = []
        self._synced_names: list[str] = []

    def _uninstall_lock_monitor(self) -> None:
        """Undo this cluster's install of the lock-order monitor (once):
        the process-wide threading patch must not outlive the cluster."""
        if self._lock_monitor_installed:
            from tpukube_torch.analysis import lockgraph

            lockgraph.uninstall()
            self._lock_monitor_installed = False

    def _make_store_api(self):
        """The apiserver surface the effectors run against; the chaos
        harness overrides this to wrap it in a fault injector."""
        return _PodStoreApi(self.pods, nodes_fn=self.node_objects)

    def _wire_extender(self) -> None:
        """Attach the effectors a real extender daemon wires (eviction
        executor, lifecycle release loop, PDB precheck) to
        ``self.extender`` over the pod store, stepped deterministically
        by this harness instead of run as threads — called at
        construction AND after a restart_extender() cold start, exactly
        like a fresh daemon main. The chaos harness extends this with
        binder/retry/circuit wiring."""
        store_api = self._store_api
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

    def advance(self, seconds: float) -> None:
        """Advance the injected fake clock (discrete-event time). Raises
        on a real clock — a sim that thinks it is compressing time while
        actually sleeping wall time is a silent lie."""
        advance = getattr(self.clock, "advance", None)
        if advance is None:
            raise RuntimeError(
                "advance() needs a FakeClock (pass clock=FakeClock())"
            )
        advance(seconds)
        fan = getattr(self.extender, "advance_replicas", None)
        if fan is not None:
            fan(seconds)

    def start(self) -> None:
        """Serve the extender's HTTP app (webhooks, /healthz, /metrics
        with the executor's and lifecycle loop's counters) on 127.0.0.1;
        nothing for an ``in_process`` cluster."""
        if self._in_process:
            return
        if (self.config.planner_replicas > 1
                or self.config.shard_transport == "subprocess"):
            raise RuntimeError(
                "a sharded SimCluster (planner_replicas > 1) runs "
                "in_process=True — the in-process router is the "
                "sim/bench plane; production replicas serve as "
                "separate extender daemons"
            )
        if self._http is None:
            try:
                self._serve()
            except BaseException:
                # __enter__ raising means __exit__/stop() never runs:
                # the threading patch must not outlive the failed start
                self._uninstall_lock_monitor()
                raise

    def _serve(self) -> None:
        self._http = serve(self.extender, "127.0.0.1",
                           self._serving_port or 0,
                           evictions=self._evictions,
                           lifecycle=self._lifecycle)
        self._serving_port = self._http.server_address[1]

    def _stop_serving(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None

    def stop(self) -> None:
        """Stop serving, then close the trace and event sinks and the
        journal (their drain threads), and unwind the lock-order monitor
        this cluster installed."""
        try:
            self._stop_serving()
            shutdown = getattr(self.extender, "shutdown", None)
            if shutdown is not None:
                shutdown()  # ShardRouter: closes every replica's sinks
            else:
                if self.extender.trace is not None:
                    self.extender.trace.close()
                if self.extender.capacity is not None:
                    self.extender.capacity.close()
                self.extender.events.close()
                if self.extender.journal is not None:
                    self.extender.journal.close()
                    self.extender.state.retire()
            self._serving_port = None
        finally:
            # the process-wide threading patch must unwind even when a
            # sink close raises (full disk)
            self._uninstall_lock_monitor()

    def __enter__(self) -> "SimCluster":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- replica chaos (sharded plane) -----------------------------------------
    def _router(self):
        from tpukube_torch.sched.shard import ShardRouter

        if not isinstance(self.extender, ShardRouter):
            raise RuntimeError(
                "replica chaos needs a sharded cluster "
                "(planner_replicas > 1)"
            )
        return self.extender

    def crash_replica(self, idx: int) -> None:
        """Kill ONE planner replica: its in-memory shard state —
        ledger, reservations, queue, plans — is gone, nothing flushed;
        the router keeps serving around it and the rendezvous janitor
        aborts any uncommitted rendezvous holding a part there."""
        self._router().kill_replica(idx)

    def partition_replica(self, idx: int) -> None:
        """Partition ONE replica away from the router (state survives,
        unreachable); ``heal_replica`` ends the partition."""
        self._router().partition_replica(idx)

    def heal_replica(self, idx: int) -> None:
        self._router().heal_replica(idx)

    def restart_replica(self, idx: int) -> int:
        """Restart a killed replica the way a restarted shard daemon
        does: fresh Extender, warm from its journal segment when the
        journal is on, else its node subset re-ingested and its ledger
        + gangs rebuilt from the pod store's annotations
        (``rebuild_from_pods``). Returns allocations restored."""
        from tpukube_torch.apiserver import live_alloc_pods

        router = self._router()
        node_annos = [
            (obj["metadata"]["name"], obj["metadata"]["annotations"])
            for obj in self.node_objects()
            if router._node_replica.get(obj["metadata"]["name"]) == idx
        ]
        # the SAME lifecycle filter every restart path applies:
        # terminal-phase pods' annotation residue must not be restored
        full_pods = router.replica_pods(idx, self.pods)
        pods = [
            annotations for annotations, _alloc, _key in
            live_alloc_pods(full_pods)
        ]
        # the full pod objects ride along so a journal-enabled replica
        # can replay its own segment (warm restart) and reconcile
        # against the same truth the cold rebuild would consume
        return router.restart_replica(idx, node_annos, pods,
                                      pod_objects=full_pods)

    # -- crash / cold restart (chaos scenarios 9 and 13) ----------------------
    def crash_extender(self) -> None:
        """Simulate extender process death mid-flight: the HTTP listener
        disappears and every piece of in-memory scheduler state — ledger,
        gang reservations, pending webhook context, queued evictions — is
        gone. Nothing is flushed or unwound; that is the point."""
        if (self.config.planner_replicas > 1
                or self.config.shard_transport == "subprocess"):
            raise RuntimeError(
                "sharded cluster: crash/restart individual replicas "
                "(crash_replica/restart_replica), not the whole plane"
            )
        self._stop_serving()
        if self.extender.journal is not None:
            # a real crash loses the journal's queued-but-undrained
            # records and flushes nothing — crash() models exactly
            # that; retiring the ledger stops its background warmer
            self.extender.journal.crash()
            self.extender.state.retire()

    def restart_extender(self) -> int:
        """Cold-start a fresh extender the way a restarted daemon does:
        new Extender, state recovered — via the durable journal
        (checkpoint + WAL replay + O(Δ) apiserver reconcile,
        sched/journal.py) when journal_enabled, else the legacy full
        rebuild from the apiserver (apiserver.rebuild_extender) —
        effectors re-wired, HTTP serving resumed on the same port if the
        crashed one served. ``self.last_recovery`` carries the recovery
        stats. Returns the number of allocations restored/known after
        recovery."""
        if self._http is not None:
            raise RuntimeError("crash_extender() first — the old "
                               "extender is still serving")
        self.extender = Extender(self.config, clock=self.clock)
        self._wire_extender()
        if self.extender.journal is not None:
            from tpukube_torch.sched import journal as journal_mod

            try:
                self.last_recovery = journal_mod.recover_extender(
                    self.extender, self._store_api
                )
                restored = len(self.extender.state.allocations())
            except journal_mod.JournalError as e:
                # the journal could not produce a trustworthy base
                # (WAL gap, undecodable checkpoint): fall back to the
                # legacy full rebuild on a FRESH extender — the failed
                # recovery may have half-restored state
                log.error("journal recovery failed (%s); falling back "
                          "to the legacy full rebuild", e)
                self.extender.journal.crash()
                self.extender = Extender(self.config, clock=self.clock)
                self._wire_extender()
                self.extender.state.set_journal(None)
                self.extender.gang.set_journal(None)
                restored = rebuild_extender(self.extender,
                                            self._store_api)
                self.extender.state.set_journal(self.extender.journal)
                self.extender.gang.set_journal(self.extender.journal)
                self.extender.journal.write_checkpoint_sync(
                    self.extender.checkpoint_doc()
                )
                self.last_recovery = {
                    "mode": "cold-fallback", "error": str(e),
                    "restored_allocs": restored,
                }
        else:
            restored = rebuild_extender(self.extender, self._store_api)
            self.last_recovery = {"mode": "cold",
                                  "restored_allocs": restored}
        # the fresh extender has ingested nothing over the webhook
        # channel yet: the next schedule() must send full node objects
        self._commit_synced([])
        if self._serving_port is not None:
            self._serve()
        return restored

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
            if self._cached_node_body:
                # NodesCached mode: the extender expands the candidate
                # set from its own cache — the body names no nodes
                return {"NodesCached": True}, None
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

    def schedule_pending(
        self, pods: list[dict[str, Any]], retries: int = 4
    ) -> dict[str, tuple[str, AllocResult]]:
        """Batch-drive many pending pods through the scheduling-cycle
        planner (requires ``batch_enabled``): admit them all into the
        extender's queue, run planning cycles, then issue each pod's
        /bind against the planned node — the protocol's one mandatory
        per-pod step (the commitment + annotation write-back). The
        planner already computed every pod's filter/prioritize answer;
        pods whose plan failed (lost races, victims terminating) requeue
        for another round. Returns pod key -> (node, alloc); raises if
        any pod stays unschedulable after ``retries`` rounds."""
        ext = self.extender
        if ext.cycle is None:
            raise RuntimeError("schedule_pending needs batch_enabled=true")
        self._sync_nodes()
        # the router's batched driver surface (admit_many / planned_many /
        # bind_many): one fanned-out call per replica per round instead
        # of one dispatch per pod — over processes a per-pod HTTP round
        # trip would hand the router's cost the whole multi-core win
        # back. A plain Extender has none: the per-pod path is the same
        # protocol.
        admit_many = getattr(ext, "admit_many", None)
        planned_many = getattr(ext, "planned_many", None)
        bind_many = getattr(ext, "bind_many", None)
        results: dict[str, tuple[str, AllocResult]] = {}
        remaining = list(pods)
        for _ in range(retries):
            if not remaining:
                break
            self.drain_evictions()
            infos = [kube.pod_from_k8s(obj) for obj in remaining]
            if admit_many is not None:
                admit_many(infos)
            else:
                for info in infos:
                    ext.admit(info)
            ext.plan_pending()
            keys = [f"{o['metadata']['namespace']}/"
                    f"{o['metadata']['name']}" for o in remaining]
            if planned_many is not None:
                planned = planned_many(keys)
            else:
                planned = {k: ext.planned_node(k) for k in keys}
            still: list[dict[str, Any]] = []
            bind_objs: list[dict[str, Any]] = []
            bind_bodies: list[dict[str, Any]] = []
            for obj, key in zip(remaining, keys):
                meta = obj["metadata"]
                node = planned.get(key)
                if node is None:
                    still.append(obj)
                    continue
                body = {
                    "PodName": meta["name"],
                    "PodNamespace": meta["namespace"],
                    "PodUID": meta["uid"],
                    "Node": node,
                }
                if bind_many is not None:
                    bind_objs.append(obj)
                    bind_bodies.append(body)
                    continue
                bres = self._post("/bind", body)
                if bres.get("Error"):
                    still.append(obj)
                    continue
                self._apply_bind(obj, node, bres, results)
            if bind_bodies:
                for obj, body, bres in zip(bind_objs, bind_bodies,
                                           bind_many(bind_bodies)):
                    if bres.get("Error"):
                        still.append(obj)
                        continue
                    self._apply_bind(obj, body["Node"], bres, results)
            remaining = still
        if remaining:
            names = [o["metadata"]["name"] for o in remaining[:3]]
            raise RuntimeError(
                f"{len(remaining)} pod(s) unschedulable after {retries} "
                f"batch rounds (first: {names})"
            )
        return results

    def _apply_bind(self, obj: dict[str, Any], node: str,
                    bres: dict[str, Any],
                    results: dict[str, tuple[str, AllocResult]]) -> None:
        """The apiserver role for one successful bind answer: persist
        the alloc annotation + nodeName on the pod object and record
        the result."""
        meta = obj["metadata"]
        meta.setdefault("annotations", {}).update(
            bres.get("Annotations", {})
        )
        obj["spec"]["nodeName"] = node
        key = f"{meta['namespace']}/{meta['name']}"
        results[key] = (node, codec.decode_alloc(
            meta["annotations"][codec.ANNO_ALLOC]
        ))

    def _sync_nodes(self) -> None:
        """Push node annotations through one recorded ``upsert_nodes``
        decision (the nodeCacheCapable out-of-band refresh): the batch
        driver skips /filter webhooks, which are how node topology
        normally reaches the extender. Identity-cached like
        ``_extender_node_args`` — an unchanged node set costs nothing."""
        objs = self.node_objects()
        synced = self._synced_objs
        if len(objs) == len(synced) and all(
            a is b for a, b in zip(objs, synced)
        ):
            return
        items = [{
            "name": obj["metadata"]["name"],
            "annotations": obj["metadata"]["annotations"],
        } for obj in objs]
        answers = self.extender.upsert_nodes_many(items)
        for item, res in zip(items, answers):
            if isinstance(res, dict) and res.get("error"):
                raise RuntimeError(
                    f"node sync failed for {item['name']}: "
                    f"{res['error']}"
                )
        self._commit_synced(objs)

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

    # -- fleet elasticity ----------------------------------------------------
    def add_slice(self, slice_id: str, mesh: MeshSpec) -> list[dict[str, Any]]:
        """Mint the nodes of a NEW slice into the harness's world
        (node names are always "<slice>-<host>" prefixed so they stay
        unique cluster-wide) and return their ``upsert_nodes`` items —
        the autoscaler's provisioner feeds these straight to the
        extender; a webhook-driven cluster picks them up on the next
        full node send. The extender learns nothing here."""
        if slice_id in self.slices:
            raise ValueError(f"slice {slice_id!r} already exists")
        self.slices[slice_id] = mesh
        self._prefixed = True
        self.mesh = (next(iter(self.slices.values()))
                     if len(self.slices) == 1 else None)
        items: list[dict[str, Any]] = []
        for host in mesh.all_hosts():
            name = f"{slice_id}-{host}"
            if name in self.nodes:
                raise ValueError(f"node {name!r} already exists")
            chips = [
                ChipInfo(
                    chip_id=f"{name}-chip-{i}",
                    index=i,
                    coord=coord,
                    hbm_bytes=self.config.hbm_bytes_per_chip,
                    num_cores=self.config.cores_per_chip,
                )
                for i, coord in enumerate(mesh.coords_of_host(host))
            ]
            info = NodeInfo(name=name, chips=chips, shares_per_chip=1,
                            slice_id=slice_id)
            self.nodes[name] = info
            items.append({
                "name": name,
                "annotations": codec.annotate_node(info, mesh),
            })
        self._node_objs_list = None
        return items

    def forget_nodes(self, names) -> list[str]:
        """Drop nodes from the harness's world AFTER a drain
        un-ingested them from the extender — the node objects stop
        riding webhook sends, so the next full sync cannot silently
        re-register decommissioned capacity. Slices left empty are
        forgotten too. Returns the names actually dropped."""
        dropped: list[str] = []
        touched: set[str] = set()
        for name in names:
            info = self.nodes.pop(name, None)
            if info is None:
                continue
            dropped.append(name)
            touched.add(info.slice_id)
            self._node_obj_cache.pop(name, None)
        for sid in touched:
            if not any(i.slice_id == sid for i in self.nodes.values()):
                self.slices.pop(sid, None)
        if dropped:
            self._node_objs_list = None
            self.mesh = (next(iter(self.slices.values()))
                         if len(self.slices) == 1 else None)
        return dropped

    def remove_slice(self, slice_id: str) -> list[str]:
        """``forget_nodes`` for one whole slice (the scale-down /
        maintenance bookkeeping after its drain completes)."""
        return self.forget_nodes([
            n for n, i in self.nodes.items() if i.slice_id == slice_id
        ])

    def make_slice_provisioner(self, mesh: MeshSpec, prefix: str = "as"):
        """An :class:`~tpukube_torch.sched.autoscale.Autoscaler` provisioner
        closure: each call mints one fresh slice of ``mesh`` geometry
        (ids "<prefix>1", "<prefix>2", ...) and returns its upsert
        items — the sim stand-in for a cloud instance API."""
        import itertools

        counter = itertools.count(1)

        def provision() -> list[dict[str, Any]]:
            sid = f"{prefix}{next(counter)}"
            while sid in self.slices:
                sid = f"{prefix}{next(counter)}"
            return self.add_slice(sid, mesh)

        return provision

    # -- metrics ------------------------------------------------------------
    def utilization(self) -> float:
        return self.extender.state.utilization()
