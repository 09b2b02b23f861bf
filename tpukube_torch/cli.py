"""The port's daemons and tools, as users start them — the port's own copy
of ``tpukube/cli.py``::

    python -m tpukube_torch.cli plugin    node agent: NVML discovery, the
                                          v1beta1 device plugin over gRPC,
                                          health watch, /metrics, the node
                                          annotation file
    python -m tpukube_torch.cli syncer    applies that file to the Node
                                          object through the apiserver
    python -m tpukube_torch.cli extender  the scheduler extender daemon
                                          (webhooks, /state, /trace,
                                          /events, /statusz, /metrics;
                                          TLS, mTLS, bearer token, probe
                                          port)
    python -m tpukube_torch.cli sim N     one BASELINE scenario, one JSON
                                          line
    python -m tpukube_torch.cli ctl ...   inspect a live extender (topo,
                                          alloc, gangs, metrics) and
                                          replay a trace
    python -m tpukube_torch.cli obs ...   timeline / events over captures

The reference reaches its syncer only through the installed
``tpukube-syncer`` script; the port is run from a checkout, so the
dispatch below names ``syncer`` too.

Every command takes ``--config <yaml>`` (the config file subset
``tpukube_torch.core.config.read_yaml`` reads) and honours the
``TPUKUBE_*`` environment over it. Importing this module, and running
``extender``, ``syncer``, ``sim``, ``ctl`` or ``obs``, loads none of
grpc, protobuf, a YAML parser, aiohttp or torch: only ``plugin`` reaches
gRPC (the kubelet speaks it), inside its body.

With ``journal_enabled`` the ``extender`` daemon recovers its ledger and
gangs from the durable journal before serving (checkpoint + WAL tail +
the apiserver reconcile, ``sched/journal.py``) and falls back to the
full rebuild from the apiserver when the journal cannot produce a
trustworthy base.

``obs capacity`` renders a capacity flight-recorder capture (one file,
or several per-replica files with ``--merge``) or a live ``/capacity``
(``--url``; ``--probe-count``/``--probe-shape`` ask ``/capacity/probe``
instead) as a sparkline, csv or json.

``obs explain <pod>`` answers why one pod is placed, pending, denied,
preempted or released, from a live extender's ``/explain`` (``--url``,
with ``--token-file`` for a bearer-gated one) or a ``decisions_path`` sink
capture (``--file``); ``--json`` prints the raw document. It exits 1 for
a pod with no provenance. The ``extender`` daemon closes the provenance
sink on SIGTERM, so a capture holds every stage.

``obs timeline --merge`` stitches the shard router's trace capture and
each replica's into one Chrome trace.

``shard-worker --config F --port P`` is one planner replica of the
sharded plane as a daemon (``sched/shardworker.py``): the process the
shard router's ``SubprocessTransport`` spawns per replica. With ``--port
0`` it binds a free port and reports it on its first stdout line. The
``extender`` daemon refuses ``planner_replicas > 1``, as the reference's
does.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import sys
import threading
import urllib.request
from typing import Any, Optional

from tpukube_torch.core.config import GpuKubeConfig, load_config

log = logging.getLogger("tpukube_torch.cli")


def _base_parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description)
    p.add_argument("--config", metavar="YAML", default=None,
                   help="config file (GpuKubeConfig fields); TPUKUBE_* env "
                        "wins")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="-v info, -vv debug")
    return p


def _setup(args: argparse.Namespace) -> GpuKubeConfig:
    level = (logging.WARNING, logging.INFO, logging.DEBUG)[min(args.verbose, 2)]
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s",
    )
    return load_config(yaml_path=args.config)


def _add_kube_api_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--kube-api", metavar="URL", default=None,
                   help="Kubernetes apiserver base URL (default: in-cluster "
                        "KUBERNETES_SERVICE_HOST; 'off' disables the "
                        "apiserver channel)")
    p.add_argument("--kube-token-file", default=None,
                   help="bearer token file (default: serviceaccount token)")
    p.add_argument("--kube-ca-file", default=None,
                   help="apiserver CA bundle (default: serviceaccount ca.crt)")


def _make_apiserver(args: argparse.Namespace, cfg: GpuKubeConfig,
                    journal=None):
    """The REST channel from flags / the in-cluster env, under the
    config's retry policy and circuit breaker, or None when no apiserver
    is configured (sim/dev runs). ``journal`` receives the channel's
    RetryExhausted/CircuitOpen/CircuitClosed events."""
    if args.kube_api == "off":
        return None
    from tpukube_torch.apiserver import ApiServerError, rest_apiserver_from_config

    try:
        return rest_apiserver_from_config(
            cfg, base_url=args.kube_api, token_path=args.kube_token_file,
            ca_path=args.kube_ca_file, journal=journal)
    except ApiServerError as e:
        if args.kube_api:  # explicitly requested: a configuration error
            raise
        log.info("no apiserver channel (%s); running standalone", e)
        return None


def _install_stop_handlers() -> threading.Event:
    """Install SIGINT/SIGTERM handlers NOW (before any serving starts, so
    a supervisor's early TERM still shuts down cleanly); returns the
    event the main thread waits on. The handler only sets the event: the
    main thread then stops the servers (a server's ``shutdown()`` from
    its own serving thread would deadlock)."""
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    return stop


# -- plugin -------------------------------------------------------------------

def main_plugin(argv: Optional[list[str]] = None) -> int:
    p = _base_parser("tpukube-plugin", "GPU node agent / device plugin daemon")
    p.add_argument("--socket", default=None,
                   help="override plugin unix socket path")
    p.add_argument("--no-register", action="store_true",
                   help="serve without dialing the kubelet (sim/debug)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics on this port (0 = ephemeral)")
    p.add_argument("--annotation-out", metavar="FILE", default="-",
                   help="write the node-topology annotation JSON here "
                        "('-' = stdout); the syncer applies it")
    _add_kube_api_args(p)
    args = p.parse_args(argv)
    cfg = _setup(args)
    stop = _install_stop_handlers()

    import os

    from tpukube_torch.core import codec
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.metrics import MetricsServer, render_plugin_metrics
    from tpukube_torch.obs.events import EventJournal
    from tpukube_torch.obs.health import HealthSampler
    from tpukube_torch.obs.statusz import plugin_statusz
    from tpukube_torch.plugin.server import (
        DevicePluginServer,
        HealthWatcher,
        KubeletSessionWatcher,
    )

    host = os.environ.get("NODE_NAME")
    if host and cfg.backend == "sim" and not cfg.sim_host_origin:
        # the sim backend derives this host's coord origin from the
        # host-i-j-k naming convention; a free-form node name needs
        # TPUKUBE_SIM_HOST_ORIGIN, and without it the default host name
        # is kept rather than crashing at startup
        try:
            cfg.sim_mesh().host_origin(host)
        except ValueError:
            log.warning("NODE_NAME %r is not host-i-j-k and sim_host_origin "
                        "is unset; using the default sim host name", host)
            host = None
    with GpuDeviceManager(cfg, host=host) as device:
        server = DevicePluginServer(cfg, device, socket_path=args.socket)
        server.start()

        def write_annotation() -> None:
            # re-run on every health/link transition so the scheduler
            # (through the syncer's Node PATCH) sees faults, not just the
            # kubelet. Atomic publish through a per-writer temp file and
            # a rename: the syncer polls this file from another process.
            import tempfile

            payload = json.dumps(codec.annotate_node(device.node_info(),
                                                     device.mesh))
            if args.annotation_out == "-":
                print(payload, flush=True)
                return
            out_dir = os.path.dirname(os.path.abspath(args.annotation_out))
            fd, tmp_path = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
            try:
                # mkstemp files are 0600; the syncer sidecar may run as
                # another user
                os.fchmod(fd, 0o644)
                with os.fdopen(fd, "w") as f:
                    f.write(payload + "\n")
                os.replace(tmp_path, args.annotation_out)
            except BaseException:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
                raise

        # the first emit BEFORE the watcher starts: one writer at a time
        write_annotation()
        journal = EventJournal(capacity=cfg.events_capacity,
                               path=cfg.events_path or None,
                               max_sink_bytes=cfg.events_sink_max_bytes)
        server.events = journal
        sampler = HealthSampler(device, journal=journal)
        sampler.start()
        watcher = HealthWatcher(device, server, on_transition=write_annotation)
        watcher.start()
        kubelet_watch = None
        if not args.no_register:
            kubelet_watch = KubeletSessionWatcher(server)
            kubelet_watch.events = journal

        # the extender <-> kubelet device-id loop: bound pods' planned
        # allocations steer GetPreferredAllocation, divergent kubelet
        # choices are reported back onto the pod
        intent_watch = None
        api = _make_apiserver(args, cfg, journal=journal)
        if api is not None:
            from tpukube_torch.apiserver import (
                AllocIntentWatcher,
                alloc_divergence_reporter,
            )

            server.set_alloc_reporter(alloc_divergence_reporter(api))
            intent_watch = AllocIntentWatcher(
                api, device.host, server, poll_seconds=cfg.health_poll_seconds)
            intent_watch.start()

        metrics = MetricsServer(
            lambda: render_plugin_metrics(
                server, health=watcher, kubelet_watch=kubelet_watch,
                intent_watch=intent_watch, sampler=sampler, events=journal,
            ),
            port=args.metrics_port,
            statusz=lambda: plugin_statusz(
                server, device=device, health=watcher,
                kubelet_watch=kubelet_watch, intent_watch=intent_watch,
                sampler=sampler, events=journal,
            ),
        )
        metrics.start()

        if kubelet_watch is not None:
            try:
                # jittered backoff under the retry policy; the session
                # watcher's poll-cadence retry is the outer safety net
                kubelet_watch.retrier.journal = journal
                kubelet_watch.retrier.call(server.register_with_kubelet)
            except Exception as e:
                # kubelet not up yet (a DaemonSet boot race): the session
                # watcher registers on a later poll
                log.warning("initial kubelet registration failed (%s); the "
                            "session watcher will retry", e)
                kubelet_watch.mark_unregistered()
            kubelet_watch.start()
        log.warning("plugin serving %s on %s (metrics :%d)",
                    server.resource_name, server.socket_path, metrics.port)
        try:
            stop.wait()
        finally:
            if intent_watch is not None:
                intent_watch.stop()
            if kubelet_watch is not None:
                kubelet_watch.stop()
            watcher.stop()
            sampler.stop()
            journal.close()
            metrics.stop()
            server.stop()
    return 0


# -- syncer -------------------------------------------------------------------

def main_syncer(argv: Optional[list[str]] = None) -> int:
    """Annotation syncer sidecar: applies the node agent's annotation file
    to the Node object through the apiserver."""
    import os

    p = _base_parser(
        "tpukube-syncer",
        "apply the node agent's annotation file to the Node via the apiserver",
    )
    p.add_argument("--annotation-file", metavar="FILE", required=True,
                   help="the plugin's --annotation-out file to watch")
    p.add_argument("--node", default=None,
                   help="Node object name (default: $NODE_NAME)")
    p.add_argument("--poll", type=float, default=5.0,
                   help="file poll interval seconds")
    p.add_argument("--once", action="store_true",
                   help="apply once and exit (init-container mode)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics on this port (0 = disabled)")
    _add_kube_api_args(p)
    args = p.parse_args(argv)
    cfg = _setup(args)
    node = args.node or os.environ.get("NODE_NAME")
    if not node:
        p.error("--node or $NODE_NAME required")

    from tpukube_torch.apiserver import NodeAnnotationSyncer

    api = _make_apiserver(args, cfg)
    if api is None:
        p.error("no apiserver: pass --kube-api or run in-cluster")
    syncer = NodeAnnotationSyncer(api, node, args.annotation_file,
                                  poll_seconds=args.poll)
    if args.once:
        return 0 if syncer.check_once() else 1
    stop = _install_stop_handlers()
    syncer.start()
    metrics = None
    if args.metrics_port:
        from tpukube_torch.metrics import MetricsServer, render_syncer_metrics

        metrics = MetricsServer(lambda: render_syncer_metrics(syncer),
                                port=args.metrics_port)
        metrics.start()
    log.warning("syncing %s -> node %s", args.annotation_file, node)
    try:
        stop.wait()
    finally:
        if metrics is not None:
            metrics.stop()
        syncer.stop()
    return 0


# -- extender -----------------------------------------------------------------

def main_extender(argv: Optional[list[str]] = None) -> int:
    p = _base_parser("tpukube-extender", "scheduler extender HTTP daemon")
    p.add_argument("--host", default=None, help="override extender_host")
    p.add_argument("--port", type=int, default=None,
                   help="override extender_port")
    # /bind mutates the ledger and runs preemption, /state and /trace
    # disclose placement: the surface must not serve anonymous callers.
    #   mTLS   (--tls-cert/--tls-key/--tls-client-ca): the TLS layer
    #          refuses peers without a CA-signed client certificate, as
    #          kube-scheduler's extender tlsConfig speaks.
    #   bearer (--auth-token-file): a token on every route but /healthz
    #          and /metrics, for ctl and proxies that inject it.
    p.add_argument("--tls-cert", default=None, metavar="PEM",
                   help="serve HTTPS with this certificate chain")
    p.add_argument("--tls-key", default=None, metavar="PEM",
                   help="private key for --tls-cert")
    p.add_argument("--tls-client-ca", default=None, metavar="PEM",
                   help="require client certs signed by this CA (mTLS)")
    p.add_argument("--auth-token-file", default=None, metavar="FILE",
                   help="require 'Authorization: Bearer <token>' matching "
                        "this file's content on all non-probe routes")
    p.add_argument("--probe-port", type=int, default=0, metavar="PORT",
                   help="serve /healthz and /metrics ONLY on this extra "
                        "plain-HTTP port (needed with --tls-client-ca: "
                        "kubelet probes and Prometheus cannot present "
                        "client certs; 0 = disabled)")
    _add_kube_api_args(p)
    args = p.parse_args(argv)
    cfg = _setup(args)

    if cfg.planner_replicas > 1:
        # the slice-partitioned plane (sched/shard.py) deploys as ONE
        # extender daemon per replica — each with its slice set and
        # journal segment — behind the routing contract the in-process
        # ShardRouter defines; a single daemon asked to be N replicas
        # would shard nothing (one process, one GIL, one failure
        # domain)
        p.error(
            "planner_replicas > 1 is a deployment topology, not a "
            "daemon flag: run one `tpukube-shard-worker` per replica "
            "behind the router webhook front (deploy/README's "
            "multi-daemon sketch; the in-process ShardRouter serves "
            "the sim/bench plane — `tpukube-sim 14`)"
        )

    ssl_ctx = None
    if args.tls_cert or args.tls_key:
        import ssl

        if not (args.tls_cert and args.tls_key):
            p.error("--tls-cert and --tls-key must be given together")
        ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_ctx.load_cert_chain(args.tls_cert, args.tls_key)
        if args.tls_client_ca:
            ssl_ctx.load_verify_locations(args.tls_client_ca)
            ssl_ctx.verify_mode = ssl.CERT_REQUIRED
    elif args.tls_client_ca:
        p.error("--tls-client-ca requires --tls-cert/--tls-key")
    auth_token = None
    if args.auth_token_file:
        with open(args.auth_token_file) as f:
            auth_token = f.read().strip()
        if not auth_token:
            p.error(f"--auth-token-file {args.auth_token_file} is empty")
    stop = _install_stop_handlers()

    from tpukube_torch.sched.extender import (
        Extender,
        make_app,
        make_probe_app,
        run_probe_server,
        run_server,
    )

    host = args.host or cfg.extender_host
    port = args.port if args.port is not None else cfg.extender_port
    extender = Extender(cfg)
    loops: list = []
    reconcile = evictions = node_refresh = lifecycle = pod_informer = None
    api = _make_apiserver(args, cfg, journal=extender.events)
    if api is not None:
        from tpukube_torch.apiserver import (
            AllocReconcileLoop,
            EvictionExecutor,
            NodeTopologyRefreshLoop,
            PodAdmissionFeed,
            PodInformer,
            PodLifecycleReleaseLoop,
            pod_binder,
            rebuild_extender,
        )

        # the restart story: reconstruct the ledger and gang
        # reservations BEFORE serving, or a restarted extender re-plans
        # GPUs that already run someone's containers. With
        # journal_enabled the durable journal recovers
        # O(Δ-since-checkpoint) (checkpoint + WAL replay + apiserver
        # reconcile); a journal that cannot produce a trustworthy base
        # falls back to the O(fleet) rebuild on a FRESH extender —
        # degraded, never wrong.
        recovered = False
        if extender.journal is not None:
            from tpukube_torch.sched.journal import (
                JournalError,
                recover_extender,
            )

            try:
                rstats = recover_extender(extender, api)
                log.warning(
                    "journal recovery: %d allocation(s) known after "
                    "checkpoint+replay+reconcile (%d record(s) "
                    "replayed, %.3fs)",
                    len(extender.state.allocations()),
                    rstats["replayed"], rstats["recovery_s"],
                )
                recovered = True
            except JournalError as e:
                log.error("journal recovery failed (%s); falling back "
                          "to the legacy full rebuild", e)
                extender.journal.crash()
                extender = Extender(cfg)
                api = _make_apiserver(args, cfg, journal=extender.events)
        # nodeCacheCapable webhooks carry names only: without this loop,
        # health/link faults would never reach the node cache (built
        # before the rebuild so the rebuild can prime it)
        node_refresh = NodeTopologyRefreshLoop(
            extender, api, poll_seconds=cfg.health_poll_seconds)
        if recovered:
            # prime the refresh loop with the recovered node payloads
            # (its first poll must not re-dispatch every unchanged
            # upsert_node decision)
            for name in extender.state.node_names():
                view = extender.state.node(name)
                if view is not None:
                    node_refresh.note_applied(name, view.raw_payload)
        else:
            if extender.journal is not None:
                # detach while the O(fleet) rebuild runs: every one of
                # its commits would otherwise serialize a WAL record
                # the checkpoint below immediately truncates away
                extender.state.set_journal(None)
                extender.gang.set_journal(None)
            restored = rebuild_extender(extender, api,
                                        refresh=node_refresh)
            if restored:
                log.warning("rebuilt %d allocation(s) from the "
                            "apiserver", restored)
            if extender.journal is not None:
                # fallback rebuilds still end at a durable point so the
                # NEXT restart recovers warm
                extender.state.set_journal(extender.journal)
                extender.gang.set_journal(extender.journal)
                extender.journal.write_checkpoint_sync(
                    extender.checkpoint_doc()
                )
        # with bindVerb delegated here, the extender must create the real
        # Binding: kube-scheduler won't
        extender.binder = pod_binder(api)
        extender.api_retrier = api.retrier
        extender.api_circuit = api.circuit
        if api.circuit is not None and api.circuit.enabled:
            # degraded mode: while the apiserver circuit is open, fail
            # filter/bind safe
            extender.degraded_gate = (
                lambda: ("apiserver circuit open"
                         if api.circuit.is_open() else None))

        # the PDB precheck (a dry-run Eviction POST): a preemption plan
        # with a PDB-blocked victim is refused before any eviction
        def _precheck(pod_key: str):
            namespace, name = pod_key.split("/", 1)
            return api.evict_pod(namespace, name, dry_run=True)

        extender.evict_precheck = _precheck
        reconcile = AllocReconcileLoop(
            extender, api, poll_seconds=cfg.health_poll_seconds)
        evictions = EvictionExecutor(extender, api)
        lifecycle = PodLifecycleReleaseLoop(extender, api, evictions=evictions)
        informer_children = [lifecycle, reconcile]
        if cfg.batch_enabled:
            informer_children.append(PodAdmissionFeed(
                extender, api, poll_seconds=cfg.health_poll_seconds))
        # ONE pod stream for all pod loops
        pod_informer = PodInformer(api, informer_children,
                                   poll_seconds=cfg.health_poll_seconds)
        node_refresh.journal = extender.events
        pod_informer.journal = extender.events
        loops = [evictions, node_refresh, pod_informer]
        for loop in loops:
            loop.start()
    if ssl_ctx is None and auth_token is None:
        log.warning(
            "extender serving WITHOUT transport or bearer auth: anyone "
            "reaching this port can bind pods and run preemption; use "
            "--tls-cert/--tls-key (+ --tls-client-ca for mTLS) or "
            "--auth-token-file outside of dev/sim")
    if args.tls_client_ca and not args.probe_port:
        log.warning(
            "mTLS without --probe-port: kubelet httpGet probes and "
            "Prometheus scrapes cannot present client certificates and "
            "will be refused at the handshake")
    stop_probe = None
    server = None
    try:
        if args.probe_port:
            stop_probe = run_probe_server(
                make_probe_app(extender, reconcile=reconcile,
                               evictions=evictions, node_refresh=node_refresh,
                               lifecycle=lifecycle),
                host, args.probe_port)
        server = run_server(
            make_app(extender, reconcile=reconcile, evictions=evictions,
                     node_refresh=node_refresh, lifecycle=lifecycle,
                     auth_token=auth_token, informer=pod_informer),
            host, port, ssl_context=ssl_ctx)
        log.warning("extender serving on %s:%d (score_mode=%s, tls=%s, "
                    "mtls=%s, bearer=%s, probe_port=%d)",
                    host, server.server_address[1], cfg.score_mode,
                    ssl_ctx is not None, bool(args.tls_client_ca),
                    auth_token is not None, args.probe_port)
        stop.wait()
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        if stop_probe is not None:
            stop_probe()
        for loop in loops:
            loop.stop()
        # drain the capture sinks so a post-mortem read sees every event
        if extender.trace is not None:
            extender.trace.close()
        if extender.decisions is not None:
            extender.decisions.close()
        if extender.capacity is not None:
            extender.capacity.close()
        extender.events.close()
        if extender.journal is not None:
            # drain the queued WAL records before exit (a SIGKILL loses
            # them, which is what recovery's reconcile absorbs)
            extender.journal.close()
    return 0


# -- sim ----------------------------------------------------------------------

def main_sim(argv: Optional[list[str]] = None) -> int:
    p = _base_parser(
        "tpukube-sim",
        "run a BASELINE config scenario against the real control-plane stack",
    )
    p.add_argument("scenario", type=int, choices=range(1, 16),
                   help="BASELINE scenario number")
    args = p.parse_args(argv)
    cfg = _setup(args)

    from tpukube_torch.sim import scenarios

    # dynamic lock-order detection (tpukube_torch.analysis.lockgraph):
    # the config flag wraps every Lock/RLock the port creates for the
    # whole scenario run, whatever topology the scenario itself loads,
    # and the result JSON gains the acquisition-order graph + any
    # deadlock cycles. Off by default — zero overhead unless asked for.
    monitor = None
    if cfg.lock_monitor:
        from tpukube_torch.analysis import lockgraph

        monitor = lockgraph.install()
    try:
        # without --config each scenario uses its canonical BASELINE
        # topology; with it, the user's topology/config drives it
        result = scenarios.run(args.scenario, cfg if args.config else None)
    finally:
        if monitor is not None:
            from tpukube_torch.analysis import lockgraph

            lockgraph.uninstall()
    if monitor is not None:
        result["lock_graph"] = monitor.report()
        if result["lock_graph"]["cycles"]:
            log.error("lock-order cycles detected: %s",
                      result["lock_graph"]["cycles"])
    print(json.dumps(result))
    return 1 if monitor is not None and monitor.cycles() else 0


# -- obs ----------------------------------------------------------------------

def _since_arg(text: str) -> float:
    """argparse type for ``--since``: epoch seconds, a bare relative
    number, or a suffixed duration (15m, 2h, 90s, 1d) — the shared
    parser lives in tpukube_torch.obs.capacity."""
    from tpukube_torch.obs.capacity import parse_since

    try:
        return parse_since(text)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def main_obs(argv: Optional[list[str]] = None) -> int:
    """Offline observability tooling: ``timeline`` converts a JSONL
    decision trace to Chrome trace-event JSON (Perfetto-loadable per-pod
    scheduling timelines); ``events`` queries an event-journal capture
    (the events_path sink, or an /events dump saved one JSON object per
    line) with pod/node/reason/since filters; ``capacity`` renders the
    capacity flight recorder (a capture or a live /capacity) and asks
    /capacity/probe; ``explain`` answers why-pending / why-here /
    why-denied for one pod from a live /explain or a provenance sink;
    ``slo`` evaluates the burn-rate SLOs against a live /metrics endpoint
    or a captured snapshot (exit 1 while any SLO burns at page rate)."""
    p = argparse.ArgumentParser(
        prog="tpukube-obs",
        description="offline observability tooling (timeline / events / "
                    "capacity / explain / slo)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    tp = sub.add_parser(
        "timeline",
        help="convert a JSONL decision trace (trace_path capture, or a "
             "/trace dump) to Chrome trace-event JSON")
    tp.add_argument("trace_file", nargs="+",
                    help="JSONL capture(s); pass several with --merge "
                         "(the router's .router sink plus each "
                         "replica's own capture)")
    tp.add_argument("-o", "--out", default="-", metavar="FILE",
                    help="output file ('-' = stdout)")
    tp.add_argument("--merge", action="store_true",
                    help="stitch several per-process captures into ONE "
                         "Chrome trace: one process lane per file "
                         "(named for it), a shared time zero, and the "
                         "router's fan-out spans rendered as true "
                         "wall-clock slices enclosing the replica spans "
                         "they fanned out to")
    tp.add_argument("--stats", action="store_true",
                    help="also print per-phase timing stats (JSON) to stderr")

    ep = sub.add_parser(
        "events", help="query a JSONL event-journal capture (events_path sink)")
    ep.add_argument("events_file")
    ep.add_argument("--pod", default=None, help="filter by pod key")
    ep.add_argument("--node", default=None, help="filter by node name")
    ep.add_argument("--reason", default=None,
                    help="filter by reason (e.g. ChipUnhealthy)")
    ep.add_argument("--replica", default=None,
                    help="filter by source replica of a federated dump")
    ep.add_argument("--since", type=_since_arg, default=None, metavar="T",
                    help="absolute unix timestamp, a relative duration "
                         "(15m, 2h, 90s, 1d), or a bare number < 1e9 = "
                         "seconds before the newest event in the capture")
    ep.add_argument("--json", action="store_true", dest="as_json",
                    help="one JSON object per event instead of text lines")

    cp = sub.add_parser(
        "capacity",
        help="render a capacity flight-recorder capture or a live "
             "/capacity endpoint (sparkline / csv / json)",
    )
    cp.add_argument("capacity_file", nargs="*",
                    help="capacity_path JSONL capture(s); pass several "
                         "with --merge (one per replica)")
    cp.add_argument("--url", default=None,
                    help="live extender base URL (reads /capacity)")
    cp.add_argument("--token-file", default=None, metavar="FILE",
                    help="bearer token file for an --auth-token-file "
                         "extender (/capacity sits behind its auth)")
    cp.add_argument("--merge", action="store_true",
                    help="stitch several per-replica captures into one "
                         "fleet view (each file becomes a replica lane "
                         "named for it)")
    cp.add_argument("--since", type=_since_arg, default=None,
                    metavar="T",
                    help="absolute unix timestamp, a relative duration "
                         "(15m, 2h), or a bare number < 1e9 = seconds "
                         "before the newest sample")
    cp.add_argument("--format", default="sparkline",
                    choices=("sparkline", "csv", "json"),
                    help="output rendering (default: sparkline)")
    cp.add_argument("--probe-count", type=int, default=None,
                    metavar="N",
                    help="with --url: what-if probe for N contiguous "
                         "chips (/capacity/probe) instead of the "
                         "recorder document")
    cp.add_argument("--probe-shape", default=None, metavar="XxYxZ",
                    help="with --url: what-if probe for a shaped box "
                         "(e.g. 4x4x4)")

    xp = sub.add_parser(
        "explain",
        help="why-pending / why-here / why-denied for one pod, from "
             "the decision-provenance layer (decisions_enabled)",
    )
    xp.add_argument("pod",
                    help="pod key (namespace/name; a bare name means "
                         "default/<name>)")
    xsrc = xp.add_mutually_exclusive_group(required=True)
    xsrc.add_argument("--url", default=None,
                      help="live extender base URL (reads /explain)")
    xsrc.add_argument("--file", default=None, metavar="JSONL",
                      help="decisions_path JSONL sink capture to "
                           "assemble offline")
    xp.add_argument("--token-file", default=None, metavar="FILE",
                    help="bearer token file for an --auth-token-file "
                         "extender (/explain sits behind its auth)")
    xp.add_argument("--json", action="store_true", dest="as_json",
                    help="raw explain document instead of text")

    sp = sub.add_parser(
        "slo",
        help="evaluate the latency SLOs (burn rates) from /metrics",
    )
    src = sp.add_mutually_exclusive_group(required=True)
    src.add_argument("--url", default=None,
                     help="live /metrics endpoint to scrape")
    src.add_argument("--snapshot", default=None, metavar="FILE",
                     help="captured /metrics text to evaluate offline")
    sp.add_argument("--window", type=float, default=0.0, metavar="SECONDS",
                    help="with --url: scrape twice this far apart and "
                         "report the windowed burn rate (0 = single "
                         "scrape, lifetime burn)")
    args = p.parse_args(argv)

    if args.cmd == "timeline":
        import os as os_mod

        from tpukube_torch import trace as trace_mod
        from tpukube_torch.obs import timeline

        if len(args.trace_file) > 1 and not args.merge:
            p.error("multiple trace files require --merge")
        if args.merge:
            captures = [
                (os_mod.path.basename(path), trace_mod.load(path))
                for path in args.trace_file
            ]
            text = json.dumps(timeline.merged_chrome_trace(captures),
                              sort_keys=True) + "\n"
            if args.out == "-":
                sys.stdout.write(text)
            else:
                with open(args.out, "w") as f:
                    f.write(text)
            if args.stats:
                merged = [e for _, evs in captures for e in evs]
                print(json.dumps(timeline.phase_stats(merged),
                                 indent=2), file=sys.stderr)
            return 0
        events = trace_mod.load(args.trace_file[0])
        if args.out == "-":
            timeline.dump_chrome_trace(events, sys.stdout)
        else:
            with open(args.out, "w") as f:
                timeline.dump_chrome_trace(events, f)
        if args.stats:
            print(json.dumps(timeline.phase_stats(events), indent=2),
                  file=sys.stderr)
        return 0

    if args.cmd == "slo":
        return _obs_slo(args)
    if args.cmd == "capacity":
        return _obs_capacity(p, args)
    if args.cmd == "explain":
        return _obs_explain(args)

    from tpukube_torch.obs import events as events_mod

    evs = events_mod.load(args.events_file)
    since = args.since
    if since is not None and since < 1e9:
        newest = max((float(e.get("last_ts", 0)) for e in evs
                      if isinstance(e, dict)), default=0.0)
        since = newest - since
    evs = events_mod.filter_events(
        evs, reason=args.reason, pod=args.pod, node=args.node,
        since=since, replica=args.replica)
    for ev in evs:
        if args.as_json:
            print(json.dumps(ev, sort_keys=True))
        else:
            print(events_mod.format_event(ev))
    return 0


def _obs_explain(args: argparse.Namespace) -> int:
    """``obs explain``: one pod's provenance document from a live
    /explain (``--url``) or a sink capture (``--file``), as text or
    ``--json``. Exit 1 for a pod with no provenance (unsampled, rotated
    out, or provenance off), so the command composes into scripts."""
    from urllib.parse import quote

    from tpukube_torch.obs import decisions as decisions_mod

    pod = args.pod if "/" in args.pod else f"default/{args.pod}"
    if args.url:
        req = urllib.request.Request(
            f"{args.url}/explain?pod={quote(pod, safe='/')}")
        if args.token_file:
            with open(args.token_file) as f:
                req.add_header("Authorization", f"Bearer {f.read().strip()}")
        with urllib.request.urlopen(req, timeout=10) as r:
            doc = json.loads(r.read())
    else:
        doc = decisions_mod.explain_doc(decisions_mod.load(args.file), pod)
    if args.as_json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        print(decisions_mod.format_explain(doc))
    return 0 if doc.get("stages") else 1


def _obs_capacity(p: argparse.ArgumentParser, args) -> int:
    """``obs capacity``: a live /capacity (or /capacity/probe) with
    ``--url``, else one capture file or several with ``--merge``."""
    import os

    from tpukube_torch import trace as trace_mod
    from tpukube_torch.obs import capacity as capacity_mod

    if args.url:
        if args.capacity_file:
            p.error("--url and capture files are exclusive")

        def fetch(path: str) -> dict:
            req = urllib.request.Request(f"{args.url}{path}")
            if args.token_file:
                with open(args.token_file) as f:
                    req.add_header("Authorization",
                                   f"Bearer {f.read().strip()}")
            with urllib.request.urlopen(req, timeout=10) as r:
                return json.loads(r.read())

        if args.probe_count is not None or args.probe_shape:
            q = (f"count={args.probe_count}"
                 if args.probe_count is not None
                 else f"shape={args.probe_shape}")
            doc = fetch(f"/capacity/probe?{q}")
            print(json.dumps(doc, indent=2, sort_keys=True))
            # composes into scripts: exit 0 only when the demand fits
            # somewhere (contiguous or via the DCN fallback)
            return 0 if (doc.get("fits")
                         or (doc.get("dcn") or {}).get("fits")) else 1
        since = f"?since={args.since}" if args.since is not None else ""
        print(capacity_mod.format_capacity(
            fetch(f"/capacity{since}"), args.format))
        return 0
    if not args.capacity_file:
        p.error("a capture file or --url is required")
    if args.probe_count is not None or args.probe_shape:
        p.error("--probe-count/--probe-shape need --url (a probe runs "
                "against a live snapshot)")
    if len(args.capacity_file) > 1 and not args.merge:
        p.error("multiple capture files require --merge")
    since = args.since
    if args.merge:
        per = [(os.path.basename(path), {"samples": trace_mod.load(path)})
               for path in args.capacity_file]
        doc = capacity_mod.merge_capacity_docs(per)
    else:
        doc = {"samples": trace_mod.load(args.capacity_file[0])}
    samples = doc.get("samples") or []
    if since is not None:
        if since < 1e9:
            newest = max((float(s.get("ts", 0.0)) for s in samples),
                         default=0.0)
            since = newest - since
        doc["samples"] = [s for s in samples
                          if float(s.get("ts", 0.0)) >= since]
    print(capacity_mod.format_capacity(doc, args.format))
    return 0


def _obs_slo(args: argparse.Namespace) -> int:
    """``obs slo``: DEFAULT_SLOS' burn rates as JSON, from one snapshot
    (lifetime burn) or two scrapes ``--window`` seconds apart."""
    import time as time_mod

    from tpukube_torch.obs import slo as slo_mod

    def scrape(url: str) -> str:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.read().decode()

    if args.snapshot:
        with open(args.snapshot) as f:
            text = f.read()
        result = slo_mod.evaluate(text)
    elif args.window > 0:
        first = scrape(args.url)
        time_mod.sleep(args.window)
        second = scrape(args.url)
        result = slo_mod.evaluate(second, prev_text=first,
                                  window_seconds=args.window)
    else:
        result = slo_mod.evaluate(scrape(args.url))
    print(json.dumps(result, indent=2, sort_keys=True))
    # exit non-zero when any SLO is burning at page rate, so the
    # command composes into scripts/CI gates
    burning = any(("page" in v["alerts"]) for v in result.values())
    return 1 if burning else 0


# -- ctl ----------------------------------------------------------------------

def _fetch(server: str, path: str, token: Optional[str] = None,
           ssl_ctx=None) -> Any:
    req = urllib.request.Request(f"{server}{path}")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=10, context=ssl_ctx) as r:
        body = r.read()
    if path == "/metrics":
        return body.decode()
    return json.loads(body)


def _ctl_ssl_context(args: argparse.Namespace):
    """Client-side TLS for a secured extender (the server's two modes):
    --cacert pins the serving cert, --cert/--key presents the client
    certificate mTLS demands."""
    if args.key and not args.cert:
        raise SystemExit("--key requires --cert")
    if not (args.cacert or args.cert):
        return None
    import ssl

    ctx = ssl.create_default_context(cafile=args.cacert)
    if args.cert:
        if not args.key:
            raise SystemExit("--cert requires --key")
        ctx.load_cert_chain(args.cert, args.key)
    return ctx


def _render_topo(topo: dict[str, Any], out) -> None:
    """ASCII occupancy map: one grid per z-plane per slice, one cell per
    GPU (coords are slice-local)."""
    glyph = {"free": ".", "allocated": "#", "reserved": "+", "unhealthy": "X"}
    # mesh_dims is null on a multi-slice cluster (each slice header
    # carries its dims instead)
    mesh = (f"mesh {topo['mesh_dims']}  " if topo.get("mesh_dims") else "")
    print(
        f"{mesh}util {topo['utilization_percent']}%  "
        f"alloc {topo['chips_allocated']}/{topo['chips_total']}  "
        f"reserved {topo['chips_reserved_unbound']}  "
        f"unhealthy {topo['chips_unhealthy']}",
        file=out,
    )
    slices = topo.get("slices") or []
    multi = len(slices) > 1
    for sl in slices:
        dx, dy, dz = sl["mesh_dims"]
        grid = {}
        for node in topo["nodes"]:
            if node["slice"] != sl["id"]:
                continue
            for chip in node["chips"]:
                x, y, z = chip["coord"]
                grid[(x, y, z)] = glyph.get(chip["status"], "?")
        if multi:
            print(f"slice {sl['id']}  {sl['mesh_dims']}  "
                  f"util {sl['utilization_percent']}%", file=out)
        for z in range(dz):
            print(f"z={z}  ({glyph['free']} free {glyph['allocated']} alloc "
                  f"{glyph['reserved']} reserved {glyph['unhealthy']} "
                  f"unhealthy)", file=out)
            for y in range(dy):
                print("  " + " ".join(grid.get((x, y, z), " ")
                                      for x in range(dx)), file=out)
    # nodes whose inventory came from the static table instead of runtime
    # introspection: their memory/SM facts are guesses
    fallback = [n["name"] for n in topo["nodes"]
                if str(n.get("source", "")).startswith("table")]
    if fallback:
        print(f"table-fallback nodes: {', '.join(sorted(fallback))}",
              file=out)


def main_ctl(argv: Optional[list[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="tpukubectl",
        description="inspect a live extender / replay decision traces",
    )
    p.add_argument("--server", default="http://127.0.0.1:12345",
                   help="extender base URL (https:// for a TLS extender)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="raw JSON output")
    p.add_argument("--token-file", default=None, metavar="FILE",
                   help="bearer token file for an --auth-token-file extender")
    p.add_argument("--cacert", default=None, metavar="PEM",
                   help="CA bundle pinning the extender's serving cert")
    p.add_argument("--cert", default=None, metavar="PEM",
                   help="client certificate for an mTLS extender")
    p.add_argument("--key", default=None, metavar="PEM",
                   help="private key for --cert")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("topo", help="cluster topology + occupancy map")
    sub.add_parser("alloc", help="committed allocations")
    sub.add_parser("gangs", help="live gang reservations")
    sub.add_parser("metrics", help="prometheus metrics dump")
    rp = sub.add_parser("replay", help="replay a JSONL decision trace and "
                                       "report determinism divergences")
    rp.add_argument("trace_file")
    rp.add_argument("--config", default=None,
                    help="config YAML for the scratch scheduler")
    args = p.parse_args(argv)

    if args.cmd == "replay":
        from tpukube_torch import trace as trace_mod

        cfg = load_config(yaml_path=args.config)
        events = trace_mod.load(args.trace_file)
        divergences = trace_mod.replay(events, config=cfg)
        if not divergences:
            print(f"replay ok: {len(events)} events, 0 divergences")
            return 0
        for d in divergences:
            print(d)
        return 1

    token = None
    if args.token_file:
        with open(args.token_file) as f:
            token = f.read().strip()
    data = _fetch(args.server, {
        "topo": "/state/topology",
        "alloc": "/state/allocs",
        "gangs": "/state/gangs",
        "metrics": "/metrics",
    }[args.cmd], token=token, ssl_ctx=_ctl_ssl_context(args))
    if args.cmd == "metrics":
        sys.stdout.write(data)
        return 0
    if args.as_json:
        print(json.dumps(data, indent=2))
        return 0
    if args.cmd == "topo":
        _render_topo(data, sys.stdout)
    elif args.cmd == "alloc":
        if not data:
            print("no allocations")
        for a in data:
            print(f"{a['pod']:40s} {a['node']:16s} prio={a['priority']:<4d} "
                  f"{','.join(a['devices'])}")
    elif args.cmd == "gangs":
        if not data:
            print("no gang reservations")
        for g in data:
            state = "committed" if g["committed"] else "assembling"
            chips = sum(len(cs) for cs in g["slices"].values())
            where = "+".join(sorted(g["slices"]))
            gate = ""
            if g.get("victims_terminating"):
                gate = (f" [waiting on {g['victims_terminating']} "
                        f"terminating victim(s)]")
            elif g.get("victims_pending"):
                gate = (f" [{g['victims_pending']} preemption victim(s) "
                        f"planned, not yet evicted]")
            print(f"{g['namespace']}/{g['group']:24s} {state:10s} "
                  f"{g['members_bound']}/{g['min_member']} bound "
                  f"prio={g['priority']} chips={chips} in {where}{gate}")
    return 0


def main_shard_worker(argv: Optional[list[str]] = None) -> int:
    from tpukube_torch.sched.shardworker import main_worker

    return main_worker(argv)


TOOLS = {
    "plugin": main_plugin,
    "syncer": main_syncer,
    "extender": main_extender,
    "shard-worker": main_shard_worker,
    "sim": main_sim,
    "ctl": main_ctl,
    "obs": main_obs,
}


def main(argv: Optional[list[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in TOOLS:
        print(f"usage: python -m tpukube_torch.cli {{{'|'.join(TOOLS)}}} ...",
              file=sys.stderr)
        return 2
    return TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
