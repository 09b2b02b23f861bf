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
   and checks shape, finiteness, loss, causality and card-vs-CPU parity;
   the served forwards launch the attention kernel once a layer each
   (``attention_launches``, 32 x 3). Meanwhile a ``HealthSampler`` on the node agent samples NVML telemetry
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
   and 3 timed steps; the loss must fall, the four steps must launch the
   GroupNorm pair's four kernels for each of the 49 norms, and one step at
   batch 2 on 64x64 images must agree with the CPU (which runs the plain
   GroupNorm);
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
12. the Kubernetes REST channel: every effect below crosses HTTP to the
   stand-in apiserver ``tpukube_torch.sim.kube_rest`` (a ``FakeApiServer``
   on 127.0.0.1, bearer token) through ``RestApiServer`` and the loops of
   ``tpukube_torch.apiserver``, all in watch mode:
   a. the stand-in holds this machine's Node object (no topology yet) and a
      pending ``qiniu.com/tpu: 1`` pod ``default/rest-0``;
   b. the node agent (real backend) publishes its annotation file
      atomically; ``NodeAnnotationSyncer`` merge-patches it onto the Node;
   c. the extender learns the node only through
      ``NodeTopologyRefreshLoop``'s node watch (its webhooks get node names
      only, as a nodeCacheCapable extender's do); file write -> applied, ms;
   d. ``sched/client.py`` runs the cycle over HTTP with
      ``extender.binder = pod_binder(api)``: the stand-in's pod must end
      bound to this node with the alloc annotation, through
      ``POST .../binding``;
   e. ``AllocIntentWatcher`` (this node's field selector) must put
      ``default/rest-0 -> [tpu-0]`` into the plugin's intents (bind response
      -> intent, ms); GetPreferredAllocation answers from it, the kubelet's
      Allocate gives the env, and ``--scheduled`` runs with it as a child:
      the env held against the alloc annotation, one Llama-3-8B request
      (B=2, S=2048) after the UUID check;
   f. the pod is marked ``Succeeded`` in the stand-in (the kubelet's part);
      ``PodLifecycleReleaseLoop``, a child of a ``PodInformer`` on the pod
      watch, must release ``tpu-0`` (phase -> release, ms); the pod is
      deleted through ``RestApiServer.delete_pod``, and a second pod must
      bind ``tpu-0``;
   g. a two-share node agent (sim backend): the extender plans
      ``frac0of2``, the kubelet's Allocate takes ``frac1of2``, the plugin's
      ``alloc_divergence_reporter`` writes the alloc-actual annotation over
      REST, and ``AllocReconcileLoop`` must fold it into the ledger, clear
      it and rewrite the alloc annotation; the extender's ``/metrics``
      counts the reconcile and both node refreshes, the plugin's page the
      intent-watch events;
   h. config 5 through the channel (host work, ``rest_fleet``): 16 Node
      objects learned by the refresh loop, 80 burst pods, then the
      64-member priority-100 gang, which must preempt and commit on 8 whole
      hosts, contiguous along y; every bind a Binding POST, every victim an
      Eviction POST from the ``EvictionExecutor``, confirmed by the
      lifecycle loop's DELETED events; the gang's pods deleted over REST
      and released by the lifecycle loop; a paged pod list;
   i. one ``rest:`` line: the times above (medians where they repeat), the
      gang's commit with the REST effector beside step 11a's, the
      stand-in's request counts by route (each route must be used);
13. the batch scheduling cycle (host work but d):
   a. BASELINE scenarios 1-6 through the port's ``scenarios.run`` with the
      in-process plugin transport, each run with batching off and then
      with ``TPUKUBE_BATCH_ENABLED=1``: the placement keys of the two runs
      must be equal, and scenario 5's utilization must reach the north
      star's 95%;
   b. scenario 10 at the reference's defaults: 1,024 nodes, 4,096 GPU
      slots, a 256-member gang, 100,000 pods on the fake clock;
   c. scenario 12 at the reference's defaults: 10,240 nodes, 40,960 slots,
      a 512-member gang, 40,000 pods, with the leak check and the
      snapshot-maintenance numbers; each drive raises on its own
      invariants (gang uncommitted, ledger divergence, leaked
      reservations, a pod shortfall); scenario 12's lifecycle resyncs
      ride the alloc change log: their incremental hit ratio must reach
      tools/perf_floor.json's ``coldstart.resync_hit_ratio_min``;
   d. one card pod from a batch plan, over the REST stand-in of step 12:
      an extender with batching on, its ``PodInformer`` carrying the
      lifecycle loop and a ``PodAdmissionFeed``; a pending
      ``default/batch-0`` pod must be admitted by the feed with no webhook
      sent and planned by ``plan_pending``; ``sched/client.py``'s webhooks
      are answered from the plan (``tpukube_cycle_plan_hits_total`` >= 1
      on ``/metrics``), the Binding POST binds it, the intent watch and
      the kubelet's Allocate give the env, and ``--scheduled`` serves one
      Llama-3-8B request (B=2, S=2048) on the card; the pod then ends and
      is released;
   e. one ``scenarios:`` line: per drive pods/s, wall and simulated
      seconds, webhook p99s, the plan-hit ratio, the snapshot's
      maintenance times (12), utilization; 13d's times; the host's CPU;
14. the daemons as users start them (``python -m tpukube_torch.cli``,
   children of this script), over the REST stand-in apiserver of step 12:
   a. openssl mints a CA, a server certificate (SAN 127.0.0.1) and a client
      certificate; a ``config.yaml`` like the deploy ConfigMap's, plus the
      fleet's geometry, with the trace and event sinks in a temp dir;
   b. the stand-in holds this machine's Node ``h100-0`` (no topology yet)
      and 1,024 annotated HGX Node objects of 8 GPUs (``8,1024,1`` /
      ``8,1,1``, scenario 10's 8,192 slots);
   c. the ``syncer`` daemon (``--annotation-file``, ``--node``,
      ``--kube-api``, ``--kube-token-file``, ``--poll 0.05``) patches the
      node agent's annotation file onto the Node: file write -> PATCH, ms;
   d. the ``extender`` daemon as deploy/extender-deployment.yaml starts it
      (``--config``, ``--tls-cert/--tls-key/--tls-client-ca``,
      ``--probe-port``): spawn -> the probe port's /healthz listing all
      1,025 nodes, learned through its rebuild (bulk ingest) and node
      watch; a client without a certificate fails its handshake; the
      probe port serves /healthz and /metrics (``tpukube_ingest_nodes_total``
      >= 1,025) and answers 404 on /state/topology;
   e. ``default/daemon-0`` (``qiniu.com/tpu: 1``) through /filter ->
      /prioritize -> /bind over mTLS (``sched/client.py`` with an
      ``ssl.SSLContext``, kube-scheduler's ``tlsConfig``): bound to this
      node by the daemon's Binding POST; the in-process intent watch and
      the kubelet's Allocate give the env, and ``--scheduled`` serves one
      Llama-3-8B request (B=2, S=2048) after the UUID check;
   f. a 256-member gang of ``qiniu.com/tpu: 1`` pods over mTLS with
      kube-scheduler's node names only: every member bound by the
      daemon's Binding POSTs, placed as the in-process ``SimCluster``
      places the same gang on the same fleet;
   g. ``ctl topo|alloc|gangs|metrics`` over mTLS as children, each exiting
      0; ``alloc`` lists daemon-0 on ``tpu-0`` and the 256 members,
      ``gangs`` the committed gang; /statusz shows both watch streams held
      and the trace's stats;
   h. SIGTERM: exit 0, and ``ctl replay`` of its JSONL trace finds no
      divergence; a second extender daemon rebuilds the same /state/allocs
      and /state/gangs; a new pod cannot take ``tpu-0`` until daemon-0 is
      ``Succeeded`` and the new daemon's lifecycle loop releases it;
   i. ``sim 5`` as a child prints one JSON line, utilization >= 95%;
   j. one ``daemons:`` line with the times (host clock);
15. crash and fault recovery:
   a. scenarios 8, 9 and 13 of the port at the reference's sizes, chaos
      seed 1337, every snapshot lookup audited: the seeded apiserver fault
      storm with the circuit's blackout, the extender crash mid-gang with
      the cold restart, and 8 crash cycles at the journal's seams (clean,
      lost tail, torn tail, corrupt tail, torn checkpoint) under the storm;
      each with zero leaked reservations, zero ledger divergence and zero
      audit divergences, the committed gang surviving every cycle;
   b. a second ``extender`` daemon as step 14 starts it, over a stand-in
      holding step 14's 1,025 Node objects, its config adding
      ``journal_enabled``, a ``journal_path`` in the temp dir and
      ``journal_fsync: always``: ``default/journal-0`` bound to ``tpu-0``,
      then a 64-member gang; after the 32nd member's /bind the daemon is
      SIGKILLed and restarted with the same config: it must recover warm
      (/statusz ``journal.last_recovery``: a checkpoint, records replayed),
      serve the same /state/allocs and /state/gangs, refuse ``tpu-0`` to a
      new pod while journal-0 lives; the other 32 members bind and the
      gang commits where the in-process ``SimCluster`` places it; the
      journal's /metrics families are read; journal-0 ends, is released,
      and ``default/journal-1`` bound to ``tpu-0`` runs ``--scheduled``
      (one Llama-3-8B request, B=2, S=2048, after the UUID check); a
      second SIGKILL, ``chaos.crash.tear_checkpoint`` on the checkpoint,
      and the restart must take the mode the port's ``recover_extender``
      takes on a copy of those files and serve the same allocations;
      SIGTERM exits 0;
   c. the ``recovery:`` and ``journal:`` lines (host clock);
16. the multi-tenant serving plane (``tpukube_torch/tenancy``, host work
   but b's pods):
   a. scenario 11 of the port at the reference's size (8 waves, seed 1337:
      four burst tenants' diurnal waves under quotas and scenario 8's
      fault storm, a committed training gang, a probe gang that preempts
      and burns the gang SLO) and scenario 7 (chip and link faults through
      a node agent's telemetry into the fleet rollup and the SLO
      evaluator), each held to the invariants the reference's tests
      assert: zero quota violations, a share ratio <= 2.0, both gangs
      committed, preemptions, every shed and denial journaled, no leak or
      divergence, steady utilization >= 90%; scenario 7's transitions,
      events and fleet rollups;
   b. an ``extender`` daemon as step 14 starts it, its config adding
      ``tenancy_enabled`` and ``tenancy_quotas`` (team-a half a card,
      team-b a card), over a stand-in holding this machine's Node,
      annotated by a two-share node agent on the card: ``team-a-0`` binds
      a share; ``team-a-1`` is refused at /filter by team-a's quota while
      the other share is free (``tpukube_tenancy_shedding`` 0 before it,
      a ``TenantQuotaDenied`` event, the denial counter at 1); ``team-b-0``
      binds the other share; each pod's env (the plugin's Allocate) names
      its tenant in ``TPU_KUBE_TENANT``, and the two serve Llama-3-8B
      (B=1, S=2048) at once under the guard as step 8's pods do, their
      ``meshenv`` reading the tenant back; while they run, /statusz and
      ``tpukube_tenant_chips_used`` show each tenant at half a card and
      ``obs slo --url`` exits 0; SIGTERM, and a restart with the same
      config shows the same tenants and allocations; ``team-a-0`` ends,
      is released, and ``team-a-1`` binds its share;
   c. the ``tenancy:`` line (host clock; the pods' times beside step 8's);
17. fleet elasticity and capacity forensics (``sched/drain.py``,
   ``sched/autoscale.py``, ``obs/capacity.py``, ``chaos/maintenance.py``;
   host work but b's pods):
   a. scenario 15 of the port, phases A, B and C (the maintenance storm
      of drains, crashes and spot kills on 4 slices of 4x4x1 with an
      8-member gang and 6 fillers, 6 cycles; the autoscaler's burst -> up
      -> idle -> down; one replica's slices drained under the shard
      router while the other restarts), seed 1337, every snapshot lookup
      audited, held to
      the reference's invariants: the gang all-or-nothing, zero leaks and
      divergences, no tick over the budget, every cordon surviving its
      crash; then one graceful drain of a resident-loaded 64-GPU slice
      under budget 2 (begin -> the slice leaves the ledger), and the bulk
      provisioning of a 10,240-node slice until its GPUs are free to the
      placement sweeps;
   b. ``drain_life``: an in-process extender with drain, capacity, the
      autoscaler (up at queue depth 1, one slice at least, no cooldown),
      batching and the journal, over step 12's REST stand-in, this
      machine's node annotated by the real-backend node agent:
      ``serve-0`` bound to ``tpu-0`` from a batch plan serves Llama-3-8B
      (B=1, S=2048) until evicted; ``drain.begin`` cordons the node
      (/statusz shows it); the tick evicts serve-0 through the
      ``EvictionExecutor`` (SIGTERM to its process, the pod deleted once
      it exited); ``serve-1`` arrives meanwhile and stays pending,
      stranded as ``draining`` on /capacity, a one-GPU probe fitting
      nowhere; the next tick un-ingests the node (``unnodes`` in the WAL,
      the ``tpukube_drain_*`` families on /metrics); the autoscaler sees
      serve-1 queued and provisions this machine's Node item (``up``);
      serve-1 is bound to ``tpu-0`` and serves alone (B=1, three
      requests); ``obs capacity --url`` exits 0; serve-1 ends and is
      released;
   c. the ``elasticity:`` line (host clock; serve-1's forward beside step
      8's two shared pods);
18. decision provenance (``obs/decisions.py``, the cycle's phase
   profiling, ``/explain``, ``obs explain``; host work but b's pods):
   a. the reference's decisions smoke on the port: scenario 12 at 10,240
      nodes and tools/perf_floor.json's 4,000 pods with
      ``TPUKUBE_DECISIONS_ENABLED=1`` at sample rate 1.0: records made,
      the record wall at most the file's ``overhead_pct_max`` (15%) of
      the drive's, and every bind equal to the same drive's with the
      plane off;
   b. ``explain_life``: an ``extender`` daemon as step 14 starts it,
      behind a bearer token, its config adding batching and
      ``decisions_enabled`` at sample rate 1.0 with a ``decisions_path``
      sink, over step 12's REST stand-in holding this machine's Node
      annotated by the real-backend node agent: ``why-0``, admitted by
      the feed and planned on its /filter, is bound to ``tpu-0`` from the
      plan and serves Llama-3-8B (B=1, S=2048) for three requests with
      the plugin's Allocate env; ``obs explain --url --token-file`` exits
      0 naming this node, the fast arm and the chain admit -> cycle_plan
      -> bind; ``why-1`` asks for one GPU while the card is taken: /filter
      refuses it with the node's pruning reason, and it explains as
      pending with a queue age above 0; /statusz shows
      ``decisions.enabled``, /metrics ``tpukube_decisions_total`` and
      every phase of ``tpukube_cycle_phase_seconds``; 100 /explain round
      trips are timed; why-0 ends and explains ``release``; why-1 binds
      ``tpu-0`` and serves one request; SIGTERM exits 0, and ``obs
      explain --file`` on the sink renders what the live route did;
   c. the ``provenance:`` line (host clock: the overhead with the
      drive's pods/s on and off, each phase's p50, the /explain median,
      why-0's forward beside step 8's two shared pods);
19. the sharded plane (``sched/shard.py``'s in-process router, the
   incremental resync log; host work but c's pods):
   a. the reference's shard smoke on the port: scenario 14 with 4 slices
      of 8x8x16 (1,024 nodes, 4,096 GPU slots) behind 2 planner
      replicas, tools/perf_floor.json's 6,000 pods; zero leaks, zero
      divergence and both replicas alive (the scenario raises
      otherwise), and pods/s at least the file's ``shard`` floor;
   b. the acceptance fleet: scenario 14 at its defaults, 10 slices of
      32x32x40 (102,400 nodes, 409,600 slots) behind 4 replicas, the
      pods cut from 40,000 to 6,000; the one-time ingest reported apart
      as ``setup_s``;
   c. ``shard_life``: an in-process ``ShardRouter`` (2 replicas, batching,
      provenance at rate 1.0, the journal in per-replica segments) over
      step 12's REST stand-in and its loops, holding this machine's Node
      (annotated by the real-backend node agent) and a sim HGX host of 8
      GPUs, each its own slice, on different replicas: a 9-member DCN
      gang of one-GPU pods goes through the two-phase rendezvous (8 on
      the sim host, 1 on ``tpu-0``) and commits; the card member's env
      (its annotation and the plugin's Allocate) carries the global gang
      env and it serves Llama-3-8B (B=1, S=2048) for three requests; its
      stitched ``router.explain`` shows the router's route and rendezvous
      stages and its replica's chain through bind; while it serves, the
      card's replica is killed (``shard-x`` not placed, the dead
      replica's pods out of the federated ledger) and restarted warm from
      its journal segment with the member back on ``tpu-0``, zero leaked
      reservations, zero divergence; the lifecycle's next resync is a
      full read, the next incremental; the gang's end reaches each
      replica as one ``release_many``; ``shard-x`` binds ``tpu-0`` and
      serves one request; ``router_statusz`` and the federated /metrics
      show both replicas, the committed rendezvous and the resync
      counters;
   d. the ``shard:`` line (host clock: a's and b's pods/s, b's setup, the
      /filter median through the router beside the replica's, the
      rendezvous' prepare -> commit, kill -> restart -> ready, the resync
      counters, the member's forward beside step 18's why-0);
20. the process-parallel sharded plane, every replica a ``shard-worker``
   daemon (``SubprocessTransport``); first the live threads and child
   processes of this process are printed, then in a fresh interpreter
   (``shard_proc_child``, so nothing earlier steps left running shares
   its interpreter lock):
   a. tools/check.sh's process-mode smoke: scenario 14's drive on 4
      slices of 8x8x16, host block 2,2,1 (1,024 nodes), the ``shard_mp``
      block's 6,000 pods, a 128-gang, at most 2,048 alive, at N=1 and N=2
      workers; N=2 at least the block's 800 pods/s, the parallel
      efficiency at least 0.55 where ``schedulable_cores`` (affinity and
      cgroup quota) counts 3 or more;
   b. the wire codec: a mixed workload placed the same with ``wire_codec``
      json and binary, TKW1 frames moved, the 1,024-node drive at audit
      rate 1.0 at the ``wire`` block's bytes-per-wave ratio (3.0), and the
      micro point's encode / decode µs and size ratio;
   c. ``shard_proc_life``: step 19c's DCN gang and card member over two
      worker daemons, the bind effector applied by the router from each
      bind answer (the member's annotation carries the global gang env);
      the card's worker SIGKILLed while the member serves and a fresh one
      restarted warm from its journal segment with the federated state
      as before the kill; shard-x placed after; the router's listener
      serving federated /metrics, /statusz and the member's stitched
      /explain citing both replicas over HTTP; no worker left alive;
   d. the ``shard_proc:`` line (spawn -> ready, replica RTTs, wire bytes
      and ratios, health checks, N=1/N=2 pods/s and efficiency with the
      cores counted, kill -> respawn -> ready, the member's forward, the
      parent's threads and children, the step's and the run's seconds);
   ``shard_proc_phase(card, c0, prov, t_start)`` runs step 20 alone;
21. the lint prover and the lock-order monitor (``tpukube_torch/analysis``),
   in a fresh interpreter (``analysis_child``, so nothing earlier steps
   left running shares its interpreter lock or its threading patch):
   a. ``python -m tpukube_torch.analysis <checkout>/tpukube_torch`` three
      times, each a fresh process, two from the checkout and one from
      ``/``: each exits 0 with ``tpukube-lint: clean``, and their median
      wall is at most tools/perf_floor.json's ``lint_wall_s_floor`` x
      ``allowed_regression``; ``--list-rules`` names the 13 rules; a
      seeded tree (the lock-discipline fixture as ``sched/gang.py``, a
      rules file reading ``tpukube_nonexistent_total``) exits 1 with
      exactly those findings; ``--rules made-up-rule`` exits 2; the
      rules-file cross-check reads deploy/prometheus-rules.yaml's
      expressions without a YAML library; an in-process ``run_all`` is
      clean;
   b. scenarios 1-7 with the monitor off, under ``lockgraph.monitor()``,
      and off again: no cycle, more than 1,000 acquisitions, the extender
      -> gang and gang -> state edges, the threading factories restored
      after;
   c. ``lockgraph_life``: step 20's 1,024-node fleet behind two
      ``shard-worker`` daemons with ``lock_monitor`` on in the config the
      router and both workers read, 384 pods placed from batch plans;
      this machine's Node (the real-backend node agent's annotation)
      ingested by the router and a one-GPU pod bound to ``tpu-0``, its
      env the plugin's Allocate, serving Llama-3-8B (B=1, S=2048) for
      one request; the router's ``lockgraph_report()`` and its listener's
      ``GET /lockgraph`` both show r0 and r1 reporting, no cycle and
      acquisitions; no worker left alive;
   d. the ``lint:`` line (each clean run's wall, the median and the gate,
      files, lines, rules, findings, the rule expressions read, the
      seeded findings by rule, the monitor's counts with the scenarios'
      walls on and off, the federated report, the member's forward, the
      step's seconds); ``analysis_phase(card, t_start)`` runs step 21
      alone;
22. ``dryrun_multichip(4, device="cpu")``: both legs over gloo ranks, leg 2
   on a DCN gang env the port's extender mints on a two-slice sim fleet;
23. the GroupNorm kernel pair (``tpukube_torch/kernels/group_norm.py``), in a
   fresh interpreter on the allocated card (``kernels_phase``): at the
   ResNet cell's batch, 64, in bf16, at C=64 on 224², 256 on 224², 1024 on
   56² and 2048 on 28², the pair's output and the gradients of x, scale
   and bias against its plain version (``group_norm_plain``), the ReLU on
   and off, within the bounds ``norm_check`` states (one ulp plus 2**-18
   of the largest magnitude; the parameters' gradients 2**-18 of their
   terms' magnitudes; what the ReLU's edge can move), four launches a
   forward and backward; then each direction of both by CUDA
   events and each kernel's device time by the profiler, beside its byte
   bound; a line a shape, then the kernels line: each kernel's ms, its
   ``bound_ms`` and the plain version's ms for its direction;
24. the causal attention kernel (``tpukube_torch/kernels/attention.py``), in
   a fresh interpreter on the allocated card (``attention_phase``): at
   Mistral-7B's shape (32 heads over 8, d 128) and Moonlight-16B-A3B's (16
   heads, dq 192, dv 128, v a strided slice), 256, 1,385 and 4,096 tokens,
   the kernel and its plain version against an f32 computation of the same
   function, within the bounds ``attention_check`` states, one launch a
   call; then the kernel's device time a launch by the profiler beside its
   bound (FLOPs at 989 TFLOP/s, bytes at 3.35 TB/s), and by CUDA events the
   kernel, the chain and ``F.scaled_dot_product_attention`` (``library_ms``
   only; the port never calls it); a line a shape and length, then the
   ``attention`` line.

The last line is ``{"ok": true, "device": {...}}``. Any failed step (an
NCCL init, a child's exit, a check, any error of the REST channel) exits
non-zero and prints no result, and so does a run that imported ``grpc``,
``google.protobuf``, ``yaml`` or ``aiohttp``; without CUDA it exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import queue
import signal
import statistics
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

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


def place_pods(node: dict, pods: list, want: list, refused: dict, card: str,
               times=None):
    """Place ``pods`` in order on ``node`` through the extender over HTTP
    (each bind must name ``want[i]``'s device ids on that node), then
    filter ``refused``, which must find no node. Each pod's webhook round
    trips (ms) go into ``times`` when given. Returns the allocs, or None
    when a check failed."""
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
            if times is not None:
                times.append(ms)
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
def node_agent(env: dict, host=None):
    """The node agent on the card: a real-backend ``GpuDeviceManager``
    (``env`` over the config's defaults; ``host`` names its node), its
    ``DevicePluginServer`` and ``HealthWatcher``, registered with the
    in-process kubelet peer (the GPU machine has no grpcio: the same
    v1beta1 bytes cross without sockets). Yields them, with the ms from
    Register to the kubelet's first ListAndWatch list, once that list
    holds every device."""
    from tpukube_torch.core.config import load_config
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.plugin import DevicePluginServer, HealthWatcher, InProcessKubelet

    cfg = load_config(env={"TPUKUBE_BACKEND": "real", **env})
    with GpuDeviceManager(cfg, host=host) as mgr, InProcessKubelet() as kubelet:
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


def config5_phase(card: str):
    """Config 5 on a simulated HGX fleet (module docstring, step 11a);
    its run, or None when a check failed."""
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
        return None
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
    return r


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


# -- the Kubernetes REST channel (step 12) ------------------------------------

REST_TOKEN = "chip-smoke-token"  # the stand-in's bearer token
REST_POLL_S = 0.05  # the syncer's file poll and every loop's resync pacing
REST_WAIT_S = 30.0  # how long any one REST effect may take to show
# every route RestApiServer speaks; each must be used at the stand-in
REST_ROUTES = ("nodes.list", "nodes.watch", "nodes.get", "nodes.patch",
               "pods.list", "pods.watch", "pods.get", "pods.patch",
               "pods.delete", "pods.binding", "pods.eviction")


def port_pkg() -> types.SimpleNamespace:
    """The port's modules the REST steps run on (the tests pass the
    reference's namesakes to hold them against it)."""
    from tpukube_torch import apiserver, metrics
    from tpukube_torch.core import codec
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.sched.extender import Extender, serve
    from tpukube_torch.sim import SimCluster

    return types.SimpleNamespace(
        api=apiserver, metrics=metrics, codec=codec, load_config=load_config,
        PodGroup=PodGroup, Extender=Extender, SimCluster=SimCluster, sim_kw={},
        serve=serve, rest_api=apiserver.rest_apiserver_from_config)


def wait_for(what: str, cond, timeout: float = REST_WAIT_S) -> float:
    """Spin until ``cond()`` holds; the host-clock time it first held.
    Raises RuntimeError after ``timeout`` seconds."""
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise RuntimeError(f"REST channel: {what} did not happen in {timeout} s")
        time.sleep(0.0005)
    return time.perf_counter()


class RestTimer:
    """Host-clock round trips of the REST channel's Binding POSTs (each
    ``RestApiServer._request`` on a ``/binding`` path) and of the whole
    bind effector (``pod_binder``: GET, annotation PATCH, Binding POST)."""

    def __init__(self, api) -> None:
        self.binding_ms: list = []
        self.effector_ms: list = []
        request = api._request

        def timed(method, path, *args, **kw):
            t = time.perf_counter()
            try:
                return request(method, path, *args, **kw)
            finally:
                if method == "POST" and path.endswith("/binding"):
                    self.binding_ms.append((time.perf_counter() - t) * 1e3)

        api._request = timed

    def binder(self, bind):
        def timed(alloc) -> None:
            t = time.perf_counter()
            try:
                bind(alloc)
            finally:
                self.effector_ms.append((time.perf_counter() - t) * 1e3)
        return timed


@contextlib.contextmanager
def rest_loops(pkg, ext, api, admission: bool = False):
    """A daemon's loops over ``api``, all in watch mode, for the block:
    the node-topology refresh loop; the lifecycle release loop and the
    reconcile loop (and with ``admission`` the batch queue's
    ``PodAdmissionFeed``) as children of one PodInformer (one pod
    stream); the eviction executor, confirmed by the lifecycle loop's
    DELETED events; the bind effector. Yields them."""
    a = pkg.api
    refresh = a.NodeTopologyRefreshLoop(ext, api, poll_seconds=REST_POLL_S)
    execu = a.EvictionExecutor(ext, api, poll_seconds=3600.0)
    lifecycle = a.PodLifecycleReleaseLoop(ext, api, poll_seconds=REST_POLL_S,
                                          evictions=execu)
    reconcile = a.AllocReconcileLoop(ext, api, poll_seconds=REST_POLL_S)
    feed = (a.PodAdmissionFeed(ext, api, poll_seconds=REST_POLL_S)
            if admission else None)
    informer = a.PodInformer(
        api, [lifecycle, reconcile] + ([feed] if feed is not None else []),
        poll_seconds=REST_POLL_S)
    timer = RestTimer(api)
    ext.binder = timer.binder(a.pod_binder(api))
    # the channel's retry/circuit layer rides on the extender, as a
    # daemon wires it, so /metrics exports tpukube_retry_*/circuit_*
    ext.api_retrier, ext.api_circuit = api.retrier, api.circuit
    refresh.start()
    informer.start()
    try:
        wait_for("the pod informer's stream", informer.stream_connected)
        wait_for("the node watch", refresh.stream_connected)
        yield types.SimpleNamespace(refresh=refresh, execu=execu,
                                    lifecycle=lifecycle, reconcile=reconcile,
                                    feed=feed, informer=informer, timer=timer)
        streams_held(refresh, informer)
        if execu.failures or execu.blocked:
            raise RuntimeError(f"REST channel: {execu.failures} eviction(s) "
                               f"failed, {execu.blocked} blocked")
        channel_clean(api)
    finally:
        informer.stop()
        refresh.stop()


def channel_clean(api) -> None:
    """Raise unless the channel's requests all went through first time:
    a retried request (a transport error or a 5xx) or a circuit that
    opened is an error of the REST channel, even when a retry hid it."""
    stats, circuit = api.retrier.stats, api.circuit
    if not stats.attempts or stats.retries or stats.exhausted or circuit.opens \
            or circuit.state_code():
        raise RuntimeError(
            f"REST channel: {stats.attempts} attempts, {stats.retries} retried, "
            f"{stats.exhausted} exhausted; circuit opened {circuit.opens} times, "
            f"state {circuit.state()}")


def streams_held(*loops) -> None:
    """Raise unless every watch loop kept its first stream: a reconnect
    means a stream failed (or ended) and events were read from a resync."""
    broken = {lp.watch_status()["name"]: lp.watch_status() for lp in loops
              if lp.reconnects or lp.watch_status()["reconnect_failures"]}
    if broken:
        raise RuntimeError(f"REST channel: watch streams broke: {broken}")


def write_annotation(path: str, codec, mgr) -> None:
    """The node agent's annotation file, published atomically (a temp file
    in the same directory, then a rename), as the reference's plugin
    daemon writes it for the syncer sidecar."""
    import tempfile

    payload = json.dumps(codec.annotate_node(mgr.node_info(), mgr.mesh))
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(payload + "\n")
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def rest_pod_life(pkg, card_agent, share_agent, run_child=None) -> dict:
    """Steps 12a-g: one card pod's life and one kubelet divergence, every
    effect through ``pkg``'s REST channel (``RestApiServer`` over the
    stand-in apiserver ``tpukube_torch.sim.kube_rest``) and its loops.
    ``card_agent()`` enters the card's node agent (mgr, server, kubelet),
    ``share_agent()`` a two-share node agent, one after the other (the
    discovery shim serves one manager at a time); ``run_child(env)`` runs
    the bound pod and returns its report (None: no child). Returns the
    decisions and the host-clock times; raises RuntimeError when a check
    fails. Package-agnostic, so the tests hold the port's loops against
    the reference's."""
    import tempfile
    import urllib.request

    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.sched import client
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim.kube_rest import KubeRestServer

    a, codec = pkg.api, pkg.codec
    out: dict = {}
    with KubeRestServer(token=REST_TOKEN) as kube, \
            tempfile.TemporaryDirectory() as td:
        cfg = pkg.load_config(env={})
        api = pkg.rest_api(cfg, kube.base_url, token=REST_TOKEN)
        ext = pkg.Extender(cfg)
        anno_path = os.path.join(td, "anno.json")
        with rest_loops(pkg, ext, api) as loops, contextlib.ExitStack() as stack:
            server = pkg.serve(ext, evictions=loops.execu, lifecycle=loops.lifecycle,
                               reconcile=loops.reconcile, node_refresh=loops.refresh)
            stack.callback(server.server_close)
            stack.callback(server.shutdown)
            port = server.server_address[1]
            with card_agent() as agent:
                node = agent.mgr.host
                res = agent.server.resource_name
                # a. the Node object (no topology yet) and a pending pod
                kube.store.patch_node_annotations(node, {})
                kube.store.upsert_pod(pod_object("rest-0", tpu=1))
                intents = a.AllocIntentWatcher(api, node, agent.server,
                                               poll_seconds=REST_POLL_S)
                syncer = a.NodeAnnotationSyncer(api, node, anno_path,
                                                poll_seconds=REST_POLL_S)
                with contextlib.ExitStack() as loops_of_node:
                    intents.start()
                    loops_of_node.callback(intents.stop)
                    syncer.start()
                    loops_of_node.callback(syncer.stop)
                    wait_for("the intent watch", intents.stream_connected)
                    # b/c. the agent's annotation file -> the syncer's PATCH
                    # -> the refresh loop's node watch -> the node cache
                    t = time.perf_counter()
                    write_annotation(anno_path, codec, agent.mgr)
                    t_topo = wait_for("node topology",
                                      lambda: ext.state.node(node) is not None)
                    out["file_to_topology_ms"] = (t_topo - t) * 1e3
                    if codec.ANNO_NODE_TOPOLOGY not in api.get_node_annotations(node):
                        raise RuntimeError(f"node {node} carries no topology annotation")
                    # d. kube-scheduler's cycle over HTTP, names only; the
                    # bind effector creates the Binding over REST
                    host, alloc, ms = client.place(port, pod_object("rest-0", tpu=1),
                                                   [node])
                    t_bound = time.perf_counter()
                    # e. the intent arrives through the watch (the clock
                    # stops at the first look that finds it)
                    t_intent = wait_for("rest-0's intent", lambda: agent.server.intents
                                        .snapshot().get("default/rest-0")
                                        == alloc.device_ids)
                    out["bind_to_intent_ms"] = (t_intent - t_bound) * 1e3
                    stored = api.get_pod("default", "rest-0")
                    payload = (stored["metadata"].get("annotations") or {}).get(
                        codec.ANNO_ALLOC)
                    if (host != node or stored["spec"].get("nodeName") != node
                            or payload is None or codec.decode_alloc(payload)
                            .device_ids != alloc.device_ids):
                        raise RuntimeError(f"rest-0 bound {alloc.device_ids} on "
                                           f"{host}; the apiserver holds {stored}")
                    out["bind"] = [host, alloc.device_ids]
                    out["webhook_ms"] = ms
                    # the kubelet's GetPreferredAllocation and Allocate
                    # answer from the intent
                    ids = sorted(agent.kubelet.devices(res))
                    out["preferred"] = agent.kubelet.preferred(res, ids, 1)
                    penv = agent.kubelet.allocate(res, alloc.device_ids)
                    if (out["preferred"] != alloc.device_ids
                            or agent.server.intents.depth() or agent.server.divergences):
                        raise RuntimeError(f"preferred {out['preferred']}, intents "
                                           f"{agent.server.intents.snapshot()}")
                    if run_child is not None:
                        out["child"] = run_child({**alloc.env, **penv,
                                                  ENV_ALLOC: payload})
                    # f. the kubelet reports the pod Succeeded; the lifecycle
                    # loop releases it from the pod stream; the pod is deleted
                    # and a second pod takes the same GPU
                    done = dict(kube.store.get_pod("default", "rest-0"))
                    done["status"] = {"phase": "Succeeded"}
                    t = time.perf_counter()
                    kube.store.upsert_pod(done)
                    t_rel = wait_for("rest-0's release", lambda: ext.state.allocation(
                        "default/rest-0") is None)
                    out["phase_to_release_ms"] = (t_rel - t) * 1e3
                    api.delete_pod("default", "rest-0")
                    kube.store.upsert_pod(pod_object("rest-1", tpu=1))
                    _, alloc1, _ = client.place(port, pod_object("rest-1", tpu=1), [node])
                    out["second_bind"] = alloc1.device_ids
                    if alloc1.device_ids != alloc.device_ids:
                        raise RuntimeError(f"rest-1 bound {alloc1.device_ids}")
                    # the intent watch's count is read once its last event
                    # (rest-1's Binding) has landed, not while it races in
                    wait_for("rest-1's intent", lambda: agent.server.intents
                             .snapshot().get("default/rest-1") == alloc1.device_ids)
                    out["released"] = loops.lifecycle.released
                    out["intent_watch_events"] = metric_lines(
                        pkg.metrics.render_plugin_metrics(
                            agent.server, intent_watch=intents)).get(
                        "tpukube_plugin_intent_watch_events_total")
                    streams_held(intents)
            # g. divergence on a two-share node: planned frac0of2, the
            # kubelet takes frac1of2, the plugin reports it over REST and
            # the reconcile loop folds it into the ledger
            with share_agent() as share:
                snode = share.mgr.host
                sres = share.server.resource_name
                share.server.set_alloc_reporter(a.alloc_divergence_reporter(api))
                api.patch_node_annotations(
                    snode, codec.annotate_node(share.mgr.node_info(), share.mgr.mesh))
                wait_for("the share node's topology",
                         lambda: ext.state.node(snode) is not None)
                shared = a.AllocIntentWatcher(api, snode, share.server,
                                              poll_seconds=REST_POLL_S)
                shared.start()
                try:
                    wait_for("the share node's intent watch", shared.stream_connected)
                    kube.store.upsert_pod(pod_object("div-0", vtpu=1))
                    _, dalloc, _ = client.place(port, pod_object("div-0", vtpu=1),
                                                [snode])
                    wait_for("div-0's intent", lambda: share.server.intents.snapshot()
                             .get("default/div-0") == dalloc.device_ids)
                    taken = [d for d in sorted(share.kubelet.devices(sres))
                             if d not in dalloc.device_ids][:1]
                    share.kubelet.allocate(sres, taken)
                    wait_for("the reconcile of div-0", lambda: ext.state.allocation(
                        "default/div-0").device_ids == taken)
                    annos = wait_for_annotations(kube, api, "div-0", codec, taken, a)
                    wait_for("the reconcile count",
                             lambda: loops.reconcile.reconciled == 1)
                    streams_held(shared)
                finally:
                    shared.stop()
                out["divergence"] = {
                    "planned": dalloc.device_ids, "kubelet": taken,
                    "ledger": ext.state.allocation("default/div-0").device_ids,
                    "annotation": codec.decode_alloc(annos[codec.ANNO_ALLOC]).device_ids,
                    "reconciled": loops.reconcile.reconciled,
                    "divergences": share.server.divergences,
                }
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=10) as r:
                page = metric_lines(r.read().decode())
            out["metrics"] = {k: page.get(k) for k in (
                "tpukube_reconciles_total", "tpukube_node_refreshes_total",
                "tpukube_lifecycle_releases_total", "tpukube_binds_total",
                'tpukube_retry_attempts_total{op="apiserver"}',
                'tpukube_retry_retries_total{op="apiserver"}',
                'tpukube_circuit_state{circuit="apiserver"}')}
            out["binding_post_ms"] = list(loops.timer.binding_ms)
            out["effector_ms"] = list(loops.timer.effector_ms)
        out["routes"] = dict(kube.requests)
    return out


def wait_for_annotations(kube, api, name: str, codec, taken: list, a) -> dict:
    """The pod's annotations, read over REST once the stand-in's store
    shows the reconcile loop's work done: its alloc-actual report cleared
    and its alloc annotation rewritten to ``taken``. (The wait reads the
    store, so the count of GETs at the stand-in does not hang on timing.)"""
    def done() -> bool:
        got = kube.store.get_pod("default", name)["metadata"].get("annotations") or {}
        return (a.ANNO_ALLOC_ACTUAL not in got and codec.ANNO_ALLOC in got
                and codec.decode_alloc(got[codec.ANNO_ALLOC]).device_ids == taken)

    wait_for(f"{name}'s rewritten alloc annotation", done)
    return api.get_pod("default", name)["metadata"].get("annotations") or {}


def rest_fleet(pkg) -> dict:
    """Step 12h: config 5 through ``pkg``'s REST channel. The HGX fleet
    ``8,16,1`` / ``8,1,1`` as 16 Node objects on the stand-in apiserver,
    learned by the refresh loop's node watch; 80 priority-0 burst pods,
    then the 64-member priority-100 gang, which preempts. Every bind is a
    Binding POST (``pod_binder``), every victim an Eviction POST
    (``EvictionExecutor`` through ``RestApiServer.evict_pod``), confirmed
    by the lifecycle loop's DELETED events on the pod stream; at the end
    the gang's pods are deleted over REST and the lifecycle loop releases
    them. Webhooks go in process (names only). Returns what happened; the
    caller judges it. Package-agnostic, so the tests hold the port's run
    against the reference's."""
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim.kube_rest import KubeRestServer

    a, codec = pkg.api, pkg.codec
    cfg = pkg.load_config(env=CONFIG5_ENV)
    with pkg.SimCluster(cfg, **pkg.sim_kw) as c:
        nodes = c.node_objects()
        hosts = {n: sorted(tuple(ch.coord) for ch in info.chips)
                 for n, info in c.nodes.items()}
    with KubeRestServer(token=REST_TOKEN) as kube:
        api = pkg.rest_api(cfg, kube.base_url, token=REST_TOKEN)
        ext = pkg.Extender(cfg)
        ext.evict_precheck = lambda key: api.evict_pod(*key.split("/", 1), dry_run=True)
        for obj in nodes:  # the node agents' syncers
            api.patch_node_annotations(obj["metadata"]["name"],
                                       obj["metadata"]["annotations"])
        with rest_loops(pkg, ext, api) as loops:
            wait_for("16 nodes", lambda: len(ext.state.node_names()) == len(nodes))
            names = sorted(ext.state.node_names())

            def schedule(pod) -> tuple:
                kube.store.upsert_pod(pod)
                meta = pod["metadata"]
                deadline = time.perf_counter() + REST_WAIT_S
                while True:
                    loops.execu.drain()
                    fres = ext.handle("filter", {"Pod": pod, "NodeNames": names})
                    if fres.get("Error") or not fres["NodeNames"]:
                        raise RuntimeError(f"{meta['name']}: {fres}")
                    pres = ext.handle("prioritize", {"Pod": pod,
                                                     "NodeNames": fres["NodeNames"]})
                    scores = {e["Host"]: e["Score"] for e in pres}
                    best = max(sorted(scores), key=lambda h: scores[h])
                    bres = ext.handle("bind", {
                        "PodName": meta["name"], "PodNamespace": meta["namespace"],
                        "PodUID": meta["uid"], "Node": best})
                    if not bres.get("Error"):
                        return best, codec.decode_alloc(
                            bres["Annotations"][codec.ANNO_ALLOC])
                    if time.perf_counter() > deadline:
                        raise RuntimeError(f"{meta['name']}: {bres['Error']}")
                    time.sleep(0.001)

            burst = [schedule(pod_object(f"infer-{i}", tpu=1))
                     for i in range(CONFIG5_BURST)]
            util_burst = ext.state.utilization()
            group = pkg.PodGroup("llama-train", min_member=CONFIG5_GANG)
            gang = [schedule(pod_object(f"train-{i}", tpu=1, priority=100,
                                        annotations=codec.pod_group_annotations(group)))
                    for i in range(CONFIG5_GANG)]
            res = ext.gang.reservation("default", "llama-train")
            victims = sorted(al.pod_key for _, al in burst
                             if ext.state.allocation(al.pod_key) is None)
            wait_for("every victim confirmed gone",
                     lambda: loops.execu.depth() == 0 and all(
                         kube.store.get_pod(*k.split("/", 1)) is None for k in victims))
            util = ext.state.utilization()
            bound = {p["metadata"]["name"]: p["spec"].get("nodeName")
                     for p in kube.store.list_pods()}
            # a paged LIST: 128 pods in pages of 50
            api.LIST_PAGE_LIMIT = 50
            pages = kube.requests["pods.list"]
            listed = sorted(p["metadata"]["name"] for p in api.list_pods())
            listed_ok = (listed == sorted(bound)
                         and kube.requests["pods.list"] - pages == 3)
            for _, al in gang:
                api.delete_pod(*al.pod_key.split("/", 1))
            wait_for("the gang's release", lambda: all(
                ext.state.allocation(al.pod_key) is None for _, al in gang))
            page = pkg.metrics.render_extender_metrics(
                ext, reconcile=loops.reconcile, evictions=loops.execu,
                node_refresh=loops.refresh, lifecycle=loops.lifecycle)
            binding_ms, effector_ms = loops.timer.binding_ms, loops.timer.effector_ms
        evicted = [k for kind, k in kube.store.patch_log if kind == "evict"]
        return {
            "burst": [(n, al.device_ids, [tuple(x) for x in al.coords]) for n, al in burst],
            "gang": [(n, al.device_ids, [tuple(x) for x in al.coords]) for n, al in gang],
            "util_burst": util_burst,
            "utilization": util,
            "util_after_release": ext.state.utilization(),
            "committed": res is not None and res.committed,
            "commit_latency": res.commit_latency if res is not None else None,
            "victims": victims,
            "evicted": sorted(evicted),
            "binding_posts": kube.requests["pods.binding"],
            "bound": bound,
            "preemptions": ext.preemptions,
            "released": loops.lifecycle.released,
            "refreshed": loops.refresh.refreshed,
            "metrics": page,
            "binding_post_ms": binding_ms,
            "effector_ms": effector_ms,
            "routes": dict(kube.requests),
            "listed": listed_ok,
            "hosts": hosts,
        }


SHARE_NODE_ENV = {  # step 12g's two-share node agent, on the sim backend
    "TPUKUBE_BACKEND": "sim", "TPUKUBE_SHARES_PER_CHIP": "2",
    "TPUKUBE_SIM_MESH_DIMS": "1,1,1", "TPUKUBE_SIM_HOST_BLOCK": "1,1,1",
    "TPUKUBE_SIM_HOST_ORIGIN": "0,0,0", "TPUKUBE_SLICE_ID": "share-slice",
}


@contextlib.contextmanager
def share_agent(host: str = "share-node"):
    """Step 12g's two-share node agent ``share-node`` (sim backend): its
    device plugin registered with the in-process kubelet peer. The tests
    run step 16b on it under another ``host`` name."""
    from tpukube_torch.core.config import load_config
    from tpukube_torch.device import GpuDeviceManager
    from tpukube_torch.plugin import DevicePluginServer, InProcessKubelet

    cfg = load_config(env=SHARE_NODE_ENV)
    with GpuDeviceManager(cfg, host=host) as mgr, InProcessKubelet() as kubelet:
        server = DevicePluginServer(cfg, mgr)
        kubelet.register_plugin(server)
        kubelet.wait_for_devices(server.resource_name, len(mgr.device_list()))
        yield types.SimpleNamespace(mgr=mgr, kubelet=kubelet, server=server)


def rest_phase(card: str, c0, r5: dict):
    """Step 12 on the card: one Llama-3-8B pod's life and a divergence
    through the REST channel (``rest_pod_life``), then config 5 through it
    (``rest_fleet``). Returns the ``rest:`` line's object, or None when a
    check failed."""
    from tpukube_torch.obs.registry import quantile

    def child(env: dict):
        sp = run_pod(["--scheduled"], env, "scheduled")
        if sp is None:
            raise RuntimeError("the rest-0 pod failed")
        return sp

    pkg = port_pkg()
    try:
        life = rest_pod_life(pkg, lambda: node_agent({}), share_agent,
                             run_child=child)
        fleet = rest_fleet(pkg)
    except RuntimeError as e:
        fail(str(e))
        return None
    sp = life["child"]
    checked = sp["scheduled"]
    if (sp["uuid"] != c0.chip_id or checked["pod"] != "default/rest-0"
            or checked["device_ids"] != ["tpu-0"] or life["bind"][1] != ["tpu-0"]):
        fail(f"rest-0: {checked} on {sp['uuid']}, bound {life['bind']}")
        return None
    print("rest pod: " + json.dumps(sp, sort_keys=True), flush=True)
    div = life["divergence"]
    m = life["metrics"]
    if (div["planned"] != ["tpu-0-frac0of2"] or div["kubelet"] != ["tpu-0-frac1of2"]
            or div["ledger"] != div["kubelet"] or div["annotation"] != div["kubelet"]
            or div["reconciled"] != 1 or div["divergences"] != 1
            or m["tpukube_reconciles_total"] != 1
            or m["tpukube_node_refreshes_total"] != 2
            or m["tpukube_lifecycle_releases_total"] != life["released"]
            or life["released"] != 1
            or not m['tpukube_retry_attempts_total{op="apiserver"}']
            or m['tpukube_retry_retries_total{op="apiserver"}'] != 0
            or m['tpukube_circuit_state{circuit="apiserver"}'] != 0
            or not life["intent_watch_events"]):
        fail(f"REST divergence/metrics: {div}; {m}; intent watch events "
             f"{life['intent_watch_events']}")
        return None
    coords = {co for _, _, cs in fleet["gang"] for co in cs}
    nodes = sorted({n for n, _, _ in fleet["gang"]})
    ys = sorted({co[1] for co in coords})
    fm = metric_lines(fleet["metrics"])
    n_binds = CONFIG5_BURST + CONFIG5_GANG
    checks = {
        "committed": fleet["committed"],
        "64 GPUs on 8 whole hosts": len(coords) == CONFIG5_GANG and len(nodes) == 8
        and all(set(fleet["hosts"][n]) <= coords for n in nodes),
        "contiguous along y": ys == list(range(ys[0], ys[0] + len(ys))),
        "victims evicted over REST": bool(fleet["victims"])
        and fleet["evicted"] == fleet["victims"] == sorted(
            set(fleet["victims"])) and fleet["preemptions"] == len(fleet["victims"]),
        "one Binding POST per bind": fleet["binding_posts"] == n_binds
        == len(fleet["binding_post_ms"]),
        "binds visible at the apiserver": all(
            fleet["bound"][f"train-{i}"] == fleet["gang"][i][0]
            for i in range(CONFIG5_GANG)),
        "utilization after the preemption": fleet["utilization"]
        == (CONFIG5_BURST - len(fleet["victims"]) + CONFIG5_GANG) / 128,
        "the gang released by the lifecycle loop": fleet["released"] == CONFIG5_GANG
        and fleet["util_after_release"]
        == (CONFIG5_BURST - len(fleet["victims"])) / 128,
        "/metrics node refreshes 16": fm.get("tpukube_node_refreshes_total") == 16,
        "/metrics evictions": fm.get("tpukube_evictions_total") == len(fleet["victims"]),
        "/metrics lifecycle releases": fm.get("tpukube_lifecycle_releases_total")
        == CONFIG5_GANG,
        "paged pod list": fleet["listed"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    routes = {r: life["routes"].get(r, 0) + fleet["routes"].get(r, 0)
              for r in REST_ROUTES}
    unused = [r for r, n in routes.items() if n <= 0]
    if bad or unused:
        fail(f"config 5 over REST: {bad}; routes never used {unused}; nodes "
             f"{nodes}, rows {ys}")
        return None
    posts = life["binding_post_ms"] + fleet["binding_post_ms"]
    effector = life["effector_ms"] + fleet["effector_ms"]
    print(
        f"REST channel: rest-0 placed by the refresh loop's topology "
        f"({life['file_to_topology_ms']:.3f} ms from the annotation file), bound "
        f"{life['bind'][1]} on {life['bind'][0]} through POST .../binding, its "
        f"intent watched in {life['bind_to_intent_ms']:.3f} ms, served Llama-3-8B "
        f"B={sp['batch']} S={sp['seq']} ({sp['forward_ms_median']:.3f} ms), released "
        f"{life['phase_to_release_ms']:.3f} ms after Succeeded; divergence "
        f"{div['planned']} -> {div['kubelet']} reconciled; config 5 over REST: "
        f"{CONFIG5_GANG}-member gang committed on {nodes[0]}..{nodes[-1]} after "
        f"{len(fleet['victims'])} evictions, commit latency "
        f"{fleet['commit_latency'] * 1e3:.3f} ms (in process, step 11a: "
        f"{r5['commit_latency'] * 1e3:.3f} ms); Binding POST median "
        f"{quantile(posts, 0.5):.3f} ms over {len(posts)} (host CPU times) [{card}]",
        flush=True,
    )
    return {
        "file_to_topology_ms": life["file_to_topology_ms"],
        "bind_to_intent_ms": life["bind_to_intent_ms"],
        "phase_to_release_ms": life["phase_to_release_ms"],
        "binding_post_ms_median": statistics.median(posts),
        "binding_posts": len(posts),
        "bind_effector_ms_median": statistics.median(effector),
        "gang_commit_ms_rest": fleet["commit_latency"] * 1e3,
        "gang_commit_ms_in_process": r5["commit_latency"] * 1e3,
        "gang_cycle_p50_ms_in_process": quantile(r5["cycles"], 0.5) * 1e3,
        "evictions": len(fleet["evicted"]),
        "webhook_ms": life["webhook_ms"],
        "routes": routes,
        "card": card,
    }


# -- the batch scheduling cycle and the scenario drives (step 13) -------------

# each scenario's placement keys, equal with batching off and on (the
# reference's tests/test_cycle.py SCENARIO_KEYS)
SCENARIO_KEYS = {
    1: ("node", "devices", "env_keys", "utilization_percent"),
    2: ("placements", "utilization_percent"),
    3: ("pods", "shared_one_chip"),
    4: ("gang_box", "contiguous", "utilization_percent"),
    5: ("value", "vs_baseline", "preemptions", "pods_placed"),
    6: ("value", "waves", "wave_size", "full_utilization_percent",
        "util_min_after_refill_percent", "lifecycle_releases"),
}
NORTH_STAR_UTIL = 95.0  # BASELINE's utilization target, percent


@contextlib.contextmanager
def scenario_env(env: dict):
    """``env`` set in this process's environment for the block (the
    scenarios read their knobs from it), the old values back after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def batch_pod_life(pkg, card_agent, run_child=None) -> dict:
    """Step 13d: one card pod placed from a batch plan, every effect
    through ``pkg``'s REST channel over the stand-in apiserver. The
    extender runs with ``TPUKUBE_BATCH_ENABLED=1``; its PodInformer
    carries the lifecycle loop and a ``PodAdmissionFeed``. A pending
    ``default/batch-0`` pod created in the stand-in must be admitted by
    the feed with no webhook sent, planned by ``plan_pending``, and its
    /filter -> /prioritize -> /bind (``sched/client.py`` over HTTP)
    answered from the plan; the bind effector's Binding POST, the intent
    watch and the kubelet's Allocate give the env; ``run_child(env)``
    runs the pod (None: no child); the pod then ends ``Succeeded`` and
    the lifecycle loop releases it. Returns the decisions and host-clock
    times; raises RuntimeError when a check fails. Package-agnostic, so
    the tests hold the port's run against the reference's."""
    import urllib.request

    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.sched import client
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim.kube_rest import KubeRestServer

    a, codec = pkg.api, pkg.codec
    key = "default/batch-0"
    out: dict = {}
    with KubeRestServer(token=REST_TOKEN) as kube:
        cfg = pkg.load_config(env={"TPUKUBE_BATCH_ENABLED": "1"})
        api = pkg.rest_api(cfg, kube.base_url, token=REST_TOKEN)
        ext = pkg.Extender(cfg)
        with rest_loops(pkg, ext, api, admission=True) as loops, \
                contextlib.ExitStack() as stack:
            server = pkg.serve(ext, evictions=loops.execu, lifecycle=loops.lifecycle,
                               reconcile=loops.reconcile, node_refresh=loops.refresh)
            stack.callback(server.server_close)
            stack.callback(server.shutdown)
            port = server.server_address[1]
            with card_agent() as agent:
                node = agent.mgr.host
                res = agent.server.resource_name
                intents = a.AllocIntentWatcher(api, node, agent.server,
                                               poll_seconds=REST_POLL_S)
                intents.start()
                stack.callback(intents.stop)
                wait_for("the intent watch", intents.stream_connected)
                api.patch_node_annotations(
                    node, codec.annotate_node(agent.mgr.node_info(), agent.mgr.mesh))
                wait_for("node topology", lambda: ext.state.node(node) is not None)
                # the pending pod reaches the queue through the pod stream
                t = time.perf_counter()
                kube.store.upsert_pod(pod_object("batch-0", tpu=1))
                t_adm = wait_for("batch-0's admission",
                                 lambda: loops.feed.admitted == 1)
                out["added_to_admitted_ms"] = (t_adm - t) * 1e3
                if any(ext.latencies[h] for h in ext.latencies):
                    raise RuntimeError("a webhook was answered before the plan")
                t = time.perf_counter()
                out["planned"] = ext.plan_pending()
                out["admitted_to_planned_ms"] = (time.perf_counter() - t) * 1e3
                out["planned_node"] = ext.planned_node(key)
                if out["planned"] != 1 or out["planned_node"] != node:
                    raise RuntimeError(f"plan_pending planned {out['planned']}, "
                                       f"batch-0 on {out['planned_node']}")
                # kube-scheduler's cycle over HTTP, names only: each
                # webhook answered from the plan where it can be
                host, alloc, ms = client.place(port, pod_object("batch-0", tpu=1),
                                               [node])
                t_bound = time.perf_counter()
                out["bind"] = [host, alloc.device_ids]
                out["webhook_ms"] = ms
                wait_for("batch-0's intent", lambda: agent.server.intents
                         .snapshot().get(key) == alloc.device_ids)
                out["bind_to_intent_ms"] = (time.perf_counter() - t_bound) * 1e3
                stored = api.get_pod("default", "batch-0")
                payload = (stored["metadata"].get("annotations") or {}).get(
                    codec.ANNO_ALLOC)
                if (host != node or stored["spec"].get("nodeName") != node
                        or payload is None
                        or codec.decode_alloc(payload).device_ids != alloc.device_ids):
                    raise RuntimeError(f"batch-0 bound {alloc.device_ids} on {host}; "
                                       f"the apiserver holds {stored}")
                ids = sorted(agent.kubelet.devices(res))
                out["preferred"] = agent.kubelet.preferred(res, ids, 1)
                penv = agent.kubelet.allocate(res, alloc.device_ids)
                if out["preferred"] != alloc.device_ids or agent.server.intents.depth():
                    raise RuntimeError(f"preferred {out['preferred']}, intents "
                                       f"{agent.server.intents.snapshot()}")
                if run_child is not None:
                    out["child"] = run_child({**alloc.env, **penv, ENV_ALLOC: payload})
                done = dict(kube.store.get_pod("default", "batch-0"))
                done["status"] = {"phase": "Succeeded"}
                kube.store.upsert_pod(done)
                wait_for("batch-0's release",
                         lambda: ext.state.allocation(key) is None)
                streams_held(intents)
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                        timeout=10) as r:
                page = metric_lines(r.read().decode())
            out["metrics"] = {k: page.get(k) for k in (
                "tpukube_cycles_total", "tpukube_cycle_pods_planned_total",
                "tpukube_cycle_plan_hits_total", "tpukube_cycle_plan_misses_total",
                "tpukube_cycle_assumes_total", "tpukube_binds_total",
                "tpukube_lifecycle_releases_total")}
            # the feed's admissions over the whole life: the bind
            # effector's annotation PATCH (before the Binding) re-delivers
            # the still-unbound pod after /bind consumed its plan, and the
            # feed admits it again, as the reference's does; the queue
            # entry leaves at the release
            out["admitted"] = loops.feed.admitted
            out["released"] = loops.lifecycle.released
        out["routes"] = dict(kube.requests)
    return out


def host_cpu() -> str:
    """The host's CPU model, architecture and core count (the drives are
    host work)."""
    import platform

    model = "CPU model not reported"
    with contextlib.suppress(OSError):
        with open("/proc/cpuinfo") as f:
            for line in f:
                name, _, value = line.partition(":")
                if name.strip().lower() in ("model name", "cpu model",
                                            "hardware") and value.strip():
                    model = value.strip()
                    break
    return f"{model} ({platform.machine()}), {os.cpu_count()} cores"


def drive_line(r: dict) -> dict:
    """One kilonode drive's numbers for the ``scenarios:`` line."""
    out = {k: r[k] for k in ("nodes", "chips", "pods_total", "pods_per_sec",
                             "wall_s", "sim_seconds", "time_compression",
                             "webhook_p99_ms", "utilization_percent")}
    out["plan_hit_ratio"] = r["cycle"]["plan_hit_ratio"]
    if "snapshot" in r:
        out.update({k: r["snapshot"][k] for k in (
            "delta_apply_p50_ms", "rebuild_p50_ms", "snapshot_ms_per_cycle")})
    return out


def batch_phase(card: str, c0):
    """Step 13: the scenario drives through the port's ``scenarios.run``
    (13a-c), then one card pod from a batch plan (13d). Returns the
    ``scenarios:`` line's object, or None when a check failed."""
    from tpukube_torch.sim import scenarios

    t_step = time.perf_counter()
    line: dict = {"card": card, "host": host_cpu()}
    try:
        # a. scenarios 1-6, batching off then on: the same placements
        small = {}
        for n in sorted(SCENARIO_KEYS):
            runs = []
            for batch in ("0", "1"):
                with scenario_env({"TPUKUBE_BATCH_ENABLED": batch}):
                    runs.append(scenarios.run(n))
            legacy, batched = ({k: r[k] for k in SCENARIO_KEYS[n]} for r in runs)
            if legacy != batched:
                fail(f"scenario {n} placed differently with batching: "
                     f"{legacy} vs {batched}")
                return None
            small[n] = {"wall_s": [r["wall_s"] for r in runs], **legacy}
        s5 = small[5]
        if s5["value"] < NORTH_STAR_UTIL:
            fail(f"scenario 5 utilization {s5['value']} < {NORTH_STAR_UTIL}")
            return None
        print(f"scenarios 1-6 (transport inprocess), batching off and on: the "
              f"same placements; scenario 5 utilization {s5['value']}%, "
              f"{s5['preemptions']} preemptions, {s5['pods_placed']} pods placed "
              f"[{card}; {line['host']}]", flush=True)
        line["small"] = small
        # b, c. the kilonode drives at the reference's default sizes (each
        # raises on its own invariants)
        for n in (10, 12):
            r = scenarios.run(n)
            if r["ledger_divergence"] or not r["gang_committed"]:
                fail(f"scenario {n}: {r}")
                return None
            line[f"scenario_{n}"] = drive_line(r)
            line[f"scenario_{n}"]["resync"] = r["resync"]
            if n == 12:
                # the lifecycle's per-wave reconcile rides the alloc
                # change log: at least the reference's coldstart floor of
                # its reads incremental (tools/perf_floor.json)
                with open(PERF_FLOOR) as f:
                    hit_min = json.load(f)["coldstart"]["resync_hit_ratio_min"]
                ratio = r["resync"]["incremental_hit_ratio"]
                if ratio is None or ratio < hit_min:
                    fail(f"scenario 12 resync hit ratio {ratio} < {hit_min}: "
                         f"{r['resync']}")
                    return None
            print(f"scenario {n}: {r['nodes']} nodes, {r['chips']} GPUs, "
                  f"{r['pods_total']} pods in {r['wall_s']} s "
                  f"({r['pods_per_sec']} pods/s, {r['sim_seconds']} simulated s); "
                  f"cycle {json.dumps(r['cycle'], sort_keys=True)}; resync "
                  f"{json.dumps(r['resync'], sort_keys=True)} "
                  f"[host CPU times; {line['host']}]", flush=True)
        # d. one card pod admitted, planned and bound from the plan
        life = batch_pod_life(port_pkg(), lambda: node_agent({}),
                              run_child=lambda env: run_pod(
                                  ["--scheduled"], env, "scheduled"))
    except RuntimeError as e:
        fail(str(e))
        return None
    sp, m = life["child"], life["metrics"]
    if sp is None:
        return None
    checked = sp["scheduled"]
    if (sp["uuid"] != c0.chip_id or checked["pod"] != "default/batch-0"
            or checked["device_ids"] != ["tpu-0"] or life["bind"][1] != ["tpu-0"]
            or life["released"] != 1
            or not m["tpukube_cycle_plan_hits_total"]
            or m["tpukube_cycle_pods_planned_total"] != 1):
        fail(f"batch-0: {checked} on {sp['uuid']}, {life}")
        return None
    print("batch pod: " + json.dumps(sp, sort_keys=True), flush=True)
    line["batch_pod"] = {k: life[k] for k in (
        "added_to_admitted_ms", "admitted_to_planned_ms", "webhook_ms",
        "bind_to_intent_ms", "bind", "metrics", "admitted")}
    line["batch_pod"]["forward_ms"] = sp["forward_ms_median"]
    line["step_s"] = time.perf_counter() - t_step
    print(
        f"batch pod: default/batch-0 admitted by the feed "
        f"{life['added_to_admitted_ms']:.3f} ms after ADDED, planned in "
        f"{life['admitted_to_planned_ms']:.3f} ms, webhooks "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in life["webhook_ms"].items())
        + f" ({m['tpukube_cycle_plan_hits_total']:.0f} plan hits), bound "
        f"{life['bind'][1]} over REST, served Llama-3-8B B={sp['batch']} "
        f"S={sp['seq']} ({sp['forward_ms_median']:.3f} ms) [{card}]",
        flush=True,
    )
    return line


# -- the daemons as users start them (step 14) --------------------------------

DAEMON_HOSTS = 1024  # scenario 10's node count: 8,192 GPU slots
DAEMON_GANG = 256    # scenario 10's gang size
DAEMON_NODE = "h100-0"  # this machine's Node object
DAEMON_WAIT_S = 60.0  # how long a daemon child may take to show one effect
# the deploy ConfigMap's config.yaml (deploy/extender-deployment.yaml),
# plus the fleet's geometry, the loops' pacing and the capture sinks
DAEMON_CONFIG = """\
resource_tpu: qiniu.com/tpu
resource_vtpu: qiniu.com/vtpu
extender_port: 12345
score_mode: topology
reservation_ttl_seconds: 30.0
trace_capacity: 4096
slice_id: hgx
sim_mesh_dims: [8, {hosts}, 1]
sim_host_block: [8, 1, 1]
health_poll_seconds: {poll}
trace_path: {trace}
events_path: {events}
"""


def mint_pki(d: str) -> dict:
    """A CA, a server certificate (SAN 127.0.0.1) and a client certificate,
    with openssl, as cert-manager would issue them into the deploy/
    secrets. Returns their paths."""
    def o(*cmd) -> None:
        subprocess.run(cmd, check=True, capture_output=True, cwd=d, timeout=60)

    o("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
      "-keyout", "ca.key", "-out", "ca.crt", "-days", "2",
      "-subj", "/CN=tpukube-smoke-ca")
    for name, cn, ext in (
        ("server", "localhost", "subjectAltName=IP:127.0.0.1,DNS:localhost"),
        ("client", "kube-scheduler", "extendedKeyUsage=clientAuth"),
    ):
        with open(os.path.join(d, f"{name}.ext"), "w") as f:
            f.write(ext + "\n")
        o("openssl", "req", "-newkey", "rsa:2048", "-nodes",
          "-keyout", f"{name}.key", "-out", f"{name}.csr", "-subj", f"/CN={cn}")
        o("openssl", "x509", "-req", "-in", f"{name}.csr", "-CA", "ca.crt",
          "-CAkey", "ca.key", "-CAcreateserial", "-out", f"{name}.crt",
          "-days", "2", "-extfile", f"{name}.ext")
    return {k: os.path.join(d, v) for k, v in (
        ("ca", "ca.crt"), ("cert", "server.crt"), ("key", "server.key"),
        ("client_cert", "client.crt"), ("client_key", "client.key"))}


class Children:
    """The step's daemon children (``python -m tpukube_torch.cli ...``):
    each one's stderr goes to a file of its own; ``close()`` kills any
    still running."""

    def __init__(self, d: str) -> None:
        self._d = d
        self._procs: list = []

    def spawn(self, name: str, args: list) -> subprocess.Popen:
        err = open(os.path.join(self._d, f"{name}-{len(self._procs)}.err"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpukube_torch.cli", *args], cwd=ROOT,
            env=pod_env({}), stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=err, text=True)
        proc.err_path = err.name
        err.close()
        self._procs.append(proc)
        return proc

    def run(self, name: str, args: list) -> tuple:
        """Run a tool child to its end: (exit code, stdout)."""
        proc = self.spawn(name, args)
        try:
            out, _ = proc.communicate(timeout=DAEMON_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise RuntimeError(f"{name} {args} outlived {DAEMON_WAIT_S} s")
        return proc.returncode, out

    @staticmethod
    def tail(proc) -> str:
        with open(proc.err_path) as f:
            return f.read()[-3000:]

    def stop(self, proc) -> tuple:
        """SIGTERM, then the exit code and the seconds the exit took."""
        t = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=DAEMON_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise RuntimeError(f"a daemon outlived SIGTERM by {DAEMON_WAIT_S} s")
        return rc, time.perf_counter() - t

    def close(self) -> None:
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


def https_get(url: str, ctx=None, raw: bool = False):
    with urllib.request.urlopen(url, timeout=30, context=ctx) as r:
        body = r.read()
    return body if raw else json.loads(body)


def daemon_wait(what: str, cond, proc=None) -> float:
    """``wait_for`` with the daemon child's stderr in the error, and its
    death an immediate failure."""
    def check() -> bool:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"{what}: the daemon exited {proc.returncode}: "
                               f"{Children.tail(proc)}")
        with contextlib.suppress(OSError):
            return bool(cond())
        return False

    return wait_for(what, check, timeout=DAEMON_WAIT_S)


def daemon_life(card_agent, run_child=None, hosts: int = DAEMON_HOSTS,
                gang: int = DAEMON_GANG) -> dict:
    """Step 14: the port's daemons started as the manifests start them,
    over the REST stand-in apiserver (a-i of the module docstring).
    ``card_agent()`` enters this machine's node agent (its node named
    ``DAEMON_NODE``); ``run_child(env)`` runs the card pod (None: no
    child). Returns the decisions and host-clock times; raises
    RuntimeError when a check fails. The tests run it at a small fleet."""
    import ssl
    import tempfile

    from tpukube_torch.apiserver import AllocIntentWatcher, rest_apiserver_from_config
    from tpukube_torch.core import codec
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.sched import client
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim import SimCluster
    from tpukube_torch.sim.harness import _free_port
    from tpukube_torch.sim.kube_rest import KubeRestServer

    out: dict = {"hosts": hosts + 1, "gang_size": gang}
    t_step = time.perf_counter()
    with tempfile.TemporaryDirectory() as td, \
            KubeRestServer(token=REST_TOKEN) as kube, \
            contextlib.ExitStack() as stack:
        kids = Children(td)
        stack.callback(kids.close)
        # a. the PKI, the config file, the apiserver token
        pki = mint_pki(td)
        mtls = ssl.create_default_context(cafile=pki["ca"])
        mtls.load_cert_chain(pki["client_cert"], pki["client_key"])
        anon = ssl.create_default_context(cafile=pki["ca"])
        cfg_path = os.path.join(td, "config.yaml")
        trace_path = os.path.join(td, "trace.jsonl")
        with open(cfg_path, "w") as f:
            f.write(DAEMON_CONFIG.format(
                hosts=hosts, poll=REST_POLL_S, trace=trace_path,
                events=os.path.join(td, "events.jsonl")))
        token_path = os.path.join(td, "token")
        with open(token_path, "w") as f:
            f.write(REST_TOKEN + "\n")
        # the in-process sims of the same config keep no capture: the
        # sinks are the daemon's
        cfg = dataclasses.replace(load_config(yaml_path=cfg_path, env={}),
                                  trace_path="", events_path="")
        # b. the fleet's Node objects, and this machine's with no topology
        with SimCluster(cfg, in_process=True) as sim:
            fleet = sim.node_objects()
        for obj in fleet:
            kube.store.patch_node_annotations(obj["metadata"]["name"],
                                              obj["metadata"]["annotations"])
        kube.store.patch_node_annotations(DAEMON_NODE, {})
        names = sorted([o["metadata"]["name"] for o in fleet] + [DAEMON_NODE])
        api = rest_apiserver_from_config(load_config(env={}), kube.base_url,
                                         token=REST_TOKEN)
        kube_args = ["--kube-api", kube.base_url, "--kube-token-file", token_path]
        with card_agent() as agent:
            node = agent.mgr.host
            if node != DAEMON_NODE:
                raise RuntimeError(f"the node agent names its node {node}")
            # c. the syncer daemon: the node agent's file -> the Node PATCH
            anno_path = os.path.join(td, "anno.json")
            sync_metrics = _free_port()
            syncer = kids.spawn("syncer", [
                "syncer", "--annotation-file", anno_path, "--node", node,
                "--poll", str(REST_POLL_S), "--metrics-port", str(sync_metrics),
                *kube_args])
            daemon_wait("the syncer's /metrics", lambda: https_get(
                f"http://127.0.0.1:{sync_metrics}/metrics", raw=True), syncer)
            t = time.perf_counter()
            write_annotation(anno_path, codec, agent.mgr)
            t_patch = daemon_wait("the syncer's Node PATCH", lambda: (
                codec.ANNO_NODE_TOPOLOGY in kube.store.get_node_annotations(node)),
                syncer)
            out["file_to_patch_ms"] = (t_patch - t) * 1e3
            # d. the extender daemon, as deploy/extender-deployment.yaml
            # starts it, learning the fleet through its rebuild (bulk
            # ingest) and its node watch
            port, probe = _free_port(), _free_port()
            ext_args = [
                "extender", "--config", cfg_path, "--host", "127.0.0.1",
                "--port", str(port), "--tls-cert", pki["cert"],
                "--tls-key", pki["key"], "--tls-client-ca", pki["ca"],
                "--probe-port", str(probe), *kube_args]
            base = f"https://127.0.0.1:{port}"
            probe_base = f"http://127.0.0.1:{probe}"

            def start_extender(name: str):
                t0 = time.perf_counter()
                proc = kids.spawn(name, ext_args)
                t_ready = daemon_wait(f"{name} ready at {len(names)} nodes", lambda: len(
                    https_get(f"{probe_base}/healthz")["nodes"]) == len(names), proc)
                return proc, (t_ready - t0) * 1e3

            ext1, out["spawn_to_ready_ms"] = start_extender("extender")
            try:
                https_get(f"{base}/healthz", anon)
                raise RuntimeError("a client without a certificate was served")
            except (ssl.SSLError, OSError):
                pass
            page = metric_lines(https_get(f"{probe_base}/metrics", raw=True).decode())
            try:
                https_get(f"{probe_base}/state/topology")
                raise RuntimeError("the probe port served /state/topology")
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    raise
            out["ingest_nodes_total"] = page.get("tpukube_ingest_nodes_total")
            if (out["ingest_nodes_total"] or 0) < len(names):
                raise RuntimeError(f"ingest counted {out['ingest_nodes_total']}")
            topo_raw = https_get(f"{base}/state/topology", mtls, raw=True)
            out["topology_bytes"] = len(topo_raw)
            card = [n for n in json.loads(topo_raw)["nodes"] if n["name"] == node]
            if not card or len(card[0]["chips"]) != len(agent.mgr.device_list()):
                raise RuntimeError(f"the card's node in /state/topology: {card}")
            # e. one card pod placed by the daemon over mTLS, pinned to
            # this machine's node (as its nodeSelector would pin it)
            intents = AllocIntentWatcher(api, node, agent.server,
                                         poll_seconds=REST_POLL_S)
            intents.start()
            stack.callback(intents.stop)
            wait_for("the intent watch", intents.stream_connected)
            kube.store.upsert_pod(pod_object("daemon-0", tpu=1))
            host, alloc, ms = client.place(port, pod_object("daemon-0", tpu=1),
                                           [node], ssl_context=mtls)
            t_bound = time.perf_counter()
            t_intent = wait_for("daemon-0's intent", lambda: agent.server.intents
                                .snapshot().get("default/daemon-0") == alloc.device_ids)
            out["bind_to_intent_ms"] = (t_intent - t_bound) * 1e3
            out["webhook_mtls_ms"] = ms
            stored = kube.store.get_pod("default", "daemon-0")
            payload = (stored["metadata"].get("annotations") or {}).get(codec.ANNO_ALLOC)
            if (host != node or stored["spec"].get("nodeName") != node
                    or alloc.device_ids != ["tpu-0"] or payload is None):
                raise RuntimeError(f"daemon-0 bound {alloc.device_ids} on {host}; "
                                   f"the apiserver holds {stored}")
            out["bind"] = [host, alloc.device_ids]
            res = agent.server.resource_name
            out["preferred"] = agent.kubelet.preferred(
                res, sorted(agent.kubelet.devices(res)), 1)
            penv = agent.kubelet.allocate(res, alloc.device_ids)
            if out["preferred"] != alloc.device_ids:
                raise RuntimeError(f"preferred {out['preferred']}")
            if run_child is not None:
                out["child"] = run_child({**alloc.env, **penv, ENV_ALLOC: payload})
            # f. a fleet-sized gang through the daemon, names only, beside
            # the in-process port's placement of the same gang
            group = PodGroup("fleet-train", min_member=gang)
            annos = codec.pod_group_annotations(group)
            t = time.perf_counter()
            placed = []
            for i in range(gang):
                pod = pod_object(f"train-{i}", tpu=1, annotations=annos)
                kube.store.upsert_pod(pod)
                h, a, _ = client.place(port, pod, names, ssl_context=mtls)
                placed.append((h, a.device_ids))
            out["gang_wall_s"] = time.perf_counter() - t
            bound = {p["metadata"]["name"]: p["spec"].get("nodeName")
                     for p in kube.store.list_pods()}
            if any(bound.get(f"train-{i}") != placed[i][0] for i in range(gang)):
                raise RuntimeError("a gang member is not bound where /bind said")
            with SimCluster(cfg, in_process=True) as sim:
                t = time.perf_counter()
                want = []
                for i in range(gang):
                    h, a = sim.schedule(sim.make_pod(f"train-{i}", tpu=1, group=group))
                    want.append((h, a.device_ids))
                out["gang_in_process_wall_s"] = time.perf_counter() - t
                out["gang_in_process_commit_ms"] = sim.extender.gang.reservation(
                    "default", "fleet-train").commit_latency * 1e3
            if placed != want:
                raise RuntimeError("the daemon placed the gang otherwise than the "
                                   "in-process port")
            page = metric_lines(https_get(f"{probe_base}/metrics", raw=True).decode())
            out["gang_commit_ms"] = page["gang_schedule_latency_seconds_sum"] * 1e3
            # g. ctl as children, over mTLS; /statusz with the client cert
            tls = ["--server", base, "--cacert", pki["ca"], "--cert",
                   pki["client_cert"], "--key", pki["client_key"]]
            ctl = {cmd: kids.spawn(f"ctl-{cmd}", ["ctl", *tls, cmd])
                   for cmd in ("topo", "alloc", "gangs", "metrics")}
            ctl_out = {}
            for cmd, proc in ctl.items():
                text, _ = proc.communicate(timeout=DAEMON_WAIT_S)
                if proc.returncode != 0:
                    raise RuntimeError(f"ctl {cmd} exited {proc.returncode}: "
                                       f"{Children.tail(proc)}")
                ctl_out[cmd] = text
            alloc_lines = ctl_out["alloc"].splitlines()
            if (not any(ln.startswith("default/daemon-0 ") and ln.endswith(" tpu-0")
                        for ln in alloc_lines) or len(alloc_lines) != gang + 1
                    or f"committed  {gang}/{gang} bound" not in ctl_out["gangs"]):
                raise RuntimeError(f"ctl alloc/gangs: {ctl_out['gangs']}")
            statusz = https_get(f"{base}/statusz", mtls)
            for watch in ("pod_watch", "node_watch"):
                w = statusz[watch]
                if not (w["configured"] and w["thread_alive"]
                        and w["stream_connected"] and not w["reconnects"]):
                    raise RuntimeError(f"/statusz {watch}: {w}")
            out["statusz_trace"] = statusz["trace"]
            out["statusz_ingest"] = {k: statusz["ingest"][k] for k in (
                "nodes_total", "batches", "seconds_total")}
            allocs_before = https_get(f"{base}/state/allocs", mtls)
            gangs_before = https_get(f"{base}/state/gangs", mtls)
            # h. SIGTERM, the trace replayed, a second daemon rebuilt
            rc, out["sigterm_to_exit_s"] = kids.stop(ext1)
            if rc != 0:
                raise RuntimeError(f"the extender exited {rc} on SIGTERM: "
                                   f"{Children.tail(ext1)}")
            rc, text = kids.run("ctl-replay", ["ctl", "replay", trace_path,
                                               "--config", cfg_path])
            if rc != 0 or ", 0 divergences" not in text:
                raise RuntimeError(f"ctl replay exited {rc}: {text[-2000:]}")
            out["replay"] = text.strip()
            ext2, out["restart_to_ready_ms"] = start_extender("extender-restarted")
            allocs_after = https_get(f"{base}/state/allocs", mtls)
            gangs_after = https_get(f"{base}/state/gangs", mtls)
            key = ("pod", "node", "devices", "priority")
            if ([{k: a[k] for k in key} for a in allocs_after]
                    != [{k: a[k] for k in key} for a in allocs_before]):
                raise RuntimeError("the restarted daemon rebuilt other allocations")
            gkey = ("namespace", "group", "committed", "members_bound", "slices")
            if ([{k: g[k] for k in gkey} for g in gangs_after]
                    != [{k: g[k] for k in gkey} for g in gangs_before]
                    or not gangs_after or not gangs_after[0]["committed"]):
                raise RuntimeError(f"the restarted daemon's gangs: {gangs_after}")
            out["rebuilt_allocations"] = len(allocs_after)
            # a new pod cannot take tpu-0 while daemon-0 lives; released by
            # the new daemon's lifecycle loop, it can
            kube.store.upsert_pod(pod_object("daemon-1", tpu=1))
            fres = client.filter_nodes(port, pod_object("daemon-1", tpu=1), [node],
                                       ssl_context=mtls)
            if fres["NodeNames"] or fres.get("Error"):
                raise RuntimeError(f"daemon-1 was schedulable on {node}: {fres}")
            done = dict(kube.store.get_pod("default", "daemon-0"))
            done["status"] = {"phase": "Succeeded"}
            t = time.perf_counter()
            kube.store.upsert_pod(done)
            t_rel = daemon_wait("daemon-0's release", lambda: "default/daemon-0" not in {
                a["pod"] for a in https_get(f"{base}/state/allocs", mtls)}, ext2)
            out["phase_to_release_ms"] = (t_rel - t) * 1e3
            _, alloc1, _ = client.place(port, pod_object("daemon-1", tpu=1), [node],
                                        ssl_context=mtls)
            if alloc1.device_ids != ["tpu-0"]:
                raise RuntimeError(f"daemon-1 bound {alloc1.device_ids}")
            out["second_bind"] = alloc1.device_ids
            for proc in (ext2, syncer):
                rc, _ = kids.stop(proc)
                if rc != 0:
                    raise RuntimeError(f"a daemon exited {rc} on SIGTERM: "
                                       f"{Children.tail(proc)}")
        # i. the scenario runner as a child
        rc, text = kids.run("sim", ["sim", "5"])
        lines = text.strip().splitlines()
        if rc != 0 or len(lines) != 1:
            raise RuntimeError(f"sim 5 exited {rc}: {text[-2000:]}")
        out["sim5_value"] = json.loads(lines[0])["value"]
        if out["sim5_value"] < NORTH_STAR_UTIL:
            raise RuntimeError(f"sim 5 utilization {out['sim5_value']}%")
        out["routes"] = dict(kube.requests)
    out["step_s"] = time.perf_counter() - t_step
    return out


def daemon_phase(card: str, c0, plain_ms: dict):
    """Step 14 on the card (``daemon_life`` with the card's node agent and
    a ``--scheduled`` pod); ``plain_ms`` is step 3's webhook round trips
    over plain HTTP. Returns the ``daemons:`` line's object, or None when
    a check failed."""
    try:
        life = daemon_life(lambda: node_agent({}, host=DAEMON_NODE),
                           run_child=lambda env: run_pod(["--scheduled"], env,
                                                         "scheduled"))
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        fail(f"daemons: {e}")
        return None
    sp = life.pop("child")
    if sp is None:
        return None
    checked = sp["scheduled"]
    if (sp["uuid"] != c0.chip_id or checked["pod"] != "default/daemon-0"
            or checked["device_ids"] != ["tpu-0"]):
        fail(f"daemon-0: {checked} on {sp['uuid']}")
        return None
    print("daemon pod: " + json.dumps(sp, sort_keys=True), flush=True)
    line = {"card": card, "host": host_cpu(), "webhook_plain_ms": plain_ms,
            "forward_ms": sp["forward_ms_median"], **life}
    print(
        f"daemons: extender ready at {life['hosts']} nodes "
        f"{life['spawn_to_ready_ms']:.1f} ms after spawn; file -> Node PATCH "
        f"{life['file_to_patch_ms']:.1f} ms; webhooks over mTLS "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in life["webhook_mtls_ms"].items())
        + " (plain HTTP, step 3: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in plain_ms.items())
        + f"); bind -> intent {life['bind_to_intent_ms']:.1f} ms; "
        f"{life['gang_size']}-member gang through the daemon in "
        f"{life['gang_wall_s']:.2f} s (commit {life['gang_commit_ms']:.1f} ms; "
        f"in process {life['gang_in_process_wall_s']:.2f} s, commit "
        f"{life['gang_in_process_commit_ms']:.1f} ms); SIGTERM -> exit "
        f"{life['sigterm_to_exit_s']:.2f} s; restart rebuilt "
        f"{life['rebuilt_allocations']} allocations, ready in "
        f"{life['restart_to_ready_ms']:.1f} ms; /state/topology "
        f"{life['topology_bytes']} bytes; step {life['step_s']:.1f} s "
        f"[host CPU times; {line['host']}; {card}]",
        flush=True,
    )
    return line


# -- crash and fault recovery (step 15) ---------------------------------------

CHAOS_SEED = "1337"  # the reference scenarios' default seed
JOURNAL_GANG = 64  # the gang the journaled daemon is killed in the middle of
# step 14's config plus the durable journal: fsync on every drained batch,
# and no cadence checkpoint within the step (the one before the kill is the
# checkpoint each recovery writes when it ends), so the WAL tail at the
# kill holds every decision since the daemon started serving
JOURNAL_CONFIG = DAEMON_CONFIG + """\
journal_enabled: true
journal_path: {wal}
journal_fsync: always
checkpoint_interval_seconds: 3600
"""
FALLBACK_LOG = "falling back to the legacy full rebuild"


def recovery_scenarios() -> dict:
    """Step 15a: scenarios 8, 9 and 13 of the port at the reference's sizes
    (13 at its default 8 crash cycles), seed 1337, every snapshot lookup
    audited. Each raises on its own invariants; the acceptance the
    reference's tests assert is checked here too. Returns the
    ``recovery:`` line's numbers."""
    from tpukube_torch.sim import scenarios

    with scenario_env({"TPUKUBE_CHAOS_SEED": CHAOS_SEED,
                       "TPUKUBE_SNAPSHOT_AUDIT_RATE": "1.0"}):
        r8, r9, r13 = (scenarios.run(n) for n in (8, 9, 13))
    for n, r in ((8, r8), (9, r9), (13, r13)):
        if (r["leaked_reservations"] or r["ledger_divergence"]
                or r["snapshot_audit"]["divergences"]):
            raise RuntimeError(f"scenario {n}: {r}")
    if not (r8["gang_committed"] and r8["blackout_refused"]
            and r8["circuit"]["opens"] >= 1 and not r8["evictions_pending"]
            and r8["faults"]["injected"] > 0):
        raise RuntimeError(f"scenario 8: {r8}")
    if not (r9["gang_committed"] and r9["partial_gang_restored"]
            and r9["restored"] == 4 and r9["agent_restart_allocate_ok"]):
        raise RuntimeError(f"scenario 9: {r9}")
    if (r13["crash_cycles"] != 8 or len(r13["recovery_modes"]) != 8
            or r13["warm_mode"] != "warm"
            or set(r13["seams"][:5]) != {"clean", "lost_tail", "torn_tail",
                                         "corrupt_tail", "torn_checkpoint"}):
        raise RuntimeError(f"scenario 13: {r13}")
    return {
        "wall_s": {n: r["wall_s"] for n, r in ((8, r8), (9, r9), (13, r13))},
        "s8_faults": r8["faults"]["by_kind"],
        "s8_circuit_opens": r8["circuit"]["opens"],
        "s9_recovery_s": r9["recovery_s"],
        "s13": {k: r13[k] for k in (
            "seams", "recovery_modes", "recovery_s_p50", "recovery_s_max",
            "warm_recovery_s", "cold_rebuild_s", "replay_speedup",
            "pods_placed", "faults_injected", "snapshot_audit")},
    }


def journal_life(card_agent, run_child=None, hosts: int = DAEMON_HOSTS,
                 gang: int = JOURNAL_GANG) -> dict:
    """Step 15b: the extender daemon with the durable journal, killed and
    recovered, over a REST stand-in apiserver holding step 14's fleet
    (``hosts`` HGX Node objects and this machine's). ``card_agent()``
    enters this machine's node agent (its node named ``DAEMON_NODE``);
    ``run_child(env)`` runs the card pod (None: no child). Returns the
    decisions and host-clock times; raises RuntimeError when a check
    fails. The tests run it at a small fleet."""
    import shutil
    import ssl
    import tempfile

    from tpukube_torch.apiserver import AllocIntentWatcher, rest_apiserver_from_config
    from tpukube_torch.chaos import crash
    from tpukube_torch.core import codec
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.sched import client
    from tpukube_torch.sched.extender import Extender
    from tpukube_torch.sched.journal import JournalError, recover_extender
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim import SimCluster
    from tpukube_torch.sim.harness import _free_port
    from tpukube_torch.sim.kube_rest import KubeRestServer

    out: dict = {"hosts": hosts + 1, "gang_size": gang}
    t_step = time.perf_counter()
    with tempfile.TemporaryDirectory() as td, \
            KubeRestServer(token=REST_TOKEN) as kube, \
            contextlib.ExitStack() as stack:
        kids = Children(td)
        stack.callback(kids.close)
        pki = mint_pki(td)
        mtls = ssl.create_default_context(cafile=pki["ca"])
        mtls.load_cert_chain(pki["client_cert"], pki["client_key"])
        wal = os.path.join(td, "wal.jsonl")
        cfg_path = os.path.join(td, "config.yaml")
        with open(cfg_path, "w") as f:
            f.write(JOURNAL_CONFIG.format(
                hosts=hosts, poll=REST_POLL_S, wal=wal,
                trace=os.path.join(td, "trace.jsonl"),
                events=os.path.join(td, "events.jsonl")))
        token_path = os.path.join(td, "token")
        with open(token_path, "w") as f:
            f.write(REST_TOKEN + "\n")
        # the in-process sims of the same config keep no capture and no
        # journal: the files are the daemon's
        cfg = dataclasses.replace(
            load_config(yaml_path=cfg_path, env={}), trace_path="",
            events_path="", journal_enabled=False, journal_path="")
        with SimCluster(cfg, in_process=True) as sim:
            fleet = sim.node_objects()
        for obj in fleet:
            kube.store.patch_node_annotations(obj["metadata"]["name"],
                                              obj["metadata"]["annotations"])
        names = sorted([o["metadata"]["name"] for o in fleet] + [DAEMON_NODE])
        api = rest_apiserver_from_config(load_config(env={}), kube.base_url,
                                         token=REST_TOKEN)
        with card_agent() as agent:
            node = agent.mgr.host
            if node != DAEMON_NODE:
                raise RuntimeError(f"the node agent names its node {node}")
            kube.store.patch_node_annotations(node, codec.annotate_node(
                agent.mgr.node_info(), agent.mgr.mesh))
            port, probe = _free_port(), _free_port()
            ext_args = [
                "extender", "--config", cfg_path, "--host", "127.0.0.1",
                "--port", str(port), "--tls-cert", pki["cert"],
                "--tls-key", pki["key"], "--tls-client-ca", pki["ca"],
                "--probe-port", str(probe), "--kube-api", kube.base_url,
                "--kube-token-file", token_path]
            base = f"https://127.0.0.1:{port}"
            probe_base = f"http://127.0.0.1:{probe}"

            def start_extender(name: str, t0: float):
                proc = kids.spawn(name, ext_args)
                t_ready = daemon_wait(f"{name} ready at {len(names)} nodes", lambda: len(
                    https_get(f"{probe_base}/healthz")["nodes"]) == len(names), proc)
                return proc, (t_ready - t0) * 1e3

            def state() -> tuple:
                return (https_get(f"{base}/state/allocs", mtls),
                        https_get(f"{base}/state/gangs", mtls))

            def kill(proc) -> float:
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=DAEMON_WAIT_S)
                return time.perf_counter()

            def place(pod) -> tuple:
                kube.store.upsert_pod(pod)
                host, alloc, _ = client.place(port, pod, names, ssl_context=mtls)
                return host, alloc.device_ids

            ext, out["first_start_ms"] = start_extender("journaled",
                                                        time.perf_counter())
            # journal-0 on this machine's tpu-0
            intents = AllocIntentWatcher(api, node, agent.server,
                                         poll_seconds=REST_POLL_S)
            intents.start()
            stack.callback(intents.stop)
            wait_for("the intent watch", intents.stream_connected)
            kube.store.upsert_pod(pod_object("journal-0", tpu=1))
            host, alloc, _ = client.place(port, pod_object("journal-0", tpu=1),
                                          [node], ssl_context=mtls)
            if host != node or alloc.device_ids != ["tpu-0"]:
                raise RuntimeError(f"journal-0 bound {alloc.device_ids} on {host}")
            # half the gang, then SIGKILL after the last of its binds
            group = PodGroup("journal-train", min_member=gang)
            members = [pod_object(f"jt-{i}", tpu=1,
                                  annotations=codec.pod_group_annotations(group))
                       for i in range(gang)]
            t = time.perf_counter()
            placed = [place(p) for p in members[:gang // 2]]
            gang_s = time.perf_counter() - t
            before = state()
            out["killed_at"] = {"allocations": len(before[0]),
                                "members_bound": before[1][0]["members_bound"]}
            # a. SIGKILL; the restart recovers warm from the checkpoint its
            # first start wrote and the WAL tail behind it
            ext, out["kill_to_ready_ms"] = start_extender("journaled-warm",
                                                          kill(ext))
            recovery = https_get(f"{base}/statusz", mtls)["journal"]["last_recovery"]
            if (FALLBACK_LOG in Children.tail(ext) or recovery is None
                    or recovery["mode"] != "warm" or not recovery["checkpoint"]
                    or recovery["replayed"] <= 0):
                raise RuntimeError(f"the restart did not recover warm: {recovery}: "
                                   f"{Children.tail(ext)}")
            out["recovery"] = {k: recovery[k] for k in (
                "mode", "recovery_s", "replayed", "restored_allocs",
                "restored_gangs", "divergences")}
            if state() != before:
                raise RuntimeError("the recovered daemon serves other allocations "
                                   "or gangs than before the kill")
            # tpu-0 is refused to a new pod while journal-0 lives
            fres = client.filter_nodes(port, pod_object("journal-1", tpu=1), [node],
                                       ssl_context=mtls)
            if fres["NodeNames"] or fres.get("Error"):
                raise RuntimeError(f"journal-1 was schedulable on {node}: {fres}")
            # the other half binds and the gang commits where the in-process
            # port places the same gang on the same fleet
            t = time.perf_counter()
            placed += [place(p) for p in members[gang // 2:]]
            out["gang_wall_s"] = gang_s + time.perf_counter() - t
            gangs = https_get(f"{base}/state/gangs", mtls)
            if [(g["group"], g["committed"], g["members_bound"]) for g in gangs] \
                    != [("journal-train", True, gang)]:
                raise RuntimeError(f"the gang after the restart: {gangs}")
            with SimCluster(cfg, in_process=True) as sim:
                want = [sim.schedule(sim.make_pod(f"jt-{i}", tpu=1, group=group))
                        for i in range(gang)]
            if placed != [(h, a.device_ids) for h, a in want]:
                raise RuntimeError("the recovered daemon placed the gang otherwise "
                                   "than the in-process port")
            page = metric_lines(https_get(f"{probe_base}/metrics", raw=True).decode())
            out["metrics"] = {k: page.get(k) for k in (
                "tpukube_recovery_seconds_sum", "tpukube_recovery_seconds_count",
                "tpukube_recovery_replayed_deltas_total",
                'tpukube_checkpoint_seconds{quantile="0.5"}',
                "tpukube_checkpoint_seconds_count",
                "tpukube_journal_appends_total", "tpukube_journal_bytes_total")}
            if not (page.get("tpukube_recovery_seconds_count")
                    and page.get("tpukube_checkpoint_seconds_count")
                    and page.get("tpukube_recovery_replayed_deltas_total", 0)
                    == recovery["replayed"]):
                raise RuntimeError(f"the journal's /metrics: {out['metrics']}")
            out["wal_bytes_on_disk"] = os.path.getsize(wal)
            # journal-0 ends; the lifecycle loop releases tpu-0 for journal-1
            done = dict(kube.store.get_pod("default", "journal-0"))
            done["status"] = {"phase": "Succeeded"}
            kube.store.upsert_pod(done)
            daemon_wait("journal-0's release", lambda: "default/journal-0" not in {
                a["pod"] for a in https_get(f"{base}/state/allocs", mtls)}, ext)
            kube.store.upsert_pod(pod_object("journal-1", tpu=1))
            host, alloc1, _ = client.place(port, pod_object("journal-1", tpu=1),
                                           [node], ssl_context=mtls)
            if host != node or alloc1.device_ids != ["tpu-0"]:
                raise RuntimeError(f"journal-1 bound {alloc1.device_ids} on {host}")
            wait_for("journal-1's intent", lambda: agent.server.intents
                     .snapshot().get("default/journal-1") == alloc1.device_ids)
            stored = kube.store.get_pod("default", "journal-1")
            payload = stored["metadata"]["annotations"][codec.ANNO_ALLOC]
            penv = agent.kubelet.allocate(agent.server.resource_name,
                                          alloc1.device_ids)
            if run_child is not None:
                out["child"] = run_child({**alloc1.env, **penv, ENV_ALLOC: payload})
            # b. SIGKILL again and tear the checkpoint: the restart must
            # take the mode the port's recover_extender takes on those
            # files, and serve the same allocations (degraded, never wrong)
            before = state()
            t_kill = kill(ext)
            if not crash.tear_checkpoint(wal + ".ckpt"):
                raise RuntimeError("no checkpoint to tear")
            probe_dir = os.path.join(td, "probe")
            os.mkdir(probe_dir)
            for fn in os.listdir(td):
                if fn.startswith("wal.jsonl"):
                    shutil.copy(os.path.join(td, fn), probe_dir)
            oracle = Extender(dataclasses.replace(
                cfg, journal_enabled=True,
                journal_path=os.path.join(probe_dir, "wal.jsonl")))
            try:
                want_mode = recover_extender(oracle, api)["mode"]
            except JournalError:
                want_mode = "cold-fallback"
            finally:
                oracle.journal.crash()
                oracle.state.retire()
            t_spawn = time.perf_counter()
            ext, out["torn_kill_to_ready_ms"] = start_extender("journaled-torn",
                                                               t_kill)
            out["torn_spawn_to_ready_ms"] = (time.perf_counter() - t_spawn) * 1e3
            recovery = https_get(f"{base}/statusz", mtls)["journal"]["last_recovery"]
            mode = ("cold-fallback" if FALLBACK_LOG in Children.tail(ext)
                    else (recovery or {}).get("mode"))
            if mode != want_mode:
                raise RuntimeError(f"the torn-checkpoint restart took {mode}, the "
                                   f"port's recovery takes {want_mode}")
            out["torn_mode"] = mode
            if state() != before:
                raise RuntimeError("the torn-checkpoint restart serves other "
                                   "allocations or gangs")
            rc, _ = kids.stop(ext)
            if rc != 0:
                raise RuntimeError(f"the journaled daemon exited {rc} on SIGTERM: "
                                   f"{Children.tail(ext)}")
        out["routes"] = dict(kube.requests)
    out["step_s"] = time.perf_counter() - t_step
    return out


def recovery_phase(card: str, c0, daemons: dict):
    """Step 15 on the card: the chaos scenarios (15a), then ``journal_life``
    with the card's node agent and a ``--scheduled`` pod (15b); prints the
    ``recovery:`` and ``journal:`` lines. ``daemons`` is step 14's line
    (its cold restart is printed beside the warm one). Returns the two
    lines' objects, or None when a check failed."""
    host = host_cpu()
    try:
        scen = recovery_scenarios()
        life = journal_life(lambda: node_agent({}, host=DAEMON_NODE),
                            run_child=lambda env: run_pod(["--scheduled"], env,
                                                          "scheduled"))
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        fail(f"recovery: {e}")
        return None
    s13 = scen["s13"]
    rec_line = {"card": card, "host": host, **scen}
    print(
        f"recovery: scenario 8 {scen['wall_s'][8]:.2f} s, faults "
        f"{json.dumps(scen['s8_faults'], sort_keys=True)}, circuit opened "
        f"{scen['s8_circuit_opens']}x; scenario 9 {scen['wall_s'][9]:.2f} s; "
        f"scenario 13 {scen['wall_s'][13]:.2f} s, seams {s13['seams']}, modes "
        f"{s13['recovery_modes']}, recovery p50 {s13['recovery_s_p50']} s max "
        f"{s13['recovery_s_max']} s, warm {s13['warm_recovery_s']} s vs cold "
        f"rebuild {s13['cold_rebuild_s']} s ({s13['replay_speedup']}x) "
        f"[host CPU times; {host}; {card}]",
        flush=True,
    )
    sp = life.pop("child")
    if sp is None:
        return None
    checked = sp["scheduled"]
    if (sp["uuid"] != c0.chip_id or checked["pod"] != "default/journal-1"
            or checked["device_ids"] != ["tpu-0"]):
        fail(f"journal-1: {checked} on {sp['uuid']}")
        return None
    print("journal pod: " + json.dumps(sp, sort_keys=True), flush=True)
    m = life["metrics"]
    ckpt_p50 = m['tpukube_checkpoint_seconds{quantile="0.5"}']
    line = {"card": card, "host": host, "forward_ms": sp["forward_ms_median"],
            "cold_restart_to_ready_ms": daemons["restart_to_ready_ms"], **life}
    print(
        f"journal: SIGKILL mid-gang ({life['killed_at']['members_bound']}/"
        f"{life['gang_size']} bound) -> ready {life['kill_to_ready_ms']:.1f} ms "
        f"warm at {life['hosts']} nodes ({life['recovery']['replayed']} records "
        f"replayed, tpukube_recovery_seconds sum "
        f"{m['tpukube_recovery_seconds_sum']:.4f} s; step 14's cold restart "
        f"{daemons['restart_to_ready_ms']:.1f} ms); checkpoint p50 "
        f"{ckpt_p50:.4f} s; WAL "
        f"{m['tpukube_journal_bytes_total']:.0f} bytes in "
        f"{m['tpukube_journal_appends_total']:.0f} appends; "
        f"{life['gang_size']}-member gang {life['gang_wall_s']:.2f} s with "
        f"fsync always; torn checkpoint -> {life['torn_mode']} "
        f"{life['torn_kill_to_ready_ms']:.1f} ms; journal-1 request "
        f"{sp['forward_ms_median']:.3f} ms; step {life['step_s']:.1f} s "
        f"[host CPU times; {host}; {card}]",
        flush=True,
    )
    return rec_line, line


# -- the multi-tenant serving plane (step 16) ----------------------------------

TENANCY_WAVES = "8"  # scenario 11's default trace (the reference's size)
TENANT_LABEL = "tpu.qiniu.com/tenant"  # tenancy_label's default
# half a card for team-a (one share of two), a whole card for team-b
TENANCY_QUOTAS = "team-a=chips:0.5;team-b=chips:1"
# step 14's config with the tenancy plane on
TENANCY_CONFIG = DAEMON_CONFIG + """\
tenancy_enabled: true
tenancy_quotas: "{quotas}"
"""
# /statusz tenants fields that are process counters (they restart at 0)
TENANT_COUNTERS = ("sheds", "quota_denials")


def tenancy_scenarios() -> dict:
    """Step 16a: scenario 11 of the port at the reference's size (8
    waves, seed 1337) and scenario 7, each held to the invariants the
    reference's tests assert (each scenario also raises on its own).
    Returns the ``tenancy:`` line's scenario numbers."""
    from tpukube_torch.sim import scenarios

    with scenario_env({"TPUKUBE_CHAOS_SEED": CHAOS_SEED,
                       "TPUKUBE_TENANCY_WAVES": TENANCY_WAVES}):
        r11 = scenarios.run(11)
    sheds, denials = r11["sheds_by_tenant"], r11["quota_denials_by_tenant"]
    if (r11["quota_violations"] or r11["value"] is None or r11["value"] > 2.0
            or set(r11["gangs_committed"]) != {"diurnal-train", "slo-probe"}
            or r11["preemptions"] <= 0 or not sum(sheds.values())
            or sum(sheds.values()) != r11["shed_events_journaled"]
            or not sum(denials.values())
            or sum(denials.values()) != r11["denial_events_journaled"]
            or r11["leaked_reservations"] or r11["ledger_divergence"]
            or r11["steady_utilization_min_percent"] < 90):
        raise RuntimeError(f"scenario 11: {r11}")
    r7 = scenarios.run(7)
    fleet = (r7["fleet_degraded"], r7["fleet_recovered"])
    if (r7["transitions"] != {"chip_fault": True, "link_fault": True,
                              "recovery": True}
            or not {"ChipUnhealthy", "ChipRecovered", "LinkFault",
                    "LinkRecovered"} <= set(r7["event_reasons"])
            or r7["chip_series_on_node_metrics"] < 16
            or (fleet[0]["unhealthy"], fleet[0]["degraded"],
                fleet[0]["links_down"]) != (1, 2, 1)
            or (fleet[1]["unhealthy"], fleet[1]["degraded"],
                fleet[1]["healthy"]) != (0, 0, 16)
            or any(v["total"] <= 0 or v["burn_rate"] is None
                   for v in r7["slo"].values())):
        raise RuntimeError(f"scenario 7: {r7}")
    return {
        "s11_wall_s": r11["wall_s"],
        "s11_share_ratio": r11["value"],
        "s11_sheds_by_tenant": sheds,
        "s11_quota_denials_by_tenant": denials,
        "s11_preemptions": r11["preemptions"],
        "s11_steady_utilization_min_percent":
            r11["steady_utilization_min_percent"],
        "s11_pods_placed": r11["pods_placed"],
        "s7_wall_s": r7["wall_s"],
        "s7_slo": r7["slo"],
    }


def tenancy_life(share_agent, run_pair=None) -> dict:
    """Step 16b: two tenants share this machine's card through the
    extender daemon with ``tenancy_enabled`` (started as step 14 starts
    it: config file, mTLS, probe port, the REST stand-in).
    ``share_agent()`` enters the node agent with two shares per card (its
    node named ``DAEMON_NODE``); ``run_pair(envs, agent, during)`` runs
    the two tenants' pods on their share envs and calls ``during()``
    while they run (None: no pods, ``during()`` alone). Returns the
    decisions and host-clock times; raises RuntimeError when a check
    fails. The tests run it on a sim share node."""
    import ssl
    import tempfile

    from tpukube_torch.core import codec
    from tpukube_torch.device.gpu import ENV_KUBE_TENANT
    from tpukube_torch.sched import client
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim.harness import _free_port
    from tpukube_torch.sim.kube_rest import KubeRestServer
    from tpukube_torch.workload.meshenv import PodGpuEnv

    out: dict = {"quotas": TENANCY_QUOTAS}
    t_step = time.perf_counter()
    with tempfile.TemporaryDirectory() as td, \
            KubeRestServer(token=REST_TOKEN) as kube, \
            contextlib.ExitStack() as stack:
        kids = Children(td)
        stack.callback(kids.close)
        pki = mint_pki(td)
        mtls = ssl.create_default_context(cafile=pki["ca"])
        mtls.load_cert_chain(pki["client_cert"], pki["client_key"])
        cfg_path = os.path.join(td, "config.yaml")
        with open(cfg_path, "w") as f:
            f.write(TENANCY_CONFIG.format(
                hosts=1, poll=REST_POLL_S,
                trace=os.path.join(td, "trace.jsonl"),
                events=os.path.join(td, "events.jsonl"),
                quotas=TENANCY_QUOTAS))
        token_path = os.path.join(td, "token")
        with open(token_path, "w") as f:
            f.write(REST_TOKEN + "\n")
        with share_agent() as agent:
            node = agent.mgr.host
            if node != DAEMON_NODE:
                raise RuntimeError(f"the node agent names its node {node}")
            # the node agent's two-share annotation on this machine's Node
            kube.store.patch_node_annotations(
                node, codec.annotate_node(agent.mgr.node_info(), agent.mgr.mesh))
            port, probe = _free_port(), _free_port()
            ext_args = [
                "extender", "--config", cfg_path, "--host", "127.0.0.1",
                "--port", str(port), "--tls-cert", pki["cert"],
                "--tls-key", pki["key"], "--tls-client-ca", pki["ca"],
                "--probe-port", str(probe), "--kube-api", kube.base_url,
                "--kube-token-file", token_path]
            base = f"https://127.0.0.1:{port}"
            probe_base = f"http://127.0.0.1:{probe}"

            def start_extender(name: str):
                t0 = time.perf_counter()
                proc = kids.spawn(name, ext_args)
                t_ready = daemon_wait(f"{name} ready", lambda: https_get(
                    f"{probe_base}/healthz")["nodes"] == [node], proc)
                return proc, (t_ready - t0) * 1e3

            def metrics() -> dict:
                return metric_lines(
                    https_get(f"{probe_base}/metrics", raw=True).decode())

            def pod(name: str, tenant: str) -> dict:
                obj = pod_object(name, vtpu=1)
                obj["metadata"]["labels"] = {TENANT_LABEL: tenant}
                kube.store.upsert_pod(obj)
                return obj

            def place(name: str, tenant: str):
                _, alloc, ms = client.place(port, pod(name, tenant), [node],
                                            ssl_context=mtls)
                env = allocate(agent, alloc)
                seen = PodGpuEnv.from_env(env).tenant
                if env.get(ENV_KUBE_TENANT) != tenant or seen != tenant:
                    raise RuntimeError(f"{name}'s env names tenant {seen!r}")
                out["binds"][name] = alloc.device_ids
                out["tenants_env"][name] = seen
                out["webhook_ms"][name] = ms
                return env

            def tenants_doc() -> dict:
                doc = https_get(f"{base}/statusz", mtls)["tenants"]
                return {"capacity": doc["capacity"],
                        "max_min_share_ratio": doc["max_min_share_ratio"],
                        "tenants": {t: {k: v for k, v in d.items()
                                        if k not in TENANT_COUNTERS}
                                    for t, d in doc["tenants"].items()}}

            out.update(binds={}, tenants_env={}, webhook_ms={})
            ext1, out["spawn_to_ready_ms"] = start_extender("extender-tenancy")
            envs = [place("team-a-0", "team-a")]
            # no SLO burns at the page threshold: the refusal below is
            # the quota's, not a shed
            out["shedding_before_refusal"] = metrics()["tpukube_tenancy_shedding"]
            if out["shedding_before_refusal"] != 0:
                raise RuntimeError("the tenancy plane is shedding")
            t = time.perf_counter()
            fres = client.filter_nodes(port, pod("team-a-1", "team-a"), [node],
                                       ssl_context=mtls)
            out["refusal_ms"] = (time.perf_counter() - t) * 1e3
            out["refusal"] = fres.get("Error") or ""
            if fres["NodeNames"] or "quota" not in out["refusal"]:
                raise RuntimeError(f"team-a-1 was not refused by quota: {fres}")
            events = https_get(f"{base}/events?reason=TenantQuotaDenied", mtls)
            if [e["object"] for e in events] != ["pod/default/team-a-1"]:
                raise RuntimeError(f"TenantQuotaDenied events: {events}")
            out["quota_denials_metric"] = metrics()[
                'tpukube_tenant_quota_denials_total{tenant="team-a"}']
            if out["quota_denials_metric"] != 1:
                raise RuntimeError(f"quota denials {out['quota_denials_metric']}")
            envs.append(place("team-b-0", "team-b"))
            if (out["binds"]["team-a-0"] != ["tpu-0-frac0of2"]
                    or out["binds"]["team-b-0"] != ["tpu-0-frac1of2"]):
                raise RuntimeError(f"the tenants bound {out['binds']}")

            def during() -> None:
                doc = https_get(f"{base}/statusz", mtls)["tenants"]["tenants"]
                chips = {t: doc[t]["chips_used"] for t in ("team-a", "team-b")}
                page = metrics()
                gauge = {t: page[f'tpukube_tenant_chips_used{{tenant="{t}"}}']
                         for t in chips}
                if chips != {"team-a": 0.5, "team-b": 0.5} or gauge != chips:
                    raise RuntimeError(f"tenant usage {chips}, gauge {gauge}")
                rc, text = kids.run("obs-slo", ["obs", "slo", "--url",
                                                f"{probe_base}/metrics"])
                if rc != 0:
                    raise RuntimeError(f"obs slo exited {rc}: {text[-2000:]}")
                out["chips_used"] = chips
                out["slo_burn"] = {k: v["burn_rate"]
                                   for k, v in json.loads(text).items()}

            if run_pair is None:
                during()
            else:
                out["pods"] = run_pair(envs, agent, during)
            before = (tenants_doc(), https_get(f"{base}/state/allocs", mtls))
            rc, _ = kids.stop(ext1)
            if rc != 0:
                raise RuntimeError(f"the extender exited {rc} on SIGTERM: "
                                   f"{Children.tail(ext1)}")
            ext2, out["restart_to_ready_ms"] = start_extender(
                "extender-tenancy-restarted")
            after = (tenants_doc(), https_get(f"{base}/state/allocs", mtls))
            out["restart_same_tenants"] = after[0] == before[0]
            out["restart_same_allocs"] = after[1] == before[1]
            if not (out["restart_same_tenants"] and out["restart_same_allocs"]):
                raise RuntimeError(f"the restarted daemon's tenants {after[0]} "
                                   f"and allocations {after[1]}, before "
                                   f"{before}")
            out["tenants_after_restart"] = after[0]["tenants"]
            # team-a-0 ends; the lifecycle loop releases its share, and
            # team-a-1's retry is admitted onto it
            done = dict(kube.store.get_pod("default", "team-a-0"))
            done["status"] = {"phase": "Succeeded"}
            t = time.perf_counter()
            kube.store.upsert_pod(done)
            t_rel = daemon_wait("team-a-0's release", lambda: "default/team-a-0"
                                not in {a["pod"] for a in https_get(
                                    f"{base}/state/allocs", mtls)}, ext2)
            out["phase_to_release_ms"] = (t_rel - t) * 1e3
            place("team-a-1", "team-a")
            if out["binds"]["team-a-1"] != ["tpu-0-frac0of2"]:
                raise RuntimeError(f"team-a-1 bound {out['binds']['team-a-1']}")
            rc, _ = kids.stop(ext2)
            if rc != 0:
                raise RuntimeError(f"the extender exited {rc} on SIGTERM: "
                                   f"{Children.tail(ext2)}")
        out["routes"] = dict(kube.requests)
    out["step_s"] = time.perf_counter() - t_step
    return out


def tenancy_phase(card: str, c0, daemons: dict, step8: list):
    """Step 16 on the card: the scenarios (16a), then ``tenancy_life`` with
    the card's two-share node agent, the two tenants' ``--shared`` pods
    serving Llama-3-8B under the guard (16b); prints the ``tenancy:``
    line's text. ``daemons`` is step 14's line (its /filter round trip
    over mTLS with tenancy off) and ``step8`` step 8's shared pods'
    reports. Returns the line's object, or None when a check failed."""
    from tpukube_torch.native import cudaguard

    host = host_cpu()
    guard = cudaguard.library_path()
    quota = c0.hbm_bytes // 2

    def run_pair(envs, agent, during):
        ran = run_shared(envs, guard, agent.mgr, during=during)
        if ran is None:
            raise RuntimeError("the tenants' shared pods failed")
        return ran[0]

    try:
        scen = tenancy_scenarios()
        life = tenancy_life(
            lambda: node_agent({"TPUKUBE_SHARES_PER_CHIP": "2"}, host=DAEMON_NODE),
            run_pair=run_pair)
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        fail(f"tenancy: {e}")
        return None
    reports = life.pop("pods")
    for tenant, r in zip(("team-a", "team-b"), reports):
        if (r["uuid"] != c0.chip_id or r["tenant"] != tenant
                or r["max_memory_reserved"] > quota or r["guard_peak"] > quota):
            fail(f"{tenant}'s pod: {r}")
            return None
        print(f"tenant pod {tenant}: " + json.dumps(r, sort_keys=True), flush=True)
    per_pod = {t: {"forward_ms_median": r["forward_ms_median"],
                   "tokens_per_s": r["tokens_per_s"]}
               for t, r in zip(("team-a", "team-b"), reports)}
    step8_pods = [{"forward_ms_median": r["forward_ms_median"],
                   "tokens_per_s": r["tokens_per_s"]} for r in step8]
    tenancy_filter = {t: life["webhook_ms"][f"{t}-0"]["filter"]
                      for t in ("team-a", "team-b")}
    line = {"card": card, "host": host, **scen, **life, "pods": per_pod,
            "step8_pods": step8_pods,
            "step14_webhook_mtls_ms": daemons["webhook_mtls_ms"]}
    print(
        f"tenancy: scenario 11 ({TENANCY_WAVES} waves, seed {CHAOS_SEED}) "
        f"{scen['s11_wall_s']:.2f} s, share ratio {scen['s11_share_ratio']}, "
        f"sheds {json.dumps(scen['s11_sheds_by_tenant'], sort_keys=True)}, "
        f"quota denials "
        f"{json.dumps(scen['s11_quota_denials_by_tenant'], sort_keys=True)}, "
        f"{scen['s11_preemptions']} preemptions, steady utilization min "
        f"{scen['s11_steady_utilization_min_percent']}%; scenario 7 "
        f"{scen['s7_wall_s']:.2f} s; daemon /filter with tenancy on "
        + ", ".join(f"{t} {v:.3f} ms" for t, v in tenancy_filter.items())
        + f" (step 14, tenancy off: {daemons['webhook_mtls_ms']['filter']:.3f} "
        f"ms); team-a-1 refused by quota in {life['refusal_ms']:.3f} ms "
        f"(tpukube_tenancy_shedding {life['shedding_before_refusal']:g}); "
        f"restart -> ready {life['restart_to_ready_ms']:.1f} ms with the "
        f"same tenants; team-a-0 Succeeded -> released "
        f"{life['phase_to_release_ms']:.1f} ms, team-a-1 placed on "
        f"{life['binds']['team-a-1']}; Llama-3-8B B=1 S=2048 per pod: "
        + ", ".join(f"{t} {v['forward_ms_median']:.3f} ms "
                    f"{v['tokens_per_s']:.1f} tokens/s" for t, v in per_pod.items())
        + " (step 8: "
        + ", ".join(f"{v['forward_ms_median']:.3f} ms {v['tokens_per_s']:.1f} "
                    f"tokens/s" for v in step8_pods)
        + f"); step {life['step_s']:.1f} s [host CPU times; {host}; {card}]",
        flush=True,
    )
    return line


# -- fleet elasticity and capacity forensics (step 17) -------------------------

MAINT_CYCLES = "6"  # scenario 15's default storm (the reference's size)
DRAIN_POINT_BUDGET = "2"  # the graceful drain point's eviction budget
SCALE_UP_NODES = 10240  # the scale-up point: one slice of 32x32x40, 4 per node
# the in-process extender of 17b: every elasticity plane on, the batch
# cycle, the journal; the autoscaler scales up on one queued pod, keeps
# at least one slice and acts on every evaluation (no cooldown)
DRAIN_LIFE_ENV = {
    "TPUKUBE_BATCH_ENABLED": "1", "TPUKUBE_DRAIN_ENABLED": "1",
    "TPUKUBE_CAPACITY_ENABLED": "1", "TPUKUBE_AUTOSCALE_ENABLED": "1",
    "TPUKUBE_AUTOSCALE_UP_QUEUE_DEPTH": "1",
    "TPUKUBE_AUTOSCALE_MIN_SLICES": "1",
    "TPUKUBE_AUTOSCALE_COOLDOWN_SECONDS": "0",
    "TPUKUBE_JOURNAL_ENABLED": "1", "TPUKUBE_JOURNAL_FSYNC": "always",
}


def elasticity_scenarios() -> dict:
    """Step 17a: scenario 15 of the port (phases A, B and C) at the
    reference's size and seed, every snapshot lookup audited, held to the
    invariants the reference asserts (the scenario raises on a partial
    gang, a leak, a divergence, a lost cordon or a tick over the budget;
    they are checked here again); then the two direct points of the
    reference's elasticity bench on the port's code. Returns the
    ``elasticity:`` line's host-side numbers."""
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.mesh import MeshSpec
    from tpukube_torch.sim import scenarios
    from tpukube_torch.sim.harness import SimCluster

    with scenario_env({"TPUKUBE_CHAOS_SEED": CHAOS_SEED,
                       "TPUKUBE_MAINT_CYCLES": MAINT_CYCLES,
                       "TPUKUBE_SNAPSHOT_AUDIT_RATE": "1.0"}):
        r15 = scenarios.run(15)
    storm, scale, audit = r15["storm"], r15["autoscale"], r15["snapshot_audit"]
    if (r15["peak_tick_moves"] > r15["budget_moves"] or audit["divergences"]
            or not audit["checks"] or not storm["drains_completed"]
            or not storm["spot_kills"] or scale["scale_ups"] != 1
            or scale["scale_downs"] != 1
            or not r15["sharded"]["drained_slices"]):
        raise RuntimeError(f"scenario 15: {r15}")
    out = {
        "s15_wall_s": r15["wall_s"], "s15_cycles": r15["cycles"],
        "s15_drains_completed": storm["drains_completed"],
        "s15_scale_downs": scale["scale_downs"],
        "s15_rebalanced_slices": len(r15["sharded"]["drained_slices"]),
        "s15_last_incarnation_evictions":
            storm["last_incarnation_drain"].get("evictions", 0),
        "s15_spot_kills": storm["spot_kills"],
        "s15_returned_slices": storm["returned_slices"],
        "s15_peak_tick_moves": r15["peak_tick_moves"],
        "s15_budget_moves": r15["budget_moves"],
        "s15_audit_checks": audit["checks"],
    }
    # one graceful drain of a resident-loaded 64-chip slice under budget
    # 2, from begin() until the slice leaves the ledger
    cfg = load_config(env={"TPUKUBE_BACKEND": "sim",
                           "TPUKUBE_DRAIN_ENABLED": "1",
                           "TPUKUBE_DRAIN_MAX_CONCURRENT_MOVES":
                               DRAIN_POINT_BUDGET})
    mesh = MeshSpec(dims=(4, 4, 4), host_block=(2, 2, 1))
    with SimCluster(cfg, clock=FakeClock(), in_process=True,
                    slices={"s0": mesh, "s1": mesh}) as c:
        ext = c.extender
        for i in range(16):
            c.schedule(c.make_pod(f"d{i}", tpu=2))
        doomed = sorted(n for n in ext.state.node_names()
                        if ext.state.slice_of_node(n) == "s0")
        t0 = time.perf_counter()
        ext.drain.begin(doomed, reason="elasticity point")
        ticks = 0
        while ext.drain.active():
            ext.drain.tick()
            c.clock.advance(1.0)
            ticks += 1
            if ticks > 200:
                raise RuntimeError("the drain point did not converge")
        wall = time.perf_counter() - t0
        st = ext.drain.statusz()
        if st["completed"] != 1 or "s0" in ext.state.slice_ids():
            raise RuntimeError(f"the drain point did not complete: {st}")
    out.update(drain_point_wall_s=wall, drain_point_ticks=ticks,
               drain_point_evictions=st["evictions_total"],
               drain_point_peak_tick_moves=st["peak_tick_moves"],
               drained_chips_per_s=st["chips_removed_total"] / max(wall, 1e-9))
    out.update(scale_up_point(SCALE_UP_NODES))
    return out


def scale_up_point(n_nodes: int) -> dict:
    """Bulk provisioning of one fresh slice of ``n_nodes`` nodes (4 GPUs
    each under a 2,2,1 host block, the reference's 32x32x40 geometry at
    10,240 nodes) through ``upsert_nodes`` until its chips are free to
    the placement sweeps: the scale-up's time to capacity."""
    from tpukube_torch.core import codec
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.mesh import MeshSpec
    from tpukube_torch.core.types import ChipInfo, NodeInfo
    from tpukube_torch.sched.extender import Extender

    dims = (32, 32, max(1, n_nodes * 4 // (32 * 32)))
    mesh = MeshSpec(dims=dims, host_block=(2, 2, 1))
    items = []
    for host in mesh.all_hosts()[:n_nodes]:
        name = f"as-{host}"
        chips = [ChipInfo(chip_id=f"{name}-chip-{i}", index=i, coord=c,
                          hbm_bytes=16 * 2**30)
                 for i, c in enumerate(mesh.coords_of_host(host))]
        items.append({"name": name, "annotations": codec.annotate_node(
            NodeInfo(name=name, chips=chips, slice_id="as"), mesh)})
    ext = Extender(load_config(env={"TPUKUBE_BACKEND": "sim"}))
    try:
        t0 = time.perf_counter()
        results = ext.upsert_nodes_many(items)
        snap = ext.snapshots.current()
        free = sum(snap.slice(sid).free_chips for sid in ext.state.slice_ids())
        took = time.perf_counter() - t0
    finally:
        ext.state.retire()
    bad = [r for r in results if r != {"ours": True}]
    if bad or free != len(items) * 4:
        raise RuntimeError(f"the scale-up point: {len(bad)} rejects, "
                           f"{free} GPUs free of {len(items) * 4}")
    return {"scale_up_nodes": len(items), "scale_up_gpus": free,
            "scale_up_to_capacity_s": took}


def drain_life(card_agent, start_serving=None, run_solo=None) -> dict:
    """Step 17b: this machine's node drained under a serving pod and given
    back by the autoscaler, every effect through the REST channel of
    step 12 (the stand-in apiserver, ``rest_loops`` with the admission
    feed). The extender runs in process with ``DRAIN_LIFE_ENV`` (drain,
    capacity, the autoscaler, batching, the journal), its HTTP app on
    127.0.0.1.

    ``card_agent()`` enters the node agent; ``start_serving(env)``
    starts serve-0's container (a Popen that prints a ``serving`` line,
    then serves until SIGTERM); ``run_solo(env)`` runs serve-1 to its end
    and returns its report. None for either: no container (the tests).

    serve-0 is admitted by the feed, planned, bound to tpu-0 from the
    plan, and its env comes from the plugin's Allocate. The drain
    cordons the node (``begin``: the cordon is durable when it returns);
    /statusz shows it. The drain tick evicts serve-0 (its GPU leaves the
    ledger, as a preemption victim's does); the executor's Eviction POST
    reaches the stand-in, whose kubelet part SIGTERMs the container and
    deletes the pod once it has exited. Meanwhile serve-1 arrives, is
    admitted and planned to no node: its GPU is free but cordoned, so
    /capacity's stranded ledger names it ``draining``, and the probe of
    one GPU fits nowhere. The lifecycle loop's DELETED event confirms the
    eviction; the next tick un-ingests the node (``unnodes`` in the WAL
    after a sync) and counts the drain on /metrics. serve-1 is retried (kube-scheduler marks it
    unschedulable: a MODIFIED event re-admits it), the autoscaler sees
    queue depth 1 and provisions this machine's Node item (once: one
    machine): ``up``; the probe fits again, serve-1 is planned and bound
    to tpu-0 and runs; ``obs capacity --url`` exits 0; serve-1 ends and
    is released. Returns the decisions and host-clock times; raises
    RuntimeError when a check fails. No container outlives the call."""
    import math
    import signal
    import tempfile

    from tpukube_torch.apiserver import FakeApiServer
    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.sched import client
    from tpukube_torch.sched.journal import load_wal
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim.kube_rest import KubeRestServer

    pkg = port_pkg()
    a, codec = pkg.api, pkg.codec
    procs: dict = {}  # pod key -> its container's process
    t_sig: list = []

    class KubeletApi(FakeApiServer):
        """The stand-in's store, with the kubelet's half of an eviction:
        an accepted eviction of a graceful pod SIGTERMs its container."""

        def evict_pod(self, namespace, name, dry_run=False):
            ok = super().evict_pod(namespace, name, dry_run=dry_run)
            proc = procs.get(f"{namespace}/{name}")
            if ok and not dry_run and proc is not None and proc.poll() is None:
                t_sig.append(time.perf_counter())
                proc.send_signal(signal.SIGTERM)
            return ok

    out: dict = {"binds": {}}
    t_step = time.perf_counter()
    store = KubeletApi()
    with tempfile.TemporaryDirectory() as td, \
            KubeRestServer(store=store, token=REST_TOKEN) as kube, \
            contextlib.ExitStack() as stack:

        def stop_containers() -> None:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()

        stack.callback(stop_containers)
        wal = os.path.join(td, "wal.jsonl")
        cfg = pkg.load_config(env={**DRAIN_LIFE_ENV, "TPUKUBE_JOURNAL_PATH": wal})
        api = pkg.rest_api(cfg, kube.base_url, token=REST_TOKEN)
        ext = pkg.Extender(cfg)
        stack.callback(ext.journal.close)
        # the step drives the drain's ticks itself; the decision path's
        # amortized tick would take the eviction out of its hands
        ext.drain.TICK_INTERVAL_S = math.inf
        loops = stack.enter_context(rest_loops(pkg, ext, api, admission=True))
        server = pkg.serve(ext, evictions=loops.execu, lifecycle=loops.lifecycle,
                           reconcile=loops.reconcile, node_refresh=loops.refresh)
        stack.callback(server.server_close)
        stack.callback(server.shutdown)
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"

        def get(path: str):
            return https_get(f"{base}{path}")

        def metrics() -> dict:
            return metric_lines(https_get(f"{base}/metrics", raw=True).decode())

        agent = stack.enter_context(card_agent())
        node = agent.mgr.host
        out["node"] = node
        res = agent.server.resource_name
        intents = a.AllocIntentWatcher(api, node, agent.server,
                                       poll_seconds=REST_POLL_S)
        intents.start()
        stack.callback(intents.stop)
        wait_for("the intent watch", intents.stream_connected)
        annotations = codec.annotate_node(agent.mgr.node_info(), agent.mgr.mesh)
        api.patch_node_annotations(node, annotations)
        wait_for("node topology", lambda: ext.state.node(node) is not None)
        chips = len(ext.state.node(node).info.chips)

        def admitted(name: str, n: int) -> None:
            wait_for(f"{name}'s admission", lambda: loops.feed.admitted >= n)

        def bind_from_plan(name: str) -> dict:
            """Plan the queue, then kube-scheduler's cycle over HTTP, the
            Binding POST, the intent watch and the kubelet's Allocate:
            the pod's container env."""
            key = f"default/{name}"
            ext.plan_pending()
            if ext.planned_node(key) != node:
                raise RuntimeError(f"{name} planned on {ext.planned_node(key)}")
            host, alloc, _ = client.place(port, pod_object(name, tpu=1), [node])
            out["binds"][name] = alloc.device_ids
            wait_for(f"{name}'s intent", lambda: agent.server.intents
                     .snapshot().get(key) == alloc.device_ids)
            payload = (api.get_pod("default", name)["metadata"]["annotations"]
                       [codec.ANNO_ALLOC])
            if host != node or alloc.device_ids != ["tpu-0"]:
                raise RuntimeError(f"{name} bound {alloc.device_ids} on {host}")
            return {**alloc.env, **agent.kubelet.allocate(res, alloc.device_ids),
                    ENV_ALLOC: payload}

        # serve-0: admitted by the feed, bound from the plan, serving
        kube.store.upsert_pod(pod_object("serve-0", tpu=1))
        admitted("serve-0", 1)
        env0 = bind_from_plan("serve-0")
        kube.store.graceful.add("default/serve-0")  # terminates as the kubelet lets it
        if start_serving is not None:
            proc = procs["default/serve-0"] = start_serving(env0)
            lines: queue.Queue = queue.Queue()
            threading.Thread(target=pump, args=(proc.stdout, lines),
                             daemon=True).start()
            while True:
                line = lines.get(timeout=POD_TIMEOUT_S)
                if line is None:
                    raise RuntimeError(f"serve-0 exited {proc.wait()} before "
                                       f"serving")
                print(f"serve-0: {line.rstrip()}", flush=True)
                if line.startswith('{"serving"'):
                    break

        # the drain: cordon (durable when begin returns)
        t = time.perf_counter()
        drain_id = ext.drain.begin([node], reason="maintenance")
        t_cordon = time.perf_counter()
        out["begin_to_cordon_ms"] = (t_cordon - t) * 1e3
        out["cordoned"] = sorted(ext.state.cordoned_nodes())
        active = get("/statusz")["drain"]["active"]
        out["statusz_drain_active"] = len(active)
        if [d["id"] for d in active] != [drain_id] or out["cordoned"] != [node]:
            raise RuntimeError(f"the drain: /statusz {active}, cordoned "
                               f"{out['cordoned']}")
        # the tick: serve-0 evicted; the executor's Eviction POST reaches
        # the stand-in, whose kubelet part SIGTERMs the container and
        # deletes the pod once it has exited
        exited = threading.Event()
        t_exit: list = []

        def kubelet(proc) -> None:
            if proc is not None:
                proc.wait()
            t_exit.append(time.perf_counter())
            exited.set()
            kube.store.finish_termination("default", "serve-0")

        t_tick = time.perf_counter()
        moves = ext.drain.tick()
        loops.execu.check_once()
        if moves != 1 or ext.state.allocation("default/serve-0") is not None:
            raise RuntimeError(f"the drain tick moved {moves}")
        proc = procs.get("default/serve-0")
        if proc is not None and not t_sig:
            raise RuntimeError("the eviction did not SIGTERM serve-0")
        threading.Thread(target=kubelet, args=(proc,), daemon=True).start()
        # serve-1 arrives while serve-0 terminates: admitted, planned to
        # no node; its GPU is free in the ledger but cordoned, so the
        # stranded ledger names the drain, and a probe fits nowhere
        kube.store.upsert_pod(pod_object("serve-1", tpu=1))
        admitted("serve-1", 2)
        ext.plan_pending()
        if ext.planned_node("default/serve-1") is not None:
            raise RuntimeError("serve-1 was planned onto the cordoned node")
        doc = get("/capacity")
        out["stranded_reasons"] = {r: n for row in doc["stranded"]["by_shape"]
                                   for r, n in row["reasons"].items()}
        out["unschedulable"] = doc["unschedulable"]
        probe = get("/capacity/probe?count=1")
        out["probe_fits_before"] = probe["fits"]
        if out["stranded_reasons"] != {"draining": 1} or probe["fits"]:
            raise RuntimeError(f"serve-1 stranded {doc['stranded']}, probe "
                               f"{probe}")
        if not exited.wait(PREEMPT_TIMEOUT_S):
            raise RuntimeError(f"serve-0 did not exit in {PREEMPT_TIMEOUT_S} s")
        if proc is not None:
            # the cordon's interval holds the /statusz read above; the
            # tick's is the choreography alone
            out["cordon_to_sigterm_ms"] = (t_sig[0] - t_cordon) * 1e3
            out["tick_to_sigterm_ms"] = (t_sig[0] - t_tick) * 1e3
            out["sigterm_to_exit_ms"] = (t_exit[0] - t_sig[0]) * 1e3
            if proc.returncode != -signal.SIGTERM:
                raise RuntimeError(f"serve-0 exited {proc.returncode}, not by "
                                   f"its SIGTERM")
        wait_for("serve-0's eviction confirmed", lambda: loops.execu.evicted == 1)
        out["evicted"] = ["default/serve-0"]
        # the next tick: nothing left on the node, the drain un-ingests it
        ext.drain.tick()
        t_done = time.perf_counter()
        out["exit_to_completed_ms"] = (t_done - t_exit[0]) * 1e3
        st = ext.drain.stats()
        out["removed_nodes"] = ([node] if node not in ext.state.node_names()
                                else [])
        if st["completed"] != 1 or node in ext.state.node_names():
            raise RuntimeError(f"the drain did not complete: {st}")
        ext.journal.sync()
        records, _ = load_wal(wal)
        out["wal_unnodes"] = [r["d"]["n"] for r in records if r["k"] == "unnodes"]
        page = metrics()
        out["metrics"] = {k: page.get(k) for k in (
            "tpukube_drain_completed_total", "tpukube_drain_evictions_total",
            "tpukube_drain_chips_removed_total")}
        if out["metrics"] != {"tpukube_drain_completed_total": 1.0,
                              "tpukube_drain_evictions_total": 1.0,
                              "tpukube_drain_chips_removed_total": float(chips)}:
            raise RuntimeError(f"/metrics drain families {out['metrics']}")
        # kube-scheduler's retry marks serve-1 unschedulable: the MODIFIED
        # event re-admits it, and the queue holds it
        retried = dict(kube.store.get_pod("default", "serve-1"))
        retried["status"] = {"phase": "Pending", "conditions": [
            {"type": "PodScheduled", "status": "False",
             "reason": "Unschedulable"}]}
        kube.store.upsert_pod(retried)
        admitted("serve-1", 3)
        # the scale-up: this machine's Node item, once (one machine)
        items = [{"name": node, "annotations": annotations}]
        t_up = time.perf_counter()
        with ext._decision_lock:
            ext.autoscaler.set_provisioner(lambda: [items.pop()] if items else [])
            out["queue_depth_at_tick"] = ext.cycle.queue_depth()
            out["decision"] = ext.autoscaler.tick()
        if out["decision"] != "up" or node not in ext.state.node_names():
            raise RuntimeError(f"the autoscaler decided {out['decision']} at "
                               f"queue depth {out['queue_depth_at_tick']}")
        out["probe_fits_after"] = get("/capacity/probe?count=1")["fits"]
        env1 = bind_from_plan("serve-1")
        out["up_to_bound_ms"] = (time.perf_counter() - t_up) * 1e3
        out["metrics"]["tpukube_autoscaler_scale_ups_total"] = metrics().get(
            "tpukube_autoscaler_scale_ups_total")
        if run_solo is not None:
            out["solo"] = run_solo(env1)
        obs = subprocess.run(
            [sys.executable, "-m", "tpukube_torch.cli", "obs", "capacity",
             "--url", base], cwd=ROOT, env=pod_env({}), capture_output=True,
            text=True, timeout=60)
        out["obs_capacity_rc"] = obs.returncode
        out["obs_capacity"] = obs.stdout.strip().splitlines()
        if obs.returncode != 0:
            raise RuntimeError(f"obs capacity --url exited {obs.returncode}: "
                               f"{obs.stderr[-2000:]}")
        # serve-1 ends and is released; no pod outlives the step
        done = dict(kube.store.get_pod("default", "serve-1"))
        done["status"] = {"phase": "Succeeded"}
        kube.store.upsert_pod(done)
        wait_for("serve-1's release",
                 lambda: ext.state.allocation("default/serve-1") is None)
        streams_held(intents)
        out["drain"] = ext.drain.statusz()
        out["autoscaler"] = ext.autoscaler.statusz()
    out["routes"] = dict(kube.requests)
    out["step_s"] = time.perf_counter() - t_step
    return out


def elasticity_phase(card: str, c0, step8: list):
    """Step 17 on the card: scenario 15 and the two points (17a), then
    ``drain_life`` with the card's node agent, serve-0 a Llama-3-8B B=1
    pod serving until evicted and serve-1 a B=1 pod of 3 requests (17b);
    prints the ``elasticity:`` line's text. ``step8`` is step 8's shared
    pods' reports. Returns the line's object, or None when a check
    failed."""
    host = host_cpu()

    def start_serving(env):
        return subprocess.Popen(
            [sys.executable, "-m", "tpukube_torch.graft", "--requests",
             str(BURST_REQUESTS), "--batch", "1"],
            cwd=ROOT, env=pod_env(env), stdout=subprocess.PIPE, text=True)

    def run_solo(env):
        r = run_pod(["--requests", "3", "--batch", "1"], env, "pod")
        if r is None:
            raise RuntimeError("serve-1's pod failed")
        return r

    try:
        scen = elasticity_scenarios()
        life = drain_life(lambda: node_agent({}), start_serving=start_serving,
                          run_solo=run_solo)
    except (RuntimeError, subprocess.SubprocessError, OSError,
            queue.Empty) as e:
        fail(f"elasticity: {e}")
        return None
    solo = life.pop("solo")
    if solo["uuid"] != c0.chip_id or solo["batch"] != 1:
        fail(f"serve-1's pod: {solo}")
        return None
    print("serve-1: " + json.dumps(solo, sort_keys=True), flush=True)
    step8_pods = [{"forward_ms_median": r["forward_ms_median"],
                   "tokens_per_s": r["tokens_per_s"]} for r in step8]
    line = {"card": card, "host": host, **scen, **life,
            "serve1": {"forward_ms_median": solo["forward_ms_median"],
                       "tokens_per_s": solo["tokens_per_s"]},
            "step8_pods": step8_pods}
    print(
        f"elasticity: scenario 15 A+B+C ({scen['s15_cycles']} cycles, seed "
        f"{CHAOS_SEED}, audit 1.0) {scen['s15_wall_s']:.3f} s, "
        f"{scen['s15_drains_completed']} storm drains + "
        f"{scen['s15_scale_downs']} scale-down + "
        f"{scen['s15_rebalanced_slices']} slices rebalanced away, "
        f"{scen['s15_last_incarnation_evictions']} evictions (last "
        f"incarnation), {scen['s15_spot_kills']} spot kills, peak "
        f"{scen['s15_peak_tick_moves']} moves a tick (budget "
        f"{scen['s15_budget_moves']}); a 64-GPU slice drained in "
        f"{scen['drain_point_wall_s'] * 1e3:.1f} ms "
        f"({scen['drained_chips_per_s']:.1f} GPUs/s, budget "
        f"{DRAIN_POINT_BUDGET}); {scen['scale_up_nodes']} nodes to capacity "
        f"in {scen['scale_up_to_capacity_s']:.3f} s; this node: begin -> "
        f"cordon {life['begin_to_cordon_ms']:.3f} ms, cordon -> SIGTERM "
        f"{life['cordon_to_sigterm_ms']:.3f} ms (the tick's "
        f"{life['tick_to_sigterm_ms']:.3f} ms), SIGTERM -> exit "
        f"{life['sigterm_to_exit_ms']:.1f} ms, exit -> drain completed "
        f"{life['exit_to_completed_ms']:.1f} ms, scale-up decision -> "
        f"serve-1 bound {life['up_to_bound_ms']:.3f} ms; serve-1 alone, "
        f"Llama-3-8B B=1 S=2048: {solo['forward_ms_median']:.3f} ms, "
        f"{solo['tokens_per_s']:.1f} tokens/s (step 8's two shared pods: "
        + ", ".join(f"{v['forward_ms_median']:.3f} ms {v['tokens_per_s']:.1f} "
                    f"tokens/s" for v in step8_pods)
        + f"); step {life['step_s']:.1f} s [host CPU times; {host}; {card}]",
        flush=True,
    )
    return line


# -- decision provenance (step 18) ----------------------------------------------

# the reference's decisions smoke: scenario 12's pod count and the
# overhead ceiling (tools/perf_floor.json's "decisions" entry)
PERF_FLOOR = os.path.join(ROOT, "tools", "perf_floor.json")
EXPLAIN_TOKEN = "chip-smoke-explain"  # the daemon's bearer token
EXPLAIN_ROUNDS = 100  # /explain round trips timed
PHASES = ("queue", "pin", "plan", "answer", "commit")
# step 14's config with the batch cycle and decision provenance on, every
# pod sampled, the provenance sink in the temp dir
EXPLAIN_CONFIG = DAEMON_CONFIG + """\
batch_enabled: true
decisions_enabled: true
decisions_sample_rate: 1.0
decisions_path: {decisions}
"""


@contextlib.contextmanager
def recorded_binds(ext_mod=None):
    """Every placement the extenders of ``ext_mod`` (the port's extender
    module by default) answer at /bind while the block runs, in order:
    (pod key, node, alloc annotation); a refused bind places nothing."""
    if ext_mod is None:
        from tpukube_torch.sched import extender as ext_mod

    binds: list = []
    real = ext_mod.Extender._handle_bind

    def handle_bind(self, body):
        resp = real(self, body)
        if not resp.get("Error"):
            binds.append((f"{body['PodNamespace']}/{body['PodName']}",
                          body["Node"], resp.get("Annotations")))
        return resp

    ext_mod.Extender._handle_bind = handle_bind
    try:
        yield binds
    finally:
        ext_mod.Extender._handle_bind = real


def decisions_smoke() -> dict:
    """Step 18a: the reference's decisions smoke on the port: scenario 12
    at 10,240 nodes and tools/perf_floor.json's pod count, with decision
    provenance on at sample rate 1.0, then the same drive with it off.
    Provenance must record, cost at most the file's ``overhead_pct_max``
    of the drive's wall, and move no pod: the two drives' placements must
    be equal, bind by bind. Returns the ``provenance:`` line's drive
    numbers; raises RuntimeError when a check fails."""
    from tpukube_torch.sim import scenarios

    with open(PERF_FLOOR) as f:
        floor = json.load(f)["decisions"]
    runs = {}
    for on in ("1", "0"):
        with scenario_env({"TPUKUBE_KILONODE10K_PODS": str(floor["pods"]),
                           "TPUKUBE_DECISIONS_ENABLED": on,
                           "TPUKUBE_DECISIONS_SAMPLE_RATE": "1.0"}), \
                recorded_binds() as binds:
            runs[on] = (scenarios.run(12), binds)
    (r_on, binds_on), (r_off, binds_off) = runs["1"], runs["0"]
    d = r_on["decisions"]
    if not d["recorded"] or d["overhead_pct"] is None \
            or d["overhead_pct"] > floor["overhead_pct_max"]:
        raise RuntimeError(f"decisions smoke: recorded {d['recorded']}, "
                           f"overhead {d['overhead_pct']}% (ceiling "
                           f"{floor['overhead_pct_max']}%)")
    if "decisions" in r_off:
        raise RuntimeError("provenance recorded with decisions_enabled off")
    if not binds_on or binds_on != binds_off:
        raise RuntimeError(f"placements with provenance on ({len(binds_on)} "
                           f"binds) differ from those with it off "
                           f"({len(binds_off)})")
    return {
        "pods": r_on["pods_total"], "nodes": r_on["nodes"],
        "recorded": d["recorded"], "record_seconds": d["record_seconds"],
        "overhead_pct": d["overhead_pct"],
        "overhead_pct_max": floor["overhead_pct_max"],
        "pods_per_s_on": r_on["pods_per_sec"],
        "pods_per_s_off": r_off["pods_per_sec"],
        "wall_s_on": r_on["wall_s"], "wall_s_off": r_off["wall_s"],
        "binds_compared": len(binds_on),
    }


def explain_life(card_agent, serve=None) -> dict:
    """Step 18b: one card pod's placement, pending wait and release
    explained live and from the provenance sink. An ``extender`` daemon
    started as step 14 starts it (config file, the REST stand-in), behind
    a bearer token, its config adding the batch cycle and decision
    provenance at sample rate 1.0 with a sink in the temp dir; the
    stand-in holds this machine's Node, annotated by ``card_agent()``'s
    node agent. ``serve(env, requests)`` runs a pod's container on the
    Allocate env and returns its report (None: no container).

    why-0 is admitted by the daemon's admission feed, planned on its
    /filter and bound to tpu-0 from the plan; ``obs explain --url`` (a
    child) names this node, the batch arm and the chain admit ->
    cycle_plan -> bind. why-1 asks for one GPU while the card is taken:
    /filter refuses it with the node's pruning reason, and it explains as
    pending with a queue age above 0. /statusz shows the decisions
    section, /metrics counts the records and every cycle phase. why-0
    ends, is released and explains so; why-1 binds tpu-0 and runs. On
    SIGTERM the daemon exits 0, and ``obs explain --file`` on its sink
    renders what the live route did. Returns the decisions and the
    host-clock times; raises RuntimeError when a check fails."""
    import tempfile
    from urllib.parse import quote

    from tpukube_torch.core import codec
    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.obs import decisions as decisions_mod
    from tpukube_torch.sched import client
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sim.harness import _free_port
    from tpukube_torch.sim.kube_rest import KubeRestServer

    out: dict = {"binds": {}, "pods": {}}
    t_step = time.perf_counter()
    with tempfile.TemporaryDirectory() as td, \
            KubeRestServer(token=REST_TOKEN) as kube, \
            contextlib.ExitStack() as stack:
        kids = Children(td)
        stack.callback(kids.close)
        sink = os.path.join(td, "decisions.jsonl")
        cfg_path = os.path.join(td, "config.yaml")
        with open(cfg_path, "w") as f:
            f.write(EXPLAIN_CONFIG.format(
                hosts=1, poll=REST_POLL_S,
                trace=os.path.join(td, "trace.jsonl"),
                events=os.path.join(td, "events.jsonl"), decisions=sink))
        kube_token, auth = (os.path.join(td, n) for n in ("kube-token", "auth"))
        for path, text in ((kube_token, REST_TOKEN), (auth, EXPLAIN_TOKEN)):
            with open(path, "w") as f:
                f.write(text + "\n")
        agent = stack.enter_context(card_agent())
        node = agent.mgr.host
        kube.store.patch_node_annotations(
            node, codec.annotate_node(agent.mgr.node_info(), agent.mgr.mesh))
        port = _free_port()
        base = f"http://127.0.0.1:{port}"
        t = time.perf_counter()
        proc = kids.spawn("extender-explain", [
            "extender", "--config", cfg_path, "--host", "127.0.0.1",
            "--port", str(port), "--auth-token-file", auth,
            "--kube-api", kube.base_url, "--kube-token-file", kube_token])
        t_ready = daemon_wait("the extender ready", lambda: https_get(
            f"{base}/healthz")["nodes"] == [node], proc)
        out["spawn_to_ready_ms"] = (t_ready - t) * 1e3

        def get(path: str, raw: bool = False):
            req = urllib.request.Request(f"{base}{path}")
            req.add_header("Authorization", f"Bearer {EXPLAIN_TOKEN}")
            with urllib.request.urlopen(req, timeout=30) as r:
                body = r.read()
            return body if raw else json.loads(body)

        def explain(name: str) -> dict:
            return get(f"/explain?pod={quote('default/' + name, safe='/')}")

        def stages(name: str) -> list:
            return [ev["stage"] for ev in explain(name)["stages"]]

        def settled(name: str) -> list:
            """The pod's stages once three reads 0.1 s apart agree (the
            admission feed may still be re-admitting it after a bind)."""
            seen = [stages(name)]
            while len(seen) < 3 or seen[-1] != seen[-2] or seen[-2] != seen[-3]:
                time.sleep(0.1)
                seen.append(stages(name))
            return seen[-1]

        def obs_explain(*args: str) -> tuple:
            return kids.run("obs-explain", ["obs", "explain", *args])

        def admitted(name: str) -> None:
            t = time.perf_counter()
            kube.store.upsert_pod(pod_object(name, tpu=1))
            t_adm = daemon_wait(f"{name}'s admission",
                                lambda: "admit" in stages(name), proc)
            out[f"{name}_added_to_admitted_ms"] = (t_adm - t) * 1e3

        def bind(name: str, requests: int) -> None:
            host, alloc, ms = client.place(port, pod_object(name, tpu=1), [node],
                                           token=EXPLAIN_TOKEN)
            out["binds"][name] = alloc.device_ids
            out[f"{name}_webhook_ms"] = ms
            if host != node or alloc.device_ids != ["tpu-0"]:
                raise RuntimeError(f"{name} bound {alloc.device_ids} on {host}")
            payload = kube.store.get_pod("default", name)["metadata"][
                "annotations"][codec.ANNO_ALLOC]
            if serve is not None:
                env = {**allocate(agent, alloc), ENV_ALLOC: payload}
                out["pods"][name] = serve(env, requests)

        def ended(name: str) -> None:
            done = dict(kube.store.get_pod("default", name))
            done["status"] = {"phase": "Succeeded"}
            t = time.perf_counter()
            kube.store.upsert_pod(done)
            t_rel = daemon_wait(f"{name}'s release",
                                lambda: "release" in stages(name), proc)
            out[f"{name}_succeeded_to_release_ms"] = (t_rel - t) * 1e3

        # why-0: admitted by the feed, planned on its /filter, bound from
        # the plan; its explain names the node, the arm and the chain
        admitted("why-0")
        bind("why-0", 3)
        rc, text = obs_explain("--url", base, "--token-file", auth,
                               "default/why-0")
        doc0 = explain("why-0")
        chain = [ev["stage"] for ev in doc0["stages"]]
        plan = next(ev for ev in doc0["stages"] if ev["stage"] == "cycle_plan")
        bound = next(ev for ev in doc0["stages"] if ev["stage"] == "bind")
        out.update(why0_rc=rc, why0_text=text.strip().splitlines(),
                   why0_chain=chain, why0_arm=plan["arm"],
                   why0_served_from=bound["served_from"])
        if (rc != 0 or doc0["verdict"] != "placed" or doc0["node"] != node
                or chain[:3] != ["admit", "cycle_plan", "bind"]
                or f"PLACED on {node}" not in text
                or f"arm={plan['arm']}" not in text or plan["arm"] != "fast"
                or bound["served_from"] != "plan"):
            raise RuntimeError(f"why-0's explain (exit {rc}): {doc0}\n{text}")
        # why-1 while the card is taken: pending, pruned, aging
        admitted("why-1")
        fres = client.filter_nodes(port, pod_object("why-1", tpu=1), [node],
                                   token=EXPLAIN_TOKEN)
        doc1 = explain("why-1")
        plan1 = [ev for ev in doc1["stages"] if ev["stage"] == "cycle_plan"]
        out.update(why1_verdict=doc1["verdict"],
                   why1_reasons=(fres.get("FailedNodes") or {}).get(node, ""),
                   why1_pending_age_s=(plan1[-1].get("queue_age_s")
                                       if plan1 else None),
                   why1_text=decisions_mod.format_explain(doc1).splitlines())
        if (fres["NodeNames"] or doc1["verdict"] != "pending" or not plan1
                or plan1[-1]["node"] is not None
                or not out["why1_reasons"]
                or not (out["why1_pending_age_s"] or 0) > 0):
            raise RuntimeError(f"why-1 while the card is taken: {fres}, {doc1}")
        statusz = get("/statusz")["decisions"]
        page = metric_lines(https_get(f"{base}/metrics", raw=True).decode())
        out["statusz"] = {k: statusz[k] for k in (
            "enabled", "sample_rate", "events", "pods", "recorded",
            "sink_path")}
        out["decisions_total"] = page.get("tpukube_decisions_total", 0)
        out["phases_observed"] = {
            p: page.get(f'tpukube_cycle_phase_seconds_count{{phase="{p}"}}', 0)
            for p in PHASES}
        out["phases"] = phase_stats(page)
        if (statusz["enabled"] is not True or statusz["sink_path"] != sink
                or not out["decisions_total"] > 0
                or not all(v > 0 for v in out["phases_observed"].values())):
            raise RuntimeError(f"/statusz decisions {statusz}, /metrics "
                               f"{out['decisions_total']} records, phases "
                               f"{out['phases_observed']}")
        walls = []
        for _ in range(EXPLAIN_ROUNDS):
            t = time.perf_counter()
            explain("why-0")
            walls.append((time.perf_counter() - t) * 1e3)
        out["explain_ms_median"] = statistics.median(walls)
        # why-0 ends and is released; why-1 takes the card
        ended("why-0")
        bind("why-1", 1)
        if explain("why-1")["verdict"] != "placed":
            raise RuntimeError(f"why-1 bound but explains {explain('why-1')}")
        live = {}
        for name in ("why-0", "why-1"):
            settled(name)
            rc, text = obs_explain("--url", base, "--token-file", auth,
                                   "--json", f"default/{name}")
            if rc != 0:
                raise RuntimeError(f"obs explain --url {name} exited {rc}")
            live[name] = json.loads(text)
        out["why0_stages_final"] = [ev["stage"] for ev in live["why-0"]["stages"]]
        rc, out["sigterm_s"] = kids.stop(proc)
        out["sigterm_rc"] = rc
        if rc != 0:
            raise RuntimeError(f"the extender exited {rc} on SIGTERM: "
                               f"{Children.tail(proc)}")
        same = []
        for name in ("why-0", "why-1"):
            rc, text = obs_explain("--file", sink, "--json", f"default/{name}")
            same.append(rc == 0 and json.loads(text) == live[name])
        out["sink_same_stages"] = all(same)
        if not out["sink_same_stages"]:
            raise RuntimeError(f"the sink's explain differs from the live "
                               f"route's: {same}")
        out["sink_lines"] = len(decisions_mod.load(sink))
        out["routes"] = dict(kube.requests)
    out["step_s"] = time.perf_counter() - t_step
    return out


def phase_stats(page: dict) -> dict:
    """Each cycle phase's count, mean and p50 from a /metrics page's
    ``tpukube_cycle_phase_seconds`` histogram. The histogram keeps bucket
    counts only, so the p50 is the upper bound of the bucket the median
    observation falls in (ms)."""
    import re

    out = {}
    for p in PHASES:
        count = page.get(f'tpukube_cycle_phase_seconds_count{{phase="{p}"}}', 0)
        total = page.get(f'tpukube_cycle_phase_seconds_sum{{phase="{p}"}}', 0)
        bounds = sorted(
            (float(m.group(1)), v) for k, v in page.items()
            if (m := re.fullmatch(r'tpukube_cycle_phase_seconds_bucket'
                                  rf'\{{le="([^"]+)",phase="{p}"\}}', k))
            and m.group(1) != "+Inf")
        p50 = next((le for le, n in bounds if count and n >= count / 2),
                   math.inf)
        out[p] = {"count": count,
                  "mean_ms": total / count * 1e3 if count else None,
                  "p50_le_ms": p50 * 1e3}
    return out


def provenance_phase(card: str, c0, step8: list):
    """Step 18 on the card: the decisions smoke (18a), then
    ``explain_life`` with the card's node agent, why-0 a Llama-3-8B B=1
    pod of three requests and why-1 one of one (18b); prints the
    ``provenance:`` line's text. ``step8`` is step 8's shared pods'
    reports. Returns the line's object, or None when a check failed."""
    host = host_cpu()

    def serve(env, requests):
        r = run_pod(["--requests", str(requests), "--batch", "1"], env, "pod")
        if r is None or r["uuid"] != c0.chip_id or r["batch"] != 1:
            raise RuntimeError(f"a pod of explain_life failed: {r}")
        return r

    try:
        smoke = decisions_smoke()
        life = explain_life(lambda: node_agent({}, host=DAEMON_NODE),
                            serve=serve)
    except (RuntimeError, subprocess.SubprocessError, OSError) as e:
        fail(f"provenance: {e}")
        return None
    pods = life.pop("pods")
    for name, r in pods.items():
        print(f"{name}: " + json.dumps(r, sort_keys=True), flush=True)
    why0 = pods["why-0"]
    step8_pods = [{"forward_ms_median": r["forward_ms_median"],
                   "tokens_per_s": r["tokens_per_s"]} for r in step8]
    phases = life["phases"]
    line = {"card": card, "host": host, "smoke": smoke, **life,
            "why0_pod": {"forward_ms_median": why0["forward_ms_median"],
                         "tokens_per_s": why0["tokens_per_s"]},
            "step8_pods": step8_pods}
    print(
        f"provenance: scenario 12 at {smoke['nodes']} nodes, "
        f"{smoke['pods']} pods, sample rate 1.0: overhead "
        f"{smoke['overhead_pct']}% of the drive (ceiling "
        f"{smoke['overhead_pct_max']}%), {smoke['recorded']} records, "
        f"{smoke['pods_per_s_on']} pods/s on vs {smoke['pods_per_s_off']} "
        f"off, {smoke['binds_compared']} binds equal; daemon phases (p50 "
        f"bucket bound / mean) "
        + ", ".join(f"{p} <= {v['p50_le_ms']:g} / {v['mean_ms']:.4f} ms"
                    for p, v in phases.items())
        + f"; /explain round trip median {life['explain_ms_median']:.3f} ms "
        f"({EXPLAIN_ROUNDS} rounds); why-0 Llama-3-8B B=1 S=2048 "
        f"{why0['forward_ms_median']:.3f} ms, {why0['tokens_per_s']:.1f} "
        f"tokens/s (step 8's two shared pods: "
        + ", ".join(f"{v['forward_ms_median']:.3f} ms {v['tokens_per_s']:.1f} "
                    f"tokens/s" for v in step8_pods)
        + f"); step {life['step_s']:.1f} s [host CPU times; {host}; {card}]",
        flush=True,
    )
    return line


# -- the sharded control plane (step 19) -----------------------------------------

# the reference's shard smoke (tools/check.sh): 4 slices of 8x8x16 (1,024
# nodes, 4,096 GPUs) behind two planner replicas, tools/perf_floor.json's
# "shard" pods and pods/s floor
SHARD_SMOKE_ENV = {"TPUKUBE_SHARD_SLICES": "4", "TPUKUBE_SIM_MESH_DIMS": "8,8,16",
                   "TPUKUBE_PLANNER_REPLICAS": "2"}
# the acceptance fleet at scenario 14's defaults (10 slices of 32x32x40,
# 102,400 nodes, behind 4 replicas), its 40,000 pods cut to bound the step
SHARD_FLEET_PODS = 6000
# shard_life's router: two replicas, the batch cycle, every pod's
# provenance, the journal (one segment per replica)
SHARD_LIFE_ENV = {"TPUKUBE_PLANNER_REPLICAS": "2", "TPUKUBE_BATCH_ENABLED": "1",
                  "TPUKUBE_DECISIONS_ENABLED": "1",
                  "TPUKUBE_DECISIONS_SAMPLE_RATE": "1.0",
                  "TPUKUBE_JOURNAL_ENABLED": "1"}
SHARD_SIM_HOST = "hgx-0-host-0"  # a sim HGX host of 8 GPUs, slice hgx-0
SHARD_GANG = 9  # one-GPU members: the sim host takes 8, no replica all 9
SHARD_FILTER_ROUNDS = 100  # /filter handles timed, router and replica


def shard_scenarios() -> dict:
    """Step 19a and 19b: scenario 14 at the reference's shard smoke size
    (its pods/s at least tools/perf_floor.json's ``shard`` floor), then
    at its defaults with the pods cut to ``SHARD_FLEET_PODS``. Each run
    raises on its own invariants (a leak, a divergence, a dead replica,
    a shortfall). Returns the ``shard:`` line's drive numbers."""
    from tpukube_torch.sim import scenarios

    with open(PERF_FLOOR) as f:
        floor = json.load(f)["shard"]
    out = {}
    for tag, env in (("smoke", {**SHARD_SMOKE_ENV,
                                "TPUKUBE_KILONODE100K_PODS": str(floor["pods"])}),
                     ("fleet", {"TPUKUBE_KILONODE100K_PODS":
                                str(SHARD_FLEET_PODS)})):
        with scenario_env(env):
            r = scenarios.run(14)
        if r["ledger_divergence"] or not r["gang_committed"]:
            raise RuntimeError(f"scenario 14 ({tag}): {r}")
        out[tag] = {k: r[k] for k in ("nodes", "chips", "pods_total",
                                      "pods_per_sec", "wall_s", "setup_s",
                                      "sim_seconds", "webhook_p99_ms",
                                      "resync")}
        out[tag]["replicas"] = len(r["shard"]["replicas"])
        out[tag]["slice_assignment"] = r["shard"]["slice_assignment"]
        out[tag]["rendezvous"] = r["shard"]["rendezvous"]
    out["smoke"]["pods_per_sec_min"] = floor["pods_per_sec_min"]
    if out["smoke"]["pods_per_sec"] < floor["pods_per_sec_min"]:
        raise RuntimeError(f"scenario 14 smoke: {out['smoke']['pods_per_sec']} "
                           f"pods/s < the floor's {floor['pods_per_sec_min']}")
    return out


def shard_sim_host(codec) -> dict:
    """The Node annotations of a sim HGX host of 8 GPUs (as step 11a's
    hosts), alone in its slice ``hgx-0``."""
    from tpukube_torch.core.mesh import MeshSpec
    from tpukube_torch.core.types import ChipInfo, NodeInfo, TopologyCoord

    mesh = MeshSpec(dims=(8, 1, 1), host_block=(8, 1, 1),
                    torus=(False, False, False))
    chips = [ChipInfo(chip_id=f"{SHARD_SIM_HOST}-gpu-{i}", index=i,
                      coord=TopologyCoord(i, 0, 0), hbm_bytes=80 << 30,
                      num_cores=132) for i in range(8)]
    return codec.annotate_node(NodeInfo(name=SHARD_SIM_HOST, chips=chips,
                                        slice_id="hgx-0"), mesh)


def _source(ev: dict) -> str:
    """Who recorded a stitched explain's stage: "router", or a replica's
    name."""
    return ev.get("replica_source") or ev.get("replica", "")


def route_cycle(router, codec, pod: dict, nodes: list):
    """kube-scheduler's cycle for ``pod`` through the router, in process:
    /filter over the node names, /prioritize, /bind the best. Returns
    (node, the bound alloc); raises RuntimeError when it is refused."""
    fres = router.handle("filter", {"Pod": pod, "NodeNames": list(nodes)})
    if fres.get("Error") or not fres["NodeNames"]:
        raise RuntimeError(f"{pod['metadata']['name']} unschedulable: "
                           f"{fres.get('Error') or fres['FailedNodes']}")
    pres = router.handle("prioritize", {"Pod": pod,
                                        "NodeNames": fres["NodeNames"]})
    scores = {e["Host"]: e["Score"] for e in pres}
    best = max(sorted(scores), key=lambda h: scores[h])
    meta = pod["metadata"]
    bres = router.handle("bind", {"PodName": meta["name"],
                                  "PodNamespace": meta["namespace"],
                                  "PodUID": meta["uid"], "Node": best})
    if bres.get("Error"):
        raise RuntimeError(f"{meta['name']} bind: {bres['Error']}")
    return best, codec.decode_alloc(bres["Annotations"][codec.ANNO_ALLOC])


def shard_life(card_agent, start_serving=None, run_solo=None) -> dict:
    """Step 19c: a DCN gang through the shard router's two-phase
    rendezvous with one member on this machine's GPU, every effect
    through the REST channel of step 12 (the stand-in apiserver,
    ``rest_loops``: the lifecycle's resyncs ride the router's federated
    ``allocs_since``). An in-process ``ShardRouter`` with
    ``SHARD_LIFE_ENV`` (two replicas, batching, provenance at rate 1.0,
    the journal with a segment per replica); the stand-in holds two
    nodes, each its own slice: this machine's Node, annotated by
    ``card_agent()``'s node agent, and a sim HGX host of 8 GPUs. The
    slices go to different replicas.

    A 9-member gang of one-GPU pods that opts into DCN fits no replica
    whole: its webhooks go through the rendezvous (8 members on the sim
    host, one on tpu-0) and it commits; the card member's env is its
    bind's annotation (the global gang env: two slices, its own index)
    and the plugin's Allocate. ``start_serving(env)`` starts it (a Popen
    that prints a ``serving`` line, then serves and exits); None: no
    container (the tests). Its stitched ``router.explain`` shows the
    router's route and rendezvous stages and its replica's chain through
    bind, under one trace id. While it serves, the replica owning the
    card's slice is killed: ``shard-x`` is not placed, the federated
    ledger drops the dead replica's pods; ``restart_replica`` with the
    stand-in's pod objects restarts it warm from its segment, the member
    back on tpu-0, zero leaked reservations, zero divergence. The
    lifecycle's next resync is a full read (a new incarnation), the next
    incremental. The gang ends while the pod stream delivers nothing
    (its pods' events lost): one resync finds them terminal and each
    replica gets one ``release_many``. ``shard-x`` binds tpu-0 and runs
    (``run_solo(env)``, its report). The router's /statusz and /metrics
    show both replicas, the rendezvous and the resync counters. Returns
    the decisions and host-clock times; raises RuntimeError when a check
    fails. No container outlives the call."""
    import tempfile

    from tpukube_torch.apiserver import FakeApiServer, live_alloc_pods
    from tpukube_torch.chaos import leaked_reservations, ledger_divergence
    from tpukube_torch.device.gpu import (
        ENV_GANG_NUM_SLICES,
        ENV_GANG_SLICE_INDEX,
        ENV_GANG_SLICES,
    )
    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.metrics import render_federated_metrics
    from tpukube_torch.obs.slo import parse_metrics, validate_exposition
    from tpukube_torch.obs.statusz import router_statusz
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sched.shard import ShardRouter
    from tpukube_torch.sim.kube_rest import KubeRestServer

    pkg = port_pkg()
    a, codec = pkg.api, pkg.codec

    class GapApi(FakeApiServer):
        """The stand-in's store, with a watch gap: pods that end while
        the pod stream delivers nothing (their events lost, as across a
        stream's reconnect window); only a list sees them."""

        def end_unseen(self, keys: list) -> None:
            with self._lock:
                for key in keys:
                    self._pods[key] = {**self._pods[key],
                                       "status": {"phase": "Succeeded"}}

    out: dict = {}
    t_step = time.perf_counter()
    store = GapApi()
    procs: list = []
    with tempfile.TemporaryDirectory() as td, \
            KubeRestServer(store=store, token=REST_TOKEN) as kube, \
            contextlib.ExitStack() as stack:

        def stop_containers() -> None:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()

        stack.callback(stop_containers)
        cfg = pkg.load_config(env={**SHARD_LIFE_ENV, "TPUKUBE_JOURNAL_PATH":
                                   os.path.join(td, "wal.jsonl")})
        api = pkg.rest_api(cfg, kube.base_url, token=REST_TOKEN)
        router = ShardRouter(cfg)
        stack.callback(router.shutdown)
        agent = stack.enter_context(card_agent())
        node = agent.mgr.host
        out["node"] = node
        res = agent.server.resource_name
        nodes = [node, SHARD_SIM_HOST]
        api.patch_node_annotations(node, codec.annotate_node(
            agent.mgr.node_info(), agent.mgr.mesh))
        api.patch_node_annotations(SHARD_SIM_HOST, shard_sim_host(codec))
        loops = stack.enter_context(rest_loops(pkg, router, api))
        intents = a.AllocIntentWatcher(api, node, agent.server,
                                       poll_seconds=REST_POLL_S)
        intents.start()
        stack.callback(intents.stop)
        wait_for("the intent watch", intents.stream_connected)
        wait_for("both nodes' topology", lambda: all(
            router.state.node(n) is not None for n in nodes))
        with router._lock:
            assignment = dict(router._slice_replica)
        out["slice_assignment"] = {s: f"r{i}" for s, i in
                                   sorted(assignment.items())}
        print(f"shard: slice -> replica {out['slice_assignment']}", flush=True)
        card_idx = router._node_replica[node]
        if sorted(assignment.values()) != [0, 1] \
                or router._node_replica[SHARD_SIM_HOST] == card_idx:
            raise RuntimeError(f"slices on one replica: {assignment}")
        out["card_replica"] = f"r{card_idx}"

        def pods_now() -> dict:
            return {f"{p['metadata'].get('namespace', 'default')}/"
                    f"{p['metadata']['name']}": p for p in api.list_pods()}

        def resync() -> dict:
            loops.informer.check_once()
            return loops.lifecycle.resync_stats()

        def env_of(name: str, alloc) -> dict:
            """The bound pod's container env: its alloc annotation as the
            stand-in holds it (the downward API's source) under the
            plugin's Allocate of the ids the intent watch delivered."""
            key = f"default/{name}"
            wait_for(f"{name}'s intent", lambda: agent.server.intents
                     .snapshot().get(key) == alloc.device_ids)
            payload = (api.get_pod("default", name)["metadata"]
                       ["annotations"][codec.ANNO_ALLOC])
            return {**codec.decode_alloc(payload).env,
                    **agent.kubelet.allocate(res, alloc.device_ids),
                    ENV_ALLOC: payload}

        # the gang: fits no replica whole, goes through the rendezvous
        group = pkg.PodGroup("shard-gang", min_member=SHARD_GANG,
                             allow_dcn=True)
        members = [pod_object(f"gang-{i}", tpu=1,
                              annotations=codec.pod_group_annotations(group))
                   for i in range(SHARD_GANG)]
        for pod in members:
            kube.store.upsert_pod(pod)
        out["resync_before_gang"] = resync()
        binds = {}
        t_prepare = time.perf_counter()
        for pod in members:
            host, alloc = route_cycle(router, codec, pod, nodes)
            binds[pod["metadata"]["name"]] = (host, alloc)
            if router.rendezvous_committed and "rendezvous_ms" not in out:
                out["rendezvous_ms"] = (time.perf_counter() - t_prepare) * 1e3
        on_card = [n for n, (h, _) in binds.items() if h == node]
        on_sim = [n for n, (h, _) in binds.items() if h == SHARD_SIM_HOST]
        out["rendezvous"] = {"prepared": router.rendezvous_prepared,
                             "committed": router.rendezvous_committed,
                             "aborted": router.rendezvous_aborted}
        if (len(on_card) != 1 or len(on_sim) != SHARD_GANG - 1
                or out["rendezvous"] != {"prepared": 1, "committed": 1,
                                         "aborted": 0}):
            raise RuntimeError(f"the gang: {len(on_card)} on the card, "
                               f"{len(on_sim)} on the sim host, rendezvous "
                               f"{out['rendezvous']}")
        member = on_card[0]
        member_key = f"default/{member}"
        alloc = binds[member][1]
        if alloc.device_ids != ["tpu-0"]:
            raise RuntimeError(f"{member} bound {alloc.device_ids}")
        env = env_of(member, alloc)
        gang_env = {k: env.get(k) for k in (
            ENV_GANG_NUM_SLICES, ENV_GANG_SLICES, ENV_GANG_SLICE_INDEX)}
        want_slices = sorted(assignment)
        out["member"] = member
        out["member_gang_env"] = gang_env
        if gang_env != {ENV_GANG_NUM_SLICES: "2",
                        ENV_GANG_SLICES: ",".join(want_slices),
                        ENV_GANG_SLICE_INDEX:
                            str(want_slices.index(agent.mgr.node_info().slice_id))}:
            raise RuntimeError(f"{member}'s gang env {gang_env}")
        print(f"shard: {member} bound tpu-0 of {node}, gang env {gang_env}; "
              f"{len(on_sim)} members on {SHARD_SIM_HOST}", flush=True)
        # the member's stitched explain: the router's stages and its
        # replica's chain through bind, one trace id
        doc = router.explain(member_key)
        stages = [(_source(ev), ev["stage"]) for ev in doc["stages"]]
        trace_of = {}  # (source, stage) -> the first such stage's trace id
        for ev in doc["stages"]:
            trace_of.setdefault((_source(ev), ev["stage"]),
                                (ev.get("ctx") or {}).get("trace"))
        out["explain_stages"] = [[src, stage, trace_of[(src, stage)]]
                                 for src, stage in stages]
        # the member's /filter webhook is one trace: the router's route
        # and its replica's gang reserve and filter; the rendezvous (the
        # gang's, under the trace of the webhook that prepared it) is in
        # the chain, and the replica's chain runs through bind (its own
        # webhook's trace)
        rep = out["card_replica"]
        trace = trace_of.get(("router", "route"))
        out["explain_trace"] = trace
        if (trace is None
                or {trace_of.get(k) for k in (
                    (rep, "gang_reserve"), (rep, "filter"))} != {trace}
                or not trace_of.get(("router", "rendezvous"))
                or not trace_of.get((rep, "bind"))):
            raise RuntimeError(f"{member}'s explain: "
                               f"{out['explain_stages']}")
        if start_serving is not None:
            proc = start_serving(env)
            procs.append(proc)
            lines: queue.Queue = queue.Queue()
            threading.Thread(target=pump, args=(proc.stdout, lines),
                             daemon=True).start()
            while True:
                line = lines.get(timeout=POD_TIMEOUT_S)
                if line is None:
                    raise RuntimeError(f"{member} exited {proc.wait()} "
                                       f"before serving")
                print(f"{member}: {line.rstrip()}", flush=True)
                if line.startswith('{"serving"'):
                    break
        out["resync_before_kill"] = resync()
        # the kill, while the member serves: the journal's drain thread
        # has landed the member's bind (it bound seconds ago)
        router.replicas[card_idx].extender.journal.sync()
        t_kill = time.perf_counter()
        router.kill_replica(card_idx)
        out["member_serving_at_kill"] = (start_serving is not None
                                         and procs[0].poll() is None)
        if start_serving is not None and not out["member_serving_at_kill"]:
            raise RuntimeError(f"{member} ended before the kill")
        # shard-x must run on this machine (kube-scheduler's own
        # predicates leave this node alone as its candidate)
        x = pod_object("shard-x", tpu=1)
        kube.store.upsert_pod(x)
        fres = router.handle("filter", {"Pod": x, "NodeNames": [node]})
        out["shard_x_while_dead"] = fres["NodeNames"]
        ledger = {al.pod_key for al in router.state.allocations()}
        if fres["NodeNames"] or member_key in ledger:
            raise RuntimeError(f"while r{card_idx} is dead: shard-x feasible "
                               f"on {fres['NodeNames']}, member in the "
                               f"ledger: {member_key in ledger}")
        # the warm restart from the replica's segment, fed the stand-in's
        # node and pod objects
        t_restart = time.perf_counter()
        pods = pods_now()
        owned = router.replica_pods(card_idx, pods)
        node_annos = [(n, kube.store.get_node_annotations(n)) for n in nodes
                      if router._node_replica.get(n) == card_idx]
        restored = router.restart_replica(
            card_idx, node_annos,
            [annos for annos, _, _ in live_alloc_pods(owned)],
            pod_objects=owned)
        t_ready = time.perf_counter()
        out["kill_to_restart_ms"] = (t_restart - t_kill) * 1e3
        out["restart_ms"] = (t_ready - t_restart) * 1e3
        out["last_restart"] = dict(router.last_restart)
        back = router.state.allocation(member_key)
        view = types.SimpleNamespace(extender=router, pods=pods_now())
        out["leaked_reservations"] = len(leaked_reservations(view))
        out["ledger_divergence"] = len(ledger_divergence(view))
        if (not out["last_restart"]["warm"] or restored < 1
                or back is None or back.node_name != node
                or back.device_ids != ["tpu-0"]
                or out["leaked_reservations"] or out["ledger_divergence"]):
            raise RuntimeError(f"the restart: {out['last_restart']}, member "
                               f"{back}, {out['leaked_reservations']} leaked, "
                               f"{out['ledger_divergence']} diverged")
        # the lifecycle's next resync reads in full (the new incarnation),
        # the one after it incrementally
        r1, r2 = resync(), resync()
        out["resync_after_restart"] = [r1, r2]
        before = out["resync_before_kill"]
        if (r1["full"] != before["full"] + 1
                or r1["incremental"] != before["incremental"]
                or r2["full"] != r1["full"]
                or r2["incremental"] != r1["incremental"] + 1):
            raise RuntimeError(f"resyncs around the restart: {before} -> "
                               f"{r1} -> {r2}")
        if start_serving is not None:
            proc = procs[0]
            report = None
            while True:
                line = lines.get(timeout=POD_TIMEOUT_S)
                if line is None:
                    break
                report = line
            if proc.wait() != 0 or report is None:
                raise RuntimeError(f"{member} exited {proc.returncode}")
            out["member_pod"] = json.loads(report)["pod"]
        # the gang ends unseen; one resync releases it, one release_many
        # a replica
        calls: list = []
        for rep in router.replicas:
            real = rep.transport.release_many

            def counted(keys, _real=real, _name=rep.name):
                calls.append((_name, sorted(keys)))
                return _real(keys)

            rep.transport.release_many = counted
        kube.store.end_unseen([f"default/{p['metadata']['name']}"
                               for p in members])
        resync()
        ledger = {al.pod_key for al in router.state.allocations()}
        out["release_many"] = {name: len(keys) for name, keys in calls}
        want_calls = {f"r{card_idx}": 1,
                      f"r{1 - card_idx}": SHARD_GANG - 1}
        if (out["release_many"] != want_calls or len(calls) != 2
                or any(f"default/{n}" in ledger for n in binds)):
            raise RuntimeError(f"the gang's releases: {calls}")
        # shard-x binds the card, runs, ends
        host, xalloc = route_cycle(router, codec, x, [node])
        if host != node or xalloc.device_ids != ["tpu-0"]:
            raise RuntimeError(f"shard-x bound {xalloc.device_ids} on {host}")
        xenv = env_of("shard-x", xalloc)
        if run_solo is not None:
            out["shard_x_pod"] = run_solo(xenv)
        done = dict(kube.store.get_pod("default", "shard-x"))
        done["status"] = {"phase": "Succeeded"}
        kube.store.upsert_pod(done)
        wait_for("shard-x's release",
                 lambda: router.state.allocation("default/shard-x") is None)
        # the router's /statusz and /metrics
        z = router_statusz(router)
        out["statusz"] = {"replicas": [(r["replica"], r["alive"])
                                       for r in z["replicas"]],
                          "rendezvous_counters": z["rendezvous_counters"]}
        page = render_federated_metrics(router, lifecycle=loops.lifecycle)
        errors = validate_exposition(page)
        samples = {s.name + ("{" + ",".join(f'{k}="{v}"' for k, v in
                                             sorted(s.labels)) + "}"
                             if s.labels else ""): s.value
                   for s in parse_metrics(page)}
        out["metrics"] = {k: v for k, v in samples.items() if k.startswith((
            "tpukube_replica_up", "tpukube_router_rendezvous_total",
            "tpukube_resync_"))}
        want = {'tpukube_replica_up{replica="r0"}': 1.0,
                'tpukube_replica_up{replica="r1"}': 1.0,
                'tpukube_router_rendezvous_total{outcome="committed"}': 1.0}
        if (errors or any(out["metrics"].get(k) != v for k, v in want.items())
                or out["statusz"]["rendezvous_counters"]["committed"] != 1
                or [r[1] for r in out["statusz"]["replicas"]] != [True, True]
                or not out["metrics"].get("tpukube_resync_incremental_total")):
            raise RuntimeError(f"the router's pages: {errors}, "
                               f"{out['metrics']}, {out['statusz']}")
        out["resync"] = loops.lifecycle.resync_stats()
        # host-clock /filter handles: the router's beside its replica's
        probe, solo = (pod_object(n, tpu=1) for n in ("probe-r", "probe-e"))
        ext = router.replicas[card_idx].extender
        for who, target, pod in (("router", router, probe),
                                 ("replica", ext, solo)):
            body = {"Pod": pod, "NodeNames": nodes}
            walls = []
            for _ in range(SHARD_FILTER_ROUNDS):
                t = time.perf_counter()
                target.handle("filter", body)
                walls.append((time.perf_counter() - t) * 1e3)
            out[f"filter_ms_{who}"] = statistics.median(walls)
        out["routes"] = dict(kube.requests)
    out["step_s"] = time.perf_counter() - t_step
    return out


def shard_phase(card: str, c0, prov: dict):
    """Step 19 on the card: scenario 14 at the reference's smoke size and
    at its defaults (19a, 19b), then ``shard_life`` with the card's node
    agent, the member a Llama-3-8B B=1 pod of three requests and shard-x
    one of one (19c); prints the ``shard:`` line's text (19d). ``prov``
    is step 18's line (why-0's forward). Returns the line's object, or
    None when a check failed."""
    host = host_cpu()

    def start_serving(env):
        return subprocess.Popen(
            [sys.executable, "-m", "tpukube_torch.graft", "--requests", "3",
             "--batch", "1"],
            cwd=ROOT, env=pod_env(env), stdout=subprocess.PIPE, text=True)

    def run_solo(env):
        r = run_pod(["--requests", "1", "--batch", "1"], env, "pod")
        if r is None or r["uuid"] != c0.chip_id or r["batch"] != 1:
            raise RuntimeError(f"shard-x's pod failed: {r}")
        return r

    try:
        drives = shard_scenarios()
        life = shard_life(lambda: node_agent({}), start_serving=start_serving,
                          run_solo=run_solo)
    except (RuntimeError, subprocess.SubprocessError, OSError,
            queue.Empty) as e:
        fail(f"shard: {e}")
        return None
    member = life.pop("member_pod")
    if member["uuid"] != c0.chip_id or member["batch"] != 1:
        fail(f"the card member's pod: {member}")
        return None
    print(f"{life['member']}: " + json.dumps(member, sort_keys=True), flush=True)
    print("shard-x: " + json.dumps(life.pop("shard_x_pod"), sort_keys=True),
          flush=True)
    why0 = prov["why0_pod"]
    line = {"card": card, "host": host, **drives, **life,
            "member_forward_ms": member["forward_ms_median"],
            "member_tokens_per_s": member["tokens_per_s"],
            "why0_pod": why0}
    sm, fl, rs = drives["smoke"], drives["fleet"], life["resync"]
    print(
        f"shard: scenario 14 smoke ({sm['nodes']} nodes, {sm['replicas']} "
        f"replicas, {sm['pods_total']} pods) {sm['pods_per_sec']} pods/s "
        f"(floor {sm['pods_per_sec_min']}); fleet ({fl['nodes']} nodes, "
        f"{fl['chips']} GPUs, {fl['replicas']} replicas, {fl['pods_total']} "
        f"pods) {fl['pods_per_sec']} pods/s, setup {fl['setup_s']} s; /filter "
        f"median {life['filter_ms_router']:.3f} ms through the router vs "
        f"{life['filter_ms_replica']:.3f} ms on the replica "
        f"({SHARD_FILTER_ROUNDS} rounds); rendezvous prepare -> commit "
        f"{life['rendezvous_ms']:.3f} ms; kill -> restart "
        f"{life['kill_to_restart_ms']:.3f} ms -> ready "
        f"{life['restart_ms']:.3f} ms ({life['last_restart']['restored']} "
        f"allocations restored warm); resync {rs['full']} full, "
        f"{rs['incremental']} incremental, {rs['bytes']} bytes, hit ratio "
        f"{rs['incremental_hit_ratio']}; {life['member']} Llama-3-8B B=1 "
        f"S=2048 {member['forward_ms_median']:.3f} ms, "
        f"{member['tokens_per_s']:.1f} tokens/s (step 18's why-0: "
        f"{why0['forward_ms_median']:.3f} ms, {why0['tokens_per_s']:.1f} "
        f"tokens/s); step {life['step_s']:.1f} s [host CPU times; {host}; "
        f"{card}]",
        flush=True,
    )
    return line


# -- the process-parallel sharded plane (step 20) ------------------------------

# tools/check.sh's process-mode shard smoke: 4 slices of 8x8x16 with host
# block 2,2,1 (1,024 nodes), the batch cycle with plan-served /filter
# answers, every replica a worker daemon
SHARD_MP_ENV = {"TPUKUBE_SIM_MESH_DIMS": "8,8,16", "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                "TPUKUBE_BATCH_ENABLED": "1", "TPUKUBE_BATCH_MAX_PODS": "2048",
                "TPUKUBE_FILTER_FROM_PLAN": "1",
                "TPUKUBE_SHARD_TRANSPORT": "subprocess"}
SHARD_MP_GANG = 128  # check.sh's training gang and alive cap
SHARD_MP_ALIVE = 2048
# drives of each point, taken in turns (N=1, N=2, N=1, ...): one drive is
# under 2 s of wall on the card host, and one N=2 drive read 3,556.2 pods/s
# in a whole run and 4,225.3 with step 20 alone (PERF.md §6), so each point
# is the median of its drives
SHARD_MP_ROUNDS = 3
SHARD_MP_CHILD_S = 600  # the drive child's time limit
WIRE_MICRO_ROUNDS = 25  # the micro point's p50 rounds, as bench.sched_micro's
# step 19c's router over worker daemons
SHARD_PROC_LIFE_ENV = {**SHARD_LIFE_ENV, "TPUKUBE_SHARD_TRANSPORT": "subprocess"}


def schedulable_cores(affinity=None, cgroup: str = "/sys/fs/cgroup") -> dict:
    """The cores this process may run on: the smaller of its CPU affinity
    and its cgroup's CPU quota (cgroup v2 ``cpu.max``, else v1
    ``cpu.cfs_quota_us`` / ``cpu.cfs_period_us``), the quota rounded up.
    ``os.cpu_count()`` counts the host's CPUs, which a container may not
    get. Returns the affinity count, the quota in cores (None: no
    quota), the result and ``os.cpu_count()``."""
    aff = len(os.sched_getaffinity(0)) if affinity is None else affinity
    quota = None
    with contextlib.suppress(OSError, ValueError):
        with open(os.path.join(cgroup, "cpu.max")) as f:
            q, period = f.read().split()[:2]
        if q != "max":
            quota = int(q) / int(period)
    if quota is None:
        with contextlib.suppress(OSError, ValueError):
            with open(os.path.join(cgroup, "cpu", "cpu.cfs_quota_us")) as f:
                q = int(f.read())
            with open(os.path.join(cgroup, "cpu", "cpu.cfs_period_us")) as f:
                period = int(f.read())
            if q > 0 and period > 0:
                quota = q / period
    cores = aff if quota is None else min(aff, math.ceil(quota))
    return {"affinity": aff, "quota": quota, "cores": cores,
            "os_cpu_count": os.cpu_count()}


def live_children(pid=None) -> list:
    """(pid, command line) of each live child process of ``pid`` (this
    process by default), read from /proc."""
    pid = os.getpid() if pid is None else pid
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        with contextlib.suppress(OSError, ValueError, IndexError):
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            # the command name may hold spaces: fields follow its ")"
            fields = stat[stat.rindex(")") + 2:].split()
            if int(fields[1]) != pid or fields[0] == "Z":
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            out.append((int(entry), cmd.strip()))
    return sorted(out)


def _shard_mp_slices(cfg) -> dict:
    from tpukube_torch.core.mesh import MeshSpec

    mesh = cfg.sim_mesh()
    return {f"s{i:02d}": MeshSpec(dims=mesh.dims, host_block=mesh.host_block,
                                  torus=mesh.torus) for i in range(4)}


def shard_mp_sweep() -> dict:
    """Step 20a: tools/check.sh's process-mode smoke on the port —
    ``_kilonode_drive`` over 1,024 nodes with the ``shard_mp`` block's
    pods at N=1 and N=2 worker daemons (each drive raises on a leak, a
    divergence or a shortfall), ``SHARD_MP_ROUNDS`` drives of each in
    turns. Every N=2 drive's pods/s must reach the block's floor, and the
    parallel efficiency (N=2's median pods/s over N=1's, halved) its
    floor where ``schedulable_cores`` counts 3 or more (two workers and
    the router). Raises RuntimeError naming the gate."""
    from tpukube_torch.core.config import load_config
    from tpukube_torch.sim import scenarios

    with open(PERF_FLOOR) as f:
        floor = json.load(f)["shard_mp"]
    cores = schedulable_cores()
    print(f"shard_proc 20a: schedulable cores {cores['cores']} (affinity "
          f"{cores['affinity']}, cgroup quota {cores['quota']}, "
          f"os.cpu_count() {cores['os_cpu_count']})", flush=True)
    runs: dict = {1: [], 2: []}
    for _ in range(SHARD_MP_ROUNDS):
        for n in (1, 2):
            cfg = load_config(env={**SHARD_MP_ENV,
                                   "TPUKUBE_PLANNER_REPLICAS": str(n)})
            r = scenarios._kilonode_drive(
                cfg, metric=f"shard_mp_n{n}", total_target=floor["pods"],
                gang_size=SHARD_MP_GANG, max_alive=SHARD_MP_ALIVE,
                check_leaks=True, slices=_shard_mp_slices(cfg),
                include_setup=False)
            if (r["ledger_divergence"] or not r["gang_committed"]
                    or r["shard"]["transport"]["mode"] != "subprocess"):
                raise RuntimeError(f"N={n}: {r}")
            runs[n].append(r)
            print(f"shard_proc 20a: N={n} {r['pods_total']} pods "
                  f"{r['pods_per_sec']} pods/s (wall {r['wall_s']} s, setup "
                  f"{r['setup_s']} s)", flush=True)
    per_run = {n: [r["pods_per_sec"] for r in runs[n]] for n in (1, 2)}
    p1, p2 = (statistics.median(per_run[n]) for n in (1, 2))
    eff = (p2 / p1) / 2 if p1 else 0.0
    last = runs[2][-1]
    tr = last["shard"]["transport"]
    out = {"nodes": last["nodes"], "pods": last["pods_total"],
           "n1_pods_per_sec": p1, "n2_pods_per_sec": p2,
           "pods_per_sec_by_run": per_run,
           "walls_s": {n: [r["wall_s"] for r in runs[n]] for n in (1, 2)},
           "parallel_efficiency": round(eff, 4), "cores": cores,
           "pods_per_sec_min": floor["pods_per_sec_min"],
           "parallel_efficiency_min": floor["parallel_efficiency_min"],
           "efficiency_gated": cores["cores"] >= 3,
           "transport": tr, "wire": last["wire"]}
    if min(per_run[2]) < floor["pods_per_sec_min"]:
        raise RuntimeError(f"N=2 {per_run[2]} pods/s: one under the "
                           f"shard_mp floor {floor['pods_per_sec_min']}")
    if out["efficiency_gated"]:
        if eff < floor["parallel_efficiency_min"]:
            raise RuntimeError(
                f"parallel efficiency {eff:.4f} < the shard_mp floor "
                f"{floor['parallel_efficiency_min']} on {cores['cores']} "
                f"schedulable cores")
    else:
        print(f"parallel-efficiency floor SKIPPED: {cores['cores']} "
              f"schedulable CPU(s) — workers time-slice, the ratio measures "
              f"contention, not parallelism", flush=True)
    return out


def wire_micro() -> dict:
    """bench.sched_micro's wire point on the port's codec: a fleet-shaped
    upsert wave of the 16x16x16 mesh's 64 hosts (host block 4,4,4), TKW1
    encode and decode p50 µs and the compact-JSON / frame size ratio."""
    from tpukube_torch.core.mesh import MeshSpec
    from tpukube_torch.sched import wirecodec

    mesh = MeshSpec(dims=(16, 16, 16), host_block=(4, 4, 4))
    names = sorted(mesh.all_hosts())
    wave = {"items": [
        {"name": name, "slice": "slice-0", "topology": "16x16x16",
         "chips": mesh.chips_per_host,
         "device_ids": [f"{name}-chip-{i}" for i in range(mesh.chips_per_host)],
         "badLinks": ([] if i % 7 else
                      [{"from": f"{name}-chip-0", "to": f"{name}-chip-1"}]),
         "free": mesh.chips_per_host, "epoch": 3, "healthy": True}
        for i, name in enumerate(names)]}

    def p50_us(fn) -> float:
        walls = []
        for _ in range(WIRE_MICRO_ROUNDS):
            t = time.perf_counter()
            fn()
            walls.append(time.perf_counter() - t)
        return sorted(walls)[len(walls) // 2] * 1e6

    json_len = len(wirecodec.dumps_json(wave))
    frame, _ = wirecodec.encode_frame(wave, 1024)
    if wirecodec.decode_frame(frame) != wave:
        raise RuntimeError("the micro wave does not round-trip")
    return {"encode_us": p50_us(lambda: wirecodec.encode_frame(wave, 1024)),
            "decode_us": p50_us(lambda: wirecodec.decode_frame(frame)),
            "json_bytes": json_len, "frame_bytes": len(frame),
            "ratio": json_len / len(frame)}


def wire_codec_smoke() -> dict:
    """Step 20b: tools/check.sh's wire-codec smoke on the port. A fixed
    mixed workload over 2 worker daemons places the same with
    ``wire_codec`` json and binary, and the binary run moves TKW1 frames;
    the 1,024-node drive at ``snapshot_audit_rate`` 1.0 over 2 workers
    with the ``wire`` block's pods, once per codec: json's bytes per wave
    over binary's must reach the block's ratio. Then the micro point
    (:func:`wire_micro`) against the block's µs ceilings times
    ``allowed_regression`` and its size-ratio floor. Raises RuntimeError
    naming the gate."""
    from tpukube_torch.core.clock import FakeClock
    from tpukube_torch.core.config import load_config
    from tpukube_torch.core.mesh import MeshSpec
    from tpukube_torch.core.types import PodGroup
    from tpukube_torch.sim import SimCluster, scenarios

    with open(PERF_FLOOR) as f:
        floors = json.load(f)
    floor, slack = floors["wire"], floors["allowed_regression"]

    def mixed(codec: str):
        cfg = load_config(env={
            "TPUKUBE_PLANNER_REPLICAS": "2", "TPUKUBE_SHARD_TRANSPORT": "subprocess",
            "TPUKUBE_BATCH_ENABLED": "1", "TPUKUBE_BACKEND": "sim",
            "TPUKUBE_WIRE_CODEC": codec, "TPUKUBE_WIRE_COMPRESS_MIN_BYTES": "256"})
        slices = {sid: MeshSpec(dims=(2, 2, 2), host_block=(2, 2, 1),
                                torus=(False, False, False)) for sid in ("s0", "s1")}
        placed = {}
        with SimCluster(cfg, clock=FakeClock(), in_process=True,
                        slices=slices) as c:
            def put(pod):
                node, alloc = c.schedule(pod)
                placed[alloc.pod_key] = (node, sorted(alloc.device_ids))

            put(c.make_pod("solo-0", tpu=1))
            put(c.make_pod("multi-0", tpu=2))
            grp = PodGroup("pg", min_member=2)
            for i in range(2):
                put(c.make_pod(f"pg-{i}", tpu=1, group=grp, priority=10))
            c.complete_pod("solo-0")
            put(c.make_pod("solo-1", tpu=1))
            return placed, c.extender.wire_totals()

    placed_json, small_json = mixed("json")
    placed_bin, small_bin = mixed("binary")
    if placed_json != placed_bin:
        raise RuntimeError(f"json placements {placed_json} != binary "
                           f"{placed_bin}")
    if small_bin.get("codec") != "binary" or "codec" in small_json:
        raise RuntimeError("the binary run moved no TKW1 frame (or the json "
                           "run did)")

    def drive(codec: str) -> dict:
        cfg = load_config(env={**SHARD_MP_ENV, "TPUKUBE_PLANNER_REPLICAS": "2",
                               "TPUKUBE_SNAPSHOT_AUDIT_RATE": "1.0",
                               "TPUKUBE_WIRE_CODEC": codec})
        r = scenarios._kilonode_drive(
            cfg, metric=f"wire_{codec}", total_target=floor["pods"],
            gang_size=SHARD_MP_GANG, max_alive=SHARD_MP_ALIVE,
            check_leaks=True, slices=_shard_mp_slices(cfg), include_setup=False)
        if r["ledger_divergence"] or not r["gang_committed"]:
            raise RuntimeError(f"the {codec} drive: {r}")
        return r["wire"]

    wj, wb = drive("json"), drive("binary")
    ratio = wj["bytes_per_wave"] / wb["bytes_per_wave"] if wb["bytes_per_wave"] else 0.0
    micro = wire_micro()
    out = {"placements_equal": True, "mixed_pods": len(placed_json),
           "json_bytes_per_wave": wj["bytes_per_wave"],
           "binary_bytes_per_wave": wb["bytes_per_wave"],
           "bytes_per_wave_ratio": round(ratio, 4),
           "bytes_per_wave_ratio_min": floor["bytes_per_wave_ratio_min"],
           "binary_compress_ratio": wb.get("compress_ratio"),
           "binary_saved_bytes": wb.get("saved_bytes"),
           "json_top_ops": wj["top_ops"], "binary_top_ops": wb["top_ops"],
           "micro": micro,
           "encode_us_max": floor["encode_us_max"] * slack,
           "decode_us_max": floor["decode_us_max"] * slack,
           "micro_ratio_min": floor["micro_ratio_min"]}
    if wb.get("codec") != "binary":
        raise RuntimeError("the binary drive recorded no codec")
    if ratio < floor["bytes_per_wave_ratio_min"]:
        raise RuntimeError(f"bytes/wave ratio {ratio:.4f} < the wire floor "
                           f"{floor['bytes_per_wave_ratio_min']}")
    for key in ("encode", "decode"):
        if micro[f"{key}_us"] > out[f"{key}_us_max"]:
            raise RuntimeError(f"micro {key} {micro[f'{key}_us']:.1f} us > "
                               f"{out[f'{key}_us_max']:.1f} us")
    if micro["ratio"] < floor["micro_ratio_min"]:
        raise RuntimeError(f"micro size ratio {micro['ratio']:.4f} < "
                           f"{floor['micro_ratio_min']}")
    return out


def shard_proc_child() -> int:
    """Steps 20a and 20b in this (fresh) interpreter: prints their
    results as one JSON line, last; on a failed gate prints
    ``shard_proc 20a: ...`` or ``20b: ...`` on stderr and returns 1. No
    worker daemon outlives it (its live children are read from /proc)."""
    out = {}
    for tag, fn in (("20a", shard_mp_sweep), ("20b", wire_codec_smoke)):
        t = time.perf_counter()
        try:
            out[tag] = fn()
        except Exception as e:  # noqa: BLE001 (every failure fails the step)
            import traceback

            traceback.print_exc()
            return fail(f"shard_proc {tag}: {type(e).__name__}: {e}")
        out[tag]["step_s"] = time.perf_counter() - t
    left = live_children()
    if left:
        return fail(f"shard_proc 20b: processes left alive: {left}")
    print(json.dumps(out), flush=True)
    return 0


def wait_journaled(path: str, key: str, timeout: float = REST_WAIT_S) -> None:
    """Wait until the WAL segment at ``path`` holds a record naming
    ``key`` (a worker's drain thread writes it moments after the bind)."""
    needle = json.dumps(key).encode()

    def landed() -> bool:
        with contextlib.suppress(OSError):
            with open(path, "rb") as f:
                return needle in f.read()
        return False

    wait_for(f"{key} in {path}", landed, timeout)


def shard_proc_life(card_agent, start_serving=None, run_solo=None) -> dict:
    """Step 20c: step 19c's card pod under a router over worker daemons.
    A ``ShardRouter`` with ``SHARD_PROC_LIFE_ENV`` (two replicas, each a
    ``shard-worker`` process; batching, provenance at rate 1.0, the
    journal with a segment per worker) over the REST stand-in and its
    loops, holding this machine's Node (``card_agent()``'s node agent)
    and a sim HGX host of 8 GPUs, their slices on different workers; the
    router applies the REST bind effector from each bind answer. A
    9-member DCN gang goes through the rendezvous, the member on tpu-0
    with the global gang env in its annotation and its container env
    (the plugin's Allocate merged over it); ``start_serving(env)`` starts
    it (None: no container). While it serves, the card's worker process
    is SIGKILLed (``kill_replica``): ``shard-x`` is not placed, the
    federated ledger drops the dead worker's pods; a fresh worker is
    spawned and restarted warm from its journal segment: the federated
    state is what it was before the kill, zero leaked reservations and
    divergence. The member exits 0; the gang ends and reaches each worker
    as one ``release_many``; ``shard-x`` binds tpu-0 and runs
    (``run_solo(env)``). The router's listener (``make_router_app`` on
    the extender's threaded server) serves federated /metrics with both
    workers' series under a ``replica`` label and the transport series,
    /statusz with the wire bill and flights, and the member's stitched
    /explain citing both replicas. Every worker spawned has ended when
    the call returns. Returns the decisions and host-clock times; raises
    RuntimeError when a check fails."""
    import tempfile

    from tpukube_torch.apiserver import FakeApiServer, live_alloc_pods
    from tpukube_torch.chaos import leaked_reservations, ledger_divergence
    from tpukube_torch.device.gpu import (
        ENV_GANG_NUM_SLICES,
        ENV_GANG_SLICE_INDEX,
        ENV_GANG_SLICES,
    )
    from tpukube_torch.graft import ENV_ALLOC
    from tpukube_torch.obs.slo import parse_metrics, validate_exposition
    from tpukube_torch.sched.extender import run_server
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sched.shard import ShardRouter
    from tpukube_torch.sched.shardworker import make_router_app
    from tpukube_torch.sim.kube_rest import KubeRestServer

    pkg = port_pkg()
    a, codec = pkg.api, pkg.codec

    class GapApi(FakeApiServer):
        def end_unseen(self, keys: list) -> None:
            with self._lock:
                for key in keys:
                    self._pods[key] = {**self._pods[key],
                                       "status": {"phase": "Succeeded"}}

    out: dict = {}
    t_step = time.perf_counter()
    store = GapApi()
    procs: list = []
    spawned: list = []
    with tempfile.TemporaryDirectory() as td, \
            KubeRestServer(store=store, token=REST_TOKEN) as kube, \
            contextlib.ExitStack() as stack:

        def stop_containers() -> None:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()

        stack.callback(stop_containers)
        wal = os.path.join(td, "wal.jsonl")
        cfg = pkg.load_config(env={**SHARD_PROC_LIFE_ENV,
                                   "TPUKUBE_JOURNAL_PATH": wal})
        api = pkg.rest_api(cfg, kube.base_url, token=REST_TOKEN)
        t_spawn = time.perf_counter()
        router = ShardRouter(cfg)
        out["router_ready_ms"] = (time.perf_counter() - t_spawn) * 1e3
        spawned = router.spawned
        stack.callback(router.close)
        out["spawn_ready_ms"] = {f"r{t.index}": t.spawn_ready_s * 1e3
                                 for t in router.spawned}
        out["worker_pids"] = {f"r{t.index}": t.pid for t in router.spawned}
        agent = stack.enter_context(card_agent())
        node = agent.mgr.host
        out["node"] = node
        res = agent.server.resource_name
        nodes = [node, SHARD_SIM_HOST]
        api.patch_node_annotations(node, codec.annotate_node(
            agent.mgr.node_info(), agent.mgr.mesh))
        api.patch_node_annotations(SHARD_SIM_HOST, shard_sim_host(codec))
        loops = stack.enter_context(rest_loops(pkg, router, api))
        intents = a.AllocIntentWatcher(api, node, agent.server,
                                       poll_seconds=REST_POLL_S)
        intents.start()
        stack.callback(intents.stop)
        wait_for("the intent watch", intents.stream_connected)
        wait_for("both nodes' topology", lambda: all(
            n in router._node_replica for n in nodes))
        with router._lock:
            assignment = dict(router._slice_replica)
        out["slice_assignment"] = {s: f"r{i}" for s, i in sorted(assignment.items())}
        card_idx = router._node_replica[node]
        if sorted(assignment.values()) != [0, 1] \
                or router._node_replica[SHARD_SIM_HOST] == card_idx:
            raise RuntimeError(f"slices on one worker: {assignment}")
        out["card_replica"] = f"r{card_idx}"
        print(f"shard_proc: slice -> worker {out['slice_assignment']}, "
              f"workers {out['worker_pids']}", flush=True)

        def pods_now() -> dict:
            return {f"{p['metadata'].get('namespace', 'default')}/"
                    f"{p['metadata']['name']}": p for p in api.list_pods()}

        def resync() -> dict:
            loops.informer.check_once()
            return loops.lifecycle.resync_stats()

        def ledger() -> list:
            return sorted((al.pod_key, al.node_name, tuple(al.device_ids))
                          for al in router.state.allocations())

        def env_of(name: str, alloc) -> dict:
            key = f"default/{name}"
            wait_for(f"{name}'s intent", lambda: agent.server.intents
                     .snapshot().get(key) == alloc.device_ids)
            payload = (api.get_pod("default", name)["metadata"]
                       ["annotations"][codec.ANNO_ALLOC])
            return {**codec.decode_alloc(payload).env,
                    **agent.kubelet.allocate(res, alloc.device_ids),
                    ENV_ALLOC: payload}

        group = pkg.PodGroup("shard-proc-gang", min_member=SHARD_GANG,
                             allow_dcn=True)
        members = [pod_object(f"gang-{i}", tpu=1,
                              annotations=codec.pod_group_annotations(group))
                   for i in range(SHARD_GANG)]
        for pod in members:
            kube.store.upsert_pod(pod)
        out["resync_before_gang"] = resync()
        binds = {}
        t_prepare = time.perf_counter()
        for pod in members:
            host, alloc = route_cycle(router, codec, pod, nodes)
            binds[pod["metadata"]["name"]] = (host, alloc)
            if router.rendezvous_committed and "rendezvous_ms" not in out:
                out["rendezvous_ms"] = (time.perf_counter() - t_prepare) * 1e3
        on_card = [n for n, (h, _) in binds.items() if h == node]
        on_sim = [n for n, (h, _) in binds.items() if h == SHARD_SIM_HOST]
        out["rendezvous"] = {"prepared": router.rendezvous_prepared,
                             "committed": router.rendezvous_committed,
                             "aborted": router.rendezvous_aborted}
        if (len(on_card) != 1 or len(on_sim) != SHARD_GANG - 1
                or out["rendezvous"] != {"prepared": 1, "committed": 1,
                                         "aborted": 0}):
            raise RuntimeError(f"the gang: {len(on_card)} on the card, "
                               f"{len(on_sim)} on the sim host, rendezvous "
                               f"{out['rendezvous']}")
        member = on_card[0]
        member_key = f"default/{member}"
        alloc = binds[member][1]
        if alloc.device_ids != ["tpu-0"]:
            raise RuntimeError(f"{member} bound {alloc.device_ids}")
        env = env_of(member, alloc)
        gang_env = {k: env.get(k) for k in (
            ENV_GANG_NUM_SLICES, ENV_GANG_SLICES, ENV_GANG_SLICE_INDEX)}
        want_slices = sorted(assignment)
        out["member"] = member
        out["member_gang_env"] = gang_env
        if gang_env != {ENV_GANG_NUM_SLICES: "2",
                        ENV_GANG_SLICES: ",".join(want_slices),
                        ENV_GANG_SLICE_INDEX:
                            str(want_slices.index(agent.mgr.node_info().slice_id))}:
            raise RuntimeError(f"{member}'s gang env {gang_env} (its "
                               f"annotation must carry the global gang env)")
        print(f"shard_proc: {member} bound tpu-0 of {node}, gang env "
              f"{gang_env}; {len(on_sim)} members on {SHARD_SIM_HOST}",
              flush=True)
        # the router's listener (make_router_app on the extender's threaded
        # server); the member's stitched /explain while its worker holds
        # its chain: the router's route and rendezvous stages (the parts
        # on both workers) and its worker's own stages through bind
        server = run_server(make_router_app(router), "127.0.0.1", 0)
        stack.callback(server.server_close)
        stack.callback(server.shutdown)
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def get(path: str) -> str:
            with urllib.request.urlopen(base + path, timeout=REST_WAIT_S) as r:
                return r.read().decode()

        if get("/healthz") != "ok":
            raise RuntimeError("the router listener's /healthz")
        doc = json.loads(get(f"/explain?pod={member_key}"))
        rdv = [ev for ev in doc["stages"] if ev.get("stage") == "rendezvous"]
        cited = sorted({p["replica"] for ev in rdv for p in (ev.get("parts") or [])})
        sources = sorted({_source(ev) for ev in doc["stages"]})
        stages = {(_source(ev), ev["stage"]) for ev in doc["stages"]}
        why = "\n".join(doc.get("why") or [])
        out["explain"] = {"verdict": doc["verdict"], "parts_replicas": cited,
                          "sources": sources, "stages": len(doc["stages"])}
        rep_name = out["card_replica"]
        if (doc["verdict"] != "placed" or cited != ["r0", "r1"]
                or "replica r0" not in why or "replica r1" not in why
                or not {("router", "route"), (rep_name, "filter"),
                        (rep_name, "bind")} <= stages):
            raise RuntimeError(f"{member}'s stitched /explain: {out['explain']}, "
                               f"stages {sorted(stages)}")
        if start_serving is not None:
            proc = start_serving(env)
            procs.append(proc)
            lines: queue.Queue = queue.Queue()
            threading.Thread(target=pump, args=(proc.stdout, lines),
                             daemon=True).start()
            while True:
                line = lines.get(timeout=POD_TIMEOUT_S)
                if line is None:
                    raise RuntimeError(f"{member} exited {proc.wait()} "
                                       f"before serving")
                print(f"{member}: {line.rstrip()}", flush=True)
                if line.startswith('{"serving"'):
                    break
        out["resync_before_kill"] = resync()
        # the kill, while the member serves: its worker's drain thread has
        # landed the member's bind in the worker's journal segment
        wait_journaled(f"{wal}.r{card_idx}", member_key)
        before = ledger()
        victim = router.replicas[card_idx].transport
        t_kill = time.perf_counter()
        router.kill_replica(card_idx)
        out["kill_ms"] = (time.perf_counter() - t_kill) * 1e3
        out["killed_worker_exit"] = victim._proc.returncode
        if victim._proc.returncode != -signal.SIGKILL:
            raise RuntimeError(f"the killed worker exited "
                               f"{victim._proc.returncode}")
        out["member_serving_at_kill"] = (start_serving is not None
                                         and procs[0].poll() is None)
        if start_serving is not None and not out["member_serving_at_kill"]:
            raise RuntimeError(f"{member} ended before the kill")
        x = pod_object("shard-x", tpu=1)
        kube.store.upsert_pod(x)
        fres = router.handle("filter", {"Pod": x, "NodeNames": [node]})
        out["shard_x_while_dead"] = fres["NodeNames"]
        if fres["NodeNames"] or member_key in {k for k, _, _ in ledger()}:
            raise RuntimeError(f"while r{card_idx} is dead: shard-x feasible "
                               f"on {fres['NodeNames']}, the member in the "
                               f"federated ledger")
        t_restart = time.perf_counter()
        pods = pods_now()
        owned = router.replica_pods(card_idx, pods)
        node_annos = [(n, kube.store.get_node_annotations(n)) for n in nodes
                      if router._node_replica.get(n) == card_idx]
        restored = router.restart_replica(
            card_idx, node_annos,
            [annos for annos, _, _ in live_alloc_pods(owned)],
            pod_objects=owned)
        t_ready = time.perf_counter()
        fresh = router.replicas[card_idx].transport
        out["kill_to_respawn_ms"] = (t_restart - t_kill) * 1e3
        out["respawn_ready_ms"] = (t_ready - t_restart) * 1e3
        out["respawn_spawn_ready_ms"] = fresh.spawn_ready_s * 1e3
        out["respawned_pid"] = fresh.pid
        out["last_restart"] = dict(router.last_restart)
        after = ledger()
        view = types.SimpleNamespace(extender=router, pods=pods_now())
        out["leaked_reservations"] = len(leaked_reservations(view))
        out["ledger_divergence"] = len(ledger_divergence(view))
        out["state_equal_after_restart"] = after == before
        back = router.state.allocation(member_key)
        if (not out["last_restart"]["warm"] or restored < 1
                or after != before or back is None
                or back.device_ids != ["tpu-0"]
                or out["leaked_reservations"] or out["ledger_divergence"]
                or fresh.pid == victim.pid or victim._proc.poll() is None):
            raise RuntimeError(f"the respawn: {out['last_restart']}, state "
                               f"equal {after == before}, member {back}, "
                               f"{out['leaked_reservations']} leaked, "
                               f"{out['ledger_divergence']} diverged")
        out["health_check_dead"] = router.health_check()
        if out["health_check_dead"]:
            raise RuntimeError(f"health check after the respawn marked "
                               f"{out['health_check_dead']} dead")
        r1, r2 = resync(), resync()
        out["resync_after_restart"] = [r1, r2]
        rb = out["resync_before_kill"]
        if (r1["full"] != rb["full"] + 1 or r1["incremental"] != rb["incremental"]
                or r2["full"] != r1["full"]
                or r2["incremental"] != r1["incremental"] + 1):
            raise RuntimeError(f"resyncs around the respawn: {rb} -> {r1} "
                               f"-> {r2}")
        if start_serving is not None:
            proc = procs[0]
            report = None
            while True:
                line = lines.get(timeout=POD_TIMEOUT_S)
                if line is None:
                    break
                report = line
            if proc.wait() != 0 or report is None:
                raise RuntimeError(f"{member} exited {proc.returncode}")
            out["member_pod"] = json.loads(report)["pod"]
        # the router's pages over its listener, the gang still bound and
        # the respawned worker serving
        page = get("/metrics")
        errors = validate_exposition(page)
        samples = list(parse_metrics(page))
        names = {s.name for s in samples}
        binds_by = {s.label("replica") for s in samples
                    if s.name == "tpukube_binds_total"}
        out["metrics"] = {
            "errors": errors, "families": len(names),
            "binds_total_replicas": sorted(r for r in binds_by if r),
            "rtt_count": {s.label("replica"): s.value for s in samples
                          if s.name == "tpukube_replica_rtt_seconds_count"},
            "health_checks": {s.label("replica"): s.value for s in samples
                              if s.name == "tpukube_replica_health_checks_total"},
            "health_failures": {s.label("replica"): s.value for s in samples
                                if s.name
                                == "tpukube_replica_health_check_failures_total"},
        }
        if (errors or out["metrics"]["binds_total_replicas"] != ["r0", "r1"]
                or not {"tpukube_replica_rtt_seconds_count",
                        "tpukube_router_wire_bytes_total",
                        "tpukube_replica_up"} <= names):
            raise RuntimeError(f"the federated /metrics: {out['metrics']}")
        z = json.loads(get("/statusz"))
        out["statusz"] = {"sharded": z.get("sharded"),
                          "replicas": [(r["replica"], r["alive"])
                                       for r in z["replicas"]],
                          "wire_total": z["wire"]["total"],
                          "flights": len(z.get("flights") or []),
                          "transport_mode": z["transport"]["mode"]}
        if (not z.get("sharded") or z["wire"]["total"] <= 0 or not z.get("flights")
                or [r[1] for r in out["statusz"]["replicas"]] != [True, True]):
            raise RuntimeError(f"the router's /statusz: {out['statusz']}")
        # the gang ends unseen; one resync releases it, one release_many a
        # worker
        calls: list = []
        for rep in router.replicas:
            real = rep.transport.release_many

            def counted(keys, _real=real, _name=rep.name):
                calls.append((_name, sorted(keys)))
                return _real(keys)

            rep.transport.release_many = counted
        kube.store.end_unseen([f"default/{p['metadata']['name']}"
                               for p in members])
        resync()
        out["release_many"] = {name: len(keys) for name, keys in calls}
        if (out["release_many"] != {f"r{card_idx}": 1,
                                    f"r{1 - card_idx}": SHARD_GANG - 1}
                or len(calls) != 2
                or any(f"default/{n}" == k for n in binds for k, _, _ in ledger())):
            raise RuntimeError(f"the gang's releases: {calls}")
        host, xalloc = route_cycle(router, codec, x, [node])
        if host != node or xalloc.device_ids != ["tpu-0"]:
            raise RuntimeError(f"shard-x bound {xalloc.device_ids} on {host}")
        xenv = env_of("shard-x", xalloc)
        if run_solo is not None:
            out["shard_x_pod"] = run_solo(xenv)
        done = dict(kube.store.get_pod("default", "shard-x"))
        done["status"] = {"phase": "Succeeded"}
        kube.store.upsert_pod(done)
        wait_for("shard-x's release",
                 lambda: router.state.allocation("default/shard-x") is None)
        walls = []
        probe = pod_object("probe-r", tpu=1)
        for _ in range(SHARD_FILTER_ROUNDS):
            t = time.perf_counter()
            router.handle("filter", {"Pod": probe, "NodeNames": nodes})
            walls.append((time.perf_counter() - t) * 1e3)
        out["filter_ms_router"] = statistics.median(walls)
        rtts = {}
        for rep in router.replicas:
            w = sorted(rep.transport.rtt_snapshot())
            rtts[rep.name] = {"n": len(w), "p50_ms": w[len(w) // 2] * 1e3,
                              "p99_ms": w[min(len(w) - 1, int(0.99 * len(w)))] * 1e3}
        out["rtt"] = rtts
        out["health"] = {rep.name: [rep.transport.health_checks,
                                    rep.transport.health_failures]
                         for rep in router.replicas}
        out["wire"] = router.wire_totals()
        out["resync"] = loops.lifecycle.resync_stats()
        out["routes"] = dict(kube.requests)
    out["workers_alive_after"] = [t.pid for t in spawned if t._proc.poll() is None]
    if out["workers_alive_after"]:
        raise RuntimeError(f"workers alive after the router closed: "
                           f"{out['workers_alive_after']}")
    out["step_s"] = time.perf_counter() - t_step
    return out


def shard_proc_phase(card: str, c0, prov: dict, t_start: float):
    """Step 20 on the card machine: the parent's live threads and child
    processes, then 20a and 20b in a fresh interpreter
    (``shard_proc_child``), then ``shard_proc_life`` with the card's node
    agent, the member a Llama-3-8B B=1 pod of three requests and shard-x
    one of one (20c), and the ``shard_proc:`` line (20d). Every check
    fails through ``fail("shard_proc 20x: ...")``; no worker it spawned
    may be alive at its end. ``prov`` is step 18's line. Returns the
    line's object, or None when a check failed."""
    t_step = time.perf_counter()
    host = host_cpu()
    threads = threading.active_count()
    children = live_children()
    print(f"shard_proc: before the drive child, {threads} live threads in "
          f"this process and {len(children)} live child processes "
          f"{[c[1][:80] for c in children]}", flush=True)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.shard_proc_child())"],
        cwd=ROOT, env=pod_env({}), stdout=subprocess.PIPE, text=True,
        timeout=SHARD_MP_CHILD_S)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0 or not lines:
        print(proc.stdout, flush=True)
        fail(f"shard_proc 20a/20b: the drive child exited {proc.returncode} "
             f"(its stderr above names the gate)")
        return None
    drives = json.loads(lines[-1])

    def start_serving(env):
        return subprocess.Popen(
            [sys.executable, "-m", "tpukube_torch.graft", "--requests", "3",
             "--batch", "1"],
            cwd=ROOT, env=pod_env(env), stdout=subprocess.PIPE, text=True)

    def run_solo(env):
        r = run_pod(["--requests", "1", "--batch", "1"], env, "pod")
        if r is None or r["uuid"] != c0.chip_id or r["batch"] != 1:
            raise RuntimeError(f"shard-x's pod failed: {r}")
        return r

    try:
        life = shard_proc_life(lambda: node_agent({}), start_serving=start_serving,
                               run_solo=run_solo)
    except Exception as e:  # noqa: BLE001 (every failure fails the step)
        import traceback

        traceback.print_exc()
        fail(f"shard_proc 20c: {type(e).__name__}: {e}")
        return None
    member = life.pop("member_pod")
    if member["uuid"] != c0.chip_id or member["batch"] != 1:
        fail(f"shard_proc 20c: the card member's pod: {member}")
        return None
    print(f"{life['member']}: " + json.dumps(member, sort_keys=True), flush=True)
    print("shard-x: " + json.dumps(life.pop("shard_x_pod"), sort_keys=True),
          flush=True)
    left = [c for c in live_children() if "shard-worker" in c[1]]
    if left:
        fail(f"shard_proc 20c: worker daemons left alive: {left}")
        return None
    a, b = drives["20a"], drives["20b"]
    tr = a["transport"]
    line = {"card": card, "host": host, "sweep": a, **life, "wire_codec": b,
            "member_forward_ms": member["forward_ms_median"],
            "member_tokens_per_s": member["tokens_per_s"],
            "why0_forward_ms": prov["why0_pod"]["forward_ms_median"],
            "parent_threads": threads, "parent_children": len(children),
            "step20c_s": life["step_s"], "step_s": time.perf_counter() - t_step,
            "run_s": time.monotonic() - t_start}
    by_op = {op: c["tx"] + c["rx"] for op, c in sorted(
        life["wire"]["by_op"].items(), key=lambda kv: -(kv[1]["tx"] + kv[1]["rx"]))}
    print(
        f"shard_proc: spawn -> ready {json.dumps({k: round(v, 3) for k, v in life['spawn_ready_ms'].items()})} ms, "
        f"respawn {life['respawn_spawn_ready_ms']:.3f} ms; replica RTT p50/p99 "
        f"{json.dumps({k: [round(v['p50_ms'], 3), round(v['p99_ms'], 3)] for k, v in life['rtt'].items()})} ms "
        f"(20a N=2: {json.dumps({r['replica']: [r.get('rtt_p50_ms'), r.get('rtt_p99_ms')] for r in tr['replicas']})}); "
        f"wire bytes by op {json.dumps(dict(list(by_op.items())[:6]))}; bytes/wave json "
        f"{b['json_bytes_per_wave']} / binary {b['binary_bytes_per_wave']} = "
        f"{b['bytes_per_wave_ratio']:.4f} (floor {b['bytes_per_wave_ratio_min']}), "
        f"micro ratio {b['micro']['ratio']:.4f} (floor {b['micro_ratio_min']}), "
        f"encode {b['micro']['encode_us']:.1f} / decode {b['micro']['decode_us']:.1f} us "
        f"(ceilings {b['encode_us_max']:.0f} / {b['decode_us_max']:.0f}); health checks "
        f"and failures {json.dumps(life['health'])}; N=1 {a['n1_pods_per_sec']} and N=2 "
        f"{a['n2_pods_per_sec']} pods/s, medians of {json.dumps(a['pods_per_sec_by_run'])} "
        f"(floor {a['pods_per_sec_min']}), efficiency "
        f"{a['parallel_efficiency']:.4f} (floor {a['parallel_efficiency_min']}, "
        f"{'gated' if a['efficiency_gated'] else 'not gated'} on {a['cores']['cores']} "
        f"schedulable cores: affinity {a['cores']['affinity']}, quota "
        f"{a['cores']['quota']}); kill -> respawn {life['kill_to_respawn_ms']:.3f} "
        f"ms -> ready {life['respawn_ready_ms']:.3f} ms ({life['last_restart']['restored']} "
        f"allocations restored warm); {life['member']} Llama-3-8B B=1 S=2048 "
        f"{member['forward_ms_median']:.3f} ms (step 18's why-0: "
        f"{prov['why0_pod']['forward_ms_median']:.3f} ms); parent {threads} threads, "
        f"{len(children)} children; step {line['step_s']:.1f} s, run so far "
        f"{line['run_s']:.1f} s [host CPU times; {host}; {card}]",
        flush=True,
    )
    return line


# -- the lint prover and the lock-order monitor (step 21) ---------------------

# the seeded tree's sched/gang.py: the reference's lock-discipline fixture,
# three blocking calls under the scheduling locks
LINT_SEEDED_GANG = """\
import time

class GangManager:
    def bad_write(self):
        with self._lock:
            self._sink_file.write("line")

    def bad_sleep(self):
        with self._decision_lock:
            time.sleep(0.1)

    def bad_open(self):
        with self._pending_lock:
            with open("/tmp/x", "w") as f:
                pass
"""
# ... and its rules file, reading a series no registry renders
LINT_SEEDED_RULES = (
    "apiVersion: monitoring.coreos.com/v1\n"
    "kind: PrometheusRule\n"
    "spec:\n"
    "  groups:\n"
    "    - name: g\n"
    "      rules:\n"
    "        - record: r\n"
    "          expr: rate(tpukube_nonexistent_total[5m])\n"
)
LINT_SEEDED_WANT = {"lock-discipline": 3, "name-consistency": 1}
LINT_CWDS = (ROOT, ROOT, "/")  # the clean CLI runs, each a fresh process
LINT_CLI_S = 300  # one CLI run's time limit
ANALYSIS_CHILD_S = 600  # the step's child's time limit
# step 21c: step 20's 1,024-node fleet (4 slices of 8x8x16, host block
# 2,2,1) behind two worker daemons, router and workers under the monitor
LOCKGRAPH_ENV = {"TPUKUBE_SIM_MESH_DIMS": "8,8,16", "TPUKUBE_SIM_HOST_BLOCK": "2,2,1",
                 "TPUKUBE_BATCH_ENABLED": "1", "TPUKUBE_BATCH_MAX_PODS": "2048",
                 "TPUKUBE_PLANNER_REPLICAS": "2",
                 "TPUKUBE_SHARD_TRANSPORT": "subprocess",
                 "TPUKUBE_LOCK_MONITOR": "1"}
LOCKGRAPH_PODS = 384  # placed from batch plans before the card pod


def lint_cli(args: list, cwd: str) -> tuple:
    """``python -m tpukube_torch.analysis *args`` as a fresh process from
    ``cwd``: (exit code, stdout and stderr, wall seconds)."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "tpukube_torch.analysis", *args], cwd=cwd,
        env=pod_env({}), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=LINT_CLI_S)
    return proc.returncode, proc.stdout, time.perf_counter() - t


def lint_static() -> dict:
    """Step 21a: the lint prover over the port's tree, three times as a
    fresh process (two from the checkout, one from ``/``), each exit 0
    and ``tpukube-lint: clean``, the median wall within
    tools/perf_floor.json's ``lint_wall_s_floor`` x ``allowed_regression``;
    ``--list-rules`` names the 13 rules; a seeded tree (the
    lock-discipline fixture as ``sched/gang.py``, a rules file reading
    ``tpukube_nonexistent_total``) exits 1 with exactly those findings;
    ``--rules made-up-rule`` exits 2; the rules-file cross-check reads
    deploy/prometheus-rules.yaml's expressions; an in-process ``run_all``
    is clean. Raises RuntimeError naming the failed check."""
    import tempfile

    from tpukube_torch.analysis import base
    from tpukube_torch.analysis.consistency import rule_expressions

    tree = os.path.join(ROOT, "tpukube_torch")
    walls = []
    for cwd in LINT_CWDS:
        rc, out, wall = lint_cli([tree], cwd)
        if rc != 0 or out.strip().splitlines()[-1:] != ["tpukube-lint: clean"]:
            raise RuntimeError(f"the clean run from {cwd} exited {rc}: "
                               f"{out[-3000:]!r}")
        walls.append(wall)
    rc, out, _ = lint_cli(["--list-rules"], ROOT)
    listed = [ln.split()[0] for ln in out.splitlines() if ln.strip()]
    if rc != 0 or listed != list(base.ALL_RULES) or len(listed) != 13:
        raise RuntimeError(f"--list-rules exited {rc}: {out!r}")
    with tempfile.TemporaryDirectory() as td:
        os.makedirs(os.path.join(td, "sched"))
        with open(os.path.join(td, "sched", "gang.py"), "w") as f:
            f.write(LINT_SEEDED_GANG)
        rules = os.path.join(td, "rules.yaml")
        with open(rules, "w") as f:
            f.write(LINT_SEEDED_RULES)
        rc, out, seeded_s = lint_cli(["--json", "--rules-file", rules, td], ROOT)
    seeded: dict = {}
    for ln in out.splitlines():
        if ln.startswith("{"):
            rule = json.loads(ln)["rule"]
            seeded[rule] = seeded.get(rule, 0) + 1
    if rc != 1 or seeded != LINT_SEEDED_WANT:
        raise RuntimeError(f"the seeded tree exited {rc} with {seeded}, want "
                           f"exit 1 with {LINT_SEEDED_WANT}: {out[-3000:]!r}")
    rc, out, _ = lint_cli(["--rules", "made-up-rule", tree], ROOT)
    if rc != 2:
        raise RuntimeError(f"--rules made-up-rule exited {rc}, want 2: {out!r}")
    exprs = rule_expressions(os.path.join(ROOT, "deploy", "prometheus-rules.yaml"))
    if not exprs:
        raise RuntimeError("the rules-file cross-check read no expression")
    sources, errors = base.iter_source_files([tree])
    t = time.perf_counter()
    findings = base.run_all([tree])
    inproc_s = time.perf_counter() - t
    if findings or errors:
        raise RuntimeError(f"in-process run_all: {[str(f) for f in findings + errors]}")
    with open(os.path.join(ROOT, "tools", "perf_floor.json")) as f:
        floor = json.load(f)
    limit = floor["lint_wall_s_floor"] * floor["allowed_regression"]
    median = statistics.median(walls)
    if median > limit:
        raise RuntimeError(f"median lint wall {median:.3f} s over the gate "
                           f"{limit:.3f} s (walls {walls})")
    return {"walls_s": walls, "median_s": median, "gate_s": limit,
            "lint_wall_s_floor": floor["lint_wall_s_floor"],
            "allowed_regression": floor["allowed_regression"],
            "inprocess_s": inproc_s, "files": len(sources),
            "lines": sum(sf.text.count("\n") for sf in sources),
            "rules": len(base.ALL_RULES), "findings": 0,
            "rule_expressions": len(exprs), "seeded": seeded,
            "seeded_s": seeded_s}


def lint_dynamic() -> dict:
    """Step 21b: scenarios 1-7 of the port with the lock-order monitor
    off, under ``lockgraph.monitor()``, and off again: no cycle, more than
    1,000 acquisitions, the extender -> gang and gang -> state edges of
    the declared order, and the threading factories restored after.
    Returns the report's counts and the walls (the first run pays the
    imports; the monitor's cost is its run against the second off run);
    raises RuntimeError naming the failed check."""
    from tpukube_torch.analysis import lockgraph
    from tpukube_torch.sim import scenarios

    def drive() -> float:
        t = time.perf_counter()
        for i in range(1, 8):
            scenarios.run(i, None)
        return time.perf_counter() - t

    cold_s = drive()
    with lockgraph.monitor() as mon:
        on_s = drive()
    off_s = drive()
    rep = mon.report()
    edges = {(e["from"].rsplit(":", 1)[0], e["to"].rsplit(":", 1)[0])
             for e in rep["edges"]}
    want = {("tpukube_torch/sched/extender.py", "tpukube_torch/sched/gang.py"),
            ("tpukube_torch/sched/gang.py", "tpukube_torch/sched/state.py")}
    if rep["cycles"] or rep["acquisitions"] <= 1000 or not want <= edges:
        raise RuntimeError(f"scenarios 1-7 under the monitor: cycles "
                           f"{rep['cycles']}, {rep['acquisitions']} acquisitions, "
                           f"missing edges {sorted(want - edges)}")
    if threading.Lock is not lockgraph._REAL_LOCK \
            or threading.RLock is not lockgraph._REAL_RLOCK:
        raise RuntimeError("the threading factories were not restored")
    return {"acquisitions": rep["acquisitions"], "edges": len(rep["edges"]),
            "sites": len(rep["sites"]), "cycles": rep["cycles"],
            "monitor_off_first_s": cold_s, "monitor_off_s": off_s,
            "monitor_on_s": on_s}


def lockgraph_life(card_agent, run_solo) -> dict:
    """Step 21c: ``LOCKGRAPH_ENV``'s fleet in a ``SimCluster`` over a
    ``ShardRouter`` of two ``shard-worker`` daemons, the config (the one
    the router and, through their per-replica files, both workers read)
    turning the lock-order monitor on; ``LOCKGRAPH_PODS`` pods placed
    from batch plans; then this machine's Node, annotated by
    ``card_agent()``'s node agent, ingested by the router, and a
    one-GPU pod bound to tpu-0 through the router's webhooks, its env
    the plugin's Allocate, run by ``run_solo(env)``. The router's
    ``lockgraph_report()`` and its listener's ``GET /lockgraph`` must
    each show both workers reporting, no cycle and acquisitions. No
    worker may outlive the cluster. Returns the counts and host-clock
    times; raises RuntimeError naming the failed check."""
    from tpukube_torch.analysis import lockgraph
    from tpukube_torch.core import codec
    from tpukube_torch.core.config import load_config
    from tpukube_torch.sched.extender import run_server
    from tpukube_torch.sched.kube import pod_object
    from tpukube_torch.sched.shardworker import make_router_app
    from tpukube_torch.sim import SimCluster

    cfg = load_config(env=LOCKGRAPH_ENV)
    out: dict = {}
    t = time.perf_counter()
    with SimCluster(cfg, slices=_shard_mp_slices(cfg), in_process=True) as c, \
            contextlib.ExitStack() as stack:
        router = c.extender
        if c.lock_monitor is None or lockgraph.active() is not c.lock_monitor:
            raise RuntimeError("lock_monitor did not install the monitor")
        out["spawn_ready_ms"] = {f"r{tr.index}": tr.spawn_ready_s * 1e3
                                 for tr in router.spawned}
        out["nodes"] = len(c.nodes)
        t_place = time.perf_counter()
        placed = c.schedule_pending([c.make_pod(f"lg-{i}", tpu=1)
                                     for i in range(LOCKGRAPH_PODS)])
        out["placed"] = len(placed)
        out["place_ms"] = (time.perf_counter() - t_place) * 1e3
        if len(placed) != LOCKGRAPH_PODS:
            raise RuntimeError(f"{len(placed)} of {LOCKGRAPH_PODS} pods placed")
        agent = stack.enter_context(card_agent())
        node = agent.mgr.host
        res = router.upsert_nodes_many([{
            "name": node,
            "annotations": codec.annotate_node(agent.mgr.node_info(),
                                               agent.mgr.mesh)}])
        if isinstance(res[0], dict) and res[0].get("error"):
            raise RuntimeError(f"the router refused {node}: {res[0]['error']}")
        host, alloc = route_cycle(router, codec, pod_object("lockgraph-0", tpu=1),
                                  [node])
        if host != node or alloc.device_ids != ["tpu-0"]:
            raise RuntimeError(f"lockgraph-0 bound {alloc.device_ids} on {host}")
        out["card_replica"] = f"r{router._node_replica[node]}"
        out["member_pod"] = run_solo(allocate(agent, alloc))
        server = run_server(make_router_app(router), "127.0.0.1", 0)
        stack.callback(server.server_close)
        stack.callback(server.shutdown)
        rep = router.lockgraph_report()
        url = f"http://127.0.0.1:{server.server_address[1]}/lockgraph"
        with urllib.request.urlopen(url, timeout=REST_WAIT_S) as r:
            http = json.loads(r.read())
        for what, doc in (("lockgraph_report()", rep), ("GET /lockgraph", http)):
            if (doc is None or doc["replicas_reporting"] != ["r0", "r1"]
                    or doc["cycles"] or doc["acquisitions"] <= 0):
                raise RuntimeError(f"{what}: " + json.dumps(
                    doc and {k: doc[k] for k in ("replicas_reporting", "cycles",
                                                 "acquisitions")}))
        out["report"] = {"replicas_reporting": rep["replicas_reporting"],
                         "acquisitions": rep["acquisitions"],
                         "edges": len(rep["edges"]), "sites": len(rep["sites"]),
                         "cycles": rep["cycles"],
                         "http_acquisitions": http["acquisitions"]}
    left = [ch for ch in live_children() if "shard-worker" in ch[1]]
    if left:
        raise RuntimeError(f"worker daemons left alive: {left}")
    if threading.Lock is not lockgraph._REAL_LOCK:
        raise RuntimeError("the cluster's stop did not restore threading.Lock")
    out["step_s"] = time.perf_counter() - t
    return out


def analysis_child() -> int:
    """Step 21 in this (fresh) interpreter: 21a ``lint_static``, 21b
    ``lint_dynamic``, 21c ``lockgraph_life`` with the card's node agent
    and a Llama-3-8B pod (B=1, S=2048, one request); prints the results
    as one JSON line, last. A failed check prints ``analysis 21x: ...``
    on stderr and returns 1; so does a YAML, aiohttp, gRPC or protobuf
    module loaded here."""
    with node_agent({}) as agent:
        chip_id = agent.mgr.chips()[0].chip_id

    def run_solo(env):
        r = run_pod(["--requests", "1", "--batch", "1"], env, "pod")
        if r is None or r["uuid"] != chip_id or r["batch"] != 1:
            raise RuntimeError(f"lockgraph-0's pod failed: {r}")
        return r

    out: dict = {}
    for tag, fn in (("21a", lint_static), ("21b", lint_dynamic),
                    ("21c", lambda: lockgraph_life(lambda: node_agent({}),
                                                   run_solo))):
        t = time.perf_counter()
        try:
            out[tag] = fn()
        except Exception as e:  # noqa: BLE001 (every failure fails the step)
            import traceback

            traceback.print_exc()
            return fail(f"analysis {tag}: {type(e).__name__}: {e}")
        out[tag].setdefault("step_s", time.perf_counter() - t)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("grpc", "yaml", "aiohttp")
                    or m.startswith("google.protobuf"))
    if loaded:
        return fail(f"analysis 21: the step imported {loaded}")
    print(json.dumps(out), flush=True)
    return 0


def analysis_phase(card: str, t_start: float):
    """Step 21 on the card machine: ``analysis_child`` in a fresh
    interpreter, then the ``lint:`` line (21d). Returns the line's
    object, or None when a check failed (the child's stderr names it
    as ``analysis 21x: ...``; its stdout is quoted here)."""
    t_step = time.perf_counter()
    host = host_cpu()
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.analysis_child())"],
        cwd=ROOT, env=pod_env({}), stdout=subprocess.PIPE, text=True,
        timeout=ANALYSIS_CHILD_S)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    if proc.returncode != 0 or not lines:
        print(proc.stdout, flush=True)
        fail(f"analysis 21: the child exited {proc.returncode} (its stderr "
             f"above names the check: analysis 21a/21b/21c)")
        return None
    r = json.loads(lines[-1])
    a, b, c = r["21a"], r["21b"], r["21c"]
    member = c.pop("member_pod")
    print("lockgraph-0: " + json.dumps(member, sort_keys=True), flush=True)
    line = {"card": card, "host": host, "static": a, "dynamic": b,
            "federated": c, "member_forward_ms": member["forward_ms_median"],
            "member_tokens_per_s": member["tokens_per_s"],
            "step_s": time.perf_counter() - t_step,
            "run_s": time.monotonic() - t_start}
    print(
        f"lint: clean runs {', '.join(f'{w:.3f}' for w in a['walls_s'])} s "
        f"(cwd {', '.join(LINT_CWDS)}), median {a['median_s']:.3f} s, gate "
        f"{a['gate_s']:.3f} s (lint_wall_s_floor {a['lint_wall_s_floor']} x "
        f"{a['allowed_regression']}), in-process run_all {a['inprocess_s']:.3f} s; "
        f"{a['files']} files, {a['lines']} lines, {a['rules']} rules, "
        f"{a['findings']} findings; {a['rule_expressions']} rule expressions "
        f"read from deploy/prometheus-rules.yaml; seeded tree "
        f"{json.dumps(a['seeded'], sort_keys=True)}; scenarios 1-7 under the "
        f"monitor: {b['acquisitions']} acquisitions, {b['edges']} edges, "
        f"{b['sites']} sites, cycles {b['cycles']}, {b['monitor_on_s']:.3f} s "
        f"on vs {b['monitor_off_s']:.3f} s off (the first run, off: "
        f"{b['monitor_off_first_s']:.3f} s); federated over 2 workers at "
        f"{c['nodes']} nodes + this node ({c['placed']} pods placed): replicas "
        f"{c['report']['replicas_reporting']}, {c['report']['acquisitions']} "
        f"acquisitions, {c['report']['edges']} edges, cycles "
        f"{c['report']['cycles']}; lockgraph-0 on {c['card_replica']} Llama-3-8B "
        f"B=1 S=2048 {member['forward_ms_median']:.3f} ms; step "
        f"{line['step_s']:.1f} s, run so far {line['run_s']:.1f} s "
        f"[host CPU times; {host}; {card}]",
        flush=True,
    )
    return line


# Step 23: the GroupNorm kernel pair (tpukube_torch/kernels/group_norm.py)
# against its plain version at the ResNet cell's batch; (channels, side,
# the cell's ReLU) of stage 1's first norm, stage 1's last, stage 3's last
# and stage 4's last
KERNEL_BATCH = 64
KERNEL_ITERS = 20
KERNEL_SHAPES = [(64, 224, True), (256, 224, False), (1024, 56, False), (2048, 28, False)]
HBM_BYTES_PER_S = 3.35e12  # NVIDIA data sheet, H100 SXM
# the bytes an element each kernel must move, bf16: stats reads x; apply
# reads x and writes y; grad_reduce reads x and dy; grad_apply reads x and
# dy and writes dx
KERNEL_BYTES = {"group_norm_stats": 2, "group_norm_apply": 4,
                "group_norm_grad_reduce": 4, "group_norm_grad_apply": 6}


def norm_inputs(c: int, side: int, device, seed: int, batch: int = KERNEL_BATCH,
                dtype=None) -> tuple:
    """``channels_last`` x and dy of (batch, c, side, side) in ``dtype``
    (bf16 by default), float32 scale and bias; each channel's values
    offset, so that the groups' means lie off zero."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    shape, dtype = (batch, c, side, side), dtype or torch.bfloat16
    x = torch.randn(shape, generator=g, device=device).mul_(2.0)
    x = x.add_(torch.randn((1, c, 1, 1), generator=g, device=device)).to(dtype)
    dy = torch.randn(shape, generator=g, device=device).to(dtype)
    scale = 1.0 + 0.5 * torch.randn((c,), generator=g, device=device)
    bias = 0.5 * torch.randn((c,), generator=g, device=device)
    return (x.contiguous(memory_format=torch.channels_last), scale, bias,
            dy.contiguous(memory_format=torch.channels_last))


def norm_grads(fn, x, scale, bias, dy, relu: bool) -> tuple:
    """``fn``'s output and its gradients for x, scale and bias, given dy."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
    y = fn(*leaves, 32, relu=relu)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


def norm_excess(got, want, keep, extra=0.0) -> float:
    """The largest excess, over ``keep``, of |got - want| past one ulp of
    the dtype at the larger of the two, plus 2**-18 of max|want|, plus
    ``extra``. At most 0 passes."""
    import torch

    mant = {torch.bfloat16: 7, torch.float32: 23}[got.dtype]

    def ulp(t):
        a = t.float().abs().clamp_min(torch.finfo(t.dtype).tiny)
        return torch.exp2(torch.floor(torch.log2(a)) - mant)

    bound = torch.maximum(ulp(got), ulp(want)) + want.float().abs().max() * 2.0 ** -18 + extra
    return float(((got.float() - want.float()).abs() - bound)[keep].max())


def norm_check(c: int, side: int, relu: bool, device, batch: int = KERNEL_BATCH,
               dtype=None) -> dict:
    """The pair against its plain version on the card, forward and
    backward, at (batch, c, side, side) in ``dtype`` (bf16 by default).
    The two round their float32 statistics and sums in other orders
    (about 2**-24 relative each), and a cast then lands on neighbouring
    values, so:

    - y and dx: within one ulp of the dtype at the larger of the two,
      plus 2**-18 of the largest magnitude (``norm_excess``);
    - dscale and dbias: within 2**-18 of the sum of their terms'
      magnitudes (g and g * xhat), channel by channel: a tree sum's error
      over N*H*W terms is about log2(N*H*W) * 2**-24 of that;
    - with the ReLU, the edge: elements whose float32 pre-activation lies
      within 2**-20 of its largest magnitude of zero may fall on either
      side of the mask in the two versions. They are left out of the
      elementwise comparisons, and what they can move is added to the
      bounds: their terms, unmasked, to dscale's and dbias's; to each dx
      of their (sample, group), rstd * (E1 + |xhat| * E2), where E1 and E2
      are the edge's sums of |dy * scale| and |dy * scale * xhat| over the
      group's M elements, divided by M: the most they move the group's
      two sums in dx.

    Returns each number's largest excess past its bound (at most 0), the
    edge's size and the launches; raises past a bound, or unless the
    pair launched four kernels and gave ``channels_last`` y and dx."""
    import torch
    import torch.nn.functional as F

    from tpukube_torch.kernels import group_norm as gn

    x, scale, bias, dy = norm_inputs(c, side, device, c + side, batch, dtype)
    before = gn.GroupNormNHWC.launches
    y, dx, dscale, dbias = norm_grads(gn.group_norm, x, scale, bias, dy, relu)
    launches = gn.GroupNormNHWC.launches - before
    py, pdx, pdscale, pdbias = norm_grads(gn.group_norm_plain, x, scale, bias, dy, relu)
    if not (y.is_contiguous(memory_format=torch.channels_last)
            and dx.is_contiguous(memory_format=torch.channels_last)
            and y.dtype == dx.dtype == x.dtype):
        raise RuntimeError(f"the pair's y or dx is not {x.dtype} channels_last")
    pre = F.group_norm(x.float(), 32, scale, bias, 1e-5)
    edge = pre.abs() <= 2.0 ** -20 * pre.abs().max() if relu else torch.zeros_like(pre, dtype=torch.bool)
    del pre
    keep = ~edge
    out = {"y": norm_excess(y, py, keep)}
    del y
    v = x.float().reshape(batch, 32, -1)
    rstd = torch.rsqrt(v.var(-1, unbiased=False, keepdim=True) + 1e-5)
    xhat = ((v - v.mean(-1, keepdim=True)) * rstd).reshape(x.shape)
    del v
    g = dy.float()
    moved = 0.0
    if relu:
        share = (g * scale[:, None, None]).abs() * edge
        e1 = share.reshape(batch, 32, -1).sum(-1, keepdim=True) / (share[0].numel() // 32)
        e2 = (share * xhat.abs()).reshape(batch, 32, -1).sum(-1, keepdim=True)
        e2 = e2 / (share[0].numel() // 32)
        del share
        moved = (rstd * (e1 + xhat.abs().reshape(batch, 32, -1) * e2)).reshape(x.shape)
    out["dx"] = norm_excess(dx, pdx, keep, moved)
    del dx, pdx, moved
    masked = g * (py > 0) if relu else g
    for name, got, want, terms, unmasked in (("dbias", dbias, pdbias, masked, g),
                                             ("dscale", dscale, pdscale, masked * xhat, g * xhat)):
        bound = (terms.abs().sum((0, 2, 3)).double() * 2.0 ** -18
                 + (unmasked.abs() * edge).sum((0, 2, 3)).double())
        out[name] = float(((got.double() - want.double()).abs() - bound).max())
    bad = {k: v for k, v in out.items() if not v <= 0}
    out.update(edge=int(edge.sum()), launches=launches)
    if bad or launches != 4:
        raise RuntimeError(f"C={c} {side}x{side} relu={relu}: past the bound by {bad}, "
                           f"{launches} launches (4)")
    return out


def norm_times(c: int, side: int, relu: bool, device) -> dict:
    """Times at (KERNEL_BATCH, c, side, side), over KERNEL_ITERS calls
    after a warm-up on an idle card: each direction of the pair and of
    the plain version by CUDA events (the backward alone, its forward
    run before each call), each kernel's device time a launch by
    ``torch.profiler``, and the byte bounds at HBM_BYTES_PER_S."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpukube_torch.kernels import group_norm as gn

    x, scale, bias, dy = norm_inputs(c, side, device, seed=c + side)
    leaves = [x.requires_grad_(True), scale.requires_grad_(True), bias.requires_grad_(True)]
    elems = x.numel()

    def forward_ms(fn) -> float:
        with torch.no_grad():
            fn(x, scale, bias, 32, relu=relu)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(KERNEL_ITERS):
                fn(x, scale, bias, 32, relu=relu)
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) / KERNEL_ITERS

    def backward_ms(fn) -> float:
        total = 0.0
        for i in range(KERNEL_ITERS + 1):
            y = fn(x, scale, bias, 32, relu=relu)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            torch.autograd.grad(y, leaves, dy)
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end) if i else 0.0
        return total / KERNEL_ITERS

    out = {"forward_ms": forward_ms(gn.group_norm), "backward_ms": backward_ms(gn.group_norm),
           "plain_forward_ms": forward_ms(gn.group_norm_plain),
           "plain_backward_ms": backward_ms(gn.group_norm_plain),
           "forward_bound_ms": 4 * elems / HBM_BYTES_PER_S * 1e3,
           "backward_bound_ms": 6 * elems / HBM_BYTES_PER_S * 1e3, "kernels": {}}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(KERNEL_ITERS):
            torch.autograd.grad(gn.group_norm(x, scale, bias, 32, relu=relu), leaves, dy)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        name = next((k for k in KERNEL_BYTES if e.key.startswith(k)), None)
        if name and e.count:
            ms = e.device_time_total / e.count / 1e3
            bound = KERNEL_BYTES[name] * elems / HBM_BYTES_PER_S * 1e3
            out["kernels"][name] = {"ms": ms, "bound_ms": bound, "roofline_pct": 100 * bound / ms}
    if set(out["kernels"]) != set(KERNEL_BYTES):
        raise RuntimeError(f"the profiler saw {sorted(out['kernels'])}, not the four kernels")
    return out


def kernels_child() -> int:
    """Step 23 in this (fresh) interpreter on the card: at each of
    KERNEL_SHAPES, ``norm_check`` with the ReLU on and off, then
    ``norm_times`` with the cell's ReLU; prints the results as one JSON
    line, last. A failed check prints ``kernels 23: ...`` on stderr and
    returns 1."""
    import torch

    device = torch.device("cuda", 0)
    out = []
    for c, side, relu in KERNEL_SHAPES:
        try:
            checks = {str(r).lower(): norm_check(c, side, r, device) for r in (True, False)}
            torch.cuda.empty_cache()
            times = norm_times(c, side, relu, device)
        except Exception as e:  # noqa: BLE001 (every failure fails the step)
            import traceback

            traceback.print_exc()
            return fail(f"kernels 23: {type(e).__name__}: {e}")
        torch.cuda.empty_cache()
        out.append({"shape": [KERNEL_BATCH, c, side, side], "relu": relu,
                    "checks": checks, **times})
    print(json.dumps(out), flush=True)
    return 0


def kernels_phase(card: str, env: dict):
    """Step 23: ``kernels_child`` in a fresh interpreter on the allocated
    card (``env``), a line a shape, then the ``kernels`` line: each
    kernel's device time a launch, its byte bound and the plain version's
    time for the kernel's direction. Returns the line's object, or None
    when a check failed."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.kernels_child())"],
        cwd=ROOT, env=pod_env(env), stdout=subprocess.PIPE, text=True, timeout=POD_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(proc.stdout, flush=True)
        fail(f"kernels 23: the child exited {proc.returncode} (its stderr above names the check)")
        return None
    rows = []
    for r in json.loads(lines[-1]):
        n, c, h, w = r["shape"]
        print(
            f"group_norm bf16 ({n}, {c}, {h}, {w}), ReLU {r['relu']}: forward "
            f"{r['forward_ms']:.3f} ms (bytes' bound {r['forward_bound_ms']:.3f}, plain "
            f"{r['plain_forward_ms']:.3f}), backward {r['backward_ms']:.3f} ms (bound "
            f"{r['backward_bound_ms']:.3f}, plain {r['plain_backward_ms']:.3f}); "
            + ", ".join(f"{k} {v['ms']:.4f} ms / {v['bound_ms']:.4f} ({v['roofline_pct']:.1f}%)"
                        for k, v in r["kernels"].items())
            + "; checks, ReLU on / off, largest excess past the bound (<= 0): "
            + "; ".join(f"{k} " + json.dumps(v, sort_keys=True) for k, v in r["checks"].items())
            + f" [{card}]",
            flush=True,
        )
        for name, k in r["kernels"].items():
            forward = name in ("group_norm_stats", "group_norm_apply")
            rows.append({"name": name, "shape": r["shape"], "relu": r["relu"],
                         "ms": k["ms"], "bound_ms": k["bound_ms"],
                         "roofline_pct": k["roofline_pct"],
                         "plain_ms": r["plain_forward_ms" if forward else "plain_backward_ms"]})
    return {"kernels": rows, "card": card}


# Step 24: the causal attention kernel (tpukube_torch/kernels/attention.py)
# against its plain version and an f32 computation of the same function:
# (query heads, kv heads, dq, dv). Step 24 checks and times the two
# decoders' shapes (ATTENTION_TIMED); the card tests also check two narrow
# ones, whose head dims fill part of a 128-byte row of shared memory.
ATTENTION_SHAPES = {"mistral": (32, 8, 128, 128), "moonlight": (16, 16, 192, 128),
                    "narrow": (8, 4, 24, 16), "dv40": (12, 4, 96, 40)}
ATTENTION_TIMED = ("mistral", "moonlight")
ATTENTION_LENGTHS = (256, 1385, 4096)
ATTENTION_ITERS = 20
# the kernel's errors may be this many times the chain's, plus a floor: of
# the largest output magnitude for the largest error, of a row's largest
# magnitude for a row's (attention_check says why)
ATTENTION_RATIO = 1.25
ATTENTION_FLOOR = 2.0 ** -9
ATTENTION_ROW_FLOOR = 2.0 ** -8


def attention_inputs(shape: str, seq: int, device, seed: int) -> tuple:
    """bf16 q (1, S, H, dq), k (1, S, KV, dq) and v (1, S, KV, dv) at
    ``shape`` (ATTENTION_SHAPES), made from ``seed``. Outside Mistral-7B's
    shape v is a strided slice of a wider tensor, as Moonlight's forward
    makes it (the latter half of each head's values of ``kv``). Scores
    spread about 1.5 (q scaled), so the softmax is neither flat nor
    one-hot."""
    import torch

    H, KV, dq, dv = ATTENTION_SHAPES[shape]
    g = torch.Generator(device=device).manual_seed(seed)
    q = (1.5 * torch.randn((1, seq, H, dq), generator=g, device=device)).to(torch.bfloat16)
    k = torch.randn((1, seq, KV, dq), generator=g, device=device).to(torch.bfloat16)
    if shape != "mistral":
        kv = torch.randn((1, seq, KV, 128 + dv), generator=g, device=device).to(torch.bfloat16)
        v = kv[..., 128:]
    else:
        v = torch.randn((1, seq, KV, dv), generator=g, device=device).to(torch.bfloat16)
    return q, k, v


def attention_f32(q, k, v):
    """The same function as the chain, every step in float32 from the bf16
    inputs: the yardstick both are held to."""
    import torch

    B, S, H, dq = q.shape
    KV, dv = k.shape[2], v.shape[3]
    qf = q.float().reshape(B, S, KV, H // KV, dq)
    out = torch.empty((B, S, H * dv), device=q.device, dtype=torch.float32)
    for j in range(KV):  # one kv head at a time: S x S f32 scores per group
        logits = torch.einsum("bsgd,btd->bgst", qf[:, :, j], k[:, :, j].float()) * dq ** -0.5
        logits = logits.masked_fill(~torch.ones((S, S), dtype=torch.bool,
                                                device=q.device).tril(), float("-inf"))
        o = torch.einsum("bgst,btd->bsgd", torch.softmax(logits, dim=-1), v[:, :, j].float())
        g = H // KV
        out.view(B, S, H, dv)[:, :, j * g:(j + 1) * g] = o
    return out


def attention_check(shape: str, seq: int, device, seed: int = 0) -> dict:
    """The kernel and the plain chain against ``attention_f32`` at one
    shape and ``seq`` tokens: each one's largest error, mean error and
    largest error of a row (a token's head) over that row's largest
    magnitude.

    Both round where the chain rounds (the scores to bf16 before and after
    the scale, the probabilities to bf16, the output to bf16); the kernel
    rounds probabilities not yet normalised and sums in another order, so
    its errors are the chain's kind and size, not the same numbers. Three
    gates, each ATTENTION_RATIO times the chain's figure plus a floor:

    - the largest error, plus ATTENTION_FLOOR of the largest output
      magnitude: the final cast alone puts either half a bf16 ulp (2**-9
      of a value's binade) off, and where the chain's sum lands next to a
      rounding point and the kernel's on the far side, the two differ by
      that much while each is right;
    - the largest row-relative error, plus ATTENTION_ROW_FLOOR: half an
      ulp of a row's largest value is at most 2**-8 of it. The outputs
      of long rows average more values and are smaller, so this is the
      gate that sees a fault confined to late rows or late key tiles;
    - the mean error, with no floor.

    Raises past a bound, or unless one launch made a (1, S, H * dv) bf16
    output."""
    import torch

    from tpukube_torch.kernels import attention

    q, k, v = attention_inputs(shape, seq, device, seed + seq)
    before = attention.launches
    got = attention.causal_attention_fwd(q, k, v)
    launches = attention.launches - before
    plain = attention.causal_attention_plain(q, k, v)
    want = attention_f32(q, k, v)
    H, _, _, dv = ATTENTION_SHAPES[shape]
    if tuple(got.shape) != (1, seq, H * dv) or got.dtype != torch.bfloat16 or launches != 1:
        raise RuntimeError(f"{shape} S={seq}: {tuple(got.shape)} {got.dtype}, {launches} launches")
    top = float(want.abs().max())
    rows = want.view(1, seq, H, dv).abs().amax(-1)

    def errors(x) -> tuple:
        err = (x.float() - want).abs()
        row = float((err.view(1, seq, H, dv).amax(-1) / rows).max())
        return float(err.max()), float(err.mean()), row

    kmax, kmean, krow = errors(got)
    pmax, pmean, prow = errors(plain)
    out = {"kernel_max": kmax, "kernel_mean": kmean, "kernel_row": krow,
           "plain_max": pmax, "plain_mean": pmean, "plain_row": prow,
           "kernel_vs_plain_max": float((got.float() - plain.float()).abs().max()),
           "floor": ATTENTION_FLOOR * top}
    out["bound"] = ATTENTION_RATIO * pmax + out["floor"]
    out["row_bound"] = ATTENTION_RATIO * prow + ATTENTION_ROW_FLOOR
    out["mean_bound"] = ATTENTION_RATIO * pmean
    for name, bound in (("max", "bound"), ("row", "row_bound"), ("mean", "mean_bound")):
        if not out[f"kernel_{name}"] <= out[bound]:
            raise RuntimeError(f"{shape} S={seq}: the kernel's {name} error {out[f'kernel_{name}']} "
                               f"is past {out[bound]} (chain {out[f'plain_{name}']})")
    return out


def attention_bound(shape: str, seq: int) -> dict:
    """The kernel's least time at one decoder's shape: the causal FLOPs,
    2 * H * S(S+1)/2 * (dq + dv), at the bf16 peak, and the bytes of q, k,
    v and the output once each at HBM_BYTES_PER_S; the larger binds."""
    H, KV, dq, dv = ATTENTION_SHAPES[shape]
    flops = H * seq * (seq + 1) * (dq + dv)
    nbytes = 2 * seq * (H * dq + KV * dq + KV * dv + H * dv)
    return {"flops": flops, "bytes": nbytes, "flop_ms": flops / H100_BF16_FLOPS * 1e3,
            "byte_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def attention_times(shape: str, seq: int, device) -> dict:
    """Times at one decoder's shape and ``seq`` tokens on an idle card, over
    ATTENTION_ITERS calls after a warm-up: the kernel, the plain chain and
    ``F.scaled_dot_product_attention(is_causal=True)`` (the library's
    yardstick, ``library_ms``; the port never calls it) by CUDA events; the
    kernel's device time a launch by ``torch.profiler``; its bound and its
    share of the FLOP bound."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from tpukube_torch.kernels import attention

    q, k, v = attention_inputs(shape, seq, device, seed=seq)
    H, KV = ATTENTION_SHAPES[shape][:2]

    def library(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True,
                                              enable_gqa=H != KV)

    def events_ms(fn) -> float:
        with torch.inference_mode():
            fn(q, k, v)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ATTENTION_ITERS):
                fn(q, k, v)
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) / ATTENTION_ITERS

    out = {"kernel_ms": events_ms(attention.causal_attention_fwd),
           "plain_ms": events_ms(attention.causal_attention_plain), **attention_bound(shape, seq)}
    try:  # the yardstick only: the step does not stand or fall with it
        out["library_ms"] = events_ms(library)
    except RuntimeError as e:
        out["library_ms"], out["library_error"] = None, str(e)[:200]
    with profile(activities=[ProfilerActivity.CUDA]) as prof, torch.inference_mode():
        for _ in range(ATTENTION_ITERS):
            attention.causal_attention_fwd(q, k, v)
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages() if e.key.startswith("causal_attention_fwd") and e.count]
    if len(seen) != 1:
        raise RuntimeError(f"the profiler saw {[e.key for e in seen]}, not the one kernel")
    out["device_ms"] = seen[0].device_time_total / seen[0].count / 1e3
    out["bound_ms"] = max(out["flop_ms"], out["byte_ms"])
    out["flop_pct"] = 100 * out["flop_ms"] / out["device_ms"]
    out["tflops"] = out["flops"] / out["device_ms"] / 1e9
    return out


def attention_child() -> int:
    """Step 24 in this (fresh) interpreter on the card: at each of
    ATTENTION_TIMED and ATTENTION_LENGTHS, ``attention_check`` then
    ``attention_times``; prints the results as one JSON line, last. A
    failed check prints ``attention 24: ...`` on stderr and returns 1."""
    import torch

    device = torch.device("cuda", 0)
    out = []
    for shape in ATTENTION_TIMED:
        for seq in ATTENTION_LENGTHS:
            try:
                checks = attention_check(shape, seq, device)
                torch.cuda.empty_cache()
                times = attention_times(shape, seq, device)
            except Exception as e:  # noqa: BLE001 (every failure fails the step)
                import traceback

                traceback.print_exc()
                return fail(f"attention 24: {type(e).__name__}: {e}")
            torch.cuda.empty_cache()
            out.append({"shape": shape, "seq": seq, "checks": checks, **times})
    print(json.dumps(out), flush=True)
    return 0


def attention_phase(card: str, env: dict):
    """Step 24: ``attention_child`` in a fresh interpreter on the allocated
    card (``env``), a line a shape and length, then the ``attention``
    line. Returns the line's object, or None when a check failed."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.attention_child())"],
        cwd=ROOT, env=pod_env(env), stdout=subprocess.PIPE, text=True, timeout=POD_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(proc.stdout, flush=True)
        fail(f"attention 24: the child exited {proc.returncode} (its stderr above names the check)")
        return None
    rows = json.loads(lines[-1])
    for r in rows:
        H, KV, dq, dv = ATTENTION_SHAPES[r["shape"]]
        c = r["checks"]
        print(
            f"causal_attention_fwd {r['shape']} (H {H}, KV {KV}, dq {dq}, dv {dv}), S {r['seq']}: "
            f"{r['device_ms']:.4f} ms a launch (bound {r['bound_ms']:.4f}: FLOPs "
            f"{r['flop_ms']:.4f}, bytes {r['byte_ms']:.4f}; {r['flop_pct']:.1f}% of the FLOP "
            f"bound, {r['tflops']:.0f} TFLOP/s); events: kernel {r['kernel_ms']:.4f}, chain "
            f"{r['plain_ms']:.4f}, library {r['library_ms'] or float('nan'):.4f} ms; largest error vs f32 "
            f"kernel {c['kernel_max']:.3e} (bound {c['bound']:.3e}), chain {c['plain_max']:.3e}; "
            f"of a row {c['kernel_row']:.3e} (bound {c['row_bound']:.3e}), chain "
            f"{c['plain_row']:.3e}; mean {c['kernel_mean']:.3e} / {c['plain_mean']:.3e} [{card}]",
            flush=True,
        )
    return {"attention": rows, "card": card}


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


def run_shared(envs: list, guard: str, mgr, during=None) -> tuple:
    """Two ``--shared`` pods, one per share env, under the guard: both are
    started, and released by ``go`` together once both are ``ready``;
    while they run, the node agent's telemetry is sampled and its probe
    must stay healthy, and ``during()`` (when given) runs once, right
    after the release. Returns (reports, ready lines, [(phase,
    telemetry)]) or None when a pod or the probe failed. No pod outlives
    the call."""
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
        if during is not None:
            during()
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


def vgpu_phase(card: str, c0, solo: dict, shared_out: list) -> int:
    """BASELINE config 3 on the card (module docstring, step 8); 0 or the
    exit code of the failed check. The two shared pods' reports go into
    ``shared_out`` (step 16 prints its tenants' pods beside them)."""
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
    shared_out.extend(reports)
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
        step3_ms: list = []
        allocs = place_pods(node_object(mgr), [pod_object("serve-0", tpu=1)],
                            [["tpu-0"]], pod_object("serve-1", tpu=1), card,
                            times=step3_ms)
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
    # every served forward takes the attention kernel, once a layer
    if pod["attention_launches"] != pod["n_layers"] * pod["requests"]:
        return fail(f"pod: {pod['attention_launches']} attention launches in "
                    f"{pod['requests']} forwards of {pod['n_layers']} layers")
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
    # each of the 49 norms launches the pair, two kernels a direction
    want = 4 * 49 * (rn["steps"] + 1)
    if rn["norms"] != 49 or rn["norm_launches"] != want:
        return fail(f"ResNet pod: {rn['norm_launches']} GroupNorm launches over "
                    f"{rn['norms']} norms, not {want} over 49")
    print(
        f"ResNet-50 DP step ({rn['params']} params, bf16 compute, GroupNorm and "
        f"its ReLU by the Triton pair: {rn['norm_launches']} launches in "
        f"{rn['steps'] + 1} steps), "
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
    step8_shared: list = []
    rc = vgpu_phase(card, c0, pod, step8_shared)
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
    r5 = config5_phase(card)
    if r5 is None:
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

    # -- the Kubernetes REST channel: one card pod's life, then config 5 ----
    rest = rest_phase(card, c0, r5)
    if rest is None:
        return 1
    print("rest: " + json.dumps(rest, sort_keys=True), flush=True)

    # -- the batch cycle: scenarios 1-6, the kilonode drives, a card pod ----
    drives = batch_phase(card, c0)
    if drives is None:
        return 1
    print("scenarios: " + json.dumps(drives, sort_keys=True), flush=True)

    # -- the daemons as users start them: syncer and extender children ------
    daemons = daemon_phase(card, c0, step3_ms[0])
    if daemons is None:
        return 1
    print("daemons: " + json.dumps(daemons, sort_keys=True), flush=True)

    # -- crash and fault recovery: chaos scenarios, the journaled daemon ----
    recovered = recovery_phase(card, c0, daemons)
    if recovered is None:
        return 1
    print("recovery: " + json.dumps(recovered[0], sort_keys=True), flush=True)
    print("journal: " + json.dumps(recovered[1], sort_keys=True), flush=True)

    # -- the multi-tenant serving plane: scenarios 11 and 7, two tenants ----
    tenancy = tenancy_phase(card, c0, daemons, step8_shared)
    if tenancy is None:
        return 1
    print("tenancy: " + json.dumps(tenancy, sort_keys=True), flush=True)

    # -- fleet elasticity: scenario 15, this node drained and scaled back --
    elastic = elasticity_phase(card, c0, step8_shared)
    if elastic is None:
        return 1
    print("elasticity: " + json.dumps(elastic, sort_keys=True), flush=True)

    # -- decision provenance: the decisions smoke, a card pod explained ----
    prov = provenance_phase(card, c0, step8_shared)
    if prov is None:
        return 1
    print("provenance: " + json.dumps(prov, sort_keys=True), flush=True)

    # -- the sharded plane: scenario 14, a DCN gang through the router -----
    shard = shard_phase(card, c0, prov)
    if shard is None:
        return 1
    print("shard: " + json.dumps(shard, sort_keys=True), flush=True)

    # -- the process-parallel plane: worker daemons, a card pod's worker
    # killed and respawned --------------------------------------------------
    shard_proc = shard_proc_phase(card, c0, prov, t_start)
    if shard_proc is None:
        return 1
    print("shard_proc: " + json.dumps(shard_proc, sort_keys=True), flush=True)

    # -- the lint prover and the lock-order monitor, a card pod under it ----
    lint = analysis_phase(card, t_start)
    if lint is None:
        return 1
    print("lint: " + json.dumps(lint, sort_keys=True), flush=True)

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
    # nothing on the card path loaded the gRPC stack, a YAML parser or aiohttp
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("grpc", "yaml", "aiohttp")
                    or m.startswith("google.protobuf"))
    if loaded:
        return fail(f"the card path imported {loaded}")

    # -- the GroupNorm pair against its plain version ------------------------
    kernels = kernels_phase(card, env)
    if kernels is None:
        return 1

    # -- the causal attention kernel against its plain version ---------------
    attn = attention_phase(card, env)
    if attn is None:
        return 1
    print("attention: " + json.dumps(attn, sort_keys=True), flush=True)
    print(f"chip_smoke: whole run {time.monotonic() - t_start:.1f} s [{card}]",
          flush=True)

    print(json.dumps({
        **kernels,
        "note": "the JAX package has no Pallas kernel; the port's one hand "
                "kernel pair is kernels/group_norm.py (Triton; ms: the "
                "profiler's device time a launch at batch 64, bound_ms: each "
                "byte the kernel must move once at 3.35 TB/s, plain_ms: its "
                "direction in the plain version, F.group_norm on the float32 "
                "copy, the cast and F.relu, by CUDA events). The native code "
                "is host C++: gpuinfo (NVML discovery, XID health, telemetry) "
                "and cudaguard (CUDA driver quota guard); the scheduler extender, "
                "its durable journal (WAL, CRC, checkpoints), the tenancy "
                "plane (quotas, DRF order, SLO-burn shedding), the SLO "
                "evaluator, drain, the autoscaler, capacity analytics, "
                "decision provenance, the shard router, its process "
                "transport, the shard-worker daemons and the TKW1 wire "
                "codec, the incremental resync log, the lint prover "
                "(tpukube_torch.analysis) and the lock-order monitor "
                "(analysis.lockgraph) are host Python (numpy)",
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
