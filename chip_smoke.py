#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build, check and time the batch
round's kernels on one NVIDIA GPU, then drive the port's main path.

    python3 chip_smoke.py    # one card, about 13-15 min, build included

Workloads (every one from seed 42 through ``workloads.cluster``):

- cfg2: 1000 pods x 500 nodes, percentageOfNodesToScore 100, tie_break
  first; the five-filter, five-score profile;
- north: 10 000 pods x 5 000 nodes, percentage 0 -> 500 sampled nodes,
  tie_break reservoir, base counter 12345, start index 2027; that profile;
- cfg3: 5 000 pods x 2 000 nodes, every pod with bench's two spread
  constraints; cfg2's knobs; the seven-plugin profile (the five plus
  PodTopologySpread and InterPodAffinity, upstream's default weights);
- cfg4: 10 000 pods x 5 000 nodes, inter-pod terms on every pod (bench's
  preferred anti-affinity on odd pods, required anti-affinity on every
  25th, required zone affinity on pods 20, 60, ...) and the spread
  constraints on every 3rd; north's knobs; the seven-plugin profile;
- cfg5-vol: BASELINE cfg5's size and profile in one round: 10 000 pods x
  5 000 nodes plus 5 000 pods bound round-robin before it, cfg4's spread
  constraints and inter-pod terms, DaemonSet host ports and volumes
  (``workloads.add_host_ports``, ``add_volumes``: own, shared and
  WaitForFirstConsumer claims, GCE PD, EBS and Azure disks, CSI nodes);
  percentage 0 -> 500 sampled nodes (so the score planes are compacted in
  the scan's step), tie_break first, base counter 0, start 0; upstream's
  default profile (fifteen filters and seven scores in the registry's
  order, default weights);
- cfg5-churn (the main path since the service's batch round was ported):
  BASELINE cfg5's churn as the JAX package's bench drives it
  (``run_churn``), through the port's ``SchedulerService(store,
  tie_break="first", use_batch="auto")`` on the default configuration: 5
  000 nodes, 10 000 pods (spread constraints on every 3rd) in 5 waves of
  2 000 with deterministic stamps, 10 % of the bound pods deleted after
  each wave, and a rolling cordon of 50 nodes before every wave after the
  first (``workloads.churn``); one ``schedule_pending(max_rounds=1)`` a
  wave, each a windowed round of 8 windows of 256 pods (P 2 048);
- cfg7-preempt-5k: Kubernetes scheduler_perf's PreemptionBasic at its
  5000Nodes size (``workloads.preemption_wave``): 5 000 nodes of 4 CPU, 32Gi
  and 110 pods, 20 000 bound low-priority pods (4 a node, 900m and 500Mi,
  priorities 0-2, seeded start times, 64 apps), 16 PDBs allowing 2
  disruptions each, then 400 fillers (priority 50) and 64 preemptors of 3
  CPU (priority 10, every 8th pinned to a hostname) pending; one
  ``schedule_pending(max_rounds=1)`` through the port's service on the
  default configuration: every preemptor fails its first scan, the victim
  search (K5) runs once per replay window with failures, and each
  nomination restarts the kernel on the tail;
- cfg8-gang: the JAX package's bench ``run_gang`` (``workloads.gang_churn``):
  200 distributed-training jobs of 8-64 one-CPU members (plan seed 24),
  each a PodGroup with minMember its member count, on 220 bench nodes (64
  CPU, 256Gi, 512 pods, 8 zones), arriving in 5 waves, each wave's jobs
  completing after the next wave is scheduled; one
  ``schedule_pending(max_rounds=3)`` a wave through the port's service
  under ``gang_scheduler_config()`` (Coscheduling, DefaultPreemption off):
  every member parks at Permit until its gang's last member releases the
  whole gang, and each replay window makes one gang-verdict dispatch (K6);
- cfg6-autoscale: the JAX package's bench ``run_autoscale``
  (``workloads.autoscale``): 4 bench nodes, three node groups (pool-small 8
  CPU 32Gi ssd, pool-mid 16 CPU 64Gi hdd, pool-big 64 CPU 256Gi ssd; each
  at minSize 0, maxSize 48, 110 pods, a zone of its own), then 1 500 bench
  pods from ``random.Random(11)``; ``SchedulerService(store,
  tie_break="first", use_batch="auto", autoscale="on")`` with the
  least-waste expander and ``schedule_pending_autoscaled(max_rounds=2,
  max_passes=12)``: each scale-up estimate is one lane-scan launch (K8);
- the autoscale burst: one ``ScaleUpEstimator.estimate`` against 16 node
  groups of 64 copies (the reference autoscaler's max_nodes_per_scale_up),
  4 to 64 CPU, every 4th tainted NoSchedule, and 10 000 pending bench
  pods (``workloads.autoscale_burst``): G 16 x N 1 024 x P 10 000;
- cfg10-tune-10k: the JAX bench's tune report (``bench.py`` run_tune_report:
  the imbalance/cem, consolidate/cem and imbalance/grad rows, seed 11, 8
  steps, population 16, tau 50, lr 1, the default profile's seven scores and
  its filters) at 1 250 nodes x 10 000 pods (the bench's 8 pods a node at
  north's pod count; ``workloads.tune``), ``run_tuning`` on the card in
  float32; the bench's own 12 x 96 size is the parity cut;
- cfg9-stream: the JAX package's bench ``run_stream_report``
  (``workloads.stream_cluster`` / ``steady_feed``): 600 bench nodes, 6 000
  bench pods bound round-robin (spread constraints on every 3rd), then
  ticks of 100 arrivals and 100 deletions of settled pods, through
  ``SchedulerService(store, tie_break="first", use_batch="force")``: one
  priming tick, then 48 timed ticks (a cut of the bench's 320) in each of
  three modes: ``schedule_pending`` a tick, ``schedule_stream`` with the
  overlap off, and streamed (wave k+1's encode, upload and scan launched
  while wave k commits);
- cfg11-scenario: BASELINE cfg5's "10k pods x 5k nodes scenario" as one
  KEP-140 Scenario (``workloads.scenario_churn``): major 0 creates 5 000
  bench nodes and a Deployment ``web`` of 200 replicas of a 100m / 128Mi
  pod, majors 1-5 create 2 000 bench pods each (spread constraints on
  every 3rd, deterministic stamps), majors 2-5 first delete every 10th pod
  of the previous major by name and move a rolling 50-node cordon by
  patchOperations, major 3 also scales ``web`` to 400, major 6 is the
  doneOperation; ``ScenarioEngine(store, SchedulerService(store,
  tie_break="first", use_batch="auto"), ControllerManager(store)).run`` on
  the default configuration, store and service clocks pinned (SimClock);
- cfg8-gang-journal: cfg8-gang at full size (run_gang's knobs, store and
  service clocks pinned) with a write-ahead journal wired as the
  reference's boot wires it (``state/journal.py``, ``state/recovery.py``:
  the scheduler's meta on every record, a ``write_mark`` after each wave),
  its primary killed by ``kill_at`` inside wave 4;
- the scorer bridge at north: north's 5 000 nodes with 5 000 of its pods
  bound (``make_cluster("north", (16, 5000, 5000))``), the default profile,
  ``TPUScorerBridge`` Filter and Prioritize for its first 16 pending pods
  over seeded candidate lists of 500 node names (upstream's default sample
  at 5 000 nodes) and for its first 2 over every node;
- the extender round: cfg2's cluster (500 nodes) with its first 64 pods
  pending, a scheduler whose configuration has an extender stanza (filter
  and prioritize verbs, weight 1, nodeCacheCapable) pointing at the bridge
  served over HTTP at the reference's routes.

Cut for the time limit: no float64 churn runs at full size (the cut of
phase 9 holds float64); the annotation bytes of phase 4 are compared at
full size at cfg2 only (cfg3 at a 1 000 x 500 cut, as cfg4 and cfg5-vol),
so the float64 end-to-end rounds run only there.  None of these holds a
kernel against its plain version.  cfg9-stream times 48 ticks a mode
(``time_stream.py`` runs the bench's 320) and its float64 leg 8.  The
float32 churn, cfg7 and cfg8-gang's scale leg hash no pod digests (nothing
compares them; at full size they cost ~6 ms a MB of annotations).  The float32 churn runs the
first 3 of its 5 waves (phase 29 replays the same windowed rounds at the
same size), cfg8-gang's scale leg all 5.  The CPU float64
references of phases 4, 9, 14, 18, 22, 26, 28 and 29 run in two worker processes
started after the build, beside the card's phases.  The plain references
of phases 2, 23 and 24 (host-bound: hundreds of small launches a pod) run
on the card in two more worker processes, beside the main process's
untimed checks, and hand back their time and a sha256 digest of every
output (the kernel's must be equal: bitwise); every kernel is timed after
they are idle.  The script stops all four workers before it exits.

Phases (each prints its seconds; any failure exits nonzero before the last
line):

1. the card's name and power limit (nvidia-smi), then the kernel build
   (nvcc, sm_90a, every source in parallel, on a thread while the worker
   processes start their references and the clusters are encoded; joined
   before the first kernel launch); the C renderer's status
   (``native.status()``: the library, or why it did not load, the build's
   seconds, the Python headers) and the compiler's version: the script
   fails if the renderer did not load;
2. kernel against plain version on the card, bitwise (digests of every
   output against a worker's plain run) in float32 and float64, with the
   trace on: the scan (one thread-block cluster of ``cluster_width(N, 1)``
   blocks; score planes compacted in the step wherever a round would
   compact them) and the compaction of its planes at every workload; in
   float32, the redundant chains (the earlier design, one block per SM)
   bitwise equal to the cluster at every workload and timed beside it; where the step compacts, the compacted
   planes against the same kernel's full planes gathered at the ascending
   sampled ids, and the two blobs; at cfg5-vol, the first failures of each
   filter (NodePorts, VolumeRestrictions, NodeVolumeLimits, VolumeBinding
   and VolumeZone must each reject a pair); the compaction on seeded planes
   for every fail-pack mode and raw dtype (``K3_SEEDED``: rows that wrap,
   start at 0, visit nothing or more than n_true; padded node columns;
   planes at odd offsets; in-step planes; north's widths); the compaction
   timed at every workload over launches back to back behind a sleep of
   the card (``timing.device_ms``), its host µs a call beside it;
3. end to end: ``BatchEngine(device="cuda").schedule`` on every workload
   in float32, and in float64 at cfg2 (launch counters reset just before
   each round and read just after: every round must launch each kernel
   once);
4. every pod's annotation bytes from a CUDA float64 round equal a CPU
   float64 round's at cfg2, and at cfg3, cfg4 and cfg5-vol cut to 1 000
   pods x 500 nodes (a CPU round at full size does not fit the time
   limit);
5. the float32 round's differences from float64 at cfg2, per score plugin
   and per filter, printed;
6. the scatter kernel (K4) against its plain version, bitwise, on every
   plane dtype and rank of the churn's problem, K from 1 to a quarter of
   the rows with repeated indices; timed beside its plain version and
   ``index_copy_`` (kernel, plain, library, kernel; 200 calls each), each
   with its CUDA-event µs and its host µs a call over the same calls;
7. the windowed scan (K2w, a cluster as every one-lane scan): at cfg4's
   and cfg5-vol's full shapes, the kernel run in windows of 256 chained on
   the card equals the one-launch kernel bitwise (packed outputs, trace
   planes and compaction blobs window by window, the whole final carry), in
   both dtypes, timed against it; at cfg5-churn's wave shape, one window
   against the windowed plain version and the redundant chains, timed
   beside them;
8. cfg5-churn end to end on the card, float32 (its first 3 waves): per wave
   the wall, encode, blocked and estimated device time, commit with its
   ``annotate`` and ``store_mutate`` stages, windows,
   launches (counts reset just before each wave), the placer's decisions
   and planes scattered, and the encoder's counters; a wave fails on a
   scan or compaction count other than its window count, no scatter after
   the first wave, a batch fallback, a sequential pod, an unbound pod, or a
   document the C renderer did not render (``materialize_wave`` returning
   None, a filter pair without its escaped twin);
9. the same churn cut to 1 500 pods in 3 waves on 500 nodes with a 10-node
   cordon: the CUDA float64 service and the CPU float64 service leave every
   pod with equal annotations, node and status;
10. (cut for the time limit: float32 against float64 after the first
   churn wave);
11. the victim-search kernel (K5) against its plain version, bitwise, in
   float32 and float64, on seeded problems of 64 pods x 5 000 nodes with V
   1, 4 and 16 slots, with no PDB and no same-window success and with 16
   PDBs and 150 successes;
12. cfg7-preempt-5k end to end on the card, float32 (counts reset just
   before the round): the wall, the restarts, the victim-search dispatches
   and K5 launches, its seconds, the nominations and victims, commit,
   sequential pods, scan and compaction launches; it fails on a preemption
   or batch fallback, a sequential pod, a preemptor neither bound nor
   nominated, no nomination, restarts other than the nominations (less one
   when the last pending pod is the one nominated), or K5 launches other
   than the dispatches;
13. K5 against its plain version on the captured inputs of that round's
   first dispatch, bitwise in float32 and float64, timed (the kernel over
   20 launches enqueued behind a sleep of the card, so they run back to
   back: the launch is shorter than its call; the call's host time beside
   it; the plain version once); the whole dispatch
   (``run_search`` on the same host inputs: its masks the kernel's) and its
   split (host staging; inputs in, kernel and fetch by CUDA events), the
   mean of 20, warm and cold (the problem's tables uploaded first, as the
   service runs every dispatch);
14. cfg7-preempt-5k cut to 500 nodes, 2 000 bound pods, 40 fillers and 16
   preemptors, two rounds: the CUDA float64 service and the CPU float64
   service (a worker process) leave every pod with equal annotations, node
   and status (nominatedNodeName included) and evict the same pods;
15. the gang kernels against their plain versions, bitwise: the window
   verdict (K6) on seeded problems (K 256 and 2 048 member slots, G 80, N
   220 and 5 000, D 8 and N; K 4 096, G 512, N = D 5 000, whose bitmaps take
   several blocks), the feasibility scan (K7) in float32 and
   float64 at a shape for each of its kernel shapes (a warp a group at N
   60-500, blocks of 256 and 512 threads at N 2 000-8 000, the state in
   shared memory at R 5 and in global scratch at N 12 000 in float64), at
   the JAX bench's dispatch shape (G 64, M 64, N 220, D 8) and at G 256 x
   M 64 x N 5 000 with D 8 and D 5 000;
16. cfg8-gang end to end on the card, float32, all 5 waves: per wave the
   wall, commit with its ``annotate`` and ``store_mutate`` stages, the gang
   counters, the launches (counts reset just before each wave) and the
   verdict's seconds; a wave fails on a verdict mismatch, a partially bound
   group, a gang or batch fallback, K6 launches other than the dispatches,
   dispatches other than one a replay window, an unbound member, or a
   document the C renderer did not render (as in 8);
17. K6 timed on the captured inputs of 16's first dispatch (launches back
   to back behind a sleep of the card, ``timing.device_ms``; the host's
   call and the CUDA-event time of host-paced calls beside it; the
   dispatch's host ms from 16's ``gang_kernel_s`` over its dispatches); group_preview
   at 16's final state on a feasible group (32 one-CPU members) and on one
   too large for any node (4 members of 100 CPU at priority 100), counts
   reset just before: K7 must launch twice and the victim search (K5) at
   least once; K7 and K5 against their plain versions on the captured
   inputs, K7 timed as K6, with the preview's whole dispatch (one copy in,
   one copy out) and K7 at the JAX bench's standalone dispatch (64 fresh
   groups of 8-64 one-CPU members over the 220 nodes) at 16's final state;
18. the CUDA float64 service against the CPU float64 service (a worker
   process) on cfg8-gang's parity leg (24 jobs of 2-8 members, plan seed
   23, 40 nodes) and on the same plan on 4 nodes of 8 CPU in 3 zones (members
   fail and gangs cascade): after every wave every pod's annotations, node
   and status equal, the events equal at the end; no group partially bound
   after any wave;
19. Part A's probe (one node of 33554438 bytes of memory, one pod asking
   33554439): in float32 on the card the round runs in float64 (one
   promotion counted, in the engine and in the service), places nothing
   ("Insufficient memory") and equals the float64 round.  Phases 3, 8 and
   12 fail on any promotion and print each round's exactness headroom;
20. (run after 21, on its captured inputs) K8 (the masked mode: one
   block of ``lane_tile`` threads a lane over its own rows) against its
   plain version, bitwise in float32 and float64, at cfg6-autoscale's
   first estimate dispatch; at the burst's shape, each of the 16 lanes of
   K8 against the one-lane scan (K2) launched on that lane's mask, in both
   dtypes; K8 timed over 20 launches at both shapes, the plain version
   once at cfg6's; the tile width printed;
21. cfg6-autoscale end to end on the card, float32 (counts reset just
   before): the wall, scheduled, pending after, nodes added, scale-ups,
   passes, group sizes, estimate dispatches and K8 launches, each
   dispatch's (G, P, N), exactness headroom, K8 time, tile width and split
   (encode, lower, launch, fetch; the process's first K8 launch apart from
   the next), ``estimate_cum_s`` and its split, the rounds' scan
   and compaction launches, and whether the scale-ups equal
   BENCH_autoscaler.json's (recorded, not required); it fails on a kernel
   error, a resource-fallback estimate or a method other than
   "xla-batch", K8 launches other than the dispatches, a pod left pending,
   or a batch fallback other than the size rule (a round below
   ``batch_min_work`` takes the sequential cycle, as in the bench); then
   one estimate at the autoscale burst, its wall, split and K8 time;
22. cfg6-autoscale through the CUDA float64 service and the CPU float64
   service (a worker process), store clocks frozen: every pod's
   annotations, node and status, the autoscaler's events, summaries and
   node names equal;
23. K9 at cfg10-tune-10k's imbalance problem and at its consolidate
   problem (625 term groups), each on generation 0's population of
   ``run_cem`` (seed 11, 16 lanes), in float32 and float64: each lane
   bitwise equal to the one-lane scan (K2, one block) under that lane's
   weights (packed outputs and final carry), launched explicitly as the
   redundant chains with one block: the cluster path against the block
   path; the lane with the most fractional weights bitwise equal
   to ``scan_plain``; the objective kernel (values on every lane,
   cotangents of every lane) bitwise equal to its plain version for the
   three objectives; K9 and its objective timed over 20 launches at each
   problem, the plain scan once; the cluster width C and the term-group
   list width KM printed (K8's tile width, in 20);
24. K2g (the grad forward, a cluster of ``cluster_width(N, 1)`` blocks
   folding the residual M, then the contraction) at the same problem under
   the lane with the most fractional weights, tau 50: fragmentation in
   float32 and utilization in float64 against ``grad_plain`` (a worker's)
   within K2G_TOL of the gradient's norm (printed with the error), the
   launch's final carry bitwise the hard rollout's; pending_age exactly 0;
   timed over 20 launches, and apart: the grad forward against the hard
   forward (one lane of K9), the contraction against its plain version
   (bitwise) and ``torch.einsum``;
25. cfg10-tune-10k end to end, float32, the three rows through a default
   service on the card: wall, rollouts, dispatches, grad dispatches,
   launches (counts reset just before each row), default and tuned
   objectives, improvement, exactness headroom and the population's carry
   bytes; it fails on K9 launches other than the evaluate and population
   dispatches (dispatches less grad dispatches), grad forwards (K2g) or
   contractions other than the grad dispatches, a promotion, or a tuned
   objective below the default;
26. CUDA float64 against CPU float64 (a worker process) at the bench's
   12 x 96: the three ``run_tuning`` reports (CEM bitwise, grad within
   1e-9); the zero-drift rounds (the bench's imbalance workload through the
   service with no override, with the profile's own weights as an
   override, and with seeded float weights): the defaults change no byte,
   and every pod's bytes equal the CPU service's, finalScore fractional
   under the float weights;
28. (run after phases 29, 35 and 36, beside phases 23-24's plain
   references) cfg9-stream on the card, float32, each of the three
   modes from a fresh cluster (launch counters reset just before the 48
   timed ticks, read just after; each streamed wave's own launches counted
   apart around ``schedule_async`` and its ``decisions()``): the wall,
   pods/s, ``stream_overlap_s``, ``stream_stall_s``, overlap efficiency,
   drains, the stages (admit, encode, upload, dispatch, device_blocked,
   trace_fetch, annotate, store_mutate), the placer's decisions and the
   encoder's counters; the three final stores' ``pod_parity_state``
   digests must be equal; the streamed run fails on fewer than 40 waves,
   no overlap, a drain, a wave that did not launch exactly one scan and one
   compaction, a fallback, a sequential pod, a promotion or an unbound pod;
   then one more wave's ``result()`` is timed behind a sleep of the card
   (~200 ms) enqueued after its ``decisions()``: it must return in a
   quarter of the sleep (it waits on the blob copy's event, not on the
   stream) while the card still sleeps; then the CUDA float64 streamed run
   at 8 ticks equals a CPU float64 streamed run (a worker process);
27. (run after 19) the C renderer's bytes against the Python renderer's
   (every binding of the renderer cleared): every document of cfg2's
   full-size float64 round of phase 4 (the per-pod functions, and
   ``materialize_wave`` for the scheduled pods) equal on that BatchResult;
   the churn cut of phase 9 and cfg8-gang's parity leg through the CUDA
   float64 service, pod digests (and the gang's events) equal;
29. (run after 28) cfg11-scenario on the card, float32 (launch counters
   reset just before the replay, read just after and at the end of each
   major's convergence pass): the replay's wall, each major's wall and
   launches, ``metrics()`` (``batch_pods``, ``batch_commits``,
   ``engine_rounds``, ``commit_s``, ``overlap_efficiency``), the
   allocation rate; it fails on a phase other than Succeeded, an unbound
   pod (the 400 ReplicaSet pods included), a podScheduled count other than
   the bindings or a delete count other than the delete operations, a
   batch fallback, a sequential pod, a promotion, or no scan, compaction
   or scatter launch; the full-size timeline is not hashed.  Then its
   float64 cut (500 nodes, 1 000 pods, a Deployment of 20 then 40, a
   10-node cordon) on the card: the returned Scenario and the store dump
   byte-equal (sha256) to a CPU float64 replay (a worker process); then the
   JAX package's autoscale replay (tests/test_autoscaler.py
   ``_autoscale_scenario``) under ``autoscale="scenario"`` in float64: its
   timeline equal to the CPU's, K8 launched;
30. the lifecycle on the card on cfg9-stream's cluster (600 nodes, 6 000
   bound pods, every node scored), float32: (a) one tick's 100 arrivals,
   then ``start_background(poll_interval=0.05)``: the loop's first round
   gives the pod digests of ``schedule_pending(max_rounds=1,
   respect_backoff=True)`` on two twin stores; (b) ten more ticks fed while
   the loop runs, then ``stop_background()`` (raising nothing): every
   arrival bound exactly once (one Scheduled event each), no node over its
   allocatable, ``batch_pods`` > 0 with no fallback, idle ticks launching
   nothing; (c) a configuration naming an unknown plugin rolls back; (d)
   after a restart with another configuration and
   ``reset_scheduler_configuration``, a tick's round gives the bytes of the
   twin that never restarted; (e) at phase 29's float64 cut, ``snap()``
   loaded into a fresh store and service on the card equals the source
   modulo uid and resourceVersion (the snapshot's kinds) and schedules
   nothing more, and ``ResetService.reset()`` restores the boot state and
   configuration;
31. cfg8-gang-journal, float32, on the card: (a) the uninterrupted run in
   a spawned process, its ``parity_digest`` the target; beside it (b) the
   journaled primary in another spawned process, killed by ``kill_at`` one
   record past wave 4's first gang-release record, while this process
   tails the live journal with a ``ReplicaApplier`` (the records, bytes,
   each wave's ``journal_append`` seconds against its ``commit_s``, the
   replica's lag); then (c), in a third spawned process started with the
   others, ``boot_recover`` into a fresh store (its replay seconds), a
   fresh service restarted from the journaled configuration,
   ``restore_scheduler_state``, a new journal epoch, the crashed wave re-run
   from the last mark (creates already there skipped) and wave 5, beside
   (d) ``promote_replica`` of the live replica in this process, resumed the
   same way.  Each resumed leg's digest must equal (a)'s, with no
   partially bound group, and a 32-member ``group_preview`` at each final
   state equal (a)'s; counts reset before each leg's waves: each must
   launch K2w, K3, K6 and K7;
32. the scorer bridge at north on the card, float32: each case's Filter,
   then Prioritize over the nodes that passed (none when none passed, as a
   scheduler calls it); each response equal to the
   bridge's own oracle fallback for the same pod (from a CPU worker):
   passed, failed and unresolvable nodes with their messages, and every
   score; no fallback, no error, one scan launch a call; each verb's median
   latency split into encode (with upload), kernel (launch and wait) and
   fetch (K3 and the trace);
33. the extender round on the card, float32: one ``schedule_pending``,
   which takes the sequential cycle (counted "extender webhooks
   configured"), each extender call one kernel pass of the bridge; no
   handler or Filter error, no fallback, every pod bound with both extender
   annotations; the binds and the extender annotation bytes equal the
   same round in float64 on the CPU (a worker process, its own server);
35. the differential fuzzer and kernel chaos on the card, float32
   (``fuzz_phases``: (a), (e), (b) and (c) run after cfg11-scenario,
   beside phases 23-24's plain references in the card's workers, which
   ``tune_start`` starts first; ``process_chaos_phase`` joins (d) last):
   (a) ``FUZZ_SWEEP``'s seeded composite scenarios
   through ``fuzz.smoke.sweep`` (batch against the sequential oracle,
   streamed against serial), every scenario after the first under
   ``RecompileGuard(max_compiles=0)``: no divergence, each kernel's
   launches; (b) ``KernelChaos`` at cfg2 (1 000 pods over 500 nodes, the
   five-plugin profile, percentage 100, windows of 256): the round's third
   window's fetch fails while the fourth is already launched; exactly one
   ``kernel error: ChaosError`` in ``batch_fallbacks``, windows 0-1
   committed (512 pods), the sequential tail's seconds, every pod's digest
   equal to the uninterrupted run's on the card; (c) ``KernelChaos`` on
   cfg9-stream's cluster for ``CHAOS_STREAM_TICKS`` streamed ticks (a
   decision fetch and a launch fail): both drains counted as ``kernel
   error: ChaosError``, the store's digest equal to a ``stream_off`` run's;
   (d) on a thread started before phase 34, one ``ProcessChaos`` kill
   point of a generated composite scenario on the batch path, its children on
   the card (loading the built libraries, building none): the recovered
   trail equal to the uninterrupted child's, no torn record, no partial
   gang, each reporting child's ``compile_count`` delta 0 and no degraded
   kernel error (``child_degrades``); (e) after (a), each fixture its own
   ``Phase`` (only the one that injects kernel errors marked chaos),
   both committed fixtures replayed on fresh harnesses on the card in
   float64 and float32: no divergence, the committed bytes.  No phase but
   35 may degrade a kernel error (``kernels.DEGRADES``: each ``Phase``
   checks it on exit, each worker job too, and it must be empty when phase
   35 starts).
36. the kernel-library cache (``ops/aot.py``) on the card: (a) after the
   build, every library (13) saved into a fresh temporary cache (13 saves);
   then two child processes, started beside phases 23-24's plain references
   and joined after phase 35, each with ``KSS_COMPILE_CACHE_DIR`` an empty
   temporary directory: (b) one loads every library from that cache (ten
   hits, no miss, no save, no ``nvcc``) and runs cfg2's float32 round in
   windows of 256 (K2, K3), its store digest equal to phase 35 (b)'s
   uninterrupted round's; (c) one over a copy of the cache with three
   entries altered (``AOT_TAMPERED``: scatter.cu's sidecar under another
   ``kernel-digest``, gang.cu's library truncated, preempt.cu's sidecar
   under another ``platform``) counts one fallback for each reason,
   rebuilds only those three sources with ``nvcc`` and saves them, holds K4
   (``kernels.scatter_rows``) bitwise against ``ops/batch.scatter_rows_plain``
   on every plane kind of cfg2's problem, and gives cfg2's digest again.
   The hits, misses, saves, fallbacks, the children's build and load
   seconds and the card's name and power limit are printed.
37. the scan ensemble (``ops/procmesh.py``, ``KSS_MESH_PROCESSES``) on the
   card, in a child process started after phases 23-24 and joined after
   phase 35 (d), with ``KSS_AOT_CACHE_DIR`` phase 36's warm cache and
   ``KSS_COMPILE_CACHE_DIR`` an empty directory (the child and its workers
   load every library from the cache): (a) cfg2's float32 round in one
   launch through a one-worker ensemble, its store digest phase 35 (b)'s,
   the pool engaged with a dispatch and a loaded scan, the worker's K2
   launches with 0 ``nvcc`` runs, 10 loads and 0 degrades, K3 in the
   parent, no fallback; (b) north in one launch in the child and through
   the worker, equal documents, with the wall split (planes shipped,
   the worker's place, scan and fetch, the reply, K3 and the trace in the
   parent); (c) ``WorkerChaos`` kill, stop and sever at dispatch 0 on a
   small seeded cluster: no divergence, one respawn (a hang for stop), the
   breaker closed, no worker left (``leaked_worker_pids``); (d) two
   workers on the one card: a counted fallback, ``sharded_scan_unported``
   only, or the probe's own reason where gloo cannot start (workers that do
   not start fail the phase), and cfg2's digest; (e) a grandchild with no
   ``nvcc`` (off its ``PATH``, ``CUDA_HOME`` an empty directory) loads all
   13 libraries from the cache, counted ``toolchain_unverified``, with no
   ``toolchain`` fallback.
38. the node axis sharded over shards of the one card (``NodeMesh((cuda:0,)
   * n)``: the buffers and the in-launch mailbox exchange a mesh of cards
   runs, csrc/scan_shard_trace.cu, scan_shard_cluster.cu and
   scan_shard_masked.cu), in a child process started beside phase 37's and
   joined after it: (1) cfg2 on 2 and 4 shards, float32 and float64, the
   sharded K2 bitwise the unsharded kernel and its plain sharded version
   (``scan_plain_sharded`` on the CPU), 4 windows of 256 chained shard for
   shard bitwise the one launch, then cfg2 through the service on 2 and 4
   shards (windows of 256 on the mesh) with phase 35 (b)'s store digest;
   the sharded K2 timed at cfg2 on 2 shards beside the unsharded kernel and
   its plain sharded version on the card; (2) north and cfg4 one-launch
   rounds on 2 and 4 shards: documents equal the one-device round's, K2's
   shard mode and K3 launched once each, the scan timed on 1, 2 and 4
   shards with what the shards add a pod; (3) K5 at cfg7-preempt-5k's first
   dispatch (phase 13's) on 2 and 4 shards, a launch a shard, masks equal
   the unsharded launch's, and the cfg7 cut through a service on 2 shards
   equal to one device's; (4) cfg6-autoscale through a service on 2 shards
   and the burst on 4, estimates, pods and events equal one device's, and
   every captured sharded K8 dispatch bitwise K8 on the whole axis; (5) the
   fuzzer's shard role on 2 shards of the card: no divergence; (6) 5 000
   lanes on 2 shards, more blocks than the card holds at once: refused
   with ``KernelArgumentError`` before the launch, no hang.  The kernels
   line reads the shard modes' launches from (1)-(5)'s main-path drives.

Before phase 20 the earlier phases' cycles and rounds are collected and
what is left of the heap is frozen (``gc.freeze``), the tracked objects
counted at each step, so phases 20-26 pay no full collection of it.

Then one ``{"kernels": [...]}`` line (time, plain time, bound and launches
of each kernel: the one-launch scan at cfg5-vol, launched by its round;
the windowed scan, the compaction and the scatter at cfg5-churn's shapes,
launched by the float32 churn; the victim search at the first dispatch of
cfg7-preempt-5k, launched by its round; the window verdict at cfg8-gang's
first dispatch, launched by the gang waves; the feasibility scan at the
preview's first group, launched by group_preview; the lane scan at
cfg6-autoscale's first estimate dispatch, launched by its loop; the
population scan K9 with its objective at phase 23's two shapes, the grad
scan K2g and its contraction at phase 24's, launched by phase 25's rows;
the scan's cluster width and the redundant chains' time beside it; the
scan's, the compaction's and the scatter's launches add cfg9-stream's
streamed run's, cfg11-scenario's and the background loop's, K8's the
autoscale replay's, the scan's, the compaction's and the scatter's the
bridge's (phases 32 and 33), the windowed scan's, the compaction's, the
scatter's, K6's and K7's the journaled legs' (phase 31), those of K2,
K2w, K3, K4, K5, K6 and K8 phase 35's sweep and chaos rounds, the scan's
phase 37's worker's and the compaction's phase 37's parent's,
``launches_by_path`` apart), and as
the last line
``{"ok": true, "device": {...}}``.  Everything is generated from seeds; nothing is read
from the network.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from typing import Any, NamedTuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12     # non-tensor float32
FP64_OPS_PER_S = 34e12     # non-tensor float64
INT32_OPS_PER_S = 33.5e12  # 64 INT32 lanes per SM against 128 FP32 (Hopper white paper)

FIVE_FILTERS = ("NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodeResourcesFit")
FIVE_SCORES = [
    ("NodeResourcesFit", 1),
    ("NodeResourcesBalancedAllocation", 1),
    ("ImageLocality", 1),
    ("TaintToleration", 3),
    ("NodeAffinity", 2),
]
# upstream's default profile as the service's default configuration hands
# it to the engine: the registry's filter order, its scores and weights
DEFAULT_FILTERS = (
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodePorts", "NodeResourcesFit",
    "VolumeRestrictions", "EBSLimits", "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits",
    "VolumeBinding", "VolumeZone", "PodTopologySpread", "InterPodAffinity",
)
DEFAULT_SCORES = [
    ("TaintToleration", 3), ("NodeAffinity", 2), ("NodeResourcesFit", 1), ("PodTopologySpread", 2),
    ("InterPodAffinity", 2), ("NodeResourcesBalancedAllocation", 1), ("ImageLocality", 1),
]
PROFILES = {
    "five": (FIVE_FILTERS, FIVE_SCORES),
    "seven": (
        FIVE_FILTERS + ("PodTopologySpread", "InterPodAffinity"),
        FIVE_SCORES + [("PodTopologySpread", 2), ("InterPodAffinity", 2)],
    ),
    "default": (DEFAULT_FILTERS, DEFAULT_SCORES),
}


class Workload(NamedTuple):
    pods: int
    nodes: int
    pct: int          # percentageOfNodesToScore
    tie: str
    base_counter: int
    start: int        # start index
    profile: str
    spread: Any = False    # predicate on the pod index, or False
    interpod: Any = False
    bound: int = 0         # pods bound round-robin before the round
    storage: bool = False  # host ports and volumes


WORKLOADS = {
    "cfg2": Workload(1000, 500, 100, "first", 0, 0, "five"),
    "north": Workload(10000, 5000, 0, "reservoir", 12345, 2027, "five"),
    "cfg3": Workload(5000, 2000, 100, "first", 0, 0, "seven", spread=lambda i: True),
    "cfg4": Workload(
        10000, 5000, 0, "reservoir", 12345, 2027, "seven", spread=lambda i: i % 3 == 0, interpod=lambda i: True,
    ),
    "cfg5-vol": Workload(
        10000, 5000, 0, "first", 0, 0, "default", spread=lambda i: i % 3 == 0, interpod=lambda i: True,
        bound=5000, storage=True,
    ),
}
# CUDA float64 against CPU float64 annotation bytes: (workload, cut to
# (pods, nodes, bound pods) or None)
ANNOTATION_CHECKS = (("cfg2", None), ("cfg3", (1000, 500, 0)), ("cfg4", (1000, 500, 0)), ("cfg5-vol", (1000, 500, 500)))
MAIN = "cfg5-vol"  # the one-launch path: the kernels line reads its float32 run
# cfg5-churn: (pods, nodes, waves, cordoned nodes); the byte-check cut
CHURN = (10000, 5000, 5, 50)
# the first 3 of its 5 waves: phase 29 replays the same windowed rounds at
# the same size (the churn as a Scenario), so the time goes there (PERF.md
# §4 names the cut)
CHURN_F32_WAVES = 3
CHURN_CUT = (1500, 500, 3, 10)
WINDOW = 256  # the service's commit_wave: windows of 256 pods
# cfg7-preempt-5k: (nodes, bound low-priority pods, fillers, preemptors);
# the byte-check cut, run for two rounds
PREEMPT = (5000, 20000, 400, 64)
PREEMPT_CUT = (500, 2000, 40, 16)
# K5 against its plain version on seeded problems: pods x nodes, resource
# columns, and (V, PDB, S) cases
K5_SEEDED = (64, 5000, 2, [(v, pdb, s) for v in (1, 4, 16) for pdb, s in ((0, 0), (16, 150))])
# cfg8-gang (the JAX package's bench run_gang): the scale leg, its parity
# leg, and the parity leg's plan on 4 nodes of 8 CPU in 3 zones, where
# members fail in four of the five waves and their gangs cascade (on 6 such
# nodes every member still fits)
GANG = dict(jobs=200, min_members=8, max_members=64, nodes=220, waves=5, seed=24)
GANG_WAVES = 5  # all 5 waves of the scale leg
GANG_PARITY = dict(jobs=24, min_members=2, max_members=8, nodes=40, waves=5, seed=23)
GANG_CUTS = {"parity": GANG_PARITY, "cascade": dict(GANG_PARITY, nodes=4)}
# K3 against its plain version on seeded planes: (P, N, n_true, W, WS,
# in-step width or None); rows that start at 0, visit nothing, visit more
# than n_true and wrap in each (seeded_planes); padded node columns and a
# fail plane of odd bytes (the planes after it at odd offsets: byte stores);
# rows over several partition tiles; in-step planes at aligned and odd
# offsets; north's widths (16-byte stores)
K3_SEEDED = [
    (1024, 512, 500, 384, 256, None), (7, 40, 37, 33, 9, None), (5, 1100, 1050, 1030, 1025, None),
    (6, 64, 64, 64, 16, 32), (3, 50, 45, 17, 7, 13), (64, 5120, 5000, 5120, 512, 512),
]
# K6 against its plain version on seeded problems: (K, G, N, D); at G 80 x
# D 5 000 and G 512 x D 5 000 the groups' bitmaps take several blocks
K6_SEEDED = [(k, 80, n, d) for k in (256, 2048) for n in (220, 5000) for d in (8, n)] + [(4096, 512, 5000, 5000)]
# K7 in both dtypes: (G, M, N, R, D) — a shape for each kernel shape that
# kernels.FEAS_TABLE picks (a warp a group, four groups a block, at N 60,
# 120 and, in float64, 220; blocks of 256 and 512 threads at N 220 to
# 8 000), the JAX bench's dispatch (G 64 x M 64 x N 220), the 5 000-node
# shapes under a zone and a hostname key, R 5 (the state in shared memory)
# and N 12 000 (in float64 the state in global scratch)
K7_SEEDED = [
    (16, 16, 60, 2, 4), (16, 16, 120, 2, 8), (64, 64, 220, 2, 8), (16, 16, 500, 2, 8), (16, 16, 2000, 2, 8),
    (16, 16, 4000, 2, 8), (16, 16, 8000, 2, 8), (256, 64, 5000, 2, 8), (256, 64, 5000, 2, 5000),
    (16, 16, 300, 5, 8), (32, 16, 12000, 2, 12000),
]
# cfg6-autoscale (the JAX package's bench run_autoscale, workloads.autoscale)
# and the autoscale burst (one estimate: 16 groups of the reference
# autoscaler's 64-copy max_nodes_per_scale_up, 10 000 pending pods)
AUTOSCALE = dict(n_pods=1500, seed_nodes=4, max_size=48, seed=11)
BURST = dict(n_groups=16, copies=64, n_pending=10_000, seed=11)
# BENCH_autoscaler.json's scale-ups (a CPU run of the JAX package): recorded
# beside the port's, not required
AUTOSCALE_REFERENCE = [["pool-small", 48], ["pool-big", 1]]
# Part A's probe: one node, one pod asking a byte more memory than it has
# (GCD 1, so float32 cannot hold the sums)
PROBE_NODE = {"metadata": {"name": "n0", "labels": {}},
              "status": {"allocatable": {"cpu": "4", "memory": "33554438", "pods": "110"}}}
PROBE_POD = {"metadata": {"name": "p0", "namespace": "default"},
             "spec": {"containers": [{"name": "c", "resources": {"requests": {"memory": "33554439"}}}]}}
# filters cfg5-vol must see reject at least one (pod, node) pair first
MUST_REJECT = ("NodePorts", "VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone")
DEVICE = "cuda"
# cfg9-stream (workloads.STREAM: the JAX bench's run_stream_report, 600
# nodes, 6 000 bound pods, 100 arrivals and 100 deletions a tick): each mode
# times STREAM_TICKS ticks after one priming tick, a cut of the bench's 320;
# the float64 leg against the CPU runs STREAM_F64_TICKS; result() is timed
# behind STREAM_SLEEP_CYCLES of sleep (~200 ms at the H100's 1.98 GHz)
STREAM_TICKS = 48
STREAM_F64_TICKS = 8
STREAM_MODES = ("sequential", "stream_off", "streamed")
STREAM_SLEEP_CYCLES = 400_000_000
# cfg11-scenario (workloads.SCENARIO: BASELINE cfg5's churn as one KEP-140
# Scenario, 5 000 nodes, 10 000 pods in 5 majors, a Deployment of 200 then
# 400 replicas) in float32 on the card; its float64 cut against the CPU; the
# store and service clocks (SimClock) it starts from
SCENARIO_F64 = dict(n_nodes=500, n_pods=1000, steps=5, web=20, cordon=10)
# the float32 run's depth, cut from workloads.SCENARIO's 10 000 pods in 5
# majors to pay for phase 34 (the first three majors keep the deletions,
# the rolling cordon and the Deployment's patch)
SCENARIO_F32 = dict(n_nodes=5000, n_pods=6000, steps=3, web=200, cordon=50)
SCENARIO_CLOCK = 1_700_000_000.0
# phase 30 (the lifecycle) on cfg9-stream's cluster: the ticks fed while the
# background loop runs, the loop's poll interval, its configuration (every
# node scored: a restart then restarts no rotation the twin's round would
# keep), a bad configuration and a valid other one
LIFECYCLE_TICKS = 10
LIFECYCLE_POLL_S = 0.05
LIFECYCLE_CFG = {"percentageOfNodesToScore": 100}
LIFECYCLE_BAD_CFG = {"profiles": [{"schedulerName": "default-scheduler",
                                   "plugins": {"multiPoint": {"enabled": [{"name": "NoSuchPlugin"}]}}}]}
LIFECYCLE_OTHER_CFG = {"profiles": [{"schedulerName": "default-scheduler",
                                     "plugins": {"multiPoint": {"disabled": [{"name": "ImageLocality"}]}}}],
                       "percentageOfNodesToScore": 100}
# phase 31 (cfg8-gang-journal): cfg8-gang's scale leg, its primary killed
# inside wave 4 (index 3)
JOURNAL_GANG = GANG
JOURNAL_KILL_WAVE = 3
# phase 32 (the scorer bridge at north): pending pods asked about over
# candidate lists of ``sample`` names, the first ``full`` of them over every
# node, and the pods bound before; phase 33: cfg2 pods scheduled through the
# extender
BRIDGE = dict(pods=16, sample=500, full=2, bound=5000)
# phase 32's second leg: cfg4's pods (inter-pod terms on every pod, spread
# on every 3rd) over seeded 500-name lists of its 5 000 nodes, its first
# 5 000 pods bound: spread domains and inter-pod terms reach past every
# candidate list, so the bridge's answers hold only if its kernel pass sees
# the cluster
BRIDGE_LEGS = {"north": BRIDGE, "cfg4": dict(pods=8, sample=500, full=0, bound=5000)}
EXTENDER_PODS = 64
# phase 35 (the fuzzer and kernel chaos): the sweep's seed and scenarios
# (fuzz.smoke.sweep, the KSS_FUZZ_* knobs' meaning); cfg2's chaos trip (the
# device events of a windowed round: its launch, then one a window fetched,
# so event 3 is the third window's fetch); cfg9-stream's chaos ticks and
# trips (a decision fetch, then the next wave's launch); the ProcessChaos
# scenario's seed and kill record
FUZZ_SWEEP = dict(seed=0, scenarios=10, shrink_steps=12, budget_s=0.0)
CHAOS_CFG2_TRIP = 3
CHAOS_STREAM_TICKS = 6
CHAOS_STREAM_EVENTS = (1, 3)
PROCESS_CHAOS = dict(seed=10, kill_record=7)
# the five-filter, five-score profile as a scheduler configuration
FIVE_CFG = {"percentageOfNodesToScore": 100, "profiles": [{"schedulerName": "default-scheduler", "plugins": {
    "multiPoint": {"enabled": [{"name": "PrioritySort"}, *({"name": n} for n in FIVE_FILTERS),
                               *({"name": n, "weight": w} for n, w in FIVE_SCORES if n not in FIVE_FILTERS),
                               {"name": "DefaultBinder"}],
                   "disabled": [{"name": "*"}]}}}]}
# what one BatchEngine round launches
ROUND_LAUNCHES = {
    "scan": 1, "scan_lanes": 0, "scan_sharded": 0, "scan_lanes_sharded": 0, "compact": 1, "scatter": 0, "preempt": 0,
    "gang_verdict": 0, "gang_feasibility": 0, "scan_population": 0, "objective": 0, "scan_grad": 0, "grad_contract": 0,
}
# cfg10-tune-10k (workloads.TUNE: the JAX bench's tune report at 1 250 nodes
# x 10 000 pods, seed 11, steps 8, pop 16, tau 50, lr 1) and the bench's own
# 12 x 96 size, the parity cut; the zero-drift and float-weight service
# rounds: the bench's zero-drift workload (imbalance, 10 nodes x 80 pods,
# seed 3) and seeded float weights
TUNE_PARITY = dict(n_nodes=12, n_pods=96)
TUNE_SERVICE = dict(n_nodes=10, n_pods=80, seed=3)
TUNE_FLOAT_WEIGHTS = [1.37, 2.05, 0.62, 2.5, 1.75, 0.9, 1.12]
# K2g against grad_plain: ||dg|| <= tol * ||g|| (the grad forward folds M in
# the cluster's order and over pods before F; the plain version sums each
# pod's terms with F)
K2G_TOL = {"float64": 1e-10, "float32": 1e-4}


def log(*a) -> None:
    print(*a, flush=True)


def kernel_degrades() -> dict:
    """``kernels.DEGRADES``: every kernel error this process degraded."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    return dict(K.DEGRADES)


class Phase:
    """A timed phase; it fails where it degraded a kernel error (a round,
    a streamed wave or an estimate finished on the sequential cycle), but
    where ``chaos`` says the phase injects them."""

    def __init__(self, name: str, chaos: bool = False):
        self.name = name
        self.chaos = chaos

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.degrades = kernel_degrades()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.3f} s")
            if not self.chaos and kernel_degrades() != self.degrades:
                raise AssertionError(f"{self.name}: kernel errors degraded outside the chaos phase: "
                                     f"{kernel_degrades()} (before: {self.degrades})")


def no_kernel_errors(fn, *args):
    """A worker job: ``fn(*args)``, failing where it degraded a kernel
    error in the worker's process."""
    before = kernel_degrades()
    out = fn(*args)
    if kernel_degrades() != before:
        raise AssertionError(f"{fn.__name__}{args}: kernel errors degraded: {kernel_degrades()} (before: {before})")
    return out


@contextlib.contextmanager
def python_renderer():
    """Every binding of the C renderer cleared, so the Python renderer
    render: the package's ``native.fastjson`` (the batch engine reads it at
    each call) and the ``_fastjson`` that utils/gojson.py and
    plugins/storereflector.py bind at import."""
    from kube_scheduler_simulator_tpu_torch import native
    from kube_scheduler_simulator_tpu_torch.plugins import storereflector as SR
    from kube_scheduler_simulator_tpu_torch.utils import gojson

    saved = (native.fastjson, gojson._fastjson, SR._fastjson)
    native.fastjson = gojson._fastjson = SR._fastjson = None
    try:
        yield
    finally:
        native.fastjson, gojson._fastjson, SR._fastjson = saved


@contextlib.contextmanager
def renderer_watch(what: str):
    """Count the commit's documents by path: ``materialize_wave`` calls
    (None: the wave took the per-pod Python functions) and per-pod filter
    pairs for the history (no escaped twin: the Python renderer).  With the
    renderer loaded (not cleared by ``python_renderer``), fail on either."""
    from kube_scheduler_simulator_tpu_torch import native
    from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchResult

    seen = {"waves": 0, "waves_none": 0, "pairs": 0, "pairs_no_twin": 0}
    mw, fp = BatchResult.materialize_wave, BatchResult.filter_annotation_pair

    def materialize_wave(self, js):
        out = mw(self, js)
        seen["waves"] += 1
        seen["waves_none"] += out is None
        return out

    def filter_annotation_pair(self, i, want_esc=True):
        out = fp(self, i, want_esc)
        if want_esc:
            seen["pairs"] += 1
            seen["pairs_no_twin"] += out[1] is None
        return out

    BatchResult.materialize_wave, BatchResult.filter_annotation_pair = materialize_wave, filter_annotation_pair
    try:
        yield seen
    finally:
        BatchResult.materialize_wave, BatchResult.filter_annotation_pair = mw, fp
    if native.fastjson is not None and (seen["waves_none"] or seen["pairs_no_twin"]):
        raise AssertionError(f"{what}: commit documents took the Python path ({seen})")


def stage_seconds(svc) -> dict:
    """The wave profiler's cumulative seconds of the commit's stages."""
    st = svc.profiler.snapshot()["stages"]
    return {s: st[s]["total_s"] for s in ("annotate", "store_mutate")}


def cuda_ms(fn, reps: int, warmup: int = 1):
    """(mean ms per call over ``reps`` calls timed with CUDA events, last
    result), after ``warmup`` untimed calls."""
    import torch

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s.record()
    for _ in range(reps):
        res = fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps, res


def device_ms(fn, reps: int, warmup: int = 3):
    """``timing.device_ms``: (ms a launch on the card with ``reps`` launches
    enqueued behind a sleep of the card, so they run back to back; ms a
    call on the host; the last result)."""
    from kube_scheduler_simulator_tpu_torch.timing import device_ms as timed

    return timed(fn, reps, warmup)


def host_and_cuda_us(fn, reps: int, warmup: int = 10) -> "tuple[float, float]":
    """(µs per call by CUDA events, µs per call on the host's clock) over the
    same ``reps`` back-to-back calls after ``warmup``: where the two agree,
    the card waits on the host between calls."""
    import torch

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) * 1e3 / reps, host * 1e6 / reps


def same(name: str, a, b) -> float:
    """Require bitwise-equal tensors; return max |a - b| (0.0)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
        diff = (a.double() - b.double()).abs()
        n_bad = int((diff != 0).sum()) if a.shape == b.shape else -1
        raise AssertionError(f"{name}: kernel and plain version differ ({n_bad} cells, {a.dtype}/{b.dtype})")
    return 0.0


def search_counts(args, outs) -> dict:
    """Bytes the victim search must move (every input read once, the three
    masks written once) and the operations its lanes do on these inputs:
    per (pod, node) lane, the V slot compares and the lower slots' R
    additions, the S same-window checks and the matching successes' R
    additions, the fit (3 per column and 4 more), the PDB counts (2 per
    matching lower slot and budget), and each active slot's reprieve (4 per
    column and 4 more)."""
    import torch

    (ucand, ureq, uprio, smask, sreq, snode, alloc, base_req, extra_req, base_cnt, extra_cnt, max_pods,
     vreq, vprio, vvalid, vmatch, allowed) = args
    U, N = ucand.shape
    R, V, S = alloc.shape[1], vprio.shape[1], snode.shape[0]
    lower = vvalid.unsqueeze(0) & (vprio.unsqueeze(0) < uprio.view(U, 1, 1))  # [U,N,V]
    n_low = int(lower.sum())
    hits = 0
    if S:
        onehot = snode.long().unsqueeze(0) == torch.arange(N, device=snode.device).unsqueeze(1)
        hits = int((smask.float() @ onehot.float().T).sum())  # [U,N] successes landing on each lane
    pdb_hits = int((vmatch.unsqueeze(0) & lower.unsqueeze(-1)).sum()) if vmatch.shape[2] else 0
    lanes = U * N
    ops = lanes * (2 * V + S + 3 * R + 4) + n_low * (R + 4 * R + 4) + hits * (R + 1) + 2 * pdb_hits
    nbytes = sum(t.numel() * t.element_size() for t in args) + sum(t.numel() * t.element_size() for t in outs)
    return {"bytes": nbytes, "ops": ops}


def seeded_search(U, N, R, V, PDB, S, dt, device, seed):
    """Seeded arguments of the victim search at a path's scale:
    integer-valued requests that keep every node full but leave room once
    its lower slots go, slots a prefix of each node's row, priorities 0-5
    with ties against the pods' 1-6, budgets of 0-2."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n_valid = rng.integers(0, V + 1, N)
    vvalid = np.arange(V)[None, :] < n_valid[:, None]
    vreq = rng.integers(0, 9, (N, V, R)) * vvalid[..., None]
    base_req = vreq.sum(axis=1) + rng.integers(0, 3, (N, R))
    base_cnt = n_valid + rng.integers(0, 3, N)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=d)  # noqa: E731
    return (
        t(rng.random((U, N)) < 0.9, torch.bool), f(rng.integers(0, 12, (U, R))), t(rng.integers(1, 7, U), torch.int64),
        t(rng.random((U, S)) < 0.5, torch.bool), f(rng.integers(0, 3, (S, R))), t(rng.integers(0, N, S), torch.int32),
        f(base_req + rng.integers(0, 4, (N, R))), f(base_req), f(rng.integers(0, 2, (N, R))), f(base_cnt),
        f(rng.integers(0, 2, N)), f(base_cnt + rng.integers(0, 3, N)), f(vreq),
        t(np.where(vvalid, -np.sort(-rng.integers(0, 6, (N, V)), axis=1), 0), torch.int64), t(vvalid, torch.bool),
        t((rng.random((N, V, PDB)) < 0.3) & vvalid[..., None], torch.bool), t(rng.integers(0, 3, PDB), torch.int32),
    )


def as_dtype(args, dt):
    """The victim search's arguments with the float tensors in ``dt``."""
    return tuple(a.to(dt) if a.is_floating_point() else a for a in args)


def same_outputs(name: str, kout: dict, pout: dict) -> float:
    """Require the same output keys and every output bitwise equal (the
    final carry field by field); return max |a - b| (0.0)."""
    if set(kout) != set(pout):
        raise AssertionError(f"{name} output keys differ: {set(kout) ^ set(pout)}")
    for k in pout:
        if k == "final_carry":
            for f, v in pout[k].items():
                same(f"{name} final carry {f}", kout[k][f].reshape(-1), v.reshape(-1))
        else:
            same(f"{name} {k}", kout[k], pout[k])
    return 0.0


def scan_counts(cfg, dims, dp, out) -> dict:
    """Bytes the scan must move and operations it must do on this input:
    every input the profile reads once, every output once (the score
    planes at their [P, ws0] width where the step compacts them, the final
    volume carries); the operations of each (pod, node) cell, and those of
    the pod's own spread constraints, inter-pod terms, host ports and
    volumes."""
    from kube_scheduler_simulator_tpu_torch.ops.batch import plugin_gates

    P, N, R = dims["P"], dims["N"], dims["R"]
    gates = plugin_gates(cfg, dims)
    fields = [
        "alloc", "max_pods", "nz_alloc", "pod_req", "pod_nonzero", "fit_checked", "taint_cls",
        "taint_prefer_cls", "taint_unsched_cls", "pod_tol_idx", "node_taint_idx", "node_unsched",
        "aff_code_cls", "aff_pref_cls", "pod_aff_idx", "pod_pref_idx", "node_label_idx", "img_cls",
        "pod_img_idx", "node_img_idx", "name_target", "pod_active", "node_active",
        "requested0", "nonzero0", "pod_count0",
    ]
    tensors = [getattr(dp, f) for f in fields]
    if gates["spread_filter"] or gates["spread_score"]:
        tensors += [dp.incl_cls, dp.node_domain, dp.spf_ku, dp.sps_ku, dp.spread_match, dp.spread_counts0]
        tensors += list(dp.spf) + list(dp.sps[:3])
    if gates["interpod"]:
        tensors += [getattr(dp, f) for f in (
            "gdom", "term_match", "ip_match_g", "ip_aff_g", "ip_anti_g", "ip_pref_g", "ip_pref_w", "ip_own_g",
            "ip_own_w", "ip_self_match", "ip_sel0", "ip_own0", "ip_anti0",
        )]
    if "VolumeBinding" in cfg.filters or "VolumeZone" in cfg.filters:
        tensors += [dp.vb_cls, dp.vz_cls, dp.pod_vol_idx]
    for gate, fields in (
        ("ports", ("port_cols", "port_conflict", "ports_used0")),
        ("restr", ("restr_cols", "restr_conflict", "restr_used0")),
        ("cloud", ("cloud_cnt", "cloud_used0")),
        ("csi", ("csi_cols", "csi_drv", "csi_seed_used", "csi_limit", "csi_attached0")),
    ):
        if gates[gate]:
            tensors += [getattr(dp, f) for f in fields]
    read = sum(t.numel() * t.element_size() for t in tensors)
    written = sum(t.numel() * t.element_size() for k, t in out.items() if k in (
        "packed_pod", "final_requested", "final_nonzero", "final_pod_count", "final_ports_used",
        "final_restr_used", "final_cloud_used", "final_csi_att", "final_spread_counts", "final_ip_sel",
        "final_ip_own", "final_ip_anti", "fail_plug", "fail_code",
        "feasible", "trace_meta") or k.startswith(("raw:", "norm:")))
    # per (pod, node) cell: filters (Fit: 2 + 3 per resource), the scan
    # step, Fit (12 per resource column), Balanced (12), two normalized
    # scores (6 each), the weighted sum (2 per score), select (2)
    per_cell = 4 + 2 + 3 * R + 2 + 12 * len(cfg.fit_resources) + 12 + 12 + 2 * len(cfg.scores) + 2
    ops = per_cell * P * N
    active = lambda t: (t >= 0).sum(dim=1).cpu().long()
    if gates["spread_filter"]:
        # domain sum, match + self, - min, compare, first code: 5 a node
        ops += 5 * N * int(active(dp.spf[0]).sum())
    if gates["spread_score"]:
        # domain sum, count x log, + (skew - 1), + running sum: 4 a node a
        # constraint; rint, extrema, normalization: 8 a node
        n_sps = active(dp.sps[0])
        ops += N * int((4 * n_sps + 8 * (n_sps > 0)).sum())
    if gates["interpod"]:
        terms = (dp.term_match != 0).sum(dim=0).cpu().long()  # groups matching each pod
        # filter: one check per group matching the pod, 2 per required
        # term; score: one add per matching group, 2 per preferred term,
        # min-max normalization 6
        per_pod = 2 * terms + 2 * (active(dp.ip_aff_g) + active(dp.ip_anti_g)) + 2 * active(dp.ip_pref_g) + 6
        ops += N * int(per_pod.sum())
    # VolumeBinding, VolumeZone: one read a cell each; host ports and
    # conflict volumes: one add a pod's class; a cloud limit the pod wants:
    # add and compare; CSI: per id k, the k ids' need count and the compare
    ops += P * N * sum(f in cfg.filters for f in ("VolumeBinding", "VolumeZone"))
    if gates["ports"] and "NodePorts" in cfg.filters:
        ops += N * int(active(dp.port_cols).sum())
    if gates["restr"]:
        ops += N * int(active(dp.restr_cols).sum())
    if gates["cloud"]:
        n_cloud = sum(f in cfg.filters for f in ("EBSLimits", "GCEPDLimits", "AzureDiskLimits"))
        ops += 2 * N * n_cloud * int((dp.cloud_cnt > 0).any(dim=1).sum())
    if gates["csi"]:
        k = active(dp.csi_cols)
        ops += N * int((k * k + 3 * k).sum())
    return {"bytes": read + written, "ops": ops}


def carry_bytes(cfg, dims, dp, dt, blocks: int) -> dict:
    """Bytes of the scan's per-block copies of the carries it keeps beside
    Fit's: PodTopologySpread's spread_counts [SG,N], InterPodAffinity's
    ip_sel, ip_own, ip_anti [G,D+1], and the volume carries ports_used
    [PT,N], restr_used [VR,N], cloud_used [3,N], the CSI count per driver
    [DR,N] in the working dtype and the CSI attachment bytes [V,N]."""
    from kube_scheduler_simulator_tpu_torch.ops.batch import plugin_gates

    size = 4 if str(dt).endswith("float32") else 8
    N = dims["N"]
    gates = plugin_gates(cfg, dims)
    topo = (dims["SG"] * N + 3 * dims["G"] * (dims["D"] + 1)) * size
    vol = {
        "ports": dp.ports_used0.shape[1] * N * size if gates["ports"] else 0,
        "restr": dp.restr_used0.shape[1] * N * size if gates["restr"] else 0,
        "cloud": 3 * N * size if gates["cloud"] else 0,
        "csi": dp.csi_attached0.shape[1] * N + dp.csi_seed_used.shape[1] * N * size if gates["csi"] else 0,
    }
    per_block = topo + sum(vol.values())
    return {"blocks": blocks, "topology": topo, **vol, "per_block": per_block, "total": per_block * blocks}


def bound(counts: dict, dt) -> "tuple[float, str]":
    """(least ms the card could take, "bytes" or "operations"): the bytes
    over the memory rate against the operations over the peak rate of the
    working dtype (float32, float64, or int32 for integer kernels)."""
    import torch

    t_bytes = counts["bytes"] / HBM_BYTES_PER_S * 1e3
    rate = {torch.float32: FP32_OPS_PER_S, torch.float64: FP64_OPS_PER_S, torch.int32: INT32_OPS_PER_S}[dt]
    t_ops = counts["ops"] / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compact_counts(out, manifest, W, WS, n_true) -> dict:
    """Bytes the compaction must move on this input (``time_scan.compact_bytes``)."""
    from kube_scheduler_simulator_tpu_torch.time_scan import compact_bytes

    return {"bytes": compact_bytes(out, manifest, W, WS, n_true), "ops": 0}


def seeded_planes(P, N, nt, ws0, code_max, rdt, dt, dev, rng) -> dict:
    """Seeded trace planes for the compaction: row 0 starts at 0 and
    visits nothing, row 1 visits more than n_true, row 2 wraps (start
    n_true - 2, 10 visited), the rest random; first failures in -1..4 with
    codes up to ``code_max``; score planes [P, ws0 or N] in ``dt``."""
    import numpy as np
    import torch

    start, proc = rng.integers(0, nt, P), rng.integers(1, nt + 5, P)
    start[0], proc[0] = 0, 0
    proc[1] = nt + 3
    start[2], proc[2] = nt - 2, 10
    hi = {"int8": 100, "int16": 30000, "int32": 1 << 22}[rdt]
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    out = {
        "sample_start": t(start.astype(np.int32)), "sample_processed": t(proc.astype(np.int32)),
        "fail_plug": t(rng.integers(-1, 5, (P, N)).astype(np.int8)),
        "fail_code": t(rng.integers(0, code_max + 1, (P, N)).astype(np.int32)),
        "feasible": t(rng.random((P, N)) < 0.5),
        "feasible_count": t(rng.integers(0, (ws0 or 1) + 2, P).astype(np.int32)),
    }
    for s, _w in FIVE_SCORES:
        out[f"raw:{s}"] = t(rng.integers(-hi, hi + 1, (P, ws0 or N))).to(dt)
        out[f"norm:{s}"] = t(rng.integers(0, 101, (P, ws0 or N))).to(dt)
    return out


def gather_sampled(full, ws0: int):
    """[P,N] planes → [P,ws0]: each row's sampled (feasible-plane) cells in
    ascending node id, the rest zero."""
    import torch

    feas = full["feasible"]
    pos = torch.cumsum(feas.to(torch.int32), 1) - 1
    dest = torch.where(feas & (pos < ws0), pos, ws0).long()
    out = {}
    for k, v in full.items():
        if k.startswith(("raw:", "norm:")):
            z = torch.zeros((v.shape[0], ws0 + 1), dtype=v.dtype, device=v.device)
            out[k] = z.scatter_(1, dest, v)[:, :ws0]
    return out


def make_cluster(name, cut=None):
    """(nodes, all pods, pending pods, volume objects) of a workload, or of
    its cut to (pods, nodes, bound pods)."""
    from kube_scheduler_simulator_tpu_torch import workloads

    w = WORKLOADS[name]
    P, N, n_bound = cut or (w.pods, w.nodes, w.bound)
    nodes, all_pods, pending = workloads.cluster(
        P, N, seed=42, n_bound=n_bound, spread=w.spread, interpod=w.interpod,
    )
    vols = {}
    if w.storage:
        workloads.add_host_ports(all_pods)
        vols = workloads.add_volumes(nodes, all_pods, n_bound)
    return nodes, all_pods, pending, vols


def engine(name, dt, device=DEVICE, mesh=None):
    from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine

    w = WORKLOADS[name]
    filters, scores = PROFILES[w.profile]
    return BatchEngine(
        filters=list(filters), scores=scores, percentage_of_nodes_to_score=w.pct,
        trace=True, tie_break=w.tie, seed=7, device=device, dtype=dt, mesh=mesh,
    )


def digest(s: str) -> str:
    import hashlib

    return hashlib.sha256(s.encode()).hexdigest()


def round_documents(res, P: int) -> "tuple[list, list]":
    """(selected node names, per pod the sha256 of its filter, score and
    finalScore annotation documents) of a round's first ``P`` pods."""
    docs = [(digest(res.filter_annotation_json(i)), *map(digest, res.score_annotations_json(i))) for i in range(P)]
    return list(res.selected_nodes[:P]), docs


def pod_digests(store) -> dict:
    """name → (node, sha256 of the annotations' keys and values and the
    status), without JSON-encoding the annotation strings: north's 10 000
    pods carry gigabytes of them."""
    import hashlib

    out = {}
    for p in store.list("pods", copy_objects=False):
        h = hashlib.sha256()
        for k, v in sorted((p["metadata"].get("annotations") or {}).items()):
            h.update(k.encode())
            h.update(b"\0")
            h.update(str(v).encode())
            h.update(b"\0")
        h.update(json.dumps(p.get("status"), sort_keys=True).encode())
        out[p["metadata"]["name"]] = ((p.get("spec") or {}).get("nodeName"), h.hexdigest())
    return out


def run_churn(spec, device, dt, waves=None, echo=True, digests=True):
    """Drive the churn through a SchedulerService on ``device``; returns
    (per-wave records, launches over all waves, pod digests after the last
    wave, or None without ``digests``: at full size they cost ~6 ms a MB of
    annotations).  On the card a wave fails on a scan
    or compaction count other than its window count and, after the first
    wave, on no scatter; on any device, on a batch fallback, a sequential
    pod or an unbound pod."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    pods, n_nodes, n_waves, cordon = spec
    store = ClusterStore(clock=lambda: 0.0)
    svc = None
    records, total = [], {"scan": 0, "compact": 0, "scatter": 0}
    gen = workloads.churn(store, pods, n_nodes, n_waves, cordon=cordon)
    for w in gen:
        if svc is None:
            svc = SchedulerService(store, tie_break="first", use_batch="auto", device=device, dtype=dt)
            svc.start_scheduler(None)
        eng = svc._batch_engine
        pl0 = (eng._placer.plane_reuses, eng._placer.scatter_updates, eng._placer.full_uploads) if eng else (0, 0, 0)
        c0, st0 = svc.stats["commit_s"], stage_seconds(svc)
        K.reset_counts()
        with renderer_watch(f"{device} wave {w}") as rendered:
            t0 = time.perf_counter()
            svc.schedule_pending(max_rounds=1)
            wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        eng = svc._batch_engine
        lt = eng.last_timings
        windows = int(lt.get("windows", 1))
        pl = eng._placer
        unbound = sum(1 for p in store.list("pods", copy_objects=False) if not (p.get("spec") or {}).get("nodeName"))
        rec = dict(
            wave=w, wall_s=wall, encode_s=lt["encode_s"], device_s=lt["device_s"],
            device_est_s=lt.get("device_est_s", 0.0), commit_s=svc.stats["commit_s"] - c0, windows=windows,
            **{f"{k}_s": v - st0[k] for k, v in stage_seconds(svc).items()}, rendered=dict(rendered),
            overlap=1 - lt["device_s"] / lt["device_est_s"] if lt.get("device_est_s") else 0.0,
            launches=launches, reuses=pl.plane_reuses - pl0[0], scatters=pl.scatter_updates - pl0[1],
            full_uploads=pl.full_uploads - pl0[2], scattered=pl.last_scattered, unbound=unbound,
            encode_stats={k: v for k, v in eng.encode_stats().items() if k.startswith("encode_")},
            stages={k: round(v, 4) for k, v in svc.profiler.snapshot()["last_wave"].items()},
            bound=headroom(eng.last_bound), promotions=dict(svc.stats["f64_promotions"]),
        )
        if echo:
            log(f"{device} {str(dt).split('.')[-1]} wave {w}: {json.dumps(rec, sort_keys=True)}")
        if device == DEVICE:
            if launches["scan"] != windows or launches["compact"] != windows:
                raise AssertionError(f"wave {w}: {launches} for {windows} windows")
            if w > 0 and launches["scatter"] == 0:
                raise AssertionError(f"wave {w}: the cordon reached no plane through the scatter kernel")
        if svc.stats["batch_fallbacks"] or svc.stats["sequential_pods"] or svc.stats["f64_promotions"]:
            raise AssertionError(f"{device} wave {w}: fallbacks {svc.stats['batch_fallbacks']}, "
                                 f"sequential pods {svc.stats['sequential_pods']}, "
                                 f"promotions {svc.stats['f64_promotions']}")
        if unbound:
            raise AssertionError(f"{device} wave {w}: {unbound} pods left unbound (every pod places at this size)")
        for k in total:
            total[k] += launches[k]
        records.append(rec)
        if waves is not None and w + 1 >= waves:
            break
    gen.close()
    return records, total, pod_digests(store) if digests else None


def run_preempt(spec, device, dt, max_rounds: int = 1, capture: "dict | None" = None, digests=True, mesh=None):
    """cfg7-preempt-5k (or its cut) through a SchedulerService on ``device``:
    one ``schedule_pending(max_rounds=max_rounds)``, the launch counters
    reset just before it.  With ``capture``, the first victim-search
    dispatch's arguments are kept there: the kernel's tensors
    (``capture["args"]``) and run_search's host inputs
    (``capture["run_search"]``, ``time_preempt.snapshot``'s bytes).  Returns
    (the call's record, pod digests after it (None without ``digests``), pod
    names by role)."""
    from kube_scheduler_simulator_tpu_torch import time_preempt as TP
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.preemption import kernel as PK
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    n_nodes, n_low, n_fillers, n_preemptors = spec
    store = ClusterStore(clock=lambda: 0.0)
    t0 = time.perf_counter()
    names = workloads.preemption_wave(store, n_nodes, n_low, n_fillers, n_preemptors)
    build_s = time.perf_counter() - t0
    svc = SchedulerService(store, tie_break="first", use_batch="auto", device=device, dtype=dt, mesh=mesh)
    svc.start_scheduler(None)
    launch, run_search = K.preempt, PK.run_search
    # host seconds building the victim-search tables (one per kernel run)
    prep_s = [0.0]
    prepare = svc._prepare_preemption

    def timed_prepare(*a):
        t = time.perf_counter()
        try:
            return prepare(*a)
        finally:
            prep_s[0] += time.perf_counter() - t

    svc._prepare_preemption = timed_prepare
    if capture is not None:
        def keep(*args, **kw):
            if "args" not in capture:
                capture["args"] = tuple(a.clone() for a in args)
            return launch(*args, **kw)

        def keep_host(pr, *args, **kw):
            if "run_search" not in capture:
                capture["run_search"] = TP.snapshot(pr, args, kw)
            return run_search(pr, *args, **kw)

        K.preempt, PK.run_search = keep, keep_host
    try:
        K.reset_counts()
        t0 = time.perf_counter()
        svc.schedule_pending(max_rounds=max_rounds)
        wall = time.perf_counter() - t0
    finally:
        K.preempt, PK.run_search = launch, run_search
    st = svc.stats
    pods = {p["metadata"]["name"]: p for p in store.list("pods", copy_objects=False)}
    pre = [pods[n] for n in names["preemptors"]]
    rec = dict(
        wall_s=wall, build_s=build_s, launches=dict(K.LAUNCHES), restarts=st["batch_restarts"],
        dispatches=st["preempt_dispatches"], preempt_kernel_s=st["preempt_kernel_s"],
        attempts=st["preempt_attempts"], nominations=st["preempt_nominations"],
        victims=st["preempt_victims"], commit_s=st["commit_s"], sequential_pods=st["sequential_pods"],
        batch_pods=st["batch_pods"], preempt_fallbacks=dict(st["preempt_fallbacks"]),
        batch_fallbacks=dict(st["batch_fallbacks"]),
        preemptors_bound=sum(1 for p in pre if (p.get("spec") or {}).get("nodeName")),
        preemptors_nominated=sum(
            1 for p in pre
            if not (p.get("spec") or {}).get("nodeName") and (p.get("status") or {}).get("nominatedNodeName")
        ),
        last_nominated=bool((pre[-1].get("status") or {}).get("nominatedNodeName"))
        and not (pre[-1].get("spec") or {}).get("nodeName"),
        evicted=len(names["low"]) - sum(1 for n in names["low"] if n in pods),
        prepare_s=prep_s[0], engine=dict(svc._batch_engine.cum_timings),
        bound=headroom(svc._batch_engine.last_bound), promotions=dict(st["f64_promotions"]),
        stages={k: v["total_s"] for k, v in svc.profiler.snapshot()["stages"].items()},
    )
    return rec, pod_digests(store) if digests else None, names


def preempt_phases(dev, cpu_preempt_ref) -> "tuple[dict, dict]":
    """Phases 11-14: K5 against its plain version on seeded problems, the
    cfg7-preempt-5k round on the card, K5 at that round's first dispatch,
    and the cut's CUDA against CPU float64 services (the CPU side from
    ``cpu_preempt_ref``, a pool result).  Returns (the round's record, K5's
    timing)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.preemption.kernel import preempt_plain

    U5, N5, R5, cases5 = K5_SEEDED
    with Phase(f"K5 kernel vs plain, seeded {U5} pods x {N5} nodes, V/PDB/S {cases5}"):
        k5_err = 0.0
        for c, (V5, PDB5, S5) in enumerate(cases5):
            for dt in (torch.float32, torch.float64):
                args = seeded_search(U5, N5, R5, V5, PDB5, S5, dt, dev, seed=100 + c)
                got = K.preempt(*args)
                want = preempt_plain(*args)
                for nm, a, b in zip(("cand", "victims", "viol"), got, want):
                    k5_err = max(k5_err, same(f"K5 V={V5} PDB={PDB5} S={S5} {dt} {nm}", a, b))
                log(f"V={V5} PDB={PDB5} S={S5} {str(dt).split('.')[-1]}: bitwise equal; cand {int(got[0].sum())}, "
                    f"victims {int(got[1].sum())}, viol {int(got[2].sum())}")

    P_n, P_low, P_fill, P_pre = PREEMPT
    captured: dict = {}
    with Phase(f"cfg7-preempt-5k {P_n} nodes, {P_low} bound, {P_fill} fillers, {P_pre} preemptors: service on the card, float32"):
        prec, _none, _names = run_preempt(PREEMPT, DEVICE, torch.float32, capture=captured, digests=False)
        log(f"cfg7-preempt-5k float32: {json.dumps(prec, sort_keys=True)}")
        want_restarts = prec["nominations"] - int(prec["last_nominated"])
        problems = []
        if prec["preempt_fallbacks"] or prec["batch_fallbacks"]:
            problems.append(f"fallbacks {prec['preempt_fallbacks']} {prec['batch_fallbacks']}")
        if prec["promotions"]:
            problems.append(f"promoted to float64 {prec['promotions']}")
        if prec["sequential_pods"]:
            problems.append(f"{prec['sequential_pods']} pods ran the sequential cycle")
        if prec["preemptors_bound"] + prec["preemptors_nominated"] != P_pre:
            problems.append(f"preemptors bound {prec['preemptors_bound']} + nominated {prec['preemptors_nominated']} != {P_pre}")
        if prec["nominations"] < 1 or prec["preemptors_nominated"] < 1:
            problems.append("no preemptor was nominated")
        if prec["restarts"] != want_restarts:
            problems.append(f"restarts {prec['restarts']} != nominations less the last pod's ({want_restarts})")
        if prec["launches"]["preempt"] != prec["dispatches"] or "args" not in captured:
            problems.append(f"K5 launches {prec['launches']['preempt']} != dispatches {prec['dispatches']}")
        if problems:
            raise AssertionError(f"cfg7-preempt-5k: {'; '.join(problems)}")

    with Phase("K5 kernel vs plain at cfg7-preempt-5k's first dispatch"):
        cargs = captured["args"]
        U1, N1 = cargs[0].shape
        shape5 = f"U={U1} N={N1} V={cargs[13].shape[1]} R={cargs[6].shape[1]} PDB={cargs[15].shape[2]} S={cargs[5].shape[0]}"
        for dt in (torch.float32, torch.float64):
            a = as_dtype(cargs, dt)
            got = K.preempt(*a)
            for nm, x, y in zip(("cand", "victims", "viol"), got, preempt_plain(*a)):
                k5_err = max(k5_err, same(f"K5 first dispatch {dt} {nm}", x, y))
        import numpy as np

        from kube_scheduler_simulator_tpu_torch import time_preempt as TP
        from kube_scheduler_simulator_tpu_torch.preemption import kernel as PK

        # the kernel is shorter than its call: timed back to back behind a
        # sleep (timing.device_ms), the call's host time beside it
        k5_ms, k5_host_ms, kout5 = device_ms(lambda: K.preempt(*cargs), 20)
        k5_plain_ms, _p = cuda_ms(lambda: preempt_plain(*cargs), 1, warmup=0)
        k5b, k5by = bound(search_counts(cargs, kout5), torch.float32)
        # the whole dispatch on the same inputs (run_search: the inputs in
        # one pinned copy, the kernel, the masks' one buffer out), its masks
        # the kernel's, and its stages by CUDA events (mean of 20), warm (the
        # problem's tables on the card) and cold (uploaded first, as every
        # dispatch of the cfg7 service is)
        _K5_DISPATCH.append(captured["run_search"])
        pr5, sargs, skw = TP.restore(captured["run_search"])
        masks = PK.run_search(pr5, *sargs, **skw, device=DEVICE, dtype=torch.float32)
        for nm, x in zip(("cand", "victims", "viol"), kout5):
            k5_err = max(k5_err, same(f"K5 dispatch {nm}", torch.from_numpy(np.ascontiguousarray(masks[nm])),
                                      x.cpu()))
        dispatch = {}
        for how in ("warm", "cold"):
            splits = []
            for _ in range(20):
                if how == "cold":
                    pr5._device = None
                sp: dict = {}
                PK.run_search(pr5, *sargs, **skw, device=DEVICE, dtype=torch.float32, split=sp)
                splits.append(sp)
            d = dispatch[how] = {k: float(np.mean([sp[k] for sp in splits])) for k in splits[0]}
            log(f"K5 dispatch, {how} (run_search, mean of 20): host staging {1e3 * d['stage_s']:.4f} ms, inputs in "
                f"{d['in_ms']:.4f} ms, kernel {d['kernel_ms']:.4f} ms, fetch {d['fetch_ms']:.4f} ms, "
                f"wall {1e3 * d['wall_s']:.4f} ms; its masks equal the kernel's")
        k5_t = dict(ms=k5_ms, host_ms=k5_host_ms, plain_ms=k5_plain_ms, bound_ms=k5b, bound_by=k5by, err=k5_err,
                    shape=shape5,
                    cand=int(kout5[0].sum()), victims=int(kout5[1].sum()), viol=int(kout5[2].sum()),
                    dispatch=dispatch)
        log(f"timing K5 {shape5}: {json.dumps(k5_t)}")

    with Phase(f"cfg7-preempt-5k cut to {PREEMPT_CUT}, two rounds: CUDA float64 service vs CPU float64 service"):
        grec, dig_g, _n = run_preempt(PREEMPT_CUT, DEVICE, torch.float64, max_rounds=2)
        log(f"cuda float64, two rounds: {json.dumps(grec, sort_keys=True)}")
        t0 = time.perf_counter()
        crec, dig_c = cpu_preempt_ref.get()
        log(f"CPU float64 service (worker process) waited for {time.perf_counter() - t0:.2f} s")
        log(f"cpu float64, two rounds: {json.dumps(crec, sort_keys=True)}")
        if dig_g.keys() != dig_c.keys():
            raise AssertionError(f"the CUDA and CPU services evicted different pods: {sorted(dig_g.keys() ^ dig_c.keys())[:5]}")
        bad = [n for n in dig_c if dig_g[n] != dig_c[n]]
        if bad:
            raise AssertionError(f"{len(bad)} pods differ between the CUDA and CPU services, first {bad[:3]}")
        if grec["launches"]["preempt"] < 1 or grec["nominations"] != crec["nominations"]:
            raise AssertionError(f"cut: K5 launches {grec['launches']['preempt']}, nominations {grec['nominations']} "
                                 f"vs CPU {crec['nominations']}")
        log(f"{len(dig_c)} pods: node, annotations and status byte-identical, same {grec['evicted']} evictions")
    return prec, k5_t


# ------------------------------------------------------ gang (K6, K7)

def seeded_verdict(K, G, N, D, device, seed):
    """Seeded window-verdict arguments: members of G groups, a tenth of the
    slots padding (-1) and a twentieth failed (-1 node); dom a hostname
    key (dom[g, n] = n) when D == N, else random domains below D."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G, K)
    gid[rng.random(K) < 0.1] = -1
    node = rng.integers(0, N, K)
    node[rng.random(K) < 0.05] = -1
    dom = np.tile(np.arange(N), (G, 1)) if D == N else rng.integers(0, D, (G, N))
    prior = rng.integers(0, 4, G)
    minm = rng.integers(1, max(2, 2 * K // G), G)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)  # noqa: E731
    return t(gid), t(node), t(dom), t(prior), t(minm), D


def verdict_counts(args, outs) -> dict:
    """Bytes the window verdict must move (the member slots, the domain cell
    of every placed member, the per-group inputs and outputs) and its
    integer operations (per slot: the pad and failure tests and one add; per
    placed member the domain mark; per group the bitmap popcounts and the
    quorum test)."""
    gid, node, dom, prior, minm, D = args
    K, G = gid.shape[0], dom.shape[0]
    placed = int(((gid >= 0) & (node >= 0)).sum())
    nbytes = 8 * K + 4 * placed + 8 * G + sum(t.numel() * t.element_size() for t in outs)
    ops = 3 * K + 3 * placed + G * ((D + 31) // 32 + 4)
    return {"bytes": nbytes, "ops": ops}


def feasibility_counts(args, outs) -> dict:
    """Bytes the feasibility scan must move (every input once, the outputs
    once) and its operations on these inputs: per valid slot and node the R
    column compares, the budget test, the rank and the argmax step; per
    valid slot the commit (R + 2)."""
    req, valid, free, cnt, dom, D = args
    N, R = free.shape
    slots = int(valid.sum())
    nbytes = sum(t.numel() * t.element_size() for t in (req, valid, free, cnt, dom)) + sum(
        t.numel() * t.element_size() for t in outs)
    return {"bytes": nbytes, "ops": slots * (N * (R + 4) + R + 2)}


def bench_args(store, device, dt) -> tuple:
    """K7's arguments of the JAX bench's standalone feasibility dispatch on
    ``store`` (time_gang.bench_problem), in ``dt`` on ``device``."""
    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch.time_gang import bench_problem

    pr = bench_problem(store)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    return (f(pr.req), torch.from_numpy(np.asarray(pr.valid, dtype=bool)).to(device), f(pr.free), f(pr.cnt_free),
            torch.from_numpy(np.ascontiguousarray(pr.dom, dtype=np.int32)).to(device), max(int(pr.D), 1))


def gang_node_small(i: int) -> dict:
    """A node of tests/test_gang.py's churn: 8 CPU, 64Gi, 110 pods, 3 zones."""
    return {
        "metadata": {"name": f"node-{i}", "labels": {"kubernetes.io/hostname": f"node-{i}",
                                                     "topology.kubernetes.io/zone": f"zone-{i % 3}"}},
        "status": {"allocatable": {"cpu": "8", "memory": "64Gi", "pods": "110"}},
    }


def run_gang(spec, device, dt, capture: "dict | None" = None, echo=True, small_nodes=False, strict=True,
             waves: "int | None" = None, digests: bool = True):
    """cfg8-gang (or a cut) through a SchedulerService on ``device`` under
    the gang profile: one ``schedule_pending(max_rounds=3)`` a wave (the
    first ``waves`` of them, or all), the launch counters reset just before
    it.  With ``capture``, the first
    verdict dispatch's arguments are kept there.  A wave fails on a verdict
    mismatch, a partially bound group, a gang or batch fallback, or (on the
    card) verdict launches other than the dispatches; with ``strict``, also
    on an unbound member or dispatches other than one a replay window.
    Returns (per-wave records, total launches, (the pod digests after each
    wave, the events' digest; None without ``digests``), the store, the
    service)."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config, partially_bound_groups
    from kube_scheduler_simulator_tpu_torch.gang import kernel as GK
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    store = ClusterStore(clock=lambda: 0.0)
    svc = None
    records, total, wave_digests = [], {k: 0 for k in K.LAUNCHES}, []
    verdict = GK.window_verdict
    if capture is not None:
        def keep(*args, **kw):
            if "args" not in capture:
                capture["args"] = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
            return verdict(*args, **kw)

        GK.window_verdict = keep
    keys = ("gang_parked", "gang_released_groups", "gang_released_pods", "gang_kernel_dispatches",
            "gang_kernel_s", "gang_verdict_mismatch", "commit_s", "sequential_pods", "batch_pods")
    try:
        gen = workloads.gang_churn(store, node=gang_node_small if small_nodes else workloads.mk_node, **spec)
        for w in gen:
            if svc is None:
                svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0,
                                       device=device, dtype=dt)
                svc.start_scheduler(gang_scheduler_config())
            st0, sg0 = {k: svc.stats[k] for k in keys}, stage_seconds(svc)
            K.reset_counts()
            with renderer_watch(f"{device} gang wave {w}") as rendered:
                t0 = time.perf_counter()
                svc.schedule_pending(max_rounds=3)
                wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            st = svc.stats
            delta = {k: st[k] - st0[k] for k in keys}
            members = [p for p in store.list("pods", copy_objects=False) if (p["metadata"].get("labels") or {})]
            unbound = sum(1 for p in members if not (p.get("spec") or {}).get("nodeName"))
            partial = partially_bound_groups(store)
            eng = svc._batch_engine
            lt = eng.last_timings if eng is not None else {}
            rec = dict(
                wave=w, wall_s=wall, pods=len(members), unbound=unbound, windows=int(lt.get("windows", 1)),
                encode_s=lt.get("encode_s", 0.0), device_s=lt.get("device_s", 0.0), launches=launches,
                promotions=dict(st["f64_promotions"]), waiting=len(svc.framework.waiting_pods), **delta,
                **{f"{k}_s": v - sg0[k] for k, v in stage_seconds(svc).items()}, rendered=dict(rendered),
                stages={k: round(v, 4) for k, v in svc.profiler.snapshot()["last_wave"].items()},
            )
            if echo:
                log(f"{device} {str(dt).split('.')[-1]} gang wave {w}: {json.dumps(rec, sort_keys=True)}")
            problems = []
            if delta["gang_verdict_mismatch"]:
                problems.append(f"{delta['gang_verdict_mismatch']} verdict mismatches")
            if partial:
                problems.append(f"partially bound groups {partial[:3]}")
            if st["gang_fallbacks"] or st["batch_fallbacks"]:
                problems.append(f"fallbacks {st['gang_fallbacks']} {st['batch_fallbacks']}")
            if device == DEVICE and launches["gang_verdict"] != delta["gang_kernel_dispatches"]:
                problems.append(f"K6 launches {launches['gang_verdict']} != dispatches {delta['gang_kernel_dispatches']}")
            if strict and unbound:
                problems.append(f"{unbound} members unbound")
            if strict and delta["gang_kernel_dispatches"] != rec["windows"]:
                problems.append(f"{delta['gang_kernel_dispatches']} verdict dispatches for {rec['windows']} windows")
            if problems:
                raise AssertionError(f"{device} gang wave {w}: {'; '.join(problems)}")
            for k in total:
                total[k] += launches[k]
            records.append(rec)
            if digests:
                wave_digests.append(pod_digests(store))
            if waves is not None and len(records) >= waves:
                break
        gen.close()
    finally:
        GK.window_verdict = verdict
    if not digests:
        return records, total, None, store, svc
    events = [(e["metadata"]["name"], e["reason"], e["message"], e["type"])
              for e in store.list("events", copy_objects=False)]
    return records, total, (wave_digests, digest(json.dumps(sorted(events)))), store, svc


STREAM_STAGES = ("admit", "encode", "upload", "dispatch", "device_blocked", "trace_fetch", "annotate", "store_mutate")


def run_stream(device, dt, mode: str, ticks: int, sleep_check: bool = False) -> "tuple[dict, str]":
    """cfg9-stream (``workloads.STREAM``) through a SchedulerService on
    ``device`` in ``mode`` ("sequential": ``schedule_pending`` a tick;
    "stream_off" / "streamed": ``schedule_stream(streaming=...)``): one
    priming tick, then ``ticks`` timed ticks, the launch counters reset just
    before them and read just after.  Each streamed wave's own launches are
    counted apart (``schedule_async`` and its first ``decisions()`` wrapped:
    deltas of the counters, never a reset).  Returns (record, sha256 of the
    final store's ``pod_parity_state``).  On the card a run fails on a batch
    fallback, a sequential pod, a promotion, an unbound pod, or, streamed, a
    drain, no overlap, waves other than ticks, or a wave that did not launch
    one scan and one compaction.  ``sleep_check``: after the timed run, one more wave's
    ``result()`` is timed behind a sleep of the card enqueued after its
    ``decisions()`` (standing in for the next wave's scan): it must not wait
    for the sleep."""
    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler import batch_engine as BE
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.parity import parity_digest

    cfg9 = workloads.STREAM
    t_build = time.perf_counter()
    store = ClusterStore(clock=lambda: 1_700_000_000.0)
    settled = workloads.stream_cluster(store, cfg9["n_nodes"], cfg9["seed_bound"])
    svc = SchedulerService(store, tie_break="first", use_batch="force", device=device, dtype=dt)
    svc.start_scheduler(None)
    build_s = time.perf_counter() - t_build

    def drive(n_ticks: int, start: int) -> dict:
        feed = workloads.steady_feed(store, settled, n_ticks, start, cfg9["per_tick"], cfg9["seed_bound"])
        if mode == "sequential":
            tick, alive, results = 0, True, {}
            while alive:
                alive = feed(tick)
                tick += 1
                results.update(svc.schedule_pending())
            return results
        return svc.schedule_stream(feed=feed, streaming=mode == "streamed")

    waves: list = []
    sa, dec = BE.BatchEngine.schedule_async, BE.PendingBatch.decisions

    def schedule_async(self, *a, **kw):
        c0 = dict(K.LAUNCHES)
        pb = sa(self, *a, **kw)
        pb.smoke_launches = {k: K.LAUNCHES[k] - c0[k] for k in c0}
        waves.append(pb.smoke_launches)
        return pb

    def decisions(self):
        first, c0 = self._out is None, dict(K.LAUNCHES)
        out = dec(self)
        if first:
            for k in c0:
                self.smoke_launches[k] += K.LAUNCHES[k] - c0[k]
        return out

    drive(1, 0)  # the priming tick
    eng = svc._batch_engine
    enc0, pl = eng.encode_stats(), eng._placer
    pl0 = (pl.plane_reuses, pl.scatter_updates, pl.full_uploads, pl.bytes_uploaded)
    st0 = svc.profiler.snapshot()["stages"]
    keys = ("stream_waves", "stream_pods", "stream_overlap_s", "stream_stall_s")
    s0 = {k: svc.stats[k] for k in keys}
    for k in STREAM_STAGES:
        svc.profiler.totals[k][2] = 0.0  # each stage's max over the timed run
    BE.BatchEngine.schedule_async, BE.PendingBatch.decisions = schedule_async, decisions
    try:
        if device == DEVICE:
            torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        results = drive(ticks, cfg9["per_tick"])
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        BE.BatchEngine.schedule_async, BE.PendingBatch.decisions = sa, dec
    st1 = svc.profiler.snapshot()["stages"]
    stages = {k: {"count": st1[k]["count"] - st0[k]["count"], "total_s": st1[k]["total_s"] - st0[k]["total_s"],
                  "max_s": st1[k]["max_s"]} for k in STREAM_STAGES}
    up = stages["upload"]
    stream = {k: svc.stats[k] - s0[k] for k in keys}
    boundary = stream["stream_overlap_s"] + stream["stream_stall_s"]
    enc1 = eng.encode_stats()
    scheduled = sum(1 for r in results.values() if r.success)
    unbound = sum(1 for p in store.list("pods", copy_objects=False) if not (p.get("spec") or {}).get("nodeName"))
    per_wave = sorted({json.dumps({k: v for k, v in w.items() if v}, sort_keys=True) for w in waves})
    rec = dict(
        mode=mode, dtype=str(dt).split(".")[-1], ticks=ticks, build_s=build_s, wall_s=wall, scheduled=scheduled,
        pods_per_s=scheduled / wall, **stream,
        overlap_efficiency=stream["stream_overlap_s"] / boundary if boundary > 0 else 0.0,
        drains=dict(svc.stats["stream_drains"]), launches=launches, waves_launched=len(waves),
        per_wave_launches=per_wave, stages=stages,
        upload_mean_ms=1e3 * up["total_s"] / up["count"] if up["count"] else 0.0,
        upload_max_ms=1e3 * up["max_s"], unbound=unbound,
        placer=dict(reuses=pl.plane_reuses - pl0[0], scatters=pl.scatter_updates - pl0[1],
                    full_uploads=pl.full_uploads - pl0[2], bytes_uploaded=pl.bytes_uploaded - pl0[3],
                    last=sorted({f"{k[0]}:{v[0]}" for k, v in pl.decisions.items() if v[0] != "reuse"})),
        encode={k: enc1[k] - enc0.get(k, 0) for k in enc1 if k.startswith("encode_") and isinstance(enc1[k], int)},
        fallbacks=dict(svc.stats["batch_fallbacks"]), sequential_pods=svc.stats["sequential_pods"],
        promotions=dict(svc.stats["f64_promotions"]),
    )
    if device == DEVICE:
        if rec["fallbacks"] or rec["sequential_pods"] or rec["promotions"] or unbound:
            raise AssertionError(f"cfg9-stream {mode}: {json.dumps(rec)}")
        if mode == "streamed":
            if stream["stream_waves"] != ticks or stream["stream_overlap_s"] <= 0 or rec["drains"]:
                raise AssertionError(f"cfg9-stream streamed: waves {stream['stream_waves']}, overlap "
                                     f"{stream['stream_overlap_s']}, drains {rec['drains']}")
            bad = [w for w in waves if w["scan"] != 1 or w["compact"] != 1]
            if bad or len(waves) != stream["stream_waves"]:
                raise AssertionError(f"cfg9-stream: {len(waves)} waves launched for {stream['stream_waves']} "
                                     f"committed; waves not one scan and one compaction: {bad[:3]}")
            if launches["scan"] != len(waves) or launches["compact"] != len(waves):
                raise AssertionError(f"cfg9-stream: launches {launches} for {len(waves)} waves")
    final = parity_digest(store)
    if sleep_check:
        # one more tick's wave, launched as the stream launches it; after its
        # decisions() the card sleeps, as if the next wave's scan ran there
        workloads.steady_feed(store, settled, 1, cfg9["per_tick"] * (ticks + 1), cfg9["per_tick"],
                              cfg9["seed_bound"])(0)
        fw = svc.framework
        pending = fw.sort_pods(svc._ready_pending())
        pb = eng.schedule_async(store.list("nodes", copy_objects=False), store.list("pods", copy_objects=False),
                                pending, store.list("namespaces", copy_objects=False),
                                base_counter=fw.sched_counter, start_index=fw.next_start_node_index)
        pb.decisions()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(STREAM_SLEEP_CYCLES)
        e1.record()
        t0 = time.perf_counter()
        res = pb.result()
        result_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        rest_ms = 1e3 * (time.perf_counter() - t0)
        sleep_ms = e0.elapsed_time(e1)
        rec["sleep_check"] = dict(pods=len(pending), scheduled=int((res.selected[: len(pending)] >= 0).sum()),
                                  sleep_ms=sleep_ms, result_ms=result_ms, rest_of_sleep_ms=rest_ms)
        if result_ms > 0.25 * sleep_ms or rest_ms < 0.5 * sleep_ms:
            raise AssertionError(f"result() waited for the work enqueued after decisions(): {rec['sleep_check']}")
    return rec, final


def stream_phases(dev, cpu_stream_ref) -> dict:
    """cfg9-stream: the three modes in float32 on the card, equal digests;
    ``result()`` behind a sleep of the card; the CUDA float64 streamed run
    against the CPU's.  Returns the streamed run's record."""
    import torch

    recs, digests = {}, {}
    for mode in STREAM_MODES:
        with Phase(f"cfg9-stream {mode}, {STREAM_TICKS} ticks after one priming tick, float32, on the card"):
            gc.collect()  # the previous mode's store
            recs[mode], digests[mode] = run_stream(DEVICE, torch.float32, mode, STREAM_TICKS,
                                                   sleep_check=mode == "streamed")
            log(f"cfg9-stream {mode}: {json.dumps(recs[mode], sort_keys=True)}; digest {digests[mode]}")
    with Phase("cfg9-stream: the three modes' final stores"):
        if recs["streamed"]["stream_waves"] < 40:
            raise AssertionError(f"cfg9-stream: {recs['streamed']['stream_waves']} streamed waves (40 at least)")
        if len(set(digests.values())) != 1:
            raise AssertionError(f"cfg9-stream: the modes' final stores differ: {digests}")
        w = {m: recs[m]["wall_s"] for m in STREAM_MODES}
        log(f"{len(STREAM_MODES)} digests equal ({digests['streamed']}); walls {json.dumps(w)}; streamed speedup "
            f"vs sequential {w['sequential'] / w['streamed']:.3f}, vs stream_off {w['stream_off'] / w['streamed']:.3f}")
    with Phase(f"cfg9-stream cut to {STREAM_F64_TICKS} ticks: CUDA float64 streamed vs CPU float64 streamed"):
        rec64, dig64 = run_stream(DEVICE, torch.float64, "streamed", STREAM_F64_TICKS)
        t0 = time.perf_counter()
        cpu_rec, cpu_dig = cpu_stream_ref.get()
        log(f"CPU float64 streamed run (worker process) waited for {time.perf_counter() - t0:.2f} s; "
            f"cuda {json.dumps({k: rec64[k] for k in ('wall_s', 'stream_waves', 'drains')})} "
            f"cpu {json.dumps({k: cpu_rec[k] for k in ('wall_s', 'stream_waves', 'drains')})}")
        if dig64 != cpu_dig or rec64["stream_waves"] != cpu_rec["stream_waves"]:
            raise AssertionError(f"cfg9-stream float64: CUDA {dig64} ({rec64['stream_waves']} waves) vs CPU "
                                 f"{cpu_dig} ({cpu_rec['stream_waves']} waves)")
        log(f"CUDA and CPU float64 streamed stores equal ({dig64})")
    return recs["streamed"]


def autoscale_scenario() -> dict:
    """The JAX package's autoscale replay (tests/test_autoscaler.py
    ``_autoscale_scenario``): a NodeGroup ``pool`` (0 to 4 nodes of 4 CPU,
    8Gi, 20 pods) at major 1, four pods of 3 CPU and 1Gi at major 2, done at
    major 3."""
    template = {"metadata": {"labels": {}}, "spec": {},
                "status": {"allocatable": {"cpu": "4000m", "memory": "8Gi", "pods": "20"}}}
    ops = [{"id": "1", "step": {"major": 1}, "createOperation": {"typeMeta": {"kind": "NodeGroup"}, "object": {
        "metadata": {"name": "pool"}, "spec": {"minSize": 0, "maxSize": 4, "priority": 0, "template": template}}}}]
    for i in range(4):
        ops.append({"id": str(2 + i), "step": {"major": 2}, "createOperation": {"typeMeta": {"kind": "Pod"}, "object": {
            "metadata": {"name": f"p{i}", "namespace": "default", "labels": {}},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "3000m", "memory": "1Gi"}}}]}}}})
    ops.append({"id": "done", "step": {"major": 3}, "doneOperation": {}})
    return {"metadata": {"name": "autoscale-scn", "namespace": "default"}, "spec": {"operations": ops}}


def run_scenario(device, dt, spec: dict, echo: bool = True):
    """cfg11-scenario (``workloads.scenario_churn(**spec)``) through
    ``ScenarioEngine(store, SchedulerService(store, tie_break="first",
    use_batch="auto"), ControllerManager(store)).run`` on ``device``, the
    store and service clocks pinned (SimClock), the launch counters reset
    just before the run and read just after (and at the end of each major's
    convergence pass).  Returns (record, the returned Scenario, store,
    service).  A run fails on a phase other than Succeeded, an unbound pod,
    a pod count other than the scenario's, a podScheduled count other than
    the bindings, a delete count other than the delete operations, a batch
    fallback, a sequential pod, or (float32 on the card) a promotion or no
    scan, compaction or scatter launch."""
    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.controllers import ControllerManager
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scenario import ScenarioEngine
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

    scn = workloads.scenario_churn(**spec)
    store = ClusterStore(clock=SimClock(SCENARIO_CLOCK))
    svc = SchedulerService(store, tie_break="first", use_batch="auto", device=device, dtype=dt, clock=SimClock(0.0))
    svc.start_scheduler(None)
    engine = ScenarioEngine(store, svc, ControllerManager(store))
    marks: list = []
    converge = engine._run_controllers_to_convergence

    def timed(major, minor):
        events = converge(major, minor)
        marks.append((major, time.perf_counter(), dict(K.LAUNCHES)))
        return events

    engine._run_controllers_to_convergence = timed
    if device == DEVICE:
        torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    out = engine.run(scn)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    majors, prev_t, prev_l = [], t0, {k: 0 for k in launches}
    for major, t, lc in marks:
        majors.append(dict(major=major, wall_s=t - prev_t,
                           launches={k: lc[k] - prev_l[k] for k in lc if lc[k] != prev_l[k]}))
        prev_t, prev_l = t, lc
    tl = out["status"]["scenarioResult"]["timeline"]
    ops = scn["spec"]["operations"]
    pods = store.list("pods", copy_objects=False)
    per_step = spec["n_pods"] // spec["steps"]
    deleted = sum(1 for op in ops if op.get("deleteOperation") is not None)
    m = svc.metrics()
    eng = svc._batch_engine
    rec = dict(
        dtype=str(dt).split(".")[-1], phase=out["status"]["phase"], wall_s=wall, majors=majors, launches=launches,
        pods=len(pods), unbound=sum(1 for p in pods if not (p.get("spec") or {}).get("nodeName")),
        pod_scheduled_events=sum("podScheduled" in ev for evs in tl.values() for ev in evs),
        delete_events=sum("delete" in ev for evs in tl.values() for ev in evs), delete_operations=deleted,
        allocation_rate=out["status"]["scenarioResult"]["summary"]["allocationRate"],
        metrics={k: m[k] for k in ("batch_pods", "batch_commits", "engine_rounds", "commit_s", "overlap_efficiency",
                                   "commit_waves", "sequential_pods", "engine_compiles", "engine_cache_entries")},
        fallbacks=m["batch_fallbacks"], promotions=dict(svc.stats["f64_promotions"]),
        encode={k: v for k, v in eng.encode_stats().items() if k.startswith("encode_")} if eng else {},
        placer=dict(full_uploads=eng._placer.full_uploads, scatters=eng._placer.scatter_updates) if eng else {},
        kernel_launches=dict(K.LAUNCHES),
    )
    if echo:
        log(f"cfg11-scenario {device} {rec['dtype']}: {json.dumps(rec, sort_keys=True)}")
    want_pods = spec["steps"] * per_step - deleted + 2 * spec["web"]
    bad = []
    if rec["phase"] != "Succeeded":
        bad.append(f"phase {rec['phase']} ({out['status'].get('message')})")
    if rec["unbound"] or rec["pods"] != want_pods:
        bad.append(f"{rec['unbound']} unbound of {rec['pods']} pods ({want_pods} expected)")
    if rec["pod_scheduled_events"] != spec["steps"] * per_step + 2 * spec["web"]:
        bad.append(f"{rec['pod_scheduled_events']} podScheduled events")
    if rec["delete_events"] != deleted:
        bad.append(f"{rec['delete_events']} delete events for {deleted} delete operations")
    if rec["fallbacks"] or m["sequential_pods"]:
        bad.append(f"fallbacks {rec['fallbacks']}, sequential pods {m['sequential_pods']}")
    if device == DEVICE:
        if dt == torch.float32 and rec["promotions"]:
            bad.append(f"promotions {rec['promotions']}")
        if not (launches["scan"] and launches["compact"] and launches["scatter"]):
            bad.append(f"launches {launches}")
    if bad:
        raise AssertionError(f"cfg11-scenario {device} {rec['dtype']}: {'; '.join(bad)}")
    return rec, out, store, svc


def run_autoscale_scenario(device, dt) -> "tuple[dict, str]":
    """The autoscale replay under ``autoscale="scenario"`` (sequential
    rounds, the least-waste expander; each scale-up estimate one lane-scan
    launch, K8, on the card), the store clock frozen: (record, sha256 of the
    timeline).  Fails on a phase other than Succeeded, no scale-up, an
    estimate other than "xla-batch", a pod left pending, or (on the card) no
    K8 launch."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scenario import ScenarioEngine
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    store = ClusterStore(clock=lambda: 0.0)
    svc = SchedulerService(store, tie_break="first", use_batch="off", autoscale="scenario",
                           autoscaler_opts={"expander": "least-waste"}, device=device, dtype=dt)
    svc.start_scheduler(None)
    K.reset_counts()
    t0 = time.perf_counter()
    out = ScenarioEngine(store, svc, None).run(autoscale_scenario())
    wall = time.perf_counter() - t0
    tl = out["status"]["scenarioResult"]["timeline"]
    acts = [ev["autoscale"] for evs in tl.values() for ev in evs if "autoscale" in ev]
    rec = dict(phase=out["status"]["phase"], wall_s=wall, k8_launches=K.LAUNCHES["scan_lanes"],
               actions=[(a["action"], a["nodeGroup"], a.get("method")) for a in acts],
               allocation_rate=out["status"]["scenarioResult"]["summary"]["allocationRate"],
               nodes=len(store.list("nodes", copy_objects=False)))
    if (rec["phase"] != "Succeeded" or not acts or acts[0]["action"] != "ScaleUp"
            or {a.get("method") for a in acts if a["action"] == "ScaleUp"} != {"xla-batch"}
            or rec["allocation_rate"] != 1.0 or (device == DEVICE and not rec["k8_launches"])):
        raise AssertionError(f"autoscale scenario on {device}: {json.dumps(rec)}")
    return rec, digest(json.dumps(tl, sort_keys=True))


def scenario_phases(dev, cpu_scenario_ref, cpu_autoscale_scenario_ref) -> "tuple[dict, dict, tuple]":
    """Phase 29: cfg11-scenario on the card in float32, its float64 cut
    against the CPU's, the autoscale replay against the CPU's.  Returns
    (the float32 run's record, the autoscale replay's record, the float64
    cut's (store, service) for phase 30)."""
    import torch

    with Phase(f"cfg11-scenario cut to {json.dumps(SCENARIO_F32)}, float32, on the card"):
        gc.collect()
        rec, _out, _store, _svc = run_scenario(DEVICE, torch.float32, SCENARIO_F32, echo=False)
        del _out, _store, _svc
        log(f"replay wall {rec['wall_s']:.3f} s; majors " + ", ".join(
            f"{m['major']}: {m['wall_s']:.3f} s {json.dumps(m['launches'], sort_keys=True)}" for m in rec["majors"]))
        log(f"metrics(): {json.dumps(rec['metrics'], sort_keys=True)}; allocation rate {rec['allocation_rate']}")
        log(f"launches {json.dumps(rec['launches'], sort_keys=True)}; podScheduled {rec['pod_scheduled_events']}, "
            f"delete {rec['delete_events']} (operations {rec['delete_operations']}), pods {rec['pods']}, "
            f"encode {json.dumps(rec['encode'], sort_keys=True)}, placer {json.dumps(rec['placer'])}")
        gc.collect()
    with Phase(f"cfg11-scenario cut {json.dumps(SCENARIO_F64)}: CUDA float64 vs CPU float64"):
        rec64, out64, store64, svc64 = run_scenario(DEVICE, torch.float64, SCENARIO_F64, echo=False)
        got = (digest(json.dumps(out64, sort_keys=True)), digest(json.dumps(store64.dump(), sort_keys=True)))
        del out64
        t0 = time.perf_counter()
        cpu_rec, want = cpu_scenario_ref.get()
        log(f"CPU float64 replay (worker process) waited for {time.perf_counter() - t0:.2f} s; cuda wall "
            f"{rec64['wall_s']:.3f} s launches {json.dumps(rec64['launches'], sort_keys=True)}; cpu wall "
            f"{cpu_rec['wall_s']:.3f} s")
        if got != want:
            raise AssertionError(f"cfg11-scenario float64 cut: CUDA (scenario, dump) {got} vs CPU {want}")
        log(f"the returned Scenarios and the store dumps byte-equal ({got[0][:16]}, {got[1][:16]})")
    with Phase("the autoscale replay (autoscale=\"scenario\"), CUDA float64 vs CPU float64"):
        arec, adig = run_autoscale_scenario(DEVICE, torch.float64)
        cpu_arec, cpu_adig = cpu_autoscale_scenario_ref.get()
        log(f"cuda {json.dumps(arec, sort_keys=True)}; cpu {json.dumps(cpu_arec, sort_keys=True)}")
        if adig != cpu_adig:
            raise AssertionError(f"autoscale replay: CUDA timeline {adig} vs CPU {cpu_adig}")
        log(f"timelines equal ({adig[:16]}); K8 launched {arec['k8_launches']} times")
    return rec, arec, (store64, svc64)


def lifecycle_phases(dev, cut) -> dict:
    """Phase 30: the lifecycle on the card, on cfg9-stream's cluster (600
    nodes, 6 000 bound pods) in float32: (a) the background loop's first
    round over one tick's 100 arrivals against ``schedule_pending(
    max_rounds=1, respect_backoff=True)`` on twin stores; (b) ten more ticks
    fed while the loop runs: every arrival bound exactly once, no node over
    its allocatable, batch pods and no fallback, idle ticks launching
    nothing, and ``stop_background()`` raising nothing; (c) a bad
    configuration rolled back; (d) a restart and a reset giving the bytes of
    a twin that never restarted; (e) at the float64 cut of phase 29 (``cut``:
    its store and service), ``snap()`` loaded into a fresh store and
    service equal modulo uid and resourceVersion, then ``ResetService``
    restoring the boot state.  Returns the loop's record."""
    import collections

    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.models.nodeinfo import build_node_infos
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.services.reset import ResetService
    from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.parity import parity_digest

    cfg9 = workloads.STREAM

    def cluster():
        store = ClusterStore(clock=lambda: 1_700_000_000.0)
        settled = workloads.stream_cluster(store, cfg9["n_nodes"], cfg9["seed_bound"])
        feed = workloads.steady_feed(store, settled, 1 + LIFECYCLE_TICKS, 0, cfg9["per_tick"], cfg9["seed_bound"])
        feed(0)
        svc = SchedulerService(store, tie_break="first", use_batch="auto", device=DEVICE, dtype=torch.float32)
        svc.start_scheduler(LIFECYCLE_CFG)
        return store, svc, feed

    def wait_idle(svc, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while svc.pending_pods():
            if not svc.is_background_running():
                svc.stop_background()  # re-raises what the loop died of
            if time.monotonic() > deadline:
                raise AssertionError(f"the loop left {len(svc.pending_pods())} pods pending")
            time.sleep(0.01)

    rec: dict = {}
    with Phase("lifecycle (a): the background loop's first round vs schedule_pending on twin stores"):
        store_a, svc_a, feed_a = cluster()
        store_b, svc_b, _fb = cluster()
        store_c, svc_c, _fc = cluster()
        torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        svc_a.start_background(poll_interval=LIFECYCLE_POLL_S)
        wait_idle(svc_a)
        # joins the tick in flight (a pod is bound before its annotations
        # are flushed), then the loop starts again for (b)
        svc_a.stop_background()
        first_s = time.perf_counter() - t0
        first = parity_digest(store_a)
        first_launches = dict(K.LAUNCHES)
        svc_a.start_background(poll_interval=LIFECYCLE_POLL_S)
        for svc in (svc_b, svc_c):
            svc.schedule_pending(max_rounds=1, respect_backoff=True)
        twins = (parity_digest(store_b), parity_digest(store_c))
        log(f"loop's first round {first_s:.3f} s, launches {json.dumps({k: v for k, v in first_launches.items() if v})}; "
            f"digest {first[:16]}; twins {twins[0][:16]} {twins[1][:16]}")
        if first != twins[0] or first != twins[1] or not first_launches["scan"]:
            raise AssertionError(f"the loop's first round {first} vs schedule_pending {twins}, {first_launches}")
    with Phase(f"lifecycle (b): {LIFECYCLE_TICKS} ticks fed while the loop runs"):
        base = dict(K.LAUNCHES)  # the twins' rounds are not the loop's
        t0 = time.perf_counter()
        for tick in range(1, 1 + LIFECYCLE_TICKS):
            feed_a(tick)
            time.sleep(LIFECYCLE_POLL_S)
        wait_idle(svc_a)
        busy_s = time.perf_counter() - t0
        idle0 = dict(K.LAUNCHES)
        time.sleep(10 * LIFECYCLE_POLL_S)  # idle ticks
        idle = {k: K.LAUNCHES[k] - idle0[k] for k in idle0 if K.LAUNCHES[k] != idle0[k]}
        svc_a.stop_background()  # raises what the loop died of, if it did
        launches = {k: first_launches[k] + K.LAUNCHES[k] - base[k] for k in base}
        arrivals = sorted(p["metadata"]["name"] for p in store_a.list("pods", copy_objects=False)
                          if p["metadata"]["name"].startswith("pod-"))
        unbound = [n for n in arrivals if not (store_a.get("pods", n, "default")["spec"].get("nodeName"))]
        scheduled = sorted(e["involvedObject"]["name"] for e in store_a.list("events", copy_objects=False)
                           if e["reason"] == "Scheduled")
        over = []
        for ni in build_node_infos(store_a.list("nodes", copy_objects=False), store_a.list("pods", copy_objects=False)):
            for r in ("cpu", "memory", "pods"):
                used = len(ni.pods) if r == "pods" else ni.requested.get(r, 0)
                if used > ni.allocatable.get(r, 0):
                    over.append((ni.name, r, used))
        m = svc_a.metrics()
        rec = dict(first_round_s=first_s, busy_s=busy_s, arrivals=len(arrivals), unbound=len(unbound),
                   scheduled_events=len(scheduled), launches=launches, idle_launches=idle,
                   metrics={k: m[k] for k in ("batch_pods", "batch_commits", "engine_rounds", "commit_s",
                                              "overlap_efficiency", "sequential_pods", "queue_moves")},
                   fallbacks=m["batch_fallbacks"], over_allocatable=over[:5])
        log(f"the loop: {json.dumps(rec, sort_keys=True)}")
        want = (1 + LIFECYCLE_TICKS) * cfg9["per_tick"]
        if (len(arrivals) != want or unbound or scheduled != arrivals or over or m["batch_pods"] <= 0
                or m["batch_fallbacks"] or idle or svc_a.is_background_running()):
            raise AssertionError(f"the loop: {json.dumps(rec)}")
        log(f"{want} arrivals bound exactly once, no node over its allocatable, idle ticks launched nothing")
    with Phase("lifecycle (c) and (d): a bad configuration rolls back; restart and reset give the twin's bytes"):
        boot = svc_b.get_scheduler_config()
        try:
            svc_b.restart_scheduler(LIFECYCLE_BAD_CFG)
            raise AssertionError("a configuration naming an unknown plugin started")
        except KeyError as exc:
            log(f"bad configuration refused: {exc!r}")
        if svc_b.get_scheduler_config() != boot or svc_b.framework is None:
            raise AssertionError("the bad configuration was not rolled back")
        svc_b.restart_scheduler(LIFECYCLE_OTHER_CFG)
        if svc_b.get_scheduler_config() == boot:
            raise AssertionError("the other configuration did not start")
        svc_b.reset_scheduler_configuration()
        if svc_b.get_scheduler_config() != boot:
            raise AssertionError("the reset did not return to the boot configuration")
        for store in (store_b, store_c):
            # one more tick's arrivals (nothing deleted), the same in both
            workloads.steady_feed(store, collections.deque(), 1, 5000, cfg9["per_tick"], cfg9["seed_bound"])(0)
        for svc in (svc_b, svc_c):
            svc.schedule_pending(max_rounds=1)
        d_b, d_c = parity_digest(store_b), parity_digest(store_c)
        log(f"after the reset: {d_b[:16]}, the twin that never restarted: {d_c[:16]}")
        if d_b != d_c:
            raise AssertionError(f"the round after the reset {d_b} differs from the twin's {d_c}")
        del store_a, svc_a, store_b, svc_b, store_c, svc_c
        gc.collect()
    with Phase(f"lifecycle (e): snapshot and reset at the float64 cut {json.dumps(SCENARIO_F64)}"):
        store64, svc64 = cut
        t0 = time.perf_counter()
        exported = SnapshotService(store64, svc64).snap()
        fresh = ClusterStore(clock=lambda: SCENARIO_CLOCK)
        svc2 = SchedulerService(fresh, tie_break="first", use_batch="auto", device=DEVICE, dtype=torch.float64)
        svc2.start_scheduler(None)
        boot_dump, boot_cfg = json.dumps(fresh.dump(), sort_keys=True), svc2.get_scheduler_config()
        reset = ResetService(fresh, svc2)
        SnapshotService(fresh, svc2).load(exported)
        kinds = ("pods", "nodes", "persistentvolumes", "persistentvolumeclaims", "storageclasses", "priorityclasses")

        def stripped(store) -> str:
            return digest(json.dumps({k: [{**o, "metadata": {f: v for f, v in o["metadata"].items()
                                                                if f not in ("uid", "resourceVersion")}}
                                          for o in objs] for k, objs in store.dump().items() if k in kinds},
                                     sort_keys=True))

        a, b = stripped(store64), stripped(fresh)
        rounds = svc2.schedule_pending()
        log(f"snap {sum(len(v) for v in exported.values() if isinstance(v, list))} objects; loaded store "
            f"{b[:16]} vs source {a[:16]}; a round after the load scheduled {len(rounds)} pods; "
            f"{time.perf_counter() - t0:.2f} s")
        if a != b or rounds or svc2.get_scheduler_config() != exported["schedulerConfig"]:
            raise AssertionError(f"snapshot load: {b} vs {a}, {len(rounds)} pods scheduled after it")
        reset.reset()
        if json.dumps(fresh.dump(), sort_keys=True) != boot_dump or svc2.get_scheduler_config() != boot_cfg:
            raise AssertionError("ResetService.reset() did not restore the boot state")
        log("ResetService.reset() restored the boot state and configuration")
    return rec


def render_phases(res_cfg2, P: int, churn_digests: dict) -> None:
    """Phase 27: the C renderer's bytes against the Python renderer's: every
    document of cfg2's full-size float64 round (one BatchResult: the per-pod
    functions and ``materialize_wave`` in C, the per-pod functions in Python
    on a copy with empty caches), and through the CUDA float64 service the
    churn cut (phase 9's digests, rendered in C) and cfg8-gang's parity leg,
    run again with every binding of the renderer cleared: pod digests
    equal."""
    import torch

    with Phase(f"cfg2 {P} pods: C renderer against Python renderer on one float64 round"):
        t0 = time.perf_counter()
        csel, cdocs = round_documents(res_cfg2, P)
        c_s = time.perf_counter() - t0
        js = [i for i in range(P) if int(res_cfg2.selected[i]) >= 0]
        t0 = time.perf_counter()
        wave = res_cfg2.materialize_wave(js)
        w_s = time.perf_counter() - t0
        if wave is None or set(wave) != set(js):
            raise AssertionError(f"materialize_wave rendered {None if wave is None else len(wave)} of {len(js)} pods")
        fresh = copy.copy(res_cfg2)
        fresh._lists, fresh._fr_shared = None, None
        with python_renderer():
            t0 = time.perf_counter()
            psel, pdocs = round_documents(fresh, P)
            p_s = time.perf_counter() - t0
        if csel != psel:
            raise AssertionError("selections differ between the renderers")
        for i in range(P):
            for d, kind in enumerate(("filter", "score", "finalScore")):
                if cdocs[i][d] != pdocs[i][d]:
                    raise AssertionError(f"cfg2 pod {i}: {kind} bytes differ between C and Python")
        n_scored = 0
        for j in js:
            doc = wave[j]
            if digest(doc["filter"][0]) != pdocs[j][0]:
                raise AssertionError(f"cfg2 pod {j}: materialize_wave's filter bytes differ")
            if "score" in doc:
                n_scored += 1
                if (digest(doc["score"][0]), digest(doc["finalScore"][0])) != pdocs[j][1:]:
                    raise AssertionError(f"cfg2 pod {j}: materialize_wave's score bytes differ")
        log(f"{P} pods x 3 documents byte-identical, C (per pod {c_s:.3f} s) and Python ({p_s:.3f} s); "
            f"materialize_wave {len(js)} pods ({n_scored} scored) in {w_s:.3f} s, byte-identical")
    with Phase(f"cfg5-churn cut to {CHURN_CUT}: CUDA float64 service, Python renderer against phase 9's C renderer"):
        with python_renderer():
            rec, _l, dig_py = run_churn(CHURN_CUT, DEVICE, torch.float64, echo=False)
        bad = [n for n in churn_digests if dig_py.get(n) != churn_digests[n]]
        if dig_py.keys() != churn_digests.keys() or bad:
            raise AssertionError(f"{len(bad)} pods differ between the renderers, first {bad[:3]}")
        log(f"{len(dig_py)} pods byte-identical; Python commit_s per wave {[round(r['commit_s'], 4) for r in rec]}")
    with Phase(f"cfg8-gang parity leg {GANG_PARITY}: CUDA float64 service, C renderer against Python renderer"):
        recs, digs = [], []
        for mode in ("C", "Python"):
            with python_renderer() if mode == "Python" else contextlib.nullcontext():
                rec, _l, (dig, ev), _st, _svc = run_gang(GANG_PARITY, DEVICE, torch.float64, echo=False)
            recs.append([round(r["commit_s"], 4) for r in rec])
            digs.append((dig, ev))
        if digs[0] != digs[1]:
            raise AssertionError("cfg8-gang parity leg: pods or events differ between the renderers")
        log(f"{len(digs[0][0][-1])} pods after each of {len(digs[0][0])} waves and the events byte-identical; "
            f"commit_s per wave C {recs[0]}, Python {recs[1]}")


def probe(device, dt) -> dict:
    """Part A's probe through a BatchEngine and a SchedulerService on
    ``device`` in ``dt``: the node, the filter document, the promotion."""
    from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    eng = BatchEngine(filters=["NodeResourcesFit"], scores=[("NodeResourcesFit", 1)], device=device, trace=True,
                      dtype=dt)
    res = eng.schedule([PROBE_NODE], [PROBE_POD], [PROBE_POD])
    store = ClusterStore(clock=lambda: 0.0)
    store.create("nodes", json.loads(json.dumps(PROBE_NODE)))
    store.create("pods", json.loads(json.dumps(PROBE_POD)))
    svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device=device, dtype=dt)
    svc.start_scheduler(None)
    svc.schedule_pending(max_rounds=1)
    pod = store.get("pods", "p0")
    return dict(
        selected=res.selected_nodes[0], filter=res.filter_annotation_json(0), promotion=eng.last_promotion,
        promoted=eng.last_timings["promoted_f64"], round_dtype=str(eng.round_dtype),
        service_node=(pod.get("spec") or {}).get("nodeName"), service_promotions=dict(svc.stats["f64_promotions"]),
        service_annotations=digest(json.dumps(pod["metadata"].get("annotations"), sort_keys=True)),
        service_batch_pods=svc.stats["batch_pods"],
    )


def headroom(bound) -> dict:
    """A round's exactness bound and how far below float32's 2^24 it is."""
    col, worst = bound
    return {"column": col, "magnitude_x100": worst, "headroom": (1 << 24) / worst if worst else None}


def gang_phases(dev, cpu_gang_refs) -> "tuple[dict, dict, dict]":
    """Phases 15-19: K6 and K7 against their plain versions on seeded
    problems, cfg8-gang on the card, the kernels timed at that path's
    shapes (K6 at its first dispatch, K7 and K5 through group_preview), the
    CUDA against CPU float64 services on the two cuts (the CPU side from
    ``cpu_gang_refs``, pool results), and Part A's probe on the card.
    Returns (K6's timing, K7's timing, the cfg8-gang launches)."""
    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch.gang import engine as GE
    from kube_scheduler_simulator_tpu_torch.gang import kernel as GK
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.preemption import kernel as PK
    from kube_scheduler_simulator_tpu_torch.time_gang import seeded_feasibility

    with Phase(f"K6 and K7 kernel vs plain, seeded: K6 {K6_SEEDED}; K7 {K7_SEEDED} in float32 and float64"):
        err = 0.0
        for c, (k6, g6, n6, d6) in enumerate(K6_SEEDED):
            args = seeded_verdict(k6, g6, n6, d6, dev, seed=200 + c)
            got, want = K.gang_verdict(*args), GK.verdict_plain(*args)
            for nm, a, b in zip(("feasible", "distinct", "placed"), got, want):
                err = max(err, same(f"K6 K={k6} G={g6} N={n6} D={d6} {nm}", a, b))
            blocks = -(-g6 // (K.VERDICT_SMEM_BYTES // ((2 + (d6 + 31) // 32) * 4)))
            log(f"K6 K={k6} G={g6} N={n6} D={d6} ({blocks} blocks): bitwise equal; feasible {int(got[0].sum())}/{g6}, "
                f"distinct max {int(got[1].max())}, placed {int(got[2].sum())}")
        shapes7: set = set()
        for c, (g7, m7, n7, r7, d7) in enumerate(K7_SEEDED):
            for dt in (torch.float32, torch.float64):
                args = seeded_feasibility(g7, m7, n7, r7, d7, dt, dev, seed=300 + c)
                got, want = K.gang_feasibility(*args), GK.feasibility_plain(*args)
                for nm, a, b in zip(("feasible", "distinct", "assignment"), got, want):
                    err = max(err, same(f"K7 G={g7} M={m7} N={n7} R={r7} D={d7} {dt} {nm}", a, b))
                v = K.feas_variant(n7, r7, dt)
                tg, npt = K.FEAS_VARIANTS[v]
                scratch = K.feas_memory(g7, m7, n7, r7, dt, v)[2]
                where = f"{npt} nodes a thread in registers" if npt else ("global scratch" if scratch else "shared memory")
                shapes7.add((v, bool(scratch)))
                log(f"K7 G={g7} M={m7} N={n7} R={r7} D={d7} {str(dt).split('.')[-1]} (variant {v}: {tg} threads a "
                    f"group, {where}): bitwise equal; feasible {int(got[0].sum())}/{g7}, placed "
                    f"{int((got[2] >= 0).sum())}")
        built = {(v, False) for v in range(len(K.FEAS_VARIANTS)) if v != K.FEAS_MEM} | {(K.FEAS_MEM, False),
                                                                                       (K.FEAS_MEM, True)}
        if built - shapes7:
            raise AssertionError(f"K7_SEEDED misses kernel shapes (variant, global scratch) {sorted(built - shapes7)}")
        args = seeded_feasibility(32, 16, 12000, 2, 12000, torch.float64, dev, seed=303)
        k7_seeded_ms, kout = cuda_ms(lambda: K.gang_feasibility(*args), 5, warmup=1)
        k7_seeded_plain_ms, _p = cuda_ms(lambda: GK.feasibility_plain(*args), 1, warmup=0)
        args = seeded_feasibility(256, 64, 5000, 2, 8, torch.float32, dev, seed=301)
        k7_big_ms, _h, kout = device_ms(lambda: K.gang_feasibility(*args), 20)
        k7_big_plain_ms, _p = cuda_ms(lambda: GK.feasibility_plain(*args), 1, warmup=0)
        k7_big_bound, k7_big_by = bound(feasibility_counts(args, kout), torch.float32)
        log(f"timing K7 G=256 M=64 N=5000 D=8 float32: kernel {k7_big_ms:.3f} ms, plain {k7_big_plain_ms:.3f} ms, "
            f"bound {k7_big_bound:.5f} ms ({k7_big_by}); G=32 M=16 N=12000 float64 (global table): kernel "
            f"{k7_seeded_ms:.3f} ms, plain {k7_seeded_plain_ms:.3f} ms")

    captured: dict = {}
    with Phase(f"cfg8-gang {GANG}, its first {GANG_WAVES} waves: service on the card, float32"):
        grec, glaunch, _none, gstore, gsvc = run_gang(GANG, DEVICE, torch.float32, capture=captured, waves=GANG_WAVES,
                                                      digests=False)
        keys = ("wall_s", "encode_s", "device_s", "commit_s", "annotate_s", "store_mutate_s", "gang_kernel_s")
        med = {k: float(np.median([r[k] for r in grec])) for k in keys}
        st = gsvc.stats
        log(f"cfg8-gang float32: launches over {len(grec)} waves {glaunch}; medians {json.dumps(med)}; "
            f"released {st['gang_released_groups']} groups / {st['gang_released_pods']} pods, parked "
            f"{st['gang_parked']}, dispatches {st['gang_kernel_dispatches']}, preempt fallbacks "
            f"{st['preempt_fallbacks']}, promotions {st['f64_promotions']}")
        if st["f64_promotions"]:
            raise AssertionError(f"cfg8-gang float32 was promoted: {st['f64_promotions']}")
        if "args" not in captured or glaunch["gang_verdict"] < 1:
            raise AssertionError("cfg8-gang launched no window verdict")

    with Phase("timings: K6 at cfg8-gang's first dispatch; group_preview at its final state (K7, K5)"):
        cargs = captured["args"]
        shape6 = f"K={cargs[0].shape[0]} G={cargs[2].shape[0]} N={cargs[2].shape[1]} D={cargs[5]}"
        got, want = K.gang_verdict(*cargs), GK.verdict_plain(*cargs)
        for nm, a, b in zip(("feasible", "distinct", "placed"), got, want):
            err = max(err, same(f"K6 first dispatch {nm}", a, b))
        # the launch back to back behind a sleep of the card (its device
        # time), its host ms a call, and the earlier figure: CUDA events
        # around calls paced by the host; the dispatch's host ms as the
        # service saw it over the waves (gang_kernel_s / dispatches)
        k6_ms, k6_host_ms, kout6 = device_ms(lambda: K.gang_verdict(*cargs), 200)
        k6_cuda_ms, _k = cuda_ms(lambda: K.gang_verdict(*cargs), 50, warmup=5)
        k6_plain_ms, _p = cuda_ms(lambda: GK.verdict_plain(*cargs), 5, warmup=1)
        k6b, k6by = bound(verdict_counts(cargs, kout6), torch.int32)
        k6_s, k6_n = sum(r["gang_kernel_s"] for r in grec), sum(r["gang_kernel_dispatches"] for r in grec)
        k6_t = dict(ms=k6_ms, host_ms=k6_host_ms, cuda_ms=k6_cuda_ms, dispatch_ms=1e3 * k6_s / k6_n,
                    plain_ms=k6_plain_ms, bound_ms=k6b, bound_by=k6by, library_ms=None, err=err, shape=shape6)
        log(f"timing K6 {shape6}: {json.dumps(k6_t)}")
        # the preview: one feasible group (32 one-CPU members) and one too
        # large for any node (4 members of 100 CPU at priority 100, so the
        # victim search runs too)
        from kube_scheduler_simulator_tpu_torch.gang.scenario import make_member

        gstore.create("podgroups", {"metadata": {"name": "preview-ok"}, "spec": {"minMember": 32}})
        for m in range(32):
            gstore.create("pods", make_member(f"preview-ok-m{m}", "preview-ok"))
        gstore.create("podgroups", {"metadata": {"name": "preview-big"}, "spec": {"minMember": 4}})
        for m in range(4):
            big = make_member(f"preview-big-m{m}", "preview-big", cpu="100")
            big["spec"]["priority"] = 100
            gstore.create("pods", big)
        fcap: dict = {}
        scap: dict = {}
        feas, launch, run_feas = GK.feasibility, K.preempt, GK.run_feasibility

        def keep_f(*a, **kw):
            fcap.setdefault("args", tuple(x.clone() if hasattr(x, "clone") else x for x in a))
            return feas(*a, **kw)

        def keep_s(*a, **kw):
            scap.setdefault("args", tuple(x.clone() for x in a))
            return launch(*a, **kw)

        def keep_p(pr, *a, **kw):
            fcap.setdefault("problem", pr)
            return run_feas(pr, *a, **kw)

        GK.feasibility, K.preempt, GK.run_feasibility = keep_f, keep_s, keep_p
        try:
            K.reset_counts()
            t0 = time.perf_counter()
            ok = GE.group_preview(gstore, gstore.get("podgroups", "preview-ok"), device=DEVICE)
            big = GE.group_preview(gstore, gstore.get("podgroups", "preview-big"), device=DEVICE)
            preview_s = time.perf_counter() - t0
            preview_launches = dict(K.LAUNCHES)
        finally:
            GK.feasibility, K.preempt, GK.run_feasibility = feas, launch, run_feas
        log(f"group_preview x2 in {preview_s:.4f} s, launches {preview_launches}: feasible group -> feasible "
            f"{ok['feasible']}, {ok['distinctTopologyDomains']} domains, {sum(v is not None for v in ok['assignment'].values())} "
            f"assigned; large group -> feasible {big['feasible']}, victim preview {big.get('victimPreview')}")
        if not ok["feasible"] or big["feasible"] or "victimPreview" not in big:
            raise AssertionError("group_preview: the small group must be feasible, the large one not (with a victim preview)")
        if preview_launches["gang_feasibility"] != 2 or preview_launches["preempt"] < 1:
            raise AssertionError(f"group_preview did not launch K7 twice and K5: {preview_launches}")
        fargs = fcap["args"]
        got, want = K.gang_feasibility(*fargs), GK.feasibility_plain(*fargs)
        for nm, a, b in zip(("feasible", "distinct", "assignment"), got, want):
            err = max(err, same(f"K7 preview {nm}", a, b))
        k7_ms, k7_host_ms, kout7 = device_ms(lambda: K.gang_feasibility(*fargs), 200)
        k7_cuda_ms, _k = cuda_ms(lambda: K.gang_feasibility(*fargs), 50, warmup=5)
        k7_plain_ms, _p = cuda_ms(lambda: GK.feasibility_plain(*fargs), 5, warmup=1)
        k7b, k7by = bound(feasibility_counts(fargs, kout7), fargs[2].dtype)
        shape7 = f"G={fargs[0].shape[0]} M={fargs[0].shape[1]} N={fargs[2].shape[0]} R={fargs[2].shape[1]} D={fargs[5]}"
        # the preview's whole dispatch (one copy in, one launch, one copy
        # out): the mean of 20 after 3, and its stages' medians
        pr7 = fcap["problem"]
        for _ in range(3):
            GK.run_feasibility(pr7, device=DEVICE)
        splits = [{} for _ in range(20)]
        t0 = time.perf_counter()
        for sp in splits:
            GK.run_feasibility(pr7, device=DEVICE, split=sp)
        k7_dispatch_ms = 1e3 * (time.perf_counter() - t0) / len(splits)
        k7_stages = {k: float(np.median([1e6 * sp[k] for sp in splits])) for k in splits[0]}
        # the JAX bench's standalone dispatch (64 fresh groups over the 220
        # nodes) on cfg8-gang's final state
        bargs = bench_args(gstore, dev, torch.float32)
        got, want = K.gang_feasibility(*bargs), GK.feasibility_plain(*bargs)
        for nm, a, b in zip(("feasible", "distinct", "assignment"), got, want):
            err = max(err, same(f"K7 bench dispatch {nm}", a, b))
        k7_bench_ms, _h, koutb = device_ms(lambda: K.gang_feasibility(*bargs), 50)
        k7_bench_plain_ms, _p = cuda_ms(lambda: GK.feasibility_plain(*bargs), 3, warmup=1)
        k7_bench_bound, _by = bound(feasibility_counts(bargs, koutb), torch.float32)
        shape7b = f"G={bargs[0].shape[0]} M={bargs[0].shape[1]} N={bargs[2].shape[0]} R={bargs[2].shape[1]} D={bargs[5]}"
        k7_t = dict(ms=k7_ms, host_ms=k7_host_ms, cuda_ms=k7_cuda_ms, plain_ms=k7_plain_ms, bound_ms=k7b,
                    bound_by=k7by, library_ms=None, err=err,
                    shape=shape7, launches=preview_launches["gang_feasibility"],
                    dispatch_ms=k7_dispatch_ms, dispatch_stages_us=k7_stages,
                    bench_shape=shape7b, bench_ms=k7_bench_ms, bench_plain_ms=k7_bench_plain_ms,
                    bench_bound_ms=k7_bench_bound,
                    seeded_256x64x5000_ms=k7_big_ms, seeded_256x64x5000_plain_ms=k7_big_plain_ms,
                    seeded_256x64x5000_bound_ms=k7_big_bound)
        log(f"timing K7 {shape7} (the preview's first group): {json.dumps(k7_t)}")
        sargs = scap["args"]
        for dt in (torch.float32, torch.float64):
            a = as_dtype(sargs, dt)
            for nm, x, y in zip(("cand", "victims", "viol"), K.preempt(*a), PK.preempt_plain(*a)):
                same(f"K5 preview {dt} {nm}", x, y)
        log(f"K5 at the preview's dispatch (U={sargs[0].shape[0]} N={sargs[0].shape[1]} V={sargs[13].shape[1]}): "
            f"bitwise equal in float32 and float64")

    for cut, spec in GANG_CUTS.items():
        with Phase(f"cfg8-gang {cut} cut {spec}: CUDA float64 service vs CPU float64 service"):
            crec, _l, (dig_g, ev_g), _s, gsvc64 = run_gang(spec, DEVICE, torch.float64, echo=False,
                                                          small_nodes=cut == "cascade", strict=cut != "cascade")
            t0 = time.perf_counter()
            cpu_rec, (dig_c, ev_c) = cpu_gang_refs[cut].get()
            log(f"CPU float64 service (worker process) waited for {time.perf_counter() - t0:.2f} s")
            for r_g, r_c in zip(crec, cpu_rec):
                log(f"{cut} wave {r_g['wave']}: cuda parked {r_g['gang_parked']} released {r_g['gang_released_groups']} "
                    f"sequential {r_g['sequential_pods']} unbound {r_g['unbound']} | cpu parked {r_c['gang_parked']} "
                    f"released {r_c['gang_released_groups']} sequential {r_c['sequential_pods']} unbound {r_c['unbound']}")
            for w, (wg, wc) in enumerate(zip(dig_g, dig_c, strict=True)):
                if wg.keys() != wc.keys():
                    raise AssertionError(f"{cut} wave {w}: the CUDA and CPU services hold different pods")
                bad = [n for n in wc if wg[n] != wc[n]]
                if bad:
                    raise AssertionError(f"{cut} wave {w}: {len(bad)} pods differ between the CUDA and CPU services, "
                                         f"first {bad[:3]}")
            if ev_g != ev_c:
                raise AssertionError(f"{cut}: the CUDA and CPU services recorded different events")
            if gsvc64.stats["gang_kernel_dispatches"] < 1:
                raise AssertionError(f"{cut}: no window verdict dispatched")
            if cut == "cascade" and not any(r["sequential_pods"] for r in crec):
                raise AssertionError("cascade cut: no member failed the kernel (nothing cascaded)")
            log(f"{cut}: after every wave ({[len(d) for d in dig_c]} pods) node, annotations and status "
                f"byte-identical, events equal, no partially bound group")

    with Phase("Part A's probe on the card: float32 against float64"):
        r32, r64 = probe(DEVICE, torch.float32), probe(DEVICE, torch.float64)
        log(f"float32: {json.dumps(r32, sort_keys=True)}")
        log(f"float64: {json.dumps(r64, sort_keys=True)}")
        problems = []
        if r32["selected"] is not None or r32["service_node"] is not None:
            problems.append("the pod was placed")
        if "Insufficient memory" not in r32["filter"] or r32["filter"] != r64["filter"]:
            problems.append("the filter documents differ or miss Insufficient memory")
        if r32["service_annotations"] != r64["service_annotations"]:
            problems.append("the service's annotations differ between float32 and float64")
        if r32["promoted"] != 1.0 or r32["promotion"] is None or sum(r32["service_promotions"].values()) != 1:
            problems.append("float32 did not count exactly one promotion")
        if r64["promotion"] is not None or r64["service_promotions"]:
            problems.append("float64 counted a promotion")
        if problems:
            raise AssertionError(f"Part A probe: {'; '.join(problems)}")
    return k6_t, k7_t, glaunch


# ------------------------------------------ capacity engine (K8)

def capture_lanes(capture: list, estimator):
    """Wrap kernels.scan_lanes: each dispatch's arguments, shape, working
    dtype, block width, exactness headroom (``estimator()``'s last bound)
    and CUDA events around the launch are appended to ``capture``, and the
    estimator's split of the dispatch before it (encode, lower, launch,
    fetch: ``last_split``) to the record before.  Returns the function
    that unwraps it."""
    import torch

    from kube_scheduler_simulator_tpu_torch.autoscaler import estimator as EST
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    orig, orig_est = K.scan_lanes, EST.ScaleUpEstimator._estimate_kernel

    def wrapped(cfg, dims, dp, lane, widest=None):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = orig(cfg, dims, dp, lane, widest=widest)
        e.record()
        est = estimator()
        widest = int(lane.sum(dim=1).max()) if widest is None else widest
        capture.append(dict(
            args=(cfg, dims, dp, lane), widest=widest, tile=K.lane_tile(widest), events=(s, e), G=lane.shape[0],
            P=int(dp.pod_active.sum()), N=int(dp.n_true), P_pad=dims["P"], N_pad=dims["N"],
            dtype=str(dp.alloc.dtype).split(".")[-1], bound=headroom(est.last_bound) if est is not None else None,
        ))
        return out

    def estimate(self, *a, **kw):
        out = orig_est(self, *a, **kw)
        if capture:
            capture[-1]["split"] = dict(self.last_split)
        return out

    K.scan_lanes, EST.ScaleUpEstimator._estimate_kernel = wrapped, estimate

    def unwrap():
        K.scan_lanes, EST.ScaleUpEstimator._estimate_kernel = orig, orig_est

    return unwrap


def run_autoscale(device, dt, frozen_clock=False, capture: "list | None" = None, mesh=None):
    """cfg6-autoscale through a SchedulerService on ``device`` in ``dt``, as
    bench's run_autoscale drives it (``workloads.autoscale``, then
    ``schedule_pending_autoscaled(max_rounds=2, max_passes=12)``), the
    launch counts reset just before it and read just after.
    ``frozen_clock``: the store's clock frozen at 0, so two runs are
    byte-comparable.  With ``capture``, every lane-scan dispatch is kept
    there (``capture_lanes``).  Returns (record, pod digests, events
    digest)."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    def start(store):
        svc = SchedulerService(store, tie_break="first", use_batch="auto", autoscale="on",
                               autoscaler_opts={"expander": "least-waste"}, device=device, dtype=dt, mesh=mesh)
        svc.start_scheduler(None)
        return svc

    store = ClusterStore(clock=lambda: 0.0) if frozen_clock else ClusterStore()
    svc = workloads.autoscale(store, start, **AUTOSCALE)
    unwrap = capture_lanes(capture, lambda: svc.autoscaler._estimator) if capture is not None else None
    # the seconds Python's garbage collector takes during the loop, by
    # generation (the process holds every earlier phase's objects)
    gc_rec = {"collections": [0, 0, 0], "s": [0.0, 0.0, 0.0]}
    gc_t0 = [0.0]

    def gc_probe(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_rec["collections"][info["generation"]] += 1
            gc_rec["s"][info["generation"]] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(gc_probe)
    try:
        K.reset_counts()
        t0 = time.perf_counter()
        results = svc.schedule_pending_autoscaled(max_rounds=2, max_passes=12)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        gc.callbacks.remove(gc_probe)
        if unwrap is not None:
            unwrap()
    asc = svc.autoscaler
    am = asc.metrics()
    ups = [e for e in asc.events if e["action"] == "ScaleUp"]
    rec = dict(
        wall_s=wall, scheduled=sum(1 for r in results.values() if r.success), pending_after=len(svc.pending_pods()),
        nodes_added=am["nodes_added"], scale_ups=am["scale_ups"], passes=am["passes"],
        group_sizes={g: v["current"] for g, v in sorted(am["groups"].items())},
        estimate_dispatches=am["estimate_dispatches"], estimate_compiles=am["estimate_compiles"],
        estimate_cum_s=am["estimate_cum_s"], kernel_errors=am["estimate_kernel_errors"],
        estimate_split=dict(asc._estimator.cum_split) if asc._estimator else {}, gc=gc_rec,
        launches=launches,
        actions=[[e["nodeGroup"], len(e["nodes"])] for e in ups], methods=sorted({e["method"] for e in ups}),
        batch_pods=svc.stats["batch_pods"], sequential_pods=svc.stats["sequential_pods"],
        batch_fallbacks=dict(svc.stats["batch_fallbacks"]), promotions=dict(svc.stats["f64_promotions"]),
        estimate_promotions=dict(asc._estimator.promotions) if asc._estimator else {},
        nodes=sorted(n["metadata"]["name"] for n in store.list("nodes", copy_objects=False)),
    )
    return rec, pod_digests(store), digest(json.dumps(asc.events, sort_keys=True))


def lane_counts(cfg, dims, dp, lane, out) -> dict:
    """Bytes and operations of one lane-scan launch: the problem read once
    and the lane mask, every lane's outputs written once (``scan_counts``
    over the outputs with their lane axis); the scan's operations over
    each lane's active rows only (a masked-out row is infeasible with no
    arithmetic; every ``scan_counts`` term is linear in the node count),
    plus one mask read a (lane, pod, node) cell."""
    c = scan_counts(cfg, dims, dp, out)
    ops = c["ops"] * int(lane.sum()) // dims["N"] + dims["P"] * lane.numel()
    return {"bytes": c["bytes"] + lane.numel() * lane.element_size(), "ops": ops}


def dp_as(dp, dt):
    """A DeviceProblem with its float tensors in ``dt`` (exact: every value
    is an integer well inside both dtypes' range)."""
    import torch

    conv = lambda t: t.to(dt) if isinstance(t, torch.Tensor) and t.is_floating_point() else t  # noqa: E731
    return dp._replace(**{f: tuple(map(conv, v)) if isinstance(v, tuple) else conv(v) for f, v in dp._asdict().items()})


def autoscale_phases(dev, cpu_autoscale_ref) -> dict:
    """Phases 20-22.  21 runs first: cfg6-autoscale end to end on the card
    in float32, capturing its lane-scan dispatches, then one burst estimate.
    20 holds K8 against its plain version on the captured inputs of cfg6's
    first dispatch (bitwise, float32 and float64) and, at the burst's shape,
    each lane against the one-lane scan K2 launched on that lane's mask, and
    times K8 at both.  22 holds the CUDA float64 service against the CPU
    float64 service (``cpu_autoscale_ref``, a pool result).  Returns K8's
    timing and launches."""
    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.autoscaler import ScaleUpEstimator
    from kube_scheduler_simulator_tpu_torch.ops import batch as B
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    cfg6: list = []
    with Phase(f"21. cfg6-autoscale {AUTOSCALE}: service on the card, float32"):
        rec, _dig, _ev = run_autoscale(DEVICE, torch.float32, capture=cfg6)
        for c in cfg6:
            c["k8_ms"] = c["events"][0].elapsed_time(c["events"][1])
        rec["dispatches"] = [{k: c[k] for k in ("G", "P", "N", "P_pad", "N_pad", "dtype", "bound", "k8_ms", "widest",
                                                "tile", "split")} for c in cfg6]
        log(f"cfg6-autoscale float32: {json.dumps(rec, sort_keys=True)}")
        for j, c in enumerate(cfg6):
            sp = c["split"]
            log(f"estimate {j + 1} of {len(cfg6)} (the process's {'first' if j == 0 else 'next'} K8 launch; tile "
                f"{c['tile']} for {c['widest']} rows): encode {sp['encode_s']:.4f} s, lower {sp['lower_s']:.4f} s, "
                f"launch {sp['launch_s']:.5f} s, fetch {sp['fetch_s']:.4f} s; K8 {c['k8_ms']:.4f} ms")
        log(f"estimate_cum_s {rec['estimate_cum_s']:.4f} s = {json.dumps(rec['estimate_split'])}; the garbage "
            f"collector during the loop: {rec['gc']['collections']} collections by generation, "
            f"{[round(x, 4) for x in rec['gc']['s']]} s")
        log(f"scale-ups {rec['actions']}; BENCH_autoscaler.json (JAX package, CPU) {AUTOSCALE_REFERENCE}: "
            f"{'equal' if rec['actions'] == AUTOSCALE_REFERENCE else 'different'}")
        problems = []
        if rec["kernel_errors"]:
            problems.append(f"kernel errors {rec['kernel_errors']}")
        # every estimate records its method: a resource-fallback one fails here
        if rec["methods"] != ["xla-batch"]:
            problems.append(f"estimate methods {rec['methods']}")
        if rec["launches"]["scan_lanes"] != rec["estimate_dispatches"] or not cfg6:
            problems.append(f"K8 launches {rec['launches']['scan_lanes']} != dispatches {rec['estimate_dispatches']}")
        # the size rule (a round of pods x nodes below batch_min_work takes
        # the sequential cycle) is the service's routing, as in the bench;
        # any other fallback reason fails
        refused = {k: v for k, v in rec["batch_fallbacks"].items() if k != "below batch_min_work"}
        if rec["pending_after"] or refused:
            problems.append(f"pending after {rec['pending_after']}, batch fallbacks {refused}")
        if problems:
            raise AssertionError(f"cfg6-autoscale: {'; '.join(problems)}")
        launches = rec["launches"]["scan_lanes"]

    burst: list = []
    with Phase(f"21. the autoscale burst {BURST}: one ScaleUpEstimator(device='cuda').estimate"):
        groups, room, pending = workloads.autoscale_burst(**BURST)
        est = ScaleUpEstimator(device=DEVICE)
        unwrap = capture_lanes(burst, lambda: est)
        try:
            t0 = time.perf_counter()
            out = est.estimate(groups, room, pending, volumes={})
            wall = time.perf_counter() - t0
        finally:
            unwrap()
        c = burst[0]
        c["k8_ms"] = c["events"][0].elapsed_time(c["events"][1])
        sp = c["split"]
        log(f"burst estimate split: encode {sp['encode_s']:.4f} s, lower {sp['lower_s']:.4f} s, launch "
            f"{sp['launch_s']:.5f} s, fetch {sp['fetch_s']:.4f} s; tile {c['tile']} for {c['widest']} rows")
        log(f"burst estimate: wall {wall:.4f} s, K8 {c['k8_ms']:.3f} ms (G={c['G']} P={c['P']} N={c['N']}, padded "
            f"{c['P_pad']} x {c['N_pad']}, {c['dtype']}, bound {json.dumps(c['bound'])}); estimates "
            f"{[(e.group, e.nodes_needed, e.pods_fit, e.waste) for e in out]}")
        if len(burst) != 1 or {e.method for e in out} != {"xla-batch"} or not any(e.pods_fit for e in out):
            raise AssertionError("the burst estimate did not run one lane-kernel dispatch that places pods")

    with Phase("20. K8 kernel vs plain at cfg6's first dispatch; lanes vs K2 at the burst; timed"):
        cfg, dims, dp, lane = cfg6[0]["args"]
        shape6 = f"cfg6-autoscale first dispatch: G={lane.shape[0]} P={dims['P']} N={dims['N']}"
        k8_err = 0.0
        for dt in (torch.float32, torch.float64):
            d = dp_as(dp, dt)
            pms, pout = cuda_ms(lambda: B.scan_lanes_plain(cfg, dims, d, lane), 1, warmup=0)
            k8_err = max(k8_err, same_outputs(f"K8 cfg6 {dt}", K.scan_lanes(cfg, dims, d, lane), pout))
            if dt == dp.alloc.dtype:
                plain_ms = pms
        w6 = cfg6[0]["widest"]
        k8_ms, kout = cuda_ms(lambda: K.scan_lanes(cfg, dims, dp, lane, widest=w6), 20, warmup=3)
        k8b, k8by = bound(lane_counts(cfg, dims, dp, lane, kout), dp.alloc.dtype)
        c6 = K.lane_tile(w6)
        log(f"{shape6} (tile {c6} for {w6} rows, KM={dp.ip_match_g.shape[1]}): bitwise equal in float32 and "
            f"float64; kernel {k8_ms:.4f} ms, plain {plain_ms:.1f} ms, bound {k8b:.6f} ms ({k8by})")
        cfg, dims, dp, lane = burst[0]["args"]
        G = lane.shape[0]
        for dt in (torch.float32, torch.float64):
            d = dp_as(dp, dt)
            kb = K.scan_lanes(cfg, dims, d, lane)
            for g in range(G):
                one = K.scan(cfg, dims, d._replace(node_active=lane[g].contiguous()), blocks=1)
                for k, v in one.items():
                    if k != "final_carry":
                        k8_err = max(k8_err, same(f"K8 burst lane {g} {k} {dt}", kb[k][g], v))
            del kb
        wb = burst[0]["widest"]
        burst_ms, bout = cuda_ms(lambda: K.scan_lanes(cfg, dims, dp, lane, widest=wb), 20, warmup=2)
        burst_b, burst_by = bound(lane_counts(cfg, dims, dp, lane, bout), dp.alloc.dtype)
        cb = K.lane_tile(wb)
        log(f"burst G={G} P={dims['P']} N={dims['N']} (tile {cb} for {wb} rows, KM={dp.ip_match_g.shape[1]}): "
            f"every lane bitwise "
            f"equal to K2 on its mask in float32 and "
            f"float64; kernel {burst_ms:.3f} ms, bound {burst_b:.6f} ms ({burst_by}); placed per lane "
            f"{(bout['selected'] >= 0).sum(dim=1).tolist()}")
        k8_t = dict(ms=k8_ms, plain_ms=plain_ms, bound_ms=k8b, bound_by=k8by, err=k8_err, shape=shape6, launches=launches,
                    tile=c6, burst_ms=burst_ms, burst_bound_ms=burst_b, burst_bound_by=burst_by,
                    burst_shape=f"G={G} P={dims['P']} N={dims['N']}", burst_tile=cb,
                    estimate_cum_s=rec["estimate_cum_s"], estimate_split=rec["estimate_split"],
                    first_launch=cfg6[0]["split"], second_launch=cfg6[1]["split"] if len(cfg6) > 1 else None)
        log(f"timing K8: {json.dumps(k8_t)}")
        del bout, kout
        torch.cuda.empty_cache()

    with Phase("22. cfg6-autoscale: CUDA float64 service vs CPU float64 service"):
        grec, dig_g, ev_g = run_autoscale(DEVICE, torch.float64, frozen_clock=True)
        t0 = time.perf_counter()
        crec, dig_c, ev_c = cpu_autoscale_ref.get()
        log(f"CPU float64 service (worker process) waited for {time.perf_counter() - t0:.2f} s")
        for side, r in (("cuda", grec), ("cpu", crec)):
            log(f"{side} float64: wall {r['wall_s']:.3f} s, actions {r['actions']}, passes {r['passes']}, "
                f"pending after {r['pending_after']}, launches {r['launches']}")
        keys = ("scheduled", "pending_after", "nodes_added", "scale_ups", "passes", "group_sizes", "actions",
                "methods", "nodes", "estimate_dispatches", "batch_fallbacks")
        diff = [k for k in keys if grec[k] != crec[k]]
        if dig_g.keys() != dig_c.keys() or diff:
            raise AssertionError(f"the CUDA and CPU services differ: {diff}")
        bad = [n for n in dig_c if dig_g[n] != dig_c[n]]
        if bad:
            raise AssertionError(f"{len(bad)} pods differ between the CUDA and CPU services, first {bad[:3]}")
        if ev_g != ev_c:
            raise AssertionError("the CUDA and CPU autoscalers recorded different events")
        if grec["launches"]["scan_lanes"] != grec["estimate_dispatches"]:
            raise AssertionError(f"float64: K8 launches {grec['launches']['scan_lanes']} != dispatches")
        log(f"{len(dig_c)} pods: node, annotations and status byte-identical; autoscaler events, summaries "
            f"and node names equal")
    return k8_t


# ------------------------------------------ the tuner (K9, K2g)

def tune_reports(device, dt, size) -> list:
    """The JAX bench's three tune rows (``workloads.TUNE_ROWS``) through the
    port's ``run_tuning`` on ``device`` in ``dt`` at ``size`` (nodes, pods),
    each with its wall and the kernel launches (counts reset just before)."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.tuning import run_tuning

    t = workloads.TUNE
    out = []
    for family, tuner in workloads.TUNE_ROWS:
        K.reset_counts()
        t0 = time.perf_counter()
        rep = run_tuning(family=family, tuner=tuner, seed=t["seed"], steps=t["steps"], pop=t["pop"], tau=t["tau"],
                         lr=t["lr"], device=device, dtype=dt, **size)
        rep["wall_s"] = time.perf_counter() - t0
        rep["launches"] = {k: K.LAUNCHES[k] for k in ("scan_population", "objective", "scan_grad")}
        out.append(rep)
    return out


def tune_service_rounds(device, dt) -> dict:
    """The bench's zero-drift workload through the port's service on
    ``device`` in ``dt``: pod digests with no override ("folded"), with the
    profile's own weights as an override ("defaults") and with
    TUNE_FLOAT_WEIGHTS ("float"); whether a finalScore came out
    fractional."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    out = {}
    for mode in ("folded", "defaults", "float"):
        nodes, pods, _obj = workloads.tune("imbalance", **TUNE_SERVICE)
        store = ClusterStore(clock=lambda: 0.0)
        for o in nodes:
            store.create("nodes", o)
        for o in pods:
            store.create("pods", o)
        svc = SchedulerService(store, tie_break="first", use_batch="force", batch_min_work=0, device=device, dtype=dt)
        svc.start_scheduler(None)
        if mode == "defaults":
            svc.set_plugin_weights({n: float(w) for n, w in svc.framework.score_weights.items()})
        elif mode == "float":
            svc.set_plugin_weights(TUNE_FLOAT_WEIGHTS)
        svc.schedule_pending()
        if svc.stats["batch_pods"] == 0 or svc.stats["batch_fallbacks"]:
            raise AssertionError(f"zero-drift {mode}: batch pods {svc.stats['batch_pods']}, "
                                 f"fallbacks {svc.stats['batch_fallbacks']}")
        out[mode] = pod_digests(store)
        if mode == "float":
            out["fractional"] = any(
                "." in (p["metadata"].get("annotations") or {}).get("scheduler-simulator/finalscore-result", "")
                for p in store.list("pods", copy_objects=False)
            )
    return out


def population_counts(cfg, dims, dp, W, out) -> dict:
    """Bytes and operations of one population launch (K9) and its objective:
    the problem and the weights read once, every lane's outputs and value
    written once; the scan's operations once a lane, plus the objective's
    (about 6 a lane's cpu/mem fraction: divide, mask, square, two tree
    adds)."""
    c = scan_counts(cfg, dims, dp, out)
    L = W.shape[0]
    return {"bytes": c["bytes"] + W.numel() * W.element_size() * 2,
            "ops": c["ops"] * L + 6 * 2 * dims["N"] * L}


def grad_counts(cfg, dims, dp, w, F, out) -> dict:
    """Bytes and operations of one grad launch (K2g): the scan's (one lane),
    plus F and the weights read and dw written once, and 2(S + 3)
    operations a (committed pod, sampled node) cell (the softmax's max,
    exp and sum, c and its mean, and two a weight)."""
    c = scan_counts(cfg, dims, dp, out)
    S = len(cfg.scores)
    cells = int(out["packed_pod"][1].sum())
    return {"bytes": c["bytes"] + (F.numel() + w.numel()) * F.element_size() + 8 * S,
            "ops": c["ops"] + 2 * (S + 3) * cells}


def contract_counts(M, F) -> dict:
    """Bytes and operations of K2g's contraction: M and F read once, dw
    written once; a multiply and an add a term of M."""
    return {"bytes": M.numel() * M.element_size() + F.numel() * F.element_size() + M.shape[1] * 8,
            "ops": 2 * M.numel()}


def capture_population(capture: list):
    """Wrap tuning.tuner.TuningSession.evaluate_population: each call's
    weight matrix is appended to ``capture``.  Returns the unwrapper."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT

    orig = TT.TuningSession.evaluate_population

    def wrapped(self, W):
        capture.append(np.asarray(W, dtype=np.float64).copy())
        return orig(self, W)

    TT.TuningSession.evaluate_population = wrapped
    return lambda: setattr(TT.TuningSession, "evaluate_population", orig)


def generation0(session, scores, t) -> "tuple":
    """(W, lane): generation 0's [pop, S] weight matrix of ``run_cem`` (seed
    and population of cfg10-tune-10k) on ``session``, and the lane with the
    most fractional weights (generation 0 opens with the profile's integer
    mean, the zero vector and one-hots; its Gaussian draws follow)."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT

    gen0: list = []
    unwrap = capture_population(gen0)
    try:
        TT.run_cem(session, np.asarray([float(w) for _s, w in scores]), steps=1, pop=t["pop"], seed=t["seed"])
    finally:
        unwrap()
    W = gen0[0]
    frac = [int((np.abs(r - np.round(r)) > 0).sum()) for r in W]
    return W, max(range(W.shape[0]), key=lambda g: (frac[g], g)), frac


def k9_checks(dev, sessions, W, gp, frac, family, obj, plain_refs) -> dict:
    """Phase 23 at one family's generation 0: in float32 and float64 every
    lane of K9 bitwise equal to the one-lane scan (K2) under its weights
    (packed outputs and final carry), lane ``gp`` bitwise equal to
    ``scan_plain`` (``plain_refs[dt]``, a worker's digests), the objective
    kernel (values and cotangents of every lane) bitwise its plain version.
    Returns the family's record for ``k9_timed``."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.tuning import objective as TO

    s32 = sessions[torch.float32]
    L, N = W.shape[0], s32.dims["N"]
    C, KM = K.cluster_width(N, L), s32.dp.ip_match_g.shape[1]
    shape = f"cfg10-tune-10k {family}: L={L} P={s32.dims['P']} N={N} S={W.shape[1]} G={s32.dims['G']}"
    log(f"{shape}: clusters of C={C} blocks a lane ({C * L} SMs), term-group lists KM={KM}; per-lane carries (bytes): "
        f"{json.dumps(carry_bytes(s32.cfg, s32.dims, s32.dp, torch.float32, L))}; exactness bound "
        f"{json.dumps(headroom(s32.bound))}; generation 0 weights {W.tolist()}")
    err = 0.0
    for dt, s in sessions.items():
        Wt = torch.as_tensor(W).to(device=dev, dtype=dt)
        kout = K.scan_population(s.cfg, s.dims, s.dp, Wt)
        for g in range(L):
            one = K.scan(s.cfg, s.dims, s.dp, weights=Wt[g].contiguous(), blocks=1)
            for k, v in one.items():
                if k == "final_carry":
                    for f, fv in v.items():
                        err = max(err, same(f"K9 {family} lane {g} final carry {f} {dt}",
                                            torch.as_tensor(kout[k][f])[g].reshape(-1), fv.reshape(-1)))
                else:
                    err = max(err, same(f"K9 {family} lane {g} {k} {dt}", kout[k][g], v))
            del one
        t0 = time.perf_counter()
        plain_ms, pdig = plain_refs[dt].get()
        log(f"plain version (worker process) waited for {time.perf_counter() - t0:.2f} s")
        kdig = out_digests(kout, lane=gp)
        err = max(err, same_digests(f"K9 {family} lane {gp} vs scan_plain {dt}",
                                    {k: v for k, v in kdig.items() if k in pdig}, pdig))
        ys = {"final_nonzero": kout["final_nonzero"], "selected": kout["selected"]}
        for name in TO.OBJECTIVES:
            err = max(err, same(f"objective {name} {dt}", TO.objective_value(name, ys, s.dp, s.age_w),
                                TO.objective_plain(name, ys, s.dp, s.age_w)))
            for g in range(L):
                one_ys = {k: v[g] for k, v in ys.items()}
                err = max(err, same(f"objective grad {name} lane {g} {dt}",
                                    TO.objective_grad(name, one_ys, s.dp, s.age_w),
                                    TO.objective_grad_plain(name, one_ys, s.dp, s.age_w)))
        values = TO.objective_value(obj, ys, s.dp, s.age_w).tolist()
        log(f"{family} {dt}: {L} lanes bitwise equal to K2 under their weights; lane {gp} ({frac[gp]} of "
            f"{W.shape[1]} weights fractional, {W[gp].tolist()}) equal to scan_plain ({plain_ms:.1f} ms); objective "
            f"values and cotangents equal their plain versions for {list(TO.OBJECTIVES)}; {obj} per lane {values}; "
            f"placed per lane {(kout['selected'] >= 0).sum(dim=1).tolist()}")
        if dt == torch.float32:
            k9_plain_ms = plain_ms
        del kout
        torch.cuda.empty_cache()
    # the plain scan is timed over one lane (lane gp): the 16 lanes in plain
    # would take ~16 x as long again
    return dict(plain_ms=k9_plain_ms, plain_shape=f"one lane (lane {gp}) of {shape}", err=err, shape=shape, C=C, KM=KM)


def k9_timed(dev, s32, W, obj, rec) -> dict:
    """K9 and its objective timed together over 20 launches in float32, the
    objective alone, and the bound: ``rec`` (from ``k9_checks``) completed."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.tuning import objective as TO

    Wt = torch.as_tensor(W).to(device=dev, dtype=torch.float32)

    def population():
        kout = K.scan_population(s32.cfg, s32.dims, s32.dp, Wt)
        return kout, TO.objective_value(obj, kout, s32.dp, s32.age_w)

    k9_ms, (kout, _v) = cuda_ms(population, 20, warmup=2)
    obj_ms, _v = cuda_ms(lambda: TO.objective_value(obj, kout, s32.dp, s32.age_w), 20, warmup=2)
    k9b, k9by = bound(population_counts(s32.cfg, s32.dims, s32.dp, Wt, kout), torch.float32)
    del kout
    torch.cuda.empty_cache()
    return dict(ms=k9_ms, objective_ms=obj_ms, bound_ms=k9b, bound_by=k9by, **rec)


def tune_start(dev) -> "tuple[dict, list]":
    """Phases 23-24's problems, and their plain references started in the
    card's worker processes (host-bound: ~100 s of the two workers), so
    that other phases run beside them before ``tune_phases`` checks them.
    Returns (the families' sessions and references, K2g's cases)."""
    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.tuning import objective as TO
    from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT

    t = workloads.TUNE
    scores, _filters = TT.profile_scores(device=DEVICE)
    families = {}
    for family in ("imbalance", "consolidate"):
        sess = {}
        for dt in (torch.float32, torch.float64):
            sess[dt], obj = tune_session(family, dt)
        if sess[torch.float32].promotion is not None:
            raise AssertionError(f"cfg10-tune-10k {family} promoted to float64: {sess[torch.float32].promotion}")
        W, gp, frac = generation0(sess[torch.float32], scores, t)
        refs = {dt: _GPU_POOL.apply_async(no_kernel_errors, (plain_lane_job, family, str(dt).split(".")[-1], W[gp].tolist()))
                for dt in sess}
        families[family] = (sess, obj, W, gp, frac, refs)
    sessions, _obj, W, gp, _frac, _refs = families["imbalance"]
    # K2g's cases: (dtype, objective); the hard rollout under the lane with
    # the most fractional weights, its cotangent, and grad_plain in a worker
    grad_cases = []
    for dt, objective in ((torch.float32, "fragmentation"), (torch.float64, "utilization"),
                          (torch.float32, "pending_age")):
        s = sessions[dt]
        w = torch.as_tensor(W[gp]).to(device=dev, dtype=dt)
        hard = K.scan_population(s.cfg, s.dims, s.dp, w[None].contiguous())
        ys = {"final_nonzero": hard["final_nonzero"][0], "selected": hard["selected"][0]}
        F = TO.objective_grad(objective, ys, s.dp, s.age_w)
        ref = None
        if objective != "pending_age":
            ref = _GPU_POOL.apply_async(no_kernel_errors, (plain_grad_job, str(dt).split(".")[-1], W[gp].tolist(), F.cpu().numpy(),
                                                         t["tau"]))
        grad_cases.append((dt, objective, s, w, hard, F, ref))
    return families, grad_cases


def tune_phases(dev, cpu_tune_ref, started: "tuple[dict, list]") -> "tuple[dict, dict]":
    """Phases 23-26 (cfg10-tune-10k and the bench's 12 x 96 size) on what
    ``tune_start`` set up: 23's and 24's checks against their plain
    references; K9 and K2g timed once the workers are idle.  Returns (K9's
    timing, K2g's timing)."""
    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import batch as B
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT

    t = workloads.TUNE
    size = dict(n_nodes=t["n_nodes"], n_pods=t["n_pods"])
    families, grad_cases = started
    del started
    sessions, obj, W, gp, frac, _refs = families["imbalance"]
    s32 = sessions[torch.float32]
    shape = f"cfg10-tune-10k imbalance: L={W.shape[0]} P={s32.dims['P']} N={s32.dims['N']} S={W.shape[1]}"

    with Phase("23. K9 at cfg10-tune-10k's imbalance and consolidate generation 0: lanes vs K2, the most "
               "fractional lane vs the plain scan, the objective kernel"):
        recs = {}
        for family, (sess, fobj, fW, fgp, ffrac, refs) in families.items():
            recs[family] = k9_checks(dev, sess, fW, fgp, ffrac, family, fobj, refs)

    with Phase(f"24. K2g at {shape.replace('L=16', 'one lane')}, tau {t['tau']}: against grad_plain"):
        k2g_err = 0.0
        for dt, objective, s, w, hard, F, ref in grad_cases:
            dw, out = K.scan_grad(s.cfg, s.dims, s.dp, w, F, t["tau"])
            for k, v in out.items():
                if k == "final_carry":
                    for f, fv in v.items():
                        same(f"K2g final carry {f}", fv.reshape(-1), torch.as_tensor(hard[k][f])[0].reshape(-1))
                else:
                    same(f"K2g {k} vs the hard rollout", v, hard[k][0])
            if objective == "pending_age":
                if dw.any():
                    raise AssertionError(f"pending_age: K2g gave {dw.tolist()}, not 0")
                log(f"pending_age {dt}: K2g exactly 0")
                continue
            tol = K2G_TOL[str(dt).split(".")[-1]]
            t0 = time.perf_counter()
            plain_ms, dw_p = ref.get()
            log(f"grad_plain (worker process) waited for {time.perf_counter() - t0:.2f} s")
            dw_p = torch.as_tensor(dw_p).to(dw.device)
            err = float((dw - dw_p).norm())
            rel = err / max(float(dw_p.norm()), 1e-300)
            log(f"{objective} {dt}: K2g {dw.tolist()}; grad_plain {dw_p.tolist()}; |dg| {err:.3e} = {rel:.3e} |g| "
                f"(tolerance {tol:g} |g|); final carry bitwise the hard rollout's; plain {plain_ms:.1f} ms")
            if not float(dw_p.norm()) > 0 or rel > tol:
                raise AssertionError(f"K2g {objective} {dt}: |dg| = {rel:.3e} |g| over the tolerance {tol:g}")
            k2g_err = max(k2g_err, float((dw - dw_p).abs().max()))
            if dt == torch.float32:
                k2g_plain_ms = plain_ms
                k2g_args = (s, w, F)

    with Phase("23-24. K9 (both problems) and K2g timed, the workers idle"):
        k9_t = k9_timed(dev, s32, W, obj, recs["imbalance"])
        csess, cobj, cW = families["consolidate"][:3]
        k9c = k9_timed(dev, csess[torch.float32], cW, cobj, recs["consolidate"])
        k9_t.update(consolidate_ms=k9c["ms"], consolidate_plain_ms=k9c["plain_ms"],
                    consolidate_bound_ms=k9c["bound_ms"], consolidate_bound_by=k9c["bound_by"],
                    consolidate_shape=k9c["shape"], consolidate_C=k9c["C"], consolidate_KM=k9c["KM"],
                    err=max(k9_t["err"], k9c["err"]))
        log(f"timing K9: {json.dumps(k9_t)}")
        s, w, F = k2g_args
        tau = t["tau"]
        k2g_ms, (_dw, kout) = cuda_ms(lambda: K.scan_grad(s.cfg, s.dims, s.dp, w, F, tau), 20, warmup=2)
        k2gb, k2gby = bound(grad_counts(s.cfg, s.dims, s.dp, w, F, kout), torch.float32)
        # its two launches apart, beside the hard forward the CEM tuner runs
        # (one lane of K9), the plain contraction and einsum on the same M
        fwd_ms, (M, _o) = cuda_ms(lambda: K.scan_grad_forward(s.cfg, s.dims, s.dp, w, tau), 20, warmup=2)
        hard_ms, _h = cuda_ms(lambda: K.scan_population(s.cfg, s.dims, s.dp, w[None].contiguous()), 20, warmup=2)
        c_ms, dwc = cuda_ms(lambda: K.grad_contract(M, F, tau), 200, warmup=10)
        cp_ms, dwp = cuda_ms(lambda: B.grad_contract_plain(M, F, tau), 20, warmup=2)
        Fd = F.double()
        lib_ms, _l = cuda_ms(lambda: torch.einsum("nj,jkn->k", Fd, M), 200, warmup=10)
        c_err = same("K2g contraction vs grad_contract_plain", dwc, dwp)
        cb, cby = bound(contract_counts(M, F), torch.float64)
        C = K.cluster_width(s.dims["N"], 1)
        k2g_t = dict(ms=k2g_ms, plain_ms=k2g_plain_ms, bound_ms=k2gb, bound_by=k2gby, err=k2g_err,
                     forward_ms=fwd_ms, hard_forward_ms=hard_ms, cluster=C,
                     contract=dict(ms=c_ms, plain_ms=cp_ms, library_ms=lib_ms, bound_ms=cb, bound_by=cby, err=c_err,
                                   shape=f"M [2, {M.shape[1]}, {M.shape[2]}] float64, F [{M.shape[2]}, 2] float32"),
                     shape=f"{shape.replace('L=16', 'one lane')}, fragmentation, lane {gp}'s weights")
        log(f"timing K2g (grad forward {fwd_ms:.3f} ms at C={C} against the hard forward {hard_ms:.3f} ms: "
            f"{100 * (fwd_ms / hard_ms - 1):+.1f} %; contraction {c_ms * 1e3:.2f} us): {json.dumps(k2g_t)}")
        del kout, M, _o, _h, sessions, families, csess, grad_cases, s32, s
        torch.cuda.empty_cache()

    with Phase(f"25. cfg10-tune-10k {size}: run_tuning on the card, float32, the bench's three rows"):
        svc = SchedulerService(ClusterStore(), device=DEVICE)
        svc.start_scheduler(None)
        seen: list = []
        note = svc.note_tuning_run
        svc.note_tuning_run = lambda session, report: (seen.append(session), note(session, report))
        launches = {"scan_population": 0, "scan_grad": 0, "grad_contract": 0}
        for family, tuner in workloads.TUNE_ROWS:
            K.reset_counts()
            t0 = time.perf_counter()
            rep = TT.run_tuning(family=family, tuner=tuner, seed=t["seed"], steps=t["steps"], pop=t["pop"],
                                tau=t["tau"], lr=t["lr"], svc=svc, **size)
            wall = time.perf_counter() - t0
            got = {k: K.LAUNCHES[k] for k in ("scan_population", "objective", "scan_grad", "grad_contract")}
            sess = seen[-1]
            rec = {k: rep[k] for k in ("defaultObjective", "tunedObjective", "improvement", "rollouts", "dispatches",
                                       "gradDispatches", "weights", "kernelPlatform")}
            log(f"{family}/{tuner}: wall {wall:.3f} s, {json.dumps(rec)}, launches {got}, "
                f"dtype {str(sess.dp.alloc.dtype).split('.')[-1]}, exactness {json.dumps(headroom(sess.bound))}, "
                f"population carries (bytes) {json.dumps(carry_bytes(sess.cfg, sess.dims, sess.dp, sess.dp.alloc.dtype, t['pop']))}, "
                f"history {json.dumps(rep['history'])}")
            # an evaluate or population call launches K9, a value-and-grad
            # call the grad forward (K2g) and the contraction
            problems = []
            if got["scan_population"] != rep["dispatches"] - rep["gradDispatches"]:
                problems.append(f"K9 launches {got['scan_population']} != dispatches {rep['dispatches']} - grad "
                                f"dispatches {rep['gradDispatches']}")
            if got["scan_grad"] != rep["gradDispatches"] or got["grad_contract"] != rep["gradDispatches"]:
                problems.append(f"K2g launches {got['scan_grad']} and contractions {got['grad_contract']} != grad "
                                f"dispatches {rep['gradDispatches']}")
            if sess.promotion is not None:
                problems.append(f"promoted: {sess.promotion}")
            if rep["tunedObjective"] < rep["defaultObjective"]:
                problems.append(f"tuned {rep['tunedObjective']} below default {rep['defaultObjective']}")
            if rep["kernelPlatform"] != torch.device(DEVICE).type:
                problems.append(f"kernelPlatform {rep['kernelPlatform']}")
            if problems:
                raise AssertionError(f"cfg10-tune-10k {family}/{tuner}: {'; '.join(problems)}")
            for k in launches:
                launches[k] += got[k]
            if family == "consolidate":
                k9_t["consolidate_launches"] = got["scan_population"]
            if tuner == "grad":
                k2g_t["grad_row_wall_s"] = wall
        k9_t["launches"], k2g_t["launches"] = launches["scan_population"], launches["scan_grad"]
        k2g_t["contract"]["launches"] = launches["grad_contract"]
        log(f"service counters: runs {svc.stats['tuning_runs']}, rollouts {svc.stats['tuning_rollouts']}, "
            f"grad dispatches {svc.stats['tuning_grad_dispatches']}, objectives {svc.stats['tuning_objective']}")
        del seen, svc
        torch.cuda.empty_cache()

    with Phase(f"26. the bench's {TUNE_PARITY} size and the zero-drift rounds: CUDA float64 vs CPU float64"):
        gpu_reps = tune_reports(DEVICE, torch.float64, TUNE_PARITY)
        gpu_rounds = tune_service_rounds(DEVICE, torch.float64)
        t0 = time.perf_counter()
        cpu_reps, cpu_rounds = cpu_tune_ref.get()
        log(f"CPU float64 (worker process) waited for {time.perf_counter() - t0:.2f} s")
        for g, c in zip(gpu_reps, cpu_reps):
            tag = f"{g['family']}/{g['tuner']}"
            log(f"{tag}: cuda {json.dumps({k: g[k] for k in ('weights', 'defaultObjective', 'tunedObjective', 'wall_s', 'launches')})}; "
                f"cpu weights {c['weights']} tuned {c['tunedObjective']}")
            if g["defaultObjective"] != c["defaultObjective"] or g["tunedObjective"] != c["tunedObjective"]:
                raise AssertionError(f"{tag}: objectives differ between CUDA and CPU float64")
            if g["tuner"] == "cem":
                if g["weights"] != c["weights"] or g["history"] != c["history"]:
                    raise AssertionError(f"{tag}: CEM weights or history differ between CUDA and CPU float64")
            else:
                dw = float(np.linalg.norm(np.subtract(g["weights"], c["weights"])))
                if dw > 1e-9 * float(np.linalg.norm(c["weights"])) or len(g["history"]) != len(c["history"]):
                    raise AssertionError(f"{tag}: grad weights differ by {dw:.3e}")
                for a, b in zip(g["history"], c["history"]):
                    if a["objective"] != b["objective"] or abs(a["gradNorm"] - b["gradNorm"]) > 1e-9 * b["gradNorm"]:
                        raise AssertionError(f"{tag}: grad history differs: {a} vs {b}")
        if gpu_rounds["folded"] != gpu_rounds["defaults"]:
            raise AssertionError("zero drift: the defaults as an override changed pod bytes on the card")
        for mode in ("folded", "defaults", "float"):
            if gpu_rounds[mode] != cpu_rounds[mode]:
                bad = [n for n in cpu_rounds[mode] if gpu_rounds[mode].get(n) != cpu_rounds[mode][n]]
                raise AssertionError(f"{mode}: {len(bad)} pods differ between the CUDA and CPU services, first {bad[:3]}")
        if not gpu_rounds["fractional"]:
            raise AssertionError("float weights rendered no fractional finalScore")
        log(f"three reports equal (CEM bitwise, grad within 1e-9); {len(gpu_rounds['folded'])} pods: defaults as an "
            f"override byte-identical to no override, and CUDA equal to CPU with no override, the defaults and "
            f"float weights {TUNE_FLOAT_WEIGHTS} (finalScore fractional)")
    return k9_t, k2g_t


# ------------------------------------------ the journal, recovery, promotion (phase 31)

def journal_store():
    """A store on cfg8-gang's pinned clock (SimClock: recovery restores it)."""
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

    return ClusterStore(clock=SimClock(SCENARIO_CLOCK))


def journal_service(store, device, dt):
    """cfg8-gang's service (run_gang's knobs) on ``store``, its clock pinned;
    not started."""
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

    return SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device=device, dtype=dt,
                            clock=SimClock(SCENARIO_CLOCK))


def attach_journal(store, svc, directory: str):
    """A journal epoch in ``directory``, wired as the reference's boot
    (server/di.py) wires it: attached to the store, the scheduler's meta on
    every record, the snapshot service's export as the checkpoint."""
    from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService
    from kube_scheduler_simulator_tpu_torch.state.journal import Journal
    from kube_scheduler_simulator_tpu_torch.state.recovery import build_checkpoint, scheduler_meta_provider

    journal = Journal(directory)
    store.attach_journal(journal)
    journal.add_meta_provider(scheduler_meta_provider(svc))
    snap = SnapshotService(store, svc)
    journal.checkpoint_provider = lambda: build_checkpoint(store, snap)
    return journal


def arm_kill(journal) -> None:
    """``kill_at`` one record past the first gang-release record from now:
    the process dies (SIGKILL) the instant that record is durable."""
    append = journal.append

    def armed(rtype, events=None, extra=None):
        if rtype == "gang-release" and journal.kill_at is None:
            journal.kill_at = journal.stats["records"] + 2
        return append(rtype, events, extra)

    journal.append = armed


def journal_waves(store, svc, plan, spec, first: int = 0, resume: bool = False, kill_wave=None,
                  progress: "str | None" = None, who: str = "") -> list:
    """cfg8-gang's waves ``first``.. on a started service: ``gang_wave``
    (``resume``: the first re-runs a crashed wave, skipping what is already
    there), ``schedule_pending(max_rounds=3)``, then a recovery mark
    (``write_mark``).  A wave fails on a partially bound group or a verdict
    mismatch.  Per wave: wall, ``commit_s``, the journal's append seconds,
    records and bytes (0 with no journal).  ``kill_wave``: arm the kill at
    that wave's start; ``progress``: a file each wave's record is appended
    to (a killed process returns nothing)."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.gang import partially_bound_groups
    from kube_scheduler_simulator_tpu_torch.state.recovery import write_mark

    out = []
    for w in range(first, spec["waves"]):
        journal = store.journal
        if w == kill_wave:
            arm_kill(journal)
        workloads.gang_wave(store, plan, spec["waves"], w, resume=resume and w == first)
        js0 = dict(journal.stats) if journal is not None else {"records": 0, "bytes": 0}
        ja0, c0, r0 = store._journal_s, svc.stats["commit_s"], svc.stats["gang_released_pods"]
        mm0 = svc.stats["gang_verdict_mismatch"]
        t0 = time.perf_counter()
        svc.schedule_pending(max_rounds=3)
        write_mark(svc, w)
        js = journal.stats if journal is not None else js0
        rec = dict(wave=w, wall_s=time.perf_counter() - t0, commit_s=svc.stats["commit_s"] - c0,
                   journal_append_s=store._journal_s - ja0, records=js["records"] - js0["records"],
                   bytes=js["bytes"] - js0["bytes"], released_pods=svc.stats["gang_released_pods"] - r0)
        partial = partially_bound_groups(store)
        if partial or svc.stats["gang_verdict_mismatch"] != mm0:
            raise AssertionError(f"{who} wave {w}: partially bound {partial[:3]}, verdict mismatches "
                                 f"{svc.stats['gang_verdict_mismatch'] - mm0}")
        out.append(rec)
        log(f"{who} wave {w}: {json.dumps(rec, sort_keys=True)}")
        if progress is not None:
            with open(progress, "a") as f:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
    return out


def journal_primary(directory: str, progress: str, spec: dict, device: str) -> None:
    """Phase 31's primary, a spawned process: cfg8-gang in float32 with a
    journal in ``directory`` wired from the first mutation on, a mark after
    each wave, killed by ``kill_at`` one record past wave 4's first
    gang-release record.  Exits 3 when the kill never fired."""
    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    if device == "cuda":
        K.build()
    store = journal_store()
    svc = journal_service(store, device, torch.float32)
    attach_journal(store, svc, directory)
    plan = workloads.gang_setup(store, **{k: v for k, v in spec.items() if k != "waves"})
    svc.start_scheduler(gang_scheduler_config())
    journal_waves(store, svc, plan, spec, kill_wave=JOURNAL_KILL_WAVE, progress=progress, who="primary")
    sys.exit(3)


def preview_launch(store, dev) -> dict:
    """A 32-member group previewed at the store's final state (K7): its
    answer."""
    from kube_scheduler_simulator_tpu_torch.gang import engine as GE
    from kube_scheduler_simulator_tpu_torch.gang.scenario import make_member

    store.create("podgroups", {"metadata": {"name": "preview-ok"}, "spec": {"minMember": 32}})
    for m in range(32):
        store.create("pods", make_member(f"preview-ok-m{m}", "preview-ok"))
    return GE.group_preview(store, store.get("podgroups", "preview-ok"), device=dev)


def journal_leg(role: str, spec: dict, device: str, out, go=None, directory: str = "", epoch: str = "") -> None:
    """One of phase 31's legs in a spawned process on the card, its answer
    put on ``out`` as (role, record) or (role, the error): "uninterrupted",
    cfg8-gang run through; "recovered", once ``go`` is set (the primary is
    dead): ``boot_recover`` of ``directory`` into a fresh store, a fresh
    service restarted from the journaled configuration,
    ``restore_scheduler_state``, a new journal epoch in ``epoch``, the
    crashed wave re-run from the last mark, then the rest.  The record:
    the parity digest, a 32-member preview at the final state, the waves,
    the launches (counts reset before the waves) and, recovered, the
    replay."""
    import traceback

    try:
        import torch

        from kube_scheduler_simulator_tpu_torch import workloads
        from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config
        from kube_scheduler_simulator_tpu_torch.ops import kernels as K
        from kube_scheduler_simulator_tpu_torch.state.recovery import boot_recover, restore_scheduler_state
        from kube_scheduler_simulator_tpu_torch.utils.parity import parity_digest

        if device == "cuda":
            K.build()
        setup = {k: v for k, v in spec.items() if k != "waves"}
        rec: dict = {}
        store = journal_store()
        if role == "uninterrupted":
            svc = journal_service(store, device, torch.float32)
            plan = workloads.gang_setup(store, **setup)
            svc.start_scheduler(gang_scheduler_config())
            first, resume = 0, False
        else:
            plan = workloads.gang_setup(journal_store(), **setup)
            go.wait()
            t0 = time.perf_counter()
            report = boot_recover(directory, store)
            rec.update(replay_s=time.perf_counter() - t0, recovery=report.stats())
            svc = journal_service(store, device, torch.float32)
            journal = attach_journal(store, svc, epoch)
            svc.start_scheduler(report.scheduler_config)
            restore_scheduler_state(svc, report)
            journal.last_mark = report.last_mark
            store.journal_append("boot", {"recovered": True})
            first, resume = int((report.last_mark or {}).get("tick", -1)) + 1, True
        K.reset_counts()
        rec["waves"] = journal_waves(store, svc, plan, spec, first=first, resume=resume, who=role)
        rec["digest"] = parity_digest(store)
        rec["preview"] = preview_launch(store, torch.device(device))
        rec.update(launches=dict(K.LAUNCHES), resumed_from=first, pods=len(store.list("pods", copy_objects=False)))
        if store.journal is not None:
            store.journal.close()
            rec["epoch"] = dict(store.journal.stats)
        if kernel_degrades():
            raise AssertionError(f"the {role} leg degraded kernel errors: {kernel_degrades()}")
        out.put((role, rec))
    except BaseException:  # noqa: BLE001 - handed to the phase, which fails on it
        out.put((role, {"error": traceback.format_exc()}))


def journal_phases(dev) -> dict:
    """Phase 31, cfg8-gang-journal, four legs on the card: (a) cfg8-gang
    uninterrupted, its parity digest the target (a spawned process); (b)
    the same run journaled in a spawned primary, killed inside wave 4,
    while this process tails its journal live with a ReplicaApplier; (c)
    recovery and resume in a spawned process (``journal_leg``); (d)
    ``promote_replica`` of the live replica in this process, resumed the
    same way, beside (c).  Each resumed leg's digest must equal (a)'s, with
    no partially bound group, and its preview (a)'s.  Returns the launches
    by leg and the numbers."""
    import queue
    import signal
    import tempfile

    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.replication import ReplicaApplier, promote_replica
    from kube_scheduler_simulator_tpu_torch.state import journal as J
    from kube_scheduler_simulator_tpu_torch.utils.parity import parity_digest

    spec, dt = JOURNAL_GANG, torch.float32
    device = "cuda" if dev.type == "cuda" else "cpu"
    tmp = tempfile.mkdtemp(prefix="kss-journal-")
    jdir, progress = os.path.join(tmp, "primary"), os.path.join(tmp, "progress.jsonl")
    os.makedirs(jdir)
    ctx = multiprocessing.get_context("spawn")
    answers, go = ctx.Queue(), ctx.Event()
    legs = [ctx.Process(target=journal_leg, args=("uninterrupted", spec, device, answers)),
            ctx.Process(target=journal_leg, args=("recovered", spec, device, answers, go, jdir,
                                                 os.path.join(tmp, "epoch-a")))]
    out: dict = {"launches": {}}
    got: dict = {}

    def collect(role: str) -> dict:
        while role not in got:
            try:
                r, rec = answers.get(timeout=600)
            except queue.Empty:
                raise AssertionError(f"phase 31: no answer from the {role} leg") from None
            if "error" in rec:
                raise AssertionError(f"phase 31, the {r} leg:\n{rec['error']}")
            got[r] = rec
        return got[role]

    try:
        with Phase(f"31a-b. cfg8-gang {spec}: uninterrupted (a spawned process on the card), and journaled in a "
                   f"spawned primary on the card killed inside wave 4, a ReplicaApplier tailing its journal live"):
            for p in legs:
                p.start()
            t0 = time.perf_counter()
            child = ctx.Process(target=journal_primary, args=(jdir, progress, spec, device))
            child.start()
            rstore = journal_store()
            applier = ReplicaApplier(rstore, jdir, notify=False)
            applier.bootstrap()
            lag_records, lag_s, polls = 0, 0.0, 0
            while child.is_alive():
                applier.step()
                polls += 1
                lag_records = max(lag_records, int(applier.stats["lag_records"]))
                lag_s = max(lag_s, float(applier.stats["lag_seconds"]))
                time.sleep(0.02)
            child.join()
            t_child = time.perf_counter() - t0
            if child.exitcode != -signal.SIGKILL:
                raise AssertionError(f"the primary exited {child.exitcode}: the kill inside wave 4 never fired")
            go.set()
            t1 = time.perf_counter()
            applier.step()
            drain_s = time.perf_counter() - t1
            primary_waves = [json.loads(ln) for ln in open(progress)]
            seg_bytes = sum(os.path.getsize(p) for _i, p in J.list_segments(jdir))
            out.update(primary_waves=primary_waves, journal_records=applier.stats["records_shipped"],
                       journal_bytes=seg_bytes, replica=dict(applier.stats), replica_lag_records_max=lag_records,
                       replica_lag_s_max=lag_s, replica_polls=polls, replica_drain_s=drain_s, primary_s=t_child)
            log(f"primary killed (exit {child.exitcode}) after {t_child:.2f} s: journal "
                f"{applier.stats['records_shipped']} records, {seg_bytes} bytes; replica {json.dumps(applier.stats)}, "
                f"max lag {lag_records} records / {lag_s:.3f} s over {polls} polls, final drain {drain_s:.3f} s")
            if applier.stats["torn_records"]:
                raise AssertionError(f"the replica read torn records: {applier.stats}")
            target = collect("uninterrupted")
            out["launches"]["uninterrupted"] = target["launches"]
            log(f"uninterrupted: {target['pods']} pods, digest {target['digest']}, launches {target['launches']}")

        with Phase("31c-d. leg (a): boot_recover and resume (a spawned process on the card), beside leg (b): "
                   "promote_replica, resumed the same way"):
            plan = workloads.gang_setup(journal_store(), **{k: v for k, v in spec.items() if k != "waves"})
            t0 = time.perf_counter()
            promotion = promote_replica(applier, lambda s: journal_service(s, dev, dt))
            promote_s = time.perf_counter() - t0
            svc = promotion.service
            journal = attach_journal(rstore, svc, jdir)
            journal.last_mark = promotion.recovery.last_mark
            rstore.journal_append("boot", {"promoted": True})
            first_b = int((promotion.recovery.last_mark or {}).get("tick", -1)) + 1
            K.reset_counts()
            waves_b = journal_waves(rstore, svc, plan, spec, first=first_b, resume=True, who="leg (b)")
            digest_b = parity_digest(rstore)
            preview_b = preview_launch(rstore, dev)
            out["launches"]["promoted"] = dict(K.LAUNCHES)
            journal.close()
            out.update(promote_s=promote_s, promotion=promotion.stats(), promoted_waves=waves_b,
                       promoted_epoch=dict(journal.stats))
            log(f"leg (b): promotion {json.dumps(promotion.stats())} in {promote_s:.3f} s, resumed from wave "
                f"{first_b}, digest {digest_b}, launches {out['launches']['promoted']}")
            del rstore, svc, promotion, applier
            rec_a = collect("recovered")
            out["launches"]["recovered"] = rec_a["launches"]
            out.update(replay_s=rec_a["replay_s"], recovery=rec_a["recovery"], resumed_from=rec_a["resumed_from"],
                       recovered_waves=rec_a["waves"], recovered_epoch=rec_a["epoch"])
            log(f"leg (a): recovery {json.dumps(rec_a['recovery'])} in {rec_a['replay_s']:.3f} s, resumed from wave "
                f"{rec_a['resumed_from']}, digest {rec_a['digest']}, launches {rec_a['launches']}, new epoch "
                f"{json.dumps(rec_a['epoch'])}")
            for leg, digest, partial, preview in (
                ("(a) recovered", rec_a["digest"], rec_a["recovery"]["partial_gangs"], rec_a["preview"]),
                ("(b) promoted", digest_b, out["promotion"]["partial_gangs"], preview_b),
            ):
                if digest != target["digest"] or partial or preview != target["preview"]:
                    raise AssertionError(f"leg {leg}: digest {digest} != {target['digest']}, or {partial} partially "
                                         f"bound groups, or another preview")
            log(f"both legs' digests and previews equal the uninterrupted run's; no partially bound group")
    finally:
        go.set()
        for p in legs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
        shutil.rmtree(tmp, ignore_errors=True)
    for leg in ("recovered", "promoted"):
        launches = out["launches"][leg]
        log(f"{leg} leg: K6 {launches['gang_verdict']} launches, K7 {launches['gang_feasibility']}, "
            f"K2w {launches['scan']}, K3 {launches['compact']}")
        if dev.type == "cuda" and not (launches["gang_verdict"] and launches["gang_feasibility"]
                                       and launches["scan"] and launches["compact"]):
            raise AssertionError(f"the {leg} leg did not launch K2w, K3, K6 and K7: {launches}")
    return out


# ------------------------------------------ the extenderv1 bridge (phases 32-33)

def bridge_cluster(dev, dt, name: str = "north"):
    """A workload's 5 000 nodes with 5 000 of its pods bound in a store, a
    default-profile service over it (not scheduling), its bridge, and the
    pending pods and candidate lists phase 32 asks about
    (``BRIDGE_LEGS[name]``): (bridge, nodes, cases), a case (pod, candidate
    node names or None for every node)."""
    import random

    from kube_scheduler_simulator_tpu_torch.scheduler.scorer_bridge import TPUScorerBridge
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    spec = BRIDGE_LEGS[name]
    n_pods, n_nodes, n_bound = spec["pods"], WORKLOADS[name].nodes, spec["bound"]
    nodes, all_pods, pending, _vols = make_cluster(name, (n_pods, n_nodes, n_bound))
    store = ClusterStore(clock=lambda: 0.0)
    store.create("namespaces", {"metadata": {"name": "default"}})
    for n in nodes:
        store.create("nodes", n)
    for p in all_pods[:n_bound]:
        store.create("pods", p)
    svc = SchedulerService(store, tie_break="first", device=dev, dtype=dt)
    svc.start_scheduler(None)
    names = [n["metadata"]["name"] for n in nodes]
    rng = random.Random(17)
    cases = [(p, rng.sample(names, spec["sample"])) for p in pending[: spec["pods"]]]
    cases += [(p, None) for p in pending[: spec["full"]]]
    return TPUScorerBridge(svc), nodes, cases


def filter_split(resp) -> tuple:
    """(passed names, failedNodes, failedAndUnresolvableNodes) of a Filter
    response in either mode."""
    passed = resp["nodenames"] if resp.get("nodenames") is not None else [
        n["metadata"]["name"] for n in (resp.get("nodes") or {}).get("items") or []]
    return list(passed), dict(resp.get("failedNodes") or {}), dict(resp.get("failedAndUnresolvableNodes") or {})


def cpu_bridge_oracle(name: str = "north") -> list:
    """Phase 32's reference for one leg: the bridge's own oracle fallbacks
    (the sequential plugins) for every case, on the CPU in float64: per
    case (passed, failed, unresolvable) and the Prioritize scores over the
    passed nodes."""
    import torch

    bridge, nodes, cases = bridge_cluster(torch.device("cpu"), torch.float64, name)
    by_name = {n["metadata"]["name"]: n for n in nodes}
    out = []
    for pod, names in cases:
        cand = nodes if names is None else [by_name[nm] for nm in names]
        passed, failed, unresolvable = bridge._filter_fallback(pod, cand)
        scores = bridge._prioritize_fallback(pod, passed) if passed else []
        out.append(([n["metadata"]["name"] for n in passed], failed, unresolvable,
                    {e["host"]: e["score"] for e in scores}))
    return out


def bridge_phase(dev, oracle_ref, name: str = "north") -> dict:
    """Phase 32, one leg: extenderv1 Filter, then Prioritize over the
    passed nodes, through the bridge on the card at ``name`` (north: 16
    pods over candidate lists of 500 names, 2 over every node in full
    ``nodes`` mode; cfg4: 8 pods over 500 names), each response held
    against the bridge's oracle fallback for the same pod (from a CPU
    worker); no fallback, no error.  Returns the launches and latencies."""
    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    spec = BRIDGE_LEGS[name]
    with Phase(f"32. the scorer bridge at {name} (5 000 nodes, {spec['bound']} bound): Filter and Prioritize "
               f"for {spec['pods']} pods over {spec['sample']} candidates, {spec['full']} over every node, "
               f"float32, on the card"):
        bridge, nodes, cases = bridge_cluster(dev, torch.float32, name)
        lat: dict = {}
        got = []
        K.reset_counts()
        for c, (pod, names) in enumerate(cases):
            mode = "nodes" if names is None else "nodenames"
            t0 = time.perf_counter()
            # extenderv1 ExtenderArgs: full node objects, or names only
            f = bridge.filter({"pod": pod, "nodes": {"items": nodes}} if names is None
                              else {"pod": pod, "nodenames": names})
            t1 = time.perf_counter()
            fst = bridge._engine.profiler.snapshot()["last_wave"]
            if f["error"]:
                raise AssertionError(f"case {c}: Filter error {f['error']!r}")
            passed, failed, unresolvable = filter_split(f)
            calls = [("filter", t1 - t0, fst)]
            p = []
            if passed:
                # a scheduler asks Prioritize about the nodes that passed,
                # and about none when none did
                pargs = ({"pod": pod, "nodes": {"items": f["nodes"]["items"]}} if names is None
                         else {"pod": pod, "nodenames": passed})
                t2 = time.perf_counter()
                p = bridge.prioritize(pargs)
                calls.append(("prioritize", time.perf_counter() - t2, bridge._engine.profiler.snapshot()["last_wave"]))
            got.append((passed, failed, unresolvable, {e["host"]: e["score"] for e in p}))
            for verb, wall, st in calls:
                row = {"wall_ms": 1e3 * wall, "encode_ms": 1e3 * (st.get("encode", 0.0) + st.get("upload", 0.0)),
                       "kernel_ms": 1e3 * (st.get("dispatch", 0.0) + st.get("device_blocked", 0.0)),
                       "fetch_ms": 1e3 * st.get("trace_fetch", 0.0)}
                lat.setdefault((verb, mode), []).append(row)
        launches = dict(K.LAUNCHES)
        if bridge.fallbacks:
            raise AssertionError(f"the bridge fell back {bridge.fallbacks} times")
        med = {f"{verb} {mode} ({len(rows)} calls)": {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
               for (verb, mode), rows in lat.items()}
        log(f"{name}: bridge launches {launches}; median latency by verb: {json.dumps(med)}")
        t0 = time.perf_counter()
        oracle = oracle_ref.get()
        log(f"the oracle (CPU worker) waited for {time.perf_counter() - t0:.2f} s")
        for c, ((kp, kf, ku, ks), (op, of, ou, os_)) in enumerate(zip(got, oracle)):
            if kp != op or kf != of or ku != ou:
                raise AssertionError(f"case {c}: Filter differs from the oracle: passed {len(kp)}/{len(op)}, "
                                     f"failed {len(kf)}/{len(of)}, unresolvable {len(ku)}/{len(ou)}")
            if ks != os_:
                bad = [h for h in ks if ks[h] != os_.get(h)]
                raise AssertionError(f"case {c}: Prioritize differs from the oracle on {len(bad)} nodes, first {bad[:3]}")
        counts = [(len(kp), len(kf), len(ku)) for kp, kf, ku, _s in got]
        log(f"{len(cases)} cases equal the oracle (passed, failed, unresolvable per case: {counts}); "
            f"requests {bridge.requests}, fallbacks {bridge.fallbacks}")
        n_calls = sum(bridge.requests.values())
        if dev.type == "cuda" and launches["scan"] != n_calls:
            raise AssertionError(f"the bridge launched K2 {launches['scan']} times for {n_calls} calls")
    return {"launches": launches, "latency": med}


def bridge_server(bridge):
    """(server, its URL prefix, the calls seen, the handler errors): a
    stdlib ThreadingHTTPServer on 127.0.0.1 serving ``bridge`` at the
    reference's routes (server/server.py:606-611),
    ``/api/v1/tpuscorer/{filter,prioritize}``, on a thread of its own;
    every call's Filter error and every handler error is kept for the phase
    to check."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    calls: list = []
    errors: list = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def do_POST(self):
            try:
                args = json.loads(self.rfile.read(int(self.headers.get("Content-Length") or 0)))
                verb = self.path.rsplit("/", 1)[-1]
                if self.path == "/api/v1/tpuscorer/filter":
                    out = bridge.filter(args)
                elif self.path == "/api/v1/tpuscorer/prioritize":
                    out = bridge.prioritize(args)
                else:
                    raise ValueError(f"no route {self.path}")
                calls.append((verb, out.get("error", "") if isinstance(out, dict) else ""))
                code, data = 200, json.dumps(out).encode()
            except Exception as exc:  # noqa: BLE001 - kept for the phase to fail on
                errors.append(f"{type(exc).__name__}: {exc}")
                code, data = 500, json.dumps({"error": str(exc)}).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}/api/v1/tpuscorer", calls, errors


def extender_round(device, dt) -> "tuple[dict, dict, dict]":
    """Phase 33's round: cfg2's cluster with its first EXTENDER_PODS pods
    pending, a default-profile bridge service over the store served over
    HTTP, and a scheduler whose configuration has an extender stanza
    (filter and prioritize verbs, weight 1, nodeCacheCapable) pointing at
    it; one ``schedule_pending`` round, which takes the sequential cycle.
    Returns (record, binds, the extender annotations with the bridge's URL
    replaced by a placeholder), over the pods the round scheduled (cfg2's
    pod 5 arrives bound to node-7 by nodeName)."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler.scorer_bridge import TPUScorerBridge
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

    nodes, _all, pending, _vols = make_cluster("cfg2")
    store = ClusterStore(clock=SimClock(SCENARIO_CLOCK))
    store.create("namespaces", {"metadata": {"name": "default"}})
    for n in nodes:
        store.create("nodes", n)
    for p in pending[:EXTENDER_PODS]:
        store.create("pods", p)
    scheduled = {p["metadata"]["name"] for p in pending[:EXTENDER_PODS] if not p["spec"].get("nodeName")}
    scorer = SchedulerService(store, tie_break="first", device=device, dtype=dt)
    scorer.start_scheduler(None)
    bridge = TPUScorerBridge(scorer)
    server, url, calls, errors = bridge_server(bridge)
    try:
        svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device=device,
                               dtype=dt, clock=SimClock(SCENARIO_CLOCK))
        svc.start_scheduler({"percentageOfNodesToScore": 100, "extenders": [{
            "urlPrefix": url, "filterVerb": "filter", "prioritizeVerb": "prioritize", "weight": 1,
            "nodeCacheCapable": True}]})
        K.reset_counts()
        t0 = time.perf_counter()
        svc.schedule_pending(max_rounds=1)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
    rec = dict(wall_s=wall, launches=launches, calls=len(calls), requests=dict(bridge.requests),
               fallbacks=bridge.fallbacks, errors=errors, filter_errors=[e for _v, e in calls if e],
               batch_fallbacks=dict(svc.stats["batch_fallbacks"]), sequential_pods=svc.stats["sequential_pods"],
               pending=len(scheduled))
    binds, docs = {}, {}
    for p in store.list("pods", copy_objects=False):
        nm = p["metadata"]["name"]
        if nm not in scheduled:
            continue
        binds[nm] = (p.get("spec") or {}).get("nodeName")
        docs[nm] = {k: v.replace(url, "<bridge>") for k, v in (p["metadata"].get("annotations") or {}).items()
                    if k.startswith("scheduler-simulator/extender-")}
    return rec, binds, docs


def cpu_extender() -> "tuple[dict, dict, dict]":
    """Phase 33's round on the CPU in float64 (the bridge too)."""
    import torch

    return extender_round(torch.device("cpu"), torch.float64)


def extender_phase(dev, cpu_ref) -> dict:
    """Phase 33: the extender round on the card (every extender call one
    kernel pass of the bridge), its binds and extender annotation bytes
    against the same round in float64 on the CPU (a worker).  Returns the
    round's record."""
    import torch

    with Phase(f"33. the extender round: {EXTENDER_PODS} cfg2 pods through the sequential cycle, the extender "
               f"stanza served by the bridge over HTTP on the card, float32"):
        rec, binds, docs = extender_round(dev, torch.float32)
        log(f"extender round: {json.dumps(rec, sort_keys=True)}")
        problems = []
        if rec["errors"] or rec["filter_errors"]:
            problems.append(f"handler errors {rec['errors'][:3]}, Filter errors {rec['filter_errors'][:3]}")
        if rec["fallbacks"]:
            problems.append(f"{rec['fallbacks']} bridge fallbacks")
        if rec["batch_fallbacks"] != {"extender webhooks configured": 1} or rec["sequential_pods"] != rec["pending"]:
            problems.append(f"batch fallbacks {rec['batch_fallbacks']}, sequential pods {rec['sequential_pods']} of "
                            f"{rec['pending']}")
        if not all(binds.values()) or sum(1 for d in docs.values() if len(d) == 2) != rec["pending"]:
            problems.append("a pod unbound or without both extender annotations")
        if dev.type == "cuda" and rec["launches"]["scan"] != rec["calls"]:
            problems.append(f"K2 launches {rec['launches']['scan']} for {rec['calls']} extender calls")
        if problems:
            raise AssertionError(f"extender round: {'; '.join(problems)}")
        t0 = time.perf_counter()
        rec_cpu, binds_cpu, docs_cpu = cpu_ref.get()
        log(f"CPU float64 round (worker process) waited for {time.perf_counter() - t0:.2f} s: "
            f"{json.dumps(rec_cpu, sort_keys=True)}")
        if binds != binds_cpu:
            bad = [n for n in binds if binds[n] != binds_cpu.get(n)]
            raise AssertionError(f"{len(bad)} binds differ between the CUDA and CPU rounds, first {bad[:3]}")
        if docs != docs_cpu:
            bad = [n for n in docs if docs[n] != docs_cpu.get(n)]
            raise AssertionError(f"{len(bad)} pods' extender annotations differ, first {bad[:3]}")
        size = sum(len(v) for d in docs.values() for v in d.values())
        log(f"{len(binds)} binds and {size} bytes of extender annotations equal between the CUDA and CPU rounds")
    return rec


# ------------------------------------------ plain references on the card, in workers

# phase 34 (the simulator process at north): north's nodes and pending pods
# imported over HTTP, ``arrivals`` more created over the kube API, ``gets``
# seeded pods read back over both APIs, and one session at cfg2's size
SIM = dict(nodes=5000, pods=10000, arrivals=100, group=8, gets=10, seed=7, cordon="node-17")
SIM_SESSION = "cfg2"
SIM_CLOCK = 1_700_000_000.0


def sim_http(port: int, method: str, path: str, body=None, timeout: float = 600.0):
    """(status, body bytes) of one request to 127.0.0.1:``port``."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def sim_cluster():
    """(nodes, pending pods, arrivals) of north at phase 34's size."""
    from kube_scheduler_simulator_tpu_torch import workloads

    w = WORKLOADS["north"]
    nodes, _all, pending = workloads.cluster(SIM["pods"] + SIM["arrivals"], SIM["nodes"], seed=42,
                                             n_bound=0, spread=w.spread, interpod=w.interpod)
    return nodes, pending[: SIM["pods"]], pending[SIM["pods"]:]


def session_snapshot() -> dict:
    """The import body of phase 34's session: cfg2's nodes, bound and
    pending pods, each pod with the creationTimestamp an exported snapshot
    carries.  A session's store stamps what arrives without one from the
    wall clock, in whole seconds, and the queue sorts by that stamp, then
    by the store's name order: unstamped, the order of the session's round
    would depend on where a second boundary fell during the import."""
    nodes, all_pods, _pending, _vols = make_cluster(SIM_SESSION)
    stamp = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(SIM_CLOCK))
    for p in all_pods:
        p["metadata"]["creationTimestamp"] = stamp
    return {"nodes": nodes, "pods": all_pods}


def wait_bound(store, n: int, timeout: float = 600.0, kind_ok=None) -> float:
    """Wait until ``n`` pods of ``store`` are bound; the seconds waited."""
    t0 = time.perf_counter()
    while True:
        bound = sum(1 for p in store.list("pods", copy_objects=False) if (p.get("spec") or {}).get("nodeName"))
        if bound >= n:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{bound} of {n} pods bound after {timeout} s")
        time.sleep(0.01)


def round_done(svc) -> None:
    """Wait for the loop's round in flight to end: a tick holds the
    service's quiesce gate, and a round writes its annotations after its
    binds."""
    with svc.pause_streams("phase 34 read"):
        pass


def sim_direct(device: str = DEVICE) -> "tuple[dict, float]":
    """The reference run of phase 34's steps 1-3: a SchedulerService built
    as DIContainer builds it (default configuration, seed 0, use_batch
    auto), the snapshot loaded as POST /api/v1/import loads it, then
    ``schedule_pending`` directly, then the arrivals' first half, the node
    cordoned, the second half, ``schedule_pending`` after each.  Returns
    (pod_digests, its wall); a worker process on the card runs it beside
    the server's phase."""
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    t0 = time.perf_counter()
    nodes, pending, arrivals = sim_cluster()
    store = ClusterStore(clock=lambda: SIM_CLOCK)
    svc = SchedulerService(store, seed=0, use_batch="auto", autoscale="off", device=device)
    svc.start_scheduler(None)
    SnapshotService(store, svc).load({"nodes": nodes, "pods": pending})
    svc.schedule_pending()
    for half, part in enumerate(arrival_halves(arrivals)):
        if half:
            store.patch("nodes", SIM["cordon"], {"spec": {"unschedulable": True}})
        for p in part:
            store.create("pods", copy.deepcopy(p))
        svc.schedule_pending()
    return pod_digests(store), time.perf_counter() - t0


def arrival_halves(arrivals: list) -> "tuple[list, list]":
    """Phase 34's arrivals before and after the cordon."""
    cut = len(arrivals) // 2
    return arrivals[:cut], arrivals[cut:]


def arrival_parts(arrivals: list) -> list:
    """The server's sends: each half in a burst and a group of
    ``SIM["group"]`` pods, the groups next to the cordon, each part
    landing before the next is sent.  A group's rounds have at most a
    group's pods, so the rounds on both sides of the cordon share one
    shape and the next one writes the cordoned row with K4."""
    first, second = arrival_halves(arrivals)
    g = SIM["group"]
    return [first[:-g], first[-g:], second[:g], second[g:]]


def cpu_sim_session() -> dict:
    """Phase 34's session reference: a container on the CPU in float64
    (``DIContainer(device="cpu")``, as the session's but for the device)
    loads cfg2's snapshot and schedules it in one round, as the session's
    loop does.  Returns pod_digests."""
    from kube_scheduler_simulator_tpu_torch.server import DIContainer

    di = DIContainer(device="cpu", enable_simulator_operator=False)
    try:
        di.snapshot_service().load(session_snapshot())
        di.scheduler_service().schedule_pending(max_rounds=1)
        return pod_digests(di.cluster_store)
    finally:
        di.close()


def simulator_phase(dev, session_ref, direct_ref) -> dict:
    """Phase 34: the simulator process at north on the card, in this
    process: DIContainer + SimulatorServer with both APIs on ephemeral
    ports, the background loop scheduling what clients create.  Held
    against ``direct_ref`` (sim_direct, a worker process on the card that
    runs beside this phase) and ``session_ref`` (cpu_sim_session)."""
    import random
    import threading

    import numpy as np

    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.server import DIContainer, SimulatorServer
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.tenancy import SUBSTRATE

    rec: dict = {"launches": {}}
    steps: dict = {}
    t_mark = [time.perf_counter()]

    def mark(name: str) -> None:
        now = time.perf_counter()
        steps[name] = round(now - t_mark[0], 3)
        t_mark[0] = now

    with Phase(f"34. the simulator process at north ({SIM['nodes']} nodes, {SIM['pods']} pods imported, "
               f"{SIM['arrivals']} over the kube API, a session at {SIM_SESSION}), on the card"):
        nodes, pending, arrivals = sim_cluster()
        snapshot = {"nodes": nodes, "pods": pending}
        mark("generate")
        di = DIContainer(cluster_store=ClusterStore(clock=lambda: SIM_CLOCK), device=dev)
        server = SimulatorServer(di, port=0, kube_api_port=0)
        port = server.start(background=True)
        mark("boot")
        kport = server.kube_api_port
        store, svc = di.cluster_store, di.scheduler_service()
        log(f"serving the simulator API on 127.0.0.1:{port}, the kube API on 127.0.0.1:{kport}, device {di.device}")
        try:
            # 1-2. the import, and the loop's round over it
            K.reset_counts()
            t0 = time.perf_counter()
            code, _b = sim_http(port, "POST", "/api/v1/import", snapshot)
            t_import = time.perf_counter() - t0
            if code != 200:
                raise AssertionError(f"import answered {code}: {_b[:300]!r}")
            t_round = wait_bound(store, len(pending))
            round_done(svc)
            mark("import and first round")
            first = dict(K.LAUNCHES)
            rec["launches"]["import round"] = first
            eng = svc._batch_engine
            log(f"import wall {t_import:.3f} s ({len(nodes)} nodes, {len(pending)} pods); first round: "
                f"{t_round:.3f} s from the import's answer to the last bind, launches K2 {first['scan']} "
                f"K3 {first['compact']} K4 {first['scatter']}; engine timings "
                f"{json.dumps({k: round(v, 4) for k, v in (eng.last_timings or {}).items()})}")
            # 3-4. arrivals over the kube API (arrival_parts), a client
            # cordoning a node halfway (its row goes to the card by K4 at
            # the next round), the binds read off a watch
            rv = store.resource_version
            qs = "&".join(f"{param}LastResourceVersion={rv}" for param in
                          ("pods", "nodes", "pvs", "pvcs", "scs", "pcs", "namespace"))
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("GET", f"/api/v1/listwatchresources?{qs}")
            resp = conn.getresponse()
            names = {p["metadata"]["name"] for p in arrivals}
            bound_at: dict = {}
            counts = {"events": 0}

            def read_watch():
                buf = b""
                while len(bound_at) < len(names):
                    chunk = resp.read1(1 << 20)
                    if not chunk:
                        return
                    buf += chunk
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        if not line.strip():
                            continue
                        ev = json.loads(line)
                        counts["events"] += 1
                        obj = ev["Obj"]
                        nm = obj["metadata"]["name"]
                        if ev["Kind"] == "pods" and nm in names and (obj.get("spec") or {}).get("nodeName"):
                            bound_at.setdefault(nm, time.perf_counter())

            reader = threading.Thread(target=read_watch, daemon=True)
            reader.start()
            K.reset_counts()
            sent_at = {}
            t0 = time.perf_counter()
            done = len(pending)
            for k, part in enumerate(arrival_parts(arrivals)):
                if k == 2:
                    code, _b = sim_http(kport, "PATCH", f"/api/v1/nodes/{SIM['cordon']}",
                                        {"spec": {"unschedulable": True}})
                    if code != 200:
                        raise AssertionError(f"the cordon answered {code}: {_b[:300]!r}")
                for p in part:
                    sent_at[p["metadata"]["name"]] = time.perf_counter()
                    code, _b = sim_http(kport, "POST", "/api/v1/namespaces/default/pods", p)
                    if code != 201:
                        raise AssertionError(f"kube API create answered {code}: {_b[:300]!r}")
                done += len(part)
                wait_bound(store, done)
                round_done(svc)
            round_done(svc)
            reader.join(timeout=120)
            conn.close()
            t_arrivals = time.perf_counter() - t0
            later = dict(K.LAUNCHES)
            rec["launches"]["kube-API arrivals"] = later
            if len(bound_at) != len(names):
                raise AssertionError(f"the watch showed {len(bound_at)} of {len(names)} binds")
            lat = np.array([bound_at[n] - sent_at[n] for n in names])
            log(f"kube-API arrivals: {len(arrivals)} pods in {t_arrivals:.3f} s, arrival-to-bind latency (watch) "
                f"median {1e3 * np.median(lat):.1f} ms, p90 {1e3 * np.percentile(lat, 90):.1f} ms, "
                f"max {1e3 * lat.max():.1f} ms; launches K2 {later['scan']} K3 {later['compact']} "
                f"K4 {later['scatter']}, scattered {eng._placer.last_scattered}")
            log(f"watch: {counts['events']} events read, {len(bound_at)} bind events of the arrivals")
            mark("arrivals")
            if dev.type == "cuda" and (later["scatter"] == 0 or first["scan"] == 0):
                raise AssertionError(f"the loop's rounds did not launch K2 and K4: {first} {later}")
            # 5. seeded pods over both APIs against the store's objects
            rng = random.Random(SIM["seed"])
            every = [p["metadata"]["name"] for p in pending + arrivals]
            for nm in rng.sample(every, SIM["gets"]):
                want = store.get("pods", nm, "default")
                # the kube API wraps the object in its type meta
                typed = {**want, "apiVersion": want.get("apiVersion", "v1"), "kind": want.get("kind", "Pod")}
                for p_, path, obj in ((port, f"/api/v1/resources/pods/{nm}?namespace=default", want),
                                      (kport, f"/api/v1/namespaces/default/pods/{nm}", typed)):
                    code, body = sim_http(p_, "GET", path)
                    if code != 200 or json.loads(body) != obj:
                        raise AssertionError(f"GET {path} on :{p_} answered {code} and not the store's object")
            log(f"{SIM['gets']} seeded pods read over both APIs equal the store's objects")
            mark("gets")
            served = pod_digests(store)
            mark("digests")
            # 6. metrics
            code, body = sim_http(port, "GET", "/api/v1/metrics")
            metrics = {ln.rpartition(" ")[0]: float(ln.rpartition(" ")[2]) for ln in body.decode().splitlines()
                       if ln and not ln.startswith("#")}
            picked = {k: metrics.get(k) for k in ("simulator_batch_rounds_total", "simulator_batch_kernel_runs_total",
                                                  'simulator_scheduled_pods_total{path="batch"}')}
            log(f"metrics {code}: {json.dumps(picked)}; substrate {json.dumps(SUBSTRATE.stats())}")
            if code != 200 or not all(picked.values()):
                raise AssertionError(f"metrics answered {code} with {picked}")
            mark("metrics")
            # 7-8. a restart with another configuration, then reset
            cfg = svc.get_scheduler_config()
            cfg["profiles"][0]["pluginConfig"] = [{"name": "NodeResourcesFit", "args": {"scoringStrategy": {
                "type": "MostAllocated", "resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 1}]}}}]
            code, _b = sim_http(port, "POST", "/api/v1/schedulerconfiguration", cfg)
            now = svc.get_scheduler_config()["profiles"][0].get("pluginConfig") or []
            if code != 202 or not any(pc["name"] == "NodeResourcesFit" and pc["args"]["scoringStrategy"]["type"]
                                      == "MostAllocated" for pc in now):
                raise AssertionError(f"the restart answered {code} and did not take the configuration")
            mark("restart")
            t0 = time.perf_counter()
            code, _b = sim_http(port, "PUT", "/api/v1/reset")
            if code != 202 or store.list("pods", copy_objects=False) or store.list("nodes", copy_objects=False):
                raise AssertionError(f"reset answered {code} and left objects")
            log(f"restart 202, reset 202 in {time.perf_counter() - t0:.3f} s: the store is empty")
            mark("reset")
            # 9. a session at cfg2's size, scheduled by its own loop
            t0 = time.perf_counter()
            code, body = sim_http(port, "POST", "/api/v1/sessions", {"id": "cfg2"})
            if code != 201:
                raise AssertionError(f"session create answered {code}: {body[:300]!r}")
            snap2 = session_snapshot()
            K.reset_counts()
            code, _b = sim_http(port, "POST", "/api/v1/sessions/cfg2/import", snap2)
            sdi = server.sessions.resolve_di("cfg2")
            wait_bound(sdi.cluster_store, len(snap2["pods"]))
            round_done(sdi.scheduler_service())
            t_session = time.perf_counter() - t0
            rec["launches"]["session"] = dict(K.LAUNCHES)
            sdig = pod_digests(sdi.cluster_store)
            mark("session")
            if sdi.device != di.device or sdi.scheduler_service().device != di.device:
                raise AssertionError(f"the session runs on {sdi.device}, not {di.device}")
            code, body = sim_http(port, "GET", "/api/v1/metrics")
            subs = {ln.rpartition(" ")[0]: float(ln.rpartition(" ")[2]) for ln in body.decode().splitlines()
                    if ln.startswith("simulator_substrate_fn_")}
            log(f"session {SIM_SESSION}: {len(snap2['pods'])} pods on {len(snap2['nodes'])} nodes in "
                f"{t_session:.3f} s (create, import, its loop's round), launches {rec['launches']['session']}; "
                f"substrate metrics {json.dumps(subs)}")
            # the substrate resolves the card's kernel entries and launch
            # plans: a CPU rehearsal reads zeros
            if dev.type == "cuda" and not (subs.get("simulator_substrate_fn_hits_total")
                                           and subs.get("simulator_substrate_fn_entries")):
                raise AssertionError(f"the substrate counters read {subs}")
        finally:
            server.shutdown()
        mark("shutdown")
        # the direct service on the card, on the same snapshot and arrivals
        t0 = time.perf_counter()
        direct, direct_s = direct_ref.get()
        log(f"the direct service (schedule_pending on the card, a worker process beside this phase): "
            f"{direct_s:.3f} s; waited for {time.perf_counter() - t0:.2f} s")
        if direct != served:
            bad = [n for n in served if served[n] != direct.get(n)]
            raise AssertionError(f"the server's binds or annotations differ from the direct service's on "
                                 f"{len(bad)} pods, first {bad[:3]}")
        log(f"binds and annotation digests of {len(served)} pods equal the direct service's "
            f"({sum(1 for v in served.values() if v[0])} bound)")
        t0 = time.perf_counter()
        want = session_ref.get()
        log(f"the session's CPU float64 reference waited for {time.perf_counter() - t0:.2f} s")
        if want != sdig:
            bad = [n for n in sdig if sdig[n] != want.get(n)]
            raise AssertionError(f"the session differs from the CPU float64 run on {len(bad)} pods, first "
                                 f"{[(n, sdig[n], want.get(n)) for n in bad[:2]]}")
        log(f"the session's {len(sdig)} pods equal the CPU float64 run")
        mark("checks")
        log(f"phase 34's steps (s): {json.dumps(steps)}")
    rec.update(import_s=t_import, round_s=t_round, arrival_ms=float(1e3 * np.median(lat)), session_s=t_session,
               watch_events=counts["events"])
    return rec


# ------------------------------------------ the fuzzer and kernel chaos (phase 35)

def fuzz_sweep(dev) -> dict:
    """Phase 35 (a): the seeded sweep on the card; counts reset just before
    it and read just after."""
    from kube_scheduler_simulator_tpu_torch.fuzz import FuzzHarness, smoke
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    with Phase(f"phase 35 (a): the fuzz sweep, {FUZZ_SWEEP['scenarios']} seeded scenarios (seeds "
               f"{FUZZ_SWEEP['seed']} and {FUZZ_SWEEP['seed'] + 1}), batch against the oracle and streamed against "
               "serial, on the card, float32"):
        harness = FuzzHarness(dev)
        K.reset_counts()
        t0 = time.perf_counter()
        report = smoke.sweep(harness, FUZZ_SWEEP, log=log)
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        rec = dict(wall_s=wall, scenarios=report["scenarios"], divergences=report["divergences"],
                   failures=report["failures"], compiles_after_first=report["compiles"],
                   scenario_s=report["seconds"], coverage=report["coverage"], launches=launches)
        log(f"fuzz sweep: {json.dumps(rec, sort_keys=True)}")
        if report["divergences"] or report["failures"] or report["scenarios"] < 8:
            raise AssertionError(f"the fuzz sweep diverged: {json.dumps(rec)}")
        if dev.type == "cuda" and (not launches["scan"] or not launches["compact"]):
            raise AssertionError(f"the fuzz sweep launched no scan or no compaction: {launches}")
        for (_profile, _role), (_store, svc) in harness._built.items():
            fb = [r for r in svc.stats["batch_fallbacks"] if r.startswith("kernel error")]
            dr = [r for r in svc.stats["stream_drains"] if r.startswith("kernel error")]
            est = svc.autoscaler._estimator if svc.autoscaler is not None else None
            if fb or dr or (est is not None and est.kernel_errors):
                raise AssertionError(f"the fuzz sweep's {_role} service counted kernel errors: {fb} {dr}")
    return rec


def fixture_replays(dev) -> dict:
    """Phase 35 (e): every committed fixture (``fuzz/fixtures/``, one
    injecting kernel errors) replayed on a fresh harness on the card, in
    float64 and in float32: no divergence, the committed bytes.  Each
    fixture is a ``Phase`` of its own, marked chaos only where the fixture
    injects kernel errors (its ``chaos`` key)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.fuzz import iter_fixture_paths, load_fixture, replay_fixture
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    rec: dict = {}
    for path in iter_fixture_paths():
        fx = load_fixture(path)
        with Phase(f"phase 35 (e): fixture {os.path.basename(path)} replayed on the card, float64 and float32",
                   chaos=bool(fx.get("chaos"))):
            for dt in (torch.float64, torch.float32):
                K.reset_counts()
                t0 = time.perf_counter()
                v, encoded = replay_fixture(fx, device=dev, dtype=dt)
                key = f"{os.path.basename(path)} {str(dt).split('.')[-1]}"
                rec[key] = dict(wall_s=time.perf_counter() - t0, divergences=v["divergences"],
                                exact=encoded == fx["expected"], launches={k: n for k, n in K.LAUNCHES.items() if n})
                if v["divergences"] or encoded != fx["expected"]:
                    raise AssertionError(f"fixture {key}: {json.dumps(rec[key])}")
    log(f"fixtures: {json.dumps(rec, sort_keys=True)}")
    return rec


def cfg2_service(dev, dt, pipeline="auto", mesh=None):
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    nodes, _all, pending, _vols = make_cluster("cfg2")
    store = ClusterStore(clock=lambda: SCENARIO_CLOCK)
    for n in nodes:
        store.create("nodes", n)
    for p in pending:
        store.create("pods", p)
    svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device=dev, dtype=dt,
                           pipeline=pipeline, mesh=mesh)
    svc.start_scheduler(FIVE_CFG)
    return store, svc


def cfg2_chaos(dev) -> dict:
    """Phase 35 (b): cfg2's round in windows of 256 on the card, once
    uninterrupted, once with the third window's fetch failing."""
    import torch

    from kube_scheduler_simulator_tpu_torch.fuzz import KernelChaos
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    recs, digests = {}, {}
    for leg in ("uninterrupted", "chaos"):
        with Phase(f"phase 35 (b): cfg2 1000 pods x 500 nodes in windows of {WINDOW}, {leg}, on the card, float32",
                   chaos=leg == "chaos"):
            store, svc = cfg2_service(dev, torch.float32)
            K.reset_counts()
            t0 = time.perf_counter()
            if leg == "chaos":
                with KernelChaos(svc, fail_events={CHAOS_CFG2_TRIP}) as kc:
                    svc.schedule_pending(max_rounds=1)
                trips, events = kc.trips, kc.events
            else:
                svc.schedule_pending(max_rounds=1)
                trips = events = 0
            wall = time.perf_counter() - t0
            digests[leg] = pod_digests(store)
            recs[leg] = dict(wall_s=wall, trips=trips, events=events, launches=dict(K.LAUNCHES),
                             digest=digest(json.dumps(digests[leg], sort_keys=True)),
                             batch_pods=svc.stats["batch_pods"], batch_fallbacks=dict(svc.stats["batch_fallbacks"]),
                             sequential_tail_s=svc.stats["degrade_s"], commit_s=svc.stats["commit_s"],
                             restarts=svc.stats["batch_restarts"], windows=svc._batch_engine.last_timings.get("windows"),
                             bound=sum(1 for v in digests[leg].values() if v[0]))
            log(f"cfg2 {leg}: {json.dumps(recs[leg], sort_keys=True)}")
    u, c = recs["uninterrupted"], recs["chaos"]
    with Phase("phase 35 (b): the chaotic cfg2 round against the uninterrupted one"):
        if u["batch_fallbacks"] or u["restarts"] or u["windows"] != 4:
            raise AssertionError(f"cfg2 uninterrupted: {json.dumps(u)}")
        if c["trips"] != 1 or c["batch_fallbacks"] != {"kernel error: ChaosError": 1}:
            raise AssertionError(f"cfg2 chaos: {json.dumps(c)}")
        if c["batch_pods"] != (CHAOS_CFG2_TRIP - 1) * WINDOW or c["sequential_tail_s"] <= 0:
            raise AssertionError(f"cfg2 chaos: {c['batch_pods']} pods committed before the trip "
                                 f"({(CHAOS_CFG2_TRIP - 1) * WINDOW} expected)")
        if digests["chaos"] != digests["uninterrupted"]:
            bad = [n for n in digests["uninterrupted"] if digests["chaos"].get(n) != digests["uninterrupted"][n]]
            raise AssertionError(f"cfg2 chaos: {len(bad)} pods differ from the uninterrupted run, first {bad[:3]}")
        log(f"cfg2 chaos: {len(digests['chaos'])} pods' digests equal the uninterrupted run's; "
            f"{c['batch_pods']} pods committed from windows before the trip, the sequential tail "
            f"{c['sequential_tail_s']:.3f} s")
    return {"uninterrupted": u, "chaos": c}


def stream_chaos(dev) -> dict:
    """Phase 35 (c): cfg9-stream's cluster, ``CHAOS_STREAM_TICKS`` ticks
    streamed with ``CHAOS_STREAM_EVENTS`` failing, against ``stream_off``."""
    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.fuzz import KernelChaos
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.parity import parity_digest

    cfg9 = workloads.STREAM
    recs, digests = {}, {}
    for mode in ("stream_off", "streamed with chaos"):
        with Phase(f"phase 35 (c): cfg9-stream {CHAOS_STREAM_TICKS} ticks, {mode}, on the card, float32",
                   chaos=mode != "stream_off"):
            store = ClusterStore(clock=lambda: 1_700_000_000.0)
            settled = workloads.stream_cluster(store, cfg9["n_nodes"], cfg9["seed_bound"])
            svc = SchedulerService(store, tie_break="first", use_batch="force", device=dev, dtype=torch.float32)
            svc.start_scheduler(None)
            feed = workloads.steady_feed(store, settled, CHAOS_STREAM_TICKS, 0, cfg9["per_tick"], cfg9["seed_bound"])
            K.reset_counts()
            t0 = time.perf_counter()
            if mode == "stream_off":
                svc.schedule_stream(feed=feed, streaming=False)
                trips = 0
            else:
                with KernelChaos(svc, fail_events=frozenset(CHAOS_STREAM_EVENTS)) as kc:
                    svc.schedule_stream(feed=feed, streaming=True)
                trips = kc.trips
            wall = time.perf_counter() - t0
            digests[mode] = parity_digest(store)
            recs[mode] = dict(wall_s=wall, trips=trips, launches=dict(K.LAUNCHES),
                              drains=dict(svc.stats["stream_drains"]), waves=svc.stats["stream_waves"],
                              batch_fallbacks=dict(svc.stats["batch_fallbacks"]),
                              unbound=len(svc.pending_pods()), digest=digests[mode])
            log(f"cfg9-stream {mode}: {json.dumps(recs[mode], sort_keys=True)}")
    off, on = recs["stream_off"], recs["streamed with chaos"]
    with Phase("phase 35 (c): the chaotic stream against stream_off"):
        want = {"kernel error: ChaosError": len(CHAOS_STREAM_EVENTS)}
        got = {r: n for r, n in on["drains"].items() if r.startswith("kernel error")}
        if on["trips"] != len(CHAOS_STREAM_EVENTS) or got != want or on["batch_fallbacks"]:
            raise AssertionError(f"cfg9-stream chaos: {json.dumps(on)}")
        if off["drains"] or off["batch_fallbacks"] or digests["stream_off"] != digests["streamed with chaos"]:
            raise AssertionError(f"cfg9-stream chaos: digest {on['digest']} against stream_off {off['digest']}")
        log(f"cfg9-stream chaos: drains {json.dumps(on['drains'])}; the store's digest equals stream_off's "
            f"({off['digest']})")
    return {"stream_off": off, "chaos": on}


def process_chaos(device: str) -> dict:
    """Phase 35 (d): one ProcessChaos kill point, its children on
    ``device``; the parent's kernel build comes first, so the children only
    load the libraries."""
    from kube_scheduler_simulator_tpu_torch.fuzz import ProcessChaos, generate_scenario

    scn = generate_scenario(PROCESS_CHAOS["seed"], 0, features=frozenset({"preemption", "churn", "retune"}))
    pc = ProcessChaos(scn, kill_records=(PROCESS_CHAOS["kill_record"],), role={"use_batch": "auto"},
                      child_timeout_s=300, device=device)
    t0 = time.perf_counter()
    v = pc.run()
    return dict(v, wall_s=time.perf_counter() - t0, child_compiles=pc.child_compiles,
                child_launches=pc.child_launches, child_degrades=pc.child_degrades, scenario=scn["name"],
                features=list(scn["features"]))


def start_process_chaos(dev) -> "tuple[Any, dict]":
    """Phase 35 (d), started on a thread before phase 34 (its children are
    processes of their own, mostly importing torch and starting CUDA; phase
    34 is host-bound in this process): (the thread, the box its record or
    error lands in)."""
    import threading

    box: dict = {}

    def leg_d() -> None:
        try:
            box["rec"] = process_chaos(str(dev))
        except BaseException as exc:  # noqa: BLE001 - re-raised when the thread is joined
            box["error"] = exc

    worker = threading.Thread(target=leg_d, name="process-chaos")
    worker.start()
    return worker, box


def fuzz_phases(dev) -> dict:
    """Phase 35's legs in this process: (a), (e), (b) and (c), run beside
    the tuner's plain references (``tune_start``)."""
    if kernel_degrades():
        raise AssertionError(f"kernel errors degraded before phase 35: {kernel_degrades()}")
    t0 = time.perf_counter()
    rec = {"sweep": fuzz_sweep(dev), "fixtures": fixture_replays(dev), "cfg2": cfg2_chaos(dev),
           "stream": stream_chaos(dev)}
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def process_chaos_phase(dev, leg_d: "tuple[Any, dict]", rec: dict) -> dict:
    """Phase 35 (d) joined (started by ``start_process_chaos``) and checked;
    ``rec`` (``fuzz_phases``'s) gains it."""
    worker, box = leg_d
    t0 = time.perf_counter()
    with Phase(f"phase 35 (d): ProcessChaos, kill record {PROCESS_CHAOS['kill_record']}, children on the card "
               "(joined)"):
        worker.join()
        if "error" in box:
            raise box["error"]
        d = box["rec"]
        log(f"ProcessChaos: {json.dumps(d, sort_keys=True)[:6000]}")
        if d["divergences"] or d["truncated_records"] or d["partial_gangs"] or not d["replayed_records"]:
            raise AssertionError(f"ProcessChaos: {json.dumps(d)[:4000]}")
        if d["child_compiles"] != [0, 0]:
            raise AssertionError(f"ProcessChaos children built or loaded libraries: {d['child_compiles']}")
        if d["child_degrades"]:
            raise AssertionError(f"ProcessChaos children degraded kernel errors: {d['child_degrades']}")
        if dev.type == "cuda" and not d["child_launches"].get("scan"):
            raise AssertionError(f"ProcessChaos children launched no scan on the card: {d['child_launches']}")
    rec["process"] = d
    rec["wall_s"] += time.perf_counter() - t0
    log(f"phase 35: {rec['wall_s']:.3f} s (the sweep {rec['sweep']['wall_s']:.3f}, cfg2's chaos round "
        f"{rec['cfg2']['chaos']['wall_s']:.3f} with its sequential tail {rec['cfg2']['chaos']['sequential_tail_s']:.3f}, "
        f"the stream's chaos {rec['stream']['chaos']['wall_s']:.3f}; ProcessChaos {d['wall_s']:.3f} on its thread, "
        "from phase 34 on; (a)-(c) and (e) beside phases 23-24's plain references)")
    return rec


# ------------------------------------------------ phase 36: the library cache

def aot_child(role: str, out_path: str) -> None:
    """Phase 36's child, a process of its own on the card, its
    ``KSS_AOT_CACHE_DIR`` and ``KSS_COMPILE_CACHE_DIR`` set by the parent:
    ``kernels.build`` (the libraries from the cache, or rebuilt where an
    entry is rejected), cfg2's float32 round in windows of 256 and, for the
    "fallback" child, K4 against its plain version on cfg2's planes.  Its
    record goes to ``out_path`` as JSON."""
    t_enter = time.perf_counter()
    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import aot
    from kube_scheduler_simulator_tpu_torch.ops import batch as B
    from kube_scheduler_simulator_tpu_torch.ops import encode as E
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    dev = torch.device(DEVICE)
    torch.cuda.init()
    t_cuda = time.perf_counter()
    builds0 = dict(K.BUILDS)
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    rec = dict(role=role, import_and_cuda_s=t_cuda - t_enter, build_s=build_s,
               builds={k: K.BUILDS[k] - builds0[k] for k in K.BUILDS}, cache=aot.stats(),
               built=sorted(p.name for p in K.build_dir().glob("*.so")), platform=K.cuda_platform(),
               toolchain=aot.toolchain_of(K._nvcc()), cache_dir=os.environ.get("KSS_AOT_CACHE_DIR"))
    store, svc = cfg2_service(dev, torch.float32)
    K.reset_counts()
    t0 = time.perf_counter()
    svc.schedule_pending(max_rounds=1)
    torch.cuda.synchronize()
    rec.update(round_s=time.perf_counter() - t0, launches=dict(K.LAUNCHES),
               batch_fallbacks=dict(svc.stats["batch_fallbacks"]), degrades=kernel_degrades(),
               windows=svc._batch_engine.last_timings.get("windows"),
               digest=digest(json.dumps(pod_digests(store), sort_keys=True)))
    if role == "fallback":
        # K4 (rebuilt after its entry's kernel-digest fallback) against its
        # plain version on every plane kind of cfg2's problem
        nodes, all_pods, pending, vols = make_cluster("cfg2")
        host, _dims = B.lower_host(E.pad_problem(E.encode(nodes, all_pods, pending, volumes=vols)), torch.float32)
        g = torch.Generator().manual_seed(36)
        checked, n0 = [], K.LAUNCHES["scatter"]
        for (fname, sub), a in sorted(B.problem_leaves(host).items(), key=lambda kv: str(kv[0])):
            if fname in B.CARRY0_FIELDS or a.ndim == 0 or a.shape[0] < 4:
                continue
            rows_n = a.shape[0]
            buf0 = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for k in sorted({1, 7, max(1, rows_n // 4)}):
                idx = torch.randperm(rows_n, generator=g)[:k].to(torch.int32).to(dev)
                src = torch.from_numpy(np.ascontiguousarray(a[torch.randperm(rows_n, generator=g)[:k].numpy()])).to(dev)
                want = B.scatter_rows_plain(buf0.clone(), idx, src)
                got = K.scatter_rows(buf0.clone(), idx, src)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"phase 36 (c): K4 differs from its plain version on {fname}[{sub}] K={k}")
            checked.append(f"{fname}{'' if sub is None else f'[{sub}]'} {a.dtype} {tuple(a.shape)}")
        rec["k4"] = dict(planes=checked, launches=K.LAUNCHES["scatter"] - n0)
    rec["wall_in_child_s"] = time.perf_counter() - t_enter
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(rec, f)


# phase 36 (c)'s prepared cache: each altered entry and the fallback it counts
AOT_TAMPERED = {"scatter": "kernel-digest", "gang": "corrupt", "preempt": "platform"}


def aot_start(dev) -> dict:
    """Phase 36 (a): the built libraries saved into a fresh cache; then (b)
    and (c)'s children started on the card (they run beside phases 23-24's
    plain references and cfg11-scenario; ``aot_phase`` joins them)."""
    import tempfile

    from kube_scheduler_simulator_tpu_torch.ops import aot
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    tmp = tempfile.mkdtemp(prefix="kss-aot-")
    warm = os.path.join(tmp, "cache")
    with Phase("phase 36 (a): the built libraries saved into a fresh kernel-library cache"):
        before = aot.stats()
        t0 = time.perf_counter()
        saved = K.save_libraries(K.library_cache(warm))
        save_s = time.perf_counter() - t0
        after = aot.stats()
        saves = after["aot_cache_saves_total"] - before["aot_cache_saves_total"]
        if None in saved.values() or saves != len(K.SOURCES) or after["aot_cache_fallbacks_by_reason"] != before[
                "aot_cache_fallbacks_by_reason"]:
            raise AssertionError(f"phase 36 (a): {saves} saves of {len(K.SOURCES)} libraries: {saved}, {after}")
        sizes = {n: os.path.getsize(path) for n, path in saved.items()}
        side = json.load(open(os.path.join(warm, "scan.json"), encoding="utf-8"))
        log(f"phase 36 (a): {saves} saves in {save_s:.3f} s, {sum(sizes.values())} bytes "
            f"({json.dumps(sizes, sort_keys=True)}); toolchain {side['toolchain']!r}, platform {side['platform']!r}")
        # (c)'s cache: the same entries, three of them altered
        bad = os.path.join(tmp, "tampered")
        shutil.copytree(warm, bad)
        for name, reason in AOT_TAMPERED.items():
            sp = os.path.join(bad, f"{name}.json")
            side = json.load(open(sp, encoding="utf-8"))
            if reason == "corrupt":
                lib = os.path.join(bad, side["library"])
                with open(lib, "r+b") as f:
                    f.truncate(os.path.getsize(lib) // 2)
                continue
            side[reason] = "0" * 16 if reason == "kernel-digest" else "sm_80; arch=compute_80,code=sm_80"
            with open(sp, "w", encoding="utf-8") as f:
                json.dump(side, f)
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    for role, cache_dir in (("warm", warm), ("fallback", bad)):
        build_dir = os.path.join(tmp, f"build-{role}")
        os.makedirs(build_dir)
        out = os.path.join(tmp, f"{role}.json")
        env = dict(os.environ, KSS_AOT_CACHE_DIR=cache_dir, KSS_COMPILE_CACHE_DIR=build_dir)
        code = f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; chip_smoke.aot_child({role!r}, {out!r})"
        logf = open(os.path.join(tmp, f"{role}.log"), "w", encoding="utf-8")
        procs[role] = (subprocess.Popen([sys.executable, "-c", code], env=env, stdout=logf, stderr=subprocess.STDOUT,
                                        cwd=root), out, logf)
    _CHILDREN.extend(p for p, *_ in procs.values())
    return dict(tmp=tmp, procs=procs, save_s=save_s, saves=saves)


def aot_phase(started: dict, cfg2_digest: str, card: str) -> dict:
    """Phase 36 (b) and (c) joined and checked: the warm child loaded every
    library from the cache (no nvcc), the other counted one fallback for
    each altered entry and rebuilt only those; both rounds' digests are
    this process's cfg2 round's."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    recs = {}
    try:
        with Phase("phase 36 (b), (c): the kernel-library cache's children on the card (joined)"):
            for role, (proc, out, logf) in started["procs"].items():
                try:
                    rc = proc.wait(timeout=900)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rc = proc.wait()
                logf.close()
                child_log = open(logf.name, encoding="utf-8").read()
                if rc != 0 or not os.path.exists(out):
                    raise AssertionError(f"phase 36 {role} child exited {rc}:\n{child_log[-6000:]}")
                recs[role] = rec = json.load(open(out, encoding="utf-8"))
                log(f"phase 36 {role} child: {json.dumps(rec, sort_keys=True)}")
            warm, fb = recs["warm"], recs["fallback"]
            n = len(K.SOURCES)
            want_warm = {"aot_cache_hits_total": n, "aot_cache_misses_total": 0, "aot_cache_saves_total": 0,
                         "aot_cache_fallbacks_by_reason": {}, "aot_cache_toolchain_unverified_total": 0}
            if warm["cache"] != want_warm or warm["builds"] != {"nvcc": 0, "loads": n} or warm["built"]:
                raise AssertionError(f"phase 36 (b): the warm child did not load every library from the cache: "
                                     f"{json.dumps(warm)}")
            want_fb = {"aot_cache_hits_total": n - len(AOT_TAMPERED), "aot_cache_misses_total": 0,
                       "aot_cache_saves_total": len(AOT_TAMPERED),
                       "aot_cache_fallbacks_by_reason": {r: 1 for r in AOT_TAMPERED.values()},
                       "aot_cache_toolchain_unverified_total": 0}
            rebuilt = sorted(name.split("-")[0] for name in fb["built"])
            if fb["cache"] != want_fb or fb["builds"] != {"nvcc": len(AOT_TAMPERED), "loads": n} or rebuilt != sorted(
                    K.SOURCES[name].split(".")[0] for name in AOT_TAMPERED):
                raise AssertionError(f"phase 36 (c): {json.dumps(fb)}")
            for role, rec in recs.items():
                if rec["digest"] != cfg2_digest or rec["batch_fallbacks"] or rec["degrades"] or rec["windows"] != 4:
                    raise AssertionError(f"phase 36 {role}: cfg2's round differs from this process's "
                                         f"({cfg2_digest}): {json.dumps(rec)}")
                if not (rec["launches"]["scan"] and rec["launches"]["compact"]):
                    raise AssertionError(f"phase 36 {role}: cfg2's round launched {rec['launches']}")
            if not fb["k4"]["launches"]:
                raise AssertionError(f"phase 36 (c): K4: {json.dumps(fb['k4'])}")
            log(f"phase 36: warm child: {want_warm['aot_cache_hits_total']} hits, 0 misses, 0 saves, no fallback, "
                f"nvcc 0, libraries loaded in {warm['build_s']:.3f} s (this process's fresh build "
                f"{K.build_seconds:.3f} s), child wall {warm['wall_in_child_s']:.3f} s (torch and CUDA "
                f"{warm['import_and_cuda_s']:.3f} s); fallback child: "
                f"{json.dumps(fb['cache']['aot_cache_fallbacks_by_reason'], sort_keys=True)}, "
                f"{fb['cache']['aot_cache_hits_total']} hits, {fb['cache']['aot_cache_saves_total']} saves, "
                f"nvcc {fb['builds']['nvcc']} ({', '.join(rebuilt)}) in {fb['build_s']:.3f} s, child wall "
                f"{fb['wall_in_child_s']:.3f} s; K4 bitwise on {len(fb['k4']['planes'])} planes; both cfg2 digests "
                f"{cfg2_digest[:16]}; {card}")
    finally:
        for proc, *_rest in started["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        # the warm cache stays for phase 37's ensemble (removed there, or on
        # the way out of the script)
        for name in os.listdir(started["tmp"]):
            if name != "cache":
                shutil.rmtree(os.path.join(started["tmp"], name), ignore_errors=True)
        _TMPDIRS.append(started["tmp"])
    return dict(recs, save_s=started["save_s"], saves=started["saves"], fresh_build_s=K.build_seconds,
                warm=os.path.join(started["tmp"], "cache"))


# ------------------------------------------------ phase 37: the scan ensemble

ENSEMBLE_CHAOS = dict(nodes=4, pods=12, heartbeat_s=0.3, timeout_s=120.0)


def no_nvcc_child(out_path: str) -> None:
    """Phase 37 (e), a process with no ``nvcc`` (off its ``PATH``, and
    ``CUDA_HOME`` a directory without one): ``kernels.build(compile=False)``
    from the warm cache, every entry loaded with its toolchain unverified."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import aot
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    torch.cuda.init()
    t0 = time.perf_counter()
    K.build(compile=False)
    rec = dict(build_s=time.perf_counter() - t0, builds=dict(K.BUILDS), cache=aot.stats(), nvcc=K._nvcc(),
               toolchain=aot.toolchain_of(K._nvcc()), platform=K.cuda_platform(), libraries=len(K._LIBS))
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(rec, f)


def ensemble_child(cfg2_digest: str, out_path: str) -> None:
    """Phase 37, a process of its own on the card (``KSS_AOT_CACHE_DIR``
    phase 36's warm cache, ``KSS_COMPILE_CACHE_DIR`` an empty directory, so
    this process and its workers load every library from the cache): (e)'s
    child started first, then (a) cfg2 through a one-worker ensemble, (b)
    north in one launch in this process and through the worker, (c)
    WorkerChaos kill, stop and sever, (d) two workers on the one card.  Its
    record goes to ``out_path`` as JSON; a failed check raises."""
    import tempfile

    import torch

    from kube_scheduler_simulator_tpu_torch.fuzz.chaos import WorkerChaos, leaked_worker_pids
    from kube_scheduler_simulator_tpu_torch.ops import aot, procmesh
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    dev = torch.device(DEVICE)
    card = dev.type == "cuda"  # a CPU rehearsal: no libraries, no launches, no (e)
    if card:
        torch.cuda.init()
    rec: dict = {}
    tmp = tempfile.mkdtemp(prefix="kss-ensemble-")
    # (e): a child without the compiler, beside the rest
    hidden = [d for d in os.environ.get("PATH", "").split(os.pathsep) if d and not os.path.exists(os.path.join(d, "nvcc"))]
    os.makedirs(os.path.join(tmp, "no-cuda"))
    os.makedirs(os.path.join(tmp, "build-e"))
    env = dict(os.environ, PATH=os.pathsep.join(hidden), CUDA_HOME=os.path.join(tmp, "no-cuda"),
               KSS_COMPILE_CACHE_DIR=os.path.join(tmp, "build-e"))
    env.pop("CUDA_PATH", None)
    root = os.path.dirname(os.path.abspath(__file__))
    out_e = os.path.join(tmp, "e.json")
    code = f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; chip_smoke.no_nvcc_child({out_e!r})"
    child_e = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=root, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT) if card else None
    try:
        t0 = time.perf_counter()
        builds0 = dict(K.BUILDS)
        if card:
            K.build()
        rec["parent_build"] = dict(s=time.perf_counter() - t0, builds={k: K.BUILDS[k] - builds0[k] for k in K.BUILDS},
                                   cache=aot.stats())
        if rec["parent_build"]["builds"]["nvcc"]:
            raise AssertionError(f"phase 37: the ensemble's parent ran nvcc: {rec['parent_build']}")

        # (a) cfg2 through one worker: one launch (pipeline off: the ensemble
        # serves no windows), the same store as phase 35's windowed round
        os.environ["KSS_MESH_PROCESSES"] = "1"
        procmesh.reset()
        with Phase("phase 37 (a): cfg2 through a one-worker ensemble on the card, float32"):
            store, svc = cfg2_service(dev, torch.float32, pipeline=False)
            K.reset_counts()
            t0 = time.perf_counter()
            svc.schedule_pending(max_rounds=1)
            if card:
                torch.cuda.synchronize()
            st = procmesh.stats()
            a = dict(wall_s=time.perf_counter() - t0, launches=dict(K.LAUNCHES), procmesh=st,
                     digest=digest(json.dumps(pod_digests(store), sort_keys=True)),
                     batch_fallbacks=dict(svc.stats["batch_fallbacks"]), batch_pods=svc.stats["batch_pods"],
                     stages=dict(svc._batch_engine.profiler.last_wave))
            rec["a"] = a
            log(f"phase 37 (a): {json.dumps(a, sort_keys=True)}")
            pool = st["pool"] or {}
            if a["digest"] != cfg2_digest or a["batch_fallbacks"]:
                raise AssertionError(f"phase 37 (a): cfg2 through the worker differs from the in-process round "
                                     f"({cfg2_digest}): {json.dumps(a)}")
            if not (pool.get("engaged") == 1 and pool["dispatches"] >= 1 and pool["scans_loaded"] >= 1):
                raise AssertionError(f"phase 37 (a): the ensemble did not serve cfg2: {json.dumps(st)}")
            if st["run_fallbacks_by_reason"] or st["fallbacks_by_reason"]:
                raise AssertionError(f"phase 37 (a): ensemble fallbacks: {json.dumps(st)}")
            if pool["worker_builds"] != ({"nvcc": 0, "loads": len(K.SOURCES)} if card else {}) or pool["worker_degrades"]:
                raise AssertionError(f"phase 37 (a): the worker's builds or degrades: {json.dumps(pool)}")
            if card and (not pool["worker_launches"].get("scan") or not a["launches"]["compact"] or a["launches"]["scan"]):
                raise AssertionError(f"phase 37 (a): K2 in the worker {pool['worker_launches']}, "
                                     f"this process {a['launches']}")

        # (b) north in one launch: in this process, then through the worker
        # (the pool of (a), its libraries loaded)
        nodes, all_pods, pending, vols = make_cluster("north")
        P = len(pending)
        docs = {}
        for leg in ("in-process", "ensemble"):
            with Phase(f"phase 37 (b): north, one launch, {leg}, on the card, float32"):
                if leg == "in-process":
                    os.environ.pop("KSS_MESH_PROCESSES")
                else:
                    os.environ["KSS_MESH_PROCESSES"] = "1"
                eng = engine("north", torch.float32, device=dev)
                if (eng._procmesh is not None) != (leg == "ensemble"):
                    raise AssertionError(f"phase 37 (b) {leg}: the engine's pool is {eng._procmesh}")
                K.reset_counts()
                w0 = dict((procmesh.stats()["pool"] or {}).get("worker_launches") or {})
                t0 = time.perf_counter()
                res = eng.schedule(nodes, all_pods, pending, volumes=vols)
                wall = time.perf_counter() - t0
                docs[leg] = round_documents(res, P)
                st = procmesh.stats()
                b = dict(wall_s=wall, launches=dict(K.LAUNCHES), timings=dict(eng.last_timings),
                         stages=dict(eng.profiler.last_wave),
                         digest=digest(json.dumps(docs[leg], sort_keys=True)))
                if leg == "ensemble":
                    pool = st["pool"]
                    b.update(last_run=pool["last_run"], worker_launches={
                        k: n - w0.get(k, 0) for k, n in pool["worker_launches"].items()},
                        run_fallbacks=st["run_fallbacks_by_reason"])
                rec[f"b {leg}"] = b
                log(f"phase 37 (b) {leg}: {json.dumps(b, sort_keys=True)}")
        b, bi = rec["b ensemble"], rec["b in-process"]
        if b["digest"] != bi["digest"] or docs["ensemble"] != docs["in-process"]:
            raise AssertionError("phase 37 (b): north through the worker differs from the in-process round")
        if b["run_fallbacks"] or b["last_run"]["reply_bytes"] <= 0 or (card and (
                b["worker_launches"].get("scan") != 1 or b["launches"]["scan"] or b["launches"]["compact"] != 1)):
            raise AssertionError(f"phase 37 (b): {json.dumps(b)}")
        lr = b["last_run"]
        worker = lr["worker"]
        log(f"phase 37 (b): north's wall split through the worker: planes shipped {lr['ship_bytes']} bytes in "
            f"{lr['ship_s']:.4f} s; in the worker place {worker['place_s']:.4f} s, scan {worker['scan_s']:.4f} s, "
            f"outputs to the host {worker['fetch_s']:.4f} s; reply {lr['reply_bytes']} bytes, the wait for it "
            f"{lr['wait_s']:.4f} s (transport {lr['wait_s'] - sum(worker.values()):.4f} s); K3 and the trace in "
            f"this process (trace_fetch) {b['stages'].get('trace_fetch', 0.0):.4f} s; round {b['wall_s']:.3f} s "
            f"against {bi['wall_s']:.3f} s in-process; digest {b['digest'][:16]} equal")

        # (c) WorkerChaos at a small scenario, the worker faulted at the first dispatch
        procmesh.reset()
        os.environ.pop("KSS_MESH_PROCESSES", None)
        c_nodes, _c_all, c_pods = workloads.cluster(ENSEMBLE_CHAOS["pods"], ENSEMBLE_CHAOS["nodes"], seed=5)
        scn = {"name": "phase-37-chaos", "nodes": c_nodes, "pods": c_pods}
        rec["c"] = {}
        for mode in ("kill", "stop", "sever"):
            with Phase(f"phase 37 (c): WorkerChaos {mode} at dispatch 0, one worker on the card"):
                t0 = time.perf_counter()
                v = WorkerChaos(scn, mode=mode, fault_at=0, nprocs=1, heartbeat_s=ENSEMBLE_CHAOS["heartbeat_s"],
                                timeout_s=ENSEMBLE_CHAOS["timeout_s"], device=DEVICE).run()
                v["wall_s"] = time.perf_counter() - t0
                v["leaked_after"] = leaked_worker_pids()
                rec["c"][mode] = v
                log(f"phase 37 (c) {mode}: {json.dumps(v, sort_keys=True)}")
                if (v["engaged"] != 1 or v["fired"] != 1 or v["divergences"] or v["respawns"] != 1
                        or v["hangs_detected"] != (1 if mode == "stop" else 0) or v["breaker_state"] != "closed"
                        or v["leaked_workers"] or v["leaked_after"] or v["run_fallbacks"]):
                    raise AssertionError(f"phase 37 (c) {mode}: {json.dumps(v)}")
                if v["worker_builds"].get("nvcc") or (card and not v["worker_launches"].get("scan")):
                    raise AssertionError(f"phase 37 (c) {mode}: the workers' builds and launches {json.dumps(v)}")

        # (d) two workers on the one card: a counted fallback, the same store
        os.environ["KSS_MESH_PROCESSES"] = "2"
        procmesh.reset()
        with Phase("phase 37 (d): cfg2 with two workers on the one card, float32"):
            store, svc = cfg2_service(dev, torch.float32, pipeline=False)
            K.reset_counts()
            svc.schedule_pending(max_rounds=1)
            st = procmesh.stats()
            d = dict(procmesh=st, launches=dict(K.LAUNCHES), digest=digest(json.dumps(pod_digests(store), sort_keys=True)))
            rec["d"] = d
            procmesh.reset()
            os.environ.pop("KSS_MESH_PROCESSES")
            log(f"phase 37 (d): verdict {st['verdict']!r}, bring-up fallbacks {st['fallbacks_by_reason']}, run "
                f"fallbacks {st['run_fallbacks_by_reason']}, pool {json.dumps(st['pool'])}")
            if d["digest"] != cfg2_digest or not two_worker_fallback(st) or (card and not d["launches"]["scan"]):
                raise AssertionError(f"phase 37 (d): {json.dumps(d)}")
            if leaked_worker_pids():
                raise AssertionError(f"phase 37 (d): workers left: {leaked_worker_pids()}")

        # (e) joined
        with Phase("phase 37 (e): the cache in a process without nvcc (joined)") if card else contextlib.nullcontext():
            out, _ = child_e.communicate(timeout=600) if card else (b"", None)
            if card and (child_e.returncode != 0 or not os.path.exists(out_e)):
                raise AssertionError(f"phase 37 (e) child exited {child_e.returncode}:\n{out.decode()[-6000:]}")
            e = json.load(open(out_e, encoding="utf-8")) if card else {"rehearsal": True}
            rec["e"] = e
            log(f"phase 37 (e): {json.dumps(e, sort_keys=True)}")
            n = len(K.SOURCES)
            if card and (e["toolchain"] is not None or e["builds"] != {"nvcc": 0, "loads": n} or e["libraries"] != n
                    or e["cache"]["aot_cache_hits_total"] != n or e["cache"]["aot_cache_fallbacks_by_reason"]
                    or e["cache"]["aot_cache_toolchain_unverified_total"] != n):
                raise AssertionError(f"phase 37 (e): {json.dumps(e)}")
    finally:
        if child_e is not None and child_e.poll() is None:
            child_e.kill()
            child_e.wait()
        procmesh.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(rec, f, default=str)


def two_worker_fallback(st: dict) -> bool:
    """Phase 37 (d)'s one admitted fallback of two workers on one card:
    every scan shape refused ``sharded_scan_unported`` by an engaged pair,
    or, where gloo cannot start, the probe's own reason.  Workers that do
    not start (``spawn_failed``, ``distributed_init_unavailable``) fail."""
    run, up = st["run_fallbacks_by_reason"], st["fallbacks_by_reason"]
    if not up:
        return set(run) == {"sharded_scan_unported"}
    return not run and len(up) == 1 and all(
        r == "probe_timeout" or r.startswith("collectives_unavailable") for r in up)


def ensemble_start(warm: str, cfg2_digest: str) -> dict:
    """Phase 37's child started on the card (``ensemble_child``), beside the
    host-bound phases 30-34; ``ensemble_phase`` joins it."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="kss-phase37-")
    _TMPDIRS.append(tmp)
    build = os.path.join(tmp, "build")
    os.makedirs(build)
    out = os.path.join(tmp, "phase37.json")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, KSS_AOT_CACHE_DIR=warm, KSS_COMPILE_CACHE_DIR=build)
    env.pop("KSS_MESH_PROCESSES", None)
    code = (f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            f"chip_smoke.ensemble_child({cfg2_digest!r}, {out!r})")
    logf = open(os.path.join(tmp, "phase37.log"), "w", encoding="utf-8")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=logf, stderr=subprocess.STDOUT, cwd=root)
    _CHILDREN.append(proc)
    return dict(proc=proc, out=out, log=logf, t0=time.perf_counter())


def ensemble_phase(started: dict, card: str) -> dict:
    """Phase 37 joined: its child's log printed and its record checked
    again here (the child raised on any failed check)."""
    with Phase("phase 37: the scan ensemble's child on the card (joined)"):
        proc = started["proc"]
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        started["log"].close()
        child_log = open(started["log"].name, encoding="utf-8").read()
        log(child_log.rstrip()[-20000:])
        if rc != 0 or not os.path.exists(started["out"]):
            raise AssertionError(f"phase 37's child exited {rc}")
        rec = json.load(open(started["out"], encoding="utf-8"))
        rec["wall_s"] = time.perf_counter() - started["t0"]
        a, b, d = rec["a"], rec["b ensemble"], rec["d"]
        for mode in ("kill", "stop", "sever"):
            if rec["c"][mode]["divergences"] or rec["c"][mode]["respawns"] != 1:
                raise AssertionError(f"phase 37 (c) {mode}: {json.dumps(rec['c'][mode])}")
        if not two_worker_fallback(d["procmesh"]):
            raise AssertionError(f"phase 37 (d): {json.dumps(d['procmesh'])}")
        rec["worker_scan_launches"] = (a["procmesh"]["pool"]["worker_launches"].get("scan", 0)
                                       + b["worker_launches"].get("scan", 0))
        rec["parent_compact_launches"] = a["launches"]["compact"] + b["launches"]["compact"]
        log(f"phase 37: {rec['wall_s']:.3f} s from its start; the worker's K2 launches {rec['worker_scan_launches']} "
            f"(cfg2 {a['procmesh']['pool']['worker_launches'].get('scan', 0)}, north "
            f"{b['worker_launches'].get('scan', 0)}), "
            f"K3 in this process's child {rec['parent_compact_launches']}, the worker's builds "
            f"{json.dumps(a['procmesh']['pool']['worker_builds'])} and degrades "
            f"{json.dumps(a['procmesh']['pool']['worker_degrades'])}; WorkerChaos respawns "
            f"{[rec['c'][m]['respawns'] for m in ('kill', 'stop', 'sever')]}, hangs "
            f"{[rec['c'][m]['hangs_detected'] for m in ('kill', 'stop', 'sever')]}; two workers: verdict "
            f"{d['procmesh']['verdict']!r}, {json.dumps(d['procmesh']['run_fallbacks_by_reason'])}; without nvcc "
            f"{rec['e'].get('cache', {}).get('aot_cache_toolchain_unverified_total')} libraries loaded unverified; "
            f"{card}")
    return rec


# ------------------------------------------- phase 38: the node axis sharded

SHARDS = (2, 4)
SHARD_WINDOW = 256
SHARD_FUZZ = ((0, 1), (2, 0), (3, 1))  # (seed, index) of the fuzz scenarios the shard role runs
SHARD_REFUSED_LANES = 5000  # (shard, lane) blocks past what one card holds at once
SHARD_TEST_CAP = 2000  # polls of a mailbox wait in the cap's check (a few ms)


def refused_clusters(sms: int) -> int:
    """A count of one-block shard clusters past what a card of ``sms`` SMs
    holds at once: an SM runs at most 2 048 threads, so at most 2 048 /
    SCAN_THREADS of the scan's blocks."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    return 2048 // K.SCAN_THREADS * sms + 1


def shard_mesh(dev, n: int):
    from kube_scheduler_simulator_tpu_torch.ops.mesh import NodeMesh

    return NodeMesh((dev,) * n)


def unshard(sp):
    """The DeviceProblem of a ShardedProblem's whole axis (its node-axis
    fields concatenated in shard order, the rest from shard 0)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import batch as B

    fields = {}
    for f in B.DeviceProblem._fields:
        ax = B.NODE_AXIS_SPECS.get(f)
        v0 = getattr(sp.shards[0], f)
        fields[f] = v0 if ax is None else torch.cat([getattr(dp, f) for dp in sp.shards], ax[0])
    return B.DeviceProblem(**fields)


def sharded_digests(out: dict) -> dict:
    """``out_digests`` of a scan's outputs but its chaining view (the
    sharded scan's ``final_carry`` is a list of the shards' carries; both
    hand on the whole axis's final carry field by field)."""
    return out_digests({k: v for k, v in out.items() if k != "final_carry" and not k.startswith("_")})


def lanes_capture(capture: list):
    """Wrap kernels.scan_lanes_sharded: each dispatch's arguments and
    outputs are appended to ``capture``.  Returns the unwrapping function."""
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    orig = K.scan_lanes_sharded

    def wrapped(cfg, dims, sp, lanes, widest=None):
        out = orig(cfg, dims, sp, lanes, widest=widest)
        capture.append(dict(args=(cfg, dims, sp, lanes, widest), out=out))
        return out

    K.scan_lanes_sharded = wrapped

    def unwrap():
        K.scan_lanes_sharded = orig

    return unwrap


def shard_lanes_check(dev, c: dict, name: str) -> dict:
    """A captured sharded K8 dispatch against K8 on the whole axis: bitwise."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    cfg, dims, sp, lanes, widest = c["args"]
    whole = K.scan_lanes(cfg, dims, unshard(sp), torch.cat(lanes, 1), widest=widest)
    keys = ("packed_pod", "final_requested", "final_nonzero", "final_pod_count", "final_spread_counts",
            "final_ip_sel", "final_start")
    same_digests(f"{name}: sharded K8 vs K8", out_digests({k: c["out"][k] for k in keys}),
                 out_digests({k: whole[k] for k in keys}))
    return dict(G=lanes[0].shape[0], N=dims["N"], P=dims["P"], shards=len(lanes), widest=widest,
                tile=K.lane_tile(widest if widest is not None else 512), err=max_abs_err(c["out"], whole, keys))


def shard_child(cfg2_digest: str, k5_path: str, out_path: str) -> None:
    """Phase 38, a process of its own on the card: the node axis sharded
    over shards of the one card (``NodeMesh((cuda:0,) * n)``).  (1) cfg2 on
    2 and 4 shards, float32 and float64: the sharded K2 bitwise its plain
    sharded version and the unsharded kernel, windows of 256, the service's
    round (windows on the mesh) equal to the in-process digest; (2) north and
    cfg4 one-launch rounds on 2 and 4 shards: documents equal the unsharded
    round's, K2 sharded and K3 once each, the scan's ms beside the
    unsharded ms; (3) K5 at cfg7-preempt-5k's first dispatch on 2 and 4
    shards, masks equal to the unsharded launch, and the cfg7 cut through a
    service on a mesh; (4) K8 at cfg6 through a service on a mesh and at the
    burst, each dispatch bitwise K8 on the whole axis; (5) the fuzzer's
    shard role; (6) the refusals.  Its record goes to ``out_path``; a
    failed check raises."""
    import pickle

    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch import time_preempt as TP
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.autoscaler import ScaleUpEstimator
    from kube_scheduler_simulator_tpu_torch.fuzz import FuzzHarness, generate_scenario, run_differential
    from kube_scheduler_simulator_tpu_torch.ops import batch as B
    from kube_scheduler_simulator_tpu_torch.ops import encode as E
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.preemption import kernel as PK
    from kube_scheduler_simulator_tpu_torch.preemption.kernel import preempt_plain

    dev = torch.device(DEVICE)
    card = dev.type == "cuda"
    if card:
        torch.cuda.init()
        K.build()
    cpu = torch.device("cpu")
    rec: dict = {"main": {k: 0 for k in K.LAUNCHES}, "by_path": {}}

    def main_path(label: str, launches: dict) -> None:
        rec["by_path"][label] = {k: n for k, n in launches.items() if n}
        for k, n in launches.items():
            rec["main"][k] += n

    # (1) cfg2: the sharded K2 against its plain sharded version and the
    # unsharded kernel; windows of 256
    cfg = workload_cfg("cfg2")
    pr = encoded("cfg2")
    err = {"scan_sharded": 0.0, "preempt_sharded": 0.0, "scan_lanes_sharded": 0.0}  # max |sharded - reference|
    for dt in (torch.float32, torch.float64):
        with Phase(f"phase 38 (1): cfg2 on 2 and 4 shards of the card, {dt}"):
            dp, dims, ws0 = lowered("cfg2", pr, dt, dev)
            dpc, _dc, _wc = lowered("cfg2", pr, dt, cpu)
            uout = K.scan(cfg, dims, dp, ws0=ws0)
            ud = sharded_digests(uout)
            for n in SHARDS:
                sp = B.shard_device_problem(dp, shard_mesh(dev, n))
                kout = K.scan_sharded(cfg, dims, sp, ws0=ws0)
                kd = sharded_digests(kout)
                same_digests(f"cfg2 {n} shards {dt}: sharded K2 vs K2", kd, ud)
                t0 = time.perf_counter()
                pout = B.scan_plain_sharded(cfg, dims, B.shard_device_problem(dpc, shard_mesh(cpu, n)), ws0=ws0)
                pd = sharded_digests(pout)
                same_digests(f"cfg2 {n} shards {dt}: sharded K2 vs its plain sharded version (CPU)", kd, pd)
                err["scan_sharded"] = max(err["scan_sharded"], max_abs_err(kout, uout), max_abs_err(kout, pout))
                del pout
                # windows of 256 chained shard for shard, against the one launch
                carry, W = None, SHARD_WINDOW
                for off in range(0, dims["P"], W):
                    wout = K.scan_sharded(cfg, dims, sp, ws0=ws0, carry0=carry, offset=off, window=W)
                    for k in ("fail_plug", "fail_code", "feasible", "packed_pod"):
                        a = wout[k][:4] if k == "packed_pod" else wout[k]
                        b = kout[k][:4, off:off + W] if k == "packed_pod" else kout[k][off:off + W]
                        same(f"cfg2 {n} shards {dt}: window at {off} {k}", a, b)
                    carry = wout["final_carry"]
                for k in ("final_requested", "final_nonzero", "final_pod_count", "final_start"):
                    same(f"cfg2 {n} shards {dt}: windows' final {k}", wout[k], kout[k])
                log(f"cfg2 {n} shards {str(dt).split('.')[-1]}: sharded K2 bitwise the unsharded kernel and its "
                    f"plain sharded version ({len(kd)} outputs; plain {time.perf_counter() - t0:.2f} s on the CPU); "
                    f"{dims['P'] // W} windows of {W} bitwise the one launch; max |err| so far "
                    f"{err['scan_sharded']!r}")
        del dp, dpc, uout
    # the kernels line's shape: cfg2, 2 shards, float32 (plain on the card)
    with Phase("phase 38 (1): cfg2 timed, 2 shards, float32"):
        dp, dims, ws0 = lowered("cfg2", pr, torch.float32, dev)
        sp = B.shard_device_problem(dp, shard_mesh(dev, 2))
        ms, kout = cuda_ms(lambda: K.scan_sharded(cfg, dims, sp, ws0=ws0), 10, 3)
        ums, _u = cuda_ms(lambda: K.scan(cfg, dims, dp, ws0=ws0), 10, 3)
        plain_ms, pout = cuda_ms(lambda: B.scan_plain_sharded(cfg, dims, sp, ws0=ws0), 1, 0)
        same_digests("cfg2 2 shards: sharded K2 vs its plain sharded version on the card", sharded_digests(kout),
                     sharded_digests(pout))
        err["scan_sharded"] = max(err["scan_sharded"], max_abs_err(kout, pout))
        b_ms, b_by = bound(scan_counts(cfg, dims, dp, kout), torch.float32)
        rec["cfg2"] = dict(ms=ms, unsharded_ms=ums, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           P=dims["P"], N=dims["N"], shards=2, cluster=K.cluster_width(dims["N"] // 2, 1),
                           err=err["scan_sharded"])
        log(f"cfg2 timed: {json.dumps(rec['cfg2'])}")
        del dp, sp, kout, pout, _u
    # the service's round on the mesh: windows of 256 (the main path)
    for n in SHARDS:
        with Phase(f"phase 38 (1): cfg2 through the service on {n} shards, float32"):
            store, svc = cfg2_service(dev, torch.float32, mesh=shard_mesh(dev, n))
            K.reset_counts()
            svc.schedule_pending(max_rounds=1)
            launches = dict(K.LAUNCHES)
            main_path(f"cfg2 service on {n} shards (windows of 256)", launches)
            dg = digest(json.dumps(pod_digests(store), sort_keys=True))
            m = svc.metrics()
            r = dict(launches=launches, digest=dg, windows=svc._batch_engine.last_timings.get("windows"),
                     shard_devices=m["shard_devices"], sharded_dispatches=m["sharded_dispatches_total"],
                     plane_shard_bytes=m["plane_shard_bytes_per_device"],
                     uploaded=m["device_bytes_uploaded_total"], fallbacks=dict(svc.stats["batch_fallbacks"]))
            rec[f"cfg2 service {n}"] = r
            log(f"cfg2 service on {n} shards: {json.dumps(r)}")
            if dg != cfg2_digest or r["fallbacks"] or launches["scan"] or launches["scan_sharded"] < 2 \
                    or m["shard_devices"] != n:
                raise AssertionError(f"phase 38 (1): cfg2's service round on {n} shards ({cfg2_digest}): {json.dumps(r)}")

    # (2) north and cfg4: one-launch rounds on 2 and 4 shards, timed
    for name in ("north", "cfg4"):
        w = WORKLOADS[name]
        nodes, all_pods, pending, vols = make_cluster(name)
        P = len(pending)
        docs = {}
        for n in (None, *SHARDS):
            leg = "one device" if n is None else f"{n} shards"
            with Phase(f"phase 38 (2): {name} one launch, {leg}, float32"):
                eng = engine(name, torch.float32, device=DEVICE, mesh=None if n is None else shard_mesh(dev, n))
                K.reset_counts()
                res = eng.schedule(nodes, all_pods, pending, base_counter=w.base_counter, start_index=w.start,
                                   volumes=vols)
                launches = dict(K.LAUNCHES)
                docs[leg] = round_documents(res, P)
                if n is not None:
                    main_path(f"{name} one-launch round on {n} shards", launches)
                    want = {**{k: 0 for k in K.LAUNCHES}, "scan_sharded": 1, "compact": 1}
                    if launches != want or docs[leg] != docs["one device"]:
                        raise AssertionError(f"phase 38 (2): {name} on {n} shards: launches {launches}, documents "
                                             f"{'equal' if docs[leg] == docs['one device'] else 'differ'}")
                    log(f"{name} on {n} shards: documents equal the one-device round's; launches {launches}")
        with Phase(f"phase 38 (2): {name} scan timed, one device and 2 and 4 shards, float32"):
            pr_n = E.pad_problem(E.encode(nodes, all_pods, pending, volumes=vols))
            dp, dims, ws0 = lowered(name, pr_n, torch.float32, dev)
            cfg_n = workload_cfg(name)
            t = {"unsharded_ms": cuda_ms(lambda: K.scan(cfg_n, dims, dp, ws0=ws0), 2, 1)[0]}
            for n in SHARDS:
                sp = B.shard_device_problem(dp, shard_mesh(dev, n))
                ms, kout = cuda_ms(lambda: K.scan_sharded(cfg_n, dims, sp, ws0=ws0), 2, 1)
                t[f"{n}_ms"] = ms
                t[f"{n}_cluster"] = K.cluster_width(dims["N"] // n, 1)
                # what the shard mode adds a pod, against the unsharded
                # kernel: the exchanges, the wider kernel (every gate on)
                # and its spills, less what the split of the node axis saves
                t[f"{n}_added_us_a_pod"] = 1e3 * (ms - t["unsharded_ms"]) / pr_n.P_true
                # the exchanges alone, timed in the kernel (the last timed
                # launch): each shard's rank-0 block from each publish to the
                # end of its wait, the wait for the slowest shard included
                xns = kout["_exchange_ns"][0].double().cpu()
                t[f"{n}_exchange_us_a_pod"] = float(xns.mean()) / 1e3 / dims["P"]
                t[f"{n}_exchange_us_a_pod_max_shard"] = float(xns.max()) / 1e3 / dims["P"]
                del sp, kout
            t.update(P=pr_n.P_true, N=pr_n.N_true, cluster=K.cluster_width(dims["N"], 1))
            rec[f"{name} timed"] = t
            log(f"{name} timed: {json.dumps(t)}")
            del dp

    # (3) K5: cfg7-preempt-5k's first dispatch on 2 and 4 shards, then the
    # cfg7 cut through a service on a mesh (the main path)
    with Phase("phase 38 (3): K5 at cfg7-preempt-5k's first dispatch on 2 and 4 shards, float32"):
        with open(k5_path, "rb") as f:
            pr5, sargs, skw = TP.restore(pickle.load(f))
        want = PK.run_search(pr5, *sargs, **skw, device=DEVICE, dtype=torch.float32)
        for n in SHARDS:
            calls: list = []
            launch = K.preempt

            def keep(*args, **kw):
                calls.append(tuple(a.clone() for a in args))
                return launch(*args, **kw)

            K.preempt = keep
            try:
                got = PK.run_search(pr5, *sargs, **skw, device=DEVICE, dtype=torch.float32,
                                    mesh=shard_mesh(dev, n))
            finally:
                K.preempt = launch
            for k in ("cand", "victims", "viol"):
                if not np.array_equal(got[k], want[k]):
                    raise AssertionError(f"phase 38 (3): K5 on {n} shards: mask {k} differs from the unsharded launch")
            err["preempt_sharded"] = max(err["preempt_sharded"], max_abs_err(got, want, ("cand", "victims", "viol")))
            if len(calls) != n:
                raise AssertionError(f"phase 38 (3): K5 on {n} shards launched {len(calls)} times")
            if n == 2:
                ms, host_ms, outs = device_ms(lambda: [K.preempt(*a) for a in calls], 20)
                plain_ms, _p = cuda_ms(lambda: [preempt_plain(*a) for a in calls], 1, warmup=0)
                cnt = [search_counts(a, o) for a, o in zip(calls, outs)]
                b_ms, b_by = bound({"bytes": sum(c["bytes"] for c in cnt), "ops": sum(c["ops"] for c in cnt)},
                                   torch.float32)
                rec["k5"] = dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                 shards=2, shape=[list(a[0].shape) for a in calls])
            log(f"K5 on {n} shards: {n} launches over the node ranges, masks equal the unsharded launch's")
        rec["k5"]["err"] = err["preempt_sharded"]
        log(f"K5 timed: {json.dumps(rec['k5'])}")
    with Phase(f"phase 38 (3): cfg7-preempt-5k cut {PREEMPT_CUT} through the service, one device and 2 shards"):
        r1, d1, _n1 = run_preempt(PREEMPT_CUT, DEVICE, torch.float32)
        r2, d2, _n2 = run_preempt(PREEMPT_CUT, DEVICE, torch.float32, mesh=shard_mesh(dev, 2))
        main_path("cfg7-preempt-5k cut on 2 shards", r2["launches"])
        rec["cfg7 cut"] = dict(one=r1["launches"], sharded=r2["launches"], nominations=r2["nominations"])
        if d1 != d2 or r2["launches"]["preempt"] < 2 or r2["nominations"] != r1["nominations"]:
            raise AssertionError(f"phase 38 (3): the cfg7 cut on 2 shards: {json.dumps(rec['cfg7 cut'])}, pods "
                                 f"{'equal' if d1 == d2 else 'differ'}")
        log(f"cfg7 cut on 2 shards: pods equal the one-device service's; {json.dumps(rec['cfg7 cut'])}")

    # (4) K8: cfg6 through a service on a mesh, and the burst
    with Phase(f"phase 38 (4): cfg6-autoscale {AUTOSCALE} through the service, one device and 2 shards, float32"):
        r1, d1, e1 = run_autoscale(DEVICE, torch.float32, frozen_clock=True)
        cap: list = []
        unwrap = lanes_capture(cap)
        try:
            r2, d2, e2 = run_autoscale(DEVICE, torch.float32, frozen_clock=True, mesh=shard_mesh(dev, 2))
        finally:
            unwrap()
        main_path("cfg6-autoscale on 2 shards", r2["launches"])
        if d1 != d2 or e1 != e2 or r2["actions"] != r1["actions"] or r2["kernel_errors"] or not cap:
            raise AssertionError(f"phase 38 (4): cfg6 on 2 shards: actions {r2['actions']} vs {r1['actions']}, pods "
                                 f"{'equal' if d1 == d2 else 'differ'}, events {'equal' if e1 == e2 else 'differ'}")
        first = shard_lanes_check(dev, cap[0], "cfg6's first dispatch")
        cfgl, dimsl, spl, lanesl, widestl = cap[0]["args"]
        ms, _o = cuda_ms(lambda: K.scan_lanes_sharded(cfgl, dimsl, spl, lanesl, widest=widestl), 10, 3)
        ums, _u = cuda_ms(lambda: K.scan_lanes(cfgl, dimsl, unshard(spl), torch.cat(lanesl, 1), widest=widestl),
                          10, 3)
        plain_ms, pout = cuda_ms(lambda: B.scan_lanes_plain_sharded(cfgl, dimsl, spl, lanesl), 1, 0)
        keys = ("packed_pod", "final_requested", "final_pod_count")
        same_digests("cfg6's first dispatch: sharded K8 vs its plain sharded version",
                     out_digests({k: _o[k] for k in keys}), out_digests({k: pout[k] for k in keys}))
        err["scan_lanes_sharded"] = max(err["scan_lanes_sharded"], first["err"], max_abs_err(_o, pout, keys))
        lane_all = torch.cat(lanesl, 1)
        b_ms, b_by = bound(lane_counts(cfgl, dimsl, unshard(spl), lane_all, _u), torch.float32)
        rec["k8"] = dict(ms=ms, unsharded_ms=ums, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         dispatches=len(cap), **first)
        log(f"cfg6 on 2 shards: pods and events equal the one-device service's; {len(cap)} sharded K8 dispatches; "
            f"K8 timed {json.dumps(rec['k8'])}")
        del cap, _o, _u, pout
    with Phase(f"phase 38 (4): the autoscale burst {BURST} on 4 shards, float32"):
        groups, headroom_, pods = workloads.autoscale_burst(**BURST)
        est1 = ScaleUpEstimator(device=DEVICE, dtype=torch.float32).estimate(groups, headroom_, pods)
        cap = []
        unwrap = lanes_capture(cap)
        try:
            K.reset_counts()
            est2 = ScaleUpEstimator(device=DEVICE, dtype=torch.float32, mesh=shard_mesh(dev, 4)).estimate(
                groups, headroom_, pods)
            main_path("the autoscale burst on 4 shards", dict(K.LAUNCHES))
        finally:
            unwrap()
        if [e.__dict__ for e in est1] != [e.__dict__ for e in est2] or len(cap) != 1:
            raise AssertionError("phase 38 (4): the burst's estimates on 4 shards differ from one device's")
        rec["burst"] = shard_lanes_check(dev, cap[0], "the burst")
        err["scan_lanes_sharded"] = rec["k8"]["err"] = max(err["scan_lanes_sharded"], rec["burst"]["err"])
        log(f"the burst on 4 shards: estimates equal; K8 bitwise on the whole axis; {json.dumps(rec['burst'])}")
        del cap

    # (5) the fuzzer's shard role on the card
    with Phase(f"phase 38 (5): the fuzzer's shard role on 2 shards of the card, scenarios {SHARD_FUZZ}"):
        harness = FuzzHarness(DEVICE)
        K.reset_counts()
        div = []
        for seed, index in SHARD_FUZZ:
            v, _s = run_differential(generate_scenario(seed, index), harness, comparisons=("shard-vs-single",))
            div += v["divergences"]
        launches = dict(K.LAUNCHES)
        main_path("fuzz shard role on 2 shards", launches)
        rec["fuzz"] = dict(divergences=div, launches=launches)
        log(f"fuzz shard role: {json.dumps(rec['fuzz'])}")
        if div or not launches["scan_sharded"]:
            raise AssertionError(f"phase 38 (5): {json.dumps(rec['fuzz'])}")

    # (6) the refusals: shards that cannot all be resident, never a hang
    with Phase("phase 38 (6): a shard count that cannot be co-resident is refused"):
        prq = E.pad_problem(E.encode(*make_cluster("cfg2", (4, 8, 0))[:3]), node_multiple=2)
        dpq, dimsq = B.lower(prq, dtype=torch.float32, device=dev)
        cfgq = B.BatchConfig(filters=tuple(FIVE_FILTERS), scores=(("NodeResourcesFit", 1),), trace=False)
        spq = B.shard_device_problem(dpq, shard_mesh(dev, 2))
        lanes = [torch.ones((SHARD_REFUSED_LANES, dimsq["N"] // 2), dtype=torch.bool, device=dev)] * 2
        t0 = time.perf_counter()
        try:
            K.scan_lanes_sharded(cfgq, dimsq, spq, lanes)
        except K.KernelArgumentError as exc:
            rec["refused"] = dict(s=time.perf_counter() - t0, error=str(exc))
        else:
            raise AssertionError(f"phase 38 (6): {SHARD_REFUSED_LANES} lanes x 2 shards were not refused")
        log(f"refused in {rec['refused']['s']:.4f} s: {rec['refused']['error']}")
    with Phase("phase 38 (6): more one-block shard clusters than the card holds at once are refused"):
        n = refused_clusters(torch.cuda.get_device_properties(dev).multi_processor_count)
        prc = E.pad_problem(E.encode(*make_cluster("cfg2", (4, 8, 0))[:3]), node_multiple=n)
        dpc_, dimsc = B.lower(prc, dtype=torch.float32, device=dev)
        spc = B.shard_device_problem(dpc_, shard_mesh(dev, n))
        t0 = time.perf_counter()
        try:
            K.scan_sharded(cfgq, dimsc, spc)
        except K.KernelArgumentError as exc:
            rec["refused_clusters"] = dict(shards=n, s=time.perf_counter() - t0, error=str(exc))
        else:
            raise AssertionError(f"phase 38 (6): {n} shard clusters of one block were not refused")
        log(f"refused in {rec['refused_clusters']['s']:.4f} s: {rec['refused_clusters']['error']}")
        del spc, dpc_
    with Phase("phase 38 (6): a shard that never answers ends its peers' waits at the cap, raised"):
        cap_, silent = K.SHARD_SPIN_CAP, K.SILENT_SHARD
        K.SHARD_SPIN_CAP, K.SILENT_SHARD = SHARD_TEST_CAP, 1
        t0 = time.perf_counter()
        try:
            K.scan_sharded(cfgq, dimsq, spq)
        except K.KernelLaunchError as exc:
            rec["spin_cap"] = dict(cap=SHARD_TEST_CAP, s=time.perf_counter() - t0, error=str(exc))
        else:
            raise AssertionError("phase 38 (6): a silent shard's peers returned without an error")
        finally:
            K.SHARD_SPIN_CAP, K.SILENT_SHARD = cap_, silent
        # the card still answers: the same launch with every shard
        same_digests("phase 38 (6): the launch after the cap", sharded_digests(K.scan_sharded(cfgq, dimsq, spq)),
                     sharded_digests(K.scan(cfgq, dimsq, dpq)))
        log(f"the cap: {json.dumps(rec['spin_cap'])}; the next launch bitwise the unsharded kernel")

    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(rec, f, default=str)


def shard_start(cfg2_digest: str, k5_dispatch: bytes) -> dict:
    """Phase 38's child started on the card (``shard_child``), beside phases
    30-34 and phase 37's child; ``shard_phase`` joins it."""
    import pickle
    import tempfile

    tmp = tempfile.mkdtemp(prefix="kss-phase38-")
    _TMPDIRS.append(tmp)
    k5_path = os.path.join(tmp, "k5.pickle")
    with open(k5_path, "wb") as f:
        pickle.dump(k5_dispatch, f)
    out = os.path.join(tmp, "phase38.json")
    root = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            f"chip_smoke.shard_child({cfg2_digest!r}, {k5_path!r}, {out!r})")
    logf = open(os.path.join(tmp, "phase38.log"), "w", encoding="utf-8")
    env = dict(os.environ)
    env.pop("KSS_MESH_PROCESSES", None)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, stdout=logf, stderr=subprocess.STDOUT, cwd=root)
    _CHILDREN.append(proc)
    return dict(proc=proc, out=out, log=logf, t0=time.perf_counter())


def shard_phase(started: dict, card: str) -> dict:
    """Phase 38 joined: its child's log printed and its record read."""
    with Phase("phase 38: the node axis sharded, the child on the card (joined)"):
        proc = started["proc"]
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        started["log"].close()
        log(open(started["log"].name, encoding="utf-8").read().rstrip()[-20000:])
        if rc != 0 or not os.path.exists(started["out"]):
            raise AssertionError(f"phase 38's child exited {rc}")
        rec = json.load(open(started["out"], encoding="utf-8"))
        rec["wall_s"] = time.perf_counter() - started["t0"]
        log(f"phase 38: {rec['wall_s']:.3f} s from its start; main-path launches {json.dumps(rec['main'])}; {card}")
    return rec


def workload_cfg(name):
    """The scan's configuration of a workload (trace on)."""
    from kube_scheduler_simulator_tpu_torch.ops import batch as B

    w = WORKLOADS[name]
    filters, scores = PROFILES[w.profile]
    return B.BatchConfig(filters=filters, scores=tuple(scores), trace=True, tie_break=w.tie, seed=7)


def encoded(name):
    """A workload's encoded, padded problem (from its seed)."""
    from kube_scheduler_simulator_tpu_torch.ops import encode as E

    nodes, all_pods, pending, vols = make_cluster(name)
    return E.pad_problem(E.encode(nodes, all_pods, pending, volumes=vols))


def lowered(name, pr, dt, dev):
    """(dp, dims, ws0) of a workload's encoded problem on ``dev``, with the
    workload's round knobs."""
    from kube_scheduler_simulator_tpu_torch.ops import batch as B
    from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import num_feasible_nodes_to_find

    w = WORKLOADS[name]
    dp, dims = B.lower(pr, dtype=dt, device=dev)
    N = pr.N_true
    dp = dp._replace(tb_base=w.base_counter, start0=w.start % N, sample_k=num_feasible_nodes_to_find(N, w.pct))
    return dp, dims, B.pick_ws0(workload_cfg(name), dims, dp.sample_k, N)


def out_digests(out: dict, lane: "int | None" = None) -> dict:
    """sha256 of each output tensor's dtype, shape and bytes (lane ``lane``
    of laned outputs; the final carry field by field, flattened, as
    ``same_outputs`` compares it): two outputs with equal digests are
    bitwise equal."""
    import hashlib

    import torch

    def one(t, flat=False):
        t = torch.as_tensor(t)
        t = (t if lane is None else t[lane]).contiguous()
        if flat:
            t = t.reshape(-1)
        h = hashlib.sha256(f"{t.dtype} {tuple(t.shape)}".encode())
        h.update(t.cpu().reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b"")
        return h.hexdigest()

    got = {}
    for k, v in out.items():
        if k == "final_carry":
            got.update({f"final_carry {f}": one(fv, flat=True) for f, fv in v.items()})
        else:
            got[k] = one(v)
    return got


def same_digests(name: str, kernel: dict, plain: dict) -> float:
    """Require the kernel's output digests equal the plain version's; return
    max |a - b| (0.0)."""
    if set(kernel) != set(plain):
        raise AssertionError(f"{name} output keys differ: {set(kernel) ^ set(plain)}")
    bad = sorted(k for k in plain if kernel[k] != plain[k])
    if bad:
        raise AssertionError(f"{name}: kernel and plain version differ in {bad}")
    return 0.0


def max_abs_err(a: dict, b: dict, keys=None) -> float:
    """The largest |a - b| over the outputs ``keys`` (by default every key
    the two share but the chaining view and the wrappers' own ``_`` keys),
    each tensor or array taken as float64 on the CPU; cells equal in value
    (infinities, NaN beside NaN) count 0."""
    import torch

    keys = keys or [k for k in b if k in a and k != "final_carry" and not k.startswith("_")]
    err = 0.0
    for k in keys:
        x, y = (torch.as_tensor(v).detach().cpu().double() for v in (a[k], b[k]))
        if x.shape != y.shape:
            raise AssertionError(f"{k}: shapes {tuple(x.shape)} and {tuple(y.shape)}")
        d = (x - y).abs()
        d[(x == y) | (x.isnan() & y.isnan())] = 0.0
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def gpu_worker_init() -> None:
    """A worker process of the plain references on the card: they are
    host-bound (hundreds of small launches a pod), so two run beside each
    other and beside the main process's untimed checks; nothing is timed
    on the card while they run."""
    import torch

    torch.set_num_threads(2)


def plain_scan_job(name: str, dt_name: str) -> "tuple[float, dict]":
    """Phase 2's plain reference: (ms, output digests) of ``scan_plain`` on a
    workload's problem, rebuilt from its seed, in ``dt_name``."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import batch as B

    dt = getattr(torch, dt_name)
    dp, dims, ws0 = lowered(name, encoded(name), dt, torch.device(DEVICE))
    ms, out = cuda_ms(lambda: B.scan_plain(workload_cfg(name), dims, dp, ws0=ws0), 1, warmup=0)
    dig = out_digests(out)
    del out, dp
    torch.cuda.empty_cache()
    return ms, dig


def tune_session(family: str, dt):
    """A cfg10-tune-10k tuner session of ``family`` in ``dt`` on the card."""
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT

    t = workloads.TUNE
    scores, filters = TT.profile_scores(device=DEVICE)
    nodes, pods, obj = workloads.tune(family, seed=t["seed"], n_nodes=t["n_nodes"], n_pods=t["n_pods"])
    return TT.TuningSession(nodes, pods, scores, filters=filters, objective=obj, dtype=dt, device=DEVICE), obj


def plain_lane_job(family: str, dt_name: str, w: list) -> "tuple[float, dict]":
    """Phase 23's plain reference: (ms, output digests) of ``scan_plain`` on
    cfg10-tune-10k's ``family`` problem under the weight row ``w``."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import batch as B

    dt = getattr(torch, dt_name)
    s, _obj = tune_session(family, dt)
    wt = torch.tensor(w, dtype=dt, device=DEVICE)
    ms, out = cuda_ms(lambda: B.scan_plain(s.cfg, s.dims, s.dp, weights=wt), 1, warmup=0)
    dig = out_digests(out)
    del out, s
    torch.cuda.empty_cache()
    return ms, dig


def plain_grad_job(dt_name: str, w: list, F, tau: float) -> "tuple[float, object]":
    """Phase 24's plain reference: (ms, d objective / d weights) of
    ``grad_plain`` on cfg10-tune-10k's imbalance problem under the weight
    row ``w`` and the cotangent ``F`` (a numpy [N, 2] array)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.ops import batch as B

    dt = getattr(torch, dt_name)
    s, _obj = tune_session("imbalance", dt)
    wt = torch.tensor(w, dtype=dt, device=DEVICE)
    Ft = torch.as_tensor(F).to(device=DEVICE, dtype=dt)
    ms, (dw, _o) = cuda_ms(lambda: B.grad_plain(s.cfg, s.dims, s.dp, wt, Ft, tau), 1, warmup=0)
    dw = dw.cpu().numpy()
    del _o, s
    torch.cuda.empty_cache()
    return ms, dw


# ------------------------------------------ CPU references, in workers

def cpu_worker_init() -> None:
    """A worker process of the CPU float64 references: never touches the
    card, and leaves cores to the main process."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    torch.set_num_threads(3)


def cpu_round(name: str, cut) -> "tuple[list, list]":
    """A workload's (or its cut's) CPU float64 round: round_documents."""
    import torch

    w = WORKLOADS[name]
    nodes, all_pods, pending, vols = make_cluster(name, cut)
    res = engine(name, torch.float64, device="cpu").schedule(
        nodes, all_pods, pending, base_counter=w.base_counter, start_index=w.start, volumes=vols,
    )
    return round_documents(res, len(pending))


def cpu_churn(spec) -> "tuple[list, dict]":
    """The churn through a CPU float64 service: (per-wave records, pod
    digests after the last wave)."""
    import torch

    records, _total, digests = run_churn(spec, "cpu", torch.float64, echo=False)
    return records, digests


def cpu_preempt(spec) -> "tuple[dict, dict]":
    """The cfg7-preempt-5k cut through a CPU float64 service, two rounds:
    (their record, pod digests after them)."""
    import torch

    rec, digests, _names = run_preempt(spec, "cpu", torch.float64, max_rounds=2)
    return rec, digests


def cpu_gang(cut: str) -> "tuple[list, tuple]":
    """A cfg8-gang cut through a CPU float64 service: (per-wave records,
    (the pod digests after each wave, the events' digest))."""
    import torch

    records, _total, digests, _store, _svc = run_gang(
        GANG_CUTS[cut], "cpu", torch.float64, echo=False, small_nodes=cut == "cascade", strict=cut != "cascade",
    )
    return records, digests


def cpu_tune() -> "tuple[list, dict]":
    """The bench-size tune reports and the zero-drift service rounds on the
    CPU in float64: (tune_reports, tune_service_rounds)."""
    import torch

    return tune_reports("cpu", torch.float64, TUNE_PARITY), tune_service_rounds("cpu", torch.float64)


def cpu_autoscale() -> "tuple[dict, dict, str]":
    """cfg6-autoscale through a CPU float64 service, the store's clock
    frozen: run_autoscale's (record, pod digests, events digest)."""
    import torch

    return run_autoscale("cpu", torch.float64, frozen_clock=True)


def cpu_scenario() -> "tuple[dict, tuple]":
    """cfg11-scenario's float64 cut through a CPU float64 service: (record,
    (sha256 of the returned Scenario, sha256 of the store dump))."""
    import torch

    rec, out, store, _svc = run_scenario("cpu", torch.float64, SCENARIO_F64, echo=False)
    return rec, (digest(json.dumps(out, sort_keys=True)), digest(json.dumps(store.dump(), sort_keys=True)))


def cpu_autoscale_scenario() -> "tuple[dict, str]":
    """The autoscale replay on the CPU in float64: run_autoscale_scenario's
    (record, timeline digest)."""
    import torch

    return run_autoscale_scenario("cpu", torch.float64)


def cpu_stream() -> "tuple[dict, str]":
    """cfg9-stream's float64 cut streamed through a CPU float64 service:
    run_stream's (record, digest)."""
    import torch

    return run_stream("cpu", torch.float64, "streamed", STREAM_F64_TICKS)


_POOL = None  # the CPU worker pool, stopped on the way out of the script
_K5_DISPATCH: list = []  # cfg7-preempt-5k's first victim-search dispatch (phase 13), for phase 38
_GPU_POOL = None  # the plain references' worker pool on the card, stopped likewise
_CHILDREN: list = []  # phase 36's and 37's child processes, killed likewise where still running
_TMPDIRS: list = []  # phase 36's warm cache and phase 37's directory, removed likewise


def main() -> int:
    global _POOL, _GPU_POOL
    t_all = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from kube_scheduler_simulator_tpu_torch.ops import batch as B
        from kube_scheduler_simulator_tpu_torch.ops import encode as E
        from kube_scheduler_simulator_tpu_torch.ops import kernels as K
        from kube_scheduler_simulator_tpu_torch.scheduler.framework_runner import num_feasible_nodes_to_find
        from kube_scheduler_simulator_tpu_torch import workloads
    except ImportError as exc:
        print(f"chip_smoke: the port package is not beside this script ({exc})", file=sys.stderr)
        return 2
    import numpy as np

    assert "jax" not in sys.modules, "the port must not import jax"
    dev = torch.device(DEVICE)

    with Phase("card"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
            f"count {torch.cuda.device_count()}")
        try:
            import yaml

            log(f"yaml imports here (PyYAML {yaml.__version__}); phase 34's path does not need it")
        except ImportError:
            log("yaml does not import here; phase 34's path does not need it")
    # the build (nvcc, one process a source) runs on a thread of its own:
    # the workers' references (plain versions and CPU runs need no built
    # kernel) and the clusters' encoding go on beside it
    import threading

    build_error: list = []

    def build() -> None:
        try:
            K.build()
        except BaseException as exc:  # noqa: BLE001 - re-raised when the build is joined
            build_error.append(exc)

    builder = threading.Thread(target=build, name="kernel-build")
    t_build = time.perf_counter()
    builder.start()
    with Phase("C renderer (native/fastjson.c)"):
        from kube_scheduler_simulator_tpu_torch import native

        st = native.status()
        log(f"renderer status: {json.dumps(st)}")
        if not st["loaded"]:
            raise AssertionError(f"the C renderer did not load: {st['reason']}")
        if shutil.which(st["compiler"]):
            cc = subprocess.run([st["compiler"], "--version"], capture_output=True, text=True, timeout=60)
            log(f"{st['compiler']} --version: {(cc.stdout or cc.stderr).strip().splitlines()[0] if cc.returncode == 0 else cc.stderr.strip()}")
        log(f"renderer built in {st['build_s']:.3f} s ({'compiled' if st['built'] else 'cached'}) from "
            f"{native.SOURCE} into {st['path']}")

    # the CPU references (phases 4 and 9) run beside the card's phases; the
    # longest first
    _POOL = multiprocessing.get_context("spawn").Pool(2, initializer=cpu_worker_init)
    cpu_refs = {name: _POOL.apply_async(no_kernel_errors, (cpu_round, name, cut)) for name, cut in ANNOTATION_CHECKS}
    cpu_churn_ref = _POOL.apply_async(no_kernel_errors, (cpu_churn, CHURN_CUT,))
    cpu_preempt_ref = _POOL.apply_async(no_kernel_errors, (cpu_preempt, PREEMPT_CUT,))
    cpu_gang_refs = {cut: _POOL.apply_async(no_kernel_errors, (cpu_gang, cut,)) for cut in GANG_CUTS}
    cpu_autoscale_ref = _POOL.apply_async(no_kernel_errors, (cpu_autoscale,))
    cpu_tune_ref = _POOL.apply_async(no_kernel_errors, (cpu_tune,))
    cpu_stream_ref = _POOL.apply_async(no_kernel_errors, (cpu_stream,))
    cpu_scenario_ref = _POOL.apply_async(no_kernel_errors, (cpu_scenario,))
    cpu_autoscale_scenario_ref = _POOL.apply_async(no_kernel_errors, (cpu_autoscale_scenario,))
    cpu_bridge_refs = {name: _POOL.apply_async(no_kernel_errors, (cpu_bridge_oracle, name,)) for name in BRIDGE_LEGS}
    cpu_sim_ref = _POOL.apply_async(no_kernel_errors, (cpu_sim_session,))
    cpu_extender_ref = _POOL.apply_async(no_kernel_errors, (cpu_extender,))

    # the plain references of phases 2, 23 and 24 run on the card in two
    # worker processes while the main process runs its untimed checks;
    # every timing waits until they are idle
    _GPU_POOL = multiprocessing.get_context("spawn").Pool(2, initializer=gpu_worker_init)
    dts = (torch.float32, torch.float64)
    plain_refs = {(name, dt): _GPU_POOL.apply_async(no_kernel_errors, (plain_scan_job, name, str(dt).split(".")[-1]))
                  for name in WORKLOADS for dt in dts}

    clusters = {}
    timing: dict = {}
    for name in WORKLOADS:
        t0 = time.perf_counter()
        nodes, all_pods, pending, vols = make_cluster(name)
        pr = E.pad_problem(E.encode(nodes, all_pods, pending, volumes=vols))
        clusters[name] = (nodes, all_pods, pending, vols, pr)
        log(f"{name}: generated and encoded in {time.perf_counter() - t0:.2f} s")
    with Phase("build (the rest of it, once the workers started and the clusters were encoded)"):
        builder.join()
        if build_error:
            raise build_error[0]
        log(f"kernel build: {K.build_seconds:.2f} s (nvcc, sm_90a, {len(K.SOURCES)} sources in parallel), "
            f"{time.perf_counter() - t_build:.2f} s after it started")

    # ------------------------------------------------ kernel vs plain
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timed: dict = {}  # (name, dt) -> what the timing pass needs
    for name in WORKLOADS:
        w = WORKLOADS[name]
        P, N = w.pods, w.nodes
        nodes, all_pods, pending, vols, pr = clusters[name]
        filters, scores = PROFILES[w.profile]
        cfg = workload_cfg(name)
        for dt in dts:
            with Phase(f"scan kernel vs plain, {name} {P}x{N}, {dt}"):
                dp, dims, ws0 = lowered(name, pr, dt, dev)
                log(f"padded P={dims['P']} N={dims['N']} R={dims['R']} sample_k={dp.sample_k} start0={dp.start0} "
                    f"ws0={ws0} SG={dims['SG']} G={dims['G']} D={dims['D']} KC={dims['KC']} KS={dims['KS']} "
                    f"KA={dims['KA']} KB={dims['KB']} KP={dims['KP']} KO={dims['KO']} keys={dims['key_struct']} "
                    f"domain slots {K.domain_layout(dims, dt)} PT={dims['PT']} VR={dims['VR']} VID={dims['VID']} "
                    f"DR={dims['DR']} CLOUD={dims['CLOUD']} lists KPT/KVR/KV/KM="
                    f"{dp.port_cols.shape[1]}/{dp.restr_cols.shape[1]}/{dp.csi_cols.shape[1]}/"
                    f"{dp.ip_match_g.shape[1]} gates {B.plugin_gates(cfg, dims)}")
                C = K.cluster_width(dims["N"], 1)
                log(f"one cluster of C={C} blocks; the lane's carries (bytes): "
                    f"{json.dumps(carry_bytes(cfg, dims, dp, dt, 1))}")
                kout = K.scan(cfg, dims, dp, ws0=ws0)
                torch.cuda.synchronize()
                kdig = out_digests(kout)
                if dt == torch.float32:
                    # the redundant chains (the earlier design), bitwise the cluster
                    bdig = out_digests(K.scan(cfg, dims, dp, ws0=ws0, blocks=sms))
                    same_digests(f"{name}: the redundant chains ({sms} blocks) vs the cluster", bdig, kdig)
                    log(f"the redundant chains ({sms} blocks) bitwise equal to the cluster ({len(kdig)} outputs)")
                t0 = time.perf_counter()
                plain_ms, pdig = plain_refs.pop((name, dt)).get()
                log(f"plain version (worker process) waited for {time.perf_counter() - t0:.2f} s")
                err = same_digests("scan", kdig, pdig)
                fail = kout["fail_plug"][: pr.P_true]
                codes = {
                    f: sorted(set(kout["fail_code"][: pr.P_true][fail == k].unique().tolist()))
                    for k, f in enumerate(filters) if f in ("PodTopologySpread", "InterPodAffinity")
                }
                log(f"scan bitwise equal ({len(pdig)} outputs, digests); plain {plain_ms:.1f} ms; "
                    f"scheduled {int((kout['selected'][: pr.P_true] >= 0).sum())}/{pr.P_true}; "
                    f"first-failure codes {codes}")
                if w.storage:
                    # (pod, node) pairs each filter rejected first
                    rejected = {f: int((fail == k).sum()) for k, f in enumerate(filters)}
                    log(f"first rejections per filter: {json.dumps(rejected)}")
                    gates = B.plugin_gates(cfg, dims)
                    off = [g for g in ("ports", "restr", "cloud", "csi") if not gates[g]]
                    none = [f for f in MUST_REJECT if rejected[f] == 0]
                    if off or none:
                        raise AssertionError(f"{name}: gates off {off}; filters that rejected nothing {none}")
                # the compaction on these planes at the widths a round picks
                packed = kout["packed_pod"].cpu().numpy()
                W = min(dims["N"], E._bucket(max(int(packed[3].max()), 1)))
                WS = min(dims["N"], E._bucket(max(int(packed[1].max()), 1)), ws0 or dims["N"])
                mm = kout["trace_meta"].cpu().numpy()
                rdt = tuple(B.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(cfg.scores)))
                cfn, manifest = B.build_compact_fn(cfg, dims, W, WS, rdt, int(mm[-1, 1]), in_step_ws0=ws0)
                kb = K.compact(cfg, dims, W, WS, manifest, kout, pr.N_true, ws0)
                pb = B.compact_plain(cfg, dims, W, WS, manifest, kout, pr.N_true, ws0)
                cerr = same("compact blob", kb, pb)
                log(f"compact bitwise equal (W={W} WS={WS} in-step {ws0} mode="
                    f"{B.fail_pack_mode(int(mm[-1, 1]), len(filters))} raw={rdt}, {kb.numel()} bytes)")
                if ws0 is not None:
                    # in-step compaction: the same kernel's full planes,
                    # gathered at the ascending sampled ids, and their blob
                    full = K.scan(cfg, dims, dp)
                    for k, v in gather_sampled(full, ws0).items():
                        same(f"in-step {k} vs full planes gathered", kout[k], v)
                    _ffn, fman = B.build_compact_fn(cfg, dims, W, WS, rdt, int(mm[-1, 1]))
                    fb = K.compact(cfg, dims, W, WS, fman, full, pr.N_true)
                    # the pods' rows: a padding row's sampled cells are
                    # kept in the full planes, masked in the compacted ones
                    ub, uf = (B.unpack_compact_blob(b.cpu().numpy(), manifest) for b in (kb, fb))
                    for k in ub:
                        if not np.array_equal(ub[k][: pr.P_true], uf[k][: pr.P_true]):
                            raise AssertionError(f"in-step blob vs full-plane blob: plane {k} differs")
                    log(f"in-step planes [P,{ws0}] equal the full planes gathered; blobs equal in the pods' rows")
                    del fb
                    del full
                timed[(name, dt)] = (cfg, dims, dp, ws0, W, WS, manifest, pr.N_true,
                                     dict(scan_plain_ms=plain_ms, scan_err=err, compact_err=cerr))
                del kout, kb, pb
                torch.cuda.empty_cache()

    # the workers are idle now: the timing pass
    for (name, dt), (cfg, dims, dp, ws0, W, WS, manifest, n_true, t) in timed.items():
        with Phase(f"scan and compaction kernels timed, {name}, {dt}"):
            # warm-up calls first: the first timed scan of the process
            # must not pay for clocks or the allocator settling
            big = WORKLOADS[name].pods >= 10000
            ms, kout = cuda_ms(lambda: K.scan(cfg, dims, dp, ws0=ws0), *((2, 1) if big else (20, 10)))
            # the redundant chains beside it, float32 only (one launch at full size)
            blocks_ms = None
            if dt == torch.float32:
                blocks_ms, _bo = cuda_ms(lambda: K.scan(cfg, dims, dp, ws0=ws0, blocks=sms), *((1, 0) if big else (5, 2)))
                del _bo
            # K3 back to back behind a sleep of the card, its host µs a call beside it
            cms, chost_ms, _kb = device_ms(lambda: K.compact(cfg, dims, W, WS, manifest, kout, n_true, ws0), 20)
            cplain_ms, _pb = cuda_ms(lambda: B.compact_plain(cfg, dims, W, WS, manifest, kout, n_true, ws0), 3)
            sb, sby = bound(scan_counts(cfg, dims, dp, kout), dt)
            cb, cby = bound(compact_counts(kout, manifest, W, WS, n_true), dt)
            timing[(name, dt)] = t = dict(
                scan_ms=ms, scan_blocks_ms=blocks_ms, cluster=K.cluster_width(dims["N"], 1),
                scan_plain_ms=t["scan_plain_ms"], scan_err=t["scan_err"], scan_bound_ms=sb,
                scan_bound_by=sby, compact_ms=cms, compact_host_us=1e3 * chost_ms, compact_plain_ms=cplain_ms,
                compact_err=t["compact_err"], compact_bound_ms=cb, compact_bound_by=cby,
            )
            log(f"timing {name} {str(dt).split('.')[-1]}: {json.dumps(t)}")
            del kout, _kb, _pb
    del timed
    torch.cuda.empty_cache()

    with Phase(f"compact kernel vs plain, every fail-pack mode and raw dtype (seeded planes {K3_SEEDED})"):
        rng = np.random.default_rng(11)
        n_cases = 0
        for P, N, nt, W, WS, ws0 in K3_SEEDED:
            for filters in (FIVE_FILTERS, ()):
                if ws0 is not None and not filters:
                    continue
                cfg = B.BatchConfig(filters=filters, scores=tuple(FIVE_SCORES), trace=True)
                for code_max in (9, 200, 30000, 70000):
                    for rdt in ("int8", "int16", "int32"):
                        for dt in (torch.float32, torch.float64):
                            out = seeded_planes(P, N, nt, ws0, code_max, rdt, dt, dev, rng)
                            dims = {"P": P, "N": N}
                            _fn, manifest = B.build_compact_fn(cfg, dims, W, WS, (rdt,) * 5, code_max, in_step_ws0=ws0)
                            same(
                                f"compact P={P} N={N} W={W} WS={WS} ws0={ws0} filters={len(filters)} "
                                f"code_max={code_max} raw={rdt} {dt}",
                                K.compact(cfg, dims, W, WS, manifest, out, nt, ws0),
                                B.compact_plain(cfg, dims, W, WS, manifest, out, nt, ws0),
                            )
                            n_cases += 1
        log(f"compact bitwise equal: {n_cases} cases, every shape x 2 filter sets (in-step: filters only) x 4 code "
            f"ranges (modes 0-3) x 3 raw dtypes x 2 float dtypes")

    # ------------------------------------------------------ end to end
    results = {}
    main_launches = None
    # float64 rounds where phase 4 compares a full-size round's bytes
    full_f64 = [name for name, cut in ANNOTATION_CHECKS if cut is None]
    for name in WORKLOADS:
        w = WORKLOADS[name]
        P, N = w.pods, w.nodes
        nodes, all_pods, pending, vols, _pr = clusters[name]
        for dt in (torch.float32, torch.float64) if name in full_f64 else (torch.float32,):
            with Phase(f"end to end BatchEngine(device='cuda'), {name} {P}x{N}, {dt}"):
                eng = engine(name, dt)
                ok, why = eng.supported(pending, nodes, vols)
                assert ok, why
                K.reset_counts()
                t0 = time.perf_counter()
                res = eng.schedule(nodes, all_pods, pending, base_counter=w.base_counter, start_index=w.start,
                                   volumes=vols)
                wall = time.perf_counter() - t0
                launches = dict(K.LAUNCHES)
                # a fresh engine's placer uploads every plane: no scatter
                if launches != dict(ROUND_LAUNCHES):
                    raise AssertionError(f"the round did not launch scan and compaction once each: {launches}")
                if eng.last_promotion is not None:
                    raise AssertionError(f"{name} {dt}: promoted to float64 ({eng.last_promotion})")
                log(f"exactness bound: {json.dumps(headroom(eng.last_bound))}")
                if name == MAIN and dt == torch.float32:
                    main_launches = launches
                sel = res.selected[:P]  # rows past P are shape padding
                assert len(sel) == P and ((sel >= -1) & (sel < N)).all()
                lt = eng.last_timings
                log(f"wall {wall:.3f} s encode_s {lt['encode_s']:.3f} device_s {lt['device_s']:.3f} "
                    f"scheduled {int((sel >= 0).sum())}/{P} launches {launches}")
                stages = {k: round(v, 4) for k, v in eng.profiler.snapshot()["last_wave"].items()}
                log(f"host stages (s): {json.dumps(stages, sort_keys=True)}")
                results[(name, dt)] = res

    for name, cut in ANNOTATION_CHECKS:
        w = WORKLOADS[name]
        P, N = cut[:2] if cut else (w.pods, w.nodes)
        with Phase(f"{name} {P}x{N} annotation bytes: CUDA float64 round vs CPU float64 round"):
            if cut is None:
                gpu = results[(name, torch.float64)]
            else:
                nodes, all_pods, pending, vols = make_cluster(name, cut)
                K.reset_counts()
                gpu = engine(name, torch.float64).schedule(
                    nodes, all_pods, pending, base_counter=w.base_counter, start_index=w.start, volumes=vols,
                )
                assert K.LAUNCHES == dict(ROUND_LAUNCHES), K.LAUNCHES
            gsel, gdocs = round_documents(gpu, P)
            t0 = time.perf_counter()
            csel, cdocs = cpu_refs[name].get()
            log(f"CPU float64 round (worker process) waited for {time.perf_counter() - t0:.2f} s")
            assert csel == gsel, "selections differ between CUDA and CPU float64"
            for i in range(P):
                for d, kind in enumerate(("filter", "score", "finalScore")):
                    if cdocs[i][d] != gdocs[i][d]:
                        raise AssertionError(f"pod {i}: {kind} annotation bytes differ")
            log(f"{P} pods x 3 annotation documents byte-identical (sha256); "
                f"scheduled {sum(s is not None for s in gsel)}/{P}")

    with Phase("float32 against float64 (CUDA rounds)"):
        f32_report = {}
        for name in full_f64:
            P = WORKLOADS[name].pods
            filters, scores = PROFILES[WORKLOADS[name].profile]
            r32, r64 = results[(name, torch.float32)], results[(name, torch.float64)]
            t32, t64 = r32.out["trace"], r64.out["trace"]
            diff_sel = np.nonzero(r32.selected[:P] != r64.selected[:P])[0]
            per_plugin = {}
            for k, (s, _w) in enumerate(scores):
                rows = [
                    i for i in range(P)
                    if not (np.array_equal(t32["sids"][i], t64["sids"][i])
                            and np.array_equal(t32["raw"][k][i], t64["raw"][k][i])
                            and np.array_equal(t32["norm"][k][i], t64["norm"][k][i]))
                ]
                per_plugin[s] = len(rows)
            # per filter: rows whose first failures of that filter (cells
            # and codes) differ; all rows when the windows differ in width
            per_filter = {}
            same_w = t32["fail_plug"].shape == t64["fail_plug"].shape
            for k, f in enumerate(filters):
                if not same_w:
                    per_filter[f] = P
                    continue
                h32, h64 = t32["fail_plug"][:P] == k, t64["fail_plug"][:P] == k
                c32 = np.where(h32, t32["fail_code"][:P], 0)
                c64 = np.where(h64, t64["fail_code"][:P], 0)
                per_filter[f] = int(((h32 != h64) | (c32 != c64)).any(axis=1).sum())
            rep = {
                "pods": P,
                "selected_differ": int(len(diff_sel)),
                "first_differing_pod": int(diff_sel[0]) if len(diff_sel) else None,
                "score_rows_differ": per_plugin,
                "filter_rows_differ": per_filter,
            }
            if name == "cfg2":
                docs = {"filter": 0, "score": 0, "finalScore": 0}
                for i in range(P):
                    docs["filter"] += r32.filter_annotation_json(i) != r64.filter_annotation_json(i)
                    s32, f32 = r32.score_annotations_json(i)
                    s64, f64 = r64.score_annotations_json(i)
                    docs["score"] += s32 != s64
                    docs["finalScore"] += f32 != f64
                rep["documents_differ"] = docs
            f32_report[name] = rep
            log(f"{name}: float32 vs float64: {json.dumps(rep, sort_keys=True)}")


    # ------------------------------------------- row scatter (K4)
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    P_ch, N_ch, waves_ch, cordon_ch = CHURN
    with Phase("scatter kernel vs plain on every plane of the churn's problem"):
        # the problem of cfg5-churn's first wave: 5 000 nodes, 2 000 pods
        cstore = ClusterStore(clock=lambda: 0.0)
        gen = workloads.churn(cstore, P_ch, N_ch, waves_ch, cordon=cordon_ch)
        next(gen)
        cpods = cstore.list("pods", copy_objects=False)
        churn_pr = E.pad_problem(E.encode(cstore.list("nodes", copy_objects=False), cpods, cpods, None))
        del gen, cstore
        planes: dict = {}
        for pdt in (torch.float32, torch.float64):
            host, _dims = B.lower_host(churn_pr, pdt)
            for (fname, sub), a in B.problem_leaves(host).items():
                key = (str(a.dtype), a.ndim)
                if fname not in B.CARRY0_FIELDS and a.shape[0] >= 4 and (
                    key not in planes or a.shape[0] > planes[key][1].shape[0]
                ):
                    planes[key] = (fname if sub is None else f"{fname}[{sub}]", a)
        g = torch.Generator().manual_seed(17)
        checked = []
        s_err = 0.0
        for (dts, nd), (fname, a) in sorted(planes.items()):
            rows_n = a.shape[0]
            buf0 = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for k in sorted({1, 2, 7, max(1, rows_n // 16), max(1, rows_n // 4)}):
                idx = torch.randperm(rows_n, generator=g)[:k].to(torch.int32)
                idx = torch.cat([idx, idx[:1].repeat(3)]).to(dev)
                src = torch.from_numpy(np.ascontiguousarray(a[torch.randperm(rows_n, generator=g)[: k + 3].numpy()]))
                src = src.to(dev)
                src[k:] = src[0]
                want = B.scatter_rows_plain(buf0.clone(), idx, src)
                got = K.scatter_rows(buf0.clone(), idx, src)
                s_err = max(s_err, same(f"scatter {fname} {dts} rank {nd} K={k}", got, want))
            checked.append(f"{fname} {dts} {tuple(a.shape)}")
        log(f"scatter bitwise equal on {len(checked)} planes: {checked}")
        # the main path's update: node_unsched [N], the rows of one cordon
        # step (about 2 x 50 nodes), padded to a bucket as the placer does
        unsched = torch.from_numpy(host["node_unsched"]).to(dev)
        k_main = E._bucket(2 * cordon_ch)
        idx = torch.randperm(unsched.shape[0], generator=g)[:k_main].to(torch.int32).to(dev)
        rows = torch.ones(k_main, dtype=torch.bool, device=dev)
        idx64 = idx.long()
        # the three in turns, kernel first and last (200 calls each)
        s_us, s_host = host_and_cuda_us(lambda: K.scatter_rows(unsched, idx, rows), 200)
        p_us, p_host = host_and_cuda_us(lambda: B.scatter_rows_plain(unsched, idx, rows), 200)
        l_us, l_host = host_and_cuda_us(lambda: unsched.index_copy_(0, idx64, rows), 200)
        s2_us, s2_host = host_and_cuda_us(lambda: K.scatter_rows(unsched, idx, rows), 200)
        s_bytes = k_main * 4 + 2 * k_main * rows.element_size()
        scatter_t = dict(ms=min(s_us, s2_us) / 1e3, host_us=min(s_host, s2_host), runs_us=[s_us, s2_us],
                         plain_ms=p_us / 1e3, plain_host_us=p_host, library_ms=l_us / 1e3, library_host_us=l_host,
                         bound_ms=s_bytes / HBM_BYTES_PER_S * 1e3, K=k_main, bytes=s_bytes, err=s_err)
        scatter_t["bounded_by"] = "host" if scatter_t["host_us"] >= 0.9 * scatter_t["ms"] * 1e3 else "device"
        log(f"timing scatter node_unsched [{unsched.shape[0]}] K={k_main}: {json.dumps(scatter_t)}")

    # ------------------------------------------- windowed scan (K2w)
    win_t: dict = {}
    for name in ("cfg4", "cfg5-vol"):
        pr = clusters[name][4]
        cfg = workload_cfg(name)
        for dt in (torch.float32, torch.float64):
            with Phase(f"windowed scan vs one launch, {name} full shape, windows of {WINDOW}, {dt}"):
                dp, dims, ws0 = lowered(name, pr, dt, dev)
                Pp, N = dims["P"], pr.N_true
                wdims = dict(dims, P=WINDOW)
                one_ms, one = cuda_ms(lambda: K.scan(cfg, dims, dp, ws0=ws0), 1)

                def chain():
                    carry, outs = None, []
                    for off in range(0, Pp, WINDOW):
                        o = K.scan(cfg, dims, dp, ws0=ws0, carry0=carry, offset=off, window=WINDOW)
                        carry = o["final_carry"]
                        outs.append(o)
                    return outs

                win_ms, outs = cuda_ms(chain, 1)
                keys = [k for k in one if k.startswith(("raw:", "norm:", "fail_"))]
                packed = one["packed_pod"].cpu().numpy()
                W = min(dims["N"], E._bucket(max(int(packed[3].max()), 1)))
                WS = min(dims["N"], E._bucket(max(int(packed[1].max()), 1)), ws0 or dims["N"])
                mm = one["trace_meta"].cpu().numpy()
                rdt = tuple(B.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(cfg.scores)))
                code_max = int(mm[-1, 1])
                _fn, manifest = B.build_compact_fn(cfg, dims, W, WS, rdt, code_max, in_step_ws0=ws0)
                whole = B.unpack_compact_blob(K.compact(cfg, dims, W, WS, manifest, one, N, ws0).cpu().numpy(), manifest)
                _fn, wman = B.build_compact_fn(cfg, wdims, W, WS, rdt, code_max, in_step_ws0=ws0)
                for c, o in enumerate(outs):
                    lo, hi = c * WINDOW, (c + 1) * WINDOW
                    same(f"window {c} packed", o["packed_pod"][:4], one["packed_pod"][:4, lo:hi])
                    for k in keys:
                        same(f"window {c} {k}", o[k], one[k][lo:hi])
                    part = B.unpack_compact_blob(K.compact(cfg, wdims, W, WS, wman, o, N, ws0).cpu().numpy(), wman)
                    for k, v in part.items():
                        if not np.array_equal(v, whole[k][lo:hi]):
                            raise AssertionError(f"window {c}: blob plane {k} differs from the one-launch blob's rows")
                for fname in B.CARRY0_FIELDS:
                    same(f"final carry {fname}", outs[-1]["final_carry"][fname].reshape(-1), one["final_carry"][fname].reshape(-1))
                win_t[(name, dt)] = dict(one_ms=one_ms, windows_ms=win_ms, windows=len(outs))
                log(f"{len(outs)} windows chained on the card equal one launch (packed, {len(keys)} trace planes, "
                    f"blobs, final carry); one launch {one_ms:.2f} ms, windows {win_ms:.2f} ms "
                    f"({100 * (win_ms / one_ms - 1):+.2f} %)")
                del one, outs, dp
                torch.cuda.empty_cache()

    with Phase(f"one window at cfg5-churn's wave shape: kernel vs windowed plain"):
        cfg = B.BatchConfig(filters=DEFAULT_FILTERS, scores=tuple(DEFAULT_SCORES), trace=True, tie_break="first", seed=0)
        dp, dims = B.lower(churn_pr, dtype=torch.float32, device=dev)
        sample_k = num_feasible_nodes_to_find(N_ch, 0)
        dp = dp._replace(sample_k=sample_k)
        ws0 = B.pick_ws0(cfg, dims, sample_k, N_ch)
        wdims = dict(dims, P=WINDOW)
        first = K.scan(cfg, dims, dp, ws0=ws0, offset=0, window=WINDOW)
        carry = first["final_carry"]
        kw = dict(ws0=ws0, carry0=carry, offset=WINDOW, window=WINDOW)
        sw_ms, kout = cuda_ms(lambda: K.scan(cfg, dims, dp, **kw), 20, warmup=3)
        sw_plain_ms, pout = cuda_ms(lambda: B.scan_plain(cfg, dims, dp, **kw), 1, warmup=0)
        sw_err = same_outputs("window 1", kout, pout)
        # the redundant chains beside the cluster, bitwise
        swb_ms, bout = cuda_ms(lambda: K.scan(cfg, dims, dp, blocks=sms, **kw), 5, warmup=1)
        same_outputs("window 1, the redundant chains vs the cluster", bout, kout)
        del bout
        wsb, wsby = bound(scan_counts(cfg, wdims, B.slice_pod_window(dp, WINDOW, WINDOW), kout), torch.float32)
        packed = kout["packed_pod"].cpu().numpy()
        W = min(dims["N"], E._bucket(max(int(packed[3].max()), 1)))
        WS = min(dims["N"], E._bucket(max(int(packed[1].max()), 1)), ws0 or dims["N"])
        mm = kout["trace_meta"].cpu().numpy()
        rdt = tuple(B.raw_dtype_for(int(mm[k, 0]), int(mm[k, 1])) for k in range(len(cfg.scores)))
        _fn, wman = B.build_compact_fn(cfg, wdims, W, WS, rdt, int(mm[-1, 1]), in_step_ws0=ws0)
        wc_ms, wc_host_ms, kb = device_ms(lambda: K.compact(cfg, wdims, W, WS, wman, kout, churn_pr.N_true, ws0), 50)
        wc_plain_ms, pb = cuda_ms(lambda: B.compact_plain(cfg, wdims, W, WS, wman, kout, churn_pr.N_true, ws0), 3)
        wc_err = same("window compaction blob", kb, pb)
        wcb, wcby = bound(compact_counts(kout, wman, W, WS, churn_pr.N_true), torch.float32)
        churn_t = dict(scan_window_ms=sw_ms, scan_window_blocks_ms=swb_ms, cluster=K.cluster_width(dims["N"], 1),
                       scan_window_plain_ms=sw_plain_ms, scan_window_err=sw_err,
                       scan_window_bound_ms=wsb, scan_window_bound_by=wsby, compact_ms=wc_ms,
                       compact_host_us=1e3 * wc_host_ms,
                       compact_plain_ms=wc_plain_ms, compact_err=wc_err, compact_bound_ms=wcb, compact_bound_by=wcby)
        log(f"window 1 of P={dims['P']} N={dims['N']} ws0={ws0} W={W} WS={WS}: kernel equals the windowed plain "
            f"version; {json.dumps(churn_t)}")
        del dp, first, carry, kout, pout

    # ------------------------------------------- cfg5-churn end to end
    def medians(records) -> dict:
        keys = ("wall_s", "encode_s", "device_s", "device_est_s", "commit_s", "annotate_s", "store_mutate_s", "overlap")
        return {k: float(np.median([r[k] for r in records])) for k in keys}

    with Phase(f"cfg5-churn {P_ch} pods x {N_ch} nodes, {CHURN_F32_WAVES} of {waves_ch} waves, cordon {cordon_ch}: "
               f"service on the card, float32"):
        rec32, main_launches_churn, _none = run_churn(CHURN, DEVICE, torch.float32, waves=CHURN_F32_WAVES,
                                                      digests=False)
        log(f"float32 churn: launches over {len(rec32)} waves {main_launches_churn}; medians {json.dumps(medians(rec32))}")
    with Phase(f"cfg5-churn cut to {CHURN_CUT}: CUDA float64 service vs CPU float64 service"):
        _r, _l, dig_gpu = run_churn(CHURN_CUT, DEVICE, torch.float64)
        t0 = time.perf_counter()
        rec_cpu, dig_cpu = cpu_churn_ref.get()
        log(f"CPU float64 service (worker process) waited for {time.perf_counter() - t0:.2f} s")
        for rec in rec_cpu:
            log(f"cpu float64 wave {rec['wave']}: {json.dumps(rec, sort_keys=True)}")
        if dig_gpu.keys() != dig_cpu.keys():
            raise AssertionError("the CUDA and CPU services left different pods")
        bad = [n for n in dig_cpu if dig_gpu[n] != dig_cpu[n]]
        if bad:
            raise AssertionError(f"{len(bad)} pods differ between the CUDA and CPU services, first {bad[:3]}")
        log(f"{len(dig_cpu)} pods: node, annotations and status byte-identical between the CUDA and CPU services")
    # ------------------------------------------- victim search (K5)
    prec, k5_t = preempt_phases(dev, cpu_preempt_ref)

    # ------------------------------------------- gang (K6, K7)
    k6_t, k7_t, gang_launches = gang_phases(dev, cpu_gang_refs)

    # ------------------------------------------- the C renderer's bytes
    render_phases(results[("cfg2", torch.float64)], WORKLOADS["cfg2"].pods, dig_gpu)

    # ------------------------------------------- a clean heap for K8 and K9
    # the cycles the churn, preemption and gang services left, then the
    # rounds and clusters of phases 1-5, are collected, and what is left is
    # frozen: a full collection inside the autoscale loop or the tuner then
    # walks only their own objects
    with Phase("heap before the capacity engine and the tuner"):
        heap = {"tracked": len(gc.get_objects())}
        t0 = time.perf_counter()
        heap["cycles_freed"] = gc.collect()
        heap["cycles_s"] = time.perf_counter() - t0
        heap["after_cycles"] = len(gc.get_objects())
        del clusters, results
        t0 = time.perf_counter()
        heap["rounds_freed"] = gc.collect()
        heap["rounds_s"] = time.perf_counter() - t0
        heap["after_rounds"] = len(gc.get_objects())
        gc.freeze()
        heap["frozen"] = gc.get_freeze_count()
        log(f"gc-tracked objects: {json.dumps(heap)}")

    # ------------------------------------------- capacity engine (K8)
    k8_t = autoscale_phases(dev, cpu_autoscale_ref)

    # ------------------------------------------- the tuner (K9, K2g)
    # its plain references run in the card's workers (~100 s); meanwhile
    # this process runs cfg11-scenario and phase 35's own legs (host-bound)
    tune_started = tune_start(dev)
    # phase 36's children (the kernel-library cache) beside them too
    aot_started = aot_start(dev)

    # ------------------------------------------- cfg11-scenario
    scen_rec, ascen_rec, cut64 = scenario_phases(dev, cpu_scenario_ref, cpu_autoscale_scenario_ref)
    scen_launches = scen_rec["launches"]

    # ------------------------------------------- the fuzzer and kernel chaos
    fuzz_rec = fuzz_phases(dev)

    # ------------------------------------------- the kernel-library cache
    aot_rec = aot_phase(aot_started, fuzz_rec["cfg2"]["uninterrupted"]["digest"], card)
    del aot_started

    # ------------------------------------------- cfg9-stream (still beside them)
    stream_rec = stream_phases(dev, cpu_stream_ref)
    stream_launches = stream_rec["launches"]

    k9_t, k2g_t = tune_phases(dev, cpu_tune_ref, tune_started)
    del tune_started
    # phase 37's child (the scan ensemble) on the card beside phases 30-34,
    # from phase 36's warm cache (its kernels timed: nothing is timed on the
    # card from here on)
    ens_started = ensemble_start(aot_rec["warm"], fuzz_rec["cfg2"]["uninterrupted"]["digest"])
    # phase 38's child (the node axis sharded over shards of the card) too
    shard_started = shard_start(fuzz_rec["cfg2"]["uninterrupted"]["digest"], _K5_DISPATCH[0])
    # phase 34's direct service, in a worker on the card beside phases 29-33
    # (the plain references are done with the pool by now)
    sim_direct_ref = _GPU_POOL.apply_async(no_kernel_errors, (sim_direct,))

    # ------------------------------------------- the lifecycle
    loop_rec = lifecycle_phases(dev, cut64)
    del cut64

    # ------------------------------------------- the journal, the bridge, the extender
    journal_rec = journal_phases(dev)
    legs = [journal_rec["launches"][leg] for leg in ("recovered", "promoted")]
    bridge_legs = {name: bridge_phase(dev, cpu_bridge_refs[name], name) for name in BRIDGE_LEGS}
    bridge_rec = bridge_legs["north"]
    log("phase 32's median latencies (ms) by leg: " + json.dumps(
        {name: {k: round(v["wall_ms"], 3) for k, v in rec["latency"].items()} for name, rec in bridge_legs.items()}))
    ext_rec = extender_phase(dev, cpu_extender_ref)

    # ------------------------------------------- the simulator process
    # phase 35 (d)'s children run beside phase 34
    leg_d = start_process_chaos(dev)
    sim_rec = simulator_phase(dev, cpu_sim_ref, sim_direct_ref)
    sim_launches = {k: sum(rec[k] for rec in sim_rec["launches"].values()) for k in ("scan", "compact", "scatter")}

    # ------------------------------------------- phase 35 (d), joined
    fuzz_rec = process_chaos_phase(dev, leg_d, fuzz_rec)

    # ------------------------------------------- phase 37, joined
    ens_rec = ensemble_phase(ens_started, card)
    # ------------------------------------------- phase 38, joined
    sh_rec = shard_phase(shard_started, card)
    fz = {k: fuzz_rec["sweep"]["launches"][k] + fuzz_rec["stream"]["chaos"]["launches"][k]
          + fuzz_rec["cfg2"]["chaos"]["launches"][k] for k in K.LAUNCHES}
    fz_window = fuzz_rec["cfg2"]["chaos"]["launches"]["scan"]
    fz_scan = fz["scan"] - fz_window
    log("phase 35's launches by kernel: " + json.dumps({"sweep": fuzz_rec["sweep"]["launches"],
                                                          "cfg2 chaos": fuzz_rec["cfg2"]["chaos"]["launches"],
                                                          "stream chaos": fuzz_rec["stream"]["chaos"]["launches"],
                                                          "ProcessChaos children": fuzz_rec["process"]["child_launches"]}))

    ref = MAIN
    main = timing[(ref, torch.float32)]
    churn_shape = f"cfg5-churn: window of {WINDOW} of P={churn_pr.P} N={churn_pr.N}"
    kernels = [
        {
            "name": "scan",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:1185",
            "launches": main_launches["scan"] + stream_launches["scan"] + scen_launches["scan"]
            + loop_rec["launches"]["scan"] + bridge_rec["launches"]["scan"] + bridge_legs["cfg4"]["launches"]["scan"] + ext_rec["launches"]["scan"]
            + sim_launches["scan"] + fz_scan + ens_rec["worker_scan_launches"],
            "launches_by_path": {f"{ref} round": main_launches["scan"], "cfg9-stream streamed": stream_launches["scan"],
                                 "cfg11-scenario (windows and one-launch rounds)": scen_launches["scan"],
                                 "background loop": loop_rec["launches"]["scan"],
                                 "scorer bridge at north": bridge_rec["launches"]["scan"],
                                 "scorer bridge at cfg4": bridge_legs["cfg4"]["launches"]["scan"],
                                 "extender round": ext_rec["launches"]["scan"],
                                 "simulator process at north (phase 34)": sim_launches["scan"],
                                 "fuzz sweep and stream chaos (phase 35)": fz_scan,
                                 "scan ensemble's worker (phase 37: cfg2 and north)": ens_rec["worker_scan_launches"]},
            "max_abs_err": main["scan_err"],
            "ms": main["scan_ms"],
            "plain_ms": main["scan_plain_ms"],
            "bound_ms": main["scan_bound_ms"],
            "bound_by": main["scan_bound_by"],
            "library_ms": None,
            "paced_by": f"sequential dependency chain over the pod queue, one cluster of {main['cluster']} blocks",
            "shape": f"{ref}, one launch (its round)",
            "cluster": main["cluster"],
            "blocks_ms": main["scan_blocks_ms"],
            "by_workload": {n: {k: timing[(n, torch.float32)][k] for k in ("scan_ms", "scan_blocks_ms", "cluster",
                                                                             "scan_bound_ms")} for n in WORKLOADS},
        },
        {
            "name": "scan_window",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:1785",
            "launches": main_launches_churn["scan"] + sum(leg["scan"] for leg in legs) + fz_window,
            "launches_by_path": {"cfg5-churn": main_launches_churn["scan"],
                                 "cfg8-gang-journal recovered leg": legs[0]["scan"],
                                 "cfg8-gang-journal promoted leg": legs[1]["scan"],
                                 "cfg2 kernel chaos (phase 35)": fz_window},
            "max_abs_err": churn_t["scan_window_err"],
            "ms": churn_t["scan_window_ms"],
            "plain_ms": churn_t["scan_window_plain_ms"],
            "bound_ms": churn_t["scan_window_bound_ms"],
            "bound_by": churn_t["scan_window_bound_by"],
            "library_ms": None,
            "paced_by": f"sequential dependency chain over the pod queue, one cluster of {churn_t['cluster']} blocks",
            "shape": churn_shape,
            "cluster": churn_t["cluster"],
            "blocks_ms": churn_t["scan_window_blocks_ms"],
        },
        {
            "name": "compact",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/compact.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:951",
            "launches": main_launches_churn["compact"] + stream_launches["compact"] + scen_launches["compact"]
            + loop_rec["launches"]["compact"] + sum(leg["compact"] for leg in legs)
            + bridge_rec["launches"]["compact"] + bridge_legs["cfg4"]["launches"]["compact"] + ext_rec["launches"]["compact"]
            + sim_launches["compact"] + fz["compact"] + ens_rec["parent_compact_launches"],
            "launches_by_path": {"cfg5-churn": main_launches_churn["compact"],
                                 "cfg9-stream streamed": stream_launches["compact"],
                                 "cfg11-scenario": scen_launches["compact"],
                                 "background loop": loop_rec["launches"]["compact"],
                                 "cfg8-gang-journal recovered leg": legs[0]["compact"],
                                 "cfg8-gang-journal promoted leg": legs[1]["compact"],
                                 "scorer bridge at north": bridge_rec["launches"]["compact"],
                                 "scorer bridge at cfg4": bridge_legs["cfg4"]["launches"]["compact"],
                                 "extender round": ext_rec["launches"]["compact"],
                                 "simulator process at north (phase 34)": sim_launches["compact"],
                                 "fuzz and kernel chaos (phase 35)": fz["compact"],
                                 "scan ensemble's parent (phase 37: cfg2 and north)": ens_rec["parent_compact_launches"]},
            "max_abs_err": churn_t["compact_err"],
            "ms": churn_t["compact_ms"],
            "plain_ms": churn_t["compact_plain_ms"],
            "bound_ms": churn_t["compact_bound_ms"],
            "bound_by": churn_t["compact_bound_by"],
            "library_ms": None,
            "host_us": churn_t["compact_host_us"],
            "shape": churn_shape,
            "timed": "launches back to back behind a sleep of the card (timing.device_ms)",
            "by_workload": {n: {k: timing[(n, torch.float32)][k] for k in ("compact_ms", "compact_host_us",
                                                                             "compact_bound_ms")} for n in WORKLOADS},
        },
        {
            "name": "scatter",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scatter.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:614",
            "launches": main_launches_churn["scatter"] + stream_launches["scatter"] + scen_launches["scatter"]
            + loop_rec["launches"]["scatter"] + sum(leg["scatter"] for leg in legs)
            + bridge_rec["launches"]["scatter"] + bridge_legs["cfg4"]["launches"]["scatter"] + ext_rec["launches"]["scatter"]
            + sim_launches["scatter"] + fz["scatter"],
            "launches_by_path": {"cfg5-churn": main_launches_churn["scatter"],
                                 "cfg9-stream streamed": stream_launches["scatter"],
                                 "cfg11-scenario": scen_launches["scatter"],
                                 "background loop": loop_rec["launches"]["scatter"],
                                 "cfg8-gang-journal recovered leg": legs[0]["scatter"],
                                 "cfg8-gang-journal promoted leg": legs[1]["scatter"],
                                 "scorer bridge at north": bridge_rec["launches"]["scatter"],
                                 "scorer bridge at cfg4": bridge_legs["cfg4"]["launches"]["scatter"],
                                 "extender round": ext_rec["launches"]["scatter"],
                                 "simulator process at north (phase 34)": sim_launches["scatter"],
                                 "fuzz and kernel chaos (phase 35)": fz["scatter"]},
            "max_abs_err": scatter_t["err"],
            "ms": scatter_t["ms"],
            "plain_ms": scatter_t["plain_ms"],
            "bound_ms": scatter_t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": scatter_t["library_ms"],
            "host_us": scatter_t["host_us"],
            "library_host_us": scatter_t["library_host_us"],
            "paced_by": f"the {scatter_t['bounded_by']}: host µs a call beside the CUDA-event µs",
            "shape": f"cfg5-churn: node_unsched [{churn_pr.N}], K={scatter_t['K']}",
        },
        {
            "name": "preempt",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/preempt.cu",
            "replaces": "kube_scheduler_simulator_tpu/preemption/kernel.py:34",
            "launches": prec["launches"]["preempt"] + fz["preempt"],
            "launches_by_path": {"cfg7-preempt-5k": prec["launches"]["preempt"],
                                 "fuzz sweep (phase 35)": fz["preempt"]},
            "max_abs_err": k5_t["err"],
            "ms": k5_t["ms"],
            "plain_ms": k5_t["plain_ms"],
            "bound_ms": k5_t["bound_ms"],
            "bound_by": k5_t["bound_by"],
            "library_ms": None,
            "shape": f"cfg7-preempt-5k first dispatch: {k5_t['shape']}",
            "call_ms": k5_t["host_ms"],
            "dispatch": k5_t["dispatch"],
        },
        {
            "name": "gang_verdict",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/gang.cu",
            "replaces": "kube_scheduler_simulator_tpu/gang/kernel.py:43",
            "launches": gang_launches["gang_verdict"] + sum(leg["gang_verdict"] for leg in legs) + fz["gang_verdict"],
            "launches_by_path": {"cfg8-gang": gang_launches["gang_verdict"],
                                 "cfg8-gang-journal recovered leg": legs[0]["gang_verdict"],
                                 "cfg8-gang-journal promoted leg": legs[1]["gang_verdict"],
                                 "fuzz sweep (phase 35)": fz["gang_verdict"]},
            "max_abs_err": k6_t["err"],
            "ms": k6_t["ms"],
            "plain_ms": k6_t["plain_ms"],
            "bound_ms": k6_t["bound_ms"],
            "bound_by": k6_t["bound_by"],
            "library_ms": None,
            "shape": f"cfg8-gang first dispatch: {k6_t['shape']}",
            "timed": "launches back to back behind a sleep of the card (timing.device_ms)",
            "host_ms": k6_t["host_ms"],
            "cuda_ms": k6_t["cuda_ms"],
            "dispatch_ms": k6_t["dispatch_ms"],
        },
        {
            "name": "gang_feasibility",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/gang.cu",
            "replaces": "kube_scheduler_simulator_tpu/gang/kernel.py:108",
            "launches": k7_t["launches"] + sum(leg["gang_feasibility"] for leg in legs),
            "launches_by_path": {"group_preview at cfg8-gang": k7_t["launches"],
                                 "cfg8-gang-journal recovered leg": legs[0]["gang_feasibility"],
                                 "cfg8-gang-journal promoted leg": legs[1]["gang_feasibility"]},
            "max_abs_err": k7_t["err"],
            "ms": k7_t["ms"],
            "plain_ms": k7_t["plain_ms"],
            "bound_ms": k7_t["bound_ms"],
            "bound_by": k7_t["bound_by"],
            "library_ms": None,
            "shape": f"group_preview at cfg8-gang's final state: {k7_t['shape']}",
            "timed": "launches back to back behind a sleep of the card (timing.device_ms)",
            "host_ms": k7_t["host_ms"],
            "cuda_ms": k7_t["cuda_ms"],
            "dispatch_ms": k7_t["dispatch_ms"],
            "dispatch_stages_us": k7_t["dispatch_stages_us"],
            "bench_shape": k7_t["bench_shape"],
            "bench_ms": k7_t["bench_ms"],
            "bench_bound_ms": k7_t["bench_bound_ms"],
            "seeded_256x64x5000_ms": k7_t["seeded_256x64x5000_ms"],
            "seeded_256x64x5000_bound_ms": k7_t["seeded_256x64x5000_bound_ms"],
        },
        {
            "name": "scan_lanes",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan_masked.cu",
            "replaces": "kube_scheduler_simulator_tpu/autoscaler/estimator.py:186",
            "launches": k8_t["launches"] + ascen_rec["k8_launches"] + fz["scan_lanes"],
            "launches_by_path": {"cfg6-autoscale": k8_t["launches"],
                                 "the autoscale replay (cfg11-scenario phase)": ascen_rec["k8_launches"],
                                 "fuzz sweep (phase 35)": fz["scan_lanes"]},
            "max_abs_err": k8_t["err"],
            "ms": k8_t["ms"],
            "plain_ms": k8_t["plain_ms"],
            "bound_ms": k8_t["bound_ms"],
            "bound_by": k8_t["bound_by"],
            "library_ms": None,
            "paced_by": "sequential dependency chain over the pod queue, one block a lane over its own rows",
            "shape": k8_t["shape"],
            "tile": k8_t["tile"],
            "burst_tile": k8_t["burst_tile"],
            "burst_ms": k8_t["burst_ms"],
            "burst_bound_ms": k8_t["burst_bound_ms"],
            "burst_shape": k8_t["burst_shape"],
            "estimate_cum_s": k8_t["estimate_cum_s"],
            "estimate_split": k8_t["estimate_split"],
        },
        {
            "name": "scan_population",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan.cu",
            "objective_source": "kube_scheduler_simulator_tpu_torch/csrc/tune.cu",
            "replaces": "kube_scheduler_simulator_tpu/tuning/relax.py:36",
            "launches": k9_t["launches"],
            "max_abs_err": k9_t["err"],
            "ms": k9_t["ms"],
            "plain_ms": k9_t["plain_ms"],
            "bound_ms": k9_t["bound_ms"],
            "bound_by": k9_t["bound_by"],
            "library_ms": None,
            "paced_by": f"sequential dependency chain over the pod queue, one cluster of {k9_t['C']} blocks a lane",
            "shape": k9_t["shape"],
            "plain_shape": k9_t["plain_shape"],
            "objective_ms": k9_t["objective_ms"],
            "cluster": k9_t["C"],
            "KM": k9_t["KM"],
            "consolidate_ms": k9_t["consolidate_ms"],
            "consolidate_plain_ms": k9_t["consolidate_plain_ms"],
            "consolidate_bound_ms": k9_t["consolidate_bound_ms"],
            "consolidate_bound_by": k9_t["consolidate_bound_by"],
            "consolidate_launches": k9_t["consolidate_launches"],
            "consolidate_shape": k9_t["consolidate_shape"],
            "consolidate_cluster": k9_t["consolidate_C"],
            "consolidate_KM": k9_t["consolidate_KM"],
        },
        {
            "name": "scan_grad",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:1614",
            "launches": k2g_t["launches"],
            "max_abs_err": k2g_t["err"],
            "ms": k2g_t["ms"],
            "plain_ms": k2g_t["plain_ms"],
            "bound_ms": k2g_t["bound_ms"],
            "bound_by": k2g_t["bound_by"],
            "library_ms": None,
            "paced_by": (f"sequential dependency chain over the pod queue, one cluster of {k2g_t['cluster']} blocks; "
                         f"the softmax sums ride the selection's exchange"),
            "shape": k2g_t["shape"],
            "cluster": k2g_t["cluster"],
            "forward_ms": k2g_t["forward_ms"],
            "hard_forward_ms": k2g_t["hard_forward_ms"],
            "grad_row_wall_s": k2g_t["grad_row_wall_s"],
        },
        {
            "name": "grad_contract",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/tune.cu",
            "replaces": "kube_scheduler_simulator_tpu/tuning/relax.py:63",
            "launches": k2g_t["contract"]["launches"],
            "max_abs_err": k2g_t["contract"]["err"],
            "ms": k2g_t["contract"]["ms"],
            "plain_ms": k2g_t["contract"]["plain_ms"],
            "bound_ms": k2g_t["contract"]["bound_ms"],
            "bound_by": k2g_t["contract"]["bound_by"],
            "library_ms": k2g_t["contract"]["library_ms"],
            "library_call": "torch.einsum('nj,jkn->k', F, M) (without the division by tau)",
            "shape": k2g_t["contract"]["shape"],
        },
    ]
    # the sharded modes (phase 38): launches of its main-path drives, each
    # reset just before and read just after
    def by_path(kernel: str) -> dict:
        return {label: n[kernel] for label, n in sh_rec["by_path"].items() if n.get(kernel)}

    t2 = {name: sh_rec[f"{name} timed"] for name in ("north", "cfg4")}
    kernels += [
        {
            "name": "scan_sharded",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan_shard_trace.cu",
            "untraced_source": "kube_scheduler_simulator_tpu_torch/csrc/scan_shard_cluster.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:1185",
            "sharding": "kube_scheduler_simulator_tpu/ops/batch.py:560 (shard_device_problem: GSPMD over the node axis)",
            "launches": sh_rec["main"]["scan_sharded"],
            "launches_by_path": by_path("scan_sharded"),
            "max_abs_err": sh_rec["cfg2"]["err"],
            "ms": sh_rec["cfg2"]["ms"],
            "plain_ms": sh_rec["cfg2"]["plain_ms"],
            "bound_ms": sh_rec["cfg2"]["bound_ms"],
            "bound_by": sh_rec["cfg2"]["bound_by"],
            "library_ms": None,
            "unsharded_ms": sh_rec["cfg2"]["unsharded_ms"],
            "shape": f"cfg2 one launch, P={sh_rec['cfg2']['P']} N={sh_rec['cfg2']['N']}, 2 shards of the card, "
                     f"clusters of {sh_rec['cfg2']['cluster']}",
            "by_workload": t2,
            "timed": "beside phases 30-34 and phase 37's child (the card shared)",
        },
        {
            "name": "preempt_sharded",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/preempt.cu",
            "replaces": "kube_scheduler_simulator_tpu/preemption/kernel.py:34",
            "sharding": "kube_scheduler_simulator_tpu/preemption/kernel.py:218 (shard_search_args)",
            "launches": sh_rec["main"]["preempt"],
            "launches_by_path": by_path("preempt"),
            "max_abs_err": sh_rec["k5"]["err"],
            "ms": sh_rec["k5"]["ms"],
            "plain_ms": sh_rec["k5"]["plain_ms"],
            "bound_ms": sh_rec["k5"]["bound_ms"],
            "bound_by": sh_rec["k5"]["bound_by"],
            "library_ms": None,
            "shape": f"cfg7-preempt-5k first dispatch on 2 shards: a launch a shard, {sh_rec['k5']['shape']}",
            "timed": "launches back to back behind a sleep of the card (timing.device_ms), beside phases 30-34",
        },
        {
            "name": "scan_lanes_sharded",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan_shard_masked.cu",
            "replaces": "kube_scheduler_simulator_tpu/autoscaler/estimator.py:186",
            "sharding": "kube_scheduler_simulator_tpu/autoscaler/estimator.py:244 (the [G, N] lane mask sharded on N)",
            "launches": sh_rec["main"]["scan_lanes_sharded"],
            "launches_by_path": by_path("scan_lanes_sharded"),
            "max_abs_err": sh_rec["k8"]["err"],
            "ms": sh_rec["k8"]["ms"],
            "plain_ms": sh_rec["k8"]["plain_ms"],
            "bound_ms": sh_rec["k8"]["bound_ms"],
            "bound_by": sh_rec["k8"]["bound_by"],
            "library_ms": None,
            "unsharded_ms": sh_rec["k8"]["unsharded_ms"],
            "shape": f"cfg6-autoscale first dispatch on 2 shards: G={sh_rec['k8']['G']} N={sh_rec['k8']['N']} "
                     f"P={sh_rec['k8']['P']}",
            "burst": sh_rec["burst"],
            "timed": "beside phases 30-34 and phase 37's child (the card shared)",
        },
    ]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"kernel {k['name']} was not launched on its path")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for pool in (_POOL, _GPU_POOL):
            if pool is not None:
                pool.terminate()
                pool.join()
        for child in _CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
        for tmp in _TMPDIRS:
            shutil.rmtree(tmp, ignore_errors=True)
    sys.exit(rc)
