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
  while wave k commits).

Cut for the time limit: no float64 churn runs at full size (the cut of
phase 9 holds float64); the annotation bytes of phase 4 are compared at
full size at cfg2 only (cfg3 at a 1 000 x 500 cut, as cfg4 and cfg5-vol),
so the float64 end-to-end rounds run only there.  None of these holds a
kernel against its plain version.  cfg9-stream times 48 ticks a mode
(``time_stream.py`` runs the bench's 320) and its float64 leg 8.  The
float32 churn, cfg7 and cfg8-gang's scale leg hash no pod digests (nothing
compares them; at full size they cost ~6 ms a MB of annotations).  The float32 churn and cfg8-gang's
scale leg run all 5 of their waves.  The CPU float64
references of phases 4, 9, 14, 18, 22, 26 and 28 run in two worker processes
started after the build, beside the card's phases.  The plain references
of phases 2, 23 and 24 (host-bound: hundreds of small launches a pod) run
on the card in two more worker processes, beside the main process's
untimed checks, and hand back their time and a sha256 digest of every
output (the kernel's must be equal: bitwise); every kernel is timed after
they are idle.  The script stops all four workers before it exits.

Phases (each prints its seconds; any failure exits nonzero before the last
line):

1. the card's name and power limit (nvidia-smi), then the kernel build
   (nvcc, sm_90a, every source in parallel); the C renderer's status
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
8. cfg5-churn end to end on the card, float32 (all 5 waves): per wave
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
28. (run after 26) cfg9-stream on the card, float32, each of the three
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
   float64 service, pod digests (and the gang's events) equal.

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
streamed run's, ``launches_by_path`` apart), and as
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
CHURN_F32_WAVES = 5  # all 5 waves
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
# what one BatchEngine round launches
ROUND_LAUNCHES = {
    "scan": 1, "scan_lanes": 0, "compact": 1, "scatter": 0, "preempt": 0, "gang_verdict": 0, "gang_feasibility": 0,
    "scan_population": 0, "objective": 0, "scan_grad": 0, "grad_contract": 0,
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


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.3f} s")


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


def engine(name, dt, device=DEVICE):
    from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine

    w = WORKLOADS[name]
    filters, scores = PROFILES[w.profile]
    return BatchEngine(
        filters=list(filters), scores=scores, percentage_of_nodes_to_score=w.pct,
        trace=True, tie_break=w.tie, seed=7, device=device, dtype=dt,
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
    """name → (node, sha256 of the annotations and status)."""
    return {
        p["metadata"]["name"]: (
            (p.get("spec") or {}).get("nodeName"),
            digest(json.dumps([p["metadata"].get("annotations"), p.get("status")], sort_keys=True)),
        )
        for p in store.list("pods", copy_objects=False)
    }


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


def run_preempt(spec, device, dt, max_rounds: int = 1, capture: "dict | None" = None, digests=True):
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
    svc = SchedulerService(store, tie_break="first", use_batch="auto", device=device, dtype=dt)
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


def run_autoscale(device, dt, frozen_clock=False, capture: "list | None" = None):
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
                               autoscaler_opts={"expander": "least-waste"}, device=device, dtype=dt)
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


def tune_phases(dev, cpu_tune_ref) -> "tuple[dict, dict]":
    """Phases 23-26 (cfg10-tune-10k and the bench's 12 x 96 size).  The plain
    references of 23 and 24 run in the card's worker processes beside 23's
    and 24's checks; K9 and K2g are timed once they are idle.  Returns (K9's
    timing, K2g's timing)."""
    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import batch as B
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.tuning import objective as TO
    from kube_scheduler_simulator_tpu_torch.tuning import tuner as TT

    t = workloads.TUNE
    size = dict(n_nodes=t["n_nodes"], n_pods=t["n_pods"])
    scores, _filters = TT.profile_scores(device=DEVICE)
    families = {}
    for family in ("imbalance", "consolidate"):
        sess = {}
        for dt in (torch.float32, torch.float64):
            sess[dt], obj = tune_session(family, dt)
        if sess[torch.float32].promotion is not None:
            raise AssertionError(f"cfg10-tune-10k {family} promoted to float64: {sess[torch.float32].promotion}")
        W, gp, frac = generation0(sess[torch.float32], scores, t)
        refs = {dt: _GPU_POOL.apply_async(plain_lane_job, (family, str(dt).split(".")[-1], W[gp].tolist()))
                for dt in sess}
        families[family] = (sess, obj, W, gp, frac, refs)
    sessions, obj, W, gp, frac, _refs = families["imbalance"]
    s32 = sessions[torch.float32]
    shape = f"cfg10-tune-10k imbalance: L={W.shape[0]} P={s32.dims['P']} N={s32.dims['N']} S={W.shape[1]}"
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
            ref = _GPU_POOL.apply_async(plain_grad_job, (str(dt).split(".")[-1], W[gp].tolist(), F.cpu().numpy(),
                                                         t["tau"]))
        grad_cases.append((dt, objective, s, w, hard, F, ref))

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


# ------------------------------------------ plain references on the card, in workers

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


def cpu_stream() -> "tuple[dict, str]":
    """cfg9-stream's float64 cut streamed through a CPU float64 service:
    run_stream's (record, digest)."""
    import torch

    return run_stream("cpu", torch.float64, "streamed", STREAM_F64_TICKS)


_POOL = None  # the CPU worker pool, stopped on the way out of the script
_GPU_POOL = None  # the plain references' worker pool on the card, stopped likewise


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
    with Phase("build"):
        K.build()
        log(f"kernel build: {K.build_seconds:.2f} s (nvcc, sm_90a, {len(K.SOURCES)} sources in parallel)")
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
    cpu_refs = {name: _POOL.apply_async(cpu_round, (name, cut)) for name, cut in ANNOTATION_CHECKS}
    cpu_churn_ref = _POOL.apply_async(cpu_churn, (CHURN_CUT,))
    cpu_preempt_ref = _POOL.apply_async(cpu_preempt, (PREEMPT_CUT,))
    cpu_gang_refs = {cut: _POOL.apply_async(cpu_gang, (cut,)) for cut in GANG_CUTS}
    cpu_autoscale_ref = _POOL.apply_async(cpu_autoscale)
    cpu_tune_ref = _POOL.apply_async(cpu_tune)
    cpu_stream_ref = _POOL.apply_async(cpu_stream)

    # the plain references of phases 2, 23 and 24 run on the card in two
    # worker processes while the main process runs its untimed checks;
    # every timing waits until they are idle
    _GPU_POOL = multiprocessing.get_context("spawn").Pool(2, initializer=gpu_worker_init)
    dts = (torch.float32, torch.float64)
    plain_refs = {(name, dt): _GPU_POOL.apply_async(plain_scan_job, (name, str(dt).split(".")[-1]))
                  for name in WORKLOADS for dt in dts}

    clusters = {}
    timing: dict = {}
    for name in WORKLOADS:
        t0 = time.perf_counter()
        nodes, all_pods, pending, vols = make_cluster(name)
        pr = E.pad_problem(E.encode(nodes, all_pods, pending, volumes=vols))
        clusters[name] = (nodes, all_pods, pending, vols, pr)
        log(f"{name}: generated and encoded in {time.perf_counter() - t0:.2f} s")

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
    k9_t, k2g_t = tune_phases(dev, cpu_tune_ref)

    # ------------------------------------------- cfg9-stream
    stream_rec = stream_phases(dev, cpu_stream_ref)
    stream_launches = stream_rec["launches"]

    ref = MAIN
    main = timing[(ref, torch.float32)]
    churn_shape = f"cfg5-churn: window of {WINDOW} of P={churn_pr.P} N={churn_pr.N}"
    kernels = [
        {
            "name": "scan",
            "route": "cuda",
            "source": "kube_scheduler_simulator_tpu_torch/csrc/scan.cu",
            "replaces": "kube_scheduler_simulator_tpu/ops/batch.py:1185",
            "launches": main_launches["scan"] + stream_launches["scan"],
            "launches_by_path": {f"{ref} round": main_launches["scan"], "cfg9-stream streamed": stream_launches["scan"]},
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
            "launches": main_launches_churn["scan"],
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
            "launches": main_launches_churn["compact"] + stream_launches["compact"],
            "launches_by_path": {"cfg5-churn": main_launches_churn["compact"],
                                 "cfg9-stream streamed": stream_launches["compact"]},
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
            "launches": main_launches_churn["scatter"] + stream_launches["scatter"],
            "launches_by_path": {"cfg5-churn": main_launches_churn["scatter"],
                                 "cfg9-stream streamed": stream_launches["scatter"]},
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
            "launches": prec["launches"]["preempt"],
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
            "launches": gang_launches["gang_verdict"],
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
            "launches": k7_t["launches"],
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
            "launches": k8_t["launches"],
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
    sys.exit(rc)
