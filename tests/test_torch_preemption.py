"""The port's batched preemption (preemption/) against the JAX package's.

- The victim search (K5): seeded numpy problems go to the reference's
  ``run_search`` (jitted, on the CPU) and to the port's ``run_search`` on
  the CPU, whose ``preempt_plain`` stands in for the CUDA kernel; the
  reference's encoded problem is carried across by
  ``problem_from_fields``.  ``cand``, ``victims`` and ``viol`` must be
  equal on every lane.
- The encoder: the same store objects through both packages'
  ``encode_preemption`` and ``prepare_round``; every array and the victim
  pods slot by slot must be equal.
- The service: tests/test_preemption.py's scenarios through the port's
  ``SchedulerService(device="cpu", use_batch="auto", batch_min_work=0)``
  and the JAX service on identical stores: equal annotations, node, status
  (``nominatedNodeName`` included) on every pod, equal evictions, equal
  preemption and fallback counters.

float64 is scoped to each test, as in the other port test files.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.preemption import encode as JE  # noqa: E402
from kube_scheduler_simulator_tpu.preemption import engine as JG  # noqa: E402
from kube_scheduler_simulator_tpu.preemption import kernel as JK  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from test_batch_parity import mk_node, mk_pod  # noqa: E402
from test_torch_service import assert_same, pod_states  # noqa: E402
from kube_scheduler_simulator_tpu_torch.preemption import encode as TE  # noqa: E402
from kube_scheduler_simulator_tpu_torch.preemption import engine as TG  # noqa: E402
from kube_scheduler_simulator_tpu_torch.preemption import kernel as TK  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype), scoped to
    each test."""
    with jax.enable_x64(True):
        yield


# ------------------------------------------------------------ the kernel

SHAPES = [(1, 1, 1, 1, 0, 0), (5, 16, 4, 2, 3, 0), (7, 23, 9, 3, 2, 5), (16, 64, 16, 2, 0, 12)]
VARIANTS = ["mixed", "priority_ties", "zero_request_column", "binding_max_pods", "zero_budget_pdb"]


def search_problem(U, N, V, R, PDB, S, variant, seed):
    """A seeded victim-search problem as the reference encodes one (int64
    resources, slots a prefix of each node's row), plus the dispatch's
    per-pod arrays and the round's extra usage."""
    rng = np.random.default_rng(seed)
    pr = JE.PreemptionProblem([f"n{j}" for j in range(N)], [f"r{r}" for r in range(R)])
    n_valid = rng.integers(0, V + 1, N)
    n_valid[rng.integers(0, N)] = V  # some node holds every slot
    vvalid = np.arange(V)[None, :] < n_valid[:, None]
    hi_prio = 2 if variant == "priority_ties" else 6
    vprio = np.where(vvalid, -np.sort(-rng.integers(0, hi_prio, (N, V)), axis=1), 0)
    vreq = rng.integers(0, 5, (N, V, R)) * 3 * vvalid[..., None]
    ureq = rng.integers(0, 6, (U, R)) * 3
    if variant == "zero_request_column":
        ureq[:, 0] = 0
        vreq[..., -1] = 0
    other = rng.integers(0, 4, (N, R)) * 3
    pr.base_req = vreq.sum(axis=1) + other
    pr.alloc = pr.base_req + rng.integers(-2, 6, (N, R)) * 3
    pr.base_cnt = n_valid + rng.integers(0, 3, N)
    slack = rng.integers(0, 1, N) if variant == "binding_max_pods" else rng.integers(0, 4, N)
    pr.max_pods = pr.base_cnt + slack
    pr.vreq, pr.vprio, pr.vvalid = vreq, vprio, vvalid
    pr.vstart = np.where(vvalid, rng.integers(0, 3 if variant == "priority_ties" else 50, (N, V)), 0)
    pr.vmatch = (rng.random((N, V, PDB)) < 0.45) & vvalid[..., None]
    pr.allowed = rng.integers(0, 3, PDB)
    if variant == "zero_budget_pdb" and PDB:
        pr.allowed[0] = 0
    pr.V, pr.PDB = V, PDB
    pr.victim_pods = [[{"metadata": {"name": f"v{j}-{s}"}} for s in range(int(n_valid[j]))] for j in range(N)]
    pr.res_idx = {r: j for j, r in enumerate(pr.resource_names)}
    ucand = rng.random((U, N)) < 0.8
    uprio = rng.integers(1, hi_prio + 1, U)
    smask = rng.random((U, S)) < 0.6
    sreq = rng.integers(0, 3, (S, R)) * 3
    snode = rng.integers(0, N, S).astype(np.int32)
    extra_req = rng.integers(0, 2, (N, R)) * 3 * (variant == "mixed")
    extra_cnt = rng.integers(0, 2, N) * (variant == "mixed")
    return pr, (ucand, ureq, uprio, smask, sreq, snode), extra_req, extra_cnt


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_search_matches_the_reference(shape, variant):
    """preempt_plain (through the port's run_search on the CPU) against the
    reference's jitted search: equal masks on every (pod, node, slot) lane.
    The round's extra usage goes to the reference folded into base_req, as
    its engine passes it, and to the port as ``usage=``/``cnt=``."""
    pr, args, extra_req, extra_cnt = search_problem(*shape, variant, seed=sum(shape) * 7 + VARIANTS.index(variant))
    port_pr = TK.problem_from_fields(pr)
    base_req, base_cnt = pr.base_req, pr.base_cnt
    pr.base_req, pr.base_cnt = base_req + extra_req, base_cnt + extra_cnt
    want = JK.run_search(pr, *args)
    got = TK.run_search(port_pr, *args, usage=extra_req, cnt=extra_cnt, device="cpu")
    for k in ("cand", "victims", "viol"):
        assert got[k].dtype == np.bool_ and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), (k, np.argwhere(got[k] != want[k])[:5])
    if shape[0] > 1:
        assert want["cand"].any() and want["viol"].any() or shape[4] == 0


def test_search_refuses_values_beyond_exact_floats():
    """A column whose magnitudes pass 2**24 cannot be searched exactly in
    float32: run_search raises instead of rounding."""
    pr, args, _er, _ec = search_problem(5, 16, 4, 2, 3, 0, "mixed", seed=3)
    port_pr = TK.problem_from_fields(pr)
    port_pr.alloc[0, 0] = 1 << 24
    with pytest.raises(ValueError, match="exact integers"):
        TK.run_search(port_pr, *args, device="cpu", dtype=torch.float32)
    assert TK.run_search(port_pr, *args, device="cpu")["cand"].shape == (5, 16)


# ----------------------------------------------------------- the encoder


def _stamp(p, i, start=None):
    p["metadata"]["creationTimestamp"] = f"2024-01-01T00:{i // 60:02d}:{i % 60:02d}Z"
    if start is not None:
        p.setdefault("status", {})["startTime"] = start
    return p


def encoder_cluster(store) -> None:
    """Nodes with bound pods of mixed priorities, equal and distinct start
    times, two namespaces, PDBs (one in another namespace, one with a zero
    budget), pending pods with and without an extended resource, one
    nominated pod."""
    rng = random.Random(5)
    for i in range(7):
        n = mk_node(f"node-{i}", cpu_m=4000, mem_mi=8192, pods=6 + i % 3)
        if i % 3 == 0:
            n["status"]["allocatable"]["example.com/gpu"] = "2"
        store.create("nodes", n)
    store.create("namespaces", {"metadata": {"name": "default"}})
    store.create("namespaces", {"metadata": {"name": "batch"}})
    k = 0
    for i in range(7):
        for s in range(rng.randrange(1, 5)):
            v = mk_pod(f"b-{i}-{s}", cpu_m=rng.choice([300, 600, 900]), mem_mi=rng.choice([128, 256]),
                       labels={"app": f"a{k % 3}", "tier": f"t{s % 2}"}, ns="batch" if k % 4 == 3 else "default")
            v["spec"]["nodeName"] = f"node-{i}"
            v["spec"]["priority"] = rng.choice([0, 0, 5, 10, 200])
            store.create("pods", _stamp(v, k, start=f"2024-01-01T01:00:{rng.randrange(0, 6):02d}Z"))
            k += 1
    for name, sel, ns, allowed in (("pdb-a0", {"app": "a0"}, None, 1), ("pdb-t1", {"tier": "t1"}, None, 0),
                                   ("pdb-batch", {"app": "a1"}, "batch", 2)):
        meta = {"name": name} if ns is None else {"name": name, "namespace": ns}
        store.create("poddisruptionbudgets", {"metadata": meta, "spec": {"selector": {"matchLabels": sel}},
                                              "status": {"disruptionsAllowed": allowed}})
    for i in range(5):
        p = mk_pod(f"pend-{i}", cpu_m=rng.choice([500, 1500]), mem_mi=256)
        p["spec"]["priority"] = 100 + i
        if i == 2:
            p["spec"]["containers"][0]["resources"]["requests"]["example.com/gpu"] = "1"
        if i == 4:
            p["spec"]["volumes"] = [{"name": "scratch", "emptyDir": {}}]
        store.create("pods", _stamp(p, 100 + i))
    nom = mk_pod("nominee", cpu_m=700, mem_mi=64)
    nom["spec"]["priority"] = 300
    store.create("pods", _stamp(nom, 200))
    store.patch("pods", "nominee", {"status": {"nominatedNodeName": "node-1"}})


def _both_services():
    out = []
    for Svc, Store, extra in ((SchedulerService, ClusterStore, {"device": "cpu"}), (JaxService, JaxStore, {})):
        store = Store(clock=lambda: 0.0)
        encoder_cluster(store)
        svc = Svc(store, tie_break="first", use_batch="auto", batch_min_work=0, **extra)
        svc.start_scheduler(None)
        out.append(svc)
    return out


ARRAYS = ("alloc", "base_req", "base_cnt", "max_pods", "vreq", "vprio", "vstart", "vvalid", "vmatch", "allowed")


def assert_problems_equal(got, want) -> None:
    assert got.node_names == want.node_names and got.resource_names == want.resource_names
    assert (got.V, got.PDB, got.res_idx) == (want.V, want.PDB, want.res_idx)
    for f in ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    names = lambda pr: [[p["metadata"]["name"] for p in lows] for lows in pr.victim_pods]  # noqa: E731
    assert names(got) == names(want)


@pytest.mark.parametrize("with_nomination", [False, True])
def test_encoder_matches_the_reference(with_nomination):
    """encode_preemption over the same snapshot NodeInfos, PDBs and
    nominations: equal tables and victim pods slot by slot."""
    port, ref = _both_services()
    prs = []
    for svc in (port, ref):
        snap = svc.build_snapshot()
        pending = [p for p in svc.pending_pods() if p["metadata"]["name"] != "nominee"]
        res = TE.fit_resource_axis(pending) if svc is port else JE.fit_resource_axis(pending)
        assert res == ["cpu", "example.com/gpu", "memory"]
        pdbs = svc.cluster_store.list("poddisruptionbudgets")
        noms = svc._pending_nominations() if with_nomination else None
        enc = TE.encode_preemption if svc is port else JE.encode_preemption
        prs.append(enc(snap.node_infos, res, pdbs, nominated=noms, max_pending_priority=104))
    assert_problems_equal(*prs)
    assert prs[0].vmatch.any() and prs[0].V >= 3


def test_prepare_round_matches_the_reference():
    """prepare_round on each package's framework, engine and snapshot: the
    GCD-scaled problem, the tail's requests, priorities and per-pod
    reasons, NodeResourcesFit's filter index."""
    port, ref = _both_services()
    ctxs = []
    for svc, prep in ((port, TG.prepare_round), (ref, JG.prepare_round)):
        fw = svc.framework
        tail = fw.sort_pods([p for p in svc.pending_pods() if p["metadata"]["name"] != "nominee"])
        nodes = svc.cluster_store.list("nodes", copy_objects=False)
        noms = svc._pending_nominations()
        ctx, reason = prep(fw, svc._engine_for(fw), svc.build_snapshot(), svc.cluster_store, nodes, tail, noms)
        assert reason is None
        ctxs.append(ctx)
    got, want = ctxs
    assert_problems_equal(got.pr, want.pr)
    assert np.array_equal(got.ureq_all, want.ureq_all) and np.array_equal(got.uprio_all, want.uprio_all)
    assert got.pod_reasons == want.pod_reasons and "preemptor mounts volumes" in got.pod_reasons
    assert (got.fit_k, got.n_true) == (want.fit_k, want.n_true)
    assert got.pr.alloc[0, 0] < 4000  # cpu scaled by its column GCD


# ----------------------------------------------------------- the service

PREEMPT_STATS = ("preempt_attempts", "preempt_nominations", "preempt_victims", "preempt_fallbacks", "batch_fallbacks")


def run_services(build, drive, **svc_kw):
    """Build identical stores for both packages (``build(store)`` returns
    the configuration), start a service on each (the port's on the CPU),
    run ``drive(store, svc, make)`` (``make(**kw)`` builds another service of
    the same package on that store; ``drive`` returns the service whose
    counters count, None for ``svc``); returns (port service, port states,
    reference service, reference states)."""
    out = []
    for Svc, Store, extra in ((SchedulerService, ClusterStore, {"device": "cpu"}), (JaxService, JaxStore, {})):
        store = Store(clock=lambda: 0.0)
        cfg = build(store)
        svc = Svc(store, **svc_kw, **extra)
        svc.start_scheduler(cfg)

        def make(cfg=cfg, store=store, Svc=Svc, extra=extra, **kw):
            s = Svc(store, **kw, **extra)
            s.start_scheduler(cfg)
            return s

        counted = drive(store, svc, make) or svc
        out.append((counted, pod_states(store)))
    (port, got), (ref, want) = out
    return port, got, ref, want


def assert_same_preemption(port, got, ref, want) -> None:
    assert_same(got, want)
    for k in PREEMPT_STATS:
        assert port.stats[k] == ref.stats[k], (k, port.stats[k], ref.stats[k])
    if ref.stats["preempt_dispatches"]:
        assert port.stats["preempt_dispatches"] >= 1


def _simple(store):
    for i in range(6):
        store.create("nodes", mk_node(f"node-{i}", cpu_m=1000, mem_mi=2048))
    for i in range(6):
        v = mk_pod(f"victim-{i}", cpu_m=800, mem_mi=128)
        v["spec"]["nodeName"] = f"node-{i}"
        v["spec"]["priority"] = 0
        store.create("pods", _stamp(v, i, start=f"2024-01-01T01:00:{i:02d}Z"))
    vip = mk_pod("vip", cpu_m=700, mem_mi=64)
    vip["spec"]["priority"] = 1000
    store.create("pods", _stamp(vip, 30))


def _sweep(store):
    rng = random.Random(42)
    for i in range(16):
        store.create("nodes", mk_node(f"node-{i}", cpu_m=2000, mem_mi=4096))
    k = 0
    for i in range(16):
        for s in range(3):
            v = mk_pod(f"bound-{i}-{s}", cpu_m=rng.choice([400, 500, 600]), mem_mi=128,
                       labels={"tier": f"t{s}", "app": f"a{i % 3}"})
            v["spec"]["nodeName"] = f"node-{i}"
            v["spec"]["priority"] = rng.choice([0, 5, 10])
            store.create("pods", _stamp(v, k, start=f"2024-01-01T0{rng.randrange(1, 9)}:00:{k % 60:02d}Z"))
            k += 1
    store.create("poddisruptionbudgets", {
        "metadata": {"name": "pdb-t1"}, "spec": {"selector": {"matchLabels": {"tier": "t1"}}},
        "status": {"disruptionsAllowed": 1},
    })
    for i in range(60):
        p = mk_pod(f"fill-{i}", cpu_m=rng.choice([20, 50]), mem_mi=16)
        p["spec"]["priority"] = 20
        store.create("pods", _stamp(p, 100 + i))
    for i in range(6):
        p = mk_pod(f"preemptor-{i}", cpu_m=rng.choice([900, 1100]), mem_mi=64)
        p["spec"]["priority"] = 100 + i
        store.create("pods", _stamp(p, 300 + i))


def _pdb_minimizes(store):
    for i in range(2):
        store.create("nodes", mk_node(f"node-{i}", cpu_m=1000, mem_mi=2048))
    a = mk_pod("guarded", cpu_m=900, mem_mi=128, labels={"app": "db"})
    a["spec"]["nodeName"] = "node-0"
    store.create("pods", _stamp(a, 0, start="2024-01-01T01:00:00Z"))
    b = mk_pod("plain", cpu_m=900, mem_mi=128, labels={"app": "web"})
    b["spec"]["nodeName"] = "node-1"
    store.create("pods", _stamp(b, 1, start="2024-01-01T01:00:01Z"))
    store.create("poddisruptionbudgets", {
        "metadata": {"name": "db-pdb"}, "spec": {"selector": {"matchLabels": {"app": "db"}}},
        "status": {"disruptionsAllowed": 0},
    })
    vip = mk_pod("vip", cpu_m=800, mem_mi=64)
    vip["spec"]["priority"] = 100
    store.create("pods", _stamp(vip, 10))


def _reprieve(store):
    store.create("nodes", mk_node("node-0", cpu_m=1000, mem_mi=4096))
    big = mk_pod("big", cpu_m=700, mem_mi=128)
    big["spec"]["nodeName"] = "node-0"
    big["spec"]["priority"] = 0
    store.create("pods", _stamp(big, 0, start="2024-01-01T01:00:00Z"))
    for i in range(2):
        small = mk_pod(f"small-{i}", cpu_m=100, mem_mi=64)
        small["spec"]["nodeName"] = "node-0"
        small["spec"]["priority"] = 5
        store.create("pods", _stamp(small, 1 + i, start=f"2024-01-01T02:00:0{i}Z"))
    vip = mk_pod("vip", cpu_m=750, mem_mi=64)
    vip["spec"]["priority"] = 100
    store.create("pods", _stamp(vip, 10))


def _volumes_preemptor(store):
    for i in range(2):
        store.create("nodes", mk_node(f"node-{i}", cpu_m=1000, mem_mi=2048))
    for i, name in enumerate(("victim", "victim2")):
        v = mk_pod(name, cpu_m=800, mem_mi=128)
        v["spec"]["nodeName"] = f"node-{i}"
        store.create("pods", _stamp(v, i))
    vip = mk_pod("vip", cpu_m=700, mem_mi=64)
    vip["spec"]["priority"] = 100
    vip["spec"]["volumes"] = [{"name": "scratch", "emptyDir": {}}]
    store.create("pods", _stamp(vip, 10))


def _one_victim_two_nodes(store, small_cpu):
    """node-0 (preferred after the eviction) holds the lone victim; a
    preemptor of priority 100 fits only there once it is gone."""
    store.create("nodes", mk_node("node-0", cpu_m=1000, mem_mi=8192))
    store.create("nodes", mk_node("node-1", cpu_m=small_cpu, mem_mi=8192))
    v = mk_pod("victim", cpu_m=900, mem_mi=128)
    v["spec"]["nodeName"] = "node-0"
    v["spec"]["priority"] = 0
    store.create("pods", _stamp(v, 0))
    pre = mk_pod("preemptor", cpu_m=900, mem_mi=64)
    pre["spec"]["priority"] = 100
    store.create("pods", _stamp(pre, 1))


def _drive_rounds(rounds):
    def drive(store, svc, make):
        svc.schedule_pending(max_rounds=rounds)
    return drive


def _drive_simple(store, svc, make):
    """One round nominates the preemptor; then the queue drains and the
    nominee lands on its node."""
    svc.schedule_pending(max_rounds=1)
    assert (store.get("pods", "vip")["status"]).get("nominatedNodeName")
    svc.schedule_pending()


def _drive_stealers(store, svc, make):
    """Round 1 nominates the preemptor; stealers arrive while it waits out
    its backoff (a frozen queue clock) and take a round of their own, which
    must respect the reservation; then everything drains."""
    svc.schedule_pending(max_rounds=1)
    assert (store.get("pods", "preemptor")["status"]).get("nominatedNodeName") == "node-0"
    for i in range(2):
        p = mk_pod(f"stealer-{i}", cpu_m=150, mem_mi=16)
        p["spec"]["priority"] = 1
        store.create("pods", _stamp(p, 10 + i))
    svc.schedule_pending(max_rounds=1, respect_backoff=True)
    for i in range(2):
        assert store.get("pods", f"stealer-{i}")["spec"].get("nodeName") == "node-1"
    svc.schedule_pending()


def _drive_outranked(store, svc, make):
    """The preemptor is nominated; a higher-priority pod then arrives and a
    fresh service's rounds must fall back to the sequential cycle."""
    svc.schedule_pending(max_rounds=1)
    assert (store.get("pods", "preemptor")["status"]).get("nominatedNodeName") == "node-0"
    king = mk_pod("king", cpu_m=100, mem_mi=16)
    king["spec"]["priority"] = 1000
    store.create("pods", _stamp(king, 50))
    second = make(tie_break="first", use_batch="auto", batch_min_work=0)
    second.schedule_pending(max_rounds=2)
    return second


CFG = {"percentageOfNodesToScore": 100}
SCENARIOS = {
    "simple": (_simple, _drive_simple, {}),
    "randomized_sweep_pdb_commit_wave_16": (_sweep, _drive_rounds(4), {"commit_wave": 16}),
    "pdb_minimizes_violations": (_pdb_minimizes, _drive_rounds(2), {}),
    "reprieve_keeps_small_victims": (_reprieve, _drive_rounds(2), {}),
    "volumes_preemptor_falls_back": (_volumes_preemptor, _drive_rounds(2), {}),
    "nominated_capacity_not_stolen": (
        lambda s: _one_victim_two_nodes(s, 400), _drive_stealers, {"clock": lambda: 0.0},
    ),
    "nomination_gate_outranked": (lambda s: _one_victim_two_nodes(s, 500), _drive_outranked, {}),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_service_preemption_matches_the_reference(scenario):
    """Each tests/test_preemption.py scenario through both services with
    the batched PostFilter: equal pods (annotations, node, status with
    nominatedNodeName), equal evictions, equal counters."""
    build, drive, kw = SCENARIOS[scenario]

    def build_cfg(store):
        build(store)
        return dict(CFG)

    port, got, ref, want = run_services(
        build_cfg, drive, tie_break="first", use_batch="auto", batch_min_work=0, **kw
    )
    assert_same_preemption(port, got, ref, want)
    if scenario == "volumes_preemptor_falls_back":
        assert port.stats["preempt_nominations"] == 0
        assert any("volumes" in r for r in port.stats["preempt_fallbacks"]), port.stats["preempt_fallbacks"]
        assert port.stats["sequential_pods"] >= 1
    elif scenario == "nomination_gate_outranked":
        assert any("outranks" in r or "preemption in flight" in r for r in port.stats["batch_fallbacks"])
    else:
        assert port.stats["preempt_nominations"] >= 1 and port.stats["preempt_fallbacks"] == {}
        assert port.stats["preempt_dispatches"] >= 1
    if scenario == "reprieve_keeps_small_victims":
        assert "small-0" in got and "small-1" in got and "big" not in got
    if scenario == "pdb_minimizes_violations":
        assert "guarded" in got and got["vip"][0] == "node-1"


@pytest.mark.parametrize("pipeline", [False, True])
def test_preemption_wave_matches_the_reference(pipeline):
    """cfg7-preempt-5k (workloads.preemption_wave) cut to 80 nodes, 320
    bound low-priority pods, 280 fillers and 16 preemptors, two rounds:
    every preemptor fails its first scan, each nomination restarts the
    kernel on the tail, and the second round takes the nominees.  With
    ``pipeline`` the first run splits into windows of 256, so the victim
    search of the second window sees 24 same-window successes.  Equal pods,
    evictions and counters; no fallback in the first round; every
    preemptor bound or nominated."""
    from kube_scheduler_simulator_tpu_torch import workloads

    def build(store):
        workloads.preemption_wave(store, n_nodes=80, n_low=320, n_fillers=280, n_preemptors=16)
        return None

    def drive(store, svc, make):
        svc.schedule_pending(max_rounds=1)
        svc.first_round = {k: dict(v) if isinstance(v, dict) else v for k, v in svc.stats.items()}
        # the nominees' round: nominated pods in the round take the
        # sequential cycle, in both packages
        svc.schedule_pending(max_rounds=1)

    port, got, ref, want = run_services(
        build, drive, tie_break="first", use_batch="auto", batch_min_work=0, pipeline=pipeline
    )
    assert_same_preemption(port, got, ref, want)
    first = port.first_round
    assert first["preempt_fallbacks"] == {} and first["batch_fallbacks"] == {} and first["sequential_pods"] == 0
    assert first["preempt_nominations"] >= 4 and first["batch_restarts"] >= first["preempt_nominations"] - 1
    assert port.stats["preempt_dispatches"] == ref.stats["preempt_dispatches"]
    landed = [n for n, (node, _a, _s) in got.items() if n.startswith("preemptor-") and node]
    waiting = [n for n, (node, _a, st) in got.items() if n.startswith("preemptor-") and not node and st.get("nominatedNodeName")]
    assert len(landed) >= 8 and len(landed) + len(waiting) == 16, (landed, waiting)
