"""The port's gang path against the JAX package's.

- K6 (the window verdict) and K7 (the feasibility scan): the port's plain
  versions and its ``run_*`` functions on the CPU against the reference's
  ``run_window_verdict`` / ``run_feasibility`` on seeded numpy problems
  (ties across nodes, padding and failed members, invalid slots, an
  infeasible group, one group, one domain, a domain per node), and the
  scan at the shapes where its kernel's shape changes on the card
  (tests/test_torch_kernels.py K7_EDGES).
- The encoder (``node_domain_ids``, ``encode_feasibility``), ``group_preview``
  and ``group_victim_search`` against the reference's.
- The port's CPU service against the JAX service on tests/test_gang.py's
  scenarios under the gang profile: churn seeds 1-3, a member that fits
  nowhere (auto and force), the stale-quorum cascade, parked capacity held
  against later batch rounds, permit timeouts expired through
  ``process_waiting_pods``, ``KSS_GANG_BATCH=0``, and cfg8-gang's parity leg
  on 4 nodes (members fail and gangs cascade).  Annotations, node, status
  and events must be equal, and no group partially bound.
- Part A's probe: a float32 round whose memory sums pass 2^24 runs in
  float64 and equals the float64 round and the reference in x64.

The kernels' and the probe's ``gpu``-marked twins live in
tests/test_torch_kernels.py, which imports no JAX and so runs on the card.

Every reference call runs under ``jax.enable_x64(True)`` and is held
exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kube_scheduler_simulator_tpu.gang import encode as JGE  # noqa: E402
from kube_scheduler_simulator_tpu.gang import engine as JGN  # noqa: E402
from kube_scheduler_simulator_tpu.gang import kernel as JGK  # noqa: E402
from kube_scheduler_simulator_tpu.models.nodeinfo import build_node_infos as j_node_infos  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.batch_engine import BatchEngine as JaxEngine  # noqa: E402
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
import test_gang as JT  # noqa: E402  (its churn scenario)
from test_gang import mk_group, mk_member, mk_node  # noqa: E402
from test_torch_kernels import K7_EDGES, k7_problem  # noqa: E402  (K7's edge shapes, no JAX there)
from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.gang import encode as GE  # noqa: E402
from kube_scheduler_simulator_tpu_torch.gang import engine as GN  # noqa: E402
from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config, partially_bound_groups  # noqa: E402
from kube_scheduler_simulator_tpu_torch.gang import kernel as GK  # noqa: E402
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import build_node_infos  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.batch_engine import BatchEngine  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype), scoped to
    each test."""
    with jax.enable_x64(True):
        yield


# ------------------------------------------------------------- K6, K7


def verdict_problem(K, G, N, D, seed, fail=0.05, pad=0.1):
    """Seeded window-verdict inputs (numpy): padding and failed slots, a
    hostname key (dom[g, n] = n) when D == N."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G, K)
    gid[rng.random(K) < pad] = -1
    node = rng.integers(0, N, K)
    node[rng.random(K) < fail] = -1
    dom = np.tile(np.arange(N), (G, 1)) if D == N else rng.integers(0, D, (G, N))
    prior = rng.integers(0, 3, G)
    minm = rng.integers(1, max(2, 2 * K // G), G)
    return [np.asarray(a, dtype=np.int32) for a in (gid, node, dom, prior, minm)] + [D]


VERDICT_CASES = {
    "zone key": (300, 12, 40, 4),
    "hostname key (D = N)": (300, 12, 40, 40),
    "one group": (50, 1, 30, 3),
    "one domain": (120, 6, 25, 1),
    "many failures": (200, 10, 20, 5),
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_window_verdict_matches_the_reference(case):
    K, G, N, D = VERDICT_CASES[case]
    args = verdict_problem(K, G, N, D, seed=len(case), fail=0.3 if case == "many failures" else 0.05)
    want = JGK.run_window_verdict(*args)
    got = GK.run_window_verdict(*args, device="cpu")
    for k in ("feasible", "distinct_domains", "placed"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    plain = GK.verdict_plain(*[torch.from_numpy(a) for a in args[:5]], D)
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(want["feasible"]))
    np.testing.assert_array_equal(plain[1].numpy(), np.asarray(want["distinct_domains"]))
    if G > 1:
        assert not want["feasible"].all()


def feasibility_problem(G, M, N, R, D, seed, holes=True):
    """A seeded GangFeasibilityProblem stand-in (the fields both packages'
    ``run_feasibility`` read): prefix-valid slots with holes, small requests
    (ties across nodes everywhere), some nodes overcommitted, group 0
    asking more than any node has."""
    rng = np.random.default_rng(seed)
    valid = np.arange(M)[None, :] < rng.integers(1, M + 1, G)[:, None]
    if holes:
        valid &= rng.random((G, M)) < 0.9
    req = rng.integers(0, 3, (G, M, R)).astype(np.int64)
    req[0, 0] = 50
    free = rng.integers(-1, 8, (N, R)).astype(np.int64)
    cnt = rng.integers(0, 4, N).astype(np.int64)
    dom = np.tile(np.arange(N) if D == N else np.arange(N) % D, (G, 1)).astype(np.int32)
    return SimpleNamespace(req=req, valid=valid, free=free, cnt_free=cnt, dom=dom, D=D)


FEASIBILITY_CASES = {
    "zone key": (16, 12, 30, 2, 4),
    "hostname key (D = N)": (16, 12, 30, 2, 30),
    "one group": (1, 20, 25, 2, 3),
    "one domain": (8, 10, 20, 3, 1),
    "one resource, no holes": (12, 8, 15, 1, 5),
}


@pytest.mark.parametrize("case", sorted(FEASIBILITY_CASES))
def test_feasibility_scan_matches_the_reference(case):
    G, M, N, R, D = FEASIBILITY_CASES[case]
    pr = feasibility_problem(G, M, N, R, D, seed=len(case), holes="no holes" not in case)
    want = JGK.run_feasibility(pr)
    assert not want["feasible"][0]  # group 0 asks for more than any node has
    for dt in (torch.float64, torch.float32):
        got = GK.run_feasibility(pr, device="cpu", dtype=dt)
        for k in ("feasible", "distinct_domains", "assignment"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{k} {dt}")


@pytest.mark.parametrize("case", sorted(K7_EDGES))
def test_feasibility_scan_matches_the_reference_at_the_kernel_edges(case):
    """run_feasibility on the CPU (its staged buffers and output views
    around the plain version) against the reference at K7_EDGES' shapes,
    where the kernel's shapes change on the card: feasible, distinct
    domains and assignment equal in float64 and float32."""
    pr = k7_problem(*K7_EDGES[case], seed=len(case))
    want = JGK.run_feasibility(pr)
    assert not want["feasible"][0]  # group 0's first member asks more than any node has
    for dt in (torch.float64, torch.float32):
        got = GK.run_feasibility(pr, device="cpu", dtype=dt)
        for k in ("feasible", "distinct_domains", "assignment"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{k} {dt}")
    assert (np.asarray(want["assignment"])[1] == -1).all()  # the all-pad group places nothing


def test_feasibility_scan_refuses_values_beyond_exact_floats():
    pr = feasibility_problem(2, 2, 3, 1, 1, seed=0)
    pr.free[0, 0] = 1 << 24
    with pytest.raises(ValueError, match="beyond exact integers"):
        GK.run_feasibility(pr, device="cpu", dtype=torch.float32)
    assert GK.run_feasibility(pr, device="cpu", dtype=torch.float64)["feasible"].shape == (2,)


def test_encoder_matches_the_reference():
    nodes = [mk_node(f"n{i}", cpu=str(4 + i % 3), zone=f"z{i % 3}") for i in range(7)]
    nodes[3]["metadata"]["labels"].pop("topology.kubernetes.io/zone")
    bound = mk_member("b0", None, cpu="2")
    bound["spec"]["nodeName"] = "n1"
    groups = [[mk_member(f"g{g}-{m}", f"g{g}", cpu=str(1 + m % 2)) for m in range(2 + g)] for g in range(3)]
    keys = ["topology.kubernetes.io/zone", "kubernetes.io/hostname", "topology.kubernetes.io/zone"]
    got = GE.encode_feasibility(groups, keys, build_node_infos(nodes, [bound]))
    want = JGE.encode_feasibility(groups, keys, j_node_infos(nodes, [bound]))
    for f in ("req", "valid", "free", "cnt_free", "dom"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert (got.D, got.resource_names, got.node_names) == (want.D, want.resource_names, want.node_names)


def test_group_victim_search_matches_the_reference():
    nodes = [mk_node(f"n{i}", cpu="8") for i in range(3)]
    pods = []
    for i in range(6):
        v = mk_member(f"low-{i}", None, cpu=str(2 + i % 3))
        v["spec"].update(nodeName=f"n{i % 3}", priority=i % 2)
        v["status"] = {"startTime": f"2024-01-01T00:00:0{i}Z"}
        pods.append(v)
    groups = [([mk_member(f"a{m}", "a", cpu="3") for m in range(2)], 5),
              ([mk_member(f"b{m}", "b", cpu="9") for m in range(2)], 5),
              ([mk_member(f"c{m}", "c", cpu="1") for m in range(3)], 1)]
    want = JGK.group_victim_search(j_node_infos(nodes, pods), groups)
    for dt in (torch.float64, torch.float32):
        assert GK.group_victim_search(build_node_infos(nodes, pods), groups, device="cpu", dtype=dt) == want
    assert want[0]["node"] is not None and want[1]["node"] is None


def _preview_store(Store):
    """4 nodes of 8 CPU in 2 zones, each holding a 6-CPU low-priority pod;
    three groups: "fits" (4 one-CPU members), "big" (2 members of 3 CPU at
    priority 10: infeasible on free capacity, one eviction hosts it) and
    "huge" (2 members of 5 CPU: no single node after evictions)."""
    s = Store(clock=lambda: 0.0)
    s.create("namespaces", {"metadata": {"name": "default"}})
    for i in range(4):
        s.create("nodes", mk_node(f"node-{i}", cpu="8", zone=f"zone-{i % 2}"))
        low = mk_member(f"low-{i}", None, cpu="6")
        low["spec"].update(nodeName=f"node-{i}", priority=0)
        low["status"] = {"startTime": f"2024-01-01T00:00:0{i}Z"}
        s.create("pods", low)
    s.create("podgroups", mk_group("fits", 4, topologyPackKey="topology.kubernetes.io/zone"))
    for m in range(4):
        s.create("pods", mk_member(f"fits-{m}", "fits"))
    for g, cpu in (("big", "3"), ("huge", "5")):
        s.create("podgroups", mk_group(g, 2))
        for m in range(2):
            p = mk_member(f"{g}-{m}", g, cpu=cpu)
            p["spec"]["priority"] = 10
            s.create("pods", p)
    return s


@pytest.mark.parametrize("group", ["fits", "big", "huge"])
def test_group_preview_matches_the_reference(group):
    js, ps = _preview_store(JaxStore), _preview_store(ClusterStore)
    want = JGN.group_preview(js, js.get("podgroups", group))
    got = GN.group_preview(ps, ps.get("podgroups", group), device="cpu")
    assert got == want
    assert want["feasible"] is (group == "fits")
    if group == "fits":
        assert want["distinctTopologyDomains"] == 1
    else:
        assert (want["victimPreview"]["node"] is None) is (group == "huge")


# ---------------------------------------------------------- the service


def _store(Store, nodes):
    s = Store(clock=lambda: 0.0)
    s.create("namespaces", {"metadata": {"name": "default"}})
    for nd in nodes:
        s.create("nodes", nd)
    return s


def _states(store) -> dict:
    pods = {
        p["metadata"]["name"]: (
            (p.get("spec") or {}).get("nodeName"),
            p["metadata"].get("annotations") or {},
            p.get("status") or {},
        )
        for p in store.list("pods")
    }
    events = sorted(
        (e["metadata"]["name"], e["involvedObject"]["name"], e["reason"], e["message"], e["type"])
        for e in store.list("events")
    )
    return {"pods": pods, "events": events}


def run_both(build, drive, use_batch="auto", clock=None):
    """Identical stores for both packages (``build(Store)``), a service on
    each under the gang profile (the port's on the CPU), ``drive(store,
    service)`` on each; returns (port service, port states, reference
    service, reference states).  Every drive step must leave no group
    partially bound."""
    out = []
    for Svc, Store, extra in ((SchedulerService, ClusterStore, {"device": "cpu"}), (JaxService, JaxStore, {})):
        store = build(Store)
        svc = Svc(store, tie_break="first", use_batch=use_batch, batch_min_work=0, clock=clock, **extra)
        svc.start_scheduler(gang_scheduler_config())
        drive(store, svc)
        assert partially_bound_groups(store) == []
        out.append((svc, _states(store)))
    (port, got), (ref, want) = out
    return port, got, ref, want


def assert_same(got, want):
    assert got["pods"].keys() == want["pods"].keys()
    bad = [k for k in want["pods"] if got["pods"][k] != want["pods"][k]]
    assert not bad, (len(bad), bad[:3], got["pods"][bad[0]], want["pods"][bad[0]])
    assert got["events"] == want["events"]


GANG_STATS = ("gang_rounds", "gang_parked", "gang_released_groups", "gang_released_pods",
              "gang_kernel_dispatches", "gang_verdict_mismatch", "permit_wait_expired", "sequential_pods")


def assert_same_stats(port, ref):
    assert {k: port.stats[k] for k in GANG_STATS} == {k: ref.stats[k] for k in GANG_STATS}
    assert port.stats["gang_fallbacks"] == ref.stats["gang_fallbacks"]
    assert port.stats["gang_verdict_mismatch"] == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_churn_matches_the_reference(seed):
    nodes = [mk_node(f"node-{i}", cpu="8", zone=f"zone-{i % 3}") for i in range(6)]
    port, got, ref, want = run_both(
        lambda Store: _store(Store, nodes), lambda store, svc: JT.TestGangBatchParity._churn(store, svc, seed)
    )
    assert_same(got, want)
    assert_same_stats(port, ref)
    assert port.stats["gang_released_groups"] > 0 and port.stats["gang_kernel_dispatches"] > 0


def _failed_member(Store):
    s = _store(Store, [mk_node(f"node-{i}", cpu="4") for i in range(3)])
    s.create("podgroups", mk_group("bad", 3))
    s.create("pods", mk_member("bad-0", "bad"))
    s.create("pods", mk_member("bad-1", "bad"))
    s.create("pods", mk_member("bad-2", "bad", cpu="64"))
    s.create("podgroups", mk_group("ok", 2))
    s.create("pods", mk_member("ok-0", "ok"))
    s.create("pods", mk_member("ok-1", "ok"))
    return s


def _stale_quorum(Store):
    """a-0 parks, a-1 fits nowhere (its cascade rejects a-0), a-2 and a-3
    re-park at 1/3 and 2/3: no release."""
    s = _store(Store, [mk_node(f"node-{i}", cpu="4") for i in range(4)])
    s.create("podgroups", mk_group("g", 3))
    s.create("pods", mk_member("a-0", "g"))
    s.create("pods", mk_member("a-1", "g", cpu="64"))
    s.create("pods", mk_member("a-2", "g"))
    s.create("pods", mk_member("a-3", "g"))
    return s


def _one(rounds=None):
    def drive(store, svc):
        if rounds is None:
            svc.schedule_pending()
        else:
            svc.schedule_pending(max_rounds=rounds)
    return drive


@pytest.mark.parametrize(
    "scenario,use_batch",
    [("failed member", "auto"), ("failed member", "force"), ("failed member", "off"),
     ("stale quorum", "auto"), ("stale quorum", "off")],
)
def test_failures_match_the_reference(scenario, use_batch):
    build, drive = {
        "failed member": (_failed_member, _one()),
        "stale quorum": (_stale_quorum, _one(1)),
    }[scenario]
    port, got, ref, want = run_both(build, drive, use_batch=use_batch)
    assert_same(got, want)
    assert_same_stats(port, ref)
    assert set(port.framework.waiting_pods) == set(ref.framework.waiting_pods)
    if scenario == "stale quorum":
        assert port.stats["gang_released_groups"] == 0 and len(port.framework.waiting_pods) == 2
    elif use_batch != "off":
        assert port.stats["gang_released_groups"] >= 1


def test_parked_capacity_holds_in_later_batch_rounds():
    def build(Store):
        s = _store(Store, [mk_node("node-0", cpu="4"), mk_node("node-1", cpu="4")])
        s.create("podgroups", mk_group("g", 3, timeout=600))
        s.create("pods", mk_member("m0", "g", cpu="3"))
        s.create("pods", mk_member("m1", "g", cpu="3"))
        s.create("pods", mk_member("m2", "g", schedulerName="external-sched"))
        return s

    def drive(store, svc):
        svc.schedule_pending(max_rounds=1)
        assert len(svc.framework.waiting_pods) == 2
        for r in range(2):
            store.create("pods", mk_member(f"intruder-{r}", None, cpu="2"))
            res = svc.schedule_pending(max_rounds=1)
            assert not res[f"default/intruder-{r}"].success
        assert len(svc.framework.waiting_pods) == 2

    port, got, ref, want = run_both(build, drive)
    assert_same(got, want)
    assert_same_stats(port, ref)


def test_permit_timeouts_expire_through_process_waiting_pods():
    t = [0.0]

    def build(Store):
        s = _store(Store, [mk_node(f"node-{i}") for i in range(3)])
        s.create("podgroups", mk_group("g", 3, timeout=60))
        s.create("pods", mk_member("m0", "g"))
        s.create("pods", mk_member("m1", "g"))
        s.create("pods", mk_member("m2", "g", schedulerName="external-sched"))
        return s

    def drive(store, svc):
        t[0] = 0.0
        svc.schedule_pending(max_rounds=1)
        assert len(svc.framework.waiting_pods) == 2
        t[0] = 59.0
        assert svc.process_waiting_pods() == {}
        t[0] = 60.0
        assert len(svc.process_waiting_pods()) == 1
        assert svc.framework.waiting_pods == {}

    port, got, ref, want = run_both(build, drive, clock=lambda: t[0])
    assert_same(got, want)
    assert_same_stats(port, ref)
    assert port.stats["permit_wait_expired"] == 1


def test_the_gang_switch_keeps_rounds_sequential(monkeypatch):
    monkeypatch.setenv("KSS_GANG_BATCH", "0")

    def build(Store):
        s = _store(Store, [mk_node(f"node-{i}") for i in range(3)])
        s.create("podgroups", mk_group("g", 2))
        s.create("pods", mk_member("m0", "g"))
        s.create("pods", mk_member("m1", "g"))
        return s

    port, got, ref, want = run_both(build, _one())
    assert_same(got, want)
    assert_same_stats(port, ref)
    assert port.stats["gang_rounds"] == 0
    assert port.stats["gang_fallbacks"] == {"gang batch path disabled (KSS_GANG_BATCH=0)": 1}
    assert got["pods"]["m0"][0] is not None


def test_cfg8_cascading_cut_matches_the_reference():
    """cfg8-gang's parity leg (24 jobs of 2-8 members, plan seed 23) on 4
    nodes of 8 CPU: members fail in most waves and their gangs cascade."""
    small = [mk_node(f"node-{i}", cpu="8", zone=f"zone-{i % 3}") for i in range(4)]

    def run(Svc, Store, extra):
        store = Store(clock=lambda: 0.0)
        svc = None
        waves = []
        for _w in workloads.gang_churn(store, jobs=24, min_members=2, max_members=8, nodes=4, waves=5, seed=23,
                                       node=lambda i: small[i]):
            if svc is None:
                svc = Svc(store, tie_break="first", use_batch="auto", batch_min_work=0, **extra)
                svc.start_scheduler(gang_scheduler_config())
            svc.schedule_pending(max_rounds=3)
            assert partially_bound_groups(store) == []
            waves.append(_states(store))
        return svc, waves

    port, got = run(SchedulerService, ClusterStore, {"device": "cpu"})
    ref, want = run(JaxService, JaxStore, {})
    for g, w in zip(got, want, strict=True):
        assert_same(g, w)
    assert_same_stats(port, ref)
    assert port.stats["sequential_pods"] > 0 and port.stats["gang_released_groups"] > 0


# ------------------------------------------------------- Part A's probe

PROBE_NODE = {"metadata": {"name": "n0", "labels": {}},
              "status": {"allocatable": {"cpu": "4", "memory": "33554438", "pods": "110"}}}
PROBE_POD = {"metadata": {"name": "p0", "namespace": "default"},
             "spec": {"containers": [{"name": "c", "resources": {"requests": {"memory": "33554439"}}}]}}


def _probe_round(Engine, **kw):
    eng = Engine(filters=["NodeResourcesFit"], scores=[("NodeResourcesFit", 1)], trace=True, **kw)
    res = eng.schedule([PROBE_NODE], [PROBE_POD], [PROBE_POD])
    return eng, (res.selected_nodes[0], res.filter_annotation_json(0), res.score_annotations_json(0))


def test_float32_round_past_the_exact_bound_runs_in_float64():
    ref = _probe_round(JaxEngine)[1]
    assert ref[0] is None and "Insufficient memory" in ref[1]
    e64, r64 = _probe_round(BatchEngine, device="cpu", dtype=torch.float64)
    e32, r32 = _probe_round(BatchEngine, device="cpu", dtype=torch.float32)
    assert r32 == r64 == ref
    assert e64.last_promotion is None and e64.last_timings["promoted_f64"] == 0.0
    assert e32.round_dtype == torch.float64 and e32.last_timings["promoted_f64"] == 1.0
    assert e32.last_promotion.startswith("resource memory:")
    # through the service: one promotion, counted by reason
    states = []
    for dt in (torch.float32, torch.float64):
        store = ClusterStore(clock=lambda: 0.0)
        store.create("nodes", PROBE_NODE)
        store.create("pods", PROBE_POD)
        svc = SchedulerService(store, tie_break="first", use_batch="auto", batch_min_work=0, device="cpu", dtype=dt)
        svc.start_scheduler(None)
        svc.schedule_pending(max_rounds=1)
        states.append(_states(store))
        assert sum(svc.stats["f64_promotions"].values()) == (dt == torch.float32)
        assert svc.stats["batch_pods"] == 1
    assert states[0] == states[1] and states[0]["pods"]["p0"][0] is None


def test_the_bound_leaves_mebibyte_workloads_in_float32():
    from kube_scheduler_simulator_tpu_torch.ops import batch as TB
    from kube_scheduler_simulator_tpu_torch.ops import encode as TE

    nodes, all_pods, pending = workloads.cluster(60, 40, seed=3)
    col, worst = TB.exactness_bound(TE.encode(nodes, all_pods, pending))
    assert 0 < worst < (1 << 24) // 8, (col, worst)
    assert TB.round_dtype((col, worst), torch.float32) == (torch.float32, None)
    with pytest.raises(ValueError, match="beyond exact float64"):
        TB.round_dtype(("resource memory", 1 << 53), torch.float32)
