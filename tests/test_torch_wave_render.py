"""The port's C renderer wired into the commit paths
(``BatchResult.materialize_wave``, the per-pod pair functions' deferred
twins, the reflector's history) against the port's Python renderer and
against the JAX service.

The Python path is forced by clearing every binding of the renderer: the
package's ``native.fastjson`` (the batch engine reads it at each call) and
the module-level ``_fastjson`` of ``utils/gojson.py`` and
``plugins/storereflector.py`` (bound at import).  The port runs on the CPU
in float64 (``device="cpu"``), the reference in x64; the workloads are
tests/test_wave_render.py's: a result-level round with failure tables and
single-feasible pods, the mixed churn, the gang shapes and a preemption
round; and a round whose node name holds a lone surrogate, which takes the
Python path and must still give the reference's bytes.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path
from typing import Any

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JaxService  # noqa: E402
from kube_scheduler_simulator_tpu.state.store import ClusterStore as JaxStore  # noqa: E402
from test_batch_parity import mk_node, mk_pod, profile_with  # noqa: E402
from test_commit_pipeline import _mixed_cluster, _mixed_pods  # noqa: E402
from test_gang import mk_group, mk_member  # noqa: E402
from test_gang import mk_node as mk_gnode  # noqa: E402
from kube_scheduler_simulator_tpu_torch import native  # noqa: E402
from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config, partially_bound_groups  # noqa: E402
from kube_scheduler_simulator_tpu_torch.plugins import storereflector as SR  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler import batch_engine as BE  # noqa: E402
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService  # noqa: E402
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils import gojson  # noqa: E402

Obj = dict[str, Any]


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype)."""
    with jax.enable_x64(True):
        yield


def python_renderer(m) -> None:
    """Clear every binding of the C renderer (``m``: a monkeypatch)."""
    m.setattr(native, "fastjson", None)
    m.setattr(gojson, "_fastjson", None)
    m.setattr(SR, "_fastjson", None)


def test_the_renderer_is_loaded():
    assert native.fastjson is not None, native.status()["reason"]


# ------------------------------------------------- result-level parity


def test_materialize_wave_docs_match_the_python_per_pod_functions(monkeypatch):
    """materialize_wave's documents against the per-pod functions on the
    Python path, over failure tables (taints, giant pods) and pods with one
    feasible node (no score documents)."""
    rng = random.Random(11)
    store = ClusterStore()
    for i in range(10):
        taints = [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}] if i % 4 == 0 else None
        store.create("nodes", mk_node(f"n{i}", cpu_m=4000 + 500 * (i % 3), mem_mi=8192, taints=taints))
    for i in range(36):
        p = mk_pod(f"p{i}", cpu_m=rng.choice([100, 250, 3900]), mem_mi=rng.choice([64, 256]),
                   labels={"app": f"a{i % 4}"})
        if i % 7 == 0:
            p["spec"]["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        store.create("pods", p)
    svc = SchedulerService(store, tie_break="first", seed=3, device="cpu")
    svc.start_scheduler({"percentageOfNodesToScore": 100})
    fw = svc.framework
    eng = BE.BatchEngine.from_framework(fw, trace=True, device="cpu")
    pending = fw.sort_pods(svc.pending_pods())
    batch = eng.schedule(store.list("nodes"), store.list("pods"), pending, store.list("namespaces"))
    js = [j for j in range(len(pending)) if int(batch.selected[j]) >= 0]
    assert js and len(js) < len(pending)
    docs = batch.materialize_wave(js)
    assert docs is not None and set(docs) == set(js)
    # the per-pod C functions give the same documents, with deferred twins
    for j in js:
        plain, twin = batch.filter_annotation_pair(j)
        assert plain == docs[j]["filter"][0] and isinstance(twin, tuple)
    python_renderer(monkeypatch)
    monkeypatch.setattr(batch, "_wave", lambda: None)
    compared = 0
    for j in js:
        assert docs[j]["filter"][0] == batch.filter_annotation_pair(j)[0], f"pod {j}"
        if int(batch.feasible_count[j]) > 1:
            sp, fp = batch.score_annotations_pairs(j)
            assert sp[1] is None and fp[1] is None
            assert docs[j]["score"][0] == sp[0], f"pod {j} score"
            assert docs[j]["finalScore"][0] == fp[0], f"pod {j} finalScore"
            compared += 1
        else:
            assert "score" not in docs[j]
    assert compared > 0
    # the failed pods' documents: the C renderer's (a fresh result) equal
    # the Python renderer's
    failed = [j for j in range(len(pending)) if int(batch.selected[j]) < 0]
    want = [batch.filter_annotation_json(j) for j in failed]
    monkeypatch.undo()
    fresh = eng.schedule(store.list("nodes"), store.list("pods"), pending, store.list("namespaces"))
    assert [fresh.filter_annotation_json(j) for j in failed] == want


# ------------------------------------------------ service-level parity


def _states(store) -> dict:
    """name → (node, annotations, status) of every pod."""
    return {
        p["metadata"]["name"]: (
            (p.get("spec") or {}).get("nodeName"),
            p["metadata"].get("annotations") or {},
            p.get("status") or {},
        )
        for p in store.list("pods")
    }


def three_ways(monkeypatch, build, drive, **svc_kw) -> dict:
    """``build(store)`` → the configuration; run ``drive(store, service)``
    on the port with the C renderer, on the port with the Python renderer
    and on the JAX service.  Returns their pod states and the port's
    materialize_wave results (None or the number of documents)."""
    waves: list = []
    real = BE.BatchResult.materialize_wave

    def recorded(self, js):
        out = real(self, js)
        waves.append(None if out is None else len(out))
        return out

    monkeypatch.setattr(BE.BatchResult, "materialize_wave", recorded)
    states = {}
    for kind in ("native", "python", "jax"):
        with monkeypatch.context() as m:
            if kind == "python":
                python_renderer(m)
            Svc, Store, extra = (JaxService, JaxStore, {}) if kind == "jax" else (
                SchedulerService, ClusterStore, {"device": "cpu"})
            store = Store(clock=lambda: 0.0)
            cfg = build(store)
            svc = Svc(store, **svc_kw, **extra)
            svc.start_scheduler(cfg)
            drive(store, svc)
            states[kind] = _states(store)
        if kind == "native":
            states["native_waves"] = list(waves)
    return states


def assert_same(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    bad = [k for k in want if got[k] != want[k]]
    assert not bad, (what, len(bad), bad[:3])


def check(states: dict) -> None:
    assert_same(states["native"], states["python"], "C renderer against the Python renderer")
    assert_same(states["native"], states["jax"], "the port against the JAX service")


def _churn_build(store):
    for n in _mixed_cluster(32):
        store.create("nodes", n)
    return {
        "profiles": [profile_with(["NodeResourcesFit", "TaintToleration", "NodeAffinity", "PodTopologySpread"])],
        "percentageOfNodesToScore": 100,
    }


def _churn_drive(store, svc):
    for pods in (_mixed_pods(0, 40),):
        for p in pods:
            store.create("pods", dict(p))
        svc.schedule_pending()
    for i in range(0, 12, 3):  # churn: some scheduled pods leave
        store.delete("pods", f"pod-{i}")
    for p in _mixed_pods(40, 56):
        store.create("pods", dict(p))
    svc.schedule_pending()


def test_churn_annotations_match_python_and_the_reference(monkeypatch):
    """The mixed churn (arrivals, deletions) through the bulk commit in
    windows of 8: byte-identical three ways, every wave rendered in C."""
    states = three_ways(monkeypatch, _churn_build, _churn_drive, seed=5, use_batch="force", batch_min_work=0,
                        commit_wave=8, pipeline=True)
    check(states)
    waves = states["native_waves"]
    assert waves and None not in waves and sum(waves) > 0, waves


def test_gang_annotations_match_python_and_the_reference(monkeypatch):
    """Gang waves (Permit park and release, PodGroup quorum) and singleton
    pods under the gang profile."""

    def build(store):
        store.create("namespaces", {"metadata": {"name": "default"}})
        for i in range(6):
            store.create("nodes", mk_gnode(f"node-{i}", cpu="8", zone=f"zone-{i % 3}"))
        return gang_scheduler_config()

    def drive(store, svc):
        rng = random.Random(21)
        jid = 0
        for wave in range(2):
            for _ in range(2):
                members = rng.randint(2, 4)
                g = f"job-{jid}"
                jid += 1
                store.create("podgroups", mk_group(g, members, timeout=300))
                for m2 in range(members):
                    store.create("pods", mk_member(f"{g}-m{m2}", g, cpu=str(rng.choice([1, 2]))))
            store.create("pods", mk_member(f"solo-{wave}", None))
            svc.schedule_pending(max_rounds=3)
        assert partially_bound_groups(store) == []

    states = three_ways(monkeypatch, build, drive, tie_break="first", use_batch="auto", batch_min_work=0)
    check(states)
    assert None not in states["native_waves"]
    assert sum(n is not None for n, _a, _s in states["native"].values()) >= 10


def test_preemption_annotations_match_python_and_the_reference(monkeypatch):
    """A preemption round: the nomination, the victims' eviction and the
    nominee's later landing."""

    def stamp(p: Obj, i: int, start: "str | None" = None) -> Obj:
        p["metadata"]["creationTimestamp"] = f"2024-01-01T00:00:{i:02d}Z"
        if start is not None:
            p.setdefault("status", {})["startTime"] = start
        return p

    def build(store):
        for i in range(6):
            store.create("nodes", mk_node(f"node-{i}", cpu_m=1000, mem_mi=2048))
        for i in range(6):
            v = mk_pod(f"victim-{i}", cpu_m=800, mem_mi=128)
            v["spec"]["nodeName"] = f"node-{i}"
            v["spec"]["priority"] = 0
            store.create("pods", stamp(v, i, start=f"2024-01-01T01:00:{i:02d}Z"))
        for i in range(8):
            store.create("pods", stamp(mk_pod(f"small-{i}", cpu_m=100, mem_mi=64), 10 + i))
        vip = mk_pod("vip", cpu_m=700, mem_mi=64)
        vip["spec"]["priority"] = 1000
        store.create("pods", stamp(vip, 30))
        return {"percentageOfNodesToScore": 100}

    states = three_ways(monkeypatch, build, lambda store, svc: svc.schedule_pending(), tie_break="first",
                        use_batch="auto", batch_min_work=0)
    check(states)
    assert states["native"]["vip"][0]  # the preemptor landed
    assert None not in states["native_waves"]


def test_a_lone_surrogate_in_a_node_name_takes_the_python_path(monkeypatch):
    """A node name UTF-8 cannot encode: the C renderer refuses the round's
    fragments, the Python renderer writes it, and the bytes equal the
    reference's and the Python path's."""

    def build(store):
        for i in range(4):
            store.create("nodes", mk_node(f"node-{i}" + ("\udc80" if i == 2 else ""), cpu_m=4000, mem_mi=8192))
        for i in range(12):
            store.create("pods", mk_pod(f"pod-{i}", cpu_m=300, mem_mi=128))
        return {"percentageOfNodesToScore": 100}

    states = three_ways(monkeypatch, build, lambda store, svc: svc.schedule_pending(), tie_break="first",
                        use_batch="force", batch_min_work=0)
    check(states)
    assert states["native_waves"] and set(states["native_waves"]) == {None}
    assert any(n == "node-2\udc80" for n, _a, _s in states["native"].values())
