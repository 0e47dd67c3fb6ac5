"""The port's crash recovery (state/recovery.py) against the JAX package's:
each package recovers the other's journal directory to the other's own
dump; the committed damaged-journal fixtures recover to their expected
bytes; a recovered service is re-armed alike; and a journaled batch-round
service killed by ``kill_at`` in a subprocess, then recovered and resumed
(and separately promoted from a live replica), ends equal to the
uninterrupted run and to the JAX package's service."""

from __future__ import annotations

import importlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from kube_scheduler_simulator_tpu_torch import workloads  # noqa: E402

PACKAGES = ("kube_scheduler_simulator_tpu", "kube_scheduler_simulator_tpu_torch")
CLOCK = 1_700_000_000.0
FIXTURE_ROOT = ROOT / "kube_scheduler_simulator_tpu" / "state" / "fixtures"
FIXTURES = sorted(p.name for p in FIXTURE_ROOT.iterdir() if p.is_dir())


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def store_of(pkg: str):
    return mod(pkg, "state.store").ClusterStore(clock=mod(pkg, "utils.simclock").SimClock(CLOCK))


def service_of(pkg: str, store, **kw):
    extra = {"device": "cpu"} if pkg.endswith("_torch") else {}
    return mod(pkg, "scheduler.service").SchedulerService(
        store, tie_break="first", clock=mod(pkg, "utils.simclock").SimClock(CLOCK), **kw, **extra)


def attach(pkg: str, store, svc, d: str, **kw):
    """The reference's boot wiring (server/di.py)."""
    R = mod(pkg, "state.recovery")
    j = mod(pkg, "state.journal").Journal(d, **kw)
    store.attach_journal(j)
    j.add_meta_provider(R.scheduler_meta_provider(svc))
    snap = mod(pkg, "services.snapshot").SnapshotService(store, svc)
    j.checkpoint_provider = lambda: R.build_checkpoint(store, snap)
    return j


def node(name: str, cpu: str) -> dict:
    return {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name, "zone": f"z{name[-1]}"}},
            "status": {"allocatable": {"cpu": cpu, "memory": "16Gi", "pods": "110"}}}


def pod(name: str, cpu: str) -> dict:
    return {"metadata": {"name": name},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]}}


def run_sequential(pkg: str, d: str, checkpoint_every: int = 0) -> None:
    s = store_of(pkg)
    svc = service_of(pkg, s, use_batch="off")
    j = attach(pkg, s, svc, d, checkpoint_every=checkpoint_every)
    s.create("namespaces", {"metadata": {"name": "default"}})
    svc.start_scheduler(None)
    for i in range(3):
        s.create("nodes", node(f"n{i}", "1"))
    for t in range(3):
        for i in range(3):
            s.create("pods", pod(f"p{t}-{i}", "300m"))
        svc.schedule_pending(max_rounds=2)
        mod(pkg, "state.recovery").write_mark(svc, t)
        if t == 1:
            s.delete("pods", "p0-0", "default")
    if checkpoint_every == 0:
        j.compact()
    s.create("pods", pod("tail", "100m"))


def run_gang(pkg: str, d: str, checkpoint_every: int = 0) -> None:
    s = store_of(pkg)
    svc = service_of(pkg, s, use_batch="force")
    attach(pkg, s, svc, d, checkpoint_every=checkpoint_every)
    plan = workloads.gang_setup(s, jobs=6, min_members=2, max_members=4, nodes=4, seed=9)
    svc.start_scheduler(mod(pkg, "gang").gang_scheduler_config())
    for w in range(3):
        workloads.gang_wave(s, plan, 3, w)
        svc.schedule_pending(max_rounds=3)
        mod(pkg, "state.recovery").write_mark(svc, w)


RUNS = {"sequential": run_sequential, "gang": run_gang}


def recover(pkg: str, d: str):
    s = store_of(pkg)
    report = mod(pkg, "state.recovery").boot_recover(d, s)
    return s, report


@pytest.mark.parametrize("every", [0, 7], ids=["manual checkpoint", "checkpoint every 7"])
@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("writer", PACKAGES, ids=["JAX journal", "port journal"])
def test_each_package_recovers_the_others_journal_to_its_dump(writer, run, every, tmp_path):
    d = tmp_path / "j"
    RUNS[run](writer, str(d), every)
    out = []
    for pkg in (writer, *(p for p in PACKAGES if p != writer)):
        work = tmp_path / pkg
        shutil.copytree(d, work)
        s, report = recover(pkg, str(work))
        out.append((s.dump(), s.resource_version, s.durability_counters(), report.stats(), report.last_meta,
                    report.last_mark, report.scheduler_config))
    assert out[0] == out[1]
    assert out[0][3]["replayed_records"] + out[0][3]["checkpoint_loaded"] > 0


@pytest.mark.parametrize("name", FIXTURES)
def test_every_fixture_recovers_to_its_expected_bytes(name, tmp_path):
    """Recovery truncates torn tails in place: each fixture is copied
    first, and the committed files are never touched."""
    expected = json.loads((FIXTURE_ROOT / name / "expected.json").read_text())
    work = tmp_path / name
    shutil.copytree(FIXTURE_ROOT / name, work)
    store = store_of(PACKAGES[1])
    report = mod(PACKAGES[1], "state.recovery").RecoveryManager(str(work)).recover(store)
    stats = report.stats()
    got = {
        "stats": {k: stats[k] for k in ("replayed_records", "truncated_records", "bad_checkpoints",
                                         "checkpoint_loaded")},
        "resource_version": store.resource_version,
        "counters": store.durability_counters(),
        "dump": store.dump(),
    }
    assert json.dumps(got, sort_keys=True) == json.dumps(expected, sort_keys=True)
    # a second boot over the truncated directory replays clean
    again = mod(PACKAGES[1], "state.recovery").RecoveryManager(str(work)).recover(store_of(PACKAGES[1]))
    assert again.truncated_records == 0 and again.replayed_records == report.replayed_records


@pytest.mark.parametrize("run", list(RUNS))
def test_a_recovered_service_is_re_armed_alike(run, tmp_path):
    """``restore_scheduler_state`` gives both packages' fresh services the
    same rotation and attempt counters, queue states, clocks and event
    sequence; their next round leaves the same pods."""
    RUNS[run](PACKAGES[0], str(tmp_path / "j"))
    out = []
    for pkg in PACKAGES:
        work = tmp_path / pkg
        shutil.copytree(tmp_path / "j", work)
        s, report = recover(pkg, str(work))
        svc = service_of(pkg, s, use_batch="off" if run == "sequential" else "force")
        svc.start_scheduler(report.scheduler_config)
        mod(pkg, "state.recovery").restore_scheduler_state(svc, report)
        state = ({n: [fw.sched_counter, fw.next_start_node_index] for n, fw in svc.frameworks.items()},
                 svc.queue.state_snapshot(), svc._event_seq, svc._clock.now, s._clock.now)
        s.create("pods", pod("after", "100m"))
        svc.schedule_pending(max_rounds=1)
        out.append((state, {p["metadata"]["name"]: ((p.get("spec") or {}).get("nodeName"),
                                                    p["metadata"].get("annotations"))
                            for p in s.list("pods")}))
    assert out[0] == out[1]


def test_partial_gang_scans_agree():
    out = []
    for pkg in PACKAGES:
        s = store_of(pkg)
        s.create("namespaces", {"metadata": {"name": "default"}})
        for g, n in (("g1", 3), ("g2", 2)):
            s.create("podgroups", {"metadata": {"name": g}, "spec": {"minMember": n}})
            for m in range(n):
                s.create("pods", {"metadata": {"name": f"{g}-{m}", "labels": {"pod-group.scheduling.sigs.k8s.io": g}},
                                  "spec": {"nodeName": "n0"} if (g == "g1" and m == 0) else {}})
        mgr = mod(pkg, "state.recovery").RecoveryManager("unused")
        first = mgr.scan_partial_gangs(s)
        s.patch("pods", "g1-1", {"spec": {"nodeName": "n0"}}, "default")
        s.patch("pods", "g1-2", {"spec": {"nodeName": "n0"}}, "default")
        out.append((first, mgr.scan_partial_gangs(s)))
    assert out[0] == out[1] == (1, 0)


# ---------------------------------------------------------- crash and resume

SPEC = dict(jobs=12, min_members=2, max_members=6, nodes=12, waves=5, seed=23)
KILL_WAVE = 3

CHILD = """
import sys
sys.path.insert(0, {root!r})
from kube_scheduler_simulator_tpu_torch import workloads
from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService
from kube_scheduler_simulator_tpu_torch.state.journal import Journal
from kube_scheduler_simulator_tpu_torch.state.recovery import build_checkpoint, scheduler_meta_provider, write_mark
from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock
spec = {spec!r}
store = ClusterStore(clock=SimClock({clock!r}))
svc = SchedulerService(store, tie_break="first", clock=SimClock({clock!r}), use_batch="force", device="cpu")
j = Journal({d!r}, kill_at={kill_at!r})
store.attach_journal(j)
j.add_meta_provider(scheduler_meta_provider(svc))
snap = SnapshotService(store, svc)
j.checkpoint_provider = lambda: build_checkpoint(store, snap)
plan = workloads.gang_setup(store, **{{k: v for k, v in spec.items() if k != "waves"}})
svc.start_scheduler(gang_scheduler_config())
for w in range(spec["waves"]):
    workloads.gang_wave(store, plan, spec["waves"], w)
    svc.schedule_pending(max_rounds=3)
    write_mark(svc, w)
sys.exit(3)
"""


def gang_waves(pkg: str, store, svc, plan, first: int = 0, resume: bool = False) -> None:
    for w in range(first, SPEC["waves"]):
        workloads.gang_wave(store, plan, SPEC["waves"], w, resume=resume and w == first)
        svc.schedule_pending(max_rounds=3)
        mod(pkg, "state.recovery").write_mark(svc, w)
        assert not mod(pkg, "gang").partially_bound_groups(store)


def uninterrupted(pkg: str, d: "str | None"):
    s = store_of(pkg)
    svc = service_of(pkg, s, use_batch="force")
    if d is not None:
        attach(pkg, s, svc, d)
    plan = workloads.gang_setup(s, **{k: v for k, v in SPEC.items() if k != "waves"})
    svc.start_scheduler(mod(pkg, "gang").gang_scheduler_config())
    gang_waves(pkg, s, svc, plan)
    return s, plan


def test_a_killed_journaled_service_recovers_and_promotes_to_the_uninterrupted_run(tmp_path):
    T = PACKAGES[1]
    J = mod(T, "state.journal")
    parity = mod(T, "utils.parity").parity_digest
    # the uninterrupted run, journaled: the target digest and the record
    # index one past wave 4's first gang-release record
    s0, plan = uninterrupted(T, str(tmp_path / "base"))
    target = parity(s0)
    recs = [r for _i, p in J.list_segments(str(tmp_path / "base")) for _o, r in J.read_records(p)]
    m = next(i for i, r in enumerate(recs) if r["t"] == "mark" and r["x"]["tick"] == KILL_WAVE - 1)
    release = next(i for i in range(m, len(recs)) if recs[i]["t"] == "gang-release")
    kill_at = release + 2  # 1-based: the record after that release
    assert recs[kill_at - 1]["t"] != "mark"
    # the JAX package's service on the same workload ends the same
    ref, _ = uninterrupted(PACKAGES[0], None)
    assert parity(ref) == target

    d = tmp_path / "crash"
    d.mkdir()
    child = subprocess.Popen([sys.executable, "-c", CHILD.format(
        root=str(ROOT), spec=SPEC, clock=CLOCK, d=str(d), kill_at=kill_at)], cwd=str(ROOT))
    rstore = store_of(T)
    applier = mod(T, "replication").ReplicaApplier(rstore, str(d), notify=False)
    applier.bootstrap()
    while child.poll() is None:
        applier.step()
        time.sleep(0.01)
    assert child.returncode == -9, "the kill inside wave 4 did not fire"
    # the crashed journal is the uninterrupted one's first kill_at records
    crashed = [r for _i, p in J.list_segments(str(d)) for _o, r in J.read_records(p)]
    assert len(crashed) == kill_at and crashed == recs[:kill_at]

    # (a) boot recovery, a fresh service, a new epoch, the resume
    s, report = recover(T, str(d))
    svc = service_of(T, s, use_batch="force")
    j = attach(T, s, svc, str(tmp_path / "epoch-a"))
    svc.start_scheduler(report.scheduler_config)
    mod(T, "state.recovery").restore_scheduler_state(svc, report)
    j.last_mark = report.last_mark
    s.journal_append("boot", {"recovered": True})
    assert report.partial_gangs == 0 and report.last_mark["tick"] == KILL_WAVE - 1
    gang_waves(T, s, svc, plan, first=KILL_WAVE, resume=True)
    assert parity(s) == target

    # (b) the live replica promoted, resumed the same way
    promotion = mod(T, "replication").promote_replica(applier, lambda st: service_of(T, st, use_batch="force"))
    assert promotion.stats()["records_shipped"] == kill_at and promotion.recovery.partial_gangs == 0
    jb = attach(T, rstore, promotion.service, str(d))
    jb.last_mark = promotion.recovery.last_mark
    rstore.journal_append("boot", {"promoted": True})
    gang_waves(T, rstore, promotion.service, plan, first=KILL_WAVE, resume=True)
    assert parity(rstore) == target
