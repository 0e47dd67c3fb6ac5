"""The port's replication/ against the JAX package's: the journal tailer
classifies every read alike (open tail, torn, seal, crash boundary, read
faults), each package's applier follows the other's live journal to a
byte-equal store, promotion re-arms the same scheduler state, and the
replica container serves read-only until it promotes."""

from __future__ import annotations

import errno
import importlib
import os
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import retry_tables  # noqa: E402

PACKAGES = ("kube_scheduler_simulator_tpu", "kube_scheduler_simulator_tpu_torch")
CLOCK = 1_700_000_000.0


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(autouse=True)
def _retry_tables_as_found():
    """A follower's read fault counts a retry at the replication seam in each
    package's process-wide table (``resilience.retry_stats``): each test
    leaves both tables as it found them."""
    with retry_tables(empty=False):
        yield


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def store_of(pkg: str):
    return mod(pkg, "state.store").ClusterStore(clock=mod(pkg, "utils.simclock").SimClock(CLOCK))


def journaled(pkg: str, d: str, **kw):
    s = store_of(pkg)
    j = mod(pkg, "state.journal").Journal(d, **kw)
    s.attach_journal(j)
    j.checkpoint_provider = lambda: mod(pkg, "state.recovery").build_checkpoint(s)
    return s, j


def pod(name: str) -> dict:
    return {"metadata": {"name": name}, "spec": {}}


def both(fn, tmp_path):
    """``fn(pkg, directory)`` for each package in a fresh directory; asserts
    the two answers equal and returns the port's."""
    out = [fn(pkg, str(tmp_path / pkg)) for pkg in PACKAGES]
    assert out[0] == out[1]
    return out[1]


def test_a_truncated_frame_reads_as_an_open_tail_at_every_offset(tmp_path):
    def fn(pkg, d):
        s, _j = journaled(pkg, d)
        s.create("namespaces", {"metadata": {"name": "default"}})
        s.create("pods", pod("t0"))
        seg = mod(pkg, "state.journal").list_segments(d)[-1][1]
        blob = open(seg, "rb").read()
        first = len(blob) - 1
        while first > 8 and blob[first - 1:first] != b"}":
            first -= 1
        seen = []
        for cut in range(first, len(blob)):
            with open(seg, "wb") as f:
                f.write(blob[:cut])
            t = mod(pkg, "replication").JournalTailer(d)
            seen.append(([p.get("t") for p in t.poll()], dict(t.stats), os.path.getsize(seg)))
        with open(seg, "wb") as f:
            f.write(blob)
        return seen

    seen = both(fn, tmp_path)
    assert all(st["torn_records"] == 0 for _t, st, _n in seen)


def test_full_length_corruption_reads_as_torn_once(tmp_path):
    def fn(pkg, d):
        s, _j = journaled(pkg, d)
        s.create("namespaces", {"metadata": {"name": "default"}})
        s.create("pods", pod("c0"))
        s.create("pods", pod("c1"))
        seg = mod(pkg, "state.journal").list_segments(d)[-1][1]
        blob = bytearray(open(seg, "rb").read())
        blob[-3] ^= 0xFF
        open(seg, "wb").write(bytes(blob))
        t = mod(pkg, "replication").JournalTailer(d)
        got = [len(t.poll()) for _ in range(3)]
        return got, dict(t.stats), os.path.getsize(seg) == len(blob)

    got, stats, untouched = both(fn, tmp_path)
    assert got == [2, 0, 0] and stats["torn_records"] == 1 and untouched


def test_the_tailer_follows_a_seal_and_a_crash_boundary(tmp_path):
    def fn(pkg, d):
        J = mod(pkg, "state.journal")
        s, j = journaled(pkg, d)
        s.create("namespaces", {"metadata": {"name": "default"}})
        t = mod(pkg, "replication").JournalTailer(d)
        s.create("pods", pod("r0"))
        a = [p.get("t") for p in t.poll()]
        j.close()  # seals segment 1
        j2 = J.Journal(d)
        s.attach_journal(j2)
        j2.checkpoint_provider = lambda: mod(pkg, "state.recovery").build_checkpoint(s)
        s.create("pods", pod("r1"))
        b = [p.get("t") for p in t.poll()]
        seg = J.list_segments(d)[-1][1]
        blob = open(seg, "rb").read()
        j2.compact()  # checkpoint 3 + segment 3, segment 2 pruned
        s.create("pods", pod("post"))
        open(seg, "wb").write(blob)  # what a tailer racing the prune sees
        racing = mod(pkg, "replication").JournalTailer(d)
        c = [p.get("t") for p in racing.poll()]
        return a, b, dict(t.stats), c, dict(racing.stats)

    a, b, st, c, st2 = both(fn, tmp_path)
    assert b == ["event"] and st["seals"] == 1 and st["torn_records"] == 0
    assert "checkpoint" in c and st2["checkpoints_crossed"] == 1 and st2["torn_records"] == 0


@pytest.mark.parametrize("writer", PACKAGES, ids=["JAX primary", "port primary"])
@pytest.mark.parametrize("follower", PACKAGES, ids=["JAX follower", "port follower"])
def test_an_applier_follows_a_live_journal_to_a_byte_equal_store(writer, follower, tmp_path):
    d = str(tmp_path / "j")
    s, j = journaled(writer, d)
    replica = store_of(follower)
    applier = mod(follower, "replication").ReplicaApplier(replica, d, notify=True)
    seen = []
    replica.subscribe(["pods"], lambda ev: seen.append((ev.type, ev.obj["metadata"]["name"])))
    applier.bootstrap()
    s.create("namespaces", {"metadata": {"name": "default"}})
    applier.step()
    for i in range(6):
        with s.journal_txn("wave"):
            s.create("pods", pod(f"ap{i}"))
            if i >= 2:
                s.delete("pods", f"ap{i - 2}")
        applier.step()
        assert applier.stats["lag_records"] == 0
        if i == 3:
            old_rv = replica.resource_version
            j.compact()  # the follower's segment pruned: a rebase
    s.create("pods", pod("late"))
    applier.step()
    assert replica.dump() == s.dump() and replica.resource_version == s.resource_version
    assert applier.stats["rebases"] == 1 and applier.report.truncated_records == 0
    assert ("ADDED", "ap0") in seen and ("DELETED", "ap0") in seen
    with pytest.raises(mod(follower, "state.store").ResourceExpiredError):
        replica.events_since("pods", old_rv - 1)


def _primary(pkg: str, d: str):
    R = mod(pkg, "state.recovery")
    s = store_of(pkg)
    extra = {"device": "cpu"} if pkg.endswith("_torch") else {}
    svc = mod(pkg, "scheduler.service").SchedulerService(
        s, use_batch="off", tie_break="first", clock=mod(pkg, "utils.simclock").SimClock(0.0), **extra)
    j = mod(pkg, "state.journal").Journal(d)
    s.attach_journal(j)
    j.add_meta_provider(R.scheduler_meta_provider(svc))
    j.checkpoint_provider = lambda: R.build_checkpoint(s)
    s.create("namespaces", {"metadata": {"name": "default"}})
    svc.start_scheduler(None)
    s.create("nodes", {"metadata": {"name": "fn"}, "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                                                            "pods": "10"}}})
    for i in range(3):
        s.create("pods", {"metadata": {"name": f"fp{i}"},
                          "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "1500m"}}}]}})
    svc.schedule_pending(max_rounds=2)
    svc._clock.advance(3.0)
    R.write_mark(svc, 4)
    return s, svc, j


@pytest.mark.parametrize("writer", PACKAGES, ids=["JAX primary", "port primary"])
def test_promotion_re_arms_the_same_scheduler_state(writer, tmp_path):
    d = str(tmp_path / "j")
    s, svc, j = _primary(writer, d)
    out = []
    for pkg in PACKAGES:
        replica = store_of(pkg)
        applier = mod(pkg, "replication").ReplicaApplier(replica, d, notify=True)
        applier.bootstrap()
        applier.step()
        extra = {"device": "cpu"} if pkg.endswith("_torch") else {}
        promotion = mod(pkg, "replication").promote_replica(
            applier, lambda st: mod(pkg, "scheduler.service").SchedulerService(
                st, use_batch="off", tie_break="first", clock=mod(pkg, "utils.simclock").SimClock(0.0), **extra))
        svc2 = promotion.service
        assert replica.dump() == s.dump()
        out.append((promotion.stats(), svc2.framework.sched_counter, svc2.framework.next_start_node_index,
                    svc2._clock.now, svc2.queue.state_snapshot(), promotion.recovery.last_mark,
                    applier.stats["promotions"], replica.recovery_stats))
    assert out[0] == out[1]
    assert out[1][3] == 3.0 and out[1][5]["tick"] == 4


ENVS = [{}, {"KSS_REPLICA_OF": "/tmp/j", "KSS_REPLICA_POLL_S": "0.2"}, {"KSS_REPLICA_OF": "/tmp/j"},
        {"KSS_REPLICA_OF": "/tmp/j", "KSS_REPLICA_POLL_S": "nope"},
        {"KSS_REPLICA_OF": "/tmp/j", "KSS_REPLICA_POLL_S": "0"}]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "unset")
def test_replica_knobs_are_read_alike(env, monkeypatch):
    for k in ("KSS_REPLICA_OF", "KSS_REPLICA_POLL_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    answers = []
    for pkg in PACKAGES:
        try:
            answers.append(("value", mod(pkg, "replication").replica_knobs()))
        except ValueError as e:
            answers.append(("error", str(e)))
    assert answers[0] == answers[1]


def test_read_faults_are_classified_and_backed_off_alike(tmp_path):
    def fn(pkg, d):
        s, _j = journaled(pkg, d)
        s.create("namespaces", {"metadata": {"name": "default"}})
        s.create("pods", pod("bp0"))
        missing = mod(pkg, "replication").JournalTailer(d + "-not-yet")
        enoent = (missing.poll(), dict(missing.stats))
        replica = store_of(pkg)
        applier = mod(pkg, "replication").ReplicaApplier(replica, d, notify=False)
        real = applier.tailer.io_open

        def denied(*a, **k):
            raise PermissionError(errno.EACCES, "Permission denied")

        applier.tailer.io_open = denied
        trail = [applier.step(), applier.stats["backoffs"], applier._error_streak]
        trail += [applier.step(), applier.stats["backoffs"], applier.tailer.stats["read_errors"]]
        applier.tailer.io_open = real
        applier._backoff_until = 0.0
        trail += [applier.step(), applier._error_streak, replica.count("pods"),
                  dict(applier.stats["read_errors_by_errno"])]
        return enoent, trail

    enoent, trail = both(fn, tmp_path)
    assert enoent[0] == [] and enoent[1]["read_errors"] == 0
    assert trail[1] == 1 and trail[-1] == {"EACCES": 1}


def test_the_replica_container_serves_read_only_then_promotes(tmp_path):
    """The port's ReplicaContainer on the CPU: the replica store follows
    the primary, the scheduler routes read a detached facade started with
    the journaled configuration, and promotion builds the real service
    over the replica store, journaling into the same directory."""
    from kube_scheduler_simulator_tpu_torch.replication import ReplicaContainer
    from kube_scheduler_simulator_tpu_torch.state.journal import list_segments, read_records

    d = str(tmp_path / "j")
    s, svc, j = _primary(PACKAGES[1], d)
    j.close()
    di = ReplicaContainer(d, poll_s=0.01, device="cpu")
    try:
        assert di.read_only and di.cluster_store.dump() == s.dump()
        facade = di.scheduler_service()
        assert facade.cluster_store is not di.cluster_store and facade.use_batch == "off"
        assert di.extender_service() is facade.extender_service and di.extender_service().extenders == []
        di.note_replica_read()
        status = di.replication_status()
        assert status["role"] == "replica" and status["readRequests"] == 1 and status["recordsShipped"] > 0
        di.start_following()
        report = di.promote()
        assert di.promote() is report and not di.read_only
        assert di.scheduler_service() is report.service and report.service.cluster_store is di.cluster_store
        assert di.replication_status()["role"] == "primary" and report.stats()["partial_gangs"] == 0
        di.cluster_store.create("pods", pod("accepted"))
        assert di.tpu_scorer_bridge().scheduler_service is report.service
    finally:
        di.close()
    recs = [r for _i, p in list_segments(d) for _o, r in read_records(p)]
    assert [r["t"] for r in recs if r["t"] in ("boot", "seal")][-2:] == ["boot", "seal"]
    assert recs[-2]["events"][0][2]["metadata"]["name"] == "accepted"
