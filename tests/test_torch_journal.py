"""The port's write-ahead journal (state/journal.py) against the JAX
package's: the same operations through both packages leave byte-equal
segment and checkpoint files, the same stats, the same wedge and degrade
outcomes under a seeded disk fault, and the same knob validation."""

from __future__ import annotations

import errno
import importlib
import os
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PACKAGES = ("kube_scheduler_simulator_tpu", "kube_scheduler_simulator_tpu_torch")
CLOCK = 1_700_000_000.0


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
        store, tie_break="first", clock=mod(pkg, "utils.simclock").SimClock(0.0), **kw, **extra)


class FaultyIO:
    """The journal's IO seam with one seeded fault: the ``fail_at``-th
    (0-based) call of ``op`` raises ``err``."""

    def __init__(self, fail_at: int, op: str, err: int):
        self.fail_at, self.op, self.err, self.calls = fail_at, op, err, {"write": 0, "flush": 0, "fsync": 0}

    def _tick(self, op: str) -> None:
        n = self.calls[op]
        self.calls[op] += 1
        if op == self.op and n == self.fail_at:
            raise OSError(self.err, os.strerror(self.err))

    def write(self, f, data: bytes) -> None:
        self._tick("write")
        f.write(data)

    def flush(self, f) -> None:
        self._tick("flush")
        f.flush()

    def fsync(self, fd: int) -> None:
        self._tick("fsync")
        os.fsync(fd)


def node(name: str, cpu: str = "8") -> dict:
    return {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "status": {"allocatable": {"cpu": cpu, "memory": "16Gi", "pods": "110"},
                       "capacity": {"cpu": cpu, "memory": "16Gi", "pods": "110"}}}


def pod(name: str, cpu: str = "100m") -> dict:
    return {"metadata": {"name": name},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]}}


# ------------------------------------------------------------------ scenarios
# each drives one package's modules in a fresh directory and returns the
# journal (or None when it closed its own)


def sc_single_mutations(pkg, d):
    s = store_of(pkg)
    j = mod(pkg, "state.journal").Journal(d)
    s.attach_journal(j)
    s.create("namespaces", {"metadata": {"name": "default"}})
    s.create("pods", {"metadata": {"name": "p"}, "spec": {}})
    s.delete("pods", "p", "default")
    return j


def sc_nested_txn(pkg, d):
    s = store_of(pkg)
    j = mod(pkg, "state.journal").Journal(d)
    s.attach_journal(j)
    s.create("namespaces", {"metadata": {"name": "default"}})
    s.create("nodes", {"metadata": {"name": "n"}})
    s.create("pods", {"metadata": {"name": "p"}, "spec": {}})
    with s.journal_txn("wave"):
        s.bind_pod("default", "p", "n")
        with s.journal_txn("inner"):
            s.patch("pods", "p", {"metadata": {"annotations": {"a": "1", "b": "{\"x\":[1,2]}"}}}, "default")
    with s.journal_txn("empty"):
        pass
    return j


def sc_bulk_update(pkg, d):
    s = store_of(pkg)
    j = mod(pkg, "state.journal").Journal(d)
    s.attach_journal(j)
    s.create("namespaces", {"metadata": {"name": "default"}})
    for i in range(3):
        s.create("pods", {"metadata": {"name": f"p{i}"}, "spec": {}})
    s.bulk_update("pods", [(f"p{i}", "default", lambda cur: {
        **cur, "metadata": dict(cur["metadata"]), "spec": {**cur["spec"], "nodeName": "n"}}) for i in range(3)])
    return j


def sc_compaction(pkg, d):
    s = store_of(pkg)
    j = mod(pkg, "state.journal").Journal(d, checkpoint_every=4)
    s.attach_journal(j)
    j.checkpoint_provider = lambda: mod(pkg, "state.recovery").build_checkpoint(s)
    s.create("namespaces", {"metadata": {"name": "default"}})
    for i in range(9):
        s.create("pods", {"metadata": {"name": f"p{i}"}, "spec": {}})
    j.append("mark", extra={"tick": 3})
    j.close()
    return j


def sc_raw_records_and_fsync(pkg, d):
    j = mod(pkg, "state.journal").Journal(d, fsync=True)
    j.append("event", events=[["pods", "ADDED", {"metadata": {"name": "a", "resourceVersion": "1"}}]])
    j.append("mark", extra={"tick": 3, "label": "tick", "weights": None})
    j.append("config", extra={"config": {"profiles": [{"schedulerName": "default-scheduler"}]}})
    j.close()
    return j


def sc_service_sequential(pkg, d):
    """The boot wiring (meta provider, snapshot checkpoint), the config
    record, sequential attempts, marks and a manual compaction."""
    R = mod(pkg, "state.recovery")
    s = store_of(pkg)
    svc = service_of(pkg, s, use_batch="off")
    j = mod(pkg, "state.journal").Journal(d)
    s.attach_journal(j)
    j.add_meta_provider(R.scheduler_meta_provider(svc))
    snap = mod(pkg, "services.snapshot").SnapshotService(s, svc)
    j.checkpoint_provider = lambda: R.build_checkpoint(s, snap)
    s.create("namespaces", {"metadata": {"name": "default"}})
    svc.start_scheduler(None)
    for i in range(2):
        s.create("nodes", node(f"n{i}", cpu="1"))
    for i in range(5):
        s.create("pods", pod(f"p{i}", cpu="400m"))
    svc.schedule_pending(max_rounds=2)
    R.write_mark(svc, 0)
    j.compact()
    s.create("pods", pod("late"))
    svc.schedule_pending(max_rounds=1)
    R.write_mark(svc, 1, label="end")
    return j


def sc_service_batch_wave(pkg, d):
    """A batch round's commit wave: one atomic record."""
    R = mod(pkg, "state.recovery")
    s = store_of(pkg)
    svc = service_of(pkg, s, use_batch="auto", batch_min_work=0)
    j = mod(pkg, "state.journal").Journal(d)
    s.attach_journal(j)
    j.add_meta_provider(R.scheduler_meta_provider(svc))
    s.create("namespaces", {"metadata": {"name": "default"}})
    svc.start_scheduler(None)
    s.create("nodes", node("wn"))
    for i in range(4):
        s.create("pods", pod(f"wp{i}"))
    svc.schedule_pending(max_rounds=2)
    assert svc.stats["batch_commits"] >= 1, svc.stats["batch_fallbacks"]
    R.write_mark(svc, 0)
    return j


def sc_gang_release(pkg, d):
    """The gang profile on the batch round: each release one record."""
    from kube_scheduler_simulator_tpu_torch import workloads

    R = mod(pkg, "state.recovery")
    s = store_of(pkg)
    svc = service_of(pkg, s, use_batch="force")
    j = mod(pkg, "state.journal").Journal(d)
    s.attach_journal(j)
    j.add_meta_provider(R.scheduler_meta_provider(svc))
    plan = workloads.gang_setup(s, jobs=4, min_members=2, max_members=3, nodes=3, seed=5)
    svc.start_scheduler(mod(pkg, "gang").gang_scheduler_config())
    for w in range(2):
        workloads.gang_wave(s, plan, 2, w)
        svc.schedule_pending(max_rounds=3)
        R.write_mark(svc, w)
    return j


def _fault(on_error: str, op: str, fail_at: int, err: int):
    def sc(pkg, d):
        J = mod(pkg, "state.journal")
        s = store_of(pkg)
        j = J.Journal(d, fsync=op == "fsync", on_error=on_error, io=FaultyIO(fail_at, op, err))
        s.attach_journal(j)
        outcome = []
        for i, obj in enumerate([{"metadata": {"name": "default"}}] + [{"metadata": {"name": f"p{i}"}, "spec": {}}
                                                                       for i in range(4)]):
            kind = "namespaces" if i == 0 else "pods"
            try:
                with s.journal_txn("attempt"):
                    s.create(kind, obj)
                outcome.append("ok")
            except J.JournalWedged:
                outcome.append("wedged")
        j.outcome = (outcome, j.wedged, j.degraded_errno, dict(j.degraded_by_errno), s.count("pods"))
        return j

    return sc


SCENARIOS = {
    "single mutations": sc_single_mutations,
    "nested txn": sc_nested_txn,
    "bulk update": sc_bulk_update,
    "compaction": sc_compaction,
    "raw records, fsync, seal": sc_raw_records_and_fsync,
    "service, sequential, marks, checkpoint": sc_service_sequential,
    "service, batch commit wave": sc_service_batch_wave,
    "gang releases": sc_gang_release,
    "wedge on ENOSPC": _fault("wedge", "write", 2, errno.ENOSPC),
    "degrade on EIO": _fault("degrade", "write", 2, errno.EIO),
    "degrade on an fsync EROFS": _fault("degrade", "fsync", 1, errno.EROFS),
    "wedge on a flush EIO": _fault("wedge", "flush", 3, errno.EIO),
}


def files_of(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_the_same_operations_leave_byte_equal_journals(name, tmp_path):
    out = []
    for pkg in PACKAGES:
        d = tmp_path / pkg
        j = SCENARIOS[name](pkg, str(d))
        out.append((files_of(d), dict(j.stats), getattr(j, "outcome", None)))
    (ref_files, ref_stats, ref_out), (port_files, port_stats, port_out) = out
    assert list(port_files) == list(ref_files)
    for fn in ref_files:
        assert port_files[fn] == ref_files[fn], fn
    assert port_stats == ref_stats and port_out == ref_out
    assert any(b for b in ref_files.values())


def test_the_port_journal_frames_what_the_store_holds(tmp_path):
    """Objects are written in the store's insertion order (not sorted):
    a recovered pod's annotations and conditions keep the live bytes."""
    J = mod(PACKAGES[1], "state.journal")
    s = store_of(PACKAGES[1])
    s.attach_journal(J.Journal(str(tmp_path)))
    s.create("namespaces", {"metadata": {"name": "default"}})
    s.create("pods", {"metadata": {"name": "p", "annotations": {"z": "1", "a": "2"}},
                      "spec": {}, "status": {"conditions": [{"type": "B"}, {"type": "A"}]}})
    recs = [r for _i, p in J.list_segments(str(tmp_path)) for _o, r in J.read_records(p)]
    obj = recs[-1]["events"][0][2]
    assert list(obj["metadata"]["annotations"]) == ["z", "a"]
    assert obj["status"]["conditions"] == [{"type": "B"}, {"type": "A"}]
    assert obj == s.get("pods", "p")


@pytest.mark.parametrize("damage", ["torn tail", "crc flip", "bad magic", "oversized length"])
def test_readers_classify_damage_alike(damage, tmp_path):
    RJ, TJ = (mod(pkg, "state.journal") for pkg in PACKAGES)
    j = TJ.Journal(str(tmp_path))
    j.append("event", events=[["pods", "ADDED", {"metadata": {"name": "a", "resourceVersion": "1"}}]])
    j.append("mark", extra={"tick": 1})
    j.close()
    seg = TJ.list_segments(str(tmp_path))[0][1]
    data = bytearray(open(seg, "rb").read())
    if damage == "torn tail":
        data += TJ._HEADER.pack(999, 0) + b"short"
    elif damage == "crc flip":
        data[-3] ^= 0x10
    elif damage == "bad magic":
        data[0] ^= 0xFF
    else:
        data += TJ._HEADER.pack(TJ._MAX_RECORD + 1, 0)
    open(seg, "wb").write(bytes(data))
    got, want = list(TJ.read_records(seg)), list(RJ.read_records(seg))
    assert got == want and got[-1][1] is None


ENVS = [
    {},
    {"KSS_JOURNAL_DIR": "{d}"},
    {"KSS_JOURNAL_DIR": "{d}", "KSS_JOURNAL_FSYNC": "1", "KSS_CHECKPOINT_EVERY": "128"},
    {"KSS_JOURNAL_DIR": "{d}", "KSS_JOURNAL_ON_ERROR": "degrade", "KSS_JOURNAL_FSYNC": "off"},
    {"KSS_JOURNAL_DIR": "{d}", "KSS_JOURNAL_ON_ERROR": "ignore"},
    {"KSS_JOURNAL_DIR": "{d}", "KSS_CHECKPOINT_EVERY": "nope"},
    {"KSS_JOURNAL_DIR": "{d}", "KSS_CHECKPOINT_EVERY": "-1"},
]


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "unset")
def test_journal_knobs_are_read_alike(env, monkeypatch, tmp_path):
    for k in ("KSS_JOURNAL_DIR", "KSS_JOURNAL_FSYNC", "KSS_CHECKPOINT_EVERY", "KSS_JOURNAL_ON_ERROR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v.format(d=tmp_path / "j"))
    answers = []
    for pkg in PACKAGES:
        J = mod(pkg, "state.journal")
        got = []
        for fn in (J.journal_knobs, J.on_error_from_env, J.journal_from_env):
            try:
                v = fn()
                if isinstance(v, J.Journal):
                    v.close()
                    v = (v.directory, v.fsync, v.checkpoint_every, v.on_error)
                got.append(("value", v))
            except J.JournalError as e:
                got.append(("error", str(e)))
        answers.append(got)
    assert answers[0] == answers[1]


def test_errno_labels_are_alike():
    RJ, TJ = (mod(pkg, "state.journal") for pkg in PACKAGES)
    for e in (OSError(errno.ENOSPC, "x"), OSError(errno.EIO, "x"), OSError(errno.EROFS, "x"),
              OSError(errno.EACCES, "x"), OSError("no errno")):
        assert TJ.classify_errno(e) == RJ.classify_errno(e)


def test_a_wedged_journal_refuses_at_transaction_entry(tmp_path):
    J = mod(PACKAGES[1], "state.journal")
    s = store_of(PACKAGES[1])
    j = J.Journal(str(tmp_path), on_error="wedge", io=FaultyIO(2, "write", errno.ENOSPC))
    s.attach_journal(j)
    s.create("namespaces", {"metadata": {"name": "default"}})
    s.create("pods", {"metadata": {"name": "p0"}, "spec": {}})
    with pytest.raises(J.JournalWedged):
        s.create("pods", {"metadata": {"name": "p1"}, "spec": {}})
    before = s.dump()
    with pytest.raises(J.JournalWedged):
        with s.journal_txn("wave"):
            s.create("pods", {"metadata": {"name": "p2"}, "spec": {}})
    assert s.dump() == before and j.stats["wedges"] == 1


def test_service_metrics_read_the_attached_journal(tmp_path):
    """``metrics()`` reports the journal's counters and the store's last
    recovery, as the reference's does; zeros with no journal."""
    pkg = PACKAGES[1]
    s = store_of(pkg)
    svc = service_of(pkg, s, use_batch="off")
    svc.start_scheduler(None)
    m = svc.metrics()
    assert (m["journal_enabled"], m["journal_records_total"], m["checkpoint_compactions_total"]) == (0, 0, 0)
    j = mod(pkg, "state.journal").Journal(str(tmp_path), checkpoint_every=2)
    s.attach_journal(j)
    j.checkpoint_provider = lambda: mod(pkg, "state.recovery").build_checkpoint(s)
    svc.restart_scheduler(None)  # a config record
    s.create("namespaces", {"metadata": {"name": "default"}})
    s.create("pods", {"metadata": {"name": "p"}, "spec": {}})
    m = svc.metrics()
    assert m["journal_enabled"] == 1 and m["journal_records_total"] == j.stats["records"] == 3
    assert m["journal_bytes_written_total"] == j.stats["bytes"] and m["checkpoint_compactions_total"] == 1
    assert m["journal_degraded_by_errno"] == {} and m["recovery_replayed_records_total"] == 0
    s2 = store_of(pkg)
    mod(pkg, "state.recovery").boot_recover(str(tmp_path), s2)
    svc2 = service_of(pkg, s2, use_batch="off")
    svc2.start_scheduler(None)
    m2 = svc2.metrics()
    assert m2["journal_enabled"] == 0 and m2["recovery_partial_gangs_total"] == 0
    assert m2["recovery_replayed_records_total"] == s2.recovery_stats["replayed_records"]
