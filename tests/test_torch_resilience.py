"""The port's resilience/ against the JAX package's: Deadline, the seeded
RetryPolicy, the counted Breaker and the per-seam retry counter give the
same numbers and the same transitions in both packages."""

from __future__ import annotations

import pytest

from kube_scheduler_simulator_tpu import resilience as R
from kube_scheduler_simulator_tpu_torch import resilience as T


class _Clock:
    """A hand-advanced monotonic clock: time never passes on its own."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


POLICIES = [
    {},
    {"base_s": 0.05, "factor": 2.0, "max_s": 2.0, "jitter": 0.25, "attempts": 8},
    {"base_s": 0.1, "factor": 3.0, "max_s": 5.0, "jitter": 0.5, "attempts": 12},
    {"base_s": 0.1, "factor": 2.0, "max_s": 1.0, "jitter": 0.0, "attempts": 6},
]


@pytest.mark.parametrize("seed", [0, 1, 7, 17, 2**31 - 1])
@pytest.mark.parametrize("kw", POLICIES, ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "defaults")
def test_retry_schedules_are_equal_for_each_seed(seed, kw):
    a, b = R.RetryPolicy(seed=seed, **kw), T.RetryPolicy(seed=seed, **kw)
    assert a.schedule() == b.schedule()
    assert [a.delay(k) for k in (0, 3, 40)] == [b.delay(k) for k in (0, 3, 40)]
    assert [a.exhausted(k) for k in range(15)] == [b.exhausted(k) for k in range(15)]


@pytest.mark.parametrize("kw", [{"base_s": 0.0}, {"factor": 0.5}, {"max_s": 0.0}, {"jitter": 1.0}, {"jitter": -0.1}])
def test_retry_policies_refuse_the_same_parameters(kw):
    with pytest.raises(ValueError) as ra:
        R.RetryPolicy(seed=0, **kw)
    with pytest.raises(ValueError) as tb:
        T.RetryPolicy(seed=0, **kw)
    assert str(ra.value) == str(tb.value)


@pytest.mark.parametrize("raw", ["", "17", "-3", "seventeen"])
def test_retry_seed_env_knob_is_read_alike(monkeypatch, raw):
    monkeypatch.setenv("KSS_RETRY_SEED", raw)
    if raw == "seventeen":
        for mod in (R, T):
            with pytest.raises(ValueError, match="KSS_RETRY_SEED"):
                mod.retry_seed_from_env()
        return
    assert R.retry_seed_from_env() == T.retry_seed_from_env()
    # seed=None policies take the env seed at construction
    assert R.RetryPolicy().schedule() == T.RetryPolicy().schedule()


def test_deadlines_slice_alike():
    ca, cb = _Clock(), _Clock()
    a, b = R.Deadline(10.0, clock=ca), T.Deadline(10.0, clock=cb)
    for step in (0.0, 3.0, 5.0, 1.5, 4.0):
        ca.t += step
        cb.t += step
        assert (a.elapsed(), a.remaining(), a.expired(), a.slice(3.0)) == (
            b.elapsed(), b.remaining(), b.expired(), b.slice(3.0))


# each step: "f" failure, "s" success, "a" allow() (its answer recorded),
# "+N" the clock advanced N seconds
BREAKER_RUNS = [
    (dict(fail_threshold=3), "f f s f f a f a a s a"),
    (dict(fail_threshold=2, cooldown_s=None), "f f a +100 a s a"),
    (dict(fail_threshold=2, cooldown_s=5.0), "f f a +4 a +2 a a f a +5 a s a f"),
    (dict(fail_threshold=1, cooldown_s=1.0), "f a +1 a s f +1 a a f +1 a s a"),
]


@pytest.mark.parametrize("kw,run", BREAKER_RUNS)
def test_breakers_make_the_same_transitions(kw, run):
    out = []
    for mod in (R, T):
        clk = _Clock()
        br = mod.Breaker(clock=clk, **kw)
        trail = []
        for step in run.split():
            if step == "f":
                br.failure()
            elif step == "s":
                br.success()
            elif step == "a":
                trail.append(br.allow())
            else:
                clk.t += float(step)
            trail.append((br.state, br.state_code))
        out.append((trail, dict(br.stats)))
    assert out[0] == out[1]


def test_breaker_validation_is_alike():
    for mod in (R, T):
        with pytest.raises(ValueError, match="fail_threshold"):
            mod.Breaker(fail_threshold=0)


def test_retry_counters_per_seam():
    T.reset_retry_stats()
    T.note_retry("replication")
    T.note_retry("replication", 2)
    T.note_retry("procmesh")
    assert T.retry_stats() == {"replication": 3, "procmesh": 1}
    T.reset_retry_stats()
    assert T.retry_stats() == {}


def test_service_metrics_read_the_retry_counters():
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

    T.reset_retry_stats()
    svc = SchedulerService(ClusterStore(), device="cpu")
    svc.start_scheduler(None)
    assert svc.metrics()["retry_by_seam"] == {}
    T.note_retry("replication", 4)
    assert svc.metrics()["retry_by_seam"] == {"replication": 4}
    T.reset_retry_stats()
