"""The differential runner: one scenario, at least two independent paths.

Every subsystem carries a sequential oracle and a byte-parity bar; this
module is the engine that drives them.  A fuzz scenario executes through
independent paths that must agree byte-for-byte on the full annotation
trail (:mod:`fuzz.verdict`):

- ``batch-vs-oracle``: the tick-driven drain through the batch engine
  (the CUDA kernels on the card, their plain versions on the CPU;
  ``use_batch="auto"``, every exactness gate live) against the pure
  sequential cycle (``use_batch="off"``).
- ``stream-vs-serial``: the same timeline as a continuously draining
  admission feed, streamed (overlapped pipeline) vs strictly serial.
- ``shard-vs-single`` (the reference's opt-in comparison of a node axis
  sharded over two devices): the ``shard`` role runs on an explicit
  two-shard ``NodeMesh`` of the harness's device (the port's CPU has one
  device, where the reference's runs ``KSS_MESH_DEVICES=2`` over its
  virtual CPU devices), against the single-device ``shard-base``.
- ``shard-stream-vs-serial`` (the stream over a mesh): not ported; its
  role raises :class:`ShardNotPorted` (ROADMAP.md, queue 1, item 7c).

**Service reuse.**  A fresh service's first round encodes the cluster
cold and fills the engine's caches, so a :class:`FuzzHarness` keeps one
long-lived (store, service) pair per (profile, role), every service on
the harness's ``device`` (the card unless the caller passes "cpu"), and
wipes the store between scenarios exactly the way the scenario engine
does (``store.restore({})``); engines and the process's kernel libraries
survive, and scenario workloads use disjoint name prefixes so queue /
backoff bookkeeping never collides.  Both members of a pair always
replay the same scenario sequence, so their rotation counters and
resourceVersion streams stay aligned — the property the tie-break draw
needs.  Divergences found mid-sequence are re-confirmed standalone (a
fresh harness) before shrinking.

Determinism: stores and services run on :class:`utils.SimClock` — wall
clock never reaches creationTimestamps, queue backoff, or Permit
deadlines during a fuzz run.
"""

from __future__ import annotations

import copy
import os
from typing import Any

from kube_scheduler_simulator_tpu_torch.fuzz import verdict as V
from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state
from kube_scheduler_simulator_tpu_torch.utils.simclock import SimClock

Obj = dict[str, Any]

DEFAULT_COMPARISONS: tuple[str, ...] = ("batch-vs-oracle", "stream-vs-serial")

# simulated seconds appended after the last tick: past every gang
# timeout the generator emits, so parked waits always resolve before the
# final parity snapshot
EPILOGUE_ADVANCE_S = 330.0


class ShardNotPorted(NotImplementedError):
    """A ``shard-stream`` role: the stream over a node mesh is ROADMAP.md's
    queue 1, item 7c."""


class FuzzHarnessError(RuntimeError):
    """The harness itself broke an invariant (NOT a scenario divergence):
    e.g. a scenario left pods parked at Permit past the epilogue."""


def fuzz_knobs() -> Obj:
    """The documented ``KSS_FUZZ_*`` env knobs, validated here so a typo
    fails loudly at session start instead of silently fuzzing with
    defaults (README.md lists them)."""

    def _int(name: str, raw: str, default: int) -> int:
        raw = raw.strip()
        if not raw:
            return default
        try:
            v = int(raw)
        except ValueError:
            raise ValueError(f"{name} must be an integer, got {raw!r}") from None
        if v < 0:
            raise ValueError(f"{name} must be >= 0, got {v}")
        return v

    budget_raw = os.environ.get("KSS_FUZZ_BUDGET", "").strip()
    try:
        budget = float(budget_raw) if budget_raw else 0.0
    except ValueError:
        raise ValueError(f"KSS_FUZZ_BUDGET must be seconds (float), got {budget_raw!r}") from None
    return {
        "seed": _int("KSS_FUZZ_SEED", os.environ.get("KSS_FUZZ_SEED", ""), 0),
        "scenarios": _int("KSS_FUZZ_SCENARIOS", os.environ.get("KSS_FUZZ_SCENARIOS", ""), 25),
        "shrink_steps": _int(
            "KSS_FUZZ_SHRINK_STEPS", os.environ.get("KSS_FUZZ_SHRINK_STEPS", ""), 192
        ),
        "budget_s": budget,
    }


# ------------------------------------------------------------------ harness

_ROLE_KW: dict[str, dict] = {
    "oracle": {"use_batch": "off"},
    "batch": {"use_batch": "auto", "batch_min_work": 0},
    "stream-on": {"use_batch": "auto", "batch_min_work": 0},
    "stream-off": {"use_batch": "auto", "batch_min_work": 0},
    # two shards of the harness's device (an explicit NodeMesh)
    "shard": {"use_batch": "force", "batch_min_work": 0, "_mesh_shards": 2},
    "shard-base": {"use_batch": "force", "batch_min_work": 0},
    # the stream × mesh fusion: sharded engines on a STREAMED feed,
    # byte-diffed against the serial single-device projection of the
    # same timeline (the cfg12 fusion's differential adversary)
    "shard-stream": {"use_batch": "force", "batch_min_work": 0, "_mesh_devices": "2"},
    "shard-stream-off": {"use_batch": "force", "batch_min_work": 0},
}


class FuzzHarness:
    """Long-lived (store, service) pairs keyed by (profile, role), every
    service on ``device`` (None: the card) in ``dtype`` (None: the
    service's default, float32 on the card and float64 on the CPU)."""

    def __init__(self, device: Any = None, dtype: Any = None) -> None:
        from kube_scheduler_simulator_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.dtype = dtype
        self._built: dict[tuple[str, str], tuple[Any, Any]] = {}

    def service(self, profile: str, role: str) -> tuple[Any, Any]:
        key = (profile, role)
        if key not in self._built:
            self._built[key] = self._build(profile, role)
        return self._built[key]

    def _build(self, profile: str, role: str) -> tuple[Any, Any]:
        from kube_scheduler_simulator_tpu_torch.ops.mesh import NodeMesh
        from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
        from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore

        kw = dict(_ROLE_KW[role])
        if kw.pop("_mesh_devices", None) is not None:
            raise ShardNotPorted(
                f"fuzz role {role!r} streams over a node mesh: not ported (ROADMAP.md, queue 1, item 7c)"
            )
        shards = kw.pop("_mesh_shards", None)
        if shards is not None:
            kw["mesh"] = NodeMesh((self.device,) * shards)
        store = ClusterStore(clock=SimClock(1_700_000_000.0))
        store.create("namespaces", {"metadata": {"name": "default"}})
        cfg = None
        if profile == "gang":
            from kube_scheduler_simulator_tpu_torch.gang import gang_scheduler_config

            cfg = gang_scheduler_config()
        svc = SchedulerService(
            store,
            tie_break="first",
            clock=SimClock(0.0),
            autoscale="on",
            # an EXPLICIT default-valued override: engines hold a weight row
            # from the start, so mid-run retunes swap its values and never
            # rebuild an engine
            weights={},
            device=self.device,
            dtype=self.dtype,
            **kw,
        )
        svc.start_scheduler(cfg)
        return store, svc

    def reset(self, profile: str, role: str) -> tuple[Any, Any]:
        """The pair, wiped for the next scenario: cluster state cleared
        (the scenario-engine wipe), the default namespace restored, and
        the weight override back at the baseline.  Engines and their caches,
        clocks and rotation counters are deliberately KEPT — both members
        of a pair replay the same sequence, so they stay aligned."""
        store, svc = self.service(profile, role)
        store.restore({})
        store.create("namespaces", {"metadata": {"name": "default"}})
        svc.set_plugin_weights({})
        return store, svc


# ------------------------------------------------------------------- drive


def apply_op(store: Any, svc: Any, op: Obj) -> None:
    """Apply one scenario op.  Deletes/patches of absent objects are
    skipped (the shrinker removes creates without chasing references —
    forgiveness here keeps every shrunk scenario executable, and it is
    deterministic: under parity both paths see the same store)."""
    o = op["op"]
    if o == "create":
        try:
            store.create(op["kind"], copy.deepcopy(op["object"]))
        except (KeyError, ValueError):
            # admission failures (e.g. a pod naming a PriorityClass whose
            # create the shrinker deleted) skip the object, both paths
            pass
    elif o == "delete":
        try:
            store.delete(op["kind"], op["name"], op.get("namespace"))
        except KeyError:
            pass
    elif o == "patch":
        try:
            store.patch(op["kind"], op["name"], copy.deepcopy(op["body"]), op.get("namespace"))
        except KeyError:
            pass
    elif o == "weights":
        svc.set_plugin_weights(dict(op["weights"]))
    else:  # pragma: no cover - generator never emits unknown ops
        raise ValueError(f"unknown fuzz op {o!r}")


def _settle(store: Any, svc: Any, autoscaled: bool) -> None:
    """Post-timeline convergence: advance past every permit deadline,
    expire parked waits, and drain until quiescent."""
    clk = svc._clock
    clk.advance(EPILOGUE_ADVANCE_S)
    svc.process_waiting_pods()
    for _ in range(4):
        if autoscaled:
            results = svc.schedule_pending_autoscaled(max_rounds=2, max_passes=4)
        else:
            results = svc.schedule_pending(max_rounds=2)
        if not any(r.success or r.nominated_node for r in results.values()):
            break
        clk.advance(1.0)
    leftover = svc._all_waiting_keys()
    if leftover:
        raise FuzzHarnessError(f"pods still parked at Permit after epilogue: {sorted(leftover)}")


def run_ticks(scenario: Obj, store: Any, svc: Any) -> Obj:
    """The tick-driven projection: apply each tick's ops, drain the
    queue (autoscaled when the scenario composes the capacity engine),
    advance simulated time one step — then settle and snapshot."""
    clk = svc._clock
    step = float(scenario.get("stepSeconds") or 1.0)
    autoscaled = "autoscale" in scenario["features"]
    for ops in scenario["ticks"]:
        for op in ops:
            apply_op(store, svc, op)
        if autoscaled:
            svc.schedule_pending_autoscaled(max_rounds=2, max_passes=4)
        else:
            svc.schedule_pending(max_rounds=2)
        clk.advance(step)
    _settle(store, svc, autoscaled)
    return pod_parity_state(store)


def run_stream(scenario: Obj, store: Any, svc: Any, streaming: bool) -> Obj:
    """The stream projection: the same timeline as an admission feed
    (one tick per admission), streamed or strictly serial.  The capacity
    engine does not run mid-stream — autoscaler passes read in-flight
    state and would be legitimately phase-sensitive — so ``autoscale``
    scenarios exercise it only on the tick-driven comparison."""
    clk = svc._clock
    step = float(scenario.get("stepSeconds") or 1.0)
    ticks = scenario["ticks"]

    def feed(tick: int) -> bool:
        if tick >= len(ticks):
            return False
        for op in ticks[tick]:
            apply_op(store, svc, op)
        clk.advance(step)
        return True

    svc.schedule_stream(feed=feed, streaming=streaming, idle_sleep_s=0.0)
    _settle(store, svc, autoscaled=False)
    return pod_parity_state(store)


# ------------------------------------------------------------ differential

_COMPARISON_ROLES: dict[str, tuple[str, str]] = {
    "batch-vs-oracle": ("batch", "oracle"),
    "stream-vs-serial": ("stream-on", "stream-off"),
    "shard-vs-single": ("shard", "shard-base"),
    # sharded + streamed vs serial single-device: not ported (the
    # shard-stream role raises ShardNotPorted)
    "shard-stream-vs-serial": ("shard-stream", "shard-stream-off"),
}


def _run_role(scenario: Obj, store: Any, svc: Any, role: str, chaos: "Obj | None") -> Obj:
    def drive() -> Obj:
        if role in ("stream-on", "shard-stream"):
            return run_stream(scenario, store, svc, streaming=True)
        if role in ("stream-off", "shard-stream-off"):
            return run_stream(scenario, store, svc, streaming=False)
        return run_ticks(scenario, store, svc)

    if chaos and role in (chaos.get("roles") or ("batch",)):
        from kube_scheduler_simulator_tpu_torch.fuzz.chaos import KernelChaos

        with KernelChaos(svc, fail_events=frozenset(chaos["fail_events"])):
            return drive()
    return drive()


def run_differential(
    scenario: Obj,
    harness: "FuzzHarness | None" = None,
    comparisons: "tuple[str, ...]" = DEFAULT_COMPARISONS,
    chaos: "Obj | None" = None,
    device: Any = None,
    dtype: Any = None,
) -> tuple[Obj, dict[str, Obj]]:
    """Execute ``scenario`` through every requested comparison pair and
    judge the byte diffs.  Returns ``(verdict, states)`` where
    ``states`` maps role -> parity state (fixture replay pins the oracle
    state's exact bytes).  ``chaos`` is a plan dict
    ``{"roles": [...], "fail_events": [...]}`` applied to the named
    roles' services (:mod:`fuzz.chaos`).  ``device`` and ``dtype`` are
    those of a harness built here (None: the card, its default dtype)."""
    harness = harness or FuzzHarness(device, dtype)
    profile = scenario.get("profile") or "default"
    cmps: list[Obj] = []
    states: dict[str, Obj] = {}
    for kind in comparisons:
        role_a, role_b = _COMPARISON_ROLES[kind]
        store_a, svc_a = harness.reset(profile, role_a)
        before = V.gate_snapshot(svc_a.metrics())
        state_a = _run_role(scenario, store_a, svc_a, role_a, chaos)
        explained = V.gate_delta(before, V.gate_snapshot(svc_a.metrics()))
        store_b, svc_b = harness.reset(profile, role_b)
        state_b = _run_role(scenario, store_b, svc_b, role_b, chaos)
        states[role_a], states[role_b] = state_a, state_b
        cmps.append(V.compare(kind, state_a, state_b, explained))
    return V.verdict(scenario, cmps), states


def encode_state(state: Obj) -> list:
    """Canonical JSON-serializable form of a parity state — the exact
    bytes a fixture's ``expected`` field commits."""
    return [[k, V._row(state[k])] for k in sorted(state)]
