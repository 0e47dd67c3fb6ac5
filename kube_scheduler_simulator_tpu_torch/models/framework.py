"""Scheduling-framework contracts: Status, CycleState, plugin interfaces.

This is the Python analog of k8s.io/kubernetes scheduler framework types that
the reference's wrapped plugins delegate to (reference
simulator/scheduler/plugin/wrappedplugin.go:253-364 type-asserts 12 extension
points against these interfaces).  Semantics follow the v1.26 framework the
reference pins (reference simulator/go.mod:3-30):

- A nil/None status means Success.
- ``Status.message()`` joins reasons with ", " — this exact string is what
  lands in the filter/score annotations (reference
  simulator/scheduler/plugin/resultstore/store.go:38-89).
- Scores are int64 in [MIN_NODE_SCORE, MAX_NODE_SCORE].
"""

from __future__ import annotations

import enum
from typing import Any, Protocol, Sequence, runtime_checkable

Obj = dict[str, Any]

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0


class Code(enum.IntEnum):
    """framework.Code (upstream framework/interface.go)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


class Status:
    """framework.Status: a code plus human-readable reasons."""

    __slots__ = ("code", "reasons", "plugin")

    def __init__(self, code: Code = Code.SUCCESS, reasons: "Sequence[str] | None" = None, plugin: str = ""):
        self.code = code
        self.reasons = list(reasons or [])
        self.plugin = plugin

    @staticmethod
    def success() -> "Status":
        return Status(Code.SUCCESS)

    @staticmethod
    def unschedulable(*reasons: str) -> "Status":
        return Status(Code.UNSCHEDULABLE, reasons)

    @staticmethod
    def unresolvable(*reasons: str) -> "Status":
        return Status(Code.UNSCHEDULABLE_AND_UNRESOLVABLE, reasons)

    @staticmethod
    def error(*reasons: str) -> "Status":
        return Status(Code.ERROR, reasons)

    @staticmethod
    def skip() -> "Status":
        return Status(Code.SKIP)

    @staticmethod
    def wait(*reasons: str) -> "Status":
        return Status(Code.WAIT, reasons)

    def is_success(self) -> bool:
        return self.code == Code.SUCCESS

    def is_skip(self) -> bool:
        return self.code == Code.SKIP

    def is_wait(self) -> bool:
        return self.code == Code.WAIT

    def is_rejected(self) -> bool:
        """framework.Status.IsRejected: unschedulable either way."""
        return self.code in (Code.UNSCHEDULABLE, Code.UNSCHEDULABLE_AND_UNRESOLVABLE)

    def message(self) -> str:
        return ", ".join(self.reasons)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Status({self.code.name}, {self.message()!r})"


def is_success(status: "Status | None") -> bool:
    return status is None or status.is_success()


class WaitingPod:
    """A pod parked at Permit (upstream framework.waitingPod): one or
    more permit plugins returned Wait with a timeout; the pod is bound
    only once every plugin calls ``allow`` (or rejected/expired).  The
    reference records the Wait status + timeout per plugin (reference
    wrappedplugin.go:582-611) and upstream's binding cycle blocks on this
    object; the simulator's synchronous loop keeps it in
    Framework.waiting_pods and finishes the bind on the triggering call.
    """

    def __init__(self, pod: Obj, node_name: str, state: "CycleState", plugin_timeouts: dict[str, float], now: float):
        self.pod = pod
        self.node_name = node_name
        self.state = state
        # plugin → absolute deadline
        self.deadlines = {p: now + t for p, t in plugin_timeouts.items()}
        self.pending = set(plugin_timeouts)
        self.rejected: "str | None" = None  # rejection message

    @property
    def key(self) -> str:
        return f"{self.pod['metadata'].get('namespace', 'default')}/{self.pod['metadata']['name']}"

    def pending_plugins(self) -> "set[str]":
        return set(self.pending)

    def earliest_deadline(self) -> float:
        return min(self.deadlines.values()) if self.deadlines else 0.0


class PreFilterResult:
    """framework.PreFilterResult: optional node-name allowlist."""

    __slots__ = ("node_names",)

    def __init__(self, node_names: "set[str] | None" = None):
        self.node_names = node_names

    def all_nodes(self) -> bool:
        return self.node_names is None

    def merge(self, other: "PreFilterResult | None") -> "PreFilterResult":
        if other is None or other.all_nodes():
            return self
        if self.all_nodes():
            return other
        assert self.node_names is not None and other.node_names is not None
        return PreFilterResult(self.node_names & other.node_names)


class CycleState:
    """framework.CycleState: per-scheduling-cycle plugin scratch space."""

    def __init__(self) -> None:
        self._data: dict[str, Any] = {}

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def read(self, key: str) -> Any:
        return self._data.get(key)

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def clone(self) -> "CycleState":
        """Shallow clone (upstream CycleState.Clone): entries are shared;
        writers that mutate an entry on a clone must copy-on-write it
        (the ``add_pod_to_state`` extensions do)."""
        c = CycleState()
        c._data = dict(self._data)
        return c


class Plugin(Protocol):
    name: str


@runtime_checkable
class QueueSortPlugin(Protocol):
    name: str

    def less(self, pod_info1: Obj, pod_info2: Obj) -> bool: ...


@runtime_checkable
class PreFilterPlugin(Protocol):
    name: str

    def pre_filter(self, state: CycleState, pod: Obj) -> "tuple[PreFilterResult | None, Status | None]": ...


@runtime_checkable
class FilterPlugin(Protocol):
    name: str

    def filter(self, state: CycleState, pod: Obj, node_info: "Any") -> "Status | None": ...


@runtime_checkable
class PostFilterPlugin(Protocol):
    name: str

    def post_filter(
        self, state: CycleState, pod: Obj, filtered_node_status_map: dict[str, Status]
    ) -> "tuple[str | None, Status | None]": ...


@runtime_checkable
class PreScorePlugin(Protocol):
    name: str

    def pre_score(self, state: CycleState, pod: Obj, nodes: list[Obj]) -> "Status | None": ...


@runtime_checkable
class ScorePlugin(Protocol):
    name: str

    def score(self, state: CycleState, pod: Obj, node_name: str) -> "tuple[int, Status | None]": ...


@runtime_checkable
class ScoreExtensions(Protocol):
    def normalize_scores(self, state: CycleState, pod: Obj, scores: dict[str, int]) -> "Status | None": ...


@runtime_checkable
class ReservePlugin(Protocol):
    name: str

    def reserve(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None": ...

    def unreserve(self, state: CycleState, pod: Obj, node_name: str) -> None: ...


@runtime_checkable
class PermitPlugin(Protocol):
    name: str

    def permit(self, state: CycleState, pod: Obj, node_name: str) -> "tuple[Status | None, float]": ...


@runtime_checkable
class PreBindPlugin(Protocol):
    name: str

    def pre_bind(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None": ...


@runtime_checkable
class BindPlugin(Protocol):
    name: str

    def bind(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None": ...


@runtime_checkable
class PostBindPlugin(Protocol):
    name: str

    def post_bind(self, state: CycleState, pod: Obj, node_name: str) -> None: ...
