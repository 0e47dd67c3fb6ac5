"""Wrapped (debuggable) plugins: delegate to the original, record results.

Rebuild of the reference's core wrappedPlugin (reference
simulator/scheduler/plugin/wrappedplugin.go:253-765): every plugin is
wrapped under the name ``<Original>Wrapped``; each extension-point call
delegates to the original and records the outcome in the ResultStore, with
optional user Before/After extender hooks per point (reference
wrappedplugin.go:47-171 defines the 11 extender interfaces — here a single
duck-typed extender object with ``before_<point>`` / ``after_<point>``
methods plays that role, created per-plugin via a PluginExtenderInitializer
receiving the shared store).
"""

from __future__ import annotations

from typing import Any, Callable

from kube_scheduler_simulator_tpu_torch.models.framework import Code, CycleState, Status
from kube_scheduler_simulator_tpu_torch.plugins.resultstore import (
    PASSED_FILTER_MESSAGE,
    SUCCESS_MESSAGE,
    WAIT_MESSAGE,
    ResultStore,
)

Obj = dict[str, Any]

PLUGIN_SUFFIX = "Wrapped"


def plugin_name(name: str) -> str:
    return name + PLUGIN_SUFFIX


def original_name(wrapped: str) -> str:
    return wrapped[: -len(PLUGIN_SUFFIX)] if wrapped.endswith(PLUGIN_SUFFIX) else wrapped


def _ns(pod: Obj) -> str:
    return pod["metadata"].get("namespace", "default")


def _name(pod: Obj) -> str:
    return pod["metadata"]["name"]


def _status_message(status: "Status | None") -> str:
    if status is None or status.is_success():
        return SUCCESS_MESSAGE
    if status.is_wait():
        return WAIT_MESSAGE
    return status.message()


class WrappedPlugin:
    """Wraps one plugin instance; exposes the same extension points."""

    def __init__(self, store: ResultStore, original: Any, extender: Any = None):
        self.store = store
        self.original = original
        self.extender = extender
        self.name = plugin_name(original.name)

    # ---- capability probes (mirror the NewWrappedPlugin type asserts)

    def implements(self, point: str) -> bool:
        return hasattr(self.original, point)

    def _hook(self, hook_name: str) -> "Callable | None":
        if self.extender is None:
            return None
        return getattr(self.extender, hook_name, None)

    # ----------------------------------------------------------- extension points

    def pre_filter(self, state: CycleState, pod: Obj):
        before = self._hook("before_pre_filter")
        if before is not None:
            result, status = before(state, pod)
            if status is not None and not status.is_success():
                return result, status
        result, status = self.original.pre_filter(state, pod)
        self.store.add_pre_filter_result(
            _ns(pod), _name(pod), self.original.name, _status_message(status), result
        )
        after = self._hook("after_pre_filter")
        if after is not None:
            return after(state, pod, result, status)
        return result, status

    def filter(self, state: CycleState, pod: Obj, node_info: Any) -> "Status | None":
        before = self._hook("before_filter")
        if before is not None:
            status = before(state, pod, node_info)
            if status is not None and not status.is_success():
                return status
        status = self.original.filter(state, pod, node_info)
        msg = PASSED_FILTER_MESSAGE if status is None or status.is_success() else status.message()
        self.store.add_filter_result(_ns(pod), _name(pod), node_info.name, self.original.name, msg)
        after = self._hook("after_filter")
        if after is not None:
            return after(state, pod, node_info, status)
        return status

    def post_filter(self, state: CycleState, pod: Obj, filtered_node_status_map: dict[str, Status]):
        before = self._hook("before_post_filter")
        if before is not None:
            nominated, status = before(state, pod, filtered_node_status_map)
            if status is not None and not status.is_success():
                return nominated, status
        nominated, status = self.original.post_filter(state, pod, filtered_node_status_map)
        self.store.add_post_filter_result(
            _ns(pod),
            _name(pod),
            nominated or "",
            self.original.name,
            sorted(filtered_node_status_map.keys()),
        )
        after = self._hook("after_post_filter")
        if after is not None:
            return after(state, pod, filtered_node_status_map, nominated, status)
        return nominated, status

    def pre_score(self, state: CycleState, pod: Obj, nodes: list[Obj]) -> "Status | None":
        before = self._hook("before_pre_score")
        if before is not None:
            status = before(state, pod, nodes)
            if status is not None and not status.is_success():
                return status
        status = self.original.pre_score(state, pod, nodes)
        self.store.add_pre_score_result(_ns(pod), _name(pod), self.original.name, _status_message(status))
        after = self._hook("after_pre_score")
        if after is not None:
            return after(state, pod, nodes, status)
        return status

    def score(self, state: CycleState, pod: Obj, node_info: Any) -> "tuple[int, Status | None]":
        before = self._hook("before_score")
        if before is not None:
            score, status = before(state, pod, node_info.name)
            if status is not None and not status.is_success():
                return score, status
        score, status = self.original.score(state, pod, node_info)
        self.store.add_score_result(_ns(pod), _name(pod), node_info.name, self.original.name, score)
        after = self._hook("after_score")
        if after is not None:
            return after(state, pod, node_info.name, score, status)
        return score, status

    def normalize_scores(self, state: CycleState, pod: Obj, scores: dict[str, int]) -> "Status | None":
        before = self._hook("before_normalize_score")
        if before is not None:
            status = before(state, pod, scores)
            if status is not None and not status.is_success():
                return status
        status = None
        if hasattr(self.original, "normalize_scores"):
            status = self.original.normalize_scores(state, pod, scores)
        after = self._hook("after_normalize_score")
        if after is not None:
            status = after(state, pod, scores, status)
        for node_name, s in scores.items():
            self.store.add_normalized_score_result(_ns(pod), _name(pod), node_name, self.original.name, s)
        return status

    def reserve(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None":
        before = self._hook("before_reserve")
        if before is not None:
            status = before(state, pod, node_name)
            if status is not None and not status.is_success():
                return status
        status = None
        if hasattr(self.original, "reserve"):
            status = self.original.reserve(state, pod, node_name)
        if status is None or status.is_success():
            self.store.add_selected_node(_ns(pod), _name(pod), node_name)
        self.store.add_reserve_result(_ns(pod), _name(pod), self.original.name, _status_message(status))
        after = self._hook("after_reserve")
        if after is not None:
            return after(state, pod, node_name, status)
        return status

    def unreserve(self, state: CycleState, pod: Obj, node_name: str) -> None:
        if hasattr(self.original, "unreserve"):
            self.original.unreserve(state, pod, node_name)

    def permit(self, state: CycleState, pod: Obj, node_name: str):
        before = self._hook("before_permit")
        if before is not None:
            status, timeout = before(state, pod, node_name)
            if status is not None and not status.is_success():
                return status, timeout
        status, timeout = self.original.permit(state, pod, node_name)
        self.store.add_permit_result(
            _ns(pod), _name(pod), self.original.name, _status_message(status), timeout
        )
        after = self._hook("after_permit")
        if after is not None:
            return after(state, pod, node_name, status, timeout)
        return status, timeout

    def pre_bind(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None":
        before = self._hook("before_pre_bind")
        if before is not None:
            status = before(state, pod, node_name)
            if status is not None and not status.is_success():
                return status
        status = self.original.pre_bind(state, pod, node_name)
        self.store.add_pre_bind_result(_ns(pod), _name(pod), self.original.name, _status_message(status))
        after = self._hook("after_pre_bind")
        if after is not None:
            return after(state, pod, node_name, status)
        return status

    def bind(self, state: CycleState, pod: Obj, node_name: str) -> "Status | None":
        before = self._hook("before_bind")
        if before is not None:
            status = before(state, pod, node_name)
            if status is not None and not status.is_success():
                return status
        status = self.original.bind(state, pod, node_name)
        self.store.add_bind_result(_ns(pod), _name(pod), self.original.name, _status_message(status))
        after = self._hook("after_bind")
        if after is not None:
            return after(state, pod, node_name, status)
        return status

    def post_bind(self, state: CycleState, pod: Obj, node_name: str) -> None:
        if hasattr(self.original, "post_bind"):
            self.original.post_bind(state, pod, node_name)

    def less(self, pod_info1: Obj, pod_info2: Obj) -> bool:
        return self.original.less(pod_info1, pod_info2)
