"""The scheduling framework runner: ScheduleOne over wrapped plugins.

Sequential rebuild of the upstream scheduling cycle the reference traces
(SURVEY.md section 3.2: PreFilter → Filter → [PostFilter] → PreScore →
Score → Normalize → selectHost → Reserve → Permit → PreBind → Bind), with
upstream's feasible-node sampling (percentageOfNodesToScore + rotating
start index) and the single-feasible-node scoring bypass.

This path produces the full per-plugin annotation trace through the result
store.  The batch engine (scheduler/batch_engine.py) computes the same
results as tensors; this runner is the semantic oracle.
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import (
    Code,
    CycleState,
    PreFilterResult,
    Status,
    WaitingPod,
)
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo
from kube_scheduler_simulator_tpu_torch.models.snapshot import Snapshot
from kube_scheduler_simulator_tpu_torch.models.wrapped import WrappedPlugin

Obj = dict[str, Any]

MIN_FEASIBLE_NODES_TO_FIND = 100
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5
# upstream maxTimeout for permit Wait (15 minutes)
MAX_PERMIT_TIMEOUT_S = 15 * 60.0


def num_feasible_nodes_to_find(num_all_nodes: int, percentage: int) -> int:
    """Upstream sched.numFeasibleNodesToFind (module-level so the batch
    engine computes the identical sample cap, scheduler/batch_engine.py)."""
    if num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND or percentage >= 100:
        return num_all_nodes
    adaptive = percentage
    if adaptive <= 0:
        adaptive = 50 - num_all_nodes // 125
        if adaptive < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
            adaptive = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
    num_nodes = num_all_nodes * adaptive // 100
    if num_nodes < MIN_FEASIBLE_NODES_TO_FIND:
        return MIN_FEASIBLE_NODES_TO_FIND
    return num_nodes


class FrameworkHandle:
    """What plugins can reach (upstream framework.Handle analog)."""

    def __init__(self, cluster_store: Any = None):
        self.cluster_store = cluster_store
        self.framework: "Framework | None" = None
        self._snapshot: "Snapshot | None" = None

    def snapshot(self) -> "Snapshot | None":
        return self._snapshot

    def set_snapshot(self, snap: Snapshot) -> None:
        self._snapshot = snap

    # upstream framework.Handle's waiting-pod surface (plugins use these
    # to approve/reject parked pods, e.g. coscheduling-style gangs)
    def get_waiting_pod(self, namespace: str, name: str):
        return self.framework.get_waiting_pod(namespace, name) if self.framework else None

    def iterate_over_waiting_pods(self):
        return self.framework.iterate_over_waiting_pods() if self.framework else []


class ScheduleResult:
    __slots__ = ("selected_node", "feasible_nodes", "diagnosis", "status", "nominated_node", "waiting_on")

    def __init__(
        self,
        selected_node: "str | None" = None,
        feasible_nodes: "list[str] | None" = None,
        diagnosis: "dict[str, Status] | None" = None,
        status: "Status | None" = None,
        nominated_node: "str | None" = None,
        waiting_on: "str | None" = None,
    ):
        self.selected_node = selected_node
        self.feasible_nodes = feasible_nodes or []
        self.diagnosis = diagnosis or {}
        self.status = status
        self.nominated_node = nominated_node
        # node the pod is parked on at Permit (WaitingPod machinery)
        self.waiting_on = waiting_on

    @property
    def success(self) -> bool:
        return self.selected_node is not None


class Framework:
    """One scheduling profile's plugin set, ready to schedule pods."""

    EXTENSION_POINTS = (
        "queue_sort",
        "pre_filter",
        "filter",
        "post_filter",
        "pre_score",
        "score",
        "reserve",
        "permit",
        "pre_bind",
        "bind",
        "post_bind",
    )

    def __init__(
        self,
        plugins: dict[str, list[WrappedPlugin]],
        handle: FrameworkHandle,
        score_weights: "dict[str, int] | None" = None,
        percentage_of_nodes_to_score: int = 0,
        seed: int = 0,
        profile_name: str = "default-scheduler",
        tie_break: str = "reservoir",
        clock: "Any | None" = None,
    ):
        self.plugins = {p: list(plugins.get(p, [])) for p in self.EXTENSION_POINTS}
        self.handle = handle
        handle.framework = self
        self.score_weights = dict(score_weights or {})
        # Optional plugin-weight OVERRIDE (the learned scoring head,
        # tuning/): SchedulerService.set_plugin_weights installs a
        # name → float map here; the weighted-sum below and the batch
        # engine (from_framework) both read it, so a round keeps the
        # same weighting whichever path it takes.  score_weights itself
        # stays the profile's integer config — restoring the default is
        # just clearing this.
        self.score_weight_override: "dict[str, float] | None" = None
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.seed = seed
        self.next_start_node_index = 0
        # Number of schedule_one attempts so far; keys the tie-break draw
        # (utils/hashing.py) so the batch kernel — which processes pod i of
        # a round as attempt sched_counter+i — makes the identical pick.
        self.sched_counter = 0
        self.profile_name = profile_name
        # pods parked at Permit (key → WaitingPod); see allow_waiting_pod
        self.waiting_pods: dict[str, WaitingPod] = {}
        # injectable time source for Permit deadlines: scenario replay
        # drives a deterministic timeline clock through here so gang
        # scheduleTimeoutSeconds expiry replays byte-identically
        import time as _time

        self.clock = clock or _time.monotonic
        # waiting pods RESOLVED (allowed-and-bound or rejected) since the
        # service last drained — fills whether the resolution came from a
        # service call or a PLUGIN cascade (gang release/rejection), so
        # the service can record failures it would otherwise never see
        self.resolved_waiting: list[tuple[Obj, "ScheduleResult"]] = []
        # "reservoir" = upstream selectHost semantics (uniform over tied
        # maxima), made deterministic via a counter-keyed hash draw shared
        # with the batch kernel; "first" = first-max in visit order,
        # matching the batch engine's argmax — used by parity tests.
        self.tie_break = tie_break
        # ExtenderService (scheduler/extender.py); None = no extenders.
        # Hooks mirror upstream: filter narrowing after plugin filters,
        # additive prioritize scores, extender binder preferred over bind
        # plugins.
        self.extender_service = None

    # ------------------------------------------------------------- utilities

    def num_feasible_nodes_to_find(self, num_all_nodes: int) -> int:
        """Upstream sched.numFeasibleNodesToFind."""
        return num_feasible_nodes_to_find(num_all_nodes, self.percentage_of_nodes_to_score)

    def run_filter_plugins_silently(
        self,
        state: CycleState,
        pod: Obj,
        node_info: NodeInfo,
        snapshot: "Snapshot | None" = None,
    ) -> bool:
        """Run the ORIGINAL filter plugins without recording (used by
        preemption's victim search).  With ``snapshot``, other pods'
        pending nominations on this node are accounted first — upstream's
        dry run goes through RunFilterPluginsWithNominatedPods, so a
        preemptor can't be nominated onto capacity already reserved for a
        higher-priority nominee."""
        if snapshot is not None:
            from kube_scheduler_simulator_tpu_torch.plugins.intree.queue_bind import pod_priority

            me = pod["metadata"]
            nominated = [
                q
                for q in snapshot.nominated_pods(node_info.name)
                if pod_priority(q) >= pod_priority(pod)
                and not (
                    q["metadata"]["name"] == me["name"]
                    and q["metadata"].get("namespace", "default") == me.get("namespace", "default")
                )
            ]
            if nominated:
                scratch = NodeInfo(node_info.node)
                for p in node_info.pods:
                    scratch.add_pod(p)
                cloned = state.clone()
                for q in nominated:
                    scratch.add_pod(q)
                    for wp in self.plugins["filter"]:
                        add = getattr(wp.original, "add_pod_to_state", None)
                        if add is not None:
                            add(cloned, pod, q, node_info)
                if not self._silent_pass(cloned, pod, scratch):
                    return False
        return self._silent_pass(state, pod, node_info)

    def _silent_pass(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> bool:
        for wp in self.plugins["filter"]:
            status = wp.original.filter(state, pod, node_info)
            if status is not None and not status.is_success():
                return False
        return True

    # ---------------------------------------------------------- schedule one

    def schedule_one(self, pod: Obj, snapshot: Snapshot) -> ScheduleResult:
        self.handle.set_snapshot(snapshot)
        state = CycleState()
        # One attempt = one tie-break counter tick, consumed or not (the
        # batch kernel ticks once per scan step the same way).
        self._attempt = self.sched_counter
        self.sched_counter += 1

        # PreFilter
        merged_result = PreFilterResult(None)
        for wp in self.plugins["pre_filter"]:
            result, status = wp.pre_filter(state, pod)
            if status is not None and not status.is_success():
                if status.is_skip():
                    continue
                diagnosis = {ni.name: status for ni in snapshot.node_infos}
                return ScheduleResult(diagnosis=diagnosis, status=status)
            if result is not None:
                merged_result = merged_result.merge(result)

        node_infos = snapshot.node_infos
        if not merged_result.all_nodes():
            assert merged_result.node_names is not None
            node_infos = [ni for ni in node_infos if ni.name in merged_result.node_names]
            if not node_infos:
                status = Status.unresolvable("node(s) didn't satisfy plugin(s) prefilter result")
                return ScheduleResult(status=status)

        # Filter with feasible-node sampling + rotating start index
        num_all = len(snapshot.node_infos)
        num_to_find = self.num_feasible_nodes_to_find(num_all)
        feasible: list[NodeInfo] = []
        diagnosis: dict[str, Status] = {}
        processed = 0
        n = len(node_infos)
        for i in range(n):
            ni = node_infos[(self.next_start_node_index + i) % n]
            processed += 1
            status = self._run_filters_with_nominated(state, pod, ni, snapshot)
            if status is None:
                feasible.append(ni)
                if len(feasible) >= num_to_find:
                    break
            else:
                diagnosis[ni.name] = status
        self.next_start_node_index = (self.next_start_node_index + processed) % n if n else 0

        # Extender filter pass (upstream findNodesThatPassExtenders).  A
        # non-ignorable extender failure fails this scheduling attempt.
        if feasible and self.extender_service is not None and self.extender_service.extenders:
            try:
                passed, failed = self.extender_service.run_filter(pod, [ni.node for ni in feasible])
            except Exception as e:
                return ScheduleResult(status=Status.error(str(e)), diagnosis=diagnosis)
            passed_names = {nd["metadata"]["name"] for nd in passed}
            for nm, reason in failed.items():
                diagnosis[nm] = Status.unschedulable(reason)
            feasible = [ni for ni in feasible if ni.name in passed_names]

        if not feasible:
            nominated = self._run_post_filters(state, pod, diagnosis)
            status = Status.unschedulable(
                f"0/{num_all} nodes are available"
            )
            return ScheduleResult(diagnosis=diagnosis, status=status, nominated_node=nominated)

        # Single feasible node: skip scoring (upstream optimization).
        if len(feasible) == 1:
            selected = feasible[0].name
        else:
            selected, score_status = self._score_and_select(state, pod, feasible)
            if selected is None:
                return ScheduleResult(status=score_status, diagnosis=diagnosis)

        # Reserve
        for wp in self.plugins["reserve"]:
            status = wp.reserve(state, pod, selected)
            if status is not None and not status.is_success():
                self._unreserve(state, pod, selected)
                return ScheduleResult(status=status, diagnosis=diagnosis)
        snapshot.assume(pod, selected)

        # Permit: Wait parks the pod in waiting_pods (upstream's
        # waitingPodsMap) — binding happens when every waiting plugin
        # calls allow_waiting_pod, or the pod is rejected/expired.
        wait_timeouts: dict[str, float] = {}
        for wp in self.plugins["permit"]:
            status, timeout = wp.permit(state, pod, selected)
            if status is not None and status.is_wait():
                # upstream clamps 0/negative AND oversized timeouts to the
                # 15 min max
                t = float(timeout) if timeout and timeout > 0 else MAX_PERMIT_TIMEOUT_S
                wait_timeouts[wp.original.name] = min(t, MAX_PERMIT_TIMEOUT_S)
            elif status is not None and not status.is_success():
                snapshot.forget(pod, selected)
                self._unreserve(state, pod, selected)
                return ScheduleResult(status=status, diagnosis=diagnosis)
        if wait_timeouts:
            waiting = WaitingPod(pod, selected, state, wait_timeouts, self.clock())
            self.waiting_pods[waiting.key] = waiting
            return ScheduleResult(diagnosis=diagnosis, waiting_on=selected)

        return self._finish_binding(
            state, pod, selected, diagnosis, [ni.name for ni in feasible], snapshot
        )

    def _finish_binding(
        self,
        state: CycleState,
        pod: Obj,
        selected: str,
        diagnosis: dict[str, Status],
        feasible_names: list[str],
        snapshot: "Snapshot | None",
    ) -> ScheduleResult:
        """PreBind → Bind → PostBind (also runs when a waiting pod is
        finally allowed, where the round snapshot no longer exists)."""

        def fail(status: Status) -> ScheduleResult:
            if snapshot is not None:
                snapshot.forget(pod, selected)
            self._unreserve(state, pod, selected)
            return ScheduleResult(status=status, diagnosis=diagnosis)

        # PreBind
        for wp in self.plugins["pre_bind"]:
            status = wp.pre_bind(state, pod, selected)
            if status is not None and not status.is_success():
                return fail(status)

        # Bind: an interested extender binder takes precedence over bind
        # plugins (upstream sched.extendersBinding).
        binder = (
            self.extender_service.find_binder(pod)
            if self.extender_service is not None and self.extender_service.extenders
            else None
        )
        if binder is not None:
            idx, _ext = binder
            meta = pod["metadata"]
            try:
                result = self.extender_service.bind(
                    idx,
                    {
                        "podName": meta["name"],
                        "podNamespace": meta.get("namespace", "default"),
                        "podUID": meta.get("uid", ""),
                        "node": selected,
                    },
                )
            except Exception as e:  # webhook down/timeout: clean up state
                return fail(Status.error(str(e)))
            if result and result.get("error"):
                return fail(Status.error(result["error"]))
            # Upstream: the extender webhook binds against the apiserver
            # itself.  Our extender can't reach the in-memory store, so the
            # simulator performs the store bind on its behalf after a
            # successful response.
            store = getattr(self.handle, "cluster_store", None)
            if store is not None:
                meta = pod["metadata"]
                store.bind_pod(meta.get("namespace", "default"), meta["name"], selected)
        else:
            for wp in self.plugins["bind"]:
                status = wp.bind(state, pod, selected)
                if status is not None and status.is_skip():
                    continue
                if status is not None and not status.is_success():
                    return fail(status)
                break

        for wp in self.plugins["post_bind"]:
            wp.post_bind(state, pod, selected)

        return ScheduleResult(
            selected_node=selected,
            feasible_nodes=feasible_names,
            diagnosis=diagnosis,
        )

    # --------------------------------------------------------- waiting pods

    def get_waiting_pod(self, namespace: str, name: str) -> "WaitingPod | None":
        """upstream Handle.GetWaitingPod analog."""
        return self.waiting_pods.get(f"{namespace}/{name}")

    def iterate_over_waiting_pods(self):
        """upstream Handle.IterateOverWaitingPods analog."""
        return list(self.waiting_pods.values())

    def allow_waiting_pod(self, namespace: str, name: str, plugin: str) -> "ScheduleResult | None":
        """Plugin ``plugin`` approves the waiting pod; once every permit
        plugin has approved, the bind cycle completes (upstream
        waitingPod.Allow).  Returns the final result when binding ran."""
        wp = self.get_waiting_pod(namespace, name)
        if wp is None:
            return None
        wp.pending.discard(plugin)
        # an approved plugin's timer stops (upstream Allow cancels it)
        wp.deadlines.pop(plugin, None)
        if wp.pending:
            return None
        del self.waiting_pods[wp.key]
        res = self._finish_binding(wp.state, wp.pod, wp.node_name, {}, [], None)
        self.resolved_waiting.append((wp.pod, res))
        return res

    def reject_waiting_pod(self, namespace: str, name: str, message: str = "rejected") -> "ScheduleResult | None":
        """upstream waitingPod.Reject: unreserve and fail the pod."""
        wp = self.waiting_pods.pop(f"{namespace}/{name}", None)
        if wp is None:
            return None
        # the pod is already out of the map, so plugin cascades triggered
        # by this unreserve (gang teardown) terminate
        self._unreserve(wp.state, wp.pod, wp.node_name)
        res = ScheduleResult(status=Status.unschedulable(message))
        self.resolved_waiting.append((wp.pod, res))
        return res

    def expire_waiting_pods(self, now: "float | None" = None) -> dict[str, ScheduleResult]:
        """Reject every waiting pod whose earliest permit deadline passed
        (upstream rejects on timer expiry)."""
        now = self.clock() if now is None else now
        out: dict[str, ScheduleResult] = {}
        for key in [k for k, w in self.waiting_pods.items() if w.earliest_deadline() <= now]:
            ns, name = key.split("/", 1)
            res = self.reject_waiting_pod(ns, name, "pod rejected: permit wait timeout expired")
            if res is not None:
                out[key] = res
        return out

    # ------------------------------------------------------------- internals

    def _run_filters(self, state: CycleState, pod: Obj, ni: NodeInfo) -> "Status | None":
        """Run filter plugins in order; stop at first failure (upstream
        RunFilterPlugins semantics — later plugins don't run, so their
        entries are absent from the annotation, as in the reference)."""
        for wp in self.plugins["filter"]:
            status = wp.filter(state, pod, ni)
            if status is not None and not status.is_success():
                return status
        return None

    def _run_filters_with_nominated(
        self, state: CycleState, pod: Obj, ni: NodeInfo, snapshot: Snapshot
    ) -> "Status | None":
        """Upstream RunFilterPluginsWithNominatedPods: when equal-or-
        higher-priority pods are NOMINATED onto the node (preemption
        happened, victims evicted, nominee not yet bound), the pod must
        pass filters BOTH with those pods' resources accounted AND
        without them — otherwise it could steal the capacity preemption
        just freed for the nominee."""
        from kube_scheduler_simulator_tpu_torch.plugins.intree.queue_bind import pod_priority

        me = pod["metadata"]
        nominated = [
            q
            for q in snapshot.nominated_pods(ni.name)
            if pod_priority(q) >= pod_priority(pod)
            and not (
                q["metadata"]["name"] == me["name"]
                and q["metadata"].get("namespace", "default") == me.get("namespace", "default")
            )
        ]
        if nominated:
            scratch = NodeInfo(ni.node)
            for p in ni.pods:
                scratch.add_pod(p)
            # cloned cycle state + AddPod extensions so STATE-based
            # plugins (InterPodAffinity, PodTopologySpread) see the
            # nominated pods too, not just node-resource readers
            cloned = state.clone()
            for q in nominated:
                scratch.add_pod(q)
                for wp in self.plugins["filter"]:
                    add = getattr(wp.original, "add_pod_to_state", None)
                    if add is not None:
                        add(cloned, pod, q, ni)
            status = self._run_filters(cloned, pod, scratch)
            if status is not None and not status.is_success():
                return status
        return self._run_filters(state, pod, ni)

    def _run_post_filters(self, state: CycleState, pod: Obj, diagnosis: dict[str, Status]) -> "str | None":
        for wp in self.plugins["post_filter"]:
            nominated, status = wp.post_filter(state, pod, diagnosis)
            if status is None or status.is_success():
                return nominated
        return None

    def _score_and_select(
        self, state: CycleState, pod: Obj, feasible: list[NodeInfo]
    ) -> "tuple[str | None, Status | None]":
        # PreScore: a non-success status aborts the cycle (upstream
        # RunPreScorePlugins fails scheduling on the first error).
        nodes = [ni.node for ni in feasible]
        for wp in self.plugins["pre_score"]:
            status = wp.pre_score(state, pod, nodes)
            if status is not None and not status.is_success():
                if status.is_skip():
                    continue
                return None, status

        totals: dict[str, int] = {ni.name: 0 for ni in feasible}
        for wp in self.plugins["score"]:
            raw: dict[str, int] = {}
            for ni in feasible:
                score, status = wp.score(state, pod, ni)
                if status is not None and not status.is_success():
                    score = 0
                raw[ni.name] = score
            wp.normalize_scores(state, pod, raw)
            weights = self.score_weight_override or self.score_weights
            weight = weights.get(wp.original.name, 1)
            for name, s in raw.items():
                totals[name] += s * weight

        # Extender prioritize pass (additive weighted scores).
        if self.extender_service is not None and self.extender_service.extenders:
            ext_totals = self.extender_service.run_prioritize(pod, nodes)
            for name, s in ext_totals.items():
                if name in totals:
                    totals[name] += s

        return self._select_host(totals), None

    def _select_host(self, totals: dict[str, int]) -> str:
        """Upstream selectHost: max score, uniform tie-break over tied
        maxima (reference mirrors the reservoir form at
        scheduler/scheduler.go:323-344).  The pick is the k-th tied
        candidate in visit order with k from the counter-keyed hash draw —
        bit-identical to the batch kernel's selection (ops/batch.py)."""
        best_score: "int | None" = None
        tied: list[str] = []
        for name, score in totals.items():
            if best_score is None or score > best_score:
                best_score = score
                tied = [name]
            elif score == best_score:
                tied.append(name)
        if not tied:
            return ""
        if self.tie_break != "reservoir" or len(tied) == 1:
            return tied[0]
        from kube_scheduler_simulator_tpu_torch.utils.hashing import tie_break_draw

        return tied[tie_break_draw(self.seed, self._attempt) % len(tied)]

    def _unreserve(self, state: CycleState, pod: Obj, node_name: str) -> None:
        for wp in reversed(self.plugins["reserve"]):
            wp.unreserve(state, pod, node_name)

    def sort_pods(self, pods: list[Obj]) -> list[Obj]:
        """Order the activeQ by the QueueSort plugin (PrioritySort default).

        Ties (neither less(a,b) nor less(b,a)) MUST compare equal so the
        stable sort preserves arrival order.  The old comparator returned
        1 for ties ("a > b"), which is inconsistent (it also claims b > a)
        — Timsort then emits a length-dependent permutation of the tied
        group, so two otherwise-identical workloads whose creationTimestamps
        straddle a wall-clock second boundary differently scheduled in
        DIFFERENT orders (the test_mixed_everything_differential flake)."""
        qs = self.plugins["queue_sort"]
        if not qs:
            return list(pods)
        import functools

        less = qs[0].less

        def cmp(a: Obj, b: Obj) -> int:
            if less(a, b):
                return -1
            if less(b, a):
                return 1
            return 0

        return sorted(pods, key=functools.cmp_to_key(cmp))
