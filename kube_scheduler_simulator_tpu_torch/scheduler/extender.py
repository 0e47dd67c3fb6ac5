"""Webhook-extender tracing proxy + scheduling-cycle integration.

Rebuild of the reference's extender layer (reference
simulator/scheduler/extender/{extender.go,service.go} and
extender/resultstore): the user's KubeSchedulerConfiguration extenders are
proxied so every Filter/Prioritize/Preempt/Bind webhook round-trip is
recorded and written to the pod's annotations
(``scheduler-simulator/extender-*-result``, reference
extender/annotation/annotation.go:3-12).

Wire format is the upstream extenderv1 JSON (lowercase keys: ``pod``,
``nodes``, ``nodenames``, ``failedNodes`` …) so real extender webhooks work
unmodified.  ``override_extenders_cfg_to_simulator`` rewrites the config
the way the reference does (service.go:88-109) so an *external* scheduler
can also be pointed at this simulator's /api/v1/extender/<verb>/<id>
endpoints; the in-process scheduler calls the Service directly (same
topological position, one fewer HTTP hop).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any

from kube_scheduler_simulator_tpu_torch.utils.gojson import go_marshal

Obj = dict[str, Any]

MAX_EXTENDER_PRIORITY = 10  # extenderv1.MaxExtenderPriority
MAX_NODE_SCORE = 100
DEFAULT_TIMEOUT_S = 5.0  # reference extender.go:22-24

EXTENDER_FILTER_RESULT = "scheduler-simulator/extender-filter-result"
EXTENDER_PRIORITIZE_RESULT = "scheduler-simulator/extender-prioritize-result"
EXTENDER_PREEMPT_RESULT = "scheduler-simulator/extender-preempt-result"
EXTENDER_BIND_RESULT = "scheduler-simulator/extender-bind-result"


class ExtenderError(Exception):
    """A non-ignorable extender failed (transport or body error); upstream
    fails the scheduling attempt in this case."""


class HTTPExtender:
    """One configured extender webhook (reference extender.go:55-199)."""

    def __init__(self, config: Obj):
        self.config = dict(config)
        self.url_prefix: str = config.get("urlPrefix") or ""
        self.filter_verb: str = config.get("filterVerb") or ""
        self.prioritize_verb: str = config.get("prioritizeVerb") or ""
        self.preempt_verb: str = config.get("preemptVerb") or ""
        self.bind_verb: str = config.get("bindVerb") or ""
        self.weight: int = int(config.get("weight") or 1)
        self.node_cache_capable: bool = bool(config.get("nodeCacheCapable"))
        # upstream: an ignorable extender's failures don't fail scheduling
        self.ignorable: bool = bool(config.get("ignorable"))
        self.managed_resources = {r.get("name") for r in config.get("managedResources") or []}
        timeout = config.get("httpTimeout")
        self.timeout_s = _parse_go_duration(timeout) if timeout else DEFAULT_TIMEOUT_S

    @property
    def name(self) -> str:
        return self.url_prefix

    def is_interested(self, pod: Obj) -> bool:
        """Upstream IsInterested: no managed resources → always."""
        if not self.managed_resources:
            return True
        for c in (pod.get("spec") or {}).get("containers") or []:
            for section in ("requests", "limits"):
                for r in ((c.get("resources") or {}).get(section) or {}):
                    if r in self.managed_resources:
                        return True
        return False

    def is_binder(self) -> bool:
        return bool(self.bind_verb)

    # ------------------------------------------------------------- verbs

    def filter(self, args: Obj) -> Obj:
        if not self.filter_verb:
            raise ValueError("filterVerb is empty")
        return self._send(self.filter_verb, args)

    def prioritize(self, args: Obj) -> list[Obj]:
        """Returns the webhook's response AS IS (raw [0,10] priorities —
        weight scaling happens at score-combination time in the cycle, so
        the recorded annotation and the proxy endpoint expose exactly what
        the extender returned)."""
        if not self.prioritize_verb:
            raise ValueError("prioritizeVerb is empty")
        return self._send(self.prioritize_verb, args) or []

    def preempt(self, args: Obj) -> Obj:
        if not self.preempt_verb:
            raise ValueError("preemptVerb is empty")
        return self._send(self.preempt_verb, args)

    def bind(self, args: Obj) -> Obj:
        if not self.bind_verb:
            raise ValueError("bindVerb is empty")
        return self._send(self.bind_verb, args)

    def _send(self, action: str, args: Any) -> Any:
        url = self.url_prefix.rstrip("/") + "/" + action
        req = urllib.request.Request(
            url,
            data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            if resp.status != 200:
                raise RuntimeError(f"failed {action} with extender at URL {url}, code {resp.status}")
            return json.loads(resp.read().decode() or "null")


class ExtenderResultStore:
    """Per-pod extender results → 4 annotations (reference
    extender/resultstore/resultstore.go)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._results: dict[str, dict[str, dict[str, Any]]] = {}

    @staticmethod
    def _pod_key(pod: Obj) -> str:
        from kube_scheduler_simulator_tpu_torch.utils.keys import pod_key

        return pod_key(pod)

    def _entry(self, pod: Obj) -> dict[str, dict[str, Any]]:
        k = self._pod_key(pod)
        if k not in self._results:
            self._results[k] = {"filter": {}, "prioritize": {}, "preempt": {}, "bind": {}}
        return self._results[k]

    def add_filter_result(self, args: Obj, result: Obj, host_name: str) -> None:
        with self._mu:
            self._entry(args["pod"])["filter"][host_name] = result

    def add_prioritize_result(self, args: Obj, result: Any, host_name: str) -> None:
        with self._mu:
            self._entry(args["pod"])["prioritize"][host_name] = result

    def add_preempt_result(self, args: Obj, result: Obj, host_name: str) -> None:
        with self._mu:
            self._entry(args["pod"])["preempt"][host_name] = result

    def add_bind_result(self, args: Obj, result: Obj, host_name: str) -> None:
        with self._mu:
            key = f"{args.get('podNamespace', 'default')}/{args.get('podName', '')}"
            if key not in self._results:
                self._results[key] = {"filter": {}, "prioritize": {}, "preempt": {}, "bind": {}}
            self._results[key]["bind"][host_name] = result

    # ResultStore interface for the shared store reflector:

    def get_stored_result(self, pod: Obj) -> dict[str, str]:
        with self._mu:
            e = self._results.get(self._pod_key(pod))
            if e is None:
                return {}
            out = {}
            for cat, anno_key in (
                ("filter", EXTENDER_FILTER_RESULT),
                ("prioritize", EXTENDER_PRIORITIZE_RESULT),
                ("preempt", EXTENDER_PREEMPT_RESULT),
                ("bind", EXTENDER_BIND_RESULT),
            ):
                if e[cat]:
                    out[anno_key] = go_marshal(e[cat])
            return out

    def has_result(self, pod: Obj) -> bool:
        with self._mu:
            return self._pod_key(pod) in self._results

    def delete_data(self, pod: Obj) -> None:
        with self._mu:
            self._results.pop(self._pod_key(pod), None)


EXTENDER_RESULT_STORE_KEY = "ExtenderResultStoreKey"


class ExtenderService:
    """Proxy + recorder for the configured extenders (reference
    extender/service.go:18-85)."""

    def __init__(self, extender_cfgs: "list[Obj] | None", reflector: Any = None):
        self.extenders = [HTTPExtender(c) for c in (extender_cfgs or [])]
        self.store = ExtenderResultStore()
        if reflector is not None:
            reflector.add_result_store(self.store, EXTENDER_RESULT_STORE_KEY)

    def filter(self, id_: int, args: Obj) -> Obj:
        result = self.extenders[id_].filter(args)
        self.store.add_filter_result(args, result, self.extenders[id_].name)
        return result

    def prioritize(self, id_: int, args: Obj) -> list[Obj]:
        result = self.extenders[id_].prioritize(args)
        self.store.add_prioritize_result(args, result, self.extenders[id_].name)
        return result

    def preempt(self, id_: int, args: Obj) -> Obj:
        result = self.extenders[id_].preempt(args)
        self.store.add_preempt_result(args, result, self.extenders[id_].name)
        return result

    def bind(self, id_: int, args: Obj) -> Obj:
        result = self.extenders[id_].bind(args)
        self.store.add_bind_result(args, result, self.extenders[id_].name)
        return result

    # ----------------------------------------------- scheduling-cycle hooks

    def run_filter(self, pod: Obj, feasible_nodes: list[Obj]) -> "tuple[list[Obj], dict[str, str]]":
        """findNodesThatPassExtenders: each extender narrows the feasible
        set; failed nodes carry reasons into the diagnosis.  A transport or
        body error fails the attempt (ExtenderError) unless the extender is
        marked ignorable — upstream findNodesThatPassExtenders semantics."""
        failed: dict[str, str] = {}
        nodes = feasible_nodes
        for i, ext in enumerate(self.extenders):
            if not ext.filter_verb or not nodes:
                continue
            if not ext.is_interested(pod):
                continue
            if ext.node_cache_capable:
                args = {"pod": pod, "nodenames": [n["metadata"]["name"] for n in nodes]}
            else:
                args = {"pod": pod, "nodes": {"items": nodes}}
            try:
                result = self.filter(i, args)
            except Exception as e:
                if ext.ignorable:
                    continue
                raise ExtenderError(f"extender {ext.name} filter: {e}") from e
            if result.get("error"):
                if ext.ignorable:
                    continue
                raise ExtenderError(f"extender {ext.name} filter: {result['error']}")
            by_name = {n["metadata"]["name"]: n for n in nodes}
            if result.get("nodenames") is not None:
                nodes = [by_name[nm] for nm in result["nodenames"] if nm in by_name]
            elif result.get("nodes") is not None:
                items = result["nodes"].get("items") or []
                nodes = [by_name[n["metadata"]["name"]] for n in items if n["metadata"]["name"] in by_name]
            for nm, reason in (result.get("failedNodes") or {}).items():
                failed[nm] = reason
            for nm, reason in (result.get("failedAndUnresolvableNodes") or {}).items():
                failed[nm] = reason
        return nodes, failed

    def run_prioritize(self, pod: Obj, feasible_nodes: list[Obj]) -> dict[str, int]:
        """prioritizeNodes' extender pass: raw [0,10] webhook priorities
        scaled by weight × MaxNodeScore/MaxExtenderPriority at combination
        time (upstream prioritizeNodes).  Errors here are always ignorable
        (upstream logs and skips failed prioritize calls)."""
        totals: dict[str, int] = {}
        for i, ext in enumerate(self.extenders):
            if not ext.prioritize_verb:
                continue
            if not ext.is_interested(pod):
                continue
            if ext.node_cache_capable:
                args = {"pod": pod, "nodenames": [n["metadata"]["name"] for n in feasible_nodes]}
            else:
                args = {"pod": pod, "nodes": {"items": feasible_nodes}}
            try:
                items = self.prioritize(i, args)
            except Exception:
                continue
            scale = ext.weight * (MAX_NODE_SCORE // MAX_EXTENDER_PRIORITY)
            for item in items:
                totals[item["host"]] = totals.get(item["host"], 0) + int(item["score"]) * scale
        return totals

    def run_preempt(
        self, pod: Obj, node_to_victims: dict[str, list[Obj]]
    ) -> dict[str, list[Obj]]:
        """Upstream Evaluator.callExtenders: each preempt-verb extender
        narrows the candidate node→victims map.  A failing extender is
        skipped when ignorable, otherwise the error propagates
        (ExtenderError) and the preemption attempt fails."""
        candidates = node_to_victims

        def _uid(v: Obj) -> str:
            return (
                v["metadata"].get("uid")
                or f"{v['metadata'].get('namespace', 'default')}/{v['metadata']['name']}"
            )

        for i, ext in enumerate(self.extenders):
            if not ext.preempt_verb or not candidates:
                continue
            if not ext.is_interested(pod):
                continue
            if ext.node_cache_capable:
                # upstream ProcessPreemption sends uid-only meta victims to
                # nodeCacheCapable extenders
                args: Obj = {
                    "pod": pod,
                    "nodeNameToMetaVictims": {
                        nm: {"pods": [{"uid": _uid(v)} for v in victims], "numPDBViolations": 0}
                        for nm, victims in candidates.items()
                    },
                }
            else:
                args = {
                    "pod": pod,
                    "nodeNameToVictims": {
                        nm: {"pods": victims, "numPDBViolations": 0}
                        for nm, victims in candidates.items()
                    },
                }
            try:
                result = self.preempt(i, args) or {}
            except Exception as e:
                if ext.ignorable:
                    continue
                raise ExtenderError(f"extender {ext.name} preempt: {e}") from e
            narrowed = result.get("nodeNameToVictims")
            if narrowed is None:
                narrowed = result.get("nodeNameToMetaVictims")
            if narrowed is None:
                continue  # extender expressed no opinion
            # an empty map is an explicit all-veto, not "no opinion"
            by_uid = {_uid(v): v for victims in candidates.values() for v in victims}

            def resolve(entry: Any) -> list[Obj]:
                pods = (entry or {}).get("pods") or []
                out: list[Obj] = []
                for p in pods:
                    if "metadata" in p:  # full victims response
                        out.append(p)
                    else:  # meta victims: {"uid": ...}
                        v = by_uid.get(p.get("uid", ""))
                        if v is not None:
                            out.append(v)
                return out

            # A node whose returned victims are empty/unresolvable is
            # dropped (upstream errors "expected at least one victim pod on
            # node"); victims the extender didn't approve are never used.
            candidates = {
                nm: victims
                for nm, entry in narrowed.items()
                if nm in candidates
                for victims in [resolve(entry)]
                if victims
            }
        return candidates

    def find_binder(self, pod: Obj) -> "tuple[int, HTTPExtender] | None":
        for i, ext in enumerate(self.extenders):
            if ext.is_binder() and ext.is_interested(pod):
                return i, ext
        return None


def override_extenders_cfg_to_simulator(cfg: Obj, simulator_port: int) -> None:
    """Rewrite extender configs to point at the simulator proxy endpoints
    (reference service.go:88-109) — used when an EXTERNAL scheduler should
    round-trip through this simulator's HTTP server."""
    for i, ext in enumerate(cfg.get("extenders") or []):
        ext["enableHTTPS"] = False
        ext.pop("tlsConfig", None)
        ext["urlPrefix"] = f"http://localhost:{simulator_port}/api/v1/extender/"
        for verb in ("filterVerb", "prioritizeVerb", "preemptVerb", "bindVerb"):
            if ext.get(verb):
                ext[verb] = f"{verb.removesuffix('Verb').lower()}/{i}"


def _parse_go_duration(d: Any) -> float:
    """Parse a metav1.Duration-ish value ("5s", "100ms", nanoseconds int)."""
    if isinstance(d, (int, float)):
        return float(d) / 1e9  # Go time.Duration marshals as nanoseconds
    s = str(d)
    units = {"ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0, "us": 1e-6, "µs": 1e-6, "ns": 1e-9}
    for suffix in ("ms", "us", "µs", "ns", "s", "m", "h"):
        if s.endswith(suffix):
            try:
                return float(s[: -len(suffix)]) * units[suffix]
            except ValueError:
                break
    return DEFAULT_TIMEOUT_S
