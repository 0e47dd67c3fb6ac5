"""Host feature encoder: cluster objects → dense batch-scheduling tensors.

The PyTorch port's copy of the JAX package's ``ops/encode.py``: ``encode``,
``pad_problem``, their helpers and the incremental ``EncodeCache``,
unchanged (the reference's ``objective_planes``, which only its tuner
reads, is left out).  It is the host boundary of the batch path: every
string-semantic the reference evaluates inside its per-node plugin calls
(label selectors, node-affinity terms, taints/tolerations, topology keys —
reference simulator/scheduler/plugin/wrappedplugin.go delegates these to the
upstream in-tree plugins) is evaluated HERE, once, on the host, memoized by
(spec signature × label signature), and lowered to dense matrices.  The
device only ever sees numbers.

Encoding layout (P = pending pods in queue order, N = nodes, R = resources):

Static per-(pod,node) features are FACTORED through equivalence classes —
pods grouped by constraint signature (toleration set, affinity spec,
preferred terms), nodes by taint/label signature — and shipped to the
device as small class matrices plus per-pod/per-node class-index vectors;
the scan kernel gathers them per pod row on the device (ops/batch.py
``expand_features`` is the plain [P,N] expansion).
Factoring matters: at 10k pods × 5k nodes the dense matrices are ~700 MB
of host→device traffic per round, the class form a few MB.
- ``taint_cls``        [L,T] int16  index of first untolerated NoSchedule/
                                   NoExecute taint (-1 = tolerated) per
                                   (toleration-class, taint-class)
- ``taint_prefer_cls`` [L,T] int16  count of untolerated PreferNoSchedule
                                   taints — TaintToleration score
- ``taint_unsched_cls``[L,T] bool   tolerates the unschedulable taint
- ``pod_tol_idx`` [P] / ``node_taint_idx`` [N]: class indices
- ``node_unsched``     [N]  bool   node.spec.unschedulable
- ``aff_code_cls``     [A,M] int8  0 pass / 1 enforced-affinity fail /
                                  2 pod-affinity fail — NodeAffinity filter
- ``incl_cls``         [A,M] bool  nodeSelector+requiredAffinity only —
                                  PodTopologySpread NodeInclusionPolicy mask
- ``aff_pref_cls``     [B,M] int32 matched preferred-term weight sum
- ``pod_aff_idx``/``pod_pref_idx`` [P], ``node_label_idx`` [N]: class indices
- ``name_target``      [P] int32  NodeName filter: -1 = unconstrained,
                                  node index, or -2 = named node absent

Dynamic state (the lax.scan carry in ops/batch.py) is seeded with:
- node ``requested``/``nonzero``/``pod_count`` from already-bound pods
- ``spread_node_counts`` [SG,N]: per unique (namespace, labelSelector)
  spread-constraint group, # matching pods per NODE (per-node, so the
  per-pod NodeInclusionPolicy mask stays exact)
- inter-pod affinity term-group counts [G,D] over topology DOMAINS
  (a domain = one (topologyKey, value) pair; hostname keys make one
  domain per node)

Resource quantities are divided by their per-resource GCD so that float32
device math stays exact for Mi/milli-granular workloads; all score formulas
are scale-invariant ratios.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import numpy as np

from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo, build_node_infos
from kube_scheduler_simulator_tpu_torch.plugins.intree.helpers import affinity_term_matches_pod
from kube_scheduler_simulator_tpu_torch.plugins.intree.noderesources import (
    DEFAULT_MEMORY_REQUEST,
    DEFAULT_MILLI_CPU_REQUEST,
    pod_non_zero_request,
)
from kube_scheduler_simulator_tpu_torch.models.podresources import (
    CPU,
    EPHEMERAL_STORAGE,
    MEMORY,
    PODS,
    is_fit_resource,
    pod_resource_request,
)
from kube_scheduler_simulator_tpu_torch.utils.labels import (
    find_untolerated_taint,
    match_label_selector,
    match_node_selector,
    match_node_selector_term,
    tolerations_tolerate_taint,
)

Obj = dict[str, Any]

HOSTNAME_KEY = "kubernetes.io/hostname"


def _sig(obj: Any) -> str:
    """Signature for memoizing selector evaluation and grouping equal
    specs.  Used ONLY for deduplication — two semantically equal objects
    that disagree on dict key order just land in separate (still-correct)
    equivalence classes — so the fast non-canonical ``repr`` beats
    canonical JSON (~4× cheaper, and this runs per pod per round)."""
    return repr(obj)


def _group(items: list[Any], keyfn: Callable[[Any], str]) -> "tuple[list[Any], np.ndarray]":
    """Unique representatives + index of each item into them."""
    reps: list[Any] = []
    index: dict[str, int] = {}
    idx = np.empty(len(items), dtype=np.int32)
    for i, it in enumerate(items):
        k = keyfn(it)
        j = index.get(k)
        if j is None:
            j = len(reps)
            index[k] = j
            reps.append(it)
        idx[i] = j
    return reps, idx


def _fit_from_request(req: dict[str, int]) -> dict[str, int]:
    """Nonzero requests for the resources NodeResourcesFit checks
    (models/podresources.is_fit_resource — shared with the sequential
    plugin)."""
    return {r: v for r, v in req.items() if v != 0 and is_fit_resource(r)}


def gcd_scale_columns(columns: "list[np.ndarray]") -> None:
    """Divide every array in ``columns`` by their joint GCD, in place, so
    float32 device math stays exact for Mi/milli-granular workloads (the
    score formulas are ratio-based, hence scale-invariant).  The ONE
    implementation both encoders use — ops/encode (batch kernel columns)
    and preemption/encode (victim-search columns) — so incremental
    re-scaling can never drift between them (parity-pinned by
    tests/test_encode_incremental.py)."""
    g = 0
    for arr in columns:
        if arr.size:
            g = math.gcd(g, int(np.gcd.reduce(np.abs(arr.reshape(-1)), initial=0)))
    g = g or 1
    for arr in columns:
        arr //= g


def _node_label_reps(node_labels: "list[dict]", node_names: "list[str]"):
    """Node label classes for the affinity/volume matrices — keyed by
    (labels, name) because match_node_selector can match metadata.name
    fields.  Shared by the cold encode pass and EncodeCache priming."""
    return _group(
        [{"labels": node_labels[i], "name": node_names[i]} for i in range(len(node_names))],
        lambda x: _sig(sorted(x["labels"].items())) + "|" + x["name"],
    )


def _node_image_tables(nodes: "list[Obj]"):
    """(node_image_sets, img_states, nimg_reps, nimg_idx) — the node side
    of the ImageLocality class matrices.  Shared by the cold encode pass
    and EncodeCache priming."""
    node_image_sets = [
        tuple(
            sorted(
                {
                    nm
                    for img in (n.get("status") or {}).get("images") or []
                    for nm in img.get("names") or []
                }
            )
        )
        for n in nodes
    ]
    img_states: dict[str, tuple[int, int]] = {}
    for n in nodes:
        for img in (n.get("status") or {}).get("images") or []:
            size = int(img.get("sizeBytes") or 0)
            for nm in img.get("names") or []:
                sz, cnt = img_states.get(nm, (size, 0))
                img_states[nm] = (sz, cnt + 1)
    nimg_reps, nimg_idx = _group(node_image_sets, repr)
    return node_image_sets, img_states, nimg_reps, nimg_idx


def _frozen_cls_rep(p: Obj) -> Obj:
    """Minimal immutable stand-in for a pod in the PERSISTENT equivalence
    class table (EncodeCache): the spread/inter-pod selectors read only
    the namespace, labels and terminating flag of a matched pod
    (match_label_selector + helpers.affinity_term_matches_pod), so the
    table never holds references into live store objects."""
    meta = p["metadata"]
    frozen: Obj = {
        "namespace": meta.get("namespace", "default"),
        "labels": dict(meta.get("labels") or {}),
    }
    if meta.get("deletionTimestamp"):
        frozen["deletionTimestamp"] = meta["deletionTimestamp"]
    return {"metadata": frozen}


def _fit_resources(pod: Obj) -> dict[str, int]:
    return _fit_from_request(pod_resource_request(pod))


class SpreadConstraint:
    __slots__ = ("key_idx", "group", "max_skew", "self_match")

    def __init__(self, key_idx: int, group: int, max_skew: int, self_match: bool):
        self.key_idx = key_idx
        self.group = group
        self.max_skew = max_skew
        self.self_match = self_match


class BatchProblem:
    """All arrays the batch kernel needs, as numpy (host) arrays.

    ops/batch.py ``lower`` turns it into device tensors.
    """

    def __init__(self) -> None:
        self.P = 0
        self.N = 0
        self.R = 0
        self.node_names: list[str] = []
        self.pod_keys: list[str] = []
        self.resource_names: list[str] = []
        # filled by encode()


def _namespace_of(pod: Obj) -> str:
    return pod["metadata"].get("namespace", "default")


class _Memo:
    """Memoized selector matchers shared across the encoding pass.

    Signatures are themselves cached by object identity — the same
    selector/term/pod dicts are matched against thousands of partners, and
    re-serializing them per pair dominates encoding time at 10k pods."""

    def __init__(self, ns_labels: Mapping[str, Mapping[str, str]]):
        self.ns_labels = ns_labels
        self._label_sel: dict[tuple[str, str], bool] = {}
        self._term: dict[tuple[str, str, str], bool] = {}
        self._sig_by_id: dict[int, str] = {}
        self._lsig_by_id: dict[int, str] = {}

    def sig_of(self, obj: Any) -> str:
        k = id(obj)
        v = self._sig_by_id.get(k)
        if v is None:
            v = _sig(obj)
            self._sig_by_id[k] = v
        return v

    def label_sig_of(self, obj_with_meta: Obj) -> str:
        """Label signature of a pod/node object, keyed by object identity."""
        k = id(obj_with_meta)
        v = self._lsig_by_id.get(k)
        if v is None:
            v = _sig(sorted((obj_with_meta["metadata"].get("labels") or {}).items()))
            self._lsig_by_id[k] = v
        return v

    def label_selector(self, sel: "Obj | None", pod: Obj) -> bool:
        k = (self.sig_of(sel), self.label_sig_of(pod))
        v = self._label_sel.get(k)
        if v is None:
            v = match_label_selector(sel, pod["metadata"].get("labels") or {})
            self._label_sel[k] = v
        return v

    def affinity_term(self, term: Obj, owner_ns: str, target: Obj) -> bool:
        k = (self.sig_of(term) + "|" + owner_ns,
             self.label_sig_of(target),
             _namespace_of(target))
        v = self._term.get(k)
        if v is None:
            v = affinity_term_matches_pod(term, owner_ns, target, self.ns_labels)
            self._term[k] = v
        return v


def encode(
    nodes: list[Obj],
    all_pods: list[Obj],
    pending: list[Obj],
    namespaces: "list[Obj] | None" = None,
    hard_pod_affinity_weight: int = 1,
    added_affinity: "Obj | None" = None,
    volumes: "dict[str, list[Obj]] | None" = None,
    nominated: "list[tuple[Obj, str]] | None" = None,
    seed: "EncodeCache | None" = None,
    rows: "EncodeCache | None" = None,
    node_infos: "list[NodeInfo] | None" = None,
) -> BatchProblem:
    """Encode a scheduling snapshot.

    ``pending`` must already be in queue (QueueSort) order; ``all_pods`` is
    the full pod list (bound pods seed the node usage state, mirroring the
    oracle's build_node_infos snapshot).  ``volumes`` carries the volume
    resource kinds the volume-plugin kernels resolve on the host
    (persistentvolumeclaims / persistentvolumes / storageclasses /
    csinodes, keyed by store kind); omitted kinds encode as empty.

    ``nominated``: (pod, node_name) pairs for UNBOUND pods holding a
    preemption nomination whose reservation every pending pod must
    respect (upstream RunFilterPluginsWithNominatedPods).  Their resource
    requests and pod count seed the FILTER state only (``requested0`` /
    ``pod_count0``) — never ``nonzero0`` — because upstream scores nodes
    without nominated pods.  Callers are responsible for the gate
    (scheduler/service): every pending pod's priority must be <= every
    nominee's, and neither side may carry ports/volumes/required
    (anti-)affinity/required spread, so the filter-only, always-accounted
    model is exact (Fit is monotone: passing WITH the nominee implies
    passing without).

    ``seed``: a primed :class:`EncodeCache` whose gates all passed — the
    bound-pod-derived state (node usage planes, pod class counts, seed
    tables) comes from the cache's incrementally-maintained aggregates
    instead of an O(all-pods) ``build_node_infos`` scan, and the
    class-matrix rows are served from the cache's per-signature row
    caches.  Every other branch runs the SAME code as the cold path, so
    seeded and cold encodes of the same snapshot are value-identical.

    ``rows``: the row caches alone (a just-primed EncodeCache) — a COLD
    encode fills/serves them so the first delta wave after a fallback
    doesn't re-pay every class-matrix row.  Row content is a pure
    function of (spec signature × the node tables), and the cache is
    emptied whenever the node tables change, so serving a cached row is
    exactly the cold computation.  Implied by ``seed``.
    """
    pr = BatchProblem()
    P, N = len(pending), len(nodes)
    pr.P, pr.N = P, N
    pr.node_names = [n["metadata"]["name"] for n in nodes]
    pr.pod_keys = [f"{_namespace_of(p)}/{p['metadata']['name']}" for p in pending]
    ns_labels = {
        ns["metadata"]["name"]: ns["metadata"].get("labels") or {} for ns in (namespaces or [])
    }
    memo = _Memo(ns_labels)
    if seed is not None:
        rows = seed
        node_infos = None
    elif node_infos is None:
        # ``node_infos``: a caller-precomputed snapshot (EncodeCache's
        # state-gate fallback shares ONE build with its re-prime)
        node_infos = build_node_infos(nodes, all_pods)

    # ------------------------------------------------------------- resources
    # Pods repeat identical resource shapes (same container templates);
    # parse each DISTINCT (containers, initContainers, overhead) signature
    # once — at 10k pods this collapses ~20 µs of quantity parsing per pod
    # into one dict hit.
    req_memo: dict[str, tuple] = {}

    def _pod_resources(p: Obj) -> tuple:
        spec = p.get("spec") or {}
        k = (
            memo.sig_of(spec.get("containers") or ())
            + "|"
            + memo.sig_of(spec.get("initContainers") or ())
            + "|"
            + memo.sig_of(spec.get("overhead") or ())
        )
        v = req_memo.get(k)
        if v is None:
            req = pod_resource_request(p)
            nz = pod_non_zero_request(p)
            v = (req, _fit_from_request(req), (nz[CPU], nz[MEMORY]))
            req_memo[k] = v
        return v

    res_of = [_pod_resources(p) for p in pending]
    req_of = [r[0] for r in res_of]
    fit_of = [r[1] for r in res_of]
    res_set: set[str] = {CPU, MEMORY}
    for fr in fit_of:
        res_set |= set(fr)
    pr.resource_names = sorted(res_set)
    res_idx = {r: i for i, r in enumerate(pr.resource_names)}
    R = pr.R = len(pr.resource_names)

    if seed is not None:
        # Delta path: the bound-pod usage aggregates are maintained
        # incrementally (EncodeCache); the dense planes are rebuilt from
        # the per-node dicts because the resource AXIS depends on the
        # pending pods' fit set.
        alloc, requested0, nonzero0, nz_alloc, pod_count0, max_pods = seed._node_planes(res_idx, R)
    else:
        alloc = np.zeros((N, R), dtype=np.int64)
        requested0 = np.zeros((N, R), dtype=np.int64)
        nonzero0 = np.zeros((N, 2), dtype=np.int64)
        nz_alloc = np.zeros((N, 2), dtype=np.int64)
        pod_count0 = np.zeros(N, dtype=np.int64)
        max_pods = np.zeros(N, dtype=np.int64)
        for ni_i, ni in enumerate(node_infos):
            for r, v in ni.allocatable.items():
                if r in res_idx:
                    alloc[ni_i, res_idx[r]] = v
            max_pods[ni_i] = ni.allowed_pod_number()
            pod_count0[ni_i] = len(ni.pods)
            for r, v in ni.requested.items():
                if r in res_idx:
                    requested0[ni_i, res_idx[r]] = v
            cpu = mem = 0
            for p in ni.pods:
                _req, _fit, (nz_cpu, nz_mem) = _pod_resources(p)
                cpu += nz_cpu
                mem += nz_mem
            nonzero0[ni_i] = (cpu, mem)
            nz_alloc[ni_i] = (ni.allocatable.get(CPU, 0), ni.allocatable.get(MEMORY, 0))

    if nominated:
        name_to_idx = {nm: j for j, nm in enumerate(pr.node_names)}
        for npod, nn in nominated:
            j = name_to_idx.get(nn)
            if j is None:
                continue
            pod_count0[j] += 1
            for r, v in pod_resource_request(npod).items():
                if r in res_idx:
                    requested0[j, res_idx[r]] += v

    pod_req = np.zeros((P, R), dtype=np.int64)
    pod_nonzero = np.zeros((P, 2), dtype=np.int64)
    for i, p in enumerate(pending):
        for r, v in req_of[i].items():
            if r in res_idx:
                pod_req[i, res_idx[r]] = v
        pod_nonzero[i] = res_of[i][2]
    # fit_checked: which resource columns the Fit filter checks for this pod
    # (want > 0 and an upstream-checked resource name); fit_order keeps the
    # pod-manifest iteration order for byte-identical failure messages
    fit_checked = np.zeros((P, R), dtype=bool)
    fit_order: list[list[int]] = []
    for i, p in enumerate(pending):
        cols = [res_idx[r] for r in fit_of[i]]
        for c in cols:
            fit_checked[i, c] = True
        fit_order.append(cols)
    pr.fit_order = fit_order

    # GCD-scale each resource column so float32 stays exact on-device
    # (gcd_scale_columns — the implementation shared with the preemption
    # encoder).
    for r in range(R):
        gcd_scale_columns([alloc[:, r], requested0[:, r], pod_req[:, r]])
    for c in (0, 1):
        gcd_scale_columns([nonzero0[:, c], pod_nonzero[:, c], nz_alloc[:, c]])

    pr.alloc, pr.requested0, pr.pod_count0, pr.max_pods = alloc, requested0, pod_count0, max_pods
    pr.nonzero0, pr.nz_alloc = nonzero0, nz_alloc
    pr.pod_req, pr.pod_nonzero, pr.fit_checked = pod_req, pod_nonzero, fit_checked

    # --------------------------------------------- static [P,N] matrices
    node_labels = [n["metadata"].get("labels") or {} for n in nodes]
    node_taints = [(n.get("spec") or {}).get("taints") or [] for n in nodes]
    node_unsched = np.array(
        [bool((n.get("spec") or {}).get("unschedulable")) for n in nodes], dtype=bool
    )

    # Taints: group pods by toleration signature, nodes by taint signature.
    tol_reps, tol_idx = _group(
        [(p.get("spec") or {}).get("tolerations") or [] for p in pending], _sig
    )
    if seed is not None:
        taint_reps, taint_idx = seed.taint_reps, seed.taint_idx
    else:
        taint_reps, taint_idx = _group(node_taints, _sig)
    tf = np.full((len(tol_reps), len(taint_reps)), -1, dtype=np.int16)
    tp = np.zeros((len(tol_reps), len(taint_reps)), dtype=np.int16)
    tu = np.ones((len(tol_reps), len(taint_reps)), dtype=bool)  # unschedulable-toleration
    tol_rows = rows.tol_rows if rows is not None else None
    for a, tols in enumerate(tol_reps):
        if tol_rows is not None:
            hit = tol_rows.get(_sig(tols))
            if hit is not None:
                tf[a], tp[a], tu[a] = hit
                continue
        prefer_tols = [t for t in tols if not t.get("effect") or t.get("effect") == "PreferNoSchedule"]
        unsched_taint = {"key": "node.kubernetes.io/unschedulable", "effect": "NoSchedule"}
        tolerates_unsched = tolerations_tolerate_taint(tols, unsched_taint)
        for b, taints in enumerate(taint_reps):
            bad = find_untolerated_taint(taints, tols)
            if bad is not None:
                tf[a, b] = taints.index(bad)
            tp[a, b] = sum(
                1
                for t in taints
                if t.get("effect") == "PreferNoSchedule"
                and not tolerations_tolerate_taint(prefer_tols, t)
            )
            tu[a, b] = tolerates_unsched
        if tol_rows is not None:
            tol_rows[_sig(tols)] = (tf[a].copy(), tp[a].copy(), tu[a].copy())
            rows.rows_miss += 1
    pr.taint_cls, pr.taint_prefer_cls = tf, tp
    # NodeUnschedulable: fails unless the pod tolerates the unschedulable
    # taint (upstream nodeunschedulable.go) — the kernel combines
    # taint_unsched_cls with node_unsched on-device.
    pr.taint_unsched_cls = tu
    pr.pod_tol_idx = tol_idx
    pr.node_taint_idx = taint_idx
    pr.node_unsched = node_unsched

    # NodeAffinity + nodeSelector (+ plugin-level addedAffinity), and the
    # spread inclusion mask (no addedAffinity).
    def _aff_spec(p: Obj) -> Obj:
        spec = p.get("spec") or {}
        aff = ((spec.get("affinity") or {}).get("nodeAffinity") or {}).get(
            "requiredDuringSchedulingIgnoredDuringExecution"
        )
        return {"sel": spec.get("nodeSelector"), "req": aff}

    aff_reps, aff_idx = _group([_aff_spec(p) for p in pending], _sig)
    if seed is not None:
        nl_reps, nl_idx = seed.nl_reps, seed.nl_idx
    else:
        nl_reps, nl_idx = _node_label_reps(node_labels, pr.node_names)
    ac = np.zeros((len(aff_reps), len(nl_reps)), dtype=np.int8)
    inc = np.ones((len(aff_reps), len(nl_reps)), dtype=bool)
    aff_rows = rows.aff_rows if rows is not None else None
    for a, spec in enumerate(aff_reps):
        if aff_rows is not None:
            hit = aff_rows.get(_sig(spec))
            if hit is not None:
                ac[a], inc[a] = hit
                continue
        for b, nl in enumerate(nl_reps):
            labels, name = nl["labels"], nl["name"]
            ok = True
            if added_affinity is not None and not match_node_selector(added_affinity, labels, name):
                ac[a, b] = 1
                ok = False
            if ok and spec["sel"]:
                if any(labels.get(k) != v for k, v in spec["sel"].items()):
                    ac[a, b] = 2
                    ok = False
            if ok and spec["req"] is not None and not match_node_selector(spec["req"], labels, name):
                ac[a, b] = 2
            # inclusion ignores addedAffinity
            iok = True
            if spec["sel"] and any(labels.get(k) != v for k, v in spec["sel"].items()):
                iok = False
            if iok and spec["req"] is not None and not match_node_selector(spec["req"], labels, name):
                iok = False
            inc[a, b] = iok
        if aff_rows is not None:
            aff_rows[_sig(spec)] = (ac[a].copy(), inc[a].copy())
            rows.rows_miss += 1
    pr.aff_code_cls, pr.incl_cls = ac, inc
    pr.pod_aff_idx = aff_idx
    pr.node_label_idx = nl_idx

    # Preferred node-affinity weights.
    pref_reps, pref_idx = _group(
        [
            (((p.get("spec") or {}).get("affinity") or {}).get("nodeAffinity") or {}).get(
                "preferredDuringSchedulingIgnoredDuringExecution"
            )
            or []
            for p in pending
        ],
        _sig,
    )
    ap = np.zeros((len(pref_reps), len(nl_reps)), dtype=np.int32)
    pref_rows = rows.pref_rows if rows is not None else None
    for a, prefs in enumerate(pref_reps):
        if pref_rows is not None:
            hit = pref_rows.get(_sig(prefs))
            if hit is not None:
                ap[a] = hit
                continue
        for b, nl in enumerate(nl_reps):
            total = 0
            for item in prefs:
                w = int(item.get("weight") or 0)
                if w and match_node_selector_term(item.get("preference") or {}, nl["labels"], nl["name"]):
                    total += w
            ap[a, b] = total
        if pref_rows is not None:
            pref_rows[_sig(prefs)] = ap[a].copy()
            rows.rows_miss += 1
    pr.aff_pref_cls = ap
    pr.pod_pref_idx = pref_idx

    # ImageLocality: the score is pure per-(pod, node) — no carry
    # dependence — so the COMPLETE upstream score (size×spread summed over
    # the pod's container images, thresholded to [0,100]) is computed here
    # per (container-image-list class × node-image-set class) and expanded
    # on-device like the other factored features.
    from kube_scheduler_simulator_tpu_torch.plugins.intree.imagelocality import (
        _normalized_image_name,
        score_from_total,
    )

    if seed is not None:
        img_states, nimg_reps, nimg_idx = seed.img_states, seed.nimg_reps, seed.nimg_idx
        nimg_sets = seed.nimg_sets
    else:
        _node_image_sets, img_states, nimg_reps, nimg_idx = _node_image_tables(nodes)
        nimg_sets = None  # built lazily below (only when images exist)
    pod_image_lists = [
        tuple(
            _normalized_image_name(c.get("image") or "")
            for c in (p.get("spec") or {}).get("containers") or []
        )
        for p in pending
    ]
    pimg_reps, pimg_idx = _group(pod_image_lists, repr)
    img_cls = np.zeros((len(pimg_reps), len(nimg_reps)), dtype=np.int8)
    if img_states:  # all-zero when no node publishes images
        if nimg_sets is None:
            nimg_sets = [set(ns) for ns in nimg_reps]
        img_rows = rows.img_rows if rows is not None else None
        for a, images in enumerate(pimg_reps):
            if img_rows is not None:
                hit = img_rows.get(repr(images))
                if hit is not None:
                    img_cls[a] = hit
                    continue
            for b, nset_s in enumerate(nimg_sets):
                total = 0
                for nm in images:
                    if nm in nset_s and nm in img_states:
                        size, cnt = img_states[nm]
                        total += int(size * cnt / N) if N else 0
                img_cls[a, b] = score_from_total(total, len(images))
            if img_rows is not None:
                img_rows[repr(images)] = img_cls[a].copy()
                rows.rows_miss += 1
    pr.img_cls = img_cls
    pr.pod_img_idx = pimg_idx
    pr.node_img_idx = nimg_idx

    # NodePorts: port classes are the distinct (protocol, hostIP,
    # hostPort) triples PENDING pods want — PT stays bounded by the
    # pending workload regardless of how many bound pods hold ports.
    # Everything else is projected INTO that class space through the
    # conflict relation (0.0.0.0 overlaps any IP):
    #   ports_used0[n, w] = # occupying triples on node n conflicting
    #                       with wanted class w
    #   commit adds C @ pod_ports[i] (the committed pod's triples are
    #   themselves pending classes; C maps them to every class they
    #   conflict with)
    # and the filter is simply clash[n] = Σ_w pod_ports[i][w]·used[n][w].
    from kube_scheduler_simulator_tpu_torch.plugins.intree.node_basic import (
        _host_ports,
        _ports_conflict,
    )

    port_table: dict[tuple, int] = {}
    pend_port_ids: list[list[int]] = []
    for p in pending:
        ids = []
        for t in _host_ports(p):
            if t not in port_table:
                port_table[t] = len(port_table)
            ids.append(port_table[t])
        pend_port_ids.append(ids)
    PT = len(port_table)
    pr.PT = PT
    # the EncodeCache gate rejects pending host-port workloads, so the
    # bound-pod port scan below never runs without node_infos
    assert seed is None or PT == 0, "seeded encode cannot carry host-port state"
    pod_ports = np.zeros((P, max(PT, 1)), dtype=bool)
    for i, ids in enumerate(pend_port_ids):
        for t in ids:
            pod_ports[i, t] = True
    triples = list(port_table)
    ports_used0 = np.zeros((N, max(PT, 1)), dtype=np.int64)
    if PT:
        # conflict requires equal (protocol, port), so index the wanted
        # classes by that pair — each bound triple then checks at most a
        # handful of candidates instead of all PT classes
        by_proto_port: dict[tuple, list[int]] = {}
        for w, (proto, _ip, port) in enumerate(triples):
            by_proto_port.setdefault((proto, port), []).append(w)
        for n_i, ni in enumerate(node_infos):
            for bp in ni.pods:
                for bt in _host_ports(bp):
                    for w in by_proto_port.get((bt[0], bt[2]), ()):
                        if _ports_conflict(bt, triples[w]):
                            ports_used0[n_i, w] += 1
    port_conflict = np.zeros((max(PT, 1), max(PT, 1)), dtype=bool)
    for a, ta in enumerate(triples):
        for b, tb in enumerate(triples):
            port_conflict[a, b] = _ports_conflict(ta, tb)
    pr.pod_ports, pr.ports_used0, pr.port_conflict = pod_ports, ports_used0, port_conflict

    # Volume plugins (VolumeBinding/VolumeZone static class matrices;
    # VolumeRestrictions + the NodeVolumeLimits family dynamic classes).
    _encode_volumes(pr, pending, node_infos, nl_reps, volumes or {}, N)

    # NodeName: target node index (-1 unconstrained, -2 named node absent)
    name_to_idx = {nm: i for i, nm in enumerate(pr.node_names)}
    name_target = np.full(P, -1, dtype=np.int32)
    for i, p in enumerate(pending):
        want = (p.get("spec") or {}).get("nodeName")
        if want:
            name_target[i] = name_to_idx.get(want, -2)
    pr.name_target = name_target

    # ------------------------------------------------------ topology domains
    topo_keys: list[str] = []

    def key_id(k: str) -> int:
        if k not in topo_keys:
            topo_keys.append(k)
        return topo_keys.index(k)

    # collect keys used by spread constraints & interpod terms of pending pods
    for p in pending:
        for c in (p.get("spec") or {}).get("topologySpreadConstraints") or []:
            key_id(c["topologyKey"])
        aff = (p.get("spec") or {}).get("affinity") or {}
        for kind in ("podAffinity", "podAntiAffinity"):
            a = aff.get(kind) or {}
            for t in a.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
                key_id(t.get("topologyKey", ""))
            for t in a.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
                key_id((t.get("podAffinityTerm") or {}).get("topologyKey", ""))
    # ... and by existing pods' terms (they poison/score toward pending
    # pods).  Seeded encodes skip the scan: the cache gate guarantees no
    # bound pod carries inter-pod affinity terms, so the scan would
    # contribute nothing.
    if seed is None:
        for ni in node_infos:
            for p in ni.pods:
                aff = (p.get("spec") or {}).get("affinity") or {}
                for kind in ("podAffinity", "podAntiAffinity"):
                    a = aff.get(kind) or {}
                    for t in a.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
                        key_id(t.get("topologyKey", ""))
                    for t in a.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
                        key_id((t.get("podAffinityTerm") or {}).get("topologyKey", ""))

    # Global domain numbering, contiguous per key.  Keys whose values are
    # UNIQUE per node (hostname-like bijections) get the identity layout
    # dom[n] = base + n, which lets the batch kernel expand/collapse
    # domain vectors with array slices instead of [D,N] one-hot streams
    # (ops/batch.py key_info).
    KT = len(topo_keys)
    node_domain = np.full((max(KT, 1), N), -1, dtype=np.int32)
    key_base: list[int] = []
    key_identity: list[bool] = []
    next_id = 0
    for ki, key in enumerate(topo_keys):
        values = [labels.get(key) for labels in node_labels]
        present = [v for v in values if v is not None]
        bijective = len(present) > 0 and len(set(present)) == len(present)
        key_base.append(next_id)
        key_identity.append(bijective)
        if bijective:
            for n_i, v in enumerate(values):
                if v is not None:
                    node_domain[ki, n_i] = next_id + n_i
            next_id += N  # reserve the full range to keep the identity map
        else:
            interned: dict[str, int] = {}
            for n_i, v in enumerate(values):
                if v is not None:
                    if v not in interned:
                        interned[v] = next_id
                        next_id += 1
                    node_domain[ki, n_i] = interned[v]
    D = max(next_id, 1)
    pr.topo_keys, pr.node_domain, pr.D = topo_keys, node_domain, D
    pr.key_base, pr.key_identity = key_base, key_identity

    # --------------------------------------------------- PodTopologySpread
    sg_table: dict[str, int] = {}
    sg_specs: list[tuple[str, "Obj | None"]] = []  # (namespace, selector)

    def spread_group(ns: str, sel: "Obj | None") -> int:
        k = ns + "|" + memo.sig_of(sel)
        if k not in sg_table:
            sg_table[k] = len(sg_specs)
            sg_specs.append((ns, sel))
        return sg_table[k]

    pod_spread_filter: list[list[SpreadConstraint]] = []
    pod_spread_score: list[list[SpreadConstraint]] = []
    for i, p in enumerate(pending):
        ns = _namespace_of(p)
        fl, sl = [], []
        for c in (p.get("spec") or {}).get("topologySpreadConstraints") or []:
            sc = SpreadConstraint(
                key_id(c["topologyKey"]),
                spread_group(ns, c.get("labelSelector")),
                int(c.get("maxSkew") or 1),
                memo.label_selector(c.get("labelSelector"), p),
            )
            (fl if c.get("whenUnsatisfiable") == "DoNotSchedule" else sl).append(sc)
        pod_spread_filter.append(fl)
        pod_spread_score.append(sl)

    # Pod equivalence classes over (label signature, namespace,
    # terminating): spread/inter-pod selectors see pods only through
    # these, so each (selector, class) pair is evaluated ONCE and
    # expanded by indexing — at 10k pods the per-(group × pod) memo
    # lookups otherwise dominate encoding.  Seeded encodes share the
    # cache's APPEND-ONLY table (ids are internal, results are
    # permutation-invariant) and its incrementally-maintained per-node
    # class counts instead of re-classifying every bound pod.
    if seed is not None:
        cls_index, cls_reps = seed.cls_index, seed.cls_reps
        _cls_rep_of = _frozen_cls_rep
    else:
        cls_index = {}
        cls_reps = []
        _cls_rep_of = None

    def pod_cls(p: Obj) -> int:
        k = (
            memo.label_sig_of(p)
            + "|"
            + _namespace_of(p)
            + ("|T" if p["metadata"].get("deletionTimestamp") else "|F")
        )
        c = cls_index.get(k)
        if c is None:
            c = len(cls_reps)
            cls_index[k] = c
            cls_reps.append(p if _cls_rep_of is None else _cls_rep_of(p))
        return c

    # topo_keys is empty iff NO pod (pending or bound) carries spread or
    # inter-pod affinity constraints — the only consumers of the classes;
    # skip the full-cluster classification pass for such workloads
    if topo_keys:
        pend_cls = np.fromiter((pod_cls(p) for p in pending), dtype=np.int64, count=P)
        if seed is not None:
            node_cls_counts = seed.node_cls_counts
        else:
            node_cls_counts = []
            for ni in node_infos:
                ccnt: dict[int, int] = {}
                for ep in ni.pods:
                    c = pod_cls(ep)
                    ccnt[c] = ccnt.get(c, 0) + 1
                node_cls_counts.append(ccnt)
    else:
        pend_cls = np.zeros(P, dtype=np.int64)
        node_cls_counts = seed.node_cls_counts if seed is not None else [{} for _ in range(N)]

    SG = len(sg_specs)
    spread_match = np.zeros((max(SG, 1), P), dtype=bool)
    spread_counts0 = np.zeros((max(SG, 1), N), dtype=np.int64)
    for s, (ns, sel) in enumerate(sg_specs):
        m_cls = np.zeros(max(len(cls_reps), 1), dtype=bool)
        for c, rp in enumerate(cls_reps):
            m_cls[c] = (
                _namespace_of(rp) == ns
                and not rp["metadata"].get("deletionTimestamp")
                and memo.label_selector(sel, rp)
            )
        spread_match[s] = m_cls[pend_cls]
        for n_i, ccnt in enumerate(node_cls_counts):
            if ccnt:
                spread_counts0[s, n_i] = sum(k for c, k in ccnt.items() if m_cls[c])
    pr.SG = SG
    pr.spread_match = spread_match
    pr.spread_counts0 = spread_counts0

    KC = max((len(x) for x in pod_spread_filter), default=0)
    KS = max((len(x) for x in pod_spread_score), default=0)

    def pad_constraints(lists: list[list[SpreadConstraint]], K: int):
        key = np.full((P, max(K, 1)), -1, dtype=np.int32)
        grp = np.full((P, max(K, 1)), 0, dtype=np.int32)
        skew = np.ones((P, max(K, 1)), dtype=np.int64)
        selfm = np.zeros((P, max(K, 1)), dtype=bool)
        for i, lst in enumerate(lists):
            for k, c in enumerate(lst):
                key[i, k] = c.key_idx
                grp[i, k] = c.group
                skew[i, k] = c.max_skew
                selfm[i, k] = c.self_match
        return key, grp, skew, selfm

    pr.spf_key, pr.spf_group, pr.spf_skew, pr.spf_self = pad_constraints(pod_spread_filter, KC)
    pr.sps_key, pr.sps_group, pr.sps_skew, pr.sps_self = pad_constraints(pod_spread_score, KS)
    pr.KC, pr.KS = KC, KS

    # ----------------------------------------------------- InterPodAffinity
    # Term groups: (topologyKey, namespace-scope, labelSelector).  One group
    # can be referenced by many pods'/terms' — counts are shared.
    g_table: dict[str, int] = {}
    g_terms: list[tuple[Obj, str]] = []  # (term, owner_ns)
    g_key = []  # key idx per group

    def term_group(term: Obj, owner_ns: str) -> int:
        namespaces = term.get("namespaces") or []
        ns_sel = term.get("namespaceSelector")
        if namespaces or ns_sel is not None:
            scope = _sig({"ns": sorted(namespaces), "sel": ns_sel})
        else:
            scope = "same:" + owner_ns
        k = _sig({"key": term.get("topologyKey", ""), "sel": term.get("labelSelector")}) + "|" + scope
        if k not in g_table:
            g_table[k] = len(g_terms)
            g_terms.append((term, owner_ns))
            g_key.append(key_id(term.get("topologyKey", "")))
        return g_table[k]

    def pod_terms(p: Obj):
        aff = (p.get("spec") or {}).get("affinity") or {}
        pa = aff.get("podAffinity") or {}
        paa = aff.get("podAntiAffinity") or {}
        return (
            pa.get("requiredDuringSchedulingIgnoredDuringExecution") or [],
            paa.get("requiredDuringSchedulingIgnoredDuringExecution") or [],
            pa.get("preferredDuringSchedulingIgnoredDuringExecution") or [],
            paa.get("preferredDuringSchedulingIgnoredDuringExecution") or [],
        )

    # Pending pods' own term lists (padded) + "toward"-update lists —
    # memoized by (affinity-spec signature, namespace): the group/weight
    # lists depend on nothing else, and pods stamped from the same
    # template share them.
    aff_groups: list[list[int]] = []
    anti_groups: list[list[int]] = []
    pref_groups: list[list[tuple[int, int]]] = []  # (group, signed weight)
    own_updates: list[list[tuple[int, int]]] = []  # (group, folded weight)
    terms_memo: dict[str, tuple] = {}
    for p in pending:
        ns = _namespace_of(p)
        tk = memo.sig_of((p.get("spec") or {}).get("affinity") or ()) + "|" + ns
        entry = terms_memo.get(tk)
        if entry is None:
            req_aff, req_anti, pref_aff, pref_anti = pod_terms(p)
            ag = [term_group(t, ns) for t in req_aff]
            ng = [term_group(t, ns) for t in req_anti]
            prefs = [(term_group((t.get("podAffinityTerm") or {}), ns), int(t.get("weight") or 0)) for t in pref_aff]
            prefs += [(term_group((t.get("podAffinityTerm") or {}), ns), -int(t.get("weight") or 0)) for t in pref_anti]
            pg = [(g, w) for g, w in prefs if w]
            ups: list[tuple[int, int]] = []
            if hard_pod_affinity_weight > 0:
                ups += [(term_group(t, ns), hard_pod_affinity_weight) for t in req_aff]
            ups += pg
            entry = (ag, ng, pg, ups)
            terms_memo[tk] = entry
        aff_groups.append(entry[0])
        anti_groups.append(entry[1])
        pref_groups.append(entry[2])
        own_updates.append(entry[3])

    # Existing pods' own terms create groups too (they poison/score toward
    # the pending pods).  Register ALL groups first, then seed the counts.
    # Seeded encodes skip the scan — the cache gate guarantees no bound
    # pod carries inter-pod affinity, so the cold loop would emit nothing.
    seed_ops: list[tuple[str, int, int, int]] = []  # (which, group, node, weight)
    for n_i, ni in enumerate(node_infos if seed is None else ()):
        for ep in ni.pods:
            ep_ns = _namespace_of(ep)
            req_aff, req_anti, pref_aff, pref_anti = pod_terms(ep)
            for t in req_anti:
                seed_ops.append(("anti", term_group(t, ep_ns), n_i, 1))
            if hard_pod_affinity_weight > 0:
                for t in req_aff:
                    seed_ops.append(("own", term_group(t, ep_ns), n_i, hard_pod_affinity_weight))
            for t in pref_aff:
                w = int(t.get("weight") or 0)
                if w:
                    seed_ops.append(("own", term_group((t.get("podAffinityTerm") or {}), ep_ns), n_i, w))
            for t in pref_anti:
                w = int(t.get("weight") or 0)
                if w:
                    seed_ops.append(("own", term_group((t.get("podAffinityTerm") or {}), ep_ns), n_i, -w))

    G = len(g_terms)
    ip_sel0 = np.zeros((max(G, 1), D), dtype=np.int64)
    ip_own0 = np.zeros((max(G, 1), D), dtype=np.int64)
    ip_anti0 = np.zeros((max(G, 1), D), dtype=np.int64)
    for which, g, n_i, w in seed_ops:
        d = node_domain[g_key[g], n_i]
        if d < 0:
            continue
        (ip_anti0 if which == "anti" else ip_own0)[g, d] += w
    # term matching per pod CLASS, expanded to pods/nodes by indexing
    if G:
        tm_cls = np.zeros((G, max(len(cls_reps), 1)), dtype=bool)
        for g, (term, owner_ns) in enumerate(g_terms):
            for c, rp in enumerate(cls_reps):
                tm_cls[g, c] = memo.affinity_term(term, owner_ns, rp)
        for n_i, ccnt in enumerate(node_cls_counts):
            if not ccnt:
                continue
            for g in range(G):
                d = node_domain[g_key[g], n_i]
                if d < 0:
                    continue
                total = sum(k for c, k in ccnt.items() if tm_cls[g, c])
                if total:
                    ip_sel0[g, d] += total
        # term_match[g, j]: group g's term selects pending pod j.
        term_match = tm_cls[:, pend_cls]
    else:
        term_match = np.zeros((1, P), dtype=bool)

    pr.G = G
    pr.term_match = term_match
    pr.ip_sel0, pr.ip_own0, pr.ip_anti0 = ip_sel0, ip_own0, ip_anti0
    pr.group_key = np.array(g_key, dtype=np.int32) if G else np.zeros(1, dtype=np.int32)

    def pad_groups(lists, K, with_w=False):
        Kp = max(K, 1)
        grp = np.full((P, Kp), -1, dtype=np.int32)
        w = np.zeros((P, Kp), dtype=np.int64)
        for i, lst in enumerate(lists):
            for k, item in enumerate(lst):
                if with_w:
                    grp[i, k], w[i, k] = item
                else:
                    grp[i, k] = item
        return (grp, w) if with_w else grp

    pr.KA = max((len(x) for x in aff_groups), default=0)
    pr.KB = max((len(x) for x in anti_groups), default=0)
    pr.KP = max((len(x) for x in pref_groups), default=0)
    pr.KO = max((len(x) for x in own_updates), default=0)
    pr.ip_aff_g = pad_groups(aff_groups, pr.KA)
    pr.ip_anti_g = pad_groups(anti_groups, pr.KB)
    pr.ip_pref_g, pr.ip_pref_w = pad_groups(pref_groups, pr.KP, with_w=True)
    pr.ip_own_g, pr.ip_own_w = pad_groups(own_updates, pr.KO, with_w=True)
    # self-match escape hatch: pod matches all its own required-affinity terms
    selfm = np.zeros(P, dtype=bool)
    for i, p in enumerate(pending):
        gl = aff_groups[i]
        selfm[i] = bool(gl) and all(term_match[g, i] for g in gl)
    pr.ip_self_match = selfm

    # True (unpadded) sizes + all-active masks; pad_problem overwrites
    # these, so every consumer can read them unconditionally.
    pr.P_true, pr.N_true = P, N
    pr.pod_active = np.ones(P, dtype=bool)
    pr.node_active = np.ones(N, dtype=bool)

    return pr


def _encode_volumes(
    pr: BatchProblem,
    pending: list[Obj],
    node_infos: "list[NodeInfo] | None",
    nl_reps: list[Obj],
    volumes: "dict[str, list[Obj]]",
    n_nodes: int,
) -> None:
    """Lower the volume filter plugins to batch tensors.

    Mirrors plugins/intree/volumes.py (the sequential oracle, itself
    pinned to upstream v1.26 — reference wrappedplugin.go delegates these
    to the in-tree plugins) with every PVC → PV / StorageClass / CSINode
    string lookup resolved HERE on the host:

    - VolumeBinding / VolumeZone are STATIC per (pod-volume-class ×
      node-label-class): codes with the oracle's first-failing-claim
      semantics, expanded on-device like the NodeAffinity matrices.
    - VolumeRestrictions follows the NodePorts recipe: conflict classes =
      the distinct (kind, id, readOnly) cloud-volume triples pending pods
      mount; ``restr_used0[n,w]`` counts occupying volumes conflicting
      with class w, and the kernel's commit projects a placed pod's
      triples through the conflict relation.
    - EBS/GCE/AzureDisk limits are per-family counts (no dedup — the
      oracle counts per mount); CSI NodeVolumeLimits tracks the distinct
      (driver, volume-id) attachments per node: ids referenced by pending
      pods get carry bits (``csi_attached0``), all other existing
      attachments collapse into per-driver seed counts, and per-driver
      caps come from each node's CSINode allocatable (default 256).
    """
    P, N = len(pending), n_nodes
    M = len(nl_reps)
    from kube_scheduler_simulator_tpu_torch.plugins.intree.volumes import (
        CLOUD_LIMIT_PLUGINS,
        REGION_LABELS,
        ZONE_LABELS,
        NodeVolumeLimits,
        _pod_pvc_names,
        pod_cloud_triples,
        pod_csi_volume_ids,
        resolve_csi_driver,
        volumes_conflict,
    )

    # Fast path: no PENDING pod mounts anything → every volume kernel is
    # inert regardless of what bound pods hold (conflicts/counts/codes
    # only engage for wanted classes), so skip the per-pod grouping and
    # seeding loops — they would otherwise tax every volume-free round.
    if not any((p.get("spec") or {}).get("volumes") for p in pending):
        pr.vb_cls = np.zeros((1, M), dtype=np.int8)
        pr.vz_cls = np.zeros((1, M), dtype=np.int8)
        pr.pod_vol_idx = np.zeros(P, dtype=np.int32)
        pr.VR = 0
        pr.pod_restr = np.zeros((P, 1), dtype=bool)
        pr.restr_conflict = np.zeros((1, 1), dtype=bool)
        pr.restr_used0 = np.zeros((N, 1), dtype=np.int64)
        pr.CLOUD = 0
        pr.cloud_cnt = np.zeros((P, 3), dtype=np.int64)
        pr.cloud_used0 = np.zeros((N, 3), dtype=np.int64)
        pr.VID = pr.DR = 0
        pr.pod_csi = np.zeros((P, 1), dtype=bool)
        pr.csi_drv_oh = np.zeros((1, 1), dtype=np.int64)
        pr.csi_attached0 = np.zeros((N, 1), dtype=np.int64)
        pr.csi_seed_used = np.zeros((N, 1), dtype=np.int64)
        pr.csi_limit = np.full((N, 1), NodeVolumeLimits.default_limit, dtype=np.int64)
        return
    # past the fast path the bound-pod volume scans need the real
    # NodeInfos — the EncodeCache gate routes volume workloads to the
    # cold encode
    assert node_infos is not None, "volume workloads require the cold encode path"

    def _ns_of(o: Obj) -> str:
        return o["metadata"].get("namespace") or "default"

    pvc_by = {(_ns_of(o), o["metadata"]["name"]): o for o in volumes.get("persistentvolumeclaims") or []}
    pv_by = {o["metadata"]["name"]: o for o in volumes.get("persistentvolumes") or []}
    sc_by = {o["metadata"]["name"]: o for o in volumes.get("storageclasses") or []}
    csinode_by = {o["metadata"]["name"]: o for o in volumes.get("csinodes") or []}

    def dget(kind: str, name: str, namespace: "str | None" = None) -> "Obj | None":
        """Dict-backed object source for the shared resolution helpers."""
        if kind == "persistentvolumeclaims":
            return pvc_by.get((namespace, name))
        if kind == "persistentvolumes":
            return pv_by.get(name)
        if kind == "storageclasses":
            return sc_by.get(name)
        return None

    # ------------------------------------------- VolumeBinding / VolumeZone
    vol_reps, vol_idx = _group(
        [(_namespace_of(p), tuple(_pod_pvc_names(p))) for p in pending], repr
    )
    VC = len(vol_reps)
    vb = np.zeros((VC, M), dtype=np.int8)
    vz = np.zeros((VC, M), dtype=np.int8)
    aff_memo: dict[tuple[int, int], bool] = {}
    for a, (ns, claims) in enumerate(vol_reps):
        for claim in claims:
            pvc = pvc_by.get((ns, claim))
            if pvc is None:
                continue  # missing PVC = PreFilter reject; supported() de-batches
            vol_name = (pvc.get("spec") or {}).get("volumeName")
            if not vol_name:
                sc_name = (pvc.get("spec") or {}).get("storageClassName")
                sc = sc_by.get(sc_name) if sc_name else None
                if (sc or {}).get("volumeBindingMode", "Immediate") != "WaitForFirstConsumer":
                    # node-independent failure — first-fails every node class
                    vb[a] = np.where(vb[a] == 0, 1, vb[a])
                continue
            pv = pv_by.get(vol_name)
            if pv is None:
                continue
            required = ((pv.get("spec") or {}).get("nodeAffinity") or {}).get("required")
            if required is not None:
                for b, nl in enumerate(nl_reps):
                    if vb[a, b]:
                        continue
                    k = (id(required), b)
                    ok = aff_memo.get(k)
                    if ok is None:
                        ok = match_node_selector(required, nl["labels"], nl["name"])
                        aff_memo[k] = ok
                    if not ok:
                        vb[a, b] = 2
            pv_labels = pv["metadata"].get("labels") or {}
            if any(l in pv_labels for ls in (ZONE_LABELS, REGION_LABELS) for l in ls):
                for b, nl in enumerate(nl_reps):
                    if vz[a, b]:
                        continue
                    nlabels = nl["labels"]
                    fail = False
                    for label_set in (ZONE_LABELS, REGION_LABELS):
                        for label in label_set:
                            if label in pv_labels and label in nlabels:
                                if nlabels[label] not in set(pv_labels[label].split("__")):
                                    fail = True
                                    break
                        if fail:
                            break
                    if fail:
                        vz[a, b] = 1
    pr.vb_cls, pr.vz_cls, pr.pod_vol_idx = vb, vz, vol_idx

    # ------------------------------------------------- VolumeRestrictions
    triples: list[tuple] = []
    tri_idx: dict[tuple, int] = {}
    pend_tri: list[list[int]] = []
    for p in pending:
        ids = []
        for t in pod_cloud_triples(p):
            if t not in tri_idx:
                tri_idx[t] = len(triples)
                triples.append(t)
            ids.append(tri_idx[t])
        pend_tri.append(ids)
    VR = len(triples)
    pr.VR = VR
    pod_restr = np.zeros((P, max(VR, 1)), dtype=bool)
    for i, ids in enumerate(pend_tri):
        for t in ids:
            pod_restr[i, t] = True

    restr_conflict = np.zeros((max(VR, 1), max(VR, 1)), dtype=bool)
    for a, ta in enumerate(triples):
        for b, tb in enumerate(triples):
            restr_conflict[a, b] = volumes_conflict(ta, tb)
    restr_used0 = np.zeros((N, max(VR, 1)), dtype=np.int64)
    if VR:
        by_kind_id: dict[tuple, list[int]] = {}
        for w, (kind, vid, _ro) in enumerate(triples):
            by_kind_id.setdefault((kind, vid), []).append(w)
        for n_i, ni in enumerate(node_infos):
            for bp in ni.pods:
                for bt in pod_cloud_triples(bp):
                    for w in by_kind_id.get((bt[0], bt[1]), ()):
                        if volumes_conflict(bt, triples[w]):
                            restr_used0[n_i, w] += 1
    pr.pod_restr, pr.restr_conflict, pr.restr_used0 = pod_restr, restr_conflict, restr_used0

    # -------------------------------------- EBS/GCE/Azure volume counts
    CLOUD_KEYS = tuple(cls.volume_key for cls in CLOUD_LIMIT_PLUGINS)

    def cloud_counts(p: Obj) -> "list[int]":
        vols = (p.get("spec") or {}).get("volumes") or []
        return [sum(1 for v in vols if v.get(k)) for k in CLOUD_KEYS]

    cloud_cnt = np.zeros((P, 3), dtype=np.int64)
    for i, p in enumerate(pending):
        cloud_cnt[i] = cloud_counts(p)
    cloud_used0 = np.zeros((N, 3), dtype=np.int64)
    pr.CLOUD = int(cloud_cnt.any())
    if pr.CLOUD:
        for n_i, ni in enumerate(node_infos):
            for bp in ni.pods:
                cloud_used0[n_i] += cloud_counts(bp)
    pr.cloud_cnt, pr.cloud_used0 = cloud_cnt, cloud_used0

    # ------------------------------------------- CSI NodeVolumeLimits
    # shared resolution core (plugins/intree/volumes.py) over the dict
    # indexes — one parity-critical implementation for oracle and kernel
    drv_memo: dict[tuple[str, str], "str | None"] = {}

    def driver_of(v: Obj, ns: str) -> "str | None":
        return resolve_csi_driver(v, ns, dget)

    def vol_ids(p: Obj) -> "set[tuple[str, str]]":
        return pod_csi_volume_ids(p, driver_of, drv_memo)

    vid_table: dict[str, int] = {}
    vid_driver: list[str] = []
    pend_vids: list[list[int]] = []
    for p in pending:
        ids = []
        for driver, vid in sorted(vol_ids(p)):
            if vid not in vid_table:
                vid_table[vid] = len(vid_table)
                vid_driver.append(driver)
            ids.append(vid_table[vid])
        pend_vids.append(ids)
    VID = len(vid_table)
    drv_table: dict[str, int] = {}
    for d in vid_driver:
        if d not in drv_table:
            drv_table[d] = len(drv_table)
    DR = len(drv_table)
    pr.VID, pr.DR = VID, DR
    pod_csi = np.zeros((P, max(VID, 1)), dtype=bool)
    for i, ids in enumerate(pend_vids):
        for t in ids:
            pod_csi[i, t] = True
    csi_drv_oh = np.zeros((max(VID, 1), max(DR, 1)), dtype=np.int64)
    for v, d in enumerate(vid_driver):
        csi_drv_oh[v, drv_table[d]] = 1
    csi_attached0 = np.zeros((N, max(VID, 1)), dtype=np.int64)
    csi_seed_used = np.zeros((N, max(DR, 1)), dtype=np.int64)
    csi_limit = np.full((N, max(DR, 1)), NodeVolumeLimits.default_limit, dtype=np.int64)
    if VID:
        for n_i, ni in enumerate(node_infos):
            seen: set[tuple[str, str]] = set()
            for bp in ni.pods:
                seen |= vol_ids(bp)
            for driver, vid in seen:
                t = vid_table.get(vid)
                if t is not None:
                    csi_attached0[n_i, t] = 1
                elif driver in drv_table:
                    csi_seed_used[n_i, drv_table[driver]] += 1
            # per-driver caps from the node's CSINode allocatable
            csinode = csinode_by.get(ni.name)
            for d in ((csinode or {}).get("spec") or {}).get("drivers") or []:
                cnt = (d.get("allocatable") or {}).get("count")
                if d.get("name") in drv_table and cnt is not None:
                    csi_limit[n_i, drv_table[d["name"]]] = int(cnt)
    pr.pod_csi, pr.csi_drv_oh = pod_csi, csi_drv_oh
    pr.csi_attached0, pr.csi_seed_used, pr.csi_limit = csi_attached0, csi_seed_used, csi_limit


# --------------------------------------------------------- shape bucketing

def _bucket(x: int) -> int:
    """Next size in the {2^k, 1.25·2^k, 1.5·2^k, 1.75·2^k} series (≤25%
    padding waste) — the jit cache then sees O(log) distinct shapes as
    pods/nodes churn instead of one compile per exact dimension (SURVEY §7
    hard part (b)); scan wall time is linear in the padded pod axis, so
    tighter buckets directly buy back kernel time."""
    if x <= 0:
        return 0
    if x <= 8:
        return 8
    k = math.ceil(math.log2(x))
    for frac in (5, 6, 7):  # 1.25/1.5/1.75 × 2^(k-1)
        mid = frac * 2 ** (k - 3)
        if mid >= x:
            return mid
    return 2 ** k


def _pad_axis(a: np.ndarray, axis: int, target: int, fill) -> np.ndarray:
    a = np.asarray(a)
    if a.shape[axis] >= target:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, target - a.shape[axis])
    return np.pad(a, widths, constant_values=fill)


def pad_problem(pr: BatchProblem, node_multiple: int = 1) -> BatchProblem:
    """Pad the pod/node/group axes of an encoded problem to bucket
    boundaries, with ``pod_active``/``node_active`` masks so padding rows
    never schedule and padded nodes are never feasible.  The unrolled
    per-constraint dims (KC/KS/KA/KB/KP/KO) stay exact — padding them
    would multiply kernel work, and they are workload-type-stable.  Host
    metadata (node_names/pod_keys, P_true/N_true) keeps the true sizes.

    ``node_multiple``: round the padded node axis up to a multiple (mesh
    sharding needs the sharded axis divisible by the device count)."""
    P, N = pr.P, pr.N
    P_pad, N_pad = _bucket(P), _bucket(N)
    if node_multiple > 1:
        N_pad = ((N_pad + node_multiple - 1) // node_multiple) * node_multiple
    SG_pad = _bucket(pr.SG) if pr.SG else pr.SG
    G_pad = _bucket(pr.G) if pr.G else pr.G

    pr.P_true, pr.N_true = P, N
    pr.pod_active = _pad_axis(np.ones(P, dtype=bool), 0, P_pad, False)
    pr.node_active = _pad_axis(np.ones(N, dtype=bool), 0, N_pad, False)

    # pod axis (rows).  Class-index vectors pad with class 0 — padding rows
    # are never committed (pod_active False) and padded nodes never feasible
    # (node_active False), so the class content is irrelevant.
    for name, fill in (
        ("pod_req", 0), ("pod_nonzero", 0), ("fit_checked", False),
        ("pod_tol_idx", 0), ("pod_aff_idx", 0), ("pod_pref_idx", 0),
        ("pod_img_idx", 0), ("name_target", -1), ("pod_ports", False),
        ("pod_vol_idx", 0), ("pod_restr", False), ("cloud_cnt", 0), ("pod_csi", False),
        ("spf_key", -1), ("spf_group", 0), ("spf_skew", 1), ("spf_self", 0),
        ("sps_key", -1), ("sps_group", 0), ("sps_skew", 1), ("sps_self", 0),
        ("ip_aff_g", -1), ("ip_anti_g", -1), ("ip_pref_g", -1), ("ip_pref_w", 0),
        ("ip_own_g", -1), ("ip_own_w", 0), ("ip_self_match", False),
    ):
        setattr(pr, name, _pad_axis(getattr(pr, name), 0, P_pad, fill))
    # pod axis as columns
    pr.spread_match = _pad_axis(pr.spread_match, 1, P_pad, False)
    pr.term_match = _pad_axis(pr.term_match, 1, P_pad, False)

    # node axis
    for name, fill in (
        ("alloc", 0), ("max_pods", 0), ("nz_alloc", 0), ("requested0", 0),
        ("nonzero0", 0), ("pod_count0", 0),
        ("node_taint_idx", 0), ("node_label_idx", 0), ("node_img_idx", 0),
        ("node_unsched", False), ("ports_used0", 0),
        ("restr_used0", 0), ("cloud_used0", 0), ("csi_attached0", 0),
        ("csi_seed_used", 0), ("csi_limit", 0),
    ):
        setattr(pr, name, _pad_axis(getattr(pr, name), 0, N_pad, fill))
    for name, fill in (
        ("node_domain", -1), ("spread_counts0", 0),
    ):
        setattr(pr, name, _pad_axis(getattr(pr, name), 1, N_pad, fill))

    # group axes (rows of [SG,*] / [G,*] arrays; indices into them are
    # unaffected, padding rows are simply never referenced)
    if pr.SG and SG_pad > pr.SG:
        pr.spread_match = _pad_axis(pr.spread_match, 0, SG_pad, False)
        pr.spread_counts0 = _pad_axis(pr.spread_counts0, 0, SG_pad, 0)
        pr.SG = SG_pad
    if pr.G and G_pad > pr.G:
        pr.term_match = _pad_axis(pr.term_match, 0, G_pad, False)
        # fill with an already-used key so lower()'s used_keys set (hence
        # KU/key_struct and per-step expansion work) doesn't grow
        pr.group_key = _pad_axis(pr.group_key, 0, G_pad, int(pr.group_key[0]))
        for name in ("ip_sel0", "ip_own0", "ip_anti0"):
            setattr(pr, name, _pad_axis(getattr(pr, name), 0, G_pad, 0))
        pr.G = G_pad

    # Volume class axes: padded classes are never wanted (pod_restr /
    # pod_csi padding is False) and their conflict/driver rows are zero,
    # so they can't fail a filter or perturb a count.
    if pr.VR:
        VR_pad = _bucket(pr.VR)
        if VR_pad > pr.VR:
            pr.pod_restr = _pad_axis(pr.pod_restr, 1, VR_pad, False)
            pr.restr_conflict = _pad_axis(
                _pad_axis(pr.restr_conflict, 0, VR_pad, False), 1, VR_pad, False
            )
            pr.restr_used0 = _pad_axis(pr.restr_used0, 1, VR_pad, 0)
            pr.VR = VR_pad
    if pr.VID:
        VID_pad = _bucket(pr.VID)
        if VID_pad > pr.VID:
            pr.pod_csi = _pad_axis(pr.pod_csi, 1, VID_pad, False)
            pr.csi_drv_oh = _pad_axis(pr.csi_drv_oh, 0, VID_pad, 0)
            pr.csi_attached0 = _pad_axis(pr.csi_attached0, 1, VID_pad, 0)
            pr.VID = VID_pad
        DR_pad = _bucket(pr.DR)
        if DR_pad > pr.DR:
            # padded driver columns: need_d stays 0 there (zero one-hot
            # rows), and the over-limit check requires need_d > 0
            pr.csi_drv_oh = _pad_axis(pr.csi_drv_oh, 1, DR_pad, 0)
            pr.csi_seed_used = _pad_axis(pr.csi_seed_used, 1, DR_pad, 0)
            pr.csi_limit = _pad_axis(pr.csi_limit, 1, DR_pad, 0)
            pr.DR = DR_pad

    # Identity-key expansions dynamic_slice [base, base+N) out of the
    # domain axis; with N padded the axis must extend past the last base.
    if N_pad > N and any(pr.key_identity):
        d_pad = pr.D + (N_pad - N)
        for name in ("ip_sel0", "ip_own0", "ip_anti0"):
            setattr(pr, name, _pad_axis(getattr(pr, name), 1, d_pad, 0))
        pr.D = d_pad

    pr.P, pr.N = P_pad, N_pad
    return pr


# ------------------------------------------------------- incremental encode

class EncodeCache:
    """Host-side incremental encoder: delta re-encode across waves.

    A churn workload changes the cluster at the margin — <5% of objects
    move between scheduling waves — but a cold ``encode()`` pays the full
    O(all-pods) ``build_node_infos`` scan plus every class-matrix build
    every round.  This cache retains, between rounds:

    - the bound-pod usage aggregates (per-node requested/nonzero dicts,
      pod counts, the pod equivalence-class table and per-node class
      counts), keyed by ``(resourceVersion, nodeName)`` fingerprints so
      only CHANGED pods are re-encoded (the store bumps resourceVersion
      on every mutation; objects without one fall back to a content
      signature);
    - the node-derived class tables (taint/label/image reps) and LAZY
      class-matrix row caches keyed by spec signature, valid while the
      node set is unchanged.

    ``encode()`` diffs the cluster against that state; when the exactness
    GATES hold it runs the shared :func:`encode` implementation with
    ``seed=self`` — the same assembly code as the cold path, with only
    the bound-state inputs swapped — so seeded and cold encodes are
    value-identical (pinned by tests/test_encode_incremental.py and the
    tier-1 smoke step).  Outside the envelope it falls back to a cold
    full encode and counts the reason.

    Gates (full re-encode when any fails) — STATE gates re-prime the
    cache: node set changed; plugin config (addedAffinity /
    hardPodAffinityWeight) changed; class-table staleness past the
    compaction threshold.  WORKLOAD gates keep the (still-valid) cached
    state current via the bound diff and skip the re-prime: pending pods
    mount volumes or carry host ports (their planes need bound-pod
    scans); any bound pod carries inter-pod affinity terms (their own
    terms seed group counts the delta can't maintain — tracked as a
    maintained counter, so the gate clears the wave the last carrier
    leaves).
    """

    def __init__(self, max_class_stale_factor: int = 4):
        import threading

        self.stats = {
            "encode_full_total": 0,
            "encode_delta_total": 0,
            "encode_rows_reencoded_total": 0,
            "encode_fallbacks_by_reason": {},
        }
        # Serializes every encode() against every other encode(): the
        # streaming pipeline runs the diff off the commit thread (wave
        # k+1's encode while wave k commits), and the
        # fingerprint tables (bound/cls_index/node_cls_counts/...) are
        # read-modify-write state — two interleaved _apply_bound_delta
        # passes double-apply entries and corrupt the aggregates
        # (tests/test_stream.py pins mutual exclusion + a churn stress).
        # RLock: the seeded encode() call re-enters cache methods.
        self._lock = threading.RLock()
        self._primed = False
        self._max_stale = max_class_stale_factor
        # request parsing memo (containers/initContainers/overhead sig →
        # (req items, nonzero pair)) — survives re-primes: churned pods
        # are stamped from the same templates
        self._req_memo: dict[str, tuple] = {}
        self.rows_miss = 0  # row-cache misses within the current seeded encode
        self._delta_rows = 0
        # why the cached state was dropped from outside (``invalidate``):
        # the next encode's state gate reports it instead of "cold start"
        self._invalidated: "str | None" = None

    # -------------------------------------------------------- fingerprints

    @staticmethod
    def _node_fp(n: Obj) -> str:
        rv = n["metadata"].get("resourceVersion")
        return rv if rv is not None else _sig(n)

    @staticmethod
    def _pod_fp(p: Obj) -> tuple:
        # nodeName rides along explicitly: waiting pods are shown to the
        # encoder as synthesized bound copies that share the store
        # object's resourceVersion (scheduler/service.py
        # _pods_with_waiting_assumed)
        rv = p["metadata"].get("resourceVersion")
        return (rv if rv is not None else _sig(p), (p.get("spec") or {}).get("nodeName") or "")

    # -------------------------------------------------------------- public

    def encode(
        self,
        nodes: list[Obj],
        all_pods: list[Obj],
        pending: list[Obj],
        namespaces: "list[Obj] | None" = None,
        hard_pod_affinity_weight: int = 1,
        added_affinity: "Obj | None" = None,
        volumes: "dict[str, list[Obj]] | None" = None,
        nominated: "list[tuple[Obj, str]] | None" = None,
    ) -> BatchProblem:
        """Drop-in for :func:`encode`, delta-re-encoding when possible.

        Gate failures split in two classes: STATE gates (cold start, node
        set or plugin config changed, class-table compaction) invalidate
        the cached state, so the fallback re-primes; WORKLOAD gates
        (pending volumes/ports, bound inter-pod affinity) only mean THIS
        round's problem isn't delta-representable — the bound diff is
        still applied so the cached state stays fresh, the cold encode
        serves/fills the (still-valid) row caches, and no O(all-pods)
        re-prime is paid.  A workload that stays gated for a while — e.g.
        a bound pod holding inter-pod affinity — therefore costs the
        cold encode plus a cheap fingerprint diff per wave, and the first
        wave after the gate clears goes straight back to the delta path.

        Thread safety: the whole pass (gates, bound diff, seeded/cold
        encode) holds ``self._lock`` — concurrent callers (a streaming
        prep thread racing a sequential drain, or two profile rounds)
        serialize instead of interleaving read-modify-write passes over
        the fingerprint tables.
        """
        with self._lock:
            return self._encode_locked(
                nodes, all_pods, pending, namespaces,
                hard_pod_affinity_weight, added_affinity, volumes, nominated,
            )

    def invalidate(self, reason: str) -> None:
        """Drop the cached state: the next encode is a full one that
        re-primes, counted under ``reason`` in
        ``encode_fallbacks_by_reason`` (the store was restored wholesale
        under the cache)."""
        with self._lock:
            self._primed = False
            self._invalidated = reason

    def stats_snapshot(self) -> dict:
        """A copy of the counters, readable while an encode is in
        flight: the top-level keys are fixed at construction (values
        only ever replaced, ints atomically under the GIL) and the
        fallback-reason dict is published copy-on-write (never mutated
        in place), so the metrics scrape thread never queues behind a
        multi-second cold encode holding the encode lock.  Monotone
        counters may be one in-flight encode apart from each other —
        fine for a scrape, which only needs each counter individually
        intact."""
        # lock-free: copy-on-write read — _encode_locked never mutates the
        # published fallback dict in place (it rebinds a fresh merged dict)
        # and the int values are replaced atomically under the GIL, so a
        # scrape never queues behind a multi-second cold encode
        return {
            k: (dict(v) if isinstance(v, dict) else v) for k, v in self.stats.items()
        }

    def _encode_locked(
        self,
        nodes: list[Obj],
        all_pods: list[Obj],
        pending: list[Obj],
        namespaces: "list[Obj] | None",
        hard_pod_affinity_weight: int,
        added_affinity: "Obj | None",
        volumes: "dict[str, list[Obj]] | None",
        nominated: "list[tuple[Obj, str]] | None",
    ) -> BatchProblem:
        self._trim_memos()
        state_reason = self._state_gate(nodes, hard_pod_affinity_weight, added_affinity)
        workload_reason = None
        if state_reason is None:
            # keep the aggregates current whether or not this round can
            # use them (the diff also maintains bound_affinity)
            self._apply_bound_delta(all_pods)
            workload_reason = self._workload_gate(pending)
        if state_reason is None and workload_reason is None:
            self.rows_miss = 0
            pr = encode(
                nodes, all_pods, pending, namespaces,
                hard_pod_affinity_weight=hard_pod_affinity_weight,
                added_affinity=added_affinity, volumes=volumes,
                nominated=nominated, seed=self,
            )
            self.stats["encode_delta_total"] += 1
            self.stats["encode_rows_reencoded_total"] += self.rows_miss + self._delta_rows
            return pr
        fb = self.stats["encode_fallbacks_by_reason"]
        reason = state_reason or workload_reason
        # copy-on-write publish: stats_snapshot() reads this dict
        # WITHOUT the encode lock, so the published value is never
        # mutated in place
        self.stats["encode_fallbacks_by_reason"] = {**fb, reason: fb.get(reason, 0) + 1}
        ni = None
        if state_reason is not None:
            # prime FIRST (emptying any stale row caches), then let the
            # cold encode fill/serve them — row content is a pure
            # function of (spec sig × node tables), and the just-primed
            # tables equal the ones the cold pass groups from the same
            # nodes, so the first delta wave after a fallback starts
            # row-warm.  ONE build_node_infos serves both passes.
            ni = build_node_infos(nodes, all_pods)
            self._prime(nodes, all_pods, hard_pod_affinity_weight, added_affinity, node_infos=ni)
        self.rows_miss = 0
        pr = encode(
            nodes, all_pods, pending, namespaces,
            hard_pod_affinity_weight=hard_pod_affinity_weight,
            added_affinity=added_affinity, volumes=volumes, nominated=nominated,
            rows=self if self._primed else None, node_infos=ni,
        )
        self.stats["encode_full_total"] += 1
        return pr

    def _trim_memos(self) -> None:
        """Bound the persistent memos — they are pure caches, so clearing
        on overflow is always safe (the next encodes re-fill the hot
        entries); without this a long-lived server fed ever-distinct
        specs would grow them without limit."""
        if len(self._req_memo) > 8192:
            self._req_memo.clear()
        if self._primed:
            for rc in (self.tol_rows, self.aff_rows, self.pref_rows, self.img_rows):
                if len(rc) > 2048:
                    rc.clear()

    # --------------------------------------------------------------- gates

    def _state_gate(self, nodes, hard_w, added_affinity) -> "str | None":
        """Gates that invalidate the CACHED STATE (fallback must re-prime)."""
        if not self._primed:
            reason, self._invalidated = self._invalidated or "cold start", None
            return reason
        if (hard_w, _sig(added_affinity)) != self._cfg_key:
            return "plugin config changed"
        if len(nodes) != len(self.node_names):
            return "node set changed"
        node_fp = self.node_fp
        node_names = self.node_names
        for i, n in enumerate(nodes):
            if n["metadata"]["name"] != node_names[i] or self._node_fp(n) != node_fp[i]:
                return "node set changed"
        if len(self.cls_reps) > max(1024, self._max_stale * (len(self.bound) + 64)):
            # departed pods' stale classes make every selector sweep
            # longer; a full re-encode re-primes a compact table
            return "class-table compaction"
        return None

    def _workload_gate(self, pending) -> "str | None":
        """Gates that only make THIS round non-delta-representable (the
        cached state stays valid; the fallback skips re-priming)."""
        if any((p.get("spec") or {}).get("volumes") for p in pending):
            return "pending pods mount volumes"
        from kube_scheduler_simulator_tpu_torch.plugins.intree.node_basic import _host_ports

        for p in pending:
            if _host_ports(p):
                return "pending pods carry host ports"
        if self.bound_affinity:
            return "bound pods carry inter-pod affinity"
        return None

    # ------------------------------------------------------- bound deltas

    def _apply_bound_delta(self, all_pods: list[Obj]) -> None:
        """Diff the bound-pod set against the cache and apply the deltas.

        Always succeeds: the maintained aggregates (usage, counts,
        classes, the bound-affinity counter) are well-defined for every
        pod — it is the seeded ENCODE that can't model an affinity
        carrier's own term seeds, which `_workload_gate` checks against
        the counter this diff keeps current."""
        by_name = self.node_by_name
        bound = self.bound
        seen: set[str] = set()
        changes: list[tuple] = []  # (key, old entry | None, new entry)
        for p in all_pods:
            nn = (p.get("spec") or {}).get("nodeName")
            if not nn:
                continue
            j = by_name.get(nn)
            if j is None:
                continue
            meta = p["metadata"]
            key = meta.get("namespace", "default") + "/" + meta["name"]
            seen.add(key)
            fp = self._pod_fp(p)
            old = bound.get(key)
            if old is not None and old[0] == fp:
                continue
            changes.append((key, old, self._entry(p, fp, j)))
        removals = [k for k in bound if k not in seen]
        for key, old, new in changes:
            if old is not None:
                self._sub(old)
            self._add(new)
            bound[key] = new
        for k in removals:
            self._sub(bound.pop(k))
        self._delta_rows = len(changes) + len(removals)

    def _entry(self, p: Obj, fp: tuple, j: int) -> tuple:
        spec = p.get("spec") or {}
        rk = (
            _sig(spec.get("containers") or ())
            + "|" + _sig(spec.get("initContainers") or ())
            + "|" + _sig(spec.get("overhead") or ())
        )
        v = self._req_memo.get(rk)
        if v is None:
            req = pod_resource_request(p)
            nz = pod_non_zero_request(p)
            v = (tuple(req.items()), (nz[CPU], nz[MEMORY]))
            self._req_memo[rk] = v
        meta = p["metadata"]
        ck = (
            _sig(sorted((meta.get("labels") or {}).items()))
            + "|" + meta.get("namespace", "default")
            + ("|T" if meta.get("deletionTimestamp") else "|F")
        )
        c = self.cls_index.get(ck)
        if c is None:
            c = len(self.cls_reps)
            self.cls_index[ck] = c
            self.cls_reps.append(_frozen_cls_rep(p))
        aff = spec.get("affinity") or {}
        has_aff = bool(aff.get("podAffinity") or aff.get("podAntiAffinity"))
        return (fp, j, v[0], v[1], c, has_aff)

    def _add(self, e: tuple) -> None:
        _fp, j, req_items, nz, c, has_aff = e
        d = self.requested_d[j]
        for r, v in req_items:
            d[r] = d.get(r, 0) + v
        self.nonzero[j, 0] += nz[0]
        self.nonzero[j, 1] += nz[1]
        self.pod_count[j] += 1
        cc = self.node_cls_counts[j]
        cc[c] = cc.get(c, 0) + 1
        if has_aff:
            self.bound_affinity += 1

    def _sub(self, e: tuple) -> None:
        _fp, j, req_items, nz, c, has_aff = e
        d = self.requested_d[j]
        for r, v in req_items:
            d[r] = d.get(r, 0) - v
        self.nonzero[j, 0] -= nz[0]
        self.nonzero[j, 1] -= nz[1]
        self.pod_count[j] -= 1
        cc = self.node_cls_counts[j]
        nc = cc.get(c, 0) - 1
        if nc:
            cc[c] = nc
        else:
            cc.pop(c, None)
        if has_aff:
            self.bound_affinity -= 1

    # ------------------------------------------------------------- priming

    def _prime(
        self, nodes: list[Obj], all_pods: list[Obj], hard_w: int, added_affinity,
        node_infos: "list[NodeInfo] | None" = None,
    ) -> None:
        """Rebuild the cached state from scratch (around a full encode).
        ``node_infos``: the cold pass's own snapshot, when the caller
        already built it — saves the duplicate O(all-pods) bound scan."""
        from kube_scheduler_simulator_tpu_torch.models.podresources import node_allocatable

        N = len(nodes)
        self._cfg_key = (hard_w, _sig(added_affinity))
        self.node_names = tuple(n["metadata"]["name"] for n in nodes)
        self.node_fp = tuple(self._node_fp(n) for n in nodes)
        self.node_by_name = {nm: j for j, nm in enumerate(self.node_names)}
        node_labels = [n["metadata"].get("labels") or {} for n in nodes]
        node_taints = [(n.get("spec") or {}).get("taints") or [] for n in nodes]
        self.taint_reps, self.taint_idx = _group(node_taints, _sig)
        self.nl_reps, self.nl_idx = _node_label_reps(node_labels, list(self.node_names))
        _sets, self.img_states, self.nimg_reps, self.nimg_idx = _node_image_tables(nodes)
        self.nimg_sets = [set(s) for s in self.nimg_reps]
        alloc_d: list[dict] = []
        max_pods = np.zeros(N, dtype=np.int64)
        nz_alloc = np.zeros((N, 2), dtype=np.int64)
        for j, n in enumerate(nodes):
            a = node_allocatable(n)
            alloc_d.append(a)
            max_pods[j] = a.get(PODS, 0)
            nz_alloc[j] = (a.get(CPU, 0), a.get(MEMORY, 0))
        self.alloc_d = alloc_d
        self.max_pods_arr = max_pods
        self.nz_alloc_arr = nz_alloc
        self.requested_d: list[dict] = [dict() for _ in range(N)]
        self.nonzero = np.zeros((N, 2), dtype=np.int64)
        self.pod_count = np.zeros(N, dtype=np.int64)
        self.cls_index: dict[str, int] = {}
        self.cls_reps: list[Obj] = []
        self.node_cls_counts: "list[dict[int, int]]" = [dict() for _ in range(N)]
        self.bound: dict[str, tuple] = {}
        self.bound_affinity = 0
        # lazy class-matrix row caches (valid while the node tables are)
        self.tol_rows: dict[str, tuple] = {}
        self.aff_rows: dict[str, tuple] = {}
        self.pref_rows: dict[str, Any] = {}
        self.img_rows: dict[str, Any] = {}
        if node_infos is not None:
            bound_iter = ((p, j) for j, ni in enumerate(node_infos) for p in ni.pods)
        else:
            bound_iter = (
                (p, j)
                for p in all_pods
                if (nn := (p.get("spec") or {}).get("nodeName"))
                and (j := self.node_by_name.get(nn)) is not None
            )
        for p, j in bound_iter:
            meta = p["metadata"]
            key = meta.get("namespace", "default") + "/" + meta["name"]
            e = self._entry(p, self._pod_fp(p), j)
            self.bound[key] = e
            self._add(e)  # maintains bound_affinity via the entry flag
        self._primed = True

    # ------------------------------------------------------------ seed view

    def _node_planes(self, res_idx: dict[str, int], R: int):
        """The [N,*] resource planes for a seeded encode — fresh arrays
        (the GCD scaling and nominated-pod adjustments mutate them)."""
        N = len(self.node_names)
        alloc = np.zeros((N, R), dtype=np.int64)
        requested0 = np.zeros((N, R), dtype=np.int64)
        for j in range(N):
            for r, v in self.alloc_d[j].items():
                c = res_idx.get(r)
                if c is not None:
                    alloc[j, c] = v
            d = self.requested_d[j]
            if d:
                row = requested0[j]
                for r, v in d.items():
                    c = res_idx.get(r)
                    if c is not None:
                        row[c] = v
        return (
            alloc,
            requested0,
            self.nonzero.copy(),
            self.nz_alloc_arr.copy(),
            self.pod_count.copy(),
            self.max_pods_arr.copy(),
        )


def objective_planes(pr: "BatchProblem", pending: "list[Obj] | None" = None) -> dict:
    """Host-side objective planes for the tuner (tuning/objective.py).

    ``age_w`` [P]: normalized pending-age weight per pod row — how much an
    unscheduled outcome for that pod costs the pending-age objective.
    Derived from creationTimestamp seniority when the timestamps parse and
    differ; otherwise from queue rank (the pending order IS the
    PrioritySort age order within a priority band).  Normalized to (0, 1]
    with the oldest pod at 1; padding rows (pod_active False) carry 0.

    Shapes follow the (possibly padded) problem axes, so the planes go to
    the device beside the lowered DeviceProblem."""
    P = pr.P
    p_true = min(getattr(pr, "P_true", P) or P, P)
    age = None
    if pending:
        import calendar
        import time as _time

        ts: "list[int] | None" = []
        for p in pending[:p_true]:
            raw = (p.get("metadata") or {}).get("creationTimestamp") or ""
            try:
                ts.append(calendar.timegm(_time.strptime(raw, "%Y-%m-%dT%H:%M:%SZ")))
            except (TypeError, ValueError):
                ts = None
                break
        if ts and len(set(ts)) > 1:
            a = np.asarray(ts, dtype=np.float64)
            age = (a.max() - a) + 1.0  # oldest pod → largest weight
            age = age / age.max()
    if age is None and p_true:
        age = np.arange(p_true, 0, -1, dtype=np.float64) / float(p_true)
    out = np.zeros(P, dtype=np.float64)
    if age is not None:
        out[: len(age)] = age
    return {"age_w": out}
