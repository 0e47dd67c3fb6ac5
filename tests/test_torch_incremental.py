"""The port's incremental path against the JAX package's: the EncodeCache
(delta re-encode across rounds) and the DevicePlacer (planes resident on
the device, row updates through the scatter kernel's plain version here).

The same seeded churn goes through both packages.  Every wave the port's
cached encode equals a cold encode and the JAX cache's encode, array for
array, with the same fallback reasons counted; the two placers make the
same decision for every plane both problems carry (reuse, scatter or full
upload, with the same bytes), and a scattered row lands.  Mirrors
tests/test_encode_incremental.py.
"""

from __future__ import annotations

import random
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.ops import batch as JB  # noqa: E402
from kube_scheduler_simulator_tpu.ops import encode as JE  # noqa: E402
from test_encode_incremental import Cluster, assert_problem_equal  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import encode as TE  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    """The reference lowers in float64 here (the port's CPU dtype), scoped
    to each test."""
    with jax.enable_x64(True):
        yield


def _cluster(seed: int, n_nodes: int = 10, pending: int = 12, warm: int = 0) -> Cluster:
    cl = Cluster(n_nodes, random.Random(seed))
    cl.pending = [cl.mk_pod() for _ in range(pending)]
    for _ in range(warm):
        cl.churn(binds=4, deletes=0, mutates=0, new_pending=4)
    return cl


def _stats(cache) -> dict:
    return {k: cache.stats[k] for k in (
        "encode_full_total", "encode_delta_total", "encode_rows_reencoded_total", "encode_fallbacks_by_reason",
    )}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_cache_randomized_churn_parity(seed):
    """Random add/delete/modify streams with nomination churn: every wave
    the port's cached encode equals its cold encode and the JAX cache's
    encode, and both caches count the same delta and full encodes."""
    rng = random.Random(seed)
    cl = Cluster(10, rng)
    cl.pending = [cl.mk_pod(pend_affinity=seed == 1) for _ in range(12)]
    port, ref = TE.EncodeCache(), JE.EncodeCache()
    for wave in range(6):
        noms = [(cl.mk_pod(), f"node-{rng.randrange(10)}")] if wave % 2 == 1 else None
        cold = TE.encode(cl.nodes, cl.all_pods(), cl.pending, None, nominated=noms)
        inc = port.encode(cl.nodes, cl.all_pods(), cl.pending, None, nominated=noms)
        want = ref.encode(cl.nodes, cl.all_pods(), cl.pending, None, nominated=noms)
        assert_problem_equal(cold, inc, f"seed={seed} wave={wave} cold")
        assert_problem_equal(want, inc, f"seed={seed} wave={wave} reference")
        assert _stats(port) == _stats(ref), wave
        cl.churn(pend_affinity=seed == 1)
    assert port.stats["encode_delta_total"] >= 4 and port.stats["encode_full_total"] == 1, port.stats


def test_encode_cache_gates_fall_back_by_reason():
    """Each exactness gate routes both caches to a counted cold encode, for
    the same reason, and the encodes still match."""
    cl = _cluster(7, n_nodes=8, pending=6)
    for _ in range(2):
        cl.churn(binds=3, deletes=0, mutates=0, new_pending=3)
    port, ref = TE.EncodeCache(), JE.EncodeCache()

    def both(tag, **kw):
        cold = TE.encode(cl.nodes, cl.all_pods(), cl.pending, None, **kw)
        inc = port.encode(cl.nodes, cl.all_pods(), cl.pending, None, **kw)
        want = ref.encode(cl.nodes, cl.all_pods(), cl.pending, None, **kw)
        assert_problem_equal(cold, inc, tag)
        assert_problem_equal(want, inc, tag)
        assert _stats(port) == _stats(ref), tag

    both("cold")
    assert port.stats["encode_fallbacks_by_reason"] == {"cold start": 1}
    both("delta")
    assert port.stats["encode_delta_total"] == 1
    # a node label flip: "node set changed"
    cl.nodes[2] = cl.mk_node(2)
    cl.nodes[2]["metadata"]["labels"]["disk"] = "nvme"
    both("node-change")
    assert port.stats["encode_fallbacks_by_reason"]["node set changed"] == 1
    # a cordon (spec.unschedulable) is a node change too
    cl.nodes[4] = dict(cl.nodes[4], spec={**cl.nodes[4]["spec"], "unschedulable": True})
    cl.nodes[4]["metadata"] = {**cl.nodes[4]["metadata"], "resourceVersion": cl.rv()}
    both("cordon")
    assert port.stats["encode_fallbacks_by_reason"]["node set changed"] == 2
    # a bound pod with inter-pod affinity gates while present
    evil = cl.mk_pod(node="node-1")
    evil["spec"]["affinity"] = {
        "podAntiAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                {"labelSelector": {"matchLabels": {"app": "a1"}}, "topologyKey": "kubernetes.io/hostname"}
            ]
        }
    }
    cl.bound[evil["metadata"]["name"]] = evil
    both("bound-affinity")
    assert port.stats["encode_fallbacks_by_reason"]["bound pods carry inter-pod affinity"] == 1
    del cl.bound[evil["metadata"]["name"]]
    both("affinity-gone")
    # pending volumes gate
    vp = cl.mk_pod()
    vp["spec"]["volumes"] = [{"name": "v", "persistentVolumeClaim": {"claimName": "c1"}}]
    vols = {
        "persistentvolumeclaims": [{"metadata": {"name": "c1", "namespace": "default"}, "spec": {"volumeName": "pv1"}}],
        "persistentvolumes": [{"metadata": {"name": "pv1"}, "spec": {}}],
    }
    cl.pending.append(vp)
    both("volumes", volumes=vols)
    assert port.stats["encode_fallbacks_by_reason"]["pending pods mount volumes"] == 1
    cl.pending.pop()
    both("volumes-gone")


# -------------------------------------------------------------- placer

def _jax_decisions(placer, dp, key) -> dict:
    """Place ``dp`` with the JAX DevicePlacer (its default bank 0) and read
    back its decision for every plane: ("reuse" | "scatter" | "full" |
    "carry", bytes uploaded)."""
    entry = placer._cache.get(key, {}).get(0, {})
    old = {path: dev for path, (_host, dev) in entry.items()}
    by_id = {id(dev): path for path, dev in old.items()}
    scattered: dict = {}
    real = placer._scatter

    def spy(cached_dev, idx, rows):
        out = real(cached_dev, idx, rows)
        k = min(JE._bucket(len(idx)), cached_dev.shape[0])
        scattered[by_id[id(cached_dev)]] = (4 + rows.nbytes // len(rows)) * k
        return out

    placer._scatter = spy
    try:
        placer.place(dp, key)
    finally:
        placer._scatter = real
    new = placer._cache[key][0]
    out = {}
    for name, val in dp._asdict().items():
        for sub, leaf in (enumerate(val) if isinstance(val, tuple) else [(None, val)]):
            path = (name, sub)
            if name in JB.CARRY0_FIELDS or not isinstance(leaf, np.ndarray) or leaf.ndim == 0:
                out[path] = ("carry", leaf.nbytes if isinstance(leaf, np.ndarray) and leaf.ndim else 0)
            elif path in scattered:
                out[path] = ("scatter", scattered[path])
            elif path in old and new[path][1] is old[path]:
                out[path] = ("reuse", 0)
            else:
                out[path] = ("full", leaf.nbytes)
    return out


def _both_placers(problems, frac=None):
    """Place each BatchProblem of ``problems`` with both placers; yields
    (JAX decisions, port decisions, port placed problem, port host
    problem) per round, over the planes both problems carry."""
    jp = JB.DevicePlacer(scatter_max_frac=frac)
    tp = TB.DevicePlacer(scatter_max_frac=frac)
    for pr in problems:
        jdp, jdims = JB.lower(pr, dtype=np.float64)
        host, tdims = TB.lower_host(pr, torch.float64)
        want = _jax_decisions(jp, jdp, tuple(sorted(jdims.items())))
        placed = tp.place(host, tuple(sorted(tdims.items())), torch.device("cpu"))
        common = {
            path for path in want.keys() & tp.decisions.keys()
            if (leaf := TB.problem_leaves(host)[path]).shape == np.shape(getattr(jdp, path[0]) if path[1] is None
                                                                        else getattr(jdp, path[0])[path[1]])
            and leaf.dtype == np.asarray(getattr(jdp, path[0]) if path[1] is None else getattr(jdp, path[0])[path[1]]).dtype
        }
        yield {p: want[p] for p in common}, {p: tp.decisions[p] for p in common}, placed, host


def _churn_problems(cl: Cluster, waves: int, cordon_at: "tuple[int, ...]" = ()):
    """Padded problems of a churn sequence; on the waves in ``cordon_at``
    node 3's cordon flips (node_unsched changes in one row)."""
    out = []
    for w in range(waves):
        pr = TE.pad_problem(TE.encode(cl.nodes, cl.all_pods(), cl.pending, None))
        if w in cordon_at:
            pr.node_unsched = pr.node_unsched.copy()
            pr.node_unsched[3] = not pr.node_unsched[3]
        out.append(pr)
        if w % 2:
            cl.churn(binds=4, deletes=1, mutates=0, new_pending=4)
    return out


def test_device_placer_decisions_match_the_reference():
    """On the same churn sequence (new pending pods every other wave, a
    one-row cordon flip on waves 2 and 3) the port's placer and the JAX
    placer decide alike for every plane both problems carry, with the same
    bytes; the node-axis planes are reused, node_unsched scatters, and the
    placed planes equal the host problem's."""
    cl = _cluster(4, n_nodes=8, pending=10, warm=2)
    seen, unsched = set(), []
    # resident planes are updated in place: read each round's placement
    # before the next round places
    for w, (want, got, placed, host) in enumerate(_both_placers(_churn_problems(cl, 5, cordon_at=(2,)))):
        assert got == want, (w, {p: (got[p], want[p]) for p in got if got[p] != want[p]})
        assert {("node_unsched", None), ("alloc", None), ("pod_req", None)} <= got.keys()
        seen |= {kind for kind, _n in got.values()}
        unsched.append(got[("node_unsched", None)][0])
        for (name, sub), leaf in TB.problem_leaves(host).items():
            t = getattr(placed, name) if sub is None else getattr(placed, name)[sub]
            assert np.array_equal(t.numpy(), leaf), (w, name, sub)
    assert seen == {"reuse", "scatter", "full", "carry"}
    # reused, then the flip lands by a row update, and flips back by one
    assert unsched == ["full", "reuse", "scatter", "scatter", "reuse"]


def test_device_placer_counters_and_bytes():
    """The counters: a first placement uploads everything, an identical one
    reuses every plane, a one-row change scatters one padded bucket of
    rows; bytes_uploaded sums what each decision shipped."""
    cl = _cluster(4, n_nodes=8, pending=10, warm=2)
    pr = TE.pad_problem(TE.encode(cl.nodes, cl.all_pods(), cl.pending, None))
    placer = TB.DevicePlacer()
    host, dims = TB.lower_host(pr, torch.float64)
    key = tuple(sorted(dims.items()))
    placer.place(host, key, torch.device("cpu"))
    first = placer.bytes_uploaded
    assert first > 0 and placer.plane_reuses == 0 and placer.full_uploads > 30
    carried = sum(n for kind, n in placer.decisions.values() if kind == "carry")
    host2, _ = TB.lower_host(pr, torch.float64)
    placer.place(host2, key, torch.device("cpu"))
    assert placer.plane_reuses == placer.full_uploads and placer.bytes_uploaded == first + carried
    host3, _ = TB.lower_host(pr, torch.float64)
    host3["node_unsched"] = host3["node_unsched"].copy()
    host3["node_unsched"][3] = True
    d3 = placer.place(host3, key, torch.device("cpu"))
    assert placer.scatter_updates == 1 and placer.last_scattered == ["node_unsched"]
    # one changed row, padded to bucket(1) = 8 rows of one byte + int32 indices
    assert placer.decisions[("node_unsched", None)] == ("scatter", 8 * (1 + 4))
    assert bool(d3.node_unsched[3]) and torch.equal(d3.node_unsched, torch.from_numpy(host3["node_unsched"]))


@pytest.mark.parametrize("frac,kind", [("0.01", "full"), ("1.0", "scatter")])
def test_placer_scatter_frac_knob(monkeypatch, frac, kind):
    """``KSS_PLACER_SCATTER_FRAC`` moves the scatter threshold as the
    reference's does: 0.01 sends a 6-row change up in full, 1.0 scatters it;
    bad values raise."""
    cl = _cluster(4, n_nodes=8, pending=10, warm=2)
    pr = TE.pad_problem(TE.encode(cl.nodes, cl.all_pods(), cl.pending, None))
    monkeypatch.setenv("KSS_PLACER_SCATTER_FRAC", frac)
    placer = TB.DevicePlacer()
    host, dims = TB.lower_host(pr, torch.float64)
    key = tuple(sorted(dims.items()))
    placer.place(host, key, torch.device("cpu"))
    host2, _ = TB.lower_host(pr, torch.float64)
    host2["node_unsched"] = host2["node_unsched"].copy()
    host2["node_unsched"][:6] = ~host2["node_unsched"][:6]
    d = placer.place(host2, key, torch.device("cpu"))
    assert placer.decisions[("node_unsched", None)][0] == kind
    assert torch.equal(d.node_unsched, torch.from_numpy(host2["node_unsched"]))
    for bad in ("0", "1.5", "x"):
        monkeypatch.setenv("KSS_PLACER_SCATTER_FRAC", bad)
        with pytest.raises(ValueError, match="KSS_PLACER_SCATTER_FRAC"):
            TB.DevicePlacer()


def test_placer_keeps_the_last_max_keys_shape_keys():
    """Resident planes are kept per shape key for the last ``max_keys``
    keys: a key placed again while kept reuses its planes; one evicted by
    newer keys uploads in full again."""
    cl = _cluster(4, n_nodes=8, pending=10, warm=2)
    pr = TE.pad_problem(TE.encode(cl.nodes, cl.all_pods(), cl.pending, None))
    placer = TB.DevicePlacer(max_keys=2)
    cpu = torch.device("cpu")

    def place(key):
        before = placer.plane_reuses
        placer.place(TB.lower_host(pr, torch.float64)[0], key, cpu)
        return placer.plane_reuses - before

    assert place("a") == 0 and place("b") == 0
    assert place("a") > 20  # kept: every plane reused
    assert place("c") == 0  # evicts "b", the least recently placed
    assert place("a") > 20 and place("b") == 0
    assert list(placer._cache) == ["a", "b"]
