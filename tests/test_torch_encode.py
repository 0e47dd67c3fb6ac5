"""The PyTorch port's host encoder and lowering against the JAX package's.

Same cluster objects through both packages' ``encode`` + ``pad_problem`` +
``lower``; every encoded attribute and every lowered field must be equal
(exact: the encoders are integer numpy code, the lowered planes float64
casts of the same integers).  The port lowers onto the CPU here.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from kube_scheduler_simulator_tpu.ops import batch as JB  # noqa: E402
from kube_scheduler_simulator_tpu.ops import encode as JE  # noqa: E402
from kube_scheduler_simulator_tpu_torch import interop, workloads  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import batch as TB  # noqa: E402
from kube_scheduler_simulator_tpu_torch.ops import encode as TE  # noqa: E402


@pytest.fixture(autouse=True)
def _x64():
    """The reference runs in float64 here (the port's CPU dtype), scoped to
    each test so other test files keep the process default."""
    with jax.enable_x64(True):
        yield


def _graft():
    import __graft_entry__ as ge

    nodes, pods = ge._build_objects(16, 32)
    return nodes, pods, pods


def _cfg2():
    # taints + tolerations, nodeSelector, one unschedulable node, one
    # nodeName-pinned pod, images on nodes and pods, bound pods
    return workloads.cluster(40, 60, seed=11, n_bound=25)


def _empty():
    nodes, all_pods, _pending = workloads.cluster(0, 12, seed=2, n_bound=6)
    return nodes, all_pods, []


def _storage():
    # host ports, bound and unbound claims, shared claims, cloud disks and
    # CSI nodes, held by bound pods too
    nodes, all_pods, pending = workloads.cluster(60, 70, seed=4, n_bound=40)
    workloads.add_host_ports(all_pods)
    return nodes, all_pods, pending, workloads.add_volumes(nodes, all_pods, 40)


CLUSTERS = {"graft": _graft, "cfg2": _cfg2, "empty": _empty, "storage": _storage}


def jax_fields(dp) -> dict:
    return {
        k: tuple(np.asarray(x) for x in v) if isinstance(v, tuple) else np.asarray(v)
        for k, v in dp._asdict().items()
    }


def assert_same_value(name, want, got):
    """A port field (tensor, tuple of tensors or int) equals the JAX one."""
    if isinstance(got, tuple):
        assert isinstance(want, tuple) and len(want) == len(got), name
        for j, (w, g) in enumerate(zip(want, got)):
            assert_same_value(f"{name}[{j}]", w, g)
        return
    if isinstance(got, torch.Tensor):
        g = got.numpy()
        w = np.asarray(want)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        assert np.array_equal(g, w), name
        return
    assert int(got) == int(np.asarray(want)), name


def _encode_both(which):
    nodes, all_pods, pending, *vols = CLUSTERS[which]()
    vols = vols[0] if vols else {}
    jpr = JE.pad_problem(JE.encode(nodes, all_pods, pending, volumes=vols))
    tpr = TE.pad_problem(TE.encode(nodes, all_pods, pending, volumes=vols))
    return jpr, tpr


@pytest.mark.parametrize("which", sorted(CLUSTERS))
def test_encode_matches_reference(which):
    jpr, tpr = _encode_both(which)
    jv, tv = vars(jpr), vars(tpr)
    assert set(jv) == set(tv)
    for k in jv:
        a, b = jv[k], tv[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
        else:
            assert a == b, k


@pytest.mark.parametrize("which", sorted(CLUSTERS))
def test_lower_matches_reference(which):
    jpr, tpr = _encode_both(which)
    jdp, jdims = JB.lower(jpr)
    tdp, tdims = TB.lower(tpr, dtype=torch.float64, device="cpu")
    assert tdims == jdims
    jf = jax_fields(jdp)
    for name in TB.DeviceProblem._fields:
        if name not in TB.LIST_FIELDS:
            assert_same_value(name, jf[name], getattr(tdp, name))
    # the port's own per-pod column and term-group lists: each row's set
    # columns (each pod's matching groups), ascending
    lists = TB.volume_lists(jf["pod_ports"], jf["pod_restr"], jf["pod_csi"], jf["csi_drv_oh"])
    lists.update(TB.term_lists(jf["term_match"]))
    for name in TB.LIST_FIELDS:
        assert np.array_equal(getattr(tdp, name).numpy(), lists[name]), name
    for mask, name in ((jf["pod_ports"], "port_cols"), (jf["pod_restr"], "restr_cols"), (jf["pod_csi"], "csi_cols"),
                       (np.asarray(jf["term_match"]).T, "ip_match_g")):
        for i in range(mask.shape[0]):
            row = lists[name][i]
            assert row[row >= 0].tolist() == np.nonzero(mask[i])[0].tolist(), (name, i)
    if which == "storage":
        assert all(lists[n].max() >= 0 for n in ("port_cols", "restr_cols", "csi_cols", "csi_drv"))
    # every port field is a JAX field; the JAX-only ones are the on-device
    # expansion placeholders, the traced weight vector and the one-hot key
    # expansion (the port gathers through node_domain and gdom instead)
    assert set(jf) - set(TB.DeviceProblem._fields) == {
        "taint_fail", "taint_prefer", "unsched_ok", "aff_code", "aff_pref",
        "name_ok", "incl", "img_score", "vb_code", "vz_code", "plugin_w",
        "key_valid", "key_oh", "g_ku",
    }


@pytest.mark.parametrize("which", sorted(CLUSTERS))
def test_from_jax_problem_matches_lower(which):
    jpr, tpr = _encode_both(which)
    jdp, jdims = JB.lower(jpr)
    carried, cdims = interop.from_jax_problem(jax_fields(jdp), jdims, device="cpu")
    own, odims = TB.lower(tpr, dtype=torch.float64, device="cpu")
    assert cdims == odims
    for name in TB.DeviceProblem._fields:
        a, b = getattr(carried, name), getattr(own, name)
        if isinstance(a, tuple):
            assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), name
        elif isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name


def test_lower_float32_planes_and_one_buffer():
    """float32 lowering casts the same integers; every tensor views one
    shared buffer (one host-to-device copy)."""
    _jpr, tpr = _encode_both("cfg2")
    dp, _dims = TB.lower(tpr, dtype=torch.float32, device="cpu")
    assert dp.alloc.dtype == torch.float32 and dp.pod_req.dtype == torch.float32
    assert np.array_equal(dp.alloc.numpy(), np.asarray(tpr.alloc, dtype=np.float32))
    storages = {
        t.untyped_storage().data_ptr()
        for name in TB.DeviceProblem._fields
        for t in (getattr(dp, name) if isinstance(getattr(dp, name), tuple) else (getattr(dp, name),))
        if isinstance(t, torch.Tensor)
    }
    assert len(storages) == 1
