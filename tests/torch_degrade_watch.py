"""A pytest plugin that holds every port test to "no kernel error degraded
without chaos".

The port's round, stream and estimator finish a kernel error on the
sequential cycle (``kernels.degradable`` counts each one in
``kernels.DEGRADES``).  Before they did, a fault of a plain version raised
and failed its test; now it would pass quietly.  This plugin's hooks fail
the setup or the call of any test of a ``tests/test_torch_*`` module that
added to ``kernels.DEGRADES``, but those of ``CHAOS_MODULES``, which
inject kernel failures on purpose.  tests/test_torch_fuzz.py registers it
(``pytest_plugins``), so it is active in every process that collects the
port's tests; hooks, unlike an autouse fixture, also reach the tests
collected before that module."""

from __future__ import annotations

import pytest

CHAOS_MODULES = frozenset({"test_torch_fuzz"})
# the tests that degraded a kernel error without chaos, by node id
OFFENDERS: "dict[str, dict[str, int]]" = {}


def watched(module_name: str) -> bool:
    name = module_name.rsplit(".", 1)[-1]
    return name.startswith("test_torch_") and name not in CHAOS_MODULES


def added_degrades(before: "dict[str, int]") -> "dict[str, int]":
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    return {k: n - before.get(k, 0) for k, n in dict(K.DEGRADES).items() if n != before.get(k, 0)}


def _watch(item, phase: str):
    module = getattr(item, "module", None)
    if module is None or not watched(module.__name__):
        return (yield)
    from kube_scheduler_simulator_tpu_torch.ops import kernels as K

    before = dict(K.DEGRADES)
    result = yield
    added = added_degrades(before)
    if added:
        OFFENDERS[item.nodeid] = added
        pytest.fail(f"{item.nodeid} degraded a kernel error without chaos ({phase}): {added}")
    return result


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _watch(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _watch(item, "call"))
