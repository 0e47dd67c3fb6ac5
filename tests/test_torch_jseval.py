"""The port's JavaScript tooling (utils/jscheck, jseval, jsdom, jsengine)
against the JAX package's.

- The reference's own tests run against the port (``exec_on_port``): the
  interpreter's semantics (tests/test_jseval.py), the static checks of the
  served script (tests/test_webui_js.py), the port's web UI executed through
  the port's ``jsdom.Harness`` (tests/test_webui_exec.py), and the
  real-engine differential with its frozen language subset
  (tests/test_webui_engine_differential.py: the engine leg skips with its
  reason where the host has no JavaScript engine, as the reference's does).
- The same scripts give the same output through both packages'
  interpreters: every script tests/test_jseval.py runs, and the web UI's
  boot, table view, search and pod dialog through both harnesses.
"""

from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import exec_on_port  # noqa: E402

exec_on_port("test_jseval", globals())


def _port_checks(name: str, prefix: str) -> dict:
    """Run ``tests/<name>.py`` on the port in a namespace of its own and
    register its tests here as ``test_<prefix>_*``."""
    ns: dict = {"__name__": __name__, "__file__": str(Path(__file__).resolve().parent / f"{name}.py")}
    exec_on_port(name, ns)
    for key, fn in list(ns.items()):
        if key.startswith("test_") and callable(fn):
            globals()[f"test_{prefix}_{key[5:]}"] = fn
    return ns


_port_checks("test_webui_js", "webui_js")
_WEBUI_EXEC = _port_checks("test_webui_exec", "webui_exec")
_ENGINE = _port_checks("test_webui_engine_differential", "engine")

# ------------------------------------------------------ both packages

from kube_scheduler_simulator_tpu.server import webui as RW  # noqa: E402
from kube_scheduler_simulator_tpu.utils import jsdom as RD  # noqa: E402
from kube_scheduler_simulator_tpu.utils import jseval as RJ  # noqa: E402
from kube_scheduler_simulator_tpu_torch.server import webui as TW  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils import jsdom as TD  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils import jseval as TJ  # noqa: E402


def _scripts() -> "list[str]":
    """Every script tests/test_jseval.py hands to its interpreter."""
    tree = ast.parse((Path(__file__).resolve().parent / "test_jseval.py").read_text())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "run"
                and node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            out.append(node.args[0].value)
    return out


SCRIPTS = _scripts()


def outcome(J, src: str) -> dict:
    """The globals a script declares, as JavaScript strings, or the error it
    threw."""
    std = set(J.Interp({}).run("").vars)
    try:
        scope = J.Interp({}).run(src)
    except Exception as e:  # noqa: BLE001 - the error is the outcome compared
        return {"error": type(e).__name__, "message": str(e)}
    out = {}
    for name, v in sorted(scope.vars.items()):
        if name in std:
            continue
        try:
            text = J.to_str(v)
        except Exception as e:  # noqa: BLE001
            text = f"<{type(e).__name__}>"
        # a host object's repr names its package and address
        out[name] = re.sub(r" at 0x[0-9a-f]+", "", text).replace(J.__name__, "jseval")
    return out


def test_the_scripts_are_collected_and_most_run_without_a_host():
    clean = [s for s in SCRIPTS if "error" not in outcome(TJ, s)]
    assert len(SCRIPTS) >= 10 and len(clean) >= 10


@pytest.mark.parametrize("i", range(len(SCRIPTS)))
def test_both_interpreters_give_the_same_globals(i):
    """Without a host (the script's timers and fetch undefined), an error
    is part of the outcome and must be the same error."""
    assert outcome(TJ, SCRIPTS[i]) == outcome(RJ, SCRIPTS[i])


def _render(W, D, view: str) -> str:
    mk = _WEBUI_EXEC
    h = D.Harness(W.HTML)
    for k in mk["KINDS"]:
        h.routes[("GET", f"/api/v1/resources/{k}")] = {"items": []}
    h.routes[("GET", "/api/v1/resources/nodes")] = {"items": [mk["node_obj"]("exec-node-1")]}
    h.routes[("GET", "/api/v1/resources/pods")] = {"items": [
        mk["pod_obj"]("exec-pod-a", node="exec-node-1", annotations=mk["SCORED"]), mk["pod_obj"]("exec-pod-pending")]}
    h.routes[("GET", "/api/v1/autoscaler")] = {"mode": "off"}
    interp = h.boot(W.JS)
    if view == "tables":
        interp.get_global("toggleView")()
    elif view == "search":
        interp.get_global("toggleView")()
        h.document._by_id["search"].value = "pending"
        interp.get_global("onSearch")()
        h.flush_timers()
    elif view == "dialog":
        interp.get_global("showPod")(interp.get_global("state")["pods"]["default/exec-pod-a"])
        return D.collect_text(h.document._by_id["dlgbody"])
    return D.collect_text(h.document._by_id["tables" if view != "boot" else "nodes"])


@pytest.mark.parametrize("view", ["boot", "tables", "search", "dialog"])
def test_the_web_ui_renders_alike_through_both_harnesses(view):
    assert TW.HTML == RW.HTML and TW.JS == RW.JS
    ref, port = _render(RW, RD, view), _render(TW, TD, view)
    assert port == ref and "exec-" in port


def test_the_engine_program_emits_alike_through_both_interpreters():
    from tests import test_webui_engine_differential as R

    ref, port = R.run_driver_in_interpreter(), _ENGINE["run_driver_in_interpreter"]()
    assert json.dumps(port) == json.dumps(ref)
