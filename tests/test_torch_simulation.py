import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import exec_on_port  # noqa: E402

exec_on_port("test_scheduler_simulation", globals())


# ------------------------------------------------------- both packages

import jax  # noqa: E402

from kube_scheduler_simulator_tpu.scenario.simulation import (  # noqa: E402
    run_scheduler_simulation as ref_run,
)
from kube_scheduler_simulator_tpu_torch.scenario.simulation import (  # noqa: E402
    run_scheduler_simulation as port_run,
)
from torch_reference_checks import answer_alike, both_servers, normalized  # noqa: E402


def _two_simulators() -> dict:
    obj = _simulation_obj()
    obj["spec"]["simulators"] = [
        {"name": "batch", "useBatch": "auto"},
        {"name": "fit-only", "useBatch": "off", "schedulerConfig": {"profiles": [{
            "schedulerName": "default-scheduler",
            "plugins": {"multiPoint": {"enabled": [{"name": "NodeResourcesFit"}, {"name": "PrioritySort"},
                                                   {"name": "DefaultBinder"}],
                                       "disabled": [{"name": "*"}]}}}]}},
    ]
    return obj


@pytest.mark.parametrize("case", ["default", "two simulators", "template outside the directory", "no scenario"])
def test_both_packages_run_a_scheduler_simulation_alike(case, tmp_path, monkeypatch):
    monkeypatch.delenv("KSS_AOT_CACHE_DIR", raising=False)
    obj = {"default": _simulation_obj, "two simulators": _two_simulators,
           "no scenario": lambda: {"spec": {}},
           "template outside the directory": lambda: {"spec": {"scenarioTemplateFilePath": "../../etc/passwd"}}}[case]()
    monkeypatch.setenv("KSS_SCENARIO_TEMPLATE_DIR", str(tmp_path))
    with jax.enable_x64(True):
        want = ref_run(obj)
    got = port_run(obj, device="cpu")
    assert normalized(got) == normalized(want)


def test_both_servers_run_a_posted_simulation_alike(monkeypatch):
    servers = both_servers(use_batch="off")
    try:
        (code, body), = answer_alike(servers, [("POST", "/api/v1/schedulersimulations", _simulation_obj(), False)])
        assert code == 200 and body["status"]["phase"] == "Completed"
    finally:
        for s in servers:
            s.close()
