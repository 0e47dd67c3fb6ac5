import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_reference_checks import exec_on_port  # noqa: E402

exec_on_port("test_selectors", globals())


# ------------------------------------------------------- both packages

import random  # noqa: E402

from kube_scheduler_simulator_tpu.utils import k8s_selectors as ref_selectors  # noqa: E402
from kube_scheduler_simulator_tpu_torch.utils import k8s_selectors as port_selectors  # noqa: E402

LABEL_SELECTORS = ["app=web", "app==web,tier!=db", "env in (a, b),app notin (x)", "!canary", "canary",
                   "app", "tier notin (fe)", "", "app=", "bad key=v", "env in (a", "x=y=z"]
FIELD_SELECTORS = ["metadata.name=p-1", "spec.nodeName!=n-0", "status.phase=Pending,metadata.namespace=default",
                   "metadata.name==p-2", "", "spec.nodeName", "metadata.labels=x"]


def seeded_objects(n: int = 60) -> list:
    rng = random.Random(5)
    out = []
    for i in range(n):
        labels = {k: rng.choice(["web", "db", "a", "b", "x", "fe"]) for k in ("app", "env", "tier", "canary")
                  if rng.random() < 0.6}
        out.append({"metadata": {"name": f"p-{i % 4}", "namespace": rng.choice(["default", "team"]),
                                 "labels": labels},
                    "spec": {"nodeName": rng.choice(["n-0", "n-1", ""])},
                    "status": {"phase": rng.choice(["Pending", "Running"])}})
    return out


def outcome(parse, s, args) -> tuple:
    try:
        pred = parse(s)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return ("error", type(e).__name__, str(e))
    return ("ok", [bool(pred(a)) for a in args])


@pytest.mark.parametrize("sel", LABEL_SELECTORS)
def test_both_packages_parse_and_match_a_label_selector_alike(sel):
    labels = [o["metadata"]["labels"] for o in seeded_objects()]
    assert outcome(port_selectors.parse_label_selector, sel, labels) == outcome(
        ref_selectors.parse_label_selector, sel, labels)


@pytest.mark.parametrize("sel", FIELD_SELECTORS)
def test_both_packages_parse_and_match_a_field_selector_alike(sel):
    objs = seeded_objects()
    assert outcome(port_selectors.parse_field_selector, sel, objs) == outcome(
        ref_selectors.parse_field_selector, sel, objs)
