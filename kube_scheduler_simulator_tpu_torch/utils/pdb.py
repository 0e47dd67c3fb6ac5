"""PodDisruptionBudget dry-run accounting, shared by every component
that plans evictions: DefaultPreemption's victim selection
(plugins/intree/queue_bind.py) and the autoscaler's scale-down drain
(autoscaler/engine.py).  One implementation so the two can never
diverge on what "violates a PDB" means.
"""

from __future__ import annotations

from typing import Any

Obj = dict[str, Any]


def violates_pdb(victim: Obj, pdbs: list[Obj], budget: dict[int, int]) -> bool:
    """Would evicting ``victim`` violate any matching PDB?

    ``budget`` is the dry run's remaining disruptions per PDB index —
    shared across the whole planning pass (each planned eviction
    consumes one from every matching budget), seeded lazily from
    ``status.disruptionsAllowed``.  Mutates ``budget``; callers
    roll back by keeping their own trial copy."""
    from kube_scheduler_simulator_tpu_torch.utils.labels import match_label_selector

    vio = False
    for idx, pdb in enumerate(pdbs):
        if (pdb["metadata"].get("namespace") or "default") != (
            victim["metadata"].get("namespace") or "default"
        ):
            continue
        if not match_label_selector(
            (pdb.get("spec") or {}).get("selector"), victim["metadata"].get("labels") or {}
        ):
            continue
        if idx not in budget:
            budget[idx] = int(((pdb.get("status") or {}).get("disruptionsAllowed")) or 0)
        budget[idx] -= 1
        if budget[idx] < 0:
            vio = True
    return vio
