"""ImageLocality score plugin (upstream v1.26).

score = scale(sum over pod container images of size*spread) where
spread = numNodesHavingImage / totalNodes, clamped into
[23MB, 1000MB * numContainers] then mapped to [0,100].
"""

from __future__ import annotations

from typing import Any

from kube_scheduler_simulator_tpu_torch.models.framework import MAX_NODE_SCORE, CycleState, Status
from kube_scheduler_simulator_tpu_torch.models.nodeinfo import NodeInfo

Obj = dict[str, Any]

MIN_THRESHOLD = 23 * 1024 * 1024
MAX_CONTAINER_THRESHOLD = 1000 * 1024 * 1024


def _normalized_image_name(name: str) -> str:
    if ":" not in name.rsplit("/", 1)[-1]:
        name += ":latest"
    return name


def score_from_total(total: int, num_containers: int) -> int:
    """Map the summed size×spread to [0, MAX_NODE_SCORE] (upstream
    calculatePriority) — shared by this plugin and the batch encoder so
    the two can't drift."""
    max_threshold = MAX_CONTAINER_THRESHOLD * num_containers
    if total < MIN_THRESHOLD:
        return 0
    if total > max_threshold:
        return int(MAX_NODE_SCORE)
    return int(MAX_NODE_SCORE * (total - MIN_THRESHOLD) / (max_threshold - MIN_THRESHOLD))


class ImageLocality:
    name = "ImageLocality"

    STATE_KEY = "ImageLocalityImageStates"

    def __init__(self, args: "Obj | None" = None, handle: Any = None):
        self.handle = handle

    def _image_states(self, state: CycleState) -> dict[str, tuple[int, int]]:
        """Cluster-wide image index, built once per scheduling cycle and
        cached in CycleState (score() runs once per node)."""
        cached = state.read(self.STATE_KEY)
        if cached is not None:
            return cached
        image_states: dict[str, tuple[int, int]] = {}
        snap = self.handle.snapshot() if self.handle is not None else None
        if snap is not None:
            for ni in snap.node_infos:
                for img in (ni.node.get("status") or {}).get("images") or []:
                    size = int(img.get("sizeBytes") or 0)
                    for n in img.get("names") or []:
                        sz, cnt = image_states.get(n, (size, 0))
                        image_states[n] = (sz, cnt + 1)
        state.write(self.STATE_KEY, image_states)
        return image_states

    def score(self, state: CycleState, pod: Obj, node_info: NodeInfo) -> "tuple[int, Status | None]":
        snap = self.handle.snapshot() if self.handle is not None else None
        total_nodes = len(snap.node_infos) if snap is not None else 1
        image_states = self._image_states(state)
        node_images = set()
        for img in (node_info.node.get("status") or {}).get("images") or []:
            node_images.update(img.get("names") or [])

        containers = (pod.get("spec") or {}).get("containers") or []
        sum_scores = 0
        for c in containers:
            name = _normalized_image_name(c.get("image") or "")
            if name in node_images and name in image_states:
                size, cnt = image_states[name]
                sum_scores += int(size * cnt / total_nodes) if total_nodes else 0
        return score_from_total(sum_scores, len(containers)), None
