"""ImageLocality score tables (upstream v1.26).

score = scale(sum over pod container images of size*spread) where
spread = numNodesHavingImage / totalNodes, clamped into
[23MB, 1000MB * numContainers] then mapped to [0,100].
"""

from __future__ import annotations

from kube_scheduler_simulator_tpu_torch.models.framework import MAX_NODE_SCORE

MIN_THRESHOLD = 23 * 1024 * 1024
MAX_CONTAINER_THRESHOLD = 1000 * 1024 * 1024


def _normalized_image_name(name: str) -> str:
    if ":" not in name.rsplit("/", 1)[-1]:
        name += ":latest"
    return name


def score_from_total(total: int, num_containers: int) -> int:
    """Map the summed size×spread to [0, MAX_NODE_SCORE] (upstream
    calculatePriority)."""
    max_threshold = MAX_CONTAINER_THRESHOLD * num_containers
    if total < MIN_THRESHOLD:
        return 0
    if total > max_threshold:
        return int(MAX_NODE_SCORE)
    return int(MAX_NODE_SCORE * (total - MIN_THRESHOLD) / (max_threshold - MIN_THRESHOLD))
