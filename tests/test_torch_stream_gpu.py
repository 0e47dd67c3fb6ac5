"""The streaming wave pipeline on the card: the twin of
tests/test_torch_stream.py's churn parity case, in a file that does not
import JAX (the card's machine has none).  Skips without a card.

cfg9-stream's shape at a cut (``workloads.stream_cluster`` /
``steady_feed``: 40 nodes, 300 bound pods, 20 arrivals and 20 deletions a
tick, a priming tick then 5) through the port's service on the card in
float64, streamed and serial, and on the CPU streamed: the three final
stores' ``pod_parity_state`` are equal, and every streamed wave launched one
scan and one compaction.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(device: str, streaming: bool):
    from kube_scheduler_simulator_tpu_torch import workloads
    from kube_scheduler_simulator_tpu_torch.ops import kernels
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state.store import ClusterStore
    from kube_scheduler_simulator_tpu_torch.utils.parity import pod_parity_state

    store = ClusterStore(clock=lambda: 1_700_000_000.0)
    settled = workloads.stream_cluster(store, n_nodes=40, seed_bound=300)
    svc = SchedulerService(store, tie_break="first", use_batch="force", device=device, dtype=torch.float64)
    svc.start_scheduler(None)
    kernels.reset_counts()
    for n_ticks, start in ((1, 0), (5, 20)):
        feed = workloads.steady_feed(store, settled, n_ticks, start, per_tick=20, seed_bound=300)
        svc.schedule_stream(feed=feed, streaming=streaming)
    return pod_parity_state(store), svc, dict(kernels.LAUNCHES)


@pytest.mark.gpu
def test_streamed_churn_on_the_card_matches_serial_and_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sys.path.insert(0, str(ROOT))
    streamed, svc, launches = _run("cuda", True)
    serial, _svc, _l = _run("cuda", False)
    cpu, _svc, _l = _run("cpu", True)
    assert streamed == serial and streamed == cpu
    waves = svc.stats["stream_waves"]
    assert waves == 6 and svc.stats["stream_drains"] == {} and svc.stats["stream_overlap_s"] > 0.0
    assert launches["scan"] == waves and launches["compact"] == waves
