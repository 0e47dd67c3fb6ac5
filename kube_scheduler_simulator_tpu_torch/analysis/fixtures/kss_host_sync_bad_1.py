"""KSS-HOST-SYNC bad fixture 1: a wrapper that reads the card on its way to
the launch."""

import torch


def launch(lib, out: torch.Tensor, lane_active: torch.Tensor):
    widest = int(lane_active.sum(dim=1).max())  # expect-finding
    rc = lib.kss_scan(out.data_ptr(), widest)
    first = out[0].item()  # expect-finding
    return rc, first
