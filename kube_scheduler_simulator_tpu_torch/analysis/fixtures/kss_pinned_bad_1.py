"""KSS-PINNED bad fixture 1: a pinned staging buffer written again while
its upload may still be in flight."""

import numpy as np
import torch


def stage(arrays, dev):
    host = torch.empty(1024, dtype=torch.uint8, device="cpu", pin_memory=True)
    hn = host.numpy()
    hn[: arrays[0].nbytes] = arrays[0].view(np.uint8)
    first = host.to(dev, non_blocking=True)
    hn[: arrays[1].nbytes] = arrays[1].view(np.uint8)  # expect-finding
    second = host.to(dev, non_blocking=True)
    return first, second


def upload_rows(rows, plane):
    staged = torch.empty(rows.shape, dtype=rows.dtype, device="cpu", pin_memory=True)
    staged.copy_(rows)
    plane.copy_(staged, non_blocking=True)
    staged.zero_()  # expect-finding
    return plane
