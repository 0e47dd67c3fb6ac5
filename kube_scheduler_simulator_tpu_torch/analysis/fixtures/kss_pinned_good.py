"""KSS-PINNED good fixture: every write of a pinned buffer comes before its
hand-off or after a wait; a fresh buffer, or a pageable one, is free."""

import numpy as np
import torch


def stage(arrays, dev, ev):
    host = torch.empty(1024, dtype=torch.uint8, device="cpu", pin_memory=True)
    hn = host.numpy()
    hn[: arrays[0].nbytes] = arrays[0].view(np.uint8)
    first = host.to(dev, non_blocking=True)
    ev.record()
    ev.synchronize()
    hn[: arrays[1].nbytes] = arrays[1].view(np.uint8)
    second = host.to(dev, non_blocking=True)
    torch.cuda.synchronize(dev)
    host[0] = 1
    return first, second


def fresh(rows, plane):
    staged = torch.empty(rows.shape, dtype=rows.dtype, device="cpu", pin_memory=True)
    plane.copy_(staged, non_blocking=True)
    staged = torch.empty(rows.shape, dtype=rows.dtype, device="cpu", pin_memory=True)
    staged[0] = 1
    pageable = torch.empty(rows.shape, dtype=rows.dtype, device="cpu")
    plane.copy_(pageable, non_blocking=True)
    pageable[0] = 1
    return plane, staged
