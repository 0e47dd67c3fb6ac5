"""KSS-HOST-SYNC bad fixture 2: a dispatch that waits for the card."""

import torch


def dispatch(fn, dp, dev):
    packed = torch.empty((5, 64), dtype=torch.int32, device=dev)
    fn(dp, packed)
    torch.cuda.synchronize(dev)  # expect-finding
    rows = packed.tolist()  # expect-finding
    blob = dp["blob"].cpu()  # expect-finding
    any_placed = bool(packed[0].max() >= 0)  # expect-finding
    return rows, blob, any_placed
