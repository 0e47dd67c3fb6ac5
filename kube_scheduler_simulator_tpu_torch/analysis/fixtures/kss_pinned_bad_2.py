"""KSS-PINNED bad fixture 2: a pinned fetch buffer written before the
fetch is waited for, in a function and on an attribute."""

import torch


def fetch(out, ev):
    res = torch.empty(out.shape, dtype=torch.uint8, device="cpu", pin_memory=True)
    res.copy_(out, non_blocking=True)
    ev.record()
    res[0] = 0  # expect-finding
    return res


class Staging:
    def launch(self, dev, n):
        self._host = torch.empty(n, dtype=torch.uint8, device="cpu").pin_memory()
        moved = self._host.to(dev, non_blocking=True)
        self._host.fill_(0)  # expect-finding
        return moved
