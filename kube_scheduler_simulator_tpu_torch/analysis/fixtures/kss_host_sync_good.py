"""KSS-HOST-SYNC good fixture: host values from the host, tensors left on
the card."""

import torch


def launch(lib, out: torch.Tensor, widest: int, sizes, dims):
    rc = lib.kss_scan(out.data_ptr(), int(widest))
    n = int(len(sizes))
    k = float(sum(sizes))
    cells = int(torch.Size(sizes).numel())
    width = int(dims["N"])
    return rc, n, k, cells, width, out
