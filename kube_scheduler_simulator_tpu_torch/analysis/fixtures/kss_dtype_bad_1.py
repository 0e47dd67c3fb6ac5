"""KSS-DTYPE bad fixture 1: creation calls that leave the dtype or the
device to torch's defaults."""

import torch


def planes(N, P, dev):
    rows = torch.arange(N, device=dev)  # expect-finding
    carry = torch.zeros((P, N), dtype=torch.int32)  # expect-finding
    fill = torch.full((N,), -1)  # expect-finding
    return rows, carry, fill
