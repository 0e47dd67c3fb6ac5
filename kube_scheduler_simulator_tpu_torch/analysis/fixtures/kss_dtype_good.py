"""KSS-DTYPE good fixture: pinned dtypes and devices, float reductions,
``*_like`` calls and operands whose dtype the AST cannot see."""

import numpy as np
import torch


def planes(N, P, dev, scores, node_mask):
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    carry = torch.zeros((P, N), dtype=torch.int32, device=dev)
    like = torch.zeros_like(carry)
    placed = (rows >= 0).sum(dtype=torch.int32)
    ranks = torch.cumsum(node_mask.to(torch.int32), dim=0, dtype=torch.int32)
    total = scores.float().sum()
    weighted = (scores * 0.5).sum()
    opaque = scores.sum()
    host = np.asarray(node_mask).sum()
    return like, placed, ranks, total, weighted, opaque, host
