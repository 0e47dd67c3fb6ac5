"""KSS-DTYPE bad fixture 2: integer reductions that torch widens to int64."""

import torch


def counts(sel, node_mask, scores):
    placed = (sel >= 0).sum()  # expect-finding
    ranks = torch.cumsum(node_mask.to(torch.int32), dim=0)  # expect-finding
    hits = torch.where(scores > 0, 1, 0).sum(dim=1)  # expect-finding
    full = torch.prod(node_mask, dim=0)  # expect-finding
    return placed, ranks, hits, full
