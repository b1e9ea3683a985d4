"""Exact k-nearest-neighbour queries with chunked distance matrices
(`sags_tpu.ops.knn`): ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b per query chunk, then a
top-k of the negated distances."""

from __future__ import annotations

import torch


def knn(queries: torch.Tensor, points: torch.Tensor, k: int, chunk: int = 1024,
        exclude_self: bool = False):
    """k nearest `points` [N,3] of each of `queries` [M,3].
    Returns (sq_dists [M,k], indices [M,k] int64), ascending by distance."""
    kk = k + 1 if exclude_self else k
    pt_sq = torch.sum(points * points, dim=-1)
    negs, idxs = [], []
    for q0 in range(0, queries.shape[0], chunk):
        qc = queries[q0:q0 + chunk]
        d2 = torch.sum(qc * qc, dim=-1)[:, None] + pt_sq[None, :] - 2.0 * (qc @ points.T)
        neg, idx = torch.topk(-d2, kk, dim=-1)
        negs.append(neg)
        idxs.append(idx)
    neg = torch.cat(negs) if negs else queries.new_zeros((0, kk))
    idx = torch.cat(idxs) if idxs else torch.zeros((0, kk), dtype=torch.int64,
                                                   device=queries.device)
    d2 = torch.clamp(-neg, min=0.0)
    if exclude_self:
        d2, idx = d2[:, 1:], idx[:, 1:]
    return d2, idx
