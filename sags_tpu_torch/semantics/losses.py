"""Semantic losses: per-pixel CE and the 3D neighbourhood-consistency term
(`sags_tpu.semantics.losses` in torch)."""

from __future__ import annotations

import math

import torch

from sags_tpu_torch.ops.knn import knn


def object_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """logits [K,H,W], labels [H,W] int → scalar CE / log(num_classes)."""
    K = logits.shape[0]
    logp = torch.log_softmax(logits, dim=0)
    onehot = labels[None] == torch.arange(K, dtype=labels.dtype,
                                          device=labels.device)[:, None, None]
    picked = torch.sum(torch.where(onehot, logp, torch.zeros_like(logp)), dim=0)
    return -torch.mean(picked) / math.log(num_classes)


class _GatherRows(torch.autograd.Function):
    """`src[idx]` over rows, with a backward that is bitwise reproducible:
    the cotangent rows are stably sorted by index and each index's run is
    summed in a fixed order (`torch.segment_reduce`, the pattern of
    `ops.composite.scatter_rows`). The backward of plain indexing adds
    duplicate indices in parallel, in an order that changes from run to run;
    the JAX package's scatter-add is deterministic."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = src.shape[0]
        return src[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        rows = grad.reshape(flat.numel(), -1)[order]
        lengths = torch.bincount(flat, minlength=ctx.n_rows)
        out = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True)
        return out.reshape((ctx.n_rows,) + grad.shape[idx.dim():]), None


def loss_cls_3d(features: torch.Tensor, predictions: torch.Tensor,
                uniform: torch.Tensor, active: torch.Tensor, k: int = 5,
                lambda_val: float = 2.0, sample_size: int = 1000) -> torch.Tensor:
    """KL(sample ‖ its k xyz-neighbours) over the fixed-capacity map.

    `uniform` [N] are the U[0,1) draws that pick the sample (top-k of the
    draws over active slots — the JAX package's Gumbel-top-k form)."""
    neg_inf = torch.full_like(uniform, -float("inf"))
    scores = torch.where(active, uniform, neg_inf)
    _, sample_idx = torch.topk(scores, sample_size)
    sample_feat = features[sample_idx]
    sample_pred = predictions[sample_idx]
    far = torch.where(active[:, None], features, torch.full_like(features, 1e10))
    _, nbr_idx = knn(sample_feat, far, k=k, chunk=min(1024, sample_size))
    nbr_pred = _GatherRows.apply(predictions, nbr_idx)  # a row is many samples' neighbour
    kl = sample_pred[:, None, :] * (torch.log(sample_pred[:, None, :] + 1e-10)
                                    - torch.log(nbr_pred + 1e-10))
    loss = torch.mean(torch.sum(kl, dim=-1))
    return lambda_val * loss / predictions.shape[-1]
