"""Masked segment reductions (counterparts of ``regcn_tpu/ops/segment.py``).

These are plain XLA ops in the JAX package, so plain ``index_add_`` (and
``scatter_reduce`` for the softmax's segment max) is their port. Sums
accumulate in fp32; an empty segment gives 0.
"""

from __future__ import annotations

import torch


def masked_segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, mask: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Segment-sum where padded entries (mask==0) contribute zero."""
    m = mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
    contrib = (data * m).float()
    out = contrib.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, contrib).to(data.dtype)


def masked_segment_mean(
    data: torch.Tensor, segment_ids: torch.Tensor, mask: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Mean over valid entries per segment; empty segments yield zeros.

    Used for relation-context pooling: parity with the Python span loop at
    ref:src/rrgcn.py:161-166 (mean of incident-entity embeddings per
    relation, zeros for relations absent from the snapshot).
    """
    s = masked_segment_sum(data, segment_ids, mask, num_segments)
    cnt = mask.float().new_zeros(num_segments).index_add_(0, segment_ids, mask.float())
    cnt = cnt.to(data.dtype).reshape(cnt.shape + (1,) * (s.ndim - 1))
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), torch.zeros_like(s))


def segment_softmax(
    logits: torch.Tensor, segment_ids: torch.Tensor, mask: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Numerically stable softmax over the masked entries of each segment.

    ``logits`` [E] or [E, ...] (a trailing axis per attention head),
    ``segment_ids`` and ``mask`` [E]. Masked logits count as the dtype's
    lowest finite value, the max of an empty segment is taken as 0 and the
    denominator is clamped to 1e-16, so a masked entry and every entry of
    an all-masked segment get 0. The segment max only shifts the
    exponents, and its own gradient cancels in the softmax, so it is
    detached here (JAX differentiates through it; both give the same
    gradient up to rounding)."""
    m = mask.reshape(mask.shape + (1,) * (logits.dim() - 1))
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(m > 0, logits, torch.full_like(logits, neg))
    ids = segment_ids.reshape(m.shape).expand_as(logits)
    seg_max = torch.full((num_segments,) + tuple(logits.shape[1:]), float("-inf"),
                         dtype=logits.dtype, device=logits.device)
    seg_max = seg_max.scatter_reduce(0, ids, masked.detach(), "amax", include_self=False)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros_like(seg_max))
    shifted = torch.exp(masked - seg_max[segment_ids]) * m
    denom = shifted.new_zeros(seg_max.shape).index_add_(0, segment_ids, shifted)
    return shifted / torch.clamp(denom[segment_ids], min=1e-16)
