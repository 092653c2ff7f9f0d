"""Ranking metrics: raw + filtered MRR and Hits@k.

Counterpart of ``regcn_tpu/train/metrics.py``. Rank = 1 + the count of
strictly greater scores (the optimistic convention); the filter squashes
other known answers to -1e7 with one scatter over a padded COO.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from regcn_torch.parallel.collectives import all_reduce_sum

FILTER_VALUE = -1e7  # parity with ref:rgcn/utils.py:60


def ranks_from_scores(scores: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """rank[i] = 1 + #{j : scores[i,j] > scores[i,targets[i]]}."""
    tgt = np.take_along_axis(scores, targets[:, None], axis=1)
    return 1 + np.sum(scores > tgt, axis=1).astype(np.int64)


def filtered_ranks(scores: np.ndarray, queries: np.ndarray, targets: np.ndarray,
                   answer_filter) -> np.ndarray:
    """Host ranks after squashing the other known answers of each query
    (``queries`` [B, 2] are the filter keys) to FILTER_VALUE."""
    if answer_filter is None:
        return ranks_from_scores(scores, targets)
    rows, cols = answer_filter.mask_coo(queries, targets)
    if len(rows):
        scores = scores.copy()
        scores[rows, cols] = FILTER_VALUE
    return ranks_from_scores(scores, targets)


def device_ranks(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """[B] ranks on the scores' device: 1 + #(strictly greater)."""
    tgt = scores.gather(1, targets[:, None])
    return 1 + (scores > tgt).sum(dim=1)


def device_filtered_ranks(scores, targets, mask_rows, mask_cols) -> torch.Tensor:
    """Filtered ranks on device; (mask_rows, mask_cols) is a padded COO of
    entries to squash whose padding rows equal B and are dropped.

    The padding entries are pointed at one spare slot past the [B, N]
    matrix, so dropping them needs no host sync."""
    B, N = scores.shape
    flat = torch.empty(B * N + 1, dtype=scores.dtype, device=scores.device)
    flat[: B * N] = scores.reshape(-1)
    idx = torch.where(mask_rows < B, mask_rows * N + mask_cols, B * N)
    flat[idx] = FILTER_VALUE
    return device_ranks(flat[: B * N].view(B, N), targets)


def sharded_ranks(scores: torch.Tensor, targets: torch.Tensor, shard) -> torch.Tensor:
    """:func:`device_ranks` of scores sharded on the candidate axis (this
    rank's [B, rows] of the ``RowShard``): the target's score from its
    owner, each rank's count of strictly greater scores, summed over ranks
    (in float64, exact for any count), so ties count as in
    :func:`device_ranks`; every rank gets the same [B] ranks."""
    local = targets - shard.row0
    owned = (local >= 0) & (local < scores.shape[1])
    picked = scores.gather(1, local.clamp(0, scores.shape[1] - 1)[:, None])[:, 0]
    tgt = all_reduce_sum(torch.where(owned, picked, torch.zeros_like(picked)), shard.group)
    count = (scores > tgt[:, None]).sum(dim=1).double()
    return 1 + all_reduce_sum(count, shard.group).long()


def sharded_filtered_ranks(scores, targets, mask_rows, mask_cols, shard) -> torch.Tensor:
    """:func:`device_filtered_ranks` of scores sharded on the candidate
    axis: each rank squashes the entries of the padded COO that fall in its
    columns, then :func:`sharded_ranks`."""
    B, n = scores.shape
    local = mask_cols - shard.row0
    keep = (mask_rows < B) & (local >= 0) & (local < n)
    flat = torch.empty(B * n + 1, dtype=scores.dtype, device=scores.device)
    flat[: B * n] = scores.reshape(-1)
    flat[torch.where(keep, mask_rows * n + local, B * n)] = FILTER_VALUE
    return sharded_ranks(flat[: B * n].view(B, n), targets, shard)


def filter_coo_padded(answer_filter, queries, targets, bucket: int = 4096):
    """Host-side padded COO for device filtering; pad rows = B (dropped)."""
    B = len(queries)
    if answer_filter is None:
        rows = np.full(bucket, B, np.int64)
        return rows, np.zeros(bucket, np.int64)
    rows, cols = answer_filter.mask_coo(queries, targets)
    n = len(rows)
    padded = max(((n + bucket - 1) // bucket) * bucket, bucket)
    out_r = np.full(padded, B, np.int64)
    out_c = np.zeros(padded, np.int64)
    out_r[:n] = rows
    out_c[:n] = cols
    return out_r, out_c


@dataclasses.dataclass
class RankStats:
    mrr: float
    hits: Dict[int, float]
    count: int


def stat_ranks(rank_arrays: Sequence[np.ndarray], hits_at=(1, 3, 10)) -> RankStats:
    """Aggregate MRR/Hits over per-snapshot rank arrays (ref:rgcn/utils.py:169-178)."""
    all_ranks = np.concatenate([np.asarray(r) for r in rank_arrays])
    mrr = float(np.mean(1.0 / all_ranks.astype(np.float64)))
    hits = {k: float(np.mean(all_ranks <= k)) for k in hits_at}
    return RankStats(mrr=mrr, hits=hits, count=len(all_ranks))
