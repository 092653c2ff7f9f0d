"""The collectives of the sharded paths, as autograd Functions.

JAX's sharded trainer lets GSPMD insert its collectives and differentiate
them; here each collective on the autograd path is written out, with the
backward its forward needs. The convention is that of a loss summed over
ranks: each rank runs the backward of its own share of the loss, and the
gradient of a tensor is the sum over ranks of those shares' gradients.
So:

- :class:`AllReduceSum`: forward the sum over ranks, backward the sum over
  ranks of the incoming gradients (every rank's share used the sum);
- :class:`AllGatherRows`: forward the rows of every rank stacked, backward
  the sum over ranks of the incoming gradient, then this rank's rows;
- :class:`AllToAll`: forward block g of the input to rank g, backward the
  same exchange of the gradients the other way.

A value that every rank computes alike from replicated inputs (a loss, the
decoders' query features) is counted once over the ranks by scaling each
rank's share by 1 / G (``Trainer.train_step``), and the gradients of the
replicated parameters are summed over ranks after the backward
(:func:`all_reduce_replicated`). ``reduce_scatter`` is not used: gloo
may lack it. Every rank must call the same collectives in the same order,
so the sharded paths never branch on a rank's data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class RowShard:
    """Rows ``row0 .. row0 + rows`` of an [n, ...] table row-sharded over
    ``group``, whose rank ``rank`` holds them (``n = size * rows``)."""

    group: Any
    rank: int
    size: int
    rows: int

    @property
    def row0(self) -> int:
        return self.rank * self.rows

    @property
    def n(self) -> int:
        return self.size * self.rows


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rank, ctx.rows = group, dist.get_rank(group), x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = _sum(g, ctx.group)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


class AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of ``group``, differentiable (see module)."""
    return AllReduceSum.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[G * rows, ...]: every rank's ``x`` [rows, ...] in rank order."""
    return AllGatherRows.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` [G, ...]: block g goes to rank g; returns block g from rank g."""
    return AllToAll.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over ranks; not differentiable."""
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def from_first_rank(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the first rank of ``group`` holds it, on every rank; not
    differentiable. Replicated activations agree across ranks only up to
    the card's atomic sums, which add in no fixed order: state that ranks
    derive from them alike (EST's memories) takes one rank's copy."""
    y = x.detach().contiguous().clone()
    dist.broadcast(y, src=dist.get_global_rank(group, 0), group=group)
    return y


def gather_rows(h_local: torch.Tensor, idx: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """``h[idx]`` of the row-sharded table of which this rank holds the
    rows of ``shard`` as ``h_local``: each rank contributes the rows it owns
    and zeros, summed over ranks, so every gathered row is the owner's
    value exactly (a sum of one value and zeros). Differentiable: the
    summed gradient of each gathered row reaches its owner's row."""
    rows, group = h_local.shape[0], shard.group
    local = idx - shard.row0
    owned = (local >= 0) & (local < rows)
    picked = h_local[local.clamp(0, rows - 1)]
    mask = owned.reshape(owned.shape + (1,) * (picked.dim() - owned.dim()))
    return all_reduce_sum(torch.where(mask, picked, torch.zeros_like(picked)), group)


def rows_of(table: torch.Tensor, idx: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """``table.index_select(0, idx)``; with ``shard``, of the row-sharded
    table whose rows this rank holds as ``table`` (:func:`gather_rows`)."""
    return table.index_select(0, idx) if shard is None else gather_rows(table, idx, shard)


def whole_rows(x: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """``x`` whole: with ``shard``, every rank's rows all-gathered (each
    row's gradient summed over the ranks to its owner), else ``x``."""
    return x if shard is None else all_gather_rows(x, shard.group)


def all_reduce_replicated(grads: Sequence[Optional[torch.Tensor]], params: Sequence[torch.Tensor],
                          replicated: Sequence[bool], group) -> List[torch.Tensor]:
    """``grads`` with those of the replicated parameters summed over ranks
    in one flat ``all_reduce`` (a None gradient counts as zeros); the
    sharded parameters' gradients are whole after the backward already.
    The sum is one collective's result, so every rank's replicated
    gradients, and with them its replicated parameters, stay bit-equal."""
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    picked = [g for g, r in zip(grads, replicated) if r]
    if not picked:
        return grads
    flat = torch.cat([g.reshape(-1) for g in picked])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for g, r in zip(grads, replicated):
        if r:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        else:
            out.append(g)
    return out
