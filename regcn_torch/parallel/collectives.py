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
  same exchange of the gradients the other way;
- :class:`ColumnsDot`: the decoders' scores of replicated query features
  against the rank's candidate columns, the features' gradient reduced
  over ranks in fp32 before it rounds.

A value that every rank computes alike from replicated inputs (a loss, the
decoders' query features) is counted once over the ranks by scaling each
rank's share by 1 / G (``Trainer.train_step``), and the gradients of the
replicated parameters are summed over ranks after the backward
(:func:`all_reduce_replicated`). ``reduce_scatter`` is not used: gloo
may lack it. Every rank must call the same collectives in the same order,
so the sharded paths never branch on a rank's data.

Under bf16 compute the all-gather and the all-to-all carry bf16 rows,
which is exact. A sum over ranks is not: every sum here runs in fp32
(:func:`_sum` widens bf16 partials to fp32, sums them in one collective
and rounds the result once to the partials' dtype; at G = 2 that is the
bf16 sum itself). That is the backward of the all-gather and of
:func:`gather_rows`, whose forward sums one owner's row and zeros (exact
in any dtype); the losses' and the replicated gradients' sums are fp32
already, as JAX's fp32 islands keep them.

A ``data`` axis above 1 replicates the whole training: each replica runs
the same steps on the same data, and JAX's replicas are one program with
one result. The port's replicas compute apart, and the card's atomic sums
add in no fixed order, so they would part in their last bits after a
step. So every value that a replica carries forward (each step's
gradients, BatchNorm statistics, EST's memories, the evaluation's ranks)
is taken from the first replica (:func:`from_first_replica`), and the
replicas stay bit-equal by construction.
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
    replicas: Any = None  # the mesh's data-axis group where that axis is above 1
    first: bool = True  # this rank is the mesh's first (data 0, graph 0)

    @property
    def row0(self) -> int:
        return self.rank * self.rows

    @property
    def n(self) -> int:
        return self.size * self.rows


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks in fp32 (see the module), in ``x``'s dtype."""
    y = x.contiguous().to(torch.float32 if x.dtype == torch.bfloat16 else x.dtype, copy=True)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


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


class ColumnsDot(torch.autograd.Function):
    """``dot_f32(x, cols.T)``: the replicated query features ``x`` [B, k]
    against this rank's candidate columns ``cols`` [rows, k], an fp32
    [B, rows]. The gradient of ``x`` is a contraction over the sharded
    candidate axis: the backward sums the ranks' fp32 partial products in
    one collective and rounds the sum once to ``x``'s dtype, as GSPMD
    reduces a contraction's partials before the convert after it. Each
    rank keeps 1 / G of it, its share of the replicated activation, so the
    replicated leaves' gradients summed over ranks count it once."""

    @staticmethod
    def forward(ctx, x, cols, group):
        from regcn_torch.utils.dtypes import dot_f32

        ctx.save_for_backward(x, cols)
        ctx.group = group
        return dot_f32(x, cols.T)

    @staticmethod
    def backward(ctx, g):
        x, cols = ctx.saved_tensors
        g = g.float()
        gx = gc = None
        if ctx.needs_input_grad[0]:
            gx = _sum(g @ cols.float(), ctx.group) / dist.get_world_size(ctx.group)
            gx = gx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            gc = (g.T @ x.float()).to(cols.dtype)
        return gx, gc, None


def columns_dot(x: torch.Tensor, cols: torch.Tensor, shard: Optional["RowShard"]
                ) -> torch.Tensor:
    """The fp32 scores ``x @ cols.T`` of the decoders' query features
    against their candidates; with ``shard`` the candidates are this rank's
    columns (:class:`ColumnsDot`)."""
    if shard is None:
        from regcn_torch.utils.dtypes import dot_f32

        return dot_f32(x, cols.T)
    x, cols = (t.to(torch.promote_types(x.dtype, cols.dtype)) for t in (x, cols))
    return ColumnsDot.apply(x, cols, shard.group)


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


def from_first_replica(x: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """``x`` as the first replica of the mesh holds it (the rank at the
    same ``graph`` position on ``data`` 0), on every replica; ``x`` itself
    where there is one replica. Not differentiable."""
    if shard is None or shard.replicas is None:
        return x
    return from_first_rank(x, shard.replicas)


def tensors_from_first_rank(ts: Sequence[Optional[torch.Tensor]], group
                            ) -> List[Optional[torch.Tensor]]:
    """:func:`from_first_rank` of each tensor of ``ts`` over ``group`` (None
    stays None), in one broadcast per dtype."""
    out = list(ts)
    for dtype in dict.fromkeys(t.dtype for t in ts if t is not None):
        at = [i for i, t in enumerate(ts) if t is not None and t.dtype == dtype]
        flat = from_first_rank(torch.cat([ts[i].detach().reshape(-1) for i in at]), group)
        pos = 0
        for i in at:
            out[i] = flat[pos:pos + ts[i].numel()].view_as(ts[i])
            pos += ts[i].numel()
    return out


def tensors_from_first_replica(ts: Sequence[Optional[torch.Tensor]], shard: Optional[RowShard]
                               ) -> List[Optional[torch.Tensor]]:
    """:func:`from_first_replica` of each tensor of ``ts`` (None stays
    None), in one broadcast per dtype."""
    if shard is None or shard.replicas is None:
        return list(ts)
    return tensors_from_first_rank(ts, shard.replicas)


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
