"""Scoring decoders: ConvTransE (entities) and ConvTransR (relations).

Counterparts of ``regcn_tpu/models/decoders.py``. Parity with
ref:src/decoder.py:55-100 (ConvTransE) and :10-52 (ConvTransR): tanh the
entity table, stack [head; rel] (or [head; tail]) as a 2-channel
length-d signal, BatchNorm -> dropout -> Conv1d(2->C, k, same) ->
BatchNorm -> relu -> dropout -> channel-major flatten -> Linear(C*d -> d)
-> dropout -> BatchNorm -> relu -> scores against all candidates in one
[B,d]x[d,N] GEMM.

Under bf16 compute the features run in bf16, BatchNorm's statistics and
its affine map in fp32, and the scores come out fp32 (``dot_f32``), as
JAX's ``preferred_element_type=float32``.

In eval mode BatchNorm uses the running statistics of the model state.
In train mode it normalises by the batch statistics of the real rows
only (padded triples are masked out, as in the JAX package), with the
*biased* variance both to normalise and in the running update; so it is
written out rather than taken from ``F.batch_norm``, which can mask no
row and updates ``running_var`` with the unbiased variance.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import relu

from regcn_torch.ops.activations import inverted_dropout
from regcn_torch.parallel.collectives import (RowShard, all_reduce_max, all_reduce_sum,
                                              gather_rows)
from regcn_torch.utils.dtypes import dot_f32, linear
from regcn_torch.utils.init import torch_linear_uniform

Params = Dict[str, torch.Tensor]
BNState = Dict[str, torch.Tensor]

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


def _init_bn(c: int) -> Tuple[Params, BNState]:
    return (
        {"scale": torch.ones((c,)), "bias": torch.zeros((c,))},
        {"mean": torch.zeros((c,)), "var": torch.ones((c,))},
    )


def init_convtrans(
    gen: torch.Generator, h_dim: int, channels: int = 50, kernel: int = 3
) -> Tuple[Params, BNState]:
    """Shared init for ConvTransE/R (identical pipelines, different stacks)."""
    conv_fan_in = 2 * kernel
    fc_fan_in = h_dim * channels
    params: Params = {
        "conv_w": torch_linear_uniform(gen, (channels, 2, kernel), conv_fan_in),
        "conv_b": torch_linear_uniform(gen, (channels,), conv_fan_in),
        "fc_w": torch_linear_uniform(gen, (h_dim, fc_fan_in), fc_fan_in),
        "fc_b": torch_linear_uniform(gen, (h_dim,), fc_fan_in),
    }
    state: BNState = {}
    for name, c in (("bn0", 2), ("bn1", channels), ("bn2", h_dim)):
        params[name], state[name] = _init_bn(c)
    return params, state


def _batch_norm(params: Params, state: BNState, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *, train: bool = False
                ) -> Tuple[torch.Tensor, BNState]:
    """BatchNorm1d over channel axis 1: (out, new running statistics).

    In train mode the statistics are over the rows whose ``mask`` [B] is
    non-zero (all rows without a mask); the new running statistics are
    detached from the graph. In eval mode ``state`` comes back as it is."""
    c = x.shape[1]
    shape = [1] * x.dim()
    shape[1] = c
    x32 = x.float()  # statistics always accumulate in fp32
    if train:
        axes = [i for i in range(x.dim()) if i != 1]
        if mask is not None:
            mshape = [1] * x.dim()
            mshape[0] = x.shape[0]
            m = mask.float().reshape(mshape)
            denom = torch.clamp(m.sum() * (x.numel() / (x.shape[0] * c)), min=1.0)
            mean = torch.sum(x32 * m, dim=axes) / denom
            var = torch.sum(m * (x32 - mean.reshape(shape)) ** 2, dim=axes) / denom
        else:
            mean = torch.mean(x32, dim=axes)
            var = torch.var(x32, dim=axes, unbiased=False)
        new_state = {
            "mean": (1 - _BN_MOMENTUM) * state["mean"] + _BN_MOMENTUM * mean.detach(),
            "var": (1 - _BN_MOMENTUM) * state["var"] + _BN_MOMENTUM * var.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    inv = torch.rsqrt(var.reshape(shape) + _BN_EPS)
    out = (x32 - mean.reshape(shape)) * inv * params["scale"].reshape(shape).float() \
        + params["bias"].reshape(shape).float()
    return out.to(x.dtype), new_state


def _convtrans_features(
    params: Params,
    state: BNState,
    stacked: torch.Tensor,  # [B, 2, d]
    mask: Optional[torch.Tensor],
    *,
    input_dropout: float,
    hidden_dropout: float,
    feat_dropout: float,
    gen: Optional[torch.Generator],
    train: bool,
) -> Tuple[torch.Tensor, BNState]:
    """[B, 2, d] stacked pair -> ([B, d] query features, new BN state)."""
    new_state = dict(state)
    x, new_state["bn0"] = _batch_norm(params["bn0"], state["bn0"], stacked, mask, train=train)
    x = inverted_dropout(x, input_dropout, gen, train)
    # the weights in the input's dtype, as JAX's convolution takes them
    x = F.conv1d(x, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype), padding="same")
    x, new_state["bn1"] = _batch_norm(params["bn1"], state["bn1"], x, mask, train=train)
    x = inverted_dropout(relu(x), feat_dropout, gen, train)
    x = x.reshape(x.shape[0], -1)  # [B, C*d], channel-major like torch .view
    x = inverted_dropout(linear(x, params["fc_w"], params["fc_b"]), hidden_dropout, gen, train)
    x, new_state["bn2"] = _batch_norm(params["bn2"], state["bn2"], x, mask, train=train)
    return relu(x), new_state


Scores = Union[torch.Tensor, Tuple[torch.Tensor, BNState]]


def _rows(table: torch.Tensor, idx: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """``table[idx]``; with ``shard``, of the row-sharded table whose rows
    this rank holds as ``table``."""
    return table[idx] if shard is None else gather_rows(table, idx, shard)


def sharded_masked_ce(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                      shard: RowShard) -> torch.Tensor:
    """The masked-mean CE of ``recurrent._masked_ce`` over scores sharded on
    the candidate axis (this rank's [B, rows]): the logsumexp from the
    maximum over ranks and the sum over ranks of the exponentials, the
    target's logit from its owner, every rank with the same loss."""
    scores = scores.float()
    m = all_reduce_max(scores.amax(dim=1), shard.group)
    lse = m + torch.log(all_reduce_sum(torch.exp(scores - m[:, None]).sum(dim=1), shard.group))
    local = labels - shard.row0
    owned = (local >= 0) & (local < scores.shape[1])
    picked = scores.gather(1, local.clamp(0, scores.shape[1] - 1)[:, None])[:, 0]
    target = all_reduce_sum(torch.where(owned, picked, torch.zeros_like(picked)), shard.group)
    return torch.sum((lse - target) * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _score(params, state, stacked, candidates, mask, input_dropout, hidden_dropout,
           feat_dropout, gen, train) -> Scores:
    x, new_state = _convtrans_features(
        params, state, stacked, mask, input_dropout=input_dropout,
        hidden_dropout=hidden_dropout, feat_dropout=feat_dropout, gen=gen, train=train)
    scores = dot_f32(x, candidates.T)  # fp32 scores in every compute dtype
    return (scores, new_state) if train else scores


def convtranse_score(
    params: Params,
    state: BNState,
    embedding: torch.Tensor,  # [N, d] evolved entity embeddings
    rel_emb: torch.Tensor,  # [2R, d]
    triples: torch.Tensor,  # [B, 3] int (s, r, o), padded
    mask: Optional[torch.Tensor] = None,  # [B]
    *,
    input_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    feat_dropout: float = 0.0,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    shard: Optional[RowShard] = None,
) -> Scores:
    """Entity scores [B, N] (ref:src/decoder.py:78-100); in train mode
    (scores, new BN state), the dropouts drawn from ``gen``. With ``shard``
    the embedding holds this rank's rows of the entity table: the
    subjects' rows are gathered from their owners, every rank computes the
    same query features, and the scores are those of the rank's candidates,
    [B, rows] (:func:`sharded_masked_ce` takes the CE over them)."""
    ent_all = torch.tanh(embedding)
    stacked = torch.stack([_rows(ent_all, triples[:, 0], shard), rel_emb[triples[:, 1]]], dim=1)
    return _score(params, state, stacked, ent_all, mask, input_dropout, hidden_dropout,
                  feat_dropout, gen, train)


def convtransr_score(
    params: Params,
    state: BNState,
    embedding: torch.Tensor,
    rel_emb: torch.Tensor,  # [2R, d] candidates
    triples: torch.Tensor,  # [B, 3]
    mask: Optional[torch.Tensor] = None,
    *,
    input_dropout: float = 0.0,
    hidden_dropout: float = 0.0,
    feat_dropout: float = 0.0,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    shard: Optional[RowShard] = None,
) -> Scores:
    """Relation scores [B, 2R] (ref:src/decoder.py:29-52); in train mode
    (scores, new BN state). With ``shard`` the subjects' and objects' rows
    are gathered from their owners, and the scores are replicated."""
    ent_all = torch.tanh(embedding)
    stacked = torch.stack([_rows(ent_all, triples[:, 0], shard),
                           _rows(ent_all, triples[:, 2], shard)], dim=1)
    return _score(params, state, stacked, rel_emb, mask, input_dropout, hidden_dropout,
                  feat_dropout, gen, train)
