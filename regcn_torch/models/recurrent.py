"""RecurrentRGCN — the framework core model.

Counterpart of ``regcn_tpu/models/recurrent.py`` (parity with
ref:src/rrgcn.py:58-248): the evolution, the training losses
(:func:`get_loss`) and the eval-mode scores (:func:`predict`). The JAX
``lax.scan`` over the history window is a Python loop over its T steps
here. In training every dropout draws from one ``torch.Generator`` on
the parameters' device; JAX's and torch's random streams differ, so the
two packages agree step for step only with every dropout at 0.

With ``use_static`` (ref:src/rrgcn.py:146-155, :225-247) the evolution
starts from the static entity-word graph's embedding, one
``rgcn_block_layer`` over the entities and words, and the loss adds the
angular constraint between that embedding and each step's evolved one
(:func:`static_angular_loss`). On an entity-sharded mesh ``words_emb`` is
row-sharded as ``dynamic_emb`` is: every rank gathers both tables, runs the
block layer whole and keeps its own rows, and the angular loss sums each
rank's rows across the ranks.

Under ``dtype="bfloat16"`` the trainer hands the model bf16 parameters
and windows; the segment sums, the aggregation's product and scatter, the
self-loop products, BatchNorm and the scores (fp32) and the CE are fp32
islands, as in JAX.

Evolution step (one snapshot):
  ctx[r]   = mean_{e incident to r} h[e]                  (segment mean)
  h0       = GRUCell([emb_rel ; ctx], h0)                 (relation GRU)
  cur      = RGCNCell(g, h, h0)                           (2 x UnionRGCN)
  gate     = sigmoid(h @ W_t + b_t)
  h        = gate * cur + (1-gate) * h                    (time gate)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import relu

from regcn_torch.config import ModelConfig
from regcn_torch.models import decoders
from regcn_torch.models.layers import (
    gru_cell,
    init_gru_cell,
    init_rgcn_block_layer,
    init_rgcn_cell,
    rgcn_block_layer,
    rgcn_cell,
)
from regcn_torch.ops.activations import l2_normalize
from regcn_torch.ops.segment import masked_segment_mean
from regcn_torch.parallel.collectives import RowShard, all_reduce_sum, gather_rows, whole_rows
from regcn_torch.parallel.mesh import table_shard
from regcn_torch.utils.dtypes import compute_dtype, mm
from regcn_torch.utils.init import xavier_normal, xavier_uniform

Params = Dict[str, Any]


@dataclasses.dataclass
class ModelState:
    """Non-parameter model state: decoder BatchNorm running stats."""

    bn_ob: decoders.BNState
    bn_rel: decoders.BNState


def tree_to(tree, device):
    """Moves every tensor of a nested dict/list to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def check_supported(cfg: ModelConfig) -> None:
    """Raises for a compute dtype other than float32 and bfloat16."""
    compute_dtype(cfg.dtype)


def init_params(
    gen: torch.Generator, cfg: ModelConfig, device="cuda"
) -> Tuple[Params, ModelState]:
    """Random parameters and fresh BN state, drawn from ``gen`` on the CPU
    and moved to ``device``."""
    check_supported(cfg)
    params: Params = {
        "emb_rel": xavier_normal(gen, (cfg.num_rels_total, cfg.h_dim)),
        "dynamic_emb": torch.randn((cfg.num_ents, cfg.h_dim), generator=gen),
        "time_gate_w": xavier_uniform(gen, (cfg.h_dim, cfg.h_dim), gain=math.sqrt(2.0)),
        "time_gate_b": torch.zeros((cfg.h_dim,)),
        "gru": init_gru_cell(gen, 2 * cfg.h_dim, cfg.h_dim),
        "rgcn": init_rgcn_cell(gen, cfg),
    }
    params["decoder_ob"], bn_ob = decoders.init_convtrans(
        gen, cfg.h_dim, cfg.decoder_channels, cfg.decoder_kernel)
    params["decoder_rel"], bn_rel = decoders.init_convtrans(
        gen, cfg.h_dim, cfg.decoder_channels, cfg.decoder_kernel)
    if cfg.use_static:
        params["words_emb"] = xavier_normal(gen, (cfg.num_words, cfg.h_dim))
        params["static_rgcn"] = init_rgcn_block_layer(gen, cfg.h_dim, 2 * cfg.num_static_rels,
                                                      cfg.n_bases)
    state = ModelState(bn_ob=tree_to(bn_ob, device), bn_rel=tree_to(bn_rel, device))
    return tree_to(params, device), state


def _static_init(params: Params, cfg: ModelConfig, static_snap, *,
                 gen: Optional[torch.Generator] = None, train: bool = False,
                 shard: Optional[RowShard] = None) -> torch.Tensor:
    """The static graph's entity embedding [N, d] (ref:src/rrgcn.py:146-152):
    the block layer over ``dynamic_emb`` ++ ``words_emb``, its first
    ``num_ents`` rows, L2-normalised under ``layer_norm``.

    With ``shard`` both tables hold this rank's rows: each is all-gathered
    (each row's gradient summed over the ranks to its owner), the layer runs
    whole on every rank, so its dropout draws are one process's, and the
    rank keeps its own rows of the entities' output, [rows, d]."""
    h_all = torch.cat([whole_rows(params["dynamic_emb"], shard),
                       whole_rows(params["words_emb"], shard)], dim=0)
    out = rgcn_block_layer(params["static_rgcn"], h_all, static_snap, cfg.n_bases,
                           dropout=cfg.dropout, gen=gen, train=train)
    static_emb = out[: cfg.num_ents] if shard is None else out[shard.row0:shard.row0 + shard.rows]
    return l2_normalize(static_emb) if cfg.layer_norm else static_emb


def evolve(params: Params, cfg: ModelConfig, history, *, static_snap=None,
           gen: Optional[torch.Generator] = None, train: bool = False, return_all: bool = False,
           impl: str = "xla"):
    """Run the recurrent evolution over a stacked [T, ...] history window
    (a Snapshot of tensors). Returns (h_final [N, d], r_emb_final [2R, d]);
    with ``return_all``, (h_final, r_emb_final, the static embedding or
    None, every step's h [T, N, d]). With ``use_static`` and a
    ``static_snap`` (the static graph's Snapshot) the evolution starts
    from the static embedding.

    With ``impl`` an entity-sharded marker (``regcn_torch/dist.py``),
    ``params["dynamic_emb"]`` holds this rank's rows and so does h: the
    relation context gathers its entities' rows from their owners, the
    layers aggregate over the rank's edges, and the time gate runs on the
    rank's rows; the relation embeddings stay replicated."""
    check_supported(cfg)
    shard = _shard(impl, params)
    static_emb = None
    if cfg.use_static and static_snap is not None:
        static_emb = _static_init(params, cfg, static_snap, gen=gen, train=train, shard=shard)
        h = static_emb
    else:
        h = l2_normalize(params["dynamic_emb"]) if cfg.layer_norm else params["dynamic_emb"]
    emb_rel = params["emb_rel"]
    h0 = emb_rel
    all_h = []
    for t in range(history.src.shape[0]):
        snap = history.step(t)
        # relation context: masked segment-mean of current entity states over
        # the (relation, incident-entity) pair list
        ent = h[snap.rc_ent] if shard is None else gather_rows(h, snap.rc_ent, shard)
        ctx = masked_segment_mean(ent, snap.rc_rel, snap.rc_mask, cfg.num_rels_total)
        h0_new = gru_cell(params["gru"], torch.cat([emb_rel, ctx], dim=1), h0)
        if cfg.layer_norm:
            h0_new = l2_normalize(h0_new)
        cur = rgcn_cell(params["rgcn"], h, h0_new, snap, cfg, gen=gen, train=train, impl=impl)
        if cfg.layer_norm:
            cur = l2_normalize(cur)
        gate = torch.sigmoid(mm(h, params["time_gate_w"]) + params["time_gate_b"])
        h_new = gate * cur + (1.0 - gate) * h
        # an empty (all-masked) snapshot is an identity step, for autograd
        # too; decided on the device, so the loop never waits for the host
        active = snap.edge_mask.max() > 0
        h = torch.where(active, h_new, h)
        h0 = torch.where(active, h0_new, h0)
        all_h.append(h)
    if return_all:
        return h, h0, static_emb, torch.stack(all_h)
    return h, h0


def _shard(impl, params: Params) -> Optional[RowShard]:
    """This rank's rows of the entity table under a sharded ``impl``, else
    None."""
    return table_shard(impl, params["dynamic_emb"].shape[0])


def _masked_ce(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows whose mask is set: fp32 logsumexp
    minus the target logit, summed over real rows and divided by their
    count (``F.cross_entropy``'s mean would count the padded rows)."""
    scores = scores.float()
    nll = torch.logsumexp(scores, dim=1) - scores.gather(1, labels[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def static_angular_loss(static_emb: torch.Tensor, all_h: torch.Tensor, cfg,
                        active: Optional[torch.Tensor] = None,
                        shard: Optional[RowShard] = None) -> torch.Tensor:
    """Angular constraint between the static and the evolved embeddings
    (ref:src/rrgcn.py:225-247): per history step t (1-indexed, counting
    ``active`` steps only when it is given), max(0, cos(angle * t) -
    cos_sim(static, evolved)) summed over entities and steps, times
    ``static_weight``; with ``discount`` 0 the angle does not grow with t.
    With ``shard`` both tables hold this rank's rows: the rank sums its
    rows and the sum is all-reduced, so every rank holds the whole loss
    (``collectives.py``'s convention)."""
    T = all_h.shape[0]
    if active is None:
        steps = torch.arange(1, T + 1, dtype=torch.float32, device=all_h.device)
    else:
        active = active.float()
        steps = torch.cumsum(active, dim=0)
    if cfg.discount == 0:
        steps = torch.ones_like(steps)
    angles = torch.cos(cfg.angle * math.pi / 180.0 * steps)  # [T]
    if cfg.layer_norm:
        sim = torch.sum(static_emb[None] * l2_normalize(all_h), dim=-1)  # [T, N]
    else:
        num = torch.sum(static_emb[None] * all_h, dim=-1)
        den = torch.linalg.vector_norm(static_emb, dim=-1)[None] * torch.linalg.vector_norm(
            all_h, dim=-1)
        sim = num / torch.clamp(den, min=1e-12)
    # JAX's where(gap > 0, gap, 0), its gradient 0 at 0 as relu's
    gap = relu(angles[:, None] - sim)
    if active is not None:
        gap = gap * active[:, None]
    total = torch.sum(gap)
    return cfg.static_weight * (total if shard is None else all_reduce_sum(total, shard.group))


def get_loss(
    params: Params,
    state: ModelState,
    cfg: ModelConfig,
    history,
    triples: torch.Tensor,  # [B, 3] padded, inverses already added
    triple_mask: torch.Tensor,  # [B]
    *,
    static_snap=None,
    gen: Optional[torch.Generator] = None,
    train: bool = True,
    impl: str = "xla",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], ModelState]:
    """Entity + relation + static losses (ref:src/rrgcn.py:197-248):
    (loss_ent, {"entity", "relation", "static"}, new ModelState). The
    static loss is the angular constraint with ``use_static`` and a
    ``static_snap``, else 0. In train mode the decoders' BatchNorms use the
    batch statistics of the real triples and the new state holds their
    updated running statistics. Under a sharded ``impl`` (:func:`evolve`)
    the entity scores are the rank's candidates' and the entity CE is taken
    across ranks (``decoders.sharded_masked_ce``); every rank returns the
    same losses."""
    check_supported(cfg)
    shard = _shard(impl, params)
    static_emb = all_h = None
    if cfg.use_static:
        h, r_emb, static_emb, all_h = evolve(params, cfg, history, static_snap=static_snap,
                                             gen=gen, train=train, return_all=True, impl=impl)
    else:
        h, r_emb = evolve(params, cfg, history, gen=gen, train=train, impl=impl)
    pre_emb = l2_normalize(h) if cfg.layer_norm else h
    zero = torch.zeros((), device=h.device)
    losses = {"entity": zero, "relation": zero, "static": zero}
    bn_ob, bn_rel = state.bn_ob, state.bn_rel
    kw = dict(input_dropout=cfg.input_dropout, hidden_dropout=cfg.hidden_dropout,
              feat_dropout=cfg.feat_dropout, gen=gen, train=train, shard=shard)
    if cfg.entity_prediction:
        out = decoders.convtranse_score(params["decoder_ob"], bn_ob, pre_emb, r_emb, triples,
                                        triple_mask, **kw)
        scores, bn_ob = out if train else (out, bn_ob)
        losses["entity"] = (_masked_ce(scores, triples[:, 2], triple_mask) if shard is None else
                            decoders.sharded_masked_ce(scores, triples[:, 2], triple_mask, shard))
    if cfg.relation_prediction:
        # the candidates are the EVOLVED relation embeddings (ref:src/rrgcn.py:222)
        out = decoders.convtransr_score(params["decoder_rel"], bn_rel, pre_emb, r_emb, triples,
                                        triple_mask, **kw)
        scores, bn_rel = out if train else (out, bn_rel)
        losses["relation"] = _masked_ce(scores, triples[:, 1], triple_mask)
    if static_emb is not None:
        active = (history.edge_mask.amax(dim=1) > 0).float()
        losses["static"] = static_angular_loss(static_emb, all_h, cfg, active=active,
                                               shard=shard)
    return losses["entity"], losses, ModelState(bn_ob=bn_ob, bn_rel=bn_rel)


def predict(
    params: Params,
    state: ModelState,
    cfg: ModelConfig,
    history,
    triples: torch.Tensor,  # [B, 3] with inverses, padded
    *,
    static_snap=None,
    impl: str = "xla",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode scores (ref:src/rrgcn.py:183-194): (ent [B,N], rel [B,2R]),
    fp32 in every compute dtype; under a sharded ``impl`` the entity scores
    are the rank's candidates', [B, rows]."""
    shard = _shard(impl, params)
    h, r_emb = evolve(params, cfg, history, static_snap=static_snap, impl=impl)
    emb = l2_normalize(h) if cfg.layer_norm else h
    scores_ob = decoders.convtranse_score(params["decoder_ob"], state.bn_ob, emb, r_emb, triples,
                                          shard=shard)
    scores_rel = decoders.convtransr_score(params["decoder_rel"], state.bn_rel, emb, r_emb,
                                           triples, shard=shard)
    return scores_ob, scores_rel
