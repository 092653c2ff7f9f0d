"""HisRES recurrent model.

Counterpart of ``regcn_tpu/hisres/model.py`` (parity with
ref:hisres_src/hisres.py:102-451 ``RecurrentRGCN``):

- two recurrent streams, fused by a learned sigmoid gate
  (ref :272-333): the per-snapshot graphs through ``rgcn`` and GRU pair 1
  with a LogCL-style cosine time encoding, and the 2-snapshot-union
  graphs through ``rgcn_2`` and GRU pair 2. The JAX ``lax.scan`` over a
  stream's window is a Python loop over its T steps here;
- the query-conditioned history graphs (from the sparse history store)
  encoded by the attention CandRGCN cells, raw and inverse, and gated
  into the final embeddings (ref :337-349);
- TimeConvTransE/R decoders whose relation scores can be masked by a
  one-hot history vocabulary (ref:hisres_src/decoder.py:46-51, :95-99):
  the masked score is 0, not -inf; entity loss = 0.5 * raw + 0.5 *
  inverse CE; relation score = history_rate * masked + (1 -
  history_rate) * raw (ref :351-363).

In training every dropout draws from one ``torch.Generator`` on the
parameters' device; JAX's and torch's random streams differ, so the two
packages agree step for step only with every dropout at 0
(``cand_dropout`` among them).

Under ``compute_dtype="bfloat16"`` the trainer hands the model bf16
parameters and windows; the time encoding's cosine, the candidate sums
(B1, fed fp32) and the decoders' scores stay fp32 islands, as in JAX.

On an entity-sharded mesh (``cfg.impl`` a marker of ``regcn_torch/dist.py``,
which ``HisResTrainer(mesh=...)`` sets) ``dynamic_emb`` holds this rank's
rows: both recurrent streams run on them, their relation contexts gather
rows by global id and their union layers aggregate over the rank's
partition of each graph. The fused table is then all-gathered: the
candidate cells run whole on every rank over the replicated history
graphs, as JAX keeps them dense, and so do the decoders' queries; the
entity decoders score the rank's candidate columns, with the CE across
ranks. The static graph's ``words_emb`` is row-sharded as the entity
table is: the block layer runs whole on the gathered tables on every rank
(``recurrent._static_init``), and the angular loss sums each rank's rows
across the ranks. Under bf16 compute the rank's rows enter in bf16 as the
whole table does on one device, with the same fp32 islands; the gathers
carry the rows in their dtype and every sum across ranks runs in fp32
(``parallel/collectives.py``). Still to come on a mesh (ROADMAP A.11b):
the sweep's model axis and the counterpart of JAX's ``dryrun_multichip``,
neither of which is this module's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from regcn_torch.hisres import layers as HLayers
from regcn_torch.models import decoders as D
from regcn_torch.models.layers import gru_cell, init_gru_cell, init_rgcn_block_layer
from regcn_torch.models.recurrent import _masked_ce, _static_init, static_angular_loss, tree_to
from regcn_torch.ops.activations import l2_normalize
from regcn_torch.ops.rgcn_scatter import check_impl
from regcn_torch.ops.segment import masked_segment_mean
from regcn_torch.parallel.collectives import RowShard, columns_dot, rows_of, whole_rows
from regcn_torch.parallel.mesh import table_shard
from regcn_torch.utils.dtypes import compute_dtype, dot_f32, mm
from regcn_torch.utils.init import torch_linear_uniform, xavier_normal

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class HisResConfig:
    """Same fields and defaults as ``regcn_tpu.hisres.model.HisResConfig``."""

    num_ents: int
    num_rels: int
    h_dim: int = 200
    n_layers: int = 2
    history_rate: float = 0.3
    dropout: float = 0.2
    input_dropout: float = 0.2
    hidden_dropout: float = 0.2
    feat_dropout: float = 0.2
    self_loop: bool = True
    skip_connect: bool = False
    layer_norm: bool = True
    entity_prediction: bool = True
    relation_prediction: bool = True
    use_static: bool = False
    num_static_rels: int = 0
    num_words: int = 0
    n_bases: int = 100
    static_weight: float = 0.5
    discount: float = 1.0
    angle: float = 10.0
    cand_dropout: float = 0.2  # fixed in the reference cell (ref :70-71)
    # relation-context incidence of both recurrent streams: "src", the
    # HisRES variant's r2e (ref:hisres_rgcn/utils.py:77-80), or "both"
    rc_mode: str = "src"
    compute_dtype: str = "float32"
    impl: Any = "xla"

    @property
    def num_rels_total(self) -> int:
        return 2 * self.num_rels


@dataclasses.dataclass
class HisResState:
    """BatchNorm running statistics: the 4 decoders', and the candidate
    cells' (raw and inverse), a list of one per layer."""

    bn_ob_raw: Any
    bn_ob_inv: Any
    bn_rel_raw: Any
    bn_rel_his: Any
    bn_cand_raw: List[Dict[str, torch.Tensor]]
    bn_cand_inv: List[Dict[str, torch.Tensor]]


def check_supported(cfg: HisResConfig) -> None:
    """Raises for an unknown compute dtype, aggregation route or relation
    context."""
    compute_dtype(cfg.compute_dtype)
    check_impl(cfg.impl)
    if cfg.rc_mode not in ("src", "both"):
        raise ValueError(f"rc_mode must be 'both' or 'src', got {cfg.rc_mode!r}")


def init_params(gen: torch.Generator, cfg: HisResConfig, device="cuda"
                ) -> Tuple[Params, HisResState]:
    """Random parameters and fresh BN states, drawn from ``gen`` on the CPU
    and moved to ``device``."""
    check_supported(cfg)
    d = cfg.h_dim
    params: Params = {
        "emb_rel": xavier_normal(gen, (cfg.num_rels_total, d)),
        "dynamic_emb": torch.randn((cfg.num_ents, d), generator=gen),
        # r_linear: the first step's relation mix (ref :143)
        "r_linear_w": torch_linear_uniform(gen, (d, 2 * d), 2 * d),
        "r_linear_b": torch_linear_uniform(gen, (d,), 2 * d),
        # LogCL-style time encoding (ref :148-154)
        "time_linear_w": torch_linear_uniform(gen, (d, 2 * d), 2 * d),
        "time_linear_b": torch_linear_uniform(gen, (d,), 2 * d),
        "weight_t2": torch.randn((1, d), generator=gen),
        "bias_t2": torch.randn((1, d), generator=gen),
        # fusion gates (ref :156-158)
        "linear_g_w": torch_linear_uniform(gen, (d, d), d),
        "linear_g_b": torch.zeros((d,)),
        "linear_s1_w": torch_linear_uniform(gen, (d, d), d),
        "linear_s1_b": torch.zeros((d,)),
        "linear_o1_w": torch_linear_uniform(gen, (d, d), d),
        "linear_o1_b": torch.zeros((d,)),
        # GRU pairs (ref :236-240)
        "relation_cell_1": init_gru_cell(gen, 2 * d, d),
        "entity_cell_1": init_gru_cell(gen, d, d),
        "relation_cell_2": init_gru_cell(gen, 2 * d, d),
        "entity_cell_2": init_gru_cell(gen, d, d),
        "rgcn": HLayers.init_hisres_rgcn_cell(gen, d, cfg.n_layers, cfg.self_loop,
                                              cfg.skip_connect),
        "rgcn_2": HLayers.init_hisres_rgcn_cell(gen, d, cfg.n_layers, cfg.self_loop,
                                                cfg.skip_connect),
    }
    params["cand_raw"], bn_cand_raw = HLayers.init_cand_cell(gen, d, cfg.n_layers)
    params["cand_inv"], bn_cand_inv = HLayers.init_cand_cell(gen, d, cfg.n_layers)
    bns = {}
    for name in ("ob_raw", "ob_inv", "rel_raw", "rel_his"):
        params[f"decoder_{name}"], bns[f"bn_{name}"] = D.init_convtrans(gen, d)
    if cfg.use_static:
        params["words_emb"] = xavier_normal(gen, (cfg.num_words, d))
        params["static_rgcn"] = init_rgcn_block_layer(gen, d, 2 * cfg.num_static_rels,
                                                      cfg.n_bases)
    state = HisResState(bn_cand_raw=bn_cand_raw, bn_cand_inv=bn_cand_inv, **bns)
    return tree_to(params, device), HisResState(
        **{f.name: tree_to(getattr(state, f.name), device) for f in dataclasses.fields(state)})


def _shard(cfg: HisResConfig, params: Params) -> Optional[RowShard]:
    """This rank's rows of the entity table under a sharded ``cfg.impl``,
    else None."""
    return table_shard(cfg.impl, params["dynamic_emb"].shape[0])


def _stream(params: Params, cfg: HisResConfig, history, h_init: torch.Tensor, prefix: str,
            time_encode: bool, gen: Optional[torch.Generator], train: bool,
            shard: Optional[RowShard] = None):
    """One recurrent stream over a stacked [T, ...] window (ref :272-313):
    (h_final, h0_final, every step's h [T, N, d]); with ``shard``, of this
    rank's rows."""
    emb_rel = params["emb_rel"]
    k = 1 if prefix == "g" else 2
    rel_cell, ent_cell = params[f"relation_cell_{k}"], params[f"entity_cell_{k}"]
    rgcn = params["rgcn" if prefix == "g" else "rgcn_2"]
    T = history.src.shape[0]
    h, h0 = h_init, emb_rel
    all_h = []
    for step in range(T):
        snap = history.step(step)
        if time_encode:
            # LogCL cosine time encoding (ref :274-277), t2 = T - step + 1, in fp32
            h_t = torch.cos(params["weight_t2"].float() * float(T - step + 1)
                            + params["bias_t2"].float()).to(h.dtype)
            h = mm(torch.cat([h, h_t.expand(h.shape[0], -1)], dim=1), params["time_linear_w"].T) \
                + params["time_linear_b"]
        ctx = masked_segment_mean(rows_of(h, snap.rc_ent, shard), snap.rc_rel, snap.rc_mask,
                                  cfg.num_rels_total)
        if step == 0:
            # the first step starts h0 from r_linear (ref :285-287)
            h0 = mm(torch.cat([emb_rel, ctx], dim=1), params["r_linear_w"].T) + params["r_linear_b"]
            if cfg.layer_norm:
                h0 = l2_normalize(h0)
        cur_h, cur_r = HLayers.hisres_rgcn_cell(rgcn, h, h0, snap, dropout=cfg.dropout, gen=gen,
                                                train=train, impl=cfg.impl)
        h = gru_cell(ent_cell, cur_h, h)
        if cfg.layer_norm:
            h = l2_normalize(h)
        h0 = gru_cell(rel_cell, torch.cat([cur_r, ctx], dim=1), h0)
        if cfg.layer_norm:
            h0 = l2_normalize(h0)
        all_h.append(h)
    return h, h0, torch.stack(all_h)


def forward(params: Params, cfg: HisResConfig, history, history_gg, *, static_snap=None,
            gen: Optional[torch.Generator] = None, train: bool = False):
    """Both streams: (g_emb, gg_emb, r_emb, static_emb, the g stream's
    every step h [T, N, d]). ``history`` and ``history_gg`` are stacked
    windows (Snapshots of tensors); with ``use_static`` and a
    ``static_snap`` both start from the static graph's embedding. On a
    mesh the entity tables are this rank's rows."""
    check_supported(cfg)
    shard = _shard(cfg, params)
    if cfg.use_static and static_snap is not None:
        h_init = _static_init(params, cfg, static_snap, gen=gen, train=train, shard=shard)
    else:
        h_init = l2_normalize(params["dynamic_emb"]) if cfg.layer_norm else params["dynamic_emb"]
    g_emb, r_emb, all_h = _stream(params, cfg, history, h_init, "g", True, gen, train, shard)
    gg_emb, _, _ = _stream(params, cfg, history_gg, h_init, "gg", False, gen, train, shard)
    return g_emb, gg_emb, r_emb, h_init, all_h


def fuse_streams(params: Params, g_emb: torch.Tensor, gg_emb: torch.Tensor) -> torch.Tensor:
    """weight_g = sigmoid(linear_g(g_emb)) blend (ref :331-333)."""
    w = torch.sigmoid(mm(g_emb, params["linear_g_w"].T) + params["linear_g_b"])
    return w * g_emb + (1 - w) * gg_emb


def _time_convtrans_score(dec_params, bn_state, embedding, rel_emb, triples, mask, cfg, gen,
                          train: bool, mode: str, partial=None, shard: Optional[RowShard] = None):
    """TimeConvTransE/R (ref:hisres_src/decoder.py): (scores, new BN
    state); ``partial`` [B, 2R] multiplies the relation scores. With
    ``shard`` the (whole) ``embedding`` is scored on this rank's candidate
    columns only: entity scores [B, rows]."""
    ent_all = torch.tanh(embedding)
    e1 = ent_all[triples[:, 0]]
    other = rel_emb[triples[:, 1]] if mode == "entity" else ent_all[triples[:, 2]]
    x, new_bn = D._convtrans_features(
        dec_params, bn_state, torch.stack([e1, other], dim=1), mask,
        input_dropout=cfg.input_dropout, hidden_dropout=cfg.hidden_dropout,
        feat_dropout=cfg.feat_dropout, gen=gen, train=train)
    if mode == "entity":
        if shard is not None:
            ent_all = ent_all[shard.row0:shard.row0 + shard.rows]
        scores = columns_dot(x, ent_all, shard)  # fp32 scores
    else:
        scores = dot_f32(x, rel_emb.T)
    if partial is not None:
        scores = scores * partial  # the one-hot history mask (ref decoder :48-51)
    return scores, new_bn


def _final_embeddings(params, state: HisResState, cfg, pre_emb, r_emb, his_graph_raw,
                      his_graph_inv, gen, train):
    """The candidate cells over the history graphs, gated into ``pre_emb``:
    (final_raw, final_inv, new bn_cand_raw, new bn_cand_inv)."""
    emb_raw, bn_raw = HLayers.cand_cell(params["cand_raw"], state.bn_cand_raw, pre_emb, r_emb,
                                        his_graph_raw, dropout=cfg.cand_dropout, gen=gen,
                                        train=train)
    emb_inv, bn_inv = HLayers.cand_cell(params["cand_inv"], state.bn_cand_inv, pre_emb, r_emb,
                                        his_graph_inv, dropout=cfg.cand_dropout, gen=gen,
                                        train=train)
    emb_raw, emb_inv = l2_normalize(emb_raw), l2_normalize(emb_inv)
    w_s = torch.sigmoid(mm(emb_raw, params["linear_s1_w"].T) + params["linear_s1_b"])
    w_o = torch.sigmoid(mm(emb_inv, params["linear_o1_w"].T) + params["linear_o1_b"])
    return (w_s * emb_raw + (1 - w_s) * pre_emb, w_o * emb_inv + (1 - w_o) * pre_emb,
            bn_raw, bn_inv)


def get_loss(
    params: Params,
    state: HisResState,
    cfg: HisResConfig,
    history,
    history_gg,
    triples: torch.Tensor,  # [B, 3] raw rows (no inverses), padded
    inv_triples: torch.Tensor,  # [B, 3] the inverse rows
    mask: torch.Tensor,  # [B]
    his_graph_raw,  # Snapshot: the query-conditioned history graph
    his_graph_inv,
    rel_vocab: torch.Tensor,  # [2B, 2R] one-hot
    *,
    static_snap=None,
    gen: Optional[torch.Generator] = None,
    train: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], HisResState]:
    """(loss_ent, {"entity", "relation", "static"}, new HisResState). In
    train mode every BatchNorm normalises by the batch statistics of the
    real rows (real edges in the candidate cells), and the new state
    holds their updated running statistics."""
    shard = _shard(cfg, params)
    g_emb, gg_emb, r_emb, static_emb, all_h = forward(
        params, cfg, history, history_gg, static_snap=static_snap, gen=gen, train=train)
    pre_emb = whole_rows(fuse_streams(params, g_emb, gg_emb), shard)
    final_raw, final_inv, bn_cand_raw, bn_cand_inv = _final_embeddings(
        params, state, cfg, pre_emb, r_emb, his_graph_raw, his_graph_inv, gen, train)

    def entity_ce(scores, labels):
        return (_masked_ce(scores, labels, mask) if shard is None
                else D.sharded_masked_ce(scores, labels, mask, shard))

    zero = torch.zeros((), device=pre_emb.device)
    losses = {"entity": zero, "relation": zero, "static": zero}
    new = dict(bn_ob_raw=state.bn_ob_raw, bn_ob_inv=state.bn_ob_inv, bn_rel_raw=state.bn_rel_raw,
               bn_rel_his=state.bn_rel_his, bn_cand_raw=bn_cand_raw, bn_cand_inv=bn_cand_inv)
    if cfg.entity_prediction:
        preds, new["bn_ob_raw"] = _time_convtrans_score(
            params["decoder_ob_raw"], state.bn_ob_raw, final_raw, r_emb, triples, mask, cfg,
            gen, train, "entity", shard=shard)
        predo, new["bn_ob_inv"] = _time_convtrans_score(
            params["decoder_ob_inv"], state.bn_ob_inv, final_inv, r_emb, inv_triples, mask, cfg,
            gen, train, "entity", shard=shard)
        losses["entity"] = 0.5 * entity_ce(preds, triples[:, 2]) + \
            0.5 * entity_ce(predo, inv_triples[:, 2])
    if cfg.relation_prediction:
        all_triples = torch.cat([triples, inv_triples])
        all_mask = torch.cat([mask, mask])
        s_raw, new["bn_rel_raw"] = _time_convtrans_score(
            params["decoder_rel_raw"], state.bn_rel_raw, pre_emb, r_emb, all_triples, all_mask,
            cfg, gen, train, "relation")
        s_his, new["bn_rel_his"] = _time_convtrans_score(
            params["decoder_rel_his"], state.bn_rel_his, pre_emb, r_emb, all_triples, all_mask,
            cfg, gen, train, "relation", partial=rel_vocab)
        score = cfg.history_rate * s_his + (1 - cfg.history_rate) * s_raw
        losses["relation"] = _masked_ce(score, all_triples[:, 1], all_mask)
    if cfg.use_static:
        # the angular constraint against every step of the g stream
        # (ref :340-355), against the starting embedding without a static graph
        losses["static"] = static_angular_loss(static_emb, all_h, cfg, shard=shard)
    return losses["entity"], losses, HisResState(**new)


def predict(
    params: Params,
    state: HisResState,
    cfg: HisResConfig,
    history,
    history_gg,
    triples: torch.Tensor,
    inv_triples: torch.Tensor,
    mask: torch.Tensor,
    his_graph_raw,
    his_graph_inv,
    rel_vocab: torch.Tensor,
    *,
    static_snap=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval scores (ref :394-434): (entity [2B, N], relation [2B, 2R]), the
    rows stacked [raw; inverse] as the queries ``[triples; inv_triples]``;
    on a mesh the entity scores are this rank's candidates', [2B, rows]."""
    shard = _shard(cfg, params)
    g_emb, gg_emb, r_emb, _, _ = forward(params, cfg, history, history_gg,
                                         static_snap=static_snap)
    pre_emb = whole_rows(fuse_streams(params, g_emb, gg_emb), shard)
    final_raw, final_inv, _, _ = _final_embeddings(params, state, cfg, pre_emb, r_emb,
                                                   his_graph_raw, his_graph_inv, None, False)
    preds, _ = _time_convtrans_score(params["decoder_ob_raw"], state.bn_ob_raw, final_raw, r_emb,
                                     triples, mask, cfg, None, False, "entity", shard=shard)
    predo, _ = _time_convtrans_score(params["decoder_ob_inv"], state.bn_ob_inv, final_inv, r_emb,
                                     inv_triples, mask, cfg, None, False, "entity", shard=shard)
    all_triples = torch.cat([triples, inv_triples])
    all_mask = torch.cat([mask, mask])
    s_raw, _ = _time_convtrans_score(params["decoder_rel_raw"], state.bn_rel_raw, pre_emb, r_emb,
                                     all_triples, all_mask, cfg, None, False, "relation")
    s_his, _ = _time_convtrans_score(params["decoder_rel_his"], state.bn_rel_his, pre_emb, r_emb,
                                     all_triples, all_mask, cfg, None, False, "relation",
                                     partial=rel_vocab)
    return (torch.cat([preds, predo], dim=0),
            cfg.history_rate * s_his + (1 - cfg.history_rate) * s_raw)
