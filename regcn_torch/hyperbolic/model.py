"""Hyperbolic recurrent RGCN: the model core of the hyperbolic slice.

Counterpart of ``regcn_tpu/hyperbolic/model.py`` for its four encoders
(LGCN, the hyperbolic UnionRGCN, FHNN, HGAT) with each of its four
decoders (tangent ConvTransE / R, MuRP, RotH, AttH, each entity decoder
with its relation variant). As in JAX, the encoder alone picks the
evolution path: LGCN, FHNN and HGAT run on the ball (``evolve`` lines
322-367), the uvrgcn on the
tangent carry (``_evolve_tangent``, which JAX's ``evolve`` picks for this
encoder). The JAX ``lax.scan`` over the history window is a Python loop
over its T steps. One evolution step (snapshot t), on the ball:

  ctx  = segment-mean of log_0(h) over relation incidence
  h0   = GRUCell([emb_rel ; ctx], h0)                 (tangent, L2-normalised)
  cur  = encoder cell(g_t, h, h0), projected, tangent-L2-normalised
  h    = exp_0(gate * log_0(cur) + (1-gate) * log_0(h))   (±10 clamps)
  h    = radius evolution towards the static radius   (or apply_radius)

and on the tangent carry v = log_0(h), where every exp_0/log_0 pair of
the ball path becomes a norm clamp (``clamp_tangent_norm``) and the radii
come from v (``radius_from_tangent``, ``apply_radius_tangent``).
``evolve(tangent_fast=False)`` runs the uvrgcn on the ball path instead
(``hyperbolic_union_layer``), the reference formulation the tangent carry
is held against.

The initial points are the exp map of ``dynamic_emb`` (L2-normalised
under ``layer_norm``), or with ``use_static`` of the static entity-word
graph's embedding (one ``rgcn_block_layer``; the loss then adds the
angular constraint between it and each step's evolved point, compared in
tangent space), or with ``manifold_entities`` the table itself, which
then lives on the ball and is updated by Riemannian Adam
(``regcn_torch/hyperbolic/optim.py``).

The curvature is fixed, or learned as clamp(exp(log_c), c_min, c_max),
with c_max a warmup schedule that the trainer passes in; the entity
decoders may learn a curvature per relation below it.

With ``use_est`` (``regcn_torch/hyperbolic/est.py``) the initial points
take the H-PES slow memory before the evolution, and the query heads' rows
of the final table are enriched from their retrieved event histories
before the decoders; with ``use_time_aware_negative`` the other true
tails of each training query are squashed out of its entity scores.

Under ``compute_dtype="bfloat16"`` the trainer hands the model bf16
parameters and windows: the norms, exp / log and radius maps, the
Lorentz and Einstein aggregations, ``_static_radius``, the scatter's input
and the scores stay fp32 islands, each returning the carry's dtype where
JAX's does; a learned curvature promotes what it touches to fp32, as
JAX's strong fp32 scalar does (:func:`get_curvature`).

On an entity-sharded mesh (``cfg.impl`` a marker of ``regcn_torch/dist.py``,
which ``HyperbolicTrainer(mesh=...)`` sets) ``dynamic_emb`` holds this
rank's rows: the evolution, its per-row maps and the decoders' tables run
on them, the relation context and the queries gather their rows by
global id, a replicated [N] leaf (``radius_static``, the ConvTransE bias)
meets the table through the rank's slice, the tangent ConvTransE scores
the rank's candidates with the CE across ranks, and the distance
decoders' CE runs B2 over the all-gathered table on every rank. EST's
memories stay whole and replicated: the evolution injects the rank's rows
of the slow memory, the enrichment gathers the heads' and the neighbours'
rows by global id, computes the same fused rows on every rank and writes
back the heads the rank owns; TANS squashes the rank's candidate columns
(the trainer cuts the COO to them on the host). The static graph's
``words_emb`` is row-sharded as the entity table is: the block layer runs
whole on the gathered tables on every rank (``recurrent._static_init``).
Under bf16 compute the rank's rows enter in bf16 as the whole table does
on one device, and every fp32 island (the norm clamps, the radius weight's
scalars, EST's gathers and write-back) stays where the one-device path
keeps it: the gathers carry the rows in their dtype and every sum across
ranks runs in fp32 (``parallel/collectives.py``). Still to come on a mesh
(ROADMAP A.11b): the sweep's model axis and the counterpart of JAX's
``dryrun_multichip``, neither of which is this module's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from regcn_torch.hyperbolic import decoders as HD
from regcn_torch.hyperbolic import est
from regcn_torch.hyperbolic import layers as HL
from regcn_torch.hyperbolic import ops as H
from regcn_torch.models.decoders import sharded_masked_ce
from regcn_torch.models.layers import gru_cell, init_gru_cell, init_rgcn_block_layer
from regcn_torch.models.recurrent import _masked_ce, _static_init, static_angular_loss, tree_to
from regcn_torch.ops.activations import l2_normalize
from regcn_torch.ops.rgcn_scatter import check_impl
from regcn_torch.ops.segment import masked_segment_mean
from regcn_torch.parallel.collectives import RowShard, rows_of, whole_rows
from regcn_torch.parallel.mesh import table_shard
from regcn_torch.utils.dtypes import compute_dtype, mm
from regcn_torch.ops.streaming_ce import check_width
from regcn_torch.utils.init import xavier_normal, xavier_uniform

Params = Dict[str, Any]

CLAMP = 10.0
ENCODERS = HL.ENCODERS
DECODERS = ("hyperbolic_convtranse", "murp", "roth", "atth")
# (encoder, decoder) pairs this package runs: all of them
PORTED = tuple((e, d) for e in ENCODERS for d in DECODERS)


@dataclasses.dataclass(frozen=True)
class HyperbolicConfig:
    """Same fields and defaults as ``regcn_tpu.hyperbolic.model.HyperbolicConfig``."""

    num_ents: int
    num_rels: int
    h_dim: int = 200
    n_layers: int = 2
    encoder: str = "hyperbolic_uvrgcn"
    decoder: str = "hyperbolic_convtranse"
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
    c: float = 0.01
    learn_curvature: bool = False
    curvature_min: float = 1e-4
    curvature_max: float = 1e-1
    manifold_entities: bool = False
    use_residual_evolution: bool = True
    radius_lambda: float = 0.02
    radius_min: float = 0.5
    radius_max: float = 3.0
    radius_epsilon: float = 0.1
    radius_anchor_beta: float = 1.0
    radius_msg_gamma: float = 1.0
    compute_dtype: str = "float32"
    num_heads: int = 4
    hyp_init_scale: float = 1e-3
    hyp_score_scale_init: float = 1.0
    hyp_score_margin_init: float = 1.0
    use_entity_bias: bool = False
    use_rel_curvature: bool = False
    radius_alpha: float = 0.5
    radius_beta: float = 0.5
    use_est: bool = False
    est_state_alpha: float = 0.2
    est_encoder: str = "gru"
    est_history_len: int = 32
    use_time_aware_negative: bool = False
    impl: str = "xla"

    @property
    def num_rels_total(self) -> int:
        return 2 * self.num_rels


@dataclasses.dataclass
class HypModelState:
    """Non-parameter state: the ConvTrans decoders' BN running statistics
    (empty for the distance decoders) and the radius-target buffer, which
    weight decay never touches."""

    bn_ob: Any
    bn_rel: Any
    radius_target: torch.Tensor  # [N]


def check_supported(cfg: HyperbolicConfig) -> None:
    """Raises for an unknown compute dtype, encoder x decoder pair or
    aggregation route."""
    compute_dtype(cfg.compute_dtype)
    if (cfg.encoder, cfg.decoder) not in PORTED:
        raise ValueError(f"unknown encoder x decoder pair ({cfg.encoder!r}, {cfg.decoder!r}); "
                         f"known: {PORTED}")
    check_impl(cfg.impl)


def check_device(cfg: HyperbolicConfig, device) -> None:
    """Raises where a distance decoder's embedding width is one that kernel
    B2 does not take on ``device`` (``streaming_ce.check_width``): the
    trainers call it at construction."""
    if cfg.decoder in ENTITY_LOSSES:
        check_width(cfg.h_dim, device)


def init_params(gen: torch.Generator, cfg: HyperbolicConfig, radius_target=None,
                device="cuda") -> Tuple[Params, HypModelState]:
    """Random parameters drawn from ``gen`` on the CPU, moved to ``device``.

    ``radius_target`` [N] (e.g. :func:`~regcn_torch.hyperbolic.train.compute_radius_targets`)
    seeds the learnable ``radius_static``; it defaults to mid-range."""
    check_supported(cfg)
    d = cfg.h_dim
    dyn = torch.randn((cfg.num_ents, d), generator=gen)
    if cfg.manifold_entities:
        # on the ball: a tangent normal of std 0.1, mapped (ref :322-325)
        dyn = H.exp_map_zero(0.1 * dyn, cfg.c)
    params: Params = {
        "dynamic_emb": dyn,
        "emb_rel": xavier_normal(gen, (cfg.num_rels_total, d)),
        "time_gate_w": xavier_uniform(gen, (d, d), gain=math.sqrt(2.0)),
        "time_gate_b": torch.zeros(d),
        "gru": init_gru_cell(gen, 2 * d, d),
        "rgcn": HL.init_encoder_cell(gen, cfg.encoder, d, cfg.num_rels_total, cfg.n_layers,
                                     n_bases=cfg.n_bases, num_heads=cfg.num_heads,
                                     self_loop=cfg.self_loop, skip_connect=cfg.skip_connect),
        "radius_mlp_w": xavier_uniform(gen, (1, d), gain=0.1),
        "radius_mlp_b": torch.zeros(1),
    }
    if cfg.learn_curvature:
        params["log_c"] = torch.tensor(math.log(cfg.c))
    rt = (torch.as_tensor(radius_target, dtype=torch.float32).clone()
          if radius_target is not None
          else torch.full((cfg.num_ents,), 0.5 * (cfg.radius_min + cfg.radius_max)))
    params["radius_static"] = rt.clone()
    bn_ob = bn_rel = {}
    scores = dict(score_scale_init=cfg.hyp_score_scale_init,
                  score_margin_init=cfg.hyp_score_margin_init)
    entity = (cfg.num_ents, cfg.num_rels_total, d, cfg.c, cfg.hyp_init_scale,
              cfg.use_entity_bias, cfg.use_rel_curvature)
    if cfg.decoder == "hyperbolic_convtranse":
        params["decoder_ob"], bn_ob = HD.init_hyperbolic_convtranse(gen, cfg.num_ents, d)
        params["decoder_rel"], bn_rel = HD.init_hyperbolic_convtransr(gen, cfg.num_rels_total, d)
    elif cfg.decoder == "murp":
        params["decoder_ob"] = HD.init_murp(gen, *entity, **scores)
        params["decoder_rel"] = HD.init_murp_rel(gen, cfg.num_rels, d)
    else:
        init_ob, init_rel = {"roth": (HD.init_roth, HD.init_roth_rel),
                             "atth": (HD.init_atth, HD.init_atth_rel)}[cfg.decoder]
        params["decoder_ob"] = init_ob(gen, *entity, **scores)
        params["decoder_rel"] = init_rel(gen, cfg.num_rels, d, cfg.hyp_init_scale, **scores)
    if cfg.use_static:
        params["words_emb"] = xavier_normal(gen, (cfg.num_words, d))
        params["static_rgcn"] = init_rgcn_block_layer(gen, d, 2 * cfg.num_static_rels,
                                                      cfg.n_bases)
    if cfg.use_est:
        params["est"] = est.init_est_params(gen, cfg)
    state = HypModelState(bn_ob=tree_to(bn_ob, device), bn_rel=tree_to(bn_rel, device),
                          radius_target=rt.to(device))
    return tree_to(params, device), state


def get_curvature(params: Params, cfg: HyperbolicConfig, curvature_max=None) -> torch.Tensor:
    """clamp(exp(log_c), c_min, c_max) when learned, else the fixed c.

    Under bf16 compute the learned c is returned as a [1] tensor. JAX's is
    a strongly typed fp32 scalar, which promotes every bf16 operand it
    meets to fp32 (a Möbius sum, a map to the hyperboloid); torch promotes
    only for a tensor with an axis, and a [1] tensor broadcasts as the
    scalar does. The fixed c is weakly typed in JAX (``jnp.asarray`` of a
    Python float) and promotes nothing, as the 0-d tensor here."""
    if cfg.learn_curvature:
        cmax = cfg.curvature_max if curvature_max is None else curvature_max
        c = H.clip(torch.exp(params["log_c"]), cfg.curvature_min, cmax)
        return c if cfg.compute_dtype == "float32" else c.reshape(1)
    return H.constant(cfg.c, params["emb_rel"].device)


def _shard(cfg: HyperbolicConfig, params: Params) -> Optional[RowShard]:
    """This rank's rows of the entity table under a sharded ``cfg.impl``,
    else None."""
    return table_shard(cfg.impl, params["dynamic_emb"].shape[0])


def _my_rows(t: torch.Tensor, shard: Optional[RowShard]) -> torch.Tensor:
    """This rank's rows of a replicated [N, ...] leaf (all of it off a mesh)."""
    return t if shard is None else t[shard.row0:shard.row0 + shard.rows]


def _static_radius(params: Params, cfg: HyperbolicConfig, c) -> torch.Tensor:
    """clip(radius_static, r_min, r_max), then below the ball boundary of a
    detached c (the reference bounds it with c.detach())."""
    r = H.clip(params["radius_static"], cfg.radius_min, cfg.radius_max)
    max_r = 1.0 / torch.sqrt(torch.as_tensor(c).detach())
    # in r's dtype: a learned c must not promote a bf16 radius (nor, through
    # apply_radius, the carry) to fp32
    return H.minimum(r, max_r - 1e-6).to(r.dtype)


def _radius_evolution(params, cfg, x, static_radius, c):
    """TemporalRadiusEvolution: anchor to the static radius plus a bounded
    learned delta."""
    tangent = H.log_map_zero(x, c)
    delta = (mm(tangent, params["radius_mlp_w"].T) + params["radius_mlp_b"])[..., 0]
    delta = torch.clamp(delta, -cfg.radius_epsilon, cfg.radius_epsilon)
    dynamic_radius = H.get_radius(x)
    base = (cfg.radius_anchor_beta * static_radius
            + (1.0 - cfg.radius_anchor_beta) * dynamic_radius)
    return H.apply_radius(x, base + delta, c)


def evolve(params: Params, cfg: HyperbolicConfig, history, *, static_snap=None,
           est_slow_state: Optional[torch.Tensor] = None, gen: Optional[torch.Generator] = None,
           train: bool = False, return_all: bool = False, curvature_max=None,
           tangent_fast: Optional[bool] = None):
    """Runs the evolution over a stacked [T, ...] history window (a
    Snapshot of tensors). Returns (h ball points [N, d], h0 [2R, d]); with
    ``return_all``, (h, h0, the static embedding or None, every step's ball
    points [T, N, d]). The uvrgcn encoder runs on its tangent carry unless
    ``tangent_fast`` is False, as JAX's ``evolve`` picks. With
    ``use_static`` and a ``static_snap`` the initial points come from the
    static graph; with ``use_est`` the H-PES slow memory
    ``est_slow_state`` [N, d] is injected into them."""
    check_supported(cfg)
    c = get_curvature(params, cfg, curvature_max)
    shard = _shard(cfg, params)
    static_emb = None
    if cfg.use_static and static_snap is not None:
        static_emb = _static_init(params, cfg, static_snap, gen=gen, train=train, shard=shard)
        h = H.exp_map_zero(static_emb, c)
    elif cfg.manifold_entities:
        # the entities already live on the ball: projected only (ref :775-777)
        h = H.project_to_ball(params["dynamic_emb"], c)
    else:
        emb = params["dynamic_emb"]
        h = H.exp_map_zero(l2_normalize(emb) if cfg.layer_norm else emb, c)
    static_radius = _my_rows(_static_radius(params, cfg, c), shard)
    h = H.apply_radius(h, static_radius, c)
    if cfg.use_est and est_slow_state is not None:
        h = est.inject_slow_state(params["est"], h, _my_rows(est_slow_state, shard), c)
    emb_rel = params["emb_rel"]
    if tangent_fast is None:
        tangent_fast = cfg.encoder == "hyperbolic_uvrgcn"
    if tangent_fast and cfg.encoder == "hyperbolic_uvrgcn":
        h, h0, all_h = _evolve_tangent(params, cfg, history, h, emb_rel, static_radius, c,
                                       gen=gen, train=train, return_all=return_all, shard=shard)
        return (h, h0, static_emb, all_h) if return_all else (h, h0)
    h0 = emb_rel
    all_h = []
    for t in range(history.src.shape[0]):
        snap = history.step(t)
        h_tan = H.log_map_zero(h, c)
        ctx = masked_segment_mean(rows_of(h_tan, snap.rc_ent, shard), snap.rc_rel, snap.rc_mask,
                                  cfg.num_rels_total)
        h0_new = gru_cell(params["gru"], torch.cat([emb_rel, ctx], dim=1), h0)
        if cfg.layer_norm:
            h0_new = l2_normalize(h0_new)
        cur = HL.encoder_cell(params["rgcn"], cfg.encoder, h, h0_new, snap, c,
                              n_bases=cfg.n_bases, radius_gamma=cfg.radius_msg_gamma,
                              dropout=cfg.dropout, gen=gen, train=train, impl=cfg.impl)
        cur = H.project_to_ball(cur, c)
        if cfg.layer_norm:
            cur = H.exp_map_zero(l2_normalize(H.log_map_zero(cur, c)), c)
        cur_tan = torch.clamp(H.log_map_zero(cur, c), -CLAMP, CLAMP)
        prev_tan = torch.clamp(h_tan, -CLAMP, CLAMP)
        gate = torch.sigmoid(mm(prev_tan, params["time_gate_w"]) + params["time_gate_b"])
        h_new = H.project_to_ball(H.exp_map_zero(gate * cur_tan + (1.0 - gate) * prev_tan, c), c)
        if cfg.use_residual_evolution:
            h_new = _radius_evolution(params, cfg, h_new, static_radius, c)
        else:
            h_new = H.apply_radius(h_new, static_radius, c)
        # an empty (all-masked) snapshot is an identity step, decided on the
        # device so the loop never waits for the host
        active = snap.edge_mask.max() > 0
        h = torch.where(active, h_new, h)
        h0 = torch.where(active, h0_new, h0)
        all_h.append(h)
    return (h, h0, static_emb, torch.stack(all_h)) if return_all else (h, h0)


def _evolve_tangent(params, cfg, history, h_init, emb_rel, static_radius, c, *, gen, train,
                    return_all=False, shard=None):
    """The evolution with its carry in tangent space, v = log_0(h) exactly
    (eps clamps included): each exp_0 -> project -> log_0 of the ball path
    is one ``clamp_tangent_norm``, and the ball points are made at the end:
    (h [N, d], h0, with ``return_all`` every step's points [T, N, d], else
    None)."""
    v, h0 = H.log_map_zero(h_init, c), emb_rel
    all_v = []
    for t in range(history.src.shape[0]):
        snap = history.step(t)
        ctx = masked_segment_mean(rows_of(v, snap.rc_ent, shard), snap.rc_rel, snap.rc_mask,
                                  cfg.num_rels_total)
        h0_new = gru_cell(params["gru"], torch.cat([emb_rel, ctx], dim=1), h0)
        if cfg.layer_norm:
            h0_new = l2_normalize(h0_new)
        cur = HL.uvrgcn_cell_tangent(params["rgcn"], v, h0_new, snap, c,
                                     radius_gamma=cfg.radius_msg_gamma, dropout=cfg.dropout,
                                     gen=gen, train=train, impl=cfg.impl)
        # the ball path projects (the cell's last clamp), tangent-normalises,
        # then clips: unit rows make the clip a no-op
        cur_tan = l2_normalize(cur) if cfg.layer_norm else torch.clamp(cur, -CLAMP, CLAMP)
        prev_tan = torch.clamp(v, -CLAMP, CLAMP)
        gate = torch.sigmoid(mm(prev_tan, params["time_gate_w"]) + params["time_gate_b"])
        v_new = H.clamp_tangent_norm(gate * cur_tan + (1.0 - gate) * prev_tan, c)
        if cfg.use_residual_evolution:
            delta = (mm(v_new, params["radius_mlp_w"].T) + params["radius_mlp_b"])[..., 0]
            delta = torch.clamp(delta, -cfg.radius_epsilon, cfg.radius_epsilon)
            base = (cfg.radius_anchor_beta * static_radius
                    + (1.0 - cfg.radius_anchor_beta) * H.radius_from_tangent(v_new, c))
            v_new = H.apply_radius_tangent(v_new, base + delta, c)
        else:
            v_new = H.apply_radius_tangent(v_new, static_radius, c)
        active = snap.edge_mask.max() > 0
        v = torch.where(active, v_new, v)
        h0 = torch.where(active, h0_new, h0)
        all_v.append(v)
    # every step's points as JAX makes them: the exp map of the stacked
    # carries, which the static loss maps back to the tangent space
    all_h = H.exp_map_zero(torch.stack(all_v), c) if return_all else None
    return H.exp_map_zero(v, c), h0, all_h


def static_angular_loss_tangent(static_emb: torch.Tensor, all_h: torch.Tensor, cfg, c,
                                active: Optional[torch.Tensor] = None,
                                shard: Optional[RowShard] = None) -> torch.Tensor:
    """The static constraint compared in tangent space (ref :1039-1064):
    ``recurrent.static_angular_loss`` of log_0 of every step's points (on a
    mesh, of the rank's rows, summed across the ranks)."""
    return static_angular_loss(static_emb, H.log_map_zero(all_h, c), cfg, active=active,
                               shard=shard)


def radius_supervision_loss(params, state: HypModelState, cfg, triples, mask, c):
    """λ · MSE(static radius, radius target) over the batch's entities."""
    ents = torch.cat([triples[:, 0], triples[:, 2]])
    w = torch.cat([mask, mask])
    present = torch.clamp(w.new_zeros(cfg.num_ents).index_add(0, ents, w), 0.0, 1.0)
    diff_sq = (_static_radius(params, cfg, c) - state.radius_target) ** 2 * present
    return cfg.radius_lambda * torch.sum(diff_sq) / torch.clamp(torch.sum(present), min=1.0)


def _decoder_dropouts(cfg):
    return (cfg.input_dropout, cfg.hidden_dropout, cfg.feat_dropout)


ENTITY_SCORES = {"murp": HD.murp_score, "roth": HD.roth_score, "atth": HD.atth_score}
RELATION_SCORES = {"murp": HD.murp_rel_score, "roth": HD.roth_rel_score,
                   "atth": HD.atth_rel_score}
ENTITY_LOSSES = {"murp": HD.murp_loss, "roth": HD.roth_loss, "atth": HD.atth_loss}
RELATION_LOSSES = {"murp": HD.murp_rel_loss, "roth": HD.roth_rel_loss,
                   "atth": HD.atth_rel_loss}


def entity_scores(params, state, cfg, pre_emb, r_emb, triples, mask, c, *, gen=None,
                  train=False, ent_tan=None, shard=None) -> Tuple[torch.Tensor, Any]:
    """(entity scores [B, N], new ``bn_ob``; the old one for the distance
    decoders). With ``shard`` the tables hold this rank's rows and the
    scores are its candidates', [B, rows]."""
    if cfg.decoder == "hyperbolic_convtranse":
        return HD.hyperbolic_convtranse_score(
            params["decoder_ob"], state.bn_ob, pre_emb, r_emb, triples, c, mask,
            dropouts=_decoder_dropouts(cfg), gen=gen, train=train, ent_tan=ent_tan, shard=shard)
    columns = None if shard is None else slice(shard.row0, shard.row0 + shard.rows)
    return ENTITY_SCORES[cfg.decoder](params["decoder_ob"], whole_rows(pre_emb, shard), r_emb,
                                      triples, c, dropout=cfg.input_dropout, gen=gen,
                                      train=train, columns=columns), state.bn_ob


def relation_scores(params, state, cfg, pre_emb, r_emb, triples, mask, c, *, gen=None,
                    train=False, ent_tan=None, shard=None) -> Tuple[torch.Tensor, Any]:
    """(relation scores [B, 2R], new ``bn_rel``; the old one for the
    distance decoders); replicated on a mesh."""
    if cfg.decoder == "hyperbolic_convtranse":
        return HD.hyperbolic_convtransr_score(
            params["decoder_rel"], state.bn_rel, pre_emb, r_emb, triples, c, mask,
            dropouts=_decoder_dropouts(cfg), gen=gen, train=train, ent_tan=ent_tan, shard=shard)
    return RELATION_SCORES[cfg.decoder](params["decoder_rel"], whole_rows(pre_emb, shard), r_emb,
                                        triples, c, dropout=cfg.input_dropout, gen=gen,
                                        train=train), state.bn_rel


def _decoder_inputs(h, cfg, c):
    """(ball points for the decoders, the ConvTrans decoders' shared
    leaky-tanh tangent table or None), as JAX's ``get_loss`` and
    ``predict`` make them."""
    pre_tan = H.log_map_zero(h, c)
    if cfg.layer_norm:
        pre_tan = l2_normalize(pre_tan)
    ent_tan = None
    if cfg.decoder == "hyperbolic_convtranse":
        ent_tan = HD._leaky_tanh(H.clamp_tangent_norm(pre_tan, c))
    return H.exp_map_zero(pre_tan, c), ent_tan


def _dynamic_tangent(params, cfg, c):
    """The entity table as EST reads it: tangent vectors, so the log map of
    the table where it lives on the ball."""
    emb = params["dynamic_emb"]
    return H.log_map_zero(emb, c) if cfg.manifold_entities else emb


def _enrich(params, cfg, est_inputs, emb, ent_tan, triples, r_emb, c, shard=None):
    """EST's enrichment of the decoders' table ``emb`` from ``est_inputs``
    (the ESTState, the RetrievalBatch of the batch's heads): (the enriched
    table, the ConvTrans decoders' leaky-tanh tangent table of it where
    ``ent_tan`` was one, the fused tangent rows [B, d]). JAX lets each
    ConvTrans decoder derive the tangent table from the enriched one; it
    is derived here once for both. With ``shard`` the tables hold this
    rank's rows (``est.enrich_embeddings``)."""
    emb, ctx = est.enrich_embeddings(params["est"], cfg, emb, triples, est_inputs[1], c,
                                     est_inputs[0].slow, _dynamic_tangent(params, cfg, c),
                                     r_emb, return_ctx_tangent=True, shard=shard)
    if ent_tan is not None:
        ent_tan = HD._leaky_tanh(H.log_map_zero(emb, c))
    return emb, ent_tan, ctx


def get_loss(params: Params, state: HypModelState, cfg: HyperbolicConfig, history,
             triples: torch.Tensor, triple_mask: torch.Tensor, *, static_snap=None,
             est_inputs=None, tans_mask_coo=None, gen: Optional[torch.Generator] = None, train: bool = True,
             curvature_max=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], HypModelState, Dict[str, Any]]:
    """(loss_ent, {"entity", "relation", "static", "radius"}, new
    HypModelState, aux): the losses are 0-d tensors, the new state holds the
    ConvTrans decoders' updated BN running statistics in train mode, and
    ``aux`` the decoders' table ``pre_emb``, the ``curvature`` and, where
    EST enriched the table, the fused tangent rows ``est_ctx_tan`` [B, d]
    for the H-PES writeback.

    ``triples`` [B, 3] with inverses, padded; ``triple_mask`` [B].
    ``static_snap``: the static graph's Snapshot with ``use_static``, whose
    angular constraint is then the static loss (else 0).
    ``est_inputs``: (ESTState, RetrievalBatch or None) with ``use_est``.
    ``tans_mask_coo``: (rows, cols) of entity scores squashed to -1e9 in
    training with ``use_time_aware_negative`` (rows >= B are padding); on a
    mesh, of the rank's candidate columns (``est.shard_tans_coo``)."""
    c = get_curvature(params, cfg, curvature_max)
    shard = _shard(cfg, params)
    slow = est_inputs[0].slow if cfg.use_est and est_inputs is not None else None
    static_emb = all_h = None
    kw = dict(static_snap=static_snap, est_slow_state=slow, gen=gen, train=train,
              curvature_max=curvature_max)
    if cfg.use_static:
        h, r_emb, static_emb, all_h = evolve(params, cfg, history, return_all=True, **kw)
    else:
        h, r_emb = evolve(params, cfg, history, **kw)
    pre_emb, ent_tan = _decoder_inputs(h, cfg, c)
    aux: Dict[str, Any] = {}
    if slow is not None and est_inputs[1] is not None:
        pre_emb, ent_tan, aux["est_ctx_tan"] = _enrich(params, cfg, est_inputs, pre_emb, ent_tan,
                                                       triples, r_emb, c, shard)
    aux.update(pre_emb=pre_emb, curvature=c)
    zero = torch.zeros((), device=h.device)
    losses = {"entity": zero, "relation": zero, "static": zero}
    bn_ob, bn_rel = state.bn_ob, state.bn_rel
    convtrans = cfg.decoder == "hyperbolic_convtranse"
    # the distance decoders' CE is B2 over every candidate: on a mesh each
    # rank runs it over the all-gathered table, the loss replicated
    whole = None if convtrans else whole_rows(pre_emb, shard)
    if cfg.entity_prediction:
        if convtrans:
            scores, bn_ob = entity_scores(params, state, cfg, pre_emb, r_emb, triples,
                                          triple_mask, c, gen=gen, train=train, ent_tan=ent_tan,
                                          shard=shard)
            if cfg.use_time_aware_negative and tans_mask_coo is not None and train:
                scores = est.squash_entries(scores, *tans_mask_coo)
            losses["entity"] = (
                _masked_ce(scores, triples[:, 2], triple_mask) if shard is None
                else sharded_masked_ce(scores, triples[:, 2], triple_mask, shard))
        else:
            losses["entity"] = ENTITY_LOSSES[cfg.decoder](
                params["decoder_ob"], whole, r_emb, triples, c, mask=triple_mask,
                dropout=cfg.input_dropout, gen=gen, train=train,
                rel_curvature_max=curvature_max)
    if cfg.relation_prediction:
        if convtrans:
            scores, bn_rel = relation_scores(params, state, cfg, pre_emb, r_emb, triples,
                                             triple_mask, c, gen=gen, train=train,
                                             ent_tan=ent_tan, shard=shard)
            losses["relation"] = _masked_ce(scores, triples[:, 1], triple_mask)
        else:
            losses["relation"] = RELATION_LOSSES[cfg.decoder](
                params["decoder_rel"], whole, r_emb, triples, c, mask=triple_mask,
                dropout=cfg.input_dropout, gen=gen, train=train)
    if static_emb is not None:
        active = (history.edge_mask.amax(dim=1) > 0).float()
        losses["static"] = static_angular_loss_tangent(static_emb, all_h, cfg, c, active=active,
                                                       shard=shard)
    losses["radius"] = radius_supervision_loss(params, state, cfg, triples, triple_mask, c)
    new_state = HypModelState(bn_ob=bn_ob, bn_rel=bn_rel, radius_target=state.radius_target)
    return losses["entity"], losses, new_state, aux


def predict(params: Params, state: HypModelState, cfg: HyperbolicConfig, history,
            triples: torch.Tensor, triple_mask=None, *, static_snap=None, est_inputs=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode scores: (entity [B, N], relation [B, 2R]); ``static_snap``
    and ``est_inputs`` as in :func:`get_loss`. On a mesh the entity scores
    are this rank's candidates', [B, rows]."""
    c = get_curvature(params, cfg)
    slow = est_inputs[0].slow if cfg.use_est and est_inputs is not None else None
    shard = _shard(cfg, params)
    h, r_emb = evolve(params, cfg, history, static_snap=static_snap, est_slow_state=slow)
    emb, ent_tan = _decoder_inputs(h, cfg, c)
    if slow is not None and est_inputs[1] is not None:
        emb, ent_tan, _ = _enrich(params, cfg, est_inputs, emb, ent_tan, triples, r_emb, c, shard)
    kw = dict(ent_tan=ent_tan, shard=shard)
    return (entity_scores(params, state, cfg, emb, r_emb, triples, triple_mask, c, **kw)[0],
            relation_scores(params, state, cfg, emb, r_emb, triples, triple_mask, c, **kw)[0])
