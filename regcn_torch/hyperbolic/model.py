"""Hyperbolic recurrent RGCN: the model core of the hyperbolic slice.

Counterpart of ``regcn_tpu/hyperbolic/model.py`` on its ball-space path
(``evolve`` lines 322-367) for the LGCN encoder and the RotH / RotH-Rel
decoders. The JAX ``lax.scan`` over the history window is a Python loop
over its T steps. One evolution step (snapshot t):

  ctx  = segment-mean of log_0(h) over relation incidence
  h0   = GRUCell([emb_rel ; ctx], h0)                 (tangent, L2-normalised)
  cur  = LGCN cell(g_t, h, h0), projected, tangent-L2-normalised
  h    = exp_0(gate * log_0(cur) + (1-gate) * log_0(h))   (±10 clamps)
  h    = radius evolution towards the static radius   (or apply_radius)

The curvature is fixed, or learned as clamp(exp(log_c), c_min, c_max),
with c_max a warmup schedule that the trainer passes in.

Not ported yet, and raising: the static graph, EST, entities stored on
the ball (Riemannian Adam), bf16, the uvrgcn tangent-carry path and the
other encoders and decoders (ROADMAP A6-A9).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from regcn_torch.hyperbolic import decoders as HD
from regcn_torch.hyperbolic import layers as HL
from regcn_torch.hyperbolic import ops as H
from regcn_torch.models.layers import gru_cell, init_gru_cell
from regcn_torch.models.recurrent import tree_to
from regcn_torch.ops.activations import l2_normalize
from regcn_torch.ops.segment import masked_segment_mean
from regcn_torch.utils.init import xavier_normal, xavier_uniform

Params = Dict[str, Any]

CLAMP = 10.0
ENCODERS = HL.ENCODERS
DECODERS = ("hyperbolic_convtranse", "murp", "roth", "atth")


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
    """Non-parameter state: decoder BN stats (none for RotH) and the
    radius-target buffer, which weight decay never touches."""

    bn_ob: Any
    bn_rel: Any
    radius_target: torch.Tensor  # [N]


def check_supported(cfg: HyperbolicConfig) -> None:
    """Raises for the configurations this package does not run yet."""
    unported = {
        "use_static": "the static graph (ROADMAP A7)",
        "use_est": "EST (ROADMAP A9)",
        "use_time_aware_negative": "TANS negatives (ROADMAP A9)",
        "manifold_entities": "entities on the ball with Riemannian Adam (ROADMAP A6)",
    }
    for flag, what in unported.items():
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag}: {what} is not ported yet")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(f"compute dtype {cfg.compute_dtype!r}: only float32 is ported")
    if cfg.encoder != "lgcn":
        raise NotImplementedError(f"the {cfg.encoder} encoder is not ported yet (ROADMAP A6/A8)")
    if cfg.decoder != "roth":
        raise NotImplementedError(f"the {cfg.decoder} decoder is not ported yet (ROADMAP A6/A8)")
    if cfg.impl != "xla":
        raise NotImplementedError(f"impl {cfg.impl!r} is not ported yet")


def init_params(gen: torch.Generator, cfg: HyperbolicConfig, radius_target=None,
                device="cuda") -> Tuple[Params, HypModelState]:
    """Random parameters drawn from ``gen`` on the CPU, moved to ``device``.

    ``radius_target`` [N] (e.g. :func:`~regcn_torch.hyperbolic.train.compute_radius_targets`)
    seeds the learnable ``radius_static``; it defaults to mid-range."""
    check_supported(cfg)
    d = cfg.h_dim
    params: Params = {
        "dynamic_emb": torch.randn((cfg.num_ents, d), generator=gen),
        "emb_rel": xavier_normal(gen, (cfg.num_rels_total, d)),
        "time_gate_w": xavier_uniform(gen, (d, d), gain=math.sqrt(2.0)),
        "time_gate_b": torch.zeros(d),
        "gru": init_gru_cell(gen, 2 * d, d),
        "rgcn": HL.init_encoder_cell(gen, cfg.encoder, d, cfg.num_rels_total, cfg.n_layers,
                                     n_bases=cfg.n_bases, self_loop=cfg.self_loop,
                                     skip_connect=cfg.skip_connect),
        "radius_mlp_w": xavier_uniform(gen, (1, d), gain=0.1),
        "radius_mlp_b": torch.zeros(1),
    }
    if cfg.learn_curvature:
        params["log_c"] = torch.tensor(math.log(cfg.c))
    rt = (torch.as_tensor(radius_target, dtype=torch.float32).clone()
          if radius_target is not None
          else torch.full((cfg.num_ents,), 0.5 * (cfg.radius_min + cfg.radius_max)))
    params["radius_static"] = rt.clone()
    params["decoder_ob"] = HD.init_roth(
        gen, cfg.num_ents, cfg.num_rels_total, d, cfg.c, cfg.hyp_init_scale,
        cfg.use_entity_bias, cfg.use_rel_curvature,
        score_scale_init=cfg.hyp_score_scale_init, score_margin_init=cfg.hyp_score_margin_init)
    params["decoder_rel"] = HD.init_roth_rel(
        gen, cfg.num_rels, d, cfg.hyp_init_scale,
        score_scale_init=cfg.hyp_score_scale_init, score_margin_init=cfg.hyp_score_margin_init)
    state = HypModelState(bn_ob={}, bn_rel={}, radius_target=rt.to(device))
    return tree_to(params, device), state


def get_curvature(params: Params, cfg: HyperbolicConfig, curvature_max=None) -> torch.Tensor:
    """clamp(exp(log_c), c_min, c_max) when learned, else the fixed c."""
    if cfg.learn_curvature:
        cmax = cfg.curvature_max if curvature_max is None else curvature_max
        return H.clip(torch.exp(params["log_c"]), cfg.curvature_min, cmax)
    return H.constant(cfg.c, params["emb_rel"].device)


def _static_radius(params: Params, cfg: HyperbolicConfig, c) -> torch.Tensor:
    """clip(radius_static, r_min, r_max), then below the ball boundary of a
    detached c (the reference bounds it with c.detach())."""
    r = H.clip(params["radius_static"], cfg.radius_min, cfg.radius_max)
    max_r = 1.0 / torch.sqrt(torch.as_tensor(c).detach())
    return H.minimum(r, max_r - 1e-6)


def _radius_evolution(params, cfg, x, static_radius, c):
    """TemporalRadiusEvolution: anchor to the static radius plus a bounded
    learned delta."""
    tangent = H.log_map_zero(x, c)
    delta = (tangent @ params["radius_mlp_w"].T + params["radius_mlp_b"])[..., 0]
    delta = torch.clamp(delta, -cfg.radius_epsilon, cfg.radius_epsilon)
    dynamic_radius = H.get_radius(x)
    base = (cfg.radius_anchor_beta * static_radius
            + (1.0 - cfg.radius_anchor_beta) * dynamic_radius)
    return H.apply_radius(x, base + delta, c)


def evolve(params: Params, cfg: HyperbolicConfig, history, *,
           gen: Optional[torch.Generator] = None, train: bool = False,
           curvature_max=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Runs the evolution over a stacked [T, ...] history window (a
    Snapshot of tensors). Returns (h ball points [N, d], h0 [2R, d])."""
    check_supported(cfg)
    c = get_curvature(params, cfg, curvature_max)
    emb = params["dynamic_emb"]
    h = H.exp_map_zero(l2_normalize(emb) if cfg.layer_norm else emb, c)
    static_radius = _static_radius(params, cfg, c)
    h = H.apply_radius(h, static_radius, c)
    emb_rel = params["emb_rel"]
    h0 = emb_rel
    for t in range(history.src.shape[0]):
        snap = history.step(t)
        h_tan = H.log_map_zero(h, c)
        ctx = masked_segment_mean(h_tan.index_select(0, snap.rc_ent), snap.rc_rel, snap.rc_mask,
                                  cfg.num_rels_total)
        h0_new = gru_cell(params["gru"], torch.cat([emb_rel, ctx], dim=1), h0)
        if cfg.layer_norm:
            h0_new = l2_normalize(h0_new)
        cur = HL.encoder_cell(params["rgcn"], cfg.encoder, h, h0_new, snap, c,
                              n_bases=cfg.n_bases, dropout=cfg.dropout, gen=gen, train=train,
                              impl=cfg.impl)
        cur = H.project_to_ball(cur, c)
        if cfg.layer_norm:
            cur = H.exp_map_zero(l2_normalize(H.log_map_zero(cur, c)), c)
        cur_tan = torch.clamp(H.log_map_zero(cur, c), -CLAMP, CLAMP)
        prev_tan = torch.clamp(h_tan, -CLAMP, CLAMP)
        gate = torch.sigmoid(prev_tan @ params["time_gate_w"] + params["time_gate_b"])
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
    return h, h0


def _final_embedding(h, cfg, c):
    if cfg.layer_norm:
        return H.exp_map_zero(l2_normalize(H.log_map_zero(h, c)), c)
    return h


def radius_supervision_loss(params, state: HypModelState, cfg, triples, mask, c):
    """λ · MSE(static radius, radius target) over the batch's entities."""
    ents = torch.cat([triples[:, 0], triples[:, 2]])
    w = torch.cat([mask, mask])
    present = torch.clamp(w.new_zeros(cfg.num_ents).index_add(0, ents, w), 0.0, 1.0)
    diff_sq = (_static_radius(params, cfg, c) - state.radius_target) ** 2 * present
    return cfg.radius_lambda * torch.sum(diff_sq) / torch.clamp(torch.sum(present), min=1.0)


def entity_scores(params, state, cfg, pre_emb, r_emb, triples, c, *, gen=None, train=False):
    return HD.roth_score(params["decoder_ob"], pre_emb, r_emb, triples, c,
                         dropout=cfg.input_dropout, gen=gen, train=train)


def relation_scores(params, state, cfg, pre_emb, r_emb, triples, c, *, gen=None, train=False):
    return HD.roth_rel_score(params["decoder_rel"], pre_emb, r_emb, triples, c,
                             dropout=cfg.input_dropout, gen=gen, train=train)


def get_loss(params: Params, state: HypModelState, cfg: HyperbolicConfig, history,
             triples: torch.Tensor, triple_mask: torch.Tensor, *,
             gen: Optional[torch.Generator] = None, train: bool = True,
             curvature_max=None) -> Dict[str, torch.Tensor]:
    """The entity, relation, static and radius losses (0-d tensors).

    ``triples`` [B, 3] with inverses, padded; ``triple_mask`` [B]."""
    c = get_curvature(params, cfg, curvature_max)
    h, r_emb = evolve(params, cfg, history, gen=gen, train=train, curvature_max=curvature_max)
    pre_emb = _final_embedding(h, cfg, c)
    zero = torch.zeros((), device=h.device)
    losses = {"entity": zero, "relation": zero, "static": zero}
    if cfg.entity_prediction:
        losses["entity"] = HD.roth_loss(
            params["decoder_ob"], pre_emb, r_emb, triples, c, mask=triple_mask,
            dropout=cfg.input_dropout, gen=gen, train=train, rel_curvature_max=curvature_max)
    if cfg.relation_prediction:
        losses["relation"] = HD.roth_rel_loss(
            params["decoder_rel"], pre_emb, r_emb, triples, c, mask=triple_mask,
            dropout=cfg.input_dropout, gen=gen, train=train)
    losses["radius"] = radius_supervision_loss(params, state, cfg, triples, triple_mask, c)
    return losses


def predict(params: Params, state: HypModelState, cfg: HyperbolicConfig, history,
            triples: torch.Tensor, triple_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode scores: (entity [B, N], relation [B, 2R])."""
    c = get_curvature(params, cfg)
    h, r_emb = evolve(params, cfg, history)
    emb = _final_embedding(h, cfg, c)
    return (entity_scores(params, state, cfg, emb, r_emb, triples, c),
            relation_scores(params, state, cfg, emb, r_emb, triples, c))
