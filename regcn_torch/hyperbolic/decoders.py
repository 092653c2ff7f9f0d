"""Hyperbolic distance decoders: RotH and RotH-Rel.

Counterpart of ``regcn_tpu/hyperbolic/decoders.py`` for the decoders the
hyperbolic config-3 slice runs. Scores come from the Möbius-difference
distance of a query to every candidate, from one [B,d]x[d,N] product
(:func:`regcn_torch.ops.streaming_ce.distance_logits`). The training
loss :func:`dist_ce_loss` is kernel B2 on a CUDA tensor and its plain
version on a CPU tensor (:func:`regcn_torch.ops.streaming_ce.streaming_nll`).

MuRP, AttH, DistMult, ComplEx and the tangent ConvTransE/R decoders are
not ported yet (ROADMAP A6, A8): their entry points raise.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from regcn_torch.hyperbolic import ops as H
from regcn_torch.hyperbolic.layers import _dropout
from regcn_torch.ops.streaming_ce import SCORE_EPS, distance_logits, streaming_nll

Params = Dict[str, torch.Tensor]

REL_C_EPS = 1e-5  # ref REL_CURVATURE_EPSILON
REL_C_MARGIN = 0.999
REL_C_INIT_RATIO = 0.95

def softplus_inverse(x: float, eps: float = 1e-12) -> float:
    return math.log(max(math.exp(float(x)) - 1.0, eps))


def clamp_relation_curvature(rel_c_raw, global_c, warmup_max=None):
    """Two-sided clamp into [REL_C_EPS, min(REL_C_MARGIN c, warmup_max)]."""
    upper = REL_C_MARGIN * global_c
    if warmup_max is not None:
        upper = H.minimum(H._t(upper, rel_c_raw), warmup_max)
    return H.clip(rel_c_raw, REL_C_EPS, upper)


def dist_score(query, candidates, c, *, candidate_bias=None, score_scale=None,
               score_margin=0.0, query_curvature=None, use_hyperbolic_distance=False):
    """[B, N] Möbius-difference scores: margin - ||diff||^2 (proxy, global
    c) or margin - d_c(q, x) with per-query curvature."""
    if use_hyperbolic_distance and query_curvature is not None:
        c = query_curvature.reshape(-1, 1)
    return distance_logits(query, candidates, c, bias=candidate_bias, scale=score_scale,
                           margin=score_margin, true_dist=use_hyperbolic_distance)


def dist_ce_loss(query, candidates, target, c, *, mask=None, candidate_bias=None,
                 score_scale=None, score_margin=0.0, query_curvature=None,
                 use_hyperbolic_distance=False) -> torch.Tensor:
    """Masked-mean CE over all candidates: kernel B2 on CUDA tensors, its
    plain version on CPU tensors. The proxy path uses the global c even
    when a per-query curvature is given, as the dense JAX path does."""
    B, N = query.shape[0], candidates.shape[0]
    f32 = dict(dtype=torch.float32, device=query.device)
    bias = candidate_bias if candidate_bias is not None else torch.zeros(N, **f32)
    scale = H._t(1.0 if score_scale is None else score_scale, query).float().reshape(())
    margin = H._t(score_margin, query).float().reshape(())
    if query_curvature is None or not use_hyperbolic_distance:
        cq = H._t(c, query).float().reshape(()).expand(B).contiguous()
    else:
        cq = query_curvature.reshape(-1).float().contiguous()
    nll = streaming_nll(query.float().contiguous(), candidates.float().contiguous(),
                        bias.float().contiguous(), target, cq, scale, margin,
                        bool(use_hyperbolic_distance))
    if mask is None:
        return nll.mean()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ------------------------------------------------------- Givens primitives

def givens_rotation(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Pairwise 2-D rotations. x [B,d], angles [B,d/2] or [d/2]."""
    if angles.dim() == 1:
        angles = angles[None, :].expand(x.shape[0], -1)
    x1, x2 = x[:, 0::2], x[:, 1::2]
    ca, sa = torch.cos(angles), torch.sin(angles)
    return torch.stack([ca * x1 - sa * x2, sa * x1 + ca * x2], dim=2).reshape(x.shape)


def _score_scale(params):
    return torch.nn.functional.softplus(params["score_scale_raw"]) + SCORE_EPS


def _relation_curvature(params, r_idx, c, warmup_max=None):
    if "rel_curvature_raw" not in params:
        return None
    n = params["rel_curvature_raw"].shape[0]
    raw = torch.nn.functional.softplus(params["rel_curvature_raw"][torch.remainder(r_idx, n)])
    return clamp_relation_curvature(raw, c, warmup_max)


def _uniform(gen, shape, bound):
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


# ----------------------------------------------------------------- RotH

def init_roth(gen: torch.Generator, num_entities, num_rels_total, h_dim, c_init=0.01,
              init_scale=1e-3, use_entity_bias=False, use_rel_curvature=False,
              score_scale_init=1.0, score_margin_init=1.0) -> Params:
    if h_dim % 2:
        raise ValueError(f"h_dim must be even for the Givens rotation; got {h_dim}")
    p: Params = {
        "rot_w": _uniform(gen, (h_dim // 2, h_dim), init_scale),
        "rot_b": torch.zeros(h_dim // 2),
        "trans_w": _uniform(gen, (h_dim, h_dim), init_scale),
        "trans_b": torch.zeros(h_dim),
        "reshape_w1": _uniform(gen, (h_dim, h_dim), init_scale),
        "reshape_b1": torch.zeros(h_dim),
        "reshape_w2": _uniform(gen, (h_dim, h_dim), init_scale),
        "reshape_b2": torch.zeros(h_dim),
        "score_scale_raw": torch.tensor(float(score_scale_init)),
        "score_margin": torch.tensor(float(score_margin_init)),
    }
    if use_entity_bias:
        p["entity_bias"] = torch.zeros(num_entities)
    if use_rel_curvature:
        theta = softplus_inverse(max(c_init * REL_C_INIT_RATIO, REL_C_EPS))
        p["rel_curvature_raw"] = torch.full((num_rels_total,), theta)
    return p


def _reshape_tangent(params, x):
    """Residual tangent MLP before the Givens pairing."""
    hidden = torch.relu(x @ params["reshape_w1"].T + params["reshape_b1"])
    return x + hidden @ params["reshape_w2"].T + params["reshape_b2"]


def _roth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train):
    r_idx = triples[:, 1]
    s_emb = H.project_to_ball(entity_embedding.index_select(0, triples[:, 0]), c)
    s_tan = _dropout(H.log_map_zero(s_emb, c), dropout, gen, train)
    s_tan = _reshape_tangent(params, s_tan)
    rel = rel_embedding.index_select(0, r_idx)
    angles = rel @ params["rot_w"].T + params["rot_b"]
    rot_s = H.exp_map_zero(givens_rotation(s_tan, angles), c)
    t_r = H.exp_map_zero(rel @ params["trans_w"].T + params["trans_b"], c)
    return H.mobius_add(H.project_to_ball(rot_s, c), H.project_to_ball(t_r, c), c)


def _roth_distance_args(params, triples, c, rel_curvature_max):
    return dict(candidate_bias=params.get("entity_bias"), score_scale=_score_scale(params),
                score_margin=params["score_margin"],
                query_curvature=_relation_curvature(params, triples[:, 1], c, rel_curvature_max),
                use_hyperbolic_distance="rel_curvature_raw" in params)


def roth_score(params, entity_embedding, rel_embedding, triples, c, *, dropout=0.0, gen=None,
               train=False, rel_curvature_max=None):
    query = _roth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train)
    scores = dist_score(query, entity_embedding, c,
                        **_roth_distance_args(params, triples, c, rel_curvature_max))
    if "entity_bias" in params:
        scores = scores + params["entity_bias"][triples[:, 0]][:, None]
    return scores


def roth_loss(params, entity_embedding, rel_embedding, triples, c, *, mask=None, dropout=0.0,
              gen=None, train=True, rel_curvature_max=None):
    query = _roth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train)
    return dist_ce_loss(query, entity_embedding, triples[:, 2], c, mask=mask,
                        **_roth_distance_args(params, triples, c, rel_curvature_max))


def init_roth_rel(gen: torch.Generator, num_rels_base, h_dim, init_scale=1e-3,
                  score_scale_init=1.0, score_margin_init=1.0) -> Params:
    if h_dim % 2:
        raise ValueError(f"h_dim must be even for the Givens rotation; got {h_dim}")
    return {
        "global_rot": _uniform(gen, (h_dim // 2,), math.pi),
        "reshape_w1": _uniform(gen, (h_dim, h_dim), init_scale),
        "reshape_b1": torch.zeros(h_dim),
        "reshape_w2": _uniform(gen, (h_dim, h_dim), init_scale),
        "reshape_b2": torch.zeros(h_dim),
        "rel_bias": torch.zeros(num_rels_base * 2),
        "score_scale_raw": torch.tensor(float(score_scale_init)),
        "score_margin": torch.tensor(float(score_margin_init)),
    }


def _roth_rel_query(params, entity_embedding, triples, c, dropout, gen, train):
    s_tan = _dropout(H.log_map_zero(entity_embedding.index_select(0, triples[:, 0]), c),
                     dropout, gen, train)
    s_tan = _reshape_tangent(params, s_tan)
    rot_s = H.exp_map_zero(givens_rotation(s_tan, params["global_rot"]), c)
    return H.mobius_add(-rot_s, entity_embedding.index_select(0, triples[:, 2]), c)


def roth_rel_score(params, entity_embedding, rel_embedding, triples, c, *, dropout=0.0,
                   gen=None, train=False):
    query = _roth_rel_query(params, entity_embedding, triples, c, dropout, gen, train)
    return dist_score(query, H.exp_map_zero(rel_embedding, c), c,
                      candidate_bias=params["rel_bias"], score_scale=_score_scale(params),
                      score_margin=params["score_margin"])


def roth_rel_loss(params, entity_embedding, rel_embedding, triples, c, *, mask=None,
                  dropout=0.0, gen=None, train=True):
    query = _roth_rel_query(params, entity_embedding, triples, c, dropout, gen, train)
    return dist_ce_loss(query, H.exp_map_zero(rel_embedding, c), triples[:, 1], c, mask=mask,
                        candidate_bias=params["rel_bias"], score_scale=_score_scale(params),
                        score_margin=params["score_margin"])


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"the {name} decoder is not ported yet (ROADMAP {item})")

    fn.__name__ = name
    return fn


init_murp = murp_score = murp_loss = _not_ported("MuRP", "A8")
init_atth = atth_score = atth_loss = _not_ported("AttH", "A8")
distmult_score = _not_ported("DistMult", "A8")
complex_score = _not_ported("ComplEx", "A8")
hyperbolic_convtranse_score = _not_ported("tangent ConvTransE", "A6")
hyperbolic_convtransr_score = _not_ported("tangent ConvTransR", "A6")
