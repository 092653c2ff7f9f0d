"""Hyperbolic decoders: RotH and RotH-Rel, and the tangent ConvTransE / R.

Counterpart of ``regcn_tpu/hyperbolic/decoders.py`` for the decoders of
the two hyperbolic configurations this package runs:

- RotH / RotH-Rel (config 3): scores come from the Möbius-difference
  distance of a query to every candidate, from one [B,d]x[d,N] product
  (:func:`regcn_torch.ops.streaming_ce.distance_logits`). The training
  loss :func:`dist_ce_loss` is kernel B2 on a CUDA tensor and its plain
  version on a CPU tensor (:func:`regcn_torch.ops.streaming_ce.streaming_nll`).
- the tangent ConvTransE / ConvTransR of the headline (uvrgcn): the
  Euclidean decoders' pipeline (``regcn_torch/models/decoders.py``: masked
  batch-statistics BN in training, three dropout sites) on the leaky-tanh
  tangent table, scored with one plain GEMM plus a candidate bias ``b``.

MuRP, AttH, DistMult and ComplEx are not ported yet (ROADMAP A.7): their
entry points raise.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from regcn_torch.hyperbolic import ops as H
from regcn_torch.models import decoders as euclidean_decoders
from regcn_torch.ops.activations import inverted_dropout
from regcn_torch.ops.streaming_ce import SCORE_EPS, distance_logits, streaming_nll

Params = Dict[str, torch.Tensor]
BNState = euclidean_decoders.BNState

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


# ---------------------------------------------------- tangent ConvTransE / R

def init_hyperbolic_convtranse(gen: torch.Generator, num_entities, h_dim, channels=50, kernel=3
                               ) -> Tuple[Params, BNState]:
    """The Euclidean ConvTransE's parameters and BN state, plus a bias ``b``
    over the entity candidates."""
    params, bn_state = euclidean_decoders.init_convtrans(gen, h_dim, channels, kernel)
    params["b"] = torch.zeros(num_entities)
    return params, bn_state


def init_hyperbolic_convtransr(gen: torch.Generator, num_rels_total, h_dim, channels=50,
                               kernel=3) -> Tuple[Params, BNState]:
    """As :func:`init_hyperbolic_convtranse`, ``b`` over the 2R relations."""
    params, bn_state = euclidean_decoders.init_convtrans(gen, h_dim, channels, kernel)
    params["b"] = torch.zeros(num_rels_total)
    return params, bn_state


def _leaky_tanh(x: torch.Tensor) -> torch.Tensor:
    """0.9 tanh(x) + 0.1 x, the 'leaky tanh' of the tangent decoders."""
    return 0.9 * torch.tanh(x) + 0.1 * x


def _convtrans_score(params, bn_state, stacked, candidates, mask, dropouts, gen, train):
    x, new_bn = euclidean_decoders._convtrans_features(
        params, bn_state, stacked, mask, input_dropout=dropouts[0], hidden_dropout=dropouts[1],
        feat_dropout=dropouts[2], gen=gen, train=train)
    return x @ candidates.T + params["b"], new_bn


def hyperbolic_convtranse_score(params, bn_state, entity_embedding, rel_embedding, triples, c,
                                mask=None, *, dropouts=(0.0, 0.0, 0.0), gen=None, train=False,
                                ent_tan=None) -> Tuple[torch.Tensor, BNState]:
    """(entity scores [B, N], new BN state) on tangent embeddings. ``ent_tan``,
    if given, is the leaky-tanh tangent table, shared by both decoders;
    otherwise it is derived from the ball points ``entity_embedding``.
    ``dropouts`` are (input, hidden, feat), drawn from ``gen`` in training."""
    if ent_tan is None:
        ent_tan = _leaky_tanh(H.log_map_zero(entity_embedding, c))
    stacked = torch.stack([ent_tan.index_select(0, triples[:, 0]),
                           rel_embedding.index_select(0, triples[:, 1])], dim=1)
    return _convtrans_score(params, bn_state, stacked, ent_tan, mask, dropouts, gen, train)


def hyperbolic_convtransr_score(params, bn_state, entity_embedding, rel_embedding, triples, c,
                                mask=None, *, dropouts=(0.0, 0.0, 0.0), gen=None, train=False,
                                ent_tan=None) -> Tuple[torch.Tensor, BNState]:
    """(relation scores [B, 2R], new BN state); the candidates are the
    evolved relation embeddings."""
    if ent_tan is None:
        ent_tan = _leaky_tanh(H.log_map_zero(entity_embedding, c))
    stacked = torch.stack([ent_tan.index_select(0, triples[:, 0]),
                           ent_tan.index_select(0, triples[:, 2])], dim=1)
    return _convtrans_score(params, bn_state, stacked, rel_embedding, mask, dropouts, gen, train)


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
    s_tan = inverted_dropout(H.log_map_zero(s_emb, c), dropout, gen, train)
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
    s_tan = inverted_dropout(H.log_map_zero(entity_embedding.index_select(0, triples[:, 0]), c),
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


init_murp = murp_score = murp_loss = _not_ported("MuRP", "A.7")
init_atth = atth_score = atth_loss = _not_ported("AttH", "A.7")
distmult_score = _not_ported("DistMult", "A.7")
complex_score = _not_ported("ComplEx", "A.7")
