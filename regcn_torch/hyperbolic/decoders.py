"""Hyperbolic decoders: MuRP, RotH and AttH (each with its relation
variant), the tangent ConvTransE / R, DistMult and ComplEx.

Counterpart of ``regcn_tpu/hyperbolic/decoders.py``:

- the distance decoders MuRP / MuRP-Rel, RotH / RotH-Rel (config 3) and
  AttH / AttH-Rel (config 4): each builds a query on the ball and scores it
  by the Möbius-difference distance to every candidate, from one
  [B,d]x[d,N] product (:func:`regcn_torch.ops.streaming_ce.distance_logits`).
  The training loss :func:`dist_ce_loss` is kernel B2 on a CUDA tensor and
  its plain version on a CPU tensor
  (:func:`regcn_torch.ops.streaming_ce.streaming_nll`). The entity
  decoders score on the true distance under a per-relation curvature when
  they learn one (``rel_curvature_raw``), else on the proxy distance;
- the tangent ConvTransE / ConvTransR of the headline (uvrgcn): the
  Euclidean decoders' pipeline (``regcn_torch/models/decoders.py``: masked
  batch-statistics BN in training, three dropout sites) on the leaky-tanh
  tangent table, scored with one plain GEMM plus a candidate bias ``b``;
- DistMult and ComplEx: tangent scores, one plain GEMM each. The JAX
  model calls neither; they are here because the JAX package has them.

Every score product has an fp32 result in every compute dtype
(``dot_f32``), and the distance losses cast their inputs to fp32 at B2's
boundary, as JAX's ``streaming_nll`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from regcn_torch.hyperbolic import ops as H
from regcn_torch.models import decoders as euclidean_decoders
from regcn_torch.ops.activations import inverted_dropout
from regcn_torch.ops.streaming_ce import SCORE_EPS, distance_logits, streaming_nll
from regcn_torch.parallel.collectives import rows_of
from regcn_torch.utils.dtypes import dot_f32, mm
from regcn_torch.utils.init import xavier_uniform

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

def _pairwise(x: torch.Tensor, angles: torch.Tensor, reflect: bool) -> torch.Tensor:
    if angles.dim() == 1:
        angles = angles[None, :].expand(x.shape[0], -1)
    x1, x2 = x[:, 0::2], x[:, 1::2]
    ca, sa = torch.cos(angles), torch.sin(angles)
    if reflect:
        out = (ca * x1 + sa * x2, sa * x1 - ca * x2)
    else:
        out = (ca * x1 - sa * x2, sa * x1 + ca * x2)
    return torch.stack(out, dim=2).reshape(x.shape)


def givens_rotation(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Pairwise 2-D rotations. x [B,d], angles [B,d/2] or [d/2]."""
    return _pairwise(x, angles, reflect=False)


def givens_reflection(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Pairwise 2-D reflections: o1 = cos x1 + sin x2, o2 = sin x1 - cos x2."""
    return _pairwise(x, angles, reflect=True)


def _uniform(gen, shape, bound):
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


# ---------------------------------------------- distance decoders' common parts

def _score_scale(params):
    return torch.nn.functional.softplus(params["score_scale_raw"]) + SCORE_EPS


def _relation_curvature(params, r_idx, c, warmup_max=None):
    if "rel_curvature_raw" not in params:
        return None
    n = params["rel_curvature_raw"].shape[0]
    raw = torch.nn.functional.softplus(params["rel_curvature_raw"][torch.remainder(r_idx, n)])
    return clamp_relation_curvature(raw, c, warmup_max)


def _entity_extras(p: Params, num_entities, num_rels_total, c_init, use_entity_bias,
                   use_rel_curvature, score_scale_init, score_margin_init) -> Params:
    """The entity decoders' score scale and margin, then, as configured, the
    candidate bias and the per-relation curvature (softplus-parametrised,
    starting at 0.95 c)."""
    p["score_scale_raw"] = torch.tensor(float(score_scale_init))
    p["score_margin"] = torch.tensor(float(score_margin_init))
    if use_entity_bias:
        p["entity_bias"] = torch.zeros(num_entities)
    if use_rel_curvature:
        theta = softplus_inverse(max(c_init * REL_C_INIT_RATIO, REL_C_EPS))
        p["rel_curvature_raw"] = torch.full((num_rels_total,), theta)
    return p


def _distance_args(params, triples, c, rel_curvature_max, use_hyperbolic_distance=None):
    """The entity decoders' scoring arguments: the candidate bias, scale,
    margin and the query's relation curvature, on the true distance when
    the curvature is learned (unless ``use_hyperbolic_distance`` says)."""
    if use_hyperbolic_distance is None:
        use_hyperbolic_distance = "rel_curvature_raw" in params
    return dict(candidate_bias=params.get("entity_bias"), score_scale=_score_scale(params),
                score_margin=params["score_margin"],
                query_curvature=_relation_curvature(params, triples[:, 1], c, rel_curvature_max),
                use_hyperbolic_distance=use_hyperbolic_distance)


def _entity_scores(params, query, entity_embedding, triples, c, rel_curvature_max,
                   use_hyperbolic_distance=None, columns: Optional[slice] = None):
    """[B, N] scores of ``query`` against every entity, or against the
    entities of ``columns`` (a rank's candidates on a mesh, [B, rows]);
    with an entity bias, the subject's bias is added to its whole row, as
    JAX's eval does."""
    args = _distance_args(params, triples, c, rel_curvature_max, use_hyperbolic_distance)
    if columns is not None:
        entity_embedding = entity_embedding[columns]
        if args["candidate_bias"] is not None:
            args["candidate_bias"] = args["candidate_bias"][columns]
    scores = dist_score(query, entity_embedding, c, **args)
    if "entity_bias" in params:
        scores = scores + params["entity_bias"][triples[:, 0]][:, None]
    return scores


def _entity_loss(params, query, entity_embedding, triples, c, mask, rel_curvature_max):
    """The entity CE over every candidate; the subject's row-constant bias
    cancels in it."""
    return dist_ce_loss(query, entity_embedding, triples[:, 2], c, mask=mask,
                        **_distance_args(params, triples, c, rel_curvature_max))


def _relation_args(params):
    """The relation decoders' bias over the 2R relations, and their scale
    and margin where they have them (MuRP-Rel has neither)."""
    return dict(candidate_bias=params["rel_bias"],
                score_scale=_score_scale(params) if "score_scale_raw" in params else None,
                score_margin=params.get("score_margin", 0.0))


def _relation_scores(params, query, rel_embedding, c):
    return dist_score(query, H.exp_map_zero(rel_embedding, c), c, **_relation_args(params))


def _relation_loss(params, query, rel_embedding, triples, c, mask):
    return dist_ce_loss(query, H.exp_map_zero(rel_embedding, c), triples[:, 1], c, mask=mask,
                        **_relation_args(params))


def _translate(params, rel, mixed, c):
    """mobius_add(mixed, exp_0(rel @ trans_w.T + trans_b)), both projected
    to the ball: the entity decoders' relation translation."""
    t_r = H.exp_map_zero(mm(rel, params["trans_w"].T) + params["trans_b"], c)
    return H.mobius_add(H.project_to_ball(mixed, c), H.project_to_ball(t_r, c), c)


def _subject_tangent(entity_embedding, triples, c, dropout, gen, train):
    """log_0 of the projected subjects, with the input dropout."""
    s_emb = H.project_to_ball(entity_embedding.index_select(0, triples[:, 0]), c)
    return inverted_dropout(H.log_map_zero(s_emb, c), dropout, gen, train)


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


def _convtrans_score(params, bn_state, stacked, candidates, bias, mask, dropouts, gen, train):
    x, new_bn = euclidean_decoders._convtrans_features(
        params, bn_state, stacked, mask, input_dropout=dropouts[0], hidden_dropout=dropouts[1],
        feat_dropout=dropouts[2], gen=gen, train=train)
    return dot_f32(x, candidates.T) + bias, new_bn


def hyperbolic_convtranse_score(params, bn_state, entity_embedding, rel_embedding, triples, c,
                                mask=None, *, dropouts=(0.0, 0.0, 0.0), gen=None, train=False,
                                ent_tan=None, shard=None) -> Tuple[torch.Tensor, BNState]:
    """(entity scores [B, N], new BN state) on tangent embeddings. ``ent_tan``,
    if given, is the leaky-tanh tangent table, shared by both decoders;
    otherwise it is derived from the ball points ``entity_embedding``.
    ``dropouts`` are (input, hidden, feat), drawn from ``gen`` in training.
    With ``shard`` the tables hold this rank's rows: the subjects' rows are
    gathered from their owners and the scores are the rank's candidates',
    [B, rows], with their slice of the bias ``b``."""
    if ent_tan is None:
        ent_tan = _leaky_tanh(H.log_map_zero(entity_embedding, c))
    stacked = torch.stack([rows_of(ent_tan, triples[:, 0], shard),
                           rel_embedding.index_select(0, triples[:, 1])], dim=1)
    bias = params["b"] if shard is None else params["b"][shard.row0:shard.row0 + shard.rows]
    return _convtrans_score(params, bn_state, stacked, ent_tan, bias, mask, dropouts, gen, train)


def hyperbolic_convtransr_score(params, bn_state, entity_embedding, rel_embedding, triples, c,
                                mask=None, *, dropouts=(0.0, 0.0, 0.0), gen=None, train=False,
                                ent_tan=None, shard=None) -> Tuple[torch.Tensor, BNState]:
    """(relation scores [B, 2R], new BN state); the candidates are the
    evolved relation embeddings. With ``shard`` the subjects' and objects'
    rows are gathered from their owners; the scores are replicated."""
    if ent_tan is None:
        ent_tan = _leaky_tanh(H.log_map_zero(entity_embedding, c))
    stacked = torch.stack([rows_of(ent_tan, triples[:, 0], shard),
                           rows_of(ent_tan, triples[:, 2], shard)], dim=1)
    return _convtrans_score(params, bn_state, stacked, rel_embedding, params["b"], mask,
                            dropouts, gen, train)


# ----------------------------------------------------------------- MuRP

def init_murp(gen: torch.Generator, num_entities, num_rels_total, h_dim, c_init=0.01,
              init_scale=1e-3, use_entity_bias=False, use_rel_curvature=False,
              score_scale_init=1.0, score_margin_init=1.0) -> Params:
    p: Params = {
        "rot_w": _uniform(gen, (h_dim, h_dim), init_scale),
        "rot_b": torch.zeros(h_dim),
        "trans_w": _uniform(gen, (h_dim, h_dim), init_scale),
        "trans_b": torch.zeros(h_dim),
    }
    return _entity_extras(p, num_entities, num_rels_total, c_init, use_entity_bias,
                          use_rel_curvature, score_scale_init, score_margin_init)


def _murp_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train):
    """Diagonal scaling of the subject's tangent, then the translation."""
    rel = rel_embedding.index_select(0, triples[:, 1])
    rot = mm(rel, params["rot_w"].T) + params["rot_b"]
    s_tan = _subject_tangent(entity_embedding, triples, c, dropout, gen, train)
    return _translate(params, rel, H.exp_map_zero(rot * s_tan, c), c)


def murp_score(params, entity_embedding, rel_embedding, triples, c, *, dropout=0.0, gen=None,
               train=False, rel_curvature_max=None, use_hyperbolic_distance=None, columns=None):
    query = _murp_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train)
    return _entity_scores(params, query, entity_embedding, triples, c, rel_curvature_max,
                          use_hyperbolic_distance, columns)


def murp_loss(params, entity_embedding, rel_embedding, triples, c, *, mask=None, dropout=0.0,
              gen=None, train=True, rel_curvature_max=None):
    query = _murp_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train)
    return _entity_loss(params, query, entity_embedding, triples, c, mask, rel_curvature_max)


def init_murp_rel(gen: torch.Generator, num_rels_base, h_dim) -> Params:
    return {
        "w_s": xavier_uniform(gen, (h_dim, h_dim)),
        "w_o": xavier_uniform(gen, (h_dim, h_dim)),
        "rel_bias": torch.zeros(num_rels_base * 2),
    }


def _murp_rel_query(params, entity_embedding, triples, c, dropout, gen, train):
    """exp_0(s_tan @ w_s + o_tan @ w_o); the dropouts drawn s first, then o."""
    s_tan = H.log_map_zero(entity_embedding.index_select(0, triples[:, 0]), c)
    o_tan = H.log_map_zero(entity_embedding.index_select(0, triples[:, 2]), c)
    s_tan = inverted_dropout(s_tan, dropout, gen, train)
    o_tan = inverted_dropout(o_tan, dropout, gen, train)
    return H.exp_map_zero(mm(s_tan, params["w_s"]) + mm(o_tan, params["w_o"]), c)


def murp_rel_score(params, entity_embedding, rel_embedding, triples, c, *, dropout=0.0,
                   gen=None, train=False):
    query = _murp_rel_query(params, entity_embedding, triples, c, dropout, gen, train)
    return _relation_scores(params, query, rel_embedding, c)


def murp_rel_loss(params, entity_embedding, rel_embedding, triples, c, *, mask=None,
                  dropout=0.0, gen=None, train=True):
    query = _murp_rel_query(params, entity_embedding, triples, c, dropout, gen, train)
    return _relation_loss(params, query, rel_embedding, triples, c, mask)


# ----------------------------------------------------------------- RotH

def _check_even(h_dim):
    if h_dim % 2:
        raise ValueError(f"h_dim must be even for the Givens pairs; got {h_dim}")


def init_roth(gen: torch.Generator, num_entities, num_rels_total, h_dim, c_init=0.01,
              init_scale=1e-3, use_entity_bias=False, use_rel_curvature=False,
              score_scale_init=1.0, score_margin_init=1.0) -> Params:
    _check_even(h_dim)
    p: Params = {
        "rot_w": _uniform(gen, (h_dim // 2, h_dim), init_scale),
        "rot_b": torch.zeros(h_dim // 2),
        "trans_w": _uniform(gen, (h_dim, h_dim), init_scale),
        "trans_b": torch.zeros(h_dim),
        "reshape_w1": _uniform(gen, (h_dim, h_dim), init_scale),
        "reshape_b1": torch.zeros(h_dim),
        "reshape_w2": _uniform(gen, (h_dim, h_dim), init_scale),
        "reshape_b2": torch.zeros(h_dim),
    }
    return _entity_extras(p, num_entities, num_rels_total, c_init, use_entity_bias,
                          use_rel_curvature, score_scale_init, score_margin_init)


def _reshape_tangent(params, x):
    """Residual tangent MLP before the Givens pairing."""
    hidden = torch.relu(mm(x, params["reshape_w1"].T) + params["reshape_b1"])
    return x + mm(hidden, params["reshape_w2"].T) + params["reshape_b2"]


def _roth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train):
    rel = rel_embedding.index_select(0, triples[:, 1])
    s_tan = _reshape_tangent(params, _subject_tangent(entity_embedding, triples, c, dropout, gen,
                                                      train))
    angles = mm(rel, params["rot_w"].T) + params["rot_b"]
    return _translate(params, rel, H.exp_map_zero(givens_rotation(s_tan, angles), c), c)


def roth_score(params, entity_embedding, rel_embedding, triples, c, *, dropout=0.0, gen=None,
               train=False, rel_curvature_max=None, columns=None):
    query = _roth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train)
    return _entity_scores(params, query, entity_embedding, triples, c, rel_curvature_max,
                          columns=columns)


def roth_loss(params, entity_embedding, rel_embedding, triples, c, *, mask=None, dropout=0.0,
              gen=None, train=True, rel_curvature_max=None):
    query = _roth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train)
    return _entity_loss(params, query, entity_embedding, triples, c, mask, rel_curvature_max)


def _relation_extras(p: Params, num_rels_base, score_scale_init, score_margin_init) -> Params:
    p["rel_bias"] = torch.zeros(num_rels_base * 2)
    p["score_scale_raw"] = torch.tensor(float(score_scale_init))
    p["score_margin"] = torch.tensor(float(score_margin_init))
    return p


def init_roth_rel(gen: torch.Generator, num_rels_base, h_dim, init_scale=1e-3,
                  score_scale_init=1.0, score_margin_init=1.0) -> Params:
    _check_even(h_dim)
    p: Params = {
        "global_rot": _uniform(gen, (h_dim // 2,), math.pi),
        "reshape_w1": _uniform(gen, (h_dim, h_dim), init_scale),
        "reshape_b1": torch.zeros(h_dim),
        "reshape_w2": _uniform(gen, (h_dim, h_dim), init_scale),
        "reshape_b2": torch.zeros(h_dim),
    }
    return _relation_extras(p, num_rels_base, score_scale_init, score_margin_init)


def _roth_rel_query(params, entity_embedding, triples, c, dropout, gen, train):
    s_tan = inverted_dropout(H.log_map_zero(entity_embedding.index_select(0, triples[:, 0]), c),
                             dropout, gen, train)
    s_tan = _reshape_tangent(params, s_tan)
    rot_s = H.exp_map_zero(givens_rotation(s_tan, params["global_rot"]), c)
    return H.mobius_add(-rot_s, entity_embedding.index_select(0, triples[:, 2]), c)


def roth_rel_score(params, entity_embedding, rel_embedding, triples, c, *, dropout=0.0,
                   gen=None, train=False):
    query = _roth_rel_query(params, entity_embedding, triples, c, dropout, gen, train)
    return _relation_scores(params, query, rel_embedding, c)


def roth_rel_loss(params, entity_embedding, rel_embedding, triples, c, *, mask=None,
                  dropout=0.0, gen=None, train=True):
    query = _roth_rel_query(params, entity_embedding, triples, c, dropout, gen, train)
    return _relation_loss(params, query, rel_embedding, triples, c, mask)


# ----------------------------------------------------------------- AttH

def init_atth(gen: torch.Generator, num_entities, num_rels_total, h_dim, c_init=0.01,
              init_scale=1e-3, use_entity_bias=False, use_rel_curvature=False,
              score_scale_init=1.0, score_margin_init=1.0) -> Params:
    _check_even(h_dim)
    p: Params = {
        "rot_w": _uniform(gen, (h_dim // 2, h_dim), init_scale),
        "rot_b": torch.zeros(h_dim // 2),
        "ref_w": _uniform(gen, (h_dim // 2, h_dim), init_scale),
        "ref_b": torch.zeros(h_dim // 2),
        "trans_w": _uniform(gen, (h_dim, h_dim), init_scale),
        "trans_b": torch.zeros(h_dim),
        "attn_w": _uniform(gen, (2 * h_dim, h_dim), init_scale),
        "attn_b": torch.zeros(2 * h_dim),
    }
    return _entity_extras(p, num_entities, num_rels_total, c_init, use_entity_bias,
                          use_rel_curvature, score_scale_init, score_margin_init)


def _attention_mix(rot_s, ref_s, a, c):
    """exp_0 of the attention-weighted rotation and reflection."""
    return H.exp_map_zero(a * rot_s + (1.0 - a) * ref_s, c)


def _atth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train):
    """The subject's rotation and reflection by its relation, mixed by
    sigmoid(<attn_w_r, [s_tan, rel_r]>), then the translation."""
    rel = rel_embedding.index_select(0, triples[:, 1])
    s_tan = _subject_tangent(entity_embedding, triples, c, dropout, gen, train)
    rot_s = givens_rotation(s_tan, mm(rel, params["rot_w"].T) + params["rot_b"])
    ref_s = givens_reflection(s_tan, mm(rel, params["ref_w"].T) + params["ref_b"])
    attn_w = mm(rel, params["attn_w"].T) + params["attn_b"]
    a = torch.sigmoid(torch.sum(attn_w * torch.cat([s_tan, rel], dim=-1), dim=-1, keepdim=True))
    return _translate(params, rel, _attention_mix(rot_s, ref_s, a, c), c)


def atth_score(params, entity_embedding, rel_embedding, triples, c, *, dropout=0.0, gen=None,
               train=False, rel_curvature_max=None, columns=None):
    query = _atth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train)
    return _entity_scores(params, query, entity_embedding, triples, c, rel_curvature_max,
                          columns=columns)


def atth_loss(params, entity_embedding, rel_embedding, triples, c, *, mask=None, dropout=0.0,
              gen=None, train=True, rel_curvature_max=None):
    query = _atth_query(params, entity_embedding, rel_embedding, triples, c, dropout, gen, train)
    return _entity_loss(params, query, entity_embedding, triples, c, mask, rel_curvature_max)


def init_atth_rel(gen: torch.Generator, num_rels_base, h_dim, init_scale=1e-3,
                  score_scale_init=1.0, score_margin_init=1.0) -> Params:
    _check_even(h_dim)
    p: Params = {
        "global_rot": _uniform(gen, (h_dim // 2,), math.pi),
        "global_ref": _uniform(gen, (h_dim // 2,), math.pi),
        "attn_weight": _uniform(gen, (2 * h_dim,), init_scale),
    }
    return _relation_extras(p, num_rels_base, score_scale_init, score_margin_init)


def _atth_rel_query(params, entity_embedding, triples, c, dropout, gen, train):
    """The subject's global rotation and reflection, mixed by
    sigmoid(<attn_weight, [s_tan, o_tan]>), Möbius-subtracted from the
    object."""
    obj = entity_embedding.index_select(0, triples[:, 2])
    s_tan = H.log_map_zero(entity_embedding.index_select(0, triples[:, 0]), c)
    o_tan = H.log_map_zero(obj, c)
    s_tan = inverted_dropout(s_tan, dropout, gen, train)
    rot_s = givens_rotation(s_tan, params["global_rot"])
    ref_s = givens_reflection(s_tan, params["global_ref"])
    a = torch.sigmoid(mm(torch.cat([s_tan, o_tan], dim=-1), params["attn_weight"]))[:, None]
    return H.mobius_add(-_attention_mix(rot_s, ref_s, a, c), obj, c)


def atth_rel_score(params, entity_embedding, rel_embedding, triples, c, *, dropout=0.0,
                   gen=None, train=False):
    query = _atth_rel_query(params, entity_embedding, triples, c, dropout, gen, train)
    return _relation_scores(params, query, rel_embedding, c)


def atth_rel_loss(params, entity_embedding, rel_embedding, triples, c, *, mask=None,
                  dropout=0.0, gen=None, train=True):
    query = _atth_rel_query(params, entity_embedding, triples, c, dropout, gen, train)
    return _relation_loss(params, query, rel_embedding, triples, c, mask)


# ------------------------------------------------ DistMult / ComplEx (tangent)

def distmult_score(entity_embedding, rel_embedding, triples, c, *, dropout=0.0, gen=None,
                   train=False):
    """[B, N] bilinear tangent scores <s ⊙ r, e> against every entity."""
    ent_tan = inverted_dropout(H.log_map_zero(entity_embedding, c), dropout, gen, train)
    s = ent_tan.index_select(0, triples[:, 0])
    return dot_f32(s * rel_embedding.index_select(0, triples[:, 1]), ent_tan.T)


def complex_score(entity_embedding, rel_embedding, triples, c, *, dropout=0.0, gen=None,
                  train=False):
    """[B, N] ComplEx scores Re<s ⊙ r, conj(e)> with the tangent's halves as
    real and imaginary parts: [Re(s r), Im(s r)] against [e_re, e_im], which
    is the tangent table itself."""
    ent_tan = inverted_dropout(H.log_map_zero(entity_embedding, c), dropout, gen, train)
    half = ent_tan.shape[-1] // 2
    s = ent_tan.index_select(0, triples[:, 0])
    r = rel_embedding.index_select(0, triples[:, 1])
    s_re, s_im, r_re, r_im = s[:, :half], s[:, half:], r[:, :half], r[:, half:]
    sr = torch.cat([s_re * r_re - s_im * r_im, s_re * r_im + s_im * r_re], dim=-1)
    return dot_f32(sr, ent_tan.T)
