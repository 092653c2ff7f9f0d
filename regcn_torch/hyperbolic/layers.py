"""Hyperbolic GNN encoder layers: all four encoders of the JAX package.

Counterpart of ``regcn_tpu/hyperbolic/layers.py``:

- ``lgcn``: a block-decomposed tangent transform per relation, messages
  mapped to the hyperboloid and aggregated per destination as weighted
  Lorentz centroids, a dual self-loop, an optional gated skip, ±10
  tangent clamps and the fixed-slope rrelu;
- ``hyperbolic_uvrgcn``: the UnionRGCN message ``(v_src + rel) @ W``
  weighted by ``exp(-γ|r_src - r_dst|)`` of the points' radii and summed
  per destination by kernel B1 (``regcn_torch/ops/rgcn_scatter.py``), the
  same self-loop, skip, clamps and rrelu; on ball points
  (:func:`hyperbolic_union_layer`, which ``evolve(tangent_fast=False)``
  reaches through :func:`encoder_cell`) or on the tangent carry
  (:func:`union_layer_tangent`, :func:`uvrgcn_cell_tangent`);
- ``fhnn``: a per-relation matvec on the source's tangent vector (plus
  the relation embedding), mapped to the ball and aggregated per
  destination as the Einstein midpoint of the in-degree weights, a
  Möbius self-loop, the rrelu and dropout in tangent space;
- ``hgat``: per head, the per-relation matvec message, attention logits
  ``leaky_relu(<attn_vec[rel], log_0(h_src ⊕ -h_dst)>, 0.2)``, the
  segment softmax over each destination's edges and the Einstein midpoint
  of the messages under it; the heads averaged in tangent space, the
  Möbius self-loop, an optional gated skip, rrelu and dropout.

The per-relation matvec of fhnn and hgat is JAX's ``take`` lowering: the
relation weights gathered per edge ([E, d, d], or [E, heads, d, d] for
hgat), then a batched product. The parameter dictionaries have the JAX
package's keys and layouts.

On an entity-sharded mesh (``impl`` a marker of ``regcn_torch/dist.py``)
each layer takes and returns this rank's rows, as JAX's layers dispatch
(``regcn_tpu/hyperbolic/layers.py``): the uvrgcn's radius-weighted sum
runs on B1 over the rank's edges, with the per-row radii of the gathered
table or halo buffer (``parallel/halo.py:mesh_rgcn_aggregate``); LGCN's
Lorentz centroid, FHNN's Einstein midpoint and HGAT's segment softmax
reduce over destination segments, so they run shard-local on the
exchanged source rows (``mesh_local_aggregate``). Each dropout draws the
whole table's mask and keeps the rank's rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from regcn_torch.hyperbolic import ops as H
from regcn_torch.models.layers import init_union_rgcn_layer
from regcn_torch.ops.activations import inverted_dropout, leaky_relu, rrelu
from regcn_torch.dist import is_sharded
from regcn_torch.ops.rgcn_scatter import check_impl, rgcn_aggregate
from regcn_torch.ops.segment import segment_softmax
from regcn_torch.parallel.halo import (mesh_edges, mesh_local_aggregate, mesh_rgcn_aggregate,
                                       table_rows)
from regcn_torch.utils.dtypes import mm, promoted
from regcn_torch.utils.init import RELU_GAIN, _uniform, xavier_uniform

Params = Dict[str, torch.Tensor]

CLAMP = 10.0  # tangent clamp
ENCODERS = ("hyperbolic_uvrgcn", "fhnn", "lgcn", "hgat")


def _dual_self_loop(params, h_tan, has_in_edge):
    """``loop_w`` for nodes with incoming edges, ``evolve_loop_w`` else."""
    return torch.where(has_in_edge[:, None] > 0, mm(h_tan, params["loop_w"]),
                       mm(h_tan, params["evolve_loop_w"]))


def init_lgcn_layer(gen: torch.Generator, h_dim, num_rels, n_bases=-1, self_loop=True,
                    skip_connect=False) -> Params:
    nb = num_rels if n_bases <= 0 else min(n_bases, num_rels)
    if h_dim % nb:
        raise ValueError(f"h_dim {h_dim} must be divisible by n_bases {nb}")
    sub = h_dim // nb
    p = {"weight": xavier_uniform(gen, (num_rels, nb * sub * sub), gain=RELU_GAIN)}
    if self_loop:
        p["loop_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
        p["evolve_loop_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
    if skip_connect:
        p["skip_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
        p["skip_b"] = torch.zeros(h_dim)
    return p


def _local_or_mesh(impl, snap, table: torch.Tensor, local_fn):
    """(``local_fn`` over this rank's destination rows or, off a mesh, over
    every row, the edges whose ``has_in_edge`` the self-loop reads)."""
    if is_sharded(impl):
        edges = mesh_edges(impl, snap)
        return mesh_local_aggregate(impl, table, edges, local_fn), edges
    return local_fn(table, snap.src, snap.dst, snap.edge_mask, snap.rel, snap.in_deg_norm,
                    snap.has_in_edge, table.shape[0]), snap


def lgcn_layer(params: Params, h_hyper: torch.Tensor, rel_emb: Optional[torch.Tensor], snap, c,
               n_bases: int, *, prev_h=None, dropout: float = 0.0,
               gen: Optional[torch.Generator] = None, train: bool = False,
               impl: str = "xla") -> torch.Tensor:
    """One LGCN layer on ball points [N, d] (this rank's rows on a mesh);
    returns ball points."""
    d = h_hyper.shape[1]
    nb, sub = n_bases, d // n_bases
    h_tan = H.log_map_zero(h_hyper, c)

    def local_fn(tan, src, dst, mask, rel, norm, has_in, rows):
        # per-edge block-diagonal transform: nb blocks of [sub, sub]. Gathers
        # are index_select: its backward is one index_add_, where indexing's
        # sorts its indices first
        w_e = params["weight"].index_select(0, rel).reshape(-1, nb, sub, sub)
        src_feat = tan.index_select(0, src).reshape(-1, nb, sub, 1)
        msg_tan = torch.sum(src_feat * w_e, dim=2).reshape(-1, d)
        if rel_emb is not None:
            msg_tan = msg_tan + rel_emb.index_select(0, rel)
        msg_lorentz = H.to_lorentz(H.exp_map_zero(msg_tan, c), c)
        agg = H.lorentz_centroid_segments(msg_lorentz, norm[dst] * mask, dst, rows, c)
        return torch.clamp(H.log_map_zero(H.to_poincare(agg, c), c), -CLAMP, CLAMP)

    # the messages read the sources' tangent rows, which travel between ranks
    h_new, edges = _local_or_mesh(impl, snap, h_tan, local_fn)

    if "loop_w" in params:
        loop = _dual_self_loop(params, h_tan, edges.has_in_edge)
    if prev_h is not None and "skip_w" in params:
        prev_tan = H.log_map_zero(prev_h, c)
        gate = torch.sigmoid(mm(prev_tan, params["skip_w"]) + params["skip_b"])
        if "loop_w" in params:
            h_new = h_new + loop
        h_new = gate * h_new + (1 - gate) * prev_tan
    elif "loop_w" in params:
        h_new = h_new + loop

    h_new = torch.clamp(h_new, -CLAMP, CLAMP)
    # the eval-mode rrelu even while training: the reference calls
    # F.rrelu with its default training=False
    h_new = rrelu(h_new)
    h_new = inverted_dropout(h_new, dropout, gen, train, rows=table_rows(impl, h_hyper))
    return H.exp_map_zero(h_new, c).to(h_hyper.dtype)


def fhnn_edge_transform(rel_weight: torch.Tensor, tan_src: torch.Tensor, rel: torch.Tensor
                        ) -> torch.Tensor:
    """``msg[e] = tan_src[e] @ rel_weight[rel[e]]`` (ref:hyperbolic_layers.py:436-466),
    JAX's ``take`` lowering: the [E, d, d] weights gathered per edge, then
    one batched matvec. (JAX picks a one-hot GEMM instead on a TPU only.)"""
    w_e = rel_weight.index_select(0, rel)
    return torch.bmm(*promoted(tan_src[:, None, :], w_e))[:, 0, :]


def init_fhnn_layer(gen: torch.Generator, h_dim, num_rels, self_loop=True) -> Params:
    """``rel_weight`` [R, d, d]: xavier-uniform on its view(-1, d), fans
    (R * d, d) (ref :361-362); ``loop_w`` xavier-uniform, gain 1."""
    p = {"rel_weight": _uniform(gen, (num_rels, h_dim, h_dim),
                                (6.0 / (num_rels * h_dim + h_dim)) ** 0.5)}
    if self_loop:
        p["loop_w"] = xavier_uniform(gen, (h_dim, h_dim))
    return p


def _tangent_activation(h_new: torch.Tensor, c, dropout: float, gen, train, rows=None
                        ) -> torch.Tensor:
    """The rrelu in tangent space, then dropout in tangent space
    (ref :466-475), each between log_0 and exp_0; ``rows`` as
    ``inverted_dropout`` takes it on a mesh."""
    h_new = H.exp_map_zero(rrelu(H.log_map_zero(h_new, c)), c)
    if train and dropout > 0 and gen is not None:
        h_new = H.exp_map_zero(inverted_dropout(H.log_map_zero(h_new, c), dropout, gen, train,
                                                rows=rows), c)
    return h_new


def fhnn_layer(params: Params, h_hyper: torch.Tensor, rel_emb: Optional[torch.Tensor], snap, c,
               *, prev_h=None, dropout: float = 0.0, gen: Optional[torch.Generator] = None,
               train: bool = False, impl: str = "xla") -> torch.Tensor:
    """One FHNN layer on ball points [N, d] (this rank's rows on a mesh);
    returns ball points. ``prev_h`` is ignored, as in the reference
    (ref :444)."""
    h_tan = H.log_map_zero(h_hyper, c)

    def local_fn(tan, src, dst, mask, rel, norm, has_in, rows):
        msg_tan = fhnn_edge_transform(params["rel_weight"], tan.index_select(0, src), rel)
        if rel_emb is not None:
            msg_tan = msg_tan + rel_emb.index_select(0, rel)
        return H.einstein_midpoint_segments(H.exp_map_zero(msg_tan, c), norm[dst] * mask, dst,
                                            rows, c)

    h_new, _ = _local_or_mesh(impl, snap, h_tan, local_fn)
    if "loop_w" in params:
        h_new = H.mobius_add(h_new, H.exp_map_zero(mm(h_tan, params["loop_w"]), c), c)
    return _tangent_activation(h_new, c, dropout, gen, train,
                               table_rows(impl, h_hyper)).to(h_hyper.dtype)


def init_hgat_layer(gen: torch.Generator, h_dim, num_rels, num_heads=4, self_loop=True,
                    skip_connect=False) -> Params:
    """``rel_weight`` [R, heads, d, d] and ``attn_vec`` [R, heads, d]
    (head_dim = d: the reference cell averages its heads, ref :948)."""
    p = {
        "rel_weight": _uniform(gen, (num_rels, num_heads, h_dim, h_dim),
                               (6.0 / (num_rels * num_heads * h_dim + h_dim)) ** 0.5),
        "attn_vec": _uniform(gen, (num_rels, num_heads, h_dim),
                             (6.0 / (num_rels * num_heads + h_dim)) ** 0.5),
    }
    if self_loop:
        p["loop_w"] = xavier_uniform(gen, (h_dim, h_dim))
    if skip_connect:
        p["skip_w"] = xavier_uniform(gen, (h_dim, h_dim))
        p["skip_b"] = torch.zeros(h_dim)
    return p


def hgat_layer(params: Params, h_hyper: torch.Tensor, rel_emb: Optional[torch.Tensor], snap, c,
               *, prev_h: Optional[torch.Tensor] = None, dropout: float = 0.0,
               gen: Optional[torch.Generator] = None, train: bool = False,
               impl: str = "xla") -> torch.Tensor:
    """One HGAT layer on ball points [N, d] (this rank's rows on a mesh);
    returns ball points. ``rel_emb`` takes no part in the attention
    (ref :882). JAX maps a function over the heads; here every head runs
    in one batched product, one segment softmax and one Einstein midpoint
    over [E, heads, ...]. The attention reads the ball points of both ends
    and the messages the sources' tangent rows: on a mesh both travel,
    side by side in one [rows, 2d] table."""
    d = h_hyper.shape[1]
    h_tan = H.log_map_zero(h_hyper, c)

    def aggregate(ball, tan, src, dst, mask, rel, rows):
        w_e = params["rel_weight"].index_select(0, rel)  # [E, heads, d, d]
        src_tan = tan.index_select(0, src)
        msgs_tan = torch.matmul(*promoted(src_tan[:, None, None, :], w_e))[:, :, 0, :]
        msgs_ball = H.exp_map_zero(msgs_tan, c)  # [E, heads, d]
        h_src, h_dst = ball.index_select(0, src), ball.index_select(0, dst)
        diff_tan = H.log_map_zero(H.mobius_add(h_src, -h_dst, c), c)
        av = params["attn_vec"].index_select(0, rel)  # [E, heads, d]
        scores = leaky_relu(torch.sum(av * diff_tan[:, None, :], dim=-1), 0.2)  # [E, heads]
        alpha = segment_softmax(scores, dst, mask, rows)
        agg = H.einstein_midpoint_segments(msgs_ball, alpha * mask[:, None], dst, rows,
                                           c)  # [rows, heads, d]
        return H.exp_map_zero(torch.mean(H.log_map_zero(agg, c), dim=1), c)

    if is_sharded(impl):
        h_new = mesh_local_aggregate(
            impl, torch.cat([h_hyper, h_tan.to(h_hyper.dtype)], dim=1), mesh_edges(impl, snap),
            lambda both, src, dst, mask, rel, norm, has_in, rows: aggregate(
                both[:, :d], both[:, d:], src, dst, mask, rel, rows))
    else:
        h_new = aggregate(h_hyper, h_tan, snap.src, snap.dst, snap.edge_mask, snap.rel,
                          h_hyper.shape[0])
    if "loop_w" in params:
        h_new = H.mobius_add(h_new, H.exp_map_zero(mm(h_tan, params["loop_w"]), c), c)
    if prev_h is not None and "skip_w" in params:
        prev_tan = H.log_map_zero(prev_h, c)
        gate = torch.sigmoid(mm(prev_tan, params["skip_w"]) + params["skip_b"])
        h_new = H.exp_map_zero(gate * H.log_map_zero(h_new, c) + (1 - gate) * prev_tan, c)
    return _tangent_activation(h_new, c, dropout, gen, train,
                               table_rows(impl, h_hyper)).to(h_hyper.dtype)


def _abs_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| with derivative +1 where a == b, as ``jax.grad(jnp.abs)(0.)``
    is; torch's ``abs`` has 0 there. Every self-edge sits at that tie, and
    so does every edge between two entities of bitwise-equal radius."""
    d = a - b
    return torch.where(d >= 0, d, -d)


def _radius_weight(radius_gamma: float):
    """The uvrgcn's edge weight exp(-γ|r_src - r_dst|) of the two ends' radii."""
    return lambda r_src, r_dst: torch.exp(-radius_gamma * _abs_diff(r_src, r_dst))


def _union_sum(params: Params, v: torch.Tensor, rel_emb: torch.Tensor, snap, c, radius,
               radius_gamma: float, impl):
    """(the radius-weighted union sum [N, d] on B1 of the tangent rows ``v``,
    the edges whose ``has_in_edge`` the self-loop reads). ``radius`` [N] are
    the rows' radii off a mesh; on a mesh (this rank's rows) the radii come
    per row of the gathered table or halo buffer, from the tangent rows, as
    JAX's halo path takes them."""
    if is_sharded(impl):
        edges = mesh_edges(impl, snap)
        return mesh_rgcn_aggregate(impl, v, rel_emb, params["w_neighbor"], edges,
                                   row_scalar_fn=lambda rows: H.radius_from_tangent(rows, c),
                                   edge_weight_fn=_radius_weight(radius_gamma)), edges
    rw = _radius_weight(radius_gamma)(radius.index_select(0, snap.src),
                                      radius.index_select(0, snap.dst))
    return rgcn_aggregate(v, rel_emb, params["w_neighbor"], snap.src, snap.dst, snap.rel,
                          snap.edge_mask, snap.in_deg_norm, dst_sorted=snap.dst_sorted,
                          edge_weight=rw), snap


def hyperbolic_union_layer(params: Params, h_hyper: torch.Tensor, rel_emb: torch.Tensor, snap,
                           c, *, prev_h: Optional[torch.Tensor] = None,
                           radius_gamma: float = 1.0, dropout: float = 0.0,
                           gen: Optional[torch.Generator] = None, train: bool = False,
                           impl: str = "xla") -> torch.Tensor:
    """One UnionRGCN layer on ball points [N, d] (this rank's rows on a
    mesh); returns ball points. The radius weight comes from the points'
    norms (``get_radius``), and B1 sums the weighted messages, with the
    weight's gradient ``dw``."""
    h_tan = H.log_map_zero(h_hyper, c)
    radius = None if is_sharded(impl) else H.get_radius(h_hyper)
    h_new, edges = _union_sum(params, h_tan, rel_emb, snap, c, radius, radius_gamma, impl)
    h_new = torch.clamp(h_new, -CLAMP, CLAMP)

    if "loop_w" in params:
        loop = _dual_self_loop(params, h_tan, edges.has_in_edge)
    if prev_h is not None and "skip_w" in params:
        prev_tan = H.log_map_zero(prev_h, c)
        gate = torch.sigmoid(mm(prev_tan, params["skip_w"]) + params["skip_b"])
        if "loop_w" in params:
            h_new = h_new + loop
        h_new = gate * h_new + (1 - gate) * prev_tan
    elif "loop_w" in params:
        h_new = h_new + loop

    h_new = torch.clamp(h_new, -CLAMP, CLAMP)
    h_new = inverted_dropout(rrelu(h_new), dropout, gen, train, rows=table_rows(impl, h_hyper))
    return H.exp_map_zero(h_new, c).to(h_hyper.dtype)


def union_layer_tangent(params: Params, v: torch.Tensor, rel_emb: torch.Tensor, snap, c, *,
                        prev_v: Optional[torch.Tensor] = None, radius_gamma: float = 1.0,
                        dropout: float = 0.0, gen: Optional[torch.Generator] = None,
                        train: bool = False, impl: str = "xla") -> torch.Tensor:
    """One UnionRGCN layer on tangent vectors v [N, d] (``v = log_0`` of the
    ball points; this rank's rows on a mesh); returns the raw tangent
    output, which the caller clamps with :func:`H.clamp_tangent_norm`. The
    radius weight of each edge requires grad through v, so B1's backward
    computes its ``dw``."""
    radius = None if is_sharded(impl) else H.radius_from_tangent(v, c)
    h_new, edges = _union_sum(params, v, rel_emb, snap, c, radius, radius_gamma, impl)
    h_new = torch.clamp(h_new, -CLAMP, CLAMP)

    if "loop_w" in params:
        loop = _dual_self_loop(params, v, edges.has_in_edge)
    if prev_v is not None and "skip_w" in params:
        gate = torch.sigmoid(mm(prev_v, params["skip_w"]) + params["skip_b"])
        if "loop_w" in params:
            h_new = h_new + loop
        h_new = gate * h_new + (1 - gate) * prev_v
    elif "loop_w" in params:
        h_new = h_new + loop

    h_new = torch.clamp(h_new, -CLAMP, CLAMP)
    return inverted_dropout(rrelu(h_new), dropout, gen, train, rows=table_rows(impl, v))


def uvrgcn_cell_tangent(params, v: torch.Tensor, rel_emb: torch.Tensor, snap, c, *,
                        radius_gamma: float = 1.0, dropout: float = 0.0,
                        gen: Optional[torch.Generator] = None, train: bool = False,
                        impl: str = "xla") -> torch.Tensor:
    """The uvrgcn layer stack on the tangent carry; between layers (and
    after the last) the norm clamp that stands for the ball path's
    exp_0 -> project -> log_0."""
    x, prev = v, None
    for i, lp in enumerate(params["layers"]):
        new_x = union_layer_tangent(lp, x, rel_emb, snap, c, prev_v=prev if i > 0 else None,
                                    radius_gamma=radius_gamma, dropout=dropout, gen=gen,
                                    train=train, impl=impl)
        prev, x = x, H.clamp_tangent_norm(new_x, c)
    return x


def _check_encoder(encoder: str) -> None:
    if encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {encoder!r}; known: {ENCODERS}")


def init_encoder_cell(gen: torch.Generator, encoder: str, h_dim: int, num_rels_total: int,
                      n_layers: int, n_bases: int = -1, num_heads: int = 4,
                      self_loop: bool = True, skip_connect: bool = False) -> Dict[str, list]:
    _check_encoder(encoder)
    layers = []
    for i in range(n_layers):
        sc = skip_connect and i > 0
        if encoder == "hyperbolic_uvrgcn":
            layers.append(init_union_rgcn_layer(gen, h_dim, self_loop, sc))
        elif encoder == "fhnn":
            layers.append(init_fhnn_layer(gen, h_dim, num_rels_total, self_loop))
        elif encoder == "lgcn":
            layers.append(init_lgcn_layer(gen, h_dim, num_rels_total, n_bases, self_loop, sc))
        else:
            layers.append(init_hgat_layer(gen, h_dim, num_rels_total, num_heads, self_loop, sc))
    return {"layers": layers}


def encoder_cell(params, encoder: str, h_hyper: torch.Tensor, rel_emb: torch.Tensor, snap, c,
                 *, n_bases: int = -1, num_heads: int = 4, radius_gamma: float = 1.0,
                 dropout: float = 0.0, gen: Optional[torch.Generator] = None,
                 train: bool = False, impl: str = "xla") -> torch.Tensor:
    """The ball-space layer stack: ``evolve``'s path for LGCN, FHNN and
    HGAT, and for the uvrgcn with ``tangent_fast=False``; ``impl`` a
    sharded marker runs it on this rank's rows."""
    _check_encoder(encoder)
    check_impl(impl)
    x, prev = h_hyper, None
    for i, lp in enumerate(params["layers"]):
        kw = dict(prev_h=prev if i > 0 else None, dropout=dropout, gen=gen, train=train,
                  impl=impl)
        if encoder == "hyperbolic_uvrgcn":
            new_x = hyperbolic_union_layer(lp, x, rel_emb, snap, c, radius_gamma=radius_gamma,
                                           **kw)
        elif encoder == "fhnn":
            new_x = fhnn_layer(lp, x, rel_emb, snap, c, **kw)
        elif encoder == "hgat":
            new_x = hgat_layer(lp, x, rel_emb, snap, c, **kw)
        else:
            d = x.shape[1]
            nb_eff = d * d // lp["weight"].shape[1]  # cols = nb * (d/nb)^2 = d^2 / nb
            new_x = lgcn_layer(lp, x, rel_emb, snap, c, nb_eff, **kw)
        prev, x = x, new_x
    return x
