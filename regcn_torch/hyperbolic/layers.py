"""Hyperbolic GNN encoder layers: the LGCN encoder.

Counterpart of ``regcn_tpu/hyperbolic/layers.py`` for ``lgcn``: a
block-decomposed tangent transform per relation, messages mapped to the
hyperboloid and aggregated per destination as weighted Lorentz
centroids, a dual self-loop, an optional gated skip, ±10 tangent
clamps and the fixed-slope rrelu. The parameter dictionaries have the
JAX package's keys and layouts.

The other encoders (``hyperbolic_uvrgcn``, ``fhnn``, ``hgat``) and the
multi-device halo aggregation are not ported yet (ROADMAP A6, A8, A12).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from regcn_torch.hyperbolic import ops as H
from regcn_torch.ops.activations import rrelu
from regcn_torch.utils.init import RELU_GAIN, xavier_uniform

Params = Dict[str, torch.Tensor]

CLAMP = 10.0  # tangent clamp
ENCODERS = ("hyperbolic_uvrgcn", "fhnn", "lgcn", "hgat")


def _dropout(x, rate: float, gen: Optional[torch.Generator], train: bool):
    """Inverted dropout from ``gen`` (a generator on x's device)."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _dual_self_loop(params, h_tan, has_in_edge):
    """``loop_w`` for nodes with incoming edges, ``evolve_loop_w`` else."""
    return torch.where(has_in_edge[:, None] > 0, h_tan @ params["loop_w"],
                       h_tan @ params["evolve_loop_w"])


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


def lgcn_layer(params: Params, h_hyper: torch.Tensor, rel_emb: Optional[torch.Tensor], snap, c,
               n_bases: int, *, prev_h=None, dropout: float = 0.0,
               gen: Optional[torch.Generator] = None, train: bool = False) -> torch.Tensor:
    """One LGCN layer on ball points [N, d]; returns ball points."""
    n, d = h_hyper.shape
    nb, sub = n_bases, d // n_bases
    h_tan = H.log_map_zero(h_hyper, c)

    # per-edge block-diagonal transform: nb blocks of [sub, sub]. Gathers
    # are index_select: its backward is one index_add_, where indexing's
    # sorts its indices first
    w_e = params["weight"].index_select(0, snap.rel).reshape(-1, nb, sub, sub)
    src_feat = h_tan.index_select(0, snap.src).reshape(-1, nb, sub, 1)
    msg_tan = torch.sum(src_feat * w_e, dim=2).reshape(-1, d)
    if rel_emb is not None:
        msg_tan = msg_tan + rel_emb.index_select(0, snap.rel)
    msg_lorentz = H.to_lorentz(H.exp_map_zero(msg_tan, c), c)
    agg = H.lorentz_centroid_segments(
        msg_lorentz, snap.in_deg_norm[snap.dst] * snap.edge_mask, snap.dst, n, c)
    h_new = torch.clamp(H.log_map_zero(H.to_poincare(agg, c), c), -CLAMP, CLAMP)

    if "loop_w" in params:
        loop = _dual_self_loop(params, h_tan, snap.has_in_edge)
    if prev_h is not None and "skip_w" in params:
        prev_tan = H.log_map_zero(prev_h, c)
        gate = torch.sigmoid(prev_tan @ params["skip_w"] + params["skip_b"])
        if "loop_w" in params:
            h_new = h_new + loop
        h_new = gate * h_new + (1 - gate) * prev_tan
    elif "loop_w" in params:
        h_new = h_new + loop

    h_new = torch.clamp(h_new, -CLAMP, CLAMP)
    # the eval-mode rrelu even while training: the reference calls
    # F.rrelu with its default training=False
    h_new = rrelu(h_new)
    h_new = _dropout(h_new, dropout, gen, train)
    return H.exp_map_zero(h_new, c).to(h_hyper.dtype)


def _check_encoder(encoder: str) -> None:
    if encoder not in ENCODERS:
        raise ValueError(f"unknown encoder {encoder!r}; known: {ENCODERS}")
    if encoder != "lgcn":
        raise NotImplementedError(f"the {encoder} encoder is not ported yet (ROADMAP A6/A8)")


def init_encoder_cell(gen: torch.Generator, encoder: str, h_dim: int, num_rels_total: int,
                      n_layers: int, n_bases: int = -1, num_heads: int = 4,
                      self_loop: bool = True, skip_connect: bool = False) -> Dict[str, list]:
    _check_encoder(encoder)
    return {"layers": [
        init_lgcn_layer(gen, h_dim, num_rels_total, n_bases, self_loop, skip_connect and i > 0)
        for i in range(n_layers)
    ]}


def encoder_cell(params, encoder: str, h_hyper: torch.Tensor, rel_emb: torch.Tensor, snap, c,
                 *, n_bases: int = -1, num_heads: int = 4, radius_gamma: float = 1.0,
                 dropout: float = 0.0, gen: Optional[torch.Generator] = None,
                 train: bool = False, impl: str = "xla") -> torch.Tensor:
    _check_encoder(encoder)
    if impl != "xla":
        raise NotImplementedError(f"encoder impl {impl!r} (halo / pallas) is not ported yet")
    x, prev = h_hyper, None
    for i, lp in enumerate(params["layers"]):
        d = x.shape[1]
        nb_eff = d * d // lp["weight"].shape[1]  # cols = nb * (d/nb)^2 = d^2 / nb
        new_x = lgcn_layer(lp, x, rel_emb, snap, c, nb_eff, prev_h=prev if i > 0 else None,
                           dropout=dropout, gen=gen, train=train)
        prev, x = x, new_x
    return x
