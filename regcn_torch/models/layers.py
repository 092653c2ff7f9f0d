"""GNN encoder layers (plain functions over parameter dictionaries).

Counterparts of ``regcn_tpu/models/layers.py``; the parameter
dictionaries have the JAX package's keys and layouts (weights applied as
``x @ W``; GRU weights in torch's [3H, in] layout), so converted JAX
parameters drop in unchanged.

- :func:`union_rgcn_layer` — parity with ref:rgcn/layers.py:182-279
  ``UnionRGCNLayer``: edge message ``(h_src + rel_emb[type]) @ W``,
  in-degree-normalised sum reduce, dual self-loop (``loop_w`` for nodes
  with incoming edges, ``evolve_loop_w`` for isolated ones), optional
  sigmoid-gated skip connection, fixed-slope rrelu, then dropout in
  training. The rrelu keeps its fixed slope in training too: the
  reference calls ``F.rrelu`` with its default ``training=False``
  (ref:src/rrgcn.py:16), so no slope is ever sampled.
- :func:`rgcn_block_layer` — parity with ref:rgcn/layers.py:147-179
  ``RGCNBlockLayer``, the static entity-word graph's layer: a
  block-diagonal transform per relation, the in-degree-normalised sum
  over destinations (``masked_segment_sum``, plain ``index_add_``: JAX's
  is a plain ``segment_sum``, not a Pallas kernel), the fixed-slope
  rrelu, then dropout in training.
- :func:`rgcn_basis_layer` — parity with ref:rgcn/layers.py:96-144, the
  basis-decomposition layer of the legacy entity classifier
  (``regcn_torch/models/entity_classifier.py``), featureless (input) or
  projected; its sum over each node's edges is kernel B1 with the
  per-(destination, type) edge norm as the edge weight.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from regcn_torch.config import ModelConfig
from regcn_torch.dist import is_sharded
from regcn_torch.ops.activations import inverted_dropout, rrelu
from regcn_torch.ops.rgcn_scatter import rgcn_aggregate, scatter_add_sorted
from regcn_torch.ops.segment import masked_segment_sum
from regcn_torch.parallel.halo import mesh_edges, mesh_rgcn_aggregate, table_rows
from regcn_torch.utils.dtypes import dot_f32, linear, mm
from regcn_torch.utils.init import RELU_GAIN, gru_uniform, xavier_uniform

Params = Dict[str, torch.Tensor]

# the basis layer's fused gather [B, E, out] is taken up to this many
# elements (JAX's ``_BASIS_FUSE_ELEMS``); above it, a loop over the bases
_BASIS_FUSE_ELEMS = 1 << 27


def init_union_rgcn_layer(
    gen: torch.Generator, h_dim: int, self_loop: bool = True, skip_connect: bool = False
) -> Params:
    p: Params = {"w_neighbor": xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)}
    if self_loop:
        p["loop_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
        p["evolve_loop_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
    if skip_connect:
        p["skip_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
        p["skip_b"] = torch.zeros((h_dim,))
    return p


def union_rgcn_layer(
    params: Params,
    h: torch.Tensor,  # [N, d]
    rel_emb: torch.Tensor,  # [2R, d] evolved relation embeddings for this layer
    snap,  # Snapshot of tensors (single step: no time axis)
    *,
    prev_h: Optional[torch.Tensor] = None,  # for skip connect (layer >= 1)
    dropout: float = 0.0,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    impl: str = "xla",
) -> torch.Tensor:
    """With ``impl`` a :class:`~regcn_torch.dist.HaloImpl` or
    :class:`~regcn_torch.dist.GspmdImpl`, ``h`` holds this rank's rows of
    the entity table and the layer returns its rows: the aggregation over
    the rank's partition of the edges (``snap.halo`` / ``snap.parts``; JAX
    ``layers.py:63-70``), the self-loop over its rows, and the dropout's
    mask drawn for the whole table, as one device draws it."""
    if is_sharded(impl):
        edges = mesh_edges(impl, snap)
        node_repr = mesh_rgcn_aggregate(impl, h, rel_emb, params["w_neighbor"], edges)
    else:
        edges = snap
        node_repr = rgcn_aggregate(
            h, rel_emb, params["w_neighbor"], snap.src, snap.dst, snap.rel,
            snap.edge_mask, snap.in_deg_norm, dst_sorted=snap.dst_sorted, impl=impl,
        )
    if "loop_w" in params:
        # dual self-loop: evolve_loop_weight for isolated nodes
        # (ref:rgcn/layers.py:226-233); fp32 products, back in h's dtype
        loop = torch.where(edges.has_in_edge[:, None] > 0,
                           dot_f32(h, params["loop_w"]).to(h.dtype),
                           dot_f32(h, params["evolve_loop_w"]).to(h.dtype))
        node_repr = node_repr + loop
    if prev_h is not None and "skip_w" in params:
        # sigmoid-gated skip across layers (ref:rgcn/layers.py:234-245)
        gate = torch.sigmoid(mm(prev_h, params["skip_w"]) + params["skip_b"])
        node_repr = gate * node_repr + (1.0 - gate) * prev_h
    return inverted_dropout(rrelu(node_repr), dropout, gen, train,
                            rows=table_rows(impl, h))


def init_rgcn_cell(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, list]:
    """Stack of n_layers UnionRGCN layers (ref:src/rrgcn.py:14-54 RGCNCell)."""
    return {"layers": [
        init_union_rgcn_layer(gen, cfg.h_dim, cfg.self_loop, cfg.skip_connect and i > 0)
        for i in range(cfg.n_layers)
    ]}


def rgcn_cell(
    params, h: torch.Tensor, rel_emb: torch.Tensor, snap, cfg: ModelConfig, *,
    gen: Optional[torch.Generator] = None, train: bool = False, impl: str = "xla",
) -> torch.Tensor:
    x = h
    prev = None
    for i, lp in enumerate(params["layers"]):
        sc_prev = prev if (cfg.skip_connect and i > 0) else None
        prev, x = x, union_rgcn_layer(lp, x, rel_emb, snap, prev_h=sc_prev,
                                      dropout=cfg.dropout, gen=gen, train=train, impl=impl)
    return x


def init_rgcn_block_layer(gen: torch.Generator, h_dim: int, num_rels: int, n_bases: int
                          ) -> Params:
    """``weight`` [num_rels, n_bases * sub * sub], sub = h_dim / n_bases:
    row r holds relation r's n_bases diagonal blocks of [sub, sub]."""
    if h_dim % n_bases:
        raise ValueError(f"h_dim {h_dim} must be divisible by n_bases {n_bases}")
    sub = h_dim // n_bases
    return {"weight": xavier_uniform(gen, (num_rels, n_bases * sub * sub), gain=RELU_GAIN)}


def rgcn_block_layer(
    params: Params,
    h: torch.Tensor,  # [N_total, d]: entities, then words, for the static graph
    snap,
    n_bases: int,
    *,
    dropout: float = 0.0,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
) -> torch.Tensor:
    """msg_e = blockdiag(W[rel_e]) @ h[src_e]; the sum over each node's
    incoming edges times 1/in_degree; rrelu; no self-loop."""
    n, d = h.shape
    sub = d // n_bases
    # the blocks applied as a broadcast product summed over the input
    # index (the LGCN layer's form): per edge n_bases products of [1, sub]
    # by [sub, sub], far too small for a batched GEMM
    w_e = params["weight"].index_select(0, snap.rel).reshape(-1, n_bases, sub, sub)
    h_src = h.index_select(0, snap.src).reshape(-1, n_bases, sub, 1)
    msg = torch.sum(h_src * w_e, dim=2).reshape(-1, d)
    agg = masked_segment_sum(msg, snap.dst, snap.edge_mask, n) * snap.in_deg_norm[:, None]
    return inverted_dropout(rrelu(agg), dropout, gen, train)


def init_rgcn_basis_layer(gen: torch.Generator, in_feat: int, out_feat: int, num_rels: int,
                          num_bases: int = -1, bias: bool = False) -> Params:
    """The legacy basis-decomposition layer (ref:rgcn/layers.py:96-144):
    ``weight`` [B, in, out] (B = num_rels unless 0 < num_bases <
    num_rels), ``w_comp`` [num_rels, B] only when B < num_rels, and an
    optional ``bias`` [out]."""
    if num_bases <= 0 or num_bases > num_rels:
        num_bases = num_rels
    p: Params = {"weight": xavier_uniform(gen, (num_bases, in_feat, out_feat), gain=RELU_GAIN)}
    if num_bases < num_rels:
        p["w_comp"] = xavier_uniform(gen, (num_rels, num_bases), gain=RELU_GAIN)
    if bias:
        p["bias"] = xavier_uniform(gen, (1, out_feat), gain=RELU_GAIN)[0]
    return p


def rgcn_basis_layer(params: Params, h: Optional[torch.Tensor], graph, *,
                     input_layer: bool = False, activation=None) -> torch.Tensor:
    """Basis-decomposed relation-typed aggregation (ref:rgcn/layers.py:118-144).

    ``msg_e = h[src_e] @ W[rel_e]`` with ``W[r] = sum_b w_comp[r, b] basis_b``,
    summed over each node's incoming edges times the edge norm
    (``graph``: a ``regcn_torch.data.rdf.StaticGraph``, edges sorted by
    destination; the sum is kernel B1), then bias and activation. As in
    JAX, the bases are applied the GEMM-friendly way round: B products
    ``P_b = h @ basis_b`` over all nodes, then ``msg_e = sum_b
    comp[rel_e, b] P_b[src_e]``, never an [E, d, d] tensor; that sum is one
    gathered [B, E, out] contraction up to ``_BASIS_FUSE_ELEMS`` elements
    and a loop over the bases with an [E, out] accumulator above.

    ``input_layer=True`` is the featureless input mode (ref :129-134): node
    features are implicit one-hot ids, so the message is row
    ``(rel_e, src_e)`` of the composed weight, and ``h`` is not read.
    """
    weight = params["weight"]  # [B, in, out]
    num_bases, out_feat = weight.shape[0], weight.shape[-1]
    n_edges = graph.src.shape[0]

    def combine_bases(tables: torch.Tensor) -> torch.Tensor:  # [B, N, out]
        comp = params["w_comp"].index_select(0, graph.rel)  # [E, B]
        if num_bases * n_edges * out_feat <= _BASIS_FUSE_ELEMS:
            return torch.einsum("eb,beo->eo", comp, tables[:, graph.src, :])
        msg = tables.new_zeros((n_edges, out_feat))
        for b in range(num_bases):
            msg = msg + comp[:, b, None] * tables[b].index_select(0, graph.src)
        return msg

    tables = weight if input_layer else torch.einsum("ni,bio->bno", h, weight)
    if "w_comp" in params:
        msg = combine_bases(tables)
    else:  # one basis per relation: a double gather, no contraction
        msg = tables[graph.rel, graph.src]
    agg = scatter_add_sorted(msg.contiguous(), graph.keys, graph.num_nodes,
                             edge_weight=graph.edge_norm, row_scale=graph.in_deg_norm)
    if "bias" in params:
        agg = agg + params["bias"]
    return agg if activation is None else activation(agg)


def init_gru_cell(gen: torch.Generator, input_size: int, hidden_size: int) -> Params:
    """torch nn.GRUCell parameterisation (ref:src/rrgcn.py:133)."""
    return {
        "w_ih": gru_uniform(gen, (3 * hidden_size, input_size), hidden_size),
        "w_hh": gru_uniform(gen, (3 * hidden_size, hidden_size), hidden_size),
        "b_ih": gru_uniform(gen, (3 * hidden_size,), hidden_size),
        "b_hh": gru_uniform(gen, (3 * hidden_size,), hidden_size),
    }


def gru_cell(params: Params, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """torch GRUCell semantics: r/z gates then candidate with reset on h.

    Gate order r, z, n, as in ``torch.nn.GRUCell``."""
    return gru_gates(linear(x, params["w_ih"], params["b_ih"]),
                     linear(h, params["w_hh"], params["b_hh"]), h)


def gru_gates(gi: torch.Tensor, gh: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The GRU update from its two projections, ``gi = x W_ih^T + b_ih`` and
    ``gh = h W_hh^T + b_hh``: a recurrence over a sequence projects all of
    its inputs in one product and calls this per step."""
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h
