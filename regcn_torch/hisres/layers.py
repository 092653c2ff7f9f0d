"""HisRES GNN layers.

Counterpart of ``regcn_tpu/hisres/layers.py``; the parameter dictionaries
have the JAX package's keys and layouts (weights applied as ``x @ W``,
``r_linear_w`` and the attention's weights in torch's Linear layout).

- :func:`hisres_union_layer`: the baseline UnionRGCN plus a relation
  branch, ``(node_repr, edge_repr)`` with ``edge_repr =
  rrelu(Linear(rel_emb))`` (ref:hisres_rgcn/layers.py:285-394). Its
  aggregation ``segment_sum((h[src] + rel[rel]) @ W * mask, dst) *
  in_deg_norm`` is ``rgcn_aggregate``'s function, so it runs on kernel B1
  (``regcn_torch/ops/rgcn_scatter.py``); JAX sums it with a plain
  ``segment_sum``.
- :func:`cand_rgcn_layer`: attention RGCN over the query-conditioned
  history graph (ref:hisres_rgcn/layers.py:7-114): edge logits
  ``attn_fc(leaky_relu(pos_proj([h_s; r; h_d]), 0.01))`` under a segment
  softmax over each destination's edges; messages ``conv1d_{1x1}(bn(h_s +
  r)) @ W``, the BatchNorm over the real edges' batch statistics; the
  softmax-weighted sum on B1 with the weight ``alpha * mask``, whose
  gradient B1's backward gives as ``dw``; the dual self-loop.

Both layers apply the fixed-slope rrelu (the reference's ``F.rrelu`` with
its default ``training=False``), then dropout in training. On a mesh the
union layer runs on the rank's rows; the candidate layers stay dense, on
the all-gathered table (``hisres/model.py``), as JAX keeps them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from regcn_torch.dist import is_sharded
from regcn_torch.hyperbolic.layers import _dual_self_loop
from regcn_torch.models.decoders import _batch_norm, _init_bn
from regcn_torch.ops.activations import inverted_dropout, leaky_relu, rrelu
from regcn_torch.ops.rgcn_scatter import rgcn_aggregate, scatter_add_sorted
from regcn_torch.ops.segment import segment_softmax
from regcn_torch.parallel.halo import mesh_edges, mesh_rgcn_aggregate, table_rows
from regcn_torch.utils.dtypes import mm
from regcn_torch.utils.init import RELU_GAIN, torch_linear_uniform, xavier_normal, xavier_uniform

Params = Dict[str, torch.Tensor]


def init_hisres_union_layer(gen: torch.Generator, h_dim, self_loop=True, skip_connect=False
                            ) -> Params:
    p: Params = {
        "w_neighbor": xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN),
        "r_linear_w": torch_linear_uniform(gen, (h_dim, h_dim), h_dim),
        "r_linear_b": torch_linear_uniform(gen, (h_dim,), h_dim),
    }
    if self_loop:
        p["loop_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
        p["evolve_loop_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
    if skip_connect:
        p["skip_w"] = xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN)
        p["skip_b"] = torch.zeros((h_dim,))
    return p


def hisres_union_layer(
    params: Params,
    h: torch.Tensor,  # [N, d]
    rel_emb: torch.Tensor,  # [2R, d] the evolving relation embeddings
    snap,
    *,
    prev_h: Optional[torch.Tensor] = None,
    dropout: float = 0.0,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
    impl="xla",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(node_repr [N, d], edge_repr [2R, d]). With ``impl`` a sharded marker
    (``regcn_torch/dist.py``) ``h`` and ``node_repr`` are this rank's rows,
    aggregated over its partition of the edges on B1 as JAX's halo path
    does (``regcn_tpu/hisres/layers.py:56-63``); ``edge_repr`` is
    replicated."""
    if is_sharded(impl):
        edges = mesh_edges(impl, snap)
        node_repr = mesh_rgcn_aggregate(impl, h, rel_emb, params["w_neighbor"], edges)
    else:
        edges = snap
        node_repr = rgcn_aggregate(
            h, rel_emb, params["w_neighbor"], snap.src, snap.dst, snap.rel, snap.edge_mask,
            snap.in_deg_norm, dst_sorted=snap.dst_sorted)
    edge_repr = mm(rel_emb, params["r_linear_w"].T) + params["r_linear_b"]
    if "loop_w" in params:
        loop = _dual_self_loop(params, h, edges.has_in_edge)
    if prev_h is not None and "skip_w" in params:
        gate = torch.sigmoid(mm(prev_h, params["skip_w"]) + params["skip_b"])
        if "loop_w" in params:
            node_repr = node_repr + loop
        node_repr = gate * node_repr + (1 - gate) * prev_h
    elif "loop_w" in params:
        node_repr = node_repr + loop
    return (inverted_dropout(rrelu(node_repr), dropout, gen, train, rows=table_rows(impl, h)),
            inverted_dropout(rrelu(edge_repr), dropout, gen, train))


def init_hisres_rgcn_cell(gen: torch.Generator, h_dim, n_layers, self_loop=True,
                          skip_connect=False) -> Dict[str, list]:
    return {"layers": [init_hisres_union_layer(gen, h_dim, self_loop, skip_connect and i > 0)
                       for i in range(n_layers)]}


def hisres_rgcn_cell(params, h: torch.Tensor, rel_emb: torch.Tensor, snap, *,
                     dropout: float = 0.0, gen: Optional[torch.Generator] = None,
                     train: bool = False, impl="xla") -> Tuple[torch.Tensor, torch.Tensor]:
    """Threads the evolving relation embedding through the layer stack
    (ref:hisres_src/hisres.py:33-41): x, r = layer(g, x, r)."""
    x, r = h, rel_emb
    for lp in params["layers"]:
        x, r = hisres_union_layer(lp, x, r, snap, dropout=dropout, gen=gen, train=train,
                                  impl=impl)
    return x, r


# ------------------------------------------------------------- CandRGCN

def init_cand_layer(gen: torch.Generator, h_dim) -> Tuple[Params, Dict]:
    params: Params = {
        "attn_fc_w": xavier_normal(gen, (1, 3 * h_dim), gain=RELU_GAIN),
        "pos_proj_w": xavier_normal(gen, (3 * h_dim, 3 * h_dim), gain=RELU_GAIN),
        "w_neighbor": xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN),
        "loop_w": xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN),
        "evolve_loop_w": xavier_uniform(gen, (h_dim, h_dim), gain=RELU_GAIN),
        # Conv1d(1 -> 1, k=1): a scalar affine map of the feature signal
        "conv_w": torch_linear_uniform(gen, (1,), 1),
        "conv_b": torch_linear_uniform(gen, (1,), 1),
    }
    params["bn0"], bn_state = _init_bn(1)
    return params, bn_state


def cand_rgcn_layer(
    params: Params,
    bn_state: Dict,
    h: torch.Tensor,  # [N, d]
    rel_emb: torch.Tensor,  # [2R, d]
    snap,  # the history graph, destination-sorted
    *,
    dropout: float = 0.2,
    gen: Optional[torch.Generator] = None,
    train: bool = False,
) -> Tuple[torch.Tensor, Dict]:
    """(node_repr [N, d], new BN state; ``bn_state`` itself outside training)."""
    n = h.shape[0]
    h_src = h.index_select(0, snap.src)
    r_e = rel_emb.index_select(0, snap.rel)

    # edge attention logits (ref :106-109)
    z = torch.cat([h_src, r_e, h.index_select(0, snap.dst)], dim=-1)
    logits = mm(leaky_relu(mm(z, params["pos_proj_w"].T), 0.01), params["attn_fc_w"].T)[:, 0]
    alpha = segment_softmax(logits, snap.dst, snap.edge_mask, n)

    # message: conv1d(1 -> 1, k=1) over bn(h_src + r), then @ W (ref :86-99)
    x, new_bn = _batch_norm(params["bn0"], bn_state, (h_src + r_e)[:, None, :], snap.edge_mask,
                            train=train)
    msg = mm(x[:, 0, :] * params["conv_w"][0] + params["conv_b"][0], params["w_neighbor"])

    # the alpha-weighted sum per destination, on B1: masked edges keyed n
    keys = torch.where(snap.edge_mask > 0, snap.dst, n).to(torch.int32)
    w = alpha * snap.edge_mask
    # B1 sums in fp32; the sum returns in the dtype of JAX's segment sum of
    # msg * w (fp32 where the history graph's mask is fp32)
    agg_dtype = torch.result_type(msg, w)
    if not snap.dst_sorted:
        order = torch.argsort(keys, stable=True)
        keys, w, msg = keys[order], w[order], msg[order]
    agg = scatter_add_sorted(msg.float().contiguous(), keys, n,
                             edge_weight=w.float().contiguous())

    node_repr = agg.to(agg_dtype) + _dual_self_loop(params, h, snap.has_in_edge)
    return inverted_dropout(rrelu(node_repr), dropout, gen, train), new_bn


def init_cand_cell(gen: torch.Generator, h_dim, n_layers) -> Tuple[Dict[str, list], List[Dict]]:
    layers, bns = [], []
    for _ in range(n_layers):
        p, s = init_cand_layer(gen, h_dim)
        layers.append(p)
        bns.append(s)
    return {"layers": layers}, bns


def cand_cell(params, bn_states: List[Dict], h: torch.Tensor, rel_emb: torch.Tensor, snap, *,
              dropout: float = 0.2, gen: Optional[torch.Generator] = None, train: bool = False
              ) -> Tuple[torch.Tensor, List[Dict]]:
    x, new_bns = h, []
    for lp, bs in zip(params["layers"], bn_states):
        x, nb = cand_rgcn_layer(lp, bs, x, rel_emb, snap, dropout=dropout, gen=gen, train=train)
        new_bns.append(nb)
    return x, new_bns
