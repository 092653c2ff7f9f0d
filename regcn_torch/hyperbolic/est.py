"""EST: persistent entity memory and event-history retrieval.

Counterpart of ``regcn_tpu/hyperbolic/est.py``, as plain functions on
tensors:

- H-PES (:class:`ESTState`, :func:`inject_slow_state`,
  :func:`update_states`): fast (EMA) and slow (gated) tangent-space
  memories of the entities. The buffers live in an :class:`ESTState`
  beside the parameters, carried by the train state and its checkpoints;
  the writeback runs on detached values, by segment sums.
- H-TDP (:func:`time_delta_tangent`, :func:`time_delta_projection`):
  exp_0(MLP(log1p Δt)).
- ETNR (:class:`TemporalIndex`): a host-side numpy index of each entity's
  events; a query returns padded [B, K] arrays of the K latest events
  before the query time, which :class:`RetrievalBatch` carries to the
  device.
- QCHHE (:func:`history_encoder_tangent`): tangent features of (neighbour,
  relation, Δt), a query-conditioned bias and gate, a GRU (unrolled over
  the K events, the input projection of all K in one product) or a
  post-LN Transformer backbone, a layer norm and masked attention pooling.
- Fusion and enrichment (:func:`fuse_global_local_tangent`,
  :func:`enrich_embeddings`): the query heads' rows of the entity table
  replaced by the gated fusion of their own tangent and the history
  context, all on tangent features.
- TANS (:func:`build_true_tails_dict`, :func:`tans_mask_coo`): host-built
  (query, candidate) COO entries that training squashes to -1e9.

On an entity-sharded mesh the memories stay whole and replicated on every
rank, as JAX keeps them, and the writeback runs alike on every rank, from
the same context rows (the trainer's ``est_update``) and with segment sums
that are ``index_put_`` accumulations, which add each entity's rows in one
order on the card too, so the ranks' memories stay bit-equal;
the enrichment gathers the rows it reads by global id and writes the heads
the rank owns (:func:`enrich_embeddings`), and TANS keeps the entries of
the rank's candidate columns (:func:`shard_tans_coo`).

The parameter dictionaries have the JAX package's keys and layouts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import relu

from regcn_torch.hyperbolic import ops as H
from regcn_torch.models.layers import gru_gates, init_gru_cell
from regcn_torch.parallel.collectives import RowShard, rows_of
from regcn_torch.utils.dtypes import linear, mm, promoted
from regcn_torch.utils.init import torch_linear_uniform, xavier_uniform

Params = Dict[str, torch.Tensor]

CLAMP = 10.0
MASKED = -1e9  # the logit of a masked event, key or candidate


# ----------------------------------------------------------------- H-PES

@dataclasses.dataclass
class ESTState:
    """The entity memories [N, d] in tangent space: ``fast`` an EMA of the
    contexts, ``slow`` its gated follower, which the model injects."""

    fast: torch.Tensor
    slow: torch.Tensor


def init_est_state(num_ents: int, h_dim: int, device="cuda") -> ESTState:
    return ESTState(fast=torch.zeros((num_ents, h_dim), device=device),
                    slow=torch.zeros((num_ents, h_dim), device=device))


def init_est_params(gen: torch.Generator, cfg) -> Params:
    """Every EST parameter (H-PES gate, H-TDP MLP, QCHHE, fusion), drawn
    from ``gen`` on the CPU."""
    d = cfg.h_dim
    p: Params = {
        "slow_threshold": torch.tensor(0.5),
        "slow_scale": torch.tensor(2.0),
        # H-TDP MLP 1 -> d -> d: xavier weights, torch-default biases
        "tdp_w1": xavier_uniform(gen, (d, 1)),
        "tdp_b1": torch_linear_uniform(gen, (d,), 1),
        "tdp_w2": xavier_uniform(gen, (d, d)),
        "tdp_b2": torch_linear_uniform(gen, (d,), d),
        "hist_proj_w": xavier_uniform(gen, (d, 3 * d)),
        "hist_proj_b": torch.zeros(d),
        "cond_in_w": xavier_uniform(gen, (d, d)),
        "cond_in_b": torch.zeros(d),
        "cond_gate_w": xavier_uniform(gen, (d, d)),
        "cond_gate_b": torch.zeros(d),
        "attn_proj_w": xavier_uniform(gen, (1, 2 * d)),
        "attn_proj_b": torch.zeros(1),
        "out_norm_scale": torch.ones(d),
        "out_norm_bias": torch.zeros(d),
        "fusion_gate_w": xavier_uniform(gen, (d, 2 * d)),
        "fusion_gate_b": torch.zeros(d),
    }
    if cfg.est_encoder == "gru":
        p["qchhe_gru"] = init_gru_cell(gen, d, d)
    elif cfg.est_encoder == "transformer":
        p["qchhe_transformer"] = _init_transformer(gen, d, n_layers=2)
    else:
        raise ValueError(f"unknown est encoder {cfg.est_encoder!r}")
    return p


def inject_slow_state(params: Params, h_hyp: torch.Tensor, slow: torch.Tensor, c,
                      entity_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ball points with the (detached) slow memory added in tangent space."""
    s = slow.detach()
    if entity_ids is not None:
        s = s.index_select(0, entity_ids)
    h_tan = torch.clamp(H.log_map_zero(h_hyp, c) + s, -CLAMP, CLAMP)
    # in h_hyp's dtype: the fp32 slow memory must not promote a bf16 carry
    return H.project_to_ball(H.exp_map_zero(h_tan, c), c).to(h_hyp.dtype)


@torch.no_grad()
def update_states(params: Params, state: ESTState, entity_ids: torch.Tensor, mask: torch.Tensor,
                  context_tangent: torch.Tensor, alpha: float) -> ESTState:
    """The H-PES writeback: each entity among the valid rows of
    ``entity_ids`` [B] (``mask`` [B], 1 = valid) takes the mean of its
    rows' contexts [B, d] into its fast memory, and the slow memory follows
    the fast one through a sigmoid gate on the distance between them; the
    gate's threshold and scale are read detached. Returns a new state.

    The segment sums are ``index_put_`` accumulations: on the card these
    add a repeated entity's rows in one fixed order (``index_add_`` adds
    them by atomics in any order), so ranks that hold the memories
    replicated compute them bit for bit alike."""
    n, d = state.fast.shape
    # fp32, as JAX's product with the fp32 triple mask makes a bf16 context
    ctx = context_tangent.detach().float()
    mask = mask.float()
    cnt = mask.new_zeros(n).index_put_((entity_ids,), mask, accumulate=True)
    present = (cnt > 0)[:, None]
    ctx_sum = ctx.new_zeros((n, d)).index_put_((entity_ids,), ctx * mask[:, None],
                                               accumulate=True)
    ctx_mean = ctx_sum / torch.clamp(cnt, min=1.0)[:, None]
    fast = torch.where(present, (1.0 - alpha) * state.fast + alpha * ctx_mean, state.fast)
    delta = fast - state.slow
    delta_norm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    threshold = torch.clamp(params["slow_threshold"].detach(), min=1e-6)
    scale = torch.clamp(params["slow_scale"].detach(), min=0.1)
    gate = torch.sigmoid(scale * (delta_norm - threshold))
    return ESTState(fast=fast, slow=torch.where(present, state.slow + gate * delta, state.slow))


# ----------------------------------------------------------------- H-TDP

def time_delta_tangent(params: Params, deltas: torch.Tensor) -> torch.Tensor:
    """MLP(log1p Δt) tangent features [B, K, d] of the time gaps [B, K]. The
    first layer has one input, so it is a product of each gap with the
    weight column. The gaps' log1p is fp32, so under bf16 compute the MLP
    runs in fp32 on the bf16 weights' values, as JAX's promotion runs it."""
    x = torch.log1p(deltas.float())[..., None]
    h1 = relu(x * params["tdp_w1"][:, 0] + params["tdp_b1"])
    return linear(h1, params["tdp_w2"], params["tdp_b2"])


def time_delta_projection(params: Params, deltas: torch.Tensor, c) -> torch.Tensor:
    """exp_0(MLP(log1p Δt)): [B, K, d] ball points."""
    return H.exp_map_zero(time_delta_tangent(params, deltas), c)


# ------------------------------------------------------------------ ETNR

class TemporalIndex:
    """Host-side per-entity event index.

    :meth:`build` takes the snapshots; :meth:`query` returns padded [B, K]
    numpy arrays of the K latest events strictly before the query time."""

    def __init__(self, history_len: int = 32):
        self.history_len = history_len
        self._index: Dict[int, List[Tuple[int, int, int]]] = {}
        self.num_rels = 0

    def build(self, snapshot_list: List[np.ndarray], num_rels: int) -> None:
        self._index = {}
        self.num_rels = num_rels
        for t, snapshot in enumerate(snapshot_list):
            if snapshot is None or len(snapshot) == 0:
                continue
            for h_id, r_id, t_id in np.asarray(snapshot)[:, :3]:
                self._index.setdefault(int(h_id), []).append((t, int(r_id), int(t_id)))
                self._index.setdefault(int(t_id), []).append((t, int(r_id) + num_rels, int(h_id)))
        # time-sorted arrays per entity: a query is one searchsorted each
        self._arrays = {}
        for e, events in self._index.items():
            events.sort(key=lambda x: x[0])
            arr = np.asarray(events, dtype=np.int64).reshape(-1, 3)
            self._arrays[e] = (arr[:, 0], arr[:, 1].astype(np.int32), arr[:, 2].astype(np.int32))

    def query(self, entity_ids, query_time: int):
        """(neighbours, relations, time gaps, event mask), each [B, K]: the
        latest events first in time order, left-aligned, zeros after."""
        K = self.history_len
        B = len(entity_ids)
        nb_e = np.zeros((B, K), np.int32)
        nb_r = np.zeros((B, K), np.int32)
        dts = np.zeros((B, K), np.float32)
        msk = np.zeros((B, K), np.float32)
        for i, eid in enumerate(entity_ids):
            ev = self._arrays.get(int(eid))
            if ev is None:
                continue
            times, rels, nbs = ev
            end = int(np.searchsorted(times, query_time, side="left"))
            lo = max(0, end - K)
            n = end - lo
            if n == 0:
                continue
            nb_e[i, :n] = nbs[lo:end]
            nb_r[i, :n] = rels[lo:end]
            dts[i, :n] = (query_time - times[lo:end]).astype(np.float32)
            msk[i, :n] = 1.0
        return nb_e, nb_r, dts, msk


@dataclasses.dataclass
class RetrievalBatch:
    """The ETNR query of a batch's heads on the device."""

    nb_ents: torch.Tensor  # [B, K] int64
    nb_rels: torch.Tensor  # [B, K] int64
    deltas: torch.Tensor  # [B, K] float32
    event_mask: torch.Tensor  # [B, K] float32
    row_mask: torch.Tensor  # [B] float32: the batch row itself is real

    @classmethod
    def query(cls, index: TemporalIndex, triples: np.ndarray, mask: np.ndarray,
              query_time: int, device) -> "RetrievalBatch":
        """The events of ``triples[:, 0]`` before ``query_time``."""
        nb_e, nb_r, dts, msk = index.query(triples[:, 0], query_time)
        return cls(nb_ents=torch.from_numpy(nb_e).long().to(device),
                   nb_rels=torch.from_numpy(nb_r).long().to(device),
                   deltas=torch.from_numpy(dts).to(device),
                   event_mask=torch.from_numpy(msk).to(device),
                   row_mask=torch.from_numpy(np.asarray(mask, np.float32)).to(device))


# ----------------------------------------------------------------- QCHHE

def _init_transformer(gen: torch.Generator, d: int, n_layers: int = 2):
    """A post-LN Transformer encoder (torch's TransformerEncoder layout)."""
    ff = 4 * d
    return {"layers": [{
        "qkv_w": torch_linear_uniform(gen, (3 * d, d), d),
        "qkv_b": torch.zeros(3 * d),
        "out_w": torch_linear_uniform(gen, (d, d), d),
        "out_b": torch.zeros(d),
        "ff1_w": torch_linear_uniform(gen, (ff, d), d),
        "ff1_b": torch_linear_uniform(gen, (ff,), d),
        "ff2_w": torch_linear_uniform(gen, (d, ff), ff),
        "ff2_b": torch_linear_uniform(gen, (d,), ff),
        "ln1_scale": torch.ones(d), "ln1_bias": torch.zeros(d),
        "ln2_scale": torch.ones(d), "ln2_bias": torch.zeros(d),
    } for _ in range(n_layers)]}


def _layer_norm(x, scale, bias, eps=1e-5):
    """(x - mean) / sqrt(var + eps) * scale + bias with the biased variance,
    as JAX's ``jnp.var``: torch's ``layer_norm`` is that, in one kernel."""
    x, scale, bias = promoted(x, scale, bias)
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _transformer_encode(tparams, x: torch.Tensor, mask: torch.Tensor, n_heads: int = 4):
    """x [B, K, d], mask [B, K] (1 = valid): post-LN self-attention layers
    whose padded keys get the logit -1e9."""
    B, K, d = x.shape
    hd = d // n_heads
    pad = (mask <= 0)[:, None, None, :]

    def heads(t):
        return t.reshape(B, K, n_heads, hd).transpose(1, 2)

    for lp in tparams["layers"]:
        q, k, v = linear(x, lp["qkv_w"], lp["qkv_b"]).split(d, dim=-1)
        logits = (heads(q) @ heads(k).transpose(-1, -2)) / math.sqrt(hd)
        attn = torch.softmax(logits.masked_fill(pad, MASKED), dim=-1)
        out = (attn @ heads(v)).transpose(1, 2).reshape(B, K, d)
        x = _layer_norm(x + linear(out, lp["out_w"], lp["out_b"]), lp["ln1_scale"],
                        lp["ln1_bias"])
        ff = linear(relu(linear(x, lp["ff1_w"], lp["ff1_b"])), lp["ff2_w"], lp["ff2_b"])
        x = _layer_norm(x + ff, lp["ln2_scale"], lp["ln2_bias"])
    return x


def _gru_encode(gp: Params, x: torch.Tensor) -> torch.Tensor:
    """The GRU over the K events of each row, from a zero state: x [B, K, d]
    -> every step's state [B, K, d]. The input projection of all K events
    is one product, split by ``unbind``: its backward stacks the K
    gradients once, where indexing each step would fill and add a whole
    [K, B, 3d] gradient per step."""
    gi = linear(x.transpose(0, 1), gp["w_ih"], gp["b_ih"])  # [K, B, 3d]
    h = x.new_zeros((x.shape[0], gp["w_hh"].shape[1]))
    seq = []
    for gi_k in gi.unbind(0):
        h = gru_gates(gi_k, linear(h, gp["w_hh"], gp["b_hh"]), h)
        seq.append(h)
    return torch.stack(seq, dim=1)


def history_encoder(params: Params, cfg, neighbor_hyp, rel_hyp, time_hyp, query_tangent, mask,
                    c) -> torch.Tensor:
    """QCHHE on ball features [B, K, d] -> [B, d] ball context."""
    context_t = history_encoder_tangent(
        params, cfg, H.log_map_zero(neighbor_hyp, c), H.log_map_zero(rel_hyp, c),
        H.log_map_zero(time_hyp, c), query_tangent, mask)
    return H.exp_map_zero(context_t, c)


def history_encoder_tangent(params: Params, cfg, nb_t: torch.Tensor, rl_t: torch.Tensor,
                            tm_t: torch.Tensor, query_tangent: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """QCHHE on tangent features: (neighbour, relation, Δt) [B, K, d] each,
    the query's tangent [B, d] and the event mask [B, K] -> the tangent
    context [B, d]."""
    hist = torch.tanh(linear(torch.cat([nb_t, rl_t, tm_t], dim=-1), params["hist_proj_w"],
                               params["hist_proj_b"]))
    bias_in = linear(query_tangent, params["cond_in_w"], params["cond_in_b"])[:, None]
    bias_gate = torch.sigmoid(linear(query_tangent, params["cond_gate_w"],
                                       params["cond_gate_b"]))[:, None]
    hist = (hist + bias_in) * bias_gate
    if cfg.est_encoder == "gru":
        hist_seq = _gru_encode(params["qchhe_gru"], hist)
    else:
        hist_seq = _transformer_encode(params["qchhe_transformer"], hist, mask)
    hist_seq = _layer_norm(hist_seq, params["out_norm_scale"], params["out_norm_bias"])
    # the attention logit of [state ; query], its two halves apart
    d = hist_seq.shape[-1]
    w = params["attn_proj_w"][0]
    scores = mm(hist_seq, w[:d]) + (mm(query_tangent, w[d:]) + params["attn_proj_b"])[:, None]
    attn = torch.softmax(scores.masked_fill(mask <= 0, MASKED), dim=-1) * mask
    attn = attn / torch.clamp(torch.sum(attn, dim=-1, keepdim=True), min=1e-9)
    return torch.sum(hist_seq * attn[..., None], dim=1)


# ------------------------------------------------------ enrich + fusion

def fuse_global_local_tangent(params: Params, g_t: torch.Tensor, l_t: torch.Tensor
                              ) -> torch.Tensor:
    """Gated fusion of tangent rows -> tangent rows."""
    gate = torch.sigmoid(linear(torch.cat([g_t, l_t], dim=-1), params["fusion_gate_w"],
                                  params["fusion_gate_b"]))
    return torch.clamp(gate * l_t + (1.0 - gate) * g_t, -CLAMP, CLAMP)


def fuse_global_local(params: Params, h_global, h_local, c) -> torch.Tensor:
    """Gated fusion of ball points, in tangent space."""
    fused_t = fuse_global_local_tangent(params, H.log_map_zero(h_global, c),
                                        H.log_map_zero(h_local, c))
    return H.project_to_ball(H.exp_map_zero(fused_t, c), c)


def set_rows(table: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
             values: torch.Tensor) -> torch.Tensor:
    """``table`` with row ``rows[i]`` set to ``values[i]`` for each valid i
    (JAX's ``table.at[where(valid, rows, N)].set(values, mode="drop")``).

    Where a row index repeats, its last valid occurrence writes, as JAX's
    scatter on the CPU does, and only that update receives the row's
    gradient: JAX sends each written row's cotangent to the one update
    that was written, while ``index_put`` would send it to every duplicate.
    The others write into a spare row N that is cut off. Decided on the
    device, with no host sync."""
    n, b = table.shape[0], rows.shape[0]
    pos = torch.arange(b, device=rows.device)
    key = torch.where(valid, rows, n)
    last = torch.full((n + 1,), -1, dtype=pos.dtype, device=rows.device).scatter_reduce(
        0, key, pos, "amax")
    target = torch.where(valid & (last.index_select(0, key) == pos), rows, n)
    spare = torch.cat([table, table.new_zeros((1,) + table.shape[1:])])
    return spare.index_put((target,), values)[:n]


def enrich_embeddings(params: Params, cfg, global_emb: torch.Tensor, triples: torch.Tensor,
                      rb: RetrievalBatch, c, slow_state: torch.Tensor,
                      dynamic_tangent: torch.Tensor, rel_tangent: torch.Tensor, *,
                      return_ctx_tangent: bool = False, shard: Optional[RowShard] = None):
    """EST enrichment of the query heads' rows of ``global_emb`` [N, d]
    (ball), all on tangent features: each row's neighbours (the
    ``dynamic_tangent`` table plus the detached slow memory), relations
    (``rel_tangent`` [2R, d], the evolved relation embeddings) and time
    gaps go through QCHHE, conditioned on the head's own tangent, and the
    gated fusion of head and context replaces the head's row. Padded rows
    (``rb.row_mask`` 0) write nothing. Each exp/log round trip of the ball
    formulation is a ``clamp_tangent_norm``.

    With ``return_ctx_tangent`` also returns the fused tangent rows [B, d],
    which the H-PES writeback takes.

    With ``shard`` ``global_emb`` and ``dynamic_tangent`` hold this rank's
    rows (the slow memory stays whole): the heads' and the neighbours' rows
    are gathered from their owners (``collectives.rows_of``), every rank
    computes the same fused rows, and the rank writes those of the heads it
    owns; the fused rows returned are the whole [B, d] on every rank."""
    heads = triples[:, 0]
    B, K = rb.nb_ents.shape
    d = cfg.h_dim
    nb = rb.nb_ents.reshape(-1)
    nb_t = H.clamp_tangent_norm(rows_of(dynamic_tangent, nb, shard), c)
    nb_t = torch.clamp(nb_t + slow_state.detach().index_select(0, nb), -CLAMP, CLAMP)
    nb_t = H.clamp_tangent_norm(nb_t, c).reshape(B, K, d)
    rl_t = H.clamp_tangent_norm(rel_tangent.index_select(0, rb.nb_rels.reshape(-1)),
                                c).reshape(B, K, d)
    tm_t = H.clamp_tangent_norm(time_delta_tangent(params, rb.deltas), c)

    q_tangent = H.log_map_zero(rows_of(global_emb, heads, shard), c)
    context_t = history_encoder_tangent(params, cfg, nb_t, rl_t, tm_t, q_tangent, rb.event_mask)
    fused_t = fuse_global_local_tangent(params, q_tangent, H.clamp_tangent_norm(context_t, c))
    # in the table's dtype under bf16 compute
    fused = H.project_to_ball(H.exp_map_zero(fused_t, c), c).to(global_emb.dtype)
    valid = rb.row_mask > 0
    if shard is not None:  # the heads this rank owns, at their local rows
        heads = heads - shard.row0
        valid = valid & (heads >= 0) & (heads < shard.rows)
    out = set_rows(global_emb, heads, valid, fused)
    if return_ctx_tangent:
        return out, H.clamp_tangent_norm(fused_t, c)
    return out


# ------------------------------------------------------------------ TANS

def build_true_tails_dict(snapshot_list: List[np.ndarray], num_rels: int):
    """(head, rel) -> sorted unique true tails, inverse triples included."""
    true_tails: Dict[Tuple[int, int], set] = {}
    for snapshot in snapshot_list:
        if snapshot is None or len(snapshot) == 0:
            continue
        for h, r, t in np.asarray(snapshot)[:, :3]:
            true_tails.setdefault((int(h), int(r)), set()).add(int(t))
            true_tails.setdefault((int(t), int(r) + num_rels), set()).add(int(h))
    return {k: np.asarray(sorted(v), dtype=np.int64) for k, v in true_tails.items()}


def tans_mask_coo(triples: np.ndarray, mask: np.ndarray, true_tails_by_hr: dict,
                  max_filter: int = 50, pad_bucket: int = 4096):
    """Padded COO (rows, cols) of the entity-score entries to squash to
    -1e9: for each valid row, up to ``max_filter`` other true tails of its
    (head, relation). Padding entries carry the out-of-range row B, which
    the squash drops; the length is a multiple of ``pad_bucket``."""
    B = len(triples)
    rows, cols = [], []
    for i in range(B):
        if mask[i] <= 0:
            continue
        h, r, t = int(triples[i][0]), int(triples[i][1]), int(triples[i][2])
        tails = true_tails_by_hr.get((h, r))
        if tails is None:
            continue
        tails = tails[tails != t][:max_filter]
        if len(tails):
            rows.append(np.full(len(tails), i, dtype=np.int64))
            cols.append(tails)
    n = sum(len(r) for r in rows)
    padded = max(((n + pad_bucket - 1) // pad_bucket) * pad_bucket, pad_bucket)
    out_rows = np.full(padded, B, dtype=np.int64)
    out_cols = np.zeros(padded, dtype=np.int64)
    if n:
        out_rows[:n] = np.concatenate(rows)
        out_cols[:n] = np.concatenate(cols)
    return out_rows, out_cols


def shard_tans_coo(rows: np.ndarray, cols: np.ndarray, batch: int, shard: RowShard):
    """:func:`tans_mask_coo`'s (rows, cols) cut to this rank's candidate
    columns ``row0 .. row0 + rows`` and shifted to them, for scores of the
    rank's candidates [B, rows]: an entry of another rank's column becomes
    padding (row ``batch``, which the squash drops). The length stays."""
    keep = (rows < batch) & (cols >= shard.row0) & (cols < shard.row0 + shard.rows)
    return np.where(keep, rows, batch), np.where(keep, cols - shard.row0, 0)


def squash_entries(scores: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``scores`` [B, N] with the COO entries set to -1e9 (JAX's
    ``scores.at[rows, cols].set(-1e9, mode="drop")``): rows >= B are
    padding and dropped; the squashed entries get no gradient."""
    B, N = scores.shape
    hit = torch.zeros((B + 1, N), dtype=torch.bool, device=scores.device)
    hit.index_put_((rows, cols), torch.ones((), dtype=torch.bool, device=scores.device))
    return scores.masked_fill(hit[:B], MASKED)
