"""Edge-partitioned RGCN aggregation over a mesh of ranks.

Counterpart of ``regcn_tpu/parallel/halo.py``. Each snapshot graph is
partitioned by DESTINATION entity shard, so the scatter-sum is entirely
shard-local; the only communication is the exchange of source-entity rows
that a shard's edges read from other shards:

- ``dist_agg="gspmd"`` (:func:`sharded_rgcn_aggregate`): every rank
  gathers every shard's rows (an all-gather of the [N, d] table a layer),
  as GSPMD does for JAX's sharded trainer and as JAX's
  ``sharded_rgcn_aggregate`` writes out;
- ``dist_agg="halo"`` (:func:`halo_rgcn_aggregate`): the boundary set, one
  ``all_to_all`` per layer of exactly the unique rows each other shard
  needs, padded to ``halo_per_pair`` per pair of ranks.

Host side (numpy, the arrays bit for bit JAX's): :func:`partition_edges_by_dst`,
:func:`partition_edges_boundary`, :func:`build_halo_store` and their
helpers. Device side: a rank takes its own slice of a partition as
:class:`LocalEdges` (:func:`local_parts`, :func:`local_halo`), its edges
sorted by local destination row, with masked edges keyed past the last row,
as kernel B1 needs. Both aggregations then gather each edge's message from
one table (the gathered [N, d] table, or the rank's rows followed by the
halo buffer) and sum them with ONE launch of B1
(``regcn_torch/ops/rgcn_scatter.py:scatter_add_sorted``) per layer and
snapshot, as many as the unsharded path launches. The interior/remote
split of JAX's halo partition becomes the order of that one edge list:
interior edges first, then remote ones, for each destination. The
aggregations other than the sum (the hyperbolic encoders' midpoint,
centroid and attention) take the same exchange with a local function
(:func:`halo_local_aggregate`, :func:`sharded_local_aggregate`); the
layers of all three families reach these through :func:`mesh_edges`,
:func:`mesh_rgcn_aggregate` and :func:`mesh_local_aggregate`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from regcn_torch.dist import HaloImpl, require_halo, require_parts
from regcn_torch.ops.rgcn_scatter import cumsum_segment_sum, scatter_add_sorted
from regcn_torch.parallel.collectives import all_gather_rows, all_to_all
from regcn_torch.parallel.mesh import graph_group, graph_rank, graph_size, table_shard
from regcn_torch.utils.dtypes import dot_f32

# ------------------------------------------------------------------ host side


@dataclasses.dataclass
class PartitionedEdges:
    """Edges partitioned by destination shard, padded per shard (numpy).

    Shapes [G, E_s] (a leading [S] with :func:`build_partition_store`);
    ``dst_local`` is the row index within the owning shard. Built host-side
    by :func:`partition_edges_by_dst`.
    """

    src: np.ndarray  # [G, E_s] global source ids
    dst_local: np.ndarray  # [G, E_s] local destination row
    rel: np.ndarray  # [G, E_s]
    edge_mask: np.ndarray  # [G, E_s]
    in_deg_norm: np.ndarray  # [G, rows_per_shard]
    has_in_edge: np.ndarray  # [G, rows_per_shard]
    rows_per_shard: int


def partition_edges_by_dst(
    triples: np.ndarray, num_nodes: int, num_rels: int, num_shards: int,
    edge_bucket: int = 256,
) -> PartitionedEdges:
    """Host-side: inverse edges + degree norms + per-dst-shard split."""
    triples = np.asarray(triples)[:, :3].astype(np.int64)
    s, r, o = triples[:, 0], triples[:, 1], triples[:, 2]
    src = np.concatenate([s, o]).astype(np.int32)
    dst = np.concatenate([o, s]).astype(np.int32)
    rel = np.concatenate([r, r + num_rels]).astype(np.int32)

    rows = -(-num_nodes // num_shards)  # ceil: rows per shard
    in_deg = np.bincount(dst, minlength=num_shards * rows).astype(np.float32)
    shard_of = dst // rows
    dst_local = dst % rows

    per_shard = [np.flatnonzero(shard_of == g) for g in range(num_shards)]
    e_max = max((len(ix) for ix in per_shard), default=1)
    E_s = max(((e_max + edge_bucket - 1) // edge_bucket) * edge_bucket, edge_bucket)

    def pad2(vals_list, dtype, fill=0):
        out = np.full((num_shards, E_s), fill, dtype=dtype)
        for g, ix in enumerate(per_shard):
            out[g, : len(ix)] = vals_list[ix]
        return out

    mask = np.zeros((num_shards, E_s), np.float32)
    for g, ix in enumerate(per_shard):
        mask[g, : len(ix)] = 1.0

    in_deg_2d = in_deg.reshape(num_shards, rows)
    return PartitionedEdges(
        src=pad2(src, np.int32),
        dst_local=pad2(dst_local, np.int32),
        rel=pad2(rel, np.int32),
        edge_mask=mask,
        in_deg_norm=1.0 / np.maximum(in_deg_2d, 1.0),
        has_in_edge=(in_deg_2d > 0).astype(np.float32),
        rows_per_shard=rows,
    )


def build_partition_store(snap_list: List[np.ndarray], num_nodes: int, num_rels: int,
                          num_shards: int, edge_bucket: int = 256) -> PartitionedEdges:
    """:func:`partition_edges_by_dst` of every snapshot, stacked with a
    leading [S] axis at the largest ``E_s`` of them (the extra slots
    masked), as :func:`build_halo_store` stacks the boundary partitions: the
    ``dist_agg="gspmd"`` window of the port, where JAX needs none."""
    parts = [partition_edges_by_dst(t, num_nodes, num_rels, num_shards, edge_bucket)
             for t in snap_list]
    E = max(p.src.shape[1] for p in parts)

    def stack(name):
        return np.stack([np.pad(getattr(p, name), ((0, 0), (0, E - p.src.shape[1])))
                         for p in parts])

    return PartitionedEdges(
        src=stack("src"), dst_local=stack("dst_local"), rel=stack("rel"),
        edge_mask=stack("edge_mask"),
        in_deg_norm=np.stack([p.in_deg_norm for p in parts]),
        has_in_edge=np.stack([p.has_in_edge for p in parts]),
        rows_per_shard=parts[0].rows_per_shard)


@dataclasses.dataclass
class HaloPartitionedEdges:
    """Destination-sharded edges with a BOUNDARY-SET halo (numpy).

    Interior edges (source owned by the destination shard) read the local
    rows directly; remote edges read a compact halo buffer assembled by a
    single ``all_to_all``: owner ``g`` sends requester ``q`` exactly the
    unique source rows q's edges need from g (``send_idx[g, q]``), padded
    to ``halo_per_pair``. Per-shard comm volume is ``G * P * d`` rows
    instead of the all-gather's ``N * d``. Built host-side by
    :func:`partition_edges_boundary`.
    """

    int_src_local: np.ndarray  # [G, Ei] local row of the source
    int_dst_local: np.ndarray  # [G, Ei]
    int_rel: np.ndarray  # [G, Ei]
    int_mask: np.ndarray  # [G, Ei]
    rem_src_halo: np.ndarray  # [G, Er] index into the [G*P] halo buffer
    rem_dst_local: np.ndarray  # [G, Er]
    rem_rel: np.ndarray  # [G, Er]
    rem_mask: np.ndarray  # [G, Er]
    send_idx: np.ndarray  # [G owners, G requesters, P] local row ids
    in_deg_norm: np.ndarray  # [G, rows_per_shard]
    has_in_edge: np.ndarray  # [G, rows_per_shard]
    rows_per_shard: int
    halo_per_pair: int


def _boundary_core(triples: np.ndarray, num_nodes: int, num_rels: int,
                   num_shards: int) -> dict:
    """Host-side partition of one snapshot's edges into interior/remote
    per-destination-shard lists plus the per-(owner, requester) unique
    source-row need tables. Pure numpy; packing/bucketing happens in
    :func:`_pack_boundary` so a whole split can share bucket sizes."""
    triples = np.asarray(triples)
    triples = triples.reshape(-1, triples.shape[-1] if triples.ndim > 1 else 3)
    triples = triples[:, :3].astype(np.int64)
    s, r, o = triples[:, 0], triples[:, 1], triples[:, 2]
    src = np.concatenate([s, o]).astype(np.int32)
    dst = np.concatenate([o, s]).astype(np.int32)
    rel = np.concatenate([r, r + num_rels]).astype(np.int32)

    G = num_shards
    rows = -(-num_nodes // G)
    in_deg = np.bincount(dst, minlength=G * rows).astype(np.float32)
    owner_src = src // rows
    shard_of = dst // rows

    int_lists, rem_lists = [], []  # per shard: (src_local/halo, dst_local, rel)
    need_per_pair = [[np.empty(0, np.int64)] * G for _ in range(G)]
    for q in range(G):
        ix = np.flatnonzero(shard_of == q)
        own = owner_src[ix] == q
        ii = ix[own]
        ri = ix[~own]
        int_lists.append((src[ii] % rows, dst[ii] % rows, rel[ii]))
        # per-owner unique needed rows + halo-local edge indices
        halo_idx = np.zeros(len(ri), np.int64)
        for g in range(G):
            sel = owner_src[ri] == g
            uniq, inv = np.unique(src[ri[sel]], return_inverse=True)
            need_per_pair[g][q] = uniq % rows
            halo_idx[sel] = inv  # position within (g, q)'s block; offset later
        rem_lists.append((halo_idx, dst[ri] % rows, rel[ri], owner_src[ri]))

    return {
        "int_lists": int_lists,
        "rem_lists": rem_lists,
        "need_per_pair": need_per_pair,
        "in_deg_2d": in_deg.reshape(G, rows),
        "rows": rows,
        "max_int": max((len(t[0]) for t in int_lists), default=1),
        "max_rem": max((len(t[0]) for t in rem_lists), default=1),
        "max_pair": max((len(need_per_pair[g][q])
                         for g in range(G) for q in range(G)), default=1),
    }


def _pack_boundary(core: dict, G: int, Ei: int, Er: int, P: int) -> dict:
    """Pad/pack one snapshot's core partition into fixed-size numpy
    arrays (field dict mirroring :class:`HaloPartitionedEdges`)."""
    send_idx = np.zeros((G, G, P), np.int32)
    for g in range(G):
        for q in range(G):
            u = core["need_per_pair"][g][q]
            send_idx[g, q, : len(u)] = u

    def pack(lists, E, cols):
        out = [np.zeros((G, E), np.int32) for _ in range(cols)]
        mask = np.zeros((G, E), np.float32)
        for g, vals in enumerate(lists):
            k = len(vals[0])
            for c in range(cols):
                out[c][g, :k] = vals[c]
            mask[g, :k] = 1.0
        return out, mask

    (i_src, i_dst, i_rel), i_mask = pack(core["int_lists"], Ei, 3)
    rem_packed = []
    for halo_idx, dstl, relv, owners in core["rem_lists"]:
        rem_packed.append((owners * P + halo_idx, dstl, relv))
    (r_src, r_dst, r_rel), r_mask = pack(rem_packed, Er, 3)
    in_deg_2d = core["in_deg_2d"]
    return {
        "int_src_local": i_src, "int_dst_local": i_dst,
        "int_rel": i_rel, "int_mask": i_mask,
        "rem_src_halo": r_src, "rem_dst_local": r_dst,
        "rem_rel": r_rel, "rem_mask": r_mask,
        "send_idx": send_idx,
        "in_deg_norm": 1.0 / np.maximum(in_deg_2d, 1.0),
        "has_in_edge": (in_deg_2d > 0).astype(np.float32),
    }


def _boundary_stats(core: dict, G: int, P: int, num_nodes: int) -> dict:
    rows = core["rows"]
    boundary_rows = sum(len(core["need_per_pair"][g][q])
                        for g in range(G) for q in range(G))
    return {
        "boundary_rows_total": boundary_rows,
        "boundary_fraction_of_N": boundary_rows / max(num_nodes, 1),
        "halo_rows_per_shard": G * P,
        "allgather_rows_per_shard": G * rows,
        "volume_ratio_vs_allgather": (G * P) / max(G * rows, 1),
    }


def _bucketed(n: int, bucket: int) -> int:
    return max(((n + bucket - 1) // bucket) * bucket, bucket)


def partition_edges_boundary(
    triples: np.ndarray, num_nodes: int, num_rels: int, num_shards: int,
    edge_bucket: int = 256, halo_bucket: int = 64,
) -> Tuple[HaloPartitionedEdges, dict]:
    """Host-side boundary-halo partition. Returns (edges, stats) where
    stats records the measured boundary-set sizes vs N."""
    G = num_shards
    core = _boundary_core(triples, num_nodes, num_rels, G)
    P = _bucketed(core["max_pair"], halo_bucket)
    Ei = _bucketed(core["max_int"], edge_bucket)
    Er = _bucketed(core["max_rem"], edge_bucket)
    fields = _pack_boundary(core, G, Ei, Er, P)
    edges = HaloPartitionedEdges(**fields, rows_per_shard=core["rows"], halo_per_pair=P)
    return edges, _boundary_stats(core, G, P, num_nodes)


def build_halo_store(
    snap_list: List[np.ndarray], num_nodes: int, num_rels: int,
    num_shards: int, pad_front: int = 0,
    edge_bucket: int = 256, halo_bucket: int = 64,
) -> Tuple[HaloPartitionedEdges, dict]:
    """Stacked halo partitions for a whole split: every array field gains
    a leading ``[S]`` axis (``S = pad_front + len(snap_list)``) with
    bucket sizes shared across snapshots. ``pad_front`` prepends empty
    (all-masked) partitions, as JAX's store prepends empty identity
    snapshots.

    Returns (stacked edges, stats) where stats aggregates the measured
    per-snapshot boundary sizes (mean/max ``boundary_fraction_of_N``,
    halo-vs-allgather volume ratio).
    """
    G = num_shards
    empty = np.zeros((0, 3), np.int64)
    cores = [_boundary_core(t, num_nodes, num_rels, G)
             for t in [empty] * pad_front + list(snap_list)]
    P = _bucketed(max(c["max_pair"] for c in cores), halo_bucket)
    Ei = _bucketed(max(c["max_int"] for c in cores), edge_bucket)
    Er = _bucketed(max(c["max_rem"] for c in cores), edge_bucket)
    packed = [_pack_boundary(c, G, Ei, Er, P) for c in cores]
    stacked = {k: np.stack([p[k] for p in packed]) for k in packed[0]}
    edges = HaloPartitionedEdges(**stacked, rows_per_shard=cores[0]["rows"], halo_per_pair=P)
    per_snap = [_boundary_stats(c, G, P, num_nodes)
                for c in cores[pad_front:]]
    fracs = [s["boundary_fraction_of_N"] for s in per_snap] or [0.0]
    stats = {
        "num_snapshots": len(snap_list),
        "num_shards": G,
        "boundary_fraction_of_N_mean": float(np.mean(fracs)),
        "boundary_fraction_of_N_max": float(np.max(fracs)),
        "halo_rows_per_shard": G * P,
        "allgather_rows_per_shard": G * cores[0]["rows"],
        "volume_ratio_vs_allgather": (G * P) / max(G * cores[0]["rows"], 1),
    }
    return edges, stats


# ---------------------------------------------------------------- device side

_LOCAL_ARRAYS = ("src", "dst", "rel", "edge_mask", "in_deg_norm", "has_in_edge", "send_idx")


@dataclasses.dataclass
class LocalEdges:
    """One rank's edges of a snapshot (or a [T, ...] window of them), sorted
    by ``dst`` with masked edges last, as B1 takes them.

    ``src`` indexes the table the messages are gathered from: the
    all-gathered [N, d] table (gspmd: global ids), or the rank's rows
    followed by the [G * P, d] halo buffer (halo: local rows, then
    ``rows + `` the halo slot). ``dst`` is the local destination row.
    ``send_idx`` [G, P] (halo only) holds the local rows this rank sends
    each rank."""

    src: torch.Tensor  # [E]
    dst: torch.Tensor  # [E]
    rel: torch.Tensor  # [E]
    edge_mask: torch.Tensor  # [E]
    in_deg_norm: torch.Tensor  # [rows]
    has_in_edge: torch.Tensor  # [rows]
    send_idx: Optional[torch.Tensor]  # [G, P] or None
    rows: int

    def to(self, device) -> "LocalEdges":
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _LOCAL_ARRAYS if getattr(self, f) is not None})

    def step(self, t: int) -> "LocalEdges":
        return dataclasses.replace(self, **{
            f: getattr(self, f)[t] for f in _LOCAL_ARRAYS if getattr(self, f) is not None})


def _sorted_by_key(src, dst, rel, mask, rows) -> tuple:
    """The edges of each step (rows of the [T, E] arrays) in ascending key
    order, key = dst for a real edge and ``rows`` for a masked one, stable:
    each destination's edges keep their order."""
    keys = np.where(mask > 0, dst, rows)
    order = np.argsort(keys, axis=-1, kind="stable")
    return tuple(np.take_along_axis(a, order, axis=-1) for a in (src, dst, rel, mask))


def _local(src, dst, rel, mask, norm, has_in, send_idx, rows) -> LocalEdges:
    src, dst, rel, mask = _sorted_by_key(src, dst, rel, mask, rows)
    return LocalEdges(
        src=torch.from_numpy(src.astype(np.int64)), dst=torch.from_numpy(dst.astype(np.int64)),
        rel=torch.from_numpy(rel.astype(np.int64)),
        edge_mask=torch.from_numpy(mask.astype(np.float32)),
        in_deg_norm=torch.from_numpy(np.ascontiguousarray(norm, np.float32)),
        has_in_edge=torch.from_numpy(np.ascontiguousarray(has_in, np.float32)),
        send_idx=None if send_idx is None else torch.from_numpy(send_idx.astype(np.int64)),
        rows=rows)


def local_parts(parts: PartitionedEdges, rank: int) -> LocalEdges:
    """Shard ``rank`` of a destination partition ([G, E] or [S, G, E]) as
    :class:`LocalEdges` (CPU tensors)."""
    return _local(parts.src[..., rank, :], parts.dst_local[..., rank, :],
                  parts.rel[..., rank, :], parts.edge_mask[..., rank, :],
                  parts.in_deg_norm[..., rank, :], parts.has_in_edge[..., rank, :], None,
                  parts.rows_per_shard)


def local_halo(halo: HaloPartitionedEdges, rank: int) -> LocalEdges:
    """Shard ``rank`` of a boundary partition ([G, ...] or [S, G, ...]) as
    :class:`LocalEdges` (CPU tensors): the interior edges read the local
    rows, the remote ones row ``rows + rem_src_halo`` of the rank's rows
    followed by its halo buffer."""
    rows = halo.rows_per_shard

    def cat(a, b):
        return np.concatenate([a, b], axis=-1)

    return _local(
        cat(halo.int_src_local[..., rank, :], rows + halo.rem_src_halo[..., rank, :]),
        cat(halo.int_dst_local[..., rank, :], halo.rem_dst_local[..., rank, :]),
        cat(halo.int_rel[..., rank, :], halo.rem_rel[..., rank, :]),
        cat(halo.int_mask[..., rank, :], halo.rem_mask[..., rank, :]),
        halo.in_deg_norm[..., rank, :], halo.has_in_edge[..., rank, :],
        halo.send_idx[..., rank, :, :], rows)


def _aggregate(table, rel_emb, weight, edges: LocalEdges, edge_weight=None,
               cumsum: bool = False) -> torch.Tensor:
    """``norm_v * sum_{dst_e = v} w_e (table[src_e] + rel_emb[rel_e]) @ W``
    over the rank's rows, the sum on B1 (one launch); with ``cumsum`` the
    cumulative-sum reduction over the rank's sorted edges instead (no edge
    weight), as ``impl="cumsum"`` takes on one device."""
    msg = dot_f32(table[edges.src] + rel_emb[edges.rel], weight)
    if cumsum:
        if edge_weight is not None:
            raise ValueError("impl='cumsum' takes no edge weight")
        agg = cumsum_segment_sum(msg * edges.edge_mask.float()[:, None], edges.dst, edges.rows)
        return agg * edges.in_deg_norm.float()[:, None]
    keys = torch.where(edges.edge_mask > 0, edges.dst, edges.rows).to(torch.int32)
    w = edges.edge_mask.float() if edge_weight is None else \
        edge_weight.float() * edges.edge_mask.float()
    return scatter_add_sorted(msg, keys, edges.rows, edge_weight=w.contiguous(),
                              row_scale=edges.in_deg_norm.float().contiguous())


def _edge_weight(table, src, dst, row_scalar_fn, edge_weight_fn) -> Optional[torch.Tensor]:
    """``edge_weight_fn(s[src], s[dst])`` of the per-row scalars ``s =
    row_scalar_fn(table)``: O(rows) scalars, gathered per edge."""
    if edge_weight_fn is None:
        return None
    s = row_scalar_fn(table)
    return edge_weight_fn(s[src], s[dst])


def _check_rows(mesh, h: torch.Tensor, edges: LocalEdges) -> None:
    if h.shape[0] != edges.rows:
        raise ValueError(f"the rank holds {h.shape[0]} rows, its edges expect {edges.rows} "
                         f"(num_ents must divide by the mesh's {graph_size(mesh)} shards)")


def sharded_rgcn_aggregate(
    mesh,
    h: torch.Tensor,  # [rows, d] this rank's entity states
    rel_emb: torch.Tensor,  # [2R, d] replicated
    weight: torch.Tensor,  # [d, d] replicated
    edges: LocalEdges,  # this rank's edges (global sources)
    *,
    row_scalar_fn=None,  # rows [n, d] -> [n] per-row scalar (e.g. radius)
    edge_weight_fn=None,  # (scalar_src [E], scalar_dst [E]) -> [E] weight
    cumsum: bool = False,  # the cumulative-sum reduction instead of B1
) -> torch.Tensor:
    """Shard-local scatter with an all-gather of the source rows (JAX's
    ``sharded_rgcn_aggregate``; what GSPMD inserts for its trainer): the
    rank's aggregated [rows, d] rows, in ``h``'s dtype. ``row_scalar_fn`` /
    ``edge_weight_fn`` as in :func:`halo_rgcn_aggregate`, the scalars taken
    of the gathered table (a destination is row ``row0 + dst`` there).
    ``cumsum`` reduces the rank's edges by their cumulative sum: JAX's
    runs over the whole sorted edge array, this over the rank's, so the
    two round apart (shorter prefixes here)."""
    _check_rows(mesh, h, edges)
    h_full = all_gather_rows(h, graph_group(mesh))  # [G * rows, d]
    row0 = graph_rank(mesh) * edges.rows
    w = _edge_weight(h_full, edges.src, edges.dst + row0, row_scalar_fn, edge_weight_fn)
    return _aggregate(h_full, rel_emb, weight, edges, w, cumsum).to(h.dtype)


def halo_buffer(mesh, h: torch.Tensor, edges: LocalEdges) -> torch.Tensor:
    """[rows + G * P, d]: the rank's rows, then the rows the other ranks
    sent it, rank g's block at ``rows + g * P`` (one ``all_to_all``)."""
    send = h[edges.send_idx]  # [G requesters, P, d]
    halo = all_to_all(send, graph_group(mesh))
    return torch.cat([h, halo.reshape(-1, h.shape[1])], dim=0)


def _run_local(edges: LocalEdges, local_fn: Callable, hbuf: torch.Tensor, src: torch.Tensor
               ) -> torch.Tensor:
    return local_fn(hbuf, src, edges.dst, edges.edge_mask, edges.rel, edges.in_deg_norm,
                    edges.has_in_edge, edges.rows)


def halo_local_aggregate(mesh, h: torch.Tensor, edges: LocalEdges,
                         local_fn: Callable) -> torch.Tensor:
    """Generic boundary-halo exchange + shard-local aggregation, for every
    aggregation other than the sum (the hyperbolic encoders' weighted
    segment reductions), as JAX's.

    ``local_fn(hbuf, src, dst, mask, rel, norm, has_in, rows)`` runs on the
    rank and must return ``[rows, d_out]``: ``hbuf`` [rows + G*P, d] is the
    rank's rows followed by the received halo buffer; ``src`` [E] indexes
    ``hbuf``, ``dst`` / ``mask`` / ``rel`` [E] with ``dst`` local (sorted,
    masked edges last), so ``hbuf[dst]`` is the destination's row;
    ``norm`` / ``has_in`` [rows]."""
    _check_rows(mesh, h, edges)
    return _run_local(edges, local_fn, halo_buffer(mesh, h, edges), edges.src)


def sharded_local_aggregate(mesh, h: torch.Tensor, edges: LocalEdges,
                            local_fn: Callable) -> torch.Tensor:
    """The ``dist_agg="gspmd"`` counterpart of :func:`halo_local_aggregate`
    (what GSPMD makes of JAX's dense layer): an all-gather of the rows,
    then ``local_fn`` over the rank's destination partition, with the same
    contract: ``hbuf`` [rows + N, d] is the rank's rows followed by the
    gathered table, ``src`` indexes it (``rows +`` the global id)."""
    _check_rows(mesh, h, edges)
    hbuf = torch.cat([h, all_gather_rows(h, graph_group(mesh))], dim=0)
    return _run_local(edges, local_fn, hbuf, edges.src + edges.rows)


def halo_rgcn_aggregate(
    mesh,
    h: torch.Tensor,  # [rows, d] this rank's entity states
    rel_emb: torch.Tensor,  # [2R, d] replicated
    weight: torch.Tensor,  # [d, d] replicated
    edges: LocalEdges,  # this rank's edges (halo buffer sources)
    *,
    row_scalar_fn=None,  # rows [n, d] -> [n] per-row scalar (e.g. radius)
    edge_weight_fn=None,  # (scalar_src [E], scalar_dst [E]) -> [E] weight
) -> torch.Tensor:
    """Boundary-set halo exchange, then the rank's aggregation in one B1
    launch over its interior and remote edges together.

    ``row_scalar_fn`` / ``edge_weight_fn`` support radius-weighted messages
    (the hyperbolic union layers): scalars are computed per ROW of the
    rank's rows and halo buffer and gathered per edge, so the extra cost is
    O(rows) not O(E·d). Messages accumulate in fp32 and return in
    ``h.dtype``."""
    _check_rows(mesh, h, edges)
    hbuf = halo_buffer(mesh, h, edges)
    w = _edge_weight(hbuf, edges.src, edges.dst, row_scalar_fn, edge_weight_fn)
    return _aggregate(hbuf, rel_emb, weight, edges, w).to(h.dtype)


# ------------------------------------------------ the layers' entry points


def mesh_edges(impl, snap) -> LocalEdges:
    """The rank's partition of ``snap``'s edges that ``impl`` (a sharded
    marker of ``regcn_torch/dist.py``) aggregates over, or a loud error."""
    return require_halo(snap) if isinstance(impl, HaloImpl) else require_parts(snap)


def mesh_rgcn_aggregate(impl, h, rel_emb, weight, edges: LocalEdges, **weight_fns):
    """:func:`halo_rgcn_aggregate` or :func:`sharded_rgcn_aggregate`, as
    ``impl`` selects: one B1 launch over the rank's edges."""
    if isinstance(impl, HaloImpl):
        return halo_rgcn_aggregate(impl.mesh, h, rel_emb, weight, edges, **weight_fns)
    return sharded_rgcn_aggregate(impl.mesh, h, rel_emb, weight, edges,
                                  cumsum=impl.route == "cumsum", **weight_fns)


def mesh_local_aggregate(impl, h, edges: LocalEdges, local_fn: Callable) -> torch.Tensor:
    """:func:`halo_local_aggregate` or :func:`sharded_local_aggregate`, as
    ``impl`` selects."""
    fn = halo_local_aggregate if isinstance(impl, HaloImpl) else sharded_local_aggregate
    return fn(impl.mesh, h, edges, local_fn)


def table_rows(impl, h: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(the whole table's rows, this rank's first) where ``h`` holds this
    rank's rows under a sharded ``impl``, else None: the ``rows`` argument
    of ``inverted_dropout``, which draws the whole table's mask."""
    shard = table_shard(impl, h.shape[0])
    return None if shard is None else (shard.n, shard.row0)
