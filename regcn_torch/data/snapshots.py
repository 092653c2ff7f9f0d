"""Snapshot graph construction as flat padded edge arrays.

Counterpart of ``regcn_tpu/data/snapshots.py``. The host builds every
array, with the native C++ builder by default (``native.py``) or numpy;
:meth:`Snapshot.to` then makes the tensors on a device in one step.

Semantics (ref:rgcn/utils.py:78-134):
- inverse edges: for every triple (s, r, o) an edge s->o with type r and
  o->s with type r+R;
- message normalisation is 1/in_degree of the destination node, with
  isolated nodes clamped to 1;
- the relation-context incidence: for every base relation r present in
  the snapshot, the set of entities incident to r-edges (or, for HisRES,
  their sources only), shared by r and r+R, as a flat (rel_id, ent_id)
  pair list.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np
import torch

_ARRAY_FIELDS = ("src", "dst", "rel", "edge_mask", "in_deg_norm", "has_in_edge",
                 "rc_rel", "rc_ent", "rc_mask")
_INDEX_FIELDS = ("src", "dst", "rel", "rc_rel", "rc_ent")
_SHARD_FIELDS = ("halo", "parts")


def _round_up(n: int, multiple: int) -> int:
    if multiple <= 1:
        return max(n, 1)
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


@dataclasses.dataclass
class Snapshot:
    """One timestamp's padded graph (or a [T, ...] stack of them).

    build_snapshot and build_history return host numpy arrays with the
    dtypes below; :meth:`to` returns the same snapshot as tensors
    (indices int64).
    Shapes: E = padded edge count (2x triples, inverses included),
    M = padded relation-context pair count, N = num_nodes.
    """

    src: np.ndarray  # [E] int32, padded with 0
    dst: np.ndarray  # [E] int32, padded with 0
    rel: np.ndarray  # [E] int32 in [0, 2R), padded with 0
    edge_mask: np.ndarray  # [E] float32 {0,1}
    in_deg_norm: np.ndarray  # [N] float32: 1/max(in_deg,1)
    has_in_edge: np.ndarray  # [N] float32 {0,1}: in_deg > 0
    rc_rel: np.ndarray  # [M] int32 relation id in [0, 2R)
    rc_ent: np.ndarray  # [M] int32 entity id
    rc_mask: np.ndarray  # [M] float32 {0,1}
    num_edges: int  # unpadded edges
    num_triples: int  # unpadded triples
    # True when the real edges are stored destination-sorted (padded tail
    # last): the scatter kernel then needs no argsort. build_snapshot sets
    # it; hand-built snapshots default to the safe False.
    dst_sorted: bool = False
    # on an entity-sharded mesh, the rank's own edges of the same snapshots
    # (``regcn_torch.parallel.halo.LocalEdges``): the boundary-halo partition
    # (``halo``, dist_agg="halo") or the destination partition (``parts``,
    # dist_agg="gspmd"); None on one device
    halo: Any = None
    parts: Any = None

    def to(self, device) -> "Snapshot":
        """The same snapshot as tensors on ``device``."""
        fields = {}
        for f in _ARRAY_FIELDS:
            a = getattr(self, f)
            a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
            a = a.long() if f in _INDEX_FIELDS else a.float()
            fields[f] = a.to(device)
        for f in _SHARD_FIELDS:
            if getattr(self, f) is not None:
                fields[f] = getattr(self, f).to(device)
        return dataclasses.replace(self, **fields)

    def step(self, t: int) -> "Snapshot":
        """Step ``t`` of a stacked [T, ...] history."""
        fields = {f: getattr(self, f)[t] for f in _ARRAY_FIELDS}
        for f in _SHARD_FIELDS:
            if getattr(self, f) is not None:
                fields[f] = getattr(self, f).step(t)
        return dataclasses.replace(self, **fields)


def split_by_time(data: np.ndarray) -> List[np.ndarray]:
    """Group time-ordered quads [N,4] into per-timestamp triple arrays [n,3].

    Parity with ref:rgcn/utils.py:306-339 (which assumes the input is
    sorted by time and emits snapshots in order of first appearance).
    """
    data = np.asarray(data)
    if data.size == 0:
        return []
    snapshots: List[np.ndarray] = []
    current: List[np.ndarray] = []
    latest_t = 0
    for row in data:
        t = row[3]
        if latest_t != t:
            latest_t = t
            if current:
                snapshots.append(np.array(current, dtype=np.int64)[:, :3])
            current = []
        current.append(row)
    if current:
        snapshots.append(np.array(current, dtype=np.int64)[:, :3])
    return snapshots


def _relation_context_pairs(triples: np.ndarray, num_rels: int, rc_mode: str = "both"):
    """Unique (relation, entity) incidence pairs including inverse relations.

    rc_mode="both", parity with ref:rgcn/utils.py:78-97: r_to_e[r] is the
    *set* of entities incident to base-relation-r triples (both
    endpoints), and r+R maps to the same set.

    rc_mode="src", parity with the HisRES variant's r2e
    (ref:hisres_rgcn/utils.py:71-88): only the source entity, for r and
    for r+R alike.
    """
    s, r, o = triples[:, 0], triples[:, 1], triples[:, 2]
    if rc_mode == "src":
        parts = [np.stack([r, s], axis=1), np.stack([r + num_rels, s], axis=1)]
    elif rc_mode == "both":
        parts = [
            np.stack([r, s], axis=1),
            np.stack([r, o], axis=1),
            np.stack([r + num_rels, s], axis=1),
            np.stack([r + num_rels, o], axis=1),
        ]
    else:
        raise ValueError(f"rc_mode must be 'both' or 'src', got {rc_mode!r}")
    pairs = np.unique(np.concatenate(parts, axis=0), axis=0)
    return pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)


def build_snapshot(
    triples: np.ndarray,
    num_nodes: int,
    num_rels: int,
    edge_pad: int | None = None,
    rc_pad: int | None = None,
    edge_bucket: int = 1024,
    rc_bucket: int = 1024,
    use_native: bool | None = None,
    rc_mode: str = "both",
) -> Snapshot:
    """Build a padded flat-array snapshot graph from [n,3] (s,r,o) triples;
    ``rc_mode`` picks the relation-context incidence
    (:func:`_relation_context_pairs`).

    ``use_native`` True or None (the default) builds the arrays with the
    C++ builder (``regcn_torch/data/native.py``, compiled at first use),
    False with numpy; given the same padding the two are bit-identical.
    Without ``rc_pad`` the native builder pads the relation context to
    ``4 n`` rounded up to ``rc_bucket`` and numpy to the unique pairs'
    count rounded up, as JAX's two builders do. Where the module cannot be
    built (no C++ compiler, a failed build) or has an older signature,
    ``None`` takes numpy, with numpy's padding, after a warning (once a
    process for a build), and True raises, as in JAX; an error inside a
    call of a built module raises either way."""
    triples = np.asarray(triples)[:, :3].astype(np.int64)
    n = len(triples)
    if use_native is not False:
        from regcn_torch.data import native

        E = edge_pad if edge_pad is not None else _round_up(2 * n, edge_bucket)
        M = rc_pad if rc_pad is not None else _round_up(4 * n, rc_bucket)
        try:
            (src, dst, rel, emask, norm, has_in, rc_r, rc_e, rc_m, e, nn) = (
                native.build_snapshot_arrays(triples, num_nodes, num_rels, E, M,
                                             1 if rc_mode == "src" else 0))
        except native.StaleNativeError:
            if use_native is True:
                raise
        except native.NativeBuildError as exc:
            if use_native is True:
                raise
            native.warn_numpy_fallback(exc)
        else:
            return Snapshot(src=src, dst=dst, rel=rel, edge_mask=emask, in_deg_norm=norm,
                            has_in_edge=has_in, rc_rel=rc_r, rc_ent=rc_e, rc_mask=rc_m,
                            num_edges=int(e), num_triples=int(nn), dst_sorted=True)
    s, r, o = triples[:, 0], triples[:, 1], triples[:, 2]

    src = np.concatenate([s, o]).astype(np.int32)
    dst = np.concatenate([o, s]).astype(np.int32)
    rel = np.concatenate([r, r + num_rels]).astype(np.int32)
    e = len(src)

    # destination-sort the real edges (stable; padded tail stays last) so
    # the scatter kernel consumes them without an argsort
    order = np.argsort(dst, kind="stable")
    src, dst, rel = src[order], dst[order], rel[order]

    in_deg = np.bincount(dst, minlength=num_nodes).astype(np.float32)
    has_in = (in_deg > 0).astype(np.float32)
    in_deg_norm = 1.0 / np.maximum(in_deg, 1.0)

    rc_rel, rc_ent = _relation_context_pairs(triples, num_rels, rc_mode)
    m = len(rc_rel)

    E = edge_pad if edge_pad is not None else _round_up(e, edge_bucket)
    M = rc_pad if rc_pad is not None else _round_up(m, rc_bucket)
    if E < e or M < m:
        raise ValueError(f"padding too small: edges {e}>{E} or rc {m}>{M}")

    def pad(a: np.ndarray, size: int, fill=0):
        out = np.full((size,), fill, dtype=a.dtype)
        out[: len(a)] = a
        return out

    edge_mask = np.zeros((E,), np.float32)
    edge_mask[:e] = 1.0
    rc_mask = np.zeros((M,), np.float32)
    rc_mask[:m] = 1.0

    return Snapshot(
        src=pad(src, E),
        dst=pad(dst, E),
        rel=pad(rel, E),
        edge_mask=edge_mask,
        in_deg_norm=in_deg_norm,
        has_in_edge=has_in,
        rc_rel=pad(rc_rel, M),
        rc_ent=pad(rc_ent, M),
        rc_mask=rc_mask,
        num_edges=e,
        num_triples=n,
        dst_sorted=True,
    )


def stack_history(snaps: Sequence[Snapshot]) -> Snapshot:
    """Stack T same-padding snapshots into [T, ...] arrays."""
    if not snaps:
        raise ValueError("empty history")
    fields = {f: np.stack([getattr(sn, f) for sn in snaps], axis=0) for f in _ARRAY_FIELDS}
    return Snapshot(
        num_edges=max(sn.num_edges for sn in snaps),
        num_triples=max(sn.num_triples for sn in snaps),
        dst_sorted=all(sn.dst_sorted for sn in snaps),
        **fields,
    )


def build_history(
    snapshots: Sequence[np.ndarray],
    num_nodes: int,
    num_rels: int,
    edge_bucket: int = 1024,
    rc_bucket: int = 1024,
    rc_mode: str = "both",
    use_native: bool | None = None,
) -> Snapshot:
    """Build + stack a history window, padding all steps to the window max
    (``use_native`` as in :func:`build_snapshot`)."""
    edge_pad = _round_up(max(2 * len(t) for t in snapshots), edge_bucket)
    # rc pairs <= 4 * triples
    rc_pad = _round_up(4 * max(len(t) for t in snapshots), rc_bucket)
    return stack_history([
        build_snapshot(t, num_nodes, num_rels, edge_pad=edge_pad, rc_pad=rc_pad, rc_mode=rc_mode,
                       use_native=use_native)
        for t in snapshots
    ])


def pad_triples(triples: np.ndarray, num_rels: int, bucket: int = 512):
    """Add inverse triples and pad: returns (all_triples [B,3] int32, mask [B]).

    Parity with ref:src/rrgcn.py:209-211 (inverse triples appended with
    relation id shifted by R).
    """
    triples = np.asarray(triples)[:, :3].astype(np.int64)
    inv = triples[:, [2, 1, 0]].copy()
    inv[:, 1] += num_rels
    allt = np.concatenate([triples, inv], axis=0).astype(np.int32)
    b = len(allt)
    B = _round_up(b, bucket)
    out = np.zeros((B, 3), np.int32)
    out[:b] = allt
    mask = np.zeros((B,), np.float32)
    mask[:b] = 1.0
    return out, mask


def dilate_snapshots(snapshots: Sequence[np.ndarray], dilate_len: int) -> List[np.ndarray]:
    """Merge every ``dilate_len`` consecutive snapshots into one, its rows
    deduplicated and sorted (``np.unique``); the list as it is for
    ``dilate_len <= 1``. Parity with ref:rgcn/utils.py:408-422
    (``dilate_input``)."""
    if dilate_len <= 1:
        return list(snapshots)
    return [np.unique(np.concatenate(snapshots[i:i + dilate_len], axis=0), axis=0)
            for i in range(0, len(snapshots), dilate_len)]
