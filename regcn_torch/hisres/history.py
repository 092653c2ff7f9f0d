"""Sparse multi-granularity history store.

Counterpart of ``regcn_tpu/hisres/history.py`` (numpy and scipy only, so
a copy: the same tables, the same queries, the same arrays bit for bit).
The one change: :meth:`HistoryStore.his_graph` stores its kept edges
stably sorted by destination (``dst_sorted=True``), so the scatter kernel
takes them without an argsort; only the order of each destination's sum
differs from JAX's.

Parity with ref:hisres_src/get_new_history.py:99-126 (offline cumulative
sparse history matrices) and their consumption in
ref:hisres_src/hisres_main.py:317-353:

- tail history: which (s, r) -> o triples appeared at or before each
  timestamp (the reference's cumulative CSR of shape (E * 2R, E));
- relation history: which relations were seen between (s, o) in the last
  ``history_len`` snapshots before t (the reference's per-timestamp
  (E * E, 2R) CSRs, summed over the window).

The reference materializes scipy CSR matrices per timestamp; at
ICEWS14s scale those have 3.3M-row (tail) and 50M-row (rel) indptr
arrays PER TIMESTAMP — hundreds of MB each, unusable. Here the same
information lives in flat event tables sorted by query key, and every
query is a vectorized ``searchsorted`` block gather:

- ``_tail_*``: unique (s*2R + r, o) pairs with their first-occurrence
  time, sorted by key — cumulative membership is ``t_first < t``;
- ``_rel_*``: per-snapshot (s*E + o, r) pairs with their time, sorted by
  (key, time) — windowed membership is ``t - hlen <= time < t``.

Query-conditioned vocabularies are one-hot rows scattered from the
gathered blocks. The store also emits the padded flat edge arrays of the
query-conditioned history graph directly (replacing the reference's
per-query Python loop + dense ``todense()`` round trip at
ref:hisres_rgcn/utils.py:490-604).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from regcn_torch.data.snapshots import Snapshot, _round_up, build_snapshot


def _block_gather(keys_sorted: np.ndarray, query_keys: np.ndarray,
                  lo_extra=None, hi_extra=None):
    """For each query key, the [lo, hi) block in a key-sorted table.

    Returns (rows, idx): for every table entry that matches some query
    key, the query row it belongs to and its table index. Duplicated
    query keys each get their own copy (matches the reference's per-row
    one-hot gather).
    """
    lo = np.searchsorted(keys_sorted, query_keys, side="left")
    hi = np.searchsorted(keys_sorted, query_keys, side="right")
    counts = hi - lo
    rows = np.repeat(np.arange(len(query_keys)), counts)
    # index within each block: arange over concatenated blocks
    total = int(counts.sum())
    if total == 0:
        return rows, np.zeros(0, np.int64)
    starts = np.repeat(lo, counts)
    offsets = np.arange(total) - np.repeat(
        np.cumsum(counts) - counts, counts)
    return rows, starts + offsets


class HistoryStore:
    """Cumulative (s,r)->o and windowed (s,o)->r history over flat
    sorted event tables."""

    def __init__(self, num_nodes: int, num_rels: int, history_len: int = 3,
                 rel_window_mode: str = "full"):
        if rel_window_mode not in ("full", "endpoints"):
            raise ValueError(f"rel_window_mode must be 'full' or "
                             f"'endpoints', got {rel_window_mode!r}")
        self.num_nodes = num_nodes
        self.num_rels = num_rels  # base R
        self.history_len = history_len
        # "full": relations seen anywhere in [t-hlen, t) — the INTENDED
        # semantics of ref:hisres_main.py:336-350. "endpoints": reproduce
        # the reference's ACTUAL behavior — get_new_history.py:124-126
        # saves the PER-STEP rel_seq under the name the consumer treats
        # as cumulative, so load(t-1) - load(t-hlen-1) |nonzero| is the
        # symmetric difference of events at exactly those two timestamps.
        self.rel_window_mode = rel_window_mode
        self.num_times = 0
        # tail table: unique (s*2R+r) keys, candidate o, first-seen time
        self._tail_key = np.zeros(0, np.int64)
        self._tail_o = np.zeros(0, np.int32)
        self._tail_tfirst = np.zeros(0, np.int64)
        # rel table: (s*E+o) keys, relation, time; sorted by (key, time)
        self._rel_key = np.zeros(0, np.int64)
        self._rel_r = np.zeros(0, np.int32)
        self._rel_t = np.zeros(0, np.int64)

    def build(self, snapshot_list: List[np.ndarray]) -> "HistoryStore":
        E, R, R2 = self.num_nodes, self.num_rels, 2 * self.num_rels
        self.num_times = len(snapshot_list)
        keys, os_, ts = [], [], []
        rkeys, rrs, rts = [], [], []
        for t, snap in enumerate(snapshot_list):
            arr = np.asarray(snap)[:, :3].astype(np.int64)
            if len(arr) == 0:
                continue
            inv = arr[:, [2, 1, 0]].copy()
            inv[:, 1] += R
            full = np.concatenate([arr, inv])
            keys.append(full[:, 0] * R2 + full[:, 1])
            os_.append(full[:, 2])
            ts.append(np.full(len(full), t, np.int64))
            rkeys.append(full[:, 0] * E + full[:, 2])
            rrs.append(full[:, 1])
            rts.append(np.full(len(full), t, np.int64))
        if keys:
            key = np.concatenate(keys)
            o = np.concatenate(os_)
            tt = np.concatenate(ts)
            # first occurrence per unique (key, o): sort by (key, o, t)
            order = np.lexsort((tt, o, key))
            key, o, tt = key[order], o[order], tt[order]
            first = np.ones(len(key), bool)
            first[1:] = (key[1:] != key[:-1]) | (o[1:] != o[:-1])
            self._tail_key = key[first]
            self._tail_o = o[first].astype(np.int32)
            self._tail_tfirst = tt[first]

            rk = np.concatenate(rkeys)
            rr = np.concatenate(rrs)
            rt = np.concatenate(rts)
            order = np.lexsort((rt, rk))
            self._rel_key, self._rel_r, self._rel_t = (
                rk[order], rr[order].astype(np.int32), rt[order])
        return self

    # ------------------------------------------------------------- persist
    def save(self, directory: str):
        """Write per-timestamp npz CSRs (artifact parity with the
        reference's get_new_history.py tool)."""
        import scipy.sparse as sp

        os.makedirs(directory, exist_ok=True)
        E, R2 = self.num_nodes, 2 * self.num_rels
        for t in range(self.num_times):
            sel = self._tail_tfirst <= t
            m = sp.csr_matrix(
                (np.ones(int(sel.sum()), np.float32),
                 (self._tail_key[sel], self._tail_o[sel])),
                shape=(E * R2, E))
            sp.save_npz(os.path.join(directory, f"tail_history_{t}.npz"), m)
            sel = self._rel_t == t
            m = sp.csr_matrix(
                (np.ones(int(sel.sum()), np.float32),
                 (self._rel_key[sel], self._rel_r[sel])),
                shape=(E * E, R2))
            sp.save_npz(os.path.join(directory, f"rel_history_{t}.npz"), m)

    @classmethod
    def load(cls, directory: str, num_nodes: int, num_rels: int,
             num_times: int, history_len: int = 3) -> "HistoryStore":
        """Load the reference tool's per-timestamp npz artifacts."""
        import scipy.sparse as sp

        store = cls(num_nodes, num_rels, history_len)
        store.num_times = num_times
        tk, to, tf = [], [], []
        rk, rr, rt = [], [], []
        prev_nnz_keys = None
        for t in range(num_times):
            m = sp.load_npz(
                os.path.join(directory, f"tail_history_{t}.npz")).tocoo()
            pairs = set(zip(m.row.tolist(), m.col.tolist()))
            new = pairs - prev_nnz_keys if prev_nnz_keys is not None else pairs
            for kk, oo in new:
                tk.append(kk)
                to.append(oo)
                tf.append(t)
            prev_nnz_keys = pairs
            m = sp.load_npz(
                os.path.join(directory, f"rel_history_{t}.npz")).tocoo()
            rk.extend(m.row.tolist())
            rr.extend(m.col.tolist())
            rt.extend([t] * m.nnz)
        if tk:
            key = np.asarray(tk, np.int64)
            o = np.asarray(to, np.int32)
            tf_ = np.asarray(tf, np.int64)
            order = np.lexsort((o, key))
            store._tail_key, store._tail_o, store._tail_tfirst = (
                key[order], o[order], tf_[order])
        if rk:
            k = np.asarray(rk, np.int64)
            r = np.asarray(rr, np.int32)
            t_ = np.asarray(rt, np.int64)
            order = np.lexsort((t_, k))
            store._rel_key, store._rel_r, store._rel_t = k[order], r[order], t_[order]
        return store

    # -------------------------------------------------------------- queries
    def _tail_pairs(self, triples: np.ndarray, t: int):
        """(rows, candidate o) of history tails for each (s, r) query row
        strictly before snapshot t (ref main :326-330)."""
        if t <= 0 or len(self._tail_key) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        t_eff = min(t - 1, self.num_times - 1)
        q = triples[:, 0].astype(np.int64) * (2 * self.num_rels) + triples[:, 1]
        rows, idx = _block_gather(self._tail_key, q)
        keep = self._tail_tfirst[idx] <= t_eff
        return rows[keep], self._tail_o[idx[keep]]

    def tail_vocab(self, triples: np.ndarray, t: int) -> np.ndarray:
        """One-hot [B, E] of known tails for each (s, r) row (rel ids may
        already include inverses)."""
        out = np.zeros((len(triples), self.num_nodes), np.float32)
        rows, cols = self._tail_pairs(triples, t)
        out[rows, cols] = 1.0
        return out

    def rel_pairs(self, triples: np.ndarray, t: int):
        """(rows, relation) pairs seen between (s, o) before t.

        mode "full" (default, the intended semantics of ref
        main :336-350): anywhere in the last ``history_len`` snapshots.
        mode "endpoints" (reference-actual reproduction): the symmetric
        difference of events at exactly t-1 and t-hlen-1 — what
        ``load_npz(t-1) - load_npz(t-hlen-1)`` + ``masked_fill(!=0)``
        computes given get_new_history.py saves per-step rel matrices.
        """
        if t <= 0 or len(self._rel_key) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        q = triples[:, 0].astype(np.int64) * self.num_nodes + triples[:, 2]
        rows, idx = _block_gather(self._rel_key, q)
        times = self._rel_t[idx]
        if self.rel_window_mode == "endpoints":
            t_hi, t_lo = t - 1, t - self.history_len - 1
            keep = (times == t_hi) | ((times == t_lo) & (t_lo >= 0))
            rows, rels = rows[keep], self._rel_r[idx[keep]]
            side = (times[keep] == t_hi).astype(np.int64) * 2 - 1  # +1/-1
            if len(rows):
                # nonzero count difference == symmetric difference for
                # 0/1 multiplicities; general multiplicities cancel too
                u, inv = np.unique(rows * (2 * self.num_rels) + rels,
                                   return_inverse=True)
                net = np.zeros(len(u), np.int64)
                np.add.at(net, inv, side)
                u = u[net != 0]
                rows = u // (2 * self.num_rels)
                rels = (u % (2 * self.num_rels)).astype(np.int32)
            return rows, rels
        lo_t = max(t - self.history_len, 0)
        keep = (times >= lo_t) & (times < t)
        rows, rels = rows[keep], self._rel_r[idx[keep]]
        # dedup (row, rel) — one-hot semantics
        if len(rows):
            u = np.unique(rows * (2 * self.num_rels) + rels)
            rows = u // (2 * self.num_rels)
            rels = (u % (2 * self.num_rels)).astype(np.int32)
        return rows, rels

    def rel_vocab(self, triples: np.ndarray, t: int) -> np.ndarray:
        out = np.zeros((len(triples), 2 * self.num_rels), np.float32)
        rows, rels = self.rel_pairs(triples, t)
        out[rows, rels] = 1.0
        return out

    # --------------------------------------------------- history graph build
    def his_graph(
        self,
        triples: np.ndarray,  # [B, 3] (query rows; rel in [0, 2R) allowed)
        mask: np.ndarray,  # [B]
        t: int,
        inv: bool = False,
        edge_bucket: int = 1024,
        max_edges: Optional[int] = None,
        edge_pad: Optional[int] = None,
    ) -> Snapshot:
        """Query-conditioned history graph as padded flat edge arrays.

        For each valid query (s, r): every vocab candidate o adds an edge
        s->o with type r and o->s with type r-R (inv) or r+R (raw)
        (ref:hisres_rgcn/utils.py:540-557). Degree norm = 1/in_deg. With
        ``max_edges``, a larger graph keeps a uniform sample of that many
        edges (``default_rng(1234)``, as JAX); the kept edges are stored
        stably sorted by destination.
        """
        E = self.num_nodes
        R = self.num_rels
        rows, cols = self._tail_pairs(triples, t)
        valid = mask[rows] > 0
        rows, cols = rows[valid], cols[valid]
        s = triples[rows, 0]
        r = triples[rows, 1]
        o = cols
        if len(s):
            src = np.concatenate([s, o]).astype(np.int32)
            dst = np.concatenate([o, s]).astype(np.int32)
            rel = np.concatenate([r, r - R if inv else r + R]).astype(np.int32)
        else:
            src = np.zeros(0, np.int32)
            dst = np.zeros(0, np.int32)
            rel = np.zeros(0, np.int32)
        if max_edges is not None and len(src) > max_edges:
            keep = np.random.default_rng(1234).choice(len(src), max_edges, replace=False)
            src, dst, rel = src[keep], dst[keep], rel[keep]
        order = np.argsort(dst, kind="stable")
        src, dst, rel = src[order], dst[order], rel[order]

        e = len(src)
        pad = edge_pad if edge_pad is not None else _round_up(max(e, 1), edge_bucket)
        in_deg = np.bincount(dst, minlength=E).astype(np.float32)

        def p(a):
            out = np.zeros((pad,), a.dtype)
            out[: len(a)] = a
            return out

        emask = np.zeros((pad,), np.float32)
        emask[:e] = 1.0
        return Snapshot(
            src=p(src), dst=p(dst), rel=p(rel), edge_mask=emask,
            in_deg_norm=1.0 / np.maximum(in_deg, 1.0),
            has_in_edge=(in_deg > 0).astype(np.float32),
            rc_rel=np.zeros(1, np.int32), rc_ent=np.zeros(1, np.int32),
            rc_mask=np.zeros(1, np.float32),
            num_edges=e, num_triples=len(triples), dst_sorted=True,
        )


def build_time_graph(num_timestamps: int, r_types, periods,
                     num_rels: int, edge_bucket: int = 128) -> Snapshot:
    """Periodic timestamp graph (parity: ref:hisres_rgcn/utils.py:408-446).

    Nodes are timestamps; for each (relation type r, period p) pair an
    edge t -> t+p is added for every PERIOD-ALIGNED t (t = 0, p, 2p, ...
    with t+p < num_timestamps — the reference iterates
    ``range(0, timestamps, p)``, ref :425, so non-multiples of p get no
    period-p edge; matched exactly). Inverse edges carry r + num_rels and
    message normalisation is 1/in-degree with isolated nodes clamped to
    1 — exactly the semantics of ``build_snapshot``, so this is a thin
    triple generator over it. (The reference keeps this builder
    unreferenced by its entry points; provided for library parity.)
    """
    rows = []
    for r, p in zip(r_types, periods):
        t = np.arange(0, num_timestamps - p, p, dtype=np.int64)
        if len(t):
            rows.append(np.stack([t, np.full(len(t), r, np.int64), t + p], 1))
    triples = (np.concatenate(rows) if rows
               else np.zeros((0, 3), np.int64))
    return build_snapshot(triples, num_timestamps, num_rels,
                          edge_bucket=edge_bucket)
