"""Static-KB entity-classification datasets (legacy RDF loader parity).

Counterpart of ``regcn_tpu/data/rdf.py``, a copy of its numpy code (the
legacy RGCN entity-classification stack, ref:rgcn/knowledge_graph.py:25-135
``RGCNEntityDataset``, its ``_load_data`` :337-511 and BFS helpers
:231-266): a static multi-relational knowledge base with a subset of
labeled nodes, for node classification with a basis-decomposition RGCN
(aifb/mutag/bgs/am).

The reference parses gzipped RDF with rdflib and caches the result as
``edges.npz`` / ``labels.npz`` / ``train_idx.npy`` / ``test_idx.npy``
(ref:rgcn/knowledge_graph.py:369-399); this module reads that cached
layout (plus a plain-TSV one) and has a deterministic synthetic
generator.

Semantics preserved:
- directed BFS from the labeled nodes, pruning nodes more than
  ``bfs_level`` hops away, with optional consecutive relabeling
  (ref:rgcn/knowledge_graph.py:100-127, :248-266);
- per-(destination, edge-type) in-degree normalisation
  ``edge_norm = 1 / count(dst, type)`` (ref :128-131);
- labels stored one-hot in the cache are argmaxed to class ids
  (ref :133-135).

Conscious divergence, as in the JAX package: after relabeling, the
reference maps dropped train/test indices to node 0 via a
zero-initialised ``node_map`` (ref :118-121), silently mislabeling node
0; here dropped indices are filtered out instead.

:func:`to_static_graph` makes the device graph: edges sorted by
destination for kernel B1, the edge norm as B1's edge weight. JAX's graph
keeps the loader's edge order (its segment sum does not care), so the two
differ only in the fp32 order of each node's sum.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


@dataclasses.dataclass
class EntityClassData:
    """Host-side entity-classification dataset (all numpy).

    Mirrors the attribute surface of ref:rgcn/knowledge_graph.py:36-60.
    ``labels`` is dense ``[num_nodes]`` int64 class ids (−1 = unlabeled).
    """

    name: str
    num_nodes: int
    num_rels: int  # including inverse + self relation (2R+1, ref :420)
    num_classes: int
    edge_src: np.ndarray  # [E] int64
    edge_dst: np.ndarray  # [E] int64
    edge_type: np.ndarray  # [E] int64 in [0, num_rels)
    edge_norm: np.ndarray  # [E] float32, 1/count(dst, type)
    labels: np.ndarray  # [num_nodes] int64, −1 where unlabeled
    train_idx: np.ndarray  # [n_train] int64
    test_idx: np.ndarray  # [n_test] int64


def compute_edge_norm(edge_dst: np.ndarray, edge_type: np.ndarray) -> np.ndarray:
    """``1 / |{e : dst_e = d, type_e = t}|`` per edge (ref :128-131)."""
    _, inverse, count = np.unique(
        np.stack([edge_dst, edge_type]), axis=1,
        return_inverse=True, return_counts=True,
    )
    return (1.0 / count[inverse]).astype(np.float32)


def bfs_levels(num_nodes: int, src: np.ndarray, dst: np.ndarray,
               roots: np.ndarray, depth: int) -> np.ndarray:
    """Directed BFS reach mask within ``depth`` hops of ``roots``.

    Vectorised equivalent of ref:rgcn/knowledge_graph.py:248-266
    (sparse row-vector × adjacency per level, forward direction only).
    Returns a boolean ``[num_nodes]`` keep mask (roots ∪ levels 1..depth).
    """
    keep = np.zeros(num_nodes, dtype=bool)
    frontier = np.zeros(num_nodes, dtype=bool)
    frontier[np.asarray(roots, dtype=np.int64)] = True
    keep |= frontier
    for _ in range(depth):
        hit = frontier[src]
        nxt = np.zeros(num_nodes, dtype=bool)
        np.logical_or.at(nxt, dst[hit], True)
        frontier = nxt & ~keep
        if not frontier.any():
            break
        keep |= frontier
    return keep


def bfs_prune(data: EntityClassData, bfs_level: int = 2,
              relabel: bool = False) -> EntityClassData:
    """Prune nodes > ``bfs_level`` hops from any labeled node.

    Parity with ref:rgcn/knowledge_graph.py:100-127: an edge is dropped
    if *either* endpoint is deleted; ``relabel`` compacts node ids to the
    nodes that still appear in some edge.
    """
    if bfs_level <= 0:
        return data
    labeled = np.where(data.labels >= 0)[0]
    keep = bfs_levels(data.num_nodes, data.edge_src, data.edge_dst,
                      labeled, bfs_level)
    ekeep = keep[data.edge_src] & keep[data.edge_dst]
    src, dst, etype = (data.edge_src[ekeep], data.edge_dst[ekeep],
                       data.edge_type[ekeep])
    num_nodes, labels = data.num_nodes, data.labels
    train_idx, test_idx = data.train_idx, data.test_idx
    if relabel:
        uniq, flat = np.unique(np.concatenate([src, dst]), return_inverse=True)
        src, dst = flat[: len(src)], flat[len(src):]
        node_map = np.full(num_nodes, -1, dtype=np.int64)
        node_map[uniq] = np.arange(len(uniq))
        labels = labels[uniq]
        train_idx = node_map[train_idx][node_map[train_idx] >= 0]
        test_idx = node_map[test_idx][node_map[test_idx] >= 0]
        num_nodes = len(uniq)
    return dataclasses.replace(
        data, num_nodes=num_nodes, edge_src=src, edge_dst=dst,
        edge_type=etype, edge_norm=compute_edge_norm(dst, etype),
        labels=labels, train_idx=train_idx, test_idx=test_idx,
    )


def _finalize(name: str, num_nodes: int, num_base_rels: int,
              triples: np.ndarray, labels: np.ndarray,
              train_idx: np.ndarray, test_idx: np.ndarray,
              num_classes: int, bfs_level: int, relabel: bool,
              add_inverse_and_self: bool = True) -> EntityClassData:
    """Assemble edges (+ inverse ``r+R`` and self-loop relation ``2R``)
    and apply BFS pruning.

    Relation-id layout note: only the COUNT (``num_rel = 2R+1``) matches
    the reference's cached ``edges.npz`` (ref :420); the reference
    interleaves ids (self=0, forward=2r+1, inverse=2r+2, ref
    rgcn/knowledge_graph.py:431-441) while this emits blocked ids
    (forward=r, inverse=r+R, self=2R). Each layout is self-consistent;
    TSV/synthetic datasets are therefore not id-interchangeable with
    reference caches (which are loaded verbatim by their own branch)."""
    s, r, o = triples[:, 0], triples[:, 1], triples[:, 2]
    if add_inverse_and_self:
        loop = np.arange(num_nodes, dtype=np.int64)
        src = np.concatenate([s, o, loop])
        dst = np.concatenate([o, s, loop])
        etype = np.concatenate(
            [r, r + num_base_rels,
             np.full(num_nodes, 2 * num_base_rels, dtype=np.int64)])
        num_rels = 2 * num_base_rels + 1
    else:
        src, dst, etype, num_rels = s, o, r, num_base_rels
    data = EntityClassData(
        name=name, num_nodes=num_nodes, num_rels=num_rels,
        num_classes=num_classes,
        edge_src=src.astype(np.int64), edge_dst=dst.astype(np.int64),
        edge_type=etype.astype(np.int64),
        edge_norm=compute_edge_norm(dst, etype),
        labels=labels.astype(np.int64),
        train_idx=np.asarray(train_idx, dtype=np.int64),
        test_idx=np.asarray(test_idx, dtype=np.int64),
    )
    return bfs_prune(data, bfs_level, relabel)


def load_entity_data(name: str, data_dir: str = "data",
                     bfs_level: int = 2, relabel: bool = False,
                     seed: int = 123) -> EntityClassData:
    """Load an entity-classification dataset.

    Resolution order (ref loader surface ``load_data(dataset, bfs_level,
    relabel)``, ref:rgcn/knowledge_graph.py:82-86):
    1. synthetic presets (``synthetic-*``);
    2. the reference's cached-npz artifact layout under
       ``<data_dir>/<name>/`` (ref :369-399): ``edges.npz`` with keys
       ``n`` / ``nrel`` / ``edges [E,3] = (src, dst, type)``, one-hot
       ``labels.npz`` (dense or scipy CSR fields), ``train_idx.npy``,
       ``test_idx.npy``;
    3. a plain-TSV layout: ``edges.txt`` rows ``s r o`` (base relations;
       inverse/self added here) + ``labels.txt`` rows ``node class
       split`` with split ∈ {train, test}.
    """
    if name.startswith("synthetic"):
        return generate_entity_class(name, seed=seed, bfs_level=bfs_level,
                                     relabel=relabel)
    d = os.path.join(data_dir, name)
    npz = os.path.join(d, "edges.npz")
    if os.path.isfile(npz):
        cache = np.load(npz)
        edges = cache["edges"].astype(np.int64)  # [E,3] (src, dst, type)
        num_nodes, num_rels = int(cache["n"]), int(cache["nrel"])
        onehot = _load_label_matrix(os.path.join(d, "labels.npz"), num_nodes)
        labels = np.where(onehot.any(axis=1), onehot.argmax(axis=1), -1)
        data = EntityClassData(
            name=name, num_nodes=num_nodes, num_rels=num_rels,
            num_classes=onehot.shape[1],
            edge_src=edges[:, 0], edge_dst=edges[:, 1], edge_type=edges[:, 2],
            edge_norm=compute_edge_norm(edges[:, 1], edges[:, 2]),
            labels=labels.astype(np.int64),
            train_idx=np.load(os.path.join(d, "train_idx.npy")).astype(np.int64),
            test_idx=np.load(os.path.join(d, "test_idx.npy")).astype(np.int64),
        )
        return bfs_prune(data, bfs_level, relabel)
    # plain-TSV fallback
    triples = np.loadtxt(os.path.join(d, "edges.txt"), dtype=np.int64, ndmin=2)
    num_nodes = int(triples[:, [0, 2]].max()) + 1
    num_base = int(triples[:, 1].max()) + 1
    labels = np.full(num_nodes, -1, dtype=np.int64)
    train_rows, test_rows = [], []
    with open(os.path.join(d, "labels.txt")) as f:
        for line in f:
            node, cls, split = line.split()
            labels[int(node)] = int(cls)
            (train_rows if split == "train" else test_rows).append(int(node))
    return _finalize(name, num_nodes, num_base, triples, labels,
                     np.array(train_rows), np.array(test_rows),
                     int(labels.max()) + 1, bfs_level, relabel)


def _load_label_matrix(path: str, num_nodes: int) -> np.ndarray:
    """One-hot label matrix from a dense or scipy-CSR ``.npz``
    (the reference saves scipy CSR, ref :534-539)."""
    z = np.load(path, allow_pickle=False)
    if "data" in z and "indices" in z and "indptr" in z:
        shape = tuple(z["shape"])
        out = np.zeros(shape, dtype=np.float32)
        indptr, indices, vals = z["indptr"], z["indices"], z["data"]
        for i in range(shape[0]):
            out[i, indices[indptr[i]: indptr[i + 1]]] = \
                vals[indptr[i]: indptr[i + 1]]
        return out
    key = "labels" if "labels" in z else list(z.keys())[0]
    return np.asarray(z[key], dtype=np.float32)


_ENTITY_PRESETS = {
    # aifb-shaped: 8285 nodes, 45 base relations, 4 classes, 176 labeled
    "synthetic-aifb": dict(num_nodes=8285, num_base_rels=45, num_classes=4,
                           n_labeled=176, avg_degree=8),
    "synthetic-entity-small": dict(num_nodes=600, num_base_rels=12,
                                   num_classes=4, n_labeled=120, avg_degree=6),
}


def generate_entity_class(name: str = "synthetic-entity-small",
                          seed: int = 123, bfs_level: int = 2,
                          relabel: bool = False, **overrides) -> EntityClassData:
    """Deterministic synthetic static KB whose class signal lives in the
    relational structure (class-specific hub entities + typed relations),
    so a 2-layer basis RGCN separates classes while a featureless linear
    model cannot. Fills in for the absent aifb/mutag/bgs/am archives the
    same way data/synthetic.py fills in for the temporal tarball.
    """
    if name not in _ENTITY_PRESETS:
        raise KeyError(
            f"unknown synthetic entity dataset {name!r}; "
            f"known: {sorted(_ENTITY_PRESETS)}")
    cfg = dict(_ENTITY_PRESETS[name])
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    n, num_base = cfg["num_nodes"], cfg["num_base_rels"]
    n_classes, n_labeled = cfg["num_classes"], cfg["n_labeled"]
    rng = np.random.default_rng(seed)

    node_class = rng.integers(0, n_classes, size=n)
    # per-class hub entities; membership edges use a class-specific relation
    hubs = rng.choice(n, size=n_classes * 3, replace=False).reshape(n_classes, 3)
    rows = []
    for c in range(n_classes):
        members = np.where(node_class == c)[0]
        hub = hubs[c][rng.integers(0, 3, size=len(members))]
        rel = c % num_base
        rows.append(np.stack([members, np.full(len(members), rel), hub], axis=1))
    # background noise edges with class-agnostic relations
    n_noise = n * cfg["avg_degree"] // 2
    noise_rel = rng.integers(n_classes % num_base, num_base, size=n_noise)
    rows.append(np.stack([rng.integers(0, n, n_noise), noise_rel,
                          rng.integers(0, n, n_noise)], axis=1))
    triples = np.concatenate(rows).astype(np.int64)

    labeled = rng.choice(n, size=n_labeled, replace=False)
    labels = np.full(n, -1, dtype=np.int64)
    labels[labeled] = node_class[labeled]
    n_train = int(0.8 * n_labeled)
    perm = rng.permutation(labeled)
    return _finalize(name, n, num_base, triples, labels,
                     perm[:n_train], perm[n_train:], n_classes,
                     bfs_level, relabel)


def _round_up(x: int, m: int) -> int:
    return max(((x + m - 1) // m) * m, m)


@dataclasses.dataclass
class StaticGraph:
    """The padded static graph of the entity classifier, on one device.

    Edges are sorted by destination, as kernel B1 takes them: ``keys``
    holds each edge's destination, and ``num_nodes`` for a padding slot,
    which sorts last and whose sum is dropped. The legacy task normalises
    per (destination, edge type) (ref:rgcn/knowledge_graph.py:128-131), not
    per node, so the per-edge norm is B1's edge weight (0 in padding) and
    ``in_deg_norm``, its row scale, is all ones.
    """

    src: torch.Tensor  # [E] int64
    keys: torch.Tensor  # [E] int32, ascending; num_nodes in padding
    rel: torch.Tensor  # [E] int64
    edge_norm: torch.Tensor  # [E] float32: 1/count(dst, type), 0 in padding
    in_deg_norm: torch.Tensor  # [N] float32 (all ones)

    @property
    def num_nodes(self) -> int:
        return self.in_deg_norm.shape[0]


def to_static_graph(data: EntityClassData, device="cuda", edge_bucket: int = 128) -> StaticGraph:
    """The graph of ``data`` padded to a multiple of ``edge_bucket`` edges,
    sorted by destination (stable), on ``device``."""
    e, n = len(data.edge_src), data.num_nodes
    pad = _round_up(e, edge_bucket) - e
    order = np.argsort(data.edge_dst, kind="stable")

    def p(a, fill=0):
        return np.pad(a[order], (0, pad), constant_values=fill)

    t = torch.from_numpy
    return StaticGraph(
        src=t(p(data.edge_src).astype(np.int64)).to(device),
        keys=t(p(data.edge_dst, n).astype(np.int32)).to(device),
        rel=t(p(data.edge_type).astype(np.int64)).to(device),
        edge_norm=t(p(data.edge_norm).astype(np.float32)).to(device),
        in_deg_norm=torch.ones(n, dtype=torch.float32, device=device),
    )
