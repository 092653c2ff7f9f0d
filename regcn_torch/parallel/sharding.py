"""Sharding rules and the pieces of the sharded train and predict steps.

Counterpart of ``regcn_tpu/parallel/sharding.py``. The design is JAX's:

- the entity axis is the big axis: the entity table ``dynamic_emb`` (and
  the static graph's ``words_emb``, in blocks of ``num_words / G`` rows),
  their Adam moments, the evolved entity states and the
  decoder's candidate axis are row-sharded over the mesh's ``graph`` axis,
  one block of ``N / G`` rows per rank;
- relation tables and the GRU and decoder weights are small, so
  replicated: every rank holds them whole and bit-equal;
- the entity CE's logsumexp and the ranks reduce over ranks.

JAX states this as sharding annotations and GSPMD inserts the collectives;
here they are written out (``collectives.py``) and each rank runs the
model on its rows (the sharded ``impl`` markers of ``regcn_torch/dist.py``
route ``models/``). What the JAX module's functions become:

- ``param_sharding_rules`` / ``state_sharding_rules``: a flag per
  parameter leaf (in ``tree_leaves`` order, which the Adam moments follow)
  saying whether it is row-sharded; :func:`shard_params` /
  :func:`shard_state` cut a whole tree into this rank's rows, and
  :func:`unshard_state` gathers them back (for a checkpoint, which keeps
  the unsharded format);
- ``make_sharded_train_step``: each trainer's step under a mesh (RE-GCN's,
  the hyperbolic one's, HisRES's), whose backward takes
  :func:`train_grads` (each rank's share of the loss, then the replicated
  gradients summed over ranks) and whose optimizer takes the clip's
  global norm across ranks (``EuclideanAdam.shard``); ``predict_step``:
  each family's ``predict`` under the sharded ``impl``, scored by
  :class:`ShardedEval`;
- ``shard_snapshot_store`` / ``make_sharded_epoch_fn``: each training
  window carries the rank's partition of its edges (:func:`attach_partition`),
  and ``Trainer.run_epoch`` takes the port's eager epoch, the fused
  epoch's steps in their order.

A ``data`` axis above 1 replicates all of this, as JAX's rules replicate
every leaf over it: each replica's ranks hold the same rows as the first
replica's. What a step carries forward is taken from the first replica
(:func:`train_grads`, :func:`from_first_replica_tree`, the ranks of
:class:`ShardedEval`), so the replicas stay bit-equal
(``collectives.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence

import numpy as np
import torch

from regcn_torch.data.snapshots import Snapshot, build_history
from regcn_torch.dist import attach_history_halo
from regcn_torch.parallel import halo as H
from regcn_torch.parallel.collectives import (RowShard, all_gather_rows, all_reduce_replicated,
                                              from_first_replica, tensors_from_first_replica)
from regcn_torch.train import metrics
from regcn_torch.train.optim import AdamState, tree_leaves
from regcn_torch.utils.dtypes import map_tensors

# parameter leaves sharded over the entity axis (row-sharded)
_ENTITY_SHARDED = ("dynamic_emb", "words_emb")


def _paths(tree, prefix=()) -> List[tuple]:
    """Key paths of a nested dict/list, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, prefix + (str(i),))]
    return [prefix]


def param_sharding_rules(tree) -> List[bool]:
    """Per leaf of ``tree`` (``tree_leaves`` order): True for the entity
    tables, row-sharded, False for the rest, replicated. Matching is by
    path-component name, as in JAX."""
    return [any(n in _ENTITY_SHARDED for n in path) and leaf.dim() >= 1
            for path, leaf in zip(_paths(tree), tree_leaves(tree))]


def state_sharding_rules(state) -> List[bool]:
    """The rules of a TrainState's parameters, which its Adam moments
    follow leaf for leaf."""
    return param_sharding_rules(state.params)


def rank_rows(t: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """This rank's block of the row-sharded ``t`` (a detached copy):
    ``t.shape[0] / G`` rows, so ``words_emb`` takes its own row count."""
    rows = t.shape[0] // shard.size
    return t.detach()[shard.rank * rows:(shard.rank + 1) * rows].clone()


def _rebuild(tree, leaves: list):
    """``tree`` with its leaves replaced, in ``tree_leaves`` order."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return next(it)

    return go(tree)


def shard_params(tree, shard: RowShard):
    """``tree`` with each row-sharded leaf cut to this rank's rows (a
    detached copy that requires grad as the leaf did); replicated leaves as
    they are."""
    leaves = [(rank_rows(t, shard).requires_grad_(t.requires_grad) if s else t)
              for t, s in zip(tree_leaves(tree), param_sharding_rules(tree))]
    return _rebuild(tree, leaves)


def shard_state(state, shard: RowShard):
    """A whole TrainState cut to this rank's rows: the entity tables and
    their Adam moments; everything else as it is."""
    rules = state_sharding_rules(state)
    opt = state.opt_state
    moments = [[rank_rows(t, shard) if s else t for t, s in zip(ts, rules)] for ts in (opt.mu, opt.nu)]
    return dataclasses.replace(
        state, params=shard_params(state.params, shard),
        opt_state=AdamState(count=opt.count, mu=moments[0], nu=moments[1],
                            manifold=opt.manifold))


def unshard_state(state, shard: RowShard):
    """The TrainState whole again: every rank's rows of each sharded leaf
    and moment gathered (a collective: every rank calls it), as a state
    that shares nothing sharded with ``state``."""
    rules = state_sharding_rules(state)

    def whole(ts):
        with torch.no_grad():
            return [all_gather_rows(t.detach(), shard.group) if s else t
                    for t, s in zip(ts, rules)]

    params = _rebuild(state.params, [
        t.requires_grad_(True) if s else t
        for t, s in zip(whole(tree_leaves(state.params)), rules)])
    opt = state.opt_state
    return dataclasses.replace(
        state, params=params,
        opt_state=AdamState(count=opt.count, mu=whole(opt.mu), nu=whole(opt.nu),
                            manifold=opt.manifold))


def sharded_grads(total: torch.Tensor, leaves: Sequence[torch.Tensor], replicated: Sequence[bool],
                  shard: RowShard) -> List[torch.Tensor]:
    """The gradients of the loss ``total`` (the same value on every rank)
    under the sum-over-ranks convention of ``collectives.py``: each rank's
    share is ``total / G``, and the replicated leaves' gradients are summed
    over ranks afterwards; the sharded leaves' are whole already."""
    grads = torch.autograd.grad(total / shard.size, list(leaves), allow_unused=True)
    return all_reduce_replicated(grads, leaves, replicated, shard.group)


def train_grads(total: torch.Tensor, state, opt=None, shard=None) -> list:
    """The gradients of a training step's loss ``total`` by every parameter
    of ``state`` (``tree_leaves`` order, None where a leaf has none): off a
    mesh plain ``autograd.grad``; on one (``shard``) :func:`sharded_grads`,
    taken from the first replica where the ``data`` axis is above 1, with
    ``opt``'s clip norm taken across the ranks (no optimizer: the
    ``run_analysis`` gradients)."""
    leaves = tree_leaves(state.params)
    if shard is None:
        return list(torch.autograd.grad(total, leaves, allow_unused=True))
    rules = state_sharding_rules(state)
    if opt is not None:
        opt.shard(rules, shard.group)
    return tensors_from_first_replica(sharded_grads(total, leaves, [not r for r in rules], shard),
                                      shard)


def from_first_replica_tree(tree, shard=None):
    """``tree`` (a model state: BatchNorm statistics, buffers) with every
    tensor taken from the first replica of the mesh, in one broadcast per
    dtype; ``tree`` itself off a mesh or with one replica."""
    if shard is None or shard.replicas is None:
        return tree
    leaves: list = []
    map_tensors(tree, lambda t: leaves.append(t) or t)
    it = iter(tensors_from_first_replica(leaves, shard))
    return map_tensors(tree, lambda t: next(it))


def attach_partition(history: Snapshot, snaps: Sequence[np.ndarray], num_nodes: int,
                     num_rels: int, dist_agg: str, shard: RowShard,
                     edge_bucket: int = 256) -> Snapshot:
    """``history`` (a host window of ``snaps``) with this rank's partition
    of the same snapshots' edges: the boundary halo (``halo``, JAX's
    ``attach_history_halo``) or the destination partition (``parts``)."""
    if dist_agg == "halo":
        history = attach_history_halo(history, snaps, num_nodes, num_rels, shard.size,
                                      edge_bucket=edge_bucket)
        return dataclasses.replace(history, halo=H.local_halo(history.halo, shard.rank))
    store = H.build_partition_store(list(snaps), num_nodes, num_rels, shard.size,
                                    edge_bucket=edge_bucket)
    return dataclasses.replace(history, parts=H.local_parts(store, shard.rank))


@dataclasses.dataclass
class ShardedEval:
    """A trainer's sharded windows and ranks, in training and in the
    rolling evaluation (``train/loop.py:rolling_ranks``, HisRES's own
    loops): windows with the rank's partition of their edges, ranks across
    the candidate shards, and the whole score matrix for multi-step
    inference. ``cfg`` is any family's model config (``num_ents``,
    ``num_rels``); ``rc_mode`` the windows' relation-context incidence
    (HisRES's streams take ``"src"``)."""

    cfg: Any  # ModelConfig, HyperbolicConfig or HisResConfig
    tc: Any  # TrainConfig
    dist_agg: str
    shard: RowShard
    device: Any
    rc_mode: str = "both"

    def window(self, snaps: Sequence[np.ndarray]) -> Snapshot:
        hist = build_history(list(snaps), self.cfg.num_ents, self.cfg.num_rels,
                             edge_bucket=self.tc.edge_bucket, rc_bucket=self.tc.rc_bucket,
                             rc_mode=self.rc_mode)
        return attach_partition(hist, snaps, self.cfg.num_ents, self.cfg.num_rels, self.dist_agg,
                                self.shard, self.tc.edge_bucket).to(self.device)

    def ranks(self, s_ob, s_rel, trip, er, ec, rr, rc) -> torch.Tensor:
        """[4, B]: the entity ranks (raw, filtered) across the shards, the
        relation ranks (replicated scores); the first replica's."""
        return from_first_replica(torch.stack([
            metrics.sharded_ranks(s_ob, trip[:, 2], self.shard),
            metrics.sharded_filtered_ranks(s_ob, trip[:, 2], er, ec, self.shard),
            metrics.device_ranks(s_rel, trip[:, 1]),
            metrics.device_filtered_ranks(s_rel, trip[:, 1], rr, rc),
        ]), self.shard)

    def full_scores(self, s_ob: torch.Tensor) -> torch.Tensor:
        """[B, N]: every rank's candidate columns, in rank order; the first
        replica's."""
        return from_first_replica(all_gather_rows(s_ob.T.contiguous(), self.shard.group).T,
                                  self.shard)

    def rel_scores(self, s_rel: torch.Tensor) -> torch.Tensor:
        """The replicated relation scores, the first replica's."""
        return from_first_replica(s_rel, self.shard)
