"""Distributed-aggregation dispatch markers.

Counterpart of ``regcn_tpu/dist.py``. The layer stacks' ``impl``
argument takes, beside the strings ``"xla"`` / ``"pallas"`` /
``"cumsum"``, one of two markers that say the entity rows are sharded over
the ``graph`` axis of a mesh (``regcn_torch/parallel/mesh.py``), one shard
of rows per rank of a ``torch.distributed`` process group:

- :class:`GspmdImpl` (``dist_agg="gspmd"``): each rank gathers every
  shard's rows, then aggregates the edges of its own destination rows
  (:func:`regcn_torch.parallel.halo.sharded_rgcn_aggregate`). JAX leaves
  these gathers to GSPMD, which inserts them from sharding annotations;
  PyTorch has no GSPMD, so the port writes them out.
- :class:`HaloImpl` (``dist_agg="halo"``): the boundary-set exchange
  (:func:`regcn_torch.parallel.halo.halo_rgcn_aggregate`), one
  ``all_to_all`` of the source rows other shards need.

Either way every entity-axis step of the model (gathers of rows by global
id, the decoder's candidate axis, the CE's logsumexp, the ranks) runs on
the rank's own rows with explicit collectives. The snapshot must carry the
rank's partition of its edges (``snap.halo`` or ``snap.parts``); a layer
raises where it is absent, with no silent fallback.

It stays a leaf module (stdlib imports only), as JAX's is, so the model
modules can import it without the :mod:`regcn_torch.parallel` package,
which imports the models back.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShardedImpl:
    """Entity rows sharded over the ``graph`` axis of ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh`` with dims
    ``("data", "graph")``)."""

    mesh: Any

    def __str__(self) -> str:  # logs / error messages
        return self.dist_agg

    dist_agg = ""


@dataclasses.dataclass(frozen=True)
class GspmdImpl(ShardedImpl):
    """Select the all-gather aggregation over ``mesh``. ``route="cumsum"``
    (``Trainer(impl="cumsum")``, which JAX's ``check_impl_compatible``
    lets through under gspmd) reduces each rank's destination-sorted edges
    by the cumulative sum instead of B1."""

    route: str = "xla"  # the rank's local reduction: "xla" (B1) or "cumsum"

    dist_agg = "gspmd"


@dataclasses.dataclass(frozen=True)
class HaloImpl(ShardedImpl):
    """Select the boundary-halo aggregation over ``mesh``.

    Layers receiving this as their ``impl`` require the snapshot to carry
    the rank's halo partition (``snap.halo``, built by
    :func:`regcn_torch.parallel.halo.build_halo_store`); they raise if it
    is absent."""

    dist_agg = "halo"


def is_sharded(impl) -> bool:
    return isinstance(impl, ShardedImpl)


def sharded_impl(mesh, dist_agg: str, impl: str = "xla") -> ShardedImpl:
    """The marker of ``dist_agg`` over ``mesh``; under gspmd ``impl``
    "cumsum" keeps its route on each rank ("xla" and "pallas" both take
    B1). Call :func:`check_impl_compatible` first: the halo takes "xla"
    only."""
    if dist_agg == "halo":
        return HaloImpl(mesh)
    return GspmdImpl(mesh, route="cumsum" if impl == "cumsum" else "xla")


def require_halo(snap):
    """The layer-side guard: halo-partitioned edges or a loud error."""
    if getattr(snap, "halo", None) is None:
        raise ValueError(
            "impl is HaloImpl but the snapshot carries no halo partition; "
            "build the store with halo_shards=mesh size")
    return snap.halo


def require_parts(snap):
    """The GSPMD counterpart of :func:`require_halo`: the rank's
    destination-partitioned edges or a loud error."""
    if getattr(snap, "parts", None) is None:
        raise ValueError(
            "impl is GspmdImpl but the snapshot carries no edge partition; "
            "build it with regcn_torch.parallel.sharding.attach_partition")
    return snap.parts


def check_impl_compatible(impl, dist_agg: str) -> None:
    """Reject conflicting aggregation selections instead of silently
    overriding one (e.g. impl='pallas' together with dist_agg='halo' —
    the boundary halo REPLACES the scatter backend, it does not compose
    with it)."""
    if dist_agg == "halo" and isinstance(impl, str) and impl != "xla":
        raise ValueError(
            f"impl={impl!r} conflicts with dist_agg='halo': the boundary "
            f"halo replaces the aggregation backend; drop --impl or use "
            f"impl='xla'")


def halo_shards(mesh, dist_agg: str):
    """Graph-axis size when the boundary halo is active, else None."""
    if mesh is not None and dist_agg == "halo":
        from regcn_torch.parallel.mesh import graph_size  # deferred (cycle)

        return graph_size(mesh)
    return None


def attach_history_halo(history, snaps, num_nodes: int, num_rels: int,
                        shards: int, edge_bucket: int = 256):
    """Return ``history`` (a stacked Snapshot window) with boundary-halo
    partitions of the same snapshots attached (host numpy, all shards) —
    the per-step-path counterpart of JAX's
    ``build_snapshot_store(halo_shards=...)``. A rank takes its own slice
    with :func:`regcn_torch.parallel.halo.local_halo`."""
    from regcn_torch.parallel.halo import build_halo_store  # deferred (cycle)

    halo, _ = build_halo_store(list(snaps), num_nodes, num_rels, shards,
                               edge_bucket=edge_bucket)
    return dataclasses.replace(history, halo=halo)
