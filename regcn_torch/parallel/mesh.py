"""Device-mesh construction over a ``torch.distributed`` process group.

Counterpart of ``regcn_tpu/parallel/mesh.py``: the 2-D logical mesh

    ("data", "graph")

where the ``graph`` axis shards the entity dimension (the entity table and
its Adam moments, the evolved entity states, the decoder's candidate axis)
and ``data`` replicates. One rank of the process group holds one position
of the mesh. JAX builds its mesh over devices and lets GSPMD insert the
collectives; here the caller initialises the process group (its backend,
NCCL across cards or gloo, is the caller's choice: nothing in the package
picks one) and the port's sharded paths call the collectives themselves
(``regcn_torch/parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
GRAPH_AXIS = "graph"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: int = 1
    graph: int = 1


def make_mesh(axes: Optional[MeshAxes] = None, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``device_type`` with dims ``("data", "graph")``
    over the initialised default process group, rank r at position
    ``divmod(r, graph)``; ``axes`` defaults to every rank on ``graph``. The
    mesh's sub-groups take the default group's backend, so gloo on one card
    builds its mesh as it is (``init_device_mesh`` would pick NCCL)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if axes is None:
        axes = MeshAxes(data=1, graph=world)
    n = axes.data * axes.graph
    if n != world:
        raise ValueError(f"mesh needs {n} ranks, the process group has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(axes.data, axes.graph),
                      mesh_dim_names=(DATA_AXIS, GRAPH_AXIS))


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def graph_size(mesh) -> int:
    """The size of the mesh's ``graph`` axis (the entity shards)."""
    return axis_size(mesh, GRAPH_AXIS)


def check_entity_divisibility(num_ents: int, mesh) -> None:
    """Row-exact entity sharding requires num_ents % graph_size == 0.

    Raised early with an actionable message instead of a shape error deep
    in a collective. Datasets whose entity count is not a multiple of
    the mesh should pad the id space with inert entities (never appearing
    in any triple); note padded ids DO participate in full-candidate
    scoring, so also extend filter/answer masks if exact MRR parity with
    the unpadded run is required.
    """
    g = graph_size(mesh)
    if num_ents % g != 0:
        raise ValueError(
            f"num_ents={num_ents} is not divisible by the '{GRAPH_AXIS}' "
            f"mesh axis ({g}); pad the entity id space to "
            f"{((num_ents + g - 1) // g) * g} (see docstring)")


def check_words_divisibility(num_words: int, mesh) -> None:
    """The static graph's ``words_emb`` is row-sharded as the entity table
    is, so ``num_words`` must be a multiple of the ``graph`` axis too; JAX
    refuses the same table at ``device_put``. Raised at the trainer's
    construction, before any collective."""
    g = graph_size(mesh)
    if num_words % g != 0:
        raise ValueError(
            f"num_words={num_words} is not divisible by the '{GRAPH_AXIS}' mesh axis ({g}): "
            "the static graph's words_emb is row-sharded over it, as the entity table is")


def graph_rank(mesh) -> int:
    """This rank's position on the ``graph`` axis: its shard of rows."""
    return int(mesh.get_local_rank(GRAPH_AXIS))


def graph_group(mesh):
    """The process group of this rank's ``graph`` axis."""
    return mesh.get_group(GRAPH_AXIS)


def row_shard(mesh, num_rows: int):
    """This rank's :class:`~regcn_torch.parallel.collectives.RowShard` of an
    [num_rows, ...] table row-sharded over the mesh's ``graph`` axis."""
    from regcn_torch.parallel.collectives import RowShard

    g = graph_size(mesh)
    return RowShard(graph_group(mesh), graph_rank(mesh), g, num_rows // g)


def table_shard(impl, rows: int):
    """This rank's ``RowShard`` of the entity table, of which it holds
    ``rows`` rows, under a sharded ``impl`` (``regcn_torch/dist.py``), else
    None."""
    from regcn_torch.dist import is_sharded

    if not is_sharded(impl):
        return None
    return row_shard(impl.mesh, graph_size(impl.mesh) * rows)
