"""The host side of the port's entity sharding against regcn_tpu's, in one
process (no ranks; ``tests/test_torch_sharded_train.py`` runs them).

- ``partition_edges_by_dst``, ``partition_edges_boundary``,
  ``build_halo_store`` (with ``pad_front``) and ``_boundary_stats``: every
  array bit for bit JAX's, dtypes included, and the statistics equal, at
  G = 1, 2, 3, 4 and 8 (N = 50 does not divide by 3, 4 or 8: the last
  shard's rows run past N, as in JAX).
- ``check_entity_divisibility``: JAX's message.
- Each rank's ``LocalEdges``: the rank's edges keyed by local row,
  ascending with masked edges last, each destination's edges in the order
  of the unsharded builder's; and the aggregation each rank runs on them
  (``halo._aggregate``, B1's plain version on the CPU) against the
  unsharded ``rgcn_aggregate``, with the collectives stood in for by
  slicing every rank's rows in this one process: the all-gathered table
  for ``gspmd``, each owner's ``send_idx`` rows for ``halo``. fp32 sums in
  another order: rtol 1e-5, atol 1e-6 of the output's scale.
- The sharded trainer's refusals, raised before any collective, and the
  markers of ``regcn_torch/dist.py`` with their guards.
"""

import types

import jax
import numpy as np
import pytest
import torch

from regcn_tpu.parallel import halo as jax_halo
from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
from regcn_tpu.parallel.mesh import check_entity_divisibility as jax_check_divisibility
from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from regcn_torch.data.snapshots import build_snapshot
from regcn_torch.ops.rgcn_scatter import rgcn_aggregate
from regcn_torch.parallel import halo as H
from regcn_torch.parallel.mesh import check_entity_divisibility

N, R, D = 50, 6, 8
SHARDS = [1, 2, 3, 4, 8]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def snapshots(seed=0, sizes=(120, 7, 0, 60)):
    rng = np.random.default_rng(seed)
    out = []
    for m in sizes:
        t = np.stack([rng.integers(0, N, m), rng.integers(0, R, m), rng.integers(0, N, m)], 1)
        out.append(np.unique(t, axis=0).reshape(-1, 3))
    return out


def assert_fields_equal(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


PART_FIELDS = ("src", "dst_local", "rel", "edge_mask", "in_deg_norm", "has_in_edge")
HALO_FIELDS = ("int_src_local", "int_dst_local", "int_rel", "int_mask", "rem_src_halo",
               "rem_dst_local", "rem_rel", "rem_mask", "send_idx", "in_deg_norm", "has_in_edge")


@pytest.mark.parametrize("G", SHARDS)
@pytest.mark.parametrize("bucket", [16, 256])
def test_partition_edges_by_dst_matches_jax(G, bucket):
    for t in snapshots():
        got = H.partition_edges_by_dst(t, N, R, G, edge_bucket=bucket)
        want = jax_halo.partition_edges_by_dst(t, N, R, G, edge_bucket=bucket)
        assert_fields_equal(got, want, PART_FIELDS)
        assert got.rows_per_shard == want.rows_per_shard


@pytest.mark.parametrize("G", SHARDS)
def test_partition_edges_boundary_and_stats_match_jax(G):
    for t in snapshots(1):
        got, got_stats = H.partition_edges_boundary(t, N, R, G, edge_bucket=16, halo_bucket=8)
        want, want_stats = jax_halo.partition_edges_boundary(t, N, R, G, edge_bucket=16,
                                                             halo_bucket=8)
        assert_fields_equal(got, want, HALO_FIELDS)
        assert (got.rows_per_shard, got.halo_per_pair) == (want.rows_per_shard,
                                                           want.halo_per_pair)
        assert got_stats == want_stats
        core = H._boundary_core(t, N, R, G)
        assert H._boundary_stats(core, G, 8, N) == jax_halo._boundary_stats(
            jax_halo._boundary_core(t, N, R, G), G, 8, N)


@pytest.mark.parametrize("G", SHARDS)
@pytest.mark.parametrize("pad_front", [0, 3])
def test_build_halo_store_matches_jax(G, pad_front):
    got, got_stats = H.build_halo_store(snapshots(2), N, R, G, pad_front=pad_front,
                                        edge_bucket=32, halo_bucket=16)
    want, want_stats = jax_halo.build_halo_store(snapshots(2), N, R, G, pad_front=pad_front,
                                                 edge_bucket=32, halo_bucket=16)
    assert_fields_equal(got, want, HALO_FIELDS)
    assert got.send_idx.shape[0] == pad_front + 4
    assert got_stats == want_stats


def test_check_entity_divisibility_matches_jax():
    jmesh = jax_make_mesh(JaxMeshAxes(1, 4), devices=jax.devices()[:4])
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 4))
    check_entity_divisibility(48, mesh)
    jax_check_divisibility(48, jmesh)
    with pytest.raises(ValueError) as got:
        check_entity_divisibility(N, mesh)
    with pytest.raises(ValueError) as want:
        jax_check_divisibility(N, jmesh)
    assert str(got.value) == str(want.value) and "pad the entity id space to 52" in str(got.value)


def local_views(t, G, mode):
    if mode == "halo":
        store, _ = H.build_halo_store([t], N, R, G, edge_bucket=16, halo_bucket=8)
        return [H.local_halo(store, r).step(0) for r in range(G)], store
    store = H.build_partition_store([t], N, R, G, edge_bucket=16)
    return [H.local_parts(store, r).step(0) for r in range(G)], store


@pytest.mark.parametrize("G", [2, 4, 5])
@pytest.mark.parametrize("mode", ["gspmd", "halo"])
def test_local_edges_are_keyed_in_the_unsharded_order(G, mode):
    """Every real edge lands on its destination's rank once, keyed by its
    local row; each destination's edges keep the unsharded builder's
    (stable) order in gspmd mode, interior before remote in halo mode."""
    t = snapshots(3)[0]
    views, _ = local_views(t, G, mode)
    rows = -(-N // G)
    snap = build_snapshot(t, N, R, edge_bucket=16, use_native=False)
    seen = []
    for r, e in enumerate(views):
        keys = torch.where(e.edge_mask > 0, e.dst, e.rows)
        assert bool((keys[1:] >= keys[:-1]).all()) and e.rows == rows
        real = e.edge_mask > 0
        dst = e.dst[real] + r * rows
        if mode == "gspmd":
            src = e.src[real]
        else:
            src = torch.where(e.src[real] < rows, e.src[real] + r * rows, -1)
            assert e.send_idx.shape[0] == G
        seen += list(zip(dst.tolist(), e.rel[real].tolist(), src.tolist()))
    want = list(zip(snap.dst[:snap.num_edges].tolist(), snap.rel[:snap.num_edges].tolist(),
                    snap.src[:snap.num_edges].tolist()))
    if mode == "gspmd":
        assert seen == want
    else:
        assert sorted((d, rel) for d, rel, _ in seen) == sorted((d, rel) for d, rel, _ in want)


@pytest.mark.parametrize("G", [2, 4, 5])
@pytest.mark.parametrize("mode", ["gspmd", "halo"])
def test_each_ranks_aggregate_is_its_rows_of_the_unsharded_one(G, mode):
    t = snapshots(4)[0]
    rng = np.random.default_rng(5)
    rows = -(-N // G)
    h = torch.from_numpy(rng.normal(size=(G * rows, D)).astype(np.float32))
    h[N:] = 0.0  # rows past N exist only as the last shard's padding
    rel = torch.from_numpy(rng.normal(size=(2 * R, D)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(D, D)).astype(np.float32) / D)
    snap = build_snapshot(t, N, R, edge_bucket=16, use_native=False).to("cpu")
    want = rgcn_aggregate(h[:N], rel, w, snap.src, snap.dst, snap.rel, snap.edge_mask,
                          snap.in_deg_norm, dst_sorted=True)
    views, _ = local_views(t, G, mode)
    got = []
    for r, e in enumerate(views):
        own = h[r * rows:(r + 1) * rows]
        if mode == "gspmd":
            table = h  # the all-gather
        else:  # the all_to_all: owner g's send_idx rows for rank r
            halo = torch.cat([views[g].send_idx[r] + g * rows for g in range(G)])
            table = torch.cat([own, h[halo]])
        got.append(H._aggregate(table, rel, w, e))
    got = torch.cat(got)[:N]
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("what", ["cumsum", "pallas_halo"])
def test_trainer_refuses_what_a_mesh_does_not_run_yet(what):
    """The sharded trainer's refusals, before any collective: ``impl``
    "cumsum" or "pallas" with the halo raises JAX's ``check_impl_compatible``
    error (the halo replaces the aggregation backend). A data axis above 1,
    bf16 compute, ``run_analysis`` and ``impl="cumsum"`` under ``"gspmd"``,
    refused until they were ported, run on a mesh
    (``tests/test_torch_sharded_options.py``), as the static graph does
    (``tests/test_torch_sharded_static.py``)."""
    from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
    from regcn_torch.data.synthetic import generate
    from regcn_torch.train.loop import Trainer

    data = generate("synthetic-small", seed=123, num_ents=40, num_rels=5, num_snaps=10,
                    triples_per_snap=30, split=(6, 2, 2))
    model = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=8, n_layers=2)
    kw = dict(mesh=types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 2)),
              device="cpu", dist_agg="halo", impl="cumsum" if what == "cumsum" else "pallas")
    cfg = ExperimentConfig(model=ModelConfig(**model), train=TrainConfig())
    with pytest.raises(ValueError, match="conflicts with dist_agg='halo'"):
        Trainer(cfg, data, **kw)


def test_markers_and_their_guards():
    """``regcn_torch/dist.py`` as JAX's: ``halo_shards`` is the graph axis
    under the halo and None otherwise; the markers name their aggregation;
    a layer given a marker but a snapshot without the rank's partition
    raises instead of aggregating unsharded."""
    from regcn_torch import dist as D
    from regcn_torch.data.snapshots import build_history

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 4))
    assert D.halo_shards(mesh, "halo") == 4
    assert D.halo_shards(mesh, "gspmd") is None and D.halo_shards(None, "halo") is None
    assert [str(D.sharded_impl(mesh, m)) for m in ("gspmd", "halo")] == ["gspmd", "halo"]
    assert D.is_sharded(D.HaloImpl(mesh)) and not D.is_sharded("xla")
    snap = build_history(snapshots()[:1], N, R, edge_bucket=16, use_native=False)
    with pytest.raises(ValueError, match="no halo partition"):
        D.require_halo(snap)
    with pytest.raises(ValueError, match="no edge partition"):
        D.require_parts(snap)
    attached = D.attach_history_halo(snap, snapshots()[:1], N, R, 4, edge_bucket=16)
    assert D.require_halo(attached).send_idx.shape[:3] == (1, 4, 4)
