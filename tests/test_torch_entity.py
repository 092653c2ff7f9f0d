"""The legacy entity classifier of the port against ``regcn_tpu``: the RDF
loader (``regcn_torch/data/rdf.py``), the basis-RGCN layer and the
classifier (``regcn_torch/models/entity_classifier.py``), on the CPU.

- the numpy functions equal JAX's output array for array: the edge norm,
  the BFS reach and prune (with and without relabeling), the synthetic
  presets, the cached-npz layout (dense and CSR labels) and the TSV one;
- ``to_static_graph`` sorts the edges by destination (padding keyed N,
  last), its weights are the edge norms, and its sum over every node's
  edges equals JAX's unsorted graph's within 1e-6;
- ``rgcn_basis_layer`` in the featureless and the projected mode, each
  with one basis per relation and with fewer bases (``w_comp``) in both
  orders of ``combine_bases`` (the fused gather, and the per-base loop
  that JAX takes above ``_BASIS_FUSE_ELEMS``, forced here by setting it
  to 0 in both packages): values and every gradient within 1e-5;
- ``entity_logits`` from JAX's initial parameters, and a 20-step ``fit``
  against JAX's (dropout 0): every epoch's loss within 1e-5, the final
  parameters within atol 1e-5 + rtol 1e-3 and the same accuracies;
- the classifier learns ``synthetic-entity-small`` (with dropout) well
  above chance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import regcn_tpu.models.layers as jax_layers
from regcn_tpu.data import rdf as jax_rdf
from regcn_tpu.models import entity_classifier as jax_ec
from regcn_torch.data import rdf
from regcn_torch.models import entity_classifier as ec
from regcn_torch.models import layers as pt_layers
from regcn_torch.train.optim import tree_map

FIELDS = ("edge_src", "edge_dst", "edge_type", "edge_norm", "labels", "train_idx", "test_idx")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_data(got, want):
    for f in ("name", "num_nodes", "num_rels", "num_classes"):
        assert getattr(got, f) == getattr(want, f), f
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.fixture(scope="module")
def small():
    return (rdf.load_entity_data("synthetic-entity-small", seed=3),
            jax_rdf.load_entity_data("synthetic-entity-small", seed=3))


# ------------------------------------------------------------------- loader

def test_numpy_functions_match_jax(small):
    data, _ = small
    g = np.random.default_rng(0)
    dst, etype = g.integers(0, 30, 200), g.integers(0, 4, 200)
    np.testing.assert_array_equal(rdf.compute_edge_norm(dst, etype),
                                  jax_rdf.compute_edge_norm(dst, etype))
    roots = np.where(data.labels >= 0)[0][:5]
    for depth in (0, 1, 2, 3):
        np.testing.assert_array_equal(
            rdf.bfs_levels(data.num_nodes, data.edge_src, data.edge_dst, roots, depth),
            jax_rdf.bfs_levels(data.num_nodes, data.edge_src, data.edge_dst, roots, depth))
    for name in ("synthetic-entity-small", "synthetic-aifb"):
        for bfs_level, relabel in ((2, False), (1, True), (0, False)):
            assert_same_data(rdf.generate_entity_class(name, seed=5, bfs_level=bfs_level,
                                                       relabel=relabel),
                             jax_rdf.generate_entity_class(name, seed=5, bfs_level=bfs_level,
                                                           relabel=relabel))
    base = dataclasses.asdict(data)
    for relabel in (False, True):
        got = rdf.bfs_prune(rdf.EntityClassData(**base), 1, relabel)
        want = jax_rdf.bfs_prune(jax_rdf.EntityClassData(**base), 1, relabel)
        assert_same_data(got, want)
    with pytest.raises(KeyError):
        rdf.generate_entity_class("synthetic-nothing")


def test_npz_and_tsv_layouts_match_jax(tmp_path):
    g = np.random.default_rng(1)
    n, nrel, n_classes = 40, 5, 3
    edges = np.stack([g.integers(0, n, 150), g.integers(0, n, 150), g.integers(0, nrel, 150)], 1)
    onehot = np.zeros((n, n_classes), np.float32)
    labeled = g.choice(n, 12, replace=False)
    onehot[labeled, g.integers(0, n_classes, 12)] = 1.0
    for layout in ("dense", "csr"):
        d = tmp_path / f"kb-{layout}"
        d.mkdir()
        np.savez(d / "edges.npz", n=n, nrel=nrel, edges=edges)
        if layout == "dense":
            np.savez(d / "labels.npz", labels=onehot)
        else:
            rows, cols = np.nonzero(onehot)
            indptr = np.searchsorted(rows, np.arange(n + 1))
            np.savez(d / "labels.npz", data=onehot[rows, cols], indices=cols, indptr=indptr,
                     shape=np.array(onehot.shape))
        np.save(d / "train_idx.npy", labeled[:8])
        np.save(d / "test_idx.npy", labeled[8:])
        for relabel in (False, True):
            assert_same_data(
                rdf.load_entity_data(d.name, data_dir=str(tmp_path), bfs_level=1,
                                     relabel=relabel),
                jax_rdf.load_entity_data(d.name, data_dir=str(tmp_path), bfs_level=1,
                                         relabel=relabel))
    d = tmp_path / "kb-tsv"
    d.mkdir()
    np.savetxt(d / "edges.txt", edges[:, [0, 2, 1]], fmt="%d")
    (d / "labels.txt").write_text("".join(
        f"{v} {i % n_classes} {'train' if i < 8 else 'test'}\n" for i, v in enumerate(labeled)))
    assert_same_data(rdf.load_entity_data("kb-tsv", data_dir=str(tmp_path)),
                     jax_rdf.load_entity_data("kb-tsv", data_dir=str(tmp_path)))


def test_static_graph_is_sorted_by_destination(small):
    data, jdata = small
    graph = rdf.to_static_graph(data, "cpu", 128)
    jgraph = jax_rdf.to_static_graph(jdata, 128)
    E, n = len(data.edge_src), data.num_nodes
    assert graph.src.shape[0] == jgraph.src.shape[0] == -(-E // 128) * 128
    keys = graph.keys.numpy()
    assert np.all(np.diff(keys) >= 0) and np.all(keys[E:] == n) and np.all(keys[:E] < n)
    assert np.all(graph.edge_norm.numpy()[E:] == 0)
    msg = np.random.default_rng(2).normal(size=(E, 3)).astype(np.float32)
    want = np.zeros((n, 3), np.float32)
    np.add.at(want, data.edge_dst, msg * data.edge_norm[:, None])
    order = np.argsort(data.edge_dst, kind="stable")
    padded = np.zeros((graph.src.shape[0], 3), np.float32)
    padded[:E] = msg[order]
    from regcn_torch.ops.rgcn_scatter import scatter_add_sorted

    got = scatter_add_sorted(torch.from_numpy(padded), graph.keys, n,
                             edge_weight=graph.edge_norm, row_scale=graph.in_deg_norm)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------------- basis layer

def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), tree)


@pytest.mark.parametrize("order", ["fused", "per_base"])
@pytest.mark.parametrize("n_bases", [-1, 3], ids=["per_relation", "w_comp"])
@pytest.mark.parametrize("input_layer", [True, False], ids=["featureless", "projected"])
def test_basis_layer_matches_jax(small, monkeypatch, input_layer, n_bases, order):
    data, jdata = small
    if order == "per_base":
        monkeypatch.setattr(jax_layers, "_BASIS_FUSE_ELEMS", 0)
        monkeypatch.setattr(pt_layers, "_BASIS_FUSE_ELEMS", 0)
    in_feat = data.num_nodes if input_layer else 6
    jp = jax_layers.init_rgcn_basis_layer(jax.random.PRNGKey(1), in_feat, 5, data.num_rels,
                                          num_bases=n_bases, bias=True)
    assert ("w_comp" in jp) == (n_bases > 0)
    h = np.random.default_rng(4).normal(size=(data.num_nodes, 6)).astype(np.float32)
    weights = np.random.default_rng(5).normal(size=(data.num_nodes, 5)).astype(np.float32)
    jgraph = jax_rdf.to_static_graph(jdata, 128)

    def jloss(p, x):
        out = jax_layers.rgcn_basis_layer(p, x, jgraph, input_layer=input_layer,
                                          activation=jax.nn.relu)
        return jnp.sum(out * weights), out

    (_, want), (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(h))
    pp, ph = to_torch(jp), torch.from_numpy(h).requires_grad_(True)
    out = pt_layers.rgcn_basis_layer(pp, ph, rdf.to_static_graph(data, "cpu", 128),
                                     input_layer=input_layer, activation=torch.relu)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    leaves = list(pp.values()) + ([] if input_layer else [ph])
    grads = torch.autograd.grad((out * torch.from_numpy(weights)).sum(), leaves)
    want_grads = list(jgp.values()) + ([] if input_layer else [jgh])
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- classifier

def test_logits_and_fit_match_jax(small):
    data, jdata = small
    kw = dict(h_dim=8, n_bases=4, n_hidden_layers=2, dropout=0.0, lr=1e-2, n_epochs=20)
    jcfg, cfg = jax_ec.EntityClassifierConfig(**kw), ec.EntityClassifierConfig(**kw)
    jparams = jax_ec.init_entity_classifier(jax.random.PRNGKey(0), jdata, jcfg)
    pparams = ec.init_entity_classifier(torch.Generator().manual_seed(0), data, cfg, "cpu")
    assert jax.tree.map(np.shape, jparams) == tree_map(lambda t: tuple(t.shape), pparams)
    params = to_torch(jparams)
    np.testing.assert_allclose(
        ec.entity_logits(params, rdf.to_static_graph(data, "cpu", 128), cfg).detach().numpy(),
        jax_ec.entity_logits(jparams, jax_rdf.to_static_graph(jdata, 128), jcfg),
        rtol=1e-5, atol=1e-5)
    want, want_losses = jax_ec.fit(jax.random.PRNGKey(0), jdata, jcfg)
    got, losses = ec.fit(0, data, cfg, device="cpu", params=params)
    assert len(losses) == 20
    np.testing.assert_allclose(losses, np.asarray(want_losses), rtol=1e-5, atol=1e-5)
    for name in want:
        for key, w in want[name].items():
            np.testing.assert_allclose(got[name][key].detach().numpy(), np.asarray(w),
                                       rtol=1e-3, atol=1e-5, err_msg=f"{name}.{key}")
    for idx in (data.train_idx, None):
        assert ec.evaluate(got, data, cfg, idx=idx) == pytest.approx(
            jax_ec.evaluate(want, jdata, jcfg, idx=idx))


def test_learns_the_small_preset_above_chance(small):
    data, _ = small
    cfg = ec.EntityClassifierConfig(dropout=0.2)
    params, losses = ec.fit(0, data, cfg, device="cpu")
    assert losses[-1] < 0.5 * losses[0]
    assert ec.evaluate(params, data, cfg, idx=data.train_idx) > 0.9
    assert ec.evaluate(params, data, cfg) > 2.0 / data.num_classes
