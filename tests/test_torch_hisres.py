"""The port's HisRES data, layers and model against regcn_tpu.hisres.

- the snapshot builders' relation context with ``rc_mode="src"``;
- ``HistoryStore``: its event tables, both vocabularies, ``rel_pairs`` in
  both window modes, ``his_graph`` (with and without its edge cap), the
  save / load round trip and ``build_time_graph``, all equal to JAX's bit
  for bit; the history graph up to the order of its edges, which the port
  stores sorted by destination;
- ``hisres_union_layer`` and ``hisres_rgcn_cell`` (their sum on B1's plain
  version), ``cand_rgcn_layer`` and ``cand_cell`` (the attention-weighted
  sum on B1 with the weight's gradient): values, new BatchNorm statistics,
  and the gradient of a random projection by every parameter and input;
- ``init_params``' leaves, ``get_loss``'s three losses and the gradient of
  the trainer's total by every parameter, with and without the static
  graph, and ``predict``.

The same parameters (JAX's, converted) and the same arrays go to both
packages, dropouts 0. Tolerances: fp32 on both sides with sums in
another order, rtol 1e-4 / atol 1e-5; gradients within atol 1e-5 *
max(1, max|JAX gradient|) of each tensor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.hisres import history as JHist
from regcn_tpu.hisres import layers as JL
from regcn_tpu.hisres import model as JM
from regcn_torch.convert import hisres_params_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hisres import history as PHist
from regcn_torch.hisres import layers as PL
from regcn_torch.hisres import model as PM
from regcn_torch.hisres.train import union_snapshots
from regcn_torch.train.optim import tree_leaves

TINY = dict(num_ents=50, num_rels=4, num_snaps=12, triples_per_snap=30, split=(8, 2, 2))
RTOL, ATOL = 1e-4, 1e-5
D = 8
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0,
                  cand_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=31, with_static=True, **TINY)


@pytest.fixture(scope="module")
def snaps(data):
    return (pt_snapshots.split_by_time(data.train) + pt_snapshots.split_by_time(data.valid)
            + pt_snapshots.split_by_time(data.test))


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def close_grad(got, want, msg=""):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def both(host):
    """A host Snapshot as the port's tensors and as JAX's Snapshot."""
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


def leaves_with_paths(tree):
    return dict((jax.tree_util.keystr(k), np.asarray(v))
                for k, v in jax.tree_util.tree_flatten_with_path(tree)[0])


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}[{i}]")]
    return [prefix]


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree)).requires_grad_(True)


# ------------------------------------------------------------------- data

def test_relation_context_src_mode_equals_jax(snaps, data):
    for rc_mode in ("src", "both"):
        got = pt_snapshots.build_history(snaps[2:5], data.num_nodes, data.num_rels,
                                         edge_bucket=32, rc_bucket=32, rc_mode=rc_mode)
        want = jax_snapshots.build_history(snaps[2:5], data.num_nodes, data.num_rels,
                                           edge_bucket=32, rc_bucket=32, rc_mode=rc_mode)
        for f in pt_snapshots._ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    src = pt_snapshots._relation_context_pairs(snaps[3], data.num_rels, "src")
    assert set(src[1].tolist()) == set(snaps[3][:, 0].tolist())


@pytest.fixture(scope="module")
def stores(data, snaps):
    return {mode: (PHist.HistoryStore(data.num_nodes, data.num_rels, 3, mode).build(snaps),
                   JHist.HistoryStore(data.num_nodes, data.num_rels, 3, mode).build(snaps))
            for mode in ("full", "endpoints")}


def queries(snaps, t, num_rels, bucket=32):
    """(raw, inv, mask) as the trainers pad them."""
    arr = snaps[t][:, :3].astype(np.int32)
    raw = np.zeros((bucket * (-(-len(arr) // bucket)), 3), np.int32)
    raw[:len(arr)] = arr
    mask = np.zeros(len(raw), np.float32)
    mask[:len(arr)] = 1.0
    inv = raw[:, [2, 1, 0]].copy()
    inv[:, 1] += num_rels
    return raw, inv, mask


def test_history_store_tables_and_vocabularies_equal_jax(stores, snaps, data):
    got, want = stores["full"]
    for f in ("_tail_key", "_tail_o", "_tail_tfirst", "_rel_key", "_rel_r", "_rel_t"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for mode, (got, want) in stores.items():
        for t in (0, 1, 3, 7, 11):
            raw, inv, _ = queries(snaps, min(t, len(snaps) - 1), data.num_rels)
            allq = np.concatenate([raw, inv])
            for a, b in zip(got.rel_pairs(allq, t), want.rel_pairs(allq, t)):
                np.testing.assert_array_equal(a, b, err_msg=f"{mode} rel_pairs t={t}")
            np.testing.assert_array_equal(got.rel_vocab(allq, t), want.rel_vocab(allq, t))
            np.testing.assert_array_equal(got.tail_vocab(allq, t), want.tail_vocab(allq, t))
            for a, b in zip(got._tail_pairs(allq, t), want._tail_pairs(allq, t)):
                np.testing.assert_array_equal(a, b)


def edge_set(g):
    e = g.num_edges
    return sorted(zip(g.src[:e].tolist(), g.dst[:e].tolist(), g.rel[:e].tolist()))


@pytest.mark.parametrize("max_edges", [None, 40])
def test_his_graph_equals_jax_up_to_edge_order(stores, snaps, data, max_edges):
    """Every field equal; the real edges the same multiset, the port's
    stably sorted by destination; a capped graph keeps JAX's sample."""
    got_store, want_store = stores["full"]
    capped = 0
    for t in (1, 4, 9):
        raw, inv, mask = queries(snaps, t, data.num_rels)
        for q, is_inv in ((raw, False), (inv, True)):
            got = got_store.his_graph(q, mask, t, inv=is_inv, edge_bucket=64, max_edges=max_edges)
            want = want_store.his_graph(q, mask, t, inv=is_inv, edge_bucket=64,
                                        max_edges=max_edges)
            assert got.dst_sorted and got.num_edges == want.num_edges > 0
            capped += got.num_edges == max_edges
            assert edge_set(got) == edge_set(want)
            e = got.num_edges
            assert np.all(np.diff(got.dst[:e]) >= 0)
            order = np.argsort(want.dst[:e], kind="stable")
            for f in ("src", "dst", "rel"):
                np.testing.assert_array_equal(getattr(got, f)[:e], getattr(want, f)[:e][order])
            for f in ("edge_mask", "in_deg_norm", "has_in_edge", "rc_rel", "rc_ent", "rc_mask"):
                np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
            assert len(got.src) == len(want.src)
    assert (capped > 0) == (max_edges is not None)


def test_history_store_save_load_and_time_graph_equal_jax(stores, snaps, data, tmp_path):
    got, want = stores["full"]
    got.save(str(tmp_path))
    loaded = PHist.HistoryStore.load(str(tmp_path), data.num_nodes, data.num_rels,
                                     len(snaps), 3)
    raw, inv, _ = queries(snaps, 6, data.num_rels)
    allq = np.concatenate([raw, inv])
    np.testing.assert_array_equal(loaded.tail_vocab(allq, 6), want.tail_vocab(allq, 6))
    got_g = PHist.build_time_graph(12, [0, 1], [2, 3], 2, edge_bucket=16)
    want_g = JHist.build_time_graph(12, [0, 1], [2, 3], 2, edge_bucket=16)
    for f in pt_snapshots._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(got_g, f), getattr(want_g, f), err_msg=f)


# ----------------------------------------------------------------- layers

def layer_inputs(data, seed=2):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(data.num_nodes, D)).astype(np.float32)
    rel = rng.normal(size=(2 * data.num_rels, D)).astype(np.float32)
    return h, rel, rng.normal(size=(data.num_nodes, D)).astype(np.float32), \
        rng.normal(size=(2 * data.num_rels, D)).astype(np.float32)


def his_graph(stores, snaps, data, t=6):
    raw, _, mask = queries(snaps, t, data.num_rels)
    return both(stores["full"][0].his_graph(raw, mask, t, edge_bucket=64))


def compare(jax_fn, torch_fn, params_np, h, rel, n_out):
    """jax_fn/torch_fn(params, h, rel) -> (outputs..., aux); the sum of each
    output times its probe, and its gradient by every parameter, h and rel."""
    def j(p, hh, rr):
        *outs, aux = jax_fn(p, hh, rr)
        return sum(jnp.sum(o * pr) for o, pr in zip(outs, n_out)), (outs, aux)

    want_g, (want, want_aux) = jax.jit(jax.grad(j, argnums=(0, 1, 2), has_aux=True))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(h), jnp.asarray(rel))
    params = torch_tree(params_np)
    th, tr = torch.from_numpy(h).requires_grad_(True), torch.from_numpy(rel).requires_grad_(True)
    *got, aux = torch_fn(params, th, tr)
    for g, w in zip(got, want):
        close(g, w)
    leaves = tree_leaves(params)
    total = sum(torch.sum(o * torch.from_numpy(pr)) for o, pr in zip(got, n_out))
    grads = torch.autograd.grad(total, leaves + [th, tr], allow_unused=True)
    want_leaves = leaves_with_paths(want_g[0])
    for path, g in zip(paths(params), grads):
        close_grad(g, want_leaves[path], msg=path)
        assert g is not None and float(g.abs().max()) > 0, path
    close_grad(grads[-2], want_g[1], msg="h")
    close_grad(grads[-1], want_g[2], msg="rel_emb")
    return aux, want_aux


def test_hisres_union_layer_and_cell_match_jax(snaps, data):
    """The layer on one snapshot, and the two-layer cell that threads the
    relation embedding through it, on a three-snapshot window's first."""
    host = pt_snapshots.build_snapshot(snaps[4], data.num_nodes, data.num_rels, edge_bucket=32,
                                       rc_mode="src")
    pt_snap, jx_snap = both(host)
    h, rel, ph, pr = layer_inputs(data)
    layer = jax.tree.map(np.asarray, JL.init_hisres_union_layer(jax.random.PRNGKey(1), D))
    compare(lambda p, hh, rr: (*JL.hisres_union_layer(p, hh, rr, jx_snap), None),
            lambda p, hh, rr: (*PL.hisres_union_layer(p, hh, rr, pt_snap), None),
            layer, h, rel, (ph, pr))
    cell = jax.tree.map(np.asarray, JL.init_hisres_rgcn_cell(jax.random.PRNGKey(2), D, 2))
    compare(lambda p, hh, rr: (*JL.hisres_rgcn_cell(p, hh, rr, jx_snap), None),
            lambda p, hh, rr: (*PL.hisres_rgcn_cell(p, hh, rr, pt_snap), None),
            cell, h, rel, (ph, pr))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cand_layer_and_cell_match_jax(stores, snaps, data, train):
    """On a history graph: the layer and the two-layer cell, their new BN
    statistics (the batch statistics of the real edges in training)."""
    pt_g, jx_g = his_graph(stores, snaps, data)
    h, rel, ph, _ = layer_inputs(data)
    params, bn = JL.init_cand_layer(jax.random.PRNGKey(3), D)
    params, bn = jax.tree.map(np.asarray, (params, bn))
    if not train:  # running statistics away from their initial values
        bn = {"mean": np.full(1, 0.3, np.float32), "var": np.full(1, 1.7, np.float32)}
    aux, want_aux = compare(
        lambda p, hh, rr: JL.cand_rgcn_layer(p, jax.tree.map(jnp.asarray, bn), hh, rr, jx_g,
                                             dropout=0.0, train=train),
        lambda p, hh, rr: PL.cand_rgcn_layer(p, {k: torch.tensor(v) for k, v in bn.items()},
                                             hh, rr, pt_g, dropout=0.0, train=train),
        params, h, rel, (ph,))
    for k in ("mean", "var"):
        close(aux[k], want_aux[k], msg=k)
    cell, bns = JL.init_cand_cell(jax.random.PRNGKey(4), D, 2)
    cell, bns = jax.tree.map(np.asarray, (cell, bns))
    aux, want_aux = compare(
        lambda p, hh, rr: JL.cand_cell(p, jax.tree.map(jnp.asarray, bns), hh, rr, jx_g,
                                       dropout=0.0, train=train),
        lambda p, hh, rr: PL.cand_cell(p, [{k: torch.tensor(v) for k, v in b.items()}
                                           for b in bns], hh, rr, pt_g, dropout=0.0,
                                       train=train),
        cell, h, rel, (ph,))
    for a, w in zip(aux, want_aux):
        for k in ("mean", "var"):
            close(a[k], w[k], msg=k)


# ------------------------------------------------------------------ model

def step_inputs(stores, snaps, data, t=5, hlen=3):
    """Both packages' get_loss inputs for snapshot t after its window."""
    window = snaps[t - hlen:t]
    hist = both(pt_snapshots.build_history(window, data.num_nodes, data.num_rels, 32, 32,
                                           rc_mode="src"))
    hist_gg = both(pt_snapshots.build_history(union_snapshots(window), data.num_nodes,
                                              data.num_rels, 32, 32, rc_mode="src"))
    raw, inv, mask = queries(snaps, t, data.num_rels)
    store = stores["full"][0]
    graphs = [both(store.his_graph(q, mask, t, inv=i, edge_bucket=64))
              for q, i in ((raw, False), (inv, True))]
    vocab = store.rel_vocab(np.concatenate([raw, inv]), t)
    vocab[np.concatenate([mask, mask]) == 0] = 0.0
    pt = (hist[0], hist_gg[0], torch.from_numpy(raw).long(), torch.from_numpy(inv).long(),
          torch.from_numpy(mask), graphs[0][0], graphs[1][0], torch.from_numpy(vocab))
    jx = (hist[1], hist_gg[1], jnp.asarray(raw), jnp.asarray(inv), jnp.asarray(mask),
          graphs[0][1], graphs[1][1], jnp.asarray(vocab))
    return pt, jx


def configs(data, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=2,
                n_bases=4, **NO_DROPOUT)
    base.update(kw)
    return JM.HisResConfig(**base), PM.HisResConfig(**base)


def static_pair(data):
    host = pt_snapshots.build_snapshot(data.static_triples, data.num_nodes + data.num_words,
                                       data.num_static_rels, edge_bucket=32)
    return both(host)


@pytest.mark.parametrize("use_static", [False, True], ids=["dynamic", "static"])
def test_get_loss_every_gradient_and_predict_match_jax(stores, snaps, data, use_static):
    """``init_params``' leaves equal JAX's; the three losses, the new BN
    states and the gradient of the trainer's total (0.7 entity + 0.3
    relation + static) by every parameter; then ``predict``'s [2B, N]
    entity and [2B, 2R] relation scores."""
    kw = dict(use_static=True, num_static_rels=data.num_static_rels,
              num_words=data.num_words) if use_static else {}
    jcfg, pcfg = configs(data, **kw)
    jp, js = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    got, _ = PM.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert {p: tuple(t.shape) for p, t in zip(paths(got), tree_leaves(got))} == {
        p: v.shape for p, v in leaves_with_paths(jp).items()}
    cp, cs = hisres_params_from_jax(jp, js, device="cpu")
    pt_in, jx_in = step_inputs(stores, snaps, data)
    pt_static, jx_static = static_pair(data) if use_static else (None, None)
    js_dev = jax.tree.map(jnp.asarray, js)

    def total(p):
        _, losses, new = JM.get_loss(p, js_dev, jcfg, *jx_in, static_snap=jx_static, train=True)
        return 0.7 * losses["entity"] + 0.3 * losses["relation"] + losses["static"], (losses,
                                                                                     new)

    want_g, (want, want_state) = jax.jit(jax.grad(total, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    leaves = tree_leaves(cp)
    for p in leaves:
        p.requires_grad_(True)
    _, losses, new = PM.get_loss(cp, cs, pcfg, *pt_in, static_snap=pt_static, train=True)
    for k in ("entity", "relation", "static"):
        close(losses[k], want[k], msg=k)
    assert (float(losses["static"].detach()) > 0) == use_static
    for f in dataclasses.fields(new):
        tree, want_tree = getattr(new, f.name), leaves_with_paths(getattr(want_state, f.name))
        assert set(paths(tree)) == set(want_tree)
        for path, a in zip(paths(tree), tree_leaves(tree)):
            close(a, want_tree[path], msg=f"{f.name}{path}")
    grads = torch.autograd.grad(0.7 * losses["entity"] + 0.3 * losses["relation"]
                                + losses["static"], leaves, allow_unused=True)
    want_leaves = leaves_with_paths(want_g)
    assert set(paths(cp)) == set(want_leaves)
    for path, g in zip(paths(cp), grads):
        close_grad(g, want_leaves[path], msg=path)
    for path in ("['cand_raw']['layers'][1]['attn_fc_w']", "['cand_inv']['layers'][0]['conv_b']",
                 "['rgcn_2']['layers'][1]['w_neighbor']", "['weight_t2']"):
        assert np.abs(want_leaves[path]).max() > 0, path

    with torch.no_grad():
        s_ent, s_rel = PM.predict(cp, cs, pcfg, *pt_in, static_snap=pt_static)
    j_ent, j_rel = JM.predict(jax.tree.map(jnp.asarray, jp), js_dev, jcfg, *jx_in,
                              static_snap=jx_static)
    B = pt_in[2].shape[0]
    assert s_ent.shape == (2 * B, data.num_nodes) and s_rel.shape == (2 * B, 2 * data.num_rels)
    close(s_ent, j_ent)
    close(s_rel, j_rel)


def test_unported_configs_raise(data):
    """The halo aggregation, once refused, is ported on a mesh
    (``tests/test_torch_sharded_hisres.py``): ``impl="halo"`` names no
    single-device route and raises, and a mesh's marker with bf16 compute,
    not ported there yet, raises naming its ROADMAP item (the static graph,
    refused there until it was ported, runs in
    ``tests/test_torch_sharded_static.py``); bf16
    compute, refused until it was ported, initialises fp32 parameters, and
    a dtype JAX does not offer raises."""
    import types

    from regcn_torch.dist import HaloImpl

    _, pcfg = configs(data)
    with pytest.raises(ValueError, match="no single-device route"):
        PM.init_params(torch.Generator().manual_seed(0), dataclasses.replace(pcfg, impl="halo"),
                       device="cpu")
    marker = HaloImpl(types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 2)))
    with pytest.raises(NotImplementedError, match="A.11b"):
        PM.init_params(torch.Generator().manual_seed(0),
                       dataclasses.replace(pcfg, impl=marker, compute_dtype="bfloat16"),
                       device="cpu")
    params, _ = PM.init_params(torch.Generator().manual_seed(0),
                               dataclasses.replace(pcfg, compute_dtype="bfloat16"), device="cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(params))
    with pytest.raises(ValueError, match="compute dtype"):
        PM.init_params(torch.Generator().manual_seed(0),
                       dataclasses.replace(pcfg, compute_dtype="float16"), device="cpu")
