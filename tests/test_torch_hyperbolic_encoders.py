"""The port's fhnn and hgat encoders against regcn_tpu's.

- ``segment_softmax`` (``regcn_torch/ops/segment.py``) with empty and
  all-masked segments, one logit per edge and one per head: values, and
  the gradient of a random projection by the logits;
- ``einstein_midpoint_segments`` (``regcn_torch/hyperbolic/ops.py``) with
  an empty segment, per edge and per head: values, and the gradients by
  the points, the weights and a learned curvature;
- ``fhnn_layer`` and ``hgat_layer``, and two-layer ``encoder_cell``s of
  each (hgat with its gated skip), on a snapshot of the synthetic data:
  values, and the gradient of a random projection by every parameter, the
  input points, the relation embeddings and the curvature;
- the eight pairs {fhnn, hgat} x {hyperbolic_convtranse, murp, roth,
  atth} through the hyperbolic model: ``init_params``' leaves,
  ``get_loss``'s four losses and ``predict``; the gradient of the
  trainer's total by every parameter for the convtranse pairs. JAX's
  gradient of the whole model (compiled once, as its trainer compiles it)
  takes 8-12 s a pair, so the distance decoders, which
  ``tests/test_torch_hyperbolic_pairs.py`` holds with every gradient, are
  held by their losses here, and the encoders' own gradients by the layer
  and cell tests above.

The same parameters (JAX's, converted) and the same snapshot arrays go
to both packages, with dropout at 0. Tolerances: fp32 on both sides with
sums and transcendentals in another order, rtol 1e-4 / atol 1e-5;
gradients within atol 1e-5 * max(1, max|JAX gradient|) of each tensor,
but the curvature's, one number that sums a term of every entry of the
layer's output, within rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.hyperbolic import layers as JL
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic import ops as JH
from regcn_tpu.ops.segment import segment_softmax as jax_segment_softmax
from regcn_torch.convert import hyperbolic_params_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import layers as PL
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic import ops as PH
from regcn_torch.hyperbolic.train import compute_radius_targets
from regcn_torch.ops.segment import segment_softmax
from regcn_torch.train.optim import tree_leaves, tree_map

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
RTOL, ATOL = 1e-4, 1e-5
D = 8
C = 0.01
ENCODERS = ("fhnn", "hgat")
PAIRS = [(e, d) for e in ENCODERS for d in PM.DECODERS]
WITH_GRADIENTS = ("hyperbolic_convtranse",)
CONFIG4 = dict(learn_curvature=True, use_rel_curvature=True, use_entity_bias=True)
OPTIONS = {"hyperbolic_convtranse": dict(learn_curvature=True), "murp": CONFIG4,
           "atth": CONFIG4, "roth": dict(learn_curvature=True, use_entity_bias=True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=123, **TINY)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def close_grad(got, want, msg=""):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()),
                               err_msg=msg)


def close_c_grad(got, want, msg="c"):
    """The curvature's gradient: one sum over every output entry."""
    close(got, want, rtol=RTOL, atol=ATOL, msg=msg)


def snapshot(data, t=3):
    host = pt_snapshots.build_snapshot(pt_snapshots.split_by_time(data.train)[t], data.num_nodes,
                                       data.num_rels, edge_bucket=32)
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


def leaves_with_paths(tree):
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}[{i}]")]
    return [prefix]


# ------------------------------------------------------------------- ops

@pytest.mark.parametrize("heads", [None, 3])
def test_segment_softmax_matches_jax(heads):
    """Segments 0-5 over 12 entries: segment 2 empty, segment 4 all
    masked, masked entries inside segments 0 and 3; segment 5 a single
    entry. The softmax and its gradient equal JAX's; masked and empty
    give 0."""
    rng = np.random.default_rng(0)
    ids = np.array([0, 0, 0, 1, 1, 3, 3, 3, 4, 4, 5, 1])
    mask = np.array([1, 0, 1, 1, 1, 1, 0, 1, 0, 0, 1, 1], np.float32)
    shape = (len(ids),) if heads is None else (len(ids), heads)
    logits = (rng.normal(size=shape) * 5).astype(np.float32)
    probe = rng.normal(size=shape).astype(np.float32)

    def jax_fn(x):
        out = jax_segment_softmax(x, jnp.asarray(ids), jnp.asarray(mask), 7) if heads is None \
            else jax.vmap(lambda col: jax_segment_softmax(col, jnp.asarray(ids),
                                                          jnp.asarray(mask), 7),
                          in_axes=1, out_axes=1)(x)
        return jnp.sum(out * probe), out

    want_g, want = jax.jit(jax.grad(jax_fn, has_aux=True))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = segment_softmax(x, torch.from_numpy(ids), torch.from_numpy(mask), 7)
    close(got, want)
    masked = mask == 0
    assert float(got.detach()[torch.from_numpy(masked)].abs().max()) == 0.0
    (g,) = torch.autograd.grad(torch.sum(got * torch.from_numpy(probe)), x)
    close_grad(g, want_g)


@pytest.mark.parametrize("heads", [None, 2])
def test_einstein_midpoint_matches_jax(heads):
    """Ball points of radius up to 9 (c = 0.01: the boundary is at 10),
    weights with zeros, segment 3 empty: the midpoint, and the gradients by
    the points, the weights and c."""
    rng = np.random.default_rng(1)
    ids = np.array([0, 0, 1, 1, 1, 2, 4, 4, 0])
    lead = (len(ids),) if heads is None else (len(ids), heads)
    dirs = rng.normal(size=lead + (D,))
    radius = rng.uniform(0.5, 9.0, size=lead + (1,))
    points = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True) * radius).astype(np.float32)
    weights = rng.uniform(0, 1, size=lead).astype(np.float32)
    weights[1] = 0.0
    probe = rng.normal(size=(5,) + lead[1:] + (D,)).astype(np.float32)

    def jax_fn(p, w, c):
        if heads is None:
            out = JH.einstein_midpoint_segments(p, w, jnp.asarray(ids), 5, c)
        else:
            out = jax.vmap(lambda pp, ww: JH.einstein_midpoint_segments(
                pp, ww, jnp.asarray(ids), 5, c), in_axes=(1, 1), out_axes=1)(p, w)
        return jnp.sum(out * probe), out

    want_g, want = jax.jit(jax.grad(jax_fn, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(points), jnp.asarray(weights), jnp.float32(C))
    p = torch.from_numpy(points).requires_grad_(True)
    w = torch.from_numpy(weights).requires_grad_(True)
    c = torch.tensor(C, requires_grad=True)
    got = PH.einstein_midpoint_segments(p, w, torch.from_numpy(ids), 5, c)
    assert got.shape == (5,) + lead[1:] + (D,)
    close(got, want)
    assert float(got.detach()[3].abs().max()) == 0.0
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(probe)), (p, w, c))
    close_grad(grads[0], want_g[0], msg="points")
    close_grad(grads[1], want_g[1], msg="weights")
    close_c_grad(grads[2], want_g[2])


# ---------------------------------------------------------------- layers

def layer_inputs(data, seed=2):
    """Ball points [N, D] at tangent norms 0.5 to 15 (radius up to 9.05 of
    the ball's 10; nearer the edge the conformal factor amplifies fp32
    rounding past any tolerance), relation embeddings [2R, D]."""
    rng = np.random.default_rng(seed)
    tan = rng.normal(size=(data.num_nodes, D)).astype(np.float32)
    tan *= rng.uniform(0.5, 15, size=(data.num_nodes, 1)).astype(np.float32) / np.linalg.norm(
        tan, axis=-1, keepdims=True)
    h = np.asarray(JH.exp_map_zero(jnp.asarray(tan), C))
    rel = rng.normal(size=(2 * data.num_rels, D)).astype(np.float32)
    probe = rng.normal(size=(data.num_nodes, D)).astype(np.float32)
    return h, rel, probe


def init_layer(encoder, data, n_layers=None, skip=False):
    key = jax.random.PRNGKey(3)
    R2 = 2 * data.num_rels
    if n_layers is not None:
        return jax.tree.map(np.asarray, JL.init_encoder_cell(
            key, encoder, D, R2, n_layers, num_heads=4, skip_connect=skip))
    if encoder == "fhnn":
        return jax.tree.map(np.asarray, JL.init_fhnn_layer(key, D, R2))
    return jax.tree.map(np.asarray, JL.init_hgat_layer(key, D, R2, num_heads=4))


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree)).requires_grad_(True)


def compare_layer(data, jax_call, torch_call, params_np):
    pt_snap, jx_snap = snapshot(data)
    h, rel, probe = layer_inputs(data)

    def jax_fn(params, hh, rr, c):
        out = jax_call(params, hh, rr, jx_snap, c)
        return jnp.sum(out * probe), out

    want_g, want = jax.jit(jax.grad(jax_fn, argnums=(0, 1, 2, 3), has_aux=True))(
        jax.tree.map(jnp.asarray, params_np), jnp.asarray(h), jnp.asarray(rel), jnp.float32(C))
    params = torch_tree(params_np)
    th = torch.from_numpy(h.copy()).requires_grad_(True)
    tr = torch.from_numpy(rel).requires_grad_(True)
    c = torch.tensor(C, requires_grad=True)
    got = torch_call(params, th, tr, pt_snap, c)
    close(got, want)
    assert float(torch.linalg.vector_norm(got.detach(), dim=-1).max()) < 1.0 / C ** 0.5
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(probe)), leaves + [th, tr, c],
                                allow_unused=True)
    want_leaves = dict(leaves_with_paths(want_g[0]))
    for path, g in zip(paths(params), grads):
        close_grad(g, want_leaves[path], msg=path)
    close_grad(grads[len(leaves)], want_g[1], msg="h")
    close_grad(grads[len(leaves) + 1], want_g[2], msg="rel_emb")
    close_c_grad(grads[len(leaves) + 2], want_g[3])
    # every parameter takes part
    assert all(g is not None and float(g.abs().max()) > 0 for g in grads[:len(leaves)])


def test_fhnn_layer_matches_jax(data):
    compare_layer(data,
                  lambda p, h, r, s, c: JL.fhnn_layer(p, h, r, s, c),
                  lambda p, h, r, s, c: PL.fhnn_layer(p, h, r, s, c),
                  init_layer("fhnn", data))


def test_hgat_layer_matches_jax(data):
    compare_layer(data,
                  lambda p, h, r, s, c: JL.hgat_layer(p, h, r, s, c, num_heads=4),
                  lambda p, h, r, s, c: PL.hgat_layer(p, h, r, s, c),
                  init_layer("hgat", data))


@pytest.mark.parametrize("encoder", ENCODERS)
def test_encoder_cell_matches_jax(data, encoder):
    """Two layers; hgat's second with its gated skip from the first's input."""
    compare_layer(data,
                  lambda p, h, r, s, c: JL.encoder_cell(p, encoder, h, r, s, c, num_heads=4),
                  lambda p, h, r, s, c: PL.encoder_cell(p, encoder, h, r, s, c, num_heads=4),
                  init_layer(encoder, data, n_layers=2, skip=True))


def test_edge_transform_equals_per_edge_product(data):
    """The batched take lowering is the per-edge product ``tan @ W[rel]``."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(6, D, D)).astype(np.float32))
    tan = torch.from_numpy(rng.normal(size=(9, D)).astype(np.float32))
    rel = torch.from_numpy(rng.integers(0, 6, 9))
    want = torch.stack([tan[e] @ w[rel[e]] for e in range(9)])
    close(PL.fhnn_edge_transform(w, tan, rel), want.numpy(), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- pairs

def triples_of(data, t=4, bucket=64):
    return pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[t], data.num_rels,
                                    bucket)


def history(data, start=2, length=2):
    window = pt_snapshots.split_by_time(data.train)[start:start + length]
    host = pt_snapshots.build_history(window, data.num_nodes, data.num_rels, edge_bucket=32,
                                      rc_bucket=64)
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


def pair_configs(data, encoder, decoder):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=2,
                encoder=encoder, decoder=decoder, dropout=0.0, input_dropout=0.0,
                hidden_dropout=0.0, feat_dropout=0.0, skip_connect=True, **OPTIONS[decoder])
    return JM.HyperbolicConfig(**base), PM.HyperbolicConfig(**base)


def pair_init(data, encoder, decoder):
    jcfg, pcfg = pair_configs(data, encoder, decoder)
    rt = compute_radius_targets(pt_snapshots.split_by_time(data.train), data.num_nodes)
    params, state = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg, rt))
    got, _ = PM.init_params(torch.Generator().manual_seed(0), pcfg, rt, device="cpu")
    assert dict(zip(paths(got), [tuple(t.shape) for t in tree_leaves(got)])) == {
        p: v.shape for p, v in leaves_with_paths(params)}
    return jcfg, pcfg, (params, state), hyperbolic_params_from_jax(params, state, device="cpu")


def test_every_pair_is_ported():
    assert sorted(PM.PORTED) == sorted((e, d) for e in PL.ENCODERS for d in PM.DECODERS)


@pytest.mark.parametrize("encoder,decoder", PAIRS)
def test_pair_matches_jax(data, encoder, decoder):
    """``init_params``' leaves equal JAX's; ``get_loss``'s four losses in
    training mode (and, for the convtranse pairs, the gradient of
    the trainer's total by every parameter) and ``predict``'s scores equal
    JAX's, under a warmup bound on the curvature."""
    jcfg, pcfg, (jp, js), (cp, cs) = pair_init(data, encoder, decoder)
    pt_hist, jx_hist = history(data)
    triples, mask = triples_of(data)
    cmax = 0.028

    def total(p):
        _, losses, _, _ = JM.get_loss(p, jax.tree.map(jnp.asarray, js), jcfg, jx_hist,
                                      jnp.asarray(triples), jnp.asarray(mask), train=True,
                                      curvature_max=cmax)
        return (0.7 * losses["entity"] + 0.3 * losses["relation"] + losses["static"]
                + losses["radius"]), losses

    jp_dev = jax.tree.map(jnp.asarray, jp)
    grads_wanted = decoder in WITH_GRADIENTS
    if grads_wanted:
        want_g, want = jax.jit(jax.grad(total, has_aux=True))(jp_dev)
    else:
        _, want = jax.jit(total)(jp_dev)
    leaves = tree_leaves(cp)
    for p in leaves:
        p.requires_grad_(True)
    _, losses, _, _ = PM.get_loss(cp, cs, pcfg, pt_hist, torch.from_numpy(triples).long(),
                                  torch.from_numpy(mask), train=True, curvature_max=cmax)
    for k in ("entity", "relation", "static", "radius"):
        close(losses[k], want[k], msg=k)
    if grads_wanted:
        got_total = (0.7 * losses["entity"] + 0.3 * losses["relation"] + losses["static"]
                     + losses["radius"])
        grads = torch.autograd.grad(got_total, leaves, allow_unused=True)
        want_leaves = dict(leaves_with_paths(want_g))
        assert set(paths(cp)) == set(want_leaves)
        for path, g in zip(paths(cp), grads):
            close_grad(g, want_leaves[path], msg=path)
        assert np.abs(want_leaves["['rgcn']['layers'][0]['rel_weight']"]).max() > 0
    triples, mask = triples_of(data, t=5)
    with torch.no_grad():
        s_ob, s_rel = PM.predict(tree_map(torch.Tensor.detach, cp), cs, pcfg, pt_hist,
                                 torch.from_numpy(triples).long(), torch.from_numpy(mask))
    j_ob, j_rel = jax.jit(lambda p, s: JM.predict(p, s, jcfg, jx_hist, jnp.asarray(triples),
                                                  jnp.asarray(mask)))(
        jp_dev, jax.tree.map(jnp.asarray, js))
    close(s_ob, j_ob)
    close(s_rel, j_rel)
