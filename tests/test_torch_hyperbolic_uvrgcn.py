"""The port's hyperbolic headline (uvrgcn + tangent ConvTransE/R) against
regcn_tpu.hyperbolic, module by module.

JAX's init_params(PRNGKey(0)) goes through hyperbolic_params_from_jax, so
both packages see the same parameters; every other input comes from a
numpy default_rng seed, and every dropout is 0. Tolerances: fp32 on both
sides with sums and transcendentals in another order, rtol 1e-4 / atol
1e-5; gradients within rtol 1e-4 and atol 1e-5 * max(1, max|JAX
gradient|) of each array, because a gradient entry sums many terms that
cancel. The exception is each ConvTrans decoder's ``conv_b`` and
``fc_b``: a batch-statistics BatchNorm follows each, so their true
gradient is 0 and both packages give rounding noise; the port's is held
to 1e-6 of the largest gradient instead.

The uvrgcn's radius weight exp(-γ|r_src - r_dst|) sits on the kink of
|x| at every self-edge and between entities of equal radius, where
``jax.grad(jnp.abs)(0.)`` is 1 and torch's abs has 0: a case builds both
and checks that the gradients agree, and that torch's own abs would not.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.hyperbolic import decoders as JD
from regcn_tpu.hyperbolic import layers as JL
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic import ops as JH
from regcn_torch.convert import hyperbolic_params_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import decoders as PD
from regcn_torch.hyperbolic import layers as PL
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic import ops as PH
from regcn_torch.hyperbolic.train import compute_radius_targets
from regcn_torch.train.optim import tree_leaves, tree_map

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
D = 8
RTOL, ATOL = 1e-4, 1e-5
C = 0.01
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
# the biases that a batch-statistics BatchNorm follows: their true gradient is 0
SHIFT_INVARIANT = {f"['{dec}']['{b}']" for dec in ("decoder_ob", "decoder_rel")
                   for b in ("conv_b", "fc_b")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save,
    and on a CPU shared with other test workers far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def close_grad(got, want, msg=""):
    want = np.asarray(want)
    close(got, want, atol=ATOL * max(1.0, np.abs(want).max()), msg=msg)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=123, **TINY)


def configs(data, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=2,
                encoder="hyperbolic_uvrgcn", decoder="hyperbolic_convtranse", c=C, **NO_DROPOUT)
    base.update(kw)
    return JM.HyperbolicConfig(**base), PM.HyperbolicConfig(**base)


def init(data, **kw):
    """(jax config, torch config, jax params+state, torch params+state)."""
    jcfg, pcfg = configs(data, **kw)
    rt = compute_radius_targets(pt_snapshots.split_by_time(data.train), data.num_nodes)
    params, state = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg, rt))
    converted = hyperbolic_params_from_jax(params, state, device="cpu")
    return jcfg, pcfg, jax.tree.map(jnp.asarray, (params, state)), converted


def as_jax(host):
    return jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)


def history(data, start=2, length=3, empty_first=False):
    """(torch, JAX) history windows of the same arrays."""
    window = pt_snapshots.split_by_time(data.train)[start:start + length]
    host = pt_snapshots.build_history(window, data.num_nodes, data.num_rels,
                                      edge_bucket=32, rc_bucket=64)
    if empty_first:  # an all-masked step, as JAX's fused paths front-pad
        host.edge_mask[0] = 0.0
        host.rc_mask[0] = 0.0
    return host.to("cpu"), as_jax(host)


def tangent(rng, n):
    """Tangent rows of norms 5-30 (ball radii ~4.6-9.5 at c = 0.01)."""
    v = rng.normal(size=(n, D))
    v *= rng.uniform(5.0, 30.0, (n, 1)) / np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def paths(tree, prefix=""):
    """JAX keystr paths of a nested dict/list, in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}[{i}]")]
    return [prefix]


def keyed(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------- (a) ops

@pytest.mark.parametrize("learned", [False, True], ids=["fixed_c", "tensor_c"])
def test_radius_maps_match_jax(rng, learned):
    """radius_from_tangent and apply_radius_tangent: values and gradients
    by v, the radius and (a tensor) c; radii below eps and past the ball's
    edge hit the clip, a zero row the norm's eps."""
    v = tangent(rng, 12)
    v[3] = 0.0
    v[4] *= 100.0  # tanh saturates: the radius clamps below the edge
    radius = rng.uniform(0.5, 3.0, 12).astype(np.float32)
    radius[:2] = (0.0, 50.0)
    G = rng.normal(size=(2, 12, D)).astype(np.float32)

    def jax_fn(v, r, c):
        return (jnp.sum(JH.radius_from_tangent(v, c) * G[0, :, 0])
                + jnp.sum(JH.apply_radius_tangent(v, r, c) * G[1]))

    jc = jnp.asarray(C, jnp.float32)
    want_val = (JH.radius_from_tangent(jnp.asarray(v), jc),
                JH.apply_radius_tangent(jnp.asarray(v), jnp.asarray(radius), jc))
    want_grads = jax.grad(jax_fn, argnums=(0, 1, 2))(jnp.asarray(v), jnp.asarray(radius), jc)
    leaves = [t(v).requires_grad_(True), t(radius).requires_grad_(True),
              torch.tensor(C).requires_grad_(True)]
    c = leaves[2] if learned else C
    got_val = (PH.radius_from_tangent(leaves[0], c),
               PH.apply_radius_tangent(leaves[0], leaves[1], c))
    for g, w in zip(got_val, want_val):
        close(g, w)
    total = (torch.sum(got_val[0] * t(G[0, :, 0])) + torch.sum(got_val[1] * t(G[1])))
    got_grads = torch.autograd.grad(total, leaves[:3] if learned else leaves[:2])
    for name, g, w in zip(("v", "radius", "c"), got_grads, want_grads):
        close_grad(g, w, msg=name)


# ------------------------------------------------------------ (b) layers

def tie_snapshot(data, v):
    """One snapshot with a self-edge and an edge between entities 7 and 9,
    whose tangent rows are negatives of each other: their radii are
    bitwise equal, so |r_src - r_dst| is 0 on both edges."""
    real = pt_snapshots.split_by_time(data.train)[3]
    extra = np.array([[7, 1, 7], [7, 2, 9], [11, 0, 11]])
    host = pt_snapshots.build_history([np.concatenate([real, extra])], data.num_nodes,
                                      data.num_rels, edge_bucket=32, rc_bucket=64)
    v[9] = -v[7]
    return host


def layer_snapshot(data, case):
    """(torch snapshot, JAX snapshot) of one step; ``unsorted`` shuffles the
    edges (dst_sorted False), so the radius weights must follow them."""
    window = pt_snapshots.split_by_time(data.train)[3:4]
    host = pt_snapshots.build_history(window, data.num_nodes, data.num_rels, edge_bucket=32,
                                      rc_bucket=64)
    if case == "unsorted":
        order = np.random.default_rng(6).permutation(host.src.shape[1])
        for f in ("src", "dst", "rel", "edge_mask"):
            getattr(host, f)[0] = getattr(host, f)[0][order]
        host = dataclasses.replace(host, dst_sorted=False)
    return host


def layer_inputs(data, rng, case):
    v = tangent(rng, data.num_nodes)
    host = tie_snapshot(data, v) if case == "tie" else layer_snapshot(data, case)
    rel = rng.normal(size=(2 * data.num_rels, D)).astype(np.float32)
    return v, rel, host.to("cpu").step(0), jax.tree.map(lambda a: a[0], as_jax(host))


@pytest.mark.parametrize("case,layer,impl", [
    ("sorted", 0, "xla"), ("sorted", 1, "xla"), ("unsorted", 1, "xla"), ("tie", 1, "xla"),
    ("sorted", 1, "pallas")])
def test_union_layer_tangent_matches_jax(data, rng, case, layer, impl):
    """Values and gradients by v, prev_v, rel_emb and every weight of the
    layer (layer 1 has the skip gate); ``pallas`` runs JAX's B1 kernel in
    interpret mode, as the JAX package's own tests run it on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    _, _, (jp, _), (cp, _) = init(data, skip_connect=True)
    v, rel, snap, jsnap = layer_inputs(data, rng, case)
    prev = tangent(rng, data.num_nodes) if layer else None
    G = rng.normal(size=v.shape).astype(np.float32)
    jlp = jp["rgcn"]["layers"][layer]

    def jax_fn(lp, v, r, pv):
        out = JL.union_layer_tangent(lp, v, r, jsnap, C, prev_v=pv, impl=impl)
        return jnp.sum(out * G), out

    args = (jlp, jnp.asarray(v), jnp.asarray(rel), None if prev is None else jnp.asarray(prev))
    with pltpu.force_tpu_interpret_mode() if impl == "pallas" else contextlib.nullcontext():
        want_grads, want = jax.grad(jax_fn, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    lp = {k: p.clone().requires_grad_(True) for k, p in cp["rgcn"]["layers"][layer].items()}
    leaves = [t(v).requires_grad_(True), t(rel).requires_grad_(True)]
    if prev is not None:
        leaves.append(t(prev).requires_grad_(True))

    def port(abs_diff=PL._abs_diff):
        saved, PL._abs_diff = PL._abs_diff, abs_diff
        try:
            out = PL.union_layer_tangent(lp, leaves[0], leaves[1], snap, C,
                                         prev_v=leaves[2] if prev is not None else None)
        finally:
            PL._abs_diff = saved
        return out, torch.autograd.grad(torch.sum(out * t(G)), leaves + list(lp.values()))

    got, grads = port()
    close(got, want)
    names = ["v", "rel_emb", "prev_v"][:len(leaves)] + list(lp)
    wants = [want_grads[1], want_grads[2], want_grads[3]][:len(leaves)] + [
        want_grads[0][k] for k in lp]
    for name, g, w in zip(names, grads, wants):
        close_grad(g, w, msg=name)
    if case == "tie":
        radius = PH.radius_from_tangent(leaves[0].detach(), C)
        ties = (radius[snap.src] == radius[snap.dst]) & (snap.edge_mask > 0)
        assert bool(ties[snap.src != snap.dst].any()) and bool(ties[snap.src == snap.dst].any())
        # torch's own abs, whose derivative at 0 is 0, gives another dv
        _, torch_abs = port(lambda a, b: (a - b).abs())
        assert not np.allclose(torch_abs[0].numpy(), np.asarray(wants[0]), rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(wants[0]).max()))


@pytest.mark.parametrize("skip", [False, True])
def test_uvrgcn_cell_tangent_matches_jax(data, rng, skip):
    """The two-layer stack with the norm clamp between layers: values and
    gradients by v, rel_emb and every weight of both layers."""
    _, _, (jp, _), (cp, _) = init(data, skip_connect=skip)
    v, rel, snap, jsnap = layer_inputs(data, rng, "sorted")
    G = rng.normal(size=v.shape).astype(np.float32)

    def jax_fn(p, v, r):
        out = JL.uvrgcn_cell_tangent(p, v, r, jsnap, C)
        return jnp.sum(out * G), out

    want_grads, want = jax.grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jp["rgcn"], jnp.asarray(v), jnp.asarray(rel))
    params = {"layers": [{k: p.clone().requires_grad_(True) for k, p in lp.items()}
                         for lp in cp["rgcn"]["layers"]]}
    leaves = [t(v).requires_grad_(True), t(rel).requires_grad_(True)]
    got = PL.uvrgcn_cell_tangent(params, *leaves, snap, C)
    close(got, want)
    grads = torch.autograd.grad(torch.sum(got * t(G)), leaves + tree_leaves(params))
    wants = dict(keyed(want_grads[0]), v=want_grads[1], rel_emb=want_grads[2])
    for name, g in zip(["v", "rel_emb"] + paths(params), grads):
        close_grad(g, wants[name], msg=name)


def test_init_matches_jax_structure(data):
    """The uvrgcn layers' and ConvTrans decoders' keys and shapes, and the
    BN trees of the model state."""
    _, pcfg, (jp, js), _ = init(data, skip_connect=True)
    got, state = PM.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert {k: v.shape for k, v in keyed(jax.tree.map(np.asarray, jp)).items()} == {
        p: tuple(x.shape) for p, x in zip(paths(got), tree_leaves(got))}
    for bn in ("bn_ob", "bn_rel"):
        assert {k: v.shape for k, v in keyed(getattr(js, bn)).items()} == {
            p: tuple(x.shape) for p, x in zip(paths(getattr(state, bn)),
                                              tree_leaves(getattr(state, bn)))}


def test_ball_space_uvrgcn_raises(data):
    """The uvrgcn's ball-space layer stack (``encoder_cell``, which
    ``evolve(tangent_fast=False)`` runs), refused until it was ported, now
    runs and matches JAX's on ball points."""
    _, _, (jp, _), (cp, _) = init(data, skip_connect=True)
    snap, jx = history(data, length=1)
    rng = np.random.default_rng(8)
    h = np.asarray(JH.exp_map_zero(jnp.asarray(rng.normal(size=(data.num_nodes, D))
                                               .astype(np.float32)), C))
    got = PL.encoder_cell(cp["rgcn"], "hyperbolic_uvrgcn", torch.from_numpy(h), cp["emb_rel"],
                          snap.step(0), C)
    want = JL.encoder_cell(jp["rgcn"], "hyperbolic_uvrgcn", jnp.asarray(h), jp["emb_rel"],
                           jax.tree.map(lambda a: a[0], jx), C)
    close(got, want)


# ------------------------------------------------------------ (c) evolve

@pytest.mark.parametrize("empty_first", [False, True])
def test_evolve_matches_jax(data, empty_first):
    """JAX's evolve picks its tangent-carry scan for this encoder
    (tangent_fast=None); an empty first snapshot is an identity step."""
    jcfg, pcfg, (jp, _), (cp, _) = init(data)
    pt_hist, jx_hist = history(data, empty_first=empty_first)
    h, r = PM.evolve(cp, pcfg, pt_hist)
    jh, jr, _, _ = JM.evolve(jp, jcfg, jx_hist)
    close(h, jh)
    close(r, jr)
    if empty_first:  # equal to the window without the empty step
        short, _ = history(data, start=3, length=2)
        h2, r2 = PM.evolve(cp, pcfg, short)
        close(h, h2, rtol=0, atol=0)
        close(r, r2, rtol=0, atol=0)


# ---------------------------------------------------------- (d) decoders

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which", ["convtranse", "convtransr"])
def test_convtrans_decoders_match_jax(data, rng, which, train):
    """A half-padded bucket, running statistics away from their init: the
    scores, the new BN statistics (train mode) and the gradients by the
    decoder's parameters, the ball points and the relation embeddings;
    the tangent table is derived from the ball points (ent_tan=None)."""
    _, _, (jp, js), (cp, cs) = init(data)
    dec, bn = ("decoder_ob", "bn_ob") if which == "convtranse" else ("decoder_rel", "bn_rel")
    bn_np = jax.tree.map(np.array, getattr(js, bn))
    for st in bn_np.values():
        st["mean"] = rng.normal(size=st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    real = pt_snapshots.split_by_time(data.train)[3]
    triples, mask = pt_snapshots.pad_triples(real, data.num_rels, 4 * len(real))
    assert mask.sum() * 2 == len(mask)
    emb = np.asarray(JH.exp_map_zero(jnp.asarray(tangent(rng, data.num_nodes)), C))
    rel = rng.normal(size=(2 * data.num_rels, D)).astype(np.float32)
    n_cand = data.num_nodes if which == "convtranse" else 2 * data.num_rels
    G = (rng.normal(size=(len(triples), n_cand)) * mask[:, None]).astype(np.float32)
    jfn = getattr(JD, f"hyperbolic_{which}_score")

    def jax_fn(p, e, r):
        scores, new = jfn(p, bn_np, e, r, jnp.asarray(triples), C, jnp.asarray(mask), train=train)
        return jnp.sum(scores * G), (scores, new)

    want_grads, (want_scores, want_bn) = jax.grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        jp[dec], jnp.asarray(emb), jnp.asarray(rel))
    params = tree_map(lambda p: p.clone().requires_grad_(True), cp[dec])
    leaves = [t(emb).requires_grad_(True), t(rel).requires_grad_(True)]
    scores, new_bn = getattr(PD, f"hyperbolic_{which}_score")(
        params, jax.tree.map(t, bn_np), *leaves, t(triples).long(), C, t(mask), train=train)
    close(scores, want_scores)
    for path, got in zip(paths(new_bn), tree_leaves(new_bn)):
        assert not got.requires_grad, path
        close(got, keyed(want_bn)[path], msg=path)
    grads = torch.autograd.grad(torch.sum(scores * t(G)), tree_leaves(params) + leaves)
    largest = max(g.abs().max().item() for g in grads)
    wants = dict(keyed(want_grads[0]), entity_embedding=want_grads[1],
                 rel_embedding=want_grads[2])
    for name, g in zip(paths(params) + ["entity_embedding", "rel_embedding"], grads):
        w = wants[name]
        if train and f"['{dec}']{name}" in SHIFT_INVARIANT:
            assert g.abs().max().item() <= 1e-6 * largest, name
        else:
            close_grad(g, w, msg=name)


# ---------------------------------------------------------- (e) get_loss

@pytest.mark.parametrize("learn_curvature", [False, True])
def test_get_loss_matches_jax(data, learn_curvature):
    """The four losses, every parameter's gradient and the new BN running
    statistics of one training window of 3 snapshots."""
    jcfg, pcfg, (jp, js), (cp, cs) = init(data, learn_curvature=learn_curvature)
    pt_hist, jx_hist = history(data)
    triples, mask = pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[5],
                                             data.num_rels, 64)
    tw = 0.7

    def jax_fn(p):
        _, losses, new_state, _ = JM.get_loss(p, js, jcfg, jx_hist, jnp.asarray(triples),
                                              jnp.asarray(mask), train=True)
        total = (tw * losses["entity"] + (1 - tw) * losses["relation"] + losses["static"]
                 + losses["radius"])
        return total, (losses, new_state)

    want_grads, (want_losses, want_state) = jax.jit(jax.grad(jax_fn, has_aux=True))(jp)
    for p in tree_leaves(cp):
        p.requires_grad_(True)
    loss_ent, losses, new_state, _ = PM.get_loss(cp, cs, pcfg, pt_hist, t(triples).long(),
                                                 t(mask), train=True)
    assert loss_ent is losses["entity"]
    for k in ("entity", "relation", "static", "radius"):
        close(losses[k], want_losses[k], msg=k)
    total = (tw * losses["entity"] + (1 - tw) * losses["relation"] + losses["static"]
             + losses["radius"])
    grads = torch.autograd.grad(total, tree_leaves(cp), allow_unused=True)
    want = keyed(want_grads)
    assert set(paths(cp)) == set(want)
    largest = max(g.abs().max().item() for g in grads if g is not None)
    for path, g in zip(paths(cp), grads):
        assert g is not None, path
        if path in SHIFT_INVARIANT:
            assert g.abs().max().item() <= 1e-6 * largest, path
        else:
            close_grad(g, want[path], msg=path)
    for bn in ("bn_ob", "bn_rel"):
        got_bn = getattr(new_state, bn)
        want_bn = keyed(getattr(want_state, bn))
        for path, g, old in zip(paths(got_bn), tree_leaves(got_bn),
                                tree_leaves(getattr(cs, bn))):
            close(g, want_bn[path], msg=f"{bn}{path}")
            assert not torch.equal(g, old), f"{bn}{path} was not updated"
    close(new_state.radius_target, js.radius_target, rtol=0, atol=0)


# ----------------------------------------------------------- (f) predict

def test_predict_matches_jax(data):
    jcfg, pcfg, (jp, js), (cp, cs) = init(data)
    pt_hist, jx_hist = history(data)
    triples, mask = pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[5],
                                             data.num_rels, 64)
    s_ob, s_rel = PM.predict(cp, cs, pcfg, pt_hist, t(triples).long(), t(mask))
    j_ob, j_rel = JM.predict(jp, js, jcfg, jx_hist, jnp.asarray(triples), jnp.asarray(mask))
    assert s_ob.shape == (len(triples), data.num_nodes)
    assert s_rel.shape == (len(triples), 2 * data.num_rels)
    close(s_ob, j_ob)
    close(s_rel, j_rel)
