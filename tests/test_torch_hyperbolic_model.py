"""The port's hyperbolic model (LGCN + RotH) against regcn_tpu.hyperbolic.

JAX's init_params(PRNGKey(0)) goes through hyperbolic_params_from_jax, so
both packages see the same parameters and the same snapshot arrays, with
dropout at 0. Tolerance: fp32 on both sides with sums and transcendentals
in another order, rtol 1e-4 / atol 1e-5; gradients additionally within
atol 1e-5 * max(1, max|JAX gradient|) of each parameter, because a
gradient entry sums many terms that cancel.
"""

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
from regcn_tpu.hyperbolic.train import compute_radius_targets as jax_radius_targets
from regcn_torch.convert import hyperbolic_params_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import decoders as PD
from regcn_torch.hyperbolic import layers as PL
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic.train import compute_radius_targets, tree_leaves

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
RTOL, ATOL = 1e-4, 1e-5
HLEN = 2


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=123, **TINY)


def configs(data, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=8, n_layers=2,
                encoder="lgcn", decoder="roth", n_bases=4, dropout=0.0, input_dropout=0.0,
                hidden_dropout=0.0, feat_dropout=0.0)
    base.update(kw)
    return JM.HyperbolicConfig(**base), PM.HyperbolicConfig(**base)


def radius_target(data):
    return compute_radius_targets(pt_snapshots.split_by_time(data.train), data.num_nodes)


def init(data, seed=0, **kw):
    """(jax config, torch config, jax params+state as numpy, torch params+state)."""
    jcfg, pcfg = configs(data, **kw)
    params, state = JM.init_params(jax.random.PRNGKey(seed), jcfg, radius_target(data))
    params, state = jax.tree.map(np.asarray, (params, state))
    converted = hyperbolic_params_from_jax(params, state, device="cpu")
    return jcfg, pcfg, jax.tree.map(jnp.asarray, (params, state)), converted


def history(data, start=2, empty_first=False, length=HLEN):
    window = pt_snapshots.split_by_time(data.train)[start:start + length]
    host = pt_snapshots.build_history(window, data.num_nodes, data.num_rels,
                                      edge_bucket=32, rc_bucket=64)
    if empty_first:  # an all-masked step, as JAX's fused paths front-pad
        host.edge_mask[0] = 0.0
        host.rc_mask[0] = 0.0
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


def triples_of(data, t=4, bucket=64):
    triples, mask = pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[t],
                                             data.num_rels, bucket)
    return triples, mask


def test_radius_targets_equal_jax(data):
    train = pt_snapshots.split_by_time(data.train)
    for kw in ({}, dict(alpha=0.2, beta=0.8, radius_min=0.1, radius_max=5.0)):
        np.testing.assert_array_equal(compute_radius_targets(train, data.num_nodes, **kw),
                                      jax_radius_targets(train, data.num_nodes, **kw))
    np.testing.assert_array_equal(compute_radius_targets([], 7), jax_radius_targets([], 7))


def test_init_params_matches_jax_structure(data):
    _, pcfg, (jp, js), (cp, cs) = init(data, learn_curvature=True, skip_connect=True)
    got, _ = PM.init_params(torch.Generator().manual_seed(0), pcfg, radius_target(data),
                            device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    want_shapes = {jax.tree_util.keystr(k): np.shape(v) for k, v in want}

    def shapes(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: s for k, v in tree.items() for k2, s in shapes(v, f"{prefix}['{k}']").items()}
        if isinstance(tree, list):
            return {k2: s for i, v in enumerate(tree) for k2, s in shapes(v, f"{prefix}[{i}]").items()}
        return {prefix: tuple(tree.shape)}

    assert shapes(got) == want_shapes
    assert shapes(cp) == want_shapes
    np.testing.assert_array_equal(cs.radius_target.numpy(), js.radius_target)
    np.testing.assert_array_equal(got["radius_static"].numpy(), js.radius_target)


@pytest.mark.parametrize("layer,skip,train", [(0, False, False), (1, True, False),
                                              (1, True, True)])
def test_lgcn_layer_matches_jax(data, rng, layer, skip, train):
    """``train=True`` with dropout 0: the rrelu stays the eval-mode one."""
    _, _, (jp, _), (cp, _) = init(data, skip_connect=skip)
    pt_hist, jx_hist = history(data)
    c = 0.01
    h = np.asarray(JM.H.exp_map_zero(jnp.asarray(rng.normal(size=(data.num_nodes, 8))
                                                 .astype(np.float32)), c))
    rel = rng.normal(size=(2 * data.num_rels, 8)).astype(np.float32)
    prev = h[::-1].copy() if skip else None
    want = JL.lgcn_layer(jp["rgcn"]["layers"][layer], jnp.asarray(h), jnp.asarray(rel),
                         jax.tree.map(lambda a: a[1], jx_hist), c, 4,
                         prev_h=None if prev is None else jnp.asarray(prev), train=train)
    got = PL.lgcn_layer(cp["rgcn"]["layers"][layer], torch.from_numpy(h), torch.from_numpy(rel),
                        pt_hist.step(1), c, 4,
                        prev_h=None if prev is None else torch.from_numpy(prev), train=train)
    close(got, want)


@pytest.mark.parametrize("empty_first", [False, True])
def test_evolve_matches_jax(data, empty_first):
    jcfg, pcfg, (jp, _), (cp, _) = init(data)
    pt_hist, jx_hist = history(data, empty_first=empty_first)
    h, r = PM.evolve(cp, pcfg, pt_hist)
    jh, jr, _, _ = JM.evolve(jp, jcfg, jx_hist)
    close(h, jh)
    close(r, jr)
    if empty_first:  # the empty step is the identity: equal to the 1-step window
        one, _ = history(data, start=3, length=1)
        h1, r1 = PM.evolve(cp, pcfg, one)
        close(h, h1, rtol=0, atol=0)
        close(r, r1, rtol=0, atol=0)


@pytest.mark.parametrize("rel_c", [False, True])
def test_roth_scores_and_losses_match_jax(data, rng, rel_c):
    """RotH (with entity bias and, for ``rel_c``, relation curvature on the
    true distance) and RotH-Rel: eval scores and training losses."""
    _, _, (jp, _), (cp, _) = init(data, use_entity_bias=True, use_rel_curvature=rel_c)
    c = 0.01
    emb = np.asarray(JM.H.exp_map_zero(jnp.asarray(rng.normal(size=(data.num_nodes, 8))
                                                   .astype(np.float32)), c))
    rel = rng.normal(size=(2 * data.num_rels, 8)).astype(np.float32)
    bias = rng.normal(size=data.num_nodes).astype(np.float32) * 0.1
    ob = dict(jp["decoder_ob"], entity_bias=jnp.asarray(bias))
    cp["decoder_ob"]["entity_bias"] = torch.from_numpy(bias)
    triples, mask = triples_of(data)
    j, t = (jnp.asarray(emb), jnp.asarray(rel), jnp.asarray(triples)), \
        (torch.from_numpy(emb), torch.from_numpy(rel), torch.from_numpy(triples).long())
    # at init each RotH query sits next to its subject's embedding; there the
    # true distance takes the sqrt of a diff_sq of ~1e-5 expanded from terms
    # of ~10 (one GEMM), whose fp32 rounding differs between XLA and torch:
    # those scores agree to ~1e-3 absolute, the rest to rtol 1e-4
    close(PD.roth_score(cp["decoder_ob"], *t, c, rel_curvature_max=0.008),
          JD.roth_score(ob, *j, c, rel_curvature_max=0.008), atol=2e-3 if rel_c else ATOL)
    close(PD.roth_rel_score(cp["decoder_rel"], *t, c), JD.roth_rel_score(jp["decoder_rel"], *j, c))
    close(PD.roth_loss(cp["decoder_ob"], *t, c, mask=torch.from_numpy(mask)),
          JD.roth_loss(ob, *j, c, mask=jnp.asarray(mask)))
    close(PD.roth_rel_loss(cp["decoder_rel"], *t, c, mask=torch.from_numpy(mask)),
          JD.roth_rel_loss(jp["decoder_rel"], *j, c, mask=jnp.asarray(mask)))


def jax_loss_and_grads(jcfg, jp, js, jx_hist, triples, mask, cmax):
    def total(p):
        _, losses, _, _ = JM.get_loss(p, js, jcfg, jx_hist, jnp.asarray(triples),
                                      jnp.asarray(mask), train=True, curvature_max=cmax)
        return (0.7 * losses["entity"] + 0.3 * losses["relation"] + losses["static"]
                + losses["radius"]), losses

    params = jax.tree.map(jnp.asarray, jp)
    grads, losses = jax.jit(jax.grad(total, has_aux=True))(params)
    return jax.tree.map(np.asarray, losses), grads


@pytest.mark.parametrize("learn_curvature", [False, True])
def test_get_loss_and_every_gradient_match_jax(data, learn_curvature):
    jcfg, pcfg, (jp, js), (cp, cs) = init(data, learn_curvature=learn_curvature)
    pt_hist, jx_hist = history(data)
    triples, mask = triples_of(data)
    cmax = 0.028  # the curvature bound of the warmup's first epoch
    want_losses, want_grads = jax_loss_and_grads(jcfg, jp, js, jx_hist, triples, mask, cmax)
    leaves = tree_leaves(cp)
    for p in leaves:
        p.requires_grad_(True)
    _, losses, _, _ = PM.get_loss(cp, cs, pcfg, pt_hist, torch.from_numpy(triples).long(),
                               torch.from_numpy(mask), train=True, curvature_max=cmax)
    for k in ("entity", "relation", "static", "radius"):
        close(losses[k], want_losses[k], msg=k)
    assert float(losses["entity"]) > 0 and float(losses["relation"]) > 0
    total = 0.7 * losses["entity"] + 0.3 * losses["relation"] + losses["static"] + losses["radius"]
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    want = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in want}
    got = dict(zip(_paths(cp), grads))
    assert set(got) == set(want)
    for path, g in got.items():
        w = want[path]
        g = np.zeros_like(w) if g is None else g.numpy()
        close(g, w, atol=ATOL * max(1.0, np.abs(w).max()), msg=path)
    if learn_curvature:
        assert np.abs(want["['log_c']"]) > 0


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}[{i}]")]
    return [prefix]


def test_static_radius_detaches_the_curvature(data):
    """The static radius is bounded below the ball of a detached c: no
    gradient reaches log_c through it, in JAX or here."""
    jcfg, pcfg, (jp, _), (cp, _) = init(data, learn_curvature=True)
    jp = dict(jp, radius_static=jnp.full_like(jp["radius_static"], 50.0))  # past 1/sqrt(c)
    jg = jax.grad(lambda lc: jnp.sum(JM._static_radius(
        dict(jp, log_c=lc), jcfg, JM.get_curvature(dict(jp, log_c=lc), jcfg))))(
        jnp.asarray(jp["log_c"]))
    log_c = cp["log_c"].clone().requires_grad_(True)
    radius = torch.full_like(cp["radius_static"], 50.0).requires_grad_(True)
    params = dict(cp, log_c=log_c, radius_static=radius)
    r = PM._static_radius(params, pcfg, PM.get_curvature(params, pcfg))
    (g,) = torch.autograd.grad(r.sum(), [log_c], allow_unused=True)
    assert float(jg) == 0.0 and (g is None or float(g) == 0.0)
    close(r, JM._static_radius(jp, jcfg, JM.get_curvature(jp, jcfg)))


def test_predict_matches_jax(data):
    jcfg, pcfg, (jp, js), (cp, cs) = init(data, learn_curvature=True)
    pt_hist, jx_hist = history(data)
    triples, mask = triples_of(data, t=5)
    s_ob, s_rel = PM.predict(cp, cs, pcfg, pt_hist, torch.from_numpy(triples).long(),
                             torch.from_numpy(mask))
    j_ob, j_rel = JM.predict(jp, js, jcfg, jx_hist, jnp.asarray(triples), jnp.asarray(mask))
    assert s_ob.shape == (len(triples), data.num_nodes)
    assert s_rel.shape == (len(triples), 2 * data.num_rels)
    close(s_ob, j_ob)
    close(s_rel, j_rel)


@pytest.mark.parametrize("unported", [
    dict(use_static=True), dict(manifold_entities=True),
    dict(compute_dtype="bfloat16"), dict(encoder="fhnn"), dict(encoder="hgat")])
def test_unported_configs_raise(data, unported):
    """The static graph, entities on the ball (``manifold_entities``), the
    fhnn and hgat encoders and bf16 compute, refused until they were
    ported, now run: the parameters have JAX's keys and shapes (on the ball
    for ``manifold_entities``), and ``evolve`` matches JAX's; under bf16
    the parameters stay fp32, and a dtype JAX does not offer raises."""
    if "compute_dtype" in unported:
        _, pcfg = configs(data, **unported)
        got, _ = PM.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
        assert all(t.dtype == torch.float32 for t in tree_leaves(got))
        with pytest.raises(ValueError, match="compute dtype"):
            PM.init_params(torch.Generator().manual_seed(0),
                           dataclasses.replace(pcfg, compute_dtype="float16"), device="cpu")
        return
    if "use_static" in unported:
        unported = dict(unported, num_static_rels=2, num_words=10)
    jcfg, pcfg, (jp, _), (cp, _) = init(data, **unported)
    got, _ = PM.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(got)] == [
        tuple(np.shape(v)) for v in [keyed_leaf(jp, p) for p in paths(got)]]
    pt_hist, jx_hist = history(data)
    kw_pt, kw_jx = {}, {}
    if "use_static" in unported:
        rng = np.random.default_rng(3)
        ents = np.arange(data.num_nodes)
        st = np.stack([ents, rng.integers(0, 2, len(ents)),
                       rng.integers(0, 10, len(ents)) + data.num_nodes], axis=1)
        host = pt_snapshots.build_snapshot(st, data.num_nodes + 10, 2, edge_bucket=32)
        kw_pt["static_snap"] = host.to("cpu")
        kw_jx["static_snap"] = jax_snapshots.Snapshot(
            **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
            num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=True)
    else:
        radius = torch.linalg.vector_norm(got["dynamic_emb"], dim=-1)
        assert float(radius.max()) < 1.0 / 0.01 ** 0.5
    h, r = PM.evolve(cp, pcfg, pt_hist, **kw_pt)
    jh, jr, _, _ = JM.evolve(jp, jcfg, jx_hist, **kw_jx)
    close(h, jh)
    close(r, jr)


def paths(tree, prefix=()):
    """Key paths of a nested dict/list, in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, prefix + (i,))]
    return [prefix]


def keyed_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_config_defaults_equal_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JM.HyperbolicConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(PM.HyperbolicConfig)}
    assert jf == pf
