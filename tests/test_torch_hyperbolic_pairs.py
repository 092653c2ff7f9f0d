"""The port's hyperbolic model with each of its eight encoder x decoder
pairs, {lgcn, hyperbolic_uvrgcn} x {hyperbolic_convtranse, murp, roth,
atth}, against regcn_tpu.hyperbolic.model: ``init_params``' leaves,
``get_loss``'s four losses and the gradient of the trainer's total by
every parameter, and ``predict``.

JAX's ``init_params(PRNGKey(0))`` goes through
``hyperbolic_params_from_jax``, so both packages see the same parameters
and the same snapshot arrays, with dropout at 0. MuRP and AttH run with
config 4's options (learned curvature, a curvature per relation, an
entity bias), so their entity loss takes the true distance under a
per-query curvature; the entity bias and the relation curvature are
drawn at random so that the curvature's clamp binds for some relations
only. RotH runs with config 3's proxy distance, a learned curvature and
an entity bias: at init its query sits next to its subject, where the
true distance takes the sqrt of a diff_sq of ~1e-5 built from terms of
~10 in one GEMM, whose fp32 rounding differs between XLA and torch (its
true distance with other weights: tests/test_torch_hyperbolic_distance_decoders.py).

Tolerances: fp32 on both sides with sums and transcendentals in another
order, rtol 1e-4 / atol 1e-5; gradients within atol 1e-5 * max(1,
max|JAX gradient|) of each parameter, because a gradient entry sums many
terms that cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.hyperbolic import model as JM
from regcn_torch.convert import hyperbolic_params_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic.train import compute_radius_targets
from regcn_torch.train.optim import tree_leaves

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
RTOL, ATOL = 1e-4, 1e-5
D = 8
PAIRS = [(e, d) for e in ("lgcn", "hyperbolic_uvrgcn") for d in PM.DECODERS]
# config 4's options; RotH keeps config 3's proxy distance (see above)
CONFIG4 = dict(learn_curvature=True, use_rel_curvature=True, use_entity_bias=True)
OPTIONS = {"hyperbolic_convtranse": {}, "murp": CONFIG4, "atth": CONFIG4,
           "roth": dict(learn_curvature=True, use_entity_bias=True)}


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


def triples_of(data, t=4, bucket=64):
    return pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[t], data.num_rels,
                                    bucket)


def configs(data, encoder, decoder, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=2,
                encoder=encoder, decoder=decoder, n_bases=4, dropout=0.0, input_dropout=0.0,
                hidden_dropout=0.0, feat_dropout=0.0)
    base.update(OPTIONS[decoder])
    base.update(kw)
    return JM.HyperbolicConfig(**base), PM.HyperbolicConfig(**base)


def radius_target(data):
    return compute_radius_targets(pt_snapshots.split_by_time(data.train), data.num_nodes)


def init(data, encoder, decoder, seed=0):
    jcfg, pcfg = configs(data, encoder, decoder)
    params, state = JM.init_params(jax.random.PRNGKey(seed), jcfg, radius_target(data))
    params, state = jax.tree.map(np.asarray, (params, state))
    if decoder != "hyperbolic_convtranse":  # a trained-looking bias and curvature
        rng = np.random.default_rng(seed)
        ob = dict(params["decoder_ob"])
        ob["entity_bias"] = (rng.normal(size=ob["entity_bias"].shape) * 0.1).astype(np.float32)
        if "rel_curvature_raw" in ob:
            ob["rel_curvature_raw"] = (ob["rel_curvature_raw"]
                                       + rng.normal(size=ob["rel_curvature_raw"].shape) * 0.4
                                       ).astype(np.float32)
        params = dict(params, decoder_ob=ob)
    converted = hyperbolic_params_from_jax(params, state, device="cpu")
    return jcfg, pcfg, jax.tree.map(jnp.asarray, (params, state)), converted


def history(data, start=2, length=2):
    window = pt_snapshots.split_by_time(data.train)[start:start + length]
    host = pt_snapshots.build_history(window, data.num_nodes, data.num_rels,
                                      edge_bucket=32, rc_bucket=64)
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


def shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: s for k, v in tree.items() for k2, s in shapes(v, f"{prefix}['{k}']").items()}
    if isinstance(tree, list):
        return {k2: s for i, v in enumerate(tree) for k2, s in shapes(v, f"{prefix}[{i}]").items()}
    return {prefix: tuple(np.shape(tree))}


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}[{i}]")]
    return [prefix]


@pytest.mark.parametrize("decoder", ["atth", "murp"])
def test_init_params_leaves_equal_jax(data, decoder):
    """Leaf names and shapes of ``init_params`` equal JAX's, with config 4's
    options and without them."""
    for extras in (True, False):
        kw = {} if extras else dict(learn_curvature=False, use_rel_curvature=False,
                                    use_entity_bias=False)
        jcfg, pcfg = configs(data, "hyperbolic_uvrgcn", decoder, **kw)
        want, _ = JM.init_params(jax.random.PRNGKey(0), jcfg, radius_target(data))
        got, _ = PM.init_params(torch.Generator().manual_seed(0), pcfg, radius_target(data),
                                device="cpu")
        assert shapes(got) == shapes(want)
        assert ("['decoder_ob']['rel_curvature_raw']" in shapes(got)) == extras


def test_every_pair_is_ported():
    """This file's eight pairs, and the fhnn and hgat encoders' eight
    (tests/test_torch_hyperbolic_encoders.py), are all of them."""
    assert set(PAIRS) <= set(PM.PORTED)
    assert sorted(PM.PORTED) == sorted((e, d) for e in PM.ENCODERS for d in PM.DECODERS)


@pytest.mark.parametrize("encoder,decoder", PAIRS)
def test_pair_get_loss_and_every_gradient_match_jax(data, encoder, decoder):
    """``get_loss``'s four losses and the gradient of the trainer's total by
    every parameter, in training mode with dropout 0, against JAX; the
    distance decoders with config 4's options and a warmup bound on the
    curvature."""
    jcfg, pcfg, (jp, js), (cp, cs) = init(data, encoder, decoder)
    pt_hist, jx_hist = history(data)
    triples, mask = triples_of(data)
    cmax = 0.028

    def total(p):
        _, losses, _, _ = JM.get_loss(p, js, jcfg, jx_hist, jnp.asarray(triples),
                                      jnp.asarray(mask), train=True, curvature_max=cmax)
        return (0.7 * losses["entity"] + 0.3 * losses["relation"] + losses["static"]
                + losses["radius"]), losses

    want_g, want = jax.jit(jax.grad(total, has_aux=True))(jp)
    leaves = tree_leaves(cp)
    for p in leaves:
        p.requires_grad_(True)
    _, losses, _, _ = PM.get_loss(cp, cs, pcfg, pt_hist, torch.from_numpy(triples).long(),
                               torch.from_numpy(mask), train=True, curvature_max=cmax)
    for k in ("entity", "relation", "static", "radius"):
        close(losses[k], want[k], msg=k)
    got_total = (0.7 * losses["entity"] + 0.3 * losses["relation"] + losses["static"]
                 + losses["radius"])
    grads = torch.autograd.grad(got_total, leaves, allow_unused=True)
    want_g = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_flatten_with_path(want_g)[0]}
    got_g = dict(zip(paths(cp), grads))
    assert set(got_g) == set(want_g)
    for path, g in got_g.items():
        w = want_g[path]
        close(np.zeros_like(w) if g is None else g.numpy(), w,
              atol=ATOL * max(1.0, np.abs(w).max()), msg=path)
    if decoder != "hyperbolic_convtranse":
        for leaf in ("['log_c']", "['decoder_ob']['rel_curvature_raw']",
                     "['decoder_ob']['entity_bias']"):
            assert (leaf not in want_g) == (leaf not in got_g)
            assert leaf not in want_g or np.abs(want_g[leaf]).max() > 0, leaf


@pytest.mark.parametrize("encoder,decoder", PAIRS)
def test_pair_predict_matches_jax(data, encoder, decoder):
    jcfg, pcfg, (jp, js), (cp, cs) = init(data, encoder, decoder)
    pt_hist, jx_hist = history(data)
    triples, mask = triples_of(data, t=5)
    s_ob, s_rel = PM.predict(cp, cs, pcfg, pt_hist, torch.from_numpy(triples).long(),
                             torch.from_numpy(mask))
    j_ob, j_rel = JM.predict(jp, js, jcfg, jx_hist, jnp.asarray(triples), jnp.asarray(mask))
    assert s_ob.shape == (len(triples), data.num_nodes)
    assert s_rel.shape == (len(triples), 2 * data.num_rels)
    close(s_ob, j_ob)
    close(s_rel, j_rel)
