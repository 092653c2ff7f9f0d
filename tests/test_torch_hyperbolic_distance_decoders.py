"""The port's MuRP / MuRP-Rel, RotH / RotH-Rel, AttH / AttH-Rel, DistMult
and ComplEx against regcn_tpu.hyperbolic.decoders (the model with each of
its encoder x decoder pairs: tests/test_torch_hyperbolic_pairs.py).

Each case feeds the same seeded numpy inputs and the same weights to both
packages: JAX's ``init_*`` parameters, with every weight redrawn at a
scale that makes the query depend on it (the init scale 1e-3 would leave
each query a near copy of its subject or of the translation), the entity
bias and the per-relation curvature random, so that the curvature clamp
binds for some relations and not for others. The decoders' losses are
also held against JAX's Pallas kernel B2 (``streaming_dist_ce_loss``) in
interpret mode, as tests/test_pallas_scoring.py runs it. Dropout is 0 in
every comparison with JAX (the two packages' generators differ).

Tolerances: fp32 on both sides with sums and transcendentals in another
order, rtol 1e-4 / atol 1e-5; gradients within atol 1e-5 * max(1,
max|JAX gradient|) of each input or parameter, because a gradient entry
sums many terms that cancel. No case needs more, the true distance
included: with these weights no query sits within rounding of a
candidate (see tests/test_torch_hyperbolic_pairs.py for RotH at init).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from regcn_tpu.hyperbolic import decoders as JD
from regcn_tpu.hyperbolic import model as JM
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import decoders as PD

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
RTOL, ATOL = 1e-4, 1e-5
C, D = 0.01, 8
ENTITY = {"murp": (JD.init_murp, JD._murp_query, JD.murp_score, JD.murp_loss,
                   PD.murp_score, PD.murp_loss),
          "roth": (JD.init_roth, JD._roth_query, JD.roth_score, JD.roth_loss,
                   PD.roth_score, PD.roth_loss),
          "atth": (JD.init_atth, JD._atth_query, JD.atth_score, JD.atth_loss,
                   PD.atth_score, PD.atth_loss)}
RELATION = {"murp_rel": (JD.init_murp_rel, JD._murp_rel_query,
                         JD.murp_rel_score, JD.murp_rel_loss, PD.murp_rel_score,
                         PD.murp_rel_loss),
            "roth_rel": (JD.init_roth_rel, JD._roth_rel_query, JD.roth_rel_score,
                         JD.roth_rel_loss, PD.roth_rel_score, PD.roth_rel_loss),
            "atth_rel": (JD.init_atth_rel, JD._atth_rel_query, JD.atth_rel_score,
                         JD.atth_rel_loss, PD.atth_rel_score, PD.atth_rel_loss)}
SCALAR = ("score_scale_raw", "score_margin")


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


def grad_close(got, want, msg=""):
    want = np.asarray(want)
    close(got, want, atol=ATOL * max(1.0, np.abs(want).max()), msg=msg)


def randomised(params, rng):
    """JAX's parameters (numpy) with every weight redrawn at scale 0.3,
    the entity bias at 0.1, the relation curvature around its init value
    (softplus 0.006-0.015 against a clamp at 0.999 c), scale and margin
    off their init values."""
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if k == "rel_curvature_raw":
            out[k] = (v + rng.normal(size=v.shape) * 0.4).astype(np.float32)
        elif k in SCALAR:
            out[k] = np.float32(v + rng.uniform(-0.3, 0.3))
        else:
            scale = 0.1 if "bias" in k else 0.3
            out[k] = (rng.normal(size=v.shape) * scale).astype(np.float32)
    return out


def tables(rng, n_ents, n_rels_total):
    emb = np.asarray(JM.H.exp_map_zero(
        jnp.asarray(rng.normal(size=(n_ents, D)).astype(np.float32)), C))
    rel = (rng.normal(size=(n_rels_total, D)) * 0.5).astype(np.float32)
    return emb, rel


def triples_of(data, t=4, bucket=64):
    return pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[t], data.num_rels,
                                    bucket)


def both(arrays):
    """(jax arrays, torch tensors) of a tuple of numpy arrays."""
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(np.asarray(a)) for a in arrays))


def jax_streaming_loss(query, candidates, target, mask, **kw):
    with pltpu.force_tpu_interpret_mode():
        return JD.dist_ce_loss(query, candidates, target, C, mask=mask, streaming=True, **kw)


def test_givens_reflection_matches_jax(rng):
    x = rng.normal(size=(6, D)).astype(np.float32)
    for angles in (rng.normal(size=(6, D // 2)), rng.normal(size=D // 2)):
        angles = angles.astype(np.float32)
        got = PD.givens_reflection(torch.from_numpy(x), torch.from_numpy(angles))
        close(got, JD.givens_reflection(jnp.asarray(x), jnp.asarray(angles)))
    # a reflection is its own inverse, and keeps each pair's norm
    twice = PD.givens_reflection(got, torch.from_numpy(angles))
    close(twice, x, atol=1e-6)


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "entity_bias"])
@pytest.mark.parametrize("rel_c", [False, True], ids=["proxy", "rel_curvature"])
@pytest.mark.parametrize("decoder", sorted(ENTITY))
def test_entity_decoder_matches_jax(data, decoder, rel_c, bias):
    """Eval scores, the training loss (also against interpret-mode Pallas
    B2) and its gradients by every parameter and both embedding tables."""
    init, jquery, jscore, jloss, pscore, ploss = ENTITY[decoder]
    rng = np.random.default_rng(sorted(ENTITY).index(decoder) * 4 + 2 * rel_c + bias)
    n, r2 = data.num_nodes, 2 * data.num_rels
    jp = randomised(init(jax.random.PRNGKey(0), n, r2, D, C, use_entity_bias=bias,
                         use_rel_curvature=rel_c), rng)
    assert ("entity_bias" in jp) == bias and ("rel_curvature_raw" in jp) == rel_c
    emb, rel = tables(rng, n, r2)
    triples, mask = triples_of(data)
    (j_emb, j_rel, j_tri, j_mask), (t_emb, t_rel, t_tri, t_mask) = both((emb, rel, triples, mask))
    t_tri = t_tri.long()
    cmax = 0.008  # below 0.999 c: the warmup bound of the entity loss binds for some relations
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    tparams = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in jp.items()}

    close(pscore(tparams, t_emb, t_rel, t_tri, C), jscore(jparams, j_emb, j_rel, j_tri, C),
          msg="eval scores")

    def jax_total(p, e, r):
        return jloss(p, e, r, j_tri, C, mask=j_mask, rel_curvature_max=cmax)

    want, want_g = jax.value_and_grad(jax_total, argnums=(0, 1, 2))(jparams, j_emb, j_rel)
    e, r = t_emb.clone().requires_grad_(True), t_rel.clone().requires_grad_(True)
    got = ploss(tparams, e, r, t_tri, C, mask=t_mask, rel_curvature_max=cmax)
    close(got, want, msg="loss")
    assert float(got) > 0
    grads = torch.autograd.grad(got, list(tparams.values()) + [e, r])
    for name, g in zip(list(tparams) + ["entity_embedding", "rel_embedding"], grads):
        w = want_g[0][name] if name in tparams else want_g[1 if name == "entity_embedding" else 2]
        grad_close(g, w, msg=name)
    if rel_c:  # the curvature clamp binds for some relations, not for all
        assert 0 < np.count_nonzero(np.asarray(want_g[0]["rel_curvature_raw"])) < r2
    if bias:
        assert np.abs(np.asarray(want_g[0]["entity_bias"])).max() > 0

    query = jquery(jparams, j_emb, j_rel, j_tri, C, 0.0, None, False)
    args = dict(candidate_bias=jparams.get("entity_bias"), score_scale=JD._score_scale(jparams),
                score_margin=jparams["score_margin"],
                query_curvature=JD._relation_curvature(jparams, j_tri[:, 1], C, cmax),
                use_hyperbolic_distance=rel_c)
    close(got, jax_streaming_loss(query, j_emb, j_tri[:, 2], j_mask, **args),
          msg="loss against interpret-mode Pallas")


@pytest.mark.parametrize("decoder", sorted(RELATION))
def test_relation_decoder_matches_jax(data, decoder):
    """Eval scores, the loss (also against interpret-mode Pallas B2) and its
    gradients; MuRP-Rel has a bias over the relations and no scale or
    margin."""
    init, jquery, jscore, jloss, pscore, ploss = RELATION[decoder]
    rng = np.random.default_rng(10 + sorted(RELATION).index(decoder))
    n, r2 = data.num_nodes, 2 * data.num_rels
    jp = randomised(init(jax.random.PRNGKey(1), data.num_rels, D), rng)
    assert jp["rel_bias"].shape == (r2,)
    assert all(k in jp for k in SCALAR) == (decoder != "murp_rel")
    emb, rel = tables(rng, n, r2)
    triples, mask = triples_of(data)
    (j_emb, j_rel, j_tri, j_mask), (t_emb, t_rel, t_tri, t_mask) = both((emb, rel, triples, mask))
    t_tri = t_tri.long()
    jparams = {k: jnp.asarray(v) for k, v in jp.items()}
    tparams = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True) for k, v in jp.items()}

    close(pscore(tparams, t_emb, t_rel, t_tri, C), jscore(jparams, j_emb, j_rel, j_tri, C),
          msg="eval scores")
    want, want_g = jax.value_and_grad(
        lambda p, e, r: jloss(p, e, r, j_tri, C, mask=j_mask), argnums=(0, 1, 2))(
        jparams, j_emb, j_rel)
    e, r = t_emb.clone().requires_grad_(True), t_rel.clone().requires_grad_(True)
    got = ploss(tparams, e, r, t_tri, C, mask=t_mask)
    close(got, want, msg="loss")
    grads = torch.autograd.grad(got, list(tparams.values()) + [e, r])
    for name, g in zip(list(tparams) + ["entity_embedding", "rel_embedding"], grads):
        w = want_g[0][name] if name in tparams else want_g[1 if name == "entity_embedding" else 2]
        grad_close(g, w, msg=name)

    query = jquery(jparams, j_emb, j_tri, C, 0.0, None, False)
    args = dict(candidate_bias=jparams["rel_bias"])
    if "score_scale_raw" in jparams:
        args.update(score_scale=JD._score_scale(jparams), score_margin=jparams["score_margin"])
    close(got, jax_streaming_loss(query, JM.H.exp_map_zero(j_rel, C), j_tri[:, 1], j_mask,
                                  **args), msg="loss against interpret-mode Pallas")


@pytest.mark.parametrize("override", [False, True])
def test_murp_score_distance_override(data, override):
    """``murp_score(use_hyperbolic_distance=)`` picks the distance whatever
    the relation curvature says: the proxy with it, the true distance under
    the global c without it."""
    rng = np.random.default_rng(20 + override)
    n, r2 = data.num_nodes, 2 * data.num_rels
    jp = randomised(JD.init_murp(jax.random.PRNGKey(2), n, r2, D, C, use_entity_bias=True,
                                 use_rel_curvature=not override), rng)
    emb, rel = tables(rng, n, r2)
    triples, _ = triples_of(data)
    (j_emb, j_rel, j_tri), (t_emb, t_rel, t_tri) = both((emb, rel, triples))
    want = JD.murp_score({k: jnp.asarray(v) for k, v in jp.items()}, j_emb, j_rel, j_tri, C,
                         use_hyperbolic_distance=override)
    got = PD.murp_score({k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}, t_emb,
                        t_rel, t_tri.long(), C, use_hyperbolic_distance=override)
    close(got, want)
    default = PD.murp_score({k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}, t_emb,
                            t_rel, t_tri.long(), C)
    assert not torch.allclose(got, default)


def test_murp_rel_dropout_draws_subject_then_object(data):
    """MuRP-Rel's two dropout sites draw from the generator in JAX's order
    of sites: the subject's mask, then the object's."""
    rng = np.random.default_rng(30)
    n, r2 = data.num_nodes, 2 * data.num_rels
    params = {k: torch.from_numpy(np.asarray(v)) for k, v in randomised(
        JD.init_murp_rel(jax.random.PRNGKey(3), data.num_rels, D), rng).items()}
    emb, _ = tables(rng, n, r2)
    emb = torch.from_numpy(emb)
    tri = torch.from_numpy(triples_of(data)[0]).long()
    got = PD._murp_rel_query(params, emb, tri, C, 0.5, torch.Generator().manual_seed(5), True)
    gen = torch.Generator().manual_seed(5)
    s_tan = PD.H.log_map_zero(emb[tri[:, 0]], C)
    o_tan = PD.H.log_map_zero(emb[tri[:, 2]], C)
    keep_s = torch.rand(s_tan.shape, generator=gen) < 0.5
    keep_o = torch.rand(o_tan.shape, generator=gen) < 0.5
    want = PD.H.exp_map_zero((s_tan * keep_s * 2.0) @ params["w_s"]
                             + (o_tan * keep_o * 2.0) @ params["w_o"], C)
    close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["distmult", "complex"])
def test_tangent_scores_match_jax(data, name):
    rng = np.random.default_rng(40)
    emb, rel = tables(rng, data.num_nodes, 2 * data.num_rels)
    triples, _ = triples_of(data)
    (j_emb, j_rel, j_tri), (t_emb, t_rel, t_tri) = both((emb, rel, triples))
    want = getattr(JD, f"{name}_score")(j_emb, j_rel, j_tri, C)
    got = getattr(PD, f"{name}_score")(t_emb, t_rel, t_tri.long(), C)
    assert got.shape == (len(triples), data.num_nodes)
    close(got, want)
