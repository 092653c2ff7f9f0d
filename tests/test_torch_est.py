"""The port's EST (``regcn_torch/hyperbolic/est.py``) against
``regcn_tpu.hyperbolic.est``, function by function, at d = 16 and K = 8.

Parameters come from JAX's ``init_est_params(PRNGKey(0))`` and are
converted; every other input comes from a numpy default_rng seed or from
the synthetic generator both packages share. Tolerances: values within
rtol 1e-4 / atol 1e-5 (fp32 on both sides, sums and transcendentals in
another order; the QCHHE GRU projects its K inputs in one product where
JAX projects each step's); gradients within rtol 1e-4 and atol 1e-5 *
max(1, max|JAX gradient|) of each array. Host-side arrays (the temporal
index's queries, the true-tail dictionary, the TANS COO) must be equal.

The enrichment writes the heads' rows back with a scatter-set, and heads
repeat in a batch (a triple and the inverse of another share one). JAX
sends each written row's cotangent to the one update written, where
torch's ``index_put`` sends it to every duplicate: the enrichment cases
run batches with repeated heads and padded rows, and one case shows that
a plain ``index_put`` would miss JAX's gradients.

JAX's values and gradients come from one jitted program a case
(``jax.jit(jax.value_and_grad(...))``): run eagerly, each operation
compiles a program of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.hyperbolic import est as JE
from regcn_tpu.hyperbolic import gru as JG
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic import ops as JH
from regcn_torch.data.snapshots import pad_triples, split_by_time
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import est as PE
from regcn_torch.hyperbolic import gru as PG
from regcn_torch.hyperbolic import model as PM
from regcn_torch.train.optim import tree_leaves, tree_map

D, K, C = 16, 8, 0.01
RTOL, ATOL = 1e-4, 1e-5
ENCODERS = ("gru", "transformer")
TINY = dict(num_ents=30, num_rels=4, num_snaps=8, triples_per_snap=12, split=(6, 1, 1))


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


def close_trees(got, want, msg=""):
    """Two parameter trees (the port's tensors, JAX's arrays) leaf by leaf."""
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(want_leaves), msg
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        close_grad(g, w, msg=f"{msg} leaf {i}")


def t(a, grad=False):
    x = torch.from_numpy(np.array(a))
    return x.requires_grad_(True) if grad else x


def cfgs(encoder="gru", **kw):
    base = dict(num_ents=TINY["num_ents"], num_rels=TINY["num_rels"], h_dim=D, use_est=True,
                est_encoder=encoder, est_history_len=K, **kw)
    return JM.HyperbolicConfig(**base), PM.HyperbolicConfig(**base)


def est_params(encoder):
    """(JAX's est parameters, the port's: the same values, requiring grad)."""
    jcfg, _ = cfgs(encoder)
    jp = JE.init_est_params(jax.random.PRNGKey(0), jcfg)
    return jp, tree_map(lambda a: t(a, grad=True), jax.tree.map(np.asarray, jp))


def ball(rng, shape, scale=0.3):
    return np.asarray(JH.exp_map_zero(jnp.asarray(rng.normal(size=shape) * scale, jnp.float32),
                                      C))


def weights_like(rng, *shapes):
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


# ----------------------------------------------------------------- H-PES

@pytest.mark.parametrize("with_ids", [False, True], ids=["table", "gathered"])
def test_inject_slow_state(with_ids):
    rng = np.random.default_rng(1)
    ids = np.array([3, 0, 5, 5, 11], np.int64) if with_ids else None
    rows = 5 if with_ids else 12
    h = ball(rng, (rows, D))
    slow = rng.normal(size=(12, D)).astype(np.float32) * 3.0
    slow[0] = 12.0  # past the ±10 clamp
    w, = weights_like(rng, (rows, D))
    jp, pp = est_params("gru")

    def jfn(h):
        return jnp.sum(JE.inject_slow_state(jp, h, jnp.asarray(slow), C,
                                            None if ids is None else jnp.asarray(ids)) * w)

    want, want_g = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(h))
    th = t(h, grad=True)
    got = PE.inject_slow_state(pp, th, t(slow), C, None if ids is None else t(ids))
    close(got, JE.inject_slow_state(jp, jnp.asarray(h), jnp.asarray(slow), C,
                                    None if ids is None else jnp.asarray(ids)))
    g, = torch.autograd.grad(torch.sum(got * t(w)), th)
    close(torch.sum(got * t(w)), want)
    close_grad(g, want_g)


def test_update_states_with_repeated_and_padded_entities():
    """Entities repeat among the valid rows, padded rows repeat valid
    entities and must not count; the gate is read from the parameters."""
    rng = np.random.default_rng(2)
    n = 10
    fast = rng.normal(size=(n, D)).astype(np.float32)
    slow = (fast + rng.normal(size=(n, D)) * rng.uniform(0, 1, (n, 1))).astype(np.float32)
    ids = np.array([1, 4, 4, 7, 1, 1, 9, 2, 4, 0], np.int64)
    mask = np.array([1, 1, 1, 1, 1, 0, 1, 0, 0, 0], np.float32)
    ctx = rng.normal(size=(len(ids), D)).astype(np.float32)
    jp, pp = est_params("gru")
    jp = dict(jp, slow_threshold=jnp.float32(0.8), slow_scale=jnp.float32(3.0))
    pp = dict(pp, slow_threshold=torch.tensor(0.8, requires_grad=True),
              slow_scale=torch.tensor(3.0, requires_grad=True))
    want = JE.update_states(jp, JE.ESTState(fast=jnp.asarray(fast), slow=jnp.asarray(slow)),
                            jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(ctx), 0.2)
    got = PE.update_states(pp, PE.ESTState(fast=t(fast), slow=t(slow)), t(ids), t(mask), t(ctx),
                           0.2)
    close(got.fast, want.fast)
    close(got.slow, want.slow)
    untouched = [e for e in range(n) if e not in ids[mask > 0]]
    np.testing.assert_array_equal(got.fast.numpy()[untouched], fast[untouched])
    np.testing.assert_array_equal(got.slow.numpy()[untouched], slow[untouched])
    assert not got.fast.requires_grad and not got.slow.requires_grad


# ----------------------------------------------------------------- H-TDP

@pytest.mark.parametrize("ball_points", [False, True], ids=["tangent", "projection"])
def test_time_delta(ball_points):
    rng = np.random.default_rng(3)
    deltas = rng.integers(0, 40, size=(5, K)).astype(np.float32)
    w, = weights_like(rng, (5, K, D))
    jp, pp = est_params("gru")

    def jfn(p):
        out = (JE.time_delta_projection(p, jnp.asarray(deltas), C) if ball_points
               else JE.time_delta_tangent(p, jnp.asarray(deltas)))
        return jnp.sum(out * w), out

    (want, want_out), want_g = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jp)
    out = (PE.time_delta_projection(pp, t(deltas), C) if ball_points
           else PE.time_delta_tangent(pp, t(deltas)))
    close(out, want_out)
    g = torch.autograd.grad(torch.sum(out * t(w)), tree_leaves(pp), allow_unused=True)
    for name, gp, leaf in zip(jax.tree_util.tree_flatten_with_path(want_g)[0],
                              g, tree_leaves(pp)):
        close_grad(torch.zeros_like(leaf) if gp is None else gp, name[1],
                   msg=jax.tree_util.keystr(name[0]))


# ----------------------------------------------------------------- QCHHE

def history_inputs(rng, b=6):
    nb, rl, tm = (rng.normal(size=(b, K, D)).astype(np.float32) for _ in range(3))
    q = rng.normal(size=(b, D)).astype(np.float32)
    lengths = np.array([K, 3, 0, 1, K - 1, 5])[:b]  # row 2 has no events
    mask = (np.arange(K)[None] < lengths[:, None]).astype(np.float32)
    return nb, rl, tm, q, mask


@pytest.mark.parametrize("encoder", ENCODERS)
def test_history_encoder_tangent_values_and_gradients(encoder):
    rng = np.random.default_rng(4)
    nb, rl, tm, q, mask = history_inputs(rng)
    w, = weights_like(rng, (len(q), D))
    jcfg, pcfg = cfgs(encoder)
    jp, pp = est_params(encoder)

    def jfn(p, nb, rl, tm, q):
        out = JE.history_encoder_tangent(p, jcfg, nb, rl, tm, q, jnp.asarray(mask))
        return jnp.sum(out * w), out

    (want, want_out), want_g = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3, 4), has_aux=True))(jp, *map(jnp.asarray, (nb, rl, tm, q)))
    ins = [t(a, grad=True) for a in (nb, rl, tm, q)]
    out = PE.history_encoder_tangent(pp, pcfg, *ins, t(mask))
    close(out, want_out)
    assert np.abs(want_out[2]).max() == 0  # no events: a zero context
    g = torch.autograd.grad(torch.sum(out * t(w)), tree_leaves(pp) + ins, allow_unused=True)
    n = len(tree_leaves(pp))
    g_params = [torch.zeros_like(x) if gi is None else gi for gi, x in zip(g[:n], tree_leaves(pp))]
    close_trees(dict(zip(range(n), g_params)), want_g[0], msg="params")
    for i, (gi, wi) in enumerate(zip(g[n:], want_g[1:])):
        close_grad(gi, wi, msg=f"input {i}")


@pytest.mark.parametrize("encoder", ENCODERS)
def test_history_encoder_on_the_ball(encoder):
    rng = np.random.default_rng(5)
    nb, rl, tm, q, mask = history_inputs(rng)
    nb, rl, tm = (ball(rng, (len(q), K, D)) for _ in range(3))
    jcfg, pcfg = cfgs(encoder)
    jp, pp = est_params(encoder)
    want = JE.history_encoder(jp, jcfg, *map(jnp.asarray, (nb, rl, tm, q, mask)), C)
    close(PE.history_encoder(pp, pcfg, *map(t, (nb, rl, tm, q, mask)), C), want)


def test_layer_norm_uses_the_biased_variance():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 5, D)).astype(np.float32) * 3 + 1
    scale, bias = (rng.normal(size=D).astype(np.float32) for _ in range(2))
    close(PE._layer_norm(t(x), t(scale), t(bias)),
          JE._layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))


# ------------------------------------------------------ fusion + enrichment

@pytest.mark.parametrize("ball_points", [False, True], ids=["tangent", "ball"])
def test_fuse_global_local(ball_points):
    rng = np.random.default_rng(7)
    g, l = (ball(rng, (9, D)) for _ in range(2))
    if not ball_points:
        g, l = g * 400, l * 400  # tangent rows, some past the ±10 clamp
    w, = weights_like(rng, (9, D))
    jp, pp = est_params("gru")

    def jfn(p, g, l):
        out = (JE.fuse_global_local(p, g, l, C) if ball_points
               else JE.fuse_global_local_tangent(p, g, l))
        return jnp.sum(out * w), out

    (_, want_out), want_g = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True))(
        jp, jnp.asarray(g), jnp.asarray(l))
    tg, tl = t(g, grad=True), t(l, grad=True)
    out = (PE.fuse_global_local(pp, tg, tl, C) if ball_points
           else PE.fuse_global_local_tangent(pp, tg, tl))
    close(out, want_out)
    gg, gl = torch.autograd.grad(torch.sum(out * t(w)), [tg, tl])
    close_grad(gg, want_g[1])
    close_grad(gl, want_g[2])


def test_set_rows_sends_each_rows_gradient_to_the_update_written():
    """Distinct updates at repeated rows: the last valid occurrence writes
    and alone gets the row's gradient, as JAX's scatter-set on the CPU; a
    padded row writes nothing."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    rows = np.array([1, 1, 2, 1, 3], np.int64)
    valid = np.array([1, 1, 1, 0, 1], np.float32)
    upd = np.arange(15, dtype=np.float32).reshape(5, 3) + 100
    w = np.arange(12, dtype=np.float32).reshape(4, 3) + 1

    def jfn(table, upd):
        safe = jnp.where(jnp.asarray(valid) > 0, jnp.asarray(rows), 4)
        out = table.at[safe].set(upd, mode="drop")
        return jnp.sum(out * w), out

    (_, want_out), (want_gt, want_gu) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(table), jnp.asarray(upd))
    tt, tu = t(table, grad=True), t(upd, grad=True)
    out = PE.set_rows(tt, t(rows), t(valid) > 0, tu)
    np.testing.assert_array_equal(out.detach().numpy(), want_out)
    gt, gu = torch.autograd.grad(torch.sum(out * t(w)), [tt, tu])
    np.testing.assert_array_equal(gt.numpy(), want_gt)
    np.testing.assert_array_equal(gu.numpy(), want_gu)
    assert gu.numpy()[[0, 3]].max() == 0 and gu.numpy()[[1, 2, 4]].min() > 0


@pytest.fixture(scope="module")
def snapshots():
    data = generate("synthetic-small", seed=123, **TINY)
    return data, split_by_time(data.train)


def enrichment_case(snapshots, encoder, seed=8):
    """A padded batch of training snapshot 5 (heads repeat; the padding's
    heads too) with its retrieval at time 5 from a JAX TemporalIndex."""
    data, train = snapshots
    rng = np.random.default_rng(seed)
    triples, mask = pad_triples(train[5], data.num_rels, 32)
    index = JE.TemporalIndex(K)
    index.build(train, data.num_rels)
    nb_e, nb_r, dts, msk = index.query(triples[:, 0], 5)
    heads = triples[:, 0][mask > 0]
    assert len(np.unique(heads)) < len(heads) and (mask == 0).any() and msk.sum() > 0
    n, r2 = data.num_nodes, 2 * data.num_rels
    arrays = dict(global_emb=ball(rng, (n, D)), dyn=rng.normal(size=(n, D)).astype(np.float32),
                  rel=rng.normal(size=(r2, D)).astype(np.float32) * 0.5,
                  slow=rng.normal(size=(n, D)).astype(np.float32) * 0.3)
    rb = dict(nb_ents=nb_e, nb_rels=nb_r, deltas=dts, event_mask=msk, row_mask=mask)
    w_out, w_ctx = weights_like(rng, (n, D), (len(triples), D))
    return triples, arrays, rb, w_out, w_ctx


def jax_enrichment(jp, jcfg, triples, arrays, rb, w_out, w_ctx):
    jrb = JE.RetrievalBatch(**{k: jnp.asarray(v) for k, v in rb.items()})

    def jfn(p, g, dyn, rel):
        out, ctx = JE.enrich_embeddings(p, jcfg, g, jnp.asarray(triples), jrb, C,
                                        jnp.asarray(arrays["slow"]), dyn, rel,
                                        return_ctx_tangent=True)
        return jnp.sum(out * w_out) + jnp.sum(ctx * w_ctx), (out, ctx)

    return jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2, 3), has_aux=True))(
        jp, *(jnp.asarray(arrays[k]) for k in ("global_emb", "dyn", "rel")))


def port_enrichment(pp, pcfg, triples, arrays, rb, w_out, w_ctx):
    prb = PE.RetrievalBatch(nb_ents=t(rb["nb_ents"]).long(), nb_rels=t(rb["nb_rels"]).long(),
                            deltas=t(rb["deltas"]), event_mask=t(rb["event_mask"]),
                            row_mask=t(rb["row_mask"]))
    ins = [t(arrays[k], grad=True) for k in ("global_emb", "dyn", "rel")]
    out, ctx = PE.enrich_embeddings(pp, pcfg, ins[0], t(triples).long(), prb, C,
                                    t(arrays["slow"]), ins[1], ins[2], return_ctx_tangent=True)
    total = torch.sum(out * t(w_out)) + torch.sum(ctx * t(w_ctx))
    g = torch.autograd.grad(total, tree_leaves(pp) + ins, allow_unused=True)
    n = len(tree_leaves(pp))
    g_params = [torch.zeros_like(x) if gi is None else gi for gi, x in zip(g[:n], tree_leaves(pp))]
    return (out, ctx), dict(zip(range(n), g_params)), g[n:]


@pytest.mark.parametrize("encoder", ENCODERS)
def test_enrich_embeddings_with_repeated_heads_and_padded_rows(snapshots, encoder):
    """The enriched table, the fused context rows and every gradient (the
    EST parameters, the table, the dynamic and relation tables)."""
    triples, arrays, rb, w_out, w_ctx = enrichment_case(snapshots, encoder)
    jcfg, pcfg = cfgs(encoder)
    jp, pp = est_params(encoder)
    (_, (want_out, want_ctx)), want_g = jax_enrichment(jp, jcfg, triples, arrays, rb, w_out,
                                                       w_ctx)
    (out, ctx), g_params, g_ins = port_enrichment(pp, pcfg, triples, arrays, rb, w_out, w_ctx)
    close(out, want_out)
    close(ctx, want_ctx)
    untouched = np.setdiff1d(np.arange(len(out)), triples[rb["row_mask"] > 0, 0])
    np.testing.assert_array_equal(out.detach().numpy()[untouched],
                                  arrays["global_emb"][untouched])
    close_trees(g_params, want_g[0], msg="est params")
    for name, gi, wi in zip(("global_emb", "dynamic", "relation"), g_ins, want_g[1:]):
        close_grad(gi, wi, msg=name)


def test_a_plain_index_put_would_miss_jax(snapshots, monkeypatch):
    """The same case with the write-back as a plain ``index_put``: every
    duplicate head then takes its row's gradient, and the EST parameters'
    gradients leave JAX's."""
    triples, arrays, rb, w_out, w_ctx = enrichment_case(snapshots, "gru")
    jcfg, pcfg = cfgs("gru")
    jp, pp = est_params("gru")
    _, want_g = jax_enrichment(jp, jcfg, triples, arrays, rb, w_out, w_ctx)

    def plain(table, rows, valid, values):
        keep = valid.nonzero()[:, 0]
        return table.index_put((rows[keep],), values[keep])

    monkeypatch.setattr(PE, "set_rows", plain)
    _, g_params, _ = port_enrichment(pp, pcfg, triples, arrays, rb, w_out, w_ctx)
    with pytest.raises(AssertionError):
        close_trees(g_params, want_g[0], msg="est params")


# -------------------------------------------------------- host side: ETNR, TANS

@pytest.mark.parametrize("query_time", [0, 3, 5, 100])
def test_temporal_index_query_equals_jax(snapshots, query_time):
    data, train = snapshots
    ents = np.concatenate([np.arange(data.num_nodes), [0, 7, 7]])
    got_index, want_index = PE.TemporalIndex(K), JE.TemporalIndex(K)
    got_index.build(train, data.num_rels)
    want_index.build(train, data.num_rels)
    got, want = got_index.query(ents, query_time), want_index.query(ents, query_time)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (got[3].sum() > 0) == (query_time > 0)


def test_true_tails_and_tans_mask_coo_equal_jax(snapshots):
    data, train = snapshots
    got_tails = PE.build_true_tails_dict(train, data.num_rels)
    want_tails = JE.build_true_tails_dict(train, data.num_rels)
    assert got_tails.keys() == want_tails.keys()
    for k in want_tails:
        np.testing.assert_array_equal(got_tails[k], want_tails[k])
    for i in (1, 5):
        triples, mask = pad_triples(train[i], data.num_rels, 32)
        for kw in ({}, dict(max_filter=1, pad_bucket=8)):
            got = PE.tans_mask_coo(triples, mask, got_tails, **kw)
            want = JE.tans_mask_coo(triples, mask, want_tails, **kw)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            assert (got[0] < len(triples)).any()
            assert kw or (got[0] == len(triples)).any()  # padded to 4096


def test_squash_entries_drops_padding_and_passes_no_gradient(snapshots):
    data, train = snapshots
    tails = JE.build_true_tails_dict(train, data.num_rels)
    triples, mask = pad_triples(train[5], data.num_rels, 32)
    rows, cols = JE.tans_mask_coo(triples, mask, tails, pad_bucket=64)
    rng = np.random.default_rng(9)
    scores = rng.normal(size=(len(triples), data.num_nodes)).astype(np.float32)
    w, = weights_like(rng, scores.shape)

    def jfn(s):
        out = s.at[jnp.asarray(rows), jnp.asarray(cols)].set(-1e9, mode="drop")
        return jnp.sum(jnp.where(out > -1e8, out * w, 0.0)), out

    (_, want), want_g = jax.jit(jax.value_and_grad(jfn, has_aux=True))(jnp.asarray(scores))
    ts = t(scores, grad=True)
    got = PE.squash_entries(ts, t(rows), t(cols))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    g, = torch.autograd.grad(torch.sum(torch.where(got > -1e8, got * t(w), 0.0)), ts)
    np.testing.assert_array_equal(g.numpy(), want_g)


# ------------------------------------------------- the hyperbolic GRU library

def gru_case(name, rng):
    """(JAX's function, the port's, JAX's parameters, the inputs), the
    parameters from ``PRNGKey(0)``, the inputs ball points or tangents."""
    key = jax.random.PRNGKey(0)
    if name in ("cell", "tangent_input"):
        jp = JG.init_hyperbolic_gru_cell(key, D, D)
        x = (rng.normal(size=(5, D)).astype(np.float32) if name == "tangent_input"
             else ball(rng, (5, D)))
        fn = "hyperbolic_gru_cell" if name == "cell" else "hyperbolic_gru_cell_tangent_input"
        return getattr(JG, fn), getattr(PG, fn), jp, (x, ball(rng, (5, D)))
    if name in ("sequence", "sequence_h0"):
        jp = JG.init_hyperbolic_gru(key, D, D, num_layers=2)
        x = ball(rng, (4, 3, D))
        if name == "sequence":
            return JG.hyperbolic_gru, PG.hyperbolic_gru, jp, (x,)
        h0 = ball(rng, (2, 3, D))
        return (lambda p, x, h0, c: JG.hyperbolic_gru(p, x, c, h0_hyp=h0),
                lambda p, x, h0, c: PG.hyperbolic_gru(p, x, c, h0_hyp=h0), jp, (x, h0))
    if name == "entity_gate":
        jp = JG.init_hyperbolic_entity_gru(key, D)
        return (JG.hyperbolic_entity_gru, PG.hyperbolic_entity_gru, jp,
                (ball(rng, (6, D)), ball(rng, (6, D))))
    jp = JG.init_hyperbolic_relation_gru(key, D)
    return (JG.hyperbolic_relation_gru, PG.hyperbolic_relation_gru, jp,
            (rng.normal(size=(6, 2 * D)).astype(np.float32), ball(rng, (6, D))))


@pytest.mark.parametrize("name", ["cell", "tangent_input", "sequence", "sequence_h0",
                                  "entity_gate", "relation"])
def test_hyperbolic_gru_library_matches_jax(name):
    """``regcn_torch/hyperbolic/gru.py``: each cell's output and the
    gradients of its parameters and inputs (the sequence model's outputs
    and final states both)."""
    rng = np.random.default_rng(10)
    jfn, pfn, jp, ins = gru_case(name, rng)
    ws = None

    def flat(out):
        return out if isinstance(out, tuple) else (out,)

    def jloss(p, *ins):
        outs = flat(jfn(p, *ins, C))
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    ws = [rng.normal(size=o.shape).astype(np.float32)
          for o in flat(jfn(jp, *map(jnp.asarray, ins), C))]
    argnums = tuple(range(len(ins) + 1))
    (_, want_outs), want_g = jax.jit(jax.value_and_grad(jloss, argnums=argnums, has_aux=True))(
        jp, *map(jnp.asarray, ins))
    pp = tree_map(lambda a: t(a, grad=True), jax.tree.map(np.asarray, jp))
    tins = [t(a, grad=True) for a in ins]
    outs = flat(pfn(pp, *tins, C))
    for o, w in zip(outs, want_outs):
        close(o, w)
    g = torch.autograd.grad(sum(torch.sum(o * t(w)) for o, w in zip(outs, ws)),
                            tree_leaves(pp) + tins)
    n = len(tree_leaves(pp))
    close_trees(dict(zip(range(n), g[:n])), want_g[0], msg="params")
    for i, (gi, wi) in enumerate(zip(g[n:], want_g[1:])):
        close_grad(gi, wi, msg=f"input {i}")
