"""The port's RE-GCN model against regcn_tpu.models on converted weights.

JAX's init_params(PRNGKey(0)) goes through params_from_jax; both packages
then see the same parameters and the same snapshot arrays. Tolerance:
fp32 on both sides with sums in another order, rtol=1e-4 / atol=1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.config import ModelConfig as JaxModelConfig
from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.models import decoders as jax_decoders
from regcn_tpu.models import layers as jax_layers
from regcn_tpu.models import recurrent as jax_recurrent
from regcn_torch.config import ModelConfig
from regcn_torch.convert import params_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.models import decoders as pt_decoders
from regcn_torch.models import layers as pt_layers
from regcn_torch.models import recurrent as pt_recurrent
from regcn_torch.train.optim import tree_leaves

TINY = dict(num_ents=64, num_rels=6, num_snaps=10, triples_per_snap=40, split=(6, 2, 2))
RTOL, ATOL = 1e-4, 1e-5


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=123, **TINY)


def configs(data, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=32, n_layers=2, **kw)
    return JaxModelConfig(**base), ModelConfig(**base)


def jax_init(cfg, seed=0, random_bn=False):
    """JAX parameters as numpy; with ``random_bn`` the BN affine params and
    running stats are made non-trivial so the eval-mode BN is exercised."""
    params, state = jax.tree.map(np.asarray, jax_recurrent.init_params(jax.random.PRNGKey(seed), cfg))
    if random_bn:
        rng = np.random.default_rng(seed + 1)
        for dec, bn in (("decoder_ob", state.bn_ob), ("decoder_rel", state.bn_rel)):
            for name in ("bn0", "bn1", "bn2"):
                c = bn[name]["mean"].shape[0]
                bn[name] = {"mean": rng.normal(size=c).astype(np.float32) * 0.3,
                            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
                params[dec][name] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                                     "bias": rng.normal(size=c).astype(np.float32) * 0.1}
    return params, state


def history(data, empty_first=False):
    window = pt_snapshots.split_by_time(data.train)[2:5]
    host = pt_snapshots.build_history(window, data.num_nodes, data.num_rels,
                                      edge_bucket=32, rc_bucket=64)
    if empty_first:  # an all-masked step, as the JAX eval store front-pads
        host.edge_mask[0] = 0.0
        host.rc_mask[0] = 0.0
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


def test_init_params_matches_jax_structure(data):
    jcfg, pcfg = configs(data, skip_connect=True)
    want = jax_init(jcfg)
    got = pt_recurrent.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    conv = params_from_jax(*want, device="cpu")

    def leaves(tree):
        return jax.tree.leaves((tree[0], dataclasses.asdict(tree[1])))

    want_shapes = [a.shape for a in leaves(want)]
    assert [tuple(a.shape) for a in leaves(got)] == want_shapes
    assert [tuple(a.shape) for a in leaves(conv)] == want_shapes
    for a, b in zip(leaves(conv), leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b)
    # the same generator seed gives the same parameters again
    again = pt_recurrent.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(again)))


@pytest.mark.parametrize("layer,skip", [(0, False), (1, True)])
def test_union_rgcn_layer_matches_jax(data, rng, layer, skip):
    jcfg, _ = configs(data, skip_connect=skip)
    params_np, state_np = jax_init(jcfg)
    params, _ = params_from_jax(params_np, state_np, device="cpu")
    pt_hist, jx_hist = history(data)
    snap_pt = pt_hist.step(1)
    snap_jx = jax.tree.map(lambda a: a[1], jx_hist)
    h = rng.normal(size=(data.num_nodes, 32)).astype(np.float32)
    rel = rng.normal(size=(2 * data.num_rels, 32)).astype(np.float32)
    prev = rng.normal(size=h.shape).astype(np.float32) if skip else None
    got = pt_layers.union_rgcn_layer(
        params["rgcn"]["layers"][layer], torch.from_numpy(h), torch.from_numpy(rel), snap_pt,
        prev_h=None if prev is None else torch.from_numpy(prev))
    want = jax_layers.union_rgcn_layer(
        params_np["rgcn"]["layers"][layer], jnp.asarray(h), jnp.asarray(rel), snap_jx,
        prev_h=None if prev is None else jnp.asarray(prev))
    close(got, want)


def test_gru_cell_matches_jax_and_torch(data, rng):
    jcfg, _ = configs(data)
    params_np, state_np = jax_init(jcfg)
    params, _ = params_from_jax(params_np, state_np, device="cpu")
    x = rng.normal(size=(12, 64)).astype(np.float32)
    h = rng.normal(size=(12, 32)).astype(np.float32)
    got = pt_layers.gru_cell(params["gru"], torch.from_numpy(x), torch.from_numpy(h))
    close(got, jax_layers.gru_cell(params_np["gru"], jnp.asarray(x), jnp.asarray(h)))
    cell = torch.nn.GRUCell(64, 32)  # gate order r, z, n, as torch's own cell
    with torch.no_grad():
        for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
            getattr(cell, k.replace("w_", "weight_").replace("b_", "bias_")).copy_(params["gru"][k])
        close(got, cell(torch.from_numpy(x), torch.from_numpy(h)))


@pytest.mark.parametrize("which", ["convtranse", "convtransr"])
def test_decoders_match_jax(data, rng, which):
    jcfg, _ = configs(data)
    params_np, state_np = jax_init(jcfg, random_bn=True)
    params, state = params_from_jax(params_np, state_np, device="cpu")
    emb = rng.normal(size=(data.num_nodes, 32)).astype(np.float32)
    rel = rng.normal(size=(2 * data.num_rels, 32)).astype(np.float32)
    triples, mask = pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.test)[0],
                                             data.num_rels, 32)
    dec, bn = ("decoder_ob", "bn_ob") if which == "convtranse" else ("decoder_rel", "bn_rel")
    got = getattr(pt_decoders, f"{which}_score")(
        params[dec], getattr(state, bn), torch.from_numpy(emb), torch.from_numpy(rel),
        torch.from_numpy(triples).long())
    want, _ = getattr(jax_decoders, f"{which}_score")(
        params_np[dec], getattr(state_np, bn), jnp.asarray(emb), jnp.asarray(rel),
        jnp.asarray(triples), jnp.asarray(mask), train=False)
    close(got, want)


@pytest.mark.parametrize("empty_first", [False, True])
def test_evolve_matches_jax(data, empty_first):
    jcfg, pcfg = configs(data)
    params_np, state_np = jax_init(jcfg)
    params, _ = params_from_jax(params_np, state_np, device="cpu")
    pt_hist, jx_hist = history(data, empty_first)
    h, r = pt_recurrent.evolve(params, pcfg, pt_hist)
    jh, jr, _, _ = jax_recurrent.evolve(params_np, jcfg, jx_hist)
    close(h, jh)
    close(r, jr)


def test_predict_matches_jax(data):
    jcfg, pcfg = configs(data)
    params_np, state_np = jax_init(jcfg, random_bn=True)
    params, state = params_from_jax(params_np, state_np, device="cpu")
    pt_hist, jx_hist = history(data)
    triples, mask = pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[5],
                                             data.num_rels, 128)
    s_ob, s_rel = pt_recurrent.predict(params, state, pcfg, pt_hist,
                                       torch.from_numpy(triples).long())
    j_ob, j_rel = jax_recurrent.predict(params_np, state_np, jcfg, jx_hist,
                                        jnp.asarray(triples), jnp.asarray(mask))
    assert s_ob.shape == (len(triples), data.num_nodes)
    assert s_rel.shape == (len(triples), 2 * data.num_rels)
    close(s_ob, j_ob)
    close(s_rel, j_rel)


def static_graph(data, n_words=16, n_rels=3):
    """(torch snapshot, JAX snapshot) of a static entity-word graph: one
    link from each entity, its word and relation drawn from a seed."""
    rng = np.random.default_rng(3)
    ents = np.arange(data.num_nodes)
    st = np.stack([ents, rng.integers(0, n_rels, len(ents)),
                   rng.integers(0, n_words, len(ents)) + data.num_nodes], axis=1)
    host = pt_snapshots.build_snapshot(st, data.num_nodes + n_words, n_rels, edge_bucket=32)
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


@pytest.mark.parametrize("unported", [dict(use_static=True), dict(dtype="bfloat16")])
def test_unported_configs_raise(data, unported):
    """The static graph (``use_static``) and bf16 compute, refused until
    they were ported, now run: the static graph's parameters have JAX's
    keys and shapes, and the eval scores from its static start match
    JAX's; under bf16 the parameters stay fp32, and a dtype JAX does not
    offer raises."""
    if "use_static" not in unported:
        _, pcfg = configs(data, **unported)
        got, _ = pt_recurrent.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
        assert all(t.dtype == torch.float32 for t in tree_leaves(got))
        with pytest.raises(ValueError, match="compute dtype"):
            pt_recurrent.init_params(torch.Generator().manual_seed(0),
                                     dataclasses.replace(pcfg, dtype="float16"), device="cpu")
        return
    jcfg, pcfg = configs(data, use_static=True, num_static_rels=3, num_words=16, n_bases=8)
    got, _ = pt_recurrent.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    params_np, state_np = jax_init(jcfg)
    assert got["words_emb"].shape == params_np["words_emb"].shape == (16, 32)
    assert got["static_rgcn"]["weight"].shape == params_np["static_rgcn"]["weight"].shape
    params, state = params_from_jax(params_np, state_np, device="cpu")
    pt_snap, jx_snap = static_graph(data)
    pt_hist, jx_hist = history(data)
    triples, mask = pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[5],
                                             data.num_rels, 128)
    s_ob, s_rel = pt_recurrent.predict(params, state, pcfg, pt_hist,
                                       torch.from_numpy(triples).long(), static_snap=pt_snap)
    j_ob, j_rel = jax_recurrent.predict(params_np, state_np, jcfg, jx_hist,
                                        jnp.asarray(triples), jnp.asarray(mask),
                                        static_snap=jx_snap)
    close(s_ob, j_ob)
    close(s_rel, j_rel)
