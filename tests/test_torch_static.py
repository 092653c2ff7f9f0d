"""The static entity-word graph (BASELINE config 2's constraint) in the
port, against regcn_tpu, in both model families: RE-GCN and the
hyperbolic headline (uvrgcn + tangent ConvTransE/R).

The data are built as ``tests/test_static_graph.py`` builds them: the
synthetic-small generator at seed 13 (50 entities), and 100 static links
from a numpy seed over 3 static relations and 20 words; to these each
entity adds one link, as every entity of the configurations' data has
some (synthetic ``with_static`` gives each 3). An entity without a link
starts from a zero row of the static embedding, and the 1/eps factors of
the two L2 normalisations it then passes overflow its gradient: JAX's
is NaN there. Parameters are
JAX's ``init_params(PRNGKey(0))`` converted, every dropout is 0, and the
static graph's Snapshot is built by each package from the same triples.
Tolerances:

- functions (the block layer, ``_static_init``, both angular losses,
  ``evolve(return_all)``, ``predict``): values within rtol 1e-4 / atol
  1e-5 (fp32 with sums in another order); gradients within rtol 1e-3 /
  atol 1e-5;
- ``get_loss``: the losses within rtol 1e-4 / atol 1e-5, every gradient
  within rtol 1e-3 / atol 1e-5, ``words_emb`` and ``static_rgcn.weight``
  among them;
- a training step (epoch 0 step by step from JAX's state before each
  ``train_step``): the losses within rtol 1e-4 / atol 1e-5; every
  parameter and BN statistic within atol 1e-5 + rtol 1e-3, far below
  lr = 1e-3, so each step's direction must agree. As in the trainers'
  other tests, the decoders' ``conv_b`` / ``fc_b`` (a batch-statistics
  BatchNorm follows each) and, on a one-snapshot window, the hyperbolic
  ``radius_mlp`` (the layer norm erases the radius it sets) have a true
  gradient of 0 that both packages turn into rounding noise: their
  values are not compared there and the port's gradient of each is held
  to 1e-6 of the step's largest;
- ``fit``: epoch 0's valid MRR within 1e-4 and its mean losses within
  rtol 1e-4 / atol 1e-5 of JAX's ``fit``; resumed from its checkpoint
  for a second epoch, the state and the valid MRR of 2 epochs in one
  ``fit``, to 1e-6 (the same code on the same device: two epochs of
  fp32 drift between the packages can move a near-tied rank, so the
  second epoch is held to the port's own uninterrupted run);
- the rolling test of JAX's best state: the same ranks, snapshot by
  snapshot.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.config import ExperimentConfig as JaxExperimentConfig
from regcn_tpu.config import ModelConfig as JaxModelConfig
from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.data.dataset import TKGData
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxHypTrainer
from regcn_tpu.models import layers as jax_layers
from regcn_tpu.models import recurrent as jax_recurrent
from regcn_tpu.train import loop as jax_loop
from regcn_tpu.train import metrics as jax_metrics
from regcn_tpu.train.state import create_train_state as jax_create_train_state
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.convert import hyperbolic_params_from_jax, params_from_jax, train_state_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic.train import HyperbolicTrainer, compute_radius_targets
from regcn_torch.models import layers as pt_layers
from regcn_torch.models import recurrent as pt_recurrent
from regcn_torch.train import loop as pt_loop
from regcn_torch.train import metrics as pt_metrics
from regcn_torch.train import state as pt_state
from regcn_torch.train.optim import tree_leaves

D, N_BASES = 8, 4
NUM_WORDS, NUM_STATIC_RELS = 20, 3
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
# windows of 1 and 2 snapshots keep JAX's compilations (one per window
# length and step function) few
TC = dict(n_epochs=2, lr=1e-3, train_history_len=2, test_history_len=2, edge_bucket=32,
          rc_bucket=64, triple_bucket=64)
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 1e-3
MRR_TOL = 1e-4
SHIFT_INVARIANT = {f"['{dec}']['{b}']" for dec in ("decoder_ob", "decoder_rel")
                   for b in ("conv_b", "fc_b")}
RADIUS_MLP = {"['radius_mlp_w']", "['radius_mlp_b']"}
FAMILIES = ["regcn", "hyperbolic"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save,
    and on a CPU shared with other test workers far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    base = generate("synthetic-small", seed=13, num_ents=50, num_rels=5, num_snaps=12,
                    triples_per_snap=30, split=(8, 2, 2))
    rng = np.random.default_rng(0)
    ents = np.arange(base.num_nodes)
    static = np.concatenate([
        np.stack([rng.integers(0, base.num_nodes, 100), rng.integers(0, NUM_STATIC_RELS, 100),
                  rng.integers(0, NUM_WORDS, 100) + base.num_nodes], axis=1),
        np.stack([ents, ents % NUM_STATIC_RELS, ents % NUM_WORDS + base.num_nodes], axis=1)])
    return TKGData(train=base.train, valid=base.valid, test=base.test,
                   num_nodes=base.num_nodes, num_rels=base.num_rels, static_triples=static,
                   num_static_rels=NUM_STATIC_RELS, num_words=NUM_WORDS)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def static_kw(data, **kw):
    return dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_bases=N_BASES,
                use_static=True, num_static_rels=data.num_static_rels,
                num_words=data.num_words, **NO_DROPOUT, **kw)


def regcn_configs(data, **kw):
    base = static_kw(data, n_layers=2, **kw)
    return (JaxExperimentConfig(model=JaxModelConfig(**base), train=JaxTrainConfig(**TC)),
            ExperimentConfig(model=ModelConfig(**base), train=TrainConfig(**TC)))


def hyp_configs(data, **kw):
    base = static_kw(data, n_layers=2, encoder="hyperbolic_uvrgcn",
                     decoder="hyperbolic_convtranse", c=0.01, **kw)
    return JM.HyperbolicConfig(**base), PM.HyperbolicConfig(**base)


def static_snaps(data):
    """(the port's static Snapshot on the CPU, JAX's), each package's own build."""
    n_total = data.num_nodes + data.num_words
    pt = pt_snapshots.build_snapshot(data.static_triples, n_total, data.num_static_rels,
                                     edge_bucket=32)
    jx = jax_snapshots.build_snapshot(data.static_triples, n_total, data.num_static_rels,
                                      edge_bucket=32)
    for f in pt_snapshots._ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(pt, f), np.asarray(getattr(jx, f)), err_msg=f)
    return pt.to("cpu"), jx


def history(data, start=2, length=3):
    window = pt_snapshots.split_by_time(data.train)[start:start + length]
    host = pt_snapshots.build_history(window, data.num_nodes, data.num_rels, edge_bucket=32,
                                      rc_bucket=64)
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


def triples_of(data, t=5):
    return pt_snapshots.pad_triples(pt_snapshots.split_by_time(data.train)[t], data.num_rels, 64)


def model_init(data, family):
    """(jax config, port config, JAX params and state as jnp arrays, the
    port's converted params and state)."""
    if family == "regcn":
        (jcfg, pcfg) = (c.model for c in regcn_configs(data))
        params, state = jax_recurrent.init_params(jax.random.PRNGKey(0), jcfg)
        params, state = jax.tree.map(np.asarray, (params, state))
        converted = params_from_jax(params, state, device="cpu")
    else:
        jcfg, pcfg = hyp_configs(data)
        rt = compute_radius_targets(pt_snapshots.split_by_time(data.train), data.num_nodes)
        params, state = JM.init_params(jax.random.PRNGKey(0), jcfg, rt)
        params, state = jax.tree.map(np.asarray, (params, state))
        converted = hyperbolic_params_from_jax(params, state, device="cpu")
    return jcfg, pcfg, jax.tree.map(jnp.asarray, (params, state)), converted


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


def params_with_grad(params):
    return jax.tree.map(lambda t: t.detach().clone().requires_grad_(True), params)


# ------------------------------------------------------------- the layer

def test_block_layer_matches_jax(data):
    """``rgcn_block_layer`` on the static graph: values, and the gradients
    of h and of the block weights."""
    pt_snap, jx_snap = static_snaps(data)
    n_total = data.num_nodes + data.num_words
    jp = jax_layers.init_rgcn_block_layer(jax.random.PRNGKey(0), D, 2 * NUM_STATIC_RELS,
                                          N_BASES)
    assert jp["weight"].shape == (2 * NUM_STATIC_RELS, N_BASES * (D // N_BASES) ** 2)
    got_init = pt_layers.init_rgcn_block_layer(torch.Generator().manual_seed(0), D,
                                               2 * NUM_STATIC_RELS, N_BASES)
    assert got_init["weight"].shape == tuple(jp["weight"].shape)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(n_total, D)).astype(np.float32)
    probe = rng.normal(size=(n_total, D)).astype(np.float32)

    def jax_fn(w, x):
        out = jax_layers.rgcn_block_layer({"weight": w}, x, jx_snap, N_BASES)
        return jnp.sum(out * probe), out

    (jg_w, jg_h), out_j = jax.grad(jax_fn, argnums=(0, 1), has_aux=True)(jp["weight"],
                                                                         jnp.asarray(h))
    w = torch.from_numpy(np.asarray(jp["weight"])).requires_grad_(True)
    x = torch.from_numpy(h).requires_grad_(True)
    out = pt_layers.rgcn_block_layer({"weight": w}, x, pt_snap, N_BASES)
    close(out, out_j)
    g_w, g_h = torch.autograd.grad(torch.sum(out * torch.from_numpy(probe)), (w, x))
    close(g_w, jg_w, rtol=GRAD_RTOL)
    close(g_h, jg_h, rtol=GRAD_RTOL)


@pytest.mark.parametrize("layer_norm", [True, False], ids=["layer_norm", "raw"])
def test_static_init_matches_jax(data, layer_norm):
    jcfg, pcfg, (jp, _), (cp, _) = model_init(data, "regcn")
    jcfg = dataclasses.replace(jcfg, layer_norm=layer_norm)
    pcfg = dataclasses.replace(pcfg, layer_norm=layer_norm)
    pt_snap, jx_snap = static_snaps(data)
    got = pt_recurrent._static_init(cp, pcfg, pt_snap)
    want = jax_recurrent._static_init(jp, jcfg, jx_snap, None, False)
    assert got.shape == (data.num_nodes, D)
    close(got, want)


# --------------------------------------------------------- angular losses

@pytest.mark.parametrize("padded", [False, True], ids=["full", "front_padded"])
@pytest.mark.parametrize("discount", [0.0, 1.0], ids=["discount0", "discount1"])
@pytest.mark.parametrize("layer_norm", [True, False], ids=["layer_norm", "raw"])
def test_static_angular_loss_matches_jax(layer_norm, discount, padded):
    """Value and both gradients; a front-padded window (its first step
    inactive) numbers its active steps only."""
    _, pcfg = regcn_configs_plain(layer_norm=layer_norm, discount=discount, angle=30.0)
    jcfg = JaxModelConfig(**dataclasses.asdict(pcfg))
    rng = np.random.default_rng(2)
    static = rng.normal(size=(12, D)).astype(np.float32)
    if layer_norm:
        static /= np.linalg.norm(static, axis=-1, keepdims=True)
    all_h = (static[None] + 0.8 * rng.normal(size=(3, 12, D))).astype(np.float32)
    active = np.array([0.0, 1.0, 1.0], np.float32) if padded else None

    def jax_fn(s, a):
        return jax_recurrent.static_angular_loss(
            s, a, jcfg, active=None if active is None else jnp.asarray(active))

    want, (jg_s, jg_a) = jax.value_and_grad(jax_fn, argnums=(0, 1))(jnp.asarray(static),
                                                                     jnp.asarray(all_h))
    s, a = (torch.from_numpy(v).requires_grad_(True) for v in (static, all_h))
    got = pt_recurrent.static_angular_loss(
        s, a, pcfg, active=None if active is None else torch.from_numpy(active))
    assert float(want) > 0
    close(got, want)
    g_s, g_a = torch.autograd.grad(got, (s, a))
    close(g_s, jg_s, rtol=GRAD_RTOL)
    close(g_a, jg_a, rtol=GRAD_RTOL)


def regcn_configs_plain(**kw):
    """A RE-GCN config of the static-loss fields only (no data)."""
    base = dict(num_ents=12, num_rels=2, h_dim=D, use_static=True, static_weight=0.5, **kw)
    return JaxModelConfig(**base), ModelConfig(**base)


@pytest.mark.parametrize("layer_norm", [True, False], ids=["layer_norm", "raw"])
def test_static_angular_loss_tangent_matches_jax(layer_norm):
    """The hyperbolic constraint on ball points, compared in tangent space:
    value and both gradients, with a front-padded window."""
    base = dict(num_ents=12, num_rels=2, h_dim=D, use_static=True, angle=20.0,
                layer_norm=layer_norm)
    jcfg, pcfg = JM.HyperbolicConfig(**base), PM.HyperbolicConfig(**base)
    rng = np.random.default_rng(3)
    static = rng.normal(size=(12, D)).astype(np.float32)
    static /= np.linalg.norm(static, axis=-1, keepdims=True)
    tangent = (static[None] + 0.8 * rng.normal(size=(3, 12, D))).astype(np.float32)
    all_h = np.asarray(JM.H.exp_map_zero(jnp.asarray(tangent), 0.01))
    active = np.array([0.0, 1.0, 1.0], np.float32)

    def jax_fn(s, a):
        return JM.static_angular_loss_tangent(s, a, jcfg, 0.01, active=jnp.asarray(active))

    want, (jg_s, jg_a) = jax.value_and_grad(jax_fn, argnums=(0, 1))(jnp.asarray(static),
                                                                     jnp.asarray(all_h))
    s, a = (torch.from_numpy(v).requires_grad_(True) for v in (static, all_h))
    got = PM.static_angular_loss_tangent(s, a, pcfg, 0.01, active=torch.from_numpy(active))
    assert float(want) > 0
    close(got, want)
    g_s, g_a = torch.autograd.grad(got, (s, a))
    close(g_s, jg_s, rtol=GRAD_RTOL)
    close(g_a, jg_a, rtol=GRAD_RTOL)


# ---------------------------------------------------- evolve, loss, predict

def family_evolve(family, params, cfg, hist, snap, port):
    if family == "regcn":
        if port:
            return pt_recurrent.evolve(params, cfg, hist, static_snap=snap, return_all=True)
        return jax_recurrent.evolve(params, cfg, hist, static_snap=snap, return_all=True)
    if port:
        return PM.evolve(params, cfg, hist, static_snap=snap, return_all=True)
    return JM.evolve(params, cfg, hist, static_snap=snap, return_all=True)


@pytest.mark.parametrize("family", FAMILIES)
def test_evolve_return_all_matches_jax(data, family):
    """The final points, the relation state, the static embedding and
    every step's points [T, N, d], on a window with an empty front step."""
    jcfg, pcfg, (jp, _), (cp, _) = model_init(data, family)
    pt_snap, jx_snap = static_snaps(data)
    pt_hist, jx_hist = history(data)
    got = family_evolve(family, cp, pcfg, pt_hist, pt_snap, True)
    want = family_evolve(family, jp, jcfg, jx_hist, jx_snap, False)
    assert got[3].shape == (3, data.num_nodes, D)
    for name, g, w in zip(("h", "h0", "static_emb", "all_h"), got, want):
        close(g, w, msg=name)
    close(got[3][-1], want[0])


def family_loss(family, params, state, cfg, hist, triples, mask, snap, port):
    if family == "regcn":
        fn = pt_recurrent.get_loss if port else jax_recurrent.get_loss
        _, losses, new = fn(params, state, cfg, hist, triples, mask, static_snap=snap,
                            train=True)
    else:
        fn = PM.get_loss if port else JM.get_loss
        _, losses, new, _ = fn(params, state, cfg, hist, triples, mask, static_snap=snap,
                               train=True)
    total = 0.7 * losses["entity"] + 0.3 * losses["relation"] + losses["static"]
    if family == "hyperbolic":
        total = total + losses["radius"]
    return total, losses


@pytest.mark.parametrize("family", FAMILIES)
def test_get_loss_matches_jax(data, family):
    """Every loss, the static one > 0, and every parameter's gradient,
    ``words_emb`` and ``static_rgcn.weight`` among them."""
    jcfg, pcfg, (jp, js), (cp, cs) = model_init(data, family)
    pt_snap, jx_snap = static_snaps(data)
    pt_hist, jx_hist = history(data)
    triples, mask = triples_of(data)

    def jax_fn(p):
        return family_loss(family, p, js, jcfg, jx_hist, jnp.asarray(triples),
                           jnp.asarray(mask), jx_snap, False)

    want_grads, want_losses = jax.jit(jax.grad(jax_fn, has_aux=True))(jp)
    cp = params_with_grad(cp)
    total, losses = family_loss(family, cp, cs, pcfg, pt_hist, torch.from_numpy(triples).long(),
                                torch.from_numpy(mask), pt_snap, True)
    assert float(want_losses["static"]) > 0
    for k, v in want_losses.items():
        close(losses[k], v, msg=k)
    names = paths(cp)
    assert "['words_emb']" in names and "['static_rgcn']['weight']" in names
    grads = torch.autograd.grad(total, tree_leaves(cp), allow_unused=True)
    want = keyed(want_grads)
    for name, g in zip(names, grads):
        if g is None:
            assert not np.any(want[name]), name
            continue
        close(g, want[name], rtol=GRAD_RTOL, msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_predict_matches_jax(data, family):
    jcfg, pcfg, (jp, js), (cp, cs) = model_init(data, family)
    pt_snap, jx_snap = static_snaps(data)
    pt_hist, jx_hist = history(data)
    triples, mask = triples_of(data, t=6)
    trip = torch.from_numpy(triples).long()
    if family == "regcn":
        got = pt_recurrent.predict(cp, cs, pcfg, pt_hist, trip, static_snap=pt_snap)
        want = jax_recurrent.predict(jp, js, jcfg, jx_hist, jnp.asarray(triples),
                                     jnp.asarray(mask), static_snap=jx_snap)
        plain = pt_recurrent.predict(cp, cs, pcfg, pt_hist, trip)
    else:
        got = PM.predict(cp, cs, pcfg, pt_hist, trip, torch.from_numpy(mask),
                         static_snap=pt_snap)
        want = JM.predict(jp, js, jcfg, jx_hist, jnp.asarray(triples), jnp.asarray(mask),
                          static_snap=jx_snap)
        plain = PM.predict(cp, cs, pcfg, pt_hist, trip, torch.from_numpy(mask))
    for g, w in zip(got, want):
        close(g, w)
    # the static start changes the scores
    assert not torch.allclose(got[0], plain[0])


# ---------------------------------------------------------------- trainers

def host_copy(tree):
    """numpy copies: JAX's steps donate their input state's buffers."""
    return jax.tree.map(lambda a: np.array(a), tree)


def device_copy(tree):
    return jax.tree.map(jnp.asarray, tree)


class RankRecorder:
    """Stands in for a metrics module's ``stat_ranks`` and keeps the rank
    arrays it is given."""

    def __init__(self, stat_ranks):
        self.stat_ranks, self.seen = stat_ranks, []

    def __call__(self, rank_arrays, *a, **kw):
        self.seen.append([np.asarray(r) for r in rank_arrays])
        return self.stat_ranks(rank_arrays, *a, **kw)


def recorded_test(trainer, state, monkeypatch, module):
    """(stats, the four rank-array lists) of ``trainer.test(state)``."""
    recorder = RankRecorder(module.stat_ranks)
    with monkeypatch.context() as m:
        m.setattr(module, "stat_ranks", recorder)
        stats = trainer.test(state)
    return stats, recorder.seen


def port_trainer(data, family):
    if family == "regcn":
        return pt_loop.Trainer(regcn_configs(data)[1], data, device="cpu")
    return HyperbolicTrainer(hyp_configs(data)[1], TrainConfig(**TC), data, device="cpu")


@pytest.fixture(scope="module", params=FAMILIES)
def jax_run(request, data):
    """JAX, with the static graph: epoch 0 step by step through its
    ``train_step`` (window index, state before, losses, state after);
    ``fit`` for 1 epoch from the initial state; the rolling test of fit's
    best state, the rank arrays read where they are reduced."""
    family = request.param
    order = port_trainer(data, family).epoch_order(0)
    if family == "regcn":
        jcfg, _ = regcn_configs(data)
        trainer = jax_loop.Trainer(jcfg, data)
        init = host_copy(jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train))
        hlen, step_args = TC["train_history_len"], ()
    else:
        jcfg, _ = hyp_configs(data)
        trainer = JaxHypTrainer(jcfg, JaxTrainConfig(**TC), data)
        init = host_copy(trainer.init_state(jax.random.PRNGKey(0)))
        hlen = TC["train_history_len"]
        step_args = (jnp.asarray(trainer._curvature_max(0), jnp.float32),)
    state, steps = device_copy(init), []
    for i in order:
        hist = trainer._history(trainer.train_list[max(0, i - hlen):i])
        triples, mask = jax_snapshots.pad_triples(trainer.train_list[i], data.num_rels,
                                                  TC["triple_bucket"])
        before = host_copy(state)
        state, losses = trainer.train_step(state, hist, jnp.asarray(triples),
                                           jnp.asarray(mask), *step_args)
        steps.append((i, before, jax.tree.map(float, losses), host_copy(state)))
    if family == "regcn":
        trainer.cfg = dataclasses.replace(
            trainer.cfg, train=dataclasses.replace(trainer.cfg.train, n_epochs=1))
        best, info = trainer.fit(state=device_copy(init))
    else:
        best, info = trainer.fit(state=device_copy(init), n_epochs=1)
    with pytest.MonkeyPatch.context() as mp:
        tests = recorded_test(trainer, best, mp, jax_metrics)
    return dict(family=family, steps=steps, init=init, info=info, best=host_copy(best),
                tests=tests)


def assert_state_close(state, want, skip=frozenset(), rtol=1e-3, atol=1e-5):
    params = keyed(want.params)
    for path, got in zip(paths(state.params), tree_leaves(state.params)):
        if path not in skip:
            close(got, params[path], rtol=rtol, atol=atol, msg=path)
    for bn in ("bn_ob", "bn_rel"):
        got_bn, want_bn = getattr(state.model_state, bn), keyed(getattr(want.model_state, bn))
        for path, got in zip(paths(got_bn), tree_leaves(got_bn)):
            close(got, want_bn[path], rtol=rtol, atol=atol, msg=f"{bn}{path}")


def recording(trainer, state, watch):
    """Wraps ``trainer.opt.step`` to record, per step, each watched
    parameter's largest gradient entry over the step's largest."""
    names, step, seen = paths(state.params), trainer.opt.step, []

    def recording_step(params, grads, opt_state):
        largest = max(g.abs().max().item() for g in grads if g is not None)
        seen.append({n: (0.0 if g is None else g.abs().max().item() / largest)
                     for n, g in zip(names, grads) if n in watch})
        step(params, grads, opt_state)

    trainer.opt.step = recording_step
    return seen


def port_step(trainer, state, i, family):
    if family == "regcn":
        return trainer.train_step(state, *trainer.window(i))
    return trainer.train_step(state, *trainer.window(i), trainer._curvature_max(0))


def test_epoch_0_steps_match_jax_train_step(data, jax_run):
    """Each of epoch 0's steps from JAX's state before it, the static
    graph in the loss: the losses, every parameter and BN statistic after."""
    family = jax_run["family"]
    trainer = port_trainer(data, family)
    assert trainer.static_snap is not None
    assert [i for i, *_ in jax_run["steps"]] == trainer.epoch_order(0)
    for i, before, want_losses, after in jax_run["steps"]:
        state = train_state_from_jax(before, device="cpu")
        held = set(SHIFT_INVARIANT)
        if family == "hyperbolic" and trainer.window(i)[0].src.shape[0] == 1:
            held |= RADIUS_MLP
        seen = recording(trainer, state, held)
        losses = port_step(trainer, state, i, family)
        assert want_losses["static"] > 0
        for k, w in want_losses.items():
            np.testing.assert_allclose(float(losses[k]), w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step on snapshot {i}: {k}")
        assert all(v <= 1e-6 for v in seen[0].values()), (i, seen)
        assert_state_close(state, after, skip=held)


def port_fit(data, family, state, epochs, **kw):
    trainer = port_trainer(data, family)
    if family == "regcn":
        trainer.cfg = dataclasses.replace(
            trainer.cfg, train=dataclasses.replace(trainer.cfg.train, n_epochs=epochs))
        return trainer.fit(state=state, **kw)
    return trainer.fit(state=state, n_epochs=epochs, **kw)


def test_fit_resumes_and_matches_jax(data, jax_run, tmp_path):
    """``fit`` for one epoch with a checkpoint against JAX's ``fit``; then a
    fresh trainer resumes it for a second epoch, which ends where 2 epochs
    in one ``fit`` end; the static graph's parameters are restored with
    their Adam moments."""
    family = jax_run["family"]
    path = str(tmp_path / "ckpt")
    first = train_state_from_jax(jax_run["init"], device="cpu")
    _, info1 = port_fit(data, family, first, 1, checkpoint_path=path)
    (got,), (want,) = info1["history"], jax_run["info"]["history"]
    assert got["epoch"] == want["epoch"] == 0
    assert abs(got["valid_mrr_raw"] - want["valid_mrr_raw"]) <= MRR_TOL
    assert got["losses"]["static"] > 0
    for k, w in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], w, rtol=RTOL, atol=ATOL, err_msg=k)

    template = train_state_from_jax(jax_run["init"], device="cpu", seed=7)
    restored, start, _, _ = pt_state.restore_for_resume(path, template)
    assert start == 1
    for a, b in zip(tree_leaves(first.params) + first.opt_state.mu + first.opt_state.nu,
                    tree_leaves(restored.params) + restored.opt_state.mu
                    + restored.opt_state.nu):
        assert torch.equal(a.detach(), b.detach())
    names = paths(restored.params)
    for key in ("['words_emb']", "['static_rgcn']['weight']"):
        assert restored.opt_state.nu[names.index(key)].abs().max() > 0, key
    _, resumed = port_fit(data, family, template, 2, checkpoint_path=path, resume=True)
    whole = train_state_from_jax(jax_run["init"], device="cpu")
    _, straight = port_fit(data, family, whole, 2)
    assert [r["epoch"] for r in resumed["history"]] == [1]
    assert abs(resumed["history"][0]["valid_mrr_raw"]
               - straight["history"][1]["valid_mrr_raw"]) <= 1e-6
    last, _ = pt_state.restore_checkpoint(os.path.join(path, "last"), template)
    assert last.step == whole.step == 2 * len(port_trainer(data, family).epoch_order(0))
    for a, b in zip(tree_leaves(whole.params), tree_leaves(last.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)


def test_rolling_test_ranks_match_jax(data, jax_run, monkeypatch):
    """The test split of JAX's best state through the port's trainer: the
    same ranks, snapshot by snapshot, and the same four MRRs."""
    trainer = port_trainer(data, jax_run["family"])
    want_stats, want_ranks = jax_run["tests"]
    got_stats, got_ranks = recorded_test(
        trainer, train_state_from_jax(jax_run["best"], device="cpu"), monkeypatch, pt_metrics)
    assert len(got_ranks) == len(want_ranks) == 4
    for key, got, want in zip(pt_loop.RANK_KEYS, got_ranks, want_ranks):
        assert len(got) == len(want) == len(trainer.test_list)
        for t, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{key}, test snapshot {t}")
        assert got_stats[key].mrr == want_stats[key].mrr
