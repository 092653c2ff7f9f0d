"""The port's hyperbolic trainer against regcn_tpu's HyperbolicTrainer.

Both trainers start from JAX's init_state(PRNGKey(0)) (converted with
hyperbolic_params_from_jax) and take 3 optimizer steps on the same
training windows with dropout 0, learned curvature and its warmup bound.
Losses agree within rtol 1e-4 / atol 1e-5 (fp32, sums in another order).
After the steps every parameter agrees within atol 1e-5 + rtol 1e-3:
Adam divides each update by sqrt(v), so a gradient entry that is mostly
rounding noise still moves its parameter by up to lr; the tolerance is
far below lr = 1e-3, so each step's direction must agree.

The optimizer itself is held to optax's chain to fp32 rounding (rtol and
atol 1e-6: the bias corrections are computed in another precision), on
the two points where torch's own tools differ from it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic.optim import dual_optimizer as jax_dual_optimizer
from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxTrainer
from regcn_torch.config import TrainConfig
from regcn_torch.convert import hyperbolic_params_from_jax
from regcn_torch.data.snapshots import split_by_time
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic.train import HyperbolicTrainer
from regcn_torch.train.optim import EuclideanAdam, tree_leaves

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
STEPS = 3


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=123, **TINY)


def configs(data, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=8, n_layers=2,
                encoder="lgcn", decoder="roth", n_bases=4, dropout=0.0, input_dropout=0.0,
                hidden_dropout=0.0, feat_dropout=0.0, learn_curvature=True)
    base.update(kw)
    tc = dict(lr=1e-3, train_history_len=2, test_history_len=2, edge_bucket=32, rc_bucket=64,
              triple_bucket=64)
    return (JM.HyperbolicConfig(**base), JaxTrainConfig(**tc), PM.HyperbolicConfig(**base),
            TrainConfig(**tc))


@pytest.fixture(scope="module")
def jax_run(data):
    """JAX: the initial parameters, then per step the losses and parameters."""
    jcfg, jtc, _, _ = configs(data)
    trainer = JaxTrainer(jcfg, jtc, data, curvature_warmup_epochs=5)
    state = trainer.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, (state.params, state.model_state))
    cmax = jnp.asarray(trainer._curvature_max(0), jnp.float32)
    order = [2, 1, 4]  # windows of 2, 1 (short) and 2 snapshots
    steps = []
    for i in order:
        lo = max(0, i - jtc.train_history_len)
        history = trainer._history(trainer.train_list[lo:i])
        from regcn_tpu.data.snapshots import pad_triples

        triples, mask = pad_triples(trainer.train_list[i], data.num_rels, jtc.triple_bucket)
        state, losses = trainer.train_step(state, history, jnp.asarray(triples),
                                           jnp.asarray(mask), cmax)
        steps.append((jax.tree.map(float, losses), jax.tree.map(np.asarray, state.params)))
    return init, order, steps


def test_three_steps_match_jax(data, jax_run):
    (params_np, state_np), order, steps = jax_run
    _, _, pcfg, ptc = configs(data)
    trainer = HyperbolicTrainer(pcfg, ptc, data, curvature_warmup_epochs=5, device="cpu")
    state = trainer.state_from(*hyperbolic_params_from_jax(params_np, state_np, device="cpu"))
    cmax = trainer._curvature_max(0)
    assert cmax == pytest.approx(0.01 + 0.09 / 5)
    for i, (want_losses, want_params) in zip(order, steps):
        losses = trainer.train_step(state, *trainer.window(i), cmax)
        for k in ("entity", "relation", "static", "radius"):
            np.testing.assert_allclose(float(losses[k]), want_losses[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step on snapshot {i}: {k}")
        want = jax.tree_util.tree_flatten_with_path(want_params)[0]
        got = [t.detach().numpy() for t in tree_leaves(state.params)]
        assert len(got) == len(want)
        for (path, w), g in zip(sorted(want, key=lambda kv: _order(kv[0], state.params)), got):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5,
                                       err_msg=f"after snapshot {i}: {jax.tree_util.keystr(path)}")
    assert state.step == STEPS and state.opt_state.count == STEPS


def _order(path, params):
    """Position of a JAX key path among the port's tree_leaves order."""
    keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
    return _paths(params).index("/".join(keys))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def test_epoch_order_and_windows_match_jax(data):
    """One step per training snapshot in JAX's shuffled order; windows of
    up to train_history_len snapshots before it."""
    import random

    _, _, pcfg, ptc = configs(data)
    trainer = HyperbolicTrainer(pcfg, ptc, data, device="cpu")
    for epoch in (0, 3):
        want = list(range(1, len(trainer.train_list)))
        random.Random(ptc.seed + epoch).shuffle(want)
        assert trainer.epoch_order(epoch) == want
    history, triples, mask = trainer.window(1)
    assert history.src.shape[0] == 1 and triples.shape[0] == mask.shape[0]
    assert trainer.window(4)[0].src.shape[0] == ptc.train_history_len


def test_run_epoch_reports_mean_losses(data):
    _, _, pcfg, ptc = configs(data)
    trainer = HyperbolicTrainer(pcfg, ptc, data, device="cpu")
    state = trainer.init_state()
    losses = trainer.run_epoch(state, 0)
    assert state.step == len(trainer.train_list) - 1
    assert all(np.isfinite(v) for v in losses.values()) and losses["entity"] > 0


@pytest.mark.parametrize("unported", ["triple_batch_size", "dilate_len", "manifold_entities"])
def test_unported_options_raise(data, unported):
    """``dilate_len > 1``, once refused, is now read as JAX's trainer reads
    it, not at all: the training list equals JAX's, undilated. Triple batching (chunks
    of 16 rows, mode ``accumulate``) and entities on the ball with
    Riemannian Adam, refused until they were ported, now run: epoch 1 of
    each from JAX's state after epoch 0 (Adam moments that damp the
    rounding noise of near-zero gradients) matches JAX's ``run_epoch``,
    the mean losses within rtol 1e-4 / atol 1e-5 and every parameter
    within atol 1e-5 + rtol 1e-3."""
    _, _, pcfg, ptc = configs(data)
    if unported == "dilate_len":
        jcfg, jtc, pcfg, ptc = configs(data)
        got = HyperbolicTrainer(pcfg, dataclasses.replace(ptc, dilate_len=2), data, device="cpu")
        want = JaxTrainer(jcfg, dataclasses.replace(jtc, dilate_len=2), data)
        assert len(got.train_list) == len(want.train_list) == len(split_by_time(data.train))
        for g, w in zip(got.train_list, want.train_list):
            np.testing.assert_array_equal(g, w)
        return
    from regcn_torch.convert import train_state_from_jax

    cfg_kw = {"manifold_entities": True} if unported == "manifold_entities" else {}
    kw = {"triple_batch_size": 16} if unported == "triple_batch_size" else {}
    jcfg, jtc, pcfg, ptc = configs(data, **cfg_kw)
    fused = JaxTrainer(jcfg, jtc, data, curvature_warmup_epochs=5)
    after0, _ = fused.run_epoch(fused.init_state(jax.random.PRNGKey(0)), 0)
    after0 = jax.tree.map(np.array, after0)
    jax_trainer = JaxTrainer(jcfg, jtc, data, curvature_warmup_epochs=5, **kw) if kw else fused
    want_state, want_losses = jax_trainer.run_epoch(jax.tree.map(jnp.asarray, after0), 1)
    trainer = HyperbolicTrainer(pcfg, ptc, data, curvature_warmup_epochs=5, device="cpu", **kw)
    state = train_state_from_jax(after0, device="cpu")
    got = trainer.run_epoch(state, 1)
    assert state.step == int(want_state.step) == 2 * (len(trainer.train_list) - 1)
    for k, w in want_losses.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want_state.params))[0]
    for (path, w), g in zip(sorted(want, key=lambda kv: _order(kv[0], state.params)),
                            tree_leaves(state.params)):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-3, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def optax_steps(params, grads_per_step, lr, grad_norm, wd):
    opt = jax_dual_optimizer(lr, 0.01, grad_norm, wd)
    params = [jnp.asarray(p) for p in params]
    opt_state = opt.init(params)
    for grads in grads_per_step:
        updates, opt_state = opt.update([jnp.asarray(g) for g in grads], opt_state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params]


@pytest.mark.parametrize("norm", ["below_limit", "above_limit"])
def test_optimizer_equals_optax_chain(rng, norm):
    """clip_by_global_norm has no +1e-6 in its divisor (torch's
    clip_grad_norm_ has), and clips only from the limit on."""
    shapes = [(5, 3), (4,), ()]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    scale = 0.01 if norm == "below_limit" else 10.0
    grads = [[rng.normal(size=s).astype(np.float32) * scale for s in shapes] for _ in range(3)]
    want = optax_steps(params, grads, 1e-2, 1.0, 1e-2)
    opt = EuclideanAdam(1e-2, 1.0, 1e-2)
    tp = [torch.tensor(p) for p in params]
    st = opt.init(tp)
    for gs in grads:
        opt.step(tp, [torch.tensor(g) for g in gs], st)
    for g, w in zip(tp, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    # a tiny global norm: torch's +1e-6 would change the clipped gradient
    tiny = [[np.full(s, 1e-7, np.float32) for s in shapes]]
    big = optax_steps(params, tiny, 1e-2, 1e-9, 0.0)
    tp = [torch.tensor(p) for p in params]
    opt0 = EuclideanAdam(1e-2, 1e-9, 0.0)
    opt0.step(tp, [torch.tensor(g) for g in tiny[0]], opt0.init(tp))
    for g, w in zip(tp, big):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_optimizer_decays_and_steps_a_leaf_without_gradient(rng):
    """optax treats every leaf alike: a parameter that got no gradient is
    still weight-decayed and moved by Adam; torch.optim.Adam would skip it."""
    params = [rng.normal(size=(3,)).astype(np.float32), rng.normal(size=(2,)).astype(np.float32)]
    grads = [rng.normal(size=(3,)).astype(np.float32), np.zeros(2, np.float32)]
    want = optax_steps(params, [grads], 1e-2, 1.0, 1e-1)
    opt = EuclideanAdam(1e-2, 1.0, 1e-1)
    tp = [torch.tensor(p) for p in params]
    opt.step(tp, [torch.tensor(grads[0]), None], opt.init(tp))
    np.testing.assert_allclose(tp[1].numpy(), want[1], rtol=1e-6, atol=1e-6)
    assert not np.allclose(tp[1].numpy(), params[1])
    np.testing.assert_allclose(tp[0].numpy(), want[0], rtol=1e-6, atol=1e-6)
