"""The port's RE-GCN training path against regcn_tpu's, on converted weights.

Every dropout is 0 (JAX's and torch's random streams cannot match), and
every input comes from a numpy default_rng seed. Tolerances:

- train-mode decoders: scores, new BN statistics and decoder-parameter
  gradients (but those of SHIFT_INVARIANT biases, below, held to 0
  within 1e-6 of the largest gradient) within rtol 1e-5 and an atol of 1e-6 times the largest
  |JAX value| of the array (at least 1e-6): fp32, one conv and two GEMMs
  summed in another order leave errors of ~1e-6 of a row's largest
  entry, which a plain atol would miss on entries near 0;
- ``get_loss``: losses within rtol 1e-4 / atol 1e-5, gradients within
  rtol 1e-3 / atol 1e-5 (fp32 through the 2-layer evolution and the
  scatter's backward), BN statistics within rtol 1e-4 / atol 1e-5;
- a whole epoch against ``Trainer.run_epoch_fused``: every parameter and
  BN running statistic within atol 1e-5 + rtol 1e-3 and the mean losses
  within rtol 1e-4 / atol 1e-5. Adam divides each update by sqrt(v), so
  a gradient entry that is mostly rounding noise still moves its
  parameter by up to lr; the tolerance is far below lr = 1e-3, so each
  step's direction must agree. The exception is each decoder's
  ``conv_b`` and ``fc_b``: a batch-statistics BatchNorm follows each, and
  removes any per-channel shift, so their true gradient is 0 and Adam
  moves them by normalised rounding noise, by about lr per step in both
  packages (noise no two implementations share). Their values are not
  compared after an epoch; instead the port's gradient of each is held
  to 0 (within 1e-6 of the step's largest gradient) at every step, as in
  ``get_loss``'s test.

One module-scoped JAX run trains two epochs; the port starts from its
converted initial state and from its converted state after epoch 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.config import ExperimentConfig as JaxExperimentConfig
from regcn_tpu.config import ModelConfig as JaxModelConfig
from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.models import decoders as jax_decoders
from regcn_tpu.models import recurrent as jax_recurrent
from regcn_tpu.train import loop as jax_loop
from regcn_tpu.train.state import create_train_state as jax_create_train_state
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.convert import params_from_jax, train_state_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.models import decoders as pt_decoders
from regcn_torch.models import recurrent as pt_recurrent
from regcn_torch.train import loop as pt_loop
from regcn_torch.train.optim import tree_leaves

# 6 training snapshots: 5 steps per epoch, the windows of i = 1 and 2 short
TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
D = 16
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
TC = dict(train_history_len=3, test_history_len=3, edge_bucket=32, rc_bucket=64, triple_bucket=64)


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
    return generate("synthetic-small", seed=123, **TINY)


def configs(data, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=2,
                **NO_DROPOUT)
    base.update(kw)
    return (JaxExperimentConfig(model=JaxModelConfig(**base), train=JaxTrainConfig(**TC)),
            ExperimentConfig(model=ModelConfig(**base), train=TrainConfig(**TC)))


def host_copy(tree):
    """numpy copies: the fused epoch donates its input state's buffers."""
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def jax_run(data):
    """JAX: the initial state, then the state and mean losses after each of
    two fused epochs."""
    jcfg, _ = configs(data)
    trainer = jax_loop.Trainer(jcfg, data)
    state = jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
    states, losses = [host_copy(state)], []
    for epoch in range(2):
        state, mean = trainer.run_epoch_fused(state, epoch)
        states.append(host_copy(state))
        losses.append(mean)
    return states, losses


def paths(tree, prefix=""):
    """'/'-joined key paths of a nested dict/list, in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def by_path(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


# the biases that a batch-statistics BatchNorm follows: their true gradient is 0
SHIFT_INVARIANT = {f"{dec}/{b}" for dec in ("decoder_ob", "decoder_rel")
                   for b in ("conv_b", "fc_b")}


def assert_state_close(state, want, rtol=1e-3, atol=1e-5, skip=()):
    """Every parameter (but those in ``skip``) and BN running statistic of
    the port's ``state`` against a JAX TrainState with numpy leaves."""
    for path, got in zip(paths(state.params), tree_leaves(state.params)):
        if path in skip:
            continue
        np.testing.assert_allclose(got.detach().numpy(), by_path(want.params, path), rtol=rtol,
                                   atol=atol, err_msg=path)
    for bn in ("bn_ob", "bn_rel"):
        got_bn = getattr(state.model_state, bn)
        for path, got in zip(paths(got_bn), tree_leaves(got_bn)):
            np.testing.assert_allclose(got.numpy(), by_path(getattr(want.model_state, bn), path),
                                       rtol=rtol, atol=atol, err_msg=f"{bn}/{path}")


# ------------------------------------------------------------------ decoders

@pytest.mark.parametrize("which", ["convtranse", "convtransr"])
def test_train_mode_decoders_match_jax(data, which):
    """A half-padded bucket: the padded rows pass through the conv and the
    fc but enter neither the batch statistics nor, through G, the loss."""
    rng = np.random.default_rng(1)
    jcfg, _ = configs(data)
    params_np, state_np = host_copy(jax_recurrent.init_params(jax.random.PRNGKey(0),
                                                              jcfg.model))
    dec, bn = ("decoder_ob", "bn_ob") if which == "convtranse" else ("decoder_rel", "bn_rel")
    # running statistics away from their init, so the update is seen
    for st in getattr(state_np, bn).values():
        st["mean"] = rng.normal(size=st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 1.5, st["var"].shape).astype(np.float32)
    params, state = params_from_jax(params_np, state_np, device="cpu")
    real = pt_snapshots.split_by_time(data.train)[3]
    triples, mask = pt_snapshots.pad_triples(real, data.num_rels, 4 * len(real))
    assert mask.sum() * 2 == len(mask)
    emb = rng.normal(size=(data.num_nodes, D)).astype(np.float32)
    rel = rng.normal(size=(2 * data.num_rels, D)).astype(np.float32)
    n_cand = data.num_nodes if which == "convtranse" else 2 * data.num_rels
    G = (rng.normal(size=(len(triples), n_cand)) * mask[:, None]).astype(np.float32)

    def jax_fn(p):
        scores, new = getattr(jax_decoders, f"{which}_score")(
            p, getattr(state_np, bn), jnp.asarray(emb), jnp.asarray(rel), jnp.asarray(triples),
            jnp.asarray(mask), train=True)
        return jnp.sum(scores * G), (scores, new)

    want_grads, (want_scores, want_bn) = jax.jit(jax.grad(jax_fn, has_aux=True))(params_np[dec])
    leaves = tree_leaves(params[dec])
    for t in leaves:
        t.requires_grad_(True)
    scores, new_bn = getattr(pt_decoders, f"{which}_score")(
        params[dec], getattr(state, bn), torch.from_numpy(emb), torch.from_numpy(rel),
        torch.from_numpy(triples).long(), torch.from_numpy(mask), train=True)
    grads = torch.autograd.grad(torch.sum(scores * torch.from_numpy(G)), leaves)

    def close(got, want, name):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(want).max()), err_msg=name)

    close(scores.detach().numpy(), want_scores, "scores")
    for path, got in zip(paths(new_bn), tree_leaves(new_bn)):
        assert not got.requires_grad, path
        close(got.numpy(), by_path(want_bn, path), path)
    largest = max(g.abs().max().item() for g in grads)
    for path, got in zip(paths(params[dec]), grads):
        want = np.asarray(by_path(want_grads, path))
        if f"{dec}/{path}" in SHIFT_INVARIANT:  # rounding noise on both sides
            assert max(got.abs().max().item(), np.abs(want).max()) <= 1e-6 * largest, path
        else:
            close(got.numpy(), want, path)


# ------------------------------------------------------------------ get_loss

def test_get_loss_matches_jax(data, jax_run):
    """Losses, every parameter's gradient and the new BN state of one
    training window (3 snapshots; through rgcn_aggregate, so the scatter's
    backward on a real model too)."""
    jcfg, pcfg = configs(data)
    init = jax_run[0][0]
    state = train_state_from_jax(init, device="cpu")
    trainer = pt_loop.Trainer(pcfg, data, device="cpu")
    history, triples, mask = trainer.window(4)
    host = pt_snapshots.build_history(trainer.train_list[1:4], data.num_nodes, data.num_rels,
                                      edge_bucket=32, rc_bucket=64)
    jx_hist = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)

    def jax_fn(p):
        _, losses, new = jax_recurrent.get_loss(
            p, init.model_state, jcfg.model, jx_hist, jnp.asarray(triples.numpy()),
            jnp.asarray(mask.numpy()), train=True)
        return 0.7 * losses["entity"] + 0.3 * losses["relation"], (losses, new)

    want_grads, (want_losses, want_state) = jax.jit(jax.grad(jax_fn, has_aux=True))(init.params)
    loss_ent, losses, new_state = pt_recurrent.get_loss(
        state.params, state.model_state, pcfg.model, history, triples, mask, train=True)
    assert loss_ent is losses["entity"]
    for k in ("entity", "relation", "static"):
        np.testing.assert_allclose(losses[k].item(), float(want_losses[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    total = 0.7 * losses["entity"] + 0.3 * losses["relation"]
    grads = torch.autograd.grad(total, tree_leaves(state.params), allow_unused=True)
    largest = max(g.abs().max().item() for g in grads)
    for path, got in zip(paths(state.params), grads):
        assert got is not None, path
        np.testing.assert_allclose(got.numpy(), np.asarray(by_path(want_grads, path)),
                                   rtol=1e-3, atol=1e-5, err_msg=path)
        if path in SHIFT_INVARIANT:
            assert got.abs().max().item() <= 1e-6 * largest, path
    assert_state_close(dataclasses.replace(state, model_state=new_state),
                       dataclasses.replace(init, model_state=host_copy(want_state)),
                       rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------- epoch

@pytest.mark.parametrize("epoch", [0, 1])
def test_epoch_matches_jax_run_epoch_fused(data, jax_run, epoch):
    """Epoch 0 from the converted initial state; epoch 1 from the converted
    state after JAX's epoch 0 (Adam count 5, non-zero moments)."""
    states, losses = jax_run
    _, pcfg = configs(data)
    trainer = pt_loop.Trainer(pcfg, data, device="cpu")
    state = train_state_from_jax(states[epoch], device="cpu")
    assert state.opt_state.count == state.step == 5 * epoch
    # each step's gradients of the SHIFT_INVARIANT biases, against its largest
    names, step = paths(state.params), trainer.opt.step
    shift_grads = []

    def recording_step(params, grads, opt_state):
        largest = max(g.abs().max().item() for g in grads if g is not None)
        shift_grads.append({n: g.abs().max().item() / largest
                            for n, g in zip(names, grads) if n in SHIFT_INVARIANT})
        step(params, grads, opt_state)

    trainer.opt.step = recording_step
    got = trainer.run_epoch(state, epoch)
    assert state.step == state.opt_state.count == 5 * (epoch + 1)
    for k, want in losses[epoch].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
    assert len(shift_grads) == 5
    for i, rel in enumerate(shift_grads):
        assert all(v <= 1e-6 for v in rel.values()), (i, rel)
    assert_state_close(state, states[epoch + 1], skip=SHIFT_INVARIANT)


def test_epoch_order_matches_jax(data):
    """The order in which JAX's fused epoch takes the snapshots, read from
    the call of its epoch function, for epochs 0 to 3."""
    jcfg, pcfg = configs(data)
    trainer = jax_loop.Trainer(jcfg, data)
    trainer._ensure_store()
    seen = []

    def record(state, store, order):
        seen.append(np.asarray(order).tolist())
        zeros = np.zeros(len(seen[-1]), np.float32)
        return state, {"entity": zeros, "relation": zeros, "static": zeros}

    trainer._epoch_fn = record
    ours = pt_loop.Trainer(pcfg, data, device="cpu")
    for epoch in range(4):
        trainer.run_epoch_fused(None, epoch)
        assert ours.epoch_order(epoch) == seen[-1]
    assert sorted(seen[0]) == list(range(1, len(ours.train_list))) and seen[0] != seen[1]


def test_short_windows_run_as_they_are(data):
    _, pcfg = configs(data)
    trainer = pt_loop.Trainer(pcfg, data, device="cpu")
    assert [trainer.window(i)[0].src.shape[0] for i in (1, 2, 3, 5)] == [1, 2, 3, 3]
    assert trainer.window(1) is trainer.window(1)


# ---------------------------------------------------------- multi-step input

@pytest.mark.parametrize("which", ["construct_snap", "construct_snap_r"])
def test_construct_snap_matches_jax(which):
    rng = np.random.default_rng(2)
    num_rels, n = 5, 12
    triples = np.stack([rng.integers(0, 40, n), rng.integers(0, 2 * num_rels, n),
                        rng.integers(0, 40, n)], axis=1)
    scores = rng.normal(size=(n, 40 if which == "construct_snap" else 2 * num_rels))
    for topk in (1, 3):
        got = getattr(pt_loop, which)(triples, num_rels, scores, topk)
        want = getattr(jax_loop, which)(triples, num_rels, scores, topk)
        assert got.dtype == want.dtype and got.shape == (n * topk, 3)
        np.testing.assert_array_equal(got, want)
