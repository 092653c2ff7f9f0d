"""The port's HyperbolicTrainer on the hyperbolic headline (uvrgcn +
tangent ConvTransE/R, fixed c) against regcn_tpu's HyperbolicTrainer.

One module-scoped JAX run, dropouts 0, from ``init_state(PRNGKey(0))``:
epochs 0 and 1 through ``run_epoch``, then epoch 0 again step by step
through the same fused epoch, ``epoch_fn`` on one snapshot a call (the
state before and after each step; the fused store front-pads the short
windows with empty snapshots, and JAX holds that path to its per-step
``train_step``, ``tests/test_hyperbolic_model.py:273``): one compiled
step for every window length, where ``train_step`` compiles one each;
``fit`` for 2 epochs from the state after epoch 0; ``test(multi_step=
True)`` of fit's best state with entity and with relation feedback, the
rank arrays read where they are reduced. The port starts from the
converted JAX states (``train_state_from_jax``).
Tolerances:

- a step, or an epoch: the (mean) losses within rtol 1e-4 / atol 1e-5;
  every parameter and BN running statistic within atol 1e-5 + rtol 1e-3.
  Adam divides each update by sqrt(v), so a gradient entry that is mostly
  rounding noise still moves its parameter by up to lr; the tolerance is
  far below lr = 1e-3, so each step's direction must agree;
- parameters whose true gradient is 0: each ConvTrans decoder's
  ``conv_b`` and ``fc_b`` at every step (a batch-statistics BatchNorm
  follows each), and ``radius_mlp_w`` / ``radius_mlp_b`` on a window of
  one snapshot (the radius they set is erased by the layer norm before
  the decoders, and no later step of the window feels it). Both packages
  move them by rounding noise, by up to lr on Adam's first step, so
  their values are not compared where that noise entered them, and the
  port's gradient of each is held to 1e-6 of the step's largest there.
  The first step of epoch 0 is on a one-snapshot window, so epoch 0 is
  compared step by step from JAX's state before each step, and whole
  epochs start from the state after epoch 0, whose Adam moments damp
  that noise;
- ``fit``, also resumed from its checkpoint after the first epoch: the
  best and each epoch's valid MRR within 1e-4, the best state as an
  epoch's state;
- multi-step test: the same ranks as JAX's, snapshot by snapshot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxTrainer
from regcn_tpu.train import metrics as jax_metrics
from regcn_torch.config import TrainConfig
from regcn_torch.convert import train_state_from_jax
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic.train import HyperbolicTrainer
from regcn_torch.train import loop as pt_loop
from regcn_torch.train import metrics as pt_metrics
from regcn_torch.train import state as pt_state
from regcn_torch.train.optim import tree_leaves

# 6 training snapshots: 5 steps per epoch, the windows of i = 1 and 2 short
TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
TC = dict(n_epochs=2, lr=1e-3, train_history_len=3, test_history_len=3, edge_bucket=32,
          rc_bucket=64, triple_bucket=64)
STEPS = 5
MRR_TOL = 1e-4
SHIFT_INVARIANT = {f"['{dec}']['{b}']" for dec in ("decoder_ob", "decoder_rel")
                   for b in ("conv_b", "fc_b")}
RADIUS_MLP = {"['radius_mlp_w']", "['radius_mlp_b']"}


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


def configs(data):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=8, n_layers=2,
                encoder="hyperbolic_uvrgcn", decoder="hyperbolic_convtranse", c=0.01,
                **NO_DROPOUT)
    return (JM.HyperbolicConfig(**base), JaxTrainConfig(**TC), PM.HyperbolicConfig(**base),
            TrainConfig(**TC))


def trainer_of(data):
    _, _, pcfg, ptc = configs(data)
    return HyperbolicTrainer(pcfg, ptc, data, device="cpu")


def host_copy(tree):
    """numpy copies: JAX's epoch donates its input state's buffers."""
    return jax.tree.map(lambda a: np.array(a), tree)


class RankRecorder:
    """Stands in for a metrics module's ``stat_ranks`` and keeps the rank
    arrays it is given."""

    def __init__(self, stat_ranks):
        self.stat_ranks, self.seen = stat_ranks, []

    def __call__(self, rank_arrays, *a, **kw):
        self.seen.append([np.asarray(r) for r in rank_arrays])
        return self.stat_ranks(rank_arrays, *a, **kw)


def multi_step_ranks(trainer, state, monkeypatch, module, relation_evaluation):
    """(stats, the four rank-array lists) of ``trainer.test(multi_step=True)``."""
    recorder = RankRecorder(module.stat_ranks)
    with monkeypatch.context() as m:
        m.setattr(module, "stat_ranks", recorder)
        stats = trainer.test(state, multi_step=True, topk=3,
                             relation_evaluation=relation_evaluation)
    return stats, recorder.seen


@pytest.fixture(scope="module")
def jax_run(data):
    """JAX: epoch 0 step by step (window index, state before, losses,
    state after), the states after the fused epochs 0 and 1 and epoch 1's
    mean losses, fit's info and best state, the multi-step tests."""
    jcfg, jtc, _, _ = configs(data)
    trainer = JaxTrainer(jcfg, jtc, data)
    init = host_copy(trainer.init_state(jax.random.PRNGKey(0)))
    state, _ = trainer.run_epoch(device_copy(init), 0)
    after0 = host_copy(state)
    state, mean1 = trainer.run_epoch(state, 1)
    after1 = host_copy(state)
    steps = fused_steps(trainer, init, trainer_of(data).epoch_order(0))
    best, info = trainer.fit(state=device_copy(after0))
    with pytest.MonkeyPatch.context() as mp:
        tests = {rel: multi_step_ranks(trainer, best, mp, jax_metrics, rel)
                 for rel in (False, True)}
    return dict(steps=steps, after0=after0, after1=after1, mean1=mean1, info=info,
                best=host_copy(best), tests=tests)


def device_copy(tree):
    return jax.tree.map(jnp.asarray, tree)


def fused_stores(trainer):
    """The stores of JAX's fused epoch, as its ``run_epoch`` builds them
    before its first fused epoch (``regcn_tpu/hyperbolic/train.py:607-624``)."""
    from regcn_tpu.train.epoch import build_snapshot_store

    tc, hlen = trainer.tc, trainer.tc.train_history_len
    trainer._store = build_snapshot_store(
        trainer.train_list, trainer.num_nodes, trainer.num_rels, edge_bucket=tc.edge_bucket,
        rc_bucket=tc.rc_bucket, triple_bucket=tc.triple_bucket, pad_front=hlen,
        halo_shards=trainer._halo_shards())
    triples_all = np.asarray(trainer._store.triples[hlen:])
    masks_all = np.asarray(trainer._store.triple_mask[hlen:])
    trainer._train_est_store = trainer._build_est_store(
        triples_all, masks_all, times=list(range(len(triples_all))), with_tans=True)


def fused_steps(trainer, init, order):
    """JAX's epoch 0 one step a call through its fused epoch (``epoch_fn``
    on the order [i], over the stores ``run_epoch`` builds): (window index,
    state before, losses, state after) of each step."""
    if trainer._store is None:
        fused_stores(trainer)
    cmax = jnp.asarray(trainer._curvature_max(0), jnp.float32)
    state, steps = device_copy(init), []
    for i in order:
        before = host_copy(state)
        state, losses = trainer.epoch_fn(state, trainer._store, trainer._train_est_store,
                                         jnp.asarray([i], jnp.int32), cmax)
        steps.append((i, before, {k: float(v[0]) for k, v in losses.items()},
                      host_copy(state)))
    return steps


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


def assert_state_close(state, want, rtol=1e-3, atol=1e-5, skip=SHIFT_INVARIANT):
    """Every parameter but those in ``skip``, and every BN running
    statistic, of the port's ``state`` against a JAX state with numpy
    leaves."""
    params = keyed(want.params)
    for path, got in zip(paths(state.params), tree_leaves(state.params)):
        if path not in skip:
            np.testing.assert_allclose(got.detach().numpy(), params[path], rtol=rtol, atol=atol,
                                       err_msg=path)
    for bn in ("bn_ob", "bn_rel"):
        got_bn, want_bn = getattr(state.model_state, bn), keyed(getattr(want.model_state, bn))
        assert len(want_bn) == 6  # bn0, bn1, bn2: mean and var
        for path, got in zip(paths(got_bn), tree_leaves(got_bn)):
            np.testing.assert_allclose(got.numpy(), want_bn[path], rtol=rtol, atol=atol,
                                       err_msg=f"{bn}{path}")


def recording(trainer, state, watch):
    """Wraps ``trainer.opt.step`` to record, per step, each watched
    parameter's largest gradient entry over the step's largest."""
    names, step, seen = paths(state.params), trainer.opt.step, []

    def recording_step(params, grads, opt_state):
        largest = max(g.abs().max().item() for g in grads if g is not None)
        seen.append({n: g.abs().max().item() / largest for n, g in zip(names, grads)
                     if n in watch})
        step(params, grads, opt_state)

    trainer.opt.step = recording_step
    return seen


def test_epoch_0_steps_match_jax_train_step(data, jax_run):
    """Each of epoch 0's steps from JAX's state before it: the losses,
    every parameter and BN statistic after it; on the one-snapshot window
    radius_mlp's gradient is held to 0 instead of comparing its values."""
    trainer = trainer_of(data)
    steps = jax_run["steps"]
    assert [i for i, *_ in steps] == trainer.epoch_order(0)
    assert sum(trainer.window(i)[0].src.shape[0] == 1 for i, *_ in steps) == 1
    for i, before, want_losses, after in steps:
        state = train_state_from_jax(before, device="cpu")
        held = SHIFT_INVARIANT | (RADIUS_MLP if trainer.window(i)[0].src.shape[0] == 1 else set())
        seen = recording(trainer, state, held)
        losses = trainer.train_step(state, *trainer.window(i), trainer._curvature_max(0))
        for k in ("entity", "relation", "static", "radius"):
            np.testing.assert_allclose(float(losses[k]), want_losses[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step on snapshot {i}: {k}")
        assert len(seen[0]) == len(held) and all(v <= 1e-6 for v in seen[0].values()), (i, seen)
        assert_state_close(state, after, skip=held)


def test_epoch_1_matches_jax_run_epoch(data, jax_run):
    """The whole of epoch 1 from the converted state after JAX's epoch 0
    (Adam count 5, moved BN statistics) against ``run_epoch``."""
    trainer = trainer_of(data)
    state = train_state_from_jax(jax_run["after0"], device="cpu")
    assert state.opt_state.count == state.step == STEPS
    seen = recording(trainer, state, SHIFT_INVARIANT)
    got = trainer.run_epoch(state, 1)
    assert state.step == state.opt_state.count == 2 * STEPS
    for k, want in jax_run["mean1"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
    assert got["entity"] > 0 and got["relation"] > 0 and got["radius"] > 0
    assert len(seen) == STEPS
    for i, rel in enumerate(seen):
        assert len(rel) == 4 and all(v <= 1e-6 for v in rel.values()), (i, rel)
    assert_state_close(state, jax_run["after1"])


def assert_fit_close(got, want, best, want_best):
    assert got["selection_metric"] == want["selection_metric"] == "ent_raw"
    assert abs(got["best_valid_mrr_raw"] - want["best_valid_mrr_raw"]) <= MRR_TOL
    assert len(got["history"]) <= len(want["history"]) == 2
    rows = {r["epoch"]: r for r in want["history"]}
    for g in got["history"]:
        w = rows[g["epoch"]]
        assert abs(g["valid_mrr_raw"] - w["valid_mrr_raw"]) <= MRR_TOL, (g["epoch"], g, w)
        for k in ("entity", "relation", "static", "radius"):
            np.testing.assert_allclose(g["losses"][k], w["losses"][k], rtol=1e-4, atol=1e-5)
    assert_state_close(best, want_best)


def test_fit_matches_jax(data, jax_run):
    best, got = trainer_of(data).fit(state=train_state_from_jax(jax_run["after0"], device="cpu"))
    assert len(got["history"]) == 2
    assert_fit_close(got, jax_run["info"], best, jax_run["best"])


def test_fit_resumes_from_its_checkpoint(data, jax_run, tmp_path):
    """``fit`` for one epoch with a checkpoint, then a fresh trainer resumes
    it for the second: the same epochs, MRRs and best state as JAX's fit
    of 2 epochs at once, the resumed state on the trainer's device."""
    path = str(tmp_path / "ckpt")
    _, first = trainer_of(data).fit(state=train_state_from_jax(jax_run["after0"], device="cpu"),
                                    n_epochs=1, checkpoint_path=path)
    assert [r["epoch"] for r in first["history"]] == [0]
    for sub in ("", "last"):
        for f in (pt_state.STATE_FILE, pt_state.META_FILE):
            assert (tmp_path / "ckpt" / sub / f).exists(), (sub, f)
    trainer = trainer_of(data)
    # a template of the checkpoint's tree: JAX's initial state, converted
    template = train_state_from_jax(jax_run["steps"][0][1], device="cpu", seed=7)
    restored, start, best_mrr, best_epoch = pt_state.restore_for_resume(path, template)
    assert (start, best_epoch, restored.step) == (1, 0, 2 * STEPS)
    assert all(t.device == trainer.device for t in tree_leaves(restored.model_state.bn_ob))
    best, got = trainer.fit(state=template, checkpoint_path=path, resume=True)
    assert [r["epoch"] for r in got["history"]] == [1]
    assert_fit_close(got, jax_run["info"], best, jax_run["best"])


@pytest.mark.parametrize("relation_evaluation", [False, True], ids=["entity", "relation"])
def test_multi_step_test_matches_jax(data, jax_run, monkeypatch, relation_evaluation):
    """Top-k predictions fed back into the window: the same ranks as JAX,
    snapshot by snapshot, from JAX's best state."""
    best, tests = jax_run["best"], jax_run["tests"]
    want_stats, want_ranks = tests[relation_evaluation]
    trainer = trainer_of(data)
    got_stats, got_ranks = multi_step_ranks(trainer, train_state_from_jax(best, device="cpu"),
                                            monkeypatch, pt_metrics, relation_evaluation)
    assert len(got_ranks) == len(want_ranks) == 4
    for key, got, want in zip(pt_loop.RANK_KEYS, got_ranks, want_ranks):
        assert len(got) == len(want) == len(trainer.test_list)
        for t, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{key}, test snapshot {t}")
        assert got_stats[key].mrr == want_stats[key].mrr
