"""The port's HisResTrainer against regcn_tpu's.

One module-scoped JAX run, dropouts 0 (``cand_dropout`` too), from
``init_state(PRNGKey(0))``: epoch 0 step by step (the windows shorter than
the history through ``train_step``, the others through the fused
``epoch_fn`` one snapshot at a time: the state before and after each
step), epoch 1 through ``run_epoch``, ``fit`` for 2 epochs from the state
after epoch 0, the test split (fused) and its multi-step test from fit's
best state, the rank arrays read where they are reduced, and
``analysis_record``. The port starts from the converted JAX states
(``train_state_from_jax``). One recurrent layer and a history of 2 keep
JAX's compiles short; ``tests/test_torch_hisres.py`` holds two layers and
three-snapshot windows. Tolerances:

- a step, or an epoch: the (mean) losses within rtol 1e-4 / atol 1e-5;
  after a step, Adam's mu and sqrt(nu) within 1e-4 of each leaf's largest entry plus
  1e-7 (a BatchNorm scale or bias sums a term of every row, and mu is
  a tenth of a gradient); every
  parameter and BN running statistic within atol 1e-5 + rtol 1e-3. Adam
  divides each update by sqrt(v), so a gradient entry that is rounding
  noise (below 1e-4 of its leaf's largest: a ConvTrans channel that the
  relu shuts for nearly every query, at these tiny widths) moves its
  parameter by up to lr = 1e-3 on either side; the moments hold such an
  entry, its value is not compared. Each ConvTrans decoder's ``conv_b``
  and ``fc_b`` have a true gradient of 0 (a batch-statistics BatchNorm
  follows each), so their values are not compared, and the port's
  gradient of each is held to 1e-6 of the step's largest. The running
  means of the BatchNorms that follow them (bn1, bn2) take in that noise
  at every step, so after a whole epoch they are held within atol 1e-4;
- ``fit``, also resumed from its checkpoint: the best and each epoch's
  valid MRR within 1e-4, the best state as an epoch's state;
- the test split, single- and multi-step: the same ranks as JAX's,
  snapshot by snapshot; ``analysis_record`` within rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.hisres import model as JM
from regcn_tpu.hisres.train import HisResTrainer as JaxTrainer
from regcn_tpu.train import metrics as jax_metrics
from regcn_torch.config import TrainConfig
from regcn_torch.convert import _adam_states, train_state_from_jax
from regcn_torch.data.synthetic import generate
from regcn_torch.hisres import model as PM
from regcn_torch.hisres import train as pt_train
from regcn_torch.hisres.train import HisResTrainer, union_snapshots
from regcn_torch.train import loop as pt_loop
from regcn_torch.train import metrics as pt_metrics
from regcn_torch.train import state as pt_state
from regcn_torch.train.optim import tree_leaves

# 8 training snapshots: 7 steps per epoch, the window of i = 1 short
TINY = dict(num_ents=50, num_rels=4, num_snaps=12, triples_per_snap=30, split=(8, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0,
                  cand_dropout=0.0)
TC = dict(n_epochs=2, lr=1e-3, train_history_len=2, test_history_len=2, edge_bucket=32,
          rc_bucket=32, triple_bucket=32)
HIS_EDGE_BUCKET = 64
STEPS = 7
MRR_TOL = 1e-4
EPOCH_SHIFTED_MEAN_ATOL = 1e-4
SHIFT_INVARIANT = {f"['{dec}']['{b}']" for dec in ("decoder_ob_raw", "decoder_ob_inv",
                                                  "decoder_rel_raw", "decoder_rel_his")
                   for b in ("conv_b", "fc_b")}
BN_FIELDS = ("bn_ob_raw", "bn_ob_inv", "bn_rel_raw", "bn_rel_his", "bn_cand_raw", "bn_cand_inv")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=31, **TINY)


def configs(data):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=8, n_layers=1,
                **NO_DROPOUT)
    return (JM.HisResConfig(**base), JaxTrainConfig(**TC), PM.HisResConfig(**base),
            TrainConfig(**TC))


def trainer_of(data, **kw):
    _, _, pcfg, ptc = configs(data)
    return HisResTrainer(pcfg, ptc, data, his_edge_bucket=HIS_EDGE_BUCKET, device="cpu", **kw)


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


def recorded_test(trainer, state, monkeypatch, module, **kw):
    """(stats, the four rank-array lists) of ``trainer.test(state, **kw)``."""
    recorder = RankRecorder(module.stat_ranks)
    with monkeypatch.context() as m:
        m.setattr(module, "stat_ranks", recorder)
        stats = trainer.test(state, **kw)
    return stats, recorder.seen


@pytest.fixture(scope="module")
def jax_run(data):
    jcfg, jtc, _, _ = configs(data)
    trainer = JaxTrainer(jcfg, jtc, data, his_edge_bucket=HIS_EDGE_BUCKET)
    init = host_copy(trainer.init_state(jax.random.PRNGKey(0)))
    trainer._build_train_stores()
    state, steps = device_copy(init), []
    hlen = jtc.train_history_len
    for i in trainer_of(data).epoch_order(0):
        before = host_copy(state)
        if i < hlen:
            window = trainer.train_list[max(0, i - hlen):i]
            state, losses = trainer.train_step(
                state, trainer._history(window), trainer._history(union_snapshots(window)),
                *trainer._batch(trainer.train_list[i], i))
        else:
            state, stacked = trainer.epoch_fn(state, trainer._g_store, trainer._gg_store,
                                              trainer._his_store, jnp.asarray([i], jnp.int32))
            losses = jax.tree.map(lambda a: a[0], stacked)
        steps.append((i, before, jax.tree.map(float, losses), host_copy(state)))
    after0 = host_copy(state)
    state, mean1 = trainer.run_epoch(device_copy(after0), 1)
    after1 = host_copy(state)
    best, info = trainer.fit(state=device_copy(after0))
    with pytest.MonkeyPatch.context() as mp:
        tests = {multi: recorded_test(trainer, best, mp, jax_metrics, multi_step=multi, topk=3)
                 for multi in (False, True)}
    analysis = trainer.analysis_record(device_copy(after0))
    return dict(steps=steps, after0=after0, after1=after1, mean1=mean1, info=info,
                best=host_copy(best), tests=tests, analysis=analysis)


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}[{i}]")]
    return [prefix]


def keyed(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def adam_moments(jax_state):
    """JAX's Adam ``mu`` and ``nu`` by key path."""
    (_, adam), = _adam_states(jax_state.opt_state)
    return keyed(adam.mu), keyed(adam.nu)


def assert_state_close(state, want, rtol=1e-3, atol=1e-5, skip=SHIFT_INVARIANT,
                       shifted_mean_atol=1e-5, moments=True):
    """Every parameter and its Adam moments but those in ``skip``, and every
    BN running statistic, of the port's ``state`` against a JAX state (numpy
    leaves). The moments hold each gradient entry, within 1e-4 of its
    leaf's largest plus 1e-7; a parameter entry whose gradients so far are below
    1e-4 of its leaf's largest (sqrt(nu)) is rounding noise on both sides,
    which Adam's division by sqrt(nu) blows up to as much as lr, so its
    value is not compared. ``shifted_mean_atol``: the running means of the
    decoders' bn1 and bn2, which take in conv_b and fc_b at every step.
    Without ``moments`` (whole epochs, where those noise entries feed every
    later step), each entry of every parameter is compared and no moment."""
    params = keyed(want.params)
    mu, nu = adam_moments(want)
    names = paths(state.params)
    assert set(names) == set(params)
    for path, got, g_mu, g_nu in zip(names, tree_leaves(state.params), state.opt_state.mu,
                                     state.opt_state.nu):
        if path in skip:
            continue
        for name, a, b in () if not moments else (("mu", g_mu.numpy(), mu[path]),
                           ("sqrt(nu)", np.sqrt(g_nu.numpy()), np.sqrt(nu[path]))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max() + 1e-7,
                                       err_msg=f"{name}{path}")
        signal = (np.sqrt(nu[path]) >= 1e-4 * np.sqrt(nu[path]).max() if moments
                  else np.ones(nu[path].shape, bool))
        np.testing.assert_allclose(got.detach().numpy()[signal], params[path][signal], rtol=rtol,
                                   atol=atol, err_msg=path)
    for bn in BN_FIELDS:
        got_bn, want_bn = getattr(state.model_state, bn), keyed(getattr(want.model_state, bn))
        assert set(paths(got_bn)) == set(want_bn)
        for path, got in zip(paths(got_bn), tree_leaves(got_bn)):
            shifted = bn.startswith("bn_ob") or bn.startswith("bn_rel")
            shifted = shifted and path in ("['bn1']['mean']", "['bn2']['mean']")
            np.testing.assert_allclose(got.numpy(), want_bn[path], rtol=rtol,
                                       atol=shifted_mean_atol if shifted else atol,
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


def test_epoch_order_runs_short_windows_first(data):
    trainer = trainer_of(data)
    order = trainer.epoch_order(0)
    hlen = trainer.tc.train_history_len
    assert sorted(order) == list(range(1, len(trainer.train_list)))
    assert [i for i in order if i < hlen] == order[:hlen - 1]


def test_epoch_0_steps_match_jax_train_step(data, jax_run):
    """Each of epoch 0's steps from JAX's state before it: the losses,
    every parameter and BN statistic after it."""
    trainer = trainer_of(data)
    steps = jax_run["steps"]
    assert len(steps) == STEPS
    for i, before, want_losses, after in steps:
        state = train_state_from_jax(before, device="cpu")
        seen = recording(trainer, state, SHIFT_INVARIANT)
        losses = trainer.train_step(state, *trainer.window(i))
        for k in pt_train.LOSS_KEYS:
            np.testing.assert_allclose(float(losses[k]), want_losses[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step on snapshot {i}: {k}")
        assert len(seen[0]) == 8 and all(v <= 1e-6 for v in seen[0].values()), (i, seen)
        assert_state_close(state, after)


def test_epoch_1_matches_jax_run_epoch(data, jax_run):
    """The whole of epoch 1 from the converted state after JAX's epoch 0
    against JAX's fused ``run_epoch``."""
    trainer = trainer_of(data)
    state = train_state_from_jax(jax_run["after0"], device="cpu")
    assert state.opt_state.count == state.step == STEPS
    got = trainer.run_epoch(state, 1)
    assert state.step == state.opt_state.count == 2 * STEPS
    for k, want in jax_run["mean1"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
    assert got["entity"] > 0 and got["relation"] > 0
    assert_state_close(state, jax_run["after1"], shifted_mean_atol=EPOCH_SHIFTED_MEAN_ATOL,
                       moments=False)


def assert_fit_close(got, want, best, want_best):
    assert got["selection_metric"] == want["selection_metric"] == "ent_raw"
    assert abs(got["best_valid_mrr_raw"] - want["best_valid_mrr_raw"]) <= MRR_TOL
    assert_state_close(best, want_best, shifted_mean_atol=EPOCH_SHIFTED_MEAN_ATOL,
                       moments=False)


def test_fit_matches_jax_and_resumes_from_its_checkpoint(data, jax_run, tmp_path):
    """``fit`` of 2 epochs from the state after epoch 0 against JAX's; then
    the same for one epoch with a checkpoint, resumed by a fresh trainer
    for the second: the same best MRR and best state, the resumed epoch
    alone in its history."""
    best, got = trainer_of(data).fit(state=train_state_from_jax(jax_run["after0"], device="cpu"))
    assert [r["epoch"] for r in got["history"]] == [0, 1]
    assert_fit_close(got, jax_run["info"], best, jax_run["best"])

    path = str(tmp_path / "ckpt")
    one = trainer_of(data)
    one.tc = dataclasses.replace(one.tc, n_epochs=1)
    _, first = one.fit(state=train_state_from_jax(jax_run["after0"], device="cpu"),
                       checkpoint_path=path)
    assert [r["epoch"] for r in first["history"]] == [0]
    for sub in ("", "last"):
        for f in (pt_state.STATE_FILE, pt_state.META_FILE):
            assert (tmp_path / "ckpt" / sub / f).exists(), (sub, f)
    template = train_state_from_jax(jax_run["steps"][0][1], device="cpu", seed=7)
    restored, start, _, best_epoch = pt_state.restore_for_resume(path, template)
    assert (start, best_epoch, restored.step) == (1, 0, 2 * STEPS)
    assert isinstance(restored.model_state, PM.HisResState)
    assert len(restored.model_state.bn_cand_raw) == 1
    best, got = trainer_of(data).fit(state=template, checkpoint_path=path, resume=True)
    assert [r["epoch"] for r in got["history"]] == [1]
    assert_fit_close(got, jax_run["info"], best, jax_run["best"])


@pytest.mark.parametrize("multi_step", [False, True], ids=["single", "multi"])
def test_test_ranks_match_jax(data, jax_run, monkeypatch, multi_step):
    """The test split's ranks over the 2B stacked queries, raw and
    filtered, snapshot by snapshot, from fit's best state; multi-step with
    the vocabularies frozen at the split's start and the top-3 entity
    predictions fed back."""
    want_stats, want_ranks = jax_run["tests"][multi_step]
    trainer = trainer_of(data)
    got_stats, got_ranks = recorded_test(
        trainer, train_state_from_jax(jax_run["best"], device="cpu"), monkeypatch, pt_metrics,
        multi_step=multi_step, topk=3)
    assert len(got_ranks) == len(want_ranks) == 4
    for key, got, want in zip(pt_loop.RANK_KEYS, got_ranks, want_ranks):
        assert len(got) == len(want) == len(trainer.test_list)
        for t, (g, w) in enumerate(zip(got, want)):
            assert len(g) == 2 * len(trainer.test_list[t])
            np.testing.assert_array_equal(g, w, err_msg=f"{key}, test snapshot {t}")
        assert got_stats[key].mrr == want_stats[key].mrr


def test_analysis_record_matches_jax(data, jax_run):
    """``analysis_record`` of the state after epoch 0: the global and the 10
    largest gradient norms by name, and the entity norms."""
    want = jax_run["analysis"]
    got = trainer_of(data, run_analysis=True).analysis_record(
        train_state_from_jax(jax_run["after0"], device="cpu"))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_unported_options_raise(data):
    """A mesh, refused until HisRES was ported to one
    (``tests/test_torch_sharded_hisres.py``), now refuses only what it does
    not run yet, naming its ROADMAP item (here ``run_analysis``); the halo
    without a mesh raises JAX's error."""
    import types

    _, _, pcfg, ptc = configs(data)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 2))
    with pytest.raises(NotImplementedError, match="A.11b"):
        HisResTrainer(pcfg, ptc, data, device="cpu", mesh=mesh, run_analysis=True)
    with pytest.raises(ValueError, match="requires a mesh"):
        HisResTrainer(pcfg, ptc, data, device="cpu", dist_agg="halo")
