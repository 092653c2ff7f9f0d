"""The port's RE-GCN trainer around the steps: fit, multi-step evaluation,
checkpoints and resume, dropout, and the options it does not run.

Against regcn_tpu, from the same converted initial state, dropouts 0
(one module-scoped JAX run: ``Trainer.fit`` for 2 epochs, then
``Trainer.test(multi_step=True)`` of its best state, entity and relation
feedback, with the rank arrays read where they are reduced):

- ``fit``: ``best_valid_mrr_raw`` and each history row's valid MRRs
  within 1e-4;
- multi-step test ranks equal to JAX's, rank for rank, and the same
  four MRRs.

Without a JAX counterpart to compare with, on the CPU: dropout's keep
rate within 4 sigma of binomial, its masks repeatable from a seed;
checkpoints restore every part of the state exactly; ``fit(resume=True)``
after 1 of 2 epochs ends where 2 epochs in one ``fit`` end, with dropout
on, to 1e-6.
"""

import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from regcn_tpu.config import ExperimentConfig as JaxExperimentConfig
from regcn_tpu.config import ModelConfig as JaxModelConfig
from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data import build_answer_filters_by_time as jax_answer_filters
from regcn_tpu.train import loop as jax_loop
from regcn_tpu.train import metrics as jax_metrics
from regcn_tpu.train.state import create_train_state as jax_create_train_state
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.convert import train_state_from_jax
from regcn_torch.data.answers import build_answer_filters_by_time
from regcn_torch.data.snapshots import split_by_time
from regcn_torch.data.synthetic import generate
from regcn_torch.ops.activations import inverted_dropout
from regcn_torch.train import loop as pt_loop
from regcn_torch.train import metrics as pt_metrics
from regcn_torch.train import state as pt_state
from regcn_torch.train.optim import tree_leaves
from regcn_torch.train.state import make_optimizer

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
TC = dict(n_epochs=2, train_history_len=3, test_history_len=3, edge_bucket=32, rc_bucket=64,
          triple_bucket=64)
MRR_TOL = 1e-4


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


def configs(data, model=None, **train):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=16, n_layers=2,
                **NO_DROPOUT)
    base.update(model or {})
    tc = dict(TC, **train)
    return (JaxExperimentConfig(model=JaxModelConfig(**base), train=JaxTrainConfig(**tc)),
            ExperimentConfig(model=ModelConfig(**base), train=TrainConfig(**tc)))


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
    """JAX: the initial state, fit's (best state, info), and the multi-step
    test of the best state with entity and with relation feedback."""
    jcfg, _ = configs(data)
    trainer = jax_loop.Trainer(jcfg, data)
    state = jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
    init = jax.tree.map(np.array, state)
    best, info = trainer.fit(state=state)
    with pytest.MonkeyPatch.context() as mp:
        tests = {rel: multi_step_ranks(trainer, best, mp, jax_metrics, rel)
                 for rel in (False, True)}
    return init, jax.tree.map(np.array, best), info, tests


def test_fit_matches_jax(data, jax_run):
    init, _, want, _ = jax_run
    _, pcfg = configs(data)
    trainer = pt_loop.Trainer(pcfg, data, device="cpu")
    _, got = trainer.fit(state=train_state_from_jax(init, device="cpu"))
    assert got["selection_metric"] == want["selection_metric"] == "ent_raw"
    assert abs(got["best_valid_mrr_raw"] - want["best_valid_mrr_raw"]) <= MRR_TOL
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"]
        for k in ("valid_mrr_raw", "valid_mrr_filter"):
            assert abs(g[k] - w[k]) <= MRR_TOL, (g["epoch"], k, g[k], w[k])
        for k in ("entity", "relation", "static"):
            np.testing.assert_allclose(g["losses"][k], w["losses"][k], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("relation_evaluation", [False, True], ids=["entity", "relation"])
def test_multi_step_test_matches_jax(data, jax_run, monkeypatch, relation_evaluation):
    """Top-k predictions fed back into the window: the same ranks as JAX,
    snapshot by snapshot, from JAX's best state."""
    _, best, _, tests = jax_run
    want_stats, want_ranks = tests[relation_evaluation]
    _, pcfg = configs(data)
    trainer = pt_loop.Trainer(pcfg, data, device="cpu")
    got_stats, got_ranks = multi_step_ranks(trainer, train_state_from_jax(best, device="cpu"),
                                            monkeypatch, pt_metrics, relation_evaluation)
    assert len(got_ranks) == len(want_ranks) == 4
    for key, got, want in zip(pt_loop.RANK_KEYS, got_ranks, want_ranks):
        assert len(got) == len(want) == len(trainer.test_list)
        for t, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{key}, test snapshot {t}")
        assert got_stats[key].mrr == want_stats[key].mrr


def test_multi_step_feedback_changes_the_window(data, jax_run):
    """From the second test snapshot on, the window holds predictions where
    single-step evaluation holds the real snapshots: the ranks differ."""
    _, best, _, _ = jax_run
    _, pcfg = configs(data)
    trainer = pt_loop.Trainer(pcfg, data, device="cpu")
    state = train_state_from_jax(best, device="cpu")
    single, multi = trainer.test(state), trainer.test(state, multi_step=True, topk=3)
    assert single["ent_raw"].count == multi["ent_raw"].count
    assert any(single[k].mrr != multi[k].mrr for k in pt_loop.RANK_KEYS)


def test_filtered_ranks_match_jax(data):
    rng = np.random.default_rng(3)
    snap = split_by_time(data.test)[0]
    queries, targets = snap[:, [0, 1]], snap[:, 2]
    scores = rng.normal(size=(len(snap), data.num_nodes))
    got = pt_metrics.filtered_ranks(scores, queries, targets,
                                    build_answer_filters_by_time(data.test, data.num_rels,
                                                                 False)[0])
    want = jax_metrics.filtered_ranks(scores, queries, targets,
                                      jax_answer_filters(data.test, data.num_rels, False)[0])
    np.testing.assert_array_equal(got, want)
    raw = pt_metrics.filtered_ranks(scores, queries, targets, None)
    np.testing.assert_array_equal(raw, pt_metrics.ranks_from_scores(scores, targets))
    assert (got <= raw).all() and (got < raw).any()


# ----------------------------------------------------------------- optimizer

def test_clip_uses_the_exact_global_norm():
    """At config 1's widths the clip factor is the float64 one (rtol 1e-6):
    an fp32 norm of millions of squares summed in turn loses digits, which
    moves every update whose gradient nearly cancels its weight decay."""
    rng = np.random.default_rng(4)
    shapes = [(7128, 200), (200, 10000), (460, 200)]
    grads = [rng.normal(size=s).astype(np.float32) * 1e-3 for s in shapes]
    params = [torch.zeros(s) for s in shapes]
    opt = make_optimizer(TrainConfig(weight_decay=0.0))
    state = opt.init(params)
    opt.step(params, [torch.from_numpy(g) for g in grads], state)
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads))
    assert norm > 1.0  # the clip is on
    for mu, g in zip(state.mu, grads):
        np.testing.assert_allclose(mu.numpy(), 0.1 * g.astype(np.float64) / norm, rtol=1e-6,
                                   atol=0)


# ------------------------------------------------------------------- dropout

def test_dropout_keep_rate_and_scale():
    p, n = 0.2, 200_000
    x = torch.ones(n)
    out = inverted_dropout(x, p, torch.Generator().manual_seed(0), train=True)
    kept = int((out != 0).sum())
    sigma = np.sqrt(n * p * (1 - p))
    assert abs(kept - n * (1 - p)) <= 4 * sigma
    assert torch.equal(out[out != 0], torch.full((kept,), 1 / (1 - p)))


def test_dropout_masks_repeat_from_a_seed_and_eval_ignores_the_generator():
    x = torch.randn(64, 8, generator=torch.Generator().manual_seed(1))
    a = inverted_dropout(x, 0.3, torch.Generator().manual_seed(5), train=True)
    b = inverted_dropout(x, 0.3, torch.Generator().manual_seed(5), train=True)
    c = inverted_dropout(x, 0.3, torch.Generator().manual_seed(6), train=True)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    for train, rate in ((False, 0.3), (True, 0.0)):
        assert inverted_dropout(x, rate, gen, train=train) is x
    assert torch.equal(gen.get_state(), before)


# --------------------------------------------------------------- checkpoints

def trained_state(data, steps=2, **model):
    """A port state after ``steps`` steps with the config's dropouts."""
    _, pcfg = configs(data, model=model or dict(dropout=0.2, input_dropout=0.2,
                                                hidden_dropout=0.2, feat_dropout=0.2))
    trainer = pt_loop.Trainer(pcfg, data, device="cpu")
    state = trainer.init_state()
    for i in trainer.epoch_order(0)[:steps]:
        trainer.train_step(state, *trainer.window(i))
    return trainer, state


def assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a.params) + a.opt_state.mu + a.opt_state.nu,
                    tree_leaves(b.params) + b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x.detach(), y.detach())
    for bn in ("bn_ob", "bn_rel"):
        for x, y in zip(tree_leaves(getattr(a.model_state, bn)),
                        tree_leaves(getattr(b.model_state, bn))):
            assert torch.equal(x, y)
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert (a.step, a.opt_state.count) == (b.step, b.opt_state.count)


def test_checkpoint_round_trip(data, tmp_path):
    trainer, state = trained_state(data)
    pt_state.save_checkpoint(str(tmp_path), state, {"epoch": 3, "mrr": 0.25})
    assert sorted(os.listdir(tmp_path)) == ["meta.json", "state.pt"]
    restored, meta = pt_state.restore_checkpoint(str(tmp_path), trainer.init_state(seed=9))
    assert meta == {"epoch": 3, "mrr": 0.25}
    assert state.step == 2 and state.opt_state.count == 2
    assert_states_equal(restored, state)
    assert all(t.requires_grad and t.is_leaf for t in tree_leaves(restored.params))
    # the restored state trains on exactly as the original does
    i = trainer.epoch_order(1)[0]
    for s in (state, restored):
        trainer.train_step(s, *trainer.window(i))
    assert_states_equal(restored, state)


def test_restore_refuses_another_model(data, tmp_path):
    _, state = trained_state(data, steps=0)
    pt_state.save_checkpoint(str(tmp_path), state)
    _, pcfg = configs(data, model=dict(h_dim=8))
    other = pt_loop.Trainer(pcfg, data, device="cpu").init_state()
    with pytest.raises(ValueError, match="other shapes"):
        pt_state.restore_checkpoint(str(tmp_path), other)


def test_restore_for_resume_prefers_last(data, tmp_path):
    trainer, state = trained_state(data, steps=1)
    best = pt_state.copy_state(state)
    trainer.train_step(state, *trainer.window(2))
    path = str(tmp_path)
    assert not pt_state.has_resumable_checkpoint(path)
    pt_state.save_checkpoint(path, best, {"epoch": 0, "mrr": 0.5})
    pt_state.save_last_checkpoint(path, state, epoch=1, best_mrr=0.5, best_epoch=0)
    assert pt_state.has_resumable_checkpoint(path)
    got, start, best_mrr, best_epoch = pt_state.restore_for_resume(path, trainer.init_state())
    assert (start, best_mrr, best_epoch) == (2, 0.5, 0) and got.step == 2
    assert_states_equal(got, state)
    # without a complete last/ the root's best state is the resume point
    os.remove(os.path.join(path, "last", "meta.json"))
    got, start, best_mrr, best_epoch = pt_state.restore_for_resume(path, trainer.init_state())
    assert (start, best_mrr, best_epoch) == (1, 0.5, 0) and got.step == 1
    assert_states_equal(got, best)


def test_meta_json_is_written_after_the_state(data, tmp_path, monkeypatch):
    _, state = trained_state(data, steps=0)
    save, events = torch.save, []

    def spy_save(obj, f):
        events.append(("state written", sorted(os.listdir(tmp_path))))
        save(obj, f)

    monkeypatch.setattr(pt_state.torch, "save", spy_save)
    pt_state.save_checkpoint(str(tmp_path), state, {"epoch": 0})
    assert events == [("state written", [])]
    assert sorted(os.listdir(tmp_path)) == ["meta.json", "state.pt"]
    with open(tmp_path / "meta.json") as f:
        assert json.load(f) == {"epoch": 0}


def test_fit_resumes_where_it_stopped(data, tmp_path):
    """2 epochs in one fit, against 1 epoch, then fit(resume=True) to 2,
    with every dropout at the config's 0.2: the last checkpoints and the
    best MRRs agree to 1e-6."""
    drop = dict(dropout=0.2, input_dropout=0.2, hidden_dropout=0.2, feat_dropout=0.2)
    runs = {}
    for name, epochs in (("whole", (2,)), ("resumed", (1, 2))):
        path = str(tmp_path / name)
        for n_epochs in epochs:
            _, pcfg = configs(data, model=drop, n_epochs=n_epochs)
            trainer = pt_loop.Trainer(pcfg, data, device="cpu")
            _, info = trainer.fit(checkpoint_path=path, resume=True)
        runs[name] = (pt_state.restore_checkpoint(os.path.join(path, "last"),
                                                  trainer.init_state())[0], info)
    (whole, whole_info), (resumed, resumed_info) = runs["whole"], runs["resumed"]
    assert whole.step == resumed.step == 2 * (len(trainer.train_list) - 1)
    assert [r["epoch"] for r in resumed_info["history"]] == [1]
    assert abs(whole_info["best_valid_mrr_raw"] - resumed_info["best_valid_mrr_raw"]) <= 1e-6
    assert abs(whole_info["history"][1]["valid_mrr_raw"]
               - resumed_info["history"][0]["valid_mrr_raw"]) <= 1e-6
    for a, b in zip(tree_leaves(whole.params) + whole.opt_state.mu + whole.opt_state.nu,
                    tree_leaves(resumed.params) + resumed.opt_state.mu + resumed.opt_state.nu):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=0, atol=1e-6)
    assert torch.equal(whole.gen.get_state(), resumed.gen.get_state())


# ------------------------------------------------------------- not ported yet

@pytest.mark.parametrize("unported", ["mesh", "halo", "run_analysis", "dilate_len", "use_static"])
def test_unported_options_raise(data, jax_run, unported):
    """A mesh and the halo, refused until they were ported, are checked as
    JAX checks them: a mesh whose ``graph`` axis does not divide the
    entities raises JAX's divisibility error, and ``dist_agg="halo"``
    without a mesh raises (``tests/test_torch_sharded_train.py`` runs
    both on gloo ranks). ``run_analysis``, the
    static graph and ``dilate_len > 1``, refused until they were ported,
    now run and match JAX: with ``dilate_len=2`` the dilated training list
    array for array and a training step on its window 2 (every parameter
    but the ConvTrans decoders' ``conv_b`` and ``fc_b``, whose true
    gradient is 0 under the batch-statistics BatchNorm after each, so that
    Adam moves them by rounding noise), the analysis record of JAX's initial state (the
    global gradient norm, each named parameter norm the two records share,
    within rtol 1e-5, and the entity norms), and a training step with the
    static graph from the same state (the losses within rtol 1e-4 / atol
    1e-5, the parameters within atol 1e-5 + rtol 1e-3)."""
    init = jax_run[0]
    if unported == "run_analysis":
        jcfg, pcfg = configs(data)
        want = jax_loop.Trainer(jcfg, data, run_analysis=True).analysis_record(
            jax.tree.map(jax.numpy.asarray, init))
        got = pt_loop.Trainer(pcfg, data, run_analysis=True, device="cpu").analysis_record(
            train_state_from_jax(init, device="cpu"))
        assert len(got) == len(want) == 14
        shared = (set(got) & set(want)) - {"global_norm"}
        assert len(shared) >= 11
        for k in shared | {"global_norm"}:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
        return
    if unported == "dilate_len":
        jcfg, pcfg = configs(data, dilate_len=2)
        jtrainer = jax_loop.Trainer(jcfg, data)
        trainer = pt_loop.Trainer(pcfg, data, device="cpu")
        assert len(trainer.train_list) == len(jtrainer.train_list) == -(
            -len(split_by_time(data.train)) // 2)
        for g, w in zip(trainer.train_list, jtrainer.train_list):
            np.testing.assert_array_equal(g, w)
        state = train_state_from_jax(init, device="cpu")
        i = 2
        jstate, want = jtrainer.train_step(jax.tree.map(jax.numpy.asarray, init),
                                           jtrainer._history(jtrainer.train_list[0:i]),
                                           *jtrainer._triples(i))
        got = trainer.train_step(state, *trainer.window(i))
        for k in ("entity", "relation"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-5)
        want_params = jax.tree.map(np.asarray, jstate.params)
        for path, leaf in zip(paths(state.params), tree_leaves(state.params)):
            if path[-1] not in ("conv_b", "fc_b"):
                np.testing.assert_allclose(leaf.detach().numpy(), by_path(want_params, path),
                                           rtol=1e-3, atol=1e-5, err_msg=path)
        return
    if unported == "use_static":
        rng = np.random.default_rng(4)
        ents = np.arange(data.num_nodes)
        st = np.stack([ents, rng.integers(0, 2, len(ents)),
                       rng.integers(0, 12, len(ents)) + data.num_nodes], axis=1)
        sdata = dataclasses.replace(data, static_triples=st, num_static_rels=2, num_words=12)
        jcfg, pcfg = configs(sdata, model=dict(use_static=True, num_static_rels=2,
                                               num_words=12, n_bases=8))
        jtrainer = jax_loop.Trainer(jcfg, sdata)
        jstate = jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
        state = train_state_from_jax(jax.tree.map(np.array, jstate), device="cpu")
        i = 3
        history = jtrainer._history(jtrainer.train_list[0:i])
        triples, mask = jtrainer._triples(i)
        jstate, want = jtrainer.train_step(jstate, history, triples, mask)
        trainer = pt_loop.Trainer(pcfg, sdata, device="cpu")
        got = trainer.train_step(state, *trainer.window(i))
        assert float(want["static"]) > 0
        for k in ("entity", "relation", "static"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-5)
        want_params = jax.tree.map(np.asarray, jstate.params)
        for path, leaf in zip(paths(state.params), tree_leaves(state.params)):
            np.testing.assert_allclose(leaf.detach().numpy(), by_path(want_params, path),
                                       rtol=1e-3, atol=1e-5, err_msg=path)
        return
    _, pcfg = configs(data)
    if unported == "mesh":
        mesh = types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 3))
        assert data.num_nodes % 3
        with pytest.raises(ValueError, match="not divisible by the 'graph' mesh axis"):
            pt_loop.Trainer(pcfg, data, device="cpu", mesh=mesh)
    else:
        with pytest.raises(ValueError, match="requires a mesh"):
            pt_loop.Trainer(pcfg, data, device="cpu", dist_agg="halo")


def paths(tree, prefix=()):
    """Key paths of a nested dict/list, in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, prefix + (i,))]
    return [prefix]


def by_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree
