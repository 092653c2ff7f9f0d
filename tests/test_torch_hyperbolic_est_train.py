"""The port's HyperbolicTrainer on BASELINE config 5 (the headline, uvrgcn
+ tangent ConvTransE/R, with EST: H-PES memories, ETNR retrieval, the
QCHHE GRU; and TANS negatives) against regcn_tpu's HyperbolicTrainer.

One module-scoped JAX run, dropouts 0, K = 8 events, from
``init_state(PRNGKey(0))``: epoch 0 and epoch 1 through ``run_epoch``,
JAX's fused epoch on its precomputed ``ESTStore``; epoch 0 again step by
step through that fused epoch, one snapshot a call (the state before and
after each step, the H-PES memories included; JAX holds the fused epoch
on its ``ESTStore`` to ``train_step`` with the retrieval batch at the
snapshot's time and the TANS COO, ``tests/test_hyperbolic_model.py:314``;
``fused_steps`` of ``tests/test_torch_hyperbolic_headline_train.py``);
``fit`` for 2 epochs from the state after
epoch 0; the valid and test splits of fit's best state, single-step
(JAX's fused eval on its ``ESTStore``) and multi-step, the rank arrays
read where they are reduced. The port starts from the converted JAX
states (``train_state_from_jax``). Tolerances:

- a step, or an epoch: the (mean) losses within rtol 1e-4 / atol 1e-5;
  every parameter, BN running statistic and H-PES memory within atol 1e-5
  + rtol 1e-3. Adam divides each update by sqrt(v), so a gradient entry
  that is mostly rounding noise still moves its parameter by up to lr;
  the tolerance is far below lr = 1e-3, so each step's direction must
  agree;
- parameters whose true gradient is 0: each ConvTrans decoder's
  ``conv_b`` and ``fc_b`` (a batch-statistics BatchNorm follows each) and
  the QCHHE attention's ``attn_proj_b`` (it shifts every event's logit of
  a row alike, and a softmax follows) at every step, and ``radius_mlp_w``
  / ``radius_mlp_b`` on a window of one snapshot. Both packages move them
  by rounding noise, by up to lr on Adam's first step, so their values are
  not compared where that noise entered them, and the port's gradient of
  each is held to 1e-6 of the step's largest there;
- the eval ranks, single- and multi-step, at their time offsets: equal to
  JAX's, snapshot by snapshot;
- ``fit``, also resumed from its checkpoint after the first epoch: the
  best and each epoch's valid MRR within 1e-4, the best state as an
  epoch's state, but for the running means of the BatchNorms that follow
  ``conv_b`` and ``fc_b`` (each decoder's ``bn1`` and ``bn2``): they take
  the noise of those biases, which over fit's 10 steps moves them by up to
  ~1e-4 (their variances are compared).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hyperbolic_headline_train import fused_steps

from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data.answers import build_answer_filters_by_time as jax_filters
from regcn_tpu.data.snapshots import pad_triples
from regcn_tpu.hyperbolic import est as JE
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxTrainer
from regcn_tpu.train import metrics as jax_metrics
from regcn_torch.config import TrainConfig
from regcn_torch.convert import train_state_from_jax
from regcn_torch.data.answers import build_answer_filters_by_time
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
EST = dict(use_est=True, use_time_aware_negative=True, est_encoder="gru", est_history_len=8,
           est_state_alpha=0.2)
TC = dict(n_epochs=2, lr=1e-3, train_history_len=3, test_history_len=3, edge_bucket=32,
          rc_bucket=64, triple_bucket=64)
STEPS = 5
MRR_TOL = 1e-4
HELD = {f"['{dec}']['{b}']" for dec in ("decoder_ob", "decoder_rel")
        for b in ("conv_b", "fc_b")} | {"['est']['attn_proj_b']"}
RADIUS_MLP = {"['radius_mlp_w']", "['radius_mlp_b']"}
# the BN running means after conv_b and fc_b, which take their noise
HELD_BN = {f"{dec}['{bn}']['mean']" for dec in ("bn_ob", "bn_rel") for bn in ("bn1", "bn2")}


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
                **NO_DROPOUT, **EST)
    return (JM.HyperbolicConfig(**base), JaxTrainConfig(**TC), PM.HyperbolicConfig(**base),
            TrainConfig(**TC))


def trainer_of(data):
    _, _, pcfg, ptc = configs(data)
    return HyperbolicTrainer(pcfg, ptc, data, device="cpu")


def host_copy(tree):
    """numpy copies: JAX's epoch donates its input state's buffers."""
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


def recorded_ranks(evaluate, monkeypatch, module):
    """(stats, the four rank-array lists) of ``evaluate()``."""
    recorder = RankRecorder(module.stat_ranks)
    with monkeypatch.context() as m:
        m.setattr(module, "stat_ranks", recorder)
        stats = evaluate()
    return stats, recorder.seen


EVALS = ("valid", "test", "test_multi_step")


def run_eval(trainer, state, name, filters):
    """One of ``EVALS``: the valid split at ``len(train)``, as ``fit`` runs
    it, or the test split, single- or multi-step."""
    if name == "valid":
        return trainer.evaluate(state, trainer.train_list, trainer.valid_list, *filters,
                                time_offset=len(trainer.train_list))
    return trainer.test(state, multi_step=name == "test_multi_step", topk=3)


@pytest.fixture(scope="module")
def jax_run(data):
    """JAX: epoch 0 step by step (window index, state before, losses,
    state after), the states after the fused epochs 0 and 1 and epoch 1's
    mean losses, fit's info and best state, the evaluations of it."""
    jcfg, jtc, _, _ = configs(data)
    trainer = JaxTrainer(jcfg, jtc, data)
    init = host_copy(trainer.init_state(jax.random.PRNGKey(0)))
    state, _ = trainer.run_epoch(device_copy(init), 0)
    after0 = host_copy(state)
    state, mean1 = trainer.run_epoch(state, 1)
    after1 = host_copy(state)
    steps = fused_steps(trainer, init, trainer_of(data).epoch_order(0))
    best, info = trainer.fit(state=device_copy(after0))
    filters = (jax_filters(data.valid, data.num_rels, False),
               jax_filters(data.valid, data.num_rels, True))
    with pytest.MonkeyPatch.context() as mp:
        evals = {name: recorded_ranks(lambda: run_eval(trainer, best, name, filters), mp,
                                      jax_metrics) for name in EVALS}
    return dict(steps=steps, after0=after0, after1=after1, mean1=mean1, info=info,
                best=host_copy(best), evals=evals)


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


def assert_state_close(state, want, rtol=1e-3, atol=1e-5, skip=HELD, skip_bn=()):
    """Every parameter but those in ``skip``, every BN running statistic but
    those in ``skip_bn`` and both H-PES memories of the port's ``state``
    against a JAX state with numpy leaves."""
    params = keyed(want.params)
    assert len(params) == len(tree_leaves(state.params))
    for path, got in zip(paths(state.params), tree_leaves(state.params)):
        if path not in skip:
            np.testing.assert_allclose(got.detach().numpy(), params[path], rtol=rtol, atol=atol,
                                       err_msg=path)
    for bn in ("bn_ob", "bn_rel"):
        got_bn, want_bn = getattr(state.model_state, bn), keyed(getattr(want.model_state, bn))
        for path, got in zip(paths(got_bn), tree_leaves(got_bn)):
            if bn + path not in skip_bn:
                np.testing.assert_allclose(got.numpy(), want_bn[path], rtol=rtol, atol=atol,
                                           err_msg=f"{bn}{path}")
    for memory in ("fast", "slow"):
        np.testing.assert_allclose(getattr(state.est_state, memory).numpy(),
                                   getattr(want.est_state, memory), rtol=rtol, atol=atol,
                                   err_msg=memory)


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


def test_epoch_0_steps_match_jax_train_step(data, jax_run):
    """Each of epoch 0's steps from JAX's state before it, with its
    retrieval batch and TANS COO: the losses, every parameter, BN statistic
    and H-PES memory after it."""
    trainer = trainer_of(data)
    steps = jax_run["steps"]
    assert [i for i, *_ in steps] == trainer.epoch_order(0)
    assert sum(trainer.window(i)[0].src.shape[0] == 1 for i, *_ in steps) == 1
    for i, before, want_losses, after in steps:
        state = train_state_from_jax(before, device="cpu")
        if i == steps[0][0]:
            assert float(state.est_state.slow.abs().max()) == 0  # zero memories at init
        rb, tans = trainer.est_window(i)
        assert rb is not None and tans is not None
        assert float(rb.event_mask.sum()) > 0 and int((tans[0] < rb.row_mask.numel()).sum()) > 0
        held = HELD | (RADIUS_MLP if trainer.window(i)[0].src.shape[0] == 1 else set())
        seen = recording(trainer, state, held)
        losses = trainer.train_step(state, *trainer.window(i), trainer._curvature_max(0), rb,
                                    tans)
        for k in ("entity", "relation", "static", "radius"):
            np.testing.assert_allclose(float(losses[k]), want_losses[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step on snapshot {i}: {k}")
        assert len(seen[0]) == len(held) and all(v <= 1e-6 for v in seen[0].values()), (i, seen)
        assert_state_close(state, after, skip=held)
        assert float(state.est_state.slow.abs().max()) > 0


def test_fused_epoch_matches_jax_run_epoch(data, jax_run):
    """The whole of epoch 1 from the converted state after JAX's epoch 0
    against ``run_epoch``, whose fused scan reads the retrieval batches
    and TANS masks from its precomputed ESTStore."""
    trainer = trainer_of(data)
    state = train_state_from_jax(jax_run["after0"], device="cpu")
    assert state.opt_state.count == state.step == STEPS
    seen = recording(trainer, state, HELD)
    got = trainer.run_epoch(state, 1)
    assert state.step == state.opt_state.count == 2 * STEPS
    for k, want in jax_run["mean1"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
    assert len(seen) == STEPS
    for i, rel in enumerate(seen):
        assert len(rel) == len(HELD) and all(v <= 1e-6 for v in rel.values()), (i, rel)
    assert_state_close(state, jax_run["after1"])


@pytest.mark.parametrize("name", EVALS)
def test_eval_ranks_at_their_time_offset_match_jax(data, jax_run, monkeypatch, name):
    """The valid split at ``len(train)`` and the test split at
    ``len(train) + len(valid)``, single-step (JAX's fused eval) and
    multi-step: the same ranks as JAX's, snapshot by snapshot, from JAX's
    best state."""
    want_stats, want_ranks = jax_run["evals"][name]
    trainer = trainer_of(data)
    filters = (build_answer_filters_by_time(data.valid, data.num_rels, False),
               build_answer_filters_by_time(data.valid, data.num_rels, True))
    state = train_state_from_jax(jax_run["best"], device="cpu")
    got_stats, got_ranks = recorded_ranks(lambda: run_eval(trainer, state, name, filters),
                                          monkeypatch, pt_metrics)
    n_eval = len(trainer.valid_list if name == "valid" else trainer.test_list)
    assert len(got_ranks) == len(want_ranks) == 4
    for key, got, want in zip(pt_loop.RANK_KEYS, got_ranks, want_ranks):
        assert len(got) == len(want) == n_eval
        for t, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {key}, snapshot {t}")
        assert got_stats[key].mrr == want_stats[key].mrr


def test_eval_retrieves_at_the_time_offset(data, jax_run):
    """The valid split's first snapshot retrieves the events before
    ``len(train)``: the latest training events of each head, none of them
    at time 0 only."""
    trainer = trainer_of(data)
    inputs = trainer._eval_inputs(train_state_from_jax(jax_run["best"], device="cpu"),
                                  len(trainer.train_list))
    triples, mask = pad_triples(trainer.valid_list[0], data.num_rels, TC["triple_bucket"])
    rb = inputs(0, triples, mask)["est_inputs"][1]
    gaps = rb.deltas[rb.event_mask > 0]
    assert gaps.numel() > 0 and float(gaps.min()) >= 1
    assert float(gaps.max()) <= len(trainer.train_list)


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
    assert_state_close(best, want_best, skip_bn=HELD_BN)


def test_fit_matches_jax(data, jax_run):
    best, got = trainer_of(data).fit(state=train_state_from_jax(jax_run["after0"], device="cpu"))
    assert len(got["history"]) == 2
    assert_fit_close(got, jax_run["info"], best, jax_run["best"])


def test_fit_resumes_from_its_checkpoint(data, jax_run, tmp_path):
    """``fit`` for one epoch with a checkpoint, then a fresh trainer resumes
    it for the second: the H-PES memories come back with the rest, and the
    epochs, MRRs and best state are JAX's fit of 2 epochs at once."""
    path = str(tmp_path / "ckpt")
    trainer = trainer_of(data)
    first_best, first = trainer.fit(state=train_state_from_jax(jax_run["after0"], device="cpu"),
                                    n_epochs=1, checkpoint_path=path)
    assert [r["epoch"] for r in first["history"]] == [0]
    template = train_state_from_jax(jax_run["steps"][0][1], device="cpu", seed=7)
    restored, start, _, best_epoch = pt_state.restore_for_resume(path, template)
    assert (start, best_epoch, restored.step) == (1, 0, 2 * STEPS)
    for memory in ("fast", "slow"):
        assert torch.equal(getattr(restored.est_state, memory),
                           getattr(first_best.est_state, memory))
    best, got = trainer_of(data).fit(state=template, checkpoint_path=path, resume=True)
    assert [r["epoch"] for r in got["history"]] == [1]
    assert_fit_close(got, jax_run["info"], best, jax_run["best"])


def test_best_state_keeps_its_own_memories(data, jax_run):
    """``copy_state`` copies the H-PES memories: a step on the live state
    leaves the copy's as they were."""
    trainer = trainer_of(data)
    state = train_state_from_jax(jax_run["after0"], device="cpu")
    kept = pt_state.copy_state(state)
    i = trainer.epoch_order(1)[0]
    trainer.train_step(state, *trainer.window(i), trainer._curvature_max(1), *trainer.est_window(i))
    for memory in ("fast", "slow"):
        assert not torch.equal(getattr(state.est_state, memory), getattr(kept.est_state, memory))
        np.testing.assert_array_equal(getattr(kept.est_state, memory).numpy(),
                                      getattr(jax_run["after0"].est_state, memory))
    assert dataclasses.is_dataclass(kept.est_state)


def test_get_loss_and_predict_match_jax(data, jax_run):
    """The model's entry points with EST and TANS from the state after one
    step (non-zero memories): ``get_loss``'s losses, every gradient (held
    to rtol 1e-4 and atol 1e-5 * max(1, max|JAX gradient|) of each array)
    and the fused context rows of its ``aux``; ``predict``'s scores."""
    jcfg, jtc, pcfg, _ = configs(data)
    jtrainer, trainer = JaxTrainer(jcfg, jtc, data), trainer_of(data)
    after = jax_run["steps"][0][3]
    i = trainer.epoch_order(1)[0]
    lo = max(0, i - jtc.train_history_len)
    history = jtrainer._history(jtrainer.train_list[lo:i])
    triples, mask = pad_triples(jtrainer.train_list[i], data.num_rels, jtc.triple_bucket)
    rb = jtrainer._retrieval(triples, mask, i)
    tans = tuple(map(jnp.asarray, JE.tans_mask_coo(triples, mask, jtrainer.true_tails)))
    params, ms, est_state = (device_copy(x) for x in (after.params, after.model_state,
                                                     after.est_state))

    def jloss(p):
        _, losses, _, aux = JM.get_loss(p, ms, jcfg, history, jnp.asarray(triples),
                                        jnp.asarray(mask), est_inputs=(est_state, rb),
                                        tans_mask_coo=tans, train=True)
        total = (jtc.task_weight * losses["entity"] + (1 - jtc.task_weight) * losses["relation"]
                 + losses["static"] + losses["radius"])
        return total, (losses, aux["est_ctx_tan"])

    want_g, (want_losses, want_ctx) = jax.jit(jax.grad(jloss, has_aux=True))(params)
    want_scores = JM.predict(params, ms, jcfg, history, jnp.asarray(triples), jnp.asarray(mask),
                             est_inputs=(est_state, rb))

    state = train_state_from_jax(after, device="cpu")
    prb, ptans = trainer.est_window(i)
    total, losses, _, aux = trainer.loss(state, *trainer.window(i), trainer._curvature_max(0),
                                         prb, ptans)
    for k in ("entity", "relation", "radius"):
        np.testing.assert_allclose(float(losses[k].detach()), float(want_losses[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(aux["est_ctx_tan"].detach().numpy(), want_ctx, rtol=1e-4,
                               atol=1e-5)
    grads = torch.autograd.grad(total, tree_leaves(state.params), allow_unused=True)
    want = keyed(want_g)
    for path, g, p in zip(paths(state.params), grads, tree_leaves(state.params)):
        w = want[path]
        g = torch.zeros_like(p) if g is None else g
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=path)
    with torch.inference_mode():
        scores = PM.predict(state.params, state.model_state, pcfg, trainer.window(i)[0],
                            trainer.window(i)[1], trainer.window(i)[2],
                            est_inputs=(state.est_state, prb))
    for got, w in zip(scores, want_scores):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
