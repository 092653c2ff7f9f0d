"""The port's HyperbolicTrainer on BASELINE config 4 (uvrgcn + AttH /
AttH-Rel, learned curvature, a curvature per relation, an entity bias)
against regcn_tpu's HyperbolicTrainer.

Config 4 is the first configuration whose entity loss takes the true
distance under a per-query curvature with a trained candidate bias: the
curvature's gradient (B2's dc on the card) flows into
``rel_curvature_raw`` through softplus and the relation-curvature clamp,
whose upper bound 0.999 c moves with the learned c, and the bias's (B2's
dbias) into ``entity_bias``. The relation loss (AttH-Rel) takes the
proxy distance with its bias, scale and margin.

One module-scoped JAX run, dropouts 0, no curvature warmup (the bound is
``curvature_max`` from the first epoch, as ``tools/bench_configs.py``
runs config 4), from ``init_state(PRNGKey(0))``: epochs 0 and 1 through
``run_epoch``, then epoch 0 again step by step through the same fused
epoch, one snapshot a call (the state before and after each step; as in
``tests/test_torch_hyperbolic_headline_train.py``, ``fused_steps``); ``fit`` for 2
epochs from the state after epoch 0; ``test(multi_step=True)`` of fit's
best state with entity and with relation feedback, the rank arrays read
where they are reduced. The port starts from the converted JAX states
(``train_state_from_jax``). Tolerances:

- a step, or an epoch: the (mean) losses within rtol 1e-4 / atol 1e-5;
  every parameter within atol 1e-5 + rtol 1e-3. Adam divides each update
  by sqrt(v), so a gradient entry that is mostly rounding noise still
  moves its parameter by up to lr; the tolerance is far below lr = 1e-3
  for parameters of magnitude below 1, so each step's direction must
  agree;
- parameters whose true gradient is 0: ``radius_mlp_w`` / ``radius_mlp_b``
  on a window of one snapshot (the radius they set is erased by the layer
  norm before the decoders, and no later step of the window feels it).
  Both packages move them by rounding noise, by up to lr on Adam's first
  step, so their values are not compared where that noise entered them,
  and the port's gradient of each is held to 1e-6 of the step's largest
  there. The first step of epoch 0 is on a one-snapshot window, so epoch 0
  is compared step by step from JAX's state before each step, and whole
  epochs start from the state after epoch 0, whose Adam moments damp that
  noise. The decoders' ``score_margin`` shifts every logit of a query
  alike, so the CE's gradient by it is 0 too; the port's is held to 1e-6
  of the step's largest at every step, and its value (~1) is compared
  with the others;
- ``fit``: the best and each epoch's valid MRR within 1e-4, the best
  state as an epoch's state;
- multi-step test: the same ranks as JAX's, snapshot by snapshot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hyperbolic_headline_train import fused_steps

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
from regcn_torch.train.optim import tree_leaves

# 6 training snapshots: 5 steps per epoch, the windows of i = 1 and 2 short
TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
CONFIG4 = dict(encoder="hyperbolic_uvrgcn", decoder="atth", c=0.01, learn_curvature=True,
               use_rel_curvature=True, use_entity_bias=True)
TC = dict(n_epochs=2, lr=1e-3, train_history_len=3, test_history_len=3, edge_bucket=32,
          rc_bucket=64, triple_bucket=64)
STEPS = 5
MRR_TOL = 1e-4
MARGINS = {"['decoder_ob']['score_margin']", "['decoder_rel']['score_margin']"}
RADIUS_MLP = {"['radius_mlp_w']", "['radius_mlp_b']"}
B2_GRADIENTS = ("['log_c']", "['decoder_ob']['rel_curvature_raw']",
                "['decoder_ob']['entity_bias']")


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
                **CONFIG4, **NO_DROPOUT)
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


def assert_state_close(state, want, rtol=1e-3, atol=1e-5, skip=frozenset()):
    """Every parameter but those in ``skip`` of the port's ``state`` against
    a JAX state with numpy leaves; the distance decoders keep no BN state."""
    params = keyed(want.params)
    got_paths = paths(state.params)
    assert set(got_paths) == set(params)
    for path, got in zip(got_paths, tree_leaves(state.params)):
        if path not in skip:
            np.testing.assert_allclose(got.detach().numpy(), params[path], rtol=rtol, atol=atol,
                                       err_msg=path)
    assert state.model_state.bn_ob == {} and state.model_state.bn_rel == {}


def recording(trainer, state, watch):
    """Wraps ``trainer.opt.step`` to record, per step, each watched
    parameter's largest gradient entry over the step's largest, and the
    largest entries of the B2 gradients (log_c, rel_curvature_raw,
    entity_bias)."""
    names, step, seen = paths(state.params), trainer.opt.step, []

    def recording_step(params, grads, opt_state):
        largest = max(g.abs().max().item() for g in grads if g is not None)
        row = {n: g.abs().max().item() / largest for n, g in zip(names, grads) if n in watch}
        row["b2"] = {n: g.abs().max().item() for n, g in zip(names, grads) if n in B2_GRADIENTS}
        seen.append(row)
        step(params, grads, opt_state)

    trainer.opt.step = recording_step
    return seen


def assert_held(seen, held):
    for row in seen:
        b2 = row.pop("b2")
        assert set(row) == set(held) and all(v <= 1e-6 for v in row.values()), row
        assert set(b2) == set(B2_GRADIENTS) and all(v > 0 for v in b2.values()), b2


def test_config4_model_runs_both_distances(data):
    """The entity loss takes the true distance with a per-query curvature
    and the entity bias; the relation loss the proxy with its own bias."""
    _, _, pcfg, _ = configs(data)
    state = trainer_of(data).init_state()
    ob, rel = state.params["decoder_ob"], state.params["decoder_rel"]
    assert {"rel_curvature_raw", "entity_bias"} <= set(ob) and "log_c" in state.params
    assert ob["rel_curvature_raw"].shape == (2 * data.num_rels,)
    assert ob["entity_bias"].shape == (data.num_nodes,)
    assert {"global_rot", "global_ref", "attn_weight", "rel_bias"} <= set(rel)
    assert PM.ENTITY_LOSSES[pcfg.decoder] is PM.HD.atth_loss


def test_epoch_0_steps_match_jax_train_step(data, jax_run):
    """Each of epoch 0's steps from JAX's state before it: the losses and
    every parameter after it, the B2 gradients (log_c, rel_curvature_raw,
    entity_bias) nonzero; on the one-snapshot window radius_mlp's gradient
    is held to 0 instead of comparing its values."""
    trainer = trainer_of(data)
    steps = jax_run["steps"]
    assert [i for i, *_ in steps] == trainer.epoch_order(0)
    assert sum(trainer.window(i)[0].src.shape[0] == 1 for i, *_ in steps) == 1
    for i, before, want_losses, after in steps:
        state = train_state_from_jax(before, device="cpu")
        one = trainer.window(i)[0].src.shape[0] == 1
        seen = recording(trainer, state, MARGINS | (RADIUS_MLP if one else set()))
        losses = trainer.train_step(state, *trainer.window(i), trainer._curvature_max(0))
        for k in ("entity", "relation", "static", "radius"):
            np.testing.assert_allclose(float(losses[k]), want_losses[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"step on snapshot {i}: {k}")
        assert_held(seen, MARGINS | (RADIUS_MLP if one else set()))
        assert_state_close(state, after, skip=RADIUS_MLP if one else frozenset())


def test_epoch_1_matches_jax_run_epoch(data, jax_run):
    """The whole of epoch 1 from the converted state after JAX's epoch 0
    (Adam count 5) against ``run_epoch``."""
    trainer = trainer_of(data)
    state = train_state_from_jax(jax_run["after0"], device="cpu")
    assert state.opt_state.count == state.step == STEPS
    seen = recording(trainer, state, MARGINS)
    got = trainer.run_epoch(state, 1)
    assert state.step == state.opt_state.count == 2 * STEPS
    for k, want in jax_run["mean1"].items():
        np.testing.assert_allclose(got[k], want, rtol=1e-4, atol=1e-5, err_msg=k)
    assert got["entity"] > 0 and got["relation"] > 0 and got["radius"] > 0
    assert len(seen) == STEPS
    assert_held(seen, MARGINS)
    assert_state_close(state, jax_run["after1"])


def test_fit_matches_jax(data, jax_run):
    best, got = trainer_of(data).fit(state=train_state_from_jax(jax_run["after0"], device="cpu"))
    want = jax_run["info"]
    assert got["selection_metric"] == want["selection_metric"] == "ent_raw"
    assert abs(got["best_valid_mrr_raw"] - want["best_valid_mrr_raw"]) <= MRR_TOL
    assert len(got["history"]) == len(want["history"]) == 2
    for g, w in zip(got["history"], want["history"]):
        assert g["epoch"] == w["epoch"]
        assert abs(g["valid_mrr_raw"] - w["valid_mrr_raw"]) <= MRR_TOL, (g, w)
        for k in ("entity", "relation", "static", "radius"):
            np.testing.assert_allclose(g["losses"][k], w["losses"][k], rtol=1e-4, atol=1e-5)
    assert_state_close(best, jax_run["best"])


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
