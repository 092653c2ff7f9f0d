"""The vectorized sweep (``regcn_torch.train.sweep``) and the ``torch.func``
rules of kernels B1 and B2, on the CPU.

- B1 (``scatter_add_sorted``) under ``vmap`` over K models: with a shared
  graph the model axis folds into the feature axis (one call on
  [E, K * d]); a per-model edge weight is multiplied into the messages
  first, its gradient from the batched backward; batched keys run once
  per model. Values and gradients (``vmap(grad)``) equal a Python loop
  over the models to 1e-6.
- B2 (``streaming_nll``): the forward and both backward Functions run
  once per model under ``vmap``; the NLL and all six gradients, on both
  distances, equal a loop over the models to 1e-6.
- ``SweepRunner`` with ``{lr: 2, task_weight: 2, seed: 2}`` against JAX's
  (dropouts 0): epoch 1 from JAX's state after epoch 0 (converted; Adam
  moments that damp the rounding noise of near-zero gradients), every
  parameter within atol 1e-5 + rtol 1e-3 but the ConvTrans decoders'
  ``conv_b`` and ``fc_b`` (true gradient 0 under the batch-statistics
  BatchNorm after each: Adam moves them by rounding noise), then each
  model's four valid MRRs within 1e-4; ``run``'s rows.
- each model slice of the RE-GCN sweep against the port's own
  ``Trainer`` with that model's lr, task weight and seed, dropouts on: 3
  steps, each from the same state and the same generator state, the
  losses within rtol 1e-5, every gradient within 1e-5 of its largest
  entry, the BN statistics, and the optimizer step within 1e-6;
- ``HyperbolicSweepRunner`` on LGCN + RotH (B2 decoders) against JAX's as
  above, and on the headline (uvrgcn on B1, the per-model radius weight)
  against the port's ``HyperbolicTrainer`` step by step as above; its
  refusals (``manifold_entities``, ``use_est``, a mesh) as JAX's.
- ``SweepRunner(mesh=...)`` on one spawn of 2 gloo CPU ranks, a (data 2,
  graph 1) mesh (a file store; the ranks niced, torch on one thread),
  started before this process computes the references, at this file's
  sizes (h = 16, 2 layers): K = 4 models (lr {1e-3, 5e-4} x seeds {1, 2})
  with the config's dropouts for one epoch, on that mesh and on a (data 1,
  graph 2) mesh of the same ranks (both ranks bit-equal there), against
  the unsharded port on the same combos: every parameter within rtol 1e-5
  / atol 1e-7, the epoch's mean losses within rtol 1e-5, the four valid
  MRRs within 1e-6 (each model's dropout draws come from its own
  generator whatever rank holds it, and a vmapped batch of K / D models
  rounds as one of K), the rows of all K models in combo order on both
  ranks; K = 8 (4 a rank, dropouts 0) against JAX's ``SweepRunner`` on a
  (data 8, graph 1) mesh, as ``tests/test_sweep.py`` builds it, by
  ``check_against_jax``'s criteria (see the test for the one entry that
  the unsharded port, too, holds only as far as it is from JAX); the
  divisibility error's message as JAX's, without a process group. JAX is
  imported inside functions only, so that the spawned ranks, which import
  this module to find their entry point, load none.
"""

import dataclasses
import os
import pickle
import random

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.func import grad, vmap

import test_torch_sharded_train as TT
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.convert import _adam_states, _like, _tensor_tree
from regcn_torch.data.answers import build_answer_filters_by_time
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic.model import HyperbolicConfig
from regcn_torch.hyperbolic.train import HyperbolicTrainer
from regcn_torch.parallel.mesh import MeshAxes, check_model_divisibility, make_mesh
from regcn_torch.ops import rgcn_scatter
from regcn_torch.ops import streaming_ce as ce
from regcn_torch.train import loop as pt_loop
from regcn_torch.train import state as pt_state
from regcn_torch.train.loop import RANK_KEYS
from regcn_torch.train.optim import AdamState, tree_leaves, tree_map
from regcn_torch.train.sweep import HyperbolicSweepRunner, SweepRunner, SweepState, model_slice
from regcn_torch.utils.profiling import _named_leaves

TINY = dict(num_ents=60, num_rels=5, num_snaps=12, triples_per_snap=40, split=(8, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
TC = dict(edge_bucket=32, rc_bucket=32, triple_bucket=32, train_history_len=2,
          test_history_len=2, lr=1e-3)
COMBOS = {"lr": [1e-3, 5e-3], "task_weight": [0.7, 0.5], "seed": [0, 1]}
MRR_TOL = 1e-4
NOISE = ("conv_b", "fc_b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    from regcn_tpu.data.synthetic import generate as jax_generate

    return jax_generate("synthetic-small", seed=17, **TINY), generate("synthetic-small",
                                                                      seed=17, **TINY)


# ---------------------------------------------------------------- B1 rules

@pytest.fixture
def forward_calls(monkeypatch):
    """The shapes of the messages the scatter's plain forward sees."""
    seen = []
    orig = rgcn_scatter._scatter_forward

    def spy(msg, *args):
        seen.append(tuple(msg.shape))
        return orig(msg, *args)

    monkeypatch.setattr(rgcn_scatter, "_scatter_forward", spy)
    return seen


@pytest.mark.parametrize("weight", ["shared", "per_model", "batched_keys"])
def test_b1_vmap_rule_matches_a_loop(forward_calls, weight):
    g = np.random.default_rng(3)
    K, E, n, d = 4, 40, 9, 6
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    keys = torch.from_numpy(np.sort(g.integers(0, n + 1, (K, E)), axis=1).astype(np.int32))
    msgs, target = t(g.normal(size=(K, E, d))), t(g.normal(size=(K, n, d)))
    ws, row_scale = t(g.random((K, E))), t(g.random(n))

    def f(msg, w, k, tgt):
        out = rgcn_scatter.scatter_add_sorted(2.0 * msg, k, n, edge_weight=w,
                                              row_scale=row_scale)
        return (out * tgt).sum()

    dims = {"shared": (0, None, None, 0), "per_model": (0, 0, None, 0),
            "batched_keys": (0, 0, 0, 0)}[weight]
    args = (msgs, ws[0] if dims[1] is None else ws, keys[0] if dims[2] is None else keys, target)
    grads = vmap(grad(f, argnums=(0, 1)), in_dims=dims)(*args)
    values = vmap(f, in_dims=dims)(*args)
    calls = list(forward_calls)
    want_calls = {"shared": [(E, K * d)] * 2, "per_model": [(E, K * d)] * 2,
                  "batched_keys": [(E, d)] * (2 * K)}[weight]
    assert calls == want_calls
    for k in range(K):
        pick = [a if dim is None else a[k] for a, dim in zip(args, dims)]
        leaves = [pick[0].clone().requires_grad_(True), pick[1].clone().requires_grad_(True)]
        value = f(leaves[0], leaves[1], pick[2], pick[3])
        want = torch.autograd.grad(value, leaves)
        torch.testing.assert_close(values[k], value.detach(), rtol=1e-6, atol=1e-6)
        for got, w in zip(grads, want):
            torch.testing.assert_close(got[k], w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- B2 rules

@pytest.mark.parametrize("true_dist", [False, True], ids=["proxy", "true"])
def test_b2_vmap_rules_match_a_loop(monkeypatch, true_dist):
    calls = []

    def spy(fn):
        orig = fn.forward

        def forward(*args):
            calls.append((fn.__name__, tuple(args[0].shape)))
            return orig(*args)

        return staticmethod(forward)

    for fn in (ce._StreamingNLL, ce._BackwardQ, ce._BackwardX):
        monkeypatch.setattr(fn, "forward", spy(fn))
    g = np.random.default_rng(5)
    K, B, N, d = 3, 7, 11, 4
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ins = (t(0.1 * g.normal(size=(K, B, d))), t(0.1 * g.normal(size=(K, N, d))),
           t(g.normal(size=(K, N))), t(0.01 + 0.1 * g.random((K, B))),
           t(0.5 + g.random(K)), t(g.random(K)))
    target = torch.from_numpy(g.integers(0, N, B))
    weights = t(g.random(B))

    def f(q, x, bias, cq, scale, margin):
        return (ce.streaming_nll(q, x, bias, target, cq, scale, margin, true_dist)
                * weights).sum()

    grads = vmap(grad(f, argnums=tuple(range(6))))(*ins)
    assert sorted(calls) == sorted([(n, (B, d)) for n in ("_StreamingNLL", "_BackwardQ",
                                                           "_BackwardX")] * K)
    for k in range(K):
        leaves = [a[k].clone().requires_grad_(True) for a in ins]
        want = torch.autograd.grad(
            (ce.streaming_nll_reference(leaves[0], leaves[1], leaves[2], target, leaves[3],
                                        leaves[4], leaves[5], true_dist) * weights).sum(),
            leaves)
        for got, w in zip(grads, want):
            torch.testing.assert_close(got[k], w, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- against JAX's sweeps

def sweep_state_from_jax(runner, states) -> SweepState:
    """The port's SweepState from a JAX sweep's stacked state (numpy leaves):
    parameters, BN statistics and the stacked Adam moments of its
    ``inject_hyperparams(adam)``."""
    params = _tensor_tree(states.params, "cpu")
    ms = {f.name: _tensor_tree(getattr(states.model_state, f.name), "cpu")
          for f in dataclasses.fields(runner.model_state_type)}
    state = runner.state_from(params, ms)
    (_, adam), = _adam_states(states.opt_state)
    state.opt_state = AdamState(
        count=int(np.asarray(adam.count).reshape(-1)[0]),
        mu=tree_leaves(_like(_tensor_tree(adam.mu, "cpu"), state.params)),
        nu=tree_leaves(_like(_tensor_tree(adam.nu, "cpu"), state.params)))
    return state


def named(params) -> dict:
    return dict(_named_leaves(params, {id(t): t for t in tree_leaves(params)}))


def jax_placed(jr, states):
    """numpy ``states`` on JAX's devices as its sweep's ``run`` places them:
    the model axis over the ``data`` axis of its mesh, if it has one."""
    import jax
    import jax.numpy as jnp

    from regcn_tpu.train.sweep import model_axis_shardings

    states = jax.tree.map(jnp.asarray, states)
    mesh = getattr(jr, "mesh", None)
    return states if mesh is None else jax.device_put(states,
                                                      model_axis_shardings(states, mesh))


def jax_epoch(jr, states, epoch):
    import jax
    import jax.numpy as jnp

    idx = list(range(1, len(jr.train_list)))
    random.Random(jr.tc.seed + epoch).shuffle(idx)
    states, _ = jr.epoch_fn(jax_placed(jr, states), jr.store,
                            jnp.asarray(np.asarray(idx, np.int32)),
                            jnp.asarray(np.asarray(jr.tws, np.float32)))
    return jax.tree.map(np.array, states)


def jax_valid_mrrs(jr, states) -> list:
    """Each model's four valid MRRs of a JAX sweep state (its ``run``'s
    evaluation, from a given state)."""
    import jax

    from regcn_tpu.data.answers import build_answer_filters_by_time
    from regcn_tpu.train import metrics
    from regcn_tpu.train.epoch import build_eval_store, stack_eval_filters

    tc, d = jr.tc, jr.data
    ent_f = build_answer_filters_by_time(d.valid, d.num_rels, False)
    rel_f = build_answer_filters_by_time(d.valid, d.num_rels, True)
    estore = build_eval_store(jr.train_list, jr.valid_list, d.num_nodes, d.num_rels,
                              tc.test_history_len, edge_bucket=tc.edge_bucket,
                              rc_bucket=tc.rc_bucket, triple_bucket=tc.triple_bucket)
    er, ec = stack_eval_filters(ent_f, jr.valid_list, d.num_rels, tc.triple_bucket,
                                rel_mode=False)
    rr, rc = stack_eval_filters(rel_f, jr.valid_list, d.num_rels, tc.triple_bucket,
                                rel_mode=True)
    ranks = jax.device_get(jr.eval_fn(jax_placed(jr, states), estore, er, ec, rr, rc))
    tmask = np.asarray(estore.triple_mask)[tc.test_history_len:] > 0
    return [{key: metrics.stat_ranks([arr[k][t][tmask[t]] for t in range(arr.shape[1])]).mrr
             for key, arr in zip(RANK_KEYS, ranks)} for k in range(jr.n_models)]


def assert_params_near_jax(got_params, want_params):
    """Every parameter but NOISE's within rtol 1e-3 / atol 1e-5 of JAX's."""
    got, want = named(got_params), named(_tensor_tree(want_params, "cpu"))
    assert set(got) == set(want)
    for name, w in want.items():
        if not name.endswith(tuple(f"['{n}']" for n in NOISE)):
            torch.testing.assert_close(got[name], w, rtol=1e-3, atol=1e-5, msg=name)


def assert_mrrs_near_jax(got, want):
    for g, w in zip(got, want, strict=True):
        for key in RANK_KEYS:
            assert abs(g[key] - w[key]) <= MRR_TOL, (key, g[key], w[key])


def valid_stats(runner, state):
    """Each model's RANK_KEYS -> RankStats on the valid split."""
    ent_f = build_answer_filters_by_time(runner.data.valid, runner.data.num_rels, False)
    rel_f = build_answer_filters_by_time(runner.data.valid, runner.data.num_rels, True)
    return runner.evaluate(state, runner.train_list, runner.valid_list, ent_f, rel_f)


def check_against_jax(jr, runner, init):
    """Epoch 0 in JAX from its initial states; epoch 1 from there in both:
    every parameter, then each model's valid MRRs (the rows of ``run``)."""
    after0 = jax_epoch(jr, init, 0)
    after1 = jax_epoch(jr, after0, 1)
    state = sweep_state_from_jax(runner, after0)
    runner.run_epoch(state, 1)
    assert_params_near_jax(state.params, after1.params)
    assert_mrrs_near_jax([{k: s.mrr for k, s in g.items()} for g in valid_stats(runner, state)],
                         jax_valid_mrrs(jr, after1))
    rows, _ = runner.run(n_epochs=1)
    assert [(r["lr"], r["task_weight"], r["seed"]) for r in rows] == list(
        zip(jr.lrs, jr.tws, jr.seeds))
    assert all(0 < r["valid_ent_mrr_raw"] == r["stats"]["ent_raw"].mrr <= 1 for r in rows)


def test_sweep_runner_matches_jax(data):
    import jax

    from regcn_tpu.config import ModelConfig as JaxModelConfig
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.train.sweep import SweepRunner as JaxSweepRunner

    jdata, pdata = data
    base = dict(num_ents=jdata.num_nodes, num_rels=jdata.num_rels, h_dim=16, n_layers=2,
                **NO_DROPOUT)
    jr = JaxSweepRunner(JaxModelConfig(**base), JaxTrainConfig(**TC), jdata, COMBOS)
    init = jax.tree.map(np.array, jr.init_fn(jr.seeds, jr.lrs))
    runner = SweepRunner(ModelConfig(**base), TrainConfig(**TC), pdata, COMBOS, device="cpu")
    assert runner.n_models == 2
    check_against_jax(jr, runner, init)


def test_hyperbolic_sweep_runner_matches_jax_on_config3(data):
    import jax

    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.hyperbolic.model import HyperbolicConfig as JaxHyperbolicConfig
    from regcn_tpu.train.sweep import HyperbolicSweepRunner as JaxHyperbolicSweepRunner

    jdata, pdata = data
    base = dict(num_ents=jdata.num_nodes, num_rels=jdata.num_rels, h_dim=8, n_layers=2,
                encoder="lgcn", decoder="roth", n_bases=4, learn_curvature=True, **NO_DROPOUT)
    combos = {"lr": COMBOS["lr"], "task_weight": COMBOS["task_weight"]}
    jr = JaxHyperbolicSweepRunner(JaxHyperbolicConfig(**base), JaxTrainConfig(**TC), jdata,
                                  combos)
    init = jax.tree.map(np.array, jr._init_states())
    runner = HyperbolicSweepRunner(HyperbolicConfig(**base), TrainConfig(**TC), pdata, combos,
                                   device="cpu")
    check_against_jax(jr, runner, init)


# ------------------------------------------- against the port's own trainers

def check_slices(runner, trainers, loss_args=()):
    """3 steps: before each, model k's trainer takes slice k of the sweep's
    state and its generator's state; the losses, gradients, BN statistics
    and the optimizer step of each slice against its trainer's."""
    state = runner.init_state()
    for i in runner.epoch_order(0)[:3]:
        gens = [g.get_state() for g in state.gens]
        losses, grads, new_ms = runner.grad_step(state, i)
        stepped = []
        for k, tr in enumerate(trainers):
            ms_k = runner.model_state_type(**model_slice(state.model_state, k))
            if isinstance(tr, pt_loop.Trainer):
                s_k = pt_state.state_from(model_slice(state.params, k), ms_k, tr.cfg.train, 0,
                                          "cpu")
            else:
                s_k = tr.state_from(model_slice(state.params, k), ms_k)
            s_k.gen.set_state(gens[k])
            total, parts, new_bn, *_ = tr.loss(s_k, *tr.window(i), *loss_args)
            want = torch.autograd.grad(total, tree_leaves(s_k.params), allow_unused=True)
            for key, v in parts.items():
                torch.testing.assert_close(losses[key][k], v.detach(), rtol=1e-5, atol=1e-6)
            scale = max(g[k].abs().max().item() for g in grads)
            for got, w in zip(grads, want):
                w = torch.zeros_like(got[k]) if w is None else w
                assert (got[k] - w).abs().max().item() <= 1e-5 * scale
            for a, b in zip(tree_leaves(model_slice(new_ms, k)),
                            tree_leaves(dataclasses.asdict(new_bn))):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            leaves = [p.detach().clone() for p in tree_leaves(s_k.params)]
            opt_k = AdamState(count=state.opt_state.count,
                              mu=[m[k].clone() for m in state.opt_state.mu],
                              nu=[m[k].clone() for m in state.opt_state.nu])
            tr.opt.step(leaves, [g[k] for g in grads], opt_k)
            stepped.append(leaves)
        runner.opt.step(tree_leaves(state.params), grads, state.opt_state)
        state.model_state = new_ms
        for k, leaves in enumerate(stepped):
            for a, b in zip(tree_leaves(state.params), leaves):
                torch.testing.assert_close(a[k], b, rtol=1e-6, atol=1e-6)


def test_sweep_slices_match_the_sequential_trainer_with_dropout(data):
    _, pdata = data
    cfg = ModelConfig(num_ents=pdata.num_nodes, num_rels=pdata.num_rels, h_dim=16, n_layers=2)
    tc = TrainConfig(**TC)
    runner = SweepRunner(cfg, tc, pdata, COMBOS, device="cpu")
    assert runner.draw_shapes(runner.init_state(), 3)  # dropouts on: draws to make
    trainers = [pt_loop.Trainer(ExperimentConfig(model=cfg, train=dataclasses.replace(
        tc, lr=lr, task_weight=tw, seed=s)), pdata, device="cpu")
        for lr, tw, s in zip(*COMBOS.values())]
    check_slices(runner, trainers)


def test_headline_sweep_slices_match_the_hyperbolic_trainer(data):
    _, pdata = data
    cfg = HyperbolicConfig(num_ents=pdata.num_nodes, num_rels=pdata.num_rels, h_dim=8,
                           n_layers=2)
    assert (cfg.encoder, cfg.decoder) == ("hyperbolic_uvrgcn", "hyperbolic_convtranse")
    tc = TrainConfig(**TC)
    runner = HyperbolicSweepRunner(cfg, tc, pdata, COMBOS, device="cpu")
    trainers = [HyperbolicTrainer(cfg, dataclasses.replace(tc, lr=lr, task_weight=tw, seed=s),
                                  pdata, device="cpu") for lr, tw, s in zip(*COMBOS.values())]
    check_slices(runner, trainers, (trainers[0]._curvature_max(0),))


def test_hyperbolic_sweep_refusals(data):
    _, pdata = data
    tc = TrainConfig(**TC)
    for kw in ({"manifold_entities": True}, {"use_est": True}):
        cfg = HyperbolicConfig(num_ents=pdata.num_nodes, num_rels=pdata.num_rels, h_dim=8, **kw)
        with pytest.raises(ValueError, match="non-EST"):
            HyperbolicSweepRunner(cfg, tc, pdata, {"lr": [1e-3]}, device="cpu")
    cfg = ModelConfig(num_ents=pdata.num_nodes, num_rels=pdata.num_rels, h_dim=8)
    with pytest.raises(ValueError, match="shape-changing"):
        SweepRunner(cfg, tc, pdata, {"n_hidden": [8, 16]}, device="cpu")
    with pytest.raises(TypeError, match="mesh"):  # JAX's takes no mesh either
        HyperbolicSweepRunner(HyperbolicConfig(num_ents=pdata.num_nodes,
                                               num_rels=pdata.num_rels, h_dim=8),
                              tc, pdata, {"lr": [1e-3]}, mesh=object(), device="cpu")


# ------------------------------------------------- the model axis on a mesh

D = 2  # the data axis of the port's mesh
COMBOS_4 = {"lr": [1e-3, 5e-4, 1e-3, 5e-4], "seed": [1, 1, 2, 2]}
# JAX's sharded sweep case (tests/test_sweep.py): 8 models on a data axis of 8
COMBOS_8 = {"lr": [1e-3, 5e-4] * 4, "seed": [1, 2, 3, 4, 5, 6, 7, 8]}


def mesh_data():
    return generate("synthetic-small", seed=17, **TINY)


def mesh_model(data, dropout: bool) -> dict:
    return dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=16, n_layers=2,
                **({} if dropout else NO_DROPOUT))


def port_sweep(data, combos, dropout: bool, mesh=None) -> SweepRunner:
    return SweepRunner(ModelConfig(**mesh_model(data, dropout)), TrainConfig(**TC), data,
                       combos, mesh=mesh, device="cpu")


def run_recording(runner) -> tuple:
    """``run(n_epochs=1)``: (rows, the rank's state, the epoch's mean losses)."""
    seen, run_epoch = [], runner.run_epoch
    runner.run_epoch = lambda *a: seen.append(run_epoch(*a)) or seen[-1]
    rows, state = runner.run(n_epochs=1)
    return rows, state, seen[0]


def mrrs(rows) -> list:
    return [{k: s.mrr for k, s in r["stats"].items()} for r in rows]


def sweep_rank_main(rank: int, workdir: str) -> None:
    """One rank of the (data 2, graph 1) mesh: the K = 4 sweep with dropouts
    from its seeds; then JAX's K = 8 state after epoch 0 (converted by the
    test process), the rank's models' slice of it, epoch 1 and the valid
    split of every model."""
    torch.set_num_threads(1)
    os.nice(10)  # a helper of this test: the other test workers keep their CPU share
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=D,
                            rank=rank)
    data, mesh = mesh_data(), make_mesh(MeshAxes(data=D, graph=1), device_type="cpu")
    runner = port_sweep(data, COMBOS_4, dropout=True, mesh=mesh)
    rows, state, losses = run_recording(runner)
    out = {"own": list(runner.own), "rows": [{k: v for k, v in r.items() if k != "stats"}
                                             for r in rows],
           "mrrs": mrrs(rows), "losses": losses, "params": state.params}
    # the same sweep on a (data 1, graph 2) mesh of the same ranks: both
    # hold all 4 models, the graph group's first rank's values carried
    runner = port_sweep(data, COMBOS_4, dropout=True,
                        mesh=make_mesh(MeshAxes(data=1, graph=D), device_type="cpu"))
    rows, state, losses = run_recording(runner)
    out["replicas"] = {"own": list(runner.own), "mrrs": mrrs(rows), "losses": losses,
                       "params": state.params}
    runner = port_sweep(data, COMBOS_8, dropout=False, mesh=mesh)
    own = slice(runner.own.start, runner.own.stop)

    def own_state(blob):
        state = runner.state_from(tree_map(lambda t: t[own], blob["params"]),
                                  tree_map(lambda t: t[own], blob["model_state"]))
        state.opt_state = AdamState(count=blob["count"], mu=[m[own] for m in blob["mu"]],
                                    nu=[m[own] for m in blob["nu"]])
        return state

    def valid_mrrs(state):
        return [{k: s.mrr for k, s in st.items()} for st in valid_stats(runner, state)]

    state = own_state(TT.read_input(workdir, "after0"))
    runner.run_epoch(state, 1)
    out["jax"] = {"own": list(runner.own), "params": state.params, "mrrs": valid_mrrs(state),
                  "mrrs_of_jax": valid_mrrs(own_state(TT.read_input(workdir, "after1")))}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def sweep_spawn(tmp_path_factory):
    """The D = 2 ranks, started first: their K = 4 sweep needs nothing of
    this process; JAX's state after epoch 0 reaches them later."""
    workdir = str(tmp_path_factory.mktemp("sweep_mesh"))
    return workdir, mp.start_processes(sweep_rank_main, args=(workdir,), nprocs=D, join=False,
                                       start_method="spawn")


@pytest.fixture(scope="module")
def mesh_jax(sweep_spawn):
    """JAX's SweepRunner over a (data 8, graph 1) mesh, K = 8, dropouts 0:
    its states after epochs 0 and 1, each converted for the ranks, and each
    model's valid MRRs after epoch 1; the unsharded port's parameters after
    its epoch 1 from the same state after epoch 0."""
    import jax

    from regcn_tpu.config import ModelConfig as JaxModelConfig
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.data.synthetic import generate as jax_generate
    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from regcn_tpu.train.sweep import SweepRunner as JaxSweepRunner

    jdata = jax_generate("synthetic-small", seed=17, **TINY)
    jcfg, jtc = JaxModelConfig(**mesh_model(jdata, dropout=False)), JaxTrainConfig(**TC)
    jr = JaxSweepRunner(jcfg, jtc, jdata, dict(COMBOS_8),
                        mesh=jax_make_mesh(JaxMeshAxes(data=8, graph=1)))
    init = jax.tree.map(np.array, jr.init_fn(jr.seeds, jr.lrs))
    after0 = jax_epoch(jr, init, 0)
    runner = port_sweep(mesh_data(), COMBOS_8, dropout=False)

    def send(name, states):
        state = sweep_state_from_jax(runner, states)
        TT.write_input(sweep_spawn[0], name, {
            "params": state.params, "model_state": state.model_state,
            "count": state.opt_state.count, "mu": state.opt_state.mu, "nu": state.opt_state.nu})

    send("after0", after0)
    after1 = jax_epoch(jr, after0, 1)
    send("after1", after1)
    state = sweep_state_from_jax(runner, after0)
    runner.run_epoch(state, 1)
    return after1, jax_valid_mrrs(jr, after1), state.params


@pytest.fixture(scope="module")
def unsharded_4(sweep_spawn):
    """The unsharded port's K = 4 sweep with dropouts, while the ranks run."""
    return run_recording(port_sweep(mesh_data(), COMBOS_4, dropout=True))


@pytest.fixture(scope="module")
def mesh_ranks(sweep_spawn, mesh_jax, unsharded_4):
    """Every rank's results, once JAX's and the unsharded references are in."""
    workdir, ctx = sweep_spawn
    while not ctx.join():
        pass
    ranks = []
    for r in range(D):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def test_sharded_sweep_matches_the_unsharded_sweep(mesh_ranks, unsharded_4):
    """Each rank's K / D models after one epoch with dropouts: every
    parameter, every model's mean losses and four valid MRRs as the
    unsharded sweep's."""
    rows, state, losses = unsharded_4
    assert [r["own"] for r in mesh_ranks] == [[0, 1], [2, 3]]
    for res in mesh_ranks:
        own = slice(res["own"][0], res["own"][-1] + 1)
        want = named(tree_map(lambda t: t[own], state.params))
        got = named(res["params"])
        assert set(got) == set(want)
        for name, w in want.items():
            torch.testing.assert_close(got[name], w, rtol=1e-5, atol=1e-7, msg=name)
        assert set(res["losses"]) == set(losses)
        for k, w in losses.items():
            np.testing.assert_allclose(res["losses"][k], w, rtol=1e-5, atol=0, err_msg=k)
        for g, w in zip(res["mrrs"], mrrs(rows), strict=True):
            for key in RANK_KEYS:
                assert abs(g[key] - w[key]) <= 1e-6, (key, g[key], w[key])


def test_sharded_sweep_replicas_on_a_graph_axis(mesh_ranks, unsharded_4):
    """On a (data 1, graph 2) mesh both ranks train all 4 models, each
    step's gradients, BN statistics and losses and the valid split's ranks
    their graph group's first rank's: the two ranks bit-equal, and every
    parameter, loss and MRR as the unsharded sweep's."""
    _, state, losses = unsharded_4
    first, second = (res["replicas"] for res in mesh_ranks)
    assert first["own"] == second["own"] == [0, 1, 2, 3]
    for a, b in zip(tree_leaves(first["params"]), tree_leaves(second["params"])):
        assert torch.equal(a, b)
    assert first["mrrs"] == second["mrrs"]
    got, want = named(first["params"]), named(state.params)
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=1e-5, atol=1e-7, msg=name)
    for k, w in losses.items():
        np.testing.assert_allclose(first["losses"][k], w, rtol=1e-5, atol=0, err_msg=k)
    for g, w in zip(first["mrrs"], mrrs(unsharded_4[0]), strict=True):
        for key in RANK_KEYS:
            assert abs(g[key] - w[key]) <= 1e-6, (key, g[key], w[key])


def test_sharded_sweep_rows_in_combo_order_on_every_rank(mesh_ranks, unsharded_4):
    rows = unsharded_4[0]
    want = [(lr, 0.7, s) for lr, s in zip(*COMBOS_4.values())]  # tc's task weight
    for res in mesh_ranks:
        assert [(r["lr"], r["task_weight"], r["seed"]) for r in res["rows"]] == want
        assert [r["valid_ent_mrr_raw"] for r in res["rows"]] == [m["ent_raw"]
                                                               for m in res["mrrs"]]
        assert all(0 < r["valid_ent_mrr_raw"] <= 1 for r in res["rows"])
    assert mesh_ranks[0]["rows"] == mesh_ranks[1]["rows"]
    assert len(rows) == len(want)


def test_sharded_sweep_matches_jax_sharded_sweep(mesh_ranks, mesh_jax):
    """K = 8 at D = 2 (4 models a rank) against JAX's sweep over a (data
    8, graph 1) mesh, epoch 1 from JAX's state after epoch 0: every rank's
    models' parameters as ``check_against_jax`` holds them, but that an
    entry outside that tolerance must lie no further from JAX than the
    unsharded port's sweep from the same state does (one entry does: model
    6's decoder_rel bn1 bias, 4.62e-5 from JAX against 1.4e-5 allowed, in
    the port sharded or not; JAX's own sharded and unsharded sweeps part by
    1.4e-4 in that leaf of model 1); every model's valid MRRs on each rank
    within MRR_TOL of JAX's; and the mesh's evaluation of JAX's own state
    after epoch 1 within MRR_TOL of JAX's."""
    after1, want_mrrs, unsharded = mesh_jax
    outside = []
    for res in mesh_ranks:
        own = slice(res["jax"]["own"][0], res["jax"]["own"][-1] + 1)
        assert own.stop - own.start == 8 // D
        got = named(res["jax"]["params"])
        want = named(tree_map(lambda t: t[own], _tensor_tree(after1.params, "cpu")))
        port = named(tree_map(lambda t: t[own], unsharded))
        assert set(got) == set(want)
        for name, w in want.items():
            if name.endswith(tuple(f"['{n}']" for n in NOISE)):
                continue
            gap, allowed = (got[name] - w).abs(), 1e-5 + 1e-3 * w.abs()
            far = gap > allowed
            if bool(far.any()):
                outside.append((name, gap.max().item()))
                assert bool((gap[far] <= (port[name] - w).abs()[far] + 1e-7).all()), name
        assert_mrrs_near_jax(res["jax"]["mrrs"], want_mrrs)
        assert_mrrs_near_jax(res["jax"]["mrrs_of_jax"], want_mrrs)
    assert len(outside) <= 1, outside


def test_sweep_divisibility_error_matches_jax():
    """K = 3 on a data axis of 2: JAX's SweepRunner raises at construction,
    the port's check (which ``SweepRunner(mesh=...)`` runs first) the same
    message, without a process group."""
    import jax

    from regcn_tpu.config import ModelConfig as JaxModelConfig
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.data.synthetic import generate as jax_generate
    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from regcn_tpu.train.sweep import SweepRunner as JaxSweepRunner

    jdata = jax_generate("synthetic-small", seed=17, **TINY)
    with pytest.raises(ValueError, match="pad the combo list to 4") as want:
        JaxSweepRunner(JaxModelConfig(**mesh_model(jdata, dropout=False)),
                       JaxTrainConfig(**TC), jdata, {"seed": [1, 2, 3]},
                       mesh=jax_make_mesh(JaxMeshAxes(data=2, graph=1),
                                          devices=jax.devices()[:2]))
    with pytest.raises(ValueError, match="pad the combo list to 4") as got:
        check_model_divisibility(3, 2)
    assert str(got.value) == str(want.value)
    check_model_divisibility(4, 2)
