"""The rest of the hyperbolic trainer in the port, against regcn_tpu:
Riemannian Adam on entities stored on the ball (``manifold_entities``),
triple batching in both modes, ``run_analysis`` in both trainers, and the
uvrgcn's ball-space layer (``evolve(tangent_fast=False)``).

The trainer runs BASELINE config 5's model (the headline, uvrgcn +
tangent ConvTransE/R, with EST and TANS negatives, K = 4 events) with
``manifold_entities``, dropouts 0, from JAX's ``init_state(PRNGKey(0))``
converted (its optax ``multi_transform`` state included). One
module-scoped JAX run: epoch 0 step by step through its fused epoch, one
snapshot a call (``fused_steps`` of
``tests/test_torch_hyperbolic_headline_train.py``: JAX holds the fused
epoch with EST to its per-step ``train_step``,
``tests/test_hyperbolic_model.py:314``); epoch 1, from the state after
epoch 0 (whose Adam moments damp the rounding noise of zero-gradient
parameters), with triple batches of 32
rows (two chunks of real triples and two all-masked ones a snapshot) in
mode ``accumulate`` and in mode ``per_chunk``; the analysis record of the
initial state. Tolerances:

- the dual optimizer alone, 3 steps on the same gradients with points
  near the ball's edge: every parameter and Adam moment within rtol 1e-5
  / atol 1e-6 of optax's, 1e-4 of lr = 1e-2 (fp32, the same operations
  but for the summation order of a row's norm and the bias corrections'
  powers, which optax takes in fp32);
- a step or an epoch: the (mean) losses within rtol 1e-4 / atol 1e-5;
  every parameter, BN statistic, H-PES memory and the Riemannian moments
  of ``dynamic_emb`` within atol 1e-5 + rtol 1e-3, far below lr = 1e-3.
  As in config 5's tests, the parameters whose true gradient is 0 (each
  ConvTrans decoder's ``conv_b`` and ``fc_b``, the QCHHE attention's
  ``attn_proj_b``; ``radius_mlp`` on a one-snapshot window) are moved by
  rounding noise in both packages, by up to lr: their values, and the BN
  running means after ``conv_b`` and ``fc_b``, are not compared where
  that noise entered them, and the port's gradient of each is held to
  1e-6 of the step's largest;
- the analysis records: the same keys, each value within rtol 1e-5 (a
  gradient norm's absolute floor 1e-7, for the norms of zero-gradient
  parameters that are rounding noise);
- the ball-space layer and ``evolve(tangent_fast=False)`` against JAX:
  values within rtol 1e-4 / atol 1e-5, gradients within rtol 1e-3 / atol
  1e-5; against the port's own tangent carry within rtol 2e-4 / atol 2e-5,
  the tolerance of JAX's equivalence test of the two paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_hyperbolic_headline_train import fused_steps

from regcn_tpu.config import ExperimentConfig as JaxExperimentConfig
from regcn_tpu.config import ModelConfig as JaxModelConfig
from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.hyperbolic import layers as JL
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic.optim import dual_optimizer as jax_dual_optimizer
from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxTrainer
from regcn_tpu.train import loop as jax_loop
from regcn_tpu.train.state import create_train_state as jax_create_train_state
from regcn_tpu.utils import profiling as jax_profiling
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.convert import hyperbolic_params_from_jax, train_state_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import layers as PL
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic import ops as PH
from regcn_torch.hyperbolic import train as pt_hyp_train
from regcn_torch.hyperbolic.optim import RiemannianDualAdam, manifold_mask
from regcn_torch.hyperbolic.train import HyperbolicTrainer, compute_radius_targets
from regcn_torch.train import loop as pt_loop
from regcn_torch.train.optim import AdamState, tree_leaves

# 6 training snapshots: 5 steps per epoch, the windows of i = 1 and 2 short
TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
EST = dict(use_est=True, use_time_aware_negative=True, est_encoder="gru", est_history_len=4,
           est_state_alpha=0.2)
# 60 real triples (inverses included) padded to 128: chunks of 32 give two
# with real rows and two all-masked ones. Windows of 1 and 2 snapshots
# keep JAX's compilations (one per window length and step function) few
TC = dict(n_epochs=2, lr=1e-3, train_history_len=2, test_history_len=2, edge_bucket=32,
          rc_bucket=64, triple_bucket=128)
CHUNK = 32
STEPS = 5
RTOL, ATOL = 1e-4, 1e-5
HELD = {f"['{dec}']['{b}']" for dec in ("decoder_ob", "decoder_rel")
        for b in ("conv_b", "fc_b")} | {"['est']['attn_proj_b']"}
RADIUS_MLP = {"['radius_mlp_w']", "['radius_mlp_b']"}
HELD_BN = {f"{dec}['{bn}']['mean']" for dec in ("bn_ob", "bn_rel") for bn in ("bn1", "bn2")}
MODES = ["accumulate", "per_chunk"]


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


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def configs(data, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=8, n_layers=2,
                encoder="hyperbolic_uvrgcn", decoder="hyperbolic_convtranse", c=0.01,
                manifold_entities=True, **NO_DROPOUT, **EST)
    base.update(kw)
    return (JM.HyperbolicConfig(**base), JaxTrainConfig(**TC), PM.HyperbolicConfig(**base),
            TrainConfig(**TC))


def trainer_of(data, **kw):
    _, _, pcfg, ptc = configs(data)
    return HyperbolicTrainer(pcfg, ptc, data, device="cpu", **kw)


def host_copy(tree):
    """numpy copies: JAX's steps donate their input state's buffers."""
    return jax.tree.map(lambda a: np.array(a), tree)


def device_copy(tree):
    return jax.tree.map(jnp.asarray, tree)


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


# ------------------------------------------------------- the optimizer

def test_dual_optimizer_step_matches_optax():
    """Three steps of ``dual_optimizer(manifold_entities=True)`` and the
    port's ``RiemannianDualAdam`` on the same gradients: points near the
    ball's edge among the entities, a gradient norm above the clip."""
    c, lr, grad_norm, wd = 0.01, 1e-2, 1.0, 1e-3
    rng = np.random.default_rng(5)
    tangent = rng.normal(size=(20, 8)).astype(np.float32)
    tangent[:5] *= 40.0  # exp_0 of these lies within 1e-6 of the edge 1/sqrt(c) = 10
    params = {"dynamic_emb": np.asarray(JM.H.exp_map_zero(jnp.asarray(tangent), c)),
              "emb_rel": rng.normal(size=(6, 8)).astype(np.float32),
              "rgcn": {"layers": [{"w": rng.normal(size=(8, 8)).astype(np.float32)}]}}
    radius = np.linalg.norm(params["dynamic_emb"], axis=-1)
    assert radius.max() > 10.0 - 1e-3
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
             for _ in range(3)]
    opt = jax_dual_optimizer(lr, c, grad_norm, wd, manifold_entities=True)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = opt.init(jp)
    ours = RiemannianDualAdam(lr, c, grad_norm, wd)
    tp = jax.tree.map(torch.from_numpy, params)
    leaves = tree_leaves(tp)
    state = ours.init(leaves)
    state.manifold = manifold_mask(tp)
    assert state.manifold == [True, False, False]
    for g in grads:
        updates, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        ours.step(leaves, tree_leaves(jax.tree.map(torch.from_numpy, g)), state)
        for name, got, want in zip(paths(tp), leaves, tree_leaves(jax.tree.map(np.asarray, jp))):
            close(got, want, rtol=1e-5, atol=1e-6, msg=name)
    moments = train_state_like(jstate, tp)
    assert moments.count == state.count == 3 and moments.manifold == state.manifold
    for a, b in zip(state.mu + state.nu, moments.mu + moments.nu):
        close(a, b, rtol=1e-5, atol=1e-6)


def train_state_like(jstate, params):
    """The port's AdamState from an optax dual-optimizer state, through
    ``train_state_from_jax``."""

    @dataclasses.dataclass
    class Fake:
        params: dict
        opt_state: object
        model_state: object
        step: int = 0

    @dataclasses.dataclass
    class FakeModelState:
        bn_ob: dict
        bn_rel: dict
        radius_target: np.ndarray

    fake = Fake(params=jax.tree.map(lambda t: t.numpy(), params),
                opt_state=jax.tree.map(np.asarray, jstate),
                model_state=FakeModelState({}, {}, np.zeros(1, np.float32)))
    return train_state_from_jax(fake, device="cpu").opt_state


# ---------------------------------------------------------------- the runs

@pytest.fixture(scope="module")
def jax_run(data):
    """JAX with ``manifold_entities``: epoch 0 step by step (window index,
    state before, losses, state after); epoch 1 in each triple-batching
    mode from the state after epoch 0 (the state after, the mean losses);
    the initial state's analysis record, with every parameter's norm."""
    jcfg, jtc, _, _ = configs(data)
    trainer = JaxTrainer(jcfg, jtc, data)
    init = host_copy(trainer.init_state(jax.random.PRNGKey(0)))
    steps = fused_steps(trainer, init, trainer_of(data).epoch_order(0))
    chunked, after0 = {}, steps[-1][3]
    for mode in MODES:
        tr = JaxTrainer(jcfg, jtc, data, triple_batch_size=CHUNK, triple_batch_mode=mode)
        state, mean = tr.run_epoch(device_copy(after0), 1)
        chunked[mode] = (host_copy(state), mean)
    with pytest.MonkeyPatch.context() as mp:
        every_norm(mp, jax_profiling)
        analysis = trainer.analysis_record(device_copy(init), 0)
    return dict(init=init, steps=steps, chunked=chunked, analysis=analysis)


def assert_state_close(state, want, skip=frozenset(), rtol=1e-3, atol=1e-5):
    """Parameters (but ``skip``), BN statistics (but ``HELD_BN`` where
    ``skip`` holds the decoders' biases), the H-PES memories and the
    Riemannian moments of ``dynamic_emb`` against a JAX state."""
    params = keyed(want.params)
    for path, got in zip(paths(state.params), tree_leaves(state.params)):
        if path not in skip:
            close(got, params[path], rtol=rtol, atol=atol, msg=path)
    for bn in ("bn_ob", "bn_rel"):
        got_bn, want_bn = getattr(state.model_state, bn), keyed(getattr(want.model_state, bn))
        for path, got in zip(paths(got_bn), tree_leaves(got_bn)):
            if not (skip and f"{bn}{path}" in HELD_BN):
                close(got, want_bn[path], rtol=rtol, atol=atol, msg=f"{bn}{path}")
    for memory in ("fast", "slow"):
        close(getattr(state.est_state, memory), getattr(want.est_state, memory), rtol=rtol,
              atol=atol, msg=memory)
    converted = train_state_from_jax(want, device="cpu")
    k = paths(state.params).index("['dynamic_emb']")
    assert state.opt_state.manifold == converted.opt_state.manifold
    assert state.opt_state.manifold[k] and sum(state.opt_state.manifold) == 1
    assert state.opt_state.count == converted.opt_state.count
    for moment in ("mu", "nu"):
        close(getattr(state.opt_state, moment)[k], getattr(converted.opt_state, moment)[k],
              rtol=rtol, atol=atol, msg=f"dynamic_emb {moment}")


def recording(trainer, state, watch):
    """Wraps ``trainer.opt.step`` to record, per optimizer step, each
    watched parameter's largest gradient entry over the step's largest."""
    names, step, seen = paths(state.params), trainer.opt.step, []

    def recording_step(params, grads, opt_state):
        largest = max(g.abs().max().item() for g in grads if g is not None)
        seen.append({n: (0.0 if g is None else g.abs().max().item() / largest)
                     for n, g in zip(names, grads) if n in watch})
        step(params, grads, opt_state)

    trainer.opt.step = recording_step
    return seen


def test_epoch_0_with_manifold_entities_matches_jax_train_step(data, jax_run):
    """Each of epoch 0's steps from JAX's state before it: the losses, every
    parameter, the retracted ``dynamic_emb`` on the ball, its Riemannian
    moments and the H-PES memories after it."""
    trainer = trainer_of(data)
    for i, before, want_losses, after in jax_run["steps"]:
        state = train_state_from_jax(before, device="cpu")
        assert state.opt_state.manifold == manifold_mask(state.params)
        held = HELD | (RADIUS_MLP if trainer.window(i)[0].src.shape[0] == 1 else set())
        seen = recording(trainer, state, held)
        losses = trainer.train_step(state, *trainer.window(i), trainer._curvature_max(0),
                                    *trainer.est_window(i))
        for k, w in want_losses.items():
            np.testing.assert_allclose(float(losses[k]), w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"step on snapshot {i}: {k}")
        assert all(v <= 1e-6 for v in seen[0].values()), (i, seen)
        norms = torch.linalg.vector_norm(state.params["dynamic_emb"], dim=-1)
        assert norms.max() < 1.0 / 0.01 ** 0.5
        assert_state_close(state, after, skip=held)


@pytest.mark.parametrize("mode", MODES)
def test_triple_batching_epoch_matches_jax(data, jax_run, mode):
    """Epoch 1 with triple batches of 32 from JAX's state after epoch 0,
    EST's retrieval batch sliced and the TANS COO rebuilt per chunk,
    all-masked chunks skipped: the mean losses, the steps taken and the
    state after."""
    trainer = trainer_of(data, triple_batch_size=CHUNK, triple_batch_mode=mode)
    state = train_state_from_jax(jax_run["steps"][-1][3], device="cpu")
    chunks = {i: len(trainer.chunks(i)) for i in trainer.epoch_order(1)}
    assert set(chunks.values()) == {2}
    seen = recording(trainer, state, HELD)
    got = trainer.run_epoch(state, 1)
    want_state, want_losses = jax_run["chunked"][mode]
    steps = STEPS if mode == "accumulate" else sum(chunks.values())
    assert state.step - STEPS == state.opt_state.count - STEPS == steps
    assert state.step == int(want_state.step)
    assert len(seen) == steps and all(v <= 1e-6 for s in seen for v in s.values()), seen
    for k, w in want_losses.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL, err_msg=k)
    assert_state_close(state, want_state, skip=HELD)


def every_norm(monkeypatch, *modules):
    """Makes each module's ``gradient_stats`` keep every parameter's norm:
    the record's 10 largest can swap places at a near tie between
    packages, so the records are compared on all of them."""
    for module in modules:
        stats = module.gradient_stats
        monkeypatch.setattr(module, "gradient_stats",
                            lambda *a, _stats=stats, **kw: _stats(*a, top_k=1000, **kw))


def assert_records_close(got, want, n_params):
    assert set(got) == set(want)
    assert sum(k.startswith("[") for k in got) == n_params
    for k, w in want.items():
        atol = 1e-7 if k.startswith("[") or k == "global_norm" else 0.0
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=atol, err_msg=k)


def assert_top_10(record, full):
    """The default record holds the global norm and the 10 largest of
    ``full``'s norms."""
    norms = sorted((v for k, v in full.items() if k.startswith("[")), reverse=True)
    top = {k: v for k, v in record.items() if k.startswith("[")}
    assert len(top) == 10 and record["global_norm"] == full["global_norm"]
    assert all(full[k] == v for k, v in top.items()) and min(top.values()) == norms[9]


def test_hyperbolic_analysis_record_matches_jax(data, jax_run, monkeypatch):
    """``HyperbolicTrainer.analysis_record`` of the initial state: every
    parameter's gradient norm by name, entity norms, static radii,
    curvature; the state's generator untouched; ``fit`` keeps one a row."""
    trainer = trainer_of(data, run_analysis=True)
    state = train_state_from_jax(jax_run["init"], device="cpu")
    gen = state.gen.get_state()
    record = trainer.analysis_record(state, 0)
    with monkeypatch.context() as m:
        every_norm(m, pt_hyp_train)
        got = trainer.analysis_record(state, 0)
    assert torch.equal(gen, state.gen.get_state())
    assert_records_close(got, jax_run["analysis"], len(tree_leaves(state.params)))
    assert_top_10(record, got)
    assert all(np.isfinite(v) for v in got.values())
    _, info = trainer.fit(state=state, n_epochs=1)
    assert len(info["history"][0]["analysis"]) == len(record) == 17


def test_regcn_analysis_record_matches_jax(data, monkeypatch):
    """``Trainer.analysis_record``: every parameter's gradient norm by name
    and the entity norms as JAX's, and a record in each row of ``fit``."""
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=8, n_layers=2,
                **NO_DROPOUT)
    tc = dict(TC, triple_bucket=64)
    jcfg = JaxExperimentConfig(model=JaxModelConfig(**base), train=JaxTrainConfig(**tc))
    pcfg = ExperimentConfig(model=ModelConfig(**base), train=TrainConfig(**tc))
    jstate = jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train)
    trainer = pt_loop.Trainer(pcfg, data, run_analysis=True, device="cpu")
    state = train_state_from_jax(host_copy(jstate), device="cpu")
    record = trainer.analysis_record(state)
    assert len(record) == 14  # the global norm, the 10 largest, 3 entity-norm statistics
    with monkeypatch.context() as m:
        every_norm(m, jax_profiling, pt_loop)
        want = jax_loop.Trainer(jcfg, data, run_analysis=True).analysis_record(jstate)
        got = trainer.analysis_record(state)
    assert_records_close(got, want, len(tree_leaves(state.params)))
    assert_top_10(record, got)
    pcfg1 = dataclasses.replace(pcfg, train=dataclasses.replace(pcfg.train, n_epochs=1))
    _, info = pt_loop.Trainer(pcfg1, data, run_analysis=True, device="cpu").fit(state=state)
    assert len(info["history"][0]["analysis"]) == 14


# ------------------------------------------------------ the ball-space layer

def ball_init(data, **kw):
    jcfg, _, pcfg, _ = configs(data, use_est=False, use_time_aware_negative=False,
                               manifold_entities=False, skip_connect=True, **kw)
    rt = compute_radius_targets(pt_snapshots.split_by_time(data.train), data.num_nodes)
    params, state = JM.init_params(jax.random.PRNGKey(0), jcfg, rt)
    params, state = jax.tree.map(np.asarray, (params, state))
    converted = hyperbolic_params_from_jax(params, state, device="cpu")
    return jcfg, pcfg, jax.tree.map(jnp.asarray, (params, state)), converted


def history(data, start=2, length=3):
    window = pt_snapshots.split_by_time(data.train)[start:start + length]
    host = pt_snapshots.build_history(window, data.num_nodes, data.num_rels, edge_bucket=32,
                                      rc_bucket=64)
    jx = jax_snapshots.Snapshot(
        **{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
        num_edges=host.num_edges, num_triples=host.num_triples, dst_sorted=host.dst_sorted)
    return host.to("cpu"), jx


def test_hyperbolic_union_layer_matches_jax(data):
    """The second layer (with its skip gate) on ball points: values, and
    the gradients of the points, the previous layer's points and every
    layer parameter, the radius weight's among them (B1's dw)."""
    _, _, (jp, _), (cp, _) = ball_init(data)
    pt_hist, jx_hist = history(data, length=1)
    rng = np.random.default_rng(4)
    h = np.asarray(JM.H.exp_map_zero(jnp.asarray(rng.normal(size=(data.num_nodes, 8))
                                                 .astype(np.float32)), 0.01))
    prev = np.asarray(JM.H.exp_map_zero(jnp.asarray(rng.normal(size=(data.num_nodes, 8))
                                                    .astype(np.float32)), 0.01))
    probe = rng.normal(size=(data.num_nodes, 8)).astype(np.float32)
    jlayer, jrel = jp["rgcn"]["layers"][1], jp["emb_rel"]
    jsnap = jax.tree.map(lambda a: a[0], jx_hist)

    def jax_fn(lp, x, pv):
        out = JL.hyperbolic_union_layer(lp, x, jrel, jsnap, 0.01, prev_h=pv)
        return jnp.sum(out * probe), out

    (jg_p, jg_h, jg_prev), want = jax.jit(jax.grad(jax_fn, argnums=(0, 1, 2), has_aux=True))(
        jlayer, jnp.asarray(h), jnp.asarray(prev))
    lp = {k: v.clone().requires_grad_(True) for k, v in cp["rgcn"]["layers"][1].items()}
    x, pv = (torch.from_numpy(a).requires_grad_(True) for a in (h, prev))
    out = PL.hyperbolic_union_layer(lp, x, cp["emb_rel"], pt_hist.step(0), 0.01, prev_h=pv)
    close(out, want)
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(probe)),
                                [x, pv] + list(lp.values()))
    close(grads[0], jg_h, rtol=1e-3)
    close(grads[1], jg_prev, rtol=1e-3)
    for (name, _), g in zip(lp.items(), grads[2:]):
        close(g, jg_p[name], rtol=1e-3, msg=name)


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "apply_radius"])
def test_ball_space_evolve_matches_jax_and_the_tangent_carry(data, residual):
    """``evolve(tangent_fast=False)`` routes the uvrgcn to its ball-space
    layer: every step's points against JAX's ball path, the final points'
    gradient of each parameter against JAX's, and the port's tangent
    carry within the tolerance of JAX's equivalence test. Without the
    residual radius evolution every entity sits at its target radius, so
    entities of one target meet on the kink of |r_src - r_dst|, tied to
    the last bit in one package and one rounding apart in the other: the
    gradient there depends on that rounding, and that case compares
    values only."""
    jcfg, pcfg, (jp, _), (cp, _) = ball_init(data, use_residual_evolution=residual)
    pt_hist, jx_hist = history(data)
    rng = np.random.default_rng(6)
    probe = rng.normal(size=(data.num_nodes, 8)).astype(np.float32)

    def jax_fn(p):
        h, h0, _, all_h = JM.evolve(p, jcfg, jx_hist, return_all=True, tangent_fast=False)
        return jnp.sum(h * probe) + jnp.sum(h0 ** 2), (h, h0, all_h)

    want_grads, want = jax.jit(jax.grad(jax_fn, has_aux=True))(jp)
    cp = jax.tree.map(lambda t: t.clone().requires_grad_(True), cp)
    h, h0, _, all_h = PM.evolve(cp, pcfg, pt_hist, return_all=True, tangent_fast=False)
    for name, g, w in zip(("h", "h0", "all_h"), (h, h0, all_h), want):
        close(g, w, msg=name)
    if residual:
        total = torch.sum(h * torch.from_numpy(probe)) + torch.sum(h0 ** 2)
        grads = torch.autograd.grad(total, tree_leaves(cp), allow_unused=True)
        wg = keyed(want_grads)
        for name, g in zip(paths(cp), grads):
            if g is None:
                assert not np.any(wg[name]), name
            else:
                close(g, wg[name], rtol=1e-3, msg=name)
    with torch.no_grad():
        fast = PM.evolve(cp, pcfg, pt_hist, return_all=True)
    for name, f, b in zip(("h", "h0", "all_h"), (fast[0], fast[1], fast[3]), (h, h0, all_h)):
        close(f, b.detach(), rtol=2e-4, atol=2e-5, msg=name)
    assert torch.all(PH.get_radius(h) < 1.0 / 0.01 ** 0.5)
