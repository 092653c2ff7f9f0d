"""bf16 compute in the port's hyperbolic trainer against regcn_tpu's.

Both packages start from JAX's ``init_state(PRNGKey(0))``, converted, with
every dropout 0. Two bf16 runs round differently, so the port is held to
the drift JAX's own bf16 shows from JAX's fp32 (as in
``tests/test_torch_bf16.py``): for each loss, gradient, score table and
parameter, ``||port_bf16 - jax_fp32|| <= 2 ||jax_bf16 - jax_fp32|| + atol
ref`` (L2 norms), ref = ``||jax_fp32||`` with atol 1e-2, or for a
parameter after the 3 steps the distance JAX's fp32 run moved it, with
atol 0.5 (Adam moves an entry by about lr whatever its gradient's size);
each message carries the port-bf16 vs JAX-bf16 gap. A gradient leaf takes
atol 0.2: the two packages' forward passes round differently, and a leaf
that reads the forward's output directly (the decoders' first BatchNorm)
carries that difference, though on the same bf16 inputs the decoders'
gradients agree far closer; over the whole model the RMS of the leaves'
relative drifts is held at 2x JAX's + 1e-2. The gradient of a 0-d
parameter (config 3's ``log_c``) takes atol 0.5: it sums every term's
dependence on c, and at this size the entity and relation parts cancel to
2 % of their size, so bf16's error in the parts (~2 % in both packages)
is of the order of the sum itself.

- **The headline** (uvrgcn + tangent ConvTransE / R, fixed c) and **config
  3** (LGCN + RotH, learned curvature: JAX's strong fp32 scalar): the
  trainer's loss and every gradient, the eval scores (JAX's hyperbolic
  trainer evaluates in bf16 and returns fp32 scores, and so does the
  port), and 3 ``train_step``s. Config 3's RotH losses go through B2's
  plain version here, fed fp32 at its boundary; JAX's trainer takes the
  dense CE, so B2's boundary is also held against JAX's interpret-mode
  Pallas kernel on bf16 inputs (both cast them to fp32 first: rtol 1e-5).
- Parameters stay fp32 after the steps, as the JAX tests assert
  (``tests/test_hyperbolic_model.py``), and over
  3 epochs the port's bf16 loss falls and ends within rtol 0.05 of its
  fp32 loss (their criterion).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data.snapshots import pad_triples as jax_pad_triples
from regcn_tpu.hyperbolic import decoders as JD
from regcn_tpu.hyperbolic import model as JM
from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxTrainer
from regcn_torch.config import TrainConfig
from regcn_torch.convert import hyperbolic_params_from_jax
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import decoders as PD
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic.train import HyperbolicTrainer
from regcn_torch.train.optim import tree_leaves

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
TC = dict(lr=1e-3, train_history_len=2, test_history_len=2, edge_bucket=32, rc_bucket=64,
          triple_bucket=64)
MODELS = {
    "headline": dict(encoder="hyperbolic_uvrgcn", decoder="hyperbolic_convtranse", h_dim=16),
    "config3": dict(encoder="lgcn", decoder="roth", n_bases=4, h_dim=8, learn_curvature=True),
}
ORDER = (2, 3, 4)  # windows of 2 snapshots: one compile of JAX's step
DRIFT_ATOL = 1e-2
STEP_ATOL = 0.5
SCALAR_GRAD_ATOL = 0.5
LEAF_GRAD_ATOL = 0.2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=123, **TINY)


def assert_drift(port16, jax16, jax32, name, atol=DRIFT_ATOL, start=None):
    p, j, r = (np.asarray(x, np.float64) for x in (port16, jax16, jax32))
    e_p, e_j, gap = np.linalg.norm(p - r), np.linalg.norm(j - r), np.linalg.norm(p - j)
    ref = np.linalg.norm(r if start is None else r - np.asarray(start, np.float64))
    msg = (f"{name}: |port16-jax32| {e_p:.3e}, |jax16-jax32| {e_j:.3e}, "
           f"|port16-jax16| {gap:.3e}, ref {ref:.3e}")
    print(msg)
    assert e_p <= 2.0 * e_j + atol * ref, msg
    return e_p, e_j


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def by_path(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def configs(data, model, dtype):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, n_layers=2,
                compute_dtype=dtype, **NO_DROPOUT)
    base.update(MODELS[model])
    return (JM.HyperbolicConfig(**base), JaxTrainConfig(**TC), PM.HyperbolicConfig(**base),
            TrainConfig(**TC))


def jax_window(trainer, i):
    lo = max(0, i - TC["train_history_len"])
    history = trainer._history(trainer.train_list[lo:i])
    triples, mask = jax_pad_triples(trainer.train_list[i], trainer.num_rels,
                                    TC["triple_bucket"])
    return history, jnp.asarray(triples), jnp.asarray(mask)


def jax_train_step(trainer, grad_fn, state, window, cmax):
    """JAX's ``train_step`` (dropouts 0, no EST) in its two parts: the
    loss's gradient, brought to fp32 for the optimizer, then the
    optimizer's update (``apply_accumulated``: ``opt.update`` and
    ``apply_updates``, as ``train_step`` applies them) and the new BN
    statistics: (new state, fp32 losses)."""
    from regcn_tpu.utils.dtypes import tree_to_fp32

    grads, (losses, model_state, _) = grad_fn(state.params, state.model_state, *window,
                                              jax.random.PRNGKey(1), cmax, None, None)
    state = trainer.apply_accumulated(state, tree_to_fp32(grads))
    return dataclasses.replace(state, model_state=model_state), tree_to_fp32(losses)


@pytest.fixture(scope="module", params=sorted(MODELS))
def hyperbolic_runs(request, data):
    """Per compute dtype, JAX's loss and gradients on window 4, its eval
    scores on that window and its parameters after 3 steps; the port's
    bf16 counterparts from the same initial state."""
    model = request.param
    out = {}
    for dt in ("float32", "bfloat16"):
        jcfg, jtc, pcfg, ptc = configs(data, model, dt)
        trainer = JaxTrainer(jcfg, jtc, data)
        state = trainer.init_state(jax.random.PRNGKey(0))
        init = jax.tree.map(np.asarray, (state.params, state.model_state))
        cmax = jnp.asarray(trainer._curvature_max(0), jnp.float32)
        history, triples, mask = jax_window(trainer, 4)
        # one compile of the loss's gradient serves the window-4 case and
        # the steps (every window of ORDER has window 4's shapes)
        grad_fn = jax.jit(jax.grad(trainer._loss_fn, has_aux=True))
        grads, (losses, _, _) = grad_fn(state.params, state.model_state, history, triples, mask,
                                        jax.random.PRNGKey(1), cmax, None, None)
        scores = trainer.predict_step(state, history, triples, mask)
        run = dict(losses=jax.tree.map(float, losses), scores=jax.tree.map(np.asarray, scores),
                   grads=jax.tree.map(lambda a: np.asarray(a, np.float32), grads), init=init)
        step_losses = []
        for i in ORDER:
            state, ls = jax_train_step(trainer, grad_fn, state, jax_window(trainer, i), cmax)
            step_losses.append(jax.tree.map(float, ls))
        run.update(step_losses=step_losses, params=jax.tree.map(np.asarray, state.params))
        out[f"jax_{dt}"] = run
        if dt == "bfloat16":
            port = HyperbolicTrainer(pcfg, ptc, data, device="cpu")
            pstate = port.state_from(*hyperbolic_params_from_jax(*init, device="cpu"))
            pcmax = port._curvature_max(0)
            total, plosses, _, _ = port.loss(pstate, *port.window(4), pcmax)
            pgrads = torch.autograd.grad(total, tree_leaves(pstate.params), allow_unused=True)
            history, triples, mask = port.window(4)
            with torch.inference_mode():
                pscores = port._predict()(pstate.params, pstate.model_state, pcfg, history,
                                          triples, mask)
            psteps = [port.train_step(pstate, *port.window(i), pcmax) for i in ORDER]
            out["port"] = dict(losses=plosses, grads=pgrads, scores=pscores, steps=psteps,
                               state=pstate)
    return model, out


def test_loss_and_gradients_track_jax_bf16(hyperbolic_runs):
    model, runs = hyperbolic_runs
    j32, j16, port = runs["jax_float32"], runs["jax_bfloat16"], runs["port"]
    for k in ("entity", "relation", "static", "radius"):
        assert port["losses"][k].dtype == torch.float32
        assert_drift(port["losses"][k].item(), j16["losses"][k], j32["losses"][k],
                     f"{model} loss {k}")
    rel_p, rel_j = [], []
    state = port["state"]
    for path, g in zip(paths(state.params), port["grads"]):
        if g is None:  # no gradient in either package (JAX's is 0)
            assert not np.any(by_path(j16["grads"], path)), path
            continue
        assert g.dtype == torch.float32, path
        want = by_path(j32["grads"], path)
        e_p, e_j = assert_drift(g.numpy(), by_path(j16["grads"], path), want,
                                f"{model} grad {path}",
                                atol=SCALAR_GRAD_ATOL if g.dim() == 0 else LEAF_GRAD_ATOL)
        ref = np.linalg.norm(want)
        if g.dim() and ref > 1e-6:  # leaves whose true gradient is ~0 have no scale
            rel_p.append(e_p / ref)
            rel_j.append(e_j / ref)
    # over the whole model each leaf's relative drift counts once
    p_rms, j_rms = np.sqrt(np.mean(np.square(rel_p))), np.sqrt(np.mean(np.square(rel_j)))
    print(f"{model}: relative gradient drift, RMS over leaves: port {p_rms:.3e}, JAX {j_rms:.3e}")
    assert p_rms <= 2.0 * j_rms + DRIFT_ATOL, (model, p_rms, j_rms)
    assert p_rms >= 0.1 * j_rms, (model, "the port's bf16 barely moves from fp32", p_rms)


def test_eval_scores_track_jax_bf16(hyperbolic_runs):
    """JAX's hyperbolic ``predict_step`` runs the model in bf16 and returns
    fp32 scores; the port's evaluation does the same."""
    model, runs = hyperbolic_runs
    j32, j16, port = runs["jax_float32"], runs["jax_bfloat16"], runs["port"]
    for k, (got, w16, w32) in enumerate(zip(port["scores"], j16["scores"], j32["scores"])):
        assert got.dtype == torch.float32 and w16.dtype == np.float32
        assert_drift(got.numpy(), w16, w32, f"{model} scores {('entity', 'relation')[k]}")


def test_three_steps_track_jax_bf16(hyperbolic_runs):
    model, runs = hyperbolic_runs
    j32, j16, port = runs["jax_float32"], runs["jax_bfloat16"], runs["port"]
    for s, (got, w16, w32) in enumerate(zip(port["steps"], j16["step_losses"],
                                            j32["step_losses"])):
        for k in ("entity", "relation", "radius"):
            assert_drift(got[k].item(), w16[k], w32[k], f"{model} step {s} {k}")
    state, init = port["state"], runs["jax_float32"]["init"][0]
    for path, p in zip(paths(state.params), tree_leaves(state.params)):
        assert p.dtype == torch.float32, path
        assert_drift(p.detach().numpy(), by_path(j16["params"], path),
                     by_path(j32["params"], path), f"{model} {path}", atol=STEP_ATOL,
                     start=by_path(init, path))


@pytest.mark.parametrize("true_dist", [False, True], ids=["proxy", "true"])
def test_b2_boundary_against_interpret_mode_pallas(true_dist):
    """The RotH loss's CE on bf16 queries and candidates: both packages cast
    them (and the bias, c, scale and margin) to fp32 at the kernel's
    boundary, so the loss and its gradients agree to fp32 rounding and the
    gradients come back in the inputs' dtype."""
    rng = np.random.default_rng(11)
    B, N, d = 24, 40, 8
    q = np.asarray(jnp.asarray(rng.normal(size=(B, d)) * 0.3, jnp.bfloat16), np.float32)
    x = np.asarray(jnp.asarray(rng.normal(size=(N, d)) * 0.3, jnp.bfloat16), np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    target = rng.integers(0, N, B)
    mask = (rng.uniform(size=B) < 0.8).astype(np.float32)
    kw = dict(use_hyperbolic_distance=true_dist, score_margin=1.0)

    def jax_fn(jq, jx):
        with pltpu.force_tpu_interpret_mode():
            return JD.dist_ce_loss(jq, jx, jnp.asarray(target), 0.5, mask=jnp.asarray(mask),
                                   candidate_bias=jnp.asarray(bias), streaming=True, **kw)

    want, (gq, gx) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    tq, tx = (torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (q, x))
    got = PD.dist_ce_loss(tq, tx, torch.from_numpy(target), 0.5, mask=torch.from_numpy(mask),
                          candidate_bias=torch.from_numpy(bias), **kw)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    pq, px = torch.autograd.grad(got, (tq, tx))
    for name, a, b in (("dq", pq, gq), ("dx", px, gx)):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        b = np.asarray(b, np.float32)
        # the same fp32 gradient rounded to bf16 once: one ulp
        np.testing.assert_allclose(a.float().numpy(), b, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(b).max(), err_msg=name)


# ---------------------------------------------------------- 3-epoch tracks

@pytest.mark.parametrize("family", ["headline", "config3"])
def test_bf16_tracks_fp32_over_three_epochs(data, family):
    """JAX's own criterion: the loss falls, the parameters stay fp32, and
    the last epoch's entity loss is within rtol 0.05 of the fp32 run's."""
    last = {}
    for dt in ("float32", "bfloat16"):
        _, _, pcfg, ptc = configs(data, family, dt)
        trainer = HyperbolicTrainer(pcfg, ptc, data, device="cpu")
        state = trainer.init_state(0)
        losses = [trainer.run_epoch(state, e)["entity"] for e in range(3)]
        assert losses[-1] < losses[0], (dt, losses)
        assert all(p.dtype == torch.float32 for p in tree_leaves(state.params))
        last[dt] = losses[-1]
    np.testing.assert_allclose(last["bfloat16"], last["float32"], rtol=0.05)
