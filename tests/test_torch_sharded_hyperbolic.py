"""The port's entity-sharded hyperbolic trainer on gloo ranks, against the
unsharded port and regcn_tpu's sharded trainer.

One spawn of G = 2 and one of G = 4 CPU processes (a ``torch.distributed``
gloo group over a file store, a ``("data", "graph")`` mesh of 1 x G) runs
every case below in both ``dist_agg`` modes; the ranks write their results
and this process compares them with the unsharded port, run here once per
module. Torch runs on one thread in every rank, fp32, every dropout 0, on
40 entities at h = 16, from JAX's initial states converted
(``regcn_torch/convert.py``) and sliced per rank. This module imports JAX
inside its fixtures only, so that the spawned ranks, which import it to
find their entry point, load no JAX.

The configurations: the headline (uvrgcn + tangent ConvTransE / R, with
the radius edge weight), config 3 (LGCN + RotH, learned c), config 4
(uvrgcn + AttH with learned and per-relation curvature and the entity
bias), and the FHNN and HGAT encoders with RotH. Tolerances:

- each encoder's cell on the rank's rows against the unsharded cell, and
  the headline's evolution with ``radius_static``'s gradient summed over
  the ranks: values and every gradient within rtol 1e-5, atol 1e-6 of the
  largest value (fp32 sums in another order);
- ``get_loss`` against the unsharded port: the losses within rtol 1e-4 /
  atol 1e-5, every gradient (the entity table's gathered) within rtol
  1e-3 / atol 1e-5;
- one epoch against the unsharded port from the same state, the
  unsharded trainer's after its epoch 0 (Adam moments that damp the
  rounding noise of near-zero gradients, as
  ``tests/test_torch_hyperbolic_train.py`` starts its epochs: from JAX's
  initial state Adam's first step moves each entry by lr times the sign
  of its gradient, rounding noise where the gradient is 0, as for the
  radius MLP on a one-snapshot window or a dead BatchNorm channel): the
  mean losses within rtol 1e-4, every parameter (the gathered table too)
  within atol 1e-5 + rtol 1e-3, but the ConvTrans decoders' ``conv_b``
  and ``fc_b``, whose true gradient is 0 and which Adam moves by rounding
  noise (``tests/test_torch_train.py``); the replicated leaves bit-equal
  on every rank;
- the test ranks of the unsharded trainer's state after that epoch,
  single-step and multi-step in both modes: the four MRRs
  within 1e-4 of the unsharded trainer's, the ranks equal but for at most
  1 % of the queries (near ties);
- the headline at G = 4 under ``"halo"`` against JAX's
  ``HyperbolicTrainer(mesh=make_mesh(MeshAxes(1, 4)), dist_agg="halo")``,
  one epoch from the same state then the valid split, as
  ``tests/test_halo_production.py`` runs it: the entity loss and MRR within
  2e-3, that file's limits;
- a checkpoint written sharded, restored unsharded and again sharded:
  every tensor equal;
- ``python -m regcn_torch.cli hyperbolic --shards 2`` with torchrun's
  variables set, in both modes, against the same command unsharded: the
  test MRRs within 1e-3;
- every refusal on a mesh raises JAX's error where JAX refuses (config 5,
  triple batching under ``"gspmd"`` and the static graph, refused until
  they were ported, run in ``tests/test_torch_sharded_est.py`` and
  ``tests/test_torch_sharded_static.py``; bf16 compute, ``run_analysis``
  and a data axis in ``tests/test_torch_sharded_options.py``).
"""

import copy
import dataclasses
import os
import pickle
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from regcn_torch.config import TrainConfig
from regcn_torch.data.snapshots import build_history
from regcn_torch.data.synthetic import generate
from regcn_torch.dist import sharded_impl
from regcn_torch.hyperbolic import layers as HL
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic import ops as H
from regcn_torch.hyperbolic.train import HyperbolicTrainer
from regcn_torch.parallel import sharding
from regcn_torch.parallel.collectives import all_gather_rows
from regcn_torch.parallel.mesh import MeshAxes, make_mesh
from regcn_torch.train import metrics
from regcn_torch.train import state as train_state
from regcn_torch.train.optim import AdamState, tree_leaves, tree_map
from test_torch_sharded_train import read_input, write_input

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
TC = dict(n_epochs=1, train_history_len=3, test_history_len=3, edge_bucket=32, rc_bucket=64,
          triple_bucket=64)
D = 16
MODES = ("gspmd", "halo")
CONFIGS = {
    "headline": dict(),
    "config3": dict(encoder="lgcn", decoder="roth", n_bases=4, learn_curvature=True),
    "config4": dict(decoder="atth", learn_curvature=True, use_rel_curvature=True,
                    use_entity_bias=True),
    "fhnn": dict(encoder="fhnn", decoder="roth", learn_curvature=True),
    "hgat": dict(encoder="hgat", decoder="roth", learn_curvature=True, num_heads=2),
}
ENCODERS = ("hyperbolic_uvrgcn", "lgcn", "fhnn", "hgat")
CASES = [(g, m) for g in (2, 4) for m in MODES]
# the ConvTrans decoders' biases before a batch-statistics BatchNorm
SHIFT_INVARIANT = {f"{dec}/{b}" for dec in ("decoder_ob", "decoder_rel")
                   for b in ("conv_b", "fc_b")}
CLI_ARGS = ["-d", "synthetic-small", "--n-epochs", "1", "--n-hidden", "16",
            "--train-history-len", "2", "--test-history-len", "2", "--dropout", "0",
            "--input-dropout", "0", "--hidden-dropout", "0", "--feat-dropout", "0"]
WINDOW = 4  # the training snapshot of the get_loss case


def data_of():
    return generate("synthetic-small", seed=123, **TINY)


def base_of(name, data) -> dict:
    return dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=2,
                **NO_DROPOUT, **CONFIGS[name])


def trainer_of(name, data, **kw) -> HyperbolicTrainer:
    return HyperbolicTrainer(PM.HyperbolicConfig(**base_of(name, data)), TrainConfig(**TC), data,
                             device="cpu", **kw)


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def blob_of(state) -> dict:
    """A TrainState as picklable values (a generator does not pickle)."""
    return {"params": tree_map(lambda t: t.detach().clone(), state.params),
            "mu": [t.clone() for t in state.opt_state.mu],
            "nu": [t.clone() for t in state.opt_state.nu], "count": state.opt_state.count,
            "step": state.step, "model_state": copy.deepcopy(state.model_state),
            "est": copy.deepcopy(state.est_state)}


def state_of(blob):
    gen = torch.Generator()
    gen.manual_seed(0)
    return train_state.TrainState(
        params=tree_map(lambda t: t.clone().requires_grad_(True), blob["params"]),
        opt_state=AdamState(count=blob["count"], mu=[t.clone() for t in blob["mu"]],
                            nu=[t.clone() for t in blob["nu"]]),
        model_state=copy.deepcopy(blob["model_state"]), gen=gen, step=blob["step"],
        est_state=copy.deepcopy(blob["est"]))


def cell_inputs(data):
    """Random ball points [N, d], relations [2R, d], a probe [N, d] and each
    encoder's cell parameters, from numpy's seed 7, and the window of
    training snapshot 3."""
    rng = np.random.default_rng(7)
    n, r2 = data.num_nodes, 2 * data.num_rels

    def normal(*shape, scale=0.3):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))

    c = torch.tensor(0.01)
    h = H.exp_map_zero(normal(n, D), c)
    cells = {enc: HL.init_encoder_cell(torch.Generator().manual_seed(3), enc, D, r2, 2,
                                       n_bases=4, num_heads=2)
             for enc in ENCODERS}
    return h, normal(r2, D), normal(n, D, scale=1.0), cells, c


def cell_out(enc, params, h, rel, snap, c, impl="xla"):
    if enc == "hyperbolic_uvrgcn":  # the headline's tangent carry
        return HL.uvrgcn_cell_tangent(params, H.log_map_zero(h, c), rel, snap, c, impl=impl)
    return HL.encoder_cell(params, enc, h, rel, snap, c, n_bases=4, num_heads=2, impl=impl)


def cell_grads(enc, params, h, rel, probe, snap, c, impl="xla"):
    """(out, the gradients of sum(out * probe) in h, rel and every parameter)."""
    leaves = [h.clone().requires_grad_(True), rel.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in tree_leaves(params)]
    tree = sharding._rebuild(params, leaves[2:])
    out = cell_out(enc, tree, leaves[0], leaves[1], snap, c, impl)
    return out.detach(), list(torch.autograd.grad((out * probe).sum(), leaves,
                                                  allow_unused=True))


def evolve_grads(params, cfg, history, probe):
    """(h, the gradients of sum(h * probe) in dynamic_emb and radius_static)."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    h, _ = PM.evolve(params, cfg, history)
    g = torch.autograd.grad((h * probe).sum(), [params["dynamic_emb"], params["radius_static"]])
    return h.detach(), list(g)


# ---------------------------------------------------------------- the ranks

def _rank_cells(mesh, mode, shard, data, inputs) -> dict:
    h, rel, probe, cells, c = inputs
    tc = TrainConfig(**TC)
    cfg = PM.HyperbolicConfig(**base_of("headline", data))
    snap = sharding.ShardedEval(cfg, tc, mode, shard, "cpu").window(
        split_train(data)[3:4]).step(0)
    impl = sharded_impl(mesh, mode)
    lo, hi = shard.row0, shard.row0 + shard.rows
    out = {}
    for enc in ENCODERS:
        got, grads = cell_grads(enc, cells[enc], h[lo:hi], rel, probe[lo:hi], snap, c, impl)
        # the loss is partitioned: the replicated inputs' gradients sum over ranks
        for g in grads[1:]:
            if g is not None:
                dist.all_reduce(g, group=shard.group)
        out[enc] = (got, grads)
    return out


def _rank_evolve(trainer, blob, probe) -> tuple:
    """The headline's evolution on the rank's rows, with radius_static's
    gradient summed over the ranks."""
    mine = sharding.shard_state(state_of(blob), trainer.shard)
    hist = trainer.window(WINDOW)[0]
    lo, hi = trainer.shard.row0, trainer.shard.row0 + trainer.shard.rows
    h, (g_emb, g_radius) = evolve_grads(mine.params, trainer.cfg, hist, probe[lo:hi])
    dist.all_reduce(g_radius, group=trainer.shard.group)
    return h, g_emb, g_radius


def _rank_get_loss(trainer, blob) -> dict:
    mine = sharding.shard_state(state_of(blob), trainer.shard)
    total, losses, _, _ = trainer.loss(mine, *trainer.window(WINDOW), trainer._curvature_max(0))
    rules = sharding.state_sharding_rules(mine)
    grads = sharding.sharded_grads(total, tree_leaves(mine.params), [not r for r in rules],
                                   trainer.shard)
    with torch.no_grad():
        whole = [all_gather_rows(g, trainer.shard.group) if r else g
                 for g, r in zip(grads, rules)]
    return {"losses": {k: float(v.detach()) for k, v in losses.items()}, "grads": whole}


def _rank_epoch(trainer, blob) -> tuple:
    """Epoch 1 from the unsharded trainer's state after epoch 0."""
    state = sharding.shard_state(state_of(blob), trainer.shard)
    losses = trainer.run_epoch(state, 1)
    whole = sharding.unshard_state(state, trainer.shard)
    rules = sharding.state_sharding_rules(state)
    return {"losses": losses,
            "params": [t.detach().clone() for t in tree_leaves(whole.params)],
            "replicated": [t.detach().clone() for t, r in zip(tree_leaves(state.params), rules)
                           if not r]}, state


def _rank_anchor(trainer, blob) -> dict:
    """Epoch 0 from JAX's initial state, then the valid split's MRRs."""
    state = sharding.shard_state(state_of(blob), trainer.shard)
    losses = trainer.run_epoch(state, 0)
    valid = trainer.evaluate(state, trainer.train_list, trainer.valid_list,
                             time_offset=len(trainer.train_list))
    return {"losses": losses, "valid_mrr": valid["ent_raw"].mrr}


def recorded_test(trainer, state, **kw):
    """(the four MRRs, the rank arrays) of ``trainer.test``."""
    seen = []
    stat_ranks = metrics.stat_ranks

    def recording(arrays, *a, **k):
        seen.append([np.asarray(r) for r in arrays])
        return stat_ranks(arrays, *a, **k)

    metrics.stat_ranks = recording
    try:
        stats = trainer.test(state, **kw)
    finally:
        metrics.stat_ranks = stat_ranks
    return {k: s.mrr for k, s in stats.items()}, seen


def _rank_checkpoint(trainer, state, workdir, tag="") -> bool:
    """Sharded -> unsharded -> sharded; True where every tensor came back
    (EST's memories too, where the state has them)."""
    shard = trainer.shard
    a, b = (os.path.join(workdir, f"ck-{tag}{trainer.dist_agg}-{x}") for x in "ab")
    train_state.save_checkpoint(a, state, {"epoch": 0}, shard=shard)
    gathered = sharding.unshard_state(state, shard)
    whole, meta = train_state.restore_checkpoint(a, gathered)

    def leaves(s):
        est = [] if s.est_state is None else tree_leaves(train_state.fields_of(s.est_state))
        return tree_leaves(s.params) + s.opt_state.mu + s.opt_state.nu + tree_leaves(
            train_state.fields_of(s.model_state)) + est

    ok = meta == {"epoch": 0} and all(torch.equal(x, y)
                                      for x, y in zip(leaves(whole), leaves(gathered)))
    if shard.rank == 0:
        train_state.save_checkpoint(b, whole, {"epoch": 0})
    dist.barrier(group=shard.group)
    back, _ = train_state.restore_checkpoint(b, state, shard)
    ok = ok and all(torch.equal(x, y) for x, y in zip(leaves(back), leaves(state)))
    return ok and back.opt_state.count == state.opt_state.count and back.step == state.step


def _rank_cli(G, mode, workdir, data) -> dict:
    import regcn_torch.data as pt_data
    from regcn_torch import cli

    pt_data.load_data = lambda *a, **k: data
    os.environ.update(RANK=str(dist.get_rank()), LOCAL_RANK=str(dist.get_rank()),
                      WORLD_SIZE=str(G), MASTER_ADDR="localhost", MASTER_PORT="1")
    return cli.main(["hyperbolic", *CLI_ARGS, "--shards", str(G), "--dist-agg", mode,
                     "--models-dir", os.path.join(workdir, f"cli-{mode}")], device="cpu")


def split_train(data):
    from regcn_torch.data.snapshots import split_by_time

    return split_by_time(data.train)


def rank_main(rank: int, G: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.nice(10)  # a helper of this test: the other test workers keep their CPU share
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=G,
                            rank=rank)
    init = read_input(workdir, "init")
    data = data_of()
    mesh = make_mesh(MeshAxes(1, G), device_type="cpu")
    cells = cell_inputs(data)
    results = {}
    for mode in MODES:
        res = {}
        for name in CONFIGS:
            trainer = trainer_of(name, data, mesh=mesh, dist_agg=mode)
            if name == "headline":
                res["cells"] = _rank_cells(mesh, mode, trainer.shard, data, cells)
                res["evolve"] = _rank_evolve(trainer, init[name], cells[2])
            res[name, "get_loss"] = _rank_get_loss(trainer, init[name])
            late = read_input(workdir, name)
            res[name, "epoch"], state = _rank_epoch(trainer, late["after0"])
            final = sharding.shard_state(state_of(late["final"]), trainer.shard)
            res[name, "test"] = recorded_test(trainer, final)
            res[name, "multi_step"] = recorded_test(trainer, final, multi_step=True, topk=3)
            if name == "headline":
                res["round_trip"] = _rank_checkpoint(trainer, state, workdir)
                if G == 4 and mode == "halo":
                    res["anchor"] = _rank_anchor(trainer, init[name])
        if G == 2:
            res["cli"] = _rank_cli(G, mode, workdir, data)
        results[mode] = res
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


# ------------------------------------------------------------- this process

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def host_copy(tree):
    import jax

    return jax.tree.map(lambda a: np.array(a), tree)


def jax_setup():
    """(JAX's data, configs and train config, its hyperbolic trainer class)."""
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.data.synthetic import generate as jax_generate
    from regcn_tpu.hyperbolic import model as JM
    from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxTrainer

    data = jax_generate("synthetic-small", seed=123, **TINY)
    return data, lambda name: JM.HyperbolicConfig(**base_of(name, data)), \
        JaxTrainConfig(**TC), JaxTrainer


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded trainer at G = 4 under ``"halo"`` on the headline and
    its initial state, ``PRNGKey(0)`` (JAX initialises alike with and
    without a mesh); the initial state of each configuration as numpy."""
    import jax

    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh

    data, config, tc, JaxTrainer = jax_setup()
    mesh = jax_make_mesh(JaxMeshAxes(1, 4), devices=jax.devices()[:4])
    trainer = JaxTrainer(config("headline"), tc, data, mesh=mesh, dist_agg="halo")
    state = trainer.init_state(jax.random.PRNGKey(0))
    inits = {name: host_copy(state if name == "headline" else
                             JaxTrainer(config(name), tc, data).init_state(jax.random.PRNGKey(0)))
             for name in CONFIGS}
    return trainer, state, inits


def jax_anchor(trainer, state) -> dict:
    """One epoch of JAX's sharded trainer from ``state``: its mean losses
    and the valid split's entity MRR after it."""
    state, losses = trainer.run_epoch(state, 0)
    valid = trainer.evaluate(state, trainer.train_list, trainer.valid_list)
    return {"losses": losses, "valid_mrr": valid["ent_raw"].mrr}


@pytest.fixture(scope="module")
def spawns(jax_runs, tmp_path_factory):
    """The spawns of G = 2 and G = 4, side by side, from JAX's converted
    initial states; each configuration's states after the unsharded epochs
    reach them later (``unsharded``)."""
    from regcn_torch.convert import train_state_from_jax

    init = {name: blob_of(train_state_from_jax(jax_runs[2][name], device="cpu"))
            for name in CONFIGS}
    out = {}
    for G in (2, 4):
        workdir = str(tmp_path_factory.mktemp(f"g{G}"))
        write_input(workdir, "init", init)
        out[G] = workdir, mp.start_processes(rank_main, args=(G, workdir), nprocs=G,
                                             join=False, start_method="spawn")
    return init, out


@pytest.fixture(scope="module")
def unsharded(spawns):
    """The unsharded port from JAX's converted initial states, while the
    ranks run: get_loss at WINDOW with every gradient, one epoch, the test
    ranks after it (single-step; the headline multi-step too), each cell
    and the headline's evolution; each configuration's states after its
    epochs go to the ranks."""
    data = data_of()
    out = {"init": spawns[0], "after0": {}, "final": {}}
    for name in CONFIGS:
        trainer = trainer_of(name, data)
        init = out["init"][name]
        state = state_of(init)
        total, losses, _, _ = trainer.loss(state, *trainer.window(WINDOW),
                                           trainer._curvature_max(0))
        grads = torch.autograd.grad(total, tree_leaves(state.params), allow_unused=True)
        out[name, "get_loss"] = {
            "losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": [torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads, tree_leaves(state.params))],
            "names": paths(state.params)}
        state = state_of(init)
        trainer.run_epoch(state, 0)
        out["after0"][name] = blob_of(state)
        out[name, "epoch"] = {"losses": trainer.run_epoch(state, 1),
                              "params": [t.detach().clone() for t in tree_leaves(state.params)]}
        out["final"][name] = blob_of(state)
        for workdir, _ in spawns[1].values():
            write_input(workdir, name, {k: out[k][name] for k in ("after0", "final")})
        out[name, "test"] = recorded_test(trainer, state)
        out[name, "multi_step"] = recorded_test(trainer, state, multi_step=True, topk=3)
        if name == "headline":
            h, rel, probe, cells, c = cell_inputs(data)
            snap = build_history(split_train(data)[3:4], data.num_nodes, data.num_rels,
                                 edge_bucket=TC["edge_bucket"],
                                 rc_bucket=TC["rc_bucket"]).to("cpu").step(0)
            out["cells"] = {enc: cell_grads(enc, cells[enc], h, rel, probe, snap, c)
                            for enc in ENCODERS}
            out["evolve"] = evolve_grads(state_of(init).params, trainer.cfg,
                                         trainer.window(WINDOW)[0], probe)
    return out


@pytest.fixture(scope="module")
def cli_unsharded(tmp_path_factory):
    import regcn_torch.data as pt_data
    from regcn_torch import cli

    data = data_of()
    workdir = str(tmp_path_factory.mktemp("cli"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pt_data, "load_data", lambda *a, **k: data)
        return cli.main(["hyperbolic", *CLI_ARGS, "--models-dir", workdir], device="cpu")


@pytest.fixture(scope="module")
def rank_results(unsharded, jax_runs, spawns):
    """Every rank's results, per (G, mode), and JAX's sharded anchor, which
    this process runs while the ranks do."""
    out = {"anchor": jax_anchor(*jax_runs[:2])}
    for G, (workdir, ctx) in spawns[1].items():
        while not ctx.join():
            pass
        ranks = []
        for r in range(G):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        for mode in MODES:
            out[G, mode] = [rk[mode] for rk in ranks]
    return out


def case_id(case):
    return f"G{case[0]}-{case[1]}"


def close_to_scale(got, want, msg=""):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * max(want.abs().max().item(), 1e-30), msg=msg)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_encoder_cells_and_their_gradients_match_unsharded(rank_results, unsharded, case):
    """The uvrgcn's tangent cell with its radius weight, LGCN, FHNN and HGAT
    on the rank's rows, and the headline's evolution with radius_static's
    gradient summed over ranks, against the unsharded port."""
    G = case[0]
    for rank, res in enumerate(rank_results[case]):
        lo, hi = rank * TINY["num_ents"] // G, (rank + 1) * TINY["num_ents"] // G
        for enc in ENCODERS:
            got, got_g = res["cells"][enc]
            want, want_g = unsharded["cells"][enc]
            close_to_scale(got, want[lo:hi], enc)
            for i, (g, w) in enumerate(zip(got_g, want_g)):
                if w is None:
                    assert g is None or not g.any(), (enc, i)
                    continue
                close_to_scale(g, w[lo:hi] if i == 0 else w, f"{enc} gradient {i}")
        h, g_emb, g_radius = res["evolve"]
        want_h, (want_emb, want_radius) = unsharded["evolve"]
        close_to_scale(h, want_h[lo:hi], "evolve")
        close_to_scale(g_emb, want_emb[lo:hi], "dynamic_emb")
        close_to_scale(g_radius, want_radius, "radius_static")


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_get_loss_and_every_gradient_match_unsharded(rank_results, unsharded, case, name):
    want = unsharded[name, "get_loss"]
    for res in rank_results[case]:
        got = res[name, "get_loss"]
        for k, w in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], w, rtol=1e-4, atol=1e-5, err_msg=k)
        for leaf, g, w in zip(want["names"], got["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-5, err_msg=leaf)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_epoch_and_test_ranks_match_unsharded(rank_results, unsharded, case, name):
    want = unsharded[name, "epoch"]
    names = unsharded[name, "get_loss"]["names"]
    for res in rank_results[case]:
        got = res[name, "epoch"]
        for k, w in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
        for leaf, a, b in zip(names, got["params"], want["params"]):
            if leaf not in SHIFT_INVARIANT:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5,
                                           err_msg=leaf)
        assert_ranks_match(res[name, "test"], unsharded[name, "test"])
    first = rank_results[case][0][name, "epoch"]["replicated"]
    for res in rank_results[case][1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, res[name, "epoch"]["replicated"]))


def assert_ranks_match(got, want, mrr_tol=1e-4):
    for k, w in want[0].items():
        assert abs(got[0][k] - w) <= mrr_tol, (k, got[0][k], w)
    a = np.concatenate([np.concatenate(x) for x in got[1]])
    b = np.concatenate([np.concatenate(x) for x in want[1]])
    assert a.shape == b.shape and np.mean(a != b) <= 0.01, np.mean(a != b)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_multi_step_test_matches_unsharded(rank_results, unsharded, case, name):
    """Multi-step in both modes: under ``"halo"`` each window's halo is
    rebuilt on the host, as JAX's trainer does."""
    for res in rank_results[case]:
        assert_ranks_match(res[name, "multi_step"], unsharded[name, "multi_step"])


def test_headline_halo_matches_jax_sharded_trainer(rank_results):
    want = rank_results["anchor"]
    for res in rank_results[4, "halo"]:
        got = res["anchor"]
        assert abs(got["losses"]["entity"] - float(want["losses"]["entity"])) < 2e-3
        assert abs(got["valid_mrr"] - want["valid_mrr"]) < 2e-3


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_checkpoint_round_trip_sharded_unsharded_sharded(rank_results, case):
    assert all(res["round_trip"] for res in rank_results[case])


@pytest.mark.parametrize("mode", MODES)
def test_cli_hyperbolic_shards(rank_results, cli_unsharded, mode):
    for res in rank_results[2, mode]:
        for k, w in cli_unsharded.items():
            for metric, v in w.items():
                assert abs(res["cli"][k][metric] - v) <= 1e-3, (k, metric)


FAKE_MESH = types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 2))
REFUSALS = {
    "halo-triple-batching": (dict(triple_batch_size=16, dist_agg="halo"), ValueError,
                             "triple_batch_size chunking is not supported"),
    "halo-without-mesh": (dict(mesh=None, dist_agg="halo"), ValueError, "requires a mesh"),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_on_a_mesh(what):
    """What the trainer refuses raises before any collective: where JAX's
    trainer refuses (the halo without a mesh or with triple batching), the
    port raises JAX's error."""
    import regcn_tpu.hyperbolic.model as JM
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxTrainer

    data = data_of()
    kw, error, match = REFUSALS[what]
    kw = dict(kw)
    cfg = dict(base_of("headline", data), **kw.pop("cfg", {}))
    kw.setdefault("mesh", FAKE_MESH)
    with pytest.raises(error, match=match):
        HyperbolicTrainer(PM.HyperbolicConfig(**cfg), TrainConfig(**TC), data, device="cpu",
                          **kw)
    if error is ValueError:
        with pytest.raises(error, match=match):
            JaxTrainer(JM.HyperbolicConfig(**cfg), JaxTrainConfig(**TC), data,
                       mesh=kw["mesh"] and object(), dist_agg=kw.get("dist_agg", "gspmd"),
                       triple_batch_size=kw.get("triple_batch_size"))
