"""The port's entity-sharded HisRES trainer on gloo ranks, against the
unsharded port and regcn_tpu's sharded trainer.

One spawn of G = 2 and one of G = 4 CPU processes (a ``torch.distributed``
gloo group over a file store, a ``("data", "graph")`` mesh of 1 x G) runs
every case below in both ``dist_agg`` modes, side by side; the ranks write
their results and this process compares them with the unsharded port, run
here once per module. Torch runs on one thread in every rank, fp32, every
dropout 0 (``cand_dropout`` too), on 40 entities at h = 8, from JAX's
initial state converted (``regcn_torch/convert.py``) and sliced per rank.
This module imports JAX inside its fixtures only, so that the spawned
ranks, which import it to find their entry point, load no JAX.

Tolerances:

- both recurrent streams' union-layer cell on the rank's rows against the
  unsharded cell: values and every gradient within rtol 1e-5, atol 1e-6
  of the largest value (fp32 sums in another order);
- ``get_loss`` against the unsharded port: the losses within rtol 1e-4 /
  atol 1e-5, every gradient (the entity table's gathered) within rtol
  1e-3 / atol 1e-5;
- one epoch (epoch 1, from the unsharded trainer's state after epoch 0,
  whose Adam moments damp the rounding noise of near-zero gradients, as
  ``tests/test_torch_hisres_train.py`` starts its epoch) against the
  unsharded port: the mean losses within rtol 1e-4, every parameter (the
  gathered table too) within atol 1e-5 + rtol 1e-3, but the four decoders'
  ``conv_b`` and ``fc_b``, whose true gradient is 0 under batch-statistics
  BatchNorm and which Adam moves by rounding noise; the replicated leaves
  bit-equal on every rank;
- the test ranks of the unsharded trainer's state after that epoch,
  single- and multi-step in both modes: the four MRRs within 1e-4, the
  ranks equal but for at most 1 % of the queries (near ties);
- at G = 4 under ``"halo"`` against JAX's ``HisResTrainer(mesh=make_mesh(
  MeshAxes(1, 4)), dist_agg="halo")``, one epoch from JAX's initial state
  then the valid split, as ``tests/test_halo_production.py`` runs it: the
  entity loss and MRR within 2e-3, that file's limits;
- a checkpoint written sharded, restored unsharded and again sharded:
  every tensor equal;
- ``python -m regcn_torch.cli hisres --shards 2`` with torchrun's
  variables set, in both modes, against the same command unsharded: the
  test MRRs within 1e-3;
- every refusal on a mesh names its ROADMAP item, or raises JAX's error
  where JAX refuses.
"""

import copy
import os
import pickle
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from regcn_torch.config import TrainConfig
from regcn_torch.data.snapshots import build_history, split_by_time
from regcn_torch.data.synthetic import generate
from regcn_torch.dist import sharded_impl
from regcn_torch.hisres import layers as HLayers
from regcn_torch.hisres import model as PM
from regcn_torch.hisres.train import HisResTrainer
from regcn_torch.parallel import sharding
from regcn_torch.parallel.collectives import all_gather_rows
from regcn_torch.parallel.mesh import MeshAxes, make_mesh
from regcn_torch.train import metrics
from regcn_torch.train import state as train_state
from regcn_torch.train.optim import AdamState, tree_leaves, tree_map

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0,
                  cand_dropout=0.0)
# history 2: JAX's sharded epoch compiles one short-window step and its scan
TC = dict(n_epochs=1, train_history_len=2, test_history_len=2, edge_bucket=32, rc_bucket=64,
          triple_bucket=64)
D, LAYERS = 8, 1
HIS_EDGE_BUCKET = 64
MODES = ("gspmd", "halo")
CASES = [(g, m) for g in (2, 4) for m in MODES]
SHIFT_INVARIANT = {f"decoder_{dec}/{b}" for dec in ("ob_raw", "ob_inv", "rel_raw", "rel_his")
                   for b in ("conv_b", "fc_b")}
CLI_ARGS = ["-d", "synthetic-small", "--n-epochs", "1", "--n-hidden", "8", "--n-layers", "1",
            "--train-history-len", "2", "--test-history-len", "2", "--dropout", "0",
            "--input-dropout", "0", "--hidden-dropout", "0", "--feat-dropout", "0"]
WINDOW = 4  # the training snapshot of the get_loss case


def data_of():
    return generate("synthetic-small", seed=123, **TINY)


def base_of(data) -> dict:
    return dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=LAYERS,
                **NO_DROPOUT)


def trainer_of(data, **kw) -> HisResTrainer:
    return HisResTrainer(PM.HisResConfig(**base_of(data)), TrainConfig(**TC), data,
                         his_edge_bucket=HIS_EDGE_BUCKET, device="cpu", **kw)


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
            "step": state.step, "model_state": copy.deepcopy(state.model_state)}


def state_of(blob):
    gen = torch.Generator()
    gen.manual_seed(0)
    return train_state.TrainState(
        params=tree_map(lambda t: t.clone().requires_grad_(True), blob["params"]),
        opt_state=AdamState(count=blob["count"], mu=[t.clone() for t in blob["mu"]],
                            nu=[t.clone() for t in blob["nu"]]),
        model_state=copy.deepcopy(blob["model_state"]), gen=gen, step=blob["step"])


def cell_inputs(data):
    """Entity rows [N, d], relations [2R, d], probes of both outputs and a
    two-layer union cell, from numpy's seed 7."""
    rng = np.random.default_rng(7)
    n, r2 = data.num_nodes, 2 * data.num_rels

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    cell = HLayers.init_hisres_rgcn_cell(torch.Generator().manual_seed(3), D, 2)
    return normal(n, D), normal(r2, D), normal(n, D), normal(r2, D), cell


def cell_grads(cell, h, rel, probe_h, probe_r, snap, impl="xla"):
    """(node rows, edge rows, the gradients of their probed sum in h, rel
    and every parameter)."""
    leaves = [h.clone().requires_grad_(True), rel.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in tree_leaves(cell)]
    x, r = HLayers.hisres_rgcn_cell(sharding._rebuild(cell, leaves[2:]), leaves[0], leaves[1],
                                    snap, impl=impl)
    grads = torch.autograd.grad((x * probe_h).sum() + (r * probe_r).sum(), leaves)
    return x.detach(), r.detach(), list(grads)


def loss_grads(trainer, state, inputs) -> dict:
    total, losses, _ = trainer.loss(state, *inputs)
    leaves = tree_leaves(state.params)
    if trainer.shard is None:
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    else:
        rules = sharding.state_sharding_rules(state)
        grads = sharding.sharded_grads(total, leaves, [not r for r in rules], trainer.shard)
        with torch.no_grad():
            grads = [all_gather_rows(g, trainer.shard.group) if r else g
                     for g, r in zip(grads, rules)]
    return {"losses": {k: float(v.detach()) for k, v in losses.items()}, "grads": grads}


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


# ---------------------------------------------------------------- the ranks

def _rank_cell(trainer, data, inputs) -> tuple:
    """The union cell on the rank's rows of training snapshot 3's window,
    the replicated gradients summed over the ranks."""
    h, rel, probe_h, probe_r, cell = inputs
    shard = trainer.shard
    snap = trainer._history(split_by_time(data.train)[3:4]).step(0)
    lo, hi = shard.row0, shard.row0 + shard.rows
    # the edge rows are replicated: every rank's share of their probe is 1 / G
    x, r, grads = cell_grads(cell, h[lo:hi], rel, probe_h[lo:hi], probe_r / shard.size, snap,
                             sharded_impl(trainer.mesh, trainer.dist_agg))
    for g in grads[1:]:
        dist.all_reduce(g, group=shard.group)
    return x, r, grads


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


def _rank_checkpoint(trainer, state, workdir) -> bool:
    """Sharded -> unsharded -> sharded; True where every tensor came back."""
    shard = trainer.shard
    a, b = (os.path.join(workdir, f"ck-{trainer.dist_agg}-{x}") for x in "ab")
    train_state.save_checkpoint(a, state, {"epoch": 0}, shard=shard)
    gathered = sharding.unshard_state(state, shard)
    whole, meta = train_state.restore_checkpoint(a, gathered)

    def leaves(s):
        return tree_leaves(s.params) + s.opt_state.mu + s.opt_state.nu + tree_leaves(
            train_state.fields_of(s.model_state))

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
    return cli.main(["hisres", *CLI_ARGS, "--shards", str(G), "--dist-agg", mode,
                     "--models-dir", os.path.join(workdir, f"cli-{mode}")], device="cpu")


def rank_main(rank: int, G: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.nice(10)  # a helper of this test: the other test workers keep their CPU share
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=G,
                            rank=rank)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    data = data_of()
    mesh = make_mesh(MeshAxes(1, G), device_type="cpu")
    cells = cell_inputs(data)
    results = {}
    for mode in MODES:
        trainer = trainer_of(data, mesh=mesh, dist_agg=mode)
        res = {"cell": _rank_cell(trainer, data, cells)}
        mine = sharding.shard_state(state_of(inputs["init"]), trainer.shard)
        res["get_loss"] = loss_grads(trainer, mine, trainer.window(WINDOW))
        res["epoch"], state = _rank_epoch(trainer, inputs["after0"])
        final = sharding.shard_state(state_of(inputs["final"]), trainer.shard)
        res["test"] = recorded_test(trainer, final)
        res["multi_step"] = recorded_test(trainer, final, multi_step=True, topk=3)
        res["round_trip"] = _rank_checkpoint(trainer, state, workdir)
        if G == 4 and mode == "halo":
            res["anchor"] = _rank_anchor(trainer, inputs["init"])
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


def jax_setup():
    """(JAX's data, config, train config, its HisRES trainer class)."""
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.data.synthetic import generate as jax_generate
    from regcn_tpu.hisres import model as JM
    from regcn_tpu.hisres.train import HisResTrainer as JaxTrainer

    data = jax_generate("synthetic-small", seed=123, **TINY)
    return data, JM.HisResConfig(**base_of(data)), JaxTrainConfig(**TC), JaxTrainer


@pytest.fixture(scope="module")
def jax_trainer():
    """JAX's sharded trainer at G = 4 under ``"halo"`` and its initial
    state, ``PRNGKey(0)`` (JAX initialises alike with and without a mesh),
    with a numpy copy of that state."""
    import jax

    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh

    data, cfg, tc, JaxTrainer = jax_setup()
    mesh = jax_make_mesh(JaxMeshAxes(1, 4), devices=jax.devices()[:4])
    trainer = JaxTrainer(cfg, tc, data, his_edge_bucket=HIS_EDGE_BUCKET, mesh=mesh,
                         dist_agg="halo")
    state = trainer.init_state(jax.random.PRNGKey(0))
    return trainer, state, jax.tree.map(lambda a: np.array(a), state)


def jax_anchor(trainer, state) -> dict:
    """One epoch of JAX's sharded trainer from ``state``: its mean losses
    and the valid split's entity MRR after it."""
    state, losses = trainer.run_epoch(state, 0)
    valid = trainer.evaluate(state, trainer.train_list, trainer.valid_list,
                             time_offset=len(trainer.train_list))
    return {"losses": losses, "valid_mrr": valid["ent_raw"].mrr}


@pytest.fixture(scope="module")
def unsharded(jax_trainer):
    """The unsharded port from JAX's converted initial state: the union
    cell, get_loss at WINDOW with every gradient, epochs 0 and 1, the test
    ranks after them (single- and multi-step)."""
    from regcn_torch.convert import train_state_from_jax

    data = data_of()
    trainer = trainer_of(data)
    init = blob_of(train_state_from_jax(jax_trainer[2], device="cpu"))
    h, rel, probe_h, probe_r, cell = cell_inputs(data)
    snap = build_history(split_by_time(data.train)[3:4], data.num_nodes, data.num_rels,
                         edge_bucket=TC["edge_bucket"], rc_bucket=TC["rc_bucket"],
                         rc_mode="src").to("cpu").step(0)
    out = {"init": init, "cell": cell_grads(cell, h, rel, probe_h, probe_r, snap)}
    state = state_of(init)
    out["names"] = paths(state.params)
    out["get_loss"] = loss_grads(trainer, state, trainer.window(WINDOW))
    trainer.run_epoch(state, 0)
    out["after0"] = blob_of(state)
    out["epoch"] = {"losses": trainer.run_epoch(state, 1),
                    "params": [t.detach().clone() for t in tree_leaves(state.params)]}
    out["final"] = blob_of(state)
    out["test"] = recorded_test(trainer, state)
    out["multi_step"] = recorded_test(trainer, state, multi_step=True, topk=3)
    return out


@pytest.fixture(scope="module")
def cli_unsharded(tmp_path_factory):
    import regcn_torch.data as pt_data
    from regcn_torch import cli

    data = data_of()
    workdir = str(tmp_path_factory.mktemp("cli"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pt_data, "load_data", lambda *a, **k: data)
        return cli.main(["hisres", *CLI_ARGS, "--models-dir", workdir], device="cpu")


@pytest.fixture(scope="module")
def rank_results(unsharded, jax_trainer, tmp_path_factory):
    """Every rank's results, per (G, mode), and JAX's sharded anchor: the
    spawns of G = 2 and G = 4 run side by side while this process runs
    JAX's."""
    spawns = {}
    for G in (2, 4):
        workdir = str(tmp_path_factory.mktemp(f"g{G}"))
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump({k: unsharded[k] for k in ("init", "after0", "final")}, f)
        spawns[G] = workdir, mp.start_processes(rank_main, args=(G, workdir), nprocs=G,
                                                join=False, start_method="spawn")
    out = {"anchor": jax_anchor(*jax_trainer[:2])}
    for G, (workdir, ctx) in spawns.items():
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


def assert_ranks_match(got, want, mrr_tol=1e-4):
    for k, w in want[0].items():
        assert abs(got[0][k] - w) <= mrr_tol, (k, got[0][k], w)
    a = np.concatenate([np.concatenate(x) for x in got[1]])
    b = np.concatenate([np.concatenate(x) for x in want[1]])
    assert a.shape == b.shape and np.mean(a != b) <= 0.01, np.mean(a != b)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_union_cell_and_its_gradients_match_unsharded(rank_results, unsharded, case):
    G = case[0]
    want_x, want_r, want_g = unsharded["cell"]
    for rank, res in enumerate(rank_results[case]):
        lo, hi = rank * TINY["num_ents"] // G, (rank + 1) * TINY["num_ents"] // G
        x, r, grads = res["cell"]
        close_to_scale(x, want_x[lo:hi], "node rows")
        close_to_scale(r, want_r, "edge rows")
        for i, (g, w) in enumerate(zip(grads, want_g)):
            close_to_scale(g, w[lo:hi] if i == 0 else w, f"gradient {i}")


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_get_loss_and_every_gradient_match_unsharded(rank_results, unsharded, case):
    want = unsharded["get_loss"]
    for res in rank_results[case]:
        got = res["get_loss"]
        for k, w in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], w, rtol=1e-4, atol=1e-5, err_msg=k)
        for leaf, g, w in zip(unsharded["names"], got["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-5, err_msg=leaf)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_epoch_and_test_ranks_match_unsharded(rank_results, unsharded, case):
    want = unsharded["epoch"]
    for res in rank_results[case]:
        got = res["epoch"]
        for k, w in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
        for leaf, a, b in zip(unsharded["names"], got["params"], want["params"]):
            if leaf not in SHIFT_INVARIANT:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5,
                                           err_msg=leaf)
        assert_ranks_match(res["test"], unsharded["test"])
    first = rank_results[case][0]["epoch"]["replicated"]
    for res in rank_results[case][1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, res["epoch"]["replicated"]))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_multi_step_test_matches_unsharded(rank_results, unsharded, case):
    """Multi-step in both modes, as JAX's HisRES trainer runs it."""
    for res in rank_results[case]:
        assert_ranks_match(res["multi_step"], unsharded["multi_step"])


def test_halo_matches_jax_sharded_trainer(rank_results):
    want = rank_results["anchor"]
    for res in rank_results[4, "halo"]:
        got = res["anchor"]
        assert abs(got["losses"]["entity"] - float(want["losses"]["entity"])) < 2e-3
        assert abs(got["valid_mrr"] - want["valid_mrr"]) < 2e-3


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_checkpoint_round_trip_sharded_unsharded_sharded(rank_results, case):
    assert all(res["round_trip"] for res in rank_results[case])


@pytest.mark.parametrize("mode", MODES)
def test_cli_hisres_shards(rank_results, cli_unsharded, mode):
    for res in rank_results[2, mode]:
        for k, w in cli_unsharded.items():
            for metric, v in w.items():
                assert abs(res["cli"][k][metric] - v) <= 1e-3, (k, metric)


FAKE_MESH = types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 2))
REFUSALS = {
    "bf16": (dict(cfg=dict(compute_dtype="bfloat16")), NotImplementedError, "A.11b"),
    "run-analysis": (dict(run_analysis=True), NotImplementedError, "A.11b"),
    "data-axis": (dict(mesh=types.SimpleNamespace(mesh_dim_names=("data", "graph"),
                                                  shape=(2, 2))), NotImplementedError, "A.11b"),
    "halo-without-mesh": (dict(mesh=None, dist_agg="halo"), ValueError, "requires a mesh"),
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_refusals_on_a_mesh(what):
    """What a mesh does not run yet raises before any collective, naming
    its ROADMAP item; the halo without a mesh raises JAX's error."""
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.hisres import model as JM
    from regcn_tpu.hisres.train import HisResTrainer as JaxTrainer

    data = data_of()
    kw, error, match = REFUSALS[what]
    kw = dict(kw)
    cfg = dict(base_of(data), **kw.pop("cfg", {}))
    kw.setdefault("mesh", FAKE_MESH)
    with pytest.raises(error, match=match):
        HisResTrainer(PM.HisResConfig(**cfg), TrainConfig(**TC), data, device="cpu", **kw)
    if error is ValueError:
        with pytest.raises(error, match=match):
            JaxTrainer(JM.HisResConfig(**cfg), JaxTrainConfig(**TC), data, **kw)
