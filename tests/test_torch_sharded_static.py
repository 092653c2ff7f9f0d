"""The static entity-word graph on the port's entity-sharded trainers, in all
three families, on gloo ranks, against the unsharded port and regcn_tpu's
sharded RE-GCN trainer.

The pattern of ``tests/test_torch_sharded_hyperbolic.py``, whose helpers
this module takes: one spawn of G = 2 and one of G = 4 CPU processes (a
gloo group over a file store, a 1 x G mesh) run every case in both
``dist_agg`` modes, torch on one thread, fp32, every dropout 0, from JAX's
initial states converted and sliced per rank; JAX is imported inside the
fixtures only. The data are ``synthetic-small`` with its static graph: 40
entities and 20 words, so that ``words_emb`` shards at G = 2 and 4. The
families: RE-GCN config 2 and the hyperbolic headline (h = 16, 2 layers,
4 bases), and HisRES (h = 8, 1 layer, ``tests/test_torch_sharded_hisres.py``'s
settings). Tolerances, those files':

- ``get_loss`` against the unsharded port: the losses (the angular static
  loss summed across the ranks among them) within rtol 1e-4 / atol 1e-5,
  every gradient (the entity and word tables' gathered) within rtol 1e-3 /
  atol 1e-5;
- one epoch from the unsharded trainer's state after its epoch 0: the mean
  losses within rtol 1e-4, every parameter but the ConvTrans decoders'
  ``conv_b`` / ``fc_b`` (true gradient 0, moved by Adam on rounding noise)
  within atol 1e-5 + rtol 1e-3; the replicated leaves bit-equal on every
  rank;
- the test ranks from the unsharded trainer's final state: the four MRRs
  within 1e-4, the ranks equal but for at most 1 % of the queries;
- RE-GCN config 2 at G = 2 under ``"gspmd"`` against JAX's
  ``Trainer(mesh=make_mesh(MeshAxes(1, 2)))``: one fused epoch from the
  same state, then the valid split, the entity loss and the MRR within
  2e-3;
- a checkpoint written sharded, restored unsharded and again sharded:
  every tensor equal, ``words_emb``'s rows among them;
- ``num_words`` not divisible by the ``graph`` axis: each trainer raises
  ``ValueError`` at construction, where JAX's ``device_put`` of its state
  refuses the same 20 words at G = 8;
- the CLI's mesh options take ``--add-static-graph`` with ``--shards`` in
  ``train``, ``test``, ``hyperbolic`` and ``hisres``.
"""

import os
import pickle
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_sharded_hisres as hisres_case
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.data.synthetic import generate
from regcn_torch.hisres import model as HM
from regcn_torch.hisres.train import HisResTrainer
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic.train import HyperbolicTrainer
from regcn_torch.parallel import sharding
from regcn_torch.parallel.collectives import all_gather_rows
from regcn_torch.parallel.mesh import MeshAxes, make_mesh
from regcn_torch.train import loop
from regcn_torch.train.optim import tree_leaves
from test_torch_sharded_train import read_input, write_input
from test_torch_sharded_hyperbolic import (NO_DROPOUT, SHIFT_INVARIANT, TC, TINY,
                                           _rank_checkpoint, assert_ranks_match, blob_of,
                                           host_copy, paths, recorded_test, state_of)

FAMILIES = ("regcn", "headline", "hisres")
MODES = ("gspmd", "halo")
CASES = [(g, f, m) for g in (2, 4) for f in FAMILIES for m in MODES]
WINDOW = 4  # the training snapshot of the get_loss case
NOISE_ONLY = SHIFT_INVARIANT | hisres_case.SHIFT_INVARIANT


def data_of():
    return generate("synthetic-small", seed=123, with_static=True, **TINY)


def base_of(family, data) -> dict:
    static = dict(num_ents=data.num_nodes, num_rels=data.num_rels, use_static=True,
                  num_static_rels=data.num_static_rels, num_words=data.num_words, n_bases=4)
    if family == "hisres":
        return dict(static, h_dim=hisres_case.D, n_layers=hisres_case.LAYERS,
                    **hisres_case.NO_DROPOUT)
    return dict(static, h_dim=16, n_layers=2, **NO_DROPOUT)


def trainer_of(family, data, **kw):
    base = base_of(family, data)
    if family == "regcn":
        return loop.Trainer(ExperimentConfig(model=ModelConfig(**base), train=TrainConfig(**TC)),
                            data, device="cpu", **kw)
    if family == "headline":
        return HyperbolicTrainer(PM.HyperbolicConfig(**base), TrainConfig(**TC), data,
                                 device="cpu", **kw)
    return HisResTrainer(HM.HisResConfig(**base), TrainConfig(**hisres_case.TC), data,
                         his_edge_bucket=hisres_case.HIS_EDGE_BUCKET, device="cpu", **kw)


def loss_of(trainer, state) -> tuple:
    """(total, losses) of a training step on window WINDOW."""
    extra = (trainer._curvature_max(0),) if isinstance(trainer, HyperbolicTrainer) else ()
    return trainer.loss(state, *trainer.window(WINDOW), *extra)[:2]


# ---------------------------------------------------------------- the ranks

def _rank_get_loss(trainer, blob) -> dict:
    mine = sharding.shard_state(state_of(blob), trainer.shard)
    total, losses = loss_of(trainer, mine)
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
    """Epoch 0 from JAX's initial state, then the valid split's MRR."""
    state = sharding.shard_state(state_of(blob), trainer.shard)
    losses = trainer.run_epoch(state, 0)
    valid = trainer.evaluate(state, trainer.train_list, trainer.valid_list)
    return {"losses": losses, "valid_mrr": valid["ent_raw"].mrr}


def rank_main(rank: int, G: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.nice(10)  # a helper of this test: the other test workers keep their CPU share
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=G,
                            rank=rank)
    init = read_input(workdir, "init")
    data = data_of()
    mesh = make_mesh(MeshAxes(1, G), device_type="cpu")
    results = {}
    for family in FAMILIES:
        for mode in MODES:
            trainer = trainer_of(family, data, mesh=mesh, dist_agg=mode)
            res = {"get_loss": _rank_get_loss(trainer, init[family])}
            late = read_input(workdir, family)
            res["epoch"], state = _rank_epoch(trainer, late["after0"])
            final = sharding.shard_state(state_of(late["final"]), trainer.shard)
            res["test"] = recorded_test(trainer, final)
            res["round_trip"] = _rank_checkpoint(trainer, state, workdir, family)
            if family == "regcn" and G == 2 and mode == "gspmd":
                res["anchor"] = _rank_anchor(trainer, init[family])
            results[family, mode] = res
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


def jax_families():
    """JAX's data and, per family, (model config, train config, trainer
    class, its keyword arguments)."""
    from regcn_tpu.config import ExperimentConfig as JaxExperimentConfig
    from regcn_tpu.config import ModelConfig as JaxModelConfig
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.data.synthetic import generate as jax_generate
    from regcn_tpu.hisres import model as JHM
    from regcn_tpu.hisres.train import HisResTrainer as JaxHisRes
    from regcn_tpu.hyperbolic import model as JPM
    from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxHyperbolic
    from regcn_tpu.train import loop as jax_loop

    data = jax_generate("synthetic-small", seed=123, with_static=True, **TINY)
    regcn = JaxExperimentConfig(model=JaxModelConfig(**base_of("regcn", data)),
                                train=JaxTrainConfig(**TC))
    return data, {
        "regcn": lambda **kw: jax_loop.Trainer(regcn, data, **kw),
        "headline": lambda **kw: JaxHyperbolic(JPM.HyperbolicConfig(**base_of("headline", data)),
                                               JaxTrainConfig(**TC), data, **kw),
        "hisres": lambda **kw: JaxHisRes(JHM.HisResConfig(**base_of("hisres", data)),
                                         JaxTrainConfig(**hisres_case.TC), data,
                                         his_edge_bucket=hisres_case.HIS_EDGE_BUCKET, **kw),
    }, regcn


def jax_init(family, trainer, mesh=None):
    """JAX's initial state of ``family`` from ``PRNGKey(0)``, on ``mesh``
    where there is one (its ``device_put``)."""
    import jax

    if family != "regcn":
        return trainer.init_state(jax.random.PRNGKey(0))
    from regcn_tpu.parallel.sharding import state_sharding_rules
    from regcn_tpu.train.state import create_train_state

    cfg = trainer.cfg
    state = create_train_state(jax.random.PRNGKey(0), cfg.model, cfg.train)
    return state if mesh is None else jax.device_put(state, state_sharding_rules(state, mesh))


@pytest.fixture(scope="module")
def jax_runs():
    """Each family's initial state as numpy, and JAX's sharded RE-GCN
    trainer at G = 2 under ``"gspmd"`` with that state on its mesh."""
    import jax

    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh

    _, makers, _ = jax_families()
    inits = {f: host_copy(jax_init(f, make())) for f, make in makers.items()}
    mesh = jax_make_mesh(JaxMeshAxes(1, 2), devices=jax.devices()[:2])
    trainer = makers["regcn"](mesh=mesh)
    return trainer, jax_init("regcn", trainer, mesh), inits


def jax_anchor(trainer, state) -> dict:
    state, losses = trainer.run_epoch_fused(state, 0)
    valid = trainer.evaluate(state, trainer.train_list, trainer.valid_list)
    return {"losses": losses, "valid_mrr": valid["ent_raw"].mrr}


@pytest.fixture(scope="module")
def spawns(jax_runs, tmp_path_factory):
    """The spawns of G = 2 and G = 4, side by side, from JAX's converted
    initial states; each family's states after the unsharded epochs reach
    them later (``unsharded``)."""
    from regcn_torch.convert import train_state_from_jax

    init = {f: blob_of(train_state_from_jax(jax_runs[2][f], device="cpu")) for f in FAMILIES}
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
    ranks run: get_loss with every gradient, one epoch, the test ranks
    after it; each family's states after its epochs go to the ranks."""
    data = data_of()
    out = {"init": spawns[0], "after0": {}, "final": {}}
    for family in FAMILIES:
        trainer = trainer_of(family, data)
        init = out["init"][family]
        state = state_of(init)
        total, losses = loss_of(trainer, state)
        grads = torch.autograd.grad(total, tree_leaves(state.params), allow_unused=True)
        out[family, "get_loss"] = {
            "losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": [torch.zeros_like(p) if g is None else g
                      for g, p in zip(grads, tree_leaves(state.params))],
            "names": paths(state.params)}
        state = state_of(init)
        trainer.run_epoch(state, 0)
        out["after0"][family] = blob_of(state)
        out[family, "epoch"] = {"losses": trainer.run_epoch(state, 1),
                                "params": [t.detach().clone() for t in tree_leaves(state.params)]}
        out["final"][family] = blob_of(state)
        for workdir, _ in spawns[1].values():
            write_input(workdir, family, {k: out[k][family] for k in ("after0", "final")})
        out[family, "test"] = recorded_test(trainer, state)
    return out


@pytest.fixture(scope="module")
def rank_results(unsharded, jax_runs, spawns):
    """Every rank's results per G, and JAX's sharded anchor, which this
    process runs while the ranks do."""
    out = {"anchor": jax_anchor(*jax_runs[:2])}
    for G, (workdir, ctx) in spawns[1].items():
        while not ctx.join():
            pass
        out[G] = []
        for r in range(G):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out[G].append(pickle.load(f))
    return out


def case_id(case):
    return f"G{case[0]}-{case[1]}-{case[2]}"


def ranks_of(rank_results, case):
    G, family, mode = case
    return [res[family, mode] for res in rank_results[G]]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_get_loss_and_every_gradient_match_unsharded(rank_results, unsharded, case):
    want = unsharded[case[1], "get_loss"]
    assert want["losses"]["static"] > 0
    for res in ranks_of(rank_results, case):
        got = res["get_loss"]
        for k, w in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], w, rtol=1e-4, atol=1e-5, err_msg=k)
        for leaf, g, w in zip(want["names"], got["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-5, err_msg=leaf)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_epoch_and_test_ranks_match_unsharded(rank_results, unsharded, case):
    family = case[1]
    want = unsharded[family, "epoch"]
    names = unsharded[family, "get_loss"]["names"]
    results = ranks_of(rank_results, case)
    for res in results:
        got = res["epoch"]
        for k, w in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
        for leaf, a, b in zip(names, got["params"], want["params"]):
            if leaf not in NOISE_ONLY:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5,
                                           err_msg=leaf)
        assert_ranks_match(res["test"], unsharded[family, "test"])
    first = results[0]["epoch"]["replicated"]
    for res in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, res["epoch"]["replicated"]))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_checkpoint_round_trip_sharded_unsharded_sharded(rank_results, case):
    assert all(res["round_trip"] for res in ranks_of(rank_results, case))


def test_config2_gspmd_matches_jax_sharded_trainer(rank_results):
    want = rank_results["anchor"]
    for res in ranks_of(rank_results, (2, "regcn", "gspmd")):
        got = res["anchor"]
        assert abs(got["losses"]["entity"] - float(want["losses"]["entity"])) < 2e-3
        assert abs(got["valid_mrr"] - want["valid_mrr"]) < 2e-3


@pytest.mark.parametrize("family", FAMILIES)
def test_words_not_divisible_by_the_graph_axis_raise_as_jax_refuses(family):
    """20 words over a graph axis of 8: the port's trainer raises at its
    construction, before any collective; JAX's ``device_put`` of the state
    raises the same ``ValueError`` class for the same table."""
    import jax

    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh

    data = data_of()
    assert data.num_words == 20 and data.num_nodes % 8 == 0
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 8))
    with pytest.raises(ValueError, match="num_words=20 is not divisible by the 'graph' mesh "
                                         r"axis \(8\)"):
        trainer_of(family, data, mesh=mesh)
    _, makers, _ = jax_families()
    jax_mesh = jax_make_mesh(JaxMeshAxes(1, 8), devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="should be divisible by 8, but it is equal to 20"):
        jax_init(family, makers[family](mesh=jax_mesh), jax_mesh)


@pytest.mark.parametrize("mode", ["train", "test", "hyperbolic", "hisres"])
def test_cli_takes_the_static_graph_with_shards(mode, monkeypatch):
    """``--add-static-graph`` with ``--shards``, stopped before it was
    ported, passes the CLI's option checks in every mode that takes a mesh,
    and so do bf16 and ``--run-analysis`` beside it (stopped there, naming
    ROADMAP A.11b, until they were ported): launched without torchrun, each
    command stops only for the process group it lacks."""
    from regcn_torch import cli

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = [mode, "-d", "synthetic-small", "--shards", "2", "--add-static-graph"]
    for extra in ([], ["--compute-dtype", "bfloat16"], ["--run-analysis"]):
        with pytest.raises(SystemExit, match="launch with torchrun"):
            cli.main(argv + extra, device="cpu")
