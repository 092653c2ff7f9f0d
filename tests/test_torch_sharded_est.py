"""Config 5 (EST and TANS) and triple batching on the port's entity-sharded
hyperbolic trainer, on gloo ranks, against the unsharded port and
regcn_tpu's sharded trainer.

The pattern of ``tests/test_torch_sharded_hyperbolic.py``, whose helpers
this module takes: one spawn of G = 2 and one of G = 4 CPU processes (a
gloo group over a file store, a 1 x G mesh) run every case, torch on one
thread, fp32, every dropout 0, 40 entities at h = 16, from JAX's initial
states converted and sliced per rank; JAX is imported inside the fixtures
only. The cases:

- ``config5``: the headline with EST (the GRU history encoder) and TANS,
  in both ``dist_agg`` modes;
- triple batching in chunks of 16 of the 64 padded triples, under
  ``"gspmd"`` (JAX refuses it under ``"halo"``), in ``accumulate`` and
  ``per_chunk``: config 5, each chunk with its own retrieval batch and its
  TANS COO cut to the rank's columns, and config 3 (LGCN + RotH, learned
  c), whose chunks run B2's plain version over the gathered table.

Tolerances, that file's:

- ``get_loss`` (of the whole window; of its first chunk for the
  triple-batched cases) against the unsharded port: the losses within rtol
  1e-4 / atol 1e-5, every gradient (the entity table's gathered) within
  rtol 1e-3 / atol 1e-5;
- one epoch from the unsharded trainer's state after its epoch 0: the mean
  losses within rtol 1e-4, every parameter but the ConvTrans decoders'
  ``conv_b`` / ``fc_b`` and the QCHHE attention's ``attn_proj_b`` (true
  gradient 0, moved by Adam on rounding noise, as
  ``tests/test_torch_hyperbolic_est_train.py`` says) within atol 1e-5 +
  rtol 1e-3, and EST's memories
  after it within the same limits; the replicated leaves and the memories
  bit-equal on every rank;
- the test ranks from the unsharded trainer's final state: the four MRRs
  within 1e-4, the ranks equal but for at most 1 % of the queries
  (multi-step too for ``config5``);
- config 5 at G = 2 under ``"gspmd"`` against JAX's
  ``HyperbolicTrainer(mesh=make_mesh(MeshAxes(1, 2)))``: one epoch from
  the same state, then the valid split, the entity loss and the MRR within
  2e-3;
- a checkpoint written sharded, restored unsharded and again sharded:
  every tensor equal, EST's memories among them;
- ``python -m regcn_torch.cli hyperbolic --shards 2 --use-est
  --use-time-aware-negative`` against the same command unsharded: the
  test MRRs within 1e-3.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from regcn_torch.config import TrainConfig
from regcn_torch.data.synthetic import generate
from regcn_torch.hyperbolic import model as PM
from regcn_torch.hyperbolic.train import HyperbolicTrainer
from regcn_torch.parallel import sharding
from regcn_torch.parallel.collectives import all_gather_rows
from regcn_torch.parallel.mesh import MeshAxes, make_mesh
from regcn_torch.train.optim import tree_leaves
from test_torch_sharded_hyperbolic import (CLI_ARGS, D, NO_DROPOUT, SHIFT_INVARIANT, TC, TINY,
                                           _rank_checkpoint, assert_ranks_match, blob_of,
                                           host_copy, paths, recorded_test, state_of)

EST = dict(use_est=True, use_time_aware_negative=True, est_encoder="gru", est_history_len=4)
EST_FLAGS = ["--use-est", "--use-time-aware-negative", "--est-history-len", "4"]
CONFIG3 = dict(encoder="lgcn", decoder="roth", n_bases=4, learn_curvature=True)
CHUNK = 16
MODES = ("gspmd", "halo")
# name: (model config, trainer options, the modes it runs in)
CONFIGS = {
    "config5": (EST, {}, MODES),
    "config5-accumulate": (EST, dict(triple_batch_size=CHUNK), ("gspmd",)),
    "config5-per_chunk": (EST, dict(triple_batch_size=CHUNK, triple_batch_mode="per_chunk"),
                          ("gspmd",)),
    "config3-accumulate": (CONFIG3, dict(triple_batch_size=CHUNK), ("gspmd",)),
    "config3-per_chunk": (CONFIG3, dict(triple_batch_size=CHUNK, triple_batch_mode="per_chunk"),
                          ("gspmd",)),
}
CASES = [(g, name, m) for g in (2, 4) for name in CONFIGS for m in CONFIGS[name][2]]
WINDOW = 4  # the training snapshot of the get_loss case
# true gradient 0, moved by Adam on rounding noise: the ConvTrans decoders'
# biases before a batch-statistics BatchNorm and the QCHHE attention's bias,
# which shifts every event's logit of a row alike
NOISE_ONLY = SHIFT_INVARIANT | {"est/attn_proj_b"}


def data_of():
    return generate("synthetic-small", seed=123, **TINY)


def base_of(name, data) -> dict:
    return dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=2,
                **NO_DROPOUT, **CONFIGS[name][0])


def trainer_of(name, data, **kw) -> HyperbolicTrainer:
    return HyperbolicTrainer(PM.HyperbolicConfig(**base_of(name, data)), TrainConfig(**TC), data,
                             device="cpu", **CONFIGS[name][1], **kw)


def window_inputs(trainer) -> tuple:
    """``loss``'s inputs after the state: the whole window of WINDOW with
    EST's inputs, or with triple batching its first chunk's."""
    history, triples, mask = trainer.window(WINDOW)
    if trainer.triple_batch_size:
        triples, mask, rb, tans = trainer.chunks(WINDOW)[0]
        return history, triples, mask, trainer._curvature_max(0), rb, tans
    return history, triples, mask, trainer._curvature_max(0), *trainer.est_window(WINDOW)


def est_of(state) -> list:
    return [] if state.est_state is None else [state.est_state.fast.clone(),
                                               state.est_state.slow.clone()]


# ---------------------------------------------------------------- the ranks

def _rank_get_loss(trainer, blob) -> dict:
    mine = sharding.shard_state(state_of(blob), trainer.shard)
    total, losses, _, _ = trainer.loss(mine, *window_inputs(trainer))
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
            "est": est_of(state),
            "replicated": [t.detach().clone() for t, r in zip(tree_leaves(state.params), rules)
                           if not r]}, state


def _rank_anchor(trainer, blob) -> dict:
    """Epoch 0 from JAX's initial state, then the valid split's MRR."""
    state = sharding.shard_state(state_of(blob), trainer.shard)
    losses = trainer.run_epoch(state, 0)
    valid = trainer.evaluate(state, trainer.train_list, trainer.valid_list,
                             time_offset=len(trainer.train_list))
    return {"losses": losses, "valid_mrr": valid["ent_raw"].mrr}


def _rank_cli(G, workdir, data) -> dict:
    import regcn_torch.data as pt_data
    from regcn_torch import cli

    pt_data.load_data = lambda *a, **k: data
    os.environ.update(RANK=str(dist.get_rank()), LOCAL_RANK=str(dist.get_rank()),
                      WORLD_SIZE=str(G), MASTER_ADDR="localhost", MASTER_PORT="1")
    return cli.main(["hyperbolic", *CLI_ARGS, *EST_FLAGS, "--shards", str(G),
                     "--models-dir", os.path.join(workdir, "cli")], device="cpu")


def rank_main(rank: int, G: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.nice(10)  # a helper of this test: the other test workers keep their CPU share
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=G,
                            rank=rank)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    data = data_of()
    mesh = make_mesh(MeshAxes(1, G), device_type="cpu")
    results = {}
    for name, (_, _, modes) in CONFIGS.items():
        for mode in modes:
            trainer = trainer_of(name, data, mesh=mesh, dist_agg=mode)
            res = {"get_loss": _rank_get_loss(trainer, inputs["init"][name])}
            res["epoch"], state = _rank_epoch(trainer, inputs["after0"][name])
            final = sharding.shard_state(state_of(inputs["final"][name]), trainer.shard)
            res["test"] = recorded_test(trainer, final)
            if name == "config5":
                res["multi_step"] = recorded_test(trainer, final, multi_step=True, topk=3)
                res["round_trip"] = _rank_checkpoint(trainer, state, workdir, name)
                if G == 2 and mode == "gspmd":
                    res["anchor"] = _rank_anchor(trainer, inputs["init"][name])
            results[name, mode] = res
    if G == 2:
        results["cli"] = _rank_cli(G, workdir, data)
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


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's sharded trainer at G = 2 under ``"gspmd"`` on config 5 and its
    initial state, ``PRNGKey(0)``; each configuration's initial state as
    numpy (JAX initialises alike with and without a mesh and a chunk size)."""
    import jax

    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.data.synthetic import generate as jax_generate
    from regcn_tpu.hyperbolic import model as JM
    from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxTrainer
    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh

    data = jax_generate("synthetic-small", seed=123, **TINY)
    tc = JaxTrainConfig(**TC)
    mesh = jax_make_mesh(JaxMeshAxes(1, 2), devices=jax.devices()[:2])
    trainer = JaxTrainer(JM.HyperbolicConfig(**base_of("config5", data)), tc, data, mesh=mesh)
    state = trainer.init_state(jax.random.PRNGKey(0))
    inits = {"config5": host_copy(state),
             "config3": host_copy(JaxTrainer(JM.HyperbolicConfig(**base_of(
                 "config3-accumulate", data)), tc, data).init_state(jax.random.PRNGKey(0)))}
    return trainer, state, inits


def jax_anchor(trainer, state) -> dict:
    state, losses = trainer.run_epoch(state, 0)
    valid = trainer.evaluate(state, trainer.train_list, trainer.valid_list,
                             time_offset=len(trainer.train_list))
    return {"losses": losses, "valid_mrr": valid["ent_raw"].mrr}


@pytest.fixture(scope="module")
def unsharded(jax_runs):
    """The unsharded port from JAX's converted initial states: get_loss
    with every gradient, one epoch, the test ranks after it."""
    from regcn_torch.convert import train_state_from_jax

    data = data_of()
    out = {"init": {}, "after0": {}, "final": {}}
    for name in CONFIGS:
        trainer = trainer_of(name, data)
        init = blob_of(train_state_from_jax(jax_runs[2][name.split("-")[0]], device="cpu"))
        out["init"][name] = init
        state = state_of(init)
        total, losses, _, _ = trainer.loss(state, *window_inputs(trainer))
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
                              "params": [t.detach().clone() for t in tree_leaves(state.params)],
                              "est": est_of(state)}
        out["final"][name] = blob_of(state)
        out[name, "test"] = recorded_test(trainer, state)
        if name == "config5":
            out[name, "multi_step"] = recorded_test(trainer, state, multi_step=True, topk=3)
    return out


@pytest.fixture(scope="module")
def cli_unsharded(tmp_path_factory):
    import regcn_torch.data as pt_data
    from regcn_torch import cli

    data = data_of()
    workdir = str(tmp_path_factory.mktemp("cli"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pt_data, "load_data", lambda *a, **k: data)
        return cli.main(["hyperbolic", *CLI_ARGS, *EST_FLAGS, "--models-dir", workdir],
                        device="cpu")


@pytest.fixture(scope="module")
def rank_results(unsharded, jax_runs, tmp_path_factory):
    """Every rank's results per G, and JAX's sharded anchor: the spawns of
    G = 2 and G = 4 run side by side while this process runs JAX's."""
    spawns = {}
    for G in (2, 4):
        workdir = str(tmp_path_factory.mktemp(f"g{G}"))
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump({k: unsharded[k] for k in ("init", "after0", "final")}, f)
        spawns[G] = workdir, mp.start_processes(rank_main, args=(G, workdir), nprocs=G,
                                                join=False, start_method="spawn")
    out = {"anchor": jax_anchor(*jax_runs[:2])}
    for G, (workdir, ctx) in spawns.items():
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
    G, name, mode = case
    return [res[name, mode] for res in rank_results[G]]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_get_loss_and_every_gradient_match_unsharded(rank_results, unsharded, case):
    want = unsharded[case[1], "get_loss"]
    for res in ranks_of(rank_results, case):
        got = res["get_loss"]
        for k, w in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], w, rtol=1e-4, atol=1e-5, err_msg=k)
        for leaf, g, w in zip(want["names"], got["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-5, err_msg=leaf)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_epoch_memories_and_test_ranks_match_unsharded(rank_results, unsharded, case):
    """One epoch (EST's memories after it too) and the single-step test
    ranks; the replicated leaves and the memories bit-equal on every rank."""
    name = case[1]
    want = unsharded[name, "epoch"]
    names = unsharded[name, "get_loss"]["names"]
    results = ranks_of(rank_results, case)
    for res in results:
        got = res["epoch"]
        for k, w in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
        for leaf, a, b in zip(names, got["params"], want["params"]):
            if leaf not in NOISE_ONLY:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5,
                                           err_msg=leaf)
        assert len(got["est"]) == len(want["est"]) == (2 if name.startswith("config5") else 0)
        for what, a, b in zip(("fast", "slow"), got["est"], want["est"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5, err_msg=what)
        assert_ranks_match(res["test"], unsharded[name, "test"])
    first = results[0]["epoch"]
    for res in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(first["replicated"],
                                                     res["epoch"]["replicated"]))
        assert all(torch.equal(a, b) for a, b in zip(first["est"], res["epoch"]["est"]))


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "config5"], ids=case_id)
def test_config5_multi_step_and_checkpoint_round_trip(rank_results, unsharded, case):
    """Multi-step in both modes, each step's retrieval batch at its time;
    a sharded checkpoint round trip keeps every tensor, the memories too."""
    for res in ranks_of(rank_results, case):
        assert_ranks_match(res["multi_step"], unsharded["config5", "multi_step"])
        assert res["round_trip"]


def test_config5_gspmd_matches_jax_sharded_trainer(rank_results):
    want = rank_results["anchor"]
    for res in ranks_of(rank_results, (2, "config5", "gspmd")):
        got = res["anchor"]
        assert abs(got["losses"]["entity"] - float(want["losses"]["entity"])) < 2e-3
        assert abs(got["valid_mrr"] - want["valid_mrr"]) < 2e-3


def test_cli_hyperbolic_shards_with_est(rank_results, cli_unsharded):
    for res in rank_results[2]:
        for k, w in cli_unsharded.items():
            for metric, v in w.items():
                assert abs(res["cli"][k][metric] - v) <= 1e-3, (k, metric)
