"""bf16 compute, ``run_analysis``, ``impl="cumsum"`` and a ``data`` axis
above 1 on the port's entity-sharded trainers, on gloo ranks, against the
unsharded port and regcn_tpu's sharded trainer.

The pattern of ``tests/test_torch_sharded_hyperbolic.py``, whose helpers
this module takes with those of the RE-GCN and HisRES files: one spawn of
G = 2 CPU processes on a (data 1, graph 2) mesh and one of 4 on a (data 2,
graph 2) mesh, side by side (a gloo group over a file store each; the
ranks niced, torch on one thread), while this process runs the unsharded
port and JAX's sharded trainers on conftest's virtual CPU mesh. Every
dropout is 0, 40 entities. The trainers: RE-GCN config 1 (h = 16, 2
layers; its states are JAX's converted initial state), the hyperbolic
headline, config 3 (LGCN + RotH, B2's plain version over the gathered
table) and config 5 (the headline with EST and TANS), and HisRES (h = 8,
1 layer), these four from the port's own seeded initial states. JAX is
imported inside the fixtures only, so that the spawned ranks load none.
The checks and their tolerances:

- **bf16** (each trainer, both ``dist_agg`` modes): ``get_loss`` and
  every gradient at window 4, and every parameter after 3 steps, against
  the unsharded port in bf16 and in fp32 from the same state, by
  ``tests/test_torch_bf16.py``'s drift criterion,
  ``||mesh_bf16 - port_fp32|| <= 2 ||port_bf16 - port_fp32|| + atol * ref``:
  for a loss atol 1e-2 of the fp32 loss; for a gradient 2^-8 (bf16's
  resolution) of the whole fp32 gradient's norm, since bf16's error in a
  leaf's gradient scales with the activations that flow into it, not with
  the leaf's own norm, which cancelling sums make small (the BatchNorms'
  scales, the ConvTrans biases of true gradient 0, the radius MLP under a
  loss of ~1e-7); for a parameter after the steps 0.5 of the distance the
  fp32 run moved it (that file's ``STEP_ATOL``). The parameters and their
  gradients stay fp32. Against JAX: RE-GCN's epoch at G = 2 under
  ``"gspmd"`` against ``Trainer(mesh=make_mesh(MeshAxes(1, 2)))`` in bf16
  and fp32 from the same state, the mean losses and every parameter by
  the same criterion.
- **run_analysis** (each trainer, both modes): ``analysis_record`` of the
  same state on the mesh against one process's, every key, within rtol
  1e-5 (fp32 sums in another order), and equal on every rank; RE-GCN's
  against JAX's sharded trainer's at G = 2, every key within rtol 1e-4 /
  atol 1e-6 (``tests/test_torch_hisres_train.py``'s, port against JAX).
- **cumsum**: RE-GCN with ``impl="cumsum"`` at G = 2 under ``"gspmd"``:
  each rank's aggregation of a snapshot against JAX's
  ``rgcn_aggregate(impl="cumsum")`` within ``tests/test_torch_native.py``'s
  limits for the same algorithm (rtol 1e-5, atol 1e-6 of the scale), its
  gradients within that file's limits for the cumsum route against
  another summation (rtol 1e-4, atol 1e-5 of the scale: the backward's
  reverse cumulative sum over the rank's prefix rounds apart from JAX's);
  ``get_loss`` against the unsharded cumsum route, the losses within rtol
  1e-4 / atol 1e-5 and every gradient within rtol 1e-3 / atol 1e-5 (the
  limits at which ``tests/test_torch_sharded_train.py`` holds the sharded
  B1 route to the unsharded one: each rank's cumulative sum runs over its
  own destination partition, the unsharded one over every edge, so the
  prefixes differ in length and round apart), two epochs against JAX's sharded
  ``Trainer(impl="cumsum")`` (which runs it over the whole sorted edge
  array): the mean losses within rtol 1e-4 / atol 1e-5, every parameter
  within atol 1e-5 + rtol 1e-3 but the decoders' ``conv_b`` / ``fc_b``
  (true gradient 0, moved by Adam on rounding noise, as
  ``tests/test_torch_sharded_train.py`` leaves them out), the test MRRs
  within 1e-4; under ``"halo"`` the ``ValueError`` of both packages.
- **data = 2** (each trainer, and config 5, ``"gspmd"``): the epoch and
  the test ranks on the (2, 2) mesh bit-equal to those on the (1, 2) mesh
  (on the CPU the sums add in one order), the replicas' parameters, Adam
  moments, model state and EST's memories bit-equal; a checkpoint written
  by the mesh's first rank alone and restored on all four ranks, every
  tensor equal; RE-GCN's epoch against JAX's
  ``Trainer(mesh=make_mesh(MeshAxes(2, 2)))`` within
  ``tests/test_torch_sharded_train.py``'s limits.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_sharded_hisres as TR
import test_torch_sharded_hyperbolic as TH
import test_torch_sharded_train as TT
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.data.snapshots import build_history, split_by_time
from regcn_torch.hisres import model as HisResModel
from regcn_torch.hisres.train import HisResTrainer
from regcn_torch.hyperbolic import model as HypModel
from regcn_torch.hyperbolic.train import HyperbolicTrainer
from regcn_torch.parallel import halo as H
from regcn_torch.parallel import sharding
from regcn_torch.parallel.collectives import all_gather_rows
from regcn_torch.parallel.mesh import MeshAxes, make_mesh
from regcn_torch.train import loop
from regcn_torch.train import state as train_state
from regcn_torch.train.optim import tree_leaves
from regcn_torch.utils.dtypes import map_tensors

FAMILIES = ("regcn", "headline", "config3", "config5", "hisres")
MODES = ("gspmd", "halo")
CASES = [(f, m) for f in FAMILIES for m in MODES]
DATA_FAMILIES = ("regcn", "headline", "config5", "hisres")
WINDOW = 4  # the training snapshot of the get_loss cases
STEPS = 3
LOSS_ATOL = 1e-2
GRAD_ATOL = 2.0 ** -8
STEP_ATOL = 0.5
BLOBS = {"regcn": (TT.blob_of, TT.state_of), "headline": (TH.blob_of, TH.state_of),
         "config3": (TH.blob_of, TH.state_of), "config5": (TH.blob_of, TH.state_of),
         "hisres": (TR.blob_of, TR.state_of)}
# config 5: the headline with EST (the GRU history encoder) and TANS
EST = dict(use_est=True, use_time_aware_negative=True, est_encoder="gru", est_history_len=4)


def data_of():
    return TT.data_of()  # the three modules' synthetic-small cut, seed 123


def trainer_of(family, data, dtype="float32", **kw):
    """The trainer of ``family`` on the CPU, in compute ``dtype``."""
    if family == "regcn":
        base, tc = TT.configs(data)
        cfg = ExperimentConfig(model=ModelConfig(**base, dtype=dtype), train=TrainConfig(**tc))
        return loop.Trainer(cfg, data, device="cpu", **kw)
    if family == "hisres":
        cfg = HisResModel.HisResConfig(**TR.base_of(data), compute_dtype=dtype)
        return HisResTrainer(cfg, TrainConfig(**TR.TC), data, his_edge_bucket=TR.HIS_EDGE_BUCKET,
                             device="cpu", **kw)
    base = (dict(TH.base_of("headline", data), **EST) if family == "config5" else
            TH.base_of(family, data))
    cfg = HypModel.HyperbolicConfig(**base, compute_dtype=dtype)
    return HyperbolicTrainer(cfg, TrainConfig(**TH.TC), data, device="cpu", **kw)


def loss_inputs(trainer, i):
    if isinstance(trainer, HyperbolicTrainer):
        return (*trainer.window(i), trainer._curvature_max(0), *trainer.est_window(i))
    return trainer.window(i)


def step(trainer, state, i):
    if isinstance(trainer, HyperbolicTrainer):
        return trainer.snapshot_step(state, i, trainer._curvature_max(0))
    return trainer.train_step(state, *trainer.window(i))


def loss_grads(trainer, state) -> dict:
    """The losses at WINDOW and every gradient (the entity tables' whole)."""
    total, losses, *_ = trainer.loss(state, *loss_inputs(trainer, WINDOW))
    leaves = tree_leaves(state.params)
    if trainer.shard is None:
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    else:
        rules = sharding.state_sharding_rules(state)
        grads = sharding.sharded_grads(total, leaves, [not r for r in rules], trainer.shard)
        with torch.no_grad():
            grads = [all_gather_rows(g, trainer.shard.group) if r else g
                     for g, r in zip(grads, rules)]
    return {"losses": {k: float(v.detach()) for k, v in losses.items()},
            "grads": [torch.zeros_like(p) if g is None else g.detach()
                      for g, p in zip(grads, leaves)]}


def whole_params(trainer, state) -> list:
    if trainer.shard is not None:
        state = sharding.unshard_state(state, trainer.shard)
    return [t.detach().clone() for t in tree_leaves(state.params)]


def three_steps(trainer, state) -> list:
    for i in trainer.epoch_order(0)[:STEPS]:
        step(trainer, state, i)
    return whole_params(trainer, state)


def state_leaves(state) -> list:
    """Parameters, Adam moments, every tensor of the model state and EST's
    memories."""
    ms = []
    map_tensors((state.model_state, state.est_state), lambda t: ms.append(t) or t)
    return tree_leaves(state.params) + state.opt_state.mu + state.opt_state.nu + ms


# ---------------------------------------------------------------- the ranks

def _rank_bf16(family, mode, mesh, data, blob) -> dict:
    trainer = trainer_of(family, data, "bfloat16", mesh=mesh, dist_agg=mode)
    state_of = BLOBS[family][1]
    out = loss_grads(trainer, sharding.shard_state(state_of(blob), trainer.shard))
    state = sharding.shard_state(state_of(blob), trainer.shard)
    out["steps"] = three_steps(trainer, state)
    out["dtypes"] = {t.dtype for t in tree_leaves(state.params) + out["grads"]}
    if family == "regcn" and mode == "gspmd":
        state = sharding.shard_state(state_of(blob), trainer.shard)
        out["epoch"] = (trainer.run_epoch(state, 0), whole_params(trainer, state))
    return out


def _rank_analysis(family, mode, mesh, data, blob) -> dict:
    trainer = trainer_of(family, data, mesh=mesh, dist_agg=mode, run_analysis=True)
    return trainer.analysis_record(sharding.shard_state(BLOBS[family][1](blob), trainer.shard))


def aggregate_inputs(data):
    """Training snapshot 3 as a host window, and random entity rows [N, d],
    relations [2R, d], a weight [d, d] and a probe [N, d], from numpy's
    seed 7."""
    rng = np.random.default_rng(7)
    d, n = 16, data.num_nodes

    def normal(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    snaps = split_by_time(data.train)[3:4]
    return (snaps, build_history(snaps, n, data.num_rels, edge_bucket=32),
            normal(n, d), normal(2 * data.num_rels, d), normal(d, d, scale=1.0 / d), normal(n, d))


def _rank_cumsum_aggregate(trainer, data) -> tuple:
    """The rank's rows of the cumsum aggregation of snapshot 3 on its
    destination partition, and the gradients of sum(out * probe) in its
    rows, the relations and the weight (these two summed over ranks)."""
    shard = trainer.shard
    snaps, hist, h, rel, w, probe = aggregate_inputs(data)
    lo, hi = shard.row0, shard.row0 + shard.rows
    mine = [torch.from_numpy(a).requires_grad_(True) for a in (h[lo:hi], rel, w)]
    edges = sharding.attach_partition(hist, snaps, data.num_nodes, data.num_rels, "gspmd",
                                      shard, 32).parts.step(0)
    got = H.sharded_rgcn_aggregate(trainer.mesh, *mine, edges, cumsum=True)
    grads = list(torch.autograd.grad((got * torch.from_numpy(probe[lo:hi])).sum(), mine))
    for g in grads[1:]:
        dist.all_reduce(g, group=shard.group)
    return got.detach(), grads


def _rank_cumsum(mesh, data, blob) -> dict:
    trainer = trainer_of("regcn", data, mesh=mesh, impl="cumsum")
    out = {"aggregate": _rank_cumsum_aggregate(trainer, data),
           "get_loss": loss_grads(trainer, sharding.shard_state(TT.state_of(blob),
                                                                trainer.shard))}
    state = sharding.shard_state(TT.state_of(blob), trainer.shard)
    out["losses"] = [trainer.run_epoch(state, e) for e in range(2)]
    out["params"] = whole_params(trainer, state)
    out["mrr"] = {k: s.mrr for k, s in trainer.test(state).items()}
    return out


def _rank_data(family, mesh, data, blob, workdir) -> dict:
    """One epoch and the test ranks (both meshes); on several replicas,
    every rank's state and a checkpoint written and restored."""
    trainer = trainer_of(family, data, mesh=mesh)
    state = sharding.shard_state(BLOBS[family][1](blob), trainer.shard)
    losses = trainer.run_epoch(state, 0)
    out = {"losses": losses, "params": whole_params(trainer, state),
           "test": TH.recorded_test(trainer, state)}
    if trainer.shard.replicas is None:
        return out
    out["state"] = [t.detach().clone() for t in state_leaves(state)]
    path = os.path.join(workdir, f"ck-{family}")
    writes = []
    save = torch.save
    torch.save = lambda obj, f, *a, **k: writes.append(f) or save(obj, f, *a, **k)
    try:
        train_state.save_checkpoint(path, state, {"epoch": 0}, shard=trainer.shard)
    finally:
        torch.save = save
    back, meta = train_state.restore_checkpoint(path, state, trainer.shard)
    out["writes"] = len(writes)
    out["restored"] = meta == {"epoch": 0} and all(
        torch.equal(a, b) for a, b in zip(state_leaves(back), state_leaves(state)))
    return out


def rank_main(rank: int, data_axis: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.nice(10)  # a helper of this test: the other test workers keep their CPU share
    world = 2 * data_axis
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=world,
                            rank=rank)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inits = pickle.load(f)
    data = data_of()
    mesh = make_mesh(MeshAxes(data_axis, 2), device_type="cpu")
    out = {"data": {f: _rank_data(f, mesh, data, inits[f], workdir) for f in DATA_FAMILIES}}
    if data_axis == 1:
        for family, mode in CASES:
            out["bf16", family, mode] = _rank_bf16(family, mode, mesh, data, inits[family])
            out["analysis", family, mode] = _rank_analysis(family, mode, mesh, data,
                                                           inits[family])
        out["cumsum"] = _rank_cumsum(mesh, data, inits["regcn"])
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


# ------------------------------------------------------------- this process

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_regcn(dtype="float32"):
    """(JAX's data, its RE-GCN experiment config in ``dtype``)."""
    from regcn_tpu.config import ExperimentConfig as JaxExperimentConfig
    from regcn_tpu.config import ModelConfig as JaxModelConfig
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.data.synthetic import generate as jax_generate

    data = jax_generate("synthetic-small", seed=123, **TT.TINY)
    base, tc = TT.configs(data)
    return data, JaxExperimentConfig(model=JaxModelConfig(**base, dtype=dtype),
                                     train=JaxTrainConfig(**tc))


@pytest.fixture(scope="module")
def inits():
    """Every trainer's initial state as a blob: RE-GCN's JAX's, converted;
    the others' the port's own, from their trainers' seeds."""
    import jax

    from regcn_torch.convert import train_state_from_jax
    from regcn_tpu.train.state import create_train_state

    _, jcfg = jax_regcn()
    init = TT.host_copy(create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train))
    data = data_of()
    out = {"regcn": TT.blob_of(train_state_from_jax(init, device="cpu")), "jax_regcn": init}
    for family in FAMILIES[1:]:
        out[family] = BLOBS[family][0](trainer_of(family, data).init_state())
    return out


@pytest.fixture(scope="module")
def rank_results(inits, tmp_path_factory):
    """The ranks' results per mesh, (1, 2) and (2, 2), spawned side by side;
    this process computes the references while they run (the fixtures
    that take this one)."""
    spawns = {}
    for data_axis in (1, 2):
        workdir = str(tmp_path_factory.mktemp(f"data{data_axis}"))
        with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
            pickle.dump({k: v for k, v in inits.items() if k in FAMILIES}, f)
        spawns[data_axis] = workdir, mp.start_processes(
            rank_main, args=(data_axis, workdir), nprocs=2 * data_axis, join=False,
            start_method="spawn")
    return spawns


def ranks_of(rank_results, data_axis) -> list:
    """Every rank's results of the mesh with ``data_axis`` replicas (joined
    once, then read)."""
    workdir, ctx = rank_results[data_axis]
    if not isinstance(ctx, list):
        while not ctx.join():
            pass
        ranks = []
        for r in range(2 * data_axis):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        rank_results[data_axis] = workdir, ranks
    return rank_results[data_axis][1]


@pytest.fixture(scope="module")
def unsharded(inits, rank_results, jax_runs):
    """The unsharded port from the same states: in bf16 and fp32 get_loss
    and 3 steps, the analysis record, and the cumsum route's get_loss
    (after JAX's runs, so that both run while the ranks do)."""
    data = data_of()
    out = {}
    for family in FAMILIES:
        state_of = BLOBS[family][1]
        for dtype in ("bfloat16", "float32"):
            trainer = trainer_of(family, data, dtype, run_analysis=True)
            out[family, dtype] = loss_grads(trainer, state_of(inits[family]))
            out[family, dtype]["steps"] = three_steps(trainer, state_of(inits[family]))
            out[family, dtype]["start"] = whole_params(trainer, state_of(inits[family]))
        out[family, "analysis"] = trainer.analysis_record(state_of(inits[family]))
    trainer = trainer_of("regcn", data, impl="cumsum")
    out["cumsum"] = loss_grads(trainer, TT.state_of(inits["regcn"]))
    return out


@pytest.fixture(scope="module")
def jax_runs(inits, rank_results):
    """JAX's sharded RE-GCN trainer on the virtual mesh from the converted
    state: at (1, 2) under ``"gspmd"`` one fused epoch in bf16 and in fp32
    and the analysis record, with ``impl="cumsum"`` two epochs and the test
    MRRs; at (2, 2) one epoch."""
    import jax

    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from regcn_tpu.parallel.sharding import state_sharding_rules
    from regcn_tpu.train import loop as jax_loop

    init = inits["jax_regcn"]

    def run(mesh, dtype="float32", epochs=1, **kw):
        data, jcfg = jax_regcn(dtype)
        trainer = jax_loop.Trainer(jcfg, data, mesh=mesh, **kw)

        def fresh():
            return jax.device_put(jax.tree.map(jax.numpy.asarray, init),
                                  state_sharding_rules(init, mesh))

        out = {}
        if kw.get("run_analysis"):
            out["analysis"] = trainer.analysis_record(fresh())
        state, losses = fresh(), []
        for epoch in range(epochs):
            state, mean = trainer.run_epoch_fused(state, epoch)
            losses.append(mean)
        out.update(losses=losses, state=TT.host_copy(state))
        if kw.get("impl") == "cumsum":
            out["mrr"] = {k: s.mrr for k, s in trainer.test(state).items()}
        return out

    mesh12 = jax_make_mesh(JaxMeshAxes(1, 2), devices=jax.devices()[:2])
    return {"bfloat16": run(mesh12, "bfloat16"),
            "float32": run(mesh12, run_analysis=True),
            "cumsum": run(mesh12, epochs=2, impl="cumsum"),
            "data": run(jax_make_mesh(JaxMeshAxes(2, 2), devices=jax.devices()[:4]))}


def drift(got, bf16, fp32, atol, ref=None, name=""):
    """||got - fp32|| <= 2 ||bf16 - fp32|| + atol * ref (ref: ||fp32||)."""
    g, b, f = (np.asarray(x, np.float64) for x in (got, bf16, fp32))
    e_got, e_bf16 = np.linalg.norm(g - f), np.linalg.norm(b - f)
    ref = np.linalg.norm(f) if ref is None else ref
    assert e_got <= 2.0 * e_bf16 + atol * ref, (
        f"{name}: |mesh16-fp32| {e_got:.3e} > 2 x |bf16-fp32| {e_bf16:.3e} + {atol} x {ref:.3e}")


def jax_leaves(jstate_params, names) -> list:
    out = []
    for name in names:
        ref = jstate_params
        for k in name.split("/"):
            ref = ref[int(k)] if isinstance(ref, list) else ref[k]
        out.append(np.asarray(ref))
    return out


def names_of(family, inits):
    return TH.paths(BLOBS[family][1](inits[family]).params)


def case_id(case):
    return "-".join(case)


# ------------------------------------------------------------------- bf16

@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bf16_loss_and_every_gradient_match_one_process(rank_results, unsharded, inits, case):
    family, mode = case
    want16, want32 = unsharded[family, "bfloat16"], unsharded[family, "float32"]
    whole = float(np.sqrt(sum(float(g.double().norm()) ** 2 for g in want32["grads"])))
    for res in ranks_of(rank_results, 1):
        got = res["bf16", family, mode]
        for k, v in want32["losses"].items():
            drift(got["losses"][k], want16["losses"][k], v, LOSS_ATOL, name=k)
        for name, g, b, f in zip(names_of(family, inits), got["grads"], want16["grads"],
                                 want32["grads"]):
            drift(g.numpy(), b.numpy(), f.numpy(), GRAD_ATOL, whole, name)
        assert got["dtypes"] == {torch.float32}


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bf16_three_steps_match_one_process(rank_results, unsharded, inits, case):
    family, mode = case
    want16, want32 = unsharded[family, "bfloat16"], unsharded[family, "float32"]
    for res in ranks_of(rank_results, 1):
        got = res["bf16", family, mode]["steps"]
        for name, a, b, f, s in zip(names_of(family, inits), got, want16["steps"],
                                    want32["steps"], want32["start"]):
            moved = float((f.double() - s.double()).norm())
            drift(a.numpy(), b.numpy(), f.numpy(), STEP_ATOL, moved, name)


def test_bf16_epoch_matches_jax_sharded_trainer(rank_results, jax_runs, inits):
    """RE-GCN at G = 2 under ``"gspmd"``: the mesh's bf16 epoch against
    JAX's sharded bf16 and fp32 epochs from the same state."""
    names = names_of("regcn", inits)
    j16, j32 = jax_runs["bfloat16"], jax_runs["float32"]
    start = jax_leaves(inits["jax_regcn"].params, names)
    for res in ranks_of(rank_results, 1):
        losses, params = res["bf16", "regcn", "gspmd"]["epoch"]
        for k in ("entity", "relation"):
            drift(losses[k], j16["losses"][0][k], j32["losses"][0][k], LOSS_ATOL, name=k)
        for name, a, b, f, s in zip(names, params, jax_leaves(j16["state"].params, names),
                                    jax_leaves(j32["state"].params, names), start):
            drift(a.numpy(), b, f, STEP_ATOL, float(np.linalg.norm(f - s)), name)


# ------------------------------------------------------------ run_analysis

@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_analysis_record_matches_one_process(rank_results, unsharded, case):
    family, mode = case
    want = unsharded[family, "analysis"]
    records = [res["analysis", family, mode] for res in ranks_of(rank_results, 1)]
    assert all(r == records[0] for r in records[1:])  # the same record on every rank
    assert set(records[0]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(records[0][k], v, rtol=1e-5, err_msg=k)


def test_analysis_record_matches_jax_sharded_trainer(rank_results, jax_runs):
    want = jax_runs["float32"]["analysis"]
    got = ranks_of(rank_results, 1)[0]["analysis", "regcn", "gspmd"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


# ------------------------------------------------------------------ cumsum

def test_cumsum_aggregate_matches_jax_cumsum(rank_results):
    """Each rank's cumulative-sum aggregation of its destination partition
    against JAX's ``rgcn_aggregate(impl="cumsum")`` over the whole sorted
    edge array, within ``tests/test_torch_native.py``'s limits for the same
    algorithm (rtol 1e-5, atol 1e-6 of the scale). The gradients need
    more: the backward runs the cumulative sum in reverse over the rank's
    prefix, a sum in another order than JAX's (one entry of h's gradient
    1.4e-5 of the scale off), so they take that file's limits for the
    cumsum route against another summation, the exact route (rtol 1e-4,
    atol 1e-5 of the scale)."""
    import jax
    import jax.numpy as jnp

    from regcn_tpu.ops.rgcn_scatter import rgcn_aggregate as jax_rgcn_aggregate

    _, hist, h, rel, w, probe = aggregate_inputs(data_of())
    snap = hist.step(0)

    def jax_fn(h_, rel_, w_):
        out = jax_rgcn_aggregate(h_, rel_, w_, jnp.asarray(snap.src), jnp.asarray(snap.dst),
                                 jnp.asarray(snap.rel), jnp.asarray(snap.edge_mask),
                                 jnp.asarray(snap.in_deg_norm), impl="cumsum", dst_sorted=True)
        return jnp.sum(out * probe), out

    jgrads, jout = jax.grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(h, rel, w)
    jout, jgrads = np.asarray(jout), [np.asarray(g) for g in jgrads]
    for r, res in enumerate(ranks_of(rank_results, 1)):
        got, grads = res["cumsum"]["aggregate"]
        rows = slice(r * got.shape[0], (r + 1) * got.shape[0])
        np.testing.assert_allclose(got.numpy(), jout[rows], rtol=1e-5,
                                   atol=1e-6 * np.abs(jout).max())
        for name, g, want in zip(("h", "rel", "w"), grads, (jgrads[0][rows], *jgrads[1:])):
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_cumsum_get_loss_matches_one_process(rank_results, unsharded):
    want = unsharded["cumsum"]
    for res in ranks_of(rank_results, 1):
        got = res["cumsum"]["get_loss"]
        for k, v in want["losses"].items():
            np.testing.assert_allclose(got["losses"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
        for g, w in zip(got["grads"], want["grads"]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-5)


def test_cumsum_epochs_match_jax_sharded_trainer(rank_results, jax_runs, inits):
    want = jax_runs["cumsum"]
    names = names_of("regcn", inits)
    for res in ranks_of(rank_results, 1):
        got = res["cumsum"]
        for epoch in range(2):
            for k in ("entity", "relation", "static"):
                np.testing.assert_allclose(got["losses"][epoch][k], want["losses"][epoch][k],
                                           rtol=1e-4, atol=1e-5, err_msg=k)
        for name, a, b in zip(names, got["params"], jax_leaves(want["state"].params, names)):
            if name not in TT.SHIFT_INVARIANT:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-5, err_msg=name)
        for k, v in want["mrr"].items():
            assert abs(got["mrr"][k] - v) <= 1e-4, (k, got["mrr"][k], v)


def test_cumsum_under_halo_raises_the_jax_error():
    """JAX's ``check_impl_compatible``: the halo replaces the aggregation
    backend, so ``impl="cumsum"`` with it raises in both packages, before
    any collective."""
    import types

    from regcn_tpu.train import loop as jax_loop

    data = data_of()
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "graph"), shape=(1, 2))
    with pytest.raises(ValueError, match="conflicts with dist_agg='halo'"):
        trainer_of("regcn", data, mesh=mesh, dist_agg="halo", impl="cumsum")
    jdata, jcfg = jax_regcn()
    with pytest.raises(ValueError, match="conflicts with dist_agg='halo'"):
        jax_loop.Trainer(jcfg, jdata, impl="cumsum", mesh=object(), dist_agg="halo")


# --------------------------------------------------------------- data = 2

@pytest.mark.parametrize("family", DATA_FAMILIES)
def test_data_axis_epoch_and_ranks_bit_equal_to_one_replica(rank_results, family):
    one = ranks_of(rank_results, 1)
    two = ranks_of(rank_results, 2)
    for r, res in enumerate(two):
        want, got = one[r % 2]["data"][family], res["data"][family]
        assert got["losses"] == want["losses"]
        assert all(torch.equal(a, b) for a, b in zip(got["params"], want["params"]))
        assert got["test"][0] == want["test"][0]
        assert all(np.array_equal(a, b) for x, y in zip(got["test"][1], want["test"][1])
                   for a, b in zip(x, y))


@pytest.mark.parametrize("family", DATA_FAMILIES)
def test_data_axis_replicas_are_identical(rank_results, family):
    two = ranks_of(rank_results, 2)
    for r in (0, 1):  # graph position r: ranks r (data 0) and 2 + r (data 1)
        a, b = two[r]["data"][family]["state"], two[2 + r]["data"][family]["state"]
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("family", DATA_FAMILIES)
def test_data_axis_checkpoint_written_once_restored_everywhere(rank_results, family):
    two = ranks_of(rank_results, 2)
    # the first rank writes state.pt (torch.save), the other three nothing
    assert [res["data"][family]["writes"] for res in two] == [1, 0, 0, 0]
    assert all(res["data"][family]["restored"] for res in two)


def test_data_axis_epoch_matches_jax_sharded_trainer(rank_results, jax_runs, inits):
    want = jax_runs["data"]
    names = names_of("regcn", inits)
    for res in ranks_of(rank_results, 2):
        got = res["data"]["regcn"]
        for k in ("entity", "relation", "static"):
            np.testing.assert_allclose(got["losses"][k], want["losses"][0][k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        for name, a, b in zip(names, got["params"], jax_leaves(want["state"].params, names)):
            if name not in TT.SHIFT_INVARIANT:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-5, err_msg=name)
