"""The port's entity-sharded RE-GCN trainer on gloo ranks, against
regcn_tpu's sharded trainer.

One spawn of G = 2 and one of G = 4 CPU processes (a ``torch.distributed``
gloo group over a file store, a ``("data", "graph")`` mesh of 1 x G) runs
every case below in both ``dist_agg`` modes; the ranks write their results
and this process compares them. Torch runs on one thread in every rank,
fp32, every dropout 0. JAX's reference is ``Trainer(mesh=make_mesh(
MeshAxes(1, G)), dist_agg=...)`` on conftest's virtual 8-device CPU mesh,
run once per module from JAX's initial state: two fused epochs, then the
test split. This module imports JAX inside its fixtures only, so that the
spawned ranks, which import it to find their entry point, load no JAX.

Tolerances, those of ``tests/test_torch_train.py``:

- the aggregation of each rank's rows and its gradients against the
  unsharded ``rgcn_aggregate`` (B1's plain version): rtol 1e-5, atol 1e-6
  of the largest value (fp32 sums in another order);
- ``get_loss`` against the unsharded port: the losses within rtol 1e-4 /
  atol 1e-5, every gradient within rtol 1e-3 / atol 1e-5;
- two epochs against JAX's sharded trainer: the mean losses within rtol
  1e-4 / atol 1e-5, every parameter (the gathered entity table too) and BN
  statistic within atol 1e-5 + rtol 1e-3, but the decoders' ``conv_b`` and
  ``fc_b``, whose true gradient is 0 and which Adam moves by rounding noise
  (``tests/test_torch_train.py``), so not compared, and the running means
  of the BatchNorms after them (bn1, bn2), which take in that noise: atol
  1e-3, Adam's largest step (lr); the replicated leaves bit-equal on every
  rank;
- the test ranks of JAX's state after the two epochs: the four MRRs
  within 1e-4 of JAX's, and the rank arrays equal but for at most 1 % of
  the queries (near ties that fp32 sums in another order may break the
  other way: JAX's own sharded runs differ by 3e-4 in entity MRR between
  ``gspmd`` and ``halo`` at G = 4 on these data);
- a checkpoint written sharded, restored unsharded, written again and
  restored sharded: every tensor equal;
- ``python -m regcn_torch.cli train`` and ``test`` with ``--shards G``
  and torchrun's variables set, against the same commands unsharded:
  the test MRRs within 1e-3, and ``test`` equal to ``train``'s.
"""

import dataclasses
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.data.snapshots import build_history
from regcn_torch.data.synthetic import generate
from regcn_torch.models import recurrent
from regcn_torch.ops.rgcn_scatter import rgcn_aggregate
from regcn_torch.parallel import halo as H
from regcn_torch.parallel import sharding
from regcn_torch.parallel.mesh import MeshAxes, make_mesh
from regcn_torch.train import loop, metrics
from regcn_torch.train import state as train_state
from regcn_torch.train.optim import AdamState, tree_leaves, tree_map

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
TC = dict(n_epochs=2, train_history_len=3, test_history_len=3, edge_bucket=32, rc_bucket=64,
          triple_bucket=64)
MODES = ("gspmd", "halo")
CASES = [(g, m) for g in (2, 4) for m in MODES]
SHIFT_INVARIANT = {f"{dec}/{b}" for dec in ("decoder_ob", "decoder_rel")
                   for b in ("conv_b", "fc_b")}
# the BatchNorms after conv_b and fc_b take in their noise: each running mean
# moves with its bias, which Adam steps by up to lr = 1e-3 a step
SHIFTED_MEANS = {"bn1/mean", "bn2/mean"}
SHIFTED_MEAN_ATOL = 1e-3
CLI_ARGS = ["-d", "synthetic-small", "--n-epochs", "1", "--n-hidden", "16",
            "--train-history-len", "2", "--test-history-len", "2", "--dropout", "0",
            "--input-dropout", "0", "--hidden-dropout", "0", "--feat-dropout", "0"]


def data_of():
    return generate("synthetic-small", seed=123, **TINY)


def configs(data):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=16, n_layers=2,
                **NO_DROPOUT)
    return base, TC


def port_config(data) -> ExperimentConfig:
    base, tc = configs(data)
    return ExperimentConfig(model=ModelConfig(**base), train=TrainConfig(**tc))


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def blob_of(state) -> dict:
    """A TrainState as plain tensors, for a rank to rebuild (a generator
    does not pickle)."""
    return {"params": tree_map(lambda t: t.detach().clone(), state.params),
            "mu": state.opt_state.mu, "nu": state.opt_state.nu, "count": state.opt_state.count,
            "step": state.step,
            "model_state": train_state.fields_of(state.model_state)}


def state_of(blob):
    """The TrainState of ``blob`` (JAX's key order, as converted)."""
    gen = torch.Generator()
    gen.manual_seed(0)
    return train_state.TrainState(
        params=tree_map(lambda t: t.clone().requires_grad_(True), blob["params"]),
        opt_state=AdamState(count=blob["count"], mu=[t.clone() for t in blob["mu"]],
                            nu=[t.clone() for t in blob["nu"]]),
        model_state=recurrent.ModelState(**blob["model_state"]), gen=gen, step=blob["step"])


# ---------------------------------------------------------------- the ranks

def _rank_aggregate(trainer, rng_seed=7) -> dict:
    """The rank's rows of the aggregation of training snapshot 3, and the
    gradients of sum(out * R), against the unsharded aggregation."""
    shard, data = trainer.shard, trainer.data
    snaps = trainer.train_list[3:4]
    rng = np.random.default_rng(rng_seed)
    d = 16
    h = torch.from_numpy(rng.normal(size=(data.num_nodes, d)).astype(np.float32))
    rel = torch.from_numpy(rng.normal(size=(2 * data.num_rels, d)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(d, d)).astype(np.float32) / d)
    probe = torch.from_numpy(rng.normal(size=(data.num_nodes, d)).astype(np.float32))
    full = [t.clone().requires_grad_(True) for t in (h, rel, w)]
    snap = build_history(snaps, data.num_nodes, data.num_rels, edge_bucket=32).step(0).to("cpu")
    want = rgcn_aggregate(full[0], full[1], full[2], snap.src, snap.dst, snap.rel,
                          snap.edge_mask, snap.in_deg_norm, dst_sorted=True)
    want_g = torch.autograd.grad((want * probe).sum(), full)
    lo, hi = shard.row0, shard.row0 + shard.rows
    mine = [h[lo:hi].clone().requires_grad_(True), rel.clone().requires_grad_(True),
            w.clone().requires_grad_(True)]
    hist = sharding.attach_partition(build_history(snaps, data.num_nodes, data.num_rels,
                                                   edge_bucket=32),
                                     snaps, data.num_nodes, data.num_rels, trainer.dist_agg,
                                     shard, 32)
    fn = H.halo_rgcn_aggregate if trainer.dist_agg == "halo" else H.sharded_rgcn_aggregate
    edges = (hist.halo if trainer.dist_agg == "halo" else hist.parts).step(0)
    got = fn(trainer.mesh, mine[0], mine[1], mine[2], edges)
    got_g = list(torch.autograd.grad((got * probe[lo:hi]).sum(), mine))
    # the loss is partitioned: the replicated inputs' gradients sum over ranks
    for g in got_g[1:]:
        dist.all_reduce(g, group=shard.group)
    out = {"out": (got.detach(), want.detach()[lo:hi]),
           "grads": [(got_g[0], want_g[0][lo:hi]), (got_g[1], want_g[1]),
                     (got_g[2], want_g[2])]}
    if trainer.dist_agg == "halo":
        out.update(_rank_halo_variants(trainer, h, rel, w, snap, edges))
    return out


def _rank_halo_variants(trainer, h, rel, w, snap, edges) -> dict:
    """The halo path's other entry points on the same snapshot: a
    radius-style weight exp(-|s_src - s_dst|) from a per-row scalar, against
    the unsharded aggregation with that edge weight; and
    ``halo_local_aggregate`` with a plain segment sum as its local
    function, against ``halo_rgcn_aggregate``."""
    shard = trainer.shard
    lo, hi = shard.row0, shard.row0 + shard.rows
    row_scalar = lambda x: x.norm(dim=-1)  # noqa: E731
    weight = lambda a, b: torch.exp(-(a - b).abs())  # noqa: E731
    s = row_scalar(h)
    want = rgcn_aggregate(h, rel, w, snap.src, snap.dst, snap.rel, snap.edge_mask,
                          snap.in_deg_norm, dst_sorted=True,
                          edge_weight=weight(s[snap.src], s[snap.dst]))
    got = H.halo_rgcn_aggregate(trainer.mesh, h[lo:hi], rel, w, edges, row_scalar_fn=row_scalar,
                                edge_weight_fn=weight)

    def local_fn(hbuf, src, dst, mask, rl, norm, has_in, rows):
        msg = (hbuf[src] + rel[rl]) @ w * mask[:, None]
        return torch.zeros(rows, msg.shape[1]).index_add_(0, dst, msg) * norm[:, None]

    local = H.halo_local_aggregate(trainer.mesh, h[lo:hi], edges, local_fn)
    plain = H.halo_rgcn_aggregate(trainer.mesh, h[lo:hi], rel, w, edges)
    return {"weighted": (got, want[lo:hi]), "local_fn": (local, plain)}


def _rank_get_loss(trainer, init) -> dict:
    """Losses and every gradient of the sharded loss against the
    unsharded port's, from the converted initial state, at window 4."""
    plain = loop.Trainer(trainer.cfg, trainer.data, device="cpu")
    full = state_of(init)
    total, losses, _ = plain.loss(full, *plain.window(4))
    want_g = torch.autograd.grad(total, tree_leaves(full.params), allow_unused=True)
    mine = sharding.shard_state(full, trainer.shard)
    total_s, losses_s, _ = trainer.loss(mine, *trainer.window(4))
    rules = sharding.state_sharding_rules(mine)
    got_g = sharding.sharded_grads(total_s, tree_leaves(mine.params), [not r for r in rules],
                                   trainer.shard)
    lo, hi = trainer.shard.row0, trainer.shard.row0 + trainer.shard.rows
    names = paths(full.params)
    return {"losses": ({k: float(v) for k, v in losses_s.items()},
                       {k: float(v) for k, v in losses.items()}),
            "grads": [(n, g.detach(), (torch.zeros_like(p) if w is None else w)[lo:hi] if r
                       else (torch.zeros_like(p) if w is None else w))
                      for n, g, w, r, p in zip(names, got_g, want_g, rules,
                                               tree_leaves(full.params))]}


def _rank_epochs(trainer, init) -> dict:
    state = sharding.shard_state(state_of(init), trainer.shard)
    out = {"losses": [], "states": [], "replicated": []}
    for epoch in range(2):
        out["losses"].append(trainer.run_epoch(state, epoch))
        whole = sharding.unshard_state(state, trainer.shard)
        out["states"].append((paths(whole.params),
                              [t.detach().clone() for t in tree_leaves(whole.params)],
                              {bn: (paths(getattr(whole.model_state, bn)),
                                    [t.clone() for t in tree_leaves(getattr(whole.model_state,
                                                                            bn))])
                               for bn in ("bn_ob", "bn_rel")}))
    rules = sharding.state_sharding_rules(state)
    out["replicated"] = [t.detach().clone() for t, r in zip(tree_leaves(state.params), rules)
                         if not r]
    return out, state


def _rank_test(trainer, final) -> dict:
    state = sharding.shard_state(state_of(final), trainer.shard)
    seen = []
    stat_ranks = metrics.stat_ranks

    def recording(arrays, *a, **kw):
        seen.append([np.asarray(r) for r in arrays])
        return stat_ranks(arrays, *a, **kw)

    metrics.stat_ranks = recording
    try:
        stats = trainer.test(state)
    finally:
        metrics.stat_ranks = stat_ranks
    return {"mrr": {k: s.mrr for k, s in stats.items()}, "ranks": seen}


def _rank_checkpoint(trainer, state, workdir) -> dict:
    """Sharded -> unsharded -> sharded; True where every tensor came back."""
    shard = trainer.shard
    a, b = os.path.join(workdir, f"ck-{trainer.dist_agg}-a"), os.path.join(
        workdir, f"ck-{trainer.dist_agg}-b")
    train_state.save_checkpoint(a, state, {"epoch": 1}, shard=shard)
    gathered = sharding.unshard_state(state, shard)
    whole, meta = train_state.restore_checkpoint(a, gathered)
    ok = meta == {"epoch": 1} and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(whole.params) + whole.opt_state.mu
                                          + whole.opt_state.nu,
                                          tree_leaves(gathered.params) + gathered.opt_state.mu
                                          + gathered.opt_state.nu))
    if shard.rank == 0:
        train_state.save_checkpoint(b, whole, {"epoch": 1})
    dist.barrier(group=shard.group)
    back, _ = train_state.restore_checkpoint(b, state, shard)
    ok = ok and all(torch.equal(x, y) for x, y in zip(
        tree_leaves(back.params) + back.opt_state.mu + back.opt_state.nu,
        tree_leaves(state.params) + state.opt_state.mu + state.opt_state.nu))
    ok = ok and back.opt_state.count == state.opt_state.count and back.step == state.step
    return {"round_trip": ok}


def _rank_cli(G, mode, workdir, data) -> dict:
    import regcn_torch.data as pt_data
    from regcn_torch import cli

    pt_data.load_data = lambda *a, **k: data
    os.environ.update(RANK=str(dist.get_rank()), LOCAL_RANK=str(dist.get_rank()),
                      WORLD_SIZE=str(G), MASTER_ADDR="localhost", MASTER_PORT="1")
    models = os.path.join(workdir, f"cli-{mode}")
    argv = [*CLI_ARGS, "--shards", str(G), "--dist-agg", mode, "--models-dir", models]
    trained = cli.main(["train", *argv], device="cpu")
    tested = cli.main(["test", *argv], device="cpu")
    wrong = None
    try:
        cli.main(["train", *CLI_ARGS, "--shards", str(G + 1), "--models-dir", models],
                 device="cpu")
    except SystemExit as e:
        wrong = str(e)
    return {"train": trained, "test": tested, "wrong_shards": wrong}


def write_input(workdir: str, name: str, value) -> None:
    """``value`` into ``workdir`` as ``name``.pkl for the ranks, whole or
    not at all (written beside, then renamed)."""
    path = os.path.join(workdir, f"{name}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(value, f)
    os.replace(path + ".tmp", path)


def read_input(workdir: str, name: str, timeout_s: float = 1800.0):
    """A rank's input ``name``.pkl from ``workdir``, waiting until the test
    process has written it: the ranks start with what they can run and
    meet the late inputs (states that the test process computes while they
    run) when they need them."""
    path, waited = os.path.join(workdir, f"{name}.pkl"), 0.0
    while not os.path.exists(path):
        if waited > timeout_s:
            raise TimeoutError(f"{path} was not written within {timeout_s} s")
        time.sleep(0.1)
        waited += 0.1
    with open(path, "rb") as f:
        return pickle.load(f)


def rank_main(rank: int, G: int, workdir: str) -> None:
    torch.set_num_threads(1)
    os.nice(10)  # a helper of this test: the other test workers keep their CPU share
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=G,
                            rank=rank)
    init = read_input(workdir, "init")
    data = data_of()
    mesh = make_mesh(MeshAxes(1, G), device_type="cpu")
    results = {}
    for mode in MODES:
        trainer = loop.Trainer(port_config(data), data, mesh=mesh, dist_agg=mode, device="cpu")
        res = {"aggregate": _rank_aggregate(trainer),
               "get_loss": _rank_get_loss(trainer, init)}
        res["epochs"], state = _rank_epochs(trainer, init)
        res["test"] = _rank_test(trainer, read_input(workdir, "final")[mode])
        res.update(_rank_checkpoint(trainer, state, workdir))
        res["cli"] = _rank_cli(G, mode, workdir, data)
        if mode == "halo":
            try:
                trainer.test(state, multi_step=True)
            except ValueError as e:
                res["multi_step_halo"] = str(e)
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
    """(JAX's data and experiment config, its initial state as numpy)."""
    import jax

    from regcn_tpu.config import ExperimentConfig as JaxExperimentConfig
    from regcn_tpu.config import ModelConfig as JaxModelConfig
    from regcn_tpu.config import TrainConfig as JaxTrainConfig
    from regcn_tpu.data.synthetic import generate as jax_generate
    from regcn_tpu.train.state import create_train_state

    data = jax_generate("synthetic-small", seed=123, **TINY)
    base, tc = configs(data)
    jcfg = JaxExperimentConfig(model=JaxModelConfig(**base), train=JaxTrainConfig(**tc))
    return data, jcfg, host_copy(create_train_state(jax.random.PRNGKey(0), jcfg.model,
                                                    jcfg.train))


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """The spawns of G = 2 and G = 4, side by side, from JAX's converted
    initial state; JAX's final states reach them later (``jax_runs``)."""
    from regcn_torch.convert import train_state_from_jax

    init = blob_of(train_state_from_jax(jax_setup()[2], device="cpu"))
    out = {}
    for G in (2, 4):
        workdir = str(tmp_path_factory.mktemp(f"g{G}"))
        write_input(workdir, "init", init)
        out[G] = workdir, mp.start_processes(rank_main, args=(G, workdir), nprocs=G,
                                             join=False, start_method="spawn")
    return out


@pytest.fixture(scope="module")
def jax_runs(spawns):
    """JAX's sharded trainer per (G, mode), while the ranks run: the initial
    state, the states and mean losses after two fused epochs, and the test
    ranks of the last state, whose converted state goes to the ranks."""
    import jax

    from regcn_torch.convert import train_state_from_jax
    from regcn_tpu.parallel.mesh import MeshAxes as JaxMeshAxes
    from regcn_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from regcn_tpu.parallel.sharding import state_sharding_rules
    from regcn_tpu.train import loop as jax_loop
    from regcn_tpu.train import metrics as jax_metrics

    data, jcfg, init = jax_setup()
    runs = {}
    for G, mode in CASES:
        mesh = jax_make_mesh(JaxMeshAxes(1, G), devices=jax.devices()[:G])
        trainer = jax_loop.Trainer(jcfg, data, mesh=mesh, dist_agg=mode)
        state = jax.device_put(jax.tree.map(jax.numpy.asarray, init),
                               state_sharding_rules(init, mesh))
        states, losses = [], []
        for epoch in range(2):
            state, mean = trainer.run_epoch_fused(state, epoch)
            states.append(host_copy(state))
            losses.append(mean)
        seen = []
        stat_ranks = jax_metrics.stat_ranks
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax_metrics, "stat_ranks",
                      lambda arrays, *a, **kw: seen.append([np.asarray(r) for r in arrays])
                      or stat_ranks(arrays, *a, **kw))
            stats = trainer.test(state)
        runs[G, mode] = {"states": states, "losses": losses, "ranks": seen,
                         "mrr": {k: s.mrr for k, s in stats.items()}}
        if mode == MODES[-1]:
            write_input(spawns[G][0], "final", {
                m: blob_of(train_state_from_jax(runs[G, m]["states"][-1], device="cpu"))
                for m in MODES})
    return init, runs


@pytest.fixture(scope="module")
def rank_results(spawns, jax_runs):
    """Every rank's results, per (G, mode)."""
    out = {}
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


@pytest.fixture(scope="module")
def cli_unsharded(tmp_path_factory):
    """The same CLI commands without --shards."""
    import regcn_torch.data as pt_data
    from regcn_torch import cli

    data = data_of()
    workdir = str(tmp_path_factory.mktemp("cli"))
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pt_data, "load_data", lambda *a, **k: data)
        return cli.main(["train", *CLI_ARGS, "--models-dir", workdir], device="cpu")


def case_id(case):
    return f"G{case[0]}-{case[1]}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_aggregate_and_its_gradients_match_unsharded(rank_results, case):
    for res in rank_results[case]:
        got, want = res["aggregate"]["out"]
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
        for (g, w), name in zip(res["aggregate"]["grads"], ("h", "rel_emb", "weight")):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6 * w.abs().max().item(),
                                       msg=name)


@pytest.mark.parametrize("G", [2, 4])
def test_halo_weighted_and_generic_aggregations(rank_results, G):
    """``halo_rgcn_aggregate``'s per-row scalar and edge weight (the
    hyperbolic union layers' radius weight) against the unsharded
    aggregation with that weight, and ``halo_local_aggregate`` against it
    with a plain segment sum; rtol 1e-5, atol 1e-6 of the scale."""
    for res in rank_results[G, "halo"]:
        for key in ("weighted", "local_fn"):
            got, want = res["aggregate"][key]
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * want.abs().max().item(),
                                       msg=key)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_get_loss_and_every_gradient_match_unsharded(rank_results, case):
    for res in rank_results[case]:
        got, want = res["get_loss"]["losses"]
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
        for name, g, w in res["get_loss"]["grads"]:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_epochs_match_jax_sharded_trainer(rank_results, jax_runs, case, epoch):
    want = jax_runs[1][case]
    for res in rank_results[case]:
        got = res["epochs"]["losses"][epoch]
        for k in ("entity", "relation", "static"):
            np.testing.assert_allclose(got[k], want["losses"][epoch][k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        names, params, bns = res["epochs"]["states"][epoch]
        jstate = want["states"][epoch]
        for name, leaf in zip(names, params):
            if name in SHIFT_INVARIANT:
                continue
            ref = jstate.params
            for k in name.split("/"):
                ref = ref[int(k)] if isinstance(ref, list) else ref[k]
            np.testing.assert_allclose(leaf.numpy(), ref, rtol=1e-3, atol=1e-5, err_msg=name)
        for bn, (bn_names, leaves) in bns.items():
            for name, leaf in zip(bn_names, leaves):
                ref = getattr(jstate.model_state, bn)
                for k in name.split("/"):
                    ref = ref[k]
                atol = SHIFTED_MEAN_ATOL if name in SHIFTED_MEANS else 1e-5
                np.testing.assert_allclose(leaf.numpy(), ref, rtol=1e-3, atol=atol,
                                           err_msg=f"{bn}/{name}")
    # the replicated parameters are bit-equal on every rank
    first = rank_results[case][0]["epochs"]["replicated"]
    for res in rank_results[case][1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, res["epochs"]["replicated"]))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_test_ranks_match_jax(rank_results, jax_runs, case):
    want = jax_runs[1][case]
    for res in rank_results[case]:
        for k, w in want["mrr"].items():
            assert abs(res["test"]["mrr"][k] - w) <= 1e-4, (k, res["test"]["mrr"][k], w)
        got = np.concatenate([np.concatenate(a) for a in res["test"]["ranks"]])
        ref = np.concatenate([np.concatenate(a) for a in want["ranks"]])
        assert got.shape == ref.shape
        assert np.mean(got != ref) <= 0.01, np.mean(got != ref)
        if case[1] == "halo":
            assert "dist_agg='halo'" in res["multi_step_halo"]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_checkpoint_round_trip_sharded_unsharded_sharded(rank_results, case):
    assert all(res["round_trip"] for res in rank_results[case])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_cli_shards_train_and_test(rank_results, cli_unsharded, case):
    G = case[0]
    for res in rank_results[case]:
        cli = res["cli"]
        assert cli["train"] == cli["test"]
        for k, w in cli_unsharded.items():
            for metric, v in w.items():
                assert abs(cli["train"][k][metric] - v) <= 1e-3, (k, metric)
        assert f"--shards {G + 1} needs that many processes" in cli["wrong_shards"]
