"""The port's command-line driver, ``regcn_torch.cli``, against ``regcn_tpu.cli``.

At a tiny shape (60 entities, 5 relations, 12 snapshots: the data of
``tests/test_sweep.py``, served to both CLIs for any dataset name), every
dropout 0, on the CPU (``main(argv, device="cpu")``):

- the parser equals JAX's: every option's destination, default, choices,
  type and whether it is required; ``grid_table``, the range tables and
  ``model_name`` equal JAX's;
- ``train`` then ``test``: the port's printed MRRs equal a JAX CLI run of
  the same arguments within 1e-4 (the port starts from JAX's initial
  state, converted: the two packages' random streams differ), and
  ``test`` restores ``train``'s checkpoint and prints the same numbers;
- ``hyperbolic`` (LGCN + RotH) likewise against the JAX CLI;
- ``hisres``, ``entity`` and the grids (sequential and ``--vectorize``):
  the configs the port's CLI builds equal those JAX's builds (read off
  JAX's trainers as its CLI calls them), and the CLI's results equal the
  port's own trainer called directly with JAX's configs (those trainers
  are held against JAX in their own files);
- every flag-rejection rule stops as JAX's does; ``bench``, ``--shards``
  and ``--dist-agg halo`` stop naming their ROADMAP items,
  ``--compute-dtype bfloat16`` reaches the trainer's loss as bf16, and a
  CUDA run without a card stops;
- ``--dilate-len 2`` trains on the dilated list, and
  ``dilate_snapshots`` equals JAX's array for array;
- the profiling helpers: ``parameter_count`` and ``training_summary``
  equal JAX's, ``StepTimer``, and ``trace`` writing a Chrome trace.

JAX's ``use_fast_prng`` (TPU mechanics) is left out of its CLI runs, so
its initial state is the threefry ``PRNGKey(seed)`` one that the test
rebuilds and converts.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import regcn_tpu.data as jax_data
import regcn_tpu.utils.prng as jax_prng
import regcn_torch.data as pt_data
from regcn_tpu import cli as jax_cli
from regcn_tpu.data.snapshots import dilate_snapshots as jax_dilate
from regcn_tpu.data.synthetic import generate as jax_generate
from regcn_torch import cli
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.convert import _like, train_state_from_jax
from regcn_torch.data.snapshots import dilate_snapshots, split_by_time
from regcn_torch.data.synthetic import generate
from regcn_torch.train import loop as pt_loop
from regcn_torch.train import state as pt_state
from regcn_torch.utils.dtypes import tree_to_compute

TINY = dict(num_ents=60, num_rels=5, num_snaps=12, triples_per_snap=40, split=(8, 2, 2))
NO_DROPOUT = ["--dropout", "0", "--input-dropout", "0", "--hidden-dropout", "0",
              "--feat-dropout", "0"]
COMMON = ["-d", "synthetic-small", "--n-epochs", "2", "--n-hidden", "16",
          "--train-history-len", "2", "--test-history-len", "2", *NO_DROPOUT]
HYPERBOLIC = ["--encoder", "lgcn", "--decoder", "roth", "--n-bases", "4", "--n-hidden", "8"]
MRR_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    """(JAX's data, the port's data), served to both CLIs for every name."""
    jdata, pdata = jax_generate("synthetic-small", seed=17, **TINY), generate(
        "synthetic-small", seed=17, **TINY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_data, "load_data", lambda *a, **k: jdata)
        mp.setattr(pt_data, "load_data", lambda *a, **k: pdata)
        mp.setattr(jax_prng, "use_fast_prng", lambda: None)
        yield jdata, pdata


def run_cli(module, argv, workdir, **kw):
    """``module.main(argv)`` with checkpoints and grid logs under ``workdir``."""
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        return module.main([*argv, "--models-dir", str(workdir / "models")], **kw)
    finally:
        os.chdir(cwd)


def assert_mrrs_close(got, want):
    assert set(got) == set(want)
    for key in want:
        assert set(got[key]) == set(want[key])
        for metric, w in want[key].items():
            assert abs(got[key][metric] - w) <= MRR_TOL, (key, metric, got[key][metric], w)


# ------------------------------------------------------------------ parser

def options(parser):
    return {a.dest: (a.default, a.choices, a.type, a.required, a.nargs, a.const,
                     type(a).__name__, tuple(a.option_strings))
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    got, want = options(cli.build_parser()), options(jax_cli.build_parser())
    assert got == want
    assert len(got) > 70
    assert cli.build_parser().prog == "regcn_torch"


def test_grid_table_and_model_name_match_jax():
    assert cli.HP_RANGE == jax_cli.HP_RANGE
    assert cli.HP_RANGE_BY_DATASET == jax_cli.HP_RANGE_BY_DATASET
    assert cli.HP_RANGE_HISRES == jax_cli.HP_RANGE_HISRES
    assert cli.VECTORIZABLE == jax_cli.VECTORIZABLE
    for dataset in ("synthetic-small", "synthetic-wiki", "ICEWS18", "synthetic-gdelt", "YAGO"):
        for family in ("regcn", "hyperbolic", "hisres"):
            assert cli.grid_table(dataset, family) == jax_cli.grid_table(dataset, family)
    for argv in (["train", "-d", "x"], ["train", "-d", "ICEWS14s", "--dilate-len", "2",
                                         "--dropout", "0.3", "--weight", "0.1"]):
        assert cli.model_name(cli.build_parser().parse_args(argv)) == jax_cli.model_name(
            jax_cli.build_parser().parse_args(argv))
        assert "|" in cli.model_name(cli.build_parser().parse_args(argv))


# ------------------------------------------------- train / test, hyperbolic

def regcn_init(jdata, argv):
    """The port's train state from JAX's initial one (``PRNGKey(seed)``), its
    parameters in the port's own order so that checkpoints restore."""
    from regcn_tpu.train.state import create_train_state as jax_create

    args = jax_cli.build_parser().parse_args(argv)
    jcfg = jax_cli.make_experiment(args, jdata)
    jstate = jax.tree.map(np.array, jax_create(jax.random.PRNGKey(args.seed), jcfg.model,
                                               jcfg.train))
    got = train_state_from_jax(jstate, device="cpu")
    pcfg = cli.make_experiment(cli.build_parser().parse_args(argv), jdata)
    template = pt_state.create_train_state(args.seed, pcfg.model, pcfg.train, "cpu")
    params = _like(got.params, template.params)
    return pt_state.state_from(params, got.model_state, pcfg.train, args.seed + 1, "cpu")


@pytest.fixture(scope="module")
def train_runs(tiny, tmp_path_factory):
    """JAX's CLI ``train``, then the port's ``train`` (from JAX's initial
    state) and ``test``."""
    jdata, _ = tiny
    argv = ["train", *COMMON]
    want = run_cli(jax_cli, argv, tmp_path_factory.mktemp("jax"))
    init = regcn_init(jdata, argv)
    work = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt_loop.Trainer, "init_state",
                   lambda self, seed=None: pt_state.copy_state(init))
        got = run_cli(cli, argv, work, device="cpu")
    tested = run_cli(cli, ["test", *COMMON], work, device="cpu")
    return want, got, tested


def test_train_then_test_matches_jax(train_runs):
    want, got, tested = train_runs
    assert_mrrs_close(got, want)
    assert tested == got
    assert 0 < got["ent_raw"]["mrr"] <= 1 and "hits@10" in got["ent_filter"]


def test_hyperbolic_matches_jax(tiny, tmp_path_factory):
    from regcn_tpu.hyperbolic.train import HyperbolicTrainer as JaxHyperbolicTrainer
    from regcn_torch.hyperbolic.train import HyperbolicTrainer

    jdata, _ = tiny
    argv = ["hyperbolic", *COMMON, *HYPERBOLIC]
    want = run_cli(jax_cli, argv, tmp_path_factory.mktemp("jax"))
    args = jax_cli.build_parser().parse_args(argv)
    jcfg, jtc = jax_cli.make_hyperbolic_configs(args, jdata)
    jstate = JaxHyperbolicTrainer(jcfg, jtc, jdata).init_state(jax.random.PRNGKey(args.seed))
    init = train_state_from_jax(jax.tree.map(np.array, jstate), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(HyperbolicTrainer, "init_state", lambda self, seed=None: init)
        got = run_cli(cli, argv, tmp_path_factory.mktemp("port"), device="cpu")
    assert_mrrs_close(got, want)


# ---------------------------------------- configs read off JAX's trainers

class Captured(Exception):
    """Stops JAX's CLI where it hands its configs to a trainer."""


def capture(mp, module, name):
    """Replaces ``module.name`` with a stub that raises ``Captured`` carrying
    the arguments it was called with."""
    def stub(*args, **kwargs):
        raise Captured(args, kwargs)

    mp.setattr(module, name, stub)


def asdict(cfg):
    return dataclasses.asdict(cfg)


def test_hisres_matches_its_trainer(tiny, tmp_path):
    import regcn_tpu.hisres.train as jax_hisres_train
    from regcn_torch.hisres.model import HisResConfig
    from regcn_torch.hisres.train import HisResTrainer

    jdata, pdata = tiny
    argv = ["hisres", *COMMON, "--n-bases", "4"]
    with pytest.MonkeyPatch.context() as mp:
        capture(mp, jax_hisres_train, "HisResTrainer")
        with pytest.raises(Captured) as seen:
            jax_cli.main(argv)
    (jcfg, jtc, _), kwargs = seen.value.args
    assert kwargs["rel_window_mode"] == "full"
    pcfg, ptc = cli.make_hisres_configs(cli.build_parser().parse_args(argv), pdata)
    assert asdict(pcfg) == asdict(jcfg) and asdict(ptc) == asdict(jtc)
    got = run_cli(cli, argv, tmp_path, device="cpu")
    trainer = HisResTrainer(HisResConfig(**asdict(jcfg)), TrainConfig(**asdict(jtc)), pdata,
                            device="cpu")
    best, _ = trainer.fit()
    want = trainer.test(best)
    assert got == {k: {"mrr": s.mrr, **{f"hits@{h}": v for h, v in s.hits.items()}}
                   for k, s in want.items()}


def test_entity_matches_its_fit():
    import regcn_tpu.models.entity_classifier as jax_ec
    from regcn_torch.data.rdf import load_entity_data
    from regcn_torch.models import entity_classifier as ec

    argv = ["entity", "-d", "synthetic-entity-small", "--n-hidden", "8", "--n-epochs", "10",
            "--dropout", "0"]
    with pytest.MonkeyPatch.context() as mp:
        capture(mp, jax_ec, "fit")
        with pytest.raises(Captured) as seen:
            jax_cli.main(argv)
    (_, jdata, jcfg), _ = seen.value.args
    cfg = ec.EntityClassifierConfig(**asdict(jcfg))
    got = cli.main(argv, device="cpu")
    data = load_entity_data("synthetic-entity-small", seed=2023)
    np.testing.assert_array_equal(data.edge_src, jdata.edge_src)
    params, losses = ec.fit(2023, data, cfg, device="cpu")
    want = {"train_acc": ec.evaluate(params, data, cfg, idx=data.train_idx),
            "test_acc": ec.evaluate(params, data, cfg), "final_loss": losses[-1]}
    assert got == want
    assert len(losses) == 10 and losses[-1] < losses[0]


def test_sequential_grid_matches_its_trainer(tiny, tmp_path):
    """``grid --tune n_layers``: a row per combo from the port's Trainer with
    JAX's ``make_experiment`` of that combo, each in its own checkpoint
    directory; the hyperbolic and hisres families route to their runners."""
    jdata, pdata = tiny
    argv = ["grid", *COMMON, "--n-epochs", "1", "--tune", "n_layers"]
    rows = run_cli(cli, argv, tmp_path, device="cpu")
    assert [r["params"] for r in rows] == [{"n_layers": 1}, {"n_layers": 2}]
    for row in rows:
        args = jax_cli.build_parser().parse_args(["train", *argv[1:]])
        args.n_layers = row["params"]["n_layers"]
        jcfg = jax_cli.make_experiment(args, jdata)
        exp = ExperimentConfig(model=ModelConfig(**asdict(jcfg.model)),
                               train=TrainConfig(**asdict(jcfg.train)))
        trainer = pt_loop.Trainer(exp, pdata, device="cpu")
        best, _ = trainer.fit()
        assert row["test_ent_mrr_raw"] == trainer.test(best)["ent_raw"].mrr
    ckpts = os.listdir(tmp_path / "models" / "grid-regcn")
    assert len(ckpts) == 2 and all(c.endswith(("n_layers=1", "n_layers=2")) for c in ckpts)
    assert (tmp_path / "synthetic-small.uvrgcn-convtranse.gs").read_text().count("\n") == 2

    for family, runner in (("hyperbolic", "run_hyperbolic"), ("hisres", "run_hisres")):
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cli, runner, lambda a: calls.append((a.lr, a.checkpoint)) or
                       {"ent_raw": {"mrr": 0.1 * len(calls)}})
            rows = run_cli(cli, ["grid", "-d", "synthetic-small", "--grid-family", family,
                                 "--tune", "lr"], tmp_path, device="cpu")
        assert [c[0] for c in calls] == cli.HP_RANGE["lr"] and len(rows) == 2
        assert all(f"grid-{family}" in c[1] for c in calls)


def test_vectorized_grid_matches_its_sweep(tiny, tmp_path):
    """``grid --tune lr --vectorize`` for the regcn and the hyperbolic
    family: the rows of the port's sweep runner with JAX's configs; the
    hisres family stops, as in JAX."""
    from regcn_torch.hyperbolic.model import HyperbolicConfig
    from regcn_torch.train.sweep import HyperbolicSweepRunner, SweepRunner

    jdata, pdata = tiny
    combos = {"lr": cli.HP_RANGE["lr"]}
    for family, extra in (("regcn", []), ("hyperbolic", HYPERBOLIC)):
        argv = ["grid", *COMMON, "--n-epochs", "1", "--tune", "lr", "--vectorize",
                "--grid-family", family, *extra]
        rows = run_cli(cli, argv, tmp_path, device="cpu")
        args = jax_cli.build_parser().parse_args(["train", *argv[1:]])
        if family == "regcn":
            jcfg = jax_cli.make_experiment(args, jdata)
            runner = SweepRunner(ModelConfig(**asdict(jcfg.model)),
                                 TrainConfig(**asdict(jcfg.train)), pdata, combos, device="cpu")
        else:
            jcfg, jtc = jax_cli.make_hyperbolic_configs(args, jdata)
            runner = HyperbolicSweepRunner(HyperbolicConfig(**asdict(jcfg)),
                                           TrainConfig(**asdict(jtc)), pdata, combos,
                                           device="cpu")
        want, _ = runner.run()
        assert rows == [{"params": {"lr": r["lr"]}, "valid_ent_mrr_raw": r["valid_ent_mrr_raw"]}
                        for r in want]
    for module in (cli, jax_cli):
        with pytest.raises(SystemExit, match="hisres"):
            run_cli(module, ["grid", "-d", "synthetic-small", "--tune", "lr", "--vectorize",
                             "--grid-family", "hisres"], tmp_path,
                    **({"device": "cpu"} if module is cli else {}))


# ------------------------------------------------------------------ refusals

@pytest.mark.parametrize("argv", [
    ["entity", "-d", "synthetic-entity-small", "--multi-step"],
    ["entity", "-d", "synthetic-entity-small", "--relation-evaluation"],
    ["bench", "-d", "synthetic-small", "--run-analysis"],
    ["grid", "-d", "synthetic-small", "--tune", "bogus_param"],
    ["grid", "-d", "synthetic-small", "--tune", "lr", "--vectorize", "--multi-step"],
    ["grid", "-d", "synthetic-small", "--tune", "seed", "--vectorize", "--run-analysis"],
    ["train", "-d", "synthetic-small", "--dist-agg", "halo"],
], ids=["entity-multi-step", "entity-relation-evaluation", "bench-run-analysis", "unknown-tune",
        "vectorize-multi-step", "vectorize-run-analysis", "halo-without-shards"])
def test_rejections_match_jax(tiny, tmp_path, argv):
    for module, kw in ((jax_cli, {}), (cli, {"device": "cpu"})):
        with pytest.raises(SystemExit):
            run_cli(module, argv, tmp_path, **kw)


@pytest.mark.parametrize("argv, item", [
    (["bench", "-d", "synthetic-small"], "A.2"),
    (["grid", "-d", "synthetic-small", "--tune", "lr", "--vectorize", "--shards", "2"],
     "A.11b"),
    (["hyperbolic", "-d", "synthetic-small", "--shards", "2", "--dist-agg", "halo",
      "--compute-dtype", "bfloat16"], "A.11b"),
], ids=["bench", "shards", "halo"])
def test_unported_modes_stop_naming_their_roadmap_item(tiny, tmp_path, argv, item):
    """``hyperbolic`` and ``hisres`` on a mesh, stopped here until they were
    ported, now run (``tests/test_torch_sharded_hyperbolic.py``,
    ``tests/test_torch_sharded_hisres.py``); what stays unported on a mesh
    stops before any process group: the vectorized grid's model axis, and
    bf16 (or ``--run-analysis``) with ``--shards``; EST and the static
    graph with ``--shards``, stopped here until they were ported, run
    (``tests/test_torch_sharded_est.py``)."""
    with pytest.raises(SystemExit, match=item):
        run_cli(cli, argv, tmp_path, device="cpu")


def test_shards_outside_torchrun_stops_naming_it(tiny, tmp_path, monkeypatch):
    """``train --shards 2`` runs one process per shard: without torchrun's
    environment and without a process group it stops, naming torchrun
    (``tests/test_torch_sharded_train.py`` runs it on gloo ranks)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        run_cli(cli, ["train", "-d", "synthetic-small", "--shards", "2"], tmp_path,
                device="cpu")


def test_bfloat16_and_a_missing_card(tiny, tmp_path, monkeypatch):
    """``--compute-dtype bfloat16``, refused until bf16 compute was ported,
    now trains: every loss of the run casts to bf16, and the test MRRs are
    finite."""
    seen = []

    def recording(tree, dtype):
        seen.append(dtype)
        return tree_to_compute(tree, dtype)

    monkeypatch.setattr(pt_loop, "tree_to_compute", recording)
    out = run_cli(cli, ["train", *COMMON, "--compute-dtype", "bfloat16"], tmp_path,
                  device="cpu")
    assert seen and set(seen) == {torch.bfloat16}
    assert all(0.0 < v["mrr"] <= 1.0 for v in out.values()), out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            run_cli(cli, ["train", *COMMON], tmp_path)


# ------------------------------------------------------------------ dilation

def test_dilate_len_trains_on_the_dilated_list(tiny, tmp_path):
    jdata, pdata = tiny
    snaps = split_by_time(pdata.train)
    for k in (1, 2, 3, 5):
        got, want = dilate_snapshots(snaps, k), jax_dilate(snaps, k)
        assert len(got) == len(want) == -(-len(snaps) // k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    seen = []
    fit = pt_loop.Trainer.fit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt_loop.Trainer, "fit", lambda self, **kw: seen.append(self.train_list)
                   or fit(self, **kw))
        result = run_cli(cli, ["train", *COMMON, "--n-epochs", "1", "--dilate-len", "2"],
                         tmp_path, device="cpu")
    assert len(seen[0]) == len(snaps) // 2 == 4
    for g, w in zip(seen[0], jax_dilate(split_by_time(jdata.train), 2)):
        np.testing.assert_array_equal(g, w)
    assert 0 < result["ent_raw"]["mrr"] <= 1


# --------------------------------------------------------------- profiling

def test_profiling_helpers_match_jax(tiny, tmp_path):
    """``parameter_count`` and ``training_summary`` give JAX's numbers and
    keys for the same parameters; ``StepTimer`` keeps its window; ``trace``
    writes a Chrome trace where the caller says and does nothing when
    disabled."""
    import time

    from regcn_tpu.utils import profiling as jax_profiling
    from regcn_torch.utils import profiling

    jdata, _ = tiny
    state = regcn_init(jdata, ["train", *COMMON])
    cfg = cli.make_experiment(cli.build_parser().parse_args(["train", *COMMON]), jdata).model
    got = profiling.training_summary(state.params, cfg)
    want = jax_profiling.training_summary(
        jax.tree.map(lambda t: np.asarray(t.detach()), state.params), cfg)
    assert got == want and got["num_parameters"] == profiling.parameter_count(state.params)
    timer = profiling.StepTimer(window=2)
    for _ in range(3):
        with timer:
            time.sleep(0.001)
    assert len(timer.times) == 2 and timer.mean_s >= 0.001 and timer.p50_s >= 0.001
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert not (tmp_path / "off").exists()
