"""Command-line experiment driver of the port.

Counterpart of ``regcn_tpu/cli.py`` (parity with ref:src/main.py:294-447,
the train/test/grid-search driver and its ~35 flags), with the same
flags, choices and defaults. Run on a CUDA card as

    python -m regcn_torch.cli train -d synthetic-small --n-epochs 10
    python -m regcn_torch.cli test  -d synthetic-small --checkpoint models/...
    python -m regcn_torch.cli grid  -d synthetic-small --tune lr,seed --vectorize
    python -m regcn_torch.cli hyperbolic -d synthetic-icews14s --encoder lgcn --decoder roth
    python -m regcn_torch.cli hisres -d synthetic-small
    python -m regcn_torch.cli entity -d synthetic-aifb

and from Python as ``main([...])``, or ``main([...], device="cpu")`` to
run every kernel's plain version on the CPU. Without a card, and without
``device="cpu"``, it stops.

``train``, ``test``, ``hyperbolic`` and ``hisres`` (and the sequential
RE-GCN ``grid``) take ``--shards G`` and ``--dist-agg {gspmd,halo}``,
entity-sharded over G processes, one per shard, as ``torchrun`` starts
them on a machine with G cards (rank r on ``cuda:{LOCAL_RANK}``; the
process group comes from torchrun's environment with torch's default
backend for the device):

    torchrun --nproc-per-node 2 -m regcn_torch.cli train -d synthetic-icews14s --shards 2
    torchrun --nproc-per-node 2 -m regcn_torch.cli hyperbolic -d synthetic-icews14s \
        --shards 2 --dist-agg halo
    torchrun --nproc-per-node 2 -m regcn_torch.cli hyperbolic -d synthetic-icews14s \
        --shards 2 --use-est --use-time-aware-negative

With ``--shards`` the modes take EST and TANS (``hyperbolic``), triple
batching (``hyperbolic`` under ``--dist-agg gspmd``; JAX refuses it under
``halo``) and ``--add-static-graph`` (``train``, ``test``, ``hyperbolic``,
``hisres``; the dataset's word count must be a multiple of ``--shards``).

Not ported, and stopping with a message that names the ROADMAP item:
``bench`` (A.2: ``bench.py`` measures the JAX package); ``--shards`` for
``grid --vectorize``, and in ``hyperbolic`` / ``hisres`` with bf16 or
``--run-analysis`` (A.11b).

``--compute-dtype bfloat16`` reaches the trainers of ``train``, ``test``,
``hyperbolic`` and ``hisres`` (and of the sequential ``grid``), as in the
JAX CLI: bf16 activations with fp32 parameters and fp32 islands
(``regcn_torch/utils/dtypes.py``). ``grid --vectorize`` trains in fp32
whatever the flag says, as JAX's vectorized sweep casts nothing.

Hyperparameter grid parity: ref:src/hyperparameter_range.py:6-11.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os

import torch

# grid-search ranges (parity with ref:src/hyperparameter_range.py:6-11)
HP_RANGE = {
    "n_hidden": [100, 200],
    "n_layers": [1, 2],
    "dropout": [0.2, 0.4],
    "n_bases": [50, 100],
    "lr": [1e-3, 5e-4],
    "train_history_len": [1, 3, 7, 10],
    "task_weight": [0.5, 0.7, 1.0],
    "seed": [2023, 2024, 2025],
}

# per-dataset range overrides. The reference's hisres driver dispatches
# per-dataset hp_range_* tables that are missing from its repo
# (ref:hisres_main.py:551-562, stale); these provide working equivalents
# keyed by dataset-shape family.
HP_RANGE_BY_DATASET = {
    "wiki": {"train_history_len": [1, 2, 3], "dropout": [0.2]},
    "yago": {"train_history_len": [1, 2, 3], "dropout": [0.2]},
    "gdelt": {"train_history_len": [3, 7], "lr": [1e-3]},
    "icews18": {"train_history_len": [3, 7, 10]},
    "icews05-15": {"train_history_len": [3, 7], "lr": [1e-3]},
}
# hisres-only knob (ref:hisres_main.py history_rate)
HP_RANGE_HISRES = {"history_rate": [0.1, 0.3, 0.5]}

# numeric knobs that do not change tensor shapes: with --vectorize these
# sweep as ONE vmapped program (regcn_torch/train/sweep.py) instead of
# sequential retraining
VECTORIZABLE = ("lr", "task_weight", "seed")

log = logging.getLogger(__name__)


def grid_table(dataset: str, family: str) -> dict:
    table = dict(HP_RANGE)
    if family == "hisres":
        table.update(HP_RANGE_HISRES)
    for key, overrides in HP_RANGE_BY_DATASET.items():
        if key in dataset.lower():
            table.update(overrides)
    return table


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="regcn_torch", description="RE-GCN on PyTorch and CUDA")
    p.add_argument("mode", choices=["train", "test", "grid", "bench",
                                    "hyperbolic", "hisres", "entity"])
    p.add_argument("-d", "--dataset", required=True)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--models-dir", default="models")
    # encoder
    p.add_argument("--encoder", default="uvrgcn")
    p.add_argument("--n-hidden", type=int, default=200)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--n-bases", type=int, default=100)
    p.add_argument("--self-loop", action="store_true", default=True)
    p.add_argument("--skip-connect", action="store_true", default=False)
    p.add_argument("--layer-norm", action="store_true", default=True)
    # decoder
    p.add_argument("--decoder", default="convtranse")
    p.add_argument("--input-dropout", type=float, default=0.2)
    p.add_argument("--hidden-dropout", type=float, default=0.2)
    p.add_argument("--feat-dropout", type=float, default=0.2)
    # static graph
    p.add_argument("--add-static-graph", action="store_true", default=False)
    p.add_argument("--weight", type=float, default=0.5, help="static loss weight")
    p.add_argument("--discount", type=float, default=1.0)
    p.add_argument("--angle", type=float, default=10.0)
    # tasks
    p.add_argument("--entity-prediction", action="store_true", default=True)
    p.add_argument("--relation-prediction", action="store_true", default=True)
    p.add_argument("--task-weight", type=float, default=0.7)
    # training
    p.add_argument("--n-epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--grad-norm", type=float, default=1.0)
    p.add_argument("--evaluate-every", type=int, default=1)
    p.add_argument("--seed", type=int, default=2023)
    # history
    p.add_argument("--train-history-len", type=int, default=3)
    p.add_argument("--test-history-len", type=int, default=3)
    p.add_argument("--dilate-len", type=int, default=1)
    # inference
    p.add_argument("--multi-step", action="store_true", default=False)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--relation-evaluation", action="store_true", default=False)
    # grid search
    p.add_argument("--tune", default="n_hidden,n_layers,dropout,n_bases")
    p.add_argument("--vectorize", action="store_true", default=False,
                   help="grid mode: vmap lr/task_weight/seed combos into one program")
    p.add_argument("--grid-family", default="regcn",
                   choices=["regcn", "hyperbolic", "hisres"],
                   help="grid mode: which model family to sweep")
    p.add_argument("--resume", action="store_true", default=False,
                   help="restore the checkpoint (params+optimizer+epoch) and continue")
    # entity-classification mode (legacy RGCN task, ref:rgcn/knowledge_graph.py:82-86)
    p.add_argument("--bfs-level", type=int, default=2)
    p.add_argument("--relabel", action="store_true", default=False)
    # misc
    p.add_argument("--run-analysis", action="store_true", default=False)
    p.add_argument("--impl", default="xla", choices=["xla", "pallas"],
                   help="the aggregation route of the JAX package; both take kernel B1 here")

    # multi-device (train / test / hyperbolic / hisres)
    p.add_argument("--shards", type=int, default=None,
                   help="graph-axis mesh size: shard the entity table, its optimizer "
                        "moments and the decoder candidate axis over this many processes "
                        "(torchrun --nproc-per-node N)")
    p.add_argument("--dist-agg", default="gspmd", choices=["gspmd", "halo"],
                   help="cross-shard RGCN aggregation: 'gspmd' all-gathers the entity rows; "
                        "'halo' exchanges the boundary set (regcn_torch/parallel/halo.py)")

    # hyperbolic model flags (parity: ref hyperbolic_main.py:708-845)
    hp = p.add_argument_group("hyperbolic")
    hp.add_argument("--curvature", type=float, default=0.01)
    hp.add_argument("--learn-curvature", action="store_true", default=False)
    hp.add_argument("--curvature-min", type=float, default=1e-4)
    hp.add_argument("--curvature-max", type=float, default=1e-1)
    hp.add_argument("--curvature-warmup-epochs", type=int, default=0)
    hp.add_argument("--manifold-entities", action="store_true", default=False,
                    help="store entities on the ball + Riemannian Adam")
    hp.add_argument("--use-residual-evolution", action="store_true", default=True)
    hp.add_argument("--radius-lambda", type=float, default=0.02)
    hp.add_argument("--radius-min", type=float, default=0.5)
    hp.add_argument("--radius-max", type=float, default=3.0)
    hp.add_argument("--radius-epsilon", type=float, default=0.1)
    hp.add_argument("--radius-anchor-beta", type=float, default=1.0)
    hp.add_argument("--radius-msg-gamma", type=float, default=1.0)
    hp.add_argument("--radius-alpha", type=float, default=0.5,
                    help="degree weight in the radius target (ref :729)")
    hp.add_argument("--radius-beta", type=float, default=0.5,
                    help="frequency weight in the radius target (ref :730)")
    hp.add_argument("--num-heads", type=int, default=4, help="HGAT heads")
    hp.add_argument("--hyp-init-scale", type=float, default=1e-3)
    hp.add_argument("--hyp-score-scale-init", type=float, default=1.0)
    hp.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bf16 activations with fp32 params/islands "
                         "(train/hyperbolic/hisres modes)")
    hp.add_argument("--hyp-score-margin-init", type=float, default=1.0)
    hp.add_argument("--use-entity-euclidean-bias", action="store_true", default=False)
    hp.add_argument("--use-relation-specific-curvature", action="store_true", default=False)
    hp.add_argument("--triple-batch-size", type=int, default=None)
    hp.add_argument("--triple-batch-mode", default="accumulate",
                    choices=["accumulate", "per_chunk"],
                    help="accumulate: sum chunk grads, one optimizer step "
                         "per snapshot (reference parity); per_chunk: step "
                         "per chunk")
    hp.add_argument("--patience", type=int, default=20)
    # EST
    hp.add_argument("--use-est", action="store_true", default=False)
    hp.add_argument("--est-state-alpha", type=float, default=0.2)
    hp.add_argument("--est-encoder", default="gru", choices=["gru", "transformer"])
    hp.add_argument("--est-history-len", type=int, default=32)
    hp.add_argument("--use-time-aware-negative", action="store_true", default=False)

    # hisres flags (parity: ref hisres_main.py:422-537)
    hr = p.add_argument_group("hisres")
    hr.add_argument("--history-rate", type=float, default=0.3)
    hr.add_argument("--rel-window-mode", default="full",
                    choices=["full", "endpoints"],
                    help="relation-history vocabulary: 'full' = relations "
                         "anywhere in the last history-len snapshots (the "
                         "intended semantics of ref:hisres_main.py:336-350); "
                         "'endpoints' reproduces the reference's actual "
                         "per-step-difference files (parity mode)")
    hr.add_argument("--rc-mode", default="src", choices=["src", "both"],
                    help="relation-context incidence for the hisres "
                         "streams: 'src' = source entities only (the "
                         "HisRES r2e, ref:hisres_rgcn/utils.py:77-80 — "
                         "reference parity, default); 'both' = both "
                         "endpoints")
    return p


def check_single_device(args) -> None:
    """Stops on the multi-device flags where the JAX package has no mesh
    either (the vectorized grid's model axis, ROADMAP A.11b)."""
    if args.shards:
        raise SystemExit(f"--shards {args.shards}: '{args.mode}' on a mesh is not ported to "
                         "regcn_torch yet (ROADMAP A.11b)")
    if args.dist_agg != "gspmd":
        raise SystemExit(f"--dist-agg requires --shards, and '{args.mode}' on a mesh is not "
                         "ported to regcn_torch yet (ROADMAP A.11b)")


def check_mesh_options(args) -> None:
    """Stops, before any process group is made, on the options that the
    ``hyperbolic`` and ``hisres`` modes do not run on a mesh yet (ROADMAP
    A.11b); the trainers raise for them too."""
    if not args.shards:
        return
    for unported, flag in (
            (args.compute_dtype != "float32", f"--compute-dtype {args.compute_dtype}"),
            (args.run_analysis, "--run-analysis")):
        if unported:
            raise SystemExit(f"{flag} with --shards: '{args.mode}' on a mesh does not run it "
                             "yet (ROADMAP A.11b)")


def make_cli_mesh(args):
    """The ``("data", "graph")`` mesh of ``--shards`` over the ranks of the
    process group, or None: the group is the caller's where one is
    initialised, else torchrun's (``env://``, torch's default backend for
    the device), and on a card rank r takes ``cuda:{LOCAL_RANK}``."""
    if not args.shards:
        if args.dist_agg != "gspmd":
            raise SystemExit("--dist-agg requires --shards")
        return None
    import torch.distributed as dist

    from regcn_torch.parallel.mesh import MeshAxes, make_mesh

    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise SystemExit(f"--shards {args.shards} runs one process per shard: launch with "
                             f"torchrun --nproc-per-node {args.shards} -m regcn_torch.cli ...")
        dist.init_process_group(init_method="env://")
    world = dist.get_world_size()
    if world != args.shards:
        raise SystemExit(f"--shards {args.shards} needs that many processes, the process group "
                         f"has {world} (torchrun --nproc-per-node {args.shards})")
    if args.device.type == "cuda":
        args.device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(args.device)
    return make_mesh(MeshAxes(data=1, graph=args.shards), device_type=args.device.type)


def _device(args) -> torch.device:
    return torch.device(getattr(args, "device", "cuda"))


def make_hyperbolic_configs(args, data):
    from regcn_torch.config import TrainConfig
    from regcn_torch.hyperbolic.model import HyperbolicConfig

    encoder = args.encoder if args.encoder != "uvrgcn" else "hyperbolic_uvrgcn"
    decoder = args.decoder if args.decoder != "convtranse" else "hyperbolic_convtranse"
    cfg = HyperbolicConfig(
        num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=args.n_hidden,
        n_layers=args.n_layers, encoder=encoder, decoder=decoder,
        dropout=args.dropout, input_dropout=args.input_dropout,
        hidden_dropout=args.hidden_dropout, feat_dropout=args.feat_dropout,
        self_loop=args.self_loop, skip_connect=args.skip_connect,
        layer_norm=args.layer_norm, use_static=args.add_static_graph,
        num_static_rels=data.num_static_rels, num_words=data.num_words,
        n_bases=args.n_bases, static_weight=args.weight,
        discount=args.discount, angle=args.angle,
        compute_dtype=args.compute_dtype,
        c=args.curvature, learn_curvature=args.learn_curvature,
        curvature_min=args.curvature_min, curvature_max=args.curvature_max,
        manifold_entities=args.manifold_entities,
        use_residual_evolution=args.use_residual_evolution,
        radius_lambda=args.radius_lambda, radius_min=args.radius_min,
        radius_max=args.radius_max, radius_epsilon=args.radius_epsilon,
        radius_anchor_beta=args.radius_anchor_beta,
        radius_msg_gamma=args.radius_msg_gamma, num_heads=args.num_heads,
        radius_alpha=args.radius_alpha, radius_beta=args.radius_beta,
        hyp_init_scale=args.hyp_init_scale,
        hyp_score_scale_init=args.hyp_score_scale_init,
        hyp_score_margin_init=args.hyp_score_margin_init,
        use_entity_bias=args.use_entity_euclidean_bias,
        use_rel_curvature=args.use_relation_specific_curvature,
        use_est=args.use_est, est_state_alpha=args.est_state_alpha,
        est_encoder=args.est_encoder, est_history_len=args.est_history_len,
        use_time_aware_negative=args.use_time_aware_negative,
        impl=args.impl,
    )
    tc = TrainConfig(
        lr=args.lr, grad_norm=args.grad_norm, n_epochs=args.n_epochs,
        evaluate_every=args.evaluate_every, task_weight=args.task_weight,
        train_history_len=args.train_history_len,
        test_history_len=args.test_history_len, seed=args.seed,
    )
    return cfg, tc


def make_hisres_configs(args, data):
    from regcn_torch.config import TrainConfig
    from regcn_torch.hisres.model import HisResConfig

    cfg = HisResConfig(
        num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=args.n_hidden,
        n_layers=args.n_layers, history_rate=args.history_rate,
        dropout=args.dropout, input_dropout=args.input_dropout,
        hidden_dropout=args.hidden_dropout, feat_dropout=args.feat_dropout,
        self_loop=args.self_loop, skip_connect=args.skip_connect,
        layer_norm=args.layer_norm, use_static=args.add_static_graph,
        num_static_rels=data.num_static_rels, num_words=data.num_words,
        n_bases=args.n_bases, static_weight=args.weight,
        discount=args.discount, angle=args.angle,
        compute_dtype=args.compute_dtype,
        rc_mode=args.rc_mode,
    )
    tc = TrainConfig(
        lr=args.lr, grad_norm=args.grad_norm, n_epochs=args.n_epochs,
        task_weight=args.task_weight,
        train_history_len=args.train_history_len,
        test_history_len=args.test_history_len, seed=args.seed,
    )
    return cfg, tc


def selection_metric(args) -> str:
    """--relation-evaluation selects the best checkpoint on relation MRR
    (ref:src/main.py:266, ref:hyperbolic_main.py:672)."""
    return "rel_raw" if args.relation_evaluation else "ent_raw"


def _load(args):
    from regcn_torch.data import load_data

    return load_data(args.dataset, args.data_dir, load_static=args.add_static_graph)


def _report(stats) -> dict:
    """The stats as JSON, printed once (by rank 0 of a mesh)."""
    import torch.distributed as dist

    result = {
        k: {"mrr": s.mrr, **{f"hits@{h}": v for h, v in s.hits.items()}}
        for k, s in stats.items()
    }
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(result, indent=2))
    return result


def run_hyperbolic(args) -> dict:
    from regcn_torch.hyperbolic.train import HyperbolicTrainer

    check_mesh_options(args)
    mesh = make_cli_mesh(args)
    data = _load(args)
    cfg, tc = make_hyperbolic_configs(args, data)
    trainer = HyperbolicTrainer(
        cfg, tc, data, triple_batch_size=args.triple_batch_size,
        triple_batch_mode=args.triple_batch_mode,
        curvature_warmup_epochs=args.curvature_warmup_epochs, mesh=mesh,
        dist_agg=args.dist_agg, run_analysis=args.run_analysis, device=_device(args),
    )
    ckpt = args.checkpoint or os.path.join(args.models_dir, "hyp-" + model_name(args))
    best, info = trainer.fit(patience=args.patience, checkpoint_path=ckpt,
                             resume=args.resume,
                             selection_metric=selection_metric(args))
    log.info("best valid MRR (%s): %.4f", info.get("selection_metric", "ent_raw"),
             info["best_valid_mrr_raw"])
    return _report(trainer.test(best, multi_step=args.multi_step, topk=args.topk,
                                relation_evaluation=args.relation_evaluation))


def run_hisres(args) -> dict:
    from regcn_torch.hisres.train import HisResTrainer

    check_mesh_options(args)
    mesh = make_cli_mesh(args)
    data = _load(args)
    cfg, tc = make_hisres_configs(args, data)
    trainer = HisResTrainer(cfg, tc, data, mesh=mesh, dist_agg=args.dist_agg,
                            rel_window_mode=args.rel_window_mode,
                            run_analysis=args.run_analysis, device=_device(args))
    ckpt = args.checkpoint or os.path.join(args.models_dir, "hisres-" + model_name(args))
    best, info = trainer.fit(checkpoint_path=ckpt, resume=args.resume,
                             selection_metric=selection_metric(args))
    log.info("best valid MRR (%s): %.4f", info.get("selection_metric", "ent_raw"),
             info["best_valid_mrr_raw"])
    return _report(trainer.test(best, multi_step=args.multi_step, topk=args.topk,
                                relation_evaluation=args.relation_evaluation))


def make_experiment(args, data):
    from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig

    model = ModelConfig(
        num_ents=data.num_nodes,
        num_rels=data.num_rels,
        h_dim=args.n_hidden,
        n_layers=args.n_layers,
        dropout=args.dropout,
        input_dropout=args.input_dropout,
        hidden_dropout=args.hidden_dropout,
        feat_dropout=args.feat_dropout,
        self_loop=args.self_loop,
        skip_connect=args.skip_connect,
        layer_norm=args.layer_norm,
        entity_prediction=args.entity_prediction,
        relation_prediction=args.relation_prediction,
        use_static=args.add_static_graph,
        num_static_rels=data.num_static_rels,
        num_words=data.num_words,
        n_bases=args.n_bases,
        static_weight=args.weight,
        discount=args.discount,
        angle=args.angle,
        dtype=args.compute_dtype,
    )
    train = TrainConfig(
        lr=args.lr,
        grad_norm=args.grad_norm,
        n_epochs=args.n_epochs,
        evaluate_every=args.evaluate_every,
        task_weight=args.task_weight,
        train_history_len=args.train_history_len,
        test_history_len=args.test_history_len,
        dilate_len=args.dilate_len,
        seed=args.seed,
    )
    return ExperimentConfig(model=model, train=train)


def model_name(args) -> str:
    """Checkpoint name encoding the hyperparameter signature
    (ref:src/main.py:136-139)."""
    return (
        f"{args.dataset}-{args.encoder}-{args.decoder}-ly{args.n_layers}"
        f"-dilate{args.dilate_len}-his{args.train_history_len}"
        f"-w{args.weight}-disc{args.discount}-angle{args.angle}"
        f"-dp{args.dropout}|{args.input_dropout}|{args.hidden_dropout}|{args.feat_dropout}"
    )


def run_single(args) -> dict:
    from regcn_torch.train.loop import Trainer
    from regcn_torch.train.state import restore_checkpoint

    mesh = make_cli_mesh(args)
    data = _load(args)
    cfg = make_experiment(args, data)
    trainer = Trainer(cfg, data, impl=args.impl, mesh=mesh, dist_agg=args.dist_agg,
                      run_analysis=args.run_analysis, device=_device(args))
    ckpt = args.checkpoint or os.path.join(args.models_dir, model_name(args))

    if args.mode == "test":
        state, meta = restore_checkpoint(ckpt, trainer.init_state(args.seed), trainer.shard)
        log.info("loaded checkpoint %s (meta %s)", ckpt, meta)
    else:
        state, info = trainer.fit(checkpoint_path=ckpt, resume=args.resume,
                                  selection_metric=selection_metric(args))
        log.info("best valid MRR (%s): %.4f", info.get("selection_metric", "ent_raw"),
                 info["best_valid_mrr_raw"])
    return _report(trainer.test(state, multi_step=args.multi_step, topk=args.topk,
                                relation_evaluation=args.relation_evaluation))


def run_grid(args):
    """Cartesian grid search (ref:src/main.py:403-443; the hisres
    per-dataset tables the reference references but never committed are
    provided via HP_RANGE_BY_DATASET, ref:hisres_main.py:551-562).

    ``--grid-family {regcn,hyperbolic,hisres}`` selects the trained
    family. With --vectorize, the lr/task_weight/seed sub-grid trains as
    ONE vmapped program per outer (shape-changing) combination
    (``regcn_torch/train/sweep.py``)."""
    table = grid_table(args.dataset, args.grid_family)
    keys = [k.strip() for k in args.tune.split(",") if k.strip()]
    for k in keys:
        if k not in table:
            raise SystemExit(f"unknown hyperparameter {k!r}; known: {list(table)}")
    out_log = f"{args.dataset}.{args.encoder}-{args.decoder}.gs"
    results = []

    if args.vectorize and any(k in VECTORIZABLE for k in keys):
        from regcn_torch.train.sweep import HyperbolicSweepRunner, SweepRunner

        if args.grid_family == "hisres":
            raise SystemExit(
                "--vectorize supports the regcn and hyperbolic families; "
                "run the hisres grid without --vectorize")
        # the vectorized sweep selects on valid entity MRR and never runs
        # test(); eval-protocol flags cannot be honored there
        for flag, name in ((args.multi_step, "--multi-step"),
                           (args.relation_evaluation, "--relation-evaluation"),
                           (args.run_analysis, "--run-analysis")):
            if flag:
                raise SystemExit(
                    f"{name} is not supported with grid --vectorize "
                    f"(the vmapped sweep has no test/analysis phase); "
                    f"run the grid without --vectorize")
        check_single_device(args)

        vec_keys = [k for k in keys if k in VECTORIZABLE]
        seq_keys = [k for k in keys if k not in VECTORIZABLE]
        inner = list(itertools.product(*[table[k] for k in vec_keys]))
        outer = list(itertools.product(*[table[k] for k in seq_keys])) or [()]
        log.info("vectorized grid: %d outer x %d vmapped combos", len(outer), len(inner))
        data = _load(args)
        with open(out_log, "w") as f:
            for combo in outer:
                for k, v in zip(seq_keys, combo):
                    setattr(args, k, v)
                combos = {k: [row[i] for row in inner] for i, k in enumerate(vec_keys)}
                if args.grid_family == "hyperbolic":
                    hcfg, htc = make_hyperbolic_configs(args, data)
                    runner = HyperbolicSweepRunner(hcfg, htc, data, combos, device=_device(args))
                else:
                    cfg = make_experiment(args, data)
                    runner = SweepRunner(cfg.model, cfg.train, data, combos, impl=args.impl,
                                         device=_device(args))
                rows, _ = runner.run()
                for r in rows:
                    row = {"params": {**dict(zip(seq_keys, combo)),
                                      **{k: r[k] for k in vec_keys}},
                           "valid_ent_mrr_raw": r["valid_ent_mrr_raw"]}
                    results.append(row)
                    f.write(json.dumps(row) + "\n")
                    f.flush()
        best = max(results, key=lambda r: r["valid_ent_mrr_raw"])
        log.info("best: %s", best)
        return results

    combos = list(itertools.product(*[table[k] for k in keys]))
    log.info("grid search over %s: %d combos -> %s", keys, len(combos), out_log)
    # model_name() omits several sweepable keys (n_hidden, lr, seed, ...);
    # give every combo its own checkpoint path so combos never
    # share/restore each other's state. A user-supplied --checkpoint
    # becomes the parent dir of the per-combo paths and is restored after
    # the sweep.
    user_checkpoint = args.checkpoint
    ckpt_root = user_checkpoint or os.path.join(args.models_dir, f"grid-{args.grid_family}")
    try:
        with open(out_log, "w") as f:
            family_runner = {"regcn": run_single, "hyperbolic": run_hyperbolic,
                             "hisres": run_hisres}[args.grid_family]
            for combo in combos:
                for k, v in zip(keys, combo):
                    setattr(args, k, v)
                combo_tag = "-".join(f"{k}={v}" for k, v in zip(keys, combo))
                args.checkpoint = os.path.join(ckpt_root, f"{model_name(args)}-{combo_tag}")
                r = family_runner(args)
                row = {"params": dict(zip(keys, combo)), "test_ent_mrr_raw": r["ent_raw"]["mrr"]}
                results.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
    finally:
        args.checkpoint = user_checkpoint
    best = max(results, key=lambda r: r["test_ent_mrr_raw"])
    log.info("best: %s", best)
    return results


def run_entity(args):
    """Static-KB entity classification (the legacy RGCN task;
    ``regcn_torch/data/rdf.py`` and ``models/entity_classifier.py``)."""
    from regcn_torch.data.rdf import load_entity_data
    from regcn_torch.models import entity_classifier as ec

    data = load_entity_data(args.dataset, data_dir=args.data_dir, bfs_level=args.bfs_level,
                            relabel=args.relabel, seed=args.seed)
    log.info("entity dataset %s: %d nodes, %d rels, %d classes, %d/%d train/test labeled",
             data.name, data.num_nodes, data.num_rels, data.num_classes, len(data.train_idx),
             len(data.test_idx))
    cfg = ec.EntityClassifierConfig(h_dim=args.n_hidden, n_bases=args.n_bases,
                                    dropout=args.dropout, lr=args.lr, n_epochs=args.n_epochs)
    params, losses = ec.fit(args.seed, data, cfg, device=_device(args))
    train_acc = ec.evaluate(params, data, cfg, idx=data.train_idx)
    test_acc = ec.evaluate(params, data, cfg)
    log.info("final loss %.4f | train acc %.4f | test acc %.4f", losses[-1], train_acc,
             test_acc)
    return {"train_acc": train_acc, "test_acc": test_acc, "final_loss": float(losses[-1])}


def main(argv=None, device="cuda"):
    """Parses ``argv`` and runs its mode on ``device``: the CUDA card by
    default, the CPU (every kernel's plain version) with ``device="cpu"``,
    as the tests run it. Stops when the device is a CUDA one and no card
    is there."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    # flags a mode cannot honor must ERROR, not silently no-op
    if args.mode in ("bench", "entity"):
        for flag, name in ((args.multi_step, "--multi-step"),
                           (args.relation_evaluation, "--relation-evaluation"),
                           (args.run_analysis, "--run-analysis")):
            if flag:
                raise SystemExit(
                    f"{name} applies to the train/test/hyperbolic/hisres "
                    f"modes, not '{args.mode}'")
    if args.mode == "bench":
        raise SystemExit("bench: regcn_torch has no benchmark yet (ROADMAP A.2); bench.py "
                         "measures the JAX package")
    args.device = torch.device(device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("regcn_torch.cli runs on a CUDA card and none is visible; call "
                         "main(argv, device='cpu') to run the plain versions on the CPU")
    if args.mode == "grid":
        args.mode = "train"
        return run_grid(args)
    if args.mode == "hyperbolic":
        return run_hyperbolic(args)
    if args.mode == "hisres":
        return run_hisres(args)
    if args.mode == "entity":
        return run_entity(args)
    return run_single(args)


if __name__ == "__main__":
    main()
