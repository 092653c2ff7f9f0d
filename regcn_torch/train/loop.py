"""Training and evaluation drivers.

Counterpart of ``regcn_tpu/train/loop.py`` (ref:src/main.py:33-291).

- :func:`rolling_ranks` / :func:`evaluate` / :func:`test`: the
  single-step rolling-window evaluation, raw and filtered MRR over a
  split. Each eval snapshot is scored from the ``test_history_len``
  snapshots before it, then joins the window. With ``multi_step``
  (:func:`multi_step_ranks`) the snapshot's top-k predictions join the
  window instead (:func:`construct_snap`, :func:`construct_snap_r`). The
  model's scores come from a ``predict`` function, RE-GCN's by default;
  the hyperbolic trainer passes ``regcn_torch.hyperbolic.model.predict``,
  and with ``step_inputs`` the keyword arguments it takes at each eval
  snapshot (EST's retrieval batch at that snapshot's time).
- :class:`Trainer`: RE-GCN training, one optimizer step per training
  snapshot in the order of ``Trainer.run_epoch_fused``, and ``fit`` with
  best and last checkpoints and resume. With ``use_static`` the static
  entity-word graph is built once, on the trainer's device, and every
  training step and eval snapshot starts from its embedding; with
  ``run_analysis`` ``fit`` records gradient and embedding statistics once
  an epoch (:meth:`Trainer.analysis_record`).

The JAX trainer runs an epoch as one fused ``lax.scan`` over a store
front-padded with empty snapshots; here a Python loop takes the same
steps in the same order. A window shorter than the history length is
run as it is: the fused path's empty front snapshots are identity steps,
so both give the same result.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from regcn_torch.config import ExperimentConfig, TrainConfig
from regcn_torch.data.answers import AnswerFilter, build_answer_filters_by_time
from regcn_torch.data.dataset import TKGData
from regcn_torch.data.snapshots import (build_history, build_snapshot, dilate_snapshots,
                                        pad_triples, split_by_time)
from regcn_torch.dist import check_impl_compatible, sharded_impl
from regcn_torch.models import recurrent
from regcn_torch.ops.rgcn_scatter import check_impl
from regcn_torch.parallel import sharding
from regcn_torch.parallel.mesh import (check_entity_divisibility, check_words_divisibility,
                                       row_shard)
from regcn_torch.train import metrics
from regcn_torch.train import state as train_state
from regcn_torch.train.optim import tree_leaves
from regcn_torch.train.state import TrainState
from regcn_torch.utils.dtypes import compute_dtype, tree_to_compute, tree_to_fp32
from regcn_torch.utils.profiling import embedding_stats, gradient_stats

log = logging.getLogger(__name__)

RANK_KEYS = ("ent_raw", "ent_filter", "rel_raw", "rel_filter")
LOSS_KEYS = ("entity", "relation", "static")

# predict(params, model_state, cfg, history, triples [B,3], mask [B], **step_inputs)
#   -> (ent [B,N], rel [B,2R])
Predict = Callable[..., tuple]
# step_inputs(t, triples [B,3], mask [B]) -> predict's keyword arguments at eval snapshot t
StepInputs = Optional[Callable[[int, np.ndarray, np.ndarray], dict]]


def regcn_predict(params, model_state, cfg, history, triples, mask, static_snap=None,
                  impl: str = "xla"):
    """RE-GCN's eval-mode scores (the mask is not needed there)."""
    return recurrent.predict(params, model_state, cfg, history, triples, static_snap=static_snap,
                             impl=impl)


def static_snapshot(data: TKGData, tc: TrainConfig, device):
    """The static entity-word graph of ``data`` as a Snapshot on ``device``
    (entities, then words, as nodes; inverse edges give 2 *
    ``num_static_rels`` relation ids), or None where it has none."""
    if data.static_triples is None:
        return None
    return build_snapshot(data.static_triples, data.num_nodes + data.num_words,
                          data.num_static_rels, edge_bucket=tc.edge_bucket).to(device)


@torch.inference_mode()
def rolling_ranks(
    params,
    model_state,
    cfg,
    tc: TrainConfig,
    history_list: Sequence[np.ndarray],
    eval_list: Sequence[np.ndarray],
    ent_filters: Optional[List[AnswerFilter]] = None,
    rel_filters: Optional[List[AnswerFilter]] = None,
    device="cuda",
    predict: Predict = regcn_predict,
    step_inputs: StepInputs = None,
    sharded=None,
) -> Dict[str, List[np.ndarray]]:
    """Per eval snapshot, the ranks of its real queries under each of
    ``RANK_KEYS`` (entity/relation, raw/filtered). On an entity-sharded
    mesh ``sharded`` (a ``regcn_torch.parallel.sharding.ShardedEval``)
    builds the windows with the rank's partition and ranks the candidates
    across the shards; every rank gets the same ranks."""
    window = list(history_list[-tc.test_history_len:])
    if not window:
        raise ValueError("rolling evaluation needs at least one history snapshot")
    ranks: Dict[str, List[np.ndarray]] = {k: [] for k in RANK_KEYS}
    for t, snap in enumerate(eval_list):
        history = (sharded.window(window) if sharded is not None else
                   build_history(window, cfg.num_ents, cfg.num_rels, edge_bucket=tc.edge_bucket,
                                 rc_bucket=tc.rc_bucket).to(device))
        triples, mask = pad_triples(snap, cfg.num_rels, tc.triple_bucket)
        er, ec = metrics.filter_coo_padded(
            ent_filters[t] if ent_filters else None, triples[:, [0, 1]], triples[:, 2])
        rr, rc = metrics.filter_coo_padded(
            rel_filters[t] if rel_filters else None, triples[:, [0, 2]], triples[:, 1])
        er, ec, rr, rc = (torch.from_numpy(a).to(device) for a in (er, ec, rr, rc))
        trip = torch.from_numpy(triples).long().to(device)
        s_ob, s_rel = predict(params, model_state, cfg, history, trip,
                              torch.from_numpy(mask).to(device),
                              **(step_inputs(t, triples, mask) if step_inputs else {}))
        step = (sharded.ranks(s_ob, s_rel, trip, er, ec, rr, rc) if sharded is not None else
                torch.stack([
                    metrics.device_ranks(s_ob, trip[:, 2]),
                    metrics.device_filtered_ranks(s_ob, trip[:, 2], er, ec),
                    metrics.device_ranks(s_rel, trip[:, 1]),
                    metrics.device_filtered_ranks(s_rel, trip[:, 1], rr, rc),
                ])).cpu().numpy()
        valid = mask > 0
        for key, row in zip(RANK_KEYS, step):
            ranks[key].append(row[valid])
        # the window holds the last test_history_len snapshots, so a short
        # history grows up to that length, as in regcn_tpu's fused eval
        window = (window + [snap])[-tc.test_history_len:]
    return ranks


def multi_step_ranks(
    params,
    model_state,
    cfg,
    tc: TrainConfig,
    history_list: Sequence[np.ndarray],
    eval_list: Sequence[np.ndarray],
    ent_filters: Optional[List[AnswerFilter]] = None,
    rel_filters: Optional[List[AnswerFilter]] = None,
    device="cuda",
    predict: Predict = regcn_predict,
    topk: int = 10,
    relation_evaluation: bool = False,
    step_inputs: StepInputs = None,
    sharded=None,
) -> Dict[str, List[np.ndarray]]:
    """Multi-step evaluation (ref:src/main.py:33-107): as
    :func:`rolling_ranks`, but each snapshot's top-k predictions, of
    entities or with ``relation_evaluation`` of relations, take the oldest
    snapshot's place in the window instead of the snapshot itself. With
    ``sharded`` (``dist_agg="gspmd"``) every rank gathers the whole score
    matrix and takes the same steps (the hyperbolic trainer's under
    ``"halo"`` too: the window's halo is rebuilt on the host each step)."""
    window = list(history_list[-tc.test_history_len:])
    ranks: Dict[str, List[np.ndarray]] = {k: [] for k in RANK_KEYS}
    for t, snap in enumerate(eval_list):
        history = (sharded.window(window) if sharded is not None else
                   build_history(window, cfg.num_ents, cfg.num_rels, edge_bucket=tc.edge_bucket,
                                 rc_bucket=tc.rc_bucket).to(device))
        triples, mask = pad_triples(snap, cfg.num_rels, tc.triple_bucket)
        valid = mask > 0
        tq = triples[valid]
        with torch.inference_mode():
            s_ob, s_rel = predict(params, model_state, cfg, history,
                                  torch.from_numpy(triples).long().to(device),
                                  torch.from_numpy(mask).to(device),
                                  **(step_inputs(t, triples, mask) if step_inputs else {}))
            if sharded is not None:
                s_ob, s_rel = sharded.full_scores(s_ob), sharded.rel_scores(s_rel)
        # the dense scores go to the host, in float64 as in the JAX loop
        s_ob = s_ob.cpu().numpy().astype(np.float64)[valid]
        s_rel = s_rel.cpu().numpy().astype(np.float64)[valid]
        ranks["ent_raw"].append(metrics.ranks_from_scores(s_ob, tq[:, 2]))
        ranks["ent_filter"].append(metrics.filtered_ranks(
            s_ob, tq[:, [0, 1]], tq[:, 2], ent_filters[t] if ent_filters else None))
        ranks["rel_raw"].append(metrics.ranks_from_scores(s_rel, tq[:, 1]))
        ranks["rel_filter"].append(metrics.filtered_ranks(
            s_rel, tq[:, [0, 2]], tq[:, 1], rel_filters[t] if rel_filters else None))
        if relation_evaluation:
            pred = construct_snap_r(tq, cfg.num_rels, s_rel, topk)
        else:
            pred = construct_snap(tq, cfg.num_rels, s_ob, topk)
        if len(pred):
            window.pop(0)
            window.append(pred)
    return ranks


def evaluate(
    params,
    model_state,
    cfg,
    tc: TrainConfig,
    history_list: Sequence[np.ndarray],
    eval_list: Sequence[np.ndarray],
    ent_filters: Optional[List[AnswerFilter]] = None,
    rel_filters: Optional[List[AnswerFilter]] = None,
    device="cuda",
    predict: Predict = regcn_predict,
    multi_step: bool = False,
    topk: int = 10,
    relation_evaluation: bool = False,
    step_inputs: StepInputs = None,
    sharded=None,
) -> Dict[str, metrics.RankStats]:
    """Rolling-window evaluation, single-step or with ``multi_step``
    (:func:`multi_step_ranks`): ``RANK_KEYS`` -> RankStats."""
    if multi_step:
        ranks = multi_step_ranks(params, model_state, cfg, tc, history_list, eval_list,
                                 ent_filters, rel_filters, device, predict, topk,
                                 relation_evaluation, step_inputs, sharded)
    else:
        ranks = rolling_ranks(params, model_state, cfg, tc, history_list, eval_list,
                              ent_filters, rel_filters, device, predict, step_inputs, sharded)
    return {k: metrics.stat_ranks(v) for k, v in ranks.items()}


def test(
    params,
    model_state,
    cfg,
    tc: TrainConfig,
    data: TKGData,
    device="cuda",
    predict: Predict = regcn_predict,
    multi_step: bool = False,
    topk: int = 10,
    relation_evaluation: bool = False,
    step_inputs: StepInputs = None,
    sharded=None,
) -> Dict[str, metrics.RankStats]:
    """Test-split evaluation of the hyperbolic trainers: history = train +
    valid, eval = test, with per-timestamp answer filters of the test split;
    ``sharded`` as in :func:`rolling_ranks`. The training snapshots are
    never dilated here: JAX's hyperbolic and HisRES trainers do not read
    ``dilate_len``."""
    ent_f = build_answer_filters_by_time(data.test, data.num_rels, False)
    rel_f = build_answer_filters_by_time(data.test, data.num_rels, True)
    return evaluate(
        params, model_state, cfg, tc,
        split_by_time(data.train) + split_by_time(data.valid), split_by_time(data.test),
        ent_f, rel_f, device, predict, multi_step, topk, relation_evaluation, step_inputs,
        sharded,
    )


def train_window(train_list: Sequence[np.ndarray], i: int, num_nodes: int, num_rels: int,
                 tc: TrainConfig, device) -> tuple:
    """(history, triples, mask) on ``device`` for training snapshot ``i``:
    the history is ``train_list[max(0, i - train_history_len):i]``."""
    hist = build_history(train_list[max(0, i - tc.train_history_len):i], num_nodes, num_rels,
                         edge_bucket=tc.edge_bucket, rc_bucket=tc.rc_bucket)
    triples, mask = pad_triples(train_list[i], num_rels, tc.triple_bucket)
    return (hist.to(device), torch.from_numpy(triples).long().to(device),
            torch.from_numpy(mask).to(device))


def sharded_train_window(train_list: Sequence[np.ndarray], i: int, num_rels: int,
                         tc: TrainConfig, sharded) -> tuple:
    """:func:`train_window` on a mesh: the history carries this rank's
    partition of its edges (``sharded``, a ``ShardedEval``)."""
    triples, mask = pad_triples(train_list[i], num_rels, tc.triple_bucket)
    return (sharded.window(train_list[max(0, i - tc.train_history_len):i]),
            torch.from_numpy(triples).long().to(sharded.device),
            torch.from_numpy(mask).to(sharded.device))


def construct_snap(triples: np.ndarray, num_rels: int, scores: np.ndarray, topk: int
                   ) -> np.ndarray:
    """Top-k entity predictions as a synthetic snapshot for multi-step
    inference (ref:rgcn/utils.py:367-381)."""
    top = np.argsort(-scores, axis=1)[:, :topk]
    out = []
    for i in range(len(triples)):
        h, r = int(triples[i][0]), int(triples[i][1])
        for idx in top[i]:
            if r < num_rels:
                out.append([h, r, int(idx)])
            else:
                out.append([int(idx), r - num_rels, h])
    return np.asarray(out, dtype=np.int64)


def construct_snap_r(triples: np.ndarray, num_rels: int, rel_scores: np.ndarray, topk: int
                     ) -> np.ndarray:
    """Relation-prediction variant (ref:rgcn/utils.py:383-405)."""
    top = np.argsort(-rel_scores, axis=1)[:, :topk]
    out = []
    for i in range(len(triples)):
        h, t = int(triples[i][0]), int(triples[i][2])
        for idx in top[i]:
            if idx < num_rels:
                out.append([h, int(idx), t])
            else:
                out.append([t, int(idx) - num_rels, h])
    return np.asarray(out, dtype=np.int64)


class Trainer:
    """RE-GCN training and evaluation on one device.

    With ``dilate_len > 1`` every ``dilate_len`` consecutive training
    snapshots are merged into one (:func:`dilate_snapshots`), as JAX's
    trainer does; the valid and test splits stay as they are. ``impl``
    ("xla" or "pallas", JAX's aggregation routes) takes kernel B1 on the
    card either way; "cumsum" takes the cumulative-sum route, in training
    and evaluation alike, as JAX's trainer does. Under ``dtype="bfloat16"``
    the loss casts the parameters and the history window to bf16
    (``utils/dtypes.py:tree_to_compute``), and the gradients reach the
    fp32 parameters in fp32; evaluation runs in fp32, as JAX's
    ``predict_step`` has no cast, and checkpoints hold the fp32
    parameters.

    ``mesh`` (``regcn_torch.parallel.mesh.make_mesh``, with a ``graph``
    axis over the ranks of an initialised process group; every rank builds
    its own Trainer and calls the same methods) trains entity-sharded, as
    JAX's ``Trainer(mesh=...)``: the state holds this rank's rows of the
    entity table and its Adam moments, the rest replicated, and
    ``dist_agg`` picks the cross-shard aggregation, ``"gspmd"`` (an
    all-gather of the entity rows) or ``"halo"`` (the boundary-set
    ``all_to_all``). ``init_state`` and the checkpoints take and give
    whole states' rows; multi-step evaluation needs ``"gspmd"``, as in
    JAX. With the static graph ``words_emb`` is row-sharded too, so
    ``num_words`` must be a multiple of the ``graph`` axis (a ``ValueError``
    at construction otherwise, as JAX refuses it). On a mesh:

    - bf16 compute casts the rank's rows as the unsharded loss casts the
      table; the gathers and the halo's exchange carry bf16 rows, and
      every sum across ranks runs in fp32 (``parallel/collectives.py``);
    - ``impl="cumsum"`` under ``"gspmd"`` reduces each rank's
      destination-sorted edges by their cumulative sum in place of B1, in
      training and evaluation; under ``"halo"`` it raises JAX's
      ``ValueError`` (``check_impl_compatible``);
    - ``run_analysis`` records the norms of whole arrays, the entity
      table's rows all-gathered, the same record on every rank, and only
      the mesh's first rank logs it;
    - a ``data`` axis above 1 replicates the whole training, as JAX's
      rules replicate every leaf over it. Each replica would compute its
      steps apart, and the card's atomic sums add in no fixed order, so
      every step's gradients and BatchNorm statistics, and the ranks of
      every evaluation, are taken from the first replica (a broadcast over
      the ``data`` group): the replicas stay bit-equal by construction, at
      the cost of one broadcast a step, where an average over the group
      would leave them equal only as far as its sum is. The dropouts draw
      from the same seed on every replica. Only the mesh's first rank
      writes a checkpoint, and every rank waits for it.

    Still to come on a mesh (ROADMAP A.11b): the sweep's model axis
    (``train/sweep.py``) and the counterpart of JAX's ``dryrun_multichip``.
    """

    def __init__(self, cfg: ExperimentConfig, data: TKGData, *, impl: str = "xla", mesh=None,
                 dist_agg: str = "gspmd", run_analysis: bool = False, device="cuda"):
        if dist_agg not in ("gspmd", "halo"):
            raise ValueError(f"dist_agg must be 'gspmd' or 'halo', got {dist_agg!r}")
        if mesh is None and dist_agg == "halo":
            raise ValueError("dist_agg='halo' requires a mesh")
        check_impl_compatible(impl, dist_agg)
        check_impl(impl)
        recurrent.check_supported(cfg.model)
        self.compute_dtype = compute_dtype(cfg.model.dtype)
        self.mesh, self.dist_agg, self.shard = mesh, dist_agg, None
        if mesh is not None:
            check_entity_divisibility(data.num_nodes, mesh)
            if cfg.model.use_static:
                check_words_divisibility(data.num_words, mesh)
            self.shard = row_shard(mesh, data.num_nodes)
            impl = sharded_impl(mesh, dist_agg, impl)
        self.impl = impl
        self.cfg, self.data = cfg, data
        self.device = torch.device(device)
        self.num_rels, self.num_nodes = data.num_rels, data.num_nodes
        self.train_list = dilate_snapshots(split_by_time(data.train), cfg.train.dilate_len)
        self.valid_list = split_by_time(data.valid)
        self.test_list = split_by_time(data.test)
        self.static_snap = (static_snapshot(data, cfg.train, self.device)
                            if cfg.model.use_static else None)
        self.run_analysis = run_analysis
        self.opt = train_state.make_optimizer(cfg.train)
        self._windows: Dict[int, tuple] = {}

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Random parameters from ``seed`` (default ``tc.seed``) on the
        trainer's device; on a mesh, this rank's rows of them."""
        seed = self.cfg.train.seed if seed is None else seed
        state = train_state.create_train_state(seed, self.cfg.model, self.cfg.train, self.device)
        return state if self.shard is None else sharding.shard_state(state, self.shard)

    # ------------------------------------------------------------------ data
    def window(self, i: int) -> tuple:
        """(history, triples, mask) of training snapshot ``i``, built once;
        on a mesh the history carries this rank's partition of its edges."""
        if i not in self._windows:
            if self.shard is None:
                self._windows[i] = train_window(self.train_list, i, self.num_nodes,
                                                self.num_rels, self.cfg.train, self.device)
            else:
                self._windows[i] = sharded_train_window(self.train_list, i, self.num_rels,
                                                        self.cfg.train, self._sharded_eval())
        return self._windows[i]

    def _sharded_eval(self):
        """The rank's windows and ranks on a mesh, else None."""
        if self.shard is None:
            return None
        return sharding.ShardedEval(self.cfg.model, self.cfg.train, self.dist_agg, self.shard,
                                    self.device)

    # ----------------------------------------------------------------- train
    def loss(self, state: TrainState, history, triples, mask):
        """(total, losses, new ModelState) of a training step:
        total = tw * entity + (1 - tw) * relation + static; the parameters
        and the history in the compute dtype, the losses in fp32."""
        params = tree_to_compute(state.params, self.compute_dtype)
        history = tree_to_compute(history, self.compute_dtype)
        _, losses, new_model_state = recurrent.get_loss(
            params, state.model_state, self.cfg.model, history, triples, mask,
            static_snap=self.static_snap, gen=state.gen, train=True, impl=self.impl)
        losses = tree_to_fp32(losses)
        tw = self.cfg.train.task_weight
        total = tw * losses["entity"] + (1.0 - tw) * losses["relation"] + losses["static"]
        return total, losses, new_model_state

    def train_step(self, state: TrainState, history, triples, mask) -> Dict[str, torch.Tensor]:
        """One optimizer step, in place on ``state``; returns the losses
        (0-d tensors on the device, not synchronised)."""
        total, losses, new_model_state = self.loss(state, history, triples, mask)
        grads = sharding.train_grads(total, state, self.opt, self.shard)
        self.opt.step(tree_leaves(state.params), grads, state.opt_state)
        state.model_state = sharding.from_first_replica_tree(new_model_state, self.shard)
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def epoch_order(self, epoch: int) -> List[int]:
        """The training snapshots of an epoch in ``run_epoch_fused``'s order."""
        order = np.arange(1, len(self.train_list), dtype=np.int32)
        np.random.default_rng(self.cfg.train.seed + epoch).shuffle(order)
        return order.tolist()

    def run_epoch(self, state: TrainState, epoch: int) -> Dict[str, float]:
        """One step per training snapshot; returns the mean losses (one
        host sync per epoch)."""
        order = self.epoch_order(epoch)
        sums = torch.zeros(len(LOSS_KEYS), device=self.device)
        for i in order:
            losses = self.train_step(state, *self.window(i))
            sums += torch.stack([losses[k] for k in LOSS_KEYS])
        return dict(zip(LOSS_KEYS, (sums / max(len(order), 1)).tolist()))

    # ------------------------------------------------------------- analysis
    def analysis_record(self, state: TrainState) -> Dict[str, float]:
        """The ``run_analysis`` sample of an epoch (``regcn_tpu``'s
        ``Trainer.analysis_record``): the gradient norms of the training
        loss on the first full window, with the entity embeddings' row-norm
        statistics. Its dropouts draw from a generator seeded 0, as JAX's
        from a fixed key, and leave the state's generator alone. On a mesh
        (a collective) the statistics are those of the whole arrays."""
        i = min(self.cfg.train.train_history_len, len(self.train_list) - 1)
        history, triples, mask = self.window(i)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        total, _, _ = self.loss(dataclasses.replace(state, gen=gen), history, triples, mask)
        grads = sharding.train_grads(total, state, shard=self.shard)
        rec = gradient_stats(state.params, grads, shard=self.shard)
        rec.update(embedding_stats(state.params["dynamic_emb"], "entity", shard=self.shard))
        return rec

    # ------------------------------------------------------------------ eval
    def evaluate(self, state: TrainState, history_list: Sequence[np.ndarray],
                 eval_list: Sequence[np.ndarray],
                 ent_filters: Optional[List[AnswerFilter]] = None,
                 rel_filters: Optional[List[AnswerFilter]] = None,
                 multi_step: bool = False, topk: int = 10, relation_evaluation: bool = False
                 ) -> Dict[str, metrics.RankStats]:
        """Rolling-window evaluation (ref:src/main.py:33-107), single-step
        or multi-step (:func:`multi_step_ranks`; not under
        ``dist_agg="halo"``, as in JAX)."""
        if multi_step and self.mesh is not None and self.dist_agg == "halo":
            raise ValueError(
                "multi-step inference rebuilds history from predictions "
                "per step (host loop) and is not supported under "
                "dist_agg='halo'; use dist_agg='gspmd' mesh mode for it")
        return evaluate(state.params, state.model_state, self.cfg.model, self.cfg.train,
                        history_list, eval_list, ent_filters, rel_filters, self.device,
                        functools.partial(regcn_predict, static_snap=self.static_snap,
                                          impl=self.impl),
                        multi_step=multi_step, topk=topk,
                        relation_evaluation=relation_evaluation, sharded=self._sharded_eval())

    def test(self, state: TrainState, multi_step: bool = False, topk: int = 10,
             relation_evaluation: bool = False) -> Dict[str, metrics.RankStats]:
        """The test split, with train + valid as its history."""
        ent_f = build_answer_filters_by_time(self.data.test, self.num_rels, False)
        rel_f = build_answer_filters_by_time(self.data.test, self.num_rels, True)
        return self.evaluate(state, self.train_list + self.valid_list, self.test_list, ent_f,
                             rel_f, multi_step=multi_step, topk=topk,
                             relation_evaluation=relation_evaluation)

    # ------------------------------------------------------------------- fit
    def fit(self, state: Optional[TrainState] = None, checkpoint_path: Optional[str] = None,
            log_every: int = 1, resume: bool = False, selection_metric: str = "ent_raw"
            ) -> Tuple[TrainState, Dict]:
        """``tc.n_epochs`` epochs with best-on-valid selection
        (ref:src/main.py:211-279); returns (best state, info).

        The valid split is evaluated every ``tc.evaluate_every`` epochs; the
        best state by ``selection_metric`` ("ent_raw" or "rel_raw") is kept
        as a copy and, with ``checkpoint_path``, saved at the root of it on
        each improvement, while ``<path>/last`` takes the state after every
        epoch. ``resume=True`` continues from the checkpoint there, if any:
        parameters, Adam moments, BN statistics, the dropout generator and
        the step, from the epoch after the saved one. ``info`` holds
        ``best_valid_mrr_raw`` (the selection metric's best value),
        ``selection_metric`` and ``history``, a row per evaluated epoch."""
        tc = self.cfg.train
        if selection_metric not in ("ent_raw", "rel_raw"):
            raise ValueError(f"selection_metric must be 'ent_raw' or 'rel_raw', got "
                             f"{selection_metric!r}")
        start_epoch, best_mrr, best_epoch = 0, 0.0, -1
        state = state or self.init_state()
        if resume and train_state.has_resumable_checkpoint(checkpoint_path):
            state, start_epoch, best_mrr, best_epoch = train_state.restore_for_resume(
                checkpoint_path, state, shard=self.shard)
            log.info("resumed from %s at epoch %d (best MRR %.4f @ %d)", checkpoint_path,
                     start_epoch, best_mrr, best_epoch)
        ent_f = build_answer_filters_by_time(self.data.valid, self.num_rels, False)
        rel_f = build_answer_filters_by_time(self.data.valid, self.num_rels, True)
        best_state = train_state.copy_state(state)
        rows = []
        for epoch in range(start_epoch, tc.n_epochs):
            t0 = time.perf_counter()
            losses = self.run_epoch(state, epoch)
            dt = time.perf_counter() - t0
            if epoch % log_every == 0:
                log.info("epoch %04d | loss e/r/s: %.4f/%.4f/%.4f | %.1fs", epoch,
                         losses["entity"], losses["relation"], losses["static"], dt)
            if self.run_analysis:
                rec = self.analysis_record(state)
                if self.shard is None or self.shard.first:
                    log.info("analysis %04d | grad global %.4e | ent norm %.3f±%.3f", epoch,
                             rec["global_norm"], rec["entity_norm_mean"],
                             rec["entity_norm_std"])
            if epoch % tc.evaluate_every == 0:
                stats = self.evaluate(state, self.train_list, self.valid_list, ent_f, rel_f)
                mrr = stats[selection_metric].mrr
                row = {"epoch": epoch, "losses": losses, "valid_mrr_raw": stats["ent_raw"].mrr,
                       "valid_mrr_filter": stats["ent_filter"].mrr, "epoch_time_s": dt}
                if self.run_analysis:
                    row["analysis"] = rec
                rows.append(row)
                log.info("epoch %04d | valid %s MRR %.4f | ent raw/filt %.4f/%.4f (best %.4f)",
                         epoch, selection_metric, mrr, stats["ent_raw"].mrr,
                         stats["ent_filter"].mrr, best_mrr)
                if mrr > best_mrr:
                    best_mrr, best_epoch = mrr, epoch
                    best_state = train_state.copy_state(state)
                    if checkpoint_path:
                        train_state.save_checkpoint(checkpoint_path, state,
                                                    {"epoch": epoch, "mrr": mrr},
                                                    shard=self.shard)
            # every epoch, evaluated or not, so resume never re-runs one
            if checkpoint_path:
                train_state.save_last_checkpoint(checkpoint_path, state, epoch, best_mrr,
                                                 best_epoch, shard=self.shard)
        return best_state, {"best_valid_mrr_raw": best_mrr, "selection_metric": selection_metric,
                            "history": rows}
