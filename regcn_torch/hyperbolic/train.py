"""Hyperbolic training: the trainer of the hyperbolic slice.

Counterpart of ``regcn_tpu/hyperbolic/train.py`` (any of the four
encoders, LGCN, the uvrgcn, FHNN and HGAT, with any of the four
decoders: among them config 3, LGCN + RotH; config 4, uvrgcn + AttH with
learned and per-relation curvature and an entity bias; the headline,
uvrgcn + tangent ConvTransE / R; config 5, the headline with EST and TANS
negatives; fixed or learned curvature with its warmup, radius
supervision): degree/frequency radius targets, one optimizer step per
training snapshot in the JAX trainer's shuffled order, the decoders' BN
running statistics carried from step to step, rolling-window raw and
filtered evaluation (single- or multi-step), and ``fit`` with patience,
the best state kept, best and ``last/`` checkpoints and resume.

EST (``use_est``): the trainer indexes the training snapshots' events
(``est.TemporalIndex``); a training step on snapshot i takes the
retrieval batch of its heads at time i and then writes the H-PES memories
back, an eval snapshot t the batch at ``time_offset + t`` (the valid
split follows the training snapshots, the test split both). TANS
(``use_time_aware_negative``): each training step squashes the other
true tails, over the training snapshots, of its queries. Both inputs of
a training window are built once, like the window.

Static graph (``use_static``): the entity-word graph is built once, on
the trainer's device, and every step and eval snapshot starts from its
embedding. ``manifold_entities``: the dual optimizer, Riemannian Adam on
the entity table (``regcn_torch/hyperbolic/optim.py``). Triple batching
(``triple_batch_size``): a snapshot's padded triples go through in chunks
of that size, all-masked chunks skipped, each with its own slice of EST's
retrieval batch and its own TANS COO; in mode ``accumulate`` (the
reference's) each chunk's loss is its own mean, the gradients add up
over the chunks and the clip and the optimizer step come once per
snapshot, in mode ``per_chunk`` each chunk takes a step; the epoch logs
each snapshot's mean of its chunk losses. ``run_analysis``: ``fit``
records gradient, embedding, radius and curvature statistics each epoch
(:meth:`HyperbolicTrainer.analysis_record`).

The JAX trainer runs an epoch as one fused ``lax.scan`` over a store
front-padded with empty snapshots; here a Python loop takes the same
steps in the same order. A window shorter than the history length is
run as it is: the fused path's empty front snapshots are identity steps,
so both give the same result.

``compute_dtype="bfloat16"``: each step's loss takes the parameters and
the history in bf16 (``utils/dtypes.py:tree_to_compute``; 0-d leaves
such as a learned curvature stay fp32), its gradients and losses come
back in fp32, and both optimizers stay fp32; evaluation runs in bf16 with
fp32 scores, as JAX's ``predict_step`` does.

``dilate_len`` is not read, as JAX's hyperbolic trainer does not read it.

``mesh`` (``regcn_torch.parallel.mesh.make_mesh`` over an initialised
process group; every rank builds its own trainer and calls the same
methods) trains entity-sharded, as JAX's ``HyperbolicTrainer(mesh=...)``:
the state holds this rank's rows of ``dynamic_emb`` and of its optimizer
moments, every other leaf replicated; ``dist_agg`` picks the cross-shard
aggregation of every encoder, ``"gspmd"`` (an all-gather of the rows) or
``"halo"`` (the boundary-set ``all_to_all``), set as ``cfg.impl``. Each
training window and evaluation window carries the rank's partition of
its edges; multi-step evaluation runs in both modes (JAX rebuilds each
window's halo on the host too); checkpoints hold whole states. EST's
memories stay whole and replicated, and every rank writes them back alike
from the first rank's context rows;
each TANS COO, of the whole step or of a chunk, is cut on the host to the
rank's candidate columns (``est.shard_tans_coo``). Triple batching runs
under ``"gspmd"``, each chunk's gradients summed across the ranks and the
clip's norm taken across them once a step (under ``"halo"`` JAX refuses it
with a ``ValueError``, and so does this trainer). With the static graph
``words_emb`` is row-sharded too, so ``num_words`` must be a multiple of
the ``graph`` axis (a ``ValueError`` at construction, as JAX refuses it).
Under bf16 compute the rank's rows are cast as the whole table is on one
device, the gathers and the halo's exchange carry bf16 rows and every sum
across ranks runs in fp32 (``parallel/collectives.py``). ``run_analysis``
records the norms of whole arrays (the entity table's rows all-gathered),
the same on every rank, and only the mesh's first rank logs it. A ``data``
axis above 1 replicates the whole training, as JAX's rules replicate every
leaf over it: every step's gradients, BatchNorm statistics and EST
context rows, and the ranks of every evaluation, are taken from the first
replica (a broadcast over the ``data`` group), so the replicas stay
bit-equal by construction although each computes apart and the card's
atomic sums add in no fixed order; the dropouts draw from the same seed
on every replica, and only the mesh's first rank writes a checkpoint.
Still to come on a mesh (ROADMAP A.11b): the sweep's model axis
(``train/sweep.py``) and the counterpart of JAX's ``dryrun_multichip``.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from regcn_torch.config import TrainConfig
from regcn_torch.data.answers import build_answer_filters_by_time
from regcn_torch.data.dataset import TKGData
from regcn_torch.data.snapshots import pad_triples, split_by_time
from regcn_torch.dist import sharded_impl
from regcn_torch.hyperbolic import est
from regcn_torch.hyperbolic import model as hmodel
from regcn_torch.hyperbolic import ops as H
from regcn_torch.hyperbolic.model import HyperbolicConfig, HypModelState
from regcn_torch.hyperbolic.optim import dual_optimizer, manifold_mask
from regcn_torch.parallel import sharding
from regcn_torch.parallel.collectives import from_first_rank, from_first_replica, rows_of
from regcn_torch.parallel.mesh import (check_entity_divisibility, check_words_divisibility,
                                       row_shard)
from regcn_torch.train import loop, metrics
from regcn_torch.train import state as train_state
from regcn_torch.train.optim import tree_leaves
from regcn_torch.train.state import TrainState, copy_state
from regcn_torch.utils.dtypes import compute_dtype, tree_to_compute, tree_to_fp32
from regcn_torch.utils.profiling import embedding_stats, gradient_stats

log = logging.getLogger(__name__)

LOSS_KEYS = ("entity", "relation", "static", "radius")


def compute_radius_targets(
    train_list: List[np.ndarray], num_nodes: int,
    alpha: float = 0.5, beta: float = 0.5,
    radius_min: float = 0.5, radius_max: float = 3.0,
) -> np.ndarray:
    """Degree/frequency-based radius targets [num_nodes] float32."""
    freq = np.zeros(num_nodes, dtype=np.float64)
    pairs = []
    for snapshot in train_list:
        if len(snapshot) == 0:
            continue
        src, dst = snapshot[:, 0], snapshot[:, 2]
        freq += np.bincount(src, minlength=num_nodes)
        freq += np.bincount(dst, minlength=num_nodes)
        pairs.append(np.stack([src, dst], 1))
        pairs.append(np.stack([dst, src], 1))
    if pairs:
        uniq = np.unique(np.concatenate(pairs), axis=0)
        degree_counts = np.bincount(uniq[:, 0], minlength=num_nodes).astype(np.float64)
    else:
        degree_counts = np.zeros(num_nodes)
    score = alpha * np.log1p(degree_counts) + beta * np.log1p(freq)
    if score.max() - score.min() < 1e-9:
        normed = np.full_like(score, 0.5)
    else:
        normed = (score - score.min()) / (score.max() - score.min())
    return (radius_min + (radius_max - radius_min) * normed).astype(np.float32)


class HyperbolicTrainer:
    def __init__(self, cfg: HyperbolicConfig, tc: TrainConfig, data: TKGData, *,
                 curvature_warmup_epochs: int = 0, triple_batch_size: Optional[int] = None,
                 triple_batch_mode: str = "accumulate", mesh=None, dist_agg: str = "gspmd",
                 run_analysis: bool = False, device="cuda"):
        if triple_batch_mode not in ("accumulate", "per_chunk"):
            raise ValueError(f"triple_batch_mode must be 'accumulate' or 'per_chunk', got "
                             f"{triple_batch_mode!r}")
        if dist_agg not in ("gspmd", "halo"):
            raise ValueError(f"dist_agg must be 'gspmd' or 'halo', got {dist_agg!r}")
        if dist_agg == "halo":
            if mesh is None:
                raise ValueError("dist_agg='halo' requires a mesh")
            if triple_batch_size:
                raise ValueError("dist_agg='halo' runs the fused-epoch path only; "
                                 "triple_batch_size chunking is not supported with it")
        hmodel.check_supported(cfg)
        hmodel.check_device(cfg, device)
        self.compute_dtype = compute_dtype(cfg.compute_dtype)
        self.mesh, self.dist_agg, self.shard = mesh, dist_agg, None
        if mesh is not None:
            check_entity_divisibility(data.num_nodes, mesh)
            if cfg.use_static:
                check_words_divisibility(data.num_words, mesh)
            # every encoder and decoder dispatches on the marker
            cfg = dataclasses.replace(cfg, impl=sharded_impl(mesh, dist_agg))
            hmodel.check_supported(cfg)
            self.shard = row_shard(mesh, data.num_nodes)
        self.cfg, self.tc, self.data = cfg, tc, data
        self.device = torch.device(device)
        self.curvature_warmup_epochs = curvature_warmup_epochs
        self.triple_batch_size, self.triple_batch_mode = triple_batch_size, triple_batch_mode
        self.run_analysis = run_analysis
        self.num_rels, self.num_nodes = data.num_rels, data.num_nodes
        self.train_list = split_by_time(data.train)
        self.valid_list = split_by_time(data.valid)
        self.test_list = split_by_time(data.test)
        self.radius_target = compute_radius_targets(
            self.train_list, data.num_nodes, alpha=cfg.radius_alpha, beta=cfg.radius_beta,
            radius_min=cfg.radius_min, radius_max=cfg.radius_max)
        self.temporal_index = self.true_tails = None
        if cfg.use_est:
            self.temporal_index = est.TemporalIndex(cfg.est_history_len)
            self.temporal_index.build(self.train_list, self.num_rels)
        if cfg.use_time_aware_negative:
            self.true_tails = est.build_true_tails_dict(self.train_list, self.num_rels)
        self.static_snap = loop.static_snapshot(data, tc, self.device) if cfg.use_static else None
        self.opt = dual_optimizer(tc, cfg)
        self._windows: Dict = {}
        self._est_windows: Dict = {}
        self._chunks: Dict = {}

    # ----------------------------------------------------------------- state
    def state_from(self, params, model_state: HypModelState, seed: Optional[int] = None
                   ) -> TrainState:
        """A fresh training state (zero Adam moments; with EST, zero H-PES
        memories; with ``manifold_entities`` the entity table marked for
        Riemannian Adam) around ``params``, copied onto the trainer's
        device; on a mesh, this rank's rows of the whole ``params``."""
        state = train_state.state_from(params, model_state, self.tc,
                                       self.tc.seed + 1 if seed is None else seed, self.device)
        if self.cfg.manifold_entities:
            state.opt_state.manifold = manifold_mask(state.params)
        if self.cfg.use_est:
            state.est_state = est.init_est_state(self.cfg.num_ents, self.cfg.h_dim, self.device)
        return state if self.shard is None else sharding.shard_state(state, self.shard)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Random parameters from ``torch.Generator().manual_seed(seed)``
        (default ``tc.seed``), radius_static seeded with the radius targets."""
        seed = self.tc.seed if seed is None else seed
        params, model_state = hmodel.init_params(
            torch.Generator().manual_seed(seed), self.cfg, self.radius_target, device="cpu")
        return self.state_from(params, model_state, seed + 1)

    # ------------------------------------------------------------------ data
    def window(self, i: int):
        """(history, triples, mask) on the device for training snapshot i:
        the window is ``train_list[max(0, i - hlen):i]``, on a mesh with the
        rank's partition of its edges; built once."""
        if i not in self._windows:
            if self.shard is None:
                self._windows[i] = loop.train_window(self.train_list, i, self.num_nodes,
                                                     self.num_rels, self.tc, self.device)
            else:
                self._windows[i] = loop.sharded_train_window(self.train_list, i, self.num_rels,
                                                             self.tc, self._sharded_eval())
        return self._windows[i]

    def _sharded_eval(self):
        """The rank's windows and ranks on a mesh, else None."""
        if self.shard is None:
            return None
        return sharding.ShardedEval(self.cfg, self.tc, self.dist_agg, self.shard, self.device)

    def est_window(self, i: int) -> tuple:
        """(retrieval batch, TANS COO) on the device for training snapshot i,
        each None where the config does without; built once."""
        if i not in self._est_windows:
            triples, mask = pad_triples(self.train_list[i], self.num_rels, self.tc.triple_bucket)
            self._est_windows[i] = self._est_inputs(triples, mask, i)
        return self._est_windows[i]

    def _est_inputs(self, triples: np.ndarray, mask: np.ndarray, i: int) -> tuple:
        """(retrieval batch, TANS COO) of ``triples`` at training time i; on
        a mesh the COO of the rank's candidate columns."""
        rb = tans = None
        if self.temporal_index is not None:
            rb = est.RetrievalBatch.query(self.temporal_index, triples, mask, i, self.device)
        if self.true_tails is not None:
            coo = est.tans_mask_coo(triples, mask, self.true_tails)
            if self.shard is not None:
                coo = est.shard_tans_coo(*coo, len(triples), self.shard)
            tans = tuple(torch.from_numpy(a).to(self.device) for a in coo)
        return rb, tans

    def chunks(self, i: int) -> list:
        """Triple batching's chunks of training snapshot i: (triples, mask,
        retrieval batch, TANS COO) on the device for each chunk of
        ``triple_batch_size`` rows of the padded triples that holds a real
        one; built once. A snapshot whose padded triples fit in one chunk
        is not cut (an empty list)."""
        if i not in self._chunks:
            triples, mask = pad_triples(self.train_list[i], self.num_rels, self.tc.triple_bucket)
            tb, out = self.triple_batch_size, []
            if len(triples) > tb:
                for s in range(0, len(triples), tb):
                    tr, mk = triples[s:s + tb], mask[s:s + tb]
                    if mk.sum() > 0:
                        out.append((torch.from_numpy(tr).long().to(self.device),
                                    torch.from_numpy(mk).to(self.device),
                                    *self._est_inputs(tr, mk, i)))
            self._chunks[i] = out
        return self._chunks[i]

    def _predict(self):
        """The model's eval-mode scores, the static graph bound in. Under
        bf16 compute the parameters and the history enter in bf16 and the
        scores leave in fp32, as JAX's ``predict_step`` runs them."""
        predict = functools.partial(hmodel.predict, static_snap=self.static_snap)
        cdt = self.compute_dtype
        if cdt == torch.float32:
            return predict

        def predict_compute(params, model_state, cfg, history, triples, mask=None, **kw):
            s_ob, s_rel = predict(tree_to_compute(params, cdt), model_state, cfg,
                                  tree_to_compute(history, cdt), triples, mask, **kw)
            return s_ob.float(), s_rel.float()

        return predict_compute

    def _eval_inputs(self, state: TrainState, time_offset: int):
        """``step_inputs`` of the rolling evaluation: EST's retrieval batch of
        eval snapshot t at ``time_offset + t``; None without EST."""
        if self.temporal_index is None:
            return None

        def inputs(t, triples, mask):
            rb = est.RetrievalBatch.query(self.temporal_index, triples, mask, time_offset + t,
                                          self.device)
            return {"est_inputs": (state.est_state, rb)}

        return inputs

    def _curvature_max(self, epoch: int) -> float:
        """Warmup schedule for the curvature's upper bound."""
        cfg = self.cfg
        if not cfg.learn_curvature or self.curvature_warmup_epochs <= 0:
            return cfg.curvature_max
        if epoch >= self.curvature_warmup_epochs:
            return cfg.curvature_max
        progress = (epoch + 1) / self.curvature_warmup_epochs
        return cfg.c + (cfg.curvature_max - cfg.c) * progress

    # ----------------------------------------------------------------- train
    def loss(self, state: TrainState, history, triples, mask, cmax, rb=None, tans=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], HypModelState, Dict]:
        """(total, losses, new HypModelState, aux of ``get_loss``): total = tw *
        entity + (1 - tw) * relation + static + radius, with the dropouts of
        a training step; ``rb`` and ``tans`` as ``est_window`` gives them.
        The parameters and the history enter in the compute dtype, the
        losses leave in fp32."""
        est_inputs = (state.est_state, rb) if (self.cfg.use_est and rb is not None) else None
        _, losses, new_model_state, aux = hmodel.get_loss(
            tree_to_compute(state.params, self.compute_dtype), state.model_state, self.cfg,
            tree_to_compute(history, self.compute_dtype), triples, mask,
            static_snap=self.static_snap, est_inputs=est_inputs, tans_mask_coo=tans,
            gen=state.gen, train=True, curvature_max=cmax)
        losses = tree_to_fp32(losses)
        tw = self.tc.task_weight
        total = (tw * losses["entity"] + (1.0 - tw) * losses["relation"]
                 + losses["static"] + losses["radius"])
        return total, losses, new_model_state, aux

    def est_update(self, state: TrainState, triples, mask, aux) -> None:
        """The H-PES writeback of a step into ``state.est_state``, from the
        fused context rows of its forward (the unenriched rows without a
        retrieval batch) and the gate parameters as they were in that
        forward; a no-op without EST. On a mesh every rank takes the first
        rank's context rows, which the others hold up to the card's atomic
        sums, so the replicated memories stay bit-equal."""
        if state.est_state is None:
            return
        ctx = aux.get("est_ctx_tan")
        if ctx is None:  # on a mesh the heads' rows gathered from their owners
            with torch.no_grad():
                ctx = H.log_map_zero(rows_of(aux["pre_emb"], triples[:, 0], self.shard),
                                     aux["curvature"])
        if self.shard is not None:  # every rank writes back the mesh's first rank's rows
            ctx = from_first_replica(from_first_rank(ctx, self.shard.group), self.shard)
        state.est_state = est.update_states(state.params["est"], state.est_state, triples[:, 0],
                                            mask, ctx, self.cfg.est_state_alpha)

    def grad_step(self, state: TrainState, history, triples, mask, cmax, rb=None, tans=None
                  ) -> Tuple[Dict[str, torch.Tensor], tuple]:
        """A step's forward and backward without the optimizer: (losses,
        the gradients in ``tree_leaves`` order, None where a leaf has none).
        The new BN statistics and the H-PES writeback go into ``state``;
        the writeback reads the gate parameters of the forward, as JAX's
        ``update_states`` does."""
        total, losses, new_model_state, aux = self.loss(state, history, triples, mask, cmax, rb,
                                                        tans)
        grads = sharding.train_grads(total, state, self.opt, self.shard)
        self.est_update(state, triples, mask, aux)
        state.model_state = sharding.from_first_replica_tree(new_model_state, self.shard)
        return {k: v.detach() for k, v in losses.items()}, grads

    def train_step(self, state: TrainState, history, triples, mask, cmax, rb=None, tans=None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step, in place on ``state``; returns the losses
        (0-d tensors on the device, not synchronised)."""
        losses, grads = self.grad_step(state, history, triples, mask, cmax, rb, tans)
        self.opt.step(tree_leaves(state.params), grads, state.opt_state)
        state.step += 1
        return losses

    def snapshot_step(self, state: TrainState, i: int, cmax) -> Dict[str, torch.Tensor]:
        """The step(s) of training snapshot i: one ``train_step``, or with
        triple batching one per chunk (``per_chunk``) or one from the sum
        of the chunks' gradients (``accumulate``). Returns the losses, the
        mean of the chunks' where there are chunks."""
        history = self.window(i)[0]
        chunks = self.chunks(i) if self.triple_batch_size else []
        if not chunks:
            return self.train_step(state, *self.window(i), cmax, *self.est_window(i))
        seen, acc = [], None
        for triples, mask, rb, tans in chunks:
            if self.triple_batch_mode == "per_chunk":
                seen.append(self.train_step(state, history, triples, mask, cmax, rb, tans))
                continue
            losses, grads = self.grad_step(state, history, triples, mask, cmax, rb, tans)
            seen.append(losses)
            acc = list(grads) if acc is None else [
                g if a is None else (a if g is None else a + g) for a, g in zip(acc, grads)]
        if acc is not None:
            self.opt.step(tree_leaves(state.params), acc, state.opt_state)
            state.step += 1
        return {k: torch.stack([l[k] for l in seen]).mean() for k in seen[0]}

    def epoch_order(self, epoch: int) -> List[int]:
        """The training snapshots of an epoch, in the JAX trainer's order."""
        idx = list(range(1, len(self.train_list)))
        random.Random(self.tc.seed + epoch).shuffle(idx)
        return idx

    def run_epoch(self, state: TrainState, epoch: int) -> Dict[str, float]:
        """The steps of every training snapshot; returns the mean losses."""
        cmax = self._curvature_max(epoch)
        order = self.epoch_order(epoch)
        sums = torch.zeros(len(LOSS_KEYS), device=self.device)
        for i in order:
            losses = self.snapshot_step(state, i, cmax)
            sums += torch.stack([losses[k] for k in LOSS_KEYS])
        means = (sums / max(len(order), 1)).tolist()  # one sync per epoch
        return dict(zip(LOSS_KEYS, means))

    # ------------------------------------------------------------- analysis
    def analysis_record(self, state: TrainState, epoch: int = 0) -> Dict[str, float]:
        """The ``run_analysis`` sample of an epoch (``regcn_tpu``'s
        ``HyperbolicTrainer.analysis_record``): the gradient norms of the
        training loss on the first full window, with EST's retrieval batch
        and without TANS, as JAX takes them; the entity table's row norms;
        the static radii's mean and spread; the curvature. Its dropouts
        draw from a generator seeded 0, as JAX's from a fixed key, and the
        state is left as it was. On a mesh (a collective) the statistics
        are those of the whole arrays."""
        i = min(self.tc.train_history_len, len(self.train_list) - 1)
        history, triples, mask = self.window(i)
        rb = self.est_window(i)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        cmax = self._curvature_max(epoch)
        probe = dataclasses.replace(state, gen=gen)
        total, *_ = self.loss(probe, history, triples, mask, cmax, rb, None)
        grads = sharding.train_grads(total, state, shard=self.shard)
        rec = gradient_stats(state.params, grads, shard=self.shard)
        rec.update(embedding_stats(state.params["dynamic_emb"], "entity", shard=self.shard))
        radius = state.params["radius_static"].detach().cpu().numpy()
        rec["radius_static_mean"] = float(radius.mean())
        rec["radius_static_std"] = float(radius.std())
        rec["curvature"] = float(hmodel.get_curvature(state.params, self.cfg, cmax))
        return rec

    # ------------------------------------------------------------------ eval
    def evaluate(self, state: TrainState, history_list: Sequence[np.ndarray],
                 eval_list: Sequence[np.ndarray], ent_filters=None, rel_filters=None,
                 time_offset: int = 0, multi_step: bool = False, topk: int = 10,
                 relation_evaluation: bool = False) -> Dict[str, metrics.RankStats]:
        """Rolling-window evaluation of ``eval_list``, whose first snapshot
        is at time ``time_offset`` (EST retrieves the events before it)."""
        return loop.evaluate(state.params, state.model_state, self.cfg, self.tc, history_list,
                             eval_list, ent_filters, rel_filters, self.device, self._predict(),
                             multi_step, topk, relation_evaluation,
                             self._eval_inputs(state, time_offset), self._sharded_eval())

    def test(self, state: TrainState, multi_step: bool = False, topk: int = 10,
             relation_evaluation: bool = False) -> Dict[str, metrics.RankStats]:
        """The test split, with train + valid as its history; ``multi_step``
        feeds the top-k predictions back (ref:hyperbolic_main.py:135-142)."""
        return loop.test(state.params, state.model_state, self.cfg, self.tc, self.data,
                         self.device, self._predict(), multi_step, topk, relation_evaluation,
                         self._eval_inputs(state, len(self.train_list) + len(self.valid_list)),
                         self._sharded_eval())

    def fit(self, state: Optional[TrainState] = None, n_epochs: Optional[int] = None,
            patience: int = 20, checkpoint_path: Optional[str] = None, resume: bool = False,
            selection_metric: str = "ent_raw"):
        """Training with early stopping on the validation split; returns
        (best state, info).

        With ``checkpoint_path`` the best state is saved at its root on each
        improvement and the state after every epoch under ``<path>/last``;
        ``resume=True`` continues from there, if a checkpoint exists:
        parameters, Adam moments, BN statistics, the dropout generator, the
        step, the H-PES memories, the best MRR and the patience count
        (epochs since the best)."""
        if selection_metric not in ("ent_raw", "rel_raw"):
            raise ValueError(f"selection_metric must be 'ent_raw' or 'rel_raw', got "
                             f"{selection_metric!r}")
        state = state or self.init_state()
        start_epoch, best_mrr, best_epoch = 0, 0.0, -1
        if resume and train_state.has_resumable_checkpoint(checkpoint_path):
            state, start_epoch, best_mrr, best_epoch = train_state.restore_for_resume(
                checkpoint_path, state, shard=self.shard)
            log.info("resumed from %s at epoch %d (best MRR %.4f @ %d)", checkpoint_path,
                     start_epoch, best_mrr, best_epoch)
        ent_f = build_answer_filters_by_time(self.data.valid, self.num_rels, False)
        rel_f = build_answer_filters_by_time(self.data.valid, self.num_rels, True)
        best_state = copy_state(state)
        bad_epochs = max(0, start_epoch - 1 - best_epoch) if best_epoch >= 0 else 0
        rows = []
        for epoch in range(start_epoch, n_epochs or self.tc.n_epochs):
            t0 = time.perf_counter()
            losses = self.run_epoch(state, epoch)
            dt = time.perf_counter() - t0
            stats = self.evaluate(state, self.train_list, self.valid_list, ent_f, rel_f,
                                  time_offset=len(self.train_list))
            mrr = stats[selection_metric].mrr
            row = {"epoch": epoch, "losses": losses, "valid_mrr_raw": stats["ent_raw"].mrr,
                   "epoch_time_s": dt}
            if self.run_analysis:
                row["analysis"] = rec = self.analysis_record(state, epoch)
                if self.shard is None or self.shard.first:
                    log.info("analysis %03d | grad global %.4e | ent norm %.3f±%.3f | radius "
                             "%.3f±%.3f | c %.5f", epoch, rec["global_norm"],
                             rec["entity_norm_mean"], rec["entity_norm_std"],
                             rec["radius_static_mean"], rec["radius_static_std"],
                             rec["curvature"])
            rows.append(row)
            log.info("epoch %03d | e/r/s/rad %.4f/%.4f/%.4f/%.4f | %s MRR %.4f | %.1fs", epoch,
                     losses["entity"], losses["relation"], losses["static"], losses["radius"],
                     selection_metric, mrr, dt)
            if mrr > best_mrr:
                best_mrr, best_state, best_epoch, bad_epochs = mrr, copy_state(state), epoch, 0
                if checkpoint_path:
                    train_state.save_checkpoint(checkpoint_path, state,
                                                {"epoch": epoch, "mrr": mrr}, shard=self.shard)
            else:
                bad_epochs += 1
            if checkpoint_path:
                train_state.save_last_checkpoint(checkpoint_path, state, epoch, best_mrr,
                                                 best_epoch, shard=self.shard)
            if bad_epochs >= patience:
                log.info("early stop at epoch %d (patience %d)", epoch, patience)
                break
        return best_state, {"best_valid_mrr_raw": best_mrr, "best_epoch": best_epoch,
                            "selection_metric": selection_metric, "history": rows}
