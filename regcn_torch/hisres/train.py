"""HisRES training and evaluation.

Counterpart of ``regcn_tpu/hisres/train.py`` (parity with
ref:hisres_src/hisres_main.py): the per-snapshot and 2-snapshot-union
graph streams (ref :303-313), the one-hot relation vocabularies and
query-conditioned history graphs from the sparse history store
(ref :317-353), and :class:`HisResTrainer` with one optimizer step per
training snapshot, raw and filtered evaluation over the 2B stacked
queries, ``fit`` with best and ``last/`` checkpoints and resume, and
``analysis_record``.

JAX precomputes a split's step inputs into a device-resident store
(``HisResStore``) so that its epoch runs as one fused scan. Here each
training snapshot's inputs (both streams' windows, the queries and their
inverses, both history graphs and the relation vocabulary's (row,
relation) pairs) are built on the host once, on first use, and cached on
the trainer's device, as ``loop.Trainer`` caches its windows; the dense
vocabulary is made from its pairs on the device at each step, as JAX's
scan makes it. Each history graph is padded to its own multiple of
``his_edge_bucket`` rather than to the split's largest: every padded edge
is masked, so the padding changes no value. An eval split's inputs are
cached the same way, per ``cache_key``.

``compute_dtype="bfloat16"``: the training loss runs in bf16 with JAX's
fp32 islands, its gradients reach the fp32 parameters in fp32, and
evaluation runs in fp32, as JAX's ``predict_step`` has no cast.

``mesh`` (``regcn_torch.parallel.mesh.make_mesh``; every rank builds its
own trainer and calls the same methods) trains entity-sharded, as JAX's
``HisResTrainer(mesh=...)``: the state holds this rank's rows of
``dynamic_emb`` and of its Adam moments; ``dist_agg`` (``"gspmd"`` or
``"halo"``) picks both recurrent streams' cross-shard aggregation, and
each stream's window carries the rank's partition of its own graphs (the
2-snapshot unions are graphs of their own); the history graphs and the
vocabularies stay replicated; evaluation, single- and multi-step, ranks
across the candidate shards; checkpoints hold whole states. With the
static graph ``words_emb`` is row-sharded too, so ``num_words`` must be a
multiple of the ``graph`` axis (a ``ValueError`` at construction, as JAX
refuses it). Not ported on a mesh yet, and raising ``NotImplementedError``
(ROADMAP A.11b): bf16 compute, ``run_analysis`` and a ``data`` axis above
1.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from regcn_torch.config import TrainConfig
from regcn_torch.data.answers import build_answer_filters_by_time
from regcn_torch.data.dataset import TKGData
from regcn_torch.data.snapshots import _round_up, build_history, split_by_time
from regcn_torch.dist import sharded_impl
from regcn_torch.hisres import model as hmodel
from regcn_torch.hisres.history import HistoryStore
from regcn_torch.hisres.model import HisResConfig
from regcn_torch.parallel import sharding
from regcn_torch.parallel.mesh import (DATA_AXIS, axis_size, check_entity_divisibility,
                                       check_words_divisibility, row_shard)
from regcn_torch.train import loop, metrics
from regcn_torch.train import state as train_state
from regcn_torch.train.optim import tree_leaves
from regcn_torch.train.state import TrainState
from regcn_torch.utils.dtypes import compute_dtype, tree_to_compute, tree_to_fp32
from regcn_torch.utils.profiling import embedding_stats, gradient_stats

log = logging.getLogger(__name__)

LOSS_KEYS = ("entity", "relation", "static")


def union_snapshots(input_list: List[np.ndarray]) -> List[np.ndarray]:
    """2-snapshot union stream (ref main :307-313); a one-snapshot window
    reuses the snapshot itself (ref :308-309)."""
    if len(input_list) <= 1:
        return list(input_list)
    return [np.unique(np.concatenate([input_list[i], input_list[i + 1]]), axis=0)
            for i in range(len(input_list) - 1)]


class HisResTrainer:
    """HisRES training and evaluation on one device, or entity-sharded on a
    mesh (see the module)."""

    def __init__(self, cfg: HisResConfig, tc: TrainConfig, data: TKGData,
                 his_edge_bucket: int = 4096, his_max_edges: Optional[int] = 65536,
                 mesh=None, dist_agg: str = "gspmd", rel_window_mode: str = "full",
                 run_analysis: bool = False, device="cuda"):
        if dist_agg not in ("gspmd", "halo"):
            raise ValueError(f"dist_agg must be 'gspmd' or 'halo', got {dist_agg!r}")
        if dist_agg == "halo" and mesh is None:
            raise ValueError("dist_agg='halo' requires a mesh")
        hmodel.check_supported(cfg)
        self.mesh, self.dist_agg, self.shard = mesh, dist_agg, None
        if mesh is not None:
            check_entity_divisibility(data.num_nodes, mesh)
            if cfg.use_static:
                check_words_divisibility(data.num_words, mesh)
            for unported, what in ((axis_size(mesh, DATA_AXIS) != 1, "a data axis above 1"),
                                   (run_analysis, "run_analysis")):
                if unported:
                    raise NotImplementedError(f"{what} on a mesh (HisRES) is not ported yet "
                                              "(ROADMAP A.11b)")
            # both recurrent streams dispatch on the marker
            cfg = dataclasses.replace(cfg, impl=sharded_impl(mesh, dist_agg))
            hmodel.check_supported(cfg)
            self.shard = row_shard(mesh, data.num_nodes)
        self.compute_dtype = compute_dtype(cfg.compute_dtype)
        self.cfg, self.tc, self.data = cfg, tc, data
        self.device = torch.device(device)
        self.num_rels, self.num_nodes = data.num_rels, data.num_nodes
        self.run_analysis = run_analysis
        self.his_edge_bucket, self.his_max_edges = his_edge_bucket, his_max_edges
        self.train_list = split_by_time(data.train)
        self.valid_list = split_by_time(data.valid)
        self.test_list = split_by_time(data.test)
        self.all_list = self.train_list + self.valid_list + self.test_list
        self.static_snap = loop.static_snapshot(data, tc, self.device) if cfg.use_static else None
        # the sparse history over every split (the reference's offline tool
        # takes train + valid + test, ref:get_new_history.py:86)
        self.history_store = HistoryStore(self.num_nodes, self.num_rels,
                                          history_len=tc.train_history_len,
                                          rel_window_mode=rel_window_mode).build(self.all_list)
        self.opt = train_state.make_optimizer(tc)
        self._windows: Dict[int, tuple] = {}
        self._eval_cache: Dict = {}

    # ----------------------------------------------------------------- state
    def state_from(self, params, model_state, seed: Optional[int] = None) -> TrainState:
        """A fresh training state (zero Adam moments) around copies of
        ``params`` and ``model_state`` on the trainer's device; on a mesh,
        this rank's rows of the whole ``params``."""
        state = train_state.state_from(params, model_state, self.tc,
                                       self.tc.seed + 1 if seed is None else seed, self.device)
        return state if self.shard is None else sharding.shard_state(state, self.shard)

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Random parameters from ``torch.Generator().manual_seed(seed)``
        (default ``tc.seed``); dropout draws from ``seed + 1``."""
        seed = self.tc.seed if seed is None else seed
        params, model_state = hmodel.init_params(torch.Generator().manual_seed(seed), self.cfg,
                                                 device="cpu")
        return self.state_from(params, model_state, seed + 1)

    # ------------------------------------------------------------------ data
    def _history(self, snaps: Sequence[np.ndarray]):
        """A stream's window on the device; on a mesh with the rank's
        partition of its graphs' edges."""
        tc = self.tc
        if self.shard is not None:
            return self._sharded_eval().window(snaps)
        return build_history(list(snaps), self.num_nodes, self.num_rels,
                             edge_bucket=tc.edge_bucket, rc_bucket=tc.rc_bucket,
                             rc_mode=self.cfg.rc_mode).to(self.device)

    def _queries(self, snap: np.ndarray, t: int) -> tuple:
        """(triples, inverse triples, mask, history graph raw, inverse,
        vocabulary pairs) of one snapshot's queries at global time t, on the
        device. The padded rows keep relation R in their inverses; they are
        masked wherever they are read, and hold no vocabulary pair."""
        arr = np.asarray(snap)[:, :3].astype(np.int32)
        b = len(arr)
        B = _round_up(b, self.tc.triple_bucket)
        raw = np.zeros((B, 3), np.int32)
        raw[:b] = arr
        mask = np.zeros((B,), np.float32)
        mask[:b] = 1.0
        inv = raw[:, [2, 1, 0]].copy()
        inv[:, 1] += self.num_rels
        store = self.history_store
        graphs = [store.his_graph(q, mask, t, inv=is_inv, edge_bucket=self.his_edge_bucket,
                                  max_edges=self.his_max_edges).to(self.device)
                  for q, is_inv in ((raw, False), (inv, True))]
        rows, rels = store.rel_pairs(np.concatenate([raw, inv]), t)
        keep = np.concatenate([mask, mask])[rows] > 0
        dev = self.device
        return (torch.from_numpy(raw).long().to(dev), torch.from_numpy(inv).long().to(dev),
                torch.from_numpy(mask).to(dev), *graphs,
                (torch.from_numpy(rows[keep]).long().to(dev),
                 torch.from_numpy(rels[keep]).long().to(dev)))

    def _inputs(self, window: Sequence[np.ndarray], snap: np.ndarray, t: int) -> tuple:
        """The step inputs of ``snap`` at global time t after ``window``,
        the vocabulary as its pairs."""
        return (self._history(window), self._history(union_snapshots(window)),
                *self._queries(snap, t))

    def rel_vocab(self, pairs: tuple, n_queries: int) -> torch.Tensor:
        """The one-hot [2B, 2R] relation vocabulary from its (row,
        relation) pairs, made on their device."""
        rows, rels = pairs
        vocab = torch.zeros((n_queries, 2 * self.num_rels), device=rows.device)
        vocab[rows, rels] = 1.0
        return vocab

    def _dense(self, inputs: tuple) -> tuple:
        return (*inputs[:-1], self.rel_vocab(inputs[-1], 2 * inputs[2].shape[0]))

    def window(self, i: int) -> tuple:
        """``train_step``'s inputs for training snapshot i: (history,
        history_gg, triples, inverse triples, mask, history graph raw,
        inverse, relation vocabulary). The window is ``train_list[max(0, i
        - hlen):i]``; everything but the dense vocabulary is built once."""
        if i not in self._windows:
            lo = max(0, i - self.tc.train_history_len)
            self._windows[i] = self._inputs(self.train_list[lo:i], self.train_list[i], i)
        return self._dense(self._windows[i])

    # ----------------------------------------------------------------- train
    def loss(self, state: TrainState, history, history_gg, triples, inv_triples, mask, hg_raw,
             hg_inv, rel_vocab):
        """(total, losses, new HisResState) of a training step: total =
        tw * entity + (1 - tw) * relation + static. The parameters and both
        streams' windows enter in the compute dtype (the history graphs and
        the vocabulary stay fp32, as JAX casts only those three), the
        losses leave in fp32."""
        cdt = self.compute_dtype
        _, losses, new_model_state = hmodel.get_loss(
            tree_to_compute(state.params, cdt), state.model_state, self.cfg,
            tree_to_compute(history, cdt), tree_to_compute(history_gg, cdt), triples,
            inv_triples, mask, hg_raw, hg_inv, rel_vocab, static_snap=self.static_snap,
            gen=state.gen, train=True)
        losses = tree_to_fp32(losses)
        tw = self.tc.task_weight
        total = tw * losses["entity"] + (1.0 - tw) * losses["relation"] + losses["static"]
        return total, losses, new_model_state

    def train_step(self, state: TrainState, *inputs) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``window(i)``'s inputs, in place on
        ``state``; returns the losses (0-d tensors, not synchronised)."""
        total, losses, new_model_state = self.loss(state, *inputs)
        grads = sharding.train_grads(total, state, self.opt, self.shard)
        self.opt.step(tree_leaves(state.params), grads, state.opt_state)
        state.model_state = new_model_state
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def epoch_order(self, epoch: int) -> List[int]:
        """The training snapshots of an epoch in the JAX trainer's order:
        its shuffle, the windows shorter than the history length first
        (JAX runs them before its fused scan over the others)."""
        idx = list(range(1, len(self.train_list)))
        random.Random(self.tc.seed + epoch).shuffle(idx)
        hlen = self.tc.train_history_len
        return [i for i in idx if i < hlen] + [i for i in idx if i >= hlen]

    def run_epoch(self, state: TrainState, epoch: int) -> Dict[str, float]:
        """One step per training snapshot; returns the mean losses (one
        host sync per epoch)."""
        order = self.epoch_order(epoch)
        sums = torch.zeros(len(LOSS_KEYS), device=self.device)
        for i in order:
            losses = self.train_step(state, *self.window(i))
            sums += torch.stack([losses[k] for k in LOSS_KEYS])
        return dict(zip(LOSS_KEYS, (sums / max(len(order), 1)).tolist()))

    # ------------------------------------------------------------------ eval
    def predict(self, state: TrainState, *inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode scores of ``window``-style inputs: (entity [2B, N],
        relation [2B, 2R]), in fp32 whatever the compute dtype."""
        return hmodel.predict(state.params, state.model_state, self.cfg, *inputs,
                              static_snap=self.static_snap)

    def _eval_steps(self, history_list, eval_list, ent_filters, rel_filters, time_offset):
        """Per eval snapshot: (inputs, the four filter COOs on the device,
        the real rows of the 2B stacked queries)."""
        window = list(history_list[-self.tc.test_history_len:])
        steps = []
        for t, snap in enumerate(eval_list):
            inputs = self._inputs(window, snap, time_offset + t)
            allq = torch.cat([inputs[2], inputs[3]]).cpu().numpy()
            m = inputs[4].cpu().numpy()
            er, ec = metrics.filter_coo_padded(ent_filters[t] if ent_filters else None,
                                               allq[:, [0, 1]], allq[:, 2])
            rr, rc = metrics.filter_coo_padded(rel_filters[t] if rel_filters else None,
                                               allq[:, [0, 2]], allq[:, 1])
            coo = tuple(torch.from_numpy(a).to(self.device) for a in (er, ec, rr, rc))
            steps.append((inputs, coo, np.concatenate([m, m]) > 0))
            window = (window + [snap])[-self.tc.test_history_len:]
        return steps

    def _sharded_eval(self):
        """The rank's windows and ranks on a mesh, else None."""
        if self.shard is None:
            return None
        return sharding.ShardedEval(self.cfg, self.tc, self.dist_agg, self.shard, self.device,
                                    self.cfg.rc_mode)

    @torch.inference_mode()
    def _rolling_ranks(self, state, steps) -> Dict[str, List[np.ndarray]]:
        ranks = {k: [] for k in loop.RANK_KEYS}
        sharded = self._sharded_eval()
        for inputs, (er, ec, rr, rc), allm in steps:
            s_ent, s_rel = self.predict(state, *self._dense(inputs))
            allq = torch.cat([inputs[2], inputs[3]])
            step = (sharded.ranks(s_ent, s_rel, allq, er, ec, rr, rc) if sharded is not None else
                    torch.stack([
                        metrics.device_ranks(s_ent, allq[:, 2]),
                        metrics.device_filtered_ranks(s_ent, allq[:, 2], er, ec),
                        metrics.device_ranks(s_rel, allq[:, 1]),
                        metrics.device_filtered_ranks(s_rel, allq[:, 1], rr, rc),
                    ])).cpu().numpy()
            for key, row in zip(loop.RANK_KEYS, step):
                ranks[key].append(row[allm])
        return ranks

    def _multi_step_ranks(self, state, history_list, eval_list, ent_filters, rel_filters,
                          time_offset, topk, relation_evaluation) -> Dict[str, List[np.ndarray]]:
        """Multi-step evaluation (ref:hisres_main.py:53-58, :81-89,
        :129-137): the history vocabularies frozen at ``time_offset`` (no
        ground truth beyond the last real snapshot), each snapshot's top-k
        predictions fed back into the window in its oldest snapshot's
        place (the snapshot itself when there are none)."""
        window = list(history_list[-self.tc.test_history_len:])
        ranks = {k: [] for k in loop.RANK_KEYS}
        for t, snap in enumerate(eval_list):
            inputs = self._dense(self._inputs(window, snap, time_offset))
            with torch.inference_mode():
                s_ent, s_rel = self.predict(state, *inputs)
                if self.shard is not None:
                    s_ent = self._sharded_eval().full_scores(s_ent)
            allq = torch.cat([inputs[2], inputs[3]]).cpu().numpy()
            m = inputs[4].cpu().numpy()
            allm = np.concatenate([m, m]) > 0
            tq = allq[allm]
            # the dense scores to the host in float64, as in the JAX loop
            s_ent = s_ent.cpu().numpy().astype(np.float64)[allm]
            s_rel = s_rel.cpu().numpy().astype(np.float64)[allm]
            ranks["ent_raw"].append(metrics.ranks_from_scores(s_ent, tq[:, 2]))
            ranks["ent_filter"].append(metrics.filtered_ranks(
                s_ent, tq[:, [0, 1]], tq[:, 2], ent_filters[t] if ent_filters else None))
            ranks["rel_raw"].append(metrics.ranks_from_scores(s_rel, tq[:, 1]))
            ranks["rel_filter"].append(metrics.filtered_ranks(
                s_rel, tq[:, [0, 2]], tq[:, 1], rel_filters[t] if rel_filters else None))
            if relation_evaluation:
                pred = loop.construct_snap_r(tq, self.num_rels, s_rel, topk)
            else:
                pred = loop.construct_snap(tq, self.num_rels, s_ent, topk)
            window.pop(0)
            window.append(pred if len(pred) else snap)
        return ranks

    def evaluate(self, state: TrainState, history_list: Sequence[np.ndarray],
                 eval_list: Sequence[np.ndarray], ent_filters=None, rel_filters=None,
                 time_offset: int = 0, cache_key=None, multi_step: bool = False,
                 topk: int = 10, relation_evaluation: bool = False
                 ) -> Dict[str, metrics.RankStats]:
        """Rolling-window evaluation of ``eval_list``, whose first snapshot
        is at global time ``time_offset``: the 2B stacked queries [raw;
        inverse] ranked raw and filtered. Single-step inputs are cached
        under ``cache_key``."""
        if multi_step:
            ranks = self._multi_step_ranks(state, history_list, eval_list, ent_filters,
                                           rel_filters, time_offset, topk, relation_evaluation)
        else:
            steps = self._eval_cache.get(cache_key) if cache_key is not None else None
            if steps is None:
                steps = self._eval_steps(history_list, eval_list, ent_filters, rel_filters,
                                         time_offset)
                if cache_key is not None:
                    self._eval_cache[cache_key] = steps
            ranks = self._rolling_ranks(state, steps)
        return {k: metrics.stat_ranks(v) for k, v in ranks.items()}

    def test(self, state: TrainState, multi_step: bool = False, topk: int = 10,
             relation_evaluation: bool = False) -> Dict[str, metrics.RankStats]:
        """The test split, with train + valid as its history."""
        ent_f = build_answer_filters_by_time(self.data.test, self.num_rels, False)
        rel_f = build_answer_filters_by_time(self.data.test, self.num_rels, True)
        return self.evaluate(state, self.train_list + self.valid_list, self.test_list, ent_f,
                             rel_f, time_offset=len(self.train_list) + len(self.valid_list),
                             cache_key="test", multi_step=multi_step, topk=topk,
                             relation_evaluation=relation_evaluation)

    # ------------------------------------------------------------- analysis
    def analysis_record(self, state: TrainState) -> Dict[str, float]:
        """The ``run_analysis`` sample of an epoch (ref:hisres_main.py:255):
        the gradient norms of the training loss on the first full window,
        with the entity embeddings' row-norm statistics. Its dropouts draw
        from a generator seeded 0, as JAX's from a fixed key, and leave the
        state's generator alone."""
        hlen = self.tc.train_history_len
        i = min(max(hlen, 1), len(self.train_list) - 1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        total, _, _ = self.loss(dataclasses.replace(state, gen=gen), *self.window(i))
        grads = torch.autograd.grad(total, tree_leaves(state.params), allow_unused=True)
        rec = gradient_stats(state.params, grads)
        rec.update(embedding_stats(state.params["dynamic_emb"], "entity"))
        return rec

    # ------------------------------------------------------------------- fit
    def fit(self, state: Optional[TrainState] = None, checkpoint_path: Optional[str] = None,
            resume: bool = False, selection_metric: str = "ent_raw"
            ) -> Tuple[TrainState, Dict]:
        """``tc.n_epochs`` epochs, the valid split evaluated after each; the
        best state by ``selection_metric`` ("ent_raw" or "rel_raw") is kept
        as a copy and, with ``checkpoint_path``, saved at the root of it on
        each improvement, while ``<path>/last`` takes the state after every
        epoch. ``resume=True`` continues from the checkpoint there, if any.
        Returns (best state, info) with ``best_valid_mrr_raw``,
        ``selection_metric`` and ``history``, a row per epoch."""
        tc = self.tc
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
        best_state = train_state.copy_state(state)
        rows = []
        for epoch in range(start_epoch, tc.n_epochs):
            t0 = time.perf_counter()
            losses = self.run_epoch(state, epoch)
            dt = time.perf_counter() - t0
            stats = self.evaluate(state, self.train_list, self.valid_list, ent_f, rel_f,
                                  time_offset=len(self.train_list), cache_key="valid")
            mrr = stats[selection_metric].mrr
            row = {"epoch": epoch, "losses": losses, "valid_mrr_raw": stats["ent_raw"].mrr,
                   "epoch_time_s": dt}
            log.info("epoch %03d | e/r/s %.4f/%.4f/%.4f | %s MRR %.4f | %.1fs", epoch,
                     losses["entity"], losses["relation"], losses["static"], selection_metric,
                     mrr, dt)
            if self.run_analysis:
                row["analysis"] = rec = self.analysis_record(state)
                log.info("analysis %03d | grad global %.4e | ent norm %.3f±%.3f", epoch,
                         rec["global_norm"], rec["entity_norm_mean"], rec["entity_norm_std"])
            rows.append(row)
            if mrr > best_mrr:
                best_mrr, best_epoch = mrr, epoch
                best_state = train_state.copy_state(state)
                if checkpoint_path:
                    train_state.save_checkpoint(checkpoint_path, state,
                                                {"epoch": epoch, "mrr": mrr}, shard=self.shard)
            if checkpoint_path:
                train_state.save_last_checkpoint(checkpoint_path, state, epoch, best_mrr,
                                                 best_epoch, shard=self.shard)
        return best_state, {"best_valid_mrr_raw": best_mrr, "selection_metric": selection_metric,
                            "history": rows}
