"""Hyperbolic training: the trainer of the hyperbolic slice.

Counterpart of ``regcn_tpu/hyperbolic/train.py`` for the configurations
this package runs (LGCN + RotH, fixed or learned curvature with its
warmup, radius supervision): degree/frequency radius targets, one
optimizer step per training snapshot in the JAX trainer's shuffled
order, rolling-window raw and filtered evaluation, and ``fit`` with
patience and the best state kept.

The JAX trainer runs an epoch as one fused ``lax.scan`` over a store
front-padded with empty snapshots; here a Python loop takes the same
steps in the same order. A window shorter than the history length is
run as it is: the fused path's empty front snapshots are identity steps,
so both give the same result.

Not ported yet, and raising: triple mini-batching (``triple_batch_size``),
EST and TANS, the static graph, meshes and the boundary halo.
"""

from __future__ import annotations

import copy
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
from regcn_torch.data.snapshots import build_history, pad_triples, split_by_time
from regcn_torch.hyperbolic import model as hmodel
from regcn_torch.hyperbolic.model import HyperbolicConfig, HypModelState
from regcn_torch.hyperbolic.optim import AdamState, dual_optimizer
from regcn_torch.train import loop, metrics

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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass
class HypTrainState:
    """Parameters (leaf tensors that require grad, updated in place), the
    optimizer state, the model state, the dropout generator and the step."""

    params: Dict
    opt_state: AdamState
    model_state: HypModelState
    gen: torch.Generator
    step: int = 0


class HyperbolicTrainer:
    def __init__(self, cfg: HyperbolicConfig, tc: TrainConfig, data: TKGData, *,
                 curvature_warmup_epochs: int = 0, triple_batch_size: Optional[int] = None,
                 device="cuda"):
        hmodel.check_supported(cfg)
        if triple_batch_size:
            raise NotImplementedError("triple_batch_size (snapshot-inner mini-batching) is "
                                      "not ported yet")
        if tc.dilate_len > 1:
            raise NotImplementedError("dilated training snapshots (dilate_len > 1) are not "
                                      "ported yet")
        self.cfg, self.tc, self.data = cfg, tc, data
        self.device = torch.device(device)
        self.curvature_warmup_epochs = curvature_warmup_epochs
        self.num_rels, self.num_nodes = data.num_rels, data.num_nodes
        self.train_list = split_by_time(data.train)
        self.valid_list = split_by_time(data.valid)
        self.test_list = split_by_time(data.test)
        self.radius_target = compute_radius_targets(
            self.train_list, data.num_nodes, alpha=cfg.radius_alpha, beta=cfg.radius_beta,
            radius_min=cfg.radius_min, radius_max=cfg.radius_max)
        self.opt = dual_optimizer(tc.lr, tc.grad_norm, tc.weight_decay, cfg.manifold_entities)
        self._windows: Dict = {}

    # ----------------------------------------------------------------- state
    def state_from(self, params, model_state: HypModelState, seed: Optional[int] = None
                   ) -> HypTrainState:
        """A fresh training state (zero Adam moments) around ``params``,
        copied onto the trainer's device."""
        params = _tree_map(lambda t: t.detach().to(self.device, copy=True).requires_grad_(True),
                           params)
        model_state = HypModelState(bn_ob={}, bn_rel={},
                                    radius_target=model_state.radius_target.to(self.device))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.tc.seed + 1 if seed is None else seed)
        return HypTrainState(params=params, opt_state=self.opt.init(tree_leaves(params)),
                             model_state=model_state, gen=gen)

    def init_state(self, seed: Optional[int] = None) -> HypTrainState:
        """Random parameters from ``torch.Generator().manual_seed(seed)``
        (default ``tc.seed``), radius_static seeded with the radius targets."""
        seed = self.tc.seed if seed is None else seed
        params, model_state = hmodel.init_params(
            torch.Generator().manual_seed(seed), self.cfg, self.radius_target, device="cpu")
        return self.state_from(params, model_state, seed + 1)

    # ------------------------------------------------------------------ data
    def window(self, i: int):
        """(history, triples, mask) on the device for training snapshot i:
        the window is ``train_list[max(0, i - hlen):i]``; built once."""
        if i not in self._windows:
            hlen = self.tc.train_history_len
            hist = build_history(self.train_list[max(0, i - hlen):i], self.num_nodes,
                                 self.num_rels, edge_bucket=self.tc.edge_bucket,
                                 rc_bucket=self.tc.rc_bucket)
            triples, mask = pad_triples(self.train_list[i], self.num_rels, self.tc.triple_bucket)
            self._windows[i] = (hist.to(self.device),
                                torch.from_numpy(triples).long().to(self.device),
                                torch.from_numpy(mask).to(self.device))
        return self._windows[i]

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
    def loss(self, state: HypTrainState, history, triples, mask, cmax
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, losses): total = tw * entity + (1 - tw) * relation +
        static + radius, with the dropouts of a training step."""
        losses = hmodel.get_loss(state.params, state.model_state, self.cfg, history, triples,
                                 mask, gen=state.gen, train=True, curvature_max=cmax)
        tw = self.tc.task_weight
        total = (tw * losses["entity"] + (1.0 - tw) * losses["relation"]
                 + losses["static"] + losses["radius"])
        return total, losses

    def train_step(self, state: HypTrainState, history, triples, mask, cmax
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step, in place on ``state``; returns the losses
        (0-d tensors on the device, not synchronised)."""
        total, losses = self.loss(state, history, triples, mask, cmax)
        leaves = tree_leaves(state.params)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        self.opt.step(leaves, grads, state.opt_state)
        state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    def epoch_order(self, epoch: int) -> List[int]:
        """The training snapshots of an epoch, in the JAX trainer's order."""
        idx = list(range(1, len(self.train_list)))
        random.Random(self.tc.seed + epoch).shuffle(idx)
        return idx

    def run_epoch(self, state: HypTrainState, epoch: int) -> Dict[str, float]:
        """One step per training snapshot; returns the mean losses."""
        cmax = self._curvature_max(epoch)
        order = self.epoch_order(epoch)
        sums = torch.zeros(len(LOSS_KEYS), device=self.device)
        for i in order:
            losses = self.train_step(state, *self.window(i), cmax)
            sums += torch.stack([losses[k] for k in LOSS_KEYS])
        means = (sums / max(len(order), 1)).tolist()  # one sync per epoch
        return dict(zip(LOSS_KEYS, means))

    # ------------------------------------------------------------------ eval
    def evaluate(self, state: HypTrainState, history_list: Sequence[np.ndarray],
                 eval_list: Sequence[np.ndarray], ent_filters=None, rel_filters=None
                 ) -> Dict[str, metrics.RankStats]:
        return loop.evaluate(state.params, state.model_state, self.cfg, self.tc, history_list,
                             eval_list, ent_filters, rel_filters, self.device, hmodel.predict)

    def test(self, state: HypTrainState) -> Dict[str, metrics.RankStats]:
        return loop.test(state.params, state.model_state, self.cfg, self.tc, self.data,
                         self.device, hmodel.predict)

    def fit(self, state: Optional[HypTrainState] = None, n_epochs: Optional[int] = None,
            patience: int = 20, selection_metric: str = "ent_raw"):
        """Training with early stopping on the validation split; returns
        (best state, info)."""
        if selection_metric not in ("ent_raw", "rel_raw"):
            raise ValueError(f"selection_metric must be 'ent_raw' or 'rel_raw', got "
                             f"{selection_metric!r}")
        state = state or self.init_state()
        ent_f = build_answer_filters_by_time(self.data.valid, self.num_rels, False)
        rel_f = build_answer_filters_by_time(self.data.valid, self.num_rels, True)
        best_state, best_mrr, best_epoch, bad_epochs = copy_state(state), 0.0, -1, 0
        rows = []
        for epoch in range(n_epochs or self.tc.n_epochs):
            t0 = time.perf_counter()
            losses = self.run_epoch(state, epoch)
            dt = time.perf_counter() - t0
            stats = self.evaluate(state, self.train_list, self.valid_list, ent_f, rel_f)
            mrr = stats[selection_metric].mrr
            rows.append({"epoch": epoch, "losses": losses, "valid_mrr_raw": stats["ent_raw"].mrr,
                         "epoch_time_s": dt})
            log.info("epoch %03d | e/r/s/rad %.4f/%.4f/%.4f/%.4f | %s MRR %.4f | %.1fs", epoch,
                     losses["entity"], losses["relation"], losses["static"], losses["radius"],
                     selection_metric, mrr, dt)
            if mrr > best_mrr:
                best_mrr, best_state, best_epoch, bad_epochs = mrr, copy_state(state), epoch, 0
            else:
                bad_epochs += 1
            if bad_epochs >= patience:
                log.info("early stop at epoch %d (patience %d)", epoch, patience)
                break
        return best_state, {"best_valid_mrr_raw": best_mrr, "best_epoch": best_epoch,
                            "selection_metric": selection_metric, "history": rows}


def copy_state(state: HypTrainState) -> HypTrainState:
    """A deep copy whose tensors share nothing with ``state``."""
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(state.gen.get_state())
    with torch.no_grad():
        return HypTrainState(
            params=copy.deepcopy(state.params), opt_state=copy.deepcopy(state.opt_state),
            model_state=copy.deepcopy(state.model_state), gen=gen, step=state.step)
