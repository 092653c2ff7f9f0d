"""Vectorized hyperparameter sweep: K configurations trained as one program.

Counterpart of ``regcn_tpu/train/sweep.py``. The numeric knobs that do not
change a tensor's shape (learning rate, task weight, seed) sweep over a
model axis: ``torch.func.vmap`` over ``torch.func.grad_and_value`` of one
model's loss trains K models in the launches of one, the window's graph
shared between them (no batch axis) and the parameters, the decoders' BN
statistics, the task weight and the dropout draws batched. The kernels
take the model axis through their ``vmap`` rules: B1 folds it into its
feature axis (one launch on [E, K * d] for the K models), B2 launches once
per model.

- the learning rate rides in :class:`StackedAdam` as a [K] vector, the
  counterpart of ``optax.inject_hyperparams(adam)`` after
  ``clip_by_global_norm`` and ``add_decayed_weights``; the clip is per
  model, its norm summed in float64 as ``regcn_torch/train/optim.py``
  does;
- the task weight enters the loss as a batched 0-d tensor;
- each model's dropout draws come from its own generator, seeded
  ``seed + 1`` as a single model's trainer seeds its own, in the order and
  shapes a single model's step asks for them (listed once per window
  shape by a run on the ``meta`` device), so model k draws exactly what the
  sequential trainer with its seed draws. JAX's per-model streams depend
  on the model's seed alone in the same way.

The sweep trains in fp32 whatever the config's compute dtype says: JAX's
sweep casts neither the parameters nor the windows, so its bf16 policy
never starts there (its islands are no-ops on fp32 inputs).

Shape-changing knobs (n_hidden, n_layers, dropout rates, n_bases) sweep
sequentially (``regcn_torch/cli.py``'s grid).

On a mesh (``SweepRunner(mesh=...)``, JAX's model axis sharded over the
``data`` mesh axis and replicated over ``graph``) the rank at position r
of a ``data`` axis of size D trains models ``[r K / D, (r + 1) K / D)``:
their learning rates, task weights, seeds, parameters, Adam moments and
dropout generators, each generator seeded as in one process. The models
are independent, so nothing crosses the ``data`` axis within a step. The
ranks of one ``graph`` group hold the same models; JAX's replicas there
are one program with one result, while the port's are processes whose
atomic sums on the card add in no fixed order, so every value a step
carries forward (the gradients, the BatchNorm statistics, the losses)
and the evaluation's ranks are taken from the group's first rank, one
broadcast each, and the replicas stay bit-equal (as a trainer's ``data``
replicas do, ``regcn_torch/parallel/collectives.py``). The
epoch's mean losses and the evaluation's ranks are all-gathered over the
``data`` group, so every rank reports all K models in combo order.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from regcn_torch.config import ModelConfig, TrainConfig
from regcn_torch.data.answers import build_answer_filters_by_time
from regcn_torch.data.snapshots import build_history, pad_triples, split_by_time
from regcn_torch.hyperbolic import model as hmodel
from regcn_torch.hyperbolic.train import compute_radius_targets
from regcn_torch.models import recurrent
from regcn_torch.ops.activations import DropoutDraws
from regcn_torch.ops.rgcn_scatter import check_impl, shape_run
from regcn_torch.parallel.collectives import (all_gather_rows, from_first_rank,
                                               tensors_from_first_rank)
from regcn_torch.parallel.mesh import (DATA_AXIS, GRAPH_AXIS, axis_size, check_model_divisibility,
                                       data_group, data_rank, graph_group)
from regcn_torch.train import metrics
from regcn_torch.train.loop import RANK_KEYS, train_window
from regcn_torch.train.optim import AdamState, EuclideanAdam, tree_leaves, tree_map
from regcn_torch.train.state import fields_of

VECTORIZABLE = ("lr", "task_weight", "seed")


def expand_combos(combos: Dict[str, Sequence], tc: TrainConfig
                  ) -> Tuple[List[float], List[float], List[int]]:
    """(lrs, task weights, seeds), one per model, as JAX expands them: a
    knob left out takes the config's value; a shorter list repeats its
    last entry."""
    unknown = set(combos) - set(VECTORIZABLE)
    if unknown:
        raise ValueError(f"not vectorizable (shape-changing): {sorted(unknown)}")
    n = max(len(v) for v in combos.values())
    lrs = list(combos.get("lr", [tc.lr] * n))
    tws = list(combos.get("task_weight", [tc.task_weight] * n))
    seeds = list(combos.get("seed", [tc.seed] * n))
    n = max(len(lrs), len(tws), len(seeds))
    for lst in (lrs, tws, seeds):
        lst.extend([lst[-1]] * (n - len(lst)))
    return lrs, tws, seeds


def stack_trees(trees: Sequence) -> object:
    """One tree whose leaves stack the given trees' leaves on a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [stack_trees([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack([t.detach() for t in trees])


def model_slice(tree, k: int):
    """Model ``k``'s tree of a stacked tree."""
    return tree_map(lambda t: t[k], tree)


class StackedAdam(EuclideanAdam):
    """clip_by_global_norm -> add_decayed_weights -> Adam on stacked leaves
    [K, ...], in place: :class:`EuclideanAdam`'s steps with each model's
    own clip and a [K] learning rate ``lrs``."""

    def __init__(self, lrs: torch.Tensor, grad_norm: float = 1.0, weight_decay: float = 1e-5):
        super().__init__(0.0, grad_norm, weight_decay)
        self.lrs = lrs

    def _per_model(self, v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return v.reshape((-1,) + (1,) * (like.dim() - 1))

    def clipped(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
        """Each model's gradients clipped by their own global norm, summed in
        float64 as the single-model clip sums it."""
        k = self.lrs.shape[0]
        norms = torch.stack([torch.linalg.vector_norm(g.reshape(k, -1), dim=1,
                                                      dtype=torch.float64) for g in grads])
        g_norm = torch.linalg.vector_norm(norms, dim=0)
        factor = torch.where(g_norm < self.grad_norm, torch.ones_like(g_norm),
                             self.grad_norm / g_norm).float()
        return [g * self._per_model(factor, g) for g in grads]

    def apply_update(self, params: List[torch.Tensor], update: List[torch.Tensor]) -> None:
        for p, u in zip(params, update):
            p.sub_(u * self._per_model(self.lrs, u))


@dataclasses.dataclass
class SweepState:
    """K models' training state: parameters and model state (a dict of the
    model-state dataclass's fields) stacked on axis 0, the stacked Adam
    moments, one dropout generator per model and the step. On a mesh it
    holds the rank's own K / D models."""

    params: dict
    opt_state: AdamState
    model_state: dict
    gens: List[torch.Generator]
    step: int = 0


class _Sweep:
    """What both runners share: the combos, the windows, the vmapped step,
    the epoch order and the vmapped rolling evaluation of the valid split.
    ``lrs``, ``tws``, ``seeds`` and ``n_models`` are every model's; ``own``
    is the range of those this rank trains (all of them without a mesh);
    ``replicas`` the mesh's ``graph`` group, whose ranks hold the same
    models, where that axis is above 1."""

    loss_keys: Tuple[str, ...] = ()
    model_state_type: type = object  # the model's state dataclass

    def __init__(self, cfg, tc: TrainConfig, data, combos: Dict[str, Sequence], device,
                 mesh=None):
        self.cfg, self.tc, self.data = cfg, tc, data
        self.device = torch.device(device)
        self.lrs, self.tws, self.seeds = expand_combos(combos, tc)
        self.n_models = len(self.lrs)
        self.group = self.replicas = None  # the mesh's data and graph groups
        self.own = range(self.n_models)
        if mesh is not None:
            d = axis_size(mesh, DATA_AXIS)
            check_model_divisibility(self.n_models, d)
            per = self.n_models // d
            self.own = range(data_rank(mesh) * per, (data_rank(mesh) + 1) * per)
            self.group = data_group(mesh) if d > 1 else None
            self.replicas = graph_group(mesh) if axis_size(mesh, GRAPH_AXIS) > 1 else None
        self.train_list = split_by_time(data.train)
        self.valid_list = split_by_time(data.valid)
        own = slice(self.own.start, self.own.stop)
        self.opt = StackedAdam(torch.tensor(self.lrs[own], dtype=torch.float32,
                                            device=self.device),
                               tc.grad_norm, tc.weight_decay)
        self.task_weights = torch.tensor(self.tws[own], dtype=torch.float32, device=self.device)
        self._windows: Dict[int, tuple] = {}
        self._draw_shapes: Dict[tuple, list] = {}

    # ------------------------------------------------------------ model hooks
    def init_model(self, seed: int) -> Tuple[dict, object]:
        """(params, model state) of one model from ``seed``, on the device."""
        raise NotImplementedError

    def model_loss(self, params, model_state, history, triples, mask, gen):
        """(losses dict, new model state) of one model's training step."""
        raise NotImplementedError

    def model_predict(self, params, model_state, history, triples):
        """(entity [B, N], relation [B, 2R]) eval-mode scores of one model."""
        raise NotImplementedError

    # ------------------------------------------------------------------ state
    def own_seeds(self) -> List[int]:
        return [self.seeds[k] for k in self.own]

    def init_state(self) -> SweepState:
        """Each of the rank's models from its seed, stacked; dropout
        generators seeded ``seed + 1``, on the device."""
        models = [self.init_model(s) for s in self.own_seeds()]
        return self.state_from(stack_trees([p for p, _ in models]),
                               stack_trees([fields_of(m) for _, m in models]))

    def state_from(self, params: dict, model_state: dict) -> SweepState:
        """A fresh state (zero moments, step 0) around stacked ``params`` and
        ``model_state`` (a dict of the model-state fields) of the rank's own
        models, copied onto the device."""
        params = tree_map(lambda t: t.detach().to(self.device, copy=True), params)
        model_state = tree_map(lambda t: t.detach().to(self.device, copy=True), model_state)
        gens = []
        for s in self.own_seeds():
            g = torch.Generator(device=self.device)
            g.manual_seed(int(s) + 1)
            gens.append(g)
        return SweepState(params=params, opt_state=self.opt.init(tree_leaves(params)),
                          model_state=model_state, gens=gens)

    # ------------------------------------------------------------------ train
    def window(self, i: int) -> tuple:
        """(history, triples, mask) of training snapshot ``i``, built once."""
        if i not in self._windows:
            self._windows[i] = train_window(self.train_list, i, self.data.num_nodes,
                                            self.data.num_rels, self.tc, self.device)
        return self._windows[i]

    def _dropout_rates(self) -> Tuple[float, ...]:
        c = self.cfg
        return (c.dropout, c.input_dropout, c.hidden_dropout, c.feat_dropout)

    def draw_shapes(self, state: SweepState, i: int) -> list:
        """The shapes of the dropout draws of one model's step on window
        ``i``, in order: a run of the step's forward on the ``meta`` device
        (shapes only, nothing launched). They follow from the window's
        shapes alone (the meta run reads no values), so one run serves
        every window of the same shapes."""
        history, triples, mask = self.window(i)
        # [T, E], [T, N] and [T, pairs]: every field of the window has one of these
        key = tuple(tuple(t.shape) for t in (history.src, history.in_deg_norm, history.rc_rel,
                                              triples))
        if key not in self._draw_shapes:
            shapes = []
            if any(r > 0 for r in self._dropout_rates()):
                meta = lambda t: t.detach().to("meta")  # noqa: E731
                rec = DropoutDraws()
                with torch.no_grad(), shape_run():
                    self.model_loss(tree_map(meta, model_slice(state.params, 0)),
                                    self.model_state_type(**tree_map(
                                        meta, model_slice(state.model_state, 0))),
                                    history.to("meta"), triples.to("meta"), mask.to("meta"),
                                    rec)
                shapes = rec.shapes
            self._draw_shapes[key] = shapes
        return self._draw_shapes[key]

    def draws(self, state: SweepState, i: int) -> List[torch.Tensor]:
        """Each model's dropout draws of window ``i`` from its own
        generator, stacked to [K, *shape] per draw."""
        return [torch.stack([torch.rand(shape, generator=g, device=self.device)
                             for g in state.gens])
                for shape in self.draw_shapes(state, i)]

    def grad_step(self, state: SweepState, i: int) -> Tuple[Dict[str, torch.Tensor], list, dict]:
        """Every model's forward and backward on training snapshot ``i``
        without the optimizer: (losses, each [K]; the gradients in
        ``tree_leaves`` order, each [K, ...]; the new model state, stacked).
        Draws each model's dropout from its generator. On a mesh whose
        ``graph`` axis is above 1, all three are the group's first rank's."""
        history, triples, mask = self.window(i)
        mtype = self.model_state_type

        def loss(params, model_state, draws, tw):
            losses, new_state = self.model_loss(params, mtype(**model_state), history, triples,
                                                mask, DropoutDraws(draws))
            total = tw * losses["entity"] + (1.0 - tw) * losses["relation"] + sum(
                losses[k] for k in self.loss_keys if k not in ("entity", "relation"))
            return total, (losses, fields_of(new_state))

        grads, (_, (losses, new_state)) = vmap(grad_and_value(loss, has_aux=True))(
            state.params, state.model_state, self.draws(state, i), self.task_weights)
        losses = {k: v.detach() for k, v in losses.items()}
        grads, new_state = tree_leaves(grads), tree_map(torch.Tensor.detach, new_state)
        if self.replicas is not None:  # the graph group's first rank's, one broadcast
            n_g, n_s = len(grads), len(tree_leaves(new_state))
            flat = tensors_from_first_rank(grads + tree_leaves(new_state) + list(losses.values()),
                                           self.replicas)
            grads, state_leaves = flat[:n_g], iter(flat[n_g:n_g + n_s])
            new_state = tree_map(lambda _: next(state_leaves), new_state)
            losses = dict(zip(losses, flat[n_g + n_s:]))
        return losses, grads, new_state

    def train_step(self, state: SweepState, i: int) -> Dict[str, torch.Tensor]:
        """One optimizer step of every model on training snapshot ``i``, in
        place on ``state``; returns the losses, each [K] (not synchronised)."""
        losses, grads, state.model_state = self.grad_step(state, i)
        self.opt.step(tree_leaves(state.params), grads, state.opt_state)
        state.step += 1
        return losses

    def epoch_order(self, epoch: int) -> List[int]:
        """The training snapshots of an epoch, in the JAX sweep's order."""
        idx = list(range(1, len(self.train_list)))
        random.Random(self.tc.seed + epoch).shuffle(idx)
        return idx

    def gathered(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [k, ...] of the rank's own models as [K, ...] of every
        model, in combo order: all-gathered over the mesh's data group."""
        return x if self.group is None else all_gather_rows(x, self.group)

    def run_epoch(self, state: SweepState, epoch: int) -> Dict[str, np.ndarray]:
        """One step of each of the rank's models per training snapshot; the
        mean losses of every model, each [K] (one host sync)."""
        order = self.epoch_order(epoch)
        sums = torch.zeros((len(self.own), len(self.loss_keys)), device=self.device)
        for i in order:
            losses = self.train_step(state, i)
            sums += torch.stack([losses[k] for k in self.loss_keys], dim=1)
        means = self.gathered(sums / max(len(order), 1)).T.cpu().numpy()
        return dict(zip(self.loss_keys, means))

    # ------------------------------------------------------------------- eval
    @torch.no_grad()
    def evaluate(self, state: SweepState, history_list: Sequence[np.ndarray],
                 eval_list: Sequence[np.ndarray], ent_filters=None, rel_filters=None
                 ) -> List[Dict[str, metrics.RankStats]]:
        """Rolling-window evaluation of every model (``loop.rolling_ranks``
        with the scores of the rank's models from one vmapped forward, their
        ranks the ``graph`` group's first rank's and gathered over the
        mesh's data group); per model of all K, ``RANK_KEYS`` -> RankStats."""
        tc, num_rels = self.tc, self.data.num_rels
        mtype = self.model_state_type
        window = list(history_list[-tc.test_history_len:])
        ranks = [{k: [] for k in RANK_KEYS} for _ in range(self.n_models)]
        for t, snap in enumerate(eval_list):
            history = build_history(window, self.data.num_nodes, num_rels,
                                    edge_bucket=tc.edge_bucket,
                                    rc_bucket=tc.rc_bucket).to(self.device)
            triples, mask = pad_triples(snap, num_rels, tc.triple_bucket)
            er, ec = metrics.filter_coo_padded(
                ent_filters[t] if ent_filters else None, triples[:, [0, 1]], triples[:, 2])
            rr, rc = metrics.filter_coo_padded(
                rel_filters[t] if rel_filters else None, triples[:, [0, 2]], triples[:, 1])
            er, ec, rr, rc = (torch.from_numpy(a).to(self.device) for a in (er, ec, rr, rc))
            trip = torch.from_numpy(triples).long().to(self.device)
            s_ob, s_rel = vmap(lambda p, ms: self.model_predict(p, mtype(**ms), history, trip))(
                state.params, state.model_state)
            step = torch.stack([torch.stack([
                metrics.device_ranks(s_ob[k], trip[:, 2]),
                metrics.device_filtered_ranks(s_ob[k], trip[:, 2], er, ec),
                metrics.device_ranks(s_rel[k], trip[:, 1]),
                metrics.device_filtered_ranks(s_rel[k], trip[:, 1], rr, rc),
            ]) for k in range(len(self.own))])
            if self.replicas is not None:
                step = from_first_rank(step, self.replicas)
            step = self.gathered(step).cpu().numpy()
            valid = mask > 0
            for k in range(self.n_models):
                for key, row in zip(RANK_KEYS, step[k]):
                    ranks[k][key].append(row[valid])
            window = (window + [snap])[-tc.test_history_len:]
        return [{key: metrics.stat_ranks(v) for key, v in r.items()} for r in ranks]

    def run(self, n_epochs: Optional[int] = None, state: Optional[SweepState] = None):
        """Train every model ``n_epochs`` (default ``tc.n_epochs``) epochs,
        then evaluate each on the valid split; returns (rows, state), a row
        per model with its lr, task weight, seed, ``valid_ent_mrr_raw`` and
        ``stats``, as JAX's runner gives them. On a mesh every rank returns
        the rows of all K models, in combo order, and its own state: that of
        its K / D models."""
        state = state or self.init_state()
        for epoch in range(n_epochs or self.tc.n_epochs):
            self.run_epoch(state, epoch)
        ent_f = build_answer_filters_by_time(self.data.valid, self.data.num_rels, False)
        rel_f = build_answer_filters_by_time(self.data.valid, self.data.num_rels, True)
        stats = self.evaluate(state, self.train_list, self.valid_list, ent_f, rel_f)
        rows = [{"lr": float(self.lrs[k]), "task_weight": float(self.tws[k]),
                 "seed": int(self.seeds[k]), "valid_ent_mrr_raw": stats[k]["ent_raw"].mrr,
                 "stats": stats[k]} for k in range(self.n_models)]
        return rows, state


class SweepRunner(_Sweep):
    """A vectorized (lr, task_weight, seed) sweep of RE-GCN.

    As in JAX's runner the training snapshots are not dilated and the
    static graph is not used (a ``use_static`` model gets a static loss of
    0). ``impl`` is "xla" or "pallas" (both take kernel B1). ``mesh`` (from
    ``regcn_torch.parallel.mesh.make_mesh``) splits the models over its
    ``data`` axis, whose size must divide K, as JAX's ``mesh`` shards them
    (see the module)."""

    loss_keys = ("entity", "relation", "static")
    model_state_type = recurrent.ModelState

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, data, combos: Dict[str, Sequence],
                 impl: str = "xla", mesh=None, device="cuda"):
        check_impl(impl)
        recurrent.check_supported(cfg)
        super().__init__(cfg, tc, data, combos, device, mesh)

    def init_model(self, seed: int):
        return recurrent.init_params(torch.Generator().manual_seed(int(seed)), self.cfg,
                                     device=self.device)

    def model_loss(self, params, model_state, history, triples, mask, gen):
        _, losses, new_state = recurrent.get_loss(params, model_state, self.cfg, history,
                                                  triples, mask, gen=gen, train=True)
        return losses, new_state

    def model_predict(self, params, model_state, history, triples):
        return recurrent.predict(params, model_state, self.cfg, history, triples)


class HyperbolicSweepRunner(_Sweep):
    """A vectorized (lr, task_weight, seed) sweep of the hyperbolic model:
    the configurations with the Euclidean optimizer and without EST, as in
    JAX (``manifold_entities`` needs per-model Riemannian state and
    ``use_est`` per-model memories; both raise). The loss adds the radius
    term; a distance decoder runs B2 once per model, the uvrgcn's B1 folds
    the models with each one's radius weight multiplied in."""

    loss_keys = ("entity", "relation", "static", "radius")
    model_state_type = hmodel.HypModelState

    def __init__(self, cfg, tc: TrainConfig, data, combos: Dict[str, Sequence], device="cuda"):
        if cfg.manifold_entities or cfg.use_est:
            raise ValueError("vectorized sweep supports the Euclidean-optimizer, non-EST "
                             "hyperbolic configurations")
        hmodel.check_supported(cfg)
        hmodel.check_device(cfg, device)
        # fp32 whatever the config's compute dtype: JAX's sweep casts nothing
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        super().__init__(cfg, tc, data, combos, device)
        self.radius_target = compute_radius_targets(
            self.train_list, data.num_nodes, alpha=cfg.radius_alpha, beta=cfg.radius_beta,
            radius_min=cfg.radius_min, radius_max=cfg.radius_max)

    def init_model(self, seed: int):
        params, model_state = hmodel.init_params(
            torch.Generator().manual_seed(int(seed)), self.cfg, self.radius_target, device="cpu")
        return (tree_map(lambda t: t.to(self.device), params),
                hmodel.HypModelState(**tree_map(lambda t: t.to(self.device),
                                                fields_of(model_state))))

    def model_loss(self, params, model_state, history, triples, mask, gen):
        _, losses, new_state, _ = hmodel.get_loss(params, model_state, self.cfg, history,
                                                  triples, mask, gen=gen, train=True)
        return losses, new_state

    def model_predict(self, params, model_state, history, triples):
        return hmodel.predict(params, model_state, self.cfg, history, triples)

