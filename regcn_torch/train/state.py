"""Train state and checkpointing.

Counterpart of ``regcn_tpu/train/state.py``. The train state holds the
parameters (leaf tensors that require grad, updated in place), the
optimizer's moments, the decoders' BatchNorm running statistics, the
dropout generator, the step and, for a hyperbolic model with EST, the
H-PES memories; a checkpoint holds all of it, so training resumes exactly
where it stopped.

Layout, as in the JAX package: ``<path>/state.pt`` (``torch.save`` of
the state) and ``<path>/meta.json``; ``fit`` keeps the best state at the
root and the last epoch's under ``<path>/last/``. Each file is written
beside its final name and moved into place with ``os.replace``, and
``meta.json`` only after ``state.pt`` is complete, so a crash never
leaves a ``meta.json`` without its state: at worst the state is one save
ahead of a stale ``meta.json``, and resume re-runs one epoch. Saves are
synchronous. Orbax checkpoints of the JAX package are not read.

On an entity-sharded mesh (``shard``, this rank's
``regcn_torch.parallel.collectives.RowShard``) a checkpoint keeps the
unsharded format: every rank gathers the whole state and rank 0 writes it;
a restore reads the whole state and keeps the rank's rows. So a sharded
run resumes from an unsharded checkpoint and the other way round, as JAX
restores, then shards.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from regcn_torch.config import ModelConfig, TrainConfig
from regcn_torch.models import recurrent
from regcn_torch.train.optim import AdamState, EuclideanAdam, tree_leaves, tree_map

STATE_FILE, META_FILE = "state.pt", "meta.json"


@dataclasses.dataclass
class TrainState:
    """The state of both trainers: RE-GCN's (``model_state`` a
    ``recurrent.ModelState``) and the hyperbolic one's (a
    ``hyperbolic.model.HypModelState``, and with EST an ``est_state``, the
    ``hyperbolic.est.ESTState`` of JAX's ``HypTrainState``)."""

    params: Dict[str, Any]
    opt_state: AdamState
    model_state: Any  # a dataclass of tensor trees: BN running statistics and buffers
    gen: torch.Generator  # the dropout generator, on the parameters' device
    step: int = 0
    est_state: Any = None  # a dataclass of tensors, or None


def make_optimizer(tc: TrainConfig) -> EuclideanAdam:
    """clip-by-global-norm, then coupled weight decay, then Adam, with
    optax's semantics (``regcn_torch/train/optim.py``)."""
    return EuclideanAdam(tc.lr, tc.grad_norm, tc.weight_decay)


def fields_of(obj) -> Dict[str, Any]:
    """A dataclass's fields as a dict, the values as they are (not copied)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def state_from(params, model_state, tc: TrainConfig, seed: int, device="cuda") -> TrainState:
    """A fresh state (zero Adam moments, step 0) around copies of
    ``params`` and ``model_state`` on ``device``; the dropout generator is
    seeded with ``seed``."""
    params = tree_map(lambda t: t.detach().to(device, copy=True).requires_grad_(True), params)
    model_state = type(model_state)(**{k: recurrent.tree_to(v, device)
                                       for k, v in fields_of(model_state).items()})
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrainState(params=params, opt_state=make_optimizer(tc).init(tree_leaves(params)),
                      model_state=model_state, gen=gen)


def create_train_state(seed: int, cfg: ModelConfig, tc: TrainConfig, device="cuda") -> TrainState:
    """Random parameters from ``torch.Generator().manual_seed(seed)`` on
    the CPU, moved to ``device``; dropout draws from ``seed + 1``."""
    params, model_state = recurrent.init_params(torch.Generator().manual_seed(seed), cfg,
                                                device="cpu")
    return state_from(params, model_state, tc, seed + 1, device)


def copy_state(state: TrainState) -> TrainState:
    """A deep copy of a train state whose tensors and generator share
    nothing with ``state`` (the best state of ``fit`` is kept so)."""
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(state.gen.get_state())
    with torch.no_grad():
        return dataclasses.replace(
            state, params=copy.deepcopy(state.params), opt_state=copy.deepcopy(state.opt_state),
            model_state=copy.deepcopy(state.model_state), gen=gen,
            est_state=copy.deepcopy(state.est_state))


def _write(path: str, write) -> None:
    """``write(tmp)`` then ``os.replace(tmp, path)``."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, meta: Optional[Dict[str, Any]] = None,
                    shard=None) -> None:
    """The whole train state to ``<path>/state.pt``, then ``meta`` to
    ``<path>/meta.json``; with ``shard``, gathered over the ranks (a
    collective) and written by rank 0, the other ranks waiting for it."""
    if shard is not None:
        from regcn_torch.parallel.sharding import unshard_state

        whole = unshard_state(state, shard)
        if shard.rank == 0:
            save_checkpoint(path, whole, meta)
        dist.barrier(group=shard.group)
        return
    os.makedirs(path, exist_ok=True)
    blob = {
        "params": tree_map(torch.Tensor.detach, state.params),
        "opt_state": {"count": state.opt_state.count, "mu": state.opt_state.mu,
                      "nu": state.opt_state.nu, "manifold": state.opt_state.manifold},
        "model_state": fields_of(state.model_state),
        "gen": state.gen.get_state(),
        "step": state.step,
        "est_state": None if state.est_state is None else fields_of(state.est_state),
    }
    _write(os.path.join(path, STATE_FILE), lambda f: torch.save(blob, f))

    def dump(f):
        with open(f, "w") as fh:
            json.dump(meta or {}, fh)

    _write(os.path.join(path, META_FILE), dump)


def restore_checkpoint(path: str, template: TrainState, shard=None
                       ) -> Tuple[TrainState, Dict[str, Any]]:
    """(state, meta) from ``path``, on the device of ``template``'s
    parameters; the checkpoint must hold a tree of the same shapes (with
    ``shard``, of the whole state, of which this rank keeps its rows)."""
    device = tree_leaves(template.params)[0].device
    blob = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    got, want = tree_leaves(blob["params"]), [t.shape for t in tree_leaves(template.params)]
    if shard is not None:
        from regcn_torch.parallel.sharding import param_sharding_rules

        want = [(shard.size * w[0],) + tuple(w[1:]) if s else w
                for w, s in zip(want, param_sharding_rules(template.params))]
    if [t.shape for t in got] != [torch.Size(w) for w in want]:
        raise ValueError(f"checkpoint {path} holds parameters of other shapes than the model's")
    if (blob.get("est_state") is None) != (template.est_state is None):
        raise ValueError(f"checkpoint {path} and the model differ in holding an EST state")
    gen = torch.Generator(device=device)
    gen.set_state(blob["gen"].cpu())
    opt = blob["opt_state"]
    state = TrainState(
        params=tree_map(lambda t: t.requires_grad_(True), blob["params"]),
        opt_state=AdamState(count=int(opt["count"]), mu=opt["mu"], nu=opt["nu"],
                            manifold=opt.get("manifold")),
        model_state=type(template.model_state)(**blob["model_state"]),
        gen=gen, step=int(blob["step"]),
        est_state=(None if template.est_state is None
                   else type(template.est_state)(**blob["est_state"])))
    meta = {}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if shard is not None:
        from regcn_torch.parallel.sharding import shard_state

        state = shard_state(state, shard)
    return state, meta


def save_last_checkpoint(path: str, state: TrainState, epoch: int, best_mrr: float,
                         best_epoch: int, shard=None) -> None:
    """The state at the last completed epoch under ``<path>/last``: the
    root holds the best state, saved only on improvement, so resuming
    from it alone would re-run (and re-randomise) every epoch after it."""
    save_checkpoint(os.path.join(path, "last"), state,
                    {"epoch": int(epoch), "best_mrr": float(best_mrr),
                     "best_epoch": int(best_epoch)}, shard=shard)


def restore_for_resume(path: str, template: TrainState, shard=None):
    """(state, start_epoch, best_mrr, best_epoch) for ``fit(resume=True)``,
    from ``<path>/last`` where it is complete, else from the best state at
    the root (where last == best)."""
    last = os.path.join(path, "last")
    if _complete_checkpoint(last):
        state, meta = restore_checkpoint(last, template, shard)
        return (state, int(meta["epoch"]) + 1, float(meta.get("best_mrr", 0.0)),
                int(meta.get("best_epoch", -1)))
    state, meta = restore_checkpoint(path, template, shard)
    epoch = int(meta.get("epoch", -1))
    return state, epoch + 1, float(meta.get("mrr", 0.0)), epoch


def _complete_checkpoint(path: str) -> bool:
    """meta.json and state.pt: both are moved into place complete, the
    meta last."""
    return (os.path.exists(os.path.join(path, META_FILE))
            and os.path.exists(os.path.join(path, STATE_FILE)))


def has_resumable_checkpoint(path) -> bool:
    return bool(path) and (_complete_checkpoint(path)
                           or _complete_checkpoint(os.path.join(path, "last")))
