"""Parameter conversion from the JAX package.

:func:`params_from_jax` takes the pytree of ``regcn_tpu``'s
``models.recurrent.init_params`` (or of a trained state) with numpy
leaves and returns this package's parameters and BN running statistics.
The port keeps the JAX layouts, so the conversion is a copy:

- ``w_neighbor``, ``loop_w``, ``evolve_loop_w``, ``skip_w`` and
  ``time_gate_w`` are applied as ``x @ W`` in both packages;
- ``conv_w`` [C, 2, k] is torch's Conv1d layout and ``fc_w`` [d, C*d]
  torch's Linear layout, as in JAX;
- the GRU's ``w_ih`` / ``w_hh`` are [3H, in] with gate order r, z, n,
  torch's GRUCell layout, as in JAX.

:func:`hyperbolic_params_from_jax` does the same for the pytree of
``regcn_tpu.hyperbolic.model.init_params``: the nested ``rgcn.layers``
list (LGCN's or the uvrgcn's keys), the decoder dicts, the ConvTrans
decoders' BN trees and the 0-d leaves (``log_c``, ``score_margin``,
``score_scale_raw``) become tensors of the same shapes, and
``HypModelState.radius_target`` comes along; with EST the ``est`` subtree
(its 0-d gate leaves, the nested ``qchhe_gru`` or ``qchhe_transformer``)
converts the same way.

:func:`hisres_params_from_jax` does the same for the pytree of
``regcn_tpu.hisres.model.init_params`` and its ``HisResState``: the six
BN trees, the candidate cells' as lists of one per layer.

:func:`train_state_from_jax` takes a whole ``regcn_tpu`` ``TrainState``,
hyperbolic ``HypTrainState`` or ``HisResTrainState`` (numpy leaves): its
parameters and BN statistics as above, the Adam ``count``/``mu``/``nu`` of its optax chain,
its step and, from a ``HypTrainState`` with EST, its ``ESTState`` (the
H-PES ``fast`` and ``slow`` memories), so that a run can continue
mid-training in this package. The dual optimizer's state of
``manifold_entities`` (an optax ``multi_transform``: Riemannian Adam's
``count``/``mu``/``nu`` on the entity table, Adam's on the other leaves,
each with the other's leaves masked out) becomes one ``AdamState`` whose
``manifold`` marks the entity table.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from regcn_torch.hisres.model import HisResState
from regcn_torch.hyperbolic.est import ESTState
from regcn_torch.hyperbolic.model import HypModelState
from regcn_torch.models.recurrent import ModelState
from regcn_torch.train.optim import AdamState, tree_leaves
from regcn_torch.train.state import TrainState


def _tensor_tree(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tensor_tree(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def params_from_jax(
    params_np: Mapping[str, Any], model_state_np, device="cuda"
) -> Tuple[dict, ModelState]:
    """(params, ModelState) on ``device`` from the JAX parameter pytree and
    its ``ModelState`` (anything with ``bn_ob`` and ``bn_rel``)."""
    params = _tensor_tree(params_np, device)
    state = ModelState(
        bn_ob=_tensor_tree(model_state_np.bn_ob, device),
        bn_rel=_tensor_tree(model_state_np.bn_rel, device),
    )
    return params, state


def hyperbolic_params_from_jax(
    params_np: Mapping[str, Any], model_state_np, device="cuda"
) -> Tuple[dict, HypModelState]:
    """(params, HypModelState) on ``device`` from the hyperbolic JAX
    parameter pytree and its ``HypModelState``."""
    state = HypModelState(
        bn_ob=_tensor_tree(model_state_np.bn_ob, device),
        bn_rel=_tensor_tree(model_state_np.bn_rel, device),
        radius_target=_tensor_tree(model_state_np.radius_target, device),
    )
    return _tensor_tree(params_np, device), state


def hisres_params_from_jax(
    params_np: Mapping[str, Any], model_state_np, device="cuda"
) -> Tuple[dict, HisResState]:
    """(params, HisResState) on ``device`` from the HisRES JAX parameter
    pytree and its ``HisResState``."""
    state = HisResState(**{f.name: _tensor_tree(getattr(model_state_np, f.name), device)
                           for f in dataclasses.fields(HisResState)})
    return _tensor_tree(params_np, device), state


def _adam_states(opt_state, label=None) -> list:
    """(label, member) for each member of a nested optax state that has
    Adam's ``count``, ``mu`` and ``nu``; the label is the
    ``multi_transform`` partition the member sits in, or None."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return [(label, opt_state)]
    if isinstance(opt_state, Mapping):
        return [f for k, v in opt_state.items() for f in _adam_states(v, k)]
    if isinstance(opt_state, (tuple, list)):
        return [f for sub in opt_state for f in _adam_states(sub, label)]
    return []


def _masked(leaf) -> bool:
    """optax's ``MaskedNode``: the leaf of a partition that another owns
    (an empty tuple)."""
    return isinstance(leaf, tuple) and not leaf


def _merge(trees):
    """The trees of several ``multi_transform`` partitions as one: each
    leaf from the tree that does not mask it."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _merge([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_merge([t[i] for t in trees]) for i in range(len(first))]
    return next(t for t in trees if not _masked(t))


def _like(tree, template):
    """``tree`` reordered as ``template``: the same keys, in its order
    (JAX may hand back a dict with its keys sorted)."""
    if isinstance(template, Mapping):
        return {k: _like(tree[k], v) for k, v in template.items()}
    if isinstance(template, list):
        return [_like(t, v) for t, v in zip(tree, template)]
    return tree


def train_state_from_jax(jax_state, device="cuda", seed: int = 0) -> TrainState:
    """A ``TrainState`` on ``device`` from a ``regcn_tpu`` ``TrainState``,
    ``HypTrainState`` (its model state has a ``radius_target``) or
    ``HisResTrainState`` (its model state has ``bn_cand_raw``) with numpy
    leaves (``jax.tree.map(np.asarray, state)``). The dropout generator,
    which JAX's PRNG key cannot seed alike, is seeded with ``seed``."""
    if hasattr(jax_state.model_state, "bn_cand_raw"):
        convert = hisres_params_from_jax
    elif hasattr(jax_state.model_state, "radius_target"):
        convert = hyperbolic_params_from_jax
    else:
        convert = params_from_jax
    params, model_state = convert(jax_state.params, jax_state.model_state, device)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    found = _adam_states(jax_state.opt_state)
    if not found:
        raise ValueError("the JAX optimizer state holds no Adam moments (count, mu, nu)")
    counts = {int(np.asarray(a.count)) for _, a in found}
    if len(counts) != 1:
        raise ValueError(f"the JAX optimizer's partitions are at different steps {counts}")
    moments = [tree_leaves(_like(_tensor_tree(_merge([getattr(a, m) for _, a in found]), device),
                                 params)) for m in ("mu", "nu")]
    manifold = None
    for label, a in found:
        if label == "manifold":
            manifold = [not _masked(x) for x in tree_leaves(_like(a.mu, params))]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    est = getattr(jax_state, "est_state", None)
    if est is not None:
        est = ESTState(fast=_tensor_tree(est.fast, device), slow=_tensor_tree(est.slow, device))
    return TrainState(params=params,
                      opt_state=AdamState(count=counts.pop(), mu=moments[0], nu=moments[1],
                                          manifold=manifold),
                      model_state=model_state, gen=gen, step=int(np.asarray(jax_state.step)),
                      est_state=est)
