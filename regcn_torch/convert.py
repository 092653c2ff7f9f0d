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

:func:`train_state_from_jax` takes a whole ``regcn_tpu`` ``TrainState``
or hyperbolic ``HypTrainState`` (numpy leaves): its parameters and BN
statistics as above, the Adam ``count``/``mu``/``nu`` of its optax chain,
its step and, from a ``HypTrainState`` with EST, its ``ESTState`` (the
H-PES ``fast`` and ``slow`` memories), so that a run can continue
mid-training in this package.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

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


def _adam_state(opt_state):
    """The member of a (nested tuple) optax chain state that has Adam's
    ``count``, ``mu`` and ``nu``."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _like(tree, template):
    """``tree`` reordered as ``template``: the same keys, in its order
    (JAX may hand back a dict with its keys sorted)."""
    if isinstance(template, Mapping):
        return {k: _like(tree[k], v) for k, v in template.items()}
    if isinstance(template, list):
        return [_like(t, v) for t, v in zip(tree, template)]
    return tree


def train_state_from_jax(jax_state, device="cuda", seed: int = 0) -> TrainState:
    """A ``TrainState`` on ``device`` from a ``regcn_tpu`` ``TrainState`` or
    ``HypTrainState`` (its model state has a ``radius_target``) with numpy
    leaves (``jax.tree.map(np.asarray, state)``). The dropout generator,
    which JAX's PRNG key cannot seed alike, is seeded with ``seed``."""
    hyperbolic = hasattr(jax_state.model_state, "radius_target")
    convert = hyperbolic_params_from_jax if hyperbolic else params_from_jax
    params, model_state = convert(jax_state.params, jax_state.model_state, device)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    adam = _adam_state(jax_state.opt_state)
    if adam is None:
        raise ValueError("the JAX optimizer state holds no Adam moments (count, mu, nu)")
    moments = [tree_leaves(_like(_tensor_tree(m, device), params)) for m in (adam.mu, adam.nu)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    est = getattr(jax_state, "est_state", None)
    if est is not None:
        est = ESTState(fast=_tensor_tree(est.fast, device), slow=_tensor_tree(est.slow, device))
    return TrainState(params=params,
                      opt_state=AdamState(count=int(np.asarray(adam.count)), mu=moments[0],
                                          nu=moments[1]),
                      model_state=model_state, gen=gen, step=int(np.asarray(jax_state.step)),
                      est_state=est)
