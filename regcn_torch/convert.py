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
list, the decoder dicts and the 0-d leaves (``log_c``,
``score_margin``, ``score_scale_raw``) become tensors of the same
shapes, and ``HypModelState.radius_target`` comes along.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from regcn_torch.hyperbolic.model import HypModelState
from regcn_torch.models.recurrent import ModelState


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
