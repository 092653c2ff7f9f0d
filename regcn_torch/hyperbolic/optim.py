"""The Euclidean branch of the hyperbolic trainer's optimizer.

Counterpart of ``regcn_tpu/hyperbolic/optim.py:dual_optimizer`` with
``manifold_entities=False``: the optax chain
``clip_by_global_norm(grad_norm) -> add_decayed_weights(weight_decay) ->
adam(lr)``, on a flat list of parameter tensors, in place. It is written
out rather than taken from ``torch.nn.utils.clip_grad_norm_`` and
``torch.optim.Adam`` because those differ from optax in two ways that
move the trajectory:

- ``clip_grad_norm_`` divides by ``norm + 1e-6``; optax divides by the
  norm itself, and only when the norm is at least ``grad_norm``;
- ``Adam`` skips a parameter whose ``.grad`` is None; optax decays and
  updates every leaf, so a leaf without a gradient here gets a zero
  gradient, then its weight decay and its Adam step.

Riemannian Adam for entities stored on the ball is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class EuclideanAdam:
    """clip-by-global-norm, coupled weight decay, Adam (optax semantics)."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults, the ones the JAX trainer uses

    def __init__(self, lr: float, grad_norm: float = 1.0, weight_decay: float = 1e-5):
        self.lr, self.grad_norm, self.weight_decay = lr, grad_norm, weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(count=0, mu=[torch.zeros_like(p) for p in params],
                         nu=[torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
             state: AdamState) -> None:
        """Updates ``params`` and ``state`` in place; a None grad is zero.

        Written with ``torch._foreach_*`` ops: a dozen launches for all
        parameters together, where one op per tensor would be hundreds."""
        params = list(params)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax: keep the grads while the norm is below the limit, else
        # g / norm * limit; decided on the device
        factor = torch.where(g_norm < self.grad_norm, torch.ones_like(g_norm),
                             self.grad_norm / g_norm)
        grads = torch._foreach_mul(grads, factor)
        torch._foreach_add_(grads, params, alpha=self.weight_decay)
        state.count += 1
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(state.nu, 1.0 - self.b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(state.mu, 1.0 - self.b1 ** state.count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(params, update, alpha=-self.lr)


def dual_optimizer(lr: float, grad_norm: float = 1.0, weight_decay: float = 1e-5,
                   manifold_entities: bool = False) -> EuclideanAdam:
    if manifold_entities:
        raise NotImplementedError(
            "manifold_entities (Riemannian Adam on the ball) is not ported yet (ROADMAP A6)")
    return EuclideanAdam(lr, grad_norm, weight_decay)
