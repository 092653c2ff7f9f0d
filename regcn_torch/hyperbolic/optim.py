"""The dual Riemannian / Euclidean optimizer of the hyperbolic trainer.

Counterpart of ``regcn_tpu/hyperbolic/optim.py`` (parity with the
reference's ``_DualOptimizer``, ref:hyperbolic_src/hyperbolic_main.py:404-467).
With ``manifold_entities`` the entity table ``dynamic_emb`` lives on the
Poincaré ball and takes Riemannian Adam's step, every other parameter the
Euclidean optimizer's (``regcn_torch/train/optim.py``). One step, as
optax's ``clip_by_global_norm`` then ``multi_transform`` takes it:

1. every gradient clipped by the global norm over all parameters;
2. on the ball leaves, the Riemannian gradient g / λ_x² (λ_x the
   conformal factor at the point), Adam's moments with bias correction,
   and the retraction x <- exp_x(-lr m̂ / (sqrt(v̂) + eps)), added as
   JAX adds it, x + (exp_x(...) - x);
3. on every other leaf, coupled weight decay, then Adam.

Momentum is not transported between points (geoopt's default, and
JAX's). Which leaves are on the ball travels with the optimizer state
(``AdamState.manifold``), since a state converted from JAX orders its
leaves otherwise than one made here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from regcn_torch.hyperbolic import ops as H
from regcn_torch.train.optim import AdamState, EuclideanAdam

MANIFOLD_KEYS = ("dynamic_emb",)


def manifold_mask(tree, on_ball: bool = False) -> List[bool]:
    """Per leaf of ``tree`` (``tree_leaves`` order), whether it lies under a
    key of ``MANIFOLD_KEYS``."""
    if isinstance(tree, dict):
        return [m for k, v in tree.items() for m in manifold_mask(v, on_ball or k in MANIFOLD_KEYS)]
    if isinstance(tree, list):
        return [m for v in tree for m in manifold_mask(v, on_ball)]
    return [on_ball]


class RiemannianDualAdam(EuclideanAdam):
    """Riemannian Adam on the state's ball leaves at the fixed curvature
    ``c``, :class:`EuclideanAdam`'s decay and Adam on the others, after one
    clip over all of them."""

    def __init__(self, lr: float, c: float, grad_norm: float = 1.0,
                 weight_decay: float = 1e-5):
        super().__init__(lr, grad_norm, weight_decay)
        self.c = c

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]],
             state: AdamState) -> None:
        if state.manifold is None:
            raise ValueError("the optimizer state marks no leaf as on the ball "
                             "(AdamState.manifold)")
        params = list(params)
        grads = self.clipped(params, grads)
        state.count += 1
        euclid = [i for i, on_ball in enumerate(state.manifold) if not on_ball]
        self.adam(*([seq[i] for i in euclid] for seq in (params, grads, state.mu, state.nu)),
                  state.count)
        for i in (i for i, on_ball in enumerate(state.manifold) if on_ball):
            self._riemannian(params[i], grads[i], state.mu[i], state.nu[i], state.count)

    def _riemannian(self, x, g, mu, nu, count: int) -> None:
        lam = H.conformal_factor(x, self.c)
        rg = g / (lam * lam)
        mu.mul_(self.b1).add_(rg, alpha=1.0 - self.b1)
        nu.mul_(self.b2).addcmul_(rg, rg, value=1.0 - self.b2)
        mu_hat = mu / (1.0 - self.b1 ** count)
        nu_hat = nu / (1.0 - self.b2 ** count)
        direction = -self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        x.add_(H.exp_map(direction, x, self.c) - x)


def dual_optimizer(tc, cfg) -> EuclideanAdam:
    """The hyperbolic trainer's optimizer: :class:`RiemannianDualAdam` at
    ``cfg.c`` with ``manifold_entities``, else the Euclidean one."""
    if cfg.manifold_entities:
        return RiemannianDualAdam(tc.lr, cfg.c, tc.grad_norm, tc.weight_decay)
    return EuclideanAdam(tc.lr, tc.grad_norm, tc.weight_decay)
