"""The optimizer both trainers use, and the parameter-tree helpers.

Counterpart of the optax chain of ``regcn_tpu/train/state.py:make_optimizer``
(and of the Euclidean branch of ``regcn_tpu/hyperbolic/optim.py``):
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

Parameters are nested dicts and lists of tensors; :func:`tree_leaves`
fixes the order in which the optimizer's moments follow them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def tree_map(fn: Callable, tree):
    """``fn`` applied to every tensor of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def global_norm(grads: Sequence[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                group=None) -> torch.Tensor:
    """The float64 global norm of ``grads``; with ``sharded``, the squares
    of the marked leaves are summed over the ranks of ``group`` (each rank
    holds its rows of them) and the replicated leaves counted once."""
    norms = torch._foreach_norm(list(grads), 2, dtype=torch.float64)
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = [n * n for n in norms]
    local = torch.stack([q for q, s in zip(sq, sharded) if s]).sum()
    dist.all_reduce(local, group=group)
    rest = [q for q, s in zip(sq, sharded) if not s]
    return torch.sqrt(local + (torch.stack(rest).sum() if rest else 0.0))


@dataclasses.dataclass
class AdamState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    # per leaf, whether it lives on the Poincaré ball and takes Riemannian
    # Adam's step (``regcn_torch/hyperbolic/optim.py``); None: no leaf does
    manifold: Optional[List[bool]] = None


class EuclideanAdam:
    """clip-by-global-norm, coupled weight decay, Adam (optax semantics)."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults, the ones the JAX trainer uses

    def __init__(self, lr: float, grad_norm: float = 1.0, weight_decay: float = 1e-5):
        self.lr, self.grad_norm, self.weight_decay = lr, grad_norm, weight_decay
        # on an entity-sharded mesh: per leaf, whether each rank holds only
        # its rows of it, and the process group of those ranks
        self.sharded: Optional[List[bool]] = None
        self.group = None

    def shard(self, sharded: Sequence[bool], group) -> None:
        """Take the clip's global norm across the ranks of ``group``, where
        the leaves marked in ``sharded`` (in the order of the parameters)
        hold each rank's rows only."""
        self.sharded, self.group = list(sharded), group

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
        grads = self.clipped(params, grads)
        state.count += 1
        self.adam(params, grads, state.mu, state.nu, state.count)

    def clipped(self, params: Sequence[torch.Tensor], grads: Sequence[Optional[torch.Tensor]]
                ) -> List[torch.Tensor]:
        """The gradients clipped by their global norm (a None grad is zero)."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        # the global norm accumulated in float64: torch's fp32 norm on the
        # CPU sums millions of squares one after another and loses digits
        # the card's keeps, so the clip factor, and with it every update
        # whose gradient nearly cancels its weight decay, would differ
        # between devices
        g_norm = global_norm(grads, self.sharded, self.group)
        # optax: keep the grads while the norm is below the limit, else
        # g / norm * limit; decided on the device
        factor = torch.where(g_norm < self.grad_norm, torch.ones_like(g_norm),
                             self.grad_norm / g_norm).float()
        return list(torch._foreach_mul(grads, factor))

    def adam(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             mu: List[torch.Tensor], nu: List[torch.Tensor], count: int) -> None:
        """Coupled weight decay, then Adam's step ``count``, in place on
        ``params``, ``mu`` and ``nu`` (the clipped ``grads`` are consumed)."""
        if not params:
            return
        torch._foreach_add_(grads, params, alpha=self.weight_decay)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        torch._foreach_div_(update, denom)
        self.apply_update(params, update)

    def apply_update(self, params: List[torch.Tensor], update: List[torch.Tensor]) -> None:
        """``params -= lr * update``, in place."""
        torch._foreach_add_(params, update, alpha=-self.lr)
