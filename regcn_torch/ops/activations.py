"""Activation functions matching the reference's torch semantics, and
the inverted dropout of the training path."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

# torch F.rrelu defaults (ref uses F.rrelu at ref:src/rrgcn.py:16)
RRELU_LOWER = 1.0 / 8.0
RRELU_UPPER = 1.0 / 3.0


def rrelu(x: torch.Tensor) -> torch.Tensor:
    """Randomized leaky ReLU in eval mode: a fixed slope (lower+upper)/2.

    The reference calls F.rrelu functionally with its default
    training=False (ref:src/rrgcn.py:16), so the model only ever uses
    this deterministic form.
    """
    return torch.where(x >= 0, x, x * ((RRELU_LOWER + RRELU_UPPER) / 2.0))


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: x where x >= 0, else x * negative_slope. Its
    derivative at 0 is 1, as JAX's; torch's ``F.leaky_relu`` takes the
    slope there."""
    return torch.where(x >= 0, x, x * negative_slope)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row L2 normalisation, parity with torch F.normalize (p=2).

    The clamp sits inside the sqrt, as in ``regcn_tpu/ops/activations.py``,
    and the norm is taken in fp32.
    """
    x32 = x.float()
    sq = torch.sum(x32 * x32, dim=dim, keepdim=True)
    return (x32 / torch.sqrt(torch.clamp(sq, min=eps * eps))).to(x.dtype)


class DropoutDraws:
    """Dropout's uniform draws given in advance, in the order the training
    path asks for them: a stand-in for its generator where the draws must
    come from outside the function, as under ``torch.func.vmap``, where each
    model's draws come batched from its own generator. Without ``draws`` it
    records the shapes the path asks for (and hands back zeros), so a run on
    the ``meta`` device lists the draws a step needs."""

    def __init__(self, draws: Optional[Sequence[torch.Tensor]] = None):
        self.draws = None if draws is None else list(draws)
        self.shapes: List[Tuple[int, ...]] = []

    def uniform(self, shape, device) -> torch.Tensor:
        i = len(self.shapes)
        self.shapes.append(tuple(shape))
        if self.draws is None:
            return torch.zeros(shape, device=device)
        if i >= len(self.draws) or tuple(self.draws[i].shape) != tuple(shape):
            raise ValueError(f"dropout draw {i} of shape {tuple(shape)} was not given in advance")
        return self.draws[i]


def inverted_dropout(x: torch.Tensor, rate: float,
                     gen: Union[torch.Generator, DropoutDraws, None], train: bool,
                     rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability ``1 - rate`` and
    scale the survivors by ``1 / (1 - rate)``; the identity outside
    training, at rate 0 or without a generator. The mask is drawn from
    ``gen``, which must live on ``x``'s device, or taken from a
    :class:`DropoutDraws`. With ``rows`` = (n, row0), ``x`` holds rows
    ``row0 ..`` of an [n, ...] table sharded over ranks: the mask of the
    whole table is drawn (every rank's generator alike) and ``x`` keeps its
    rows, so a sharded run draws what the unsharded one draws."""
    if not train or rate <= 0.0 or gen is None:
        return x
    shape = x.shape if rows is None else (rows[0],) + tuple(x.shape[1:])
    if isinstance(gen, DropoutDraws):
        keep = gen.uniform(shape, x.device) < 1.0 - rate
    else:
        if gen.device.type != x.device.type:
            raise ValueError(f"dropout on a {x.device.type} tensor needs a generator on that "
                             f"device, got one on {gen.device}")
        keep = torch.rand(shape, generator=gen, device=x.device) < 1.0 - rate
    if rows is not None:
        keep = keep[rows[1]:rows[1] + x.shape[0]]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
