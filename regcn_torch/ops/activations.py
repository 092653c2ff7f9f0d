"""Activation functions matching the reference's torch semantics, and
the inverted dropout of the training path."""

from __future__ import annotations

from typing import Optional

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


def inverted_dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator], train: bool
                     ) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability ``1 - rate`` and
    scale the survivors by ``1 / (1 - rate)``; the identity outside
    training, at rate 0 or without a generator. The mask is drawn from
    ``gen``, which must live on ``x``'s device."""
    if not train or rate <= 0.0 or gen is None:
        return x
    if gen.device.type != x.device.type:
        raise ValueError(f"dropout on a {x.device.type} tensor needs a generator on that "
                         f"device, got one on {gen.device}")
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
