"""Poincaré-ball and Lorentz-model operations.

Counterparts of ``regcn_tpu/hyperbolic/ops.py`` for what the hyperbolic
slice runs, with the same ``EPS`` clamps and fp32 islands. The curvature
``c`` is a float or a 0-d tensor (learned curvature); gradients flow to it.

At a tie JAX's ``jnp.maximum`` / ``jnp.minimum`` / ``jnp.clip`` split the
gradient evenly between both sides, while ``torch.clamp`` passes all of it
to the input. :func:`clip` keeps JAX's rule, for the one place where ties
happen: radius targets hit ``radius_min`` and ``radius_max`` exactly, and
``_static_radius`` clips against those same bounds. The other clamps bound
a computed value by an eps-sized or fixed constant that it never equals in
practice; they use ``torch.clamp``, whose backward is two kernels where the
tie-splitting one is five.

Conventions: curvature c > 0, ball = {x : c ||x||^2 < 1}.
"""

from __future__ import annotations

import functools

import torch

EPS = 1e-6


@functools.lru_cache(maxsize=None)
def constant(v: float, device: torch.device) -> torch.Tensor:
    """A float32 0-d tensor on ``device``, made once per value: a fresh
    ``torch.tensor(v, device="cuda")`` is a pageable host-to-device copy
    that waits for the stream to drain. Made outside inference mode, so
    that autograd may save it later."""
    with torch.inference_mode(False):
        return torch.tensor(v, dtype=torch.float32, device=device)


def _t(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor on ``like``'s device (float32 for Python numbers)."""
    if isinstance(v, torch.Tensor):
        return v
    return constant(float(v), like.device)


def maximum(x: torch.Tensor, v) -> torch.Tensor:
    """``jnp.maximum(x, v)``: JAX's gradient at ties for a tensor ``v``;
    ``torch.clamp`` for a number, which ``x`` is not expected to equal."""
    if isinstance(v, torch.Tensor):
        return torch.maximum(x, v)
    return torch.clamp(x, min=v)


def minimum(x: torch.Tensor, v) -> torch.Tensor:
    """``jnp.minimum(x, v)``, as :func:`maximum`."""
    if isinstance(v, torch.Tensor):
        return torch.minimum(x, v)
    return torch.clamp(x, max=v)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` = minimum(maximum(x, lo), hi), with JAX's
    gradient at ties."""
    return torch.minimum(torch.maximum(x, _t(lo, x)), _t(hi, x))


def sqrt(c):
    return torch.sqrt(c) if isinstance(c, torch.Tensor) else c ** 0.5


def _norm(x: torch.Tensor, keepdim: bool = True, eps: float = EPS) -> torch.Tensor:
    # clamp INSIDE the sqrt: sqrt'(0) = inf would otherwise give NaN
    # gradients for exactly-zero rows (empty aggregation segments)
    sq = torch.sum(x * x, dim=-1, keepdim=keepdim)
    return torch.sqrt(maximum(sq, eps * eps))


def clamp_norm(x: torch.Tensor, max_norm, eps: float = EPS) -> torch.Tensor:
    """Rescale rows whose norm exceeds max_norm (fp32 island)."""
    x32 = x.float()
    norm = _norm(x32, eps=eps)
    clamped = minimum(norm, max_norm - eps)
    return (x32 * (clamped / norm)).to(x.dtype)


def project_to_ball(x: torch.Tensor, c, eps: float = EPS) -> torch.Tensor:
    """Project into the open Poincaré ball of curvature c."""
    return clamp_norm(x, 1.0 / sqrt(c) - eps, eps)


def exp_map_zero(v: torch.Tensor, c, eps: float = EPS) -> torch.Tensor:
    """exp_0(v) = tanh(sqrt(c)||v||) v / (sqrt(c)||v||), projected."""
    sqrt_c = sqrt(c)
    v32 = v.float()
    v_norm = _norm(v32, eps=eps)
    out = torch.tanh(sqrt_c * v_norm) * (v32 / v_norm) / sqrt_c
    return project_to_ball(out, c, eps).to(v.dtype)


def log_map_zero(x: torch.Tensor, c, eps: float = EPS) -> torch.Tensor:
    """log_0(x) = atanh(sqrt(c)||x||) x / (sqrt(c)||x||)."""
    sqrt_c = sqrt(c)
    x32 = x.float()
    x_norm = _norm(x32, eps=eps)
    scaled = minimum(sqrt_c * x_norm, 1.0 - eps)
    return (torch.atanh(scaled) * x32 / (sqrt_c * x_norm)).to(x.dtype)


def conformal_factor(x: torch.Tensor, c, keepdim: bool = True) -> torch.Tensor:
    """λ_x = 2 / (1 - c ||x||²)."""
    sq = torch.sum(x * x, dim=-1, keepdim=keepdim)
    return 2.0 / maximum(1.0 - c * sq, EPS)


def mobius_add(x: torch.Tensor, y: torch.Tensor, c, eps: float = EPS) -> torch.Tensor:
    """Möbius addition x ⊕_c y, projected to the ball."""
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    y_sq = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    num = (1 + 2 * c * xy + c * y_sq) * x + (1 - c * x_sq) * y
    denom = 1 + 2 * c * xy + c * c * x_sq * y_sq
    return project_to_ball(num / (denom + eps), c, eps)


def get_radius(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Point norm, the hyperbolic 'specificity' radius: [...]."""
    return _norm(x, keepdim=False, eps=eps)


def apply_radius(x: torch.Tensor, radius, c, eps: float = EPS) -> torch.Tensor:
    """Rescale points to a target radius, direction preserved."""
    if radius is None:
        return x
    radius = _t(radius, x)
    if radius.dim() == x.dim() - 1:
        radius = radius[..., None]
    radius = clip(radius.float(), eps, 1.0 / sqrt(c) - eps)
    x32 = x.float()
    return (x32 / _norm(x32, eps=eps) * radius).to(x.dtype)


def safe_arctanh(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    return torch.atanh(clip(x, -1 + eps, 1 - eps))


def tangent_norm_bound(c, eps: float = EPS):
    """The tangent norm that survives exp_0 -> project -> log_0."""
    sqrt_c = torch.sqrt(torch.as_tensor(c, dtype=torch.float32))
    return torch.atanh(minimum(1.0 - 2.0 * sqrt_c * eps, 1.0 - eps)) / sqrt_c


def clamp_tangent_norm(v: torch.Tensor, c, eps: float = EPS) -> torch.Tensor:
    """Tangent-space equivalent of log_0(project_to_ball(exp_0(v)))."""
    bound = tangent_norm_bound(c, eps)
    v32 = v.float()
    vn = _norm(v32, eps=eps)
    return (v32 * (minimum(vn, bound) / vn)).to(v.dtype)


# ------------------------------------------------ Lorentz / hyperboloid model

def lorentz_inner(x: torch.Tensor, y: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Minkowski inner product <x,y>_L = -x0 y0 + sum_i xi yi."""
    t = torch.sum(x[..., :1] * y[..., :1], dim=-1, keepdim=keepdim)
    s = torch.sum(x[..., 1:] * y[..., 1:], dim=-1, keepdim=keepdim)
    return -t + s


def to_lorentz(x: torch.Tensor, c, eps: float = EPS) -> torch.Tensor:
    """Poincaré ball -> Lorentz manifold, <y,y>_L = -1/c."""
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    denom = maximum(1.0 - c * x_sq, eps)
    x0 = (1.0 + c * x_sq) / (sqrt(c) * denom)
    return torch.cat([x0, 2.0 * x / denom], dim=-1)


def to_poincare(y: torch.Tensor, c, eps: float = EPS) -> torch.Tensor:
    """Lorentz manifold -> Poincaré ball."""
    denom = maximum(1.0 + y[..., :1] * sqrt(c), eps)
    return y[..., 1:] / denom


def lorentz_normalize(x: torch.Tensor, c, eps: float = EPS) -> torch.Tensor:
    """Rescale onto the manifold: <x,x>_L = -1/c."""
    ip = lorentz_inner(x, x, keepdim=True)
    return x / torch.sqrt(maximum(-ip * c, eps))


def lorentz_centroid_segments(
    emb: torch.Tensor,  # [E, d+1] points on the hyperboloid
    weights: torch.Tensor,  # [E] non-negative
    segment_ids: torch.Tensor,  # [E] int64
    num_segments: int,
    c,
    eps: float = EPS,
) -> torch.Tensor:
    """Per-segment weighted Lorentz centroid; empty segments give the
    hyperboloid's origin (1/sqrt(c), 0, ...). Two segment sums with
    ``index_add_``, as the JAX package does them with ``segment_sum``."""
    wsum = weights.new_zeros(num_segments).index_add(0, segment_ids, weights)
    w = weights / (wsum[segment_ids] + eps)
    centroid = emb.new_zeros((num_segments, emb.shape[-1])).index_add(
        0, segment_ids, w[:, None] * emb)
    origin = torch.zeros_like(centroid)
    origin[:, 0] = 1.0 / sqrt(c)
    centroid = torch.where((wsum <= eps)[:, None], origin, centroid)
    return lorentz_normalize(centroid, c, eps).to(emb.dtype)
