"""The port's hyperbolic ops against regcn_tpu.hyperbolic.ops.

Same numpy inputs on both sides, values and gradients. Tolerance: fp32
on both sides with transcendental and summation rounding that differs
between XLA and PyTorch, rtol=1e-4 / atol=1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.hyperbolic import ops as JH
from regcn_torch.hyperbolic import ops as PH

RTOL, ATOL = 1e-4, 1e-5
C = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save,
    and on a CPU shared with other test workers far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def points(rng, n=12, d=8, scale=3.0):
    """Ball points of varied radius, one row exactly zero and one near the edge."""
    x = rng.normal(size=(n, d)).astype(np.float32) * scale / np.sqrt(d)
    x[0] = 0.0
    x[1] *= 9.9 / np.linalg.norm(x[1])  # radius 9.9 of the ball's 10
    return x


# each case: name -> (jax fn, torch fn) of (x [n, d], y [n, d], c)
UNARY = {
    "norm": (lambda x, y, c: JH._norm(x), lambda x, y, c: PH._norm(x)),
    "clamp_norm": (lambda x, y, c: JH.clamp_norm(x, 2.0), lambda x, y, c: PH.clamp_norm(x, 2.0)),
    "project_to_ball": (lambda x, y, c: JH.project_to_ball(x * 5, c),
                        lambda x, y, c: PH.project_to_ball(x * 5, c)),
    "exp_map_zero": (lambda x, y, c: JH.exp_map_zero(x, c), lambda x, y, c: PH.exp_map_zero(x, c)),
    "log_map_zero": (lambda x, y, c: JH.log_map_zero(x, c), lambda x, y, c: PH.log_map_zero(x, c)),
    "conformal_factor": (lambda x, y, c: JH.conformal_factor(x, c),
                         lambda x, y, c: PH.conformal_factor(x, c)),
    "mobius_add": (lambda x, y, c: JH.mobius_add(x, y, c), lambda x, y, c: PH.mobius_add(x, y, c)),
    "get_radius": (lambda x, y, c: JH.get_radius(x), lambda x, y, c: PH.get_radius(x)),
    "apply_radius": (lambda x, y, c: JH.apply_radius(x, y[:, 0] + 1.5, c),
                     lambda x, y, c: PH.apply_radius(x, y[:, 0] + 1.5, c)),
    "safe_arctanh": (lambda x, y, c: JH.safe_arctanh(x / 4), lambda x, y, c: PH.safe_arctanh(x / 4)),
    "clamp_tangent_norm": (lambda x, y, c: JH.clamp_tangent_norm(x * 100, c),
                           lambda x, y, c: PH.clamp_tangent_norm(x * 100, c)),
    "lorentz_inner": (lambda x, y, c: JH.lorentz_inner(x, y), lambda x, y, c: PH.lorentz_inner(x, y)),
    "to_lorentz": (lambda x, y, c: JH.to_lorentz(x, c), lambda x, y, c: PH.to_lorentz(x, c)),
    # these two at half the radius: near the edge the hyperboloid's
    # coordinates reach ~1e3, <x,x>_L cancels ~1e6-sized terms in fp32, and
    # neither side is accurate to 1e-4 there
    "to_poincare": (lambda x, y, c: JH.to_poincare(JH.to_lorentz(x / 2, c) * 1.1, c),
                    lambda x, y, c: PH.to_poincare(PH.to_lorentz(x / 2, c) * 1.1, c)),
    "lorentz_normalize": (lambda x, y, c: JH.lorentz_normalize(JH.to_lorentz(x / 2, c) * 1.3, c),
                          lambda x, y, c: PH.lorentz_normalize(PH.to_lorentz(x / 2, c) * 1.3, c)),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_op_value_and_gradient_match_jax(rng, name):
    jfn, pfn = UNARY[name]
    x, y = points(rng), points(rng)
    want = jfn(jnp.asarray(x), jnp.asarray(y), jnp.float32(C))
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.tensor(C, requires_grad=True)
    got = pfn(xt, torch.from_numpy(y), ct)
    close(got, want)
    # gradient of a fixed random projection of the output, w.r.t. x and c
    w = rng.normal(size=np.shape(want)).astype(np.float32)
    jgx, jgc = jax.jit(jax.grad(lambda a, c: jnp.sum(jfn(a, jnp.asarray(y), c) * w),
                                argnums=(0, 1)))(
        jnp.asarray(x), jnp.float32(C))
    gx, gc = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)), [xt, ct],
                                 allow_unused=True)
    close(gx, jgx)
    close(torch.zeros(()) if gc is None else gc, jgc, rtol=1e-3)


def test_tangent_norm_bound_matches_jax():
    for c in (1e-4, 0.01, 0.3):
        close(PH.tangent_norm_bound(torch.tensor(c)), JH.tangent_norm_bound(jnp.float32(c)))


@pytest.mark.parametrize("tie", ["lo", "hi"])
def test_clip_splits_the_gradient_at_ties_as_jax_does(tie):
    """radius targets hit radius_min / radius_max exactly: at a tie JAX's
    clip passes half the gradient, torch.clamp all of it."""
    v = 0.5 if tie == "lo" else 3.0
    jg = jax.jit(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.5, 3.0))))(
        jnp.asarray([v, 1.0], jnp.float32))
    x = torch.tensor([v, 1.0], requires_grad=True)
    (g,) = torch.autograd.grad(PH.clip(x, 0.5, 3.0).sum(), [x])
    close(g, jg, rtol=0, atol=0)
    assert g[0] == 0.5


def test_lorentz_centroid_segments_with_empty_segments(rng):
    """Weighted centroids per segment; segments 3 and 6 get no edge and one
    segment gets only zero-weight edges: all three are the origin."""
    E, S, d = 30, 8, 8
    seg = rng.integers(0, S, E)
    seg[np.isin(seg, [3, 6])] = 0
    seg[-4:] = 5
    w = rng.random(E).astype(np.float32)
    w[seg == 5] = 0.0
    emb = np.array(JH.to_lorentz(jnp.asarray(points(rng, E, d)), C))
    want = JH.lorentz_centroid_segments(jnp.asarray(emb), jnp.asarray(w), jnp.asarray(seg), S, C)
    et = torch.from_numpy(emb).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = PH.lorentz_centroid_segments(et, wt, torch.from_numpy(seg), S, C)
    close(got, want)
    origin = np.zeros(d + 1, np.float32)
    origin[0] = 1 / np.sqrt(C)
    for s in (3, 5, 6):
        close(got[s], origin)
    proj = rng.normal(size=(S, d + 1)).astype(np.float32)
    jge, jgw = jax.jit(jax.grad(lambda e, ww: jnp.sum(JH.lorentz_centroid_segments(
        e, ww, jnp.asarray(seg), S, C) * proj), argnums=(0, 1)))(jnp.asarray(emb), jnp.asarray(w))
    ge, gw = torch.autograd.grad(torch.sum(got * torch.from_numpy(proj)), [et, wt])
    close(ge, jge)
    close(gw, jgw)
