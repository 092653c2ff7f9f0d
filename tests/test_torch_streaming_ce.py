"""Kernel B2's plain version against regcn_tpu, value and all six gradients.

The port's ``dist_ce_loss`` on CPU tensors is the plain version of the
streaming CE kernels. It is held against JAX's dense
``dist_ce_loss(streaming=False)`` and against the Pallas kernel itself,
``streaming_dist_ce_loss`` run in interpret mode (as
tests/test_pallas_scoring.py runs it), on the proxy path and the
true-distance path with per-query curvature, with a mask, and with N
not a multiple of the Pallas tile (512). The JAX references are computed
once per case for the module.

Tolerances: the value within rtol 1e-5 (fp32 logsumexp in another
order). Gradients within rtol 2e-4, the tolerance
tests/test_pallas_scoring.py holds the Pallas backward to against the
dense JAX path (its tile-by-tile recompute sums in another order), plus
atol 1e-5 * max(1, max|JAX gradient|): dc_i and dbias_j are sums over
hundreds of terms that cancel, so a small entry carries the rounding of
the large terms it came from. The true distance near the ball's edge is
ill-conditioned: artanh'(z) = 1/(1 - z^2) amplifies the fp32 rounding of
1 - c|q|^2 about a thousandfold, and JAX's own dense and Pallas paths
disagree there by ~0.5 % in dq. That case is held to rtol 1e-2, and the
test checks that the two JAX paths disagree by more than the default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from regcn_tpu.hyperbolic import decoders as JD
from regcn_tpu.hyperbolic import ops as JH
from regcn_tpu.ops.pallas_scoring import streaming_dist_ce_loss
from regcn_torch.hyperbolic import decoders as PD
from regcn_torch.ops import streaming_ce

C = 0.01
B, N, D = 16, 600, 8
VALUE_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
GRAD_NAMES = ("q", "x", "bias", "c", "scale", "margin")

# case -> (true distance, per-query curvature given, mask, points near the ball's edge)
CASES = {
    "proxy": (False, False, True, False),
    "proxy_near_edge": (False, False, True, True),
    "proxy_ignores_query_c": (False, True, False, False),
    "true_per_query_c": (True, True, True, False),
    "true_scalar_c_near_edge": (True, False, False, True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save,
    and on a CPU shared with other test workers far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(case):
    true, per_query, masked, edge = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q = np.array(JH.exp_map_zero(jnp.asarray(rng.normal(size=(B, D)).astype(np.float32) * 0.4), C))
    x = np.array(JH.exp_map_zero(jnp.asarray(rng.normal(size=(N, D)).astype(np.float32) * 0.4), C))
    if edge:
        # antipodal pairs at radius 9.995 of the ball's 10: the true
        # distance's max-norm clamp binds. Inside the ball the proxy's clamp
        # binds only by rounding, so five candidates sit past the edge.
        unit = q[:5] / np.linalg.norm(q[:5], axis=1, keepdims=True)
        q[:5] = 9.995 * unit
        x[:5] = -9.995 * unit
        x[5:10] = -12.0 * unit
    tgt = rng.integers(0, N, B).astype(np.int32)
    tgt[:3] = N - 1 - np.arange(3)  # targets in the last, partial tile
    return dict(
        true=true, q=q, x=x, tgt=tgt,
        bias=(rng.normal(size=N) * 0.1).astype(np.float32),
        c=np.float32(C),
        qc=rng.uniform(0.005, 0.05, B).astype(np.float32) if per_query else None,
        mask=(rng.uniform(size=B) > 0.25).astype(np.float32) if masked else None,
        scale=np.float32(1.3), margin=np.float32(0.7))


def jax_loss(a, streaming):
    """The JAX loss as a function of (q, x, bias, c-or-qc, scale, margin)."""
    diff_qc = a["qc"] is not None and a["true"]

    def f(q, x, bias, c, scale, margin):
        kw = dict(mask=None if a["mask"] is None else jnp.asarray(a["mask"]),
                  candidate_bias=bias, score_scale=scale, score_margin=margin,
                  query_curvature=c if diff_qc else
                  (None if a["qc"] is None else jnp.asarray(a["qc"])),
                  use_hyperbolic_distance=a["true"])
        c_arg = jnp.float32(C) if diff_qc else c
        if streaming:
            return streaming_dist_ce_loss(q, x, jnp.asarray(a["tgt"]), c_arg, **kw)
        return JD.dist_ce_loss(q, x, jnp.asarray(a["tgt"]), c_arg, streaming=False, **kw)

    args = tuple(jnp.asarray(v) for v in (a["q"], a["x"], a["bias"],
                                          a["qc"] if diff_qc else a["c"], a["scale"], a["margin"]))
    with pltpu.force_tpu_interpret_mode():
        value, grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(6))))(*args)
    return float(value), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def references():
    return {case: {kind: jax_loss(inputs(case), kind == "pallas") for kind in ("dense", "pallas")}
            for case in CASES}


def torch_loss(a):
    diff_qc = a["qc"] is not None and a["true"]
    leaves = [torch.tensor(v, requires_grad=True) for v in (
        a["q"], a["x"], a["bias"], a["qc"] if diff_qc else a["c"], a["scale"], a["margin"])]
    q, x, bias, c, scale, margin = leaves
    qc = c if diff_qc else (None if a["qc"] is None else torch.from_numpy(a["qc"]))
    loss = PD.dist_ce_loss(q, x, torch.from_numpy(a["tgt"]).long(), C if diff_qc else c,
                           mask=None if a["mask"] is None else torch.from_numpy(a["mask"]),
                           candidate_bias=bias, score_scale=scale, score_margin=margin,
                           query_curvature=qc, use_hyperbolic_distance=a["true"])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]


@pytest.mark.parametrize("kind", ["dense", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax(references, case, kind):
    a = inputs(case)
    value, grads = torch_loss(a)
    want_value, want_grads = references[case][kind]
    np.testing.assert_allclose(value, want_value, rtol=VALUE_RTOL)
    rtol = GRAD_RTOL
    if case == "true_scalar_c_near_edge":
        rtol = 1e-2
        dense, pallas = references[case]["dense"][1][0], references[case]["pallas"][1][0]
        assert not np.allclose(dense, pallas, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for name, g, w in zip(GRAD_NAMES, grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=GRAD_ATOL * max(1.0, np.abs(w).max()), err_msg=name)
        assert np.any(w != 0) or name == "c", f"{case}: JAX's d{name} is all zero"


@pytest.mark.parametrize("case", ["proxy_near_edge", "true_scalar_c_near_edge"])
def test_near_edge_cases_reach_the_clamps(case):
    """The near-edge inputs make each path's max-norm clamp bind for some
    pairs, by a margin well above fp32 rounding."""
    a = inputs(case)
    diff_sq = streaming_ce.mobius_diff_norm_sq(torch.from_numpy(a["q"]), torch.from_numpy(a["x"]), C)
    if a["true"]:
        sqrt_c = np.sqrt(C + 1e-6)
        bound = (1 / (sqrt_c + 1e-6) - 1e-6) ** 2
    else:
        bound = (1 / np.sqrt(C) - 2e-6) ** 2
    assert (diff_sq > bound + 1e-3).sum() >= 5
    assert (diff_sq < bound - 1e-3).float().mean() > 0.9


def test_dist_score_matches_jax(references):
    """The dense eval scores, both distances, with per-query curvature."""
    for case in ("proxy", "true_per_query_c"):
        a = inputs(case)
        kw = dict(score_margin=0.7, use_hyperbolic_distance=a["true"])
        want = JD.dist_score(jnp.asarray(a["q"]), jnp.asarray(a["x"]), C,
                             candidate_bias=jnp.asarray(a["bias"]), score_scale=jnp.float32(1.3),
                             query_curvature=None if a["qc"] is None else jnp.asarray(a["qc"]),
                             **kw)
        got = PD.dist_score(torch.from_numpy(a["q"]), torch.from_numpy(a["x"]), C,
                            candidate_bias=torch.from_numpy(a["bias"]),
                            score_scale=torch.tensor(1.3),
                            query_curvature=None if a["qc"] is None else torch.from_numpy(a["qc"]),
                            **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
