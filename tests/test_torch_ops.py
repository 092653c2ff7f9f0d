"""The port's ops against regcn_tpu.ops (the scatter kernel's own tests are
in test_torch_kernels.py).

Tolerances: fp32 on both sides; sums taken in another order give
rtol=1e-4 / atol=1e-5 unless stated. Gradients use the same tolerances:
each entry is a sum over at most a few hundred edges in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.data import build_snapshot as jax_build_snapshot
from regcn_tpu.ops import activations as jax_act
from regcn_tpu.ops import segment as jax_segment
from regcn_tpu.ops.pallas_rgcn import rgcn_aggregate_pallas, scatter_add_sorted as jax_scatter
from regcn_tpu.ops.rgcn_scatter import rgcn_aggregate as jax_rgcn_aggregate
from regcn_torch.ops import activations as pt_act
from regcn_torch.ops import segment as pt_segment
from regcn_torch.ops.rgcn_scatter import (
    rgcn_aggregate,
    scatter_add_sorted,
    scatter_add_sorted_reference,
)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save,
    and on a CPU shared with other test workers far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_masked_segment_reductions_match_jax(rng, reduce):
    M, S, d = 90, 12, 7
    data = rng.normal(size=(M, d)).astype(np.float32)
    ids = rng.integers(0, S - 2, M).astype(np.int64)  # the last two segments stay empty
    mask = (rng.random(M) < 0.7).astype(np.float32)
    pt_fn = getattr(pt_segment, f"masked_segment_{reduce}")
    jax_fn = getattr(jax_segment, f"masked_segment_{reduce}")
    got = pt_fn(t(data), t(ids), t(mask), S)
    want = jax_fn(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(mask), S)
    close(got, want)
    assert np.all(got.numpy()[-2:] == 0.0)


def test_rrelu_and_l2_normalize_match_jax(rng):
    x = rng.normal(size=(20, 9)).astype(np.float32)
    x[3] = 0.0  # a zero row: the clamp inside the sqrt keeps it finite
    close(pt_act.rrelu(t(x)), jax_act.rrelu(jnp.asarray(x), None, train=False), rtol=0, atol=0)
    got = pt_act.l2_normalize(t(x))
    close(got, jax_act.l2_normalize(jnp.asarray(x)), rtol=1e-6, atol=1e-7)
    assert np.all(got.numpy()[3] == 0.0)


def _sorted_keys(rng, E, n, n_real):
    keys = np.full(E, n, np.int32)
    keys[:n_real] = np.sort(rng.integers(0, n, n_real))
    return keys


@pytest.mark.parametrize("weighted", [False, True])
def test_scatter_reference_matches_pallas_interpret(rng, weighted):
    from jax.experimental.pallas import tpu as pltpu

    E, n, d = 96, 40, 8
    keys = _sorted_keys(rng, E, n, 80)  # padded tail keyed n
    msg = rng.normal(size=(E, d)).astype(np.float32)
    w = rng.random(E).astype(np.float32) if weighted else None
    scale = rng.random(n).astype(np.float32) if weighted else None
    got = scatter_add_sorted_reference(
        t(msg), t(keys), n, None if w is None else t(w), None if scale is None else t(scale))
    with pltpu.force_tpu_interpret_mode():
        want = jax_scatter(jnp.asarray(msg * (1.0 if w is None else w[:, None])),
                           jnp.asarray(keys), n, tile_edges=32, chunk=8)
    want = np.asarray(want) * (1.0 if scale is None else scale[:, None])
    close(got, want)


def _aggregate_inputs(rng, case, dst_sorted):
    """A snapshot from build_snapshot (padded tail with dst=0); shuffled into a
    hand-built edge order when dst_sorted is False."""
    n, R, d, m = 50, 6, 16, 60
    triples = np.unique(np.stack([rng.integers(0, n, m), rng.integers(0, R, m),
                                  rng.integers(0, n, m)], axis=1), axis=0)
    snap = jax_build_snapshot(triples, n, R, edge_bucket=64, use_native=False)
    src, dst, rel, mask = snap.src, snap.dst, snap.rel, snap.edge_mask
    assert mask[-1] == 0 and dst[-1] == 0  # the padded tail breaks dst's order
    if case == "all_masked":
        mask = np.zeros_like(mask)
    if not dst_sorted:
        order = rng.permutation(len(src))
        src, dst, rel, mask = src[order], dst[order], rel[order], mask[order]
    h = rng.normal(size=(n, d)).astype(np.float32)
    rel_emb = rng.normal(size=(2 * R, d)).astype(np.float32)
    w = (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32)
    return h, rel_emb, w, src, dst, rel, mask, snap.in_deg_norm


@pytest.mark.parametrize("case", ["padded", "all_masked"])
@pytest.mark.parametrize("dst_sorted", [True, False])
def test_rgcn_aggregate_matches_jax_xla_and_pallas(rng, case, dst_sorted):
    from jax.experimental.pallas import tpu as pltpu

    args = _aggregate_inputs(rng, case, dst_sorted)
    got = rgcn_aggregate(*(t(a) for a in args[:3]), *(t(a).long() for a in args[3:6]),
                         t(args[6]), t(args[7]), dst_sorted=dst_sorted)
    jargs = [jnp.asarray(a) for a in args]
    close(got, jax_rgcn_aggregate(*jargs, impl="xla", dst_sorted=dst_sorted))
    with pltpu.force_tpu_interpret_mode():
        close(got, rgcn_aggregate_pallas(*jargs, dst_sorted=dst_sorted))
    if case == "all_masked":
        assert torch.count_nonzero(got) == 0


@pytest.mark.parametrize("case", ["padded", "all_masked"])
@pytest.mark.parametrize("dst_sorted", [True, False])
def test_rgcn_aggregate_gradients_match_jax_xla_and_pallas(rng, case, dst_sorted):
    """d(sum(out * G)) by h, rel_emb and W: the port's scatter Function
    against jax.grad of the XLA path and of the Pallas path in interpret
    mode, whose custom VJP runs _scatter_bwd."""
    from jax.experimental.pallas import tpu as pltpu

    args = _aggregate_inputs(rng, case, dst_sorted)
    G = rng.normal(size=args[0].shape).astype(np.float32)
    leaves = [t(a).requires_grad_(True) for a in args[:3]]
    out = rgcn_aggregate(*leaves, *(t(a).long() for a in args[3:6]), t(args[6]), t(args[7]),
                         dst_sorted=dst_sorted)
    got = torch.autograd.grad(out, leaves, t(G))
    jrest = [jnp.asarray(a) for a in args[3:]]

    def loss(fn, **kw):
        return lambda h, r, w: jnp.sum(fn(h, r, w, *jrest, dst_sorted=dst_sorted, **kw) * G)

    jleaves = [jnp.asarray(a) for a in args[:3]]
    want_xla = jax.jit(jax.grad(loss(jax_rgcn_aggregate, impl="xla"), argnums=(0, 1, 2)))(*jleaves)
    with pltpu.force_tpu_interpret_mode():
        want_pallas = jax.jit(jax.grad(loss(rgcn_aggregate_pallas), argnums=(0, 1, 2)))(*jleaves)
    for name, g, wx, wp in zip(("h", "rel_emb", "W"), got, want_xla, want_pallas):
        close(g, wx)
        close(g, wp)
        if case == "all_masked":
            assert torch.count_nonzero(g) == 0, name


@pytest.mark.parametrize("case", ["padded", "all_masked", "no_row_scale"])
def test_weighted_scatter_gradients_match_jax(rng, case):
    """dmsg and dw of the weighted, row-scaled scatter against jax.grad of
    the JAX scatter_add_sorted(msg * w[:, None]) times the row scale."""
    from jax.experimental.pallas import tpu as pltpu

    E, n, d = 96, 40, 8
    keys = _sorted_keys(rng, E, n, 0 if case == "all_masked" else 80)
    msg = rng.normal(size=(E, d)).astype(np.float32)
    w = rng.random(E).astype(np.float32)
    scale = None if case == "no_row_scale" else rng.random(n).astype(np.float32)
    G = rng.normal(size=(n, d)).astype(np.float32)
    leaves = [t(msg).requires_grad_(True), t(w).requires_grad_(True)]
    out = scatter_add_sorted(*leaves[:1], t(keys), n, edge_weight=leaves[1],
                             row_scale=None if scale is None else t(scale))
    got = torch.autograd.grad(out, leaves, t(G))

    def loss(m, wt):
        o = jax_scatter(m * wt[:, None], jnp.asarray(keys), n, tile_edges=32, chunk=8)
        return jnp.sum(o * (1.0 if scale is None else scale[:, None]) * G)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(msg), jnp.asarray(w))
    for g, wt in zip(got, want):
        close(g, wt)
    if case == "all_masked":
        assert torch.count_nonzero(got[0]) == 0 and torch.count_nonzero(got[1]) == 0


@pytest.mark.parametrize("weighted", [False, True])
def test_cpu_scatter_output_has_the_functions_backward(rng, weighted):
    """The CPU path's result comes out of the same autograd Function as the
    card's, so the backward tested here against JAX is the one the card runs."""
    E, n, d = 64, 30, 5
    keys = t(_sorted_keys(rng, E, n, 50))
    msg = t(rng.normal(size=(E, d)).astype(np.float32)).requires_grad_(True)
    w = t(rng.random(E).astype(np.float32)).requires_grad_(weighted)
    out = scatter_add_sorted(msg, keys, n, edge_weight=w)
    assert type(out.grad_fn).__name__ == "_ScatterAddSortedBackward"


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
def test_row_scale_that_requires_grad_raises_under_grad_mode(rng, mode):
    """No path needs a gradient for the row scale: the wrapper raises rather
    than detach it in grad mode, and runs as before in the eval loop's modes."""
    E, n, d = 64, 30, 5
    keys = t(_sorted_keys(rng, E, n, 50))
    msg = t(rng.normal(size=(E, d)).astype(np.float32))
    scale = t(rng.random(n).astype(np.float32)).requires_grad_(True)
    if mode == "grad":
        with pytest.raises(ValueError, match="row_scale"):
            scatter_add_sorted(msg, keys, n, row_scale=scale)
        return
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    with ctx:
        got = scatter_add_sorted(msg, keys, n, row_scale=scale)
    assert torch.equal(got, scatter_add_sorted_reference(msg, keys, n, None, scale.detach()))
