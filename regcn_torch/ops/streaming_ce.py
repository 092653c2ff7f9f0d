"""Cross-entropy over Möbius-distance logits against every candidate.

Counterpart of ``regcn_tpu/ops/pallas_scoring.py`` (kernel B2:
``_ce_kernel`` with the custom VJP ``_streaming_nll``) and of the dense
``regcn_tpu/hyperbolic/decoders.py:dist_ce_loss(streaming=False)``. Per
query i and candidate j,

    logit_ij = scale * (margin - dist_c(q_i, x_j)) + bias_j
    nll_i    = logsumexp_j logit_ij - logit_{i, target_i}

with dist the clamped squared norm of the Möbius difference (proxy) or
the true distance ``2/sqrt(c) artanh(sqrt(c) |.|)`` under a per-query
curvature c_i (see :func:`distance_logits`).

On a CUDA tensor, :func:`streaming_nll` runs the hand-written kernels of
``regcn_torch/csrc/streaming_ce.cu`` behind a ``torch.autograd.Function``
whose backward is two kernels as well; the [B, N] logits never reach
device memory. On a CPU tensor the same Function runs the plain versions
(:func:`ce_forward_plain`, and autograd through
:func:`streaming_nll_reference` for the backward). There is no switch
that sends a CUDA tensor to a plain version. The Functions are new-style
(``setup_context`` and a ``vmap`` rule), so B2 composes with
``torch.func``: under ``vmap`` over K models each kernel runs once per
model.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from regcn_torch.ops import cuda_build, rgcn_scatter
from regcn_torch.utils.dtypes import dot_f32

SCORE_EPS = 1e-6  # ref SCORE_SCALE_EPSILON
TILE = 64  # queries and candidates per tile of the backward kernels' clusters
FWD_ROWS = 16  # candidates per tile of the forward's walk
BWD_X_ROWS = 32  # queries per tile of the candidate-side backward's walk
BWD_Q_ROWS = 32  # candidates per tile of the query-side backward's walk
MAX_CLUSTER = 8  # blocks of one candidate tile in the candidate-side backward
MAX_CLUSTER_Q = 16  # blocks of one query tile in the query-side backward
MAX_D = 512  # widest embedding the kernels take
# widest of the first library's instances; wider ones are in the second
# (cuda_build.VARIANTS), which builds in parallel with it
NARROW_D = 256
_INT_MAX = 2**31 - 1


# ------------------------------------------------------------- plain version

def mobius_diff_norm_sq(query, candidates, c, eps: float = SCORE_EPS) -> torch.Tensor:
    """[B, N] ||mobius_add(-q, x)||^2 from one GEMM (fp32 products); c is a
    scalar or [B, 1]."""
    p = dot_f32(query, candidates.T)
    qq = torch.sum(query * query, dim=-1, keepdim=True)
    xx = torch.sum(candidates * candidates, dim=-1)[None, :]
    A = 1.0 - 2.0 * c * p + c * xx
    B = 1.0 - c * qq
    D = 1.0 - 2.0 * c * p + (c * c) * qq * xx + eps
    num_sq = A * A * qq - 2.0 * A * B * p + B * B * xx
    return torch.maximum(num_sq, num_sq.new_zeros(())) / (D * D)


def distance_logits(query, candidates, c, *, bias=None, scale=None, margin=0.0,
                    true_dist: bool = False) -> torch.Tensor:
    """[B, N] ``scale * (margin - dist) + bias``; c is a scalar or [B, 1].

    ``true_dist=False``: dist = the squared Möbius-difference norm,
    clamped to the ball; ``True``: the geodesic distance under c."""
    diff_sq = mobius_diff_norm_sq(query, candidates, c)
    if not isinstance(c, torch.Tensor):
        c = diff_sq.new_full((), c)
    if true_dist:
        sqrt_c = torch.sqrt(c + SCORE_EPS)
        diff_norm = torch.sqrt(torch.maximum(diff_sq, diff_sq.new_full((), SCORE_EPS ** 2)))
        diff_norm = torch.minimum(diff_norm, 1.0 / (sqrt_c + SCORE_EPS) - SCORE_EPS)
        z = torch.minimum(sqrt_c * diff_norm, diff_sq.new_full((), 1.0 - SCORE_EPS))
        block = margin - (2.0 / (sqrt_c + SCORE_EPS)) * torch.atanh(z)
    else:
        max_norm = 1.0 / torch.sqrt(c) - 2 * SCORE_EPS
        block = margin - torch.minimum(diff_sq, max_norm * max_norm)
    if scale is not None:
        block = scale * block
    if bias is not None:
        block = block + bias[None, :]
    return block


def ce_forward_plain(q, x, bias, cq, target, scale, margin, true_dist: bool = False):
    """The forward kernel's plain version, on any device: (nll [B], lse [B])
    from dense logits."""
    logits = distance_logits(q, x, cq[:, None], bias=bias, scale=scale, margin=margin,
                             true_dist=true_dist)
    lse = torch.logsumexp(logits, dim=1)
    return lse - logits.gather(1, target.long()[:, None])[:, 0], lse


def streaming_nll_reference(q, x, bias, target, cq, scale, margin,
                            true_dist: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernels, on any device: per-query NLL
    [B] from dense logits; gradients by autograd."""
    return ce_forward_plain(q, x, bias, cq, target, scale, margin, true_dist)[0]


# ------------------------------------------------------------------ kernels

def _lib(d: int) -> ctypes.CDLL:
    """The library whose instances take width ``d``."""
    return _kernel_lib(d > NARROW_D)


@functools.cache
def _kernel_lib(wide: bool = False) -> ctypes.CDLL:
    lib = cuda_build.load("streaming_ce_wide" if wide else "streaming_ce")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.streaming_ce_forward.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
    lib.streaming_ce_backward_q.argtypes = [ptr] * 17 + [i32] * 6 + [ptr]
    lib.streaming_ce_backward_x.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
    lib.streaming_ce_forward_occupancy.argtypes = [i32] * 2 + [ptr] * 3
    lib.streaming_ce_backward_q_occupancy.argtypes = [i32] * 3 + [ptr] * 2
    lib.streaming_ce_backward_x_occupancy.argtypes = [i32] * 3 + [ptr] * 2
    for fn in (lib.streaming_ce_forward, lib.streaming_ce_backward_q,
               lib.streaming_ce_backward_x, lib.streaming_ce_forward_occupancy,
               lib.streaming_ce_backward_q_occupancy, lib.streaming_ce_backward_x_occupancy):
        fn.restype = ctypes.c_int
    lib.streaming_ce_error_string.argtypes = [i32]
    lib.streaming_ce_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _kernel_lib().streaming_ce_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_counters: dict = {}
_KERNEL_SLOT = {"forward": 0, "backward_q": 1}


def _counters_for(kernel: str, device: torch.device, n: int) -> torch.Tensor:
    """``n`` int32 zeros for one kernel to find the last block (or cluster);
    every launch leaves them at zero again. One buffer per device with a
    slot per kernel, grown on demand; launches of one kernel that share
    its slot run on one stream, one after another."""
    buf = _counters.get(device)
    if buf is None or buf.shape[1] < n:
        buf = torch.zeros((len(_KERNEL_SLOT), max(n, 1024)), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf[_KERNEL_SLOT[kernel]]


@functools.cache
def _forward_occupancy(device: torch.device, d: int, true_dist: bool) -> Tuple[int, int, int]:
    """(queries per block, blocks per SM, SMs of the card) of the forward."""
    queries, per_sm, sms = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib(d).streaming_ce_forward_occupancy(
            d, int(true_dist), ctypes.addressof(queries), ctypes.addressof(per_sm),
            ctypes.addressof(sms))
    _raise_on(err, "streaming_ce_forward_occupancy")
    return queries.value, per_sm.value, sms.value


def forward_plan(B: int, N: int, d: int, true_dist: bool, device: torch.device,
                 splits: int = 0) -> dict:
    """The forward's launch: per tile of ``queries`` queries (the kernel's
    128), ``splits`` blocks that cut the 16-row candidate tiles evenly.
    ``splits=0`` takes as many as one wave of resident blocks holds over the
    query tiles, then the fewest that keep each block's share of tiles."""
    queries, per_sm, sms = _forward_occupancy(device, d, true_dist)
    q_tiles, c_tiles = -(-B // queries), -(-N // FWD_ROWS)
    if not splits:
        per = -(-c_tiles // min(c_tiles, max(1, per_sm * sms // q_tiles)))
        splits = -(-c_tiles // per)
    return dict(grid=q_tiles * splits, queries=queries, splits=splits, blocks_per_sm=per_sm,
                candidate_tiles_per_block=-(-c_tiles // splits))


def ce_forward(q, x, bias, cq, target, scale, margin, true_dist: bool, splits: int = 0):
    """Launches the forward kernel: returns (nll [B], lse [B]). ``splits``
    (blocks per query tile; 0 = chosen by :func:`forward_plan`) changes the
    sums' order, not their terms."""
    B, d = q.shape
    N = x.shape[0]
    plan = forward_plan(B, N, d, true_dist, q.device, splits)
    splits = plan["splits"]
    part = torch.empty((3, splits, B), dtype=torch.float32, device=q.device)
    nll = torch.empty(B, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, dtype=torch.float32, device=q.device)
    counters = _counters_for("forward", q.device, -(-B // plan["queries"]))
    with torch.cuda.device(q.device):
        err = _lib(d).streaming_ce_forward(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), cq.data_ptr(), target.data_ptr(),
            scale.data_ptr(), margin.data_ptr(), part.data_ptr(), nll.data_ptr(),
            lse.data_ptr(), counters.data_ptr(), B, N, d, splits, int(true_dist), _stream(q))
    _raise_on(err, "streaming_ce_forward")
    ce_forward.launches += 1
    return nll, lse


@functools.cache
def _backward_q_occupancy(device: torch.device, d: int, cluster: int, true_dist: bool
                          ) -> Tuple[int, int]:
    """(blocks per SM, clusters resident at once) of the query-side backward;
    0 clusters if none of this size fits the card."""
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib(d).streaming_ce_backward_q_occupancy(
            d, cluster, int(true_dist), ctypes.addressof(per_sm), ctypes.addressof(clusters))
    _raise_on(err, "streaming_ce_backward_q_occupancy")
    return per_sm.value, clusters.value


def backward_q_plan(B: int, N: int, d: int, true_dist: bool, device: torch.device,
                    cluster: int = 0, splits: int = 0) -> dict:
    """The query-side backward's launch: per 64 queries, ``splits`` clusters
    of ``cluster`` blocks, which cut the 32-row candidate tiles between them.
    For each size, ``splits`` defaults to as many clusters as the card holds
    at once over the query tiles (at most one split per block's tile);
    ``cluster=0`` picks the size whose busiest SM walks the fewest candidate
    tiles (waves of resident clusters times tiles per block), then the
    fewest splits (partials merged through device memory), then the smallest
    size. A size of which no cluster fits the card is never picked."""
    q_tiles, c_tiles = -(-B // TILE), -(-N // BWD_Q_ROWS)

    def launch(size: int) -> tuple:
        """(tiles on the busiest SM, splits, size) of clusters of ``size``."""
        clusters = _backward_q_occupancy(device, d, size, true_dist)[1]
        n = splits or max(1, min(-(-c_tiles // size), clusters // q_tiles))
        cost = -(-q_tiles * n // clusters) * -(-c_tiles // (n * size)) if clusters else math.inf
        return cost, n, size

    if cluster:
        _, n, cluster = launch(cluster)
    else:
        _, n, cluster = min(launch(size) for size in range(1, min(MAX_CLUSTER_Q, c_tiles) + 1))
    per_sm, clusters = _backward_q_occupancy(device, d, cluster, true_dist)
    return dict(grid=q_tiles * n * cluster, cluster=cluster, splits=n, blocks_per_sm=per_sm,
                active_clusters=clusters,
                candidate_tiles_per_block=-(-c_tiles // (n * cluster)))


def ce_backward_q(q, x, bias, cq, target, scale, margin, lse, g, true_dist: bool,
                  cluster: int = 0, splits: int = 0):
    """Launches the query-side backward kernel: (dq [B,d], dc [B], dscale,
    dmargin). ``cluster`` (1 to 16 blocks) and ``splits`` (clusters per 64
    queries; 0 = chosen by :func:`backward_q_plan`) change the sums' order,
    not their terms."""
    B, d = q.shape
    N = x.shape[0]
    plan = backward_q_plan(B, N, d, true_dist, q.device, cluster, splits)
    cluster, splits = plan["cluster"], plan["splits"]
    q_tiles = -(-B // TILE)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_part, rows_part = torch.empty((splits, B, d), **f32), torch.empty((2, splits, B), **f32)
    scal_part = torch.empty((q_tiles * splits, 2), **f32)
    dq, dc = torch.empty((B, d), **f32), torch.empty(B, **f32)
    dscale, dmargin = torch.empty((), **f32), torch.empty((), **f32)
    counters = _counters_for("backward_q", q.device, q_tiles + 1)
    with torch.cuda.device(q.device):
        err = _lib(d).streaming_ce_backward_q(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), cq.data_ptr(), target.data_ptr(),
            scale.data_ptr(), margin.data_ptr(), lse.data_ptr(), g.data_ptr(),
            dq_part.data_ptr(), rows_part.data_ptr(), scal_part.data_ptr(), dq.data_ptr(),
            dc.data_ptr(), dscale.data_ptr(), dmargin.data_ptr(), counters.data_ptr(), B, N, d,
            cluster, splits, int(true_dist), _stream(q))
    _raise_on(err, "streaming_ce_backward_q")
    ce_backward_q.launches += 1
    return dq, dc, dscale, dmargin


@functools.cache
def _backward_x_occupancy(device: torch.device, d: int, cluster: int, true_dist: bool
                          ) -> Tuple[int, int]:
    """(blocks per SM, clusters resident at once) of the candidate-side backward."""
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _lib(d).streaming_ce_backward_x_occupancy(
            d, cluster, int(true_dist), ctypes.addressof(per_sm), ctypes.addressof(clusters))
    _raise_on(err, "streaming_ce_backward_x_occupancy")
    return per_sm.value, clusters.value


def backward_x_plan(B: int, N: int, d: int, true_dist: bool, device: torch.device,
                    cluster: int = 0) -> dict:
    """The candidate-side backward's launch: one cluster of ``cluster`` blocks
    per 64 candidates, the blocks splitting the query tiles. ``cluster=0``
    picks the size whose busiest SM walks the fewest query tiles (waves of
    resident clusters times tiles per block), the smallest such size."""
    c_tiles, q_tiles = -(-N // TILE), -(-B // BWD_X_ROWS)

    def tiles_on_busiest_sm(size: int) -> int:
        clusters = _backward_x_occupancy(device, d, size, true_dist)[1]
        return -(-c_tiles // max(clusters, 1)) * -(-q_tiles // size)

    if not cluster:
        cluster = min(range(1, min(MAX_CLUSTER, q_tiles) + 1), key=tiles_on_busiest_sm)
    per_sm, clusters = _backward_x_occupancy(device, d, cluster, true_dist)
    return dict(grid=c_tiles * cluster, cluster=cluster, blocks_per_sm=per_sm,
                active_clusters=clusters, query_tiles_per_block=-(-q_tiles // cluster))


def ce_backward_x(q, x, bias, cq, target, scale, margin, lse, g, true_dist: bool,
                  cluster: int = 0):
    """Launches the candidate-side backward kernel: (dx [N,d], dbias [N]).
    ``cluster`` (1 to 8 blocks per candidate tile; 0 = chosen by
    :func:`backward_x_plan`) changes the sums' order, not their terms."""
    B, d = q.shape
    N = x.shape[0]
    splits = backward_x_plan(B, N, d, true_dist, q.device, cluster)["cluster"]
    f32 = dict(dtype=torch.float32, device=q.device)
    dx, dbias = torch.empty((N, d), **f32), torch.empty(N, **f32)
    with torch.cuda.device(q.device):
        err = _lib(d).streaming_ce_backward_x(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), cq.data_ptr(), target.data_ptr(),
            scale.data_ptr(), margin.data_ptr(), lse.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dbias.data_ptr(), B, N, d, splits, int(true_dist), _stream(q))
    _raise_on(err, "streaming_ce_backward_x")
    ce_backward_x.launches += 1
    return dx, dbias


ce_forward.launches = 0
ce_backward_q.launches = 0
ce_backward_x.launches = 0


def _aligned(q, x) -> None:
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("the kernels load rows of q and x as float4: both must be 16-byte aligned")


def _plain_vjp(q, x, bias, cq, target, scale, margin, g, true_dist: bool):
    """(dq, dx, dbias, dc, dscale, dmargin) of ``sum(g * nll)``, by autograd
    through :func:`streaming_nll_reference`: the backward kernels' plain
    version."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (q, x, bias, cq, scale, margin)]
        nll = streaming_nll_reference(ins[0], ins[1], ins[2], target, ins[3], ins[4], ins[5],
                                      true_dist)
        return torch.autograd.grad(nll, ins, g)


def _per_slice(fn, info, in_dims, args):
    """``fn.apply`` once per model of a ``vmap`` (B2's queries and
    candidates both differ per model, so nothing folds); the outputs
    stacked on a new leading axis."""
    def pick(a, dim, i):
        if dim is None or not isinstance(a, torch.Tensor):
            return a
        return a.select(dim, i).contiguous()

    outs = [fn.apply(*(pick(a, d, i) for a, d in zip(args, in_dims)))
            for i in range(info.batch_size)]
    stacked = tuple(torch.stack(o) for o in zip(*outs))
    return stacked, (0,) * len(stacked)


class _BackwardKernel(torch.autograd.Function):
    """A backward kernel of B2 as a Function: the kernel on a CUDA tensor,
    the plain version on a CPU tensor, once per model under ``vmap``; not
    differentiable itself."""

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(*output)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("B2's backward kernels have no gradient of their own")


class _BackwardQ(_BackwardKernel):
    """The query-side backward: (dq, dc, dscale, dmargin)."""

    @staticmethod
    def forward(q, x, bias, cq, target, scale, margin, lse, g, true_dist):
        if q.device.type == "cuda":
            _aligned(q, x)
            return ce_backward_q(q, x, bias, cq, target, scale, margin, lse, g, true_dist)
        dq, _, _, dc, dscale, dmargin = _plain_vjp(q, x, bias, cq, target, scale, margin, g,
                                                   true_dist)
        return dq, dc, dscale, dmargin

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_slice(_BackwardQ, info, in_dims, args)


class _BackwardX(_BackwardKernel):
    """The candidate-side backward: (dx, dbias)."""

    @staticmethod
    def forward(q, x, bias, cq, target, scale, margin, lse, g, true_dist):
        if q.device.type == "cuda":
            _aligned(q, x)
            return ce_backward_x(q, x, bias, cq, target, scale, margin, lse, g, true_dist)
        _, dx, dbias, _, _, _ = _plain_vjp(q, x, bias, cq, target, scale, margin, g, true_dist)
        return dx, dbias

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_slice(_BackwardX, info, in_dims, args)


class _StreamingNLL(torch.autograd.Function):
    """B2 as a new-style Function, so that it composes with ``torch.func``:
    forward (nll, lse), the kernel on a CUDA tensor and the plain version on
    a CPU tensor; the backward through :class:`_BackwardQ` and
    :class:`_BackwardX`, which reach their own ``vmap`` rules with plain
    tensors; under ``vmap``, one launch per model."""

    @staticmethod
    def forward(q, x, bias, cq, scale, margin, target, true_dist):
        if q.device.type == "cuda":
            _aligned(q, x)
            return ce_forward(q, x, bias, cq, target, scale, margin, true_dist)
        return ce_forward_plain(q, x, bias, cq, target, scale, margin, true_dist)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, x, bias, cq, scale, margin, target, true_dist = inputs
        lse = output[1]
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, x, bias, cq, scale, margin, target, lse)
        ctx.true_dist = true_dist

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, x, bias, cq, scale, margin, target, lse = ctx.saved_tensors
        args = (q, x, bias, cq, target, scale, margin, lse, g.contiguous(), ctx.true_dist)
        dq, dc, dscale, dmargin = _BackwardQ.apply(*args)
        dx, dbias = _BackwardX.apply(*args)
        return dq, dx, dbias, dc, dscale, dmargin, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        return _per_slice(_StreamingNLL, info, in_dims, args)


def _check(name, t, shape, dtype, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
                         f"on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def check_width(d: int, device) -> None:
    """Raises ``ValueError`` where the kernels do not take embedding width
    ``d`` on ``device`` (above :data:`MAX_D` on a CUDA device; the plain
    version takes any width): the trainers call it at construction, so
    that no epoch stops at its first step."""
    if torch.device(device).type == "cuda" and not 0 < d <= MAX_D:
        raise ValueError(f"kernel B2 (streaming_ce.cu) takes embedding widths up to {MAX_D} on "
                         f"the card; got d={d}")


def streaming_nll(q, x, bias, target, cq, scale, margin, true_dist: bool = False) -> torch.Tensor:
    """Per-query NLL [B] over all N candidates, differentiable in q [B,d],
    x [N,d], bias [N], cq [B] (per-query curvature), scale and margin
    (0-d tensors). target [B] holds candidate indices.

    On a CUDA tensor this runs the kernels (each wrapper counts its
    launches in ``.launches``); on a CPU tensor, their plain versions.
    Either way through :class:`_StreamingNLL`, so it composes with
    ``torch.func``: under ``vmap`` over K models each kernel launches K
    times. A width that is not a multiple of 4 is zero-padded to the next
    one on both devices (the kernels load rows as float4): the kernels see
    q and x only through q.x, |q|^2 and |x|^2, to which zero columns add
    nothing, and autograd drops the padded columns' gradients. The padded
    copies are fresh, so 16-byte aligned."""
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"q [B, d] and x [N, d] must share d; got {tuple(q.shape)} and "
                         f"{tuple(x.shape)}")
    (B, d), N = q.shape, x.shape[0]
    dev = q.device
    for name, t, shape in (("q", q, (B, d)), ("x", x, (N, d)), ("bias", bias, (N,)),
                           ("cq", cq, (B,)), ("scale", scale, ()), ("margin", margin, ())):
        _check(name, t, shape, torch.float32, dev)
    if dev.type not in rgcn_scatter.devices():
        raise ValueError(f"streaming_nll runs on cuda or cpu, not {dev}")
    target = target.to(torch.int32).contiguous()
    _check("target", target, (B,), torch.int32, dev)
    d4 = -(-d // 4) * 4
    if dev.type == "cuda" and (B == 0 or N == 0 or d == 0 or d > MAX_D
                               or max(B, N) * d4 > _INT_MAX):
        raise ValueError(f"the kernels take B, N > 0 and 0 < d <= {MAX_D}; got B={B} N={N} d={d}")
    if d4 != d:
        q, x = F.pad(q, (0, d4 - d)), F.pad(x, (0, d4 - d))
    return _StreamingNLL.apply(q, x, bias, cq, scale, margin, target, bool(true_dist))[0]
