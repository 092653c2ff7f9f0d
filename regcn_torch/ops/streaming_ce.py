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
device memory. On a CPU tensor it runs the plain version,
:func:`streaming_nll_reference` (dense logits, ``logsumexp``, autograd).
There is no switch that sends a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from regcn_torch.ops import cuda_build

SCORE_EPS = 1e-6  # ref SCORE_SCALE_EPSILON
TILE = 64  # queries and candidates per kernel tile
BWD_X_ROWS = 32  # queries per tile of the candidate-side backward's walk
MAX_CLUSTER = 8  # blocks of one candidate tile in the candidate-side backward
MAX_D = 256  # widest embedding the kernels take
# blocks of each kernel that fit on an SM (shared memory: ~105 KB forward,
# ~125 KB backward at d = 200); splits are sized to fill the SMs in one wave
_FWD_BLOCKS_PER_SM, _BWD_BLOCKS_PER_SM = 2, 1
_INT_MAX = 2**31 - 1


# ------------------------------------------------------------- plain version

def mobius_diff_norm_sq(query, candidates, c, eps: float = SCORE_EPS) -> torch.Tensor:
    """[B, N] ||mobius_add(-q, x)||^2 from one GEMM; c is a scalar or [B, 1]."""
    p = query @ candidates.T
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


def streaming_nll_reference(q, x, bias, target, cq, scale, margin,
                            true_dist: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernels, on any device: per-query NLL
    [B] from dense logits; gradients by autograd."""
    logits = distance_logits(q, x, cq[:, None], bias=bias, scale=scale, margin=margin,
                             true_dist=true_dist)
    lse = torch.logsumexp(logits, dim=1)
    return lse - logits.gather(1, target.long()[:, None])[:, 0]


# ------------------------------------------------------------------ kernels

@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("streaming_ce")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.streaming_ce_forward.argtypes = [ptr] * 11 + [i32] * 6 + [ptr]
    lib.streaming_ce_backward_q.argtypes = [ptr] * 17 + [i32] * 6 + [ptr]
    lib.streaming_ce_backward_x.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
    lib.streaming_ce_backward_x_occupancy.argtypes = [i32] * 3 + [ptr] * 2
    for fn in (lib.streaming_ce_forward, lib.streaming_ce_backward_q,
               lib.streaming_ce_backward_x, lib.streaming_ce_backward_x_occupancy):
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
    """``n`` int32 zeros for one kernel to find the last block of a tile;
    every launch leaves them at zero again. One buffer per device with a
    slot per kernel, grown on demand; launches of one kernel that share
    its slot run on one stream, one after another."""
    buf = _counters.get(device)
    if buf is None or buf.shape[1] < n:
        buf = torch.zeros((len(_KERNEL_SLOT), max(n, 1024)), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf[_KERNEL_SLOT[kernel]]


def _splits(tiles: int, other_tiles: int, blocks_per_sm: int, device: torch.device
            ) -> Tuple[int, int]:
    """(splits, tiles per split) of an axis of ``tiles`` tiles, with
    ``other_tiles`` blocks along the other axis: as many splits as one
    wave of ``blocks_per_sm`` blocks on every SM holds."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = min(tiles, max(1, blocks_per_sm * sms // other_tiles))
    per = -(-tiles // want)
    return -(-tiles // per), per


def ce_forward(q, x, bias, cq, target, scale, margin, true_dist: bool):
    """Launches the forward kernel: returns (nll [B], lse [B])."""
    B, d = q.shape
    N = x.shape[0]
    q_tiles = -(-B // TILE)
    splits, per = _splits(-(-N // TILE), q_tiles, _FWD_BLOCKS_PER_SM, q.device)
    part = torch.empty((3, splits, B), dtype=torch.float32, device=q.device)
    nll = torch.empty(B, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, dtype=torch.float32, device=q.device)
    counters = _counters_for("forward", q.device, q_tiles)
    with torch.cuda.device(q.device):
        err = _kernel_lib().streaming_ce_forward(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), cq.data_ptr(), target.data_ptr(),
            scale.data_ptr(), margin.data_ptr(), part.data_ptr(), nll.data_ptr(),
            lse.data_ptr(), counters.data_ptr(), B, N, d, splits, per, int(true_dist),
            _stream(q))
    _raise_on(err, "streaming_ce_forward")
    ce_forward.launches += 1
    return nll, lse


def ce_backward_q(q, x, bias, cq, target, scale, margin, lse, g, true_dist: bool):
    """Launches the query-side backward kernel: (dq [B,d], dc [B], dscale, dmargin)."""
    B, d = q.shape
    N = x.shape[0]
    q_tiles = -(-B // TILE)
    splits, per = _splits(-(-N // TILE), q_tiles, _BWD_BLOCKS_PER_SM, q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_part = torch.empty((splits, B, d), **f32)
    rows_part = torch.empty((2, splits, B), **f32)
    scal_part = torch.empty((q_tiles * splits, 2), **f32)
    dq, dc = torch.empty((B, d), **f32), torch.empty(B, **f32)
    dscale, dmargin = torch.empty((), **f32), torch.empty((), **f32)
    counters = _counters_for("backward_q", q.device, q_tiles + 1)
    with torch.cuda.device(q.device):
        err = _kernel_lib().streaming_ce_backward_q(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), cq.data_ptr(), target.data_ptr(),
            scale.data_ptr(), margin.data_ptr(), lse.data_ptr(), g.data_ptr(),
            dq_part.data_ptr(), rows_part.data_ptr(), scal_part.data_ptr(), dq.data_ptr(),
            dc.data_ptr(), dscale.data_ptr(), dmargin.data_ptr(), counters.data_ptr(),
            B, N, d, splits, per, int(true_dist), _stream(q))
    _raise_on(err, "streaming_ce_backward_q")
    ce_backward_q.launches += 1
    return dq, dc, dscale, dmargin


@functools.cache
def _backward_x_occupancy(device: torch.device, d: int, cluster: int, true_dist: bool
                          ) -> Tuple[int, int]:
    """(blocks per SM, clusters resident at once) of the candidate-side backward."""
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _kernel_lib().streaming_ce_backward_x_occupancy(
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
        err = _kernel_lib().streaming_ce_backward_x(
            q.data_ptr(), x.data_ptr(), bias.data_ptr(), cq.data_ptr(), target.data_ptr(),
            scale.data_ptr(), margin.data_ptr(), lse.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dbias.data_ptr(), B, N, d, splits, int(true_dist), _stream(q))
    _raise_on(err, "streaming_ce_backward_x")
    ce_backward_x.launches += 1
    return dx, dbias


ce_forward.launches = 0
ce_backward_q.launches = 0
ce_backward_x.launches = 0


class _StreamingNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, x, bias, cq, scale, margin, target, true_dist):
        nll, lse = ce_forward(q, x, bias, cq, target, scale, margin, true_dist)
        ctx.save_for_backward(q, x, bias, cq, scale, margin, target, lse)
        ctx.true_dist = true_dist
        return nll

    @staticmethod
    def backward(ctx, g):
        q, x, bias, cq, scale, margin, target, lse = ctx.saved_tensors
        g = g.contiguous()
        dq, dc, dscale, dmargin = ce_backward_q(q, x, bias, cq, target, scale, margin, lse, g,
                                                ctx.true_dist)
        dx, dbias = ce_backward_x(q, x, bias, cq, target, scale, margin, lse, g, ctx.true_dist)
        return dq, dx, dbias, dc, dscale, dmargin, None, None


def _check(name, t, shape, dtype, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
                         f"on {device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def streaming_nll(q, x, bias, target, cq, scale, margin, true_dist: bool = False) -> torch.Tensor:
    """Per-query NLL [B] over all N candidates, differentiable in q [B,d],
    x [N,d], bias [N], cq [B] (per-query curvature), scale and margin
    (0-d tensors). target [B] holds candidate indices.

    On a CUDA tensor this runs the kernels (each wrapper counts its
    launches in ``.launches``); on a CPU tensor, the plain version."""
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"q [B, d] and x [N, d] must share d; got {tuple(q.shape)} and "
                         f"{tuple(x.shape)}")
    (B, d), N = q.shape, x.shape[0]
    dev = q.device
    for name, t, shape in (("q", q, (B, d)), ("x", x, (N, d)), ("bias", bias, (N,)),
                           ("cq", cq, (B,)), ("scale", scale, ()), ("margin", margin, ())):
        _check(name, t, shape, torch.float32, dev)
    if dev.type == "cpu":
        return streaming_nll_reference(q, x, bias, target, cq, scale, margin, true_dist)
    if dev.type != "cuda":
        raise ValueError(f"streaming_nll runs on cuda or cpu, not {dev}")
    target = target.to(torch.int32).contiguous()
    _check("target", target, (B,), torch.int32, dev)
    if B == 0 or N == 0 or d == 0 or d > MAX_D or d % 4 or max(B, N) * d > _INT_MAX:
        raise ValueError(f"the kernels take B, N > 0 and 0 < d <= {MAX_D}, a multiple of 4; got "
                         f"B={B} N={N} d={d}")
    if q.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("the kernels load rows of q and x as float4: both must be 16-byte aligned")
    return _StreamingNLL.apply(q, x, bias, cq, scale, margin, target, bool(true_dist))
