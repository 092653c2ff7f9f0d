"""RGCN edge aggregation: gather -> (h_src + rel) @ W -> sorted scatter-sum.

Counterpart of ``regcn_tpu/ops/rgcn_scatter.py:rgcn_aggregate`` and of
the Pallas scatter in ``regcn_tpu/ops/pallas_rgcn.py``. Per snapshot
graph with E directed edges over N entities,

    msg_e = (H[src_e] + Rel[rel_e]) @ W            # one [E,d]x[d,d] GEMM
    out_v = in_deg_norm_v * sum_{e: dst_e=v} mask_e * w_e * msg_e   # w_e = 1 unless given

The GEMM is a library product (the JAX package also leaves it to XLA
outside its kernel) with an fp32 result in every compute dtype
(``regcn_torch/utils/dtypes.py:dot_f32``: under bf16 compute, the bf16
tensor-core GEMM with an fp32 output on the card, the fp32 product of the
bf16 values on the CPU), as JAX's ``preferred_element_type=float32``.
The mask, the edge weight and the in-degree norm enter the scatter in
fp32, and the sum returns in the compute dtype of ``h``. The scatter is
the hand-written CUDA kernel
``regcn_torch/csrc/rgcn_scatter.cu`` on a CUDA tensor, and its plain
version :func:`scatter_add_sorted_reference` on a CPU tensor. There is
no switch that sends a CUDA tensor to the plain version. ``impl="cumsum"``
is JAX's other single-device route, a cumulative sum over the
destination-sorted messages (:func:`rgcn_aggregate_cumsum`), plain torch
on both devices: no Pallas kernel stands behind it.

Both devices differentiate the scatter through one
``torch.autograd.Function`` whose backward is plain torch indexing: the
counterpart of ``regcn_tpu/ops/pallas_rgcn.py:_scatter_bwd``, a gather
``g[dst] * [dst < N]`` that XLA runs, not a Pallas kernel. With the
edge weight and row scale folded in as the forward folds them,

    gk_e   = row_scale[key_e] * g[key_e]  (0 for a masked edge, key_e == n)
    dmsg_e = w_e * gk_e
    dw_e   = <gk_e, msg_e>                (only when the weight needs it)

``row_scale`` gets no gradient: the in-degree norm is data in both
packages, so a ``row_scale`` that requires grad raises under grad mode.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch

from regcn_torch.dist import is_sharded
from regcn_torch.ops import cuda_build
from regcn_torch.utils.dtypes import dot_f32

_INT_MAX = 2**31 - 1
IMPLS = ("xla", "pallas", "cumsum")
_MAX_EDGES = 2**24  # the kernel's per-row counters hold chunk ids below 2^19


@functools.cache
def _kernel_lib() -> ctypes.CDLL:
    lib = cuda_build.load("rgcn_scatter")
    lib.rgcn_scatter_sorted.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.rgcn_scatter_sorted.restype = ctypes.c_int
    lib.rgcn_scatter_chunk_edges.argtypes = []
    lib.rgcn_scatter_chunk_edges.restype = ctypes.c_int
    lib.chunk_edges = lib.rgcn_scatter_chunk_edges()
    lib.rgcn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rgcn_cuda_error_string.restype = ctypes.c_char_p
    return lib


_counters: dict = {}
_shape_runs = [0]  # open shape_run() blocks


@contextlib.contextmanager
def shape_run():
    """Inside the block the kernels' wrappers (B1's here, B2's in
    ``streaming_ce``) take ``meta`` tensors, through their plain versions:
    shapes only, nothing launched. The vectorized sweep lists a step's
    dropout draws so; outside it a meta tensor is refused."""
    _shape_runs[0] += 1
    try:
        yield
    finally:
        _shape_runs[0] -= 1


def devices() -> tuple:
    """The device types the wrappers take here: cuda and cpu, and meta
    inside :func:`shape_run`."""
    return ("cpu", "cuda", "meta") if _shape_runs[0] else ("cpu", "cuda")


def _counters_for(device: torch.device, n: int) -> torch.Tensor:
    """``n`` 64-bit zeros, one per row, by which the kernel finds the chunk
    that merges a row cut by chunk boundaries; every launch leaves them at
    zero again. One buffer per device, grown on demand; launches that share
    it run on one stream, one after another."""
    buf = _counters.get(device)
    if buf is None or buf.shape[0] < n:
        buf = torch.zeros(max(n, 8192), dtype=torch.int64, device=device)
        _counters[device] = buf
    return buf


def _check_vector(name: str, t: Optional[torch.Tensor], length: int, dtype, device) -> None:
    if t is None:
        return
    if t.dtype != dtype or t.shape != (length,) or not t.is_contiguous() or t.device != device:
        raise ValueError(
            f"{name} must be a contiguous {dtype} vector of length {length} on {device}; "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def scatter_add_sorted_reference(
    msg: torch.Tensor, keys: torch.Tensor, n: int,
    edge_weight: Optional[torch.Tensor] = None, row_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the scatter kernel, on any device.

    ``out[v] = row_scale[v] * sum_{e: keys[e] == v} edge_weight[e] * msg[e]``
    for v < n; keys lie in [0, n], and key n (a masked edge) lands in a
    spare row that is dropped.
    """
    if edge_weight is not None:
        msg = msg * edge_weight[:, None]
    out = msg.new_zeros((n + 1, msg.shape[1])).index_add_(0, keys, msg)[:n]
    if row_scale is not None:
        out = out * row_scale[:, None]
    return out


def scatter_add_sorted_backward(
    g: torch.Tensor, keys: torch.Tensor, n: int, edge_weight: Optional[torch.Tensor],
    row_scale: Optional[torch.Tensor], msg: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dmsg [E, d], dw [E] or None) of the scatter, given the gradient g
    [n, d] of its output: the gather of ``_scatter_bwd``, clamped and
    masked as JAX does, with w and row_scale folded in; dw only if msg is
    given. The same plain torch code on both devices."""
    gs = g if row_scale is None else g * row_scale[:, None]
    if n == 0:
        gk = g.new_zeros((keys.shape[0], g.shape[1]))
    else:
        gk = torch.where((keys < n)[:, None], gs.index_select(0, keys.clamp(max=n - 1)), 0.0)
    dmsg = gk if edge_weight is None else gk * edge_weight[:, None]
    dw = None if msg is None else (gk * msg).sum(dim=1)
    return dmsg, dw


def _scatter_forward(msg, keys, n, edge_weight, row_scale) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor (and
    on a ``meta`` tensor inside :func:`shape_run`)."""
    num_edges, d = msg.shape
    if msg.device.type in ("cpu", "meta"):
        return scatter_add_sorted_reference(msg, keys, n, edge_weight, row_scale)
    if max(n + 1, d) > _INT_MAX or num_edges >= _MAX_EDGES:
        raise ValueError(f"shape too large for the kernel: E={num_edges} n={n} d={d}")
    out = torch.empty((n, d), dtype=torch.float32, device=msg.device)
    if n == 0 or d == 0:
        return out
    lib = _kernel_lib()
    # scratch: two partial sums of d per chunk of edge slots, for rows the chunks cut
    chunks = -(-num_edges // lib.chunk_edges)
    partial = torch.empty((2 * chunks, d), dtype=torch.float32, device=msg.device)
    with torch.cuda.device(msg.device):
        err = lib.rgcn_scatter_sorted(
            msg.data_ptr(), keys.data_ptr(),
            None if edge_weight is None else edge_weight.data_ptr(),
            None if row_scale is None else row_scale.data_ptr(),
            out.data_ptr(), partial.data_ptr(), _counters_for(msg.device, n).data_ptr(),
            num_edges, n, d, torch.cuda.current_stream(msg.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"rgcn_scatter_sorted launch failed: {lib.rgcn_cuda_error_string(err).decode()}")
    scatter_add_sorted.launches += 1
    return out


class _ScatterAddSorted(torch.autograd.Function):
    """The scatter as a new-style Function, so that it composes with
    ``torch.func`` (``vmap`` of ``grad``): its :meth:`vmap` rule folds a
    model axis into the feature axis, and its backward is plain torch, so
    it vmaps by composition."""

    @staticmethod
    def forward(msg, edge_weight, keys, n, row_scale):
        return _scatter_forward(msg, keys, n, edge_weight, row_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        msg, edge_weight, keys, n, row_scale = inputs
        need_dw = edge_weight is not None and ctx.needs_input_grad[1]
        ctx.save_for_backward(keys, edge_weight, row_scale, msg if need_dw else None)
        ctx.n = n

    @staticmethod
    def backward(ctx, g):
        keys, edge_weight, row_scale, msg = ctx.saved_tensors
        dmsg, dw = scatter_add_sorted_backward(g, keys, ctx.n, edge_weight, row_scale, msg)
        return (dmsg if ctx.needs_input_grad[0] else None), dw, None, None, None

    @staticmethod
    def vmap(info, in_dims, msg, edge_weight, keys, n, row_scale):
        """K models (``info.batch_size``) over one graph: with ``keys`` and
        ``row_scale`` shared, the model axis folds into the feature axis,
        one launch on [E, K * d]; a per-model edge weight is multiplied
        into the messages first (its gradient comes from the backward,
        which runs batched). Batched keys or row scales launch once per
        model."""
        msg_d, w_d, keys_d, _, scale_d = in_dims
        k = info.batch_size
        if keys_d is not None or scale_d is not None:
            def pick(t, dim, i):
                return t if dim is None or t is None else t.select(dim, i).contiguous()

            outs = [_ScatterAddSorted.apply(pick(msg, msg_d, i), pick(edge_weight, w_d, i),
                                            pick(keys, keys_d, i), n, pick(row_scale, scale_d, i))
                    for i in range(k)]
            return torch.stack(outs), 0
        msg = (msg.unsqueeze(0).expand(k, *msg.shape) if msg_d is None
               else msg.movedim(msg_d, 0))
        if w_d is not None:
            msg = msg * edge_weight.movedim(w_d, 0)[:, :, None]
            edge_weight = None
        num_edges, d = msg.shape[1], msg.shape[2]
        folded = msg.permute(1, 0, 2).reshape(num_edges, k * d).contiguous()
        out = _ScatterAddSorted.apply(folded, edge_weight, keys, n, row_scale)
        return out.reshape(n, k, d), 1


def scatter_add_sorted(
    msg: torch.Tensor, keys: torch.Tensor, n: int,
    edge_weight: Optional[torch.Tensor] = None, row_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sorted-segment sum ``out[v] = row_scale[v] * sum_{keys[e]==v} w_e msg_e``.

    msg: [E, d] float32, contiguous; keys: [E] int32, ascending,
    masked edges keyed n; edge_weight: optional [E] float32; row_scale:
    optional [n] float32. On a CUDA tensor this launches the kernel and
    adds one to ``scatter_add_sorted.launches``; on a CPU tensor it runs
    the plain version. Either way the result is differentiable in msg and
    edge_weight (:func:`scatter_add_sorted_backward`), also under
    ``torch.func`` transforms: under ``vmap`` over K models that share the
    graph it launches once on [E, K * d] (``_ScatterAddSorted.vmap``).
    Unsorted keys give wrong sums on CUDA: sort them first, as
    :func:`rgcn_aggregate` does for ``dst_sorted=False``.
    """
    if msg.dim() != 2 or msg.dtype != torch.float32 or not msg.is_contiguous():
        raise ValueError(f"msg must be a contiguous 2-D float32 tensor; got {msg.dtype} "
                         f"{tuple(msg.shape)}")
    num_edges = msg.shape[0]
    _check_vector("keys", keys, num_edges, torch.int32, msg.device)
    _check_vector("edge_weight", edge_weight, num_edges, torch.float32, msg.device)
    _check_vector("row_scale", row_scale, n, torch.float32, msg.device)
    if msg.device.type not in devices():
        raise ValueError(f"scatter_add_sorted runs on cuda or cpu, not {msg.device}")
    if row_scale is not None and row_scale.requires_grad and torch.is_grad_enabled():
        raise ValueError("scatter_add_sorted has no gradient for row_scale (the in-degree norm "
                         "is data): pass it detached")
    return _ScatterAddSorted.apply(msg, edge_weight, keys, n, row_scale)


scatter_add_sorted.launches = 0


def check_impl(impl) -> None:
    """Raises unless ``impl`` is one of the JAX package's single-device
    aggregation routes: "xla" (XLA's segment sum) or "pallas" (kernel B1),
    which take the same path here, the kernel on a CUDA tensor and its
    plain version on a CPU tensor; or "cumsum", the approximate
    cumulative-sum route (:func:`rgcn_aggregate_cumsum`). The hyperbolic
    and HisRES layers take B1 for "cumsum" too, as JAX's take their
    segment sum. The entity-sharded markers of ``regcn_torch/dist.py``
    pass: every layer of the three families dispatches them to
    ``regcn_torch/parallel/halo.py``. "halo" names no single-device route:
    the boundary halo runs on a mesh."""
    if is_sharded(impl):
        return
    if impl == "halo":
        raise ValueError("impl 'halo' names no single-device route: the boundary halo runs on "
                         "a mesh, Trainer(mesh=..., dist_agg='halo')")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def rgcn_aggregate(
    h: torch.Tensor,  # [N, d] entity embeddings
    rel_emb: torch.Tensor,  # [2R, d] relation embeddings
    weight: torch.Tensor,  # [d, d] neighbor weight
    src: torch.Tensor,  # [E] int
    dst: torch.Tensor,  # [E] int
    rel: torch.Tensor,  # [E] int
    edge_mask: torch.Tensor,  # [E] float {0,1}
    in_deg_norm: torch.Tensor,  # [N] float
    *,
    dst_sorted: bool,
    edge_weight: Optional[torch.Tensor] = None,  # [E] float, multiplies the mask
    impl: str = "xla",
) -> torch.Tensor:
    """Returns [N, d] aggregated neighborhood messages in ``h``'s dtype,
    each edge's message scaled by ``edge_mask`` (times ``edge_weight``
    where given: the hyperbolic uvrgcn's radius weight, which may require
    grad).

    ``dst_sorted=True`` (the edge order of build_snapshot, Snapshot.dst_sorted)
    feeds the edges to the kernel as they are; otherwise they are sorted
    by key first, their weights with them. ``impl="cumsum"`` requires
    ``dst_sorted=True``, as JAX's does, and takes no edge weight.
    """
    if is_sharded(impl):
        raise ValueError(f"rgcn_aggregate aggregates on one device; impl {impl!r} is "
                         "regcn_torch.parallel.halo's (models/layers.py dispatches it)")
    if impl == "cumsum":
        if not dst_sorted:
            raise ValueError("impl='cumsum' requires destination-sorted edges")
        if edge_weight is not None:
            raise ValueError("impl='cumsum' takes no edge weight")
        return rgcn_aggregate_cumsum(h, rel_emb, weight, src, dst, rel, edge_mask, in_deg_norm)
    n = h.shape[0]
    # masked edges carry key n. The padded tail stores dst=0, so raw dst is
    # not monotone: keying the mask first keeps the keys ascending.
    keys = torch.where(edge_mask > 0, dst, n).to(torch.int32)
    w = edge_mask.float() if edge_weight is None else edge_weight.float() * edge_mask.float()
    if not dst_sorted:
        order = torch.argsort(keys, stable=True)
        src, rel, keys, w = src[order], rel[order], keys[order], w[order]
    msg = dot_f32(h[src] + rel_emb[rel], weight)
    agg = scatter_add_sorted(msg, keys, n, edge_weight=w.contiguous(),
                             row_scale=in_deg_norm.float().contiguous())
    return agg.to(h.dtype)


def rgcn_aggregate_cumsum(h, rel_emb, weight, src, dst, rel, edge_mask, in_deg_norm
                          ) -> torch.Tensor:
    """The sorted-segment sum as a cumulative sum and differences at the
    segment boundaries (``regcn_tpu/ops/rgcn_scatter.py:_rgcn_aggregate_cumsum``):

        S = cumsum(mask * msg);  out[v] = norm_v * (S[end_v] - S[start_v])

    The fp32 running sum makes it approximate (JAX measured a max relative
    error ~6e-5 at E = 4M), so JAX offers it for large-graph serving only.
    The segment offsets come from ``searchsorted`` over the running max of
    the raw ``dst``: the builders zero-fill the padded tail after the sorted
    real edges, and a masked edge adds a zero message, so giving its empty
    span to the running-max segment is exact. Its messages are not keyed
    to n as B1's are: it relies on that layout (every real edge before
    every padded one, real dst ascending)."""
    msg = dot_f32(h[src] + rel_emb[rel], weight)
    agg = cumsum_segment_sum(msg * edge_mask.float()[:, None], dst, h.shape[0])
    return (agg * in_deg_norm.float()[:, None]).to(h.dtype)


def cumsum_segment_sum(msg: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """[n, d]: the sum of the rows of ``msg`` [E, d] over each destination
    of ``dst`` [E], as a cumulative sum and its differences at the segment
    boundaries (:func:`rgcn_aggregate_cumsum`, whose layout it needs: the
    real edges first, by ascending destination, the masked ones' messages
    zero). A rank on a mesh runs it over its own destination partition."""
    cum = torch.cat([msg.new_zeros((1, msg.shape[1])), torch.cumsum(msg, dim=0)], dim=0)
    dst_keys = torch.cummax(dst, dim=0).values.contiguous()
    offsets = torch.searchsorted(dst_keys, torch.arange(n + 1, dtype=dst_keys.dtype,
                                                        device=dst_keys.device))
    return cum[offsets[1:]] - cum[offsets[:-1]]
