"""The bf16 compute policy shared by the trainers (``regcn_tpu/utils/dtypes.py``).

Under ``compute_dtype="bfloat16"`` a trainer casts the fp32 leaves of its
parameters and of its history snapshots that have at least one axis to
bf16 inside the loss (:func:`tree_to_compute`); 0-d leaves (a learned
curvature, score margins, gate thresholds) stay fp32. The cast is part of
the autograd graph, so each gradient comes back to its fp32 parameter in
fp32, as JAX's ``tree_to_fp32`` brings it back before the fp32 optimizer.
Norms, transcendental chains, BatchNorm statistics, segment sums, the
scatter kernel's input and the cross-entropy stay fp32 islands inside the
model, each where the JAX package keeps one; :func:`dot_f32` is the
counterpart of ``jnp.dot(..., preferred_element_type=jnp.float32)``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype`` / ``dtype`` string."""
    if name not in DTYPES:
        raise ValueError(f"compute dtype must be one of {tuple(DTYPES)}, got {name!r}")
    return DTYPES[name]


def tree_to_compute(tree, dtype: torch.dtype):
    """``tree`` with every fp32 tensor of at least one axis cast to
    ``dtype``: through dicts, lists, tuples and dataclasses (a Snapshot's
    ``edge_mask``, ``in_deg_norm``, ``has_in_edge`` and ``rc_mask``); 0-d
    tensors and everything else as they are. The identity for fp32."""
    if dtype == torch.float32:
        return tree
    return _map(tree, lambda t: t.to(dtype) if t.dtype == torch.float32 and t.dim() >= 1 else t)


def tree_to_fp32(tree):
    """``tree`` with every floating tensor cast to fp32."""
    return _map(tree, lambda t: t.float() if t.is_floating_point() else t)


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)
            if f.init and isinstance(getattr(tree, f.name), (torch.Tensor, dict, list, tuple))})
    return tree


def promoted(*ts):
    """``ts`` cast to their common dtype (None stays None). JAX promotes the
    operands of a product (an fp32 activation times a bf16 weight is an
    fp32 product); torch's products take one dtype. A no-op in fp32."""
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in ts if t is not None])
    return [None if t is None else t.to(dtype) for t in ts]


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion of the operands."""
    a, b = promoted(a, b)
    return a @ b


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """``F.linear`` with JAX's promotion of the operands."""
    return F.linear(*promoted(x, w, b))


class _DotF32(torch.autograd.Function):
    """``a @ b`` of bf16 operands with an fp32 result.

    Forward: on a CUDA tensor ``torch.mm(a, b, out_dtype=torch.float32)``,
    the bf16 tensor-core GEMM with fp32 accumulation and output; on a CPU
    tensor the fp32 product of the bf16 values, which is what JAX's CPU
    computes for ``preferred_element_type=float32`` (the CPU build of
    torch has no ``aten::mm.dtype``). Backward, on both devices: the fp32
    products of the fp32 cotangent with the other operand's bf16 values,
    each rounded to its operand's dtype, as JAX returns a gradient in the
    primal's dtype."""

    @staticmethod
    def forward(a, b):
        a2 = a.reshape(-1, a.shape[-1])
        if a.is_cuda:
            out = torch.mm(a2, b, out_dtype=torch.float32)
        else:
            out = a2.float() @ b.float()
        return out.reshape(*a.shape[:-1], b.shape[-1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g2 @ b.float().T).reshape(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.reshape(-1, a.shape[-1]).float().T @ g2).to(b.dtype)
        return ga, gb


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(a, b, preferred_element_type=jnp.float32)`` for ``a``
    [..., k] and ``b`` [k, n]: operands of two dtypes promote first, as in
    JAX; the fp32-output product of :class:`_DotF32` for bf16 operands, the
    plain product for fp32 ones (and for float64 ones, which the plain
    versions of the kernels take as their exact reference)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    if dtype != torch.bfloat16:
        return a @ b
    return _DotF32.apply(a, b)
