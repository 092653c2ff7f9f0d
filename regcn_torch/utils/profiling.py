"""The ``run_analysis`` statistics of both trainers.

Counterparts of ``gradient_stats`` and ``embedding_stats`` in
``regcn_tpu/utils/profiling.py`` (parity with
ref:hyperbolic_src/hyperbolic_model.py:1090-1108 ``log_gradient_stats``
and the reference's embedding logging under --run-analysis). Parameters
are named by JAX's ``keystr`` paths (``['rgcn']['layers'][0]['w_neighbor']``)
and ranked as JAX ranks them, so the two packages' records compare key by
key.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from regcn_torch.train.optim import tree_leaves


def _named_leaves(tree, grads: dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(keystr path, tensor) of every leaf, dict keys sorted at each level
    as JAX flattens a dict; ``grads`` maps a leaf's id to its gradient."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _named_leaves(tree[k], grads, f"{prefix}['{k}']")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _named_leaves(v, grads, f"{prefix}[{i}]")]
    return [(prefix, grads[id(tree)])]


def gradient_stats(params, grads: Sequence[Optional[torch.Tensor]], top_k: int = 10
                   ) -> Dict[str, float]:
    """The global gradient norm and the ``top_k`` largest per-parameter
    norms, by name, largest first. ``grads`` follows
    ``regcn_torch.train.optim.tree_leaves(params)``; a None gradient counts
    as 0, as JAX's zero gradient of an unused leaf."""
    by_id = {id(p): g for p, g in zip(tree_leaves(params), grads)}
    named = {}
    for name, g in _named_leaves(params, by_id):
        named[name] = 0.0 if g is None else float(torch.linalg.vector_norm(g.float()))
    global_norm = float(np.sqrt(sum(v ** 2 for v in named.values())))
    top = dict(sorted(named.items(), key=lambda kv: -kv[1])[:top_k])
    return {"global_norm": global_norm, **top}


def embedding_stats(emb: torch.Tensor, prefix: str = "emb") -> Dict[str, float]:
    """Row-norm statistics of an embedding table (mean, std, max), taken
    on the host in float32 as JAX takes them."""
    norms = np.linalg.norm(emb.detach().cpu().numpy().astype(np.float32), axis=-1)
    return {
        f"{prefix}_norm_mean": float(norms.mean()),
        f"{prefix}_norm_std": float(norms.std()),
        f"{prefix}_norm_max": float(norms.max()),
    }
