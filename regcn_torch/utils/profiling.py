"""Profiling and analysis hooks: the counterpart of
``regcn_tpu/utils/profiling.py``.

- :func:`trace`: a ``torch.profiler`` context that writes a Chrome trace
  (Perfetto / ``chrome://tracing``) of host and device activity into a
  directory the caller names;
- :func:`gradient_stats` and :func:`embedding_stats`: the ``run_analysis``
  statistics of the trainers (parity with
  ref:hyperbolic_src/hyperbolic_model.py:1090-1108 ``log_gradient_stats``
  and the reference's embedding logging under --run-analysis).
  Parameters are named by JAX's ``keystr`` paths
  (``['rgcn']['layers'][0]['w_neighbor']``) and ranked as JAX ranks them,
  so the two packages' records compare key by key;
- :class:`StepTimer`: rolling wall-clock statistics of training steps;
- :func:`parameter_count` / :func:`training_summary`: parameter counts and
  the config echo (parity with ref :1110-1128 ``get_training_summary``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from regcn_torch.train.optim import tree_leaves

log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Profile the block with ``torch.profiler`` (the host, and the card
    where CUDA is available) and write ``<log_dir>/trace.json``, a Chrome
    trace; a no-op when ``enabled`` is false. Yields the profiler (None
    when disabled), whose ``key_averages()`` sums the block's events."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


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


def parameter_count(params) -> int:
    """The number of scalars in a nested dict/list of tensors."""
    return sum(t.numel() for t in tree_leaves(params))


def training_summary(params, cfg: Any) -> Dict[str, Any]:
    """``num_parameters``, ``num_tensors`` and the config's fields."""
    if dataclasses.is_dataclass(cfg):
        config = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    elif hasattr(cfg, "__dict__"):
        config = dict(vars(cfg))
    else:
        config = str(cfg)
    return {"num_parameters": parameter_count(params), "num_tensors": len(tree_leaves(params)),
            "config": config}


class StepTimer:
    """Rolling wall-clock statistics of the last ``window`` timed blocks
    (``with timer: ...``). It reads the host's clock: time a step on the
    card after a ``torch.cuda.synchronize()``."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times: List[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50_s(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0
