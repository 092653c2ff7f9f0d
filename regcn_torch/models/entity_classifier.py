"""Basis-RGCN entity classifier (the legacy RGCN task).

Counterpart of ``regcn_tpu/models/entity_classifier.py``: the model
behind the reference's legacy entity-classification stack
(ref:rgcn/knowledge_graph.py:25-135 loads aifb/mutag/bgs/am;
ref:rgcn/layers.py:96-144 is the basis layer; the original RGCN paper's
node-classification task). A featureless basis-decomposition input layer,
``n_hidden_layers - 1`` projected basis layers and a projected output
layer, each summing over the static graph's edges with kernel B1
(:func:`regcn_torch.models.layers.rgcn_basis_layer`), softmax
cross-entropy over the classes at the labeled training nodes plus an L2
term on the input layer.

:func:`fit` is full-batch Adam, one step an epoch, in a Python loop (the
JAX package runs the same steps as one ``lax.scan``). Dropout draws from a
``torch.Generator`` on the parameters' device, seeded ``seed + 1``; JAX's
and torch's streams differ, so the two packages agree step for step only
with dropout 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from regcn_torch.data.rdf import EntityClassData, StaticGraph, to_static_graph
from regcn_torch.models.layers import init_rgcn_basis_layer, rgcn_basis_layer
from regcn_torch.ops.activations import inverted_dropout
from regcn_torch.train.optim import EuclideanAdam, tree_leaves, tree_map

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class EntityClassifierConfig:
    h_dim: int = 16
    n_bases: int = -1  # <=0: one basis per relation
    n_hidden_layers: int = 1  # basis layers between input and output
    dropout: float = 0.0
    lr: float = 1e-2
    l2: float = 5e-4  # weight decay on the input layer (RGCN convention)
    n_epochs: int = 60
    edge_bucket: int = 128


def init_entity_classifier(gen: torch.Generator, data: EntityClassData,
                           cfg: EntityClassifierConfig, device="cuda") -> Params:
    """Random parameters drawn from ``gen`` on the CPU, moved to ``device``
    (leaves that require grad)."""
    params: Params = {"input": init_rgcn_basis_layer(
        gen, data.num_nodes, cfg.h_dim, data.num_rels, num_bases=cfg.n_bases, bias=True)}
    for i in range(cfg.n_hidden_layers - 1):
        params[f"hidden{i}"] = init_rgcn_basis_layer(
            gen, cfg.h_dim, cfg.h_dim, data.num_rels, num_bases=cfg.n_bases, bias=True)
    params["output"] = init_rgcn_basis_layer(
        gen, cfg.h_dim, data.num_classes, data.num_rels, num_bases=cfg.n_bases, bias=True)
    return tree_map(lambda t: t.to(device).requires_grad_(True), params)


def entity_logits(params: Params, graph: StaticGraph, cfg: EntityClassifierConfig, *,
                  gen: Optional[torch.Generator] = None, train: bool = False) -> torch.Tensor:
    """[N, num_classes] class logits for every node; in training, dropout
    before each projected layer."""
    h = rgcn_basis_layer(params["input"], None, graph, input_layer=True, activation=torch.relu)
    i = 0
    while f"hidden{i}" in params:
        h = inverted_dropout(h, cfg.dropout, gen, train)
        h = rgcn_basis_layer(params[f"hidden{i}"], h, graph, activation=torch.relu)
        i += 1
    h = inverted_dropout(h, cfg.dropout, gen, train)
    return rgcn_basis_layer(params["output"], h, graph)


def loss(params: Params, graph: StaticGraph, labels: torch.Tensor, idx: torch.Tensor,
         cfg: EntityClassifierConfig, gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Mean softmax cross-entropy at ``idx`` plus ``l2`` times the input
    layer's squared norm, with the dropouts of training."""
    logits = entity_logits(params, graph, cfg, gen=gen, train=True).index_select(0, idx)
    ce = torch.nn.functional.cross_entropy(logits, labels.index_select(0, idx))
    l2 = sum(torch.sum(torch.square(w)) for w in tree_leaves(params["input"]))
    return ce + cfg.l2 * l2


def graph_for(data: EntityClassData, edge_bucket: int, device) -> StaticGraph:
    """The padded device graph of ``data``, built once per (bucket, device)
    and kept on the dataset object."""
    key = (edge_bucket, str(torch.device(device)))
    cached = getattr(data, "_torch_graph_cache", None)
    if cached is None or cached[0] != key:
        cached = (key, to_static_graph(data, device, edge_bucket))
        data._torch_graph_cache = cached  # plain dataclass: attach the memo
    return cached[1]


def fit(seed: int, data: EntityClassData, cfg: EntityClassifierConfig, device="cuda",
        params: Optional[Params] = None) -> Tuple[Params, List[float]]:
    """``cfg.n_epochs`` full-batch Adam steps (optax.adam's semantics: no
    clip, no weight decay beyond the loss's L2 term) from ``params``, or
    from random parameters drawn with ``torch.Generator().manual_seed(seed)``;
    dropout draws from a generator on ``device`` seeded ``seed + 1``.
    Returns (params, the per-epoch training loss), with one host sync."""
    device = torch.device(device)
    graph = graph_for(data, cfg.edge_bucket, device)
    labels = torch.from_numpy(data.labels).to(device)
    train_idx = torch.from_numpy(data.train_idx).to(device)
    if params is None:
        params = init_entity_classifier(torch.Generator().manual_seed(seed), data, cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    leaves = tree_leaves(params)
    adam = EuclideanAdam(cfg.lr, weight_decay=0.0)
    state = adam.init(leaves)
    losses = []
    for _ in range(cfg.n_epochs):
        value = loss(params, graph, labels, train_idx, cfg, gen)
        grads = list(torch.autograd.grad(value, leaves))
        state.count += 1
        with torch.no_grad():
            adam.adam(leaves, grads, state.mu, state.nu, state.count)
        losses.append(value.detach())
    return params, torch.stack(losses).tolist() if losses else []


@torch.no_grad()
def evaluate(params: Params, data: EntityClassData, cfg: EntityClassifierConfig,
             idx=None) -> float:
    """Classification accuracy on ``idx`` (default: the test split)."""
    device = tree_leaves(params)[0].device
    graph = graph_for(data, cfg.edge_bucket, device)
    idx = torch.from_numpy(data.test_idx if idx is None else idx).to(device)
    pred = torch.argmax(entity_logits(params, graph, cfg).index_select(0, idx), dim=-1)
    labels = torch.from_numpy(data.labels).to(device).index_select(0, idx)
    return float(torch.mean((pred == labels).float()))
