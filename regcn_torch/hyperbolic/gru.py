"""Hyperbolic GRU family: tangent-space recurrences on the Poincaré ball.

Counterpart of ``regcn_tpu/hyperbolic/gru.py``: the library cells of the
hyperbolic package. The model does not call them (its relation GRU and
entity time gate are written inline in ``hyperbolic/model.py``); they
are the standalone equivalents.

Every cell log-maps ball points to the tangent space at the origin, runs
the Euclidean recurrence there and exp-maps back. The sequence model
keeps its carry in tangent space between steps, which is exact: the next
step would log-map the exp-mapped output at once. The parameter
dictionaries have the JAX package's keys and layouts.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from regcn_torch.hyperbolic import ops as H
from regcn_torch.models.layers import gru_cell, init_gru_cell
from regcn_torch.ops.activations import inverted_dropout
from regcn_torch.utils.dtypes import mm
from regcn_torch.utils.init import xavier_uniform

Params = Dict[str, torch.Tensor]


def init_hyperbolic_gru_cell(gen: torch.Generator, input_size: int, hidden_size: int) -> Params:
    """A tangent-space GRU cell: torch's GRUCell parameters."""
    return init_gru_cell(gen, input_size, hidden_size)


def hyperbolic_gru_cell(params: Params, x_hyp: torch.Tensor, h_hyp: torch.Tensor, c
                        ) -> torch.Tensor:
    """One step: log both, the GRU in tangent space, exp back."""
    return H.exp_map_zero(gru_cell(params, H.log_map_zero(x_hyp, c), H.log_map_zero(h_hyp, c)),
                          c)


def hyperbolic_gru_cell_tangent_input(params: Params, x_tan: torch.Tensor, h_hyp: torch.Tensor,
                                      c) -> torch.Tensor:
    """One step with the input already in tangent space."""
    return H.exp_map_zero(gru_cell(params, x_tan, H.log_map_zero(h_hyp, c)), c)


def init_hyperbolic_gru(gen: torch.Generator, input_size: int, hidden_size: int,
                        num_layers: int = 1) -> Params:
    """A stacked, unidirectional sequence GRU."""
    return {f"layer{i}": init_gru_cell(gen, input_size if i == 0 else hidden_size, hidden_size)
            for i in range(num_layers)}


def hyperbolic_gru(params: Params, x_hyp: torch.Tensor, c, h0_hyp: Optional[torch.Tensor] = None,
                   *, dropout: float = 0.0, gen: Optional[torch.Generator] = None,
                   train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked tangent GRU over a sequence x [T, B, in] of ball points,
    from ``h0_hyp`` [L, B, hidden] (zeros if None): (outputs [T, B, hidden],
    h_n [L, B, hidden]), both on the ball. In training, inverted dropout
    from ``gen`` between layers."""
    num_layers = len(params)
    _, B, _ = x_hyp.shape
    hidden = params["layer0"]["w_hh"].shape[1]
    h0_tan = (x_hyp.new_zeros((num_layers, B, hidden)) if h0_hyp is None
              else H.log_map_zero(h0_hyp, c))
    layer_in = H.log_map_zero(x_hyp, c)
    finals = []
    for i in range(num_layers):
        h, outs = h0_tan[i], []
        for x_t in layer_in:
            h = gru_cell(params[f"layer{i}"], x_t, h)
            outs.append(h)
        finals.append(h)
        layer_in = torch.stack(outs)
        if i < num_layers - 1:
            layer_in = inverted_dropout(layer_in, dropout, gen, train)
    return H.exp_map_zero(layer_in, c), H.exp_map_zero(torch.stack(finals), c)


def init_hyperbolic_entity_gru(gen: torch.Generator, hidden_size: int) -> Params:
    """RE-GCN's entity time gate, in tangent space."""
    return {"time_gate_w": xavier_uniform(gen, (hidden_size, hidden_size), gain=math.sqrt(2.0)),
            "time_gate_b": torch.zeros(hidden_size)}


def hyperbolic_entity_gru(params: Params, current_hyp: torch.Tensor, prev_hyp: torch.Tensor, c
                          ) -> torch.Tensor:
    """gate = sigmoid(prev_tan @ W + b); the two points blended in tangent
    space by it."""
    cur_tan, prev_tan = H.log_map_zero(current_hyp, c), H.log_map_zero(prev_hyp, c)
    gate = torch.sigmoid(mm(prev_tan, params["time_gate_w"]) + params["time_gate_b"])
    return H.exp_map_zero(gate * cur_tan + (1.0 - gate) * prev_tan, c)


def init_hyperbolic_relation_gru(gen: torch.Generator, hidden_size: int) -> Params:
    """The relation GRU, whose input is [relation ; entity context]."""
    return init_gru_cell(gen, 2 * hidden_size, hidden_size)


def hyperbolic_relation_gru(params: Params, rel_input_tan: torch.Tensor,
                            prev_rel_hyp: torch.Tensor, c) -> torch.Tensor:
    """The input in tangent space, the hidden state on the ball."""
    return H.exp_map_zero(gru_cell(params, rel_input_tan, H.log_map_zero(prev_rel_hyp, c)), c)
