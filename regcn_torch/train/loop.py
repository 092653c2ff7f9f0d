"""Evaluation loop: rolling-window raw/filtered MRR over a split.

Counterpart of the single-step branch of
``regcn_tpu/train/loop.py:Trainer.evaluate`` and of ``Trainer.test``
(ref:src/main.py:33-107): each eval snapshot is scored from the
``test_history_len`` snapshots before it, then joins the window. The
model's scores come from a ``predict`` function, RE-GCN's by default;
the hyperbolic trainer passes ``regcn_torch.hyperbolic.model.predict``.
Multi-step evaluation (``construct_snap``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from regcn_torch.config import TrainConfig
from regcn_torch.data.answers import AnswerFilter, build_answer_filters_by_time
from regcn_torch.data.dataset import TKGData
from regcn_torch.data.snapshots import build_history, pad_triples, split_by_time
from regcn_torch.models import recurrent
from regcn_torch.train import metrics

RANK_KEYS = ("ent_raw", "ent_filter", "rel_raw", "rel_filter")

# predict(params, model_state, cfg, history, triples [B,3], mask [B]) -> (ent [B,N], rel [B,2R])
Predict = Callable[..., tuple]


def regcn_predict(params, model_state, cfg, history, triples, mask):
    """RE-GCN's eval-mode scores (the mask is not needed there)."""
    return recurrent.predict(params, model_state, cfg, history, triples)


@torch.inference_mode()
def rolling_ranks(
    params,
    model_state,
    cfg,
    tc: TrainConfig,
    history_list: Sequence[np.ndarray],
    eval_list: Sequence[np.ndarray],
    ent_filters: Optional[List[AnswerFilter]] = None,
    rel_filters: Optional[List[AnswerFilter]] = None,
    device="cuda",
    predict: Predict = regcn_predict,
) -> Dict[str, List[np.ndarray]]:
    """Per eval snapshot, the ranks of its real queries under each of
    ``RANK_KEYS`` (entity/relation, raw/filtered)."""
    window = list(history_list[-tc.test_history_len:])
    if not window:
        raise ValueError("rolling evaluation needs at least one history snapshot")
    ranks: Dict[str, List[np.ndarray]] = {k: [] for k in RANK_KEYS}
    for t, snap in enumerate(eval_list):
        history = build_history(window, cfg.num_ents, cfg.num_rels,
                                edge_bucket=tc.edge_bucket, rc_bucket=tc.rc_bucket).to(device)
        triples, mask = pad_triples(snap, cfg.num_rels, tc.triple_bucket)
        er, ec = metrics.filter_coo_padded(
            ent_filters[t] if ent_filters else None, triples[:, [0, 1]], triples[:, 2])
        rr, rc = metrics.filter_coo_padded(
            rel_filters[t] if rel_filters else None, triples[:, [0, 2]], triples[:, 1])
        er, ec, rr, rc = (torch.from_numpy(a).to(device) for a in (er, ec, rr, rc))
        trip = torch.from_numpy(triples).long().to(device)
        s_ob, s_rel = predict(params, model_state, cfg, history, trip,
                              torch.from_numpy(mask).to(device))
        step = torch.stack([
            metrics.device_ranks(s_ob, trip[:, 2]),
            metrics.device_filtered_ranks(s_ob, trip[:, 2], er, ec),
            metrics.device_ranks(s_rel, trip[:, 1]),
            metrics.device_filtered_ranks(s_rel, trip[:, 1], rr, rc),
        ]).cpu().numpy()
        valid = mask > 0
        for key, row in zip(RANK_KEYS, step):
            ranks[key].append(row[valid])
        # the window holds the last test_history_len snapshots, so a short
        # history grows up to that length, as in regcn_tpu's fused eval
        window = (window + [snap])[-tc.test_history_len:]
    return ranks


def evaluate(
    params,
    model_state,
    cfg,
    tc: TrainConfig,
    history_list: Sequence[np.ndarray],
    eval_list: Sequence[np.ndarray],
    ent_filters: Optional[List[AnswerFilter]] = None,
    rel_filters: Optional[List[AnswerFilter]] = None,
    device="cuda",
    predict: Predict = regcn_predict,
) -> Dict[str, metrics.RankStats]:
    """Rolling-window evaluation: ``RANK_KEYS`` -> RankStats."""
    ranks = rolling_ranks(params, model_state, cfg, tc, history_list, eval_list,
                          ent_filters, rel_filters, device, predict)
    return {k: metrics.stat_ranks(v) for k, v in ranks.items()}


def test(
    params,
    model_state,
    cfg,
    tc: TrainConfig,
    data: TKGData,
    device="cuda",
    predict: Predict = regcn_predict,
) -> Dict[str, metrics.RankStats]:
    """Test-split evaluation (``Trainer.test``): history = train + valid,
    eval = test, with per-timestamp answer filters of the test split."""
    if tc.dilate_len > 1:
        raise NotImplementedError("dilated training snapshots (dilate_len > 1) are not ported yet")
    ent_f = build_answer_filters_by_time(data.test, data.num_rels, False)
    rel_f = build_answer_filters_by_time(data.test, data.num_rels, True)
    return evaluate(
        params, model_state, cfg, tc,
        split_by_time(data.train) + split_by_time(data.valid), split_by_time(data.test),
        ent_f, rel_f, device, predict,
    )
