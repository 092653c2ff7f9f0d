"""The port's rolling-window evaluation against regcn_tpu's Trainer.

Same converted parameters on both sides. MRRs agree to 1e-4. Ranks are
integers computed from fp32 scores whose sums are taken in another order,
so a rank may differ only where two scores are within rounding of each
other: the test allows at most 2 such ranks, each off by at most 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regcn_tpu.config import ExperimentConfig
from regcn_tpu.config import ModelConfig as JaxModelConfig
from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data import build_answer_filters_by_time, split_by_time
from regcn_tpu.train import metrics as jax_metrics
from regcn_tpu.train.loop import Trainer
from regcn_tpu.train.state import create_train_state
from regcn_torch.config import ModelConfig, TrainConfig
from regcn_torch.convert import params_from_jax
from regcn_torch.data.synthetic import generate
from regcn_torch.train import loop as pt_loop
from regcn_torch.train import metrics as pt_metrics

TINY = dict(num_ents=64, num_rels=6, num_snaps=10, triples_per_snap=40, split=(6, 2, 2))
MRR_TOL = 1e-4
MAX_RANK_MISMATCHES, MAX_RANK_DIFF = 2, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads cost more than they save,
    and on a CPU shared with other test workers far more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    data = generate("synthetic-small", seed=123, **TINY)
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=32, n_layers=2)
    buckets = dict(test_history_len=3, edge_bucket=32, rc_bucket=64, triple_bucket=32)
    trainer = Trainer(ExperimentConfig(model=JaxModelConfig(**base),
                                       train=JaxTrainConfig(**buckets)), data)
    state = create_train_state(jax.random.PRNGKey(0), trainer.cfg.model, trainer.cfg.train)
    params, model_state = params_from_jax(jax.tree.map(np.asarray, state.params),
                                          jax.tree.map(np.asarray, state.model_state),
                                          device="cpu")
    return data, trainer, state, (params, model_state, ModelConfig(**base), TrainConfig(**buckets))


def jax_rank_arrays(trainer, state, history_list, eval_list, ent_f, rel_f):
    store, er, ec, rr, rc, tmask = trainer._eval_resources(history_list, eval_list, ent_f, rel_f)
    ranks = jax.device_get(trainer._eval_fn(state, store, er, ec, rr, rc))
    return {k: [arr[t][tmask[t]] for t in range(arr.shape[0])]
            for k, arr in zip(pt_loop.RANK_KEYS, ranks)}


def test_test_split_matches_trainer_test(setup):
    data, trainer, state, (params, model_state, cfg, tc) = setup
    got = pt_loop.test(params, model_state, cfg, tc, data, device="cpu")
    want = trainer.test(state)
    for k in pt_loop.RANK_KEYS:
        assert got[k].count == want[k].count > 0
        assert abs(got[k].mrr - want[k].mrr) <= MRR_TOL, k
        for h in (1, 3, 10):
            assert abs(got[k].hits[h] - want[k].hits[h]) <= MAX_RANK_MISMATCHES / got[k].count


@pytest.mark.parametrize("split", ["valid", "test", "short_history"])
def test_rolling_ranks_match_trainer_eval(setup, split):
    """Per-query ranks; ``short_history`` gives a 1-snapshot history to a
    3-snapshot window, which grows to 3 snapshots as eval snapshots join it
    (JAX front-pads it with identity steps; the port runs the shorter
    window until it is full: the same result)."""
    data, trainer, state, (params, model_state, cfg, tc) = setup
    train, valid, test = (split_by_time(getattr(data, s)) for s in ("train", "valid", "test"))
    quads = data.valid if split == "valid" else data.test
    history_list = {"valid": train, "test": train + valid, "short_history": train[:1]}[split]
    eval_list = valid if split == "valid" else test
    ent_f = build_answer_filters_by_time(quads, data.num_rels, False)
    rel_f = build_answer_filters_by_time(quads, data.num_rels, True)
    got = pt_loop.rolling_ranks(params, model_state, cfg, tc, history_list, eval_list,
                                ent_f, rel_f, device="cpu")
    want = jax_rank_arrays(trainer, state, history_list, eval_list, ent_f, rel_f)
    for k in pt_loop.RANK_KEYS:
        g, w = np.concatenate(got[k]), np.concatenate(want[k])
        assert g.shape == w.shape and g.min() >= 1
        assert g.max() <= (data.num_nodes if k.startswith("ent") else 2 * data.num_rels)
        diff = np.abs(g - w)
        assert np.count_nonzero(diff) <= MAX_RANK_MISMATCHES and diff.max() <= MAX_RANK_DIFF, k
        assert abs(pt_metrics.stat_ranks(got[k]).mrr - jax_metrics.stat_ranks(want[k]).mrr) <= MRR_TOL


def test_device_ranks_match_jax(rng):
    """Exact integer ranks from the same scores, with padded COO rows (== B)
    that must be dropped and ties that must not count."""
    B, N = 24, 40
    scores = rng.normal(size=(B, N)).astype(np.float32)
    scores[:, 5] = scores[:, 6]  # ties
    targets = rng.integers(0, N, B)
    nnz = 60
    rows = np.full(nnz + 20, B, np.int64)
    rows[:nnz] = rng.integers(0, B, nnz)
    cols = rng.integers(0, N, nnz + 20)
    keep = cols[:nnz] != targets[rows[:nnz]]  # the filter never squashes a target
    rows[:nnz][~keep] = B
    t = torch.from_numpy
    got_raw = pt_metrics.device_ranks(t(scores), t(targets))
    got_f = pt_metrics.device_filtered_ranks(t(scores), t(targets), t(rows), t(cols))
    j = jnp.asarray
    np.testing.assert_array_equal(got_raw.numpy(), jax_metrics.device_ranks(j(scores), j(targets)))
    np.testing.assert_array_equal(
        got_f.numpy(), jax_metrics.device_filtered_ranks(j(scores), j(targets), j(rows), j(cols)))
    np.testing.assert_array_equal(got_raw.numpy(), pt_metrics.ranks_from_scores(scores, targets))
    assert np.all(got_f.numpy() <= got_raw.numpy())


def test_dilated_history_is_refused(setup):
    """The test-split evaluation of the hyperbolic trainers does not read
    ``dilate_len``, as JAX's hyperbolic and HisRES trainers do not: with
    ``dilate_len=2`` it gives the ranks of ``dilate_len=1`` (once refused,
    it now runs; only the RE-GCN ``Trainer`` dilates its training list)."""
    data, _, _, (params, model_state, cfg, tc) = setup
    got = pt_loop.test(params, model_state, cfg, dataclasses.replace(tc, dilate_len=2), data,
                       device="cpu")
    want = pt_loop.test(params, model_state, cfg, tc, data, device="cpu")
    for k in want:
        assert got[k].mrr == want[k].mrr, k
