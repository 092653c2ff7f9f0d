"""bf16 compute in the port's HisRES trainer against regcn_tpu's.

Both packages start from JAX's ``init_state(PRNGKey(0))``, converted, with
every dropout 0 (``cand_dropout`` too). The port is held to the drift
JAX's own bf16 shows from JAX's fp32, as in ``tests/test_torch_bf16.py``:
for each loss and parameter, ``||port_bf16 - jax_fp32|| <= 2
||jax_bf16 - jax_fp32|| + atol ref`` (L2 norms), ref = ``|jax_fp32|``
with atol 1e-2 for a loss, and for a parameter after the 3 steps the
distance JAX's fp32 run moved it, with atol 0.5 (Adam moves an entry by
about lr whatever its gradient's size); each message carries the
port-bf16 vs JAX-bf16 gap.

- 3 ``train_step``s; the parameters stay fp32, as
  ``tests/test_hisres.py`` asserts.
- Evaluation stays fp32 (JAX's ``predict_step`` has no cast).
- Over 3 epochs the port's bf16 loss falls and ends within rtol 0.05 of
  its fp32 loss (JAX's criterion).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data.snapshots import Snapshot as JaxSnapshot
from regcn_tpu.hisres import model as JRM
from regcn_tpu.hisres.train import HisResTrainer as JaxHisResTrainer
from regcn_torch.config import TrainConfig
from regcn_torch.convert import train_state_from_jax
from regcn_torch.data.synthetic import generate
from regcn_torch.hisres import model as PRM
from regcn_torch.hisres.train import HisResTrainer, union_snapshots
from regcn_torch.train.optim import tree_leaves

NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
STEP_ATOL = 0.5
DRIFT_ATOL = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_drift(port16, jax16, jax32, name, atol=DRIFT_ATOL, start=None):
    p, j, r = (np.asarray(x, np.float64) for x in (port16, jax16, jax32))
    e_p, e_j, gap = np.linalg.norm(p - r), np.linalg.norm(j - r), np.linalg.norm(p - j)
    ref = np.linalg.norm(r if start is None else r - np.asarray(start, np.float64))
    msg = (f"{name}: |port16-jax32| {e_p:.3e}, |jax16-jax32| {e_j:.3e}, "
           f"|port16-jax16| {gap:.3e}, ref {ref:.3e}")
    print(msg)
    assert e_p <= 2.0 * e_j + atol * ref, msg


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def by_path(tree, path):
    for k in path.split("/"):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


HISRES_TINY = dict(num_ents=50, num_rels=4, num_snaps=12, triples_per_snap=30, split=(8, 2, 2))
HISRES_TC = dict(n_epochs=2, lr=1e-3, train_history_len=2, test_history_len=2, edge_bucket=32,
                 rc_bucket=32, triple_bucket=32)


@pytest.fixture(scope="module")
def hisres_data():
    return generate("synthetic-small", seed=31, **HISRES_TINY)


def hisres_configs(data, dtype):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=8, n_layers=1,
                compute_dtype=dtype, cand_dropout=0.0, **NO_DROPOUT)
    return (JRM.HisResConfig(**base), JaxTrainConfig(**HISRES_TC), PRM.HisResConfig(**base),
            TrainConfig(**HISRES_TC))


def fused_counts(arg):
    """A JAX Snapshot with its static unpadded counts set as JAX's fused
    epoch sets them (``regcn_tpu/train/epoch.py:175-176``): the padded edge
    count and the triple bucket. No computation reads either field, but as
    static pytree fields each distinct pair compiles ``train_step`` anew."""
    if not isinstance(arg, JaxSnapshot):
        return arg
    return dataclasses.replace(arg, num_edges=int(arg.src.shape[-1]),
                               num_triples=HISRES_TC["triple_bucket"])


def test_hisres_three_steps_track_jax_bf16(hisres_data):
    """Three steps on windows of 2 snapshots from the same converted state:
    each step's losses and every parameter after them. The windows' padded
    shapes agree, and their static counts are set as the fused epoch sets
    them (``fused_counts``): one compile of JAX's step per dtype."""
    data = hisres_data
    runs = {}
    order = (3, 4, 5)  # windows of 2 snapshots
    for dt in ("float32", "bfloat16"):
        jcfg, jtc, pcfg, ptc = hisres_configs(data, dt)
        trainer = JaxHisResTrainer(jcfg, jtc, data, his_edge_bucket=64)
        state = trainer.init_state(jax.random.PRNGKey(0))
        init = jax.tree.map(np.array, state)
        losses = []
        for i in order:
            window = trainer.train_list[max(0, i - 2):i]
            args = (trainer._history(window), trainer._history(union_snapshots(window)),
                    *trainer._batch(trainer.train_list[i], i))
            state, ls = trainer.train_step(state, *map(fused_counts, args))
            losses.append(jax.tree.map(float, ls))
        runs[dt] = (init, losses, jax.tree.map(np.asarray, state.params))
        if dt == "bfloat16":
            port = HisResTrainer(pcfg, ptc, data, his_edge_bucket=64, device="cpu")
            pstate = train_state_from_jax(init, device="cpu")
            plosses = [port.train_step(pstate, *port.window(i)) for i in order]
    init, l32, p32 = runs["float32"]
    _, l16, p16 = runs["bfloat16"]
    for s in range(len(order)):
        for k in ("entity", "relation"):
            assert plosses[s][k].dtype == torch.float32
            assert_drift(plosses[s][k].item(), l16[s][k], l32[s][k], f"hisres step {s} {k}")
    for path, p in zip(paths(pstate.params), tree_leaves(pstate.params)):
        assert p.dtype == torch.float32, path
        assert_drift(p.detach().numpy(), by_path(p16, path), by_path(p32, path),
                     f"hisres {path}", atol=STEP_ATOL, start=by_path(init.params, path))


def test_hisres_eval_runs_in_fp32(hisres_data):
    """JAX's HisRES ``predict_step`` has no cast: the bf16 trainer's scores
    are the fp32 trainer's, bit for bit."""
    _, _, p32, ptc = hisres_configs(hisres_data, "float32")
    _, _, p16, _ = hisres_configs(hisres_data, "bfloat16")
    t32 = HisResTrainer(p32, ptc, hisres_data, his_edge_bucket=64, device="cpu")
    t16 = HisResTrainer(p16, ptc, hisres_data, his_edge_bucket=64, device="cpu")
    state = t32.init_state(0)
    with torch.inference_mode():
        a = t32.predict(state, *t32.window(3))
        b = t16.predict(state, *t16.window(3))
    for x, y in zip(a, b):
        assert y.dtype == torch.float32
        assert torch.equal(x, y)


def test_hisres_bf16_tracks_fp32_over_three_epochs(hisres_data):
    """JAX's own criterion: the loss falls, the parameters stay fp32, and
    the last epoch's entity loss is within rtol 0.05 of the fp32 run's."""
    last = {}
    for dt in ("float32", "bfloat16"):
        _, _, pcfg, ptc = hisres_configs(hisres_data, dt)
        trainer = HisResTrainer(pcfg, ptc, hisres_data, his_edge_bucket=64, device="cpu")
        state = trainer.init_state(0)
        losses = [trainer.run_epoch(state, e)["entity"] for e in range(3)]
        assert losses[-1] < losses[0], (dt, losses)
        assert all(p.dtype == torch.float32 for p in tree_leaves(state.params))
        last[dt] = losses[-1]
    np.testing.assert_allclose(last["bfloat16"], last["float32"], rtol=0.05)
