"""bf16 compute in the port against regcn_tpu's bf16, RE-GCN and the islands.

The JAX package's bf16 mode is a policy (``regcn_tpu/utils/dtypes.py``):
the fp32 leaves with an axis of the parameters and of the history go to
bf16 at the loss boundary, 0-d leaves stay fp32, and fp32 islands sit
inside the compute path. Every input here is drawn from a numpy seed and
rounded to bf16 once, so both packages start from the same bf16 values.

- **Island ops** (each fp32 island JAX keeps, with the dtype it returns):
  the port's output has JAX's dtype, and its values lie within one bf16
  ulp of JAX's (an ulp of each value's own binade, plus 2^-16 of the
  output's largest entry for entries that cancel to near 0): both compute
  the island in fp32 and round once. ``rgcn_aggregate`` also against
  JAX's interpret-mode Pallas B1, the hyperbolic ops at a fixed c (weakly
  typed in JAX, a 0-d tensor here) and a learned one (a strong fp32 scalar
  in JAX, a [1] tensor here, so both promote).
- **RE-GCN config 1** (``Trainer.loss``, its gradients, and 3 steps of
  ``Trainer``) against JAX's ``Trainer`` loss and ``train_step``. Two bf16
  runs round differently, so the port is held to the drift JAX's own bf16
  shows from JAX's fp32: for each loss, gradient and parameter,
  ``||port_bf16 - jax_fp32|| <= 2 ||jax_bf16 - jax_fp32|| + atol ||jax_fp32||``
  with atol 1e-2 (L2 norms over the array); the port-bf16 vs JAX-bf16
  gap is in each message. After the 3 steps a parameter's atol is 0.5 of
  the distance JAX's fp32 run moved it instead: Adam moves an entry by
  about lr whatever its gradient's size, so where a gradient entry sits
  within bf16 noise of 0 the two runs step it in different directions.
  Over all gradients the port's drift must also be at least a tenth of
  JAX's, which shows that the port did compute in bf16. Then JAX's own
  criterion: after 3 epochs the port's bf16 loss is within rtol 0.05 of
  its fp32 loss, and the parameters stay fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from regcn_tpu.config import ExperimentConfig as JaxExperimentConfig
from regcn_tpu.config import ModelConfig as JaxModelConfig
from regcn_tpu.config import TrainConfig as JaxTrainConfig
from regcn_tpu.data import snapshots as jax_snapshots
from regcn_tpu.hyperbolic import decoders as JHD
from regcn_tpu.hyperbolic import est as JE
from regcn_tpu.hyperbolic import model as JHM
from regcn_tpu.hyperbolic import ops as JH
from regcn_tpu.hisres import layers as JHL
from regcn_tpu.hisres import model as JHR
from regcn_tpu.models import decoders as jax_decoders
from regcn_tpu.models import layers as jax_layers
from regcn_tpu.models import recurrent as jax_recurrent
from regcn_tpu.ops import activations as jax_act
from regcn_tpu.ops import segment as jax_segment
from regcn_tpu.ops.rgcn_scatter import rgcn_aggregate as jax_rgcn_aggregate
from regcn_tpu.train import loop as jax_loop
from regcn_tpu.train.state import create_train_state as jax_create_train_state
from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig
from regcn_torch.convert import train_state_from_jax
from regcn_torch.data import snapshots as pt_snapshots
from regcn_torch.data.synthetic import generate
from regcn_torch.hisres import layers as PHL
from regcn_torch.hisres import model as PHR
from regcn_torch.hyperbolic import decoders as PHD
from regcn_torch.hyperbolic import est as PE
from regcn_torch.hyperbolic import model as PHM
from regcn_torch.hyperbolic import ops as PH
from regcn_torch.models import decoders as pt_decoders
from regcn_torch.models import layers as pt_layers
from regcn_torch.models import recurrent as pt_recurrent
from regcn_torch.ops import activations as pt_act
from regcn_torch.ops import segment as pt_segment
from regcn_torch.ops.rgcn_scatter import rgcn_aggregate as pt_rgcn_aggregate
from regcn_torch.train import loop as pt_loop
from regcn_torch.train.optim import tree_leaves
from regcn_torch.utils.dtypes import dot_f32, tree_to_compute, tree_to_fp32

TINY = dict(num_ents=40, num_rels=5, num_snaps=10, triples_per_snap=30, split=(6, 2, 2))
D = 16
NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)
TC = dict(train_history_len=3, test_history_len=3, edge_bucket=32, rc_bucket=64, triple_bucket=64)
DRIFT_ATOL = 1e-2
STEP_ATOL = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return generate("synthetic-small", seed=123, **TINY)


# ------------------------------------------------------------------ helpers

def bf16(a) -> np.ndarray:
    """``a`` rounded to bf16, held as fp32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def both(*arrays, dtype="bfloat16"):
    """(jax arrays, torch tensors) of numpy arrays, in ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jd) for a in arrays],
            [torch.from_numpy(np.asarray(a, np.float32)).to(td) for a in arrays])


def assert_island(got: torch.Tensor, want, name: str) -> None:
    """JAX's dtype, and values within one bf16 ulp (module docstring)."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (
        f"{name}: port {got.dtype}, JAX {want.dtype}")
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(w), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bound = ulp + 2.0 ** -16 * max(np.abs(w).max(), 2.0 ** -126)
    err = np.abs(g - w)
    worst = float((err / ulp).max()) if err.size else 0.0
    assert np.all(err <= bound), f"{name}: {worst:.2f} ulp at worst"


def assert_composite(got: torch.Tensor, want, name: str, ulps: float = 4.0) -> None:
    """A chain of bf16 ops and islands: JAX's dtype, and values within
    ``ulps`` bf16 ulps of the output's largest entry (roundings inside the
    chain may fall differently in the two packages)."""
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (
        f"{name}: port {got.dtype}, JAX {want.dtype}")
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    scale = 2.0 ** (np.floor(np.log2(max(np.abs(w).max(), 2.0 ** -126))) - 7)
    worst = float(np.abs(g - w).max() / scale)
    assert worst <= ulps, f"{name}: {worst:.2f} ulps of the largest entry"


def drift_errors(port16, jax16, jax32):
    p, j, r = (np.asarray(x, np.float64) for x in (port16, jax16, jax32))
    return (np.linalg.norm(p - r), np.linalg.norm(j - r), np.linalg.norm(p - j),
            np.linalg.norm(r))


def assert_drift(port16, jax16, jax32, name: str, atol: float = DRIFT_ATOL, start=None):
    """err(port_bf16, jax_fp32) <= 2 err(jax_bf16, jax_fp32) + atol * ref,
    ref = ||jax_fp32||, or for parameters after some steps from ``start``
    the distance ||jax_fp32 - start|| they moved; returns (port drift, JAX
    drift)."""
    e_p, e_j, gap, ref = drift_errors(port16, jax16, jax32)
    if start is not None:
        ref = float(np.linalg.norm(np.asarray(jax32, np.float64) - np.asarray(start)))
    msg = (f"{name}: |port16-jax32| {e_p:.3e}, |jax16-jax32| {e_j:.3e}, "
           f"|port16-jax16| {gap:.3e}, ref {ref:.3e}")
    print(msg)
    assert e_p <= 2.0 * e_j + atol * ref, msg
    return e_p, e_j


def jax_snapshot(host):
    return jax_snapshots.Snapshot(**{f: getattr(host, f) for f in pt_snapshots._ARRAY_FIELDS},
                                  num_edges=host.num_edges, num_triples=host.num_triples,
                                  dst_sorted=host.dst_sorted)


def cast_snapshot(host, jd, td):
    """(JAX snapshot, torch snapshot) with the float arrays in the compute dtype."""
    js = jax_snapshot(host)
    js = dataclasses.replace(js, **{f: jnp.asarray(getattr(host, f), jd) for f in
                                    ("edge_mask", "in_deg_norm", "has_in_edge", "rc_mask")})
    return js, tree_to_compute(host.to("cpu"), td)


def graph(seed=0, n=40, r=5, m=60, rc_mode="both"):
    rng = np.random.default_rng(seed)
    t = np.unique(np.stack([rng.integers(0, n, m), rng.integers(0, r, m),
                            rng.integers(0, n, m)], 1), axis=0)
    return pt_snapshots.build_snapshot(t, n, r, edge_bucket=32, rc_bucket=64, rc_mode=rc_mode)


# ------------------------------------------------------------------ islands

def test_dot_f32_is_the_fp32_product_of_the_bf16_values():
    rng = np.random.default_rng(0)
    a, b = bf16(rng.normal(size=(7, 16))), bf16(rng.normal(size=(16, 5)))
    ta, tb = (torch.from_numpy(x).bfloat16().requires_grad_(True) for x in (a, b))
    out = dot_f32(ta, tb)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), a @ b, rtol=1e-6, atol=1e-6)
    want = jnp.dot(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    assert_island(out, want, "dot_f32")
    g = rng.normal(size=(7, 5)).astype(np.float32)
    ga, gb = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    assert ga.dtype == gb.dtype == torch.bfloat16
    ja, jb = jax.grad(lambda x, y: jnp.sum(jnp.dot(x, y, preferred_element_type=jnp.float32)
                                           * g), argnums=(0, 1))(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    assert_island(ga, ja, "dot_f32 da")
    assert_island(gb, jb, "dot_f32 db")
    # wider operands keep their product's dtype: the kernels' float64 references
    for dt in (torch.float32, torch.float64):
        x, y = torch.from_numpy(a).to(dt), torch.from_numpy(b).to(dt)
        out = dot_f32(x, y)
        assert out.dtype == dt and torch.equal(out, x @ y)


def test_tree_casts_follow_the_policy():
    tree = {"w": torch.ones(3, 2), "c": torch.tensor(0.5), "i": torch.arange(3),
            "l": [torch.zeros(2)], "snap": graph().to("cpu")}
    out = tree_to_compute(tree, torch.bfloat16)
    assert out["w"].dtype == out["l"][0].dtype == torch.bfloat16
    assert out["c"].dtype == torch.float32 and out["i"].dtype == torch.int64
    assert out["snap"].edge_mask.dtype == out["snap"].in_deg_norm.dtype == torch.bfloat16
    assert out["snap"].src.dtype == torch.int64 and out["snap"].dst_sorted
    assert tree_to_compute(tree, torch.float32) is tree
    back = tree_to_fp32(out)
    assert back["w"].dtype == back["snap"].rc_mask.dtype == torch.float32


def test_l2_normalize_and_segment_islands():
    rng = np.random.default_rng(1)
    x = bf16(rng.normal(size=(12, D)) * 3)
    (jx,), (tx,) = both(x)
    assert_island(pt_act.l2_normalize(tx), jax_act.l2_normalize(jx), "l2_normalize")
    ids = rng.integers(0, 5, 12)
    mask = (rng.uniform(size=12) < 0.8).astype(np.float32)
    (jm,), (tm,) = both(mask)
    for name in ("masked_segment_sum", "masked_segment_mean"):
        got = getattr(pt_segment, name)(tx, torch.from_numpy(ids), tm, 7)
        want = getattr(jax_segment, name)(jx, jnp.asarray(ids), jm, 7)
        assert_island(got, want, name)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_rgcn_aggregate_island(impl):
    """The bf16 edge GEMM with an fp32 result, the fp32 scatter (B1's
    plain version here; JAX's interpret-mode Pallas B1 for "pallas") and
    the result in bf16."""
    rng = np.random.default_rng(2)
    host = graph(2)
    h, rel = bf16(rng.normal(size=(40, D))), bf16(rng.normal(size=(10, D)))
    w = bf16(rng.normal(size=(D, D)) / 4)
    (jh, jr, jw), (th, tr, tw) = both(h, rel, w)
    js, ts = cast_snapshot(host, jnp.bfloat16, torch.bfloat16)
    got = pt_rgcn_aggregate(th, tr, tw, ts.src, ts.dst, ts.rel, ts.edge_mask, ts.in_deg_norm,
                            dst_sorted=True)
    with pltpu.force_tpu_interpret_mode():
        want = jax_rgcn_aggregate(jh, jr, jw, js.src, js.dst, js.rel, js.edge_mask,
                                  js.in_deg_norm, impl=impl, dst_sorted=True)
    assert_island(got, want, f"rgcn_aggregate[{impl}]")


def test_union_rgcn_layer_self_loop_island(data):
    """The self-loop GEMMs with an fp32 result, back in bf16, and the layer
    in bf16 throughout."""
    jcfg, _ = configs(data)
    params = jax_layers.init_union_rgcn_layer(jax.random.PRNGKey(3), D, skip_connect=True)
    params = jax.tree.map(lambda a: np.asarray(a), params)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.asarray(v)).bfloat16() for k, v in params.items()}
    rng = np.random.default_rng(3)
    h, rel, prev = (bf16(rng.normal(size=s)) for s in ((40, D), (10, D), (40, D)))
    (jh, jr, jprev), (th, tr, tprev) = both(h, rel, prev)
    js, ts = cast_snapshot(graph(3), jnp.bfloat16, torch.bfloat16)
    got = pt_layers.union_rgcn_layer(tp, th, tr, ts, prev_h=tprev)
    want = jax_layers.union_rgcn_layer(jp, jh, jr, js, prev_h=jprev)
    assert_composite(got, want, "union_rgcn_layer")


@pytest.mark.parametrize("which", ["convtranse", "convtransr"])
def test_decoder_islands(data, which):
    """BatchNorm's statistics and affine map in fp32 (new running stats
    fp32), the features in bf16, the scores fp32, the CE in fp32."""
    jcfg, _ = configs(data)
    params, state = jax.tree.map(np.asarray, jax_recurrent.init_params(jax.random.PRNGKey(0),
                                                                       jcfg.model))
    dec, bn = ("decoder_ob", "bn_ob") if which == "convtranse" else ("decoder_rel", "bn_rel")
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params[dec])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)).bfloat16(), params[dec])
    jbn = getattr(state, bn)
    tbn = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), jbn)
    rng = np.random.default_rng(4)
    real = pt_snapshots.split_by_time(data.train)[3]
    triples, mask = pt_snapshots.pad_triples(real, data.num_rels, 4 * len(real))
    emb, rel = bf16(rng.normal(size=(data.num_nodes, D))), bf16(rng.normal(size=(10, D)))
    (je, jr), (te, tr) = both(emb, rel)
    scores, new_bn = getattr(pt_decoders, f"{which}_score")(
        tp, tbn, te, tr, torch.from_numpy(triples).long(), torch.from_numpy(mask), train=True)
    want, want_bn = getattr(jax_decoders, f"{which}_score")(
        jp, jbn, je, jr, jnp.asarray(triples), jnp.asarray(mask), train=True)
    assert_composite(scores, want, f"{which} scores")
    for k in new_bn:
        for s in ("mean", "var"):
            # a batch mean near 0 cancels: summation order shows there
            assert_composite(new_bn[k][s], want_bn[k][s], f"{which} {k}.{s}")
    labels = triples[:, 2] if which == "convtranse" else triples[:, 1]
    got_ce = pt_recurrent._masked_ce(scores, torch.from_numpy(labels).long(),
                                     torch.from_numpy(mask))
    want_ce = jax_recurrent._masked_ce(want, jnp.asarray(labels), jnp.asarray(mask))
    assert_island(got_ce, want_ce, f"{which} CE")
    bx, bw = bf16(rng.normal(size=(6, 2, D))), bf16(rng.uniform(0.5, 1.5, size=2))
    out, _ = pt_decoders._batch_norm({"scale": torch.from_numpy(bw).bfloat16(),
                                      "bias": torch.zeros(2).bfloat16()}, tbn["bn0"],
                                     torch.from_numpy(bx).bfloat16(), train=True)
    jout, _ = jax_decoders._batch_norm({"scale": jnp.asarray(bw, jnp.bfloat16),
                                        "bias": jnp.zeros(2, jnp.bfloat16)}, jbn["bn0"],
                                       jnp.asarray(bx, jnp.bfloat16), None, axis=1, train=True)
    assert_island(out, jout, "batch_norm")


C_KINDS = {"fixed": (lambda: 0.01, lambda: PH.constant(0.01, torch.device("cpu"))),
           "learned": (lambda: jnp.asarray(0.01, jnp.float32), lambda: torch.tensor([0.01]))}


@pytest.mark.parametrize("c_kind", sorted(C_KINDS))
def test_hyperbolic_islands(c_kind):
    """The norm, exp / log maps, radius maps, Lorentz centroid and
    Einstein midpoint: fp32 inside, the points' dtype out."""
    jc, tc = (f() for f in C_KINDS[c_kind])
    rng = np.random.default_rng(5)
    v = bf16(rng.normal(size=(12, D)) * 2)
    x = bf16(np.asarray(JH.exp_map_zero(jnp.asarray(v), 0.01)))
    radius = bf16(rng.uniform(0.5, 3.0, size=12))
    (jv, jx, jrad), (tv, tx, trad) = both(v, x, radius)
    cases = [
        ("clamp_norm", lambda m: m.clamp_norm(xx, 5.0)),
        ("project_to_ball", lambda m: m.project_to_ball(xx, cc)),
        ("exp_map_zero", lambda m: m.exp_map_zero(vv, cc)),
        ("log_map_zero", lambda m: m.log_map_zero(xx, cc)),
        ("apply_radius", lambda m: m.apply_radius(xx, rr, cc)),
        ("clamp_tangent_norm", lambda m: m.clamp_tangent_norm(vv * 10, cc)),
        ("radius_from_tangent", lambda m: m.radius_from_tangent(vv, cc)),
        ("apply_radius_tangent", lambda m: m.apply_radius_tangent(vv, rr, cc)),
    ]
    for name, fn in cases:
        vv, xx, rr, cc = jv, jx, jrad, jc
        want = fn(JH)
        vv, xx, rr, cc = tv, tx, trad, tc
        assert_island(fn(PH), want, f"{name}[{c_kind}]")
    ids = np.sort(rng.integers(0, 6, 12))  # segment 6 .. 7 empty
    w = bf16(rng.uniform(0.1, 1.0, size=12))
    (jw,), (tw,) = both(w)
    lor = bf16(np.asarray(JH.to_lorentz(jnp.asarray(x), 0.01)))
    (jl,), (tl,) = both(lor)
    # bf16 segment sums in both packages, summed in their own orders
    assert_composite(PH.lorentz_centroid_segments(tl, tw, torch.from_numpy(ids), 8, tc),
                  JH.lorentz_centroid_segments(jl, jw, jnp.asarray(ids), 8, jc),
                  f"lorentz_centroid_segments[{c_kind}]")
    assert_island(PH.einstein_midpoint_segments(tx, tw, torch.from_numpy(ids), 8, tc),
                  JH.einstein_midpoint_segments(jx, jw, jnp.asarray(ids), 8, jc),
                  f"einstein_midpoint_segments[{c_kind}]")


@pytest.mark.parametrize("c_kind", sorted(C_KINDS))
def test_hyperbolic_model_islands(c_kind):
    """``_static_radius`` keeps the radius's dtype, the tangent ConvTransE
    scores are fp32, EST's slow-memory injection keeps the carry's dtype
    and its time features start from an fp32 log1p."""
    jc, tc = (f() for f in C_KINDS[c_kind])
    rng = np.random.default_rng(6)
    cfg_kw = dict(num_ents=12, num_rels=3, h_dim=D, compute_dtype="bfloat16",
                  learn_curvature=c_kind == "learned")
    jcfg, tcfg = JHM.HyperbolicConfig(**cfg_kw), PHM.HyperbolicConfig(**cfg_kw)
    rs = bf16(rng.uniform(0.1, 12.0, size=12))
    (jrs,), (trs,) = both(rs)
    assert_island(PHM._static_radius({"radius_static": trs}, tcfg, tc),
                  JHM._static_radius({"radius_static": jrs}, jcfg, jc), f"_static_radius")
    params, bn = JHD.init_hyperbolic_convtranse(jax.random.PRNGKey(6), 12, D)
    params = jax.tree.map(np.asarray, params)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)).bfloat16(), params)
    tbn = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), bn)
    x = bf16(np.asarray(JH.exp_map_zero(jnp.asarray(rng.normal(size=(12, D))), 0.01)))
    rel = bf16(rng.normal(size=(6, D)))
    (jx, jr), (tx, tr) = both(x, rel)
    triples = np.stack([rng.integers(0, 12, 8), rng.integers(0, 6, 8), rng.integers(0, 12, 8)],
                       1)
    want, _ = JHD.hyperbolic_convtranse_score(jp, bn, jx, jr, jnp.asarray(triples), jc)
    got, _ = PHD.hyperbolic_convtranse_score(tp, tbn, tx, tr, torch.from_numpy(triples).long(),
                                             tc)
    assert_composite(got, want, "hyperbolic_convtranse_score")
    slow = rng.normal(size=(12, D)).astype(np.float32) * 0.1
    assert_island(PE.inject_slow_state({}, tx, torch.from_numpy(slow), tc),
                  JE.inject_slow_state({}, jx, jnp.asarray(slow), jc), "inject_slow_state")
    est = JE.init_est_params(jax.random.PRNGKey(7), jcfg)
    jest = {k: (jnp.asarray(v, jnp.bfloat16) if np.ndim(v) else jnp.asarray(v))
            for k, v in est.items() if k.startswith("tdp_")}
    test_ = {k: (torch.from_numpy(np.asarray(v)).bfloat16() if np.ndim(v)
                 else torch.tensor(float(v))) for k, v in est.items() if k.startswith("tdp_")}
    deltas = rng.integers(0, 30, size=(3, 4)).astype(np.float32)
    assert_island(PE.time_delta_tangent(test_, torch.from_numpy(deltas)),
                  JE.time_delta_tangent(jest, jnp.asarray(deltas)), "time_delta_tangent")


def test_hisres_islands():
    """The candidate layer's sum (B1 in fp32 here, JAX's segment sum of
    bf16 messages times the fp32 history-graph mask) and its dtype, and
    the TimeConvTransE scores in fp32."""
    params, bn = JHL.init_cand_layer(jax.random.PRNGKey(8), D)
    params = jax.tree.map(np.asarray, params)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)).bfloat16(), params)
    tbn = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), bn)
    rng = np.random.default_rng(8)
    host = graph(8, rc_mode="src")  # the history graph: its masks stay fp32, as in JAX
    h, rel = bf16(rng.normal(size=(40, D))), bf16(rng.normal(size=(10, D)))
    (jh, jr), (th, tr) = both(h, rel)
    got, _ = PHL.cand_rgcn_layer(tp, tbn, th, tr, host.to("cpu"), train=False)
    want, _ = JHL.cand_rgcn_layer(jp, bn, jh, jr, jax_snapshot(host), train=False)
    assert_composite(got, want, "cand_rgcn_layer")
    cfg_kw = dict(num_ents=40, num_rels=5, h_dim=D, compute_dtype="bfloat16", **NO_DROPOUT)
    jcfg, tcfg = JHR.HisResConfig(**cfg_kw), PHR.HisResConfig(**cfg_kw)
    dparams, dbn = jax_decoders.init_convtrans(jax.random.PRNGKey(9), D)
    dparams = jax.tree.map(np.asarray, dparams)
    jdp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), dparams)
    tdp = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)).bfloat16(), dparams)
    tdbn = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), dbn)
    triples = np.stack([rng.integers(0, 40, 8), rng.integers(0, 10, 8), rng.integers(0, 40, 8)],
                       1)
    mask = np.ones(8, np.float32)
    for mode in ("entity", "relation"):
        got, _ = PHR._time_convtrans_score(tdp, tdbn, th, tr, torch.from_numpy(triples).long(),
                                           torch.from_numpy(mask), tcfg, None, False, mode)
        want, _ = JHR._time_convtrans_score(jdp, dbn, jh, jr, jnp.asarray(triples),
                                            jnp.asarray(mask), jcfg, None, False, mode)
        assert_composite(got, want, f"time convtrans {mode}")


# ------------------------------------------------------------------ config 1

def configs(data, **kw):
    base = dict(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=D, n_layers=2,
                **NO_DROPOUT)
    base.update(kw)
    return (JaxExperimentConfig(model=JaxModelConfig(**base), train=JaxTrainConfig(**TC)),
            ExperimentConfig(model=ModelConfig(**base), train=TrainConfig(**TC)))


def host_copy(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def jax_init(data):
    jcfg, _ = configs(data)
    return host_copy(jax_create_train_state(jax.random.PRNGKey(0), jcfg.model, jcfg.train))


def window_inputs(trainer, i):
    history, triples, mask = trainer.window(i)
    lo = max(0, i - trainer.cfg.train.train_history_len)
    host = pt_snapshots.build_history(trainer.train_list[lo:i], trainer.num_nodes,
                                      trainer.num_rels, edge_bucket=TC["edge_bucket"],
                                      rc_bucket=TC["rc_bucket"])
    return (history, triples, mask), (jax_snapshot(host), jnp.asarray(triples.numpy()),
                                      jnp.asarray(mask.numpy()))


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


@pytest.fixture(scope="module")
def config1_losses(data, jax_init):
    """(JAX fp32, JAX bf16, port bf16) of window 4: losses and gradients."""
    out = {}
    for dt in ("float32", "bfloat16"):
        jcfg, pcfg = configs(data, dtype=dt)
        jtr = jax_loop.Trainer(jcfg, data)
        trainer = pt_loop.Trainer(pcfg, data, device="cpu")
        (history, triples, mask), (jh, jt, jm) = window_inputs(trainer, 4)
        grads, (losses, _) = jax.jit(jax.grad(jtr._loss_fn, has_aux=True))(
            jax_init.params, jax_init.model_state, jh, jt, jm, None)
        out[f"jax_{dt}"] = (host_copy(losses), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                             grads))
        if dt == "bfloat16":
            state = train_state_from_jax(jax_init, device="cpu")
            total, plosses, _ = trainer.loss(state, history, triples, mask)
            pgrads = torch.autograd.grad(total, tree_leaves(state.params), allow_unused=True)
            out["port"] = (plosses, pgrads, state)
    return out


def test_config1_loss_and_gradients_track_jax_bf16(config1_losses):
    (jl32, jg32), (jl16, jg16) = config1_losses["jax_float32"], config1_losses["jax_bfloat16"]
    plosses, pgrads, state = config1_losses["port"]
    for k in ("entity", "relation", "static"):
        assert plosses[k].dtype == torch.float32 and jl16[k].dtype == np.float32
        assert_drift(plosses[k].item(), jl16[k], jl32[k], f"loss {k}")
    drift_p = drift_j = 0.0
    for path, g in zip(paths(state.params), pgrads):
        assert g is not None and g.dtype == torch.float32, path
        e_p, e_j = assert_drift(g.numpy(), by_path(jg16, path), by_path(jg32, path), path)
        drift_p, drift_j = drift_p + e_p, drift_j + e_j
    assert drift_p >= 0.1 * drift_j, ("the port's bf16 gradients barely move from fp32",
                                      drift_p, drift_j)


def test_config1_three_steps_track_jax_bf16(data, jax_init):
    """Three ``train_step``s from the same converted state, on windows 4,
    5 and 3 (3 snapshots each: one compile of JAX's step): every parameter
    after them, and each step's losses."""
    order = (4, 5, 3)
    runs = {}
    for dt in ("float32", "bfloat16"):
        jcfg, pcfg = configs(data, dtype=dt)
        jtr = jax_loop.Trainer(jcfg, data)
        trainer = pt_loop.Trainer(pcfg, data, device="cpu")
        jstate = jax.tree.map(jnp.asarray, jax_init)
        state = train_state_from_jax(jax_init, device="cpu")
        jl, pl = [], []
        for i in order:
            pin, jin = window_inputs(trainer, i)
            jstate, losses = jtr.train_step(jstate, *jin)
            jl.append(host_copy(losses))
            pl.append(trainer.train_step(state, *pin))
        runs[dt] = (host_copy(jstate.params), jl, state, pl)
    j32, jl32, _, _ = runs["float32"]
    j16, jl16, state, pl16 = runs["bfloat16"]
    for s in range(len(order)):
        for k in ("entity", "relation"):
            assert pl16[s][k].dtype == torch.float32
            assert_drift(pl16[s][k].item(), jl16[s][k], jl32[s][k], f"step {s} loss {k}")
    for path, p in zip(paths(state.params), tree_leaves(state.params)):
        assert p.dtype == torch.float32, path
        assert_drift(p.detach().numpy(), by_path(j16, path), by_path(j32, path), path,
                     atol=STEP_ATOL, start=by_path(jax_init.params, path))


def test_config1_bf16_tracks_fp32_over_three_epochs(data):
    """JAX's own criterion (tests/test_epoch_fused.py): the loss falls, the
    parameters stay fp32 and the last epoch's loss is within rtol 0.05 of
    the fp32 run's."""
    last = {}
    for dt in ("float32", "bfloat16"):
        _, pcfg = configs(data, dtype=dt)
        trainer = pt_loop.Trainer(pcfg, data, device="cpu")
        state = trainer.init_state(0)
        losses = [trainer.run_epoch(state, e)["entity"] for e in range(3)]
        assert losses[-1] < losses[0], (dt, losses)
        assert all(p.dtype == torch.float32 for p in tree_leaves(state.params))
        last[dt] = losses[-1]
    np.testing.assert_allclose(last["bfloat16"], last["float32"], rtol=0.05)


def test_config1_eval_runs_in_fp32(data, jax_init):
    """JAX's ``predict_step`` has no cast: a bf16 trainer evaluates the fp32
    parameters in fp32, bit for bit the fp32 trainer's scores."""
    _, p32 = configs(data)
    _, p16 = configs(data, dtype="bfloat16")
    state = train_state_from_jax(jax_init, device="cpu")
    s32 = pt_loop.Trainer(p32, data, device="cpu").evaluate(
        state, pt_snapshots.split_by_time(data.train), pt_snapshots.split_by_time(data.valid))
    s16 = pt_loop.Trainer(p16, data, device="cpu").evaluate(
        state, pt_snapshots.split_by_time(data.train), pt_snapshots.split_by_time(data.valid))
    for k in s32:
        assert s32[k].mrr == s16[k].mrr, k
