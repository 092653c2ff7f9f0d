"""The streaming-CE wrapper, and kernel B2 against its plain version.

This file imports no JAX, so its CUDA tests also run on a GPU machine
without it (``--noconftest`` skips the JAX set-up in conftest.py):

    python -m pytest --noconftest -q -m cuda tests/test_torch_streaming_ce_kernels.py

Tolerances on the card: both sides are held against the plain version
in float64. The kernels' NLL must lie within
max(1e-5 * max(1, max|nll|), 2 * the fp32 plain version's own error), and
each gradient within max(1e-4 * max(1, max|gradient|), 2 * the fp32 plain
version's error) for that input. The first terms cover summation order
(fp32 FMAs in another order than cuBLAS and ``logsumexp``; a gradient
entry sums hundreds or thousands of terms that cancel); the second covers
inputs where fp32 itself is inaccurate: near the ball's edge the true
distance's artanh' amplifies the rounding of 1 - c|q|^2 about a
thousandfold, and there the fp32 plain version is off by ~2 % in dq.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from regcn_torch.hyperbolic import decoders as PD
from regcn_torch.hyperbolic import ops as PH
from regcn_torch.ops import streaming_ce as S

NLL_TOL, GRAD_TOL = 1e-5, 1e-4
C = 0.01
NAMES = ("q", "x", "bias", "cq", "scale", "margin")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_case(B, N, d, *, true=False, per_query_c=False, near_edge=False, seed=0, c_low=0.005):
    """(q, x, bias, target, cq, scale, margin, g) as CPU tensors, q and x
    ball points from a seeded numpy generator; g is an upstream gradient;
    per-query curvatures are drawn from [c_low, 0.999 c]."""
    rng = np.random.default_rng(seed)
    q = PH.exp_map_zero(torch.from_numpy(rng.normal(size=(B, d)).astype(np.float32) * 0.4), C)
    x = PH.exp_map_zero(torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32) * 0.4), C)
    if near_edge:
        # antipodal pairs at radius 9.995 of 10 (the true distance's clamp
        # binds) and candidates past the edge (the proxy's clamp binds)
        u = q[:8] / q[:8].norm(dim=1, keepdim=True)
        q[:8], x[:8], x[8:16] = 9.995 * u, -9.995 * u, -12.0 * u
    target = torch.from_numpy(rng.integers(0, N, B))
    k = min(4, B)
    target[:k] = N - 1 - torch.arange(k)  # targets in the last, partial tile
    # per-query curvatures as clamp_relation_curvature bounds them: at most
    # 0.999 c, so the points stay inside every query's ball
    cq = (torch.from_numpy(rng.uniform(c_low, 0.999 * C, B).astype(np.float32)) if per_query_c
          else torch.full((B,), C))
    return (q, x, torch.from_numpy((rng.normal(size=N) * 0.1).astype(np.float32)), target, cq,
            torch.tensor(1.3), torch.tensor(0.7), torch.from_numpy(rng.random(B).astype(np.float32)))


def run(fn, case, true, device):
    """(nll, [dq, dx, dbias, dcq, dscale, dmargin]) of ``fn`` on ``device``."""
    q, x, bias, target, cq, scale, margin, g = case
    leaves = [t.to(device).requires_grad_(True) for t in (q, x, bias, cq, scale, margin)]
    nll = fn(leaves[0], leaves[1], leaves[2], target.to(device), leaves[3], leaves[4], leaves[5],
             true)
    grads = torch.autograd.grad(nll, leaves, g.to(device))
    return nll.detach(), list(grads)


def test_wrapper_on_cpu_is_the_plain_version():
    case = make_case(12, 70, 8, true=True, per_query_c=True)
    before = (S.ce_forward.launches, S.ce_backward_q.launches, S.ce_backward_x.launches)
    got, got_g = run(S.streaming_nll, case, True, "cpu")
    want, want_g = run(S.streaming_nll_reference, case, True, "cpu")
    assert (S.ce_forward.launches, S.ce_backward_q.launches, S.ce_backward_x.launches) == before
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


def test_dist_ce_loss_on_cpu_is_the_masked_mean_of_the_plain_nll():
    q, x, bias, target, cq, scale, margin, _ = make_case(12, 70, 8)
    mask = (torch.arange(12) < 9).float()
    loss = PD.dist_ce_loss(q, x, target, C, mask=mask, candidate_bias=bias, score_scale=scale,
                           score_margin=margin)
    nll = S.streaming_nll_reference(q, x, bias, target, cq, scale, margin)
    torch.testing.assert_close(loss, (nll * mask).sum() / 9, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("B, N, picked", [(512, 7128, 1), (512, 460, 8), (1, 460, 1),
                                           (97, 65, 4)])
def test_backward_x_plan_picks_the_fewest_tiles_on_the_busiest_sm(monkeypatch, B, N, picked):
    """The cluster size the candidate-side backward launches with, given the
    occupancy an H100 reports at d = 200 (clusters of 1 to 8 blocks resident
    at once; one block per SM): the smallest size whose busiest SM walks the
    fewest 32-row query tiles."""
    resident = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
    monkeypatch.setattr(S, "_backward_x_occupancy", lambda dev, d, size, true: (1, resident[size]))
    plan = S.backward_x_plan(B, N, 200, False, torch.device("cpu"))
    assert plan["cluster"] == picked
    assert plan["grid"] == -(-N // S.TILE) * picked
    q_tiles = -(-B // S.BWD_X_ROWS)
    assert plan["query_tiles_per_block"] == -(-q_tiles // picked)


# clusters of the query-side backward resident at once on an H100 SXM at
# d = 200 (one block per SM), as cudaOccupancyMaxActiveClusters reports them;
# 16 varies in the cases below
Q_RESIDENT = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9, 10: 7, 11: 7,
              12: 7, 13: 7, 14: 7, 15: 7}


@pytest.mark.parametrize("B, N, resident_16, cluster, splits", [
    (512, 7128, 7, 2, 8), (512, 460, 7, 2, 8), (512, 7128, 8, 16, 1), (1, 7128, 7, 16, 7),
    (1, 7128, 0, 8, 15), (97, 65, 7, 3, 1)])
def test_backward_q_plan_picks_the_fewest_tiles_on_the_busiest_sm(monkeypatch, B, N, resident_16,
                                                                  cluster, splits):
    """The launch of the query-side backward: per size, as many splits as fit
    the card at once; then the size whose busiest SM walks the fewest 32-row
    candidate tiles, with the fewest splits, never a size of which no
    cluster fits. At config 3's shapes (B = 512) clusters of 16 cannot hold
    the 8 query tiles at once, so 8 clusters of 2 per tile fill 128 SMs."""
    resident = {**Q_RESIDENT, 16: resident_16}
    monkeypatch.setattr(S, "_backward_q_occupancy", lambda dev, d, size, true: (1, resident[size]))
    plan = S.backward_q_plan(B, N, 200, False, torch.device("cpu"))
    assert (plan["cluster"], plan["splits"]) == (cluster, splits)
    assert plan["grid"] == -(-B // S.TILE) * splits * cluster
    c_tiles = -(-N // S.BWD_Q_ROWS)
    assert plan["candidate_tiles_per_block"] == -(-c_tiles // (splits * cluster))
    forced = S.backward_q_plan(B, N, 200, False, torch.device("cpu"), cluster=1, splits=3)
    assert (forced["cluster"], forced["splits"]) == (1, 3)


@pytest.mark.parametrize("B, N, queries, per_sm, splits, want", [
    (512, 7128, 128, 1, 0, 32), (512, 460, 128, 1, 0, 29), (512, 7128, 64, 2, 0, 32),
    (1, 7128, 128, 1, 0, 112), (97, 65, 128, 1, 0, 5), (20000, 100, 128, 1, 0, 1),
    (512, 7128, 128, 1, 3, 3)])
def test_forward_plan_fills_the_sms_in_one_wave(monkeypatch, B, N, queries, per_sm, splits, want):
    """The forward's launch, given the occupancy an H100 reports (132 SMs;
    the kernel's queries per block and the blocks of it an SM holds): as
    many splits per query tile as one wave of resident blocks holds, then
    the fewest that keep each block's share of 16-row candidate tiles; an
    explicit count is taken as it is. At config 3's entity shape 4 query
    tiles of 128 x 32 splits fill 128 SMs, 14 tiles a block."""
    monkeypatch.setattr(S, "_forward_occupancy", lambda dev, d, true: (queries, per_sm, 132))
    plan = S.forward_plan(B, N, 200, False, torch.device("cpu"), splits)
    c_tiles = -(-N // S.FWD_ROWS)
    assert (plan["queries"], plan["splits"]) == (queries, want)
    assert plan["grid"] == -(-B // queries) * want <= max(per_sm * 132, -(-B // queries))
    assert plan["candidate_tiles_per_block"] == -(-c_tiles // want)
    assert plan["blocks_per_sm"] == per_sm


def _check_phase_builds(tool: str) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    module = __import__(tool)
    src = (Path(S.__file__).resolve().parent.parent / "csrc" / "streaming_ce.cu").read_text()
    builds = module.phase_sources()
    assert set(builds) == set(module.PHASES)
    for name, (old, new) in module.PHASES.items():
        assert src.count(old) == 1 and builds[name] == src.replace(old, new), name


def test_diagnosis_phase_builds_cut_the_kernel_source():
    """tools/ce_bwd_x_diagnosis.py --phases times the candidate-side backward
    with one phase of its walk emptied: each edit still finds its one place."""
    _check_phase_builds("ce_bwd_x_diagnosis")


def test_bwd_q_diagnosis_phase_builds_cut_the_kernel_source():
    """tools/ce_bwd_q_diagnosis.py --phases does the same for the query-side
    backward's walk."""
    _check_phase_builds("ce_bwd_q_diagnosis")


def test_fwd_diagnosis_builds_cut_the_kernel_source():
    """tools/ce_fwd_diagnosis.py --phases does the same for the forward's
    walk; its probe build adds its stores to each of the three kernels, and
    its 64-query build its two edits, each at one place."""
    _check_phase_builds("ce_fwd_diagnosis")
    import ce_fwd_diagnosis as tool
    src = (Path(S.__file__).resolve().parent.parent / "csrc" / "streaming_ce.cu").read_text()
    for edits, build in ((tool.PROBE, tool.probe_source()),
                         (tool.QUERIES_64, tool.edited(tool.QUERIES_64))):
        for old, new in edits.values():
            assert src.count(old) == 1 and build.count(new) == 1, old


@pytest.mark.parametrize("bad", ["f64_q", "short_bias", "strided_x", "cq_shape", "scale_shape",
                                 "width_mismatch", "meta_device"])
def test_wrapper_rejects_bad_inputs(bad):
    q, x, bias, target, cq, scale, margin, _ = make_case(8, 20, 4)
    if bad == "f64_q":
        q = q.double()
    elif bad == "short_bias":
        bias = bias[:-1]
    elif bad == "strided_x":
        x = torch.cat([x, x], dim=1)[:, ::2]
    elif bad == "cq_shape":
        cq = cq[:, None]
    elif bad == "scale_shape":
        scale = scale.reshape(1)
    elif bad == "width_mismatch":
        x = x[:, :3].contiguous()
    else:  # neither cuda nor cpu: no path at all
        q, x, bias, cq, scale, margin = (t.to("meta") for t in (q, x, bias, cq, scale, margin))
    with pytest.raises(ValueError):
        S.streaming_nll(q, x, bias, target, cq, scale, margin)


# case -> (B, N, d, true distance, per-query c, near edge, masked query tail)
CUDA_CASES = {
    "entity_config3": (512, 7128, 200, False, False, False, True),
    "relation_config3": (512, 460, 200, False, False, False, True),
    "true_per_query_c": (512, 7128, 200, True, True, False, False),
    "near_edge_proxy": (512, 7128, 200, False, False, True, False),
    "near_edge_true": (512, 7128, 200, True, False, True, False),
    "partial_tiles": (300, 1000, 200, True, True, False, True),
    "narrow": (16, 70, 8, True, False, False, False),
    # the candidate-side backward's cut: 64 candidates per cluster, 32-row query tiles
    "relation_true_per_query_c": (512, 460, 200, True, True, False, False),
    "one_query": (1, 7128, 200, False, False, False, False),
    "b_64": (64, 7128, 200, True, True, False, False),
    "n_below_one_tile": (512, 40, 200, False, False, False, True),
    "n_one_past_a_tile": (300, 65, 200, True, True, False, False),
    "n_one_past_two_tiles": (512, 129, 200, False, False, False, True),
    "b_past_a_query_tile_masked_tail": (97, 1000, 200, False, False, False, True),
}


def assert_kernels_match_float64(case, true, device, masked):
    """The kernels' NLL and six gradients against the plain version in
    float64, within the file's tolerances; one launch of each kernel."""
    B = case[0].shape[0]
    before = (S.ce_forward.launches, S.ce_backward_q.launches, S.ce_backward_x.launches)
    got, got_g = run(S.streaming_nll, case, true, device)
    after = (S.ce_forward.launches, S.ce_backward_q.launches, S.ce_backward_x.launches)
    assert after == tuple(b + 1 for b in before)
    plain, plain_g = run(S.streaming_nll_reference, case, true, device)
    case64 = [t.double() if t.is_floating_point() else t for t in case]
    exact, exact_g = run(S.streaming_nll_reference, case64, true, device)
    torch.cuda.synchronize()
    assert got.shape == (B,) and torch.isfinite(got).all()
    for n, a, p, e, tol in zip(("nll",) + NAMES, [got] + got_g, [plain] + plain_g,
                               [exact] + exact_g, [NLL_TOL] + [GRAD_TOL] * 6):
        assert a.shape == e.shape and torch.isfinite(a).all(), n
        err = (a.double() - e).abs().max().item()
        plain_err = (p.double() - e).abs().max().item()
        assert err <= max(tol * max(1.0, e.abs().max().item()), 2 * plain_err), \
            f"{n}: max err {err}, plain fp32 err {plain_err}"
    if masked:
        assert torch.count_nonzero(got_g[0][B - B // 5:]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CASES))
def test_kernels_match_plain_version(cuda, name):
    B, N, d, true, per_query_c, edge, masked = CUDA_CASES[name]
    case = make_case(B, N, d, true=true, per_query_c=per_query_c, near_edge=edge)
    if masked:  # a zero-gradient padded tail, as the masked mean gives it
        case[-1][B - B // 5:] = 0.0
    assert_kernels_match_float64(case, true, cuda, masked)


def config4_entity_case(seed=4):
    """BASELINE config 4's entity loss: B = 512 queries against N = 7128
    entities at d = 200 on the true distance, each query under its
    relation's curvature anywhere in the clamp's range [REL_C_EPS, 0.999 c],
    a nonzero entity bias, and the padded tail of the triple batch."""
    case = make_case(512, 7128, 200, true=True, per_query_c=True, c_low=PD.REL_C_EPS, seed=seed)
    case[-1][512 - 512 // 5:] = 0.0
    assert case[4].min() < 1e-4 and case[2].abs().max() > 0
    return case


@pytest.mark.cuda
def test_kernels_at_config4_entity_shape(cuda):
    assert_kernels_match_float64(config4_entity_case(), True, cuda, True)


@pytest.mark.cuda
def test_kernels_next_to_a_candidate_at_config4_entity_shape(cuda):
    """Config 4's entity case with 16 queries ~1e-4 from their target, as
    training drives a query towards its target. There the distance's
    expansion cancels terms of ~10 down to a diff_sq of ~1e-8, so the three
    kernels must take each pair's logit from the same p, |q|^2 and |x|^2:
    with |x|^2 summed in another order than the forward's, the candidate-
    side backward's dx of those targets missed float64 by 1.44e-4 on an
    H100, against a limit of 1.22e-4 (the plain version's miss 2.8e-5)."""
    case = config4_entity_case()
    q, x, target = case[0], case[1], case[3]
    rng = np.random.default_rng(5)
    q[:16] = PH.project_to_ball(
        x[target[:16]] + torch.from_numpy(rng.normal(size=(16, 200)).astype(np.float32)) * 1e-5,
        C)
    assert_kernels_match_float64(case, True, cuda, True)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [7128, 460], ids=["entity", "relation"])
def test_kernels_are_deterministic(cuda, N):
    case = make_case(512, N, 200, true=True, per_query_c=True)
    first = run(S.streaming_nll, case, True, cuda)
    second = run(S.streaming_nll, case, True, cuda)
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", range(1, S.MAX_CLUSTER + 1))
def test_backward_x_at_every_cluster_size(cuda, cluster):
    """dx and dbias with the query tiles cut over 1 to 8 blocks of a cluster
    (the wrapper picks one of these): each within the plain version's
    tolerance, and bitwise repeatable."""
    B, N, d = 300, 1000, 200
    q, x, bias, target, cq, scale, margin, g = (
        t.to(cuda) for t in make_case(B, N, d, true=True, per_query_c=True))
    target = target.to(torch.int32)
    _, lse = S.ce_forward(q, x, bias, cq, target, scale, margin, True)
    first = S.ce_backward_x(q, x, bias, cq, target, scale, margin, lse, g, True, cluster)
    second = S.ce_backward_x(q, x, bias, cq, target, scale, margin, lse, g, True, cluster)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, plain_g = run(S.streaming_nll_reference, (q, x, bias, target, cq, scale, margin, g), True,
                     cuda)
    for got, want in zip(first, plain_g[1:3]):
        err = (got - want).abs().max().item()
        assert err <= GRAD_TOL * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_dist_ce_loss_on_cuda_never_runs_the_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(S, "streaming_nll_reference", refuse)
    q, x, bias, target, cq, scale, margin, _ = make_case(64, 500, 200)
    q = q.to(cuda).requires_grad_(True)
    loss = PD.dist_ce_loss(q, x.to(cuda), target.to(cuda), C, candidate_bias=bias.to(cuda),
                           score_scale=scale.to(cuda), score_margin=margin.to(cuda))
    loss.backward()
    assert math.isfinite(loss.item()) and torch.isfinite(q.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["wide", "misaligned"])
def test_shapes_the_kernels_do_not_take_raise_on_cuda(cuda, shape):
    d = {"wide": S.MAX_D + 4, "misaligned": 200}[shape]
    q, x, bias, target, cq, scale, margin, _ = make_case(8, 20, d)
    q, x, bias, target, cq, scale, margin = (t.to(cuda) for t in (q, x, bias, target, cq, scale,
                                                                   margin))
    if shape == "misaligned":  # rows one float past a 16-byte boundary
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(20, d)
    with pytest.raises(ValueError):
        S.streaming_nll(q, x, bias, target, cq, scale, margin)


def test_odd_width_is_padded_exactly_on_cpu():
    """Widths that are no multiple of 4 (ROADMAP C.7): the wrapper pads q
    and x with zero columns, which add nothing to q.x, |q|^2 or |x|^2, and
    drops the padded columns' gradients. At d = 50 on the CPU the padded
    path equals the unpadded plain version (within fp32 rounding of the
    GEMM's other blocking: rtol 1e-6), values and every gradient, and its
    gradients keep the width 50."""
    case = make_case(48, 130, 50, true=True, per_query_c=True)
    for true in (False, True):
        got, got_g = run(S.streaming_nll, case, true, "cpu")
        want, want_g = run(S.streaming_nll_reference, case, true, "cpu")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
        for n, a, b in zip(NAMES, got_g, want_g):
            assert a.shape == b.shape, n
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=n)


def test_widths_past_the_kernels_limit_raise_at_trainer_construction():
    """d > MAX_D on the card raises at construction, naming the limit and
    the width; the plain version on the CPU takes any width."""
    S.check_width(S.MAX_D, "cuda")
    S.check_width(S.MAX_D + 4, "cpu")
    with pytest.raises(ValueError, match=f"up to {S.MAX_D}.*d={S.MAX_D + 4}"):
        S.check_width(S.MAX_D + 4, "cuda")
    from regcn_torch.config import TrainConfig
    from regcn_torch.data import load_data
    from regcn_torch.hyperbolic.model import HyperbolicConfig
    from regcn_torch.hyperbolic.train import HyperbolicTrainer
    data = load_data("synthetic-small", seed=123)
    cfg = HyperbolicConfig(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=S.MAX_D + 4,
                           encoder="lgcn", decoder="roth")
    with pytest.raises(ValueError, match=f"d={S.MAX_D + 4}"):
        HyperbolicTrainer(cfg, TrainConfig(), data, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [50, 300, 512])
@pytest.mark.parametrize("true", [False, True], ids=["proxy", "true_per_query_c"])
def test_kernels_at_the_widths_jax_trains(cuda, d, true):
    """ROADMAP C.7: the widths the kernels once refused, at config 3's
    entity shape: d = 50 (padded to 52), and d = 300 and 512 (the wide
    instances): one launch of each kernel, within the file's tolerances."""
    case = make_case(512, 7128, d, true=true, per_query_c=true)
    case[-1][512 - 512 // 5:] = 0.0
    assert_kernels_match_float64(case, true, cuda, True)


@pytest.mark.cuda
@pytest.mark.parametrize("true", [False, True], ids=["proxy", "true_per_query_c"])
def test_forward_at_every_split_count(cuda, true):
    """nll and lse with the 63 candidate tiles of 16 cut over 1 to 66
    splits, at B = 300 (no multiple of the query tile) and N = 993: the
    last tile holds one candidate, which is a target, so in the last split
    some chain threads see only masked candidates, and from 64 splits on
    whole splits hold no candidate. Each within the plain version's
    tolerance against float64, and bitwise repeatable."""
    B, N, d = 300, 993, 200
    q, x, bias, target, cq, scale, margin, _ = (
        t.to(cuda) for t in make_case(B, N, d, true=true, per_query_c=true))
    target = target.to(torch.int32)
    want = {}
    for dtype in (torch.float32, torch.float64):
        a = [t.to(dtype) for t in (q, x, bias, cq, scale, margin)]
        logits = S.distance_logits(a[0], a[1], a[3][:, None], bias=a[2], scale=a[4],
                                   margin=a[5], true_dist=true)
        lse = torch.logsumexp(logits, dim=1)
        want[dtype] = (lse - logits.gather(1, target.long()[:, None])[:, 0], lse)
    c_tiles = -(-N // S.FWD_ROWS)
    for splits in range(1, c_tiles + 4):
        first = S.ce_forward(q, x, bias, cq, target, scale, margin, true, splits)
        second = S.ce_forward(q, x, bias, cq, target, scale, margin, true, splits)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), splits
        for name, got, plain, exact in zip(("nll", "lse"), first, want[torch.float32],
                                           want[torch.float64]):
            err = (got.double() - exact).abs().max().item()
            plain_err = (plain.double() - exact).abs().max().item()
            assert err <= max(NLL_TOL * max(1.0, exact.abs().max().item()), 2 * plain_err), \
                f"{name} at {splits} splits: max err {err}, plain fp32 err {plain_err}"


@pytest.mark.cuda
@pytest.mark.parametrize("cluster, splits", [(c, 0) for c in range(1, S.MAX_CLUSTER_Q + 1)]
                         + [(1, 1), (2, 3), (4, 8), (1, 32)])
def test_backward_q_at_every_cluster_size(cuda, cluster, splits):
    """dq, dc, dscale and dmargin with the candidate tiles cut over 1 to 16
    blocks of a cluster and over one or more clusters per query tile (the
    wrapper picks one of these; (4, 8) needs two waves of clusters): each
    within the plain version's tolerance, and bitwise repeatable."""
    B, N, d = 300, 1000, 200
    q, x, bias, target, cq, scale, margin, g = (
        t.to(cuda) for t in make_case(B, N, d, true=True, per_query_c=True))
    target = target.to(torch.int32)
    _, lse = S.ce_forward(q, x, bias, cq, target, scale, margin, True)
    first = S.ce_backward_q(q, x, bias, cq, target, scale, margin, lse, g, True, cluster, splits)
    second = S.ce_backward_q(q, x, bias, cq, target, scale, margin, lse, g, True, cluster, splits)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    _, plain_g = run(S.streaming_nll_reference, (q, x, bias, target, cq, scale, margin, g), True,
                     cuda)
    for got, want in zip(first, [plain_g[0], plain_g[3], plain_g[4], plain_g[5]]):
        err = (got - want).abs().max().item()
        assert err <= GRAD_TOL * max(1.0, want.abs().max().item()), err
