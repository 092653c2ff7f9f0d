#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``regcn_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them; turns TF32 off for matmul and
   cuDNN so every comparison is in full fp32;
2. build: compiles every CUDA kernel of the main path from the sources in
   ``regcn_torch/csrc/``, all ``nvcc`` processes at once;
3. kernels: holds each kernel against its plain PyTorch version on the
   card, in several cases, within 1e-5 * max(1, max|plain|) (fp32 on both
   sides; the summation order is the only difference), and times the
   kernel, the plain version and one library call for the same function;
   the scatter (B1) at config 1's first test snapshot, a skewed E=4096
   case and the first test snapshot of synthetic-icews18, each beside
   zeros + index_add_ and its bound (the JSON row's top-level times are
   config 1's, ``shapes`` holds all three);
4. main path: RE-GCN config 1 (h=200, 2 UnionRGCN layers, history 3,
   ConvTransE/R) with random weights from a seeded generator, evaluated
   over the whole test split of synthetic-icews14s (seed 123) through
   ``regcn_torch.train.loop.test``. The kernels' launch counts are reset
   just before and read just after; the first test snapshot's scores must
   match a CPU run of the same parameters;
5. streaming-CE kernels (B2): the forward and both backward kernels
   against the plain version in seven cases (the config-3 entity and
   relation shapes, the true distance with per-query curvature, points at
   the ball's edge on both distances, partial tiles, a masked query
   tail), value and all six gradients; the kernels, the plain version
   and the GEMM of the same shape are timed at both config-3 shapes, and
   the candidate-side backward's grid, cluster size and blocks per SM
   are printed;
6. training path: hyperbolic config 3 (LGCN + RotH, c=0.01 learned with
   a 5-epoch warmup, radius supervision, h=200, 2 layers, n_bases 100,
   history 3) through ``regcn_torch.hyperbolic.train.HyperbolicTrainer``:
   (a) 3 steps on the card, each checked against the CPU from the same
   state (dropouts 0): the losses, every parameter's gradient and the
   optimizer's update; (b) one full epoch with the config's
   dropouts, the kernels' launch counts reset just before and read just
   after (B2 forward and both backward kernels: 2 per step); (c) the
   test split's four MRRs; (d) a few steps under torch.profiler.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from regcn_torch.config import ModelConfig, TrainConfig  # noqa: E402
from regcn_torch.data.snapshots import (  # noqa: E402
    build_history,
    build_snapshot,
    pad_triples,
    split_by_time,
)
from regcn_torch.data.synthetic import generate  # noqa: E402
from regcn_torch.hyperbolic.model import HyperbolicConfig  # noqa: E402
from regcn_torch.hyperbolic.ops import exp_map_zero  # noqa: E402
from regcn_torch.hyperbolic.train import HyperbolicTrainer, tree_leaves  # noqa: E402
from regcn_torch.models import recurrent  # noqa: E402
from regcn_torch.ops import cuda_build  # noqa: E402
from regcn_torch.ops import streaming_ce as ce  # noqa: E402
from regcn_torch.ops.rgcn_scatter import (  # noqa: E402
    rgcn_aggregate,
    scatter_add_sorted,
    scatter_add_sorted_reference,
)
from regcn_torch.train import loop  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNEL_TOL = 1e-5  # relative to max(1, max|plain|): fp32 summation order only
CPU_SCORE_TOL = 1e-4  # relative to max(1, max|cpu score|): fp32 GEMM/conv order
SEED = 123
# streaming CE: both sides against the plain version in float64; the
# kernels may miss it by the larger of these (times max(1, max|exact|)) and
# twice the fp32 plain version's own miss (fp32 itself is inaccurate at
# the ball's edge, where artanh' amplifies rounding ~1000x)
CE_NLL_TOL = 1e-5  # fp32 logsumexp in another order
CE_GRAD_TOL = 1e-4  # each gradient entry sums thousands of cancelling terms
# elementwise operations per (query, candidate) pair besides the q.x
# products, read off the kernels' source: ~30 for a logit, ~90 for a logit,
# its softmax weight and the chain rule back to p, |q|^2, |x|^2 and c
CE_FWD_OPS, CE_BWD_OPS = 30, 90
# training path, CUDA against CPU from the same parameters (dropouts 0)
TRAIN_LOSS_RTOL = 1e-4  # fp32 sums in another order on each side
TRAIN_GRAD_TOL = 1e-4  # per parameter, relative to max(1, max|cpu grad|)
# the optimizer step on both devices from the same parameters, moments and
# gradients: fp32 rounding of the clip norm and of m / sqrt(v) only, each
# entry within this times max(1, |cpu parameter|)
TRAIN_OPT_TOL = 1e-6
PROFILE_STEPS = 20

# Every kernel of the main path: its csrc source, the wrapper whose
# ``launches`` counts it, and the TPU kernel it replaces.
KERNELS = [
    dict(name="rgcn_scatter_sorted", route="cuda", build="rgcn_scatter",
         source="regcn_torch/csrc/rgcn_scatter.cu", wrapper=scatter_add_sorted,
         replaces="regcn_tpu/ops/pallas_rgcn.py:38"),
    dict(name="streaming_ce_fwd", route="cuda", build="streaming_ce",
         source="regcn_torch/csrc/streaming_ce.cu", wrapper=ce.ce_forward,
         replaces="regcn_tpu/ops/pallas_scoring.py:42"),
    dict(name="streaming_ce_bwd_q", route="cuda", build="streaming_ce",
         source="regcn_torch/csrc/streaming_ce.cu", wrapper=ce.ce_backward_q,
         replaces="regcn_tpu/ops/pallas_scoring.py:211"),
    dict(name="streaming_ce_bwd_x", route="cuda", build="streaming_ce",
         source="regcn_torch/csrc/streaming_ce.cu", wrapper=ce.ce_backward_x,
         replaces="regcn_tpu/ops/pallas_scoring.py:211"),
]
CE_KERNELS = ("streaming_ce_fwd", "streaming_ce_bwd_q", "streaming_ce_bwd_x")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def device_time_ms(fn, reps: int = 100, trials: int = 5) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph, the
    graph replayed ``trials`` times between CUDA events; the median trial."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def reset_launches() -> None:
    for k in KERNELS:
        k["wrapper"].launches = 0


def read_launches() -> dict:
    return {k["name"]: k["wrapper"].launches for k in KERNELS}


def phase_device() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    try:
        logs = cuda_build.build(sorted({k["build"] for k in KERNELS}))
    except RuntimeError as e:
        fail(str(e))
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(logs)} source(s), {len(KERNELS)} kernel wrappers, built in "
          f"{seconds:.2f} s", flush=True)


def scatter_bound_ms(n_real: int, E: int, n: int, d: int) -> tuple:
    """Least time for the weighted, scaled scatter: read the real edges'
    messages, the keys, the edge weights and the row scales once, write
    the output once; one multiply-add per message element plus one
    multiply per output element."""
    nbytes = 4 * (n_real * d + 2 * E + n + n * d)
    flops = 2 * n_real * d + n * d
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def first_test_snapshot(data, dev: torch.device):
    """The first test snapshot as the main path builds it, padded to at
    least 640 edge slots (a dst=0 tail after the destination-sorted real
    edges), and its scatter keys (masked edges keyed N)."""
    N = data.num_nodes
    first = split_by_time(data.test)[0]
    snap = build_snapshot(first, N, data.num_rels, edge_pad=max(640, 2 * len(first))).to(dev)
    keys = torch.where(snap.edge_mask > 0, snap.dst, N).to(torch.int32)
    return snap, keys


def scatter_times(msg, keys, N: int, n_real: int, edge_weight, row_scale) -> dict:
    """Device time per call of the kernel, its plain version and one
    library call for the sum (zeros + index_add_; masked keys land in a
    spare row N), with the bound, at one shape."""
    E, d = msg.shape
    kw = dict(edge_weight=edge_weight, row_scale=row_scale)
    ms = device_time_ms(lambda: scatter_add_sorted(msg, keys, N, **kw))
    plain_ms = device_time_ms(lambda: scatter_add_sorted_reference(msg, keys, N, **kw))
    library_ms = device_time_ms(
        lambda: torch.zeros(N + 1, d, device=msg.device).index_add_(0, keys, msg))
    bound_ms, bound_by = scatter_bound_ms(n_real, E, N, d)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase_kernels(data, N: int, R: int, d: int, dev: torch.device) -> dict:
    g = np.random.default_rng(SEED)
    h = torch.from_numpy(g.normal(size=(N, d)).astype(np.float32)).to(dev)
    rel_emb = torch.from_numpy(g.normal(size=(2 * R, d)).astype(np.float32)).to(dev)
    weight = torch.from_numpy((g.normal(size=(d, d)) / math.sqrt(d)).astype(np.float32)).to(dev)

    snap, keys = first_test_snapshot(data, dev)
    check(bool(snap.dst[-1] == 0) and bool(snap.edge_mask[-1] == 0), "expected a padded dst=0 tail")
    msg = (h[snap.src] + rel_emb[snap.rel]) @ weight
    E, n_real = msg.shape[0], snap.num_edges

    errs = {}

    def compare(case, got, want):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        check(math.isfinite(err) and err <= KERNEL_TOL * scale,
              f"{case}: max|kernel - plain| = {err:.3e} > {KERNEL_TOL:.0e} * {scale:.3e}")
        errs[case] = err
        print(f"[kernels] rgcn_scatter_sorted {case}: max abs err {err:.3e} (scale {scale:.3e})",
              flush=True)

    def busiest(k, n):
        return int(torch.bincount(k.long(), minlength=n + 1)[:n].max().item())

    args = (msg, keys, N)
    kw = dict(edge_weight=snap.edge_mask, row_scale=snap.in_deg_norm)
    compare(f"config1 E={E} real={n_real} N={N} d={d} busiest row {busiest(keys, N)} edges",
            scatter_add_sorted(*args, **kw), scatter_add_sorted_reference(*args, **kw))
    first = scatter_add_sorted(*args, **kw)
    check(torch.equal(first, scatter_add_sorted(*args, **kw)), "config1: two calls differ")

    # skewed: zipf-popular destinations, hundreds of edges on one row
    E_skew = 4096
    skew_keys = np.sort(g.zipf(1.3, E_skew) % N).astype(np.int32)
    top = int(np.bincount(skew_keys).max())
    check(top >= 100, f"skewed case has only {top} edges on its busiest row")
    sk = [torch.from_numpy(a).to(dev) for a in (
        g.normal(size=(E_skew, d)).astype(np.float32), skew_keys,
        g.random(E_skew).astype(np.float32), g.random(N).astype(np.float32))]
    compare(f"skewed E={E_skew} busiest row {top} edges",
            scatter_add_sorted(sk[0], sk[1], N, edge_weight=sk[2], row_scale=sk[3]),
            scatter_add_sorted_reference(sk[0], sk[1], N, sk[2], sk[3]))

    # the ICEWS18 twin's first test snapshot, built as config 1's is
    data18 = generate("synthetic-icews18", seed=SEED)
    N18 = data18.num_nodes
    snap18, keys18 = first_test_snapshot(data18, dev)
    h18 = torch.from_numpy(g.normal(size=(N18, d)).astype(np.float32)).to(dev)
    rel18 = torch.from_numpy(g.normal(size=(2 * data18.num_rels, d)).astype(np.float32)).to(dev)
    msg18 = (h18[snap18.src] + rel18[snap18.rel]) @ weight
    kw18 = dict(edge_weight=snap18.edge_mask, row_scale=snap18.in_deg_norm)
    compare(f"ICEWS18 twin E={msg18.shape[0]} real={snap18.num_edges} N={N18} busiest row "
            f"{busiest(keys18, N18)} edges", scatter_add_sorted(msg18, keys18, N18, **kw18),
            scatter_add_sorted_reference(msg18, keys18, N18, **kw18))

    # not sorted: a hand-built edge order through rgcn_aggregate(dst_sorted=False)
    perm = torch.from_numpy(g.permutation(E)).to(dev)
    src_p, dst_p, rel_p, mask_p = (snap.src[perm], snap.dst[perm], snap.rel[perm],
                                   snap.edge_mask[perm])
    msg_p = (h[src_p] + rel_emb[rel_p]) @ weight
    compare("unsorted via rgcn_aggregate",
            rgcn_aggregate(h, rel_emb, weight, src_p, dst_p, rel_p, mask_p, snap.in_deg_norm,
                           dst_sorted=False),
            scatter_add_sorted_reference(msg_p, torch.where(mask_p > 0, dst_p, N).to(torch.int32),
                                         N, mask_p, snap.in_deg_norm))

    # fully masked: every key is N, every row must be exactly zero
    masked = torch.full_like(keys, N)
    got = scatter_add_sorted(msg, masked, N, edge_weight=torch.zeros_like(snap.edge_mask),
                             row_scale=snap.in_deg_norm)
    compare("fully masked", got, scatter_add_sorted_reference(msg, masked, N))
    check(torch.count_nonzero(got).item() == 0, "fully masked input gave non-zero rows")

    # times, device time per call, at three shapes
    shapes = [
        (f"config1 E={E} N={N}", scatter_times(msg, keys, N, n_real, **kw)),
        (f"skewed E={E_skew} N={N}",
         scatter_times(sk[0], sk[1], N, E_skew, edge_weight=sk[2], row_scale=sk[3])),
        (f"ICEWS18 twin E={msg18.shape[0]} N={N18}",
         scatter_times(msg18, keys18, N18, snap18.num_edges, **kw18)),
    ]
    for label, t in shapes:
        print(f"[kernels] rgcn_scatter_sorted at {label} d={d}: kernel {t['ms'] * 1e3:.2f} us, "
              f"plain {t['plain_ms'] * 1e3:.2f} us, zeros + index_add_ "
              f"{t['library_ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']}; kernel at {100 * t['bound_ms'] / t['ms']:.0f} % of it)",
              flush=True)
    return {"rgcn_scatter_sorted": dict(
        max_abs_err=max(errs.values()), **shapes[0][1],
        shapes=[dict(shape=label, **t) for label, t in shapes])}


def phase_main_path(data, cfg: ModelConfig, tc: TrainConfig, dev: torch.device) -> dict:
    params, state = recurrent.init_params(torch.Generator().manual_seed(SEED), cfg, device=dev)
    n_test = len(split_by_time(data.test))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = loop.test(params, state, cfg, tc, data, device=dev)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_launches()
    check(all(launches[k] == 0 for k in CE_KERNELS), f"config 1 launched a CE kernel: {launches}")

    expected = cfg.n_layers * tc.test_history_len * n_test
    check(launches["rgcn_scatter_sorted"] == expected,
          f"scatter kernel launched {launches['rgcn_scatter_sorted']} times on the main path, "
          f"expected {expected} = {cfg.n_layers} layers x {tc.test_history_len} steps x "
          f"{n_test} snapshots")
    for key, st in stats.items():
        check(math.isfinite(st.mrr) and 0.0 < st.mrr <= 1.0, f"{key} MRR {st.mrr} not in (0, 1]")
    print(f"[main] test split: {n_test} snapshots, {stats['ent_raw'].count} queries, "
          f"{total_s:.3f} s total, {total_s / n_test * 1e3:.2f} ms per snapshot", flush=True)
    print("[main] MRR " + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items()), flush=True)

    # every rank in range, from the same rolling evaluation run again
    train, valid, test = (split_by_time(getattr(data, s)) for s in ("train", "valid", "test"))
    ranks = loop.rolling_ranks(params, state, cfg, tc, train + valid, test, device=dev)
    for key, arrs in ranks.items():
        hi = cfg.num_ents if key.startswith("ent") else cfg.num_rels_total
        allr = np.concatenate(arrs)
        check(len(allr) == stats[key].count and allr.min() >= 1 and allr.max() <= hi,
              f"{key}: {len(allr)} ranks in [{allr.min()}, {allr.max()}], expected "
              f"{stats[key].count} in [1, {hi}]")

    # the first test snapshot on cuda against the same parameters on the CPU
    history = build_history((train + valid)[-tc.test_history_len:], cfg.num_ents, cfg.num_rels,
                            edge_bucket=tc.edge_bucket, rc_bucket=tc.rc_bucket)
    triples = torch.from_numpy(pad_triples(test[0], cfg.num_rels, tc.triple_bucket)[0]).long()
    with torch.inference_mode():
        gpu = recurrent.predict(params, state, cfg, history.to(dev), triples.to(dev))
        cpu_state = recurrent.ModelState(bn_ob=recurrent.tree_to(state.bn_ob, "cpu"),
                                         bn_rel=recurrent.tree_to(state.bn_rel, "cpu"))
        cpu = recurrent.predict(recurrent.tree_to(params, "cpu"), cpu_state, cfg,
                                history.to("cpu"), triples)
    for name, a, b in zip(("entity", "relation"), gpu, cpu):
        err = (a.cpu() - b).abs().max().item()
        scale = max(1.0, b.abs().max().item())
        check(a.shape == b.shape and math.isfinite(err) and err <= CPU_SCORE_TOL * scale,
              f"{name} scores on cuda vs cpu: max abs err {err:.3e} > {CPU_SCORE_TOL:.0e} * "
              f"{scale:.3e}")
        print(f"[main] {name} scores {tuple(a.shape)} cuda vs cpu: max abs err {err:.3e} "
              f"(scale {scale:.3e})", flush=True)
    device_breakdown(params, state, cfg, tc, data, dev)
    return launches


def device_breakdown(params, state, cfg, tc, data, dev) -> None:
    """Where the main path's time goes: the test split once more under
    torch.profiler; device busy time by kernel against the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_test = len(split_by_time(data.test))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop.test(params, state, cfg, tc, data, device=dev)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"[profile] test split under torch.profiler: wall {wall_us / n_test / 1e3:.2f} ms, "
          f"device busy {busy_us / n_test / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %), "
          f"{launches / n_test:.0f} kernels and copies per snapshot", flush=True)
    for e in kernels[:8]:
        print(f"[profile]   {e.self_device_time_total / n_test:9.1f} us/snapshot "
              f"{e.count / n_test:5.0f}x  {e.key[:90]}", flush=True)


# ------------------------------------------------------- streaming CE (B2)

def ce_case(B, N, d, dev, *, true=False, per_query_c=False, near_edge=False, masked=False,
            seed=SEED):
    """Inputs of the streaming CE on ``dev`` from a seeded numpy generator:
    ball points for c = 0.01 (per-query curvatures at most 0.999 c, as the
    relation-curvature clamp bounds them), targets in the last partial
    tile, an upstream gradient g that is 0 on a masked query tail."""
    rng = np.random.default_rng(seed)
    c = 0.01

    def ball(n):
        return exp_map_zero(torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32) * 0.4),
                            c).numpy()

    q, x = ball(B), ball(N)
    if near_edge:
        # antipodal pairs at radius 9.995 of the ball's 10 (the true
        # distance's max-norm clamp binds) and candidates past the edge
        # (the proxy's clamp binds)
        u = q[:8] / np.linalg.norm(q[:8], axis=1, keepdims=True)
        q[:8], x[:8], x[8:16] = 9.995 * u, -9.995 * u, -12.0 * u
    target = rng.integers(0, N, B)
    target[:4] = N - 1 - np.arange(4)
    cq = (rng.uniform(0.005, 0.999 * c, B) if per_query_c else np.full(B, c)).astype(np.float32)
    g = rng.random(B).astype(np.float32)
    if masked:
        g[B - B // 5:] = 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return dict(q=t(q.astype(np.float32)), x=t(x.astype(np.float32)),
                bias=t((rng.normal(size=N) * 0.1).astype(np.float32)), target=t(target),
                cq=t(cq), scale=torch.tensor(1.3, device=dev), margin=torch.tensor(0.7, device=dev),
                g=t(g), true=true)


CE_INPUTS = ("q", "x", "bias", "cq", "scale", "margin")


def ce_run(fn, a, dtype=torch.float32):
    """(nll, {input: gradient}) of ``fn`` with autograd, in ``dtype``."""
    leaves = {k: a[k].to(dtype).detach().requires_grad_(True) for k in CE_INPUTS}
    nll = fn(leaves["q"], leaves["x"], leaves["bias"], a["target"], leaves["cq"],
             leaves["scale"], leaves["margin"], a["true"])
    grads = torch.autograd.grad(nll, list(leaves.values()), a["g"].to(dtype))
    return nll.detach(), dict(zip(CE_INPUTS, grads))


def ce_bound_ms(B, N, d) -> dict:
    """Least time of each kernel: each input read once, each output
    written once, over HBM; the q.x products (and the dq or dx product of
    the backward kernels) plus the elementwise work over fp32 peak."""
    def bound(nbytes, flops):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    inputs = 4 * (B * d + N * d + N + 3 * B + 2)  # q, x, bias, cq, target, scale, margin
    return {
        "streaming_ce_fwd": bound(inputs + 4 * 2 * B, 2 * B * N * d + CE_FWD_OPS * B * N),
        "streaming_ce_bwd_q": bound(inputs + 4 * 2 * B + 4 * (B * d + B + 2),
                                    4 * B * N * d + CE_BWD_OPS * B * N),
        "streaming_ce_bwd_x": bound(inputs + 4 * 2 * B + 4 * (N * d + N),
                                    4 * B * N * d + CE_BWD_OPS * B * N),
    }


def ce_times(a) -> dict:
    """Device time per call of each kernel, of the plain version's share of
    the same work, and of the library GEMM of the same shape."""
    q, x, bias, target, cq = a["q"], a["x"], a["bias"], a["target"].to(torch.int32), a["cq"]
    scale, margin, g, true = a["scale"], a["margin"], a["g"], a["true"]
    B, N = q.shape[0], x.shape[0]
    nll, lse = ce.ce_forward(q, x, bias, cq, target, scale, margin, true)
    kernel = {
        "streaming_ce_fwd": lambda: ce.ce_forward(q, x, bias, cq, target, scale, margin, true),
        "streaming_ce_bwd_q": lambda: ce.ce_backward_q(q, x, bias, cq, target, scale, margin,
                                                       lse, g, true),
        "streaming_ce_bwd_x": lambda: ce.ce_backward_x(q, x, bias, cq, target, scale, margin,
                                                       lse, g, true),
    }
    leaves = {k: a[k].detach().clone().requires_grad_(True) for k in CE_INPUTS}

    def plain(wrt=()):
        nll = ce.streaming_nll_reference(leaves["q"], leaves["x"], leaves["bias"], target,
                                         leaves["cq"], leaves["scale"], leaves["margin"], true)
        if wrt:
            torch.autograd.grad(nll, [leaves[k] for k in wrt], g)

    gq = torch.rand(B, N, device=q.device)
    out = {}
    plain_fwd = device_time_ms(plain)
    for name, wrt, lib in (
            ("streaming_ce_fwd", (), lambda: torch.matmul(q, x.T)),
            ("streaming_ce_bwd_q", ("q", "cq", "scale", "margin"), lambda: torch.matmul(gq, x)),
            ("streaming_ce_bwd_x", ("x", "bias"), lambda: torch.matmul(gq.T, q))):
        ms = device_time_ms(kernel[name])
        # the plain backward's share: forward + gradients, less the forward
        plain_ms = plain_fwd if not wrt else device_time_ms(lambda: plain(wrt)) - plain_fwd
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=device_time_ms(lib))
    for name, (bound_ms, bound_by) in ce_bound_ms(B, N, q.shape[1]).items():
        out[name].update(bound_ms=bound_ms, bound_by=bound_by)
    return out


def phase_ce_kernels(N: int, R: int, d: int, dev: torch.device) -> dict:
    B = 512  # config 3's padded triple batch
    cases = {
        "entity B=512 N=7128 proxy, scalar c": dict(B=B, N=N, masked=True),
        "relation B=512 N=460 proxy, bias": dict(B=B, N=2 * R, masked=True),
        "true distance, per-query c": dict(B=B, N=N, true=True, per_query_c=True),
        "ball edge, proxy (clamp binds)": dict(B=B, N=N, near_edge=True),
        "ball edge, true distance (clamp binds)": dict(B=B, N=N, true=True, near_edge=True),
        "N=1000 B=300: partial tiles, targets in the last": dict(B=300, N=1000, true=True,
                                                                per_query_c=True),
        "masked query tail": dict(B=B, N=N, masked=True, seed=SEED + 1),
    }
    errs = {k: 0.0 for k in CE_KERNELS}
    for label, kw in cases.items():
        a = ce_case(kw.pop("B"), kw.pop("N"), d, dev, **kw)
        got, got_g = ce_run(ce.streaming_nll, a)
        plain, plain_g = ce_run(ce.streaming_nll_reference, a)
        exact, exact_g = ce_run(ce.streaming_nll_reference, a, torch.float64)
        torch.cuda.synchronize()
        parts = []
        for name, kern, tol, (k, p, e) in [("nll", "streaming_ce_fwd", CE_NLL_TOL,
                                           (got, plain, exact))] + [
                (n, "streaming_ce_bwd_x" if n in ("x", "bias") else "streaming_ce_bwd_q",
                 CE_GRAD_TOL, (got_g[n], plain_g[n], exact_g[n])) for n in CE_INPUTS]:
            err = (k.double() - e).abs().max().item()
            plain_err = (p.double() - e).abs().max().item()
            limit = max(tol * max(1.0, e.abs().max().item()), 2 * plain_err)
            check(k.shape == e.shape and math.isfinite(err) and err <= limit,
                  f"streaming CE {label}: {name} max err {err:.3e} > {limit:.3e} "
                  f"(plain fp32 err {plain_err:.3e})")
            errs[kern] = max(errs[kern], (k - p).abs().max().item())
            parts.append(f"{name} {err:.1e}/{plain_err:.1e}")
        if "tail" in label:
            check(torch.count_nonzero(got_g["q"][a["g"] == 0]).item() == 0,
                  "masked query rows got a gradient")
        print(f"[ce] {label}: kernel/plain-fp32 max err vs fp64: " + ", ".join(parts), flush=True)
    times = {}
    for label, n in (("entity", N), ("relation", 2 * R)):
        t = ce_times(ce_case(B, n, d, dev))
        for name, row in t.items():
            print(f"[ce] {name} at the {label} shape B={B} N={n} d={d}: kernel "
                  f"{row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f} us, matmul "
                  f"{row['library_ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us "
                  f"({row['bound_by']})", flush=True)
        plan = ce.backward_x_plan(B, n, d, False, dev)
        print(f"[ce] streaming_ce_bwd_x launch at the {label} shape: grid {plan['grid']} blocks "
              f"in clusters of {plan['cluster']} ({plan['query_tiles_per_block']} query tiles of "
              f"{ce.BWD_X_ROWS} rows per block), {plan['blocks_per_sm']} block(s) per SM, "
              f"{plan['active_clusters']} clusters resident at once", flush=True)
        times[label] = t
    return {k: dict(max_abs_err=errs[k], **times["entity"][k]) for k in CE_KERNELS}


# ------------------------------------------------------- training path

def config3(data, **kw) -> HyperbolicConfig:
    """BASELINE.json config 3 at full width: LGCN + RotH, c = 0.01 learned,
    radius supervision (the README's ``hyperbolic --encoder lgcn --decoder
    roth --learn-curvature``), with the CLI's defaults otherwise."""
    return HyperbolicConfig(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=200,
                            n_layers=2, encoder="lgcn", decoder="roth", n_bases=100, c=0.01,
                            learn_curvature=True, **kw)


def leaf_names(tree, prefix: str = "") -> list:
    """The dotted names of a parameter tree's tensors, in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in tree for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def copy_state_into(dst, src) -> None:
    """Parameters and Adam moments of ``src`` into ``dst``, in place."""
    with torch.no_grad():
        for a, b in zip(tree_leaves(dst.params) + dst.opt_state.mu + dst.opt_state.nu,
                        tree_leaves(src.params) + src.opt_state.mu + src.opt_state.nu):
            a.copy_(b)
    dst.opt_state.count, dst.step = src.opt_state.count, src.step


def phase_training(data, dev: torch.device) -> dict:
    tc = TrainConfig(train_history_len=3, test_history_len=3)
    no_dropout = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)

    # (a) 3 steps on the card; before each, the CPU takes the card's state,
    # and both compute the step from it: the losses, each parameter's
    # gradient, and the optimizer's update given the card's gradients
    t0 = time.perf_counter()
    gpu = HyperbolicTrainer(config3(data, **no_dropout), tc, data, curvature_warmup_epochs=5,
                            device=dev)
    cpu = HyperbolicTrainer(config3(data, **no_dropout), tc, data, curvature_warmup_epochs=5,
                            device="cpu")
    s_gpu = gpu.init_state(SEED)
    s_cpu = cpu.state_from(s_gpu.params, s_gpu.model_state)
    order, cmax = gpu.epoch_order(0)[:3], gpu._curvature_max(0)
    worst_grad = worst_opt = 0.0
    for i in order:
        copy_state_into(s_cpu, s_gpu)
        grads, losses = [], []
        for tr, st in ((gpu, s_gpu), (cpu, s_cpu)):
            total, parts = tr.loss(st, *tr.window(i), cmax)
            grads.append(torch.autograd.grad(total, tree_leaves(st.params), allow_unused=True))
            losses.append({k: float(v.detach()) for k, v in parts.items()})
        for k, b in losses[1].items():
            a = losses[0][k]
            check(math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * max(1.0, abs(b)),
                  f"step on snapshot {i}: {k} loss cuda {a} vs cpu {b}")
        names = leaf_names(s_gpu.params)
        for name, a, b in zip(names, *grads):
            check((a is None) == (b is None), f"step on snapshot {i}: {name} has a gradient on "
                  "one device only")
            if a is None:
                continue
            err = (a.cpu() - b).abs().max().item() / max(1.0, b.abs().max().item())
            check(err <= TRAIN_GRAD_TOL, f"step on snapshot {i}: {name} gradient cuda vs cpu "
                  f"{err:.3e} > {TRAIN_GRAD_TOL:.0e} of its largest entry")
            worst_grad = max(worst_grad, err)
        gpu_grads = [None if g is None else g.cpu() for g in grads[0]]
        gpu.opt.step(tree_leaves(s_gpu.params), grads[0], s_gpu.opt_state)
        cpu.opt.step(tree_leaves(s_cpu.params), gpu_grads, s_cpu.opt_state)
        s_gpu.step += 1
        s_cpu.step += 1
        for name, a, b in zip(names, tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)):
            err = ((a.detach().cpu() - b.detach()).abs() / b.detach().abs().clamp(min=1.0)).max()
            check(err.item() <= TRAIN_OPT_TOL, f"step on snapshot {i}: {name} after the "
                  f"optimizer step cuda vs cpu {err.item():.3e} > {TRAIN_OPT_TOL:.0e}")
            worst_opt = max(worst_opt, err.item())
        print(f"[train] step on snapshot {i}: losses cuda/cpu "
              + ", ".join(f"{k} {losses[0][k]:.6f}/{losses[1][k]:.6f}" for k in losses[0]),
              flush=True)
    print(f"[train] (a) 3 steps cuda vs cpu from the same state: every gradient within "
          f"{worst_grad:.2e} of its parameter's largest entry, every parameter after the "
          f"optimizer step within {worst_opt:.2e} ({time.perf_counter() - t0:.1f} s)", flush=True)

    # (b) one full epoch with the config's dropouts, through the kernels
    trainer = HyperbolicTrainer(config3(data), tc, data, curvature_warmup_epochs=5, device=dev)
    state = trainer.init_state(SEED)
    steps = len(trainer.train_list) - 1
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.run_epoch(state, 0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = read_launches()
    # the means are finite only if every step's losses were
    check(all(math.isfinite(v) for v in losses.values()), f"epoch losses {losses}")
    for k in CE_KERNELS:
        check(launches[k] == 2 * steps, f"{k} launched {launches[k]} times in an epoch of "
              f"{steps} steps, expected {2 * steps} (entity + relation loss per step)")
    print(f"[train] (b) epoch 0: {steps} steps in {epoch_s:.2f} s = {steps / epoch_s:.2f} "
          f"snapshots/s (first epoch: includes building the {steps} windows); mean losses "
          + ", ".join(f"{k} {v:.5f}" for k, v in losses.items()) + f"; launches {launches}",
          flush=True)

    # steady state: the next epoch's first steps, windows built
    order = trainer.epoch_order(1)[:PROFILE_STEPS]
    cmax = trainer._curvature_max(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in order:
        trainer.train_step(state, *trainer.window(i), cmax)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    print(f"[train] steady state: {len(order)} steps in {steady_s:.3f} s = "
          f"{len(order) / steady_s:.2f} snapshots/s, {steady_s / len(order) * 1e3:.2f} ms "
          "per step", flush=True)

    # (c) the test split
    t0 = time.perf_counter()
    stats = trainer.test(state)
    for key, st in stats.items():
        check(math.isfinite(st.mrr) and 0.0 < st.mrr <= 1.0, f"{key} MRR {st.mrr} not in (0, 1]")
    print(f"[train] (c) test split after one epoch ({time.perf_counter() - t0:.1f} s): MRR "
          + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items()), flush=True)

    # (d) where a step's time goes
    train_profile(trainer, state, trainer.epoch_order(2)[:PROFILE_STEPS],
                  trainer._curvature_max(2))
    return launches


def train_profile(trainer, state, order, cmax) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in order:
            trainer.train_step(state, *trainer.window(i), cmax)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = len(order)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] train step under torch.profiler: wall {wall_us / n / 1e3:.2f} ms, device "
          f"busy {busy_us / n / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels and copies per step", flush=True)
    for e in kernels[:10]:
        print(f"[profile]   {e.self_device_time_total / n:9.1f} us/step "
              f"{e.count / n:5.0f}x  {e.key[:90]}", flush=True)


def main() -> None:
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[phase] {name}: {seconds[name]:.1f} s", flush=True)
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    data = generate("synthetic-icews14s", seed=SEED)
    cfg = ModelConfig(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=200, n_layers=2)
    tc = TrainConfig(train_history_len=3, test_history_len=3, edge_bucket=128, rc_bucket=128,
                     triple_bucket=128)
    dev = torch.device("cuda")
    timing = timed("scatter kernel", phase_kernels, data, cfg.num_ents, cfg.num_rels,
                   cfg.h_dim, dev)
    launches = timed("config-1 test split", phase_main_path, data, cfg, tc, dev)
    timing.update(timed("streaming-CE kernels", phase_ce_kernels, cfg.num_ents, cfg.num_rels,
                        cfg.h_dim, dev))
    train_launches = timed("config-3 training", phase_training, data, dev)
    launches.update({k: train_launches[k] for k in CE_KERNELS})
    rows = [dict(name=k["name"], route=k["route"], source=k["source"], replaces=k["replaces"],
                 launches=launches[k["name"]], **timing[k["name"]]) for k in KERNELS]
    print(f"[phase] total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
