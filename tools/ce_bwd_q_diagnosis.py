#!/usr/bin/env python3
"""The query-side backward of the streaming CE (kernel B2's
``ce_backward_q_kernel`` in ``regcn_torch/csrc/streaming_ce.cu``) at every
cluster size, on one NVIDIA GPU. Run from the repository root:

    python3 tools/ce_bwd_q_diagnosis.py [--other PATH/streaming_ce.cu] [--phases]

At config 3's two shapes (B = 512 queries, d = 200, N = 7128 entities or
N = 460 relations; proxy distance, inputs from ``chip_smoke.ce_case``) it
times, as device time per call from a CUDA graph of 100 calls
(``chip_smoke.device_time_ms``), the kernel at each cluster size 1 to 16
that fits the card (with the number of clusters per query tile that the
wrapper's rule gives each size), at a few other numbers of clusters per
query tile, and at the launch the wrapper picks, each checked against the
plain version's dq, dc, dscale and dmargin (fp32 autograd) and for two
bitwise-equal calls.

With ``--other``, an earlier source whose backward_q takes the interface
of its version 2 (per-split partials in device memory and counters:
``..., g, dq_part, rows_part, scal_part, dq, dc, dscale, dmargin,
counters, B, N, d, splits, tiles_per_split, true_dist, stream``), such as ``git show
<commit>:regcn_torch/csrc/streaming_ce.cu``, is built beside it and timed
at 1, 2, 4, 8 and 16 candidate splits and at the split its wrapper took.

With ``--phases``, three more builds of the repo's source are timed, in
each of which one phase of the walk does nothing (``no p product``: p is
not computed; ``no chain``: every gradient term = p, no elementwise chain;
``no dQ product``: dq = 2 q sum dqq only). Their output is wrong; only
their times are read, as each phase's share.

Prints the card's name and power limit, each build's register and spill
lines for the backward_q kernel, then one JSON line per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ce_bwd_x_diagnosis import errors, nvcc_lib  # noqa: E402
from regcn_torch.ops import cuda_build  # noqa: E402
from regcn_torch.ops import streaming_ce as ce  # noqa: E402

B, D = 512, 200
# dq, dc, dscale and dmargin against the plain version: fp32 sums of
# thousands of terms in another order, relative to the largest entry (as
# chip_smoke's CE_GRAD_TOL)
TOL = 1e-4
# the walk's phases, and what each --phases build puts in its place
PHASES = {
    "no p product": ("j0 < kRows; j0 += kRowStep) {\n      float pd",
                     "j0 < 0; j0 += kRowStep) {\n      float pd"),
    "no chain": ("pair_grad<kTrue>(p, xx_s[r], bt[r], col0 + r == kq.tgt, kq, scale, margin, "
                 "dlogit, block,\n                       gp, gqq, gc);",
                 "dlogit = block = gp = gqq = gc = p;"),
    "no dQ product": ("j0 < kRows; j0 += kRowStep) {\n      float g0",
                      "j0 < 0; j0 += kRowStep) {\n      float g0"),
}
OTHER_SPLITS = (1, 2, 4, 8, 16)
# (cluster size, clusters per query tile) timed besides each size's own
EXTRA_LAUNCHES = ((2, 1), (2, 2), (2, 4), (1, 8), (1, 16), (4, 4))


def ptxas_lines(log: str) -> list:
    """The -Xptxas=-v lines of the backward_q kernel (the line naming the
    function, and the register / spill lines after it)."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = "backward_q" in line
        if keep:
            out.append(line.strip())
    return out


def phase_sources() -> dict:
    """The repo's source with one phase of the walk emptied, by name."""
    src = open(cuda_build.CSRC_DIR / "streaming_ce.cu").read()
    out = {}
    for name, (old, new) in PHASES.items():
        if src.count(old) != 1:
            raise SystemExit(f"streaming_ce.cu does not have {old!r} once: update PHASES")
        out[name] = src.replace(old, new)
    return out


def backward_q_of(sources: dict, workdir: str) -> dict:
    """name -> backward_q of each source, every nvcc at once."""
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        path, lib = os.path.join(workdir, f"q{i}.cu"), os.path.join(workdir, f"libq{i}.so")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"building {name} failed:\n{log}")
        fn = ctypes.CDLL(lib).streaming_ce_backward_q
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def variant_call(fn, a, lse, cluster: int, splits: int):
    """A launcher of a variant build's backward_q at ``splits`` clusters of
    ``cluster`` blocks per query tile."""
    q, x = a["q"], a["x"]
    N = x.shape[0]
    q_tiles = -(-B // ce.TILE)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_part, rows_part = torch.empty((splits, B, D), **f32), torch.empty((2, splits, B), **f32)
    scal_part = torch.empty((q_tiles * splits, 2), **f32)
    dq, dc = torch.empty((B, D), **f32), torch.empty(B, **f32)
    dscale, dmargin = torch.empty((), **f32), torch.empty((), **f32)
    counters = torch.zeros(q_tiles + 1, dtype=torch.int32, device=q.device)
    target = a["target"].to(torch.int32)

    def call():
        err = fn(q.data_ptr(), x.data_ptr(), a["bias"].data_ptr(), a["cq"].data_ptr(),
                 target.data_ptr(), a["scale"].data_ptr(), a["margin"].data_ptr(),
                 lse.data_ptr(), a["g"].data_ptr(), dq_part.data_ptr(), rows_part.data_ptr(),
                 scal_part.data_ptr(), dq.data_ptr(), dc.data_ptr(), dscale.data_ptr(),
                 dmargin.data_ptr(), counters.data_ptr(), B, N, D, cluster, splits, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"a variant build failed to launch: error {err}")
    return call


def build_other(path: str, workdir: str):
    dll, log = nvcc_lib(path, workdir, "other")
    fn = dll.streaming_ce_backward_q
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, log


def other_splits(N: int) -> int:
    """The candidate splits version 2's wrapper took: one wave of one block per SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles, q_tiles = -(-N // ce.TILE), -(-B // ce.TILE)
    want = min(tiles, max(1, sms // q_tiles))
    per = -(-tiles // want)
    return -(-tiles // per)


def other_call(fn, a, lse, splits: int):
    """Version 2 of backward_q with the candidate axis cut into ``splits`` splits."""
    q, x = a["q"], a["x"]
    N = x.shape[0]
    q_tiles, c_tiles = -(-B // ce.TILE), -(-N // ce.TILE)
    per = -(-c_tiles // splits)
    splits = -(-c_tiles // per)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq_part, rows_part = torch.empty((splits, B, D), **f32), torch.empty((2, splits, B), **f32)
    scal_part = torch.empty((q_tiles * splits, 2), **f32)
    dq, dc = torch.empty((B, D), **f32), torch.empty(B, **f32)
    dscale, dmargin = torch.empty((), **f32), torch.empty((), **f32)
    counters = torch.zeros(q_tiles + 1, dtype=torch.int32, device=q.device)
    target = a["target"].to(torch.int32)

    def call():
        err = fn(q.data_ptr(), x.data_ptr(), a["bias"].data_ptr(), a["cq"].data_ptr(),
                 target.data_ptr(), a["scale"].data_ptr(), a["margin"].data_ptr(),
                 lse.data_ptr(), a["g"].data_ptr(), dq_part.data_ptr(), rows_part.data_ptr(),
                 scal_part.data_ptr(), dq.data_ptr(), dc.data_ptr(), dscale.data_ptr(),
                 dmargin.data_ptr(), counters.data_ptr(), B, N, D, splits, per, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other backward_q failed to launch: error {err}")
        return dq, dc, dscale, dmargin
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="an earlier streaming_ce.cu with version 2's backward_q interface")
    ap.add_argument("--phases", action="store_true", help="time builds with one phase emptied")
    args = ap.parse_args()
    cs.phase_device()
    dev = torch.device("cuda")
    for name, log in cuda_build.build(["streaming_ce"]).items():
        for line in ptxas_lines(log):
            print(f"[build] {name}: {line}")
    other = None
    with tempfile.TemporaryDirectory() as workdir:
        variants = backward_q_of(phase_sources(), workdir) if args.phases else {}
        if args.other:
            other, log = build_other(args.other, workdir)
            for line in ptxas_lines(log):
                print(f"[build] other: {line}")
        for label, N in (("entity", 7128), ("relation", 460)):
            a = cs.ce_case(B, N, D, dev)
            target = a["target"].to(torch.int32)
            kw = (a["q"], a["x"], a["bias"], a["cq"], target, a["scale"], a["margin"])
            _, lse = ce.ce_forward(*kw, False)
            _, plain_g = cs.ce_run(ce.streaming_nll_reference, a)
            want = (plain_g["q"], plain_g["cq"], plain_g["scale"], plain_g["margin"])
            row = dict(shape=label, B=B, N=N, d=D, launches={})
            c_tiles = -(-N // ce.BWD_Q_ROWS)
            launches = [(0, 0)] + [(c, 0) for c in range(1, min(ce.MAX_CLUSTER_Q, c_tiles) + 1)]
            for cluster, splits in launches + list(EXTRA_LAUNCHES):
                plan = ce.backward_q_plan(B, N, D, False, dev, cluster, splits)
                key = "picked" if cluster == 0 else f"{plan['cluster']} x {plan['splits']}"
                if not plan["active_clusters"]:
                    print(f"[bwd_q] {label} cluster {key}: no cluster of this size fits",
                          flush=True)
                    row["launches"][key] = dict(ms=None, **plan)
                    continue
                fn = lambda: ce.ce_backward_q(*kw, lse, a["g"], False, cluster, splits)  # noqa: E731
                first, second = fn(), fn()
                torch.cuda.synchronize()
                err = errors(first, want)
                repeat = all(torch.equal(u, v) for u, v in zip(first, second))
                ms = cs.device_time_ms(fn)
                row["launches"][key] = dict(ms=ms, err=err, bitwise_repeatable=repeat, **plan)
                print(f"[bwd_q] {label} {key} (clusters of {plan['cluster']}, {plan['splits']} "
                      f"per query tile): {ms * 1e3:.2f} us, grid {plan['grid']}, "
                      f"{plan['blocks_per_sm']} block(s) per SM, {plan['active_clusters']} "
                      f"clusters resident, {plan['candidate_tiles_per_block']} candidate tiles "
                      f"per block, err {err:.2e}, repeatable {repeat}", flush=True)
                if not (err <= TOL and repeat):
                    raise SystemExit(f"{label} {key}: err {err:.3e} or not repeatable")
            if variants:
                row["variants"] = {}
                picked = row["launches"]["picked"]
                for cluster, splits in sorted({(1, 1), (picked["cluster"], picked["splits"])}):
                    for name, fn in variants.items():
                        ms = cs.device_time_ms(variant_call(fn, a, lse, cluster, splits))
                        row["variants"][f"{name}, {cluster} x {splits}"] = ms
                        print(f"[bwd_q] {label} {cluster} x {splits}, {name}: {ms * 1e3:.2f} us",
                              flush=True)
            if other is not None:
                row["other"] = {}
                own = other_splits(N)
                for splits in sorted(set(OTHER_SPLITS) | {own}):
                    if splits > -(-N // ce.TILE):
                        continue
                    call = other_call(other, a, lse, splits)
                    err = errors(call(), want)
                    ms = cs.device_time_ms(call)
                    key = f"{splits} (its own)" if splits == own else str(splits)
                    row["other"][key] = dict(ms=ms, err=err)
                    print(f"[bwd_q] {label} other, {key} candidate split(s): {ms * 1e3:.2f} us, "
                          f"err {err:.2e}", flush=True)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
