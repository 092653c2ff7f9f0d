#!/usr/bin/env python3
"""The candidate-side backward of the streaming CE (kernel B2's
``ce_backward_x_kernel`` in ``regcn_torch/csrc/streaming_ce.cu``) at every
cluster size, on one NVIDIA GPU. Run from the repository root:

    python3 tools/ce_bwd_x_diagnosis.py [--other PATH/streaming_ce.cu]

At config 3's two shapes (B = 512 queries, d = 200, N = 7128 entities or
N = 460 relations; proxy distance, inputs from ``chip_smoke.ce_case``) it
times, as device time per call from a CUDA graph of 100 calls
(``chip_smoke.device_time_ms``), the kernel at each cluster size 1 to 8
and at the size the wrapper picks, each checked against the plain
version's dx and dbias (fp32 autograd) and for two bitwise-equal calls.

With ``--other``, an earlier source whose backward_x takes PR 2's
interface (per-split partials in device memory and a counter per candidate
tile: ``..., g, dx_part, cols_part, dx, dbias, counters, B, N, d, splits,
tiles_per_split, true_dist, stream``), such as ``git show
<commit>:regcn_torch/csrc/streaming_ce.cu``, is built beside it and timed
at 1, 2, 4 and 8 query splits.

With ``--phases``, three more builds of the repo's source are timed, in
each of which one phase of the walk does nothing (``no p product``: p is not computed;
``no chain``: dp = p, no elementwise chain; ``no dX product``: dx = 0). Their
output is wrong; only their times are read, as each phase's share.

With ``--same PATH`` (repeatable), other sources with this interface, such
as earlier versions of this design, are built and timed the same way.

With ``--smem-probe``, a small kernel times 4096 shared-memory float4
loads by each of 32 warps on every SM at four address patterns (32
distinct float4; 8 distinct rows repeated in each quarter-warp; 4
distinct rows, one per quarter-warp; one address), to show what a
128-bit load costs when lanes share addresses.

Prints the card's name and power limit, each build's register and spill
lines for the backward_x kernel, then one JSON line per shape.
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

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from regcn_torch.ops import cuda_build  # noqa: E402
from regcn_torch.ops import streaming_ce as ce  # noqa: E402

B, D = 512, 200
# dx and dbias against the plain version: fp32 sums of thousands of terms in
# another order, relative to the largest entry (as chip_smoke's CE_GRAD_TOL)
TOL = 1e-4
# the walk's phases, and what each --phases build puts in its place
PHASES = {
    "no p product": ("r0 < kRows; r0 += kRowStep) {\n      float pp",
                     "r0 < 0; r0 += kRowStep) {\n      float pp"),
    "no chain": ("pair_grad<kTrue>(p, xx, bv, col0 + ec == tgt_s[r], rowc, r, scale, margin, "
                 "dlogit, gp,\n                       gxx);",
                 "dlogit = gp = gxx = p;"),
    "no dX product": ("r0 < kRows; r0 += kRowStep) {\n      float ga",
                      "r0 < 0; r0 += kRowStep) {\n      float ga"),
}
PROBE_SRC = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(1024) probe(int pattern, int iters, float* out) {
  __shared__ float4 s[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int idx = pattern == 0 ? lane : pattern == 1 ? (lane % 8) * 51 : pattern == 2 ? (lane / 8) * 51 : 0;
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float4 v = s[(idx + 8 * it) & 1023];
    acc += (v.x + v.y) + (v.z + v.w);
  }
  if (acc == -1.f) out[threadIdx.x] = acc;
}
extern "C" int lds_probe(int pattern, int iters, int blocks, float* out, cudaStream_t stream) {
  probe<<<blocks, 1024, 0, stream>>>(pattern, iters, out);
  return static_cast<int>(cudaGetLastError());
}
"""
PROBE_PATTERNS = ("32 distinct float4", "8 distinct rows in each quarter-warp",
                  "4 distinct rows, one per quarter-warp", "one address")


def ptxas_lines(log: str) -> list:
    """The -Xptxas=-v lines of the backward_x kernel (the line naming the
    function, and the register / spill lines after it)."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = "backward_x" in line
        if keep:
            out.append(line.strip())
    return out


def nvcc_lib(src_path: str, workdir: str, name: str):
    lib = os.path.join(workdir, f"lib{name}.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src_path],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"building {src_path} failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib), proc.stdout + proc.stderr


def backward_x_of(sources: dict, workdir: str) -> dict:
    """name -> backward_x of each source (this interface), every nvcc at once."""
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        path, lib = os.path.join(workdir, f"v{i}.cu"), os.path.join(workdir, f"libv{i}.so")
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
        fn = ctypes.CDLL(lib).streaming_ce_backward_x
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def phase_sources() -> dict:
    """The repo's source with one phase of the walk emptied, by name."""
    src = open(cuda_build.CSRC_DIR / "streaming_ce.cu").read()
    out = {}
    for name, (old, new) in PHASES.items():
        if old not in src:
            raise SystemExit(f"streaming_ce.cu no longer has {old!r}: update PHASES")
        out[name] = src.replace(old, new)
    return out


def variant_call(fn, a, lse, cluster: int):
    """A launcher of a variant build's backward_x at ``cluster`` blocks per tile."""
    q, x = a["q"], a["x"]
    N = x.shape[0]
    dx, dbias = torch.empty((N, D), device=q.device), torch.empty(N, device=q.device)
    target = a["target"].to(torch.int32)

    def call():
        err = fn(q.data_ptr(), x.data_ptr(), a["bias"].data_ptr(), a["cq"].data_ptr(),
                 target.data_ptr(), a["scale"].data_ptr(), a["margin"].data_ptr(),
                 lse.data_ptr(), a["g"].data_ptr(), dx.data_ptr(), dbias.data_ptr(), B, N, D,
                 cluster, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"a variant build failed to launch: error {err}")
    return call


def smem_probe(workdir: str) -> dict:
    path = os.path.join(workdir, "probe.cu")
    with open(path, "w") as f:
        f.write(PROBE_SRC)
    dll, _ = nvcc_lib(path, workdir, "probe")
    dll.lds_probe.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    dll.lds_probe.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(1024, device="cuda")
    iters = 4096
    res = {}
    for pattern, label in enumerate(PROBE_PATTERNS):
        def call():
            if dll.lds_probe(pattern, iters, sms, out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("the probe failed to launch")
        ms = cs.device_time_ms(call, reps=10)
        res[label] = dict(ms=ms, warp_loads_per_sm_per_us=32 * iters / (ms * 1e3))
        print(f"[probe] {label}: {ms * 1e3:.1f} us for {32 * iters} warp-wide float4 loads per "
              f"SM = {32 * iters / (ms * 1e3):.1f} per us per SM", flush=True)
    return res


def build_other(path: str, workdir: str):
    dll, log = nvcc_lib(path, workdir, "other")
    fn = dll.streaming_ce_backward_x
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, log


def other_call(fn, a, lse, splits: int):
    """PR 2's backward_x with the query axis cut into ``splits`` splits."""
    q, x = a["q"], a["x"]
    N = x.shape[0]
    q_tiles, c_tiles = -(-B // ce.TILE), -(-N // ce.TILE)
    per = -(-q_tiles // splits)
    splits = -(-q_tiles // per)
    f32 = dict(dtype=torch.float32, device=q.device)
    dx, dbias = torch.empty((N, D), **f32), torch.empty(N, **f32)
    dx_part, cols_part = torch.empty((splits, N, D), **f32), torch.empty((2, splits, N), **f32)
    counters = torch.zeros(c_tiles, dtype=torch.int32, device=q.device)
    target = a["target"].to(torch.int32)

    def call():
        err = fn(q.data_ptr(), x.data_ptr(), a["bias"].data_ptr(), a["cq"].data_ptr(),
                 target.data_ptr(), a["scale"].data_ptr(), a["margin"].data_ptr(),
                 lse.data_ptr(), a["g"].data_ptr(), dx_part.data_ptr(), cols_part.data_ptr(),
                 dx.data_ptr(), dbias.data_ptr(), counters.data_ptr(), B, N, D, splits, per, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other backward_x failed to launch: error {err}")
        return dx, dbias
    return call


def errors(got, want) -> float:
    return max((g - w).abs().max().item() / max(1.0, w.abs().max().item())
               for g, w in zip(got, want))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="an earlier streaming_ce.cu with PR 2's backward_x interface")
    ap.add_argument("--phases", action="store_true", help="time builds with one phase emptied")
    ap.add_argument("--same", action="append",
                    help="another streaming_ce.cu with this backward_x interface (repeatable)")
    ap.add_argument("--smem-probe", action="store_true", help="time shared-memory load patterns")
    args = ap.parse_args()
    cs.phase_device()
    dev = torch.device("cuda")
    for name, log in cuda_build.build(["streaming_ce"]).items():
        for line in ptxas_lines(log):
            print(f"[build] {name}: {line}")
    other = None
    with tempfile.TemporaryDirectory() as workdir:
        if args.smem_probe:
            print(json.dumps({"smem_probe": smem_probe(workdir)}), flush=True)
        sources = phase_sources() if args.phases else {}
        for path in args.same or ():
            sources[f"same {path}"] = open(path).read()
        variants = backward_x_of(sources, workdir) if sources else {}
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
            want = (plain_g["x"], plain_g["bias"])
            row = dict(shape=label, B=B, N=N, d=D, clusters={})
            for cluster in [0] + list(range(1, ce.MAX_CLUSTER + 1)):
                plan = ce.backward_x_plan(B, N, D, False, dev, cluster)
                fn = lambda: ce.ce_backward_x(*kw, lse, a["g"], False, cluster)  # noqa: E731
                first, second = fn(), fn()
                torch.cuda.synchronize()
                err = errors(first, want)
                repeat = all(torch.equal(u, v) for u, v in zip(first, second))
                ms = cs.device_time_ms(fn)
                key = "picked" if cluster == 0 else str(cluster)
                row["clusters"][key] = dict(ms=ms, err=err, bitwise_repeatable=repeat, **plan)
                print(f"[bwd_x] {label} cluster {key} ({plan['cluster']}): {ms * 1e3:.2f} us, "
                      f"grid {plan['grid']}, {plan['blocks_per_sm']} block(s) per SM, "
                      f"{plan['active_clusters']} clusters resident, err {err:.2e}, "
                      f"repeatable {repeat}", flush=True)
                if not (err <= TOL and repeat):
                    raise SystemExit(f"{label} cluster {key}: err {err:.3e} or not repeatable")
            if variants:
                row["variants"] = {}
                for cluster in sorted({1, row["clusters"]["picked"]["cluster"]}):
                    for name, fn in variants.items():
                        ms = cs.device_time_ms(variant_call(fn, a, lse, cluster))
                        row["variants"][f"{name}, cluster {cluster}"] = ms
                        print(f"[bwd_x] {label} cluster {cluster}, {name}: {ms * 1e3:.2f} us",
                              flush=True)
            if other is not None:
                row["other"] = {}
                for splits in (1, 2, 4, 8):
                    call = other_call(other, a, lse, splits)
                    err = errors(call(), want)
                    ms = cs.device_time_ms(call)
                    row["other"][str(splits)] = dict(ms=ms, err=err)
                    print(f"[bwd_x] {label} other, {splits} query split(s): {ms * 1e3:.2f} us, "
                          f"err {err:.2e}", flush=True)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
