#!/usr/bin/env python3
"""The forward of the streaming CE (kernel B2's ``ce_forward_kernel`` in
``regcn_torch/csrc/streaming_ce.cu``) at several split counts, on one
NVIDIA GPU. Run from the repository root:

    python3 tools/ce_fwd_diagnosis.py [--other PATH/streaming_ce.cu] [--phases]

At config 3's two shapes (B = 512 queries, d = 200, N = 7128 entities or
N = 460 relations; proxy distance, inputs from ``chip_smoke.ce_case``) it
times, as device time per call from a CUDA graph of 100 calls
(``chip_smoke.device_time_ms``), the launch the wrapper picks (128 queries
per block) and a few other split counts, and a build of the repo's source
with 64 queries per block (2 per lane, two blocks per SM), each at the
split count ``forward_plan``'s rule gives it from its own occupancy and at
a few others. Each launch is checked against the plain version's NLL with
``chip_smoke``'s rule (float64 as the arbiter: within max(1e-5 max(1,
max|nll|), twice the fp32 plain version's error)) and for two
bitwise-equal calls.

It also builds a probe of the repo's source in which the forward,
backward_q and backward_x write every pair's p (and the forward and
backward_q its block = margin - dist) into [B, N] buffers past their own
outputs, and reports whether they agree bit for bit.

With ``--other``, an earlier source whose forward takes version 2's
interface (``..., part, nll, lse, counters, B, N, d, splits,
tiles_per_split, true_dist, stream``, 64 x 64 tiles), such as ``git show
<commit>:regcn_torch/csrc/streaming_ce.cu``, is built beside it and timed
at its own split count (two blocks per SM in one wave) and at 1, 2, 4, 8
and 16 candidate splits, each checked the same way.

With ``--same PATH`` (repeatable), other sources whose forward takes this
interface, such as variants of this design, are built and timed at their
plans' launches, each checked the same way.

With ``--phases``, builds of the repo's source in which one phase does
nothing are timed at the picked launch (``no p product``: p is not
computed; ``no logit``: logit = p, no distance algebra; ``no fold``: the
running sum adds logits, no expf; ``no walk``: no candidate tile at all,
leaving the prologue, the partials and the merge; ``no merge``: no block
merges the splits; ``no query load``: the query tile is not loaded).
Their output is wrong; only their times are read, as each phase's share.

Prints the card's name and power limit, the register and spill lines of
the forward and backward_q at d = 200 for each build, then one JSON line
per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ce_bwd_x_diagnosis import nvcc_lib  # noqa: E402
from regcn_torch.ops import cuda_build  # noqa: E402
from regcn_torch.ops import streaming_ce as ce  # noqa: E402

B, D = 512, 200
COL4 = -(-D // 32)  # the kernels' float4 columns per warp at d = 200
# the forward's phases, and what each --phases build puts in its place
PHASES = {
    "no p product": ("j0 < kRows; j0 += kRowStep) {\n        float dot",
                     "j0 < 0; j0 += kRowStep) {\n        float dot"),
    "no logit": ("const bwdq::Logit e = bwdq::pair_logit<kTrue>(p, xx_t[r], bt[r], kq, scale, "
                 "margin);",
                 "bwdq::Logit e;\n        e.logit = p;"),
    "no fold": ("for (int i = 0; i < kPairs; ++i) acc += expf(l[i] - ref);",
                "for (int i = 0; i < kPairs; ++i) acc += l[i];"),
    "no walk": ("for (int t = t_begin; t <= t_end; ++t) {",
                "for (int t = t_begin; t < t_begin; ++t) {"),
    "no merge": ("if (!last_to_finish(counters + qtile, splits, &flag)) return;", "return;"),
    "no query load": ("bwdx::load_tile_async(reinterpret_cast<float4*>(red), q, row0, kQueries, B, "
                      "sh);", ""),
}
# the forward with 2 queries per lane (64 per block) and two blocks per SM
QUERIES_64 = {
    "queries per lane": ("constexpr int kQL = 4;", "constexpr int kQL = 2;"),
    "blocks per SM": ("__global__ void __launch_bounds__(fwd::kThreads, 1)\n    ce_forward_kernel",
                      "__global__ void __launch_bounds__(fwd::kThreads, 2)\n    ce_forward_kernel"),
}
# the probe build: each kernel also writes its pairs' p (and block) into
# [B, N] buffers past the end of an output the tool allocates larger
PROBE = {
    "forward": (
        "        l[i] = ok ? e.logit : neg_inf();",
        "        l[i] = ok ? e.logit : neg_inf();\n"
        "        if (row_ok && ok) {\n"
        "          float* pr = part + 3 * static_cast<size_t>(splits) * B;\n"
        "          pr[static_cast<size_t>(qrow) * N + col0 + r] = p;\n"
        "          pr[static_cast<size_t>(B + qrow) * N + col0 + r] = e.block;\n"
        "        }"),
    "backward_q": (
        "pair_grad<kTrue>(p, xx_s[r], bt[r], col0 + r == kq.tgt, kq, scale, margin, dlogit, block,\n"
        "                       gp, gqq, gc);",
        "pair_grad<kTrue>(p, xx_s[r], bt[r], col0 + r == kq.tgt, kq, scale, margin, dlogit, block,\n"
        "                       gp, gqq, gc);\n"
        "      if (row_ok && col0 + r < N) {\n"
        "        float* pr = dq_part + static_cast<size_t>(splits) * B * d;\n"
        "        pr[static_cast<size_t>(qrow) * N + col0 + r] = p;\n"
        "        pr[static_cast<size_t>(B + qrow) * N + col0 + r] = block;\n"
        "      }"),
    "backward_x": (
        "pair_grad<kTrue>(p, xx, bv, col0 + ec == tgt_s[r], rowc, r, scale, margin, dlogit, gp,\n"
        "                       gxx);",
        "pair_grad<kTrue>(p, xx, bv, col0 + ec == tgt_s[r], rowc, r, scale, margin, dlogit, gp,\n"
        "                       gxx);\n"
        "      if (col_ok && row0 + r < B)\n"
        "        dx[static_cast<size_t>(N) * d + static_cast<size_t>(row0 + r) * N + col0 + ec] = p;"),
}
OTHER_SPLITS = (1, 2, 4, 8, 16)
SPLITS = (1, 4, 8, 16, 32, 64)  # besides each plan's own
PTR, I32 = ctypes.c_void_p, ctypes.c_int


def ptxas_lines(log: str) -> list:
    """The -Xptxas=-v lines of the forward and backward_q instances for
    d = 200, or of version 2's forward (the line naming the function, and
    the lines after it)."""
    want = re.compile(rf"(ce_forward_kernel|ce_backward_q_kernel)ILb[01]E(Li{COL4}E|EEv)")
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = bool(want.search(line))
        if keep:
            out.append(line.strip())
    return out


def edited(edits: dict) -> str:
    """The repo's source with each (old, new) edit made at its one place."""
    src = open(cuda_build.CSRC_DIR / "streaming_ce.cu").read()
    for old, new in edits.values():
        if src.count(old) != 1:
            raise SystemExit(f"streaming_ce.cu does not have {old!r} once: update the edits")
        src = src.replace(old, new)
    return src


def phase_sources() -> dict:
    """The repo's source with one phase of the forward emptied, by name."""
    return {name: edited({name: edit}) for name, edit in PHASES.items()}


def probe_source() -> str:
    return edited(PROBE)


def build_all(sources: dict, workdir: str) -> dict:
    """name -> (library, ptxas log) of each source, every nvcc at once."""
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        path, lib = os.path.join(workdir, f"f{i}.cu"), os.path.join(workdir, f"libf{i}.so")
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
        dll = ctypes.CDLL(lib)
        dll.streaming_ce_forward.argtypes = [PTR] * 11 + [I32] * 5 + [PTR]
        dll.streaming_ce_forward_occupancy.argtypes = [I32] * 2 + [PTR] * 3
        dll.streaming_ce_backward_q.argtypes = [PTR] * 17 + [I32] * 6 + [PTR]
        dll.streaming_ce_backward_x.argtypes = [PTR] * 11 + [I32] * 5 + [PTR]
        out[name] = (dll, log)
    return out


def plan_of(dll, N: int, dev, splits: int = 0) -> dict:
    """``forward_plan``'s launch for a build, from that build's own
    occupancy (its queries per block and blocks per SM)."""
    occ = [ctypes.c_int(0) for _ in range(3)]
    if dll.streaming_ce_forward_occupancy(D, 0, *[ctypes.addressof(c) for c in occ]):
        raise RuntimeError("a build's occupancy query failed")
    with mock.patch.object(ce, "_forward_occupancy", lambda *_: tuple(c.value for c in occ)):
        return ce.forward_plan(B, N, D, False, dev, splits)


def forward_call(fn, a, ints: tuple, splits: int, q_tiles: int, extra: int = 0):
    """A launcher of a build's forward with ``splits`` partials per query:
    ``ints`` are its launch integers after B, N, d (version 3: splits;
    version 2: splits, tiles per split). ``extra`` floats follow the
    partials."""
    q, x = a["q"], a["x"]
    N = x.shape[0]
    part = torch.empty(3 * splits * B + extra, dtype=torch.float32, device=q.device)
    nll, lse = torch.empty(B, device=q.device), torch.empty(B, device=q.device)
    counters = torch.zeros(q_tiles, dtype=torch.int32, device=q.device)
    target = a["target"].to(torch.int32)

    def call():
        err = fn(q.data_ptr(), x.data_ptr(), a["bias"].data_ptr(), a["cq"].data_ptr(),
                 target.data_ptr(), a["scale"].data_ptr(), a["margin"].data_ptr(),
                 part.data_ptr(), nll.data_ptr(), lse.data_ptr(), counters.data_ptr(), B, N, D,
                 *ints, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"a forward build failed to launch: error {err}")
        return nll, lse, part
    return call


def build_call(dll, a, plan: dict, extra: int = 0):
    """A launcher of a version-3 build's forward at ``plan``."""
    return forward_call(dll.streaming_ce_forward, a, (plan["splits"],), plan["splits"],
                        -(-B // plan["queries"]), extra)


def other_launch(N: int, splits: int = 0) -> tuple:
    """(splits, tiles per split) of version 2 (64 x 64 tiles): by default as
    its wrapper took them, two blocks per SM in one wave."""
    tiles, q_tiles = -(-N // ce.TILE), -(-B // ce.TILE)
    if not splits:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = min(tiles, max(1, 2 * sms // q_tiles))
    per = -(-tiles // splits)
    return -(-tiles // per), per


def nll_error(got, plain, exact) -> tuple:
    """(max error against float64, the limit chip_smoke holds it to)."""
    err = (got.double() - exact).abs().max().item()
    plain_err = (plain.double() - exact).abs().max().item()
    return err, max(cs.CE_NLL_TOL * max(1.0, exact.abs().max().item()), 2 * plain_err)


def timed(label: str, key: str, call, plain, exact) -> dict:
    first = [t.clone() for t in call()[:2]]
    second = call()[:2]
    torch.cuda.synchronize()
    err, limit = nll_error(first[0], plain, exact)
    repeat = all(torch.equal(u, v) for u, v in zip(first, second))
    ms = cs.device_time_ms(call)
    print(f"[fwd] {label} {key}: {ms * 1e3:.2f} us, nll err {err:.2e} (limit {limit:.2e}), "
          f"repeatable {repeat}", flush=True)
    if not (err <= limit and repeat):
        raise SystemExit(f"{label} {key}: nll err {err:.3e} > {limit:.3e} or not repeatable")
    return dict(ms=ms, err=err, limit=limit, bitwise_repeatable=repeat)


def probe(dll, a, N: int, dev) -> dict:
    """How many pairs' p (and block) the probe build's forward takes
    otherwise than its backward_q (and backward_x, p only)."""
    kw = (a["q"], a["x"], a["bias"], a["cq"], a["target"].to(torch.int32), a["scale"],
          a["margin"])
    ptrs = [t.data_ptr() for t in kw]
    stream = torch.cuda.current_stream().cuda_stream
    f32 = dict(dtype=torch.float32, device=dev)
    plan = plan_of(dll, N, dev)
    _, lse, part = build_call(dll, a, plan, extra=2 * B * N)()
    f_p = part[3 * plan["splits"] * B:].view(2, B, N)
    qp = ce.backward_q_plan(B, N, D, False, dev)
    qs, qc = qp["splits"], qp["cluster"]
    dq_part = torch.empty(qs * B * D + 2 * B * N, **f32)
    outs = [torch.empty(s, **f32) for s in ((2, qs, B), (-(-B // ce.TILE) * qs, 2), (B, D), (B,),
                                            (), ())]
    counters = torch.zeros(-(-B // ce.TILE) + 1, dtype=torch.int32, device=dev)
    err = dll.streaming_ce_backward_q(*ptrs, lse.data_ptr(), a["g"].data_ptr(),
                                      dq_part.data_ptr(), *[t.data_ptr() for t in outs],
                                      counters.data_ptr(), B, N, D, qc, qs, 0, stream)
    xc = ce.backward_x_plan(B, N, D, False, dev)["cluster"]
    dx = torch.empty(N * D + B * N, **f32)
    dbias = torch.empty(N, **f32)
    err = err or dll.streaming_ce_backward_x(*ptrs, lse.data_ptr(), a["g"].data_ptr(),
                                             dx.data_ptr(), dbias.data_ptr(), B, N, D, xc, 0,
                                             stream)
    if err:
        raise RuntimeError(f"the probe build failed to launch: error {err}")
    torch.cuda.synchronize()
    q_p = dq_part[qs * B * D:].view(2, B, N)
    x_p = dx[N * D:].view(B, N)
    return dict(
        p_forward_vs_bwd_q_differ=int((f_p[0] != q_p[0]).sum()),
        block_forward_vs_bwd_q_differ=int((f_p[1] != q_p[1]).sum()),
        p_forward_vs_bwd_x_differ=int((f_p[0] != x_p).sum()),
        p_max_abs_diff_vs_bwd_x=(f_p[0] - x_p).abs().max().item(), pairs=B * N)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="an earlier streaming_ce.cu with version 2's forward interface")
    ap.add_argument("--phases", action="store_true", help="time builds with one phase emptied")
    ap.add_argument("--same", action="append",
                    help="another streaming_ce.cu with this forward interface (repeatable)")
    args = ap.parse_args()
    cs.phase_device()
    dev = torch.device("cuda")
    cuda_build.build(["streaming_ce"])
    with tempfile.TemporaryDirectory() as workdir:
        sources = {"repo": edited({}), "probe": probe_source(), "64 queries": edited(QUERIES_64),
                   **(phase_sources() if args.phases else {})}
        for path in args.same or ():
            sources[f"same {path}"] = open(path).read()
        builds = build_all(sources, workdir)
        other = None
        if args.other:
            dll, log = nvcc_lib(args.other, workdir, "other")
            other = dll.streaming_ce_forward
            other.argtypes = [PTR] * 11 + [I32] * 6 + [PTR]
            builds["other"] = (dll, log)
        for name, (_, log) in builds.items():
            if name in ("repo", "64 queries", "other"):
                for line in ptxas_lines(log):
                    print(f"[build] {name}: {line}")
        for label, N in (("entity", 7128), ("relation", 460)):
            a = cs.ce_case(B, N, D, dev)
            target = a["target"].to(torch.int32)
            kw = (a["q"], a["x"], a["bias"], a["cq"], target, a["scale"], a["margin"])
            with torch.no_grad():
                ref = (a["q"], a["x"], a["bias"], target, a["cq"], a["scale"], a["margin"])
                plain = ce.streaming_nll_reference(*ref, False)
                exact = ce.streaming_nll_reference(
                    *[t.double() if t.is_floating_point() else t for t in ref], False)
            row = dict(shape=label, B=B, N=N, d=D, launches={})
            picked = ce.forward_plan(B, N, D, False, dev)
            c_tiles = -(-N // ce.FWD_ROWS)
            splits = sorted({picked["splits"], *[s for s in SPLITS if s <= c_tiles]})
            for n in splits:
                key = f"{picked['queries']} x {n}" + (" (picked)" if n == picked["splits"] else "")
                row["launches"][key] = dict(**ce.forward_plan(B, N, D, False, dev, n), **timed(
                    label, key, lambda: ce.ce_forward(*kw, False, n) + (None,), plain, exact))
            names = ["64 queries"] + [n for n in builds if n.startswith("same ")]
            for name in names:
                dll = builds[name][0]
                own = plan_of(dll, N, dev)
                for n in (splits if name == "64 queries" else [own["splits"]]):
                    plan = plan_of(dll, N, dev, n)
                    key = f"{name}, {plan['queries']} x {n}" + (
                        " (its plan)" if n == own["splits"] else "")
                    row["launches"][key] = dict(**plan, **timed(
                        label, key, build_call(dll, a, plan), plain, exact))
            row["probe"] = probe(builds["probe"][0], a, N, dev)
            print(f"[fwd] {label} probe: {row['probe']}", flush=True)
            if args.phases:
                row["phases"] = {}
                for name in PHASES:
                    ms = cs.device_time_ms(build_call(builds[name][0], a, picked))
                    row["phases"][name] = ms
                    print(f"[fwd] {label} picked, {name}: {ms * 1e3:.2f} us", flush=True)
            if other is not None:
                row["other"] = {}
                own, _ = other_launch(N)
                tiles = -(-N // ce.TILE)
                for want in sorted({own, *[s for s in OTHER_SPLITS if s <= tiles]}):
                    n, per = other_launch(N, want)
                    key = f"{n} split(s)" + (" (its own)" if want == own else "")
                    row["other"][key] = timed(
                        label, f"v2 {key}", forward_call(other, a, (n, per), n, -(-B // ce.TILE)),
                        plain, exact)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
