#!/usr/bin/env python3
"""Where the scatter kernel B1 (``regcn_torch/csrc/rgcn_scatter.cu``) spends
its time, on one NVIDIA GPU. Run from the repository root:

    python3 tools/scatter_diagnosis.py [--other PATH/rgcn_scatter.cu]

At d = 200 and five key distributions (the first test snapshot of
synthetic-icews14s, seed 123, padded as the main path pads it; the same
edge slots with its real edges on distinct uniform rows; the first test
snapshot of synthetic-icews18; a skewed zipf case of 4096 edges; every real
edge of the first case on one row) it times, as device time per call from
a CUDA graph of 100 calls (``chip_smoke.device_time_ms``):

- the kernel as the wrapper launches it, checked against the plain version
  and for two bitwise-equal calls;
- two builds of the same source in which one kind of block returns at once
  (``chunks only``: the row tiles write nothing; ``rows only``: the edge
  chunks sum nothing). Their output is wrong; only their times are read,
  as the length of each kind of block's path;
- with ``--other``, another version of the source with the single-pass
  interface (msg, keys, edge_weight, row_scale, out, E, N, d, stream), such
  as an earlier commit's ``git show <commit>:regcn_torch/csrc/rgcn_scatter.cu``;
- ``torch.zeros`` of the output and ``zeros + index_add_`` of the same sum.

Prints the card's name and power limit, then one JSON line per case.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from regcn_torch.data.synthetic import generate  # noqa: E402
from regcn_torch.ops import cuda_build  # noqa: E402
from regcn_torch.ops.rgcn_scatter import (  # noqa: E402
    _counters_for,
    scatter_add_sorted,
    scatter_add_sorted_reference,
)

D = 200
# the dispatch of scatter_sorted_kernel, and what each role-only build makes of it
DISPATCH = ("  if (static_cast<int>(blockIdx.x) < num_chunks) {\n    chunk_block",
            "  } else {\n    row_block")


def role_builds(src: str) -> dict:
    """Sources in which the edge chunks or the row tiles return at once."""
    for anchor in DISPATCH:
        if anchor not in src:
            raise SystemExit(f"rgcn_scatter.cu no longer has {anchor!r}: update DISPATCH")
    return {
        "chunks only": src.replace(DISPATCH[1], DISPATCH[1].replace("{\n", "{\n    return;\n")),
        "rows only": src.replace(DISPATCH[0], DISPATCH[0].replace("{\n", "{\n    return;\n")),
    }


def build_all(sources: dict, workdir: str) -> dict:
    """name -> ctypes library, every nvcc started at once."""
    nvcc = cuda_build._nvcc()
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        path = os.path.join(workdir, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(workdir, f"libv{i}.so")
        procs[name] = (lib, subprocess.Popen([nvcc, *cuda_build.NVCC_FLAGS, "-o", lib, path],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def launcher(lib: ctypes.CDLL):
    """A call (msg, keys, n, w, s) -> out for a built source, by its interface."""
    fn = lib.rgcn_scatter_sorted
    fn.restype = ctypes.c_int
    if hasattr(lib, "rgcn_scatter_chunk_edges"):  # scratch, counters
        chunk = lib.rgcn_scatter_chunk_edges()
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    else:
        chunk = None
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]

    def call(msg, keys, n, w, s):
        E, d = msg.shape
        out = torch.empty(n, d, device=msg.device)
        ptrs = [msg.data_ptr(), keys.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr()]
        if chunk is not None:
            partial = torch.empty(2 * (-(-E // chunk)), d, device=msg.device)
            ptrs += [partial.data_ptr(), _counters_for(msg.device, n).data_ptr()]
        err = fn(*ptrs, E, n, d, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")
        return out

    return call


def cases(g) -> dict:
    """label -> (N, keys, edge_weight, row_scale) as numpy arrays."""
    out = {}
    for name in ("synthetic-icews14s", "synthetic-icews18"):
        data = generate(name, seed=cs.SEED)
        snap, keys = cs.first_test_snapshot(data, torch.device("cpu"))
        out[f"{name} first test snapshot"] = (data.num_nodes, keys.numpy(),
                                             snap.edge_mask.numpy(), snap.in_deg_norm.numpy())
    N, keys, w, s = out["synthetic-icews14s first test snapshot"]
    n_real = int((keys < N).sum())
    uniform = np.full_like(keys, N)
    uniform[:n_real] = np.sort(g.choice(N, n_real, replace=False))
    out["icews14s slots, real edges on distinct uniform rows"] = (N, uniform, w, s)
    hub = np.full_like(keys, N)
    hub[:n_real] = 5
    out["icews14s slots, every real edge on one row"] = (N, hub, w, s)
    skew = np.sort(g.zipf(1.3, 4096) % N).astype(np.int32)
    out["skewed zipf E=4096"] = (N, skew, g.random(4096).astype(np.float32),
                                 g.random(N).astype(np.float32))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another rgcn_scatter.cu with the single-pass interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (cuda_build.CSRC_DIR / "rgcn_scatter.cu").read_text()
    sources = role_builds(src)
    if args.other:
        with open(args.other) as f:
            sources["other"] = f.read()
    cuda_build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_build.BUILD_DIR) as workdir:
        calls = {name: launcher(lib) for name, lib in build_all(sources, workdir).items()}
        dev = torch.device("cuda")
        g = np.random.default_rng(cs.SEED)
        for label, (N, keys, w, s) in cases(g).items():
            E = len(keys)
            msg = torch.from_numpy(g.normal(size=(E, D)).astype(np.float32)).to(dev)
            kt, wt, st = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (keys, w, s))
            want = scatter_add_sorted_reference(msg, kt, N, wt, st)
            got = scatter_add_sorted(msg, kt, N, edge_weight=wt, row_scale=st)
            again = scatter_add_sorted(msg, kt, N, edge_weight=wt, row_scale=st)
            row = dict(case=label, E=E, real=int((keys < N).sum()), N=N,
                       busiest=int(np.bincount(keys[keys < N]).max()) if (keys < N).any() else 0,
                       max_abs_err=(got - want).abs().max().item(),
                       bitwise_repeatable=bool(torch.equal(got, again)))
            if "other" in calls:
                other = calls["other"](msg, kt, N, wt, st)
                row["other_max_abs_err"] = (other - want).abs().max().item()
            timed = {"kernel": lambda: scatter_add_sorted(msg, kt, N, edge_weight=wt, row_scale=st)}
            timed.update({name: (lambda f=f: f(msg, kt, N, wt, st)) for name, f in calls.items()})
            timed["torch.zeros"] = lambda: torch.zeros(N, D, device=dev)
            timed["zeros + index_add_"] = lambda: torch.zeros(N + 1, D, device=dev).index_add_(
                0, kt, msg)
            us = {}
            for _ in range(2):  # two passes, in turns
                for name, fn in timed.items():
                    us.setdefault(name, []).append(round(cs.device_time_ms(fn) * 1e3, 2))
            row["us"] = us
            row["bound_us"] = round(cs.scatter_bound_ms(row["real"], E, N, D)[0] * 1e3, 3)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
