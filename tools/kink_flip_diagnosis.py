#!/usr/bin/env python3
"""Where the sharded runs of ``chip_smoke.py`` take another branch at an
activation's kink than one process's run, on one NVIDIA GPU. Run from the
repository root:

    python3 tools/kink_flip_diagnosis.py [--runs 4] [--paths "hisres gspmd,hisres halo"]

For each ``path mode`` of ``--paths`` it spawns ``chip_smoke.SHARDS`` gloo
ranks sharing the card, as the sharded phase does, and each rank runs that
phase's 3-step check (``chip_smoke.sharded_three_steps``) ``--runs`` times.
Each kink call whose replay flipped an entry (the sharded run's own branch
other than the one process's recorded branch) is reported by rank 0, whose
recorded and own pre-activations lie in one process: the call's kind and
place in the step, its shape, the flipped entries, their pre-activations
on both sides, and how many entries of the whole recorded call lie within
1e-6 of 0 (a block of values that are 0 in exact arithmetic shows there).
Prints the card's name and power limit, a JSON line per flipped call and
one per run with the run's flip counts, and writes the lines to
``chiprun_out/kink_flips.jsonl``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

NEAR_ZERO = 1e-6
SHOWN = 8  # flipped entries shown per call


class FlipLog(cs.PinnedKinks):
    """``PinnedKinks`` that also keeps each recorded pre-activation and
    logs each replayed call whose own branch differs from the recorded."""

    def __init__(self, sink: list):
        super().__init__()
        self.sink = sink
        self.step = 0
        self.replaying = False
        self.xs = {k: [] for k in self.KINDS}
        self.calls = {k: 0 for k in self.KINDS}

    def record(self):
        self.replaying = False
        self.xs = {k: [] for k in self.KINDS}
        return super().record()

    @contextlib.contextmanager
    def replay(self, shard=None, edge_keys=None):
        self.replaying = True
        self.calls = {k: 0 for k in self.KINDS}
        with super().replay(shard, edge_keys):
            yield
        self.step += 1

    def _log(self, kind: str, x: torch.Tensor, own: torch.Tensor) -> None:
        i = self.calls[kind]
        self.calls[kind] += 1
        mask = self.masks[kind][i].to(x.device)
        if mask.shape != x.shape:  # a rank's rows of the entity axis
            return
        flipped = own != mask
        n = int(flipped.sum())
        if not n:
            return
        rec = self.xs[kind][i]
        where = flipped.nonzero()
        self.sink.append(dict(
            step=self.step, kind=kind, call=i, shape=list(x.shape), flips=n,
            near_zero_recorded=int((rec.abs() <= NEAR_ZERO).sum()),
            at=where[:SHOWN].tolist(),
            own=x.detach()[flipped][:SHOWN].tolist(),
            recorded=rec[flipped][:SHOWN].tolist(),
            rows_of_flips=sorted({tuple(w[:-1]) for w in where.tolist()})[:SHOWN],
            row_max_abs_recorded=[float(rec[tuple(w[:-1])].abs().max())
                                  for w in where[:SHOWN].tolist()]))

    def _patched(self, rrelu, relu, leaky, abs_diff):
        if self.replaying:
            def rr(x):
                self._log("rrelu", x, x >= 0)
                return rrelu(x)

            def re(x):
                self._log("relu", x, x > 0)
                return relu(x)

            def lk(x, negative_slope):
                self._log("leaky", x, x >= 0)
                return leaky(x, negative_slope)
        else:
            def rr(x):
                self.xs["rrelu"].append(x.detach().clone())
                return rrelu(x)

            def re(x):
                self.xs["relu"].append(x.detach().clone())
                return relu(x)

            def lk(x, negative_slope):
                self.xs["leaky"].append(x.detach().clone())
                return leaky(x, negative_slope)
        return super()._patched(rr, re, lk, abs_diff)


def rank_main(rank: int, workdir: str, jobs: list, runs: int) -> None:
    import datetime

    import torch.distributed as dist

    from regcn_torch.parallel.mesh import MeshAxes, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=cs.SHARDS, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh(MeshAxes(1, cs.SHARDS), device_type="cuda")
    cuts = {False: cs.sharded_data(), True: cs.sharded_static_data()}
    lines = []
    for path, mode in jobs:
        for run in range(runs):
            sink = []
            log = FlipLog(sink)
            cs.PinnedKinks = lambda: log
            try:
                cs.sharded_three_steps(f"{path} {mode} run {run} rank {rank}", path,
                                       cuts[path in cs.STATIC_PATHS], mesh, mode, dev)
                ok = True
            except SystemExit:
                ok = False
            counts = {k: [log.flips[k], log.entries[k]] for k in log.KINDS if log.entries[k]}
            lines += [dict(path=path, mode=mode, run=run, **c) for c in sink]
            lines.append(dict(path=path, mode=mode, run=run, check_passed=ok, flips=counts))
    if rank == 0:
        with open(os.path.join(workdir, "lines.json"), "w") as f:
            json.dump(lines, f)
    dist.destroy_process_group()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=4)
    parser.add_argument("--paths", default="hisres gspmd")
    args = parser.parse_args()
    cs.phase_device()
    cs.phase_build()
    jobs = [tuple(p.rsplit(" ", 1)) for p in args.paths.split(",")]
    with tempfile.TemporaryDirectory() as workdir:
        torch.multiprocessing.start_processes(rank_main, args=(workdir, jobs, args.runs),
                                              nprocs=cs.SHARDS, join=True,
                                              start_method="spawn")
        with open(os.path.join(workdir, "lines.json")) as f:
            lines = json.load(f)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/kink_flips.jsonl", "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    for line in lines:
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
