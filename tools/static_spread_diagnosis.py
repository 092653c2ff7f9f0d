#!/usr/bin/env python3
"""How far one process's test MRRs move between runs of the same training
epoch on one NVIDIA GPU, for paths of ``chip_smoke.py``'s sharded phase.
Run from the repository root:

    python3 tools/static_spread_diagnosis.py [--runs 3] [--paths "hisres static,config 5"]

For each of ``--paths`` (any path of ``chip_smoke``'s ``sharded_trainer``;
by default HisRES with the static graph and config 2, on
``sharded_static_data``, synthetic-icews05-15 with its static graph cut to
40 snapshots, and HisRES without it and config 5, on ``sharded_data``, the
icews14s cut) it trains ``--runs`` fresh single-process trainers from the
same seed for one epoch with the config's dropouts, then two with every
dropout at 0, and evaluates each one's test split (twice for the runs with
dropout: the second evaluation shows how much the serving alone moves).
The runs draw the same dropout masks; they differ only where the card's
atomic sums add in another order. Prints the card's name and power limit,
a line per run, and one JSON line per path with the spread (largest minus
smallest) of the test entity raw MRR with and without dropout, which
``chip_smoke.py`` sets beside its sharded phase's limit (``NOISY_PATHS``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

PATHS = ("hisres static", "config 2", "hisres", "config 5")


def run(path, data, dev, dropout: bool) -> tuple:
    """(mean losses, the test MRRs, the test MRRs of a second evaluation)."""
    trainer = cs.sharded_trainer(path, data, dev, dropout=dropout)
    state = trainer.init_state(cs.SEED)
    losses = trainer.run_epoch(state, 0)
    first = {k: v.mrr for k, v in trainer.test(state).items()}
    second = {k: v.mrr for k, v in trainer.test(state).items()} if dropout else first
    return losses, first, second


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--paths", default=",".join(PATHS))
    args = parser.parse_args()
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda")
    # the configs' dropouts, as the sharded phase takes them on every other path
    cs.NOISY_PATHS = ()
    cuts = {False: cs.sharded_data(), True: cs.sharded_static_data()}
    for path in args.paths.split(","):
        data = cuts[path in cs.STATIC_PATHS]
        spread = {}
        for dropout, n in ((True, args.runs), (False, 2)):
            mrrs = []
            for k in range(n):
                losses, first, second = run(path, data, dev, dropout)
                mrrs.append(first["ent_raw"])
                print(f"[{path}] {'dropouts' if dropout else 'dropouts 0'} run {k}: mean losses "
                      + ", ".join(f"{key} {v:.6f}" for key, v in losses.items())
                      + "; test MRR " + ", ".join(f"{key} {v:.6f}" for key, v in first.items())
                      + ("; again " + ", ".join(f"{key} {v:.6f}" for key, v in second.items())
                         if dropout else ""), flush=True)
            spread["dropout" if dropout else "no_dropout"] = {
                "ent_raw": mrrs, "spread": max(mrrs) - min(mrrs)}
        print(json.dumps({"path": path, "card": cs.CARD[0] if cs.CARD else None, **spread}),
              flush=True)


if __name__ == "__main__":
    main()
