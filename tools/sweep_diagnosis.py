#!/usr/bin/env python3
"""How the vectorized sweep (``regcn_torch/train/sweep.py``) amortizes the
host's cost with the number of models K, on one NVIDIA GPU. Run from the
repository root:

    python3 tools/sweep_diagnosis.py [--steps 10] [--warmup 3]

For RE-GCN (config 1 with the CLI's defaults, on synthetic-icews14s seed
123) and for config 3 (LGCN + RotH, c learned, on ``chip_smoke``'s cut of
that data), each with the CLI's dropouts, it times ``--steps`` steady
training steps of one model (``Trainer`` / ``HyperbolicTrainer``) and of
the sweep at K = 1, 2, 4 and 6 (the CLI's lr x seed grid, its first K
combinations), in turns: one model, then each K, then one model again.
Each run first takes ``--warmup`` untimed steps (the sweep's epoch 0
order: the batched shapes' first calls pay for library and allocator
set-up), then times steps on the same windows for every run (the sweep's
epoch 1 order), built and, for the sweep, with their dropout draws
listed before the clock starts; the wall of each is the host clock
around the steps, ended by ``torch.cuda.synchronize()``. Prints the card's name and power limit, a
line per run (ms per step, kernels' launch counts, peak memory) and one
JSON line per family with K x (one model's mean step) / (the sweep's
step), the model-steps per second the sweep gains.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from regcn_torch import cli  # noqa: E402
from regcn_torch.config import ExperimentConfig  # noqa: E402
from regcn_torch.hyperbolic.train import HyperbolicTrainer  # noqa: E402
from regcn_torch.train import loop  # noqa: E402
from regcn_torch.train.sweep import HyperbolicSweepRunner, SweepRunner  # noqa: E402

KS = (1, 2, 4, 6)
DEVICE = torch.device("cuda")


def family(name: str, argv: list, data, steps: int, warmup: int) -> dict:
    """One model's steady steps, the sweep's at each K, one model's again."""
    args = cli.build_parser().parse_args(argv)
    table = cli.grid_table(args.dataset, args.grid_family)
    combos = list(itertools.product(table["lr"], table["seed"]))
    dev = DEVICE
    if name == "regcn":
        exp = cli.make_experiment(args, data)
        single = loop.Trainer(ExperimentConfig(model=exp.model, train=dataclasses.replace(
            exp.train, lr=combos[0][0], seed=combos[0][1])), data, device=dev)

        def sweep(k):
            return SweepRunner(exp.model, exp.train, data, pick(combos, k), device=dev)

        def one_step(state, i):
            single.train_step(state, *single.window(i))
    else:
        cfg, tc = cli.make_hyperbolic_configs(args, data)
        single = HyperbolicTrainer(cfg, dataclasses.replace(tc, lr=combos[0][0],
                                                            seed=combos[0][1]),
                                   data, device=dev)
        cmax = single._curvature_max(0)

        def sweep(k):
            return HyperbolicSweepRunner(cfg, tc, data, pick(combos, k), device=dev)

        def one_step(state, i):
            single.train_step(state, *single.window(i), cmax)

    first = sweep(1)
    warm, order = first.epoch_order(0)[:warmup], first.epoch_order(1)[:steps]
    singles, out = [], {"family": name, "steps": steps, "warmup": warmup}

    def run_single(tag):
        state = single.init_state()
        for i in warm:
            one_step(state, i)
        for i in order:
            single.window(i)
        singles.append(cs.steady_steps(tag, lambda i: one_step(state, i), order)["ms"])
        del state
        torch.cuda.empty_cache()

    for k in KS:
        runner = sweep(k)
        if k == KS[0]:
            run_single(f"{name} one model")
        state = runner.init_state()
        for i in warm:
            runner.train_step(state, i)
        for i in order:
            runner.window(i), runner.draws(state, i)
        res = cs.steady_steps(f"{name} sweep K={k}", lambda i: runner.train_step(state, i),
                              order)
        out[f"K={k}"] = dict(ms=res["ms"], peak_mib=res["peak_mib"])
        del runner, state
        torch.cuda.empty_cache()
    run_single(f"{name} one model, again")
    one = sum(singles) / len(singles)
    out["one_model_ms"] = singles
    for k in KS:
        out[f"K={k}"]["gain"] = k * one / out[f"K={k}"]["ms"]
    return out


def pick(combos, k: int) -> dict:
    return {"lr": [lr for lr, _ in combos[:k]], "seed": [s for _, s in combos[:k]]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--warmup", type=int, default=3)
    opts = parser.parse_args()
    steps, warmup = opts.steps, opts.warmup
    cs.phase_device()
    cs.phase_build()
    data = cs.generate("synthetic-icews14s", seed=cs.SEED)
    grid = ["grid", "-d", "synthetic-icews14s", "--tune", "lr,seed", "--vectorize"]
    results = [
        family("regcn", grid, data, steps, warmup),
        family("config3", [*grid, "--grid-family", "hyperbolic", "--encoder", "lgcn",
                           "--decoder", "roth", "--learn-curvature"], cs.config3_data(), steps,
               warmup),
    ]
    for r in results:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
