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
   config 1's, ``shapes`` holds all three); and the scatter's backward:
   the gradients of h, rel_emb, W and the edge weight through
   ``rgcn_aggregate`` at config 1's first test snapshot against the CPU's,
   within the same tolerance, and bitwise repeatable;
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
   the forward's grid, splits and blocks per SM and both backward
   kernels' grids, cluster sizes and blocks per SM are printed;
6. training path: hyperbolic config 3 (LGCN + RotH, c=0.01 learned with
   a 5-epoch warmup, radius supervision, h=200, 2 layers, n_bases 100,
   history 3) through ``regcn_torch.hyperbolic.train.HyperbolicTrainer``,
   on synthetic-icews14s cut to 120 snapshots (100 / 10 / 10):
   (a) 3 steps on the card, each checked against the CPU from the same
   state (dropouts 0): the losses, every parameter's gradient and the
   optimizer's update; (b) one full epoch (99 steps) with the config's
   dropouts, the kernels' launch counts reset just before and read just
   after (B2 forward and both backward kernels: 2 per step); (c) the
   test split's four MRRs; (d) a few steps under torch.profiler;
7. config-1 training: RE-GCN config 1 as in phase 4, with its training
   settings (dropouts 0.2, task weight 0.7, lr 1e-3, grad norm 1.0,
   weight decay 1e-5), through ``regcn_torch.train.loop.Trainer``:
   (a) 3 steps on the card, each checked against the CPU from the same
   state (dropouts 0): the losses, every parameter's gradient, the new
   BatchNorm statistics and the optimizer's update, the cpu on the card's
   branches at the rrelu/relu kinks; (b) one full epoch
   with the config's dropouts, the kernels' launch counts reset just
   before and read just after (B1: 2 layers x the window's snapshots per
   step; no B2 kernel); (c) 20 steady-state steps; (d) the test split's
   four MRRs, the entity raw MRR above phase 4's random-init one; (e) a
   checkpoint round trip: saved after the epoch, restored into a fresh
   trainer, one step from each copy; (f) a few steps under
   torch.profiler, with B1's forward and the scatter backward apart;
8. hyperbolic headline training: uvrgcn + tangent ConvTransE/R (h=200,
   2 layers, history 3, c=0.01 fixed, dropouts 0.2, residual radius
   evolution, radius supervision, layer norm, fp32; buckets of 128)
   through ``regcn_torch.hyperbolic.train.HyperbolicTrainer``: (a) 3 steps
   cuda vs cpu as in phase 7, the cpu also on the card's signs of
   r_src - r_dst in the radius weight, and B1's edge-weight gradient dw
   compared inside them; (b) one epoch through ``fit(checkpoint_path)``,
   the launch counts reset just before the epoch and read just after (B1:
   2 layers x the window's snapshots per step, 1812 at this data; no B2
   kernel); (c) ``fit(resume=True)`` in a fresh trainer restores it
   exactly, one step from each copy; (d) 20 steady steps; (e) the test
   split at random init and after the epoch, 6 B1 launches per snapshot,
   the entity raw MRR above the random-init one; (f) a profile of a step,
   with B1's forward and the scatter backward apart;
9. config-4 training: BASELINE.json config 4, uvrgcn + AttH / AttH-Rel
   (h=200, 2 layers, history 3, c=0.01 learned, a curvature per relation,
   an entity bias, dropouts 0.2, fp32; buckets of 128), the first path
   that runs B1 and B2 in one step, B2's entity loss on the true distance
   with per-query curvature, on phase 6's cut of synthetic-icews14s: (a)
   3 steps cuda vs cpu as in phase 8, the
   gradients of log_c, rel_curvature_raw (B2's dc) and entity_bias (B2's
   dbias) printed apart; B2's three kernels timed at config 4's entity
   shape on that distance; (b) one epoch through ``fit``, the launch
   counts reset just before the epoch and read just after (B1 2 x the
   window's snapshots, each B2 kernel 2 per step); (c) 20 steady steps; (d) the
   test split at random init and after the epoch (B1 6 launches per
   snapshot, no B2), the entity raw MRR above the random-init one; (e) a
   profile of a step, with B1's forward, the scatter backward and the
   three B2 kernels apart;
10. config-5 training: BASELINE.json config 5, the headline with EST
   (H-PES memories, alpha 0.2; ETNR retrieval of K = 32 events; the QCHHE
   GRU) and TANS negatives, on synthetic-gdelt (seed 123, GDELT's 7691
   entities, 240 relations and 700 triples a snapshot, the time axis cut
   to 100 snapshots split 80/10/10), through phase 8's steps: (a) 3 steps
   cuda vs cpu, the cpu also on the card's branches at H-TDP's relu, the
   H-PES memories compared after each device's writeback; (b) one epoch
   through ``fit(checkpoint_path)`` (B1 2 x the window's snapshots, no
   B2); (c) the resume, the H-PES memories among the tensors restored
   exactly; (d) 20 steady steps; (e) the test split at random init and
   after the epoch (B1 6 a snapshot);
   (f) a profile of a step;
11. config-2 training: BASELINE.json config 2, RE-GCN with the static
   entity-word graph (a block-diagonal RGCN layer over entities and words
   starts the evolution; an angular constraint ties each step to it;
   n_bases 100, static weight 0.5, angle 10, discount 1), h=200, 2
   layers, history 3, dropouts 0.2, on synthetic-icews18 (seed 123,
   ICEWS18's 23033 entities, 256 relations and 1200 triples a snapshot,
   3 static links an entity) with its time axis cut to 120 snapshots
   (100 / 10 / 10) through
   ``loop.Trainer``: (a) 3 steps cuda vs cpu, the static loss among the
   losses, the cpu on the card's branches at every rrelu (the static
   layer's too); (b) one epoch through ``fit(checkpoint_path)`` (B1 2 x
   the windows' snapshots, 588, no B2); (c) the resume; (d) 20 steady
   steps and their peak memory; (e) the test split at random init and
   after the epoch (B1 60); (f) a
   profile of a step, and the static layer profiled alone with its share
   of the step's device time;
12. the hyperbolic headline with the static graph on the same data: (a) 3
   steps cuda vs cpu with B1's dw; (b) one epoch through ``fit`` (B1
   588); (e) the test split (B1 60);
13. the rest of the hyperbolic trainer on phase 6's cut of synthetic-icews14s, the
   headline with its entities on the ball and Riemannian Adam
   (``manifold_entities``): (a) 3 snapshots cuda vs cpu in triple batches
   of 256 rows in each mode (``accumulate``, ``per_chunk``), the
   Riemannian moments and the retracted entity table compared after each
   optimizer step; (b) one ``accumulate`` epoch, B1 exactly 2 layers x
   each window's snapshots x its non-empty chunks; (c) both trainers'
   ``analysis_record`` on the card and the CPU; (d) 3 windows through
   ``evolve(tangent_fast=False)``, the uvrgcn's ball-space layer on B1
   (2 launches per window snapshot), cuda vs cpu with every gradient;
14. HisRES (``regcn_torch.hisres.train.HisResTrainer``) on phase 6's cut of
   synthetic-icews14s with ``run_hisres``'s defaults (h=200, 2 layers,
   history 3, history rate 0.3, dropouts 0.2, ``rc_mode="src"``, relation
   history over the whole window, history graphs in buckets of 4096 edges
   capped at 65536, lr 1e-3, task weight 0.7; buckets of 128): (a) 3
   steps cuda vs cpu, the cpu on the card's branches at every rrelu and at
   the attention's leaky relu, B1's dw (the attention weight's gradient)
   among the checks; (b) one epoch through ``fit(checkpoint_path)``, B1
   exactly 2 x (T + max(T - 1, 1)) + 4 times a step (T the window's
   snapshots; 1376 at this data), no B2; the history graphs' real edges
   and how many hit the cap; (c) the resume; (d) 20 steady steps, their
   launches and peak memory; (e) the test split at random init and after
   the epoch (B1 14 a snapshot, 140), the entity raw MRR above the
   random-init one; (f) a profile of a step;
15. config 3 with the FHNN, then the HGAT encoder (RotH / RotH-Rel, c =
   0.01 learned; buckets of 128) on phase 6's cut data: (a) 3 steps cuda
   vs cpu, HGAT's attention leaky relu pinned; (b) 10 steady steps with
   their peak
   memory, each B2 kernel exactly twice a step, no B1; (c) the test split
   after them; (d) a profile of a step;
16. the CLI: ``regcn_torch.cli.main(["train", "-d", "synthetic-icews14s",
   "--n-epochs", "1", ...])`` with the CLI's defaults (config 1, buckets of
   1024 / 512), then ``test``, which restores train's best checkpoint: B1
   exactly the epoch's 2 x window snapshots plus 6 per valid and test
   snapshot (2178), then 186; no B2; the same metrics within 1e-4;
17. ``cli.main(["entity", "-d", "synthetic-aifb"])`` with the CLI's
   defaults (basis-RGCN classifier, h=200, one basis per relation: 91
   relations, 8285 nodes, 91136 padded edges, 4 classes): B1 held against
   its plain version at d=200 and d=4 on that graph and timed there; the
   logits at the seed's initial parameters card vs CPU; 30 full-batch
   steps and two evaluations: B1 exactly 64, the accuracies, the peak
   memory;
18. ``cli.main(["grid", "--tune", "lr,seed", "--vectorize", ...])`` for
   the regcn family, K = 6 models under ``torch.func.vmap``: (a) 3
   vmapped steps against each model's steps alone on the card from the
   same state (dropouts 0; each model on the kinks' branches the vmapped
   step took); (b) the CLI's epoch and valid split, B1 folded to one
   launch for the 6 models (as many as one model's run); (c) 20 steady
   vmapped steps beside 20 of one model, and each profiled; (d) B1 at the
   folded [E, 1200]; then the hyperbolic ``grid --vectorize`` on config 3
   (phase 6's cut data, K = 6): its 3-step check, 10 steady steps with
   each B2 kernel exactly 2 x K a step beside one model's, and the
   headline vmapped over 2 learning rates (B1 folded with each model's
   radius weight) through the same 3-step check;
19. bf16 compute (``compute_dtype="bfloat16"``: parameters fp32, cast to
   bf16 inside the loss with JAX's fp32 islands, B1 and B2 fed fp32):
   the card's bf16 GEMM with an fp32 result against the fp32 product of
   the same values; then the headline in ``bench.py``'s configuration,
   config 1, and config 3 and HisRES on phase 6's cut data, each with (a) 3
   steps on the card in bf16, on the CPU in bf16 and on the CPU in fp32
   from one state (dropouts 0): every loss and parameter of the card
   within twice the CPU's own bf16 drift from fp32 plus a stated atol;
   (b) the dtypes: the carry bf16, the scores and the parameters fp32;
   (c) 10 steady bf16 steps with the fp32 twin's launches of B1 and B2,
   and a profiled 3, printed beside the fp32 phase's wall, busy and
   kernels per step; the headline also one epoch through ``fit`` (B1
   1812) and its test split (B1 186), its entity loss within 5 % and its
   test entity raw MRR within 0.02 of phase 8's fp32 epoch;
20. the native snapshot builder, compiled from
   ``regcn_torch/csrc/graph_builder.cc`` with the host's C++ compiler:
   (a) its arrays equal numpy's for every snapshot of the three splits;
   (b) config 1's rolling evaluation of the test split with each builder:
   the host ms per query snapshot spent building windows, the MRRs
   within 1e-4 (the card's segment sums add in no fixed order);
   (c) config 1 served with ``impl="cumsum"``: the aggregation within
   1e-4 (relative) of B1 at the first test snapshot, the four MRRs within
   0.01 of B1's, no kernel launched; (d) ROADMAP C.8: with ``$CXX`` a
   missing program and a fresh build directory, the default builder warns
   once and builds numpy's arrays, ``use_native=True`` raises;
21. B2 at the widths of ROADMAP C.7 (after phase 5): the three kernels
   against the plain version at d = 50 (padded to 52 by the wrapper), 300
   and 512, config 3's entity shape, both distances, the value and every
   gradient within phase 5's limits, each width timed beside its bound and
   the matmul; one config-3 step (LGCN + RotH) at n_hidden 50 and 300 on
   the cut data, each B2 kernel launched twice, the losses finite;
22. entity-sharded training at full width (``mesh=..., dist_agg=...``,
   ROADMAP A.11 and A.11b) of nine paths: config 1, the hyperbolic
   headline, config 3 (LGCN + RotH, B2 over the all-gathered table on
   every rank), HisRES and config 5 (the headline with EST and TANS: the
   memories replicated, the enrichment's rows gathered by global id, the
   TANS COO cut to the rank's columns) in both modes, config 3
   triple-batched (chunks of 128 triples, ``accumulate``) under ``gspmd``,
   on synthetic-icews14s cut to 40 snapshots (30 / 5 / 5); and with the
   static graph (``words_emb`` row-sharded, the block layer whole on the
   gathered tables) config 2 in both modes, the static headline and
   HisRES under ``gspmd``, on synthetic-icews05-15 with its static graph
   cut alike (its 10488 entities and its words divide by 2, as the sharded
   words_emb needs); G = 2 spawned ranks for each of three groups of
   (path, mode) runs sharing the card over gloo (a file store each; the
   groups side by side): the halo's boundary statistics of each training
   split; meanwhile each single-process trainer's epoch and test split as
   the reference; in each rank, for each of its runs: (a) 3 steps against
   the single-process trainer on the card from the same state, on rank 0's
   one-process branches at the kinks (the uvrgcn's radius-weight signs
   edge by edge):
   the losses, every gradient (the entity and word tables gathered) and
   the model state of each chunk, with EST the memories after each
   write-back (within the gradients' limit of one process's, bit-equal on
   every rank), and every parameter after both optimizers step with the
   same gradients, within the 3-step checks' limits; (b) one epoch with
   the config's dropouts (none on ``NOISY_PATHS``, config 5 and HisRES
   with the static graph), B1 and B2 launched per rank as one process
   launches, each count printed beside its prediction from the data (B1 2
   x the windows' snapshots, HisRES ``hisres_launches``, config 3's B2
   kernels twice a step or, triple-batched, twice a chunk), with EST the
   memories after it bit-equal on every rank; (c) the test split, B1 per
   rank as one process, the four MRRs within 0.01 of the single
   process's; each rank's peak memory and walls (gloo stages every
   collective through the host: no speed is read from them). A failing
   rank fails the phase.

The line before the last is ``{"kernels": [...]}``: each row's
``launches`` is B1's on the config-1 test split or a B2 kernel's in the
config-3 epoch, and ``launches_by_path`` holds its count on each path
(config 5's, phases 11-13's and HisRES's, FHNN's and HGAT's, the CLI's
and the sweeps' among them); B1's ``shapes`` holds its times at six
shapes (phase 3's three, synthetic-aifb's d=200 and d=4, the folded
[E, 1200]), each B2 kernel's its times at config 4's entity shape on the
true distance, then at d = 50, 300 and 512 (phase 21). The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from regcn_torch.config import ExperimentConfig, ModelConfig, TrainConfig  # noqa: E402
from regcn_torch.data.snapshots import (  # noqa: E402
    build_history,
    build_snapshot,
    pad_triples,
    split_by_time,
)
from regcn_torch.data.synthetic import generate  # noqa: E402
from regcn_torch.hisres import layers as hisres_layers  # noqa: E402
from regcn_torch.hisres.model import HisResConfig  # noqa: E402
from regcn_torch.hisres.train import HisResTrainer  # noqa: E402
from regcn_torch.hyperbolic import est as hyp_est  # noqa: E402
from regcn_torch.hyperbolic import layers as hyp_layers  # noqa: E402
from regcn_torch.hyperbolic import model as hyp_model  # noqa: E402
from regcn_torch.hyperbolic.decoders import REL_C_EPS  # noqa: E402
from regcn_torch.hyperbolic.model import HyperbolicConfig  # noqa: E402
from regcn_torch.hyperbolic.ops import exp_map_zero  # noqa: E402
from regcn_torch.hyperbolic.train import HyperbolicTrainer  # noqa: E402
from regcn_torch.models import decoders as model_decoders  # noqa: E402
from regcn_torch.models import layers as model_layers  # noqa: E402
from regcn_torch.models import recurrent  # noqa: E402
from regcn_torch.ops import cuda_build, rgcn_scatter  # noqa: E402
from regcn_torch.ops import streaming_ce as ce  # noqa: E402
from regcn_torch.ops.activations import RRELU_LOWER, RRELU_UPPER  # noqa: E402
from regcn_torch.ops.rgcn_scatter import (  # noqa: E402
    rgcn_aggregate,
    scatter_add_sorted,
    scatter_add_sorted_reference,
)
from regcn_torch.train import loop  # noqa: E402
from regcn_torch.train import state as train_state  # noqa: E402
from regcn_torch.train.optim import tree_leaves  # noqa: E402

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
# the same on the true distance, off ``pair_logit`` and the two
# ``pair_grad`` of streaming_ce.cu, each arithmetic operation,
# comparison-select, square root, artanh, exp and division counted once:
# ~33 for the logit and ~5 for the running softmax; the query side's chain
# back to p, |q|^2 and c ~72 more, the candidate side's back to p and |x|^2
# ~42 more
CE_TRUE_OPS = {"streaming_ce_fwd": 38, "streaming_ce_bwd_q": 110, "streaming_ce_bwd_x": 80}
# training path, CUDA against CPU from the same parameters (dropouts 0)
TRAIN_LOSS_RTOL = 1e-4  # fp32 sums in another order on each side
TRAIN_GRAD_TOL = 1e-4  # per parameter, relative to max(1, max|cpu grad|)
# the optimizer step on both devices from the same parameters, moments and
# gradients: fp32 rounding of the clip norm and of m / sqrt(v) only, each
# entry within this times max(1, |cpu parameter|)
TRAIN_OPT_TOL = 1e-6
# config 1's 3 steps: at most this share of the pre-activations at the
# rrelu/relu kinks may take the other branch on the CPU than on the card
# (1 to 3 of 59.6M entries on an H100); the CPU replays the card's
# branches, so only a few entries within rounding of 0 may differ
KINK_FLIP_SHARE = 1e-6
# the uvrgcn's radius weight exp(-γ|r_src - r_dst|): the sign of r_src -
# r_dst may differ between the devices only where the two radii (0.5 to
# ~3.2) agree within rounding, ~40 fp32 ulps at radius 3
ABS_TIE_TOL = 1e-5
# the attention logits' leaky relu (HisRES's candidate layers, HGAT): HGAT's
# logit <attn_vec, log_0(h_src ⊕ -h_dst)> is 0 by construction where the two
# ends are one point (every padded edge), and its fp32 rounding (~1e-10)
# takes either sign; so a flipped logit is held to this size instead of a
# share of the entries
LEAKY_TIE_TOL = 1e-6
# the CLI's test of a restored checkpoint against train's test of the same
# state: fp32 scores in another run may reorder near-ties, moving a rank
CLI_MRR_TOL = 1e-4
PROFILE_STEPS = 20  # steady steps timed
# the bf16 phase's steady steps and each of its alternating blocks: 10, not
# PROFILE_STEPS, to keep the script within its time beside the sharded phase
BF16_STEADY_STEPS = 10
# the fhnn and hgat phase's steady steps, for the same reason
ENCODER_STEADY_STEPS = 10
# steps under torch.profiler: its key_averages over a step's thousands of
# kernels take seconds a step, the most of a phase at 20 steps; 3 (5 until
# the sharded phase took four paths) keep the script within its time on a
# slow host
PROFILED_STEPS = 3
# each path's steady-state step (wall ms) and profiled step (wall and busy
# ms, kernels and copies), by label, for the bf16 phase's side-by-side
STEADY: dict = {}
PROFILES: dict = {}
# the fp32 headline's epoch (mean losses) and test split (MRRs), which the
# bf16 phase compares with its own
EPOCHS: dict = {}
# the profiles that also print their host time by operator: the bf16
# phase's and their fp32 twins'
HOST_BREAKDOWN = {"train step", "config-1 train step", "headline train step",
                  "hisres train step", "headline bf16 train step", "config-1 bf16 train step",
                  "config-3 bf16 train step", "hisres bf16 train step"}
# parameters that no loss reads: the H-PES gate, which only the writeback
# after the backward reads (JAX's gradient of each is 0)
NO_GRAD = {"est.slow_threshold", "est.slow_scale"}

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
    CARD.append(smi.stdout.strip().splitlines()[0])
    print(CARD[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    try:
        names = sorted({k["build"] for k in KERNELS})
        logs = cuda_build.build(names + [v for v, (src, _) in cuda_build.VARIANTS.items()
                                         if src in names])
    except RuntimeError as e:
        fail(str(e))
    seconds = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:  # each kernel's counts under its instance's name
                kernel = re.search(r"(?:^|\d)([a-z][a-z_]*_kernel)", entry.group(1))
                args = re.findall(r"L[bi](\d+)E", entry.group(1))
                print(f"[build] {name}: {kernel.group(1) if kernel else entry.group(1)}"
                      f"<{','.join(args)}>")
            elif "registers" in line or "spill" in line:
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


def aggregate_grads(h, rel_emb, weight, snap, G, device) -> tuple:
    """Gradients of sum(rgcn_aggregate(...) * G) by h, rel_emb, W and the
    edge weight (the snapshot's edge mask, made to require grad)."""
    leaves = [t.detach().to(device).requires_grad_(True)
              for t in (h, rel_emb, weight, snap.edge_mask)]
    out = rgcn_aggregate(*leaves[:3], snap.src.to(device), snap.dst.to(device),
                         snap.rel.to(device), leaves[3], snap.in_deg_norm.to(device),
                         dst_sorted=True)
    return torch.autograd.grad(out, leaves, G.to(device), allow_unused=True)


def aggregate_grad_check(h, rel_emb, weight, snap, G, dev) -> None:
    """The scatter's backward on the card: every gradient present, within
    KERNEL_TOL * max(1, max|cpu gradient|) of the CPU's from the same
    inputs, and two backward calls bitwise equal."""
    first = aggregate_grads(h, rel_emb, weight, snap, G, dev)
    second = aggregate_grads(h, rel_emb, weight, snap, G, dev)
    want = aggregate_grads(h, rel_emb, weight, snap, G, "cpu")
    torch.cuda.synchronize()
    parts = []
    for name, a, b, w in zip(("h", "rel_emb", "W", "edge_weight"), first, second, want):
        check(a is not None and w is not None, f"rgcn_aggregate gave {name} no gradient")
        err = (a.cpu() - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        check(math.isfinite(err) and err <= KERNEL_TOL * scale,
              f"rgcn_aggregate d{name} cuda vs cpu: max abs err {err:.3e} > {KERNEL_TOL:.0e} * "
              f"{scale:.3e}")
        check(torch.equal(a, b), f"rgcn_aggregate d{name}: two backward calls differ")
        parts.append(f"d{name} {err:.3e} (scale {scale:.3e})")
    print("[kernels] rgcn_aggregate gradients cuda vs cpu at config 1's first test snapshot, "
          "bitwise repeatable: " + ", ".join(parts), flush=True)


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

    # differentiable on the card: gradients through rgcn_aggregate against the CPU
    G = torch.from_numpy(g.normal(size=(N, d)).astype(np.float32))
    aggregate_grad_check(h, rel_emb, weight, snap, G, dev)

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


def phase_main_path(data, cfg: ModelConfig, tc: TrainConfig, dev: torch.device) -> tuple:
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
    return launches, stats


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
            seed=SEED, c_low=0.005):
    """Inputs of the streaming CE on ``dev`` from a seeded numpy generator:
    ball points for c = 0.01 (per-query curvatures from ``c_low`` to 0.999
    c, as the relation-curvature clamp bounds them), targets in the last
    partial tile, an upstream gradient g that is 0 on a masked query tail."""
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
    cq = (rng.uniform(c_low, 0.999 * c, B) if per_query_c else np.full(B, c)).astype(np.float32)
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


def ce_bound_ms(B, N, d, true: bool = False) -> dict:
    """Least time of each kernel: each input read once, each output
    written once, over HBM; the q.x products (and the dq or dx product of
    the backward kernels) plus the elementwise work of the distance over
    fp32 peak."""
    def bound(nbytes, flops):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    ops = (CE_TRUE_OPS if true else
           {"streaming_ce_fwd": CE_FWD_OPS, "streaming_ce_bwd_q": CE_BWD_OPS,
            "streaming_ce_bwd_x": CE_BWD_OPS})
    inputs = 4 * (B * d + N * d + N + 3 * B + 2)  # q, x, bias, cq, target, scale, margin
    return {
        "streaming_ce_fwd": bound(inputs + 4 * 2 * B,
                                  2 * B * N * d + ops["streaming_ce_fwd"] * B * N),
        "streaming_ce_bwd_q": bound(inputs + 4 * 2 * B + 4 * (B * d + B + 2),
                                    4 * B * N * d + ops["streaming_ce_bwd_q"] * B * N),
        "streaming_ce_bwd_x": bound(inputs + 4 * 2 * B + 4 * (N * d + N),
                                    4 * B * N * d + ops["streaming_ce_bwd_x"] * B * N),
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
    for name, (bound_ms, bound_by) in ce_bound_ms(B, N, q.shape[1], true).items():
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
        plan = ce.forward_plan(B, n, d, False, dev)
        print(f"[ce] streaming_ce_fwd launch at the {label} shape: grid {plan['grid']} blocks, "
              f"{plan['splits']} splits per tile of {plan['queries']} queries "
              f"({plan['candidate_tiles_per_block']} candidate tiles of {ce.FWD_ROWS} rows per "
              f"block), {plan['blocks_per_sm']} block(s) per SM", flush=True)
        plan = ce.backward_q_plan(B, n, d, False, dev)
        print(f"[ce] streaming_ce_bwd_q launch at the {label} shape: grid {plan['grid']} blocks, "
              f"{plan['splits']} clusters of {plan['cluster']} per query tile "
              f"({plan['candidate_tiles_per_block']} candidate tiles of {ce.BWD_Q_ROWS} rows per "
              f"block), {plan['blocks_per_sm']} block(s) per SM, {plan['active_clusters']} "
              f"clusters resident at once", flush=True)
        plan = ce.backward_x_plan(B, n, d, False, dev)
        print(f"[ce] streaming_ce_bwd_x launch at the {label} shape: grid {plan['grid']} blocks "
              f"in clusters of {plan['cluster']} ({plan['query_tiles_per_block']} query tiles of "
              f"{ce.BWD_X_ROWS} rows per block), {plan['blocks_per_sm']} block(s) per SM, "
              f"{plan['active_clusters']} clusters resident at once", flush=True)
        times[label] = t
    return {k: dict(max_abs_err=errs[k], **times["entity"][k]) for k in CE_KERNELS}


# B2 at the widths it refused until ROADMAP C.7's repair: 50 (padded to 52
# by the wrapper), and the wide instances at 300 and 512
CE_WIDTHS = (50, 300, 512)


def phase_ce_widths(N: int, cut, dev: torch.device) -> dict:
    """(a) B2's three kernels against the plain version at each of
    ``CE_WIDTHS``, at config 3's entity shape (B = 512, N): the proxy with a
    scalar c and the true distance with per-query c, the value and all six
    gradients within phase 5's limits, one launch of each kernel a case;
    each width timed on the proxy (the kernels at the width they launch,
    the plain version, the matmul of that shape) beside the bound of the
    function at its own width; (b) one config-3 step (LGCN + RotH) at
    n_hidden 50 and 300 on the cut data: each B2 kernel launched twice
    (entity and relation loss), the losses finite."""
    B = 512
    out = {k: [] for k in CE_KERNELS}
    for d in CE_WIDTHS:
        parts = []
        for true in (False, True):
            a = ce_case(B, N, d, dev, true=true, per_query_c=true, masked=True)
            reset_launches()
            got, got_g = ce_run(ce.streaming_nll, a)
            counts = read_launches()
            check(all(counts[k] == 1 for k in CE_KERNELS),
                  f"streaming CE at d={d}: launches {counts}, expected one of each kernel")
            plain, plain_g = ce_run(ce.streaming_nll_reference, a)
            exact, exact_g = ce_run(ce.streaming_nll_reference, a, torch.float64)
            torch.cuda.synchronize()
            for name, tol, (k, p, e) in [("nll", CE_NLL_TOL, (got, plain, exact))] + [
                    (n, CE_GRAD_TOL, (got_g[n], plain_g[n], exact_g[n])) for n in CE_INPUTS]:
                err = (k.double() - e).abs().max().item()
                plain_err = (p.double() - e).abs().max().item()
                limit = max(tol * max(1.0, e.abs().max().item()), 2 * plain_err)
                check(k.shape == e.shape and math.isfinite(err) and err <= limit,
                      f"streaming CE at d={d} ({'true' if true else 'proxy'}): {name} max err "
                      f"{err:.3e} > {limit:.3e} (plain fp32 err {plain_err:.3e})")
                parts.append(f"{name} {err:.1e}")
        a = ce_case(B, N, d, dev)
        d4 = -(-d // 4) * 4
        for k in ("q", "x"):  # as the wrapper pads them
            a[k] = torch.nn.functional.pad(a[k], (0, d4 - d)).contiguous()
        t = ce_times(a)
        for name, (bound_ms, bound_by) in ce_bound_ms(B, N, d).items():
            t[name].update(bound_ms=bound_ms, bound_by=bound_by, d=d)
            out[name].append(t[name])
            print(f"[ce-width] {name} at B={B} N={N} d={d} (launched at {d4}): kernel "
                  f"{t[name]['ms'] * 1e3:.2f} us, plain {t[name]['plain_ms'] * 1e3:.2f} us, "
                  f"matmul {t[name]['library_ms'] * 1e3:.2f} us, bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by})", flush=True)
        print(f"[ce-width] d={d}: both distances within phase 5's limits, kernel err vs fp64: "
              + ", ".join(parts), flush=True)
    tc3 = TrainConfig(train_history_len=3, test_history_len=3)
    for h, bases in ((50, 50), (300, 100)):
        trainer = HyperbolicTrainer(dataclasses.replace(config3(cut), h_dim=h, n_bases=bases),
                                    tc3, cut, curvature_warmup_epochs=5, device=dev)
        state = trainer.init_state(SEED)
        i = trainer.epoch_order(0)[0]
        window = trainer.window(i)
        reset_launches()
        losses = trainer.train_step(state, *window, trainer._curvature_max(0))
        torch.cuda.synchronize()
        counts = read_launches()
        check(all(counts[k] == 2 for k in CE_KERNELS),
              f"config 3 at n_hidden {h}: launches {counts} in a step, expected 2 of each B2 "
              "kernel")
        check(all(math.isfinite(float(v)) for v in losses.values()),
              f"config 3 at n_hidden {h}: losses {losses}")
        print(f"[ce-width] config 3 (LGCN + RotH) at n_hidden {h}: one step on snapshot {i}, "
              f"launches {counts}, losses "
              + ", ".join(f"{k} {float(v):.5f}" for k, v in losses.items()), flush=True)
    return out


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


def model_state_leaves(ms) -> list:
    """Every tensor of a model state (BatchNorm running statistics, the
    radius targets), field by field."""
    return [t for f in dataclasses.fields(ms) for t in tree_leaves(getattr(ms, f.name))]


def state_leaves(state) -> list:
    """Parameters, Adam moments, the model state and, with EST, the H-PES
    memories."""
    est = [] if state.est_state is None else [state.est_state.fast, state.est_state.slow]
    return (tree_leaves(state.params) + state.opt_state.mu + state.opt_state.nu
            + model_state_leaves(state.model_state) + est)


def copy_state_into(dst, src) -> None:
    """Parameters, Adam moments, BN statistics and H-PES memories of
    ``src`` into ``dst``, in place."""
    with torch.no_grad():
        for a, b in zip(state_leaves(dst), state_leaves(src)):
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
            total, parts, *_ = tr.loss(st, *tr.window(i), cmax)
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
    STEADY["train step"] = steady_s / len(order) * 1e3
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
    cmax = trainer._curvature_max(2)
    train_profile("train step", lambda i: trainer.train_step(state, *trainer.window(i), cmax),
                  trainer.epoch_order(2)[:PROFILED_STEPS])
    return launches


def train_profile(label: str, step, order, scatter: bool = False, ce: bool = False) -> float:
    """``step(i)`` for each i of ``order`` under torch.profiler: device busy
    time by kernel against the wall time (returned: busy us per step); with
    ``scatter``, B1's forward
    kernel and the scatter's backward (``_ScatterAddSortedBackward``: the
    plain-torch gather of the autograd Function) apart; with ``ce``, the
    three B2 kernels apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in order:
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n = len(order)
    events = prof.key_averages()
    kernels = sorted((e for e in events
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    PROFILES[label] = dict(wall_ms=wall_us / n / 1e3, busy_ms=busy_us / n / 1e3,
                           kernels=sum(e.count for e in kernels) / n)
    print(f"[profile] {label} under torch.profiler: wall {wall_us / n / 1e3:.2f} ms, device "
          f"busy {busy_us / n / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} %), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels and copies per step", flush=True)
    for e in kernels[:10]:
        print(f"[profile]   {e.self_device_time_total / n:9.1f} us/step "
              f"{e.count / n:5.0f}x  {e.key[:90]}", flush=True)
    if label in HOST_BREAKDOWN:
        host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
        host_ms = sum(e.self_cpu_time_total for e in host) / n / 1e3
        print(f"[profile]   host: self CPU time {host_ms:.2f} ms/step, the largest:", flush=True)
        for e in host[:12]:
            print(f"[profile]   host {e.self_cpu_time_total / n:9.1f} us/step "
                  f"{e.count / n:6.0f}x  {e.key[:80]}", flush=True)
    if scatter:
        fwd = [e for e in kernels if "scatter_sorted_kernel" in e.key]
        bwd = [e for e in events if e.key == "_ScatterAddSortedBackward"]
        check(fwd and bwd, "the profile shows no B1 forward kernel or no scatter backward")
        fwd_us = sum(e.self_device_time_total for e in fwd)
        bwd_us = sum(e.device_time_total for e in bwd)
        print(f"[profile]   B1 forward: {fwd_us / n:.1f} us/step in "
              f"{sum(e.count for e in fwd) / n:.0f} launches ({100 * fwd_us / busy_us:.1f} % of "
              f"busy); scatter backward (gather): {bwd_us / n:.1f} us/step in "
              f"{sum(e.count for e in bwd) / n:.0f} calls ({100 * bwd_us / busy_us:.1f} % of "
              "busy)", flush=True)
    if ce:
        parts, total_us = [], 0.0
        for name in ("ce_forward_kernel", "ce_backward_q_kernel", "ce_backward_x_kernel"):
            found = [e for e in kernels if name in e.key]
            check(bool(found), f"the profile shows no {name}")
            us = sum(e.self_device_time_total for e in found)
            total_us += us
            parts.append(f"{name} {us / n:.1f} us/step in {sum(e.count for e in found) / n:.0f} "
                         "launches")
        print("[profile]   B2: " + ", ".join(parts) + f"; together {total_us / n:.1f} us/step "
              f"({100 * total_us / busy_us:.1f} % of busy)", flush=True)
    return busy_us / n


# ------------------------------------------------------- config-1 training

NO_DROPOUT = dict(dropout=0.0, input_dropout=0.0, hidden_dropout=0.0, feat_dropout=0.0)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max(1, max |b|), ``b`` on the CPU."""
    return (a.detach().cpu() - b.detach()).abs().max().item() / max(1.0, b.abs().max().item())


class PinnedKinks:
    """The branches a model takes at its kinks, recorded on one device and
    replayed on another: the fixed-slope rrelu of the RGCN layers (RE-GCN's,
    the hyperbolic encoders' and HisRES's), the decoders', EST's H-TDP and
    the static angular loss's relu (its hinge over [T, N]), the leaky relu
    of the attention logits (HisRES's candidate layers, HGAT), and
    the sign of r_src - r_dst in the uvrgcn's radius weight
    exp(-γ|r_src - r_dst|), each patched by its name in its module. An fp32 value within rounding
    of 0 may take the other branch on the other device, and a few such
    entries among the ~20M of a step can move a gradient by more than
    TRAIN_GRAD_TOL of its parameter's largest entry. Replaying the card's
    branches on the CPU compares the two devices on one branch of the
    function. ``flips`` counts, per kind, the entries whose own branch
    differed, which the training phases hold to KINK_FLIP_SHARE of
    ``entries`` for the activations: pre-activations that went wrong on
    the card would show there. Radii tie by construction (entities of
    one radius target), so there ``abs_flip_max``, the largest |r_src -
    r_dst| of a flipped edge, is held to ABS_TIE_TOL instead, and the
    attention logits, which tie at 0 on every padded edge of HGAT, to
    LEAKY_TIE_TOL."""

    KINDS = ("rrelu", "relu", "leaky", "abs")
    ACTIVATIONS = ("rrelu", "relu")

    def __init__(self):
        self.masks = {k: [] for k in self.KINDS}
        self.flips = {k: 0 for k in self.KINDS}
        self.entries = {k: 0 for k in self.KINDS}
        self.flip_max = {}  # per kind, the largest |pre-activation| that flipped
        self.abs_flip_max = 0.0

    @contextlib.contextmanager
    def _patched(self, rrelu, relu, leaky, abs_diff):
        saved = (model_layers.rrelu, hyp_layers.rrelu, hisres_layers.rrelu, model_decoders.relu,
                 hyp_est.relu, recurrent.relu, hyp_layers.leaky_relu, hisres_layers.leaky_relu,
                 hyp_layers._abs_diff)
        model_layers.rrelu = hyp_layers.rrelu = hisres_layers.rrelu = rrelu
        model_decoders.relu = hyp_est.relu = recurrent.relu = relu
        hyp_layers.leaky_relu = hisres_layers.leaky_relu = leaky
        hyp_layers._abs_diff = abs_diff
        try:
            yield
        finally:
            (model_layers.rrelu, hyp_layers.rrelu, hisres_layers.rrelu, model_decoders.relu,
             hyp_est.relu, recurrent.relu, hyp_layers.leaky_relu, hisres_layers.leaky_relu,
             hyp_layers._abs_diff) = saved

    def record(self):
        """Runs the model as it is and keeps each kink's branch."""
        self.masks = {k: [] for k in self.KINDS}
        rrelu, relu, abs_diff = model_layers.rrelu, model_decoders.relu, hyp_layers._abs_diff
        leaky = hisres_layers.leaky_relu

        def rec_rrelu(x):
            self.masks["rrelu"].append(x >= 0)
            return rrelu(x)

        def rec_relu(x):
            self.masks["relu"].append(x > 0)
            return relu(x)

        def rec_leaky(x, negative_slope):
            self.masks["leaky"].append(x >= 0)
            return leaky(x, negative_slope)

        def rec_abs(a, b):
            self.masks["abs"].append(a - b >= 0)
            return abs_diff(a, b)

        return self._patched(rec_rrelu, rec_relu, rec_leaky, rec_abs)

    def share(self, group) -> None:
        """Every rank of ``group`` takes its first rank's recorded branches
        (a collective): ranks that compare their parts of a sharded run with
        one process's run, each recorded in its own process, must replay
        one run's branches, those of the run whose gradients they take."""
        import torch.distributed as dist

        src = dist.get_global_rank(group, 0)
        for masks in self.masks.values():
            for k, mask in enumerate(masks):
                byte = mask.to(torch.uint8).contiguous()
                dist.broadcast(byte, src=src, group=group)
                masks[k] = byte.bool()

    @contextlib.contextmanager
    def replay(self, shard=None, edge_keys=None):
        """Takes the recorded branches, in the order they were recorded,
        and checks that the replay passed every recorded kink. With
        ``shard`` (a rank's ``RowShard`` of the entity table) the replay
        runs on the rank's rows of a table whose whole was recorded, and
        takes those rows of each such mask; with ``edge_keys`` (per radius
        weight call, the recorded edges' keys and the rank's,
        ``radius_edge_keys``) each rank edge takes the sign of its own edge
        in the recorded run."""
        queues = {k: iter(v) for k, v in self.masks.items()}
        keys = None if edge_keys is None else iter(edge_keys)
        slope = (RRELU_LOWER + RRELU_UPPER) / 2.0

        def pinned_edges(d, own):
            rec_mask = next(queues["abs"]).to(d.device)
            rec_keys, mine = next(keys)
            real = rec_keys >= 0
            mask = own
            if real.any():
                sk, order = torch.sort(rec_keys[real])
                pos = torch.searchsorted(sk, mine).clamp(max=sk.numel() - 1)
                found = (mine >= 0) & (sk[pos] == mine)
                mask = torch.where(found, rec_mask[real][order][pos], own)
            self.flips["abs"] += int((own != mask).sum())
            self.entries["abs"] += mask.numel()
            return mask

        def pinned(kind, x, own):
            mask = next(queues[kind]).to(x.device)
            if shard is not None and mask.shape != x.shape:  # the rank's rows of the entity axis
                axis = next(i for i, (m, n) in enumerate(zip(mask.shape, x.shape))
                            if m == shard.n and n == shard.rows)
                mask = mask.narrow(axis, shard.row0, shard.rows)
            flipped = own != mask
            self.flips[kind] += int(flipped.sum())
            self.entries[kind] += mask.numel()
            if flipped.any():
                self.flip_max[kind] = max(self.flip_max.get(kind, 0.0),
                                          x.detach()[flipped].abs().max().item())
            return mask

        def rep_rrelu(x):
            return torch.where(pinned("rrelu", x, x >= 0), x, x * slope)

        def rep_relu(x):
            return torch.where(pinned("relu", x, x > 0), x, torch.zeros_like(x))

        def rep_leaky(x, negative_slope):
            return torch.where(pinned("leaky", x, x >= 0), x, x * negative_slope)

        def rep_abs(a, b):
            d = a - b
            mask = pinned("abs", d, d >= 0) if keys is None else pinned_edges(d, d >= 0)
            flipped = d.detach()[mask != (d >= 0)]
            if flipped.numel():
                self.abs_flip_max = max(self.abs_flip_max, flipped.abs().max().item())
            return torch.where(mask, d, -d)

        with self._patched(rep_rrelu, rep_relu, rep_leaky, rep_abs):
            yield
        check(all(next(q, None) is None for q in queues.values()),
              "the replay passed fewer activations than the recorded run")

    def check(self, tag: str) -> str:
        """Fails if too many activation entries flipped, or a radius sign
        flipped away from a tie; returns a summary."""
        flips = sum(self.flips[k] for k in self.ACTIVATIONS)
        entries = sum(self.entries[k] for k in self.ACTIVATIONS)
        by_kind = ", ".join(f"{k} {self.flips[k]} of {self.entries[k]}"
                            + (f" (|x| <= {self.flip_max[k]:.2e})" if k in self.flip_max else "")
                            for k in self.ACTIVATIONS + ("leaky",) if self.entries[k])
        check(flips <= KINK_FLIP_SHARE * entries, f"{tag}: {flips} of {entries} "
              f"pre-activations took the other branch at a kink on the cpu, over "
              f"{KINK_FLIP_SHARE:.0e} of them ({by_kind})")
        check(self.flip_max.get("leaky", 0.0) <= LEAKY_TIE_TOL, f"{tag}: an attention logit "
              f"took the other branch on the cpu at |x| = {self.flip_max.get('leaky', 0.0):.3e} > "
              f"{LEAKY_TIE_TOL:.0e} ({by_kind})")
        check(self.abs_flip_max <= ABS_TIE_TOL, f"{tag}: r_src - r_dst took the other sign on "
              f"the cpu at |r_src - r_dst| = {self.abs_flip_max:.3e} > {ABS_TIE_TOL:.0e}")
        text = f"{flips + self.flips['leaky']} of {entries + self.entries['leaky']} activation " \
            f"entries ({by_kind})"
        if self.entries["abs"]:
            text += (f", {self.flips['abs']} of {self.entries['abs']} radius-weight signs (at "
                     f"|r_src - r_dst| <= {self.abs_flip_max:.2e})")
        return text + " took the other branch on the cpu's own"


class DwRecorder:
    """Keeps the edge-weight gradient dw of each call of the scatter's
    backward (``rgcn_scatter.scatter_add_sorted_backward``, patched in its
    module), in the order autograd runs them."""

    def __init__(self):
        self.seen = []

    @contextlib.contextmanager
    def recording(self):
        backward = rgcn_scatter.scatter_add_sorted_backward

        def rec(*args, **kw):
            dmsg, dw = backward(*args, **kw)
            if dw is not None:
                self.seen.append(dw.detach())
            return dmsg, dw

        rgcn_scatter.scatter_add_sorted_backward = rec
        try:
            yield
        finally:
            rgcn_scatter.scatter_add_sorted_backward = backward


def three_steps(tag: str, gpu, cpu, s_gpu, s_cpu, order, *loss_args, may_lack=()) -> dict:
    """(a) of the training phases: 3 steps on the card; before each, the
    CPU takes the card's state and both compute the step from it, the CPU
    on the card's branches at the kinks (PinnedKinks): the losses, each
    parameter's gradient, the new BN statistics, B1's edge-weight gradient
    dw where the weight needs one, with EST the H-PES memories after each
    device's writeback from its own step, and the optimizer's update given
    the card's gradients. Printed, not checked: the global norm of the
    card's first gradients as the card, the CPU in fp32 and float64 take
    it (the optimizer accumulates it in float64). Returns, per parameter,
    its gradient's worst error over the steps relative to its largest
    entry, and that largest entry."""
    t0 = time.perf_counter()
    names = leaf_names(s_gpu.params)
    worst_grad = worst_bn = worst_opt = worst_dw = worst_est = 0.0
    by_name = {n: (0.0, 0.0) for n in names}
    n_dw = 0
    kinks = PinnedKinks()
    for step, i in enumerate(order):
        copy_state_into(s_cpu, s_gpu)
        out = []
        for tr, st, pin in ((gpu, s_gpu, kinks.record), (cpu, s_cpu, kinks.replay)):
            dws = DwRecorder()
            est_args = tr.est_window(i) if st.est_state is not None else ()
            with pin(), dws.recording():
                total, parts, new_bn, *aux = tr.loss(st, *tr.window(i), *loss_args, *est_args)
                grads = torch.autograd.grad(total, tree_leaves(st.params), allow_unused=True)
            if st.est_state is not None:
                tr.est_update(st, *tr.window(i)[1:], aux[0])
            out.append(({k: float(v.detach()) for k, v in parts.items()}, grads, new_bn,
                        dws.seen))
        (l_gpu, g_gpu, bn_gpu, dw_gpu), (l_cpu, g_cpu, bn_cpu, dw_cpu) = out
        if step == 0:
            some = [g for g in g_gpu if g is not None]
            norms = (torch.linalg.vector_norm(torch.stack(torch._foreach_norm(some))),
                     torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
                         [g.cpu() for g in some]))),
                     torch.linalg.vector_norm(torch.stack([g.cpu().double().norm() for g in some])))
            print(f"[{tag}] global norm of the first step's gradients: card fp32 "
                  f"{norms[0].item():.7f}, cpu fp32 {norms[1].item():.7f}, float64 "
                  f"{norms[2].item():.7f}", flush=True)
        for k, b in l_cpu.items():
            a = l_gpu[k]
            check(math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * max(1.0, abs(b)),
                  f"{tag}, step on snapshot {i}: {k} loss cuda {a} vs cpu {b}")
        for name, a, b in zip(names, g_gpu, g_cpu):
            if name in NO_GRAD:
                check(a is None and b is None, f"{tag}: {name} got a gradient")
                continue
            if name in may_lack and a is None and b is None:
                continue
            check(a is not None and b is not None, f"{tag}, step on snapshot {i}: {name} has "
                  "no gradient")
            err = rel_err(a, b)
            check(err <= TRAIN_GRAD_TOL, f"{tag}, step on snapshot {i}: {name} gradient cuda "
                  f"vs cpu {err:.3e} > {TRAIN_GRAD_TOL:.0e} of its largest entry")
            worst_grad = max(worst_grad, err)
            by_name[name] = (max(by_name[name][0], err),
                             max(by_name[name][1], b.abs().max().item()))
        check(len(dw_gpu) == len(dw_cpu), f"{tag}, step on snapshot {i}: {len(dw_gpu)} dw on "
              f"the card, {len(dw_cpu)} on the cpu")
        for a, b in zip(dw_gpu, dw_cpu):
            err = rel_err(a, b)
            check(err <= TRAIN_GRAD_TOL, f"{tag}, step on snapshot {i}: B1's dw cuda vs cpu "
                  f"{err:.3e} > {TRAIN_GRAD_TOL:.0e} of its largest entry")
            worst_dw = max(worst_dw, err)
        n_dw += len(dw_gpu)
        for a, b in zip(model_state_leaves(bn_gpu), model_state_leaves(bn_cpu)):
            worst_bn = max(worst_bn, rel_err(a, b))
        check(worst_bn <= TRAIN_GRAD_TOL, f"{tag}, step on snapshot {i}: BN running "
              f"statistics cuda vs cpu {worst_bn:.3e} > {TRAIN_GRAD_TOL:.0e}")
        if s_gpu.est_state is not None:
            for memory in ("fast", "slow"):
                err = rel_err(getattr(s_gpu.est_state, memory), getattr(s_cpu.est_state, memory))
                check(err <= TRAIN_GRAD_TOL, f"{tag}, step on snapshot {i}: the H-PES {memory} "
                      f"memory after the writeback cuda vs cpu {err:.3e} > {TRAIN_GRAD_TOL:.0e}")
                worst_est = max(worst_est, err)
        gpu.opt.step(tree_leaves(s_gpu.params), g_gpu, s_gpu.opt_state)
        cpu.opt.step(tree_leaves(s_cpu.params), [None if g is None else g.cpu() for g in g_gpu],
                     s_cpu.opt_state)
        for name, a, b in zip(names, tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)):
            err = ((a.detach().cpu() - b.detach()).abs() / b.detach().abs().clamp(min=1.0)).max()
            check(err.item() <= TRAIN_OPT_TOL, f"{tag}, step on snapshot {i}: {name} after "
                  f"the optimizer step cuda vs cpu {err.item():.3e} > {TRAIN_OPT_TOL:.0e}")
            worst_opt = max(worst_opt, err.item())
        s_gpu.model_state, s_cpu.model_state = bn_gpu, bn_cpu
        s_gpu.step += 1
        s_cpu.step += 1
        print(f"[{tag}] step on snapshot {i}: losses cuda/cpu "
              + ", ".join(f"{k} {l_gpu[k]:.6f}/{l_cpu[k]:.6f}" for k in l_gpu), flush=True)
    flips = kinks.check(tag)
    dw_text = f", B1's dw in {n_dw} backward calls within {worst_dw:.2e}" if n_dw else ""
    est_text = ("" if s_gpu.est_state is None else
                f", the H-PES memories after each writeback within {worst_est:.2e}")
    print(f"[{tag}] (a) 3 steps cuda vs cpu from the same state, the cpu on the card's branches "
          f"at the kinks ({flips}): every gradient within {worst_grad:.2e} of its parameter's "
          f"largest entry{dw_text}, BN statistics within {worst_bn:.2e}{est_text}, every "
          f"parameter after the optimizer step within {worst_opt:.2e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return by_name


def config1_three_steps(data, cfg: ModelConfig, tc: TrainConfig, dev: torch.device) -> None:
    """(a) config 1's 3 steps, cuda against cpu (``three_steps``)."""
    exp = ExperimentConfig(model=dataclasses.replace(cfg, **NO_DROPOUT), train=tc)
    gpu = loop.Trainer(exp, data, device=dev)
    cpu = loop.Trainer(exp, data, device="cpu")
    s_gpu = gpu.init_state(SEED)
    s_cpu = train_state.state_from(s_gpu.params, s_gpu.model_state, tc, SEED, "cpu")
    three_steps("train1", gpu, cpu, s_gpu, s_cpu, gpu.epoch_order(0)[:3])


def checkpoint_round_trip(trainer, state, exp: ExperimentConfig, data, dev) -> None:
    """(e) The state saved after the epoch, restored into a fresh trainer:
    every part equal; then one step from each copy, with the dropouts
    drawn from the restored generator, in deterministic mode (the
    relation context's index_add_ has float atomics otherwise)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as path:
        train_state.save_checkpoint(path, state, {"epoch": 0})
        mib = os.path.getsize(os.path.join(path, train_state.STATE_FILE)) / 2**20
        fresh = loop.Trainer(exp, data, device=dev)
        restored, meta = train_state.restore_checkpoint(path, fresh.init_state(SEED + 7))
    check(meta == {"epoch": 0}, f"checkpoint meta {meta}")
    same = all(torch.equal(a.detach(), b.detach())
               for a, b in zip(state_leaves(state), state_leaves(restored)))
    check(same and torch.equal(state.gen.get_state(), restored.gen.get_state())
          and (state.step, state.opt_state.count) == (restored.step, restored.opt_state.count),
          "the restored state differs from the saved one")
    i = trainer.epoch_order(1)[0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # cuBLAS: deterministic without a workspace setting
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.train_step(state, *trainer.window(i))
            fresh.train_step(restored, *fresh.window(i))
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    worst = 0.0
    for name, a, b in zip(leaf_names(state.params), tree_leaves(restored.params),
                          tree_leaves(state.params)):
        err = ((a.detach() - b.detach()).abs() / b.detach().abs().clamp(min=1.0)).max().item()
        check(err <= TRAIN_OPT_TOL, f"checkpoint round trip: {name} after one step from each "
              f"copy differs by {err:.3e} > {TRAIN_OPT_TOL:.0e}")
        worst = max(worst, err)
    print(f"[train1] (e) checkpoint round trip: {mib:.1f} MiB state.pt, every tensor, the "
          f"generator, step {state.step - 1} restored exactly; one step from each copy: every "
          f"parameter within {worst:.2e} ({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_config1_training(data, cfg: ModelConfig, tc: TrainConfig, dev: torch.device,
                           random_init_mrr: float) -> dict:
    config1_three_steps(data, cfg, tc, dev)

    # (b) one full epoch with the config's dropouts, through the kernels
    exp = ExperimentConfig(model=cfg, train=tc)
    trainer = loop.Trainer(exp, data, device=dev)
    state = trainer.init_state(SEED)
    order = trainer.epoch_order(0)
    expected = cfg.n_layers * sum(min(i, tc.train_history_len) for i in order)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.run_epoch(state, 0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = read_launches()
    check(all(math.isfinite(v) for v in losses.values()), f"config-1 epoch losses {losses}")
    check(all(launches[k] == 0 for k in CE_KERNELS), f"config-1 training launched a CE kernel: "
          f"{launches}")
    check(launches["rgcn_scatter_sorted"] == expected,
          f"scatter kernel launched {launches['rgcn_scatter_sorted']} times in the config-1 "
          f"epoch, expected {expected} = {cfg.n_layers} layers x the snapshots of the "
          f"{len(order)} windows")
    print(f"[train1] (b) epoch 0: {len(order)} steps in {epoch_s:.2f} s = "
          f"{len(order) / epoch_s:.2f} snapshots/s (first epoch: includes building the "
          f"{len(order)} windows); mean losses "
          + ", ".join(f"{k} {v:.5f}" for k, v in losses.items()) + f"; launches {launches} "
          f"({launches['rgcn_scatter_sorted'] / len(order):.2f} B1 launches per step)",
          flush=True)

    # (c) steady state: the next epoch's first steps, windows built; the
    # state is copied so the checkpoint below holds the epoch's end
    steady = train_state.copy_state(state)
    order = trainer.epoch_order(1)[:PROFILE_STEPS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in order:
        trainer.train_step(steady, *trainer.window(i))
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    STEADY["config-1 train step"] = steady_s / len(order) * 1e3
    print(f"[train1] (c) steady state: {len(order)} steps in {steady_s:.3f} s = "
          f"{len(order) / steady_s:.2f} snapshots/s, {steady_s / len(order) * 1e3:.2f} ms "
          "per step", flush=True)

    # (d) the test split after the epoch
    t0 = time.perf_counter()
    stats = trainer.test(state)
    for key, st in stats.items():
        check(math.isfinite(st.mrr) and 0.0 < st.mrr <= 1.0, f"{key} MRR {st.mrr} not in (0, 1]")
    check(stats["ent_raw"].mrr > random_init_mrr, f"entity raw MRR {stats['ent_raw'].mrr:.6f} "
          f"after an epoch is not above the random-init {random_init_mrr:.6f}")
    print(f"[train1] (d) test split after one epoch ({time.perf_counter() - t0:.1f} s): MRR "
          + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items())
          + f" (random init: ent_raw {random_init_mrr:.6f})", flush=True)

    checkpoint_round_trip(trainer, state, exp, data, dev)

    # (f) where a step's time goes
    train_profile("config-1 train step", lambda i: trainer.train_step(steady, *trainer.window(i)),
                  trainer.epoch_order(2)[:PROFILED_STEPS], scatter=True)
    return launches


# ------------------------------------------------- hyperbolic headline

def headline_config(data, **kw) -> HyperbolicConfig:
    """The hyperbolic headline at full width: the reference's logged
    configuration, ``bench.py:bench_hyperbolic``'s and the CLI's hyperbolic
    default (uvrgcn + tangent ConvTransE/R, h=200, 2 layers, c=0.01 fixed,
    dropouts 0.2, residual radius evolution, radius supervision, layer
    norm), in fp32."""
    return HyperbolicConfig(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=200,
                            n_layers=2, encoder="hyperbolic_uvrgcn",
                            decoder="hyperbolic_convtranse", c=0.01, **kw)


def counted_test(trainer, state, expected: int, label: str) -> tuple:
    """The test split with the launch counts reset just before and read
    just after: (stats, launches, seconds); B1 exactly ``expected`` times,
    no B2 kernel."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = trainer.test(state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    for key, st in stats.items():
        check(math.isfinite(st.mrr) and 0.0 < st.mrr <= 1.0, f"{label}: {key} MRR {st.mrr} not "
              "in (0, 1]")
    check(launches["rgcn_scatter_sorted"] == expected and
          all(launches[k] == 0 for k in CE_KERNELS),
          f"{label}: launches {launches}, expected {expected} of the scatter kernel and no CE "
          "kernel")
    return stats, launches, seconds


def one_epoch(trainer) -> dict:
    """``fit``'s keyword for one epoch: the hyperbolic trainer takes
    ``n_epochs``; RE-GCN's and HisRES's trainers run their config's, which
    the phases set to 1."""
    return {"n_epochs": 1} if isinstance(trainer, HyperbolicTrainer) else {}


def fit_one_counted_epoch(trainer, state, **fit_kw) -> tuple:
    """``trainer.fit(state, **fit_kw)`` for one epoch with the launch counts
    reset just before its ``run_epoch`` and read just after: (fit's info,
    {"seconds", "launches"} of the epoch)."""
    epoch = {}
    run_epoch = trainer.run_epoch

    def counted_epoch(st, e):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epoch(st, e)
        torch.cuda.synchronize()
        epoch.update(seconds=time.perf_counter() - t0, launches=read_launches())
        return out

    trainer.run_epoch = counted_epoch
    try:
        _, info = trainer.fit(state=state, **one_epoch(trainer), **fit_kw)
    finally:
        trainer.run_epoch = run_epoch
    return info, epoch


def phase_headline_training(data, tc: TrainConfig, dev: torch.device, config=None,
                            tag: str = "headline") -> dict:
    """The hyperbolic headline through ``HyperbolicTrainer`` (or, with
    ``config`` and ``tag``, another configuration on its encoder and
    decoders, config 5 with EST): (a) 3 steps cuda vs cpu
    (``three_steps``, dropouts 0), B1's dw and the H-PES memories among the
    checks; (b) one epoch through ``fit(checkpoint_path)``, the launch
    counts reset just before ``run_epoch`` and read just after (B1: 2
    layers x the window's snapshots per step); (c) the checkpoint restored
    by ``fit(resume=True)`` in a fresh trainer, every part equal, one step
    from each copy; (d) 20 steady steps; (e) the test split at random init
    and after the epoch (B1 6 times per snapshot), the entity raw MRR above
    the random-init one; (f) a profile of a step, B1's forward and the
    scatter backward apart."""
    config = config or headline_config
    gpu = HyperbolicTrainer(config(data, **NO_DROPOUT), tc, data, device=dev)
    cpu = HyperbolicTrainer(config(data, **NO_DROPOUT), tc, data, device="cpu")
    s_gpu = gpu.init_state(SEED)
    s_cpu = cpu.state_from(s_gpu.params, s_gpu.model_state)
    three_steps(tag, gpu, cpu, s_gpu, s_cpu, gpu.epoch_order(0)[:3], gpu._curvature_max(0))
    del gpu, cpu, s_gpu, s_cpu

    cfg = config(data)
    trainer = HyperbolicTrainer(cfg, tc, data, device=dev)
    state = trainer.init_state(SEED)
    n_test = len(trainer.test_list)
    test_launches = cfg.n_layers * tc.test_history_len * n_test
    init_stats, _, init_s = counted_test(trainer, state, test_launches, f"{tag} at init")
    print(f"[{tag}] test split at random init ({init_s:.1f} s): MRR "
          + ", ".join(f"{k} {v.mrr:.6f}" for k, v in init_stats.items()), flush=True)

    # (b) the epoch, inside fit with a checkpoint
    order = trainer.epoch_order(0)
    expected = cfg.n_layers * sum(min(i, tc.train_history_len) for i in order)
    with tempfile.TemporaryDirectory() as path:
        info, epoch = fit_one_counted_epoch(trainer, state, checkpoint_path=path)
        launches, row = epoch["launches"], info["history"][0]
        check(all(math.isfinite(v) for v in row["losses"].values()),
              f"{tag} epoch losses {row['losses']}")
        check(all(launches[k] == 0 for k in CE_KERNELS), f"{tag} launched a CE kernel: "
              f"{launches}")
        check(launches["rgcn_scatter_sorted"] == expected,
              f"scatter kernel launched {launches['rgcn_scatter_sorted']} times in the {tag} "
              f"epoch, expected {expected} = {cfg.n_layers} layers x the snapshots of the "
              f"{len(order)} windows")
        print(f"[{tag}] (b) epoch 0 in fit: {len(order)} steps in {epoch['seconds']:.2f} s = "
              f"{len(order) / epoch['seconds']:.2f} snapshots/s (first epoch: includes building "
              f"the {len(order)} windows); mean losses "
              + ", ".join(f"{k} {v:.5f}" for k, v in row["losses"].items())
              + f"; valid ent raw MRR {row['valid_mrr_raw']:.6f}; launches {launches} "
              f"({launches['rgcn_scatter_sorted'] / len(order):.2f} B1 launches per step)",
              flush=True)
        cmax = trainer._curvature_max(1)
        headline_resume(trainer, HyperbolicTrainer(cfg, tc, data, device=dev), state, info,
                        path, tag, lambda tr, st, i: tr.train_step(st, *tr.window(i), cmax,
                                                                   *tr.est_window(i)))

    # (d) steady state on a copy: the next epoch's first steps, windows built
    steady = train_state.copy_state(state)
    cmax = trainer._curvature_max(1)
    order = trainer.epoch_order(1)[:PROFILE_STEPS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in order:
        trainer.train_step(steady, *trainer.window(i), cmax, *trainer.est_window(i))
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    STEADY[f"{tag} train step"] = steady_s / len(order) * 1e3
    print(f"[{tag}] (d) steady state: {len(order)} steps in {steady_s:.3f} s = "
          f"{len(order) / steady_s:.2f} snapshots/s, {steady_s / len(order) * 1e3:.2f} ms "
          "per step", flush=True)

    # (e) the test split after the epoch
    stats, test_counts, test_s = counted_test(trainer, state, test_launches, tag)
    check(stats["ent_raw"].mrr > init_stats["ent_raw"].mrr,
          f"{tag} entity raw MRR {stats['ent_raw'].mrr:.6f} after an epoch is not above the "
          f"random-init {init_stats['ent_raw'].mrr:.6f}")
    print(f"[{tag}] (e) test split after one epoch ({test_s:.1f} s, "
          f"{test_s / n_test * 1e3:.2f} ms per snapshot, {test_counts['rgcn_scatter_sorted']} B1 "
          "launches): MRR " + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items())
          + f" (random init: ent_raw {init_stats['ent_raw'].mrr:.6f})", flush=True)
    EPOCHS[tag] = dict(losses=row["losses"], test=stats)

    # (f) where a step's time goes
    cmax = trainer._curvature_max(2)
    train_profile(f"{tag} train step",
                  lambda i: trainer.train_step(steady, *trainer.window(i), cmax,
                                               *trainer.est_window(i)),
                  trainer.epoch_order(2)[:PROFILED_STEPS], scatter=True)
    return {f"{tag} training epoch": launches, f"{tag} test split": test_counts}


def headline_resume(trainer, fresh, state, info, path: str, tag: str, step) -> None:
    """(c) ``fit(resume=True)`` for one epoch in ``fresh``, a new trainer of
    the same configuration, restores the checkpoint of the epoch
    (``<path>/last``) and runs no epoch: every tensor, the generator and the
    step equal the trained state's, on the card; then one step from each
    copy (``step(trainer, state, i)``), in deterministic mode (the relation
    context's index_add_ has float atomics otherwise)."""
    t0 = time.perf_counter()
    mib = os.path.getsize(os.path.join(path, "last", train_state.STATE_FILE)) / 2**20
    restored, info2 = fresh.fit(state=fresh.init_state(SEED + 7), **one_epoch(fresh),
                                checkpoint_path=path, resume=True)
    check(info2["history"] == [] and info2["best_valid_mrr_raw"] == info["best_valid_mrr_raw"],
          f"resume ran an epoch or lost the best MRR: {info2}")
    same = all(torch.equal(a.detach(), b.detach())
               for a, b in zip(state_leaves(state), state_leaves(restored)))
    radius = [getattr(st.model_state, "radius_target", None) for st in (state, restored)]
    check(same and torch.equal(state.gen.get_state(), restored.gen.get_state())
          and (state.step, state.opt_state.count) == (restored.step, restored.opt_state.count)
          and (radius[0] is None or torch.equal(*radius)),
          "the restored state differs from the trained one")
    check(all(t.device.type == "cuda" for t in state_leaves(restored)),
          "the restored state is not on the card")
    i = trainer.epoch_order(1)[0]
    stepped = train_state.copy_state(state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # cuBLAS: deterministic without a workspace setting
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(trainer, stepped, i)
            step(fresh, restored, i)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    worst = 0.0
    for name, a, b in zip(leaf_names(state.params), tree_leaves(restored.params),
                          tree_leaves(stepped.params)):
        err = ((a.detach() - b.detach()).abs() / b.detach().abs().clamp(min=1.0)).max().item()
        check(err <= TRAIN_OPT_TOL, f"{tag} checkpoint round trip: {name} after one step "
              f"from each copy differs by {err:.3e} > {TRAIN_OPT_TOL:.0e}")
        worst = max(worst, err)
    if state.est_state is not None:
        for memory in ("fast", "slow"):
            a, b = getattr(restored.est_state, memory), getattr(stepped.est_state, memory)
            err = ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()
            check(err <= TRAIN_OPT_TOL, f"{tag} checkpoint round trip: the H-PES {memory} "
                  f"memory after one step from each copy differs by {err:.3e}")
            worst = max(worst, err)
    print(f"[{tag}] (c) checkpoint round trip through fit(checkpoint_path) and "
          f"fit(resume=True): {mib:.1f} MiB last/state.pt, every tensor, the generator, step "
          f"{state.step} restored exactly on the card; one step from each copy: every "
          f"parameter{' and H-PES memory' if state.est_state is not None else ''} within "
          f"{worst:.2e} ({time.perf_counter() - t0:.1f} s)", flush=True)


# ------------------------------------------------------- config-5 training

def config5(data, **kw) -> HyperbolicConfig:
    """BASELINE.json config 5 at full width, as ``tools/bench_configs.py``
    runs it: the headline (uvrgcn + tangent ConvTransE/R, h=200, 2 layers,
    history 3, c=0.01 fixed) with EST (H-PES memories with alpha 0.2, ETNR
    retrieval of K = 32 events, the QCHHE GRU) and TANS negatives, the
    CLI's defaults otherwise (dropouts 0.2), in fp32."""
    return headline_config(data, use_est=True, est_encoder="gru", est_history_len=32,
                           est_state_alpha=0.2, use_time_aware_negative=True, **kw)


def gdelt_data():
    """synthetic-gdelt (GDELT's 7691 entities, 240 relations and 700
    triples a snapshot) with its time axis cut to 100 snapshots split
    80 / 10 / 10: an epoch of 79 steps."""
    return generate("synthetic-gdelt", seed=SEED, num_snaps=100, split=(80, 10, 10))


# ------------------------------------------------------- config-4 training

B2_LEAVES = {"log_c": "log_c (every map of the model, and B2's dc where a relation's clamp "
                      "binds at 0.999 c)",
             "decoder_ob.rel_curvature_raw": "rel_curvature_raw (B2's dc)",
             "decoder_ob.entity_bias": "entity_bias (B2's dbias)"}


def config4(data, **kw) -> HyperbolicConfig:
    """BASELINE.json config 4 at full width, as ``tools/bench_configs.py``
    runs it: uvrgcn + AttH / AttH-Rel (h=200, 2 layers, history 3), c=0.01
    learned with no warmup, a curvature per relation, an entity bias, and
    the CLI's defaults otherwise (dropouts 0.2, residual radius evolution,
    radius supervision, layer norm), in fp32."""
    return HyperbolicConfig(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=200,
                            n_layers=2, encoder="hyperbolic_uvrgcn", decoder="atth", c=0.01,
                            learn_curvature=True, use_rel_curvature=True, use_entity_bias=True,
                            **kw)


def phase_config4_training(data, tc: TrainConfig, dev: torch.device) -> tuple:
    """Config 4 through ``HyperbolicTrainer``: (a) 3 steps cuda vs cpu
    (``three_steps``, dropouts 0), the gradients that B2's dc and dbias
    feed printed apart; B2's three kernels timed at config 4's entity shape
    on the true distance with per-query curvature; (b) one epoch through
    ``fit``, the launch counts reset just before ``run_epoch`` and read
    just after (B1: 2 layers x the window's snapshots per step; each B2
    kernel twice per step, entity and relation loss); (c) 20 steady steps;
    (d) the test split at random init and after the epoch (B1 6 times per
    snapshot, no B2: eval scores are the plain distance logits), the
    entity raw MRR above the random-init one; (e) a profile of a step, B1's
    forward, the scatter backward and the three B2 kernels apart. Returns
    ({path: launches}, B2's times at the config-4 entity shape)."""
    gpu = HyperbolicTrainer(config4(data, **NO_DROPOUT), tc, data, device=dev)
    cpu = HyperbolicTrainer(config4(data, **NO_DROPOUT), tc, data, device="cpu")
    s_gpu = gpu.init_state(SEED)
    s_cpu = cpu.state_from(s_gpu.params, s_gpu.model_state)
    worst = three_steps("config4", gpu, cpu, s_gpu, s_cpu, gpu.epoch_order(0)[:3],
                        gpu._curvature_max(0))
    for name, what in B2_LEAVES.items():
        err, largest = worst[name]
        check(largest > 0, f"config 4: {name} got no gradient in the 3 steps")
        print(f"[config4] (a) gradient of {what}: cuda vs cpu within {err:.3e} of its largest "
              f"entry {largest:.6e}", flush=True)
    del gpu, cpu, s_gpu, s_cpu

    cfg = config4(data)
    trainer = HyperbolicTrainer(cfg, tc, data, device=dev)
    state = trainer.init_state(SEED)
    N, d = cfg.num_ents, cfg.h_dim
    order = trainer.epoch_order(0)
    batches = sorted({trainer.window(i)[1].shape[0] for i in order})
    B = 512
    label = f"config-4 entity B={B} N={N} d={d} true distance, per-query c"
    times = ce_times(ce_case(B, N, d, dev, true=True, per_query_c=True, c_low=REL_C_EPS))
    for name, row in times.items():
        row["shape"] = label
        print(f"[config4] {name} at the {label} in [{REL_C_EPS:g}, 0.999 c]: kernel "
              f"{row['ms'] * 1e3:.2f} us, "
              f"plain {row['plain_ms'] * 1e3:.2f} us, matmul {row['library_ms'] * 1e3:.2f} us, "
              f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']})", flush=True)

    n_test = len(trainer.test_list)
    test_launches = cfg.n_layers * tc.test_history_len * n_test
    init_stats, _, init_s = counted_test(trainer, state, test_launches, "config 4 at init")
    print(f"[config4] test split at random init ({init_s:.1f} s): MRR "
          + ", ".join(f"{k} {v.mrr:.6f}" for k, v in init_stats.items()), flush=True)

    # (b) the epoch, inside fit
    expected = cfg.n_layers * sum(min(i, tc.train_history_len) for i in order)
    info, epoch = fit_one_counted_epoch(trainer, state)
    launches, row = epoch["launches"], info["history"][0]
    check(all(math.isfinite(v) for v in row["losses"].values()),
          f"config-4 epoch losses {row['losses']}")
    check(launches["rgcn_scatter_sorted"] == expected,
          f"scatter kernel launched {launches['rgcn_scatter_sorted']} times in the config-4 "
          f"epoch, expected {expected} = {cfg.n_layers} layers x the snapshots of the "
          f"{len(order)} windows")
    for k in CE_KERNELS:
        check(launches[k] == 2 * len(order), f"{k} launched {launches[k]} times in the config-4 "
              f"epoch of {len(order)} steps, expected {2 * len(order)} (entity + relation loss "
              "per step)")
    print(f"[config4] (b) epoch 0 in fit: {len(order)} steps in {epoch['seconds']:.2f} s = "
          f"{len(order) / epoch['seconds']:.2f} snapshots/s (first epoch: includes building "
          f"the {len(order)} windows; padded triple batches {batches}); mean losses "
          + ", ".join(f"{k} {v:.5f}" for k, v in row["losses"].items())
          + f"; valid ent raw MRR {row['valid_mrr_raw']:.6f}; launches {launches}", flush=True)

    # (c) steady state on a copy: the next epoch's first steps, windows built
    steady = train_state.copy_state(state)
    cmax = trainer._curvature_max(1)
    steady_order = trainer.epoch_order(1)[:PROFILE_STEPS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in steady_order:
        trainer.train_step(steady, *trainer.window(i), cmax)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    print(f"[config4] (c) steady state: {len(steady_order)} steps in {steady_s:.3f} s = "
          f"{len(steady_order) / steady_s:.2f} snapshots/s, "
          f"{steady_s / len(steady_order) * 1e3:.2f} ms per step", flush=True)

    # (d) the test split after the epoch
    stats, test_counts, test_s = counted_test(trainer, state, test_launches, "config 4")
    check(stats["ent_raw"].mrr > init_stats["ent_raw"].mrr,
          f"config-4 entity raw MRR {stats['ent_raw'].mrr:.6f} after an epoch is not above the "
          f"random-init {init_stats['ent_raw'].mrr:.6f}")
    print(f"[config4] (d) test split after one epoch ({test_s:.1f} s, "
          f"{test_s / n_test * 1e3:.2f} ms per snapshot, {test_counts['rgcn_scatter_sorted']} B1 "
          "launches, no B2): MRR " + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items())
          + f" (random init: ent_raw {init_stats['ent_raw'].mrr:.6f})", flush=True)

    # (e) where a step's time goes
    cmax = trainer._curvature_max(2)
    train_profile("config-4 train step",
                  lambda i: trainer.train_step(steady, *trainer.window(i), cmax),
                  trainer.epoch_order(2)[:PROFILED_STEPS], scatter=True, ce=True)
    return {"config-4 training epoch": launches, "config-4 test split": test_counts}, times


# ------------------------------------------------------- config-2 training

def icews18_data():
    """synthetic-icews18 (ICEWS18's 23033 entities, 256 relations and 1200
    triples a snapshot) with its static entity-word graph (3 links from
    each entity, inverse edges added) and its time axis cut to 120
    snapshots split 100 / 10 / 10: the epochs of config 2 and the static
    headline are 99 steps."""
    return generate("synthetic-icews18", seed=SEED, with_static=True, num_snaps=120,
                    split=(100, 10, 10))


def config2(data, **kw) -> ModelConfig:
    """BASELINE.json config 2 at full width, as ``tools/bench_configs.py``
    runs it: RE-GCN (h=200, 2 UnionRGCN layers, history 3, ConvTransE/R)
    with the static graph's constraint (n_bases 100, static weight 0.5,
    angle 10, discount 1), the defaults otherwise (dropouts 0.2, layer
    norm), in fp32."""
    return ModelConfig(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=200, n_layers=2,
                       use_static=True, num_static_rels=data.num_static_rels,
                       num_words=data.num_words, **kw)


def static_layer_profile(tag: str, params, cfg, snap, step_busy_us: float) -> None:
    """The static layer alone (``_static_init``: the block weights' gather,
    the block product, the index_add_ over destinations, rrelu and the
    L2 norm, then its backward into ``words_emb``, ``dynamic_emb`` and the
    block weights) under torch.profiler: its kernels, and its device time
    against a training step's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    leaves = [params["dynamic_emb"], params["words_emb"], params["static_rgcn"]["weight"]]

    def fwd_bwd():
        out = recurrent._static_init(params, cfg, snap)
        torch.autograd.grad(out.sum(), leaves)

    fwd_bwd()
    torch.cuda.synchronize()
    reps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fwd_bwd()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels) / reps
    print(f"[{tag}] (f) the static layer alone ({int(snap.edge_mask.sum())} edges over "
          f"{snap.in_deg_norm.shape[0]} nodes, forward and backward): {busy_us:.1f} us of device "
          f"time, {100 * busy_us / step_busy_us:.1f} % of a training step's busy "
          f"{step_busy_us:.1f} us", flush=True)
    for e in kernels[:8]:
        print(f"[{tag}]   {e.self_device_time_total / reps:9.1f} us {e.count / reps:4.0f}x  "
              f"{e.key[:90]}", flush=True)


def phase_config2_training(data, dev: torch.device) -> dict:
    """BASELINE config 2 through ``loop.Trainer``: (a) 3 steps cuda vs cpu
    (``three_steps``, dropouts 0), the static loss among the losses and
    the gradients of ``words_emb`` and ``static_rgcn.weight`` printed
    apart, the cpu on the card's branches at every rrelu, the static
    layer's included; (b) one epoch through ``fit(checkpoint_path)``, the
    launch counts reset just before ``run_epoch`` and read just after (B1:
    2 layers x the window's snapshots per step, 1428 at this data; no B2);
    (c) ``fit(resume=True)`` in a fresh trainer restores it exactly; (d) 20
    steady steps and their peak memory; (e) the test split at random init
    and after the epoch (B1 6 times per snapshot, 204), the entity raw MRR
    above the random-init one; (f) a profile of a step, B1's forward and
    the scatter backward apart, and the static layer profiled alone."""
    tag = "config2"
    tc = TrainConfig(train_history_len=3, test_history_len=3, edge_bucket=128, rc_bucket=128,
                     triple_bucket=128, n_epochs=1)
    exp = ExperimentConfig(model=config2(data, **NO_DROPOUT), train=tc)
    gpu = loop.Trainer(exp, data, device=dev)
    cpu = loop.Trainer(exp, data, device="cpu")
    s_gpu = gpu.init_state(SEED)
    s_cpu = train_state.state_from(s_gpu.params, s_gpu.model_state, tc, SEED, "cpu")
    worst = three_steps(tag, gpu, cpu, s_gpu, s_cpu, gpu.epoch_order(0)[:3])
    # dynamic_emb feeds only the words' rows of the static layer, which the
    # model drops, so its gradient is 0 here, as in JAX and the reference
    for name in ("words_emb", "static_rgcn.weight"):
        err, largest = worst[name]
        check(largest > 0, f"{tag}: {name} got no gradient in the 3 steps")
        print(f"[{tag}] (a) gradient of {name}: cuda vs cpu within {err:.3e} of its largest "
              f"entry {largest:.6e}", flush=True)
    print(f"[{tag}] static graph: {gpu.static_snap.num_edges} edges (inverses included) over "
          f"{data.num_nodes} entities and {data.num_words} words, "
          f"{2 * data.num_static_rels} relation ids", flush=True)
    del gpu, cpu, s_gpu, s_cpu

    exp = ExperimentConfig(model=config2(data), train=tc)
    cfg = exp.model
    trainer = loop.Trainer(exp, data, device=dev)
    state = trainer.init_state(SEED)
    n_test = len(trainer.test_list)
    test_launches = cfg.n_layers * tc.test_history_len * n_test
    init_stats, _, init_s = counted_test(trainer, state, test_launches, f"{tag} at init")
    print(f"[{tag}] test split at random init ({init_s:.1f} s): MRR "
          + ", ".join(f"{k} {v.mrr:.6f}" for k, v in init_stats.items()), flush=True)

    # (b) the epoch, inside fit with a checkpoint; (c) its resume
    order = trainer.epoch_order(0)
    expected = cfg.n_layers * sum(min(i, tc.train_history_len) for i in order)
    with tempfile.TemporaryDirectory() as path:
        info, epoch = fit_one_counted_epoch(trainer, state, checkpoint_path=path)
        launches, row = epoch["launches"], info["history"][0]
        check(all(math.isfinite(v) for v in row["losses"].values()) and row["losses"]["static"] > 0,
              f"{tag} epoch losses {row['losses']}")
        check(all(launches[k] == 0 for k in CE_KERNELS), f"{tag} launched a CE kernel: {launches}")
        check(launches["rgcn_scatter_sorted"] == expected,
              f"scatter kernel launched {launches['rgcn_scatter_sorted']} times in the {tag} "
              f"epoch, expected {expected} = {cfg.n_layers} layers x the snapshots of the "
              f"{len(order)} windows")
        print(f"[{tag}] (b) epoch 0 in fit: {len(order)} steps in {epoch['seconds']:.2f} s = "
              f"{len(order) / epoch['seconds']:.2f} snapshots/s (first epoch: includes building "
              f"the {len(order)} windows); mean losses "
              + ", ".join(f"{k} {v:.5f}" for k, v in row["losses"].items())
              + f"; valid ent raw MRR {row['valid_mrr_raw']:.6f}; launches {launches} "
              f"({launches['rgcn_scatter_sorted'] / len(order):.2f} B1 launches per step)",
              flush=True)
        headline_resume(trainer, loop.Trainer(exp, data, device=dev), state, info, path, tag,
                        lambda tr, st, i: tr.train_step(st, *tr.window(i)))

    # (d) steady state on a copy: the next epoch's first steps, windows built
    steady = train_state.copy_state(state)
    steady_order = trainer.epoch_order(1)[:PROFILE_STEPS]
    trainer.window(steady_order[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    t0 = time.perf_counter()
    for i in steady_order:
        trainer.train_step(steady, *trainer.window(i))
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"[{tag}] (d) steady state: {len(steady_order)} steps in {steady_s:.3f} s = "
          f"{len(steady_order) / steady_s:.2f} snapshots/s, "
          f"{steady_s / len(steady_order) * 1e3:.2f} ms per step; peak "
          f"torch.cuda.max_memory_allocated {peak_mib:.1f} MiB ({base_mib:.1f} MiB allocated "
          "before the steps)", flush=True)

    # (e) the test split after the epoch
    stats, test_counts, test_s = counted_test(trainer, state, test_launches, tag)
    check(stats["ent_raw"].mrr > init_stats["ent_raw"].mrr,
          f"{tag} entity raw MRR {stats['ent_raw'].mrr:.6f} after an epoch is not above the "
          f"random-init {init_stats['ent_raw'].mrr:.6f}")
    print(f"[{tag}] (e) test split after one epoch ({test_s:.1f} s, "
          f"{test_s / n_test * 1e3:.2f} ms per snapshot, {test_counts['rgcn_scatter_sorted']} B1 "
          "launches): MRR " + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items())
          + f" (random init: ent_raw {init_stats['ent_raw'].mrr:.6f})", flush=True)

    # (f) where a step's time goes, and the static layer's share of it
    busy = train_profile(f"{tag} train step",
                         lambda i: trainer.train_step(steady, *trainer.window(i)),
                         trainer.epoch_order(2)[:PROFILED_STEPS], scatter=True)
    static_layer_profile(tag, steady.params, cfg, trainer.static_snap, busy)
    return {"config-2 training epoch": launches, "config-2 test split": test_counts}


def phase_static_headline(data, dev: torch.device) -> dict:
    """The hyperbolic headline with the static graph (``--add-static-graph``)
    on config 2's data, through ``HyperbolicTrainer``: (a) 3 steps cuda vs
    cpu (``three_steps``), the static loss among the losses, B1's dw among
    the checks; (b) one epoch through ``fit`` (B1 1428, no B2); (e) the test
    split after it (B1 204)."""
    tag = "static headline"
    tc = TrainConfig(train_history_len=3, test_history_len=3, edge_bucket=128, rc_bucket=128,
                     triple_bucket=128)
    static = dict(use_static=True, num_static_rels=data.num_static_rels,
                  num_words=data.num_words)
    gpu = HyperbolicTrainer(headline_config(data, **static, **NO_DROPOUT), tc, data, device=dev)
    cpu = HyperbolicTrainer(headline_config(data, **static, **NO_DROPOUT), tc, data,
                            device="cpu")
    s_gpu = gpu.init_state(SEED)
    s_cpu = cpu.state_from(s_gpu.params, s_gpu.model_state)
    worst = three_steps(tag, gpu, cpu, s_gpu, s_cpu, gpu.epoch_order(0)[:3],
                        gpu._curvature_max(0))
    for name in ("words_emb", "static_rgcn.weight"):
        check(worst[name][1] > 0, f"{tag}: {name} got no gradient in the 3 steps")
    del gpu, cpu, s_gpu, s_cpu

    cfg = headline_config(data, **static)
    trainer = HyperbolicTrainer(cfg, tc, data, device=dev)
    state = trainer.init_state(SEED)
    order = trainer.epoch_order(0)
    expected = cfg.n_layers * sum(min(i, tc.train_history_len) for i in order)
    info, epoch = fit_one_counted_epoch(trainer, state)
    launches, row = epoch["launches"], info["history"][0]
    check(all(math.isfinite(v) for v in row["losses"].values()) and row["losses"]["static"] > 0,
          f"{tag} epoch losses {row['losses']}")
    check(launches["rgcn_scatter_sorted"] == expected
          and all(launches[k] == 0 for k in CE_KERNELS),
          f"{tag} epoch launches {launches}, expected {expected} of the scatter kernel and no "
          "CE kernel")
    print(f"[{tag}] (b) epoch 0 in fit: {len(order)} steps in {epoch['seconds']:.2f} s = "
          f"{len(order) / epoch['seconds']:.2f} snapshots/s (first epoch: includes building the "
          f"{len(order)} windows); mean losses "
          + ", ".join(f"{k} {v:.5f}" for k, v in row["losses"].items())
          + f"; valid ent raw MRR {row['valid_mrr_raw']:.6f}; launches {launches}", flush=True)
    n_test = len(trainer.test_list)
    stats, test_counts, test_s = counted_test(
        trainer, state, cfg.n_layers * tc.test_history_len * n_test, tag)
    print(f"[{tag}] (e) test split after one epoch ({test_s:.1f} s, "
          f"{test_s / n_test * 1e3:.2f} ms per snapshot, {test_counts['rgcn_scatter_sorted']} B1 "
          "launches): MRR " + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items()),
          flush=True)
    return {"static headline training epoch": launches, "static headline test split": test_counts}


# ----------------------------------------- the rest of the hyperbolic trainer

TRIPLE_BATCH = 256


def chunked_three_steps(tag: str, gpu, cpu, s_gpu, s_cpu, order, cmax) -> None:
    """(a) of phase 13: 3 snapshots' steps with triple batching on the card
    in ``gpu.triple_batch_mode``; the CPU takes the card's state before
    each optimizer step and computes each chunk from it, on the card's
    branches at the kinks: the chunk's losses and gradients (in mode
    ``accumulate`` also their sums over the snapshot); then both devices'
    optimizers step with the card's gradients, and every parameter (the
    entity table retracted on the ball among them) and the Riemannian Adam
    moments of the entity table are compared."""
    t0 = time.perf_counter()
    mode = gpu.triple_batch_mode
    names = leaf_names(s_gpu.params)
    k_ball = names.index("dynamic_emb")
    check(s_gpu.opt_state.manifold[k_ball] and sum(s_gpu.opt_state.manifold) == 1,
          f"{tag}: the optimizer state does not mark the entity table alone for Riemannian Adam")
    kinks = PinnedKinks()
    worst_grad = worst_opt = worst_moment = 0.0
    n_steps = n_chunks = 0

    def opt_steps(grads):
        nonlocal worst_opt, worst_moment, n_steps
        gpu.opt.step(tree_leaves(s_gpu.params), grads, s_gpu.opt_state)
        cpu.opt.step(tree_leaves(s_cpu.params), [None if g is None else g.cpu() for g in grads],
                     s_cpu.opt_state)
        for name, a, b in zip(names, tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)):
            err = ((a.detach().cpu() - b.detach()).abs() / b.detach().abs().clamp(min=1.0)).max()
            check(err.item() <= TRAIN_OPT_TOL, f"{tag} ({mode}), snapshot {i}: {name} after the "
                  f"optimizer step cuda vs cpu {err.item():.3e} > {TRAIN_OPT_TOL:.0e}")
            worst_opt = max(worst_opt, err.item())
        for moment in ("mu", "nu"):
            err = rel_err(getattr(s_gpu.opt_state, moment)[k_ball],
                          getattr(s_cpu.opt_state, moment)[k_ball])
            check(err <= TRAIN_OPT_TOL, f"{tag} ({mode}), snapshot {i}: the entity table's "
                  f"Riemannian {moment} cuda vs cpu {err:.3e} > {TRAIN_OPT_TOL:.0e}")
            worst_moment = max(worst_moment, err)
        radius = torch.linalg.vector_norm(s_gpu.params["dynamic_emb"], dim=-1).max().item()
        check(radius < 1.0 / math.sqrt(gpu.cfg.c), f"{tag}: an entity left the ball ({radius})")
        n_steps += 1

    def compare(a_list, b_list, what):
        nonlocal worst_grad
        for name, a, b in zip(names, a_list, b_list):
            check((a is None) == (b is None), f"{tag}: {name} has a gradient on one device only")
            if a is not None:
                err = rel_err(a, b)
                check(err <= TRAIN_GRAD_TOL, f"{tag} ({mode}), snapshot {i}: {name} {what} cuda "
                      f"vs cpu {err:.3e} > {TRAIN_GRAD_TOL:.0e} of its largest entry")
                worst_grad = max(worst_grad, err)

    for i in order:
        pairs = list(zip(gpu.chunks(i), cpu.chunks(i)))
        check(len(pairs) >= 2, f"{tag}: snapshot {i} is not cut into chunks of {TRIPLE_BATCH}")
        copy_state_into(s_cpu, s_gpu)
        sums = [None, None]
        for c_gpu, c_cpu in pairs:
            if mode == "per_chunk":
                copy_state_into(s_cpu, s_gpu)
            out = []
            for tr, st, chunk, pin in ((gpu, s_gpu, c_gpu, kinks.record),
                                       (cpu, s_cpu, c_cpu, kinks.replay)):
                with pin():
                    total, parts, new_bn, _ = tr.loss(st, tr.window(i)[0], *chunk[:2], cmax,
                                                      *chunk[2:])
                    grads = torch.autograd.grad(total, tree_leaves(st.params), allow_unused=True)
                st.model_state = new_bn
                out.append(({k: float(v.detach()) for k, v in parts.items()}, grads))
            (l_gpu, g_gpu), (l_cpu, g_cpu) = out
            for k, b in l_cpu.items():
                a = l_gpu[k]
                check(math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * max(1.0, abs(b)),
                      f"{tag} ({mode}), snapshot {i}: {k} loss cuda {a} vs cpu {b}")
            compare(g_gpu, g_cpu, "chunk gradient")
            n_chunks += 1
            if mode == "per_chunk":
                opt_steps(g_gpu)
                continue
            sums = [g if s is None else [x if y is None else (y if x is None else x + y)
                                         for x, y in zip(s, g)]
                    for s, g in zip(sums, (g_gpu, g_cpu))]
        if mode == "accumulate":
            compare(sums[0], sums[1], "summed gradient")
            opt_steps(sums[0])
    print(f"[{tag}] (a) {mode}: {len(order)} snapshots in {n_chunks} chunks of "
          f"{TRIPLE_BATCH} rows, {n_steps} optimizer steps, cuda vs cpu from the same state, the "
          f"cpu on the card's branches at the kinks ({kinks.check(tag)}): every chunk's "
          f"gradient{' and each snapshot sum' if mode == 'accumulate' else ''} within "
          f"{worst_grad:.2e} of its parameter's largest entry, every parameter after the "
          f"optimizer step within {worst_opt:.2e}, the entity table's Riemannian moments within "
          f"{worst_moment:.2e} ({time.perf_counter() - t0:.1f} s)", flush=True)


def analysis_records(tag: str, gpu, cpu, s_gpu, s_cpu, *args) -> None:
    """(c) of phase 13: ``analysis_record`` on the card and on the CPU from
    the same state: the default record (the 10 largest gradient norms),
    finite; then with every parameter's norm kept (``gradient_stats`` with
    a ``top_k`` past the parameter count: the 10 largest can swap places at
    a near tie), the same keys on both devices, each within TRAIN_GRAD_TOL
    of max(1, the CPU's value)."""
    module = sys.modules[type(gpu).__module__]
    record = gpu.analysis_record(s_gpu, *args)
    check(all(math.isfinite(v) for v in record.values())
          and sum(k.startswith("[") for k in record) == 10,
          f"{tag}: analysis record {record}")
    stats = module.gradient_stats
    module.gradient_stats = lambda *a, **kw: stats(*a, top_k=10**6, **kw)
    try:
        full = [tr.analysis_record(st, *args) for tr, st in ((gpu, s_gpu), (cpu, s_cpu))]
    finally:
        module.gradient_stats = stats
    check(set(full[0]) == set(full[1]) and all(math.isfinite(v) for v in full[0].values()),
          f"{tag}: the card's analysis record has other keys than the cpu's")
    worst = max(abs(full[0][k] - v) / max(1.0, abs(v)) for k, v in full[1].items())
    check(worst <= TRAIN_GRAD_TOL, f"{tag}: analysis record cuda vs cpu {worst:.3e}")
    print(f"[{tag}] (c) analysis_record: {len(record)} keys, global gradient norm "
          f"{record['global_norm']:.6f}, entity norm {record['entity_norm_mean']:.4f} +- "
          f"{record['entity_norm_std']:.4f}; with all {len(full[0])} keys cuda vs cpu within "
          f"{worst:.2e}", flush=True)


def phase_hyperbolic_options(data, tc: TrainConfig, dev: torch.device,
                             config1: ModelConfig) -> dict:
    """The headline with ``manifold_entities`` (Riemannian Adam on the
    entity table) on synthetic-icews14s: (a) 3 snapshots cuda vs cpu with
    triple batches of 256 rows in each mode (``chunked_three_steps``); (b)
    one epoch in mode ``accumulate``, B1 exactly 2 layers x each window's
    snapshots x its non-empty chunks; (c) the analysis records of
    ``HyperbolicTrainer`` and of config 1's ``Trainer`` on the card and the
    CPU; (d) 3 windows through ``evolve(tangent_fast=False)``, the uvrgcn's
    ball-space layer, cuda vs cpu with the gradients of every parameter,
    B1 2 x the window's snapshots each."""
    tag = "options"
    cfg = headline_config(data, manifold_entities=True, **NO_DROPOUT)
    for mode in ("accumulate", "per_chunk"):
        kw = dict(triple_batch_size=TRIPLE_BATCH, triple_batch_mode=mode)
        gpu = HyperbolicTrainer(cfg, tc, data, device=dev, **kw)
        cpu = HyperbolicTrainer(cfg, tc, data, device="cpu", **kw)
        s_gpu = gpu.init_state(SEED)
        s_cpu = cpu.state_from(s_gpu.params, s_gpu.model_state)
        chunked_three_steps(tag, gpu, cpu, s_gpu, s_cpu, gpu.epoch_order(0)[:3],
                            gpu._curvature_max(0))
    del gpu, cpu, s_gpu, s_cpu

    # (b) an epoch in mode accumulate, with the config's dropouts
    full = headline_config(data, manifold_entities=True)
    trainer = HyperbolicTrainer(full, tc, data, device=dev, triple_batch_size=TRIPLE_BATCH)
    state = trainer.init_state(SEED)
    order = trainer.epoch_order(0)
    chunks = [max(1, len(trainer.chunks(i))) for i in order]
    expected = full.n_layers * sum(min(i, tc.train_history_len) * n
                                   for i, n in zip(order, chunks))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.run_epoch(state, 0)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    epoch_launches = read_launches()
    check(all(math.isfinite(v) for v in losses.values()), f"{tag} epoch losses {losses}")
    check(state.step == len(order), f"{tag}: {state.step} optimizer steps in an accumulate "
          f"epoch of {len(order)} snapshots")
    check(epoch_launches["rgcn_scatter_sorted"] == expected
          and all(epoch_launches[k] == 0 for k in CE_KERNELS),
          f"{tag} epoch launches {epoch_launches}, expected {expected} = {full.n_layers} layers "
          f"x each window's snapshots x its {sum(chunks)} chunks, and no CE kernel")
    print(f"[{tag}] (b) accumulate epoch: {len(order)} snapshots in {sum(chunks)} chunks "
          f"({min(chunks)} to {max(chunks)} a snapshot), {state.step} optimizer steps in "
          f"{epoch_s:.2f} s (first epoch: includes building the windows); mean losses "
          + ", ".join(f"{k} {v:.5f}" for k, v in losses.items())
          + f"; launches {epoch_launches}", flush=True)

    # (c) the analysis records of both trainers
    gpu = HyperbolicTrainer(cfg, tc, data, device=dev, run_analysis=True)
    cpu = HyperbolicTrainer(cfg, tc, data, device="cpu", run_analysis=True)
    s_gpu = gpu.init_state(SEED)
    analysis_records(tag, gpu, cpu, s_gpu, cpu.state_from(s_gpu.params, s_gpu.model_state), 0)
    exp = ExperimentConfig(model=dataclasses.replace(config1, **NO_DROPOUT), train=tc)
    r_gpu = loop.Trainer(exp, data, device=dev, run_analysis=True)
    r_cpu = loop.Trainer(exp, data, device="cpu", run_analysis=True)
    s_gpu = r_gpu.init_state(SEED)
    analysis_records("options, RE-GCN", r_gpu, r_cpu, s_gpu,
                     train_state.state_from(s_gpu.params, s_gpu.model_state, tc, SEED, "cpu"))

    # (d) the ball-space route through B1
    gpu = HyperbolicTrainer(cfg, tc, data, device=dev)
    cpu = HyperbolicTrainer(cfg, tc, data, device="cpu")
    s_gpu = gpu.init_state(SEED)
    s_cpu = cpu.state_from(s_gpu.params, s_gpu.model_state)
    kinks, worst, worst_h, ball_launches = PinnedKinks(), 0.0, 0.0, 0
    probe = torch.randn(data.num_nodes, cfg.h_dim, generator=torch.Generator().manual_seed(SEED))
    for i in gpu.epoch_order(0)[:3]:
        out = []
        for tr, st, pin in ((gpu, s_gpu, kinks.record), (cpu, s_cpu, kinks.replay)):
            history = tr.window(i)[0]
            reset_launches()
            with pin():
                h, h0, _, all_h = hyp_model.evolve(st.params, cfg, history, return_all=True,
                                                   tangent_fast=False)
                if tr is gpu:
                    n = read_launches()["rgcn_scatter_sorted"]
                    want = cfg.n_layers * history.src.shape[0]
                    check(n == want, f"{tag} (d): B1 launched {n} times on the ball-space route "
                          f"of a {history.src.shape[0]}-snapshot window, expected {want}")
                    ball_launches += n
                total = torch.sum(h * probe.to(h.device)) + torch.sum(h0 ** 2)
                grads = torch.autograd.grad(total, tree_leaves(st.params), allow_unused=True)
            out.append((all_h, grads))
        (h_gpu, g_gpu), (h_cpu, g_cpu) = out
        worst_h = max(worst_h, rel_err(h_gpu, h_cpu))
        check(worst_h <= CPU_SCORE_TOL, f"{tag} (d): ball-space points cuda vs cpu {worst_h:.3e}")
        for name, a, b in zip(leaf_names(s_gpu.params), g_gpu, g_cpu):
            check((a is None) == (b is None), f"{tag} (d): {name} has a gradient on one device")
            if a is not None:
                err = rel_err(a, b)
                check(err <= TRAIN_GRAD_TOL, f"{tag} (d): {name} gradient cuda vs cpu {err:.3e}")
                worst = max(worst, err)
    print(f"[{tag}] (d) evolve(tangent_fast=False) on 3 windows, cuda vs cpu on the card's "
          f"branches ({kinks.check(tag)}): every step's ball points within {worst_h:.2e}, every "
          f"gradient within {worst:.2e}; {ball_launches} B1 launches", flush=True)
    return {"options accumulate epoch": epoch_launches,
            "options ball-space evolve": {**{k: 0 for k in epoch_launches},
                                          "rgcn_scatter_sorted": ball_launches}}


# ----------------------------------------------------------- HisRES training

def hisres_config(data, **kw) -> HisResConfig:
    """HisRES at full width with ``run_hisres``'s defaults (h=200, 2 layers,
    history rate 0.3, dropouts 0.2, the candidate cells' 0.2, layer norm,
    ``rc_mode="src"``), in fp32."""
    return HisResConfig(num_ents=data.num_nodes, num_rels=data.num_rels, h_dim=200,
                        n_layers=2, history_rate=0.3, **kw)


# run_hisres's trainer defaults: the history graphs padded to multiples of
# 4096 edges and capped at 65536, relation history over the whole window
HISRES_TRAINER = dict(his_edge_bucket=4096, his_max_edges=65536, rel_window_mode="full")


def hisres_launches(cfg: HisResConfig, T: int) -> int:
    """B1's launches in one HisRES forward on a window of T snapshots: each
    recurrent layer on the T snapshots and on the max(T - 1, 1) union
    graphs, and each layer of the two candidate cells."""
    return cfg.n_layers * (T + max(T - 1, 1)) + 2 * cfg.n_layers


def steady_steps(tag: str, step, order) -> dict:
    """``step(i)`` for each i of ``order`` (their inputs built before), with
    the launch counts reset just before and read just after, and the peak
    of torch.cuda.max_memory_allocated over the steps: prints and returns
    {"ms", "launches", "peak_mib", "base_mib"}."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    reset_launches()
    t0 = time.perf_counter()
    for i in order:
        step(i)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = dict(ms=seconds / len(order) * 1e3, launches=read_launches(),
               peak_mib=torch.cuda.max_memory_allocated() / 2**20, base_mib=base_mib)
    print(f"[{tag}] steady state: {len(order)} steps in {seconds:.3f} s = "
          f"{len(order) / seconds:.2f} snapshots/s, {out['ms']:.2f} ms per step; peak "
          f"torch.cuda.max_memory_allocated {out['peak_mib']:.1f} MiB ({base_mib:.1f} MiB "
          f"allocated before the steps); launches {out['launches']}", flush=True)
    return out


def phase_hisres_training(data, tc: TrainConfig, dev: torch.device) -> dict:
    """HisRES through ``HisResTrainer`` with ``run_hisres``'s defaults: (a) 3
    steps cuda vs cpu (``three_steps``, every dropout 0), the cpu on the
    card's branches at every rrelu and at the attention's leaky relu, B1's
    dw (the candidate layers' attention weight) among the checks; (b) one
    epoch through ``fit(checkpoint_path)``, the launch counts reset just
    before ``run_epoch`` and read just after, B1 exactly
    ``hisres_launches`` per step, no B2; the history graphs' sizes; (c)
    ``fit(resume=True)`` in a fresh trainer restores it exactly; (d) 20
    steady steps, their wall time, launches and peak memory; (e) the test
    split at random init and after the epoch (B1 ``hisres_launches`` per
    snapshot), the entity raw MRR above the random-init one; (f) a profile
    of a step, B1's forward and the scatter backward apart."""
    tag = "hisres"
    tc = dataclasses.replace(tc, n_epochs=1)  # fit runs the config's epochs
    gpu = HisResTrainer(hisres_config(data, cand_dropout=0.0, **NO_DROPOUT), tc, data,
                        device=dev, **HISRES_TRAINER)
    cpu = HisResTrainer(hisres_config(data, cand_dropout=0.0, **NO_DROPOUT), tc, data,
                        device="cpu", **HISRES_TRAINER)
    s_gpu = gpu.init_state(SEED)
    s_cpu = cpu.state_from(s_gpu.params, s_gpu.model_state)
    # the union stream's relation GRU, and the relation branch of its last
    # layer that feeds the GRU, reach the loss only through a later step of
    # the window: on a window of one union graph nothing reads them (their
    # gradient is 0 in JAX)
    last = cpu.cfg.n_layers - 1
    gg_rel_gru = ({f"relation_cell_2.{w}" for w in ("w_ih", "w_hh", "b_ih", "b_hh")}
                  | {f"rgcn_2.layers.{last}.r_linear_{w}" for w in ("w", "b")})
    worst = three_steps(tag, gpu, cpu, s_gpu, s_cpu, gpu.epoch_order(0)[:3],
                        may_lack=gg_rel_gru)
    for name in ("cand_raw.layers.0.attn_fc_w", "cand_inv.layers.1.pos_proj_w", "weight_t2",
                 "rgcn_2.layers.1.w_neighbor", *gg_rel_gru):
        check(worst[name][1] > 0, f"{tag}: {name} got no gradient in the 3 steps")
    del gpu, cpu, s_gpu, s_cpu

    cfg = hisres_config(data)
    trainer = HisResTrainer(cfg, tc, data, device=dev, **HISRES_TRAINER)
    state = trainer.init_state(SEED)
    n_test = len(trainer.test_list)
    test_launches = n_test * hisres_launches(cfg, tc.test_history_len)
    init_stats, _, init_s = counted_test(trainer, state, test_launches, f"{tag} at init")
    print(f"[{tag}] test split at random init ({init_s:.1f} s, {test_launches} B1 launches): "
          "MRR " + ", ".join(f"{k} {v.mrr:.6f}" for k, v in init_stats.items()), flush=True)

    # (b) the epoch, inside fit with a checkpoint; (c) its resume
    order = trainer.epoch_order(0)
    expected = sum(hisres_launches(cfg, min(i, tc.train_history_len)) for i in order)
    with tempfile.TemporaryDirectory() as path:
        info, epoch = fit_one_counted_epoch(trainer, state, checkpoint_path=path)
        launches, row = epoch["launches"], info["history"][0]
        check(all(math.isfinite(v) for v in row["losses"].values()),
              f"{tag} epoch losses {row['losses']}")
        check(launches["rgcn_scatter_sorted"] == expected
              and all(launches[k] == 0 for k in CE_KERNELS),
              f"{tag} epoch launches {launches}, expected {expected} of the scatter kernel "
              f"(2 layers x each window's snapshots and union graphs, 4 candidate layers, per "
              f"step) and no CE kernel")
        print(f"[{tag}] (b) epoch 0 in fit: {len(order)} steps in {epoch['seconds']:.2f} s = "
              f"{len(order) / epoch['seconds']:.2f} snapshots/s (first epoch: includes building "
              f"the {len(order)} steps' inputs); mean losses "
              + ", ".join(f"{k} {v:.5f}" for k, v in row["losses"].items())
              + f"; valid ent raw MRR {row['valid_mrr_raw']:.6f}; launches {launches} "
              f"({launches['rgcn_scatter_sorted'] / len(order):.2f} B1 launches per step)",
              flush=True)
        edges = np.array([[trainer._windows[i][k].num_edges for k in (5, 6)] for i in order])
        padded = np.array([[trainer._windows[i][k].src.shape[0] for k in (5, 6)] for i in order])
        cap = HISRES_TRAINER["his_max_edges"]
        print(f"[{tag}] history graphs of the epoch's {len(order)} steps (raw / inverse "
              f"queries): real edges mean {edges[:, 0].mean():.1f} / {edges[:, 1].mean():.1f}, "
              f"max {edges[:, 0].max()} / {edges[:, 1].max()}, padded to {padded.min()} to "
              f"{padded.max()}; {int((edges >= cap).sum())} of {edges.size} at the cap of {cap}",
              flush=True)
        headline_resume(trainer, HisResTrainer(cfg, tc, data, device=dev, **HISRES_TRAINER),
                        state, info, path, tag, lambda tr, st, i: tr.train_step(st, *tr.window(i)))

    # (d) steady state on a copy: the next epoch's first steps, inputs built
    steady = train_state.copy_state(state)
    steady_order = trainer.epoch_order(1)[:PROFILE_STEPS]
    steady_out = steady_steps(tag, lambda i: trainer.train_step(steady, *trainer.window(i)),
                              steady_order)
    STEADY[f"{tag} train step"] = steady_out["ms"]
    want = sum(hisres_launches(cfg, min(i, tc.train_history_len)) for i in steady_order)
    check(steady_out["launches"]["rgcn_scatter_sorted"] == want,
          f"{tag}: {steady_out['launches']} in the steady steps, expected {want} of B1")

    # (e) the test split after the epoch
    stats, test_counts, test_s = counted_test(trainer, state, test_launches, tag)
    check(stats["ent_raw"].mrr > init_stats["ent_raw"].mrr,
          f"{tag} entity raw MRR {stats['ent_raw'].mrr:.6f} after an epoch is not above the "
          f"random-init {init_stats['ent_raw'].mrr:.6f}")
    print(f"[{tag}] (e) test split after one epoch ({test_s:.1f} s, "
          f"{test_s / n_test * 1e3:.2f} ms per snapshot, {test_counts['rgcn_scatter_sorted']} B1 "
          "launches): MRR " + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items())
          + " (random init: " + ", ".join(f"{k} {v.mrr:.6f}" for k, v in init_stats.items())
          + ")", flush=True)

    # (f) where a step's time goes
    train_profile(f"{tag} train step", lambda i: trainer.train_step(steady, *trainer.window(i)),
                  trainer.epoch_order(2)[:PROFILED_STEPS], scatter=True)
    return {"hisres training epoch": launches, "hisres test split": test_counts,
            "hisres steady steps": steady_out["launches"]}


# ------------------------------------------ the fhnn and hgat encoders

def phase_hyperbolic_encoders(data, tc: TrainConfig, dev: torch.device) -> dict:
    """Config 3 with its LGCN encoder replaced by FHNN, then by HGAT (RotH /
    RotH-Rel, c = 0.01 learned with a 5-epoch warmup, radius supervision):
    (a) 3 steps cuda vs cpu (``three_steps``, dropouts 0), the cpu on the
    card's branches at the rrelu and, for HGAT, at the attention's leaky
    relu; (b) 10 steady steps, their wall time and peak memory, B2's three
    kernels exactly twice a step (entity and relation loss) and no B1; (c)
    the test split after them (no kernel: eval scores are plain distance
    logits); (d) a profile of a step, B2's kernels apart."""
    out = {}
    for encoder in ("fhnn", "hgat"):
        def cfg(**kw):
            return dataclasses.replace(config3(data, **kw), encoder=encoder)

        gpu = HyperbolicTrainer(cfg(**NO_DROPOUT), tc, data, curvature_warmup_epochs=5,
                                device=dev)
        cpu = HyperbolicTrainer(cfg(**NO_DROPOUT), tc, data, curvature_warmup_epochs=5,
                                device="cpu")
        s_gpu = gpu.init_state(SEED)
        s_cpu = cpu.state_from(s_gpu.params, s_gpu.model_state)
        worst = three_steps(encoder, gpu, cpu, s_gpu, s_cpu, gpu.epoch_order(0)[:3],
                            gpu._curvature_max(0))
        check(worst["rgcn.layers.1.rel_weight"][1] > 0,
              f"{encoder}: the second layer's relation weights got no gradient")
        del gpu, cpu, s_gpu, s_cpu

        trainer = HyperbolicTrainer(cfg(), tc, data, curvature_warmup_epochs=5, device=dev)
        state = trainer.init_state(SEED)
        order = trainer.epoch_order(0)[:ENCODER_STEADY_STEPS]
        E = sorted({trainer.window(i)[0].src.shape[1] for i in order})
        cmax = trainer._curvature_max(0)
        steady = steady_steps(encoder, lambda i: trainer.train_step(state, *trainer.window(i),
                                                                    cmax), order)
        launches = steady["launches"]
        check(launches["rgcn_scatter_sorted"] == 0
              and all(launches[k] == 2 * len(order) for k in CE_KERNELS),
              f"{encoder}: launches {launches} in {len(order)} steps, expected each B2 kernel "
              f"{2 * len(order)} times and no B1")
        print(f"[{encoder}] (b) padded edges of the steps' windows {E}: the per-edge relation "
              "weights take " + ", ".join(
                  f"{e * (4 if encoder == 'hgat' else 1) * cfg().h_dim ** 2 * 4 / 2**20:.0f}"
                  for e in E) + " MiB per layer and snapshot", flush=True)
        stats, test_counts, test_s = counted_test(trainer, state, 0, encoder)
        print(f"[{encoder}] (c) test split after {len(order)} steps ({test_s:.1f} s): MRR "
              + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items()), flush=True)
        train_profile(f"{encoder} train step",
                      lambda i: trainer.train_step(state, *trainer.window(i), cmax),
                      trainer.epoch_order(1)[:PROFILED_STEPS], ce=True)
        out[f"{encoder} steady steps"] = launches
        out[f"{encoder} test split"] = test_counts
        del trainer, state
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------ the CLI and the sweep

def expected_epoch_scatters(train_list, hlen: int) -> int:
    """B1's launches in one RE-GCN epoch: 2 layers x each window's snapshots."""
    return sum(2 * min(i, hlen) for i in range(1, len(train_list)))


def phase_cli_train_test(dev: torch.device) -> dict:
    """(16) ``python -m regcn_torch.cli train`` then ``test`` through
    ``cli.main`` on synthetic-icews14s with the CLI's defaults (config 1:
    h=200, 2 layers, history 3, dropouts 0.2, buckets of 1024 / 512) and
    one epoch: B1 exactly the epoch's 2 x window snapshots plus 6 per valid
    and test snapshot, no B2; ``test`` restores the best checkpoint that
    ``train`` saved and prints the same four MRRs."""
    import shutil

    from regcn_torch import cli

    models = os.path.join(ROOT, "models", "chip_smoke_cli")
    shutil.rmtree(models, ignore_errors=True)
    argv = ["-d", "synthetic-icews14s", "--n-epochs", "1", "--models-dir", models]
    data = generate("synthetic-icews14s")  # the data load_data makes for the name
    n_valid, n_test = len(split_by_time(data.valid)), len(split_by_time(data.test))
    want = {"train": expected_epoch_scatters(split_by_time(data.train), 3) + 6 * (n_valid + n_test),
            "test": 6 * n_test}
    out, launches = {}, {}
    for mode in ("train", "test"):
        reset_launches()
        t0 = time.perf_counter()
        out[mode] = cli.main([mode, *argv], device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[mode] = read_launches()
        check(launches[mode]["rgcn_scatter_sorted"] == want[mode]
              and all(launches[mode][k] == 0 for k in CE_KERNELS),
              f"cli {mode}: launches {launches[mode]}, expected B1 {want[mode]} and no B2")
        for key, row in out[mode].items():
            check(math.isfinite(row["mrr"]) and 0.0 < row["mrr"] <= 1.0,
                  f"cli {mode}: {key} MRR {row['mrr']} not in (0, 1]")
        print(f"[cli] {mode} ({seconds:.1f} s): B1 {launches[mode]['rgcn_scatter_sorted']} "
              f"launches; MRR " + ", ".join(f"{k} {v['mrr']:.6f}" for k, v in out[mode].items()),
              flush=True)
    diff = max(abs(out["test"][k][m] - v) for k, row in out["train"].items()
               for m, v in row.items())
    check(diff <= CLI_MRR_TOL, f"cli test: the restored checkpoint's metrics differ from "
          f"train's best state's by {diff:.3e} > {CLI_MRR_TOL:.0e}")
    print(f"[cli] test restored train's best checkpoint: its metrics within {diff:.3e} of "
          "train's", flush=True)
    shutil.rmtree(models, ignore_errors=True)
    return {"cli train": launches["train"], "cli test": launches["test"]}


def phase_entity(dev: torch.device) -> tuple:
    """(17) ``cli.main(["entity", "-d", "synthetic-aifb"])`` with the CLI's
    defaults (h=200, n_bases 100 > 91 relations: one basis per relation,
    dropout 0.2, lr 1e-3, 30 epochs): B1 on the graph's destination-sorted
    edges with the edge norm as its weight, held against its plain version
    at d=200 (the input layer) and d=4 (the output layer: one float4 a row)
    and timed there; the launch count (2 a forward: 30 training steps, the
    train and the test accuracy), the accuracies and the peak memory; the
    logits at the seed's initial parameters on the card against the CPU's."""
    from regcn_torch import cli
    from regcn_torch.data.rdf import load_entity_data
    from regcn_torch.models import entity_classifier as ec

    data = load_entity_data("synthetic-aifb", seed=2023)  # the CLI's --seed default
    graph = ec.graph_for(data, 128, dev)
    N, E = data.num_nodes, graph.src.shape[0]
    g = np.random.default_rng(SEED)
    errs, times = {}, []
    for d in (200, 4):
        msg = torch.from_numpy(g.normal(size=(E, d)).astype(np.float32)).to(dev)
        kw = dict(edge_weight=graph.edge_norm, row_scale=graph.in_deg_norm)
        got = scatter_add_sorted(msg, graph.keys, N, **kw)
        want = scatter_add_sorted_reference(msg, graph.keys, N, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        check(math.isfinite(err) and err <= KERNEL_TOL * scale,
              f"entity graph d={d}: max|kernel - plain| = {err:.3e} > {KERNEL_TOL:.0e} * "
              f"{scale:.3e}")
        errs[d] = err
        t = scatter_times(msg, graph.keys, N, len(data.edge_src), **kw)
        times.append(dict(shape=f"synthetic-aifb E={E} N={N} d={d}", **t))
        print(f"[entity] rgcn_scatter_sorted at E={E} ({len(data.edge_src)} real) N={N} d={d}: "
              f"max abs err {err:.3e} (scale {scale:.3e}); kernel {t['ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, zeros + index_add_ {t['library_ms'] * 1e3:.2f} us, "
              f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})", flush=True)
    cfg = ec.EntityClassifierConfig(h_dim=200, n_bases=100, dropout=0.2, lr=1e-3, n_epochs=30)
    params = ec.init_entity_classifier(torch.Generator().manual_seed(2023), data, cfg, "cpu")
    want = ec.entity_logits(params, ec.graph_for(data, 128, "cpu"), cfg).detach()
    got = ec.entity_logits(recurrent.tree_to(params, dev), graph, cfg).detach().cpu()
    err, scale = (got - want).abs().max().item(), max(1.0, want.abs().max().item())
    check(math.isfinite(err) and err <= CPU_SCORE_TOL * scale,
          f"entity logits cuda vs cpu: max abs err {err:.3e} > {CPU_SCORE_TOL:.0e} * {scale:.3e}")
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    reset_launches()
    t0 = time.perf_counter()
    result = cli.main(["entity", "-d", "synthetic-aifb"], device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    expected = 2 * (cfg.n_epochs + 2)
    check(launches["rgcn_scatter_sorted"] == expected and all(launches[k] == 0 for k in CE_KERNELS),
          f"entity: launches {launches}, expected B1 {expected} and no B2")
    check(all(math.isfinite(v) for v in result.values())
          and 0.0 <= result["train_acc"] <= 1.0 and 0.0 <= result["test_acc"] <= 1.0,
          f"entity: result {result}")
    print(f"[entity] cli entity -d synthetic-aifb ({data.num_nodes} nodes, {data.num_rels} "
          f"relations, {data.num_classes} classes, {E} padded edges): {seconds:.1f} s for 30 "
          f"full-batch steps and 2 evaluations; train acc {result['train_acc']:.4f}, test acc "
          f"{result['test_acc']:.4f}, final loss {result['final_loss']:.4f}; logits at init cuda "
          f"vs cpu {err:.3e} (scale {scale:.3e}); peak torch.cuda.max_memory_allocated "
          f"{peak_mib:.1f} MiB ({base_mib:.1f} MiB before); launches {launches}", flush=True)
    return {"cli entity": launches}, times, max(errs.values())


def kink_recording(runner):
    """``runner.model_loss`` that adds each kink's branch (PinnedKinks's
    record) to the losses: a batched tensor may not outlive the ``vmap``,
    so the branches of all models come back stacked through the losses."""
    orig = runner.model_loss

    def model_loss(*args):
        kinks = PinnedKinks()
        with kinks.record():
            losses, new_state = orig(*args)
        losses = dict(losses)
        for kind, masks in kinks.masks.items():
            for j, m in enumerate(masks):
                losses[f"kink {kind} {j}"] = m
        return losses, new_state

    return model_loss


def model_kinks(losses: dict, k: int) -> PinnedKinks:
    """PinnedKinks holding model k's branches of a vmapped step, to replay."""
    kinks = PinnedKinks()
    for kind in PinnedKinks.KINDS:
        n = sum(1 for key in losses if key.startswith(f"kink {kind} "))
        kinks.masks[kind] = [losses[f"kink {kind} {j}"][k] for j in range(n)]
    return kinks


def vmapped_three_steps(tag: str, runner, trainers, order, *loss_args) -> None:
    """3 vmapped steps of a sweep against 3 steps of each model alone on the
    card, from the same state before each step (dropouts 0): model k's
    trainer takes slice k of the sweep's state; the losses within
    TRAIN_LOSS_RTOL, every gradient within TRAIN_GRAD_TOL of its largest
    entry (model k on the branches the vmapped step took at the kinks,
    as PinnedKinks replays the card's on the cpu), the BN statistics, and
    each model's optimizer step from the same gradients and moments
    against the stacked one within TRAIN_OPT_TOL."""
    from regcn_torch.train.optim import AdamState
    from regcn_torch.train.sweep import model_slice

    t0 = time.perf_counter()
    state = runner.init_state()
    names = leaf_names(model_slice(state.params, 0))
    runner.model_loss = kink_recording(runner)
    worst = dict(loss=0.0, grad=0.0, bn=0.0, opt=0.0)
    flips = []
    for i in order:
        losses, grads, new_ms = runner.grad_step(state, i)
        expected = []
        for k, tr in enumerate(trainers):
            ms_k = runner.model_state_type(**model_slice(state.model_state, k))
            if isinstance(tr, loop.Trainer):
                s_k = train_state.state_from(model_slice(state.params, k), ms_k, tr.cfg.train,
                                             SEED, tr.device)
            else:
                s_k = tr.state_from(model_slice(state.params, k), ms_k)
            kinks = model_kinks(losses, k)
            with kinks.replay():
                total, parts, new_bn, *_ = tr.loss(s_k, *tr.window(i), *loss_args)
                g_k = torch.autograd.grad(total, tree_leaves(s_k.params), allow_unused=True)
            flips.append(kinks.check(f"{tag} model {k}"))
            for key, v in parts.items():
                a, b = losses[key][k].item(), v.item()
                check(math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * max(1.0, abs(b)),
                      f"{tag}, snapshot {i}, model {k}: {key} loss vmapped {a} vs alone {b}")
                worst["loss"] = max(worst["loss"], abs(a - b) / max(1.0, abs(b)))
            for name, a, b in zip(names, grads, g_k):
                b = torch.zeros_like(a[k]) if b is None else b
                err = (a[k] - b).abs().max().item() / max(1.0, b.abs().max().item())
                check(err <= TRAIN_GRAD_TOL, f"{tag}, snapshot {i}, model {k}: {name} gradient "
                      f"vmapped vs alone {err:.3e} > {TRAIN_GRAD_TOL:.0e}")
                worst["grad"] = max(worst["grad"], err)
            for a, b in zip(model_state_leaves(runner.model_state_type(**model_slice(new_ms, k))),
                            model_state_leaves(new_bn)):
                err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
                worst["bn"] = max(worst["bn"], err)
            check(worst["bn"] <= TRAIN_GRAD_TOL, f"{tag}, snapshot {i}, model {k}: BN statistics "
                  f"vmapped vs alone {worst['bn']:.3e} > {TRAIN_GRAD_TOL:.0e}")
            # model k's own optimizer from the sweep's moments and gradients
            leaves = [p.detach().clone() for p in tree_leaves(s_k.params)]
            opt_k = AdamState(count=state.opt_state.count,
                              mu=[m[k].clone() for m in state.opt_state.mu],
                              nu=[m[k].clone() for m in state.opt_state.nu])
            tr.opt.step(leaves, [g[k] for g in grads], opt_k)
            expected.append(leaves)
        runner.opt.step(tree_leaves(state.params), grads, state.opt_state)
        state.model_state = new_ms
        for k, leaves in enumerate(expected):
            for name, a, b in zip(names, tree_leaves(state.params), leaves):
                err = ((a[k] - b).abs() / b.abs().clamp(min=1.0)).max().item()
                check(err <= TRAIN_OPT_TOL, f"{tag}, snapshot {i}, model {k}: {name} after the "
                      f"optimizer step, stacked vs alone {err:.3e} > {TRAIN_OPT_TOL:.0e}")
                worst["opt"] = max(worst["opt"], err)
        print(f"[{tag}] vmapped step on snapshot {i}: entity losses "
              + ", ".join(f"{v:.6f}" for v in losses["entity"].tolist()), flush=True)
    del runner.model_loss
    print(f"[{tag}] (a) 3 vmapped steps of {len(trainers)} models vs each model alone on the "
          f"card from the same state: losses within {worst['loss']:.2e}, every gradient within "
          f"{worst['grad']:.2e} of its largest entry, BN statistics within {worst['bn']:.2e}, "
          f"every parameter after the stacked optimizer step within {worst['opt']:.2e}; kinks: "
          f"{flips[-1]} ({time.perf_counter() - t0:.1f} s)", flush=True)


def phase_vectorized_grid(data, dev: torch.device) -> tuple:
    """(18) ``cli.main(["grid", "--tune", "lr,seed", "--vectorize", ...])``
    for the regcn family (K = 6: lr {1e-3, 5e-4} x seed {2023, 2024,
    2025}) on synthetic-icews14s with the CLI's defaults and one epoch:
    (a) 3 vmapped steps against each model's 3 steps alone
    (``vmapped_three_steps``, dropouts 0); (b) the CLI's run, B1 folded: as
    many launches as one model's epoch and valid split, no B2; (c) 20
    steady vmapped steps beside 20 steps of one model (wall, launches, peak
    memory), and each under the profiler (device busy); (d) B1 at the
    folded width [E, 6 x 200] of a window snapshot, timed beside zeros +
    index_add_ and its bound."""
    import itertools

    from regcn_torch import cli
    from regcn_torch.train.sweep import SweepRunner

    argv = ["grid", "-d", "synthetic-icews14s", "--tune", "lr,seed", "--vectorize",
            "--n-epochs", "1"]
    args = cli.build_parser().parse_args(argv)
    table = cli.grid_table(args.dataset, args.grid_family)
    inner = list(itertools.product(table["lr"], table["seed"]))
    combos = {"lr": [lr for lr, _ in inner], "seed": [s for _, s in inner]}
    K = len(inner)
    exp = cli.make_experiment(args, data)

    # (a) dropouts 0
    cfg0 = dataclasses.replace(exp.model, **NO_DROPOUT)
    runner = SweepRunner(cfg0, exp.train, data, combos, device=dev)
    trainers = [loop.Trainer(ExperimentConfig(model=cfg0, train=dataclasses.replace(
        exp.train, lr=lr, seed=s)), data, device=dev) for lr, s in inner]
    vmapped_three_steps("grid regcn", runner, trainers, runner.epoch_order(0)[:3])
    del runner, trainers

    # (b) the CLI's run
    gs = f"{args.dataset}.{args.encoder}-{args.decoder}.gs"
    train_list = split_by_time(data.train)
    want = expected_epoch_scatters(train_list, 3) + 6 * len(split_by_time(data.valid))
    reset_launches()
    t0 = time.perf_counter()
    rows = cli.main(argv, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    os.remove(gs)
    check(len(rows) == K and all(0.0 < r["valid_ent_mrr_raw"] <= 1.0 for r in rows),
          f"grid --vectorize: rows {rows}")
    check(launches["rgcn_scatter_sorted"] == want and all(launches[k] == 0 for k in CE_KERNELS),
          f"grid --vectorize: launches {launches}, expected B1 {want} (one model's epoch and "
          "valid split: the models fold into one launch) and no B2")
    print(f"[grid regcn] (b) cli grid --tune lr,seed --vectorize, {K} models, one epoch of "
          f"{len(train_list) - 1} steps and the valid split ({seconds:.1f} s): B1 "
          f"{launches['rgcn_scatter_sorted']} launches; valid raw MRR "
          + ", ".join(f"lr {r['params']['lr']} seed {r['params']['seed']}: "
                      f"{r['valid_ent_mrr_raw']:.6f}" for r in rows), flush=True)

    # (c) steady steps: the sweep beside one model
    runner = SweepRunner(exp.model, exp.train, data, combos, device=dev)
    state = runner.init_state()
    single = loop.Trainer(ExperimentConfig(model=exp.model, train=dataclasses.replace(
        exp.train, lr=inner[0][0], seed=inner[0][1])), data, device=dev)
    s1 = single.init_state()
    order = runner.epoch_order(1)[:PROFILE_STEPS]
    for i in order:
        runner.window(i), runner.draws(state, i), single.window(i)
    sweep_out = steady_steps(f"grid regcn x{K}", lambda i: runner.train_step(state, i), order)
    one_out = steady_steps("grid regcn x1", lambda i: single.train_step(s1, *single.window(i)),
                           order)
    check(sweep_out["launches"] == one_out["launches"],
          f"grid regcn: the vmapped steps launched {sweep_out['launches']}, one model's "
          f"{one_out['launches']}")
    busy_k = train_profile(f"grid regcn x{K} vmapped step", lambda i: runner.train_step(state, i),
                           runner.epoch_order(2)[:PROFILED_STEPS])
    busy_1 = train_profile("grid regcn x1 step", lambda i: single.train_step(s1, *single.window(i)),
                           runner.epoch_order(2)[:PROFILED_STEPS], scatter=True)
    print(f"[grid regcn] (c) one vmapped step of {K} models {sweep_out['ms']:.2f} ms (device busy "
          f"{busy_k / 1e3:.3f} ms) against {K} steps of one model {K * one_out['ms']:.2f} ms "
          f"({K} x {one_out['ms']:.2f}; device busy {K} x {busy_1 / 1e3:.3f} ms): "
          f"{K * one_out['ms'] / sweep_out['ms']:.2f} x the models' steps per second; B1 "
          f"{sweep_out['launches']['rgcn_scatter_sorted']} launches in {len(order)} steps either "
          f"way", flush=True)

    # (d) B1 at the folded width
    history = runner.window(order[0])[0]
    snap = history.step(history.src.shape[0] - 1)
    n = data.num_nodes
    keys = torch.where(snap.edge_mask > 0, snap.dst, n).to(torch.int32)
    g = np.random.default_rng(SEED)
    msg = torch.from_numpy(g.normal(size=(keys.shape[0], K * exp.model.h_dim)).astype(
        np.float32)).to(dev)
    kw = dict(edge_weight=snap.edge_mask.contiguous(), row_scale=snap.in_deg_norm.contiguous())
    got = scatter_add_sorted(msg, keys, n, **kw)
    ref = scatter_add_sorted_reference(msg, keys, n, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= KERNEL_TOL * max(1.0, ref.abs().max().item()),
          f"B1 at the folded width: max|kernel - plain| {err:.3e}")
    t = scatter_times(msg, keys, n, int(snap.edge_mask.sum().item()), **kw)
    print(f"[grid regcn] (d) rgcn_scatter_sorted folded, E={msg.shape[0]} N={n} "
          f"d={msg.shape[1]}: max abs err {err:.3e}; kernel {t['ms'] * 1e3:.2f} us, plain "
          f"{t['plain_ms'] * 1e3:.2f} us, zeros + index_add_ {t['library_ms'] * 1e3:.2f} us, "
          f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}; kernel at "
          f"{100 * t['bound_ms'] / t['ms']:.0f} % of it)", flush=True)
    paths = {"grid --vectorize regcn": launches,
             f"grid regcn x{K} steady steps": sweep_out["launches"]}
    return paths, dict(shape=f"folded E={msg.shape[0]} N={n} d={msg.shape[1]}", **t), err


def phase_vectorized_hyperbolic(data, tc: TrainConfig, dev: torch.device) -> dict:
    """(18b) the hyperbolic ``grid --tune lr,seed --vectorize`` on config 3
    (LGCN + RotH, c learned, h=200; K = 6) on phase 6's cut of
    synthetic-icews14s, through ``HyperbolicSweepRunner`` with the configs
    ``cli.make_hyperbolic_configs`` builds: (a) 3 vmapped steps against each
    model alone (dropouts 0); (b) 10 steady vmapped steps with the config's
    dropouts, each B2 kernel exactly K x 2 (entity and relation loss) a
    step, no B1, beside 10 steps of one model; a profile of each; (c) the
    headline (uvrgcn + tangent ConvTransE/R, buckets of 128) vmapped over
    K = 2 learning rates: its 3-step check, B1 folded with each model's
    radius weight multiplied in (as many launches as one model's steps)."""
    import itertools

    from regcn_torch import cli
    from regcn_torch.train.sweep import HyperbolicSweepRunner

    argv = ["grid", "-d", "synthetic-icews14s", "--grid-family", "hyperbolic", "--tune",
            "lr,seed", "--vectorize", "--encoder", "lgcn", "--decoder", "roth",
            "--learn-curvature", "--n-epochs", "1"]
    args = cli.build_parser().parse_args(argv)
    table = cli.grid_table(args.dataset, args.grid_family)
    inner = list(itertools.product(table["lr"], table["seed"]))
    combos = {"lr": [lr for lr, _ in inner], "seed": [s for _, s in inner]}
    K = len(inner)
    cfg, htc = cli.make_hyperbolic_configs(args, data)
    cfg0 = dataclasses.replace(cfg, **NO_DROPOUT)
    runner = HyperbolicSweepRunner(cfg0, htc, data, combos, device=dev)
    trainers = [HyperbolicTrainer(cfg0, dataclasses.replace(htc, lr=lr, seed=s), data,
                                  device=dev) for lr, s in inner]
    vmapped_three_steps("grid hyperbolic", runner, trainers, runner.epoch_order(0)[:3],
                        trainers[0]._curvature_max(0))
    del runner, trainers
    torch.cuda.empty_cache()

    runner = HyperbolicSweepRunner(cfg, htc, data, combos, device=dev)
    state = runner.init_state()
    single = HyperbolicTrainer(cfg, dataclasses.replace(htc, lr=inner[0][0], seed=inner[0][1]),
                               data, device=dev)
    s1 = single.init_state()
    cmax = single._curvature_max(0)
    order = runner.epoch_order(0)[:10]
    for i in order:
        runner.window(i), runner.draws(state, i), single.window(i)
    out = steady_steps(f"grid hyperbolic x{K}", lambda i: runner.train_step(state, i), order)
    one = steady_steps("grid hyperbolic x1",
                       lambda i: single.train_step(s1, *single.window(i), cmax), order)
    check(out["launches"]["rgcn_scatter_sorted"] == 0
          and all(out["launches"][k] == 2 * K * len(order) for k in CE_KERNELS),
          f"grid hyperbolic: launches {out['launches']} in {len(order)} vmapped steps of {K} "
          f"models, expected each B2 kernel {2 * K * len(order)} times and no B1")
    busy_k = train_profile(f"grid hyperbolic x{K} vmapped step",
                           lambda i: runner.train_step(state, i),
                           runner.epoch_order(1)[:PROFILED_STEPS], ce=True)
    busy_1 = train_profile("grid hyperbolic x1 step",
                           lambda i: single.train_step(s1, *single.window(i), cmax),
                           runner.epoch_order(1)[:PROFILED_STEPS], ce=True)
    print(f"[grid hyperbolic] (b) one vmapped step of {K} models {out['ms']:.2f} ms (device busy "
          f"{busy_k / 1e3:.3f} ms) against {K} steps of one model {K * one['ms']:.2f} ms "
          f"({K} x {one['ms']:.2f}; device busy {K} x {busy_1 / 1e3:.3f} ms): "
          f"{K * one['ms'] / out['ms']:.2f} x the models' steps per second", flush=True)
    del runner, state, single, s1
    torch.cuda.empty_cache()

    headline = dataclasses.replace(headline_config(data), **NO_DROPOUT)
    lrs = {"lr": table["lr"]}
    runner = HyperbolicSweepRunner(headline, tc, data, lrs, device=dev)
    trainers = [HyperbolicTrainer(headline, dataclasses.replace(tc, lr=lr), data, device=dev)
                for lr in lrs["lr"]]
    order = runner.epoch_order(0)[:3]
    reset_launches()
    vmapped_three_steps("grid headline", runner, trainers, order, trainers[0]._curvature_max(0))
    launches = read_launches()
    # per step: the vmapped forward (folded) and each model's own forward
    want = sum(2 * min(i, tc.train_history_len) for i in order) * (1 + len(trainers))
    check(launches["rgcn_scatter_sorted"] == want and all(launches[k] == 0 for k in CE_KERNELS),
          f"grid headline: launches {launches} in 3 checked steps, expected B1 {want} (the "
          f"vmapped step's as one model's, then each of {len(trainers)} models') and no B2")
    return {f"grid hyperbolic x{K} steady steps": out["launches"],
            "grid headline x2 checked steps": launches}


# ----------------------------------------------------------- bf16 compute

# bf16 against fp32 (dropouts 0, the same initial state): the card's bf16
# may drift from the CPU's fp32 by twice what the CPU's own bf16 drifts,
# plus this much of |cpu fp32 loss| (each loss) or of the distance the CPU's
# fp32 run moved the parameter (after the 3 steps: Adam moves an entry by
# about lr whatever its gradient, so a gradient within bf16 noise of 0 may
# step either way)
BF16_LOSS_ATOL = 1e-2
BF16_STEP_ATOL = 0.5
# the epoch's mean entity loss and the test split's entity raw MRR of the
# bf16 headline against its fp32 twin (bench.py's claim for bf16)
BF16_EPOCH_RTOL = 0.05
BF16_MRR_ATOL = 0.02
# the card's bf16 GEMM with an fp32 result against the fp32 product of the
# same bf16 values: both accumulate exact products in fp32, in another order
GEMM_ROUTE_TOL = 1e-5


def fresh_state(trainer, state):
    """A new state on ``trainer``'s device around copies of ``state``'s
    parameters and model state (zero moments)."""
    if hasattr(trainer, "state_from"):
        return trainer.state_from(state.params, state.model_state)
    return train_state.state_from(state.params, state.model_state, trainer.cfg.train, SEED,
                                  trainer.device)


def drift_check(tag: str, what: str, card, cpu16, cpu32, atol: float, ref=None) -> float:
    """err(card bf16, cpu fp32) <= 2 err(cpu bf16, cpu fp32) + atol * ref
    (L2 norms; ref = |cpu fp32| unless given); returns the margin used."""
    c, b, f = (np.asarray(x, np.float64) for x in (card, cpu16, cpu32))
    e_card, e_cpu = np.linalg.norm(c - f), np.linalg.norm(b - f)
    ref = np.linalg.norm(f) if ref is None else ref
    check(math.isfinite(e_card) and e_card <= 2.0 * e_cpu + atol * ref,
          f"{tag}: {what} bf16 card vs fp32 cpu {e_card:.3e} > 2 x the cpu's bf16 drift "
          f"{e_cpu:.3e} + {atol} x {ref:.3e}")
    return e_card / max(2.0 * e_cpu + atol * ref, 1e-30)


def bf16_three_steps(tag: str, make, step, dev: torch.device) -> None:
    """3 bf16 steps on the card, 3 on the CPU in bf16 and 3 on the CPU in
    fp32, on the first 3 windows of epoch 0, all from the card's initial
    state (dropouts 0): each step's
    losses and every parameter after the steps under the drift bound
    (``drift_check``), the parameters fp32 throughout."""
    t0 = time.perf_counter()
    card, cpu16, cpu32 = make(dev, "bfloat16"), make("cpu", "bfloat16"), make("cpu", "float32")
    s_card = card.init_state(SEED)
    order = card.epoch_order(0)[:3]
    runs = {"card": (card, s_card), "cpu16": (cpu16, fresh_state(cpu16, s_card)),
            "cpu32": (cpu32, fresh_state(cpu32, s_card))}
    start = [t.detach().cpu().double() for t in tree_leaves(s_card.params)]
    losses = {k: [] for k in runs}
    for i in order:
        for k, (tr, st) in runs.items():
            losses[k].append({n: float(v) for n, v in step(tr, st, i).items()})
    worst = 0.0
    for s in range(len(order)):
        for n, f in losses["cpu32"][s].items():
            worst = max(worst, drift_check(tag, f"step {s} {n} loss", losses["card"][s][n],
                                           losses["cpu16"][s][n], f, BF16_LOSS_ATOL))
    names = leaf_names(s_card.params)
    leaves = [tree_leaves(runs[k][1].params) for k in ("card", "cpu16", "cpu32")]
    for name, a, b, f, s0 in zip(names, *leaves, start):
        check(a.dtype == b.dtype == f.dtype == torch.float32, f"{tag}: {name} is {a.dtype} after "
              "the bf16 steps, expected float32 parameters")
        moved = (f.detach().double() - s0).norm().item()
        worst = max(worst, drift_check(tag, f"{name} after the steps", a.detach().cpu(),
                                       b.detach(), f.detach(), BF16_STEP_ATOL, moved))
    print(f"[{tag}] 3 bf16 steps card vs cpu bf16 vs cpu fp32 from the same state: each loss "
          f"and parameter within {worst:.3f} of its drift bound; losses card/cpu16/cpu32 "
          + "; ".join(", ".join(f"{n} {losses['card'][s][n]:.5f}/{losses['cpu16'][s][n]:.5f}/"
                                f"{losses['cpu32'][s][n]:.5f}" for n in ("entity", "relation"))
                      for s in range(len(order)))
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def bf16_dtypes(tag: str, carry: torch.Tensor, scores, state) -> None:
    """The carry in bf16, the scores and the parameters in fp32."""
    check(carry.dtype == torch.bfloat16, f"{tag}: the evolution's carry is {carry.dtype}, "
          "expected bfloat16")
    for s in scores:
        check(s.dtype == torch.float32 and bool(torch.isfinite(s).all()),
              f"{tag}: scores {s.dtype}, expected finite float32")
    check(all(t.dtype == torch.float32 for t in tree_leaves(state.params)),
          f"{tag}: a parameter is not float32")
    print(f"[{tag}] dtypes: carry {carry.dtype}, scores "
          + "/".join(str(s.dtype) for s in scores) + ", parameters torch.float32", flush=True)


def bf16_speed(tag: str, fp32_label: str, trainer, step, twin, steady_order, profile_order,
               b1: int = 0, b2: int = 0) -> dict:
    """10 steady bf16 steps (their launches: B1 ``b1`` and each B2 kernel
    ``b2`` in all, as the fp32 twin launches) and a profiled 3, printed
    beside the fp32 twin's numbers of its phase; then the same 10 windows
    in blocks that alternate between the fp32 twin (``twin``: its trainer
    and step, from its own initial state) and bf16, twice each, since the
    host's speed drifts between phases. The windows are built before the
    clock starts, as the fp32 twin's were, and one step warms each up."""
    label = f"{tag} train step"
    for i in list(steady_order) + list(profile_order):
        trainer.window(i)
    step(steady_order[0])
    out = steady_steps(tag, step, steady_order)
    launches = out["launches"]
    check(launches["rgcn_scatter_sorted"] == b1 and all(launches[k] == b2 for k in CE_KERNELS),
          f"{tag}: launches {launches} in the steady steps, expected {b1} of B1 and {b2} of "
          "each CE kernel (the fp32 twin's)")
    train_profile(label, step, profile_order, scatter=b1 > 0, ce=b2 > 0)
    row = dict(bf16_ms=out["ms"], fp32_ms=STEADY.get(fp32_label),
               bf16_busy=PROFILES[label]["busy_ms"], fp32_busy=PROFILES[fp32_label]["busy_ms"],
               bf16_kernels=PROFILES[label]["kernels"],
               fp32_kernels=PROFILES[fp32_label]["kernels"])
    fmt = lambda v: "n/a" if v is None else f"{v:.2f}"  # noqa: E731
    print(f"[bf16] {tag}: steady step fp32 {fmt(row['fp32_ms'])} ms / bf16 "
          f"{row['bf16_ms']:.2f} ms; device busy fp32 {row['fp32_busy']:.3f} ms / bf16 "
          f"{row['bf16_busy']:.3f} ms; kernels and copies per step fp32 "
          f"{row['fp32_kernels']:.0f} / bf16 {row['bf16_kernels']:.0f}; B1 "
          f"{b1 / len(steady_order):.2f}, each B2 kernel {b2 / len(steady_order):.2f} per step "
          "in both", flush=True)
    twin_trainer, twin_step = twin
    for i in steady_order:
        twin_trainer.window(i)
    twin_step(steady_order[0])
    walls = {"fp32": [], "bf16": []}
    for _ in range(2):
        for name, fn in (("fp32", twin_step), ("bf16", step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in steady_order:
                fn(i)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / len(steady_order) * 1e3)
    print(f"[bf16] {tag}: alternating blocks of {len(steady_order)} steps, ms per step fp32 "
          + " / ".join(f"{w:.2f}" for w in walls["fp32"]) + ", bf16 "
          + " / ".join(f"{w:.2f}" for w in walls["bf16"])
          + f"; bf16 / fp32 {sum(walls['bf16']) / sum(walls['fp32']):.3f}", flush=True)
    return launches


def gemm_route_check(dev: torch.device) -> None:
    """``dot_f32`` on the card (``torch.mm(..., out_dtype=float32)``, bf16
    tensor cores) against the fp32 product of the same bf16 values (the
    CPU's route, run here on the card with TF32 off) at the decoders' and
    the edge GEMM's shapes, each also timed."""
    from regcn_torch.utils.dtypes import dot_f32

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    parts = []
    for name, (m, k, n) in (("ConvTransE scores", (512, 200, 7128)),
                            ("edge GEMM", (1024, 200, 200))):
        a = torch.randn(m, k, generator=g, device=dev).bfloat16()
        b = torch.randn(k, n, generator=g, device=dev).bfloat16()
        card = dot_f32(a, b)
        want = a.float() @ b.float()
        check(card.dtype == torch.float32, f"dot_f32 on the card gave {card.dtype}")
        err = (card - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        check(err <= GEMM_ROUTE_TOL * scale, f"dot_f32 {name} card route vs the fp32 product "
              f"{err:.3e} > {GEMM_ROUTE_TOL:.0e} * {scale:.3e}")
        ms = device_time_ms(lambda: dot_f32(a, b))
        f32_ms = device_time_ms(lambda: a.float() @ b.float())
        parts.append(f"{name} [{m}, {k}] x [{k}, {n}]: max abs err {err:.3e} (scale "
                     f"{scale:.3e}), {ms * 1e3:.2f} us against {f32_ms * 1e3:.2f} us")
    print("[bf16] the bf16 GEMM with an fp32 result, the card's route against the fp32 product "
          "of the bf16 values: " + "; ".join(parts), flush=True)


def phase_bf16(data, cut, cfg: ModelConfig, tc: TrainConfig, dev: torch.device) -> dict:
    """bf16 compute (``compute_dtype="bfloat16"``) on every family: the
    card's GEMM route; the headline in ``bench.py``'s configuration (one
    epoch through ``fit`` and its test split against the fp32 headline of
    phase 8, B1 1812 / 186), config 1, config 3 (B2 2 a kernel a step) and
    HisRES on the cut data; each with ``bf16_three_steps``, the dtypes,
    and 10 steady steps and a profiled 3 beside its fp32 twin's."""
    from regcn_torch.utils.dtypes import tree_to_compute

    bf = torch.bfloat16
    gemm_route_check(dev)
    out = {}

    # the headline
    tag = "headline bf16"
    bf16_three_steps(tag, lambda d, dt: HyperbolicTrainer(
        headline_config(data, compute_dtype=dt, **NO_DROPOUT), tc, data, device=d),
        lambda tr, st, i: tr.train_step(st, *tr.window(i), tr._curvature_max(0)), dev)
    hcfg = headline_config(data, compute_dtype="bfloat16")
    trainer = HyperbolicTrainer(hcfg, tc, data, device=dev)
    state = trainer.init_state(SEED)
    order = trainer.epoch_order(0)
    expected = hcfg.n_layers * sum(min(i, tc.train_history_len) for i in order)
    info, epoch = fit_one_counted_epoch(trainer, state)
    launches, row = epoch["launches"], info["history"][0]
    check(launches["rgcn_scatter_sorted"] == expected and all(launches[k] == 0 for k in CE_KERNELS),
          f"{tag}: epoch launches {launches}, expected {expected} of B1 (as the fp32 epoch) and "
          "no CE kernel")
    n_test = len(trainer.test_list)
    stats, test_counts, test_s = counted_test(trainer, state,
                                              hcfg.n_layers * tc.test_history_len * n_test, tag)
    fp32 = EPOCHS["headline"]
    l16, l32 = row["losses"]["entity"], fp32["losses"]["entity"]
    m16, m32 = stats["ent_raw"].mrr, fp32["test"]["ent_raw"].mrr
    check(abs(l16 - l32) <= BF16_EPOCH_RTOL * abs(l32), f"{tag}: epoch entity loss {l16:.5f}, "
          f"fp32 {l32:.5f}: more than {BF16_EPOCH_RTOL:.0%} apart")
    check(abs(m16 - m32) <= BF16_MRR_ATOL, f"{tag}: test ent raw MRR {m16:.5f}, fp32 {m32:.5f}: "
          f"more than {BF16_MRR_ATOL} apart")
    print(f"[{tag}] epoch 0 in fit: {len(order)} steps in {epoch['seconds']:.2f} s; mean losses "
          + ", ".join(f"{k} {v:.5f}" for k, v in row["losses"].items())
          + f" (fp32 entity {l32:.5f}); launches {launches}; test split ({test_s:.1f} s, "
          f"{test_counts['rgcn_scatter_sorted']} B1 launches): MRR "
          + ", ".join(f"{k} {v.mrr:.6f}" for k, v in stats.items())
          + f" (fp32 ent_raw {m32:.6f})", flush=True)
    out[f"{tag} training epoch"], out[f"{tag} test split"] = launches, test_counts
    history, triples, mask = trainer.window(order[0])
    with torch.inference_mode():
        carry, _ = hyp_model.evolve(tree_to_compute(state.params, bf), hcfg,
                                    tree_to_compute(history, bf))
        scores = trainer._predict()(state.params, state.model_state, hcfg, history, triples, mask)
    bf16_dtypes(tag, carry, scores, state)
    cmax = trainer._curvature_max(1)
    steady = lambda i: trainer.train_step(state, *trainer.window(i), cmax)  # noqa: E731
    steady_order = trainer.epoch_order(1)[:BF16_STEADY_STEPS]
    t32 = HyperbolicTrainer(headline_config(data), tc, data, device=dev)
    s32 = t32.init_state(SEED)
    twin = (t32, lambda i: t32.train_step(s32, *t32.window(i), cmax))
    out[f"{tag} steady steps"] = bf16_speed(
        tag, "headline train step", trainer, steady, twin, steady_order,
        trainer.epoch_order(2)[:PROFILED_STEPS],
        b1=hcfg.n_layers * sum(min(i, tc.train_history_len) for i in steady_order))
    del trainer, state

    # config 1
    tag = "config-1 bf16"
    c1 = dataclasses.replace(cfg, dtype="bfloat16")
    make = lambda d, dt, **kw: loop.Trainer(  # noqa: E731
        ExperimentConfig(model=dataclasses.replace(cfg, dtype=dt, **kw), train=tc), data, device=d)
    bf16_three_steps(tag, lambda d, dt: make(d, dt, **NO_DROPOUT),
                     lambda tr, st, i: tr.train_step(st, *tr.window(i)), dev)
    trainer = make(dev, "bfloat16")
    state = trainer.init_state(SEED)
    history, triples, _ = trainer.window(trainer.epoch_order(0)[0])
    with torch.inference_mode():
        params16 = tree_to_compute(state.params, bf)
        carry, _ = recurrent.evolve(params16, c1, tree_to_compute(history, bf))
        scores = recurrent.predict(params16, state.model_state, c1,
                                   tree_to_compute(history, bf), triples)
    bf16_dtypes(tag, carry, scores, state)
    steady_order = trainer.epoch_order(1)[:BF16_STEADY_STEPS]
    t32 = make(dev, "float32")
    s32 = t32.init_state(SEED)
    out[f"{tag} steady steps"] = bf16_speed(
        tag, "config-1 train step", trainer,
        lambda i: trainer.train_step(state, *trainer.window(i)),
        (t32, lambda i: t32.train_step(s32, *t32.window(i))), steady_order,
        trainer.epoch_order(2)[:PROFILED_STEPS],
        b1=cfg.n_layers * sum(min(i, tc.train_history_len) for i in steady_order))
    del trainer, state

    # config 3 on the cut data (B2)
    tag = "config-3 bf16"
    tc3 = TrainConfig(train_history_len=3, test_history_len=3)
    make = lambda d, dt, **kw: HyperbolicTrainer(  # noqa: E731
        config3(cut, compute_dtype=dt, **kw), tc3, cut, curvature_warmup_epochs=5, device=d)
    bf16_three_steps(tag, lambda d, dt: make(d, dt, **NO_DROPOUT),
                     lambda tr, st, i: tr.train_step(st, *tr.window(i), tr._curvature_max(0)),
                     dev)
    trainer = make(dev, "bfloat16")
    state = trainer.init_state(SEED)
    c3 = trainer.cfg
    history, triples, mask = trainer.window(trainer.epoch_order(0)[0])
    with torch.inference_mode():
        carry, _ = hyp_model.evolve(tree_to_compute(state.params, bf), c3,
                                    tree_to_compute(history, bf))
        scores = trainer._predict()(state.params, state.model_state, c3, history, triples, mask)
    bf16_dtypes(tag, carry, scores, state)
    cmax = trainer._curvature_max(1)
    steady_order = trainer.epoch_order(1)[:BF16_STEADY_STEPS]
    t32 = make(dev, "float32")
    s32 = t32.init_state(SEED)
    out[f"{tag} steady steps"] = bf16_speed(
        tag, "train step", trainer, lambda i: trainer.train_step(state, *trainer.window(i), cmax),
        (t32, lambda i: t32.train_step(s32, *t32.window(i), cmax)), steady_order,
        trainer.epoch_order(2)[:PROFILED_STEPS], b2=2 * len(steady_order))
    del trainer, state

    # HisRES
    tag = "hisres bf16"
    tch = dataclasses.replace(tc, n_epochs=1)
    make = lambda d, dt, **kw: HisResTrainer(  # noqa: E731
        hisres_config(cut, compute_dtype=dt, **kw), tch, cut, device=d, **HISRES_TRAINER)
    bf16_three_steps(tag, lambda d, dt: make(d, dt, cand_dropout=0.0, **NO_DROPOUT),
                     lambda tr, st, i: tr.train_step(st, *tr.window(i)), dev)
    trainer = make(dev, "bfloat16")
    state = trainer.init_state(SEED)
    hc = trainer.cfg
    inputs = trainer.window(trainer.epoch_order(0)[0])
    with torch.inference_mode():
        from regcn_torch.hisres import model as hisres_model

        carry = hisres_model.forward(tree_to_compute(state.params, bf), hc,
                                     tree_to_compute(inputs[0], bf),
                                     tree_to_compute(inputs[1], bf))[0]
        scores = trainer.predict(state, *inputs)
    bf16_dtypes(tag, carry, scores, state)
    steady_order = trainer.epoch_order(1)[:BF16_STEADY_STEPS]
    t32 = make(dev, "float32")
    s32 = t32.init_state(SEED)
    out[f"{tag} steady steps"] = bf16_speed(
        tag, "hisres train step", trainer, lambda i: trainer.train_step(state, *trainer.window(i)),
        (t32, lambda i: t32.train_step(s32, *t32.window(i))), steady_order,
        trainer.epoch_order(2)[:PROFILED_STEPS],
        b1=sum(hisres_launches(hc, min(i, tc.train_history_len)) for i in steady_order))
    return out


# ------------------------------------------ native builder and cumsum

# impl="cumsum" against B1 at config 1's first test snapshot: the fp32
# running sum over the sorted messages is approximate (JAX measured ~6e-5
# relative at E = 4M); and its test MRRs against B1's from the same
# parameters (a near-tie may reorder)
CUMSUM_REL_TOL = 1e-4
CUMSUM_MRR_ATOL = 1e-2


def phase_native_cumsum(data, cfg: ModelConfig, tc: TrainConfig, dev: torch.device) -> dict:
    """The native snapshot builder, built from ``regcn_torch/csrc/graph_builder.cc``
    on this host: (a) its arrays equal numpy's for every snapshot of the
    three splits, and the time each takes; (b) config 1's rolling
    evaluation of the test split with each builder, the host ms per query
    snapshot spent building windows and the wall per snapshot, the same
    MRRs; (c) config 1 served with ``impl="cumsum"``: the aggregation's
    max relative error against B1, and the four MRRs beside B1's (no B1
    launch on the cumsum route); (d) ROADMAP C.8: with ``$CXX`` a missing
    program and a fresh build directory, the default builder warns once
    and gives numpy's arrays, and ``use_native=True`` raises."""
    import functools

    from regcn_torch.data import native
    from regcn_torch.data import snapshots as snapshots_mod
    from regcn_torch.data.snapshots import _ARRAY_FIELDS, _round_up

    t0 = time.perf_counter()
    path = native.build()
    print(f"[native] {os.path.relpath(path, ROOT)} ready in {time.perf_counter() - t0:.2f} s "
          f"(compiled by {native._compiler()} at first use in this run)", flush=True)
    times = {True: 0.0, False: 0.0}
    n_snaps = 0
    for split in ("train", "valid", "test"):
        for trip in split_by_time(getattr(data, split)):
            n = len(trip)
            pads = dict(edge_pad=_round_up(2 * n, tc.edge_bucket),
                        rc_pad=_round_up(4 * n, tc.rc_bucket))
            built = {}
            for use in (True, False):
                t0 = time.perf_counter()
                built[use] = build_snapshot(trip, cfg.num_ents, cfg.num_rels, use_native=use,
                                            **pads)
                times[use] += time.perf_counter() - t0
            for f in _ARRAY_FIELDS:
                a, b = getattr(built[True], f), getattr(built[False], f)
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"native builder: {f} of a {split} snapshot differs from numpy's")
            check(built[True].num_edges == built[False].num_edges, "native builder: num_edges")
            n_snaps += 1
    print(f"[native] (a) {n_snaps} snapshots of the three splits: every array equal to numpy's; "
          f"{times[True] / n_snaps * 1e3:.3f} ms a snapshot native, "
          f"{times[False] / n_snaps * 1e3:.3f} ms numpy", flush=True)

    params, state = recurrent.init_params(torch.Generator().manual_seed(SEED), cfg, device=dev)
    n_test = len(split_by_time(data.test))
    builder = snapshots_mod.build_history
    results = {}
    for use in (True, False):
        spent = [0.0]

        def timed_history(*a, _use=use, **kw):
            t0 = time.perf_counter()
            out = builder(*a, use_native=_use, **kw)
            spent[0] += time.perf_counter() - t0
            return out

        loop.build_history = timed_history
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stats = loop.test(params, state, cfg, tc, data, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            loop.build_history = builder
        results[use] = (stats, wall, spent[0])
    for key in results[True][0]:
        # the same arrays; the card's segment sums (index_add_) add in no fixed order
        check(abs(results[True][0][key].mrr - results[False][0][key].mrr) <= CLI_MRR_TOL,
              f"native builder: {key} MRR {results[True][0][key].mrr} differs from numpy's "
              f"{results[False][0][key].mrr}")
    print("[native] (b) config-1 test split, rolling evaluation with each builder: host ms per "
          "query snapshot building its window native "
          f"{results[True][2] / n_test * 1e3:.3f} / numpy {results[False][2] / n_test * 1e3:.3f};"
          f" wall per snapshot native {results[True][1] / n_test * 1e3:.2f} ms / numpy "
          f"{results[False][1] / n_test * 1e3:.2f} ms; the MRRs within {CLI_MRR_TOL:.0e}",
          flush=True)

    # (c) impl="cumsum"
    snap, _ = first_test_snapshot(data, dev)
    g = np.random.default_rng(SEED)
    h = torch.from_numpy(g.normal(size=(cfg.num_ents, cfg.h_dim)).astype(np.float32)).to(dev)
    rel = torch.from_numpy(g.normal(size=(cfg.num_rels_total, cfg.h_dim)).astype(np.float32)
                           ).to(dev)
    w = torch.from_numpy((g.normal(size=(cfg.h_dim, cfg.h_dim)) / math.sqrt(cfg.h_dim)
                          ).astype(np.float32)).to(dev)
    args = (h, rel, w, snap.src, snap.dst, snap.rel, snap.edge_mask, snap.in_deg_norm)
    exact = rgcn_aggregate(*args, dst_sorted=True)
    approx = rgcn_aggregate(*args, dst_sorted=True, impl="cumsum")
    rel_err = ((approx - exact).abs().max() / exact.abs().max().clamp(min=1e-30)).item()
    check(rel_err <= CUMSUM_REL_TOL, f"impl='cumsum' vs B1: max relative error {rel_err:.3e} > "
          f"{CUMSUM_REL_TOL:.0e}")
    reset_launches()
    stats_c = loop.test(params, state, cfg, tc, data, device=dev,
                        predict=functools.partial(loop.regcn_predict, impl="cumsum"))
    torch.cuda.synchronize()
    counts = read_launches()
    check(all(v == 0 for v in counts.values()), f"impl='cumsum' launched a kernel: {counts}")
    stats_b = results[True][0]
    for key, st in stats_c.items():
        check(math.isfinite(st.mrr) and abs(st.mrr - stats_b[key].mrr) <= CUMSUM_MRR_ATOL,
              f"impl='cumsum' {key} MRR {st.mrr:.6f} vs B1's {stats_b[key].mrr:.6f}")
    print(f"[native] (c) impl='cumsum' at config 1's first test snapshot: max relative error "
          f"{rel_err:.3e} against B1; test split MRR cumsum / B1 "
          + ", ".join(f"{k} {stats_c[k].mrr:.6f}/{stats_b[k].mrr:.6f}" for k in stats_c)
          + f"; launches {counts}", flush=True)
    native_fallback(data, cfg, tc)
    return {"config-1 test split, cumsum": counts}


def native_fallback(data, cfg: ModelConfig, tc: TrainConfig) -> None:
    """(d) of phase 20: a host without a C++ compiler (``$CXX`` a missing
    program, a fresh build directory): the first test snapshot built with
    the default ``use_native``, with one warning, equal to numpy's; a
    second build warns no more; ``use_native=True`` raises."""
    from regcn_torch.data import native

    trip = split_by_time(data.test)[0]
    kw = dict(edge_bucket=tc.edge_bucket, rc_bucket=tc.rc_bucket)
    want = build_snapshot(trip, cfg.num_ents, cfg.num_rels, use_native=False, **kw)
    saved = (os.environ.get("CXX"), native.BUILD_DIR, native._module, native._build_failures,
             native._warned)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["CXX"] = os.path.join(tmp, "no-such-compiler")
        native.BUILD_DIR, native._module = Path(tmp) / "build", None
        native._build_failures, native._warned = {}, [False]
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                got = build_snapshot(trip, cfg.num_ents, cfg.num_rels, **kw)
                build_snapshot(trip, cfg.num_ents, cfg.num_rels, **kw)
            try:
                build_snapshot(trip, cfg.num_ents, cfg.num_rels, use_native=True, **kw)
                raised = False
            except native.NativeBuildError:
                raised = True
        finally:
            cxx, native.BUILD_DIR, native._module, native._build_failures, native._warned = saved
            if cxx is None:
                os.environ.pop("CXX", None)
            else:
                os.environ["CXX"] = cxx
    from regcn_torch.data.snapshots import _ARRAY_FIELDS

    warned = [w for w in seen if issubclass(w.category, RuntimeWarning)]
    check(len(warned) == 1, f"native fallback: {len(warned)} warnings, expected 1")
    check(raised, "native fallback: use_native=True did not raise without a compiler")
    for f in _ARRAY_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"native fallback: {f} differs from numpy's")
    print(f"[native] (d) no C++ compiler ($CXX missing, a fresh build directory): the default "
          f"builder warned once ({str(warned[0].message)[:60]}...) and built numpy's arrays; "
          "use_native=True raised", flush=True)


# ------------------------------------------------ entity-sharded training

SHARDS = 2  # ranks sharing the one card over gloo
# the sharded epoch's and test split's MRRs against the single-process
# trainer's: both take the same steps with the same dropout draws, but the
# card's index_add_ and the cross-shard sums add in another order, and an
# epoch carries that apart
SHARDED_MRR_ATOL = 0.01
CARD = []  # nvidia-smi's name and power limit, as phase 1 read them
# the paths on config 2's data: the static entity-word graph, whose
# words_emb is row-sharded as the entity table is
STATIC_PATHS = ("config 2", "static headline", "hisres static")
SHARDED_TRIPLE_BATCH = 128  # config 3 triple-batched: the padded triples in chunks of 128
# paths whose epoch runs with every dropout at 0: with their dropouts config 5
# and HisRES with the static graph train chaotically on the card, one
# process's own test MRR moving by about SHARDED_MRR_ATOL or more between runs
# of the same epoch (without dropout it stays put;
# tools/static_spread_diagnosis.py), so no one process's run can stand for them
NOISY_PATHS = ("config 5", "hisres static")
# the (path, mode) runs of the sharded phase in three groups of SHARDS ranks
# each, side by side: config 1, the headline, config 3, HisRES, config 5
# (EST and TANS) and config 2 in both modes; config 3 triple-batched, the
# static headline and HisRES with the static graph under gspmd (JAX refuses
# triple batching under halo; the static layer is GSPMD's in both modes)
SHARDED_GROUPS = (
    (("config 1", "gspmd"), ("config 1", "halo"), ("headline", "gspmd"), ("headline", "halo"),
     ("config 3", "gspmd"), ("config 3", "halo"), ("hisres static", "gspmd")),
    (("hisres", "gspmd"), ("hisres", "halo"), ("config 5", "gspmd"), ("config 5", "halo"),
     ("config 2", "halo")),
    (("config 3 triple", "gspmd"), ("config 2", "gspmd"), ("static headline", "gspmd")),
)


def sharded_data():
    """synthetic-icews14s (seed 123) with its time axis cut to 40 snapshots
    split 30 / 5 / 5: the sharded phase's epochs are 29 steps."""
    return generate("synthetic-icews14s", seed=SEED, num_snaps=40, split=(30, 5, 5))


def sharded_static_data():
    """synthetic-icews05-15 (seed 123) with its static entity-word graph, its
    time axis cut to 40 snapshots split 30 / 5 / 5 as ``sharded_data``'s: of
    the repo's synthetic datasets with a static graph, the one whose entity
    count and word count (10488 and 5196 with numpy 2.0's generator; the
    words depend on numpy's version) both divide by 2 and 4, as a sharded
    words_emb needs, JAX's too."""
    return generate("synthetic-icews05-15", seed=SEED, with_static=True, num_snaps=40,
                    split=(30, 5, 5))


def sharded_configs(cut) -> tuple:
    """Config 1 at full width with buckets of 128, on the cut data."""
    return (ModelConfig(num_ents=cut.num_nodes, num_rels=cut.num_rels, h_dim=200, n_layers=2),
            TrainConfig(train_history_len=3, test_history_len=3, edge_bucket=128,
                        rc_bucket=128, triple_bucket=128))


def sharded_trainer(path: str, cut, dev, dropout: bool = True, **mesh_kw):
    """The trainer of a sharded phase's path at full width on its cut data
    (``mesh_kw``: ``mesh`` and ``dist_agg``, or nothing for one process):
    config 1, the headline (uvrgcn + tangent ConvTransE/R), config 3 (LGCN
    + RotH, learned c; ``config 3 triple`` in chunks of
    SHARDED_TRIPLE_BATCH triples, ``accumulate``), HisRES (``run_hisres``'s
    defaults), config 5 (the headline with EST and TANS), and with the
    static graph config 2, the static headline and HisRES, each with its
    dropouts or, without ``dropout`` or on NOISY_PATHS, every one at 0."""
    cfg1, tc = sharded_configs(cut)
    off = {} if dropout and path not in NOISY_PATHS else NO_DROPOUT
    if path == "config 1":
        return loop.Trainer(ExperimentConfig(model=dataclasses.replace(cfg1, **off), train=tc),
                            cut, device=dev, **mesh_kw)
    if path == "config 2":
        return loop.Trainer(ExperimentConfig(model=config2(cut, **off), train=tc), cut,
                            device=dev, **mesh_kw)
    static = (dict(use_static=True, num_static_rels=cut.num_static_rels,
                   num_words=cut.num_words) if path in STATIC_PATHS else {})
    if path.startswith("hisres"):
        off = off and dict(off, cand_dropout=0.0)
        return HisResTrainer(hisres_config(cut, **static, **off), tc, cut, device=dev,
                             **HISRES_TRAINER, **mesh_kw)
    if path.startswith("config 3"):
        triple = (dict(triple_batch_size=SHARDED_TRIPLE_BATCH, triple_batch_mode="accumulate")
                  if path == "config 3 triple" else {})
        return HyperbolicTrainer(config3(cut, **off), tc, cut, device=dev, **triple, **mesh_kw)
    config = config5 if path == "config 5" else headline_config
    return HyperbolicTrainer(config(cut, **static, **off), tc, cut, device=dev, **mesh_kw)


def trainer_parts(trainer) -> tuple:
    """(model config, train config) of any of the three trainers."""
    if isinstance(trainer, loop.Trainer):
        return trainer.cfg.model, trainer.cfg.train
    return trainer.cfg, trainer.tc


def step_inputs(trainer, i: int) -> list:
    """``loss``'s inputs after the state for the training step on window i:
    one tuple (with EST's retrieval batch and TANS COO for a hyperbolic
    trainer), or one per chunk of a triple-batched step."""
    if not isinstance(trainer, HyperbolicTrainer):
        return [trainer.window(i)]
    cmax = trainer._curvature_max(0)
    chunks = trainer.chunks(i) if trainer.triple_batch_size else []
    if chunks:
        history = trainer.window(i)[0]
        return [(history, tr, mk, cmax, rb, tans) for tr, mk, rb, tans in chunks]
    return [(*trainer.window(i), cmax, *trainer.est_window(i))]


def sharded_launches(path: str, trainer, order) -> tuple:
    """(B1, each B2 kernel) launches that one process takes on the steps of
    ``order``, and (B1) on the test split, from the data: 2 layers x each
    window's snapshots (HisRES: ``hisres_launches``), no B1 on config 3,
    whose B2 kernels launch twice a step, or with triple batching twice a
    chunk (a snapshot that fits one chunk is one step); B2 on no test
    split."""
    cfg, tc = trainer_parts(trainer)
    if path.startswith("config 3"):
        steps = (sum(len(trainer.chunks(i)) or 1 for i in order) if trainer.triple_batch_size
                 else len(order))
        return 0, 2 * steps, 0
    if path.startswith("hisres"):
        b1 = sum(hisres_launches(cfg, min(i, tc.train_history_len)) for i in order)
        test = hisres_launches(cfg, tc.test_history_len)
    else:
        b1 = cfg.n_layers * sum(min(i, tc.train_history_len) for i in order)
        test = cfg.n_layers * tc.test_history_len
    return b1, 0, test * len(trainer.test_list)


def radius_edge_keys(plain, sharded, i: int, mode: str) -> list:
    """The uvrgcn's radius-weight calls in a loss on window i, in order (each
    layer of each snapshot): (the one-process edges' keys src * N + dst,
    the rank's edges' keys), -1 on a masked edge, both on global ids, so
    that ``PinnedKinks.replay`` takes each rank edge's sign of r_src - r_dst
    from the same edge of the recorded run. Under the halo a source slot of
    the halo buffer is mapped back to its owner's row through the host
    partition's ``send_idx``."""
    from regcn_torch.parallel.halo import build_halo_store

    cfg, tc = trainer_parts(plain)
    shard, N = sharded.shard, plain.num_nodes
    hist, hs = plain.window(i)[0], sharded.window(i)[0]
    snaps = plain.train_list[max(0, i - tc.train_history_len):i]
    send = None
    if mode == "halo":
        store, _ = build_halo_store(snaps, N, plain.num_rels, shard.size,
                                    edge_bucket=tc.edge_bucket)
        send = torch.from_numpy(store.send_idx.astype(np.int64)).to(hist.src.device)
    out = []
    for t in range(hist.src.shape[0]):
        st = hist.step(t)
        rec = torch.where(st.edge_mask > 0, st.src.long() * N + st.dst.long(), -1)
        e = (hs.halo if mode == "halo" else hs.parts).step(t)
        src = e.src
        if send is not None:
            slot = (e.src - e.rows).clamp(min=0)
            g, p = slot // store.halo_per_pair, slot % store.halo_per_pair
            src = torch.where(e.src < e.rows, shard.row0 + e.src,
                              g * e.rows + send[t, g, shard.rank, p])
        mine = torch.where(e.edge_mask > 0, src * N + shard.row0 + e.dst, -1)
        out += [(rec, mine)] * cfg.n_layers
    return out


def memories_alike(tag: str, est_state, group) -> None:
    """Fails unless EST's replicated memories are bit-equal on every rank."""
    import torch.distributed as dist

    for name in ("fast", "slow"):
        mine = getattr(est_state, name).contiguous()
        every = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
        dist.all_gather(every, mine, group=group)
        check(all(torch.equal(every[0], m) for m in every[1:]),
              f"{tag}: EST's {name} memory differs between the ranks")


def sharded_three_steps(tag: str, path: str, cut, mesh, mode: str, dev: torch.device) -> None:
    """(a) of the sharded phase, in each rank: 3 steps of the sharded
    trainer against the single-process one on the card, from the same state
    before each (dropouts 0), the sharded run on rank 0's single run's
    branches at the kinks (the uvrgcn's radius-weight signs edge by edge):
    the losses, every gradient (the entity and word tables gathered) and the
    model state (BN statistics) of each chunk (one where the step is not
    triple-batched) within the 3-step checks' limits; with EST, after each
    write-back, the memories within TRAIN_GRAD_TOL of one process's and
    bit-equal on every rank; then both optimizers step with the single
    run's gradients (summed over the chunks), and every parameter (the
    tables gathered) within TRAIN_OPT_TOL. Every rank takes rank 0's
    single-run gradients, statistics and memories, so that the rows the
    ranks update come from one set of them."""
    import torch.distributed as dist

    from regcn_torch.parallel import sharding
    from regcn_torch.parallel.collectives import all_gather_rows

    t0 = time.perf_counter()
    plain = sharded_trainer(path, cut, dev, dropout=False)
    sharded = sharded_trainer(path, cut, dev, dropout=False, mesh=mesh, dist_agg=mode)
    shard = sharded.shard
    s_plain = plain.init_state(SEED)
    names = leaf_names(s_plain.params)
    uvrgcn = getattr(trainer_parts(plain)[0], "encoder", None) == "hyperbolic_uvrgcn"
    kinks = PinnedKinks()
    worst = {"loss": 0.0, "grad": 0.0, "bn": 0.0, "opt": 0.0, "est": 0.0}
    chunks = 0

    def err(a, b) -> float:
        return (a.detach() - b.detach()).abs().max().item() / max(1.0, b.abs().max().item())

    for i in plain.epoch_order(0)[:3]:
        s_sh = sharding.shard_state(train_state.copy_state(s_plain), shard)
        rules = sharding.state_sharding_rules(s_sh)
        keys = radius_edge_keys(plain, sharded, i, mode) if uvrgcn else None
        summed = None
        for inputs, inputs_s in zip(step_inputs(plain, i), step_inputs(sharded, i)):
            chunks += 1
            with kinks.record():
                total, parts, bn, *aux = plain.loss(s_plain, *inputs)
                grads = torch.autograd.grad(total, tree_leaves(s_plain.params),
                                            allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(tree_leaves(s_plain.params), grads)]
            # every rank's one-process run from rank 0's gradients, statistics
            # and branches: the card's index_add_ sums in no fixed order, so each
            # process's run may take another branch at a kink, and the sharded
            # optimizer's rows come from every rank's copy of them
            with torch.no_grad():
                for t in grads + model_state_leaves(bn):
                    dist.broadcast(t, src=0, group=shard.group)
            kinks.share(shard.group)
            with kinks.replay(shard, keys):
                total_s, parts_s, bn_s, *aux_s = sharded.loss(s_sh, *inputs_s)
                grads_s = sharding.sharded_grads(total_s, tree_leaves(s_sh.params),
                                                 [not r for r in rules], shard)
            for k, b in parts.items():
                a = float(parts_s[k].detach())
                b = float(b.detach())
                check(math.isfinite(a) and abs(a - b) <= TRAIN_LOSS_RTOL * max(1.0, abs(b)),
                      f"{tag}, step on snapshot {i}: {k} loss sharded {a} vs one process {b}")
                worst["loss"] = max(worst["loss"], abs(a - b) / max(1.0, abs(b)))
            for name, g, gs, r in zip(names, grads, grads_s, rules):
                with torch.no_grad():
                    whole = all_gather_rows(gs, shard.group) if r else gs
                e = err(whole, g)
                check(e <= TRAIN_GRAD_TOL, f"{tag}, step on snapshot {i}: {name} gradient "
                      f"sharded vs one process {e:.3e} > {TRAIN_GRAD_TOL:.0e} of its largest "
                      "entry")
                worst["grad"] = max(worst["grad"], e)
            for a, b in zip(model_state_leaves(bn_s), model_state_leaves(bn)):
                worst["bn"] = max(worst["bn"], err(a, b))
            check(worst["bn"] <= TRAIN_GRAD_TOL, f"{tag}, step on snapshot {i}: BN statistics "
                  f"sharded vs one process {worst['bn']:.3e} > {TRAIN_GRAD_TOL:.0e}")
            if s_plain.est_state is not None:  # the H-PES write-back of the chunk
                plain.est_update(s_plain, inputs[1], inputs[2], aux[0])
                sharded.est_update(s_sh, inputs_s[1], inputs_s[2], aux_s[0])
                memories_alike(f"{tag}, step on snapshot {i}", s_sh.est_state, shard.group)
                for name in ("fast", "slow"):
                    want = getattr(s_plain.est_state, name)
                    dist.broadcast(want, src=0, group=shard.group)
                    e = err(getattr(s_sh.est_state, name), want)
                    check(e <= TRAIN_GRAD_TOL, f"{tag}, step on snapshot {i}: EST's {name} "
                          f"memory sharded vs one process {e:.3e} > {TRAIN_GRAD_TOL:.0e}")
                    worst["est"] = max(worst["est"], e)
            s_plain.model_state = s_sh.model_state = bn
            summed = grads if summed is None else [a + g for a, g in zip(summed, grads)]
        plain.opt.step(tree_leaves(s_plain.params), summed, s_plain.opt_state)
        sharded.opt.shard(rules, shard.group)
        sharded.opt.step(tree_leaves(s_sh.params),
                         [sharding.rank_rows(g, shard) if r else g for g, r in zip(summed, rules)],
                         s_sh.opt_state)
        whole = sharding.unshard_state(s_sh, shard)
        for name, a, b in zip(names, tree_leaves(whole.params), tree_leaves(s_plain.params)):
            e = ((a.detach() - b.detach()).abs() / b.detach().abs().clamp(min=1.0)).max().item()
            check(e <= TRAIN_OPT_TOL, f"{tag}, step on snapshot {i}: {name} after the "
                  f"optimizer step sharded vs one process {e:.3e} > {TRAIN_OPT_TOL:.0e}")
            worst["opt"] = max(worst["opt"], e)
        s_plain.step += 1
    flips = kinks.check(tag)
    extra = (f", EST's memories after each write-back within {worst['est']:.2e} and bit-equal "
             "on every rank" if s_plain.est_state is not None else "")
    chunked = f" in {chunks} chunks" if chunks > 3 else ""
    print(f"[{tag}] (a) 3 steps{chunked} sharded vs one process on the card from the "
          f"same state, on its branches at the kinks "
          f"({flips.replace('on the cpu', 'in the sharded run')}): losses within "
          f"{worst['loss']:.2e}, every gradient within {worst['grad']:.2e} of its largest "
          f"entry, model state within {worst['bn']:.2e}{extra}, every parameter (the tables "
          f"gathered) after the optimizer step within {worst['opt']:.2e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def sharded_rank(rank: int, G: int, workdir: str, dev_type: str = "cuda", jobs=()) -> None:
    """One rank of the sharded phase: a gloo process group over a file
    store, the rank on cuda:0 beside the others, a 1 x G mesh; for each
    (path, ``dist_agg``) of ``jobs``: ``sharded_three_steps``, then one
    epoch with the config's dropouts (with EST, the memories after it
    bit-equal on every rank) and the test split, the kernels' launches
    counted around each against one process's (each process counts its
    own); the results into ``workdir``. A failed check exits the rank
    non-zero. ``dev_type="cpu"`` rehearses it without a card."""
    import datetime

    import torch.distributed as dist

    from regcn_torch.parallel.mesh import MeshAxes, make_mesh

    cuda = dev_type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", world_size=G,
                            rank=rank, timeout=datetime.timedelta(seconds=300))
    cuts = {False: sharded_data(), True: sharded_static_data()}
    mesh = make_mesh(MeshAxes(1, G), device_type=dev.type)
    out = {}
    for path, mode in jobs:
        cut = cuts[path in STATIC_PATHS]
        tag = f"sharded {path} {mode} rank {rank}"
        sharded_three_steps(tag, path, cut, mesh, mode, dev)
        trainer = sharded_trainer(path, cut, dev, mesh=mesh, dist_agg=mode)
        state = trainer.init_state(SEED)
        order = trainer.epoch_order(0)
        b1, b2, b1_test = sharded_launches(path, trainer, order)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        losses = trainer.run_epoch(state, 0)
        if cuda:
            torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        epoch_counts = read_launches()
        check(all(math.isfinite(v) for v in losses.values()), f"{tag}: epoch losses {losses}")
        check(epoch_counts["rgcn_scatter_sorted"] == b1
              and all(epoch_counts[k] == b2 for k in CE_KERNELS),
              f"{tag}: epoch launches {epoch_counts}, expected {b1} of B1 and {b2} of each "
              "B2 kernel, as one process launches")
        if state.est_state is not None:
            memories_alike(f"{tag}, after the epoch", state.est_state, trainer.shard.group)
        reset_launches()
        t0 = time.perf_counter()
        stats = trainer.test(state)
        if cuda:
            torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_counts = read_launches()
        check(test_counts["rgcn_scatter_sorted"] == b1_test
              and all(test_counts[k] == 0 for k in CE_KERNELS),
              f"{tag}: test split launches {test_counts}, expected {b1_test} of B1")
        out[f"{path} {mode}"] = dict(
            losses=losses, mrr={k: v.mrr for k, v in stats.items()}, epoch=epoch_counts,
            test=test_counts, epoch_s=epoch_s, test_s=test_s, steps=len(order),
            expected=[b1, b2, b1_test],
            peak_mib=torch.cuda.max_memory_allocated() / 2**20 if cuda else 0.0)
        del trainer, state
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_sharded(dev: torch.device, groups=SHARDED_GROUPS) -> dict:
    """The paths of ``groups`` at full width, entity-sharded (each trainer
    with ``mesh=..., dist_agg=...``) over SHARDS gloo ranks that share the
    card, on the cut data (``sharded_data``; the static graph's paths on
    ``sharded_static_data``): the halo's boundary statistics of each cut's
    training split; each group's ranks (``sharded_rank``), the groups side
    by side, and meanwhile each single-process trainer's epoch (the config's
    dropouts) and test split as the reference; each rank's MRRs within
    SHARDED_MRR_ATOL of the reference, its launches as one process's, its
    peak memory and walls printed. gloo stages every collective through
    the host, so the walls say nothing of speed."""
    from regcn_torch.parallel.halo import build_halo_store

    jobs = [job for group in groups for job in group]
    paths = list(dict.fromkeys(path for path, _ in jobs))
    cuts = {False: sharded_data(), True: sharded_static_data()}
    for static, cut in cuts.items():
        if static:
            check(cut.num_nodes % SHARDS == 0 and cut.num_words % SHARDS == 0,
                  f"sharded phase: the static data's {cut.num_nodes} entities and "
                  f"{cut.num_words} words do not both divide by {SHARDS}")
        tc = sharded_configs(cut)[1]
        _, stats = build_halo_store(split_by_time(cut.train), cut.num_nodes, cut.num_rels,
                                    SHARDS, edge_bucket=tc.edge_bucket)
        print(f"[sharded] halo of the training split of {'the static' if static else 'the'} "
              f"cut data ({cut.num_nodes} entities"
              + (f", {cut.num_words} words" if static else "")
              + f") at G = {SHARDS}: boundary rows "
              f"{stats['boundary_fraction_of_N_mean']:.3f} of N on average (max "
              f"{stats['boundary_fraction_of_N_max']:.3f}), halo rows per shard "
              f"{stats['halo_rows_per_shard']} against the all-gather's "
              f"{stats['allgather_rows_per_shard']} (ratio "
              f"{stats['volume_ratio_vs_allgather']:.3f})", flush=True)
    t0 = time.perf_counter()
    # each group's SHARDS ranks in a process group of their own, the groups
    # side by side: gloo stages every collective through the host, so one
    # group alone leaves most of the host's cores and the card idle
    with tempfile.TemporaryDirectory() as root:
        spawned = []
        for g, group in enumerate(groups):
            workdir = os.path.join(root, str(g))
            os.makedirs(workdir)
            spawned.append((workdir, torch.multiprocessing.start_processes(
                sharded_rank, args=(SHARDS, workdir, dev.type, group), nprocs=SHARDS,
                join=False, start_method="spawn")))
        # the single-process references while the ranks run: nothing of
        # theirs waits for them
        ref = {}
        for path in paths:
            single = sharded_trainer(path, cuts[path in STATIC_PATHS], dev)
            state = single.init_state(SEED)
            t1 = time.perf_counter()
            losses = single.run_epoch(state, 0)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t1
            ref[path] = {k: v.mrr for k, v in single.test(state).items()}
            print(f"[sharded] {path}, one process: epoch of {len(single.epoch_order(0))} steps "
                  f"in {epoch_s:.2f} s, mean losses "
                  + ", ".join(f"{k} {v:.5f}" for k, v in losses.items())
                  + "; test MRR " + ", ".join(f"{k} {v:.6f}" for k, v in ref[path].items()),
                  flush=True)
            del single, state
        try:
            for _, ctx in spawned:
                while not ctx.join():
                    pass
        except Exception as e:  # a rank failed a check or raised
            fail(f"sharded phase: {type(e).__name__}: {e}")
        ranks = [{} for _ in range(SHARDS)]
        for workdir, _ in spawned:
            for r in range(SHARDS):
                with open(os.path.join(workdir, f"rank{r}.json")) as f:
                    ranks[r].update(json.load(f))
    wall = time.perf_counter() - t0
    out = {}
    for path, mode in jobs:
        key = f"{path} {mode}"
        for r, res in enumerate(ranks):
            row = res[key]
            for k, v in ref[path].items():
                check(abs(row["mrr"][k] - v) <= SHARDED_MRR_ATOL,
                      f"sharded {key} rank {r}: test {k} MRR {row['mrr'][k]:.6f}, one "
                      f"process {v:.6f}: more than {SHARDED_MRR_ATOL} apart")
            b1, b2, b1_test = row["expected"]
            print(f"[sharded] {key} rank {r}: epoch of {row['steps']} steps in "
                  f"{row['epoch_s']:.2f} s ({row['epoch_s'] / row['steps'] * 1e3:.1f} ms a "
                  "step), mean losses "
                  + ", ".join(f"{k} {v:.5f}" for k, v in row["losses"].items())
                  + f"; B1 {row['epoch']['rgcn_scatter_sorted']} (one process: {b1}) and each "
                  f"B2 kernel {row['epoch'][CE_KERNELS[0]]} (one process: {b2}) in the epoch, "
                  f"B1 {row['test']['rgcn_scatter_sorted']} (one process: {b1_test}) on the "
                  f"test split ({row['test_s']:.2f} s); test MRR "
                  + ", ".join(f"{k} {v:.6f}" for k, v in row["mrr"].items())
                  + f"; peak memory {row['peak_mib']:.0f} MiB", flush=True)
        out[f"sharded {key} epoch (each rank)"] = ranks[0][key]["epoch"]
        out[f"sharded {key} test split (each rank)"] = ranks[0][key]["test"]
    print(f"[sharded] {SHARDS} ranks a group on one card over gloo, {len(groups)} groups side "
          f"by side, {len(jobs)} runs of {len(paths)} paths, {wall:.1f} s with the spawn "
          f"({CARD[0] if CARD else 'card not read'}); the MRRs "
          f"within {SHARDED_MRR_ATOL} of one process's", flush=True)
    return out


def config3_data():
    """synthetic-icews14s (seed 123) with its time axis cut to 120
    snapshots split 100 / 10 / 10: the epochs of config 3, config 4 and
    the options phase are 99 steps."""
    return generate("synthetic-icews14s", seed=SEED, num_snaps=120, split=(100, 10, 10))


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
    launches, serving = timed("config-1 test split", phase_main_path, data, cfg, tc, dev)
    by_path = {"config-1 test split": dict(launches)}
    timing.update(timed("streaming-CE kernels", phase_ce_kernels, cfg.num_ents, cfg.num_rels,
                        cfg.h_dim, dev))
    cut = config3_data()
    ce_widths = timed("streaming-CE widths", phase_ce_widths, cfg.num_ents, cut, dev)
    by_path["config-3 training epoch"] = timed("config-3 training", phase_training,
                                               config3_data(), dev)
    by_path["config-1 training epoch"] = timed(
        "config-1 training", phase_config1_training, data, cfg, tc, dev, serving["ent_raw"].mrr)
    headline = timed("hyperbolic headline training", phase_headline_training, data, tc, dev)
    by_path.update(headline)
    config4_paths, config4_times = timed("config-4 training", phase_config4_training, cut, tc,
                                         dev)
    by_path.update(config4_paths)
    by_path.update(timed("config-5 training", phase_headline_training, gdelt_data(), tc, dev,
                         config5, "config5"))
    data18 = icews18_data()
    by_path.update(timed("config-2 training", phase_config2_training, data18, dev))
    by_path.update(timed("static headline training", phase_static_headline, data18, dev))
    del data18
    by_path.update(timed("hyperbolic trainer options", phase_hyperbolic_options, cut, tc, dev,
                         cfg))
    by_path.update(timed("hisres training", phase_hisres_training, cut, tc, dev))
    by_path.update(timed("fhnn and hgat encoders", phase_hyperbolic_encoders, cut, tc, dev))
    by_path.update(timed("cli train and test", phase_cli_train_test, dev))
    entity_paths, entity_times, entity_err = timed("cli entity", phase_entity, dev)
    by_path.update(entity_paths)
    grid_paths, folded_times, folded_err = timed("cli grid --vectorize", phase_vectorized_grid,
                                                 data, dev)
    by_path.update(grid_paths)
    by_path.update(timed("hyperbolic grid --vectorize", phase_vectorized_hyperbolic, cut, tc,
                         dev))
    by_path.update(timed("bf16 compute", phase_bf16, data, cut, cfg, tc, dev))
    by_path.update(timed("native builder and cumsum", phase_native_cumsum, data, cfg, tc, dev))
    by_path.update(timed("entity-sharded training", phase_sharded, dev))
    launches.update({k: by_path["config-3 training epoch"][k] for k in CE_KERNELS})
    for k in CE_KERNELS:
        timing[k]["shapes"] = [config4_times[k]] + ce_widths[k]
    b1 = timing["rgcn_scatter_sorted"]
    b1["shapes"] += entity_times + [folded_times]
    b1["max_abs_err"] = max(b1["max_abs_err"], entity_err, folded_err)
    rows = [dict(name=k["name"], route=k["route"], source=k["source"], replaces=k["replaces"],
                 launches=launches[k["name"]], **timing[k["name"]],
                 launches_by_path={p: n[k["name"]] for p, n in by_path.items()})
            for k in KERNELS]
    print(f"[phase] total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
