#!/usr/bin/env python3
"""Smoke test of itrails_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one result line each (every line starts with the card's name and
power limit):

1. build: compile kernels K1 (``itrails_tpu_torch/csrc/fwd.cu``), K2
   (``csrc/grad.cu``), K3 (``csrc/viterbi.cu``), K4
   (``csrc/posterior.cu``), K5 (``csrc/operators.cu``) and K6 with its
   entry scan (``csrc/maxplus.cu``) with nvcc for
   sm_90a, all at once, and print their registers, shared memory and
   spills; the SASS of the row kernels of K1 and K5 (``csrc/rows.cuh``):
   DMMA in every f64 instantiation, none in an f32 one, one block barrier
   in each;
2. K1 and then K2 against their plain PyTorch versions (f64, on the card)
   on the 3x3 model (M=27, 4096 x 8192 tokens) and the 7x7 model (M=133,
   1024 x 2048), built on the card, with ragged PAD tails and all-PAD
   windows; time, launches and the card's least time for the same work;
   K1 in f32 and in f64 (per-window loglik at rtol 1e-10), also on the
   optimize CLI's bucket shape (100 x 10112 at M=27), with the SM clocks a
   column of one tile take at the card's top SM clock, its registers and
   its tile;
   then K3 against its f32 plain version on the card at the same shapes
   and on a batch with exact ties (two exchangeable states), paths equal
   exactly, with its peak pointer-table bytes; then K4 against its f64
   plain version on the card at the same shapes, every non-PAD entry at
   atol 2e-5 and every non-PAD column's posterior summing to 1 within
   1e-5, with its peak device bytes, and K4 in f64 against the same
   reference at atol 1e-10; then K4's error on tokens simulated from the
   3x3 model with its recombination rate scaled down, so that one state's
   runs grow from ~630 columns to ~63,000: in f64 gated at atol 2e-5, in
   f32 (no gate) split into the f32 rounding of the tables and K4's f32
   arithmetic; then K5 against its plain version in f64 on the same f32
   tables, on the card, at M=27 and M=133, on the 313 chunks of 1,024
   columns of a 320 kb block simulated from each model, with PAD runs, an
   all-PAD chunk and a PAD tail: operators at atol 5e-5, log scales at
   rtol 1e-6 (and, no gate, the f32 rounding of the tables' own part),
   and K5 on the f64 tables against the plain version on them at 1e-10,
   each beside a cuBLAS yardstick (one (C M, M) @ (M, M) product times the
   chunk's columns) and the rows kernel's registers;
   then K2 on the chunk windows of a simulated 320 kb block at each model,
   entered and left through boundary rows, against its plain version in
   f64 with the same rows: loglik rtol 1e-6, every gradient entry rtol
   2e-3; then the Viterbi route's kernels on the 625 chunks of 512 columns
   of a simulated 320 kb block at each model, each against its plain
   version on the card, bit for bit: K6's max-plus operators and their
   offsets, the entry scan's omegas, and K3's forward over the chunk
   windows, its entry map, the chain and its backtrack; then K1 and K5 at
   M=36, the introgression model's 3x3 width, in f64 on tokens simulated
   from it (K1 on the CLI's bucket shape, K5 on a 320 kb block's 625
   chunks of 512 columns), each against its f64 plain version at rtol
   1e-10 and timed beside its bound;
3. the value-only path: ``itrails_tpu_torch.cli.optimize.main --no-grad``
   (Nelder-Mead) at 3x3 on a MAF simulated from the 3x3 model (1.32 M
   columns: 100 blocks of 10 kb and one 320 kb block), at its default
   ``--precision float64`` (K1 and K5 in f64), with K1's and K5's launch
   counters reset just before and read just after: K1 runs the bucket and
   K5 the long block, which launches no K1; evaluation 0 held against the
   f64 plain version at rtol 1e-10; then ``--no-grad`` with
   ``settings.method: L-BFGS-B`` (scipy's finite differences) on the card,
   its start point and its one step in each coordinate against the same
   CLI with ``--device cpu`` (started in a process of its own, on the MAF
   simulated before phase 2, so that it overlaps the card's phases 2 and
   3, stopped after the rows compared, and checked after phase 5): the
   same points, and every finite difference within 1e-6 nats of the
   CPU's;
3b. the introgression value path:
   ``itrails_tpu_torch.cli.int_optimize.main`` at the full width of
   ``examples/example_config_int.yaml`` (3x3, M=36, nine parameters free)
   on a MAF simulated from the 3x3 int model in phase 3's layout: its
   default (exact gradients, not ported for this model) refused before any
   launch or artifact; Nelder-Mead with K1's and K5's counters reset just
   before and read just after (K1 once a bucket, K5 once for the long
   block an evaluation), the history one row an evaluation, evaluation 0
   against the f64 plain versions on the card at rtol 1e-10,
   ``hidden_states.csv`` (36 states, 9 of them V4) and
   ``observed_states.csv`` (256 tokens); ``--no-grad`` with
   ``settings.method: L-BFGS-B``; an evaluation's seconds split into build
   and decode; then (after phase 5) both runs against the same CLI with
   ``--device cpu``, started in processes of their own before phase 2 as
   phase 3's: Nelder-Mead's initial simplex at the same points within rtol
   1e-10, and every finite difference within 1e-6 nats of the CPU's;
4. the main path, the CLI's default: exact-gradient L-BFGS-B on the same
   MAF, with K2's call counter and K1's and K5's launch counters reset just
   before and read just after (the long block through the chunk route: K5
   once and one K2 call over its chunk windows an evaluation, every K2
   call's windows shorter than the block; no K1 launch),
   evaluation 0's value and gradient held against the plain version (f64;
   the long block walked as one window on the CPU, where its 320,000 small
   steps run faster than on the card), and K2 on the bucket and the chunk
   route on the long block against their plain versions in f64 on the card;
5. genome scale: ``LoglikEngine`` on 33.5 M simulated columns (4096 x
   8192), seconds per evaluation split into build and decode for the
   value, and into build, decode (K2) and build backward for the gradient;
6. the Viterbi path: ``itrails_tpu_torch.cli.viterbi.main`` at 3x3 on
   phase 3's MAF with phase 4's ``.best_model.yaml`` as its config (so
   optimize -> decode end to end), with K3's and K6's counters reset just
   before and read just after (the short blocks one K3 call of two
   launches; the 320 kb block through the route ``longseq.viterbi_long``,
   one launch each of K6, the scan, and K3's forward, entry map, chain and
   backtrack, and no one-window K3 call); its ``viterbi.csv`` must be byte-identical to the
   one ``--device cpu --precision float32`` (K3's plain version) writes,
   the 320 kb block included, and the columns where it differs from the
   ``--precision float64`` CPU path are counted, with their f64 margin;
7. the segmented route, off the CLI's path and the long-block routes'
   reference: ``decoders.viterbi_segmented`` on the 320 kb block in
   65,536-column segments must equal its one-pass path;
8. the posterior path: ``itrails_tpu_torch.cli.posterior.main`` at 3x3 on
   phase 3's MAF with phase 4's ``.best_model.yaml``, at its default
   ``--precision float64`` (K4 and K5 in f64), with K4's and K5's counters
   reset just before and read just after: the short blocks' window groups
   take two K4 launches each, the 320 kb block goes through the
   sequence-parallel route (``longseq.posterior_long_pieces``: K5 twice and
   one K4 call over its chunk windows a group of chunks), and no K4 call
   walks more than 262,144 columns; every column of every block it writes
   held against the f64 plain version at atol 1e-10 (the long block's
   one-window walk on the CPU, in a process of its own while the card runs
   the CLI), the CSV's header and row count checked and rows of every block
   read back as the card's values; seconds split into decode and write;
9. the route in groups: the 320 kb block with the operator budget, then
   the store budget, lowered to five groups, within 1e-12 of phase 8's
   one-group rows, with launch counts and peak device memory; and the
   segmented reference ``decoders.posterior_segmented`` in 65,536-column
   segments, bit for bit the one-window K4 rows of the block;
10. the long-block value: phase 3's 320 kb block and a 1e7-column block
   simulated from the 3x3 model, and a 320 kb block simulated from the 7x7
   model, each through K5 and the operator product, K1 as a one-window
   batch (one row of a tile) and (the 320 kb blocks) K2 as a one-window
   batch on f32 tables,
   every value within rtol 1e-6 of the f64 plain operator path on the
   card, and through K5 and the operator product on the f64 tables within
   rtol 1e-10, with each route's milliseconds and the K5 route's peak
   device memory;
11. the long-block gradient: the chunk route (K5, the boundary rows, one
   K2 call) on f32 tables on phase 3's 320 kb block, a 320 kb block
   simulated from the 7x7 model and 1e7 columns simulated from the 3x3
   model, against its f64 plain version on the card (loglik rtol 1e-6,
   every gradient entry rtol 2e-3), with its milliseconds and peak device
   memory, and K2's one-window walk timed on the 3x3 320 kb block; then,
   on the 320 kb blocks, K5, the boundary rows and K2 timed apart at chunks
   of 256, 512 and 1,024 columns;
12. the long-block posterior in f64: the route on phase 3's 320 kb block
   and a 320 kb block simulated from the 7x7 model against K4 walking the
   block as one window on the card (and, at 3x3, the route's plain version)
   at atol 1e-10, on f32 tables against the f64 plain version at 2e-5
   (3x3), with its milliseconds and peak device memory; its stages (K5 on
   a, K5 on a^T, the boundary rows, K4 on the chunk windows, the rows to the
   host) timed apart at chunks of 256, 512 and 1,024 columns; and 1e7
   columns simulated from the 3x3 model against
   ``decoders.posterior_segmented`` on the card at atol 1e-10; K4's f32
   arithmetic gated at the card's earlier readings on the 7x7 block;
13. the long-block Viterbi path: the route (K6, the entry scan, K3's
   forward over the chunk windows, its entry map, the chain, its
   backtrack) on f32 tables on phase 3's 320 kb block, the same block on
   the 3x3 model with two exchangeable states, and a 320 kb block
   simulated from the 7x7 model, against one-window K3 on the card (exact
   at 3x3, ties included; at 7x7 exact, or every differing run's f64
   score margin printed and below 1e-4 nats) and, at 3x3, the route's
   plain version on the card (exact), with its milliseconds and peak
   device memory, its stages timed apart; and 1e7 columns simulated from
   the 3x3 model against ``decoders.viterbi_segmented`` on the card,
   exactly.

Any failure exits non-zero.  The last two lines are the kernels' JSON
record and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
STARTED = time.perf_counter()  # the run's start, host clock

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_F64_FLOPS = 67e12  # on the FP64 tensor cores, full IEEE f64
PEAK_BYTES = 3.35e12
SPECIES = ["hg38", "panTro5", "gorGor5", "ponAbe2"]
# mu-scaled start point of examples/example_config.yaml (t_1 case)
START = dict(t_1=2.4e-3, t_2=4e-4, t_upper=7.450693855e-3, N_AB=5e-4,
             N_ABC=5e-4, r=1.0)
# phase 2: (label, n_int_AB, n_int_ABC, windows, columns), for K1 and K2
K1_SHAPES = [("3x3", 3, 3, 4096, 8192), ("7x7", 7, 7, 1024, 2048)]
# phase 2: K1 on the optimize CLI's bucket of phase 3 (100 blocks of 10 kb,
# packed to a multiple of 128 columns)
K1_BUCKET = ("3x3 CLI bucket", 3, 3, 100, 10_112)
# phase 3: short blocks, their length, and how many more such rows are
# joined into the one long block (32 x 10 kb = 320 kb > 262,144)
CLI_LAYOUT = (100, 10_000, 32)
# phase 5: windows x columns
GENOME = (4096, 8192)
# K2's gradients against the plain version, per entry: f32 normalizers and
# sums over T steps
GRAD_RTOL = 2e-3
# phase 2: K3 on a 3x3 model with two exchangeable states, windows x columns
TIE_SHAPE = (512, 2048)
# phases 7 and 9: the segment length the 320 kb block gets in
# viterbi_segmented and posterior_segmented
SEGMENT_COLS = 65_536
# phase 2: K4 against its f64 plain version, per non-PAD entry, as
# tests/test_pallas_fwd.py:78 holds the TPU kernel against the scan
POST_ATOL = 2e-5
# K4 in f64 (phases 2 and 8) against the f64 plain version: the same
# recursion in another summation order
POST64_ATOL = 1e-10
# phases 2, 10 and 11: the length of the CLI's long block; phase 10's
# and phase 11's simulated 1e7-column block, windows x columns joined
LONG_BLOCK = 320_000
LONG_SIM = (1000, 10_000)
# phases 11 and 12: the chunk lengths of the long-block routes that are timed
ROUTE_CHUNKS = (256, 512, 1024)
# phase 2: K5 against its plain version in f64 on the same f32 tables:
# operators (max entry 1) and log scales, at the tolerance of the port's
# CPU test against the Pallas operator kernel
OPS_ATOL, LOGZ_RTOL = 5e-5, 1e-6
# K1 and K5 on f64 tables (the optimize CLI's value path at its default,
# --precision float64) against their plain versions in f64: the same
# recursion in another summation order.  K1's per-window loglik relative
# to max(|loglik|, 1), K5's operators absolute and log scales relative.
VALUE64_RTOL = 1e-10
# phase 3's finite differences: each difference f(x + h e_j) - f(x) of the
# card's f64 value path against the CPU's, in nats.  A step moves a
# 1.32 M-column loglik by ~1e-3 nats; f64 rounding of the ~2e6-nat total
# is ~1e-10 nats, f32 rounding ~1e-2
FD_ATOL = 1e-6
# phases 10 and 11: each route's long-block value against the f64 plain one
LONG_RTOL = 1e-6
# phase 13: a path of the Viterbi route that departs from one-window K3
# must lose or win by less than this many nats (f64 score of each run of
# differing columns)
VITERBI_MARGIN = 1e-4
# phase 2: K4's f32 error as one state's runs grow: the recombination rates
# (START's r scaled) and the windows x columns simulated from each model
RUN_RATES = (1.0, 0.1, 0.01)
RUN_SHAPE = (64, 32_768)
# phase 3b: examples/example_config_int.yaml, the introgression model at
# its full width (3x3, M = 36), all nine parameters free
INT_MU = 1e-8
INT_CONFIG = {
    "fixed_parameters": {"mu": INT_MU, "t_out": 1000000},
    "optimized_parameters": {
        "N_AB": [50000, 5000, 500000], "N_BC": [40000, 4000, 400000],
        "N_ABC": [50000, 5000, 500000], "t_1": [240000, 24000, 2400000],
        "t_2": [40000, 4000, 400000], "t_m": [80000, 8000, 800000],
        "t_upper": [745069.3855, 74506.9385, 7450693.8556],
        "r": [1e-8, 1e-9, 1e-7], "m": [0.1, 0.001, 0.99]},
    "settings": {"species_list": SPECIES, "n_int_AB": 3, "n_int_ABC": 3},
}
# the f64 posterior of one block, on the CPU (phase 8's long block)
POSTERIOR_REF = (
    "import sys\n"
    "import numpy as np\n"
    "import torch\n"
    "from itrails_tpu_torch.cli import decode\n"
    "from itrails_tpu_torch.cli.common import prepare_decode_setup\n"
    "from itrails_tpu_torch.config import load_config\n"
    "from itrails_tpu_torch.hmm import cuda_posterior\n"
    "torch.set_num_threads(1)\n"
    "config, tokens, out = sys.argv[1:]\n"
    "_, a, bfull, pi = decode.build(\n"
    "    prepare_decode_setup(load_config(config)), 'float64', 'cpu')\n"
    "tok = torch.as_tensor(np.load(tokens))[None, :]\n"
    "post, _ = cuda_posterior.posterior_fused_plain(a, bfull, pi, tok)\n"
    "np.save(out, post[:, 0, :].numpy())\n")


# processes started by a phase and waited for by a later one; main() stops
# any that is still running when it returns
RUNNING = []


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def sm_clock_mhz():
    """The card's top SM clock in MHz (nvidia-smi's clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` launches, warmed."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def start_params(n_ab, n_abc, introgression=False, **change):
    """The resolved, mu-scaled parameters of START, or with
    ``introgression`` of INT_CONFIG's start point (with ``change``)."""
    from itrails_tpu_torch.optim.cases import (
        resolve_times,
        resolve_times_introgression,
    )

    if not introgression:
        return resolve_times(frozenset(["t_1"]), dict(
            START, n_int_AB=n_ab, n_int_ABC=n_abc, **change))
    d = {k: (v[0] if isinstance(v, list) else v)
         for k, v in INT_CONFIG["optimized_parameters"].items()}
    d = {k: (v if k == "m" else v / INT_MU if k == "r" else v * INT_MU)
         for k, v in d.items()}
    d["t_out"] = INT_CONFIG["fixed_parameters"]["t_out"] * INT_MU
    return resolve_times_introgression(frozenset(["t_1"]), dict(
        d, n_int_AB=n_ab, n_int_ABC=n_abc, **change))


def build_tables(n_ab, n_abc, dev, d=None, introgression=False):
    """(a, bfull, pi, b), contiguous, in f64 on ``dev`` from the port's own
    builder, or with ``introgression`` its int builder, at the resolved
    parameters ``d`` (default: the start point; floats, or 0-d tensors
    that require grad)."""
    from itrails_tpu_torch.core.model import build_model_fn
    from itrails_tpu_torch.data.tokens import aggregation_matrix
    from itrails_tpu_torch.hmm import decoders
    from itrails_tpu_torch.introgression.builder import (
        build_model_introgression_fn,
    )

    d = start_params(n_ab, n_abc, introgression) if d is None else d
    if introgression:
        builder, names = build_model_introgression_fn, (
            "t_A", "t_B", "t_C", "t_2", "t_upper", "t_out", "t_m", "N_AB",
            "N_BC", "N_ABC", "r", "m")
    else:
        builder, names = build_model_fn, (
            "t_A", "t_B", "t_C", "t_2", "t_upper", "t_out", "N_AB", "N_ABC",
            "r")
    a, b, pi, _, _ = builder(n_ab, n_abc, device=dev)(*(d[k] for k in names))
    bfull = decoders.emission_table(b, aggregation_matrix())
    return a.contiguous(), bfull.contiguous(), pi.contiguous(), b


def k1_bound_ms(m, tokens, size=4):
    """Least time of K1's work on these inputs: the larger of its bytes
    (each input read once, each output written once) over the memory rate
    and its operations over the peak for their type (``size`` 4: f32, 8:
    f64).  Work is counted for the non-PAD columns 1..T-1, the ones the
    recurrence updates: 2*M^2 for the product plus 3*M for the emission
    product, the sum and the division.  Bytes: the tables, the tokens, the
    column-0 alpha in and the final alpha out, the loglik out in f64."""
    w, t = tokens.shape
    steps = int((tokens[:, 1:] >= 0).sum())
    ops = steps * (2 * m * m + 3 * m)
    nbytes = size * (m * m + 625 * m + m + 2 * w * m) + 4 * w * t + 8 * w
    by_ops = ops / (PEAK_F32_FLOPS if size == 4 else PEAK_F64_FLOPS)
    by_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def k2_bound_ms(m, tokens):
    """Least time of K2's function on these inputs, counted as for K1: per
    non-PAD column 1..T-1 the three M x M products the function needs (the
    forward, a v and the dA outer product, 6*M^2) and 14*M for the emission
    products, the normalizers and the dB row; K2's recompute of the forward
    is a cost of its checkpoint design and is not counted.  Bytes: the
    inputs read once (a, bfull, pi, tokens) and the outputs written once
    (the per-window loglik, dA, dbfull, dpi)."""
    w, t = tokens.shape
    steps = int((tokens[:, 1:] >= 0).sum())
    ops = steps * (6 * m * m + 14 * m)
    nbytes = 4 * (2 * (m * m + 625 * m + m) + w * t + w)
    by_ops = ops / PEAK_F32_FLOPS
    by_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def k3_bound_ms(m, tokens):
    """Least time of K3's function on these inputs, counted as for K1: per
    non-PAD column 1..T-1 one add and one compare for each (source,
    destination) pair, 2*M^2, and 3*M for the emission add, the max and the
    rescale.  Bytes: each column's token read and its state written (8
    bytes), and the tables read once; the pointer table is a cost of K3's
    design and is not counted."""
    w, t = tokens.shape
    steps = int((tokens[:, 1:] >= 0).sum())
    ops = steps * (2 * m * m + 3 * m)
    nbytes = 8 * w * t + 4 * (m * m + 625 * m + m)
    by_ops = ops / PEAK_F32_FLOPS
    by_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def k4_bound_ms(m, tokens, size=4):
    """Least time of K4's function on these inputs: per non-PAD column the
    two M x M products (a^T alpha and a^T (e * beta), 4*M^2) and 9*M for the
    emission products, the three normalizations and gamma's product; bytes:
    each non-PAD column's token read (4) and its posterior row written
    (``size``*M), and the tables read once.  The alpha store (written by
    the forward, read back and overwritten by the reverse sweep) is a cost
    of K4's design and is not counted.  The products run in f64 in both of
    K4's instantiations, at the f64 peak; the rest at the peak of the
    tables' type, ``size`` 4 (f32) or 8 (f64)."""
    steps = int((tokens >= 0).sum())
    nbytes = steps * (4 + size * m) + size * (m * m + 625 * m + m)
    by_ops = (steps * 4 * m * m / PEAK_F64_FLOPS + steps * 9 * m
              / (PEAK_F32_FLOPS if size == 4 else PEAK_F64_FLOPS))
    by_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def k5_bound_ms(m, tokens, size=4):
    """Least time of K5's function on these inputs: per non-PAD column the
    product G @ a (2*M^3) and the emission scale and normalization (2*M^2),
    at the peak for their type (``size`` 4: f32, 8: f64); bytes: 4 a column
    of tokens in, and each chunk's operator and log scale out
    (``size``*M^2 + 8)."""
    c, length = tokens.shape
    steps = int((tokens >= 0).sum())
    ops = steps * (2 * m ** 3 + 2 * m * m)
    nbytes = 4 * c * length + c * (size * m * m + 8)
    by_ops = ops / (PEAK_F32_FLOPS if size == 4 else PEAK_F64_FLOPS)
    by_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def k6_bound_ms(m, tokens):
    """Least time of K6's function on these inputs: per non-PAD column of a
    chunk, an add and a max for each (row, source, destination), 2*M^3, and
    3*M^2 for each row's emission add, max and rescale, at the f32 peak
    (max-plus has no tensor-core path); bytes: 4 a column of tokens in,
    each chunk's operator (4*M^2) and offsets (8*M) out, the tables read
    once."""
    c, length = tokens.shape
    steps = int((tokens >= 0).sum())
    ops = steps * (2 * m ** 3 + 3 * m * m)
    nbytes = 4 * c * length + c * (4 * m * m + 8 * m) + 4 * (m * m + 625 * m)
    by_ops = ops / PEAK_F32_FLOPS
    by_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def scan_bound_ms(m, c):
    """Least time of the entry scan's function on C chunks: per chunk an
    add and a max for each (i, j), 2*M^2, and 3*M for the offsets' add, the
    max and the rescale, in f64 (at PEAK_F64_FLOPS); bytes: each chunk's
    operator (4*M^2) and offsets (8*M) in, its entry (4*M) out."""
    ops = c * (2 * m * m + 3 * m)
    nbytes = c * (4 * m * m + 12 * m)
    by_ops = ops / PEAK_F64_FLOPS
    by_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                         else "bytes")


def padded_tokens(dev, w, t, seed):
    """(W, T) uniform tokens with ragged PAD tails and all-PAD windows."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, 625, (w, t), generator=gen, device=dev,
                        dtype=torch.int32)
    lengths = torch.randint(1, t + 1, (w,), generator=gen, device=dev)
    ragged = torch.arange(w, device=dev) % 3 == 1  # every third window
    cut = torch.arange(t, device=dev)[None, :] >= lengths[:, None]
    tok[ragged[:, None] & cut] = -1
    tok[::97] = -1  # all-PAD windows
    return tok


def grad_errors(got, ref):
    """Per gradient (dA, dbfull, dpi), the largest |got - ref| / |ref| over
    its entries and the median |ref|, and whether every entry of every
    gradient is within GRAD_RTOL of the reference.  Each entry is a sum of
    non-negative terms, so none cancels and the rtol holds entry by entry,
    with no absolute slack: an entry that is 0 in the reference (a token
    absent from the batch) must be 0."""
    import torch

    errs, medians = [], []
    for g, r in zip(got, ref):
        g, r = g.double().to(r.device), r.double()
        rel = torch.nan_to_num((g - r).abs() / r.abs(), nan=0.0,
                               posinf=float("inf"))
        errs.append(float(rel.max()))
        medians.append(float(r.abs().median()))
    return errs, medians, all(e <= GRAD_RTOL for e in errs)


def grad_note(errs, medians):
    """The printed form of :func:`grad_errors`' result."""
    return (f"dA / dbfull / dpi max rel err per entry "
            f"{' / '.join(f'{e:.3g}' for e in errs)} (rtol {GRAD_RTOL:g}: f32 "
            f"normalizers and sums over T steps; median |ref| "
            f"{' / '.join(f'{m:.3g}' for m in medians)})")


def phase_build(card):
    from concurrent.futures import ThreadPoolExecutor

    from itrails_tpu_torch.hmm import (_build, cuda_fwd, cuda_grad,
                                       cuda_longseq, cuda_maxplus,
                                       cuda_posterior, cuda_viterbi)

    t0 = time.perf_counter()
    kernels = (("K1", cuda_fwd), ("K2", cuda_grad), ("K3", cuda_viterbi),
               ("K4", cuda_posterior), ("K5", cuda_longseq),
               ("K6", cuda_maxplus))
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc a source, at once
        jobs = [(name, pool.submit(mod.build)) for name, mod in kernels]
        built = [(name, job.result()) for name, job in jobs]
    seconds = time.perf_counter() - t0
    for name, (path, log) in built:
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        for ln in usage:
            print(f"{card} | build {name} | {ln}")
        check(path.exists(), f"{name} did not build")
    libs = ", ".join(f"{name} {os.path.relpath(path, ROOT)}"
                     for name, (path, _) in built)
    print(f"{card} | phase 1 build: {libs} in {seconds:.2f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def phase_k1(card, dev, m_label, n_ab, n_abc, w, t, seed, reps):
    """K1 against its plain version on the card, in f32 and in f64; returns
    the f64 record (the optimize CLI's value path at its default)."""
    import torch

    from itrails_tpu_torch.hmm import cuda_fwd

    a, bfull, pi, _ = build_tables(n_ab, n_abc, dev)
    m = a.shape[0]
    tok = padded_tokens(dev, w, t, seed)
    a32, b32, p32 = (x.float().contiguous() for x in (a, bfull, pi))

    al, ll = cuda_fwd.forward_fused(a32, b32, p32, tok)
    torch.cuda.synchronize()
    al_ref, ll_ref = cuda_fwd.forward_fused_plain(a, bfull, pi, tok)
    torch.cuda.synchronize()
    ll64 = ll.double()
    abs_err = (ll64 - ll_ref).abs()
    rel = float((abs_err / ll_ref.abs().clamp(min=1.0)).max())
    total_rel = float((ll64.sum() - ll_ref.sum()).abs() / ll_ref.sum().abs())
    alpha_err = float((al.double() - al_ref).abs().max())
    check(bool(torch.isfinite(ll).all()) and tuple(al.shape) == (w, m),
          f"K1 {m_label}: non-finite or misshapen output")
    check(bool((abs_err <= 1e-5 * ll_ref.abs() + 1e-5).all()),
          f"K1 {m_label}: per-window loglik off by {rel:.3g} (rtol 1e-5)")
    check(total_rel <= 1e-6, f"K1 {m_label}: total off by {total_rel:.3g}")
    check(alpha_err <= 1e-5, f"K1 {m_label}: alpha off by {alpha_err:.3g}")

    before = cuda_fwd.forward_fused.launches
    ms = cuda_ms(lambda: cuda_fwd.forward_fused(a32, b32, p32, tok), reps)
    check(cuda_fwd.forward_fused.launches - before == reps + 1,
          f"K1 {m_label}: timed calls did not all launch the kernel")
    launches = cuda_fwd.forward_fused.launches - before + 1
    plain_ms = cuda_ms(lambda: cuda_fwd.forward_fused_plain(a, bfull, pi, tok), 1)
    bound_ms, bound_by = k1_bound_ms(m, tok)
    a, bfull, pi = (x.contiguous() for x in (a, bfull, pi))
    al64, ll64k = cuda_fwd.forward_fused(a, bfull, pi, tok)
    torch.cuda.synchronize()
    abs64 = (ll64k - ll_ref).abs()
    rel64 = float((abs64 / ll_ref.abs().clamp(min=1.0)).max())
    alpha64_err = float((al64 - al_ref).abs().max())
    check(al64.dtype == torch.float64 and bool(torch.isfinite(ll64k).all()),
          f"K1 {m_label} f64: non-finite or f32 output")
    check(rel64 <= VALUE64_RTOL and alpha64_err <= VALUE64_RTOL,
          f"K1 {m_label} f64: per-window loglik off by {rel64:.3g}, alpha by "
          f"{alpha64_err:.3g} (rtol {VALUE64_RTOL:g})")
    ms64 = cuda_ms(lambda: cuda_fwd.forward_fused(a, bfull, pi, tok), reps)
    bound64_ms, bound64_by = k1_bound_ms(m, tok, size=8)
    # every tile runs at once (one wave), so one tile's column takes the
    # kernel's time over the T - 1 columns
    mhz = sm_clock_mhz()
    clocks, clocks64 = (1e3 * x * mhz / max(t - 1, 1) for x in (ms, ms64))
    att, att64 = (cuda_fwd.kernel_attributes(m, f64) for f64 in (False, True))

    def tile(at):
        return (f"{at['registers']} registers, {at['local_bytes']} local "
                f"bytes a thread, {at['rows_per_warp']} rows a warp, up to "
                f"{at['max_warps']} warps a block")

    print(f"{card} | phase 2 K1 {m_label} M={m} W={w} T={t}: per-window ll "
          f"max rel err {rel:.3g} (rtol 1e-5: f32 products over T steps), "
          f"total rel err {total_rel:.3g} (rtol 1e-6: f64 sum of f32 "
          f"windows), alpha max abs err {alpha_err:.3g}; K1 {ms:.4f} ms "
          f"(mean of {reps}, {launches} launches), "
          f"plain f64 {plain_ms:.1f} ms (no yardstick), bound {bound_ms:.4f} "
          f"ms ({bound_by}), {bound_ms / ms:.1%} of bound; {clocks:.0f} SM "
          f"clocks a column of one tile at {mhz:.0f} MHz; rows kernel "
          f"{tile(att)}")
    print(f"{card} | phase 2 K1 {m_label} M={m} W={w} T={t} f64: per-window "
          f"ll max rel err {rel64:.3g}, alpha max abs err {alpha64_err:.3g} "
          f"(gate {VALUE64_RTOL:g}, vs the plain f64 version); K1 f64 "
          f"{ms64:.4f} ms (mean of {reps}), {ms64 / ms:.2f}x f32, f64 bound "
          f"{bound64_ms:.4f} ms ({bound64_by}), {bound64_ms / ms64:.1%} of "
          f"bound; {clocks64:.0f} SM clocks a column of one tile; rows "
          f"kernel {tile(att64)}")
    return {"max_abs_err": float(abs64.max()), "ms": ms64,
            "plain_ms": plain_ms, "bound_ms": bound64_ms,
            "bound_by": bound64_by}


def phase_k2(card, dev, m_label, n_ab, n_abc, w, t, seed, reps, k1_ms):
    """K2 against its plain version (f64) on the card; returns its record."""
    import torch

    from itrails_tpu_torch.hmm import cuda_grad

    a, bfull, pi, _ = build_tables(n_ab, n_abc, dev)
    m = a.shape[0]
    tok = padded_tokens(dev, w, t, seed)
    a32, b32, p32 = (x.float().contiguous() for x in (a, bfull, pi))

    ll, grads = cuda_grad.loglik_and_grads_fused(a32, b32, p32, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll_ref, grads_ref = cuda_grad.loglik_and_grads_plain(a, bfull, pi, tok)
    torch.cuda.synchronize()
    plain_once_s = time.perf_counter() - t0
    total_rel = float((ll - ll_ref).abs() / ll_ref.abs())
    errs, medians, ok = grad_errors(grads, grads_ref)
    check(all(bool(torch.isfinite(g).all()) for g in grads)
          and tuple(grads[1].shape) == (m, 625),
          f"K2 {m_label}: non-finite or misshapen gradient")
    check(total_rel <= 1e-6, f"K2 {m_label}: total off by {total_rel:.3g}")
    check(ok, f"K2 {m_label}: gradients off: {grad_note(errs, medians)}")
    again = cuda_grad.loglik_and_grads_fused(a32, b32, p32, tok)
    same = bool(torch.equal(again[0], ll)) and all(
        torch.equal(x, y) for x, y in zip(again[1], grads))
    check(same, f"K2 {m_label}: two calls on the same inputs differ")

    before = cuda_grad.loglik_and_grads_fused.calls
    ms = cuda_ms(lambda: cuda_grad.loglik_and_grads_fused(a32, b32, p32, tok),
                 reps)
    check(cuda_grad.loglik_and_grads_fused.calls - before == reps + 1,
          f"K2 {m_label}: timed calls did not all launch the kernel")
    plain_ms = cuda_ms(
        lambda: cuda_grad.loglik_and_grads_plain(a, bfull, pi, tok), 1)
    bound_ms, bound_by = k2_bound_ms(m, tok)
    max_abs = max(float((g.double() - r).abs().max())
                  for g, r in zip(grads, grads_ref))
    max_ref = max(float(r.abs().max()) for r in grads_ref)
    print(f"{card} | phase 2 K2 {m_label} M={m} W={w} T={t}: total rel err "
          f"{total_rel:.3g} (rtol 1e-6: f64 sum of f32 windows), "
          f"{grad_note(errs, medians)}, bitwise equal on a second call, max "
          f"abs err {max_abs:.4g} on gradients up to {max_ref:.4g}; K2 "
          f"{ms:.4f} ms (mean of {reps}, two kernels a "
          f"call), {ms / k1_ms:.2f}x K1's {k1_ms:.4f} ms, plain f64 "
          f"{plain_ms:.1f} ms (no yardstick; first call {plain_once_s:.1f} s),"
          f" bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of "
          f"bound")
    return {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def simulated_block(dev, n_ab, n_abc, seed, shape=None):
    """A long block simulated from the model at START, 1-D on ``dev``:
    ``shape`` (windows x columns, joined; default 32 x 10,000, a 320 kb
    block), with a PAD run and a PAD tail."""
    import torch

    from itrails_tpu_torch.data.simulate import simulate_token_batch

    a, _, pi, b = build_tables(n_ab, n_abc, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (32, LONG_BLOCK // 32) if shape is None else shape
    tok = simulate_token_batch(a, b, pi, *shape, gen).reshape(-1)
    tok[100_003:100_703] = -1
    tok[-291:] = -1
    return tok


def phase_k2_chunks(card, dev, m_label, n_ab, n_abc, seed, reps):
    """K2 on the chunk windows of a simulated 320 kb block, entered and
    left through boundary rows (those of the f64 plain operators), against
    its plain version in f64 with the same rows."""
    import torch

    from itrails_tpu_torch.data.tokens import PAD_TOKEN
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_grad, longseq

    a, bfull, pi, _ = build_tables(n_ab, n_abc, dev)
    m = a.shape[0]
    chunk = longseq.ROUTE_CHUNK
    tok = simulated_block(dev, n_ab, n_abc, seed)
    n_chunks = -(-(len(tok) - 1) // chunk)
    stream = longseq.chunk_matrix(tok, 0, n_chunks, chunk)
    ops, _ = longseq.chunk_operators(a, bfull, stream.reshape(-1), chunk)
    _, al0, _ = cuda_fwd.column0(bfull, pi, tok[:1])
    alpha, beta = longseq.boundary_rows(ops, al0[0], torch.ones_like(al0[0]))
    del ops
    pad = torch.full((n_chunks, 1), PAD_TOKEN, dtype=tok.dtype, device=dev)
    windows = torch.cat([pad, stream], dim=1)
    a32, b32, p32 = (x.float().contiguous() for x in (a, bfull, pi))
    rows32 = {"entry_alpha": alpha.float(), "exit_beta": beta.float()}

    def k2():
        return cuda_grad.loglik_and_grads_fused(a32, b32, p32, windows, **rows32)

    ll, grads = k2()
    torch.cuda.synchronize()
    ll_ref, grads_ref = cuda_grad.loglik_and_grads_plain(
        a, bfull, pi, windows, entry_alpha=alpha, exit_beta=beta)
    rel = float((ll - ll_ref).abs() / ll_ref.abs())
    errs, medians, ok = grad_errors(grads, grads_ref)
    check(all(bool(torch.isfinite(g).all()) for g in grads)
          and float(grads[2].abs().max()) == 0.0,
          f"K2 chunks {m_label}: non-finite gradient or a dpi term")
    check(rel <= 1e-6, f"K2 chunks {m_label}: loglik off by {rel:.3g}")
    check(ok, f"K2 chunks {m_label}: gradients off: {grad_note(errs, medians)}")
    again = k2()
    check(bool(torch.equal(again[0], ll)) and all(
        torch.equal(x, y) for x, y in zip(again[1], grads)),
          f"K2 chunks {m_label}: two calls on the same inputs differ")
    ms = cuda_ms(k2, reps)
    bound_ms, bound_by = k2_bound_ms(m, windows)
    print(f"{card} | phase 2 K2 chunk windows {m_label} M={m} "
          f"W={n_chunks} T={chunk + 1} (a simulated {len(tok)}-column block, "
          f"boundary rows of the f64 plain operators): loglik rel err "
          f"{rel:.3g} (rtol 1e-6), {grad_note(errs, medians)}, bitwise equal "
          f"on a second call; K2 {ms:.4f} ms (mean of {reps}), bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")


def kernel_split(fn, names=("viterbi_forward", "viterbi_backtrack")):
    """Device milliseconds of each kernel of ``names`` (default: K3's two)
    in one call of ``fn``, from torch.profiler, as text ("not measured"
    when it records none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        name = next((k for k in names if k in ev.key), None)
        if name is not None:
            parts.append(f"{name} {ev.device_time_total / 1e3:.3f} ms")
    return " + ".join(sorted(parts)) or "not measured"


def phase_k3(card, dev, m_label, n_ab, n_abc, w, t, seed, reps, tie=False):
    """K3 against its f32 plain version on the card, on the same tables:
    exact path equality.  With ``tie``, states 0 and 1 of the model are
    made exchangeable, so every step holds exact ties."""
    import torch

    from itrails_tpu_torch.hmm import cuda_viterbi

    a, bfull, pi, _ = build_tables(n_ab, n_abc, dev)
    a32, b32, p32 = (x.float().contiguous() for x in (a, bfull, pi))
    if tie:
        a32[1] = a32[0]
        a32[:, 1] = a32[:, 0]
        b32[1] = b32[0]
        p32[1] = p32[0]
        m_label += " ties"
    m = a32.shape[0]
    tok = padded_tokens(dev, w, t, seed)

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    path, omega = cuda_viterbi.viterbi_fused(a32, b32, p32, tok)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    group = cuda_viterbi.window_group(t, m)
    table_bytes = min(group, w) * (t - 1) * m
    log_a, log_bt, log_pi = cuda_viterbi.log_tables(a32, b32, p32)
    om0 = cuda_viterbi.column0(log_bt, log_pi, tok[:, 0])
    t0 = time.perf_counter()
    ref, om_ref = cuda_viterbi.viterbi_fused_plain(log_a, log_bt, om0, tok)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_diff = int((path != ref).sum())
    check(tuple(path.shape) == (w, t) and path.dtype == torch.int32,
          f"K3 {m_label}: misshapen path")
    check(n_diff == 0, f"K3 {m_label}: {n_diff} path entries differ from the "
                       "plain version")
    check(torch.equal(omega, om_ref), f"K3 {m_label}: final omega differs")
    pad = tok < 0
    repeats = torch.where(pad, path, torch.zeros_like(path))
    last_real = path.gather(1, ((~pad).sum(1, keepdim=True) - 1).clamp(min=0))
    check(bool((repeats == torch.where(pad, last_real, 0)).all()),
          f"K3 {m_label}: padded steps do not repeat the last state")
    if tie:
        check(not bool((path == 1).any()),
              f"K3 {m_label}: a tie went to the second of two equal states")

    split = kernel_split(lambda: cuda_viterbi.viterbi_fused(a32, b32, p32, tok))
    k3_parts = (cuda_viterbi.viterbi_forward, cuda_viterbi.viterbi_backtrack)
    before = sum(f.launches for f in k3_parts)
    ms = cuda_ms(lambda: cuda_viterbi.viterbi_fused(a32, b32, p32, tok), reps)
    launches = sum(f.launches for f in k3_parts) - before
    check(launches == 2 * (reps + 1) * -(-w // group),
          f"K3 {m_label}: timed calls did not all launch the kernels")
    bound_ms, bound_by = k3_bound_ms(m, tok)
    print(f"{card} | phase 2 K3 {m_label} M={m} W={w} T={t}: paths equal to "
          f"the f32 plain version's at all {w * t} columns (exact, ties "
          f"included), final omega bitwise equal; K3 {ms:.4f} ms (mean of "
          f"{reps}, {launches // (reps + 1)} launches a call; one call under "
          f"torch.profiler: {split}), pointer table {table_bytes} bytes "
          f"({-(-w // group)} group(s)), peak device memory of a call {peak} "
          f"bytes, plain f32 "
          f"{plain_ms:.1f} ms (one call, host clock, no yardstick), bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound")


def phase_k4(card, dev, m_label, n_ab, n_abc, w, t, seed, reps):
    """K4 against its f64 plain version on the card, in f32 and in f64;
    returns the f64 record (the posterior CLI's default)."""
    import torch

    from itrails_tpu_torch.hmm import cuda_posterior

    a, bfull, pi, _ = build_tables(n_ab, n_abc, dev)
    a, bfull, pi = (x.contiguous() for x in (a, bfull, pi))
    m = a.shape[0]
    tok = padded_tokens(dev, w, t, seed)
    a32, b32, p32 = (x.float().contiguous() for x in (a, bfull, pi))

    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    post, alpha = cuda_posterior.posterior_fused(a32, b32, p32, tok)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    post64, alpha64 = cuda_posterior.posterior_fused(a, bfull, pi, tok)
    t0 = time.perf_counter()
    ref, al_ref = cuda_posterior.posterior_fused_plain(a, bfull, pi, tok)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    check(tuple(post.shape) == (t, w, m) and post.dtype == torch.float32,
          f"K4 {m_label}: misshapen posterior")
    check(tuple(post64.shape) == (t, w, m) and post64.dtype == torch.float64,
          f"K4 {m_label} f64: misshapen posterior")
    real = (tok >= 0).T  # (T, W): the columns whose posterior is defined
    err = sum_err = err64 = 0.0
    finite = True
    for lo in range(0, t, 512):  # in slices: the f64 differences are large
        r = real[lo:lo + 512]
        p = post[lo:lo + 512].double()
        finite &= bool(torch.isfinite(p[r]).all())
        err = max(err, float(torch.where(r[:, :, None], (p - ref[lo:lo + 512]).abs(),
                                         0.0).max()))
        sum_err = max(sum_err, float(torch.where(r, (p.sum(dim=2) - 1).abs(),
                                                 0.0).max()))
        err64 = max(err64, float(torch.where(
            r[:, :, None], (post64[lo:lo + 512] - ref[lo:lo + 512]).abs(),
            0.0).max()))
    alpha_err = float((alpha.double() - al_ref).abs().max())
    alpha64_err = float((alpha64 - al_ref).abs().max())
    del ref, p, post64
    check(finite, f"K4 {m_label}: non-finite posterior")
    check(err64 <= POST64_ATOL and alpha64_err <= POST64_ATOL,
          f"K4 {m_label} f64: posterior off the plain version by {err64:.3g}, "
          f"final alpha by {alpha64_err:.3g} (atol {POST64_ATOL:g})")
    check(err <= POST_ATOL, f"K4 {m_label}: posterior off the plain version by "
                            f"{err:.3g} (atol {POST_ATOL:g})")
    check(sum_err <= 1e-5, f"K4 {m_label}: a posterior row sums to 1 +- {sum_err:.3g}")
    check(alpha_err <= POST_ATOL, f"K4 {m_label}: final alpha off by {alpha_err:.3g}")

    before = cuda_posterior.posterior_fused.launches
    ms = cuda_ms(lambda: cuda_posterior.posterior_fused(a32, b32, p32, tok), reps)
    launches = cuda_posterior.posterior_fused.launches - before
    check(launches == 2 * (reps + 1),
          f"K4 {m_label}: timed calls did not all launch the kernels")
    split = kernel_split(lambda: cuda_posterior.posterior_fused(a32, b32, p32, tok),
                         ("forward_kernel", "k4_reverse_kernel"))
    bound_ms, bound_by = k4_bound_ms(m, tok)
    ms64 = cuda_ms(lambda: cuda_posterior.posterior_fused(a, bfull, pi, tok),
                   reps)
    bound64_ms, bound64_by = k4_bound_ms(m, tok, size=8)
    print(f"{card} | phase 2 K4 {m_label} M={m} W={w} T={t}: posterior max abs "
          f"err {err:.3g} over the non-PAD entries (atol {POST_ATOL:g}, vs the "
          f"plain f64 version), rows sum to 1 within {sum_err:.3g} (1e-5), "
          f"final alpha max abs err {alpha_err:.3g}; K4 {ms:.4f} ms (mean of "
          f"{reps}, 2 launches a call; one call under torch.profiler: {split}),"
          f" peak device memory of a call {peak} bytes (store "
          f"{t * w * 4 * 32 * -(-m // 32)} bytes), plain f64 {plain_ms:.1f} ms (one call, host clock, no "
          f"yardstick), bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.1%} of bound")
    print(f"{card} | phase 2 K4 {m_label} M={m} W={w} T={t} f64: posterior max "
          f"abs err {err64:.3g} over the non-PAD entries (atol "
          f"{POST64_ATOL:g}, vs the plain f64 version), final alpha "
          f"{alpha64_err:.3g}; K4 f64 {ms64:.4f} ms (mean of {reps}), "
          f"{ms64 / ms:.2f}x f32, f64 bound {bound64_ms:.4f} ms "
          f"({bound64_by}, 67 TFLOP/s), {bound64_ms / ms64:.1%} of bound")
    return {"max_abs_err": err64, "ms": ms64, "plain_ms": plain_ms,
            "bound_ms": bound64_ms, "bound_by": bound64_by}


def phase_k4_run_lengths(card, dev):
    """K4's error against its f64 plain version as one state's runs grow:
    tokens simulated from the 3x3 model at START with r scaled by
    RUN_RATES (slower switching, longer runs).  K4 in f64 is gated at
    POST_ATOL at every rate.  K4 in f32 is a reading for the record of how
    far a model that switches more rarely than phase 8's takes its error
    past POST_ATOL, split into the part that the f32 rounding of the tables
    alone makes (the f64 plain version on the f32-rounded tables) and the
    part that K4's f32 arithmetic adds on those tables."""
    import torch

    from itrails_tpu_torch.data.simulate import simulate_token_batch
    from itrails_tpu_torch.hmm import cuda_posterior

    parts = []
    for r in RUN_RATES:
        a, bfull, pi, b = build_tables(3, 3, dev, start_params(3, 3, r=r))
        run = float(1 / (pi * (1 - torch.diagonal(a))).sum())
        gen = torch.Generator(device=dev).manual_seed(21)
        tok = simulate_token_batch(a, b, pi, *RUN_SHAPE, gen)
        tables = [x.float().contiguous() for x in (a, bfull, pi)]
        post, _ = cuda_posterior.posterior_fused(*tables, tok)
        check(bool(torch.isfinite(post).all()), f"K4 at r={r:g}: non-finite posterior")
        ref, _ = cuda_posterior.posterior_fused_plain(a, bfull, pi, tok)
        err = float((post.double() - ref).abs().max())
        post64, _ = cuda_posterior.posterior_fused(
            *(x.contiguous() for x in (a, bfull, pi)), tok)
        err64 = float((post64 - ref).abs().max())
        del post64
        check(err64 <= POST_ATOL, f"K4 f64 at r={r:g}: posterior off the plain "
                                  f"version by {err64:.3g} (atol {POST_ATOL:g})")
        rounded, _ = cuda_posterior.posterior_fused_plain(
            *(x.double() for x in tables), tok)
        table_err = float((rounded - ref).abs().max())
        del ref
        arith_err = float((post.double() - rounded).abs().max())
        del post, rounded
        parts.append(f"r={r:g}: mean run {run:.0f} columns, f64 K4 max abs err "
                     f"{err64:.3g}; f32 K4 max abs err {err:.3g} (f32 tables "
                     f"alone {table_err:.3g}, K4's f32 arithmetic on them "
                     f"{arith_err:.3g})")
    print(f"{card} | phase 2 K4 3x3 error as switching slows "
          f"({RUN_SHAPE[0]} x {RUN_SHAPE[1]} columns simulated from each "
          f"model, against the f64 plain version; f64 K4 gated at atol "
          f"{POST_ATOL:g}, f32 K4 no gate): " + "; ".join(parts))


def k5_tokens(dev, a, b, pi, seed):
    """Phase 2's K5 input: the 313 chunks of 1,024 columns of a 320 kb block
    simulated from the model, with a PAD run, an all-PAD chunk (chunk 5)
    and the block's PAD tail."""
    import torch

    from itrails_tpu_torch.data.simulate import simulate_token_batch
    from itrails_tpu_torch.hmm import longseq

    chunk = longseq.CHUNK
    n_chunks = -(-(LONG_BLOCK - 1) // chunk)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = simulate_token_batch(a, b, pi, n_chunks, chunk, gen)
    tok[1, 100:400] = -1  # a PAD run
    tok[5] = -1  # an all-PAD chunk
    tok[-1, (LONG_BLOCK - 1) % chunk:] = -1  # the block's PAD tail
    return tok


def rows_sass(card):
    """The SASS (cuobjdump) of the row kernels of K1 and K5
    (``csrc/rows.cuh``), each in its own library: every f64 instantiation
    runs its product on the FP64 tensor cores (DMMA), no f32 one does, and
    each has one block-wide barrier, the one before its column loop.  K5
    has 28 f64 instantiations (one tile a size), K1 28 (8-row tiles, one a
    size); each 7 f32 ones."""
    import re

    from itrails_tpu_torch.hmm import _build, cuda_fwd, cuda_longseq

    for name, mod, tag, n_f64 in (("K1", cuda_fwd, "k1_rows", 28),
                                  ("K5", cuda_longseq, "k5_rows", 28)):
        path, _ = mod.build()
        funcs = {n: body for n, body in _build.sass_functions(path).items()
                 if tag in n}
        f64 = {n: body for n, body in funcs.items() if f"{tag}_f64" in n}
        dmma = [len(re.findall(r"\bDMMA", body)) for body in f64.values()]
        kinds = sorted({k for body in f64.values()
                        for k in re.findall(r"\bDMMA\.\S+", body)})
        bars = [len(re.findall(r"\bBAR\.SYNC", body)) for body in funcs.values()]
        check(len(f64) == n_f64 and len(funcs) == n_f64 + 7 and min(dmma) > 0,
              f"{name}'s f64 instantiations without DMMA: {dmma}")
        check(not any(re.search(r"\b[DH]MMA", body) for n, body in funcs.items()
                      if n not in f64),
              f"an f32 {name} instantiation uses tensor cores")
        check(set(bars) == {1},
              f"{name} kernels' block barriers: {sorted(set(bars))}")
        print(f"{card} | phase 1 {name} SASS (cuobjdump -sass): {len(f64)} f64 "
              f"instantiations, each with DMMA ({min(dmma)}-{max(dmma)} a "
              f"kernel: {', '.join(kinds)}), {len(funcs) - len(f64)} f32 ones "
              f"with none; one BAR.SYNC in each (before the column loop)")


def phase_k5(card, dev, m_label, n_ab, n_abc, seed, reps):
    """K5 against its plain version in f64 on the same (f32) tables, on the
    card, on the chunks of a 320 kb block simulated from the model, and K5
    on the f64 tables against the plain version on them, in CHUNK and in
    ROUTE_CHUNK columns; returns the f64 record at ROUTE_CHUNK, the shape
    the posterior path and the gradient route give K5.  The plain
    version on the f64 tables against the f32 ones is read too, without a
    gate: over 1,024 columns of a model whose states persist, the f32
    rounding of the tables alone moves the operators by ~5e-5."""
    import torch

    from itrails_tpu_torch.hmm import cuda_longseq, longseq

    a, bfull, pi, b = build_tables(n_ab, n_abc, dev)
    m = a.shape[0]
    tok = k5_tokens(dev, a, b, pi, seed)
    n_chunks, chunk = tok.shape
    a32, b32 = (x.float().contiguous() for x in (a, bfull))

    ops, logz = cuda_longseq.chunk_operators_fused(a32, b32, tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops_ref, logz_ref = cuda_longseq.chunk_operators(
        a32.double(), b32.double(), tok.reshape(-1), chunk)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    a, bfull = a.contiguous(), bfull.contiguous()
    ops64, logz64 = cuda_longseq.chunk_operators(a, bfull, tok.reshape(-1), chunk)
    tables_ops = float((ops_ref - ops64).abs().max())
    tables_logz = float(((logz_ref - logz64).abs()
                         / logz64.abs().clamp(min=1.0)).max())
    ops64k, logz64k = cuda_longseq.chunk_operators_fused(a, bfull, tok)
    torch.cuda.synchronize()
    check(ops64k.dtype == torch.float64 and bool(torch.isfinite(ops64k).all()),
          f"K5 {m_label} f64: non-finite or f32 operators")
    ops64_err = float((ops64k - ops64).abs().max())
    logz64_err = float(((logz64k - logz64).abs()
                        / logz64.abs().clamp(min=1.0)).max())
    del ops64, logz64, ops64k
    check(ops64_err <= VALUE64_RTOL and logz64_err <= VALUE64_RTOL,
          f"K5 {m_label} f64: operators off the plain version by "
          f"{ops64_err:.3g}, log scales by {logz64_err:.3g} (gate "
          f"{VALUE64_RTOL:g})")
    check(tuple(ops.shape) == (n_chunks, m, m) and ops.dtype == torch.float32
          and logz.dtype == torch.float64, f"K5 {m_label}: misshapen output")
    check(bool(torch.isfinite(ops).all() and torch.isfinite(logz).all()),
          f"K5 {m_label}: non-finite output")
    ops_err = float((ops.double() - ops_ref).abs().max())
    logz_err = float(((logz - logz_ref).abs()
                      / logz_ref.abs().clamp(min=1.0)).max())
    check(ops_err <= OPS_ATOL, f"K5 {m_label}: operators off the plain version "
                               f"by {ops_err:.3g} (atol {OPS_ATOL:g})")
    check(logz_err <= LOGZ_RTOL, f"K5 {m_label}: log scales off by "
                                 f"{logz_err:.3g} (rtol {LOGZ_RTOL:g})")
    check(bool(torch.equal(ops[5], torch.eye(m, device=dev))) and float(logz[5]) == 0.0,
          f"K5 {m_label}: the all-PAD chunk is not the identity")

    before = cuda_longseq.chunk_operators_fused.launches
    ms = cuda_ms(lambda: cuda_longseq.chunk_operators_fused(a32, b32, tok), reps)
    launches = cuda_longseq.chunk_operators_fused.launches - before
    check(launches == reps + 1, f"K5 {m_label}: timed calls did not all launch "
                                "the kernel")
    bound_ms, bound_by = k5_bound_ms(m, tok)
    ms64 = cuda_ms(lambda: cuda_longseq.chunk_operators_fused(a, bfull, tok),
                   reps)
    bound64_ms, bound64_by = k5_bound_ms(m, tok, size=8)
    # the shape the long-block routes give K5: a LONG_BLOCK-column block's
    # columns 1..T-1 in chunks of ROUTE_CHUNK, the last padded; in f64, the
    # posterior CLI's default, K5 against the contract on the same tables
    n_g = -(-(LONG_BLOCK - 1) // longseq.ROUTE_CHUNK)
    tok_g = longseq.chunk_matrix(tok.reshape(-1)[:LONG_BLOCK], 0, n_g,
                                 longseq.ROUTE_CHUNK)
    ms_g = cuda_ms(lambda: cuda_longseq.chunk_operators_fused(a32, b32, tok_g),
                   reps)
    ms64_g = cuda_ms(lambda: cuda_longseq.chunk_operators_fused(a, bfull, tok_g),
                     reps)
    ops_g, logz_g = cuda_longseq.chunk_operators_fused(a, bfull, tok_g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops_gr, logz_gr = cuda_longseq.chunk_operators(a, bfull, tok_g.reshape(-1),
                                                   longseq.ROUTE_CHUNK)
    torch.cuda.synchronize()
    plain_g_ms = 1e3 * (time.perf_counter() - t0)
    ops_g_err = float((ops_g - ops_gr).abs().max())
    logz_g_err = float(((logz_g - logz_gr).abs()
                        / logz_gr.abs().clamp(min=1.0)).max())
    del ops_g, ops_gr
    check(ops_g_err <= VALUE64_RTOL and logz_g_err <= VALUE64_RTOL,
          f"K5 {m_label} f64 C={n_g} L={longseq.ROUTE_CHUNK}: operators off "
          f"the plain version by {ops_g_err:.3g}, log scales by "
          f"{logz_g_err:.3g} (gate {VALUE64_RTOL:g})")
    bound_g_ms, bound_g_by = k5_bound_ms(m, tok_g, size=8)
    # a yardstick, no library_ms: one cuBLAS product of every row of every
    # chunk by a, (C M, M) @ (M, M), times the chunk's columns
    rows32, rows64 = ops.reshape(-1, m), ops.reshape(-1, m).double()
    yard_ms = chunk * cuda_ms(lambda: rows32 @ a32, reps)
    yard64_ms = chunk * cuda_ms(lambda: rows64 @ a, reps)
    att, att64 = (cuda_longseq.kernel_attributes(m, f64) for f64 in (False, True))
    print(f"{card} | phase 2 K5 {m_label} M={m} C={n_chunks} L={chunk}: "
          f"operators max abs err {ops_err:.3g} (atol {OPS_ATOL:g}), log "
          f"scales max rel err {logz_err:.3g} (rtol {LOGZ_RTOL:g}; |logz| up "
          f"to {float(logz_ref.abs().max()):.1f}), vs the plain version in "
          f"f64 on the same f32 tables (the f32 rounding of the tables alone, "
          f"against the f64 tables, no gate: {tables_ops:.3g} and "
          f"{tables_logz:.3g}); "
          f"the all-PAD chunk the identity with scale 0; K5 {ms:.4f} ms (mean "
          f"of {reps}, {launches} launches), plain f64 {plain_ms:.1f} ms (one "
          f"call, host clock, no yardstick), bound {bound_ms:.4f} ms "
          f"({bound_by}), {bound_ms / ms:.1%} of bound; the same columns "
          f"in {tok_g.shape[0]} chunks of {tok_g.shape[1]} {ms_g:.4f} ms; "
          f"cuBLAS yardstick "
          f"(({n_chunks * m}, {m}) @ ({m}, {m}) x {chunk}) {yard_ms:.4f} ms; "
          f"rows kernel {att['registers']} registers, {att['local_bytes']} "
          f"local bytes a thread, {att['rows_per_warp']} rows a warp, up to "
          f"{att['max_warps']} warps a block")
    print(f"{card} | phase 2 K5 {m_label} M={m} C={n_chunks} L={chunk} f64: "
          f"operators max abs err {ops64_err:.3g}, log scales max rel err "
          f"{logz64_err:.3g} (gate {VALUE64_RTOL:g}, vs the plain version on "
          f"the same f64 tables); K5 f64 {ms64:.4f} ms (mean of {reps}), "
          f"{ms64 / ms:.2f}x f32, f64 bound {bound64_ms:.4f} ms "
          f"({bound64_by}), {bound64_ms / ms64:.1%} of bound; in "
          f"{tok_g.shape[0]} chunks of {tok_g.shape[1]} (the long-block "
          f"routes' shape, the record's) {ms64_g:.4f} ms, bound "
          f"{bound_g_ms:.4f} ms ({bound_g_by}), operators max abs err "
          f"{ops_g_err:.3g}, log scales max rel err {logz_g_err:.3g} (gate "
          f"{VALUE64_RTOL:g}), plain f64 {plain_g_ms:.1f} ms; cuBLAS "
          f"yardstick {yard64_ms:.4f} ms; rows kernel {att64['registers']} "
          f"registers, {att64['local_bytes']} local bytes a thread, "
          f"{att64['rows_per_warp']} rows a warp, up to {att64['max_warps']} "
          f"warps a block")
    return {"max_abs_err": ops_g_err, "ms": ms64_g, "plain_ms": plain_g_ms,
            "bound_ms": bound_g_ms, "bound_by": bound_g_by}


def host_ms(fn):
    """``fn()`` and its milliseconds on the host clock, synchronized before
    and after: a plain version's host-launched ops."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def phase_viterbi_route_kernels(card, dev, m_label, n_ab, n_abc, seed, reps):
    """The Viterbi route's kernels on the ROUTE_CHUNK-column chunks of a
    320 kb block simulated from the model, on f32 tables, each against its
    plain version on the card, bit for bit: K6's operators and offsets, the
    entry scan's omegas and carry, K3's forward over the chunk windows (its
    pointers and final omegas), its entry map, the chain and its backtrack.
    Returns the records of K6, the scan and K3's four parts together."""
    import torch

    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi, longseq

    a, bfull, pi, _ = build_tables(n_ab, n_abc, dev)
    a32, b32, p32 = (x.float().contiguous() for x in (a, bfull, pi))
    m = a32.shape[0]
    tok = simulated_block(dev, n_ab, n_abc, seed)
    chunk = longseq.ROUTE_CHUNK
    n_chunks = -(-(len(tok) - 1) // chunk)
    stream = longseq.chunk_matrix(tok, 0, n_chunks, chunk)
    windows = torch.cat([tok[0:n_chunks * chunk:chunk, None], stream], dim=1)
    log_a, log_bt, log_pi = cuda_viterbi.log_tables(a32, b32, p32)
    omega = cuda_viterbi.column0(log_bt, log_pi, tok[:1])[0].double()
    what = f"{m_label} M={m} C={n_chunks} L={chunk}"

    g, off = cuda_maxplus.maxplus_operators(log_a, log_bt, stream)
    (g_ref, off_ref), k6_plain = host_ms(
        lambda: cuda_maxplus.maxplus_operators_plain(log_a, log_bt, stream))
    k6_err = max(float((g - g_ref).abs().max()), float((off - off_ref).abs().max()))
    check(torch.equal(g, g_ref) and torch.equal(off, off_ref),
          f"K6 {what}: off its plain version by {k6_err:.3g}")
    del g_ref, off_ref
    entries, carry = cuda_maxplus.entry_scan(g, off, omega)
    (ent_ref, carry_ref), scan_plain = host_ms(
        lambda: cuda_maxplus.entry_scan_plain(g, off, omega))
    scan_err = float((entries - ent_ref).abs().max())
    check(torch.equal(entries, ent_ref) and torch.equal(carry, carry_ref),
          f"the entry scan {what}: off its plain version by {scan_err:.3g}")
    ptrs, om = cuda_viterbi.viterbi_forward(log_a, log_bt, entries, windows)
    maps = cuda_viterbi.entry_map(ptrs)
    states = cuda_viterbi.chain(maps, om[-1])
    rows = cuda_viterbi.viterbi_backtrack(ptrs, om, states[1:])
    (p_ref, om_ref), fwd_plain = host_ms(
        lambda: cuda_viterbi.viterbi_forward_plain(log_a, log_bt, entries,
                                                   windows))
    maps_ref, map_plain = host_ms(lambda: cuda_viterbi.entry_map_plain(ptrs))
    states_ref, chain_plain = host_ms(
        lambda: cuda_viterbi.chain_plain(maps, om[-1]))
    rows_ref, back_plain = host_ms(
        lambda: cuda_viterbi.viterbi_backtrack_plain(ptrs, om, states[1:]))
    same = {"forward": torch.equal(ptrs, p_ref) and torch.equal(om, om_ref),
            "entry map": torch.equal(maps, maps_ref),
            "chain": torch.equal(states, states_ref),
            "backtrack": torch.equal(rows, rows_ref)}
    check(all(same.values()), f"K3's parts on the chunk windows {what}: "
                              f"equal to their plain versions {same}")
    del p_ref, om_ref
    k3_err = float((rows - rows_ref).abs().max())

    k6_ms = cuda_ms(lambda: cuda_maxplus.maxplus_operators(log_a, log_bt,
                                                           stream), reps)
    scan_ms = cuda_ms(lambda: cuda_maxplus.entry_scan(g, off, omega), reps)
    fwd_ms = cuda_ms(lambda: cuda_viterbi.viterbi_forward(log_a, log_bt,
                                                          entries, windows), reps)
    map_ms = cuda_ms(lambda: cuda_viterbi.entry_map(ptrs), reps)
    chain_ms = cuda_ms(lambda: cuda_viterbi.chain(maps, om[-1]), reps)
    back_ms = cuda_ms(lambda: cuda_viterbi.viterbi_backtrack(ptrs, om,
                                                             states[1:]), reps)
    k3_ms = fwd_ms + map_ms + chain_ms + back_ms
    k6_bound, k6_by = k6_bound_ms(m, stream)
    scan_bound, scan_by = scan_bound_ms(m, n_chunks)
    k3_bound, k3_by = k3_bound_ms(m, windows)
    k3_plain = fwd_plain + map_plain + chain_plain + back_plain
    print(f"{card} | phase 2 Viterbi route kernels {what} (f32 tables, CUDA "
          f"events, mean of {reps} calls with their wrappers): K6 equal to its "
          f"plain version (operators and f64 offsets) {k6_ms:.4f} ms, bound "
          f"{k6_bound:.4f} ms ({k6_by}), {k6_bound / k6_ms:.1%} of bound, plain "
          f"{k6_plain:.1f} ms; the entry scan equal {scan_ms:.4f} ms, bound "
          f"{scan_bound:.5f} ms ({scan_by}), plain {scan_plain:.1f} ms; K3 on "
          f"the ({n_chunks}, {chunk + 1}) chunk windows, each part equal: "
          f"forward {fwd_ms:.4f} + entry map {map_ms:.4f} + chain "
          f"{chain_ms:.4f} + backtrack {back_ms:.4f} = {k3_ms:.4f} ms, bound "
          f"{k3_bound:.4f} ms ({k3_by}), {k3_bound / k3_ms:.1%} of bound, plain "
          f"{fwd_plain:.1f} + {map_plain:.1f} + {chain_plain:.1f} + "
          f"{back_plain:.1f} ms (host clock)")
    return {"k6": {"max_abs_err": k6_err, "ms": k6_ms, "plain_ms": k6_plain,
                   "bound_ms": k6_bound, "bound_by": k6_by},
            "scan": {"max_abs_err": scan_err, "ms": scan_ms,
                     "plain_ms": scan_plain, "bound_ms": scan_bound,
                     "bound_by": scan_by},
            "k3": {"max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
                   "bound_ms": k3_bound, "bound_by": k3_by}}


def write_config(workdir, name, config):
    """Writes ``config`` to ``<workdir>/<name>.yaml``; returns its path."""
    import yaml

    path = os.path.join(workdir, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


def cli_maf(dev, workdir, name, seed, introgression=False):
    """A MAF in CLI_LAYOUT (1.32 M columns, one LONG_BLOCK block) simulated
    from the 3x3 model, or with ``introgression`` the 3x3 int model, at its
    start point; returns its path, its blocks' tokens and the engine's plan
    of them (the buckets, the long blocks)."""
    import torch

    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.data.simulate import simulate_token_batch, write_maf
    from itrails_tpu_torch.hmm import windows

    n_short, block_len, n_joined = CLI_LAYOUT
    a, _, pi, b = build_tables(3, 3, dev, introgression=introgression)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sim = simulate_token_batch(a, b, pi, n_short + n_joined, block_len,
                               gen).cpu().numpy()
    maf = os.path.join(workdir, f"{name}.maf")
    write_maf(maf, list(sim[:n_short]) + [sim[n_short:].reshape(-1)], SPECIES)
    v_lst = maf_tokens(maf, SPECIES)
    lengths = [len(v) for v in v_lst]
    buckets, long_idx = windows.plan_buckets(lengths, 1)
    check(sum(lengths) == (n_short + n_joined) * block_len
          and len(long_idx) == 1 and lengths[long_idx[0]] == LONG_BLOCK,
          f"{name}.maf is not the planned layout")
    return maf, v_lst, buckets, long_idx


def optimize_on_card(main, cfg_path, out, sep, n_var, buckets, long_idx,
                     *flags):
    """Runs an optimize CLI's ``main`` on the card, K1's and K5's counts
    set to 0 just before and read just after; checks its history (one
    finite row an evaluation, more than the initial simplex's n_var + 1),
    its best model (the best row), and K1 once a bucket and K5 once a long
    block an evaluation.  Its artifacts are ``<out><sep><name>``.  Returns
    the history's rows, the best loglik, the run's seconds and the
    launches of K1 and K5."""
    import torch
    import yaml

    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq

    cuda_fwd.forward_fused.launches = 0
    cuda_longseq.chunk_operators_fused.launches = 0
    t0 = time.perf_counter()
    main([cfg_path, "--output", out, *flags])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    k1 = cuda_fwd.forward_fused.launches
    k5 = cuda_longseq.chunk_operators_fused.launches
    rows = np.loadtxt(f"{out}{sep}optimization_history.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    with open(f"{out}{sep}best_model.yaml") as f:
        best_ll = yaml.safe_load(f)["results"]["log_likelihood"]
    n_eval = rows.shape[0]
    check(n_eval > n_var + 1 and rows.shape[1] == n_var + 3,
          f"{out}: history has the wrong shape")
    check(np.array_equal(rows[:, 0], np.arange(n_eval)),
          f"{out}: history is not one row per evaluation")
    check(np.isfinite(rows).all(), f"{out}: history holds non-finite values")
    check(np.isfinite(best_ll) and best_ll == rows[:, -2].max(),
          f"{out}: best-model loglik is not the best history row")
    check(k1 == n_eval * len(buckets),
          f"{out}: K1 launched {k1} times for {n_eval} evaluations x "
          f"{len(buckets)} bucket(s): a long block must launch no K1")
    check(k5 == n_eval * len(long_idx),
          f"{out}: K5 launched {k5} times for {n_eval} evaluations x "
          f"{len(long_idx)} long block(s)")
    return rows, best_ll, seconds, k1, k5


def cli_setup(dev, workdir):
    """Phase 3's MAF and configs; starts the CPU run that
    :func:`phase_cli_fd` holds the card to, in a process of its own, which
    overlaps the card's phases from phase 2 on."""
    t0 = time.perf_counter()
    maf, v_lst, buckets, long_idx = cli_maf(dev, workdir, "sim3x3", 11)
    config = {
        "fixed_parameters": {"mu": 1e-8},
        "optimized_parameters": {
            "N_AB": [50000, 5000, 500000], "N_ABC": [50000, 5000, 500000],
            "t_1": [240000, 24000, 2400000], "t_2": [40000, 4000, 400000],
            "t_upper": [745069.3855, 74506.9385, 7450693.8556],
            "r": [1e-8, 1e-9, 1e-7],
        },
        "settings": {"input_maf": maf, "species_list": SPECIES,
                     "method": "Nelder-Mead", "n_int_AB": 3, "n_int_ABC": 3},
    }
    cfg_path = write_config(workdir, "config", config)
    n_var = len(config["optimized_parameters"])
    fd = {"config": write_config(workdir, "config_fd", dict(
        config, settings=dict(config["settings"], method="L-BFGS-B")))}
    fd["cpu"] = start_cli_cpu(workdir, "itrails_tpu_torch.cli.optimize", ".",
                              fd["config"], "fd", n_var + 1, "--no-grad")
    return {"maf": maf, "v_lst": v_lst, "buckets": buckets,
            "long_idx": long_idx, "config": config, "cfg_path": cfg_path,
            "fd": fd, "prep_s": time.perf_counter() - t0}


def phase_cli(card, dev, workdir, setup):
    """The value-only path: the optimize CLI, Nelder-Mead, at 3x3, at its
    default precision (K1 and K5 in f64), on :func:`cli_setup`'s MAF.
    Returns its launches of K1 and K5 and what later phases reuse."""
    from itrails_tpu_torch.cli.common import prepare_optimize_setup
    from itrails_tpu_torch.cli.optimize import main
    from itrails_tpu_torch.hmm import cuda_fwd, longseq
    from itrails_tpu_torch.optim.cases import resolve_times
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    config, v_lst = setup["config"], setup["v_lst"]
    buckets, long_idx = setup["buckets"], setup["long_idx"]
    n_var = len(config["optimized_parameters"])
    out = os.path.join(workdir, "run", "sim")
    rows, best_ll, cli_s, launches, k5_launches = optimize_on_card(
        main, setup["cfg_path"], out, ".", n_var, buckets, long_idx,
        "--no-grad", "--maxiter", "3")
    n_eval = rows.shape[0]

    # the first evaluation against the plain versions in f64 on the card:
    # K1's on the buckets, the operator path's on the long block
    prep = prepare_optimize_setup(config)
    d = resolve_times(prep["case"], dict(prep["fixed_dict"], **dict(
        zip(prep["optim_variables"], prep["optim_list"]))))
    engine = LoglikEngine(v_lst, 3, 3, device=dev)
    ref = engine.loglik_plain(d)
    a0, bfull0, pi0, _ = build_tables(3, 3, dev, d)
    a32, b32, p32 = (x.float().contiguous() for x in (a0, bfull0, pi0))
    per_batch = []  # each route's ms in f64 (the CLI's) and in f32
    for tok in engine.batches:
        ms = cuda_ms(lambda: cuda_fwd.forward_fused(a0, bfull0, pi0, tok), 1)
        ms32 = cuda_ms(lambda: cuda_fwd.forward_fused(a32, b32, p32, tok), 1)
        per_batch.append(f"K1 {tuple(tok.shape)} {ms:.2f} ms (f32 "
                         f"{ms32:.2f} ms)")
    for tok in engine.long_blocks:
        ms = cuda_ms(lambda: longseq.forward_loglik_long(a0, bfull0, pi0, tok),
                     3)
        ms32 = cuda_ms(lambda: longseq.forward_loglik_long(a32, b32, p32, tok),
                       3)
        per_batch.append(f"K5 + operator product, the {len(tok)}-column "
                         f"block, {ms:.2f} ms (f32 {ms32:.2f} ms)")
    rel = abs(rows[0, -2] - ref) / abs(ref)
    check(rel <= VALUE64_RTOL, f"first evaluation off the f64 reference by "
                               f"{rel:.3g} (rtol {VALUE64_RTOL:g})")
    print(f"{card} | phase 3 optimize CLI 3x3 Nelder-Mead: "
          f"{sum(len(v) for v in v_lst)} columns in {len(v_lst)} blocks "
          f"({len(buckets)} bucket(s) + {len(long_idx)} long block), {n_eval} "
          f"evaluations in {cli_s:.2f} s ({cli_s / n_eval:.3f} s/eval), K1 "
          f"launches {launches} = {n_eval} x {len(buckets)}, K5 launches "
          f"{k5_launches} = {n_eval} x {len(long_idx)}, best loglik "
          f"{best_ll:.6f}, eval 0 vs plain f64 rel err {rel:.3g} (rtol "
          f"{VALUE64_RTOL:g}); history digest "
          f"{history_digest(out + '.optimization_history.csv')}; per "
          f"evaluation, f64 (the CLI's default) and f32: "
          f"{', '.join(per_batch)}; simulation + MAF {setup['prep_s']:.1f} s "
          f"(before phase 2)")
    return launches, k5_launches, {
        "config": config, "v_lst": v_lst, "engine": engine,
        "per_eval": len(buckets) + len(long_idx), "ref": ref,
        "maf": setup["maf"], "fd": setup["fd"]}


def start_cli_cpu(workdir, module, sep, cfg_path, tag, n_rows, *flags):
    """Starts the optimize CLI ``module`` with ``--device cpu --maxiter 1``
    on ``cfg_path`` in a process of its own, stopped once its history
    (``<out><sep>optimization_history.csv``) holds ``n_rows`` rows: the
    rows :func:`cpu_rows` hands on, while later ones would only take the
    CPU that the card's phases' own references need."""
    import threading

    out = os.path.join(workdir, f"{tag}_cpu", "sim")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    history = f"{out}{sep}optimization_history.csv"
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    log = open(out + ".log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", module, cfg_path, "--output", out,
         "--maxiter", "1", "--device", "cpu", *flags],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    RUNNING.append(proc)
    run = {"out": out, "history": history, "proc": proc, "log": log,
           "stopped": False, "n_rows": n_rows}

    def stop_after_rows():
        while proc.poll() is None:
            if (os.path.exists(history)
                    and len(history_rows(history)) >= n_rows):
                run["stopped"] = True
                proc.kill()
                break
            time.sleep(0.5)
        run["ended"] = time.perf_counter() - STARTED

    run["watch"] = threading.Thread(target=stop_after_rows, daemon=True)
    run["watch"].start()
    return run


def history_rows(path):
    """The whole rows of a history CSV that another process may still be
    appending to, as lists of floats."""
    with open(path) as f:
        lines = f.read().split("\n")[1:-1]  # the header; a partial row
    return [[float(x) for x in line.split(",")] for line in lines]


def cpu_rows(run, what):
    """The first rows a CPU run of :func:`start_cli_cpu` was to write, once
    it has stopped; a run that ended by itself must have exited 0."""
    rc = run["proc"].wait()
    run["watch"].join()
    run["log"].close()
    rows = history_rows(run["history"])
    with open(run["out"] + ".log") as f:
        check((rc == 0 or run["stopped"]) and len(rows) >= run["n_rows"],
              f"the CPU {what} run exited {rc} after {len(rows)} rows:\n"
              f"{f.read()[-2000:]}")
    return np.array(rows[:run["n_rows"]])


def held_to_cpu(what, rows, ref, names, differences):
    """Holds a card run's first rows to a CPU run's (:func:`cpu_rows`): the
    same points, every loglik within VALUE64_RTOL; with ``differences``
    (a finite-difference run: the start point, then one step a coordinate)
    each difference from the start point within FD_ATOL nats of the CPU's.
    Returns the largest relative error, the largest gap between the
    differences and a note on each difference."""
    n = ref.shape[0]
    check(rows.shape[0] >= n, f"{what} history too short")
    check(np.array_equal(rows[:n, 1:-2], ref[:, 1:-2]),
          f"the card's first {n} {what} points differ from the CPU's")
    rel = np.abs(rows[:n, -2] - ref[:, -2]) / np.abs(ref[:, -2])
    check(bool((rel <= VALUE64_RTOL).all()),
          f"the card's first {n} {what} logliks off the CPU f64 ones by {rel}")
    diffs, worst = [], 0.0
    for k in range(1, n if differences else 1):  # rows 1.. against row 0
        moved = np.flatnonzero(rows[k, 1:-2] != rows[0, 1:-2])
        check(moved.size == 1, f"{what} evaluation {k} is not one "
                               "coordinate's step")
        j = int(moved[0])
        h = rows[k, 1 + j] - rows[0, 1 + j]
        d_card, d_cpu = rows[k, -2] - rows[0, -2], ref[k, -2] - ref[0, -2]
        worst = max(worst, abs(d_card - d_cpu))
        diffs.append(f"{names[j]}: step {h:.3g}, difference card {d_card:.6g} "
                     f"vs CPU {d_cpu:.6g} nats, slope card "
                     f"{d_card / h:.8g} vs CPU {d_cpu / h:.8g}")
    check(worst <= FD_ATOL,
          f"the card's {what} differences off the CPU's by up to "
          f"{worst:.3g} nats (atol {FD_ATOL:g}): {'; '.join(diffs)}")
    return float(rel.max()), worst, diffs


def phase_cli_fd(card, dev, workdir, cli):
    """``--no-grad`` with ``settings.method: L-BFGS-B`` on the card, at its
    default precision (the value path in f64): its first evaluations (the
    start point, then the start point stepped in one coordinate at a time)
    against the same CLI on the CPU in f64.  Each finite difference is held
    to FD_ATOL nats of the CPU's."""
    import torch

    from itrails_tpu_torch.cli.optimize import main
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq

    fd = cli["fd"]
    out = os.path.join(workdir, "run_fd_card", "sim")
    cuda_fwd.forward_fused.launches = 0
    cuda_longseq.chunk_operators_fused.launches = 0
    t0 = time.perf_counter()
    main([fd["config"], "--output", out, "--no-grad", "--maxiter", "1"])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    k1, k5 = (cuda_fwd.forward_fused.launches,
              cuda_longseq.chunk_operators_fused.launches)
    t0 = time.perf_counter()
    ref = cpu_rows(fd["cpu"], "finite-difference")
    wait_s = time.perf_counter() - t0
    rows = np.loadtxt(out + ".optimization_history.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    with open(out + ".optimization_history.csv") as f:
        names = f.readline().strip().split(",")[1:-2]
    n_eval = rows.shape[0]
    check(k1 == n_eval * (cli["per_eval"] - 1) and k5 == n_eval,
          f"finite-difference run: K1 launches {k1}, K5 launches {k5} for "
          f"{n_eval} evaluations")
    rel, worst, diffs = held_to_cpu("finite-difference", rows, ref, names,
                                    differences=True)
    print(f"{card} | phase 3 optimize CLI 3x3 --no-grad L-BFGS-B (finite "
          f"differences, f64 value path), --maxiter 1: {n_eval} evaluations "
          f"on the card in {card_s:.2f} s (K1 launches {k1}, K5 launches "
          f"{k5}); the CPU run (f64, started before phase 2, stopped after "
          f"its "
          f"first {ref.shape[0]} rows, ended {fd['cpu']['ended']:.1f} s into "
          f"the run) waited {wait_s:.1f} s after; first {ref.shape[0]} "
          f"evaluation points equal, logliks rel err up to {rel:.3g} (rtol "
          f"{VALUE64_RTOL:g}); finite differences within {worst:.3g} nats of "
          f"the CPU's (atol {FD_ATOL:g}): {'; '.join(diffs)}")


def history_digest(path):
    """The first 16 hex digits of the SHA-256 of an optimize history with
    its time column cut: equal digests across runs mean the runs repeated
    bit for bit (every digit of every parameter and loglik)."""
    import hashlib

    with open(path) as f:
        text = "\n".join(line.rstrip("\n").rsplit(",", 1)[0] for line in f)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def file_digest(path):
    """The first 16 hex digits of the SHA-256 of a file's bytes."""
    import hashlib

    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:16]


def phase_int_kernels(card, dev, reps):
    """K1 and K5 at M = 36, the introgression model's 3x3 width, in f64 (the
    int CLI's default) on tokens simulated from it: K1 on the CLI's bucket
    shape (100 x 10,112, PAD tails), K5 on a 320 kb block's columns in
    chunks of ROUTE_CHUNK; each against its f64 plain version on the card
    (VALUE64_RTOL), timed beside its bound."""
    import torch

    from itrails_tpu_torch.data.simulate import simulate_token_batch
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq, longseq

    a, bfull, pi, b = build_tables(3, 3, dev, introgression=True)
    m = a.shape[0]
    check(m == 36, f"the 3x3 introgression model has {m} states, not 36")
    gen = torch.Generator(device=dev).manual_seed(41)
    w, t = K1_BUCKET[3], K1_BUCKET[4]
    # phase 3's layout: w windows for the bucket, the rest joined into the
    # long block (one sequential simulation of CLI_LAYOUT[1] columns)
    sim = simulate_token_batch(a, b, pi, w + CLI_LAYOUT[2], CLI_LAYOUT[1], gen)
    tok = torch.full((w, t), -1, dtype=torch.int32, device=dev)
    tok[:, :CLI_LAYOUT[1]] = sim[:w]
    _, ll = cuda_fwd.forward_fused(a, bfull, pi, tok)
    t0 = time.perf_counter()
    _, ll_ref = cuda_fwd.forward_fused_plain(a, bfull, pi, tok)
    torch.cuda.synchronize()
    k1_plain = 1e3 * (time.perf_counter() - t0)
    k1_err = float(((ll - ll_ref).abs() / ll_ref.abs().clamp(min=1.0)).max())
    check(k1_err <= VALUE64_RTOL, f"K1 at M=36 f64: per-window loglik off the "
                                  f"plain version by {k1_err:.3g}")
    k1_ms = cuda_ms(lambda: cuda_fwd.forward_fused(a, bfull, pi, tok), reps)
    k1_bound, k1_by = k1_bound_ms(m, tok, size=8)

    n_g = -(-(LONG_BLOCK - 1) // longseq.ROUTE_CHUNK)
    block = sim[w:].reshape(-1)
    check(block.numel() == LONG_BLOCK, "phase 2's M=36 block is not 320 kb")
    tok_g = longseq.chunk_matrix(block, 0, n_g, longseq.ROUTE_CHUNK)
    ops, logz = cuda_longseq.chunk_operators_fused(a, bfull, tok_g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops_ref, logz_ref = cuda_longseq.chunk_operators(
        a, bfull, tok_g.reshape(-1), longseq.ROUTE_CHUNK)
    torch.cuda.synchronize()
    k5_plain = 1e3 * (time.perf_counter() - t0)
    k5_err = float((ops - ops_ref).abs().max())
    logz_err = float(((logz - logz_ref).abs()
                      / logz_ref.abs().clamp(min=1.0)).max())
    check(k5_err <= VALUE64_RTOL and logz_err <= VALUE64_RTOL,
          f"K5 at M=36 f64: operators off the plain version by {k5_err:.3g}, "
          f"log scales by {logz_err:.3g}")
    k5_ms = cuda_ms(lambda: cuda_longseq.chunk_operators_fused(a, bfull, tok_g),
                    reps)
    k5_bound, k5_by = k5_bound_ms(m, tok_g, size=8)
    print(f"{card} | phase 2 introgression 3x3 M={m} f64 (tokens simulated "
          f"from the int model): K1 on ({w}, {t}) {k1_ms:.4f} ms (mean of "
          f"{reps}), bound {k1_bound:.4f} ms ({k1_by}), {k1_bound / k1_ms:.1%} "
          f"of bound, plain f64 {k1_plain:.1f} ms, per-window ll max rel err "
          f"{k1_err:.3g}; K5 on C={n_g} L={longseq.ROUTE_CHUNK} {k5_ms:.4f} "
          f"ms, bound {k5_bound:.4f} ms ({k5_by}), {k5_bound / k5_ms:.1%} of "
          f"bound, plain f64 {k5_plain:.1f} ms, operators max abs err "
          f"{k5_err:.3g}, log scales max rel err {logz_err:.3g} (gate "
          f"{VALUE64_RTOL:g})")


def int_cli_setup(dev, workdir):
    """Phase 3b's MAF, simulated from the 3x3 int model in phase 3's layout,
    and its configs; starts the two ``--device cpu`` runs that
    :func:`phase_int_cli_cpu` holds the card to, in processes of their own,
    which overlap the card's phases from phase 2 on."""
    t0 = time.perf_counter()
    maf, v_lst, buckets, long_idx = cli_maf(dev, workdir, "sim_int3x3", 13,
                                            introgression=True)
    paths = {}
    for tag, method in (("nm", "Nelder-Mead"), ("fd", "L-BFGS-B"),
                        ("default", None)):
        settings = dict(INT_CONFIG["settings"], input_maf=maf)
        if method is not None:
            settings["method"] = method
        paths[tag] = write_config(workdir, f"config_int_{tag}",
                                  dict(INT_CONFIG, settings=settings))
    n_var = len(INT_CONFIG["optimized_parameters"])
    # the rows compared: the start point and one step a coordinate
    module = "itrails_tpu_torch.cli.int_optimize"
    cpu = {"nm": start_cli_cpu(workdir, module, "_", paths["nm"], "int_nm",
                               n_var + 1),
           "fd": start_cli_cpu(workdir, module, "_", paths["fd"], "int_fd",
                               n_var + 1, "--no-grad")}
    return {"v_lst": v_lst, "buckets": buckets, "long_idx": long_idx,
            "paths": paths, "cpu": cpu, "prep_s": time.perf_counter() - t0}


def phase_int_cli(card, dev, workdir, setup):
    """The introgression value path: the int optimize CLI at the full width
    of ``examples/example_config_int.yaml`` (3x3, M = 36, nine parameters
    free) on a MAF simulated from the 3x3 int model in phase 3's layout
    (1.32 M columns, one 320 kb block), on the card: its default refused
    before any launch; Nelder-Mead with K1's and K5's counters reset just
    before and read just after (K1 once a bucket and K5 once for the long
    block an evaluation), evaluation 0 against the f64 plain versions on
    the card, the state maps; scipy's finite-difference L-BFGS-B
    (``--no-grad``); the seconds of an evaluation split into build and
    decode.  On :func:`int_cli_setup`'s MAF, whose two CPU runs
    :func:`phase_int_cli_cpu` checks later."""
    import csv

    import torch

    from itrails_tpu_torch.cli.common import prepare_optimize_setup
    from itrails_tpu_torch.cli.int_optimize import main
    from itrails_tpu_torch.config import load_config
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq
    from itrails_tpu_torch.optim.cases import resolve_times_introgression
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    t_phase = time.perf_counter()
    v_lst, paths = setup["v_lst"], setup["paths"]
    buckets, long_idx = setup["buckets"], setup["long_idx"]
    n_var = len(INT_CONFIG["optimized_parameters"])

    # the default (no method key): exact gradients, refused before a build
    cuda_fwd.forward_fused.launches = 0
    cuda_longseq.chunk_operators_fused.launches = 0
    refused = os.path.join(workdir, "int_default", "sim")
    message = ""
    try:
        main([paths["default"], "--output", refused])
        code = 0
    except SystemExit as exc:  # a message exits with 1
        code = 1 if isinstance(exc.code, str) else exc.code
        message = str(exc.code)
    check(code not in (0, None) and "--no-grad" in message
          and "settings.method: Nelder-Mead" in message,
          f"the int CLI's default did not refuse: exit {code}")
    check(cuda_fwd.forward_fused.launches == 0
          and cuda_longseq.chunk_operators_fused.launches == 0
          and not os.path.exists(os.path.dirname(refused)),
          "the refused int default launched a kernel or wrote an artifact")

    out = os.path.join(workdir, "int_nm", "sim")
    rows, best_ll, cli_s, k1, k5 = optimize_on_card(
        main, paths["nm"], out, "_", n_var, buckets, long_idx, "--maxiter",
        "2")
    n_eval = rows.shape[0]
    run_dir = os.path.dirname(out)
    with open(os.path.join(run_dir, "hidden_states.csv")) as f:
        hidden = list(csv.reader(f))
    with open(os.path.join(run_dir, "observed_states.csv")) as f:
        observed = list(csv.reader(f))
    check(hidden[0] == ["idx", "hidden"] and len(hidden) == 1 + 36
          and sum(r[1].startswith("(4,") for r in hidden[1:]) == 9,
          "hidden_states.csv is not the 36 states with 9 V4 states")
    check(observed[0] == ["idx", "observed"] and len(observed) == 1 + 256
          and observed[1] == ["0", "AAAA"], "observed_states.csv is not the "
                                            "256 unambiguous tokens")

    # evaluation 0 against the f64 plain versions on the card
    prep = prepare_optimize_setup(load_config(paths["nm"]),
                                  introgression=True)
    x = resolve_times_introgression(prep["case"], dict(
        prep["fixed_dict"], **dict(zip(prep["optim_variables"],
                                        prep["optim_list"]))))
    engine = LoglikEngine(v_lst, 3, 3, device=dev, introgression=True)
    ref = engine.loglik_plain(x)
    rel = abs(rows[0, -2] - ref) / abs(ref)
    check(rel <= VALUE64_RTOL, f"int evaluation 0 off the f64 plain versions "
                               f"by {rel:.3g} (rtol {VALUE64_RTOL:g})")

    out_fd = os.path.join(workdir, "int_fd", "sim")
    cuda_fwd.forward_fused.launches = 0
    cuda_longseq.chunk_operators_fused.launches = 0
    t0 = time.perf_counter()
    main([paths["fd"], "--output", out_fd, "--no-grad", "--maxiter", "1"])
    torch.cuda.synchronize()
    fd_s = time.perf_counter() - t0
    fd_k1 = cuda_fwd.forward_fused.launches
    fd_k5 = cuda_longseq.chunk_operators_fused.launches
    fd_rows = np.loadtxt(out_fd + "_optimization_history.csv", delimiter=",",
                         skiprows=1, ndmin=2)
    # the line search also tries points with t_1 < t_m, where the model
    # does not exist: the engine gives NaN there with no build or launch
    names = prep["optim_variables"]
    built = (fd_rows[:, 1 + names.index("t_1")]
             >= fd_rows[:, 1 + names.index("t_m")])
    check(bool(np.isnan(fd_rows[~built, -2]).all()),
          "an int evaluation at t_1 < t_m has a value")
    check(fd_k1 == int(built.sum()) * len(buckets)
          and fd_k5 == int(built.sum()) * len(long_idx),
          f"int finite-difference run: K1 {fd_k1}, K5 {fd_k5} launches for "
          f"{int(built.sum())} evaluations at t_1 >= t_m (of "
          f"{fd_rows.shape[0]})")

    # an evaluation's seconds, split into build and decode (host clock,
    # synchronized), over three evaluations after a first
    engine.loglik(x)
    engine.seconds = {k: 0.0 for k in engine.seconds}
    for _ in range(3):
        engine.loglik(x)
    build_s, decode_s = (engine.seconds[k] / 3 for k in ("build", "decode"))
    print(f"{card} | phase 3b introgression optimize CLI 3x3 (M=36, "
          f"{n_var} parameters free) Nelder-Mead: "
          f"{sum(len(v) for v in v_lst)} columns in {len(v_lst)} blocks "
          f"({len(buckets)} bucket(s) + {len(long_idx)} long block), {n_eval} "
          f"evaluations in {cli_s:.2f} s ({cli_s / n_eval:.3f} s/eval), K1 "
          f"launches {k1} = {n_eval} x {len(buckets)}, K5 launches {k5} = "
          f"{n_eval} x {len(long_idx)}, best loglik {best_ll:.6f}, eval 0 vs "
          f"the f64 plain versions rel err {rel:.3g} (rtol "
          f"{VALUE64_RTOL:g}); an evaluation {build_s + decode_s:.4f} s = "
          f"build {build_s:.4f} + decode {decode_s:.4f} s (mean of 3); the "
          f"default (exact gradients) refused before any launch (exit "
          f"{code}); hidden_states.csv 36 rows (9 V4), observed_states.csv "
          f"256; --no-grad L-BFGS-B {fd_rows.shape[0]} evaluations in "
          f"{fd_s:.2f} s ({int((~built).sum())} of them at t_1 < t_m, NaN "
          f"with no build; K1 {fd_k1}, K5 {fd_k5}); history digests: "
          f"Nelder-Mead {history_digest(out + '_optimization_history.csv')}, "
          f"finite differences "
          f"{history_digest(out_fd + '_optimization_history.csv')}; "
          f"simulation + MAF {setup['prep_s']:.1f} s (before phase 2), "
          f"the phase {time.perf_counter() - t_phase:.1f} s")
    return {"cpu": setup["cpu"], "nm": rows, "fd": fd_rows, "names": names}


def phase_int_cli_cpu(card, state):
    """Phase 3b's two runs against the same CLI with ``--device cpu``
    (started before phase 2): Nelder-Mead's initial simplex (the start
    point and one step a coordinate) at the same points within
    VALUE64_RTOL, and finite-difference L-BFGS-B's start point and one step
    a coordinate at the same points within VALUE64_RTOL, every difference
    within FD_ATOL nats of the CPU's."""
    waits, refs = {}, {}
    for tag, run in state["cpu"].items():
        t0 = time.perf_counter()
        refs[tag] = cpu_rows(run, f"int {tag}")
        waits[tag] = time.perf_counter() - t0
    nm_rel, _, _ = held_to_cpu("int Nelder-Mead", state["nm"], refs["nm"],
                               state["names"], differences=False)
    fd_rel, worst, _ = held_to_cpu("int finite-difference", state["fd"],
                                   refs["fd"], state["names"],
                                   differences=True)
    n = refs["nm"].shape[0]
    print(f"{card} | phase 3b introgression CLI against --device cpu (f64, "
          f"started before phase 2, each stopped after its first {n} rows, "
          f"ended {state['cpu']['nm']['ended']:.1f} / "
          f"{state['cpu']['fd']['ended']:.1f} s into the run, waited "
          f"{waits['nm']:.1f} / {waits['fd']:.1f} s after): Nelder-Mead's "
          f"first {n} evaluations at the same points, logliks rel err up to "
          f"{nm_rel:.3g} (rtol {VALUE64_RTOL:g}); finite-difference "
          f"L-BFGS-B's first {n} points equal, logliks rel err up to "
          f"{fd_rel:.3g}, differences within {worst:.3g} nats of the CPU's "
          f"(atol {FD_ATOL:g})")


def phase_cli_grad(card, dev, workdir, cli):
    """The main path: the optimize CLI on its default, exact-gradient
    L-BFGS-B, at 3x3 on phase 3's MAF.  Returns its K2 calls, its K5
    launches and its best-model YAML."""
    import torch
    import yaml

    from itrails_tpu_torch.cli.common import prepare_optimize_setup
    from itrails_tpu_torch.cli.optimize import main
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_grad, cuda_longseq, longseq
    from itrails_tpu_torch.optim.cases import resolve_times

    config = dict(cli["config"])
    config["settings"] = {k: v for k, v in config["settings"].items()
                          if k != "method"}  # the default applies
    cfg_path = os.path.join(workdir, "config_grad.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    out = os.path.join(workdir, "run_grad", "sim")
    k2 = cuda_grad.loglik_and_grads_fused
    shapes = []  # each K2 call's (W, T) and whether it took boundary rows

    def recorded(a, bfull, pi, tokens, **rows):
        shapes.append((tuple(tokens.shape), bool(rows)))
        return k2(a, bfull, pi, tokens, **rows)

    # in place of the wrapper, which counts its calls on its module name:
    # those land on the recorder while it is there
    cuda_grad.loglik_and_grads_fused = recorded
    recorded.calls = 0
    cuda_fwd.forward_fused.launches = 0
    cuda_longseq.chunk_operators_fused.launches = 0
    try:
        t0 = time.perf_counter()
        main([cfg_path, "--output", out, "--maxiter", "3"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        cuda_grad.loglik_and_grads_fused = k2
    calls = recorded.calls
    k1_launches = cuda_fwd.forward_fused.launches
    k5_launches = cuda_longseq.chunk_operators_fused.launches

    rows = np.loadtxt(out + ".optimization_history.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    with open(out + ".best_model.yaml") as f:
        best = yaml.safe_load(f)
    n_eval = rows.shape[0]
    n_long = cli["per_eval"] - 1
    check(n_eval >= 2 and rows.shape[1] == 6 + 3, "grad history has the wrong shape")
    check(np.array_equal(rows[:, 0], np.arange(n_eval)),
          "grad history is not one row per evaluation")
    check(np.isfinite(rows).all(), "grad history holds non-finite values")
    best_ll = best["results"]["log_likelihood"]
    check(np.isfinite(best_ll) and best_ll == rows[:, -2].max(),
          "grad best-model loglik is not the best history row")
    check(calls == n_eval * cli["per_eval"] and len(shapes) == calls,
          f"K2 called {calls} times for {n_eval} evaluations x "
          f"{cli['per_eval']} batches (a bucket, and a chunk call per long "
          f"block)")
    check(k1_launches == 0 and k5_launches == n_eval * n_long,
          f"the gradient path launched K1 {k1_launches} times and K5 "
          f"{k5_launches} times for {n_eval} evaluations x {n_long} long "
          f"block(s)")
    chunk_calls = [shape for shape, with_rows in shapes if with_rows]
    check(len(chunk_calls) == n_eval * n_long
          and all(t == longseq.ROUTE_CHUNK + 1 for _, t in chunk_calls)
          and all(t < LONG_BLOCK for (_, t), _ in shapes),
          f"K2 walked a long block as one window, or not as chunks: {shapes}")
    rel = abs(rows[0, -2] - cli["ref"]) / abs(cli["ref"])
    check(rel <= 1e-6, f"grad evaluation 0 off the f64 reference by {rel:.3g}")

    # evaluation 0's gradient: the engine's (K2 on each bucket, K5 and K2 on
    # the long block's chunks) against the plain f64 version on every batch,
    # the long block walked as one window on the CPU, chained through the
    # same build; on the way, K2 on each bucket and the long-block route
    # alone against their plain versions on the card
    setup = prepare_optimize_setup(config)
    names, x0 = setup["optim_variables"], np.asarray(setup["optim_list"])
    engine = cli["engine"]
    ll_k2, g_k2 = engine.loglik_and_grad_fn(
        names, setup["fixed_dict"], setup["case"], resolve_times)(x0)
    rel_again = abs(ll_k2 - rows[0, -2]) / abs(rows[0, -2])
    check(rel_again <= 1e-12, "the engine's evaluation 0 differs from the CLI's")
    vec = torch.tensor(x0, dtype=torch.float64, device=dev, requires_grad=True)
    d = resolve_times(setup["case"],
                      {**setup["fixed_dict"], **dict(zip(names, vec.unbind()))})
    a, bfull, pi, _ = build_tables(3, 3, dev, d)
    tables = [x.detach() for x in (a, bfull, pi)]
    tables32 = [x.float().contiguous() for x in tables]
    cpu = torch.device("cpu")
    sums = [torch.zeros_like(x) for x in tables]
    per_batch = []  # each route against its plain version, and its ms
    t0 = time.perf_counter()
    routes = [(tok, cuda_grad.loglik_and_grads_plain,
               cuda_grad.loglik_and_grads_fused) for tok in engine.batches]
    routes += [(tok, longseq.forward_loglik_long_and_grads_plain,
                longseq.forward_loglik_long_and_grads)
               for tok in engine.long_blocks]
    for tok, plain, route in routes:
        ll_p, grads_p = plain(*tables, tok)
        ll_b, grads_b = route(*tables32, tok)
        b_rel = abs(float(ll_b) - float(ll_p)) / abs(float(ll_p))
        errs, medians, ok = grad_errors(grads_b, grads_p)
        check(b_rel <= 1e-6 and ok,
              f"the {tuple(tok.shape)} batch off the plain version: "
              f"loglik {b_rel:.3g}, {grad_note(errs, medians)}")
        if tok.dim() == 1:  # the whole sum holds the one-window walk
            walk = [time.perf_counter() - STARTED]
            _, grads_p = cuda_grad.loglik_and_grads_plain(
                *(x.to(cpu) for x in tables), tok.to(cpu)[None])
            walk.append(time.perf_counter() - STARTED)
        for acc, g in zip(sums, grads_p):
            acc += g.to(dev)
        ms = cuda_ms(lambda: route(*tables32, tok), 1)
        name = "K2" if tok.dim() == 2 else "K5 + boundary rows + K2 chunks"
        per_batch.append(f"{name} {tuple(tok.shape)} {ms:.2f} ms, vs plain "
                         f"f64 on the card: loglik rel err {b_rel:.3g}, "
                         f"{grad_note(errs, medians)}")
    plain_s = time.perf_counter() - t0
    (g_ref,) = torch.autograd.grad((a, bfull, pi), vec, sums)
    g_ref = g_ref.cpu().numpy()
    g_rel = np.abs(g_k2 - g_ref) / np.abs(g_ref)
    check(bool((g_rel <= 2e-3).all()),
          f"evaluation 0's gradient off the plain version by {g_rel}")
    print(f"{card} | phase 4 optimize CLI 3x3 default (L-BFGS-B, exact "
          f"gradients): {n_eval} evaluations in {cli_s:.2f} s "
          f"({cli_s / n_eval:.3f} s/eval), K2 calls {calls} = {n_eval} x "
          f"{cli['per_eval']} (the long block's: {chunk_calls[0]} chunk "
          f"windows with boundary rows), K1 launches {k1_launches}, K5 "
          f"launches {k5_launches} = {n_eval} x {n_long}, best loglik "
          f"{best_ll:.6f}; eval 0 vs plain f64 loglik rel err {rel:.3g} "
          f"(rtol 1e-6), gradient rel err per parameter "
          f"{', '.join(f'{e:.2g}' for e in g_rel)} (rtol 2e-3, against the "
          f"plain f64 version on every batch, the long block walked as one "
          f"window on the CPU, {plain_s:.1f} s, the walk from "
          f"{walk[0]:.1f} to {walk[1]:.1f} s into the run); history digest "
          f"{history_digest(out + '.optimization_history.csv')}; per "
          f"evaluation: {'; '.join(per_batch)}")
    return calls, k5_launches, out + ".best_model.yaml"


def phase_genome(card, dev):
    """LoglikEngine on 33.5 M simulated columns: value, then gradient."""
    import torch

    from itrails_tpu_torch.data.simulate import simulate_token_batch
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_grad
    from itrails_tpu_torch.optim.cases import resolve_times
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    t0 = time.perf_counter()
    a, _, pi, b = build_tables(3, 3, dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    tok = simulate_token_batch(a, b, pi, *GENOME, gen).cpu().numpy()
    engine = LoglikEngine(list(tok), 3, 3, device=dev)
    prep_s = time.perf_counter() - t0
    check(engine.n_columns == GENOME[0] * GENOME[1],
          "genome batch has the wrong size")

    n_evals = 4
    values = []
    cuda_fwd.forward_fused.launches = 0
    for k in range(n_evals):
        values.append(engine.loglik(
            start_params(3, 3, t_1=START["t_1"] * (1 + 0.01 * k))))
    launches = cuda_fwd.forward_fused.launches
    check(all(np.isfinite(values)), "genome-scale loglik is not finite")
    check(launches == n_evals * len(engine.batches),
          f"genome phase: K1 launched {launches} times for {n_evals} evals")
    build_s = engine.seconds["build"] / n_evals
    decode_s = engine.seconds["decode"] / n_evals
    print(f"{card} | phase 5 LoglikEngine 3x3 on {engine.n_columns} columns "
          f"({GENOME[0]} x {GENOME[1]}): {build_s + decode_s:.4f} s/eval = build "
          f"{build_s:.4f} s + decode {decode_s:.4f} s (mean of {n_evals}, "
          f"first included), K1 launches {launches}, loglik {values[0]:.3f}; "
          f"simulation + packing {prep_s:.1f} s")

    names = list(START)
    fixed = {"n_int_AB": 3, "n_int_ABC": 3}
    vg = engine.loglik_and_grad_fn(names, fixed, frozenset(["t_1"]),
                                   resolve_times)
    engine.seconds = dict.fromkeys(engine.seconds, 0.0)
    cuda_grad.loglik_and_grads_fused.calls = 0
    grad_values = []
    for k in range(n_evals):
        x = np.array([START[n] for n in names])
        x[0] *= 1 + 0.01 * k
        ll, g = vg(x)
        check(np.isfinite(ll) and np.isfinite(g).all(),
              "genome-scale gradient is not finite")
        grad_values.append(ll)
    calls = cuda_grad.loglik_and_grads_fused.calls
    check(calls == n_evals * len(engine.batches),
          f"genome phase: K2 called {calls} times for {n_evals} evals")
    rel = abs(grad_values[0] - values[0]) / abs(values[0])
    check(rel <= 1e-6, f"K2's genome-scale value off K1's by {rel:.3g}")
    split = {k: v / n_evals for k, v in engine.seconds.items()}
    print(f"{card} | phase 5 gradient on the same columns: "
          f"{sum(split.values()):.4f} s/eval = build {split['build']:.4f} s + "
          f"decode (K2) {split['decode']:.4f} s + build backward "
          f"{split['build_backward']:.4f} s (mean of {n_evals}, first "
          f"included), K2 calls {calls}, value vs K1's rel {rel:.3g}")


def read_viterbi_csv(path, lengths):
    """Per-block state arrays from a ``viterbi.csv`` without reference
    coordinates (one row per run of a state, positions 0-based)."""
    paths = [np.full(n, -1, dtype=np.int64) for n in lengths]
    rows = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
    for block, start, end, state in rows:
        paths[block][start:end + 1] = state
    check(all((p >= 0).all() for p in paths), f"{path} leaves columns out")
    return paths


def path_log_score(log_a, log_bt, log_pi, tokens, path):
    """f64 log-score of a state path under the clamped log tables (numpy):
    log pi + the log emissions of its columns + its log transitions; PAD
    columns add nothing.  The difference of two paths' scores is the margin
    by which the better one wins."""
    real = tokens >= 0
    e = log_bt[np.clip(tokens, 0, 624), path]
    score = log_pi[path[0]] + float(e[real].sum())
    return score + float(log_a[path[:-1], path[1:]][real[1:]].sum())


def route_counters():
    """The launch counters of the Viterbi route's kernels, by name: K6 and
    its entry scan, then K3's four parts."""
    from itrails_tpu_torch.hmm import cuda_maxplus, cuda_viterbi

    return {"K6": cuda_maxplus.maxplus_operators,
            "scan": cuda_maxplus.entry_scan,
            "K3 forward": cuda_viterbi.viterbi_forward,
            "K3 entry map": cuda_viterbi.entry_map,
            "K3 chain": cuda_viterbi.chain,
            "K3 backtrack": cuda_viterbi.viterbi_backtrack}


def phase_viterbi_cli(card, dev, workdir, cli, best_yaml):
    """The Viterbi path: the Viterbi CLI at 3x3 on phase 3's MAF, with phase
    4's best model as its config, on the card and then on the CPU in f32
    and f64.  Returns the launches of each route kernel on the card run,
    by name (:func:`route_counters`): the route's on the long block, and
    K3's forward and backtrack once a group of the short blocks' batch."""
    import torch

    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.cli.common import prepare_decode_setup
    from itrails_tpu_torch.cli.viterbi import main
    from itrails_tpu_torch.config import load_config
    from itrails_tpu_torch.hmm import cuda_viterbi, longseq, windows

    lengths = [len(v) for v in cli["v_lst"]]
    n_long = sum(n > decode.LONG_BLOCK_THRESHOLD for n in lengths)
    outs = {label: os.path.join(workdir, f"viterbi_{label}", "sim")
            for label in ("card", "cpu32", "cpu64")}
    counters = route_counters()
    for f in counters.values():
        f.launches = 0
    cuda_viterbi.viterbi_fused.calls = 0
    t0 = time.perf_counter()
    main([best_yaml, "--output", outs["card"]])
    torch.cuda.synchronize()
    calls = cuda_viterbi.viterbi_fused.calls
    route = {name: f.launches for name, f in counters.items()}
    seconds = {"card": time.perf_counter() - t0}
    # the two CPU runs (the plain versions; ~40 s each before the route
    # took the long block) in processes of their own, at once
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = {}
    t0 = time.perf_counter()
    try:
        for label, precision in (("cpu32", "float32"), ("cpu64", "float64")):
            os.makedirs(os.path.dirname(outs[label]), exist_ok=True)
            log = open(outs[label] + ".log", "w")
            procs[label] = (log, subprocess.Popen(
                [sys.executable, "-m", "itrails_tpu_torch.cli.viterbi",
                 best_yaml, "--output", outs[label], "--device", "cpu",
                 "--precision", precision],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env))
        for label, (log, proc) in procs.items():
            rc = proc.wait()
            seconds[label] = time.perf_counter() - t0
            log.flush()
            with open(outs[label] + ".log") as f:
                tail = f.read()[-2000:]
            check(rc == 0, f"the CPU {label} Viterbi CLI exited {rc}:\n{tail}")
    finally:  # no process outlives the phase
        for log, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    runs = {label: (seconds[label], outs[label] + ".viterbi.csv")
            for label in outs}
    long_lengths = [n for n in lengths if n > decode.LONG_BLOCK_THRESHOLD]
    n_groups = sum(len(longseq.viterbi_ranges(n, 27, torch.float32))
                   for n in long_lengths)
    n_states = 27
    # K3 on the short blocks' batch, the forward and the backtrack once a
    # group
    setup = prepare_decode_setup(load_config(best_yaml))
    _, a, bfull, pi = decode.build(setup, "float32", dev)
    short = [v for v in cli["v_lst"] if len(v) <= decode.LONG_BLOCK_THRESHOLD]
    batch = torch.as_tensor(windows.pack_windows(short)[0], device=dev)
    n_short = -(-batch.shape[0] // cuda_viterbi.window_group(batch.shape[1],
                                                            n_states))
    expected = dict.fromkeys(counters, n_groups)
    expected["K3 forward"] += n_short
    expected["K3 backtrack"] += n_short
    check(calls == 1 and n_long >= 1 and route == expected,
          f"K3 called {calls} times for 1 batch of short blocks (one-window K3 "
          f"on a long block is off the path); launches {route}, where "
          f"{n_long} long block(s) in {n_groups} group(s) of chunks and "
          f"{n_short} group(s) of short blocks take {expected}")
    with open(runs["card"][1], "rb") as f:
        card_csv = f.read()
    with open(runs["cpu32"][1], "rb") as f:
        cpu32_csv = f.read()
    on_card = read_viterbi_csv(runs["card"][1], lengths)
    cpu32 = read_viterbi_csv(runs["cpu32"][1], lengths)
    cpu64 = read_viterbi_csv(runs["cpu64"][1], lengths)
    check(all(((p >= 0) & (p < n_states)).all() for p in on_card),
          "the card's paths hold a state out of range")
    long_blocks = [i for i, n in enumerate(lengths)
                   if n > decode.LONG_BLOCK_THRESHOLD]
    long_equal = all(np.array_equal(on_card[i], cpu32[i]) for i in long_blocks)
    check(card_csv == cpu32_csv and long_equal,
          "the card's viterbi.csv differs from the f32 plain version's (CPU): "
          f"{sum(int((x != y).sum()) for x, y in zip(on_card, cpu32))} columns")

    # K3 alone on the short blocks' batch, the route on each long block, on
    # the card's tables
    ms = cuda_ms(lambda: cuda_viterbi.viterbi_fused(a, bfull, pi, batch), 1)
    per_batch = [f"K3 on {tuple(batch.shape)} {ms:.2f} ms"]
    for v in cli["v_lst"]:
        if len(v) > decode.LONG_BLOCK_THRESHOLD:
            tok = torch.as_tensor(np.asarray(v, np.int32), device=dev)
            ms = cuda_ms(lambda: longseq.viterbi_long(a, bfull, pi, tok), 1)
            per_batch.append(f"the route on ({len(v)},) {ms:.2f} ms")

    diff_blocks = [i for i, (x, y) in enumerate(zip(on_card, cpu64))
                   if not np.array_equal(x, y)]
    n_diff = sum(int((on_card[i] != cpu64[i]).sum()) for i in diff_blocks)
    margins = []
    if diff_blocks:  # the f64 score of each path, on f64 tables
        _, a, bfull, pi = decode.build(setup, "float64", "cpu")
        log_a, log_bt, log_pi = (
            x.numpy() for x in cuda_viterbi.log_tables(a, bfull, pi))
        for i in diff_blocks:
            tok = np.asarray(cli["v_lst"][i])
            margins.append(
                path_log_score(log_a, log_bt, log_pi, tok, cpu64[i])
                - path_log_score(log_a, log_bt, log_pi, tok, on_card[i]))
    print(f"{card} | phase 6 Viterbi CLI 3x3 on {sum(lengths)} "
          f"columns in {len(lengths)} blocks ({n_long} long), config "
          f"{os.path.basename(best_yaml)} of phase 4: card {runs['card'][0]:.2f} s "
          f"(K3 calls {calls} on the short blocks, {n_short} group(s); "
          f"launches {route}; alone: "
          f"{', '.join(per_batch)}); CPU f32 and f64 at once in two "
          f"processes, done after {runs['cpu32'][0]:.2f} and "
          f"{runs['cpu64'][0]:.2f} s (host clock, whole CLI); the card's "
          f"viterbi.csv is byte-identical "
          f"to the CPU f32 one ({len(card_csv)} bytes; the "
          f"{lengths[long_blocks[0]] if long_blocks else 0}-column block "
          f"equal at every column); columns where the card's path differs "
          f"from the CPU f64 path: {n_diff} of {sum(lengths)} in "
          f"{len(diff_blocks)} block(s), f64 score margin of the f64 path "
          f"per block {', '.join(f'{x:.3g}' for x in margins) or 'none'}")
    return route


def phase_segmented(card, dev, cli, best_yaml):
    """The segmented route on the card, off the CLI's path since the
    Viterbi route: the 320 kb block in SEGMENT_COLS-column segments against
    its one-pass path."""
    import torch

    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.cli.common import prepare_decode_setup
    from itrails_tpu_torch.config import load_config
    from itrails_tpu_torch.hmm import cuda_viterbi, decoders

    setup = prepare_decode_setup(load_config(best_yaml))
    _, a, bfull, pi = decode.build(setup, "float32", dev)
    (block,) = [v for v in cli["v_lst"] if len(v) > decode.LONG_BLOCK_THRESHOLD]
    tok = torch.as_tensor(np.asarray(block, np.int32), device=dev)
    t0 = time.perf_counter()
    one_pass = decoders.viterbi_fast(a, bfull, pi, tok[None, :])[0].cpu().numpy()
    one_s = time.perf_counter() - t0
    saved = decoders.SEGMENT_COLUMNS
    decoders.SEGMENT_COLUMNS = SEGMENT_COLS
    try:
        cuda_viterbi.viterbi_fused.calls = 0
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        segmented = decoders.viterbi_segmented(a, bfull, pi, tok).cpu().numpy()
        seg_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        calls = cuda_viterbi.viterbi_fused.calls
    finally:
        decoders.SEGMENT_COLUMNS = saved
    n_seg = -(-(len(block) - 1) // SEGMENT_COLS)
    check(calls == 2 * n_seg - 1,
          f"segmented route: {calls} K3 calls for {n_seg} segments")
    check(np.array_equal(segmented, one_pass),
          f"segmented route differs from one pass at "
          f"{int((segmented != one_pass).sum())} columns")
    print(f"{card} | phase 7 segmented Viterbi on the card: the "
          f"{len(block)}-column block in {n_seg} segments of {SEGMENT_COLS} "
          f"columns ({calls} K3 calls) equals its one-pass path at every "
          f"column; segmented {seg_s:.3f} s, one pass {one_s:.3f} s (host "
          f"clock), peak device memory of the segmented call {peak} bytes")


def phase_posterior_cli(card, dev, workdir, cli, best_yaml):
    """The posterior path: the posterior CLI at 3x3 on phase 3's MAF, with
    phase 4's best model as its config, on the card.  Returns K4's and K5's
    launches and the rows it wrote for the long block."""
    import torch

    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.cli.common import prepare_decode_setup
    from itrails_tpu_torch.cli.posterior import main
    from itrails_tpu_torch.config import load_config
    from itrails_tpu_torch.hmm import cuda_longseq, cuda_posterior, decoders, longseq, windows

    v_lst = cli["v_lst"]
    lengths = [len(v) for v in v_lst]
    n_states = 27
    row_bytes = cuda_posterior.store_row_bytes(n_states, dev, torch.float64)
    groups = decoders.posterior_groups(lengths, row_bytes,
                                       decode.LONG_BLOCK_THRESHOLD)
    long_blocks = [i for i, n in enumerate(lengths)
                   if n > decode.LONG_BLOCK_THRESHOLD]
    check(len(long_blocks) == 1, "phase 8 expects one long block")
    route = longseq.posterior_ranges(lengths[long_blocks[0]], n_states, dev,
                                     torch.float64)
    n_calls = len(groups) - 1 + len(route)  # the window groups, the route's
    out = os.path.join(workdir, "posterior_card", "sim")

    # the long block's f64 reference, on the CPU in a process of its own
    # while the card runs the CLI
    tok_path = os.path.join(workdir, "long_block.npy")
    ref_path = os.path.join(workdir, "long_block_post.npy")
    np.save(tok_path, np.asarray(v_lst[long_blocks[0]], np.int32))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    log = open(ref_path + ".log", "w")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", POSTERIOR_REF, best_yaml, tok_path, ref_path],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    try:
        pieces = []
        seconds = {"decode": 0.0, "writer": 0.0}
        run, write = decode.run_posterior, decode.write_posterior_csv
        k4 = cuda_posterior.posterior_fused
        shapes = []  # each K4 call's (W, T)

        def recorded(a, bfull, pi, tokens, **rows):
            shapes.append(tuple(tokens.shape))
            return k4(a, bfull, pi, tokens, **rows)

        def capture(*args):  # the rows the CLI writes, and the decode's time
            it = run(*args)
            while True:
                t0 = time.perf_counter()
                item = next(it, None)
                torch.cuda.synchronize()
                seconds["decode"] += time.perf_counter() - t0
                if item is None:
                    return
                pieces.append(item)
                yield item

        def timed_write(*args):
            t0 = time.perf_counter()
            write(*args)
            seconds["writer"] += time.perf_counter() - t0

        decode.run_posterior, decode.write_posterior_csv = capture, timed_write
        # in place of the wrapper, which counts on its module name: the
        # counts land on the recorder while it is there
        cuda_posterior.posterior_fused = recorded
        try:
            recorded.calls = 0
            recorded.launches = 0
            cuda_longseq.chunk_operators_fused.launches = 0
            t0 = time.perf_counter()
            main([best_yaml, "--output", out])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            calls, launches = recorded.calls, recorded.launches
            k5_launches = cuda_longseq.chunk_operators_fused.launches
        finally:
            decode.run_posterior, decode.write_posterior_csv = run, write
            cuda_posterior.posterior_fused = k4
        t0 = time.perf_counter()
        rc = ref_proc.wait()
        ref_wait_s = time.perf_counter() - t0
    finally:  # no process outlives the phase
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
        log.close()
    with open(ref_path + ".log") as f:
        check(rc == 0, f"the long block's reference exited {rc}:\n{f.read()[-2000:]}")
    check(calls == n_calls and launches == 2 * n_calls and len(shapes) == calls,
          f"K4 called {calls} times with {launches} launches; the CLI's "
          f"{len(groups) - 1} window group(s) and the long block's {len(route)} "
          f"route group(s) take {n_calls} calls and {2 * n_calls} launches")
    check(k5_launches == 2 * len(route),
          f"K5 launched {k5_launches} times for {len(route)} route group(s): "
          "two a group, on a and on a^T")
    chunk_calls = [w for w, t in shapes if t == longseq.ROUTE_CHUNK + 1]
    check(sum(chunk_calls) == route[-1][1]
          and all(t <= decode.LONG_BLOCK_THRESHOLD for _, t in shapes),
          f"K4 walked a block above {decode.LONG_BLOCK_THRESHOLD} columns as one "
          f"window, or the long block not as chunk windows: {shapes}")

    # every column of every block against the f64 plain version
    blocks = {}
    for i, rows in pieces:
        blocks.setdefault(i, []).append(rows)
    check(sorted(blocks) == list(range(len(v_lst)))
          and [i for i, _ in pieces] == sorted(i for i, _ in pieces),
          "the CLI did not hand every block on, in block order")
    rows = {i: np.concatenate(p) for i, p in blocks.items()}
    check(all(rows[i].shape == (n, n_states) and rows[i].dtype == np.float64
              for i, n in enumerate(lengths)),
          "misshapen posterior rows: the CLI's default is f64")
    setup = prepare_decode_setup(load_config(best_yaml))
    _, a, bfull, pi = decode.build(setup, "float64", dev, posterior=True)
    errs, per_batch = [], []  # per batch: max abs err, and its decode alone
    for group in groups:
        if group == long_blocks:
            tok = torch.as_tensor(np.asarray(v_lst[group[0]], np.int32),
                                  device=dev)
            errs.append(float(np.abs(rows[group[0]] - np.load(ref_path)).max()))
            ms = cuda_ms(lambda: list(longseq.posterior_long_pieces(a, bfull, pi,
                                                                    tok)), 1)
            per_batch.append(f"the long block {len(tok)} columns: the route ("
                             f"{len(route)} group(s) of (C, "
                             f"{longseq.ROUTE_CHUNK + 1}) windows) {ms:.2f} ms, "
                             f"max abs err {errs[-1]:.3g}")
            continue
        tok, _, _ = windows.pack_windows([v_lst[i] for i in group])
        tok = torch.as_tensor(tok, device=dev)
        ref, _ = cuda_posterior.posterior_fused_plain(a, bfull, pi, tok)
        errs.append(max(float((torch.as_tensor(rows[i], device=dev).double()
                               - ref[:lengths[i], w]).abs().max())
                        for w, i in enumerate(group)))
        del ref
        ms = cuda_ms(lambda: cuda_posterior.posterior_fused(a, bfull, pi, tok), 1)
        per_batch.append(f"K4 {tuple(tok.shape)} {ms:.2f} ms, max abs err "
                         f"{errs[-1]:.3g}")
    err = max(errs)
    check(err <= POST64_ATOL, f"the CLI's posterior is off the f64 plain "
                              f"version by {err:.3g} (atol {POST64_ATOL:g})")

    # the CSV: its header, one line a column, and rows of every block read
    # back as the card's f64 values
    path = out + ".posterior.csv"
    starts = np.concatenate([[0], np.cumsum(lengths)])
    samples = {}
    for i, n in enumerate(lengths):
        for k in {0, n // 2, n - 1}:
            samples[1 + int(starts[i]) + k] = (i, k)
    n_lines = 0
    with open(path, newline="") as f:
        header = f.readline()
        for n_lines, line in enumerate(f, start=1):
            if n_lines in samples:
                i, k = samples[n_lines]
                fields = line.rstrip("\n").split(",")
                check(fields[:2] == [str(i), str(k)]
                      and [float(x) for x in fields[2:]] == rows[i][k].tolist(),
                      f"CSV line {n_lines} is not block {i} column {k} of the "
                      "card's posterior")
    want = ",".join(["alignment_block_idx", "position_idx"]
                    + [f"prob_state_{j}" for j in range(n_states)]) + "\r\n"
    check(header == want, f"posterior CSV header {header!r}")
    check(n_lines == sum(lengths), f"posterior CSV has {n_lines} rows for "
                                   f"{sum(lengths)} columns")
    print(f"{card} | phase 8 posterior CLI 3x3 on {sum(lengths)} columns in "
          f"{len(lengths)} blocks ({len(long_blocks)} long), config "
          f"{os.path.basename(best_yaml)} of phase 4: {cli_s:.2f} s on the card "
          f"(host clock) = decode {seconds['decode']:.2f} s (K4, the long "
          f"block's route and the copies to the host; 0.62 s in PR 14, the long "
          f"block walked by one warp) + write "
          f"{seconds['writer'] - seconds['decode']:.2f} s + "
          f"MAF, build and hidden states "
          f"{cli_s - seconds['writer']:.2f} s; K4 (f64, the CLI's default) "
          f"calls {calls}, launches "
          f"{launches} ({len(groups) - 1} window group(s) + {len(route)} route "
          f"group(s); no call on more than {decode.LONG_BLOCK_THRESHOLD} columns), "
          f"K5 launches {k5_launches}; every column within "
          f"{err:.3g} of the f64 plain version (atol {POST64_ATOL:g}; the long "
          f"block's one-window reference on the CPU, waited {ref_wait_s:.1f} s "
          f"after the CLI); per batch alone: {'; '.join(per_batch)}; CSV "
          f"{os.path.getsize(path)} bytes, header and {n_lines} rows checked, "
          f"{len(samples)} sampled rows equal to the card's f64 values; CSV "
          f"digest {file_digest(path)}")
    return launches, k5_launches, rows[long_blocks[0]]


def phase_posterior_groups(card, dev, cli, best_yaml, route_rows):
    """The route in several groups and the segmented reference: the 320 kb
    block through the route with, in turn, the operator budget and the store
    budget lowered to a fifth of its chunks, against phase 8's one-group
    rows; then ``decoders.posterior_segmented`` with SEGMENT_COLS' segment
    length, bit for bit the one-window K4 rows of the block."""
    import torch

    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.cli.common import prepare_decode_setup
    from itrails_tpu_torch.config import load_config
    from itrails_tpu_torch.hmm import cuda_longseq, cuda_posterior, decoders, longseq

    setup = prepare_decode_setup(load_config(best_yaml))
    _, a, bfull, pi = decode.build(setup, "float64", dev, posterior=True)
    (block,) = [v for v in cli["v_lst"] if len(v) > decode.LONG_BLOCK_THRESHOLD]
    tok = torch.as_tensor(np.asarray(block, np.int32), device=dev)
    m = a.shape[0]
    chunk = longseq.ROUTE_CHUNK
    per_group = -(-(-(-(len(block) - 1) // chunk)) // 5)
    saved = longseq.OPERATOR_BUDGET_BYTES, cuda_posterior.POSTERIOR_BUDGET_BYTES
    parts = []
    for name, budgets in (
            ("operator budget", (per_group * 2 * m * m * 16, saved[1])),
            ("store budget", (saved[0], per_group * (chunk + 1)
                              * cuda_posterior.store_row_bytes(m, dev, a.dtype)))):
        longseq.OPERATOR_BUDGET_BYTES, cuda_posterior.POSTERIOR_BUDGET_BYTES = budgets
        try:
            n_groups = len(longseq.posterior_ranges(len(block), m, dev, a.dtype))
            calls = cuda_posterior.posterior_fused.calls
            k5 = cuda_longseq.chunk_operators_fused.launches
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            pieces = [p.cpu().numpy()
                      for p in longseq.posterior_long_pieces(a, bfull, pi, tok)]
            route_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) - base
            calls = cuda_posterior.posterior_fused.calls - calls
            k5 = cuda_longseq.chunk_operators_fused.launches - k5
        finally:
            longseq.OPERATOR_BUDGET_BYTES, cuda_posterior.POSTERIOR_BUDGET_BYTES = saved
        check(n_groups >= 3 and len(pieces) == n_groups and calls == n_groups
              and k5 == 4 * n_groups - 2,
              f"the route under the lowered {name}: {len(pieces)} pieces, K4 "
              f"called {calls} times and K5 launched {k5} times for {n_groups} "
              "groups (K4 once a group; K5 twice a group, and once a direction "
              "for each group's product but the last's)")
        grouped = np.concatenate(pieces)
        err = float(np.abs(grouped - route_rows).max())
        check(grouped.shape == route_rows.shape and err <= 1e-12,
              f"the route in {n_groups} groups is off phase 8's one-group rows "
              f"by {err:.3g} (atol 1e-12)")
        parts.append(f"under the lowered {name}, {n_groups} groups: K4 calls "
                     f"{calls}, K5 launches {k5}, within {err:.3g} of phase 8's "
                     f"one-group rows (atol 1e-12), {route_s:.3f} s (host clock, "
                     f"copies to the host included), peak device memory {peak} "
                     "bytes")

    one = decoders.posterior_fast(a, bfull, pi, tok[None, :])[:, 0, :]
    seg_cols = SEGMENT_COLS
    saved_cols = decoders.SEGMENT_COLUMNS
    decoders.SEGMENT_COLUMNS = seg_cols
    try:
        cuda_posterior.posterior_fused.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        lo, equal, n_pieces = 0, True, 0
        for piece in decoders.posterior_segmented(a, bfull, pi, tok):
            equal &= bool(torch.equal(piece, one[lo:lo + len(piece)]))
            lo += len(piece)
            n_pieces += 1
        seg_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        launches = cuda_posterior.posterior_fused.launches
    finally:
        decoders.SEGMENT_COLUMNS = saved_cols
    n_seg = -(-(len(block) - 1) // seg_cols)
    check(n_pieces == n_seg and launches == 3 * n_seg - 1,
          f"segmented posterior: {n_pieces} pieces and {launches} K4 launches "
          f"for {n_seg} segments")
    check(equal and lo == len(block),
          "the segmented posterior differs from the one-window K4 rows")
    route_err = float((one - torch.as_tensor(route_rows, device=dev)).abs().max())
    print(f"{card} | phase 9 the posterior route in groups and the segmented "
          f"reference on the {len(block)}-column block: "
          + "; ".join(parts)
          + f"; posterior_segmented in {n_seg} segments of {seg_cols} columns "
          f"({launches} K4 launches: {n_seg - 1} beta sweeps + {n_seg} x 2) "
          f"equals the one-window K4 rows bit for bit, {seg_s:.3f} s (host "
          f"clock), peak device memory {peak} bytes; the one-window rows are "
          f"within {route_err:.3g} of the route's (phase 8)")


def timed(fn):
    """``fn()`` and its device milliseconds, one call timed with events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_long_value(card, dev, cli):
    """The long-block value through its three routes (K5 and the operator
    product, K1 and K2 as one-window batches, K1's one row of a tile) on
    f32 tables, and the K5 route on the f64 tables (the optimize CLI's
    default), against the f64 plain operator path, on phase 3's 320 kb
    block and a 1e7-column block at 3x3 and a 320 kb block at 7x7."""
    import torch

    from itrails_tpu_torch.data.simulate import simulate_token_batch
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_grad, longseq

    cases = []
    for label, n_ab, n_abc, shape, seed in (
            ("3x3 320 kb block of phase 3", 3, 3, None, None),
            ("3x3 1e7 columns", 3, 3, LONG_SIM, 13),
            ("7x7 320 kb", 7, 7, (32, LONG_BLOCK // 32), 14)):
        a, bfull, pi, b = build_tables(n_ab, n_abc, dev)
        if shape is None:
            (block,) = [v for v in cli["v_lst"] if len(v) == LONG_BLOCK]
            tok = torch.as_tensor(block, device=dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            tok = simulate_token_batch(a, b, pi, *shape, gen).reshape(-1)
        cases.append((label, (a, bfull, pi), tok))

    parts, breakeven = [], []
    for label, tables, tok in cases:
        tables = [x.contiguous() for x in tables]
        tables32 = [x.float().contiguous() for x in tables]
        m = tables[0].shape[0]
        ref, plain_ms = timed(lambda: longseq.forward_loglik_long_plain(*tables, tok))
        ref = float(ref)
        routes = {}
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        routes["K5 + product"] = timed(
            lambda: longseq.forward_loglik_long(*tables32, tok))
        peak = torch.cuda.max_memory_allocated(dev) - base
        routes["K5 + product f64"] = timed(
            lambda: longseq.forward_loglik_long(*tables, tok))
        routes["K1 one window"] = timed(
            lambda: cuda_fwd.forward_loglik_fused(*tables32, tok[None]))
        if len(tok) == LONG_BLOCK:
            routes["K2 one window"] = timed(
                lambda: cuda_grad.loglik_and_grads_fused(*tables32, tok[None])[0])
        errs = {}
        for name, (value, _) in routes.items():
            check(value.dtype == torch.float64, f"{label}: {name}'s value is "
                                                f"{value.dtype}")
            errs[name] = float(value) - ref
            rtol = VALUE64_RTOL if name.endswith("f64") else LONG_RTOL
            check(abs(errs[name]) <= rtol * abs(ref),
                  f"{label}: {name} off the f64 plain value by "
                  f"{errs[name]:.4g} nats (rtol {rtol:g})")
        parts.append(
            f"{label} (M={m}, {len(tok)} columns): f64 plain operator path "
            f"{ref:.6f} nats ({plain_ms:.1f} ms; one f32 ulp there is "
            f"{float(np.spacing(np.float32(abs(ref)))):g} nats); "
            + ", ".join(f"{name} {ms:.3f} ms, error {errs[name]:+.4g} nats"
                        for name, (_, ms) in routes.items())
            + f"; K5 route (f32) peak device memory {peak} bytes")
        if len(tok) == LONG_BLOCK:
            breakeven.append(f"M={m} K1 one window / K5 route "
                             f"{routes['K1 one window'][1] / routes['K5 + product'][1]:.1f}x")
    print(f"{card} | phase 10 long-block value, three routes on f32 tables "
          f"and the K5 route on f64 ones against the f64 plain operator path "
          f"on the card (rtol {LONG_RTOL:g}, f64 {VALUE64_RTOL:g}): "
          + "; ".join(parts) + "; " + ", ".join(breakeven))


def phase_long_grad(card, dev, cli):
    """A long block's value and exact gradient through the chunk route (K5,
    the boundary rows, one K2 call over the chunks) on f32 tables, against
    the same route's plain version in f64 on the card on the same f32
    tables (and, without a gate, on the f64 tables: the f32 rounding of the
    tables' own part), on phase 3's 320 kb block and 1e7 simulated columns
    at 3x3 and a simulated 320 kb block at 7x7, with its milliseconds and
    peak device memory; on the 3x3 320 kb block, K2's one-window walk timed
    beside it.  Then the chunk length: on the 320 kb blocks, the route (its
    second call) and K5, the boundary rows and K2 timed apart at each of
    ROUTE_CHUNKS."""
    import torch

    from itrails_tpu_torch.data.tokens import PAD_TOKEN
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_grad, cuda_longseq, longseq

    (block,) = [v for v in cli["v_lst"] if len(v) == LONG_BLOCK]
    cases = [("3x3 320 kb block of phase 3", 3, 3,
              torch.as_tensor(block, device=dev)),
             ("7x7 320 kb", 7, 7, simulated_block(dev, 7, 7, 15)),
             ("3x3 1e7 columns", 3, 3, simulated_block(dev, 3, 3, 16, LONG_SIM))]
    parts, sweep = [], []
    for label, n_ab, n_abc, tok in cases:
        a, bfull, pi, _ = build_tables(n_ab, n_abc, dev)
        tables = [x.contiguous() for x in (a, bfull, pi)]
        tables32 = [x.float().contiguous() for x in tables]
        m = a.shape[0]
        (ll_ref, g_ref), plain_ms = timed(
            lambda: longseq.forward_loglik_long_and_grads_plain(
                *(x.double() for x in tables32), tok))
        ll64, g64 = longseq.forward_loglik_long_and_grads_plain(*tables, tok)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        k5, k2 = (cuda_longseq.chunk_operators_fused.launches,
                  cuda_grad.loglik_and_grads_fused.calls)
        (ll, grads), ms = timed(
            lambda: longseq.forward_loglik_long_and_grads(*tables32, tok))
        peak = torch.cuda.max_memory_allocated(dev) - base
        check((cuda_longseq.chunk_operators_fused.launches - k5,
               cuda_grad.loglik_and_grads_fused.calls - k2) == (1, 1),
              f"{label}: the route did not launch K5 once and call K2 once")
        rel = abs(float(ll) - float(ll_ref)) / abs(float(ll_ref))
        errs, medians, ok = grad_errors(grads, g_ref)
        check(ll.dtype == torch.float64 and rel <= LONG_RTOL and ok,
              f"{label}: the route off the f64 plain route: loglik "
              f"{rel:.3g} (rtol {LONG_RTOL:g}), {grad_note(errs, medians)}")
        ms_again = timed(
            lambda: longseq.forward_loglik_long_and_grads(*tables32, tok))[1]
        rel64 = abs(float(ll) - float(ll64)) / abs(float(ll64))
        errs64, _, _ = grad_errors(grads, g64)
        bound_ms, bound_by = k2_bound_ms(m, tok[None])
        line = (f"{label} (M={m}, {len(tok)} columns, chunk "
                f"{longseq.ROUTE_CHUNK}): route {ms:.3f} / {ms_again:.3f} ms "
                f"(first / second call; K2's function's bound {bound_ms:.4f} "
                f"ms, {bound_by}), loglik {float(ll):.6f} rel err "
                f"{rel:.3g}, {grad_note(errs, medians)} (against the f64 "
                f"tables, no gate: loglik {rel64:.3g}, gradients "
                f"{' / '.join(f'{e:.3g}' for e in errs64)}), peak device "
                f"memory {peak} bytes; f64 plain route {plain_ms:.1f} ms")
        if len(tok) == LONG_BLOCK and m == 27:
            (ll1, g1), one_ms = timed(
                lambda: cuda_grad.loglik_and_grads_fused(*tables32, tok[None]))
            rel1 = abs(float(ll1) - float(ll_ref)) / abs(float(ll_ref))
            errs1, _, _ = grad_errors(g1, g_ref)
            line += (f"; K2 one window {one_ms:.3f} ms (loglik rel err "
                     f"{rel1:.3g}, dA / dbfull / dpi max rel err "
                     f"{' / '.join(f'{e:.3g}' for e in errs1)}), "
                     f"{one_ms / ms_again:.1f}x the route")
        parts.append(line)
        if len(tok) != LONG_BLOCK:
            continue
        _, al0, _ = cuda_fwd.column0(tables32[1], tables32[2], tok[:1])
        for chunk in ROUTE_CHUNKS:
            def route():
                return longseq.forward_loglik_long_and_grads(*tables32, tok,
                                                             chunk=chunk)

            ll_r, g_r = route()
            route_ms = timed(route)[1]
            rel_r = abs(float(ll_r) - float(ll_ref)) / abs(float(ll_ref))
            errs_r, medians_r, ok_r = grad_errors(g_r, g_ref)
            check(rel_r <= LONG_RTOL and ok_r,
                  f"{label} chunk {chunk}: off the f64 plain route: loglik "
                  f"{rel_r:.3g}, {grad_note(errs_r, medians_r)}")
            n_chunks = -(-(len(tok) - 1) // chunk)
            stream = longseq.chunk_matrix(tok, 0, n_chunks, chunk)
            (ops, _), k5_ms = timed(
                lambda: cuda_longseq.chunk_operators_fused(*tables32[:2], stream))

            def rows():
                alpha, beta = longseq.boundary_rows(ops, al0[0],
                                                    torch.ones_like(al0[0]))
                pad = torch.full((n_chunks, 1), PAD_TOKEN, dtype=tok.dtype,
                                 device=dev)
                return (torch.cat([pad, stream], dim=1), alpha.float(),
                        beta.float())

            (windows, alpha, beta), rows_ms = timed(rows)
            _, k2_ms = timed(
                lambda: cuda_grad.loglik_and_grads_fused(
                    *tables32, windows, entry_alpha=alpha, exit_beta=beta))
            del ops, windows, alpha, beta
            sweep.append(f"{label} M={m} L={chunk} C={n_chunks}: K5 "
                         f"{k5_ms:.3f} + boundary rows {rows_ms:.3f} + K2 "
                         f"{k2_ms:.3f} = {k5_ms + rows_ms + k2_ms:.3f} ms, "
                         f"route {route_ms:.3f} ms, loglik rel err "
                         f"{rel_r:.3g}, gradients max rel err "
                         f"{max(errs_r):.3g}")
    print(f"{card} | phase 11 long-block gradient, the chunk route on f32 "
          f"tables against its plain version in f64 on the same tables on "
          f"the card (loglik rtol "
          f"{LONG_RTOL:g}, every gradient entry rtol {GRAD_RTOL:g}): "
          + "; ".join(parts))
    print(f"{card} | phase 11 chunk length, the route's second call and "
          f"each stage timed alone after it (CUDA events, one call each): "
          + "; ".join(sweep))


def mixed_route(k5_tables, k4_tables, tok):
    """A long block's posterior rows (T, M) through the route's stages in
    one group at ROUTE_CHUNK, with K5 on ``k5_tables`` (a, bfull) and K4 on
    ``k4_tables`` (a, bfull, pi), whose dtypes may differ: phase 12 splits
    the route's f32 error with it."""
    import torch

    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq, cuda_posterior, longseq

    a5, b5 = k5_tables
    a, bfull, pi = k4_tables
    chunk, m = longseq.ROUTE_CHUNK, a.shape[0]
    n_chunks = -(-(len(tok) - 1) // chunk)
    stream = longseq.chunk_matrix(tok, 0, n_chunks, chunk)
    _, al0, _ = cuda_fwd.column0(bfull, pi, tok[:1])
    alpha = longseq.entry_rows(
        cuda_longseq.chunk_operators_fused(a5, b5, stream)[0], al0[0])
    beta = longseq.exit_rows(
        cuda_longseq.chunk_operators_fused(a5.T.contiguous(), b5, stream)[0],
        torch.ones((m,), dtype=torch.float64, device=a.device))
    windows = torch.cat([tok[0:n_chunks * chunk:chunk, None], stream], dim=1)
    post, _ = cuda_posterior.posterior_fused(
        a, bfull, pi, windows, alpha0=alpha.to(a.dtype),
        beta_exit=beta.to(a.dtype))
    return torch.cat([post[0, :1], post[1:].transpose(0, 1).reshape(-1, m)]
                     )[:len(tok)]


def phase_long_posterior(card, dev, cli):
    """A long block's posterior through the sequence-parallel route (K5 on
    ``a`` and on ``a^T``, the entry and exit rows, one K4 call over the
    chunk windows) in f64, the posterior CLI's default: on phase 3's 320 kb
    block at 3x3 and a simulated 320 kb block at 7x7, against K4 walking the
    block as one window on the card (and, at 3x3, against the route's plain
    version on the card) at POST64_ATOL, with the route's milliseconds and
    peak device memory, and on f32 tables against the f64 plain version at
    POST_ATOL (3x3), the f32 error split into the tables' rounding, the
    route's own part (K5 in f32 and the boundary rows; gated at POST_ATOL
    against one-window f64 K4 on the same f32 tables) and K4's f32
    arithmetic on the chunk windows and on one window (each gated at
    POST_ATOL); the route's stages (K5 on a, K5 on a^T, the boundary rows,
    K4 on the chunk windows, the rows to the host) timed apart at each of
    ROUTE_CHUNKS; then 1e7 simulated columns at 3x3 against
    ``decoders.posterior_segmented`` on the card, segment by segment, at
    POST64_ATOL."""
    import torch

    from itrails_tpu_torch.hmm import (cuda_fwd, cuda_longseq, cuda_posterior,
                                       decoders, longseq)

    (block,) = [v for v in cli["v_lst"] if len(v) == LONG_BLOCK]
    cases = [("3x3 320 kb block of phase 3", 3, 3,
              torch.as_tensor(block, device=dev)),
             ("7x7 320 kb", 7, 7, simulated_block(dev, 7, 7, 17))]
    parts, sweep = [], []
    for label, n_ab, n_abc, tok in cases:
        tables = [x.contiguous() for x in build_tables(n_ab, n_abc, dev)[:3]]
        a, bfull, pi = tables
        m = a.shape[0]
        (one, _), one_ms = timed(
            lambda: cuda_posterior.posterior_fused(*tables, tok[None]))
        one = one[:, 0, :]
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        k4, k5 = (cuda_posterior.posterior_fused.calls,
                  cuda_longseq.chunk_operators_fused.launches)
        route, ms = timed(lambda: longseq.posterior_long(*tables, tok))
        peak = torch.cuda.max_memory_allocated(dev) - base
        check((cuda_posterior.posterior_fused.calls - k4,
               cuda_longseq.chunk_operators_fused.launches - k5) == (1, 2),
              f"{label}: the route did not call K4 once and launch K5 twice")
        err = float((route - one).abs().max())
        check(route.dtype == torch.float64 and route.shape == one.shape
              and err <= POST64_ATOL,
              f"{label}: the route off one-window K4 by {err:.3g} (atol "
              f"{POST64_ATOL:g})")
        f32 = [x.float().contiguous() for x in tables]
        got32, ms32 = timed(lambda: longseq.posterior_long(*f32, tok))
        if m == 27:
            plain, plain_ms = timed(lambda: longseq.posterior_long_plain(*tables,
                                                                          tok))
            err_plain = float((route - plain).abs().max())
            err32 = float((got32.double() - plain).abs().max())
            del plain
        else:
            err32 = float((got32.double() - one).abs().max())
        del route
        # the f32 error split: the tables' own rounding (one-window f64 K4 on
        # the f32 tables upcast, against the f64 tables); then on those same
        # tables, against one-window f64 K4: the route in f32, its own part
        # (K5 in f32 and the boundary rows, K4 in f64), K4's f32 arithmetic
        # on the chunk windows (K5 in f64, K4 in f32) and on one window
        up = [x.double() for x in f32]
        one_up = cuda_posterior.posterior_fused(*up, tok[None])[0][:, 0, :]
        split32 = [float((one_up - one).abs().max())] + [
            float((x.double() - one_up).abs().max()) for x in (
                got32, mixed_route(f32[:2], up, tok),
                mixed_route(up[:2], f32, tok),
                cuda_posterior.posterior_fused(*f32, tok[None])[0][:, 0, :])]
        del up, one_up, got32
        check(split32[2] <= POST_ATOL,
              f"{label}: the route's own f32 part (K5 in f32, K4 in f64) off "
              f"one-window f64 K4 on the same tables by {split32[2]:.3g} (atol "
              f"{POST_ATOL:g})")
        check(max(split32[3], split32[4]) <= POST_ATOL,
              f"{label}: K4's f32 arithmetic off one-window f64 K4 on the same "
              f"tables by {split32[3]:.3g} on the chunk windows and "
              f"{split32[4]:.3g} on one window (atol {POST_ATOL:g})")
        # its memory in the allocator's cache, as a stream of blocks finds it
        ms_again = timed(lambda: longseq.posterior_long(*tables, tok))[1]
        bound_ms, bound_by = k4_bound_ms(m, tok[None], size=8)
        line = (f"{label} (M={m}, {len(tok)} columns, chunk "
                f"{longseq.ROUTE_CHUNK}): route {ms:.3f} / {ms_again:.3f} ms "
                f"(first call / a later one; K4's function's bound {bound_ms:.4f} ms, "
                f"{bound_by}), peak device memory {peak} bytes; one-window K4 "
                f"{one_ms:.2f} ms ({one_ms / ms_again:.1f}x the route), the route "
                f"within {err:.3g} of it (atol {POST64_ATOL:g})")
        if m == 27:
            check(err_plain <= POST64_ATOL and err32 <= POST_ATOL,
                  f"{label}: the route off its f64 plain version by "
                  f"{err_plain:.3g} (atol {POST64_ATOL:g}), on f32 tables by "
                  f"{err32:.3g} (atol {POST_ATOL:g})")
            line += (f", within {err_plain:.3g} of its f64 plain version "
                     f"({plain_ms:.1f} ms); on f32 tables {ms32:.3f} ms, within "
                     f"{err32:.3g} of the f64 plain version (atol {POST_ATOL:g})")
        else:
            line += (f"; on f32 tables {ms32:.3f} ms, {err32:.3g} off one-window "
                     "K4 on the f64 tables (no gate)")
        line += (f"; f32 split: the tables' rounding {split32[0]:.3g}; on the "
                 f"f32 tables against one-window f64 K4, the route in f32 "
                 f"{split32[1]:.3g}, its own part (K5 in f32, K4 in f64) "
                 f"{split32[2]:.3g} (atol {POST_ATOL:g}), K4's f32 arithmetic "
                 f"on the chunk windows (K5 in f64) {split32[3]:.3g} and on one "
                 f"window {split32[4]:.3g} (atol {POST_ATOL:g} each)")
        parts.append(line)

        _, al0, _ = cuda_fwd.column0(bfull, pi, tok[:1])
        ones = torch.ones_like(al0[0])
        for chunk in ROUTE_CHUNKS:
            got = longseq.posterior_long(*tables, tok, chunk=chunk)
            err_c = float((got - one).abs().max())
            check(err_c <= POST64_ATOL, f"{label} chunk {chunk}: off one-window "
                                        f"K4 by {err_c:.3g}")
            del got
            route_ms = timed(lambda: longseq.posterior_long(*tables, tok,
                                                            chunk=chunk))[1]
            n_chunks = -(-(len(tok) - 1) // chunk)
            stream = longseq.chunk_matrix(tok, 0, n_chunks, chunk)
            (g_ops, _), fwd_ms = timed(
                lambda: cuda_longseq.chunk_operators_fused(a, bfull, stream))
            (k_ops, _), bwd_ms = timed(
                lambda: cuda_longseq.chunk_operators_fused(a.T.contiguous(),
                                                           bfull, stream))
            (alpha, beta), rows_ms = timed(
                lambda: (longseq.entry_rows(g_ops, al0[0]),
                         longseq.exit_rows(k_ops, ones)))
            del g_ops, k_ops
            windows = torch.cat([tok[0:n_chunks * chunk:chunk, None], stream],
                                dim=1)
            (post, _), k4_ms = timed(
                lambda: cuda_posterior.posterior_fused(
                    a, bfull, pi, windows, alpha0=alpha, beta_exit=beta))

            def to_host():
                rows = torch.empty((1 + n_chunks * chunk, m), dtype=post.dtype,
                                   device=dev)
                rows[1:].view(n_chunks, chunk, m).copy_(post[1:].transpose(0, 1))
                rows[0] = post[0, 0]
                return rows[:len(tok)].cpu()

            _, host_ms = timed(to_host)
            del post, alpha, beta, windows
            sweep.append(f"{label} M={m} L={chunk} C={n_chunks}: K5 on a "
                         f"{fwd_ms:.3f} + K5 on a^T {bwd_ms:.3f} + boundary rows "
                         f"{rows_ms:.3f} + K4 {k4_ms:.3f} + rows to the host "
                         f"{host_ms:.3f} = "
                         f"{fwd_ms + bwd_ms + rows_ms + k4_ms + host_ms:.3f} ms, "
                         f"route {route_ms:.3f} ms, max abs err {err_c:.3g}")
        del one

    # 1e7 columns: the route against posterior_segmented, segment by segment
    tables = [x.contiguous() for x in build_tables(3, 3, dev)[:3]]
    tok = simulated_block(dev, 3, 3, 18, LONG_SIM)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    route, ms = timed(lambda: longseq.posterior_long(*tables, tok))
    peak = torch.cuda.max_memory_allocated(dev) - base
    n_groups = len(longseq.posterior_ranges(len(tok), 27, dev, torch.float64))
    t0 = time.perf_counter()
    lo, err, n_seg = 0, 0.0, 0
    for piece in decoders.posterior_segmented(*tables, tok):
        err = max(err, float((piece - route[lo:lo + len(piece)]).abs().max()))
        lo += len(piece)
        n_seg += 1
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    check(lo == len(tok) and err <= POST64_ATOL,
          f"3x3 1e7 columns: the route off posterior_segmented by {err:.3g} "
          f"(atol {POST64_ATOL:g})")
    del route
    parts.append(f"3x3 {len(tok)} columns: route {ms:.3f} ms in {n_groups} "
                 f"group(s), peak device memory {peak} bytes, within {err:.3g} "
                 f"of posterior_segmented ({n_seg} segments, {seg_s:.2f} s, host "
                 f"clock) (atol {POST64_ATOL:g})")
    print(f"{card} | phase 12 long-block posterior, the route on f64 tables: "
          + "; ".join(parts))
    print(f"{card} | phase 12 chunk length, each stage timed alone after the "
          f"route (CUDA events, one call each): " + "; ".join(sweep))


def run_margins(tables, tok, ref, got):
    """The f64 score margin of each maximal run of columns where the path
    ``got`` departs from ``ref`` (numpy arrays): the score of ``ref`` over
    the run and the columns beside it, less that of ``got``, under the
    clamped log tables of ``tables`` (a, bfull, pi) in f64; positive where
    ``ref`` scores higher."""
    from itrails_tpu_torch.hmm import cuda_viterbi

    log_a, log_bt, log_pi = (x.double().cpu().numpy() for x in
                             cuda_viterbi.log_tables(*tables))
    idx = np.flatnonzero(ref != got)
    if idx.size == 0:
        return []
    cut = np.flatnonzero(np.diff(idx) > 1)
    starts = idx[np.r_[0, cut + 1]]
    ends = idx[np.r_[cut, idx.size - 1]] + 1
    margins = []
    for lo, hi in zip(starts, ends):
        lo, hi = max(lo - 1, 0), min(hi + 1, len(ref))
        col = np.arange(lo, hi)
        real = tok[col] >= 0

        def score(path):
            e = log_bt[np.clip(tok[col], 0, 624), path[col]][real].sum()
            tr = log_a[path[col[:-1]], path[col[1:]]][real[1:]].sum()
            return e + tr + (log_pi[path[0]] if lo == 0 else 0.0)

        margins.append(float(score(ref) - score(got)))
    return margins


def phase_long_viterbi(card, dev, cli):
    """A long block's Viterbi path through the sequence-parallel route (K6,
    the entry scan, K3's forward over the chunk windows, its entry map, the
    chain, its backtrack) on f32 tables, as K3 runs: on phase 3's 320 kb
    block at 3x3, the same block on the 3x3 model with states 0 and 1 made
    exchangeable (exact ties at every column), and a 320 kb block simulated
    from the 7x7 model, against K3 walking the block as one window on the
    card (exact at 3x3, ties included; at 7x7 exact, or every run of
    differing columns within VITERBI_MARGIN nats in f64) and, at 3x3,
    against the route's plain version on the card (exact), with one launch
    of each of its six kernels, its milliseconds and peak device memory,
    and its stages timed apart; then 1e7 columns simulated from the 3x3
    model against ``decoders.viterbi_segmented`` on the card, exactly."""
    import torch

    from itrails_tpu_torch.hmm import (cuda_maxplus, cuda_viterbi, decoders,
                                       longseq)

    (block,) = [v for v in cli["v_lst"] if len(v) == LONG_BLOCK]
    tok3 = torch.as_tensor(np.asarray(block, np.int32), device=dev)
    cases = [("3x3 320 kb block of phase 3", 3, 3, tok3, False),
             ("3x3 ties, the same block", 3, 3, tok3, True),
             ("7x7 320 kb", 7, 7, simulated_block(dev, 7, 7, 17), False)]
    counters = route_counters()
    parts, stages = [], []
    for label, n_ab, n_abc, tok, tie in cases:
        a, bfull, pi, _ = build_tables(n_ab, n_abc, dev)
        tables = [x.float().contiguous() for x in (a, bfull, pi)]
        if tie:
            a32, b32, p32 = tables
            a32[1] = a32[0]
            a32[:, 1] = a32[:, 0]
            b32[1] = b32[0]
            p32[1] = p32[0]
        m = a.shape[0]
        one, one_ms = timed(
            lambda: cuda_viterbi.viterbi_fused(*tables, tok[None])[0][0])
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        before = {name: f.launches for name, f in counters.items()}
        route, ms = timed(lambda: longseq.viterbi_long(*tables, tok))
        peak = torch.cuda.max_memory_allocated(dev) - base
        launched = {name: f.launches - before[name]
                    for name, f in counters.items()}
        check(launched == dict.fromkeys(counters, 1),
              f"{label}: the route's launches {launched}, one each expected")
        ms_again = timed(lambda: longseq.viterbi_long(*tables, tok))[1]
        n_diff = int((route != one).sum())
        line = (f"{label} (M={m}, {len(tok)} columns, chunk "
                f"{longseq.ROUTE_CHUNK}): route {ms:.3f} / {ms_again:.3f} ms "
                f"(first call / a later one), peak device memory {peak} bytes; "
                f"one-window K3 {one_ms:.2f} ms ({one_ms / ms_again:.1f}x the "
                f"route); columns off one-window K3's path {n_diff}")
        if m == 27:
            check(n_diff == 0, f"{label}: the route departs from one-window "
                               f"K3 at {n_diff} columns")
            plain, plain_ms = timed(lambda: longseq.viterbi_long_plain(*tables,
                                                                        tok))
            check(torch.equal(route, plain),
                  f"{label}: the route departs from its plain version at "
                  f"{int((route != plain).sum())} columns")
            line += f", equal to its plain version ({plain_ms:.1f} ms)"
        else:
            margins = run_margins((a, bfull, pi), tok.cpu().numpy(),
                                  one.cpu().numpy(), route.cpu().numpy())
            check(all(abs(x) < VITERBI_MARGIN for x in margins),
                  f"{label}: runs off one-window K3 by f64 margins {margins} "
                  f"(limit {VITERBI_MARGIN:g} nats)")
            line += (f" in {len(margins)} run(s), f64 score margins "
                     f"{', '.join(f'{x:.3g}' for x in margins) or 'none'} "
                     f"(limit {VITERBI_MARGIN:g} nats)")
        if tie:
            check(not bool((route == 1).any()),
                  f"{label}: a tie went to the second of two equal states")
            line += ", state 1 never taken"
        parts.append(line)

        # the stages, each timed alone after the route
        chunk = longseq.ROUTE_CHUNK
        n_chunks = -(-(len(tok) - 1) // chunk)
        log_a, log_bt, log_pi = cuda_viterbi.log_tables(*tables)
        omega = cuda_viterbi.column0(log_bt, log_pi, tok[:1])[0].double()
        stream = longseq.chunk_matrix(tok, 0, n_chunks, chunk)
        windows = torch.cat([tok[0:n_chunks * chunk:chunk, None], stream], dim=1)
        (g, off), k6_ms = timed(
            lambda: cuda_maxplus.maxplus_operators(log_a, log_bt, stream))
        (ent, _), scan_ms = timed(lambda: cuda_maxplus.entry_scan(g, off, omega))
        del g, off
        (ptrs, om), fwd_ms = timed(
            lambda: cuda_viterbi.viterbi_forward(log_a, log_bt, ent, windows))
        maps, map_ms = timed(lambda: cuda_viterbi.entry_map(ptrs))
        states, chain_ms = timed(lambda: cuda_viterbi.chain(maps, om[-1]))
        _, back_ms = timed(
            lambda: cuda_viterbi.viterbi_backtrack(ptrs, om, states[1:]))
        del ptrs
        total = k6_ms + scan_ms + fwd_ms + map_ms + chain_ms + back_ms
        stages.append(f"{label} M={m} C={n_chunks}: K6 {k6_ms:.3f} + entry scan "
                      f"{scan_ms:.3f} + K3 forward {fwd_ms:.3f} + entry map "
                      f"{map_ms:.3f} + chain {chain_ms:.3f} + backtrack "
                      f"{back_ms:.3f} = {total:.3f} ms")

    # 1e7 columns: the route against viterbi_segmented
    tables = [x.float().contiguous() for x in build_tables(3, 3, dev)[:3]]
    tok = simulated_block(dev, 3, 3, 19, LONG_SIM)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    route, ms = timed(lambda: longseq.viterbi_long(*tables, tok))
    peak = torch.cuda.max_memory_allocated(dev) - base
    n_groups = len(longseq.viterbi_ranges(len(tok), 27, torch.float32))
    t0 = time.perf_counter()
    seg = decoders.viterbi_segmented(*tables, tok)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    n_diff = int((route != seg).sum())
    check(n_diff == 0, f"3x3 1e7 columns: the route departs from "
                       f"viterbi_segmented at {n_diff} columns")
    parts.append(f"3x3 {len(tok)} columns: route {ms:.3f} ms in {n_groups} "
                 f"group(s), peak device memory {peak} bytes, equal to "
                 f"viterbi_segmented ({seg_s:.2f} s, host clock, segments of "
                 f"{decoders.SEGMENT_COLUMNS} columns)")
    print(f"{card} | phase 13 long-block Viterbi path, the route on f32 "
          f"tables: " + "; ".join(parts))
    print(f"{card} | phase 13 the route's stages, each timed alone after it "
          f"(CUDA events, one call each): " + "; ".join(stages))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import itrails_tpu_torch  # noqa: F401  (fails without the repository)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    try:
        return run_phases(card, dev, t_start)
    finally:  # no process outlives the script
        for proc in RUNNING:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_phases(card, dev, t_start):
    import torch

    seconds, last = {}, [time.perf_counter()]

    def mark(name):  # the host seconds since the previous mark
        now = time.perf_counter()
        seconds[name] = now - last[0]
        last[0] = now

    phase_build(card)
    rows_sass(card)
    mark("1")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        # the MAFs of phases 3 and 3b; their CPU runs overlap phases 2-3b
        cli_start = cli_setup(dev, work)
        int_start = int_cli_setup(dev, work)
        mark("3 and 3b set-up")
        k1 = [phase_k1(card, dev, *shape, seed=seed, reps=10)
              for seed, shape in enumerate(K1_SHAPES)]
        phase_k1(card, dev, *K1_BUCKET, seed=len(K1_SHAPES), reps=10)
        k2 = [phase_k2(card, dev, *shape, seed=seed, reps=10, k1_ms=rec["ms"])
              for seed, (shape, rec) in enumerate(zip(K1_SHAPES, k1))]
        for seed, (label, n_ab, n_abc, _, _) in enumerate(K1_SHAPES):
            phase_k2_chunks(card, dev, label, n_ab, n_abc, seed=20 + seed,
                            reps=10)
        for seed, shape in enumerate(K1_SHAPES):
            phase_k3(card, dev, *shape, seed=seed, reps=10)
        phase_k3(card, dev, "3x3", 3, 3, *TIE_SHAPE, seed=5, reps=2, tie=True)
        k4 = [phase_k4(card, dev, *shape, seed=seed, reps=10)
              for seed, shape in enumerate(K1_SHAPES)]
        phase_k4_run_lengths(card, dev)
        k5 = [phase_k5(card, dev, label, n_ab, n_abc, seed=seed, reps=10)
              for seed, (label, n_ab, n_abc, _, _) in enumerate(K1_SHAPES)]
        route_k = [phase_viterbi_route_kernels(card, dev, label, n_ab, n_abc,
                                               seed=30 + seed, reps=10)
                   for seed, (label, n_ab, n_abc, _, _)
                   in enumerate(K1_SHAPES)]
        mark("2")
        phase_int_kernels(card, dev, reps=10)
        mark("2 at M=36")
        k1_launches, _, cli = phase_cli(card, dev, work, cli_start)
        mark("3")
        int_cli = phase_int_cli(card, dev, work, int_start)
        mark("3b")
        k2_calls, _, best_yaml = phase_cli_grad(card, dev, work, cli)
        mark("4")
        phase_genome(card, dev)
        mark("5")
        phase_cli_fd(card, dev, work, cli)  # its CPU run started before 2
        phase_int_cli_cpu(card, int_cli)  # its CPU runs started before 2
        mark("3 and 3b against the CPU")
        route_launches = phase_viterbi_cli(card, dev, work, cli, best_yaml)
        mark("6")
        phase_segmented(card, dev, cli, best_yaml)
        mark("7")
        k4_launches, k5_post_launches, long_rows = phase_posterior_cli(
            card, dev, work, cli, best_yaml)
        mark("8")
        phase_posterior_groups(card, dev, cli, best_yaml, long_rows)
        mark("9")
        phase_long_value(card, dev, cli)
        mark("10")
        phase_long_grad(card, dev, cli)
        mark("11")
        phase_long_posterior(card, dev, cli)
        mark("12")
        phase_long_viterbi(card, dev, cli)
        mark("13")
    print(f"{card} | seconds by phase (host clock): "
          + ", ".join(f"{name} {t:.1f}" for name, t in seconds.items()))
    print(f"{card} | all phases passed in {time.perf_counter() - t_start:.1f} s")

    # each record at the genome-scale 3x3 shape of phase 2 (K1, K4 and K5
    # in f64, the CLIs' default; K5 on the 625 chunks of ROUTE_CHUNK columns
    # of a 320 kb block, the posterior path's shape; K3, K6 and its scan at
    # 3x3 on the Viterbi route's 625 chunks of a 320 kb block, K3 as its
    # four parts there: forward, entry map, chain and backtrack);
    # launches from the CLI run of its own path (K1: phase 3, K2: phase 4,
    # the main path, where each K2 call launches its two kernels, K3, K6
    # and the scan: phase 6, the Viterbi CLI, K3's four parts on its long
    # block and its forward and backtrack on the short blocks' batch; K4
    # and K5: phase 8, the posterior path, K4 two kernels a call, K5 twice
    # a group of the long block's chunks; K5's launches on the main path,
    # phase 4, are printed there)
    record = {"kernels": [{
        "name": "k1_forward",
        "route": "cuda",
        "source": "itrails_tpu_torch/csrc/fwd.cu",
        "replaces": "itrails_tpu/hmm/pallas_fwd.py:327",
        "launches": k1_launches,
        "library_ms": None,  # no single PyTorch call computes this function
        **k1[0],
    }, {
        "name": "k2_loglik_and_grads",
        "route": "cuda",
        "source": "itrails_tpu_torch/csrc/grad.cu",
        "replaces": "itrails_tpu/hmm/pallas_grad.py:203",
        "launches": 2 * k2_calls,
        "library_ms": None,  # no single PyTorch call computes this function
        **k2[0],
    }, {
        "name": "k3_viterbi",
        "route": "cuda",
        "source": "itrails_tpu_torch/csrc/viterbi.cu",
        "replaces": "itrails_tpu/hmm/pallas_viterbi.py:299",
        "launches": sum(route_launches[name] for name in (
            "K3 forward", "K3 entry map", "K3 chain", "K3 backtrack")),
        "library_ms": None,  # no single PyTorch call computes this function
        **route_k[0]["k3"],
    }, {
        "name": "k4_posterior",
        "route": "cuda",
        "source": "itrails_tpu_torch/csrc/posterior.cu",
        "replaces": "itrails_tpu/hmm/pallas_fwd.py:493",
        "launches": k4_launches,
        "library_ms": None,  # no single PyTorch call computes the posterior
        **k4[0],
    }, {
        "name": "k5_chunk_operators",
        "route": "cuda",
        "source": "itrails_tpu_torch/csrc/operators.cu",
        "replaces": "tools/exp_opkernel.py:97",
        "launches": k5_post_launches,
        # no single PyTorch call computes a chunk's chain of products
        "library_ms": None,
        **k5[0],
    }, {
        "name": "k6_maxplus_operators",
        "route": "cuda",
        "source": "itrails_tpu_torch/csrc/maxplus.cu",
        "replaces": "none: XLA ops at itrails_tpu/hmm/longseq.py:328-342",
        "launches": route_launches["K6"],
        # no PyTorch call computes a max-plus product, let alone its chain
        "library_ms": None,
        **route_k[0]["k6"],
    }, {
        "name": "k6_entry_scan",
        "route": "cuda",
        "source": "itrails_tpu_torch/csrc/maxplus.cu",
        "replaces": "none: lax.associative_scan at itrails_tpu/hmm/longseq.py:344",
        "launches": route_launches["scan"],
        # no PyTorch call computes a max-plus scan
        "library_ms": None,
        **route_k[0]["scan"],
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
