#!/usr/bin/env python3
"""Smoke test of itrails_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one result line each (every line starts with the card's name and
power limit):

1. build: compile kernels K1 (``itrails_tpu_torch/csrc/fwd.cu``) and K2
   (``csrc/grad.cu``) with nvcc for sm_90a, both at once, and print their
   registers, shared memory and spills;
2. K1 and then K2 against their plain PyTorch versions (f64, on the card)
   on the 3x3 model (M=27, 4096 x 8192 tokens) and the 7x7 model (M=133,
   1024 x 2048), built on the card, with ragged PAD tails and all-PAD
   windows; time, launches and the card's least time for the same work;
3. the value-only path: ``itrails_tpu_torch.cli.optimize.main --no-grad``
   (Nelder-Mead) at 3x3 on a MAF simulated from the 3x3 model (1.32 M
   columns: 100 blocks of 10 kb and one 320 kb block), with K1's launch
   counter reset just before and read just after;
4. the main path, the CLI's default: exact-gradient L-BFGS-B on the same
   MAF, with K2's call counter reset just before and read just after,
   evaluation 0's value and gradient held against the plain version, and
   K2 on each of its batches, the 320 kb block whole, against the plain
   version (f64; the one-window block on the CPU, where its 320,000 small
   steps run faster than on the card);
5. genome scale: ``LoglikEngine`` on 33.5 M simulated columns (4096 x
   8192), seconds per evaluation split into build and decode for the
   value, and into build, decode (K2) and build backward for the gradient.

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

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12
SPECIES = ["hg38", "panTro5", "gorGor5", "ponAbe2"]
# mu-scaled start point of examples/example_config.yaml (t_1 case)
START = dict(t_1=2.4e-3, t_2=4e-4, t_upper=7.450693855e-3, N_AB=5e-4,
             N_ABC=5e-4, r=1.0)
# phase 2: (label, n_int_AB, n_int_ABC, windows, columns), for K1 and K2
K1_SHAPES = [("3x3", 3, 3, 4096, 8192), ("7x7", 7, 7, 1024, 2048)]
# phase 3: short blocks, their length, and how many more such rows are
# joined into the one long block (32 x 10 kb = 320 kb > 262,144)
CLI_LAYOUT = (100, 10_000, 32)
# phase 5: windows x columns
GENOME = (4096, 8192)
# K2's gradients against the plain version, per entry: f32 normalizers and
# sums over T steps
GRAD_RTOL = 2e-3


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


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


def start_params(n_ab, n_abc, **change):
    """The resolved, mu-scaled parameters of START (with ``change``)."""
    from itrails_tpu_torch.optim.cases import resolve_times

    return resolve_times(frozenset(["t_1"]),
                         dict(START, n_int_AB=n_ab, n_int_ABC=n_abc, **change))


def build_tables(n_ab, n_abc, dev, d=None):
    """(a, bfull, pi, b) in f64 on ``dev`` from the port's own builder, at
    the resolved parameters ``d`` (default: START; floats, or 0-d tensors
    that require grad)."""
    from itrails_tpu_torch.core.model import build_model_fn
    from itrails_tpu_torch.data.tokens import aggregation_matrix
    from itrails_tpu_torch.hmm import decoders

    d = start_params(n_ab, n_abc) if d is None else d
    a, b, pi, _, _ = build_model_fn(n_ab, n_abc, device=dev)(
        d["t_A"], d["t_B"], d["t_C"], d["t_2"], d["t_upper"], d["t_out"],
        d["N_AB"], d["N_ABC"], d["r"])
    return a, decoders.emission_table(b, aggregation_matrix()), pi, b


def k1_bound_ms(m, tokens):
    """Least time of K1's work on these inputs: the larger of its bytes
    (each input read once, each output written once) over the memory rate
    and its f32 operations over the f32 peak.  Work is counted for the
    non-PAD columns 1..T-1, the ones the recurrence updates: 2*M^2 for the
    product plus 3*M for the emission product, the sum and the division."""
    w, t = tokens.shape
    steps = int((tokens[:, 1:] >= 0).sum())
    ops = steps * (2 * m * m + 3 * m)
    nbytes = 4 * (m * m + 625 * m + m + w * t + w * m + w)
    by_ops = ops / PEAK_F32_FLOPS
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

    from itrails_tpu_torch.hmm import _build, cuda_fwd, cuda_grad

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc for each source, at once
        jobs = [(name, pool.submit(mod.build))
                for name, mod in (("K1", cuda_fwd), ("K2", cuda_grad))]
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
    """K1 against its plain version on the card; returns its record."""
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
    print(f"{card} | phase 2 K1 {m_label} M={m} W={w} T={t}: per-window ll "
          f"max rel err {rel:.3g} (rtol 1e-5: f32 normalizers summed over T "
          f"steps), total rel err {total_rel:.3g} (rtol 1e-6: f64 sum of f32 "
          f"windows), alpha max abs err {alpha_err:.3g}; K1 {ms:.4f} ms "
          f"(mean of {reps}, {launches} launches), "
          f"plain f64 {plain_ms:.1f} ms (no yardstick), bound {bound_ms:.4f} "
          f"ms ({bound_by}), {bound_ms / ms:.1%} of bound")
    return {"max_abs_err": float(abs_err.max()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


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


def phase_cli(card, dev, workdir):
    """The value-only path: the optimize CLI, Nelder-Mead, at 3x3.  Returns
    its launches of K1 and what phase 4 reuses."""
    import torch
    import yaml

    from itrails_tpu_torch.cli.common import prepare_optimize_setup
    from itrails_tpu_torch.cli.optimize import main
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.data.simulate import simulate_token_batch, write_maf
    from itrails_tpu_torch.hmm import cuda_fwd, windows
    from itrails_tpu_torch.optim.cases import resolve_times

    t0 = time.perf_counter()
    n_short, block_len, n_joined = CLI_LAYOUT
    a, _, pi, b = build_tables(3, 3, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    sim = simulate_token_batch(a, b, pi, n_short + n_joined, block_len,
                               gen).cpu().numpy()
    blocks = list(sim[:n_short]) + [sim[n_short:].reshape(-1)]
    maf = os.path.join(workdir, "sim3x3.maf")
    write_maf(maf, blocks, SPECIES)
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
    cfg_path = os.path.join(workdir, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    v_lst = maf_tokens(maf, SPECIES)
    lengths = [len(v) for v in v_lst]
    buckets, long_idx = windows.plan_buckets(lengths, 1)
    per_eval = len(buckets) + len(long_idx)
    check(sum(lengths) >= 1_000_000 and len(long_idx) == 1,
          "phase 3 MAF is not the planned layout")
    prep_s = time.perf_counter() - t0

    out = os.path.join(workdir, "run", "sim")
    cuda_fwd.forward_fused.launches = 0
    t0 = time.perf_counter()
    main([cfg_path, "--output", out, "--no-grad", "--maxiter", "3"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = cuda_fwd.forward_fused.launches

    rows = np.loadtxt(out + ".optimization_history.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    with open(out + ".best_model.yaml") as f:
        best = yaml.safe_load(f)
    n_eval = rows.shape[0]
    check(n_eval >= 7 and rows.shape[1] == 6 + 3, "history has the wrong shape")
    check(np.array_equal(rows[:, 0], np.arange(n_eval)),
          "history is not one row per evaluation")
    check(np.isfinite(rows).all(), "history holds non-finite values")
    best_ll = best["results"]["log_likelihood"]
    check(np.isfinite(best_ll) and best_ll == rows[:, -2].max(),
          "best-model loglik is not the best history row")
    check(launches == n_eval * per_eval,
          f"K1 launched {launches} times for {n_eval} evaluations x "
          f"{per_eval} batches")

    # the first evaluation against the plain version in f64 on the card
    setup = prepare_optimize_setup(config)
    d = dict(setup["fixed_dict"], **dict(zip(setup["optim_variables"],
                                             setup["optim_list"])))
    d = resolve_times(setup["case"], d)
    a0, bfull0, pi0, _ = build_tables(3, 3, dev, d)
    a32, b32, p32 = (x.float().contiguous() for x in (a0, bfull0, pi0))
    ref = 0.0
    per_batch = []  # K1 ms at each of the main path's batch shapes
    for i_blocks in buckets + [[i] for i in long_idx]:
        tok, _, _ = windows.pack_windows([v_lst[i] for i in i_blocks],
                                         pad_length_to=128)
        tok = torch.as_tensor(tok, device=dev)
        _, ll_ref = cuda_fwd.forward_fused_plain(a0, bfull0, pi0, tok)
        ref += float(ll_ref.sum())
        ms = cuda_ms(lambda: cuda_fwd.forward_fused(a32, b32, p32, tok), 1)
        per_batch.append(f"{tuple(tok.shape)} {ms:.2f} ms")
    rel = abs(rows[0, -2] - ref) / abs(ref)
    check(rel <= 1e-6, f"first evaluation off the f64 reference by {rel:.3g}")
    print(f"{card} | phase 3 optimize CLI 3x3 Nelder-Mead: {sum(lengths)} "
          f"columns in {len(lengths)} blocks ({len(buckets)} bucket(s) + "
          f"{len(long_idx)} long block), {n_eval} evaluations in {cli_s:.2f} s "
          f"({cli_s / n_eval:.3f} s/eval), K1 launches {launches} = "
          f"{n_eval} x {per_eval}, best loglik {best_ll:.6f}, eval 0 vs plain "
          f"f64 rel err {rel:.3g} (rtol 1e-6); K1 per evaluation: "
          f"{', '.join(per_batch)}; simulation + MAF {prep_s:.1f} s")
    return launches, {"config": config, "v_lst": v_lst, "per_eval": per_eval,
                      "ref": ref}


def phase_cli_grad(card, dev, workdir, cli):
    """The main path: the optimize CLI on its default, exact-gradient
    L-BFGS-B, at 3x3 on phase 3's MAF."""
    import torch
    import yaml

    from itrails_tpu_torch.cli.common import prepare_optimize_setup
    from itrails_tpu_torch.cli.optimize import main
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_grad
    from itrails_tpu_torch.optim.cases import resolve_times
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    config = dict(cli["config"])
    config["settings"] = {k: v for k, v in config["settings"].items()
                          if k != "method"}  # the default applies
    cfg_path = os.path.join(workdir, "config_grad.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    out = os.path.join(workdir, "run_grad", "sim")
    cuda_grad.loglik_and_grads_fused.calls = 0
    cuda_fwd.forward_fused.launches = 0
    t0 = time.perf_counter()
    main([cfg_path, "--output", out, "--maxiter", "3"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    calls = cuda_grad.loglik_and_grads_fused.calls
    k1_launches = cuda_fwd.forward_fused.launches

    rows = np.loadtxt(out + ".optimization_history.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    with open(out + ".best_model.yaml") as f:
        best = yaml.safe_load(f)
    n_eval = rows.shape[0]
    check(n_eval >= 2 and rows.shape[1] == 6 + 3, "grad history has the wrong shape")
    check(np.array_equal(rows[:, 0], np.arange(n_eval)),
          "grad history is not one row per evaluation")
    check(np.isfinite(rows).all(), "grad history holds non-finite values")
    best_ll = best["results"]["log_likelihood"]
    check(np.isfinite(best_ll) and best_ll == rows[:, -2].max(),
          "grad best-model loglik is not the best history row")
    check(calls == n_eval * cli["per_eval"],
          f"K2 called {calls} times for {n_eval} evaluations x "
          f"{cli['per_eval']} batches")
    check(k1_launches == 0, f"the gradient path launched K1 {k1_launches} times")
    rel = abs(rows[0, -2] - cli["ref"]) / abs(cli["ref"])
    check(rel <= 1e-6, f"grad evaluation 0 off the f64 reference by {rel:.3g}")

    # evaluation 0's gradient: the engine's (K2 on every batch) against the
    # plain f64 version on every batch, chained through the same build; on
    # the way, K2 on each batch alone against the plain version
    setup = prepare_optimize_setup(config)
    names, x0 = setup["optim_variables"], np.asarray(setup["optim_list"])
    engine = LoglikEngine(cli["v_lst"], 3, 3, device=dev)
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
    sums = [torch.zeros_like(x) for x in tables]
    per_batch = []  # K2 against the plain version, and its ms, per batch
    t0 = time.perf_counter()
    for i, tok in enumerate(engine.batches):
        # the one-window long block's plain walk runs on the CPU
        on = dev if i < engine.n_buckets else torch.device("cpu")
        ll_p, grads_p = cuda_grad.loglik_and_grads_plain(
            *(x.to(on) for x in tables), tok.to(on))
        grads_p = [g.to(dev) for g in grads_p]
        ll_b, grads_b = cuda_grad.loglik_and_grads_fused(*tables32, tok)
        b_rel = abs(float(ll_b) - float(ll_p)) / abs(float(ll_p))
        errs, medians, ok = grad_errors(grads_b, grads_p)
        check(b_rel <= 1e-6 and ok,
              f"K2 on the {tuple(tok.shape)} batch off the plain version: "
              f"loglik {b_rel:.3g}, {grad_note(errs, medians)}")
        for acc, g in zip(sums, grads_p):
            acc += g
        ms = cuda_ms(lambda: cuda_grad.loglik_and_grads_fused(*tables32, tok), 1)
        per_batch.append(f"{tuple(tok.shape)} {ms:.2f} ms, vs plain f64 on "
                         f"{on.type}: loglik rel err {b_rel:.3g}, "
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
          f"{cli['per_eval']}, K1 launches {k1_launches}, best loglik "
          f"{best_ll:.6f}; eval 0 vs plain f64 loglik rel err {rel:.3g} "
          f"(rtol 1e-6), gradient rel err per parameter "
          f"{', '.join(f'{e:.2g}' for e in g_rel)} (rtol 2e-3, against the "
          f"plain f64 version on every batch, {plain_s:.1f} s); K2 per "
          f"evaluation: {'; '.join(per_batch)}")
    return calls


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
    phase_build(card)
    k1 = [phase_k1(card, dev, *shape, seed=seed, reps=10)
          for seed, shape in enumerate(K1_SHAPES)]
    k2 = [phase_k2(card, dev, *shape, seed=seed, reps=10, k1_ms=rec["ms"])
          for seed, (shape, rec) in enumerate(zip(K1_SHAPES, k1))]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        k1_launches, cli = phase_cli(card, dev, work)
        k2_calls = phase_cli_grad(card, dev, work, cli)
    phase_genome(card, dev)
    print(f"{card} | all phases passed in {time.perf_counter() - t_start:.1f} s")

    # each record at the genome-scale 3x3 shape of phase 2; launches from
    # the CLI run of its own path (K1: phase 3, K2: phase 4, where each K2
    # call launches its two kernels)
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
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
