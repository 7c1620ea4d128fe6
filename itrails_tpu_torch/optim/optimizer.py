"""Outer maximum-likelihood optimizer (value-only).

The reference's hot loop (optimizer.py:396-637): scipy Nelder-Mead over the
free parameters; each objective evaluation rebuilds (a, b, pi) and sums the
forward log-likelihood over all alignment blocks.  Here the model rebuild
runs in float64 on the engine's device and the likelihood of every
length-class bucket is one launch of kernel K1 on the card (its plain
version on the CPU).

Artifacts per evaluation match the reference: a row
``[n_eval, params..., loglik, seconds]`` appended to
``<prefix>.optimization_history.csv`` and a conditional best-model YAML
update; every scipy iteration also rewrites the ``--resume`` checkpoint
``<prefix>.optimizer_state.yaml``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import yaml
from scipy.optimize import minimize

from itrails_tpu_torch import resolve_device
from itrails_tpu_torch.config import update_best_model
from itrails_tpu_torch.core.model import build_model_fn
from itrails_tpu_torch.data.tokens import N_TOKENS, aggregation_matrix
from itrails_tpu_torch.hmm import decoders, windows
from itrails_tpu_torch.optim.cases import resolve_times

__all__ = ["LoglikEngine", "optimizer", "write_list"]

_BUILD_ARGS = ("t_A", "t_B", "t_C", "t_2", "t_upper", "t_out", "N_AB",
               "N_ABC", "r")


def write_list(lst, path):
    """Append one comma-separated row (reference optimizer.py:380-393)."""
    with open(path, "a") as f:
        f.write(",".join(str(x) for x in lst) + "\n")


class LoglikEngine:
    """Packs alignment blocks once and evaluates the total forward
    log-likelihood for a parameter dictionary, on one device.

    Short blocks are grouped into power-of-two length-class buckets
    (windows.plan_buckets) so one chromosome-scale block never forces its
    padding on kilobase blocks.  A block above ``long_threshold`` columns
    is its own one-window batch: the recurrence is exact, only slower than
    a sequence-parallel evaluation would be.  Every block keeps its exact
    recurrence (no splitting), so the total equals the single-batch
    log-likelihood up to float summation order; the per-batch totals are
    summed in f64."""

    def __init__(self, v_lst, n_int_AB, n_int_ABC, dtype="float64",
                 device="cuda", long_threshold=windows.LONG_BLOCK_THRESHOLD):
        self.device = resolve_device(device)
        # the decode's dtype, set here only: K1 computes in float32 on the
        # card; ``dtype`` picks the plain version's dtype on the CPU
        self.dtype = (torch.float32 if self.device.type == "cuda"
                      else getattr(torch, dtype))
        lengths = [len(v) for v in v_lst]
        for v in v_lst:
            v = np.asarray(v)
            if v.size and (v.min() < 0 or v.max() >= N_TOKENS):
                raise ValueError("alignment tokens must lie in [0, 625)")
        self._n_columns = int(sum(lengths))
        bucket_idx, long_idx = windows.plan_buckets(lengths, 1, long_threshold)
        self.batches = []
        for idxs in bucket_idx:
            tokens, _, _ = windows.pack_windows(
                [v_lst[i] for i in idxs], pad_length_to=128)
            self.batches.append(torch.as_tensor(tokens, device=self.device))
        self.n_buckets = len(self.batches)
        for i in long_idx:
            self.batches.append(torch.as_tensor(
                np.asarray(v_lst[i], np.int32)[None, :], device=self.device))
        self.n_long = len(long_idx)
        self._builder = build_model_fn(n_int_AB, n_int_ABC, torch.float64,
                                       self.device)
        self._agg = torch.as_tensor(aggregation_matrix(), dtype=torch.float64,
                                    device=self.device)
        self.seconds = {"build": 0.0, "decode": 0.0}  # summed over evals

    @property
    def n_columns(self) -> int:
        return self._n_columns

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def loglik(self, params: dict) -> float:
        """Total log-likelihood at the resolved, mu-scaled ``params``."""
        t0 = time.perf_counter()
        a, b, pi, _, _ = self._builder(*(params[k] for k in _BUILD_ARGS))
        bfull = decoders.emission_table(b, self._agg)
        a, bfull, pi = (x.to(self.dtype).contiguous() for x in (a, bfull, pi))
        self._sync()
        t1 = time.perf_counter()
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for tok in self.batches:
            total = total + decoders.forward_loglik_fast(a, bfull, pi, tok)
        value = float(total)
        self.seconds["build"] += t1 - t0
        self.seconds["decode"] += time.perf_counter() - t1
        return value


def optimizer(
    optim_variables,
    optim_list,
    bounds,
    fixed_params,
    v_lst,
    res_name,
    case,
    method="Nelder-Mead",
    header=True,
    maxiter=10000,
    dtype="float64",
    device="cuda",
):
    """Run the outer optimization (reference optimizer.py:586-637) with a
    derivative-free scipy ``method``.

    Returns the scipy result object.  ``res_name`` is the output
    path/prefix; ``<res_name>.optimization_history.csv`` and
    ``<res_name>.best_model.yaml`` follow the reference contract.
    """
    output_dir, output_prefix = os.path.split(res_name)
    history = os.path.join(output_dir,
                           f"{output_prefix}.optimization_history.csv")
    best_model_yaml = os.path.join(output_dir, f"{output_prefix}.best_model.yaml")
    state_yaml = os.path.join(output_dir, f"{output_prefix}.optimizer_state.yaml")
    if header:
        write_list(["n_eval"] + list(optim_variables) + ["loglik", "time"], history)

    engine = LoglikEngine(v_lst, fixed_params["n_int_AB"],
                          fixed_params["n_int_ABC"], dtype=dtype, device=device)
    info = {"n_eval": 0, "t0": time.time()}

    def _checkpoint(xk):
        """Atomically record the current iterate (internal mu-scaled
        coordinates) so --resume restarts the search where it stopped."""
        tmp = state_yaml + ".tmp"
        with open(tmp, "w") as f:
            yaml.safe_dump({
                "n_eval": info["n_eval"],
                "variables": list(optim_variables),
                "x_internal": [float(v) for v in np.asarray(xk)],
                "note": "internal (mu-scaled) coordinates; consumed by "
                        "--resume",
            }, f)
        os.replace(tmp, state_yaml)

    # At extreme bound corners (e.g. t_upper/N_ABC ~ 1e3 coalescent units)
    # the model build overflows to non-finite values; a large finite
    # penalty keeps simplex steps backtracking instead of propagating NaN
    # into scipy's termination logic.
    penalty = 1e12

    def objective(arg_lst):
        d = dict(fixed_params)
        for name, value in zip(optim_variables, arg_lst):
            d[name] = float(value)
        ll = engine.loglik(resolve_times(case, d))
        write_list([info["n_eval"]] + [float(v) for v in arg_lst]
                   + [ll, time.time() - info["t0"]], history)
        if os.path.exists(best_model_yaml):
            update_best_model(best_model_yaml, optim_variables, arg_lst, ll,
                              info["n_eval"])
        info["n_eval"] += 1
        return penalty if not np.isfinite(ll) else -ll

    return minimize(
        objective,
        x0=np.asarray(optim_list, dtype=np.float64),
        method=method,
        bounds=bounds,
        callback=_checkpoint,
        options={"maxiter": maxiter, "disp": True},
    )
