"""Outer maximum-likelihood optimizer.

The reference's hot loop (optimizer.py:396-637): scipy Nelder-Mead or
L-BFGS-B over the free parameters; each objective evaluation rebuilds
(a, b, pi) and sums the forward log-likelihood over all alignment blocks.
Here the model rebuild runs in float64 on the engine's device.  A
value-only evaluation is one launch of kernel K1 per length-class bucket
on the card (its plain version on the CPU), plus, for each block above the
long-block threshold, the sequence-parallel transfer-operator path with
kernel K5 (``hmm/longseq.py``), both in the engine's ``dtype``; an
exact-gradient evaluation is one call of kernel K2 per bucket and, per long
block, K5's operators and one K2 call over the block's chunks
(``longseq.forward_loglik_long_and_grads``), in float32 on the card, whose
gradient torch autograd carries back through the f64 build to the
parameters.

Artifacts per evaluation match the reference: a row
``[n_eval, params..., loglik, seconds]`` appended to
``<prefix>.optimization_history.csv`` and a conditional best-model YAML
update; every scipy iteration also rewrites the ``--resume`` checkpoint
``<prefix>.optimizer_state.yaml``.
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np
import torch
import yaml
from scipy.optimize import minimize

from itrails_tpu_torch import resolve_device
from itrails_tpu_torch.config import update_best_model
from itrails_tpu_torch.core.model import build_model_fn
from itrails_tpu_torch.core.schedule import hidden_state_list
from itrails_tpu_torch.data.tokens import (
    N_TOKENS,
    aggregation_matrix,
    token_strings,
)
from itrails_tpu_torch.hmm import cuda_fwd, decoders, longseq, windows
from itrails_tpu_torch.hmm.grad import LoglikFn
from itrails_tpu_torch.introgression.builder import (
    build_model_introgression_fn,
)
from itrails_tpu_torch.optim.cases import (
    resolve_times,
    resolve_times_introgression,
)

__all__ = ["INT_GRADIENT_NOT_PORTED", "LoglikEngine", "optimizer",
           "write_list"]

INT_GRADIENT_NOT_PORTED = (
    "exact gradients of the introgression model are not ported yet: run "
    "the value path with --no-grad, or set settings.method: Nelder-Mead in "
    "the config")

_BUILD_ARGS = ("t_A", "t_B", "t_C", "t_2", "t_upper", "t_out", "N_AB",
               "N_ABC", "r")
# the introgression builder's (itrails_tpu/optim/optimizer.py:239-244)
_INT_BUILD_ARGS = ("t_A", "t_B", "t_C", "t_2", "t_upper", "t_out", "t_m",
                   "N_AB", "N_BC", "N_ABC", "r", "m")


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
    (``long_blocks``, 1-D token tensors) leaves the buckets:

    - the value (:meth:`loglik`, what Nelder-Mead and scipy's
      finite-difference methods call) takes it through the
      sequence-parallel transfer operators of
      ``longseq.forward_loglik_long``: K5 builds each chunk's operator on
      the card, and the log-normalizer is carried in f64;
    - the exact gradient (:meth:`loglik_and_grad_fn`) takes it through
      ``longseq.forward_loglik_long_and_grads``: K5's operators give alpha
      at every chunk's entry and beta at its exit, and one K2 call takes
      every chunk as a window, so a block is never one warp's walk.

    Both are exact (no splitting), so the total equals the single-batch
    log-likelihood up to float rounding; the per-batch totals are summed in
    f64.

    The value is decoded in ``dtype`` on either device (K1 and K5 are
    instantiated on float32 and float64).  The default, float64, is what
    scipy's finite differences need: their step of 1e-8 moves a
    genome-scale loglik by ~1e-3 nats, below the rounding of an f32
    recursion (~1e-2 nats at 1.3 M columns).  The gradient is decoded in
    float32 on the card, K2's only scalar, and in ``dtype`` on the CPU.

    With ``introgression`` the tables come from the introgression builder
    (``introgression/builder.py``) and the parameters it takes (``t_m``,
    ``N_BC``, ``m`` besides the plain ones); the decode is the same.  Its
    exact gradient is not ported yet, so such an engine has the value
    path only."""

    def __init__(self, v_lst, n_int_AB, n_int_ABC, dtype="float64",
                 device="cuda", long_threshold=windows.LONG_BLOCK_THRESHOLD,
                 introgression=False):
        self.device = resolve_device(device)
        # the decodes' dtypes, set here only: the value's, and the
        # gradient's (K2 computes in float32 on the card)
        self.dtype = getattr(torch, dtype)
        self.grad_dtype = (torch.float32 if self.device.type == "cuda"
                           else self.dtype)
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
        self.long_blocks = [torch.as_tensor(np.asarray(v_lst[i], np.int32),
                                            device=self.device)
                            for i in long_idx]
        self.n_long = len(long_idx)
        self.introgression = introgression
        if introgression:
            self._builder = build_model_introgression_fn(
                n_int_AB, n_int_ABC, torch.float64, self.device)
            self._build_args = _INT_BUILD_ARGS
        else:
            self._builder = build_model_fn(n_int_AB, n_int_ABC,
                                           torch.float64, self.device)
            self._build_args = _BUILD_ARGS
        self._agg = torch.as_tensor(aggregation_matrix(), dtype=torch.float64,
                                    device=self.device)
        # summed over evaluations; "build_backward" only for gradients
        self.seconds = {"build": 0.0, "decode": 0.0, "build_backward": 0.0}

    @property
    def n_columns(self) -> int:
        return self._n_columns

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tables(self, params: dict, dtype):
        """The decode's ``(a, bfull, pi)`` in ``dtype``, built in f64 from
        the resolved ``params`` (floats or 0-d f64 tensors)."""
        a, b, pi, _, _ = self._builder(*(params[k] for k in self._build_args))
        bfull = decoders.emission_table(b, self._agg)
        return tuple(x.to(dtype).contiguous() for x in (a, bfull, pi))

    def loglik(self, params: dict) -> float:
        """Total log-likelihood at the resolved, mu-scaled ``params``.

        The introgression model exists only where the migration lies
        between the present and the first speciation: at t_1 < t_m the
        case algebra gives ``t_B`` or ``t_C`` (the times from the present
        to the migration) below zero, where the build yields tables with
        negative "probabilities".  There the value is NaN, with no build,
        so the optimizer's non-finite penalty takes the point (the JAX
        package's scan gives NaN at most such points and a meaningless
        finite value at the others)."""
        if self.introgression and min(params["t_B"], params["t_C"]) < 0:
            return float("nan")
        t0 = time.perf_counter()
        a, bfull, pi = self._tables(params, self.dtype)
        self._sync()
        t1 = time.perf_counter()
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for tok in self.batches:
            total = total + decoders.forward_loglik_fast(a, bfull, pi, tok)
        for tok in self.long_blocks:
            total = total + longseq.forward_loglik_long(a, bfull, pi, tok)
        value = float(total)
        self.seconds["build"] += t1 - t0
        self.seconds["decode"] += time.perf_counter() - t1
        return value

    def loglik_plain(self, params: dict) -> float:
        """:meth:`loglik` through the kernels' plain versions, K1's on the
        buckets and the operator route's on the long blocks, on the same
        device and tables: what the card's checks hold :meth:`loglik` to."""
        a, bfull, pi = self._tables(params, self.dtype)
        total = 0.0
        for tok in self.batches:
            total += float(cuda_fwd.forward_fused_plain(a, bfull, pi, tok)[1]
                           .sum())
        for tok in self.long_blocks:
            total += float(longseq.forward_loglik_long_plain(a, bfull, pi, tok))
        return total

    def loglik_and_grad_fn(self, optim_variables, fixed_params, case,
                           resolver):
        """Callable ``vec -> (loglik, dloglik/dvec)`` with exact gradients.

        ``vec`` holds the mu-scaled values of ``optim_variables``; the rest
        of the parameters are ``fixed_params``, resolved by ``resolver``
        (the case algebra, plain arithmetic that carries tensors).  The
        build runs in f64 as an autograd graph from ``vec``; the decode's
        value and gradient in ``(a, bfull, pi)`` come from K2 per bucket
        and from the long-block route (K5, then one K2 call over its
        chunks) per long block (their plain versions on the CPU) through
        :class:`LoglikFn`; autograd then carries them back through the
        decode-dtype cast and the build.
        The reference has no gradient path: its L-BFGS-B uses finite
        differences."""
        if self.introgression:
            raise NotImplementedError(INT_GRADIENT_NOT_PORTED)

        def f(vec_np):
            t0 = time.perf_counter()
            vec = torch.tensor(np.asarray(vec_np, np.float64),
                               dtype=torch.float64, device=self.device,
                               requires_grad=True)
            d = dict(fixed_params)
            d.update(zip(optim_variables, vec.unbind()))
            a, bfull, pi = self._tables(resolver(case, d), self.grad_dtype)
            self._sync()
            t1 = time.perf_counter()
            total = LoglikFn.apply(a, bfull, pi, *self.batches,
                                   *self.long_blocks)
            self._sync()
            t2 = time.perf_counter()
            (grad,) = torch.autograd.grad(total, vec)
            value = float(total.detach())
            grad = grad.cpu().numpy()
            t3 = time.perf_counter()
            self.seconds["build"] += t1 - t0
            self.seconds["decode"] += t2 - t1
            self.seconds["build_backward"] += t3 - t2
            return value, grad

        return f


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
    use_grad=False,
    introgression=False,
):
    """Run the outer optimization (reference optimizer.py:586-637,
    int_optimizer.py:589-651) with the scipy ``method``: derivative-free,
    or with exact gradients (``use_grad``, the JAX package's
    ``optimizer.py:364-428``; not for ``introgression`` yet).

    Returns the scipy result object, ``x`` in natural (mu-scaled)
    coordinates.  ``res_name`` is the output path/prefix;
    ``<res_name>.optimization_history.csv`` and
    ``<res_name>.best_model.yaml`` follow the reference contract (the
    introgression family separates them with '_', as the reference does,
    and writes ``hidden_states.csv`` and ``observed_states.csv`` to the
    output directory).
    """
    if introgression and use_grad:
        raise NotImplementedError(INT_GRADIENT_NOT_PORTED)
    output_dir, output_prefix = os.path.split(res_name)
    sep = "_" if introgression else "."
    history = os.path.join(output_dir,
                           f"{output_prefix}{sep}optimization_history.csv")
    best_model_yaml = os.path.join(output_dir,
                                   f"{output_prefix}{sep}best_model.yaml")
    state_yaml = os.path.join(output_dir,
                              f"{output_prefix}{sep}optimizer_state.yaml")
    if header:
        write_list(["n_eval"] + list(optim_variables) + ["loglik", "time"], history)
    if introgression:
        write_state_maps(output_dir, fixed_params["n_int_AB"],
                         fixed_params["n_int_ABC"])

    engine = LoglikEngine(v_lst, fixed_params["n_int_AB"],
                          fixed_params["n_int_ABC"], dtype=dtype,
                          device=device, introgression=introgression)
    resolver = resolve_times_introgression if introgression else resolve_times
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

    def _record(arg_lst, ll):
        write_list([info["n_eval"]] + [float(v) for v in arg_lst]
                   + [ll, time.time() - info["t0"]], history)
        if os.path.exists(best_model_yaml):
            update_best_model(best_model_yaml, optim_variables, arg_lst, ll,
                              info["n_eval"])
        info["n_eval"] += 1

    if use_grad:
        return _minimize_with_grad(engine, optim_variables, optim_list,
                                   bounds, fixed_params, case, method,
                                   maxiter, _record, _checkpoint)

    # At extreme bound corners (e.g. t_upper/N_ABC ~ 1e3 coalescent units)
    # the model build overflows to non-finite values, and the introgression
    # engine's value is NaN at t_1 < t_m (LoglikEngine.loglik); a large
    # finite penalty keeps simplex steps backtracking instead of
    # propagating NaN into scipy's termination logic.
    penalty = 1e12

    def objective(arg_lst):
        d = dict(fixed_params)
        for name, value in zip(optim_variables, arg_lst):
            d[name] = float(value)
        ll = engine.loglik(resolver(case, d))
        _record(arg_lst, ll)
        return penalty if not np.isfinite(ll) else -ll

    return minimize(
        objective,
        x0=np.asarray(optim_list, dtype=np.float64),
        method=method,
        bounds=bounds,
        callback=_checkpoint,
        options={"maxiter": maxiter, "disp": True},
    )


def write_state_maps(output_dir, n_int_AB, n_int_ABC):
    """The introgression family's state maps, ``hidden_states.csv`` and
    ``observed_states.csv``, in the output directory (the JAX package's
    ``itrails_tpu/optim/optimizer.py:293-315``; reference
    int_optimizer.py:551-560 writes them to the working directory at the
    first evaluation; they depend on no parameter, so they go up front)."""
    hidden = hidden_state_list(n_int_AB, n_int_ABC, introgression=True)
    with open(os.path.join(output_dir, "hidden_states.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["idx", "hidden"])
        w.writerows([i, str(h)] for i, h in enumerate(hidden))
    with open(os.path.join(output_dir, "observed_states.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["idx", "observed"])
        w.writerows(enumerate(token_strings()[:256]))


def _minimize_with_grad(engine, optim_variables, optim_list, bounds,
                        fixed_params, case, method, maxiter, record,
                        checkpoint):
    """scipy ``method`` with ``jac=True`` on the engine's exact gradient.

    The search runs in the scaled space z = x / |x0|: scipy's L-BFGS-B line
    search takes O(1)-norm first steps, which in raw units (t ~ 1e-3, r ~ 1)
    overshoot into the bounds or stall the Wolfe bracket.  The history, the
    best-model YAML and the checkpoint record x, never z."""
    x0 = np.asarray(optim_list, np.float64)
    if not np.all(x0 > 0.0):
        # z0 = 1 assumes positive starts; a nonpositive one would flip the
        # penalty's slope or degenerate the scaling
        raise ValueError("the exact-gradient path needs strictly positive "
                         f"starting values (got {list(optim_list)})")
    scale = np.maximum(np.abs(x0), 1e-30)
    vg = engine.loglik_and_grad_fn(optim_variables, fixed_params, case,
                                   resolve_times)

    # A non-finite build gets a soft, sloped penalty: a flat cliff with zero
    # gradient makes the line search's interpolation collapse the next step
    # and stop the run at its start.  The quadratic bowl around z = 1 slopes
    # back toward the start; its base tracks 10x the largest finite
    # objective seen (1e7 before the first), so the infeasible region never
    # scores better than a feasible point at genome scale.
    soft_penalty = 1e7
    obj_scale = {"max_abs": 0.0}

    def objective(z):
        z = np.asarray(z, np.float64)
        arg_lst = z * scale
        ll, g = vg(arg_lst)
        record(arg_lst, ll)
        if not (np.isfinite(ll) and np.all(np.isfinite(g))):
            base = max(10.0 * obj_scale["max_abs"], soft_penalty)
            dz = z - 1.0
            return base * (1.0 + float(dz @ dz)), 2.0 * base * dz
        obj_scale["max_abs"] = max(obj_scale["max_abs"], abs(ll))
        return -ll, -np.asarray(g, np.float64) * scale

    res = minimize(
        objective,
        x0=x0 / scale,
        method=method,
        jac=True,
        bounds=[(lo / s, hi / s) for (lo, hi), s in zip(bounds, scale)],
        callback=lambda zk: checkpoint(np.asarray(zk) * scale),
        options={"maxiter": maxiter, "disp": True},
    )
    res.x = np.asarray(res.x) * scale
    return res
