"""Shared CLI plumbing: IO precedence, parameter validation, mu scaling.

Mirrors the reference workflows' behavior (workflow_optimize.py:48-466) so
configs written for iTRAILS run unchanged.
"""

from __future__ import annotations

import argparse
import os

from itrails_tpu_torch.core.cutpoints import cutpoints_abc
from itrails_tpu_torch.optim.cases import ALLOWED_CASES

__all__ = [
    "standard_parser",
    "resolve_io",
    "prepare_optimize_setup",
    "resolve_optim_method",
    "TIME_PARAMS",
]

TIME_PARAMS = ("t_1", "t_A", "t_B", "t_C")


def standard_parser(description, usage=None):
    p = argparse.ArgumentParser(description=description, usage=usage)
    p.add_argument("config_file", type=str, help="Path to the YAML config file.")
    p.add_argument("--input", type=str, required=False,
                   help="Path to the MAF alignment file.")
    p.add_argument("--output", type=str, required=False,
                   help="Path and prefix for output files ('directory/prefix').")
    return p


def resolve_io(config, args):
    """Input/output precedence: command line wins over config
    (reference workflow_optimize.py:51-96)."""
    input_config = config["settings"].get("input_maf")
    output_config = config["settings"].get("output_prefix")
    maf_path = args.input or input_config
    user_output = args.output or output_config
    if args.input and input_config:
        print(f"Warning: MAF alignment file specified in both config file "
              f"({input_config}) and command-line ({args.input}). "
              f"Using command-line input.")
    if args.output and output_config:
        print(f"Warning: Output file specified in both config file "
              f"({output_config}) and command-line ({args.output}). "
              f"Using command-line output.")
    if not maf_path:
        raise ValueError(
            "Error: MAF alignment file not specified in config file or command-line."
        )
    if not user_output:
        raise ValueError(
            "Error: Output file not specified in config file or command-line."
        )
    output_dir, output_prefix = os.path.split(user_output)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    return maf_path, user_output, output_dir, output_prefix


def _classify(name, fixed, optimized):
    if name in fixed and name in optimized:
        raise ValueError(f"Parameter '{name}' cannot be both fixed and optimized.")
    if name in fixed:
        return "fixed"
    if name in optimized:
        return "optimized"
    return None


def prepare_optimize_setup(config):
    """Parse + validate an optimize config; returns a dict with
    optim_variables/optim_list/bounds_list (mu-scaled), fixed_dict
    (mu-scaled), case, and de-scaled dicts for the YAML artifacts.
    """
    fixed = config["fixed_parameters"]
    optimized = config["optimized_parameters"]
    settings = config["settings"]
    mu = float(fixed["mu"])
    n_int_AB = settings["n_int_AB"]
    n_int_ABC = settings["n_int_ABC"]
    if not (isinstance(n_int_AB, int) and n_int_AB > 0):
        raise ValueError("n_int_AB must be a positive integer")
    if not (isinstance(n_int_ABC, int) and n_int_ABC > 0):
        raise ValueError("n_int_ABC must be a positive integer")
    if not isinstance(mu, (int, float)) or mu <= 0:
        raise ValueError("mu must be a positive float or int.")

    method = settings.get("method", "Nelder-Mead").lower()
    if method not in ("nelder-mead", "l-bfgs-b"):
        raise ValueError("Method must be one of ['nelder-mead', 'l-bfgs-b'].")

    fixed_dict = {"n_int_AB": n_int_AB, "n_int_ABC": n_int_ABC}
    optim_variables, optim_list, bounds_list = [], [], []
    found = set()

    def take(name):
        kind = _classify(name, fixed, optimized)
        if kind == "fixed":
            found.add(name)
            fixed_dict[name] = float(fixed[name])
        elif kind == "optimized":
            found.add(name)
            start, lo, hi = (float(x) for x in optimized[name])
            optim_variables.append(name)
            optim_list.append(start)
            bounds_list.append((lo, hi))
        return kind

    for name in TIME_PARAMS:
        take(name)
    case = frozenset(found)
    if case not in ALLOWED_CASES:
        raise ValueError(
            f"Invalid combination of time values: {found}, check possible "
            f"combinations in the documentation."
        )

    required = ("t_2", "N_ABC", "N_AB", "r")
    for name in required:
        if take(name) is None:
            raise ValueError(
                f"Parameters {required} must be present in optimized or "
                f"fixed parameters."
            )

    # t_upper: direct, or derived from t_3 and N_ABC
    # (reference workflow_optimize.py:238-360)
    if "t_upper" in optimized:
        start, lo, hi = (float(x) for x in optimized["t_upper"])
        if start < 0 or lo < 0 or hi < 0:
            raise ValueError("Parameter 't_upper' cannot be negative. "
                             "Please check your input parameters.")
        optim_variables.append("t_upper")
        optim_list.append(start)
        bounds_list.append((lo, hi))
    elif "t_upper" in fixed:
        if float(fixed["t_upper"]) < 0:
            raise ValueError("Parameter 't_upper' cannot be negative. "
                             "Please check your input parameters.")
        fixed_dict["t_upper"] = float(fixed["t_upper"])
    else:
        print("Warning: 't_upper' not found in parameter definition. "
              "Calculating from 't_3' and 'N_ABC'.")
        deep = float(cutpoints_abc(n_int_ABC, 1.0, device="cpu")[-2])

        def t_upper_from(t3, n_abc):
            return t3 - deep * n_abc

        if "N_ABC" in optimized:
            n0, n_lo, n_hi = (float(x) for x in optimized["N_ABC"])
        elif "N_ABC" in fixed:
            n0 = n_lo = n_hi = float(fixed["N_ABC"])
        else:
            raise ValueError("'N_ABC' not found in parameter definition.")
        if "t_3" in optimized:
            t0, t_lo, t_hi = (float(x) for x in optimized["t_3"])
        elif "t_3" in fixed:
            if "N_ABC" in fixed:
                raise ValueError(
                    "At least one, 't_3' or 'N_ABC' must be present in "
                    "optimized parameters."
                )
            t0 = t_lo = t_hi = float(fixed["t_3"])
        else:
            raise ValueError("'t_3' not found in parameter definition.")
        start = t_upper_from(t0, n0)
        lo = t_upper_from(t_lo, n_hi)
        hi = t_upper_from(t_hi, n_lo)
        if not (lo <= start <= hi):
            raise ValueError(
                f"When calculating t_upper from t_3 and N_ABC, the starting "
                f"value ({start}) was not between the minimum ({lo}) and "
                f"maximum ({hi})."
            )
        if start < 0 or lo < 0 or hi < 0:
            raise ValueError("Calculated 't_upper' values cannot be negative. "
                             "Please check your input parameters.")
        optim_variables.append("t_upper")
        optim_list.append(start)
        bounds_list.append((lo, hi))

    if "t_out" in optimized:
        raise ValueError("Parameter 't_out' has to be fixed.")
    if "t_out" in fixed:
        fixed_dict["t_out"] = float(fixed["t_out"])

    # validation + mu scaling (reference workflow_optimize.py:368-405)
    def scale(name, v):
        return v / mu if name == "r" else v * mu

    def descale(name, v):
        return v * mu if name == "r" else v / mu

    for i, name in enumerate(optim_variables):
        start = optim_list[i]
        lo, hi = bounds_list[i]
        if not (lo <= start <= hi):
            raise ValueError(
                f"Starting value for '{name}' ({start}) must be between the "
                f"minimum ({lo}) and maximum ({hi})."
            )
        if start <= 0:
            raise ValueError(f"Starting value for '{name}' must be a positive number.")
        if lo <= 0:
            raise ValueError(f"Minimum value for '{name}' must be a positive number.")
        optim_list[i] = scale(name, start)
        bounds_list[i] = (scale(name, lo), scale(name, hi))

    for name, value in list(fixed_dict.items()):
        if name not in ("n_int_AB", "n_int_ABC"):
            fixed_dict[name] = scale(name, value)

    # de-scaled copies for the YAML artifacts
    descaled_fixed = {
        k: descale(k, v)
        for k, v in fixed_dict.items()
        if k not in ("n_int_AB", "n_int_ABC")
    }
    descaled_fixed["mu"] = mu
    descaled_bounds = {
        name: [
            descale(name, optim_list[i]),
            descale(name, bounds_list[i][0]),
            descale(name, bounds_list[i][1]),
        ]
        for i, name in enumerate(optim_variables)
    }

    return {
        "case": case,
        "method": method,
        "method_explicit": "method" in settings,
        "mu": mu,
        "optim_variables": optim_variables,
        "optim_list": optim_list,
        "bounds_list": bounds_list,
        "fixed_dict": fixed_dict,
        "descaled_fixed": descaled_fixed,
        "descaled_bounds": descaled_bounds,
        "settings": settings,
    }


def resolve_optim_method(setup, grad_flag: bool, no_grad_flag: bool):
    """Resolve ``(use_grad, scipy_method)`` for an optimize CLI run, with
    the JAX package's rules (itrails_tpu/cli/common.py:441-462).

    Default (no flags, no explicit ``settings.method``): the
    exact-gradient L-BFGS-B path; the reference has no exact-gradient mode
    at all (its L-BFGS-B is finite-difference, reference
    optimizer.py:620-637).  Explicitly
    setting ``settings.method: Nelder-Mead`` (or passing ``--no-grad``)
    restores the reference's default algorithm for trajectory-level
    parity; ``--no-grad`` with ``settings.method: L-BFGS-B`` gives
    scipy's finite-difference L-BFGS-B, the reference's other mode."""
    if grad_flag and no_grad_flag:
        raise ValueError("--grad and --no-grad are mutually exclusive")
    if no_grad_flag:
        return False, ("L-BFGS-B" if setup["method"] == "l-bfgs-b"
                       else "Nelder-Mead")
    if grad_flag:
        return True, "L-BFGS-B"
    if setup["method_explicit"] and setup["method"] == "nelder-mead":
        return False, "Nelder-Mead"
    return True, "L-BFGS-B"
