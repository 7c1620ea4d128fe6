"""Shared CLI plumbing: IO precedence, parameter validation, mu scaling.

Mirrors the reference workflows' behavior (workflow_optimize.py:48-466,
workflow_viterbi.py:19-610) so configs written for iTRAILS run unchanged.
"""

from __future__ import annotations

import argparse
import math
import os

from itrails_tpu_torch.config import load_config
from itrails_tpu_torch.core.cutpoints import cutpoints_ab, cutpoints_abc
from itrails_tpu_torch.optim.cases import ALLOWED_CASES, resolve_times

__all__ = [
    "standard_parser",
    "decode_parser",
    "merge_decode_overrides",
    "resolve_io",
    "prepare_optimize_setup",
    "prepare_decode_setup",
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


def decode_parser(description, usage=None):
    """The decode workflows' parser (plain family): per-parameter override
    flags and config-optional invocation, flag for flag with the reference
    (workflow_viterbi.py:19-88) and ``itrails_tpu/cli/common.py:56``, plus
    ``--device``."""
    p = argparse.ArgumentParser(description=description, usage=usage)
    p.add_argument("config_file", type=str, nargs="?", default=None,
                   help="Path to the YAML config file (equivalently "
                        "--config-file).")
    p.add_argument("--config-file", dest="config_file_flag", type=str,
                   required=False, help="Path to the YAML config file.")
    p.add_argument("--input", type=str, required=False,
                   help="Path to the MAF alignment file.")
    p.add_argument("--output", type=str, required=False,
                   help="Path and prefix for output files ('directory/prefix').")
    # Parameter overrides (always land in fixed_parameters)
    p.add_argument("--mu", type=float, help="Mutation rate")
    p.add_argument("--t1", type=float, help="Time parameter t_1")
    p.add_argument("--t_A", type=float, help="Time to speciation for species A")
    p.add_argument("--t_B", type=float, help="Time to speciation for species B")
    p.add_argument("--t_C", type=float, help="Time to speciation for species C")
    p.add_argument("--t2", type=float,
                   help="Time between first and second speciation")
    p.add_argument("--t3", type=float, help="Time parameter t_3")
    p.add_argument("--t_upper", type=float, help="Upper time parameter")
    p.add_argument("--t_out", type=float, help="Outgroup time parameter")
    p.add_argument("--N_AB", type=float, help="Effective population size for AB")
    p.add_argument("--N_ABC", type=float, help="Effective population size for ABC")
    p.add_argument("--r", type=float, help="Recombination rate")
    # Settings overrides
    p.add_argument("--n_cpu", type=int, help="Number of CPUs to use")
    p.add_argument("--species_list", nargs="+", help="List of species names")
    p.add_argument("--reference", type=str,
                   help="Reference to polarize coordinates")
    p.add_argument("--n_int_AB", type=int, help="Number of intervals for AB")
    p.add_argument("--n_int_ABC", type=int, help="Number of intervals for ABC")
    p.add_argument("--cutpoints_AB", nargs="+", type=float,
                   help="Manual cutpoints for AB intervals")
    p.add_argument("--cutpoints_ABC", nargs="+", type=float,
                   help="Manual cutpoints for ABC intervals")
    p.add_argument("--precision", choices=["float32", "float64"],
                   default="float64",
                   help="Dtype of the decode (default float64). On the "
                        "card the posterior decode (kernel K4) runs in it; "
                        "the Viterbi decode (kernel K3) always runs in "
                        "float32 there, and the flag acts only with "
                        "--device cpu.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device of the model build and the decode (default: "
                        "cuda; there is no automatic CPU fallback).")
    return p


def merge_decode_overrides(args):
    """Merge CLI override flags into the (possibly absent) config, with the
    reference's precedence: a CLI parameter removes the entry from
    optimized_parameters and pins it in fixed_parameters
    (workflow_viterbi.py:89-158)."""
    config_path = args.config_file or args.config_file_flag
    if args.config_file and args.config_file_flag:
        raise ValueError(
            "Error: config file given both positionally and via --config-file."
        )
    config = load_config(config_path) if config_path else {}
    for key in ("fixed_parameters", "optimized_parameters", "settings"):
        if config.get(key) is None:
            config[key] = {}
    fixed = config["fixed_parameters"]
    optimized = config["optimized_parameters"]
    settings = config["settings"]

    if args.mu is not None:
        fixed["mu"] = args.mu
    elif "mu" not in fixed:
        raise ValueError(
            "Error: mu must be specified either in config file or via --mu"
        )

    params = {
        "t_1": args.t1, "t_A": args.t_A, "t_B": args.t_B, "t_C": args.t_C,
        "t_2": args.t2, "t_3": args.t3, "t_upper": args.t_upper,
        "t_out": args.t_out, "N_AB": args.N_AB, "N_ABC": args.N_ABC,
        "r": args.r,
    }
    for name, value in params.items():
        if value is not None:
            if name in optimized:
                print(f"Warning: parameter '{name}' specified in both config "
                      f"file and command-line. Using command-line value.")
                del optimized[name]
            elif name in fixed:
                print(f"Warning: parameter '{name}' specified in both config "
                      f"file and command-line. Using command-line value.")
            fixed[name] = value

    for name in ("n_cpu", "species_list", "reference", "n_int_AB",
                 "n_int_ABC", "cutpoints_AB", "cutpoints_ABC"):
        value = getattr(args, name)
        if value is not None:
            settings[name] = value

    # interval-count validation / derivation from manual cutpoints
    # (reference workflow_viterbi.py:208-228; n_int derivation is the JAX
    # package's — the reference crashes downstream when only cutpoints
    # are given)
    if not settings.get("n_int_AB") and not settings.get("cutpoints_AB"):
        raise ValueError(
            "Error: n_int_AB must be specified in the config file for "
            "automatic cutpoints, n_int_AB and cutpoints_AB must be "
            "specified in the config file for manual cutpoints."
        )
    if not settings.get("n_int_ABC") and not settings.get("cutpoints_ABC"):
        raise ValueError(
            "Error: n_int_ABC must be specified in the config file for "
            "automatic cutpoints, n_int_ABC and cutpoints_ABC must be "
            "specified in the config file for manual cutpoints."
        )
    if not settings.get("n_int_AB"):
        settings["n_int_AB"] = len(settings["cutpoints_AB"]) - 1
    if not settings.get("n_int_ABC"):
        settings["n_int_ABC"] = len(settings["cutpoints_ABC"])
    return config


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


def prepare_optimize_setup(config, introgression=False):
    """Parse + validate an optimize config; returns a dict with
    optim_variables/optim_list/bounds_list (mu-scaled), fixed_dict
    (mu-scaled), case, and de-scaled dicts for the YAML artifacts.

    With ``introgression`` (``itrails_tpu/cli/common.py:244``) the model
    also needs ``N_BC``, ``t_m`` and ``m``, and a proportional ``t_m`` is
    refused.  NOTE (deviation, as in the JAX package): the reference's int
    workflows multiply the admixture proportion ``m`` by mu like a time
    parameter (workflow_int_optimize.py:372-390), which silently scales a
    dimensionless probability by ~1e-8; here ``m`` is used as given.
    """
    fixed = config["fixed_parameters"]
    optimized = config["optimized_parameters"]
    settings = config["settings"]
    if introgression and settings.get("proportional"):
        raise ValueError(
            "Proportional t_m is currently not supported in the optimization "
            "workflow. Please provide t_m as an absolute value in generations."
        )
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

    required = (
        ("t_2", "N_ABC", "N_AB", "N_BC", "r", "t_m", "m")
        if introgression
        else ("t_2", "N_ABC", "N_AB", "r")
    )
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

    # validation + mu scaling (reference workflow_optimize.py:368-405);
    # 'm' is a dimensionless proportion and is not scaled (see NOTE above)
    def scale(name, v):
        if name == "r":
            return v / mu
        if name == "m":
            return v
        return v * mu

    def descale(name, v):
        if name == "r":
            return v * mu
        if name == "m":
            return v
        return v / mu

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
    optimizer.py:620-637).  The JAX package's own comparison
    (GRADEVAL.json, on a TPU) found it faster to convergence than
    Nelder-Mead in the plain family and slower (0.65-0.81x) in the
    introgression family, with better optima in both.  Explicitly
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


def prepare_decode_setup(config):
    """Parse a Viterbi config (parameters are scalars, typically the
    best_model.yaml of an optimize run) into a fully resolved, mu-scaled
    parameter dict plus cutpoints (reference workflow_viterbi.py:154-610,
    ``itrails_tpu/cli/common.py:465``, plain family)."""
    fixed = config["fixed_parameters"]
    optimized = config.get("optimized_parameters") or {}
    settings = config["settings"]
    mu = float(fixed["mu"])
    n_int_AB = settings["n_int_AB"]
    n_int_ABC = settings["n_int_ABC"]

    def _scalar(value):
        # accept an optimize-style [start, min, max] triple by taking the
        # starting value, so an optimize config can be decoded directly
        # (the reference crashes on triples; best_model.yaml is scalar)
        if isinstance(value, (list, tuple)):
            value = value[0]
        return float(value)

    d = {"n_int_AB": n_int_AB, "n_int_ABC": n_int_ABC}
    found = set()
    for name in TIME_PARAMS:
        kind = _classify(name, fixed, optimized)
        if kind:
            found.add(name)
            d[name] = _scalar(fixed[name] if kind == "fixed" else optimized[name])
    case = frozenset(found)
    if case not in ALLOWED_CASES:
        raise ValueError(f"Invalid combination of time values: {found}")

    for name in ("t_2", "N_ABC", "N_AB", "r"):
        kind = _classify(name, fixed, optimized)
        if kind is None:
            raise ValueError(f"Parameter '{name}' must be provided.")
        d[name] = _scalar(fixed[name] if kind == "fixed" else optimized[name])

    pre = dict(d)  # un-scaled values for cutpoints
    pre_t_A = d.get("t_A", d.get("t_1"))
    if pre_t_A is None:  # case {t_B, t_C}: derive (the reference crashes here)
        pre_t_A = (d["t_B"] + d["t_C"] - d["t_2"]) / 2

    # manual cutpoints (absolute units, reference workflow_viterbi.py:345-358)
    cut_ab_abs = settings.get("cutpoints_AB")
    cut_abc_abs = settings.get("cutpoints_ABC")
    norm_cut_ab = None
    norm_cut_abc = None
    if cut_ab_abs is not None:
        if len(cut_ab_abs) != n_int_AB + 1:
            raise ValueError("cutpoints_AB must have n_int_AB + 1 values.")
        norm_cut_ab = [(float(x) - pre_t_A) / pre["N_ABC"] for x in cut_ab_abs]
    if cut_abc_abs is not None:
        if len(cut_abc_abs) != n_int_ABC:
            raise ValueError("cutpoints_ABC must have n_int_ABC values "
                             "(the final infinite bound is implicit).")
        norm_cut_abc = [
            (float(x) - pre_t_A - pre["t_2"]) / pre["N_ABC"] for x in cut_abc_abs
        ]

    # t_upper: direct or from t_3 (reference workflow_viterbi.py:360-404)
    kind = _classify("t_upper", fixed, optimized)
    if kind:
        d["t_upper"] = _scalar(fixed["t_upper"] if kind == "fixed"
                               else optimized["t_upper"])
    else:
        t3_kind = _classify("t_3", fixed, optimized)
        if t3_kind is None:
            raise ValueError("'t_3' not found in parameter definition.")
        t3 = _scalar(fixed["t_3"] if t3_kind == "fixed" else optimized["t_3"])
        if norm_cut_abc is not None:
            deep_unscaled = norm_cut_abc[-1]
        else:
            deep_unscaled = float(cutpoints_abc(n_int_ABC, 1.0, device="cpu")[-2])
        d["t_upper"] = t3 - deep_unscaled * d["N_ABC"]
    if d["t_upper"] < 0:
        raise ValueError(
            "Parameter 't_upper' must be a positive number. "
            f"Given/calculated value: {d['t_upper']}"
        )

    if "t_out" in optimized:
        raise ValueError("Parameter 't_out' has to be fixed.")
    if "t_out" in fixed:
        d["t_out"] = _scalar(fixed["t_out"])

    for name, value in list(d.items()):
        if name not in ("n_int_AB", "n_int_ABC"):
            d[name] = value / mu if name == "r" else value * mu

    deep = None if norm_cut_abc is None else norm_cut_abc[-1] * d["N_ABC"]
    d = resolve_times(case, d, deep=deep)

    # absolute cutpoints for reporting (units of the input config)
    if norm_cut_ab is not None:
        abs_cut_ab = [float(x) for x in cut_ab_abs]
    else:
        coal_ab = pre["N_ABC"] / pre["N_AB"]
        cuts = cutpoints_ab(n_int_AB, pre["t_2"] / pre["N_ABC"], coal_ab,
                            device="cpu")
        abs_cut_ab = [pre_t_A + float(x) * pre["N_ABC"] for x in cuts]
    if norm_cut_abc is not None:
        abs_cut_abc = [float(x) for x in cut_abc_abs] + [math.inf]
    else:
        cuts = cutpoints_abc(n_int_ABC, 1.0, device="cpu")[:-1]
        abs_cut_abc = [
            pre_t_A + pre["t_2"] + float(x) * pre["N_ABC"] for x in cuts
        ] + [math.inf]

    return {
        "params": d,
        "case": case,
        "mu": mu,
        "settings": settings,
        "norm_cut_ab": norm_cut_ab,
        "norm_cut_abc": norm_cut_abc,
        "abs_cut_ab": abs_cut_ab,
        "abs_cut_abc": abs_cut_abc,
    }
