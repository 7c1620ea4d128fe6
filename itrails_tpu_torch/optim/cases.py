"""Time-parameterization case algebra.

Users may specify speciation times through any of 8 allowed combinations of
{t_1, t_A, t_B, t_C} (reference workflow_optimize.py:169-184); the optimizer
derives the remaining per-species times and the outgroup divergence ``t_out``
per evaluation (reference optimizer.py:417-541).  All parameters here are in
the mu-scaled units the workflows use internally.
"""

from __future__ import annotations

import math

__all__ = ["ALLOWED_CASES", "resolve_times", "resolve_times_introgression"]

ALLOWED_CASES = {
    frozenset(["t_A", "t_B", "t_C"]),
    frozenset(["t_1", "t_A"]),
    frozenset(["t_1", "t_B"]),
    frozenset(["t_1", "t_C"]),
    frozenset(["t_A", "t_B"]),
    frozenset(["t_A", "t_C"]),
    frozenset(["t_B", "t_C"]),
    frozenset(["t_1"]),
}


def _deep_time(d):
    """norm_cut_ABC[-2] * N_ABC: start of the deepest interval in scaled
    units; the last finite cutpoint of the unit-rate discretization is
    -log(1 - (n-1)/n) = log(n)."""
    return math.log(d["n_int_ABC"]) * d["N_ABC"]


def resolve_times(case: frozenset, d: dict, deep: float | None = None) -> dict:
    """Return a copy of ``d`` with t_A, t_B, t_C and t_out filled in
    according to the parameter case.  ``d`` must already contain the case's
    time parameters plus t_2, t_upper, N_ABC (and optionally a fixed t_out,
    which always wins).  ``deep`` overrides the start of the deepest
    interval (scaled) for manual cutpoints."""
    if case not in ALLOWED_CASES:
        raise ValueError(f"Invalid combination of time values: {set(case)}")
    d = dict(d)
    if deep is None:
        deep = _deep_time(d)
    tail = deep + d["t_upper"] + 2.0 * d["N_ABC"]

    def default_out(value):
        return d["t_out"] if "t_out" in d else value

    if case == frozenset(["t_A", "t_B", "t_C"]):
        mid = (d["t_A"] + d["t_B"]) / 2 + d["t_2"]
        d["t_out"] = default_out((mid + d["t_C"]) / 2 + tail)
    elif case in (
        frozenset(["t_1", "t_A"]),
        frozenset(["t_1", "t_B"]),
        frozenset(["t_1", "t_C"]),
        frozenset(["t_1"]),
    ):
        t1 = d.pop("t_1")
        if case == frozenset(["t_1", "t_A"]):
            d["t_B"] = t1
            d["t_C"] = t1 + d["t_2"]
        elif case == frozenset(["t_1", "t_B"]):
            d["t_A"] = t1
            d["t_C"] = t1 + d["t_2"]
        elif case == frozenset(["t_1", "t_C"]):
            d["t_A"] = t1
            d["t_B"] = t1
        else:
            d["t_A"] = t1
            d["t_B"] = t1
            d["t_C"] = t1 + d["t_2"]
        d["t_out"] = default_out(t1 + d["t_2"] + tail)
    elif case == frozenset(["t_A", "t_B"]):
        t_c = (d["t_A"] + d["t_B"]) / 2 + d["t_2"]
        d["t_C"] = t_c
        mid = (d["t_A"] + d["t_B"]) / 2 + d["t_2"]
        d["t_out"] = default_out((mid + t_c) / 2 + tail)
    elif case == frozenset(["t_A", "t_C"]):
        t_b = (d["t_A"] + d["t_C"] - d["t_2"]) / 2
        d["t_B"] = t_b
        mid = (d["t_A"] + t_b) / 2 + d["t_2"]
        d["t_out"] = default_out((mid + d["t_C"]) / 2 + tail)
    elif case == frozenset(["t_B", "t_C"]):
        t_a = (d["t_B"] + d["t_C"] - d["t_2"]) / 2
        d["t_A"] = t_a
        mid = (t_a + d["t_B"]) / 2 + d["t_2"]
        d["t_out"] = default_out((mid + d["t_C"]) / 2 + tail)
    return d


def resolve_times_introgression(case: frozenset, d: dict,
                                deep: float | None = None) -> dict:
    """Introgression variant of the case algebra (reference
    int_optimizer.py:397-588): ``t_B``/``t_C`` run to the migration event,
    so e.g. ``t_1`` cases give ``t_B = t_C = t_1 - t_m``."""
    if case not in ALLOWED_CASES:
        raise ValueError(f"Invalid combination of time values: {set(case)}")
    d = dict(d)
    if deep is None:
        deep = _deep_time(d)
    tail = deep + d["t_upper"] + 2.0 * d["N_ABC"]
    t_m = d["t_m"]

    def default_out(value):
        return d["t_out"] if "t_out" in d else value

    def abc_out(t_a, t_b, t_c):
        return ((t_a + (t_b + t_m)) / 2 + d["t_2"]) + (
            t_c + t_m + d["t_2"]
        ) / 2 + tail

    if case == frozenset(["t_A", "t_B", "t_C"]):
        d["t_out"] = default_out(abc_out(d["t_A"], d["t_B"], d["t_C"]))
    elif case in (
        frozenset(["t_1", "t_A"]),
        frozenset(["t_1", "t_B"]),
        frozenset(["t_1", "t_C"]),
        frozenset(["t_1"]),
    ):
        t1 = d.pop("t_1")
        if case == frozenset(["t_1", "t_A"]):
            d["t_B"] = t1 - t_m
            d["t_C"] = t1 - t_m
        elif case == frozenset(["t_1", "t_B"]):
            d["t_A"] = t1
            d["t_C"] = t1 - t_m
        elif case == frozenset(["t_1", "t_C"]):
            d["t_A"] = t1
            d["t_B"] = t1 - t_m
        else:
            d["t_A"] = t1
            d["t_B"] = t1 - t_m
            d["t_C"] = t1 - t_m
        d["t_out"] = default_out(t1 + d["t_2"] + tail)
    elif case == frozenset(["t_A", "t_B"]):
        t_c = (d["t_B"] + d["t_A"] + t_m) / 2
        d["t_C"] = t_c
        d["t_out"] = default_out(abc_out(d["t_A"], d["t_B"], t_c))
    elif case == frozenset(["t_A", "t_C"]):
        t_b = (d["t_C"] + d["t_A"] + t_m) / 2
        d["t_B"] = t_b
        d["t_out"] = default_out(abc_out(d["t_A"], t_b, d["t_C"]))
    elif case == frozenset(["t_B", "t_C"]):
        t_a = (d["t_C"] + d["t_B"] + t_m) / 2
        d["t_A"] = t_a
        d["t_out"] = default_out(abc_out(t_a, d["t_B"], d["t_C"]))
    return d
