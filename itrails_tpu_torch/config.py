"""YAML configuration I/O and the best-model checkpoint contract.

The file formats are byte-compatible with the reference (yaml_helpers.py):

* config schema: ``fixed_parameters`` / ``optimized_parameters``
  (``[start, min, max]`` triples) / ``settings``;
* ``<prefix>.best_model.yaml`` is the checkpoint: seeded with -inf
  log-likelihood, overwritten whenever an evaluation improves it, with
  parameters de-scaled by mu (r multiplied, others divided) — it doubles as
  the input config for subsequent viterbi/posterior runs.
"""

from __future__ import annotations

import os
import sys
from math import inf

import yaml

__all__ = ["FlowSeq", "load_config", "update_best_model", "seed_best_model",
           "write_starting_params"]


class FlowSeq(list):
    """List subclass serialized inline ([a, b, c]) in YAML output."""


def _flow_seq_representer(dumper, data):
    return dumper.represent_sequence("tag:yaml.org,2002:seq", data, flow_style=True)


yaml.add_representer(FlowSeq, _flow_seq_representer)


def load_config(config_file):
    try:
        with open(config_file) as f:
            return yaml.safe_load(f)
    except Exception as e:  # pragma: no cover - mirrors reference behavior
        print(f"Error loading config file: {e}", file=sys.stderr)
        sys.exit(1)


def seed_best_model(path, fixed_parameters, settings):
    """Write the initial best-model checkpoint with -inf log-likelihood
    (reference workflow_optimize.py:458-466)."""
    data = {
        "fixed_parameters": fixed_parameters,
        "optimized_parameters": {},
        "results": {"log_likelihood": -inf, "iteration": None},
        "settings": settings,
    }
    with open(path, "w") as f:
        yaml.dump(data, f)


def write_starting_params(path, fixed_parameters, optimized_bounds, settings):
    """Write ``<prefix>.starting_params.yaml`` (reference
    workflow_optimize.py:419-456)."""
    data = {
        "fixed_parameters": fixed_parameters,
        "optimized_parameters": {
            k: FlowSeq(v) for k, v in optimized_bounds.items()
        },
        "settings": dict(settings),
    }
    if "species_list" in data["settings"]:
        data["settings"]["species_list"] = FlowSeq(data["settings"]["species_list"])
    with open(path, "w") as f:
        yaml.dump(data, f, default_flow_style=False)


def update_best_model(best_model_yaml, optim_variables, current_optim_params,
                      current_result, iteration):
    """Conditionally update the best-model checkpoint (reference
    yaml_helpers.py:57-118): overwrite only if the new log-likelihood
    improves; parameters are de-scaled by the stored mu."""
    if not os.path.exists(best_model_yaml):
        raise FileNotFoundError(f"Best model file not found: {best_model_yaml}")
    with open(best_model_yaml) as f:
        data = yaml.safe_load(f)

    mu = float(data["fixed_parameters"]["mu"])
    prev = data["results"]["log_likelihood"]
    if prev is not None and current_result <= prev:
        return False

    optim = {}
    for i, name in enumerate(optim_variables):
        v = float(current_optim_params[i])
        if name == "r":
            optim[name] = v * mu
        elif name == "m":  # dimensionless admixture proportion
            optim[name] = v
        else:
            optim[name] = v / mu
    data["optimized_parameters"] = optim
    data["results"]["log_likelihood"] = float(current_result)
    data["results"]["iteration"] = iteration
    with open(best_model_yaml, "w") as f:
        yaml.dump(data, f)
    return True
