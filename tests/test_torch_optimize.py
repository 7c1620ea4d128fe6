"""The port's optimize CLI end to end on the CPU: the reference's
Nelder-Mead trajectory (goldens/traj_1x2.npz, made by running the original
iTRAILS), its artifacts, and ``--resume``."""

import csv
import os

import jax  # noqa: F401  (both frameworks share the test process)
import numpy as np
import pytest
import torch
import yaml

from tests.conftest import GOLDENS, load_golden

torch.set_num_threads(1)

MAF = os.path.join(GOLDENS, "synthetic.maf")
SPECIES = ["hg38", "panTro5", "gorGor5", "ponAbe2"]


def _config(method="Nelder-Mead"):
    """The start point and bounds of traj_1x2.npz, in natural units."""
    settings = {"input_maf": MAF, "output_prefix": None, "n_cpu": 1,
                "species_list": SPECIES, "n_int_AB": 1, "n_int_ABC": 2}
    if method is not None:
        settings["method"] = method
    return {
        "fixed_parameters": {"mu": 1e-8},
        "optimized_parameters": {
            "N_AB": [50000, 5000, 500000],
            "N_ABC": [50000, 5000, 500000],
            "t_1": [240000, 24000, 2400000],
            "t_2": [40000, 4000, 400000],
            "t_upper": [745069.3855, 74506.9385, 7450693.8556],
            "r": [1e-8, 1e-9, 1e-7],
        },
        "settings": settings,
    }


def _run(tmp_path, *extra, method="Nelder-Mead"):
    from itrails_tpu_torch.cli.optimize import main

    cfg = tmp_path / "config.yaml"
    with open(cfg, "w") as f:
        yaml.dump(_config(method), f)
    main([str(cfg), "--output", str(tmp_path / "run" / "t"), "--device",
          "cpu", *extra])
    return tmp_path / "run"


def _history(run_dir):
    return np.loadtxt(run_dir / "t.optimization_history.csv", delimiter=",",
                      skiprows=1)


def test_cli_reproduces_the_reference_trajectory(tmp_path):
    g = load_golden("traj_1x2.npz")
    run_dir = _run(tmp_path, "--no-grad", "--maxiter", "5")
    rows = _history(run_dir)
    n = rows.shape[0]
    assert 5 < n < int(g["n_eval"])
    np.testing.assert_array_equal(rows[:, 0], np.arange(n))
    np.testing.assert_allclose(rows[:, 1:-2], g["history_params"][:n],
                               rtol=1e-10)
    np.testing.assert_allclose(rows[:, -2], g["history_loglik"][:n], rtol=1e-8)

    header = next(csv.reader(open(run_dir / "t.optimization_history.csv")))
    assert header == ["n_eval", *[str(v) for v in g["variables"]], "loglik",
                      "time"]
    assert (run_dir / "t.starting_params.yaml").exists()
    best = yaml.safe_load(open(run_dir / "t.best_model.yaml"))
    assert best["results"]["log_likelihood"] == pytest.approx(rows[:, -2].max(),
                                                              rel=1e-12)
    assert best["results"]["iteration"] == int(np.argmax(rows[:, -2]))
    assert 5000 <= best["optimized_parameters"]["N_AB"] <= 500000
    state = yaml.safe_load(open(run_dir / "t.optimizer_state.yaml"))
    assert state["variables"] == [str(v) for v in g["variables"]]


def test_cli_resume_appends_and_starts_from_the_checkpoint(tmp_path):
    run_dir = _run(tmp_path, "--no-grad", "--maxiter", "2")
    n_first = _history(run_dir).shape[0]
    best1 = yaml.safe_load(open(run_dir / "t.best_model.yaml"))
    state = yaml.safe_load(open(run_dir / "t.optimizer_state.yaml"))
    state["x_internal"][0] *= 1.07
    yaml.safe_dump(state, open(run_dir / "t.optimizer_state.yaml", "w"))

    _run(tmp_path, "--no-grad", "--maxiter", "1", "--resume")
    text = list(csv.reader(open(run_dir / "t.optimization_history.csv")))
    assert sum(1 for r in text if r[0] == "n_eval") == 1
    rows = _history(run_dir)
    assert rows.shape[0] > n_first
    # the first evaluation after the resume is the checkpointed iterate
    np.testing.assert_allclose(rows[n_first, 1], state["x_internal"][0],
                               rtol=1e-15)
    best2 = yaml.safe_load(open(run_dir / "t.best_model.yaml"))
    assert (best2["results"]["log_likelihood"]
            >= best1["results"]["log_likelihood"])


@pytest.mark.parametrize("method,flags", [(None, ()), ("Nelder-Mead", ("--grad",)),
                                          ("L-BFGS-B", ())])
def test_cli_refuses_the_exact_gradient_path(tmp_path, method, flags):
    from itrails_tpu_torch.cli.optimize import GRADIENT_NOT_PORTED

    with pytest.raises(SystemExit) as exc:
        _run(tmp_path, *flags, method=method)
    assert str(exc.value) == GRADIENT_NOT_PORTED
    assert not (tmp_path / "run" / "t.optimization_history.csv").exists()


def test_cli_refuses_obs_modes_other_than_standard(tmp_path):
    from itrails_tpu_torch.cli.optimize import main

    cfg = _config()
    cfg["settings"]["obs_mode"] = "new-method"
    path = tmp_path / "config.yaml"
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    with pytest.raises(ValueError, match="obs_mode"):
        main([str(path), "--output", str(tmp_path / "t"), "--device", "cpu",
              "--no-grad"])
