"""The port's optimize CLI end to end on the CPU: the reference's
Nelder-Mead trajectory (goldens/traj_1x2.npz, made by running the original
iTRAILS), its artifacts, ``--resume``, and the exact-gradient default
against the JAX CLI; the optimizer's exact-gradient path."""

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


@pytest.fixture(scope="module")
def jax_grad_history(tmp_path_factory):
    """The JAX CLI's exact-gradient run on the config of the gradient CLI
    cases (its default: no flag, no settings.method)."""
    from itrails_tpu.cli.optimize import main

    tmp = tmp_path_factory.mktemp("jax_grad")
    cfg = tmp / "config.yaml"
    with open(cfg, "w") as f:
        yaml.dump(_config(None), f)
    main([str(cfg), "--output", str(tmp / "run" / "t"), "--maxiter", "2"])
    return _history(tmp / "run")


@pytest.mark.parametrize("method,flags", [(None, ()), ("Nelder-Mead", ("--grad",)),
                                          ("L-BFGS-B", ())])
def test_cli_runs_the_exact_gradient_path(tmp_path, method, flags,
                                          jax_grad_history):
    """No flag, ``--grad`` over ``method: Nelder-Mead``, and
    ``method: L-BFGS-B`` all run exact-gradient L-BFGS-B, and its first
    rows equal the JAX CLI's (parameters and loglik rtol 1e-8)."""
    run_dir = _run(tmp_path, *flags, "--maxiter", "2", method=method)
    rows = _history(run_dir)
    g = load_golden("traj_1x2.npz")
    np.testing.assert_array_equal(rows[:, 0], np.arange(rows.shape[0]))
    # z = x / |x0| starts at 1, so the first row is x0 (up to one rounding)
    np.testing.assert_allclose(rows[0, 1:-2], g["history_params"][0],
                               rtol=1e-15)
    assert np.isfinite(rows).all()
    best = yaml.safe_load(open(run_dir / "t.best_model.yaml"))
    assert best["results"]["log_likelihood"] == pytest.approx(rows[:, -2].max(),
                                                              rel=1e-12)
    ref = jax_grad_history
    assert rows.shape[0] >= 3 and ref.shape[0] >= 3
    np.testing.assert_allclose(rows[:3, 1:-2], ref[:3, 1:-2], rtol=1e-8)
    np.testing.assert_allclose(rows[:3, -2], ref[:3, -2], rtol=1e-8)


def _grad_optimizer(tmp_path, variables, x0, bounds, n_int_ABC, size, seed,
                    maxiter):
    from itrails_tpu_torch.optim.optimizer import optimizer

    rng = np.random.default_rng(seed)
    fixed = {"n_int_AB": 1, "n_int_ABC": n_int_ABC, "t_1": 0.0024,
             "t_2": 0.0004, "t_upper": 0.00745069, "N_AB": 0.0005,
             "N_ABC": 0.0005, "r": 1.0}
    for name in variables:
        del fixed[name]
    res = optimizer(optim_variables=variables, optim_list=x0, bounds=bounds,
                    fixed_params=fixed,
                    v_lst=[rng.integers(0, 625, size=size).astype(np.int32)],
                    res_name=str(tmp_path / "run"), case=frozenset(["t_1"]),
                    method="L-BFGS-B", maxiter=maxiter, device="cpu",
                    use_grad=True)
    hist = np.loadtxt(tmp_path / "run.optimization_history.csv",
                      delimiter=",", skiprows=1, ndmin=2)
    return res, hist


def test_optimizer_use_grad_smoke(tmp_path):
    res, hist = _grad_optimizer(tmp_path, ["t_1", "N_ABC"], [0.0024, 0.0005],
                                [(1e-4, 0.01), (1e-4, 0.005)], 1, 120, 6, 3)
    assert np.isfinite(res.fun)
    assert hist.shape[0] > 1 and np.isfinite(hist).all()


def test_use_grad_scaled_space_handles_disparate_magnitudes(tmp_path):
    """The gradient path searches in z = x/|x0|, so a time (1e-3) and the
    recombination rate (1) see O(1) steps: the run moves off x0, and the
    history and ``res.x`` are in natural coordinates."""
    res, hist = _grad_optimizer(tmp_path, ["t_1", "r"], [0.0030, 0.5],
                                [(0.00024, 0.024), (0.01, 10.0)], 2, 200, 9, 6)
    assert 0.00024 <= res.x[0] <= 0.024 and 0.01 <= res.x[1] <= 10.0
    np.testing.assert_allclose(hist[0, 1:3], [0.0030, 0.5], rtol=1e-15)
    assert np.abs(hist[:, 1] - 0.0030).max() > 1e-6
    assert np.abs(hist[:, 2] - 0.5).max() > 1e-4


def test_use_grad_refuses_a_nonpositive_start(tmp_path):
    with pytest.raises(ValueError, match="strictly positive"):
        _grad_optimizer(tmp_path, ["t_1", "r"], [0.0030, 0.0],
                        [(0.00024, 0.024), (0.0, 10.0)], 2, 50, 9, 1)


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
