"""The port's introgression optimize path end to end on the CPU: the
engine's total against the JAX ``LoglikEngine(..., introgression=True)``
(rtol 1e-10, with and without a long block), the CLI's Nelder-Mead
trajectories against the reference's (``int_traj_1x2.npz`` and
``int_traj_4p.npz``, made by running the original iTRAILS: parameters
rtol 1e-12, loglik rtol 1e-8 / atol 1e-6, the tolerances of
``tests/test_trajectory.py``), its artifacts against the JAX int CLI's,
and what it refuses: the exact-gradient default (not ported for this
model), a 3-species list, a proportional ``t_m``; and ``t_1 < t_m``, which
the optimizer's penalty takes."""

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
MU = 1e-8
# mu-scaled fixed parameters of the two trajectory goldens
# (tests/test_trajectory.py)
TRAJ_FIXED = {"t_2": 0.0004, "t_m": 0.0008, "t_upper": 745069.3855e-8,
              "N_AB": 0.0005, "N_BC": 0.0004, "N_ABC": 0.0005, "r": 1.0}


def _resolved(n_ab, n_abc, **change):
    from itrails_tpu_torch.optim.cases import resolve_times_introgression

    d = dict(TRAJ_FIXED, t_1=2.4e-3, m=0.1, n_int_AB=n_ab, n_int_ABC=n_abc)
    d.update(change)
    return resolve_times_introgression(frozenset(["t_1"]), d)


def _natural(name, value):
    """A mu-scaled value in the config's natural units."""
    if name == "m":
        return float(value)
    return float(value) * MU if name == "r" else float(value) / MU


def _traj_config(golden, fixed_names):
    """The config of a trajectory golden: its start point and bounds
    optimized, the rest of TRAJ_FIXED fixed, in natural units."""
    variables = [str(v) for v in golden["variables"]]
    optimized = {
        name: [_natural(name, golden["x0"][i]),
               *(_natural(name, b) for b in golden["bounds"][i])]
        for i, name in enumerate(variables)}
    fixed = {"mu": MU}
    fixed.update({k: _natural(k, TRAJ_FIXED[k]) for k in fixed_names
                  if k not in optimized})
    return {"fixed_parameters": fixed, "optimized_parameters": optimized,
            "settings": {"input_maf": MAF, "output_prefix": None,
                         "species_list": SPECIES, "n_int_AB": 1,
                         "n_int_ABC": 2, "method": "Nelder-Mead"}}


def _jax_int_config(method="Nelder-Mead"):
    """``tests/test_int_workflows.py``'s optimize config: t_1 and m free."""
    settings = {"input_maf": MAF, "output_prefix": None,
                "species_list": SPECIES, "n_int_AB": 1, "n_int_ABC": 2}
    if method is not None:
        settings["method"] = method
    return {
        "fixed_parameters": {"mu": MU, "t_2": 40000, "t_m": 80000,
                             "t_upper": 745069.3855, "N_AB": 50000,
                             "N_BC": 40000, "N_ABC": 50000, "r": 1e-8},
        "optimized_parameters": {"t_1": [240000, 24000, 2400000],
                                 "m": [0.1, 0.001, 0.99]},
        "settings": settings,
    }


def _run(tmp_path, config, *extra, name="run"):
    from itrails_tpu_torch.cli.int_optimize import main

    cfg = tmp_path / f"{name}.yaml"
    with open(cfg, "w") as f:
        yaml.dump(config, f)
    out_dir = tmp_path / name
    main([str(cfg), "--output", str(out_dir / "t"), "--device", "cpu",
          *extra])
    return out_dir


def _history(run_dir):
    return np.loadtxt(run_dir / "t_optimization_history.csv", delimiter=",",
                      skiprows=1, ndmin=2)


@pytest.mark.parametrize("long_block", [False, True])
def test_int_engine_total_matches_the_jax_engine(long_block):
    """The int engine's value, K1's plain version on the buckets and, with
    a block above the (lowered) threshold, K5's operator path, against the
    JAX engine on the same blocks."""
    from itrails_tpu.optim.optimizer import LoglikEngine as JaxEngine
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    v_lst = maf_tokens(MAF, SPECIES)
    kw = {}
    if long_block:
        rng = np.random.default_rng(7)
        v_lst = v_lst + [rng.integers(0, 625, size=1500).astype(np.int32)]
        kw["long_threshold"] = 1000
    params = _resolved(2, 2, t_1=2.2e-3, m=0.2)
    mine = LoglikEngine(v_lst, 2, 2, device="cpu", introgression=True, **kw)
    assert mine.n_long == (1 if long_block else 0)
    ref = JaxEngine(v_lst, 2, 2, introgression=True, **kw).loglik(params)
    np.testing.assert_allclose(mine.loglik(params), ref, rtol=1e-10)


@pytest.mark.parametrize("long_block", [False, True])
def test_int_engine_plain_total_matches_the_jax_engine(long_block):
    """``loglik_plain``, the total the card's checks hold the engine's
    value to (each route's plain version on the engine's own batches),
    against the JAX engine on the same blocks."""
    from itrails_tpu.optim.optimizer import LoglikEngine as JaxEngine
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    v_lst = maf_tokens(MAF, SPECIES)[:3]
    kw = {}
    if long_block:
        rng = np.random.default_rng(8)
        v_lst = v_lst + [rng.integers(0, 625, size=1200).astype(np.int32)]
        kw["long_threshold"] = 1000
    params = _resolved(1, 2, t_1=2.3e-3, m=0.05)
    mine = LoglikEngine(v_lst, 1, 2, device="cpu", introgression=True, **kw)
    assert mine.n_long == (1 if long_block else 0)
    ref = JaxEngine(v_lst, 1, 2, introgression=True, **kw).loglik(params)
    np.testing.assert_allclose(mine.loglik_plain(params), ref, rtol=1e-10)


@pytest.mark.parametrize("golden_name,fixed_names", [
    ("int_traj_1x2.npz", tuple(TRAJ_FIXED)),
    ("int_traj_4p.npz", ("t_2", "t_upper", "N_AB", "N_ABC", "r")),
])
def test_cli_reproduces_the_reference_trajectory(tmp_path, golden_name,
                                                 fixed_names):
    """Every row of the reference's Nelder-Mead run: the same points and
    logliks, so the same simplex decisions, through the CLI's whole run
    (17 and 22 evaluations).  The CLI orders the variables as the config
    parser does (t_1, N_BC, t_m, m; the JAX CLI's order); the 4-parameter
    golden was made with t_m before N_BC.  Nelder-Mead treats each
    coordinate alone, so the runs are the same up to that permutation: the
    initial simplex's vertices come in another order, every later row in
    the same one."""
    g = load_golden(golden_name)
    run_dir = _run(tmp_path, _traj_config(g, fixed_names), "--maxiter",
                   str(int(g["maxiter"])))
    rows = _history(run_dir)
    n = int(g["n_eval"])
    assert rows.shape[0] == n
    np.testing.assert_array_equal(rows[:, 0], np.arange(n))
    header = next(csv.reader(open(run_dir / "t_optimization_history.csv")))
    perm = [header.index(str(v)) for v in g["variables"]]
    params = rows[:, perm]
    n_simplex = len(perm) + 1
    order = [next(k for k in range(n_simplex)
                  if np.allclose(params[k], want, rtol=1e-12, atol=0))
             for want in g["history_params"][:n_simplex]]
    assert sorted(order) == list(range(n_simplex))
    order += list(range(n_simplex, n))
    np.testing.assert_allclose(params[order], g["history_params"], rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(rows[order, -2], g["history_loglik"],
                               rtol=1e-8, atol=1e-6)
    best = yaml.safe_load(open(run_dir / "t_best_model.yaml"))
    assert best["results"]["log_likelihood"] == pytest.approx(
        rows[:, -2].max(), rel=1e-12)


def test_cli_artifacts_match_the_jax_int_cli(tmp_path):
    """The same artifact names and contents as the JAX int CLI's on the
    same config: the history (all but the time column), the best-model and
    starting-parameter YAMLs, the checkpoint, and ``hidden_states.csv`` /
    ``observed_states.csv`` byte for byte."""
    from itrails_tpu.cli.int_optimize import main as jax_main

    config = _jax_int_config()
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    with open(jax_dir / "c.yaml", "w") as f:
        yaml.dump(config, f)
    jax_main([str(jax_dir / "c.yaml"), "--output", str(jax_dir / "o" / "t"),
              "--maxiter", "2"])
    mine = _run(tmp_path, config, "--maxiter", "2", name="o")
    ref = jax_dir / "o"
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref)) == sorted([
        "t_optimization_history.csv", "t_best_model.yaml",
        "t_starting_params.yaml", "t_optimizer_state.yaml",
        "hidden_states.csv", "observed_states.csv"])
    for name in ("hidden_states.csv", "observed_states.csv"):
        assert (mine / name).read_bytes() == (ref / name).read_bytes()
    hidden = list(csv.reader(open(mine / "hidden_states.csv")))
    assert len(hidden) == 1 + 13 and any(r[1] == "(4, 0, 0)" for r in hidden)
    assert len(list(csv.reader(open(mine / "observed_states.csv")))) == 257
    rows, ref_rows = _history(mine), _history(ref)
    assert rows.shape == ref_rows.shape and rows.shape[0] >= 3
    np.testing.assert_allclose(rows[:, :-2], ref_rows[:, :-2], rtol=1e-12)
    np.testing.assert_allclose(rows[:, -2], ref_rows[:, -2], rtol=1e-10)
    assert (next(csv.reader(open(mine / "t_optimization_history.csv")))
            == ["n_eval", "t_1", "m", "loglik", "time"])
    for name in ("t_best_model.yaml", "t_starting_params.yaml",
                 "t_optimizer_state.yaml"):
        got = yaml.safe_load(open(mine / name))
        want = yaml.safe_load(open(ref / name))
        assert _flat(got) == pytest.approx(_flat(want), rel=1e-10)
    best = yaml.safe_load(open(mine / "t_best_model.yaml"))
    assert 0.001 <= best["optimized_parameters"]["m"] <= 0.99  # not scaled


def _flat(tree, prefix=""):
    """A YAML tree as {path: value}, paths of the output prefix and the
    input path left out (the two runs write to different directories)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k in ("output_prefix", "input_maf"):
                continue
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    else:
        out[prefix] = tree
    return out


def test_cli_no_grad_lbfgsb_matches_the_jax_int_cli(tmp_path):
    """``--no-grad`` with ``settings.method: L-BFGS-B``: scipy's
    finite-difference L-BFGS-B on the value path, its first rows (the start
    point, then one step in each coordinate) equal to the JAX int CLI's."""
    from itrails_tpu.cli.int_optimize import main as jax_main

    config = _jax_int_config("L-BFGS-B")
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    with open(jax_dir / "c.yaml", "w") as f:
        yaml.dump(config, f)
    jax_main([str(jax_dir / "c.yaml"), "--output", str(jax_dir / "o" / "t"),
              "--no-grad", "--maxiter", "1"])
    ref = _history(jax_dir / "o")
    rows = _history(_run(tmp_path, config, "--no-grad", "--maxiter", "1"))
    assert rows.shape[0] >= 3 and ref.shape[0] >= 3
    steps = rows[1:3, 1:-2] != rows[0, 1:-2]
    assert steps.sum(axis=1).tolist() == [1, 1]
    np.testing.assert_allclose(rows[:3, 1:-2], ref[:3, 1:-2], rtol=1e-12)
    np.testing.assert_allclose(rows[:3, -2], ref[:3, -2], rtol=1e-10)


@pytest.mark.parametrize("method,flags", [(None, ()), ("Nelder-Mead", ("--grad",)),
                                          ("L-BFGS-B", ())])
def test_cli_refuses_the_exact_gradient_before_any_build(tmp_path, method,
                                                         flags, monkeypatch):
    """The JAX int CLI's default (no method key), ``--grad`` and an
    explicit L-BFGS-B without ``--no-grad`` ask for exact gradients, which
    are not ported for this model: the CLI exits non-zero, naming the ways
    to the value path, before it builds, tokenizes or writes anything."""
    from itrails_tpu_torch.cli import int_optimize
    from itrails_tpu_torch.optim import optimizer

    def refuse(*args, **kwargs):
        raise AssertionError("the refused run reached the engine")

    monkeypatch.setattr(optimizer, "LoglikEngine", refuse)
    monkeypatch.setattr(int_optimize, "maf_tokens", refuse)
    with pytest.raises(SystemExit) as exc:
        _run(tmp_path, _jax_int_config(method), *flags)
    message = str(exc.value.code)
    assert "--no-grad" in message and "settings.method: Nelder-Mead" in message
    assert "not ported" in message
    assert not (tmp_path / "run").exists()
    with pytest.raises(NotImplementedError, match="not ported"):
        optimizer.optimizer(["t_1"], [0.0024], [(0.0001, 0.01)],
                            {"n_int_AB": 1, "n_int_ABC": 2}, [],
                            str(tmp_path / "x"), frozenset(["t_1"]),
                            device="cpu", use_grad=True, introgression=True)


def test_cli_refuses_a_three_species_list_before_tokenizing(tmp_path,
                                                            monkeypatch):
    from itrails_tpu_torch.data import maf

    def refuse(*args, **kwargs):
        raise AssertionError("a 3-species list reached the tokenizer")

    monkeypatch.setattr(maf, "read_maf", refuse)
    config = _jax_int_config()
    config["settings"]["species_list"] = SPECIES[:3]
    with pytest.raises(ValueError, match="exactly 4 species"):
        _run(tmp_path, config, "--maxiter", "1")


def test_cli_refuses_a_proportional_t_m(tmp_path):
    config = _jax_int_config()
    config["settings"]["proportional"] = True
    config["fixed_parameters"]["t_m"] = 0.25
    with pytest.raises(ValueError, match="Proportional t_m"):
        _run(tmp_path, config, "--maxiter", "1")


def test_cli_requires_the_int_parameters(tmp_path):
    from itrails_tpu.cli.common import prepare_optimize_setup as jax_setup
    from itrails_tpu_torch.cli.common import prepare_optimize_setup

    config = _jax_int_config()
    mine = prepare_optimize_setup(config, introgression=True)
    ref = jax_setup(config, introgression=True)
    for key in ("case", "optim_variables", "optim_list", "bounds_list",
                "fixed_dict", "descaled_fixed", "descaled_bounds"):
        assert mine[key] == ref[key]
    assert mine["fixed_dict"]["N_BC"] == pytest.approx(40000 * MU)
    del config["fixed_parameters"]["N_BC"]
    with pytest.raises(ValueError, match="must be present"):
        prepare_optimize_setup(config, introgression=True)


def test_t1_below_t_m_takes_the_penalty(tmp_path):
    """Where t_1 < t_m the case algebra puts the migration before the
    present (t_B = t_1 - t_m < 0): the engine's value is NaN with no build,
    and Nelder-Mead's objective is the finite penalty, so the search
    steps back instead of carrying a NaN."""
    from itrails_tpu_torch.data.maf import maf_tokens
    from itrails_tpu_torch.optim.optimizer import LoglikEngine, optimizer

    v_lst = maf_tokens(MAF, SPECIES)
    engine = LoglikEngine(v_lst, 1, 2, device="cpu", introgression=True)
    assert np.isnan(engine.loglik(_resolved(1, 2, t_1=6e-4)))
    assert engine.seconds["build"] == 0.0
    assert np.isfinite(engine.loglik(_resolved(1, 2, t_1=8e-4)))
    fixed = dict(TRAJ_FIXED, n_int_AB=1, n_int_ABC=2)
    res = optimizer(["t_1", "m"], [6e-4, 0.1], [(1e-4, 0.01), (0.001, 0.99)],
                    fixed, v_lst, str(tmp_path / "p"), frozenset(["t_1"]),
                    maxiter=1, device="cpu", introgression=True)
    rows = np.loadtxt(tmp_path / "p_optimization_history.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    assert np.isnan(rows[0, -2])
    assert res.fun == 1e12
    np.testing.assert_array_equal(np.isnan(rows[:, -2]), rows[:, 1] < 8e-4)
