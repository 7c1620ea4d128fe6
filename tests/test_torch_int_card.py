"""The introgression slice on the card (``pytest -m gpu``; every test here
skips without one): the f64 int build on the card against the CPU build
(rtol 1e-12; b with an absolute floor of 1e-15) at 3x3 (M = 36) and 7x7
(M = 182); one int evaluation's
value through K1 and K5 against their f64 plain versions on the card (rtol
1e-10); and optimize runs that repeat bit for bit, the plain CLI's
default (exact-gradient L-BFGS-B) and the int CLI's Nelder-Mead, each run
twice in processes of their own.  This file imports no JAX: the card's
references are the port's plain versions and its CPU build."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
SPECIES = ["hg38", "panTro5", "gorGor5", "ponAbe2"]
# the goldens' parameters (tests/test_introgression.py), mu-scaled
INT_PARAMS = dict(
    t_A=0.0024, t_B=0.0016, t_C=0.0016, t_2=0.0004, t_upper=0.00745069,
    t_out=0.009312, t_m=0.0008, N_AB=0.0005, N_BC=0.0004, N_ABC=0.0005,
    r=1.0, m=0.1,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    return torch.device("cuda")


def _simulated_blocks(dev, n_ab, n_abc, n_short, length, n_joined, seed):
    """Blocks simulated from the int model at INT_PARAMS: ``n_short`` of
    ``length`` columns and one of ``n_joined * length``."""
    from itrails_tpu_torch.data.simulate import simulate_token_batch
    from itrails_tpu_torch.introgression.builder import (
        build_model_introgression,
    )

    model = build_model_introgression(n_int_AB=n_ab, n_int_ABC=n_abc,
                                      device=dev, **INT_PARAMS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sim = simulate_token_batch(model.a, model.b, model.pi, n_short + n_joined,
                               length, gen).cpu().numpy()
    return list(sim[:n_short]) + [sim[n_short:].reshape(-1)]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [3, 7])
def test_int_build_on_the_card_matches_the_cpu(cuda_device, n):
    from itrails_tpu_torch.introgression.builder import (
        build_model_introgression,
    )

    card = build_model_introgression(n_int_AB=n, n_int_ABC=n,
                                     device=cuda_device, **INT_PARAMS)
    cpu = build_model_introgression(n_int_AB=n, n_int_ABC=n, device="cpu",
                                    **INT_PARAMS)
    assert card.a.shape == (2 * n * n + 3 * n * (n + 1) // 2,) * 2
    for name in ("a", "pi"):
        np.testing.assert_allclose(getattr(card, name).cpu().numpy(),
                                   getattr(cpu, name).numpy(), rtol=1e-12,
                                   atol=0)
    # b's closed-form emission integrals cancel: an ulp of difference in
    # the card's and the CPU's exp moves its smallest entries (~1e-12) by
    # up to ~1e-16 absolute, so b is held with the absolute floor of the
    # builders' JAX parity tests (atol 1e-15)
    np.testing.assert_allclose(card.b.cpu().numpy(), cpu.b.numpy(),
                               rtol=1e-12, atol=1e-15)


@pytest.mark.gpu
def test_int_value_runs_k1_and_k5_and_matches_their_plain_versions(
        cuda_device):
    """One int evaluation at 3x3 on blocks simulated from the int model:
    K1 once a bucket, K5 once for the long block, and the value within
    rtol 1e-10 of the f64 plain versions on the card."""
    from itrails_tpu_torch.hmm import cuda_fwd, cuda_longseq
    from itrails_tpu_torch.optim.optimizer import LoglikEngine

    blocks = _simulated_blocks(cuda_device, 3, 3, 20, 2000, 20, seed=3)
    engine = LoglikEngine(blocks, 3, 3, device=cuda_device,
                          long_threshold=30_000, introgression=True)
    assert engine.n_long == 1 and engine.n_buckets >= 1
    cuda_fwd.forward_fused.launches = 0
    cuda_longseq.chunk_operators_fused.launches = 0
    value = engine.loglik(INT_PARAMS)
    assert cuda_fwd.forward_fused.launches == engine.n_buckets
    assert cuda_longseq.chunk_operators_fused.launches == 1

    cuda_fwd.forward_fused.launches = 0
    ref = engine.loglik_plain(INT_PARAMS)
    assert cuda_fwd.forward_fused.launches == 0
    assert abs(value - ref) <= 1e-10 * abs(ref)


def _cli_twice(tmp_path, module, config, extra):
    """Runs ``module`` twice on ``config``, each in a fresh process, and
    returns both histories without their time column."""
    cfg = tmp_path / "config.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    out = []
    for k in range(2):
        prefix = tmp_path / f"run{k}" / "sim"
        subprocess.run([sys.executable, "-m", module, str(cfg), "--output",
                        str(prefix), *extra], check=True, cwd=REPO, env=env,
                       timeout=900)
        hist = next(prefix.parent.glob("*optimization_history.csv"))
        rows = [line.rsplit(",", 1)[0] for line in hist.read_text().split()]
        out.append(rows)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["plain default", "int Nelder-Mead"])
def test_optimize_runs_repeat_bit_for_bit_on_the_card(cuda_device, tmp_path,
                                                      family):
    """Two runs of one optimize CLI on one MAF, each in a process of its
    own, write the same history, every digit of every parameter and loglik
    (the time column aside): the plain family on its default (the build's
    backward through autograd, K2 on the buckets and the long block's
    chunk route), the int family on Nelder-Mead (K1 and K5)."""
    from itrails_tpu_torch.data.simulate import write_maf

    maf = tmp_path / "sim.maf"
    int_family = family.startswith("int")
    if int_family:
        blocks = _simulated_blocks(cuda_device, 3, 3, 30, 2000, 20, seed=5)
    else:
        from itrails_tpu_torch.core.model import build_model
        from itrails_tpu_torch.data.simulate import simulate_token_batch
        from itrails_tpu_torch.optim.cases import resolve_times

        d = resolve_times(frozenset(["t_1"]), dict(
            t_1=2.4e-3, t_2=4e-4, t_upper=7.45069e-3, N_AB=5e-4, N_ABC=5e-4,
            r=1.0, n_int_AB=3, n_int_ABC=3))
        model = build_model(n_int_AB=3, n_int_ABC=3, device=cuda_device,
                            **{k: d[k] for k in ("t_A", "t_B", "t_C", "t_2",
                                                 "t_upper", "t_out", "N_AB",
                                                 "N_ABC", "r")})
        gen = torch.Generator(device=cuda_device).manual_seed(5)
        sim = simulate_token_batch(model.a, model.b, model.pi, 30 + 140,
                                   2000, gen).cpu().numpy()
        # one block above 262,144 columns: the default's chunk route
        blocks = list(sim[:30]) + [sim[30:].reshape(-1)]
    write_maf(str(maf), blocks, SPECIES)
    optimized = {"N_AB": [50000, 5000, 500000], "N_ABC": [50000, 5000, 500000],
                 "t_1": [240000, 24000, 2400000], "t_2": [40000, 4000, 400000],
                 "t_upper": [745069.3855, 74506.9385, 7450693.8556],
                 "r": [1e-8, 1e-9, 1e-7]}
    settings = {"input_maf": str(maf), "species_list": SPECIES,
                "n_int_AB": 3, "n_int_ABC": 3}
    if int_family:
        optimized.update({"N_BC": [40000, 4000, 400000],
                          "t_m": [80000, 8000, 800000],
                          "m": [0.1, 0.001, 0.99]})
        settings["method"] = "Nelder-Mead"
    config = {"fixed_parameters": {"mu": 1e-8},
              "optimized_parameters": optimized, "settings": settings}
    module = ("itrails_tpu_torch.cli.int_optimize" if int_family
              else "itrails_tpu_torch.cli.optimize")
    first, second = _cli_twice(tmp_path, module, config, ["--maxiter", "3"])
    assert len(first) > 4
    assert first == second
