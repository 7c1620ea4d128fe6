"""The port stands alone: it imports neither JAX, nor the JAX package, nor
pandas (which the card's machine lacks), and it never moves work to the CPU
unless the caller asks for it."""

import os
import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (both frameworks share the test process)
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "itrails_tpu_torch"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card behaviour does not apply")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run `pytest -m gpu tests/test_torch_*.py` "
                    "on the H100")
    return torch.device("cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import itrails_tpu_torch, itrails_tpu_torch.cli.optimize\n"
        "import itrails_tpu_torch.convert, itrails_tpu_torch.data.simulate\n"
        "import itrails_tpu_torch.hmm.grad, itrails_tpu_torch.hmm.cuda_grad\n"
        "import itrails_tpu_torch.cli.viterbi, itrails_tpu_torch.cli.decode\n"
        "import itrails_tpu_torch.hmm.cuda_viterbi\n"
        "import itrails_tpu_torch.cli.posterior\n"
        "import itrails_tpu_torch.hmm.cuda_posterior\n"
        "import itrails_tpu_torch.hmm.longseq, itrails_tpu_torch.hmm.cuda_longseq\n"
        "import itrails_tpu_torch.hmm.cuda_maxplus\n"
        "import itrails_tpu_torch.cli.int_optimize\n"
        "import itrails_tpu_torch.introgression.builder\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'itrails_tpu', 'pandas'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, check=True)
    assert out.stdout.strip() == ""


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import jax|from jax|from itrails_tpu[. ]|import itrails_tpu[. ]|"
        r"import itrails_tpu$|import pandas|from pandas)", re.M)
    sources = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("entry", ["engine", "builder", "cli", "grad",
                                   "convert", "viterbi", "posterior",
                                   "int_engine", "int_builder", "int_cli"])
def test_entry_points_refuse_cpu_without_being_asked(entry, no_card, tmp_path):
    if entry == "engine":
        from itrails_tpu_torch.optim.optimizer import LoglikEngine

        def call():
            LoglikEngine([np.zeros(10, np.int32)], 1, 2)
    elif entry == "builder":
        from itrails_tpu_torch.core.model import build_model_fn

        def call():
            build_model_fn(1, 2)
    elif entry == "cli":
        from itrails_tpu_torch.cli.optimize import main

        def call():
            main([str(tmp_path / "missing.yaml"), "--no-grad"])
    elif entry == "grad":
        from itrails_tpu_torch.cli.optimize import main

        def call():
            main([str(tmp_path / "missing.yaml")])  # the default: gradients
    elif entry == "viterbi":
        from itrails_tpu_torch.cli.viterbi import main

        def call():
            main([str(tmp_path / "missing.yaml")])
    elif entry == "posterior":
        from itrails_tpu_torch.cli.posterior import main

        def call():
            main([str(tmp_path / "missing.yaml")])
    elif entry == "int_engine":
        from itrails_tpu_torch.optim.optimizer import LoglikEngine

        def call():
            LoglikEngine([np.zeros(10, np.int32)], 1, 2, introgression=True)
    elif entry == "int_builder":
        from itrails_tpu_torch.introgression.builder import (
            build_model_introgression_fn,
        )

        def call():
            build_model_introgression_fn(1, 2)
    elif entry == "int_cli":
        from itrails_tpu_torch.cli.int_optimize import main

        def call():
            main([str(tmp_path / "missing.yaml"), "--no-grad"])
    else:
        from itrails_tpu_torch.convert import model_from_numpy

        def call():
            model_from_numpy(np.eye(2), np.ones((2, 625)), np.ones(2) / 2,
                             device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


@pytest.mark.parametrize("builder", ["joint", "emission", "cutpoints_ab",
                                     "cutpoints_abc", "abc_stage",
                                     "int_joint", "int_emission"])
def test_builders_take_no_default_device(builder):
    """The builders under build_model_fn name their device: none of them
    runs on the CPU because the caller left the device out."""
    from itrails_tpu_torch.core import ctmc, cutpoints, emissions
    from itrails_tpu_torch.core.schedule import build_plan
    from itrails_tpu_torch.introgression import model

    calls = {
        "joint": lambda: ctmc.JointMatrixFn(build_plan(1, 2)),
        "emission": lambda: emissions.EmissionMatrixFn(1, 2),
        "abc_stage": lambda: ctmc.AbcStage(build_plan(1, 2)),
        "int_joint": lambda: model.IntJointMatrixFn(
            build_plan(1, 2, introgression=True)),
        "int_emission": lambda: emissions.IntrogressionEmissionFn(1, 2),
        "cutpoints_ab": lambda: cutpoints.cutpoints_ab(2, 0.8, 1.3),
        "cutpoints_abc": lambda: cutpoints.cutpoints_abc(2, 0.7),
    }
    with pytest.raises(TypeError, match="device"):
        calls[builder]()


@pytest.mark.gpu
def test_k1_wrapper_raises_on_inputs_it_does_not_take(cuda_device):
    from itrails_tpu_torch.hmm import cuda_fwd

    m = 27
    a = torch.full((m, m), 1.0 / m, device=cuda_device)
    bfull = torch.full((m, 625), 0.01, device=cuda_device)
    pi = torch.full((m,), 1.0 / m, device=cuda_device)
    tok = torch.zeros((2, 5), dtype=torch.int32, device=cuda_device)
    before = cuda_fwd.forward_fused.launches
    with pytest.raises(ValueError, match="float32"):
        cuda_fwd.forward_fused(a.double(), bfull, pi, tok)
    with pytest.raises(ValueError, match="int32"):
        cuda_fwd.forward_fused(a, bfull, pi, tok.long())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fwd.forward_fused(a.T, bfull, pi, tok)
    assert cuda_fwd.forward_fused.launches == before
    cuda_fwd.forward_fused(a, bfull, pi, tok)
    assert cuda_fwd.forward_fused.launches == before + 1


@pytest.mark.gpu
def test_k2_wrapper_raises_on_inputs_it_does_not_take(cuda_device):
    from itrails_tpu_torch.hmm import cuda_grad

    m = 27
    a = torch.full((m, m), 1.0 / m, device=cuda_device)
    bfull = torch.full((m, 625), 0.01, device=cuda_device)
    pi = torch.full((m,), 1.0 / m, device=cuda_device)
    tok = torch.zeros((2, 5), dtype=torch.int32, device=cuda_device)
    before = cuda_grad.loglik_and_grads_fused.calls
    with pytest.raises(ValueError, match="float32"):
        cuda_grad.loglik_and_grads_fused(a.double(), bfull, pi, tok)
    with pytest.raises(ValueError, match="int32"):
        cuda_grad.loglik_and_grads_fused(a, bfull, pi, tok.long())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_grad.loglik_and_grads_fused(a.T, bfull, pi, tok)
    with pytest.raises(ValueError, match="states"):
        big = torch.full((161, 161), 1.0 / 161, device=cuda_device)
        cuda_grad.loglik_and_grads_fused(
            big, torch.full((161, 625), 0.01, device=cuda_device),
            torch.full((161,), 1.0 / 161, device=cuda_device), tok)
    with pytest.raises(ValueError, match="float32"):
        cuda_grad.loglik_and_grads_fused(a, bfull, pi.cpu(), tok)
    assert cuda_grad.loglik_and_grads_fused.calls == before
    cuda_grad.loglik_and_grads_fused(a, bfull, pi, tok)
    assert cuda_grad.loglik_and_grads_fused.calls == before + 1


@pytest.mark.gpu
def test_k3_wrapper_raises_on_inputs_it_does_not_take(cuda_device):
    from itrails_tpu_torch.hmm import cuda_viterbi

    m = 27
    a = torch.full((m, m), 1.0 / m, device=cuda_device)
    bfull = torch.full((m, 625), 0.01, device=cuda_device)
    pi = torch.full((m,), 1.0 / m, device=cuda_device)
    tok = torch.zeros((2, 5), dtype=torch.int32, device=cuda_device)
    launches = (lambda: cuda_viterbi.viterbi_forward.launches
                + cuda_viterbi.viterbi_backtrack.launches)
    before = launches()
    with pytest.raises(ValueError, match="float32"):
        cuda_viterbi.viterbi_fused(a.double(), bfull, pi, tok)
    with pytest.raises(ValueError, match="int32"):
        cuda_viterbi.viterbi_fused(a, bfull, pi, tok.long())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_viterbi.viterbi_fused(a.T, bfull, pi, tok)
    with pytest.raises(ValueError, match="states"):
        big = torch.full((256, 256), 1.0 / 256, device=cuda_device)
        cuda_viterbi.viterbi_fused(
            big, torch.full((256, 625), 0.01, device=cuda_device),
            torch.full((256,), 1.0 / 256, device=cuda_device), tok)
    with pytest.raises(ValueError, match="omega0"):
        cuda_viterbi.viterbi_fused(a, bfull, pi, tok,
                                   omega0=torch.zeros((2, m), device="cpu"))
    with pytest.raises(ValueError, match="last"):
        cuda_viterbi.viterbi_fused(a, bfull, pi, tok, last=torch.zeros(
            2, dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError, match="last must lie"):
        cuda_viterbi.viterbi_fused(a, bfull, pi, tok, last=torch.full(
            (2,), m, dtype=torch.int32, device=cuda_device))
    assert launches() == before
    cuda_viterbi.viterbi_fused(a, bfull, pi, tok)
    assert launches() == before + 2


@pytest.mark.gpu
def test_k4_wrapper_raises_on_inputs_it_does_not_take(cuda_device):
    from itrails_tpu_torch.hmm import cuda_posterior

    m = 27
    a = torch.full((m, m), 1.0 / m, device=cuda_device)
    bfull = torch.full((m, 625), 0.01, device=cuda_device)
    pi = torch.full((m,), 1.0 / m, device=cuda_device)
    tok = torch.zeros((2, 5), dtype=torch.int32, device=cuda_device)
    before = cuda_posterior.posterior_fused.launches
    with pytest.raises(ValueError, match="float32"):
        cuda_posterior.posterior_fused(a.double(), bfull, pi, tok)
    with pytest.raises(ValueError, match="int32"):
        cuda_posterior.posterior_fused(a, bfull, pi, tok.long())
    with pytest.raises(ValueError, match="contiguous"):
        cuda_posterior.posterior_fused(a.T, bfull, pi, tok)
    with pytest.raises(ValueError, match="states"):
        big = torch.full((225, 225), 1.0 / 225, device=cuda_device)
        cuda_posterior.posterior_fused(
            big, torch.full((225, 625), 0.01, device=cuda_device),
            torch.full((225,), 1.0 / 225, device=cuda_device), tok)
    with pytest.raises(ValueError, match="alpha0"):
        cuda_posterior.posterior_fused(a, bfull, pi, tok,
                                       alpha0=torch.zeros((2, m), device="cpu"))
    with pytest.raises(ValueError, match="beta_exit"):
        cuda_posterior.beta_sweep(a, bfull, tok,
                                  beta_exit=torch.zeros((3, m), device=cuda_device))
    with pytest.raises(ValueError, match="float32"):
        cuda_posterior.beta_sweep(a, bfull.double(), tok)
    assert cuda_posterior.posterior_fused.launches == before
    cuda_posterior.posterior_fused(a, bfull, pi, tok)
    cuda_posterior.beta_sweep(a, bfull, tok)
    assert cuda_posterior.posterior_fused.launches == before + 3
