"""The port's decode CLIs (``itrails_tpu_torch.cli.viterbi`` and
``itrails_tpu_torch.cli.posterior``, ``--device cpu``) against the JAX
package's (``itrails_tpu.cli.viterbi``, ``itrails_tpu.cli.posterior``) on
goldens/synthetic.maf: ``viterbi.csv`` and ``hidden_states.csv`` byte for
byte, ``posterior.csv`` column for column, and the pieces under them
(manual cutpoints in the builder, reference coordinates, the override
merge)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.conftest import GOLDENS
from tests.test_workflows import _decode_config

torch.set_num_threads(1)

MAF = os.path.join(GOLDENS, "synthetic.maf")
SPECIES = ["hg38", "panTro5", "gorGor5", "ponAbe2"]
FLAGS = ["--input", MAF, "--mu", "1e-8", "--t1", "240000", "--t2", "40000",
         "--t_upper", "745069.3855", "--N_AB", "50000", "--N_ABC", "50000",
         "--r", "1e-8", "--n_int_AB", "1", "--n_int_ABC", "2",
         "--species_list", *SPECIES]
CUTPOINTS = {"cutpoints_AB": [240000.0, 270000.0],
             "cutpoints_ABC": [280000.0, 330000.0]}


def _write_config(path, **change):
    cfg = _decode_config()
    cfg["settings"].update(change.pop("settings", {}))
    cfg["fixed_parameters"].update(change.pop("fixed", {}))
    with open(path, "w") as f:
        yaml.dump(cfg, f)
    return str(path)


def _case_args(case, tmp_path):
    """The arguments of one CLI run (without --output)."""
    if case == "config":
        return [_write_config(tmp_path / "c.yaml")]
    if case == "flags":
        return list(FLAGS)
    if case == "override":
        path = _write_config(tmp_path / "c.yaml", fixed={"N_AB": 99999999})
        return ["--config-file", path, "--N_AB", "50000"]
    if case == "reference":
        return [_write_config(tmp_path / "c.yaml",
                              settings={"reference": "hg38"})]
    if case == "cutpoints":
        return [_write_config(tmp_path / "c.yaml", settings=CUTPOINTS)]
    return [_write_config(tmp_path / "c.yaml")]  # long_block


def _run_both(args, tmp_path):
    from itrails_tpu.cli.viterbi import main as jax_main
    from itrails_tpu_torch.cli.viterbi import main as port_main

    jax_main([*args, "--output", str(tmp_path / "jax" / "run")])
    port_main([*args, "--output", str(tmp_path / "port" / "run"), "--device",
               "cpu"])
    return [tuple((tmp_path / side / f"run.{name}.csv").read_bytes()
                  for side in ("jax", "port"))
            for name in ("viterbi", "hidden_states")]


@pytest.mark.parametrize("case", ["config", "flags", "override", "reference",
                                  "cutpoints", "long_block", "long_block_chunks"])
def test_cli_matches_the_jax_cli(case, tmp_path, monkeypatch):
    if case.startswith("long_block"):
        # both complete blocks of the MAF (60 and 45 columns) above the
        # threshold, on both sides: the JAX package's longseq.viterbi_long,
        # the port's (one chunk a block, or chunks of 8 columns)
        from itrails_tpu.cli import decode as jax_decode
        from itrails_tpu_torch.cli import decode as port_decode
        from itrails_tpu_torch.hmm import longseq

        monkeypatch.setattr(jax_decode, "LONG_BLOCK_THRESHOLD", 36)
        monkeypatch.setattr(port_decode, "LONG_BLOCK_THRESHOLD", 36)
        if case == "long_block_chunks":
            monkeypatch.setattr(longseq, "ROUTE_CHUNK", 8)
    (vj, vp), (hj, hp) = _run_both(_case_args(case, tmp_path), tmp_path)
    assert vp == vj and len(vj.splitlines()) >= 3  # header + both blocks
    assert hp == hj and len(hj.splitlines()) == 1 + 11
    if case == "reference":  # positions projected to hg38's (from 1000)
        starts = [int(r.split(b",")[1]) for r in vp.splitlines()[1:]
                  if r.startswith(b"0,")]
        assert min(starts) >= 1000
    if case == "cutpoints":
        assert b"330000.00" in hp


def _read_posterior_csv(path):
    """(header line, block and position columns (n, 2) int64, probabilities
    (n, M) float64) of a posterior CSV."""
    with open(path, "rb") as f:
        header = f.readline()
    table = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return header, table[:, :2].astype(np.int64), table[:, 2:]


@pytest.mark.parametrize("case", ["config", "flags", "override", "reference",
                                  "cutpoints", "long_block"])
def test_posterior_cli_matches_the_jax_cli(case, tmp_path, monkeypatch):
    from itrails_tpu.cli import decode as jax_decode
    from itrails_tpu.cli.posterior import main as jax_main
    from itrails_tpu_torch.cli import decode as port_decode
    from itrails_tpu_torch.cli.posterior import main as port_main

    if case == "long_block":  # both blocks one-window batches in the port
        monkeypatch.setattr(jax_decode, "LONG_BLOCK_THRESHOLD", 36)
        monkeypatch.setattr(port_decode, "LONG_BLOCK_THRESHOLD", 36)
    args = _case_args(case, tmp_path)
    jax_main([*args, "--output", str(tmp_path / "jax" / "run")])
    port_main([*args, "--output", str(tmp_path / "port" / "run"), "--device",
               "cpu"])
    hj, hp = ((tmp_path / side / "run.hidden_states.csv").read_bytes()
              for side in ("jax", "port"))
    assert hp == hj and len(hj.splitlines()) == 1 + 11
    (head_j, pos_j, prob_j), (head_p, pos_p, prob_p) = (
        _read_posterior_csv(tmp_path / side / "run.posterior.csv")
        for side in ("jax", "port"))
    assert head_p == head_j and head_j.endswith(b"prob_state_10\r\n")
    np.testing.assert_array_equal(pos_p, pos_j)
    assert len(pos_j) == 105  # one row per column of both blocks
    np.testing.assert_allclose(prob_p, prob_j, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(prob_p.sum(axis=1), 1.0, rtol=1e-12)
    if case == "reference":  # hg38's coordinates, gaps as -9
        assert pos_p[:, 1].max() >= 1000 and (pos_p[:, 1] >= -9).all()
    if case == "cutpoints":
        assert b"330000.00" in hp


def test_hidden_states_of_the_two_clis(tmp_path):
    """The Viterbi CLI annotates every state's first interval with the ABC
    cutpoints, as it did before the posterior CLI came; the posterior CLI
    annotates the V0 states' with the AB cutpoints; each matches its JAX
    counterpart byte for byte."""
    from itrails_tpu.cli.decode import write_hidden_states as jax_write
    from itrails_tpu.cli.common import prepare_decode_setup as jax_setup
    from itrails_tpu_torch.cli import decode
    from itrails_tpu_torch.cli.common import prepare_decode_setup

    cfg = _decode_config()
    cfg["settings"].update(CUTPOINTS)
    setup = prepare_decode_setup(cfg)
    model, _, _, _ = decode.build(setup, "float64", "cpu")
    lines = {}
    for posterior in (False, True):
        port = tmp_path / f"port{posterior}.hidden_states.csv"
        ref = tmp_path / f"jax{posterior}.hidden_states.csv"
        decode.write_hidden_states(str(port), model, setup,
                                   first_interval_from_ab=posterior)
        jax_write(str(ref), model, jax_setup(yaml.safe_load(yaml.dump(cfg))),
                  first_interval_from_ab=posterior)
        assert port.read_bytes() == ref.read_bytes()
        lines[posterior] = port.read_text().splitlines()
    changed = [i for i, (v, p) in enumerate(zip(lines[False], lines[True]))
               if v != p]
    v0 = [i + 1 for i, s in enumerate(model.hidden_states) if s[0] == 0]
    assert changed == v0 and v0
    assert all("240000.00-270000.00" in lines[True][i] for i in v0[:1])


def test_cli_without_arguments_exits():
    from itrails_tpu_torch.cli.viterbi import main

    with pytest.raises(SystemExit):
        main([])


def test_cli_refuses_new_method_mode(tmp_path):
    from itrails_tpu_torch.cli.viterbi import main

    path = _write_config(tmp_path / "c.yaml", settings={"obs_mode": "new-method"})
    with pytest.raises(ValueError, match="obs_mode"):
        main([path, "--output", str(tmp_path / "o" / "run"), "--device", "cpu"])


def test_posterior_cli_refuses_new_method_mode(tmp_path):
    from itrails_tpu_torch.cli.posterior import main

    path = _write_config(tmp_path / "c.yaml", settings={"obs_mode": "new-method"})
    with pytest.raises(ValueError, match="obs_mode"):
        main([path, "--output", str(tmp_path / "o" / "run"), "--device", "cpu"])


def test_cli_float32_matches_float64_on_the_synthetic_maf(tmp_path):
    from itrails_tpu_torch.cli.viterbi import main

    path = _write_config(tmp_path / "c.yaml")
    for precision in ("float64", "float32"):
        main([path, "--output", str(tmp_path / precision / "run"), "--device",
              "cpu", "--precision", precision])
    assert ((tmp_path / "float32" / "run.viterbi.csv").read_bytes()
            == (tmp_path / "float64" / "run.viterbi.csv").read_bytes())


def test_build_model_with_manual_cutpoints_matches_jax():
    from itrails_tpu.cli.common import prepare_decode_setup as jax_setup
    from itrails_tpu.core.model import build_model as jax_build_model
    from itrails_tpu_torch.cli.common import prepare_decode_setup
    from itrails_tpu_torch.core.model import build_model

    cfg = _decode_config()
    cfg["settings"].update(CUTPOINTS)
    setup = prepare_decode_setup(cfg)
    ref_setup = jax_setup(yaml.safe_load(yaml.dump(cfg)))
    for key in ("norm_cut_ab", "norm_cut_abc", "abs_cut_ab", "abs_cut_abc"):
        np.testing.assert_allclose(setup[key], ref_setup[key], rtol=1e-12)
    assert setup["params"].keys() == ref_setup["params"].keys()
    for k, v in ref_setup["params"].items():
        assert setup["params"][k] == pytest.approx(v, rel=1e-12), k

    d = setup["params"]
    args = [d[k] for k in ("t_A", "t_B", "t_C", "t_2", "t_upper", "t_out",
                           "N_AB", "N_ABC", "r", "n_int_AB", "n_int_ABC")]
    cuts = dict(cut_AB=setup["norm_cut_ab"], cut_ABC=setup["norm_cut_abc"])
    ref = jax_build_model(*args, dtype=jnp.float64, **cuts)
    mine = build_model(*args, device="cpu", **cuts)
    default = build_model(*args, device="cpu")
    for name in ("a", "b", "pi", "cut_AB", "cut_ABC"):
        np.testing.assert_allclose(getattr(mine, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-9,
                                   atol=1e-300, err_msg=name)
    np.testing.assert_allclose(mine.cut_AB.numpy(), setup["norm_cut_ab"],
                               rtol=1e-15)
    assert not torch.equal(mine.a, default.a)  # the cutpoints took effect


def test_reference_coordinates_match_jax():
    from itrails_tpu.data.maf import maf_reference_coordinates as jax_coords
    from itrails_tpu_torch.data.maf import maf_reference_coordinates

    for ref in ("hg38", "gorGor5", "absent"):
        got = maf_reference_coordinates(MAF, SPECIES, ref)
        want = jax_coords(MAF, SPECIES, ref)
        assert len(got) == len(want) == 2  # the blocks with all 4 species
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == np.int64
    assert all((c == -9).all() for c in maf_reference_coordinates(
        MAF, SPECIES, "absent"))
    with pytest.raises(ValueError, match="4 species"):
        maf_reference_coordinates(MAF, SPECIES[:3], "hg38")


@pytest.mark.parametrize("seed", range(6))
def test_segment_rows_match_jax(seed):
    """The run-length writer's rows, with and without reference
    coordinates: gap runs inside, at the start and at the end of a block,
    and state changes at gap columns, against the JAX package's."""
    from itrails_tpu.cli.decode import _rle_rows as jax_rows
    from itrails_tpu_torch.cli.decode import _rle_rows

    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    res = np.repeat(rng.integers(0, 5, n), rng.integers(1, 9, n))[:n]
    res = res.astype(np.int32)
    c = np.arange(1000, 1000 + n, dtype=np.int64)
    gaps = rng.random(n) < [0.05, 0.2, 0.5, 0.9, 0.3, 0.0][seed]
    gaps[: int(rng.integers(0, 4))] = True
    if seed % 2:
        gaps[-int(rng.integers(1, 5)):] = True
    c[gaps] = -9
    for coords in (None, c):
        got = _rle_rows(3, res, coords)
        want = jax_rows(3, res, coords)
        assert [list(map(int, r)) for r in got] == [list(map(int, r)) for r in want]


def test_merge_decode_overrides_validation():
    from itrails_tpu_torch.cli.common import decode_parser, merge_decode_overrides

    parser = decode_parser("t")
    args = parser.parse_args(["--t1", "1"])
    with pytest.raises(ValueError, match="mu must be specified"):
        merge_decode_overrides(args)
    args = parser.parse_args(["--mu", "1e-8", "--cutpoints_AB", "0", "1", "2",
                              "--cutpoints_ABC", "3", "4"])
    cfg = merge_decode_overrides(args)
    assert cfg["settings"]["n_int_AB"] == 2
    assert cfg["settings"]["n_int_ABC"] == 2
    args = parser.parse_args(["--mu", "1e-8", "--n_int_ABC", "2"])
    with pytest.raises(ValueError, match="n_int_AB must be specified"):
        merge_decode_overrides(args)
    assert parser.parse_args([]).device == "cuda"
