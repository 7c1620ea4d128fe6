"""``itrails-tpu-torch-int-optimize``: introgression-model parameter
inference (reference workflow_int_optimize.py; the JAX package's
``itrails-tpu-int-optimize``).

The same YAML schema as the plain optimize CLI plus ``t_m``, ``N_BC`` and
``m`` (the admixture proportion, not mu-scaled), and the reference's
'_'-separated artifacts: ``<output>_starting_params.yaml``,
``<output>_best_model.yaml``, ``<output>_optimization_history.csv``,
``<output>_optimizer_state.yaml``, and ``hidden_states.csv`` /
``observed_states.csv`` in the output directory.  It runs on the card
unless ``--device cpu`` is given.

Only the value path is ported for this model: Nelder-Mead
(``settings.method: Nelder-Mead``, or ``--no-grad``), and scipy's
finite-difference L-BFGS-B with ``--no-grad`` and ``settings.method:
L-BFGS-B``; each evaluation builds the tables in float64 on the device and
runs kernel K1 on the length buckets and kernel K5 on every block above
262,144 columns, in ``--precision`` (default float64).  The JAX CLI's
default, exact-gradient L-BFGS-B, exits with an error before any build.
"""

from __future__ import annotations

import os

from itrails_tpu_torch import __version__, resolve_device
from itrails_tpu_torch.cli.common import (
    prepare_optimize_setup,
    resolve_io,
    resolve_optim_method,
    standard_parser,
)
from itrails_tpu_torch.config import (
    load_config,
    seed_best_model,
    write_starting_params,
)
from itrails_tpu_torch.data.maf import maf_tokens
from itrails_tpu_torch.optim.optimizer import (
    INT_GRADIENT_NOT_PORTED,
    optimizer,
)


def main(argv=None):
    parser = standard_parser(
        "Introgression optimize workflow using iTRAILS-TPU-torch",
        usage="itrails-tpu-torch-int-optimize <config.yaml> --output "
              "OUTPUT_PATH",
    )
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    parser.add_argument("--maxiter", type=int, default=None,
                        help="Optimizer iteration cap (overrides the "
                             "settings.maxiter config key; default 10000).")
    parser.add_argument("--precision", choices=["float32", "float64"],
                        default="float64",
                        help="Dtype of the value's decode (K1 and K5 on "
                             "the card, their plain versions with --device "
                             "cpu).")
    parser.add_argument("--grad", action="store_true",
                        help="The exact-gradient path (L-BFGS-B), the JAX "
                             "CLI's default: not ported for this model, so "
                             "the CLI exits with an error.")
    parser.add_argument("--no-grad", action="store_true",
                        help="Run the reference's derivative-free algorithm "
                             "(settings.method, default Nelder-Mead).")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device of the model build and the decode "
                             "(default: cuda; there is no automatic CPU "
                             "fallback).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(args.config_file)
    setup = prepare_optimize_setup(config, introgression=True)
    use_grad, method = resolve_optim_method(setup, args.grad, args.no_grad)
    if use_grad:
        raise SystemExit(
            f"itrails-tpu-torch-int-optimize: {INT_GRADIENT_NOT_PORTED}")
    settings = dict(setup["settings"])
    if settings.get("obs_mode", "standard") != "standard":
        raise ValueError("optimize takes only obs_mode 'standard' (4 species)")
    maf_path, user_output, output_dir, output_prefix = resolve_io(config, args)
    settings["output_prefix"] = user_output
    settings["input_maf"] = maf_path
    print(f"Results will be saved to: {output_dir}.")

    write_starting_params(
        os.path.join(output_dir, f"{output_prefix}_starting_params.yaml"),
        setup["descaled_fixed"], setup["descaled_bounds"], settings,
    )
    seed_best_model(
        os.path.join(output_dir, f"{output_prefix}_best_model.yaml"),
        setup["descaled_fixed"], settings,
    )

    print("Reading MAF alignment file.")
    v_lst = maf_tokens(maf_path, settings["species_list"])
    if not v_lst:
        raise ValueError("Error reading MAF alignment file.")
    print(f"{len(v_lst)} alignment blocks, "
          f"{sum(len(v) for v in v_lst)} columns.")

    print(f"Running optimization ({method}) on {device}...")
    optimizer(
        optim_variables=setup["optim_variables"],
        optim_list=setup["optim_list"],
        bounds=setup["bounds_list"],
        fixed_params=setup["fixed_dict"],
        v_lst=v_lst,
        res_name=user_output,
        case=setup["case"],
        method=method,
        maxiter=(args.maxiter if args.maxiter is not None
                 else int(settings.get("maxiter") or 10000)),
        dtype=args.precision,
        device=device,
        introgression=True,
    )
    print("Optimization complete.")


if __name__ == "__main__":
    main()
