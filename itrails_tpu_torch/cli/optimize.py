"""``itrails-tpu-torch-optimize``: maximum-likelihood parameter inference.

CLI-compatible with the reference's ``itrails-optimize``
(workflow_optimize.py) and with ``itrails-tpu-optimize``: same YAML schema,
same artifacts (.starting_params.yaml, .best_model.yaml checkpoint,
.optimization_history.csv, .optimizer_state.yaml), same parameter-case
rules.  The default, as in ``itrails-tpu-optimize``, is L-BFGS-B with
exact gradients (kernel K2 on the card); ``--no-grad`` or
``settings.method: Nelder-Mead`` runs the reference's derivative-free
algorithm.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os

import yaml

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
from itrails_tpu_torch.optim.optimizer import optimizer


def main(argv=None):
    parser = standard_parser(
        "Optimize workflow using iTRAILS-TPU-torch",
        usage="itrails-tpu-torch-optimize <config.yaml> --output OUTPUT_PATH",
    )
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    parser.add_argument("--maxiter", type=int, default=None,
                        help="Optimizer iteration cap (overrides the "
                             "settings.maxiter config key; default 10000).")
    parser.add_argument("--precision", choices=["float32", "float64"],
                        default="float64",
                        help="Dtype of the decode with --device cpu. On "
                             "the card K1 and K2 always compute in float32 "
                             "and this flag has no effect.")
    parser.add_argument("--grad", action="store_true",
                        help="Force the exact-gradient path (L-BFGS-B on "
                             "the gradient of the decode, kernel K2, "
                             "carried back through the model build by "
                             "autograd).  This is already the default "
                             "unless the config sets settings.method: "
                             "Nelder-Mead explicitly.")
    parser.add_argument("--no-grad", action="store_true",
                        help="Run the reference's derivative-free algorithm "
                             "(settings.method, default Nelder-Mead).")
    parser.add_argument("--resume", action="store_true",
                        help="Continue a previous run: restart from the "
                             "last iterate in <output>.optimizer_state.yaml "
                             "(else the best parameters in "
                             "<output>.best_model.yaml) and append to the "
                             "optimization history.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="Device of the model build and the decode "
                             "(default: cuda; there is no automatic CPU "
                             "fallback).")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    config = load_config(args.config_file)
    maf_path, user_output, output_dir, output_prefix = resolve_io(config, args)
    setup = prepare_optimize_setup(config)
    use_grad, method = resolve_optim_method(setup, args.grad, args.no_grad)
    settings = dict(setup["settings"])
    if settings.get("obs_mode", "standard") != "standard":
        raise ValueError("optimize takes only obs_mode 'standard' (4 species)")
    settings["output_prefix"] = user_output
    settings["input_maf"] = maf_path
    species = settings["species_list"]
    print(f"Results will be saved to: {output_dir}.")

    best_model_yaml = os.path.join(output_dir, f"{output_prefix}.best_model.yaml")
    state_yaml = os.path.join(output_dir,
                              f"{output_prefix}.optimizer_state.yaml")
    resume = args.resume and (os.path.exists(best_model_yaml)
                              or os.path.exists(state_yaml))
    if resume:
        # Prefer the mid-run search-state checkpoint (the optimizer's last
        # iterate) over the best-model YAML (reference README.md:36-40),
        # which only records the best-so-far point.
        if os.path.exists(state_yaml):
            with open(state_yaml) as f:
                st = yaml.safe_load(f)
            for i, name in enumerate(setup["optim_variables"]):
                if name in st.get("variables", []):
                    setup["optim_list"][i] = float(
                        st["x_internal"][st["variables"].index(name)]
                    )
            print(f"Resuming from {state_yaml} "
                  f"(iterate after {st.get('n_eval', '?')} evaluations).")
        else:
            with open(best_model_yaml) as f:
                prev = yaml.safe_load(f)
            mu = setup["mu"]
            prev_opt = prev.get("optimized_parameters") or {}
            for i, name in enumerate(setup["optim_variables"]):
                if name in prev_opt:
                    v = float(prev_opt[name])
                    setup["optim_list"][i] = v / mu if name == "r" else v * mu
            print(f"Resuming from {best_model_yaml} "
                  f"(loglik {prev['results']['log_likelihood']}).")
    else:
        write_starting_params(
            os.path.join(output_dir, f"{output_prefix}.starting_params.yaml"),
            setup["descaled_fixed"],
            setup["descaled_bounds"],
            settings,
        )
        seed_best_model(best_model_yaml, setup["descaled_fixed"], settings)

    print("Reading MAF alignment file.")
    v_lst = maf_tokens(maf_path, species)
    if not v_lst:
        raise ValueError("Error reading MAF alignment file.")
    print(f"{len(v_lst)} alignment blocks, "
          f"{sum(len(v) for v in v_lst)} columns.")

    print(f"Running optimization ({method}"
          f"{', exact gradients' if use_grad else ''}) on {device}...")
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
        header=not resume,
        device=device,
        use_grad=use_grad,
    )
    print(
        f"Optimization complete. Results saved to "
        f"{os.path.join(output_dir, f'{output_prefix}.optimization_history.csv')}.\n"
        f"Best model saved to "
        f"{os.path.join(output_dir, f'{output_prefix}.best_model.yaml')}."
    )


if __name__ == "__main__":
    main()
