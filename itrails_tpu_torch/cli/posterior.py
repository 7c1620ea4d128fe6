"""``itrails-tpu-torch-posterior``: genome-wide posterior state decoding
(reference workflow_posterior.py, and ``itrails-tpu-posterior``): the same
flags, config schema and CSV artifacts.  It runs on the card, with kernel
K4, unless ``--device cpu`` is given, and streams the posterior to its CSV
block by block."""

from __future__ import annotations

from itrails_tpu_torch.cli import decode


def main(argv=None):
    decode.decode_main(
        argv,
        "Posterior workflow using iTRAILS-TPU-torch",
        usage=("itrails-tpu-torch-posterior --config-file CONFIG_FILE --input "
               "PATH_MAF --output OUTPUT_PATH --PARAMETERS"),
        posterior=True,
    )


if __name__ == "__main__":
    main()
