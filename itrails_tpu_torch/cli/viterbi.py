"""``itrails-tpu-torch-viterbi``: most-likely gene-tree path decoding
(reference workflow_viterbi.py, and ``itrails-tpu-viterbi``): the same
flags, config schema and CSV artifacts.  It runs on the card, with kernel
K3 (and, for a block above 262,144 columns, the route of K6 and K3's parts,
``hmm/longseq.py:viterbi_long``), unless ``--device cpu`` is given."""

from __future__ import annotations

from itrails_tpu_torch.cli import decode


def main(argv=None):
    decode.decode_main(
        argv,
        "Viterbi workflow using iTRAILS-TPU-torch",
        usage=("itrails-tpu-torch-viterbi --config-file CONFIG_FILE --input "
               "PATH_MAF --output OUTPUT_PATH --PARAMETERS"),
        posterior=False,
    )


if __name__ == "__main__":
    main()
