"""The Viterbi and posterior decoding workflows (reference
workflow_viterbi.py and workflow_posterior.py, and
``itrails_tpu/cli/decode.py`` for the plain family): config resolution,
model build, hidden-states CSV, decoding on one device, and the segment and
posterior CSV writers, in formats byte-compatible with the reference."""

from __future__ import annotations

import csv
import os
import sys

import numpy as np
import torch

from itrails_tpu_torch import __version__, resolve_device
from itrails_tpu_torch.cli.common import (
    decode_parser,
    merge_decode_overrides,
    prepare_decode_setup,
    resolve_io,
)
from itrails_tpu_torch.core.model import build_model
from itrails_tpu_torch.data.maf import maf_reference_coordinates, maf_tokens
from itrails_tpu_torch.data.tokens import aggregation_matrix
from itrails_tpu_torch.hmm import decoders, longseq, windows

__all__ = ["TOPOLOGY_MAP", "build", "decode_main", "load_inputs",
           "run_posterior", "run_viterbi",
           "write_hidden_states", "write_posterior_csv", "write_viterbi_csv"]

TOPOLOGY_MAP = {
    0: "({sp1,sp2},sp3)",
    1: "((sp1,sp2),sp3)",
    2: "((sp1,sp3),sp2)",
    3: "((sp2,sp3),sp1)",
    4: "({sp2,sp3},sp1)",  # introgressed (reference workflow_int_viterbi.py:672)
}


def decode_main(argv, description, usage, posterior):
    """main() of the Viterbi (``posterior=False``) and posterior CLIs: full
    per-parameter override flags and config-optional invocation (reference
    workflow_viterbi.py:19-158)."""
    parser = decode_parser(description, usage=usage)
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        parser.print_usage()
        sys.exit("Error: No arguments provided. Please provide either a "
                 "config file, command-line parameters, or both.")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    config = merge_decode_overrides(args)
    obs_mode = config["settings"].get("obs_mode") or "standard"
    if obs_mode != "standard":
        raise ValueError("the decode workflows take only obs_mode "
                         f"'standard' (4 species), got {obs_mode!r}")
    setup, v_lst, coords, output_dir, output_prefix = load_inputs(config, args)
    print("Calculating transition and emission probability matrices.")
    model, a, bfull, pi = build(setup, args.precision, device,
                                posterior=posterior)
    write_hidden_states(
        os.path.join(output_dir, f"{output_prefix}.hidden_states.csv"),
        model, setup, first_interval_from_ab=posterior,
    )
    if posterior:
        print(f"Running posterior decoding on {device}.")
        write_posterior_csv(
            os.path.join(output_dir, f"{output_prefix}.posterior.csv"),
            run_posterior(a, bfull, pi, v_lst), coords,
        )
        return
    print(f"Running viterbi on {device}.")
    results = run_viterbi(a, bfull, pi, v_lst)
    write_viterbi_csv(
        os.path.join(output_dir, f"{output_prefix}.viterbi.csv"),
        results, coords,
    )


def load_inputs(config, args):
    maf_path, _, output_dir, output_prefix = resolve_io(config, args)
    setup = prepare_decode_setup(config)
    species = setup["settings"]["species_list"]
    v_lst = maf_tokens(maf_path, species)
    if not v_lst:
        raise ValueError("Error reading MAF alignment file.")
    ref = setup["settings"].get("reference")
    coords = (maf_reference_coordinates(maf_path, species, ref)
              if ref is not None else None)
    return setup, v_lst, coords, output_dir, output_prefix


def build(setup, precision="float64", device="cuda", posterior=False):
    """The model, built in f64 on ``device``, and the decode's
    ``(a, bfull, pi)`` in ``precision``, except for the Viterbi decode
    (``posterior`` False) on the card, whose kernel K3 takes float32 only;
    the posterior's kernel K4 takes both.  The emission table is summed in
    f64 and then rounded, as the optimize engine does
    (optim/optimizer.py:LoglikEngine._tables)."""
    dev = resolve_device(device)
    d = setup["params"]
    model = build_model(
        d["t_A"], d["t_B"], d["t_C"], d["t_2"], d["t_upper"], d["t_out"],
        d["N_AB"], d["N_ABC"], d["r"], d["n_int_AB"], d["n_int_ABC"],
        device=dev, cut_AB=setup["norm_cut_ab"], cut_ABC=setup["norm_cut_abc"],
    )
    dtype = (torch.float32 if dev.type == "cuda" and not posterior
             else getattr(torch, precision))
    bfull = decoders.emission_table(model.b, aggregation_matrix())
    a, bfull, pi = (x.to(dtype).contiguous() for x in (model.a, bfull, model.pi))
    return model, a, bfull, pi


def write_hidden_states(path, model, setup, first_interval_from_ab: bool):
    """``<prefix>.hidden_states.csv`` (reference workflow_viterbi.py:636-684
    and workflow_posterior.py): the Viterbi workflow annotates the
    first-coalescent interval of every state, V0 included, with the ABC
    cutpoints; the posterior workflow (``first_interval_from_ab``) annotates
    the V0 states' with the AB cutpoints."""
    abs_ab = setup["abs_cut_ab"]
    abs_abc = setup["abs_cut_abc"]
    if os.path.exists(path):
        print(f"Warning: File '{path}' already exists.")
        path = path.replace(".hidden_states.csv", ".hidden_states_2.csv")
        print(f"Using an alternative file name: {path}")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["state_idx", "topology", "interval_1st_coalescent",
                    "interval_2nd_coalescent", "shorthand_name"])
        for idx, state in enumerate(model.hidden_states):
            code, i, j = state
            cuts = abs_ab if code == 0 and first_interval_from_ab else abs_abc
            w.writerow([
                idx,
                TOPOLOGY_MAP.get(code, "Unknown"),
                f"{cuts[i]:.2f}-{cuts[i + 1]:.2f}",
                f"{abs_abc[j]:.2f}-{abs_abc[j + 1]:.2f}",
                tuple(state),
            ])
    print(f"Hidden states written to file {path}.")


# Blocks longer than this leave the window batch and decode
# sequence-parallel, each through its own route (longseq.viterbi_long,
# longseq.posterior_long_pieces), as in the JAX package.
LONG_BLOCK_THRESHOLD = windows.LONG_BLOCK_THRESHOLD


def _split_by_length(v_lst):
    short = [(i, v) for i, v in enumerate(v_lst) if len(v) <= LONG_BLOCK_THRESHOLD]
    long = [(i, v) for i, v in enumerate(v_lst) if len(v) > LONG_BLOCK_THRESHOLD]
    return short, long


def run_viterbi(a, bfull, pi, v_lst):
    """The Viterbi path of every block, as int32 numpy arrays, on the
    tables' device: the short blocks as one padded window batch (kernel
    K3), each block above LONG_BLOCK_THRESHOLD through the sequence-parallel
    route ``longseq.viterbi_long`` (K6, its entry scan and K3 over the
    block's chunk windows), in bounded memory whatever its length."""
    dev = a.device
    short, long = _split_by_length(v_lst)
    out = [None] * len(v_lst)
    if short:
        tokens, lengths, owner = windows.pack_windows([v for _, v in short],
                                                      pad_windows_to=1)
        paths = decoders.viterbi_fast(
            a, bfull, pi, torch.as_tensor(tokens, device=dev)).cpu().numpy()
        rows = [paths[w, : lengths[w]] for w in range(len(owner)) if owner[w] >= 0]
        for (i, _), row in zip(short, rows):
            out[i] = row
    for i, v in long:
        v = torch.as_tensor(np.asarray(v, np.int32), device=dev)
        out[i] = longseq.viterbi_long(a, bfull, pi, v).cpu().numpy()
    return out


def run_posterior(a, bfull, pi, v_lst):
    """Posterior decode of every block on the tables' device, as a generator
    of ``(block_idx, rows)`` in block and column order
    (``decoders.posterior_stream``, with this CLI's LONG_BLOCK_THRESHOLD):
    the short blocks in window groups, each block above the threshold
    through the sequence-parallel route ``longseq.posterior_long_pieces``,
    in pieces of one group of its chunks each.  Nothing holds more than one
    window group's or one chunk group's posterior."""
    return decoders.posterior_stream(a, bfull, pi, v_lst, LONG_BLOCK_THRESHOLD)


def _rle_rows(block_idx, res, c):
    """Rows of the Viterbi segment CSV for one block, matching the
    reference's per-position serial loop (workflow_viterbi.py:692-744)
    exactly, but touching Python only at state-change events (found
    vectorized with np.diff), so a chromosome-scale block costs
    O(#segments) instead of O(T)."""
    res = np.asarray(res)
    n = len(res)
    rows = []
    if n == 0:
        return rows
    if c is None:
        bounds = np.flatnonzero(res[1:] != res[:-1]) + 1  # segment starts
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds - 1, [n - 1]])
        for s, e in zip(starts, ends):
            rows.append([block_idx, s, e, res[s]])
        return rows

    # Event-driven replay of the reference's per-position state machine.
    # Serial semantics: a change at a non-gap position ends the segment and
    # starts a new one there; a change at a GAP position ends the segment
    # and enters "reset" mode, in which all further changes are swallowed
    # until the next non-gap position restarts a segment; a block ending in
    # reset mode emits no final row.  Within a segment `res` is constant,
    # so the only positions that matter are the change events (np.diff) and
    # the anchors (c != -9) bracketing them.
    c = np.asarray(c)
    anchor_idx = np.flatnonzero(c != -9)
    if anchor_idx.size == 0:
        return rows
    first = int(anchor_idx[0])
    # index of the last anchor strictly before each event / end
    events = np.flatnonzero(res[first + 1:] != res[first:-1]) + first + 1
    lb_at = anchor_idx[
        np.maximum(np.searchsorted(anchor_idx, events, side="left") - 1, 0)
    ] if events.size else np.empty(0, np.int64)
    next_anchor_at = np.searchsorted(anchor_idx, events, side="right")

    seg_start = int(c[first])
    cur = res[first]
    reset_exit = -1  # >=0: in reset mode until the anchor at this index
    for k in range(len(events)):
        p = int(events[k])
        if reset_exit >= 0:
            if p <= reset_exit:
                continue  # swallowed inside the gap (or at the exit anchor)
            # a new segment began at the exit anchor
            seg_start = int(c[reset_exit])
            cur = res[reset_exit]
            reset_exit = -1
            if res[p] == cur:
                continue  # no change relative to the restarted segment
        cur_non_null = int(c[lb_at[k]])
        rows.append([block_idx, seg_start, cur_non_null, cur])
        if c[p] != -9:
            seg_start = int(c[p])
            cur = res[p]
        else:
            j = next_anchor_at[k]
            if j < anchor_idx.size:
                reset_exit = int(anchor_idx[j])
            elif p == n - 1:
                # change at the final position, gap coordinate: the serial
                # loop ends before any reset iteration clears cur_non_null,
                # so a (-9)-start row IS emitted
                rows.append([block_idx, -9, int(c[anchor_idx[-1]]), res[p]])
                return rows
            else:
                return rows  # terminal gap run: reference emits nothing more
    if reset_exit >= 0:
        seg_start = int(c[reset_exit])
        cur = res[reset_exit]
    rows.append([block_idx, seg_start, int(c[anchor_idx[-1]]), cur])
    return rows


def write_viterbi_csv(path, results, coords):
    """Run-length-encoded state segments (reference
    workflow_viterbi.py:692-744).  Event-driven RLE: np.diff finds the
    segment boundaries so writing a 1e8-column block is O(#segments)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Block_idx", "position_start", "position_end",
                    "most_likely_state"])
        for block_idx, res in enumerate(results):
            c = None if coords is None else coords[block_idx]
            w.writerows(_rle_rows(block_idx, res, c))
    print(f"Viterbi decoding complete. Results saved to {path}.")


# Rows of the posterior CSV formatted and written at once.
POSTERIOR_CHUNK_ROWS = 1 << 16


def write_posterior_csv(path, results, coords):
    """Per-position per-state probabilities (reference
    workflow_posterior.py:697-716), byte for byte what
    ``itrails_tpu/cli/decode.py:351`` writes: a header line from
    ``csv.writer`` (ending in \\r\\n), then one line per column ending in
    \\n, each probability widened to f64 and written as ``repr(float)``, and
    the reference coordinate (-9 for a gap) in the position column when
    ``coords`` is given.

    ``results`` yields ``(block_idx, rows)`` in block and column order, a
    block possibly in several pieces (:func:`run_posterior`); each piece is
    written, in chunks of POSTERIOR_CHUNK_ROWS, before the next is asked
    for, so the decode and the write take turns."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        block, offset = None, 0
        for block_idx, rows in results:
            if block is None:
                writer.writerow(["alignment_block_idx", "position_idx"]
                                + [f"prob_state_{i}" for i in range(rows.shape[1])])
            if block_idx != block:
                block, offset = block_idx, 0
            for off in range(0, len(rows), POSTERIOR_CHUNK_ROWS):
                chunk = np.asarray(rows[off:off + POSTERIOR_CHUNK_ROWS], np.float64)
                lo = offset + off
                pos = (range(lo, lo + len(chunk)) if coords is None else
                       np.asarray(coords[block_idx][lo:lo + len(chunk)]).tolist())
                f.write("".join(
                    f"{block_idx},{p}," + ",".join(map(repr, row)) + "\n"
                    for p, row in zip(pos, chunk.tolist())))
            offset += len(rows)
            del rows  # the piece's group goes before the next decode
        if block is None:  # no block: the header alone, with no state
            writer.writerow(["alignment_block_idx", "position_idx"])
    print(f"Posterior decoding complete. Results saved to {path}.")
