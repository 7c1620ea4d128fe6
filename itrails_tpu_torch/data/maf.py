"""Streaming MAF alignment ingestion.

Reference semantics (read_data.py:94-220): for each alignment block that
contains all four requested species, gaps become 'N' and each column
becomes a token of the 625-symbol alphabet; reference-coordinate
extraction tracks the chosen reference species' position per column (gaps
-> -9), honouring strand and srcSize.

A single-pass line parser with a vectorized column tokenizer: the four
sequences are mapped to base codes (A,C,T,G -> 0..3, anything else -> N=4)
and the token index is read from a (5,5,5,5) lookup table of the
reference's token enumeration.
"""

from __future__ import annotations

import functools

import numpy as np

from itrails_tpu_torch.data.tokens import token_index

__all__ = ["MafBlock", "read_maf", "maf_tokens", "maf_reference_coordinates"]

_BASE_CODE = np.full(256, 4, dtype=np.int8)  # default: N
for _i, _ch in enumerate("ACTG"):
    _BASE_CODE[ord(_ch)] = _i
    _BASE_CODE[ord(_ch.lower())] = _i


@functools.lru_cache(maxsize=1)
def _token_lut() -> np.ndarray:
    """(5,5,5,5) -> token id lookup (base codes 0..3 = A,C,T,G; 4 = N)."""
    lut = np.zeros((5, 5, 5, 5), dtype=np.int32)
    idx = token_index()
    sym = "ACTGN"
    for a in range(5):
        for b in range(5):
            for c in range(5):
                for d in range(5):
                    lut[a, b, c, d] = idx[sym[a] + sym[b] + sym[c] + sym[d]]
    return lut


class MafBlock:
    """One alignment block: per-species aligned text plus the s-line
    annotations needed for coordinate projection."""

    __slots__ = ("seqs", "meta")

    def __init__(self):
        self.seqs = {}  # species -> aligned string
        self.meta = {}  # species -> (start, size, strand, src_size)


def read_maf(path, species):
    """Yield :class:`MafBlock` for every block containing sequences for any
    of the given species (species name = src up to the first '.')."""
    wanted = set(species)
    block = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("a"):
                if block is not None and block.seqs:
                    yield block
                block = MafBlock()
            elif line.startswith("s ") and block is not None:
                parts = line.split()
                name = parts[1].split(".")[0]
                if name in wanted:
                    block.seqs[name] = parts[6]
                    block.meta[name] = (int(parts[2]), int(parts[3]),
                                        1 if parts[4] == "+" else -1,
                                        int(parts[5]))
    if block is not None and block.seqs:
        yield block


def _four_species(species):
    species = list(species)
    if len(species) != 4:
        raise ValueError("the 625-token alphabet needs exactly 4 species "
                         f"(3 ingroup + outgroup), got {species}")
    return species


def maf_tokens(path, species):
    """Token arrays (one int32 array per complete block) for the four
    species, in their given order (reference maf_parser, read_data.py:
    94-117: blocks missing any species are skipped; gaps count as N)."""
    species = _four_species(species)
    lut = _token_lut()
    out = []
    for block in read_maf(path, species):
        if len(block.seqs) != len(species):
            continue
        cols = [_BASE_CODE[np.frombuffer(block.seqs[sp].encode(),
                                         dtype=np.uint8)]
                for sp in species]
        out.append(lut[cols[0], cols[1], cols[2], cols[3]].astype(np.int32))
    return out


def maf_reference_coordinates(path, species, ref):
    """Per-block reference-genome coordinates per alignment column
    (reference parse_coordinates, read_data.py:146-220), one int64 array
    for each block that :func:`maf_tokens` keeps.

    Each column maps to the ``ref`` species' coordinate (start offset per
    non-gap column; the reverse strand counts backwards from srcSize -
    start), gaps map to -9; blocks where the reference sequence is absent
    map wholly to -9.
    """
    species = _four_species(species)
    out = []
    for block in read_maf(path, set(species) | {ref}):
        if any(sp not in block.seqs for sp in species):
            continue
        if ref in block.seqs:
            text = block.seqs[ref]
            start, _size, strand, src_size = block.meta[ref]
            pos = start if strand == 1 else src_size - start
            coords = np.full(len(text), -9, dtype=np.int64)
            is_base = np.frombuffer(text.encode(), dtype=np.uint8) != ord("-")
            steps = np.cumsum(is_base.astype(np.int64)) - 1
            coords[is_base] = pos + strand * steps[is_base]
            out.append(coords)
        else:
            any_sp = next(iter(block.seqs))
            out.append(np.full(len(block.seqs[any_sp]), -9, dtype=np.int64))
    return out
