"""Streaming MAF alignment ingestion.

Reference semantics (read_data.py:94-117): for each alignment block that
contains all four requested species, gaps become 'N' and each column
becomes a token of the 625-symbol alphabet.

A single-pass line parser with a vectorized column tokenizer: the four
sequences are mapped to base codes (A,C,T,G -> 0..3, anything else -> N=4)
and the token index is read from a (5,5,5,5) lookup table of the
reference's token enumeration.
"""

from __future__ import annotations

import functools

import numpy as np

from itrails_tpu_torch.data.tokens import token_index

__all__ = ["read_maf", "maf_tokens"]

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


def read_maf(path, species):
    """Yield ``{species: aligned text}`` for every block containing
    sequences for any of the given species (species name = src up to the
    first '.')."""
    wanted = set(species)
    block = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("a"):
                if block:
                    yield block
                block = {}
            elif line.startswith("s ") and block is not None:
                parts = line.split()
                name = parts[1].split(".")[0]
                if name in wanted:
                    block[name] = parts[6]
    if block:
        yield block


def maf_tokens(path, species):
    """Token arrays (one int32 array per complete block) for the four
    species, in their given order (reference maf_parser, read_data.py:
    94-117: blocks missing any species are skipped; gaps count as N)."""
    species = list(species)
    if len(species) != 4:
        raise ValueError("the 625-token alphabet needs exactly 4 species "
                         f"(3 ingroup + outgroup), got {species}")
    lut = _token_lut()
    out = []
    for block in read_maf(path, species):
        if len(block) != len(species):
            continue
        cols = [_BASE_CODE[np.frombuffer(block[sp].encode(), dtype=np.uint8)]
                for sp in species]
        out.append(lut[cols[0], cols[1], cols[2], cols[3]].astype(np.int32))
    return out
