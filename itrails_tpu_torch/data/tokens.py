"""Observed-state alphabet for 4-species alignment columns.

625 tokens: the 256 unambiguous ACTG 4-mers (index = a*64+b*16+c*4+d over
the alphabet A,C,T,G) followed by the 369 4-mers containing at least one N
(enumeration order of the reference's get_obs_state_dct,
read_data.py:6-24).  Ambiguity (N / gap / unknown) is resolved by summing
the emission probability over the compatible unambiguous tokens, applied
once per model build as a static (625, 256) 0/1 aggregation matrix:
``b_full = b @ AGG.T``.
"""

from __future__ import annotations

import functools

import numpy as np

ALPHABET = "ACTG"
PAD_TOKEN = -1
N_TOKENS = 625

__all__ = ["ALPHABET", "PAD_TOKEN", "N_TOKENS", "token_strings",
           "token_index", "aggregation_matrix"]


@functools.lru_cache(maxsize=1)
def token_strings() -> list:
    """All 625 token strings in reference order."""
    out = [a + b + c + d for a in ALPHABET for b in ALPHABET
           for c in ALPHABET for d in ALPHABET]
    ext = "ACTGN"
    for a in ext:
        for b in ext:
            for c in ext:
                for d in ext:
                    s = a + b + c + d
                    if "N" in s:
                        out.append(s)
    return out


@functools.lru_cache(maxsize=1)
def token_index() -> dict:
    return {s: i for i, s in enumerate(token_strings())}


@functools.lru_cache(maxsize=1)
def aggregation_matrix() -> np.ndarray:
    """(625, 256) 0/1 matrix: row t marks the unambiguous tokens compatible
    with token t (N matches any base)."""
    strings = token_strings()
    agg = np.zeros((len(strings), 256), dtype=np.float64)
    base_idx = {c: i for i, c in enumerate(ALPHABET)}
    for t, s in enumerate(strings):
        choices = [range(4) if ch == "N" else [base_idx[ch]] for ch in s]
        for a in choices[0]:
            for b in choices[1]:
                for c in choices[2]:
                    for d in choices[3]:
                        agg[t, ((a * 4 + b) * 4 + c) * 4 + d] = 1.0
    return agg
