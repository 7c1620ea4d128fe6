"""Simulate alignments from the coalescent HMM.

Samples hidden gene-tree paths from ``(a, pi)`` and emission columns from
``b`` on the model's device, and writes token blocks as a MAF file: the
input of the end-to-end checks (simulate from known parameters, optimize,
compare).
"""

from __future__ import annotations

import numpy as np
import torch

from itrails_tpu_torch.data.tokens import token_index, token_strings

__all__ = ["simulate_token_batch", "write_maf"]


def _normalized(x, dim):
    x = x.to(torch.float64).clamp(min=0)
    return x / x.sum(dim=dim, keepdim=True)


def simulate_token_batch(a, b, pi, n_windows: int, win_len: int,
                         generator: torch.Generator, n_frac: float = 0.02,
                         n_run: int = 64) -> torch.Tensor:
    """Sample a (n_windows, win_len) int32 token batch from the HMM
    ``(a, b, pi)`` on their device, one inverse-CDF step per column over
    all windows at once, then per-state grouped emission sampling.

    ``n_frac`` of columns are overwritten by geometric bursts (mean
    ``n_run``) of the all-ambiguous ``NNNN`` token, mimicking the masked
    runs of real MAF alignments (reference read_data.py:94-117 maps every
    non-ACGT character to N).  ``generator`` lives on the tables' device
    and makes the batch reproducible."""
    dev = a.device
    cdf_a = torch.cumsum(_normalized(a, 1), dim=1)
    cdf_b = torch.cumsum(_normalized(b, 1), dim=1)
    cdf_pi = torch.cumsum(_normalized(pi, 0), dim=0)
    m = pi.shape[0]

    def uniform(*shape):
        return torch.rand(shape, generator=generator, dtype=torch.float64,
                          device=dev)

    states = torch.empty((n_windows, win_len), dtype=torch.long, device=dev)
    states[:, 0] = torch.searchsorted(cdf_pi, uniform(n_windows)).clamp(max=m - 1)
    for t in range(1, win_len):
        u = uniform(n_windows)
        states[:, t] = ((cdf_a[states[:, t - 1]] < u[:, None]).sum(dim=1)
                        .clamp(max=m - 1))

    flat = states.reshape(-1)
    u = uniform(flat.numel())
    tokens = torch.empty(flat.numel(), dtype=torch.int32, device=dev)
    for s in range(m):
        idx = torch.nonzero(flat == s).squeeze(1)
        tokens[idx] = (torch.searchsorted(cdf_b[s], u[idx])
                       .clamp(max=b.shape[1] - 1).to(torch.int32))

    if n_frac > 0.0:
        n_runs = max(1, int(n_frac * tokens.numel() / n_run))
        starts = torch.randint(0, tokens.numel(), (n_runs,),
                               generator=generator, device=dev)
        # geometric run lengths with mean n_run (support 1, 2, ...)
        lens = (torch.log(uniform(n_runs)) / np.log1p(-1.0 / n_run)).ceil()
        lens = lens.clamp(min=1).long()
        covered = torch.zeros(tokens.numel() + 1, dtype=torch.int32, device=dev)
        covered.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
        ends = (starts + lens).clamp(max=tokens.numel())
        covered.index_add_(0, ends, -torch.ones_like(ends, dtype=torch.int32))
        mask = torch.cumsum(covered[:-1], dim=0) > 0
        tokens[mask] = token_index()["NNNN"]
    return tokens.reshape(n_windows, win_len)


def write_maf(path, token_blocks, species, chrom="chr1", src_size=500_000_000):
    """Write token blocks (1-D integer arrays over the 625-token alphabet)
    as a minimal MAF alignment of the four ``species``."""
    chars = np.array([[ord(c) for c in s] for s in token_strings()],
                     dtype=np.uint8)  # (625, 4)
    with open(path, "w") as f:
        f.write("##maf version=1\n\n")
        start = 0
        for block in token_blocks:
            cols = chars[np.asarray(block, dtype=np.int64)]  # (L, 4)
            f.write("a score=0.0\n")
            for s, sp in enumerate(species):
                seq = cols[:, s].tobytes().decode()
                f.write(f"s {sp}.{chrom} {start} {len(block)} + {src_size} "
                        f"{seq}\n")
            f.write("\n")
            start += len(block)
