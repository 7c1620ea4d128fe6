"""Emission probabilities for all hidden gene-tree states, as batched tensor
contractions (reference: get_emission_prob_mat.py).

Structure: for each hidden state the emission over observed 4-mers
``(a0, b0, c0, d0)`` is a Felsenstein-style contraction of

* JC69 branch propagators ``P(theta)`` with ``theta = sum_i mu_i t_i``
  (the JC69 propagator has the closed form ``1/4 + (I - 1/4) exp(-theta)``,
  exactly equal to the reference's numeric ``expm`` of the summed rate
  matrix, p_b_given_a at get_emission_prob_mat.py:22-44);
* a single-coalescence tensor ``F[a,b,c] = sum_d f(...)`` — the closed-form
  integral of the JC69 likelihood against a truncated-exponential
  coalescence density (JC69_analytical_integral, :47-92);
* a double-coalescence tensor ``D[a,b,c,d]`` for two coalescences in one
  interval (JC69_analytical_integral_double, :120-397).

The reference evaluates the contraction with 4^4 x 4^6 nested Python loops
per state (:586-606); here every state of a geometry class is one row of a
batched einsum (the leading dimension of every tensor below).
"""

from __future__ import annotations

import numpy as np
import torch

from itrails_tpu_torch.core.schedule import hidden_state_list

__all__ = [
    "jc69_propagator",
    "coal_tensor_single",
    "coal_tensor_double",
    "EmissionMatrixFn",
    "IntrogressionEmissionFn",
]

# EQ[i, j] = 3/4 if i == j else -1/4  (the alpha/beta/... coefficients)
_EQ = np.full((4, 4), -0.25) + np.eye(4)

# Every alpha/beta/... coefficient is BINARY (-1/4 or 3/4), so the closed-
# form integrands take only 2^3 (single) / 2^5 (double) distinct values on
# their nucleotide grids.  The static count matrices below map the tiny
# distinct-value tables back onto the (4, 4, 4[, 4]) output (summing the
# internal nucleotides), replacing 256 / 4096 evaluations of the
# transcendental formula with 8 / 32.
_TWO = np.array([-0.25, 0.75])


def _counts_single():
    eqi = np.eye(4, dtype=np.int64)  # 1 where nucleotides match
    a, b, c, d = np.ogrid[:4, :4, :4, :4]
    idx = eqi[a, d] * 4 + eqi[d, b] * 2 + eqi[d, c]  # (4,4,4,4)
    counts = np.zeros((64, 8), np.int64)
    flat = idx.reshape(64, 4)  # (abc, d)
    for k in range(4):
        np.add.at(counts, (np.arange(64), flat[:, k]), 1)
    return counts


def _counts_double():
    eqi = np.eye(4, dtype=np.int64)
    a, b, c, d, e, f = np.ogrid[:4, :4, :4, :4, :4, :4]
    idx = (eqi[a, e] * 16 + eqi[e, b] * 8 + eqi[e, f] * 4
           + eqi[f, c] * 2 + eqi[f, d])  # (4,4,4,4,4,4)
    counts = np.zeros((256, 32), np.int64)
    flat = idx.reshape(256, 16)  # (abcd, ef)
    for k in range(16):
        np.add.at(counts, (np.arange(256), flat[:, k]), 1)
    return counts


_COUNTS_SINGLE = _counts_single()  # (64, 8)
_COUNTS_DOUBLE = _counts_double()  # (256, 32)


def _binary_axes(n_axes: int, like: torch.Tensor):
    """The -1/4, 3/4 coefficient grid as ``n_axes`` broadcastable tensors of
    shape (1, .., 2, .., 1) behind a leading batch axis."""
    two = torch.as_tensor(_TWO, dtype=like.dtype, device=like.device)
    out = []
    for k in range(n_axes):
        shape = [1] * (n_axes + 1)
        shape[k + 1] = 2
        out.append(two.view(shape))
    return out


def jc69_propagator(theta):
    """JC69 transition matrices (..., 4, 4) after total scaled branch
    lengths ``theta`` (...,).  Closed form of expm(theta * (J/4 - I))."""
    e = torch.exp(-theta)[..., None, None]
    return 0.25 + torch.as_tensor(_EQ, dtype=e.dtype, device=e.device) * e


def _phi(x):
    """(1 - exp(-x)) / x, the stable divided difference of exp: finite and
    accurate for every x including x == 0 (series there)."""
    small = torch.abs(x) < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    series = 1.0 - x * (0.5 - x * (1.0 / 6.0 - x / 24.0))
    return torch.where(small, series, -torch.expm1(-safe) / safe)


def _single_integrand(alpha, beta, gamma, t, mu, k):
    """Reference JC69_analytical_integral (get_emission_prob_mat.py:47-92),
    restructured to remove the k ~= mu numerical cliff the reference
    inherits: its ``gamma/(mu - k)`` and ``gamma/(k - mu)`` terms cancel
    catastrophically; here the pair is the exact divided difference
    ``gamma * exp(-k t) * t * phi((mu - k) t)``, finite and fully accurate
    through k == mu.  Every ``1 - exp(-x)`` is ``-expm1``."""
    ekt_m = torch.exp(-k * t)
    emt_m = torch.exp(-mu * t)
    one_m_ekt = -torch.expm1(-k * t)
    ab = alpha + beta
    km = -torch.expm1(-(k + mu) * t) / (k + mu)
    return (
        one_m_ekt * (1.0 + 16.0 * ab * gamma * emt_m)
        + 4.0
        * k
        * (
            gamma * ekt_m * t * _phi((mu - k) * t)
            + (ab + 16.0 * alpha * beta * gamma * emt_m) * km
            + 4.0 * alpha * beta * -torch.expm1(-(k + 2.0 * mu) * t)
            / (k + 2.0 * mu)
        )
    ) / (64.0 * one_m_ekt)


def coal_tensor_single(t, mu, k):
    """F[n, a, b, c] = P(b, c | a) for one coalescence within time
    ``t[n]`` at coalescent rate ``k`` (truncated-exponential), summed over
    the internal nucleotide (reference p_b_c_given_a_JC69_analytical,
    :95-117)."""
    alpha, beta, gamma = _binary_axes(3, t)
    table = _single_integrand(alpha, beta, gamma, t.reshape(-1, 1, 1, 1),
                              mu, k).reshape(-1, 8)
    counts = torch.as_tensor(_COUNTS_SINGLE, dtype=t.dtype, device=t.device)
    return (table @ counts.T).reshape(-1, 4, 4, 4)


# Half-width of the excluded band around the _double_integrand's removable
# singularities mu in {1, 2, 3}: un-guarded f64 cancellation at mu = 2
# reaches 2.2e-5 at a distance of 1e-6 and nan at the exact point; with the
# 1e-5 nudge the error against the true value stays <= ~2e-11 everywhere
# (the integrand is nearly flat across the removable point).
_MU_GUARD = 1e-5


def _double_integrand(alpha, beta, gamma, delta, epsilon, t, mu):
    """Reference JC69_analytical_integral_double
    (get_emission_prob_mat.py:120-397); two coalescences of three lineages
    within ``t`` (pair rate 3, then 1 — baked into the constants).

    ``mu`` is the substitution/coalescent rate ratio (model.py feeds
    (4/3) * N_ABC, ~1e-3 in any sane configuration).  The closed form has
    removable singularities at mu in {1, 2, 3}, reachable only at
    pathological bound corners; mu is nudged off the singular set by at
    most _MU_GUARD."""
    for s in (1.0, 2.0, 3.0):
        d = mu - s
        mu = torch.where(torch.abs(d) < _MU_GUARD,
                         s + torch.where(d < 0.0, -_MU_GUARD, _MU_GUARD), mu)
    em = torch.exp(mu * t)
    e2t = torch.exp(2.0 * t)
    p1 = (-1.0 + 2.0 * beta * (mu - 2.0)) * (2.0 + mu) + 2.0 * alpha * (mu - 2.0) * (
        2.0 + 8.0 * beta + mu
    )
    p2 = (1.0 + mu) * (2.0 + 8.0 * beta + mu) + 8.0 * alpha * (
        1.0 + mu + 2.0 * beta * (2.0 + mu)
    )
    p3 = 2.0 + mu + 8.0 * gamma * (1.0 + mu)
    mu2 = mu * mu

    a1 = (-2.0 * delta * (-2.0 - 8.0 * gamma + mu)) / (-6.0 + mu + mu2)
    a2 = -(32.0 * alpha * beta * delta * p3) / (3.0 * (1.0 + mu) ** 2 * (2.0 + mu))
    a3 = -(32.0 * alpha * beta * epsilon * p3) / (em * (1.0 + mu) * (2.0 + mu) * (3.0 + mu))
    a4 = -(8.0 * alpha * beta * (1.0 + 16.0 * delta * epsilon / em) * p3) / (
        (1.0 + mu) * (2.0 + mu) * (3.0 + 2.0 * mu)
    )
    a5 = (16.0 * delta * gamma * p1) / ((mu - 2.0) * (2.0 + mu) * (1.0 + 2.0 * mu))
    a6 = -(
        4.0
        * (alpha + beta)
        * (1.0 + 2.0 * gamma * (2.0 + mu))
        * (
            (3.0 + 2.0 * mu) * (3.0 * em + 4.0 * epsilon * (3.0 + mu))
            + 12.0 * delta * (em * (3.0 + mu) + 4.0 * epsilon * (3.0 + 2.0 * mu))
        )
    ) / (3.0 * em * (2.0 + mu) * (3.0 + mu) * (3.0 + 2.0 * mu))
    a7 = -(
        2.0
        * epsilon
        * (
            (2.0 + 8.0 * gamma - mu) / ((mu - 3.0) * (mu - 2.0))
            + p2 / ((mu - 1.0) * (1.0 + mu) * (2.0 + mu))
        )
    ) / em
    poly = 2.0 + 3.0 * mu + mu2
    a8 = -(
        -16.0 * delta * epsilon * (2.0 + 8.0 * gamma - mu) * poly
        + em * (-2.0 - 8.0 * gamma + mu) * poly
        - 3.0 * em * (mu - 2.0) * p2
        - 48.0 * epsilon * (2.0 * gamma * (1.0 + mu) * p1 + delta * (mu - 2.0) * p2)
    ) / (6.0 * em * (mu - 2.0) * (1.0 + mu) * (2.0 + mu))
    a9 = (
        2.0
        * (
            2.0 * em * gamma * (1.0 + mu) * p1
            + delta * (32.0 * epsilon * gamma * (1.0 + mu) * p1 + em * (mu - 2.0) * p2)
        )
    ) / (em * (1.0 + mu) ** 2 * (mu2 - 4.0))

    b1 = (32.0 * alpha * beta * delta * p3) / (3.0 * (1.0 + mu) ** 2 * (2.0 + mu))
    b2 = (32.0 * alpha * beta * em * epsilon * p3) / (
        (1.0 + mu) * (2.0 + mu) * (3.0 + mu)
    )
    b3 = (8.0 * alpha * beta * em * (1.0 + 16.0 * delta * epsilon / em) * p3) / (
        (1.0 + mu) * (2.0 + mu) * (3.0 + 2.0 * mu)
    )
    b4 = (
        4.0
        * (alpha + beta)
        * (1.0 + 2.0 * gamma * (2.0 + mu))
        * (
            (3.0 + 2.0 * mu) * (3.0 * em * em + 4.0 * em * em * epsilon * (3.0 + mu))
            + 12.0 * delta * (em * (3.0 + mu) + 4.0 * em * epsilon * (3.0 + 2.0 * mu))
        )
    ) / (3.0 * (2.0 + mu) * (3.0 + mu) * (3.0 + 2.0 * mu))

    c1 = (2.0 * delta * (-2.0 - 8.0 * gamma + mu)) / (e2t * (-6.0 + mu + mu2))
    c2 = -(16.0 * delta * gamma * p1) / (em * (mu - 2.0) * (2.0 + mu) * (1.0 + 2.0 * mu))
    c3 = (
        2.0
        * em
        * epsilon
        * (
            (2.0 + 8.0 * gamma - mu) / (e2t * (mu - 3.0) * (mu - 2.0))
            + p2 / ((mu - 1.0) * (1.0 + mu) * (2.0 + mu))
        )
    )
    c4 = (
        -16.0 * delta * epsilon * (2.0 + 8.0 * gamma - mu) * poly
        + em * (-2.0 - 8.0 * gamma + mu) * poly
        - 3.0 * e2t * em * (mu - 2.0) * p2
        - 48.0
        * e2t
        * epsilon
        * (2.0 * gamma * (1.0 + mu) * p1 + delta * (mu - 2.0) * p2)
    ) / (6.0 * e2t * (mu - 2.0) * (1.0 + mu) * (2.0 + mu))
    c5 = -(
        2.0
        * (
            2.0 * em * gamma * (1.0 + mu) * p1
            + delta * (32.0 * epsilon * gamma * (1.0 + mu) * p1 + em * (mu - 2.0) * p2)
        )
    ) / (em * (1.0 + mu) ** 2 * (mu2 - 4.0))

    inner = c1 + c2 + c3 + c4 + c5
    a10 = (b1 + b2 + b3 + b4 + torch.exp(2.0 * (1.0 + mu) * t) * inner) / torch.exp(
        3.0 * (1.0 + mu) * t
    )

    total = a1 + a2 + a3 + a4 + a5 + a6 + a7 + a8 + a9 + a10
    norm = 1024.0 * (1.0 + 0.5 / torch.exp(3.0 * t) - 1.5 / torch.exp(t))
    return 3.0 * total / norm


def coal_tensor_double(t, mu):
    """D[n, a, b, c, d] = P(b, c, d | a) for two coalescences of lineages
    (a,b,c) within ``t[n]``, summed over both internal nucleotides
    (reference p_b_c_d_given_a_JC69_analytical, :400-424)."""
    coef = _binary_axes(5, t)
    mu = torch.as_tensor(mu, dtype=t.dtype, device=t.device)
    table = _double_integrand(*coef, t.reshape(-1, 1, 1, 1, 1, 1),
                              mu).reshape(-1, 32)
    counts = torch.as_tensor(_COUNTS_DOUBLE, dtype=t.dtype, device=t.device)
    return (table @ counts.T).reshape(-1, 4, 4, 4, 4)


def _emission_single(theta_a, theta_b, theta_c, theta_ab, theta_d,
                     t1, mu1, k1, t2, mu2, k2):
    """Emission 4-tensors (n, 4, 4, 4, 4) for hidden states with two
    coalescence events in different intervals (reference
    calc_emissions_single_JC69:484-608).

    Branch layout: species branches a/b join at the first event; their
    ancestor travels theta_ab, joins c at the second event; the root emits
    the outgroup d over theta_d.  The leading 1/4 is the uniform root prior.
    """
    pa = jc69_propagator(theta_a)  # P[a0, a1]
    pb = jc69_propagator(theta_b)  # P[b1, b0] (symmetric)
    pc = jc69_propagator(theta_c)
    pab = jc69_propagator(theta_ab)
    pd = jc69_propagator(theta_d)  # P[abc0, d0]
    f1 = coal_tensor_single(t1, mu1, k1)  # F[a1, b1, ab0]
    f2 = coal_tensor_single(t2, mu2, k2)  # F[ab1, c1, abc0]
    return 0.25 * torch.einsum(
        "nax,nyb,nxyu,nuv,nvzw,nzc,nwd->nabcd", pa, pb, f1, pab, f2, pc, pd
    )


def _emission_double(theta_a, theta_b, theta_c, theta_d, t, mu):
    """Emission 4-tensors for hidden states whose two coalescence events
    fall in the same interval (reference calc_emissions_double_JC69:
    611-698)."""
    pa = jc69_propagator(theta_a)
    pb = jc69_propagator(theta_b)
    pc = jc69_propagator(theta_c)
    pd = jc69_propagator(theta_d)
    dd = coal_tensor_double(t, mu)  # D[a1, b1, c1, abc0]
    return 0.25 * torch.einsum("nax,nyb,nzc,nxyzw,nwd->nabcd",
                               pa, pb, pc, dd, pd)


class EmissionMatrixFn:
    """``times and rates -> (M, 256)`` emission matrix ``b`` for one
    ``(n_int_AB, n_int_ABC)``, on one device.

    Rows follow the sorted hidden-state list (schedule.hidden_state_list),
    columns the unambiguous 4-mer token order (a*64 + b*16 + c*4 + d over
    A,C,T,G).  Mirrors the state-geometry driver of the reference
    (get_emission_prob_mat.py:701-1038): V1/V2/V3 deep-coalescence states
    with i<j (two single events), i==j (one double event), and V0 states
    (first event in the AB epoch).  V2/V3 reuse the V1 geometry with
    species permuted onto branches, then permute the emission axes back
    (:871-875, :897-899)."""

    def __init__(self, n_int_AB: int, n_int_ABC: int, *, device):
        self.n_int_AB = n_int_AB
        self.n_int_ABC = n_int_ABC
        self.device = torch.device(device)
        last = n_int_ABC - 1
        pairs = [(i, j) for i in range(n_int_ABC) for j in range(i + 1, n_int_ABC)]
        doubles = list(range(n_int_ABC))
        v0_pairs = [(i, j) for i in range(n_int_AB) for j in range(n_int_ABC)]

        def ix(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64).reshape(-1),
                                   device=self.device)

        def flag(x):
            return torch.as_tensor(np.asarray(x, dtype=bool).reshape(-1),
                                   device=self.device)

        p = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        self._pair_i, self._pair_j = ix(p[:, 0]), ix(p[:, 1])
        self._pair_j1 = ix(np.minimum(p[:, 1] + 1, last))
        self._pair_last = flag(p[:, 1] == last)
        d = np.asarray(doubles, dtype=np.int64)
        self._dbl_i = ix(d)
        self._dbl_i1 = ix(np.minimum(d + 1, last))
        self._dbl_last = flag(d == last)
        v = np.asarray(v0_pairs, dtype=np.int64).reshape(-1, 2)
        self._v0_i, self._v0_j = ix(v[:, 0]), ix(v[:, 1])
        self._v0_j1 = ix(np.minimum(v[:, 1] + 1, last))
        self._v0_last = flag(v[:, 1] == last)

        # row order of the concatenated blocks -> sorted hidden-state order
        keys, self.hidden_states = self._states(pairs, doubles, v0_pairs)
        pos = {k: r for r, k in enumerate(keys)}
        self._order = ix([pos[h] for h in self.hidden_states])

    def _states(self, pairs, doubles, v0_pairs):
        """The key of each row of the concatenated [V1, V2, V3 pairs; V1,
        V2, V3 doubles; V0] blocks, and the sorted hidden states."""
        keys = ([(c, i, j) for c in (1, 2, 3) for i, j in pairs]
                + [(c, i, i) for c in (1, 2, 3) for i in doubles]
                + [(0, i, j) for i, j in v0_pairs])
        return keys, hidden_state_list(self.n_int_AB, self.n_int_ABC)

    def __call__(self, *, t_A, t_B, t_C, t_AB, t_upper, t_out, coal_AB,
                 coal_ABC, mu_A, mu_B, mu_C, mu_D, mu_AB, mu_ABC, cut_AB,
                 cut_ABC):
        return self._assemble(self._blocks(
            t_A=t_A, t_B=t_B, t_C=t_C, t_AB=t_AB, t_upper=t_upper,
            t_out=t_out, coal_AB=coal_AB, coal_ABC=coal_ABC, mu_A=mu_A,
            mu_B=mu_B, mu_C=mu_C, mu_D=mu_D, mu_AB=mu_AB, mu_ABC=mu_ABC,
            cut_AB=torch.as_tensor(cut_AB), cut_ABC=torch.as_tensor(cut_ABC)))

    def _assemble(self, blocks):
        """The (M, 256) table from the blocks, in hidden-state order."""
        b = torch.cat(blocks, dim=0)[self._order]
        return b.reshape(b.shape[0], 256)

    def _v0_times(self, cut_ABC, t_upper):
        """``(t2, add)`` of the V0 (and V4) pairs' second event in ABC
        interval j: its length (``t_upper`` for the last) and the outgroup
        branch's extra ABC time."""
        last = self.n_int_ABC - 1
        j, j1 = self._v0_j, self._v0_j1
        t2 = torch.where(self._v0_last, t_upper, cut_ABC[j1] - cut_ABC[j])
        add = torch.where(self._v0_last, 0.0,
                          t_upper + cut_ABC[last] - cut_ABC[j1])
        return t2, add

    def _blocks(self, *, t_A, t_B, t_C, t_AB, t_upper, t_out, coal_AB,
                coal_ABC, mu_A, mu_B, mu_C, mu_D, mu_AB, mu_ABC, cut_AB,
                cut_ABC):
        """The emission 4-tensors of the V1-V3 and V0 states, as a list of
        (n, 4, 4, 4, 4) blocks in ``keys`` order."""
        last = self.n_int_ABC - 1
        blocks = []

        # -- deep, two single events in intervals i < j
        if self._pair_i.numel():
            i, j, j1 = self._pair_i, self._pair_j, self._pair_j1
            ci = cut_ABC[i]
            th_a = t_A * mu_A + t_AB * mu_AB + ci * mu_ABC
            th_b = t_B * mu_B + t_AB * mu_AB + ci * mu_ABC
            th_c = t_C * mu_C + ci * mu_ABC
            th_ab = (cut_ABC[j] - cut_ABC[i + 1]) * mu_ABC
            t1 = cut_ABC[i + 1] - ci
            t2 = torch.where(self._pair_last, t_upper, cut_ABC[j1] - cut_ABC[j])
            add = torch.where(self._pair_last, 0.0,
                              t_upper + cut_ABC[last] - cut_ABC[j1])
            th_d = t_out * mu_D + add * mu_ABC

            def em1(a, b, c):
                return _emission_single(a, b, c, th_ab, th_d, t1, mu_ABC,
                                        coal_ABC, t2, mu_ABC, coal_ABC)

            # V1: branches (A, B | C); V2: (A, C | B); V3: (B, C | A)
            blocks += [em1(th_a, th_b, th_c),
                       em1(th_a, th_c, th_b).permute(0, 1, 3, 2, 4),
                       em1(th_b, th_c, th_a).permute(0, 3, 1, 2, 4)]

        # -- deep, double event in one interval i
        i, i1 = self._dbl_i, self._dbl_i1
        ci = cut_ABC[i]
        th_a = t_A * mu_A + t_AB * mu_AB + ci * mu_ABC
        th_b = t_B * mu_B + t_AB * mu_AB + ci * mu_ABC
        th_c = t_C * mu_C + ci * mu_ABC
        td = torch.where(self._dbl_last, t_upper, cut_ABC[i1] - ci)
        add = torch.where(self._dbl_last, 0.0,
                          t_upper + cut_ABC[last] - cut_ABC[i1])
        th_d = t_out * mu_D + add * mu_ABC

        def em2(a, b, c):
            return _emission_double(a, b, c, th_d, td, mu_ABC)

        blocks += [em2(th_a, th_b, th_c),
                   em2(th_a, th_c, th_b).permute(0, 1, 3, 2, 4),
                   em2(th_b, th_c, th_a).permute(0, 3, 1, 2, 4)]

        # -- V0: first event in the AB epoch interval i, second in ABC j
        i, j = self._v0_i, self._v0_j
        th_a = t_A * mu_A + cut_AB[i] * mu_AB
        th_b = t_B * mu_B + cut_AB[i] * mu_AB
        th_c = t_C * mu_C + cut_ABC[j] * mu_ABC
        th_ab = (t_AB - cut_AB[i + 1]) * mu_AB + cut_ABC[j] * mu_ABC
        t1 = cut_AB[i + 1] - cut_AB[i]
        t2, add = self._v0_times(cut_ABC, t_upper)
        th_d = t_out * mu_D + add * mu_ABC
        blocks.append(_emission_single(th_a, th_b, th_c, th_ab, th_d, t1,
                                       mu_AB, coal_AB, t2, mu_ABC, coal_ABC))
        return blocks


class IntrogressionEmissionFn(EmissionMatrixFn):
    """``times and rates -> (M, 256)`` emission matrix of the introgression
    model for one ``(n_int_AB, n_int_ABC)``, on one device (the JAX
    package's ``itrails_tpu/core/emissions.py:457
    emission_matrix_introgression``; reference
    get_emission_prob_mat_introgression, int_get_emission_prob_mat.py:
    744-1110).

    ``t_B``/``t_C`` run from the present to the *migration* event; the
    V0-V3 geometries are the plain ones with the effective branch lengths
    ``t_B + t_m`` and ``t_C + t_m + t_AB``; the V4 (introgressed) states
    coalesce B with C in the BC epoch on the shifted cutpoint grid
    ``cut_BC = [0] + (cut_AB[1:] + t_m)`` at rate ``coal_BC``.  One
    mutation rate ``mu`` scales every branch."""

    def _states(self, pairs, doubles, v0_pairs):
        """The plain rows, then the V4 block's, on V0's (i, j)."""
        keys, _ = super()._states(pairs, doubles, v0_pairs)
        return (keys + [(4, i, j) for i, j in v0_pairs],
                hidden_state_list(self.n_int_AB, self.n_int_ABC, True))

    def __call__(self, *, t_A, t_B, t_C, t_AB, t_m, t_upper, t_out, coal_AB,
                 coal_BC, coal_ABC, mu, cut_AB, cut_ABC):
        cut_AB = torch.as_tensor(cut_AB)
        cut_ABC = torch.as_tensor(cut_ABC)
        cut_BC = torch.cat([torch.zeros(1, dtype=cut_AB.dtype,
                                        device=cut_AB.device),
                            cut_AB[1:] + t_m])

        # -- V4: B and C coalesce in BC interval i, A joins in ABC j;
        # branches (x, y, z) = (B, C, A)
        i, j = self._v0_i, self._v0_j
        th_a = t_B * mu + cut_BC[i] * mu
        th_b = t_C * mu + cut_BC[i] * mu
        th_c = (t_A + t_AB) * mu + cut_ABC[j] * mu
        th_ab = (t_AB + t_m - cut_BC[i + 1]) * mu + cut_ABC[j] * mu
        t1 = cut_BC[i + 1] - cut_BC[i]
        t2, add = self._v0_times(cut_ABC, t_upper)
        th_d = t_out * mu + add * mu
        # back to (A, B, C, D) axis order (reference
        # int_get_emission_prob_mat.py:1098-1100)
        v4 = _emission_single(th_a, th_b, th_c, th_ab, th_d, t1, mu, coal_BC,
                              t2, mu, coal_ABC).permute(0, 3, 1, 2, 4)

        blocks = self._blocks(
            t_A=t_A, t_B=t_B + t_m, t_C=t_C + t_m + t_AB, t_AB=t_AB,
            t_upper=t_upper, t_out=t_out, coal_AB=coal_AB, coal_ABC=coal_ABC,
            mu_A=mu, mu_B=mu, mu_C=mu, mu_D=mu, mu_AB=mu, mu_ABC=mu,
            cut_AB=cut_AB, cut_ABC=cut_ABC)
        return self._assemble(blocks + [v4])
