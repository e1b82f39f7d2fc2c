"""Blocked-scan square-root-Kalman/RLS equalizer updates.

The reference equalizer chains one Hsu-1982 sqrt-Kalman update per
symbol (reference: src/kalman.c:85-141 driven from equalizer.c:25-58)
-- a 159-step serial recursion per frame that is the faithful path's
throughput ceiling (SURVEY.md hard-part #1).  This module is the BLOCKED restructuring the north star
names: process ``B`` symbols with FROZEN coefficients (one batched
filter + error computation -- dense batched arithmetic), then fold the whole
block into ONE information-form RLS update:

    R   <- lam^B * (R + Z^H Z) + (1 - lam^B) * E * I
    dw  =  solve(R + Z^H Z, Z^H e)        (5x5 Cholesky, vectorized)

with forgetting ``lam = 1/(1+q)`` matching the reference's per-step
process-noise inflation q (kalman.c:62, hq = 1+q at kalman.c:115).
The per-symbol gain recursion and the blocked update converge to the
same exponentially-weighted least-squares solution; what changes is
WITHIN-block adaptation (frozen vs per-symbol), a numerics difference
that must stay inside the SNR parity bound -- verified against the
exact scan in tests/test_blocked_kalman.py.

Sequential depth per frame drops 159 -> ceil(128/B) + ceil(31/B)
(5 at B=32), and every step is channel-batched dense linear algebra.

Conjugation conventions mirror the reference's train/data asymmetry
(equalizer.c:48-50 vs 69-71, SURVEY.md quirk #7): training filters
``z . coeff`` (no conj), data filters ``w . conj(coeff)``.  Both LS
increments share the SAME window Gram matrix Z^H Z (the data-domain
update solves for conj(coeff) and conjugates back), so R is tracked
once.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..utils.linalg import chol_solve_hermitian


class BlockedEqState(NamedTuple):
    """Information-form blocked-RLS state (per channel or batch)."""
    r: jnp.ndarray       # [.., L, L] c64 forgetting-weighted info matrix
    coeff: jnp.ndarray   # [.., L] c64 equalizer taps


def blocked_eq_init(eq_length: int, E: float,
                    batch_shape=()) -> BlockedEqState:
    """kalman_reset equivalent: coeff = 0, R = E*I (kalman.c:42-55:
    d = 1, u = 0 is prior covariance I regularized by measurement
    noise E -- information floor E*I)."""
    eye = jnp.eye(eq_length, dtype=jnp.complex64)
    return BlockedEqState(
        r=jnp.broadcast_to(E * eye,
                           (*batch_shape, eq_length, eq_length)),
        coeff=jnp.zeros((*batch_shape, eq_length), jnp.complex64),
    )


def _info_update(state: BlockedEqState, Z, e_vec, lam_B: float,
                 E: float, conj_domain: bool) -> BlockedEqState:
    """One blocked info-form update from windows Z [.., B, L] and
    frozen-coeff errors e_vec [.., B]."""
    hi = lax.Precision.HIGHEST      # Gram/solve feed the coefficients
    A = jnp.einsum("...bi,...bj->...ij", jnp.conj(Z), Z, precision=hi)
    # R is tracked in the TRAIN domain (curvature wrt coeff); the data
    # update solves for u = conj(coeff), whose curvature is the
    # elementwise conjugate of the train-domain one.
    r_dom = jnp.conj(state.r) if conj_domain else state.r
    S = r_dom + A
    b = jnp.einsum("...bi,...b->...i", jnp.conj(Z), e_vec, precision=hi)
    delta = chol_solve_hermitian(S, b)
    if conj_domain:
        delta = jnp.conj(delta)
    coeff = state.coeff + delta
    L = Z.shape[-1]
    eye = jnp.eye(L, dtype=jnp.complex64)
    r_new = lam_B * S + (1.0 - lam_B) * E * eye
    if conj_domain:
        r_new = jnp.conj(r_new)
    return BlockedEqState(r=r_new, coeff=coeff)


def train_block(state: BlockedEqState, Z, refs, mask, lam_B: float,
                E: float, count_post: bool = False):
    """One frozen-coefficient training block.

    Z: [.., B, L] symbol windows; refs: [B] real preamble chips
    (train_eq's real reference, equalizer.c:45); mask: [B] f32
    validity (ragged tail).  Returns ``(new_state, match_count)``.

    Match criterion deviation (documented): the reference counts
    real(err)*ref > 0 (qpsk.c:117), i.e. val.real*ref < 1 -- an
    UNDERSHOOT statistic of the sequential recursion's damped
    transient.  A converged block-LS prediction hovers symmetrically
    around +-1, so that statistic decays to ~50% exactly when the fit
    is PERFECT.  The blocked path counts the intended sign agreement
    of the frozen-coefficient predictions instead (the production
    ls_train criterion); ``count_post=True`` (first block only, where
    the frozen coefficients are still zero) counts the post-update
    in-block predictions.  Detection thresholds carry over (verified
    in tests/test_blocked_kalman.py: clean ~128, noise-only ~70).
    """
    hi = lax.Precision.HIGHEST      # val's signs are the match count
    val = jnp.einsum("...bl,...l->...b", Z, state.coeff, precision=hi)
    err = refs - val                      # conj(ref-val).real == real
    new_state = _info_update(state, Z * mask[..., None],
                             err * mask, lam_B, E,
                             conj_domain=False)
    if count_post:
        val = jnp.einsum("...bl,...l->...b", Z, new_state.coeff,
                         precision=hi)
    matches = jnp.sum((val.real * refs > 0.0) * mask, axis=-1)
    return new_state, matches.astype(jnp.int32)


def data_block(state: BlockedEqState, W, mask, lam_B: float, E: float,
               error_gain: float = 0.1):
    """One frozen-coefficient decision-directed block.

    W: [.., B, L] windows.  Filters with conj(coeff) (equalizer.c:71),
    slices hard QPSK decisions, updates in the conj domain, mirrors the
    x0.1 decision-error damping (equalizer.c:81).  Returns
    ``(new_state, dibits, err_real_sum)`` -- err_real_sum is the
    reference's accumulated EOF cost contribution (qpsk.c:227-231).
    """
    sym = jnp.einsum("...bl,...l->...b", W, jnp.conj(state.coeff),
                     precision=lax.Precision.HIGHEST)   # sliced below
    i_bit = (sym.real < 0.0)
    q_bit = (sym.imag < 0.0)
    hard = (jnp.where(i_bit, -1.0, 1.0)
            + 1j * jnp.where(q_bit, -1.0, 1.0))
    err = (hard - sym) * error_gain
    dibits = ((i_bit.astype(jnp.uint8) << 1)
              | q_bit.astype(jnp.uint8))
    err_sum = jnp.sum(err.real * mask, axis=-1)
    new_state = _info_update(state, W * mask[..., None], err * mask,
                             lam_B, E, conj_domain=True)
    return new_state, dibits, err_sum
