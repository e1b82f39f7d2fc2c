"""Adaptive linear equalizer driven by the square-root Kalman gain.

JAX port of the reference's 5-tap feed-forward equalizer
(reference: src/equalizer.c).  Training (known reference symbol,
equalizer.c:45-58) and data (decision-directed, equalizer.c:64-90) are
pure step functions over an explicit state pytree so the per-symbol
recursion becomes a ``lax.scan`` body, ``vmap``-ed over channels.

Replicated quirks (parity-relevant, see SURVEY.md quirk #7): the
training filter output uses ``in * coeff`` with NO conjugation
(equalizer.c:48-50) while the data path uses ``in * conj(coeff)``
(equalizer.c:69-71); the asymmetry affects converged tap phase and is
kept bit-for-bit.

Descrambling is NOT done here (the reference descrambles inside
data_eq, equalizer.c:87); since the keystream is data-independent the
modem layer XORs the whole dibit block after the scan (scramble.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from .kalman import KalmanState, kalman_init, kalman_update


class EqState(NamedTuple):
    """Equalizer + Kalman state for one (or a batch of) channel(s)."""
    kalman: KalmanState
    coeff: jnp.ndarray   # [.., L] complex eq_coeff (kalman.c:19)


def eq_init(eq_length: int, batch_shape=()) -> EqState:
    """kalman_reset(): coeff = 0, u = 0, d = 1 (kalman.c:42-55)."""
    return EqState(
        kalman=kalman_init(eq_length, batch_shape),
        coeff=jnp.zeros((*batch_shape, eq_length), jnp.complex64),
    )


def _update(state: EqState, x_win, error, E: float, q: float) -> EqState:
    """update_eq(): gain recompute + coefficient update (equalizer.c:25-40)."""
    kalman, gain, y = kalman_update(state.kalman, x_win, E, q)
    scaled = error * y.astype(jnp.complex64)          # equalizer.c:35
    coeff = state.coeff + scaled[..., None] * jnp.conj(gain)  # equalizer.c:38
    return EqState(kalman=kalman, coeff=coeff)


def train_step(state: EqState, x_win, ref, E: float, q: float):
    """One training update; returns ``(new_state, real_error)``.

    Port of train_eq(in, index, ref) (equalizer.c:45-58): ``ref`` is a
    *real* scalar (the C prototype takes float; callers pass the
    complex preamble chip which C implicitly truncates to its real
    part -- qpsk.c:115-117).
    """
    val = jnp.sum(x_win * state.coeff, axis=-1)       # no conj (eq.c:48-50)
    error = jnp.conj(ref - val)                       # equalizer.c:53
    new_state = _update(state, x_win, error, E, q)
    return new_state, error.real


def data_step(state: EqState, x_win, E: float, q: float,
              error_gain: float = 0.1):
    """One decision-directed update; returns ``(new_state, dibit, real_error)``.

    Port of data_eq(&bits, in, index) (equalizer.c:64-90) minus the
    in-place descramble.  dibit = (I_bit << 1) | Q_bit with
    I_bit = Re(sym) < 0, Q_bit = Im(sym) < 0 (qpsk.c:268-271).
    """
    sym = jnp.sum(x_win * jnp.conj(state.coeff), axis=-1)  # eq.c:69-71
    i_bit = (sym.real < 0.0)
    q_bit = (sym.imag < 0.0)
    hard = jnp.where(i_bit, -1.0, 1.0) + 1j * jnp.where(q_bit, -1.0, 1.0)
    error = (hard - sym) * error_gain                 # equalizer.c:81
    new_state = _update(state, x_win, error, E, q)
    dibit = (i_bit.astype(jnp.uint8) << 1) | q_bit.astype(jnp.uint8)
    return new_state, dibit, error.real


def data_step_coherent(state: EqState, x_win, E: float, q: float,
                       error_gain: float = 0.1):
    """Phase-unambiguous decision-directed update (production path).

    The reference's data slicer applies ``conj(coeff)`` after training
    with ``coeff`` on a *real* reference (equalizer.c:49 vs 71), which
    leaves the QPSK constellation rotation ambiguous: for a channel of
    phase theta the sliced symbols come out rotated by 2*theta + 45deg,
    and the decision-directed loop locks to an arbitrary 90deg multiple
    (observed: the C locks each packet differently in its own loopback).

    Fix: slice in the training-consistent domain.  Training drives
    ``sum(win * coeff) -> p`` (real +/-1) for chips ``g*(1+j)*p``, so a
    data symbol s yields ``raw = sum(win * coeff) = s*(1-j)/2``;
    ``raw * (1+j) = s`` exactly -- the known-phase BPSK preamble pins
    the absolute rotation.  The decision-directed error is formed in
    the raw domain so the Kalman update dynamics match the reference's
    structure.
    """
    raw = jnp.sum(x_win * state.coeff, axis=-1)
    sym = raw * jnp.complex64(1.0 + 1.0j)
    i_bit = (sym.real < 0.0)
    q_bit = (sym.imag < 0.0)
    hard = jnp.where(i_bit, -1.0, 1.0) + 1j * jnp.where(q_bit, -1.0, 1.0)
    desired_raw = hard * jnp.complex64(0.5 - 0.5j)    # hard / (1+j)
    error = (desired_raw - raw) * error_gain
    new_state = _update(state, x_win, error, E, q)
    dibit = (i_bit.astype(jnp.uint8) << 1) | q_bit.astype(jnp.uint8)
    return new_state, dibit, error.real


def data_step_nlms(state: EqState, x_win, mu: float = 0.5,
                   eps: float = 1e-3):
    """Stable decision-directed NLMS step (production data path).

    The reference's square-root Kalman is a short-burst estimator: its
    process-noise inflation (q=0.08 per step, kalman.c:62) diverges
    over runs longer than the ~159 updates the C ever chains before a
    kalman_reset (qpsk.c:186).  A full-packet decode is 248 data
    symbols, so the production path freezes the Kalman after training
    and tracks with normalized LMS, which is unconditionally stable for
    0 < mu < 2 and costs O(L) per symbol.

    Slices in the training-consistent domain (see data_step_coherent)
    so the constellation rotation stays pinned by the preamble.
    Returns ``(new_state, dibit, |error|)``.
    """
    raw = jnp.sum(x_win * state.coeff, axis=-1)
    sym = raw * jnp.complex64(1.0 + 1.0j)
    i_bit = (sym.real < 0.0)
    q_bit = (sym.imag < 0.0)
    hard = jnp.where(i_bit, -1.0, 1.0) + 1j * jnp.where(q_bit, -1.0, 1.0)
    desired_raw = hard * jnp.complex64(0.5 - 0.5j)
    error = desired_raw - raw
    norm = eps + jnp.sum(x_win.real ** 2 + x_win.imag ** 2, axis=-1)
    coeff = state.coeff + (mu / norm)[..., None] * error[..., None] \
        * jnp.conj(x_win)
    dibit = (i_bit.astype(jnp.uint8) << 1) | q_bit.astype(jnp.uint8)
    return EqState(kalman=state.kalman, coeff=coeff), dibit, jnp.abs(error)
