"""Closed-form least-squares equalizer (production path).

The reference trains its 5-tap equalizer with 128 sequential
square-root-Kalman updates (reference: src/equalizer.c:45-58,
src/kalman.c:85-141).  That recursion is (a) the only serial
dependency in the whole RX (SURVEY.md hard-part #1) and (b) numerically
divergent beyond ~100 updates with the reference's q=0.08 process-noise
inflation (observed on the reference itself: training error grows to
~1e3 over a 128-chip burst).

The production path replaces the recursion with the *batch* solution of
the same least-squares problem the RLS is approximating:

    coeff = argmin || C @ coeff - p ||^2 + reg*||coeff||^2

where C[t, i] = sym[lag + t + i] are the chip windows and p the known
+/-1 preamble.  This is two small matmuls (C^H C is 5x5, C^H p
is 5) and one 5x5 solve -- fully parallel over channels, numerically
exact, and it removes the 128-step scan from the hot path entirely.
Decoding then applies the frozen filter to all 248 data windows as one
matmul, followed by a vectorized decision-directed phase/frequency
refinement (no scan either).

The Kalman/RLS scan machinery (adaptive/kalman.py) remains the faithful
path and the API-parity surface.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..utils.linalg import chol_solve_hermitian


def window_matrix(symbols, start, count: int, L: int, *,
                  center: bool = True):
    """C[t, i] = symbols[start + t + i - off] for t<count, i<L.

    With ``center`` (production default) the target symbol sits at the
    middle tap (off = L//2) so the equalizer sees symmetric ISI; with
    ``center=False`` the window starts AT the target, the reference's
    alignment (equalizer.c:48: in[index..index+4]).  ``start`` may be
    traced (per-channel under vmap); dynamic_slice clamps at the array
    edge, so callers should keep start >= L//2.
    """
    off = L // 2 if center else 0
    s = lax.dynamic_slice_in_dim(symbols, start - off, count + L - 1)
    cols = [lax.slice_in_dim(s, i, i + count) for i in range(L)]
    return jnp.stack(cols, axis=-1)


def _ridge_diag(L: int, reg: float, offtap_reg) -> np.ndarray:
    """Scale-relative ridge diagonal: ``reg`` on the center tap,
    ``offtap_reg`` on the others (the shrinkage prior toward the
    pure-delay solution -- config.ls_offtap_reg rationale).  ``None``
    recovers the uniform ridge."""
    d = np.full(L, reg if offtap_reg is None else offtap_reg,
                np.float32)
    d[L // 2] = reg
    return np.diag(d)


def ls_train(symbols, lag, pn, L: int, reg: float = 1e-4,
             offtap_reg=None):
    """Fit the equalizer on the preamble; returns ``(coeff, matches)``.

    Solves the regularized normal equations of the training problem the
    reference's RLS chases (equalizer.c:48-53: val = sum in*coeff, no
    conjugation; ref is the real +/-1 chip).

    Args:
      symbols: [n] complex decimated window.
      lag:     preamble start (traced ok).
      pn:      [P] float +/-1 chips.
      L:       equalizer length.
      reg:     center-tap ridge regularization.
      offtap_reg: off-center-tap ridge (shrinkage toward pure delay;
               None = uniform ``reg``).  The training chips transmit
               at quarter power, so unshrunk off-taps carry ~0.8 dB
               of estimation noise on an ISI-free channel
               (config.ls_offtap_reg).

    Returns:
      coeff:   [L] complex filter.
      matches: i32 count of sign agreements of the fitted output with
               the chips (the detection statistic, qpsk.c:111-123
               semantics on the converged filter).
    """
    P = pn.shape[-1]
    C = window_matrix(symbols, lag, P, L)            # [P, L]
    pnc = pn.astype(jnp.complex64)
    # HIGHEST precision throughout: a reduced-precision dot (bf16
    # passes, or TF32 on a GPU) corrupts the normal equations enough
    # to flip decoded bits.  These matmuls are tiny (<= [248, 5]).
    hi = lax.Precision.HIGHEST
    A = jnp.matmul(C.conj().mT, C, precision=hi)      # [L, L] hermitian
    # Scale-aware ridge: reg relative to the mean window power.
    scale = (jnp.trace(A, axis1=-2, axis2=-1).real / L)[..., None, None]
    A = A + scale * jnp.asarray(_ridge_diag(L, reg, offtap_reg),
                                A.dtype) \
        + 1e-12 * jnp.eye(L, dtype=A.dtype)
    b = jnp.matmul(C.conj().mT, pnc[..., None],
                   precision=hi)[..., 0]             # [L]
    # Unrolled Cholesky: batched tiny systems as elementwise arithmetic
    # instead of a generic LU (utils/linalg.py).
    coeff = chol_solve_hermitian(A, b)
    val = jnp.matmul(C, coeff[..., None], precision=hi)[..., 0]
    matches = jnp.sum((val.real * pn) > 0.0, axis=-1).astype(jnp.int32)
    return coeff, matches


def ls_decode(symbols, start, coeff, n_data: int):
    """Apply the frozen filter to all data windows: one matmul.

    Returns raw filter outputs [n_data] in the training domain
    (raw = s * (1-j)/2 for transmitted symbol s; see
    adaptive/equalizer.py data_step_coherent for the algebra).
    """
    L = coeff.shape[-1]
    C = window_matrix(symbols, start, n_data, L)
    return jnp.matmul(C, coeff[..., None],
                      precision=lax.Precision.HIGHEST)[..., 0]


def slice_qpsk(raw):
    """Hard decisions from raw training-domain outputs.

    Returns (dibits u8, hard_raw): hard_raw is the ideal raw-domain
    point for the decision (for error metrics / phase refinement).
    """
    sym = raw * jnp.complex64(1.0 + 1.0j)
    i_bit = (sym.real < 0.0)
    q_bit = (sym.imag < 0.0)
    hard = jnp.where(i_bit, -1.0, 1.0) + 1j * jnp.where(q_bit, -1.0, 1.0)
    hard_raw = hard * jnp.complex64(0.5 - 0.5j)
    dibit = (i_bit.astype(jnp.uint8) << 1) | q_bit.astype(jnp.uint8)
    return dibit, hard_raw


def ls_refit(symbols, start, coeff, n_data: int, reg: float = 1e-3,
             offtap_reg=None, n_fit: int = 0):
    """Decision-directed LS refit on the data section.

    The preamble transmits at HALF the data amplitude (qpsk.c:313-319),
    so the training fit sees 6 dB less SNR than the payload; refitting
    the filter against the hard decisions of a first decode pass
    recovers most of that estimation loss.  One extra pair of matmuls +
    one 5x5 solve; decisions that are wrong act as bounded noise in the
    fit (standard decision-directed LS).

    ``n_fit`` (config.ls_refit_symbols): fit on only the FIRST n_fit
    data windows (0 = all ``n_data``) -- a throughput knob: the refit's
    work scales with the window.

    Returns the refitted coeff.
    """
    L = coeff.shape[-1]
    n_data = n_fit if n_fit else n_data
    C = window_matrix(symbols, start, n_data, L)
    hi = lax.Precision.HIGHEST
    raw = jnp.matmul(C, coeff[..., None], precision=hi)[..., 0]
    _, hard_raw = slice_qpsk(raw)
    # Data amplitude is ~2x training; rescale targets to the data scale
    # so the refit is self-consistent.
    scale = jnp.mean(jnp.abs(raw), axis=-1, keepdims=True) / \
        (jnp.mean(jnp.abs(hard_raw), axis=-1, keepdims=True) + 1e-12)
    target = hard_raw * scale
    A = jnp.matmul(C.conj().mT, C, precision=hi)
    tr = (jnp.trace(A, axis1=-2, axis2=-1).real / L)[..., None, None]
    A = A + tr * jnp.asarray(_ridge_diag(L, reg, offtap_reg),
                             A.dtype) \
        + 1e-12 * jnp.eye(L, dtype=A.dtype)
    b = jnp.matmul(C.conj().mT, target[..., None],
                   precision=hi)[..., 0]
    return chol_solve_hermitian(A, b)


def _refine_err(x):
    """Amplitude-normalized mean decision distance (the refine guard's
    acceptance metric; also the reported eq_error)."""
    _, hard = slice_qpsk(x)
    s = jnp.mean(jnp.abs(x), axis=-1, keepdims=True) + 1e-9
    return jnp.mean(jnp.abs(x / s - hard / jnp.abs(hard)), axis=-1)


def phase_refine(raw, iterations: int = 3):
    """Decision-directed phase/frequency refinement, fully vectorized.

    Models the residual impairment as raw_k * exp(j(a + b k)) (constant
    phase + linear ramp = residual CFO after the FFT search) and
    estimates (a, b) from the decision rotors z_k = raw_k *
    conj(hard_raw_k): b from the average phase increment
    angle(sum z_{k+1} conj(z_k)), a from angle(sum z_k e^{-jbk}).
    No sequential loop.

    Each iteration's correction is GUARDED: applied only where it does
    not increase the mean decision distance.  Without the guard,
    iterating past the point where the true residual is corrected
    ACCUMULATES estimator noise (each pass adds an independently noisy
    clamped (a, b)) -- measured +0.7 dB BER loss at 4-6 dB SNR for 2
    unguarded iterations vs 1, and +2 dB at 5 iterations.  With the
    guard, extra iterations only help (they extend the correction
    range for residuals beyond one clamp step): measured loss vs QPSK
    theory is < 0.3 dB across 2-6 dB SNR and 0-35 Hz CFO at 3 guarded
    iterations, vs 0.6-1.0 dB for the previous 2 unguarded ones.

    Returns (corrected_raw, dibits, mean_abs_error).
    """
    n = raw.shape[-1]
    k = jnp.arange(n, dtype=jnp.float32)
    cur = raw
    # Clamp corrections: the bulk CFO is already removed by the FFT
    # search and the LS fit, so the genuine residual is small; an
    # unclamped decision-directed estimator can lock 90 degrees off at
    # low SNR (decisions and corrections reinforce each other).
    a_max = np.float32(np.pi / 8.0)
    b_max = np.float32(np.pi / 8.0 / max(n, 1))
    for _ in range(iterations):
        dibits, hard_raw = slice_qpsk(cur)
        z = cur * jnp.conj(hard_raw)
        inc = jnp.sum(z[..., 1:] * jnp.conj(z[..., :-1]), axis=-1)
        b = jnp.clip(jnp.angle(inc), -b_max, b_max)
        derot = jnp.exp(-1j * b[..., None] * k).astype(jnp.complex64)
        z0 = jnp.sum(z * derot, axis=-1)
        a = jnp.clip(jnp.angle(z0), -a_max, a_max)
        cand = cur * (jnp.exp(-1j * a)[..., None] * derot
                      ).astype(jnp.complex64)
        keep = (_refine_err(cand) <= _refine_err(cur))[..., None]
        cur = jnp.where(keep, cand, cur)
    dibits, hard_raw = slice_qpsk(cur)
    # Amplitude-normalized decision error: the preamble trains at half
    # the data amplitude (qpsk.c:313-319), so raw data magnitude is ~2x
    # the constellation's; decisions are angle-based and unaffected.
    scale = jnp.mean(jnp.abs(cur), axis=-1, keepdims=True) + 1e-9
    err = jnp.mean(jnp.abs(cur / scale - hard_raw / jnp.abs(hard_raw)),
                   axis=-1)
    return cur, dibits, err
