"""FFT utilities + FFT-based carrier-frequency-offset search.

The reference ships a KISS-FFT derivative that is compiled but never
called (reference: src/fft.c, included only at src/qpsk.c:20 --
SURVEY.md quirk #4); the north-star design promotes it to a live
feature: FFT-based frequency-offset search.  The FFT itself is
``jnp.fft`` (XLA); this module implements the modem-level feature:

  CFO estimation from the preamble: the received preamble chips are
  r[k] ~ a * p[k] * exp(j(2 pi df k / RS + phi)); multiplying by the
  known +/-1 chips strips the modulation, leaving a pure tone whose
  zero-padded-FFT peak (with parabolic interpolation) is the offset.
  Unambiguous range +/- RS/2.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def fft(x, n=None, axis=-1):
    """Complex FFT (the reference's fft(), fft.h:48)."""
    return jnp.fft.fft(x, n=n, axis=axis)


def ifft(x, n=None, axis=-1):
    return jnp.fft.ifft(x, n=n, axis=axis)


def rfft(x, n=None, axis=-1):
    """Real-input FFT (the reference's fftr wrappers, fft.c:52-186)."""
    return jnp.fft.rfft(x, n=n, axis=axis)


def irfft(x, n=None, axis=-1):
    return jnp.fft.irfft(x, n=n, axis=axis)


def estimate_cfo(chips, pn, symbol_rate: float, *, nfft: int = 512):
    """Estimate carrier offset (Hz) from received preamble chips.

    Args:
      chips: [..., P] received complex chips at the symbol rate.
      pn:    [P] known +/-1 chip sequence (modulation wipe-off).
      symbol_rate: chips per second.
      nfft:  zero-padded FFT length (resolution = rs/nfft before
             interpolation).

    Returns (cfo_hz, peak_power): both [...]-shaped float32.
    """
    # wipe off +/-1 modulation (pn is the real +/-1 chip sequence)
    tone = chips * pn
    # Zero-padded float32 FFT of each row: the estimate is read from the
    # peak bin's parabolic interpolation, so the spectrum keeps full
    # precision, and each row's transform is independent of the batch.
    spec = jnp.fft.fft(tone, n=nfft, axis=-1)
    power = spec.real ** 2 + spec.imag ** 2
    k = jnp.argmax(power, axis=-1)

    # Parabolic interpolation around the peak for sub-bin accuracy.
    km = (k - 1) % nfft
    kp = (k + 1) % nfft
    pm = jnp.take_along_axis(power, km[..., None], -1)[..., 0]
    p0 = jnp.take_along_axis(power, k[..., None], -1)[..., 0]
    pp = jnp.take_along_axis(power, kp[..., None], -1)[..., 0]
    denom = pm - 2.0 * p0 + pp
    delta = jnp.where(jnp.abs(denom) > 1e-20,
                      0.5 * (pm - pp) / denom, 0.0)
    kf = k.astype(jnp.float32) + delta
    # Map bin to signed frequency.
    kf = jnp.where(kf > nfft / 2, kf - nfft, kf)
    return kf * (symbol_rate / nfft), p0


def wipeoff_rotation(n_sym: int, cfo_hz, symbol_rate: float):
    """Rotation ``exp(-j 2 pi cfo k / rs)`` to de-rotate symbols after a
    CFO estimate; ``cfo_hz`` may be traced (per-channel)."""
    k = jnp.arange(n_sym, dtype=jnp.float32)
    ang = -2.0 * np.pi * cfo_hz[..., None] / symbol_rate * k
    return jnp.exp(1j * ang).astype(jnp.complex64)
