"""Carrier mixing (baseband <-> passband translation).

Replacement for the reference's iterated running phasor
(reference: src/qpsk.c:138-147 RX downmix, qpsk.c:301-306 TX upmix).
The C code multiplies ``phase *= rect`` once per sample and renormalizes
once per frame to fight float drift (qpsk.c:147, 306).  Here the
relative phasor ramp ``exp(j w (n+1))`` for a block is a *constant
table* computed once in float64 on the host, so per block the mixer is
one complex multiply per sample: ``out = x * (phase0 * table)``; the
carried state is a single unit phasor per stream, renormalized per
block exactly like the reference.  This kills the drift hack and the
serial dependency at once; float32 differences vs the iterated product
stay well inside the modem's SNR bound (documented deviation,
SURVEY.md section 2 quirk #9).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np



def mixer_init_phase(batch_shape=()):
    """Initial unit phasor: cmplx(0) = 1+0j (qpsk.c:375, 427)."""
    return jnp.ones(batch_shape, jnp.complex64)


@functools.lru_cache(maxsize=32)
def mixer_table(freq_hz: float, fs: float, n: int) -> np.ndarray:
    """Relative ramp ``exp(j*2*pi*freq/fs*(arange(n)+1))`` in complex64.

    Computed in float64 so the angle never loses precision to float32
    argument reduction.  Index n-1 is the per-block phase advance.
    """
    w = 2.0 * np.pi * freq_hz / fs
    return np.exp(1j * w * (np.arange(1, n + 1))).astype(np.complex64)


def downmix_tail(center: float, fs: float, n: int, halo: int,
                 x_t, ph_r, ph_i):
    """Downmixed FIR-tail planes from RAW tail samples (closed form).

    ``x_t``: [..., halo] f32 last-halo raw samples already scaled to
    matched-filter units; ``ph_r``/``ph_i``: phase planes at the START
    of the block the samples came from, broadcastable against x_t.
    This is the parity-critical carry formula shared by the batch
    core's per-block seeds and carry-out, the gated pipeline's pair
    seeds and the 2D grid's halo seeds -- one definition so they stay
    fp-identical.
    """
    table = mixer_table(-center, fs, n)
    tr = jnp.asarray(table.real[n - halo:])
    ti = jnp.asarray(table.imag[n - halo:])
    return (x_t * (ph_r * tr - ph_i * ti),
            x_t * (ph_r * ti + ph_i * tr))


def mix_block(x, phase, freq_hz: float, fs: float):
    """Mix a block; returns ``(y, new_phase)``.

    Matches the reference loop ``phase *= rect; y = x * phase``
    (qpsk.c:139-141 with negative freq for RX downmix, qpsk.c:302-303
    for TX upmix) followed by the per-frame renorm (qpsk.c:147, 306).

    Args:
      x:       [..., n] block (complex, or real PCM already scaled).
      phase:   [...] carried unit phasor.
      freq_hz: mix frequency (negative to downmix).
      fs:      sample rate.
    """
    n = x.shape[-1]
    table = jnp.asarray(mixer_table(float(freq_hz), float(fs), int(n)))
    y = x * (phase[..., None] * table)
    new_phase = phase * table[n - 1]
    new_phase = new_phase / jnp.abs(new_phase)
    return y, new_phase
