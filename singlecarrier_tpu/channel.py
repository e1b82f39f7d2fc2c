"""Channel impairment models (AWGN / CFO / phase / timing / gain).

The reference's only impairment knob is the compile-time FOFFSET
carrier offset (reference: src/qpsk.c:67).  Here every impairment is a
jit-able sampler over int16 passband PCM so BER sweeps (BASELINE.json
configs #2/#3) and fault-injection tests run batched on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def apply_cfo_phase(pcm, freq_hz: float, phase_rad: float, fs: float,
                    n0=0):
    """Apply carrier frequency + phase offset to real passband PCM.

    Shifts the passband signal via its analytic form: for a real
    passband signal this is approximated by mixing with
    cos(2 pi f t + phi) on the analytic (hilbert) signal; for the small
    offsets the modem tracks (|f| << center) we use the exact
    complex route: analytic signal -> rotate -> real part.
    """
    x = pcm.astype(jnp.float32)
    n = x.shape[-1]
    xa = _analytic(x)
    t = (jnp.arange(n) + n0) / fs
    rot = jnp.exp(1j * (2.0 * np.pi * freq_hz * t + phase_rad)
                  ).astype(jnp.complex64)
    return (xa * rot).real


def _analytic(x):
    """Analytic signal via FFT (one-sided spectrum doubling)."""
    n = x.shape[-1]
    X = jnp.fft.fft(x, axis=-1)
    h = jnp.zeros(n, jnp.float32)
    h = h.at[0].set(1.0)
    if n % 2 == 0:
        h = h.at[n // 2].set(1.0)
        h = h.at[1:n // 2].set(2.0)
    else:
        h = h.at[1:(n + 1) // 2].set(2.0)
    return jnp.fft.ifft(X * h, axis=-1)


def awgn(key, pcm, snr_db: float, *, signal_power=None):
    """Add white Gaussian noise at the given SNR (dB) to float PCM.

    ``signal_power``: mean square of the signal; measured from the
    active (nonzero) samples if not given.
    """
    x = pcm.astype(jnp.float32)
    if signal_power is None:
        active = jnp.abs(x) > 0
        signal_power = jnp.sum(x * x) / jnp.maximum(jnp.sum(active), 1)
    noise_power = signal_power / (10.0 ** (snr_db / 10.0))
    noise = jax.random.normal(key, x.shape) * jnp.sqrt(noise_power)
    return x + noise


def multipath(pcm, echoes):
    """Discrete multipath: x + sum_i g_i * x[n - d_i] (passband echo
    taps).  ``echoes``: list of (delay_samples:int, gain:float).  The
    reference's equalizer exists for exactly this impairment but its
    harness never models it (the only knob is FOFFSET, qpsk.c:67);
    this sampler closes that gap for equalizer-capability tests."""
    x = pcm.astype(jnp.float32)
    out = x
    for d, g in echoes:
        pad = [(0, 0)] * (x.ndim - 1) + [(int(d), 0)]
        out = out + jnp.float32(g) * jnp.pad(x, pad)[..., :x.shape[-1]]
    return out


def timing_offset(pcm, shift: int):
    """Integer-sample timing shift (zero-padded roll)."""
    x = pcm.astype(jnp.float32)
    return jnp.roll(x, shift, axis=-1)


def sample_rate_offset(pcm, ppm: float, *, order: int = 8):
    """Continuous sample-rate offset (clock drift / skew).

    Models a receiver ADC whose clock runs ``ppm`` parts-per-million
    fast relative to the transmitter: output sample n is the input
    waveform evaluated at t = n * (1 + ppm*1e-6), i.e. the timing
    error grows linearly over the stream -- the impairment
    ``rx_timing`` exists to absorb in the reference
    (src/qpsk.c:53, 157-162).  Implemented as an ``order``-tap Lagrange
    interpolator; at order=8 the residual distortion on the modem band
    (tops out at (center + (1+alpha) rs/2)/fs ~ 0.27) is below -60 dBc.

    ``ppm`` must be static (a Python float): sample positions and
    interpolation weights are computed at trace time in float64 (a
    float32 position grid would quantize timing by ~3e-3 samples at
    sample 50k, a larger error than the interpolator's own).

    Samples whose interpolation stencil would run off either end are
    zero (stream edges; irrelevant to mid-stream BER).
    """
    x = pcm.astype(jnp.float32)
    n = x.shape[-1]
    m = order // 2
    pos = np.arange(n, dtype=np.float64) * (1.0 + float(ppm) * 1e-6)
    i0 = np.floor(pos).astype(np.int64)
    mu = pos - i0
    valid = (i0 >= m - 1) & (i0 + m <= n - 1)
    ic = np.clip(i0, m - 1, n - 1 - m)
    offs = np.arange(-(m - 1), m + 1)
    out = jnp.zeros_like(x)
    for k in offs:
        w = np.ones(n, np.float64)
        for j in offs:
            if j != k:
                w *= (mu - j) / (k - j)
        out = out + (jnp.asarray(w.astype(np.float32))
                     * jnp.take(x, jnp.asarray(ic + k), axis=-1))
    return jnp.where(jnp.asarray(valid), out, 0.0)


def fractional_delay(pcm, delay: float, *, ntaps: int = 33):
    """Fractional-sample delay via a windowed-sinc interpolator."""
    x = pcm.astype(jnp.float32)
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(n - delay) * np.hamming(ntaps)
    h = (h / h.sum()).astype(np.float32)
    pad = (ntaps - 1) // 2
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)])
    out = jax.lax.conv_general_dilated(
        xp.reshape(-1, 1, xp.shape[-1]),
        jnp.asarray(h).reshape(1, 1, -1),
        window_strides=(1,), padding="VALID")
    return out.reshape(x.shape)


def channel(key, pcm, *, snr_db=None, freq_hz=0.0, phase_rad=0.0,
            delay=0.0, ppm=0.0, gain=1.0, fs: float = 8000.0,
            signal_power=None, echoes=()):
    """Composite impairment: CFO/phase -> delay -> drift -> multipath
    -> gain -> AWGN.

    ``signal_power``: reference power for the SNR (pre-``gain`` units;
    scaled by gain^2 internally).  Default measures the mean square of
    the active samples -- note that for framed streams with a
    reduced-amplitude preamble that mixes preamble and data power, so
    BER harnesses that anchor against data-section theory should pass
    the data-section power explicitly (ber.py does).

    Returns float32 passband samples (quantize with
    ``.astype(jnp.int16)`` if int16 is required downstream).
    """
    x = pcm.astype(jnp.float32)
    if freq_hz != 0.0 or phase_rad != 0.0:
        x = apply_cfo_phase(x, freq_hz, phase_rad, fs)
    if delay != 0.0:
        x = fractional_delay(x, delay)
    if ppm != 0.0:
        x = sample_rate_offset(x, ppm)
    if echoes:
        x = multipath(x, echoes)
    x = x * gain
    if snr_db is not None:
        sp = None if signal_power is None else signal_power * gain * gain
        x = awgn(key, x, snr_db, signal_power=sp)
    return x
