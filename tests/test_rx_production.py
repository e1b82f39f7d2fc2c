"""Production-RX tests: full-payload decode, CFO tolerance, impairments.

Covers BASELINE.json configs #1 (full decode of the golden stream) and
#2 (carrier frequency + phase offset lock).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from singlecarrier_tpu.channel import awgn, channel
from singlecarrier_tpu.config import DEFAULT_CONFIG as CFG
from singlecarrier_tpu.modem import make_prod_rx_fn, prod_rx_init, tx_stream


def _frames(pcm):
    """Pad to whole frames + one extra silent frame so the 1-block hunt
    latency flushes the final packet."""
    pcm = np.asarray(pcm)
    n = -(-len(pcm) // CFG.frame_size) + 1
    buf = np.zeros(n * CFG.frame_size, pcm.dtype)
    buf[:len(pcm)] = pcm
    return jnp.asarray(buf.reshape(n, CFG.frame_size))


def _run(pcm, descramble=False):
    fn = make_prod_rx_fn(CFG, descramble=descramble)
    state, out = fn(prod_rx_init(CFG), _frames(pcm))
    return jax.tree.map(np.asarray, out)


def _packet_bits(out, n_packets=10):
    """Collect decoded packets in order."""
    got = out.bits[out.valid]
    return got


def test_decodes_every_packet_of_harness_stream(golden):
    """All 10 packets of the C-generated stream.

    The reference TX truncates each packet's final pulse tail (the 903
    gap zeros bypass tx_filter -- qpsk.c:410-412), so the last few
    symbols of every packet are damaged ON AIR; all bits before the
    tail must decode exactly.
    """
    out = _run(golden["tx_pcm"])
    assert out.valid.sum() == 10
    ref = golden["tx_bits"].reshape(10, CFG.bits_per_frame)
    got = _packet_bits(out)
    assert got.shape == (10, CFG.bits_per_frame)
    # exact except the TX-truncated tail (last 5 symbols = 10 bits)
    assert np.array_equal(got[:, :-10], ref[:, :-10])
    assert np.mean(got != ref) < 0.02   # tail-only damage
    assert np.all(out.matches[out.valid] >= 120)


def test_flushed_tx_decodes_bit_exact():
    """Production TX (gap filtered through the pulse shaper) -> RX:
    every bit of every packet, including the packet tails."""
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (10, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = tx_stream(CFG, jnp.asarray(bits), flush_gap=True)
    out = _run(np.asarray(pcm))
    assert out.valid.sum() == 10
    got = _packet_bits(out)
    assert np.array_equal(got, bits.reshape(10, CFG.bits_per_frame))


def test_detects_all_packets_in_shipped_golden_vector(golden_raw):
    out = _run(golden_raw)
    assert out.valid.sum() == 10
    assert np.all(out.matches[out.valid] >= 120)
    # no spurious zero-window detects (the faithful path inherits them
    # from the C -- the energy gate kills them here)
    assert not out.valid[0]


def test_fractional_delay_decodes_bit_exact():
    """Sub-sample timing offsets decode exactly, frac_timing on or off.

    At 5x oversampling the symbol-spaced LS equalizer absorbs the
    residual <=0.5-sample timing error (measured: slicer error flat vs
    injected delay), so frac_timing defaults off; this pins both paths.
    """
    from singlecarrier_tpu.channel import fractional_delay
    from singlecarrier_tpu.modem.rx_production import (prod_rx_init,
                                                       prod_rx_stream)
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, (4, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    pcm = tx_stream(CFG, jnp.asarray(bits), flush_gap=True)
    delayed = np.asarray(fractional_delay(pcm.astype(jnp.float32), 0.4))
    for cfg in (CFG, CFG.replace(frac_timing=True)):
        fn = jax.jit(lambda st, fr, c=cfg: prod_rx_stream(
            c, st, fr, descramble=False))
        _, out = fn(prod_rx_init(cfg), _frames(delayed.astype(np.int16)))
        out = jax.tree.map(np.asarray, out)
        assert out.valid.sum() == 4
        got = out.bits[out.valid]
        assert np.array_equal(got, bits.reshape(4, CFG.bits_per_frame))


def test_no_false_detects_on_noise():
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 1000, 10 * CFG.frame_size).astype(np.int16)
    out = _run(noise)
    assert out.valid.sum() == 0


def test_cfo_lock_and_decode(golden):
    """Config #2: fixed carrier offset + phase offset, full decode.

    The reference breaks at a few Hz of offset (coherent 128-chip
    correlation); the production hunt + FFT CFO search must lock at
    tens of Hz.
    """
    pcm = jnp.asarray(golden["tx_pcm"])
    ref = golden["tx_bits"].reshape(10, CFG.bits_per_frame)
    for f in (7.0, 25.0, -40.0):
        key = jax.random.PRNGKey(1)
        impaired = channel(key, pcm, freq_hz=f, phase_rad=1.1, fs=CFG.fs)
        out = _run(np.asarray(impaired))
        assert out.valid.sum() == 10, f"lost packets at CFO {f} Hz"
        got = _packet_bits(out)
        ber = np.mean(got[:, :-10] != ref[:, :-10])
        assert ber == 0.0, f"BER {ber} at CFO {f} Hz"
        cfos = out.cfo_hz[out.valid]
        assert np.all(np.abs(cfos - f) < 3.0), f"CFO est {cfos} vs {f}"


def test_awgn_decode_10db(golden):
    """Config #3 anchor: at 10 dB SNR every packet decodes with low BER."""
    pcm = jnp.asarray(golden["tx_pcm"])
    ref = golden["tx_bits"].reshape(10, CFG.bits_per_frame)
    key = jax.random.PRNGKey(2)
    noisy = awgn(key, pcm, 10.0)
    out = _run(np.asarray(noisy))
    assert out.valid.sum() == 10
    got = _packet_bits(out)
    ber = np.mean(got[:, :-10] != ref[:, :-10])
    assert ber < 0.01, f"BER {ber} at 10 dB"


def test_scramble_symmetric_loopback():
    """TX scramble on + RX descramble on == clean payload roundtrip
    (the symmetry the reference intended, SURVEY.md quirk #3)."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)
    # per-packet keystream reset on both sides
    from singlecarrier_tpu.scramble import scramble_dibits
    dibits = (bits[..., 1::2] << 1) | bits[..., 0::2]
    flat = dibits.reshape(3, -1)
    scrambled = np.stack([np.asarray(scramble_dibits(jnp.asarray(r), 0)[0])
                          for r in flat])
    sb = np.stack([scrambled & 1, scrambled >> 1], axis=-1)
    tx_scrambled_bits = sb.reshape(3, CFG.ns, CFG.data_symbols * 2)

    pcm = tx_stream(CFG, jnp.asarray(tx_scrambled_bits), flush_gap=True)
    out = _run(np.asarray(pcm), descramble=True)
    assert out.valid.sum() == 3
    got = _packet_bits(out, 3)
    assert np.array_equal(got, bits.reshape(3, CFG.bits_per_frame))


def test_batched_channels_with_different_offsets(golden):
    """Config #4 seed: channels with independent CFOs demodulate
    independently under vmap."""
    pcm = jnp.asarray(golden["tx_pcm"])
    ref = golden["tx_bits"].reshape(10, CFG.bits_per_frame)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    offsets = [0.0, 15.0, -30.0]
    stack = np.stack([
        np.asarray(channel(k, pcm, freq_hz=f, snr_db=20.0, fs=CFG.fs))
        for k, f in zip(keys, offsets)])
    frames = jnp.stack([_frames(row) for row in stack])
    fn = make_prod_rx_fn(CFG, descramble=False, batched=True)
    state, out = fn(prod_rx_init(CFG, (3,)), frames)
    out = jax.tree.map(np.asarray, out)
    for c in range(3):
        assert out.valid[c].sum() == 10
        got = out.bits[c][out.valid[c]]
        assert np.mean(got[:, :-10] != ref[:, :-10]) < 0.01


def test_batch_rejects_frac_timing():
    """The batch core runs integer timing only; a frac_timing config
    must raise instead of silently losing the feature (the scan oracle
    prod_rx_stream has it), for the complex and the plane state."""
    from singlecarrier_tpu.modem.rx_production import (prod_rx_batch,
                                                   prod_rx_init_planes)

    cfg = CFG.replace(frac_timing=True)
    pcm = jnp.zeros((2, 2, CFG.frame_size), jnp.int16)
    with pytest.raises(ValueError, match="frac_timing"):
        prod_rx_batch(cfg, prod_rx_init(cfg, (2,)), pcm)
    with pytest.raises(ValueError, match="frac_timing"):
        prod_rx_batch(cfg, prod_rx_init_planes(cfg, 2), pcm)


def test_energy_normalized_hunt_rescues_cfo_edge():
    """cfg.hunt_norm="energy" (default since round 5): under the
    raw-power argmax ("none", the round<=4 behavior) the full-
    amplitude DATA sections' correlation sidelobes out-compete the
    CFO-decohered true peak (measured: Pd 0.84 at 4 dB/40 Hz, 0.10 at
    50 Hz, misses landing mid-packet); the energy-normalized statistic
    rescues every one (config.hunt_norm docstring)."""
    import functools

    C, P = 16, 3
    rng = np.random.default_rng(77)
    bits = rng.integers(0, 2, (C, P, CFG.ns, CFG.data_symbols * 2),
                        dtype=np.uint8)

    @functools.partial(jax.jit, static_argnames=("f",))
    def mk(bits_dev, key, f):
        pcm = tx_stream(CFG, bits_dev, flush_gap=True, scramble=True)
        nb = -(-pcm.shape[-1] // CFG.frame_size) + 1
        pad = nb * CFG.frame_size - pcm.shape[-1]
        x = jnp.pad(pcm.astype(jnp.float32), ((0, 0), (0, pad)))
        keys = jax.random.split(key, C)
        x = jax.vmap(lambda k, s: channel(
            k, s, snr_db=4.0, freq_hz=f, fs=CFG.fs))(keys, x)
        return x.astype(jnp.int16).reshape(C, -1, CFG.frame_size)

    from singlecarrier_tpu.modem.rx_production import prod_rx_stream

    def detections(cfg, pcm):
        out = jax.jit(jax.vmap(
            lambda p: prod_rx_stream(cfg, prod_rx_init(cfg), p,
                                     descramble=True)[1]))(pcm)
        out = jax.tree.map(np.asarray, out)
        det = 0
        for c in range(C):
            assigned = set()
            for fr in np.nonzero(out.valid[c])[0]:
                pos = ((int(fr) - 1) * CFG.frame_size
                       + int(out.lag[c, fr]) * CFG.cycles
                       + int(out.timing_phase[c, fr]))
                p = int(round(pos / CFG.packet_size))
                if (0 <= p < P and abs(pos - p * CFG.packet_size)
                        <= CFG.packet_size // 4):
                    assigned.add(p)
            det += len(assigned)
        return det

    # 40 Hz (the claimed tolerance edge): every packet detects under
    # BOTH normalizers (espan = the shipped default, energy = the
    # per-phase variant it generalizes).
    pcm = mk(jnp.asarray(bits), jax.random.PRNGKey(1), 40.0)
    assert detections(CFG, pcm) == C * P
    assert detections(CFG.replace(hunt_norm="energy"), pcm) == C * P
    assert detections(CFG.replace(hunt_norm="none"), pcm) < C * P
    # 50 Hz (beyond the design point): near-complete vs collapsed.
    pcm = mk(jnp.asarray(bits), jax.random.PRNGKey(1), 50.0)
    assert detections(CFG, pcm) >= int(0.9 * C * P)
    assert detections(CFG.replace(hunt_norm="energy"),
                      pcm) >= int(0.9 * C * P)
    assert detections(CFG.replace(hunt_norm="none"), pcm) <= C * P // 2


def test_batch_handles_non_128_multiple_channels():
    """C=192 (not a power of two) runs through the batch core with both
    state types, and silence detects nothing."""
    from singlecarrier_tpu.modem.rx_production import (
        prod_rx_batch, prod_rx_init_planes)

    C = 192
    pcm = jnp.zeros((1, C, CFG.frame_size), jnp.int16)
    fn = jax.jit(lambda s, p: prod_rx_batch(CFG, s, p))
    for st in (prod_rx_init(CFG, (C,)), prod_rx_init_planes(CFG, C)):
        _, out = fn(st, pcm)
        assert np.asarray(out.valid).shape == (1, C)
        assert not np.asarray(out.valid).any()


@pytest.mark.parametrize("cfo_hz", [-29.0, -7.3, 0.0, 12.5, 30.0])
def test_cfo_estimate_matches_float64_spectrum(cfo_hz):
    """The CFO search keeps full float32 precision: on noisy,
    CFO-rotated preamble chips its estimate equals the one read from a
    float64 FFT of the same chips (same peak bin, same parabolic
    interpolation) to a tenth of a millihertz (a bf16 spectrum misses it
    by ~1 mHz), and lies within a third of a bin (rs/nfft) of the true
    offset."""
    from singlecarrier_tpu.constants import PREAMBLE_VALUES
    from singlecarrier_tpu.dsp.fftops import estimate_cfo

    rng = np.random.default_rng(int(1000 + cfo_hz * 10))
    pn = PREAMBLE_VALUES.astype(np.float64)
    k = np.arange(pn.size)
    chips = (pn * (1 + 1j) * 0.5
             * np.exp(2j * np.pi * cfo_hz * k / CFG.rs + 0.7j))
    chips = chips + 0.1 * (rng.standard_normal(pn.size)
                           + 1j * rng.standard_normal(pn.size))
    got, _ = estimate_cfo(jnp.asarray(chips.astype(np.complex64)),
                          jnp.asarray(pn.astype(np.float32)), CFG.rs,
                          nfft=CFG.cfo_nfft)

    nfft = CFG.cfo_nfft
    power = np.abs(np.fft.fft(chips.astype(np.complex64) * pn, nfft)) ** 2
    b = int(np.argmax(power))
    pm, p0, pp = power[(b - 1) % nfft], power[b], power[(b + 1) % nfft]
    kf = b + 0.5 * (pm - pp) / (pm - 2 * p0 + pp)
    want = (kf - nfft if kf > nfft / 2 else kf) * CFG.rs / nfft

    assert abs(float(got) - want) < 1e-4
    assert abs(float(got) - cfo_hz) < CFG.rs / nfft / 3
