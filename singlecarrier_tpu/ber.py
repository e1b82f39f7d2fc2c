"""BER-vs-SNR measurement harness (BASELINE.json config #3).

The reference has no BER instrumentation at all (its loopback never
compares bits -- SURVEY.md section 4); this module closes the loop:
synthesize known payloads, impair (AWGN/CFO/phase/timing), demodulate,
count.  Everything batched: one jit call runs the whole sweep point.

Theory anchor: coherent QPSK over AWGN has
BER = Q(sqrt(2 Eb/N0)).  With noise injected at passband over the full
fs bandwidth at measured signal power S, Eb/N0 = SNR * fs / (4 rs)
(see snr_to_ebn0_db).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .channel import awgn, channel
from .config import ModemConfig
from .modem.rx_production import prod_rx_init, prod_rx_stream
from .modem.tx import tx_stream


def qpsk_theory_ber(ebn0_db) -> np.ndarray:
    """Q(sqrt(2 Eb/N0)) for coherent Gray-coded QPSK."""
    ebn0 = 10.0 ** (np.asarray(ebn0_db, np.float64) / 10.0)
    return 0.5 * np.array([math.erfc(math.sqrt(x)) for x in
                           np.atleast_1d(ebn0)])


def snr_to_ebn0_db(snr_db, cfg: ModemConfig) -> float:
    """Convert passband SNR (noise across full fs band) to Eb/N0.

    With received passband power S and total noise power N spread over
    the real signal band [0, fs/2]: N0 = N/(fs/2), Eb = S/(2 rs), so
    Eb/N0 = (S/N) * fs / (4 rs).

    CALIBRATION: S must be the power of the DATA
    sections, not the whole frame -- the preamble transmits 6 dB down
    (qpsk.c:313-319; ~34% of the frame at quarter power), so a
    whole-frame power measurement understates the data-section Es/N0
    by ~1.3 dB and makes measured BER appear to beat the coherent-QPSK
    bound.  ber_run therefore measures signal power over the data
    sections only and passes it to the AWGN sampler explicitly; with
    that anchoring, Q(sqrt(2 Eb/N0)) is a true lower bound and the gap
    above it is the pipeline's implementation loss.
    """
    return snr_db + 10.0 * np.log10(cfg.fs / (4.0 * cfg.rs))


def _wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval for k errors in n bits."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    d = 1.0 + z * z / n
    c = (p + z * z / (2 * n)) / d
    h = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / d
    return (max(c - h, 0.0), min(c + h, 1.0))


def data_section_power_mask(cfg: ModemConfig, n_packets: int,
                            n_samples: int) -> np.ndarray:
    """Boolean mask of the full-amplitude DATA samples of a packed
    ``tx_stream`` layout (packet p's data occupies
    [p*packet_size + preamble_size, p*packet_size + frame_size))."""
    pos = np.arange(n_samples)
    rel = pos % cfg.packet_size
    return ((rel >= cfg.preamble_size) & (rel < cfg.frame_size)
            & (pos < n_packets * cfg.packet_size))


def ber_run(cfg: ModemConfig, key, *, snr_db=None, freq_hz=0.0,
            phase_rad=0.0, delay=0.0, ppm=0.0, echoes=(),
            n_packets: int = 10,
            n_trials: int = 4, drop_tail_bits: int = 0,
            path: str = "xla"):
    """One sweep point; returns dict with ber / detection stats.

    ``n_trials`` independent channel realizations run as a vmap batch.
    ``drop_tail_bits`` excludes the final bits of each packet from the
    count (for reference-TX streams whose pulse tails are truncated --
    see modem/tx.py _flushed_gap; our own TX uses flush_gap and needs
    no exclusion).

    Detected packets are matched to sent packets BY STREAM POSITION:
    packet p's preamble starts at sample p*packet_size, and the RX
    reports each detection's absolute position via (block, lag,
    timing_phase); a spurious detect therefore cannot misalign the
    whole trial (the failure mode of order-based zipping).  Multiple
    detections mapping to one sent packet keep the position-closest
    one; undetected packets count as half-errored payload.
    """
    kb, kn = jax.random.split(key)
    bits = jax.random.randint(
        kb, (n_packets, cfg.ns, cfg.data_symbols * 2), 0, 2, jnp.uint8)
    ref = np.asarray(bits).reshape(n_packets, cfg.bits_per_frame)
    pcm = jax.jit(lambda b: tx_stream(cfg, b, flush_gap=True))(bits)

    n_blocks = -(-pcm.shape[-1] // cfg.frame_size) + 1
    padded = jnp.zeros(n_blocks * cfg.frame_size, jnp.float32)
    padded = padded.at[:pcm.shape[-1]].set(pcm.astype(jnp.float32))

    # SNR anchored on the DATA-section power (snr_to_ebn0_db docstring:
    # whole-frame power mixes in the 6 dB-down preamble and overstates
    # theory by ~1.3 dB).  Computed once from the clean stream under
    # jit, fetched as a python float so the trial jits see a constant.
    dmask = jnp.asarray(
        data_section_power_mask(cfg, n_packets, padded.shape[-1]))
    sig_power = float(jax.jit(
        lambda x: jnp.sum(jnp.where(dmask, x * x, 0.0))
        / jnp.maximum(dmask.sum(), 1))(padded))

    keys = jax.random.split(kn, n_trials)

    if path == "xla":
        def one_trial(k, clean):
            x = channel(k, clean, snr_db=snr_db, freq_hz=freq_hz,
                        phase_rad=phase_rad, delay=delay, ppm=ppm,
                        echoes=echoes, fs=cfg.fs,
                        signal_power=sig_power)
            frames = x.reshape(n_blocks, cfg.frame_size)
            _, out = prod_rx_stream(cfg, prod_rx_init(cfg), frames,
                                    descramble=False)
            return out

        out = jax.jit(jax.vmap(one_trial, in_axes=(0, None)))(keys,
                                                              padded)
    elif path == "batch":
        # Trials ride the channel axis of the block-parallel batch core,
        # int16 PCM in (the ADC quantization the core consumes).
        from .modem.rx_production import (prod_rx_batch,
                                          prod_rx_init_planes)

        def all_trials(keys, clean):
            x = jax.vmap(lambda k: channel(
                k, clean, snr_db=snr_db, freq_hz=freq_hz,
                phase_rad=phase_rad, delay=delay, ppm=ppm,
                echoes=echoes, fs=cfg.fs,
                signal_power=sig_power))(keys)             # [T, S]
            fr = x.astype(jnp.int16).reshape(
                n_trials, n_blocks, cfg.frame_size)
            fr = jnp.swapaxes(fr, 0, 1)                # [B, T, n]
            st = prod_rx_init_planes(cfg, n_trials)
            _, o = prod_rx_batch(cfg, st, fr, descramble=False)
            return jax.tree.map(lambda v: jnp.swapaxes(v, 0, 1), o)

        out = jax.jit(all_trials)(keys, padded)
    else:
        raise ValueError(f"unknown path {path!r}")

    valid = np.asarray(out.valid)
    got = np.asarray(out.bits)
    lag = np.asarray(out.lag)
    phs = np.asarray(out.timing_phase)

    total_bits = 0
    err_bits = 0
    detected = 0
    false_detects = 0
    sl = slice(None, None if drop_tail_bits == 0 else -drop_tail_bits)
    for t in range(n_trials):
        vidx = np.nonzero(valid[t])[0]
        # hunt window of block b = [prev | cur] -> absolute preamble
        # start sample = (b-1)*frame_size + lag*cycles + phase
        assigned: dict[int, tuple[float, int]] = {}
        for fr in vidx:
            pos = ((int(fr) - 1) * cfg.frame_size
                   + int(lag[t, fr]) * cfg.cycles + int(phs[t, fr]))
            p = int(round(pos / cfg.packet_size))
            perr = abs(pos - p * cfg.packet_size)
            if not 0 <= p < n_packets or perr > cfg.packet_size // 4:
                false_detects += 1
                continue
            if p not in assigned or perr < assigned[p][0]:
                if p in assigned:
                    false_detects += 1
                assigned[p] = (perr, int(fr))
            else:
                # a worse-positioned duplicate of an assigned packet is
                # a false detect too (not silently dropped)
                false_detects += 1
        detected += len(assigned)
        for p, (_, fr) in assigned.items():
            g = got[t, fr][sl]
            r = ref[p][sl]
            total_bits += len(r)
            err_bits += int((g != r).sum())
        # undetected packets count as half-errored payload
        missed = n_packets - len(assigned)
        total_bits += missed * len(ref[0][sl])
        err_bits += missed * (len(ref[0][sl]) // 2)

    ci = _wilson_ci(err_bits, total_bits)
    return {
        "ber": err_bits / max(total_bits, 1),
        "err_bits": err_bits,
        "total_bits": total_bits,
        "ber_ci95": [ci[0], ci[1]],
        "detection_rate": detected / (n_trials * n_packets),
        "false_detects": false_detects,
        "snr_db": snr_db,
        "ebn0_db": None if snr_db is None else snr_to_ebn0_db(snr_db, cfg),
    }


def ber_sweep(cfg: ModemConfig, snrs_db, key=None, **kw):
    """BER at each SNR; returns list of ber_run dicts."""
    key = jax.random.PRNGKey(0) if key is None else key
    out = []
    for i, snr in enumerate(snrs_db):
        out.append(ber_run(cfg, jax.random.fold_in(key, i),
                           snr_db=float(snr), **kw))
    return out
