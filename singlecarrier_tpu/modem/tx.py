"""QPSK modulator / TX chain.

JAX port of the reference TX path (reference: src/qpsk.c:251-342):
Gray-mapped QPSK symbols -> x5 zero-stuff upsample -> RRC pulse-shaping
FIR -> upmix to the 1100 Hz carrier -> real part -> int16 quantize
(preamble at half amplitude).  Pure-functional: all reference statics
(tx_filter delay line qpsk.c:39, fbb_tx_phase/rect qpsk.c:47-48) live in
an explicit ``TxState`` pytree; everything jits and vmaps over channels.

The running-phasor-with-renorm loop (qpsk.c:301-306) is replaced by the
closed-form mixer table (dsp/mixer.py); int16 conversion truncates
toward zero exactly like the C cast (qpsk.c:315-317).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModemConfig
from ..constants import PREAMBLE_TABLE, rrc_taps
from ..dsp.fir import fir_block, fir_init_state
from ..dsp.mixer import mix_block, mixer_init_phase


class TxState(NamedTuple):
    fir_tail: jnp.ndarray   # [.., ntaps-1] pulse-shaper delay line
    phase: jnp.ndarray      # [..] carrier phasor


def tx_init(cfg: ModemConfig, batch_shape=()) -> TxState:
    return TxState(
        fir_tail=fir_init_state(cfg.ntaps, batch_shape),
        phase=mixer_init_phase(batch_shape),
    )


def qpsk_mod(bits):
    """Gray map bit pairs -> QPSK symbols (qpsk.c:251-256).

    ``bits``: [..., 2*n] with layout [IQ,IQ,...]: odd index = I, even
    index = Q; bit 1 -> -1, bit 0 -> +1; symbol = I + jQ.
    """
    i = jnp.where(bits[..., 1::2] == 1, -1.0, 1.0)
    q = jnp.where(bits[..., 0::2] == 1, -1.0, 1.0)
    return (i + 1j * q).astype(jnp.complex64)


def qpsk_demod(symbols):
    """Hard QPSK decisions -> bits [..., 2*n], [IQ,...] layout
    (qpsk.c:268-271)."""
    i_bits = (symbols.real < 0.0).astype(jnp.uint8)
    q_bits = (symbols.imag < 0.0).astype(jnp.uint8)
    out = jnp.stack([q_bits, i_bits], axis=-1)       # even=Q, odd=I
    return out.reshape(*symbols.shape[:-1], -1)


def tx_frame(cfg: ModemConfig, state: TxState, symbols, amplitude):
    """Modulate one block of symbols; returns ``(pcm_int16, new_state)``.

    Port of qpsk_tx_frame(samples, symbol, length, preamble)
    (qpsk.c:278-322).  ``amplitude`` is 8192 for preamble frames, 16384
    otherwise (qpsk.c:313-319).
    """
    n_sym = symbols.shape[-1]
    n = n_sym * cfg.cycles
    # x5 zero-stuff (qpsk.c:285-291)
    sig = jnp.zeros((*symbols.shape[:-1], n), jnp.complex64)
    sig = sig.at[..., ::cfg.cycles].set(symbols)
    # RRC pulse shaping (qpsk.c:296)
    taps = rrc_taps(cfg.alpha, cfg.ntaps)
    sig, fir_tail = fir_block(taps, cfg.fir_gain, state.fir_tail, sig)
    # upmix to carrier (qpsk.c:301-306)
    sig, phase = mix_block(sig, state.phase, cfg.center, cfg.fs)
    # real passband, int16 truncation like the C cast (qpsk.c:313-319)
    pcm = (sig.real * amplitude).astype(jnp.int16)
    return pcm, TxState(fir_tail=fir_tail, phase=phase)


def _flushed_gap(cfg: ModemConfig, state: TxState, batch_shape):
    """Run the inter-packet gap zeros through the pulse shaper.

    The reference writes the 903 gap zeros straight to the output
    (qpsk.c:410-412) WITHOUT flushing tx_filter, so the trailing
    ~ntaps/2 samples of each packet's last symbols are never emitted
    and those symbols are unrecoverable at the RX (their pulse is
    truncated).  Production TX filters the gap so the full pulse energy
    lands on air; the gap stays silent except its first ~48 samples.
    """
    zeros = jnp.zeros((*batch_shape, cfg.inter_packet_gap), jnp.complex64)
    taps = rrc_taps(cfg.alpha, cfg.ntaps)
    sig, fir_tail = fir_block(taps, cfg.fir_gain, state.fir_tail, zeros)
    sig, phase = mix_block(sig, state.phase, cfg.center, cfg.fs)
    pcm = (sig.real * cfg.tx_amplitude).astype(jnp.int16)
    return pcm, TxState(fir_tail=fir_tail, phase=phase)


def tx_packet(cfg: ModemConfig, state: TxState, bits, *, scramble_offset=None,
              flush_gap: bool = False):
    """Modulate one full packet: preamble + ns data frames + gap.

    Port of the per-packet TX loop (qpsk.c:380-413).  ``bits``:
    [..., ns, data_symbols*2] payload bits in [IQ,...] layout.  Returns
    ``(pcm[..., packet_size] int16, new_state)``.

    If ``scramble_offset`` is given, payload dibits are scrambled first
    (the reference intended but never wired TX scrambling -- qpsk.c:386,
    397; enabling it restores TX/RX symmetry, SURVEY.md quirk #3).
    """
    pre = jnp.asarray(PREAMBLE_TABLE)
    pre = jnp.broadcast_to(pre, (*bits.shape[:-2], cfg.preamble_length))
    pcm_pre, state = tx_frame(cfg, state, pre, cfg.preamble_amplitude)

    if scramble_offset is not None:
        from ..scramble import scramble_dibits
        dibits = (bits[..., 1::2] << 1) | bits[..., 0::2]
        flat = dibits.reshape(*dibits.shape[:-2], -1)
        flat, _ = scramble_dibits(flat, scramble_offset)
        dibits = flat.reshape(dibits.shape)
        bits = jnp.stack(
            [dibits & 1, dibits >> 1], axis=-1
        ).reshape(bits.shape)

    chunks = [pcm_pre]
    for j in range(cfg.ns):
        syms = qpsk_mod(bits[..., j, :])
        pcm_j, state = tx_frame(cfg, state, syms, cfg.tx_amplitude)
        chunks.append(pcm_j)
    if flush_gap:
        gap, state = _flushed_gap(cfg, state, bits.shape[:-2])
    else:
        gap = jnp.zeros((*bits.shape[:-2], cfg.inter_packet_gap), jnp.int16)
    chunks.append(gap)
    return jnp.concatenate(chunks, axis=-1), state


def tx_stream(cfg: ModemConfig, bits, *, scramble: bool = False,
              flush_gap: bool = False):
    """Modulate a multi-packet stream (the reference main TX loop,
    qpsk.c:373-415).

    ``bits``: [..., n_packets, ns, data_symbols*2].  Returns int16 PCM
    [..., n_packets * packet_size].
    """
    n_packets = bits.shape[-3]
    state = tx_init(cfg, bits.shape[:-3])
    out = []
    for k in range(n_packets):
        # Per-packet keystream reset (the DVB frame-sync intent,
        # scramble.c:14-16), matching the production RX.
        off = 0 if scramble else None
        pcm, state = tx_packet(cfg, state, bits[..., k, :, :],
                               scramble_offset=off, flush_gap=flush_gap)
        out.append(pcm)
    return jnp.concatenate(out, axis=-1)
