"""QPSK demodulator / RX chain.

JAX port of the reference RX path (reference: src/qpsk.c:133-239):
downmix -> RRC matched filter -> decimate-by-5 -> 128-lag preamble
correlation hunt -> square-root-Kalman-trained equalizer over the 128
known chips -> threshold detect -> decision-directed slicing of 31 data
symbols -> descramble.

Design (SURVEY.md section 7): every reference static becomes a field of
the explicit per-channel ``RxState`` pytree; the per-frame step is a
pure ``(cfg, state, pcm) -> (state, out)`` function; ``vmap`` adds the
channel axis (the 1M-channel scaling axis) and ``lax.scan`` adds the
frame/time axis.  The hot blocks (FIR, correlation) are matmuls;
the only serial core is the 159-step Kalman/equalizer recursion, kept
as a ``lax.scan`` whose state is ~70 floats per channel.

Faithful-mode quirks replicated bit-for-bit (SURVEY.md section 2):
 * 2-frame latency through the input/decimated double buffers
   (qpsk.c:143-144, 160-161): the hunt window is the frame received two
   blocks ago.
 * the hunt searches only lags 0..127 of the 752-symbol window
   (qpsk.c:176-183).
 * non-conjugated correlation (qpsk.c:92).
 * ``rx_timing`` is overwritten with the sync *symbol index* on detect
   (qpsk.c:219) and then used as a sample-phase decimation offset into
   the combined [filtered prev | raw current] buffer (qpsk.c:161) --
   reads past the filtered half land in raw undecimated samples, as in
   the C.
 * the miss branch keeps running the decision-directed equalizer at
   ``rx_timing`` and accumulates an EOF cost (qpsk.c:225-236).
 * the (vestigial) hunt/process state variable is carried but never
   read, as in the C (qpsk.c:217, 234; SURVEY.md quirk #5).

The intended-semantics production path (full-window hunt, stable fine
timing, CFO search) lives in modem/rx_production.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..adaptive.equalizer import EqState, data_step, eq_init, train_step
from ..config import ModemConfig
from ..constants import PREAMBLE_TABLE, PREAMBLE_VALUES, rrc_taps
from ..dsp.correlate import preamble_correlate, window_energy
from ..dsp.decimate import decimate_at
from ..dsp.fir import fir_block, fir_init_state
from ..dsp.mixer import mix_block, mixer_init_phase

HUNT = 0
PROCESS = 1


class RxState(NamedTuple):
    """Per-channel demodulator state (~70 floats + buffers).

    Maps 1:1 onto the reference statics listed in SURVEY.md section 2
    (DP row): phase (qpsk.c:50), fir_tail (qpsk.c:40 via fir.c:30-34),
    raw_prev / decim_prev (the double buffers, qpsk.c:41-42),
    rx_timing (qpsk.c:53), scramble_offset (scramble.c:42), sm_state
    (qpsk.c:37).
    """
    phase: jnp.ndarray            # [..] c64 downmix phasor
    fir_tail: jnp.ndarray         # [.., ntaps-1] c64 matched-filter halo
    raw_prev: jnp.ndarray         # [.., frame_size] c64 raw downmixed prev frame
    decim_prev: jnp.ndarray       # [.., frame_size//cycles] c64 prev symbols
    rx_timing: jnp.ndarray        # [..] i32 decimation offset / sync index
    scramble_offset: jnp.ndarray  # [..] i32 RX keystream position (dibits)
    sm_state: jnp.ndarray         # [..] i32 vestigial hunt/process flag


class RxOut(NamedTuple):
    """Per-frame outputs (the reference's return, printf stats and bits
    buffer -- qpsk.c:196-238)."""
    valid: jnp.ndarray       # [..] bool frame detected
    bits: jnp.ndarray        # [.., data_symbols*2] u8, [IQ,...] layout
    matches: jnp.ndarray     # [..] i32 trained-chip sign matches (of 128)
    max_index: jnp.ndarray   # [..] i32 correlation peak lag
    max_value: jnp.ndarray   # [..] f32 correlation peak power
    mean: jnp.ndarray        # [..] f32 window energy at the peak
    eof_cost: jnp.ndarray    # [..] f32 miss-branch accumulated error


def rx_init(cfg: ModemConfig, batch_shape=()) -> RxState:
    n_sym = cfg.symbols_per_block
    return RxState(
        phase=mixer_init_phase(batch_shape),
        fir_tail=fir_init_state(cfg.ntaps, batch_shape),
        raw_prev=jnp.zeros((*batch_shape, cfg.frame_size), jnp.complex64),
        decim_prev=jnp.zeros((*batch_shape, n_sym), jnp.complex64),
        rx_timing=jnp.full(batch_shape, cfg.fine_timing_offset, jnp.int32),
        scramble_offset=jnp.zeros(batch_shape, jnp.int32),
        sm_state=jnp.full(batch_shape, HUNT, jnp.int32),
    )


def _equalize_and_slice(cfg: ModemConfig, symbols, max_index, rx_timing):
    """Training scan + data scan (qpsk.c:186-236).

    ``symbols``: [n] decimated window (the 752-symbol double buffer).
    Runs the 128-chip training burst at ``max_index`` counting sign
    matches (qpsk.c:111-123), then the 31-symbol decision-directed
    slice at sync_pos on a hit or at ``rx_timing`` on a miss
    (qpsk.c:206-236).  Per-frame equalizer state starts from
    kalman_reset (qpsk.c:186).

    Returns (matches, dibits[31], eof_cost).
    """
    L = cfg.eq_length
    E, q = cfg.kalman_E, cfg.kalman_q
    pre_real = jnp.asarray(PREAMBLE_VALUES.astype(np.float32))

    eq0 = eq_init(L)

    def train_body(carry, t):
        eq, match_count = carry
        win = lax.dynamic_slice_in_dim(symbols, max_index + t, L)
        eq, err = train_step(eq, win, pre_real[t], E, q)
        # match criterion (qpsk.c:117): real(err) * real(ref) > 0
        match_count += (err * pre_real[t] > 0.0).astype(jnp.int32)
        return (eq, match_count), None

    (eq, matches), _ = lax.scan(
        train_body, (eq0, jnp.int32(0)), jnp.arange(cfg.preamble_length))

    hit = matches > cfg.match_threshold
    start = jnp.where(hit, max_index + cfg.preamble_length, rx_timing)

    def data_body(carry, t):
        eq, err_sum = carry
        win = lax.dynamic_slice_in_dim(symbols, start + t, L)
        eq, dibit, err = data_step(eq, win, E, q, cfg.data_eq_error_gain)
        return (eq, err_sum + err), dibit

    (eq, eof_cost), dibits = lax.scan(
        data_body, (eq, jnp.float32(0.0)), jnp.arange(cfg.data_symbols))

    return matches, dibits, eof_cost


def _equalize_and_slice_blocked(cfg: ModemConfig, symbols, max_index,
                                rx_timing, block_size: int):
    """Blocked-scan variant of ``_equalize_and_slice`` (SURVEY.md
    hard-part #1 / the north star's "blocked scan" restructuring).

    Same contract, but the 159-step serial Kalman recursion becomes
    ceil(128/B) + ceil(31/B) frozen-coefficient blocks, each one
    batched filter + ONE information-form RLS update
    (adaptive/blocked_rls.py).  Numerics differ within a block (frozen
    vs per-symbol adaptation) -- verified inside the SNR parity bound
    vs the exact scan in tests/test_blocked_kalman.py.
    """
    from ..adaptive.blocked_rls import (blocked_eq_init, data_block,
                                        train_block)

    L = cfg.eq_length
    P = cfg.preamble_length
    D = cfg.data_symbols
    B = block_size
    lam_B = float((1.0 / (1.0 + cfg.kalman_q)) ** B)
    E = cfg.kalman_E
    pre_real = jnp.asarray(PREAMBLE_VALUES.astype(np.float32))

    st = blocked_eq_init(L, E)

    # ---- training: ceil(P/B) frozen blocks over the known chips ----
    nb_t = -(-P // B)
    pad_t = nb_t * B
    win = lax.dynamic_slice_in_dim(symbols, max_index, pad_t + L - 1)
    Z = jnp.stack([win[i:i + pad_t] for i in range(L)], axis=-1)
    refs = jnp.concatenate(
        [pre_real, jnp.zeros(pad_t - P, jnp.float32)])
    tmask = (jnp.arange(pad_t) < P).astype(jnp.float32)

    matches = jnp.int32(0)
    for b in range(nb_t):
        sl = slice(b * B, (b + 1) * B)
        st, m = train_block(st, Z[sl], refs[sl], tmask[sl], lam_B, E,
                            count_post=(b == 0))
        matches = matches + m

    hit = matches > cfg.match_threshold
    start = jnp.where(hit, max_index + P, rx_timing)

    # ---- data: ceil(D/B) frozen decision-directed blocks ----
    nb_d = -(-D // B)
    pad_d = nb_d * B
    win_d = lax.dynamic_slice_in_dim(symbols, start, pad_d + L - 1)
    W = jnp.stack([win_d[i:i + pad_d] for i in range(L)], axis=-1)
    dmask = (jnp.arange(pad_d) < D).astype(jnp.float32)

    eof_cost = jnp.float32(0.0)
    dib_parts = []
    for b in range(nb_d):
        sl = slice(b * B, (b + 1) * B)
        st, dib, es = data_block(st, W[sl], dmask[sl], lam_B, E,
                                 cfg.data_eq_error_gain)
        dib_parts.append(dib)
        eof_cost = eof_cost + es
    dibits = jnp.concatenate(dib_parts, axis=-1)[..., :D]

    return matches, dibits, eof_cost


def rx_frame(cfg: ModemConfig, state: RxState, pcm, *,
             freq_offset: float = 0.0, blocked: int = 0):
    """Demodulate one frame_size PCM block; returns ``(state, RxOut)``.

    Port of qpsk_rx_frame(in, bits) (qpsk.c:133-239) for a single
    channel; ``jax.vmap`` supplies the channel axis.

    Args:
      pcm: [frame_size] int16 (or float) passband samples.
      freq_offset: RX carrier offset in Hz (the reference's compile-time
        FOFFSET knob, qpsk.c:67).
      blocked: 0 = reference-exact per-symbol Kalman scan (parity
        surface); B > 0 = blocked-scan equalizer with B-symbol frozen
        blocks (``_equalize_and_slice_blocked``) -- ~B x fewer serial
        steps, numerics inside the SNR parity bound.
    """
    n_sym = cfg.symbols_per_block
    taps = rrc_taps(cfg.alpha, cfg.ntaps)

    # 1. int16 -> float, downmix to baseband (qpsk.c:138-147).
    x = pcm.astype(jnp.float32) / cfg.tx_amplitude
    raw_cur, phase = mix_block(
        x, state.phase, -(cfg.center) + freq_offset, cfg.fs)

    # 2. Matched filter the *previous* frame's raw samples (the C filters
    #    input_frame[0..N-1] after the shift -- qpsk.c:143-152), FIR halo
    #    carried across frames.
    filtered_prev, fir_tail = fir_block(
        taps, cfg.fir_gain, state.fir_tail, state.raw_prev)

    # 3. Decimate at rx_timing into the symbol double buffer
    #    (qpsk.c:157-162).  The combined buffer is
    #    [filtered prev | raw current]; a clobbered rx_timing reads into
    #    the raw half exactly as the C reads past index FRAME_SIZE.
    combined = jnp.concatenate([filtered_prev, raw_cur], axis=-1)
    decim_new = decimate_at(combined, state.rx_timing, cfg.cycles, n_sym)
    symbols = jnp.concatenate([state.decim_prev, decim_new], axis=-1)

    # 4. Preamble hunt over 128 lags (qpsk.c:176-183), non-conjugated
    #    correlation (qpsk.c:88-96).
    corr = preamble_correlate(symbols, PREAMBLE_TABLE, cfg.preamble_length)
    max_index = jnp.argmax(corr, axis=-1).astype(jnp.int32)
    max_value = jnp.take_along_axis(corr, max_index[..., None],
                                    axis=-1)[..., 0]
    energy = window_energy(symbols, cfg.preamble_length, cfg.preamble_length)
    mean = jnp.take_along_axis(energy, max_index[..., None], axis=-1)[..., 0]

    # 5. kalman_reset + train + slice (qpsk.c:186-236).
    if blocked:
        matches, dibits, eof_cost = _equalize_and_slice_blocked(
            cfg, symbols, max_index, state.rx_timing, blocked)
    else:
        matches, dibits, eof_cost = _equalize_and_slice(
            cfg, symbols, max_index, state.rx_timing)
    hit = matches > cfg.match_threshold

    # 6. Descramble: the RX LFSR advances 2 bits per data_eq call in both
    #    branches (equalizer.c:87); XOR the precomputed keystream mask.
    from ..scramble import scramble_dibits
    dibits, scramble_offset = scramble_dibits(dibits, state.scramble_offset)

    # bits layout [IQ,IQ,...]: odd=I (dibit>>1), even=Q (qpsk.c:211-214)
    bits = jnp.stack([dibits & 1, dibits >> 1], axis=-1).reshape(
        *dibits.shape[:-1], -1).astype(jnp.uint8)

    # 7. State updates: rx_timing clobber on detect (qpsk.c:219),
    #    vestigial hunt/process transitions (qpsk.c:217, 233-235).
    rx_timing = jnp.where(hit, max_index + cfg.preamble_length,
                          state.rx_timing).astype(jnp.int32)
    sm_state = jnp.where(
        hit, PROCESS,
        jnp.where(eof_cost > cfg.eof_cost_value, HUNT, state.sm_state)
    ).astype(jnp.int32)

    new_state = RxState(
        phase=phase,
        fir_tail=fir_tail,
        raw_prev=raw_cur,
        decim_prev=decim_new,
        rx_timing=rx_timing,
        scramble_offset=scramble_offset,
        sm_state=sm_state,
    )
    out = RxOut(
        valid=hit,
        bits=bits,
        matches=matches,
        max_index=max_index,
        max_value=max_value,
        mean=mean,
        eof_cost=eof_cost,
    )
    return new_state, out


def rx_stream(cfg: ModemConfig, state: RxState, pcm_frames, *,
              freq_offset: float = 0.0, blocked: int = 0):
    """Demodulate a sequence of frames via lax.scan.

    ``pcm_frames``: [n_frames, frame_size].  Returns
    ``(final_state, RxOut stacked over frames)``.  ``blocked`` selects
    the blocked-scan equalizer (see ``rx_frame``).
    """
    def body(st, pcm):
        return rx_frame(cfg, st, pcm, freq_offset=freq_offset,
                        blocked=blocked)

    return lax.scan(body, state, pcm_frames)


def make_rx_stream_fn(cfg: ModemConfig, *, freq_offset: float = 0.0,
                      batched: bool = False):
    """jit-compiled stream demodulator; ``batched`` vmaps over a leading
    channel axis of both state and pcm."""
    def fn(state, pcm_frames):
        return rx_stream(cfg, state, pcm_frames, freq_offset=freq_offset)

    if batched:
        fn = jax.vmap(fn)
    return jax.jit(fn)
