"""Detection-gated two-phase RX: the sparse-deployment wrapper.

The decode tail (CFO search, de-rotation, train, refit, refine) runs
for EVERY block-channel in ``prod_rx_batch``, although only a small
fraction of a monitoring deployment's block-channels detect (the
hit/miss branch the reference takes per frame, reference:
src/qpsk.c:196-236, generalized to masked dataflow).  The gated
receiver splits the batch core in two:

  phase 1  the core cut after the hunt and the energy gate (front-end
           + hunt + extraction + gate, with the same carried stream
           state as the full core).
  compact  shape-static detected-first ordering (argsort of the gate
           flags -- a static-shape substitute for data-dependent
           ``nonzero``) + gather of each detection's (prev, cur) raw
           PCM pair and closed-form mixer-phase / FIR-tail seeds.
  phase 2  the SAME core over the compacted [2, K] pair batch: block 0
           is a halo block that rebuilds the hunt window, block 1 is
           the decode -- decisions identical to the full path
           (tests/test_gated_rx.py, across a dispatch seam too).

The streaming state: a detection at block 0 of a dispatch needs the
PREVIOUS dispatch's last PCM block as its pair's prev, and that pair's
FIR-tail seed needs the raw halo of the block before that.  Both ride
``GatedRxState``, so back-to-back ``prod_rx_batch_gated`` calls decode
boundary-spanning packets exactly like one big dispatch.

K (``max_detections``) is a CAPACITY, not a count: rows past the
number of gate hits decode garbage and are masked by their own phase-2
gate; if more than K block-channels fire, the overflow is reported in
``out["count"]`` (> K means truncation -- size K for the deployment's
density of GATE hits, e.g. 4x the expected hits per dispatch).  The
gate alone fires far more often than the full criterion: on partial
preambles, and on block 0 of a fresh stream, whose previous-block half
is silence.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModemConfig
from ..dsp.mixer import downmix_tail
from .rx_production import (_advances, _carry_out, _rx_core,
                            prod_rx_init_planes)


class GatedRxState(NamedTuple):
    """Streaming state of the gated pipeline.

    ``planes`` is the batch core's plane tuple
    (``prod_rx_init_planes``); the two PCM leaves carry what phase 2
    needs to rebuild a block-0 detection's pair across the dispatch
    seam.
    """
    planes: tuple
    pcm_prev: jnp.ndarray        # [C, n] i16 last block of prev dispatch
    pcm_prev2_tail: jnp.ndarray  # [C, ntaps-1] i16 halo of the block before


def prod_rx_gated_init(cfg: ModemConfig, channels: int) -> GatedRxState:
    return GatedRxState(
        planes=prod_rx_init_planes(cfg, channels),
        pcm_prev=jnp.zeros((channels, cfg.frame_size), jnp.int16),
        pcm_prev2_tail=jnp.zeros((channels, cfg.ntaps - 1), jnp.int16),
    )


def _pair_operands(cfg: ModemConfig, gated, pcm, p0r, p0i, K,
                   pcm_prev, pcm_prev2_tail):
    """Detected-first ordering + gather of the phase-2 pair operands.

    The seeds use the batch core's arithmetic (f64-tabulated
    closed-form phase advances, the shared ``downmix_tail``), with the
    carried cross-dispatch PCM for b < 2.
    """
    n = cfg.frame_size
    halo = cfg.ntaps - 1
    B, C = pcm.shape[0], pcm.shape[1]

    flat = gated.reshape(-1)                       # [B*C] bool
    order = jnp.argsort(~flat)[:K]                 # detected first
    if K > flat.shape[0]:
        # capacity exceeds the dispatch: pad with row 0 -- the pad
        # region sits at i >= count and is masked by the caller's
        # in-capacity mask
        order = jnp.pad(order, (0, K - flat.shape[0]))
    b_idx = order // C
    c_idx = order % C
    pcm_f = pcm.reshape(B * C, n)
    cur = pcm_f[order]
    prev = jnp.where((b_idx > 0)[:, None],
                     pcm_f[jnp.maximum(order - C, 0)],
                     pcm_prev[c_idx])
    # phase entering the PAIR = phase of block b-1 (adv^(b-1); b=0 ->
    # adv^-1 = the phase at the start of the carried prev block, since
    # p0 is the phase AFTER it)
    advm = _advances(cfg, np.arange(B + 1) - 1.0)
    ar = jnp.asarray(advm.real)[b_idx]
    ai = jnp.asarray(advm.imag)[b_idx]
    pr = p0r[c_idx] * ar - p0i[c_idx] * ai
    pi = p0r[c_idx] * ai + p0i[c_idx] * ar
    # FIR tail entering block b-1 = downmixed halo of block b-2's PCM
    advm2 = _advances(cfg, np.arange(B + 1) - 2.0)
    ar2 = jnp.asarray(advm2.real)[b_idx]
    ai2 = jnp.asarray(advm2.imag)[b_idx]
    pr2 = p0r[c_idx] * ar2 - p0i[c_idx] * ai2
    pi2 = p0r[c_idx] * ai2 + p0i[c_idx] * ar2
    raw_t = jnp.where(
        (b_idx > 1)[:, None],
        pcm_f[jnp.maximum(order - 2 * C, 0)][:, n - halo:],
        jnp.where((b_idx == 1)[:, None],
                  pcm_prev[c_idx][:, n - halo:],
                  pcm_prev2_tail[c_idx]))
    x_t = raw_t.astype(jnp.float32) / cfg.tx_amplitude
    tl_r, tl_i = downmix_tail(cfg.center, cfg.fs, n, halo, x_t,
                              pr2[:, None], pi2[:, None])
    return (jnp.stack([prev, cur], 0), pr, pi, tl_r, tl_i,
            order, b_idx, c_idx)


def prod_rx_batch_gated(cfg: ModemConfig, state: GatedRxState,
                        pcm_frames, *, max_detections: int,
                        descramble: bool = True):
    """Two-phase gated RX over [B, C, frame_size] int16 frames.

    Returns ``(state', out)``.  ``out`` holds the phase-1 gate summary
    (``count`` = gate hits this dispatch; > max_detections means
    truncation) plus COMPACTED phase-2 results, each [K]-leading:
    ``valid`` (full criterion: gate AND matches), ``bits``
    [K, bits_per_frame], ``matches``, ``lag``, ``timing_phase``,
    ``peak``, ``energy``, ``cfo_hz``, ``eq_error``, and the stream
    coordinates ``block_idx`` / ``channel_idx`` of each row.
    """
    B = pcm_frames.shape[0]
    n = cfg.frame_size
    halo = cfg.ntaps - 1
    K = max_detections
    p0r, p0i = state.planes[0], state.planes[1]

    # ---- phase 1: gate ----
    gated, dlast = _rx_core(cfg, pcm_frames, state.planes,
                            gate_only=True)
    count = gated.sum().astype(jnp.int32)

    # ---- compact ----
    pairs, pr, pi, tl_r, tl_i, order, b_idx, c_idx = _pair_operands(
        cfg, gated, pcm_frames, p0r, p0i, K,
        state.pcm_prev, state.pcm_prev2_tail)

    # ---- phase 2: decode the compacted pairs (block 0 = halo) ----
    dec, _ = _rx_core(cfg, pairs, (pr, pi, tl_r, tl_i, None),
                      descramble=descramble)
    dec = jax.tree.map(lambda x: x[0], dec)

    in_cap = jnp.arange(K) < jnp.minimum(count, K)
    out = {
        "count": count,
        "block_idx": b_idx.astype(jnp.int32),
        "channel_idx": c_idx.astype(jnp.int32),
        "valid": dec.valid & in_cap,
        "bits": dec.bits,
        "matches": dec.matches,
        "lag": dec.lag,
        "timing_phase": dec.timing_phase,
        "peak": dec.peak,
        "energy": dec.energy,
        "cfo_hz": dec.cfo_hz,
        "eq_error": dec.eq_error,
    }

    new_state = GatedRxState(
        planes=(*_carry_out(cfg, pcm_frames, p0r, p0i), dlast),
        pcm_prev=pcm_frames[-1],
        pcm_prev2_tail=(pcm_frames[-2, :, n - halo:] if B >= 2
                        else state.pcm_prev[:, n - halo:]),
    )
    return new_state, out
