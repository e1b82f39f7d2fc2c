"""RX front-end: int16 PCM -> downmixed, matched-filtered, decimated.

Two forms of the same chain (reference: src/qpsk.c:138-162 -- downmix,
RRC matched filter; decimation is a reshape):

* ``frontend_reference`` -- the per-channel complex form built from
  ``dsp/mixer.mix_block`` and ``dsp/fir.fir_block``; the oracle.
* ``frontend_planes`` -- the batched form the block-parallel receiver
  runs over every (block, channel) pair at once.  The downmix is
  elementwise on real/imag planes; the RRC and all ``cycles``
  decimation phases are ONE dense matmul against a banded tap matrix
  whose columns are ordered (phase, symbol), so the output lands in the
  hunt-window layout ``[..., cycles, 2, n_sym]`` without a separate
  decimation pass.  The matmul runs at ``Precision.HIGHEST`` (full
  float32): the equalizer's least-squares fit downstream is sensitive
  to a TF32-rounded matched filter.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import ModemConfig
from ..constants import rrc_taps
from .fir import fir_block
from .mixer import mix_block, mixer_table

# Symbols per matmul tile: a tile is a [cycles*TILE_SYM + ntaps - 1]
# sample window times a [.., cycles*TILE_SYM] band.  Wider tiles waste
# MACs on the band's zeros; narrower ones duplicate more halo input.
TILE_SYM = 32


@functools.lru_cache(maxsize=8)
def decim_band_matrix(alpha: float, ntaps: int, cyc: int,
                      tile_sym: int) -> np.ndarray:
    """T[j*cyc + c + k, c*tile_sym + j] = taps[k] (float32).

    ``window @ T`` gives, for a window starting at sample s, the FIR
    output at sample s + j*cyc + c in column (c, j): every decimation
    phase of ``tile_sym`` consecutive symbols.
    """
    taps = rrc_taps(alpha, ntaps)
    win = cyc * tile_sym + ntaps - 1
    t = np.zeros((win, cyc * tile_sym), np.float32)
    for c in range(cyc):
        for j in range(tile_sym):
            r0 = j * cyc + c
            t[r0:r0 + ntaps, c * tile_sym + j] = taps
    return t


def frontend_planes(cfg: ModemConfig, pcm, ph_r, ph_i, tail_r, tail_i):
    """Batched downmix + RRC + decimation.

    ``pcm``: [M, frame_size] int16; ``ph_r``/``ph_i``: [M] mixer phasor
    at the start of each row's block; ``tail_r``/``tail_i``: [M,
    ntaps-1] downmixed FIR halo entering each block (the last ntaps-1
    downmixed samples of the previous block).  Returns [M, cycles, 2,
    symbols_per_block] float32: real/imag planes of every decimation
    phase -- the same values as ``frontend_reference`` followed by
    ``filtered.reshape(n_sym, cycles).T``.
    """
    n = cfg.frame_size
    halo = cfg.ntaps - 1
    cyc = cfg.cycles
    n_sym = cfg.symbols_per_block
    M = pcm.shape[0]

    table = mixer_table(-cfg.center, cfg.fs, n)
    tr = jnp.asarray(table.real)
    ti = jnp.asarray(table.imag)
    x = pcm.astype(jnp.float32) / cfg.tx_amplitude
    # phase * table first, then x * that: the mix_block order
    mr = ph_r[:, None] * tr - ph_i[:, None] * ti
    mi = ph_r[:, None] * ti + ph_i[:, None] * tr
    ext = jnp.stack([jnp.concatenate([tail_r, x * mr], -1),
                     jnp.concatenate([tail_i, x * mi], -1)], 1)

    tile_sym = TILE_SYM
    step = cyc * tile_sym
    ntiles = -(-n_sym // tile_sym)
    win = step + halo
    pad = (ntiles - 1) * step + win - ext.shape[-1]
    if pad > 0:
        ext = jnp.pad(ext, ((0, 0), (0, 0), (0, pad)))
    windows = jnp.stack(
        [lax.slice_in_dim(ext, j * step, j * step + win, axis=-1)
         for j in range(ntiles)], axis=2)            # [M, 2, tiles, win]
    band = jnp.asarray(decim_band_matrix(cfg.alpha, cfg.ntaps, cyc,
                                         tile_sym))
    y = jnp.einsum("mpjw,wt->mpjt", windows, band,
                   precision=lax.Precision.HIGHEST) * cfg.fir_gain
    y = y.reshape(M, 2, ntiles, cyc, tile_sym).transpose(0, 3, 1, 2, 4)
    return y.reshape(M, cyc, 2, ntiles * tile_sym)[..., :n_sym]


def frontend_reference(cfg: ModemConfig, pcm, phase, tail):
    """Oracle: mixer + FIR (dsp/mixer.py, dsp/fir.py) on one block;
    returns ``(filtered, new_tail, new_phase)``."""
    x = pcm.astype(jnp.float32) / cfg.tx_amplitude
    raw, new_phase = mix_block(x, phase, -cfg.center, cfg.fs)
    taps = rrc_taps(cfg.alpha, cfg.ntaps)
    filt, new_tail = fir_block(taps, cfg.fir_gain, tail, raw)
    return filt, new_tail, new_phase
