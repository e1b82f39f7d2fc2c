"""Batched streaming complex FIR (RRC pulse shaping / matched filter).

Replacement for the reference's one-sample-at-a-time delay
line (reference: src/fir.c:22-43).  The C code shifts a 49-tap memory
and accumulates ``y = sum_i memory[i] * coeff[i]`` per sample; that is
exactly cross-correlation of the tap vector with the trailing window,
so a whole block filters as one convolution with an
``ntaps-1``-sample carried halo (overlap-save).  Per-stream state is
just the last ``ntaps-1`` input samples.

Two equivalent compute paths:

* ``direct``: ``lax.conv_general_dilated`` over the real/imag planes.
* ``banded``: the convolution recast as a dense matmul against a banded
  [win, tile] matrix (reused across all channels/tiles), so the
  matrix units do the work at large channel counts.

Both orderings reassociate the float32 sum relative to the C loop;
golden tests bound the difference (tests/test_fir.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_TILE = 128  # outputs per banded tile


def fir_init_state(ntaps: int, batch_shape=(), dtype=jnp.complex64):
    """Zero delay-line halo: the last ``ntaps-1`` inputs (fir.c:30-34)."""
    return jnp.zeros((*batch_shape, ntaps - 1), dtype)


@functools.lru_cache(maxsize=16)
def banded_fir_matrix(taps_key, ntaps: int, tile: int = _TILE) -> np.ndarray:
    """Banded matrix W[win, tile] with W[t+k, t] = taps[k].

    ``y_tile = x_window @ W`` computes ``y[t] = sum_k x[t+k] taps[k]``
    for a tile of ``tile`` consecutive outputs, where
    ``win = tile + ntaps - 1``.
    """
    taps = np.asarray(taps_key, dtype=np.float32)
    win = tile + ntaps - 1
    w = np.zeros((win, tile), dtype=np.float32)
    for t in range(tile):
        w[t:t + ntaps, t] = taps
    return w


def _extend(state, x):
    """Prepend the carried halo; split the new halo off the tail."""
    x_ext = jnp.concatenate([state, x], axis=-1)
    new_state = x_ext[..., x.shape[-1]:]
    return x_ext, new_state


def _fir_direct(taps, x_ext, n_out):
    """Cross-correlation via conv_general_dilated on stacked I/Q planes."""
    batch_shape = x_ext.shape[:-1]
    n_ext = x_ext.shape[-1]
    # [2B, 1, n_ext] real planes
    planes = jnp.stack([x_ext.real, x_ext.imag], axis=0)
    planes = planes.reshape(-1, 1, n_ext)
    rhs = jnp.asarray(taps, jnp.float32).reshape(1, 1, -1)
    out = lax.conv_general_dilated(
        planes, rhs, window_strides=(1,), padding="VALID")
    out = out.reshape(2, *batch_shape, n_out)
    return lax.complex(out[0], out[1])


def _fir_banded(taps, x_ext, n_out, tile=_TILE):
    """Overlap-save banded matmul: tiles of ``tile`` outputs."""
    ntaps = len(taps)
    win = tile + ntaps - 1
    ntiles = -(-n_out // tile)
    pad = ntiles * tile + ntaps - 1 - x_ext.shape[-1]
    if pad > 0:
        x_ext = jnp.pad(x_ext, [(0, 0)] * (x_ext.ndim - 1) + [(0, pad)])
    # Overlapping windows: window j covers x_ext[j*tile : j*tile + win].
    windows = jnp.stack(
        [lax.slice_in_dim(x_ext, j * tile, j * tile + win, axis=-1)
         for j in range(ntiles)], axis=-2)           # [..., ntiles, win]
    # taps must be concrete (they are modem constants) for the cached
    # band-matrix build.
    w = jnp.asarray(banded_fir_matrix(tuple(np.asarray(taps, np.float32)),
                                      ntaps, tile))
    # HIGHEST: a reduced-precision dot (bf16 passes, or TF32 on a GPU)
    # puts ~1e-3 relative error on the matched filter, and the
    # downstream LS fits are sensitive to it.
    y = jnp.einsum("...jw,wt->...jt", windows, w,
                   precision=lax.Precision.HIGHEST)   # complex @ real
    y = y.reshape(*y.shape[:-2], ntiles * tile)
    return y[..., :n_out]


def fir_block(taps, gain, state, x, *, method: str = "banded"):
    """Filter one block; returns ``(y, new_state)``.

    Matches ``fir(memory, choice, sample, length)`` (src/fir.c:22-43):
    ``y[t] = gain * sum_k taps[k] * x_cont[t - (ntaps-1) + k]`` where
    ``x_cont`` is the continuous input stream (halo carried in
    ``state``).

    Args:
      taps:  [ntaps] real tap vector (newest-sample tap last, as the C
             delay line orders them).
      gain:  scalar output gain (headers/fir.h:17).
      state: [..., ntaps-1] carried input halo.
      x:     [..., n] complex input block.
    """
    n_out = x.shape[-1]
    x_ext, new_state = _extend(state, x)
    if method == "direct":
        y = _fir_direct(taps, x_ext, n_out)
    elif method == "banded":
        y = _fir_banded(taps, x_ext, n_out)
    else:
        raise ValueError(f"unknown FIR method: {method}")
    return y * gain, new_state
