"""Preamble correlation (sync hunt).

Replaces the reference's 128-lag sliding-window loop (reference:
src/qpsk.c:176-183 calling correlate() at qpsk.c:88-96) with a single
complex matmul: the lag windows form a banded Toeplitz structure, so
``corr = d_window @ W`` with ``W[i+k, i] = preamble[k]`` computes all
lags at once, batched over channels.

The reference correlator multiplies ``preambletable[i] * symbol[j]``
WITHOUT conjugation (qpsk.c:92) -- it works because every preamble chip
shares the same 45-degree phase (qpsk.c:361-365).  We replicate the
non-conjugated form exactly for parity (SURVEY.md quirk #6).

``window_energy`` replicates magnitude() (qpsk.c:101-109) for all lags
at once via a cumulative sum.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
from jax import lax



@functools.lru_cache(maxsize=8)
def preamble_corr_matrix(pre_key, n_lags: int) -> np.ndarray:
    """W[n_lags + P - 1, n_lags] complex with W[i+k, i] = pre[k]."""
    pre = np.asarray(pre_key, dtype=np.complex64)
    p = len(pre)
    w = np.zeros((n_lags + p - 1, n_lags), dtype=np.complex64)
    for i in range(n_lags):
        w[i:i + p, i] = pre
    return w


def preamble_correlate(symbols, preamble: np.ndarray, n_lags: int):
    """|sum_k pre[k] * sym[lag+k]|^2 for lag in [0, n_lags).

    Args:
      symbols:  [..., >= n_lags + P - 1] decimated symbols.
      preamble: [P] complex preamble table (concrete constant).
      n_lags:   number of lags to search.

    Returns [..., n_lags] float32 correlation powers
    (matches fabsf(cnormf(out)), qpsk.c:95).
    """
    p = len(preamble)
    w = jnp.asarray(preamble_corr_matrix(
        tuple(np.asarray(preamble, np.complex64)), n_lags))
    d = symbols[..., :n_lags + p - 1]
    out = jnp.matmul(d, w, precision=lax.Precision.HIGHEST)  # [.., n_lags]
    power = out.real ** 2 + out.imag ** 2
    return jnp.abs(power)


def window_energy(symbols, p: int, n_lags: int):
    """sum_{k=lag}^{lag+P-1} |sym[k]|^2 for every lag (qpsk.c:101-109)."""
    e = symbols.real ** 2 + symbols.imag ** 2
    c = jnp.cumsum(e[..., :n_lags + p - 1], axis=-1)
    c = jnp.concatenate([jnp.zeros((*c.shape[:-1], 1), c.dtype), c], axis=-1)
    return c[..., p:p + n_lags] - c[..., :n_lags]
