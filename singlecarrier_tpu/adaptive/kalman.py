"""Square-root (UD-factorized) Kalman/RLS gain estimator.

JAX port of the reference's Hsu-1982 square-root Kalman update
(reference: src/kalman.c:85-141, after "Square Root Kalman Filtering
for High Speed Data Received over Fading Dispersive Channels", IEEE
Trans. IT-28 no.5).  The reference mutates static globals one scalar at
a time; here the state is an explicit pytree ``{u, d}`` and the update
is a pure function, written so every step vectorizes over the
equalizer-tap axis and the whole thing ``vmap``s over channels (the
channel axis is the scaling axis -- per-channel state is ~70
floats, SURVEY.md section 3.3).

Key observation used to vectorize the reference's in-place triangular
loops (kalman.c:125-140): within outer step j, every u[i][j] update
reads the gain vector as it stood at the *start* of step j (gain[i] is
only modified after u[i][j] in the same iteration), and every gain
update reads the *original* column u[:,j]; so each j-step is two masked
rank-1 vector ops.  u stays strictly upper triangular (kalman_reset
zeroes it and only i<j entries are written), so no masking is needed on
the f computation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax



class KalmanState(NamedTuple):
    """UD factors: u strictly-upper [.., L, L] c64, d diagonal [.., L] f32."""
    u: jnp.ndarray
    d: jnp.ndarray


def kalman_init(eq_length: int, batch_shape=()) -> KalmanState:
    """kalman_reset(): u = 0, d = 1 (kalman.c:42-55)."""
    return KalmanState(
        u=jnp.zeros((*batch_shape, eq_length, eq_length), jnp.complex64),
        d=jnp.ones((*batch_shape, eq_length), jnp.float32),
    )


def kalman_update(state: KalmanState, x_win, E: float, q: float):
    """One gain computation; returns ``(new_state, gain, y)``.

    Port of kalman_calculate(x, index) (kalman.c:85-141) with
    ``x_win = x[index : index + L]``.

    Returns:
      new_state: updated UD factors.
      gain:      [.., L] complex kalman_gain (fully updated, as the
                 coefficient update consumes it -- equalizer.c:35-39).
      y:         final kalman_y = 1/(a[L-1] + ht) (kalman.c:130).
    """
    u, d = state
    L = x_win.shape[-1]
    cx = jnp.conj(x_win)

    # 6.2/6.3: f[j] = conj(x[j]) + sum_{i<j} u[i][j] conj(x[i])
    # (kalman.c:89-100); u is strictly upper so the full contraction is
    # exact.
    f = cx + jnp.einsum("...ij,...i->...j", u, cx,
                        precision=lax.Precision.HIGHEST)

    # 6.4: initial gain g = f * d (kalman.c:105-107).
    gain = f * d.astype(jnp.complex64)

    # 6.5/6.6: prefix sums a[j] = E + sum_{k<=j} Re(g[k] conj(f[k]))
    # (kalman.c:109-113).
    prods = (gain * jnp.conj(f)).real
    a = E + jnp.cumsum(prods, axis=-1)

    hq = 1.0 + q                      # 6.7 (kalman.c:115)
    ht = a[..., L - 1] * q            # (kalman.c:117)
    y = 1.0 / (a[..., 0] + ht)        # 6.19 (kalman.c:119)

    new_d = [d[..., 0] * hq * (E + ht) * y]   # 6.20 (kalman.c:121)

    # 6.10-6.16 recursion, one masked rank-1 pair per j (kalman.c:125-140).
    rows = jnp.arange(L)
    for j in range(1, L):
        B = a[..., j - 1] + ht                        # 6.21
        h_j = -f[..., j] * y.astype(jnp.complex64)    # 6.11
        y = 1.0 / (a[..., j] + ht)                    # 6.22
        new_d.append(d[..., j] * hq * B * y)          # 6.13

        col = u[..., :, j]                            # original column
        mask = (rows < j)
        # 6.15: u[i][j] += h[j] * conj(gain_i) for i<j, gain as of step
        # start (kalman.c:137).
        u = u.at[..., :, j].set(
            col + jnp.where(mask, h_j[..., None] * jnp.conj(gain), 0.0))
        # 6.16: gain[i] += gain[j] * conj(u_old[i][j]); col rows >= j are
        # zero so no mask needed (kalman.c:138).
        gain = gain + gain[..., j, None] * jnp.conj(col)

    d_out = jnp.stack(new_d, axis=-1)
    return KalmanState(u=u, d=d_out), gain, y
