"""Small dense linear algebra, unrolled.

``jnp.linalg.solve`` on a batched tiny complex system lowers to a
generic LU path built for large systems; for the equalizer's L x L (L=5) hermitian
positive-definite normal equations an unrolled Cholesky is pure
vectorized arithmetic -- ~L^2/2 fused elementwise ops over the channel
batch, no loops, no permutations.
"""

from __future__ import annotations

import jax.numpy as jnp


def chol_solve_hermitian(A, b):
    """Solve ``A x = b`` for hermitian positive-definite A (static L).

    A: [..., L, L] complex (only needs to be hermitian PSD + ridge);
    b: [..., L] complex.  Unrolled Cholesky A = C C^H, forward/back
    substitution; everything vectorizes over leading batch dims.
    """
    L = A.shape[-1]
    # Cholesky factor entries c[i][j] (i >= j), each [...]-shaped.
    c = [[None] * L for _ in range(L)]
    for j in range(L):
        s = A[..., j, j].real
        for k in range(j):
            s = s - (c[j][k] * jnp.conj(c[j][k])).real
        d = jnp.sqrt(jnp.maximum(s, 1e-30))
        c[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, L):
            t = A[..., i, j]
            for k in range(j):
                t = t - c[i][k] * jnp.conj(c[j][k])
            c[i][j] = t * inv_d.astype(t.dtype)

    # Forward: C y = b.
    y = [None] * L
    for i in range(L):
        t = b[..., i]
        for k in range(i):
            t = t - c[i][k] * y[k]
        y[i] = t / c[i][i]

    # Back: C^H x = y  (C^H upper triangular with entries conj(c[j][i])).
    x = [None] * L
    for i in reversed(range(L)):
        t = y[i]
        for k in range(i + 1, L):
            t = t - jnp.conj(c[k][i]) * x[k]
        x[i] = t / c[i][i]

    return jnp.stack(x, axis=-1)
