"""Tiny fixed-size linear algebra, unrolled.

``jnp.linalg.solve`` on a 6x6 system lowers to a loopy LU custom call (a
separate library call per solve). Every Gauss-Newton step in this framework
solves a 6x6 SPD system (JtJ + damping), so the solve is fully unrolled
scalar arithmetic that XLA fuses into the surrounding kernel.
"""

from __future__ import annotations

import jax.numpy as jnp


def solve_spd6(A, b):
    """Solve ``A x = b`` for a 6x6 symmetric positive-definite ``A`` via
    fully unrolled Cholesky (no loops, no custom calls — fuses to ~zero).

    Gauss-Newton callers always add a damping diagonal, which keeps ``A``
    PD even when the residual system is rank-deficient. The sqrt guard only
    triggers on pathological all-zero systems, where the result is harmless
    garbage that the caller's isfinite/fitness gate rejects.
    """
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6  # forward substitution: L y = b
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6  # back substitution: L^T x = y
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)
