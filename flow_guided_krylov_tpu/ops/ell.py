"""ELL sparse matvec for subspace Hamiltonians.

The particle-conserving subspace Hamiltonian has FIXED row degree: every
determinant couples to exactly C others (plus the diagonal), so ELL format
is exact (no padding waste):

    out[i] = diag[i] * psi[i] + sum_c elems_t[c, i] * psi[tgt_t[c, i]]

The tables are stored transposed, (C, N): each connection slot c is one
contiguous N-row.

The matvec is one gather-multiply-sum expression, which XLA fuses into a
single pass over the tables (no (C, N) intermediate).  Measured on an
H100 (700 W) at TFIM-24 (2^24 rows, C = 24): 1.26 ms per matvec, 81 % of
the device-memory bandwidth roofline, against 3.94 ms (26 %) for a
``lax.scan`` over the C rows that re-reads and re-writes its accumulator
every step (``tools/measure_device_routes.py``).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["ell_spmv"]


def ell_spmv(diag: jnp.ndarray, elems_t: jnp.ndarray, tgt_t: jnp.ndarray,
             psi: jnp.ndarray) -> jnp.ndarray:
    """ELL matvec over (C, N) transposed tables."""
    return diag * psi + (elems_t * psi[tgt_t]).sum(0)
