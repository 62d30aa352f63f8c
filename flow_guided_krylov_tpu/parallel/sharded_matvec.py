"""Basis-sharded Hamiltonian matvec + Lanczos over a device mesh.

The multi-device scaling path for SKQD/eigensolves (SURVEY.md §5, the
BASELINE stretch goal): the subspace Hamiltonian's rows — the determinant
('basis') dimension — are sharded over ALL mesh devices (both the 'data'
and 'basis' axes combined, so every device owns a determinant block no
matter how the mesh is factored), state vectors are replicated, and the
matvec's partial results land sharded — XLA inserts the all-gathers from
the sharding annotations.

Works for dense row blocks (small subspaces) and ELL row blocks (fixed
row degree); one device is the 1x1 mesh, same code path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["shard_hamiltonian_rows", "sharded_matvec_fn",
           "sharded_lanczos_expm", "sharded_lanczos_ground_state"]

# determinant-axis sharding: rows spread over every device in the mesh
ROWS = P(("data", "basis"), None)


def shard_hamiltonian_rows(mesh: Mesh, h_dense: jnp.ndarray) -> jnp.ndarray:
    """Place H with its rows (determinant axis) sharded over ALL devices."""
    return jax.device_put(h_dense, NamedSharding(mesh, ROWS))


def sharded_matvec_fn(mesh: Mesh):
    """Return mv(H_sharded, x_replicated) -> y (row-sharded result)."""

    @jax.jit
    def mv(h_sharded, x):
        x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P()))
        y = jnp.dot(h_sharded, x, precision=jax.lax.Precision.HIGHEST)
        return jax.lax.with_sharding_constraint(
            y, NamedSharding(mesh, P(("data", "basis"))))

    return mv


def sharded_lanczos_expm(mesh: Mesh, h_sharded: jnp.ndarray,
                         psi_re: jnp.ndarray, psi_im: jnp.ndarray,
                         dt: float, m: int
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """exp(-i dt H)|psi> with the matvec sharded over the mesh: the dense
    propagator of ``krylov.skqd.lanczos_expm``, whose jitted sweep
    inherits the row sharding of ``h_sharded``."""
    from ..krylov.skqd import lanczos_expm
    return lanczos_expm(h_sharded, psi_re, psi_im, dt, m)


def sharded_lanczos_ground_state(mesh: Mesh, h_sharded: jnp.ndarray,
                                 m: int = 60,
                                 v0: Optional[jnp.ndarray] = None
                                 ) -> Tuple[float, jnp.ndarray]:
    """Lowest eigenpair with row-sharded matvecs: the device Lanczos of
    ``postprocessing.eigensolver.lanczos_ground_state``, whose jitted
    sweep inherits the row sharding of ``h_sharded``."""
    from ..postprocessing.eigensolver import lanczos_ground_state
    return lanczos_ground_state(h_sharded, m=m, v0=v0)
