"""Complex-valued NQS variants.

Counterparts of ``/root/reference/src/nqs/complex_nqs.py``:

* :class:`ComplexNQS` — shared GELU trunk with separate amplitude/phase
  heads, unbounded phase (``complex_nqs.py:13-88``).
* :class:`RBMQuantumState` — Carleo-Troyer restricted Boltzmann machine
  with log-cosh hidden activations (``complex_nqs.py:91-185``); real or
  complex weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from .base import NeuralQuantumState

_normal = jax.nn.initializers.normal

__all__ = ["ComplexNQS", "RBMQuantumState"]


@dataclass(frozen=True)
class ComplexNQS(NeuralQuantumState):
    num_sites: int
    hidden_dims: Sequence[int] = (256, 256)

    def amplitude_and_phase(self, x: jnp.ndarray
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        h = x
        for i, d in enumerate(self.hidden_dims):
            h = jax.nn.gelu(self.dense(h, d, f"Dense_{i}"))
        log_amp = self.dense(h, 1, "amp_head").squeeze(-1)
        phase = self.dense(h, 1, "phase_head").squeeze(-1)
        return log_amp, phase

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.amplitude_and_phase(x)[0]

    def phase(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.amplitude_and_phase(x)[1]


@dataclass(frozen=True)
class RBMQuantumState(NeuralQuantumState):
    """RBM wavefunction: log psi = sum_j a_j s_j + sum_i log cosh(b_i + W_i.s)."""
    num_sites: int
    n_hidden: int = 64
    complex_weights: bool = False

    def _log_psi_parts(self, x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        s = 2.0 * x - 1.0  # spins in {-1, +1}
        if self.complex_weights:
            a_r = self.param("a_real", _normal(0.01),
                             (self.num_sites,))
            a_i = self.param("a_imag", _normal(0.01),
                             (self.num_sites,))
            w_r = self.param("w_real", _normal(0.01),
                             (self.n_hidden, self.num_sites))
            w_i = self.param("w_imag", _normal(0.01),
                             (self.n_hidden, self.num_sites))
            b_r = self.param("b_real", _normal(0.01),
                             (self.n_hidden,))
            b_i = self.param("b_imag", _normal(0.01),
                             (self.n_hidden,))
            a = a_r + 1j * a_i
            w = w_r + 1j * w_i
            b = b_r + 1j * b_i
            z = s @ w.T + b
            log_psi = s @ a + jnp.sum(jnp.log(jnp.cosh(z)), axis=-1)
            return jnp.real(log_psi), jnp.imag(log_psi)
        a = self.param("a", _normal(0.01), (self.num_sites,))
        w = self.param("w", _normal(0.01),
                       (self.n_hidden, self.num_sites))
        b = self.param("b", _normal(0.01), (self.n_hidden,))
        z = s @ w.T + b
        log_psi = s @ a + jnp.sum(
            jnp.abs(z) + jnp.log1p(jnp.exp(-2.0 * jnp.abs(z))) - jnp.log(2.0),
            axis=-1)
        return log_psi, jnp.zeros_like(log_psi)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._log_psi_parts(x)[0]

    def phase(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._log_psi_parts(x)[1]
