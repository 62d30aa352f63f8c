"""Neural quantum state base contract.

JAX counterpart of the reference NQS ABC
(``/root/reference/src/nqs/base.py:11-165``): a model maps occupation
configurations (B, num_sites) to ``log_amplitude`` (and optionally
``phase``); derived quantities (psi, probabilities, normalized
probabilities) are pure functions provided here.

Models are :class:`~.module.Module` dataclasses — parameters live in
pytrees, evaluation is jitted/vmapped by callers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .module import Module

__all__ = ["NeuralQuantumState", "psi", "probability",
           "normalized_probability"]


class NeuralQuantumState(Module):
    """Base class: subclasses implement __call__(x) -> log|psi| (B,).

    ``phase(x)`` defaults to zeros (real wavefunction).
    """

    def phase(self, x: jnp.ndarray) -> jnp.ndarray:
        return jnp.zeros(x.shape[0], dtype=jnp.float32)


def psi(log_amp: jnp.ndarray, phase: jnp.ndarray | None = None) -> jnp.ndarray:
    """Complex amplitude from log|psi| and phase (``base.py:90-107``)."""
    amp = jnp.exp(log_amp)
    if phase is None:
        return amp
    return amp * jnp.exp(1j * phase)


def probability(log_amp: jnp.ndarray) -> jnp.ndarray:
    """|psi|^2 = exp(2 log|psi|) (``base.py:109-120``)."""
    return jnp.exp(2.0 * log_amp)


def normalized_probability(log_amp: jnp.ndarray,
                           mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Batch-normalized |psi|^2 with a logsumexp partition
    (``base.py:122-142``); optional validity mask."""
    logp = 2.0 * log_amp
    if mask is not None:
        logp = jnp.where(mask, logp, -jnp.inf)
    return jnp.exp(logp - jax.nn.logsumexp(logp))
