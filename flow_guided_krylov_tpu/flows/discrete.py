"""Discrete flow sampler: RealNVP over a bimodal prior, sign-discretized.

Counterpart of ``/root/reference/src/flows/discrete_flow.py``: a continuous
masked-affine (RealNVP) normalizing flow over R^n with a two-mode
(+/-1 Gaussian mixture) prior; discrete configurations are obtained by
sign thresholding, and discrete probabilities p(x) = integral of the
continuous density over the orthant R_x are estimated by Monte Carlo with
a logsumexp accumulator (``discrete_flow.py:21-364``).

The reference uses the external ``normflows`` library for the coupling
layers (``discrete_flow.py:18,71-79``); this rebuild implements masked
affine coupling directly in JAX (SURVEY.md §2.9) — no external deps,
jit/vmap friendly, explicit PRNG keys.

This is the fallback sampler for non-particle-conserving (spin) systems;
molecular pipelines use :class:`ParticleConservingFlow`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.module import Module

__all__ = ["DiscreteFlowSampler", "MultiModalPrior"]


class MultiModalPrior:
    """Per-dimension mixture 0.5 N(+1, s^2) + 0.5 N(-1, s^2)
    (reference ``discrete_flow.py:319-364``)."""

    def __init__(self, n_dims: int, sigma: float = 0.5):
        self.n_dims = n_dims
        self.sigma = sigma

    def sample(self, key: jax.Array, batch: int) -> jnp.ndarray:
        k1, k2 = jax.random.split(key)
        modes = 2.0 * jax.random.bernoulli(
            k1, 0.5, (batch, self.n_dims)).astype(jnp.float32) - 1.0
        return modes + self.sigma * jax.random.normal(
            k2, (batch, self.n_dims))

    def log_prob(self, z: jnp.ndarray) -> jnp.ndarray:
        def comp(mu):
            return (-0.5 * ((z - mu) / self.sigma) ** 2
                    - jnp.log(self.sigma) - 0.5 * jnp.log(2 * jnp.pi))
        lp = jnp.logaddexp(comp(1.0), comp(-1.0)) - jnp.log(2.0)
        return lp.sum(-1)


@dataclass(frozen=True)
class DiscreteFlowSampler(Module):
    """RealNVP + bimodal prior + sign discretization."""

    n_sites: int
    n_layers: int = 6
    hidden: int = 128
    prior_sigma: float = 0.5

    @property
    def prior(self) -> MultiModalPrior:
        return MultiModalPrior(self.n_sites, self.prior_sigma)

    def _coupling_nets(self, i: int, x: jnp.ndarray
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Masked affine coupling ``i``: (log-scale, shift) of the
        transformed half, conditioned on the pass-through half (mask 1)."""
        m = jnp.arange(self.n_sites) % 2
        mask = m if i % 2 == 0 else 1 - m
        with self.scope(f"coupling_{i}"):
            h = jax.nn.relu(self.dense(x * mask, self.hidden, "Dense_0"))
            h = jax.nn.relu(self.dense(h, self.hidden, "Dense_1"))
            s = jnp.tanh(self.dense(h, self.n_sites, "Dense_2")) * 2.0
            t = self.dense(h, self.n_sites, "Dense_3")
        return s * (1 - mask), t * (1 - mask)

    # ------------------------------------------------------------------

    def forward(self, z: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        logdet = jnp.zeros(z.shape[0])
        y = z
        for i in range(self.n_layers):
            s, t = self._coupling_nets(i, y)
            y = y * jnp.exp(s) + t
            logdet = logdet + s.sum(-1)
        return y, logdet

    def inverse(self, y: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        logdet = jnp.zeros(y.shape[0])
        z = y
        for i in reversed(range(self.n_layers)):
            s, t = self._coupling_nets(i, z)
            z = (z - t) * jnp.exp(-s)
            logdet = logdet - s.sum(-1)
        return z, logdet

    def continuous_log_prob(self, y: jnp.ndarray) -> jnp.ndarray:
        z, logdet = self.inverse(y)
        return self.prior.log_prob(z) + logdet

    # ------------------------------------------------------------------

    def sample(self, key: jax.Array, batch: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Sample discrete configs (B, n) in {0,1} + continuous log-probs."""
        z = self.prior.sample(key, batch)
        y, logdet = self.forward(z)
        configs = (y > 0).astype(jnp.float32)
        log_probs = self.prior.log_prob(z) - logdet
        return configs, log_probs

    def estimate_discrete_prob(self, key: jax.Array, configs: jnp.ndarray,
                               n_mc: int = 64) -> jnp.ndarray:
        """MC estimate of p(x) = int_{orthant} p_Y(y) dy
        (reference ``discrete_flow.py:217-288``).

        Importance samples from a proposal centered on the sign pattern,
        zero-weights points outside the orthant, and averages p_Y/q in
        log space.
        """
        signs = 2.0 * configs - 1.0                      # (B, n)
        B, n = configs.shape
        sigma = self.prior_sigma
        eps = jax.random.normal(key, (n_mc, B, n))
        y = signs[None] + sigma * eps                    # proposal samples
        inside = jnp.all((y * signs[None]) > 0, axis=-1)  # in orthant
        log_q = (-0.5 * eps ** 2 - jnp.log(sigma)
                 - 0.5 * jnp.log(2 * jnp.pi)).sum(-1)
        log_p = jax.vmap(self.continuous_log_prob)(y)
        log_w = jnp.where(inside, log_p - log_q, -jnp.inf)
        return jnp.exp(jax.nn.logsumexp(log_w, axis=0) - jnp.log(n_mc))

    def log_prob(self, key: jax.Array, configs: jnp.ndarray,
                 n_mc: int = 64) -> jnp.ndarray:
        return jnp.log(self.estimate_discrete_prob(key, configs, n_mc)
                       + 1e-30)
