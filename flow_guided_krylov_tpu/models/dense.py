"""Dense (MLP) neural quantum states.

Counterparts of the reference models (``/root/reference/src/nqs/dense.py``):

* :class:`DenseNQS` — MLP -> scalar with bounded tanh output scaled by a
  learnable ``log_amp_scale`` (``dense.py:13-117``); the model the pipeline
  trains.  Hot-path evaluation optionally runs the hidden layers in
  bfloat16, with float32 accumulation and output.
* :class:`SignedDenseNQS` — shared trunk + amplitude and sign heads
  (phase in {0, pi}) (``dense.py:120-197``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import jax
import jax.numpy as jnp

from .base import NeuralQuantumState

__all__ = ["DenseNQS", "SignedDenseNQS"]

_ACTS = {"relu": jax.nn.relu, "tanh": jnp.tanh, "gelu": jax.nn.gelu,
         "silu": jax.nn.silu}


@dataclass(frozen=True)
class DenseNQS(NeuralQuantumState):
    num_sites: int
    hidden_dims: Sequence[int] = (512, 512, 512, 512)
    activation: str = "relu"
    complex_output: bool = False
    compute_dtype: jnp.dtype = jnp.float32

    def _mlp(self, x: jnp.ndarray, prefix: str) -> jnp.ndarray:
        act = _ACTS[self.activation]
        h = x.astype(self.compute_dtype)
        for i, d in enumerate(self.hidden_dims):
            h = act(self.dense(h, d, f"{prefix}Dense_{i}",
                               dtype=self.compute_dtype))
        return self.dense(h, 1, f"{prefix}Dense_{len(self.hidden_dims)}",
                          dtype=jnp.float32)

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        """x: (B, num_sites) 0/1 floats -> (B,) log|psi|."""
        out = self._mlp(x, "")
        scale = self.param("log_amp_scale", jax.nn.initializers.ones, ())
        return (scale * jnp.tanh(out)).squeeze(-1).astype(jnp.float32)

    def phase_net(self, x: jnp.ndarray) -> jnp.ndarray:
        return self._mlp(x, "phase_").squeeze(-1)

    def phase(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.complex_output:
            return self.phase_net(x)
        return jnp.zeros(x.shape[0], dtype=jnp.float32)


@dataclass(frozen=True)
class SignedDenseNQS(NeuralQuantumState):
    """Shared trunk, amplitude head + sign head (phase in {0, pi})."""
    num_sites: int
    hidden_dims: Sequence[int] = (256, 256)
    activation: str = "relu"

    def _trunk(self, x: jnp.ndarray) -> jnp.ndarray:
        act = _ACTS[self.activation]
        h = x
        for i, d in enumerate(self.hidden_dims):
            h = act(self.dense(h, d, f"Dense_{i}"))
        return h

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        amp = self.dense(self._trunk(x), 1, "amp_head")
        scale = self.param("log_amp_scale", jax.nn.initializers.ones, ())
        return (scale * jnp.tanh(amp)).squeeze(-1)

    def sign_logits(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.dense(self._trunk(x), 1, "sign_head").squeeze(-1)

    def phase(self, x: jnp.ndarray) -> jnp.ndarray:
        # sign in {+1,-1} -> phase in {0, pi}
        return jnp.pi * (self.sign_logits(x) < 0).astype(jnp.float32)
