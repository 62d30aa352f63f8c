"""Circuit-based Krylov basis sampler (quantum-hardware integration point).

Counterpart of ``/root/reference/src/krylov/basis_sampler.py``: Trotterized
``exp(-i H t)`` circuits from Pauli words with Neel/zeros/ones initial
states, measured with ``shots`` to propose basis states
(``basis_sampler.py:27-302``).

The reference dispatches to CUDA-Q when present and otherwise runs a dense
classical fallback (``basis_sampler.py:212-259``) — that fallback is the
behavioral spec here.  This rebuild keeps the (coefficients, Pauli words)
interface but simulates the statevector natively in JAX: each Pauli-word
rotation exp(-i theta P) = cos(theta) I - i sin(theta) P is applied as a
fused gather + phase multiply (P|k> permutes amplitudes by k XOR x_mask
with a popcount phase), jitted end to end.  Real QPU dispatch is out of
scope (SURVEY.md §7.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["CircuitSamplerConfig", "CUDAQConfig", "KrylovBasisSampler",
           "create_circuit_sampler"]


@dataclass
class CircuitSamplerConfig:
    """Sampler knobs (reference ``basis_sampler.py:16-24``)."""
    shots: int = 10_000
    num_trotter_steps: int = 4
    time_step: float = 0.1
    initial_state: str = "neel"      # 'neel' | 'zeros' | 'ones'
    seed: int = 0


# back-compat name from the reference
CUDAQConfig = CircuitSamplerConfig


def _pauli_masks(word: str) -> Tuple[int, int, int]:
    x_mask = z_mask = n_y = 0
    for q, p in enumerate(word.upper()):
        if p in "XY":
            x_mask |= 1 << q
        if p in "ZY":
            z_mask |= 1 << q
        if p == "Y":
            n_y += 1
    return x_mask, z_mask, n_y


def _xor_permute(psi: jnp.ndarray, x_mask: int, n_qubits: int) -> jnp.ndarray:
    """psi[k ^ x_mask] via axis flips — XOR by a mask is a composition of
    single-bit reflections, each a rank-3 (left, 2, right) reshape +
    reverse that XLA fuses into one pass (Pauli words touch at most two
    qubits).  On an H100 one such flip of a 2^25 vector runs at ~80 % of
    the bandwidth roofline for any bit (``hamiltonians/spin.py``).
    """
    for q in range(n_qubits):
        if (x_mask >> q) & 1:
            v = psi.reshape(1 << (n_qubits - 1 - q), 2, 1 << q)
            psi = jnp.flip(v, axis=1).reshape(-1)
    return psi


def _pauli_rotation_pair(re: jnp.ndarray, im: jnp.ndarray,
                         theta: jnp.ndarray, x_mask: int, z_mask: int,
                         n_y: int, n_qubits: int
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """psi' = exp(-i theta P) psi = cos(theta) psi - i sin(theta) (P psi),
    carried as (re, im) float32 pairs: the real pairs skip complex
    multiplies entirely, and (1j)**n_y is static, so the phase arithmetic
    constant-folds at trace time."""
    ct, st = jnp.cos(theta), jnp.sin(theta)
    xr = _xor_permute(re, x_mask, n_qubits)
    xi = _xor_permute(im, x_mask, n_qubits)
    if z_mask == 0 and n_y == 0:
        # pure-X word (every TFIM off-diagonal term): P psi = psi[k^x],
        # no sign vector — skips three statevector-sized temporaries
        # (arange, popcount, sign) per rotation, which is what blew HBM
        # at 2^26 amplitudes (52 rotations per 2nd-order substep)
        return ct * re + st * xi, ct * im - st * xr
    dim = 1 << n_qubits
    idx = jnp.arange(dim, dtype=jnp.uint32)
    src = idx ^ jnp.uint32(x_mask)
    # (P psi)[k] = s * (a + ib) * psi[k ^ x_mask],  s = (-1)^parity(z&src)
    par = jax.lax.population_count(src & jnp.uint32(z_mask)) & jnp.uint32(1)
    s = 1.0 - 2.0 * par.astype(jnp.float32)
    a = int(((1j) ** n_y).real)
    b = int(((1j) ** n_y).imag)
    p_re = s * (a * xr - b * xi)
    p_im = s * (a * xi + b * xr)
    # psi' = ct*psi - i*st*(p_re + i p_im) = (ct*re + st*p_im,
    #                                         ct*im - st*p_re)
    return ct * re + st * p_im, ct * im - st * p_re


@partial(jax.jit, static_argnames=("x_mask", "z_mask", "n_y", "n_qubits"))
def _apply_pauli_rotation(re: jnp.ndarray, im: jnp.ndarray,
                          theta: jnp.ndarray, x_mask: int, z_mask: int,
                          n_y: int, n_qubits: int
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    return _pauli_rotation_pair(re, im, theta, x_mask, z_mask, n_y,
                                n_qubits)


class KrylovBasisSampler:
    """Trotter-evolve an initial product state, measure, propose configs."""

    def __init__(self, coefficients: Sequence[float],
                 pauli_words: Sequence[str], n_qubits: int,
                 config: Optional[CircuitSamplerConfig] = None):
        self.coeffs = [float(c) for c in coefficients]
        self.words = list(pauli_words)
        if any(len(w) != n_qubits for w in self.words):
            raise ValueError("Pauli word length != n_qubits")
        self.n_qubits = n_qubits
        self.config = config or CircuitSamplerConfig()
        self.masks = [_pauli_masks(w) for w in self.words]
        self.key = jax.random.PRNGKey(self.config.seed)

    def _initial_state(self) -> int:
        kind = self.config.initial_state
        if kind == "zeros":
            return 0
        if kind == "ones":
            return (1 << self.n_qubits) - 1
        if kind == "neel":
            s = 0
            for i in range(0, self.n_qubits, 2):
                s |= 1 << i
            return s
        raise ValueError(f"unknown initial state {kind!r}")

    def evolve_statevector(self, t: float) -> np.ndarray:
        """2nd-order-free (first-order) Trotterized exp(-i H t)|psi0>."""
        c = self.config
        dim = 1 << self.n_qubits
        re = jnp.zeros(dim, jnp.float32).at[self._initial_state()].set(1.0)
        im = jnp.zeros(dim, jnp.float32)
        dt = t / c.num_trotter_steps
        for _ in range(c.num_trotter_steps):
            for coef, (xm, zm, ny) in zip(self.coeffs, self.masks):
                re, im = _apply_pauli_rotation(
                    re, im, jnp.float32(coef * dt), xm, zm, ny,
                    self.n_qubits)
        return np.asarray(re) + 1j * np.asarray(im)

    def sample(self, t: Optional[float] = None,
               shots: Optional[int] = None) -> Dict[int, int]:
        """Measurement counts after evolving for time t."""
        c = self.config
        t = c.time_step if t is None else t
        shots = c.shots if shots is None else shots
        psi = self.evolve_statevector(t)
        probs = np.abs(psi) ** 2
        probs = probs / probs.sum()
        self.key, k = jax.random.split(self.key)
        idx = np.asarray(jax.random.categorical(
            k, jnp.log(jnp.asarray(probs) + 1e-30), shape=(shots,)))
        vals, counts = np.unique(idx, return_counts=True)
        return {int(v): int(ct) for v, ct in zip(vals, counts)}

    def sample_krylov_bases(self, max_krylov_dim: int
                            ) -> List[Dict[int, int]]:
        """Counts at t = k * dt for k = 0..K-1 (one circuit depth per k)."""
        return [self.sample(t=k * self.config.time_step)
                for k in range(max_krylov_dim)]


def create_circuit_sampler(hamiltonian,
                           config: Optional[CircuitSamplerConfig] = None
                           ) -> KrylovBasisSampler:
    """Build a sampler from a spin Hamiltonian
    (reference ``basis_sampler.py:305-331``)."""
    from ..hamiltonians.spin import extract_coeffs_and_paulis
    coeffs, words = extract_coeffs_and_paulis(hamiltonian)
    return KrylovBasisSampler(coeffs, words, hamiltonian.n_sites, config)
