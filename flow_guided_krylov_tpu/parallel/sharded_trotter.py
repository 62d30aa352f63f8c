"""Mesh-sharded statevector Trotter rotations.

The full 2^n statevector shards its TOP log2(n_devices) bits over all mesh
devices (each chip owns one contiguous block of 2^n / n_devices
amplitudes).  A Pauli word's XOR flip then factorizes exactly:

* low bits (inside a block)  -> the local strided-reverse
  machinery of ``krylov.basis_sampler._xor_permute`` (unchanged);
* sharded high bits          -> an XOR permutation OF BLOCKS, exchanged
  as ``jax.lax.ppermute`` along the mesh axes (the linear device index
  d = data_idx * basis_size + basis_idx XORs componentwise because the
  axis sizes are powers of two).

Z/Y phases are computed blockwise from the reconstructed global index, so
nothing statevector-sized is ever replicated.  This raises the
HBM-derived statevector cap by log2(n_devices) sites (VERDICT round 2
item 3; reference Trotter path ``/root/reference/src/krylov/skqd.py:421-536``
is single-GPU).
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["mesh_supports_statevector", "make_sharded_substep",
           "shard_statevector", "STATE"]

# statevector sharding: flat (2^n,) split over every device in the mesh
STATE = P(("data", "basis"))


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def mesh_supports_statevector(mesh: Mesh, n_qubits: int) -> bool:
    """True when the 2^n statevector can shard over this mesh: both axis
    sizes must be powers of two (so XOR block exchanges factorize) and
    each device must own at least a 128-lane block."""
    if mesh is None or mesh.size <= 1:
        return False
    sizes = [mesh.shape["data"], mesh.shape["basis"]]
    if not all(_is_pow2(s) for s in sizes):
        return False
    shift = n_qubits - int(np.log2(mesh.size))
    return shift >= 7


def shard_statevector(mesh: Mesh, re: jnp.ndarray, im: jnp.ndarray):
    s = NamedSharding(mesh, STATE)
    return jax.device_put(re, s), jax.device_put(im, s)


def _block_xor_exchange(v: jnp.ndarray, mesh: Mesh, hi_mask: int
                        ) -> jnp.ndarray:
    """out_block[d] = in_block[d ^ hi_mask] via per-axis ppermutes."""
    B = mesh.shape["basis"]
    D = mesh.shape["data"]
    mb = hi_mask & (B - 1)
    ma = hi_mask >> int(np.log2(B)) if B > 1 else hi_mask
    if mb:
        v = jax.lax.ppermute(v, "basis", [(i, i ^ mb) for i in range(B)])
    if ma:
        v = jax.lax.ppermute(v, "data", [(j, j ^ ma) for j in range(D)])
    return v


def make_sharded_substep(mesh: Mesh, n_qubits: int,
                         diag_terms: List[Tuple[float, int]],
                         offd_terms: List[Tuple[float, int, int, int]],
                         dt_sub: float):
    """Build (substep(re, im), (hp_re, hp_im)) for a 2nd-order Trotter
    substep over a mesh-sharded statevector.

    ``diag_terms`` = [(coeff, z_mask)], ``offd_terms`` =
    [(coeff, x_mask, z_mask, n_y)] — the same decomposition the
    single-device path uses (``krylov/skqd.py::_trotter_ops``)."""
    from ..krylov.basis_sampler import _xor_permute

    n_dev = mesh.size
    shift = n_qubits - int(np.log2(n_dev))     # local bits per block
    local = 1 << shift
    basis_size = mesh.shape["basis"]

    def global_idx():
        d = (jax.lax.axis_index("data") * basis_size
             + jax.lax.axis_index("basis")).astype(jnp.uint32)
        return ((d << jnp.uint32(shift))
                + jnp.arange(local, dtype=jnp.uint32))

    def rotation(re_b, im_b, theta, x_mask, z_mask, n_y):
        lo = x_mask & (local - 1)
        hi = x_mask >> shift

        def permute(v):
            v = _xor_permute(v, lo, shift)
            if hi:
                v = _block_xor_exchange(v, mesh, hi)
            return v

        ct, st = jnp.cos(theta), jnp.sin(theta)
        xr = permute(re_b)
        xi = permute(im_b)
        if z_mask == 0 and n_y == 0:
            # pure-X word: no sign vector (same shortcut as single-device)
            return ct * re_b + st * xi, ct * im_b - st * xr
        src = global_idx() ^ jnp.uint32(x_mask)
        par = (jax.lax.population_count(src & jnp.uint32(z_mask))
               & jnp.uint32(1))
        s = 1.0 - 2.0 * par.astype(jnp.float32)
        a = int(((1j) ** n_y).real)
        b = int(((1j) ** n_y).imag)
        p_re = s * (a * xr - b * xi)
        p_im = s * (a * xi + b * xr)
        return ct * re_b + st * p_im, ct * im_b - st * p_re

    def half_phase_block():
        idx = global_idx()
        D = jnp.zeros(local, jnp.float32)
        for c, zm in diag_terms:
            par = jax.lax.population_count(idx & jnp.uint32(zm))
            sign = 1.0 - 2.0 * (par & jnp.uint32(1)).astype(jnp.float32)
            D = D + jnp.float32(c) * sign
        ang = 0.5 * dt_sub * D
        return jnp.cos(ang), -jnp.sin(ang)

    def substep_block(re_b, im_b, hr_b, hi_b):
        def diag_mul(re, im):
            return re * hr_b - im * hi_b, re * hi_b + im * hr_b

        re_b, im_b = diag_mul(re_b, im_b)
        for c, xm, zm, ny in offd_terms:
            re_b, im_b = rotation(re_b, im_b,
                                  jnp.float32(c * dt_sub / 2), xm, zm, ny)
        for c, xm, zm, ny in reversed(offd_terms):
            re_b, im_b = rotation(re_b, im_b,
                                  jnp.float32(c * dt_sub / 2), xm, zm, ny)
        return diag_mul(re_b, im_b)

    half_phase = jax.jit(jax.shard_map(
        half_phase_block, mesh=mesh, in_specs=(), out_specs=STATE))
    substep = jax.jit(jax.shard_map(
        substep_block, mesh=mesh,
        in_specs=(STATE, STATE, STATE, STATE), out_specs=(STATE, STATE)))

    hp_re, hp_im = half_phase()

    def substep_fn(re, im, hr, hi):
        return substep(re, im, hr, hi)

    return substep_fn, hp_re, hp_im
