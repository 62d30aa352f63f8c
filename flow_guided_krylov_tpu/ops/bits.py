"""Packed-bitstring utilities for Slater determinants.

Determinants are stored as pairs of unsigned 32-bit words — one word per
spin channel (alpha occupations in bit i of word 0, beta in word 1) — not
as (B, 2*n_orb) 0/1 float tensors like the reference
(``/root/reference/src/hamiltonians/molecular.py:43-45``).  Jordan-Wigner
parities become popcounts of masked prefixes (SURVEY.md §7.1).  Orbital
ordering matches the reference: alpha orbitals on qubits 0..n-1, beta on
n..2n-1.

Supports n_orb <= 32 per uint32 word (kernels shift by orbital INDEX,
<= 31, and the uint64 dedup key (alpha << 32) | beta still fits at 32);
the benchmark systems need <= 14.  For 33..64 orbitals each spin channel
spans TWO words in [hi, lo] order (round 5; the ``*2`` multiword
primitives below) and determinant rows are [a_hi, a_lo, b_hi, b_lo].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "pack_np", "unpack_np", "keys_np", "occupancy", "parity_between",
    "pack_device", "unpack_device", "keys_device",
    "occupancy2", "parity_between2", "flip_orbital2",
    "occupancy2_np", "parity_between2_np", "flip_orbital2_np",
    "pack2_np",
]


# ---------------------------------------------------------------------------
# Host (NumPy) side
# ---------------------------------------------------------------------------

def pack_np(configs: np.ndarray, n_orb: int) -> np.ndarray:
    """(B, 2*n_orb) 0/1 array -> (B, 2) uint32 [alpha_bits, beta_bits]."""
    configs = np.asarray(configs)
    w = (1 << np.arange(n_orb, dtype=np.uint64))
    a = (configs[:, :n_orb].astype(np.uint64) @ w).astype(np.uint32)
    b = (configs[:, n_orb:2 * n_orb].astype(np.uint64) @ w).astype(np.uint32)
    return np.stack([a, b], axis=-1)


def unpack_np(packed: np.ndarray, n_orb: int) -> np.ndarray:
    """(B, 2) uint32 -> (B, 2*n_orb) int8 occupation vectors."""
    packed = np.asarray(packed)
    shifts = np.arange(n_orb, dtype=np.uint32)
    a = (packed[:, 0:1] >> shifts) & 1
    b = (packed[:, 1:2] >> shifts) & 1
    return np.concatenate([a, b], axis=-1).astype(np.int8)


def keys_np(packed: np.ndarray) -> np.ndarray:
    """(B, 2) uint32 -> (B,) uint64 unique key (alpha << 32 | beta)."""
    packed = np.asarray(packed, dtype=np.uint64)
    return (packed[..., 0] << np.uint64(32)) | packed[..., 1]


def from_keys_np(keys: np.ndarray) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.uint64)
    a = (keys >> np.uint64(32)).astype(np.uint32)
    b = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([a, b], axis=-1)


# ---------------------------------------------------------------------------
# Device (JAX) side
# ---------------------------------------------------------------------------

def occupancy(bits: jnp.ndarray, n_orb: int) -> jnp.ndarray:
    """uint32 scalar/array -> (..., n_orb) int32 occupation vector."""
    shifts = jnp.arange(n_orb, dtype=jnp.uint32)
    return ((bits[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.int32)


def pack_device(occ: jnp.ndarray) -> jnp.ndarray:
    """(..., n_orb) 0/1 -> uint32 bits."""
    n_orb = occ.shape[-1]
    w = (jnp.uint32(1) << jnp.arange(n_orb, dtype=jnp.uint32))
    return jnp.sum(occ.astype(jnp.uint32) * w, axis=-1)


def unpack_device(packed: jnp.ndarray, n_orb: int) -> jnp.ndarray:
    """(..., 2) uint32 -> (..., 2*n_orb) float32 occupations."""
    a = occupancy(packed[..., 0], n_orb)
    b = occupancy(packed[..., 1], n_orb)
    return jnp.concatenate([a, b], axis=-1).astype(jnp.float32)


def keys_device(packed: jnp.ndarray) -> jnp.ndarray:
    """Identity: the packed (..., 2) uint32 pair IS the device key.

    Device arrays are 32-bit (64-bit mode is off), so there is no
    on-device composite scalar key; device code sorts/compares the two
    words lexicographically (e.g.
    ``jax.lax.sort((a, b), num_keys=2)``).  Kept as the named device
    counterpart of :func:`keys_np` so call sites document intent.
    """
    return packed


def parity_between(bits: jnp.ndarray, p: jnp.ndarray, q: jnp.ndarray
                   ) -> jnp.ndarray:
    """(-1)^(# occupied orbitals strictly between p and q) as int32 sign.

    This is the Jordan-Wigner / fermionic permutation sign for a†_q a_p
    acting on ``bits`` with p occupied and q empty (reference:
    ``molecular.py:379-389``).
    """
    lo = jnp.minimum(p, q).astype(jnp.uint32)
    hi = jnp.maximum(p, q).astype(jnp.uint32)
    one = jnp.uint32(1)
    mask = ((one << hi) - one) & ~((one << (lo + one)) - one)
    par = jax.lax.population_count(bits & mask) & jnp.uint32(1)
    return (1 - 2 * par.astype(jnp.int32))


# (1 << k) - 1 for k = 0..32, as uint32 (index 32 = all-ones)
_LOW_MASKS32 = ((np.uint64(1) << np.arange(33, dtype=np.uint64))
                - np.uint64(1)).astype(np.uint32)
# 1 << k for k = 0..31
_POW2_32 = (np.uint64(1) << np.arange(32, dtype=np.uint64)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Two-word (33..64 orbital) channel primitives — round 5
#
# A spin channel with n_orb > 32 spans two uint32 words in [hi, lo] order
# (orbital i < 32 in lo, i >= 32 in hi) so that lexicographic word order
# equals numeric order.  Mirrors the spin-chain W=2 design
# (``hamiltonians/spin.py:38-72``) on the molecular side.
# ---------------------------------------------------------------------------

def occupancy2(bits2: jnp.ndarray, n_orb: int) -> jnp.ndarray:
    """(..., 2) uint32 [hi, lo] -> (..., n_orb) int32 occupations."""
    lo = occupancy(bits2[..., 1], 32)
    hi = occupancy(bits2[..., 0], n_orb - 32)
    return jnp.concatenate([lo, hi], axis=-1)


def flip_orbital2(bits2: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """XOR orbital bit ``p`` of a two-word channel.

    ``bits2`` (..., 2) broadcasts against ``p`` (...,): the usual kernel
    shape is a scalar channel against a (C,) excitation grid.
    """
    w = (p >> 5).astype(jnp.int32)
    m = jnp.uint32(1) << (p.astype(jnp.uint32) & jnp.uint32(31))
    z = jnp.uint32(0)
    hi = bits2[..., 0] ^ jnp.where(w == 1, m, z)
    lo = bits2[..., 1] ^ jnp.where(w == 0, m, z)
    return jnp.stack([hi, lo], axis=-1)


def _window_mask32(start, end):
    """uint32 mask of bits [start, end) with 0 <= start, end <= 32."""
    one = jnp.uint32(1)
    full = jnp.uint32(0xFFFFFFFF)
    m_end = jnp.where(end >= 32, full,
                      (one << jnp.clip(end, 0, 31).astype(jnp.uint32)) - one)
    m_start = jnp.where(start >= 32, full,
                        (one << jnp.clip(start, 0, 31).astype(jnp.uint32))
                        - one)
    return m_end & ~m_start


def parity_between2(bits2: jnp.ndarray, p: jnp.ndarray, q: jnp.ndarray
                    ) -> jnp.ndarray:
    """Two-word mirror of :func:`parity_between` (JW sign across 64 bits)."""
    lo_i = jnp.minimum(p, q).astype(jnp.int32)
    hi_i = jnp.maximum(p, q).astype(jnp.int32)
    s = lo_i + 1
    e = hi_i
    m_lo = _window_mask32(jnp.clip(s, 0, 32), jnp.clip(e, 0, 32))
    m_hi = _window_mask32(jnp.clip(s - 32, 0, 32), jnp.clip(e - 32, 0, 32))
    cnt = (jax.lax.population_count(bits2[..., 1] & m_lo)
           + jax.lax.population_count(bits2[..., 0] & m_hi))
    return 1 - 2 * (cnt & jnp.uint32(1)).astype(jnp.int32)


def pack2_np(occ: np.ndarray) -> np.ndarray:
    """(..., n_orb) 0/1 -> (..., 2) uint32 [hi, lo] channel words."""
    occ = np.asarray(occ)
    n = occ.shape[-1]
    lo = (occ[..., :32].astype(np.uint64)
          @ (np.uint64(1) << np.arange(min(n, 32), dtype=np.uint64))
          ).astype(np.uint32)
    hi = (occ[..., 32:].astype(np.uint64)
          @ (np.uint64(1) << np.arange(max(n - 32, 0), dtype=np.uint64))
          ).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)


def occupancy2_np(bits2: np.ndarray, n_orb: int) -> np.ndarray:
    """(..., 2) uint32 [hi, lo] -> (..., n_orb) int8 occupations."""
    shifts_lo = np.arange(32, dtype=np.uint32)
    shifts_hi = np.arange(n_orb - 32, dtype=np.uint32)
    lo = (bits2[..., 1:2] >> shifts_lo) & np.uint32(1)
    hi = (bits2[..., 0:1] >> shifts_hi) & np.uint32(1)
    return np.concatenate([lo, hi], axis=-1).astype(np.int8)


def flip_orbital2_np(bits2: np.ndarray, p: np.ndarray) -> np.ndarray:
    """NumPy mirror of :func:`flip_orbital2` (uint32 end to end)."""
    w = p >> 5
    m = _POW2_32[p & 31]
    z = np.uint32(0)
    hi = bits2[..., 0] ^ np.where(w == 1, m, z)
    lo = bits2[..., 1] ^ np.where(w == 0, m, z)
    return np.stack([hi, lo], axis=-1)


def parity_between2_np(bits2: np.ndarray, p: np.ndarray, q: np.ndarray
                       ) -> np.ndarray:
    """NumPy mirror of :func:`parity_between2` (uint32 end to end)."""
    p = np.asarray(p, np.int32)
    q = np.asarray(q, np.int32)
    lo_i = np.minimum(p, q)
    hi_i = np.maximum(p, q)
    s = lo_i + 1
    e = hi_i
    m_lo = (_LOW_MASKS32[np.clip(e, 0, 32)]
            & ~_LOW_MASKS32[np.clip(s, 0, 32)])
    m_hi = (_LOW_MASKS32[np.clip(e - 32, 0, 32)]
            & ~_LOW_MASKS32[np.clip(s - 32, 0, 32)])
    masked_lo = bits2[..., 1] & m_lo
    masked_hi = bits2[..., 0] & m_hi
    if hasattr(np, "bitwise_count"):
        cnt = np.bitwise_count(masked_lo) + np.bitwise_count(masked_hi)
    else:                                    # pragma: no cover
        cnt = np.zeros(masked_lo.shape, np.int64)
        for v in (masked_lo, masked_hi):
            while np.any(v):
                cnt += (v & 1).astype(np.int64)
                v = v >> 1
    return 1 - 2 * (cnt & 1).astype(np.int32)


def parity_between_np(bits: np.ndarray, p: np.ndarray, q: np.ndarray
                      ) -> np.ndarray:
    """NumPy mirror of :func:`parity_between`.

    Works in uint32 whenever the orbital indices allow it (index <= 31,
    i.e. the whole supported n_orb <= 32 range): this numpy build's
    uint64 elementwise loops are
    ~100x slower than uint32 (no SIMD kernels), which made the host
    Slater-Condon mirror the FCI-oracle bottleneck.
    """
    bits = np.asarray(bits)
    hi_max = int(max(np.max(p, initial=0), np.max(q, initial=0)))
    if bits.dtype.itemsize <= 4 and hi_max < 32:
        bits32 = bits.astype(np.uint32, copy=False)
        lo = np.minimum(p, q)
        hi = np.maximum(p, q)
        # (1<<k)-1 via table gather: the scalar<<array ufunc has no SIMD
        # kernel in this build (~100x slower than a fancy-index take)
        mask = _LOW_MASKS32[hi] & ~_LOW_MASKS32[lo + 1]
        masked = bits32 & mask
    else:
        bits64 = bits.astype(np.uint64, copy=False)
        lo = np.minimum(np.asarray(p, np.int64),
                        np.asarray(q, np.int64)).astype(np.uint64)
        hi = np.maximum(np.asarray(p, np.int64),
                        np.asarray(q, np.int64)).astype(np.uint64)
        one = np.uint64(1)
        mask = ((one << hi) - one) & ~((one << (lo + one)) - one)
        masked = bits64 & mask
    if hasattr(np, "bitwise_count"):        # numpy >= 2.0: single ufunc
        count = np.bitwise_count(masked)
        # int32 output: int64 elementwise arithmetic has no SIMD kernels
        # in this build (~100x slower)
        return (1 - 2 * (count & np.uint8(1)).astype(np.int32))
    # fallback popcount via shift loop (numpy < 2.0 lacks it)
    v = masked
    count = np.zeros(v.shape, np.int64)
    while np.any(v):
        count += (v & 1).astype(np.int64)
        v = v >> 1
    return (1 - 2 * (count & 1)).astype(np.int64)
