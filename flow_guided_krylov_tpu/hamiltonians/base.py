"""Hamiltonian abstract base + Pauli strings.

Device counterpart of the reference's Hamiltonian contract
(``/root/reference/src/hamiltonians/base.py:9-341``).  The key departure:
configurations are packed uint32 words (W words per determinant — 2 for
molecular alpha/beta, 1 for spin chains), and connection enumeration is
*static-shaped*: every config yields exactly ``n_connections`` targets
(invalid ones carry a zero matrix element), so the whole batch jits.
"""

from __future__ import annotations

import sys
from abc import ABC, abstractmethod
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

__all__ = ["Hamiltonian", "PauliString"]

# keys() builds (alpha << 32) | beta by reinterpreting a [beta, alpha]
# uint32 pair as uint64 — a little-endian layout assumption; make it
# explicit rather than silently breaking the unkey() round-trip.
assert sys.byteorder == "little", \
    "packed-key uint64 views assume a little-endian host"


class Hamiltonian(ABC):
    """Abstract Hamiltonian over packed-bitstring configurations.

    Required surface (mirrors ``base.py:27-40`` in spirit):

    * ``n_sites`` — number of qubits/spins.
    * ``pack_words`` — uint32 words per configuration (1 or 2).
    * ``n_connections`` — static per-config connection count.
    * ``diagonal_np(packed)`` — host f64 diagonal elements.
    * ``connections_np(packed)`` — host f64 ((B,C,W) targets, (B,C) elems).
    * device variants ``diagonal_device`` / ``connections_device`` for the
      training hot path (f32, jitted).
    """

    n_sites: int
    pack_words: int

    # ------------------------------------------------------------------
    # Core kernels
    # ------------------------------------------------------------------

    @property
    @abstractmethod
    def n_connections(self) -> int:
        ...

    @abstractmethod
    def diagonal_np(self, packed: np.ndarray) -> np.ndarray:
        ...

    @abstractmethod
    def connections_np(self, packed: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        ...

    # ------------------------------------------------------------------
    # Key encoding (host)
    # ------------------------------------------------------------------

    # 128-bit key dtype for 4-word rows: compares lexicographically by
    # field, i.e. (alpha, beta) numeric order.  np.sort / argsort /
    # searchsorted / == / != all support structured dtypes, so every key
    # consumer (_sorted_unique, membership maps, dedup) works unchanged.
    KEY128 = np.dtype([("a", "<u8"), ("b", "<u8")])

    def keys(self, packed: np.ndarray) -> np.ndarray:
        """(B, W) uint32 -> (B,) sort/dedup keys.

        W <= 2: plain uint64.  W = 4 (two words per spin channel,
        [a_hi, a_lo, b_hi, b_lo] rows): structured ``KEY128`` records —
        128 bits, ordered like the concatenated (alpha, beta) integer.
        """
        packed = np.asarray(packed)
        if packed.ndim == 1:
            packed = packed[:, None]
        if self.pack_words == 1:
            return packed[..., 0].astype(np.uint64)
        flat = packed.reshape(-1, packed.shape[-1])
        if self.pack_words == 4:
            # little-endian view trick per 64-bit half (no uint64 shift
            # ufuncs: they lack SIMD kernels in this build)
            kk = np.empty((flat.shape[0], 4), np.uint32)
            kk[:, 0] = flat[:, 1]    # alpha low
            kk[:, 1] = flat[:, 0]    # alpha high
            kk[:, 2] = flat[:, 3]    # beta low
            kk[:, 3] = flat[:, 2]    # beta high
            return kk.view(self.KEY128)[:, 0].reshape(packed.shape[:-1])
        # (alpha << 32) | beta without uint64 shift ufuncs (no SIMD kernels
        # in this build): write [beta, alpha] uint32 pairs and reinterpret
        # as little-endian uint64 — two fast copies and a zero-cost view
        kk = np.empty((flat.shape[0], 2), np.uint32)
        kk[:, 0] = flat[:, 1]        # low word: beta
        kk[:, 1] = flat[:, 0]        # high word: alpha
        return kk.view(np.uint64)[:, 0].reshape(packed.shape[:-1])

    def unkey(self, keys: np.ndarray) -> np.ndarray:
        if self.pack_words == 4:
            kk = np.asarray(keys, dtype=self.KEY128).reshape(-1, 1)
            w = kk.view(np.uint32)                   # (B, 4) le words
            return np.stack([w[:, 1], w[:, 0], w[:, 3], w[:, 2]], axis=-1)
        keys = np.asarray(keys, dtype=np.uint64)
        if self.pack_words == 1:
            return keys.astype(np.uint32)[:, None]
        a = (keys >> np.uint64(32)).astype(np.uint32)
        b = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        return np.stack([a, b], axis=-1)

    # ------------------------------------------------------------------
    # Projected matrices (host, float64 — final eigensolves need f64,
    # SURVEY.md §7.3 item 4)
    # ------------------------------------------------------------------

    def matrix_elements(self, bra: np.ndarray, ket: np.ndarray) -> np.ndarray:
        """Dense <bra_i|H|ket_j> (host f64).

        Semantics of the reference's ``matrix_elements`` /
        ``matrix_elements_fast`` (``molecular.py:471-516,640-685``):
        diagonal + connection scatter through a sorted-key membership map.
        """
        bra = np.atleast_2d(np.asarray(bra, np.uint32))
        ket = np.atleast_2d(np.asarray(ket, np.uint32))
        nb, nk = bra.shape[0], ket.shape[0]
        bra_keys = self.keys(bra)
        order = np.argsort(bra_keys)
        sorted_keys = bra_keys[order]

        H = np.zeros((nb, nk))
        # diagonal / identical-config entries
        ket_keys = self.keys(ket)
        pos = np.searchsorted(sorted_keys, ket_keys)
        pos_c = np.clip(pos, 0, nb - 1)
        hit = sorted_keys[pos_c] == ket_keys
        diag = self.diagonal_np(ket)
        H[order[pos_c[hit]], np.arange(nk)[hit]] = diag[hit]

        # off-diagonal via connections of each ket column
        conn, elems = self.connections_np(ket)
        ck = self.keys(conn.reshape(-1, conn.shape[-1]))
        pos = np.searchsorted(sorted_keys, ck)
        pos_c = np.clip(pos, 0, nb - 1)
        hit = sorted_keys[pos_c] == ck
        cols = np.repeat(np.arange(nk), conn.shape[1])
        np.add.at(H, (order[pos_c[hit]], cols[hit]), elems.reshape(-1)[hit])
        return H

    def to_sparse(self, basis: np.ndarray) -> sp.csr_matrix:
        """Sparse projected H over ``basis`` (host f64 CSR).

        Counterpart of ``get_sparse_matrix_elements`` (``molecular.py:580-638``)
        and ``to_sparse`` (``base.py:211-247``).
        """
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        B = basis.shape[0]
        keys = self.keys(basis)
        order = np.argsort(keys)
        sorted_keys = keys[order]
        order32 = order.astype(np.int32)

        # fused native path (molecular Slater tables): enumeration +
        # membership + values for hits only — the NumPy mirror below
        # materializes all B*C candidate values first (~50 memory passes;
        # 0.4 M conn/s at 39 orbitals on the single-core host)
        from ..ops.native_conn import conn_hits_native
        nat = conn_hits_native(self, basis, sorted_keys)
        if nat is not None:
            src, spos, vals = nat
            rows = order32[spos]
            cols = src
        else:
            conn, elems = self.connections_np(basis)
            ck = self.keys(conn.reshape(-1, conn.shape[-1]))
            pos = np.clip(np.searchsorted(sorted_keys, ck), 0, B - 1
                          ).astype(np.int32)
            hit = sorted_keys[pos] == ck
            rows = order32[pos[hit]]
            cols = np.repeat(np.arange(B, dtype=np.int32),
                             conn.shape[1])[hit]
            vals = elems.reshape(-1)[hit]

        diag = self.diagonal_np(basis)
        rng = np.arange(B, dtype=np.int32)
        rows = np.concatenate([rows, rng])
        cols = np.concatenate([cols, rng])
        vals = np.concatenate([vals, diag])
        M = sp.coo_matrix((vals, (rows, cols)), shape=(B, B)).tocsr()
        return M

    def exact_ground_state(self, basis: np.ndarray, k: int = 1,
                           v0: Optional[np.ndarray] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Lowest-k eigenpairs of H projected onto ``basis``.

        Hermitizes and routes dense eigh (<=2048) / sparse eigsh like the
        reference (``molecular.py:913-937``).
        """
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        B = basis.shape[0]
        if B <= 2048:
            H = self.matrix_elements(basis, basis)
            asym = np.max(np.abs(H - H.T))
            if asym > 1e-8:
                import warnings
                warnings.warn(f"projected H asymmetry {asym:.2e}; symmetrizing")
            H = 0.5 * (H + H.T)
            vals, vecs = np.linalg.eigh(H)
            return vals[:k], vecs[:, :k]
        M = self.to_sparse(basis)
        M = (M + M.T) * 0.5
        if v0 is not None and len(v0) != B:
            v0 = None
        vals, vecs = spla.eigsh(M, k=max(k, 2), which="SA", v0=v0)
        idx = np.argsort(vals)
        return vals[idx][:k], vecs[:, idx][:, :k]


class PauliString:
    """A Pauli word (I/X/Y/Z per qubit) acting on packed full bitstrings.

    Counterpart of ``base.py:265-341``.  Application semantics: qubit q in
    state b; X flips, Z phases (-1)^b, Y flips with phase i(-1)^b' where b'
    is the post-flip... — we use the standard convention
    Y|0> = i|1>, Y|1> = -i|0>.
    """

    def __init__(self, paulis: str, coefficient: complex = 1.0):
        self.paulis = paulis.upper()
        self.coefficient = complex(coefficient)
        if set(self.paulis) - set("IXYZ"):
            raise ValueError(f"invalid Pauli string {paulis!r}")
        self.x_mask = 0
        self.z_mask = 0
        for q, p in enumerate(self.paulis):
            if p in "XY":
                self.x_mask |= (1 << q)
            if p in "ZY":
                self.z_mask |= (1 << q)
        self.n_y = sum(1 for p in self.paulis if p == "Y")

    @property
    def is_diagonal(self) -> bool:
        return self.x_mask == 0

    def apply(self, state: int) -> Tuple[int, complex]:
        """Return (new_state, phase) for P|state>."""
        new_state = state ^ self.x_mask
        # phase: product over qubits; standard formula
        # <new|P|state> = i^{n_y} * (-1)^{popcount(state & z_mask)} * (-i)^{...}
        # Derive directly: X: 1; Z: (-1)^b; Y on bit b: b=0 -> i, b=1 -> -i.
        phase = self.coefficient
        for q, p in enumerate(self.paulis):
            b = (state >> q) & 1
            if p == "Z":
                phase *= (-1) ** b
            elif p == "Y":
                phase *= (1j if b == 0 else -1j)
        return new_state, phase

    def __repr__(self) -> str:
        return f"PauliString({self.paulis!r}, {self.coefficient})"
