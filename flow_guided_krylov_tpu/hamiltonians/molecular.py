"""Molecular Hamiltonian over packed determinants, on device.

Second-quantized molecular Hamiltonian under Jordan-Wigner with alpha
orbitals on qubits 0..n-1 and beta on n..2n-1, matching the reference's
convention (``/root/reference/src/hamiltonians/molecular.py:43-45``), but
implemented on packed uint32 determinant pairs with static-shaped batched
Slater-Condon kernels (``ops/slater.py``) instead of Python loops.

Host integrals come from the in-repo chem front end (no PySCF in the
image); all device compute is jitted JAX.
"""

from __future__ import annotations

from itertools import combinations
from math import comb
from typing import List, Optional, Tuple

import numpy as np

from ..chem import MolecularIntegrals, compute_molecular_integrals
from ..ops.slater import (SlaterTables, build_tables, connections_batch_np,
                          diagonal_batch, diagonal_batch_np,
                          make_connection_fn_auto)
from .base import Hamiltonian, PauliString

__all__ = [
    "MolecularHamiltonian",
    "create_h2_hamiltonian", "create_lih_hamiltonian",
    "create_h2o_hamiltonian", "create_beh2_hamiltonian",
    "create_nh3_hamiltonian", "create_n2_hamiltonian",
    "create_ch4_hamiltonian", "MOLECULE_FACTORIES",
]


class MolecularHamiltonian(Hamiltonian):
    """Molecular Hamiltonian with particle-conserving determinant algebra.

    API parity targets: ``molecular.py:35-942`` (diagonal batches,
    connections, matrix elements, HF state, FCI) — rebuilt for the device.
    """

    pack_words = 2          # overridden per instance for n_orbitals > 32

    def __init__(self, integrals: MolecularIntegrals):
        self.integrals = integrals
        self.n_orbitals = integrals.n_orbitals
        self.n_alpha = integrals.n_alpha
        self.n_beta = integrals.n_beta
        self.n_electrons = integrals.n_electrons
        # 33..64 orbitals span two uint32 words per spin channel
        # ([a_hi, a_lo, b_hi, b_lo] rows; structured 128-bit host keys)
        self.pack_words = 4 if self.n_orbitals > 32 else 2
        self.n_sites = 2 * self.n_orbitals  # qubits
        self.n_qubits = self.n_sites
        self.tables: SlaterTables = build_tables(
            integrals.h1e, integrals.h2e, integrals.nuclear_repulsion,
            integrals.n_alpha, integrals.n_beta)
        self._conn_fn = None  # lazily built jitted device kernel
        self._fci_cache: Optional[Tuple[float, np.ndarray, np.ndarray]] = None
        self._fci_energy_cache: Optional[float] = None  # disk-cache memo

    # ------------------------------------------------------------------
    # Counting / enumeration
    # ------------------------------------------------------------------

    @property
    def n_valid_configs(self) -> int:
        n = self.n_orbitals
        return comb(n, self.n_alpha) * comb(n, self.n_beta)

    @property
    def n_connections(self) -> int:
        return self.tables.n_connections

    def enumerate_basis(self) -> np.ndarray:
        """All C(n,na)*C(n,nb) particle-conserving determinants,
        (B, pack_words) uint32."""
        n = self.n_orbitals
        if self.n_valid_configs > 200_000_000:
            raise NotImplementedError(
                f"enumerate_basis: {self.n_valid_configs} configs is not "
                "enumerable — use the Selected-CI machinery")

        def channel_words(k):
            ints = [sum(1 << i for i in c)
                    for c in combinations(range(n), k)]
            if n <= 32:
                return np.array(ints, dtype=np.uint32)[:, None]
            arr = np.array(ints, dtype=np.uint64)
            return np.stack([(arr >> np.uint64(32)).astype(np.uint32),
                             (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)],
                            axis=-1)                 # [hi, lo]

        alphas = channel_words(self.n_alpha)
        betas = channel_words(self.n_beta)
        a = np.repeat(alphas, len(betas), axis=0)
        b = np.tile(betas, (len(alphas), 1))
        return np.concatenate([a, b], axis=-1)

    def get_hf_state(self) -> np.ndarray:
        """Aufbau reference determinant, (pack_words,) uint32
        (``molecular.py:778-792``)."""

        def channel(k):
            bits = (1 << k) - 1
            if self.n_orbitals <= 32:
                return [bits & 0xFFFFFFFF]
            return [bits >> 32, bits & 0xFFFFFFFF]   # [hi, lo]

        return np.array(channel(self.n_alpha) + channel(self.n_beta),
                        dtype=np.uint32)

    # ------------------------------------------------------------------
    # Kernels
    # ------------------------------------------------------------------

    def diagonal_np(self, packed: np.ndarray) -> np.ndarray:
        return diagonal_batch_np(np.atleast_2d(packed), self.tables)

    def connections_np(self, packed: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        return connections_batch_np(np.atleast_2d(packed), self.tables)

    def diagonal_device(self, packed):
        return diagonal_batch(packed, self.tables)

    @property
    def connections_device(self):
        """The routed production kernel (shape-based auto-pick, round 5):
        consumed by PT2 device scoring, the restricted-ELL build, and
        the table builder — see ``ops/slater.py::connection_kernel_choice``."""
        if self._conn_fn is None:
            self._conn_fn = make_connection_fn_auto(self.tables)
        return self._conn_fn

    # ------------------------------------------------------------------
    # FCI (exactness oracle; reference ``molecular.py:838-942``)
    # ------------------------------------------------------------------

    def exact_full(self, k: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(energies, vectors, basis) in the particle-conserving subspace."""
        basis = self.enumerate_basis()
        vals, vecs = self.exact_ground_state(basis, k=k)
        return vals, vecs, basis

    def _fci_disk_cache_path(self):
        """Disk-cache location for the FCI oracle energy, keyed by the
        integral content (same cache dir as the integrals themselves).
        The oracle is benchmark instrumentation — nothing in the solver
        reads it — so caching it only removes repeat-run latency."""
        import hashlib
        import os
        from pathlib import Path
        i = self.integrals
        hsh = hashlib.sha1()
        hsh.update(np.ascontiguousarray(i.h1e).tobytes())
        hsh.update(np.ascontiguousarray(i.h2e).tobytes())
        hsh.update(np.float64(i.nuclear_repulsion).tobytes())
        hsh.update(bytes([i.n_alpha, i.n_beta, i.n_orbitals]))
        root = Path(os.environ.get(
            "FGK_INTEGRAL_CACHE",
            Path.home() / ".cache" / "fgk_integrals"))
        return root / f"fci_{hsh.hexdigest()}.txt"

    def fci_energy(self) -> float:
        if self._fci_cache is not None:
            return self._fci_cache[0]
        if self._fci_energy_cache is not None:
            return self._fci_energy_cache
        path = self._fci_disk_cache_path()
        try:
            self._fci_energy_cache = float(path.read_text())
            return self._fci_energy_cache
        except (OSError, ValueError):
            pass
        vals, vecs, basis = self.exact_full(k=1)
        self._fci_cache = (float(vals[0]), vecs[:, 0], basis)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(repr(self._fci_cache[0]))
        except OSError:
            pass
        return self._fci_cache[0]

    def fci_state(self) -> Tuple[float, np.ndarray, np.ndarray]:
        if self._fci_cache is None:
            # the disk cache holds the energy only — the state needs a
            # real solve
            vals, vecs, basis = self.exact_full(k=1)
            self._fci_cache = (float(vals[0]), vecs[:, 0], basis)
        return self._fci_cache

    # ------------------------------------------------------------------
    # Pauli-word export (for the Krylov circuit sampler interface;
    # reference ``molecular.py:687-776``)
    # ------------------------------------------------------------------

    def to_pauli_strings(self, threshold: float = 1e-10) -> List[PauliString]:
        """Jordan-Wigner Pauli decomposition (one-body + diagonal two-body).

        Matches the reference's coverage (``molecular.py:743-759``): full
        one-body terms and the diagonal (number-number) part of the
        two-body interaction; used by the circuit-sampling integration
        point, not the main pipeline.
        """
        n = self.n_orbitals
        nq = self.n_sites
        h1 = self.integrals.h1e
        terms: dict = {}

        def add(word: str, coef: complex):
            if abs(coef) < threshold:
                return
            terms[word] = terms.get(word, 0.0) + coef

        ident = "I" * nq
        add(ident, self.integrals.nuclear_repulsion)

        for spin_off in (0, n):
            for p in range(n):
                q_p = p + spin_off
                # number operator: n_p = (I - Z_p)/2
                add(ident, 0.5 * h1[p, p])
                w = list(ident)
                w[q_p] = "Z"
                add("".join(w), -0.5 * h1[p, p])
                for q in range(p + 1, n):
                    if abs(h1[p, q]) < threshold:
                        continue
                    q_q = q + spin_off
                    # hopping: h_pq (a+_p a_q + h.c.)
                    #   = h_pq/2 (X_p Z.. X_q + Y_p Z.. Y_q)
                    for op in ("X", "Y"):
                        w = list(ident)
                        w[q_p] = op
                        w[q_q] = op
                        for z in range(q_p + 1, q_q):
                            w[z] = "Z"
                        add("".join(w), 0.5 * h1[p, q])

        # diagonal two-body: 1/2 sum J_pq N_p N_q - 1/2 K same-spin,
        # expressed via n_p n_q -> (I - Z_p - Z_q + Z_p Z_q)/4
        jmat, kmat = self.tables.jmat, self.tables.kmat

        def add_nn(qa: int, qb: int, coef: float):
            if qa == qb:
                # n^2 = n for fermions
                add(ident, 0.5 * coef)
                w = list(ident)
                w[qa] = "Z"
                add("".join(w), -0.5 * coef)
                return
            add(ident, 0.25 * coef)
            for qq in (qa, qb):
                w = list(ident)
                w[qq] = "Z"
                add("".join(w), -0.25 * coef)
            w = list(ident)
            w[qa] = "Z"
            w[qb] = "Z"
            add("".join(w), 0.25 * coef)

        for p in range(n):
            for q in range(n):
                for so1 in (0, n):
                    for so2 in (0, n):
                        coef = 0.5 * jmat[p, q]
                        if so1 == so2:
                            coef -= 0.5 * kmat[p, q]
                        add_nn(p + so1, q + so2, coef)

        return [PauliString(w, c) for w, c in terms.items()
                if abs(c) > threshold]


# ---------------------------------------------------------------------------
# Molecule factories — same geometries as the reference
# (``molecular.py:1006-1141``)
# ---------------------------------------------------------------------------

def create_h2_hamiltonian(bond_length: float = 0.74) -> MolecularHamiltonian:
    geometry = [("H", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, bond_length))]
    return MolecularHamiltonian(compute_molecular_integrals(geometry))


def create_lih_hamiltonian(bond_length: float = 1.6) -> MolecularHamiltonian:
    geometry = [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, bond_length))]
    return MolecularHamiltonian(compute_molecular_integrals(geometry))


def create_h2o_hamiltonian(oh_length: float = 0.96,
                           angle: float = 104.5) -> MolecularHamiltonian:
    ang = np.radians(angle)
    geometry = [
        ("O", (0.0, 0.0, 0.0)),
        ("H", (oh_length, 0.0, 0.0)),
        ("H", (oh_length * np.cos(ang), oh_length * np.sin(ang), 0.0)),
    ]
    return MolecularHamiltonian(compute_molecular_integrals(geometry))


def create_beh2_hamiltonian(bond_length: float = 1.33) -> MolecularHamiltonian:
    geometry = [
        ("Be", (0.0, 0.0, 0.0)),
        ("H", (0.0, 0.0, bond_length)),
        ("H", (0.0, 0.0, -bond_length)),
    ]
    return MolecularHamiltonian(compute_molecular_integrals(geometry))


def create_nh3_hamiltonian(nh_length: float = 1.01,
                           hnh_angle: float = 107.8) -> MolecularHamiltonian:
    ang = np.radians(hnh_angle)
    h = nh_length * np.cos(np.arcsin(np.sin(ang / 2) / np.sin(np.radians(60))))
    r = np.sqrt(nh_length ** 2 - h ** 2)
    geometry = [
        ("N", (0.0, 0.0, h)),
        ("H", (r, 0.0, 0.0)),
        ("H", (r * np.cos(np.radians(120)), r * np.sin(np.radians(120)), 0.0)),
        ("H", (r * np.cos(np.radians(240)), r * np.sin(np.radians(240)), 0.0)),
    ]
    return MolecularHamiltonian(compute_molecular_integrals(geometry))


def create_n2_hamiltonian(bond_length: float = 1.10) -> MolecularHamiltonian:
    geometry = [("N", (0.0, 0.0, 0.0)), ("N", (0.0, 0.0, bond_length))]
    return MolecularHamiltonian(compute_molecular_integrals(geometry))


def create_ch4_hamiltonian(ch_length: float = 1.09) -> MolecularHamiltonian:
    a = ch_length / np.sqrt(3)
    geometry = [
        ("C", (0.0, 0.0, 0.0)),
        ("H", (a, a, a)), ("H", (a, -a, -a)),
        ("H", (-a, a, -a)), ("H", (-a, -a, a)),
    ]
    return MolecularHamiltonian(compute_molecular_integrals(geometry))


MOLECULE_FACTORIES = {
    "h2": create_h2_hamiltonian,
    "lih": create_lih_hamiltonian,
    "h2o": create_h2o_hamiltonian,
    "beh2": create_beh2_hamiltonian,
    "nh3": create_nh3_hamiltonian,
    "n2": create_n2_hamiltonian,
    "ch4": create_ch4_hamiltonian,
}
