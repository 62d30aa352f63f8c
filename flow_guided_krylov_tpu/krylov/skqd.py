"""Sample-based Krylov Quantum Diagonalization (Stage 4), on device.

Counterpart of ``/root/reference/src/krylov/skqd.py``:

* :class:`SampleBasedKrylovDiagonalization` — classical SKQD simulator.
  For molecular Hamiltonians the time evolution runs in the
  particle-conserving subspace (the reference's dimensionality-reduction
  trick, ``skqd.py:135-177``: NH3 65,536 -> 3,136; N2 1,048,576 -> 14,400).
* :class:`FlowGuidedSKQD` — combines the normalizing-flow basis with
  Krylov-sampled bases and tracks variational stability
  (``skqd.py:891-1059``).

Device design (SURVEY.md §7.1 item 4): the reference evolves with
scipy ``expm_multiply`` on the CPU (``skqd.py:255,270-293``); here the
default propagator is a jitted on-device Lanczos approximation of
``exp(-i dt H) |psi>`` over a dense (or matvec-abstracted) subspace
Hamiltonian, with measurement sampling via ``jax.random.categorical`` +
bincount on device.  A scipy path remains as the float64 reference
implementation (``use_device_evolution=False``) and is what the tests
validate the Lanczos propagator against.

Eigensolve guardrails ported as explicit policies (``skqd.py:683-843``):
Hermitization, diagonal regularization, condition-number check with SVD
fallback, dense/sparse routing.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax
import jax.numpy as jnp

from ..hamiltonians.base import Hamiltonian

__all__ = ["SKQDConfig", "SampleBasedKrylovDiagonalization",
           "FlowGuidedSKQD", "lanczos_expm", "lanczos_expm_ell",
           "supported_evolution_dim"]


def supported_evolution_dim(h: "Hamiltonian", mesh=None) -> int:
    """Largest subspace dimension the auto-routed device propagator can
    evolve: dense rows (cap x sqrt(n_devices)) or the sharded ELL table
    (entry budget x n_devices).  The pipeline's stage-4 skip
    heuristic derives from THIS instead of a flat threshold, so a raised
    cap is always backed by a propagator that actually routes there
    (VERDICT round 2 item 3)."""
    from ..utils.memory import MemoryBudget
    n_dev = mesh.size if mesh is not None else 1
    budget = MemoryBudget.for_device()
    dense = int(min(budget.dense_hamiltonian_cap(), 20_000) * np.sqrt(n_dev))
    ell = (budget.connection_table_entries() * n_dev
           // (h.n_connections + 1))
    return max(dense, int(ell))


def build_restricted_subspace(h: "Hamiltonian", basis: np.ndarray,
                              cap: int,
                              initial_state: Optional[np.ndarray] = None,
                              mesh=None) -> np.ndarray:
    """Evolution subspace for restricted molecular SKQD: the given basis
    plus the top PT2-ranked external candidates, capped at ``cap`` states.

    The reference evolves in the FULL enumerated particle-conserving
    space (``skqd.py:135-177``), which caps its SKQD at enumerable
    systems.  Here the propagator acts within (basis + strongest
    externals), so time evolution still pumps amplitude into determinants
    the variational stages missed — the Krylov-unique discovery the
    reference documents as NECESSARY on N2/CH4 — at any system size.
    """
    from .residual_expansion import (ResidualExpansionConfig,
                                     SelectedCIExpander)
    basis = np.atleast_2d(np.asarray(basis, np.uint32))
    cap = int(cap)
    exp = SelectedCIExpander(
        h, ResidualExpansionConfig(max_basis_size=cap), mesh=mesh)
    rows = []
    if initial_state is not None:
        rows.append(np.atleast_2d(np.asarray(initial_state, np.uint32)))
    n_init = sum(len(r) for r in rows)
    if len(basis) + n_init > cap:
        # basis alone overflows the propagator: keep its top-|c| rows
        _, coeffs = exp._diagonalize(basis)
        keep = np.argsort(-np.abs(coeffs))[:max(1, cap - n_init)]
        rows.append(basis[np.sort(keep)])
    else:
        rows.append(basis)
        room = cap - len(basis) - n_init
        if room > 0:
            cand, scores, _, _ = exp.rank_external_candidates(basis)
            if len(cand):
                top = cand[np.argsort(-scores)[:room]]
                rows.append(np.asarray(top, np.uint32))
    states = np.concatenate(rows, axis=0)
    keys = h.keys(states)
    _, first = np.unique(keys, return_index=True)
    return states[np.sort(first)]


@dataclass
class SKQDConfig:
    """SKQD knobs (reference ``skqd.py:48-72``)."""
    max_krylov_dim: int = 12
    time_step: float = 0.1
    num_trotter_steps: int = 8          # scipy / trotter path substeps
    shots_per_krylov: int = 100_000
    use_cumulative_basis: bool = True
    num_eigenvalues: int = 2
    regularization: float = 1e-8
    use_device_evolution: bool = True
    evolution: str = "auto"   # 'auto' | 'dense' | 'ell' | 'scipy' | 'trotter'
    lanczos_dim: int = 30
    # spin systems beyond this many sites evolve a full 2^n statevector
    # with 2nd-order Trotter over Pauli words instead of materializing the
    # subspace Hamiltonian (reference ``skqd.py:421-536``); 2^17 = 131k is
    # where host sparse-H assembly over the full space stops being cheap
    trotter_threshold: int = 17
    seed: int = 0
    verbose: bool = False


# ---------------------------------------------------------------------------
# On-device Lanczos propagator
# ---------------------------------------------------------------------------

def _lanczos_sweep(mv, psi_re, psi_im, m):
    """m-step Lanczos sweep for exp(-i dt H) |psi> (traced inside jit).

    ``mv(re, im)`` applies the real-symmetric H to a complex vector carried
    as (re, im) f32 pairs.  alpha/beta are real for real-symmetric H even
    with complex vectors, so T is a real tridiagonal.  Returns the Krylov
    basis (V_r, V_i), T's diagonals and the norm of psi.
    """
    n = psi_re.shape[0]
    hp = jax.lax.Precision.HIGHEST      # a GPU f32 matmul is TF32 otherwise
    norm0 = jnp.sqrt(jnp.sum(psi_re ** 2 + psi_im ** 2))
    vr = psi_re / norm0
    vi = psi_im / norm0

    V_r = jnp.zeros((m, n), jnp.float32).at[0].set(vr)
    V_i = jnp.zeros((m, n), jnp.float32).at[0].set(vi)
    alphas = jnp.zeros((m,), jnp.float32)
    betas = jnp.zeros((m,), jnp.float32)  # betas[j] couples j and j+1

    def body(j, carry):
        V_r, V_i, alphas, betas = carry
        vr_j = V_r[j]
        vi_j = V_i[j]
        wr, wi = mv(vr_j, vi_j)
        alpha = jnp.sum(wr * vr_j + wi * vi_j)
        wr = wr - alpha * vr_j
        wi = wi - alpha * vi_j
        beta_prev = jnp.where(j > 0, betas[jnp.maximum(j - 1, 0)], 0.0)
        wr = wr - beta_prev * V_r[jnp.maximum(j - 1, 0)] * (j > 0)
        wi = wi - beta_prev * V_i[jnp.maximum(j - 1, 0)] * (j > 0)
        # full reorthogonalization against all previous vectors (m is small)
        proj_r = (jnp.dot(V_r, wr, precision=hp)
                  + jnp.dot(V_i, wi, precision=hp))          # Re<v_k|w>
        proj_i = (jnp.dot(V_r, wi, precision=hp)
                  - jnp.dot(V_i, wr, precision=hp))          # Im<v_k|w>
        mask = (jnp.arange(m) <= j).astype(jnp.float32)
        proj_r = proj_r * mask
        proj_i = proj_i * mask
        wr = wr - (jnp.dot(proj_r, V_r, precision=hp)
                   - jnp.dot(proj_i, V_i, precision=hp))
        wi = wi - (jnp.dot(proj_r, V_i, precision=hp)
                   + jnp.dot(proj_i, V_r, precision=hp))
        beta = jnp.sqrt(jnp.sum(wr ** 2 + wi ** 2))
        alphas = alphas.at[j].set(alpha)
        betas = betas.at[j].set(beta)
        # Lanczos breakdown (invariant subspace): zero out later vectors so
        # T decouples and the propagator stays exact on the leading block.
        inv = jnp.where(beta > 1e-7, 1.0 / jnp.maximum(beta, 1e-30), 0.0)
        V_r = V_r.at[j + 1].set(wr * inv, mode="drop")
        V_i = V_i.at[j + 1].set(wi * inv, mode="drop")
        return V_r, V_i, alphas, betas

    V_r, V_i, alphas, betas = jax.lax.fori_loop(
        0, m, body, (V_r, V_i, alphas, betas))
    return V_r, V_i, alphas, betas, norm0


@jax.jit
def _combine(cr, ci, V_r, V_i, norm0):
    hp = jax.lax.Precision.HIGHEST
    return ((jnp.dot(cr, V_r, precision=hp)
             - jnp.dot(ci, V_i, precision=hp)) * norm0,
            (jnp.dot(cr, V_i, precision=hp)
             + jnp.dot(ci, V_r, precision=hp)) * norm0)


def _expm_from_sweep(sweep, dt: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """exp(-i dt H) |psi> as (re, im) from a ``_lanczos_sweep`` result.

    exp(-i dt T) e_1 comes from T's float64 host eigendecomposition (see
    ``eigensolver._ground_from_sweep`` for why the small eigensolve
    never runs in f32 on the GPU): the phases dt * E at |E| ~ 100 Ha need
    more digits than an f32 eigenvalue carries."""
    from ..postprocessing.eigensolver import _tridiag_np
    V_r, V_i, alphas, betas, norm0 = sweep
    vals, U = np.linalg.eigh(_tridiag_np(alphas, betas))
    c = (U * np.exp(-1j * float(dt) * vals)[None, :]) @ U[0, :]
    return _combine(jnp.asarray(c.real, jnp.float32),
                    jnp.asarray(c.imag, jnp.float32), V_r, V_i, norm0)


@partial(jax.jit, static_argnames=("m",))
def _sweep_dense(h_dense, psi_re, psi_im, m: int):
    def mv(re, im):
        return (jnp.dot(h_dense, re, precision=jax.lax.Precision.HIGHEST),
                jnp.dot(h_dense, im, precision=jax.lax.Precision.HIGHEST))

    return _lanczos_sweep(mv, psi_re, psi_im, m)


def lanczos_expm(h_dense: jnp.ndarray, psi_re: jnp.ndarray,
                 psi_im: jnp.ndarray, dt, m: int
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense-H Lanczos propagator (matrix-vector products)."""
    return _expm_from_sweep(_sweep_dense(h_dense, psi_re, psi_im, m), dt)


@partial(jax.jit, static_argnames=("m",))
def _sweep_ell(diag, elems, tgt, psi_re, psi_im, m: int):
    from ..ops.ell import ell_spmv

    def mv(re, im):
        return (ell_spmv(diag, elems, tgt, re),
                ell_spmv(diag, elems, tgt, im))

    return _lanczos_sweep(mv, psi_re, psi_im, m)


def lanczos_expm_ell(diag: jnp.ndarray, elems: jnp.ndarray,
                     tgt: jnp.ndarray, psi_re: jnp.ndarray,
                     psi_im: jnp.ndarray, dt, m: int
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ELL-structure Lanczos propagator: fixed-degree sparse matvec
    (``ops/ell.py``), 24x less device-memory traffic than the dense
    matvec for N2-sized subspaces."""
    return _expm_from_sweep(_sweep_ell(diag, elems, tgt, psi_re, psi_im, m),
                           dt)


@partial(jax.jit, static_argnames=("shots",))
def _sample_idx_cdf(key, prob, shots: int):
    """Multinomial sampling by inverse CDF: cumsum + sorted uniforms via
    searchsorted.  Unlike ``jax.random.categorical`` this never
    materializes a (shots, dim) Gumbel tensor, so it scales to 2^24-entry
    statevectors and 100k-shot budgets."""
    cdf = jnp.cumsum(prob)
    u = jax.random.uniform(key, (shots,)) * cdf[-1]
    # side='right' so a draw landing exactly on a cdf plateau boundary
    # (e.g. u == 0.0) can never select a zero-probability index
    return jnp.clip(jnp.searchsorted(cdf, u, side="right"),
                    0, prob.shape[0] - 1)


@partial(jax.jit, static_argnames=("shots", "n"))
def _sample_counts_device(key, psi_re, psi_im, shots: int, n: int):
    idx = _sample_idx_cdf(key, psi_re ** 2 + psi_im ** 2, shots)
    return jnp.bincount(idx, length=n)


# fuse the whole Trotter substep into one XLA program up to this many
# sites; beyond it, per-rotation dispatch bounds live HBM (see below)
_TROTTER_FUSE_MAX_SITES = 20


def _comb(n: int, k: int) -> int:
    from math import comb
    return comb(n, k)


def _sector_states(n: int, k: int) -> np.ndarray:
    """All n-bit states with popcount k, sorted (fixed-magnetization
    sector of a conserving spin Hamiltonian).

    Vectorized Pascal recursion: states(m, j) = states(m-1, j) followed by
    states(m-1, j-1) | 1<<(m-1) — both halves ascending and the second
    strictly above the first, so the result is sorted by construction.
    The itertools.combinations loop this replaces took minutes at the
    C(30,15) = 155M-state scale on this host; this is pure uint32
    concat/add and runs in seconds."""
    prev = {0: np.zeros(1, dtype=np.uint32)}          # m = 0
    for m in range(1, n + 1):
        cur = {}
        for j in range(max(0, k - (n - m)), min(k, m) + 1):
            parts = []
            if j in prev:
                parts.append(prev[j])
            if j - 1 in prev:
                parts.append(prev[j - 1] + np.uint32(1 << (m - 1)))
            cur[j] = parts[0] if len(parts) == 1 else np.concatenate(parts)
        prev = cur
    assert len(prev[k]) == _comb(n, k)
    return prev[k]


# ---------------------------------------------------------------------------
# SKQD
# ---------------------------------------------------------------------------

class SampleBasedKrylovDiagonalization:
    """Classical SKQD in the particle-conserving subspace."""

    def __init__(self, hamiltonian: Hamiltonian,
                 config: Optional[SKQDConfig] = None,
                 initial_state: Optional[np.ndarray] = None,
                 mesh=None, subspace_states: Optional[np.ndarray] = None):
        self.h = hamiltonian
        self.config = config or SKQDConfig()
        self.mesh = mesh  # optional ('data','basis') Mesh: H rows sharded
        self.is_molecular = hasattr(hamiltonian, "n_alpha")
        # optional explicit evolution subspace (restricted SKQD): evolve
        # within the given packed states instead of enumerating the full
        # particle-conserving space — the stage-4 route for molecular
        # systems whose full space is beyond enumeration (VERDICT r3
        # item 3; reference subspace setup ``skqd.py:135-177`` is the
        # full-space special case)
        self.restricted = subspace_states is not None

        # initial state: HF for molecules, Neel otherwise (``skqd.py:114-120``)
        if initial_state is None:
            if self.is_molecular:
                initial_state = hamiltonian.get_hf_state()
            else:
                n = hamiltonian.n_sites
                neel = 0
                for i in range(0, n, 2):
                    neel |= (1 << i)
                initial_state = np.array([neel], dtype=np.uint32)
        self.initial_state = np.asarray(initial_state, np.uint32)

        # Magnetization-conserving spin systems (XXZ without transverse
        # fields) evolve inside the fixed-popcount sector of the initial
        # state — the spin analog of the molecular particle-conserving
        # subspace trick (Heisenberg-10: 1,024 -> 252).
        self._sector_n_up: Optional[int] = None
        if (not self.is_molecular
                and getattr(hamiltonian, "conserves_magnetization", False)):
            self._sector_n_up = int(
                bin(int(self.initial_state.reshape(-1)[0])).count("1"))

        # Large spin systems evolve a full 2^n statevector with Trotterized
        # Pauli rotations (reference ``skqd.py:421-536``) instead of
        # enumerating the space and assembling a subspace Hamiltonian —
        # 2^24 complex64 is 128 MB of HBM, while the sparse H would hold
        # ~2^24 * n_sites nonzeros.  Trotter error only perturbs *which*
        # configs get sampled; the projected eigensolve is exact either way.
        # A conserved-sector space small enough to enumerate stays on the
        # subspace path regardless of the site count.
        c = self.config
        n_sites = hamiltonian.n_sites
        sector_small = False
        if self._sector_n_up is not None:
            sector_dim = _comb(n_sites, self._sector_n_up)
            # enumerable outright, or big but still ELL-evolvable on device
            # (entries budget from HBM: Heisenberg-24's 2.7M-state sector
            # at 25 connections/state is ~68M entries)
            from ..utils.memory import MemoryBudget
            sector_small = (
                sector_dim <= (1 << c.trotter_threshold)
                or sector_dim * (hamiltonian.n_connections + 1)
                <= MemoryBudget.for_device().connection_table_entries())
        self.use_trotter = (not self.is_molecular) and (
            c.evolution == "trotter"
            or (c.evolution == "auto" and n_sites > c.trotter_threshold
                and not sector_small))

        # subspace setup (reference ``skqd.py:135-177``)
        if subspace_states is not None:
            self.use_trotter = False
            self.subspace = np.atleast_2d(
                np.asarray(subspace_states, np.uint32))
        elif self.use_trotter:
            self.subspace = None
            self.dim = 1 << n_sites
            self._keys = self._order = self._sorted_keys = None
        elif self.is_molecular:
            self.subspace = hamiltonian.enumerate_basis()      # (N, 2) uint32
        elif self._sector_n_up is not None:
            states = _sector_states(n_sites, self._sector_n_up)
            self.subspace = states[:, None]                    # (N, 1)
        else:
            states = np.arange(1 << n_sites, dtype=np.uint32)
            self.subspace = states[:, None]                    # (N, 1)
        if self.subspace is not None:
            self.dim = len(self.subspace)
            self._keys = self.h.keys(self.subspace)
            self._order = np.argsort(self._keys)
            self._sorted_keys = self._keys[self._order]

        self._h_sparse: Optional[sp.csr_matrix] = None
        self._h_dense_dev = None
        self._ell = None
        self._trotter = None
        self.key = jax.random.PRNGKey(self.config.seed)

    # ------------------------------------------------------------------

    def _index_of(self, packed: np.ndarray) -> np.ndarray:
        keys = self.h.keys(np.atleast_2d(packed))
        pos = np.searchsorted(self._sorted_keys, keys)
        pos = np.clip(pos, 0, self.dim - 1)
        if not (self._sorted_keys[pos] == keys).all():
            raise ValueError("state outside the particle-conserving subspace")
        return self._order[pos]

    @property
    def subspace_hamiltonian(self) -> sp.csr_matrix:
        """Sparse subspace H, built once (reference ``skqd.py:374-419``)."""
        if self.subspace is None:
            raise RuntimeError(
                "Trotter mode never materializes the subspace Hamiltonian "
                f"(2^{self.h.n_sites} states); use the statevector path")
        if self._h_sparse is None:
            self._h_sparse = self.h.to_sparse(self.subspace)
        return self._h_sparse

    # ------------------------------------------------------------------
    # Statevector Trotter propagator (large spin systems)
    # ------------------------------------------------------------------

    def _trotter_ops(self):
        """Jitted 2nd-order Trotter substep over the Hamiltonian's Pauli
        words (reference ``skqd.py:421-536``).

        All diagonal words (x_mask == 0) fold into ONE precomputed phase
        vector exp(-i dt/2 * D); off-diagonal words become fused
        XOR-permute + phase rotations (``basis_sampler.py`` machinery),
        applied forward then in reverse at half angle so the splitting is
        symmetric.  The substep compiles once per (H, dt)."""
        if self._trotter is not None:
            return self._trotter

        from ..hamiltonians.spin import extract_coeffs_and_paulis
        from .basis_sampler import _pauli_masks, _pauli_rotation_pair

        coeffs, words = extract_coeffs_and_paulis(self.h)
        n = self.h.n_sites
        masks = [_pauli_masks(w) for w in words]
        diag = [(c, zm) for c, (xm, zm, _) in zip(coeffs, masks) if xm == 0]
        offd = [(c, xm, zm, ny) for c, (xm, zm, ny) in zip(coeffs, masks)
                if xm != 0]
        dt_sub = self.config.time_step / max(self.config.num_trotter_steps, 1)

        if self.mesh is not None:
            from ..parallel.sharded_trotter import (make_sharded_substep,
                                                    mesh_supports_statevector)
            if mesh_supports_statevector(self.mesh, n):
                # statevector sharded over the mesh: high-bit XOR flips
                # become block permutes across devices, everything else
                # stays local
                self._trotter = make_sharded_substep(self.mesh, n, diag,
                                                     offd, dt_sub)
                return self._trotter

        # exp(-i dt/2 * D) as a (cos, sin) f32 pair, the same (re, im)
        # layout the statevector is carried in
        @jax.jit
        def _half_phase():
            idx = jnp.arange(self.dim, dtype=jnp.uint32)
            D = jnp.zeros(self.dim, jnp.float32)
            for c, zm in diag:
                par = jax.lax.population_count(idx & jnp.uint32(zm))
                sign = 1.0 - 2.0 * (par & jnp.uint32(1)).astype(jnp.float32)
                D = D + jnp.float32(c) * sign
            ang = 0.5 * dt_sub * D
            return jnp.cos(ang), -jnp.sin(ang)

        hp_re, hp_im = _half_phase()

        if n <= _TROTTER_FUSE_MAX_SITES:
            # one fused XLA program: cheapest dispatch for small vectors
            @jax.jit
            def substep(re, im, hr, hi):
                def diag_mul(re, im):
                    return re * hr - im * hi, re * hi + im * hr

                re, im = diag_mul(re, im)
                for c, xm, zm, ny in offd:
                    re, im = _pauli_rotation_pair(
                        re, im, jnp.float32(c * dt_sub / 2), xm, zm, ny, n)
                for c, xm, zm, ny in reversed(offd):
                    re, im = _pauli_rotation_pair(
                        re, im, jnp.float32(c * dt_sub / 2), xm, zm, ny, n)
                return diag_mul(re, im)
        else:
            # large statevectors: one jit PER rotation.  Fusing the whole
            # 2nd-order substep keeps every rotation's intermediates live
            # in XLA's buffer assignment (tens of statevectors for
            # TFIM-26's 52 rotations at 2^26 amplitudes); per-rotation
            # dispatch bounds live memory at a handful of statevectors and
            # the dispatch overhead is negligible next to the 268 MB flips.
            from .basis_sampler import _apply_pauli_rotation

            @jax.jit
            def diag_mul(re, im, hr, hi):
                return re * hr - im * hi, re * hi + im * hr

            def substep(re, im, hr, hi):
                re, im = diag_mul(re, im, hr, hi)
                for c, xm, zm, ny in offd:
                    re, im = _apply_pauli_rotation(
                        re, im, jnp.float32(c * dt_sub / 2), xm, zm, ny, n)
                for c, xm, zm, ny in reversed(offd):
                    re, im = _apply_pauli_rotation(
                        re, im, jnp.float32(c * dt_sub / 2), xm, zm, ny, n)
                return diag_mul(re, im, hr, hi)

        self._trotter = (substep, hp_re, hp_im)
        return self._trotter

    def _evolve_trotter(self, re: jnp.ndarray, im: jnp.ndarray
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        substep, hp_re, hp_im = self._trotter_ops()
        for _ in range(max(self.config.num_trotter_steps, 1)):
            re, im = substep(re, im, hp_re, hp_im)
        return re, im

    def _device_hamiltonian(self):
        if self._h_dense_dev is None:
            h_np = self.subspace_hamiltonian.toarray().astype(np.float32)
            if self.mesh is not None:
                # zero-pad rows/cols to a device-count multiple, then shard
                # rows over all mesh devices; the jitted Lanczos propagator
                # inherits the sharding from its committed input.  The
                # zero pad block is inert under the matvec (pad entries of
                # psi start at 0 and stay 0).
                nd = self.mesh.size
                pad = (-h_np.shape[0]) % nd
                if pad:
                    h_np = np.pad(h_np, ((0, pad), (0, pad)))
                from ..parallel.sharded_matvec import shard_hamiltonian_rows
                self._h_dense_dev = shard_hamiltonian_rows(
                    self.mesh, jnp.asarray(h_np))
            else:
                self._h_dense_dev = jnp.asarray(h_np)
        return self._h_dense_dev

    def _dense_evolution_cap(self) -> int:
        """Max subspace dim for the dense device propagator: each chip
        holds rows_per_chip * dim f32.  The single-chip cap is HBM-derived
        (reference's GPU-memory-aware sizing, ``system_scaler.py:399-437``)
        and scales by sqrt(n_devices) so per-chip HBM stays constant."""
        from ..utils.memory import MemoryBudget
        n_dev = self.mesh.size if self.mesh is not None else 1
        cap = min(MemoryBudget.for_device().dense_hamiltonian_cap(), 20_000)
        return int(cap * np.sqrt(n_dev))

    def _ell_fits_memory(self) -> bool:
        """True when the fixed-degree (index, element) connection table of
        the subspace fits the HBM connection-table budget.  A mesh shards
        the table rows over all devices, so the budget scales linearly
        with the device count."""
        if self.subspace is None:
            return False
        from ..utils.memory import MemoryBudget
        n_dev = self.mesh.size if self.mesh is not None else 1
        entries = self.dim * (self.h.n_connections + 1)
        return entries <= (MemoryBudget.for_device().connection_table_entries()
                           * n_dev)

    # ------------------------------------------------------------------
    # Time evolution
    # ------------------------------------------------------------------

    def _evolve_scipy(self, psi: np.ndarray) -> np.ndarray:
        """Float64 reference propagator (scipy expm_multiply semantics,
        ``skqd.py:241-296``)."""
        H = self.subspace_hamiltonian
        dt = self.config.time_step
        return spla.expm_multiply(-1j * dt * H, psi)

    def _evolve_device(self, psi: np.ndarray) -> np.ndarray:
        H = self._device_hamiltonian()
        pad = H.shape[0] - self.dim          # mesh padding (see above)
        re_np = np.real(psi).astype(np.float32)
        im_np = np.imag(psi).astype(np.float32)
        if pad:
            re_np = np.pad(re_np, (0, pad))
            im_np = np.pad(im_np, (0, pad))
        re = jnp.asarray(re_np)
        im = jnp.asarray(im_np)
        m = min(self.config.lanczos_dim, self.dim)
        out_r, out_i = lanczos_expm(H, re, im,
                                    jnp.float32(self.config.time_step), m)
        out = np.asarray(out_r) + 1j * np.asarray(out_i)
        return out[:self.dim] if pad else out

    def _shard_ell(self):
        """Row-shard the cached ELL structure over all mesh devices: each
        chip holds dim/n_devices rows of (diag, elems, target_idx); psi
        stays replicated so the gather is local and the matvec result
        lands row-sharded (XLA inserts the all-gathers for the Lanczos
        inner products from the sharding annotations)."""
        if self.mesh is None or self._ell is None:
            return
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        nd = self.mesh.size
        pad = (-self.dim) % nd
        diag, elems_t, tgt_t = self._ell
        if pad:
            diag = jnp.pad(diag, (0, pad))
            elems_t = jnp.pad(elems_t, ((0, 0), (0, pad)))
            tgt_t = jnp.pad(tgt_t, ((0, 0), (0, pad)))
        rows1 = NamedSharding(self.mesh, P(("data", "basis")))
        rows2 = NamedSharding(self.mesh, P(None, ("data", "basis")))
        self._ell = (jax.device_put(diag, rows1),
                     jax.device_put(elems_t, rows2),
                     jax.device_put(tgt_t, rows2))
        self._ell_pad = pad

    def _device_ell_key_bits(self) -> Optional[int]:
        """Bit width for packing one state into a single uint32 device
        sort/search key: 0 for single-word packings, n_orb for molecular
        (alpha << n_orb) | beta when 2*n_orb <= 32, None when no uint32
        key exists (the host ELL build takes over)."""
        W = getattr(self.h, "pack_words", 1)
        if W == 1:
            return 0
        n_bits = getattr(getattr(self.h, "tables", None), "n_orb", None)
        if n_bits is not None and 2 * n_bits <= 32:
            return int(n_bits)
        return None

    def _build_ell_device(self, states: np.ndarray):
        """Build a basis-restricted ELL table ON DEVICE for packed states:
        only the packed states cross the host link; connections,
        membership (searchsorted over sorted uint32 keys) and elements are
        computed in jitted chunks.  A 2.7M-state Heisenberg-24 sector
        table is ~500 MB of HBM but only ~11 MB of transfer.  Works for
        any state set — the full conserved sector, a sampled Krylov basis,
        or a PT2-ranked restricted molecular subspace (W=2 keys pack as
        (alpha << n_orb) | beta while 2*n_orb <= 32)."""
        dim = len(states)
        n_bits = self._device_ell_key_bits()
        if n_bits == 0:
            keys32 = states[:, 0].astype(np.uint32)
        else:
            keys32 = ((states[:, 0].astype(np.uint32) << np.uint32(n_bits))
                      | states[:, 1].astype(np.uint32))
        sorted_states = jnp.asarray(np.sort(keys32))
        order = jnp.asarray(np.argsort(keys32).astype(np.int32))
        conn_fn = self.h.connections_device
        diag_fn = self.h.diagonal_device

        @jax.jit
        def build_chunk(packed2):
            conn, elems = conn_fn(packed2)          # (M,C,W),(M,C)
            if n_bits == 0:
                keys = conn[..., 0].reshape(-1)
            else:
                keys = ((conn[..., 0].reshape(-1) << jnp.uint32(n_bits))
                        | conn[..., 1].reshape(-1))
            pos = jnp.clip(jnp.searchsorted(sorted_states, keys),
                           0, dim - 1)
            hit = sorted_states[pos] == keys
            tgt = jnp.where(hit, order[pos], 0).astype(jnp.int32)
            el = jnp.where(hit.reshape(elems.shape), elems, 0.0)
            # tables transposed per chunk into the (C, N) ELL layout
            # (``ops/ell.py``)
            return (diag_fn(packed2).astype(jnp.float32),
                    el.astype(jnp.float32).T,
                    tgt.reshape(elems.shape).T)

        chunk = 262_144
        parts = [build_chunk(jnp.asarray(states[i:i + chunk]))
                 for i in range(0, dim, chunk)]
        return (jnp.concatenate([p[0] for p in parts]),
                jnp.concatenate([p[1] for p in parts], axis=1),
                jnp.concatenate([p[2] for p in parts], axis=1))

    def _ell_structure(self):
        """ELL (diag, elems_t, target_idx_t) for the fixed-degree subspace
        matvec, tables in the (C, N) transposed layout (see
        ``ops/ell.py``); rows mesh-sharded when a mesh is configured."""
        if self._ell is None:
            if self.is_molecular and not self.restricted:
                from ..utils.connection_table import build_connection_table
                t = build_connection_table(self.h, max_entries=200_000_000)
                if t is None:
                    return None
                self._ell = (t.diag, jnp.transpose(t.elems),
                             jnp.transpose(t.target_idx))
            elif (self._device_ell_key_bits() is not None
                  and hasattr(self.h, "connections_device")):
                self._ell = self._build_ell_device(self.subspace)
            else:
                conn, elems = self.h.connections_np(self.subspace)
                keys = self.h.keys(conn.reshape(-1, conn.shape[-1]))
                pos = np.searchsorted(self._sorted_keys, keys)
                pos = np.clip(pos, 0, self.dim - 1)
                tgt = self._order[pos].reshape(elems.shape)
                self._ell = (jnp.asarray(self.h.diagonal_np(self.subspace),
                                         jnp.float32),
                             jnp.asarray(elems.T, jnp.float32),
                             jnp.asarray(tgt.T.astype(np.int32)))
            self._shard_ell()
        return self._ell

    def _evolve_device_ell(self, psi: np.ndarray) -> np.ndarray:
        ell = self._ell_structure()
        if ell is None:
            return self._evolve_device(psi)
        diag, elems, tgt = ell
        pad = getattr(self, "_ell_pad", 0)
        re_np = np.real(psi).astype(np.float32)
        im_np = np.imag(psi).astype(np.float32)
        if pad:
            re_np = np.pad(re_np, (0, pad))
            im_np = np.pad(im_np, (0, pad))
        re = jnp.asarray(re_np)
        im = jnp.asarray(im_np)
        m = min(self.config.lanczos_dim, self.dim)
        dt = jnp.float32(self.config.time_step)
        out_r, out_i = lanczos_expm_ell(diag, elems, tgt, re, im, dt, m)
        out = np.asarray(out_r) + 1j * np.asarray(out_i)
        return out[:self.dim] if pad else out

    def evolve(self, psi: np.ndarray) -> np.ndarray:
        mode = self.config.evolution
        if not self.config.use_device_evolution or self.dim <= 1:
            mode = "scipy"
        if mode == "auto":
            # dense to ~20k rows per device; a mesh shards rows across
            # devices, raising the cap by sqrt(n_devices).  Beyond that the
            # fixed-degree ELL matvec keeps evolution on device while its
            # (index, element) table fits the device-memory budget
            # (million-state conserved sectors); past both, the f64 host
            # propagator.
            if self.dim <= self._dense_evolution_cap():
                mode = "dense"
            elif self._ell_fits_memory():
                mode = "ell"
            else:
                mode = "scipy"
        if mode == "ell":
            return self._evolve_device_ell(psi)
        if mode == "dense":
            return self._evolve_device(psi)
        return self._evolve_scipy(psi)

    # ------------------------------------------------------------------
    # Sampling
    # ------------------------------------------------------------------

    def sample_state(self, psi: np.ndarray, shots: int) -> Dict[int, int]:
        """Measurement counts {subspace_index: count}
        (reference ``skqd.py:538-579``)."""
        self.key, k = jax.random.split(self.key)
        counts = np.asarray(_sample_counts_device(
            k, jnp.asarray(np.real(psi), jnp.float32),
            jnp.asarray(np.imag(psi), jnp.float32), shots, self.dim))
        nz = np.nonzero(counts)[0]
        return {int(i): int(counts[i]) for i in nz}

    def generate_krylov_samples(self) -> List[Dict[int, int]]:
        """Sample at every Krylov step k=0..K-1, evolving in between
        (reference ``skqd.py:581-635``)."""
        c = self.config
        if self.use_trotter:
            return self._generate_krylov_samples_trotter()
        psi = np.zeros(self.dim, dtype=np.complex128)
        psi[self._index_of(self.initial_state)[0]] = 1.0
        samples = []
        for k in range(c.max_krylov_dim):
            samples.append(self.sample_state(psi, c.shots_per_krylov))
            if k < c.max_krylov_dim - 1:
                psi = self.evolve(psi)
                psi = psi / np.linalg.norm(psi)
        return samples

    def _generate_krylov_samples_trotter(self) -> List[Dict[int, int]]:
        """Statevector path: psi stays a device complex64 2^n vector for
        the whole Krylov sweep; sampling is cumsum + searchsorted (no
        (shots, 2^n) intermediates)."""
        c = self.config
        start = int(np.atleast_2d(self.initial_state)[0, 0])
        re = jnp.zeros(self.dim, jnp.float32).at[start].set(1.0)
        im = jnp.zeros(self.dim, jnp.float32)
        if self.mesh is not None:
            from ..parallel.sharded_trotter import (mesh_supports_statevector,
                                                    shard_statevector)
            if mesh_supports_statevector(self.mesh, self.h.n_sites):
                re, im = shard_statevector(self.mesh, re, im)
        samples = []
        for k in range(c.max_krylov_dim):
            self.key, sk = jax.random.split(self.key)
            idx = np.asarray(_sample_idx_cdf(sk, re ** 2 + im ** 2,
                                             c.shots_per_krylov))
            vals, counts = np.unique(idx, return_counts=True)
            samples.append({int(v): int(ct)
                            for v, ct in zip(vals, counts)})
            if k < c.max_krylov_dim - 1:
                re, im = self._evolve_trotter(re, im)
        return samples

    def build_cumulative_basis(self, samples: List[Dict[int, int]]
                               ) -> List[np.ndarray]:
        """Running union of sampled configs per Krylov dimension
        (reference ``skqd.py:637-656``)."""
        seen: Dict[int, int] = {}
        bases = []
        for counts in samples:
            for idx, ct in counts.items():
                seen[idx] = seen.get(idx, 0) + ct
            idxs = np.sort(np.fromiter(seen.keys(), dtype=np.int64))
            if self.subspace is None:
                # trotter mode: sampled indices ARE the packed configs
                bases.append(idxs.astype(np.uint32)[:, None])
            else:
                bases.append(self.subspace[idxs])
        return bases

    # ------------------------------------------------------------------
    # Projected eigensolve with stability guardrails
    # ------------------------------------------------------------------

    def compute_ground_state_energy(self, basis: np.ndarray,
                                    return_vector: bool = False):
        """Project H on ``basis`` and diagonalize with the reference's
        guardrails (``skqd.py:683-843``): Hermitize, regularize, condition
        check -> SVD fallback, dense/sparse routing."""
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        nb = len(basis)
        reg = self.config.regularization

        if nb > 2048:
            v0 = None
            if (nb > 200_000 and not self.is_molecular
                    and getattr(self.h, "pack_words", 1) == 1
                    and hasattr(self.h, "connections_device")):
                # half-million-state sampled bases: a device f32 ELL
                # Lanczos gets the ground vector to ~1e-4, and seeding
                # ARPACK with it cuts the host f64 solve from hundreds of
                # 10M+-nonzero matvecs to a handful of restarts
                from ..postprocessing.eigensolver import \
                    lanczos_ground_state_ell
                from ..utils.memory import MemoryBudget
                ell = self._build_ell_device(basis)
                m_fit = MemoryBudget.for_device().lanczos_ell_m(
                    ell[0].shape[0], ell[1].shape[0], m_max=80)
                _, v = lanczos_ground_state_ell(*ell, m=min(m_fit, nb))
                v0 = np.asarray(v, np.float64)
                del ell
            M = self.h.to_sparse(basis)
            M = (M + M.T) * 0.5 + reg * sp.eye(nb)
            k = min(self.config.num_eigenvalues, nb - 1)
            try:
                vals, vecs = spla.eigsh(M, k=max(k, 1), which="SA", v0=v0)
            except spla.ArpackNoConvergence:
                H = M.toarray()
                vals, vecs = np.linalg.eigh(H)
            idx = np.argsort(vals)
            e = float(vals[idx][0] - reg)
            if return_vector:
                return e, vecs[:, idx][:, 0]
            return e

        H = self.h.matrix_elements(basis, basis)
        H = 0.5 * (H + H.T) + reg * np.eye(nb)
        cond = np.linalg.cond(H) if nb > 1 else 1.0
        if not np.isfinite(cond) or cond > 1e12:
            # SVD fallback with singular-value clamping (``skqd.py:809-843``)
            u, s, vt = np.linalg.svd(H)
            s = np.maximum(s, 1e-10)
            H = u @ np.diag(s) @ vt
            H = 0.5 * (H + H.T)
        vals, vecs = np.linalg.eigh(H)
        e = float(vals[0] - reg)
        if return_vector:
            return e, vecs[:, 0]
        return e

    # ------------------------------------------------------------------

    def _oracle_cache_path(self):
        """Disk-cache location for the sector-oracle energy, keyed by the
        Hamiltonian content and sector size.  The refine step costs ~17 min
        of host Lanczos on the 2.7M-state Heisenberg-24 sector; the oracle
        is benchmark instrumentation, so caching only removes repeat-run
        latency (mirrors ``MolecularHamiltonian._fci_disk_cache_path``)."""
        import hashlib
        import os
        from pathlib import Path
        h = self.h
        hsh = hashlib.sha1()
        hsh.update(type(h).__name__.encode())
        for attr in ("n_sites", "Jx", "Jy", "Jz", "V", "h", "L", "periodic"):
            hsh.update(repr(getattr(h, attr, None)).encode())
        for attr in ("h_x", "h_y", "h_z"):
            v = getattr(h, attr, None)
            if v is not None:
                hsh.update(np.asarray(v, np.float64).tobytes())
        hsh.update(bytes(memoryview(np.int64([self.dim]))))
        root = Path(os.environ.get(
            "FGK_INTEGRAL_CACHE",
            Path.home() / ".cache" / "fgk_integrals"))
        return root / f"sector_{hsh.hexdigest()}.txt"

    def exact_subspace_energy(self, m: int = 120, refine_host: bool = True,
                              tol: float = 1e-9) -> float:
        """Exact ground-state energy of the FULL enumerated subspace.

        The oracle for large-sector capability claims (VERDICT round 2
        item 1): device ELL Lanczos (f32, full reorthogonalization) finds
        the sector ground state, then a host f64 ``eigsh`` seeded with the
        device eigenvector polishes it to oracle grade.  For molecular
        Hamiltonians this equals ``fci_energy``; its value is the spin
        sectors (Heisenberg-24: 2,704,156 states) where no independent
        oracle existed.
        """
        if self.subspace is None:
            raise RuntimeError(
                "Trotter mode has no enumerated subspace; the exact energy "
                "of the full 2^n space is out of reach by construction")
        path = self._oracle_cache_path()
        if refine_host:
            try:
                return float(path.read_text())
            except (OSError, ValueError):
                pass
        v0 = None
        e_dev = None
        ell = self._ell_structure()
        if ell is not None:
            from ..postprocessing.eigensolver import lanczos_ground_state_ell
            from ..utils.memory import MemoryBudget
            m_fit = MemoryBudget.for_device().lanczos_ell_m(
                ell[0].shape[0], ell[1].shape[0], m_max=m)
            # memory-capped blocks recover depth through restarts
            n_restart = max(1, -(-m // m_fit))
            e_dev, v = lanczos_ground_state_ell(
                *ell, m=min(m_fit, self.dim), restarts=n_restart)
            v0 = np.asarray(v, np.float64)[:self.dim]  # drop mesh padding
        if not refine_host:
            if e_dev is None:
                raise RuntimeError("no device ELL structure available")
            return float(e_dev)
        H = self.subspace_hamiltonian
        H = (H + H.T) * 0.5
        vals = spla.eigsh(H, k=1, which="SA", v0=v0, tol=tol,
                          return_eigenvectors=False)
        e = float(vals.min())
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(repr(e))
        except OSError:
            pass
        return e

    def run(self, final_only: bool = False) -> Dict:
        """Energies vs Krylov dimension on cumulative bases
        (reference ``skqd.py:845-888``).  ``final_only`` skips the
        intermediate cumulative eigensolves — at 500k+-state bases each
        one costs minutes of host ARPACK, and convergence studies only
        need the last."""
        samples = self.generate_krylov_samples()
        bases = self.build_cumulative_basis(samples)
        if final_only:
            energies = [np.nan] * (len(bases) - 1) + [
                self.compute_ground_state_energy(bases[-1])]
        else:
            energies = [self.compute_ground_state_energy(b) for b in bases]
        return {
            "energies": energies,
            "basis_sizes": [len(b) for b in bases],
            "bases": bases,
            "samples": samples,
            "final_energy": energies[-1] if energies else np.nan,
        }


class FlowGuidedSKQD(SampleBasedKrylovDiagonalization):
    """SKQD seeded/combined with a normalizing-flow-discovered basis
    (reference ``skqd.py:891-1059``)."""

    def __init__(self, hamiltonian: Hamiltonian, nf_basis: np.ndarray,
                 config: Optional[SKQDConfig] = None,
                 initial_state: Optional[np.ndarray] = None,
                 mesh=None, subspace_states: Optional[np.ndarray] = None):
        super().__init__(hamiltonian, config, initial_state, mesh=mesh,
                         subspace_states=subspace_states)
        self.nf_basis = np.atleast_2d(np.asarray(nf_basis, np.uint32))

    def get_combined_basis(self, krylov_basis: np.ndarray) -> np.ndarray:
        """unique(NF union Krylov) (``skqd.py:914-944``)."""
        both = np.concatenate([self.nf_basis, krylov_basis], axis=0)
        keys = self.h.keys(both)
        _, idx = np.unique(keys, return_index=True)
        return both[np.sort(idx)]

    # above this NF-basis size the per-k eigensolve ladder (1 + 2K host
    # solves, each a fresh >minutes CSR build + ARPACK at 500k+ rows)
    # costs hours; only the final cumulative union is diagonalized
    FINAL_ONLY_NF_ROWS = 100_000

    def run_with_nf(self, final_only: Optional[bool] = None) -> Dict:
        """Per-k Krylov-only vs combined energies with variational
        monotonicity checks and best-stable tracking (``skqd.py:946-1059``).

        ``final_only`` (auto above ``FINAL_ONLY_NF_ROWS`` NF rows) skips
        the intermediate per-k eigensolves — the reference's per-k
        instability bookkeeping is a small-system diagnostic, not worth
        16 ARPACK solves over ~600k-row bases."""
        c = self.config
        if final_only is None:
            final_only = len(self.nf_basis) > self.FINAL_ONLY_NF_ROWS
        nf_energy = self.compute_ground_state_energy(self.nf_basis)

        samples = self.generate_krylov_samples()
        bases = self.build_cumulative_basis(samples)

        krylov_energies: List[float] = []
        combined_energies: List[float] = []
        combined_sizes: List[int] = []
        instabilities: List[int] = []
        best_stable = nf_energy
        prev_combined = nf_energy

        for k, kb in enumerate(bases):
            if final_only and k < len(bases) - 1:
                continue
            e_k = self.compute_ground_state_energy(kb)
            combined = self.get_combined_basis(kb)
            e_c = self.compute_ground_state_energy(combined)
            krylov_energies.append(e_k)
            combined_energies.append(e_c)
            combined_sizes.append(len(combined))

            rise = e_c - prev_combined
            jump = abs(e_c - prev_combined)
            stable = not (rise > 1e-3 or jump > 1.0)
            if not stable:
                instabilities.append(k)
                if c.verbose:
                    print(f"  [skqd] instability at k={k}: "
                          f"E_combined={e_c:.6f} (prev {prev_combined:.6f})")
            else:
                best_stable = min(best_stable, e_c)
            prev_combined = e_c

        return {
            "nf_only_energy": nf_energy,
            "nf_basis_size": int(len(self.nf_basis)),
            "krylov_energies": krylov_energies,
            "combined_energies": combined_energies,
            "combined_sizes": combined_sizes,
            "krylov_basis_sizes": [len(b) for b in bases],
            "krylov_bases": bases,
            "instabilities": instabilities,
            "best_stable_energy": float(best_stable),
            "final_energy": float(best_stable),
        }
