"""Eigensolvers for projected subspace Hamiltonians.

Counterpart of ``/root/reference/src/postprocessing/eigensolver.py`` plus an
on-device addition:

* :func:`solve_generalized_eigenvalue` — Hv = E S v (the hook for Krylov
  overlap matrices), dense or sparse (``eigensolver.py:28-92``).
* :func:`regularize_overlap_matrix` — eigenvalue clamping
  (``eigensolver.py:152-191``).
* :class:`DavidsonSolver` — Davidson with diagonal preconditioning, QR
  re-orthogonalization and subspace collapse (``eigensolver.py:194-366``),
  host float64 (final eigensolves need f64; SURVEY.md §7.3 item 4).
* :func:`adaptive_eigensolver` — size-based routing
  (``eigensolver.py:400-453``).
* :func:`lanczos_ground_state` — NEW: jitted on-device Lanczos for large
  (optionally mesh-sharded) matvecs; the device path for subspace
  diagonalization beyond dense-eigh sizes.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax
import jax.numpy as jnp

__all__ = ["solve_generalized_eigenvalue", "regularize_overlap_matrix",
           "DavidsonSolver", "adaptive_eigensolver", "lanczos_ground_state",
           "lanczos_ground_state_ell"]


def solve_generalized_eigenvalue(H: np.ndarray,
                                 S: Optional[np.ndarray] = None,
                                 k: int = 1,
                                 which: str = "SA",
                                 regularization: float = 0.0
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Solve H v = E S v for the lowest-k eigenpairs (host float64)."""
    H = np.asarray(H, np.float64)
    n = H.shape[0]
    H = 0.5 * (H + H.T)
    if regularization > 0:
        H = H + regularization * np.eye(n)
    if S is None:
        if n <= 2048 or k >= n - 1:
            vals, vecs = np.linalg.eigh(H)
            return vals[:k], vecs[:, :k]
        vals, vecs = spla.eigsh(sp.csr_matrix(H), k=k, which=which)
        idx = np.argsort(vals)
        return vals[idx], vecs[:, idx]
    S = 0.5 * (np.asarray(S, np.float64) + np.asarray(S, np.float64).T)
    S = regularize_overlap_matrix(S)
    vals, vecs = sla.eigh(H, S)
    return vals[:k], vecs[:, :k]


def regularize_overlap_matrix(S: np.ndarray,
                              threshold: float = 1e-10) -> np.ndarray:
    """Clamp overlap eigenvalues to >= threshold (``eigensolver.py:152-191``)."""
    vals, vecs = np.linalg.eigh(S)
    vals = np.maximum(vals, threshold)
    return (vecs * vals) @ vecs.T


class DavidsonSolver:
    """Davidson iteration for the lowest eigenpair of a large symmetric H."""

    def __init__(self, max_subspace: int = 30, max_iterations: int = 200,
                 tol: float = 1e-9):
        self.max_subspace = max_subspace
        self.max_iterations = max_iterations
        self.tol = tol
        # post-solve diagnostics (callers use these to decide fallback)
        self.converged = False
        self.n_matvecs = 0
        self.final_residual = np.inf

    def solve(self, matvec: Callable[[np.ndarray], np.ndarray],
              diagonal: np.ndarray, k: int = 1,
              v0: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Round-5 hot-loop shape: the subspace lives in preallocated
        (n, max_subspace) buffers (the old per-iteration ``concatenate``
        memcpy'd the whole subspace), and the Gram matrix T = V^T W grows
        by ONE row/column per iteration (one n*m gemv; recomputing the
        full T was n*m^2 per iteration and dominated deep million-state
        SCI diag walls — H is symmetric, so T[m,j] = w_m . v_j =
        t_m . w_j = T[j,m] and a single new column determines both)."""
        n = len(diagonal)
        self.converged = False
        self.n_matvecs = 1
        if v0 is None:
            v0 = np.zeros(n)
            v0[int(np.argmin(diagonal))] = 1.0
        ms = self.max_subspace
        V = np.empty((n, ms), np.float64, order="F")
        W = np.empty((n, ms), np.float64, order="F")
        T = np.zeros((ms, ms))
        V[:, 0] = v0 / np.linalg.norm(v0)
        W[:, 0] = matvec(V[:, 0])
        T[0, 0] = V[:, 0] @ W[:, 0]
        theta = float(T[0, 0])
        x = V[:, 0]
        m = 1

        for _ in range(self.max_iterations):
            vals, vecs = np.linalg.eigh(T[:m, :m])
            theta = vals[0]
            y = vecs[:, 0]
            x = V[:, :m] @ y
            r = W[:, :m] @ y - theta * x
            rnorm = np.linalg.norm(r)
            self.final_residual = float(rnorm)
            if rnorm < self.tol:
                self.converged = True
                break
            # diagonal preconditioner
            denom = diagonal - theta
            denom = np.where(np.abs(denom) < 1e-8,
                             np.sign(denom + 1e-30) * 1e-8, denom)
            t = -r / denom
            # orthogonalize against V (QR-style re-orthogonalization)
            t = t - V[:, :m] @ (V[:, :m].T @ t)
            t = t - V[:, :m] @ (V[:, :m].T @ t)
            tn = np.linalg.norm(t)
            if tn < 1e-12:
                break
            t = t / tn
            if m >= ms:
                # collapse subspace to current best Ritz vector
                V[:, 0] = x / np.linalg.norm(x)
                W[:, 0] = matvec(V[:, 0])
                T[0, 0] = V[:, 0] @ W[:, 0]
                m = 1
                self.n_matvecs += 1
                continue
            V[:, m] = t
            W[:, m] = matvec(t)
            c = V[:, :m + 1].T @ W[:, m]
            T[:m + 1, m] = c
            T[m, :m + 1] = c
            m += 1
            self.n_matvecs += 1
        return np.array([theta]), x[:, None]


def adaptive_eigensolver(H, k: int = 1, dense_threshold: int = 500,
                         davidson_threshold: int = 5000
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Route by size: dense eigh < 500, Davidson < 5000, else sparse eigsh
    (reference ``eigensolver.py:400-453``)."""
    if sp.issparse(H):
        n = H.shape[0]
        if n < dense_threshold:
            return solve_generalized_eigenvalue(H.toarray(), k=k)
        vals, vecs = spla.eigsh((H + H.T) * 0.5, k=k, which="SA")
        idx = np.argsort(vals)
        return vals[idx][:k], vecs[:, idx][:, :k]
    H = np.asarray(H, np.float64)
    n = H.shape[0]
    if n < dense_threshold:
        return solve_generalized_eigenvalue(H, k=k)
    if n < davidson_threshold:
        Hs = 0.5 * (H + H.T)
        if k > 1:
            # DavidsonSolver is single-pair; keep k>1 consistent with the
            # dense/eigsh branches by routing to eigsh
            vals, vecs = spla.eigsh(sp.csr_matrix(Hs), k=k, which="SA")
            idx = np.argsort(vals)
            return vals[idx][:k], vecs[:, idx][:, :k]
        solver = DavidsonSolver()
        vals, vecs = solver.solve(lambda v: Hs @ v, np.diag(Hs), k=k)
        return vals, vecs
    vals, vecs = spla.eigsh(sp.csr_matrix(0.5 * (H + H.T)), k=k, which="SA")
    idx = np.argsort(vals)
    return vals[idx][:k], vecs[:, idx][:, :k]


def _tridiag_np(alphas, betas) -> np.ndarray:
    a = np.asarray(alphas, np.float64)
    b = np.asarray(betas, np.float64)[:a.shape[0] - 1]
    return np.diag(a) + np.diag(b, 1) + np.diag(b, -1)


def _ground_from_sweep(V: jnp.ndarray, alphas, betas
                       ) -> Tuple[float, jnp.ndarray]:
    """Ground Ritz pair of a device Lanczos sweep: the tridiagonal
    T = tridiag(alphas, betas) is diagonalized in float64 on the host, the
    Ritz vector is assembled on device.

    The small eigensolve never runs in f32 on the GPU: cuSOLVER's f32
    Jacobi ``eigh`` (used below 33 rows) was measured 5e-4 Ha off at
    |E| ~ 100 Ha on an H100 — 100x the f32 LAPACK error — while the
    m x m host solve costs nothing next to the sweep that built T."""
    vals, vecs = np.linalg.eigh(_tridiag_np(alphas, betas))
    ground = jnp.dot(jnp.asarray(vecs[:, 0], jnp.float32), V,
                     precision=jax.lax.Precision.HIGHEST)
    return float(vals[0]), ground / jnp.linalg.norm(ground)


def _lanczos_tridiag_mv(mv, v0: jnp.ndarray, m: int):
    """m-step Lanczos tridiagonalization of a symmetric operator given as
    a matvec closure, with full reorthogonalization (m is small)."""
    hp = jax.lax.Precision.HIGHEST      # a GPU f32 matmul is TF32 otherwise
    n = v0.shape[0]
    v = v0 / jnp.linalg.norm(v0)
    V = jnp.zeros((m, n), jnp.float32).at[0].set(v)
    alphas = jnp.zeros((m,), jnp.float32)
    betas = jnp.zeros((m,), jnp.float32)

    def body(j, carry):
        V, alphas, betas = carry
        vj = V[j]
        w = mv(vj)
        alpha = jnp.dot(w, vj, precision=hp)
        w = w - alpha * vj
        proj = jnp.dot(V, w, precision=hp) * (jnp.arange(m) <= j)
        w = w - jnp.dot(proj, V, precision=hp)
        beta = jnp.linalg.norm(w)
        inv = jnp.where(beta > 1e-7, 1.0 / jnp.maximum(beta, 1e-30), 0.0)
        V = V.at[j + 1].set(w * inv, mode="drop")
        return V, alphas.at[j].set(alpha), betas.at[j].set(beta)

    return jax.lax.fori_loop(0, m, body, (V, alphas, betas))


@partial(jax.jit, static_argnames=("m",))
def _lanczos_tridiag(h_dense: jnp.ndarray, v0: jnp.ndarray, m: int):
    def mv(v):
        return jnp.dot(h_dense, v, precision=jax.lax.Precision.HIGHEST)

    return _lanczos_tridiag_mv(mv, v0, m)


def lanczos_ground_state(h_dense: jnp.ndarray, m: int = 60,
                         v0: Optional[jnp.ndarray] = None
                         ) -> Tuple[float, jnp.ndarray]:
    """Lowest eigenpair of a dense symmetric H on device (f32 matvecs).

    Device route for subspaces too large for host dense eigh but small
    enough to hold H in device memory; m ~ 60 Lanczos steps with full
    reorthogonalization gives ground-state energies to ~1e-6 relative.
    """
    n = h_dense.shape[0]
    m = min(m, n)
    if v0 is None:
        v0 = jnp.ones((n,), jnp.float32)
    return _ground_from_sweep(*_lanczos_tridiag(h_dense, v0, m))


@partial(jax.jit, static_argnames=("m",))
def _lanczos_ell_sweep(diag: jnp.ndarray, elems: jnp.ndarray,
                       tgt: jnp.ndarray, v0: jnp.ndarray, m: int):
    from ..ops.ell import ell_spmv

    def mv(v):
        return ell_spmv(diag, elems, tgt, v)

    return _lanczos_tridiag_mv(mv, v0, m)


def _lanczos_ell_impl(diag, elems, tgt, v0, m: int):
    return _ground_from_sweep(*_lanczos_ell_sweep(diag, elems, tgt,
                                                         v0, m))


def lanczos_ground_state_ell(diag: jnp.ndarray, elems: jnp.ndarray,
                             tgt: jnp.ndarray, m: int = 120,
                             v0: Optional[jnp.ndarray] = None,
                             restarts: int = 1, rtol: float = 1e-7
                             ) -> Tuple[float, jnp.ndarray]:
    """Lowest eigenpair of an ELL-structured H on device; ``elems`` and
    ``tgt`` use the (C, N) transposed layout (see ``ops/ell.py``).

    The large-sector route (VERDICT round 2 item 1): million-state
    conserved-S_z spin sectors are too big for dense H but their
    fixed-degree (index, element) table fits device memory; a
    fully-reorthogonalized
    m-step Lanczos over the device ELL matvec gives the sector ground
    state in f32.  For oracle-grade f64 numbers, refine the returned
    vector on the host (e.g. ``scipy.sparse.linalg.eigsh(H, v0=...)``) —
    see ``SampleBasedKrylovDiagonalization.exact_subspace_energy``.

    ``restarts``: when the (m+1, N) Krylov block is memory-capped (see
    ``MemoryBudget.lanczos_ell_m``), depth comes from restarting the
    m-step solve seeded with the previous ground vector — the standard
    thick-restart degenerate case for one wanted eigenpair.  Stops early
    once a restart improves the energy by less than ``rtol``.
    """
    n = diag.shape[0]
    m = min(m, n)
    if v0 is None:
        v0 = jnp.ones((n,), jnp.float32)
    e, v = _lanczos_ell_impl(diag, elems, tgt, v0, m)
    for _ in range(max(0, restarts - 1)):
        e_new, v = _lanczos_ell_impl(diag, elems, tgt, v, m)
        if abs(float(e_new) - float(e)) < rtol * max(1.0, abs(float(e))):
            e = e_new
            break
        e = e_new
    return float(e), v


# ---------------------------------------------------------------------------
# Exact FULL-2^n spin-space ground state on one device
# ---------------------------------------------------------------------------

def lanczos_ground_state_ell_streamed(diag, elems, tgt, m: int = 40,
                                      v0: Optional[np.ndarray] = None,
                                      restarts: int = 1, rtol: float = 1e-7,
                                      verbose: bool = False
                                      ) -> Tuple[float, np.ndarray]:
    """Host-block Lanczos over a device ELL matvec.

    The Krylov block and the (full) reorthogonalization live in host RAM;
    the device program is ONE matvec, so the device holds only the tables
    and two N-vectors.  Cost: two ~4 B/state host transfers per step; RAM:
    (m+1) f32 N-vectors.  f32 quality — refine on the host for
    oracle-grade numbers.
    """
    from ..ops.ell import ell_spmv

    mv_dev = jax.jit(ell_spmv)
    N = int(diag.shape[0])
    m = min(m, N)

    def matvec(x32):
        # np.array, not asarray: device arrays view as read-only buffers
        return np.array(mv_dev(diag, elems, tgt, jnp.asarray(x32)))

    rng = np.random.default_rng(11)
    v = (np.array(v0, np.float32) if v0 is not None
         else rng.standard_normal(N).astype(np.float32))
    e_prev = None
    for _ in range(max(1, restarts)):
        v /= np.linalg.norm(v)
        V = np.empty((m + 1, N), np.float32)
        V[0] = v
        alphas = np.zeros(m)
        betas = np.zeros(m)
        k = m
        for j in range(m):
            w = matvec(V[j])
            alphas[j] = float(V[j] @ w)
            w -= np.float32(alphas[j]) * V[j]
            if j:
                w -= np.float32(betas[j - 1]) * V[j - 1]
            w -= V[:j + 1].T @ (V[:j + 1] @ w)    # full reorthogonalization
            b = float(np.linalg.norm(w))
            betas[j] = b
            if b < 1e-6:
                k = j + 1
                break
            V[j + 1] = w / np.float32(b)
        T = (np.diag(alphas[:k]) + np.diag(betas[:k - 1], 1)
             + np.diag(betas[:k - 1], -1))
        vals, vecs = np.linalg.eigh(T)
        e = float(vals[0])
        v = (vecs[:, 0].astype(np.float32) @ V[:k])
        if verbose:
            print(f"  [streamed lanczos] restart E={e:.8f}", flush=True)
        if e_prev is not None and abs(e - e_prev) < rtol * max(1.0, abs(e)):
            e_prev = e
            break
        e_prev = e
    return e_prev, v / np.linalg.norm(v)


def full_diagonal_device(ham):
    """(2^n,) f32 diagonal of the full spin space, built ON device in
    chunks from the packed diagonal kernel (iota states, functional
    preallocation — the diag half of ``_build_fullspace_ell_device``)."""
    n = int(ham.n_sites)
    N = 1 << n
    diag_fn = ham.diagonal_device
    chunk = min(1 << 19, N)

    @jax.jit
    def build():
        d = jnp.zeros((N,), jnp.float32)

        def body(i, d):
            start = i * chunk
            idx = (jnp.uint32(start)
                   + jnp.arange(chunk, dtype=jnp.uint32))[:, None]
            return jax.lax.dynamic_update_slice(
                d, diag_fn(idx).astype(jnp.float32), (start,))

        return jax.lax.fori_loop(0, N // chunk, body, d)

    return build()


def lanczos_ground_state_stepped(mv, dim: int, m: int = 40,
                                 v0: Optional[np.ndarray] = None,
                                 restarts: int = 3, rtol: float = 1e-7,
                                 verbose: bool = False, mv_args=()
                                 ) -> Tuple[float, np.ndarray]:
    """Device-resident Lanczos with NO stored Krylov block.

    The 3-term recurrence keeps only (v_prev, v_cur) device-resident
    across small per-step jit calls — nothing but two f32 scalars crosses
    the host link per step, and peak device memory is ~4 N-vectors
    regardless of ``m`` (no (m, N) Krylov block, no host transfers of
    N-vectors as in the streamed route).

    Pass A accumulates the tridiagonal (alpha, beta); the host
    diagonalizes T; pass B re-runs the recurrence to assemble the Ritz
    vector (classic two-pass Lanczos).  No reorthogonalization — in f32
    ghost pairs only slow the extremal pair, and each restart re-seeds
    from the current Ritz vector.  f32 grade: refine on the host for
    oracle-grade numbers (``exact_fullspace_ground_state``).

    ``mv_args``: extra device-array operands threaded through to
    ``mv(v, *mv_args)`` as jit PARAMETERS.  Do not close over large
    device arrays in ``mv``: a closed-over array is embedded in the
    compiled program as a constant."""
    m = min(m, dim)

    @jax.jit
    def step(v_prev, v_cur, beta_prev, *margs):
        w = mv(v_cur, *margs)
        alpha = jnp.dot(w, v_cur, precision=jax.lax.Precision.HIGHEST)
        w = w - alpha * v_cur - beta_prev * v_prev
        beta = jnp.linalg.norm(w)
        v_next = w / jnp.maximum(beta, 1e-30)
        return v_next, alpha, beta

    @jax.jit
    def accum(acc, v_cur, y_j):
        return acc + y_j * v_cur

    rng = np.random.default_rng(11)
    v = jnp.asarray(v0 if v0 is not None
                    else rng.standard_normal(dim), jnp.float32)
    e_prev = None
    for r in range(max(1, restarts)):
        v = v / jnp.linalg.norm(v)
        v_start = v                       # kept for pass B (one extra vec)
        v_prev = jnp.zeros_like(v)
        alphas = np.zeros(m)
        betas = np.zeros(m)
        k = m
        beta_prev = jnp.float32(0.0)
        v_cur = v_start
        for j in range(m):
            v_next, a, b = step(v_prev, v_cur, beta_prev, *mv_args)
            alphas[j] = float(a)
            betas[j] = float(b)
            if betas[j] < 1e-6:
                k = j + 1
                break
            v_prev, v_cur, beta_prev = v_cur, v_next, b
        T = (np.diag(alphas[:k]) + np.diag(betas[:k - 1], 1)
             + np.diag(betas[:k - 1], -1))
        vals, vecs = np.linalg.eigh(T)
        e = float(vals[0])
        y = vecs[:, 0]
        # pass B: rebuild sum_j y_j q_j by re-running the recurrence
        acc = jnp.zeros_like(v_start)
        v_prev = jnp.zeros_like(v_start)
        v_cur = v_start
        beta_prev = jnp.float32(0.0)
        for j in range(k):
            acc = accum(acc, v_cur, jnp.float32(y[j]))
            if j + 1 < k:
                v_next, _, b = step(v_prev, v_cur, beta_prev, *mv_args)
                v_prev, v_cur, beta_prev = v_cur, v_next, b
        v = acc
        if verbose:
            print(f"  [stepped lanczos] restart {r}: E={e:.8f}",
                  flush=True)
        if e_prev is not None and abs(e - e_prev) < rtol * max(1.0, abs(e)):
            e_prev = e
            break
        e_prev = e
    nrm = jnp.linalg.norm(v)
    return e_prev, np.asarray(v / nrm)


def _build_fullspace_ell_device(ham):
    """Identity-basis (C, N) ELL tables for the FULL 2^n space, built
    entirely ON DEVICE: states are iota, the connection key IS the target
    row (every XOR flip lands back in the space), and functional
    preallocation (fori_loop + dynamic_update_slice) keeps the peak at
    final size.  Nothing crosses the host link."""
    n = int(ham.n_sites)
    N = 1 << n
    C = int(ham.n_connections)
    conn_fn = ham.connections_device
    diag_fn = ham.diagonal_device
    chunk = min(1 << 19, N)

    @jax.jit
    def build():
        d = jnp.zeros((N,), jnp.float32)
        e = jnp.zeros((C, N), jnp.float32)
        t = jnp.zeros((C, N), jnp.int32)

        def body(i, carry):
            d, e, t = carry
            start = i * chunk
            idx = (jnp.uint32(start)
                   + jnp.arange(chunk, dtype=jnp.uint32))[:, None]
            conn, el = conn_fn(idx)               # (B, C, 1), (B, C)
            d = jax.lax.dynamic_update_slice(
                d, diag_fn(idx).astype(jnp.float32), (start,))
            e = jax.lax.dynamic_update_slice(
                e, el.astype(jnp.float32).T, (0, start))
            t = jax.lax.dynamic_update_slice(
                t, conn[..., 0].astype(jnp.int32).T, (0, start))
            return d, e, t

        return jax.lax.fori_loop(0, N // chunk, body, (d, e, t))

    return build()


def _fullspace_cache_path(ham):
    """Disk-cache location for the full-space ground energy, keyed by the
    Hamiltonian content (mirrors ``SKQD._oracle_cache_path``)."""
    import hashlib
    import os
    from pathlib import Path
    hsh = hashlib.sha1(b"fullspace")
    hsh.update(type(ham).__name__.encode())
    for attr in ("n_sites", "Jx", "Jy", "Jz", "V", "h", "L", "periodic"):
        hsh.update(repr(getattr(ham, attr, None)).encode())
    for attr in ("h_x", "h_y", "h_z"):
        val = getattr(ham, attr, None)
        if val is not None:
            hsh.update(np.asarray(val, np.float64).tobytes())
    root = Path(os.environ.get(
        "FGK_INTEGRAL_CACHE",
        Path.home() / ".cache" / "fgk_integrals"))
    return root / f"fullspace_{hsh.hexdigest()}.txt"


def exact_fullspace_ground_state(ham, m: int = 120, refine_host: bool = True,
                                 tol: float = 1e-9, verbose: bool = True,
                                 use_cache: bool = True) -> dict:
    """Exact ground state of the FULL 2^n spin Hilbert space on one device.

    The route that makes "exact" reachable where no conserved sector
    shrinks the space (TFIM at any field, transverse-field Heisenberg):

    1. **Identity-basis ELL build, ON DEVICE** — over the full space
       every XOR flip lands back in the space, so the connection key IS
       the target row: no sort, no ``searchsorted`` over 2^n keys, and
       no host assembly or multi-GB transfer
       (``_build_fullspace_ell_device``: iota states + functional
       preallocation).
    2. **Restarted f32 device Lanczos** — fused on-device program
       (``lanczos_ground_state_ell``) under the device-memory Krylov-block
       budget up to 2^24; beyond that the table-free flip route
       (``lanczos_ground_state_stepped`` over ``apply_statevector_jax``)
       or, without one, the host-block streamed variant
       (``lanczos_ground_state_ell_streamed``).
    3. **Host f64 refine** — seeded ``eigsh`` over the model's
       slab-reshape statevector matvec
       (``hamiltonians.spin.apply_statevector_np``), a formulation
       independent of the packed-connection kernels, so the refined
       energy doubles as a cross-check of the device Hamiltonian.

    Reference counterpart: none — the reference caps exact lattice truth
    at dense ``exact_ground_state`` (~2^14); this extends it to 2^24+ by
    construction (``/root/reference/src/hamiltonians/spin.py:311-344``).
    """
    import time

    from ..utils.memory import MemoryBudget, device_memory_bytes

    n = int(ham.n_sites)
    dim = 1 << n
    C = int(ham.n_connections)
    tables_bytes = 2 * C * dim * 4 + dim * 4
    hbm = device_memory_bytes()
    tables_fit = tables_bytes + (1 << 30) + 10 * dim * 4 <= 0.85 * hbm
    # table-free flip route (slab-reshape matvec): ~6 f32 N-vectors
    flip_ok = (hasattr(ham, "apply_statevector_jax")
               and 6 * 4 * dim <= 0.5 * hbm)
    if not tables_fit and not flip_ok:
        raise MemoryError(
            f"full 2^{n} ELL tables ({tables_bytes / 2**30:.1f} GiB at "
            f"C={C}) exceed the device-memory budget "
            f"({hbm / 2**30:.0f} GiB) and "
            "no table-free statevector route is available")

    path = _fullspace_cache_path(ham)
    if use_cache and refine_host:
        try:
            e = float(path.read_text())
            return {"energy": e, "dim": dim, "cached": True}
        except (OSError, ValueError):
            pass

    # -- 1+2. identity-basis ELL build (on device) + restarted Lanczos ---
    # dim <= 2^24: the fused device Lanczos program (on-device Krylov
    # block).  dim > 2^24: the table-free flip route, or the host-streamed
    # Krylov block.  The 2^24 threshold comes from an earlier device's
    # per-program limit and is yet to be re-derived (ROADMAP C1).
    t0 = time.time()
    m_fit = MemoryBudget.for_device().lanczos_ell_m(dim, C, m_max=m)
    restarts = max(1, -(-m // m_fit))
    rng = np.random.default_rng(7)
    streamed = dim > (1 << 24)
    use_flip = flip_ok and (streamed or not tables_fit)
    if use_flip:
        # table-free flip route: the slab-reshape matvec keeps everything
        # device-resident and stores no tables at all (at n=26, C=n the
        # ELL tables alone would be 13 GiB)
        diag_dev = full_diagonal_device(ham)
        jax.block_until_ready(diag_dev)
        wall_build = time.time() - t0
        t0 = time.time()
        # diag rides as a jit ARG: closing over it would embed the 2^n
        # f32 vector in the compiled program as a constant
        mv = ham.apply_statevector_jax
        v0 = rng.standard_normal(dim).astype(np.float32)
        e_dev, v = lanczos_ground_state_stepped(
            mv, dim, m=min(40, dim), v0=v0, mv_args=(diag_dev,),
            restarts=max(3, -(-m // 40)), verbose=verbose)
        v_host = np.asarray(v, np.float64)
        del v, diag_dev
    else:
        diag, elems, tgt = _build_fullspace_ell_device(ham)
        jax.block_until_ready(diag)
        wall_build = time.time() - t0
        t0 = time.time()
        v0 = rng.standard_normal(dim).astype(np.float32)
        if streamed:
            # the streamed block lives in host RAM, so m=40 is cheap;
            # restarts scale against THAT m (not the fused m_fit) — the
            # host f64 refine converges from any decent seed
            e_dev, v = lanczos_ground_state_ell_streamed(
                diag, elems, tgt, m=min(40, dim), v0=v0,
                restarts=max(3, -(-m // 40)), verbose=verbose)
            v_host = np.asarray(v, np.float64)
        else:
            e_dev, v = lanczos_ground_state_ell(diag, elems, tgt,
                                                m=min(m_fit, dim),
                                                v0=jnp.asarray(v0),
                                                restarts=restarts)
            v_host = np.asarray(v, np.float64)
        del v, diag, elems, tgt
    wall_device = time.time() - t0
    route = ("flip-stepped" if use_flip
             else "ell-streamed" if streamed else "ell-fused")
    if verbose:
        print(f"  [fullspace] {route} device Lanczos E={e_dev:.8f} "
              f"({wall_device:.1f} s; device build {wall_build:.1f} s)")

    out = {"dim": dim, "n_connections": C, "streamed": streamed,
           "route": route,
           "lanczos_m": min(40, dim) if (streamed or use_flip) else m_fit,
           "restarts": (max(3, -(-m // 40)) if (streamed or use_flip)
                        else restarts),
           "wall_build_s": round(wall_build, 1),
           "wall_device_s": round(wall_device, 1), "cached": False,
           "e_device": float(e_dev)}
    if not refine_host:
        out["energy"] = float(e_dev)
        return out

    # -- 3. host f64 seeded refine over the slab statevector matvec ------
    t0 = time.time()
    diag_np = ham.full_diagonal_np()
    nmv = [0]

    def mv(x):
        nmv[0] += 1
        return ham.apply_statevector_np(x, diag=diag_np)

    op = spla.LinearOperator((dim, dim), matvec=mv, dtype=np.float64)
    v_host /= np.linalg.norm(v_host)
    out["e_rayleigh_f32vec"] = float(v_host @ mv(v_host))
    # seeded: a near-converged v0 needs only a thin restart basis
    vals = spla.eigsh(op, k=1, which="SA", v0=v_host, tol=tol, ncv=10,
                      return_eigenvectors=False)
    e = float(vals.min())
    wall_refine = time.time() - t0
    if verbose:
        print(f"  [fullspace] host f64 refine E={e:.10f} "
              f"({nmv[0]} matvecs, {wall_refine:.1f} s)")
    out.update(energy=e,
               refine_matvecs=nmv[0], wall_refine_s=round(wall_refine, 1))
    if use_cache:
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(repr(e))
        except OSError:
            pass
    return out
