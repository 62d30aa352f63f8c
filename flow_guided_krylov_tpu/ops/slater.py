"""Batched Slater-Condon matrix elements over packed determinants.

This is the framework's hot ops layer — the device replacement for the
reference's Python-loop connection enumeration
(``/root/reference/src/hamiltonians/molecular.py:194-327``) and its
vectorized diagonal (``molecular.py:133-184``).

Two implementations share the same static excitation grids:

* :func:`make_connection_fn` — jitted JAX (float32), used in the training
  hot path.  Static shapes: every determinant of fixed (n_orb, n_a, n_b)
  has exactly ``connection_count`` connections, so the whole batch is one
  fused gather/vmap with no host round-trips and no connection cache
  (the reference's ``ConnectionCache`` becomes unnecessary).
* ``*_np`` functions — vectorized NumPy float64, used on the host for
  final projected-Hamiltonian assembly where eigensolves need f64
  (SURVEY.md §7.3 item 4), and doubling as the reference implementation
  for tests.

Convention: alpha orbitals on Jordan-Wigner qubits 0..n-1, beta on n..2n-1
(``molecular.py:43-45``); fermionic signs are popcounts of masked prefixes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .bits import (occupancy, occupancy2, occupancy2_np, parity_between,
                   parity_between2, parity_between2_np, parity_between_np,
                   flip_orbital2, flip_orbital2_np)
from .excitations import ExcitationSpec, build_excitation_spec

__all__ = [
    "SlaterTables", "build_tables", "diagonal_batch", "diagonal_batch_np",
    "make_connection_fn", "make_connection_fn_w2", "make_connection_fn_auto",
    "connection_kernel_choice", "connections_batch_np",
]


@dataclass
class SlaterTables:
    """Integral-derived tensors + excitation grids for fixed (n, n_a, n_b)."""
    n_orb: int
    n_alpha: int
    n_beta: int
    e_nuc: float
    h1: np.ndarray        # (n, n)
    h2: np.ndarray        # (n, n, n, n) chemist (pq|rs)
    jj: np.ndarray        # (n, n, n): jj[p,q,r] = (pq|rr)
    ex: np.ndarray        # (n, n, n): ex[p,q,r] = (pr|rq)
    jmat: np.ndarray      # (n, n): (pp|qq)
    kmat: np.ndarray      # (n, n): (pq|qp)
    spec_a: ExcitationSpec
    spec_b: ExcitationSpec
    ab_grid: np.ndarray   # (n_ab, 4): (occA_i, virA_a, occB_j, virB_b)

    @property
    def n_connections(self) -> int:
        return (self.spec_a.n_single + self.spec_b.n_single
                + self.spec_a.n_double + self.spec_b.n_double
                + self.ab_grid.shape[0])

    def section_sizes(self) -> Tuple[int, int, int, int, int]:
        return (self.spec_a.n_single, self.spec_b.n_single,
                self.spec_a.n_double, self.spec_b.n_double,
                self.ab_grid.shape[0])


def build_tables(h1: np.ndarray, h2: np.ndarray, e_nuc: float,
                 n_alpha: int, n_beta: int) -> SlaterTables:
    n = h1.shape[0]
    # one uint32 word per spin channel holds exactly 32 orbitals: every
    # shift in the kernels uses orbital INDICES (<= 31), and the uint64
    # dedup key (alpha << 32) | beta still fits, so n_orb = 32 is the true
    # single-word ceiling (round-4: was conservatively capped at 31).
    # 33..64 orbitals use TWO words per channel ([hi, lo]; round 5) and
    # the ``*_w2`` kernels below.
    if n > 64:
        raise NotImplementedError(
            "packed 2xuint32 determinant channels support n_orb <= 64")
    r = np.arange(n)
    jj = h2[:, :, r, r]                       # (n, n, n) -> jj[p,q,r]=(pq|rr)
    ex = np.empty((n, n, n))                  # ex[p,q,r] = (pr|rq) = h2[p,r,r,q]
    for rr in range(n):
        ex[:, :, rr] = h2[:, rr, rr, :]
    jmat = h2[r[:, None], r[:, None], r[None, :], r[None, :]]
    kmat = h2[r[:, None], r[None, :], r[None, :], r[:, None]]
    spec_a = build_excitation_spec(n, n_alpha)
    spec_b = (spec_a if n_beta == n_alpha else build_excitation_spec(n, n_beta))
    sa, sb = spec_a.singles, spec_b.singles
    ab = np.array(
        [(ia, aa, ib, bb) for (ia, aa) in sa for (ib, bb) in sb],
        dtype=np.int32).reshape(len(sa) * len(sb), 4)
    return SlaterTables(
        n_orb=n, n_alpha=n_alpha, n_beta=n_beta, e_nuc=float(e_nuc),
        h1=np.asarray(h1, np.float64), h2=np.asarray(h2, np.float64),
        jj=jj, ex=ex, jmat=jmat, kmat=kmat,
        spec_a=spec_a, spec_b=spec_b, ab_grid=ab)


# ---------------------------------------------------------------------------
# Diagonal elements
# ---------------------------------------------------------------------------

def _diag_from_occ(na, nb, h1d, jmat, kmat, e_nuc, mm):
    """Shared diagonal formula; ``mm`` is the (B,n)x(n,n) matmul to use.

    E = E_nuc + sum_p h_pp N_p + 1/2 sum_pq J_pq N_p N_q
        - 1/2 sum_pq K_pq (na_p na_q + nb_p nb_q)
    """
    N = na + nb
    one = (N * h1d[None, :]).sum(-1)
    coul = 0.5 * (mm(N, jmat) * N).sum(-1)
    exch = 0.5 * ((mm(na, kmat) * na).sum(-1) + (mm(nb, kmat) * nb).sum(-1))
    return e_nuc + one + coul - exch


def diagonal_batch(packed: jnp.ndarray, tables: SlaterTables) -> jnp.ndarray:
    """(B, 2*ch_words) uint32 -> (B,) float32 diagonal <x|H|x> on device.

    Uses HIGHEST matmul precision: these contractions are tiny (n <= ~64)
    so full-f32 passes cost nothing, and mHa-level accuracy targets rule
    out TF32/bf16 accumulation here.  Dispatches on the channel width
    (one word per spin for n <= 32, two words — [a_hi, a_lo, b_hi, b_lo]
    rows — above).
    """
    n = tables.n_orb
    if n > 32:
        na = occupancy2(packed[:, 0:2], n).astype(jnp.float32)
        nb = occupancy2(packed[:, 2:4], n).astype(jnp.float32)
    else:
        na = occupancy(packed[:, 0], n).astype(jnp.float32)
        nb = occupancy(packed[:, 1], n).astype(jnp.float32)
    h1d = jnp.asarray(np.diag(tables.h1), jnp.float32)
    jmat = jnp.asarray(tables.jmat, jnp.float32)
    kmat = jnp.asarray(tables.kmat, jnp.float32)

    def mm(x, y):
        return jnp.dot(x, y, precision=jax.lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)

    return _diag_from_occ(na, nb, h1d, jmat, kmat, tables.e_nuc, mm)


def diagonal_batch_np(packed: np.ndarray, tables: SlaterTables) -> np.ndarray:
    """Host float64 mirror of :func:`diagonal_batch`."""
    n = tables.n_orb
    if n > 32:
        na = occupancy2_np(packed[:, 0:2], n).astype(np.float64)
        nb = occupancy2_np(packed[:, 2:4], n).astype(np.float64)
    else:
        shifts = np.arange(n, dtype=np.uint32)
        na = ((packed[:, 0:1] >> shifts) & 1).astype(np.float64)
        nb = ((packed[:, 1:2] >> shifts) & 1).astype(np.float64)
    return _diag_from_occ(na, nb, np.diag(tables.h1), tables.jmat,
                          tables.kmat, tables.e_nuc, np.matmul)


# ---------------------------------------------------------------------------
# Occupied / virtual list extraction
# ---------------------------------------------------------------------------

def _occ_vir_lists_jax(bits: jnp.ndarray, n: int, k: int):
    """uint32 scalar -> (occ_list (k,), vir_list (n-k,)) ascending int32."""
    return _occ_vir_from_occ(occupancy(bits, n), n, k)


def _occ_vir_from_occ(occ: jnp.ndarray, n: int, k: int):
    """(n,) 0/1 occupancy -> (occ_list (k,), vir_list (n-k,)) int32."""
    orbitals = jnp.arange(n, dtype=jnp.int32)
    pos_occ = jnp.where(occ == 1, jnp.cumsum(occ) - 1, k)
    occ_list = jnp.zeros(k, jnp.int32).at[pos_occ].set(orbitals, mode="drop")
    vir = 1 - occ
    pos_vir = jnp.where(vir == 1, jnp.cumsum(vir) - 1, n - k)
    vir_list = jnp.zeros(n - k, jnp.int32).at[pos_vir].set(orbitals, mode="drop")
    return occ_list, vir_list


def _occ_vir_lists_matmul(bits: jnp.ndarray, n: int, k: int):
    """Scatter-free occ/vir lists: one-hot compare + tiny matvec.

    An alternative to the vmapped ``.at[].set`` scatter: this form builds
    the selection one-hot with compares
    (occ_list[j] = the orbital whose occupied-prefix count is j+1) and
    contracts it with the orbital iota — pure elementwise + matmul, which
    XLA tiles freely.  Same outputs as :func:`_occ_vir_lists_jax`.
    """
    occ = occupancy(bits, n)                      # (n,) int32 0/1
    orbitals = jnp.arange(n, dtype=jnp.float32)
    csum = jnp.cumsum(occ)                        # (n,)
    ranks_occ = jnp.arange(1, k + 1, dtype=csum.dtype)
    oh_occ = ((csum[None, :] == ranks_occ[:, None]) & (occ[None, :] == 1))
    occ_list = (oh_occ.astype(jnp.float32) @ orbitals).astype(jnp.int32)
    vsum = jnp.cumsum(1 - occ)
    ranks_vir = jnp.arange(1, n - k + 1, dtype=vsum.dtype)
    oh_vir = ((vsum[None, :] == ranks_vir[:, None]) & (occ[None, :] == 0))
    vir_list = (oh_vir.astype(jnp.float32) @ orbitals).astype(jnp.int32)
    return occ_list, vir_list


def _occ_vir_lists_np(bits: np.ndarray, n: int, k: int):
    """(B,) uint32 -> ((B, k), (B, n-k)) ascending orbital index lists."""
    shifts = np.arange(n, dtype=np.uint32)
    occ = ((bits[:, None] >> shifts) & 1).astype(np.int8)
    return _occ_vir_from_occ_np(occ, k)


def _occ_vir_from_occ_np(occ: np.ndarray, k: int):
    """(B, n) 0/1 -> ((B, k), (B, n-k)) ascending orbital index lists."""
    order = np.argsort(1 - occ, axis=1, kind="stable")
    # int32 indices: int64/uint64 elementwise ops lack SIMD in this build
    return order[:, :k].astype(np.int32), order[:, k:].astype(np.int32)


# ---------------------------------------------------------------------------
# Device connection kernel (JAX, float32)
# ---------------------------------------------------------------------------

def make_connection_fn(tables: SlaterTables):
    """Build a jitted f(packed (B,2) uint32) -> (conn (B,C,2) uint32, elems (B,C) f32).

    C = tables.n_connections, ordered [singles_a, singles_b, doubles_aa,
    doubles_bb, doubles_ab].  All connections are valid (no masking needed):
    particle conservation makes the per-determinant count static.
    """
    n = tables.n_orb
    ka, kb = tables.n_alpha, tables.n_beta
    h1 = jnp.asarray(tables.h1, jnp.float32)
    jj = jnp.asarray(tables.jj, jnp.float32)
    ex = jnp.asarray(tables.ex, jnp.float32)
    h2f = jnp.asarray(tables.h2.reshape(-1), jnp.float32)
    sing_a = jnp.asarray(tables.spec_a.singles)
    sing_b = jnp.asarray(tables.spec_b.singles)
    dbl_a = jnp.asarray(tables.spec_a.doubles)
    dbl_b = jnp.asarray(tables.spec_b.doubles)
    ab = jnp.asarray(tables.ab_grid)
    one = jnp.uint32(1)

    def h2g(p, q, r, s):
        idx = ((p * n + q) * n + r) * n + s
        return h2f[idx]

    def flip(bits, p, q):
        return bits ^ (one << p.astype(jnp.uint32)) ^ (one << q.astype(jnp.uint32))

    def per_det(pa, pb):
        occ_a = occupancy(pa, n).astype(jnp.float32)
        occ_b = occupancy(pb, n).astype(jnp.float32)
        N = occ_a + occ_b
        la, va = _occ_vir_lists_jax(pa, n, ka)
        lb, vb = _occ_vir_lists_jax(pb, n, kb)
        # effective single-excitation matrices (elementwise-sum form keeps
        # full f32 accuracy regardless of default matmul precision)
        coul = (jj * N[None, None, :]).sum(-1)
        m_a = h1 + coul - (ex * occ_a[None, None, :]).sum(-1)
        m_b = h1 + coul - (ex * occ_b[None, None, :]).sum(-1)

        # --- singles ---
        def singles(bits, other_bits, lst, vlst, m, alpha_channel):
            p = lst[sing_a[:, 0]] if alpha_channel else lst[sing_b[:, 0]]
            q = vlst[sing_a[:, 1]] if alpha_channel else vlst[sing_b[:, 1]]
            sign = parity_between(bits, p, q).astype(jnp.float32)
            elems = m[p, q] * sign
            nb_ = flip(bits, p, q)
            if alpha_channel:
                conn = jnp.stack([nb_, jnp.broadcast_to(other_bits, nb_.shape)], -1)
            else:
                conn = jnp.stack([jnp.broadcast_to(other_bits, nb_.shape), nb_], -1)
            return conn, elems

        conn_sa, el_sa = singles(pa, pb, la, va, m_a, True)
        conn_sb, el_sb = singles(pb, pa, lb, vb, m_b, False)

        # --- same-spin doubles ---
        def doubles_ss(bits, other_bits, lst, vlst, grid, alpha_channel):
            p = lst[grid[:, 0]]
            r = lst[grid[:, 1]]
            q = vlst[grid[:, 2]]
            s = vlst[grid[:, 3]]
            s1 = parity_between(bits, p, q)
            mid = flip(bits, p, q)
            s2 = parity_between(mid, r, s)
            sign = (s1 * s2).astype(jnp.float32)
            elems = (h2g(p, q, r, s) - h2g(p, s, r, q)) * sign
            nb_ = flip(mid, r, s)
            if alpha_channel:
                conn = jnp.stack([nb_, jnp.broadcast_to(other_bits, nb_.shape)], -1)
            else:
                conn = jnp.stack([jnp.broadcast_to(other_bits, nb_.shape), nb_], -1)
            return conn, elems

        conn_aa, el_aa = doubles_ss(pa, pb, la, va, dbl_a, True)
        conn_bb, el_bb = doubles_ss(pb, pa, lb, vb, dbl_b, False)

        # --- opposite-spin doubles ---
        p = la[ab[:, 0]]
        q = va[ab[:, 1]]
        r = lb[ab[:, 2]]
        s = vb[ab[:, 3]]
        sign = (parity_between(pa, p, q) * parity_between(pb, r, s)
                ).astype(jnp.float32)
        el_ab = h2g(p, q, r, s) * sign
        conn_ab = jnp.stack([flip(pa, p, q), flip(pb, r, s)], -1)

        conn = jnp.concatenate([conn_sa, conn_sb, conn_aa, conn_bb, conn_ab], 0)
        elems = jnp.concatenate([el_sa, el_sb, el_aa, el_bb, el_ab], 0)
        return conn, elems

    @jax.jit
    def connections(packed: jnp.ndarray):
        return jax.vmap(per_det)(packed[:, 0], packed[:, 1])

    return connections


# ---------------------------------------------------------------------------
# Pair tables for the two-word-channel kernel
# ---------------------------------------------------------------------------

def _build_pair_tables(tables: SlaterTables):
    """(pair_index (n,n) int32, A2 (n_pairs, n_pairs) f64) for the one-hot
    matmul formulations: A2[(p<r), (q<s)] = (pq|rs) - (ps|rq)."""
    import itertools as _it
    n = tables.n_orb
    pair_list = list(_it.combinations(range(n), 2))
    n_pairs = len(pair_list)
    pair_index_np = np.full((n, n), -1, np.int32)
    for idx, (p, r) in enumerate(pair_list):
        pair_index_np[p, r] = idx
        pair_index_np[r, p] = idx
    # vectorized: A2[i, j] = h2[p_i, q_j, r_i, s_j] - h2[p_i, s_j, r_i, q_j]
    pr = np.asarray(pair_list, np.int32)
    p, r = pr[:, 0][:, None], pr[:, 1][:, None]
    q, s = pr[:, 0][None, :], pr[:, 1][None, :]
    a2_np = tables.h2[p, q, r, s] - tables.h2[p, s, r, q]
    assert a2_np.shape == (n_pairs, n_pairs)
    return pair_index_np, a2_np


# ---------------------------------------------------------------------------
# Device connection kernel for 33..64 orbitals (two words per channel)
# ---------------------------------------------------------------------------

def make_connection_fn_w2(tables: SlaterTables):
    """Connection kernel for n_orb in 33..64 (round 5).

    Determinant rows are (B, 4) uint32 ``[a_hi, a_lo, b_hi, b_lo]`` (two
    words per spin channel, [hi, lo] order so lexicographic word order
    equals numeric order); outputs are ((B, C, 4) targets, (B, C) f32
    elements) with the same section ordering as the single-word kernels.

    Values use a pair-factorized one-hot formulation: same-spin doubles
    as OH_occpair @ A2 @ OH_virpair^T over occupied/virtual orbital PAIRS
    (A2 from :func:`_build_pair_tables`), opposite-spin doubles as
    OH_a @ H2pair @ OH_b^T over single-excitation pair indices p*n+q.
    Every contraction selects (one-hot rows hold exactly one 1), so
    HIGHEST-precision passes are value-exact.  The bit operations
    (occupancy, JW parities, flips) run on the two-word primitives in
    ``ops/bits.py``.  Not yet measured against a gather formulation on
    the GPU, where the single-word gather kernel wins.
    """
    from itertools import combinations as _comb

    n = tables.n_orb
    ka, kb = tables.n_alpha, tables.n_beta
    h1 = jnp.asarray(tables.h1, jnp.float32)
    jj = jnp.asarray(tables.jj, jnp.float32)
    ex = jnp.asarray(tables.ex, jnp.float32)
    h2pair = jnp.asarray(tables.h2.reshape(n * n, n * n), jnp.float32)
    sing_a = jnp.asarray(tables.spec_a.singles)
    sing_b = jnp.asarray(tables.spec_b.singles)
    dbl_a = jnp.asarray(tables.spec_a.doubles)
    dbl_b = jnp.asarray(tables.spec_b.doubles)

    pair_index_np, a2_np = _build_pair_tables(tables)
    n_pairs = a2_np.shape[0]
    pair_index = jnp.asarray(pair_index_np)
    a2 = jnp.asarray(a2_np, jnp.float32)

    def pair_grid(k):
        pl = list(_comb(range(k), 2))
        return (jnp.asarray([i for i, _ in pl], jnp.int32),
                jnp.asarray([j for _, j in pl], jnp.int32))

    opa_i, opa_j = pair_grid(ka)
    vpa_a, vpa_b = pair_grid(n - ka)
    opb_i, opb_j = pair_grid(kb)
    vpb_a, vpb_b = pair_grid(n - kb)

    hp = jax.lax.Precision.HIGHEST
    iota_pairs = jnp.arange(n_pairs)
    iota_nn = jnp.arange(n * n)

    def flip2(bits2, p, q):
        return flip_orbital2(flip_orbital2(bits2, p), q)

    def per_det(pa2, pb2):
        occ_a_i = occupancy2(pa2, n)
        occ_b_i = occupancy2(pb2, n)
        occ_a = occ_a_i.astype(jnp.float32)
        occ_b = occ_b_i.astype(jnp.float32)
        N = occ_a + occ_b
        la, va = _occ_vir_from_occ(occ_a_i, n, ka)
        lb, vb = _occ_vir_from_occ(occ_b_i, n, kb)
        coul = (jj * N[None, None, :]).sum(-1)
        m_a = h1 + coul - (ex * occ_a[None, None, :]).sum(-1)
        m_b = h1 + coul - (ex * occ_b[None, None, :]).sum(-1)

        def emit(new2, other2, alpha_channel):
            other = jnp.broadcast_to(other2, new2.shape)
            return (jnp.concatenate([new2, other], -1) if alpha_channel
                    else jnp.concatenate([other, new2], -1))

        def singles(bits2, other2, lst, vlst, m, grid, alpha_channel):
            p = lst[grid[:, 0]]
            q = vlst[grid[:, 1]]
            sign = parity_between2(bits2, p, q).astype(jnp.float32)
            elems = m[p, q] * sign
            return emit(flip2(bits2, p, q), other2, alpha_channel), elems

        conn_sa, el_sa = singles(pa2, pb2, la, va, m_a, sing_a, True)
        conn_sb, el_sb = singles(pb2, pa2, lb, vb, m_b, sing_b, False)

        def doubles_ss(bits2, other2, lst, vlst, grid,
                       op_i, op_j, vp_a, vp_b, alpha_channel):
            row_pi = pair_index[lst[op_i], lst[op_j]]
            col_pi = pair_index[vlst[vp_a], vlst[vp_b]]
            oh_r = (row_pi[:, None] == iota_pairs[None, :]
                    ).astype(jnp.float32)
            oh_c = (col_pi[:, None] == iota_pairs[None, :]
                    ).astype(jnp.float32)
            vals = jnp.dot(jnp.dot(oh_r, a2, precision=hp),
                           oh_c.T, precision=hp).reshape(-1)
            p = lst[grid[:, 0]]
            r = lst[grid[:, 1]]
            q = vlst[grid[:, 2]]
            s = vlst[grid[:, 3]]
            s1 = parity_between2(bits2, p, q)
            mid = flip2(bits2, p, q)
            s2 = parity_between2(mid, r, s)
            elems = vals * (s1 * s2).astype(jnp.float32)
            return emit(flip2(mid, r, s), other2, alpha_channel), elems

        conn_aa, el_aa = doubles_ss(pa2, pb2, la, va, dbl_a,
                                    opa_i, opa_j, vpa_a, vpa_b, True)
        conn_bb, el_bb = doubles_ss(pb2, pa2, lb, vb, dbl_b,
                                    opb_i, opb_j, vpb_a, vpb_b, False)

        # opposite spin: OH_a @ H2pair @ OH_b^T over p*n+q pair indices
        pA = la[sing_a[:, 0]]
        qA = va[sing_a[:, 1]]
        pB = lb[sing_b[:, 0]]
        qB = vb[sing_b[:, 1]]
        oh_a = ((pA * n + qA)[:, None] == iota_nn[None, :]
                ).astype(jnp.float32)
        oh_b = ((pB * n + qB)[:, None] == iota_nn[None, :]
                ).astype(jnp.float32)
        e_ab = jnp.dot(jnp.dot(oh_a, h2pair, precision=hp), oh_b.T,
                       precision=hp)
        sign_a = parity_between2(pa2, pA, qA)
        sign_b = parity_between2(pb2, pB, qB)
        el_ab = (e_ab * (sign_a[:, None] * sign_b[None, :]
                         ).astype(jnp.float32)).reshape(-1)
        na2 = flip2(pa2, pA, qA)                      # (Sa, 2)
        nb2 = flip2(pb2, pB, qB)                      # (Sb, 2)
        sa_n, sb_n = pA.shape[0], pB.shape[0]
        conn_ab = jnp.concatenate([
            jnp.broadcast_to(na2[:, None, :], (sa_n, sb_n, 2)),
            jnp.broadcast_to(nb2[None, :, :], (sa_n, sb_n, 2)),
        ], -1).reshape(sa_n * sb_n, 4)

        conn = jnp.concatenate([conn_sa, conn_sb, conn_aa, conn_bb, conn_ab],
                               0)
        elems = jnp.concatenate([el_sa, el_sb, el_aa, el_bb, el_ab], 0)
        return conn, elems

    @jax.jit
    def connections(packed: jnp.ndarray):
        return jax.vmap(per_det)(packed[:, 0:2], packed[:, 2:4])

    return connections


# ---------------------------------------------------------------------------
# Production auto-pick
# ---------------------------------------------------------------------------

def connection_kernel_choice(tables: SlaterTables) -> str:
    """Name of the production connection kernel for this shape: the
    gather kernel ``v1`` for one word per spin channel (n_orb <= 32),
    ``w2`` above."""
    # Measured on an H100 (700 W; ~6M connections per call) against two
    # one-hot-matmul formulations since removed: the gather kernel won at
    # every shape, 4.6-5.9x over the pair-factorized form and 7.4-21.9x
    # over the per-excitation form, 0.13 / 0.12 / 0.13 / 0.11 / 0.10 ms at
    # n_orb:n_elec 10:7 / 11:5 / 12:6 / 14:5 / 16:8.  A GPU gathers natively.
    return "w2" if tables.n_orb > 32 else "v1"


def make_connection_fn_auto(tables: SlaterTables):
    """The production connection kernel (see :func:`connection_kernel_choice`).

    This is what ``MolecularHamiltonian.connections_device``, the
    connection-table builder and the training hot path build — the
    kernel ``bench.py`` reports is the one routed here.
    """
    if tables.n_orb > 32:
        return make_connection_fn_w2(tables)
    return make_connection_fn(tables)


def connections_batch_np(packed: np.ndarray, tables: SlaterTables,
                         chunk: int = 2048
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized float64 connections: (B, 2*ch) uint32 -> ((B,C,2*ch), (B,C)).

    Processed in ``chunk``-row slices into preallocated outputs: large
    temporaries force glibc into mmap/page-fault churn on every ufunc
    (measured 10x slowdown at N2 scale on a single-core host), while
    chunk-sized temporaries stay in the warm arena.  Dispatches to the
    two-word-channel mirror for n_orb > 32.
    """
    B_total = packed.shape[0]
    row_w = 4 if tables.n_orb > 32 else 2
    if B_total > chunk:
        C = tables.n_connections
        conn_out = np.empty((B_total, C, row_w), np.uint32)
        el_out = np.empty((B_total, C), np.float64)
        for i in range(0, B_total, chunk):
            c, e = connections_batch_np(packed[i:i + chunk], tables)
            conn_out[i:i + len(c)] = c
            el_out[i:i + len(e)] = e
        return conn_out, el_out
    if tables.n_orb > 32:
        return _connections_batch_np_w2(packed, tables)
    n, ka, kb = tables.n_orb, tables.n_alpha, tables.n_beta
    B = packed.shape[0]
    # stay in uint32 end to end (n_orb <= 31): this numpy build's uint64
    # elementwise kernels are ~100x slower than uint32 (no SIMD loops)
    pa = packed[:, 0].astype(np.uint32)
    pb = packed[:, 1].astype(np.uint32)
    shifts = np.arange(n, dtype=np.uint32)
    occ_a = ((pa[:, None] >> shifts) & np.uint32(1)).astype(np.float64)
    occ_b = ((pb[:, None] >> shifts) & np.uint32(1)).astype(np.float64)
    N = occ_a + occ_b
    la, va = _occ_vir_lists_np(packed[:, 0], n, ka)
    lb, vb = _occ_vir_lists_np(packed[:, 1], n, kb)

    coul = np.einsum("pqr,br->bpq", tables.jj, N, optimize=True)
    m_a = tables.h1[None] + coul - np.einsum("pqr,br->bpq", tables.ex, occ_a,
                                             optimize=True)
    m_b = tables.h1[None] + coul - np.einsum("pqr,br->bpq", tables.ex, occ_b,
                                             optimize=True)
    h2 = tables.h2
    bidx = np.arange(B)[:, None]

    from .bits import _POW2_32

    def flip(bits, p, q):
        # table gather instead of scalar<<array (no SIMD shift kernel)
        return bits ^ _POW2_32[p] ^ _POW2_32[q]

    out_conn = []
    out_el = []

    def emit(new_ch, other, elems, alpha_channel):
        new_ch = new_ch.astype(np.uint32)
        other = np.broadcast_to(other[:, None], new_ch.shape).astype(np.uint32)
        pair = (np.stack([new_ch, other], -1) if alpha_channel
                else np.stack([other, new_ch], -1))
        out_conn.append(pair)
        out_el.append(elems)

    # singles
    for bits, lst, vlst, m, is_a, spec in (
            (pa, la, va, m_a, True, tables.spec_a),
            (pb, lb, vb, m_b, False, tables.spec_b)):
        g = spec.singles
        p = lst[:, g[:, 0]]
        q = vlst[:, g[:, 1]]
        sign = parity_between_np(bits[:, None], p, q)
        elems = m[bidx, p, q] * sign
        emit(flip(bits[:, None], p, q), (pb if is_a else pa), elems, is_a)

    # same-spin doubles
    for bits, lst, vlst, is_a, spec in (
            (pa, la, va, True, tables.spec_a),
            (pb, lb, vb, False, tables.spec_b)):
        g = spec.doubles
        p = lst[:, g[:, 0]]
        r = lst[:, g[:, 1]]
        q = vlst[:, g[:, 2]]
        s = vlst[:, g[:, 3]]
        s1 = parity_between_np(bits[:, None], p, q)
        mid = flip(bits[:, None], p, q)
        s2 = parity_between_np(mid, r, s)
        elems = (h2[p, q, r, s] - h2[p, s, r, q]) * (s1 * s2)
        emit(flip(mid, r, s), (pb if is_a else pa), elems, is_a)

    # opposite-spin doubles
    g = tables.ab_grid
    p = la[:, g[:, 0]]
    q = va[:, g[:, 1]]
    r = lb[:, g[:, 2]]
    s = vb[:, g[:, 3]]
    sign = (parity_between_np(pa[:, None], p, q)
            * parity_between_np(pb[:, None], r, s))
    elems = h2[p, q, r, s] * sign
    na = flip(pa[:, None], p, q).astype(np.uint32)
    nbv = flip(pb[:, None], r, s).astype(np.uint32)
    out_conn.append(np.stack([na, nbv], -1))
    out_el.append(elems)

    conn = np.concatenate(out_conn, axis=1)
    elems = np.concatenate(out_el, axis=1)
    return conn, elems


def _connections_batch_np_w2(packed: np.ndarray, tables: SlaterTables
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Two-word-channel host mirror: (B,4) uint32 -> ((B,C,4), (B,C) f64).

    Same section ordering as the device kernels; values via h2 fancy
    indexing (an independent formulation from the device's one-hots,
    so the pair doubles as a cross-check).
    """
    n, ka, kb = tables.n_orb, tables.n_alpha, tables.n_beta
    B = packed.shape[0]
    pa2 = packed[:, 0:2].astype(np.uint32)
    pb2 = packed[:, 2:4].astype(np.uint32)
    occ_a_i = occupancy2_np(pa2, n)
    occ_b_i = occupancy2_np(pb2, n)
    occ_a = occ_a_i.astype(np.float64)
    occ_b = occ_b_i.astype(np.float64)
    N = occ_a + occ_b
    la, va = _occ_vir_from_occ_np(occ_a_i, ka)
    lb, vb = _occ_vir_from_occ_np(occ_b_i, kb)

    coul = np.einsum("pqr,br->bpq", tables.jj, N, optimize=True)
    m_a = tables.h1[None] + coul - np.einsum("pqr,br->bpq", tables.ex,
                                             occ_a, optimize=True)
    m_b = tables.h1[None] + coul - np.einsum("pqr,br->bpq", tables.ex,
                                             occ_b, optimize=True)
    h2 = tables.h2
    bidx = np.arange(B)[:, None]

    def flip2(bits2, p, q):
        return flip_orbital2_np(flip_orbital2_np(bits2, p), q)

    out_conn = []
    out_el = []

    def emit(new2, other2, elems, alpha_channel):
        other = np.broadcast_to(other2[:, None, :], new2.shape)
        pair = (np.concatenate([new2, other], -1) if alpha_channel
                else np.concatenate([other, new2], -1))
        out_conn.append(pair.astype(np.uint32))
        out_el.append(elems)

    # singles
    for bits2, other2, lst, vlst, m, is_a, spec in (
            (pa2, pb2, la, va, m_a, True, tables.spec_a),
            (pb2, pa2, lb, vb, m_b, False, tables.spec_b)):
        g = spec.singles
        p = lst[:, g[:, 0]]
        q = vlst[:, g[:, 1]]
        sign = parity_between2_np(bits2[:, None, :], p, q)
        elems = m[bidx, p, q] * sign
        emit(flip2(bits2[:, None, :], p, q), other2, elems, is_a)

    # same-spin doubles
    for bits2, other2, lst, vlst, is_a, spec in (
            (pa2, pb2, la, va, True, tables.spec_a),
            (pb2, pa2, lb, vb, False, tables.spec_b)):
        g = spec.doubles
        p = lst[:, g[:, 0]]
        r = lst[:, g[:, 1]]
        q = vlst[:, g[:, 2]]
        s = vlst[:, g[:, 3]]
        s1 = parity_between2_np(bits2[:, None, :], p, q)
        mid = flip2(bits2[:, None, :], p, q)
        s2 = parity_between2_np(mid, r, s)
        elems = (h2[p, q, r, s] - h2[p, s, r, q]) * (s1 * s2)
        emit(flip2(mid, r, s), other2, elems, is_a)

    # opposite-spin doubles
    g = tables.ab_grid
    p = la[:, g[:, 0]]
    q = va[:, g[:, 1]]
    r = lb[:, g[:, 2]]
    s = vb[:, g[:, 3]]
    sign = (parity_between2_np(pa2[:, None, :], p, q)
            * parity_between2_np(pb2[:, None, :], r, s))
    elems = h2[p, q, r, s] * sign
    na2 = flip2(pa2[:, None, :], p, q).astype(np.uint32)
    nb2 = flip2(pb2[:, None, :], r, s).astype(np.uint32)
    out_conn.append(np.concatenate([na2, nb2], -1))
    out_el.append(elems)

    conn = np.concatenate(out_conn, axis=1)
    elems = np.concatenate(out_el, axis=1)
    return conn, elems
