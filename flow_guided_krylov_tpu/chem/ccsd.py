"""Host-side spin-orbital CCSD (+ optional perturbative triples).

The reference falls back to a PySCF CCSD reference energy whenever FCI is
infeasible (``/root/reference/examples/moderate_system_benchmark.py:122-157``).
PySCF is not available in this image, so this module implements coupled
cluster from scratch on top of the in-repo ``MolecularIntegrals``: the
standard spin-orbital CCSD equations with DIIS-accelerated amplitude
iteration (Stanton, Gauss, Watts & Bartlett, J. Chem. Phys. 94, 4334
(1991)), plus the conventional (T) correction.

Everything is float64 NumPy on the host — this is an *oracle*, not a hot
path; the device never sees it.  The spin-orbital formulation handles both the
RHF and ROHF references produced by ``chem/scf.py`` (the same routing the
reference uses, ``molecular.py:976-981``): the Fock matrix is built from the
actual reference determinant and the equations keep every non-canonical
``f_ov`` / off-diagonal term.

Validation strategy (tests/test_ccsd.py): CCSD is *exact* for two-electron
systems, so H2 in two bases must reproduce FCI to ~1e-9 Ha; the MP2 starting
energy is cross-checked against the independent closed-shell spatial-orbital
formula; LiH / H2O / Li are compared against in-repo FCI with physically
known gaps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .scf import MolecularIntegrals

__all__ = ["CCSDResult", "run_ccsd", "mp2_energy_closed_shell",
           "ccsd_reference_dict"]


@dataclass
class CCSDResult:
    e_hf: float
    e_corr: float            # CCSD correlation energy
    e_tot: float             # e_hf + e_corr
    converged: bool
    n_iterations: int
    e_triples: Optional[float] = None   # (T) correction, if requested

    @property
    def e_tot_t(self) -> Optional[float]:
        """CCSD(T) total energy, when triples were computed."""
        if self.e_triples is None:
            return None
        return self.e_tot + self.e_triples


def _spin_orbital_tensors(ints: MolecularIntegrals
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Interleaved spin-orbital h1, antisymmetrized <pq||rs>, and the
    occupied spin-orbital index list (Aufbau on the reference determinant:
    alpha on even indices, beta on odd)."""
    n = ints.n_orbitals
    m = 2 * n
    spat = np.arange(m) // 2
    spin = np.arange(m) % 2

    h1_so = ints.h1e[np.ix_(spat, spat)] * (spin[:, None] == spin[None, :])

    # physicist spatial <pq|rs> = chemist (pr|qs)
    phys = np.asarray(ints.h2e, dtype=np.float64).transpose(0, 2, 1, 3)
    big = phys[np.ix_(spat, spat, spat, spat)]
    same_pr = (spin[:, None] == spin[None, :])
    big = (big
           * same_pr[:, None, :, None]     # sigma_p == sigma_r
           * same_pr[None, :, None, :])    # sigma_q == sigma_s
    eri = big - big.transpose(0, 1, 3, 2)  # <pq||rs> = <pq|rs> - <pq|sr>

    occ = np.concatenate([2 * np.arange(ints.n_alpha),
                          2 * np.arange(ints.n_beta) + 1])
    occ = np.sort(occ)
    return h1_so, eri, occ


def mp2_energy_closed_shell(ints: MolecularIntegrals) -> float:
    """Independent closed-shell spatial-orbital MP2 correlation energy.

    Used only as a cross-check of the spin-orbital machinery (tests); the
    textbook formula E2 = sum_iajb (ia|jb)[2(ia|jb) - (ib|ja)]/D."""
    if ints.n_alpha != ints.n_beta:
        raise ValueError("closed-shell formula requires n_alpha == n_beta")
    if ints.mo_energies is None:
        raise ValueError("mo_energies required")
    no, n = ints.n_alpha, ints.n_orbitals
    eps = np.asarray(ints.mo_energies, dtype=np.float64)[:n]
    ovov = np.asarray(ints.h2e, dtype=np.float64)[:no, no:, :no, no:]
    d = (eps[:no, None, None, None] - eps[None, no:, None, None]
         + eps[None, None, :no, None] - eps[None, None, None, no:])
    return float(np.einsum("iajb,iajb->", ovov * (2.0 * ovov
                 - ovov.transpose(0, 3, 2, 1)), 1.0 / d, optimize=True))


def ccsd_reference_dict(ints: MolecularIntegrals, final_energy: float
                        ) -> dict:
    """CCSD(T) oracle on ``ints`` + error of ``final_energy`` against it.

    The benchmark CLIs call this when FCI is infeasible (the reference's
    CCSD fallback, ``moderate_system_benchmark.py:122-157``); run it on the
    same (active-space) integrals the solver used so the comparison is
    apples-to-apples.  Strong multireference systems may not converge —
    reported honestly via ``ccsd_converged`` / ``ccsd_error``.
    """
    out: dict = {}
    try:
        no = ints.n_electrons
        nv = 2 * ints.n_orbitals - no
        # The blocked (T) path (round 5) needs only O(nv^3) memory, so the
        # gate is FLOP-count (~no^3 nv^4 dgemm work), not tensor size —
        # this admits the >32-orbital frontier actives (O3/cc-pVDZ full:
        # no=18, nv=60 -> ~7.6e10 FLOPs, minutes on the host core).
        do_t = no ** 3 * nv ** 4 < 5e11
        cc = run_ccsd(ints, do_triples=do_t)
    except Exception as exc:
        out["ccsd_error"] = str(exc)
        return out
    out["ccsd_energy"] = cc.e_tot
    out["ccsd_converged"] = cc.converged
    out["error_vs_ccsd_mha"] = 1000.0 * (final_energy - cc.e_tot)
    if cc.e_triples is not None:
        out["ccsd_t_energy"] = cc.e_tot_t
        out["error_vs_ccsd_t_mha"] = 1000.0 * (final_energy - cc.e_tot_t)
    return out


class _DIIS:
    def __init__(self, max_vecs: int = 8):
        self.max_vecs = max_vecs
        self.vecs: List[np.ndarray] = []
        self.errs: List[np.ndarray] = []

    def extrapolate(self, vec: np.ndarray, err: np.ndarray) -> np.ndarray:
        self.vecs.append(vec)
        self.errs.append(err)
        if len(self.vecs) > self.max_vecs:
            self.vecs.pop(0)
            self.errs.pop(0)
        if len(self.vecs) < 2:
            return vec
        m = len(self.vecs)
        B = -np.ones((m + 1, m + 1))
        B[m, m] = 0.0
        for i in range(m):
            for j in range(i, m):
                B[i, j] = B[j, i] = float(self.errs[i] @ self.errs[j])
        rhs = np.zeros(m + 1)
        rhs[m] = -1.0
        try:
            w = np.linalg.solve(B, rhs)[:m]
        except np.linalg.LinAlgError:
            return vec
        return sum(wi * vi for wi, vi in zip(w, self.vecs))


def run_ccsd(ints: MolecularIntegrals,
             n_frozen: int = 0,
             max_cycles: int = 120,
             conv_tol: float = 1e-8,
             do_triples: bool = False,
             verbose: bool = False) -> CCSDResult:
    """Spin-orbital CCSD on the HF reference stored in ``ints``.

    ``n_frozen`` freezes the lowest spatial orbitals (core) out of the
    correlation treatment — matching ``chem/active_space.py`` semantics —
    while keeping them in the Fock build.
    """
    if ints.hf_energy is None:
        raise ValueError("MolecularIntegrals.hf_energy is required")
    h1, eri, occ_all = _spin_orbital_tensors(ints)
    m = h1.shape[0]

    # Fock over ALL spin orbitals with the full occupation
    f = h1 + np.einsum("piqi->pq", eri[:, occ_all][:, :, :, occ_all],
                       optimize=True)

    frozen = set(range(2 * n_frozen))          # spin orbitals of core spatials
    o_idx = np.array([p for p in occ_all if p not in frozen], dtype=np.int64)
    occ_set = set(int(p) for p in occ_all)
    v_idx = np.array([p for p in range(m) if p not in occ_set],
                     dtype=np.int64)
    no, nv = len(o_idx), len(v_idx)
    if no == 0 or nv == 0:
        return CCSDResult(ints.hf_energy, 0.0, ints.hf_energy, True, 0,
                          0.0 if do_triples else None)

    fd = np.diag(f)
    d1 = fd[o_idx][:, None] - fd[v_idx][None, :]
    d2 = (fd[o_idx][:, None, None, None] + fd[o_idx][None, :, None, None]
          - fd[v_idx][None, None, :, None] - fd[v_idx][None, None, None, :])

    fo = f[np.ix_(o_idx, o_idx)]
    fv = f[np.ix_(v_idx, v_idx)]
    fov = f[np.ix_(o_idx, v_idx)]
    # off-diagonal Fock blocks (zero for canonical RHF; live for ROHF)
    fo_od = fo - np.diag(np.diag(fo))
    fv_od = fv - np.diag(np.diag(fv))

    ix = np.ix_
    oooo = eri[ix(o_idx, o_idx, o_idx, o_idx)]
    ooov = eri[ix(o_idx, o_idx, o_idx, v_idx)]
    oovv = eri[ix(o_idx, o_idx, v_idx, v_idx)]
    ovov = eri[ix(o_idx, v_idx, o_idx, v_idx)]
    ovvv = eri[ix(o_idx, v_idx, v_idx, v_idx)]
    vvvv = eri[ix(v_idx, v_idx, v_idx, v_idx)]
    ovoo = eri[ix(o_idx, v_idx, o_idx, o_idx)]
    del eri  # keep peak memory low

    t1 = fov / d1
    t2 = oovv / d2
    e_mp2 = 0.25 * float(np.einsum("ijab,ijab->", oovv, t2, optimize=True))
    if verbose:
        print(f"  MP2 correlation: {e_mp2:.10f}")

    def energy(t1, t2):
        e = float(np.einsum("ia,ia->", fov, t1, optimize=True))
        e += 0.25 * float(np.einsum("ijab,ijab->", oovv, t2, optimize=True))
        e += 0.5 * float(np.einsum("ijab,ia,jb->", oovv, t1, t1,
                                   optimize=True))
        return e

    diis = _DIIS()
    e_old = energy(t1, t2)
    converged = False
    n_iter = 0
    for n_iter in range(1, max_cycles + 1):
        tau_t = t2 + 0.5 * (np.einsum("ia,jb->ijab", t1, t1)
                            - np.einsum("ib,ja->ijab", t1, t1))
        tau = t2 + (np.einsum("ia,jb->ijab", t1, t1)
                    - np.einsum("ib,ja->ijab", t1, t1))

        # --- intermediates (Stanton et al. eqs 3-8) ---
        Fae = (fv_od - 0.5 * np.einsum("me,ma->ae", fov, t1)
               + np.einsum("mf,mafe->ae", t1, ovvv, optimize=True)
               - 0.5 * np.einsum("mnaf,mnef->ae", tau_t, oovv,
                                 optimize=True))
        Fmi = (fo_od + 0.5 * np.einsum("ie,me->mi", t1, fov)
               + np.einsum("ne,mnie->mi", t1, ooov, optimize=True)
               + 0.5 * np.einsum("inef,mnef->mi", tau_t, oovv,
                                 optimize=True))
        Fme = fov + np.einsum("nf,mnef->me", t1, oovv, optimize=True)

        Wmnij = (oooo
                 + np.einsum("je,mnie->mnij", t1, ooov, optimize=True)
                 - np.einsum("ie,mnje->mnij", t1, ooov, optimize=True)
                 + 0.25 * np.einsum("ijef,mnef->mnij", tau, oovv,
                                    optimize=True))
        Wabef = (vvvv
                 - np.einsum("mb,amef->abef", t1,
                             -ovvv.transpose(1, 0, 2, 3), optimize=True)
                 + np.einsum("ma,bmef->abef", t1,
                             -ovvv.transpose(1, 0, 2, 3), optimize=True)
                 + 0.25 * np.einsum("mnab,mnef->abef", tau, oovv,
                                    optimize=True))
        # <mb||ej> = -<mb||je> = -ovov[m,b,j,e]
        Wmbej = (-ovov.transpose(0, 1, 3, 2)
                 + np.einsum("jf,mbef->mbej", t1, ovvv, optimize=True)
                 - np.einsum("nb,mnej->mbej", t1,
                             -ooov.transpose(0, 1, 3, 2), optimize=True)
                 - np.einsum("jnfb,mnef->mbej", 0.5 * t2
                             + np.einsum("jf,nb->jnfb", t1, t1), oovv,
                             optimize=True))

        # --- T1 residual ---
        rhs1 = (fov
                + np.einsum("ie,ae->ia", t1, Fae, optimize=True)
                - np.einsum("ma,mi->ia", t1, Fmi, optimize=True)
                + np.einsum("imae,me->ia", t2, Fme, optimize=True)
                - np.einsum("nf,naif->ia", t1, ovov, optimize=True)
                - 0.5 * np.einsum("imef,maef->ia", t2, ovvv, optimize=True)
                - 0.5 * np.einsum("mnae,nmei->ia", t2,
                                  -ooov.transpose(0, 1, 3, 2),
                                  optimize=True))
        t1_new = rhs1 / d1

        # --- T2 residual ---
        tmp_fb = Fae - 0.5 * np.einsum("mb,me->be", t1, Fme)
        tmp_fj = Fmi + 0.5 * np.einsum("je,me->mj", t1, Fme)
        rhs2 = oovv.copy()
        x = np.einsum("ijae,be->ijab", t2, tmp_fb, optimize=True)
        rhs2 += x - x.transpose(0, 1, 3, 2)
        x = np.einsum("imab,mj->ijab", t2, tmp_fj, optimize=True)
        rhs2 -= x - x.transpose(1, 0, 2, 3)
        rhs2 += 0.5 * np.einsum("mnab,mnij->ijab", tau, Wmnij,
                                optimize=True)
        rhs2 += 0.5 * np.einsum("ijef,abef->ijab", tau, Wabef,
                                optimize=True)
        x = (np.einsum("imae,mbej->ijab", t2, Wmbej, optimize=True)
             - np.einsum("ie,ma,mbej->ijab", t1, t1,
                         -ovov.transpose(0, 1, 3, 2), optimize=True))
        rhs2 += (x - x.transpose(0, 1, 3, 2)
                 - x.transpose(1, 0, 2, 3) + x.transpose(1, 0, 3, 2))
        # <ab||ej> = <ej||ab> = <je||ba> = ovvv[j,e,b,a]
        x = np.einsum("ie,jeba->ijab", t1, ovvv, optimize=True)
        rhs2 += x - x.transpose(1, 0, 2, 3)
        x = np.einsum("ma,mbij->ijab", t1, ovoo, optimize=True)
        rhs2 -= x - x.transpose(0, 1, 3, 2)
        t2_new = rhs2 / d2

        # DIIS on the concatenated amplitude vector
        vec = np.concatenate([t1_new.ravel(), t2_new.ravel()])
        err = np.concatenate([(t1_new - t1).ravel(), (t2_new - t2).ravel()])
        vec = diis.extrapolate(vec, err)
        t1 = vec[:t1.size].reshape(t1.shape)
        t2 = vec[t1.size:].reshape(t2.shape)

        e_new = energy(t1, t2)
        rms = float(np.sqrt(np.mean(err ** 2)))
        if verbose:
            print(f"  CCSD iter {n_iter:3d}  E_corr={e_new:.10f}  "
                  f"dE={e_new - e_old:+.2e}  rms={rms:.2e}")
        if abs(e_new - e_old) < conv_tol and rms < np.sqrt(conv_tol):
            converged = True
            e_old = e_new
            break
        e_old = e_new

    e_t: Optional[float] = None
    if do_triples:
        e_t = _perturbative_triples(t1, t2, oovv, ovvv, ooov, fd, o_idx,
                                    v_idx)
    return CCSDResult(
        e_hf=float(ints.hf_energy), e_corr=float(e_old),
        e_tot=float(ints.hf_energy + e_old), converged=converged,
        n_iterations=n_iter, e_triples=e_t)


def _perturbative_triples(t1, t2, oovv, ovvv, ooov, fd, o_idx, v_idx
                          ) -> float:
    """Conventional (T): E = (1/36) sum t3c * D3 * (t3c + t3d).

    Fully tensorized (o^3 v^3 memory) when that fits in ~2 GB; otherwise
    the blocked per-occupied-triple formulation (O(nv^3) memory — the
    standard production layout), which opens (T) to the >32-orbital
    frontier actives where the full t3 tensor would need terabytes.
    Both paths compute the identical sum (pinned against each other in
    ``tests/test_ccsd.py``).
    """
    no, nv = len(o_idx), len(v_idx)
    if no ** 3 * nv ** 3 * 8 > 2e9:
        return _perturbative_triples_blocked(t1, t2, oovv, ovvv, ooov,
                                             fd, o_idx, v_idx)

    eps_o = fd[o_idx]
    eps_v = fd[v_idx]
    d3 = (eps_o[:, None, None, None, None, None]
          + eps_o[None, :, None, None, None, None]
          + eps_o[None, None, :, None, None, None]
          - eps_v[None, None, None, :, None, None]
          - eps_v[None, None, None, None, :, None]
          - eps_v[None, None, None, None, None, :])

    def p_i_jk(x):
        # P(i/jk) f(ijk...) = f(ijk) - f(jik) - f(kji)  over axes 0,1,2
        return (x - x.transpose(1, 0, 2, 3, 4, 5)
                - x.transpose(2, 1, 0, 3, 4, 5))

    def p_a_bc(x):
        return (x - x.transpose(0, 1, 2, 4, 3, 5)
                - x.transpose(0, 1, 2, 5, 4, 3))

    # disconnected triples: P(i/jk)P(a/bc) t1[i,a] <jk||bc>
    t3d = p_i_jk(p_a_bc(np.einsum("ia,jkbc->ijkabc", t1, oovv,
                                  optimize=True))) / d3

    # connected triples:
    #   P(i/jk)P(a/bc)[ sum_e t2[jk,ae] <ei||bc> - sum_m t2[im,bc] <ma||jk> ]
    # <ei||bc> = -<ie||bc> = -ovvv[i,e,b,c];  <ma||jk> = -ovoo-style via ooov:
    # <ma||jk> = -<am||jk> = ... use <jk||ma> = ooov[j,k,m,a]:
    # <ma||jk> = <jk||ma>^T  (real integrals) = ooov[j,k,m,a]
    w = (np.einsum("jkae,iebc->ijkabc", t2, -ovvv, optimize=True)
         - np.einsum("imbc,jkma->ijkabc", t2, ooov, optimize=True))
    t3c = p_i_jk(p_a_bc(w)) / d3
    return float(np.einsum("ijkabc,ijkabc->", t3c, d3 * (t3c + t3d),
                           optimize=True) / 36.0)


def _perturbative_triples_blocked(t1, t2, oovv, ovvv, ooov, fd,
                                  o_idx, v_idx) -> float:
    """(T) blocked over occupied triples i<j<k — O(nv^3) working memory.

    Per fixed ordered (i, j, k) the connected/disconnected slices are

        u(i,j,k)[a,b,c]  = sum_e t2[j,k,a,e] <ei||bc>
                           - sum_m t2[i,m,b,c] <ma||jk>
        ud(i,j,k)[a,b,c] = t1[i,a] <jk||bc>

    (the exact integrands of the full-tensor path above); W/V apply
    P(i/jk) as the signed sum over the three cyclic placements of i and
    P(a/bc) as pair swaps on the nv^3 slice.  Both W and V are fully
    antisymmetric in (i,j,k), so the total reduces to 6x the sum over
    i<j<k of sum_abc W (W + V) / d3 / 36 = (1/6) sum_{i<j<k} (...).
    """
    no, nv = len(o_idx), len(v_idx)
    eps_o = fd[o_idx]
    eps_v = fd[v_idx]
    dv = (eps_v[:, None, None] + eps_v[None, :, None]
          + eps_v[None, None, :])
    neg_ovvv = -ovvv  # <ei||bc> = -ovvv[i,e,b,c]

    def u(i, j, k):
        # sum_e t2[j,k,a,e] * neg_ovvv[i,e,b,c]  — one dgemm
        x = t2[j, k] @ neg_ovvv[i].reshape(nv, nv * nv)
        x = x.reshape(nv, nv, nv)
        # sum_m t2[i,m,b,c] * ooov[j,k,m,a]  ( <ma||jk> = ooov[j,k,m,a] )
        y = ooov[j, k].T @ t2[i].reshape(no, nv * nv)
        return x - y.reshape(nv, nv, nv)

    def p_a_bc(x):
        return x - x.transpose(1, 0, 2) - x.transpose(2, 1, 0)

    e_t = 0.0
    for i in range(no):
        for j in range(i + 1, no):
            for k in range(j + 1, no):
                w = p_a_bc(u(i, j, k) - u(j, i, k) - u(k, j, i))
                v = p_a_bc(np.einsum("a,bc->abc", t1[i], oovv[j, k])
                           - np.einsum("a,bc->abc", t1[j], oovv[i, k])
                           - np.einsum("a,bc->abc", t1[k], oovv[j, i]))
                d3 = (eps_o[i] + eps_o[j] + eps_o[k]) - dv
                e_t += float(np.sum(w * (w + v) / d3))
    return e_t / 6.0
