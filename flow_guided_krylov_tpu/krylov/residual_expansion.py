"""Selected-CI style basis expansion with PT2 importance (Stage 3).

Counterpart of ``/root/reference/src/krylov/residual_expansion.py``:

* :class:`SelectedCIExpander` — one round: diagonalize the current basis
  (host float64), accumulate *signed* couplings <i|H|Phi> = sum_j c_j <i|H|j>
  over all external connected determinants, score epsilon_i =
  |<i|H|Phi>|^2 / |E - E_i|, add the top-k, rediagonalize, and reject the
  round if the energy rose (variational check)
  (``residual_expansion.py:305-554``).
* :class:`ResidualBasedExpander` — raw-residual variant r_i = max_j |c_j
  H_ij| with keep-max dedup (``residual_expansion.py:60-257``).
* :func:`iterative_residual_expansion` — convenience loop
  (``residual_expansion.py:260-302``).

The reference's per-state Python loop + dict accumulation
(``:492-522``) becomes one vectorized batch: connections for the whole
basis come from the static-shape kernel, then a key-grouped bincount —
O(B*C) with no Python-level loops.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..hamiltonians.base import Hamiltonian


def _sorted_unique(keys: np.ndarray, return_inverse: bool = False):
    """(unique_keys, first_index, inverse|None) via argsort + a grouped
    cumsum scatter.

    Avoids ``np.unique``'s int64-heavy internals (cumsum/flatnonzero),
    which have no SIMD kernels in this build — for the 4M-key PT2
    candidate pools this is ~6x faster.  Structured 128-bit keys
    (``KEY128``) sort via ``np.lexsort`` over their two uint64 halves:
    NumPy's generic record comparator costs a function call per compare,
    which at the 10^8-row multiword dE2 merges is the difference between
    minutes and the better part of an hour (round 5).
    """
    if keys.dtype.kind == "V" and keys.dtype.itemsize == 16:
        v = keys.view(np.uint64).reshape(-1, 2)       # [hi, lo] halves
        order = np.lexsort((v[:, 1], v[:, 0]))
        sv = v[order]
        flag = np.empty(len(keys), bool)
        if len(keys):
            flag[0] = True
            np.not_equal(sv[1:, 0], sv[:-1, 0], out=flag[1:])
            flag[1:] |= sv[1:, 1] != sv[:-1, 1]
        sk = keys[order]
    else:
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        flag = np.empty(len(sk), bool)
        if len(sk):
            flag[0] = True
            np.not_equal(sk[1:], sk[:-1], out=flag[1:])
    uniq = sk[flag]
    first_idx = order[flag]
    inverse = None
    if return_inverse:
        # group id by position in the sorted order, scattered back to the
        # input order — replaces len(keys) binary searches (generic
        # comparator calls for structured keys) with one cumsum + gather
        inverse = np.empty(len(keys), np.int32)
        inverse[order] = np.cumsum(flag, dtype=np.int32) - np.int32(1)
    return uniq, first_idx, inverse

__all__ = ["ResidualExpansionConfig", "SelectedCIExpander",
           "ResidualBasedExpander", "iterative_residual_expansion"]


@dataclass
class ResidualExpansionConfig:
    """Expansion knobs (reference ``residual_expansion.py:27-57``)."""
    configs_per_iteration: int = 100
    residual_threshold: float = 1e-4
    max_iterations: int = 10
    energy_convergence: float = 1e-6
    stagnation_threshold: float = 5e-5    # 0.05 mHa
    stagnation_patience: int = 2
    max_basis_size: int = 4096
    coefficient_threshold: float = 1e-6   # |c_j| cutoff for source states
    # SHCI-style proportional growth: when > 0, each round adds
    # max(configs_per_iteration, growth_factor * len(basis)) states, so a
    # deep run reaches a B-state basis in O(log B) eigensolves instead of
    # B / configs_per_iteration.  0 keeps the reference's fixed schedule.
    growth_factor: float = 0.0
    # SHCI-style source screening (Holmes-Tubman-Umrigar): when > 0, a
    # source row j is scored only if |c_j| * Hmax >= source_screen *
    # residual_threshold — a row below that cannot by itself push any
    # candidate over the selection cutoff.  This is the standard SHCI
    # heuristic (small sources CAN still accumulate across rows, so it is
    # not exact); the exact dE2 correction is unaffected (it always sums
    # over the full basis).  0 disables it (default; all records without
    # a "screened" marker use 0).
    source_screen: float = 0.0
    # Pre-sort row cap for the device PT2 scorer: when > 0, each scoring
    # block keeps only the top ``pt2_sort_rows`` candidate rows by
    # |c_j * H_ij| (``approx_max_k``, one bandwidth-bound pass) before
    # the O(rows log rows) multi-word lexicographic sort — the dominant
    # cost at large connection counts (a 39-orbital W=4 block sorts
    # 1024 x 104,760 rows with a 4-operand comparator without it).  This
    # is the per-row half of the SHCI screening criterion (|H_ij c_j|
    # ranking; Holmes-Tubman-Umrigar): a dropped row can no longer
    # accumulate into a candidate's coupling, so SELECTION becomes
    # approximate in exactly the way source_screen already is, while the
    # exact dE2 correction is untouched (its kernel never drops rows).
    # 0 disables it (default; records without a "sort-capped" marker
    # use 0).
    pt2_sort_rows: int = 0
    # Warm-started Davidson for the per-iteration eigensolve (B > 2048):
    # the SCI projected H is strongly diagonally dominant and the previous
    # round's eigenvector is an excellent guess, so preconditioned Davidson
    # beats warm-started ARPACK (host f64, measured ~4x at B = 4000 on
    # N2/STO-3G).  Falls back to eigsh when Davidson does not converge.
    # Routed from ``PipelineConfig.use_davidson`` (the reference carries the
    # same flag unrouted, SURVEY.md §2.6).
    use_davidson: bool = True


class SelectedCIExpander:
    """PT2-scored Selected-CI expansion over packed determinants.

    Device hot path (round 2): the per-round O(B*C) host work of the
    reference (``residual_expansion.py:408-522``) is removed three ways:

    * repeated diagonalizations of an unchanged basis hit a fingerprint
      cache (the end-of-round solve IS the next round's start-of-round);
    * the projected sparse H grows incrementally — only the newly added
      rows' connections are enumerated per round (O(k*C), k = adds);
    * PT2 candidate scoring (connections + signed key-grouped coupling
      accumulation + top-K) runs on device with sort/segment-sum ops;
      the host only filters externals and finalizes scores over the
      fetched top-K.
    """

    # device scoring pays off once the source batch is past this many
    # connection evaluations; below it, compile + transfer dominate
    DEVICE_SCORING_MIN_ELEMS = 2_000_000

    def __init__(self, hamiltonian: Hamiltonian,
                 config: Optional[ResidualExpansionConfig] = None,
                 use_device_scoring: Optional[bool] = None,
                 mesh=None):
        self.h = hamiltonian
        self.config = config or ResidualExpansionConfig()
        self._last_coeffs: Optional[np.ndarray] = None
        self.use_device_scoring = use_device_scoring
        # optional ('data','basis') Mesh: PT2 source rows shard over ALL
        # devices (shard_map), each shard sorts/segment-sums/top-Ks its own
        # connection block, and the host merge sums per-shard couplings —
        # the scale-out dimension of the stage-3 wall (SURVEY.md §5)
        self.mesh = mesh
        # fingerprint -> (energy, coeffs) for the last two bases seen
        self._diag_cache: Dict[bytes, Tuple[float, np.ndarray]] = {}
        # incremental projected-H cache: consolidated prefix CSR + pending
        # per-round staircase blocks [(row_offset, B, B.T, D), ...]
        self._inc_keys: Optional[np.ndarray] = None
        self._inc_H = None
        self._pend: list = []
        self._pt2_fn_cache: Dict[Tuple[int, int], object] = {}
        self._pt2_corr_cache: Dict[Tuple[int, int], object] = {}
        self._pt2_row_cap: Optional[int] = None
        # lazily sampled max |H_ij| over off-diagonal connections, used by
        # the source_screen heuristic to convert the coupling cutoff into
        # a |c_j| cutoff
        self._hmax: Optional[float] = None
        # cumulative wall per phase (diag = host eigensolve incl. the
        # incremental CSR growth; score = PT2 candidate scoring) — the
        # stage-3 time split, printed by iterative_residual_expansion
        self.timings: Dict[str, float] = {"diag": 0.0, "score": 0.0,
                                          "diag_build": 0.0}

    # ------------------------------------------------------------------

    def _projected_sparse(self, basis: np.ndarray, keys: np.ndarray):
        """Symmetric H over ``basis`` as a matvec operator, grown blockwise
        when the previous basis is a prefix (the iterative-expansion
        invariant).

        Round 3 rewrite: the old path re-assembled the FULL CSR every
        round (``sp.bmat`` copies every stored nonzero), an O(nnz) memcpy
        per round that turned deep million-state runs quadratic.  Now each
        round only builds its OWN (B, D) staircase blocks; the eigensolve
        sees a LinearOperator whose matvec streams the consolidated prefix
        CSR plus the pending blocks (identical action, same f64 dtype),
        and blocks consolidate into the prefix only every ~16 rounds."""
        import scipy.sparse as sp

        n = len(basis)
        if self._inc_H is not None:
            m = len(self._inc_keys)
            if n >= m and np.array_equal(keys[:m], self._inc_keys):
                if n > m:
                    new = basis[m:]
                    n_new = n - m
                    order = np.argsort(keys)
                    sorted_keys = keys[order]
                    # fused native path: enumerate + membership-test +
                    # Slater-Condon values for hits only (C++; the NumPy
                    # mirror below materializes all n_new * C candidate
                    # values first — 0.4 M conn/s at 39 orbitals)
                    from ..ops.native_conn import conn_hits_native
                    nat = conn_hits_native(self.h, new, sorted_keys)
                    if nat is not None:
                        rows, spos, vals = nat
                        cols = order[spos]
                    else:
                        conn, elems = self.h.connections_np(new)
                        ck = self.h.keys(conn.reshape(-1, conn.shape[-1]))
                        pos = np.clip(np.searchsorted(sorted_keys, ck),
                                      0, n - 1)
                        hit = sorted_keys[pos] == ck
                        rows = np.repeat(np.arange(n_new),
                                         conn.shape[1])[hit]
                        cols = order[pos[hit]]
                        vals = elems.reshape(-1)[hit]
                    old = cols < m
                    B = sp.coo_matrix((vals[old], (rows[old], cols[old])),
                                      shape=(n_new, m)).tocsr()
                    D = sp.coo_matrix(
                        (vals[~old], (rows[~old], cols[~old] - m)),
                        shape=(n_new, n_new))
                    D = (0.5 * (D + D.T)
                         + sp.diags(self.h.diagonal_np(new))).tocsr()
                    self._pend.append((m, B, B.T.tocsr(), D))
                    self._inc_keys = keys.copy()
                    if len(self._pend) >= 16:
                        self._consolidate()
                return self._operator()
            if n < m and np.array_equal(keys, self._inc_keys[:n]):
                # variational rejection reverted the basis: restrict
                self._consolidate()
                self._inc_H = self._inc_H[:n, :n].tocsr()
                self._inc_keys = keys.copy()
                return self._inc_H

        M = self.h.to_sparse(basis)
        self._inc_H = ((M + M.T) * 0.5).tocsr()
        self._pend = []
        self._inc_keys = keys.copy()
        return self._inc_H

    def _consolidate(self) -> None:
        """Fold the pending staircase blocks into the prefix CSR (one
        O(nnz) pass, amortized over ~16 rounds)."""
        if not self._pend:
            return
        import scipy.sparse as sp
        h0 = self._inc_H.tocoo()
        rs, cs, vs = [h0.row], [h0.col], [h0.data]
        n = self._inc_H.shape[0]
        for a, B, _, D in self._pend:
            nb = D.shape[0]
            b = B.tocoo()
            rs += [a + b.row, b.col]
            cs += [b.col, a + b.row]
            vs += [b.data, b.data]
            d = D.tocoo()
            rs.append(a + d.row)
            cs.append(a + d.col)
            vs.append(d.data)
            n = max(n, a + nb)
        self._inc_H = sp.coo_matrix(
            (np.concatenate(vs),
             (np.concatenate(rs), np.concatenate(cs))),
            shape=(n, n)).tocsr()
        self._pend = []

    def _operator(self):
        """The current projected H: the prefix CSR when nothing is
        pending, else a LinearOperator streaming prefix + blocks."""
        if not self._pend:
            return self._inc_H
        import scipy.sparse.linalg as spla
        H0 = self._inc_H
        m0 = H0.shape[0]
        pend = list(self._pend)
        n = pend[-1][0] + pend[-1][3].shape[0]

        def mv(x):
            x = np.asarray(x, np.float64).reshape(-1)
            y = np.zeros(n, np.float64)
            y[:m0] = H0 @ x[:m0]
            for a, B, BT, D in pend:
                nb = D.shape[0]
                y[a:a + nb] += B @ x[:a] + D @ x[a:a + nb]
                y[:a] += BT @ x[a:a + nb]
            return y

        return spla.LinearOperator((n, n), matvec=mv, dtype=np.float64)

    def _diagonalize(self, basis: np.ndarray) -> Tuple[float, np.ndarray]:
        """Ground state of H projected on basis (host f64; reference
        ``residual_expansion.py:408-443``).  Warm-started with the previous
        round's eigenvector; unchanged bases hit a fingerprint cache."""
        t0 = time.perf_counter()
        try:
            return self._diagonalize_timed(basis)
        finally:
            self.timings["diag"] += time.perf_counter() - t0

    def _diagonalize_timed(self, basis: np.ndarray
                           ) -> Tuple[float, np.ndarray]:
        keys = self.h.keys(basis)
        fp = keys.tobytes()
        hit = self._diag_cache.get(fp)
        if hit is not None:
            self._last_coeffs = hit[1]
            return hit

        v0 = None
        prev = self._last_coeffs
        if prev is not None and len(prev) <= len(basis):
            v0 = np.zeros(len(basis))
            v0[:len(prev)] = prev

        if len(basis) > 2048:
            import scipy.sparse.linalg as spla
            tb = time.perf_counter()
            M = self._projected_sparse(basis, keys)
            self.timings["diag_build"] += time.perf_counter() - tb
            if v0 is not None:
                e, vec = None, None
                if self.config.use_davidson:
                    # preconditioned Davidson with the previous eigenvector:
                    # eigenvalue error ~ rnorm^2/gap, so tol 1e-7 leaves
                    # O(1e-14/gap) Ha error — far below the 1e-6 Ha
                    # convergence test.  Ritz values are variational like
                    # eigsh's.
                    from ..postprocessing.eigensolver import DavidsonSolver
                    dav = DavidsonSolver(tol=1e-7)
                    # exact diagonal from the Hamiltonian: M may be a
                    # streaming LinearOperator (incremental-staircase path)
                    # with no .diagonal()
                    dvals, dvecs = dav.solve(
                        lambda v: M @ v, self.h.diagonal_np(basis), v0=v0)
                    if dav.converged:
                        e, vec = float(dvals[0]), dvecs[:, 0]
                if e is None:
                    # warm eigsh: k=1 at a loose residual tol is ~4x cheaper
                    # than k=2 at machine tol; same variational-error
                    # argument as above
                    vals, vecs = spla.eigsh(M, k=1, which="SA", v0=v0,
                                            tol=1e-10)
                    e, vec = float(vals[0]), vecs[:, 0]
            else:
                vals, vecs = spla.eigsh(M, k=2, which="SA")
                idx = np.argsort(vals)
                e, vec = float(vals[idx][0]), vecs[:, idx][:, 0]
        else:
            try:
                vals, vecs = self.h.exact_ground_state(basis, k=1, v0=v0)
            except TypeError:
                vals, vecs = self.h.exact_ground_state(basis, k=1)
            e, vec = float(vals[0]), vecs[:, 0]
        self._last_coeffs = vec
        if len(self._diag_cache) > 4:
            self._diag_cache.clear()
        self._diag_cache[fp] = (e, vec)
        return e, vec

    # ------------------------------------------------------------------
    # PT2 scoring
    # ------------------------------------------------------------------

    def _pt2_topk_device(self, src: np.ndarray, src_c: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Device kernel: connections of all sources, signed coupling
        accumulation per unique target (sort + segment-sum), top-K by
        coupling^2.  Returns host (cand (K', W) uint32, coupling (K',)).

        Every selected row carries either the FULL accumulated coupling of
        its key (exactly one representative row per key per shard) or 0,
        so the host merge can sum rows grouped by key — exact for both the
        single-device and the mesh-sharded layout.

        With a mesh, source rows shard over all devices via ``shard_map``:
        each shard sorts + segment-sums + top-Ks its own connection block
        entirely locally (no collectives — the merge is the host's sum),
        so the stage-3 wall scales with the device count (VERDICT round 2
        item 2)."""
        import jax
        import jax.numpy as jnp

        h = self.h
        W = h.pack_words
        C = h.n_connections
        conn_fn = h.connections_device
        c = self.config
        mesh = self.mesh
        n_dev = mesh.size if mesh is not None else 1

        S = len(src)
        # ONE static shape per expander: pad every round to the basis cap
        # so the kernel compiles once (a fresh compile of this program
        # costs far more than the padded rows, which carry zero
        # coefficients)
        S_min = max(64, n_dev, 1 << (S - 1).bit_length(),
                    1 << (max(1, c.max_basis_size) - 1).bit_length())
        # HBM guard: the flattened rows*C sort is the dominant allocation,
        # so the source is processed in fixed blocks sized by the memory
        # budget — scoring memory is independent of the basis cap (a
        # 120k-cap N2/cc-pVDZ run compiled a 21 GB program without this).
        # Per-block partial couplings of a key merge exactly in the
        # host's grouped sum, like per-shard partials.
        if self._pt2_row_cap is None:
            from ..utils.memory import MemoryBudget
            self._pt2_row_cap = MemoryBudget.for_device().pt2_score_rows(C)
        S_blk = max(64, min(S_min, max(self._pt2_row_cap, n_dev)))
        S_blk += (-S_blk) % n_dev
        # only dispatch blocks containing real rows (the block shape —
        # and so the compiled program — is fixed by the cap either way)
        n_blocks = max(1, -(-S // S_blk))
        S_pad = n_blocks * S_blk
        # K covers every internal det (<= max_basis_size) that can crowd
        # the coupling^2 ranking, plus a wide margin of externals so the
        # final PT2 rescore (with the |E - E_i| denominator) has slack.
        # Per-shard/per-block top-Ks keep the same K (cheap: the merged
        # n_blocks * n_dev * K rows are a few MB), so a key split across
        # shards or blocks survives as long as each part makes its own
        # local top-K.
        K = int(min(S_blk // n_dev * C,
                    c.max_basis_size + 16 * c.configs_per_iteration))
        # pre-sort row cap (SHCI per-row screening on device): keep only
        # the top cap_rows rows by |c_j * H_ij| before the multi-word
        # lexicographic sort — approx_max_k is one bandwidth-bound pass
        # vs the sort's O(rows log rows) multi-operand compares, which
        # dominate the scoring wall at large connection counts
        cap_rows = int(c.pt2_sort_rows) if c.pt2_sort_rows else 0
        if cap_rows:
            K = min(K, cap_rows)
        # pack (a,b) into one uint32 sort key when the bit budget allows:
        # each extra sort operand adds compile time and comparator work,
        # so the packed variant sorts (key, contrib) only
        n_bits = getattr(getattr(h, "tables", None), "n_orb", None)
        if n_bits is None:
            n_bits = getattr(h, "key_bits_per_word", None)
        if n_bits is None:
            n_bits = h.n_sites if W == 1 else 16
        packable = (W == 1) or (W == 2 and 2 * n_bits <= 32)

        def local_topk(conn, elems, coeff_blk):
            """Sort + signed accumulation + top-K over one (local) block.

            Returns W target-word arrays plus the coupling: W > 2 rows
            (two words per spin channel) sort lexicographically on all W
            words, exactly like the W = 2 spin-chain fallback.
            """
            contrib = (elems * coeff_blk[:, None]).reshape(-1)
            words = [conn[..., w].reshape(-1) for w in range(W)]
            if cap_rows and contrib.shape[0] > cap_rows:
                # SHCI-style per-row screen: a dropped row's |contrib| is
                # below cap_rows-th largest, so it could only matter via
                # accumulation — the same approximation source_screen
                # already accepts.  The exact dE2 kernel never drops rows.
                _, sel = jax.lax.approx_max_k(jnp.abs(contrib), cap_rows)
                contrib = contrib[sel]
                words = [w[sel] for w in words]
            if packable:
                a, b = words[0], (words[1] if W == 2 else None)
                key = ((a << jnp.uint32(n_bits)) | b) if W == 2 else a
                key, contrib = jax.lax.sort((key, contrib), num_keys=1)
                a = key >> jnp.uint32(n_bits) if W == 2 else key
                words = [a] if W == 1 else [
                    a, key & jnp.uint32((1 << n_bits) - 1)]
                first = jnp.concatenate([
                    jnp.ones((1,), bool), key[1:] != key[:-1]])
            else:
                *words, contrib = jax.lax.sort((*words, contrib),
                                               num_keys=W)
                neq = words[0][1:] != words[0][:-1]
                for w in words[1:]:
                    neq = neq | (w[1:] != w[:-1])
                first = jnp.concatenate([jnp.ones((1,), bool), neq])
            seg = jnp.cumsum(first) - 1
            coupling = jax.ops.segment_sum(
                contrib, seg, num_segments=words[0].shape[0],
                indices_are_sorted=True)[seg]
            score = jnp.where(first, coupling * coupling, -1.0)
            # approx_max_k (exact top-k on a GPU, a PartialReduce where
            # the backend has one); with K carrying a 16x margin over the
            # adds the 0.95 recall target is immaterial to selection
            # quality
            sc, idx = jax.lax.approx_max_k(score, K)
            # non-first duplicate rows (score -1) must contribute 0 so the
            # host's grouped sum never double-counts a key
            return tuple(w[idx] for w in words) + (
                jnp.where(sc >= 0.0, coupling[idx], 0.0),)

        fn = self._pt2_fn_cache.get((S_blk, K, cap_rows))
        if fn is None:
            if mesh is not None and n_dev > 1:
                from jax.sharding import NamedSharding, PartitionSpec as P
                rows = P(("data", "basis"))
                block = jax.shard_map(
                    lambda s, cf: local_topk(*conn_fn(s), cf),
                    mesh=mesh,
                    in_specs=(P(("data", "basis"), None), rows),
                    out_specs=rows)

                @jax.jit
                def fn(src_dev, coeff_dev):
                    src_dev = jax.lax.with_sharding_constraint(
                        src_dev, NamedSharding(mesh, P(("data", "basis"),
                                                       None)))
                    coeff_dev = jax.lax.with_sharding_constraint(
                        coeff_dev, NamedSharding(mesh, rows))
                    return block(src_dev, coeff_dev)
            else:
                @jax.jit
                def fn(src_dev, coeff_dev):
                    return local_topk(*conn_fn(src_dev), coeff_dev)

            if len(self._pt2_fn_cache) > 8:
                self._pt2_fn_cache.clear()
            self._pt2_fn_cache[(S_blk, K, cap_rows)] = fn

        pad = S_pad - S
        if pad:
            src = np.concatenate([src, np.repeat(src[:1], pad, axis=0)])
            src_c = np.concatenate([src_c, np.zeros(pad)])
        tws = [[] for _ in range(W)]
        tcs = []
        for i in range(n_blocks):
            sl = slice(i * S_blk, (i + 1) * S_blk)
            out = fn(jnp.asarray(src[sl]),
                     jnp.asarray(src_c[sl], jnp.float32))
            for w in range(W):
                tws[w].append(np.asarray(out[w]).astype(np.uint32))
            tcs.append(np.asarray(out[-1], np.float64))
        cand = np.stack([np.concatenate(t) for t in tws], -1)
        return cand, np.concatenate(tcs)

    def _pt2_candidates(self, basis: np.ndarray, coeffs: np.ndarray,
                        energy: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (candidate dets (M, W), PT2 scores (M,))."""
        t0 = time.perf_counter()
        try:
            return self._pt2_candidates_timed(basis, coeffs, energy)
        finally:
            self.timings["score"] += time.perf_counter() - t0

    def _pt2_candidates_timed(self, basis: np.ndarray, coeffs: np.ndarray,
                              energy: float
                              ) -> Tuple[np.ndarray, np.ndarray]:
        c = self.config
        sig = np.abs(coeffs) > c.coefficient_threshold
        if not sig.any():
            sig = np.abs(coeffs) >= np.abs(coeffs).max()
        src = basis[sig]
        src_c = coeffs[sig]

        if c.source_screen > 0.0 and len(src) > 1:
            # SHCI source screening: a row j with |c_j| * Hmax below the
            # selection-coupling cutoff cannot by itself push any candidate
            # over the threshold, so skip scoring it.  Hmax is sampled once
            # (strided rows, max off-diagonal |H_ij|) — a heuristic bound,
            # like the screen itself.
            if self._hmax is None:
                sample = src[:: max(1, len(src) // 256)][:256]
                _, elems = self.h.connections_np(sample)
                self._hmax = float(np.abs(elems).max())
            c_min = (c.source_screen * c.residual_threshold
                     / max(self._hmax, 1e-12))
            scr = np.abs(src_c) >= c_min
            if scr.any() and not scr.all():
                src, src_c = src[scr], src_c[scr]

        use_device = self.use_device_scoring
        if use_device is None:
            use_device = (len(src) * self.h.n_connections
                          >= self.DEVICE_SCORING_MIN_ELEMS
                          and hasattr(self.h, "connections_device"))

        if use_device:
            cand_all, coupling_all = self._pt2_topk_device(src, src_c)
            keys = self.h.keys(cand_all)
            # grouped SUM per key: duplicate rows carry 0 by construction,
            # and per-shard partial couplings of the same key add up to the
            # exact global signed coupling
            uniq, first_idx, inverse = _sorted_unique(keys,
                                                      return_inverse=True)
            coupling_all = np.bincount(inverse, weights=coupling_all,
                                       minlength=len(uniq))
            cand_all = cand_all[first_idx]
            keys = uniq
        else:
            conn, elems = self.h.connections_np(src)      # (S,C,W), (S,C)
            flat = conn.reshape(-1, conn.shape[-1])
            contrib = (elems * src_c[:, None]).reshape(-1)  # c_j * <i|H|j>
            keys_f = self.h.keys(flat)
            uniq_keys, first_idx, inverse = _sorted_unique(
                keys_f, return_inverse=True)
            coupling_all = np.bincount(inverse, weights=contrib,
                                       minlength=len(uniq_keys))
            cand_all = flat[first_idx]
            keys = uniq_keys

        basis_keys = np.sort(self.h.keys(basis))
        pos = np.clip(np.searchsorted(basis_keys, keys), 0,
                      len(basis_keys) - 1)
        external = (basis_keys[pos] != keys) & (coupling_all != 0.0)

        cand = cand_all[external]
        coupling = coupling_all[external]
        if len(cand) == 0:
            return np.empty((0, basis.shape[1]), np.uint32), np.empty(0)

        diag = self.h.diagonal_np(cand)
        denom = np.abs(energy - diag) + 1e-12
        scores = coupling ** 2 / denom
        return cand, scores

    def rank_external_candidates(self, basis: np.ndarray
                                 ) -> Tuple[np.ndarray, np.ndarray, float,
                                            np.ndarray]:
        """Diagonalize ``basis`` and PT2-rank its external candidates.

        Public wrapper used by the restricted-SKQD subspace builder
        (``krylov/skqd.py``): returns (candidates (M, W), scores (M,),
        variational energy, ground coefficients)."""
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        e, coeffs = self._diagonalize(basis)
        cand, scores = self._pt2_candidates(basis, coeffs, e)
        return cand, scores, e, coeffs

    def expand_basis(self, basis: np.ndarray,
                     n_add: Optional[int] = None) -> Dict:
        """One expansion round with variational rejection
        (``residual_expansion.py:334-406``)."""
        c = self.config
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        e0, coeffs = self._diagonalize(basis)

        n_add = n_add or c.configs_per_iteration
        room = c.max_basis_size - len(basis)
        n_add = max(0, min(n_add, room))
        if n_add == 0:
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False, "reason": "basis at capacity"}

        cand, scores = self._pt2_candidates(basis, coeffs, e0)
        keep = scores > c.residual_threshold ** 2
        cand, scores = cand[keep], scores[keep]
        if len(cand) == 0:
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False, "reason": "no candidates above threshold"}

        top = np.argsort(-scores)[:n_add]
        new_basis = np.concatenate([basis, cand[top]], axis=0)
        e1, _ = self._diagonalize(new_basis)

        if e1 > e0 + 1e-10:
            # variational violation: adding states must not raise the energy
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False, "reason": "variational violation",
                    "rejected_energy": e1}
        return {"basis": new_basis, "energy": e1, "n_added": int(len(top)),
                "accepted": True, "pt2_correction": float(scores[top].sum())}

    # ------------------------------------------------------------------
    # Exact second-order correction of the converged variational state
    # ------------------------------------------------------------------

    def pt2_correction(self, basis: np.ndarray, coeffs: np.ndarray,
                       energy: float, cap: int = 1 << 23,
                       pad_to: int = 0) -> Dict:
        """Exact Epstein-Nesbet dE2 = sum_k <k|H|Phi>^2 / (E_var - H_kk)
        over ALL determinants k outside ``basis`` — the quantity SHCI/HCI
        report as E_var + dE2 when a Selected-CI expansion exhausts.  The
        reference's PT2 only *ranks* candidates from significant sources
        (``residual_expansion.py:536-554``); this sums every external
        coupling from every source exactly.

        Device path (when one scoring block holds the whole basis and the
        key packs into 32 bits): enumerate + sort + segment-sum all
        connections, mark first-occurrence external rows via device
        searchsorted against the sorted basis keys, rank by coupling^2
        with an EXACT sort (approx_max_k recall would silently drop
        weight), fetch the top ``cap`` rows and finish in f64 on host.
        ``exact`` is False only if more than ``cap`` external rows carry
        weight — raise ``cap`` and rerun.  Host fallback otherwise."""
        import jax
        import jax.numpy as jnp

        h = self.h
        W = h.pack_words
        C = h.n_connections
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        S = len(basis)
        coeffs = np.asarray(coeffs, np.float64)

        n_bits = getattr(getattr(h, "tables", None), "n_orb", None)
        if n_bits is None:
            n_bits = getattr(h, "key_bits_per_word", None)
        if n_bits is None:
            n_bits = h.n_sites if W == 1 else 16
        packable = (W == 1) or (W == 2 and 2 * n_bits <= 32)
        if self._pt2_row_cap is None:
            from ..utils.memory import MemoryBudget
            self._pt2_row_cap = MemoryBudget.for_device().pt2_score_rows(C)

        def _host_exact():
            # exact host path: same algebra, vectorized f64 NumPy
            conn, elems = h.connections_np(basis)
            flat = conn.reshape(-1, conn.shape[-1])
            contrib = (elems * coeffs[:, None]).reshape(-1)
            keys_f = h.keys(flat)
            uniq, first_idx, inverse = _sorted_unique(keys_f,
                                                      return_inverse=True)
            coupling = np.bincount(inverse, weights=contrib,
                                   minlength=len(uniq))
            bk = np.sort(h.keys(basis))
            pos = np.clip(np.searchsorted(bk, uniq), 0, len(bk) - 1)
            ext = (bk[pos] != uniq) & (coupling != 0.0)
            dets = flat[first_idx][ext]
            coupling_e = coupling[ext]
            diag = h.diagonal_np(dets)
            de2 = float(np.sum(coupling_e ** 2 / (energy - diag)))
            return {"de2": de2, "corrected_energy": energy + de2,
                    "n_external": int(ext.sum()), "exact": True}

        if not (self._pt2_row_cap and hasattr(h, "connections_device")):
            return _host_exact()
        if not packable:
            # multiword keys (W=2 spin chains with full 32-bit words,
            # W=4 molecular >32 orbitals): device blocks with W-key
            # lexicographic sorts + host externality filter
            if S * C < self.DEVICE_SCORING_MIN_ELEMS:
                return _host_exact()
            return self._pt2_correction_multiword(basis, coeffs, energy,
                                                  cap, pad_to)

        # The correction kernel carries a second (score, key, coupling)
        # full sort on top of the scoring footprint, so one block admits
        # only half the scoring row budget.  Larger bases
        # are processed in fixed blocks; with a mesh, each block's source
        # rows additionally shard over all devices via ``shard_map``.
        # Per-block/per-shard partial couplings of a key merge exactly in
        # the host's grouped sum, like the scoring path
        # (``_pt2_topk_device``).  ``pad_to`` pins the compiled shape
        # across a growth loop (each distinct block shape costs a fresh
        # compile).
        mesh = self.mesh
        n_dev = mesh.size if mesh is not None else 1
        S_blk = max(64, n_dev, min(self._pt2_row_cap // 2,
                                   1 << (max(S, pad_to) - 1).bit_length()))
        S_blk += (-S_blk) % n_dev
        n_blocks = max(1, -(-S // S_blk))
        S_pad = n_blocks * S_blk
        cap = int(min(cap, S_blk // n_dev * C))
        conn_fn = h.connections_device

        # sorted basis keys, padded to a stable power-of-two shape with a
        # sentinel above every real (<= 2*n_bits bit) key
        if W == 2:
            bk32 = ((basis[:, 0].astype(np.uint32) << n_bits)
                    | basis[:, 1].astype(np.uint32))
        else:
            bk32 = basis[:, 0].astype(np.uint32)
        bk32 = np.sort(bk32)
        B_pad = 1 << (len(bk32) - 1).bit_length()
        if B_pad > len(bk32):
            bk32 = np.concatenate([
                bk32, np.full(B_pad - len(bk32), np.uint32(0xFFFFFFFF))])

        fn = self._pt2_corr_cache.get((S_blk, cap, B_pad))
        if fn is None:
            def local_corr(src, src_c, basis_keys):
                """One shard/block: accumulate, mark externals, top-cap."""
                conn, elems = conn_fn(src)
                contrib = (elems * src_c[:, None]).reshape(-1)
                a = conn[..., 0].reshape(-1)
                if W == 2:
                    key = ((a << jnp.uint32(n_bits))
                           | conn[..., 1].reshape(-1))
                else:
                    key = a
                key, contrib = jax.lax.sort((key, contrib), num_keys=1)
                first = jnp.concatenate([
                    jnp.ones((1,), bool), key[1:] != key[:-1]])
                seg = jnp.cumsum(first) - 1
                coupling = jax.ops.segment_sum(
                    contrib, seg, num_segments=key.shape[0],
                    indices_are_sorted=True)[seg]
                pos = jnp.clip(jnp.searchsorted(basis_keys, key), 0,
                               basis_keys.shape[0] - 1)
                ext = basis_keys[pos] != key
                score = jnp.where(first & ext, coupling * coupling, 0.0)
                n_valid = jnp.sum((score > 0).astype(jnp.int32),
                                  keepdims=True)
                neg, key_s, coup_s = jax.lax.sort(
                    (-score, key, coupling), num_keys=1)
                return key_s[:cap], coup_s[:cap], -neg[:cap], n_valid

            if mesh is not None and n_dev > 1:
                from jax.sharding import NamedSharding, PartitionSpec as P
                rows = P(("data", "basis"))
                block = jax.shard_map(
                    local_corr, mesh=mesh,
                    in_specs=(P(("data", "basis"), None), rows, P(None)),
                    out_specs=(rows, rows, rows, rows))

                @jax.jit
                def fn(src, src_c, basis_keys):
                    src = jax.lax.with_sharding_constraint(
                        src, NamedSharding(mesh, P(("data", "basis"),
                                                   None)))
                    src_c = jax.lax.with_sharding_constraint(
                        src_c, NamedSharding(mesh, rows))
                    return block(src, src_c, basis_keys)
            else:
                fn = jax.jit(local_corr)

            self._pt2_corr_cache.clear()     # one live shape is enough
            self._pt2_corr_cache[(S_blk, cap, B_pad)] = fn

        src = basis
        src_c = coeffs
        if S_pad > S:
            src = np.concatenate([src, np.repeat(src[:1], S_pad - S, 0)])
            src_c = np.concatenate([src_c, np.zeros(S_pad - S)])
        bk_dev = jnp.asarray(bk32)

        exact = True
        key_parts, coup_parts = [], []
        for i in range(n_blocks):
            sl = slice(i * S_blk, (i + 1) * S_blk)
            key_s, coup_s, score_s, n_valid = fn(
                jnp.asarray(src[sl]),
                jnp.asarray(src_c[sl], jnp.float32), bk_dev)
            exact = exact and int(np.max(np.asarray(n_valid))) <= cap
            valid = np.asarray(score_s) > 0.0
            key_parts.append(np.asarray(key_s)[valid])
            coup_parts.append(np.asarray(coup_s, np.float64)[valid])

        keys = np.concatenate(key_parts)
        coupling = np.concatenate(coup_parts)
        if n_blocks * n_dev > 1:
            # grouped sum of per-block/per-shard partial couplings
            # (exact: every block and shard contributes at most one
            # representative row per key)
            order = np.argsort(keys, kind="stable")
            keys, coupling = keys[order], coupling[order]
            firsts = np.flatnonzero(np.concatenate(
                [[True], keys[1:] != keys[:-1]]))
            coupling = np.add.reduceat(coupling, firsts)
            keys = keys[firsts]
        if W == 2:
            dets = np.stack([(keys >> n_bits).astype(np.uint32),
                             (keys & ((1 << n_bits) - 1)).astype(np.uint32)],
                            axis=-1)
        else:
            dets = keys.astype(np.uint32)[:, None]
        diag = h.diagonal_np(dets)
        de2 = float(np.sum(coupling ** 2 / (energy - diag)))
        return {"de2": de2, "corrected_energy": energy + de2,
                "n_external": int(len(keys)), "exact": exact}

    def _pt2_correction_multiword(self, basis: np.ndarray,
                                  coeffs: np.ndarray, energy: float,
                                  cap: int, pad_to: int) -> Dict:
        """Device exact-dE2 for multiword target rows (round 5).

        The packable path marks externals on device via a scalar-key
        searchsorted; multiword keys have no on-device scalar, so each
        block instead returns its top-``cap + |basis|`` representative
        rows by coupling^2 (exact sort) and the HOST filters externality
        against the sorted basis keys.  The |basis| fetch margin means
        internal rows crowding the top can never displace an external
        one.  ``exact`` is conservative: True only when every block's
        weighted unique rows all fit in the fetch window.

        The diagonal H_kk of every fetched row is computed ON DEVICE in
        fixed-shape chunks from the block outputs (which already live in
        HBM) — a host ``diagonal_np`` over the 10^8-row merges of a
        >32-orbital final pass would run for hours on the SIMD-less
        single-core host (round 5).  The f32 device diagonal perturbs
        each denominator by ~1e-7 relative, second order in dE2.
        """
        import jax
        import jax.numpy as jnp

        h = self.h
        W = h.pack_words
        C = h.n_connections
        S = len(basis)
        mesh = self.mesh
        n_dev = mesh.size if mesh is not None else 1
        if not self._pt2_row_cap:
            from ..utils.memory import MemoryBudget
            self._pt2_row_cap = MemoryBudget.for_device().pt2_score_rows(C)
        S_blk = max(64, n_dev, min(self._pt2_row_cap // 2,
                                   1 << (max(S, pad_to) - 1).bit_length()))
        S_blk += (-S_blk) % n_dev
        n_blocks = max(1, -(-S // S_blk))
        S_pad = n_blocks * S_blk
        fetch = int(min(cap + S, S_blk // n_dev * C))
        conn_fn = h.connections_device

        fn = self._pt2_corr_cache.get(("mw", S_blk, fetch))
        if fn is None:
            def local_corr(src, src_c):
                conn, elems = conn_fn(src)
                contrib = (elems * src_c[:, None]).reshape(-1)
                words = [conn[..., w].reshape(-1) for w in range(W)]
                *words, contrib = jax.lax.sort((*words, contrib),
                                               num_keys=W)
                neq = words[0][1:] != words[0][:-1]
                for w in words[1:]:
                    neq = neq | (w[1:] != w[:-1])
                first = jnp.concatenate([jnp.ones((1,), bool), neq])
                seg = jnp.cumsum(first) - 1
                coupling = jax.ops.segment_sum(
                    contrib, seg, num_segments=words[0].shape[0],
                    indices_are_sorted=True)[seg]
                score = jnp.where(first, coupling * coupling, 0.0)
                n_valid = jnp.sum((score > 0).astype(jnp.int32),
                                  keepdims=True)
                out = jax.lax.sort((-score, *words, coupling), num_keys=1)
                neg, ws, coup = out[0], out[1:1 + W], out[-1]
                return tuple(w[:fetch] for w in ws) + (
                    coup[:fetch], -neg[:fetch], n_valid)

            if mesh is not None and n_dev > 1:
                from jax.sharding import NamedSharding, PartitionSpec as P
                rows = P(("data", "basis"))
                block = jax.shard_map(
                    local_corr, mesh=mesh,
                    in_specs=(P(("data", "basis"), None), rows),
                    out_specs=tuple([rows] * (W + 2)))

                @jax.jit
                def fn(src, src_c):
                    src = jax.lax.with_sharding_constraint(
                        src, NamedSharding(mesh, P(("data", "basis"),
                                                   None)))
                    src_c = jax.lax.with_sharding_constraint(
                        src_c, NamedSharding(mesh, rows))
                    return block(src, src_c)
            else:
                fn = jax.jit(local_corr)

            self._pt2_corr_cache.clear()     # one live shape is enough
            self._pt2_corr_cache[("mw", S_blk, fetch)] = fn

        # chunked device diagonal over the fetched rows (fixed chunk shape
        # so it compiles once; built AFTER fn so the cache clear above
        # cannot drop it)
        diag_chunk = int(min(1 << 22, fetch))
        dfn = self._pt2_corr_cache.get(("mwdiag", diag_chunk))
        if dfn is None:
            dfn = jax.jit(h.diagonal_device)
            self._pt2_corr_cache[("mwdiag", diag_chunk)] = dfn

        src = basis
        src_c = np.asarray(coeffs, np.float64)
        if S_pad > S:
            src = np.concatenate([src, np.repeat(src[:1], S_pad - S, 0)])
            src_c = np.concatenate([src_c, np.zeros(S_pad - S)])

        exact = True
        det_parts, coup_parts, diag_parts = [], [], []
        for i in range(n_blocks):
            sl = slice(i * S_blk, (i + 1) * S_blk)
            out = fn(jnp.asarray(src[sl]),
                     jnp.asarray(src_c[sl], jnp.float32))
            rows_dev = jnp.stack(out[:W], -1)        # (fetch, W), in HBM
            pad_rows = (-fetch) % diag_chunk
            if pad_rows:
                rows_dev = jnp.concatenate(
                    [rows_dev, jnp.tile(rows_dev[:1], (pad_rows, 1))])
            dps = [np.asarray(dfn(rows_dev[j:j + diag_chunk]), np.float64)
                   for j in range(0, fetch, diag_chunk)]
            diag_blk = np.concatenate(dps)[:fetch]
            words = [np.asarray(out[w]).astype(np.uint32)
                     for w in range(W)]
            coup = np.asarray(out[W], np.float64)
            score = np.asarray(out[W + 1])
            exact = exact and int(np.max(np.asarray(out[W + 2]))) <= fetch
            valid = score > 0.0
            det_parts.append(np.stack(words, -1)[valid])
            coup_parts.append(coup[valid])
            diag_parts.append(diag_blk[valid])

        dets = np.concatenate(det_parts)
        coupling = np.concatenate(coup_parts)
        diag_all = np.concatenate(diag_parts)
        # grouped sum of per-block/per-shard partial couplings, then the
        # host externality filter: search the (small) sorted basis keys
        # in the unique candidates — not every unique candidate in the
        # basis, which would cost 10^8 generic-comparator binary searches
        keys = h.keys(dets)
        uniq, first_idx, inverse = _sorted_unique(keys, return_inverse=True)
        coupling = np.bincount(inverse, weights=coupling,
                               minlength=len(uniq))
        dets = dets[first_idx]
        diag = diag_all[first_idx]
        ext = coupling != 0.0
        bk = np.sort(h.keys(basis))
        pos = np.searchsorted(uniq, bk)
        in_range = pos < len(uniq)
        pos_v = pos[in_range]
        hit = uniq[pos_v] == bk[in_range]
        ext[pos_v[hit]] = False
        dets = dets[ext]
        coupling = coupling[ext]
        diag = diag[ext]
        de2 = float(np.sum(coupling ** 2 / (energy - diag)))
        return {"de2": de2, "corrected_energy": energy + de2,
                "n_external": int(ext.sum()), "exact": exact}


class ResidualBasedExpander:
    """Raw-residual selection: r_i = max_j |c_j <i|H|j>| keep-max dedup
    (reference ``residual_expansion.py:60-257``)."""

    def __init__(self, hamiltonian: Hamiltonian,
                 config: Optional[ResidualExpansionConfig] = None):
        self.h = hamiltonian
        self.config = config or ResidualExpansionConfig()

    def find_residual_configs(self, basis: np.ndarray, coeffs: np.ndarray,
                              n_add: int) -> np.ndarray:
        c = self.config
        basis = np.atleast_2d(basis)
        sig = np.abs(coeffs) > c.coefficient_threshold
        if not sig.any():
            return np.empty((0, basis.shape[1]), np.uint32)
        conn, elems = self.h.connections_np(basis[sig])
        flat = conn.reshape(-1, conn.shape[-1])
        resid = np.abs(elems * coeffs[sig][:, None]).reshape(-1)

        keys = self.h.keys(flat)
        basis_keys = np.sort(self.h.keys(basis))
        pos = np.clip(np.searchsorted(basis_keys, keys), 0,
                      len(basis_keys) - 1)
        ext = basis_keys[pos] != keys
        keys, flat, resid = keys[ext], flat[ext], resid[ext]
        if len(keys) == 0:
            return np.empty((0, basis.shape[1]), np.uint32)

        # keep-max dedup
        order = np.lexsort((-resid, keys))
        keys_s, flat_s, resid_s = keys[order], flat[order], resid[order]
        first = np.concatenate([[True], keys_s[1:] != keys_s[:-1]])
        cand, r = flat_s[first], resid_s[first]
        keep = r > c.residual_threshold
        cand, r = cand[keep], r[keep]
        top = np.argsort(-r)[:n_add]
        return cand[top]

    def expand_basis(self, basis: np.ndarray,
                     n_add: Optional[int] = None) -> Dict:
        basis = np.atleast_2d(np.asarray(basis, np.uint32))
        vals, vecs = self.h.exact_ground_state(basis, k=1)
        e0, coeffs = float(vals[0]), vecs[:, 0]
        n_add = n_add or self.config.configs_per_iteration
        cand = self.find_residual_configs(basis, coeffs, n_add)
        if len(cand) == 0:
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False}
        new_basis = np.concatenate([basis, cand], axis=0)
        e1 = float(self.h.exact_ground_state(new_basis, k=1)[0][0])
        if e1 > e0 + 1e-10:
            return {"basis": basis, "energy": e0, "n_added": 0,
                    "accepted": False, "rejected_energy": e1}
        return {"basis": new_basis, "energy": e1, "n_added": int(len(cand)),
                "accepted": True}


def iterative_residual_expansion(hamiltonian: Hamiltonian,
                                 initial_basis: np.ndarray,
                                 config: Optional[ResidualExpansionConfig] = None,
                                 use_pt2: bool = True,
                                 verbose: bool = False,
                                 mesh=None,
                                 pt2_correct: bool = False,
                                 pt2_cap: Optional[int] = None,
                                 pt2_checkpoints: Optional[list] = None) -> Dict:
    """Loop expansion rounds with stagnation-based early stopping
    (reference ``residual_expansion.py:260-302`` + pipeline loop
    ``pipeline.py:527-596``).

    ``pt2_checkpoints``: ascending basis sizes at which to also run the
    exact Epstein-Nesbet dE2 mid-trajectory and record
    (basis_size, e_var, de2, exact) — the raw points of the standard
    SHCI E-vs-dE2 -> 0 extrapolation (used to error-bar spaces where
    no convergent wavefunction oracle exists, e.g. Cr2 where CCSD
    diverges).  The correction's compiled block shape is pinned to the
    basis cap so the checkpoints reuse one program."""
    import dataclasses
    cfg = config or ResidualExpansionConfig()
    basis = np.atleast_2d(np.asarray(initial_basis, np.uint32))
    # never let a large seed basis turn expansion into a no-op — but only
    # when the seed actually crowds the cap; a deliberate cap on a deep
    # run (seed far below it) is respected as the stopping point
    if cfg.max_basis_size < len(basis) + cfg.configs_per_iteration:
        needed = len(basis) + cfg.max_iterations * cfg.configs_per_iteration
        cfg = dataclasses.replace(cfg, max_basis_size=needed)
    expander = (SelectedCIExpander(hamiltonian, cfg, mesh=mesh) if use_pt2
                else ResidualBasedExpander(hamiltonian, cfg))
    energies = []
    best_energy = np.inf
    best_basis = basis
    stall = 0
    checkpoints = sorted(pt2_checkpoints or [])
    checkpoint_rows = []

    def _maybe_checkpoint(b):
        """Exact dE2 snapshots whenever the basis crosses a checkpoint."""
        while checkpoints and len(b) >= checkpoints[0]:
            target = checkpoints.pop(0)
            e_c, c_c = expander._diagonalize(b)       # fingerprint-cached
            corr = expander.pt2_correction(
                b, c_c, e_c, cap=pt2_cap or (1 << 23),
                pad_to=cfg.max_basis_size)
            row = {"basis_size": int(len(b)), "checkpoint": int(target),
                   "e_var": float(e_c), "de2": float(corr["de2"]),
                   "exact": bool(corr["exact"])}
            checkpoint_rows.append(row)
            if verbose:
                print(f"  [pt2 checkpoint] basis={row['basis_size']} "
                      f"E={row['e_var']:.8f} dE2={row['de2']:.6f} "
                      f"exact={row['exact']}")

    for it in range(cfg.max_iterations):
        n_add = None
        if use_pt2 and cfg.growth_factor > 0:
            n_add = max(cfg.configs_per_iteration,
                        int(cfg.growth_factor * len(basis)))
        out = expander.expand_basis(basis, n_add=n_add)
        e = out["energy"]
        energies.append(e)
        if e < best_energy - 1e-12:
            improvement = best_energy - e
            best_energy, best_basis = e, out["basis"]
        else:
            improvement = 0.0
        basis = out["basis"]
        if verbose:
            t = getattr(expander, "timings", None)
            split = (f" [diag {t['diag']:.0f}s score {t['score']:.0f}s]"
                     if t else "")
            print(f"  residual iter {it}: E={e:.8f} "
                  f"basis={len(basis)} added={out['n_added']} "
                  f"accepted={out['accepted']}{split}")
        if use_pt2 and out["accepted"]:
            _maybe_checkpoint(basis)
        if not out["accepted"]:
            break
        if improvement < cfg.stagnation_threshold:
            stall += 1
            if stall >= cfg.stagnation_patience:
                break
        else:
            stall = 0
    if verbose and use_pt2:
        t = expander.timings
        print(f"  [sci timings] diag {t['diag']:.1f} s "
              f"(H-build {t.get('diag_build', 0.0):.1f} s), "
              f"pt2-score {t['score']:.1f} s")
    res = {"basis": best_basis, "energy": best_energy,
           "energies": energies, "n_iterations": len(energies)}
    if checkpoint_rows:
        res["pt2_checkpoints"] = checkpoint_rows
    if pt2_correct and use_pt2:
        # exact Epstein-Nesbet dE2 of the converged variational state
        # (the final-basis diagonalization hits the fingerprint cache)
        e_b, c_b = expander._diagonalize(best_basis)
        # when mid-trajectory checkpoints ran, pin the same block shape so
        # the final correction reuses their compiled program
        pad = cfg.max_basis_size if checkpoint_rows else 0
        corr = expander.pt2_correction(best_basis, c_b, e_b,
                                       cap=pt2_cap or (1 << 23), pad_to=pad)
        res.update(pt2_de2=corr["de2"],
                   pt2_corrected_energy=corr["corrected_energy"],
                   pt2_n_external=corr["n_external"],
                   pt2_exact=corr["exact"])
    return res
