"""Legacy/alternative Stage-1 trainer: subspace-energy objective.

Counterpart of ``/root/reference/src/flows/training.py`` (the trainer the
pipeline imports but does not invoke from ``run()``; SURVEY.md §2.2):

* :class:`IncrementalHamiltonianCache` — dense projected H over the
  accumulated basis, extended blockwise as the basis grows instead of
  recomputed (``training.py:136-277``).
* :class:`FlowNQSTrainer` — trains the NQS on the *subspace energy*
  E(theta) = c^T H c / c^T c with c_i = |psi_theta(x_i)| over the
  accumulated basis (a deterministic Rayleigh quotient — no sampling
  noise), plus a teacher cross-entropy flow update; |psi|^2-based basis
  pruning (``training.py:280-692``).
* :class:`InferenceNQSTrainer` — post-convergence: freeze the flow,
  retrain a fresh NQS on the fixed basis with a precomputed H and
  plateau-based LR decay (``training.py:715-790``).
* checkpoint save/load (``training.py:694-712``) via utils.checkpoint.

Static-shape discipline: the Rayleigh-quotient step jits at a fixed basis
capacity with a validity mask, so basis growth does not trigger
recompilation until the capacity tier doubles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..hamiltonians.molecular import MolecularHamiltonian
from ..ops.bits import unpack_np

__all__ = ["TrainingConfig", "IncrementalHamiltonianCache",
           "FlowNQSTrainer", "InferenceNQSTrainer"]


@dataclass
class TrainingConfig:
    """Knobs mirroring the reference (``training.py:39-78``)."""
    num_epochs: int = 300
    min_epochs: int = 50
    samples_per_batch: int = 1000
    nqs_lr: float = 1e-3
    flow_lr: float = 5e-4
    grad_clip: float = 1.0
    max_basis_size: int = 2048
    prune_fraction: float = 0.9       # keep top-|psi|^2 fraction on prune
    convergence_threshold: float = 1e-6
    patience: int = 30
    save_interval: int = 50           # epochs between auto-checkpoints
    checkpoint_dir: Optional[str] = None
    temperature: float = 1.0
    seed: int = 0
    verbose: bool = False


class IncrementalHamiltonianCache:
    """Dense projected H grown blockwise with the basis."""

    def __init__(self, hamiltonian: MolecularHamiltonian):
        self.h = hamiltonian
        self.basis: Optional[np.ndarray] = None     # (M, W) uint32
        self.H: Optional[np.ndarray] = None         # (M, M) f64

    def __len__(self) -> int:
        return 0 if self.basis is None else len(self.basis)

    def extend(self, new_dets: np.ndarray) -> None:
        """Append new determinants; compute only the new blocks."""
        new_dets = np.atleast_2d(np.asarray(new_dets, np.uint32))
        if len(new_dets) == 0:
            return
        if self.basis is None:
            self.basis = new_dets
            self.H = self.h.matrix_elements(new_dets, new_dets)
            self.H = 0.5 * (self.H + self.H.T)
            return
        old = self.basis
        # coupling block <old|H|new> and diagonal block <new|H|new>
        coupling = self.h.matrix_elements(old, new_dets)
        diag_blk = self.h.matrix_elements(new_dets, new_dets)
        diag_blk = 0.5 * (diag_blk + diag_blk.T)
        n_old, n_new = len(old), len(new_dets)
        H = np.empty((n_old + n_new, n_old + n_new))
        H[:n_old, :n_old] = self.H
        H[:n_old, n_old:] = coupling
        H[n_old:, :n_old] = coupling.T
        H[n_old:, n_old:] = diag_blk
        self.H = H
        self.basis = np.concatenate([old, new_dets], axis=0)

    def restrict(self, keep: np.ndarray) -> None:
        """Prune to the given index subset."""
        self.basis = self.basis[keep]
        self.H = self.H[np.ix_(keep, keep)]


class _SortedKeyDedup:
    """O(log n) membership over uint64 keys (the reference's GPU hash table
    role, ``training.py:80-133``, done with sorted keys + searchsorted)."""

    def __init__(self):
        self.keys = np.empty(0, np.uint64)

    def filter_new(self, keys: np.ndarray) -> np.ndarray:
        """Return mask of keys not yet present (first occurrence only)."""
        uniq, first = np.unique(keys, return_index=True)
        mask = np.zeros(len(keys), bool)
        if len(self.keys):
            pos = np.clip(np.searchsorted(self.keys, uniq), 0,
                          len(self.keys) - 1)
            fresh = self.keys[pos] != uniq
        else:
            fresh = np.ones(len(uniq), bool)
        mask[first[fresh]] = True
        self.keys = np.union1d(self.keys, uniq[fresh])
        return mask

    def remove_to(self, keys: np.ndarray) -> None:
        self.keys = np.sort(np.asarray(keys, np.uint64))


class FlowNQSTrainer:
    """Subspace-energy NQS training with incremental H and flow teaching."""

    def __init__(self, hamiltonian: MolecularHamiltonian, flow, nqs,
                 config: Optional[TrainingConfig] = None):
        self.h = hamiltonian
        self.flow = flow
        self.nqs = nqs
        self.config = config or TrainingConfig()
        c = self.config

        self.key = jax.random.PRNGKey(c.seed)
        self.key, kf, kn = jax.random.split(self.key, 3)
        n_sites = 2 * hamiltonian.n_orbitals
        self.flow_params = flow.init(kf, kn, 2, jnp.float32(1.0),
                                     method=flow.sample)
        self.nqs_params = nqs.init(kn, jnp.zeros((2, n_sites), jnp.float32))

        self.nqs_opt = optax.chain(optax.clip_by_global_norm(c.grad_clip),
                                   optax.adam(c.nqs_lr))
        self.flow_opt = optax.chain(optax.clip_by_global_norm(c.grad_clip),
                                    optax.adam(c.flow_lr))
        self.nqs_opt_state = self.nqs_opt.init(self.nqs_params)
        self.flow_opt_state = self.flow_opt.init(self.flow_params)

        self.cache = IncrementalHamiltonianCache(hamiltonian)
        self.dedup = _SortedKeyDedup()
        self.history: Dict[str, list] = {"energies": [], "basis_sizes": [],
                                         "epoch_times": []}
        self._jit_cache: Dict[int, callable] = {}

    # ------------------------------------------------------------------

    def _capacity(self, n: int) -> int:
        cap = 64
        while cap < n:
            cap *= 2
        return cap

    def _get_step(self, cap: int):
        if cap in self._jit_cache:
            return self._jit_cache[cap]
        nqs, flow = self.nqs, self.flow
        nqs_opt, flow_opt = self.nqs_opt, self.flow_opt

        @jax.jit
        def step(nqs_params, flow_params, nqs_opt_state, flow_opt_state,
                 H_pad, occ_pad, mask):
            def energy_fn(p):
                la = nqs.apply(p, occ_pad)
                la = jnp.where(mask, la, -30.0)
                c_ = jnp.exp(la - jnp.max(jnp.where(mask, la, -jnp.inf)))
                c_ = c_ * mask
                num = c_ @ (H_pad @ c_)
                den = c_ @ c_
                return num / (den + 1e-30)

            e, g = jax.value_and_grad(energy_fn)(nqs_params)
            upd, nqs_opt_state = nqs_opt.update(g, nqs_opt_state)
            nqs_params = optax.apply_updates(nqs_params, upd)

            # teacher update for the flow toward |psi|^2
            la = jax.lax.stop_gradient(nqs.apply(nqs_params, occ_pad))
            logp = jnp.where(mask, 2.0 * la, -jnp.inf)
            p_nqs = jax.nn.softmax(logp)

            def flow_loss_fn(fp):
                lp = flow.apply(fp, occ_pad, method=flow.log_prob)
                lp = jnp.where(mask, lp, 0.0)
                return -jnp.sum(p_nqs * lp)

            fl, fg = jax.value_and_grad(flow_loss_fn)(flow_params)
            fupd, flow_opt_state = flow_opt.update(fg, flow_opt_state)
            flow_params = optax.apply_updates(flow_params, fupd)
            return (nqs_params, flow_params, nqs_opt_state, flow_opt_state,
                    e, fl)

        self._jit_cache[cap] = step
        return step

    def _padded_inputs(self, cap: int):
        n = len(self.cache)
        H_pad = np.zeros((cap, cap), np.float32)
        H_pad[:n, :n] = self.cache.H
        occ = unpack_np(self.cache.basis, self.h.n_orbitals).astype(np.float32)
        occ_pad = np.zeros((cap, occ.shape[1]), np.float32)
        occ_pad[:n] = occ
        mask = np.zeros(cap, np.float32)
        mask[:n] = 1.0
        return (jnp.asarray(H_pad), jnp.asarray(occ_pad), jnp.asarray(mask))

    def _sample_and_accumulate(self):
        c = self.config
        self.key, k = jax.random.split(self.key)
        configs, _ = self.flow.apply(self.flow_params, k,
                                     c.samples_per_batch,
                                     jnp.float32(c.temperature),
                                     method=self.flow.sample)
        occ = np.round(np.asarray(configs)).astype(np.int8)
        from ..ops.bits import pack_np
        packed = pack_np(occ, self.h.n_orbitals)
        mask = self.dedup.filter_new(self.h.keys(packed))
        if mask.any():
            self.cache.extend(packed[mask])

    def _prune_if_needed(self):
        c = self.config
        if len(self.cache) <= c.max_basis_size:
            return
        occ = unpack_np(self.cache.basis, self.h.n_orbitals)
        la = np.asarray(self.nqs.apply(
            self.nqs_params, jnp.asarray(occ, jnp.float32)))
        keep_n = int(c.max_basis_size * c.prune_fraction)
        keep = np.sort(np.argsort(-la)[:keep_n])
        self.cache.restrict(keep)
        self.dedup.remove_to(self.h.keys(self.cache.basis))

    # ------------------------------------------------------------------

    def train(self) -> Dict[str, list]:
        import time as _t
        c = self.config
        best = np.inf
        stall = 0
        for epoch in range(c.num_epochs):
            t0 = _t.perf_counter()
            self._sample_and_accumulate()
            self._prune_if_needed()
            cap = self._capacity(len(self.cache))
            step = self._get_step(cap)
            H_pad, occ_pad, mask = self._padded_inputs(cap)
            (self.nqs_params, self.flow_params, self.nqs_opt_state,
             self.flow_opt_state, e, _fl) = step(
                self.nqs_params, self.flow_params, self.nqs_opt_state,
                self.flow_opt_state, H_pad, occ_pad, mask)
            e = float(e)
            self.history["energies"].append(e)
            self.history["basis_sizes"].append(len(self.cache))
            self.history["epoch_times"].append(_t.perf_counter() - t0)
            if c.verbose and epoch % 25 == 0:
                print(f"  [legacy] epoch {epoch}: E={e:.6f} "
                      f"basis={len(self.cache)}")
            if c.checkpoint_dir and epoch and epoch % c.save_interval == 0:
                self.save_checkpoint(f"{c.checkpoint_dir}/epoch_{epoch}")
            if epoch >= c.min_epochs:
                if e < best - c.convergence_threshold:
                    best, stall = e, 0
                else:
                    stall += 1
                    if stall >= c.patience:
                        break
        return self.history

    def extract_basis(self, max_size: Optional[int] = None) -> np.ndarray:
        """Top accumulated configs by |psi|^2 (``training.py:670-692``)."""
        occ = unpack_np(self.cache.basis, self.h.n_orbitals)
        la = np.asarray(self.nqs.apply(
            self.nqs_params, jnp.asarray(occ, jnp.float32)))
        order = np.argsort(-la)
        if max_size is not None:
            order = order[:max_size]
        return self.cache.basis[np.sort(order)]

    def save_checkpoint(self, path: str) -> str:
        from ..utils.checkpoint import save_checkpoint
        return save_checkpoint(path, {
            "flow_params": self.flow_params,
            "nqs_params": self.nqs_params,
            "flow_opt_state": self.flow_opt_state,
            "nqs_opt_state": self.nqs_opt_state,
            "basis": self.cache.basis,
            "rng_key": self.key,
            "history": {k: np.asarray(v)
                        for k, v in self.history.items() if len(v)},
        })

    def load_checkpoint(self, path: str) -> None:
        from ..utils.checkpoint import load_checkpoint
        st = load_checkpoint(path)
        self.flow_params = st["flow_params"]
        self.nqs_params = st["nqs_params"]
        self.key = np.asarray(st["rng_key"], np.uint32)
        basis = st.get("basis")
        if basis is not None:
            basis = np.asarray(basis, np.uint32)
            self.cache = IncrementalHamiltonianCache(self.h)
            self.cache.extend(basis)
            self.dedup.remove_to(self.h.keys(basis))
        for k, v in st.get("history", {}).items():
            self.history[k] = list(np.asarray(v))


class InferenceNQSTrainer:
    """Retrain a fresh NQS on a fixed basis with precomputed H
    (``training.py:715-790``)."""

    def __init__(self, hamiltonian: MolecularHamiltonian, nqs,
                 basis: np.ndarray, lr: float = 1e-3,
                 num_epochs: int = 500, patience: int = 30, seed: int = 0):
        self.h = hamiltonian
        self.nqs = nqs
        self.basis = np.atleast_2d(np.asarray(basis, np.uint32))
        self.num_epochs = num_epochs
        self.patience = patience

        H = hamiltonian.matrix_elements(self.basis, self.basis)
        self.H = jnp.asarray(0.5 * (H + H.T), jnp.float32)
        occ = unpack_np(self.basis, hamiltonian.n_orbitals)
        self.occ = jnp.asarray(occ, jnp.float32)

        key = jax.random.PRNGKey(seed)
        self.params = nqs.init(key, self.occ[:2])
        self.lr = lr

    def train(self) -> Dict[str, list]:
        nqs = self.nqs
        H, occ = self.H, self.occ

        def energy_fn(p):
            la = nqs.apply(p, occ)
            c = jnp.exp(la - jnp.max(la))
            return (c @ (H @ c)) / (c @ c + 1e-30)

        energy_and_grad = jax.jit(jax.value_and_grad(energy_fn))
        lr = self.lr
        opt = optax.adam(lr)
        opt_state = opt.init(self.params)
        hist = {"energies": []}
        best = np.inf
        stall = 0
        for epoch in range(self.num_epochs):
            e, g = energy_and_grad(self.params)
            upd, opt_state = opt.update(g, opt_state)
            self.params = optax.apply_updates(self.params, upd)
            e = float(e)
            hist["energies"].append(e)
            if e < best - 1e-9:
                best, stall = e, 0
            else:
                stall += 1
                if stall >= self.patience:
                    # plateau: halve LR once, then stop on second plateau
                    if lr > self.lr / 4:
                        lr = lr / 2
                        opt = optax.adam(lr)
                        opt_state = opt.init(self.params)
                        stall = 0
                    else:
                        break
        return hist
