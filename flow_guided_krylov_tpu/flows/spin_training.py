"""Stage-1 trainer for general spin systems (discrete RealNVP flow).

The reference pipeline supports "general spin systems" through its
``DiscreteFlowSampler`` fallback (``/root/reference/src/pipeline.py:357-363``);
this module is the jitted device counterpart: co-train the RealNVP discrete
flow with an NQS on a spin Hamiltonian using the same mixed objective as
the molecular trainer (teacher CE + physics + entropy; REINFORCE NQS), with
local energies from the static-shape spin connection kernels
(``hamiltonians/spin.py`` device ops).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .physics_guided_training import PhysicsGuidedConfig

__all__ = ["SpinFlowTrainer"]


class SpinFlowTrainer:
    """Co-trains a DiscreteFlowSampler and an NQS on a spin Hamiltonian."""

    def __init__(self, hamiltonian, flow, nqs,
                 config: Optional[PhysicsGuidedConfig] = None,
                 n_mc_prob: int = 32):
        self.h = hamiltonian
        self.flow = flow
        self.nqs = nqs
        self.config = config or PhysicsGuidedConfig()
        self.n_mc_prob = n_mc_prob
        c = self.config

        self.key = jax.random.PRNGKey(c.seed)
        self.key, kf, kn = jax.random.split(self.key, 3)
        n = hamiltonian.n_sites
        self.flow_params = flow.init(kf, kf, 2, method=flow.sample)
        self.nqs_params = nqs.init(kn, jnp.zeros((2, n), jnp.float32))

        flow_sched = optax.cosine_decay_schedule(c.flow_lr, c.num_epochs)
        nqs_sched = optax.cosine_decay_schedule(c.nqs_lr, c.num_epochs)
        self.flow_opt = optax.chain(optax.clip_by_global_norm(c.grad_clip),
                                    optax.adamw(flow_sched,
                                                weight_decay=c.weight_decay))
        self.nqs_opt = optax.chain(optax.clip_by_global_norm(c.grad_clip),
                                   optax.adamw(nqs_sched,
                                               weight_decay=c.weight_decay))
        self.flow_opt_state = self.flow_opt.init(self.flow_params)
        self.nqs_opt_state = self.nqs_opt.init(self.nqs_params)

        self.accumulated_basis: Optional[np.ndarray] = None   # (M, 1) uint32
        self._acc_keys: Optional[np.ndarray] = None
        self.energy_ema = None
        self.history: Dict[str, list] = {
            "energies": [], "teacher_losses": [], "physics_losses": [],
            "entropy_values": [], "unique_ratios": [], "basis_sizes": [],
            "epoch_times": [], "accumulated_energies": [],
        }
        self._step = self._build_step()

    def _build_step(self):
        c = self.config
        h = self.h
        n = h.n_sites
        B = c.samples_per_batch
        flow, nqs = self.flow, self.nqs
        conn_fn = h.connections_device
        n_mc = self.n_mc_prob

        weights = jnp.uint32(1) << jnp.arange(n, dtype=jnp.uint32)

        def pack(occ):
            return jnp.sum(occ.astype(jnp.uint32) * weights[None, :], -1)

        def unpack(packed):
            shifts = jnp.arange(n, dtype=jnp.uint32)
            return ((packed[:, None] >> shifts) & jnp.uint32(1)
                    ).astype(jnp.float32)

        def unique_compact(packed):
            s = jnp.sort(packed)
            first = jnp.concatenate([jnp.ones((1,), bool),
                                     s[1:] != s[:-1]])
            pos = jnp.where(first, jnp.cumsum(first) - 1, B)
            buf = jnp.zeros((B,), jnp.uint32).at[pos].set(s, mode="drop")
            return buf, jnp.sum(first)

        @jax.jit
        def step(flow_params, nqs_params, flow_opt_state, nqs_opt_state, key):
            k_samp, k_prob = jax.random.split(key)
            configs, _ = flow.apply(flow_params, k_samp, B,
                                    method=flow.sample)
            packed = pack(jnp.round(configs))
            packed_u, n_unique = unique_compact(packed)
            valid = jnp.arange(B) < n_unique
            occ_u = unpack(packed_u)

            la_x = nqs.apply(nqs_params, occ_u)
            diag = h.diagonal_device(packed_u[:, None])
            conn, elems = conn_fn(packed_u[:, None])
            occ_y = unpack(conn[..., 0].reshape(-1))
            la_y = nqs.apply(nqs_params, occ_y).reshape(elems.shape)
            e_loc = jax.lax.stop_gradient(
                diag + jnp.sum(elems * jnp.exp(la_y - la_x[:, None]), -1))
            e_loc = jnp.where(valid, e_loc, 0.0)

            logp_nqs = jnp.where(valid, 2.0 * la_x, -jnp.inf)
            p_nqs = jax.lax.stop_gradient(jax.nn.softmax(logp_nqs))
            energy = jnp.sum(e_loc * p_nqs)

            def flow_loss_fn(fp):
                probs = flow.apply(fp, k_prob, occ_u, n_mc,
                                   method=flow.estimate_discrete_prob)
                lp = jnp.log(probs + 1e-30)
                lp = jnp.where(valid, lp, -jnp.inf)
                log_flow = jax.nn.log_softmax(lp)
                log_flow = jnp.where(valid, log_flow, 0.0)
                p_flow = jnp.exp(log_flow) * valid
                teacher = -jnp.sum(p_nqs * log_flow)
                physics = jnp.sum(p_flow * (e_loc - energy))
                entropy = -jnp.sum(p_flow * log_flow)
                total = (c.teacher_weight * teacher
                         + c.physics_weight * physics
                         - c.entropy_weight * entropy)
                return total / (jnp.abs(energy) + 1.0), (teacher, physics,
                                                         entropy)

            def nqs_loss_fn(np_):
                la = nqs.apply(np_, occ_u)
                return jnp.sum((e_loc - energy) * (2.0 * la) * p_nqs)

            (_, (teacher, physics, entropy)), fg = \
                jax.value_and_grad(flow_loss_fn, has_aux=True)(flow_params)
            ng = jax.grad(nqs_loss_fn)(nqs_params)
            fu, flow_opt_state = self.flow_opt.update(fg, flow_opt_state,
                                                      flow_params)
            flow_params = optax.apply_updates(flow_params, fu)
            nu, nqs_opt_state = self.nqs_opt.update(ng, nqs_opt_state,
                                                    nqs_params)
            nqs_params = optax.apply_updates(nqs_params, nu)
            metrics = {"energy": energy, "teacher_loss": teacher,
                       "physics_loss": physics, "entropy": entropy,
                       "unique_ratio": n_unique / B}
            return (flow_params, nqs_params, flow_opt_state, nqs_opt_state,
                    packed_u, n_unique, metrics)

        return step

    def _accumulate(self, packed_u: np.ndarray, n_unique: int):
        new = packed_u[:n_unique].astype(np.uint64)
        if self._acc_keys is None:
            self._acc_keys = np.unique(new)
        else:
            self._acc_keys = np.union1d(self._acc_keys, new)
        cap = self.config.max_accumulated_basis
        if len(self._acc_keys) > cap:
            rng = np.random.default_rng(len(self._acc_keys))
            self._acc_keys = np.sort(
                rng.permutation(self._acc_keys)[:cap])
        self.accumulated_basis = self._acc_keys.astype(np.uint32)[:, None]

    def train(self) -> Dict[str, list]:
        c = self.config
        for epoch in range(c.num_epochs):
            t0 = time.perf_counter()
            self.key, k = jax.random.split(self.key)
            (self.flow_params, self.nqs_params, self.flow_opt_state,
             self.nqs_opt_state, packed_u, n_unique, metrics) = self._step(
                self.flow_params, self.nqs_params, self.flow_opt_state,
                self.nqs_opt_state, k)
            self._accumulate(np.asarray(packed_u), int(n_unique))
            m = {k_: float(v) for k_, v in metrics.items()}
            ema_d = c.ema_decay
            self.energy_ema = (m["energy"] if self.energy_ema is None
                               else ema_d * self.energy_ema
                               + (1 - ema_d) * m["energy"])
            self.history["energies"].append(m["energy"])
            self.history["teacher_losses"].append(m["teacher_loss"])
            self.history["physics_losses"].append(m["physics_loss"])
            self.history["entropy_values"].append(m["entropy"])
            self.history["unique_ratios"].append(m["unique_ratio"])
            self.history["basis_sizes"].append(len(self.accumulated_basis))
            self.history["epoch_times"].append(time.perf_counter() - t0)
            if c.verbose and epoch % 25 == 0:
                print(f"  [spin] epoch {epoch}: E={m['energy']:.6f} "
                      f"unique={m['unique_ratio']:.2f} "
                      f"basis={len(self.accumulated_basis)}")
            if epoch >= c.min_epochs and \
                    m["unique_ratio"] < c.convergence_threshold:
                if c.verbose:
                    print(f"  [spin] converged at epoch {epoch}")
                break
        return self.history
