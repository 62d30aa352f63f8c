"""Physics-guided NF-NQS co-training (Stage 1), fully jitted.

Behavioral counterpart of the reference trainer
(``/root/reference/src/flows/physics_guided_training.py:92-641``) —
same objectives, schedules and convergence rules — rebuilt as a single
jitted device step:

* flow sampling, on-device dedup (lexicographic sort + compaction),
  static-shape connection enumeration, chunked NQS evaluation, local
  energies, both losses and both optimizer updates run in ONE compiled
  XLA program per epoch.  The reference's per-epoch GPU->CPU->GPU round
  trip through Python connection loops (``molecular.py:194-327``) and its
  ``ConnectionCache`` are gone by construction (SURVEY.md §3.2).
* objectives: flow loss = w_t * CE(NQS||flow) + w_p * E_flow[E_loc - E]
  - w_e * H(flow), scaled by 1/(|E|+1)
  (``physics_guided_training.py:459-521``); NQS loss = REINFORCE with
  baseline (``:523-547``).
* temperature annealing 1.0 -> 0.1 over ``temperature_decay_epochs``
  (``:181-187``); convergence when unique_ratio < threshold after
  min_epochs (``:224-231``).
* accumulated-basis dedup/pruning happens on host between steps (small
  uint64 key arrays), with periodic basis diagonalization
  (``:549-641``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..hamiltonians.molecular import MolecularHamiltonian
from ..ops.bits import unpack_device
from ..ops.slater import diagonal_batch, make_connection_fn_auto

__all__ = ["PhysicsGuidedConfig", "PhysicsGuidedFlowTrainer"]


@dataclass
class PhysicsGuidedConfig:
    """Stage-1 hyperparameters (reference ``physics_guided_training.py:40-89``)."""
    num_epochs: int = 400
    min_epochs: int = 100
    samples_per_batch: int = 2000
    num_batches: int = 1               # gradient steps per epoch
    teacher_weight: float = 0.5
    physics_weight: float = 0.4
    entropy_weight: float = 0.1
    flow_lr: float = 5e-4
    nqs_lr: float = 1e-3
    grad_clip: float = 1.0
    weight_decay: float = 0.01
    initial_temperature: float = 1.0
    final_temperature: float = 0.1
    temperature_decay_epochs: int = 200
    convergence_threshold: float = 0.20
    ema_decay: float = 0.9
    max_accumulated_basis: int = 4096
    use_accumulated_energy: bool = True
    accumulated_energy_interval: int = 50
    nqs_chunk_size: int = 16384
    early_exit_on_complete_basis: bool = True  # stop when the whole space
                                               # is in the accumulated basis
    use_connection_table: bool = True   # precompute all connections on device
    connection_table_max_entries: int = 50_000_000
    # for enumerable spaces <= this many rows, keep the dense subspace H on
    # device and compute ALL local energies as one matvec per step
    # (e_loc = (H psi)[i] / psi[i]) instead of per-connection gathers
    dense_local_energy_max_dim: int = 20_000
    seed: int = 0
    verbose: bool = True


class PhysicsGuidedFlowTrainer:
    """Co-trains a particle-conserving flow and an NQS on one Hamiltonian."""

    def __init__(self, hamiltonian: MolecularHamiltonian, flow, nqs,
                 config: Optional[PhysicsGuidedConfig] = None,
                 mesh=None):
        self.h = hamiltonian
        self.flow = flow
        self.nqs = nqs
        self.config = config or PhysicsGuidedConfig()
        self.mesh = mesh  # optional ('data','basis') Mesh for SPMD sharding
        c = self.config

        self.key = jax.random.PRNGKey(c.seed)
        self.key, kf, kn = jax.random.split(self.key, 3)
        n_sites = 2 * hamiltonian.n_orbitals
        dummy = jnp.zeros((2, n_sites), jnp.float32)
        self.flow_params = flow.init(kf, kn, 2, jnp.float32(1.0),
                                     method=flow.sample)
        self.nqs_params = nqs.init(kn, dummy)

        flow_sched = optax.cosine_decay_schedule(c.flow_lr, c.num_epochs)
        nqs_sched = optax.cosine_decay_schedule(c.nqs_lr, c.num_epochs)
        self.flow_opt = optax.chain(
            optax.clip_by_global_norm(c.grad_clip),
            optax.adamw(flow_sched, weight_decay=c.weight_decay))
        self.nqs_opt = optax.chain(
            optax.clip_by_global_norm(c.grad_clip),
            optax.adamw(nqs_sched, weight_decay=c.weight_decay))
        self.flow_opt_state = self.flow_opt.init(self.flow_params)
        self.nqs_opt_state = self.nqs_opt.init(self.nqs_params)

        self.connection_table = None
        self._h_dense_dev = None
        if c.use_connection_table:
            from ..utils.connection_table import build_connection_table
            self.connection_table = build_connection_table(
                hamiltonian, max_entries=c.connection_table_max_entries)
            if (self.connection_table is not None
                    and self.connection_table.n_configs
                    <= c.dense_local_energy_max_dim):
                # dense subspace H (f32): densify ON DEVICE from the
                # already-resident table instead of shipping an 800 MB
                # matrix from the host
                t = self.connection_table
                n_cfg = t.n_configs

                @jax.jit
                def densify(target_idx, elems, diag):
                    rows = jnp.broadcast_to(
                        jnp.arange(n_cfg)[:, None], target_idx.shape)
                    H = jnp.zeros((n_cfg, n_cfg), jnp.float32)
                    H = H.at[rows, target_idx].add(elems)
                    return H.at[jnp.arange(n_cfg),
                                jnp.arange(n_cfg)].add(diag)

                self._h_dense_dev = densify(t.target_idx, t.elems, t.diag)
                if self.mesh is not None and n_cfg % self.mesh.size == 0:
                    # determinant rows sharded over ALL mesh devices so
                    # each chip holds 1/n of the dense subspace H at rest
                    # (non-divisible dims stay replicated at rest; the
                    # in-graph constraint in local_energies still shards
                    # the compute via GSPMD's uneven partitioning)
                    from ..parallel.sharded_matvec import \
                        shard_hamiltonian_rows
                    self._h_dense_dev = shard_hamiltonian_rows(
                        self.mesh, self._h_dense_dev)

        # device-resident accumulated basis: sorted (a,b) buffer padded
        # with 0xFFFFFFFF sentinels (host fetches only at stage boundaries)
        M = c.max_accumulated_basis
        self._acc_buf = jnp.full((M, 2), 0xFFFFFFFF, dtype=jnp.uint32)
        self._acc_count = 0
        self.energy_ema: Optional[float] = None
        self.history: Dict[str, list] = {
            "energies": [], "accumulated_energies": [], "teacher_losses": [],
            "physics_losses": [], "entropy_values": [], "unique_ratios": [],
            "basis_sizes": [], "epoch_times": [],
        }
        self._step = self._build_step()

    # ------------------------------------------------------------------
    # Jitted step
    # ------------------------------------------------------------------

    def _build_step(self):
        c = self.config
        h = self.h
        n_orb = h.n_orbitals
        n_sites = 2 * n_orb
        B = c.samples_per_batch
        conn_fn = make_connection_fn_auto(h.tables)
        hf = jnp.asarray(h.get_hf_state())
        flow, nqs = self.flow, self.nqs
        mesh = self.mesh

        def shard(x, *axes):
            # annotate; XLA inserts the collectives (scaling-book recipe)
            if mesh is None:
                return x
            from jax.sharding import NamedSharding, PartitionSpec
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, PartitionSpec(*axes)))

        def nqs_logamp_chunked(nqs_params, occ_flat):
            """Gradient-free chunked evaluation for connection amplitudes."""
            total = occ_flat.shape[0]
            chunk = min(c.nqs_chunk_size, total)
            n_chunks = -(-total // chunk)
            pad = n_chunks * chunk - total
            occ_p = jnp.pad(occ_flat, ((0, pad), (0, 0)))
            occ_p = occ_p.reshape(n_chunks, chunk, n_sites)
            la = jax.lax.map(lambda o: nqs.apply(nqs_params, o), occ_p)
            return la.reshape(-1)[:total]

        def unique_compact(packed):
            """Sort lexicographically, compact uniques to the front.

            Returns (unique_packed (B,2) padded with HF, n_unique)."""
            a, b = lax_sorted = jax.lax.sort(
                (packed[:, 0], packed[:, 1]), num_keys=2)
            first = jnp.concatenate([
                jnp.ones((1,), bool),
                (a[1:] != a[:-1]) | (b[1:] != b[:-1])])
            pos = jnp.where(first, jnp.cumsum(first) - 1, B)
            buf = jnp.broadcast_to(hf[None, :], (B, 2)).astype(jnp.uint32)
            buf = buf.at[pos].set(jnp.stack([a, b], -1), mode="drop")
            return buf, jnp.sum(first)

        table = self.connection_table

        dense_h = self._h_dense_dev is not None

        def local_energies(nqs_params, packed_u, la_x, table_arrays):
            if dense_h:
                # dense-matvec path: evaluate the NQS over the WHOLE
                # enumerated space, do one matvec, gather sampled rows.
                # Under a mesh, H rows and the full-space NQS eval are
                # sharded over all devices (determinant axis).
                keys_sorted, order, h_dense, t_occ = table_arrays
                k = ((packed_u[:, 0] << jnp.uint32(table.n_orb))
                     | packed_u[:, 1])
                pos = jnp.clip(jnp.searchsorted(keys_sorted, k), 0,
                               keys_sorted.shape[0] - 1)
                idx = order[pos]
                if mesh is not None:
                    t_occ = shard(t_occ, ("data", "basis"), None)
                    la_all = nqs.apply(nqs_params, t_occ)
                    h_dense = shard(h_dense, ("data", "basis"), None)
                else:
                    la_all = nqs_logamp_chunked(nqs_params, t_occ)
                shift = jnp.max(la_all)
                psi = jnp.exp(la_all - shift)
                hpsi = jnp.dot(h_dense, psi,
                               precision=jax.lax.Precision.HIGHEST)
                return hpsi[idx] / jnp.maximum(psi[idx], 1e-30)
            if table is not None:
                # precomputed-table path: pure gathers (HBM bandwidth).
                # Table tensors arrive as ARGUMENTS, not closure constants —
                # closed-over arrays become XLA literals and a 70 MB literal
                # makes compilation pathological.
                keys_sorted, order, target_idx, t_elems, t_diag, t_occ = \
                    table_arrays
                k = ((packed_u[:, 0] << jnp.uint32(table.n_orb))
                     | packed_u[:, 1])
                pos = jnp.clip(jnp.searchsorted(keys_sorted, k), 0,
                               keys_sorted.shape[0] - 1)
                idx = order[pos]
                # gathered per-batch rows shard over 'data' like the batch
                tgt = shard(target_idx[idx], "data", None)
                diag = shard(t_diag[idx], "data")
                elems = shard(t_elems[idx], "data", None)
                occ_y = t_occ[tgt]
                if mesh is not None:
                    la_y = nqs.apply(nqs_params,
                                     occ_y.reshape(-1, n_sites))
                else:
                    la_y = nqs_logamp_chunked(
                        nqs_params, occ_y.reshape(-1, n_sites))
                la_y = la_y.reshape(elems.shape)
                ratios = jnp.exp(la_y - la_x[:, None])
                return diag + jnp.sum(elems * ratios, axis=-1)
            diag = diagonal_batch(packed_u, h.tables)
            conn, elems = conn_fn(packed_u)
            if mesh is not None:
                # batch over 'data', connection axis over 'basis'; the
                # per-determinant sum below reduces over 'basis' via an
                # XLA-inserted psum
                conn = shard(conn, "data", "basis", None)
                elems = shard(elems, "data", "basis")
                occ_y = unpack_device(conn, n_orb)
                la_y = nqs.apply(nqs_params, occ_y.reshape(-1, n_sites))
                la_y = la_y.reshape(elems.shape)
            else:
                occ_y = unpack_device(conn.reshape(-1, 2), n_orb)
                la_y = nqs_logamp_chunked(nqs_params, occ_y)
                la_y = la_y.reshape(elems.shape)
            ratios = jnp.exp(la_y - la_x[:, None])
            return diag + jnp.sum(elems * ratios, axis=-1)

        M = c.max_accumulated_basis
        SENT = jnp.uint32(0xFFFFFFFF)

        def merge_accumulate(acc_buf, packed_u, n_unique, key):
            """Device-resident accumulated basis: sorted (a,b) buffer of
            capacity M padded with sentinels; union new uniques, prune a
            random subset at the cap (reference semantics,
            ``physics_guided_training.py:549-606``) — all in-graph, so the
            host never transfers the basis during training."""
            new = jnp.where((jnp.arange(B) < n_unique)[:, None], packed_u,
                            jnp.stack([jnp.broadcast_to(SENT, (B,)),
                                       jnp.broadcast_to(SENT, (B,))], -1))
            cat_a = jnp.concatenate([acc_buf[:, 0], new[:, 0]])
            cat_b = jnp.concatenate([acc_buf[:, 1], new[:, 1]])
            a, b = jax.lax.sort((cat_a, cat_b), num_keys=2)
            is_sent = (a == SENT) & (b == SENT)
            first = jnp.concatenate([
                jnp.ones((1,), bool), (a[1:] != a[:-1]) | (b[1:] != b[:-1])])
            valid = first & ~is_sent
            count = jnp.sum(valid)
            # random priorities: valid entries keep uniform keys, others +inf;
            # the lowest-M priorities survive (= uniform random subset)
            pri = jnp.where(valid,
                            jax.random.uniform(key, a.shape), jnp.inf)
            order = jnp.argsort(pri)
            keep_a = a[order][:M]
            keep_b = b[order][:M]
            keep_valid = valid[order][:M]
            keep_a = jnp.where(keep_valid, keep_a, SENT)
            keep_b = jnp.where(keep_valid, keep_b, SENT)
            ka, kb = jax.lax.sort((keep_a, keep_b), num_keys=2)
            return jnp.stack([ka, kb], -1), jnp.minimum(count, M)

        @jax.jit
        def step(flow_params, nqs_params, flow_opt_state, nqs_opt_state,
                 acc_buf, key, temperature, table_arrays=None):
            key, k_prune = jax.random.split(key)
            k_samp, = jax.random.split(key, 1)
            configs, _ = flow.apply(flow_params, k_samp, B, temperature,
                                    method=flow.sample)
            occ_hard = jnp.round(jax.lax.stop_gradient(configs))
            alpha_bits = jnp.sum(
                occ_hard[:, :n_orb].astype(jnp.uint32)
                * (jnp.uint32(1) << jnp.arange(n_orb, dtype=jnp.uint32)), -1)
            beta_bits = jnp.sum(
                occ_hard[:, n_orb:].astype(jnp.uint32)
                * (jnp.uint32(1) << jnp.arange(n_orb, dtype=jnp.uint32)), -1)
            packed = shard(jnp.stack([alpha_bits, beta_bits], -1),
                           "data", None)
            packed_u, n_unique = unique_compact(packed)
            packed_u = shard(packed_u, "data", None)
            valid = jnp.arange(B) < n_unique
            occ_u = unpack_device(packed_u, n_orb)

            # local energies (no gradient through connections)
            la_x_sg = nqs.apply(nqs_params, occ_u)
            e_loc = jax.lax.stop_gradient(
                local_energies(nqs_params, packed_u, la_x_sg, table_arrays))
            e_loc = jnp.where(valid, e_loc, 0.0)

            # NQS probabilities over the unique batch
            logp_nqs = jnp.where(valid, 2.0 * la_x_sg, -jnp.inf)
            p_nqs = jax.lax.stop_gradient(
                jax.nn.softmax(logp_nqs))
            energy = jnp.sum(e_loc * p_nqs)

            def flow_loss_fn(fp):
                lp = flow.apply(fp, occ_u, method=flow.log_prob)
                lp = jnp.where(valid, lp, -jnp.inf)
                log_flow = jax.nn.log_softmax(lp)          # batch-normalized
                log_flow = jnp.where(valid, log_flow, 0.0)
                p_flow = jnp.exp(log_flow) * valid
                teacher = -jnp.sum(p_nqs * log_flow)
                physics = jnp.sum(p_flow * (e_loc - energy))
                entropy = -jnp.sum(p_flow * log_flow)
                total = (c.teacher_weight * teacher
                         + c.physics_weight * physics
                         - c.entropy_weight * entropy)
                total = total / (jnp.abs(energy) + 1.0)
                return total, (teacher, physics, entropy)

            def nqs_loss_fn(np_):
                la = nqs.apply(np_, occ_u)
                centered = e_loc - energy
                return jnp.sum(centered * (2.0 * la) * p_nqs)

            (f_loss, (teacher, physics, entropy)), f_grads = \
                jax.value_and_grad(flow_loss_fn, has_aux=True)(flow_params)
            n_grads = jax.grad(nqs_loss_fn)(nqs_params)

            f_updates, flow_opt_state = self.flow_opt.update(
                f_grads, flow_opt_state, flow_params)
            flow_params = optax.apply_updates(flow_params, f_updates)
            n_updates, nqs_opt_state = self.nqs_opt.update(
                n_grads, nqs_opt_state, nqs_params)
            nqs_params = optax.apply_updates(nqs_params, n_updates)

            acc_buf, acc_count = merge_accumulate(acc_buf, packed_u,
                                                  n_unique, k_prune)
            # single packed metrics vector -> ONE host transfer per epoch
            metrics_vec = jnp.stack([
                energy, teacher, physics, entropy,
                n_unique / B, acc_count.astype(jnp.float32)])
            return (flow_params, nqs_params, flow_opt_state, nqs_opt_state,
                    acc_buf, metrics_vec)

        return step

    @property
    def accumulated_basis(self) -> Optional[np.ndarray]:
        """Host view of the device-resident accumulated basis."""
        if self._acc_count == 0:
            return None
        buf = np.asarray(self._acc_buf)
        valid = ~((buf[:, 0] == 0xFFFFFFFF) & (buf[:, 1] == 0xFFFFFFFF))
        return buf[valid]

    @accumulated_basis.setter
    def accumulated_basis(self, basis):
        M = self.config.max_accumulated_basis
        buf = np.full((M, 2), 0xFFFFFFFF, np.uint32)
        if basis is not None and len(basis):
            basis = np.asarray(basis, np.uint32)[:M]
            keys = self.h.keys(basis)
            order = np.argsort(keys)
            buf[:len(basis)] = basis[order]
            self._acc_count = len(basis)
        else:
            self._acc_count = 0
        # keep sentinel rows sorted after real rows (sorted merge invariant)
        a, b = buf[:, 0], buf[:, 1]
        order = np.lexsort((b, a))
        self._acc_buf = jnp.asarray(buf[order])

    @property
    def _acc_keys(self) -> Optional[np.ndarray]:
        basis = self.accumulated_basis
        return None if basis is None else np.sort(self.h.keys(basis))

    def _update_accumulated_basis(self, packed: np.ndarray, n: int):
        """Host-side seeding/merge into the device buffer (used by CI
        seeding and checkpoint restore)."""
        extra = np.asarray(packed[:n], np.uint32)
        current = self.accumulated_basis
        merged = (extra if current is None
                  else np.concatenate([current, extra]))
        keys = self.h.keys(merged)
        _, idx = np.unique(keys, return_index=True)
        self.accumulated_basis = merged[np.sort(idx)]

    def _table_arrays(self):
        t = self.connection_table
        if t is None:
            return None
        if self._h_dense_dev is not None:
            return (t._keys_sorted, t._order, self._h_dense_dev, t.occ)
        return (t._keys_sorted, t._order, t.target_idx, t.elems, t.diag,
                t.occ)

    # ------------------------------------------------------------------
    # Host-side accumulation
    # ------------------------------------------------------------------

    # (accumulation happens on device inside the jitted step; see
    # merge_accumulate in _build_step and the host helpers above)

    def _accumulated_energy(self) -> float:
        """Ground-state energy in the accumulated basis
        (``physics_guided_training.py:608-641``)."""
        if self.accumulated_basis is None or not len(self.accumulated_basis):
            return float("inf")
        vals, _ = self.h.exact_ground_state(self.accumulated_basis)
        return float(vals[0])

    # ------------------------------------------------------------------
    # Training loop
    # ------------------------------------------------------------------

    def temperature_at(self, epoch: int) -> float:
        c = self.config
        progress = min(1.0, epoch / max(1, c.temperature_decay_epochs))
        temp = (c.initial_temperature
                + progress * (c.final_temperature - c.initial_temperature))
        if epoch < getattr(self, "_reheat_until", 0):
            # AdaptiveAdjuster flagged an early flow collapse: reheat to
            # half the initial temperature so sampling re-diversifies
            temp = max(temp, 0.5 * c.initial_temperature)
        return temp

    def train(self) -> Dict[str, list]:
        c = self.config
        # runtime heuristics (reference ``system_scaler.py:537-609``): the
        # adjuster watches unique_ratio/energy trends; its tips drive the
        # two knobs that are live mid-training — the sampling temperature
        # (reheat on early collapse) and the convergence exit (defer while
        # the energy is still falling)
        from ..utils.system_scaler import AdaptiveAdjuster
        adjuster = AdaptiveAdjuster()
        self.history.setdefault("adjuster_tips", [])
        self._reheat_until = 0
        conv_deferred = 0
        for epoch in range(c.num_epochs):
            t0 = time.perf_counter()
            temp = jnp.float32(self.temperature_at(epoch))
            batch_metrics = []
            for _ in range(max(1, c.num_batches)):
                self.key, k = jax.random.split(self.key)
                (self.flow_params, self.nqs_params, self.flow_opt_state,
                 self.nqs_opt_state, self._acc_buf, metrics_vec) = \
                    self._step(self.flow_params, self.nqs_params,
                               self.flow_opt_state, self.nqs_opt_state,
                               self._acc_buf, k, temp, self._table_arrays())
                # ONE device->host transfer per step (each fetch waits for
                # the device; the basis stays on device)
                vec = np.asarray(metrics_vec)
                batch_metrics.append({
                    "energy": float(vec[0]), "teacher_loss": float(vec[1]),
                    "physics_loss": float(vec[2]), "entropy": float(vec[3]),
                    "unique_ratio": float(vec[4])})
                self._acc_count = int(vec[5])

            m = {k_: sum(bm[k_] for bm in batch_metrics)
                 / len(batch_metrics) for k_ in batch_metrics[0]}
            if self.energy_ema is None:
                self.energy_ema = m["energy"]
            else:
                self.energy_ema = (c.ema_decay * self.energy_ema
                                   + (1 - c.ema_decay) * m["energy"])
            self.history["energies"].append(m["energy"])
            self.history["teacher_losses"].append(m["teacher_loss"])
            self.history["physics_losses"].append(m["physics_loss"])
            self.history["entropy_values"].append(m["entropy"])
            self.history["unique_ratios"].append(m["unique_ratio"])
            self.history["basis_sizes"].append(self._acc_count)
            self.history["epoch_times"].append(time.perf_counter() - t0)

            if (c.use_accumulated_energy
                    and epoch % c.accumulated_energy_interval == 0):
                self.history["accumulated_energies"].append(
                    self._accumulated_energy())

            if c.verbose and (epoch % 25 == 0 or epoch == c.num_epochs - 1):
                print(f"  epoch {epoch:4d}  E={m['energy']:.6f} "
                      f"EMA={self.energy_ema:.6f} "
                      f"unique={m['unique_ratio']:.2f} "
                      f"basis={self.history['basis_sizes'][-1]}")

            tips = adjuster.suggest(self.history)
            if tips:
                self.history["adjuster_tips"].append((epoch, dict(tips)))
                if ("convergence_threshold" in tips
                        and self._reheat_until <= epoch):
                    self._reheat_until = epoch + 25
                    if c.verbose:
                        print(f"  [adjust] flow collapsed early; reheating "
                              f"temperature for 25 epochs")

            if epoch >= c.min_epochs and \
                    m["unique_ratio"] < c.convergence_threshold:
                if "max_epochs" in tips and conv_deferred < c.min_epochs // 2:
                    # energy still improving: defer the exit (bounded)
                    conv_deferred += 1
                else:
                    if c.verbose:
                        print(f"  converged at epoch {epoch}: "
                              f"unique_ratio={m['unique_ratio']:.3f}")
                    break
            # complete-space early exit: once every valid determinant is in
            # the accumulated basis (and fits the cap), further epochs only
            # polish the NQS, whose energy the pipeline does not use
            if (c.early_exit_on_complete_basis and epoch >= c.min_epochs
                    and hasattr(self.h, "n_valid_configs")
                    and self._acc_count >= self.h.n_valid_configs):
                if c.verbose:
                    print(f"  basis complete at epoch {epoch}: "
                          f"{self._acc_count:,} configs")
                break
        return self.history
