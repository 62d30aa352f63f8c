"""Device connection table vs on-the-fly kernel."""

import numpy as np

import jax.numpy as jnp

from flow_guided_krylov_tpu.hamiltonians import create_lih_hamiltonian
from flow_guided_krylov_tpu.utils.connection_table import \
    build_connection_table


def test_table_matches_kernel():
    h = create_lih_hamiltonian()
    table = build_connection_table(h)
    assert table is not None
    assert table.n_configs == 225

    rng = np.random.default_rng(0)
    batch = h.enumerate_basis()[rng.permutation(225)[:40]]
    diag_t, elems_t, occ_t = table.local_energy_inputs(jnp.asarray(batch))

    diag_ref = h.diagonal_np(batch)
    conn_ref, elems_ref = h.connections_np(batch)
    np.testing.assert_allclose(np.asarray(diag_t), diag_ref,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(elems_t), elems_ref, atol=2e-5)
    # target occupations must match the packed targets
    from flow_guided_krylov_tpu.ops.bits import unpack_np
    occ_ref = unpack_np(conn_ref.reshape(-1, 2), h.n_orbitals)
    np.testing.assert_array_equal(
        np.asarray(occ_t).reshape(-1, 2 * h.n_orbitals), occ_ref)


def test_table_caps():
    h = create_lih_hamiltonian()
    assert build_connection_table(h, max_entries=10) is None


def test_dense_matvec_local_energy_matches_gather():
    """The dense-H matvec local-energy path == per-connection gather path."""
    import jax
    from flow_guided_krylov_tpu.flows import (ParticleConservingFlow,
                                              PhysicsGuidedConfig,
                                              PhysicsGuidedFlowTrainer)
    from flow_guided_krylov_tpu.models import DenseNQS

    h = create_lih_hamiltonian()

    def make(dense_cap):
        flow = ParticleConservingFlow(n_orbitals=6, n_alpha=2, n_beta=2,
                                      hidden_dims=(32, 32))
        nqs = DenseNQS(num_sites=12, hidden_dims=(32, 32))
        cfg = PhysicsGuidedConfig(samples_per_batch=128, verbose=False,
                                  seed=7, dense_local_energy_max_dim=dense_cap)
        return PhysicsGuidedFlowTrainer(h, flow, nqs, cfg)

    t_dense, t_gather = make(20000), make(0)
    assert t_dense._h_dense_dev is not None
    assert t_gather._h_dense_dev is None

    def run(tr):
        out = tr._step(tr.flow_params, tr.nqs_params, tr.flow_opt_state,
                       tr.nqs_opt_state, tr._acc_buf,
                       jax.random.PRNGKey(3),
                       jnp.asarray(1.0, jnp.float32), tr._table_arrays())
        return float(np.asarray(out[-1])[0])

    assert abs(run(t_dense) - run(t_gather)) < 1e-4
