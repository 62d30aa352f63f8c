"""Slater-Condon kernel tests against the brute-force Fock-space oracle."""

from itertools import combinations

import numpy as np
import pytest

from flow_guided_krylov_tpu.ops import (build_tables, connections_batch_np,
                                        diagonal_batch, diagonal_batch_np,
                                        keys_np, make_connection_fn)
from flow_guided_krylov_tpu.ops.brute_force import dense_hamiltonian_fock


def random_integrals(n, seed=0):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(n, n))
    h1 = 0.5 * (h1 + h1.T)
    h2 = rng.normal(size=(n, n, n, n))
    # impose 8-fold chemist symmetry
    h2 = h2 + h2.transpose(1, 0, 2, 3)
    h2 = h2 + h2.transpose(0, 1, 3, 2)
    h2 = h2 + h2.transpose(2, 3, 0, 1)
    return h1, h2 / 8.0, 0.37


def enumerate_dets(n, ka, kb):
    """All particle-conserving determinants as (B, 2) uint32, plus full-space ints."""
    alphas = [sum(1 << i for i in c) for c in combinations(range(n), ka)]
    betas = [sum(1 << i for i in c) for c in combinations(range(n), kb)]
    packed = np.array([(a, b) for a in alphas for b in betas], dtype=np.uint32)
    full = np.array([a | (b << n) for a, b in packed], dtype=np.int64)
    return packed, full


def subspace_dense_from_kernels(packed, tables):
    """Assemble dense H over `packed` using the NumPy kernel path."""
    B = packed.shape[0]
    key_list = keys_np(packed)
    order = np.argsort(key_list)
    sorted_keys = key_list[order]
    H = np.zeros((B, B))
    H[np.arange(B), np.arange(B)] = diagonal_batch_np(packed, tables)
    conn, elems = connections_batch_np(packed, tables)
    ck = keys_np(conn.reshape(-1, 2))
    pos = np.searchsorted(sorted_keys, ck)
    pos = np.clip(pos, 0, B - 1)
    hit = sorted_keys[pos] == ck
    cols = order[pos]
    rows = np.repeat(np.arange(B), conn.shape[1])
    np.add.at(H, (cols[hit], rows[hit]), elems.reshape(-1)[hit])
    return H


@pytest.mark.parametrize("n,ka,kb,seed", [
    (3, 2, 1, 0), (3, 1, 1, 1), (4, 2, 2, 2), (4, 3, 1, 3),
])
def test_kernels_vs_brute_force(n, ka, kb, seed):
    h1, h2, e_nuc = random_integrals(n, seed)
    tables = build_tables(h1, h2, e_nuc, ka, kb)
    packed, full = enumerate_dets(n, ka, kb)

    H_oracle_full = dense_hamiltonian_fock(h1, h2, e_nuc)
    H_oracle = H_oracle_full[np.ix_(full, full)]
    H_kernel = subspace_dense_from_kernels(packed, tables)

    assert np.allclose(H_kernel, H_kernel.T, atol=1e-10), "kernel H not symmetric"
    np.testing.assert_allclose(H_kernel, H_oracle, atol=1e-10)


@pytest.mark.parametrize("n,ka,kb", [(4, 2, 2), (5, 3, 2)])
def test_jax_matches_numpy(n, ka, kb):
    h1, h2, e_nuc = random_integrals(n, seed=7)
    tables = build_tables(h1, h2, e_nuc, ka, kb)
    packed, _ = enumerate_dets(n, ka, kb)

    conn_np, el_np = connections_batch_np(packed, tables)
    conn_fn = make_connection_fn(tables)
    conn_j, el_j = conn_fn(packed)
    np.testing.assert_array_equal(np.asarray(conn_j), conn_np)
    np.testing.assert_allclose(np.asarray(el_j), el_np, atol=2e-5)

    d_np = diagonal_batch_np(packed, tables)
    d_j = np.asarray(diagonal_batch(packed, tables))
    np.testing.assert_allclose(d_j, d_np, rtol=2e-5, atol=2e-5)


def test_connection_targets_unique_and_particle_conserving():
    h1, h2, e_nuc = random_integrals(5, seed=11)
    tables = build_tables(h1, h2, e_nuc, 3, 2)
    packed, _ = enumerate_dets(5, 3, 2)
    conn, _ = connections_batch_np(packed[:5], tables)
    for b in range(conn.shape[0]):
        ck = keys_np(conn[b])
        assert len(np.unique(ck)) == conn.shape[1], "duplicate connection targets"
        for a, bb in conn[b]:
            assert bin(int(a)).count("1") == 3
            assert bin(int(bb)).count("1") == 2
        # source not among targets
        assert keys_np(packed[b:b + 1])[0] not in ck


@pytest.mark.parametrize("n,ka,kb", [(6, 3, 2), (8, 5, 5), (6, 1, 1),
                                     (5, 4, 1), (7, 6, 6)])
def test_gather_kernel_matches_host_mirror(n, ka, kb):
    """The device gather kernel (the only single-word kernel) == the f64
    host mirror, including k=1 / k=n-1 edge shapes."""
    h1, h2, e_nuc = random_integrals(n, seed=5)
    tables = build_tables(h1, h2, e_nuc, ka, kb)
    packed, _ = enumerate_dets(n, ka, kb)
    packed = packed[:256]
    conn_np, el_np = connections_batch_np(packed, tables)
    c1, e1 = make_connection_fn(tables)(packed)
    np.testing.assert_array_equal(np.asarray(c1), conn_np)
    np.testing.assert_allclose(np.asarray(e1), el_np, atol=2e-5)


def test_connection_kernel_auto_routing():
    """The auto-pick is the gather kernel for every single-word shape and
    w2 above 32 orbitals, and the produced kernel computes the same
    connections."""
    from flow_guided_krylov_tpu.ops.slater import (connection_kernel_choice,
                                                   make_connection_fn_auto)
    h1, h2, e_nuc = random_integrals(8, seed=3)
    tables = build_tables(h1, h2, e_nuc, 5, 5)
    assert connection_kernel_choice(tables) == "v1"
    big = build_tables(*random_integrals(12, seed=3), 6, 6)
    assert connection_kernel_choice(big) == "v1"
    wide = build_tables(np.eye(33), np.zeros((33,) * 4), 0.0, 1, 1)
    assert connection_kernel_choice(wide) == "w2"
    packed, _ = enumerate_dets(8, 5, 5)
    c_auto, e_auto = make_connection_fn_auto(tables)(packed[:64])
    c1, e1 = make_connection_fn(tables)(packed[:64])
    np.testing.assert_array_equal(np.asarray(c_auto), np.asarray(c1))
    np.testing.assert_allclose(np.asarray(e_auto), np.asarray(e1), atol=2e-6)


def test_keys_view_trick_matches_shift_formula():
    """Hamiltonian.keys builds (alpha<<32)|beta via a little-endian uint32
    view; must match the arithmetic formula exactly."""
    import numpy as np
    from flow_guided_krylov_tpu.hamiltonians import create_h2_hamiltonian
    h = create_h2_hamiltonian()
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 2**31, (1000, 2)).astype(np.uint32)
    got = h.keys(packed)
    want = (packed[:, 0].astype(np.uint64) << np.uint64(32)) \
        | packed[:, 1].astype(np.uint64)
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)
