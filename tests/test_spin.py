"""Spin Hamiltonian tests vs independent Pauli-word oracle + SKQD physics."""

import numpy as np
import pytest

from flow_guided_krylov_tpu.hamiltonians.base import PauliString
from flow_guided_krylov_tpu.hamiltonians.spin import (HeisenbergHamiltonian,
                                                      TransverseFieldIsing,
                                                      extract_coeffs_and_paulis)


def dense_from_paulis(coeffs, words, n):
    dim = 1 << n
    H = np.zeros((dim, dim), complex)
    for c, w in zip(coeffs, words):
        p = PauliString(w, c)
        for x in range(dim):
            y, ph = p.apply(x)
            H[y, x] += ph
    assert np.abs(H.imag).max() < 1e-12
    return H.real


@pytest.mark.parametrize("ham", [
    TransverseFieldIsing(6, V=1.0, h=0.7),
    TransverseFieldIsing(5, V=0.5, h=1.3, L=2, periodic=True),
    HeisenbergHamiltonian(5, 1.0, 1.0, 0.8,
                          h_x=0.3 * np.ones(5), h_z=0.2 * np.ones(5)),
    HeisenbergHamiltonian(4, 1.0, 1.0, 1.0, periodic=True),
])
def test_matrix_elements_vs_pauli_oracle(ham):
    n = ham.n_sites
    coeffs, words = extract_coeffs_and_paulis(ham)
    Hp = dense_from_paulis(coeffs, words, n)
    states = np.arange(1 << n, dtype=np.uint32)[:, None]
    Hk = ham.matrix_elements(states, states)
    np.testing.assert_allclose(Hk, Hp, atol=1e-12)


def test_tfim_skqd_reaches_ground_state():
    """Pure SKQD from |0...0> on TFIM-8; mirrors the reference's lattice
    validation (~sub-mHa at h=0.5, SKQD_VALIDATION_REPORT.md:45-54)."""
    from flow_guided_krylov_tpu.krylov import (SKQDConfig,
                                               SampleBasedKrylovDiagonalization)
    tfim = TransverseFieldIsing(8, V=1.0, h=0.5)
    e_exact = np.linalg.eigh(tfim.exact_dense())[0][0]
    skqd = SampleBasedKrylovDiagonalization(
        tfim, SKQDConfig(max_krylov_dim=10, shots_per_krylov=20000,
                         time_step=0.1, seed=1),
        initial_state=np.array([0], np.uint32))
    out = skqd.run()
    err_mha = 1000 * (out["final_energy"] - e_exact)
    assert err_mha >= -1e-6, "variational violation"
    assert err_mha < 1.6, f"TFIM SKQD error {err_mha} mHa"


def test_heisenberg_ground_state_sector():
    """XXZ without field conserves magnetization; check exact ground state
    matches dense diagonalization restricted to the half-filling sector."""
    ham = HeisenbergHamiltonian(6, 1.0, 1.0, 1.0, periodic=False)
    H = ham.exact_dense()
    e_full = np.linalg.eigh(H)[0][0]
    states = np.arange(1 << 6, dtype=np.uint32)
    half = states[[bin(s).count("1") == 3 for s in states]][:, None]
    e_half = ham.exact_ground_state(half)[0][0]
    assert e_half == pytest.approx(e_full, abs=1e-10)


def _exact_evolved(ham, psi0, t):
    import scipy.linalg
    H = ham.exact_dense()
    return scipy.linalg.expm(-1j * t * H) @ psi0


@pytest.mark.parametrize("ham,start", [
    (TransverseFieldIsing(8, V=1.0, h=0.8), 0),
    (HeisenbergHamiltonian(7, 1.0, 1.0, 0.9, h_z=0.1 * np.ones(7)),
     sum(1 << i for i in range(0, 7, 2))),
])
def test_trotter_statevector_matches_exact_propagator(ham, start):
    """The statevector Trotter substep (diag-phase + Pauli rotations)
    converges to exp(-i dt H)|psi> as substeps grow."""
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    dt = 0.1
    skqd = SampleBasedKrylovDiagonalization(
        ham, SKQDConfig(time_step=dt, num_trotter_steps=16,
                        evolution="trotter"),
        initial_state=np.array([start], np.uint32))
    assert skqd.use_trotter and skqd.subspace is None
    import jax.numpy as jnp
    re = jnp.zeros(skqd.dim, jnp.float32).at[start].set(1.0)
    im = jnp.zeros(skqd.dim, jnp.float32)
    re, im = skqd._evolve_trotter(re, im)
    psi = np.asarray(re).astype(complex) + 1j * np.asarray(im)

    psi0 = np.zeros(skqd.dim, complex)
    psi0[start] = 1.0
    psi_exact = _exact_evolved(ham, psi0, dt)
    fidelity = abs(np.vdot(psi_exact, psi / np.linalg.norm(psi)))
    assert fidelity > 0.9999, f"Trotter fidelity {fidelity}"


def test_trotter_skqd_matches_subspace_skqd():
    """SKQD through the statevector Trotter path reaches the same ground
    state as the subspace propagator (TFIM-10, h=0.5)."""
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    tfim = TransverseFieldIsing(10, V=1.0, h=0.5)
    e_exact = np.linalg.eigh(tfim.exact_dense())[0][0]
    skqd = SampleBasedKrylovDiagonalization(
        tfim, SKQDConfig(max_krylov_dim=10, shots_per_krylov=20000,
                         time_step=0.1, seed=3, evolution="trotter"),
        initial_state=np.array([0], np.uint32))
    assert skqd.use_trotter
    out = skqd.run()
    err_mha = 1000 * (out["final_energy"] - e_exact)
    assert err_mha >= -1e-6, "variational violation"
    assert err_mha < 1.6, f"Trotter SKQD error {err_mha} mHa"


def test_trotter_auto_routing_threshold():
    """evolution='auto' picks the statevector path above the threshold and
    the subspace path below it."""
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    small = SampleBasedKrylovDiagonalization(
        TransverseFieldIsing(8, V=1.0, h=0.5), SKQDConfig())
    assert not small.use_trotter and small.subspace is not None
    big = SampleBasedKrylovDiagonalization(
        TransverseFieldIsing(18, V=1.0, h=0.5),
        SKQDConfig(trotter_threshold=17))
    assert big.use_trotter and big.subspace is None
    assert big.dim == 1 << 18


def test_magnetization_sector_skqd():
    """Conserving XXZ systems restrict SKQD to the fixed-popcount sector
    (spin analog of the molecular particle-conserving subspace)."""
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    h = HeisenbergHamiltonian(8, 1.0, 1.0, 1.0,
                              h_z=np.array([0.1] + [0.0] * 7))
    assert h.conserves_magnetization
    skqd = SampleBasedKrylovDiagonalization(
        h, SKQDConfig(max_krylov_dim=8, shots_per_krylov=20000, seed=1))
    assert skqd.dim == 70                      # C(8,4), not 256
    e_exact = np.linalg.eigh(h.exact_dense())[0][0]
    out = skqd.run()
    err = 1000 * (out["final_energy"] - e_exact)
    assert err >= -1e-6
    # all sampled configs stay in-sector
    for b in out["bases"]:
        pops = [bin(int(s)).count("1") for s in b[:, 0]]
        assert set(pops) == {4}

    # a transverse field breaks conservation -> full space
    hx = HeisenbergHamiltonian(8, 1.0, 1.0, 1.0,
                               h_x=np.full(8, 0.3))
    assert not hx.conserves_magnetization
    full = SampleBasedKrylovDiagonalization(hx, SKQDConfig())
    assert full.dim == 256


def test_sz_conserving_flow_pipeline():
    """Pipeline picks the SzConservingFlow for conserving spin systems and
    solves Heisenberg-8 to the exact sector ground state."""
    from flow_guided_krylov_tpu.flows import SzConservingFlow
    from flow_guided_krylov_tpu.pipeline import (FlowGuidedKrylovPipeline,
                                                 PipelineConfig)
    h = HeisenbergHamiltonian(8, 1.0, 1.0, 1.0,
                              h_z=np.array([0.1] + [0.0] * 7))
    e_exact = np.linalg.eigh(h.exact_dense())[0][0]
    cfg = PipelineConfig(max_epochs=60, min_epochs=20,
                         samples_per_batch=512,
                         nqs_hidden_dims=[128, 128], skip_skqd=True,
                         use_residual_expansion=False, verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=e_exact)
    assert isinstance(pipe.flow, SzConservingFlow)
    assert pipe.n_valid == 70
    out = pipe.run()
    assert abs(out["final_energy"] - e_exact) < 1.6e-3


def test_large_sector_ell_evolution():
    """A conserved sector too big to enumerate under the Trotter-threshold
    gate (Heisenberg-20: C(20,10)=184,756 > 2^17) stays on the subspace
    path when its ELL table fits the HBM budget, and evolves on device."""
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    h = HeisenbergHamiltonian(20, 1.0, 1.0, 1.0,
                              h_z=np.array([0.1] + [0.0] * 19))
    skqd = SampleBasedKrylovDiagonalization(
        h, SKQDConfig(max_krylov_dim=3, shots_per_krylov=2000,
                      lanczos_dim=10, seed=0))
    assert not skqd.use_trotter
    assert skqd.dim == 184756
    out = skqd.run()
    # sampled configs stay in the popcount-10 sector
    for b in out["bases"]:
        assert {bin(int(s)).count("1") for s in b[:, 0]} == {10}
    assert np.isfinite(out["final_energy"])


def test_xor_permute_all_mask_classes():
    """psi[k ^ mask] via lane permutation (bits 0-6) + strided flips
    (bits 7+) must match direct indexing for every mask class."""
    from flow_guided_krylov_tpu.krylov.basis_sampler import _xor_permute
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    n = 10
    dim = 1 << n
    psi = rng.normal(size=dim).astype(np.float32)
    for mask in (1, 2, 64, 127, 128, 129, 512 | 3, dim - 1):
        out = np.asarray(_xor_permute(jnp.asarray(psi), mask, n))
        assert np.array_equal(out, psi[np.arange(dim) ^ mask]), mask


def test_unsupported_spin_terms_raise():
    """Anisotropic XY and h_y fields diverge from the connection kernels
    (ADVICE round 2): they must be rejected at construction."""
    with pytest.raises(NotImplementedError):
        HeisenbergHamiltonian(4, Jx=1.0, Jy=0.5, Jz=1.0)
    with pytest.raises(NotImplementedError):
        HeisenbergHamiltonian(4, h_y=0.3 * np.ones(4))


def test_sample_idx_cdf_skips_zero_probability_plateaus():
    """side='right' searchsorted: zero-probability entries (cdf plateaus)
    must never be selected, even for draws landing exactly on a boundary."""
    import jax
    import jax.numpy as jnp
    from flow_guided_krylov_tpu.krylov.skqd import _sample_idx_cdf
    prob = jnp.asarray([0.0, 0.5, 0.0, 0.5, 0.0], jnp.float32)
    idx = np.asarray(_sample_idx_cdf(jax.random.PRNGKey(0), prob, 4096))
    assert set(np.unique(idx)) <= {1, 3}


def test_exact_subspace_energy_matches_direct_diagonalization():
    """Sector oracle (device ELL Lanczos + host f64 refinement) must match
    a direct sector diagonalization."""
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    h = HeisenbergHamiltonian(10, 1.0, 1.0, 1.0,
                              h_z=np.array([0.1] + [0.0] * 9))
    neel = sum(1 << i for i in range(0, 10, 2))
    skqd = SampleBasedKrylovDiagonalization(
        h, SKQDConfig(), initial_state=np.array([neel], np.uint32))
    assert skqd.dim == 252                       # C(10,5) sector
    e_oracle = skqd.exact_subspace_energy()
    e_direct = float(h.exact_ground_state(skqd.subspace, k=1)[0][0])
    assert abs(e_oracle - e_direct) < 1e-8
    # the f32 device-only pass is already close
    e_dev = skqd.exact_subspace_energy(refine_host=False)
    assert abs(e_dev - e_direct) < 1e-3

def test_exact_subspace_energy_disk_cache(tmp_path, monkeypatch):
    """The sector-oracle energy is disk-cached (the Heisenberg-24 refine
    costs ~17 min); the cached read must round-trip exactly and be keyed
    by the Hamiltonian content."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    h = HeisenbergHamiltonian(8, 1.0, 1.0, 1.0,
                              h_z=np.array([0.1] + [0.0] * 7))
    neel = sum(1 << i for i in range(0, 8, 2))
    skqd = SampleBasedKrylovDiagonalization(
        h, SKQDConfig(), initial_state=np.array([neel], np.uint32))
    e1 = skqd.exact_subspace_energy()
    path = skqd._oracle_cache_path()
    assert path.exists()
    assert skqd.exact_subspace_energy() == e1      # cache hit round-trips
    # a different Hamiltonian keys a different file
    h2 = HeisenbergHamiltonian(8, 1.0, 1.0, 0.5,
                               h_z=np.array([0.1] + [0.0] * 7))
    skqd2 = SampleBasedKrylovDiagonalization(
        h2, SKQDConfig(), initial_state=np.array([neel], np.uint32))
    assert skqd2._oracle_cache_path() != path


def test_exact_subspace_energy_raises_on_device_error(tmp_path,
                                                     monkeypatch):
    """A device failure in the oracle's Lanczos stage raises, in both the
    refined and the device-only mode: the host refine never runs
    unseeded in its place."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    h = HeisenbergHamiltonian(10, 1.0, 1.0, 1.0,
                              h_z=np.array([0.1] + [0.0] * 9))
    neel = sum(1 << i for i in range(0, 10, 2))
    for refine_host in (True, False):
        skqd = SampleBasedKrylovDiagonalization(
            h, SKQDConfig(), initial_state=np.array([neel], np.uint32))
        monkeypatch.setattr(
            skqd, "_ell_structure",
            lambda: (_ for _ in ()).throw(RuntimeError("device failure")))
        with pytest.raises(RuntimeError, match="device failure"):
            skqd.exact_subspace_energy(refine_host=refine_host)


# ---------------------------------------------------------------------------
# Host f64 statevector matvec + full-space exact ground state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ham", [
    TransverseFieldIsing(8, V=1.0, h=1.0),
    TransverseFieldIsing(7, V=0.5, h=1.3, L=2, periodic=True),
    HeisenbergHamiltonian(8, 1.0, 1.0, 0.8,
                          h_x=0.3 * np.ones(8), h_z=0.1 * np.ones(8)),
    HeisenbergHamiltonian(7, 1.0, 1.0, 1.0, periodic=True),
    HeisenbergHamiltonian(6, 1.0, 1.0, 1.0,
                          h_z=0.1 * np.ones(6)),
])
def test_apply_statevector_matches_dense(ham):
    """The slab-reshape host matvec IS the Hamiltonian: H @ v must match
    the dense matrix-elements formulation on random vectors."""
    H = ham.exact_dense()
    rng = np.random.default_rng(3)
    for _ in range(3):
        v = rng.standard_normal(H.shape[0])
        np.testing.assert_allclose(ham.apply_statevector_np(v), H @ v,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ham", [
    TransverseFieldIsing(10, V=1.0, h=1.0),
    HeisenbergHamiltonian(9, 1.0, 1.0, 1.0,
                          h_x=0.3 * np.ones(9), h_z=0.1 * np.ones(9)),
])
def test_exact_fullspace_ground_state(ham, tmp_path, monkeypatch):
    """Device identity-ELL Lanczos + host f64 refine lands on the dense
    eigenvalue over the full 2^n space (no conserved sector)."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    from flow_guided_krylov_tpu.postprocessing import \
        exact_fullspace_ground_state
    e_ref = float(np.linalg.eigvalsh(ham.exact_dense())[0])
    res = exact_fullspace_ground_state(ham, m=60, verbose=False)
    assert not res["cached"]
    assert abs(res["energy"] - e_ref) < 1e-8
    # the f32 device stage alone is already close
    assert abs(res["e_device"] - e_ref) < 1e-3
    # second call hits the disk cache
    res2 = exact_fullspace_ground_state(ham, m=60, verbose=False)
    assert res2["cached"] and abs(res2["energy"] - e_ref) < 1e-8


def test_exact_fullspace_hbm_gate():
    """Spaces beyond BOTH the ELL-table and the table-free flip-route
    budgets are refused (n=31: six f32 2^31-vectors alone are 48 GiB)."""
    from flow_guided_krylov_tpu.postprocessing import \
        exact_fullspace_ground_state
    ham = TransverseFieldIsing(31, V=1.0, h=1.0)
    with pytest.raises(MemoryError):
        exact_fullspace_ground_state(ham, refine_host=False, use_cache=False)


def test_exact_fullspace_raises_on_device_error(tmp_path, monkeypatch):
    """A device failure in the full-space Lanczos raises instead of
    degrading to an unseeded host solve."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    from flow_guided_krylov_tpu.postprocessing import eigensolver as es
    ham = TransverseFieldIsing(9, V=1.0, h=1.0)

    def boom(*a, **k):
        raise RuntimeError("device failure")

    monkeypatch.setattr(es, "lanczos_ground_state_ell", boom)
    with pytest.raises(RuntimeError, match="device failure"):
        es.exact_fullspace_ground_state(ham, verbose=False, use_cache=False)


def test_device_fullspace_ell_build_matches_host():
    """The on-device identity-ELL build == host connections_np assembly."""
    from flow_guided_krylov_tpu.postprocessing.eigensolver import \
        _build_fullspace_ell_device
    ham = HeisenbergHamiltonian(8, 1.0, 1.0, 0.7,
                                h_x=0.3 * np.ones(8), h_z=0.1 * np.ones(8))
    d, e, t = (np.asarray(x) for x in _build_fullspace_ell_device(ham))
    states = np.arange(256, dtype=np.uint32)[:, None]
    conn, el = ham.connections_np(states)
    np.testing.assert_allclose(d, ham.diagonal_np(states), atol=1e-6)
    np.testing.assert_allclose(e, el.T, atol=1e-6)
    np.testing.assert_array_equal(t, conn[..., 0].T.astype(np.int32))


def test_streamed_ell_lanczos_matches_dense():
    """Host-block streamed Lanczos over the device matvec finds the
    ground state (f32 grade) of a full-space spin H."""
    from flow_guided_krylov_tpu.postprocessing.eigensolver import (
        _build_fullspace_ell_device, lanczos_ground_state_ell_streamed)
    ham = TransverseFieldIsing(10, V=1.0, h=1.0)
    e_ref = float(np.linalg.eigvalsh(ham.exact_dense())[0])
    diag, elems, tgt = _build_fullspace_ell_device(ham)
    e, v = lanczos_ground_state_ell_streamed(diag, elems, tgt, m=40,
                                             restarts=3)
    assert abs(e - e_ref) < 1e-3
    assert abs(np.linalg.norm(v) - 1.0) < 1e-5


def test_sector_states_at_the_31_spin_boundary():
    """n=31 puts states up to bit 30 (uint32's last value bit): the Pascal
    recursion must neither overflow nor lose sortedness there."""
    from math import comb

    from flow_guided_krylov_tpu.krylov.skqd import _sector_states
    for k in (1, 2, 29, 30):
        s = _sector_states(31, k)
        assert s.dtype == np.uint32
        assert len(s) == comb(31, k)
        assert (np.diff(s.astype(np.int64)) > 0).all()
        pop = np.array([bin(int(x)).count("1") for x in s])
        assert (pop == k).all()
    # bit 30 actually appears
    assert int(_sector_states(31, 1)[-1]) == 1 << 30


def test_connection_kernel_at_bit30_vs_pauli_oracle():
    """Heisenberg-31 edge (29,30) exercises the top uint32 value bit; pin
    the packed kernels against the PauliString oracle on a handful of
    states without materializing anything 2^31-sized."""
    n = 31
    hz = np.zeros(n)
    hz[0] = 0.1
    ham = HeisenbergHamiltonian(n, 1.0, 1.0, 1.0, h_z=hz)
    coeffs, words = extract_coeffs_and_paulis(ham)
    paulis = [PauliString(w, c) for c, w in zip(coeffs, words)]

    neel = sum(1 << i for i in range(0, n, 2))        # bits 0,2,...,30
    kets = [neel, neel ^ (1 << 30), neel ^ (1 << 30) ^ (1 << 29),
            (1 << 31) - 1 - neel]
    for x in kets:
        # oracle: accumulate <y|H|x> per connected y via Pauli application
        row = {}
        for p in paulis:
            y, ph = p.apply(x)
            row[y] = row.get(y, 0.0) + ph
        conn, el = ham.connections_np(np.array([[x]], np.uint32))
        got = {}
        for y, v in zip(conn[0, :, 0].tolist(), el[0].tolist()):
            if v != 0.0 or y == x:
                got[y] = got.get(y, 0.0) + v
        got[x] = got.get(x, 0.0) + float(
            ham.diagonal_np(np.array([[x]], np.uint32))[0])
        for y, v in row.items():
            assert abs(complex(v).imag) < 1e-12
            assert abs(got.get(y, 0.0) - complex(v).real) < 1e-10, (
                f"state {x:#x} -> {y:#x}")
        for y, v in got.items():
            if abs(v) > 1e-12:
                assert y in row, f"spurious connection {x:#x} -> {y:#x}"


@pytest.mark.parametrize("ham", [
    TransverseFieldIsing(8, V=1.0, h=0.9),
    TransverseFieldIsing(6, V=0.7, h=1.2, L=2, periodic=True),
    HeisenbergHamiltonian(7, 1.0, 1.0, 0.8, h_x=0.3 * np.ones(7),
                          h_z=0.15 * np.ones(7)),
    HeisenbergHamiltonian(6, 1.0, 1.0, 1.0, periodic=True),
])
def test_apply_statevector_jax_matches_dense(ham):
    """The table-free device flip matvec (slab-reshape stencils) is a
    third, independent formulation of H — pin it to the dense oracle."""
    import jax.numpy as jnp

    from flow_guided_krylov_tpu.postprocessing.eigensolver import \
        full_diagonal_device
    n = ham.n_sites
    H = ham.exact_dense()
    rng = np.random.default_rng(3)
    v = rng.standard_normal(1 << n).astype(np.float32)
    diag = full_diagonal_device(ham)
    np.testing.assert_allclose(np.asarray(diag), np.diag(H), atol=1e-5)
    got = np.asarray(ham.apply_statevector_jax(jnp.asarray(v), diag))
    np.testing.assert_allclose(got, H @ v, atol=1e-4)


def test_lanczos_stepped_finds_ground_state():
    """Blockless device-resident Lanczos (two-pass, no reorthogonalization)
    converges to the extremal eigenvalue through restarts."""
    import jax.numpy as jnp

    from flow_guided_krylov_tpu.postprocessing.eigensolver import (
        full_diagonal_device, lanczos_ground_state_stepped)
    ham = TransverseFieldIsing(10, V=1.0, h=1.0)
    e_ref = float(np.linalg.eigvalsh(ham.exact_dense())[0])
    diag = full_diagonal_device(ham)
    # diag threads through mv_args — the production calling convention
    # (closure capture embeds it as a remote-compile constant; HTTP 413)
    e, v = lanczos_ground_state_stepped(ham.apply_statevector_jax, 1 << 10,
                                        m=30, restarts=5, mv_args=(diag,))
    assert abs(e - e_ref) < 1e-3
    assert abs(np.linalg.norm(v) - 1.0) < 1e-5
    # the returned Ritz vector is consistent with its energy
    rq = float(v @ np.asarray(
        ham.apply_statevector_jax(jnp.asarray(v, jnp.float32), diag)))
    assert abs(rq - e) < 1e-3


def test_exact_fullspace_routes_to_flip_when_tables_do_not_fit(
        tmp_path, monkeypatch):
    """When the identity-ELL tables exceed HBM but the vectors fit, the
    full-space solve takes the table-free flip route and still lands on
    the dense eigenvalue (f64 host refine)."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    from flow_guided_krylov_tpu.utils import memory as mem
    monkeypatch.setattr(mem, "device_memory_bytes", lambda *a, **k: 1_200_000_000)
    from flow_guided_krylov_tpu.postprocessing import eigensolver as es
    ham = TransverseFieldIsing(10, V=1.0, h=1.0)
    e_ref = float(np.linalg.eigvalsh(ham.exact_dense())[0])
    res = es.exact_fullspace_ground_state(ham, m=60, verbose=False,
                                          use_cache=False)
    assert res["route"] == "flip-stepped"
    assert abs(res["e_device"] - e_ref) < 1e-3
    assert abs(res["energy"] - e_ref) < 1e-8


@pytest.mark.parametrize("ham", [
    TransverseFieldIsing(16, V=1.0, h=1.0),
    HeisenbergHamiltonian(16, 1.0, 1.0, 0.9, h_x=0.25 * np.ones(16),
                          h_z=0.1 * np.ones(16)),
])
def test_apply_statevector_jax_layout_path_matches_host(ham):
    """The device statevector matvec at n > 14 against the host f64 slab
    formulation."""
    import jax.numpy as jnp

    from flow_guided_krylov_tpu.postprocessing.eigensolver import \
        full_diagonal_device
    n = ham.n_sites
    rng = np.random.default_rng(5)
    v = rng.standard_normal(1 << n).astype(np.float32)
    want = ham.apply_statevector_np(v)
    diag = full_diagonal_device(ham)
    got = np.asarray(ham.apply_statevector_jax(jnp.asarray(v), diag))
    np.testing.assert_allclose(got, want, atol=5e-4)


@pytest.mark.parametrize("bits", [(0,), (3,), (6,), (7,), (15,), (2, 9),
                                  (0, 6), (8, 15)])
def test_device_flips_match_host_slab_reference(bits):
    """Device spin flips of a 2^16 vector, for low (< 7) and high bits and
    bit pairs, equal the host slab-reverse reference exactly: a
    permutation moves values without rounding them."""
    import jax.numpy as jnp

    from flow_guided_krylov_tpu.hamiltonians.spin import (_flip1, _flip1_jax,
                                                          _flip2_anti,
                                                          _flip2_anti_jax)
    n = 16
    v = np.random.default_rng(sum(bits)).standard_normal(1 << n
                                                         ).astype(np.float32)
    if len(bits) == 1:
        want = _flip1(v, bits[0], n)
        got = _flip1_jax(jnp.asarray(v), bits[0], n)
    else:
        want = _flip2_anti(v, *bits, n)
        got = _flip2_anti_jax(jnp.asarray(v), *bits, n)
    np.testing.assert_array_equal(np.asarray(got), want)
