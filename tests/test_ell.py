"""ELL SpMV + ELL Lanczos propagator tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from flow_guided_krylov_tpu.hamiltonians import create_lih_hamiltonian
from flow_guided_krylov_tpu.krylov import (SKQDConfig,
                                           SampleBasedKrylovDiagonalization)
from flow_guided_krylov_tpu.ops.ell import ell_spmv


def test_ell_reference_matches_dense():
    h = create_lih_hamiltonian()
    skqd = SampleBasedKrylovDiagonalization(h, SKQDConfig())
    diag, elems, tgt = skqd._ell_structure()
    H = skqd.subspace_hamiltonian.toarray()
    rng = np.random.default_rng(0)
    psi = jnp.asarray(rng.normal(size=skqd.dim).astype(np.float32))
    out = ell_spmv(diag, elems, tgt, psi)
    ref = H @ np.asarray(psi)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=2e-4, atol=2e-4)


def test_evolution_modes_agree():
    h = create_lih_hamiltonian()
    outs = {}
    for mode in ("scipy", "dense", "ell"):
        skqd = SampleBasedKrylovDiagonalization(
            h, SKQDConfig(evolution=mode, seed=2))
        psi0 = np.zeros(skqd.dim, complex)
        psi0[skqd._index_of(h.get_hf_state())[0]] = 1.0
        outs[mode] = skqd.evolve(psi0)
    assert np.abs(outs["dense"] - outs["scipy"]).max() < 1e-5
    assert np.abs(outs["ell"] - outs["scipy"]).max() < 1e-5


@pytest.mark.parametrize("n,c", [(1, 1), (7, 3), (1000, 5), (1023, 24)])
def test_ell_spmv_matches_dense_random(n, c):
    """Random (C, N) tables at odd and non-power-of-two N: the matvec is
    the dense product of the matrix the tables describe (repeated targets
    accumulate)."""
    rng = np.random.default_rng(n + c)
    diag = rng.normal(size=n).astype(np.float32)
    elems = rng.normal(size=(c, n)).astype(np.float32)
    tgt = rng.integers(0, n, size=(c, n)).astype(np.int32)
    psi = rng.normal(size=n).astype(np.float32)
    H = np.diag(diag.astype(np.float64))
    for k in range(c):
        np.add.at(H, (np.arange(n), tgt[k]), elems[k])
    out = ell_spmv(jnp.asarray(diag), jnp.asarray(elems), jnp.asarray(tgt),
                   jnp.asarray(psi))
    np.testing.assert_allclose(np.asarray(out), H @ psi, rtol=1e-5,
                               atol=1e-5)


def test_device_evolution_errors_propagate(monkeypatch):
    """A failing device propagator raises; it is not replaced by the host
    path."""
    h = create_lih_hamiltonian()
    for mode, attr in (("ell", "_evolve_device_ell"),
                       ("dense", "_evolve_device")):
        skqd = SampleBasedKrylovDiagonalization(h, SKQDConfig(evolution=mode))

        def boom(psi):
            raise RuntimeError("device failure")

        monkeypatch.setattr(skqd, attr, boom)
        psi0 = np.zeros(skqd.dim, complex)
        psi0[0] = 1.0
        with pytest.raises(RuntimeError, match="device failure"):
            skqd.evolve(psi0)
