"""Execution-level tests for the example CLIs (tiny fast paths).

Round-1 verdict: the six experiment scripts were smoke-tested only at
``--help`` level, so a regression in the glue (geometry -> integrals ->
scaler -> pipeline -> results keys) would ship silently.  These tests
drive each script's main entry function in-process on the smallest
possible system (H2-class molecules / 6-spin lattices), asserting on the
real result dictionaries.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def load_example(name: str):
    """Import an examples/ script as a module (they are not a package)."""
    path = EXAMPLES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_benchmark_pt2_only_h2():
    bench = load_example("benchmark")
    out = bench.pt2_only_run("h2")
    assert out["chemical_accuracy"]
    assert abs(out["error_mha"]) < 0.1
    assert out["nf_basis_size"] >= 1


def test_benchmark_quick_nf_only_h2():
    bench = load_example("benchmark")
    out = bench.benchmark_molecule("h2", quick=True, nf_only=True,
                                   verbose=False)
    assert out["chemical_accuracy"]
    assert abs(out["error_mha"]) < 0.1
    # results-dict compat contract keys
    for key in ("nf_energy", "residual_energy", "final_energy"):
        assert key in out


def test_skqd_validation_isolated_h2():
    val = load_example("skqd_validation")
    out = val.run_isolated("h2")
    assert out["experiment"] == "isolated"
    assert abs(out["nf_skqd_mha"]) < 0.1
    assert out["nf_basis_size"] >= 1


def test_skqd_necessity_h2_redundant():
    nec = load_example("skqd_necessity_test")
    out = nec.necessity_test("h2", residual_iters=2, krylov_dim=3,
                             verbose=False)
    # H2's 4-config space is fully discovered by NF+residual: the
    # reference records 0 Krylov-unique configs (REDUNDANT verdict)
    assert out["verdict"] == "REDUNDANT"
    assert out["krylov_unique_configs"] == 0
    assert abs(out["nf_residual_mha"]) < 0.1


def test_lattice_validation_heisenberg6():
    # glue-level execution on a small conserving lattice (20-state Sz=0
    # sector, SzConservingFlow path); the physics itself is covered by
    # tests/test_spin.py and the recorded validation results
    lat = load_example("skqd_lattice_validation")
    out = lat.run_three_mode_experiment("heisenberg", 6, 0.1, krylov_dim=4,
                                        shots=2000, max_epochs=25)
    assert set(out["errors_mha"]) == {"skqd", "nf", "combined"}
    assert min(out["errors_mha"].values()) < 20.0
    assert out["best"] in ("skqd", "nf", "combined")


def test_moderate_benchmark_glue_tiny():
    mod = load_example("moderate_system_benchmark")
    # inject an H2-class entry so the full glue path (integrals -> scaler
    # preset -> pipeline -> results keys) runs in seconds
    mod.GEOMETRIES["h2_test"] = ([("H", (0, 0, 0)), ("H", (0, 0, 0.74))],
                                 "sto-3g")
    out = mod.run("h2_test", "fast")
    assert out["chemical_accuracy"]
    assert abs(out["error_mha"]) < 0.1
    assert out["n_valid"] == 4


def test_large_benchmark_glue_tiny_active_space():
    large = load_example("large_system_benchmark")

    def h2o_tiny():
        from flow_guided_krylov_tpu.chem import compute_molecular_integrals
        from flow_guided_krylov_tpu.chem.active_space import \
            compute_active_space_integrals
        from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
        ang = np.radians(104.5)
        geom = [("O", (0, 0, 0)), ("H", (0.96, 0, 0)),
                ("H", (0.96 * np.cos(ang), 0.96 * np.sin(ang), 0))]
        ints = compute_molecular_integrals(geom)
        act = compute_active_space_integrals(ints, n_frozen=2, n_active=4)
        return MolecularHamiltonian(act)

    large.SYSTEMS["h2o_tiny_test"] = h2o_tiny
    out = large.run("h2o_tiny_test", "fast")
    # (6e, 4o) window: C(4,3)^2 = 16 configs, CAS energy must be recovered
    assert out["n_valid"] == 16
    assert out["chemical_accuracy"]
    assert abs(out["error_mha"]) < 0.1


def test_lattice_sci_mode_heisenberg8():
    """--sci mode (seeded deep Selected-CI on a spin sector) must reach
    near the exact sector energy on a small chain and report an
    oracle-checked error."""
    val = load_example("skqd_lattice_validation")
    out = val.run_large_spin_sci("heisenberg", 8, 0.1,
                                 iters=12, per_iter=10)
    assert out["experiment"] == "large-sci"
    assert out["sector_dim"] == 70                     # C(8,4)
    assert "error_mha" in out
    assert out["error_mha"] >= -1e-6                   # variational
    assert out["error_mha"] < 50.0
    # the exact Epstein-Nesbet correction must be reported, negative (or
    # zero at exhaustion), and move the error toward the oracle
    assert out["pt2_exact"]
    assert out["pt2_de2"] <= 1e-12
    assert abs(out["corrected_error_mha"]) <= out["error_mha"] + 1e-9


def test_lattice_sci_screened_heisenberg8():
    """--sci --sci-screen: SHCI source screening through the CLI glue
    (spin Hmax sampling included) must still converge to the oracle."""
    val = load_example("skqd_lattice_validation")
    out = val.run_large_spin_sci("heisenberg", 8, 0.1,
                                 iters=12, per_iter=10, screen=1.0)
    assert out["experiment"] == "large-sci"
    assert "error_mha" in out
    assert out["error_mha"] >= -1e-6
    assert out["error_mha"] < 50.0


def test_lattice_sci_dmrg_oracle_path():
    """Sectors above SECTOR_ORACLE_MAX_DIM switch to the independent
    DMRG oracle (the Heisenberg-28 route); forcing the threshold to 0 on
    a small chain must produce the same oracle-checked-error semantics,
    with the oracle labelled and the error still near zero."""
    val = load_example("skqd_lattice_validation")
    old = val.SECTOR_ORACLE_MAX_DIM
    val.SECTOR_ORACLE_MAX_DIM = 0
    try:
        out = val.run_large_spin_sci("heisenberg", 8, 0.1,
                                     iters=12, per_iter=10)
    finally:
        val.SECTOR_ORACLE_MAX_DIM = old
    assert out["oracle"].startswith("dmrg")
    assert out["error_mha"] >= -1e-5                   # DMRG: variational
    assert abs(out["error_mha"]) < 1.0                 # both near-exact


def test_lattice_sci_nonconserving_chain():
    """`--model heisenberg-hx` (uniform transverse field, no S_z
    conservation): SCI over the full 2^n space, oracle-checked."""
    val = load_example("skqd_lattice_validation")
    out = val.run_large_spin_sci("heisenberg-hx", 8, 0.3,
                                 iters=12, per_iter=30)
    assert out["sector_dim"] == 256                    # full 2^8
    assert out["error_mha"] >= -1e-5
    assert abs(out["error_mha"]) < 5.0


def test_lattice_sci_mode_tfim_full_space():
    """--sci on a non-conserving model: full-2^n space with the
    free-fermion/dense oracle fallback."""
    val = load_example("skqd_lattice_validation")
    out = val.run_large_spin_sci("tfim", 8, 1.0, iters=10, per_iter=30)
    assert out["sector_dim"] == 256
    assert "error_mha" in out
    assert out["error_mha"] >= -1e-6
    assert out["error_mha"] < 100.0


def test_lattice_convergence_study_tiny():
    """--study mode: errors must be finite, oracle-checked, and the
    rows must carry the requested grid."""
    val = load_example("skqd_lattice_validation")
    rows = val.run_large_convergence_study(8, 1.0,
                                           points=[(3, 500, 0.1)])
    assert len(rows) == 1
    assert rows[0]["krylov_dim"] == 3
    assert np.isfinite(rows[0]["error_mha"])
    assert rows[0]["error_mha"] >= -1e-3               # variational


def test_lattice_sci_growth_schedule():
    """--sci-growth: proportional adds reach the same sector energy with
    fewer eigensolve rounds than the fixed schedule."""
    val = load_example("skqd_lattice_validation")
    fixed = val.run_large_spin_sci("heisenberg", 10, 0.1,
                                   iters=40, per_iter=8)
    grown = val.run_large_spin_sci("heisenberg", 10, 0.1,
                                   iters=40, per_iter=8, growth=0.5)
    assert grown["error_mha"] >= -1e-6
    assert abs(grown["error_mha"] - fixed["error_mha"]) < 0.5
    assert grown["iterations"] < fixed["iterations"]


def test_lattice_exact_full_mode(tmp_path, monkeypatch):
    """--exact-full mode: exact full-2^n ED with the free-fermion and
    dense oracle cross-checks at machine precision."""
    monkeypatch.setenv("FGK_INTEGRAL_CACHE", str(tmp_path))
    val = load_example("skqd_lattice_validation")
    out = val.run_exact_fullspace("tfim", 10, 1.0)
    assert out["dim"] == 1024
    assert out["oracle"] == "free-fermion"
    assert abs(out["error_mha"]) < 1e-6
    out2 = val.run_exact_fullspace("heisenberg-hx", 10, 0.3)
    assert out2["oracle"] == "dense"
    assert abs(out2["error_mha"]) < 1e-6


def test_moderate_benchmark_ccsd_fallback():
    """FCI-infeasible branch: the CLI must report an active-space CCSD(T)
    oracle error bar instead of HF-referenced energies (the reference's
    CCSD fallback, ``moderate_system_benchmark.py:122-157``).  H2 with the
    FCI limit forced to 1 exercises the branch; CCSD==FCI there, so the
    pipeline error vs CCSD must be tiny."""
    mod = load_example("moderate_system_benchmark")
    mod.GEOMETRIES["h2_ccsd_test"] = ([("H", (0, 0, 0)),
                                       ("H", (0, 0, 0.74))], "sto-3g")
    old = mod.FCI_LIMIT
    mod.FCI_LIMIT = 1
    try:
        out = mod.run("h2_ccsd_test", "fast")
    finally:
        mod.FCI_LIMIT = old
    assert out["ccsd_converged"]
    assert "error_vs_ccsd_mha" in out
    assert abs(out["error_vs_ccsd_mha"]) < 0.1
    assert out["ccsd_t_energy"] <= out["ccsd_energy"]


def test_large_benchmark_sci_skqd_mode():
    """--mode sci+skqd: restricted-subspace SKQD glue on top of the
    Selected-CI stage (round-4 stage-4-at-the-frontier route)."""
    large = load_example("large_system_benchmark")
    if "h2o_tiny_test" not in large.SYSTEMS:
        def h2o_tiny():
            from flow_guided_krylov_tpu.chem import \
                compute_molecular_integrals
            from flow_guided_krylov_tpu.chem.active_space import \
                compute_active_space_integrals
            from flow_guided_krylov_tpu.hamiltonians import \
                MolecularHamiltonian
            ang = np.radians(104.5)
            geom = [("O", (0, 0, 0)), ("H", (0.96, 0, 0)),
                    ("H", (0.96 * np.cos(ang), 0.96 * np.sin(ang), 0))]
            ints = compute_molecular_integrals(geom)
            act = compute_active_space_integrals(ints, n_frozen=2,
                                                 n_active=4)
            return MolecularHamiltonian(act)
        large.SYSTEMS["h2o_tiny_test"] = h2o_tiny
    out = large.run("h2o_tiny_test", mode="sci+skqd", sci_iters=3,
                    sci_per_iter=4, sci_max_basis=12, krylov_dim=3,
                    shots=4000)
    assert out["skqd_restricted_dim"] >= out["basis_size"]
    assert "skqd_energy" in out and "skqd_error_mha" in out
    # stage 4 must never worsen the reported energy
    assert out["skqd_energy"] <= out["final_energy"] + 1e-9
