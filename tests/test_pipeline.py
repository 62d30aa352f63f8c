"""End-to-end pipeline integration tests (physics oracles as assertions)."""

import numpy as np
import pytest

from flow_guided_krylov_tpu.hamiltonians import create_h2_hamiltonian
from flow_guided_krylov_tpu.pipeline import (FlowGuidedKrylovPipeline,
                                             PipelineConfig,
                                             EnhancedFlowKrylovPipeline)


@pytest.fixture(scope="module")
def h2_result():
    h = create_h2_hamiltonian()
    cfg = PipelineConfig(max_epochs=80, min_epochs=30, samples_per_batch=256,
                         nqs_hidden_dims=[64, 64], nf_hidden_dims=[64, 64],
                         max_krylov_dim=3, shots_per_krylov=5000,
                         verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=h.fci_energy())
    out = pipe.run()
    return h, pipe, out


def test_h2_chemical_accuracy(h2_result):
    _, _, out = h2_result
    assert out["chemical_accuracy"], f"error {out['error_mha']} mHa"
    assert abs(out["error_mha"]) < 0.01  # reference headline: <0.01 mHa


def test_variational_principle(h2_result):
    h, _, out = h2_result
    fci = h.fci_energy()
    for key in ("nf_energy", "residual_energy", "final_energy"):
        assert out[key] >= fci - 1e-9, f"{key} below FCI"


def test_results_dict_keys(h2_result):
    _, _, out = h2_result
    for key in ("nf_nqs_energy", "nf_basis_size", "residual_energy",
                "combined_energy", "final_energy", "wall_time"):
        assert key in out


def test_stage_results_recorded(h2_result):
    _, pipe, _ = h2_result
    for stage in ("stage1", "stage2", "stage3", "stage4", "summary"):
        assert stage in pipe.results


def test_backcompat_alias():
    assert EnhancedFlowKrylovPipeline is FlowGuidedKrylovPipeline


def test_adapt_to_system_size_tiers():
    cfg = PipelineConfig(verbose=False)
    cfg.adapt_to_system_size(100)
    assert cfg.max_accumulated_basis >= 100
    cfg2 = PipelineConfig(verbose=False)
    cfg2.adapt_to_system_size(14400)
    assert cfg2.residual_iterations == 15
    assert cfg2.samples_per_batch == 4000


def test_open_shell_radical_pipeline():
    """OH radical (doublet, n_alpha != n_beta) through all four stages."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    ints = compute_molecular_integrals([("O", (0, 0, 0)),
                                        ("H", (0, 0, 0.97))], spin=1)
    h = MolecularHamiltonian(ints)
    assert h.n_alpha == 5 and h.n_beta == 4
    cfg = PipelineConfig(max_epochs=80, min_epochs=30, samples_per_batch=256,
                         nqs_hidden_dims=[64, 64], nf_hidden_dims=[64, 64],
                         max_krylov_dim=3, shots_per_krylov=5000,
                         verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=h.fci_energy())
    out = pipe.run()
    assert out["chemical_accuracy"], out["error_mha"]


def test_pipeline_resume(tmp_path):
    """run(resume=True) restores stage results from checkpoints."""
    from flow_guided_krylov_tpu.hamiltonians import create_h2_hamiltonian
    h = create_h2_hamiltonian()
    kw = dict(max_epochs=50, min_epochs=20, samples_per_batch=128,
              nqs_hidden_dims=[32, 32], nf_hidden_dims=[32, 32],
              checkpoint_dir=str(tmp_path), verbose=False,
              max_krylov_dim=2, shots_per_krylov=2000)
    p1 = FlowGuidedKrylovPipeline(h, PipelineConfig(**kw),
                                  exact_energy=h.fci_energy())
    out1 = p1.run()
    p2 = FlowGuidedKrylovPipeline(h, PipelineConfig(**kw),
                                  exact_energy=h.fci_energy())
    out2 = p2.run(resume=True)
    assert p2.results["stage1"].get("resumed") is True
    assert out2["chemical_accuracy"]
    assert abs(out1["final_energy"] - out2["final_energy"]) < 1e-8


def test_run_with_nf_final_only_matches_full_ladder():
    """final_only skips the per-k eigensolve ladder but must return the
    same final combined energy as the full ladder (same seed)."""
    from flow_guided_krylov_tpu.hamiltonians import create_lih_hamiltonian
    from flow_guided_krylov_tpu.krylov import FlowGuidedSKQD, SKQDConfig

    h = create_lih_hamiltonian()
    basis = h.enumerate_basis()
    diag = h.diagonal_np(basis)
    nf = basis[np.argsort(diag)[:40]]
    cfg = SKQDConfig(max_krylov_dim=4, shots_per_krylov=2000, seed=7)

    full = FlowGuidedSKQD(h, nf, cfg, initial_state=h.get_hf_state()) \
        .run_with_nf(final_only=False)
    fast = FlowGuidedSKQD(h, nf, cfg, initial_state=h.get_hf_state()) \
        .run_with_nf(final_only=True)

    assert len(full["combined_energies"]) == 4
    assert len(fast["combined_energies"]) == 1
    assert fast["combined_energies"][0] == pytest.approx(
        full["combined_energies"][-1], abs=1e-9)
    assert fast["nf_only_energy"] == pytest.approx(full["nf_only_energy"])


def test_residual_growth_factor_pipeline():
    """Proportional stage-3 adds (residual_growth_factor) keep the
    pipeline's chemical accuracy; growth only changes the add schedule."""
    from flow_guided_krylov_tpu.hamiltonians import create_lih_hamiltonian
    h = create_lih_hamiltonian()
    cfg = PipelineConfig(max_epochs=60, min_epochs=20, samples_per_batch=256,
                         nqs_hidden_dims=[64, 64], nf_hidden_dims=[64, 64],
                         residual_growth_factor=0.5, residual_iterations=12,
                         residual_configs_per_iter=20,
                         skip_skqd=True, verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=h.fci_energy())
    out = pipe.run()
    assert out["final_energy"] >= h.fci_energy() - 1e-9
    assert abs(out["error_mha"]) < 1.6


def test_stage4_skipped_once_stage3_converged(h2_result):
    """Stage 3 reaches H2's FCI energy, so the accuracy rules skip SKQD."""
    _, pipe, out = h2_result
    assert out["skqd_skipped"] is True
    assert "reason" in pipe.results["stage4"]


def test_force_skqd_runs_stage4():
    """force_skqd runs SKQD where the accuracy rules would skip it; the
    result stays variational and at chemical accuracy."""
    h = create_h2_hamiltonian()
    cfg = PipelineConfig(max_epochs=50, min_epochs=20, samples_per_batch=128,
                         nqs_hidden_dims=[32, 32], nf_hidden_dims=[32, 32],
                         max_krylov_dim=3, shots_per_krylov=2000,
                         force_skqd=True, verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=h.fci_energy())
    out = pipe.run()
    assert out["skqd_skipped"] is False
    assert pipe.results["stage4"]["skqd"]["krylov_energies"]
    assert out["skqd_energy"] >= h.fci_energy() - 1e-9
    assert out["chemical_accuracy"], out["error_mha"]
