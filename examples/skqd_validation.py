#!/usr/bin/env python
"""SKQD validation experiments.

Counterpart of ``/root/reference/examples/skqd_validation.py`` (6 modes):

  isolated    — NF-only vs NF+SKQD with residual expansion disabled
  provenance  — which configs NF finds vs Krylov finds vs both
  stretched   — stretched-geometry H2O / N2 (strong correlation)
  stretched-full — stretched geometry through the FULL pipeline (PT2 incl.)
  poor-init   — deliberately under-trained NF (few epochs), SKQD rescues
  631g        — larger 6-31G basis (H2O active window)
  headtohead  — Krylov expansion vs PT2 residual expansion from the same NF basis

Usage: python examples/skqd_validation.py --experiment isolated --molecule lih
"""

import os
import sys

# keep the CLI runnable when the editable install is absent (env resets)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def build(molecule: str, stretch: float = 1.0, basis: str = "sto-3g"):
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    geoms = {
        "h2": [("H", (0, 0, 0)), ("H", (0, 0, 0.74 * stretch))],
        "lih": [("Li", (0, 0, 0)), ("H", (0, 0, 1.6 * stretch))],
        "h2o": None, "n2": [("N", (0, 0, 0)), ("N", (0, 0, 1.10 * stretch))],
    }
    if molecule == "h2o":
        ang = np.radians(104.5)
        r = 0.96 * stretch
        geom = [("O", (0, 0, 0)), ("H", (r, 0, 0)),
                ("H", (r * np.cos(ang), r * np.sin(ang), 0))]
    else:
        geom = geoms[molecule]
    ints = compute_molecular_integrals(geom, basis=basis)
    return MolecularHamiltonian(ints)


def train_nf(h, epochs: int = 150, samples: int = 1024, seed: int = 0):
    """Stage 1+2: train the flow, return the diverse NF basis."""
    from flow_guided_krylov_tpu.pipeline import (FlowGuidedKrylovPipeline,
                                                 PipelineConfig)
    cfg = PipelineConfig(max_epochs=epochs, min_epochs=min(50, epochs // 2),
                         samples_per_batch=samples,
                         nqs_hidden_dims=[256, 256, 256],
                         nf_hidden_dims=[128, 128], seed=seed, verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=None)
    pipe.train_flow_nqs()
    pipe.extract_and_select_basis()
    return pipe


def run_isolated(molecule: str):
    """NF-only vs NF+SKQD (no residual expansion in between)."""
    from flow_guided_krylov_tpu.krylov import FlowGuidedSKQD, SKQDConfig
    h = build(molecule)
    exact = h.fci_energy()
    pipe = train_nf(h)
    nf_basis = pipe.nf_basis
    skqd = FlowGuidedSKQD(h, nf_basis,
                          SKQDConfig(max_krylov_dim=8, shots_per_krylov=50000))
    out = skqd.run_with_nf()
    res = {
        "experiment": "isolated", "molecule": molecule,
        "nf_only_mha": 1000 * (out["nf_only_energy"] - exact),
        "nf_skqd_mha": 1000 * (out["best_stable_energy"] - exact),
        "nf_basis_size": out["nf_basis_size"],
        "combined_size": out["combined_sizes"][-1],
    }
    print(json.dumps(res))
    return res


def run_provenance(molecule: str):
    """Config-set algebra: NF-only / Krylov-only / both."""
    from flow_guided_krylov_tpu.krylov import (SKQDConfig,
                                               SampleBasedKrylovDiagonalization)
    from flow_guided_krylov_tpu.postprocessing import basis_overlap
    h = build(molecule)
    exact = h.fci_energy()
    pipe = train_nf(h)
    nf_basis = pipe.nf_basis
    skqd = SampleBasedKrylovDiagonalization(
        h, SKQDConfig(max_krylov_dim=8, shots_per_krylov=50000))
    k_out = skqd.run()
    k_basis = k_out["bases"][-1]
    from flow_guided_krylov_tpu.postprocessing import merge_bases
    combined = merge_bases(nf_basis, k_basis)
    overlap = basis_overlap(nf_basis, k_basis, keys_fn=h.keys)
    res = {
        "experiment": "provenance", "molecule": molecule,
        "nf_configs": int(len(nf_basis)),
        "krylov_configs": int(len(k_basis)),
        "combined_configs": int(len(combined)),
        "overlap": overlap,
        "nf_mha": 1000 * (skqd.compute_ground_state_energy(nf_basis) - exact),
        "krylov_mha": 1000 * (k_out["final_energy"] - exact),
        "combined_mha": 1000 * (
            skqd.compute_ground_state_energy(combined) - exact),
    }
    print(json.dumps(res))
    return res


def run_stretched(molecule: str, stretch: float = 1.5):
    """Stretched geometries — strong correlation stress test."""
    from flow_guided_krylov_tpu.krylov import FlowGuidedSKQD, SKQDConfig
    h = build(molecule, stretch=stretch)
    exact = h.fci_energy()
    pipe = train_nf(h, epochs=200)
    skqd = FlowGuidedSKQD(h, pipe.nf_basis,
                          SKQDConfig(max_krylov_dim=8, shots_per_krylov=50000))
    out = skqd.run_with_nf()
    res = {
        "experiment": "stretched", "molecule": molecule, "stretch": stretch,
        "nf_only_mha": 1000 * (out["nf_only_energy"] - exact),
        "nf_skqd_mha": 1000 * (out["best_stable_energy"] - exact),
    }
    print(json.dumps(res))
    return res


def run_stretched_full(molecule: str, stretch: float = 1.5):
    """Stretched geometry through the FULL pipeline (PT2 included).

    The plain ``stretched`` mode mirrors the reference experiment
    (NF + SKQD only, ``skqd_validation.py:279-307``); this mode runs all
    four stages so residual expansion closes the remaining gap — the
    headline stretched-system number."""
    from flow_guided_krylov_tpu.pipeline import (FlowGuidedKrylovPipeline,
                                                 PipelineConfig)
    h = build(molecule, stretch=stretch)
    exact = h.fci_energy()
    cfg = PipelineConfig(max_epochs=250, min_epochs=80,
                         samples_per_batch=2000,
                         nqs_hidden_dims=[256, 256, 256],
                         nf_hidden_dims=[128, 128],
                         residual_iterations=25,
                         residual_configs_per_iter=300,
                         max_accumulated_basis=16384, verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=exact)
    out = pipe.run()
    res = {
        "experiment": "stretched-full", "molecule": molecule,
        "stretch": stretch,
        "nf_mha": 1000 * (out["nf_energy"] - exact),
        "residual_mha": 1000 * (out["residual_energy"] - exact),
        "final_mha": 1000 * (out["final_energy"] - exact),
        "chemical_accuracy": bool(abs(out["final_energy"] - exact)
                                  < 1.6e-3),
    }
    print(json.dumps(res))
    return res


def run_poor_init(molecule: str):
    """Under-trained NF (degradation test) — SKQD must rescue.

    The jitted trainer discovers small spaces completely even in a few
    epochs, so to reproduce the reference's poor-NF scenario (131 of 225
    LiH configs) the NF basis is additionally truncated to the highest-
    weight ~55% of configurations."""
    import numpy as np
    from flow_guided_krylov_tpu.krylov import FlowGuidedSKQD, SKQDConfig
    h = build(molecule)
    exact = h.fci_energy()
    pipe = train_nf(h, epochs=30, samples=256)      # deliberately short
    basis = pipe.nf_basis
    keep = max(10, int(0.55 * len(basis)))
    if len(basis) > keep:
        diag = h.diagonal_np(basis)
        order = np.argsort(diag)[:keep]             # lowest-diagonal subset
        basis = basis[np.sort(order)]
    skqd = FlowGuidedSKQD(h, basis,
                          SKQDConfig(max_krylov_dim=10,
                                     shots_per_krylov=50000))
    out = skqd.run_with_nf()
    res = {
        "experiment": "poor-init", "molecule": molecule,
        "nf_only_mha": 1000 * (out["nf_only_energy"] - exact),
        "nf_skqd_mha": 1000 * (out["best_stable_energy"] - exact),
        "nf_basis_size": out["nf_basis_size"],
    }
    print(json.dumps(res))
    return res


def run_631g(molecule: str = "lih"):
    """Larger-basis (6-31G) validation.

    ``lih`` (default): LiH/6-31G at 1.6 A — 11 orbitals, 3,025 valid
    configs, the reference's regression target
    (``skqd_validation.py:523-531``; baseline NF 2.9661 / NF+SKQD 0.7081 /
    NF+residual 0.0000 mHa).  ``h2o``: H2O/6-31G in a (10o, 8e)
    frozen-core window -> 44,100 configs (extra coverage)."""
    import numpy as np
    from flow_guided_krylov_tpu.chem import (compute_active_space_integrals,
                                             compute_molecular_integrals)
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    from flow_guided_krylov_tpu.krylov import (FlowGuidedSKQD, SKQDConfig,
                                               iterative_residual_expansion)
    if molecule == "h2o":
        ang = np.radians(104.5)
        geom = [("O", (0, 0, 0)), ("H", (0.96, 0, 0)),
                ("H", (0.96 * np.cos(ang), 0.96 * np.sin(ang), 0))]
        ints = compute_molecular_integrals(geom, basis="6-31g")
        h = MolecularHamiltonian(
            compute_active_space_integrals(ints, n_frozen=1, n_active=10))
        tag = "h2o/6-31g"
    else:
        geom = [("Li", (0.0, 0.0, 0.0)), ("H", (0.0, 0.0, 1.6))]
        ints = compute_molecular_integrals(geom, basis="6-31g")
        h = MolecularHamiltonian(ints)
        tag = "lih/6-31g"
    exact = h.fci_energy()
    pipe = train_nf(h, epochs=250, samples=2048)
    nf_mha = 1000 * (pipe.results["stage2"]["nf_energy"] - exact)
    skqd = FlowGuidedSKQD(h, pipe.nf_basis,
                          SKQDConfig(max_krylov_dim=8, shots_per_krylov=50000))
    out = skqd.run_with_nf()
    res_exp = iterative_residual_expansion(h, pipe.nf_basis)
    res = {
        "experiment": "631g", "molecule": tag,
        "n_valid": h.n_valid_configs,
        "nf_mha": nf_mha,
        "nf_skqd_mha": 1000 * (out["best_stable_energy"] - exact),
        "nf_residual_mha": 1000 * (res_exp["energy"] - exact),
    }
    print(json.dumps(res))
    return res


def run_headtohead(molecule: str):
    """Krylov vs PT2 residual expansion from the same NF basis."""
    from flow_guided_krylov_tpu.krylov import (FlowGuidedSKQD, SKQDConfig,
                                               iterative_residual_expansion)
    h = build(molecule)
    exact = h.fci_energy()
    pipe = train_nf(h)
    t0 = time.perf_counter()
    res_exp = iterative_residual_expansion(h, pipe.nf_basis)
    t_res = time.perf_counter() - t0
    t0 = time.perf_counter()
    skqd = FlowGuidedSKQD(h, pipe.nf_basis,
                          SKQDConfig(max_krylov_dim=8, shots_per_krylov=50000))
    out = skqd.run_with_nf()
    t_kry = time.perf_counter() - t0
    res = {
        "experiment": "headtohead", "molecule": molecule,
        "residual_mha": 1000 * (res_exp["energy"] - exact),
        "residual_basis": int(len(res_exp["basis"])),
        "residual_time_s": round(t_res, 2),
        "krylov_mha": 1000 * (out["best_stable_energy"] - exact),
        "krylov_basis": out["combined_sizes"][-1],
        "krylov_time_s": round(t_kry, 2),
    }
    print(json.dumps(res))
    return res


EXPERIMENTS = {
    "isolated": run_isolated,
    "provenance": run_provenance,
    "stretched": run_stretched,
    "stretched-full": run_stretched_full,
    "poor-init": run_poor_init,
    "631g": lambda molecule: run_631g(
        molecule if molecule in ("lih", "h2o") else "lih"),
    "headtohead": run_headtohead,
}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--experiment", default="isolated",
                   choices=sorted(EXPERIMENTS) + ["all"])
    p.add_argument("--molecule", default="lih")
    p.add_argument("--stretch", type=float, default=1.5)
    args = p.parse_args()
    exps = (sorted(EXPERIMENTS) if args.experiment == "all"
            else [args.experiment])
    for e in exps:
        if e == "stretched":
            run_stretched(args.molecule, args.stretch)
        elif e == "stretched-full":
            run_stretched_full(args.molecule, args.stretch)
        else:
            EXPERIMENTS[e](args.molecule)


if __name__ == "__main__":
    main()
