#!/usr/bin/env python
"""Moderate-size molecules with SystemScaler auto-configuration.

Counterpart of ``/root/reference/examples/moderate_system_benchmark.py``:
CO / HCN / C2H2 / C2H4 plus 6-31G H2O, auto-configured with
``SystemScaler`` FAST/BALANCED/ACCURATE presets; FCI reference when the
configuration space is tractable (``moderate_system_benchmark.py:394-450``).

Second-row elements (H2S) use the in-repo Slater-rule STO-3G refit
(``chem/basis.py``) — self-consistent STO-3G-quality, within ~0.04 Ha of
the published tables for H2S.

Usage: python examples/moderate_system_benchmark.py --molecule co --preset fast
"""

import os
import sys

# keep the CLI runnable when the editable install is absent (env resets)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np

GEOMETRIES = {
    # name: (geometry, basis)
    "co": ([("C", (0, 0, 0)), ("O", (0, 0, 1.128))], "sto-3g"),
    "hcn": ([("H", (0, 0, -1.064)), ("C", (0, 0, 0)),
             ("N", (0, 0, 1.156))], "sto-3g"),
    "c2h2": ([("C", (0, 0, -0.601)), ("C", (0, 0, 0.601)),
              ("H", (0, 0, -1.663)), ("H", (0, 0, 1.663))], "sto-3g"),
    "c2h4": ([("C", (0, 0, -0.6695)), ("C", (0, 0, 0.6695)),
              ("H", (0, 0.9289, -1.2321)), ("H", (0, -0.9289, -1.2321)),
              ("H", (0, 0.9289, 1.2321)), ("H", (0, -0.9289, 1.2321))],
             "sto-3g"),
    "h2o_631g": (None, "6-31g"),
    # r(SH)=1.336 A, angle 92.1 deg; second-row STO-3G via the in-repo
    # Slater-rule refit (chem/basis.py)
    "h2s": ([("S", (0.0, 0.0, 0.0)),
             ("H", (0.9617, 0.0, 0.9268)),
             ("H", (-0.9617, 0.0, 0.9268))], "sto-3g"),
}

FCI_LIMIT = 100_000  # configs beyond this: CCSD(T) oracle instead of FCI


def build(name: str):
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    if name == "h2o_631g":
        ang = np.radians(104.5)
        geom = [("O", (0, 0, 0)), ("H", (0.96, 0, 0)),
                ("H", (0.96 * np.cos(ang), 0.96 * np.sin(ang), 0))]
        ints = compute_molecular_integrals(geom, basis="6-31g")
    else:
        geom, basis = GEOMETRIES[name]
        ints = compute_molecular_integrals(geom, basis=basis)
    # moderate systems: freeze 1s cores of heavy atoms to keep the
    # configuration space tractable (the reference's active-space practice)
    n_heavy = sum(1 for el, _ in (geom or []) if el not in ("H",))
    if name == "h2o_631g":
        n_heavy = 1
    if n_heavy and ints.n_orbitals >= 10:
        ints = compute_active_space_integrals(ints, n_frozen=n_heavy)
    return MolecularHamiltonian(ints)


def run(name: str, preset_name: str = "balanced") -> dict:
    from flow_guided_krylov_tpu.pipeline import FlowGuidedKrylovPipeline
    from flow_guided_krylov_tpu.utils import QualityPreset, SystemScaler

    h = build(name)
    n_valid = h.n_valid_configs
    exact = h.fci_energy() if n_valid <= FCI_LIMIT else None
    preset = QualityPreset(preset_name)
    cfg = SystemScaler(n_valid, preset).create_pipeline_config(verbose=False)
    pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=exact)
    out = pipe.run()
    res = {
        "molecule": name, "preset": preset_name,
        "n_orbitals": h.n_orbitals, "n_valid": n_valid,
        "final_energy": out["final_energy"],
        "hf_energy": h.integrals.hf_energy,
    }
    if exact is not None:
        res["exact_energy"] = exact
        res["error_mha"] = out["error_mha"]
        res["chemical_accuracy"] = out["chemical_accuracy"]
    else:
        # no FCI: CCSD(T) on the SAME active-space integrals is the
        # error-bar oracle (the reference's CCSD fallback,
        # ``moderate_system_benchmark.py:122-157``)
        from flow_guided_krylov_tpu.chem.ccsd import ccsd_reference_dict
        res["correlation_recovered"] = (
            h.diagonal_np(h.get_hf_state()[None, :])[0] - out["final_energy"])
        res.update(ccsd_reference_dict(h.integrals, out["final_energy"]))
    print(json.dumps(res))
    return res


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--molecule", default="co",
                   help=f"one of {sorted(GEOMETRIES)} or 'all'")
    p.add_argument("--preset", default="balanced",
                   choices=["fast", "balanced", "accurate"])
    args = p.parse_args()
    names = (sorted(GEOMETRIES) if args.molecule == "all"
             else [args.molecule])
    for n in names:
        run(n, args.preset)


if __name__ == "__main__":
    main()
