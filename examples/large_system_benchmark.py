#!/usr/bin/env python
"""Active-space benchmarks for larger systems.

Counterpart of ``/root/reference/examples/large_system_benchmark.py``:
frozen-core active-space pipelines (core J/K folding implemented in
``chem/active_space.py``, the rebuild of
``large_system_benchmark.py:93-167``) for N2, ozone, butadiene, benzene
(pi space, ``:253-316``), an Fe-porphyrin model (``:320-378``) and
N2/cc-pVDZ (``:381-427``).

Cr2 (12e,12o) runs on the in-repo variationally-fitted Cr STO-3G
(anchored +58.8 mHa from the published Cr ROHF limit by
tools/hf_limit_check.py); the self-contained tables otherwise cover
H-Ar STO-3G, first-row 6-31G/6-31G*, and H/C/N/O/F cc-pVDZ.

Usage: python examples/large_system_benchmark.py --system n2_frozen
"""

import os
import sys

# keep the CLI runnable when the editable install is absent (env resets)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np

SYSTEMS = {}


def register(name):
    def deco(fn):
        SYSTEMS[name] = fn
        return fn
    return deco


@register("n2_frozen")
def n2_frozen():
    """N2 with frozen 1s cores: 8 active orbitals, 10 active electrons."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    ints = compute_molecular_integrals([("N", (0, 0, 0)),
                                        ("N", (0, 0, 1.10))])
    act = compute_active_space_integrals(ints, n_frozen=2)
    return MolecularHamiltonian(act)


@register("ozone")
def ozone():
    """O3 (C2v), frozen 1s cores: 12 active orbitals, 18 active electrons."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    # experimental geometry: r(OO)=1.278 A, angle 116.8 deg
    ang = np.radians(116.8 / 2)
    r = 1.278
    geom = [("O", (0.0, 0.0, 0.0)),
            ("O", (r * np.sin(ang), r * np.cos(ang), 0.0)),
            ("O", (-r * np.sin(ang), r * np.cos(ang), 0.0))]
    ints = compute_molecular_integrals(geom)
    act = compute_active_space_integrals(ints, n_frozen=3)
    return MolecularHamiltonian(act)


@register("butadiene_pi")
def butadiene_pi():
    """trans-butadiene with a frozen-core active window (C 1s frozen)."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    # planar trans-butadiene (approximate experimental geometry, Angstrom)
    geom = [
        ("C", (-1.849, 0.135, 0.0)), ("C", (-0.616, -0.426, 0.0)),
        ("C", (0.616, 0.426, 0.0)), ("C", (1.849, -0.135, 0.0)),
        ("H", (-2.743, -0.479, 0.0)), ("H", (-1.966, 1.211, 0.0)),
        ("H", (-0.537, -1.508, 0.0)), ("H", (0.537, 1.508, 0.0)),
        ("H", (1.966, -1.211, 0.0)), ("H", (2.743, 0.479, 0.0)),
    ]
    ints = compute_molecular_integrals(geom)
    # freeze C 1s cores + the deepest sigma MOs to reach a 10-orbital window
    act = compute_active_space_integrals(ints, n_frozen=10, n_active=10)
    return MolecularHamiltonian(act)


@register("benzene_pi")
def benzene_pi():
    """Benzene (6e, 6o) HOMO/LUMO window: C(6,3)^2 = 400 valid configs
    (reference ``large_system_benchmark.py:253-316``)."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    cc, ch = 1.40, 1.09
    geom = []
    for i in range(6):
        rad = np.radians(60.0 * i)
        geom.append(("C", (cc * np.cos(rad), cc * np.sin(rad), 0.0)))
    for i in range(6):
        rad = np.radians(60.0 * i)
        geom.append(("H", ((cc + ch) * np.cos(rad),
                           (cc + ch) * np.sin(rad), 0.0)))
    ints = compute_molecular_integrals(geom)
    # 42 electrons; the (6e, 6o) window freezes the lowest 18 MOs
    act = compute_active_space_integrals(ints, n_frozen=18, n_active=6)
    return MolecularHamiltonian(act)


@register("fe_porphyrin_model")
def fe_porphyrin_model():
    """Fe(II)N4 square-planar model, high-spin, (8e, 10o) window
    (reference ``large_system_benchmark.py:320-378``)."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    d = 2.0
    geom = [("Fe", (0.0, 0.0, 0.0)),
            ("N", (d, 0.0, 0.0)), ("N", (-d, 0.0, 0.0)),
            ("N", (0.0, d, 0.0)), ("N", (0.0, -d, 0.0))]
    ints = compute_molecular_integrals(geom, charge=2, spin=4)
    # 52 electrons, 4 unpaired; (8e, 10o) freezes the lowest 22 MOs
    act = compute_active_space_integrals(ints, n_frozen=22, n_active=10)
    return MolecularHamiltonian(act)


@register("cr2")
def cr2():
    """Cr2 (12e, 12o) — the formal sextuple bond, 3d+4s active space
    (reference ``large_system_benchmark.py:196-252``; C(12,6)^2 = 853,776
    configs).  The reference runs cc-pVDZ through PySCF; no published
    3d-metal cc-pVDZ tables exist in-repo, so this uses the in-repo
    variationally-fitted Cr STO-3G (``chem/basis.py``, validated against
    the published HF limit via tools/hf_limit_check.py).  The strong
    multi-reference character of the 3d-3d space — the point of the
    benchmark — is present either way."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    ints = compute_molecular_integrals(
        [("Cr", (0.0, 0.0, 0.0)), ("Cr", (0.0, 0.0, 1.68))])
    # 48 electrons; (12e, 12o) freezes the lowest 18 MOs (Ar-core pairs)
    act = compute_active_space_integrals(ints, n_frozen=18, n_active=12)
    return MolecularHamiltonian(act)


@register("ozone_ccpvdz_32o")
def ozone_ccpvdz_32o():
    """O3/cc-pVDZ (18e, 32o) — the single-word 32-orbital ceiling on a
    real correlated system (round-4 frontier: valence + 20 virtuals of
    the 42-orbital space, 1s cores frozen).  C(32,9)^2 = 8.1e15 configs:
    far beyond enumeration, exactly the regime HF-seeded SCI owns."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    ang = np.radians(116.8 / 2)
    r = 1.278
    geom = [("O", (0.0, 0.0, 0.0)),
            ("O", (r * np.sin(ang), r * np.cos(ang), 0.0)),
            ("O", (-r * np.sin(ang), r * np.cos(ang), 0.0))]
    ints = compute_molecular_integrals(geom, basis="cc-pvdz")
    act = compute_active_space_integrals(ints, n_frozen=3, n_active=32)
    return MolecularHamiltonian(act)


@register("ozone_ccpvdz_full")
def ozone_ccpvdz_full():
    """O3/cc-pVDZ FULL post-core space (18e, 39o) — the first >32-orbital
    active space (round-5 W=4 machinery: two uint32 words per spin
    channel, 128-bit host keys, 4-word lexicographic device sorts).
    C(39,9)^2 = 4.5e16 configs; the round-4 frontier truncated this
    system to 32 orbitals — this is the whole space with only the three
    1s cores frozen."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    ang = np.radians(116.8 / 2)
    r = 1.278
    geom = [("O", (0.0, 0.0, 0.0)),
            ("O", (r * np.sin(ang), r * np.cos(ang), 0.0)),
            ("O", (-r * np.sin(ang), r * np.cos(ang), 0.0))]
    ints = compute_molecular_integrals(geom, basis="cc-pvdz")
    act = compute_active_space_integrals(ints, n_frozen=3, n_active=39)
    return MolecularHamiltonian(act)


@register("n2_ccpvdz")
def n2_ccpvdz():
    """N2/cc-pVDZ (10e, 14o) valence active space
    (reference ``large_system_benchmark.py:381-427``)."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    ints = compute_molecular_integrals(
        [("N", (0, 0, 0)), ("N", (0, 0, 1.10))], basis="cc-pvdz")
    act = compute_active_space_integrals(ints, n_frozen=2, n_active=14)
    return MolecularHamiltonian(act)


@register("n2_ccpvdz_10o")
def n2_ccpvdz_10o():
    """N2/cc-pVDZ minimal-valence (10e, 10o): 63,504 configs, FCI-checkable."""
    from flow_guided_krylov_tpu.chem import compute_molecular_integrals
    from flow_guided_krylov_tpu.chem.active_space import \
        compute_active_space_integrals
    from flow_guided_krylov_tpu.hamiltonians import MolecularHamiltonian
    ints = compute_molecular_integrals(
        [("N", (0, 0, 0)), ("N", (0, 0, 1.10))], basis="cc-pvdz")
    act = compute_active_space_integrals(ints, n_frozen=2, n_active=10)
    return MolecularHamiltonian(act)


def run_sci(h, exact, max_basis: int = 50_000, iters: int = 80,
            per_iter: int = 600, growth: float = 0.0,
            threshold: float = 1e-4, screen: float = 0.0,
            pt2_cap: int = 0, checkpoints=None, sort_rows: int = 0) -> dict:
    """HF-seeded Selected-CI (stage-3 machinery alone) — the fastest
    route on these spaces after the round-2 host-kernel rewrite."""
    from flow_guided_krylov_tpu.krylov import (ResidualExpansionConfig,
                                               iterative_residual_expansion)
    cfg = ResidualExpansionConfig(
        max_iterations=iters, configs_per_iteration=per_iter,
        growth_factor=growth, residual_threshold=threshold,
        stagnation_threshold=1e-6, stagnation_patience=3,
        source_screen=screen, pt2_sort_rows=sort_rows,
        max_basis_size=min(h.n_valid_configs, max_basis))
    out = iterative_residual_expansion(h, h.get_hf_state()[None, :], cfg,
                                       verbose=True, pt2_correct=True,
                                       pt2_cap=pt2_cap or None,
                                       pt2_checkpoints=checkpoints)
    e = float(out["energy"])
    res = {"final_energy": e, "basis_size": int(len(out["basis"])),
           "_basis": out["basis"]}
    if "pt2_de2" in out:
        res["pt2_de2"] = out["pt2_de2"]
        res["pt2_corrected_energy"] = out["pt2_corrected_energy"]
        res["pt2_exact"] = out["pt2_exact"]
    if "pt2_checkpoints" in out:
        res.update(extrapolate_de2(out["pt2_checkpoints"],
                                   e_var_final=e,
                                   de2_final=out.get("pt2_de2"),
                                   final_exact=out.get("pt2_exact")))
    if exact is not None:
        res["error_mha"] = 1000 * (e - exact)
        res["chemical_accuracy"] = abs(e - exact) < 1.6e-3
        if "pt2_corrected_energy" in res:
            res["corrected_error_mha"] = 1000 * (res["pt2_corrected_energy"]
                                                 - exact)
    return res


def extrapolate_de2(rows, e_var_final=None, de2_final=None,
                    final_exact=None) -> dict:
    """Standard SHCI extrapolation: fit E_total = E_var + dE2 linearly in
    dE2 over the checkpointed trajectory and read the intercept at
    dE2 -> 0 (Holmes-Umrigar-Sharma practice for spaces with no
    convergent oracle).  The quoted uncertainty is the larger of the fit
    residual and 20% of the extrapolation distance from the deepest
    point — deliberately conservative."""
    pts = [(r["de2"], r["e_var"] + r["de2"]) for r in rows if r["exact"]]
    if (e_var_final is not None and de2_final is not None and final_exact
            and all(abs(de2_final - r["de2"]) > 1e-12 for r in rows)):
        pts.append((de2_final, e_var_final + de2_final))
    res = {"extrapolation_points": [
        {k: r[k] for k in ("basis_size", "e_var", "de2", "exact")}
        for r in rows]}
    if len(pts) < 2:
        return res
    pts.sort(key=lambda t: abs(t[0]), reverse=True)
    x = np.array([p[0] for p in pts])
    y = np.array([p[1] for p in pts])
    (slope, e0), residuals, *_ = np.polyfit(x, y, 1, full=True)
    fit_rms = float(np.sqrt(residuals[0] / len(x))) if len(residuals) else 0.0
    dist = abs(float(y[np.argmin(np.abs(x))]) - float(e0))
    sigma = max(fit_rms, 0.2 * dist)
    res.update(extrapolated_energy=float(e0),
               extrapolation_uncertainty_mha=round(1000 * sigma, 3),
               extrapolation_slope=float(slope),
               extrapolation_n_points=len(pts))
    return res


def run_restricted_skqd(h, exact, basis, e_sci: float,
                        krylov_dim: int = 6, shots: int = 100_000,
                        dt: float = 0.1) -> dict:
    """Stage 4 at the frontier: restricted-subspace SKQD on top of a
    Selected-CI basis (round-4; reference full-space SKQD never reaches
    these system sizes).  Evolution acts within (basis + top PT2
    externals) sized to the device propagator; sampling the evolved
    state discovers determinants stage 3 missed."""
    import time as _time
    from flow_guided_krylov_tpu.krylov import FlowGuidedSKQD, SKQDConfig
    from flow_guided_krylov_tpu.krylov.skqd import (
        build_restricted_subspace, supported_evolution_dim)
    t0 = _time.time()
    cap = supported_evolution_dim(h, None)
    states = build_restricted_subspace(h, basis, cap,
                                       initial_state=h.get_hf_state())
    skqd = FlowGuidedSKQD(
        h, basis,
        SKQDConfig(max_krylov_dim=krylov_dim, shots_per_krylov=shots,
                   time_step=dt, verbose=True),
        initial_state=h.get_hf_state(), subspace_states=states)
    out = skqd.run_with_nf(final_only=True)
    e4 = float(out["best_stable_energy"])
    res = {
        "skqd_restricted_dim": int(len(states)),
        "skqd_propagator_cap": int(cap),
        "skqd_energy": e4,
        "skqd_combined_size": int(out["combined_sizes"][-1]),
        "skqd_configs_added": int(out["combined_sizes"][-1] - len(basis)),
        "skqd_improvement_mha": 1000.0 * (e_sci - min(e4, e_sci)),
        "skqd_wall_s": round(_time.time() - t0, 1),
    }
    if exact is not None:
        res["skqd_error_mha"] = 1000.0 * (min(e4, e_sci) - exact)
    return res


def run(system: str, preset_name: str = "fast", mode: str = "pipeline",
        sci_iters: int = 80, sci_per_iter: int = 600,
        sci_max_basis: int = 50_000, sci_growth: float = 0.0,
        sci_threshold: float = 1e-4, sci_screen: float = 0.0,
        sci_pt2_cap: int = 0, krylov_dim: int = 6,
        shots: int = 100_000, sci_checkpoints=None,
        sci_sort_rows: int = 0) -> dict:
    from flow_guided_krylov_tpu.pipeline import FlowGuidedKrylovPipeline
    from flow_guided_krylov_tpu.utils import QualityPreset, SystemScaler

    h = SYSTEMS[system]()
    n_valid = h.n_valid_configs
    exact = h.fci_energy() if n_valid <= 100_000 else None
    if mode in ("sci", "sci+skqd"):
        out = run_sci(h, exact, max_basis=sci_max_basis, iters=sci_iters,
                      per_iter=sci_per_iter, growth=sci_growth,
                      threshold=sci_threshold, screen=sci_screen,
                      pt2_cap=sci_pt2_cap, checkpoints=sci_checkpoints,
                      sort_rows=sci_sort_rows)
        if mode == "sci+skqd":
            out.update(run_restricted_skqd(h, exact, out.pop("_basis"),
                                           out["final_energy"],
                                           krylov_dim=krylov_dim,
                                           shots=shots))
    else:
        cfg = SystemScaler(n_valid, QualityPreset(preset_name)
                           ).create_pipeline_config(verbose=False)
        pipe = FlowGuidedKrylovPipeline(h, cfg, exact_energy=exact)
        out = pipe.run()
    res = {
        "system": system, "n_active_orbitals": h.n_orbitals,
        "n_active_electrons": h.n_electrons, "n_valid": n_valid,
        "final_energy": out["final_energy"],
    }
    if mode in ("sci", "sci+skqd"):
        # run_sci returns scalars (incl. the PT2-corrected record)
        res.update({k: v for k, v in out.items()
                    if k not in ("final_energy", "_basis")})
    if exact is not None:
        res["exact_energy"] = exact
        res.setdefault("error_mha", out.get("error_mha"))
        res.setdefault("chemical_accuracy", out.get("chemical_accuracy"))
    else:
        from flow_guided_krylov_tpu.chem.ccsd import ccsd_reference_dict
        res["hf_energy"] = float(h.diagonal_np(h.get_hf_state()[None, :])[0])
        res["correlation_recovered"] = res["hf_energy"] - out["final_energy"]
        if "pt2_corrected_energy" in res:
            res["corrected_correlation"] = (res["hf_energy"]
                                            - res["pt2_corrected_energy"])
        # active-space CCSD(T) oracle — the error bar FCI can't provide here
        best = res.get("pt2_corrected_energy", out["final_energy"])
        res.update(ccsd_reference_dict(h.integrals, float(best)))
    print(json.dumps(res))
    return res


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--system", default="n2_frozen",
                   help=f"one of {sorted(SYSTEMS)}")
    p.add_argument("--preset", default="fast",
                   choices=["fast", "balanced", "accurate"])
    p.add_argument("--mode", default="pipeline",
                   choices=["pipeline", "sci", "sci+skqd"],
                   help="sci = HF-seeded Selected-CI only (no flow); "
                        "sci+skqd adds restricted-subspace SKQD on top "
                        "(stage 4 at the frontier)")
    p.add_argument("--krylov-dim", type=int, default=6)
    p.add_argument("--shots", type=int, default=100_000)
    p.add_argument("--sci-iters", type=int, default=80)
    p.add_argument("--sci-per-iter", type=int, default=600)
    p.add_argument("--sci-max-basis", type=int, default=50_000)
    p.add_argument("--sci-growth", type=float, default=0.0,
                   help="SHCI-style proportional adds: each round adds "
                        "max(per-iter, growth * basis) states (0 = fixed)")
    p.add_argument("--sci-threshold", type=float, default=1e-4,
                   help="PT2 coupling threshold; the deep runs "
                        "self-terminate at this cutoff")
    p.add_argument("--sci-screen", type=float, default=0.0,
                   help="SHCI source screening factor: skip scoring rows "
                        "with |c_j|*Hmax < screen*threshold (0 = off)")
    p.add_argument("--sci-pt2-cap", type=int, default=0,
                   help="external-row fetch cap for the exact PT2 "
                        "correction (0 = default 2^23; raise when "
                        "pt2_exact comes back False)")
    p.add_argument("--sci-sort-rows", type=int, default=0,
                   help="pre-sort row cap for the device PT2 scorer: keep "
                        "only the top-N rows by |c_j*H_ij| (approx_max_k) "
                        "before the multi-word sort — the SHCI per-row "
                        "screen; essential at large connection counts "
                        "(39-orbital O3: C=104,760/det).  0 = off")
    p.add_argument("--sci-checkpoints", default="",
                   help="comma-separated basis sizes at which to snapshot "
                        "the exact dE2 mid-trajectory; with >= 2 points "
                        "the result carries the standard SHCI linear "
                        "E-vs-dE2->0 extrapolation and its uncertainty "
                        "(the error bar for spaces where CCSD diverges, "
                        "e.g. Cr2)")
    args = p.parse_args()
    checkpoints = ([int(x) for x in args.sci_checkpoints.split(",") if x]
                   if args.sci_checkpoints else None)
    run(args.system, args.preset, args.mode, sci_iters=args.sci_iters,
        sci_per_iter=args.sci_per_iter, sci_max_basis=args.sci_max_basis,
        sci_growth=args.sci_growth, sci_threshold=args.sci_threshold,
        sci_screen=args.sci_screen, sci_pt2_cap=args.sci_pt2_cap,
        krylov_dim=args.krylov_dim, shots=args.shots,
        sci_checkpoints=checkpoints, sci_sort_rows=args.sci_sort_rows)


if __name__ == "__main__":
    main()
