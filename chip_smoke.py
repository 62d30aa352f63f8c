#!/usr/bin/env python
"""Device smoke test: run the system's main path once on the GPU and check
every result against this repo's own references.

    python chip_smoke.py          # one card: the six phases below
    python chip_smoke.py --four   # four cards: mesh vs one-card parity only

Phases (one card):

1. ``connection_kernels`` — the routed Slater-Condon connection kernel
   over the full N2/STO-3G space (14,400 determinants, C = 609
   connections each) against the f64 host mirror ``connections_batch_np``:
   connected determinants exactly equal, elements within 1e-5 Ha (device
   f32 at Precision.HIGHEST vs f64).
2. ``pipeline_n2`` — the four-stage pipeline (flow/NQS training,
   diversity selection, PT2 Selected-CI, SKQD) on N2 with the
   ``examples/benchmark.py --quick`` configuration and ``force_skqd``, so
   stage 4 runs even though stage 3 already reaches the bar: the final
   and the SKQD energies each under the 1.6 mHa chemical-accuracy bar
   against the in-repo FCI oracle, and the phase fails if stage 4 was
   skipped.
3. ``pt2_only_n2`` — the stage-3 Selected-CI route alone
   (``examples/benchmark.py --pt2-only``), under 1.6 mHa.
4. ``fullspace_tfim_24`` / ``fullspace_tfim_25`` — exact full-space
   ground state of the periodic TFIM at h = 1 on the device (f32 Lanczos,
   no host refine): 24 spins take the fused device ELL Lanczos, 25 spins
   the table-free flip route.  Relative error against the free-fermion
   closed form within 1e-5 (f32 round-off and the GPU's summation order).
5. ``propagator_n2`` — the SKQD propagator forced to ``ell`` and to
   ``dense`` on the full N2 space, each within max-abs 1e-5 of the f64
   scipy ``expm_multiply`` reference.
6. ``skqd_trotter_tfim_22`` — SKQD on the periodic TFIM-22 at h = 0.5
   through the statevector Trotter route (2^22 amplitudes, one jitted
   program per Pauli rotation): one Trotter substep on a random state
   within relative L2 1e-5 of an f64 host reference that applies each
   Pauli word qubit by qubit, then the whole SKQD run (device sampling,
   Krylov bases, projected-H solve) variational and within 1.6 mHa of
   the free-fermion ground energy.

``--four`` runs the sharded training step, the full pipeline on N2
(stage 4 forced) and the sharded Trotter SKQD on TFIM-22 over a 4-device
('data', 'basis') mesh, and compares each with the one-device run:
|dE| < 1e-4 Ha for N2, and for the TFIM the evolved state within
relative L2 1e-5 and the SKQD energy within 5e-4 Ha (a few shots may
cross CDF boundaries under a different summation order).

Every phase prints one line with its wall time, its error and tolerance,
and the card's name and power limit.  The last line is one JSON object,
printed only when every phase passed; any failure exits non-zero.  The
script refuses to run without a GPU.
"""

import argparse
import json
import math
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
CHEMICAL_ACCURACY_HA = 1.6e-3


def _phase(name, fn, card):
    """Run one phase; print its line; True when it passed."""
    t0 = time.perf_counter()
    try:
        err, tol, detail = fn()
        ok = bool(err < tol)
    except Exception:                    # reported, and fails the run
        traceback.print_exc()
        err, tol, detail, ok = math.nan, math.nan, "raised", False
    wall = time.perf_counter() - t0
    print(f"[{name}] wall_s={wall:.3f} err={err:.3e} tol={tol:.1e} "
          f"{'ok' if ok else 'FAIL'} {detail} | {card}", flush=True)
    return ok


def phase_connection_kernels():
    import jax.numpy as jnp
    import numpy as np
    from flow_guided_krylov_tpu.hamiltonians import create_n2_hamiltonian
    from flow_guided_krylov_tpu.ops.slater import (
        connection_kernel_choice, connections_batch_np)

    h = create_n2_hamiltonian()
    basis = h.enumerate_basis()
    conn_ref, el_ref = connections_batch_np(basis, h.tables)
    conn, el = h.connections_device(jnp.asarray(basis))
    conn, el = np.asarray(conn), np.asarray(el)
    exact = conn.shape == conn_ref.shape and np.array_equal(conn, conn_ref)
    e = float(np.max(np.abs(el - el_ref)))
    return (e if exact else math.inf, 1e-5,
            f"dets={len(basis)} C={h.n_connections} "
            f"kernel={connection_kernel_choice(h.tables)} "
            f"conn_exact={exact} max_abs={e:.2e}")


def _pipeline_config(n_devices=None):
    from benchmark import quick_config
    cfg = quick_config(True, False)
    cfg.verbose = False
    cfg.force_skqd = True
    cfg.n_devices = n_devices
    return cfg


def _stage4_ran(out):
    """True when SKQD really ran: not skipped, and its span took time."""
    return (not out["skqd_skipped"]
            and out["stage_times"]["stage4_skqd"]["total_s"] > 0)


def phase_pipeline_n2():
    from flow_guided_krylov_tpu.pipeline import run_molecular_benchmark
    out = run_molecular_benchmark("n2", _pipeline_config())
    exact = out["exact_energy"]
    err = max(abs(out["final_energy"] - exact),
              abs(out["skqd_energy"] - exact))
    if not _stage4_ran(out):
        err = math.inf
    return (err, CHEMICAL_ACCURACY_HA,
            f"E={out['final_energy']:.8f} E_skqd={out['skqd_energy']:.8f} "
            f"E_fci={exact:.8f} skqd_skipped={out['skqd_skipped']} "
            f"stages_s={_stage_seconds(out)}")


def _stage_seconds(out):
    return json.dumps({k: round(v["total_s"], 3)
                       for k, v in out["stage_times"].items()})


def phase_pt2_only_n2():
    from benchmark import pt2_only_run
    out = pt2_only_run("n2")
    err = abs(out["final_energy"] - out["exact_energy"])
    return (err, CHEMICAL_ACCURACY_HA,
            f"E={out['final_energy']:.8f} E_fci={out['exact_energy']:.8f} "
            f"basis={out['nf_basis_size']}")


def phase_fullspace_tfim(n, route):
    def run():
        from flow_guided_krylov_tpu.hamiltonians import TransverseFieldIsing
        from flow_guided_krylov_tpu.postprocessing import \
            exact_fullspace_ground_state
        from skqd_lattice_validation import tfim_free_fermion_energy
        ham = TransverseFieldIsing(n, V=1.0, h=1.0, periodic=True)
        out = exact_fullspace_ground_state(ham, refine_host=False,
                                           use_cache=False, verbose=False)
        e_ref = tfim_free_fermion_energy(n, 1.0, 1.0)
        err = abs(out["energy"] - e_ref) / abs(e_ref)
        if out["route"] != route:
            err = math.inf
        return (err, 1e-5,
                f"route={out['route']} dim=2^{n} E={out['energy']:.8f} "
                f"E_ref={e_ref:.8f}")
    return run


def phase_propagator_n2():
    import numpy as np
    from flow_guided_krylov_tpu.hamiltonians import create_n2_hamiltonian
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    h = create_n2_hamiltonian()
    outs = {}
    for mode in ("scipy", "dense", "ell"):
        skqd = SampleBasedKrylovDiagonalization(
            h, SKQDConfig(evolution=mode, seed=2))
        psi0 = np.zeros(skqd.dim, complex)
        psi0[skqd._index_of(h.get_hf_state())[0]] = 1.0
        outs[mode] = skqd.evolve(psi0)
    errs = {m: float(np.abs(outs[m] - outs["scipy"]).max())
            for m in ("dense", "ell")}
    return (max(errs.values()), 1e-5,
            f"dim={len(outs['scipy'])} " + " ".join(
                f"{m}:max_abs={e:.2e}" for m, e in errs.items()))


TROTTER_SITES, TROTTER_FIELD = 22, 0.5


def _tfim_trotter_skqd(mesh=None):
    """TFIM-22 SKQD on the statevector Trotter route, from all spins up."""
    import numpy as np
    from flow_guided_krylov_tpu.hamiltonians import TransverseFieldIsing
    from flow_guided_krylov_tpu.krylov import (
        SKQDConfig, SampleBasedKrylovDiagonalization)
    ham = TransverseFieldIsing(TROTTER_SITES, V=1.0, h=TROTTER_FIELD,
                               periodic=True)
    return SampleBasedKrylovDiagonalization(
        ham, SKQDConfig(max_krylov_dim=12, shots_per_krylov=200_000, seed=3),
        initial_state=np.array([0], np.uint32), mesh=mesh)


def _pauli_apply_np(word, psi):
    """P psi in f64, one qubit at a time on the (2,)*n tensor (qubit q is
    bit q of the index, so tensor axis n-1-q)."""
    import numpy as np
    mats = {"X": np.array([[0, 1], [1, 0]], complex),
            "Y": np.array([[0, -1j], [1j, 0]]),
            "Z": np.array([[1, 0], [0, -1]], complex)}
    n = len(word)
    t = psi.reshape((2,) * n)
    for q, p in enumerate(word.upper()):
        if p in mats:
            t = np.moveaxis(np.tensordot(mats[p], t, axes=([1], [n - 1 - q])),
                            0, n - 1 - q)
    return t.reshape(-1)


def _trotter_substep_np(ham, psi, dt_sub):
    """Host f64 reference of one symmetric 2nd-order Trotter substep:
    half the diagonal phase, every off-diagonal rotation
    exp(-i theta P) = cos(theta) - i sin(theta) P forward then in reverse
    at theta = c dt_sub / 2, half the diagonal phase."""
    import numpy as np
    from flow_guided_krylov_tpu.hamiltonians import extract_coeffs_and_paulis
    coeffs, words = extract_coeffs_and_paulis(ham)
    diag = [(c, w) for c, w in zip(coeffs, words)
            if not set(w.upper()) & set("XY")]
    offd = [(c, w) for c, w in zip(coeffs, words)
            if set(w.upper()) & set("XY")]
    ones = np.ones_like(psi)
    D = sum(c * _pauli_apply_np(w, ones).real for c, w in diag)
    half = np.exp(-0.5j * dt_sub * D)
    psi = half * psi
    for c, w in offd + offd[::-1]:
        th = c * dt_sub / 2
        psi = np.cos(th) * psi - 1j * np.sin(th) * _pauli_apply_np(w, psi)
    return half * psi


def _rel_l2(a, b):
    import numpy as np
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_skqd_trotter_tfim():
    import jax.numpy as jnp
    import numpy as np
    from flow_guided_krylov_tpu.krylov.skqd import _TROTTER_FUSE_MAX_SITES
    from skqd_lattice_validation import tfim_free_fermion_energy
    skqd = _tfim_trotter_skqd()
    route_ok = (skqd.use_trotter and skqd.subspace is None
                and TROTTER_SITES > _TROTTER_FUSE_MAX_SITES)
    # one substep on a random state vs the host f64 reference
    rng = np.random.default_rng(0)
    psi = rng.normal(size=skqd.dim) + 1j * rng.normal(size=skqd.dim)
    psi /= np.linalg.norm(psi)
    substep, hp_re, hp_im = skqd._trotter_ops()
    re, im = substep(jnp.asarray(psi.real, jnp.float32),
                     jnp.asarray(psi.imag, jnp.float32), hp_re, hp_im)
    dt_sub = skqd.config.time_step / skqd.config.num_trotter_steps
    prop_err = _rel_l2(np.asarray(re) + 1j * np.asarray(im),
                       _trotter_substep_np(skqd.h, psi, dt_sub))
    out = skqd.run(final_only=True)
    e = out["final_energy"]
    e_ref = tfim_free_fermion_energy(TROTTER_SITES, 1.0, TROTTER_FIELD)
    # scaled so both bars read as 1: substep 1e-5 relative, SKQD 1.6 mHa
    # above the exact energy and never below it
    err = max(prop_err / 1e-5, (e - e_ref) / CHEMICAL_ACCURACY_HA,
              -(e - e_ref) / 1e-6)
    if not route_ok:
        err = math.inf
    return (err, 1.0,
            f"dim=2^{TROTTER_SITES} per_rotation={route_ok} "
            f"substep_rel_l2={prop_err:.2e} E={e:.8f} E_ref={e_ref:.8f} "
            f"err_mha={1000 * (e - e_ref):+.4f} "
            f"basis={out['basis_sizes'][-1]}")


def four_card_parity():
    """Sharded training step and pipeline on N2 over make_mesh(4) vs the
    same runs on one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from flow_guided_krylov_tpu.flows import (ParticleConservingFlow,
                                              PhysicsGuidedConfig,
                                              PhysicsGuidedFlowTrainer)
    from flow_guided_krylov_tpu.hamiltonians import create_n2_hamiltonian
    from flow_guided_krylov_tpu.models import DenseNQS
    from flow_guided_krylov_tpu.parallel import make_mesh
    from flow_guided_krylov_tpu.pipeline import FlowGuidedKrylovPipeline

    h = create_n2_hamiltonian()
    exact = h.fci_energy()

    def step_energy(mesh):
        flow = ParticleConservingFlow(n_orbitals=10, n_alpha=7, n_beta=7,
                                      hidden_dims=(128, 128))
        nqs = DenseNQS(num_sites=20, hidden_dims=(256, 256, 256))
        cfg = PhysicsGuidedConfig(samples_per_batch=1024, verbose=False)
        tr = PhysicsGuidedFlowTrainer(h, flow, nqs, cfg, mesh=mesh)
        out = tr._step(tr.flow_params, tr.nqs_params, tr.flow_opt_state,
                       tr.nqs_opt_state, tr._acc_buf, jax.random.PRNGKey(0),
                       jnp.float32(1.0), tr._table_arrays())
        return float(np.asarray(out[-1])[0])

    def pipeline_energy(n_devices):
        out = FlowGuidedKrylovPipeline(h, _pipeline_config(n_devices),
                                       exact_energy=exact).run()
        if not _stage4_ran(out):
            raise RuntimeError(f"stage 4 skipped on {n_devices} devices")
        return out["final_energy"], _stage_seconds(out)

    def train_step():
        e4, e1 = step_energy(make_mesh(4)), step_energy(None)
        return abs(e4 - e1), 1e-4, f"E_mesh={e4:.8f} E_single={e1:.8f}"

    def pipeline():
        (e4, t4), (e1, t1) = pipeline_energy(4), pipeline_energy(None)
        return (abs(e4 - e1), 1e-4,
                f"E_mesh={e4:.8f} E_single={e1:.8f} "
                f"err_vs_fci_mha={1000 * (e4 - exact):+.4f} "
                f"stages_s_mesh={t4} stages_s_single={t1}")

    def trotter():
        from flow_guided_krylov_tpu.parallel import shard_statevector
        mesh = make_mesh(4)
        one, four = _tfim_trotter_skqd(), _tfim_trotter_skqd(mesh)
        re0 = jnp.zeros(one.dim, jnp.float32).at[0].set(1.0)
        im0 = jnp.zeros(one.dim, jnp.float32)
        r1, i1 = one._evolve_trotter(re0, im0)
        r4, i4 = four._evolve_trotter(*shard_statevector(mesh, re0, im0))
        state_err = _rel_l2(np.asarray(r4) + 1j * np.asarray(i4),
                            np.asarray(r1) + 1j * np.asarray(i1))
        e1 = one.run(final_only=True)["final_energy"]
        e4 = four.run(final_only=True)["final_energy"]
        # both bars scaled to 1: state 1e-5 relative, energy 5e-4 Ha
        return (max(state_err / 1e-5, abs(e4 - e1) / 5e-4), 1.0,
                f"dim=2^{TROTTER_SITES} state_rel_l2={state_err:.2e} "
                f"E_mesh={e4:.8f} E_single={e1:.8f}")

    return [("train_step_mesh4_vs_1", train_step),
            ("pipeline_n2_mesh4_vs_1", pipeline),
            ("skqd_trotter_tfim_mesh4_vs_1", trotter)]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card mesh vs 1-card parity checks")
    args = p.parse_args()

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX runs on {devices[0].platform})")
    want = 4 if args.four else 1
    if len(devices) < want:
        sys.exit(f"chip_smoke: needs {want} GPUs, JAX sees {len(devices)}")

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "examples"))
    from flow_guided_krylov_tpu.utils.device_peaks import card_label
    from flow_guided_krylov_tpu.utils.profiling import \
        enable_compilation_cache
    enable_compilation_cache()
    card = card_label()

    if args.four:
        phases = four_card_parity()
    else:
        phases = [("connection_kernels", phase_connection_kernels),
                  ("pipeline_n2", phase_pipeline_n2),
                  ("pt2_only_n2", phase_pt2_only_n2),
                  ("fullspace_tfim_24", phase_fullspace_tfim(24, "ell-fused")),
                  ("fullspace_tfim_25",
                   phase_fullspace_tfim(25, "flip-stepped")),
                  ("propagator_n2", phase_propagator_n2),
                  (f"skqd_trotter_tfim_{TROTTER_SITES}",
                   phase_skqd_trotter_tfim)]
    results = [_phase(name, fn, card) for name, fn in phases]
    print(f"card: {card}", flush=True)
    if not all(results):
        sys.exit(1)
    print(json.dumps({"ok": True,
                      "device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)}}))


if __name__ == "__main__":
    main()
