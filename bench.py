#!/usr/bin/env python
"""Headline benchmark: batched <x|H|y> matrix-element throughput.

This is the hot op of the whole framework (SURVEY.md §6: "matrix-element
eval + matvec rate" is the BASELINE target metric): for a batch of
determinants, enumerate ALL connected determinants and their Slater-Condon
matrix elements on device (N2-sized system: 20 qubits, 609 connections per
determinant).

The reference computes this with Python/numpy loops on the CPU
(``molecular.py:194-327``) — its single biggest bottleneck.  ``vs_baseline``
compares the device kernel against this repo's *vectorized NumPy float64*
host implementation measured in the same run, itself already much faster
than the reference's per-determinant loops, so the ratio is conservative.
The host rate varies with the host's state, so the ratio is a diagnostic.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}, with
the device and the card's name and power limit.
"""

import json
import time

import numpy as np


def main():
    import jax
    from flow_guided_krylov_tpu.utils.device_peaks import card_label
    from flow_guided_krylov_tpu.utils.profiling import \
        enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX runs on {dev.platform})")

    from flow_guided_krylov_tpu.chem.scf import MolecularIntegrals
    from flow_guided_krylov_tpu.hamiltonians.molecular import \
        MolecularHamiltonian
    from flow_guided_krylov_tpu.ops.slater import connections_batch_np

    # N2/STO-3G-sized synthetic system (20 qubits, C(10,7)^2 = 14,400 dets)
    rng = np.random.default_rng(0)
    n = 10
    h1 = rng.normal(size=(n, n))
    h1 = 0.5 * (h1 + h1.T)
    h2 = rng.normal(size=(n,) * 4) * 0.1
    h2 = h2 + h2.transpose(1, 0, 2, 3)
    h2 = h2 + h2.transpose(0, 1, 3, 2)
    h2 = h2 + h2.transpose(2, 3, 0, 1)
    ints = MolecularIntegrals(h1e=h1, h2e=h2 / 8, nuclear_repulsion=0.5,
                              n_electrons=14, n_orbitals=n,
                              n_alpha=7, n_beta=7)
    h = MolecularHamiltonian(ints)

    # the whole N2-sized space in one batch — the production shape (the
    # training fast path enumerates/densifies the full subspace), and
    # batch amortization is worth ~1.6x over B=2048
    basis = h.enumerate_basis()
    B = len(basis)
    batch = basis[rng.permutation(B)]
    C = h.n_connections

    # the ROUTED production kernel — the same pick every production call
    # site builds (tools/measure_conn_kernels.py times it across shapes)
    from flow_guided_krylov_tpu.ops.slater import connection_kernel_choice
    import jax.numpy as jnp
    batch_dev = jnp.asarray(batch)
    iters = 10
    fn = h.connections_device
    out = fn(batch_dev)
    jax.block_until_ready(out)             # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(batch_dev)
    jax.block_until_ready(out)
    dt_dev = (time.perf_counter() - t0) / iters
    rate_dev = B * C / dt_dev
    kernel_name = connection_kernel_choice(h.tables)

    # host rate of the f64 NumPy mirror, same batch
    t0 = time.perf_counter()
    connections_batch_np(batch, h.tables)
    dt_host = time.perf_counter() - t0
    rate_host_live = B * C / dt_host

    tta_s, tta_err, tta_basis = time_to_accuracy("n2")
    # second wall (round-5): CH4's space (15,876 configs, C=560) runs the
    # same HF-seeded SCI machinery on a different shape so the gate can't
    # overfit the N2 path
    tta2_s, tta2_err, tta2_basis = time_to_accuracy("ch4")

    print(json.dumps({
        "metric": "matrix_elements_per_second",
        "value": rate_dev,
        "unit": "elements/s",
        "vs_baseline": rate_dev / rate_host_live,
        "kernel": kernel_name,
        "host_rate": rate_host_live,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_label(),
        # BASELINE.md target metric: end-to-end wall to <1.6 mHa on N2
        # (HF-seeded Selected-CI, the framework's fastest route; the
        # reference's best N2 is 13.82 mHa — it never reaches the bar)
        "n2_time_to_chemacc_s": tta_s,
        "n2_error_mha": tta_err,
        "n2_basis_size": tta_basis,
        "ch4_time_to_chemacc_s": tta2_s,
        "ch4_error_mha": tta2_err,
        "ch4_basis_size": tta2_basis,
    }))


def time_to_accuracy(molecule: str):
    """Wall-clock from HF seed to <1.6 mHa vs FCI (N2/STO-3G: 14,400
    configs; CH4: 15,876) via the stage-3 Selected-CI machinery — the
    BASELINE.md time-to-accuracy target.  The FCI oracle is
    instrumentation (disk cached, nothing in the solver reads it); the
    timed region is the solve alone."""
    from flow_guided_krylov_tpu.hamiltonians import MOLECULE_FACTORIES
    from flow_guided_krylov_tpu.krylov import (ResidualExpansionConfig,
                                               SelectedCIExpander)

    h = MOLECULE_FACTORIES[molecule]()
    exact = h.fci_energy()
    cfg = ResidualExpansionConfig(
        max_iterations=40, configs_per_iteration=300,
        stagnation_threshold=1e-6, stagnation_patience=3,
        max_basis_size=min(h.n_valid_configs, 30_000))
    expander = SelectedCIExpander(h, cfg)
    basis = h.get_hf_state()[None, :]
    t0 = time.perf_counter()
    wall = None
    e = float("inf")
    for _ in range(cfg.max_iterations):
        out = expander.expand_basis(basis)
        basis, e = out["basis"], out["energy"]
        if e - exact < 1.6e-3:
            wall = round(time.perf_counter() - t0, 2)
            break
        if not out["accepted"]:
            break
    return wall, round(1000 * (e - exact), 4), int(len(basis))


if __name__ == "__main__":
    main()
