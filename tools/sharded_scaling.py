#!/usr/bin/env python
"""Simulated scaling curves for the shard_map paths (VERDICT r3 item 8).

Runs on the 8-virtual-device CPU mesh (one physical core), so wall clock
cannot DROP with the device count — but it exposes accidental
serialization: if each shard processed the full input (instead of its
1/n_dev row slice), wall would GROW ~linearly with n_dev.  A flat wall
at fixed problem size means per-shard work shrinks ~1/n_dev, which is
what transfers to a real multi-GPU mesh.

Usage:
    python tools/sharded_scaling.py          # prints a markdown table
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def time_pt2_scoring(n_dev: int, n_sources: int = 4096) -> float:
    """One device-scoring call (sort + segment-sum + top-K per shard)."""
    from flow_guided_krylov_tpu.hamiltonians import MOLECULE_FACTORIES
    from flow_guided_krylov_tpu.krylov import (ResidualExpansionConfig,
                                               SelectedCIExpander)
    from flow_guided_krylov_tpu.parallel import make_mesh

    h = MOLECULE_FACTORIES["n2"]()
    mesh = make_mesh(n_dev) if n_dev > 1 else None
    exp = SelectedCIExpander(
        h, ResidualExpansionConfig(max_basis_size=n_sources),
        use_device_scoring=True, mesh=mesh)
    basis = h.enumerate_basis()[:n_sources]
    rng = np.random.default_rng(0)
    coeffs = rng.normal(size=n_sources)
    coeffs /= np.linalg.norm(coeffs)
    exp._pt2_topk_device(basis, coeffs)          # compile + warm
    t0 = time.perf_counter()
    exp._pt2_topk_device(basis, coeffs)
    return time.perf_counter() - t0


def time_sharded_trotter(n_dev: int, n_qubits: int = 16,
                         n_substeps: int = 4) -> float:
    """Trotter substeps over a sharded 2^n statevector."""
    from flow_guided_krylov_tpu.hamiltonians import TransverseFieldIsing
    from flow_guided_krylov_tpu.hamiltonians.spin import \
        extract_coeffs_and_paulis
    from flow_guided_krylov_tpu.parallel import make_mesh
    from flow_guided_krylov_tpu.parallel.sharded_trotter import (
        make_sharded_substep, shard_statevector)

    from flow_guided_krylov_tpu.krylov.basis_sampler import _pauli_masks

    ham = TransverseFieldIsing(n_qubits, V=1.0, h=1.0, periodic=True)
    coeffs, words = extract_coeffs_and_paulis(ham)
    masks = [_pauli_masks(w) for w in words]
    diag = [(c, zm) for c, (xm, zm, _) in zip(coeffs, masks) if xm == 0]
    offd = [(c, xm, zm, ny) for c, (xm, zm, ny) in zip(coeffs, masks)
            if xm != 0]
    # statevector sharding lives on the 'basis' axis: put every device there
    mesh = make_mesh(n_dev, basis_parallel=n_dev)
    substep_fn, hp_re, hp_im = make_sharded_substep(mesh, n_qubits, diag,
                                                    offd, 0.05)

    def substep(r, i):
        return substep_fn(r, i, hp_re, hp_im)
    dim = 1 << n_qubits
    re = np.zeros(dim, np.float32)
    re[0] = 1.0
    im = np.zeros(dim, np.float32)
    re_d, im_d = shard_statevector(mesh, jnp.asarray(re), jnp.asarray(im))
    out = substep(re_d, im_d)
    jax.block_until_ready(out)                   # compile + warm
    t0 = time.perf_counter()
    r, i = re_d, im_d
    for _ in range(n_substeps):
        r, i = substep(r, i)
    jax.block_until_ready((r, i))
    return (time.perf_counter() - t0) / n_substeps


def main():
    rows = []
    for nd in (1, 2, 4, 8):
        t_pt2 = time_pt2_scoring(nd)
        t_trot = time_sharded_trotter(nd)
        rows.append({"n_devices": nd,
                     "pt2_scoring_s": round(t_pt2, 3),
                     "trotter_substep_s": round(t_trot, 4)})
        print(json.dumps(rows[-1]))
    base_pt2 = rows[0]["pt2_scoring_s"]
    base_tr = rows[0]["trotter_substep_s"]
    print("\n| devices | PT2 scoring (s) | x vs 1 dev | Trotter substep (s)"
          " | x vs 1 dev |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['n_devices']} | {r['pt2_scoring_s']} | "
              f"{r['pt2_scoring_s'] / base_pt2:.2f} | "
              f"{r['trotter_substep_s']} | "
              f"{r['trotter_substep_s'] / base_tr:.2f} |")
    print("\n(single physical core: flat wall = per-shard work ~1/n_dev; "
          "growing wall would expose accidental serialization)")


if __name__ == "__main__":
    main()
