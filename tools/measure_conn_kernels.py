#!/usr/bin/env python
"""Time the production connection kernel
(``ops/slater.py::make_connection_fn_auto``) across active-space shapes.

For each (n_orb, n_alpha) shape this times the routed kernel at a
production-like batch (sized so B*C covers the PT2-scoring block scale)
and prints one JSON line per shape, with the device and the card's name
and power limit.  Run on the GPU:

    python tools/measure_conn_kernels.py
    python tools/measure_conn_kernels.py --shapes 14:5 12:6 --elems 8e6
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def random_system(n, ka, kb, seed=0):
    from flow_guided_krylov_tpu.chem.scf import MolecularIntegrals
    from flow_guided_krylov_tpu.hamiltonians.molecular import \
        MolecularHamiltonian
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(n, n))
    h1 = 0.5 * (h1 + h1.T)
    h2 = rng.normal(size=(n,) * 4) * 0.1
    h2 = h2 + h2.transpose(1, 0, 2, 3)
    h2 = h2 + h2.transpose(0, 1, 3, 2)
    h2 = h2 + h2.transpose(2, 3, 0, 1)
    ints = MolecularIntegrals(h1e=h1, h2e=h2 / 8, nuclear_repulsion=0.5,
                              n_electrons=ka + kb, n_orbitals=n,
                              n_alpha=ka, n_beta=kb)
    return MolecularHamiltonian(ints)


def random_dets(h, B, seed=1):
    rng = np.random.default_rng(seed)
    n, ka, kb = h.n_orbitals, h.n_alpha, h.n_beta

    def words(k, count):
        out = np.empty(count, np.uint32)
        for i in range(count):
            bits = rng.choice(n, size=k, replace=False)
            out[i] = np.uint32(sum(1 << int(b) for b in bits))
        return out

    return np.stack([words(ka, B), words(kb, B)], -1)


def time_fn(fn, batch_dev, iters=10):
    import jax
    out = fn(batch_dev)
    jax.block_until_ready(out)           # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(batch_dev)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--shapes", nargs="*",
                   default=["10:7", "11:5", "12:6", "14:5", "16:8"],
                   help="n_orb:n_alpha pairs (n_beta = n_alpha)")
    p.add_argument("--elems", type=float, default=6e6,
                   help="target B*C connection evaluations per call")
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args()

    from flow_guided_krylov_tpu.utils.profiling import \
        enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from flow_guided_krylov_tpu.ops.slater import (
        connection_kernel_choice, make_connection_fn_auto)
    from flow_guided_krylov_tpu.utils.device_peaks import card_label
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_label()}

    for spec in args.shapes:
        n, ka = (int(x) for x in spec.split(":"))
        h = random_system(n, ka, ka)
        C = h.n_connections
        B = max(256, int(args.elems / C) // 256 * 256)
        batch = random_dets(h, B)
        batch_dev = jnp.asarray(batch)
        dt = time_fn(make_connection_fn_auto(h.tables), batch_dev,
                     args.iters)
        print(json.dumps({"n_orb": n, "n_alpha": ka, "C": C, "B": B,
                          "kernel": connection_kernel_choice(h.tables),
                          "ms": dt * 1e3, "melems_s": B * C / dt / 1e6,
                          "device": device}), flush=True)


if __name__ == "__main__":
    main()
