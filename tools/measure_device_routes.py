#!/usr/bin/env python
"""Time alternative formulations of two device routes, to choose one.

* ``ell``: the ELL SpMV at TFIM-24 (2^24 rows, C = 24): the scan over
  connection rows against the one-expression gather-multiply-sum
  ``diag*psi + (elems_t * psi[tgt_t]).sum(0)``, with each form's share of
  the device-memory bandwidth.
* ``flips``: one spin-flip permutation of a 2^25 f32 vector, for single
  low ("lane", < 7) and high ("row") bits and a two-bit mask: the
  lane-permutation matmul + row-roll form, the index gather
  ``v[iota ^ mask]`` and the slab reverse ``flip(v.reshape(a, 2, c), 1)``.
  All three must agree exactly: a permutation moves values, it does not
  round them.

Prints one JSON line per measurement, each with the device and the card's
name and power limit.  Run on the GPU:

    python tools/measure_device_routes.py [--only ell flips]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _time(fn, *args, iters=20):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)                # compile + warm
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters, out


def measure_ell(device, peaks):
    import jax
    import jax.numpy as jnp
    from flow_guided_krylov_tpu.hamiltonians import TransverseFieldIsing
    from flow_guided_krylov_tpu.ops.ell import ell_spmv
    from flow_guided_krylov_tpu.postprocessing.eigensolver import \
        _build_fullspace_ell_device

    ham = TransverseFieldIsing(24, V=1.0, h=1.0, periodic=True)
    diag, elems, tgt = _build_fullspace_ell_device(ham)
    C, N = elems.shape
    psi = jax.random.normal(jax.random.PRNGKey(0), (N,), jnp.float32)

    @jax.jit
    def scan(diag, elems_t, tgt_t, psi):
        def body(acc, et):
            e, t = et
            return acc + e * jnp.take(psi, t, axis=0), None

        return jax.lax.scan(body, diag * psi, (elems_t, tgt_t))[0]

    # tables read once, diag + psi read, out written; the C gathered psi
    # reads are extra traffic wherever they miss the cache
    min_bytes = 2 * C * N * 4 + 3 * N * 4
    outs = {}
    for name, fn in (("scan", scan),
                     ("one_expression", jax.jit(ell_spmv))):
        dt, outs[name] = _time(fn, diag, elems, tgt, psi)
        print(json.dumps({
            "measure": "ell_spmv", "form": name, "n_rows": N, "C": C,
            "ms": dt * 1e3, "min_bytes": min_bytes,
            "bytes_s": min_bytes / dt,
            "hbm_share": min_bytes / dt / peaks.hbm_bytes_s,
            "device": device}), flush=True)
    diff = float(jnp.max(jnp.abs(outs["scan"] - outs["one_expression"])))
    print(json.dumps({"measure": "ell_spmv", "max_abs_diff": diff,
                      "device": device}), flush=True)


def _lane_perm_flip(v, mask, n):
    import jax
    import jax.numpy as jnp
    lane = mask & 0x7F
    if lane:
        cols = np.arange(128)
        P = np.zeros((128, 128), np.float32)
        P[cols ^ lane, cols] = 1.0
        v = jnp.dot(v.reshape(-1, 128), jnp.asarray(P),
                    precision=jax.lax.Precision.HIGHEST).reshape(-1)
    for i in range(7, n):
        if (mask >> i) & 1:
            v = jnp.roll(v.reshape(-1, 1 << (i + 1)), 1 << i,
                         axis=1).reshape(-1)
    return v


def _gather_flip(v, mask, n):
    import jax.numpy as jnp
    return v[jnp.arange(1 << n, dtype=jnp.uint32) ^ jnp.uint32(mask)]


def _reverse_flip(v, mask, n):
    import jax.numpy as jnp
    for i in range(n):
        if (mask >> i) & 1:
            v = jnp.flip(v.reshape(1 << (n - 1 - i), 2, 1 << i),
                         axis=1).reshape(-1)
    return v


def measure_flips(device, peaks, n=25):
    import functools

    import jax
    import jax.numpy as jnp
    v = jax.random.normal(jax.random.PRNGKey(1), (1 << n,), jnp.float32)
    nbytes = 2 * (1 << n) * 4                 # read + write one vector
    for label, mask in (("bit0", 1), ("lane_bit3", 1 << 3),
                        ("row_bit10", 1 << 10), ("row_bit20", 1 << 20),
                        ("bits_3_4", (1 << 3) | (1 << 4)),
                        ("bits_3_20", (1 << 3) | (1 << 20))):
        outs = {}
        for name, form in (("lane_matmul_roll", _lane_perm_flip),
                           ("gather", _gather_flip),
                           ("reverse", _reverse_flip)):
            fn = jax.jit(functools.partial(form, mask=mask, n=n))
            dt, outs[name] = _time(fn, v)
            print(json.dumps({
                "measure": "flip", "mask": label, "n": n, "form": name,
                "ms": dt * 1e3, "bytes_s": nbytes / dt,
                "hbm_share": nbytes / dt / peaks.hbm_bytes_s,
                "device": device}), flush=True)
        ref = np.asarray(outs["gather"])
        exact = {k: bool(np.array_equal(np.asarray(o), ref))
                 for k, o in outs.items()}
        print(json.dumps({"measure": "flip", "mask": label,
                          "exact_vs_gather": exact, "device": device}),
              flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", nargs="*",
                   default=["ell", "flips"], choices=["ell", "flips"])
    args = p.parse_args()

    import jax
    from flow_guided_krylov_tpu.utils.device_peaks import (card_label,
                                                           peaks_for)
    from flow_guided_krylov_tpu.utils.profiling import \
        enable_compilation_cache
    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU: JAX runs on {dev.platform}")
    peaks = peaks_for(dev.device_kind)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card_label()}
    if "ell" in args.only:
        measure_ell(device, peaks)
    if "flips" in args.only:
        measure_flips(device, peaks)


if __name__ == "__main__":
    main()
