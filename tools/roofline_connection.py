#!/usr/bin/env python
"""Roofline + component attribution for the Slater-Condon connection kernel.

VERDICT r3 item 5: the hot kernel sat at ~186 M elements/s for two rounds
with no statement of WHICH resource bounds it.  This tool

1. prints the analytic roofline (bytes and f32 ops per connection for the
   gather kernel v1) against the peaks of
   the device JAX runs on (``utils/device_peaks.py``; an unknown device
   raises), and
2. with ``--measure`` times ablated kernel variants on that device to
   attribute the gap: output writes, h2 gathers, parities, occ/vir list
   construction, and dispatch latency (iteration-count scaling separates
   per-call overhead from device time).
"""

import argparse
import json
import time

import numpy as np


def build_system():
    from flow_guided_krylov_tpu.chem.scf import MolecularIntegrals
    from flow_guided_krylov_tpu.hamiltonians.molecular import \
        MolecularHamiltonian
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
    return MolecularHamiltonian(ints)


def analytic(h, peaks):
    t = h.tables
    C = t.n_connections
    sa, sb, da, db, nab = t.section_sizes()
    n = t.n_orb
    print(f"system: n_orb={n} n_a={t.n_alpha} n_b={t.n_beta}  "
          f"C={C} (singles {sa}+{sb}, ss-doubles {da}+{db}, os {nab})")

    out_bytes = 12  # 2x uint32 target + f32 element per connection
    print(f"\nmandatory device-memory output: {out_bytes} B/conn -> "
          f"write-bound ceiling {peaks.hbm_bytes_s / out_bytes / 1e9:.1f} "
          "G conn/s")

    # v1 (gather): per-connection f32 ops (parities ~2x25, flips, sign mul)
    v1_ops = 70
    # per-connection h2 gathers (2 same-spin, 1 os; singles use m[p,q])
    v1_gathers = (2 * (da + db) + nab + sa + sb) / C
    print(f"\nv1 (gather): ~{v1_ops} f32 ops + {v1_gathers:.2f} "
          f"gathers/conn")
    print(f"  f32 arithmetic ceiling {peaks.f32_flops / v1_ops / 1e9:.0f} "
          "G conn/s")


def _variants(h):
    """Build ablated jitted kernels. Returns {name: fn(batch)->outputs}."""
    import jax
    import jax.numpy as jnp
    from flow_guided_krylov_tpu.ops.slater import make_connection_fn
    from flow_guided_krylov_tpu.ops.bits import occupancy, parity_between
    from flow_guided_krylov_tpu.ops.slater import (_occ_vir_lists_jax,
                                                   _occ_vir_lists_matmul)

    t = h.tables
    n, ka, kb = t.n_orb, t.n_alpha, t.n_beta
    h1 = jnp.asarray(t.h1, jnp.float32)
    jj = jnp.asarray(t.jj, jnp.float32)
    ex = jnp.asarray(t.ex, jnp.float32)
    h2f = jnp.asarray(t.h2.reshape(-1), jnp.float32)
    sing_a = jnp.asarray(t.spec_a.singles)
    sing_b = jnp.asarray(t.spec_b.singles)
    dbl_a = jnp.asarray(t.spec_a.doubles)
    dbl_b = jnp.asarray(t.spec_b.doubles)
    ab = jnp.asarray(t.ab_grid)
    one = jnp.uint32(1)

    def make_v1(use_gather=True, use_parity=True, emit_conn=True,
                emit_elems=True, lists_fn=_occ_vir_lists_jax):
        def h2g(p, q, r, s):
            if not use_gather:
                return (p + q + r + s).astype(jnp.float32)
            return h2f[((p * n + q) * n + r) * n + s]

        def par(bits, p, q):
            if not use_parity:
                return jnp.ones(p.shape, jnp.int32)
            return parity_between(bits, p, q)

        def flip(bits, p, q):
            return bits ^ (one << p.astype(jnp.uint32)) \
                        ^ (one << q.astype(jnp.uint32))

        def per_det(pa, pb):
            occ_a = occupancy(pa, n).astype(jnp.float32)
            occ_b = occupancy(pb, n).astype(jnp.float32)
            N = occ_a + occ_b
            la, va = lists_fn(pa, n, ka)
            lb, vb = lists_fn(pb, n, kb)
            coul = (jj * N[None, None, :]).sum(-1)
            m_a = h1 + coul - (ex * occ_a[None, None, :]).sum(-1)
            m_b = h1 + coul - (ex * occ_b[None, None, :]).sum(-1)
            conns, els = [], []
            for bits, other, lst, vlst, m, grid, is_a in (
                    (pa, pb, la, va, m_a, sing_a, True),
                    (pb, pa, lb, vb, m_b, sing_b, False)):
                p = lst[grid[:, 0]]
                q = vlst[grid[:, 1]]
                el = m[p, q] * par(bits, p, q).astype(jnp.float32)
                nb_ = flip(bits, p, q)
                pair = ((nb_, jnp.broadcast_to(other, nb_.shape)) if is_a
                        else (jnp.broadcast_to(other, nb_.shape), nb_))
                conns.append(jnp.stack(pair, -1))
                els.append(el)
            for bits, other, lst, vlst, grid, is_a in (
                    (pa, pb, la, va, dbl_a, True),
                    (pb, pa, lb, vb, dbl_b, False)):
                p, r = lst[grid[:, 0]], lst[grid[:, 1]]
                q, s = vlst[grid[:, 2]], vlst[grid[:, 3]]
                s1 = par(bits, p, q)
                mid = flip(bits, p, q)
                s2 = par(mid, r, s)
                el = (h2g(p, q, r, s) - h2g(p, s, r, q)) \
                    * (s1 * s2).astype(jnp.float32)
                nb_ = flip(mid, r, s)
                pair = ((nb_, jnp.broadcast_to(other, nb_.shape)) if is_a
                        else (jnp.broadcast_to(other, nb_.shape), nb_))
                conns.append(jnp.stack(pair, -1))
                els.append(el)
            p = la[ab[:, 0]]
            q = va[ab[:, 1]]
            r = lb[ab[:, 2]]
            s = vb[ab[:, 3]]
            sign = (par(pa, p, q) * par(pb, r, s)).astype(jnp.float32)
            els.append(h2g(p, q, r, s) * sign)
            conns.append(jnp.stack([flip(pa, p, q), flip(pb, r, s)], -1))
            conn = jnp.concatenate(conns, 0)
            el = jnp.concatenate(els, 0)
            return conn, el

        @jax.jit
        def fn(packed):
            conn, el = jax.vmap(per_det)(packed[:, 0], packed[:, 1])
            outs = []
            outs.append(conn if emit_conn else conn.sum())
            outs.append(el if emit_elems else el.sum())
            return tuple(outs)
        return fn

    def make_lists_only(fn):
        @jax.jit
        def lists_only(packed):
            def per_det(pa, pb):
                la, va = fn(pa, n, ka)
                lb, vb = fn(pb, n, kb)
                return la.sum() + va.sum() + lb.sum() + vb.sum()
            return jax.vmap(per_det)(packed[:, 0], packed[:, 1]).sum()
        return lists_only

    return {
        "v1_full": make_connection_fn(h.tables),
        "v1_rebuilt": make_v1(),
        "v1_no_elem_write": make_v1(emit_elems=False),
        "v1_no_conn_write": make_v1(emit_conn=False),
        "v1_scalar_out": make_v1(emit_conn=False, emit_elems=False),
        "v1_no_h2gather": make_v1(use_gather=False),
        "v1_mm_lists": make_v1(lists_fn=_occ_vir_lists_matmul),
        "v1_no_parity": make_v1(use_parity=False),
        "lists_only": make_lists_only(_occ_vir_lists_jax),
        "lists_only_mm": make_lists_only(_occ_vir_lists_matmul),
    }


def measure(h, iters=20):
    import jax
    import jax.numpy as jnp
    basis = h.enumerate_basis()
    rng = np.random.default_rng(0)
    batch = jnp.asarray(basis[rng.permutation(len(basis))])
    B, C = len(basis), h.n_connections
    total = B * C
    fns = _variants(h)
    rows = {}
    for name, fn in fns.items():
        out = fn(batch)
        jax.block_until_ready(out)
        # iteration scaling: 2 and `iters` reps separate per-call dispatch
        # overhead from true device time
        times = {}
        for reps in (2, iters):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(batch)
            jax.block_until_ready(out)
            times[reps] = time.perf_counter() - t0
        # slope = device time/call; intercept = per-call overhead
        per_call = (times[iters] - times[2]) / (iters - 2)
        rate = total / per_call / 1e6
        rows[name] = (per_call * 1e3, rate)
        print(f"{name:>20}: {per_call * 1e3:8.2f} ms/call  "
              f"{rate:8.1f} M conn/s")
    print(json.dumps({k: {"ms": round(v[0], 2), "Mconn_s": round(v[1], 1)}
                      for k, v in rows.items()}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--measure", action="store_true",
                    help="time ablated variants on the device")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    from flow_guided_krylov_tpu.utils.device_peaks import peaks_for
    h = build_system()
    analytic(h, peaks_for(jax.devices()[0].device_kind))
    if args.measure:
        from flow_guided_krylov_tpu.utils.profiling import \
            enable_compilation_cache
        enable_compilation_cache()
        measure(h, args.iters)
