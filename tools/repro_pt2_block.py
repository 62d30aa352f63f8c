#!/usr/bin/env python
"""Exercise ONE production-scale PT2 device-scoring block on the GPU
— the fused program (connection kernel + sort + segment-sum +
approx_max_k) at the exact block shape the deep-SCI runs compile.

Round-5 regression guard: the first v3 (pair-factorized) kernel measured
fine standalone at B=2048 but OOMed inside this fused program at the
production S_blk=32768 (its 4D einsum intermediate was too large).  Standalone kernel benchmarks do NOT certify the scoring path;
this does.

    python tools/repro_pt2_block.py --system n2_ccpvdz --rows 32768
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--system", default="n2_ccpvdz")
    p.add_argument("--rows", type=int, default=0,
                   help="source rows (0 = the expander's own S_blk)")
    p.add_argument("--iters", type=int, default=3)
    args = p.parse_args()

    from flow_guided_krylov_tpu.utils.profiling import \
        enable_compilation_cache
    enable_compilation_cache()
    import jax

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "examples"))
    from large_system_benchmark import SYSTEMS
    from flow_guided_krylov_tpu.krylov import (ResidualExpansionConfig,
                                               SelectedCIExpander)
    from flow_guided_krylov_tpu.ops.slater import connection_kernel_choice

    h = SYSTEMS[args.system]()
    cfg = ResidualExpansionConfig(
        max_iterations=1, configs_per_iteration=600,
        residual_threshold=1e-4, max_basis_size=min(h.n_valid_configs,
                                                    50_000))
    ex = SelectedCIExpander(h, cfg)
    print(f"system={args.system} n_orb={h.n_orbitals} "
          f"C={h.n_connections} kernel={connection_kernel_choice(h.tables)}",
          flush=True)

    rng = np.random.default_rng(0)
    hf = h.get_hf_state()
    S = args.rows or 32768
    # random sources from repeated HF perturbations: exact dets don't
    # matter for the program-shape/memory question
    src = np.repeat(hf[None, :], S, axis=0)
    src_c = rng.normal(size=S)
    src_c /= np.linalg.norm(src_c)

    t0 = time.perf_counter()
    cand, coup = ex._pt2_topk_device(src, src_c)
    t_compile = time.perf_counter() - t0
    print(f"first call (compile+run): {t_compile:.1f} s, "
          f"cand={cand.shape} coup={coup.shape}", flush=True)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        cand, coup = ex._pt2_topk_device(src, src_c)
    dt = (time.perf_counter() - t0) / args.iters
    rate = S * h.n_connections / dt
    print(f"steady: {dt*1e3:.1f} ms/block, {rate/1e6:.1f} M elem/s "
          f"({S} rows x {h.n_connections} conns)", flush=True)


if __name__ == "__main__":
    main()
