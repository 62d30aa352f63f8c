#!/usr/bin/env python
"""Standalone CCSD(/T) oracle for a registered benchmark system.

Runs on the HOST only (no device), so it can compute the beyond-FCI
error bar for a frontier system concurrently with device solver runs:

    JAX_PLATFORMS=cpu python tools/ccsd_bar.py --system ozone_ccpvdz_full

Prints one JSON line with ccsd_energy / ccsd_converged (and the (T)
fields when the triples tensor fits the gate); merge against the SCI
final energy by hand or via examples/large_system_benchmark.py.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))), "examples"))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--system", default="ozone_ccpvdz_full")
    p.add_argument("--triples", action="store_true",
                   help="force (T) even past the default memory gate")
    args = p.parse_args()

    from large_system_benchmark import SYSTEMS
    from flow_guided_krylov_tpu.chem.ccsd import run_ccsd

    h = SYSTEMS[args.system]()
    ints = h.integrals
    no = ints.n_electrons
    nv = 2 * ints.n_orbitals - no
    do_t = args.triples or (no ** 3 * nv ** 3 * 8 < 8e9)
    t0 = time.time()
    cc = run_ccsd(ints, do_triples=do_t, verbose=True)
    out = {"system": args.system, "n_active_orbitals": ints.n_orbitals,
           "n_active_electrons": no,
           "ccsd_energy": cc.e_tot, "ccsd_corr": cc.e_corr,
           "ccsd_converged": bool(cc.converged),
           "hf_energy": ints.hf_energy,
           "wall_s": round(time.time() - t0, 1)}
    if cc.e_triples is not None:
        out["ccsd_t_energy"] = cc.e_tot_t
        out["triples_corr"] = cc.e_triples
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
