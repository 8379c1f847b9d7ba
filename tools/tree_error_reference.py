"""Sampled float64 error of the registry's tree tiers on the current backend.

Runs each named method once at N bodies and reports its scale-normalized
error against a float64 direct sum on ``--rows`` sampled target rows, one
JSON line per method. Run it with ``JAX_PLATFORMS=cpu`` to get the float32
CPU errors from which chip_smoke.py's tree bounds are set (three times
these, same N and seed).

    JAX_PLATFORMS=cpu python tools/tree_error_reference.py -N 1048576 --dim 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import nbody_jax as nb
from nbody_jax.bench import registry
from nbody_jax.utils.accuracy import (sample_rows, sampled_reference_forces,
                                      scale_normalized_error)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-N", type=int, default=1 << 20)
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--methods", nargs="+",
                    default=["BarnesHut_Grid", "BVH_Radix", "FMM_Chebyshev"])
    args = ap.parse_args(argv)
    cfg = nb.GravityConfig()
    system = nb.random_system(jax.random.key(args.seed), args.N, dim=args.dim,
                              dtype=jnp.float32)
    rows = sample_rows(args.N, args.rows, args.seed)
    ref = sampled_reference_forces(jax.device_get(system.positions),
                                   jax.device_get(system.masses), rows, cfg)
    for name in args.methods:
        t0 = time.perf_counter()
        forces = jax.block_until_ready(registry.get(name).fn(
            system.positions, system.masses, cfg, nb.TreeConfig()))
        err = float(scale_normalized_error(jax.device_get(forces)[rows], ref))
        print(json.dumps({
            "method": name, "N": args.N, "dim": args.dim, "seed": args.seed,
            "rows": int(rows.size), "err": err,
            "seconds": time.perf_counter() - t0,
            "platform": jax.devices()[0].platform}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
