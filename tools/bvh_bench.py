"""BVH tier timing on the GPU: far_impl and traversal-knob sweeps.

Times the full bvh_forces call (build + traversal + unsort, escalation
settled by a warm-up call) with ``jax.block_until_ready``, for each
requested (N, dim) at theta, over a grid of far_impl × group_size ×
leaf_size × batch; a checksum of the forces is printed beside each time.
Companion to tools/tree_phase_bench.py for re-measuring the BVH defaults
on the GPU (ROADMAP).

Usage: python tools/bvh_bench.py [--cases 100000:2,200000:2,100000:3]
                                 [--theta 0.25] [--impls point,local]
                                 [--group-sizes 128] [--leaf-sizes 16]
                                 [--batches 128]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import nbody_jax as nb
from nbody_jax.ops.bvh import bvh_forces


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="100000:2,200000:2,100000:3")
    ap.add_argument("--theta", type=float, default=0.25)
    ap.add_argument("--impls", default="point,local")
    ap.add_argument("--group-sizes", default="")
    ap.add_argument("--leaf-sizes", default="")
    ap.add_argument("--batches", default="")
    ap.add_argument("--frontier-widths", default="")
    ap.add_argument("--near-caps", default="")
    args = ap.parse_args()

    ints = lambda s, default: [int(x) for x in s.split(",")] if s else [default]
    cfg = nb.GravityConfig()
    print(f"backend={jax.default_backend()} theta={args.theta}")
    for case in args.cases.split(","):
        n_s, d_s = case.split(":")
        n, dim = int(n_s), int(d_s)
        system = nb.random_system(jax.random.key(7), n, dim=dim,
                                  dtype=jnp.float32)
        for impl in args.impls.split(","):
            for gs in ints(args.group_sizes, None):
                for ls in ints(args.leaf_sizes, 16):
                    for b in ints(args.batches, 128):
                        for fw in ints(args.frontier_widths, None):
                            for nc in ints(args.near_caps, None):
                                def run():
                                    return jax.block_until_ready(bvh_forces(
                                        system.positions, system.masses,
                                        cfg, theta=args.theta,
                                        far_impl=impl, group_size=gs,
                                        leaf_size=ls, batch=b,
                                        frontier_width=fw, near_cap=nc))
                                run()  # compile+warmup (settles escalation)
                                t0 = time.perf_counter()
                                f = run()
                                dt = time.perf_counter() - t0
                                chk = float(jnp.sum(jnp.abs(f)))
                                print(
                                    f"N={n:>8} {dim}D {impl:<6} "
                                    f"G={gs or '-':>4} S={ls:>3} b={b:>4} "
                                    f"W={fw or '-':>5} NL={nc or '-':>5} "
                                    f"{dt*1e3:9.1f} ms  "
                                    f"checksum={chk:.6e}", flush=True)


if __name__ == "__main__":
    main()
