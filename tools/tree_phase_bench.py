"""Phase-level timing of the tree tiers on the current backend.

Times, separately: grid-tree build (quantize/sort/aggregate/slots), BH far
field only, BH near field only, BH full, and the FMM phases via its
``_debug_skip`` ablation knob. All timings are cached-execution (second run),
each ended by fetching a checksum of its result.

Usage: python tools/tree_phase_bench.py [--n 1048576] [--dim 2] [--fmm]
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import nbody_jax as nb
from nbody_jax.ops.grid_tree import (
    auto_leaf_level, build_grid_tree, compute_capacity,
    grid_tree_accel_sorted, theta_to_ring)
from nbody_jax.ops.fmm import fmm_accel_sorted


def timed(label, fn):
    fn()  # compile + warmup
    t0 = time.perf_counter()
    fn()
    dt = time.perf_counter() - t0
    print(f"{label:44s} {dt*1e3:9.1f} ms")
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--fmm", action="store_true")
    ap.add_argument("--order", type=int, default=5)
    args = ap.parse_args()

    cfg = nb.GravityConfig()
    system = nb.random_system(jax.random.key(7), args.n, dim=args.dim,
                              dtype=jnp.float32)
    pos, mass = system.positions, system.masses
    # Mirror the driver paths' level choice: barnes_hut_grid scales the
    # target occupancy by the near-ring radius k (wide θ=0.25 rings want
    # emptier leaves — occ 32 at k=3 in 3D OOMs the [B, 343, TWR, 4] near
    # tensor); FMM uses ring=1.
    if args.fmm:
        L = auto_leaf_level(args.n, args.dim, target_occupancy=32)
    else:
        L = auto_leaf_level(args.n, args.dim, k=theta_to_ring(args.theta))
    cap = compute_capacity(pos, L)
    soft = float(cfg.softening)
    print(f"backend={jax.default_backend()} N={args.n} dim={args.dim} "
          f"L={L} capacity={cap}")

    build = functools.partial(build_grid_tree, leaf_level=L, capacity=cap,
                              quad=not args.fmm)

    def run_build():
        t = build(pos, mass)
        return float(jnp.sum(t.pos_sorted))
    timed("build_grid_tree", run_build)

    tree = build(pos, mass)

    if args.fmm:
        for skip, label in ((None, "fmm full"),
                            ("m2l", "fmm skip m2l"),
                            ("l2p", "fmm skip l2p"),
                            ("p2p", "fmm skip p2p"),
                            ("m2l,l2p,p2p", "fmm p2m+sweeps only")):
            def run(skip=skip):
                acc = fmm_accel_sorted(
                    tree, order=args.order, ring=1, softening=soft,
                    _debug_skip=skip or "")
                return float(jnp.sum(jnp.abs(acc)))
            timed(label, run)
    else:
        k = theta_to_ring(args.theta)

        for skip, far_impl, label in (
                ("", "point", f"bh eval full (k={k})"),
                ("near", "point", "bh far only"),
                ("far", "point", "bh near only"),
                ("far,near", "point", "bh scatter/slots only"),
                ("", "local", "bh eval full (local far)"),
                ("near", "local", "bh far only (local)"),
                ("", "local_leaf", "bh eval full (local_leaf far)"),
                ("near", "local_leaf", "bh far only (local_leaf)")):
            def run_bh(skip=skip, far_impl=far_impl):
                acc = grid_tree_accel_sorted(tree, k=k, softening=soft,
                                             multipole="quad",
                                             far_impl=far_impl,
                                             _debug_skip=skip)
                return float(jnp.sum(jnp.abs(acc)))
            timed(label, run_bh)


if __name__ == "__main__":
    main()
