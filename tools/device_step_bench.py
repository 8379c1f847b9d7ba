"""Device-resident per-step timing: K integration steps in ONE dispatch.

The sweep's ``Time(s)`` column (reference schema, ``utils.h:88-104``
semantics) times a single force evaluation wall-clock, launch included.
This tool measures a stepping loop: a ``lax.scan`` of K Euler steps (one
force evaluation each) compiled into ONE program, timed with
``jax.block_until_ready`` (median of three runs after a warm-up), divided
by K. Positions really advance each step (velocities are nonzero), so XLA
cannot CSE the force evaluations.

Output: a table + a CSV (``--out``) with schema
``Bodies,Method,Dimension,StepTime(s),Steps`` — a *companion* file; the
reference-schema CSVs are untouched.

Methods are closed over concrete probe results (leaf level, capacity,
traversal caps) taken from the initial state, as any real stepping loop
would be; with reference-unit accelerations (~1e-25) the tree structure
cannot drift over K steps.
"""

from __future__ import annotations

import argparse
import functools
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import nbody_jax as nb
from nbody_jax.integrators import simulate

def jittable_force_fn(name: str, pos, mass, cfg):
    """A jit-safe (static-shape, probe-free) closure for one method, with
    all concrete probes resolved from the initial state."""
    n, dim = pos.shape
    if name == "BruteForce_JNP":
        from nbody_jax.ops.brute_force import brute_force_blocked
        return lambda p, m: brute_force_blocked(p, m, cfg, block_size=1024)
    if name == "BruteForce_Pallas":
        from nbody_jax.ops.pallas_brute import brute_force_pallas
        return lambda p, m: brute_force_pallas(p, m, cfg)
    if name.startswith("BarnesHut_Grid"):
        from nbody_jax.ops.grid_tree import (auto_leaf_level,
                                             barnes_hut_grid,
                                             compute_capacity_cached,
                                             theta_to_ring)
        theta = 0.5 if name.endswith("Theta05") else cfg.theta
        L = auto_leaf_level(n, dim, k=theta_to_ring(theta))
        cap = compute_capacity_cached(pos, L)
        return lambda p, m: barnes_hut_grid(
            p, m, cfg, theta=theta, leaf_level=L, capacity=cap)
    if name == "BVH_Radix":
        # bvh_forces' escalation driver needs concrete stats; the fused
        # kernel with explicit capacities is the traceable core.
        from nbody_jax.ops.bvh import _bvh_fused
        from nbody_jax.ops.keys import MAX_BITS
        g = jnp.asarray(cfg.G, pos.dtype)
        # Mirror bvh_forces' production defaults (G=1024 post round-2
        # group-size sweep) so the artifact reflects the shipped path.
        kw = dict(key_bits=dim * MAX_BITS[dim], quad=True, leaf_size=16,
                  theta=0.25, softening=float(cfg.softening),
                  group_size=min(1024, max(1, n)), batch=128,
                  frontier_width=min(1024 if dim == 2 else 8192, 2 * n),
                  near_cap=min(1024 if dim == 2 else 8192, 2 * n),
                  multipole="quad")
        return lambda p, m: _bvh_fused(p, m, g, **kw)[0]
    if name == "FMM_Chebyshev":
        from nbody_jax.ops.fmm import fmm_forces
        from nbody_jax.ops.grid_tree import (auto_leaf_level,
                                             compute_capacity_cached)
        L = auto_leaf_level(n, dim)
        cap = compute_capacity_cached(pos, L)
        return lambda p, m: fmm_forces(p, m, cfg, order=5, leaf_level=L,
                                       capacity=cap)
    raise ValueError(f"no jittable adapter for {name}")


def measure(name: str, system, cfg, steps: int):
    """(per_step_seconds, steps): median wall time of one ``steps``-long
    scan, ended by ``jax.block_until_ready``, divided by ``steps``."""
    forces_fn = jittable_force_fn(name, system.positions, system.masses,
                                  cfg)
    run = jax.jit(functools.partial(
        simulate, forces_fn=forces_fn, dt=1e-6, num_steps=steps,
        integrator="euler"))
    jax.block_until_ready(run(system))  # compile + warm-up
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(system))
        times.append(time.perf_counter() - t0)
    return max(statistics.median(times) / steps, 1e-9), steps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-N", type=int, nargs="+",
                    default=[1000, 10_000, 100_000])
    ap.add_argument("--dim", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--methods", type=str, default=None,
                    help="comma list; default = all adapters on this "
                         "backend")
    ap.add_argument("--out", type=str,
                    default="results/device_step_times.csv")
    args = ap.parse_args()

    cfg = nb.GravityConfig()
    names = (args.methods.split(",") if args.methods else
             ["BruteForce_JNP", "BruteForce_Pallas", "BarnesHut_Grid",
              "BarnesHut_Grid_Theta05", "BVH_Radix", "FMM_Chebyshev"])
    from nbody_jax.ops.pallas_brute import kernel_available
    if not kernel_available() and "BruteForce_Pallas" in names:
        names.remove("BruteForce_Pallas")

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    # The CSV is KEYED by (Bodies, Method, Dimension): fresh measurements
    # REPLACE stale rows in place rather than appending.
    table: dict[tuple, str] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f.read().splitlines()[1:]:
                if line.strip():
                    b, m, d_, rest = line.split(",", 3)
                    table[(int(b), m, int(d_))] = line
    n_new = 0
    for dim in args.dim:
        for n in args.N:
            system = nb.random_system(jax.random.key(42), n, dim=dim,
                                      dtype=jnp.float32)
            for name in names:
                try:
                    t, k = measure(name, system, cfg, args.steps)
                except Exception as e:  # noqa: BLE001
                    print(f"{name:<24} N={n:>8} {dim}D  ERROR "
                          f"{type(e).__name__}: {e}")
                    continue
                print(f"{name:<24} N={n:>8} {dim}D  "
                      f"{t * 1e3:9.3f} ms/step (scan of {k})")
                table[(n, name, dim)] = f"{n},{name},{dim},{t:.6e},{k}"
                n_new += 1
                with open(args.out, "w") as f:
                    f.write("Bodies,Method,Dimension,StepTime(s),Steps\n")
                    for key in sorted(table):
                        f.write(table[key] + "\n")
    print(f"\n{n_new} rows refreshed in {args.out} "
          f"({len(table)} total, keyed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
