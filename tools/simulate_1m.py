"""End-to-end stepping proof at scale: N=1M leapfrog on a Plummer sphere.

BASELINE.json's config list names "leapfrog dt=0.01"; this tool runs the
full stepping loop (not just force evals) at N=1M on the current backend
and records per-step wall time plus total-energy drift in a JSON file.

Uses G=1 Plummer units (cold-start Plummer sphere): in reference units
(G=4.47e-21, |x|~1e7) accelerations are ~1e-25 and fp32 positions provably
don't move (CLAUDE.md gotcha), so energy drift would be vacuously zero.
The Plummer sphere is also the *clustered* stress case (dense core → max
leaf occupancy ≫ mean), so the default force method is the adaptive
radix-BVH tier: the uniform grid's `check_grid_capacity` guard correctly
refuses this input (measured at N=1M 3D: 894,336 of 1,048,576 bodies land
in ONE leaf cell at the auto level). `--method bh-grid` keeps the grid
path for quasi-uniform inputs.

Run:  python tools/simulate_1m.py [--n 1048576] [--steps 10] [--out PATH]
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
from nbody_jax.integrators import leapfrog_step_carried
from nbody_jax.ops.brute_force import kinetic_energy, potential_energy_blocked
from nbody_jax.ops.bvh import bvh_forces
from nbody_jax.ops.grid_tree import barnes_hut_grid


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_048_576)
    ap.add_argument("--dim", type=int, default=3, choices=(2, 3))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--theta", type=float, default=0.5)
    ap.add_argument("--method", default="bvh", choices=("bvh", "bh-grid"))
    ap.add_argument("--dist", default="plummer",
                    choices=("plummer", "uniform"),
                    help="plummer = clustered stress case (BVH tier); "
                         "uniform = quasi-uniform cube in [-1,1]^D with "
                         "total mass 1 (grid-tier-friendly)")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "results", "simulate_1m_bh.json"))
    args = ap.parse_args()

    cfg = nb.GravityConfig(G=1.0, softening=0.05)
    if args.dist == "plummer":
        system = nb.plummer_system(jax.random.key(3), args.n, dim=args.dim)
    else:
        kp = jax.random.key(3)
        system = nb.System(
            positions=jax.random.uniform(
                kp, (args.n, args.dim), dtype=jnp.float32,
                minval=-1.0, maxval=1.0),
            velocities=jnp.zeros((args.n, args.dim), jnp.float32),
            masses=jnp.full((args.n,), 1.0 / args.n, jnp.float32))

    # Stepping loops thread a caps dict: the settled escalation capacities
    # of one force eval seed the next (the dense core's high-water counts
    # are stable step to step), so later evals run ONE escalated-subset
    # dispatch at ~1.2x exact caps instead of re-deriving 2x lower bounds.
    bvh_caps: dict = {}

    def forces(pos, mass):
        if args.method == "bvh":
            return bvh_forces(pos, mass, cfg, theta=args.theta,
                              caps_state=bvh_caps)
        return barnes_hut_grid(pos, mass, cfg, theta=args.theta)

    def energy(s):
        ke = float(kinetic_energy(s.velocities, s.masses))
        pe = float(potential_energy_blocked(s.positions, s.masses, cfg,
                                            block_size=2048))
        return ke, pe

    print(f"backend={jax.default_backend()} N={args.n} dim={args.dim} "
          f"steps={args.steps} dt={args.dt} theta={args.theta}")
    ke0, pe0 = energy(system)
    e0 = ke0 + pe0
    print(f"E0 = {e0:.6e} (KE {ke0:.3e}, PE {pe0:.3e})")

    step_times = []
    s = system
    # Carried-acceleration KDK: one force eval per step (integrators.py);
    # the seed eval is timed separately as step 0's share.
    acc = forces(s.positions, s.masses) / s.masses[:, None]
    for i in range(args.steps):
        t0 = time.perf_counter()
        s, acc = leapfrog_step_carried(s, acc, forces, args.dt)
        jax.block_until_ready(s.positions)
        checksum = float(jnp.sum(jnp.abs(s.positions)))
        dt_wall = time.perf_counter() - t0
        step_times.append(dt_wall)
        print(f"step {i + 1:2d}: {dt_wall * 1e3:8.1f} ms  "
              f"checksum {checksum:.6e}")
        if not (checksum > 0 and checksum < float("inf")):
            print("non-finite state — aborting")
            return 1

    ke1, pe1 = energy(s)
    e1 = ke1 + pe1
    drift = abs(e1 - e0) / abs(e0)
    print(f"E{args.steps} = {e1:.6e} (KE {ke1:.3e}, PE {pe1:.3e})")
    print(f"relative energy drift over {args.steps} steps: {drift:.3e}")

    artifact = {
        "backend": jax.default_backend(),
        "n": args.n, "dim": args.dim, "steps": args.steps, "dt": args.dt,
        "theta": args.theta, "integrator": "leapfrog",
        "force_method": ("BVH_Radix(quad)" if args.method == "bvh"
                         else "BarnesHut_Grid(quad)"),
        "distribution": ("plummer_cold (clustered stress case)"
                         if args.dist == "plummer"
                         else "uniform_cube (quasi-uniform)"),
        "units": "G=1 Plummer",
        "softening": cfg.softening,
        "energy_initial": {"kinetic": ke0, "potential": pe0, "total": e0},
        "energy_final": {"kinetic": ke1, "potential": pe1, "total": e1},
        "relative_energy_drift": drift,
        "step_wall_s": [round(t, 4) for t in step_times],
        "step_wall_s_cached_median": round(
            sorted(step_times[1:])[len(step_times[1:]) // 2], 4)
        if len(step_times) > 1 else None,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
