"""Smoke test of the main path on one NVIDIA GPU: the four force tiers and
a few integration steps, at the reference's real sizes, each checked
against a float64 direct sum.

    python chip_smoke.py            # one GPU: device, brute, trees, stepping
    python chip_smoke.py --multi    # four GPUs: the distributed tiers only

Every phase prints its error beside its bound. The script exits non-zero,
and prints no result line, if JAX finds no GPU or any check fails. Its last
line on success is one JSON object naming the device as JAX reports it.

Bounds and why:

* Brute force, 1e-5 (normalized against the sampled float64 oracle): the
  kernel is exact float32 all-pairs; coordinates at ~1e7 leave float32
  differences ~1e-7 relative, and the compensated sum keeps the error of
  2^20 terms near 1e-6. XLA's ``brute_force_blocked`` is held to the same
  bound, and the two paths to 2e-5 of each other on the same rows (the
  two bounds added).
* FMM order 8, 1e-4: the BASELINE.json accuracy gate.
* Barnes-Hut (θ = 0.25) and BVH: three times the error a CPU float32 run of
  the same code gives at the same N and seed (``TREE_BOUNDS`` below, from
  ``tools/tree_error_reference.py``). The LET BVH of ``--multi`` is held
  to the BVH bound: same MAC, multipoles and θ, other trees.
* Stepping, |ΔE/E| over a few leapfrog steps: 1e-3. The step size makes
  the integrator's own drift far smaller; the bound covers float32 rounding
  of the potential summed over ~1e10 pairs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import nbody_jax as nb
from nbody_jax.bench import registry
from nbody_jax.utils.accuracy import (sample_rows, sampled_reference_forces,
                                      scale_normalized_error)

N_REAL = 1 << 20  # the reference's N = 1e6 row, as a power of two
ROWS = 1024  # sampled oracle target rows, against all N sources
BRUTE_BOUND = 1e-5
BRUTE_VS_XLA_BOUND = 2e-5
FMM_BOUND = 1e-4
# 3 × the CPU float32 error at N = 2^20, 3D, seed 0, 1024 sampled rows
# (tools/tree_error_reference.py: BH 1.177e-4, BVH 1.672e-5; PERF.md).
TREE_BOUNDS = {"BarnesHut_Grid": 3 * 1.177e-4, "BVH_Radix": 3 * 1.672e-5}
STEP_N = 1 << 17
STEPS = 5
STEP_DT = 1e-3
DRIFT_BOUND = 1e-3
MULTI_DEVICES = 4
MULTI_RING_N = 1 << 21  # 2D, ring brute force
MULTI_LET_N = 4_194_304  # 3D, LET BVH


class Checks:
    """Collects (name, value, bound) checks; any miss fails the run."""

    def __init__(self):
        self.failed = []

    def le(self, name, value, bound):
        ok = bool(np.isfinite(value) and value <= bound)
        print(f"  {name}: {value:.3e} (bound {bound:.1e}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(name)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def timed(fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def oracle(system, cfg, seed):
    """(rows, float64 forces on those rows from all N bodies)."""
    rows = sample_rows(system.n, ROWS, seed)
    t0 = time.perf_counter()
    ref = sampled_reference_forces(jax.device_get(system.positions),
                                   jax.device_get(system.masses), rows, cfg)
    print(f"  float64 oracle: {rows.size} rows x {system.n} sources "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return rows, ref


def sampled_error(forces, rows, ref):
    return float(scale_normalized_error(jax.device_get(forces)[rows], ref))


def run_method(name, system, cfg, tree=nb.TreeConfig()):
    fn = registry.get(name).fn
    out, first = timed(fn, system.positions, system.masses, cfg, tree)
    _, again = timed(fn, system.positions, system.masses, cfg, tree)
    print(f"  {name}: first call {first:.2f} s (with compile), "
          f"second {again:.3f} s", flush=True)
    return out


def phase_brute(checks, seed):
    print("phase brute: N=2^20 through the registry's brute method",
          flush=True)
    cfg = nb.GravityConfig()
    method = registry.reference_method_for(N_REAL).name
    assert method == "BruteForce_Pallas", method
    systems = {}
    for dim in (2, 3):
        system = nb.random_system(jax.random.key(seed), N_REAL, dim=dim,
                                  dtype=jnp.float32)
        rows, ref = oracle(system, cfg, seed)
        forces = run_method(method, system, cfg)
        assert forces.shape == (N_REAL, dim)
        checks.le(f"brute {dim}D vs float64", sampled_error(forces, rows, ref),
                  BRUTE_BOUND)
        xla = run_method("BruteForce_JNP", system, cfg)
        checks.le(f"XLA brute_force_blocked {dim}D vs float64",
                  sampled_error(xla, rows, ref), BRUTE_BOUND)
        checks.le(f"brute {dim}D vs XLA brute_force_blocked",
                  float(scale_normalized_error(
                      jax.device_get(forces)[rows],
                      jax.device_get(xla)[rows])), BRUTE_VS_XLA_BOUND)
        systems[dim] = (system, rows, ref)
    return systems[3]


def phase_trees(checks, system, rows, ref):
    print("phase trees: N=2^20 3D through the registry", flush=True)
    cfg = nb.GravityConfig()  # theta = 0.25
    assert cfg.theta == 0.25
    bounds = dict(TREE_BOUNDS, FMM_Chebyshev=FMM_BOUND)
    for name, bound in bounds.items():
        forces = run_method(name, system, cfg)
        checks.le(f"{name} vs float64", sampled_error(forces, rows, ref),
                  bound)


def phase_stepping(checks, seed):
    print(f"phase stepping: Simulation, N=2^17 3D Plummer, {STEPS} leapfrog "
          f"steps of dt={STEP_DT}", flush=True)
    cfg = nb.GravityConfig(G=1.0, softening=0.1)
    system = nb.plummer_system(jax.random.key(seed), STEP_N, dim=3)
    for method in ("brute", "bvh"):
        sim = nb.Simulation.create(system, cfg, method=method)
        e0 = sim.energy()["total"]
        t0 = time.perf_counter()
        sim = sim.run(steps=STEPS, dt=STEP_DT)
        jax.block_until_ready(sim.system.positions)
        dt = time.perf_counter() - t0
        e1 = sim.energy()["total"]
        finite = bool(jnp.all(jnp.isfinite(sim.system.positions))
                      & jnp.all(jnp.isfinite(sim.system.velocities)))
        print(f"  {method}: {STEPS} steps in {dt:.2f} s (with compile), "
              f"E0={e0:.6e} E1={e1:.6e}, finite={finite}", flush=True)
        if not finite:
            checks.failed.append(f"stepping {method} finite")
        checks.le(f"stepping {method} |dE/E|", abs(e1 - e0) / abs(e0),
                  DRIFT_BOUND)


def phase_multi(checks, seed):
    from nbody_jax.parallel.let_bvh import let_bvh
    from nbody_jax.parallel.mesh import make_mesh
    from nbody_jax.parallel.ring import ring_brute_force

    devices = jax.devices()
    if len(devices) != MULTI_DEVICES:
        raise SystemExit(f"--multi needs {MULTI_DEVICES} GPUs, "
                         f"found {len(devices)}")
    mesh = make_mesh(devices)
    cfg = nb.GravityConfig()
    print(f"phase multi: ring brute force, N={MULTI_RING_N} 2D, "
          f"{MULTI_DEVICES} GPUs", flush=True)
    system = nb.random_system(jax.random.key(seed), MULTI_RING_N, dim=2,
                              dtype=jnp.float32)
    rows, ref = oracle(system, cfg, seed)
    fn = lambda p, m: ring_brute_force(p, m, cfg, mesh=mesh)  # noqa: E731
    forces, first = timed(fn, system.positions, system.masses)
    _, again = timed(fn, system.positions, system.masses)
    print(f"  ring: first call {first:.2f} s, second {again:.3f} s",
          flush=True)
    checks.le("ring 2D vs float64", sampled_error(forces, rows, ref),
              BRUTE_BOUND)

    print(f"phase multi: LET BVH, N={MULTI_LET_N} 3D, {MULTI_DEVICES} GPUs",
          flush=True)
    system = nb.random_system(jax.random.key(seed), MULTI_LET_N, dim=3,
                              dtype=jnp.float32)
    rows, ref = oracle(system, cfg, seed)
    fn = lambda p, m: let_bvh(p, m, cfg, mesh=mesh)  # noqa: E731
    forces, first = timed(fn, system.positions, system.masses)
    _, again = timed(fn, system.positions, system.masses)
    print(f"  let_bvh: first call {first:.2f} s, second {again:.3f} s",
          flush=True)
    checks.le("let_bvh 3D vs float64", sampled_error(forces, rows, ref),
              TREE_BOUNDS["BVH_Radix"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help=f"run only the {MULTI_DEVICES}-GPU phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devices = jax.devices()
    dev = devices[0]
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    if dev.platform != "gpu":
        print(f"error: no GPU (JAX platform {dev.platform!r}); refusing to "
              f"run on anything else", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)

    checks = Checks()
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(checks, args.seed)
    else:
        system, rows, ref = phase_brute(checks, args.seed)
        phase_trees(checks, system, rows, ref)
        phase_stepping(checks, args.seed)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if checks.failed:
        print(f"error: failed checks: {checks.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
