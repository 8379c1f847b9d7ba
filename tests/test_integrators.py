import functools

import jax
import jax.numpy as jnp
import numpy as np

from nbody_jax import (
    GravityConfig,
    brute_force_direct,
    euler_step,
    kinetic_energy,
    leapfrog_step,
    plummer_system,
    potential_energy,
    random_system,
    simulate,
)


def forces_fn_for(cfg):
    return functools.partial(brute_force_direct, config=cfg)


def test_euler_semantics(rng_key):
    """v += F/m·dt then x += (new v)·dt — parity with methods.cpp:426-450."""
    sys = random_system(rng_key, 32, dim=3, dtype=jnp.float64)
    cfg = GravityConfig()
    dt = 0.1
    f = brute_force_direct(sys.positions, sys.masses, cfg)
    v_want = sys.velocities + f / sys.masses[:, None] * dt
    x_want = sys.positions + v_want * dt
    out = euler_step(sys, forces_fn_for(cfg), dt)
    np.testing.assert_allclose(np.asarray(out.velocities), np.asarray(v_want))
    np.testing.assert_allclose(np.asarray(out.positions), np.asarray(x_want))


def test_leapfrog_energy_conservation(rng_key):
    """KDK leapfrog on a softened Plummer sphere conserves E to O(dt²)."""
    sys = plummer_system(rng_key, 64, dim=3, dtype=jnp.float64,
                         total_mass=1.0, scale_radius=1.0)
    cfg = GravityConfig(G=1.0, softening=0.1)
    fn = forces_fn_for(cfg)

    def energy(s):
        return float(kinetic_energy(s.velocities, s.masses)
                     + potential_energy(s.positions, s.masses, cfg))

    e0 = energy(sys)
    final, _ = simulate(sys, fn, dt=1e-3, num_steps=100,
                        integrator="leapfrog")
    e1 = energy(final)
    assert abs(e1 - e0) / abs(e0) < 1e-3


def test_leapfrog_time_reversibility(rng_key):
    sys = plummer_system(rng_key, 32, dim=2, dtype=jnp.float64)
    cfg = GravityConfig(G=1.0, softening=0.1)
    fn = forces_fn_for(cfg)
    fwd, _ = simulate(sys, fn, dt=1e-3, num_steps=50, integrator="leapfrog")
    flipped = fwd.replace(velocities=-fwd.velocities)
    back, _ = simulate(flipped, fn, dt=1e-3, num_steps=50,
                       integrator="leapfrog")
    np.testing.assert_allclose(np.asarray(back.positions),
                               np.asarray(sys.positions), atol=1e-8)


def test_simulate_jits(rng_key):
    sys = random_system(rng_key, 16, dim=2, dtype=jnp.float32)
    cfg = GravityConfig()
    fn = forces_fn_for(cfg)
    run = jax.jit(functools.partial(simulate, forces_fn=fn, dt=0.01,
                                    num_steps=5, integrator="euler"))
    out, _ = run(sys)
    assert out.positions.shape == sys.positions.shape
    assert np.all(np.isfinite(np.asarray(out.positions)))


def test_potential_energy_blocked_matches_dense(rng_key):
    """potential_energy_blocked (the N>=1e6-scalable tiling used by
    tools/simulate_1m.py) must agree with the dense version, including
    when N is not a multiple of the block (zero-mass padding rows all sit
    at the origin and must be excluded by the coincident-pair guard)."""
    from nbody_jax.ops.brute_force import potential_energy_blocked
    cfg = GravityConfig(G=1.0, softening=0.05)
    sys = plummer_system(rng_key, 333, dim=3)
    dense = float(potential_energy(sys.positions, sys.masses, cfg))
    blocked = float(potential_energy_blocked(sys.positions, sys.masses,
                                             cfg, block_size=128))
    np.testing.assert_allclose(blocked, dense, rtol=1e-5)
    assert dense < 0  # bound system


def test_leapfrog_carried_matches_chained(rng_key):
    """simulate()'s carried-acceleration KDK (one force eval/step) must
    reproduce the chained two-eval leapfrog_step trajectory exactly —
    the recomputed a0 of step k+1 IS step k's a1."""
    from nbody_jax.config import GravityConfig
    from nbody_jax.integrators import leapfrog_step, simulate
    from nbody_jax.ops.brute_force import brute_force_direct
    from nbody_jax.state import random_system
    sys_ = random_system(rng_key, 256, dim=3, dtype=jnp.float64)
    cfg = GravityConfig(G=1.0, softening=0.1)
    fn = lambda p, m: brute_force_direct(p, m, cfg)
    want = sys_
    for _ in range(6):
        want = leapfrog_step(want, fn, 0.01)
    got, _ = simulate(sys_, fn, 0.01, 6, integrator="leapfrog")
    np.testing.assert_allclose(np.asarray(got.positions),
                               np.asarray(want.positions), rtol=1e-13)
    np.testing.assert_allclose(np.asarray(got.velocities),
                               np.asarray(want.velocities), rtol=1e-13)
