"""Scenario models: orbits, conservation, structure."""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from nbody_jax import brute_force_direct, simulate
from nbody_jax.models import (
    plummer_sphere,
    solar_system,
    spiral_galaxy,
    two_body_circular_orbit,
    uniform_random,
)


def forces_for(cfg):
    return functools.partial(brute_force_direct, config=cfg)


def test_uniform_random_matches_reference_distribution(rng_key):
    sys, cfg = uniform_random(rng_key, 256)
    assert cfg.G == 4.471e-21
    assert float(jnp.max(sys.positions)) <= 1e7


def test_two_body_orbit_closes():
    """One full period of the analytic binary returns to the start."""
    sys, cfg = two_body_circular_orbit()
    period = 4.0 * np.pi
    steps = 2000
    final, _ = simulate(sys, forces_for(cfg), dt=period / steps,
                        num_steps=steps, integrator="leapfrog")
    np.testing.assert_allclose(np.asarray(final.positions),
                               np.asarray(sys.positions), atol=5e-3)
    # Separation stays ~2 throughout implies circularity at endpoints.
    sep = np.linalg.norm(np.asarray(final.positions[0] -
                                    final.positions[1]))
    np.testing.assert_allclose(sep, 2.0, rtol=1e-3)


def test_spiral_galaxy_angular_momentum(rng_key):
    sys, cfg = spiral_galaxy(rng_key, 200, dtype=jnp.float64)
    # Net angular momentum is strongly nonzero (rotating disk).
    L = jnp.sum(sys.masses * (sys.positions[:, 0] * sys.velocities[:, 1]
                              - sys.positions[:, 1] * sys.velocities[:, 0]))
    assert float(L) > 0.05
    final, _ = simulate(sys, forces_for(cfg), dt=1e-3, num_steps=100,
                        integrator="leapfrog")
    L2 = jnp.sum(final.masses * (final.positions[:, 0] * final.velocities[:, 1]
                                 - final.positions[:, 1] * final.velocities[:, 0]))
    np.testing.assert_allclose(float(L2), float(L), rtol=1e-5)


def test_solar_system_earth_period():
    """Earth (index 3) completes one orbit in t=1 yr (G = 4π² units)."""
    sys, cfg = solar_system()
    steps = 3000
    final, _ = simulate(sys, forces_for(cfg), dt=1.0 / steps,
                        num_steps=steps, integrator="leapfrog")
    earth0 = np.asarray(sys.positions[3])
    earth1 = np.asarray(final.positions[3])
    np.testing.assert_allclose(earth1, earth0, atol=2e-2)


def test_solar_system_warns_without_x64():
    """float64 request with x64 off would silently downcast — must warn."""
    import pytest
    with jax.enable_x64(False):
        with pytest.warns(UserWarning, match="float64"):
            solar_system()


def test_plummer_virial(rng_key):
    sys, cfg = plummer_sphere(rng_key, 300, dtype=jnp.float64)
    assert np.isclose(float(jnp.sum(sys.masses)), 1.0, rtol=1e-6)
