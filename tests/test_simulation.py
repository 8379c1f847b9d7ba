import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_jax.models import plummer_sphere, two_body_circular_orbit
from nbody_jax.simulation import Simulation, available_methods


def test_available_methods():
    assert set(available_methods()) == {"brute", "barnes_hut", "bvh", "fmm"}


def test_create_and_run_each_method(rng_key):
    sys, cfg = plummer_sphere(rng_key, 64, dtype=jnp.float64)
    for method in available_methods():
        sim = Simulation.create(sys, cfg, method=method)
        sim2 = sim.run(steps=2, dt=1e-4)
        assert sim2.step_count == 2
        assert np.all(np.isfinite(np.asarray(sim2.system.positions)))


def test_energy_conservation_through_api(rng_key):
    sys, cfg = plummer_sphere(rng_key, 64, dtype=jnp.float64)
    sim = Simulation.create(sys, cfg, method="brute")
    e0 = sim.energy()["total"]
    sim = sim.run(steps=50, dt=1e-3)
    e1 = sim.energy()["total"]
    assert abs(e1 - e0) / abs(e0) < 1e-3


def test_save_load_roundtrip(rng_key, tmp_path):
    sys, cfg = two_body_circular_orbit()
    sim = Simulation.create(sys, cfg).run(steps=10, dt=1e-3)
    sim.save(str(tmp_path))
    sim2 = Simulation.load(str(tmp_path), cfg)
    assert sim2.step_count == 10
    np.testing.assert_array_equal(np.asarray(sim2.system.positions),
                                  np.asarray(sim.system.positions))


def test_bad_method_raises(rng_key):
    sys, cfg = two_body_circular_orbit()
    with pytest.raises(ValueError):
        Simulation.create(sys, cfg, method="magic")
    with pytest.raises(ValueError):
        Simulation.create(sys, cfg, integrator="rk9")
