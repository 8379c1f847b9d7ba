"""Which brute-force engine each entry point picks, by platform.

The compiled Pallas kernel runs only on a GPU; everywhere else the jnp row
path is the engine. The backend is faked here, so these tests check the
choice without running the GPU kernel.
"""

import jax
import pytest

from nbody_jax import GravityConfig, Simulation, random_system
from nbody_jax.bench import registry
from nbody_jax.ops import brute_force, pallas_brute
from nbody_jax.parallel import ring


@pytest.fixture(params=["cpu", "gpu"])
def backend(request, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: request.param)
    return request.param


def test_registry_lists_kernel_only_on_gpu(backend):
    names = {m.name for m in registry.methods_for_tiers("a")}
    assert "BruteForce_JNP" in names
    assert ("BruteForce_Pallas" in names) == (backend == "gpu")
    assert registry.get("BruteForce_Pallas").gpu_only


def test_reference_method_by_platform(backend):
    want = "BruteForce_Pallas" if backend == "gpu" else "BruteForce_JNP"
    assert registry.reference_method_for(1 << 20).name == want
    assert registry.reference_method_for(1000).name == want


def test_simulation_brute_by_platform(backend, rng_key):
    sim = Simulation.create(random_system(rng_key, 8, dim=2),
                            GravityConfig(), method="brute")
    want = (pallas_brute.brute_force_pallas if backend == "gpu"
            else brute_force.brute_force_blocked)
    assert sim.forces_fn.func is want


def test_ring_engines_by_platform(backend):
    symmetric, local, sym = ring.ring_engines()
    if backend == "gpu":
        assert (symmetric, local, sym) == (
            False, pallas_brute.pallas_local_accel, None)
    else:
        assert symmetric
        assert local is brute_force.accel_rows_blocked
        assert sym is brute_force.accel_rows_sym_blocked


def test_ring_engines_explicit_choices(backend):
    """A one-sided custom engine turns Newton-3 off; asking for it with no
    symmetric engine gets the blocked jnp tile on any platform."""
    def custom(t, s, m, soft):
        return t

    assert ring.ring_engines(local_accel=custom) == (False, custom, None)
    sym_on = ring.ring_engines(local_accel=custom, symmetric=True)
    assert sym_on == (True, custom, brute_force.accel_rows_sym_blocked)
