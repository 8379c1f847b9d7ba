"""The device-step timing tool's jittable adapters stay traceable."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct


@pytest.mark.parametrize("name", [
    "BruteForce_JNP", "BarnesHut_Grid", "BarnesHut_Grid_Theta05",
    "BVH_Radix", "FMM_Chebyshev"])
def test_adapters_jit_and_match(rng_key, name):
    """Each adapter compiles under jit/scan and agrees with the un-jitted
    driver's force law on the initial state."""
    import device_step_bench as dsb
    sys_ = random_system(rng_key, 512, dim=2, dtype=jnp.float32)
    cfg = GravityConfig()
    fn = dsb.jittable_force_fn(name, sys_.positions, sys_.masses, cfg)
    f = np.asarray(fn(sys_.positions, sys_.masses))
    want = np.asarray(brute_force_direct(sys_.positions, sys_.masses, cfg))
    scale = np.abs(want).max()
    assert np.isfinite(f).all()
    # Loose gate: same force law, approximate methods allowed their error.
    assert np.abs(f - want).max() / scale < 5e-2

    # The timer returns a positive per-step time for the scan it ran.
    t, k = dsb.measure(name, sys_, cfg, steps=2)
    assert t > 0 and k == 2
