"""Cross-language oracle: C++/OpenMP vs JAX implementations."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.ops import keys as K
from nbody_jax.utils import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native oracle not built (make -C native)")


def test_native_forces_match_jax(rng_key, dim):
    sys = random_system(rng_key, 256, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = np.asarray(brute_force_direct(sys.positions, sys.masses, cfg))
    got = native.brute_force_native(np.asarray(sys.positions),
                                    np.asarray(sys.masses),
                                    cfg.G, cfg.softening)
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_native_hilbert_matches_jax(rng_key, dim):
    bits = K.MAX_BITS[dim]
    sys = random_system(rng_key, 1000, dim=dim)
    coords = np.asarray(K.quantize(sys.positions, bits))
    want = np.asarray(K.hilbert_key_from_coords(jnp.asarray(coords), bits))
    got = native.hilbert_keys_native(coords, bits)
    np.testing.assert_array_equal(got, want)
