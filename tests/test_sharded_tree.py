"""Sharded tree evaluation on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.grid_tree import barnes_hut_grid
from nbody_jax.parallel.mesh import make_mesh
from nbody_jax.parallel.sharded_tree import barnes_hut_sharded

import pytest

pytestmark = pytest.mark.slow


def test_sharded_bh_matches_single_device(rng_key, dim):
    sys = random_system(rng_key, 400, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    # Same explicit level on both sides (the sharded path would otherwise
    # bump the auto level so every shard owns a leaf).
    single = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5,
                             leaf_level=2)
    mesh = make_mesh()
    sharded = barnes_hut_sharded(sys.positions, sys.masses, cfg,
                                 mesh=mesh, theta=0.5, leaf_level=2)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-10)


def test_sharded_bh_small_tree(rng_key):
    # N small enough that leaf_level is bumped so every shard owns a leaf.
    sys = random_system(rng_key, 40, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    single = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5)
    sharded = barnes_hut_sharded(sys.positions, sys.masses, cfg,
                                 mesh=make_mesh(), theta=0.5)
    # Different leaf levels change the approximation slightly; compare to
    # a direct sum instead for correctness at this scale.
    from nbody_jax.ops.brute_force import brute_force_direct
    from nbody_jax.utils.accuracy import scale_normalized_error
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    assert float(scale_normalized_error(sharded, want)) < 2e-2
    assert np.all(np.isfinite(np.asarray(sharded)))


def test_sharded_bh_two_device_mesh(rng_key):
    sys = random_system(rng_key, 300, dim=3, dtype=jnp.float64)
    cfg = GravityConfig()
    single = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5)
    mesh = make_mesh(jax.devices()[:2])
    sharded = barnes_hut_sharded(sys.positions, sys.masses, cfg,
                                 mesh=mesh, theta=0.5)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-10)


def test_sharded_fmm_matches_single_device(rng_key, dim):
    from nbody_jax.ops.fmm import fmm_forces
    from nbody_jax.parallel.sharded_tree import fmm_sharded
    sys = random_system(rng_key, 400, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    single = fmm_forces(sys.positions, sys.masses, cfg, order=4,
                        leaf_level=2)
    sharded = fmm_sharded(sys.positions, sys.masses, cfg,
                          mesh=make_mesh(), order=4, leaf_level=2)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-8)


def test_sharded_fmm_gate(rng_key):
    """Sharded FMM still passes the 1e-4 fidelity gate."""
    from nbody_jax.ops.brute_force import brute_force_direct
    from nbody_jax.parallel.sharded_tree import fmm_sharded
    from nbody_jax.utils.accuracy import scale_normalized_error
    sys = random_system(rng_key, 1000, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = fmm_sharded(sys.positions, sys.masses, cfg, mesh=make_mesh(),
                      order=8)
    assert float(scale_normalized_error(got, want)) < 1e-4


def test_sharded_bvh_matches_single_device(rng_key):
    from nbody_jax.ops.bvh import bvh_forces
    from nbody_jax.parallel.sharded_tree import bvh_sharded
    sys = random_system(rng_key, 500, dim=3, dtype=jnp.float64)
    cfg = GravityConfig()
    single = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25,
                        group_size=16)
    sharded = bvh_sharded(sys.positions, sys.masses, cfg, mesh=make_mesh(),
                          theta=0.25, group_size=16)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-9)
