"""Locally-essential-tree (body-sharded) distribution vs single device."""

import jax.numpy as jnp
import numpy as np

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.ops.grid_tree import barnes_hut_grid
from nbody_jax.parallel.let_tree import let_barnes_hut
from nbody_jax.parallel.mesh import make_mesh
from nbody_jax.utils.accuracy import scale_normalized_error

import pytest

pytestmark = pytest.mark.slow


def test_let_bh_matches_single_device(rng_key, dim):
    sys = random_system(rng_key, 700, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    # Same explicit leaf level on both sides so the trees are identical.
    L = 2 if dim == 3 else 3
    single = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5,
                             leaf_level=L)
    sharded = let_barnes_hut(sys.positions, sys.masses, cfg,
                             mesh=make_mesh(), theta=0.5, leaf_level=L)
    assert np.all(np.isfinite(np.asarray(sharded)))
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-8, atol=1e-30)


def test_let_bh_accuracy_vs_direct(rng_key):
    sys = random_system(rng_key, 1500, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = let_barnes_hut(sys.positions, sys.masses, cfg, mesh=make_mesh(),
                         theta=0.5, leaf_level=3)
    err = float(scale_normalized_error(got, want))
    assert err < 1e-2, err


def test_let_bh_nondivisible_n(rng_key):
    # N not divisible by shards*8 exercises the padding/idx=-1 path.
    sys = random_system(rng_key, 333, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    single = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5,
                             leaf_level=2)
    sharded = let_barnes_hut(sys.positions, sys.masses, cfg,
                             mesh=make_mesh(), theta=0.5, leaf_level=2)
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-8, atol=1e-30)


def test_let_bh_overflow_poisons(rng_key):
    # Absurdly small halo capacity must poison with NaN, never truncate.
    sys = random_system(rng_key, 700, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    out = let_barnes_hut(sys.positions, sys.masses, cfg, mesh=make_mesh(),
                         theta=0.5, leaf_level=3, halo_cap=8)
    assert not bool(jnp.all(jnp.isfinite(out)))


def test_let_fmm_matches_single_device(rng_key, dim):
    from nbody_jax.ops.fmm import fmm_forces
    from nbody_jax.parallel.let_tree import let_fmm
    sys = random_system(rng_key, 700, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    L = 2 if dim == 3 else 3
    single = fmm_forces(sys.positions, sys.masses, cfg, order=4,
                        leaf_level=L)
    sharded = let_fmm(sys.positions, sys.masses, cfg, mesh=make_mesh(),
                      order=4, leaf_level=L)
    assert np.all(np.isfinite(np.asarray(sharded)))
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-7, atol=1e-30)


def test_let_fmm_gate(rng_key):
    """LET FMM passes the 1e-4 fidelity gate at order 8 (BASELINE.json)."""
    from nbody_jax.parallel.let_tree import let_fmm
    sys = random_system(rng_key, 1200, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = let_fmm(sys.positions, sys.masses, cfg, mesh=make_mesh(),
                  order=8, leaf_level=3)
    err = float(scale_normalized_error(got, want))
    assert err < 1e-4, err


def test_let_bh_clustered_plummer_default_knobs(rng_key):
    """Plummer core through the LET BH path with NO hand-tuned knobs: the
    exchange bucket is sized by the exact data probe, the halo list by the
    exact geometric peak (VERDICT r2 weak item 5)."""
    from nbody_jax.models import plummer_sphere
    sys, cfg = plummer_sphere(rng_key, 600, dtype=jnp.float64)
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = let_barnes_hut(sys.positions, sys.masses, cfg, mesh=make_mesh(),
                         theta=0.25)
    assert np.all(np.isfinite(np.asarray(got)))
    assert float(scale_normalized_error(got, want)) < 1e-3
