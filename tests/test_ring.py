"""Multi-chip ring brute force on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.parallel.mesh import make_mesh
from nbody_jax.parallel.ring import ring_brute_force


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n", [256, 300])  # 300 exercises shard padding
def test_ring_matches_direct(rng_key, dim, n):
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    mesh = make_mesh()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = ring_brute_force(sys.positions, sys.masses, cfg, mesh=mesh)
    assert got.shape == (n, dim)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-8)


def test_ring_on_mesh_subset(rng_key):
    # 2/4-device meshes (even P: the masked half-step) and 3 (odd P) —
    # the default symmetric ring must cover every pair exactly once on all.
    sys = random_system(rng_key, 128, dim=3, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    for k in (2, 3, 4):
        mesh = make_mesh(jax.devices()[:k])
        got = ring_brute_force(sys.positions, sys.masses, cfg, mesh=mesh)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-8)


@pytest.mark.parametrize("n", [256, 300])
def test_ring_one_sided_matches_direct(rng_key, dim, n):
    """The one-sided (P rotations) ring stays available and correct."""
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = ring_brute_force(sys.positions, sys.masses, cfg, mesh=make_mesh(),
                           symmetric=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-8)


def test_ring_symmetric_with_softening(rng_key):
    """Symmetric ring under Plummer softening (guard-off path)."""
    sys = random_system(rng_key, 256, dim=2, dtype=jnp.float64)
    cfg = GravityConfig(softening=1e5)
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = ring_brute_force(sys.positions, sys.masses, cfg, mesh=make_mesh())
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-8)


def test_accel_rows_sym_consistency(rng_key):
    """The two outputs of the Newton-3 tile are the transposed one-sided
    evaluations of the same pair set (f64)."""
    from nbody_jax.ops.brute_force import _accel_rows, _accel_rows_sym
    sys = random_system(rng_key, 96, dim=3, dtype=jnp.float64)
    t_pos, s_pos = sys.positions[:32], sys.positions[32:]
    t_m, s_m = sys.masses[:32], sys.masses[32:]
    acc_t, part_s = _accel_rows_sym(t_pos, t_m, s_pos, s_m, 0.0)
    np.testing.assert_allclose(
        np.asarray(acc_t), np.asarray(_accel_rows(t_pos, s_pos, s_m, 0.0)),
        rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(part_s), np.asarray(_accel_rows(s_pos, t_pos, t_m, 0.0)),
        rtol=1e-12)


def test_blocked_sym_engine_matches_tile(rng_key):
    """The blocked Newton-3 engine (the ring's default off the GPU) matches
    the one-tile sweep on both outputs, incl. padded target blocks."""
    from nbody_jax.ops.brute_force import (_accel_rows_sym,
                                           accel_rows_sym_blocked)
    sys = random_system(rng_key, 300, dim=2, dtype=jnp.float32)
    t_pos, s_pos = sys.positions[:100], sys.positions[100:]
    t_m, s_m = sys.masses[:100], sys.masses[100:]
    want_t, want_s = _accel_rows_sym(t_pos, t_m, s_pos, s_m, 0.0)
    got_t, got_s = accel_rows_sym_blocked(t_pos, t_m, s_pos, s_m, 0.0,
                                          block=32)
    # Scale-based atol: near-cancelling components make per-element rtol
    # harsh under f32 block reordering (same argument as the project's
    # scale_normalized_error metric).
    for got, want in ((got_t, want_t), (got_s, want_s)):
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-5 * scale)


def test_ring_symmetric_with_small_blocks(rng_key):
    """End-to-end symmetric ring whose blocked engine splits each shard
    into several target blocks, on the 8-device CPU mesh."""
    import functools
    from nbody_jax.ops.brute_force import (accel_rows_blocked,
                                           accel_rows_sym_blocked)
    sys = random_system(rng_key, 256, dim=3, dtype=jnp.float32)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = ring_brute_force(
        sys.positions, sys.masses, cfg, mesh=make_mesh(), symmetric=True,
        local_accel=functools.partial(accel_rows_blocked, block=8),
        sym_accel=functools.partial(accel_rows_sym_blocked, block=8))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-25)


def test_ring_output_stays_sharded(rng_key):
    sys = random_system(rng_key, 256, dim=3, dtype=jnp.float32)
    mesh = make_mesh()
    got = ring_brute_force(sys.positions, sys.masses, mesh=mesh)
    assert len(got.sharding.device_set) == 8


def test_ring_with_pallas_local(rng_key):
    """ppermute ring with the Pallas kernel as the local engine (interpret
    mode on the CPU mesh) — the one-sided ring the GPU runs."""
    import functools
    from nbody_jax.ops.pallas_brute import pairwise_accel_pallas
    sys = random_system(rng_key, 256, dim=3, dtype=jnp.float32)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    local = functools.partial(pairwise_accel_pallas, block_t=16,
                              block_s=16, interpret=True)
    got = ring_brute_force(
        sys.positions, sys.masses, cfg, mesh=make_mesh(),
        local_accel=lambda t, s, m, soft: local(t, s, m, softening=soft))
    from nbody_jax.utils.accuracy import scale_normalized_error
    assert float(scale_normalized_error(got, want)) < 1e-4
