import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_jax import (
    GravityConfig,
    brute_force_blocked,
    brute_force_direct,
    random_system,
)
from nbody_jax.ops.brute_force import brute_force_blocked_jit


def numpy_oracle(pos, mass, G, softening):
    """Literal translation of the intended physics: per-pair double loop.

    Parity model: brute_force_seq_n_body (methods.cpp:7-42), attractive sign,
    with softening and the dist²<1e-10 skip guard (methods.cpp:24).
    """
    n, d = pos.shape
    forces = np.zeros((n, d))
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            diff = pos[j] - pos[i]
            d2 = float(np.dot(diff, diff))
            if d2 < 1e-10:
                continue
            inv_r3 = (d2 + softening**2) ** -1.5
            forces[i] += G * mass[i] * mass[j] * inv_r3 * diff
    return forces


@pytest.mark.parametrize("softening", [0.0, 1e-6, 10.0])
def test_matches_numpy_oracle(rng_key, dim, softening):
    sys = random_system(rng_key, 64, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig(softening=softening)
    got = brute_force_direct(sys.positions, sys.masses, cfg)
    want = numpy_oracle(np.asarray(sys.positions), np.asarray(sys.masses),
                        cfg.G, softening)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10)


def test_two_body_analytic():
    # Two unit masses 2.0 apart on x: |F| = G·1·1/4, attractive.
    pos = jnp.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]], dtype=jnp.float64)
    mass = jnp.ones((2,), dtype=jnp.float64)
    cfg = GravityConfig(G=1.0, softening=0.0)
    f = np.asarray(brute_force_direct(pos, mass, cfg))
    np.testing.assert_allclose(f[0], [0.25, 0.0, 0.0], atol=1e-14)
    np.testing.assert_allclose(f[1], [-0.25, 0.0, 0.0], atol=1e-14)


def test_newton_third_law(rng_key, dim):
    sys = random_system(rng_key, 256, dim=dim, dtype=jnp.float64)
    f = brute_force_direct(sys.positions, sys.masses)
    total = np.asarray(jnp.sum(f, axis=0))
    scale = float(jnp.max(jnp.linalg.norm(f, axis=-1)))
    np.testing.assert_allclose(total, np.zeros(dim), atol=1e-9 * max(scale, 1e-30))


def test_blocked_matches_direct(rng_key, dim):
    # Non-multiple N exercises the padding path.
    sys = random_system(rng_key, 300, dim=dim, dtype=jnp.float64)
    direct = brute_force_direct(sys.positions, sys.masses)
    blocked = brute_force_blocked(sys.positions, sys.masses, block_size=128)
    np.testing.assert_allclose(np.asarray(blocked), np.asarray(direct),
                               rtol=1e-12)


def test_blocked_jit_matches(rng_key):
    sys = random_system(rng_key, 200, dim=3, dtype=jnp.float64)
    cfg = GravityConfig()
    direct = brute_force_direct(sys.positions, sys.masses, cfg)
    got = brute_force_blocked_jit(sys.positions, sys.masses, cfg.G,
                                  cfg.softening, block_size=64)
    np.testing.assert_allclose(np.asarray(got), np.asarray(direct), rtol=1e-12)


def test_coincident_bodies_guarded(rng_key):
    # Two bodies at the same point: reference skips the pair (methods.cpp:24).
    pos = jnp.array([[1.0, 1.0], [1.0, 1.0], [5.0, 1.0]], dtype=jnp.float64)
    mass = jnp.array([1.0, 1.0, 1.0], dtype=jnp.float64)
    f = np.asarray(brute_force_direct(pos, mass, GravityConfig(G=1.0,
                                                               softening=0.0)))
    assert np.all(np.isfinite(f))
    # Bodies 0 and 1 only feel body 2.
    np.testing.assert_allclose(f[0], f[1])
    np.testing.assert_allclose(f[0], [1.0 / 16.0, 0.0], atol=1e-14)


@pytest.mark.parametrize("t,block", [(37, 16), (64, 64), (5, 128)])
def test_accel_rows_blocked_matches_unblocked(rng_key, t, block):
    """The ring's bounded-memory engine equals the one-tile row sweep,
    including target counts that do not divide the block."""
    from nbody_jax.ops.brute_force import _accel_rows, accel_rows_blocked
    sys = random_system(rng_key, t + 90, dim=3, dtype=jnp.float64)
    tp, sp, sm = sys.positions[:t], sys.positions[t:], sys.masses[t:]
    np.testing.assert_allclose(
        np.asarray(accel_rows_blocked(tp, sp, sm, 0.0, block=block)),
        np.asarray(_accel_rows(tp, sp, sm, 0.0)), rtol=1e-12)


@pytest.mark.parametrize("t,block", [(37, 16), (40, 64)])
def test_accel_rows_sym_blocked_matches_unblocked(rng_key, t, block):
    """Both outputs of the blocked Newton-3 engine (target rows and the
    sources' share, summed over target blocks) equal the one-tile sweep;
    zero-mass padding targets add nothing to the sources' share."""
    from nbody_jax.ops.brute_force import (_accel_rows_sym,
                                           accel_rows_sym_blocked)
    sys = random_system(rng_key, t + 70, dim=2, dtype=jnp.float64)
    tp, tm = sys.positions[:t], sys.masses[:t]
    sp, sm = sys.positions[t:], sys.masses[t:]
    got = accel_rows_sym_blocked(tp, tm, sp, sm, 0.0, block=block)
    want = _accel_rows_sym(tp, tm, sp, sm, 0.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-10)
