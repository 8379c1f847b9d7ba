import jax
import jax.numpy as jnp
import numpy as np

from nbody_jax import System, random_system, plummer_system
from nbody_jax.config import MASS_RANGE, POSITION_RANGE, VELOCITY_RANGE


def test_shapes_and_dim(rng_key, dim):
    sys = random_system(rng_key, 100, dim=dim)
    assert sys.positions.shape == (100, dim)
    assert sys.velocities.shape == (100, dim)
    assert sys.masses.shape == (100,)
    assert sys.n == 100 and sys.dim == dim
    sys.validate()


def test_distribution_ranges(rng_key):
    sys = random_system(rng_key, 4096, dim=3)
    p = np.asarray(sys.positions)
    v = np.asarray(sys.velocities)
    m = np.asarray(sys.masses)
    assert p.min() >= POSITION_RANGE[0] and p.max() <= POSITION_RANGE[1]
    assert v.min() >= VELOCITY_RANGE[0] and v.max() <= VELOCITY_RANGE[1]
    assert m.min() >= MASS_RANGE[0] and m.max() <= MASS_RANGE[1]


def test_deterministic_seeding(rng_key):
    a = random_system(rng_key, 64, dim=2)
    b = random_system(rng_key, 64, dim=2)
    np.testing.assert_array_equal(np.asarray(a.positions),
                                  np.asarray(b.positions))
    c = random_system(jax.random.key(1), 64, dim=2)
    assert not np.array_equal(np.asarray(a.positions),
                              np.asarray(c.positions))


def test_pytree_roundtrip(rng_key):
    sys = random_system(rng_key, 8, dim=3)
    leaves, treedef = jax.tree_util.tree_flatten(sys)
    assert len(leaves) == 3
    rebuilt = jax.tree_util.tree_unflatten(treedef, leaves)
    assert isinstance(rebuilt, System)

    # jit through the pytree
    @jax.jit
    def scale(s: System) -> System:
        return s.replace(positions=s.positions * 2)

    out = scale(sys)
    np.testing.assert_allclose(np.asarray(out.positions),
                               2 * np.asarray(sys.positions))


def test_plummer(rng_key):
    sys = plummer_system(rng_key, 1000, dim=3, total_mass=1.0)
    assert np.isclose(np.asarray(sys.masses).sum(), 1.0, rtol=1e-5)
    r = np.linalg.norm(np.asarray(sys.positions), axis=-1)
    # Half-mass radius of a Plummer sphere is ~1.3 scale radii.
    assert 0.5 < np.median(r) < 3.0


def test_bad_dim_raises(rng_key):
    import pytest
    with pytest.raises(ValueError):
        random_system(rng_key, 10, dim=4)
    s = random_system(rng_key, 10, dim=2)
    bad = s.replace(masses=jnp.ones((5,)))
    with pytest.raises(ValueError):
        bad.validate()
