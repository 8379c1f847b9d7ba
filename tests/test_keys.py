"""Morton/Hilbert key properties: bijectivity, locality, ordering."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from nbody_jax.ops import keys as K


def full_grid(bits, dim):
    side = 1 << bits
    pts = np.array(list(itertools.product(range(side), repeat=dim)),
                   dtype=np.uint32)
    return jnp.asarray(pts)


@pytest.mark.parametrize("bits,dim", [(2, 2), (3, 2), (2, 3), (3, 3)])
def test_morton_bijective(bits, dim):
    coords = full_grid(bits, dim)
    k = np.asarray(K.morton_key_from_coords(coords, bits))
    assert len(np.unique(k)) == len(k)
    assert k.min() == 0 and k.max() == (1 << (bits * dim)) - 1


@pytest.mark.parametrize("bits,dim", [(2, 2), (3, 2), (4, 2), (2, 3), (3, 3)])
def test_hilbert_bijective(bits, dim):
    coords = full_grid(bits, dim)
    k = np.asarray(K.hilbert_key_from_coords(coords, bits))
    assert len(np.unique(k)) == len(k), "hilbert key must be a bijection"
    assert k.min() == 0 and k.max() == (1 << (bits * dim)) - 1


@pytest.mark.parametrize("bits,dim", [(2, 2), (3, 2), (4, 2), (2, 3), (3, 3)])
def test_hilbert_locality(bits, dim):
    """The defining Hilbert property: consecutive curve points are grid
    neighbors (Manhattan distance exactly 1). Morton does NOT satisfy this;
    the reference's dead hilbert_key (vector.h:151-192) doesn't either.
    """
    coords = np.asarray(full_grid(bits, dim), dtype=np.int64)
    k = np.asarray(K.hilbert_key_from_coords(jnp.asarray(
        coords.astype(np.uint32)), bits))
    order = np.argsort(k)
    walk = coords[order]
    steps = np.abs(np.diff(walk, axis=0)).sum(axis=1)
    assert np.all(steps == 1), f"non-adjacent steps at {np.where(steps != 1)}"


def test_quantize_bounds():
    pos = jnp.array([[0.0, 0.0], [1.0, 1.0], [0.5, 0.25]])
    q = np.asarray(K.quantize(pos, 4))
    assert q.min() >= 0 and q.max() <= 15
    # Min corner near 0, max corner near 15 (1% AABB padding).
    assert q[0, 0] <= 1 and q[1, 0] >= 14


def test_morton_spatial_ordering():
    # Bodies in the same quadrant share high key bits.
    pos = jnp.array([[0.1, 0.1], [0.2, 0.2], [0.9, 0.9], [0.85, 0.95]])
    k = np.asarray(K.morton_key(pos, bits=8))
    assert abs(int(k[0]) - int(k[1])) < abs(int(k[0]) - int(k[2]))


def test_sort_bodies(rng_key):
    import jax
    from nbody_jax import random_system
    sys = random_system(rng_key, 100, dim=3)
    k = K.hilbert_key(sys.positions)
    order, ks, pos, vel, mass = K.sort_bodies_by_key(
        k, sys.positions, sys.velocities, sys.masses)
    assert np.all(np.diff(np.asarray(ks).astype(np.int64)) >= 0)
    np.testing.assert_array_equal(np.asarray(pos),
                                  np.asarray(sys.positions)[np.asarray(order)])
