"""Sparse (chunked / clustered-input) grid path — ops/sparse_grid.py.

The dense grid pads near-field tensors to the max leaf occupancy squared
and refuses degenerate capacities; the sparse path must (a) agree with
the dense path on quasi-uniform inputs (same tree, same telescoping
V-lists — only the batching differs), and (b) stay correct AND bounded on
the clustered inputs the dense path refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.ops.grid_tree import (CLUSTERED_CAPACITY_LIMIT,
                                     auto_leaf_level, barnes_hut_grid,
                                     chunk_table, compute_capacity)
from nbody_jax.ops.sparse_grid import (barnes_hut_sparse,
                                       sparse_grid_stats)
from nbody_jax.utils.accuracy import scale_normalized_error


def _clustered(key, n, frac=0.6, dim=3):
    k1, k2 = jax.random.split(key)
    nc = int(n * frac)
    core = 1e-3 * jax.random.uniform(k1, (nc, dim), jnp.float64) + 0.5
    halo = jax.random.uniform(k2, (n - nc, dim), jnp.float64)
    return (jnp.concatenate([core, halo]),
            jnp.ones((n,), jnp.float64))


def test_chunk_table_against_numpy():
    counts = jnp.asarray([0, 5, 0, 130, 64, 1, 0, 3], jnp.int32)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    C0 = 64
    want_cells, want_starts, want_lens = [], [], []
    for c, (st, ct) in enumerate(zip(np.asarray(starts),
                                     np.asarray(counts))):
        for off in range(0, int(ct), C0):
            want_cells.append(c)
            want_starts.append(st + off)
            want_lens.append(min(C0, int(ct) - off))
    NT = len(want_cells) + 3  # over-budget rows must come back empty
    cell, cstart, clen, coffs = jax.jit(
        chunk_table, static_argnames=("chunk", "num_chunks"))(
        starts, counts, chunk=C0, num_chunks=NT)
    m = len(want_cells)
    np.testing.assert_array_equal(np.asarray(cell)[:m], want_cells)
    np.testing.assert_array_equal(np.asarray(cstart)[:m], want_starts)
    np.testing.assert_array_equal(np.asarray(clen)[:m], want_lens)
    assert np.all(np.asarray(clen)[m:] == 0)
    # coffs maps each cell to its first chunk row.
    np.testing.assert_array_equal(
        np.asarray(coffs), np.cumsum([0] + [(-(-int(c) // C0))
                                            for c in np.asarray(counts)]))


@pytest.mark.parametrize("dim", [2, 3])
def test_sparse_matches_dense_uniform(rng_key, dim):
    """Same tree, same V-lists ⇒ sparse ≈ dense to summation-order fp."""
    n = 3000
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig(G=1.0, softening=1e-6)
    dense = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5,
                            layout="dense")
    sparse = barnes_hut_sparse(sys.positions, sys.masses, cfg, theta=0.5)
    assert float(scale_normalized_error(sparse, dense)) < 1e-13


@pytest.mark.parametrize("theta", [0.5, 0.25])
def test_sparse_clustered_vs_brute(rng_key, theta):
    """The input class the dense grid refuses: 60% of bodies (4800 —
    past the 4096 capacity guard) in a 1e-3-wide ball. Near field inside
    the core is exact P2P."""
    pos, mass = _clustered(rng_key, 8000)
    cfg = GravityConfig(G=1.0, softening=1e-4)
    L = auto_leaf_level(8000, 3)
    assert compute_capacity(pos, L) > CLUSTERED_CAPACITY_LIMIT
    want = brute_force_direct(pos, mass, cfg)
    got = barnes_hut_sparse(pos, mass, cfg, theta=theta)
    assert bool(jnp.all(jnp.isfinite(got)))
    tol = 3e-2 if theta == 0.5 else 4e-3
    assert float(scale_normalized_error(got, want)) < tol


def test_auto_layout_falls_back_to_sparse(rng_key):
    """barnes_hut_grid(layout='auto') must answer (via the sparse path)
    on inputs whose capacity the dense guard refuses."""
    pos, mass = _clustered(rng_key, 8000)
    cfg = GravityConfig(G=1.0, softening=1e-4)
    with pytest.raises(ValueError):
        barnes_hut_grid(pos, mass, cfg, theta=0.5, layout="dense")
    got = barnes_hut_grid(pos, mass, cfg, theta=0.5, layout="auto")
    want = barnes_hut_sparse(pos, mass, cfg, theta=0.5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12)


def test_stats_memo_identity_semantics(rng_key):
    pos = jax.random.uniform(rng_key, (500, 2), jnp.float64)
    a = sparse_grid_stats(pos, 3, 64, 8, 1)
    b = sparse_grid_stats(pos, 3, 64, 8, 1)  # memo hit (same identity)
    assert a == b
    pos2 = pos + 0.0  # new array, same values — recomputed, same stats
    assert sparse_grid_stats(pos2, 3, 64, 8, 1) == a


@pytest.mark.parametrize("dim", [2, 3])
def test_fmm_sparse_matches_dense_uniform(rng_key, dim):
    """Chunked P2M/P2P must reproduce the dense FMM (same tree, same
    expansions; only the near-field batching and the P2M partial-sum
    order differ)."""
    from nbody_jax.ops.fmm import fmm_forces
    sys = random_system(rng_key, 3000, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig(G=1.0, softening=1e-6)
    dense = fmm_forces(sys.positions, sys.masses, cfg, order=4,
                       layout="dense")
    sparse = fmm_forces(sys.positions, sys.masses, cfg, order=4,
                        layout="sparse")
    assert float(scale_normalized_error(sparse, dense)) < 1e-12


def test_fmm_sparse_clustered_vs_brute(rng_key):
    """FMM on the input class the dense grid refuses."""
    from nbody_jax.ops.fmm import fmm_forces
    pos, mass = _clustered(rng_key, 8000)
    cfg = GravityConfig(G=1.0, softening=1e-4)
    want = brute_force_direct(pos, mass, cfg)
    got = fmm_forces(pos, mass, cfg, order=5, layout="auto")
    assert bool(jnp.all(jnp.isfinite(got)))
    assert float(scale_normalized_error(got, want)) < 2e-3
    with pytest.raises(ValueError):
        fmm_forces(pos, mass, cfg, order=5, layout="dense")


def test_sparse_mono_vs_quad(rng_key):
    """Quadrupole far field must beat monopole on the sparse path too."""
    sys = random_system(rng_key, 2000, dim=2, dtype=jnp.float64)
    cfg = GravityConfig(G=1.0, softening=0.0)
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    e = {}
    for mp in ("mono", "quad"):
        got = barnes_hut_sparse(sys.positions, sys.masses, cfg,
                                theta=0.5, multipole=mp)
        e[mp] = float(scale_normalized_error(got, want))
    assert e["quad"] < e["mono"]
    assert e["quad"] < 5e-3


def test_sparse_segmented_matches_unsegmented(rng_key):
    """The bounded-dispatch segment split of the sparse evaluation is
    bit-identical to one dispatch."""
    from nbody_jax.config import GravityConfig
    from nbody_jax.ops.sparse_grid import barnes_hut_sparse
    from nbody_jax.models import plummer_sphere
    system, cfg = plummer_sphere(rng_key, 6000, dim=3, dtype=jnp.float32)
    base = barnes_hut_sparse(system.positions, system.masses, cfg,
                             theta=0.25, num_segments=1)
    seg = barnes_hut_sparse(system.positions, system.masses, cfg,
                            theta=0.25, num_segments=4)
    np.testing.assert_array_equal(np.asarray(seg), np.asarray(base))
