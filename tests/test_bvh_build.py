"""Unit tests for the BVH segment-tree quad build (ops/bvh.py).

The quadrupole build derives node mass / COM / COM-centered second
moments from a segment tree of aligned power-of-two blocks (contiguous
pairwise parallel-axis level combine + <= 2 covering blocks per level
per node). These tests validate every node's stats directly against an
f64 per-range brute computation — at the reference's 1e7-scale
coordinates, where the naive prefix-sum-of-raw-moments formulation
catastrophically cancels (the round-2 accuracy bug this build exists to
avoid; see ROADMAP "Round-2 accuracy fix").
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nbody_jax as nb
from nbody_jax.ops.bvh import MAX_BITS, build_bvh
from nbody_jax.ops.grid_tree import _quad_pairs


def _oracle_node_stats(tree, dim):
    """f64 mass/COM/S per node from the sorted bodies and node ranges."""
    pos = np.asarray(tree.pos_sorted, np.float64)
    mass = np.asarray(tree.mass_sorted, np.float64)
    lo = np.asarray(tree.range_l)
    hi = np.asarray(tree.range_r)
    qpairs = _quad_pairs(dim)
    num_nodes = lo.shape[0]
    M = np.zeros(num_nodes)
    com = np.zeros((num_nodes, dim))
    S = np.zeros((num_nodes, len(qpairs)))
    for v in range(num_nodes):
        sl = slice(lo[v], hi[v] + 1)
        m = mass[sl]
        x = pos[sl]
        M[v] = m.sum()
        com[v] = (m[:, None] * x).sum(0) / M[v]
        d = x - com[v]
        for q, (a, b) in enumerate(qpairs):
            S[v, q] = (m * d[:, a] * d[:, b]).sum()
    return M, com, S


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n", [37, 256, 1000])  # non-pow2 exercises padding
def test_quad_node_stats_match_f64_oracle(dim, n):
    system = nb.random_system(jax.random.key(11), n, dim=dim,
                              dtype=jnp.float32)
    tree = build_bvh(system.positions, system.masses,
                     dim * MAX_BITS[dim], quad=True)
    M_ref, com_ref, S_ref = _oracle_node_stats(tree, dim)

    M = np.asarray(tree.node_mass, np.float64)
    com = np.asarray(tree.node_com, np.float64)
    width = np.asarray(tree.node_size, np.float64)  # max AABB extent
    nq = len(_quad_pairs(dim))
    S = np.asarray(tree.node_table[:, 6 + dim:6 + dim + nq], np.float64)

    # Mass: segment-tree pairwise sums, O(log N * eps) relative.
    np.testing.assert_allclose(M, M_ref, rtol=1e-5)
    # COM: absolute error must stay at eps * node-extent scale — the
    # whole point of centered accumulation (prefix-sum differences carry
    # ~1e12 * eps absolute error, which rivals a small node's extent).
    com_tol = 1e-5 * np.maximum(width, 1e-3)[:, None] \
        + 3e-7 * np.abs(com_ref)
    assert np.all(np.abs(com - com_ref) <= com_tol), (
        np.abs(com - com_ref) / com_tol).max()
    # S: relative to the node's own second-moment scale m * extent^2.
    scale = np.maximum((M_ref * np.maximum(width, 1e-30) ** 2)[:, None],
                       1e-30)
    assert np.all(np.abs(S - S_ref) <= 1e-4 * scale + 1e-6 * np.abs(S_ref))


def test_quad_leaf_rows_are_exact():
    n, dim = 129, 2
    system = nb.random_system(jax.random.key(5), n, dim=dim,
                              dtype=jnp.float32)
    tree = build_bvh(system.positions, system.masses,
                     dim * MAX_BITS[dim], quad=True)
    # Unified ids: leaves occupy rows n-1 .. 2n-2.
    np.testing.assert_array_equal(np.asarray(tree.node_mass[n - 1:]),
                                  np.asarray(tree.mass_sorted))
    np.testing.assert_array_equal(np.asarray(tree.node_com[n - 1:]),
                                  np.asarray(tree.pos_sorted))
    nq = len(_quad_pairs(dim))
    assert not np.any(np.asarray(tree.node_table[n - 1:, 6 + dim:6 + dim + nq]))


def test_root_mass_is_total_mass_at_scale():
    # N large enough that the old relaxation's failure mode (many rounds)
    # and padding interact; root must still carry the exact total.
    n, dim = 20_000, 3
    system = nb.random_system(jax.random.key(9), n, dim=dim,
                              dtype=jnp.float32)
    tree = build_bvh(system.positions, system.masses,
                     dim * MAX_BITS[dim], quad=True)
    total = float(jnp.sum(system.masses.astype(jnp.float64)))
    assert abs(float(tree.node_mass[0]) - total) <= 1e-5 * total
