"""Grid-tree build invariants and Barnes-Hut accuracy vs direct sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.ops.grid_tree import (
    auto_leaf_level,
    barnes_hut_grid,
    build_grid_tree,
    cell_coords,
    compute_capacity,
    theta_to_ring,
)
from nbody_jax.ops.keys import morton_key_from_coords
from nbody_jax.utils.accuracy import scale_normalized_error


def test_cell_coords_roundtrip():
    for dim, bits in ((2, 5), (3, 4)):
        n_cells = 1 << (dim * bits)
        ids = jnp.arange(n_cells, dtype=jnp.uint32)
        xy = cell_coords(ids, dim)
        back = morton_key_from_coords(xy, bits)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(ids))


def test_build_invariants(rng_key, dim):
    sys = random_system(rng_key, 500, dim=dim, dtype=jnp.float64)
    L = auto_leaf_level(500, dim)
    C = compute_capacity(sys.positions, L)
    tree = build_grid_tree(sys.positions, sys.masses, L, C)

    # Mass conservation at every level.
    total = float(jnp.sum(sys.masses))
    for l in range(L + 1):
        np.testing.assert_allclose(float(jnp.sum(tree.level_mass[l])),
                                   total, rtol=1e-12)
    # Root COM = global COM.
    com = np.asarray(jnp.sum(sys.masses[:, None] * sys.positions, axis=0)
                     / total)
    np.testing.assert_allclose(np.asarray(tree.level_com[0][0]), com,
                               rtol=1e-12)
    # Leaf runs partition the sorted bodies: starts/counts are consistent
    # and every body has a unique window slot within its leaf.
    starts = np.asarray(tree.cell_start)
    counts = np.asarray(tree.cell_count)
    assert counts.sum() == 500
    occupied = np.concatenate(
        [np.arange(s, s + c) for s, c in zip(starts, counts) if c > 0])
    assert len(occupied) == 500 and len(np.unique(occupied)) == 500
    ws = np.asarray(tree.window_slot)
    body_leaf = np.asarray(tree.leaf_ids)
    twr = tree.capacity // 8 * 8 + 8
    assert np.all(ws >= 0) and np.all(ws < twr)
    assert len(np.unique(body_leaf.astype(np.int64) * twr + ws)) == 500
    # Sorted bodies are in Morton order of their leaf ids.
    leaf_ids = np.asarray(tree.leaf_ids)
    assert np.all(np.diff(leaf_ids) >= 0)


def test_theta_to_ring():
    assert theta_to_ring(0.5) == 1
    assert theta_to_ring(0.25) == 3
    assert theta_to_ring(1.0) == 1


@pytest.mark.parametrize("n", [256, 1000])
def test_bh_matches_direct(rng_key, dim, n):
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5)
    # Worst-body error at theta=0.5: ~1e-3 in 2D, up to ~2e-2 in 3D (the
    # cell diagonal is sqrt(3) of the side, so the ring MAC is looser).
    err = float(scale_normalized_error(got, want))
    assert err < 4e-2, f"theta=0.5 error too large: {err}"


def test_bh_converges_with_theta(rng_key):
    sys = random_system(rng_key, 1000, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    errs = []
    for theta in (0.5, 0.25, 0.125):
        # Explicit level: the auto heuristic favors fuller leaves, which
        # at N=1000 degenerates to near-field-only (exact for any theta).
        got = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=theta,
                              leaf_level=3)
        errs.append(float(scale_normalized_error(got, want)))
    assert errs[1] < errs[0] and errs[2] < errs[1], errs
    assert errs[2] < 1e-3


@pytest.mark.parametrize("dim2", [2, 3])
def test_bh_quadrupole_beats_monopole(rng_key, dim2):
    """Quadrupole far field (multipole='quad', the default) must cut the
    far-field error vs monopole at the same theta — the round-2 accuracy
    fix for the reference Accuracy(%) metric (utils.h:171-219)."""
    sys = random_system(rng_key, 4096, dim=dim2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    kw = dict(theta=0.5, leaf_level=3 if dim2 == 2 else 2)
    e_mono = float(scale_normalized_error(barnes_hut_grid(
        sys.positions, sys.masses, cfg, multipole="mono", **kw), want))
    e_quad = float(scale_normalized_error(barnes_hut_grid(
        sys.positions, sys.masses, cfg, multipole="quad", **kw), want))
    assert e_quad < 0.5 * e_mono, (e_mono, e_quad)


def test_bh_quad_accuracy_percentage(rng_key):
    """Reference per-component metric: quad theta=0.25 must clear 99%."""
    from nbody_jax.utils.accuracy import accuracy_percentage
    sys = random_system(rng_key, 8192, dim=2, dtype=jnp.float32)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.25,
                          leaf_level=4, multipole="quad")
    assert float(accuracy_percentage(got, want)) >= 99.0


def test_quad_moments_match_direct(rng_key):
    """level_quad must equal the per-cell COM-centered second moments."""
    from nbody_jax.ops.grid_tree import _quad_pairs, build_grid_tree, \
        compute_capacity
    from nbody_jax.ops.keys import quantize
    sys = random_system(rng_key, 2000, dim=3, dtype=jnp.float64)
    pos, mass = np.asarray(sys.positions), np.asarray(sys.masses)
    L = 2
    cap = compute_capacity(sys.positions, L)
    tree = build_grid_tree(sys.positions, sys.masses, L, cap, quad=True)
    qp = _quad_pairs(3)
    for lvl in (L, 1):
        q = quantize(sys.positions, lvl, lo=tree.lo,
                     hi=tree.lo + tree.cell_sizes[0])
        ids = np.asarray(morton_key_from_coords(q, lvl)).astype(np.int64)
        S_tree = np.asarray(tree.level_quad[lvl])
        for cid in np.unique(ids)[:8]:
            sel = ids == cid
            mm, pp = mass[sel], pos[sel]
            com_c = (mm[:, None] * pp).sum(0) / mm.sum()
            S_c = np.einsum("s,si,sj->ij", mm, pp - com_c, pp - com_c)
            want = np.array([S_c[a, b] for a, b in qp])
            np.testing.assert_allclose(S_tree[cid], want, rtol=1e-5,
                                       atol=1e-12 * max(abs(want).max(), 1))


def test_segmented_dispatch_matches_unsegmented(rng_key):
    """Splitting the leaf sweep into bounded dispatches (the N≥4M 3D
    segmented path) must be bit-identical to the single dispatch."""
    from nbody_jax.ops.grid_tree import grid_tree_accel_sorted
    sys = random_system(rng_key, 2048, dim=3, dtype=jnp.float64)
    lvl = auto_leaf_level(2048, 3)
    cap = compute_capacity(sys.positions, lvl)
    tree = build_grid_tree(sys.positions, sys.masses, lvl, cap, quad=True)
    base = grid_tree_accel_sorted(tree, k=1, leaf_batch=64,
                                  multipole="quad")
    seg = sum(grid_tree_accel_sorted(tree, k=1, leaf_batch=64,
                                     multipole="quad", num_segments=4,
                                     segment_index=jnp.int32(si))
              for si in range(4))
    np.testing.assert_array_equal(np.asarray(seg), np.asarray(base))


def test_segmented_hier_gather_matches_unsegmented(rng_key):
    """The N≥4M 3D production composition — hier far field, traversal-side
    defer=gather, hoisted sweep shared across 4 bounded segment dispatches
    — must be bit-identical to the unsegmented gather evaluation."""
    from nbody_jax.ops.grid_tree import grid_tree_accel_sorted
    from nbody_jax.ops.hier_far import hier_far_coeffs
    sys = random_system(rng_key, 4096, dim=3, dtype=jnp.float32)
    lvl = 4  # deep enough that k=3 has real far-field levels
    cap = compute_capacity(sys.positions, lvl)
    tree = build_grid_tree(sys.positions, sys.masses, lvl, cap, quad=True)
    coeffs = hier_far_coeffs(tree, 3, multipole="quad", defer="gather")[0]
    base = grid_tree_accel_sorted(tree, k=3, leaf_batch=64,
                                  multipole="quad", far_impl="hier",
                                  hier_coeffs=coeffs)
    seg = sum(grid_tree_accel_sorted(tree, k=3, leaf_batch=64,
                                     multipole="quad", far_impl="hier",
                                     hier_coeffs=coeffs, num_segments=4,
                                     segment_index=jnp.int32(si))
              for si in range(4))
    np.testing.assert_array_equal(np.asarray(seg), np.asarray(base))


def test_capacity_memo_exact_and_weakref_guarded(rng_key):
    """compute_capacity_cached: identity hit returns the same value without
    recomputation; a NEW array whose id happens to be reused must miss
    (weakref guard) — and distinct data must give its own capacity."""
    from nbody_jax.ops.grid_tree import (_CAPACITY_MEMO, compute_capacity,
                                         compute_capacity_cached)
    sys = random_system(rng_key, 4096, dim=2, dtype=jnp.float32)
    lvl = auto_leaf_level(4096, 2)
    want = compute_capacity(sys.positions, lvl)
    assert compute_capacity_cached(sys.positions, lvl) == want
    key = (id(sys.positions), lvl)
    assert key in _CAPACITY_MEMO
    # Hit path: poison the stored value to prove the second call is a hit.
    _CAPACITY_MEMO[key] = (_CAPACITY_MEMO[key][0], -123)
    assert compute_capacity_cached(sys.positions, lvl) == -123
    _CAPACITY_MEMO[key] = (_CAPACITY_MEMO[key][0], want)
    # Different (clustered) data: its own entry, not the old one.
    tight = sys.positions * 1e-6
    assert compute_capacity_cached(tight, lvl) == compute_capacity(
        tight, lvl)
    # Dead-object guard: a dict entry whose referent was collected must
    # never serve a hit for a different live array at the same id.
    import weakref

    class Dummy:
        pass

    d = Dummy()
    fake_key = (id(sys.positions), lvl + 1)
    _CAPACITY_MEMO[fake_key] = (weakref.ref(d), -7)
    del d  # referent dies; ref() is None -> must miss and recompute
    assert compute_capacity_cached(sys.positions, lvl + 1) == \
        compute_capacity(sys.positions, lvl + 1)
    for k in (key, fake_key, (id(tight), lvl)):
        _CAPACITY_MEMO.pop(k, None)


@pytest.mark.slow
def test_fused_driver_matches_component_path(rng_key):
    """The single-dispatch fused drivers (_bh_grid_fused / _fmm_fused /
    _bvh_fused) must be bit-identical to composing their pieces eagerly —
    they exist purely to remove host-device round trips."""
    from nbody_jax.ops.bvh import MAX_BITS as BVH_BITS
    from nbody_jax.ops.bvh import build_bvh, bvh_accel_sorted, bvh_forces
    from nbody_jax.ops.fmm import fmm_accel_sorted, fmm_forces
    from nbody_jax.ops.grid_tree import grid_tree_accel_sorted

    sys = random_system(rng_key, 1024, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    g = jnp.asarray(cfg.G, sys.positions.dtype)
    lvl = auto_leaf_level(1024, 2)
    cap = compute_capacity(sys.positions, lvl)

    # BH grid.
    fused = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5,
                            leaf_level=lvl, capacity=cap)
    tree = build_grid_tree(sys.positions, sys.masses, lvl, cap, quad=True)
    acc = grid_tree_accel_sorted(tree, k=1, softening=float(cfg.softening),
                                 multipole="quad")
    manual = (g * sys.masses)[:, None] * \
        jnp.zeros_like(acc).at[tree.order].set(acc)
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(manual))

    # FMM.
    fused = fmm_forces(sys.positions, sys.masses, cfg, order=4,
                       leaf_level=lvl, capacity=cap)
    tree = build_grid_tree(sys.positions, sys.masses, lvl, cap)
    acc = fmm_accel_sorted(tree, order=4, ring=1,
                           softening=float(cfg.softening))
    manual = (g * sys.masses)[:, None] * \
        jnp.zeros_like(acc).at[tree.order].set(acc)
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(manual))

    # BVH (capacities AND group_size passed explicitly to both paths so no
    # escalation re-run and no drift when bvh_forces retunes its defaults —
    # a different group size changes the reduction order, which is exactly
    # the bit-level difference this test exists to reject).
    kb = 2 * BVH_BITS[2]
    fused = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25,
                       group_size=128, frontier_width=1024, near_cap=1024)
    btree = build_bvh(sys.positions, sys.masses, kb, quad=True)
    acc = bvh_accel_sorted(btree, theta=0.25,
                           softening=float(cfg.softening),
                           group_size=128, frontier_width=1024,
                           near_cap=1024, multipole="quad")
    manual = (g * sys.masses)[:, None] * \
        jnp.zeros_like(acc).at[btree.order].set(acc)
    np.testing.assert_array_equal(np.asarray(fused), np.asarray(manual))


def test_bh_small_n(rng_key):
    # N small enough that the tree degenerates to near-field only.
    sys = random_system(rng_key, 16, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = barnes_hut_grid(sys.positions, sys.masses, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_bh_force_sign(rng_key):
    """Anti-regression vs SURVEY.md §8.1: tree forces must be attractive."""
    pos = jnp.array([[0.0, 0.0], [10.0, 0.0]] +
                    [[100.0 + i, 100.0] for i in range(14)], dtype=jnp.float64)
    mass = jnp.ones((16,), jnp.float64)
    got = np.asarray(barnes_hut_grid(pos, mass, GravityConfig(G=1.0)))
    assert got[0, 0] > 0  # body 0 pulled toward +x
    assert got[1, 0] < 0 or got[1, 0] > 0  # finite
    want = np.asarray(brute_force_direct(pos, mass, GravityConfig(G=1.0)))
    assert np.sign(got[0, 0]) == np.sign(want[0, 0])
