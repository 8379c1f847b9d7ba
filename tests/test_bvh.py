"""Radix-BVH build invariants and force accuracy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.ops.bvh import build_bvh, bvh_accel_sorted, bvh_forces
from nbody_jax.ops.keys import MAX_BITS
from nbody_jax.utils.accuracy import scale_normalized_error


def make_tree(rng_key, n, dim):
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    kb = dim * MAX_BITS[dim]
    return sys, build_bvh(sys.positions, sys.masses, kb)


def test_build_invariants(rng_key, dim):
    n = 300
    sys, tree = make_tree(rng_key, n, dim)
    total = float(jnp.sum(sys.masses))

    # Root covers everything, mass conserved, COM correct.
    assert int(tree.range_l[0]) == 0 and int(tree.range_r[0]) == n - 1
    np.testing.assert_allclose(float(tree.node_mass[0]), total, rtol=1e-12)
    com = np.asarray(jnp.sum(sys.masses[:, None] * sys.positions, axis=0)
                     / total)
    np.testing.assert_allclose(np.asarray(tree.node_com[0]), com, rtol=1e-12)

    # Every internal node's children partition its range.
    rl = np.asarray(tree.range_l)
    rr = np.asarray(tree.range_r)
    left = np.asarray(tree.left)
    for i in range(min(n - 1, 64)):
        lc = left[i]
        assert rl[lc] == rl[i], (i, lc)
        # right child = sibling of left: ranges are contiguous
        assert rr[lc] < rr[i]


def test_children_partition_and_aabb(rng_key):
    n = 128
    sys, tree = make_tree(rng_key, n, 2)
    rl = np.asarray(tree.range_l)
    rr = np.asarray(tree.range_r)
    left = np.asarray(tree.left)
    right = np.asarray(tree.right)
    pos = np.asarray(tree.pos_sorted)
    size = np.asarray(tree.node_size)
    for v in range(n - 1):
        # left/right children partition [l, r] contiguously.
        assert rl[left[v]] == rl[v]
        assert rr[right[v]] == rr[v]
        assert rr[left[v]] + 1 == rl[right[v]]
        # node_size is the exact AABB max extent of the covered range.
        span = pos[rl[v]:rr[v] + 1]
        want = (span.max(axis=0) - span.min(axis=0)).max()
        np.testing.assert_allclose(size[v], want, rtol=1e-12)


@pytest.mark.parametrize("n", [64, 256])
def test_bvh_matches_direct(rng_key, dim, n):
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25, batch=128)
    err = float(scale_normalized_error(got, want))
    assert err < 5e-3, f"theta=0.25 BVH error too large: {err}"


def test_bvh_theta_zero_exact(rng_key):
    """theta=0 disables the MAC: BVH must equal direct sum exactly."""
    sys = random_system(rng_key, 128, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = bvh_forces(sys.positions, sys.masses, cfg, theta=1e-9, batch=64)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-9)


def test_bvh_converges_with_theta(rng_key):
    sys = random_system(rng_key, 200, dim=3, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    # Small group size: with the dim-tuned default (256) a 200-body system
    # is a single group and every theta degenerates to exact P2P.
    errs = [float(scale_normalized_error(
        bvh_forces(sys.positions, sys.masses, cfg, theta=th, batch=128,
                   group_size=8),
        want)) for th in (0.8, 0.4, 0.2)]
    assert errs[2] < errs[0], errs
    assert errs[2] < 5e-3


def test_quad_second_moments_exact(rng_key, dim):
    """Every node's packed S equals the COM-centered second moment of its
    body range (the parallel-axis bottom-up combine is exact in f64)."""
    n = 300
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    kb = dim * MAX_BITS[dim]
    tree = build_bvh(sys.positions, sys.masses, kb, quad=True)
    qpairs = ([(0, 0), (1, 1), (0, 1)] if dim == 2
              else [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)])
    rl, rr = np.asarray(tree.range_l), np.asarray(tree.range_r)
    ps, ms = np.asarray(tree.pos_sorted), np.asarray(tree.mass_sorted)
    S_tab = np.asarray(tree.node_table[:, 6 + dim:6 + dim + len(qpairs)])
    for v in np.random.default_rng(0).integers(0, 2 * n - 1, 64):
        x, m = ps[rl[v]:rr[v] + 1], ms[rl[v]:rr[v] + 1]
        # (m·x)/m rounds one ulp off x for a single body at 1e7-scale
        # coordinates, faking a ~1e-10 second moment — use x directly.
        com = x[0] if len(x) == 1 else (m[:, None] * x).sum(0) / m.sum()
        d = x - com
        want = np.array([(m * d[:, a] * d[:, b]).sum() for a, b in qpairs])
        np.testing.assert_allclose(S_tab[v], want, rtol=1e-8, atol=1e-10)


def test_quad_build_f32_com_consistency(rng_key, dim):
    """Regression: quad-build node COM must come from the pairwise bottom-up
    combine, not global prefix-sum differences.

    At f32 with the reference's 1e7-scale coordinates, the m·x cumsum
    reaches ~1e12 magnitudes, so a small node's cumsum difference carries
    an absolute COM error that rivals the node's own extent. The monopole
    tolerates that jitter, but the parallel-axis quadrupole combine does
    not: it leaked S errors of the same order as S itself (measured
    pre-fix: BVH-quad NormError 1.6e-3 vs mono 6.5e-5 at N=2e5 2D;
    reference Accuracy(%) 68.7%). Post-fix the pairwise sums keep every
    node's COM within a few f32 ulps of the f64 value."""
    n = 30_000
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float32)
    kb = dim * MAX_BITS[dim]
    tree = build_bvh(sys.positions, sys.masses, kb, quad=True)
    rl, rr = np.asarray(tree.range_l), np.asarray(tree.range_r)
    ps = np.asarray(tree.pos_sorted, np.float64)
    ms = np.asarray(tree.mass_sorted, np.float64)
    cm = np.concatenate([[0.0], np.cumsum(ms)])
    cmx = np.vstack([np.zeros((1, dim)),
                     np.cumsum(ms[:, None] * ps, axis=0)])
    want_mass = cm[rr + 1] - cm[rl]
    want_com = (cmx[rr + 1] - cmx[rl]) / want_mass[:, None]
    com_err = np.abs(np.asarray(tree.node_com, np.float64)
                     - want_com).max()
    # f32 ulp at 1e7-scale coordinates is ~1; pairwise sums stay within
    # ~10 ulps even at the root. Prefix-sum differences gave ~1e3-1e4.
    assert com_err < 50.0, com_err
    np.testing.assert_allclose(np.asarray(tree.node_mass, np.float64),
                               want_mass, rtol=1e-5)


def test_quad_beats_mono(rng_key, dim):
    """The quadrupole far field must cut the MAC error vs monopole."""
    sys = random_system(rng_key, 2048, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    errs = {}
    for mp in ("mono", "quad"):
        got = bvh_forces(sys.positions, sys.masses, cfg, theta=0.5,
                         batch=128, group_size=32, multipole=mp)
        errs[mp] = float(scale_normalized_error(got, want))
    assert errs["quad"] < 0.4 * errs["mono"], errs
    assert errs["quad"] < 5e-3


def test_group_ids_subset_matches_full_walk(rng_key):
    """bvh_accel_sorted(group_ids=[...]) must reproduce the full walk's
    rows for those groups bit-for-bit at the same capacities (per-group
    walks are independent — the escalation driver relies on this)."""
    n, dim, G = 1024, 2, 64
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    kb = dim * MAX_BITS[dim]
    tree = build_bvh(sys.positions, sys.masses, kb, quad=True)
    kwargs = dict(theta=0.25, softening=0.0, group_size=G, batch=8,
                  frontier_width=512, near_cap=512, multipole="quad")
    full = bvh_accel_sorted(tree, **kwargs)  # [N, D] sorted order
    ids = jnp.asarray([1, 7, 12], jnp.int32)
    sub, maxw, ncnt, over = bvh_accel_sorted(
        tree, **kwargs, group_ids=ids, return_stats=True)
    assert sub.shape == (3 * G, dim)
    assert not bool(jnp.any(over))
    rows = (np.asarray(ids)[:, None] * G + np.arange(G)).reshape(-1)
    np.testing.assert_array_equal(np.asarray(sub),
                                  np.asarray(full)[rows])


def test_ragged_near_cap_no_double_count(rng_key):
    """A near_cap that is not a multiple of the pass-2 chunk must not
    re-evaluate the tail of the previous chunk (lax.dynamic_slice CLAMPS
    an out-of-bounds start): with a bag fuller than the clamp point the
    clamped re-read double-counted ~100 near windows, inflating clustered
    forces ~1.9×. The kernel now rounds the cap up to whole chunks."""
    n, dim = 512, 3
    k1, k2 = jax.random.split(rng_key)
    # Dense core ⇒ near bags fill well past NL - nl_chunk.
    core = 1e-3 * jax.random.uniform(k1, (n - 64, dim), jnp.float64) + 0.5
    halo = jax.random.uniform(k2, (64, dim), jnp.float64)
    pos = jnp.concatenate([core, halo])
    mass = jnp.ones((n,), jnp.float64)
    kb = dim * MAX_BITS[dim]
    tree = build_bvh(pos, mass, kb, quad=True)
    kwargs = dict(theta=0.5, softening=1e-4, group_size=32, batch=64,
                  frontier_width=1024, multipole="quad")
    ragged = bvh_accel_sorted(tree, **kwargs, near_cap=130)
    generous = bvh_accel_sorted(tree, **kwargs, near_cap=1024)
    assert bool(jnp.all(jnp.isfinite(ragged))), \
        "near_cap=130 (rounded up to whole chunks) should fit this input"
    np.testing.assert_allclose(np.asarray(ragged), np.asarray(generous),
                               rtol=1e-12)


def test_duplicate_positions(rng_key):
    """Identical keys exercise the index-tiebreak path (Karras §4)."""
    base = random_system(rng_key, 32, dim=2, dtype=jnp.float64)
    pos = jnp.concatenate([base.positions, base.positions[:8]])
    mass = jnp.concatenate([base.masses, base.masses[:8]])
    cfg = GravityConfig()
    got = bvh_forces(pos, mass, cfg, batch=64)
    want = brute_force_direct(pos, mass, cfg)
    assert np.all(np.isfinite(np.asarray(got)))
    err = float(scale_normalized_error(got, want))
    assert err < 5e-3
