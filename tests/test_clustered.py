"""Tree tiers on strongly clustered (Plummer) distributions.

The grid tree is uniform, so clustering inflates leaf capacity — these
tests pin down that the result stays *correct* (the documented cost is
memory/padding, not accuracy)."""

import jax.numpy as jnp

from nbody_jax import GravityConfig
from nbody_jax.models import plummer_sphere
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.ops.bvh import bvh_forces
from nbody_jax.ops.fmm import fmm_forces
from nbody_jax.ops.grid_tree import barnes_hut_grid, compute_capacity, auto_leaf_level
from nbody_jax.utils.accuracy import scale_normalized_error

import pytest

pytestmark = pytest.mark.slow


def test_bh_on_plummer(rng_key):
    sys, cfg = plummer_sphere(rng_key, 300, dtype=jnp.float64)
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.5)
    assert float(scale_normalized_error(got, want)) < 4e-2
    # Capacity inflates under clustering but stays bounded for this N.
    L = auto_leaf_level(300, 3)
    assert compute_capacity(sys.positions, L) <= 300


def test_fmm_on_plummer(rng_key):
    sys, cfg = plummer_sphere(rng_key, 300, dtype=jnp.float64)
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = fmm_forces(sys.positions, sys.masses, cfg, order=4,
                     leaf_batch=64)
    assert float(scale_normalized_error(got, want)) < 2e-2


def test_bvh_on_plummer(rng_key):
    # The adaptive radix BVH handles clustering natively.
    sys, cfg = plummer_sphere(rng_key, 500, dtype=jnp.float64)
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25,
                     group_size=16, batch=128)
    assert float(scale_normalized_error(got, want)) < 5e-3


def _clustered_system(key, n: int, frac: float = 0.9, dim: int = 3):
    """``frac`` of the bodies in a 1e-3-wide ball, the rest uniform in the
    unit cube — the densest leaf cell holds ~frac·n bodies at any coarse
    leaf level."""
    import jax
    k1, k2 = jax.random.split(key)
    nc = int(n * frac)
    core = 1e-3 * jax.random.uniform(k1, (nc, dim), jnp.float64)
    halo = jax.random.uniform(k2, (n - nc, dim), jnp.float64)
    pos = jnp.concatenate([core + 0.5, halo])
    mass = jnp.ones((n,), jnp.float64)
    return pos, mass


def test_grid_guard_refuses_degenerate_capacity(rng_key):
    """The uniform grid's capacity² near field would explode on a dense
    core (measured: Plummer N=1e5 3D ⇒ capacity 63752, a ~40 TB near
    tensor). The DENSE layout must refuse with guidance, not OOM;
    layout="auto" (the default) instead falls back to the sparse chunked
    path (ops/sparse_grid.py, tests/test_sparse_grid.py) and answers."""
    import pytest
    pos, mass = _clustered_system(rng_key, 10_000)
    cfg = GravityConfig(G=1.0, softening=1e-4)
    with pytest.raises(ValueError, match="bvh_forces"):
        barnes_hut_grid(pos, mass, cfg, theta=0.5, layout="dense")
    with pytest.raises(ValueError, match="clustered"):
        fmm_forces(pos, mass, cfg, order=4, layout="dense")
    # The default answers via the sparse fallback.
    want = brute_force_direct(pos, mass, cfg)
    got = barnes_hut_grid(pos, mass, cfg, theta=0.5)
    assert float(scale_normalized_error(got, want)) < 5e-2


def test_skewed_small_capacity_takes_sparse_fallback(rng_key):
    """Skew trigger of ``dense_layout_degenerate``: a small-N clustered
    input whose capacity clears the absolute 4096 guard (N=4000, 60% of
    bodies in one cell ⇒ capacity ~2400) but whose max/mean occupancy is
    ~150× at the θ=0.25 leaf level — the dense layout there is a ~595 GB
    near tensor (OOM'd the CPU backend before the skew trigger existed).
    layout="auto" must answer via the sparse path instead."""
    from nbody_jax.ops.grid_tree import dense_layout_degenerate

    pos, mass = _clustered_system(rng_key, 4_000, frac=0.6, dim=2)
    cfg = GravityConfig(G=1.0, softening=1e-4)
    level = auto_leaf_level(4_000, 2, k=3)  # θ=0.25 ring
    cap = compute_capacity(pos, level)
    assert cap <= 4096  # below the absolute guard: only skew catches it
    assert dense_layout_degenerate(cap, 4_000, level, 2)
    want = brute_force_direct(pos, mass, cfg)
    got = barnes_hut_grid(pos, mass, cfg, theta=0.25)
    assert bool(jnp.all(jnp.isfinite(got)))
    assert float(scale_normalized_error(got, want)) < 1e-3
    got_f = fmm_forces(pos, mass, cfg, order=5, leaf_level=level)
    assert bool(jnp.all(jnp.isfinite(got_f)))
    assert float(scale_normalized_error(got_f, want)) < 1e-3


def test_bvh_escalates_capacities_on_overflow(rng_key):
    """Deliberately tiny traversal capacities must auto-escalate to a
    finite, accurate answer (never a silent truncation)."""
    pos, mass = _clustered_system(rng_key, 2_000)
    cfg = GravityConfig(G=1.0, softening=1e-4)
    want = brute_force_direct(pos, mass, cfg)
    got = bvh_forces(pos, mass, cfg, theta=0.5, group_size=32,
                     frontier_width=16, near_cap=16, max_escalations=8)
    assert bool(jnp.all(jnp.isfinite(got)))
    # θ=0.5 group-MAC accuracy on this adversarial core sits ~3e-2.
    assert float(scale_normalized_error(got, want)) < 5e-2


def test_bvh_subset_escalation_matches_full_run(rng_key):
    """The subset re-dispatch (only overflowed groups re-walk at raised
    caps) must agree with a single generous-capacity run: per-group walks
    are independent, so the re-walked groups are bit-compatible and the
    untouched groups differ only by frontier chunking fp order."""
    pos, mass = _clustered_system(rng_key, 2_000, frac=0.3)
    cfg = GravityConfig(G=1.0, softening=1e-4)
    generous = bvh_forces(pos, mass, cfg, theta=0.5, group_size=32,
                          frontier_width=4000, near_cap=4000,
                          max_escalations=0)
    assert bool(jnp.all(jnp.isfinite(generous)))
    escalated = bvh_forces(pos, mass, cfg, theta=0.5, group_size=32,
                           frontier_width=48, near_cap=48,
                           max_escalations=8)
    assert bool(jnp.all(jnp.isfinite(escalated)))
    assert float(scale_normalized_error(escalated, generous)) < 1e-12
