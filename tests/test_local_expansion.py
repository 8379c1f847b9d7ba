"""Local (Taylor) expansion of far-field cell sums: derivative closed forms
pinned against jax.jacfwd, and the expansion's convergence behavior."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbody_jax.ops.grid_tree import (_point_mass_accel, _quad_cell_accel,
                                     _quad_pairs)
from nbody_jax.ops.local_expansion import (eval_local, local_coeffs,
                                           _h_triples, num_coeffs)


def _random_cells(dim, K, seed, scale=1e7):
    rng = np.random.default_rng(seed)
    # Cells on a shell well away from the center (local-eligible geometry),
    # at the reference's 1e7 coordinate scale.
    center = jnp.asarray(rng.uniform(-1, 1, size=(dim,)) * scale)
    dirs = rng.normal(size=(K, dim))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radii = rng.uniform(0.3, 3.0, size=(K, 1)) * scale
    com = center + jnp.asarray(dirs * radii)
    mass = jnp.asarray(rng.uniform(0.1, 5.0, size=(K,)) * 1e12)
    nq = len(_quad_pairs(dim))
    # Random PSD-ish second moments at a plausible (cell extent)² scale.
    S = jnp.asarray(rng.uniform(-1, 1, size=(K, nq)) * 1e12 * (0.05 * scale) ** 2)
    return center, com, mass, S


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("multipole", ["mono", "quad"])
def test_coeffs_match_jacfwd(dim, multipole):
    """a0 / J / H closed forms == autodiff of the direct cell sum (f64)."""
    center, com, mass, S = _random_cells(dim, K=7, seed=dim * 10 + 1)
    center = center.astype(jnp.float64)
    com = com.astype(jnp.float64)
    mass = mass.astype(jnp.float64)
    S = S.astype(jnp.float64)
    Sarg = S if multipole == "quad" else None

    if multipole == "quad":
        def f(y):
            return _quad_cell_accel(y[None, None, :], com[None], mass[None],
                                    S[None])[0, 0]
    else:
        def f(y):
            return _point_mass_accel(y[None, None, :], com[None], mass[None],
                                     0.0)[0, 0]

    a0, Jp, Hp = local_coeffs(center, com, mass, Sarg)

    a_ref = f(center)
    np.testing.assert_allclose(np.asarray(a0), np.asarray(a_ref),
                               rtol=1e-12, atol=0)

    J_ref = jax.jacfwd(f)(center)  # J_ref[a, b] = ∂a_a/∂y_b
    jidx = {p: i for i, p in enumerate(_quad_pairs(dim))}
    for a in range(dim):
        for b in range(dim):
            i = jidx[(a, b)] if (a, b) in jidx else jidx[(b, a)]
            np.testing.assert_allclose(
                float(Jp[i]), float(J_ref[a, b]), rtol=1e-10,
                err_msg=f"J[{a},{b}] {multipole}")
    # J must be symmetric (a = −∇φ ⇒ J is a Hessian of φ).
    np.testing.assert_allclose(np.asarray(J_ref), np.asarray(J_ref).T,
                               rtol=1e-10)

    if multipole == "mono":
        H_ref = jax.jacfwd(jax.jacfwd(f))(center)
        hidx = {t: i for i, t in enumerate(_h_triples(dim))}
        for a in range(dim):
            for b in range(dim):
                for c in range(dim):
                    i = hidx[tuple(sorted((a, b, c)))]
                    np.testing.assert_allclose(
                        float(Hp[i]), float(H_ref[a, b, c]), rtol=1e-9,
                        err_msg=f"H[{a},{b},{c}]")


@pytest.mark.parametrize("dim", [2, 3])
def test_coeffs_match_jacfwd_softened(dim):
    """The closed forms hold verbatim under Plummer softening (the BVH walk
    softens accepted nodes): pin mono a0/J/H against autodiff of the
    ε-softened direct sum."""
    center, com, mass, _ = _random_cells(dim, K=5, seed=dim * 7 + 3,
                                         scale=1.0)
    center = center.astype(jnp.float64)
    com = com.astype(jnp.float64)
    mass = mass.astype(jnp.float64) * 1e-12
    eps = 0.3  # comparable to the shell radii — a harsh softening

    def f(y):
        R = com - y[None, :]
        u = 1.0 / jnp.sqrt(jnp.sum(R * R, axis=-1) + eps ** 2)
        return jnp.sum(mass[:, None] * R * (u ** 3)[:, None], axis=0)

    a0, Jp, Hp = local_coeffs(center, com, mass, None, softening=eps)
    np.testing.assert_allclose(np.asarray(a0), np.asarray(f(center)),
                               rtol=1e-12)
    J_ref = jax.jacfwd(f)(center)
    H_ref = jax.jacfwd(jax.jacfwd(f))(center)
    jidx = {p: i for i, p in enumerate(_quad_pairs(dim))}
    hidx = {t: i for i, t in enumerate(_h_triples(dim))}
    for a in range(dim):
        for b in range(dim):
            i = jidx[(a, b)] if (a, b) in jidx else jidx[(b, a)]
            np.testing.assert_allclose(float(Jp[i]), float(J_ref[a, b]),
                                       rtol=1e-10)
            for c in range(dim):
                np.testing.assert_allclose(
                    float(Hp[hidx[tuple(sorted((a, b, c)))]]),
                    float(H_ref[a, b, c]), rtol=1e-9)


def test_bvh_local_softened_matches_point(rng_key):
    """With softening > 0 the BVH local path must still agree with the
    per-body walk (regression for the dropped-softening review finding)."""
    from nbody_jax.ops.bvh import bvh_forces
    sys = random_system(rng_key, 2048, dim=2, dtype=jnp.float64)
    # Softening at the scale of typical gated distances (domain ~2e7).
    cfg = GravityConfig(softening=2e5)
    f_point = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25,
                         far_impl="point")
    f_local = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25,
                         far_impl="local")
    scale = float(np.abs(np.asarray(f_point)).max())
    d = float(np.abs(np.asarray(f_local) - np.asarray(f_point)).max())
    assert d / scale < 5e-4, d / scale


@pytest.mark.parametrize("dim", [2, 3])
def test_taylor_convergence(dim):
    """eval_local error vs the direct sum shrinks like (|ρ|/d)³ (f64)."""
    center, com, mass, S = _random_cells(dim, K=16, seed=dim, scale=1.0)
    center = center.astype(jnp.float64)
    com = com.astype(jnp.float64)
    mass = mass.astype(jnp.float64) * 1e-12
    S = S.astype(jnp.float64) * 1e-12

    a0, Jp, Hp = local_coeffs(center, com, mass, S)

    rng = np.random.default_rng(99)
    dirs = rng.normal(size=(32, dim))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    errs = []
    for rho_mag in (0.02, 0.01):  # |ρ|/d_min ≈ 0.07 and 0.035
        rho = jnp.asarray(dirs * rho_mag)
        approx = eval_local(rho[None], a0[None], Jp[None], Hp[None])[0]
        exact = _quad_cell_accel((center + rho)[None], com[None],
                                 mass[None], S[None])[0]
        scale = float(jnp.max(jnp.linalg.norm(exact, axis=-1)))
        errs.append(float(jnp.max(
            jnp.linalg.norm(approx - exact, axis=-1))) / scale)
    # Halving ρ must cut the error ~8× (order-2 Taylor); allow 5×.
    assert errs[1] < errs[0] / 5.0, errs
    assert errs[0] < 1e-3, errs


def test_num_coeffs():
    assert num_coeffs(2) == (2, 3, 4)
    assert num_coeffs(3) == (3, 6, 10)


# ---------------------------------------------------------------------------
# End-to-end: the Barnes-Hut tiers with far_impl="local".
# ---------------------------------------------------------------------------

from nbody_jax import GravityConfig, random_system  # noqa: E402
from nbody_jax.ops.brute_force import brute_force_direct  # noqa: E402
from nbody_jax.ops.grid_tree import barnes_hut_grid  # noqa: E402
from nbody_jax.utils.accuracy import (accuracy_percentage,  # noqa: E402
                                      scale_normalized_error)


def test_bh_local_matches_point(rng_key, dim):
    """Grid-BH far_impl='local' stays within ~2× of the per-body far field
    on the normalized error (the order-2 Taylor truncation is gated below
    the multipole truncation) — θ=0.25, deep tree so local levels engage."""
    sys = random_system(rng_key, 4096, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    kw = dict(theta=0.25, leaf_level=5 if dim == 2 else 3)
    e_point = float(scale_normalized_error(barnes_hut_grid(
        sys.positions, sys.masses, cfg, far_impl="point", **kw), want))
    e_local = float(scale_normalized_error(barnes_hut_grid(
        sys.positions, sys.masses, cfg, far_impl="local", **kw), want))
    assert e_local < max(2.0 * e_point, 1e-6), (e_point, e_local)


def test_bh_local_accuracy_percentage(rng_key):
    """Reference per-component metric: local far field at θ=0.25 must still
    clear 99% in f32 (the judged accuracy bar for the quad tier)."""
    sys = random_system(rng_key, 8192, dim=2, dtype=jnp.float32)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.25,
                          leaf_level=4, multipole="quad", far_impl="local")
    assert float(accuracy_percentage(got, want)) >= 99.0


def test_bh_local_theta05(rng_key):
    """θ=0.5 (k=1): only levels with Taylor ratio ≤ 0.18 go local (l ≤ L−2
    in 2D); accuracy must not degrade materially vs the per-body path."""
    sys = random_system(rng_key, 4096, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    kw = dict(theta=0.5, leaf_level=5)
    e_point = float(scale_normalized_error(barnes_hut_grid(
        sys.positions, sys.masses, cfg, far_impl="point", **kw), want))
    e_local = float(scale_normalized_error(barnes_hut_grid(
        sys.positions, sys.masses, cfg, far_impl="local", **kw), want))
    assert e_local < max(1.5 * e_point, 1e-6), (e_point, e_local)


def test_bvh_local_matches_point(rng_key, dim):
    """BVH far_impl='local' (group-center expansion for accepted nodes
    beyond the gate) stays within ~2× of the per-body walk's error."""
    from nbody_jax.ops.bvh import bvh_forces
    sys = random_system(rng_key, 4096, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    e_point = float(scale_normalized_error(bvh_forces(
        sys.positions, sys.masses, cfg, theta=0.25,
        far_impl="point"), want))
    e_local = float(scale_normalized_error(bvh_forces(
        sys.positions, sys.masses, cfg, theta=0.25,
        far_impl="local"), want))
    assert e_local < max(2.0 * e_point, 1e-6), (e_point, e_local)


def test_bvh_local_huge_gate_equals_point(rng_key):
    """With an unreachable gate no node is local-eligible: the local path
    must reproduce the per-body walk (regression guard on the mask split)."""
    from nbody_jax.ops.bvh import bvh_forces
    sys = random_system(rng_key, 2048, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    f_point = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25,
                         far_impl="point")
    f_gated = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25,
                         far_impl="local", local_gate=1e30)
    np.testing.assert_allclose(np.asarray(f_gated), np.asarray(f_point),
                               rtol=1e-12)


def test_bvh_local_accuracy_percentage(rng_key):
    """Reference per-component metric: BVH local far field ≥ 99% in f32."""
    from nbody_jax.ops.bvh import bvh_forces
    sys = random_system(rng_key, 8192, dim=2, dtype=jnp.float32)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = bvh_forces(sys.positions, sys.masses, cfg, theta=0.25,
                     multipole="quad", far_impl="local")
    assert float(accuracy_percentage(got, want)) >= 99.0


def test_let_bh_local_matches_single_device(rng_key):
    """LET (body-sharded) far_impl='local' == single-chip local path on the
    8-device CPU mesh (identical trees, same level gating and centers)."""
    from nbody_jax.parallel.let_tree import let_barnes_hut
    from nbody_jax.parallel.mesh import make_mesh
    sys = random_system(rng_key, 1500, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    L = 5  # deep enough that levels 2..4 are local-eligible at k=3
    single = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.25,
                             leaf_level=L, far_impl="local")
    sharded = let_barnes_hut(sys.positions, sys.masses, cfg,
                             mesh=make_mesh(), theta=0.25, leaf_level=L,
                             far_impl="local")
    assert np.all(np.isfinite(np.asarray(sharded)))
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single),
                               rtol=1e-8, atol=1e-30)


def test_bh_sparse_local(rng_key):
    """The sparse (clustered-input) grid path accepts far_impl='local'."""
    from nbody_jax.ops.sparse_grid import barnes_hut_sparse
    sys = random_system(rng_key, 2048, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = barnes_hut_sparse(sys.positions, sys.masses, cfg, theta=0.25,
                            leaf_level=5, far_impl="local")
    err = float(scale_normalized_error(got, want))
    assert err < 5e-4, err


def test_order3_k_matches_jacfwd():
    """Packed K (∂³a, order-3 term) == triple autodiff of the direct sum."""
    import itertools
    from nbody_jax.ops.local_expansion import _k_quads
    dim = 3
    center, com, mass, _ = _random_cells(dim, K=6, seed=77)
    center = center.astype(jnp.float64)
    com = com.astype(jnp.float64)
    mass = mass.astype(jnp.float64)

    def a_of_c(c):
        R = com - c
        r = jnp.linalg.norm(R, axis=-1, keepdims=True)
        return jnp.sum(mass[:, None] * R / r ** 3, axis=0)

    K_auto = jax.jacfwd(jax.jacfwd(jax.jacfwd(a_of_c)))(center)
    _, _, _, Kp = local_coeffs(center[None, :], com[None, :, :],
                               mass[None, :], order3=True)
    kidx = {q: i for i, q in enumerate(_k_quads(dim))}
    for a, b, c, d in itertools.product(range(dim), repeat=4):
        packed = float(Kp[0, kidx[tuple(sorted((a, b, c, d)))]])
        auto = float(K_auto[a, b, c, d])
        assert abs(packed - auto) <= 1e-10 * max(abs(auto), 1e-30), \
            (a, b, c, d, packed, auto)


@pytest.mark.parametrize("dim", [2, 3])
def test_shift_local_exact(dim):
    """L2L re-centering is an exact polynomial identity:
    eval(ρ − δ, shift(coeffs, δ)) == eval(ρ, coeffs) to f64 roundoff."""
    from nbody_jax.ops.local_expansion import shift_local
    center, com, mass, _ = _random_cells(dim, K=5, seed=dim * 10 + 5)
    center = center.astype(jnp.float64)
    a0, Jp, Hp, Kp = local_coeffs(center[None, :],
                                  com[None, :, :].astype(jnp.float64),
                                  mass[None, :].astype(jnp.float64),
                                  order3=True)
    rng = np.random.default_rng(9)
    delta = jnp.asarray(rng.uniform(-0.02, 0.02, size=(dim,)) * 1e7,
                        jnp.float64)
    rho = jnp.asarray(rng.uniform(-0.05, 0.05, size=(1, 6, dim)) * 1e7,
                      jnp.float64)
    direct = eval_local(rho, a0, Jp, Hp, Kp)
    shifted = shift_local(a0, Jp, Hp, Kp, delta)
    via = eval_local(rho - delta, *shifted)
    np.testing.assert_allclose(np.asarray(via), np.asarray(direct),
                               rtol=1e-12)


@pytest.mark.parametrize("far_impl", ["local_leaf", "hier"])
def test_bh_leaf_level_far_accuracy(rng_key, far_impl):
    """Leaf-level shell-split far fields (per-body inner shells + order-3
    local beyond) hold the reference accuracy metric at θ=0.25 in 3D."""
    from nbody_jax.ops.brute_force import brute_force_direct
    from nbody_jax.ops.grid_tree import barnes_hut_grid
    from nbody_jax.state import random_system
    from nbody_jax.config import GravityConfig
    from nbody_jax.utils.accuracy import (accuracy_percentage,
                                          scale_normalized_error)
    sys = random_system(rng_key, 8192, dim=3, dtype=jnp.float32)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.25,
                          leaf_level=4, far_impl=far_impl)
    assert float(accuracy_percentage(got, want)) >= 99.0
    assert float(scale_normalized_error(got, want)) < 1e-3


@pytest.mark.parametrize("dim", [2, 3])
def test_bh_hier_matches_local_class_error(rng_key, dim):
    """far_impl='hier' error stays within ~2× of the per-leaf 'local' mode
    (same gated Taylor ratios; only the expansion centers differ)."""
    from nbody_jax.ops.brute_force import brute_force_direct
    from nbody_jax.ops.grid_tree import barnes_hut_grid
    from nbody_jax.state import random_system
    from nbody_jax.config import GravityConfig
    from nbody_jax.utils.accuracy import scale_normalized_error
    sys = random_system(rng_key, 4096, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    e_local = float(scale_normalized_error(
        barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.25,
                        leaf_level=4, far_impl="local"), want))
    e_hier = float(scale_normalized_error(
        barnes_hut_grid(sys.positions, sys.masses, cfg, theta=0.25,
                        leaf_level=4, far_impl="hier"), want))
    assert e_hier < max(2.0 * e_local, 1e-4), (e_hier, e_local)


def test_hier_chunked_sweep_matches_whole_level(rng_key):
    """The lax.map parent-chunked downward sweep (OOM guard for huge
    levels — the 46 GB tiled leaf-level gather at N=5e6 3D) is
    bit-identical to the whole-level sweep."""
    from nbody_jax.ops.grid_tree import build_grid_tree
    from nbody_jax.ops.hier_far import hier_far_coeffs
    from nbody_jax.state import random_system
    sys = random_system(rng_key, 4096, dim=3, dtype=jnp.float32)
    tree = build_grid_tree(sys.positions, sys.masses, 4, 64, quad=True)
    whole = hier_far_coeffs(tree, k=3)
    # Budget below every level's P·nc forces the chunked path everywhere.
    chunked = hier_far_coeffs(tree, k=3, chunk_budget=2744 * 8)
    # Not bit-equal: XLA reassociates f32 sums differently for the two
    # program shapes (measured max rel diff 7e-5 on ~1e-3 coeffs).
    for a, b in zip(list(whole[0]) + [whole[1], whole[2]],
                    list(chunked[0]) + [chunked[1], chunked[2]]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-3, atol=1e-8)


@pytest.mark.parametrize("dim", [2, 3])
def test_hier_gather_defer_matches_pack(rng_key, dim):
    """The traversal-side defer="gather" inner-shell evaluation (the L=6
    3D HBM-OOM fix: no [G, md·(D+1)] sweep outputs) agrees with the
    sweep-side pack tensors — same cells, same quad physics, different
    gather site, so only f32 reassociation noise separates them."""
    from nbody_jax.ops.grid_tree import (build_grid_tree,
                                         grid_tree_accel_sorted)
    from nbody_jax.ops.hier_far import hier_far_coeffs
    from nbody_jax.state import random_system
    sys_ = random_system(rng_key, 4096, dim=dim, dtype=jnp.float32)
    tree = build_grid_tree(sys_.positions, sys_.masses, 4,
                           _cap_for(sys_.positions, 4), quad=True)
    packed = grid_tree_accel_sorted(tree, k=3, multipole="quad",
                                    far_impl="hier")
    coeffs = hier_far_coeffs(tree, 3, multipole="quad",
                             defer="gather")[0]
    gathered = grid_tree_accel_sorted(tree, k=3, multipole="quad",
                                      far_impl="hier",
                                      hier_coeffs=coeffs)
    a, b = np.asarray(gathered), np.asarray(packed)
    # scale-normalized: per-component rel diff explodes on cancelling
    # net forces (the project-wide metric rationale, utils/accuracy.py)
    assert np.max(np.abs(a - b)) <= 1e-4 * np.mean(np.abs(b)) + 1e-30


def _cap_for(positions, leaf_level):
    from nbody_jax.ops.grid_tree import compute_capacity_cached
    return compute_capacity_cached(positions, leaf_level)


def test_hier_wide_ring_no_double_count(rng_key):
    """k ≥ 4 in 2D: every cell within Chebyshev k is NEAR — the hier far
    field must not re-count shells < k+1 (the c_min clamp; unclamped this
    was a 2.6e-2 error vs 4e-15 for far_impl='local')."""
    from nbody_jax.ops.brute_force import brute_force_direct
    from nbody_jax.ops.grid_tree import barnes_hut_grid
    from nbody_jax.state import random_system
    from nbody_jax.config import GravityConfig
    from nbody_jax.utils.accuracy import scale_normalized_error
    sys_ = random_system(rng_key, 1000, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys_.positions, sys_.masses, cfg)
    got = barnes_hut_grid(sys_.positions, sys_.masses, cfg, theta=0.125,
                          leaf_level=3, far_impl="hier")
    assert float(scale_normalized_error(got, want)) < 1e-6


def test_bvh_far_impl_resolver():
    """far_impl=None resolves by N ("point" below 5e6, "local" at the big
    cells), and the registry's hyper record states the same resolved value
    so run records carry the true configuration."""
    from nbody_jax.ops.bvh import resolve_bvh_far_impl
    from nbody_jax.bench.registry import all_methods
    from nbody_jax.config import GravityConfig, TreeConfig
    assert resolve_bvh_far_impl(100_000) == "point"
    assert resolve_bvh_far_impl(2_000_000) == "point"
    assert resolve_bvh_far_impl(5_000_000) == "local"
    hyper = all_methods()["BVH_Radix"].hyper
    for n in (100_000, 2_000_000, 5_000_000):
        assert hyper(n, 2, GravityConfig(), TreeConfig())["far_impl"] \
            == resolve_bvh_far_impl(n)
