"""Black-box FMM: operator sanity, convergence in order, oracle accuracy."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.ops import fmm as F
from nbody_jax.utils.accuracy import scale_normalized_error


def test_interp_matrix_partition_of_unity():
    # Σ_m S_n(t_m, y) = 1 for any y (interpolation of the constant 1).
    for n in (3, 5, 8):
        y = np.linspace(-1, 1, 17)
        S = F.s_matrix(n, y)
        np.testing.assert_allclose(S.sum(axis=1), 1.0, atol=1e-12)


def test_interp_exact_for_low_degree():
    # Chebyshev interpolation reproduces polynomials of degree < n exactly.
    n = 5
    t = F.cheb_nodes(n)
    f = lambda x: 3 * x ** 3 - x ** 2 + 0.5 * x - 2
    y = np.linspace(-0.9, 0.9, 13)
    S = F.s_matrix(n, y)
    np.testing.assert_allclose(S @ f(t), f(y), atol=1e-12)


def test_m2m_preserves_totals():
    """Interpolating the constant-1 function: total weight is conserved."""
    for dim in (2, 3):
        n = 4
        ops = F.m2m_operators(dim, n)
        assert ops.shape == (2 ** dim, n ** dim, n ** dim)
        # Columns sum to 1: anterpolation preserves total mass.
        np.testing.assert_allclose(ops.sum(axis=1), 1.0, atol=1e-10)


def test_v_list_counts():
    # Classical counts: 2D ≤ 27 per cell (k=1); union over parities is 40.
    d2 = F._v_list_deltas(2, 1)
    assert len(d2) == 40
    d3 = F._v_list_deltas(3, 1)
    assert len(d3) == 316
    # Every delta is non-near.
    assert all(np.abs(delta).max() > 1 for delta, _ in d2)


def test_jnp_cheb_matches_numpy():
    y = jnp.linspace(-0.95, 0.95, 9)
    T, dT = F._jnp_cheb_T_and_dT(5, y)
    Tn = F._cheb_T(5, np.asarray(y)).T
    np.testing.assert_allclose(np.asarray(T), Tn, atol=1e-6)
    # derivative check: T_3' = 12x^2 - 3
    np.testing.assert_allclose(np.asarray(dT[:, 3]),
                               12 * np.asarray(y) ** 2 - 3, atol=1e-5)


@pytest.mark.parametrize("n", [512, 1200])
def test_fmm_matches_direct(rng_key, dim, n):
    sys = random_system(rng_key, n, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = F.fmm_forces(sys.positions, sys.masses, cfg, order=6,
                       leaf_batch=256)
    err = float(scale_normalized_error(got, want))
    assert err < 1e-3, f"FMM order-6 error too large: {err}"


def test_fmm_converges_with_order(rng_key):
    sys = random_system(rng_key, 1000, dim=2, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    # Explicit level so the tree has a real far field at N=1000.
    errs = [float(scale_normalized_error(
        F.fmm_forces(sys.positions, sys.masses, cfg, order=o,
                     leaf_level=3, leaf_batch=256), want)) for o in (2, 4, 6)]
    assert errs[1] < errs[0] and errs[2] < errs[1], errs
    assert errs[2] < 1e-4, errs


def test_fmm_order8_hits_gate(rng_key):
    """BASELINE.json gate: FMM force fidelity ≤ 1e-4 vs direct sum."""
    sys = random_system(rng_key, 1200, dim=3, dtype=jnp.float64)
    cfg = GravityConfig()
    want = brute_force_direct(sys.positions, sys.masses, cfg)
    got = F.fmm_forces(sys.positions, sys.masses, cfg, order=8,
                       leaf_batch=128)
    err = float(scale_normalized_error(got, want))
    assert err < 1e-4, f"order-8 gate failed: {err}"
