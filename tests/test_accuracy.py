import jax.numpy as jnp
import numpy as np

from nbody_jax import (accuracy_percentage, max_relative_error,
                       percentile_relative_error)


def test_percentile_ignores_cancelling_tail():
    """One body with a near-cancelling net force wrecks max_relative_error
    but not the p99 percentile (the metric's reason to exist)."""
    n = 200
    ref = np.ones((n, 2))
    ref[0] = [1e-12, 0.0]  # near-cancelling net force
    f = ref.copy()
    f[:, 0] += 1e-3       # uniform absolute error
    assert float(max_relative_error(f, ref)) > 1e6
    p99 = float(percentile_relative_error(f, ref, 99.0))
    assert 5e-4 < p99 < 2e-3, p99


def test_percentile_nan_strict():
    ref = np.ones((4, 2))
    f = ref.copy()
    f[2, 1] = np.nan
    assert not np.isfinite(float(percentile_relative_error(f, ref)))


def test_identical_is_100():
    f = jnp.array([[1.0, 2.0], [3.0, 4.0]])
    assert float(accuracy_percentage(f, f)) == 100.0
    assert float(max_relative_error(f, f)) == 0.0


def test_one_percent_threshold():
    ref = jnp.array([[1.0, 1.0]])
    ok = ref * 1.009
    bad = ref * 1.02
    assert float(accuracy_percentage(ok, ref)) == 100.0
    assert float(accuracy_percentage(bad, ref)) == 0.0


def test_nan_is_inaccurate():
    """Anti-regression vs utils.h:200-204 where NaN passes (SURVEY.md §8.6)."""
    ref = jnp.array([[1.0, 1.0], [2.0, 2.0]])
    f = jnp.array([[jnp.nan, 1.0], [2.0, 2.0]])
    assert float(accuracy_percentage(f, ref)) == 50.0
    assert not np.isfinite(float(max_relative_error(f, ref)))


def test_sign_flip_detected():
    """Anti-regression vs the BH/BVH sign inversion (SURVEY.md §8.1)."""
    ref = jnp.array([[1.0, -2.0, 3.0]])
    assert float(accuracy_percentage(-ref, ref)) == 0.0
    np.testing.assert_allclose(float(max_relative_error(-ref, ref)), 2.0)


def test_near_zero_absolute_branch():
    # Reference component below 1e-20 → absolute check vs 1e-9 (utils.h:191-198).
    ref = jnp.array([[1e-30, 1.0]])
    ok = jnp.array([[5e-10, 1.0]])
    bad = jnp.array([[5e-9, 1.0]])
    assert float(accuracy_percentage(ok, ref)) == 100.0
    assert float(accuracy_percentage(bad, ref)) == 0.0


def test_shape_mismatch_raises():
    import pytest
    with pytest.raises(ValueError):
        accuracy_percentage(jnp.zeros((2, 2)), jnp.zeros((3, 2)))
