"""chip_smoke.py's refusals and its float64 oracle, on the CPU.

The smoke itself runs only on a GPU; here it must refuse, print no result
line, and fail outside a full checkout. Its oracle (sampled target rows
against all sources, plain NumPy float64) is checked against the dense
direct sum.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_direct
from nbody_jax.utils.accuracy import (sample_rows, sampled_reference_forces,
                                      scale_normalized_error)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]).get("ok") if lines else None
    except (json.JSONDecodeError, AttributeError):
        return None


def test_smoke_refuses_cpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert _printed_result(proc.stdout) is None
    assert "no GPU" in proc.stderr


def test_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert _printed_result(proc.stdout) is None


def test_sample_rows_distinct_sorted_in_range():
    rows = sample_rows(10_000, 1024, seed=3)
    assert rows.size == 1024 and len(set(rows.tolist())) == 1024
    assert (np.diff(rows) > 0).all() and rows[0] >= 0 and rows[-1] < 10_000
    np.testing.assert_array_equal(rows, sample_rows(10_000, 1024, seed=3))
    assert sample_rows(50, 1024).size == 50  # never more rows than bodies


def test_sampled_oracle_matches_direct_sum(rng_key, dim):
    sys_ = random_system(rng_key, 700, dim=dim, dtype=jnp.float64)
    cfg = GravityConfig()
    rows = sample_rows(700, 64, seed=1)
    want = np.asarray(brute_force_direct(sys_.positions, sys_.masses,
                                         cfg))[rows]
    got = sampled_reference_forces(sys_.positions, sys_.masses, rows, cfg,
                                   chunk=7)
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-12 * np.abs(want).max())


def test_error_metric_survives_reference_units():
    """Forces in reference units are ~1e-17; the float32 metric must not
    underflow a real error to 0."""
    ref = np.full((4, 3), 1e-17, np.float32)
    got = ref * np.float32(1 + 1e-3)
    err = float(scale_normalized_error(jnp.asarray(got, jnp.float32),
                                       jnp.asarray(ref, jnp.float32)))
    np.testing.assert_allclose(err, 1e-3, rtol=1e-2)
