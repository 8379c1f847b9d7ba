import jax.numpy as jnp

from nbody_jax import random_system
from nbody_jax.utils.profiling import PhaseTimer, phase_breakdown_fmm


def test_phase_timer_basic():
    t = PhaseTimer()
    with t.phase("a"):
        sum(range(1000))
    out = t.timed("b", lambda: jnp.arange(8.0))
    assert out.shape == (8,)
    rep = t.report()
    assert "a" in rep and "b" in rep and "total" in rep
    assert t.counts["a"] == 1


def test_fmm_breakdown(rng_key):
    sys = random_system(rng_key, 500, dim=2, dtype=jnp.float32)
    timer = phase_breakdown_fmm(sys.positions, sys.masses, order=3)
    rep = timer.report()
    assert "tree_build" in rep and "fmm_eval" in rep
    assert all(v >= 0 for v in timer.times.values())
