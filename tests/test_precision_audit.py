"""Every floating-point ``dot_general`` of every force tier asks for HIGHEST.

On an H100 a float32 product at default precision may run in TF32 (about
three decimal digits), which breaks the 1e-4 accuracy gate of the FMM tier.
This audit traces each tier to a jaxpr, walks every nested jaxpr (jit, scan,
map, cond, shard_map, pallas_call bodies) and checks the precision of each
product. Tiers with host-side probes are traced with those probes' results
passed in explicitly.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
from jax.extend import core as jex_core

from nbody_jax import GravityConfig, random_system
from nbody_jax.ops.brute_force import brute_force_blocked
from nbody_jax.ops.bvh import _bvh_fused
from nbody_jax.ops.keys import MAX_BITS
from nbody_jax.ops.fmm import fmm_forces
from nbody_jax.ops.grid_tree import barnes_hut_grid
from nbody_jax.ops.pallas_brute import brute_force_pallas
from nbody_jax.parallel.let_tree import let_fmm
from nbody_jax.parallel.mesh import make_mesh

HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(params):
    for v in params.values():
        for x in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(x, jex_core.ClosedJaxpr):
                yield x.jaxpr
            elif isinstance(x, jex_core.Jaxpr):
                yield x


def float_dots(jaxpr):
    """All float dot_general equations in ``jaxpr`` and its sub-jaxprs."""
    for eqn in jaxpr.eqns:
        if (eqn.primitive.name == "dot_general"
                and jnp.issubdtype(eqn.invars[0].aval.dtype, jnp.floating)):
            yield eqn
        for sub in _sub_jaxprs(eqn.params):
            yield from float_dots(sub)


def _is_highest(precision):
    ps = precision if isinstance(precision, tuple) else (precision,)
    return all(p == HIGHEST for p in ps)


CFG = GravityConfig()
TIERS = {
    # name: (forces(pos, mass), must contain at least one product)
    "brute_jnp": (lambda p, m: brute_force_blocked(p, m, CFG), False),
    "brute_pallas": (functools.partial(brute_force_pallas, config=CFG,
                                       interpret=True), False),
    "barnes_hut": (lambda p, m: barnes_hut_grid(
        p, m, CFG, theta=0.5, leaf_level=2, capacity=64), False),
    # bvh_forces reads overflow stats on the host; its fused device
    # program is traced with the capacities it would pass.
    "bvh": (lambda p, m: _bvh_fused(
        p, m, jnp.float32(CFG.G), key_bits=3 * MAX_BITS[3], quad=True,
        leaf_size=16, theta=0.25, softening=CFG.softening, group_size=256,
        batch=128, frontier_width=512, near_cap=512, multipole="quad",
        far_impl="local")[0], False),
    "fmm": (lambda p, m: fmm_forces(p, m, CFG, order=4, leaf_level=2,
                                    capacity=64), True),
    "let_fmm": (lambda p, m: let_fmm(
        p, m, CFG, mesh=make_mesh(jax.devices()[:2]), order=4,
        leaf_level=2, capacity=64, bucket_headroom=4.0), True),
}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tier_products_run_at_highest(rng_key, tier):
    fn, needs_dot = TIERS[tier]
    sys = random_system(rng_key, 256, dim=3, dtype=jnp.float32)
    jaxpr = jax.make_jaxpr(fn)(sys.positions, sys.masses).jaxpr
    dots = list(float_dots(jaxpr))
    if needs_dot:
        assert dots, f"{tier}: no products traced — the audit saw nothing"
    bad = [str(e.params["precision"]) for e in dots
           if not _is_highest(e.params["precision"])]
    assert not bad, f"{tier}: products below HIGHEST: {bad}"
