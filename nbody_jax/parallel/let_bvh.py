"""Body-sharded BVH tier with locally-essential-tree ring evaluation.

Completes O(N/P) per-chip body memory across all four algorithm tiers
(parallel/let_tree.py covers Barnes-Hut and FMM; the BVH tier's previous
multi-chip path, parallel/sharded_tree.bvh_sharded, replicates every body
and the whole radix tree on every chip).

Design (the reference has no distributed layer at all —
SURVEY.md §2.4):

1. **Exchange** — reuse the grid LET's Morton bucket + ``all_to_all``
   (let_tree._exchange): each chip ends holding exactly the bodies of its
   contiguous spatial chunk. The grid level here only routes bodies to
   owners; the BVH adapts freely within the chunk, so clustered inputs
   keep the radix tree's adaptivity.
2. **Local build** — each chip builds an independent Karras radix BVH
   (ops/bvh.build_bvh) over its resident bodies. No global tree exists
   anywhere; per-chip node memory is O(N/P).
3. **Self pass** — the chip's body groups walk their own tree with the
   standard frontier-expansion traversal (ops/bvh.bvh_accel_sorted).
4. **Ring pass** — the packed tree summaries (node_table + body_table,
   O(N/P) floats) rotate around the chips on a ``ppermute`` ring; at each
   of the P−1 steps every chip's groups walk the *foreign* tree
   (``bvh_accel_sorted(source=...)``). Distant foreign chunks accept at
   the root within a few frontier iterations (their whole subtree passes
   the group MAC), so ring steps are cheap except for spatial neighbors —
   the locally-essential-tree property falls out of the MAC itself, with
   no explicitly materialized halo lists.

Overflow policy: exchange-bucket overflow poisons every row with NaN
(never silent truncation), as in the LET grid tiers. Frontier/near-list
overflow poisons the affected rows too, and ``let_bvh`` then re-runs the
whole program with raised capacities, as ``bvh_forces`` does for its
overflowed groups: at 2^20 bodies per chip the uniform-input defaults
overflow.

Reference parity: the distributed analog of ``bvh_{seq,omp,parlay}_n_body``
(methods.cpp:377-423) — the work-stealing shared-memory loop becomes
shard_map + ppermute over the device mesh.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..ops.bvh import build_bvh, bvh_accel_sorted, caps_fit, raise_caps
from ..ops.keys import MAX_BITS
from .let_tree import _exchange
from .mesh import BODY_AXIS, make_mesh, pad_to_multiple


@functools.partial(
    jax.jit,
    static_argnames=("dim", "L", "nshard", "cc", "H", "key_bits", "theta",
                     "leaf_size", "group_size", "batch", "frontier_width",
                     "near_cap", "multipole", "far_impl", "softening", "G",
                     "axis_name"))
def _let_bvh_local(pos_l, mass_l, idx_l, *, dim, L, nshard, cc, H,
                   key_bits, theta, leaf_size, group_size, batch,
                   frontier_width, near_cap, multipole, far_impl,
                   softening, G, axis_name):
    """Per-chip LET BVH (runs under shard_map).

    Returns (forces_loc [PH, D], idx_loc [PH], valid [PH], need [2]):
    ``need`` is the largest frontier and near-list count any walk on any
    chip reached, for the host's capacity escalation.
    """
    dtype = pos_l.dtype
    (pos_s, mass_s, idx_s, _key_s, m_loc, _lo, _hi,
     of_ex) = _exchange(pos_l, mass_l, idx_l, dim=dim, L=L, nshard=nshard,
                        cc=cc, H=H, axis_name=axis_name)
    ph = pos_s.shape[0]
    # Invalid rows (idx < 0, zero mass) sit at the origin after the
    # exchange; left there they would pollute leaf AABBs near the domain
    # corner. Co-locate them with the last valid body: they sort next to
    # it, keep every AABB tight, and contribute nothing (zero mass; the
    # coincident-pair guard zeroes the d²≈0 interaction).
    last = pos_s[jnp.clip(m_loc - 1, 0, ph - 1)]
    pos_b = jnp.where((idx_s >= 0)[:, None], pos_s, last[None, :])

    tree = build_bvh(pos_b, mass_s, key_bits, quad=(multipole == "quad"),
                     varying_axis=axis_name)

    kwargs = dict(leaf_size=leaf_size, theta=theta, softening=softening,
                  group_size=group_size, batch=batch,
                  frontier_width=frontier_width, near_cap=near_cap,
                  multipole=multipole, far_impl=far_impl,
                  varying_axis=axis_name, return_stats=True)
    acc, maxw, ncnt, _ = bvh_accel_sorted(tree, **kwargs)
    need = jnp.stack([maxw, ncnt])

    if nshard > 1:
        perm = [(i, (i + 1) % nshard) for i in range(nshard)]

        def ring_step(carry, _):
            nt, bt, a, need = carry
            nt = jax.lax.ppermute(nt, axis_name, perm)
            bt = jax.lax.ppermute(bt, axis_name, perm)
            da, mw, nc, _ = bvh_accel_sorted(tree, source=(nt, bt), **kwargs)
            return (nt, bt, a + da,
                    jnp.maximum(need, jnp.stack([mw, nc]))), None

        (_, _, acc, need), _ = jax.lax.scan(
            ring_step, (tree.node_table, tree.body_table, acc, need), None,
            length=nshard - 1)

    idx_out = idx_s[tree.order]
    mass_out = mass_s[tree.order]
    valid = idx_out >= 0
    # A sender-side bucket overflow drops bodies destined for other
    # chips, so every chip's rows are suspect — all chips poison.
    overflow = jax.lax.pmax(of_ex.astype(jnp.int32), axis_name) > 0
    g = jnp.asarray(G, dtype)
    forces = (g * mass_out)[:, None] * acc
    forces = jnp.where(valid[:, None], forces, 0.0)
    forces = jnp.where(overflow, jnp.asarray(jnp.nan, dtype), forces)
    return forces, idx_out, valid, jax.lax.pmax(need, axis_name)


def let_bvh(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    axis_name: str = BODY_AXIS,
    theta: Optional[float] = None,
    leaf_size: int = 16,
    group_size: Optional[int] = None,
    batch: int = 128,
    frontier_width: Optional[int] = None,
    near_cap: Optional[int] = None,
    bucket_headroom: Optional[float] = None,
    multipole: str = "quad",
    far_impl: str = "point",
    max_escalations: int = 3,
) -> jax.Array:
    """BVH forces [N, D] with body-sharded LET distribution.

    Per-chip body AND tree memory is O(headroom·N/P); nothing is
    replicated. Knob semantics follow :func:`~nbody_jax.ops.bvh.bvh_forces`.
    Frontier/near-list overflow re-runs the whole per-chip program with
    raised capacities, up to ``max_escalations`` times (each a recompile;
    the per-chip program is jitted whole, so only the host sees its
    stats); rows still overflowed after that, and every row after an
    exchange-bucket overflow, are NaN (module docstring).
    """
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    nshard = mesh.shape[axis_name]
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    if group_size is None:
        # Same default as bvh_forces.
        group_size = 1024
    # Exchange granularity: >=64 owner cells per chip for load balance,
    # with the level-L cell count divisible by the shard count so chip
    # chunks tile the grid exactly.
    L = 1
    while (1 << (dim * L)) < 64 * nshard \
            or (1 << (dim * L)) % nshard != 0:
        L += 1
    cc = (1 << (dim * L)) // nshard
    n_pad = pad_to_multiple(n, nshard * 8)
    if bucket_headroom is None:
        # Exact data probe (memoized device sync; see let_tree).
        from .let_tree import exchange_bucket_peak_cached
        H = pad_to_multiple(max(8, exchange_bucket_peak_cached(
            positions, L, nshard, n_pad // nshard)), 8)
    else:
        H = pad_to_multiple(
            max(8, math.ceil(bucket_headroom * n / nshard ** 2)), 8)
    ph = nshard * H
    key_bits = dim * MAX_BITS[dim]
    group_size = min(group_size, ph)
    if frontier_width is None:
        frontier_width = min(1024 if dim == 2 else 8192, 2 * ph)
    if near_cap is None:
        near_cap = min(1024 if dim == 2 else 8192, 2 * ph)

    pad = n_pad - n
    if pad:
        # Padding bodies quantize into the far corner cell — harmless
        # (zero mass) but they must not be shipped: marked idx=-1, the
        # exchange buckets them out (same convention as let_tree).
        positions = jnp.concatenate(
            [positions, jnp.full((pad, dim), 2.0e9, positions.dtype)])
        masses = jnp.concatenate([masses, jnp.zeros((pad,), masses.dtype)])
    idx = jnp.concatenate([jnp.arange(n, dtype=jnp.int32),
                           jnp.full((pad,), -1, jnp.int32)])

    positions = jax.device_put(
        positions, NamedSharding(mesh, P(axis_name, None)))
    masses = jax.device_put(masses, NamedSharding(mesh, P(axis_name)))
    idx = jax.device_put(idx, NamedSharding(mesh, P(axis_name)))

    def run(w, nl):
        fn = functools.partial(
            _let_bvh_local, dim=dim, L=L, nshard=nshard, cc=cc, H=H,
            key_bits=key_bits, theta=float(theta), leaf_size=leaf_size,
            group_size=group_size, batch=batch, frontier_width=w,
            near_cap=nl, multipole=multipole, far_impl=far_impl,
            softening=float(config.softening), G=float(config.G),
            axis_name=axis_name)
        sharded = jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(axis_name, None), P(axis_name), P(axis_name)),
            out_specs=(P(axis_name, None), P(axis_name), P(axis_name), P()))
        return jax.jit(sharded)(positions, masses, idx)

    w, nl = frontier_width, near_cap
    forces, idx_out, valid, need = run(w, nl)
    for _ in range(max_escalations):
        need_w, need_nl = (int(v) for v in np.asarray(need))
        if caps_fit(need_w, need_nl, w, nl, leaf_size):
            break
        raised = raise_caps(need_w, need_nl, w, nl, leaf_size, 2 * ph)
        if raised == (w, nl):  # already at the 2·PH bound
            break
        w, nl = raised
        forces, idx_out, valid, need = run(w, nl)

    # Convenience materialization back to input order (tests / small N;
    # production callers keep the sharded (forces, idx) pair).
    out = jnp.zeros((n, dim), forces.dtype)
    out = out.at[jnp.where(valid, idx_out, n)].add(
        forces * valid[:, None], mode="drop")
    return out
