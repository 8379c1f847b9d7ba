"""Multi-chip tree force evaluation: replicated build, sharded evaluation.

Spatial domain decomposition (SURVEY.md §2.4's "introduced
distributed layer"): the grid tree is built identically on every chip
(O(N log N) sort + segment sums — cheap), and the O(N·list) *evaluation* —
the dominant cost — is sharded by contiguous Morton leaf ranges, which are
compact spatial blocks. Per-chip partial forces are combined with a single
``psum``. This is the all-replicated-tree corner of the locally-essential-
tree design space: no halo exchange is needed because every chip already
holds the full (small) cell hierarchy; body data is replicated, bounding
this scheme at ~10M bodies per chip — the sharded-body LET exchange is the
planned follow-up.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..ops.grid_tree import (
    auto_leaf_level,
    build_grid_tree,
    check_grid_capacity,
    compute_capacity_cached,
    grid_tree_accel_sorted,
    theta_to_ring,
)
from .mesh import BODY_AXIS, make_mesh


def barnes_hut_sharded(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    axis_name: str = BODY_AXIS,
    theta: Optional[float] = None,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    leaf_batch: int = 512,
    multipole: str = "quad",
) -> jax.Array:
    """Barnes-Hut forces [N, D], leaf evaluation sharded over the mesh.

    ``multipole`` follows :func:`~nbody_jax.ops.grid_tree.barnes_hut_grid`
    (default quadrupole far field, "mono" for reference parity)."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    num_shards = mesh.shape[axis_name]
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    k = theta_to_ring(theta)
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim, k=k)
    # A shard must own at least one leaf: 2^(D·L) >= num_shards.
    while (1 << (dim * leaf_level)) < num_shards:
        leaf_level += 1
    if capacity is None:
        capacity = compute_capacity_cached(positions, leaf_level)
        check_grid_capacity(capacity, n, leaf_level, dim,
                            "barnes_hut_sharded")

    tree = build_grid_tree(positions, masses, leaf_level, capacity,
                           quad=(multipole == "quad"))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), tree),),
        out_specs=P(),
    )
    def eval_sharded(tree_rep):
        return grid_tree_accel_sorted(
            tree_rep, k=k, softening=float(config.softening),
            leaf_batch=leaf_batch, shard_axis=axis_name,
            num_shards=num_shards, multipole=multipole)

    acc_sorted = jax.jit(eval_sharded)(tree)
    acc = jnp.zeros_like(acc_sorted).at[tree.order].set(acc_sorted)
    g = jnp.asarray(config.G, positions.dtype)
    return (g * masses)[:, None] * acc


def fmm_sharded(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    axis_name: str = BODY_AXIS,
    order: int = 5,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    leaf_batch: int = 1024,
) -> jax.Array:
    """FMM forces [N, D]: P2M/M2L/L2P+P2P sharded over the mesh.

    The BASELINE.json "FMM p=8 full pipeline sharded" configuration: per-chip M2L cell rows + leaf chunks, all_gather'd level
    arrays, psum'd forces (see ops/fmm.py::fmm_accel_sorted).
    """
    from ..ops.fmm import fmm_accel_sorted

    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    num_shards = mesh.shape[axis_name]
    n, dim = positions.shape
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim)
    while (1 << (dim * leaf_level)) < num_shards:
        leaf_level += 1
    if capacity is None:
        capacity = compute_capacity_cached(positions, leaf_level)
        check_grid_capacity(capacity, n, leaf_level, dim, "fmm_sharded")

    tree = build_grid_tree(positions, masses, leaf_level, capacity)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), tree),),
        out_specs=P(),
    )
    def eval_sharded(tree_rep):
        return fmm_accel_sorted(
            tree_rep, order=order, softening=float(config.softening),
            leaf_batch=leaf_batch, shard_axis=axis_name,
            num_shards=num_shards)

    acc_sorted = jax.jit(eval_sharded)(tree)
    acc = jnp.zeros_like(acc_sorted).at[tree.order].set(acc_sorted)
    g = jnp.asarray(config.G, positions.dtype)
    return (g * masses)[:, None] * acc


def bvh_sharded(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    axis_name: str = BODY_AXIS,
    leaf_size: int = 16,
    theta: Optional[float] = None,
    group_size: Optional[int] = None,
    multipole: str = "quad",
) -> jax.Array:
    """BVH forces [N, D]: group walks sharded over the mesh (replicated
    radix tree, per-chip group slices, psum-combined partials)."""
    from ..ops.bvh import build_bvh, bvh_accel_sorted
    from ..ops.keys import MAX_BITS

    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    num_shards = mesh.shape[axis_name]
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    if group_size is None:
        # Same default as bvh_forces.
        group_size = 1024
    group_size = min(group_size, max(1, n))

    tree = build_bvh(positions, masses, dim * MAX_BITS[dim],
                     quad=(multipole == "quad"))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), tree),),
        out_specs=P(),
    )
    def eval_sharded(tree_rep):
        return bvh_accel_sorted(
            tree_rep, leaf_size=leaf_size, theta=float(theta),
            softening=float(config.softening), group_size=group_size,
            shard_axis=axis_name, num_shards=num_shards,
            multipole=multipole)

    acc_sorted = jax.jit(eval_sharded)(tree)
    acc = jnp.zeros_like(acc_sorted).at[tree.order].set(acc_sorted)
    g = jnp.asarray(config.G, positions.dtype)
    return (g * masses)[:, None] * acc
