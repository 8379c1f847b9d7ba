"""Multi-device ring brute force: shard targets, rotate sources.

The cross-chip generalization of the CUDA shared-memory tile loop
(``main_cuda.cu:31-53``) and of the reference's thread-local-accumulation
pattern (``methods.cpp:54-92`` — SURVEY.md §2.3): each device owns a shard
of target bodies and a resident force accumulator; source shards rotate
around a 1-D ring via ``lax.ppermute``, one rotation per step, so after P
steps every device has accumulated forces from every source shard. No
``psum`` is needed — targets are disjoint, so accumulation is purely local
(the "row-wise no-reduction" shape, ``methods.cpp:98-136``, lifted across
devices).

**Symmetric (Newton's-3rd-law) mode** computes each unordered *shard pair*
once, the cross-device lift of the reference's symmetric i<j update
(``methods.cpp:7-42``): ⌈(P−1)/2⌉ forward rotations evaluate pair (b, b−s)
on device b with a two-output tile (local target rows + the partner's
Newton-3 share), and a second rotation pass carries the accumulated
partials back to their owners. For even P the s = P/2 step would
double-count, so only devices b < P/2 evaluate it. Arithmetic halves vs the
one-sided ring (P tiles → P/2 + self); bytes moved stay ≈ equal (P one-way
shard hops → 2·(P/2) hops of shards/partials). Its engine is the blocked
jnp tile; the GPU kernel (ops/pallas_brute.py) is one-sided, so on a GPU
the ring defaults to the one-sided form with that kernel.

Memory per device is O(N/P) plus the engine's bounded tile; traffic per
step is one shard (N/P bodies), overlappable with the O((N/P)²) local tile
compute.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..ops.brute_force import accel_rows_blocked, accel_rows_sym_blocked
from .mesh import BODY_AXIS, pad_to_multiple

# local_accel(targets_pos [T,D], src_pos [S,D], src_mass [S], softening)
#   -> un-G-scaled acceleration contributions [T, D]
LocalAccelFn = Callable[[jax.Array, jax.Array, jax.Array, float], jax.Array]

# sym_accel(t_pos [T,D], t_mass [T], src_pos [S,D], src_mass [S], softening)
#   -> (acc_t [T,D], part_s [S,D]): target rows + the sources' Newton-3
#   share from the same pair sweep (see brute_force._accel_rows_sym).
SymAccelFn = Callable[
    [jax.Array, jax.Array, jax.Array, jax.Array, float],
    Tuple[jax.Array, jax.Array]]

_PAD_POS = 2.0e9


def _ring_local(pos_l, mass_l, *, axis_name, num_shards, softening,
                local_accel: LocalAccelFn):
    """Per-shard body: scan over ring rotations, accumulate local forces."""

    def step(carry, _):
        src_pos, src_mass, acc = carry
        acc = acc + local_accel(pos_l, src_pos, src_mass, softening)
        perm = [(i, (i + 1) % num_shards) for i in range(num_shards)]
        src_pos = jax.lax.ppermute(src_pos, axis_name, perm)
        src_mass = jax.lax.ppermute(src_mass, axis_name, perm)
        return (src_pos, src_mass, acc), None

    acc0 = jnp.zeros_like(pos_l)
    (_, _, acc), _ = jax.lax.scan(
        step, (pos_l, mass_l, acc0), None, length=num_shards)
    return acc


def _ring_local_symmetric(pos_l, mass_l, *, axis_name, num_shards,
                          softening, sym_accel: SymAccelFn,
                          local_accel: LocalAccelFn):
    """Newton-3 ring body: each unordered shard pair computed once.

    Forward pass, step s = 1..⌈(P−1)/2⌉: the source shard rotates one hop
    (chip b then holds block b−s); one symmetric tile yields this chip's
    target rows AND the resident block's Newton-3 share, which is stacked
    for the return pass. Even P: the s = P/2 step pairs (b, b−P/2) twice
    around the ring, so only chips b < P/2 evaluate it (the masked-out
    chips' targets are covered by the partner's returned partial).

    Return pass: partials are added in DESCENDING s order with one reverse
    hop after each add, so p_s has traveled exactly s hops when the scan
    ends — chip c receives Σ_s p_s(c+s), its missing pair halves.
    """
    P_ = num_shards
    acc = local_accel(pos_l, pos_l, mass_l, softening)  # self block
    s_total = P_ // 2 if P_ % 2 == 0 else (P_ - 1) // 2
    if s_total == 0:
        return acc
    perm_fwd = [(i, (i + 1) % P_) for i in range(P_)]
    perm_ret = [(i, (i - 1) % P_) for i in range(P_)]
    me = jax.lax.axis_index(axis_name).astype(jnp.int32)

    def fwd(carry, s):
        src_pos, src_mass, acc = carry
        src_pos = jax.lax.ppermute(src_pos, axis_name, perm_fwd)
        src_mass = jax.lax.ppermute(src_mass, axis_name, perm_fwd)
        acc_t, part = sym_accel(pos_l, mass_l, src_pos, src_mass,
                                softening)
        if P_ % 2 == 0:
            keep = jnp.where(s == P_ // 2, me < P_ // 2, True)
            acc_t = jnp.where(keep, acc_t, 0.0)
            part = jnp.where(keep, part, 0.0)
        return (src_pos, src_mass, acc + acc_t), part

    (_, _, acc), parts = jax.lax.scan(
        fwd, (pos_l, mass_l, acc),
        jnp.arange(1, s_total + 1, dtype=jnp.int32))

    def ret(ret_acc, part):
        ret_acc = ret_acc + part
        return jax.lax.ppermute(ret_acc, axis_name, perm_ret), None

    ret_acc, _ = jax.lax.scan(ret, jnp.zeros_like(pos_l), parts,
                              reverse=True)
    return acc + ret_acc


def ring_engines(local_accel: Optional[LocalAccelFn] = None,
                 sym_accel: Optional[SymAccelFn] = None,
                 symmetric: Optional[bool] = None):
    """Resolve ``(symmetric, local_accel, sym_accel)`` for the ring.

    Defaults: the Pallas kernel (one-sided ring) where it runs, a GPU;
    the blocked jnp tiles (Newton-3 ring) elsewhere. Both stay O(tile) in
    memory at any shard size.
    """
    from ..ops.pallas_brute import kernel_available, pallas_local_accel
    on_gpu = kernel_available()
    if symmetric is None:
        symmetric = sym_accel is not None or (local_accel is None
                                              and not on_gpu)
    if local_accel is None:
        local_accel = pallas_local_accel if on_gpu else accel_rows_blocked
    if symmetric and sym_accel is None:
        sym_accel = accel_rows_sym_blocked
    return symmetric, local_accel, sym_accel


def ring_brute_force(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    axis_name: str = BODY_AXIS,
    local_accel: Optional[LocalAccelFn] = None,
    symmetric: Optional[bool] = None,
    sym_accel: Optional[SymAccelFn] = None,
) -> jax.Array:
    """Per-body forces [N, D] computed over every device in ``mesh``.

    ``local_accel`` is the pluggable per-device tile engine; by default the
    Pallas kernel on a GPU (ops/pallas_brute.py) and the blocked jnp row
    path elsewhere, both O(tile) in memory at any shard size.

    ``symmetric`` computes each unordered shard pair once with a two-output
    Newton-3 tile — half the arithmetic of the one-sided ring at equal bytes
    moved (module docstring). Default: on where the engine is the jnp tile
    and no one-sided ``local_accel`` is supplied without a matching
    ``sym_accel``; off on a GPU, whose kernel is one-sided.
    """
    if mesh is None:
        from .mesh import make_mesh
        mesh = make_mesh(axis_name=axis_name)
    symmetric, local_accel, sym_accel = ring_engines(
        local_accel, sym_accel, symmetric)
    num_shards = mesh.shape[axis_name]
    n, d = positions.shape

    n_pad = pad_to_multiple(n, num_shards)
    if n_pad != n:
        pad = n_pad - n
        positions = jnp.concatenate(
            [positions, jnp.full((pad, d), _PAD_POS, positions.dtype)])
        masses = jnp.concatenate([masses, jnp.zeros((pad,), masses.dtype)])

    shard = NamedSharding(mesh, P(axis_name, None))

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name)),
        out_specs=P(axis_name, None),
        # pallas_call outputs don't carry varying-mesh-axis metadata, so the
        # vma check must be off for Pallas local engines.
        check_vma=False,
    )
    def sharded(pos_l, mass_l):
        if symmetric:
            acc = _ring_local_symmetric(
                pos_l, mass_l,
                axis_name=axis_name, num_shards=num_shards,
                softening=config.softening, sym_accel=sym_accel,
                local_accel=local_accel)
        else:
            acc = _ring_local(
                pos_l, mass_l,
                axis_name=axis_name, num_shards=num_shards,
                softening=config.softening, local_accel=local_accel)
        g = jnp.asarray(config.G, acc.dtype)
        return (g * mass_l)[:, None] * acc

    positions = jax.device_put(positions, shard)
    masses = jax.device_put(masses, NamedSharding(mesh, P(axis_name)))
    forces = jax.jit(sharded)(positions, masses)
    return forces[:n]
