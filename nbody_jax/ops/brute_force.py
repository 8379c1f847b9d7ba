"""Brute-force O(N²) gravitational forces in pure jax.numpy.

Re-expresses the reference's five brute-force variants (``methods.h:30-43``):
the sequential i<j symmetric loop (``methods.cpp:7-42``), the two OpenMP
shapes (``methods.cpp:44-136``) and the two ParlayLib shapes
(``methods.cpp:139-224``) collapse into two array programs:

* :func:`brute_force_direct` — the full N×N formulation (the reference's
  "memory-efficient" row-wise shape, ``methods.cpp:98-136``, which is the
  natural array program: no write conflicts, every row independent).
* :func:`brute_force_blocked` — the same math evaluated block-of-rows at a
  time via ``lax.map``, bounding memory at O(B·N); this is the interpretable
  oracle path for large N without the Pallas kernel.

Force convention (SURVEY.md §8.1): the reference's brute force and its tree
methods disagree on sign. This engine uses the physically correct
**attractive** convention everywhere:

    F_i = G · m_i · Σ_{j≠i}  m_j · (x_j − x_i) / (‖x_j − x_i‖² + ε²)^{3/2}

with Plummer softening ε (the reference defines ``SOFTENING`` but never uses
it, ``utils.h:24``; instead it skips pairs with dist² < 1e-10,
``methods.cpp:24`` — we keep that guard as well so ε=0 reproduces reference
semantics exactly).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import DEFAULT_GRAVITY, GravityConfig

# Reference pair-skip guard: dist² < 1e-10 → no interaction (methods.cpp:24).
_DIST2_GUARD = 1e-10


def _accel_rows(
    targets: jax.Array,  # [T, D]
    sources: jax.Array,  # [S, D]
    source_masses: jax.Array,  # [S]
    softening,
    dtype=None,
) -> jax.Array:
    """Acceleration (force / m_target) on each target from all sources: [T, D].

    Works dimension-by-dimension so only (T, S) tiles are ever materialized —
    never a (T, S, D) tensor. This is the same dataflow as the Pallas
    kernel's tiles, so jnp and Pallas paths agree to fp rounding.
    """
    ndim = targets.shape[-1]
    diffs = []
    d2 = None
    for d in range(ndim):
        diff = sources[:, d][None, :] - targets[:, d][:, None]  # [T, S]
        diffs.append(diff)
        d2 = diff * diff if d2 is None else d2 + diff * diff
    soft2 = jnp.asarray(softening, d2.dtype) ** 2
    inv_r = jax.lax.rsqrt(d2 + soft2)
    w = source_masses[None, :] * (inv_r * inv_r * inv_r)  # m_j / r³
    w = jnp.where(d2 < _DIST2_GUARD, jnp.zeros_like(w), w)
    return jnp.stack([jnp.sum(w * diffs[d], axis=1) for d in range(ndim)],
                     axis=-1)


def _accel_rows_sym(
    targets: jax.Array,  # [T, D]
    target_masses: jax.Array,  # [T]
    sources: jax.Array,  # [S, D]
    source_masses: jax.Array,  # [S]
    softening,
):
    """Newton's-3rd-law rectangular tile: both sides from one pair sweep.

    Returns (acc_t [T, D], part_s [S, D]) where ``acc_t`` is the usual
    per-target acceleration Σ_s m_s·Δ/r³ (Δ = x_s − x_t) and ``part_s`` is
    the sources' acceleration contribution from these targets,
    −Σ_t m_t·Δ/r³ — the cross-chip analog of the reference's symmetric
    i<j update (``methods.cpp:7-42``). The distance/weight computation is
    shared, so one tile serves both blocks (the point of the symmetric
    ring: each unordered block pair is computed once).

    Intended for DISJOINT blocks: no self-pair handling beyond the usual
    ``d² < guard`` coincident-pair zeroing.
    """
    ndim = targets.shape[-1]
    diffs = []
    d2 = None
    for d in range(ndim):
        diff = sources[:, d][None, :] - targets[:, d][:, None]  # [T, S]
        diffs.append(diff)
        d2 = diff * diff if d2 is None else d2 + diff * diff
    soft2 = jnp.asarray(softening, d2.dtype) ** 2
    inv_r = jax.lax.rsqrt(d2 + soft2)
    u3 = inv_r * inv_r * inv_r
    u3 = jnp.where(d2 < _DIST2_GUARD, jnp.zeros_like(u3), u3)
    w_t = source_masses[None, :] * u3  # [T, S]
    w_s = target_masses[:, None] * u3
    acc_t = jnp.stack([jnp.sum(w_t * diffs[d], axis=1)
                       for d in range(ndim)], axis=-1)
    part_s = jnp.stack([-jnp.sum(w_s * diffs[d], axis=0)
                        for d in range(ndim)], axis=-1)
    return acc_t, part_s


_PAD_POS = 2.0e9  # Padding bodies live far away with zero mass.


def _target_blocks(targets, block, *extra):
    """Pad T target rows to a multiple of ``block``; return [nb, block, ...]
    views of ``targets`` (padded far away) and of each ``extra`` per-row
    array (padded with zeros, i.e. zero mass)."""
    t, d = targets.shape
    nb = -(-t // block)
    pad = nb * block - t
    out = [jnp.concatenate(
        [targets, jnp.full((pad, d), _PAD_POS, targets.dtype)]
    ).reshape(nb, block, d)]
    for x in extra:
        out.append(jnp.concatenate(
            [x, jnp.zeros((pad,), x.dtype)]).reshape(nb, block))
    return out


def accel_rows_blocked(targets, sources, source_masses, softening,
                       block: int = 1024):
    """:func:`_accel_rows` over ``block``-row target tiles via ``lax.map``:
    O(block · S) memory instead of O(T · S)."""
    t, d = targets.shape
    (blocks,) = _target_blocks(targets, block)
    acc = jax.lax.map(
        lambda b: _accel_rows(b, sources, source_masses, softening), blocks)
    return acc.reshape(-1, d)[:t]


def accel_rows_sym_blocked(targets, target_masses, sources, source_masses,
                           softening, block: int = 1024):
    """:func:`_accel_rows_sym` over ``block``-row target tiles via
    ``lax.scan``, carrying the sources' Newton-3 share: O(block · S) memory.
    Padding targets have zero mass, so they add nothing to ``part_s``."""
    t, d = targets.shape
    blocks, mblocks = _target_blocks(targets, block, target_masses)

    def step(part, blk):
        acc_t, part_s = _accel_rows_sym(blk[0], blk[1], sources,
                                        source_masses, softening)
        return part + part_s, acc_t

    part, acc = jax.lax.scan(step, jnp.zeros_like(sources), (blocks, mblocks))
    return acc.reshape(-1, d)[:t], part


def brute_force_accelerations(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
) -> jax.Array:
    """Per-body acceleration a_i = F_i / m_i, full N×N. [N, D]."""
    acc = _accel_rows(positions, positions, masses, config.softening)
    return jnp.asarray(config.G, acc.dtype) * acc


def brute_force_direct(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
) -> jax.Array:
    """Per-body forces, full N×N materialization. [N, D].

    Parity target: ``brute_force_omp_n_body_2`` (methods.cpp:98-136) with the
    attractive sign convention.
    """
    acc = brute_force_accelerations(positions, masses, config)
    return masses[:, None] * acc


def brute_force_blocked(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    block_size: int = 1024,
) -> jax.Array:
    """Per-body forces with O(block_size · N) memory via ``lax.map``.

    The analog of the reference's grain-size-controlled parallel row loop
    (``methods.cpp:190-224``): each block of target rows scans all sources.
    N is padded to a multiple of ``block_size`` with zero-mass bodies at a
    far-away coordinate (zero mass ⇒ no force contribution either way).
    """
    acc = accel_rows_blocked(positions, positions, masses, config.softening,
                             block=block_size)
    return masses[:, None] * (jnp.asarray(config.G, positions.dtype) * acc)


@functools.partial(jax.jit, static_argnames=("block_size",))
def brute_force_blocked_jit(positions, masses, G, softening, block_size=1024):
    """Jitted entry with scalar G/softening as traced args (no recompiles)."""
    acc = accel_rows_blocked(positions, positions, masses, softening,
                             block=block_size)
    return masses[:, None] * (jnp.asarray(G, positions.dtype) * acc)


def potential_energy(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
) -> jax.Array:
    """Total softened potential energy U = −G Σ_{i<j} m_i m_j / r_ij (scalar).

    Not present in the reference (it has no energy diagnostics); used by the
    conservation tests (SURVEY.md §4 implication list).
    """
    diff = positions[None, :, :] - positions[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    soft2 = jnp.asarray(config.softening, d2.dtype) ** 2
    inv_r = jax.lax.rsqrt(d2 + soft2)
    n = positions.shape[0]
    mask = ~jnp.eye(n, dtype=bool)
    pair = jnp.where(mask, masses[:, None] * masses[None, :] * inv_r, 0.0)
    return -0.5 * jnp.asarray(config.G, d2.dtype) * jnp.sum(pair)


@functools.partial(jax.jit, static_argnames=("G", "softening", "block_size"))
def _pe_blocked_impl(positions, masses, *, G, softening, block_size):
    n, dim = positions.shape
    n_pad = -(-n // block_size) * block_size
    pos_p = jnp.pad(positions, ((0, n_pad - n), (0, 0)))
    m_p = jnp.pad(masses, (0, n_pad - n))
    soft2 = jnp.asarray(softening, positions.dtype) ** 2
    idx = jnp.arange(n_pad)

    def row_block(i0):
        tp = jax.lax.dynamic_slice_in_dim(pos_p, i0, block_size)
        tm = jax.lax.dynamic_slice_in_dim(m_p, i0, block_size)
        d2 = None
        for d in range(dim):
            diff = pos_p[None, :, d] - tp[:, None, d]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        inv_r = jax.lax.rsqrt(d2 + soft2)
        ti = i0 + jnp.arange(block_size)
        # Skip self-pairs and padding rows *by index* (zero-mass padding
        # bodies all sit at the origin: with softening == 0 their mutual
        # rsqrt(0) = inf would turn 0·inf into NaN). A d²-based skip here
        # would also drop coincident *distinct* real pairs, diverging from
        # the dense potential_energy it tiles.
        skip = ((ti[:, None] == idx[None, :]) | (ti[:, None] >= n)
                | (idx[None, :] >= n))
        pair = jnp.where(skip, 0.0, tm[:, None] * m_p[None, :] * inv_r)
        return jnp.sum(pair)

    starts = jnp.arange(n_pad // block_size) * block_size
    total = jnp.sum(jax.lax.map(row_block, starts))
    return -0.5 * jnp.asarray(G, positions.dtype) * total


def potential_energy_blocked(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    block_size: int = 1024,
) -> jax.Array:
    """:func:`potential_energy` in [B, N] row tiles — scales to N ≥ 1e6
    (the dense version materializes the full (N, N) distance matrix)."""
    return _pe_blocked_impl(positions, masses, G=float(config.G),
                            softening=float(config.softening),
                            block_size=block_size)


def kinetic_energy(velocities: jax.Array, masses: jax.Array) -> jax.Array:
    return 0.5 * jnp.sum(masses * jnp.sum(velocities * velocities, axis=-1))
