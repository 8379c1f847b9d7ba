"""All-pairs gravity as a Pallas kernel for NVIDIA Hopper, through Triton.

The design is the reference's CUDA kernel (``main_cuda.cu:24-57``, GPU Gems 3
ch. 31): each program owns one block of target bodies and keeps their
accelerations in registers while every source body streams past in tiles.
Here a program is one power-of-two block of ``block_t`` targets, and a
``lax.fori_loop`` inside the kernel walks the sources ``block_s`` at a time.
Triton pipelines the source loads over ``num_stages`` buffers.

Layout. Bodies are packed as rows ``[x, y, z|0, m]`` of a ``(4, N)`` array:
Triton wants power-of-two widths, so a ``(T, 3)`` block will not lower, and
row-major ``(4, N)`` makes every row load contiguous. Each pair is evaluated
from per-dimension ``(block_t, block_s)`` tiles of differences, never from a
``|x|² + |y|² − 2x·y`` product: coordinates at the reference's ~1e7 scale
would lose the near-pair forces to cancellation.

Accumulation. The inner loop carries one ``(block_t, block_s)`` partial sum
per dimension, so it holds no cross-thread reduction. It runs over a chunk
of ``chunk`` source tiles from zero; each chunk's partial is then reduced
across sources and added into a per-target sum with Kahan compensation.
A plain running sum over all N sources is not accurate enough: one close
pair puts a term ~1e2-1e3× the typical force into a lane, and the far
field's many small terms added after it are absorbed by rounding — at
N = 2^20 in 2D that was 1.3e-3 normalized error with 32-wide tiles
(H100, see PERF.md), falling as 1/block_s. Fresh chunks confine the
absorption to one chunk's terms, and the compensated outer sum loses
nothing more.

Math (attractive convention, Plummer softening — see ops/brute_force.py):

    a_i = G · Σ_j  m_j (x_j − x_i) / (|x_j − x_i|² + ε²)^{3/2}

Pair-guard policy: the reference skips pairs with dist² < 1e-10
(``methods.cpp:24``). With softening > 0 the guard is unnecessary for
self-pairs: w = m·(d²+ε²)^{-3/2} is finite and is multiplied by the exact
zero difference x_i − x_i, so the contribution is exactly 0.0. Nearly
coincident *distinct* bodies (0 < d < 1e-5) then feel the softened force
instead of being skipped, which is better physics and irrelevant for the
reference's distributions. The guard is therefore on by default only when
softening == 0 (where rsqrt(0) = inf would give inf·0 = NaN), and
``guard=True`` forces it for strict reference semantics.

``interpret=True`` runs the same kernel through the Pallas interpreter; it
is how the CPU tests reach it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..config import DEFAULT_GRAVITY, GravityConfig
from .brute_force import _DIST2_GUARD

_PAD_POS = 2.0e9  # Padding bodies live far away with zero mass.

# Tile defaults: see PERF.md for the measurement that chose them.
BLOCK_T = 64
BLOCK_S = 32
NUM_WARPS = 4
NUM_STAGES = 3
CHUNK = 32  # source tiles per compensated step (module docstring)


def kernel_available() -> bool:
    """True where the compiled kernel runs: JAX's default backend is a GPU.

    The one switch between this kernel and the jnp row path, read by the
    bench registry, ``Simulation`` and the ring. Elsewhere the kernel runs
    only when a caller passes ``interpret=True``.
    """
    return jax.default_backend() == "gpu"


def _kernel(tgt_ref, src_ref, out_ref, *, dim, soft2, guard, block_s,
            chunk, num_tiles):
    """One program: accelerations (un-scaled by G) on a block of targets.

    Refs:
      tgt_ref: (4, block_t) target rows [x, y, z|0, unused].
      src_ref: (4, s_pad) all sources, rows [x, y, z|0, m]; zero-mass padding.
      out_ref: (4, block_t) Σ_s m_s·(x_s − x_t)/r³ per dimension; rows ≥ dim
               are written as zeros.
    """
    tgt = [tgt_ref[d, :] for d in range(dim)]  # (block_t,) each
    block_t = tgt[0].shape[0]

    def tile(j, part):
        cols = pl.ds(pl.multiple_of(j * block_s, block_s), block_s)
        diffs = [src_ref[d, cols][None, :] - tgt[d][:, None]
                 for d in range(dim)]  # (block_t, block_s) each
        d2 = diffs[0] * diffs[0] + jnp.float32(soft2)
        for d in range(1, dim):
            d2 = diffs[d] * diffs[d] + d2
        u = jax.lax.rsqrt(d2)
        w = src_ref[3, cols][None, :] * (u * u * u)
        if guard:
            # Reference pair-skip guard methods.cpp:24 — required when ε=0
            # (rsqrt(0)=inf → inf·0=NaN below); see module docstring.
            raw = d2 - jnp.float32(soft2) if soft2 else d2
            w = jnp.where(raw < _DIST2_GUARD, 0.0, w)
        return tuple(p + w * diff for p, diff in zip(part, diffs))

    def chunk_body(c, carry):
        acc, comp = carry
        part = jax.lax.fori_loop(
            c * chunk, jnp.minimum((c + 1) * chunk, num_tiles), tile,
            tuple(jnp.zeros((block_t, block_s), jnp.float32)
                  for _ in range(dim)))
        new_acc, new_comp = [], []
        for a, e, p in zip(acc, comp, part):  # Kahan: a + (Σp − e)
            y = jnp.sum(p, axis=1) - e
            t = a + y
            new_comp.append((t - a) - y)
            new_acc.append(t)
        return tuple(new_acc), tuple(new_comp)

    zeros = tuple(jnp.zeros((block_t,), jnp.float32) for _ in range(dim))
    acc, _ = jax.lax.fori_loop(0, -(-num_tiles // chunk), chunk_body,
                               (zeros, zeros))
    for d in range(4):
        out_ref[d, :] = acc[d] if d < dim else jnp.zeros_like(acc[0])


def _pow2_at_least(n: int, floor: int = 16) -> int:
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


def tile_shape(t: int, s: int, block_t: int = BLOCK_T,
               block_s: int = BLOCK_S) -> tuple[int, int, int, int]:
    """(block_t, block_s, t_pad, s_pad) for T targets and S sources.

    Blocks stay powers of two and are clamped so a small problem does not
    pad to a full tile; padded counts are multiples of their block.
    """
    block_t = min(block_t, _pow2_at_least(t))
    block_s = min(block_s, _pow2_at_least(s))
    return (block_t, block_s, -(-t // block_t) * block_t,
            -(-s // block_s) * block_s)


def _pack_rows(pos, mass, n_pad):
    """(4, n_pad) rows [x, y, z|0, m]; padding far away with zero mass."""
    n, dim = pos.shape
    rows = jnp.zeros((4, n_pad), jnp.float32)
    rows = rows.at[:dim, :n].set(pos.T.astype(jnp.float32))
    rows = rows.at[:dim, n:].set(_PAD_POS)
    if mass is not None:
        rows = rows.at[3, :n].set(mass.astype(jnp.float32))
    return rows


@functools.partial(
    jax.jit,
    static_argnames=("softening", "guard", "block_t", "block_s", "num_warps",
                     "num_stages", "interpret"))
def _accel_impl(targets, src_pos, src_mass, *, softening, guard, block_t,
                block_s, num_warps, num_stages, interpret):
    t, dim = targets.shape
    s = src_pos.shape[0]
    block_t, block_s, t_pad, s_pad = tile_shape(t, s, block_t, block_s)
    tgt = _pack_rows(targets, None, t_pad)
    src = _pack_rows(src_pos, src_mass, s_pad)
    kernel = functools.partial(
        _kernel, dim=dim, soft2=float(softening) ** 2, guard=guard,
        block_s=block_s, chunk=CHUNK, num_tiles=s_pad // block_s)
    out = pl.pallas_call(
        kernel,
        grid=(t_pad // block_t,),
        in_specs=[pl.BlockSpec((4, block_t), lambda i: (0, i)),
                  pl.BlockSpec((4, s_pad), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((4, block_t), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((4, t_pad), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps, num_stages=num_stages),
        cost_estimate=pl.CostEstimate(
            flops=(3 * dim + 5 + 2 * dim) * t_pad * s_pad,
            bytes_accessed=16 * (2 * t_pad + s_pad * (t_pad // block_t)),
            transcendentals=t_pad * s_pad),
        interpret=interpret,
        name="nbody_brute",
    )(tgt, src)
    return out[:dim, :t].T


def pairwise_accel_pallas(
    targets: jax.Array,
    src_pos: jax.Array,
    src_mass: jax.Array,
    softening: float = 0.0,
    *,
    guard: bool | None = None,
    block_t: int = BLOCK_T,
    block_s: int = BLOCK_S,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    interpret: bool = False,
) -> jax.Array:
    """Un-G-scaled accelerations on ``targets`` from all sources, [T, D].

    Rectangular: targets and sources are separate arrays, so the same call
    serves one card (targets = sources = all bodies) and the ring's
    per-card engine (parallel/ring.py: resident shard × rotating shard).
    """
    if guard is None:
        guard = float(softening) == 0.0
    return _accel_impl(targets, src_pos, src_mass,
                       softening=float(softening), guard=bool(guard),
                       block_t=block_t, block_s=block_s, num_warps=num_warps,
                       num_stages=num_stages, interpret=interpret)


def pallas_local_accel(targets, src_pos, src_mass, softening):
    """LocalAccelFn-shaped adapter for parallel/ring.py (GPU engine)."""
    return pairwise_accel_pallas(targets, src_pos, src_mass,
                                 softening=float(softening))


def brute_force_pallas(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    **tile,
) -> jax.Array:
    """Per-body forces [N, D] via the Pallas kernel (fp32).

    ``tile`` passes ``guard``, block sizes, ``num_warps``, ``num_stages``
    and ``interpret`` through to :func:`pairwise_accel_pallas`.
    """
    acc = pairwise_accel_pallas(positions, positions, masses,
                                softening=float(config.softening), **tile)
    g = jnp.float32(config.G)
    return (g * masses.astype(jnp.float32))[:, None] * acc
