"""Sparse (clustered-input) grid evaluation: chunked targets, windowed
near field — O(N) memory on ANY mass distribution.

The dense grid path (ops/grid_tree.py) batches whole leaf cells and pads
every leaf to the global max occupancy (``capacity``): near-field tensors
scale with capacity², so a Plummer-style density peak (one cell holding
~N bodies — capacity 63,752 measured at Plummer N=1e5 3D) degenerates it
into a ~40 TB near tensor, and ``check_grid_capacity`` refuses the input.
This module is the uniform grid's clustered tier — same tree, same
telescoping V-list far field, but:

* **Targets are fixed-size body chunks**, not capacity-padded cells: every
  cell's contiguous Morton run is split into ⌈occ/chunk⌉ chunks of ≤
  ``chunk_size`` bodies (``grid_tree.chunk_table``), so one dense cell
  simply contributes more chunks. All bodies of a chunk share one cell —
  hence one ancestor chain for the far field and one near ring.
* **Near-field sources are fixed-size windows over the ring runs** (the
  BVH pass-2 pattern, ops/bvh.py): each of the (2k+1)^D ring cells is a
  contiguous run, covered by ⌈occ/window⌉ windows of ``window`` bodies;
  a chunk evaluates its windows in cond-skipped sub-batches. Work scales
  with Σ_chunks (actual ring occupancy) — for a dense core that is the
  unavoidable O(core²) all-pairs, streamed through bounded [B, wl, w]
  tiles instead of one capacity²-shaped tensor.
* **Static shapes from an exact probe, not escalation**: the chunk count
  and the worst-case per-chunk window count are concrete per (positions,
  level) — one memoized device sync (:func:`sparse_grid_stats`, same
  id/weakref memo pattern as ``compute_capacity_cached``) sizes the
  program exactly, so there is no overflow path at all.
* **Leaf aggregates by chunk scatter-add** (``build_grid_tree(...,
  agg_num_chunks=)``): the build's own [ncells, capacity] window tensor is
  replaced by [num_chunks, chunk] partial sums — the build is O(N) too.

Parity: this tier answers the same force law as ``barnes_hut_grid``
(octree.cpp:97-162 role); ``barnes_hut_grid(layout="auto")`` dispatches
here instead of refusing when the capacity guard trips, so clustered
inputs (the reference initializer never produces them, but Plummer-style
astrophysical inputs do) are handled rather than redirected to the BVH.
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional

import jax
import jax.numpy as jnp

from ..config import DEFAULT_GRAVITY, GravityConfig
from .brute_force import _DIST2_GUARD
from .grid_tree import (GridTree, _neighbor_offsets, auto_leaf_level,
                        build_grid_tree, cell_coords, chunk_table,
                        far_field_rings, theta_to_ring)
from .keys import morton_key_from_coords, quantize


@functools.partial(jax.jit,
                   static_argnames=("leaf_level", "chunk", "window", "k"))
def _stats_program(positions, leaf_level: int, chunk: int, window: int,
                   k: int):
    """(total chunks, max per-cell ring windows) for the static shapes."""
    n, dim = positions.shape
    L = leaf_level
    ncells = 1 << (dim * L)
    q = quantize(positions, L)
    ids = morton_key_from_coords(q, L).astype(jnp.int32)
    counts = jnp.zeros((ncells,), jnp.int32).at[ids].add(1)
    num_chunks = jnp.sum(-(-counts // chunk))
    # Max over occupied cells of the ring window count == max over bodies
    # (per-body avoids a unique(); blocks bound the [B, nnear] gathers).
    wc = -(-counts // window)  # [ncells]
    offs = jnp.asarray(_neighbor_offsets(dim, k))  # [nnear, D]
    side = 1 << L

    def block_max(ids_b):
        xy = cell_coords(ids_b.astype(jnp.uint32), dim).astype(jnp.int32)
        nb_xy = xy[:, None, :] + offs[None, :, :]
        ok = jnp.all((nb_xy >= 0) & (nb_xy < side), axis=-1)
        nb_ids = morton_key_from_coords(
            jnp.clip(nb_xy, 0, side - 1).astype(jnp.uint32)
            .reshape(-1, dim), L).astype(jnp.int32).reshape(ids_b.shape[0],
                                                            -1)
        return jnp.max(jnp.sum(wc[nb_ids] * ok, axis=1))

    B = 16384
    npad = -(-n // B) * B
    ids_p = jnp.concatenate([ids, jnp.zeros((npad - n,), jnp.int32)]) \
        if npad > n else ids
    maxw = jnp.max(jax.lax.map(block_max, ids_p.reshape(-1, B)))
    return num_chunks, maxw


_STATS_MEMO: dict = {}
_STATS_MEMO_MAX = 128


def sparse_grid_stats(positions, leaf_level: int, chunk: int, window: int,
                      k: int):
    """Concrete (num_chunks, max_windows); one memoized device sync per
    (positions, config) — same exact id+weakref memo as
    ``compute_capacity_cached`` (jax.Arrays are immutable, so identity
    implies identical data)."""
    key = (id(positions), leaf_level, chunk, window, k)
    hit = _STATS_MEMO.get(key)
    if hit is not None and hit[0]() is positions:
        return hit[1]
    nt, nw = _stats_program(positions, leaf_level, chunk, window, k)
    val = (max(1, int(nt)), max(1, int(nw)))
    if len(_STATS_MEMO) >= _STATS_MEMO_MAX:
        dead = [kk for kk, v in _STATS_MEMO.items() if v[0]() is None]
        for kk in dead:
            del _STATS_MEMO[kk]
        if len(_STATS_MEMO) >= _STATS_MEMO_MAX:
            _STATS_MEMO.clear()
    _STATS_MEMO[key] = (weakref.ref(positions), val)
    return val


def near_field_windows(tree: GridTree, cell_b: jax.Array,
                       tpos: jax.Array, *, k: int, window: int,
                       max_windows: int, softening: float) -> jax.Array:
    """Ring near field for target chunks via fixed-size source windows.

    ``cell_b`` [B] is each chunk's leaf cell; its (2k+1)^D ring cells are
    contiguous runs of Morton-sorted bodies, covered by ⌈occ/window⌉
    windows each. The per-chunk window list (start, run-end) is built by a
    static loop over the ring offsets writing into [B, NW] tables, then
    evaluated in cond-skipped sub-batches — the exact pass-2 pattern of
    ops/bvh.py (window capacities there; an exact probe here). Self/
    coincident pairs fall to the ``d² < guard`` mask like the dense path.

    Returns the near-field acceleration increment for ``tpos`` [B, T, D].
    """
    n, dim = tree.pos_sorted.shape
    dtype = tree.pos_sorted.dtype
    B = cell_b.shape[0]
    NW = max_windows
    S = window
    side = 1 << tree.leaf_level
    offs = jnp.asarray(_neighbor_offsets(dim, k))  # [nnear, D]
    nnear = offs.shape[0]

    xy = cell_coords(cell_b.astype(jnp.uint32), dim).astype(jnp.int32)
    nb_xy = xy[:, None, :] + offs[None, :, :]
    nb_ok = jnp.all((nb_xy >= 0) & (nb_xy < side), axis=-1)  # [B, nnear]
    nb_ids = morton_key_from_coords(
        jnp.clip(nb_xy, 0, side - 1).astype(jnp.uint32).reshape(-1, dim),
        tree.leaf_level).astype(jnp.int32).reshape(B, nnear)
    rs = tree.cell_start[nb_ids]  # [B, nnear]
    cnt = tree.cell_count[nb_ids] * nb_ok
    wc = -(-cnt // S)
    woff = jnp.cumsum(wc, axis=1) - wc  # exclusive prefix [B, nnear]

    # Window tables: wstart (first sorted-body row) / wend (end of the
    # covered run) per window slot, filled ring cell by ring cell
    # (fori over the static nnear; each iteration is [B, NW] elementwise).
    warange = jnp.arange(NW, dtype=jnp.int32)[None, :]  # [1, NW]

    def fill(j, carry):
        wstart, wend = carry
        wo = jax.lax.dynamic_index_in_dim(woff, j, 1)  # [B, 1]
        wcj = jax.lax.dynamic_index_in_dim(wc, j, 1)
        rsj = jax.lax.dynamic_index_in_dim(rs, j, 1)
        cntj = jax.lax.dynamic_index_in_dim(cnt, j, 1)
        in_j = (warange >= wo) & (warange < wo + wcj)
        wstart = jnp.where(in_j, rsj + (warange - wo) * S, wstart)
        wend = jnp.where(in_j, rsj + cntj, wend)
        return wstart, wend

    wstart0 = jnp.zeros((B, NW), jnp.int32)
    wend0 = jnp.zeros((B, NW), jnp.int32)  # empty: wend <= wstart
    wstart, wend = jax.lax.fori_loop(0, nnear, fill, (wstart0, wend0))

    # Evaluate in sub-batches of windows; trailing all-empty sub-batches
    # (chunks far from any dense core) are skipped by a scalar cond.
    wl = min(NW, max(1, 2048 // S))
    NWr = -(-NW // wl) * wl  # whole sub-batches (dynamic_slice clamps!)
    if NWr > NW:
        wstart = jnp.pad(wstart, ((0, 0), (0, NWr - NW)))
        wend = jnp.pad(wend, ((0, 0), (0, NWr - NW)))
    nwb = NWr // wl
    arangeS = jnp.arange(S, dtype=jnp.int32)
    soft2 = jnp.asarray(softening, dtype) ** 2
    bt = tree.body_pack.reshape(-1, 4)  # [np8, 4] = (pos|0, mass)
    nrows = bt.shape[0]

    def win_chunk(c, acc):
        ws = jax.lax.dynamic_slice_in_dim(wstart, c * wl, wl, axis=1)
        we = jax.lax.dynamic_slice_in_dim(wend, c * wl, wl, axis=1)

        def do(acc):
            idx = ws[:, :, None] + arangeS  # [B, wl, S]
            in_rng = idx < we[:, :, None]
            rows = bt[jnp.clip(idx, 0, nrows - 1)]  # [B, wl, S, 4]
            spos = rows[..., :dim].reshape(B, -1, dim)
            smass = (rows[..., 3] * in_rng).reshape(B, -1)
            d2 = None
            diffs = []
            for d in range(dim):
                dd = spos[:, None, :, d] - tpos[:, :, None, d]
                diffs.append(dd)  # [B, T, wl*S]
                d2 = dd * dd if d2 is None else d2 + dd * dd
            inv = jax.lax.rsqrt(d2 + soft2)
            ww = smass[:, None, :] * (inv * inv * inv)
            ww = jnp.where(d2 < _DIST2_GUARD, 0.0, ww)
            return acc + jnp.stack(
                [jnp.sum(ww * diffs[d], axis=-1) for d in range(dim)],
                axis=-1)

        return jax.lax.cond(jnp.any(we > ws), do, lambda a: a, acc)

    return jax.lax.fori_loop(
        0, nwb, win_chunk, jnp.zeros(tpos.shape, dtype))


@functools.partial(
    jax.jit,
    static_argnames=("leaf_level", "k", "softening", "chunk_size",
                     "num_chunks", "max_windows", "chunk_batch",
                     "window", "multipole", "far_impl", "num_segments"))
def _bh_sparse_fused(positions, masses, g, *, leaf_level, k, softening,
                     chunk_size, num_chunks, max_windows, chunk_batch,
                     window, multipole, far_impl="point",
                     num_segments=1, segment_index=None):
    """Build + chunked evaluation + unsort + G-scale as ONE device program
    (as in grid_tree._bh_grid_fused).

    ``num_segments > 1`` bounds the dispatch (the grid-BH pattern,
    grid_tree_accel_sorted): each call sweeps only its slice of the chunk
    batches. ``segment_index`` is traced, so ONE compile serves all segments; the
    caller sums the per-segment results (disjoint support)."""
    n, dim = positions.shape
    C0 = chunk_size
    tree = build_grid_tree(positions, masses, leaf_level, capacity=8,
                           quad=(multipole == "quad"),
                           agg_num_chunks=num_chunks,
                           agg_chunk_size=C0)
    cell, cstart, clen, coffs = chunk_table(
        tree.cell_start, tree.cell_count, chunk=C0, num_chunks=num_chunks)

    # Pad the chunk rows to whole batches (pad rows: clen == 0) — and to
    # whole SEGMENTS of batches, so the per-segment dynamic_slice below
    # can never clamp out of bounds (the round-2 re-read trap).
    NB = -(-(-(-num_chunks // chunk_batch)) // num_segments) * num_segments
    NTp = NB * chunk_batch
    if NTp > num_chunks:
        pad = NTp - num_chunks
        cell = jnp.concatenate([cell, jnp.zeros((pad,), cell.dtype)])
        cstart = jnp.concatenate([cstart, jnp.zeros((pad,), cstart.dtype)])
        clen = jnp.concatenate([clen, jnp.zeros((pad,), clen.dtype)])

    bt = tree.body_pack.reshape(-1, 4)
    nrows = bt.shape[0]
    arangeC = jnp.arange(C0, dtype=jnp.int32)

    def one_batch(args):
        cell_b, cstart_b, clen_b = args  # [B] each
        idx = cstart_b[:, None] + arangeC  # [B, C0]
        rows = bt[jnp.clip(idx, 0, nrows - 1)]
        tpos = rows[..., :dim]  # garbage rows masked at the output gather
        acc = far_field_rings(tree, cell_b, tpos, k=k,
                              multipole=multipole, far_impl=far_impl)
        acc = acc + near_field_windows(
            tree, cell_b, tpos, k=k, window=window,
            max_windows=max_windows, softening=softening)
        return acc

    xs = (cell.reshape(NB, chunk_batch), cstart.reshape(NB, chunk_batch),
          clen.reshape(NB, chunk_batch))
    # Sorted row i -> (chunk, slot): pure gather back to sorted order.
    leaf = tree.leaf_ids
    within = jnp.arange(n, dtype=jnp.int32) - tree.cell_start[leaf]
    chunk_of = coffs[leaf] + within // C0
    slot = within % C0
    idx_flat = chunk_of * C0 + slot
    if num_segments == 1:
        accs = jax.lax.map(one_batch, xs)
        acc_flat = accs.reshape(-1, dim)  # [NTp·C0, D]
        acc_sorted = acc_flat[idx_flat]
    else:
        NBs = NB // num_segments
        sidx = jnp.asarray(
            0 if segment_index is None else segment_index, jnp.int32)
        xs_s = tuple(jax.lax.dynamic_slice_in_dim(x, sidx * NBs, NBs)
                     for x in xs)
        accs = jax.lax.map(one_batch, xs_s)
        acc_flat = accs.reshape(-1, dim)  # [NBs·cb·C0, D]
        base = sidx * (NBs * chunk_batch * C0)
        in_seg = (idx_flat >= base) \
            & (idx_flat < base + acc_flat.shape[0])
        acc_sorted = acc_flat[
            jnp.clip(idx_flat - base, 0, acc_flat.shape[0] - 1)] \
            * in_seg[:, None]
    acc = jnp.zeros_like(acc_sorted).at[tree.order].set(acc_sorted)
    return (g * masses)[:, None] * acc


def barnes_hut_sparse(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    theta: Optional[float] = None,
    leaf_level: Optional[int] = None,
    chunk_size: int = 512,  # bigger cell-aligned chunks amortize the
    # per-chunk window machinery over the dense core's huge cells; 512 was
    # the best of 64-2048 on the previous accelerator (Plummer 1e5 3D
    # θ=0.25), to be re-tuned on the GPU (ROADMAP).
    window: int = 8,
    chunk_batch: int = 128,
    multipole: str = "quad",
    far_impl: str = "local",
    num_segments: Optional[int] = None,
) -> jax.Array:
    """Barnes-Hut forces [N, D] on the sparse (clustered-input) grid path.

    Same force law and ring MAC as :func:`grid_tree.barnes_hut_grid`
    (θ_eff = 1/(k+1) ≤ θ; quadrupole far field by default), but near-field
    memory and work scale with the *actual* per-ring occupancy instead of
    the max-leaf-capacity square — a Plummer core streams as O(core²)
    bounded tiles rather than materializing a capacity² tensor. Shapes are
    sized by one memoized stats probe; there is no overflow/escalation
    path. Call un-jitted (the probe is a device sync), like the other tier
    drivers.
    """
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    k = theta_to_ring(theta)
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim, k=k)
    num_chunks, max_windows = sparse_grid_stats(
        positions, leaf_level, chunk_size, window, k)
    g = jnp.asarray(config.G, positions.dtype)
    if num_segments is None:
        # Bounded segments follow the grid-BH pattern (they served a
        # dispatch-time limit of the previous platform; whether the GPU
        # needs them is open — ROADMAP). Clustered near-field work scales
        # with the core occupancy, so key on N.
        num_segments = 1 if n < 500_000 else 4
    if num_segments == 1:
        return _bh_sparse_fused(
            positions, masses, g, leaf_level=leaf_level, k=k,
            softening=float(config.softening), chunk_size=chunk_size,
            num_chunks=num_chunks, max_windows=max_windows,
            chunk_batch=chunk_batch, window=window, multipole=multipole,
            far_impl=far_impl)
    acc = None
    for si in range(num_segments):
        part = _bh_sparse_fused(
            positions, masses, g, leaf_level=leaf_level, k=k,
            softening=float(config.softening), chunk_size=chunk_size,
            num_chunks=num_chunks, max_windows=max_windows,
            chunk_batch=chunk_batch, window=window, multipole=multipole,
            far_impl=far_impl, num_segments=num_segments,
            segment_index=jnp.int32(si))
        acc = part if acc is None else acc + part
    return acc
