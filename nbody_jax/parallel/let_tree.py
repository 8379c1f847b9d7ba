"""Body-sharded trees with locally-essential-tree (LET) exchange.

The BASELINE.json north-star distribution design ("spatial domain
decomposition with locally-essential-tree / halo exchange"), replacing the
replicated-body scheme of parallel/sharded_tree.py whose per-chip memory is
O(N). Here per-chip **body** memory is O(N/P + halo):

1. **Exchange**: each chip Morton-sorts its resident body shard against
   globally psum'd bounds, buckets bodies by the owning chip (the leading
   log2 P bits of the Morton key — chip p owns the contiguous dense-cell
   chunk [p·M/P, (p+1)·M/P)), and trades fixed-capacity buckets with one
   ``all_to_all``. Received bodies are locally re-sorted: every chip now
   holds exactly the bodies of its spatial chunk, in Morton order.
2. **Aggregates**: per-chunk leaf mass/COM window sums are ``all_gather``-ed
   into replicated per-level cell tables (4 floats per cell — the tree
   *summary* is cheap to replicate; only bodies are heavy) and reduced up
   the hierarchy exactly as in the single-chip build.
3. **Far field**: each chip evaluates the V-list monopole field for its own
   chunk's leaves against the replicated level tables (identical math to
   ops/grid_tree.py).
4. **Near field**: neighbors inside the chunk are evaluated locally;
   neighbors owned by other chips form a compacted (leaf, neighbor-cell)
   *halo list* (fixed capacity, overflow ⇒ NaN poisoning — never silent),
   evaluated as the owners' body blocks rotate past on a ``ppermute`` ring.
   Peak per-chip body memory stays O(N/P): one foreign block in flight.

Capacity knobs (static, all overflow-poisoned rather than truncated):
``bucket_headroom`` bounds per-(src,dst) exchange buckets at
headroom·N/P²; ``halo_cap`` bounds the foreign-neighbor list. Uniform
distributions sit far below both; heavily clustered inputs need larger
values (or a shallower tree).

Reference parity: the reference has no distributed layer at all (SURVEY.md
§2.4 — OpenMP/ParlayLib shared memory only); this module is the from-scratch
distribution layer for the Barnes-Hut tier (``octree.cpp`` +
``methods.cpp:238-272``) and the FMM near field.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import DEFAULT_GRAVITY, GravityConfig
from ..ops.grid_tree import (
    _neighbor_offsets,
    _point_mass_accel,
    _quad_cell_accel,
    _ring_offsets,
    _window_rows_raw,
    auto_leaf_level,
    cell_coords,
    check_grid_capacity,
    compute_capacity_cached,
    leaf_window_sums,
    reduce_levels,
    theta_to_ring,
)
from ..ops.keys import morton_key_from_coords, quantize
from .mesh import BODY_AXIS, make_mesh, pad_to_multiple


def _np_morton(coords: "np.ndarray", dim: int) -> "np.ndarray":
    """Numpy Morton encode (matches ops/keys.morton_key_from_coords) for
    the trace-time halo sizing — avoids hundreds of eager device
    dispatches."""
    import numpy as np

    def spread2(x):
        x = x.astype(np.uint32) & 0xFFFF
        x = (x | (x << 8)) & 0x00FF00FF
        x = (x | (x << 4)) & 0x0F0F0F0F
        x = (x | (x << 2)) & 0x33333333
        x = (x | (x << 1)) & 0x55555555
        return x

    def spread3(x):
        x = x.astype(np.uint32) & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    if dim == 2:
        return (spread2(coords[:, 0]) << 1) | spread2(coords[:, 1])
    return ((spread3(coords[:, 0]) << 2) | (spread3(coords[:, 1]) << 1)
            | spread3(coords[:, 2]))


@functools.lru_cache(maxsize=None)
def halo_cap_exact(dim: int, L: int, cc: int, k: int) -> int:
    """Exact per-chip halo-list peak — a pure function of the geometry.

    The halo list (:func:`_halo_list`) holds every (leaf, neighbor-cell)
    pair whose neighbor lies outside the chip's contiguous Morton chunk,
    INDEPENDENT of body placement — so the worst chip's count is computable
    at trace time and the capacity can be sized exactly instead of by the
    old surface-area heuristic (which NaN-poisoned on clustered inputs and
    needed hand retuning — VERDICT r2 weak item 5). Cost: one numpy pass of
    num_cells × (2k+1)^D — ≲1e8 ops at every realistic (L, k); guarded by
    a fallback to a padded heuristic above that.
    """
    import numpy as np
    from ..ops.grid_tree import _neighbor_offsets

    num = 1 << (dim * L)
    nshard = num // cc
    side = 1 << L
    offs = _neighbor_offsets(dim, k)
    if num * len(offs) > 3e8:  # unrealistically deep: padded heuristic
        nnear = len(offs)
        return int(min(cc * nnear, 8 * k * nnear
                       * int(max(cc, 4) ** ((dim - 1) / dim))))
    axes = [np.arange(side, dtype=np.int32)] * dim
    coords = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")],
                      axis=1)
    ids = _np_morton(coords, dim)
    owner = (ids // cc).astype(np.int32)
    per_chip = np.zeros(nshard, np.int64)
    for off in offs:
        nb = coords + off[None, :]
        ok = np.all((nb >= 0) & (nb < side), axis=1)
        nb_owner = _np_morton(np.clip(nb, 0, side - 1), dim) // cc
        foreign = ok & (nb_owner != owner)
        per_chip += np.bincount(owner[foreign], minlength=nshard)
    return int(per_chip.max())


def _exchange_bucket_peak(positions, leaf_level: int, nshard: int,
                          rows_per: int) -> int:
    """Exact max per-(source shard, owner chip) exchange bucket count.

    Mirrors :func:`_exchange`'s bounds (1.01-padded global min/max) and
    Morton keying on the real (unpadded) bodies, so the returned peak is
    the exact capacity the all_to_all buckets need — replacing the
    ``bucket_headroom·N/P²`` guess that overflowed (→ NaN poison) on
    clustered inputs. One device sync per (input, mesh); id-memoized like
    grid_tree.compute_capacity_cached.
    """
    n, dim = positions.shape
    mins = jnp.min(positions, axis=0)
    maxs = jnp.max(positions, axis=0)
    center = 0.5 * (mins + maxs)
    half = 0.5 * (maxs - mins) * 1.01 + 1e-30
    key = morton_key_from_coords(
        quantize(positions, leaf_level, lo=center - half, hi=center + half),
        leaf_level).astype(jnp.int32)
    cc = (1 << (dim * leaf_level)) // nshard
    owner = key // cc
    src = jnp.arange(n, dtype=jnp.int32) // rows_per
    counts = jnp.zeros((nshard * nshard,), jnp.int32) \
        .at[src * nshard + owner].add(1)
    return int(jnp.max(counts))


_PEAK_MEMO: dict = {}
_PEAK_MEMO_MAX = 128


def exchange_bucket_peak_cached(positions, leaf_level: int, nshard: int,
                                rows_per: int) -> int:
    import weakref
    key = (id(positions), leaf_level, nshard, rows_per)
    hit = _PEAK_MEMO.get(key)
    if hit is not None and hit[0]() is positions:
        return hit[1]
    peak = _exchange_bucket_peak(positions, leaf_level, nshard, rows_per)
    if len(_PEAK_MEMO) >= _PEAK_MEMO_MAX:
        dead = [kk for kk, v in _PEAK_MEMO.items() if v[0]() is None]
        for kk in dead:
            del _PEAK_MEMO[kk]
        if len(_PEAK_MEMO) >= _PEAK_MEMO_MAX:
            _PEAK_MEMO.clear()
    _PEAK_MEMO[key] = (weakref.ref(positions), peak)
    return peak


def _exchange(pos_l, mass_l, idx_l, *, dim, L, nshard, cc, H, axis_name):
    """Morton bucket + all_to_all: returns this chip's chunk bodies.

    Returns (pos_s, mass_s, idx_s, key_s [PH], m_loc scalar count,
    lo, hi, overflow bool). Arrays are Morton-sorted with invalid rows
    (idx < 0) at the end.
    """
    # Global bounds (reference 1% padding, octree.cpp:170-188), excluding
    # padding rows (idx < 0) whose far-away coords would blow up the domain.
    big = jnp.asarray(jnp.finfo(pos_l.dtype).max, pos_l.dtype)
    vmask = (idx_l >= 0)[:, None]
    mins = jax.lax.pmin(
        jnp.min(jnp.where(vmask, pos_l, big), axis=0), axis_name)
    maxs = jax.lax.pmax(
        jnp.max(jnp.where(vmask, pos_l, -big), axis=0), axis_name)
    center = 0.5 * (mins + maxs)
    half = 0.5 * (maxs - mins) * 1.01 + 1e-30
    lo, hi = center - half, center + half

    key = morton_key_from_coords(
        quantize(pos_l, L, lo=lo, hi=hi), L).astype(jnp.int32)
    # Padding rows (idx < 0) must not be shipped: bucket them nowhere.
    key = jnp.where(idx_l >= 0, key, jnp.int32(nshard * cc))
    order = jnp.argsort(key)
    key_s = key[order]
    pos_s = pos_l[order]
    mass_s = mass_l[order]
    idx_s = idx_l[order]

    bnd = jnp.searchsorted(
        key_s, jnp.arange(nshard + 1, dtype=jnp.int32) * cc).astype(jnp.int32)
    overflow = jnp.any(bnd[1:] - bnd[:-1] > H)

    # Tail-pad by H so bucket slices never clamp (a clamped dynamic_slice
    # start would silently read the wrong rows).
    dim_ = pos_s.shape[1]
    pos_t = jnp.concatenate([pos_s, jnp.zeros((H, dim_), pos_s.dtype)])
    mass_t = jnp.concatenate([mass_s, jnp.zeros((H,), mass_s.dtype)])
    idx_t = jnp.concatenate([idx_s, jnp.full((H,), -1, jnp.int32)])

    sendf = jnp.zeros((nshard, H, 4), pos_l.dtype)
    sendi = jnp.full((nshard, H, 1), -1, jnp.int32)
    arangeH = jnp.arange(H, dtype=jnp.int32)
    for p in range(nshard):
        cnt = bnd[p + 1] - bnd[p]
        seg_p = jax.lax.dynamic_slice_in_dim(pos_t, bnd[p], H)
        seg_m = jax.lax.dynamic_slice_in_dim(mass_t, bnd[p], H)
        seg_i = jax.lax.dynamic_slice_in_dim(idx_t, bnd[p], H)
        ok = arangeH < cnt
        sendf = sendf.at[p, :, :dim].set(
            jnp.where(ok[:, None], seg_p, 0.0))
        sendf = sendf.at[p, :, 3].set(jnp.where(ok, seg_m, 0.0))
        sendi = sendi.at[p, :, 0].set(jnp.where(ok, seg_i, -1))

    recvf = jax.lax.all_to_all(sendf, axis_name, split_axis=0,
                               concat_axis=0)
    recvi = jax.lax.all_to_all(sendi, axis_name, split_axis=0,
                               concat_axis=0)

    flatf = recvf.reshape(nshard * H, 4)
    flati = recvi.reshape(nshard * H)
    rkey = morton_key_from_coords(
        quantize(flatf[:, :dim], L, lo=lo, hi=hi), L).astype(jnp.int32)
    rkey = jnp.where(flati >= 0, rkey, jnp.int32(nshard * cc))
    o2 = jnp.argsort(rkey)
    m_loc = jnp.sum(flati >= 0)
    return (flatf[o2, :dim], flatf[o2, 3], flati[o2], rkey[o2], m_loc,
            lo, hi, overflow)


def _chunk_layout(key_s, m_loc, *, cc, my0):
    """Run starts/counts for this chip's cc chunk cells.

    key_s: [PH] local sorted keys (invalid rows at the end with key >= M).
    """
    cells = my0 + jnp.arange(cc, dtype=jnp.int32)
    starts = jnp.searchsorted(key_s, cells).astype(jnp.int32)
    ends = jnp.concatenate(
        [starts[1:], jnp.asarray([0], jnp.int32)])
    ends = ends.at[-1].set(m_loc.astype(jnp.int32))
    return starts, ends - starts


def _pack_bodies(pos_s, mass_s, dim):
    """Superrow packing of the local sorted bodies ([PH] is 8-aligned)."""
    ph = pos_s.shape[0]
    bt = jnp.zeros((ph, 4), pos_s.dtype)
    bt = bt.at[:, :dim].set(pos_s)
    bt = bt.at[:, 3].set(mass_s)
    return bt.reshape(ph // 8, 32)


def _replicated_levels(body_pack, starts, counts, *, dim, L, cap, cc,
                       axis_name, dtype, quad=False):
    """Leaf window sums for my chunk → all_gather → reduce up: replicated
    [com|mass] packed tables per level (step 2 of the module docstring).

    With ``quad=True`` additionally returns per-level COM-centered second
    moments. Leaves never span chips, so the leaf sums (and moments — they
    are centered at the leaf's own COM) are purely local before the
    ``all_gather``; the shared :func:`~nbody_jax.ops.grid_tree.
    leaf_window_sums` / :func:`~nbody_jax.ops.grid_tree.reduce_levels`
    then match the single-chip build exactly.
    """
    m_loc, mx_loc, S_loc = leaf_window_sums(
        body_pack, starts, starts + counts, capacity=cap, ncells=cc,
        dim=dim, quad=quad)
    m_l = jax.lax.all_gather(m_loc, axis_name, tiled=True)
    mx_l = jax.lax.all_gather(mx_loc, axis_name, tiled=True)
    S_l = (jax.lax.all_gather(S_loc, axis_name, tiled=True)
           if quad else None)
    _, _, level_pack, level_quad = reduce_levels(
        m_l, mx_l, S_l, dim=dim, L=L, dtype=dtype)
    return level_pack, (level_quad if quad else None)


def _halo_list(my_cells, *, dim, L, cc, my0, k, halo_cap):
    """Compacted (leaf_rel, foreign neighbor cell id) pairs.

    Returns (leaf_rel [HC], nb_id [HC], valid [HC], overflow bool).
    Sort-compaction (chosen over scatters on the previous accelerator).
    """
    near_offs = jnp.asarray(_neighbor_offsets(dim, k))
    side = 1 << L
    xy = cell_coords(my_cells.astype(jnp.uint32), dim).astype(jnp.int32)
    nb_xy = xy[:, None, :] + near_offs[None, :, :]  # [cc, nnear, D]
    ok = jnp.all((nb_xy >= 0) & (nb_xy < side), axis=-1)
    nb_ids = morton_key_from_coords(
        jnp.clip(nb_xy, 0, side - 1).astype(jnp.uint32).reshape(-1, dim),
        L).astype(jnp.int32).reshape(cc, -1)
    foreign = ok & ((nb_ids < my0) | (nb_ids >= my0 + cc))
    # Encode (leaf_rel, nb) into one sortable int64-free key: nb ids fit in
    # 31 - log2(cc·nnear) bits is not guaranteed, so sort a validity key
    # and apply the permutation to both arrays.
    leaf_rel = jnp.broadcast_to(
        jnp.arange(cc, dtype=jnp.int32)[:, None], foreign.shape).reshape(-1)
    nb_flat = nb_ids.reshape(-1)
    sortkey = jnp.where(foreign.reshape(-1), 0, 1).astype(jnp.int32)
    perm = jnp.argsort(sortkey, stable=True)
    total = jnp.sum(foreign)
    hc = halo_cap
    leaf_rel = leaf_rel[perm][:hc]
    nb_flat = nb_flat[perm][:hc]
    valid = jnp.arange(hc) < total
    return leaf_rel, nb_flat, valid, total > hc


def _near_offsets_ids(cells_b, *, dim, L, k):
    """Neighbor cell ids + in-bounds mask for a batch of dense cells."""
    near_offs = jnp.asarray(_neighbor_offsets(dim, k))
    side = 1 << L
    leaf_xy = cell_coords(cells_b.astype(jnp.uint32), dim).astype(jnp.int32)
    nb_xy = leaf_xy[:, None, :] + near_offs[None, :, :]
    nb_ok = jnp.all((nb_xy >= 0) & (nb_xy < side), axis=-1)
    nb_ids = morton_key_from_coords(
        jnp.clip(nb_xy, 0, side - 1).astype(jnp.uint32).reshape(-1, dim),
        L).astype(jnp.int32).reshape(cells_b.shape[0], -1)
    return nb_ids, nb_ok


def _near_field_let(body_pack, starts, counts, *, dim, L, nshard, cc, cap,
                    my0, me, k, softening, halo_cap, leaf_batch, axis_name):
    """Local + halo-ring P2P for this chip's chunk.

    Returns (near acc in window layout [cc, TWR, D], halo-overflow bool).
    Used by both the LET Barnes-Hut and LET FMM tiers (step 4 of the
    module docstring).
    """
    dtype = body_pack.dtype
    TWR = (cap // 8 + 1) * 8
    my_cells = my0 + jnp.arange(cc, dtype=jnp.int32)
    lb = min(leaf_batch, cc)

    def one_batch(cells_b):
        B = cells_b.shape[0]
        rel_b = cells_b - my0
        tb, _, _ = _window_rows_raw(body_pack, starts, counts, cap, rel_b)
        tpos = tb[..., :dim]
        nb_ids, nb_ok = _near_offsets_ids(cells_b, dim=dim, L=L, k=k)
        local = nb_ok & (nb_ids >= my0) & (nb_ids < my0 + cc)
        rel_nb = jnp.clip(nb_ids - my0, 0, cc - 1)
        sb, _, svalid = _window_rows_raw(body_pack, starts, counts, cap,
                                         rel_nb)
        svalid = svalid & local[:, :, None]
        spos = sb[..., :dim].reshape(B, -1, dim)
        smass = (sb[..., 3] * svalid).reshape(B, -1)
        return _point_mass_accel(tpos, spos, smass, softening)

    accs = jax.lax.map(one_batch, my_cells.reshape(cc // lb, lb))
    acc_win = accs.reshape(cc, TWR, dim)

    # Halo phase: foreign neighbors evaluated as owner blocks rotate past
    # on the ppermute ring (peak foreign-body memory: one block).
    h_leaf, h_nb, h_valid, of_halo = _halo_list(
        my_cells, dim=dim, L=L, cc=cc, my0=my0, k=k, halo_cap=halo_cap)
    h_tb, _, _ = _window_rows_raw(body_pack, starts, counts, cap, h_leaf)
    h_tpos = h_tb[..., :dim]  # [HC, TWR, D]

    def ring_step(carry, s):
        blk_pack, blk_starts, blk_counts, hacc = carry
        q = (me - s) % nshard  # owner of the block currently held
        q0 = q * cc
        mine = h_valid & (h_nb >= q0) & (h_nb < q0 + cc)
        rel = jnp.clip(h_nb - q0, 0, cc - 1)
        sb, _, svalid = _window_rows_raw(blk_pack, blk_starts, blk_counts,
                                         cap, rel)
        svalid = svalid & mine[:, None]
        hacc = hacc + _point_mass_accel(
            h_tpos, sb[..., :dim], sb[..., 3] * svalid, softening)
        perm = [(i, (i + 1) % nshard) for i in range(nshard)]
        blk_pack = jax.lax.ppermute(blk_pack, axis_name, perm)
        blk_starts = jax.lax.ppermute(blk_starts, axis_name, perm)
        blk_counts = jax.lax.ppermute(blk_counts, axis_name, perm)
        return (blk_pack, blk_starts, blk_counts, hacc), None

    hacc0 = jax.lax.pcast(jnp.zeros(h_tpos.shape, dtype), axis_name,
                          to="varying")
    (_, _, _, hacc), _ = jax.lax.scan(
        ring_step, (body_pack, starts, counts, hacc0),
        jnp.arange(nshard, dtype=jnp.int32))
    # Fold halo contributions back into the window accumulator (small
    # scatter-add over ≤halo_cap rows).
    acc_win = acc_win.at[jnp.where(h_valid, h_leaf, cc), :, :].add(
        hacc * h_valid[:, None, None], mode="drop")
    return acc_win, of_halo


def _windows_to_local(acc_win, key_s, starts, *, my0, cc, cap, dim):
    """Window layout → local sorted order (pure gather, as single-chip)."""
    TWR = (cap // 8 + 1) * 8
    leaf_rel_body = jnp.clip(key_s - my0, 0, cc - 1)
    body_start = starts[leaf_rel_body]
    window_slot = (jnp.arange(key_s.shape[0], dtype=jnp.int32)
                   - (body_start // 8) * 8)
    src = leaf_rel_body * TWR + jnp.clip(window_slot, 0, TWR - 1)
    return acc_win.reshape(-1, dim)[src]


@functools.partial(
    jax.jit,
    static_argnames=("dim", "L", "nshard", "cc", "cap", "H", "halo_cap",
                     "k", "softening", "G", "axis_name", "leaf_batch",
                     "multipole", "far_impl"))
def _let_bh_local(pos_l, mass_l, idx_l, *, dim, L, nshard, cc, cap, H,
                  halo_cap, k, softening, G, axis_name, leaf_batch,
                  multipole="quad", far_impl="point"):
    """Per-chip LET Barnes-Hut (runs under shard_map).

    Returns (forces_loc [PH, D], idx_loc [PH], valid [PH]).
    """
    dtype = pos_l.dtype
    me = jax.lax.axis_index(axis_name).astype(jnp.int32)
    my0 = me * cc

    (pos_s, mass_s, idx_s, key_s, m_loc, lo, hi,
     of_ex) = _exchange(pos_l, mass_l, idx_l, dim=dim, L=L, nshard=nshard,
                        cc=cc, H=H, axis_name=axis_name)
    starts, counts = _chunk_layout(key_s, m_loc, cc=cc, my0=my0)
    # starts are absolute into the local sorted arrays; cell ids used with
    # them must be chunk-relative.
    body_pack = _pack_bodies(pos_s, mass_s, dim)
    level_pack, level_quad = _replicated_levels(
        body_pack, starts, counts, dim=dim, L=L, cap=cap, cc=cc,
        axis_name=axis_name, dtype=dtype, quad=(multipole == "quad"))

    cand_offs, _ = _ring_offsets(dim, k)
    cand_offs = jnp.asarray(cand_offs)
    TWR = (cap // 8 + 1) * 8

    lb = min(leaf_batch, cc)
    my_cells = my0 + jnp.arange(cc, dtype=jnp.int32)

    use_local = far_impl == "local"

    def far_batch(cells_b):
        B = cells_b.shape[0]
        rel_b = cells_b - my0
        tb, _, _ = _window_rows_raw(body_pack, starts, counts, cap, rel_b)
        tpos = tb[..., :dim]
        acc = jnp.zeros(tpos.shape, dtype)
        if use_local:
            # Cell→cell far field (same gating as grid_tree.far_field_rings).
            from ..ops.local_expansion import (eval_local, local_coeffs,
                                               num_coeffs,
                                               ring_level_is_local)
            leaf_xy = cell_coords(cells_b.astype(jnp.uint32), dim)
            csize = (hi - lo) / (1 << L)
            center = lo + (leaf_xy.astype(dtype) + 0.5) * csize  # [B, D]
            _, nj, nh = num_coeffs(dim)
            a0 = jnp.zeros((B, dim), dtype)
            Jp = jnp.zeros((B, nj), dtype)
            Hp = jnp.zeros((B, nh), dtype)
            any_local = False
        # Far field: identical V-list geometry to grid_tree (single chip).
        for l in range(2, L + 1):
            anc = (cells_b >> (dim * (L - l))).astype(jnp.uint32)
            anc_xy = cell_coords(anc, dim).astype(jnp.int32)
            parent_xy = anc_xy >> 1
            cand_xy = parent_xy[:, None, :] * 2 + cand_offs[None, :, :]
            delta = cand_xy - anc_xy[:, None, :]
            cheb = jnp.max(jnp.abs(delta), axis=-1)
            in_bounds = jnp.all(
                (cand_xy >= 0) & (cand_xy < (1 << l)), axis=-1)
            is_far = (cheb > k) & in_bounds
            cand_ids = morton_key_from_coords(
                jnp.clip(cand_xy, 0, (1 << l) - 1).astype(jnp.uint32)
                .reshape(-1, dim), l).astype(jnp.int32).reshape(B, -1)
            cpack = level_pack[l][cand_ids]
            local_l = use_local and ring_level_is_local(dim, k, L, l)
            if local_l:
                cS = (level_quad[l][cand_ids] * is_far[..., None]
                      if multipole == "quad" else None)
                da0, dJ, dH = local_coeffs(
                    center, cpack[..., :dim], cpack[..., 3] * is_far, cS)
                a0, Jp, Hp = a0 + da0, Jp + dJ, Hp + dH
                any_local = True
            elif multipole == "quad":
                cquad = level_quad[l][cand_ids] * is_far[..., None]
                acc = acc + _quad_cell_accel(
                    tpos, cpack[..., :dim], cpack[..., 3] * is_far, cquad)
            else:
                acc = acc + _point_mass_accel(
                    tpos, cpack[..., :dim], cpack[..., 3] * is_far, 0.0)
        if use_local and any_local:
            acc = acc + eval_local(tpos - center[:, None, :], a0, Jp, Hp)
        return acc

    far = jax.lax.map(far_batch, my_cells.reshape(cc // lb, lb))
    acc_win = far.reshape(cc, TWR, dim)

    near_win, of_halo = _near_field_let(
        body_pack, starts, counts, dim=dim, L=L, nshard=nshard, cc=cc,
        cap=cap, my0=my0, me=me, k=k, softening=softening,
        halo_cap=halo_cap, leaf_batch=leaf_batch, axis_name=axis_name)
    acc_win = acc_win + near_win

    acc_loc = _windows_to_local(acc_win, key_s, starts, my0=my0, cc=cc,
                                cap=cap, dim=dim)

    valid = idx_s >= 0
    # Combine across the mesh: a sender-side bucket overflow drops
    # bodies destined for OTHER chips' chunks, so every chip's rows
    # are suspect — all chips must poison, not just the detector.
    overflow = jax.lax.pmax(
        (of_ex | of_halo).astype(jnp.int32), axis_name) > 0
    g = jnp.asarray(G, dtype)
    forces = (g * mass_s)[:, None] * acc_loc
    forces = jnp.where(valid[:, None], forces, 0.0)
    forces = jnp.where(overflow, jnp.asarray(jnp.nan, dtype), forces)
    return forces, idx_s, valid


@functools.partial(
    jax.jit,
    static_argnames=("dim", "L", "nshard", "cc", "cap", "H", "halo_cap",
                     "order", "k", "softening", "G", "axis_name",
                     "leaf_batch"))
def _let_fmm_local(pos_l, mass_l, idx_l, *, dim, L, nshard, cc, cap, H,
                   halo_cap, order, k, softening, G, axis_name, leaf_batch):
    """Per-chip LET black-box FMM (runs under shard_map).

    Far field: P2M over the local chunk (window sums) → ``all_gather`` of
    the leaf Chebyshev weights → replicated M2M / L2L sweeps → M2L rows
    sharded per level (as in ops/fmm.py) → L2P over local bodies only.
    Near field: the shared local+halo-ring P2P. Per-chip body memory stays
    O(N/P); replicated state is the per-level weight tables.
    """
    from ..ops.fmm import (_cheb_T, _interp_1d, _tensor_nodes,
                           _v_list_deltas, centered_m2l_kernel, cheb_nodes,
                           m2m_operators, multilevel_l2p)
    import numpy as np

    dtype = pos_l.dtype
    me = jax.lax.axis_index(axis_name).astype(jnp.int32)
    my0 = me * cc
    n_cheb = order
    nD = n_cheb ** dim
    num_leaves = 1 << (dim * L)

    (pos_s, mass_s, idx_s, key_s, m_loc, lo, hi,
     of_ex) = _exchange(pos_l, mass_l, idx_l, dim=dim, L=L, nshard=nshard,
                        cc=cc, H=H, axis_name=axis_name)
    starts, counts = _chunk_layout(key_s, m_loc, cc=cc, my0=my0)
    body_pack = _pack_bodies(pos_s, mass_s, dim)

    nodes = jnp.asarray(_tensor_nodes(dim, n_cheb), dtype)
    Tt = jnp.asarray(_cheb_T(n_cheb, cheb_nodes(n_cheb)).T, dtype)
    m2m = jnp.asarray(m2m_operators(dim, n_cheb), dtype)
    deltas = _v_list_deltas(dim, k)
    cs_leaf = (hi - lo) / (1 << L)  # [D]
    half_leaf = cs_leaf / 2

    # ---- P2M over my chunk cells (window-based, as ops/fmm.py) ---------
    my_cells = my0 + jnp.arange(cc, dtype=jnp.int32)
    lb = min(leaf_batch, cc)

    def p2m_batch(cells_b):
        rel_b = cells_b - my0
        tb, _, valid = _window_rows_raw(body_pack, starts, counts, cap,
                                        rel_b)
        pos = tb[..., :dim]
        mass = tb[..., 3] * valid
        xy = cell_coords(cells_b.astype(jnp.uint32), dim).astype(dtype)
        centers = lo + (xy + 0.5) * cs_leaf
        y = (pos - centers[:, None, :]) / half_leaf
        y = jnp.where(valid[..., None], y, 0.0)
        basis = None
        for d in range(dim):
            s_d = _interp_1d(n_cheb, y[..., d], Tt)
            basis = s_d if basis is None else (
                basis[..., :, None] * s_d[..., None, :]).reshape(
                    s_d.shape[:-1] + (-1,))
        return jnp.einsum("bc,bcm->bm", mass, basis,
                          precision=jax.lax.Precision.HIGHEST)

    W_loc = jax.lax.map(
        p2m_batch, my_cells.reshape(cc // lb, lb)).reshape(cc, nD)
    W_leaf = jax.lax.all_gather(W_loc, axis_name, tiled=True)  # [M, nD]

    # ---- M2M upward sweep (replicated; small) ---------------------------
    W = {L: W_leaf}
    for l in range(L - 1, 1, -1):
        child = W[l + 1].reshape(-1, 2 ** dim, nD)
        W[l] = jnp.einsum("pon,omn->pm", child, m2m,
                          precision=jax.lax.Precision.HIGHEST)

    # ---- M2L (rows sharded per level, as ops/fmm.py) --------------------
    ndeltas = len(deltas)
    deltas_arr = jnp.asarray(np.stack([d for d, _ in deltas]))
    parity_arr = jnp.asarray(np.stack([p for _, p in deltas]))
    K_leaf = centered_m2l_kernel(deltas_arr, nodes, cs_leaf, dtype)

    Lc = {}
    for l in range(2, L + 1):
        ncells = 1 << (dim * l)
        side = 1 << l
        scale_l = jnp.asarray(2.0 ** -(L - l), dtype)
        cell_ids_l = jnp.arange(ncells, dtype=jnp.uint32)
        sharded_l = ncells >= nshard
        if sharded_l:
            my_cells_l = ncells // nshard
            row_start = me * my_cells_l
            cell_ids_l = jax.lax.dynamic_slice_in_dim(
                cell_ids_l, row_start, my_cells_l)
        xy = cell_coords(cell_ids_l, dim).astype(jnp.int32)
        parity = (xy & 1)
        w_l = W[l]

        def m2l_step(acc_l, idx, xy=xy, parity=parity, w_l=w_l,
                     side=side, scale_l=scale_l, l=l):
            delta = deltas_arr[idx]
            K = K_leaf[idx] * scale_l
            ok = jnp.ones((xy.shape[0],), bool)
            for d in range(dim):
                ok = ok & parity_arr[idx, d][parity[:, d]]
            src_xy = xy + delta[None, :]
            inb = jnp.all((src_xy >= 0) & (src_xy < side), axis=-1)
            ok = ok & inb
            src_ids = morton_key_from_coords(
                jnp.clip(src_xy, 0, side - 1).astype(jnp.uint32), l)\
                .astype(jnp.int32)
            w_src = w_l[src_ids] * ok[:, None]
            return acc_l + jnp.dot(
                w_src, K.T, preferred_element_type=dtype,
                precision=jax.lax.Precision.HIGHEST), None

        acc0 = jnp.zeros((xy.shape[0], nD), dtype)
        if sharded_l:
            acc0 = jax.lax.pcast(acc0, axis_name, to="varying")
        acc_l, _ = jax.lax.scan(
            m2l_step, acc0, jnp.arange(ndeltas, dtype=jnp.int32))
        if sharded_l:
            acc_l = jax.lax.all_gather(acc_l, axis_name, tiled=True)
        Lc[l] = acc_l

    # ---- L2P over LOCAL bodies only, every level (ops/fmm.py) -----------
    ph = pos_s.shape[0]
    key_c = jnp.clip(key_s, 0, num_leaves - 1)
    bxy = cell_coords(key_c.astype(jnp.uint32), dim).astype(dtype)
    centers_body = lo + (bxy + 0.5) * cs_leaf
    valid = idx_s >= 0
    # Invalid rows sit at their clipped leaf's center: finite basis values.
    pos_eff = jnp.where(valid[:, None], pos_s, centers_body)

    blk = min(8192, ph)
    nb_l2p = -(-ph // blk)
    padl = nb_l2p * blk - ph

    def padz(x):
        if padl == 0:
            return x
        return jnp.concatenate(
            [x, jnp.broadcast_to(x[:1], (padl,) + x.shape[1:])])

    pos_b = padz(pos_eff).reshape(nb_l2p, blk, dim)
    key_b = padz(key_c).reshape(nb_l2p, blk)

    def l2p_block(args):
        pos, key = args
        return multilevel_l2p(Lc, L, key, pos, lo, cs_leaf, n_cheb, Tt)

    acc_far_loc = jax.lax.map(
        l2p_block, (pos_b, key_b)).reshape(-1, dim)[:ph]

    # ---- Near field (shared local + halo ring) ---------------------------
    near_win, of_halo = _near_field_let(
        body_pack, starts, counts, dim=dim, L=L, nshard=nshard, cc=cc,
        cap=cap, my0=my0, me=me, k=k, softening=softening,
        halo_cap=halo_cap, leaf_batch=leaf_batch, axis_name=axis_name)
    acc_near_loc = _windows_to_local(near_win, key_s, starts, my0=my0,
                                     cc=cc, cap=cap, dim=dim)

    # Combine across the mesh: a sender-side bucket overflow drops
    # bodies destined for OTHER chips' chunks, so every chip's rows
    # are suspect — all chips must poison, not just the detector.
    overflow = jax.lax.pmax(
        (of_ex | of_halo).astype(jnp.int32), axis_name) > 0
    g = jnp.asarray(G, dtype)
    forces = (g * mass_s)[:, None] * (acc_far_loc + acc_near_loc)
    forces = jnp.where(valid[:, None], forces, 0.0)
    forces = jnp.where(overflow, jnp.asarray(jnp.nan, dtype), forces)
    return forces, idx_s, valid


def let_barnes_hut(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    axis_name: str = BODY_AXIS,
    theta: Optional[float] = None,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    bucket_headroom: Optional[float] = None,
    halo_cap: Optional[int] = None,
    leaf_batch: int = 512,
    multipole: str = "quad",
    far_impl: str = "local",
) -> jax.Array:
    """Barnes-Hut forces [N, D] with body-sharded LET distribution.

    Per-chip body memory is O(headroom·N/P); the replicated state is only
    the per-level cell summaries (4 floats/cell, plus the packed second
    moments under the default ``multipole="quad"`` far field — see
    :func:`~nbody_jax.ops.grid_tree.barnes_hut_grid`). Capacity overflows
    poison the result with NaN (see module docstring) — raise
    ``bucket_headroom`` or ``halo_cap`` for clustered inputs.
    """
    theta = config.theta if theta is None else theta
    return _let_launch(
        functools.partial(_let_bh_local, multipole=multipole,
                          far_impl=far_impl),
        positions, masses, config, mesh, axis_name,
        theta_to_ring(theta), leaf_level, capacity, bucket_headroom,
        halo_cap, leaf_batch)


def let_fmm(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    mesh: Optional[Mesh] = None,
    axis_name: str = BODY_AXIS,
    order: int = 5,
    ring: int = 1,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    bucket_headroom: Optional[float] = None,
    halo_cap: Optional[int] = None,
    leaf_batch: int = 512,
) -> jax.Array:
    """Black-box FMM forces [N, D] with body-sharded LET distribution.

    The BASELINE.json "FMM p=8 full pipeline sharded" shape with true
    O(N/P) per-device body memory (see module docstring)."""
    return _let_launch(
        functools.partial(_let_fmm_local, order=order), positions, masses,
        config, mesh, axis_name, ring, leaf_level, capacity,
        bucket_headroom, halo_cap, leaf_batch)


def _let_launch(local_fn, positions, masses, config, mesh, axis_name, k,
                leaf_level, capacity, bucket_headroom, halo_cap,
                leaf_batch):
    """Shared LET scaffold: capacities, padding, shard_map, materialize."""
    if mesh is None:
        mesh = make_mesh(axis_name=axis_name)
    nshard = mesh.shape[axis_name]
    n, dim = positions.shape
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim, k=k)
    while (1 << (dim * leaf_level)) < nshard:
        leaf_level += 1
    num_leaves = 1 << (dim * leaf_level)
    cc = num_leaves // nshard
    if capacity is None:
        capacity = compute_capacity_cached(positions, leaf_level)
        check_grid_capacity(capacity, n, leaf_level, dim, "let_tree")
    n_pad = pad_to_multiple(n, nshard * 8)
    # Per-(src,dst) exchange bucket: exact data probe by default (one
    # memoized device sync); an explicit bucket_headroom keeps the old
    # N/P² heuristic semantics.
    if bucket_headroom is None:
        H = pad_to_multiple(max(8, exchange_bucket_peak_cached(
            positions, leaf_level, nshard, n_pad // nshard)), 8)
    else:
        H = pad_to_multiple(
            max(8, math.ceil(bucket_headroom * n / nshard ** 2)), 8)
    if halo_cap is None:
        # Exact geometric peak (input-independent; see halo_cap_exact).
        halo_cap = min((2 * k + 1) ** dim * cc, pad_to_multiple(
            max(8, halo_cap_exact(dim, leaf_level, cc, k)), 8))

    pad = n_pad - n
    if pad:
        positions = jnp.concatenate(
            [positions, jnp.full((pad, dim), 2.0e9, positions.dtype)])
        masses = jnp.concatenate([masses, jnp.zeros((pad,), masses.dtype)])
    idx = jnp.concatenate([jnp.arange(n, dtype=jnp.int32),
                           jnp.full((pad,), -1, jnp.int32)])
    # Padding bodies at 2e9 quantize into the far corner cell — harmless
    # (zero mass) but they must not be shipped: marked idx=-1, the exchange
    # buckets them out.

    fn = functools.partial(
        local_fn, dim=dim, L=leaf_level, nshard=nshard, cc=cc,
        cap=capacity, H=H, halo_cap=halo_cap, k=k,
        softening=float(config.softening), G=float(config.G),
        axis_name=axis_name, leaf_batch=leaf_batch)

    sharded = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name), P(axis_name)),
        out_specs=(P(axis_name, None), P(axis_name), P(axis_name)))

    positions = jax.device_put(
        positions, NamedSharding(mesh, P(axis_name, None)))
    masses = jax.device_put(masses, NamedSharding(mesh, P(axis_name)))
    idx = jax.device_put(idx, NamedSharding(mesh, P(axis_name)))
    forces, idx_out, valid = jax.jit(sharded)(positions, masses, idx)

    # Convenience materialization back to input order (tests / small N;
    # production callers keep the sharded (forces, idx) pair).
    out = jnp.zeros((n, dim), forces.dtype)
    out = out.at[jnp.where(valid, idx_out, n)].add(
        forces * valid[:, None], mode="drop")
    return out
