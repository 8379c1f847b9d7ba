"""Device-resident hierarchical grid tree — shared by Barnes-Hut and FMM.

Array-program replacement for the reference's pointer-chasing octree
(``octree.cpp:39-94``: incremental insert, leaf splitting, recursive COM
update) and its per-body recursive MAC walk (``octree.cpp:97-162``). Instead
of pointers and recursion, the tree is a *level-synchronous uniform grid*
over Morton keys:

* **Build**: quantize → Morton keys → ``argsort`` → per-level dense cell
  arrays (mass, center-of-mass) via ``segment_sum``. Everything is a fixed-
  shape array program; the serial-insertion bottleneck the reference notes
  (README.md:36) does not exist.
* **Far field**: at every level each cell interacts with its *interaction
  ring* — children of the parent's near-neighbors that are not the cell's own
  near-neighbors (the classical FMM V-list). With ring radius ``k`` the
  minimum center separation is (k+1) cell widths, i.e. an effective opening
  angle θ = 1/(k+1) (θ=0.5 ↔ k=1, the BASELINE.json configuration; the
  reference's acceptance test ``2·hs/d < θ`` at ``octree.cpp:146`` is the
  same geometry). The V-lists telescope over levels, so every body pair is
  covered exactly once: by the COM approximation at the unique level where
  its ancestors first separate, or by the near field at the leaves.
* **Near field**: leaf cells interact pairwise with their (2k+1)^D neighbor
  cells (P2P), with the brute-force self-pair guard. Slot-free: every leaf
  is a contiguous run of Morton-sorted bodies fetched as 8-body packed
  superrows (row gathers cost per row more than per byte), and results
  return to sorted order by a pure gather via ``window_slot`` (gathers
  were measured faster than scatters on the previous accelerator; to be
  re-measured on the GPU).

Barnes-Hut = this structure with monopole-at-COM far-field evaluation
(dipole term vanishes at the COM, as in ``octree.cpp:146-151``); FMM reuses
the same build and lists with order-p expansions (ops/fmm*.py).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import weakref
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_GRAVITY, GravityConfig
from .brute_force import _DIST2_GUARD
from .keys import morton_key_from_coords, quantize


def _compact2(x):
    """Inverse of keys._spread2: extract even bits of a uint32."""
    x = x & jnp.uint32(0x55555555)
    x = (x | (x >> 1)) & jnp.uint32(0x33333333)
    x = (x | (x >> 2)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x >> 4)) & jnp.uint32(0x00FF00FF)
    x = (x | (x >> 8)) & jnp.uint32(0x0000FFFF)
    return x


def _compact3(x):
    """Inverse of keys._spread3: extract every third bit of a uint32."""
    x = x & jnp.uint32(0x09249249)
    x = (x | (x >> 2)) & jnp.uint32(0x030C30C3)
    x = (x | (x >> 4)) & jnp.uint32(0x0300F00F)
    x = (x | (x >> 8)) & jnp.uint32(0x030000FF)
    x = (x | (x >> 16)) & jnp.uint32(0x000003FF)
    return x


def cell_coords(cell_ids: jax.Array, dim: int) -> jax.Array:
    """Morton cell id [M] → integer grid coords [M, dim]."""
    if dim == 2:
        return jnp.stack([_compact2(cell_ids >> 1), _compact2(cell_ids)],
                         axis=-1)
    return jnp.stack([_compact3(cell_ids >> 2), _compact3(cell_ids >> 1),
                      _compact3(cell_ids)], axis=-1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridTree:
    """Flattened hierarchical grid (a pytree; static config in aux fields)."""

    # Static configuration.
    dim: int = dataclasses.field(metadata=dict(static=True))
    leaf_level: int = dataclasses.field(metadata=dict(static=True))
    capacity: int = dataclasses.field(metadata=dict(static=True))

    # Geometry.
    lo: jax.Array  # [D] domain lower corner
    cell_sizes: jax.Array  # [L+1, D] physical cell size per level

    # Sorted body data (Morton order).
    order: jax.Array  # [N] original index of sorted slot
    leaf_ids: jax.Array  # [N] leaf cell id per sorted body
    pos_sorted: jax.Array  # [N, D]
    mass_sorted: jax.Array  # [N]

    # Per-level dense cell aggregates, index 0 = root level (1 cell).
    level_mass: Tuple[jax.Array, ...]  # [(2^(D*l),)]
    level_com: Tuple[jax.Array, ...]  # [(2^(D*l), D)]

    # Contiguous-run layout (bodies are Morton-sorted, so every leaf cell is
    # one contiguous run of sorted bodies): run start / length per dense
    # leaf cell. The slot-free near field (P2P) is built on these.
    cell_start: jax.Array  # [num_leaf_cells] first sorted-body index
    cell_count: jax.Array  # [num_leaf_cells] bodies in the cell

    # Superrow-packed bodies: row r holds the (pos|0, mass) 4-vectors of
    # sorted bodies [8r, 8r+8). Row gathers cost per ROW more than per
    # byte, so fetching a leaf's contiguous run as ceil(C/8)+1 superrows
    # instead of C per-slot rows cuts the near-field gather count ~8×.
    body_pack: jax.Array  # [ceil(N/8), 32]

    # Position of sorted body i within its leaf's target window
    # (_window_rows layout): window-result → sorted-order conversion is a
    # GATHER out[i] = acc_window[leaf_ids[i]·TWR + window_slot[i]] instead
    # of a scatter-add.
    window_slot: jax.Array  # [N]

    # Per-level packed cell aggregates [com|0, mass] for one-gather far
    # fields (same row-cost argument).
    level_pack: Tuple[jax.Array, ...]  # [(2^(D*l), 4)]

    # Per-level COM-centered second moments Σ m·(x−com)(x−com)ᵀ, packed as
    # _quad_pairs(dim) components — () unless built with ``quad=True``.
    # Centered (not raw-about-origin) because raw second moments at the
    # reference's ~1e7 coordinate scale cancel catastrophically in fp32;
    # translation up the hierarchy uses the parallel-axis identity
    # S_p = Σ_c [S_c + m_c·(com_c−com_p)(com_c−com_p)ᵀ].
    level_quad: Tuple[jax.Array, ...] = ()  # [(2^(D*l), nq)]

    @property
    def n(self) -> int:
        return self.pos_sorted.shape[0]

    @property
    def num_leaf_cells(self) -> int:
        return 1 << (self.dim * self.leaf_level)


def auto_leaf_level(n: int, dim: int, target_occupancy: Optional[int] = None,
                    max_level: Optional[int] = None, k: int = 1) -> int:
    """Leaf depth so cells average ~target_occupancy bodies (static choice).

    Default occupancy is dimension-tuned (64 in 2D, 32 in 3D; chosen on
    the previous accelerator, to be re-tuned on the GPU — ROADMAP).
    Fuller leaves shrink the capacity/mean-occupancy padding ratio (the
    near-field tensors scale with capacity², not occupancy²).

    ``k`` is the near-ring radius: the near field touches (2k+1)^D windows
    per leaf, so wider rings (θ=0.25 → k=3) want emptier leaves — occupancy
    is scaled by (3/(2k+1))^D to hold near-field pair work roughly constant
    (at k=3 in 3D the unscaled default put ~200 bodies/leaf and the
    [B, 343, TWR, 4] near tensor hit 23 GB at compile time).
    """
    import math
    if target_occupancy is None:
        target_occupancy = 64 if dim == 2 else 32
        if k > 1:
            target_occupancy = max(
                8, int(target_occupancy * (3.0 / (2 * k + 1)) ** dim))
    # floor, not ceil: the window layout favors fuller leaves, so land in
    # [target, target·2^D) rather than (target/2^D, target].
    level = max(1, math.floor(math.log2(max(n, 2) / target_occupancy) / dim))
    cap = {2: 13, 3: 8}[dim]  # ≤ 2^26 / 2^24 dense leaf cells
    if max_level is not None:
        cap = min(cap, max_level)
    return min(level, cap)


def compute_capacity(positions, leaf_level: int) -> int:
    """Max leaf occupancy (concrete; forces one device sync per (N, L))."""
    n, dim = positions.shape
    q = quantize(positions, leaf_level)
    ids = morton_key_from_coords(q, leaf_level).astype(jnp.int32)
    counts = jnp.zeros((1 << (dim * leaf_level),), jnp.int32).at[ids].add(1)
    cmax = int(jnp.max(counts))
    return max(8, int(-(-cmax // 8) * 8))  # round up to multiple of 8


# The capacity probe is a device sync, and benchmark / smoke harnesses call
# the drivers repeatedly on the SAME positions array.
# jax.Arrays are immutable, so identity ⟹ identical data and an id-keyed
# memo guarded by a weakref (ids are reused after collection) is exact,
# not a heuristic. Bounded; dead entries are swept when full.
_CAPACITY_MEMO: dict = {}
_CAPACITY_MEMO_MAX = 128


def compute_capacity_cached(positions, leaf_level: int) -> int:
    key = (id(positions), leaf_level)
    hit = _CAPACITY_MEMO.get(key)
    if hit is not None and hit[0]() is positions:
        return hit[1]
    cap = compute_capacity(positions, leaf_level)
    if len(_CAPACITY_MEMO) >= _CAPACITY_MEMO_MAX:
        dead = [k for k, v in _CAPACITY_MEMO.items() if v[0]() is None]
        for k in dead:
            del _CAPACITY_MEMO[k]
        if len(_CAPACITY_MEMO) >= _CAPACITY_MEMO_MAX:
            _CAPACITY_MEMO.clear()
    _CAPACITY_MEMO[key] = (weakref.ref(positions), cap)
    return cap


# Above this leaf capacity the uniform grid has degenerated (a Plummer-core
# style density peak): near-field pair work scales with capacity², so e.g.
# Plummer N=1e5 3D lands capacity ~64k ⇒ a ~40 TB near tensor. Guarded at
# the driver level — the adaptive radix BVH tier handles such inputs in
# O(N) memory (and auto-escalates its traversal capacities).
CLUSTERED_CAPACITY_LIMIT = 4096


def dense_layout_degenerate(capacity: int, n: int, leaf_level: int,
                            dim: int) -> bool:
    """True when the capacity-padded dense layout should not be used.

    Two triggers: the absolute capacity guard (a ~40 TB near tensor at
    Plummer N=1e5 3D), and occupancy *skew* — max/mean leaf occupancy so
    high that the padded near field does ≳256× the real pair work. The
    skew trigger exists because the absolute limit alone missed a small-N
    clustered input (N=4000 2D, 60% of bodies in one cell: capacity 2408
    ≤ 4096 but mean occupancy 15.6 at leaf level 4 ⇒ a 595 GB dense near
    tensor on the CPU backend). Uniform inputs have max/mean ≲ 5 at any
    N, so the 16× threshold never fires on them.
    """
    mean_occ = n / float(1 << (dim * leaf_level))
    return capacity > CLUSTERED_CAPACITY_LIMIT or (
        capacity > 512 and capacity > 16 * mean_occ)


def check_grid_capacity(capacity: int, n: int, leaf_level: int, dim: int,
                        what: str, limit: Optional[int] = None) -> None:
    """Refuse (loudly, with guidance) to run a degenerate uniform grid."""
    limit = CLUSTERED_CAPACITY_LIMIT if limit is None else limit
    if capacity > limit:
        ncells = 1 << (dim * leaf_level)
        raise ValueError(
            f"{what}: the densest leaf cell holds {capacity} of {n} bodies "
            f"(leaf level {leaf_level}, {ncells} cells, mean occupancy "
            f"{n / ncells:.1f}) — this input is too clustered for the "
            f"uniform grid tree, whose near-field work scales with the max "
            f"leaf occupancy squared. Use bvh_forces (adaptive Hilbert-"
            f"radix BVH, O(N) memory on any distribution) for strongly "
            f"clustered inputs, or pass leaf_level/capacity explicitly to "
            f"override this guard.")


def _quad_pairs(dim: int):
    """Packed index pairs of the symmetric second-moment tensor."""
    return ([(0, 0), (1, 1), (0, 1)] if dim == 2
            else [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)])


def leaf_window_sums(body_pack, starts, ends, *, capacity, ncells, dim,
                     quad=False):
    """Per-cell mass / mass-weighted-position (and, with ``quad``, the
    COM-centered second moments) from superrow windows over Morton-sorted
    packed bodies. Shared by the single-chip build and the LET per-chunk
    aggregation (parallel/let_tree.py) so the masked-window math has one
    home. Returns (m [C], mx [C, D], S [C, nq] | None)."""
    TW = capacity // 8 + 1
    nsr = body_pack.shape[0]
    sr_raw = (starts // 8)[:, None] + jnp.arange(TW, dtype=jnp.int32)
    rows = body_pack[jnp.clip(sr_raw, 0, nsr - 1)]  # [C, TW, 32]
    wbodies = rows.reshape(ncells, TW * 8, 4)
    gidx = (sr_raw[..., None] * 8 + jnp.arange(8, dtype=jnp.int32))\
        .reshape(ncells, TW * 8)
    wvalid = (gidx >= starts[:, None]) & (gidx < ends[:, None])
    wmass = wbodies[..., 3] * wvalid
    m = jnp.sum(wmass, axis=1)
    mx = jnp.sum(wmass[..., None] * wbodies[..., :dim], axis=1)
    S = None
    if quad:
        # Centered at the cell COM: see the GridTree.level_quad docstring.
        com = mx / jnp.maximum(m, 1e-30)[:, None]
        dxw = wbodies[..., :dim] - com[:, None, :]
        S = jnp.stack([jnp.sum(wmass * dxw[..., a] * dxw[..., b], axis=1)
                       for a, b in _quad_pairs(dim)], axis=-1)  # [C, nq]
    return m, mx, S


def reduce_levels(m_l, mx_l, S_l, *, dim, L, dtype):
    """Bottom-up 2^D-child tree reduction of leaf (mass, m·x[, second
    moments]) into per-level (mass, COM, [com|mass] pack, quad) tables.
    Quadrupole translation uses the parallel-axis identity
    S_p = Σ_c [S_c + m_c·(com_c−com_p)(com_c−com_p)ᵀ]. Shared by
    build_grid_tree and the LET replicated-summary build."""
    qpairs = _quad_pairs(dim)
    level_mass: List[jax.Array] = []
    level_com: List[jax.Array] = []
    level_pack: List[jax.Array] = []
    level_quad: List[jax.Array] = []
    for l in range(L, -1, -1):
        com_l = mx_l / jnp.maximum(m_l, 1e-30)[:, None]
        pack_l = jnp.zeros((m_l.shape[0], 4), dtype)
        pack_l = pack_l.at[:, :dim].set(com_l).at[:, 3].set(m_l)
        level_mass.append(m_l)
        level_com.append(com_l)
        level_pack.append(pack_l)
        if S_l is not None:
            level_quad.append(S_l)
        if l > 0:
            m_p = jnp.sum(m_l.reshape(-1, 1 << dim), axis=1)
            mx_p = jnp.sum(mx_l.reshape(-1, 1 << dim, dim), axis=1)
            if S_l is not None:
                com_p = mx_p / jnp.maximum(m_p, 1e-30)[:, None]
                d = com_l.reshape(-1, 1 << dim, dim) - com_p[:, None, :]
                mc = m_l.reshape(-1, 1 << dim)
                S_l = jnp.sum(
                    S_l.reshape(-1, 1 << dim, len(qpairs))
                    + mc[..., None] * jnp.stack(
                        [d[..., a] * d[..., b] for a, b in qpairs], axis=-1),
                    axis=1)
            m_l, mx_l = m_p, mx_p
    level_mass.reverse()
    level_com.reverse()
    level_pack.reverse()
    level_quad.reverse()
    return level_mass, level_com, level_pack, level_quad


def chunk_table(starts, counts, *, chunk: int, num_chunks: int):
    """Cell-aligned fixed-size chunks of the sorted body runs.

    Bodies are Morton-sorted, so every cell is one contiguous run; each run
    is split into ⌈count/chunk⌉ chunks of ≤ ``chunk`` bodies that never
    straddle a cell boundary (all bodies of a chunk share one cell, hence
    one near ring and one ancestor chain). ``num_chunks`` is the static row
    budget (Σ ⌈count_i/chunk⌉, measured by :func:`sparse_grid_stats`); rows
    past the true total have length 0.

    Returns (cell [NT], cstart [NT], clen [NT], coffs [ncells+1]) with
    ``coffs`` the exclusive prefix sum of per-cell chunk counts (chunk rows
    of cell c are coffs[c] .. coffs[c+1]).
    """
    ncells = counts.shape[0]
    nchunk = -(-counts // chunk)
    coffs = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.cumsum(nchunk, dtype=jnp.int32)])
    r = jnp.arange(num_chunks, dtype=jnp.int32)
    cell = jnp.clip(
        jnp.searchsorted(coffs, r, side="right").astype(jnp.int32) - 1,
        0, ncells - 1)
    within = r - coffs[cell]
    cstart = starts[cell] + within * chunk
    clen = jnp.clip(counts[cell] - within * chunk, 0, chunk)
    clen = jnp.where(r < coffs[-1], clen, 0)
    return cell, cstart, clen, coffs


def _leaf_chunk_sums(body_rows, starts, counts, *, num_chunks, chunk,
                     ncells, dim, quad):
    """Capacity-free leaf aggregates: masked per-chunk partial sums
    scatter-added into the dense cell arrays.

    O(N + NT) memory regardless of clustering — the windowed path
    (:func:`leaf_window_sums`) materializes [ncells, capacity]-shaped
    tensors, which degenerate when one dense cell holds ~N bodies.
    Same math as the windowed path (quad moments centered at the leaf
    COM), different partitioning of the sums.
    """
    cell, cstart, clen, _ = chunk_table(
        starts, counts, chunk=chunk, num_chunks=num_chunks)
    idx = cstart[:, None] + jnp.arange(chunk, dtype=jnp.int32)
    valid = jnp.arange(chunk, dtype=jnp.int32) < clen[:, None]
    rows = body_rows[jnp.clip(idx, 0, body_rows.shape[0] - 1)]  # [NT, c, 4]
    w = rows[..., 3] * valid
    m = jnp.zeros((ncells,), body_rows.dtype).at[cell].add(jnp.sum(w, 1))
    mx = jnp.zeros((ncells, dim), body_rows.dtype).at[cell].add(
        jnp.sum(w[..., None] * rows[..., :dim], axis=1))
    S = None
    if quad:
        com = mx / jnp.maximum(m, 1e-30)[:, None]
        d = rows[..., :dim] - com[cell][:, None, :]
        S = jnp.zeros((ncells, len(_quad_pairs(dim))), body_rows.dtype)\
            .at[cell].add(jnp.stack(
                [jnp.sum(w * d[..., a] * d[..., b], axis=1)
                 for a, b in _quad_pairs(dim)], axis=-1))
    return m, mx, S


@functools.partial(jax.jit,
                   static_argnames=("leaf_level", "capacity", "quad",
                                    "agg_num_chunks", "agg_chunk_size"))
def build_grid_tree(positions: jax.Array, masses: jax.Array,
                    leaf_level: int, capacity: int,
                    quad: bool = False,
                    agg_num_chunks: Optional[int] = None,
                    agg_chunk_size: int = 64) -> GridTree:
    """Level-synchronous device build (replaces octree.cpp:165-204 + insert).

    ``quad=True`` additionally builds per-level second moments for the
    quadrupole far field (Barnes-Hut accuracy tier); FMM and monopole BH
    skip the extra build passes.

    ``agg_num_chunks`` switches the leaf aggregation from capacity-padded
    windows to cell-aligned fixed-size chunks (:func:`_leaf_chunk_sums`) —
    the sparse / clustered-input path, where the max leaf occupancy (and
    hence ``capacity``) is unbounded. The stored ``capacity`` is then only
    metadata for :func:`_window_rows` consumers, which the sparse
    evaluation never calls.
    """
    n, dim = positions.shape
    L = leaf_level

    # Domain bounds with the reference's 1% padding (octree.cpp:170-188).
    mins = jnp.min(positions, axis=0)
    maxs = jnp.max(positions, axis=0)
    center = 0.5 * (mins + maxs)
    half = 0.5 * (maxs - mins) * 1.01 + 1e-30
    lo, hi = center - half, center + half

    q = quantize(positions, L, lo=lo, hi=hi)
    keys = morton_key_from_coords(q, L)
    order = jnp.argsort(keys)
    keys_s = keys[order]
    pos_s = positions[order]
    mass_s = masses[order]
    leaf_ids = keys_s.astype(jnp.int32)

    cell_sizes = jnp.stack(
        [(hi - lo) / (1 << l) for l in range(L + 1)], axis=0)

    # Leaf runs without scatters: bodies are sorted by leaf id, so run
    # starts come from searchsorted.
    num_leaf_cells = 1 << (dim * L)
    all_cells = jnp.arange(num_leaf_cells, dtype=leaf_ids.dtype)
    starts = jnp.searchsorted(leaf_ids, all_cells).astype(jnp.int32)
    ends = jnp.concatenate([starts[1:], jnp.full((1,), n, jnp.int32)])
    counts = ends - starts

    # Superrow packing (see field docstring).
    np8 = -(-n // 8) * 8
    bt = jnp.zeros((np8, 4), pos_s.dtype)
    bt = bt.at[:n, :dim].set(pos_s)
    bt = bt.at[:n, 3].set(mass_s)
    body_pack = bt.reshape(np8 // 8, 32)

    # Leaf aggregates via masked window sums (local, no cancellation; the
    # global-cumsum alternative loses ~ε·Σm of absolute precision), then
    # coarser levels by exact 2^D-child tree reduction — Morton ids make
    # children of one parent contiguous.
    if agg_num_chunks is not None:
        m_leaf, mx_leaf, S_leaf = _leaf_chunk_sums(
            bt, starts, ends - starts, num_chunks=agg_num_chunks,
            chunk=agg_chunk_size, ncells=num_leaf_cells, dim=dim,
            quad=quad)
    else:
        m_leaf, mx_leaf, S_leaf = leaf_window_sums(
            body_pack, starts, ends, capacity=capacity,
            ncells=num_leaf_cells, dim=dim, quad=quad)
    level_mass, level_com, level_pack, level_quad = reduce_levels(
        m_leaf, mx_leaf, S_leaf, dim=dim, L=L, dtype=pos_s.dtype)

    # Window slot of each sorted body: its leaf's window starts at the
    # superrow boundary below cell_start.
    body_start = starts[leaf_ids]  # [N]
    window_slot = (jnp.arange(n, dtype=jnp.int32)
                   - (body_start // 8) * 8)

    return GridTree(
        dim=dim, leaf_level=L, capacity=capacity,
        lo=lo, cell_sizes=cell_sizes,
        order=order, leaf_ids=leaf_ids,
        pos_sorted=pos_s, mass_sorted=mass_s,
        level_mass=tuple(level_mass), level_com=tuple(level_com),
        cell_start=starts, cell_count=counts,
        body_pack=body_pack, level_pack=tuple(level_pack),
        window_slot=window_slot,
        level_quad=tuple(level_quad),
    )


def _ring_offsets(dim: int, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static offset tables.

    Returns:
      child_offsets: [(2k+1)^D * 2^D, D] — candidate child-cell offsets
        relative to 2*parent_coords, i.e. every child of every near-parent.
      near_mask_radius: k (candidates with Chebyshev distance ≤ k from the
        cell are near-neighbors → excluded from the V-list).
    """
    parent_offs = np.array(
        list(itertools.product(range(-k, k + 1), repeat=dim)), np.int32)
    child_offs = np.array(
        list(itertools.product((0, 1), repeat=dim)), np.int32)
    cands = (parent_offs[:, None, :] * 2 + child_offs[None, :, :])
    return cands.reshape(-1, dim), k


def _neighbor_offsets(dim: int, k: int) -> np.ndarray:
    return np.array(list(itertools.product(range(-k, k + 1), repeat=dim)),
                    np.int32)


@functools.lru_cache(maxsize=None)
def _parent_window(dim: int, k: int):
    """Static tables for the parent-shared near field.

    The (2k+1)^D near windows of the 2^D sibling leaves all lie inside one
    (2k+2)^D window around their parent, so the source rows can be gathered
    ONCE PER PARENT (5.4× fewer row gathers at k=3 in 3D) and each sibling
    P2P pass just pre-zeroes the masses of cells outside its own ring — a
    static per-parity cell mask, zero per-pair cost, at (2k+2)^D/(2k+1)^D ≈
    1.5× the pair slots (on the previous accelerator the gathers, not the
    pair arithmetic, dominated the near field; to be re-measured on the
    GPU).

    Returns (offsets [(2k+2)^D, D] relative to 2·parent_coords,
             masks [2^D, (2k+2)^D] float32 — cell usable by child parity).
    """
    offs = np.array(list(itertools.product(range(-k, k + 2), repeat=dim)),
                    np.int32)
    masks = np.zeros((1 << dim, len(offs)), np.float32)
    for pm in range(1 << dim):
        par = np.array([(pm >> (dim - 1 - d)) & 1 for d in range(dim)],
                       np.int32)
        cheb = np.abs(offs - par).max(axis=1)
        masks[pm] = (cheb <= k).astype(np.float32)
    return offs, masks


@functools.lru_cache(maxsize=None)
def _leaf_shell_subset(dim: int, k: int, c_gate: int):
    """Static per-parity candidate subsets for the leaf-level far split.

    The leaf-level V-list candidates (children of the parent's near ring,
    :func:`_ring_offsets`) sit at offsets ``off − par`` from the leaf,
    where ``par ∈ {0,1}^D`` is the leaf's child parity — so which
    candidates fall in the inner far shells (Chebyshev distance in
    (k, c_gate]) is a pure function of parity. Returns
    ``(idx [2^D, m], valid [2^D, m])``: for each parity class, the indices
    into the candidate axis whose shell must stay per-body (padded to the
    max class size m with masked-out zeros). Parity bit d is coordinate
    d's LSB.
    """
    cands, _ = _ring_offsets(dim, k)
    sels = []
    for pbits in range(1 << dim):
        par = np.array([(pbits >> d) & 1 for d in range(dim)], np.int32)
        cheb = np.abs(cands - par).max(axis=1)
        sels.append(np.where((cheb > k) & (cheb <= c_gate))[0])
    m = max(len(s) for s in sels)
    idx = np.zeros((1 << dim, m), np.int32)
    valid = np.zeros((1 << dim, m), bool)
    for p, s in enumerate(sels):
        idx[p, :len(s)] = s
        valid[p, :len(s)] = True
    return idx, valid


def _window_rows_raw(body_pack, cell_start, cell_count, capacity,
                     cell_ids: jax.Array):
    """Gather each cell's contiguous body run as packed superrows.

    The slot-free near field (ROADMAP round-1 item 2): bodies are Morton-
    sorted, so a leaf cell is one contiguous run [start, start+count); the
    run is fetched as ceil(C/8)+1 rows of ``body_pack`` (8 bodies each)
    instead of C per-slot row gathers — about 8× fewer rows than the
    round-1 ``slot_index`` layout where gathers cost per row rather than
    per byte, and no slot bookkeeping at all.

    cell_ids: [...] dense leaf ids (relative to the start/count arrays).
    Returns (bodies [..., TW*8, 4] packed (pos|0, mass), gidx [..., TW*8]
    sorted-body index into 8·body_pack rows, valid mask).
    """
    TW = capacity // 8 + 1
    start = cell_start[cell_ids]
    count = cell_count[cell_ids]
    nsr = body_pack.shape[0]
    sr_raw = (start // 8)[..., None] + jnp.arange(TW, dtype=jnp.int32)
    sr = jnp.clip(sr_raw, 0, nsr - 1)
    rows = body_pack[sr]  # [..., TW, 32]
    bodies = rows.reshape(rows.shape[:-2] + (TW * 8, 4))
    gidx = (sr_raw[..., None] * 8
            + jnp.arange(8, dtype=jnp.int32)).reshape(sr_raw.shape[:-1]
                                                      + (TW * 8,))
    # (sr_raw >= nsr rows clip to the last superrow, but their gidx >= n >=
    # start+count keeps them masked.)
    valid = (gidx >= start[..., None]) & (gidx < (start + count)[..., None])
    return bodies, gidx, valid


def _window_rows(tree: GridTree, cell_ids: jax.Array):
    """Tree-level convenience wrapper over :func:`_window_rows_raw`."""
    return _window_rows_raw(tree.body_pack, tree.cell_start,
                            tree.cell_count, tree.capacity, cell_ids)


def _point_mass_accel(targets, src_pos, src_mass, softening):
    """Σ_s m_s (x_s − x_t)/(r²+ε²)^{3/2} with the coincident-pair guard.

    targets [B, C, D]; src_pos [B, S, D]; src_mass [B, S] → [B, C, D].
    """
    dim = targets.shape[-1]
    diffs = []
    d2 = None
    for d in range(dim):
        diff = src_pos[:, None, :, d] - targets[:, :, None, d]  # [B, C, S]
        diffs.append(diff)
        d2 = diff * diff if d2 is None else d2 + diff * diff
    soft2 = jnp.asarray(softening, d2.dtype) ** 2
    inv_r = jax.lax.rsqrt(d2 + soft2)
    w = src_mass[:, None, :] * (inv_r * inv_r * inv_r)
    w = jnp.where(d2 < _DIST2_GUARD, 0.0, w)
    return jnp.stack(
        [jnp.sum(w * diffs[d], axis=-1) for d in range(dim)], axis=-1)


def _quad_cell_accel(targets, com, mass, S):
    """Monopole + quadrupole cell → body acceleration.

    With R = com − x_t, r = |R|, M the cell mass and S the COM-centered
    second moment Σ m (x−com)(x−com)ᵀ (dipole vanishes at the COM):

        a = M·R/r³ − 3·S·R/r⁵ − (3/2)·tr(S)·R/r⁵ + (15/2)·(RᵀSR)·R/r⁷

    (Taylor expansion of Σ m_s (x_s−x_t)/|x_s−x_t|³ to second order; the
    r⁻² force law is 3D-like even for 2D coordinates, where z ≡ 0 makes the
    restriction to the packed 2D components exact. Validated against a
    direct sum: monopole relerr 1.0e-3 → quadrupole 4.1e-5 on a unit test
    geometry.) Masked cells must arrive with mass == 0 AND S == 0.

    Evaluated in *normalized* form — n = R/r (O(1)), Ŝ = S/r² (mass scale):

        a = [ (M + (15/2)·nᵀŜn − (3/2)·tr Ŝ)·n − 3·Ŝn ] · u²

    because the naive r⁻⁵/r⁻⁷ powers leave fp32 range at the reference's
    coordinate scale (r ~ 1e7 ⇒ u⁷ ~ 1e-49 flushes to zero, RᵀSR ~ 1e38
    nearly overflows) — measured as quadrupole *hurting* accuracy until
    this rewrite.

    targets [B, C, D]; com [B, K, D]; mass [B, K]; S [B, K, nq] → [B, C, D].
    """
    dim = targets.shape[-1]
    qpairs = _quad_pairs(dim)
    R = [com[:, None, :, d] - targets[:, :, None, d]
         for d in range(dim)]  # each [B, C, K]
    r2 = None
    for Rd in R:
        r2 = Rd * Rd if r2 is None else r2 + Rd * Rd
    u = jax.lax.rsqrt(r2)
    u = jnp.where(r2 < _DIST2_GUARD, 0.0, u)  # coincident / empty-cell guard
    u2 = u * u
    n = [Rd * u for Rd in R]  # unit direction, O(1)

    comp = {p: S[..., i][:, None, :] for i, p in enumerate(qpairs)}  # [B,1,K]

    def s_hat(a, b):  # Ŝ_ab = S_ab / r², mass scale
        raw = comp[(a, b)] if (a, b) in comp else comp[(b, a)]
        return raw * u2

    Sn = [sum(s_hat(d, e) * n[e] for e in range(dim)) for d in range(dim)]
    nSn = sum(n[d] * Sn[d] for d in range(dim))
    trS = sum(s_hat(d, d) for d in range(dim))
    radial = (mass[:, None, :] + 7.5 * nSn - 1.5 * trS) * u2
    return jnp.stack(
        [jnp.sum(radial * n[d] - (3.0 * u2) * Sn[d], axis=-1)
         for d in range(dim)], axis=-1)


def far_field_rings(tree: GridTree, leaf_ids_b: jax.Array,
                    tpos: jax.Array, *, k: int, multipole: str,
                    levels=None, far_impl: str = "point",
                    local_ratio: Optional[float] = None) -> jax.Array:
    """Telescoping V-list far field for a batch of target groups.

    Each target group b (a leaf cell's bodies in the dense path, a body
    chunk in the sparse path) is keyed by its leaf cell ``leaf_ids_b[b]``;
    at every level 2..L the group's ancestor interacts with its ≤
    (2k+1)^D·2^D-candidate V-list (children of the parent's near ring that
    are not the ancestor's own near ring) via monopole-at-COM or monopole +
    quadrupole. Returns the far-field acceleration increment for ``tpos``
    [B, T, D]. Shared by the dense per-leaf evaluation
    (:func:`grid_tree_accel_sorted`) and the sparse per-chunk evaluation
    (ops/sparse_grid.py).

    ``far_impl="local"`` switches eligible levels to the cell→cell local
    expansion (ops/local_expansion.py): each level's V-list cells are
    accumulated into an order-2 Taylor expansion at the *leaf center* and
    evaluated once per body at the end, removing the body axis from the
    per-candidate work (the dominant arithmetic term at θ=0.25, where every level
    carries (2k+1)^D·2^D candidates). A level is eligible when its worst-
    case Taylor ratio |ρ|/d ≈ √D/(2k·2^(L−l)) is ≤ ``local_ratio`` — the
    leaf level (l = L) never is (ratio ≈ √D/(2k+1)), so the nearest, most
    error-sensitive ring always stays per-body. ``far_impl="local_leaf"``
    admits the leaf level too (ratio √D/(2k+1) ≈ 0.25 at k=3 ⇒ order-2
    truncation the same magnitude as the accepted quad-source truncation),
    removing the body axis from the entire far field.
    """
    dim, L = tree.dim, tree.leaf_level
    B = leaf_ids_b.shape[0]
    cand_offs, _ = _ring_offsets(dim, k)
    cand_offs = jnp.asarray(cand_offs)
    acc = jnp.zeros(tpos.shape, tree.pos_sorted.dtype)
    use_local = far_impl in ("local", "local_leaf")
    if use_local:
        from .local_expansion import (LOCAL_RATIO_DEFAULT, eval_local,
                                      local_coeffs, num_coeffs, num_coeffs3,
                                      ring_level_is_local)
        if local_ratio is None:
            local_ratio = LOCAL_RATIO_DEFAULT
        leaf_xy = cell_coords(leaf_ids_b.astype(jnp.uint32), dim)
        center = tree.lo + (leaf_xy.astype(tree.pos_sorted.dtype) + 0.5) \
            * tree.cell_sizes[L]  # [B, D] leaf geometric centers
        _, nj, nh = num_coeffs(dim)
        dt = tree.pos_sorted.dtype
        a0 = jnp.zeros((B, dim), dt)
        Jp = jnp.zeros((B, nj), dt)
        Hp = jnp.zeros((B, nh), dt)
        # "local_leaf" admits the leaf ring (gated ratio ~0.19, vs ≤0.144
        # for the non-leaf levels), where the order-2 truncation becomes
        # the accuracy bottleneck — carry the order-3 term as well.
        order3 = far_impl == "local_leaf"
        Kp = jnp.zeros((B, num_coeffs3(dim)), dt) if order3 else None
        any_local = False
    for l in (range(2, L + 1) if levels is None else levels):
        anc = (leaf_ids_b >> (dim * (L - l))).astype(jnp.uint32)
        anc_xy = cell_coords(anc, dim).astype(jnp.int32)  # [B, D]
        parent_xy = anc_xy >> 1
        # Candidates are all children of the parent's near ring:
        # cand = 2·(parent + parent_off) + child_off, precomputed as
        # offsets relative to 2·parent.
        cand_xy = parent_xy[:, None, :] * 2 + cand_offs[None, :, :]
        delta = cand_xy - anc_xy[:, None, :]
        cheb = jnp.max(jnp.abs(delta), axis=-1)  # [B, ncand]
        in_bounds = jnp.all(
            (cand_xy >= 0) & (cand_xy < (1 << l)), axis=-1)
        is_far = (cheb > k) & in_bounds  # V-list membership
        cand_ids = morton_key_from_coords(
            jnp.clip(cand_xy, 0, (1 << l) - 1).astype(jnp.uint32)
            .reshape(-1, dim), l).astype(jnp.int32).reshape(B, -1)
        cpack = tree.level_pack[l][cand_ids]  # [B, ncand, 4]: com|mass
        cmass = cpack[..., 3] * is_far
        ccom = cpack[..., :dim]
        local_l = use_local and ring_level_is_local(
            dim, k, L, l, local_ratio,
            include_leaf=(far_impl == "local_leaf"))
        if local_l and l == L:
            # Leaf-level shell split ("local_leaf"): candidates beyond
            # c_gate = the largest Chebyshev shell whose Taylor ratio
            # (√D/2)/c exceeds local_ratio go through the local expansion
            # (same error budget as every other local level); the inner
            # far shells (k < cheb ≤ c_gate — e.g. just shell 4 of ~2744
            # candidates at k=3 in 3D) stay per-body. Removes the body
            # axis from ~86% of the dominant θ=0.25 far-field term.
            import math as _math
            c_gate = _math.ceil(dim ** 0.5 / (2.0 * local_ratio)) - 1
            mask_loc = is_far & (cheb > c_gate)
            cS = (tree.level_quad[l][cand_ids] * mask_loc[..., None]
                  if multipole == "quad" else None)
            da0, dJ, dH, dK = local_coeffs(center, ccom,
                                           cpack[..., 3] * mask_loc, cS,
                                           order3=True)
            a0, Jp, Hp, Kp = a0 + da0, Jp + dJ, Hp + dH, Kp + dK
            any_local = True
            idx_tab, valid_tab = _leaf_shell_subset(dim, k, c_gate)
            if idx_tab.shape[1] > 0:
                par_bits = anc_xy & 1  # [B, D] child parity
                pidx = sum(par_bits[:, d] << d for d in range(dim))  # [B]
                idx_b = jnp.asarray(idx_tab)[pidx]      # [B, m]
                sub_mask = (jnp.take_along_axis(is_far, idx_b, 1)
                            & jnp.asarray(valid_tab)[pidx])
                sub_pack = jnp.take_along_axis(cpack, idx_b[..., None], 1)
                sub_mass = sub_pack[..., 3] * sub_mask
                sub_com = sub_pack[..., :dim]
                if multipole == "quad":
                    sub_quad = jnp.take_along_axis(
                        tree.level_quad[l][cand_ids], idx_b[..., None], 1
                    ) * sub_mask[..., None]
                    acc = acc + _quad_cell_accel(tpos, sub_com, sub_mass,
                                                 sub_quad)
                else:
                    acc = acc + _point_mass_accel(tpos, sub_com, sub_mass,
                                                  0.0)
        elif local_l:
            cS = (tree.level_quad[l][cand_ids] * is_far[..., None]
                  if multipole == "quad" else None)
            out_l = local_coeffs(center, ccom, cmass, cS, order3=order3)
            a0, Jp, Hp = a0 + out_l[0], Jp + out_l[1], Hp + out_l[2]
            if order3:
                Kp = Kp + out_l[3]
            any_local = True
        elif multipole == "quad":
            cquad = tree.level_quad[l][cand_ids] * is_far[..., None]
            acc = acc + _quad_cell_accel(tpos, ccom, cmass, cquad)
        else:
            acc = acc + _point_mass_accel(tpos, ccom, cmass, 0.0)
    if use_local and any_local:
        acc = acc + eval_local(tpos - center[:, None, :], a0, Jp, Hp,
                               Kp if order3 else None)
    return acc


@functools.partial(
    jax.jit,
    static_argnames=("k", "softening", "leaf_batch", "shard_axis",
                     "num_shards", "multipole", "num_segments",
                     "far_impl", "_debug_skip"))
def grid_tree_accel_sorted(tree: GridTree, k: int = 1,
                           softening: float = 0.0,
                           leaf_batch: int = 512,
                           shard_axis: Optional[str] = None,
                           num_shards: int = 1,
                           multipole: str = "mono",
                           num_segments: int = 1,
                           segment_index: Optional[jax.Array] = None,
                           far_impl: str = "point",
                           hier_coeffs=None,
                           _debug_skip: str = "") -> jax.Array:
    """Barnes-Hut accelerations for all (sorted) bodies: [N, D], un-G-scaled.

    Far field: per level 2..L, each leaf's ancestor interacts with its ≤
    (2k+1)^D·2^D-candidate V-list via monopole-at-COM — or monopole +
    quadrupole when ``multipole="quad"`` (requires a tree built with
    ``quad=True``; the dipole vanishes at the COM, so quadrupole is the
    first correction, cutting the MAC error by ~(cell/dist)¹ ≈ 4-8×).
    Near field: leaf P2P over the (2k+1)^D neighborhood. Batched over
    dense leaf cells.

    ``hier_coeffs``: optional precomputed downward-sweep output (the
    4-tuple :func:`~nbody_jax.ops.hier_far.hier_far_coeffs` returns with
    ``defer="gather"``). Lets the segmented N≥4M driver run the sweep
    ONCE instead of once per segment dispatch; implies the traversal-side
    gather mode for the leaf-level inner far shells.

    Multi-chip: when called inside ``shard_map`` with ``shard_axis`` set,
    each chip evaluates its contiguous chunk of dense leaf cells (a spatial
    block, since leaves are Morton-ordered) against the replicated tree, and
    the per-chip partial forces are ``psum``-reduced — the evaluation phase
    is the O(N·(interaction list)) cost; the replicated build is O(N log N).
    """
    dim, L, C = tree.dim, tree.leaf_level, tree.capacity
    num_leaves = tree.num_leaf_cells
    side_bits = L

    near_offs = jnp.asarray(_neighbor_offsets(dim, k))  # [nnear, D]

    # Leaf chunk owned by this shard (whole range when unsharded). Shard
    # counts are powers of two, as is num_leaves, so chunks divide evenly.
    my_leaves = num_leaves // num_shards
    all_leaf_ids = jnp.arange(num_leaves, dtype=jnp.int32)
    if shard_axis is not None:
        start = jax.lax.axis_index(shard_axis).astype(jnp.int32) * my_leaves
        all_leaf_ids = jax.lax.dynamic_slice_in_dim(
            all_leaf_ids, start, my_leaves)
    if num_segments > 1:
        # Dispatch-bounding: the whole leaf sweep is ONE device program
        # (lax.map); the caller splits it into num_segments dispatches,
        # each over a slice of the leaves. segment_index is traced so one
        # compilation serves every segment.
        seg_leaves = my_leaves // num_segments
        sidx = jnp.asarray(
            0 if segment_index is None else segment_index, jnp.int32)
        all_leaf_ids = jax.lax.dynamic_slice_in_dim(
            all_leaf_ids, sidx * seg_leaves, seg_leaves)
        my_leaves = seg_leaves
    # num_leaves = 2^(D·L) and leaf_batch is a power of two, so clamping
    # makes the batches divide evenly — padding would duplicate leaf 0 into
    # the scatter-add below. Also clamp so the [B, (2k+1)^D·TWR, 4] near
    # tensor stays ≲1 GB (clustered capacities / wide rings OOM otherwise).
    twr_b = (C // 8 + 1) * 8
    nnear_b = (2 * k + 1) ** dim
    import math as _math
    mem_cap = max(1, 1 << int(_math.floor(_math.log2(
        max(1.0, 1e9 / (nnear_b * twr_b * 16))))))
    leaf_batch = min(leaf_batch, mem_cap, my_leaves)
    nb = my_leaves // leaf_batch

    # Hierarchical far field ("hier"): the whole downward sweep runs ONCE
    # outside the leaf map (per-parent gathers, L2L shifts — see
    # ops/hier_far.py); each leaf batch only evaluates its order-3 Taylor
    # expansion plus the per-body inner shells, carried into the map as xs.
    hier_on = far_impl == "hier" and "far" not in _debug_skip
    hier_xs = ()
    hier_gather = False
    hier_tables = None
    if hier_on:
        from .hier_far import hier_far_coeffs, leaf_defer_tables
        offs_np_h, valid_np_h = leaf_defer_tables(dim, k)
        md_h = offs_np_h.shape[1]
        nq_h = len(_quad_pairs(dim)) if multipole == "quad" else 0
        # Sweep-side "pack" mode materializes [G, md·(D+1)] (+ [G, md·nq])
        # per-leaf deferred-shell tensors — ~4 GB at N=5e6 3D L=6, plus
        # their chunked-stack intermediates (the round-4
        # RESOURCE_EXHAUSTED). Above ~1 GB estimated, switch to
        # "gather": the sweep emits only the [G, ~22] Taylor coefficients
        # and the traversal gathers each leaf's deferred cells itself
        # (static per-parity offset tables, the far_field_rings pattern).
        est_pack_bytes = num_leaves * md_h * (dim + 1 + nq_h) * 4
        hier_gather = (hier_coeffs is not None
                       or est_pack_bytes > 1 << 30)
        if hier_coeffs is not None:
            h_coeffs, h_dp, h_dq = hier_coeffs, None, None
        else:
            h_coeffs, h_dp, h_dq = hier_far_coeffs(
                tree, k, multipole=multipole,
                defer="gather" if hier_gather else "pack")
        if hier_gather and md_h:
            hier_tables = (jnp.asarray(offs_np_h),
                           jnp.asarray(valid_np_h,
                                       tree.pos_sorted.dtype))
        chunk0_h = all_leaf_ids[0]

        def _chunk(x):
            part = jax.lax.dynamic_slice_in_dim(x, chunk0_h, my_leaves)
            return part.reshape((nb, leaf_batch) + part.shape[1:])

        hier_xs = tuple(_chunk(x) for x in h_coeffs)
        if not hier_gather:
            hier_xs = hier_xs + (_chunk(h_dp),)
            if h_dq is not None:
                hier_xs = hier_xs + (_chunk(h_dq),)

    def one_batch(args):
        """args: ([B] dense leaf ids, *hier per-leaf tensors when hier)."""
        leaf_ids_b, *extra = args
        B = leaf_ids_b.shape[0]
        # Target bodies: each leaf's contiguous run as packed superrows
        # (slot-free; see _window_rows).
        tb, tidx, tvalid = _window_rows(tree, leaf_ids_b)  # [B, TWR, ·]
        tpos = tb[..., :dim]
        acc = jnp.zeros(tpos.shape, tree.pos_sorted.dtype)

        # --- Far field: V-list per level (shared helper) ---------------
        if hier_on:
            from .local_expansion import eval_local
            a0_b, J_b, H_b, K_b = extra[:4]
            leaf_xy_h = cell_coords(leaf_ids_b.astype(jnp.uint32), dim)
            center = tree.lo + (leaf_xy_h.astype(tree.pos_sorted.dtype)
                                + 0.5) * tree.cell_sizes[L]
            acc = acc + eval_local(tpos - center[:, None, :],
                                   a0_b, J_b, H_b, K_b)
            if hier_gather and hier_tables is not None:
                # Per-body inner far shells, traversal-side: gather each
                # leaf's deferred cells (static per-parity offsets in leaf
                # units — leaf_defer_tables) from the leaf-level summary
                # table, per batch. Same physics as the sweep-side pack
                # tensors; sized [B, md, ·] instead of [G, md·(D+1)].
                offs_t, valid_t = hier_tables
                pm_b = (leaf_ids_b & ((1 << dim) - 1)).astype(jnp.int32)
                dxy = leaf_xy_h.astype(jnp.int32)[:, None, :] \
                    + offs_t[pm_b]  # [B, md, D]
                d_ok = jnp.all((dxy >= 0) & (dxy < (1 << L)), axis=-1)
                d_ids = morton_key_from_coords(
                    jnp.clip(dxy, 0, (1 << L) - 1).astype(jnp.uint32)
                    .reshape(-1, dim), L).astype(jnp.int32)\
                    .reshape(B, -1)
                dpack = tree.level_pack[L][d_ids]  # [B, md, 4]
                dmass = dpack[..., 3] * valid_t[pm_b] * d_ok
                if multipole == "quad":
                    dq = tree.level_quad[L][d_ids] \
                        * (valid_t[pm_b] * d_ok)[..., None]
                    acc = acc + _quad_cell_accel(
                        tpos, dpack[..., :dim], dmass, dq)
                else:
                    acc = acc + _point_mass_accel(
                        tpos, dpack[..., :dim], dmass, 0.0)
            elif not hier_gather and extra[4].shape[1]:
                # per-body inner far shells (flat-packed [G, md·4]
                # buffers, no narrow trailing dim of 4 to pad; the
                # reshape per batch is local)
                dp_b = extra[4].reshape(B, -1, dim + 1)
                if multipole == "quad":
                    dq_b = extra[5].reshape(B, dp_b.shape[1], -1)
                    acc = acc + _quad_cell_accel(
                        tpos, dp_b[..., :dim], dp_b[..., dim], dq_b)
                else:
                    acc = acc + _point_mass_accel(
                        tpos, dp_b[..., :dim], dp_b[..., dim], 0.0)
        elif "far" not in _debug_skip:
            acc = acc + far_field_rings(tree, leaf_ids_b, tpos, k=k,
                                        multipole=multipole,
                                        far_impl=far_impl)

        # --- Near field: leaf P2P over the (2k+1)^D neighborhood -------
        if "near" not in _debug_skip:
            nch = 1 << dim
            if k >= 2 and B % nch == 0:
                # Parent-shared source windows (see _parent_window): one
                # (2k+2)^D gather per parent, 2^D per-parity masked P2P
                # passes over it.
                Bp = B // nch
                twr = tpos.shape[1]
                offs_np, masks_np = _parent_window(dim, k)
                parent_ids = leaf_ids_b.reshape(Bp, nch)[:, 0] >> dim
                parent_xy = cell_coords(
                    parent_ids.astype(jnp.uint32), dim).astype(jnp.int32)
                w_xy = parent_xy[:, None, :] * 2 \
                    + jnp.asarray(offs_np)[None, :, :]
                w_ok = jnp.all((w_xy >= 0) & (w_xy < (1 << side_bits)),
                               axis=-1)
                w_ids = morton_key_from_coords(
                    jnp.clip(w_xy, 0, (1 << side_bits) - 1)
                    .astype(jnp.uint32).reshape(-1, dim),
                    side_bits).astype(jnp.int32).reshape(Bp, -1)
                sb, _, svalid = _window_rows(tree, w_ids)  # [Bp, W, SWR, 4]
                svalid = svalid & w_ok[:, :, None]
                spos = sb[..., :dim].reshape(Bp, -1, dim)
                smass = sb[..., 3] * svalid  # [Bp, W, SWR]
                tpos_p = tpos.reshape(Bp, nch, twr, dim)
                parts = []
                for pm in range(nch):
                    m = jnp.asarray(masks_np[pm], tpos.dtype)
                    sm = (smass * m[None, :, None]).reshape(Bp, -1)
                    parts.append(_point_mass_accel(
                        tpos_p[:, pm], spos, sm, softening))
                acc = acc + jnp.stack(parts, axis=1).reshape(B, twr, dim)
            else:
                leaf_xy = cell_coords(leaf_ids_b.astype(jnp.uint32), dim)\
                    .astype(jnp.int32)  # [B, D]
                nb_xy = leaf_xy[:, None, :] + near_offs[None, :, :]
                nb_ok = jnp.all((nb_xy >= 0) & (nb_xy < (1 << side_bits)),
                                axis=-1)
                nb_ids = morton_key_from_coords(
                    jnp.clip(nb_xy, 0, (1 << side_bits) - 1)
                    .astype(jnp.uint32).reshape(-1, dim),
                    side_bits).astype(jnp.int32).reshape(B, -1)
                sb, _, svalid = _window_rows(tree, nb_ids)
                svalid = svalid & nb_ok[:, :, None]  # [B, nnear, SWR]
                spos = sb[..., :dim].reshape(B, -1, dim)
                smass = (sb[..., 3] * svalid).reshape(B, -1)
                acc = acc + _point_mass_accel(tpos, spos, smass, softening)

        del tidx, tvalid
        return acc

    # Map over even batches of dense leaf ids.
    ids_batched = all_leaf_ids.reshape(nb, leaf_batch)
    accs = jax.lax.map(one_batch, (ids_batched,) + hier_xs)

    # Window layout → sorted order is a pure GATHER (each body occupies
    # exactly one window slot), not a scatter.
    twr = (C // 8 + 1) * 8
    acc_flat = accs.reshape(-1, dim)  # [my_leaves·TWR, dim]
    chunk0 = all_leaf_ids[0]
    src = (tree.leaf_ids - chunk0) * twr + tree.window_slot  # [N]
    in_chunk = (tree.leaf_ids >= chunk0) & \
               (tree.leaf_ids < chunk0 + my_leaves)
    out = acc_flat[jnp.where(in_chunk, src, 0)] * in_chunk[:, None]
    if shard_axis is not None:
        out = jax.lax.psum(out, shard_axis)
    return out


@functools.partial(jax.jit, static_argnames=("k", "multipole"))
def _hier_sweep_jit(tree, k: int, multipole: str):
    """Coefficients-only downward sweep (one dispatch, segment-shared)."""
    from .hier_far import hier_far_coeffs
    return hier_far_coeffs(tree, k, multipole=multipole, defer="gather")[0]


def theta_to_ring(theta: float) -> int:
    """Opening angle → ring radius: θ_eff = 1/(k+1) ≤ θ."""
    import math
    return max(1, math.ceil(1.0 / max(theta, 1e-3)) - 1)


@functools.partial(
    jax.jit,
    static_argnames=("leaf_level", "capacity", "k", "softening",
                     "leaf_batch", "multipole", "far_impl"))
def _bh_grid_fused(positions, masses, g, *, leaf_level, capacity, k,
                   softening, leaf_batch, multipole,
                   far_impl="point"):
    """Build + traversal + unsort + G-scale as ONE device program.

    One dispatch instead of a build-dispatch / eval-dispatch / scatter /
    scale sequence of eager ops, so small-N evaluations pay one launch
    and no host round trips. Shapes stay static; only the capacity probe
    (when requested) remains outside.
    """
    tree = build_grid_tree(positions, masses, leaf_level, capacity,
                           quad=(multipole == "quad"))
    acc_sorted = grid_tree_accel_sorted(
        tree, k=k, softening=softening, leaf_batch=leaf_batch,
        multipole=multipole, far_impl=far_impl)
    acc = jnp.zeros_like(acc_sorted).at[tree.order].set(acc_sorted)
    return (g * masses)[:, None] * acc


def resolve_bh_params(n: int, dim: int, theta: float,
                      far_impl: Optional[str] = None,
                      leaf_level: Optional[int] = None,
                      leaf_batch: int = 512,
                      multipole: str = "quad") -> dict:
    """Resolve every static Barnes-Hut driver decision for (n, dim, θ).

    Single source of truth shared by :func:`barnes_hut_grid` and the
    bench registry's hyperparameter provenance, so every run records the
    tier configuration that produced it. Data-dependent decisions (the dense/sparse ``layout=auto``
    capacity probe) are NOT resolved here and are recorded as "auto".
    """
    k = theta_to_ring(theta)
    if far_impl is None:
        # "hier" at wide rings (chosen on the previous accelerator, where
        # it was faster at θ=0.25 with accuracy held; to be re-measured on
        # the GPU — ROADMAP); k=1 degenerates (every V-shell inside the
        # deferral gate), so θ=0.5 keeps "local". The 3D L=6 memory
        # blow-up of the deferred-shell pack outputs is sidestepped by the
        # footprint-gated defer="gather" mode — see hier_far.py.
        far_impl = "hier" if k >= 2 else "local"
    num_segments = 1
    if dim == 3 and k >= 3 and n >= 2_000_000:
        # 3D k=3 has 2744 V-list candidates/leaf/level; at N >= 2e6 the
        # default 512-leaf batches failed to compile on the previous
        # accelerator — smaller batches shrink every per-level
        # intermediate. To be re-checked against the GPU (ROADMAP).
        leaf_batch = min(leaf_batch, 256)
        if n >= 4_000_000:
            # Split the sweep into bounded dispatches (one compile, traced
            # index). The split served a dispatch-time limit of the
            # previous platform; whether GPU memory needs it is open
            # (ROADMAP).
            num_segments = 4
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim, k=k)
    return {"theta": theta, "k": k, "far_impl": far_impl,
            "multipole": multipole, "leaf_level": leaf_level,
            "leaf_batch": leaf_batch, "num_segments": num_segments}


def barnes_hut_grid(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    theta: Optional[float] = None,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    leaf_batch: int = 512,
    multipole: str = "quad",
    layout: str = "auto",
    far_impl: Optional[str] = None,
) -> jax.Array:
    """Barnes-Hut forces [N, D] (honors theta, unlike methods.cpp:229,248).

    ``multipole="quad"`` (default) evaluates accepted cells with monopole +
    quadrupole — the standard accuracy upgrade over the reference's
    monopole-at-COM (octree.cpp:146-151), which remains available as
    ``multipole="mono"``.

    ``far_impl="local"`` accumulates eligible far-field levels into an
    order-2 local expansion at each leaf center instead of evaluating
    every candidate cell per body (see :func:`far_field_rings`) —
    arithmetic drops ~(levels−1)× on the far field at θ=0.25.
    ``far_impl="local_leaf"`` also shell-splits the leaf-level ring
    (order-3 term carried); ``far_impl="hier"`` runs the full FMM-style
    downward sweep (ops/hier_far.py): per-parent candidate gathers, L2L
    shifts, per-body work only for the innermost far shells — the
    far-field gather volume drops ~(levels−1)·7×. "hier" requires k ≥ 2
    (at k=1 every V-list shell is inside the deferral gate and it
    degenerates to "point" with extra steps).

    ``layout``: "dense" is the capacity-padded per-leaf evaluation (fastest
    on quasi-uniform inputs; refuses degenerate capacities); "sparse" is
    the chunked O(N)-memory evaluation (ops/sparse_grid.py) for clustered
    inputs; "auto" (default) picks dense and falls back to sparse when the
    capacity guard would trip — so any mass distribution just works.
    """
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    rp = resolve_bh_params(n, dim, theta, far_impl=far_impl,
                           leaf_level=leaf_level, leaf_batch=leaf_batch,
                           multipole=multipole)
    k, far_impl = rp["k"], rp["far_impl"]
    num_segments, leaf_batch = rp["num_segments"], rp["leaf_batch"]
    leaf_level = rp["leaf_level"]
    # The sparse chunked path shares far_field_rings, which has no "hier"
    # mode (per-chunk targets have no shared dense parent structure).
    sparse_far = "local" if far_impl == "hier" else far_impl
    if layout == "sparse":
        from .sparse_grid import barnes_hut_sparse
        return barnes_hut_sparse(positions, masses, config, theta=theta,
                                 leaf_level=leaf_level, multipole=multipole,
                                 far_impl=sparse_far)
    if capacity is None:
        capacity = compute_capacity_cached(positions, leaf_level)
        if layout == "auto" and dense_layout_degenerate(
                capacity, n, leaf_level, dim):
            from .sparse_grid import barnes_hut_sparse
            return barnes_hut_sparse(positions, masses, config, theta=theta,
                                     leaf_level=leaf_level,
                                     multipole=multipole,
                                     far_impl=sparse_far)
        check_grid_capacity(capacity, n, leaf_level, dim, "barnes_hut_grid")
    g = jnp.asarray(config.G, positions.dtype)

    if num_segments == 1:
        # One fused dispatch (see _bh_grid_fused).
        return _bh_grid_fused(
            positions, masses, g, leaf_level=leaf_level, capacity=capacity,
            k=k, softening=float(config.softening), leaf_batch=leaf_batch,
            multipole=multipole, far_impl=far_impl)

    # Segmented path (N≥4M 3D wide rings): each segment stays its own
    # dispatch — that is the point of the split.
    tree = build_grid_tree(positions, masses, leaf_level, capacity,
                           quad=(multipole == "quad"))
    hier_coeffs = None
    if far_impl == "hier":
        # Run the downward sweep ONCE (its own bounded dispatch) instead
        # of re-tracing it into every segment; segments then only carry
        # the [G, ~22] Taylor coefficients (defer="gather").
        hier_coeffs = _hier_sweep_jit(tree, k=k, multipole=multipole)
    acc_sorted = None
    for si in range(num_segments):
        part = grid_tree_accel_sorted(
            tree, k=k, softening=float(config.softening),
            leaf_batch=leaf_batch, multipole=multipole,
            num_segments=num_segments,
            segment_index=jnp.int32(si), far_impl=far_impl,
            hier_coeffs=hier_coeffs)
        acc_sorted = part if acc_sorted is None else acc_sorted + part
    acc = jnp.zeros_like(acc_sorted).at[tree.order].set(acc_sorted)
    return (g * masses)[:, None] * acc
