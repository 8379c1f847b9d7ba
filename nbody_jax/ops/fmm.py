"""Fast Multipole Method — black-box (Chebyshev) FMM on the grid tree.

The reference's FMM is its most broken subsystem (SURVEY.md §8.3/8.4/8.9/8.10):
the "sequential FMM" is actually a Barnes-Hut walk (``fmm.cpp:599-703``), the
OpenMP variant doesn't compile (``fmm_omp.cpp:228``), 3D expansions are a
monopole placeholder (``fmm.cpp:195-198``), the 2D expansions use the complex
*log* kernel (``fmm.cpp:77-133``) which does not even match the suite's own
1/r² brute-force law, and the hard-coded ``Expansion<D,10>`` overflows at the
default order 16 (``fmm.h:61`` vs ``methods.h:25``).

This tier is the intended algorithm, built as the *black-box FMM*
of Fong & Darve (J. Comp. Phys. 228, 2009): cells carry weights at tensor
Chebyshev nodes instead of analytic multipole coefficients, which makes the
method kernel-independent — it expands exactly the suite's force law
K(x,y) = 1/|x−y| (with a = G·∇φ) in both 2D and 3D, so FMM forces converge
to the brute-force oracle as the order n grows. All six phases map onto the
hardware as dense batched matmuls:

  P2M   anterpolate body masses onto leaf-cell Chebyshev nodes
  M2M   child→parent interpolation operators (2^D static [n^D, n^D] mats)
  M2L   per V-list offset: gather + [cells, n^D] @ K_offset — the matmul
        hot phase, replacing the reference's per-node series loops
        (``fmm_parlay.cpp:420-713``)
  L2L   parent→child (transpose of M2M)
  L2P   gradient of the Chebyshev interpolant at each body
  P2P   leaf-neighborhood pairs (shared with the Barnes-Hut grid tier)

Expansion order is a static shape parameter (fixing §8.3 by construction).
V-lists reuse the grid tree's telescoping ring structure — per-level offsets
with parity-dependent membership (a cell's V-set depends on its position
within its parent), handled as static per-delta parity masks so every phase
stays a fixed-shape array program.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_GRAVITY, GravityConfig
from .grid_tree import (
    GridTree,
    _neighbor_offsets,
    _point_mass_accel,
    _window_rows,
    auto_leaf_level,
    build_grid_tree,
    cell_coords,
    check_grid_capacity,
    compute_capacity,
    compute_capacity_cached,
    dense_layout_degenerate,
)
from .keys import morton_key_from_coords


# --- Chebyshev machinery (static, numpy) -----------------------------------

def cheb_nodes(n: int) -> np.ndarray:
    """First-kind Chebyshev points in (-1, 1)."""
    m = np.arange(n)
    return np.cos((2 * m + 1) * np.pi / (2 * n))


def _cheb_T(n: int, y: np.ndarray) -> np.ndarray:
    """[T_0..T_{n-1}](y): shape (n, *y.shape)."""
    T = [np.ones_like(y), y]
    for k in range(2, n):
        T.append(2 * y * T[-1] - T[-2])
    return np.stack(T[:n])


def s_matrix(n: int, y: np.ndarray) -> np.ndarray:
    """Interpolation kernel S_n(t_m, y): shape (len(y), n) — row per y."""
    t = cheb_nodes(n)
    Tt = _cheb_T(n, t)  # (n, n)
    Ty = _cheb_T(n, np.asarray(y))  # (n, len(y))
    return (1.0 / n + (2.0 / n) * np.einsum("km,ky->ym", Tt[1:], Ty[1:]))


def m2m_operators(dim: int, n: int) -> np.ndarray:
    """[2^D, n^D, n^D]: child-octant weights → parent-node weights.

    M2M_o[m, m'] = Π_d S_n(t_{m,d}, (t_{m',d} + 2 o_d − 1)/2).
    """
    t = cheb_nodes(n)
    ops = []
    for octant in itertools.product((0, 1), repeat=dim):
        per_dim = []
        for d in range(dim):
            y = (t + 2 * octant[d] - 1) / 2.0  # child nodes in parent frame
            per_dim.append(s_matrix(n, y).T)  # (n, n): [m, m']
        op = per_dim[0]
        for d in range(1, dim):
            op = np.einsum("ab,cd->acbd", op, per_dim[d]).reshape(
                op.shape[0] * n, op.shape[1] * n)
        ops.append(op)
    return np.stack(ops)  # [2^D, n^D, n^D]


def centered_m2l_kernel(deltas_arr, nodes, cs_leaf, dtype):
    """Leaf-scale M2L operators [nd, nD_target, nD_source], centered.

    K'[t, s] = 1/|y_s − x_t| − 1/|y_s − c|, with c the target cell's center.
    The second term is constant across the target cell, and the Chebyshev
    interpolant reproduces constants (Σ_m S_n(t_m, y) = 1), so the force —
    the interpolant's gradient — is unchanged. What changes is float32
    rounding: local expansions hold the potential's variation across the
    cell instead of the potential itself, whose rounding the L2P gradient
    amplifies (with :func:`multilevel_l2p`, N = 131,072 3D order 8 on the
    CPU: far-field float32 error 1.7e-5 centered, 2.2e-4 not).
    """
    half = cs_leaf / 2
    s = (deltas_arr[:, None, None, :].astype(dtype) * cs_leaf
         + nodes[None, None, :, :] * half)  # [nd, 1, nD_s, D] from center
    t = nodes[None, :, None, :] * half  # [1, nD_t, 1, D] from center
    # 1/|s − t| − 1/|s| = t·(2s − t) / (|s − t|·|s|·(|s − t| + |s|)):
    # the difference is formed without cancellation, so it keeps float32's
    # relative precision (subtracting the two reciprocals would not).
    a = jnp.sqrt(jnp.sum((s - t) ** 2, axis=-1))
    b = jnp.sqrt(jnp.sum(s * s, axis=-1))
    return jnp.sum(t * (2 * s - t), axis=-1) / (a * b * (a + b))


def local_gradient(lw, y, half, n: int, Tt):
    """∇ of the order-n Chebyshev interpolant with node weights ``lw``
    [B, n^D] at cell coordinates ``y`` [B, D] in [-1, 1]^D; [B, D]."""
    dim = y.shape[-1]
    s_all, ds_all = [], []
    for d in range(dim):
        s_d, ds_d = _interp_and_grad_1d(n, y[:, d], Tt)
        s_all.append(s_d)
        ds_all.append(ds_d)
    cols = []
    for d in range(dim):
        basis = None
        for d2 in range(dim):
            f = ds_all[d2] if d2 == d else s_all[d2]
            basis = f if basis is None else (
                basis[:, :, None] * f[:, None, :]).reshape(f.shape[0], -1)
        cols.append(jnp.einsum("bm,bm->b", basis, lw,
                               precision=jax.lax.Precision.HIGHEST)
                    / half[d])
    return jnp.stack(cols, axis=-1)


def multilevel_l2p(Lc, L: int, leaf, pos, lo, cs_leaf, n: int, Tt):
    """Far-field acceleration on bodies ``pos`` [B, D] in leaf cells ``leaf``
    [B]: the sum over levels l = 2..L of the gradient of level l's local
    expansion ``Lc[l]`` [cells_l, n^D], evaluated in the body's level-l
    cell (its Morton prefix).

    This takes the place of an L2L downward pass. Passing a parent's
    expansion down interpolates it to the child's nodes, and that float32
    rounding (n^D weights of alternating sign) is then differentiated at
    the child's scale; each level's expansion is instead differentiated at
    its own scale — L−1 evaluations per body instead of one. (N = 131,072
    3D order 8 on the CPU, sampled float64 oracle: 5.3e-5 with a centered
    L2L, 8.2e-6 this way; float64 runs agree to 1e-6 either way.)
    """
    dim = pos.shape[-1]
    acc = jnp.zeros(pos.shape, pos.dtype)
    for l in range(2, L + 1):
        cell = leaf >> (dim * (L - l))  # Morton prefix = level-l cell id
        size = cs_leaf * (1 << (L - l))
        centers = lo + (cell_coords(cell.astype(jnp.uint32), dim)
                        .astype(pos.dtype) + 0.5) * size
        half = size / 2
        acc = acc + local_gradient(Lc[l][cell], (pos - centers) / half,
                                   half, n, Tt)
    return acc


def _tensor_nodes(dim: int, n: int) -> np.ndarray:
    """All n^D tensor-product node coordinates in [-1,1]^D (Morton-major)."""
    t = cheb_nodes(n)
    grids = np.meshgrid(*([t] * dim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)  # [n^D, D]


def _jnp_cheb_T_and_dT(n: int, y: jax.Array):
    """T_k(y) and T'_k(y) for k<n via recurrence (traced; static k loop)."""
    Ts = [jnp.ones_like(y), y]
    dTs = [jnp.zeros_like(y), jnp.ones_like(y)]
    for k in range(2, n):
        Ts.append(2 * y * Ts[-1] - Ts[-2])
        dTs.append(2 * Ts[k - 1] + 2 * y * dTs[-1] - dTs[-2])
    return jnp.stack(Ts[:n], -1), jnp.stack(dTs[:n], -1)  # (..., n)


def _interp_1d(n: int, y: jax.Array, Tt: jax.Array):
    """S_n(t_m, y) for traced y: (..., n) over nodes m."""
    Ty, _ = _jnp_cheb_T_and_dT(n, y)
    return 1.0 / n + (2.0 / n) * jnp.einsum(
        "...k,mk->...m", Ty[..., 1:], Tt[:, 1:],
        precision=jax.lax.Precision.HIGHEST)


def _interp_and_grad_1d(n: int, y: jax.Array, Tt: jax.Array):
    Ty, dTy = _jnp_cheb_T_and_dT(n, y)
    s = 1.0 / n + (2.0 / n) * jnp.einsum(
        "...k,mk->...m", Ty[..., 1:], Tt[:, 1:],
        precision=jax.lax.Precision.HIGHEST)
    ds = (2.0 / n) * jnp.einsum("...k,mk->...m", dTy[..., 1:], Tt[:, 1:],
                                precision=jax.lax.Precision.HIGHEST)
    return s, ds


def _v_list_deltas(dim: int, k: int):
    """Static V-list offsets at one level with parity masks.

    Returns list of (delta [D], parity_ok [D, 2] bool): cell c (parity q)
    interacts with cell c+delta iff cheb(delta) > k and the parents'
    offset floor((q+delta)/2) is within the parent near ring, per dim.
    """
    out = []
    rng = range(-(2 * k + 1), 2 * k + 2)
    for delta in itertools.product(rng, repeat=dim):
        if max(abs(x) for x in delta) <= k:
            continue  # near neighbor → P2P, not V-list
        parity_ok = np.zeros((dim, 2), dtype=bool)
        for d in range(dim):
            for q in (0, 1):
                # Parent offset along d for a cell with parity bit q.
                parity_ok[d, q] = abs(math.floor((q + delta[d]) / 2)) <= k
        # Keep the delta if some parity uses it (per-dim independence).
        if all(parity_ok[d].any() for d in range(dim)):
            out.append((np.array(delta, np.int32), parity_ok))
    return out


@functools.partial(
    jax.jit,
    static_argnames=("order", "ring", "softening", "leaf_batch",
                     "shard_axis", "num_shards", "_debug_skip",
                     "num_chunks", "chunk_size", "window", "max_windows"))
def fmm_accel_sorted(tree: GridTree, order: int = 5, ring: int = 1,
                     softening: float = 0.0,
                     leaf_batch: int = 1024,
                     shard_axis: Optional[str] = None,
                     num_shards: int = 1,
                     _debug_skip: str = "",
                     num_chunks: Optional[int] = None,
                     chunk_size: int = 64,
                     window: int = 8,
                     max_windows: int = 0) -> jax.Array:
    """FMM accelerations for all sorted bodies (un-G-scaled): [N, D].

    Multi-chip (``shard_axis`` set, called under ``shard_map``): P2M and the
    final L2P/P2P are sharded by contiguous Morton leaf chunks; M2L — the
    dominant phase — is sharded by cell rows per level; chunk results are
    ``all_gather``-ed back to replicated level arrays (they're small), and
    the per-chip partial forces are ``psum``-reduced. The up/down sweeps are
    cheap and run replicated.

    ``num_chunks`` switches P2M and P2P to the sparse (clustered-input)
    layout of ops/sparse_grid.py: targets are cell-aligned body chunks and
    P2P sources are fixed windows over the ring runs, so no tensor scales
    with the max leaf occupancy. M2M/M2L/L2L are cell-space (already
    capacity-free) and L2P is per-body; they run unchanged. Single-chip
    only (the LET path distributes clustered inputs).
    """
    sparse = num_chunks is not None
    if sparse and shard_axis is not None:
        raise ValueError("the sparse FMM layout is single-chip; use "
                         "parallel/let_tree for distribution")
    dim, L, C = tree.dim, tree.leaf_level, tree.capacity
    n_cheb = order
    nD = n_cheb ** dim
    num_leaves = tree.num_leaf_cells
    dtype = tree.pos_sorted.dtype
    k = ring

    nodes = jnp.asarray(_tensor_nodes(dim, n_cheb), dtype)  # [nD, D]
    Tt = jnp.asarray(_cheb_T(n_cheb, cheb_nodes(n_cheb)).T, dtype)  # [n,k]
    m2m = jnp.asarray(m2m_operators(dim, n_cheb), dtype)  # [2^D, nD, nD]
    deltas = _v_list_deltas(dim, k)

    leaf_size_phys = tree.cell_sizes[L]  # [D]
    half_leaf = leaf_size_phys / 2

    # Leaf cell centers for all dense leaves.
    leaf_ids_all = jnp.arange(num_leaves, dtype=jnp.int32)
    leaf_xy = cell_coords(leaf_ids_all.astype(jnp.uint32), dim)\
        .astype(dtype)
    leaf_centers = tree.lo + (leaf_xy + 0.5) * leaf_size_phys  # [M, D]

    if sparse:
        # Cell-aligned body chunks shared by P2M and P2P (grid_tree.
        # chunk_table; num_chunks comes from the exact sparse_grid_stats
        # probe). Padded to whole batches; pad rows have length 0.
        from .grid_tree import chunk_table
        cellA, cstartA, clenA, coffsA = chunk_table(
            tree.cell_start, tree.cell_count, chunk=chunk_size,
            num_chunks=num_chunks)
        cb = min(leaf_batch, 128, num_chunks)
        NBc = -(-num_chunks // cb)
        padc = NBc * cb - num_chunks
        if padc:
            cellA = jnp.concatenate(
                [cellA, jnp.zeros((padc,), cellA.dtype)])
            cstartA = jnp.concatenate(
                [cstartA, jnp.zeros((padc,), cstartA.dtype)])
            clenA = jnp.concatenate(
                [clenA, jnp.zeros((padc,), clenA.dtype)])
        btab = tree.body_pack.reshape(-1, 4)
        arangeC = jnp.arange(chunk_size, dtype=jnp.int32)
        cen_chunk = tree.lo + (
            cell_coords(cellA.astype(jnp.uint32), dim).astype(dtype)
            + 0.5) * leaf_size_phys  # [NTp, D]
        cellA_b = cellA.reshape(NBc, cb)
        cstartA_b = cstartA.reshape(NBc, cb)
        clenA_b = clenA.reshape(NBc, cb)
        cenA_b = cen_chunk.reshape(NBc, cb, dim)

        def chunk_rows(cstart_b, clen_b):
            idx = cstart_b[:, None] + arangeC  # [B, c]
            rows = btab[jnp.clip(idx, 0, btab.shape[0] - 1)]
            valid = arangeC[None, :] < clen_b[:, None]
            return rows, valid

    # ---- P2M: anterpolate body masses to leaf Chebyshev nodes ----------
    # This shard's contiguous leaf chunk (whole range when unsharded).
    my_leaves = num_leaves // num_shards
    if shard_axis is not None:
        chunk_start = (jax.lax.axis_index(shard_axis).astype(jnp.int32)
                       * my_leaves)
        leaf_ids_all = jax.lax.dynamic_slice_in_dim(
            leaf_ids_all, chunk_start, my_leaves)
        leaf_centers = jax.lax.dynamic_slice_in_dim(
            leaf_centers, chunk_start, my_leaves)
    leaf_batch_e = min(leaf_batch, my_leaves)
    nb = my_leaves // leaf_batch_e

    def p2m_batch(args):
        ids_b, centers_b = args
        # Slot-free: each leaf's contiguous run as packed superrows.
        tb, _, valid = _window_rows(tree, ids_b)  # [B, TWR, 4]
        pos = tb[..., :dim]
        mass = tb[..., 3] * valid  # [B, TWR]
        y = (pos - centers_b[:, None, :]) / half_leaf  # in [-1,1]^D
        # Masked window rows carry pos=0 → |y| can be huge and T_k(y) can
        # overflow to inf (0·inf = NaN); pin them to the center instead.
        y = jnp.where(valid[..., None], y, 0.0)
        basis = None
        for d in range(dim):
            s_d = _interp_1d(n_cheb, y[..., d], Tt)  # [B, C, n]
            basis = s_d if basis is None else (
                basis[..., :, None] * s_d[..., None, :]).reshape(
                    s_d.shape[:-1] + (-1,))
        return jnp.einsum("bc,bcm->bm", mass, basis,
                          precision=jax.lax.Precision.HIGHEST)  # [B, nD]

    ids_b = leaf_ids_all.reshape(nb, leaf_batch_e)
    cen_b = leaf_centers.reshape(nb, leaf_batch_e, dim)
    if sparse:
        # Chunked P2M: per-chunk partial node weights scatter-added into
        # the leaf table — [B, chunk, nD] intermediates instead of the
        # capacity-padded [B, TWR, nD].
        def p2m_chunk(args):
            cstart_b, clen_b, cen_cb = args
            rows, valid = chunk_rows(cstart_b, clen_b)
            pos = rows[..., :dim]
            mass = rows[..., 3] * valid
            y = (pos - cen_cb[:, None, :]) / half_leaf
            y = jnp.where(valid[..., None], y, 0.0)
            basis = None
            for d in range(dim):
                s_d = _interp_1d(n_cheb, y[..., d], Tt)
                basis = s_d if basis is None else (
                    basis[..., :, None] * s_d[..., None, :]).reshape(
                        s_d.shape[:-1] + (-1,))
            return jnp.einsum("bc,bcm->bm", mass, basis,
                              precision=jax.lax.Precision.HIGHEST)

        parts = jax.lax.map(
            p2m_chunk, (cstartA_b, clenA_b, cenA_b)).reshape(-1, nD)
        W_leaf = jnp.zeros((num_leaves, nD), dtype).at[cellA].add(parts)
    else:
        W_leaf = jax.lax.map(
            p2m_batch, (ids_b, cen_b)).reshape(my_leaves, nD)
    if shard_axis is not None:
        W_leaf = jax.lax.all_gather(W_leaf, shard_axis, tiled=True)

    # ---- M2M upward sweep ---------------------------------------------
    W = {L: W_leaf}
    for l in range(L - 1, 1, -1):
        child = W[l + 1].reshape(-1, 2 ** dim, nD)  # [cells_l, 2^D, nD]
        W[l] = jnp.einsum("pon,omn->pm", child, m2m,
                          precision=jax.lax.Precision.HIGHEST)

    # ---- M2L: V-list transfers (the matmul phase) ----------------------
    # Stack all delta operators once at leaf scale; 1/r homogeneity gives
    # every coarser level by a scalar (r_l = 2^(L-l)·r_L ⇒ K_l = K_L/2^(L-l)).
    # A lax.scan over the delta axis keeps the traced graph small (one
    # gather+matmul) instead of unrolling 40 (2D) / 316 (3D) matmuls per
    # level — the unrolled form took minutes to compile.
    ndeltas = len(deltas)
    deltas_arr = jnp.asarray(np.stack([d for d, _ in deltas]))  # [nd, D]
    parity_arr = jnp.asarray(
        np.stack([p for _, p in deltas]))  # [nd, D, 2] bool
    K_leaf = centered_m2l_kernel(deltas_arr, nodes, tree.cell_sizes[L],
                                 dtype)  # [nd, nD, nD]

    Lc = {}
    for l in range(2, L + 1):
        ncells = 1 << (dim * l)
        side = 1 << l
        scale_l = jnp.asarray(2.0 ** -(L - l), dtype)  # K_l = K_L·2^{-(L-l)}
        cell_ids_l = jnp.arange(ncells, dtype=jnp.uint32)
        # Shard M2L target rows by cell chunk when at least one cell per
        # shard exists at this level; coarser levels run replicated.
        sharded_l = shard_axis is not None and ncells >= num_shards
        if sharded_l:
            my_cells = ncells // num_shards
            row_start = (jax.lax.axis_index(shard_axis).astype(jnp.int32)
                         * my_cells)
            cell_ids_l = jax.lax.dynamic_slice_in_dim(
                cell_ids_l, row_start, my_cells)
        xy = cell_coords(cell_ids_l, dim).astype(jnp.int32)  # [rows, D]
        parity = (xy & 1)  # [rows, D]
        w_l = W[l]

        def m2l_step(acc_l, idx, xy=xy, parity=parity, w_l=w_l,
                     side=side, scale_l=scale_l, l=l):
            delta = deltas_arr[idx]  # [D]
            K = K_leaf[idx] * scale_l  # [nD, nD]
            ok = jnp.ones((xy.shape[0],), bool)
            for d in range(dim):
                ok = ok & parity_arr[idx, d][parity[:, d]]
            src_xy = xy + delta[None, :]
            inb = jnp.all((src_xy >= 0) & (src_xy < side), axis=-1)
            ok = ok & inb
            src_ids = morton_key_from_coords(
                jnp.clip(src_xy, 0, side - 1).astype(jnp.uint32), l)\
                .astype(jnp.int32)
            w_src = w_l[src_ids] * ok[:, None]  # [ncells, nD]
            return acc_l + jnp.dot(
                w_src, K.T, preferred_element_type=dtype,
                precision=jax.lax.Precision.HIGHEST), None

        acc0 = jnp.zeros((xy.shape[0], nD), dtype)
        if "m2l" in _debug_skip:
            Lc[l] = acc0
            continue
        if sharded_l:
            # The carry becomes device-varying (rows depend on axis_index);
            # mark the init accordingly for shard_map's varying-axis typing.
            acc0 = jax.lax.pcast(acc0, shard_axis, to="varying")
        acc_l, _ = jax.lax.scan(
            m2l_step, acc0, jnp.arange(ndeltas, dtype=jnp.int32))
        if sharded_l:
            acc_l = jax.lax.all_gather(acc_l, shard_axis, tiled=True)
        Lc[l] = acc_l

    # ---- L2P: per-body, every level (no L2L pass; see multilevel_l2p) --
    # Contiguous sorted-body blocks, not the capacity-padded slot layout.
    # The [N, nD] local-weight gathers happen PER BLOCK: whole-array
    # gathers at N=5e6 3D order 8 (nD = 512) are ~10 GB of temporaries.
    def l2p_all():
        n_bodies = tree.n
        blk = 8192
        nb_l2p = -(-n_bodies // blk)
        # Padded tail indices clamp to the last body; their rows land in
        # the padded output region and are dropped by the final [:n].
        idx_b = jnp.minimum(
            jnp.arange(nb_l2p * blk, dtype=jnp.int32).reshape(nb_l2p, blk),
            n_bodies - 1)

        def one_block(ib):
            return multilevel_l2p(Lc, L, tree.leaf_ids[ib],
                                  tree.pos_sorted[ib], tree.lo, leaf_size_phys,
                                  n_cheb, Tt)

        acc = jax.lax.map(one_block, idx_b).reshape(-1, dim)
        return acc[:n_bodies]

    if "l2p" in _debug_skip:
        acc_far_sorted = jnp.zeros((tree.n, dim), dtype)
    else:
        acc_far_sorted = l2p_all()
    if shard_axis is not None:
        # Only this shard's leaf-chunk bodies may contribute (the final
        # psum sums shards): zero rows outside the chunk's body range.
        in_chunk = (tree.leaf_ids >= leaf_ids_all[0]) & \
                   (tree.leaf_ids <= leaf_ids_all[-1])
        acc_far_sorted = acc_far_sorted * in_chunk[:, None]

    # ---- P2P near field ------------------------------------------------
    if sparse:
        # Windowed ring P2P over the body chunks (sparse_grid pattern).
        from .sparse_grid import near_field_windows

        def p2p_chunk(args):
            cell_b, cstart_b, clen_b = args
            rows, _ = chunk_rows(cstart_b, clen_b)
            tpos = rows[..., :dim]  # garbage rows masked at the gather
            return near_field_windows(
                tree, cell_b, tpos, k=k, window=window,
                max_windows=max_windows, softening=softening)

        if "p2p" in _debug_skip:
            acc_near_sorted = jnp.zeros((tree.n, dim), dtype)
        else:
            accs = jax.lax.map(p2p_chunk, (cellA_b, cstartA_b, clenA_b))
            acc_flat = accs.reshape(-1, dim)  # [NTp·chunk, D]
            leaf = tree.leaf_ids
            within = (jnp.arange(tree.n, dtype=jnp.int32)
                      - tree.cell_start[leaf])
            chunk_of = coffsA[leaf] + within // chunk_size
            slot = within % chunk_size
            acc_near_sorted = acc_flat[chunk_of * chunk_size + slot]
        return acc_far_sorted + acc_near_sorted

    near_offs = jnp.asarray(_neighbor_offsets(dim, k))
    nnear = near_offs.shape[0]
    side_leaf = 1 << L

    def eval_batch(args):
        ids_b, centers_b = args
        del centers_b
        B = ids_b.shape[0]
        # Slot-free targets (see grid_tree._window_rows).
        tb, tidx, tvalid = _window_rows(tree, ids_b)  # [B, TWR, 4]
        pos = tb[..., :dim]

        # P2P over the leaf neighborhood (shared structure with BH grid).
        leaf_xy_b = cell_coords(ids_b.astype(jnp.uint32), dim)\
            .astype(jnp.int32)
        nb_xy = leaf_xy_b[:, None, :] + near_offs[None, :, :]
        nb_ok = jnp.all((nb_xy >= 0) & (nb_xy < side_leaf), axis=-1)
        nb_ids = morton_key_from_coords(
            jnp.clip(nb_xy, 0, side_leaf - 1).astype(jnp.uint32)
            .reshape(-1, dim), L).astype(jnp.int32).reshape(B, -1)
        sb, _, svalid = _window_rows(tree, nb_ids)  # [B, nnear, SWR, 4]
        svalid = svalid & nb_ok[:, :, None]
        spos = sb[..., :dim].reshape(B, -1, dim)
        smass = (sb[..., 3] * svalid).reshape(B, -1)
        acc_near = _point_mass_accel(pos, spos, smass, softening)

        if "p2p" in _debug_skip:
            acc_near = jnp.zeros_like(acc_near)
        del tidx, tvalid
        return acc_near

    accs = jax.lax.map(eval_batch, (ids_b, cen_b))
    # Window layout → sorted order is a pure GATHER (see grid_tree).
    twr = (C // 8 + 1) * 8
    acc_flat = accs.reshape(-1, dim)  # [my_leaves·TWR, dim]
    chunk0 = leaf_ids_all[0]
    src = (tree.leaf_ids - chunk0) * twr + tree.window_slot  # [N]
    in_chunk = (tree.leaf_ids >= chunk0) & \
               (tree.leaf_ids < chunk0 + my_leaves)
    acc_near_sorted = acc_flat[jnp.where(in_chunk, src, 0)] \
        * in_chunk[:, None]
    out = acc_far_sorted + acc_near_sorted
    if shard_axis is not None:
        out = jax.lax.psum(out, shard_axis)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("leaf_level", "capacity", "order", "ring",
                     "softening", "leaf_batch", "num_chunks",
                     "chunk_size", "window", "max_windows"))
def _fmm_fused(positions, masses, g, *, leaf_level, capacity, order, ring,
               softening, leaf_batch, num_chunks=None,
               chunk_size=64, window=8, max_windows=0):
    """Build + 6-phase pipeline + unsort + G-scale as ONE device program
    (no eager glue ops between phases, as in grid_tree._bh_grid_fused)."""
    tree = build_grid_tree(positions, masses, leaf_level, capacity,
                           agg_num_chunks=num_chunks,
                           agg_chunk_size=chunk_size)
    acc_sorted = fmm_accel_sorted(
        tree, order=order, ring=ring, softening=softening,
        leaf_batch=leaf_batch, num_chunks=num_chunks,
        chunk_size=chunk_size, window=window, max_windows=max_windows)
    acc = jnp.zeros_like(acc_sorted).at[tree.order].set(acc_sorted)
    return (g * masses)[:, None] * acc


def fmm_forces(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    order: int = 5,
    leaf_level: Optional[int] = None,
    capacity: Optional[int] = None,
    ring: int = 1,
    leaf_batch: int = 1024,
    layout: str = "auto",
) -> jax.Array:
    """Per-body forces via black-box FMM. API parity: fmm_*_n_body
    (methods.h:66-82) with order as a static shape parameter (fixes §8.3).

    ``layout``: "dense" is the capacity-padded P2M/P2P (fastest on
    quasi-uniform inputs; refuses degenerate capacities); "sparse" chunks
    targets and windows ring sources (ops/sparse_grid.py pattern) so no
    tensor scales with the max leaf occupancy; "auto" (default) picks
    dense and falls back to sparse when the capacity guard would trip.
    """
    n, dim = positions.shape
    if dim == 3 and n >= 5_000_000:
        # Shrinking the batch shrinks every per-level intermediate; N=5e6
        # 3D failed to compile at the default batch and at 512 on the
        # previous accelerator (4M 3D compiled at the default). To be
        # re-checked against the GPU's memory (ROADMAP).
        leaf_batch = min(leaf_batch, 256)
    if leaf_level is None:
        leaf_level = auto_leaf_level(n, dim)
    g = jnp.asarray(config.G, positions.dtype)
    sparse = layout == "sparse"
    if capacity is None and not sparse:
        capacity = compute_capacity_cached(positions, leaf_level)
        if layout == "auto" and dense_layout_degenerate(
                capacity, n, leaf_level, dim):
            sparse = True
        else:
            check_grid_capacity(capacity, n, leaf_level, dim,
                                "fmm_forces")
    if sparse:
        from .sparse_grid import sparse_grid_stats
        chunk_size, window = 64, 8
        num_chunks, max_windows = sparse_grid_stats(
            positions, leaf_level, chunk_size, window, ring)
        return _fmm_fused(
            positions, masses, g, leaf_level=leaf_level, capacity=8,
            order=order, ring=ring, softening=float(config.softening),
            leaf_batch=leaf_batch,
            num_chunks=num_chunks, chunk_size=chunk_size, window=window,
            max_windows=max_windows)
    return _fmm_fused(
        positions, masses, g, leaf_level=leaf_level, capacity=capacity,
        order=order, ring=ring, softening=float(config.softening),
        leaf_batch=leaf_batch)
