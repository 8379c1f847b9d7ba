"""Hierarchical order-3 Taylor far field for the grid Barnes-Hut tier.

The per-leaf V-list far field (``grid_tree.far_field_rings``) re-gathers the
ancestor's ring candidates FOR EVERY LEAF AT EVERY LEVEL — at θ=0.25 in 3D
that is (levels−1) × num_leaves × 2744 row gathers, and the gathers, not
the arithmetic, dominated the far field on the previous accelerator (to be
re-measured on the GPU — ROADMAP). This module restructures the
far field as the classical FMM downward pass, specialized to the BH tier's
monopole+quadrupole sources and an order-3 *Taylor* local expansion
(ops/local_expansion.py), so every level's candidate data is gathered ONCE
PER PARENT CELL (shared by its 2^D children) instead of once per leaf:

  for level l = 2..L:
    gather each level-(l−1) parent's ring children (the V-list superset,
      (2k+1)^D·2^D rows) — 8^(l−1) × 2744 rows total, not 8^L × 2744;
    per child parity (static unroll), split the V-list by Chebyshev shell:
      shells ≥ c_min  → accumulate (a0, J, H, K) at the CHILD's center
                        (worst Taylor ratio √D/(2·c_min) ≤ local_ratio);
      inner shells (k < c < c_min) → defer one level DOWN: accumulate at
                        the child's children's centers, where the ratio
                        tightens to ~√D/(2(2c−1)) ≈ 0.124 — except at the
                        leaf level, where they stay per-body (the
                        "local_leaf" shell split, e.g. just shell 4 of
                        ~2744 candidates at k=3 in 3D);
    L2L-shift the parent coefficients to the child centers (exact
      polynomial re-centering, local_expansion.shift_local) and add.

Per-body far-field work drops to one order-3 Taylor evaluation plus the
inner-shell quad sum; total far-field gather volume drops ~(levels−1)·7×.
The MAC geometry (ring radius k ⇒ θ_eff = 1/(k+1)) and the quad source
truncation are IDENTICAL to the per-leaf evaluation — only where each
accepted cell's field is expanded changes, within the same gated Taylor
ratios as ``far_impl="local"``/"local_leaf" — so accuracy is the measured
99.6-99.7% class (reference metric) of those modes.

Reference parity: this implements the same far-field physics as the
recursive per-body MAC walk (``octree.cpp:97-162``) with the acceptance
geometry of ``octree.cpp:146``; the hierarchical expansion merely
re-associates the sum.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .grid_tree import GridTree, _ring_offsets, cell_coords
from .keys import morton_key_from_coords
from .local_expansion import (LOCAL_RATIO_DEFAULT, local_coeffs, num_coeffs,
                              num_coeffs3, shift_local)


def _par_vec(pm: int, dim: int) -> np.ndarray:
    """Morton child-parity index → per-axis {0,1} offsets.

    Matches ``cell_coords``'s bit layout: axis d's LSB is id bit (dim−1−d),
    so child id = parent id · 2^D + pm with these offsets.
    """
    return np.array([(pm >> (dim - 1 - d)) & 1 for d in range(dim)],
                    np.int32)


@functools.lru_cache(maxsize=None)
def _parity_shell_sel(dim: int, k: int, c_min: int):
    """Static per-parity candidate splits of the ring-children table.

    Returns (own, dfr, dfr_pad): for each child parity pm,
      own[pm] — candidate indices at Chebyshev shell ≥ c_min (local at the
                child's own center),
      dfr[pm] — indices with k < shell < c_min (deferred a level down),
      dfr_pad — (idx [2^D, md], valid [2^D, md]) rectangular padded version
                of dfr for stacking the leaf-level per-body tensors.
    """
    cands, _ = _ring_offsets(dim, k)
    own, dfr = [], []
    for pm in range(1 << dim):
        cheb = np.abs(cands - _par_vec(pm, dim)).max(axis=1)
        own.append(np.where(cheb >= c_min)[0].astype(np.int32))
        dfr.append(np.where((cheb > k) & (cheb < c_min))[0].astype(np.int32))
    md = max((len(s) for s in dfr), default=0)
    idx = np.zeros((1 << dim, md), np.int32)
    valid = np.zeros((1 << dim, md), np.float32)
    for pm, s in enumerate(dfr):
        idx[pm, : len(s)] = s
        valid[pm, : len(s)] = 1.0
    return own, dfr, (idx, valid)


@functools.lru_cache(maxsize=None)
def leaf_defer_tables(dim: int, k: int, local_ratio: Optional[float] = None):
    """Static per-parity leaf-level deferred-shell offset tables.

    Returns (offs [2^D, md, D] int32, valid [2^D, md] f32): for a leaf of
    Morton parity pm (pm = leaf_id & (2^D − 1)), the deferred inner far
    shells (k < Chebyshev < c_min, the same split ``hier_far_coeffs``'s
    sweep uses) sit at leaf-cell offsets ``offs[pm]`` in LEAF units —
    cands are parent-aligned (parent_xy·2 + cand), the leaf is at
    parent_xy·2 + par_vec, so the offset is cand − par_vec. Used by the
    traversal-side ``defer="gather"`` mode (grid_tree.py), which gathers
    these cells per leaf batch instead of materializing the [G, md·(D+1)]
    pack tensors the sweep would otherwise emit (the N=5e6 3D L=6
    out-of-memory: ~4 GB of dfr outputs plus their per-chunk stack
    intermediates).
    """
    if local_ratio is None:
        local_ratio = LOCAL_RATIO_DEFAULT
    c_min = max(math.ceil(dim ** 0.5 / (2.0 * local_ratio)), k + 1)
    _, dfr_sel, (dfr_idx, dfr_valid) = _parity_shell_sel(dim, k, c_min)
    cands, _ = _ring_offsets(dim, k)
    nch, md = dfr_idx.shape[0], dfr_idx.shape[1]
    offs = np.zeros((nch, md, dim), np.int32)
    for pm in range(nch):
        offs[pm] = cands[dfr_idx[pm]] - _par_vec(pm, dim)[None, :]
    return offs, dfr_valid


def hier_far_coeffs(
    tree: GridTree,
    k: int,
    multipole: str = "quad",
    local_ratio: Optional[float] = None,
    chunk_budget: int = 16_000_000,
    defer: str = "pack",
) -> Tuple[Tuple[jax.Array, ...], jax.Array, Optional[jax.Array]]:
    """Run the downward sweep. Returns (coeffs, dfr_pack, dfr_quad):

    coeffs — (a0 [G, D], J [G, nj], H [G, nh], K [G, nk]) order-3 local
      expansions at every dense leaf cell's geometric center (G leaves),
      covering every V-list level's shells ≥ the deferral gate;
    dfr_pack — [G, md·(D+1)] = flattened (com | mass) of each leaf's inner
      far shells (k < cheb < c_min), masses pre-zeroed for out-of-bounds /
      padding — these must be evaluated per body (quad or point to match
      ``multipole``). FLAT on purpose: a tiled memory layout can pad the
      small trailing (md, 4) dims of a [G, md, D+1] buffer many times
      over; the flat 2D layout pads little. Callers reshape per leaf
      batch.
    dfr_quad — [G, md·nq] matching flattened second moments, or None.

    Large levels are swept in parent chunks via ``lax.map``: the leaf-level
    candidate gather is [P, (2k+1)^D·2^D, 4] — at L=6 3D that is 90M rows,
    too large to materialize whole (N=5e6 3D θ=0.25).

    ``defer="gather"`` suppresses the per-leaf dfr outputs entirely
    (returns (coeffs, [G, 0], None)): the caller evaluates the leaf-level
    inner far shells itself by gathering ``leaf_defer_tables`` cells per
    leaf batch. That is how the L=6 3D sweep fits device memory at all —
    even chunked, the stacked [G, md·(D+1)] + [G, md·nq] pack outputs are
    ~4 GB at N=5e6 3D, before their per-chunk stack intermediates.
    """
    dim, L = tree.dim, tree.leaf_level
    dt = tree.pos_sorted.dtype
    if local_ratio is None:
        local_ratio = LOCAL_RATIO_DEFAULT
    # Clamp to k+1: shells ≤ k are the NEAR ring (the P2P pass owns them).
    # Without the clamp, wide rings (k ≥ 4 in 2D, k ≥ 5 in 3D) counted
    # near cells as far-field "own" shells — double counting (measured:
    # θ=0.125 L=3 2D error 2.6e-2 vs 4e-15 for far_impl="local").
    c_min = max(math.ceil(dim ** 0.5 / (2.0 * local_ratio)), k + 1)
    own_sel, dfr_sel, (dfr_idx, dfr_valid) = _parity_shell_sel(dim, k, c_min)
    cand_offs = jnp.asarray(_ring_offsets(dim, k)[0])
    nch = 1 << dim
    _, nj, nh = num_coeffs(dim)
    nk = num_coeffs3(dim)
    quad = multipole == "quad"

    coeffs = None  # (a0, J, H, K) at current-level cell centers [C_l, ...]
    pre = None  # deferred contributions awaiting the next level [C_{l+1}, .]
    dfr_pack = dfr_quad = None
    md = dfr_idx.shape[1]
    if defer == "gather":
        md = 0  # leaf-level inner shells handled caller-side (see docstring)
    # chunk_budget: per-chunk candidate-gather budget (parents ×
    # candidates). The 16M default ≈ one whole level at N=2e6 3D
    # ([4096, 2744, 4]); the 90M-row L=6 level (46 GB tiled) is swept in
    # 4096-parent chunks instead. To be re-sized for the 80 GB card.

    for l in range(2, L + 1):
        P = 1 << (dim * (l - 1))
        nc = int(cand_offs.shape[0])
        h_l = tree.cell_sizes[l].astype(dt)  # [D]

        def level_fn(pidx, *, _l=l, _coeffs=coeffs):
            """Per-parent-chunk sweep body; pidx [Pc] int32 parent ids."""
            Pc = pidx.shape[0]
            parent_xy = cell_coords(pidx.astype(jnp.uint32), dim)\
                .astype(jnp.int32)
            cand_xy = parent_xy[:, None, :] * 2 + cand_offs[None, :, :]
            in_b = jnp.all((cand_xy >= 0) & (cand_xy < (1 << _l)), axis=-1)
            cand_ids = morton_key_from_coords(
                jnp.clip(cand_xy, 0, (1 << _l) - 1).astype(jnp.uint32)
                .reshape(-1, dim), _l).astype(jnp.int32).reshape(Pc, -1)
            cpack = tree.level_pack[_l][cand_ids]  # [Pc, nc, 4]
            cmass = cpack[..., 3] * in_b
            ccom = cpack[..., :dim]
            cquad = (tree.level_quad[_l][cand_ids] * in_b[..., None]
                     if quad else None)

            parent_center = tree.lo.astype(dt) + \
                (parent_xy.astype(dt) + 0.5) \
                * tree.cell_sizes[_l - 1].astype(dt)

            # (b) shells >= c_min at each child's own center (static
            # per-parity candidate subsets; 2^D unrolled local_coeffs).
            per_par = []
            for pm in range(nch):
                child_center = parent_center + \
                    (jnp.asarray(_par_vec(pm, dim), dt) - 0.5) * h_l
                sel = own_sel[pm]
                a0, J, H, K = local_coeffs(
                    child_center, ccom[:, sel], cmass[:, sel],
                    cquad[:, sel] if quad else None, order3=True)
                per_par.append((a0, J, H, K))
            level_c = tuple(
                jnp.stack([t[i] for t in per_par], axis=1)
                .reshape(Pc * nch, per_par[0][i].shape[-1])
                for i in range(4))

            # L2L: shift the accumulated parent expansions (rows gathered
            # for this chunk) to child centers.
            if _coeffs is not None:
                prows = tuple(c[pidx] for c in _coeffs)
                shifted = []
                for pm in range(nch):
                    delta = (jnp.asarray(_par_vec(pm, dim), dt) - 0.5) * h_l
                    shifted.append(shift_local(*prows, delta))
                down = tuple(
                    jnp.stack([t[i] for t in shifted], axis=1)
                    .reshape(Pc * nch, shifted[0][i].shape[-1])
                    for i in range(4))
                level_c = tuple(a + b for a, b in zip(level_c, down))

            # (c) inner far shells (k < cheb < c_min).
            if _l < L:
                if not any(s.size for s in dfr_sel):
                    return level_c
                # Defer one level down: expand at the child's children's
                # centers (ratio tightens to ~√D/(2(2c−1))). The 2^D
                # grandchild centers ride one batched call per parity.
                h_next = tree.cell_sizes[_l + 1].astype(dt)
                gc_offs = jnp.stack(
                    [(jnp.asarray(_par_vec(pm2, dim), dt) - 0.5) * h_next
                     for pm2 in range(nch)])  # [nch, D]
                pre_par = []
                for pm in range(nch):
                    sel = dfr_sel[pm]
                    child_center = parent_center + \
                        (jnp.asarray(_par_vec(pm, dim), dt) - 0.5) * h_l
                    gc_centers = child_center[:, None, :] + gc_offs[None]
                    a0, J, H, K = local_coeffs(
                        gc_centers,  # [Pc, nch, D]
                        ccom[:, None, sel], cmass[:, None, sel],
                        cquad[:, None, sel] if quad else None, order3=True)
                    pre_par.append((a0, J, H, K))  # each [Pc, nch, ·]
                pre_c = tuple(
                    jnp.stack([t[i] for t in pre_par], axis=1)
                    .reshape(Pc * nch * nch, pre_par[0][i].shape[-1])
                    for i in range(4))
                return level_c + pre_c
            # Leaf level: the inner shells stay per-body. Static-select
            # the padded per-parity subsets from the shared parent gather,
            # interleave back to leaf-major Morton order, and FLATTEN the
            # trailing dims (see docstring: tile-padding economics).
            if not md:
                return level_c
            packs, quads = [], []
            for pm in range(nch):
                sel = dfr_idx[pm]
                v = jnp.asarray(dfr_valid[pm], dt)
                pm_mass = cmass[:, sel] * v
                packs.append(jnp.concatenate(
                    [ccom[:, sel], pm_mass[..., None]], axis=-1))
                if quad:
                    quads.append(cquad[:, sel] * v[:, None])
            out = level_c + (jnp.stack(packs, axis=1).reshape(
                Pc * nch, md * (dim + 1)),)
            if quad:
                out = out + (jnp.stack(quads, axis=1).reshape(
                    Pc * nch, md * quads[0].shape[-1]),)
            return out

        all_pidx = jnp.arange(P, dtype=jnp.int32)
        if P * nc <= chunk_budget or P < 2:
            outs = level_fn(all_pidx)
        else:
            chunk = max(1, chunk_budget // nc)
            chunk = min(P, 1 << (chunk.bit_length() - 1))  # pow2 divides P
            outs = jax.lax.map(level_fn, all_pidx.reshape(-1, chunk))
            outs = tuple(o.reshape((-1,) + o.shape[2:]) for o in outs)

        level_c = outs[:4]
        if pre is not None:
            level_c = tuple(a + b for a, b in zip(level_c, pre))
        coeffs = level_c
        if l < L:
            pre = outs[4:8] if len(outs) > 4 else None
        elif md:
            dfr_pack = outs[4]
            if quad:
                dfr_quad = outs[5]

    if coeffs is None:  # L < 2: no far field at all
        G = tree.num_leaf_cells
        coeffs = (jnp.zeros((G, dim), dt), jnp.zeros((G, nj), dt),
                  jnp.zeros((G, nh), dt), jnp.zeros((G, nk), dt))
    if dfr_pack is None:
        dfr_pack = jnp.zeros((tree.num_leaf_cells, 0), dt)
    return coeffs, dfr_pack, dfr_quad
