"""Hilbert-BVH tier: binary radix tree built on device, stackless traversal.

The reference's BVH (``bvh.h``/``bvh.cpp``) is a serially built binary tree
(recursive longest-axis median split with std::sort, ``bvh.cpp:35-73``) whose
README-claimed Hilbert ordering was never implemented (``README.md:41-46``,
SURVEY.md §8.5) and whose far-field drops whole subtrees when both children
are internal (mass aggregated only from leaf children, ``bvh.cpp:221-222`` —
§8.2). This tier delivers the *intended* design, as array programs:

* **Hilbert order for real**: bodies are sorted by exact Hilbert keys
  (ops/keys.py), so tree ranges are spatially compact segments of the curve.
* **Karras (2012) parallel radix build**: all N−1 internal nodes are
  computed independently from longest-common-prefix relations of adjacent
  keys — O(N log N) flat jnp bit arithmetic, no recursion, no insertion
  order, duplicate keys broken by index bits.
* **Node summaries without a bottom-up pass**: a Karras node covers a
  *contiguous* range [l, r] of sorted bodies, so node mass and COM are two
  prefix-sum lookups and the node's exact AABB is two sparse-table
  range-min/max lookups (both O(N log N) dense builds). Mass/COM/extent are
  exact per node — fixing §8.2 by construction. (Round 1 bounded the extent
  by the Hilbert-prefix cell instead; ranges straddling high-level cell
  boundaries got a near-domain-sized bound, failed the MAC everywhere, and
  blew up traversal work — the exact AABB removes that.)
* **Frontier-expansion traversal**: per group of contiguous Hilbert-sorted
  bodies, the candidate nodes of one tree level are classified *together*
  (MAC accept → inline monopole; ≤leaf_size bodies → near list; else expand
  both children), finishing in O(depth) dense iterations — the "vectorized,
  pointer-free frontier expansion" of the BASELINE north star, replacing
  both the reference recursion (``bvh.cpp:144-249``) and round 1's serial
  escape-pointer walk (gather-latency-bound: one node per step). Row
  gathers cost per row more than per byte, so all per-node fields are
  packed into one f32 row table and the walk does ONE gather per node;
  compaction uses jnp.sort rather than scatters (``_INVALID`` = int32 max
  sorts to the end); empty frontier chunks are skipped with scalar
  ``lax.cond``. These costs were measured on the previous accelerator and
  are to be re-measured on the GPU (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_GRAVITY, GravityConfig
from .brute_force import _DIST2_GUARD
from .grid_tree import _quad_pairs
from .keys import MAX_BITS, hilbert_key

# NOTE: must stay a NumPy scalar, NOT jnp.int32 — a module-scope jnp op
# eagerly initializes the default backend at import time, which breaks a
# bare `import __graft_entry__` before it provisions its CPU mesh
# (tests/test_import_no_backend.py guards the whole package against this).
_INVALID = np.int32(2_147_483_647)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BVHTree:
    """Flattened radix BVH over Hilbert-sorted bodies (unified node space:
    ids 0..N-2 internal, N-1..2N-2 single-body leaves)."""

    key_bits: int = dataclasses.field(metadata=dict(static=True))

    order: jax.Array  # [N] sorted-slot -> original index
    pos_sorted: jax.Array  # [N, D]
    mass_sorted: jax.Array  # [N]

    range_l: jax.Array  # [2N-1] first sorted body of node
    range_r: jax.Array  # [2N-1] last sorted body of node
    left: jax.Array  # [2N-1] left child (unified id; leaves: self)
    right: jax.Array  # [2N-1] right child (unified id; leaves: self)
    node_mass: jax.Array  # [2N-1]
    node_com: jax.Array  # [2N-1, D]
    node_size: jax.Array  # [2N-1] exact AABB max extent

    # Hot-path packed layouts (one row gather per node / per body — row
    # gathers cost per ROW more than per byte):
    # node_table[v] = [l, r, left, right, size, mass, com..., quad...] as
    # f32 (indices < 2^24 are exact in f32; build asserts N <= 8M). The
    # quad columns (COM-centered second moments, nq = 3 in 2D / 6 in 3D)
    # are present only when built with quad=True.
    node_table: jax.Array  # [2N-1, 8|12 mono; 12|16 quad]
    body_table: jax.Array  # [N, 4] = [x, y, z|0, mass]

    @property
    def n(self) -> int:
        return self.pos_sorted.shape[0]


def _delta(keys, idx, i, j, n, total_bits):
    """Common-prefix length of (key, index) pairs at i and j; −1 out of range.

    Duplicate keys are disambiguated by index bits (Karras §4), so the tree
    is well-formed for any input.
    """
    valid = (j >= 0) & (j < n)
    j_c = jnp.clip(j, 0, n - 1)
    kx = keys[i] ^ keys[j_c]
    ix = (idx[i] ^ idx[j_c]).astype(jnp.uint32)
    d = jnp.where(kx != 0,
                  jax.lax.clz(kx).astype(jnp.int32),
                  32 + jax.lax.clz(ix).astype(jnp.int32))
    return jnp.where(valid, d, -1)


@functools.partial(jax.jit,
                   static_argnames=("key_bits", "quad", "varying_axis"))
def build_bvh(positions: jax.Array, masses: jax.Array,
              key_bits: int, quad: bool = False,
              varying_axis: Optional[str] = None) -> BVHTree:
    """``varying_axis``: shard_map axis name when building per-chip trees
    inside a per-shard program (parallel/let_bvh.py). Accepted for that
    call site's benefit but currently unused — the quad combine is a
    fully unrolled segment-tree pass with no while_loop carries, so
    nothing needs a pcast."""
    n, dim = positions.shape
    keys = hilbert_key(positions, bits=key_bits // dim)
    # Left-align keys so clz of the XOR measures the true common prefix.
    keys = (keys << (32 - key_bits)).astype(jnp.uint32)
    order = jnp.argsort(keys)
    keys_s = keys[order]
    pos_s = positions[order]
    mass_s = masses[order]
    idx = jnp.arange(n, dtype=jnp.int32)

    # --- Radix-tree structure via ANSV over adjacent-pair deltas --------
    # The Karras radix tree IS the Cartesian tree (min at root) of
    # D[g] = common-prefix length of adjacent sorted (key, index) pairs —
    # all values distinct because ties fall through to index bits. Node g
    # covers bodies (L(g), R(g)] where L/R are the nearest gaps with a
    # SMALLER delta on each side, and splits at gap g itself. Each side is
    # one all-nearest-smaller-values binary descent over a sparse range-min
    # table: ~2·log2(N) single-gather rounds total, replacing Karras's
    # three search phases (exponential bound + range end + split position,
    # ~3·log2(N) rounds of double-gather probes — once the dominant build
    # cost).
    i = idx[: n - 1]
    Dg = _delta(keys_s, idx, i, i + 1, n, key_bits)  # [n-1], all distinct
    m = n - 1
    K = max(1, math.ceil(math.log2(max(m, 2)))) + 1
    big_d = jnp.int32(jnp.iinfo(jnp.int32).max)
    # tab[k][j] = min(D[j .. j+2^k-1]) (out-of-range → +inf)
    tab = [Dg]
    for kk in range(1, K):
        sh = 1 << (kk - 1)
        prev = tab[-1]
        tab.append(jnp.minimum(
            prev, jnp.concatenate([prev[sh:], jnp.full((sh,), big_d,
                                                       jnp.int32)])))

    # Left ANSV: smallest p with D[p..g-1] all >= D[g]; L(g) = p-1 (or -1).
    p = i
    for kk in range(K - 1, -1, -1):
        start = p - (1 << kk)
        ok = (start >= 0) & (tab[kk][jnp.maximum(start, 0)] >= Dg)
        p = jnp.where(ok, jnp.maximum(start, 0), p)
    lo = p  # range_l[g] = L(g) + 1 = p
    # Right ANSV: largest q with D[g+1..q] all >= D[g]; R(g) = q+1 capped.
    q = i + 1
    for kk in range(K - 1, -1, -1):
        ok = (q + (1 << kk) - 1 <= m - 1) & \
             (tab[kk][jnp.minimum(q, m - 1)] >= Dg)
        q = jnp.where(ok, q + (1 << kk), q)
    hi = jnp.minimum(q, n - 1)  # range_r[g] (bodies l..r; root gets n-1)

    # Renumber into Karras order — node i's index is the range end adjacent
    # to its parent's split gap (root = 0) — so the original endpoint child
    # formulas hold verbatim and the tree is BIT-IDENTICAL to the Karras
    # search construction (tools/verified round 3: trees equal field-for-
    # field on random + duplicate-key inputs). The parent gap is whichever
    # enclosing smaller-delta gap has the LARGER delta (nearer ancestor).
    d_lo = jnp.where(lo > 0, Dg[jnp.maximum(lo - 1, 0)], -1)
    d_hi = jnp.where(hi < n - 1, Dg[jnp.minimum(hi, m - 1)], -1)
    parent_is_right = d_hi > d_lo  # parent gap = hi (right) vs lo-1 (left)
    kid = jnp.where(parent_is_right, hi, lo)  # Karras id of this node
    packed = jnp.stack([lo, hi, i], axis=1)
    unpacked = jnp.zeros((max(m, 1), 3), jnp.int32).at[kid].set(packed)
    lo, hi, gamma = unpacked[:m, 0], unpacked[:m, 1], unpacked[:m, 2]
    # Unified ids: internal node k -> k, leaf body b -> (n-1) + b.
    left_child = jnp.where(lo == gamma, (n - 1) + gamma, gamma)
    right_child = jnp.where(hi == gamma + 1, (n - 1) + gamma + 1, gamma + 1)

    num_nodes = 2 * n - 1
    leaf_ids = (n - 1) + idx
    range_l = jnp.concatenate([lo, idx])
    range_r = jnp.concatenate([hi, idx])
    left = jnp.concatenate([left_child, leaf_ids])
    right_all = jnp.concatenate([right_child, leaf_ids])

    # Mass / COM per node from prefix sums over the contiguous range.
    # f32 hazard (hit at N=2e4 in reference units): adjacent cumsum entries
    # at ~1e12 magnitude can round a single body's mass difference to
    # EXACTLY 0 while the m·x difference stays nonzero — mx/1e-30 then
    # yields an inf COM, and 0·inf = NaN poisons anything COM-centered
    # (the quadrupole combine). Clamp the mass at 0 (cumsum differences
    # can also round slightly negative) and give massless nodes their
    # first body's position as a harmless, spatially-sane COM.
    zero = jnp.zeros((1,), pos_s.dtype)
    cmass = jnp.concatenate([zero, jnp.cumsum(mass_s)])
    cmpos = jnp.concatenate([jnp.zeros((1, dim), pos_s.dtype),
                             jnp.cumsum(mass_s[:, None] * pos_s, axis=0)])
    node_mass = jnp.maximum(cmass[range_r + 1] - cmass[range_l], 0.0)
    node_mx = cmpos[range_r + 1] - cmpos[range_l]
    node_com = jnp.where(
        (node_mass > 0)[:, None],
        node_mx / jnp.maximum(node_mass, 1e-30)[:, None],
        pos_s[range_l])

    # Exact per-node AABB extent via a sparse range-min/max table: any
    # contiguous range [l, r] is the union of the two (possibly overlapping)
    # aligned windows of width 2^k at l and r+1-2^k, k = floor(log2(count)).
    K = max(1, math.ceil(math.log2(max(n, 2)))) + 1
    mns, mxs = [pos_s], [pos_s]
    big = jnp.asarray(jnp.finfo(pos_s.dtype).max, pos_s.dtype)
    for kk in range(1, K):
        sh = 1 << (kk - 1)
        prev_mn, prev_mx = mns[-1], mxs[-1]
        pad_mn = jnp.full((sh, dim), big, pos_s.dtype)
        mns.append(jnp.minimum(
            prev_mn, jnp.concatenate([prev_mn[sh:], pad_mn])))
        mxs.append(jnp.maximum(
            prev_mx, jnp.concatenate([prev_mx[sh:], -pad_mn])))
    mn_tab = jnp.stack(mns)  # [K, N, D]
    mx_tab = jnp.stack(mxs)
    count_all = range_r - range_l + 1
    klog = jnp.floor(
        jnp.log2(count_all.astype(jnp.float32)) + 1e-6).astype(jnp.int32)
    klog = jnp.clip(klog, 0, K - 1)
    hi_start = range_r + 1 - (1 << klog)
    flat_mn = mn_tab.reshape(K * n, dim)
    flat_mx = mx_tab.reshape(K * n, dim)
    aabb_min = jnp.minimum(flat_mn[klog * n + range_l],
                           flat_mn[klog * n + hi_start])
    aabb_max = jnp.maximum(flat_mx[klog * n + range_l],
                           flat_mx[klog * n + hi_start])
    node_size = jnp.max(aabb_max - aabb_min, axis=-1)  # [2N-1]

    # COM-centered second moments for the quadrupole far field. Raw
    # prefix sums of m·x_a·x_b from the global origin cancel catastrophically
    # in f32 at the reference's 1e7-scale coordinates (S/M2 ~ (extent/|x|)²
    # can be < 1e-6), so S must be accumulated from centered quantities
    # only, and mass/COM must be self-consistent with it: at N≥1e5 the m·x
    # cumsum reaches ~1e12-scale magnitudes, so a small node's prefix-sum
    # difference carries an absolute COM error that can rival its own
    # extent. The monopole tolerates that jitter (relative force error
    # ~ δ/r), but the parallel-axis combine does not (measured: BVH-quad
    # NormError 1.6e-3 vs mono 6.5e-5 at N=2e5 2D; reference Accuracy(%)
    # 68.7%).
    #
    # Implementation: a segment tree of aligned power-of-two blocks over
    # the sorted bodies. Level k is built from level k−1 by a CONTIGUOUS
    # pairwise parallel-axis combine (reshape, no gathers — the same
    # windowed-local pattern as grid_tree.reduce_levels, O(log N · eps)
    # error). Every Karras node covers a contiguous range [l, r], which
    # the standard iterative segment-tree query covers with ≤ 2 aligned
    # blocks per level; each node accumulates its ≤ 2(K+1) blocks about a
    # provisional center inside its own AABB (its first body), then
    # recenters once to the exact COM — all arithmetic stays at node
    # scale. This replaces the previous bottom-up readiness relaxation
    # (~tree-depth sequential rounds of [2N−1]-row gathers, once the
    # dominant build cost) with K+1 data-independent masked gather rounds
    # ((m, com, S) are packed into one row, so each block is ONE gather).
    node_quad = None
    if quad:
        qpairs = _quad_pairs(dim)
        nq = len(qpairs)
        dt = pos_s.dtype
        K = max(1, math.ceil(math.log2(max(n, 2))))
        P = 1 << K
        pad = P - n

        def _dd(d):
            return jnp.stack([d[..., a] * d[..., b] for a, b in qpairs],
                             axis=-1)

        # Level build: packed rows [m, com(D), S(nq)].
        m_k = jnp.concatenate([mass_s, jnp.zeros((pad,), dt)])
        c_k = jnp.concatenate(
            [pos_s, jnp.broadcast_to(pos_s[-1:], (max(pad, 0), dim))])
        S_k = jnp.zeros((P, nq), dt)
        tabs = [jnp.concatenate([m_k[:, None], c_k, S_k], axis=-1)]
        for _ in range(K):
            mp = m_k.reshape(-1, 2)
            cp = c_k.reshape(-1, 2, dim)
            Sp = S_k.reshape(-1, 2, nq)
            m_k = mp[:, 0] + mp[:, 1]
            mx = mp[:, 0, None] * cp[:, 0] + mp[:, 1, None] * cp[:, 1]
            c_k = jnp.where((m_k > 0)[:, None],
                            mx / jnp.maximum(m_k, 1e-30)[:, None],
                            cp[:, 0])
            S_k = (Sp[:, 0] + mp[:, 0, None] * _dd(cp[:, 0] - c_k)
                   + Sp[:, 1] + mp[:, 1, None] * _dd(cp[:, 1] - c_k))
            tabs.append(
                jnp.concatenate([m_k[:, None], c_k, S_k], axis=-1))
        offs = np.cumsum([0] + [t.shape[0] for t in tabs])[:-1]
        tab = jnp.concatenate(tabs, axis=0)  # [2P-1, 1+D+nq]

        # Iterative segment-tree cover of [l, r+1) per internal node,
        # accumulated about the node's first body position. The query runs
        # as a lax.map over fixed node blocks: unchunked, the 2(K+1)
        # per-level [n-1, 1+D+nq] gather temporaries all stay live and
        # ran out of device memory at N=5e6 3D (20+ 300 MB buffers —
        # round-2 sweep failure); blocks bound the working set to a few
        # MB while the (one-block) program compiles once.
        nb_int = n - 1
        B = min(1 << 18, max(1, nb_int))
        padded = -(-nb_int // B) * B if nb_int else B
        pad_rows = padded - nb_int

        def _pad(x, fill):
            return jnp.concatenate(
                [x, jnp.full((pad_rows,) + x.shape[1:], fill, x.dtype)]) \
                if pad_rows else x

        # Pad with the empty range [0, 0) -> no blocks taken, M = 0.
        lo_b = _pad(lo, 0).reshape(-1, B)
        hi_b = _pad(hi + 1, 0).reshape(-1, B)
        cr_b = _pad(pos_s[lo], 0.0).reshape(-1, B, dim)

        def _query_block(args):
            lo_k, hi_k, c_ref = args
            M = jnp.zeros((B,), dt)
            Pm = jnp.zeros((B, dim), dt)
            Sa = jnp.zeros((B, nq), dt)
            for k in range(K + 1):
                c1 = (lo_k < hi_k) & ((lo_k & 1) == 1)
                i1 = offs[k] + lo_k
                lo_k = lo_k + c1.astype(lo_k.dtype)
                c2 = (lo_k < hi_k) & ((hi_k & 1) == 1)
                hi_k = hi_k - c2.astype(hi_k.dtype)
                i2 = offs[k] + hi_k
                for cond, ib in ((c1, i1), (c2, i2)):
                    row = tab[jnp.clip(ib, 0, tab.shape[0] - 1)]
                    mb = jnp.where(cond, row[:, 0], 0.0)
                    d = jnp.where(cond[:, None],
                                  row[:, 1:1 + dim] - c_ref, 0.0)
                    M = M + mb
                    Pm = Pm + mb[:, None] * d
                    Sa = (Sa + jnp.where(cond[:, None],
                                         row[:, 1 + dim:], 0.0)
                          + mb[:, None] * _dd(d))
                lo_k = lo_k >> 1
                hi_k = hi_k >> 1
            return M, Pm, Sa

        M, Pm, Sa = jax.lax.map(_query_block, (lo_b, hi_b, cr_b))
        M = M.reshape(-1)[:nb_int]
        Pm = Pm.reshape(-1, dim)[:nb_int]
        Sa = Sa.reshape(-1, nq)[:nb_int]
        c_ref = pos_s[lo]

        dcom = Pm / jnp.maximum(M, 1e-30)[:, None]
        com_int = jnp.where((M > 0)[:, None], c_ref + dcom, c_ref)
        S_int = Sa - M[:, None] * _dd(dcom)
        node_mass = jnp.concatenate([M, mass_s])
        node_com = jnp.concatenate([com_int, pos_s])
        node_quad = jnp.concatenate([S_int, jnp.zeros((n, nq), dt)])

    # Packed hot-path tables (see BVHTree docstring). The table dtype
    # follows the input so f64 oracle runs stay exact; in f32, node ids up
    # to 2^24 round-trip exactly (asserted).
    tdt = pos_s.dtype
    assert tdt != jnp.float32 or n <= (1 << 23), \
        "f32-packed node indices require N <= 8M"
    if quad:
        width = 12 if dim == 2 else 16
    else:
        width = 8 if dim == 2 else 12
    node_table = jnp.zeros((num_nodes, width), tdt)
    node_table = node_table.at[:, 0].set(range_l.astype(tdt))
    node_table = node_table.at[:, 1].set(range_r.astype(tdt))
    node_table = node_table.at[:, 2].set(left.astype(tdt))
    node_table = node_table.at[:, 3].set(right_all.astype(tdt))
    node_table = node_table.at[:, 4].set(node_size.astype(tdt))
    node_table = node_table.at[:, 5].set(node_mass.astype(tdt))
    node_table = node_table.at[:, 6:6 + dim].set(node_com.astype(tdt))
    if quad:
        node_table = node_table.at[:, 6 + dim:6 + dim + node_quad.shape[1]]\
            .set(node_quad.astype(tdt))

    body_table = jnp.zeros((n, 4), tdt)
    body_table = body_table.at[:, :dim].set(pos_s)
    body_table = body_table.at[:, 3].set(mass_s)

    return BVHTree(
        key_bits=key_bits,
        order=order, pos_sorted=pos_s, mass_sorted=mass_s,
        range_l=range_l, range_r=range_r, left=left, right=right_all,
        node_mass=node_mass, node_com=node_com, node_size=node_size,
        node_table=node_table, body_table=body_table,
    )


@functools.partial(
    jax.jit,
    static_argnames=("leaf_size", "theta", "softening", "group_size",
                     "batch", "frontier_width", "near_cap", "shard_axis",
                     "num_shards", "return_stats", "multipole", "far_impl",
                     "local_gate", "varying_axis", "_debug_skip"))
def bvh_accel_sorted(tree: BVHTree, leaf_size: int = 16, theta: float = 0.25,
                     softening: float = 0.0, group_size: int = 64,
                     batch: int = 128,
                     frontier_width: Optional[int] = None,
                     near_cap: Optional[int] = None,
                     shard_axis: Optional[str] = None,
                     num_shards: int = 1,
                     return_stats: bool = False,
                     multipole: str = "mono",
                     far_impl: str = "point",
                     local_gate: float = 8.0,
                     group_ids: Optional[jax.Array] = None,
                     source: Optional[tuple] = None,
                     varying_axis: Optional[str] = None,
                     _debug_skip: str = "") -> jax.Array:
    """Accelerations on every sorted body (un-G-scaled): [N, D].

    ``source`` (optional ``(node_table, body_table)`` pair) evaluates the
    walk against a *different* tree than the one providing the target
    groups — the cross-tree step of the body-sharded LET distribution
    (parallel/let_bvh.py): my groups traverse a foreign chip's tree as it
    rotates past on the ring. The source tree must share ``tree``'s
    ``key_bits``. ``varying_axis`` names the shard_map axis when this runs
    *inside* a per-shard program (device-varying inputs): loop-carry
    constants are pcast to that axis without engaging the replicated-tree
    ``shard_axis`` group-slicing/psum path.

    ``group_ids`` ([M] int32, incompatible with ``shard_axis``) restricts
    the walk to those body groups and returns [M·group_size, D] rows in
    group order instead of [N, D] — the escalation driver's subset
    re-dispatch: only overflowed groups re-walk at raised capacities,
    so one dense core no longer inflates every group's padded frontier
    (with ``return_stats``, stats cover only the listed groups).

    Level-synchronous frontier-expansion traversal (the "vectorized,
    pointer-free frontier expansion" of the BASELINE.json north star),
    replacing the round-1 serial escape-pointer walk that was gather-
    latency-bound (one node per step, ~10⁴–10⁵ serial steps per group —
    0.17× the reference CPU at 1e5 3D):

    * Each *group* of ``group_size`` contiguous Hilbert-sorted bodies
      (spatially compact by construction) maintains a frontier of up to
      ``frontier_width`` candidate nodes. One iteration classifies the
      whole frontier at once — dense [batch, W] gathers and vector math
      instead of per-node pointer chasing — so the walk finishes in
      O(tree depth) ≈ 30–50 iterations:
        - group MAC ``node_size < θ·(dist − r_group)`` (``bvh.cpp:205``
          criterion, conservatively shrunk by the group radius) → monopole
          force from each member's exact position, evaluated inline;
        - nodes with ≤ ``leaf_size`` bodies → appended to the group's
          near-interaction list;
        - everything else → expanded into both children (prefix-sum
          compaction, no sorting).
    * Pass 2 evaluates the near lists as dense (bodies × contiguous body
      windows) P2P tiles — the role of the reference's per-leaf direct
      loop (``bvh.cpp:150-177``).

    Capacity overflow (frontier or near list) is NOT silently truncated
    (the round-1 ``max_steps`` cap was): affected groups' accelerations
    are poisoned with NaN, which the NaN-strict accuracy oracle and any
    downstream consumer will see immediately.

    ``far_impl="local"``: MAC-accepted nodes farther than ``local_gate``
    group radii from the group center accumulate into an order-2 local
    Taylor expansion at the group center (ops/local_expansion.py) instead
    of being evaluated at every member body — the per-body×per-node
    product is the dominant arithmetic term of the walk (cost drops from
    G·|accepted| to |accepted| for the gated majority). Accepted nodes
    *inside* the gate (small nearby nodes, where the Taylor ratio
    |ρ|/d > 1/local_gate would bite) still evaluate per body. Truncation
    error of the gated set is O(local_gate⁻³) ≈ 2e-3 relative at the
    default gate of 8 — below the θ=0.25 MAC budget.
    """
    n = tree.n
    dim = tree.pos_sorted.shape[-1]
    dtype = tree.pos_sorted.dtype
    soft2 = jnp.asarray(softening, dtype) ** 2
    qpairs = _quad_pairs(dim)
    src_table, src_bodies = (tree.node_table, tree.body_table) \
        if source is None else source
    n_src = src_bodies.shape[0]
    if multipole == "quad" and src_table.shape[-1] < 6 + dim + len(
            qpairs):
        raise ValueError("multipole='quad' needs a tree built with "
                         "build_bvh(..., quad=True)")
    # Capacity defaults, measured at N=1e5 θ=0.25 uniform (group sizes
    # 128/256): max frontier 326 (2D) / ~3600 (3D); max near list 316 (2D)
    # / ~300 (3D, MAC-passing leafish served far). Headroom ~3×; clustered
    # inputs that exceed these poison with NaN → raise the caps.
    if frontier_width is None:
        frontier_width = min(1024 if dim == 2 else 8192, 2 * n)
    if near_cap is None:
        near_cap = min(1024 if dim == 2 else 8192, 2 * n)
    W, NL = frontier_width, near_cap
    S = leaf_size
    # Round the near-list capacity up to whole pass-2 chunks (the frontier
    # gets the same treatment below): the last chunk is fetched with
    # lax.dynamic_slice, whose out-of-bounds start CLAMPS — with a ragged
    # final chunk it silently re-reads (and re-evaluates) the tail of the
    # previous chunk, double-counting those near windows whenever the bag
    # is full past the clamp point (bit with escalated cap 158 / chunk 128
    # on a clustered core: forces came out ~1.9× too large).
    nl_chunk = min(NL, max(1, 2048 // S))
    NL = -(-NL // nl_chunk) * nl_chunk
    # Depth bound: key bits + index-tiebreak bits (duplicate keys).
    max_depth = tree.key_bits + max(
        1, math.ceil(math.log2(max(n_src, 2)))) + 2

    G = group_size
    ngroups = -(-n // G)
    pad = ngroups * G - n
    # Pad with copies of the last body at zero mass: keeps group spheres
    # tight (far-away pad coords would inflate the last group's radius).
    pos_pad = jnp.concatenate(
        [tree.pos_sorted,
         jnp.broadcast_to(tree.pos_sorted[-1], (pad, dim))]) \
        if pad else tree.pos_sorted
    gpos = pos_pad.reshape(ngroups, G, dim)
    gmin = jnp.min(gpos, axis=1)
    gmax = jnp.max(gpos, axis=1)
    gcenter = 0.5 * (gmin + gmax)
    gradius = 0.5 * jnp.linalg.norm(gmax - gmin, axis=-1)

    root = jnp.int32(0 if n_src > 1 else n_src - 1)

    Wc = min(W, 256)  # frontier chunk (empty chunks cond-skipped)
    W = -(-W // Wc) * Wc  # round capacity up to whole chunks
    nWc = W // Wc
    table = src_table
    pcast_axis = shard_axis if shard_axis is not None else varying_axis
    use_local = far_impl == "local"
    if use_local:
        from .local_expansion import eval_local, local_coeffs, num_coeffs
        _, njc, nhc = num_coeffs(dim)

    def one_batch(args):
        pos_g, center_g, radius_g = args  # [B, G, D], [B, D], [B]
        B = pos_g.shape[0]
        rows = jnp.arange(B, dtype=jnp.int32)

        def cond(state):
            it, f = state[0], state[1]
            # Frontier is sort-compacted: empty iff column 0 is all-INVALID.
            return (it < max_depth) & jnp.any(f[:, 0] != _INVALID)

        def proc_chunk(c, carry):
            if use_local:
                f, acc, kids_buf, leaf_buf, la0, lJ, lH = carry
            else:
                f, acc, kids_buf, leaf_buf = carry
            fch = jax.lax.dynamic_slice_in_dim(f, c * Wc, Wc, axis=1)

            def do(_):
                valid = fch != _INVALID
                fc = jnp.where(valid, fch, 0)
                nt = table[fc]  # [B, Wc, width] — the ONE row gather
                l = nt[..., 0]
                r = nt[..., 1]
                lkid = nt[..., 2]
                rkid = nt[..., 3]
                size = nt[..., 4]
                nmass = nt[..., 5]
                com = nt[..., 6:6 + dim]
                leafish = (r - l + 1 <= S) & valid

                cdiff = com - center_g[:, None, :]
                cdist = jnp.sqrt(jnp.sum(cdiff * cdiff, axis=-1))
                # Group MAC (bvh.cpp:205 criterion, shrunk by the group
                # radius so it holds for every member body). MAC-passing
                # leafish nodes are served by the monopole too — only
                # nearby leafish nodes go to the near list.
                mac_ok = (size < theta * (cdist - radius_g[:, None])) \
                    & valid
                near_take = leafish & ~mac_ok
                expand = valid & ~leafish & ~mac_ok

                if use_local:
                    # Far-enough accepted nodes go to the group-center
                    # local expansion; only accepted nodes within the
                    # gate are evaluated per body.
                    far_loc = mac_ok & (
                        cdist > local_gate * radius_g[:, None])
                    mac_inline = mac_ok & ~far_loc
                else:
                    mac_inline = mac_ok

                # Far field, inline at each member's position: monopole,
                # or monopole + quadrupole in the normalized form of
                # grid_tree._quad_cell_accel (r⁻⁵/r⁻⁷ powers leave fp32
                # range at 1e7-scale coordinates).
                fd2 = None
                fdiffs = []
                for d in range(dim):
                    fd = com[:, None, :, d] - pos_g[:, :, None, d]
                    fdiffs.append(fd)  # [B, G, Wc]
                    fd2 = fd * fd if fd2 is None else fd2 + fd * fd
                finv = jax.lax.rsqrt(fd2 + soft2)
                mask = mac_inline[:, None, :]
                if "far" in _debug_skip:
                    acc2 = acc  # ablation: walk without inline far eval
                elif multipole == "quad":
                    Sq = nt[..., 6 + dim:6 + dim + len(qpairs)]
                    # Coincident guard (same as _quad_cell_accel): a leaf
                    # node's COM can equal a group body's position exactly
                    # (rsqrt(0)=inf, and 0·inf=NaN leaks through the
                    # normalized direction even under the MAC mask).
                    uq = jnp.where(fd2 < _DIST2_GUARD, 0.0, finv)
                    u2 = uq * uq
                    ndir = [fdiffs[d] * uq for d in range(dim)]
                    s_hat = {p: Sq[..., i_][:, None, :] * u2
                             for i_, p in enumerate(qpairs)}

                    def sh(a, b):
                        return s_hat.get((a, b)) if (a, b) in s_hat \
                            else s_hat[(b, a)]

                    Sn = [sum(sh(d, e) * ndir[e] for e in range(dim))
                          for d in range(dim)]
                    nSn = sum(ndir[d] * Sn[d] for d in range(dim))
                    trS = sum(sh(d, d) for d in range(dim))
                    radial = jnp.where(
                        mask,
                        (nmass[:, None, :] + 7.5 * nSn - 1.5 * trS) * u2,
                        0.0)
                    acc2 = acc + jnp.stack(
                        [jnp.sum(radial * ndir[d]
                                 - jnp.where(mask, 3.0 * u2 * Sn[d], 0.0),
                                 axis=-1)
                         for d in range(dim)], axis=-1)
                else:
                    fw = jnp.where(mask,
                                   nmass[:, None, :] * (finv * finv * finv),
                                   0.0)
                    acc2 = acc + jnp.stack(
                        [jnp.sum(fw * fdiffs[d], axis=-1)
                         for d in range(dim)],
                        axis=-1)

                # Stage children / near nodes into per-chunk slots of the
                # iteration buffers (compacted once per iteration below).
                kids_c = jnp.concatenate(
                    [jnp.where(expand, lkid.astype(jnp.int32), _INVALID),
                     jnp.where(expand, rkid.astype(jnp.int32), _INVALID)],
                    axis=1)  # [B, 2Wc]
                kids2 = jax.lax.dynamic_update_slice(
                    kids_buf, kids_c, (0, 2 * c * Wc))
                leaf_c = jnp.where(near_take, fch, _INVALID)
                leaf2 = jax.lax.dynamic_update_slice(
                    leaf_buf, leaf_c, (0, c * Wc))
                if use_local:
                    lmass = nmass * far_loc
                    Sl = (nt[..., 6 + dim:6 + dim + len(qpairs)]
                          * far_loc[..., None]
                          if multipole == "quad" else None)
                    # Same ε as the inline path's rsqrt(fd2 + soft2): the
                    # closed forms hold under softening (see local_coeffs).
                    da0, dJ, dH = local_coeffs(center_g, com, lmass, Sl,
                                               softening=softening)
                    return (acc2, kids2, leaf2,
                            la0 + da0, lJ + dJ, lH + dH)
                return acc2, kids2, leaf2

            def skip(_):
                if use_local:
                    return acc, kids_buf, leaf_buf, la0, lJ, lH
                return acc, kids_buf, leaf_buf

            # Compacted frontier ⇒ chunk empty iff its first column is
            # (scalar cond: real runtime branch, gathers skipped).
            out = jax.lax.cond(
                jnp.any(fch[:, 0] != _INVALID), do, skip, None)
            return (f,) + tuple(out)

        def step(state):
            if use_local:
                (it, f, acc, near_ids, near_cnt, overflow, maxw,
                 la0, lJ, lH) = state
            else:
                it, f, acc, near_ids, near_cnt, overflow, maxw = state
            kids_buf = jnp.full((B, 2 * W), _INVALID, jnp.int32)
            leaf_buf = jnp.full((B, W), _INVALID, jnp.int32)
            if pcast_axis is not None:
                # Both buffers receive shard-varying data inside a lax.cond
                # branch; the skip branch must carry the same varying type.
                kids_buf = jax.lax.pcast(kids_buf, pcast_axis, to="varying")
                leaf_buf = jax.lax.pcast(leaf_buf, pcast_axis, to="varying")
            if use_local:
                (_, acc, kids_buf, leaf_buf, la0, lJ, lH) = \
                    jax.lax.fori_loop(
                        0, nWc, proc_chunk,
                        (f, acc, kids_buf, leaf_buf, la0, lJ, lH))
            else:
                _, acc, kids_buf, leaf_buf = jax.lax.fori_loop(
                    0, nWc, proc_chunk, (f, acc, kids_buf, leaf_buf))

            # Sort-based compaction (chosen over scatters on the previous
            # accelerator; to be re-measured on the GPU): _INVALID = int32
            # max sorts to the end.
            newf = jnp.sort(kids_buf, axis=1)[:, :W]
            nkids = jnp.sum(kids_buf != _INVALID, axis=1, dtype=jnp.int32)
            overflow = overflow | (nkids > W)
            maxw = jnp.maximum(maxw, nkids)

            # Merge new near nodes into the (unordered) near bag.
            merged = jnp.sort(
                jnp.concatenate([near_ids, leaf_buf], axis=1), axis=1)
            near_ids = merged[:, :NL]
            near_cnt = near_cnt + jnp.sum(
                leaf_buf != _INVALID, axis=1, dtype=jnp.int32)
            overflow = overflow | (near_cnt > NL)

            out = (it + 1, newf, acc, near_ids, near_cnt, overflow, maxw)
            return out + (la0, lJ, lH) if use_local else out

        f0 = jnp.broadcast_to(
            jnp.where(jnp.arange(W) == 0, root, _INVALID).astype(jnp.int32),
            (B, W))
        acc0 = jnp.zeros_like(pos_g)
        near0 = jnp.full((B, NL), _INVALID, jnp.int32)
        cnt0 = jnp.zeros((B,), jnp.int32)
        of0 = jnp.zeros((B,), bool)
        maxw0 = jnp.zeros((B,), jnp.int32)
        it0 = jnp.int32(0)
        if pcast_axis is not None:
            # Carries derive from per-shard group data; mark the constant
            # inits device-varying for shard_map's typing.
            f0, near0, cnt0, of0, maxw0, it0 = (
                jax.lax.pcast(x, pcast_axis, to="varying")
                for x in (f0, near0, cnt0, of0, maxw0, it0))
        state0 = (it0, f0, acc0, near0, cnt0, of0, maxw0)
        if use_local:
            # Coeff carries derive from center_g (shard-varying already).
            la0_0 = jnp.zeros((B, dim), dtype) + 0.0 * center_g
            lJ0 = jnp.zeros((B, njc), dtype) + 0.0 * center_g[:, :1]
            lH0 = jnp.zeros((B, nhc), dtype) + 0.0 * center_g[:, :1]
            state0 = state0 + (la0_0, lJ0, lH0)
        fin = jax.lax.while_loop(cond, step, state0)
        _, fend, acc, near_ids, near_cnt, overflow, maxw = fin[:7]
        if use_local:
            la0, lJ, lH = fin[7:]
            acc = acc + eval_local(pos_g - center_g[:, None, :],
                                   la0, lJ, lH)
        # The max_depth bound is believed tight (root-to-leaf node path ≤
        # key_bits + log2(n) splits), but if a walk ever exceeds it the
        # leftover frontier must poison, not silently drop its subtrees.
        overflow = overflow | jnp.any(fend != _INVALID, axis=1)

        # ---- Pass 2: dense near-field evaluation over contiguous windows.
        # near_ids is sort-compacted, so empty chunks are cond-skipped.
        # (nl_chunk divides NL exactly — rounded above — so every
        # dynamic_slice start is in bounds and no entry is read twice.)
        nchunks = NL // nl_chunk
        arangeS = jnp.arange(S, dtype=jnp.int32)

        def near_chunk(c, acc):
            ids_c = jax.lax.dynamic_slice_in_dim(
                near_ids, c * nl_chunk, nl_chunk, axis=1)  # [B, NLc]

            def do(acc):
                nvalid = ids_c != _INVALID
                idc = jnp.where(nvalid, ids_c, 0)
                nt = table[idc]  # [B, NLc, width]
                l = nt[..., 0].astype(jnp.int32)
                r = nt[..., 1].astype(jnp.int32)
                start = jnp.minimum(l, n_src - S)
                idx = start[:, :, None] + arangeS  # [B, NLc, S]
                in_rng = (idx >= l[:, :, None]) & (idx <= r[:, :, None]) \
                    & nvalid[:, :, None]
                bt = src_bodies[idx]  # [B, NLc, S, 4] — one gather
                spos = bt[..., :dim].reshape(B, -1, dim)
                smass = (bt[..., 3] * in_rng).reshape(B, -1)
                d2 = None
                diffs = []
                for d in range(dim):
                    dd = spos[:, None, :, d] - pos_g[:, :, None, d]
                    diffs.append(dd)  # [B, G, NLc*S]
                    d2 = dd * dd if d2 is None else d2 + dd * dd
                inv = jax.lax.rsqrt(d2 + soft2)
                ww = smass[:, None, :] * (inv * inv * inv)
                ww = jnp.where(d2 < _DIST2_GUARD, 0.0, ww)
                return acc + jnp.stack(
                    [jnp.sum(ww * diffs[d], axis=-1) for d in range(dim)],
                    axis=-1)

            return jax.lax.cond(
                jnp.any(ids_c[:, 0] != _INVALID), do, lambda a: a, acc)

        if "near" not in _debug_skip:
            acc = jax.lax.fori_loop(0, nchunks, near_chunk, acc)

        # Explicit overflow signal: poison affected groups with NaN.
        acc = jnp.where(overflow[:, None, None],
                        jnp.asarray(jnp.nan, acc.dtype), acc)
        if return_stats:
            return acc, maxw, near_cnt, overflow
        return acc

    # Multi-chip: each shard walks a contiguous slice of groups against the
    # replicated tree; partial accelerations are psum-combined.
    if group_ids is not None:
        if shard_axis is not None:
            raise ValueError("group_ids is a single-chip escalation path "
                             "and cannot be combined with shard_axis")
        gids = jnp.clip(group_ids.astype(jnp.int32), 0, ngroups - 1)
        gpos = gpos[gids]
        gcenter = gcenter[gids]
        gradius = gradius[gids]
        my_groups = gids.shape[0]
    else:
        gp = -(-ngroups // num_shards)
        ngroups_p = gp * num_shards
        gpad = ngroups_p - ngroups

        def padg(x):
            if gpad == 0:
                return x
            return jnp.concatenate(
                [x, jnp.zeros((gpad,) + x.shape[1:], x.dtype)])

        gpos, gcenter, gradius = padg(gpos), padg(gcenter), padg(gradius)
        if shard_axis is not None:
            start = jax.lax.axis_index(shard_axis).astype(jnp.int32) * gp
            gpos = jax.lax.dynamic_slice_in_dim(gpos, start, gp)
            gcenter = jax.lax.dynamic_slice_in_dim(gcenter, start, gp)
            gradius = jax.lax.dynamic_slice_in_dim(gradius, start, gp)
            my_groups = gp
        else:
            my_groups = ngroups_p

    batch = min(batch, my_groups)
    nb = -(-my_groups // batch)
    bpad = nb * batch - my_groups

    def pad0(x):
        if bpad == 0:
            return x
        return jnp.concatenate(
            [x, jnp.zeros((bpad,) + x.shape[1:], x.dtype)])

    gpos_b = pad0(gpos).reshape(nb, batch, G, dim)
    gcen_b = pad0(gcenter).reshape(nb, batch, dim)
    grad_b = pad0(gradius).reshape(nb, batch)
    out = jax.lax.map(one_batch, (gpos_b, gcen_b, grad_b))
    if return_stats:
        acc, maxw, ncnt, g_over = out
        # Padding groups (zero-position) never overflow, but keep the
        # stats honest by masking them out of the scalars anyway.
        valid_g = jnp.arange(nb * batch) < my_groups
        stats = (jnp.max(jnp.where(valid_g, maxw.reshape(-1), 0)),
                 jnp.max(jnp.where(valid_g, ncnt.reshape(-1), 0)),
                 (g_over.reshape(-1) & valid_g)[:my_groups])
    else:
        acc = out
    acc = acc.reshape(-1, dim)[:my_groups * G]
    if group_ids is not None:
        return (acc, *stats) if return_stats else acc
    if shard_axis is None:
        res = acc[:n]
        return (res, *stats) if return_stats else res
    full = jnp.zeros((ngroups_p * G, dim), acc.dtype)
    full = jax.lax.dynamic_update_slice_in_dim(full, acc, start * G, axis=0)
    res = jax.lax.psum(full, shard_axis)[:n]
    return (res, *stats) if return_stats else res


@functools.partial(
    jax.jit,
    static_argnames=("key_bits", "quad", "leaf_size", "theta", "softening",
                     "group_size", "batch", "frontier_width", "near_cap",
                     "multipole", "far_impl", "local_gate"))
def _bvh_fused(positions, masses, g, *, key_bits, quad, leaf_size, theta,
               softening, group_size, batch, frontier_width, near_cap,
               multipole, far_impl="point", local_gate=8.0):
    """Build + traversal + unsort + G-scale as ONE device program, with
    the overflow stats riding the same dispatch (no eager glue ops
    between phases, as in grid_tree._bh_grid_fused). Also returns the
    per-group overflow bitmap and the sort order so the escalation
    driver can re-dispatch ONLY the overflowed groups — and the TREE
    itself (on-device pytree, no extra transfer), so the escalation path
    reuses it instead of paying a second full build."""
    tree = build_bvh(positions, masses, key_bits, quad=quad)
    acc_sorted, maxw, ncnt, g_over = bvh_accel_sorted(
        tree, leaf_size=leaf_size, theta=theta, softening=softening,
        group_size=group_size, batch=batch, frontier_width=frontier_width,
        near_cap=near_cap, return_stats=True, multipole=multipole,
        far_impl=far_impl, local_gate=local_gate)
    acc = jnp.zeros_like(acc_sorted).at[tree.order].set(acc_sorted)
    return (g * masses)[:, None] * acc, maxw, ncnt, g_over, tree


def _cap_bucket(x: int) -> int:
    """Round up to a 1/8-power-of-two grid (so cached escalation caps —
    static jit args — land on shared compile fingerprints across steps)."""
    if x <= 0:
        return 0
    g = max(2048, 1 << max(x.bit_length() - 4, 0))
    return -(-x // g) * g


def _frontier_capacity(w: int) -> int:
    wc = min(w, 256)
    return -(-w // wc) * wc  # the kernel's chunk-rounded capacity


def _near_capacity(nl: int, leaf_size: int) -> int:
    c = min(nl, max(1, 2048 // leaf_size))
    return -(-nl // c) * c  # kernel near-cap, rounded to pass-2 chunks


def caps_fit(need_w: int, need_nl: int, w: int, nl: int,
             leaf_size: int) -> bool:
    """Whether a walk's high-water counts fit the capacities it ran with."""
    return (need_w <= _frontier_capacity(w)
            and need_nl <= _near_capacity(nl, leaf_size))


def raise_caps(need_w: int, need_nl: int, w: int, nl: int, leaf_size: int,
               limit: int) -> tuple[int, int]:
    """Capacities for the next escalation attempt, at most ``limit``.
    Counts measured under overflow are lower bounds (a truncated frontier
    expands less), so each overflowed capacity doubles past them."""
    if need_w > _frontier_capacity(w):
        w = min(limit, max(2 * _frontier_capacity(w), 2 * need_w))
    if need_nl > _near_capacity(nl, leaf_size):
        nl = min(limit, max(2 * nl, 2 * need_nl))
    return w, nl


def resolve_bvh_far_impl(n: int) -> str:
    """far_impl default by N (θ=0.25 quad, uniform cube). The gated order-2
    local expansion ("local") amortizes the per-body × per-accepted-node
    product, which only outgrows its own plumbing at the biggest cells,
    so "local" from N = 5e6 and "point" below. The threshold was chosen
    on the previous accelerator and is to be re-measured on the GPU
    (ROADMAP). Accuracy cost of "local" at 5e6: a sampled float64
    normalized error of ~1e-4 against ~1e-5 for "point" — still the
    FMM-order-8 error class, under the θ=0.25 MAC budget. Shared by
    bvh_forces and the registry's hyper record so run artifacts state the
    resolved value."""
    return "local" if n >= 5_000_000 else "point"


def bvh_forces(
    positions: jax.Array,
    masses: jax.Array,
    config: GravityConfig = DEFAULT_GRAVITY,
    leaf_size: int = 16,
    theta: Optional[float] = None,
    group_size: Optional[int] = None,
    batch: int = 128,
    frontier_width: Optional[int] = None,
    near_cap: Optional[int] = None,
    max_escalations: int = 3,
    multipole: str = "quad",
    far_impl: Optional[str] = None,
    local_gate: float = 8.0,
    caps_state: Optional[dict] = None,
) -> jax.Array:
    """Per-body forces via the Hilbert radix BVH (parity: bvh_*_n_body,
    methods.cpp:377-423, with max_bodies_per_leaf=16 default methods.h:57).

    ``multipole="quad"`` (default) adds the COM-centered quadrupole to
    MAC-accepted nodes — the same upgrade the grid-BH tier ships (the
    reference's BVH is monopole-only, bvh.cpp:221-248, available as
    ``multipole="mono"``). Measured on the reference Accuracy(%) metric
    the monopole MAC at θ=0.25 decays to 82-84% in 2D by N=2e5; the
    quadrupole holds ≥99%.

    Capacity auto-escalation: the traversal's frontier/near-list capacities
    default to sizes measured on uniform inputs; strongly clustered inputs
    (e.g. a Plummer core) can exceed them, which poisons the affected
    groups with NaN rather than silently truncating. This driver watches
    the traversal's true high-water counts and re-dispatches ONLY the
    overflowed groups with doubled capacities (up to ``max_escalations``
    recompiles, capacities bounded by 2N, subset padded to a power of two
    so recompiles stay log-bounded) until the walk fits — so clustered
    distributions are handled automatically, never answered wrong, and a
    dense core no longer inflates every other group's padded tensors.
    The escalation needs concrete stats, so call this un-jitted (each tier
    entry point already is); under ``jit``, pass ``frontier_width`` /
    ``near_cap`` explicitly and treat NaN output as the overflow signal.

    ``caps_state``: stepping loops pass a (initially empty) dict that this
    driver updates with the settled escalation capacities; the next call
    seeds its first escalation attempt from it — ~1.2× the exact
    high-water counts, bucketed to a 1/8-pow2 grid so the static-arg caps
    share compile fingerprints across steps, so a stepping loop stops
    recompiling once its capacities settle.
    """
    n, dim = positions.shape
    theta = config.theta if theta is None else theta
    if far_impl is None:
        far_impl = resolve_bvh_far_impl(n)
    if group_size is None:
        # Larger groups amortize the frontier walk across more bodies;
        # too large, and bigger group AABBs push far cells into the near
        # field quadratically once groups span many leaves. 1024 was the
        # best of 128-2048 on the previous accelerator; to be re-measured
        # on the GPU (ROADMAP).
        group_size = 1024
    key_bits = dim * MAX_BITS[dim]
    g = jnp.asarray(config.G, positions.dtype)
    G = min(group_size, max(1, n))
    w = frontier_width if frontier_width is not None \
        else min(1024 if dim == 2 else 8192, 2 * n)
    nl = near_cap if near_cap is not None \
        else min(1024 if dim == 2 else 8192, 2 * n)

    forces, maxw, ncnt, g_over, tree = _bvh_fused(
        positions, masses, g, key_bits=key_bits,
        quad=(multipole == "quad"), leaf_size=leaf_size,
        theta=float(theta), softening=float(config.softening),
        group_size=G, batch=batch,
        frontier_width=w, near_cap=nl, multipole=multipole,
        far_impl=far_impl, local_gate=local_gate)
    # One device->host transfer for both stats (each int() would be its
    # own synchronizing transfer).
    need_w, need_nl = (int(v) for v in np.asarray(jnp.stack([maxw, ncnt])))
    if caps_fit(need_w, need_nl, w, nl, leaf_size) or max_escalations == 0:
        return forces

    # Subset re-dispatch: only the overflowed (NaN-poisoned) groups
    # re-walk at raised capacities. Before this, escalation re-ran EVERY
    # group at the raised caps, so one dense core (e.g. a Plummer center)
    # inflated every group's padded frontier/near tensors — the dominant
    # cost of the clustered 1M-body step. The subset is padded to the
    # next power of two so recompiles stay log-bounded; pad entries
    # duplicate a real group (identical rows, last-write-wins merge).
    ids = np.nonzero(np.asarray(g_over))[0]
    if ids.size == 0:  # stats exceeded caps without flagged groups —
        return forces  # nothing poisoned, the result is complete.
    M = 1 << max(0, int(ids.size - 1).bit_length())
    ids_p = np.concatenate(
        [ids, np.full(M - ids.size, ids[0], ids.dtype)])
    # (The tree rides back from the fused dispatch, so escalation does
    # not build it a second time.)
    w2, nl2 = w, nl
    if caps_state:
        # Stepping loops thread a dict here: the settled exact high-water
        # counts of the PREVIOUS call seed this call's first escalation
        # attempt at ~1.2x exact instead of 2x a truncation-censored lower
        # bound (near-field work scales with the cap). An undersized seed
        # just falls through to the doubling loop.
        w2 = min(2 * n, max(w2, int(caps_state.get("w2", 0))))
        nl2 = min(2 * n, max(nl2, int(caps_state.get("nl2", 0))))
    for attempt in range(max_escalations):
        w2, nl2 = raise_caps(need_w, need_nl, w2, nl2, leaf_size, 2 * n)
        sub_acc, maxw2, ncnt2, _ = bvh_accel_sorted(
            tree, leaf_size=leaf_size, theta=float(theta),
            softening=float(config.softening), group_size=G, batch=batch,
            frontier_width=w2, near_cap=nl2, return_stats=True,
            multipole=multipole, far_impl=far_impl, local_gate=local_gate,
            group_ids=jnp.asarray(ids_p, jnp.int32))
        need_w, need_nl = (
            int(v) for v in np.asarray(jnp.stack([maxw2, ncnt2])))
        if caps_fit(need_w, need_nl, w2, nl2, leaf_size) \
                or (_frontier_capacity(w2) >= 2 * n and nl2 >= 2 * n):
            break
    if caps_state is not None:
        # The final attempt's stats are exact high-water counts when it
        # fit; 1.2x margin absorbs step-to-step drift of the dense core.
        # Bucketed to a 1/8-power-of-two grid: the caps are STATIC jit
        # args, so unquantized per-step values would recompile the subset
        # walk every step.
        caps_state["w2"] = _cap_bucket(int(1.2 * need_w) + 1)
        caps_state["nl2"] = _cap_bucket(int(1.2 * need_nl) + 1)
    rows = (ids_p[:, None] * G + np.arange(G)).reshape(-1)
    valid = rows < n
    rows_v = jnp.asarray(rows[valid])
    orig = tree.order[rows_v]  # sorted slot -> original body index
    sub_rows = sub_acc[jnp.asarray(valid)]
    sub_forces = (g * tree.mass_sorted[rows_v])[:, None] * sub_rows
    return forces.at[orig].set(sub_forces)
