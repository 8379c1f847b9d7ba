"""Order-2 local (Taylor) expansions of far-field cell accelerations.

The cell→cell far-field acceleration: instead of evaluating every accepted
source cell at every target *body* (cost ∝ bodies × cells), accumulate the
cells' acceleration field into a second-order Taylor expansion at one
*expansion center* per target group (cost ∝ cells), then evaluate the
polynomial once per body (cost ∝ bodies):

    a(c + ρ) ≈ a0 + J·ρ + ½ ρᵀH ρ,   a0 = a(c), J = ∂a/∂x|c, H = ∂²a/∂x²|c.

This is the classical dual-tree / FMM "L2P" trick applied to the Barnes-Hut
tiers (the bbFMM tier does the order-p Chebyshev version; here order 2 keeps
the BH error budget). The reference evaluates accepted cells per body
(``octree.cpp:146-151``, ``bvh.cpp:221-248``); the per-body×per-cell
product is the dominant arithmetic term of both tree tiers at θ=0.25, and
the local expansion removes the body axis from all but the nearest source
sets.

Truncation error: relative to an accepted cell's own contribution, the
order-2 local truncation is O((|ρ|/d)³) with d the center→cell distance —
callers gate which cells are local-eligible so |ρ|/d stays ≲ 0.2 (grid
rings: per level, see ``grid_tree.far_field_rings``; BVH: a distance gate
of ``local_gate`` group radii, see ``bvh.bvh_accel_sorted``).

All derivatives are hand-derived closed forms in the same *normalized*
variables as ``grid_tree._quad_cell_accel`` (n = R/r is O(1), Ŝ = S/r² is
mass-scale) because raw r⁻⁵/r⁻⁷ powers leave fp32 range at the reference's
1e7-scale coordinates. Correctness of every term is pinned against
``jax.jacfwd`` of the direct cell sum in f64 (tests/test_local_expansion.py).

Packing: J and H are symmetric (derivatives of a potential), stored as
their upper-triangle components — J uses ``grid_tree._quad_pairs`` (3 / 6
components in 2D / 3D), H its fully-symmetric triples (4 / 10).
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .brute_force import _DIST2_GUARD
from .grid_tree import _quad_pairs


# Default eligibility threshold on the worst-case Taylor ratio |ρ|/d.
# Shared by every caller that gates levels/nodes into the local expansion
# (grid rings, LET rings) so an on-chip retune changes all paths at once.
LOCAL_RATIO_DEFAULT = 0.18


def ring_level_is_local(dim: int, k: int, L: int, l: int,
                        ratio: float = LOCAL_RATIO_DEFAULT,
                        include_leaf: bool = False) -> bool:
    """Is ring level ``l`` of an L-level grid local-eligible?

    Worst-case Taylor ratio of a leaf-centered expansion against level-l
    V-list cells: |ρ| ≤ (√D/2)·h (leaf half-diagonal) over d ≥ k·h·2^(L−l)
    (candidate com at the near edge of the ancestor's ring). By default the
    leaf level itself (l = L) is never eligible — its ratio √D/(2k+1) is
    the MAC's own scale. ``include_leaf=True`` (``far_impl="local_leaf"``)
    admits it anyway: the order-2 Taylor truncation O((ρ/d)³) at that ratio
    is the same magnitude as the quad-source truncation the MAC already
    accepts, and the leaf V-list ring is by far the largest per-body term
    at θ=0.25 in 3D ((2k+1)^D·2^D ≈ 2744 candidates per group·body).
    """
    if l >= L:
        return include_leaf and l == L
    return (dim ** 0.5) / (2.0 * k * (1 << (L - l))) <= ratio


def _h_triples(dim: int):
    """Packed index triples of the fully-symmetric third-derivative tensor."""
    return [t for t in itertools.combinations_with_replacement(range(dim), 3)]


def _k_quads(dim: int):
    """Packed index quadruples of the fully-symmetric ∂³a tensor (order 3)."""
    return [q for q in itertools.combinations_with_replacement(range(dim), 4)]


def local_coeffs(center: jax.Array, com: jax.Array, mass: jax.Array,
                 S: Optional[jax.Array] = None,
                 softening: float = 0.0,
                 order3: bool = False) -> Tuple[jax.Array, ...]:
    """Accumulate (a0, J, H) at ``center`` from source cells.

    center [..., D]; com [..., K, D]; mass [..., K] (masked-out cells must
    carry mass 0); S [..., K, nq] COM-centered second moments or None
    (monopole sources). Returns a0 [..., D], J packed [..., nj], H packed
    [..., nh] — each summed over the K axis.

    ``softening``: Plummer ε of the force law being expanded. Every closed
    form below holds verbatim under ε-softening with the substitutions
    u = (r²+ε²)^{−1/2} and n = R·u (then |n| < 1): the only derivative
    fact used is ∂u/∂y_b = u³R_b, identical in both cases. Callers must
    pass the SAME ε their per-body evaluation uses (the BVH walk softens
    accepted nodes; the grid rings do not) or the two paths would compute
    different laws.

    With R = com − center, u = 1/|R| (softened: see above), n = R·u,
    Ŝ = S·u², t = Ŝn, q = nᵀŜn:

      a0  = M n u²  +  u²[(7.5q − 1.5 trŜ)n − 3t]
      J_ab = M u³(3 n_a n_b − δ_ab)
           + u³[3Ŝ_ab − 15(t_a n_b + t_b n_a) + 1.5 trŜ δ_ab
                − 7.5 trŜ n_a n_b + 52.5 q n_a n_b − 7.5 q δ_ab]
      H_abc = 3 M u⁴ (5 n_a n_b n_c − δ_ab n_c − δ_ac n_b − δ_bc n_a)

    (H keeps the monopole term only: the quadrupole's third derivative is
    O((s/d)²·(ρ/d)²) relative — below the order-2 truncation already
    accepted. J's quadrupole term is kept because gated ratios ~0.2 make
    (s/d)²·(ρ/d) comparable to the monopole's ρ²/d² term.)

    ``order3=True`` additionally returns the packed fully-symmetric
    third-derivative-of-acceleration tensor (monopole only — same argument
    as H's):

      K_abcd = 3 M u⁵ (35 n_a n_b n_c n_d
                       − 5(δ_ab n_c n_d + δ_ac n_b n_d + δ_bc n_a n_d
                           + δ_ad n_b n_c + δ_bd n_a n_c + δ_cd n_a n_b)
                       + δ_ab δ_cd + δ_ac δ_bd + δ_ad δ_bc)

    which drops the local truncation O((ρ/d)³) → O((ρ/d)⁴) — needed by the
    leaf-level shell split (``far_impl="local_leaf"``) where the gated
    ratio ~0.19 makes the order-2 term the accuracy bottleneck.
    """
    dim = center.shape[-1]
    qpairs = _quad_pairs(dim)
    triples = _h_triples(dim)

    R = [com[..., d] - center[..., None, d] for d in range(dim)]  # [..., K]
    r2 = None
    for Rd in R:
        r2 = Rd * Rd if r2 is None else r2 + Rd * Rd
    u = jax.lax.rsqrt(r2 + jnp.asarray(softening, r2.dtype) ** 2)
    u = jnp.where(r2 < _DIST2_GUARD, 0.0, u)  # empty/coincident cell guard
    u2 = u * u
    u3 = u2 * u
    n = [Rd * u for Rd in R]

    M = mass
    Mu2 = M * u2
    Mu3 = M * u3

    a0 = [Mu2 * n[d] for d in range(dim)]
    Jp = []
    for a, b in qpairs:
        term = Mu3 * (3.0 * n[a] * n[b] - (1.0 if a == b else 0.0))
        Jp.append(term)
    Mu4_3 = 3.0 * Mu3 * u
    Hp = []
    for a, b, c in triples:
        t5 = 5.0 * n[a] * n[b] * n[c]
        if a == b:
            t5 = t5 - n[c]
        if a == c:
            t5 = t5 - n[b]
        if b == c:
            t5 = t5 - n[a]
        Hp.append(Mu4_3 * t5)

    Kp = None
    if order3:
        Mu5_3 = Mu4_3 * u
        Kp = []
        for a, b, c, d in _k_quads(dim):
            t = 35.0 * n[a] * n[b] * n[c] * n[d]
            for (x, y), (z, w) in (((a, b), (c, d)), ((a, c), (b, d)),
                                   ((a, d), (b, c))):
                if x == y:
                    t = t - 5.0 * n[z] * n[w]
                if z == w:
                    t = t - 5.0 * n[x] * n[y]
                if x == y and z == w:
                    t = t + 1.0
            Kp.append(Mu5_3 * t)

    if S is not None:
        s_hat = {}
        for i, p in enumerate(qpairs):
            s_hat[p] = S[..., i] * u2

        def sh(a, b):
            return s_hat[(a, b)] if (a, b) in s_hat else s_hat[(b, a)]

        t = [sum(sh(d, e) * n[e] for e in range(dim)) for d in range(dim)]
        q = sum(n[d] * t[d] for d in range(dim))
        trS = sum(sh(d, d) for d in range(dim))
        rad = (7.5 * q - 1.5 * trS) * u2
        for d in range(dim):
            a0[d] = a0[d] + rad * n[d] - (3.0 * u2) * t[d]
        for i, (a, b) in enumerate(qpairs):
            term = (3.0 * sh(a, b)
                    - 15.0 * (t[a] * n[b] + t[b] * n[a])
                    + (52.5 * q - 7.5 * trS) * n[a] * n[b])
            if a == b:
                term = term + 1.5 * trS - 7.5 * q
            Jp[i] = Jp[i] + u3 * term

    a0 = jnp.stack([jnp.sum(x, axis=-1) for x in a0], axis=-1)
    Jp = jnp.stack([jnp.sum(x, axis=-1) for x in Jp], axis=-1)
    Hp = jnp.stack([jnp.sum(x, axis=-1) for x in Hp], axis=-1)
    if order3:
        Kp = jnp.stack([jnp.sum(x, axis=-1) for x in Kp], axis=-1)
        return a0, Jp, Hp, Kp
    return a0, Jp, Hp


def eval_local(rho: jax.Array, a0: jax.Array, Jp: jax.Array,
               Hp: jax.Array, Kp: Optional[jax.Array] = None) -> jax.Array:
    """Evaluate the packed local expansion at body offsets.

    rho [..., T, D] (body − center); a0 [..., D]; Jp [..., nj];
    Hp [..., nh]; optional Kp [..., nk] (order-3 term, see
    :func:`local_coeffs` ``order3``) → acceleration increments [..., T, D].
    """
    dim = rho.shape[-1]
    qpairs = _quad_pairs(dim)
    triples = _h_triples(dim)
    jidx = {p: i for i, p in enumerate(qpairs)}
    hidx = {t: i for i, t in enumerate(triples)}

    def J(a, b):
        i = jidx[(a, b)] if (a, b) in jidx else jidx[(b, a)]
        return Jp[..., None, i]

    def H(a, b, c):
        return Hp[..., None, hidx[tuple(sorted((a, b, c)))]]

    rho_d = [rho[..., d] for d in range(dim)]
    out = []
    for a in range(dim):
        acc = a0[..., None, a]
        for b in range(dim):
            acc = acc + J(a, b) * rho_d[b]
        # ½ Σ_bc H_abc ρ_b ρ_c — loop unique (b, c) with multiplicity.
        for b in range(dim):
            acc = acc + 0.5 * H(a, b, b) * rho_d[b] * rho_d[b]
            for c in range(b + 1, dim):
                acc = acc + H(a, b, c) * rho_d[b] * rho_d[c]
        out.append(acc)
    acc = jnp.stack(out, axis=-1)
    if Kp is not None:
        # (1/6) Σ_bcd K_abcd ρ_b ρ_c ρ_d over unique sorted (b ≤ c ≤ d)
        # with permutation multiplicity. The packed K axis itself is the
        # (a, b, c, d) quadruple list; for each output component a we need
        # K[a, b, c, d] = packed[sorted(a, b, c, d)].
        kidx = {q: i for i, q in enumerate(_k_quads(dim))}
        out3 = []
        for a in range(dim):
            acc3 = 0.0
            for b, c, d in itertools.combinations_with_replacement(
                    range(dim), 3):
                # permutation count of the multiset {b, c, d} (b ≤ c ≤ d)
                if b == c == d:
                    mult = 1
                elif b == c or c == d:
                    mult = 3
                else:
                    mult = 6
                i = kidx[tuple(sorted((a, b, c, d)))]
                acc3 = acc3 + (mult / 6.0) * Kp[..., None, i] \
                    * rho_d[b] * rho_d[c] * rho_d[d]
            out3.append(acc3)
        acc = acc + jnp.stack(out3, axis=-1)
    return acc


def shift_local(a0: jax.Array, Jp: jax.Array, Hp: jax.Array,
                Kp: jax.Array, delta) -> Tuple[jax.Array, ...]:
    """Re-center an order-3 local expansion from c to c + delta (L2L), exact.

    delta: [D] (static offsets in the hierarchical sweep) or broadcastable
    to the batch. Returns (a0', Jp', Hp', Kp') packed like the inputs:

      a0'    = a0 + J δ + ½ δᵀHδ + (1/6) K δδδ   (= the expansion at c+δ)
      J'_ab  = J_ab + Σ_c H_abc δ_c + ½ Σ_cd K_abcd δ_c δ_d
      H'_abc = H_abc + Σ_d K_abcd δ_d
      K'     = K
    """
    dim = a0.shape[-1]
    delta = jnp.broadcast_to(jnp.asarray(delta, a0.dtype), a0.shape)
    a0p = eval_local(delta[..., None, :], a0, Jp, Hp, Kp)[..., 0, :]

    qpairs = _quad_pairs(dim)
    triples = _h_triples(dim)
    quads = _k_quads(dim)
    hidx = {t: i for i, t in enumerate(triples)}
    kidx = {q: i for i, q in enumerate(quads)}
    d_d = [delta[..., d] for d in range(dim)]

    def H(a, b, c):
        return Hp[..., hidx[tuple(sorted((a, b, c)))]]

    def KK(a, b, c, d):
        return Kp[..., kidx[tuple(sorted((a, b, c, d)))]]

    Jp_new = []
    for i, (a, b) in enumerate(qpairs):
        t = Jp[..., i]
        for c in range(dim):
            t = t + H(a, b, c) * d_d[c]
        for c in range(dim):
            t = t + 0.5 * KK(a, b, c, c) * d_d[c] * d_d[c]
            for e in range(c + 1, dim):
                t = t + KK(a, b, c, e) * d_d[c] * d_d[e]
        Jp_new.append(t)
    Hp_new = []
    for i, (a, b, c) in enumerate(triples):
        t = Hp[..., i]
        for d in range(dim):
            t = t + KK(a, b, c, d) * d_d[d]
        Hp_new.append(t)
    return (a0p, jnp.stack(Jp_new, axis=-1), jnp.stack(Hp_new, axis=-1), Kp)


def num_coeffs(dim: int) -> Tuple[int, int, int]:
    """(len a0, len J packed, len H packed) for carry allocation."""
    return dim, len(_quad_pairs(dim)), len(_h_triples(dim))


def num_coeffs3(dim: int) -> int:
    """len K packed (order-3 term) for carry allocation."""
    return len(_k_quads(dim))
