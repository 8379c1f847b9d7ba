"""nbody_jax — an N-body gravitational simulation engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
C++/OpenMP/ParlayLib/CUDA suite (mathaiml5/NBody-simulation-parallel): four
algorithm tiers — brute force O(N²), Barnes-Hut octree, Hilbert-BVH, and the
Fast Multipole Method — over a shared 2D/3D particle state with softened
Newtonian gravity, Euler and leapfrog stepping, a cross-algorithm accuracy
oracle, and a benchmark harness. See SURVEY.md for the reference layer map.
"""

import os as _os

import jax as _jax

#: Persistent compilation cache used when ``JAX_COMPILATION_CACHE_DIR`` is
#: not set: a fixed path in the checkout (the path is part of the cache's
#: key, so it must not move between processes). Listed in .gitignore.
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

# JAX reads JAX_COMPILATION_CACHE_DIR itself; only without it is a
# directory set here, so the deep tree programs compile once per checkout.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)

from .config import (
    DEFAULT_GRAVITY,
    DEFAULT_TREE,
    GravityConfig,
    TreeConfig,
)
from .state import System, plummer_system, random_system
from .integrators import euler_step, leapfrog_step, simulate
from .ops.brute_force import (
    brute_force_accelerations,
    brute_force_blocked,
    brute_force_direct,
    kinetic_energy,
    potential_energy,
)
from .simulation import Simulation, available_methods
from .utils.accuracy import (
    accuracy_percentage,
    max_relative_error,
    percentile_relative_error,
    scale_normalized_error,
)

__version__ = "0.1.0"
