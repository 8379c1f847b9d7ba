"""Multi-device execution: device meshes, ring brute force, sharded trees.

The reference suite is single-process shared-memory only (no MPI/NCCL/Gloo —
SURVEY.md §2.4); this package *introduces* the distributed tier:
``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives (NCCL over
NVLink between GPUs).

Two distribution schemes per tree tier:

* ``sharded_tree`` — replicated bodies + build, sharded *evaluation*
  (compute scaling only; simplest, good to ~10M bodies/chip).
* ``let_tree`` — body-sharded with locally-essential-tree halo exchange
  (O(N/P) per-chip body memory; the BASELINE.json north-star design).
"""

from .let_bvh import let_bvh  # noqa: F401
from .let_tree import let_barnes_hut, let_fmm  # noqa: F401
from .mesh import BODY_AXIS, make_mesh, shard_bodies  # noqa: F401
from .ring import ring_brute_force  # noqa: F401
from .sharded_tree import (  # noqa: F401
    barnes_hut_sharded,
    bvh_sharded,
    fmm_sharded,
)
