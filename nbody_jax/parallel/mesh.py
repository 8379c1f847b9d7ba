"""Device-mesh helpers.

The engine scales over a 1-D mesh of devices ("x" axis): bodies are sharded
over devices (the suite's analog of data parallelism — SURVEY.md §2.3 row 1).
GPUs of one host are joined all to all, so the mesh follows the algorithm
alone.
Tests build the same mesh over 8 virtual CPU devices
(``xla_force_host_platform_device_count``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BODY_AXIS = "x"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None,
              axis_name: str = BODY_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_bodies(mesh: Mesh, *arrays, axis_name: str = BODY_AXIS):
    """Place arrays with their leading (body) axis sharded over the mesh."""
    out = []
    for a in arrays:
        spec = P(axis_name, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out) if len(out) > 1 else out[0]


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple
