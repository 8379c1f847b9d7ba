"""Particle state for the N-body engine.

The reference stores an array-of-structs ``std::vector<Body<D>>`` with
``Body<D> = {position, velocity, mass}`` (``body.h:8-19``). On an accelerator
the natural layout is struct-of-arrays so every field is a dense, tileable array:
``positions[N, D]``, ``velocities[N, D]``, ``masses[N]``. 2D vs 3D is the
trailing axis length, replacing the reference's ``template <int D>``
(``vector.h:9-10``).

``random_system`` reproduces ``generate_random_bodies<D>`` distributions
(``utils.h:108-135``: pos ~ U[1, 1e7], vel ~ U[-10, 10], mass ~ U[1, 1e8])
but with deterministic ``jax.random`` seeding — the reference seeds from
``std::random_device`` and is non-reproducible (SURVEY.md §8.7).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from .config import MASS_RANGE, POSITION_RANGE, VELOCITY_RANGE


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class System:
    """Struct-of-arrays particle state (a jax pytree).

    Attributes:
      positions:  f32/f64 array [N, D], D in {2, 3}.
      velocities: array [N, D].
      masses:     array [N].
    """

    positions: jax.Array
    velocities: jax.Array
    masses: jax.Array

    @property
    def n(self) -> int:
        return self.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.positions.shape[-1]

    @property
    def dtype(self):
        return self.positions.dtype

    def replace(self, **kwargs) -> "System":
        return dataclasses.replace(self, **kwargs)

    def astype(self, dtype) -> "System":
        return System(
            positions=self.positions.astype(dtype),
            velocities=self.velocities.astype(dtype),
            masses=self.masses.astype(dtype),
        )

    def validate(self) -> None:
        n, d = self.positions.shape
        if d not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {d}")
        if self.velocities.shape != (n, d):
            raise ValueError(
                f"velocities shape {self.velocities.shape} != {(n, d)}")
        if self.masses.shape != (n,):
            raise ValueError(f"masses shape {self.masses.shape} != {(n,)}")


def random_system(
    key: jax.Array,
    n: int,
    dim: int = 3,
    dtype=jnp.float32,
    position_range: Tuple[float, float] = POSITION_RANGE,
    velocity_range: Tuple[float, float] = VELOCITY_RANGE,
    mass_range: Tuple[float, float] = MASS_RANGE,
) -> System:
    """Deterministic analog of ``generate_random_bodies<D>`` (utils.h:108-135)."""
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    kp, kv, km = jax.random.split(key, 3)
    positions = jax.random.uniform(
        kp, (n, dim), dtype=dtype,
        minval=position_range[0], maxval=position_range[1])
    velocities = jax.random.uniform(
        kv, (n, dim), dtype=dtype,
        minval=velocity_range[0], maxval=velocity_range[1])
    masses = jax.random.uniform(
        km, (n,), dtype=dtype, minval=mass_range[0], maxval=mass_range[1])
    return System(positions=positions, velocities=velocities, masses=masses)


def plummer_system(
    key: jax.Array,
    n: int,
    dim: int = 3,
    dtype=jnp.float32,
    total_mass: float = 1.0,
    scale_radius: float = 1.0,
) -> System:
    """Plummer-sphere initial conditions (positions only; cold start).

    A physically meaningful initializer the reference lacks; useful for
    energy-conservation tests where a uniform cube produces near-unbound
    systems.
    """
    kr, kdir, _ = jax.random.split(key, 3)
    u = jax.random.uniform(kr, (n,), dtype=jnp.float32,
                           minval=1e-4, maxval=1.0 - 1e-4)
    # Inverse CDF of the Plummer cumulative mass profile.
    r = scale_radius / jnp.sqrt(u ** (-2.0 / 3.0) - 1.0)
    direction = jax.random.normal(kdir, (n, dim), dtype=jnp.float32)
    direction = direction / jnp.linalg.norm(direction, axis=-1, keepdims=True)
    positions = (r[:, None] * direction).astype(dtype)
    velocities = jnp.zeros((n, dim), dtype=dtype)
    masses = jnp.full((n,), total_mass / n, dtype=dtype)
    return System(positions=positions, velocities=velocities, masses=masses)
