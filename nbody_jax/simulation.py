"""High-level Simulation API: method selection + stepping + diagnostics.

The reference's only entry point is a one-shot force benchmark (``main.cpp``;
its integrators are dead code — SURVEY.md §3.5). This is the missing
simulation front end: pick a force method by name, step with Euler or
leapfrog, track energy, checkpoint and resume.

    sim = Simulation.create(system, config, method="fmm")
    sim = sim.run(steps=100, dt=1e-3)
    print(sim.energy())
    sim.save("ckpts")                      # orbax / npz
    sim2 = Simulation.load("ckpts", config, method="fmm")
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import jax

from .config import DEFAULT_GRAVITY, DEFAULT_TREE, GravityConfig, TreeConfig
from .integrators import euler_step, leapfrog_step
from .ops.brute_force import kinetic_energy, potential_energy_blocked
from .state import System

# method name -> forces(positions, masses) builder
_FORCE_BUILDERS = {}


def _register(name):
    def deco(fn):
        _FORCE_BUILDERS[name] = fn
        return fn
    return deco


@_register("brute")
def _brute(gravity: GravityConfig, tree: TreeConfig):
    from .ops.pallas_brute import brute_force_pallas, kernel_available
    if kernel_available():
        return functools.partial(brute_force_pallas, config=gravity)
    from .ops.brute_force import brute_force_blocked
    return functools.partial(brute_force_blocked, config=gravity)


@_register("barnes_hut")
def _bh(gravity: GravityConfig, tree: TreeConfig):
    from .ops.grid_tree import barnes_hut_grid
    return functools.partial(barnes_hut_grid, config=gravity,
                             theta=gravity.theta)


@_register("bvh")
def _bvh(gravity: GravityConfig, tree: TreeConfig):
    from .ops.bvh import bvh_forces
    return functools.partial(bvh_forces, config=gravity,
                             leaf_size=tree.max_bodies_per_leaf)


@_register("fmm")
def _fmm(gravity: GravityConfig, tree: TreeConfig):
    from .ops.fmm import fmm_forces
    return functools.partial(fmm_forces, config=gravity,
                             order=min(tree.order, 8))


def available_methods():
    return sorted(_FORCE_BUILDERS)


@dataclasses.dataclass(frozen=True)
class Simulation:
    """Immutable simulation handle; ``run`` returns an advanced copy."""

    system: System
    gravity: GravityConfig
    tree: TreeConfig
    method: str
    integrator: str
    step_count: int
    forces_fn: Callable = dataclasses.field(repr=False, compare=False)

    @classmethod
    def create(cls, system: System,
               gravity: GravityConfig = DEFAULT_GRAVITY,
               tree: TreeConfig = DEFAULT_TREE,
               method: str = "brute",
               integrator: str = "leapfrog") -> "Simulation":
        if method not in _FORCE_BUILDERS:
            raise ValueError(
                f"unknown method {method!r}; available: {available_methods()}")
        if integrator not in ("euler", "leapfrog"):
            raise ValueError(f"unknown integrator {integrator!r}")
        forces_fn = _FORCE_BUILDERS[method](gravity, tree)
        return cls(system=system, gravity=gravity, tree=tree, method=method,
                   integrator=integrator, step_count=0, forces_fn=forces_fn)

    def forces(self) -> jax.Array:
        return self.forces_fn(self.system.positions, self.system.masses)

    def run(self, steps: int, dt: float) -> "Simulation":
        step = euler_step if self.integrator == "euler" else leapfrog_step
        sys = self.system
        for _ in range(steps):
            sys = step(sys, self.forces_fn, dt)
        return dataclasses.replace(self, system=sys,
                                   step_count=self.step_count + steps)

    def energy(self) -> dict:
        """Kinetic, potential and total energy; the potential is summed in
        row blocks, so memory stays O(block · N) at any N."""
        ke = float(kinetic_energy(self.system.velocities, self.system.masses))
        pe = float(potential_energy_blocked(
            self.system.positions, self.system.masses, self.gravity))
        return {"kinetic": ke, "potential": pe, "total": ke + pe}

    def save(self, directory: str) -> str:
        from . import checkpoint as C
        return C.save_checkpoint(directory, self.system, self.step_count)

    @classmethod
    def load(cls, directory: str,
             gravity: GravityConfig = DEFAULT_GRAVITY,
             tree: TreeConfig = DEFAULT_TREE,
             method: str = "brute",
             integrator: str = "leapfrog",
             step: Optional[int] = None) -> "Simulation":
        from . import checkpoint as C
        system, step_count, _ = C.load_checkpoint(directory, step)
        sim = cls.create(system, gravity, tree, method, integrator)
        return dataclasses.replace(sim, step_count=step_count)
