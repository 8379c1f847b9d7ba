"""Time integrators: explicit Euler and kick-drift-kick leapfrog.

The reference defines explicit-Euler helpers ``update_body_velocities`` /
``update_body_positions`` (``methods.cpp:426-450``) that are never called by
any driver (SURVEY.md §3.5). Here stepping is a first-class API:
:func:`euler_step` reproduces those helpers' semantics (v += F/m·dt then
x += v·dt) and :func:`leapfrog_step` adds the symplectic KDK integrator
required by BASELINE.json.

Both steps are pure functions ``(System, forces_fn, dt) -> System`` suitable
for ``jax.jit`` and ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from .state import System

# forces_fn(positions [N,D], masses [N]) -> forces [N,D]
ForcesFn = Callable[[jax.Array, jax.Array], jax.Array]


def euler_step(system: System, forces_fn: ForcesFn, dt) -> System:
    """Explicit Euler: v += F/m·dt; x += v·dt (methods.cpp:426-450 parity)."""
    dt = jnp.asarray(dt, system.positions.dtype)
    forces = forces_fn(system.positions, system.masses)
    new_v = system.velocities + forces / system.masses[:, None] * dt
    new_x = system.positions + new_v * dt
    return system.replace(positions=new_x, velocities=new_v)


def leapfrog_step(system: System, forces_fn: ForcesFn, dt) -> System:
    """Symplectic kick-drift-kick leapfrog (2nd order, time reversible)."""
    dt = jnp.asarray(dt, system.positions.dtype)
    half = dt * 0.5
    a0 = forces_fn(system.positions, system.masses) / system.masses[:, None]
    v_half = system.velocities + a0 * half
    x1 = system.positions + v_half * dt
    a1 = forces_fn(x1, system.masses) / system.masses[:, None]
    v1 = v_half + a1 * half
    return system.replace(positions=x1, velocities=v1)


def leapfrog_step_carried(system: System, acc, forces_fn: ForcesFn,
                          dt) -> Tuple[System, jax.Array]:
    """One KDK step given the CURRENT acceleration; returns the next
    state and the acceleration at the new positions.

    Chained KDK steps evaluate forces once per step: the ``a0 =
    forces(x_k)`` that :func:`leapfrog_step` recomputes at step k+1 is
    exactly the ``a1`` step k already computed — same inputs, same
    values. Threading it through halves the force evaluations of every
    stepping loop. Seed with
    ``acc = forces_fn(x0, m) / m[:, None]``.
    """
    dt = jnp.asarray(dt, system.positions.dtype)
    half = dt * 0.5
    v_half = system.velocities + acc * half
    x1 = system.positions + v_half * dt
    a1 = forces_fn(x1, system.masses) / system.masses[:, None]
    v1 = v_half + a1 * half
    return system.replace(positions=x1, velocities=v1), a1


def simulate(
    system: System,
    forces_fn: ForcesFn,
    dt,
    num_steps: int,
    integrator: str = "leapfrog",
) -> Tuple[System, None]:
    """Run ``num_steps`` under ``lax.scan`` (compiled once, static step count).

    The leapfrog path carries the acceleration between steps
    (:func:`leapfrog_step_carried`) — one force evaluation per step
    instead of :func:`leapfrog_step`'s two, identical trajectory.
    """
    if integrator == "leapfrog":
        a0 = forces_fn(system.positions, system.masses) \
            / system.masses[:, None]

        def body(carry, _):
            sys, acc = carry
            return leapfrog_step_carried(sys, acc, forces_fn, dt), None

        (final, _), _ = jax.lax.scan(body, (system, a0), None,
                                     length=num_steps)
        return final, None

    step = {"euler": euler_step, "leapfrog": leapfrog_step}[integrator]

    def body(sys, _):
        return step(sys, forces_fn, dt), None

    final, _ = jax.lax.scan(body, system, None, length=num_steps)
    return final, None
