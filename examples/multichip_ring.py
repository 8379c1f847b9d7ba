"""Demo: multi-device ring brute force over every available device.

Run on a virtual 8-device CPU mesh:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/multichip_ring.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import nbody_jax as nb
from nbody_jax.parallel.mesh import make_mesh
from nbody_jax.parallel.ring import ring_brute_force


def main():
    devices = jax.devices()
    print(f"{len(devices)} device(s): {devices[0].platform}")
    mesh = make_mesh(devices)

    system = nb.random_system(jax.random.key(0), 8192, dim=3)
    cfg = nb.GravityConfig()

    forces = ring_brute_force(system.positions, system.masses, cfg,
                              mesh=mesh)
    jax.block_until_ready(forces)  # compile + warm-up
    t0 = time.perf_counter()
    forces = jax.block_until_ready(ring_brute_force(
        system.positions, system.masses, cfg, mesh=mesh))
    dt = time.perf_counter() - t0
    checksum = float(jnp.sum(jnp.abs(forces)))
    print(f"ring forces over {mesh.shape}: {dt * 1e3:.1f} ms "
          f"(checksum {checksum:.3e})")
    print("output sharding:", forces.sharding)


if __name__ == "__main__":
    main()
