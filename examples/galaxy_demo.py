"""Demo: evolve a rotating disk galaxy with FMM forces and plot it.

Run:  python examples/galaxy_demo.py [--n 20000] [--steps 200] [--method fmm]

Produces examples/galaxy_demo.png (before/after panels) and prints energy
drift. Works on a GPU or the CPU.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np

import nbody_jax as nb
from nbody_jax.models import spiral_galaxy


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--dt", type=float, default=2e-3)
    p.add_argument("--method", default="fmm",
                   choices=nb.available_methods())
    args = p.parse_args()

    system, cfg = spiral_galaxy(jax.random.key(0), args.n)
    sim = nb.Simulation.create(system, cfg, method=args.method)
    e0 = sim.energy()
    print(f"N={args.n} method={args.method} backend={jax.default_backend()}")
    print(f"E0 = {e0['total']:.6f} (K {e0['kinetic']:.4f} / "
          f"U {e0['potential']:.4f})")

    before = np.asarray(sim.system.positions)
    sim = sim.run(steps=args.steps, dt=args.dt)
    after = np.asarray(sim.system.positions)
    e1 = sim.energy()
    drift = (e1["total"] - e0["total"]) / abs(e0["total"])
    print(f"E after {args.steps} steps = {e1['total']:.6f} "
          f"(drift {drift:.2e})")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return

    fig, axes = plt.subplots(1, 2, figsize=(10, 5))
    for ax, pts, title in ((axes[0], before, "t = 0"),
                           (axes[1], after, f"t = {args.steps * args.dt:g}")):
        ax.scatter(pts[1:, 0], pts[1:, 1], s=0.3, alpha=0.4, lw=0)
        ax.scatter([pts[0, 0]], [pts[0, 1]], s=30, c="red")
        ax.set_xlim(-6, 6)
        ax.set_ylim(-6, 6)
        ax.set_aspect("equal")
        ax.set_title(title)
    fig.suptitle(f"spiral galaxy, {args.method} forces, N={args.n}")
    out = os.path.join(os.path.dirname(__file__), "galaxy_demo.png")
    fig.tight_layout()
    fig.savefig(out, dpi=110)
    print("wrote", out)


if __name__ == "__main__":
    main()
