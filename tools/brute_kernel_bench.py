"""Pallas brute-force kernel vs XLA's ``brute_force_blocked`` on the GPU.

For each dimension, times one force evaluation over N bodies through the
Pallas kernel at each listed tile configuration and through the plain jnp
blocked path that XLA compiles, each as the median of ``--reps`` runs after
one warm-up, every run ended by ``jax.block_until_ready``. Each result is
checked against a float64 direct sum on ``--rows`` sampled target rows.
Prints one JSON line per (path, configuration) and a summary line; refuses
to run without a GPU.

    python tools/brute_kernel_bench.py -N 1048576 --dims 2 3
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import nbody_jax as nb
from nbody_jax.ops import pallas_brute as pb
from nbody_jax.utils.accuracy import (sample_rows, sampled_reference_forces,
                                      scale_normalized_error)

# (block_t, block_s, num_warps, num_stages)
DEFAULT_TILES = [(64, 32, 4, 3), (128, 32, 4, 3), (64, 64, 4, 3),
                 (128, 64, 8, 3), (32, 32, 2, 3), (64, 32, 4, 2),
                 (128, 32, 8, 2), (256, 16, 8, 3)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def median_time(fn, reps):
    jax.block_until_ready(fn())  # warm-up + compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-N", type=int, default=1 << 20)
    ap.add_argument("--dims", type=int, nargs="+", default=[2, 3])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiles", type=str, default=None,
                    help="semicolon-separated bt,bs,warps,stages tuples")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print(json.dumps({"error": "no GPU", "platform":
                          jax.devices()[0].platform}))
        return 1
    tiles = DEFAULT_TILES if args.tiles is None else [
        tuple(int(x) for x in t.split(",")) for t in args.tiles.split(";")]
    print("card:", card_line(), "| jax", jax.__version__,
          "| device", jax.devices()[0].device_kind, flush=True)
    cfg = nb.GravityConfig()
    summary = {}
    for dim in args.dims:
        system = nb.random_system(jax.random.key(args.seed), args.N, dim=dim,
                                  dtype=jnp.float32)
        pos, mass = system.positions, system.masses
        rows = sample_rows(args.N, args.rows, args.seed)
        ref = sampled_reference_forces(pos, mass, rows, cfg)
        paths = [("xla_blocked", None,
                  jax.jit(lambda p, m: nb.brute_force_blocked(p, m, cfg)))]
        for bt, bs, nw, ns in tiles:
            paths.append((
                "pallas", (bt, bs, nw, ns),
                jax.jit(lambda p, m, bt=bt, bs=bs, nw=nw, ns=ns:
                        pb.brute_force_pallas(p, m, cfg, block_t=bt,
                                              block_s=bs, num_warps=nw,
                                              num_stages=ns))))
        for name, tile, fn in paths:
            rec = {"path": name, "tile": tile, "N": args.N, "dim": dim}
            try:
                t0 = time.perf_counter()
                out = jax.block_until_ready(fn(pos, mass))
                rec["first_call_s"] = time.perf_counter() - t0
                rec["err"] = float(scale_normalized_error(
                    jax.device_get(out)[rows], ref))
                med, lo, hi = median_time(lambda: fn(pos, mass), args.reps)
                rec.update(median_s=med, min_s=lo, max_s=hi)
                best = summary.get((name, dim))
                if best is None or med < best["median_s"]:
                    summary[(name, dim)] = rec
            except Exception as e:  # noqa: BLE001 — report and go on
                rec["error"] = f"{type(e).__name__}: {str(e)[:400]}"
            print(json.dumps(rec), flush=True)
    print(json.dumps({"best": [v for v in summary.values()]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
