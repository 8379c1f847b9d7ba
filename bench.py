"""Headline benchmark: one N=2^20 2D fp32 brute-force evaluation on a GPU.

Runs the brute-force path the registry picks on a GPU (the Pallas kernel),
times one force evaluation after a warm-up with ``jax.block_until_ready``,
and prints ONE JSON line naming the device:
{"metric", "value", "unit", "vs_baseline", "device"}.
Baseline: the reference suite's CUDA brute force at N=1e6, 2D, fp32 =
8.640 s on its (undocumented) GPU — BASELINE.md, row
`1000000,BruteForce_CUDA,2`. ``vs_baseline`` is baseline_time / our_time.
Without a GPU it prints an error line and exits non-zero.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

BASELINE_MS = 8640.0  # reference BruteForce_CUDA N=1e6 2D (BASELINE.md)
N = 1_048_576
DIM = 2


def main():
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != "gpu":
        print(json.dumps({"metric": "error_no_gpu", "value": -1.0,
                          "unit": "ms", "vs_baseline": 0.0,
                          "device": device}))
        return 1

    import nbody_jax as nb
    from nbody_jax.bench.registry import reference_method_for

    cfg = nb.GravityConfig()
    method = reference_method_for(N)
    system = nb.random_system(jax.random.key(7), N, dim=DIM,
                              dtype=jnp.float32)

    def run():
        return jax.block_until_ready(method.fn(
            system.positions, system.masses, cfg, nb.TreeConfig()))

    run()  # warm-up + compile
    t0 = time.perf_counter()
    out = run()
    elapsed_ms = (time.perf_counter() - t0) * 1e3
    if not bool(jnp.all(jnp.isfinite(out))):
        print(json.dumps({"metric": "error_nonfinite_forces", "value": -1.0,
                          "unit": "ms", "vs_baseline": 0.0,
                          "device": device}))
        return 1
    print(json.dumps({
        "metric": f"brute_force_N{N}_{DIM}D_fp32_step_time",
        "value": elapsed_ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / elapsed_ms,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
