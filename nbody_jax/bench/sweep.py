"""Benchmark sweep runner — port of ``run_simulations.sh:26-60`` semantics.

The reference sweeps N ∈ {1e3, 1e4, 1e5, 2e5, 5e5, 1e6, 2e6, 5e6} × {2D, 3D}
accuracy-off, plus the first four sizes × {2D, 3D} accuracy-on, continuing on
failure (``|| continue``). Here the same matrix runs in-process (one JAX
runtime, compile caches shared), with per-config exception containment.

Run:  python -m nbody_jax.bench.sweep [--quick] [--tiers abhf]
"""

from __future__ import annotations

import argparse
import sys
import traceback

# run_simulations.sh:26-33
SWEEP_SIZES = (1_000, 10_000, 100_000, 200_000, 500_000,
               1_000_000, 2_000_000, 5_000_000)
ACCURACY_SIZES = SWEEP_SIZES[:4]  # run_simulations.sh:49-59
QUICK_SIZES = (1_000, 10_000)


def run_sweep(sizes=SWEEP_SIZES, accuracy_sizes=ACCURACY_SIZES,
              dims=(2, 3), tiers="abhf", results_dir="results",
              seed=0, warmup=1, run_id=None, method_names=None):
    import jax

    from .. import GravityConfig, random_system
    from ..cli import BRUTE_FORCE_N_GATE
    from .harness import get_run_id, run_benchmark
    from .registry import methods_for_tiers

    run_id = run_id or get_run_id()
    all_results = []
    configs = [(n, d, False) for n in sizes for d in dims]
    configs += [(n, d, True) for n in accuracy_sizes for d in dims]

    # Explicitly-named brute methods bypass the N gate (the CLI's
    # `-m a` override, cli.py explicit_brute) — how the reference's CUDA
    # rows at 2e6/5e6 got measured despite main.cpp:24.
    explicit_brute = False
    if method_names is not None:
        from .registry import all_methods
        _all = all_methods()
        explicit_brute = any(
            m in _all and _all[m].tier == "a" for m in method_names)

    for n, dim, accuracy in configs:
        cfg_tiers = tiers
        if n > BRUTE_FORCE_N_GATE and not explicit_brute:
            cfg_tiers = cfg_tiers.replace("a", "")  # main.cpp:24 gate
        methods = methods_for_tiers(cfg_tiers)
        if method_names is not None:
            methods = [m for m in methods if m.name in method_names]
        if not methods:
            continue
        label = f"N={n} dim={dim} accuracy={int(accuracy)}"
        print(f"\n=== sweep: {label} ===")
        try:
            system = random_system(jax.random.key(seed), n, dim=dim)
            res = run_benchmark(
                system, methods, gravity=GravityConfig(),
                compute_accuracy=accuracy, run_id=run_id,
                results_dir=results_dir, warmup=warmup)
            all_results.extend(res)
        except Exception:  # noqa: BLE001 — `|| continue` parity
            print(f"sweep config {label} failed:", file=sys.stderr)
            traceback.print_exc()
            continue
    return all_results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="small sizes only (smoke test)")
    p.add_argument("--tiers", default="abhf")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--sizes", default=None,
                   help="comma-separated N override (one-config chunking: "
                        "a failed process then only loses one config, "
                        "not the whole matrix)")
    p.add_argument("--dims", default="2,3")
    p.add_argument("--accuracy", choices=("auto", "on", "off"),
                   default="auto",
                   help="'auto' = reference matrix (accuracy-on extra runs "
                        "for the first four sizes); 'on'/'off' force it for "
                        "the given --sizes (chunked driving)")
    p.add_argument("--run-id", default=None,
                   help="shared CSV run id across chunked invocations")
    p.add_argument("--methods", default=None,
                   help="comma-separated exact method names (further "
                        "narrows --tiers; per-method chunking)")
    args = p.parse_args(argv)

    if args.sizes is not None:
        sizes = tuple(int(float(s)) for s in args.sizes.split(","))
    else:
        sizes = QUICK_SIZES if args.quick else SWEEP_SIZES
    if args.accuracy == "auto":
        acc_sizes = tuple(n for n in sizes if n in ACCURACY_SIZES) \
            if args.sizes is not None else \
            (QUICK_SIZES if args.quick else ACCURACY_SIZES)
        base_sizes = sizes
    elif args.accuracy == "on":
        base_sizes, acc_sizes = (), sizes
    else:
        base_sizes, acc_sizes = sizes, ()
    dims = tuple(int(d) for d in args.dims.split(","))

    results = run_sweep(sizes=base_sizes, accuracy_sizes=acc_sizes,
                        dims=dims, tiers=args.tiers,
                        results_dir=args.results_dir,
                        seed=args.seed, warmup=args.warmup,
                        run_id=args.run_id,
                        method_names=(set(args.methods.split(","))
                                      if args.methods else None))
    failed = [r for r in results if r.time_s < 0]
    print(f"\nsweep complete: {len(results)} method-runs, {len(failed)} failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
