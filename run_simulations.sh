#!/usr/bin/env bash
# Benchmark sweep wrapper — parity with the reference's run_simulations.sh
# (builds, then sweeps N × {2D,3D} × accuracy, continuing on failure).
# The actual matrix logic lives in python -m nbody_jax.bench.sweep; this
# wrapper exists so reference users find the same entry point.
#
# Usage: ./run_simulations.sh [--quick] [--tiers abhf]
set -u

make -C native 2>/dev/null || echo "native oracle build skipped"

python -m nbody_jax.bench.sweep "$@" || exit 1
python -m nbody_jax.bench.analysis results
