"""Harness, registry, CLI, and analysis tests."""

import csv
import os

import jax
import numpy as np
import pytest

from nbody_jax import GravityConfig, random_system
from nbody_jax.bench import analysis, registry
from nbody_jax.bench.harness import (
    MethodResult,
    format_time_s,
    get_run_id,
    run_benchmark,
    safely_execute,
    Tee,
)
from nbody_jax.cli import main as cli_main


def test_registry_tiers():
    methods = registry.methods_for_tiers("a", include_gpu_only=False)
    names = {m.name for m in methods}
    assert "BruteForce_JNP" in names
    assert "BruteForce_Ring" in names
    assert "BruteForce_Pallas" not in names  # gpu_only filtered on CPU
    assert registry.methods_for_tiers("", include_gpu_only=False) == []


def test_safely_execute_contains_failure(capsys):
    log = Tee(None)

    def boom():
        raise RuntimeError("kaboom")

    t, out = safely_execute(log, "Boom", boom, warmup=0)
    assert t == -1.0 and out is None
    assert "kaboom" in capsys.readouterr().out


def test_format_time():
    assert format_time_s(1.5) == "1.500000"
    assert "e-" in format_time_s(5e-8)


def test_run_id_format():
    import datetime
    rid = get_run_id(datetime.datetime(2026, 8, 16, 4, 5, 6))
    assert rid == "08162026_040506"


def test_run_benchmark_files(rng_key, tmp_path):
    system = random_system(rng_key, 128, dim=2)
    methods = registry.methods_for_tiers("a", include_gpu_only=False)
    results = run_benchmark(system, methods, compute_accuracy=True,
                            run_id="test01", results_dir=str(tmp_path))
    assert all(r.time_s >= 0 for r in results)
    assert all(r.accuracy_pct == 100.0 for r in results)

    csv_path = tmp_path / "run_test01_N_128_2D.csv"
    out_path = tmp_path / "run_test01_N_128_2D.out"
    assert csv_path.exists() and out_path.exists()
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert {r["Method"] for r in rows} == {m.name for m in methods}
    assert all(r["Accuracy(%)"] == "100.00" for r in rows)
    assert "Body #" in out_path.read_text()  # validation force spot prints


def test_cli_end_to_end(tmp_path, capsys):
    rc = cli_main(["-d", "3", "-N", "64", "-a", "1", "-m", "a",
                   "--results-dir", str(tmp_path), "--warmup", "0"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "accuracy: 100.00%" in out
    assert list(tmp_path.glob("run_*_N_64_3D.csv"))


def test_cli_bad_tier(capsys):
    assert cli_main(["-m", "xyz", "--no-files"]) == 2


def test_cli_brute_gate(capsys, monkeypatch):
    # N > 1e6 with default tiers skips brute force (main.cpp:24 parity);
    # --dry-run stops before any force evaluation.
    rc = cli_main(["-N", "1000001", "--no-files", "--dry-run"])
    out = capsys.readouterr()
    assert rc == 0
    assert "skipping brute-force tier" in out.out
    assert "BruteForce" not in out.out.split("methods=")[1]


def test_analysis_roundtrip(rng_key, tmp_path):
    system = random_system(rng_key, 64, dim=2)
    methods = registry.methods_for_tiers("a", include_gpu_only=False)
    run_benchmark(system, methods, compute_accuracy=False, run_id="agg01",
                  results_dir=str(tmp_path))
    run_benchmark(system, methods, compute_accuracy=False, run_id="agg02",
                  results_dir=str(tmp_path))
    rows = analysis.load_results(str(tmp_path))
    assert len(rows) == 2 * len(methods)
    agg = analysis.aggregate(rows)
    assert all(v["Runs"] == 2 for v in agg.values())
    analysis.write_aggregated(agg, str(tmp_path / "aggregated_results.csv"))
    speed = analysis.speedup_table(agg)
    assert all(s["Speedup"] > 0 for s in speed)
    assert analysis.main([str(tmp_path)]) == 0


def test_failed_rows_excluded(tmp_path):
    p = tmp_path / "run_x_N_10_2D.csv"
    p.write_text("Method,Bodies,Dimension,Time(s)\nBad,10,2,-1.000000\n"
                 "Good,10,2,0.5\n")
    rows = analysis.load_results(str(tmp_path))
    assert len(rows) == 1 and rows[0]["Method"] == "Good"


def test_cli_steps_simulation(capsys):
    rc = cli_main(["-d", "2", "-N", "32", "-m", "a", "--no-files",
                   "--warmup", "0", "--steps", "3", "--dt", "0.01"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Simulating 3 leapfrog steps" in out
    assert "final position of body 0:" in out


def test_sweep_quick(tmp_path):
    from nbody_jax.bench.sweep import run_sweep
    results = run_sweep(sizes=(64,), accuracy_sizes=(64,), dims=(2,),
                        tiers="a", results_dir=str(tmp_path), warmup=0)
    # 2 configs (acc off/on) x registered CPU brute methods.
    assert results and all(r.time_s >= 0 for r in results)
    assert list(tmp_path.glob("run_*_N_64_2D.csv"))


def test_sweep_chunked_cli(tmp_path):
    """The sweep's per-config chunk flags (one config per process): explicit
    --sizes/--dims/--accuracy/--run-id must produce the named CSV."""
    from nbody_jax.bench.sweep import main as sweep_main
    rc = sweep_main(["--sizes", "64", "--dims", "2", "--accuracy", "on",
                     "--tiers", "a", "--results-dir", str(tmp_path),
                     "--run-id", "chunk1", "--warmup", "0"])
    assert rc == 0
    csv = tmp_path / "run_chunk1_N_64_2D.csv"
    assert csv.exists()
    header = csv.read_text().splitlines()[0]
    assert "Accuracy(%)" in header  # --accuracy on forced the extra columns


def test_profiling_trace_noop_and_dir(tmp_path):
    from nbody_jax.utils.profiling import trace
    with trace(None):
        pass
    with trace(str(tmp_path)):
        import jax.numpy as jnp
        float(jnp.sum(jnp.arange(8.0)))
