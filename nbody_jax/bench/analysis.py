"""Results aggregation and speedup analysis — notebook parity.

Replaces ``analysis/analyze_results.ipynb``: glob ``results/*.csv``, drop
invalid rows (time < 0), group by (Bodies, Method, Dimension) and average
repeated runs, write ``aggregated_results.csv``, and compute
speedup-vs-reference-method tables (notebook cells 2-12). Plots are optional
(matplotlib, if importable); the aggregation itself is dependency-light
(no pandas required).

Run:  python -m nbody_jax.bench.analysis [results_dir]
"""

from __future__ import annotations

import csv
import glob
import os
import sys
from collections import defaultdict
from typing import Dict, List, Tuple

Key = Tuple[int, str, int]  # (bodies, method, dim)


def load_results(results_dir: str = "results") -> List[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.csv"))):
        if os.path.basename(path) == "aggregated_results.csv":
            continue  # our own output — re-reading it would double-count
        with open(path) as f:
            reader = csv.DictReader(f)
            for row in reader:
                try:
                    t = float(row["Time(s)"])
                except (KeyError, ValueError):
                    continue
                if t < 0:  # failed run sentinel (utils.h:88-104)
                    continue
                rows.append({
                    "Method": row["Method"],
                    "Bodies": int(row["Bodies"]),
                    "Dimension": int(row["Dimension"]),
                    "Time(s)": t,
                    "Accuracy(%)": (float(row["Accuracy(%)"])
                                    if row.get("Accuracy(%)") else None),
                })
    return rows


def aggregate(rows: List[dict]) -> Dict[Key, dict]:
    """Mean over repeated runs, keyed by (Bodies, Method, Dimension)."""
    groups: Dict[Key, List[dict]] = defaultdict(list)
    for r in rows:
        groups[(r["Bodies"], r["Method"], r["Dimension"])].append(r)
    out = {}
    for key, g in sorted(groups.items()):
        times = [r["Time(s)"] for r in g]
        accs = [r["Accuracy(%)"] for r in g if r["Accuracy(%)"] is not None]
        out[key] = {
            "Bodies": key[0], "Method": key[1], "Dimension": key[2],
            "Time(s)": sum(times) / len(times),
            "Accuracy(%)": (sum(accs) / len(accs)) if accs else None,
            "Runs": len(g),
        }
    return out


def write_aggregated(agg: Dict[Key, dict], path: str):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Bodies", "Method", "Dimension", "Time(s)",
                    "Accuracy(%)", "Runs"])
        for row in agg.values():
            w.writerow([row["Bodies"], row["Method"], row["Dimension"],
                        f"{row['Time(s)']:.6f}",
                        "" if row["Accuracy(%)"] is None
                        else f"{row['Accuracy(%)']:.2f}",
                        row["Runs"]])


def speedup_table(agg: Dict[Key, dict],
                  baseline_method: str = "BruteForce_JNP") -> List[dict]:
    """Speedup of every method vs ``baseline_method`` at the same (N, dim).

    Notebook-parity: cells computing speedup vs BruteForce_Sequential.
    """
    out = []
    for (n, method, dim), row in agg.items():
        base = agg.get((n, baseline_method, dim))
        if base is None or method == baseline_method:
            continue
        out.append({
            "Bodies": n, "Dimension": dim, "Method": method,
            "Speedup": base["Time(s)"] / max(row["Time(s)"], 1e-12),
        })
    return out


#: Where the reference suite's own aggregate lives, when present.  The
#: overlay is purely optional — absent file ⇒ plots show our series only.
REF_AGGREGATE = os.environ.get(
    "NBODY_REF_AGGREGATE",
    "/root/reference/nbody-sim-new/analysis/aggregated_results.csv")


def load_reference_best(path: str = REF_AGGREGATE):
    """Best (fastest valid) reference time per (Bodies, family, Dimension).

    Families are the method-name prefixes (``BarnesHut_Parlay`` →
    ``BarnesHut``); -1 failure sentinels are dropped, mirroring
    ``load_results``.  Returns {} when the file is unavailable.
    """
    best: Dict[Tuple[int, str, int], Tuple[float, str]] = {}
    try:
        with open(path) as f:
            for row in csv.DictReader(f):
                try:
                    t = float(row["Average Runtime (s)"])
                    n = int(row["Bodies"])
                    d = int(row["Dimension"])
                    method = row["Method"]
                except (KeyError, ValueError):
                    continue
                if t < 0:
                    continue
                key = (n, method.split("_")[0], d)
                if key not in best or t < best[key][0]:
                    best[key] = (t, method)
    except OSError:
        return {}
    return best


def maybe_plot(agg: Dict[Key, dict], results_dir: str):
    """Runtime plots per dimension: log-log AND linear scale
    (``performance_plot_{2D,3D}.png`` + ``performance_plot_*_linear.png``
    parity with the reference notebook cells 8-10).  When the reference
    suite's aggregate is readable, its best competitor per family is
    overlaid as dashed lines so every win/loss is visible at a glance."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    ref_best = load_reference_best()
    for dim in (2, 3):
        series: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        for (n, method, d), row in agg.items():
            if d == dim:
                series[method].append((n, row["Time(s)"]))
        if not series:
            continue
        ref_series: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        for (n, fam, d), (t, _m) in ref_best.items():
            if d == dim:
                ref_series[fam].append((n, t))
        for scale in ("log", "linear"):
            fig, ax = plt.subplots(figsize=(8, 5))
            for method, pts in sorted(series.items()):
                pts.sort()
                ax.plot([p[0] for p in pts], [p[1] for p in pts],
                        marker="o", label=method)
            for fam, pts in sorted(ref_series.items()):
                pts.sort()
                ax.plot([p[0] for p in pts], [p[1] for p in pts],
                        linestyle="--", marker="x", alpha=0.6,
                        label=f"ref best {fam}")
            if scale == "log":
                ax.set_xscale("log")
                ax.set_yscale("log")
            ax.set_xlabel("N bodies")
            ax.set_ylabel("Time (s)")
            ax.set_title(f"{dim}D force-evaluation runtime ({scale} scale)")
            ax.legend(fontsize=7)
            fig.tight_layout()
            suffix = "" if scale == "log" else "_linear"
            fig.savefig(os.path.join(
                results_dir, f"performance_plot_{dim}D{suffix}.png"), dpi=120)
            plt.close(fig)


def ratio_heatmap_3d_vs_2d(agg: Dict[Key, dict], results_dir: str):
    """Method × N heatmap of Time(3D)/Time(2D)
    (``3D_vs_2D_ratio_heatmap.png`` parity with notebook cells 10-12)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np
    except ImportError:
        return
    pairs = {}
    for (n, method, d), row in agg.items():
        other = agg.get((n, method, 5 - d))
        if d == 3 and other is not None:
            pairs[(method, n)] = row["Time(s)"] / max(other["Time(s)"], 1e-12)
    if not pairs:
        return
    methods = sorted({m for m, _ in pairs})
    sizes = sorted({n for _, n in pairs})
    grid = np.full((len(methods), len(sizes)), np.nan)
    for (m, n), v in pairs.items():
        grid[methods.index(m), sizes.index(n)] = v
    fig, ax = plt.subplots(
        figsize=(1.2 + 1.1 * len(sizes), 0.8 + 0.45 * len(methods)))
    im = ax.imshow(grid, cmap="coolwarm", aspect="auto")
    ax.set_xticks(range(len(sizes)), [f"{s:g}" for s in sizes])
    ax.set_yticks(range(len(methods)), methods, fontsize=7)
    for i in range(len(methods)):
        for j in range(len(sizes)):
            if np.isfinite(grid[i, j]):
                ax.text(j, i, f"{grid[i, j]:.2f}", ha="center",
                        va="center", fontsize=6)
    ax.set_xlabel("N bodies")
    ax.set_title("3D / 2D runtime ratio")
    fig.colorbar(im, ax=ax, label="T(3D)/T(2D)")
    fig.tight_layout()
    fig.savefig(os.path.join(results_dir, "3D_vs_2D_ratio_heatmap.png"),
                dpi=120)
    plt.close(fig)


def speedup_heatmap(agg: Dict[Key, dict], results_dir: str,
                    baseline_method: str = "BruteForce_JNP"):
    """Method × N speedup heatmaps per dimension
    (results/speedup_heatmap_{2D,3D}.png parity)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np
    except ImportError:
        return
    rows = speedup_table(agg, baseline_method)
    for dim in (2, 3):
        sub = [r for r in rows if r["Dimension"] == dim]
        if not sub:
            continue
        methods = sorted({r["Method"] for r in sub})
        sizes = sorted({r["Bodies"] for r in sub})
        grid = np.full((len(methods), len(sizes)), np.nan)
        for r in sub:
            grid[methods.index(r["Method"]), sizes.index(r["Bodies"])] = \
                r["Speedup"]
        fig, ax = plt.subplots(
            figsize=(1.2 + 1.1 * len(sizes), 0.8 + 0.45 * len(methods)))
        im = ax.imshow(np.log10(np.maximum(grid, 1e-3)), cmap="viridis",
                       aspect="auto")
        ax.set_xticks(range(len(sizes)), [f"{s:g}" for s in sizes])
        ax.set_yticks(range(len(methods)), methods, fontsize=7)
        for i in range(len(methods)):
            for j in range(len(sizes)):
                if np.isfinite(grid[i, j]):
                    ax.text(j, i, f"{grid[i, j]:.1f}x", ha="center",
                            va="center", fontsize=6, color="white")
        ax.set_xlabel("N bodies")
        ax.set_title(f"{dim}D speedup vs {baseline_method} (log color)")
        fig.colorbar(im, ax=ax, label="log10 speedup")
        fig.tight_layout()
        fig.savefig(os.path.join(results_dir,
                                 f"speedup_heatmap_{dim}D.png"), dpi=120)
        plt.close(fig)


def speedup_lines(agg: Dict[Key, dict], results_dir: str,
                  baseline_method: str = "BruteForce_JNP"):
    """Per-method speedup-vs-N line plots — the reference's
    ``analysis/2D_Speedup.png`` / ``3D_Speedup.png`` deliverables
    (notebook cells 2-12 plot speedup over BruteForce_Sequential; the
    baseline here is this engine's own sequential-analog jnp brute)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    rows = speedup_table(agg, baseline_method)
    for dim in (2, 3):
        sub = [r for r in rows if r["Dimension"] == dim]
        if not sub:
            continue
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for method in sorted({r["Method"] for r in sub}):
            pts = sorted((r["Bodies"], r["Speedup"]) for r in sub
                         if r["Method"] == method)
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    marker="o", markersize=3, label=method)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("N bodies")
        ax.set_ylabel(f"speedup vs {baseline_method}")
        ax.set_title(f"{dim}D speedup")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(os.path.join(results_dir, f"{dim}D_Speedup.png"),
                    dpi=120)
        plt.close(fig)


def main(argv=None) -> int:
    results_dir = argv[0] if argv else "results"
    rows = load_results(results_dir)
    if not rows:
        print(f"no valid result rows found in {results_dir}/*.csv")
        return 1
    agg = aggregate(rows)
    out_path = os.path.join(results_dir, "aggregated_results.csv")
    write_aggregated(agg, out_path)
    print(f"aggregated {len(rows)} rows into {len(agg)} groups -> {out_path}")
    for s in speedup_table(agg):
        print(f"  N={s['Bodies']:>9} {s['Dimension']}D "
              f"{s['Method']:<24} speedup {s['Speedup']:.2f}x")
    maybe_plot(agg, results_dir)
    speedup_heatmap(agg, results_dir)
    speedup_lines(agg, results_dir)
    ratio_heatmap_3d_vs_2d(agg, results_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
