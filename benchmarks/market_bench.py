"""Market-data experiment benchmark: the reference's headline workload.

The reference's 250k-row Jane Street run (79 features, max_degree 3,
num_reads 1000) took 3,582.53 s on CPU
(output_result_250k_tail_corrected.txt:524, BASELINE.md).  This benchmark
runs the same pipeline shape -- parquet load, quantile normalization, date
split, per-degree scoring, QUBO degree search with 1000 annealing chains,
validation scoring -- on synthetic data of identical dimensions and reports
wall-clock per phase.

    PYTHONPATH=. python benchmarks/market_bench.py --rows 250000
"""

from __future__ import annotations

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=250_000)
    parser.add_argument("--features", type=int, default=79)
    parser.add_argument("--max-degree", type=int, default=3)
    parser.add_argument("--num-reads", type=int, default=1000)
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument(
        "--profile", default="demo", choices=["demo", "hard", "top"],
        help="'hard' = the generator calibrated to the reference's "
        "real-data regime (val comp-R^2 ~0.04-0.05, heavy tails, regime "
        "drift) so the quality column reads against the reference's "
        "0.2306 MSE / 0.0473 comp-R^2; 'top' = the high-signal regime of "
        "its curated-feature logs (val R^2 0.3242 top / 0.5147 tail); "
        "'demo' keeps the strong-signal wall-clock workload",
    )
    parser.add_argument(
        "--signal-frac", type=float, default=None,
        help="override the profile's calibrated signal fraction "
        "(generate_market_parquet)",
    )
    args = parser.parse_args()

    import jax
    import numpy as np

    from qkan_implementation.data.pipeline import (
        PROFILE_SIGNAL_FRAC,
        DataPipeline,
        generate_market_parquet,
    )
    from qkan_implementation.experiments.config import DataConfig
    from qkan_implementation.optim.degree_optimizer import DegreeOptimizer
    from qkan_implementation.utils.profiling import StageTimer

    print(f"device={jax.devices()[0]}", file=sys.stderr)
    timer = StageTimer(annotate_trace=False)

    with timer.stage("generate_data"):
        if args.data:
            path = args.data
        else:
            path = str(
                Path(tempfile.mkdtemp(prefix="market_bench_")) / "train.parquet"
            )
            generate_market_parquet(
                path, n_rows=args.rows, n_features=args.features,
                n_dates=200, profile=args.profile,
                signal_frac=args.signal_frac,
            )

    cfg = DataConfig(
        data_path=path,
        n_rows=args.rows,
        train_ratio=0.8,
        feature_cols=[f"feature_{i:02d}" for i in range(args.features)],
        target_col="responder_6",
        weight_col="weight",
        date_col="date_id",
    )
    with timer.stage("pipeline"):
        (
            train_df, train_target, train_weight, val_df, val_target, val_weight,
        ) = DataPipeline(cfg).load_and_preprocess_data()

    model = DegreeOptimizer(
        network_shape=[args.features, 1], max_degree=args.max_degree
    )
    with timer.stage("degree_search"):
        degrees = model.optimize_layer(
            layer_idx=0,
            x_data=train_df,
            y_data=train_target.to_numpy(),
            weights=train_weight.to_numpy(),
            num_reads=args.num_reads,
        )
    with timer.stage("validation_scoring"):
        scores, comp_r2 = model.evaluate_degree(
            val_df, val_target.to_numpy(), weights=val_weight.to_numpy()
        )

    total = timer.total
    best = int(np.argmin(scores))
    print(timer.report(), file=sys.stderr)
    print(
        f"degrees[0][:8]={degrees[0][:8]} val MSE per degree={scores}",
        file=sys.stderr,
    )
    # the reference's only timed run is the 250k-row log; other sizes get
    # no direct wall-clock baseline (its 1M log records quality only)
    vs = round(3582.53 / total, 1) if args.rows == 250_000 else None
    record = {
        "metric": f"market {args.rows//1000}k-row degree-search wall-clock",
        "value": round(total, 2),
        "unit": "seconds",
        "vs_baseline": vs,
        "best_degree_val_mse": float(scores[best]),
        "best_degree_val_comp_r2": float(comp_r2[best]),
    }
    print(json.dumps(record))
    # committed provenance record (VERDICT r1: regression artifacts)
    record.update(
        {
            "dataset": (
                args.data
                if args.data
                else f"synthetic parquet ({args.profile} profile), "
                f"{args.rows} rows x {args.features} features "
                f"(generate_market_parquet)"
            ),
            "profile": args.profile,
            # RESOLVED value: a null here used to mean "the calibrated
            # default was used" without saying what it was
            "signal_frac": (
                args.signal_frac
                if args.signal_frac is not None
                else PROFILE_SIGNAL_FRAC.get(args.profile)
            ),
            "reference_quality": (
                {"val_mse": 0.2306, "val_comp_r2": 0.0473,
                 "source": "output_result_250k_tail_corrected.txt:522-524"}
                if args.profile == "hard"
                else {
                    "val_comp_r2_top": 0.3242,
                    "val_comp_r2_tail": 0.5147,
                    "source": "output_result_top.txt:121, "
                    "output_result_tail.txt:114 (weighted zero-mean "
                    "comp-R^2, DegreeOptimizer._compute_metrics)",
                }
                if args.profile == "top"
                else None
            ),
            "phases": {k: round(v, 3) for k, v in timer.durations.items()},
            "device": str(jax.devices()[0]),
            "reference_baseline_s": 3582.53 if args.rows == 250_000 else None,
            "reference_source": (
                "output_result_250k_tail_corrected.txt:524 (250k rows only; "
                "the 1M log records quality, not wall-clock)"
            ),
        }
    )
    out = Path(__file__).resolve().parent / "records"
    out.mkdir(parents=True, exist_ok=True)
    tag = f"market_{args.rows//1000}k" + (
        "" if args.profile == "demo" else f"_{args.profile}"
    )
    (out / f"{tag}.json").write_text(
        json.dumps(record, indent=1)
    )


if __name__ == "__main__":
    main()
