"""Committed evidence for the reference's flagship MNIST workload shape.

The reference's headline experiment is FixedKAN [784, 32, 16, 16, 10],
max_degree 5, 10k train samples on real MNIST, with saved accuracy
artifacts (fixed_kan_tests.py:293-410; accuracies 0.5127/0.2671 at
analyze_model_utils.py:233-241).  Real MNIST is unavailable in this
environment (no network egress), so this runs the SAME workload shape on
``digits-784``: real handwritten-digit scans (the 8x8 digits set) bilinearly
upsampled to 28x28 and shift/noise-augmented to 10k samples -- labeled as
such everywhere, never presented as MNIST.

Three configurations per run:
  reference-faithful  -- the reference's exact semantics (degenerate
                         degree reward and tanh inconsistency included)
  improved            -- penalized-MSE objective + consistent tanh
  improved+train      -- plus full-gradient refinement epochs

Artifacts -> benchmarks/records/mnist_shape_{config}.json (+ 64-dim digits
baseline rows for the quality table).

Run: PYTHONPATH=. python benchmarks/mnist_shape_evidence.py           (GPU)
     PYTHONPATH=. JAX_PLATFORMS=cpu python benchmarks/mnist_shape_evidence.py --quick
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import argparse
import json
import pathlib

import jax

from qkan_implementation.experiments.mnist import run_mnist_experiment


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="tiny CPU smoke")
    ap.add_argument("--train-size", type=int, default=10000)
    ap.add_argument(
        "--only",
        default=None,
        help="run a single flagship config by name (skips the digits-64 "
        "and shallow rows) -- e.g. improved_trained_bf16",
    )
    ap.add_argument(
        "--nruns",
        type=int,
        default=1,
        help="with --only: run N sampling seeds through the statistical "
        "harness and write a *_nruns.json record (mean/std/min/max)",
    )
    ap.add_argument(
        "--ensemble",
        action="store_true",
        help="with --nruns: also evaluate the N seed-varied models as one "
        "soft-voting ensemble (adds ensemble_test_accuracy to the record)",
    )
    args = ap.parse_args()

    train_size = 500 if args.quick else args.train_size
    shape = [784, 16, 10] if args.quick else [784, 32, 16, 16, 10]
    num_reads = 64 if args.quick else 1000
    epochs = 2 if args.quick else 15

    configs = {
        # the reference's exact config incl. complexity_weight=0.1
        # (fixed_kan_tests.py:297-303) -- its degree reward is degenerate,
        # so ~chance accuracy is the faithful outcome
        "reference_faithful": dict(
            degree_objective="reference", consistent_tanh=False,
            complexity_weight=0.1, weight_epochs=0,
        ),
        "improved": dict(
            degree_objective="penalized_mse", consistent_tanh=True,
            complexity_weight=0.001, weight_epochs=0,
        ),
        # fan-in-scaled per-layer Adam lr: without it the wide first
        # layer's outputs drift past tanh saturation and the stack
        # collapses (see FixedKAN.train docstring)
        "improved_trained": dict(
            degree_objective="penalized_mse", consistent_tanh=True,
            complexity_weight=0.001, weight_epochs=epochs,
            weight_trainable="all", weight_lr_scale="fanin",
            weight_grad_clip=1.0, learning_rate=0.002,
        ),
        "improved_trained_bf16": dict(
            degree_objective="penalized_mse", consistent_tanh=True,
            complexity_weight=0.001, weight_epochs=epochs,
            weight_trainable="all", weight_lr_scale="fanin",
            weight_grad_clip=1.0, learning_rate=0.002,
            weight_compute_dtype="bfloat16",
        ),
        # the measured capability ceiling: doubling epochs WITH the cosine
        # schedule (constant-lr 30ep overfits: 0.881) -- 0.900 single-seed
        # CPU on the QR structure path
        "improved_trained_cosine30": dict(
            degree_objective="penalized_mse", consistent_tanh=True,
            complexity_weight=0.001, weight_epochs=2 * epochs,
            weight_trainable="all", weight_lr_scale="fanin",
            weight_grad_clip=1.0, learning_rate=0.002,
            weight_lr_schedule="cosine",
        ),
        # practical-ceiling recipe: the cosine30 schedule at max_degree 7
        # (richer per-edge basis; single-seed probe measured 0.9028 vs
        # 0.900 at the reference's degree 5)
        "improved_trained_cosine30_deg7": dict(
            degree_objective="penalized_mse", consistent_tanh=True,
            complexity_weight=0.001, weight_epochs=2 * epochs,
            weight_trainable="all", weight_lr_scale="fanin",
            weight_grad_clip=1.0, learning_rate=0.002,
            weight_lr_schedule="cosine", max_degree=7,
        ),
    }

    out = pathlib.Path(__file__).resolve().parent / "records"
    out.mkdir(parents=True, exist_ok=True)
    # quick smoke runs must never clobber the committed records
    pre = "QUICK_" if args.quick else ""
    if args.only is not None:
        if args.only not in configs:
            raise SystemExit(
                f"unknown config {args.only!r}; choose from {sorted(configs)}"
            )
        configs = {args.only: configs[args.only]}
    note = (
        "dataset is digits-784 (upsampled+augmented 8x8 digits), "
        "NOT MNIST; reference MNIST baselines 0.5127/0.2671 are not "
        "directly comparable"
    )
    for name, overrides in configs.items():
        print(f"=== {name} ===")
        common = dict(
            network_shape=shape,
            max_degree=5,
            train_size=train_size,
            dataset="digits-784",
            lstsq_method="normal",
            num_reads=num_reads,
        )
        common.update(overrides)  # configs may override max_degree etc.
        if args.nruns > 1:
            from qkan_implementation.experiments.mnist import (
                run_mnist_n_times,
            )

            res = run_mnist_n_times(
                n=args.nruns, verbose=True, ensemble=args.ensemble,
                **common,
            )
            res.pop("distributions", None)
            for r in res["runs"]:
                r["device"] = str(jax.devices()[0])
                r["config_name"] = name
            res["note"] = note
            plat = jax.devices()[0].platform
            (
                out / f"{pre}mnist_shape_{name}_{plat}_nruns.json"
            ).write_text(json.dumps(res, indent=1))
            print(
                f"{name}: {res['test_accuracy_mean']:.4f} "
                f"+- {res['test_accuracy_std']:.4f} "
                f"(min {res['test_accuracy_min']:.4f}, "
                f"max {res['test_accuracy_max']:.4f})"
            )
            if args.ensemble:
                print(
                    f"{name}: soft-voting ensemble of {args.nruns} = "
                    f"{res['ensemble_test_accuracy']:.4f}"
                )
            continue
        res = run_mnist_experiment(verbose=True, **common)
        res.pop("_model", None)
        res["config_name"] = name
        res["device"] = str(jax.devices()[0])
        res["note"] = note
        (out / f"{pre}mnist_shape_{name}.json").write_text(
            json.dumps(res, indent=1)
        )

    if args.only is not None:
        print(f"records -> {out}")
        return

    # 64-dim digits quality rows (no upsampling) for the quality table
    for name, overrides in configs.items():
        print(f"=== digits-64 {name} ===")
        res = run_mnist_experiment(
            network_shape=None,  # -> [64, 32, 16, 16, 10]
            max_degree=5,
            train_size=train_size,
            dataset="auto",
            lstsq_method="normal",
            num_reads=num_reads,
            verbose=True,
            **overrides,
        )
        res.pop("_model", None)
        res["config_name"] = name
        res["device"] = str(jax.devices()[0])
        (out / f"{pre}digits64_{name}.json").write_text(json.dumps(res, indent=1))

    # shallow-shape quality rows: the deep reference architecture (every
    # layer greedily fit to the same y) caps accuracy; a [in, 16, 10]
    # stack shows what the optimizer+trainer reach when the architecture
    # is not the bottleneck
    for tag, ds, shp in (
        ("digits784_shallow", "digits-784", [784, 16, 10]),
        ("digits64_shallow", "auto", [64, 16, 10]),
    ):
        print(f"=== {tag} improved_trained ===")
        res = run_mnist_experiment(
            network_shape=shp,
            max_degree=5,
            train_size=train_size,
            dataset=ds,
            lstsq_method="normal",
            num_reads=num_reads,
            verbose=True,
            **configs["improved_trained"],
        )
        res.pop("_model", None)
        res["config_name"] = "improved_trained_shallow"
        res["device"] = str(jax.devices()[0])
        (out / f"{pre}{tag}_improved_trained.json").write_text(
            json.dumps(res, indent=1)
        )
    print(f"records -> {out}")


if __name__ == "__main__":
    main()
