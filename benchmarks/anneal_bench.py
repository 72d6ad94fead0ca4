"""Annealer head-to-head on dense NON-separable random QUBOs.

VERDICT r1 item 8: the degree-selection QUBO is blockwise-separable, so the
blocked annealer + one-hot polish always wins there; this benchmark pits the
general-purpose samplers against each other on the workload class where
nothing separates -- dense symmetric Gaussian couplings (Sherrington-
Kirkpatrick-style), the same family neal's own benchmarks use:

- ``simulated_annealing`` (JAX batched single-flip Metropolis, on-device)
- ``parallel_tempering`` (JAX replica exchange, on-device)
- ``anneal_native`` (the in-repo C++ annealer -- the neal-equivalent, CPU)
- ``brute_force_native`` ground truth where n <= 22

Reference workload shape: num_reads=1000
(/root/reference/original_degree_optimizer/DegreeOptimizer.py:236-237).

Writes one record per (n, sampler) to benchmarks/records/anneal_headtohead.json.

Run: PYTHONPATH=. JAX_PLATFORMS=cpu python benchmarks/anneal_bench.py
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import argparse
import json
import pathlib
import time

import numpy as np
import jax

from qkan_implementation.anneal import (
    QuboModel,
    greedy_descent,
    parallel_tempering,
    simulated_annealing,
)
from qkan_implementation.native_bindings import (
    brute_force_native,
    native_available,
)


def random_dense_qubo(n: int, seed: int) -> QuboModel:
    rng = np.random.default_rng(seed)
    J = rng.normal(0.0, 1.0 / np.sqrt(n), (n, n))
    J = J + J.T
    np.fill_diagonal(J, 0.0)
    h = rng.normal(0.0, 1.0, n)
    return QuboModel(h=h, J=J, offset=0.0)


def run(n: int, seed: int, sweeps: int, reads: int,
        no_native: bool = False) -> list[dict]:
    model = random_dense_qubo(n, seed)
    truth = None
    if n <= 22 and native_available():
        _, truth = brute_force_native(model)

    records = []

    def record(name, fn, warmup=True):
        # warm the compile with an identical call: num_reads/num_sweeps are
        # STATIC jit args, so a smaller warmup shape compiles a different
        # program and the timed call would still pay the compile.  Host samplers (neal, native C++) have no
        # compile to warm -- warmup=False skips the double run for them
        # (at n=2048 a native run is minutes of single-core sweeps).
        compile_plus_run = None
        if warmup:
            t0 = time.time()
            fn()
            compile_plus_run = time.time() - t0
        t0 = time.time()
        samples, energies = fn()
        best = float(np.min(energies))
        elapsed = time.time() - t0
        if compile_plus_run is not None and compile_plus_run > 3.0 * elapsed + 1.0:
            print(f"    [{name}: first call {compile_plus_run:.1f}s incl. compile]")
        rec = {
            "workload": f"dense Gaussian QUBO n={n} (seed {seed})",
            "sampler": name,
            "sweeps": sweeps,
            "total_chains": int(len(energies)),
            "best_energy": best,
            "ground_truth": truth,
            "gap_to_truth": None if truth is None else best - truth,
            "found_ground_state": None
            if truth is None
            else bool(best <= truth + 1e-6),
            "wall_s": round(elapsed, 3),
            "platform": jax.devices()[0].platform,
        }
        records.append(rec)
        gap = "" if truth is None else f"  gap={best - truth:+.4f}"
        print(f"  {name:22s} best={best:.4f}{gap}  {elapsed:.2f}s")

    print(f"n={n} (ground truth: {truth})")

    def polished(fn):
        samples, _ = fn()
        samples = greedy_descent(model, samples)
        return samples, model.energy(samples)

    record(
        "sa_jax",
        lambda: polished(
            lambda: simulated_annealing(
                model, num_reads=reads, num_sweeps=sweeps, seed=seed
            )
        ),
    )
    # same total chain budget: chains x replicas = reads
    replicas = 16
    record(
        "tempering_jax",
        lambda: polished(
            lambda: parallel_tempering(
                model,
                num_chains=max(1, reads // replicas),
                num_replicas=replicas,
                num_sweeps=sweeps,
                seed=seed,
            )
        ),
    )
    if native_available() and not no_native:
        record(
            "native_cpp",
            lambda: simulated_annealing(
                model, num_reads=reads, num_sweeps=sweeps, seed=seed,
                backend="native",
            ),
            warmup=False,
        )
    return records


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[20, 64, 128])
    ap.add_argument("--sweeps", type=int, default=1000)
    ap.add_argument("--reads", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--no-native", action="store_true",
                    help="skip the C++ sampler rows (minutes of "
                    "single-core sweeps per run at n>=2048)")
    args = ap.parse_args()

    all_records = []
    for n in args.sizes:
        all_records.extend(
            run(n, args.seed, args.sweeps, args.reads, args.no_native)
        )

    out = pathlib.Path(__file__).resolve().parent / "records"
    out.mkdir(parents=True, exist_ok=True)
    path = out / "anneal_headtohead.json"
    # merge: keep rows from other platforms/workloads (the head-to-head
    # record holds rows of several platforms side by side); replace rows this run
    # re-measured
    existing = json.loads(path.read_text()) if path.exists() else []
    # the key includes the chain budget: a smoke run with --reads 64 must
    # never silently overwrite the committed full-budget evidence rows
    # (these records are regression evidence)
    key = lambda r: (
        r["workload"], r["sampler"], r["sweeps"], r["platform"],
        r["total_chains"],
    )
    fresh_keys = {key(r) for r in all_records}
    merged = [r for r in existing if key(r) not in fresh_keys] + all_records
    path.write_text(json.dumps(merged, indent=1))
    print(f"records -> {path} ({len(merged)} rows)")


if __name__ == "__main__":
    main()
