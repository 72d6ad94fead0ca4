"""MNIST-workload-shape benchmark: the reference's classification config.

Reference workload (fixed_kan_tests.py:297-303): network [784, 32, 16, 16,
10], max_degree 5, 10k training samples, QUBO structure optimization with
1000 annealing reads.  Runs the same shapes on synthetic 784-dim data (real
MNIST is not redistributable here; the digits pipeline covers accuracy
validation) and reports per-phase wall clock.

    PYTHONPATH=. python benchmarks/mnist_bench.py
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--train-size", type=int, default=10000)
    parser.add_argument("--max-degree", type=int, default=5)
    parser.add_argument("--num-reads", type=int, default=1000)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from qkan_implementation.models.fixed_kan import FixedKAN, FixedKANConfig

    print(f"device={jax.devices()[0]}", file=sys.stderr)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (args.train_size, 784)).astype(np.float32)
    labels = rng.integers(0, 10, args.train_size)
    y = np.zeros((args.train_size, 10), dtype=np.float32)
    y[np.arange(args.train_size), labels] = 1.0

    config = FixedKANConfig(
        network_shape=[784, 32, 16, 16, 10],
        max_degree=args.max_degree,
        complexity_weight=0.1,
        lstsq_method="normal",  # on-device Cholesky path
    )
    kan = FixedKAN(config)

    t0 = time.time()
    kan.optimize(
        jnp.asarray(x),
        jnp.asarray(y),
        solver="anneal",
        num_reads=args.num_reads,
        num_sweeps=1000,
    )
    structure_time = time.time() - t0

    t0 = time.time()
    out = kan(jnp.asarray(x))
    jax.block_until_ready(out)
    fwd_time = time.time() - t0

    print(
        f"structure={structure_time:.1f}s forward_10k={fwd_time*1e3:.1f}ms",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": "MNIST-shape [784,32,16,16,10] deg5 10k structure optimization",
                "value": round(structure_time, 2),
                "unit": "seconds",
                "vs_baseline": None,
            }
        )
    )


if __name__ == "__main__":
    main()
