"""Full multi-chip training run: FixedKAN over a device mesh.

A full training run across a device mesh, runnable on any mesh -- several
GPUs of one host, or the virtual 8-device CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      PYTHONPATH=. python benchmarks/multichip_train.py

Pipeline: digits classification data -> QUBO structure optimization with
mesh-sharded annealing chains -> data-parallel full-gradient training
(batch sharded over the mesh, gradient psum via sharding propagation) ->
accuracy + throughput report.
"""

from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--train-size", type=int, default=1024)
    parser.add_argument("--max-degree", type=int, default=3)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qkan_implementation.data.mnist import (
        load_mnist,
        sample_train_subset,
        to_one_hot,
    )
    from qkan_implementation.models.fixed_kan import (
        FixedKAN,
        FixedKANConfig,
        kan_apply,
    )
    from qkan_implementation.parallel import make_mesh

    n_dev = len(jax.devices())
    # mesh sizes must be powers of two for the sharded annealer
    n_mesh = 1 << (n_dev.bit_length() - 1)
    mesh = make_mesh(n_mesh, axis_name="dp")
    print(f"devices={n_dev} mesh={mesh.shape}")

    x_full, y_full, meta = load_mnist(train=True)
    x_test, y_test, _ = load_mnist(train=False)
    x_train, y_labels = sample_train_subset(
        x_full, y_full, args.train_size, seed=0
    )
    y_train = to_one_hot(y_labels, 10)

    config = FixedKANConfig(
        network_shape=[meta["image_dim"], 16, 10],
        max_degree=args.max_degree,
        complexity_weight=1e-3,
        degree_objective="penalized_mse",
        consistent_tanh=True,
    )
    kan = FixedKAN(config)

    t0 = time.time()
    kan.optimize(
        jnp.asarray(x_train, dtype=jnp.float32),
        jnp.asarray(y_train, dtype=jnp.float32),
        solver="anneal",
        num_reads=128 * n_mesh,
        num_sweeps=500,
        mesh=mesh,  # chains shard across the mesh
    )
    t_structure = time.time() - t0
    print(f"structure optimization (mesh-sharded anneal): {t_structure:.1f}s")

    # ---- data-parallel full-gradient training over the mesh --------------
    max_degree = config.max_degree
    degrees = [lp["degrees"] for lp in kan.params]
    train_params = [
        {k: v for k, v in lp.items() if k != "degrees"} for lp in kan.params
    ]

    # pad the batch to a multiple of the mesh and shard it
    b = (args.train_size // n_mesh) * n_mesh
    x = jnp.asarray(x_train[:b], dtype=jnp.float32)
    y = jnp.asarray(y_train[:b], dtype=jnp.float32)
    x = jax.device_put(x, NamedSharding(mesh, P("dp")))
    y = jax.device_put(y, NamedSharding(mesh, P("dp")))
    train_params = jax.device_put(train_params, NamedSharding(mesh, P()))

    def loss_fn(tp, xb, yb):
        full = [dict(p, degrees=d) for p, d in zip(tp, degrees)]
        logits = kan_apply(full, xb, max_degree)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.sum(yb * logp, axis=-1))

    @jax.jit
    def step(tp, xb, yb):
        loss, grads = jax.value_and_grad(loss_fn)(tp, xb, yb)
        tp = jax.tree.map(lambda p, g: p - 0.05 * g, tp, grads)
        return tp, loss

    t0 = time.time()
    losses = []
    for epoch in range(args.epochs):
        train_params, loss = step(train_params, x, y)
        losses.append(float(loss))
    jax.block_until_ready(train_params)
    t_train = time.time() - t0
    print(
        f"training: {args.epochs} full-batch steps in {t_train:.2f}s "
        f"({args.epochs * b / max(t_train, 1e-9):,.0f} samples/s); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}"
    )

    kan.params = [dict(tp, degrees=d) for tp, d in zip(train_params, degrees)]
    pred = np.asarray(kan(jnp.asarray(x_test, dtype=jnp.float32))).argmax(axis=1)
    acc = float((pred == y_test).mean())
    print(f"test accuracy: {acc:.4f}")
    assert losses[-1] < losses[0], "training did not reduce loss"


if __name__ == "__main__":
    main()
