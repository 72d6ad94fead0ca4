"""Headline benchmark: QKANLayer forward+backward throughput on the GPU.

Prints the card's name and power limit on one line, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": ...}

Workload (from BASELINE.json): QKANLayer(N=16, K=16, degree=7) fused
forward+backward, batched.  The baseline is a reference-faithful NumPy
implementation of the same layer -- dense NK x NK diagonal matrices and the
per-element Python Chebyshev loop, exactly the algorithm of
``QKAN_Steps_original/QKANLayer.py:124-135`` / ``ChebyshevStep.py:32-65``
(forward only; it has no backward at all) -- measured in-process on the
host CPU.  ``vs_baseline`` is our layers/sec over its layers/sec.

Exits non-zero without a GPU: a CPU number is never reported as a device
number.  Extra diagnostics go to stderr.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def reference_faithful_forward(x, weights, N, K):
    """The reference's algorithm, reproduced for timing: dense diagonals,
    per-element Chebyshev via cos/arccos in a Python loop."""
    max_degree = len(weights) - 1
    combined = np.zeros((N * K, N * K))
    for d in range(max_degree + 1):
        cheb_vals = np.array(
            [np.cos(d * np.arccos(np.clip(xi, -1, 1))) for xi in x]
        )
        dilated = np.diag(np.repeat(cheb_vals, K))
        weighted = np.diag(np.diag(dilated) * weights[d])
        combined += weighted / (max_degree + 1)
    lcu_diag = np.diag(combined)
    reshaped = lcu_diag.reshape(N, K, order="F")
    return np.sum(reshaped, axis=0) / N


def card_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def main():
    import jax
    import jax.numpy as jnp

    from qkan_implementation.ops import qkan_layer_forward_batched
    from qkan_implementation.utils.platform import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    print(card_name_and_power_limit())

    N = K = 16
    d = 7
    B = 262144
    rng = np.random.default_rng(0)
    x_np = rng.uniform(-1, 1, (B, N))
    w_np = rng.uniform(-1, 1, (d + 1, N * K))
    # 2x input POOL, rotated inside the scan body: with a single fixed x
    # the tanh/Chebyshev prefix depends only on loop-invariant data and
    # XLA hoists it OUT of the chain, so the chain would time only the
    # matmuls
    x_pool = jnp.asarray(np.stack([x_np, x_np[::-1]]), dtype=jnp.float32)
    w = jnp.asarray(w_np, dtype=jnp.float32)

    def loss(w, x):
        return jnp.sum(qkan_layer_forward_batched(x, w, N, K) ** 2)

    grad = jax.grad(loss)
    iters = 200

    @jax.jit
    def chained(w, x_pool):
        # dependent fwd+bwd steps in one dispatch
        def body(w, i):
            xi = jax.lax.dynamic_index_in_dim(
                x_pool, i % 2, axis=0, keepdims=False
            )
            return w - 1e-7 * grad(w, xi), None

        return jax.lax.scan(body, w, jnp.arange(iters, dtype=jnp.int32))[0]

    t0 = time.perf_counter()
    jax.block_until_ready(chained(w, x_pool))
    compile_s = time.perf_counter() - t0
    per_steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(chained(w, x_pool))
        per_steps.append((time.perf_counter() - t0) / iters)
    per_step = float(np.median(per_steps))
    spread_pct = 100.0 * (max(per_steps) - min(per_steps)) / per_step
    ours_layers_per_sec = B / per_step
    print(
        f"device={dev.device_kind} compile+first run={compile_s:.2f}s; "
        f"{per_step * 1e3:.4f} ms/step median of 5 "
        f"{[round(p * 1e3, 4) for p in per_steps]} ms",
        file=sys.stderr,
    )

    # baseline: reference-faithful NumPy forward (single sample at a time)
    got = np.asarray(
        qkan_layer_forward_batched(
            jnp.asarray(x_np[:1]), jnp.asarray(w_np), N, K
        )
    )[0]
    want = reference_faithful_forward(x_np[0], w_np, N, K)
    err = float(np.max(np.abs(got - want)))
    if err > 1e-3:
        sys.exit(f"parity check failed: max abs err {err:.3e}")
    base_iters = 5
    t0 = time.perf_counter()
    for i in range(base_iters):
        reference_faithful_forward(x_np[i % B], w_np, N, K)
    base_layers_per_sec = base_iters / (time.perf_counter() - t0)

    print(json.dumps({
        "metric": "QKANLayer(N=16,K=16,deg=7) fwd+bwd layers/sec",
        "value": round(ours_layers_per_sec, 1),
        "unit": "layers/sec",
        "vs_baseline": round(ours_layers_per_sec / base_layers_per_sec, 2),
        "spread_pct": round(spread_pct, 1),
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))


if __name__ == "__main__":
    main()
