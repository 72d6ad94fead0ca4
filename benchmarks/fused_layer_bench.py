"""Fused layer kernel against the plain XLA layer at flagship layer 0.

``kan_layer_apply`` at [784 -> 32], T=10, D=5, B=8192 (fan-in 4704) with
``backend='fused'`` (``ops/fused_layer.py``) and ``backend='xla'``:

- forward at the device default (TF32 on the GPU) and at
  BF16_BF16_F32_X3 (the serving policy);
- weight gradient at the device default (the training step's layer-0
  backward: XLA drops dx there, since layer 0's input is data).

Times are device time per call read from a ``jax.profiler`` trace
(``utils.profiling.device_kernel_times``): every kernel of the program,
with no host dispatch in them and no loop for XLA to hoist work out of.
The error of each row is against the same layer under full f32
('highest').  Prints one JSON object; chip_smoke.py phase 6 prints the
same measurement.

Run (GPU): PYTHONPATH=. python benchmarks/fused_layer_bench.py
"""

from __future__ import annotations

import json
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.models.fixed_kan import kan_layer_apply
from qkan_implementation.utils.profiling import device_kernel_times


def layer0_rows(calls: int = 50, batch: int = 8192, in_dim: int = 784,
                out: int = 32, T: int = 10, D: int = 5, seed: int = 4) -> dict:
    """{row: {kernel_ms, xla_ms, err_kernel, err_xla, kernel_in_trace,
    top kernels}}; off the GPU the times are 0 and kernel_in_trace False."""
    rng = np.random.default_rng(seed)
    lp = {
        "degrees": jnp.asarray(rng.integers(1, D + 1, out), jnp.int32),
        "coefficients": jnp.asarray(
            rng.normal(0, 0.02, (out, in_dim, D + 1, T)), jnp.float32
        ),
        "horizontal_weights": jnp.ones(out, jnp.float32),
    }
    x = jnp.asarray(rng.uniform(0, 1, (batch, in_dim)), jnp.float32)
    g = jnp.asarray(rng.normal(size=(batch, T)), jnp.float32)

    def fwd(backend, prec):
        return jax.jit(lambda c, x: kan_layer_apply(
            dict(lp, coefficients=c), x, D, backend=backend,
            matmul_precision=prec,
        ))

    def dw(backend, prec):
        return jax.jit(jax.grad(lambda c, x: jnp.sum(kan_layer_apply(
            dict(lp, coefficients=c), x, D, backend=backend,
            matmul_precision=prec,
        ) * g)))

    rows = {}
    for name, make, prec in (
        ("fwd_tf32", fwd, None),
        ("fwd_bf16x3", fwd, "BF16_BF16_F32_X3"),
        ("dw_tf32", dw, None),
    ):
        ref = np.asarray(make("xla", "highest")(lp["coefficients"], x))
        row = {}
        for backend in ("fused", "xla"):
            fn = make(backend, prec)
            got = np.asarray(fn(lp["coefficients"], x))
            kernels = device_kernel_times(fn, lp["coefficients"], x, calls=calls)
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
            key = "kernel" if backend == "fused" else "xla"
            if backend == "fused":
                row["kernel_in_trace"] = any(
                    "kan_layer_fused" in k for k in kernels
                )
            row[f"{key}_ms"] = sum(kernels.values())
            row[f"err_{key}"] = float(
                np.max(np.abs(got - ref)) / np.max(np.abs(ref))
            )
            row[f"{key}_top"] = [[k[:60], round(v, 5)] for k, v in top]
        rows[name] = row
    return rows


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "rows": layer0_rows()}, indent=1))


if __name__ == "__main__":
    main()
