"""Serving latency/throughput record for the BatchedPredictor.

Builds a flagship-shape FixedKAN ([784, 32, 16, 16, 10], deg 5), wraps it
in ``serving.BatchedPredictor``, warms every bucket, then measures
per-request latency (p50/p99) at several request sizes and steady-state
throughput at the max bucket.

Request latency includes the host-to-device copy of each request and the
copy back; the device-resident rows stage inputs on the device and time a
chained scan, which is the device rate alone.

Run: PYTHONPATH=. python benchmarks/serving_bench.py           (GPU)
     PYTHONPATH=. JAX_PLATFORMS=cpu python benchmarks/serving_bench.py --quick
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import argparse
import json
import pathlib
import time

import numpy as np
import jax
import jax.numpy as jnp

from qkan_implementation.models.fixed_kan import FixedKAN, FixedKANConfig
from qkan_implementation.serving import BatchedPredictor


def build_model(shape, max_degree=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (1024, shape[0])).astype(np.float32)
    y = np.eye(shape[-1], dtype=np.float32)[rng.integers(0, shape[-1], 1024)]
    kan = FixedKAN(
        FixedKANConfig(
            network_shape=shape, max_degree=max_degree, lstsq_method="normal"
        )
    )
    kan.optimize(jnp.asarray(x), jnp.asarray(y), solver="exact")
    return kan


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--max-batch", type=int, default=4096)
    ap.add_argument("--requests", type=int, default=50)
    args = ap.parse_args()

    shape = [64, 16, 10] if args.quick else [784, 32, 16, 16, 10]
    requests = 10 if args.quick else args.requests
    max_batch = 256 if args.quick else args.max_batch

    kan = build_model(shape)
    pred = BatchedPredictor(kan, max_batch=max_batch)
    t0 = time.time()
    pred.warmup()
    warmup_s = time.time() - t0

    rng = np.random.default_rng(1)
    dev = jax.devices()[0]
    results = {
        "workload": f"BatchedPredictor FixedKAN {shape} deg 5",
        "platform": dev.platform,
        "device": str(dev),
        "max_batch": max_batch,
        "warmup_s": round(warmup_s, 2),
        "latency_note": (
            "every predict() ships the input batch host->device and "
            "fetches the output back; device_resident_rows_per_sec is "
            "the device rate with on-device batching."
        ),
        "request_sizes": {},
    }

    for n in [1, 32, max_batch // 4, max_batch]:
        n = max(1, n)
        lat = []
        for _ in range(requests):
            x = rng.uniform(-1, 1, (n, shape[0])).astype(np.float32)
            t0 = time.perf_counter()
            out = pred.predict(x)
            lat.append(time.perf_counter() - t0)
            assert out.shape == (n, shape[-1])
        lat = np.array(lat)
        results["request_sizes"][str(n)] = {
            "p50_ms": round(float(np.percentile(lat, 50) * 1e3), 3),
            "p99_ms": round(float(np.percentile(lat, 99) * 1e3), 3),
            "rows_per_sec": round(float(n / np.percentile(lat, 50)), 1),
        }
        print(
            f"batch {n:5d}: p50 {np.percentile(lat, 50)*1e3:8.2f} ms  "
            f"p99 {np.percentile(lat, 99)*1e3:8.2f} ms  "
            f"{n / np.percentile(lat, 50):12.0f} rows/s"
        )

    # steady-state throughput: back-to-back max-bucket requests
    x = rng.uniform(-1, 1, (max_batch, shape[0])).astype(np.float32)
    reps = 5 if args.quick else 20
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict(x)
    dt = time.perf_counter() - t0
    results["steady_state_rows_per_sec"] = round(max_batch * reps / dt, 1)
    mb = x.nbytes / 1e6
    results["request_payload_mb"] = round(mb, 2)
    results["effective_ingest_mb_per_sec"] = round(mb * reps / dt, 1)
    results["predictor_stats"] = pred.stats()
    print(
        f"steady state ({reps} x {max_batch}): "
        f"{max_batch * reps / dt:,.0f} rows/s "
        f"({mb * reps / dt:.0f} MB/s ingest)"
    )

    # device-resident throughput: the chip-rate number with host<->device
    # transfer out of the loop (inputs staged on device, chained scan,
    # slope-timed) -- what a colocated server with on-device batching sees
    import jax.numpy as jnp

    from qkan_implementation.utils.profiling import timeit_chained

    xd = jnp.asarray(x)
    params = kan.params
    apply_ = pred._apply

    # params ride timeit_chained's consts (scan operands), not a closure:
    # closed-over device arrays bake into the program as constants
    def step(xc, params):
        out = apply_(params, xc)
        return xc + 1e-30 * jnp.mean(out).astype(xc.dtype)

    per_step = timeit_chained(
        step, xd, iters=5 if args.quick else 100, consts=(params,)
    )
    results["device_resident_rows_per_sec"] = round(max_batch / per_step, 1)
    results["device_resident_ms_per_batch"] = round(per_step * 1e3, 3)
    print(
        f"device-resident: {max_batch / per_step:,.0f} rows/s "
        f"({per_step * 1e3:.3f} ms per {max_batch}-batch)"
    )

    # the serving accuracy-throughput frontier: device-resident throughput
    # of every precision path measured the same way.  The matching
    # ACCURACY column at flagship fan-in comes from
    # benchmarks/eval_precision_probe.py -- read the two records together.
    # 'xla' = the default policy without the fused kernel; 'default' =
    # the device default (TF32) everywhere; 'int8x2' = two-level residual
    # int8 (3 int8 dots).
    from functools import partial
    import warnings

    from qkan_implementation.models.fixed_kan import kan_apply

    paths = [
        ("xla", dict(backend="xla")),
        ("default", dict(matmul_precision=None)),
        ("bf16io", dict(compute_dtype=jnp.bfloat16)),
        ("int8", dict(compute_dtype=jnp.int8)),
        ("int8x2", dict(compute_dtype="int8x2")),
        ("int8x2w", dict(compute_dtype="int8x2w")),
    ]
    for name, kw in paths:
        path_apply = jax.jit(
            partial(kan_apply, max_degree=kan.config.max_degree, **kw)
        )

        def step_p(xc, params):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # int8 wide-fan-in advisory
                out = path_apply(params, xc)
            return xc + 1e-30 * jnp.mean(out).astype(xc.dtype)

        per_step_p = timeit_chained(
            step_p, xd, iters=5 if args.quick else 200, consts=(params,)
        )
        results[f"device_resident_{name}_rows_per_sec"] = round(
            max_batch / per_step_p, 1
        )
        results[f"device_resident_{name}_ms_per_batch"] = round(
            per_step_p * 1e3, 3
        )
        print(
            f"device-resident ({name}): {max_batch / per_step_p:,.0f} "
            f"rows/s ({per_step_p * 1e3:.3f} ms per {max_batch}-batch)"
        )

    out_dir = pathlib.Path(__file__).resolve().parent / "records"
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"serving_latency_{dev.platform}.json"
    (out_dir / name).write_text(json.dumps(results, indent=1))
    print(f"records -> {out_dir / name}")


if __name__ == "__main__":
    main()
