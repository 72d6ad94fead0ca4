"""Whole-model train step at the flagship shape.

One jitted program: FixedKAN [784, 32, 16, 16, 10] forward + backward +
Adam update, scanned on-device and slope-timed (two chain lengths cancel
the fixed per-call cost).  Reports steps/sec and achieved matmul TFLOP/s
(counting the layer contractions of fwd+bwd only -- basis construction,
tanh, and the optimizer update are excluded, so the TFLOP/s figure is a
lower bound).

Rows: f32 with the automatic layer backend (the fused kernel of
ops/fused_layer.py on a GPU's wide layer), f32 with XLA only, and bf16io
(bf16 matmul inputs, f32 accumulation -- the cast-placement recipe of
ops/qkan_layer.py).

Run: PYTHONPATH=. python benchmarks/flagship_train_step.py           (GPU)
     PYTHONPATH=. JAX_PLATFORMS=cpu python benchmarks/flagship_train_step.py --quick
"""

from qkan_implementation.utils.platform import enable_compile_cache

enable_compile_cache()

import argparse
import json
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np

from qkan_implementation.models.fixed_kan import (
    FixedKAN,
    FixedKANConfig,
    kan_apply,
)


def build_model(shape, max_degree, batch, seed=0):
    """Structure-optimize on synthetic data (exact solver) so the timed
    params have the real pytree layout; force all degrees to max_degree so
    the timed FLOPs are the full-capacity worst case."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (min(batch, 2048), shape[0])).astype(np.float32)
    y = np.eye(shape[-1], dtype=np.float32)[
        rng.integers(0, shape[-1], x.shape[0])
    ]
    kan = FixedKAN(
        FixedKANConfig(
            network_shape=shape, max_degree=max_degree,
            lstsq_method="normal",
        )
    )
    kan.optimize(jnp.asarray(x), jnp.asarray(y), solver="exact")
    dp1 = max_degree + 1
    for lp in kan.params:
        out = lp["degrees"].shape[0]
        lp["degrees"] = jnp.full((out,), max_degree, dtype=jnp.int32)
        c = np.asarray(lp["coefficients"])
        lp["coefficients"] = jnp.asarray(
            np.random.default_rng(1).normal(0, 0.05, c.shape).astype(c.dtype)
        )
    return kan


def matmul_flops_per_step(shape, max_degree, t_dim, batch):
    """fwd contraction (2F) + bwd dW and dx (4F) over the layer matmuls.

    Layer l consumes in_l = shape[0] if l == 0 else t_dim features.  The
    collapsed layer (kan_layer_apply: weights pre-summed over `o`) runs
    ONE [B, in*(D+1)] @ [in*(D+1), T] matmul per layer, so the honest
    per-batch contraction volume is in*(D+1)*T -- `out`x smaller than the
    naive bid,oidt->bt reduction this bench counted before the collapse.
    Returns (collapsed_flops, naive_flops); TFLOP/s is reported against
    the COLLAPSED count (work actually dispatched), while naive/collapsed
    is the algorithmic-speedup factor."""
    dp1 = max_degree + 1
    collapsed = naive = 0
    in_dim = shape[0]
    for out_dim in shape[1:]:
        collapsed += in_dim * dp1 * t_dim
        naive += in_dim * dp1 * out_dim * t_dim
        in_dim = t_dim
    return 6 * batch * collapsed, 6 * batch * naive


def slope_time(step_fn, carry, short_n=10, factor=6):
    """seconds/step via two on-device scan chain lengths."""

    def make(n):
        @jax.jit
        def chain(carry):
            def body(c, _):
                return step_fn(c), None

            final, _ = jax.lax.scan(body, carry, None, length=n)
            return final

        return chain

    long_n = short_n * factor
    c_s, c_l = make(short_n), make(long_n)
    r = c_s(carry)
    jax.tree.map(lambda a: np.asarray(a), r)  # force completion via fetch
    r = c_l(carry)
    jax.tree.map(lambda a: np.asarray(a), r)

    def timed(c):
        t0 = time.time()
        out = c(carry)
        jax.tree.map(lambda a: np.asarray(a), out)
        return time.time() - t0

    t_s = min(timed(c_s) for _ in range(2))
    t_l = min(timed(c_l) for _ in range(2))
    return (t_l - t_s) / (long_n - short_n)


def main():
    import optax

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-3)
    args = ap.parse_args()

    shape = [784, 16, 10] if args.quick else [784, 32, 16, 16, 10]
    batch = 256 if args.quick else args.batch
    max_degree = 5
    kan = build_model(shape, max_degree, batch)
    t_dim = shape[-1]

    # 2*batch-row pool, each step training on a DIFFERENT rotating slice:
    # with a fixed batch the layer-0 tanh+basis is loop-invariant and XLA
    # can hoist it out of the timing scan, flattering every variant by the
    # cost of the dominant tensor.  Real training streams fresh batches.
    rng = np.random.default_rng(3)
    pool_x = jnp.asarray(
        rng.uniform(-1, 1, (2 * batch, shape[0])).astype(np.float32)
    )
    pool_y = jnp.asarray(
        np.eye(t_dim, dtype=np.float32)[rng.integers(0, t_dim, 2 * batch)]
    )

    degrees = [lp["degrees"] for lp in kan.params]
    train_params = [
        {k: v for k, v in lp.items() if k != "degrees"} for lp in kan.params
    ]
    opt = optax.adam(args.lr)

    flops, naive_flops = matmul_flops_per_step(
        shape, max_degree, t_dim, batch
    )
    results = {
        "workload": f"FixedKAN {shape} deg {max_degree} fwd+bwd+adam",
        "batch": batch,
        "device": str(jax.devices()[0]),
        "platform": jax.devices()[0].platform,
        "matmul_flops_per_step": flops,
        "naive_oidt_flops_per_step": naive_flops,
        "collapse_speedup_factor": round(naive_flops / flops, 1),
        "flops_note": (
            "collapsed layer-contraction flops only (fwd 2F + bwd 4F); "
            "basis/tanh/optimizer excluded -- TFLOP/s is a lower bound.  "
            "naive_oidt_flops is what the un-collapsed bid,oidt->bt "
            "einsum dispatched before kan_layer_apply pre-summed the "
            "weights over `o`."
        ),
    }

    modes = (
        ("f32", None, "auto"),
        ("f32_xla", None, "xla"),
        ("bf16io", jnp.bfloat16, "xla"),
    )
    for mode, compute_dtype, backend in modes:
        # the bf16io recipe stores x in bf16 (ops/qkan_layer.py docstring),
        # so the bf16 pool is sliced directly -- tanh AND the Chebyshev
        # recurrence then run in bf16 (kan_layer_apply follows x's dtype),
        # halving every byte of the dominant [B, in*(D+1)] basis tensor.
        px = pool_x if compute_dtype is None else pool_x.astype(compute_dtype)

        def loss_fn(tp, xs, ys):
            params = [
                dict(p, degrees=d) for p, d in zip(tp, degrees)
            ]
            logits = kan_apply(
                params, xs, max_degree, compute_dtype, backend,
                matmul_precision=None,  # the device default, as train()
            )
            return jnp.mean(optax.softmax_cross_entropy(logits, ys))

        def step(carry):
            tp, opt_state, i = carry
            start = (i * 997) % batch
            xs = jax.lax.dynamic_slice(
                px, (start, 0), (batch, px.shape[1])
            )
            ys = jax.lax.dynamic_slice(pool_y, (start, 0), (batch, t_dim))
            loss, grads = jax.value_and_grad(loss_fn)(tp, xs, ys)
            updates, opt_state = opt.update(grads, opt_state, tp)
            return (
                optax.apply_updates(tp, updates),
                opt_state,
                i + jnp.int32(1),
            )

        carry = (train_params, opt.init(train_params), jnp.int32(0))
        # 300/1800-step chains: a step is ~0.2-0.3 ms, so the long chain
        # carries >=400 ms of device work
        try:
            dt = slope_time(step, carry, short_n=5 if args.quick else 300)
        except Exception as e:  # a mode that OOMs must not lose the run
            results[f"{mode}_error"] = repr(e)[:300]
            print(f"{mode}: ERROR {repr(e)[:200]}")
            continue
        results[f"{mode}_step_ms"] = dt * 1e3
        results[f"{mode}_steps_per_sec"] = 1.0 / dt
        results[f"{mode}_achieved_tflops"] = flops / dt / 1e12
        print(
            f"{mode}: {dt*1e3:.3f} ms/step, "
            f"{flops/dt/1e12:.2f} TFLOP/s (matmul lower bound)"
        )

    results["roofline_note"] = (
        "collapsed contraction: each layer is [B, in*6] @ [in*6, 10]; "
        "layer 0 (reduction 4704, output 10) dominates.  The 10-wide "
        "output keeps the matrix units at low utilization by SHAPE, so "
        "raw TFLOP/s against the collapsed count is small "
        "-- the win is that the collapse removed the `out`-redundant "
        "reduction entirely (collapse_speedup_factor above), which is "
        "worth more than any utilization tuning of the naive form: the "
        "naive-equivalent throughput is collapse_speedup_factor x the "
        "reported TFLOP/s."
    )

    out = pathlib.Path(__file__).resolve().parent / "records"
    out.mkdir(parents=True, exist_ok=True)
    suffix = "" if batch == 8192 else f"_B{batch}"
    name = f"flagship_train_step{suffix}.json"
    (out / name).write_text(json.dumps(results, indent=1))
    print(f"records -> {out / name}")


if __name__ == "__main__":
    main()
